#!/usr/bin/env python3
"""Smoke test of the kspider CLI pipeline on one GPU.

Drives ``python -m kspider_tpu`` in subprocesses, one at a time, pinned to
the first visible card, on sourmash-style signatures generated from
``--seed`` (k=31, about 2,600 hashes per sketch — scaled=1000 on bacterial
genomes; families of 32 samples share a 1,500-hash core, each core hash
present with probability 0.8, and every sample has 200-2,400 private
hashes; a genus of 4 families, spread a quarter of the collection apart,
shares a 100-hash genus core that every member carries, so its colors
span four panels of the tiled engine):

- phase 1, dense, 8,192 sketches: ``index --sourmash``, ``pairwise``
  (auto: the XLA bitmask Gram), ``cluster -c 0.5``, ``export --newick``,
  and ``index --device-build``, whose artifacts must equal the host
  index byte for byte;
- phase 2, tiled, 65,536 sketches: ``index --sourmash``, ``pairwise``
  (auto: the panel-streamed engine; the genus colors give it off-diagonal
  panel pairs, whose sides must both miss and hit its device side-cache),
  ``cluster -c 0.5`` and ``cluster --from-index -c 0.5``.

Every phase is checked against an independent host reference: a
scipy.sparse sample x hash matrix ``H``, ``shared = H @ H.T`` in int64,
containments in numpy float32 formatted ``%.6g``, and clusters from
``scipy.sparse.csgraph.connected_components``.  The pairwise TSV and the
cluster files must match it exactly.  A child process on the card also
compiles the Gram at the phase-1 width, reports what XLA made of it and
its device time, and checks the fused step (parallel/step.py).

``--four-cards`` runs only the multi-card paths, each against the same
reference: phase 1 through the auto rule (color blocks sharded over four
cards, one psum), phase 2 through the auto rule (panel pairs round-robin
over the four cards), and a 4-process ``pairwise --coordinator`` run with
one card per process.

The last line of stdout is one JSON object naming the device; the script
exits non-zero, without that line, if JAX finds no GPU or any phase fails.

Usage: python chip_smoke.py [--seed N] [--four-cards]
"""

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KSIZE = 31
FAMILY = 32
CORE = 1500
P_CORE = 0.8
PRIVATE_MIN, PRIVATE_MAX = 200, 2400
GENUS = 4
GENUS_CORE = 100
CUTOFF = 0.5
PHASE1_N = 8192
PHASE2_N = 65536
CLI_TIMEOUT = 900

_SIG = (
    '[{"class": "sourmash_signature", "email": "", "hash_function": '
    '"0.murmur64", "filename": "%s", "name": "%s", "license": "CC0", '
    '"signatures": [{"num": 0, "ksize": %d, "seed": 42, "max_hash": %d, '
    '"mins": [%s], "md5sum": "00000000000000000000000000000000", '
    '"molecule": "DNA"}], "version": 0.4}]'
)


class SmokeFailure(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# data: families of samples, generated from the seed
# ---------------------------------------------------------------------------

def splitmix64(x: np.ndarray) -> np.ndarray:
    """Bijective 64-bit mix: distinct ids give distinct hash values."""
    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def family_draw(seed: int, phase: int, fam: int):
    """(core presence bool[FAMILY, CORE], private counts int[FAMILY])."""
    rng = np.random.default_rng([seed, phase, fam])
    presence = rng.random((FAMILY, CORE)) < P_CORE
    n_private = rng.integers(PRIVATE_MIN, PRIVATE_MAX + 1, size=FAMILY)
    return presence, n_private


def n_hash_ids(n: int) -> int:
    """Size of the hash id space: family cores, private ranges, genus
    cores."""
    n_fam = n // FAMILY
    return n_fam * CORE + n * PRIVATE_MAX + (n_fam // GENUS) * GENUS_CORE


def sample_hash_ids(n: int, sample: int, presence_row, n_private: int):
    """Hash ids of one sample: its family's core ids it holds, its own
    private ids (a disjoint range per sample), then its genus core.

    Family ``f`` belongs to genus ``f % (n_fam / GENUS)``: the genus's
    families lie a quarter of the collection apart, so each genus color
    spans four panels of the tiled engine and every panel pair between
    them selects the same colors."""
    n_fam = n // FAMILY
    fam = sample // FAMILY
    core = fam * CORE + np.flatnonzero(presence_row)
    base = n_fam * CORE + sample * PRIVATE_MAX
    genus = fam % (n_fam // GENUS)
    gbase = n_fam * CORE + n * PRIVATE_MAX + genus * GENUS_CORE
    return np.concatenate([core, base + np.arange(n_private),
                           gbase + np.arange(GENUS_CORE)])


def hash_values(ids: np.ndarray, seed: int) -> np.ndarray:
    return splitmix64(ids.astype(np.uint64) + np.uint64(seed) * np.uint64(1 << 40))


def sig_name(sample: int) -> str:
    return f"s{sample:06d}"


def _write_families(args):
    sigs_dir, n, seed, phase, fam_lo, fam_hi = args
    max_hash = (1 << 64) // 1000
    for fam in range(fam_lo, fam_hi):
        presence, n_private = family_draw(seed, phase, fam)
        for r in range(FAMILY):
            s = fam * FAMILY + r
            ids = sample_hash_ids(n, s, presence[r], int(n_private[r]))
            mins = np.sort(hash_values(ids, seed))
            name = sig_name(s)
            with open(os.path.join(sigs_dir, name + ".sig"), "w") as f:
                f.write(_SIG % (name + ".sig", name, KSIZE, max_hash,
                                ", ".join(map(str, mins.tolist()))))


def write_sigs(sigs_dir: str, n: int, seed: int, phase: int, workers: int):
    os.makedirs(sigs_dir)
    n_fam = n // FAMILY
    step = max(1, -(-n_fam // (4 * workers)))
    jobs = [(sigs_dir, n, seed, phase, lo, min(lo + step, n_fam))
            for lo in range(0, n_fam, step)]
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
        for _ in ex.map(_write_families, jobs):
            pass


# ---------------------------------------------------------------------------
# the independent host reference
# ---------------------------------------------------------------------------

def reference_matrix(n: int, seed: int, phase: int):
    """(H csr int64 [n, n_ids], k-mer counts int64[n]) from the generator."""
    import scipy.sparse as sp

    rows_ids = []
    for fam in range(n // FAMILY):
        presence, n_private = family_draw(seed, phase, fam)
        for r in range(FAMILY):
            rows_ids.append(sample_hash_ids(
                n, fam * FAMILY + r, presence[r], int(n_private[r])))
    counts = np.array([len(x) for x in rows_ids], dtype=np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.concatenate(rows_ids)
    h = sp.csr_matrix(
        (np.ones(len(indices), dtype=np.int64), indices, indptr),
        shape=(n, n_hash_ids(n)),
    )
    return h, counts


def reference_pairs(h, counts):
    """Sorted upper-triangle pairs (i, j, shared) of H @ H.T and the float32
    containment columns, computed as the reference's C++ does."""
    import scipy.sparse as sp

    up = sp.triu((h @ h.T).tocsr(), k=1).tocsr()
    up.sort_indices()
    i = np.repeat(np.arange(up.shape[0]), np.diff(up.indptr))
    j = up.indices.astype(np.int64)
    shared = up.data.astype(np.int64)
    k1 = counts[i].astype(np.float32)
    k2 = counts[j].astype(np.float32)
    c12 = np.float32(1.0) * shared.astype(np.float32) / k2
    c21 = shared.astype(np.float32) / k1
    cmin = np.minimum(c12, c21)
    cavg = ((c12 + c21) / np.float32(2.0)).astype(np.float32)
    cmax = np.maximum(c12, c21)
    return i, j, shared, cmin, cavg, cmax


def expected_pairwise_lines(i, j, shared, cmin, cavg, cmax):
    return [
        f"{a}\t{b}\t{sh}\t{x:.6g}\t{y:.6g}\t{z:.6g}"
        for a, b, sh, x, y, z in zip(
            (i + 1).tolist(), (j + 1).tolist(), shared.tolist(),
            cmin.tolist(), cavg.tolist(), cmax.tolist(),
        )
    ]


def expected_clusters(n, i, j, keep, names):
    """Cluster file lines: components of the kept edges, members ascending,
    components ordered by their smallest member."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    g = sp.coo_matrix(
        (np.ones(int(keep.sum()), dtype=np.int8), (i[keep], j[keep])),
        shape=(n, n),
    )
    _, labels = connected_components(g, directed=False)
    comps = {}
    for node, lab in enumerate(labels.tolist()):
        comps.setdefault(lab, []).append(node)
    ordered = sorted(comps.values(), key=lambda c: c[0])
    return [",".join(names[v] for v in comp) for comp in ordered]


class Reference:
    def __init__(self, n: int, seed: int, phase: int):
        t0 = time.perf_counter()
        self.n = n
        h, self.counts = reference_matrix(n, seed, phase)
        (self.i, self.j, self.shared, cmin, cavg,
         self.cmax) = reference_pairs(h, self.counts)
        del h
        self.lines = expected_pairwise_lines(
            self.i, self.j, self.shared, cmin, cavg, self.cmax)
        self.names = [sig_name(s) for s in range(n)]
        printed = np.array([float(f"{x:.6g}") for x in self.cmax.tolist()])
        self.clusters_tsv = expected_clusters(
            n, self.i, self.j, printed * 100.0 >= CUTOFF * 100.0, self.names)
        self.clusters_exact = expected_clusters(
            n, self.i, self.j,
            self.cmax.astype(np.float64) * 100.0 >= CUTOFF * 100.0,
            self.names)
        self.seconds = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# running the CLI and checking its files
# ---------------------------------------------------------------------------

def first_card() -> str:
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return visible.split(",")[0] if visible else "0"


def cli_env(cards: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["KSPIDER_NATIVE"] = "force"
    env["CUDA_VISIBLE_DEVICES"] = cards
    return env


def run_cli(args, cwd, env, stage, walls, log_dir):
    log = os.path.join(log_dir, stage.replace(" ", "_") + ".log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        r = subprocess.run(
            [sys.executable, "-m", "kspider_tpu", "-q", *args], cwd=cwd,
            env=env, stdout=f, stderr=subprocess.STDOUT, timeout=CLI_TIMEOUT,
        )
    walls[stage] = time.perf_counter() - t0
    out = open(log).read()
    if r.returncode != 0:
        raise SmokeFailure(
            f"{stage}: exit {r.returncode}\n{out[-3000:]}"
        )
    print(f"stage {stage}: {walls[stage]:.2f} s", flush=True)
    return out


def check_pairwise(path: str, ref: Reference, what: str) -> int:
    with open(path) as f:
        lines = f.read().splitlines()
    body = lines[1:]
    if body != ref.lines:
        bad = next((k for k, (a, b) in enumerate(zip(body, ref.lines))
                    if a != b), min(len(body), len(ref.lines)))
        got = body[bad] if bad < len(body) else "<end>"
        want = ref.lines[bad] if bad < len(ref.lines) else "<end>"
        raise SmokeFailure(
            f"{what}: pairwise TSV differs from the reference at row {bad}: "
            f"got {got!r}, want {want!r} ({len(body)} vs {len(ref.lines)} "
            f"rows)"
        )
    return len(body)


def check_clusters(path: str, want, what: str) -> int:
    with open(path) as f:
        got = f.read().splitlines()
    if got != want:
        raise SmokeFailure(
            f"{what}: clusters differ from the reference ({len(got)} vs "
            f"{len(want)} clusters)"
        )
    return len(got)


def cluster_path(prefix: str) -> str:
    return prefix + f"_kSpider_clusters_{CUTOFF * 100.0}%.tsv"


INDEX_SUFFIXES = (".extra", ".namesMap", ".kidx.npz", "_color_count.bin",
                  "_color_to_sources.bin", "_groupID_to_kmerCount.bin")


def check_same_index(a: str, b: str) -> None:
    for suf in INDEX_SUFFIXES:
        with open(a + suf, "rb") as fa, open(b + suf, "rb") as fb:
            if fa.read() != fb.read():
                raise SmokeFailure(
                    f"index --device-build: {suf} differs from the host index"
                )


# ---------------------------------------------------------------------------
# the child on the card: device facts, the Gram's HLO and time, the step
# ---------------------------------------------------------------------------

def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def safe_cutoff(shared, denom) -> float:
    """A float32 cutoff near CUTOFF that no pair's containment comes within
    8 ulp of, so a division that is off by its last bits cannot move a
    pair across it."""
    q = shared.astype(np.float64) / np.maximum(denom, 1).astype(np.float64)
    for c in np.float32(CUTOFF) + np.arange(64, dtype=np.float32) * np.float32(1e-4):
        if not len(q) or np.abs(q - np.float64(c)).min() > 8 * float(np.spacing(c)):
            return float(c)
    raise SmokeFailure("no safe cutoff near the clustering cutoff")


def device_kernel_times(trace_dir: str) -> dict:
    """Reduce a ``jax.profiler`` perfetto trace to the device's kernels:
    seconds per kernel name, and the busy share of the window from the
    first kernel's start to the last one's end.  Only the device's stream
    lines count (its "XLA Modules" / "XLA Ops" lines repeat them)."""
    import glob
    import gzip

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "perfetto_trace.json.gz")))
    if not paths:
        return {"kernels": {}, "busy_s": 0.0, "window_s": 0.0}
    with gzip.open(paths[-1]) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    device_pids = {
        e["pid"] for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and str(e.get("args", {}).get("name", "")).startswith("/device:")
    }
    lines = {
        (e["pid"], e["tid"]): str(e.get("args", {}).get("name", ""))
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
        and e.get("pid") in device_pids
    }
    streams = {k for k, v in lines.items() if v.startswith("Stream")}
    spans, kernels = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in device_pids and (
                not streams or (e["pid"], e.get("tid")) in streams):
            t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
            spans.append((t0, t0 + dur))
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + dur * 1e-6
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0.0)
    return {"kernels": kernels, "busy_s": busy * 1e-6,
            "window_s": window * 1e-6}


def gram_probe(prefix: str, ref_path: str) -> dict:
    """On the card: compile the dense Gram at this index's width, read the
    HLO, time it, and check the fused step against the reference."""
    import statistics

    import jax
    import jax.numpy as jnp

    from kspider_tpu.io import npz_index
    from kspider_tpu.ops import bitmask as bm
    from kspider_tpu.ops import pairwise as pw
    from kspider_tpu.parallel import step as step_lib
    from kspider_tpu.parallel.sharded_pairwise import _compact_multi_colors

    out = device_info()
    index = npz_index.load(prefix)
    n = index.num_groups
    block = 1024
    offs, mems, wts = _compact_multi_colors(
        index.color_offsets, index.color_members, index.color_counts)
    w_limbs = pw.weight_limbs(wts)
    n_limbs = w_limbs.shape[1]
    bits = bm.pack_bitmask_blocks(offs, mems, n, block)
    nb = bits.shape[0]
    n_pad = bits.shape[2] * 8
    wl = np.zeros((nb * block, n_limbs), dtype=np.int8)
    wl[: len(wts)] = w_limbs
    wl = wl.reshape(nb, block, n_limbs)
    bits_d, wl_d = jax.block_until_ready(
        (jax.device_put(bits), jax.device_put(wl)))

    t0 = time.perf_counter()
    compiled = bm.cooccurrence_bitmask_blocks.lower(
        bits_d, wl_d, block, n_pad, n_limbs).compile()
    out["gram_compile_s"] = time.perf_counter() - t0
    hlo = compiled.as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    operand = re.search(r"s8\[%d,%d\]" % (block, n_pad), hlo) or re.search(
        r"s8\[%d,%d\]" % (n_pad, block), hlo)
    out["hlo"] = {
        "gemm_targets": targets,
        "dot_loop_emitted": bool(re.search(r" dot\(", hlo)),
        "unpacked_s8_operand_in_hbm": bool(operand),
        "while_loops": hlo.count(" while("),
    }
    acc = jax.block_until_ready(compiled(bits_d, wl_d))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(bits_d, wl_d))
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    out["gram_s"] = t
    out["gram_tops"] = 2 * nb * block * n_pad * n_pad * n_limbs / t / 1e12
    out["gram_blocks"] = nb
    # one traced call: which kernels the time goes to, and how much of
    # the window the device sits idle between the scan's iterations
    trace_dir = os.path.join(os.path.dirname(ref_path), "gram_trace")
    with jax.profiler.trace(trace_dir, create_perfetto_trace=True):
        jax.block_until_ready(compiled(bits_d, wl_d))
    out["gram_trace"] = device_kernel_times(trace_dir)

    ref = np.load(ref_path)
    i, j, shared, counts = ref["i"], ref["j"], ref["shared"], ref["counts"]
    s_ref = np.zeros((n, n), dtype=np.int64)
    s_ref[i, j] = shared
    s_ref[j, i] = shared
    acc_h = np.asarray(acc).astype(np.int64)
    s_dev = sum(acc_h[l] * 128**l for l in range(n_limbs))[:n, :n]
    np.fill_diagonal(s_dev, 0)
    out["gram_exact"] = bool(np.array_equal(s_dev, s_ref))

    # the fused step (parallel/step.py): int32 combine, float32
    # containment, threshold, connected components — all on the card
    denom = np.minimum(counts[i], counts[j])
    cut = safe_cutoff(shared, denom)
    shared_dev, labels = step_lib.single_device_step(
        bits_d, wl_d, jnp.asarray(counts.astype(np.int32)), cut,
        block, n_pad, n_limbs)
    shared_dev = np.asarray(shared_dev).astype(np.int64)
    labels = np.asarray(labels)
    keep = shared.astype(np.float32) / np.maximum(
        denom, 1).astype(np.float32) >= np.float32(cut)
    want = expected_clusters(n, i, j, keep, [str(v) for v in range(n)])
    got_comps = {}
    for node, lab in enumerate(labels.tolist()):
        got_comps.setdefault(lab, []).append(str(node))
    got = [",".join(c) for c in sorted(got_comps.values(),
                                       key=lambda c: int(c[0]))]
    out["step_exact"] = bool(np.array_equal(shared_dev, s_ref) and got == want)
    out["step_cutoff"] = cut

    # float32 division: XLA on the card against numpy's IEEE division
    rng = np.random.default_rng(0)
    a = rng.integers(1, 5000, size=1 << 20).astype(np.int32)
    b = rng.integers(1, 5000, size=1 << 20).astype(np.int32)
    dev = np.asarray(jax.jit(
        lambda x, y: x.astype(jnp.float32) / y.astype(jnp.float32))(a, b))
    host = a.astype(np.float32) / b.astype(np.float32)
    diff = np.abs(dev.view(np.int32).astype(np.int64)
                  - host.view(np.int32).astype(np.int64))
    out["f32_div_mismatch"] = int((diff != 0).sum())
    out["f32_div_max_ulp"] = int(diff.max())
    out["f32_div_samples"] = len(a)
    return out


def run_child(fn_call: str, env: dict, timeout: int = CLI_TIMEOUT) -> dict:
    """Run ``chip_smoke.<fn_call>`` in a child and return its JSON result."""
    code = (
        f"import sys, json; sys.path.insert(0, {REPO!r}); import chip_smoke; "
        f"print('RESULT ' + json.dumps(chip_smoke.{fn_call}))"
    )
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=timeout)
    for line in r.stdout.splitlines():
        if line.startswith("RESULT "):
            if r.returncode == 0:
                return json.loads(line[len("RESULT "):])
    raise SmokeFailure(
        f"child {fn_call.split('(')[0]} exit {r.returncode}:\n"
        f"{r.stdout[-1500:]}\n{r.stderr[-3000:]}"
    )


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

class Run:
    def __init__(self, work: str, seed: int, workers: int):
        self.work = work
        self.seed = seed
        self.workers = workers
        self.walls = {}
        self.rows = 0
        self.logs = os.path.join(work, "logs")
        os.makedirs(self.logs)

    def prepare(self, phase: int, n: int) -> Reference:
        sigs = os.path.join(self.work, f"sigs{phase}")
        t0 = time.perf_counter()
        write_sigs(sigs, n, self.seed, phase, self.workers)
        self.walls[f"phase {phase} generate"] = time.perf_counter() - t0
        ref = Reference(n, self.seed, phase)
        self.walls[f"phase {phase} reference"] = ref.seconds
        print(f"phase {phase}: {n} sketches, {len(ref.lines)} reference "
              f"pairs, {int(ref.counts.sum())} postings", flush=True)
        return ref

    def cli(self, args, stage, cards):
        return run_cli(args, self.work, cli_env(cards), stage, self.walls,
                       self.logs)

    def index(self, phase: int, prefix: str, cards: str, *extra):
        self.cli(["index", "--sourmash", "--dir", f"sigs{phase}", "-k",
                  str(KSIZE), "-o", prefix, *extra],
                 f"phase {phase} index{' ' + extra[0] if extra else ''}",
                 cards)
        return os.path.join(self.work, prefix)

    def compare_pairwise(self, prefix: str, ref: Reference, what: str):
        self.rows += check_pairwise(
            prefix + "_kSpider_pairwise.tsv", ref, what)


def single_card(run: Run) -> dict:
    card = first_card()
    probe = phase1_dense(run, card)
    phase2_tiled(run, card)
    return probe


def phase1_dense(run: Run, card: str) -> dict:
    """Phase 1 on one card; returns the Gram probe's report."""
    ref1 = run.prepare(1, PHASE1_N)
    p1 = run.index(1, "p1", card)
    out = run.cli(["pairwise", "-i", "p1"], "phase 1 pairwise", card)
    if "pairwise engine: bitmask over 1 device(s)" not in out:
        raise SmokeFailure(f"phase 1 pairwise did not take the dense "
                           f"bitmask engine:\n{out[-2000:]}")
    run.compare_pairwise(p1, ref1, "phase 1 pairwise")
    run.cli(["cluster", "-i", "p1", "-c", str(CUTOFF)], "phase 1 cluster",
            card)
    n_clusters = check_clusters(cluster_path(p1), ref1.clusters_tsv,
                                "phase 1 cluster")
    run.cli(["export", "-i", "p1", "--newick"], "phase 1 export", card)
    with open(os.path.join(run.work, "kSpider_p1_pairwise.tsv")) as f:
        labeled = sum(1 for _ in f) - 1
    with open(os.path.join(run.work, "kSpider_p1.newick")) as f:
        newick = f.read()
    if labeled != len(ref1.lines) or not (newick.startswith("(")
                                          and newick.endswith(";")):
        raise SmokeFailure("phase 1 export: labeled TSV or newick malformed")
    run.index(1, "p1dev", card, "--device-build")
    check_same_index(p1, os.path.join(run.work, "p1dev"))
    print(f"phase 1: exact; {len(ref1.lines)} pairs, {n_clusters} clusters, "
          f"device-build artifacts identical", flush=True)

    ref_path = os.path.join(run.work, "ref1.npz")
    np.savez(ref_path, i=ref1.i, j=ref1.j, shared=ref1.shared,
             counts=ref1.counts)
    t0 = time.perf_counter()
    probe = run_child(f"gram_probe({p1!r}, {ref_path!r})", cli_env(card))
    run.walls["phase 1 gram probe"] = time.perf_counter() - t0
    if not probe["gram_exact"] or not probe["step_exact"]:
        raise SmokeFailure(f"gram probe mismatch: {probe}")
    print(f"gram: {probe['gram_blocks']} blocks of 1024 colors at "
          f"n={PHASE1_N}: {probe['gram_s'] * 1e3:.3f} ms device time "
          f"({probe['gram_tops']:.1f} int8 TOP/s), compile "
          f"{probe['gram_compile_s']:.2f} s; exact", flush=True)
    print(f"hlo: {json.dumps(probe['hlo'])}", flush=True)
    tr = probe["gram_trace"]
    if tr["window_s"] > 0:
        top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:4]
        print(f"gram trace: device busy {tr['busy_s'] * 1e3:.3f} ms of a "
              f"{tr['window_s'] * 1e3:.3f} ms window "
              f"({100 * tr['busy_s'] / tr['window_s']:.1f}%); "
              + "; ".join(f"{k[:60]} {v * 1e3:.3f} ms" for k, v in top),
              flush=True)
    else:
        print("gram trace: no device events recorded", flush=True)
    print(f"step (parallel/step.py) exact at cutoff {probe['step_cutoff']}; "
          f"f32 division on the card differs from numpy in "
          f"{probe['f32_div_mismatch']} of {probe['f32_div_samples']} "
          f"quotients (max {probe['f32_div_max_ulp']} ulp)", flush=True)
    return probe


def side_cache_counts(out: str):
    """(hits, misses) from the tiled engine's side-cache line, or None."""
    m = re.search(r"device side-cache: (\d+) hits / (\d+) misses", out)
    return (int(m.group(1)), int(m.group(2))) if m else None


def phase2_tiled(run: Run, card: str) -> None:
    """Phase 2 on one card."""
    ref2 = run.prepare(2, PHASE2_N)
    p2 = run.index(2, "p2", card)
    out = run.cli(["pairwise", "-i", "p2"], "phase 2 pairwise", card)
    if "tiled engine: xla over 1 device(s)" not in out:
        raise SmokeFailure(f"phase 2 pairwise did not take the tiled "
                           f"engine on one card:\n{out[-2000:]}")
    for line in out.splitlines():
        if line.strip().startswith(("stage breakdown", "device side-cache",
                                    "side payload")):
            print(f"phase 2 pairwise {line.strip()}", flush=True)
    # the genus colors make off-diagonal panel pairs that re-select the
    # same sides: the cache must have stored sides and served them again
    cache = side_cache_counts(out)
    if cache is None or cache[0] == 0 or cache[1] == 0:
        raise SmokeFailure(f"phase 2 pairwise: the device side-cache was "
                           f"not exercised (hits, misses = {cache})")
    run.compare_pairwise(p2, ref2, "phase 2 pairwise")
    run.cli(["cluster", "-i", "p2", "-c", str(CUTOFF)], "phase 2 cluster",
            card)
    n2 = check_clusters(cluster_path(p2), ref2.clusters_tsv,
                        "phase 2 cluster")
    run.cli(["cluster", "--from-index", "-i", "p2", "-c", str(CUTOFF)],
            "phase 2 cluster --from-index", card)
    check_clusters(cluster_path(p2), ref2.clusters_exact,
                   "phase 2 cluster --from-index")
    print(f"phase 2: exact; {len(ref2.lines)} pairs, {n2} clusters",
          flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def four_cards(run: Run) -> dict:
    cards = os.environ.get("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    if len(cards.split(",")) != 4:
        raise SmokeFailure(f"--four-cards needs 4 visible cards, got {cards!r}")
    info = run_child("device_info()", cli_env(cards))
    if info["count"] != 4:
        raise SmokeFailure(f"expected 4 devices, JAX found {info}")
    ref1 = run.prepare(1, PHASE1_N)
    p1 = run.index(1, "p1", cards)
    out = run.cli(["pairwise", "-i", "p1"], "phase 1 pairwise sharded", cards)
    if "pairwise engine: sharded over 4 device(s)" not in out:
        raise SmokeFailure(f"phase 1 did not shard over 4 cards:\n{out[-2000:]}")
    run.compare_pairwise(p1, ref1, "phase 1 sharded")
    print("phase 1 sharded over 4 cards: exact", flush=True)

    # four coordinated processes, one card each, over the phase-1 index
    port = free_port()
    env = cli_env(cards)
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in range(4):
            log = open(os.path.join(run.logs, f"mp{pid}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "kspider_tpu", "-q", "pairwise", "-i",
                 "p1", "--coordinator", f"localhost:{port}",
                 "--num-processes", "4", "--process-id", str(pid)],
                cwd=run.work, env=env, stdout=log, stderr=subprocess.STDOUT,
            ), log))
        for p, log in procs:
            p.wait(timeout=CLI_TIMEOUT)
            log.close()
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    run.walls["phase 1 pairwise 4 processes"] = time.perf_counter() - t0
    outs = [open(os.path.join(run.logs, f"mp{pid}.log")).read()
            for pid in range(4)]
    for pid, (p, _) in enumerate(procs):
        if p.returncode != 0:
            raise SmokeFailure(f"process {pid}: exit {p.returncode}\n"
                               f"{outs[pid][-3000:]}")
    owned = sorted(line.split("devices ")[1] for o in outs
                   for line in o.splitlines() if "local devices " in line)
    one_each = info["platform"] != "gpu" or all("," not in o for o in owned)
    if len(set(owned)) != 4 or not one_each:
        raise SmokeFailure(f"processes did not own one card each: {owned}")
    run.compare_pairwise(p1, ref1, "phase 1 4 processes")
    print(f"phase 1 over 4 coordinated processes ({', '.join(owned)}): "
          f"exact in {run.walls['phase 1 pairwise 4 processes']:.2f} s",
          flush=True)
    del ref1

    ref2 = run.prepare(2, PHASE2_N)
    p2 = run.index(2, "p2", cards)
    out = run.cli(["pairwise", "-i", "p2"],
                  "phase 2 pairwise pair-parallel", cards)
    if "tiled engine: pair-parallel over 4 device(s)" not in out:
        raise SmokeFailure(f"phase 2 did not round-robin over 4 cards:\n"
                           f"{out[-2000:]}")
    run.compare_pairwise(p2, ref2, "phase 2 pair-parallel")
    print("phase 2 pair-parallel over 4 cards: exact", flush=True)
    return info


def card_lines() -> list:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on four cards")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "kspider_tpu")):
        print("chip_smoke: the kspider_tpu package is not beside this "
              "script", file=sys.stderr)
        return 1
    cards = os.environ.get("CUDA_VISIBLE_DEVICES")
    if args.four_cards and not cards:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0,1,2,3"
    try:
        info = run_child("device_info()", cli_env(
            os.environ.get("CUDA_VISIBLE_DEVICES", "0") if args.four_cards
            else first_card()))
    except SmokeFailure as e:
        print(f"chip_smoke: no device: {e}", file=sys.stderr)
        return 1
    if info["platform"] != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{info['platform']!r}); nothing was run", file=sys.stderr)
        return 1

    work = os.path.join(REPO, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    run = Run(work, args.seed, workers=min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            info = four_cards(run)
            if info["platform"] != "gpu":
                raise SmokeFailure(f"the cards ran as {info}")
        else:
            probe = single_card(run)
            info = {k: probe[k] for k in ("platform", "kind", "count")}
            if info["platform"] != "gpu":
                raise SmokeFailure(f"the card child ran on {info}")
        lines = card_lines()
    except (SmokeFailure, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for stage, wall in run.walls.items():
        print(f"wall {stage}: {wall:.2f} s")
    print(f"rows compared: {run.rows}; total {time.perf_counter() - t0:.1f} s")
    for line in lines:
        print(line)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

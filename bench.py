"""Benchmark: pairwise co-occurrence Gram throughput on one GPU.

Prints ONE JSON line:
  {"metric": "pairwise co-occurrence pair-updates/s", "value": N,
   "unit": "pairs/s", "vs_baseline": R, "engine": "xla-bitmask",
   "device": {...}, "card": "...", "power_limit": "..."}

The workload mirrors the reference's hot loop
(/root/reference/src/pairwise.cpp:199-237): for every color c with member
degree d_c and weight w_c, accumulate w_c into all C(d_c, 2) sample-pair
counters.  "pair-updates" = sum_c C(d_c, 2) — the exact number of scalar
hash-map updates the reference performs for the same input.  The device
computes the same matrix as blocked int8 matmuls (ops/bitmask.py).

Timing: the packed inputs are placed on the device first; each timed call
of the jitted Gram ends in ``jax.block_until_ready``, after one warm-up
call that compiles.  The reported time is the median of the timed calls.
``vs_baseline`` is the speedup over the best host engine for the same
input (native C++/OpenMP if built, else vectorized numpy).

Honesty rules: the script exits non-zero, printing no result line, when
JAX finds no GPU or when the device matrix differs from the host's.  The
result line names the card and its power limit, since a card set below
its maximum power runs matrix-heavy work slower.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_SAMPLES = 1024
N_COLORS = 1 << 17
BLOCK = 1024  # colors per scan step of the Gram
N_LIMBS = 2  # weights < 128**2
N_TIMED = 10

METRIC = "pairwise co-occurrence pair-updates/s"


def make_degrees_and_weights(seed=42):
    """Host-side (tiny) metadata: per-color degree and weight profile with
    a clustered heavy tail, like real pangenome cores."""
    rng = np.random.default_rng(seed)
    r = rng.random(N_COLORS)
    degrees = np.where(
        r < 0.70,
        rng.integers(2, 6, size=N_COLORS),
        np.where(
            r < 0.95,
            rng.integers(6, 40, size=N_COLORS),
            rng.integers(40, 256, size=N_COLORS),
        ),
    ).astype(np.int32)
    weights = rng.integers(1, 5000, size=N_COLORS).astype(np.int64)
    return degrees, weights


def make_postings(degrees, seed=0):
    rng = np.random.default_rng(seed)
    offsets = np.zeros(N_COLORS + 1, dtype=np.int64)
    np.cumsum(degrees.astype(np.int64), out=offsets[1:])
    members = rng.integers(0, N_SAMPLES, size=int(offsets[-1])).astype(np.int64)
    return offsets, members


def dedup_postings(offsets, members):
    """A color is a set; the bitmask packing ORs duplicate (color, member)
    pairs away — mirror that for the host engine and the pair-update
    count so both sides score the identical workload."""
    flat_color = np.repeat(np.arange(N_COLORS, dtype=np.int64), np.diff(offsets))
    flat_member = members
    order = np.lexsort((flat_member, flat_color))
    flat_color, flat_member = flat_color[order], flat_member[order]
    keep = np.concatenate(
        (
            [True],
            (flat_color[1:] != flat_color[:-1])
            | (flat_member[1:] != flat_member[:-1]),
        )
    )
    flat_color, flat_member = flat_color[keep], flat_member[keep]
    deg2 = np.bincount(flat_color, minlength=N_COLORS).astype(np.int64)
    offsets2 = np.zeros(N_COLORS + 1, dtype=np.int64)
    np.cumsum(deg2, out=offsets2[1:])
    pair_updates = int((deg2 * (deg2 - 1) // 2).sum())
    return offsets2, flat_member.astype(np.int32), pair_updates


def host_engine():
    """(fn, kind): best available host engine for the baseline."""
    from kspider_tpu.io import native
    from kspider_tpu.ops import pairwise as pw

    if native.available():
        return native.shared_kmer_matrix, "native"
    return pw.shared_kmer_matrix_numpy, "numpy"


def card_and_power_limit():
    """(name, power limit) of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.split(","))
    return name, limit


def main() -> int:
    import jax

    from kspider_tpu.ops import bitmask as bm
    from kspider_tpu.ops import pairwise as pw
    from kspider_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform!r}); no result",
              file=sys.stderr)
        return 1
    card, power_limit = card_and_power_limit()

    degrees, weights = make_degrees_and_weights()
    w_limbs = pw.weight_limbs(weights)
    assert w_limbs.shape[1] == N_LIMBS
    offsets, members = make_postings(degrees)
    offsets2, members2, pair_updates = dedup_postings(offsets, members)

    bits = bm.pack_bitmask_blocks(offsets, members, N_SAMPLES, BLOCK)
    nb = bits.shape[0]
    wl = np.zeros((nb * BLOCK, N_LIMBS), dtype=np.int8)
    wl[:N_COLORS] = w_limbs
    wl = wl.reshape(nb, BLOCK, N_LIMBS)
    bits_d, wl_d = jax.block_until_ready(
        (jax.device_put(bits), jax.device_put(wl))
    )

    def gram():
        return bm.cooccurrence_bitmask_blocks(
            bits_d, wl_d, BLOCK, N_SAMPLES, N_LIMBS
        )

    acc = jax.block_until_ready(gram())  # compile + warm
    times = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        jax.block_until_ready(gram())
        times.append(time.perf_counter() - t0)
    t_dev = statistics.median(times)

    acc_h = np.asarray(acc).astype(np.int64)
    s_dev = acc_h[0] + 128 * acc_h[1]
    np.fill_diagonal(s_dev, 0)
    host_fn, host_kind = host_engine()
    t_host = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        s_host = host_fn(offsets2, members2, weights, N_SAMPLES)
        t_host = min(t_host, time.perf_counter() - t0)
    if not np.array_equal(s_dev, s_host):
        print("bench: device/host matrix mismatch; no result", file=sys.stderr)
        return 3

    value = pair_updates / t_dev
    print(
        f"# {card} ({power_limit}): gram {t_dev * 1e3:.3f} ms median of "
        f"{N_TIMED}, host[{host_kind}] {t_host * 1e3:.1f} ms, "
        f"pair_updates={pair_updates}, postings={len(members2)}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": METRIC,
        "value": round(value),
        "unit": "pairs/s",
        "vs_baseline": round(t_host / t_dev, 3),
        "engine": "xla-bitmask",
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "card": card,
        "power_limit": power_limit,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

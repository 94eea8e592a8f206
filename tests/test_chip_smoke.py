"""chip_smoke.py: its independent reference, and its refusal to run
without a GPU or without the package beside it."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from kspider_tpu.core import cluster as core_cluster
from kspider_tpu.core import pairwise as core_pairwise
from kspider_tpu.core.index import build_index_from_hash_sets
from kspider_tpu.io import artifacts as artifacts_io
from kspider_tpu.ops import pairwise as pw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4 * cs.FAMILY


@pytest.fixture(scope="module")
def small():
    """The smoke's generator at 4 families, indexed by the program."""
    seed, phase = 3, 1
    return cs.Reference(N, seed, phase), _index_of(N, seed, phase)


def test_reference_matches_numpy_engine(small):
    ref, index = small
    s_np = pw.shared_kmer_matrix_numpy(
        index.color_offsets, index.color_members, index.color_counts, N)
    s_ref = np.zeros((N, N), dtype=np.int64)
    s_ref[ref.i, ref.j] = ref.shared
    s_ref[ref.j, ref.i] = ref.shared
    assert np.array_equal(s_ref, s_np)
    assert np.array_equal(ref.counts, index.group_kmer_count)


def test_reference_lines_and_clusters_match_the_writers(small, tmp_path):
    ref, index = small
    prefix = str(tmp_path / "p")
    shared = core_pairwise.compute_shared_matrix(index, use_device=False)
    core_pairwise.write_pairwise_tsv(prefix, index, shared)
    artifacts_io.write_index_artifacts(prefix, index)
    with open(prefix + "_kSpider_pairwise.tsv") as f:
        assert f.read().splitlines()[1:] == ref.lines
    out = core_cluster.cluster_index(prefix, cs.CUTOFF, use_device=False)
    with open(out) as f:
        assert f.read().splitlines() == ref.clusters_tsv
    assert len(ref.clusters_tsv) < N  # the cutoff joins samples


def _index_of(n, seed, phase):
    names, hashes = [], []
    for fam in range(n // cs.FAMILY):
        presence, n_private = cs.family_draw(seed, phase, fam)
        for r in range(cs.FAMILY):
            s = fam * cs.FAMILY + r
            ids = cs.sample_hash_ids(n, s, presence[r], int(n_private[r]))
            names.append(cs.sig_name(s))
            hashes.append(np.sort(cs.hash_values(ids, seed)))
    return build_index_from_hash_sets(names, hashes, ksize=cs.KSIZE,
                                      params=f"kSize:{cs.KSIZE}")


def test_genus_colors_exercise_the_tiled_side_cache(tmp_path):
    """The phase-2 layout scaled down to 16 panels of one family each:
    each genus spans four panels a quarter of the collection apart, so
    the tiled engine gets off-diagonal panel pairs whose sides both miss
    and hit its device side-cache, and its TSV still equals the
    reference."""
    from kspider_tpu.ops import tiled_pairwise as tp

    n = 16 * cs.FAMILY
    index = _index_of(n, seed=5, phase=2)
    ref = cs.Reference(n, 5, 2)
    panel = n // 16
    prefix = str(tmp_path / "p")
    stats = {}
    rows = tp.stream_pairwise_tsv(index, prefix, panel=panel, engine="xla",
                                  cache_bytes=1 << 26, stats=stats)
    plan = tp.build_panel_plan(index.color_offsets, index.color_members,
                               index.color_counts, n, panel)
    pairs = plan.pair_keys.tolist()
    off_diag = [k for k in pairs if k // plan.n_panels != k % plan.n_panels]
    assert len(off_diag) == 4 * 6  # four groups of four panels
    assert stats["cache_hits"] > 0 and stats["cache_misses"] > 0
    assert rows == len(ref.lines)
    with open(prefix + "_kSpider_pairwise.tsv") as f:
        assert f.read().splitlines()[1:] == ref.lines
    assert cs.side_cache_counts(
        "  device side-cache: 7 hits / 3 misses (1MB resident)") == (7, 3)
    assert cs.side_cache_counts("tiled engine: xla") is None


def test_device_kernel_times_reduces_stream_lines(tmp_path):
    import gzip
    import json

    run = tmp_path / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 7,
         "args": {"name": "Stream #13(Compute)"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 8,
         "args": {"name": "XLA Ops"}},
        {"ph": "X", "pid": 1, "tid": 7, "name": "gemm", "ts": 0, "dur": 100},
        {"ph": "X", "pid": 1, "tid": 7, "name": "add", "ts": 50, "dur": 100},
        {"ph": "X", "pid": 1, "tid": 7, "name": "gemm", "ts": 300, "dur": 100},
        {"ph": "X", "pid": 1, "tid": 8, "name": "op", "ts": 0, "dur": 400},
        {"ph": "X", "pid": 2, "tid": 1, "name": "host", "ts": 0, "dur": 999},
    ]
    with gzip.open(run / "perfetto_trace.json.gz", "wt") as f:
        json.dump({"traceEvents": ev}, f)
    got = cs.device_kernel_times(str(tmp_path))
    assert got["kernels"] == pytest.approx({"gemm": 200e-6, "add": 100e-6})
    assert got["busy_s"] == pytest.approx(250e-6)  # [0, 150) + [300, 400)
    assert got["window_s"] == pytest.approx(400e-6)
    assert cs.device_kernel_times(str(tmp_path / "none"))["window_s"] == 0.0


def test_safe_cutoff_keeps_clear_of_every_quotient():
    shared = np.array([50, 51, 1000])
    denom = np.array([100, 102, 2000])  # all exactly 0.5
    c = cs.safe_cutoff(shared, denom)
    assert c > cs.CUTOFF
    q = shared / denom
    assert np.abs(q - c).min() > 8 * np.spacing(np.float32(c))


def _run_smoke(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run_smoke(REPO, env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = _run_smoke(str(tmp_path), env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

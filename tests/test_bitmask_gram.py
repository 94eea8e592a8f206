"""The XLA bitmask Gram and the engine choice vs the numpy reference."""

import numpy as np
import pytest

from kspider_tpu.ops import bitmask as bm
from kspider_tpu.ops import pairwise as pw
from tests.test_pairwise_ops import random_csr


def test_pack_bitmask_matches_packbits(rng):
    offsets = np.array([0, 3, 5], dtype=np.int64)
    members = np.array([0, 9, 130, 4, 255], dtype=np.int64)
    bits = bm.pack_bitmask_blocks(offsets, members, 256, block=2)
    dense = np.zeros((2, 256), dtype=np.uint8)
    dense[0, [0, 9, 130]] = 1
    dense[1, [4, 255]] = 1
    expect = np.packbits(dense, axis=1)
    assert np.array_equal(bits[0], expect)


def test_bitmask_engine_matches_numpy(rng):
    o, m, w = random_csr(rng, 900, 200, max_degree=12, max_weight=70000)
    s1 = bm.shared_kmer_matrix_bitmask(o, m, w, 200, block=256)
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, 200)
    assert np.array_equal(s1, s2)


# the shapes the retired per-backend kernels were checked at: one padded
# 128-wide tile, several tiles, widths that are and are not multiples of
# 128, and weights needing 1-3 base-128 limbs
@pytest.mark.parametrize("n_colors,n,max_degree,max_weight,block", [
    (250, 50, 6, 500, 128),
    (600, 150, 10, 40000, 128),
    (700, 200, 10, 40000, 128),
    (500, 300, 8, 300, 128),
    (400, 512, 8, 40000, 128),
    (300, 200, 12, 3_000_000, 256),
])
def test_xla_gram_matches_numpy(rng, n_colors, n, max_degree, max_weight,
                                block):
    o, m, w = random_csr(rng, n_colors, n, max_degree=max_degree,
                         max_weight=max_weight)
    s1 = bm.shared_kmer_matrix_bitmask(o, m, w, n, block=block)
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)


def test_engine_dispatcher(rng):
    o, m, w = random_csr(rng, 300, 60, max_degree=6, max_weight=1000)
    s_ref = pw.shared_kmer_matrix_numpy(o, m, w, 60)
    for engine in ("auto", "bitmask", "scatter", "sharded"):
        s = pw.shared_kmer_matrix(o, m, w, 60, engine=engine)
        assert np.array_equal(s, s_ref), engine
    for engine in ("nope", "pallas"):
        with pytest.raises(ValueError):
            pw.shared_kmer_matrix(o, m, w, 60, engine=engine)


T = pw.AUTO_TILED_THRESHOLD


@pytest.mark.parametrize("backend,n_devices,n,dense_only,expect", [
    ("cpu", 1, 100, False, "bitmask"),
    ("gpu", 1, 100, False, "bitmask"),
    ("gpu", 1, T, False, "bitmask"),
    ("gpu", 4, 8192, False, "sharded"),
    ("cpu", 8, T, False, "sharded"),
    ("gpu", 1, T + 1, False, "tiled"),
    ("gpu", 4, 65536, False, "tiled"),
    ("cpu", 1, 65536, False, "tiled"),
    ("gpu", 1, 65536, True, "bitmask"),
    ("gpu", 4, 65536, True, "sharded"),
])
def test_choose_engine(backend, n_devices, n, dense_only, expect):
    got = pw.choose_engine(backend, n_devices, n, dense_only=dense_only)
    assert got == expect
    assert got in ("bitmask", "sharded", "tiled")


@pytest.mark.parametrize("backend,n_devices", [("metal", 1), ("gpu", 0)])
def test_choose_engine_rejects(backend, n_devices):
    with pytest.raises(ValueError):
        pw.choose_engine(backend, n_devices, 100)


def test_cli_rejects_pallas_engine(tmp_path):
    from kspider_tpu.cli.main import cli
    from tests.cli_runner import CliRunner

    r = CliRunner().invoke(
        cli, ["pairwise", "-i", str(tmp_path / "x"), "--engine", "pallas"]
    )
    assert r.exit_code == 2
    assert "invalid choice" in r.output

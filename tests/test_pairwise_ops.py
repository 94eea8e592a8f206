"""Co-occurrence engine (scatter path) vs numpy reference."""

import numpy as np

from kspider_tpu.ops import pairwise as pw


def random_csr(rng, n_colors, n_samples, max_degree=6, max_weight=1):
    degrees = rng.integers(1, max_degree + 1, size=n_colors)
    offsets = np.zeros(n_colors + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    members = np.empty(offsets[-1], dtype=np.int32)
    for c in range(n_colors):
        members[offsets[c] : offsets[c + 1]] = np.sort(
            rng.choice(n_samples, size=degrees[c], replace=False)
        )
    weights = rng.integers(1, max_weight + 1, size=n_colors).astype(np.int64)
    return offsets, members, weights


def test_weight_limbs_roundtrip(rng):
    w = rng.integers(0, 2**40, size=1000).astype(np.int64)
    limbs = pw.weight_limbs(w)
    recon = np.zeros_like(w)
    scale = 1
    for l in range(limbs.shape[1]):
        recon += limbs[:, l].astype(np.int64) * scale
        scale *= 128
    assert np.array_equal(recon, w)


def test_matmul_matches_numpy_small(rng):
    offsets, members, weights = random_csr(rng, 200, 17, max_weight=1)
    s_np = pw.shared_kmer_matrix_numpy(offsets, members, weights, 17)
    s_dev = pw.shared_kmer_matrix(offsets, members, weights, 17, block=64)
    assert np.array_equal(s_np, s_dev)


def test_matmul_matches_numpy_large_weights(rng):
    offsets, members, weights = random_csr(rng, 300, 40, max_weight=2**21)
    s_np = pw.shared_kmer_matrix_numpy(offsets, members, weights, 40)
    s_dev = pw.shared_kmer_matrix(offsets, members, weights, 40, block=128)
    assert np.array_equal(s_np, s_dev)


def test_matmul_block_not_dividing(rng):
    offsets, members, weights = random_csr(rng, 131, 9, max_weight=300)
    s_np = pw.shared_kmer_matrix_numpy(offsets, members, weights, 9)
    s_dev = pw.shared_kmer_matrix(offsets, members, weights, 9, block=64)
    assert np.array_equal(s_np, s_dev)


def test_no_multi_colors():
    offsets = np.array([0, 1, 2], dtype=np.int64)
    members = np.array([0, 1], dtype=np.int32)
    weights = np.array([10, 20], dtype=np.int64)
    s = pw.shared_kmer_matrix(offsets, members, weights, 2)
    assert np.array_equal(s, np.zeros((2, 2), dtype=np.int64))


def test_empty():
    s = pw.shared_kmer_matrix(
        np.zeros(1, np.int64), np.empty(0, np.int32), np.empty(0, np.int64), 5
    )
    assert np.array_equal(s, np.zeros((5, 5), dtype=np.int64))

"""Multi-device (virtual 8-CPU mesh) sharded pairwise vs single-device."""

import jax
import numpy as np
import pytest

from kspider_tpu.ops import pairwise as pw
from kspider_tpu.parallel import mesh as mesh_lib
from kspider_tpu.parallel import sharded_pairwise
from tests.test_pairwise_ops import random_csr


def test_virtual_mesh_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_numpy(rng, n_dev):
    offsets, members, weights = random_csr(rng, 400, 33, max_weight=5000)
    mesh = mesh_lib.make_mesh(n_dev)
    s_sharded = sharded_pairwise.shared_kmer_matrix_sharded(
        offsets, members, weights, 33, mesh=mesh, block=64
    )
    s_np = pw.shared_kmer_matrix_numpy(offsets, members, weights, 33)
    assert np.array_equal(s_sharded, s_np)


def test_sharded_fewer_blocks_than_devices(rng):
    offsets, members, weights = random_csr(rng, 10, 5, max_degree=3, max_weight=3)
    mesh = mesh_lib.make_mesh(8)
    s_sharded = sharded_pairwise.shared_kmer_matrix_sharded(
        offsets, members, weights, 5, mesh=mesh, block=4
    )
    s_np = pw.shared_kmer_matrix_numpy(offsets, members, weights, 5)
    assert np.array_equal(s_sharded, s_np)

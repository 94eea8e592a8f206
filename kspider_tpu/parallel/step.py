"""The fused pipeline step: colors -> shared-kmer matrix -> containment ->
threshold adjacency -> connected-components labels, in ONE jit over the
device mesh.

This is the flagship compute graph of the framework: the reference needs
three separate processes (C++ pairwise, TSV round-trip, Python/rustworkx
clustering — /root/reference/src/pairwise.cpp, ks_clustering.py); here the
entire analysis after ingestion runs on-device with a single ``psum`` and
no host round-trips.  Colors arrive in the packed-bitmask layout
(ops/bitmask.py) — no scatter anywhere in the graph.

Integer-exactness note: the fused step combines weight limbs in int32 on
device (exact while every pairwise shared-count < 2**31, i.e. always in
practice — counts are bounded by the number of unique k-mers).  The
artifact-writing path combines on host in int64 instead.

Division note: XLA's GPU backend divides float32 with ``div.full.f32``
(within 2 ulp), not IEEE round-to-nearest, so a containment computed
here can differ in the last bit from numpy's and flip a pair that sits
exactly on the cutoff.  The CLI computes every containment on the host
(core/pairwise.containment_columns and the native TSV writers), so its
files are unaffected.
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from kspider_tpu.ops import bitmask as bm
from kspider_tpu.ops import cc as cc_ops
from kspider_tpu.ops import pairwise as pairwise_ops
from kspider_tpu.parallel.mesh import SHARD_AXIS
from kspider_tpu.parallel.sharded_pairwise import _device_body


def _combine_and_cluster(acc, kmer_counts, cutoff, n_limbs):
    """acc i32[L, n_pad, n_pad] -> (shared i32, labels i32)."""
    n = kmer_counts.shape[0]
    scale = jnp.asarray(
        [128**l for l in range(n_limbs)], dtype=jnp.int32
    ).reshape(n_limbs, 1, 1)
    shared = jnp.sum(acc[:, :n, :n] * scale, axis=0)
    shared = shared * (1 - jnp.eye(n, dtype=shared.dtype))
    counts = kmer_counts.astype(jnp.float32)
    # max containment = shared / min(k_i, k_j), the reference's default
    # clustering distance (ks_clustering.py:12-17)
    denom = jnp.minimum(counts[:, None], counts[None, :])
    cont = shared.astype(jnp.float32) / jnp.maximum(denom, 1.0)
    adj = (cont >= cutoff) & (shared > 0)
    labels = cc_ops.connected_components_dense(adj)
    return shared, labels


def single_device_step(bits, w_limbs, kmer_counts, cutoff,
                       block: int, n_pad: int, n_limbs: int):
    """Jittable single-device pipeline step (the graft ``entry`` target).

    bits u8[NB, block, n_pad/8], w_limbs i8[NB, block, L]."""
    acc = bm.cooccurrence_bitmask_blocks.__wrapped__(
        bits, w_limbs, block, n_pad, n_limbs
    )
    return _combine_and_cluster(acc, kmer_counts, cutoff, n_limbs)


def sharded_step(mesh: Mesh, bits, w_limbs, kmer_counts, cutoff,
                 block: int, n_pad: int, n_limbs: int):
    """Full multi-device step: shard color blocks, psum partial Gram
    matrices, cluster on replicated output."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(SHARD_AXIS, None, None),
            P(SHARD_AXIS, None, None),
            P(),
            P(),
        ),
        out_specs=(P(), P()),
    )
    def run(b, wl, counts, cut):
        acc = _device_body(b, wl, block, n_pad, n_limbs, axis=SHARD_AXIS)
        acc = jax.lax.psum(acc, SHARD_AXIS)
        return _combine_and_cluster(acc, counts, cut, n_limbs)

    return jax.jit(run)(bits, w_limbs, kmer_counts, cutoff)


def make_example_blocks(
    n_samples: int = 256,
    n_colors: int = 2048,
    block: int = 256,
    seed: int = 0,
    max_weight: int = 1000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int, int]:
    """Deterministic synthetic packed inputs for entry/dryrun/bench.

    Returns (bits, w_limbs, kmer_counts, block, n_pad, n_limbs).
    """
    rng = np.random.default_rng(seed)
    degrees = rng.integers(2, 6, size=n_colors)
    offsets = np.zeros(n_colors + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    members = rng.integers(0, n_samples, size=int(offsets[-1])).astype(np.int64)
    weights = rng.integers(1, max_weight, size=n_colors).astype(np.int64)
    w_limbs = pairwise_ops.weight_limbs(weights)
    n_limbs = w_limbs.shape[1]
    bits = bm.pack_bitmask_blocks(offsets, members, n_samples, block)
    nb = bits.shape[0]
    n_pad = bits.shape[2] * 8
    wl = np.zeros((nb * block, n_limbs), dtype=np.int8)
    wl[:n_colors] = w_limbs
    wl = wl.reshape(nb, block, n_limbs)
    kmer_counts = rng.integers(5_000, 50_000, size=n_samples).astype(np.int32)
    return bits, wl, kmer_counts, block, n_pad, n_limbs

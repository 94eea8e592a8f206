"""Hash-range work partitioning for coordinated processes.

The reference is strictly single-node (OpenMP); this framework scales
over ``jax.distributed`` processes (parallel/multiprocess.py, which also
initializes them).  The ingestion/index build is embarrassingly parallel
over hash ranges: every unique k-mer hash belongs to exactly one range,
so each process sorts/groups only its range and the color classes
concatenate without reconciliation (a class's member set is derived from
a single hash's postings, which never straddle ranges).

Each process calls :func:`my_hash_range` to pick its slice of the u64
hash space, builds a local :class:`ColorIndex` from its postings, and the
partial Gram matrices are merged by one psum across processes.
"""

from typing import Optional, Tuple

import jax
import numpy as np


def my_hash_range(
    process_id: Optional[int] = None, num_processes: Optional[int] = None
) -> Tuple[int, int]:
    """This process's [lo, hi) slice of the u64 hash space."""
    if process_id is None:
        process_id = jax.process_index()
    if num_processes is None:
        num_processes = jax.process_count()
    width = (1 << 64) // num_processes
    lo = process_id * width
    hi = (1 << 64) if process_id == num_processes - 1 else lo + width
    return lo, hi


def filter_to_range(hashes: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Keep only the hashes in [lo, hi)."""
    h = np.asarray(hashes, dtype=np.uint64)
    mask = h >= np.uint64(lo)
    if hi < (1 << 64):
        mask &= h < np.uint64(hi)
    return h[mask]


def merge_partial_matrices(partials) -> np.ndarray:
    """Host-side merge of per-range shared-kmer matrices (ranges are
    disjoint, so the merge is a plain sum)."""
    out = None
    for p in partials:
        out = p.copy() if out is None else out + p
    return out

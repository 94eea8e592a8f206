"""On-device index ingestion: sort postings, find runs, drop singletons.

The index build is a sort + run-length problem (core/index.py).  On a
small host the u64 sort dominates; this module moves it to the device:

  1. (hash, gid) postings arrive as (hi32, lo32, gid) columns;
     ``jax.lax.sort`` with three lexicographic keys sorts them on device;
  2. duplicate (hash, gid) pairs are masked;
  3. run lengths (postings per unique hash) come from two associative
     scans (run-start index forward, run-end index backward) — no scatter;
  4. postings in singleton runs are filtered out: a hash owned by one
     sample contributes nothing to the pairwise matrix, and in typical
     collections that is the large majority of postings;
  5. the surviving multi-sample postings are compacted to the front with
     a stable flag sort and returned with their count.

The host then groups the (small) compacted set into color classes; the
per-group singleton counts needed for the colorsCount artifact are
recovered arithmetically (unique-total minus multi-postings per group).

Everything is O(P log P) sorts and O(P) scans — plain ``lax`` ops that
compile for any backend.
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _compact_multi_postings(hi, lo, gid):
    """Sort, dedupe, and keep only postings of runs with >= 2 samples.

    Returns (hi, lo, gid, keep_count, unique_per_gid_input_order) where the
    first keep_count entries of the sorted outputs are the surviving
    postings (ascending (hash, gid) order).
    """
    p = hi.shape[0]
    hi, lo, gid = jax.lax.sort((hi, lo, gid), num_keys=3)

    same_hash = jnp.concatenate(
        [jnp.zeros(1, bool), (hi[1:] == hi[:-1]) & (lo[1:] == lo[:-1])]
    )
    dup = same_hash & jnp.concatenate(
        [jnp.zeros(1, bool), gid[1:] == gid[:-1]]
    )
    new_run = ~same_hash

    idx = jnp.arange(p, dtype=jnp.int32)
    # run start per posting: forward max-scan of start indices
    starts = jnp.where(new_run, idx, -1)
    run_start = jax.lax.associative_scan(jnp.maximum, starts)
    # run end (exclusive): backward min-scan of next-run starts
    next_start = jnp.where(
        jnp.concatenate([new_run[1:], jnp.ones(1, bool)]), idx + 1, p + 1
    )
    run_end = jax.lax.associative_scan(
        jnp.minimum, next_start, reverse=True
    )
    # distinct samples in the run = run postings minus duplicates; count
    # duplicates per run via prefix sums over the dup mask
    dup_i32 = dup.astype(jnp.int32)
    dup_prefix = jnp.cumsum(dup_i32)
    dup_before_start = jnp.where(
        run_start > 0, dup_prefix[jnp.maximum(run_start - 1, 0)], 0
    )
    dup_through_end = dup_prefix[run_end - 1]
    run_dups = dup_through_end - dup_before_start
    run_samples = (run_end - run_start) - run_dups

    keep = (~dup) & (run_samples >= 2)
    keep_count = jnp.sum(keep.astype(jnp.int32))
    # stable partition: kept postings first, original order preserved
    order_key = (~keep).astype(jnp.int32)
    _, hi_k, lo_k, gid_k = jax.lax.sort(
        (order_key, hi, lo, gid), num_keys=1, is_stable=True
    )
    return hi_k, lo_k, gid_k, keep_count


def _posting_bucket(m: int) -> int:
    """Quarter-octave padded length for ``m`` postings.

    Every dataset has a different posting count; without padding each
    build compiles a fresh sort/scan program for its exact shape.
    Buckets bound the compile-cache entries at <=25% pad waste."""
    if m <= 4096:
        return 4096
    p = 1 << ((m - 1).bit_length() - 1)
    step = max(1, p // 4)
    return -(-m // step) * step


#: pad sentinel: sorts after every real posting and forms a
#: single-gid (= singleton) run, so the kernel filters it out and
#: ``keep_count`` is unaffected.
_PAD_HASH = np.uint64(0xFFFFFFFFFFFFFFFF)
_PAD_GID = np.int32(0x7FFFFFFF)


def compact_multi_postings(
    hashes: np.ndarray, gids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Device-accelerated: return the deduplicated (hash, gid) postings
    whose hash is shared by >= 2 samples, sorted by (hash, gid)."""
    hashes = np.asarray(hashes, dtype=np.uint64)
    gids = np.asarray(gids, dtype=np.int32)
    hi = (hashes >> np.uint64(32)).astype(np.uint32)
    lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pad = _posting_bucket(len(hashes)) - len(hashes)
    if pad and not bool(np.any(hashes == _PAD_HASH)):
        # a real hash equal to the sentinel would share its run and
        # miscount it as multi-sample — fall back to the exact shape in
        # that (astronomically rare, adversarial-input) case
        hi = np.concatenate(
            [hi, np.full(pad, 0xFFFFFFFF, dtype=np.uint32)]
        )
        lo = np.concatenate(
            [lo, np.full(pad, 0xFFFFFFFF, dtype=np.uint32)]
        )
        gids_in = np.concatenate([gids, np.full(pad, _PAD_GID)])
    else:
        gids_in = gids
    hi_k, lo_k, gid_k, count = _compact_multi_postings(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(gids_in)
    )
    k = int(count)  # the one scalar sync before the sized D2H
    # device-slice at a bucketed length (shared compiles across counts),
    # trim the <=25% overhang on host: D2H bytes track the kept postings
    kb = min(_posting_bucket(max(k, 1)), hi_k.shape[0])
    hi_k = np.asarray(hi_k[:kb])[:k].astype(np.uint64)
    lo_k = np.asarray(lo_k[:kb])[:k].astype(np.uint64)
    out_hashes = (hi_k << np.uint64(32)) | lo_k
    return out_hashes, np.asarray(gid_k[:kb])[:k].copy()

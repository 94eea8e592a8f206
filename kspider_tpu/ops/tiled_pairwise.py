"""Panel-streamed pairwise for sample counts beyond one device matrix.

The full-matrix engines (ops/bitmask.py, parallel/sharded_pairwise.py)
hold the NxN int64 result on host — fine to ~16K samples, hopeless at
100K (80GB).
This module streams the Gram matrix panel-pair by panel-pair instead:

  1. Samples are split into fixed panels of P ids.  A color (a set of
     samples sharing identical k-mer membership) contributes to panel
     pair (I, J) only if it has >=1 member in each (>=2 members within I
     for the diagonal pair), so the per-color panel decomposition — the
     analogue of the reference's per-color ``Combo`` enumeration
     (/root/reference/src/pairwise.cpp:199-237) but at panel granularity —
     prunes the vast majority of (color, tile) work for low-degree colors.
  2. For each panel pair the selected colors are re-packed into compact
     bitmask blocks (only the two panels' columns) and a scan of int8
     matmuls accumulates S_IJ = A_I^T diag(w) A_J on the device.
  3. The weight limbs are recombined and the tile sparsified ON DEVICE
     in two phases: mask+count first (one scalar D2H), then a
     ``jnp.nonzero`` gather at a bucketed capacity sized to the actual
     count — so the bytes crossing HBM->host are ~= the surviving rows,
     not a worst-case static cap.  Host memory is O(nonzero pairs per
     panel row).
  4. Rows stream to the pairwise TSV sorted by (source_1, source_2):
     iterating panel-row I over pairs (I, J>=I) covers every i<j pair
     with i in panel I exactly once.

Exactness matches the full-matrix path: int8 matmuls with int32
accumulation, base-128 weight limbs, super-block splits keeping every
accumulator below 2**31.
"""

import functools
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kspider_tpu.ops import bitmask as bm
from kspider_tpu.ops import pairwise as pw


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class PanelPlan:
    """Preprocessed color->panel decomposition (all host-side numpy)."""

    n: int
    panel: int
    n_panels: int
    mem_s: np.ndarray  # postings sorted by (color, member)
    seg_start: np.ndarray  # per (color, panel) segment -> start into mem_s
    seg_count: np.ndarray
    seg_color: np.ndarray  # compacted color id per segment
    w_limbs: np.ndarray  # (C_kept, L) base-128 limbs
    pair_keys: np.ndarray  # sorted unique pi * n_panels + pj (pi <= pj)
    pair_off: np.ndarray  # CSR offsets into ent_* per pair
    ent_sega: np.ndarray  # per entry: segment index of the row-panel side
    ent_segb: np.ndarray  # per entry: segment index of the col-panel side
    max_weight_sum: int  # upper bound on any S entry (= sum of kept weights)
    # (n, len(offsets), len(members)) of the source CSR — lets plan-reuse
    # callers detect a plan built from a different index (see
    # stream_pairwise_tsv).  Empty tuple on hand-built plans predating it.
    src_shape: tuple = ()

    @property
    def n_limbs(self) -> int:
        return self.w_limbs.shape[1]


def build_panel_plan(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    panel: int,
) -> PanelPlan:
    """Decompose the color CSR into per-panel-pair work lists."""
    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members)  # sample ids < n always fit int32
    weights = np.asarray(weights, dtype=np.int64)
    degrees = np.diff(offsets)
    keep = np.flatnonzero(degrees >= 2)
    n_panels = max(1, _cdiv(n, panel))

    empty = PanelPlan(
        n=n, panel=panel, n_panels=n_panels,
        mem_s=np.zeros(0, np.int32),
        seg_start=np.zeros(0, np.int64), seg_count=np.zeros(0, np.int64),
        seg_color=np.zeros(0, np.int64),
        w_limbs=np.zeros((0, 1), np.int8),
        pair_keys=np.zeros(0, np.int64),
        pair_off=np.zeros(1, np.int64),
        ent_sega=np.zeros(0, np.int64), ent_segb=np.zeros(0, np.int64),
        max_weight_sum=0,
        src_shape=(int(n), len(offsets), len(members)),
    )
    if len(keep) == 0 or n == 0:
        return empty

    # ColorIndex CSRs keep each class's members ascending — when that
    # holds (the common case) segments are computed DIRECTLY on the
    # full posting array: color boundaries are the CSR offsets
    # themselves, segments of degree<2 colors are dropped at segment
    # scale, and mem_s aliases the caller's members array.  Zero
    # posting-scale temporaries beyond one panel-id array — a
    # gather/repeat/arange path materializes ~28 GB of fresh allocations
    # at 1B postings, and first-touch page faults make allocation count,
    # not FLOPs, dominate the plan build (CLAUDE.md).
    viol = (np.flatnonzero(members[1:] < members[:-1]) + 1
            if len(members) > 1 else np.zeros(0, np.int64))
    unsorted_within = bool(len(viol)) and not bool(
        np.isin(viol, offsets[1:-1]).all()
    )
    if unsorted_within:
        # rare path (tests, external CSRs): compact to kept postings
        # and 2-key sort as before
        kept_deg = degrees[keep]
        new_off = np.zeros(len(keep) + 1, dtype=np.int64)
        np.cumsum(kept_deg, out=new_off[1:])
        gather = np.repeat(offsets[keep], kept_deg) + (
            np.arange(int(kept_deg.sum())) - np.repeat(new_off[:-1], kept_deg)
        )
        mem = members[gather].astype(np.int32, copy=False)
        cid = np.repeat(np.arange(len(keep), dtype=np.int32), kept_deg)
        order = np.lexsort((mem, cid))
        mem_s = mem[order]
        cid_s = cid[order]
        pan_s = mem_s // np.int32(panel)
        new_seg = np.empty(len(cid_s), dtype=bool)
        new_seg[0] = True
        np.not_equal(cid_s[1:], cid_s[:-1], out=new_seg[1:])
        np.logical_or(new_seg[1:], pan_s[1:] != pan_s[:-1],
                      out=new_seg[1:])
        seg_start = np.flatnonzero(new_seg)
        seg_count = np.diff(np.append(seg_start, len(cid_s)))
        seg_color = cid_s[seg_start].astype(np.int64)
        seg_panel = pan_s[seg_start]
    else:
        mem_s = members.astype(np.int32, copy=False)
        total = len(mem_s)
        pan_s = mem_s // np.int32(panel)
        new_seg = np.empty(total, dtype=bool)
        new_seg[0] = True
        np.not_equal(pan_s[1:], pan_s[:-1], out=new_seg[1:])
        bounds = offsets[1:-1]
        new_seg[bounds[bounds < total]] = True  # color starts
        seg_start = np.flatnonzero(new_seg)
        seg_count = np.diff(np.append(seg_start, total))
        seg_color_orig = np.searchsorted(offsets, seg_start, side="right") - 1
        seg_panel = pan_s[seg_start]
        del pan_s
        # drop segments of degree<2 colors; remap color ids to the
        # kept-compacted space the weight limbs are built over
        seg_keep = degrees[seg_color_orig] >= 2
        seg_start = seg_start[seg_keep]
        seg_count = seg_count[seg_keep]
        seg_panel = seg_panel[seg_keep]
        kidx = np.zeros(len(degrees), np.int64)
        kidx[keep] = np.arange(len(keep))
        seg_color = kidx[seg_color_orig[seg_keep]]

    # per color: contiguous run of segments in `uniq` (seg_color is
    # nondecreasing, same scan trick)
    if len(seg_color):
        first_mask = np.empty(len(seg_color), dtype=bool)
        first_mask[0] = True
        np.not_equal(seg_color[1:], seg_color[:-1], out=first_mask[1:])
        col_first = np.flatnonzero(first_mask)
        col_t = np.diff(np.append(col_first, len(seg_color)))
    else:
        col_first = np.zeros(0, np.int64)
        col_t = np.zeros(0, np.int64)

    ent_pa, ent_pb, ent_sa, ent_sb = [], [], [], []
    for t in np.unique(col_t):
        t = int(t)
        rows = np.flatnonzero(col_t == t)
        segidx = col_first[rows][:, None] + np.arange(t)  # (m, t)
        pans = seg_panel[segidx]
        cnts = seg_count[segidx]
        ia, ib = np.triu_indices(t)
        valid = np.ones((len(rows), len(ia)), dtype=bool)
        diag = ia == ib
        if diag.any():
            valid[:, diag] = cnts[:, ia[diag]] >= 2
        pa, pb = pans[:, ia], pans[:, ib]
        sa, sb = segidx[:, ia], segidx[:, ib]
        ent_pa.append(pa[valid])
        ent_pb.append(pb[valid])
        ent_sa.append(sa[valid])
        ent_sb.append(sb[valid])

    pa = np.concatenate(ent_pa)
    pb = np.concatenate(ent_pb)
    sa = np.concatenate(ent_sa)
    sb = np.concatenate(ent_sb)
    if len(pa) == 0:
        return empty
    pk = pa.astype(np.int64) * n_panels + pb
    order2 = np.argsort(pk, kind="stable")
    pk_s, sa_s, sb_s = pk[order2], sa[order2], sb[order2]
    pair_keys, pair_first, pair_cnt = np.unique(
        pk_s, return_index=True, return_counts=True
    )
    pair_off = np.zeros(len(pair_keys) + 1, dtype=np.int64)
    np.cumsum(pair_cnt, out=pair_off[1:])

    kept_w = weights[keep]
    return PanelPlan(
        n=n, panel=panel, n_panels=n_panels,
        mem_s=mem_s,
        seg_start=seg_start.astype(np.int64),
        seg_count=seg_count.astype(np.int64),
        seg_color=seg_color,
        w_limbs=pw.weight_limbs(kept_w),
        pair_keys=pair_keys,
        pair_off=pair_off,
        ent_sega=sa_s.astype(np.int64),
        ent_segb=sb_s.astype(np.int64),
        max_weight_sum=int(kept_w.sum()),
        src_shape=(int(n), len(offsets), len(members)),
    )


def panel_row_work(plan: PanelPlan) -> np.ndarray:
    """Per-panel-row pair-entry counts — the load estimate used to assign
    whole panel rows to processes (parallel/multiprocess.py)."""
    lengths = np.diff(plan.pair_off)
    pis = plan.pair_keys // plan.n_panels
    work = np.zeros(plan.n_panels, dtype=np.int64)
    np.add.at(work, pis.astype(np.int64), lengths)
    return work


def filter_plan_rows(plan: PanelPlan, rows) -> PanelPlan:
    """Restrict a plan to the panel pairs whose ROW panel is in ``rows``.

    Shares all posting/segment arrays with the parent plan; only the
    pair CSR is rebuilt.  A sample pair (gi, gj) with gi < gj is emitted
    by exactly one panel pair — (gi // panel, gj // panel) — so panel
    rows partition the streamed output into disjoint, contiguous blocks
    of the global (gi, gj) sort order: per-row outputs computed by
    different processes concatenate (in row order) to the exact
    single-process stream.
    """
    rows = np.asarray(sorted({int(r) for r in np.asarray(rows).ravel()}))
    pis = plan.pair_keys // plan.n_panels
    keep = np.flatnonzero(np.isin(pis, rows))
    lengths = np.diff(plan.pair_off)
    new_off = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(lengths[keep], out=new_off[1:])
    # CSR gather idiom (repeat of starts + intra-pair ramp), no Python loop
    ent_idx = np.repeat(plan.pair_off[keep], lengths[keep]) + (
        np.arange(int(new_off[-1])) - np.repeat(new_off[:-1], lengths[keep])
    )
    return PanelPlan(
        n=plan.n, panel=plan.panel, n_panels=plan.n_panels,
        mem_s=plan.mem_s,
        seg_start=plan.seg_start, seg_count=plan.seg_count,
        seg_color=plan.seg_color, w_limbs=plan.w_limbs,
        pair_keys=plan.pair_keys[keep],
        pair_off=new_off,
        ent_sega=plan.ent_sega[ent_idx],
        ent_segb=plan.ent_segb[ent_idx],
        max_weight_sum=plan.max_weight_sum,
        src_shape=plan.src_shape,
    )


def _gather_side(plan: PanelPlan, segs: np.ndarray):
    """Selected segments -> (local CSR offsets, member ids)."""
    cnt = plan.seg_count[segs]
    off = np.zeros(len(segs) + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    idx = np.repeat(plan.seg_start[segs], cnt) + (
        np.arange(int(off[-1])) - np.repeat(off[:-1], cnt)
    )
    return off, plan.mem_s[idx]


def _rect_scan(bits_i, bits_j, wl, n_limbs: int, axis=None):
    """Scan color blocks, accumulating the rectangular weighted Gram.

    bits_* u8[NB, block, P/8], wl i8[NB, block, L]
    -> i32[L, Pi, Pj].  ``axis`` marks the carry varying inside shard_map."""
    pi = bits_i.shape[2] * 8
    pj = bits_j.shape[2] * 8

    def body(acc, xs):
        bi, bj, w = xs
        ai = bm.unpack_bits_to_int8(bi)  # [block, Pi]
        aj = bm.unpack_bits_to_int8(bj)

        def limb(l, acc):
            wa = ai * w[:, l][:, None]
            s = jax.lax.dot_general(
                wa, aj,
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            return acc.at[l].add(s)

        return jax.lax.fori_loop(0, n_limbs, limb, acc), None

    acc0 = jnp.zeros((n_limbs, pi, pj), dtype=jnp.int32)
    if axis is not None:
        acc0 = jax.lax.pcast(acc0, axis, to="varying")
    acc, _ = jax.lax.scan(body, acc0, (bits_i, bits_j, wl))
    return acc


@functools.partial(jax.jit, static_argnames=("block", "n_limbs"))
def _gram_rect_xla(bits_i, bits_j, wl, block: int, n_limbs: int):
    """Single-device tile engine."""
    return _rect_scan(bits_i, bits_j, wl, n_limbs)


@functools.lru_cache(maxsize=8)
def _gram_rect_sharded_fn(mesh, n_limbs: int):
    """Build (and cache) the jitted shard_map tile engine for a mesh.

    Cached at module level keyed by (mesh, n_limbs) so repeat panel-pair
    chunks on the multichip tiled path hit the jit trace cache instead of
    retracing a fresh closure every call (jax.Mesh is hashable)."""
    from jax.sharding import PartitionSpec as P

    from kspider_tpu.parallel.mesh import SHARD_AXIS

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(SHARD_AXIS, None, None),
            P(SHARD_AXIS, None, None),
            P(SHARD_AXIS, None, None),
        ),
        out_specs=P(),
    )
    def run(bi, bj, w):
        acc = _rect_scan(bi, bj, w, n_limbs, axis=SHARD_AXIS)
        return jax.lax.psum(acc, SHARD_AXIS)

    return jax.jit(run)


def _gram_rect_sharded(bits_i, bits_j, wl, n_limbs: int, mesh):
    """Mesh-parallel tile engine: color blocks sharded over the mesh's
    ``shards`` axis, per-device partial tiles merged with one psum.
    Block count must be a multiple of the mesh size."""
    return _gram_rect_sharded_fn(mesh, n_limbs)(bits_i, bits_j, wl)


@functools.partial(jax.jit, static_argnames=("n_limbs", "diag"))
def _combine_mask(acc, min_shared, n_limbs: int, diag: bool):
    """Extract phase A: recombine weight limbs, mask, count — no D2H yet.

    acc i32[L, Pi, Pj] -> (flat masked tile i32[Pi*Pj] device-resident,
    nonzero count scalar).  Values below ``min_shared`` are zeroed; for a
    diagonal panel pair only the strict upper triangle survives.  Exact
    while the true entry sum stays below 2**31 — partial sums of the
    nonnegative limb terms are bounded by the true value; callers route
    larger weight sums to ``_limb_mask``/``_gather_limbs``.

    Two-phase extract: only the scalar count crosses D2H here; the host
    then picks a bucketed capacity ~= count and ``_gather_nonzero`` ships
    exactly that many entries — instead of a fixed worst-case ``cap``
    payload per panel pair (the round-3 engine shipped >=2MB/pair even
    when a pair had a handful of surviving rows)."""
    tile = acc[0]
    scale = 1
    for l in range(1, n_limbs):
        scale *= 128
        tile = tile + acc[l] * jnp.int32(scale)
    pi, pj = tile.shape
    mask = tile >= min_shared
    if diag:
        row = jax.lax.broadcasted_iota(jnp.int32, (pi, pj), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (pi, pj), 1)
        mask = mask & (row < col)
    flat = jnp.where(mask, tile, 0).ravel()
    count = (flat > 0).sum()
    return flat, count


@functools.partial(jax.jit, static_argnames=("cap",))
def _gather_nonzero(flat, cap: int):
    """Extract phase B: gather the masked entries at a sized capacity.

    flat i32[M] -> (idx i32[cap], vals i32[cap]); slots past the true
    count hold fill (idx == M, vals 0) and are sliced off on host."""
    m = flat.shape[0]
    (idx,) = jnp.nonzero(flat, size=cap, fill_value=m)
    vals = jnp.where(idx < m, flat[jnp.minimum(idx, m - 1)], 0)
    return idx.astype(jnp.int32), vals


@functools.partial(jax.jit, static_argnames=("diag",))
def _limb_mask(acc, diag: bool):
    """Phase A of the big-weight extract (total kept weight >= 2**31):
    the combined tile would overflow int32 on device, but each limb plane
    is individually exact, so the support mask (any limb nonzero) is
    computed here and per-limb int32 values ship via ``_gather_limbs``
    for int64 host recombination — the streamed analogue of the dense
    path's super-block int64 recombine (ops/pairwise.py
    shared_kmer_matrix).  min_shared filtering happens on host."""
    pi, pj = acc.shape[1], acc.shape[2]
    mask = jnp.any(acc != 0, axis=0)
    if diag:
        row = jax.lax.broadcasted_iota(jnp.int32, (pi, pj), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (pi, pj), 1)
        mask = mask & (row < col)
    flat_mask = mask.ravel()
    count = flat_mask.sum()
    return flat_mask, count


@functools.partial(jax.jit, static_argnames=("cap", "n_limbs"))
def _gather_limbs(acc, flat_mask, cap: int, n_limbs: int):
    """Phase B of the big-weight extract: sized per-limb gather."""
    m = acc.shape[1] * acc.shape[2]
    (idx,) = jnp.nonzero(flat_mask, size=cap, fill_value=m)
    safe = jnp.minimum(idx, m - 1)
    vals = acc.reshape(n_limbs, m)[:, safe]
    vals = jnp.where(idx[None, :] < m, vals, 0)
    return idx.astype(jnp.int32), vals


_add = jax.jit(lambda x, y: x + y)


def _pack_side(off, mem_local, n_blocks: int, block: int,
               panel_pad: int) -> np.ndarray:
    """Local CSR -> bitmask blocks padded to ``n_blocks`` color blocks."""
    n_colors = len(off) - 1
    pad_colors = n_blocks * block - n_colors
    if pad_colors:
        off = np.concatenate([off, np.full(pad_colors, off[-1], dtype=np.int64)])
    return bm.pack_bitmask_blocks(off, mem_local, panel_pad, block)


def _pack_panel_side(
    plan: PanelPlan, panel_id: int, segs_slice: np.ndarray, n_blocks: int,
    block: int, panel_pad: int,
) -> np.ndarray:
    """Pack one panel pair side straight from the plan's segment CSR.

    Native fast path: ``ks_pack_segments`` (OpenMP over segments)
    replaces the single-threaded ``np.bitwise_or.at`` pack."""
    from kspider_tpu.io import native

    if native.enabled():
        try:
            if not native.available():
                raise RuntimeError(
                    f"native library failed to load: {native.load_error()!r}"
                )
            return native.pack_segments(
                plan.mem_s,
                plan.seg_start[segs_slice],
                plan.seg_count[segs_slice],
                panel_id * plan.panel,
                panel_pad // 8,
                block,
                n_blocks,
            )
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("pack_segments", exc)
    off, mem = _gather_side(plan, segs_slice)
    return _pack_side(off, mem - panel_id * plan.panel, n_blocks, block,
                      panel_pad)


def _block_bucket(nb: int) -> int:
    """Padded color-block count for a chunk (bounds kernel recompiles).

    Exact for 1-4 blocks, then quarter-octave (4 sizes per power of
    two): <=25% padded GEMM work, ~21 shapes to 128 blocks.  The old
    power-of-two rule wasted up to 33% at the streamed engine's typical
    5-6 real blocks per pair (padded to 8) and up to 94% just above its
    32-block knee."""
    if nb <= 4:
        return max(1, nb)
    p = 1 << ((nb - 1).bit_length() - 1)
    step = max(1, p // 4)
    return -(-nb // step) * step


class _PostingsSide(tuple):
    """Marker wrapper: a panel side shipped as sorted posting keys for
    on-device packing (ops/bitmask.scatter_pack_device) instead of a
    host-packed bitmask.  Fields: (payload, n_blocks) where payload is
    either raw keys i32[bucket] or the delta-compressed form
    ("d16", first, i16 deltas, count) — 2 bytes per posting across H2D
    (bm.delta_encode_keys / scatter_pack_device_delta)."""

    __slots__ = ()


def _resolve_device_pack(engine: str, mesh) -> str:
    """Streamed-engine device-pack gate over ``bm.device_pack_policy``:
    disabled for the sharded engine (sides need a mesh layout).  The
    device side-cache composes with it: cacheable (reused) sides ship
    as host-packed bits once and stay device-resident, single-use sides
    (diagonal pairs) keep the posting-key path."""
    policy, _ = bm.device_pack_policy()
    if engine == "sharded" or mesh is not None:
        return "off"
    return policy


def _postings_keys(
    plan: PanelPlan, panel_id: int, segs_slice: np.ndarray, panel_pad: int,
    n_blocks: int, block: int,
) -> Optional[np.ndarray]:
    """Selected segments -> sorted unique i32 scatter keys, bucket-padded.

    Key = local_segment_index * panel_pad + local_member; strictly
    increasing because segments are positionally ordered and mem_s is
    member-ascending within each segment.  Pad values are ascending
    out-of-range bit positions (dropped on device).  Returns None when
    the bit-position space would overflow int32 or the keys are not
    strictly increasing (a plan built from an external CSR with
    duplicate (color, member) postings would make the scatter's
    sorted/unique hints false) — callers fall back to host packing,
    mirroring ``build_scatter_keys``."""
    cnt = plan.seg_count[segs_slice]
    m = int(cnt.sum())
    total_bits = n_blocks * block * panel_pad
    bucket = bm.key_bucket(m)
    if total_bits + bucket >= 2**31:
        return None
    off = np.zeros(len(segs_slice) + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    idx = np.repeat(plan.seg_start[segs_slice], cnt) + (
        np.arange(m) - np.repeat(off[:-1], cnt)
    )
    seg_local = np.repeat(np.arange(len(segs_slice), dtype=np.int64), cnt)
    keys = seg_local * panel_pad + (
        plan.mem_s[idx].astype(np.int64) - panel_id * plan.panel
    )
    if len(keys) > 1 and not (keys[1:] > keys[:-1]).all():
        return None
    out = np.empty(bucket, dtype=np.int32)
    out[:m] = keys
    out[m:] = total_bits + np.arange(bucket - m, dtype=np.int32)
    return out


def _pad_limbs(wl: np.ndarray, n_blocks: int, block: int):
    n_limbs = wl.shape[1]
    out = np.zeros((n_blocks * block, n_limbs), dtype=np.int8)
    out[: len(wl)] = wl
    return out.reshape(n_blocks, block, n_limbs)


class _DeviceSideCache:
    """Device-resident LRU for packed panel sides.

    A panel side's bitmask depends only on (panel, selected segments,
    padding geometry) — and across panel pairs the selection repeats
    heavily (any color spanning many panels contributes the *same*
    packed side to every pair of its row/column).  Caching the device
    arrays turns those repeats into device-memory hits instead of a
    re-pack and a fresh host-to-device transfer per pair.  Budget-bounded,
    LRU-evicted; a zero budget disables caching.
    """

    def __init__(self, budget_bytes: int):
        from collections import OrderedDict

        self.budget = budget_bytes
        self.entries = OrderedDict()
        self.nbytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key):
        arr = self.entries.get(key)
        if arr is not None:
            self.entries.move_to_end(key)
            self.hits += 1
        else:
            self.misses += 1
        return arr

    def put(self, key, arr, nbytes: int):
        if self.budget <= 0 or nbytes > self.budget:
            return
        while self.nbytes + nbytes > self.budget and self.entries:
            _, (old, old_bytes) = self.entries.popitem(last=False)
            del old
            self.nbytes -= old_bytes
        self.entries[key] = (arr, nbytes)
        self.nbytes += nbytes

    def lookup(self, key):
        ent = self.get(key)
        return ent[0] if ent is not None else None


def _segs_digest(segs: np.ndarray) -> bytes:
    import hashlib

    return hashlib.blake2b(
        np.ascontiguousarray(segs).tobytes(), digest_size=16
    ).digest()


#: panel widths are padded to a multiple of this: the packed byte width
#: (panel_pad / 8) stays a multiple of 16 bytes and both GEMM output
#: dimensions a multiple of the 128-wide tiles cuBLAS's int8 kernels use
PANEL_ALIGN = 128


def iter_panel_pairs(
    plan: PanelPlan,
    engine: str = "auto",
    block: int = 1024,
    tile: int = PANEL_ALIGN,
    min_shared: int = 1,
    cap0: int = 512,
    mesh=None,
    cache_bytes: int = 0,
    stats: Optional[dict] = None,
) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (pi, pj, gi, gj, shared) for every panel pair with work.

    ``gi``/``gj`` are global 0-based sample ids with gi < gj; ``shared``
    the exact shared-k-mer counts >= min_shared.  ``engine``: "auto"
    (one device: "xla"; several local devices: pair round-robin or a
    mesh, below), "xla" (one device) or "sharded"; passing ``mesh``
    shards each pair's color blocks over the mesh.  ``tile`` is the padding unit of the panel
    width (see :data:`PANEL_ALIGN`).
    ``cache_bytes`` bounds the device-resident packed-side LRU (default
    off — enable for workloads whose colors span many panels, where
    off-diagonal panel pairs re-select the same sides; on
    diagonal-dominated workloads it only occupies HBM); pass a dict as
    ``stats`` to receive hit/miss/resident-byte counters.

    Side payload: sparse sides ship as sorted posting keys and are
    scatter-packed on device (``KSPIDER_DEVICE_PACK`` /
    ``KSPIDER_DEVICE_PACK_RATIO``, see ``_resolve_device_pack``); dense
    sides stay host-packed via the native OpenMP packer.
    """
    devices = None
    if mesh is None and engine == "auto":
        n_local = len(jax.local_devices())
        if n_local == 1:
            engine = "xla"
        elif (len(plan.pair_keys) >= 2 * n_local
                and cache_bytes <= 0):
            # panel-pair data parallelism: independent pairs round-robin
            # to local devices, results re-ordered to the plan order on
            # the host — ZERO collectives, no psum, no replicated output
            # tiles (the intra-host analogue of the multi-process layer's
            # panel-row ownership).  Skipped when the device side-cache
            # is on (cached arrays are committed to one placement).
            devices = jax.local_devices()
            engine = "xla"
        else:
            # few pairs: shard each pair's color blocks over the local
            # devices and psum instead
            from kspider_tpu.parallel.mesh import make_mesh

            mesh = make_mesh()
    if mesh is not None:
        engine = "sharded"
    if engine not in ("xla", "sharded"):
        raise ValueError(f"unknown tiled engine {engine!r}")
    # Total kept weight >= 2**31: the on-device int32 limb combine would
    # overflow, so extraction switches to per-limb D2H + int64 host
    # recombination (the streamed analogue of the dense path's
    # super-block int64 recombine, ops/pairwise.py).  Per-limb device
    # accumulation across chunks stays exact: acc[l] <= 127 * colors and
    # any pair with > _MAX_COLORS_PER_CALL colors is accumulated on host.
    big_weights = plan.max_weight_sum >= 2**31
    n_limbs = plan.n_limbs
    panel_pad = max(tile, _cdiv(plan.panel, tile) * tile)
    sup = pw._MAX_COLORS_PER_CALL - (pw._MAX_COLORS_PER_CALL % block)

    cache = _DeviceSideCache(cache_bytes)
    side_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from kspider_tpu.parallel.mesh import SHARD_AXIS

        side_sharding = NamedSharding(mesh, P(SHARD_AXIS, None, None))
    dp_policy = _resolve_device_pack(engine, mesh)
    dp_ratio = bm.device_pack_policy()[1]
    xfer = dict(bits_bytes=0, keys_bytes=0, bits_sides=0, keys_sides=0)

    def _put_device(host_arr):
        """Move a packed host array onto the device(s) so cache hits skip
        both the pack and the host-to-device transfer."""
        return jax.device_put(host_arr, side_sharding)

    def _side(panel_id, segs_slice, n_blocks, cacheable=True):
        if cache.budget <= 0 or not cacheable:
            if dp_policy != "off":
                bitmask_bytes = n_blocks * block * panel_pad // 8
                m = int(plan.seg_count[segs_slice].sum())
                keys_bytes = 4 * bm.key_bucket(m)
                if dp_policy == "force" or keys_bytes * dp_ratio <= bitmask_bytes:
                    keys = _postings_keys(
                        plan, panel_id, segs_slice, panel_pad, n_blocks,
                        block,
                    )
                    if keys is not None:
                        enc = bm.encode_keys_best(keys, m)
                        if enc is not None:
                            payload = enc + (m,)
                            xfer["keys_bytes"] += 8 + sum(
                                a.nbytes for a in enc[2:]
                                if isinstance(a, np.ndarray)
                            )
                            xfer["keys_sides"] += 1
                            return _PostingsSide((payload, n_blocks))
                        xfer["keys_bytes"] += keys.nbytes
                        xfer["keys_sides"] += 1
                        return _PostingsSide((keys, n_blocks))
            bits = _pack_panel_side(
                plan, panel_id, segs_slice, n_blocks, block, panel_pad,
            )
            xfer["bits_bytes"] += bits.nbytes
            xfer["bits_sides"] += 1
            return bits
        key = ("bits", panel_id, _segs_digest(segs_slice), n_blocks)
        hit = cache.lookup(key)
        if hit is not None:
            return hit
        bits = _pack_panel_side(
            plan, panel_id, segs_slice, n_blocks, block, panel_pad,
        )
        arr = _put_device(bits)
        cache.put(key, arr, bits.nbytes)
        return arr

    def _limbs(segs_slice, n_blocks, cacheable=True):
        colors = plan.seg_color[segs_slice]
        if cache.budget <= 0 or not cacheable:
            return _pad_limbs(plan.w_limbs[colors], n_blocks, block)
        key = ("wl", _segs_digest(colors), n_blocks)
        hit = cache.lookup(key)
        if hit is not None:
            return hit
        wl = _pad_limbs(plan.w_limbs[colors], n_blocks, block)
        arr = _put_device(wl)
        cache.put(key, arr, wl.nbytes)
        return arr

    def prepare(p: int):
        """Host side: pack one panel pair's chunks (overlaps device work).

        Packed sides go through the device-resident LRU — a color block
        spanning many panels is packed and transferred once per (panel,
        selection) instead of once per panel *pair*."""
        pk = int(plan.pair_keys[p])
        pi, pj = pk // plan.n_panels, pk % plan.n_panels
        e0, e1 = int(plan.pair_off[p]), int(plan.pair_off[p + 1])
        segs_a = plan.ent_sega[e0:e1]
        segs_b = plan.ent_segb[e0:e1]
        m = e1 - e0
        chunks = []
        for cs in range(0, m, sup):
            ce = min(cs + sup, m)
            n_real_blocks = _cdiv(ce - cs, block)
            n_blocks = _block_bucket(n_real_blocks)
            if mesh is not None:
                n_dev = mesh.devices.size
                n_blocks = _cdiv(n_blocks, n_dev) * n_dev
            # diagonal pairs' sides are selected by exactly one pair —
            # caching them would evict genuinely reused entries and
            # forgo the posting-key transfer; off-diagonal sides (panel-
            # spanning colors, identical selection across the row/column)
            # are where the cache pays
            cacheable = pi != pj
            bits_a = _side(pi, segs_a[cs:ce], n_blocks, cacheable)
            if pi == pj:
                bits_b = bits_a
            else:
                bits_b = _side(pj, segs_b[cs:ce], n_blocks, cacheable)
            wl = _limbs(segs_a[cs:ce], n_blocks, cacheable)
            chunks.append((bits_a, bits_b, wl))
        return pi, pj, chunks

    def _chunk_acc(bits_a, bits_b, wl, diag: bool):
        # posting-key sides materialize here — i.e. on the dispatch
        # thread, under the pair-parallel placement context, with the
        # small key array crossing H2D instead of the packed bitmask
        def _materialize(side):
            payload, nb_ = side[0], side[1]
            if isinstance(payload, tuple) and payload[0] == "d8":
                _, first, d8, exc, count = payload
                return bm.scatter_pack_device_delta8(
                    np.int32(first), d8, exc, np.int32(count), nb_,
                    block, panel_pad,
                )
            if isinstance(payload, tuple) and payload[0] == "d16":
                _, first, d16, count = payload
                return bm.scatter_pack_device_delta(
                    np.int32(first), d16, np.int32(count), nb_, block,
                    panel_pad,
                )
            return bm.scatter_pack_device(payload, nb_, block, panel_pad)

        if isinstance(bits_a, _PostingsSide):
            mat_a = _materialize(bits_a)
            if bits_b is bits_a:
                bits_b = mat_a
            bits_a = mat_a
        if isinstance(bits_b, _PostingsSide):
            bits_b = _materialize(bits_b)
        if engine == "sharded":
            return _gram_rect_sharded(bits_a, bits_b, wl, n_limbs, mesh)
        return _gram_rect_xla(bits_a, bits_b, wl, block, n_limbs)

    def dispatch(chunks, diag: bool):
        """Issue the async device calls; returns the un-synced accumulator.

        Big-weight pairs spanning more than one super-block chunk could
        overflow even the per-limb int32 sums across chunks (127 * colors
        >= 2**31 needs > ~16.9M colors in ONE panel pair) — those
        accumulate the combined tile on host in int64 instead."""
        if big_weights and len(chunks) > 1:
            tile = np.zeros((panel_pad, panel_pad), dtype=np.int64)
            for bits_a, bits_b, wl in chunks:
                acc = np.asarray(
                    _chunk_acc(bits_a, bits_b, wl, diag)
                ).astype(np.int64)
                scale = 1
                for l in range(n_limbs):
                    tile += acc[l] * scale
                    scale *= 128
            return ("host", tile)
        acc_dev = None
        for bits_a, bits_b, wl in chunks:
            acc = _chunk_acc(bits_a, bits_b, wl, diag)
            acc_dev = acc if acc_dev is None else _add(acc_dev, acc)
        return acc_dev

    # The count scalar's D2H is started here, not at extract time:
    # copy_to_host_async lets the 4-byte transfer ride alongside the next
    # pairs' dispatch so the later blocking int(cnt) pops an
    # already-landed value instead of paying one device round trip per
    # panel pair.  KSPIDER_NO_ASYNC_COUNT disables (measurement A/B).
    async_count = not os.environ.get("KSPIDER_NO_ASYNC_COUNT")

    def _prefetch(cnt):
        if async_count:
            try:
                cnt.copy_to_host_async()
            except AttributeError:  # pragma: no cover - exotic backend
                pass
        return cnt

    def phase_a(acc_dev, diag: bool):
        """Issue the (async) mask+count right after dispatch, so the
        sparsify compute overlaps the next pair's pack/H2D and only the
        sized gather remains when the pair is popped.  For the combine
        path the L-limb accumulator is dropped here — pending holds the
        single combined flat tile instead."""
        if isinstance(acc_dev, tuple):  # host-accumulated int64 tile
            return acc_dev
        if big_weights:
            flat_mask, cnt = _limb_mask(acc_dev, diag)
            return ("limbs", acc_dev, flat_mask, _prefetch(cnt))
        flat, cnt = _combine_mask(
            acc_dev, jnp.int32(min_shared), n_limbs, diag
        )
        return ("combine", flat, _prefetch(cnt))

    def _cap_bucket(count: int) -> int:
        # quarter-octave bucket: D2H payload <= 1.25x the true count,
        # bounded compile-cache entries; cap0 keeps the smallest shape
        # from churning (and lets tests pin a tiny floor)
        return min(max(bm.key_bucket(count), cap0), panel_pad * panel_pad)

    x_stats = dict(t_x_sync=0.0, t_x_gather=0.0, t_x_fetch=0.0)

    def extract(pi: int, pj: int, handle):
        import time as _t

        diag = pi == pj
        floor = max(1, min_shared)
        if handle[0] == "host":  # host-accumulated int64 tile
            tile = handle[1]
            if diag:
                tile = np.triu(tile, 1)
            idx = np.flatnonzero(tile >= floor)
            if len(idx) == 0:
                return None
            vals = tile.ravel()[idx].astype(np.int64)
        elif handle[0] == "limbs":
            # per-limb support on device, exact int64 recombine on host
            _, acc_dev, flat_mask, cnt = handle
            t0 = _t.perf_counter()
            count = int(cnt)  # the only pre-gather D2H: one scalar
            x_stats["t_x_sync"] += _t.perf_counter() - t0
            if count == 0:
                return None
            cap = _cap_bucket(count)
            t0 = _t.perf_counter()
            idx, lvals = _gather_limbs(acc_dev, flat_mask, cap, n_limbs)
            x_stats["t_x_gather"] += _t.perf_counter() - t0
            # full-bucket D2H + host slice: no per-count device slicing
            # (each distinct count would compile a fresh slice kernel)
            t0 = _t.perf_counter()
            idx = np.asarray(idx)[:count].astype(np.int64)
            lv = np.asarray(lvals)[:, :count].astype(np.int64)
            x_stats["t_x_fetch"] += _t.perf_counter() - t0
            vals = np.zeros(count, dtype=np.int64)
            scale = 1
            for l in range(n_limbs):
                vals += lv[l] * scale
                scale *= 128
            keep = vals >= floor
            idx, vals = idx[keep], vals[keep]
            if len(idx) == 0:
                return None
        else:
            _, flat, cnt = handle
            t0 = _t.perf_counter()
            count = int(cnt)
            x_stats["t_x_sync"] += _t.perf_counter() - t0
            if count == 0:
                return None
            cap = _cap_bucket(count)
            t0 = _t.perf_counter()
            idx, vals = _gather_nonzero(flat, cap)
            x_stats["t_x_gather"] += _t.perf_counter() - t0
            t0 = _t.perf_counter()
            idx = np.asarray(idx)[:count].astype(np.int64)
            vals = np.asarray(vals)[:count].astype(np.int64)
            x_stats["t_x_fetch"] += _t.perf_counter() - t0
        gi = pi * plan.panel + idx // panel_pad
        gj = pj * plan.panel + idx % panel_pad
        return gi.astype(np.int64), gj.astype(np.int64), vals

    # Software pipeline: a background thread packs pair p+1 (via the
    # OpenMP native packer) while the main thread dispatches pair p to a
    # device and extracts the oldest in-flight pair — host packing,
    # H2D+Gram, and the blocking D2H all overlap and the dispatch thread
    # never waits on packing.  With ``devices`` (pair-parallel mode) the
    # in-flight window widens to one pair per local device, dispatched
    # round-robin; extraction order stays the plan order, so the
    # downstream TSV stream is byte-identical to the single-device run.
    # Per-stage times land in ``stats``.
    import contextlib
    import time as _time
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    t_pack = t_dispatch = t_extract = 0.0

    def timed_prepare(p: int):
        t0 = _time.perf_counter()
        out = prepare(p)
        return out, _time.perf_counter() - t0

    n_pairs = len(plan.pair_keys)
    # >=4-deep window even on one device: pair p's sized D2H overlaps
    # later pairs' H2D+Gram (depth 1 serializes extract behind
    # dispatch), and the async count prefetch needs more than one
    # pair-time of slack.  Device-memory cost: one flat panel_pad^2 i32
    # tile per pending pair (~64 MB at panel 4096).
    inflight = 4 if devices is None else max(2, len(devices))
    pending = deque()  # (pi, pj, phase-A handle), oldest first
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(timed_prepare, 0) if n_pairs else None
        for p in range(n_pairs):
            (pi, pj, chunks), dt = fut.result()
            t_pack += dt
            if p + 1 < n_pairs:
                fut = ex.submit(timed_prepare, p + 1)
            t0 = _time.perf_counter()
            placement = (
                jax.default_device(devices[p % len(devices)])
                if devices is not None
                else contextlib.nullcontext()
            )
            with placement:
                acc_dev = dispatch(chunks, pi == pj)
                if os.environ.get("KSPIDER_SYNC_DISPATCH") and not (
                    isinstance(acc_dev, tuple)
                ):
                    # measurement mode: make "dispatch" wall = H2D + Gram
                    # and "extract" wall = sparsify + D2H, at the cost of
                    # the pipeline overlap — for per-stage attribution
                    jax.block_until_ready(acc_dev)
                handle = phase_a(acc_dev, pi == pj)
            t_dispatch += _time.perf_counter() - t0
            pending.append((pi, pj, handle))
            if len(pending) > inflight:
                t0 = _time.perf_counter()
                done = pending.popleft()
                out = extract(*done)
                t_extract += _time.perf_counter() - t0
                if out is not None:
                    yield done[0], done[1], *out
        while pending:
            t0 = _time.perf_counter()
            done = pending.popleft()
            out = extract(*done)
            t_extract += _time.perf_counter() - t0
            if out is not None:
                yield done[0], done[1], *out
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    if stats is not None:
        if devices is not None:
            mode, n_dev = "pair-parallel", len(devices)
        elif mesh is not None:
            mode, n_dev = "sharded", mesh.devices.size
        else:
            mode, n_dev = "xla", 1
        stats.update(
            cache_hits=cache.hits, cache_misses=cache.misses,
            cache_bytes=cache.nbytes, engine=mode, n_devices=n_dev,
            t_pack=t_pack, t_dispatch=t_dispatch, t_extract=t_extract,
            **x_stats,
            **xfer,
        )


def stream_pairwise_tsv(
    index,
    prefix: str,
    panel: int = 4096,
    engine: str = "auto",
    block: int = 1024,
    min_shared: int = 1,
    echo_progress: bool = False,
    mesh=None,
    cache_bytes: Optional[int] = None,
    stats: Optional[dict] = None,
    plan: Optional[PanelPlan] = None,
) -> int:
    """Compute pairwise at any N and stream `{p}_kSpider_pairwise.tsv`.

    Rows are emitted sorted by (source_1, source_2), matching the
    full-matrix writer (core/pairwise.py).  Returns the pair-row count.
    ``mesh`` shards each panel pair's colors across devices (psum merge).
    Pass a dict as ``stats`` (or set ``echo_progress``) for the
    per-stage breakdown: pack (host, overlapped), dispatch, extract
    (device wait + D2H), tsv.  ``plan`` reuses a prebuilt
    :func:`build_panel_plan` result (its ``panel`` must match) — the plan
    scan is a full pass over the postings, so callers that already built
    one for load estimation must not pay it twice.

    ``cache_bytes=None`` (default) auto-enables a 2 GB device-resident
    packed-side LRU on single-accelerator runs: colors spanning many
    panels (pangenome cores) make off-diagonal pairs re-select the same
    sides.  Kept off on CPU (tests) and on multi-device backends
    (pair-parallel round-robin needs uncommitted inputs); pass 0 to force
    off, or an explicit byte budget.
    """
    import time as _time

    from kspider_tpu.core.pairwise import write_pairwise_rows_coo

    if cache_bytes is None:
        cache_bytes = 0
        if (mesh is None and jax.default_backend() != "cpu"
                and len(jax.local_devices()) == 1):
            cache_bytes = 2 << 30

    if plan is None:
        plan = build_panel_plan(
            index.color_offsets, index.color_members, index.color_counts,
            index.num_groups, panel,
        )
    elif plan.panel != panel:
        raise ValueError(
            f"prebuilt plan has panel={plan.panel}, called with panel={panel}"
        )
    else:
        want = (
            int(index.num_groups),
            len(index.color_offsets),
            len(index.color_members),
        )
        if plan.n != index.num_groups or (
            plan.src_shape and tuple(plan.src_shape) != want
        ):
            raise ValueError(
                f"prebuilt plan was built from a different index: plan has "
                f"n={plan.n}, src_shape={plan.src_shape}; index has "
                f"(n, offsets, postings)={want}"
            )
    counts = np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)
    path = prefix + "_kSpider_pairwise.tsv"

    total = 0
    first = True
    t_tsv = 0.0
    run_stats: dict = {} if stats is None else stats
    # same profiler hook as the full-matrix path (core/pairwise.py):
    # KSPIDER_PROFILE=<dir> wraps the whole stream in a jax.profiler
    # trace so the device timeline of dispatch/extract can be inspected
    import contextlib

    profile_dir = os.environ.get("KSPIDER_PROFILE")
    if profile_dir:
        profile_cm = jax.profiler.trace(profile_dir)
    else:
        profile_cm = contextlib.nullcontext()
    gen = iter_panel_pairs(
        plan, engine=engine, block=block, min_shared=min_shared, mesh=mesh,
        cache_bytes=cache_bytes, stats=run_stats,
    )
    current_row = -1
    buf_i, buf_j, buf_v = [], [], []

    def flush():
        nonlocal total, first, t_tsv
        if not buf_i:
            return
        t0 = _time.perf_counter()
        gi = np.concatenate(buf_i)
        gj = np.concatenate(buf_j)
        sv = np.concatenate(buf_v)
        order = np.lexsort((gj, gi))
        write_pairwise_rows_coo(
            path, gi[order], gj[order], sv[order], counts, header=first
        )
        first = False
        total += len(gi)
        buf_i.clear()
        buf_j.clear()
        buf_v.clear()
        t_tsv += _time.perf_counter() - t0

    with profile_cm:
        for pi, pj, gi, gj, vals in gen:
            if pi != current_row:
                flush()
                current_row = pi
                if echo_progress:
                    print(f"  panel row {pi + 1}/{plan.n_panels}",
                          flush=True)
            buf_i.append(gi)
            buf_j.append(gj)
            buf_v.append(vals)
        flush()
    if first:  # no pairs at all: still write the header
        write_pairwise_rows_coo(
            path,
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), counts, header=True,
        )
    run_stats["t_tsv"] = t_tsv
    if echo_progress and "engine" in run_stats:
        print(
            f"  tiled engine: {run_stats['engine']} over "
            f"{run_stats['n_devices']} device(s)",
            flush=True,
        )
    if echo_progress and "t_pack" in run_stats:
        print(
            f"  stage breakdown: pack {run_stats['t_pack']:.1f}s "
            f"(overlapped) | dispatch {run_stats['t_dispatch']:.1f}s | "
            f"extract (device wait + D2H) {run_stats['t_extract']:.1f}s "
            f"[count-sync {run_stats.get('t_x_sync', 0.0):.1f} "
            f"gather {run_stats.get('t_x_gather', 0.0):.1f} "
            f"fetch {run_stats.get('t_x_fetch', 0.0):.1f}] | "
            f"tsv {t_tsv:.1f}s",
            flush=True,
        )
    if echo_progress and (
        run_stats.get("bits_sides", 0) + run_stats.get("keys_sides", 0) > 0
    ):
        print(
            f"  side payload: {run_stats['bits_sides']} host-packed sides "
            f"({run_stats['bits_bytes'] / 1e6:.0f}MB) + "
            f"{run_stats['keys_sides']} device-packed sides "
            f"({run_stats['keys_bytes'] / 1e6:.0f}MB posting keys)",
            flush=True,
        )
    if echo_progress and cache_bytes:
        h, m = run_stats["cache_hits"], run_stats["cache_misses"]
        print(
            f"  device side-cache: {h} hits / {m} misses "
            f"({run_stats['cache_bytes'] / 1e6:.0f}MB resident)",
            flush=True,
        )
    return total

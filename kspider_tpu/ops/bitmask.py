"""Bitmask-layout co-occurrence: the fast path of the pairwise engine.

A postings->dense-block scatter (ops/pairwise.py, engine "scatter") makes
XLA serialize the updates.  This layout stores each color's membership
as a packed bitmask (N/8 bytes per color) instead, and the device:

  1. unpacks bits to an int8 0/1 block with shifts and masks (vectorized,
     no scatter),
  2. scales by base-128 weight limbs,
  3. accumulates the Gram matrix with int8 matmuls into int32.

Packing happens on the host with vectorized numpy (``np.bitwise_or.at``)
or on the device from sorted posting keys (``scatter_pack_device``); the
packed index is 8x smaller than an int8 presence matrix.  Bit order
matches ``np.packbits`` (MSB first).
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_bitmask_blocks(
    offsets: np.ndarray, members: np.ndarray, n: int, block: int
) -> np.ndarray:
    """CSR colors -> packed membership bitmasks [NB, block, n_pad/8] u8."""
    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members, dtype=np.int64)
    num_colors = len(offsets) - 1
    num_blocks = max(1, _cdiv(num_colors, block))
    n_pad = max(128, _cdiv(n, 128) * 128)
    n8 = n_pad // 8
    bits = np.zeros((num_blocks * block, n8), dtype=np.uint8)
    degrees = np.diff(offsets)
    color_idx = np.repeat(np.arange(num_colors, dtype=np.int64), degrees)
    np.bitwise_or.at(
        bits,
        (color_idx, members // 8),
        (np.uint8(0x80) >> (members % 8).astype(np.uint8)),
    )
    return bits.reshape(num_blocks, block, n8)


def device_pack_policy() -> Tuple[str, float]:
    """(policy, ratio) from ``KSPIDER_DEVICE_PACK`` (auto/force/off,
    default auto) and ``KSPIDER_DEVICE_PACK_RATIO`` (default 1.25 — ship
    posting keys when their payload is at least this many times smaller
    than the packed bitmask).  The byte ratio is the whole decision: the
    on-device scatter-pack is assumed cheap next to the transfer it
    saves."""
    import os
    import warnings

    policy = os.environ.get("KSPIDER_DEVICE_PACK", "auto").lower()
    if policy not in ("auto", "force", "off"):
        warnings.warn(
            f"KSPIDER_DEVICE_PACK={policy!r} not in auto/force/off; "
            "using 'auto'",
            RuntimeWarning,
        )
        policy = "auto"
    raw_ratio = os.environ.get("KSPIDER_DEVICE_PACK_RATIO", "1.25")
    try:
        ratio = float(raw_ratio)
    except ValueError:
        warnings.warn(
            f"KSPIDER_DEVICE_PACK_RATIO={raw_ratio!r} is not a number; "
            "using 1.25",
            RuntimeWarning,
        )
        ratio = 1.25
    return policy, ratio


def key_bucket(m: int) -> int:
    """Padded key-array length for ``m`` postings (bounds jit retraces).

    Quarter-octave buckets (4 sizes per power of two): <=25% pad waste —
    the key payload is the whole point of the device-pack path — at ~4x
    the compile-cache entries of plain power-of-two buckets."""
    if m <= 512:
        return 512
    p = 1 << ((m - 1).bit_length() - 1)  # largest power of two < 2m
    step = max(1, p // 4)
    return -(-m // step) * step


def build_scatter_keys(
    offsets: np.ndarray, members: np.ndarray, n_pad: int, n_blocks: int,
    block: int,
) -> "np.ndarray | None":
    """CSR colors -> sorted scatter keys for ``scatter_pack_device``.

    Key = color * n_pad + member; pad values are ascending out-of-range
    bit positions (dropped on device).  Returns None when the bit space
    would overflow int32 or members are not strictly ascending within
    each color (the scatter needs sorted unique indices) — callers fall
    back to host packing."""
    offsets = np.asarray(offsets, dtype=np.int64)
    cnt = np.diff(offsets)
    m = int(cnt.sum())
    total_bits = n_blocks * block * n_pad
    bucket = key_bucket(m)
    if total_bits + bucket >= 2**31:
        return None
    cidx = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
    keys = cidx * n_pad + np.asarray(members, dtype=np.int64)
    if len(keys) > 1 and not (keys[1:] > keys[:-1]).all():
        return None
    out = np.empty(bucket, dtype=np.int32)
    out[:m] = keys
    out[m:] = total_bits + np.arange(bucket - m, dtype=np.int32)
    return out


def delta_encode_keys(keys: np.ndarray, count: int):
    """Bucket-padded i32 scatter keys -> (first, i16 deltas) or None.

    Keys are strictly increasing (scatter invariant), so consecutive
    deltas are >= 1 and — for the dense diagonal sides that dominate the
    posting-key payload at scale — almost always fit int16, halving the
    H2D bytes.  Returns None when any delta exceeds int16 (sparse
    selections with large color gaps) — callers ship raw i32 keys.
    Deltas are defined so ``decoded[i] = first + cumsum(d)[i]`` with
    ``d[0] = 0``; positions past ``count`` are don't-care (the device
    decoder masks them to ascending out-of-range sentinels).
    """
    if count <= 0:
        return None
    real = keys[:count].astype(np.int64)
    d = np.diff(real)
    if len(d) and d.max() > 32767:
        return None
    out = np.ones(len(keys), dtype=np.int16)
    out[0] = 0
    out[1:count] = d.astype(np.int16)
    return int(real[0]), out


def delta_encode_keys_u8(keys: np.ndarray, count: int):
    """Bucket-padded i32 scatter keys -> (first, u8 deltas, i32
    exceptions) or None.

    One byte per posting: literal delta values 1..255; 0 escapes to the
    next entry of the exception array (deltas are >= 1, so 0 is free as
    a marker).  Dense diagonal selections average delta ~5, so
    exceptions are vanishingly rare and the payload is ~1 B/posting —
    half of ``delta_encode_keys``'s int16 form.  Position 0 carries a
    dummy (the decoder forces d[0] = 0); the exception array is padded
    to a small power-of-two bucket to bound compile shapes."""
    if count <= 0:
        return None
    real = keys[:count].astype(np.int64)
    d = np.diff(real)
    esc = d > 255
    n_exc = int(esc.sum())
    bucket = len(keys)
    d8 = np.ones(bucket, dtype=np.uint8)
    if count > 1:
        d8[1:count] = np.where(esc, 0, np.minimum(d, 255)).astype(np.uint8)
    exc_bucket = max(8, 1 << (max(n_exc, 1) - 1).bit_length())
    exc = np.zeros(exc_bucket, np.int32)
    exc[:n_exc] = d[esc].astype(np.int32)
    return int(real[0]), d8, exc


def encode_keys_best(keys: np.ndarray, count: int):
    """Pick the smallest wire form for a padded key array.

    Returns ("d8", first, u8 deltas, i32 exceptions),
    ("d16", first, i16 deltas), or None (ship raw i32 keys)."""
    if count <= 0:
        return None
    bucket = len(keys)
    e8 = delta_encode_keys_u8(keys, count)
    bytes_d8 = bucket + 4 * len(e8[2]) if e8 else None
    e16 = delta_encode_keys(keys, count)
    bytes_d16 = 2 * bucket if e16 else None
    best = min(
        [(b, t) for b, t in ((bytes_d8, "d8"), (bytes_d16, "d16"))
         if b is not None and b < 4 * bucket],
        default=None,
    )
    if best is None:
        return None
    if best[1] == "d8":
        return ("d8",) + e8
    return ("d16",) + e16


@functools.partial(jax.jit, static_argnames=("n_blocks", "block", "panel_pad"))
def scatter_pack_device_delta8(
    first, d8, exceptions, count, n_blocks: int, block: int, panel_pad: int,
):
    """``scatter_pack_device`` over u8-delta keys with an escape channel.

    Decode: 0 entries substitute the next exception (running cumsum of
    the escape mask indexes the exception array), position 0 is forced
    to delta 0, then one cumsum rebuilds the keys; tail positions mask
    to ascending out-of-range sentinels.  Bit-exact with the raw path;
    ~1 byte per posting crosses the link."""
    total = n_blocks * block * panel_pad
    di = d8.astype(jnp.int32)
    is_esc = di == 0
    eidx = jnp.cumsum(is_esc.astype(jnp.int32)) - 1
    sub = exceptions[jnp.clip(eidx, 0, exceptions.shape[0] - 1)]
    d = jnp.where(is_esc, sub, di)
    iota = jnp.arange(d.shape[0], dtype=jnp.int32)
    d = jnp.where(iota == 0, 0, d)
    k = jnp.int32(first) + jnp.cumsum(d)
    k = jnp.where(iota < count, k, jnp.int32(total) + (iota - count))
    return scatter_pack_device.__wrapped__(k, n_blocks, block, panel_pad)


@functools.partial(jax.jit, static_argnames=("n_blocks", "block", "panel_pad"))
def scatter_pack_device_delta(
    first, deltas, count, n_blocks: int, block: int, panel_pad: int,
):
    """``scatter_pack_device`` over delta-compressed keys.

    Decodes ``first + cumsum(int16 deltas)`` on device (one cumsum),
    masks positions >= count to ascending out-of-range sentinels (keeps
    the scatter's sorted/unique hints valid, pad drops via mode='drop'),
    and reuses the scatter+byte-pack body.  Bit-exact with the raw-key
    path; 2 bytes per posting cross the link instead of 4."""
    total = n_blocks * block * panel_pad
    k = jnp.int32(first) + jnp.cumsum(deltas.astype(jnp.int32))
    iota = jnp.arange(k.shape[0], dtype=jnp.int32)
    k = jnp.where(iota < count, k, jnp.int32(total) + (iota - count))
    return scatter_pack_device.__wrapped__(k, n_blocks, block, panel_pad)


@functools.partial(jax.jit, static_argnames=("n_blocks", "block", "panel_pad"))
def scatter_pack_device(keys, n_blocks: int, block: int, panel_pad: int):
    """Build packed bitmask blocks ON DEVICE from sorted posting keys.

    ``keys`` i32[M]: ``seg * panel_pad + member`` per posting, strictly
    increasing (segments positionally ordered, members ascending within a
    segment — both plan invariants), padded to a bucket length with
    ascending out-of-range values so the scatter's ``unique_indices`` /
    ``indices_are_sorted`` hints stay valid and the pad drops out via
    ``mode='drop'``.

    Returns u8[n_blocks, block, panel_pad/8].  Output matches
    ``pack_bitmask_blocks`` bit-for-bit (MSB-first, np.packbits order).

    This is the H2D-thrifty alternative to host packing for the streamed
    engine: 4 bytes per posting cross the link instead of panel_pad/8
    bytes per color, a win whenever the selected segments are sparse
    (mean members-per-segment < panel_pad/32).  The bit-level scatter has
    unique sorted indices (no read-modify-write), then a dense elementwise
    reduction packs 8 presence bits into each byte.
    """
    total = n_blocks * block * panel_pad
    flat = (
        jnp.zeros(total, jnp.int8)
        .at[keys]
        .set(1, mode="drop", unique_indices=True, indices_are_sorted=True)
    )
    a = flat.reshape(n_blocks, block, panel_pad)
    # byte-pack via 8 strided slices of the minor dimension
    packed = jnp.zeros((n_blocks, block, panel_pad // 8), jnp.int32)
    for j in range(8):
        packed = packed + (a[..., j::8].astype(jnp.int32) << (7 - j))
    return packed.astype(jnp.uint8)


def unpack_bits_to_int8(bits: jnp.ndarray) -> jnp.ndarray:
    """u8[..., n8] -> i8[..., n8*8] 0/1 (MSB-first, matching np.packbits)."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    expanded = (bits[..., None] >> shifts) & jnp.uint8(1)
    return expanded.reshape(*bits.shape[:-1], bits.shape[-1] * 8).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("block", "n_pad", "n_limbs"))
def cooccurrence_bitmask_blocks(
    bits, w_limbs, block: int, n_pad: int, n_limbs: int
):
    """bits u8[NB, block, n_pad/8], w_limbs i8[NB, block, n_limbs]
    -> i32[n_limbs, n_pad, n_pad] per-limb Gram accumulators."""

    def body(acc, xs):
        b, wl = xs
        a = unpack_bits_to_int8(b)  # [block, n_pad] i8

        def limb(l, acc):
            wa = a * wl[:, l][:, None]
            s = jax.lax.dot_general(
                wa,
                a,
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            return acc.at[l].add(s)

        return jax.lax.fori_loop(0, n_limbs, limb, acc), None

    acc0 = jnp.zeros((n_limbs, n_pad, n_pad), dtype=jnp.int32)
    acc, _ = jax.lax.scan(body, acc0, (bits, w_limbs))
    return acc


def shared_kmer_matrix_bitmask(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    block: int = 1024,
    drop_singletons: bool = True,
) -> np.ndarray:
    """Exact shared-k-mer matrix via the bitmask layout (int64, NxN)."""
    from kspider_tpu.ops import pairwise as pw

    offsets = np.asarray(offsets, dtype=np.int64)
    members = np.asarray(members, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.int64)
    degrees = np.diff(offsets)
    if drop_singletons:
        keep = np.flatnonzero(degrees >= 2)
    else:
        keep = np.arange(len(degrees))
    if len(keep) == 0 or n == 0:
        return np.zeros((n, n), dtype=np.int64)

    kept_deg = degrees[keep]
    new_offsets = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(kept_deg, out=new_offsets[1:])
    gather = np.repeat(offsets[keep], kept_deg) + (
        np.arange(int(kept_deg.sum())) - np.repeat(new_offsets[:-1], kept_deg)
    )
    new_members = members[gather]
    new_weights = weights[keep]

    n_pad = max(128, _cdiv(n, 128) * 128)
    w_limbs = pw.weight_limbs(new_weights)
    n_limbs = w_limbs.shape[1]
    num_colors = len(new_weights)

    total = np.zeros((n_pad, n_pad), dtype=np.int64)
    super_size = pw._MAX_COLORS_PER_CALL - (pw._MAX_COLORS_PER_CALL % block)
    for start in range(0, num_colors, super_size):
        stop = min(start + super_size, num_colors)
        sl_off = new_offsets[start : stop + 1] - new_offsets[start]
        sl_mem = new_members[new_offsets[start] : new_offsets[stop]]
        bits = pack_bitmask_blocks(sl_off, sl_mem, n, block)
        nb = bits.shape[0]
        wl = np.zeros((nb * block, n_limbs), dtype=np.int8)
        wl[: stop - start] = w_limbs[start:stop]
        wl = wl.reshape(nb, block, n_limbs)
        acc = np.asarray(
            cooccurrence_bitmask_blocks(bits, wl, block, n_pad, n_limbs)
        ).astype(np.int64)
        scale = 1
        for l in range(n_limbs):
            total += acc[l] * scale
            scale *= 128
    s = total[:n, :n]
    np.fill_diagonal(s, 0)
    return s

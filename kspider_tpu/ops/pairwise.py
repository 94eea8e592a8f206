"""Pairwise shared-k-mer co-occurrence as an exact integer Gram matrix.

The reference's hot loop (/root/reference/src/pairwise.cpp:199-237)
enumerates, for every color c, all C(|sources(c)|, 2) sample pairs and adds
``colorsCount[c]`` to a mutex-guarded hash map — quadratic scalar work with
heavy contention.

Formulation: the shared-k-mer matrix is the weighted Gram matrix

    S = A^T · diag(w) · A          (S[i,j] = sum_c w_c A[c,i] A[c,j])

where ``A`` is the (colors x samples) 0/1 membership matrix and ``w_c`` the
number of k-mers with color c.  We compute it exactly in integer arithmetic
as blocked int8 matmuls with int32 accumulation: weights are decomposed
into base-128 limbs so every scaled entry fits in int8, and limb partial
sums are recombined in int64 on the host.

Exactness argument: each limb matmul accumulates at most 127 * C_block per
output element in int32; the scan accumulator adds at most 127 * C_total,
so C_total < 2**31 / 127 colors per call is exact — callers split larger
inputs into super-blocks (see ``shared_kmer_matrix``).

Every engine is plain XLA; :func:`choose_engine` is the one place that
decides which of them ``engine="auto"`` runs.
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# int32 accumulator safety bound: 127 * MAX_COLORS_PER_CALL < 2**31
_MAX_COLORS_PER_CALL = (2**31 - 1) // 127

# beyond this sample count the full NxN host matrix (int64) would exceed
# ~2GB and the panel-streamed engine takes over automatically
AUTO_TILED_THRESHOLD = 16384

#: backends the engines are built and checked for
BACKENDS = ("cpu", "gpu")


def choose_engine(backend: str, n_devices: int, n: int,
                  dense_only: bool = False) -> str:
    """The ``engine="auto"`` rule: (backend, local devices, N) -> engine.

    - ``"tiled"``: N above :data:`AUTO_TILED_THRESHOLD` (the NxN host
      matrix would not fit), unless the caller needs the dense matrix
      (``dense_only``);
    - ``"sharded"``: color blocks split over more than one local device,
      partial Gram matrices merged with one psum;
    - ``"bitmask"``: one device.

    The backend never changes the engine: every engine is plain XLA and
    compiles for each backend in :data:`BACKENDS`.  Any other backend is
    refused rather than run on code nobody checked there.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"no pairwise engine is checked on backend {backend!r}; "
            f"expected one of {BACKENDS}"
        )
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    if not dense_only and n > AUTO_TILED_THRESHOLD:
        return "tiled"
    return "sharded" if n_devices > 1 else "bitmask"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def weight_limbs(weights: np.ndarray) -> np.ndarray:
    """Decompose int64 weights into base-128 int8 limbs, shape (C, L)."""
    w = np.asarray(weights, dtype=np.int64)
    if w.size == 0:
        return np.zeros((0, 1), dtype=np.int8)
    max_w = int(w.max(initial=0))
    n_limbs = 1
    while max_w >= 128**n_limbs:
        n_limbs += 1
    limbs = np.empty((len(w), n_limbs), dtype=np.int8)
    rem = w.copy()
    for l in range(n_limbs):
        limbs[:, l] = (rem % 128).astype(np.int8)
        rem //= 128
    return limbs


@functools.partial(jax.jit, static_argnames=("block", "n_pad", "n_limbs"))
def _cooccurrence_blocks(rows, cols, w_limbs, block: int, n_pad: int, n_limbs: int):
    """See module docstring.  Shapes:

    rows    i32[NB, P]    in [0, block] (block == padding sentinel)
    cols    i32[NB, P]    in [0, n_pad)
    w_limbs i8[NB, block, n_limbs]

    Returns i32[n_limbs, n_pad, n_pad].
    """

    def body(acc, xs):
        r, c, wl = xs
        # Build the dense 0/1 membership block via scatter; row `block`
        # absorbs padding postings and is sliced off.
        a = jnp.zeros((block + 1, n_pad), dtype=jnp.int8)
        a = a.at[r, c].set(1, mode="drop")
        a = a[:block]

        def limb(l, acc):
            wa = a * wl[:, l][:, None]  # i8, values in [0, 127]
            s = jax.lax.dot_general(
                wa,
                a,
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            return acc.at[l].add(s)

        acc = jax.lax.fori_loop(0, n_limbs, limb, acc)
        return acc, None

    acc0 = jnp.zeros((n_limbs, n_pad, n_pad), dtype=jnp.int32)
    acc, _ = jax.lax.scan(body, acc0, (rows, cols, w_limbs))
    return acc


def _pack_blocks(
    offsets: np.ndarray,
    members: np.ndarray,
    w_limbs: np.ndarray,
    block: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack CSR colors into fixed-shape per-block posting arrays."""
    num_colors = len(offsets) - 1
    num_blocks = max(1, _cdiv(num_colors, block))
    degrees = np.diff(offsets)
    color_idx = np.repeat(np.arange(num_colors, dtype=np.int64), degrees)
    block_of_posting = color_idx // block
    row_of_posting = (color_idx % block).astype(np.int32)

    per_block = np.bincount(block_of_posting, minlength=num_blocks)
    p_max = int(per_block.max(initial=1))
    # position of each posting within its block
    block_starts = np.zeros(num_blocks + 1, dtype=np.int64)
    np.cumsum(per_block, out=block_starts[1:])
    pos_in_block = np.arange(len(members)) - block_starts[block_of_posting]

    rows = np.full((num_blocks, p_max), block, dtype=np.int32)  # sentinel
    cols = np.zeros((num_blocks, p_max), dtype=np.int32)
    rows[block_of_posting, pos_in_block] = row_of_posting
    cols[block_of_posting, pos_in_block] = members

    n_limbs = w_limbs.shape[1]
    wl = np.zeros((num_blocks * block, n_limbs), dtype=np.int8)
    wl[:num_colors] = w_limbs
    wl = wl.reshape(num_blocks, block, n_limbs)
    return rows, cols, wl


def shared_kmer_matrix(
    offsets: np.ndarray,
    members: np.ndarray,
    weights: np.ndarray,
    n: int,
    block: int = 512,
    drop_singletons: bool = True,
    engine: str = "auto",
) -> np.ndarray:
    """Exact shared-k-mer matrix S (int64, NxN, symmetric, zero diagonal).

    Input is the color-class CSR from :class:`~kspider_tpu.core.index.ColorIndex`:
    ``members[offsets[c]:offsets[c+1]]`` lists the 0-based sample ids of
    color ``c`` and ``weights[c]`` its k-mer count.

    ``engine``: "auto" (:func:`choose_engine`) | "bitmask" (packed-bit
    layout, one device) | "sharded" (color blocks data-parallel over the
    local devices, psum merge) | "scatter" (postings scatter + matmul;
    kept for comparison).
    """
    if engine == "auto":
        engine = choose_engine(
            jax.default_backend(), len(jax.local_devices()), n,
            dense_only=True,
        )
    if engine == "sharded":
        from kspider_tpu.parallel.sharded_pairwise import shared_kmer_matrix_sharded

        return shared_kmer_matrix_sharded(
            offsets, members, weights, n, block=max(block, 1024)
        )
    if engine == "bitmask":
        from kspider_tpu.ops.bitmask import shared_kmer_matrix_bitmask

        return shared_kmer_matrix_bitmask(
            offsets, members, weights, n,
            block=max(block, 1024), drop_singletons=drop_singletons,
        )
    if engine != "scatter":
        raise ValueError(f"unknown engine {engine!r}")
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

    # compact the kept colors into a fresh CSR
    kept_deg = degrees[keep]
    new_offsets = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(kept_deg, out=new_offsets[1:])
    gather = np.repeat(offsets[keep], kept_deg) + (
        np.arange(int(kept_deg.sum())) - np.repeat(new_offsets[:-1], kept_deg)
    )
    new_members = members[gather]
    new_weights = weights[keep]

    n_pad = max(128, _round_up(n, 128))
    w_limbs = weight_limbs(new_weights)
    n_limbs = w_limbs.shape[1]

    total = np.zeros((n_pad, n_pad), dtype=np.int64)
    num_colors = len(new_weights)
    # super-blocks keep the int32 accumulators exact
    super_size = _MAX_COLORS_PER_CALL - (_MAX_COLORS_PER_CALL % block)
    for start in range(0, num_colors, super_size):
        stop = min(start + super_size, num_colors)
        sl_off = new_offsets[start : stop + 1] - new_offsets[start]
        sl_mem = new_members[new_offsets[start] : new_offsets[stop]]
        rows, cols, wl = _pack_blocks(sl_off, sl_mem, w_limbs[start:stop], block)
        acc = np.asarray(
            _cooccurrence_blocks(rows, cols, wl, block, n_pad, n_limbs)
        ).astype(np.int64)
        scale = 1
        for l in range(n_limbs):
            total += acc[l] * scale
            scale *= 128
    s = total[:n, :n]
    np.fill_diagonal(s, 0)
    return s


def shared_kmer_matrix_numpy(
    offsets: np.ndarray, members: np.ndarray, weights: np.ndarray, n: int
) -> np.ndarray:
    """Pure-numpy reference implementation (exact, for tests/fallback)."""
    s = np.zeros((n, n), dtype=np.int64)
    offsets = np.asarray(offsets)
    for c in range(len(offsets) - 1):
        ms = members[offsets[c] : offsets[c + 1]]
        if len(ms) < 2:
            continue
        w = int(weights[c])
        s[np.ix_(ms, ms)] += w
    np.fill_diagonal(s, 0)
    return s

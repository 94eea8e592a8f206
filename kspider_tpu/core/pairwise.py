"""Pairwise containment matrix: orchestration + reference-exact TSV output.

Mirrors the output contract of ``kSpider::pairwise``
(/root/reference/src/pairwise.cpp:123-276):

- ``{p}_kSpider_seqToKmersNo.tsv``: header ``ID\tseq\tkmers`` then one row
  per ingested group: running 1-based counter, groupID, k-mer count.
- ``{p}_kSpider_pairwise.tsv``: header then one row per unordered pair with
  shared k-mers > 0: groupID_1 < groupID_2, shared count, and
  min/avg/max containment computed in float32 exactly as the C++ does
  (``cont_1_in_2 = (float)shared / kmers(source_2)``) and printed with
  C++ default ostream formatting (6 significant digits).

Row order note: the reference emits rows in hash-map iteration order
(non-deterministic); we emit sorted by (source_1, source_2).  All known
consumers (cluster, export, test/validate.py) key rows by the id pair.
"""

from typing import Optional

import numpy as np

from kspider_tpu.core.index import ColorIndex
from kspider_tpu.ops import pairwise as pairwise_ops


def format_float_cpp(x: float) -> str:
    """Format like C++ ``operator<<(ostream&, float)``: %g, 6 sig digits."""
    return f"{float(x):.6g}"


def compute_shared_matrix(
    index: ColorIndex,
    use_device: bool = True,
    block: int = 512,
    engine: str = "auto",
) -> np.ndarray:
    """S[i, j] = number of k-mer hashes shared by groups i and j (int64).

    ``use_device=False`` runs the numpy reference on the host instead."""
    if use_device:
        return pairwise_ops.shared_kmer_matrix(
            index.color_offsets,
            index.color_members,
            index.color_counts,
            index.num_groups,
            block=block,
            engine=engine,
        )
    return pairwise_ops.shared_kmer_matrix_numpy(
        index.color_offsets,
        index.color_members,
        index.color_counts,
        index.num_groups,
    )


def containment_columns(shared, k1, k2):
    """float32 containment columns for pair arrays (reference math,
    /root/reference/src/pairwise.cpp:260-264)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        c12 = np.float32(1.0) * shared.astype(np.float32) / k2.astype(np.float32)
        c21 = shared.astype(np.float32) / k1.astype(np.float32)
    cmin = np.minimum(c12, c21)
    cavg = ((c12 + c21) / np.float32(2.0)).astype(np.float32)
    cmax = np.maximum(c12, c21)
    return cmin, cavg, cmax


def write_seq_to_kmers_tsv(prefix: str, index: ColorIndex) -> None:
    ingested = np.flatnonzero(index.group_kmer_count >= 0)
    with open(prefix + "_kSpider_seqToKmersNo.tsv", "w") as f:
        f.write("ID\tseq\tkmers\n")
        for counter, g in enumerate(ingested, start=1):
            f.write(f"{counter}\t{g + 1}\t{index.group_kmer_count[g]}\n")


def write_pairwise_tsv(
    prefix: str, index: ColorIndex, shared: np.ndarray, min_shared: int = 1
) -> int:
    """Emit ``{p}_kSpider_pairwise.tsv``; returns the number of pair rows.

    ``min_shared`` filters rows below the shared-k-mer floor — the same
    semantics the panel-streamed engine applies on device, so the flag
    behaves identically on every engine."""
    n = index.num_groups
    min_shared = max(1, int(min_shared))
    counts64 = np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)
    from kspider_tpu.io import native

    if native.enabled():
        try:
            if not native.available():
                raise RuntimeError(
                    f"native library failed to load: {native.load_error()!r}"
                )
            native.write_pairwise_tsv(
                prefix + "_kSpider_pairwise.tsv", shared, counts64,
                min_shared=min_shared,
            )
            return int((shared >= min_shared).sum()) // 2
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("write_pairwise_tsv", exc)
    iu, ju = np.triu_indices(n, k=1)
    s = shared[iu, ju]
    nz = s >= min_shared
    iu, ju, s = iu[nz], ju[nz], s[nz]

    # kmer counts; missing (never-ingested) groups behave like phmap
    # operator[] default-insert: count 0 -> containment inf
    counts = np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)
    k1 = counts[iu]
    k2 = counts[ju]
    cmin, cavg, cmax = containment_columns(s, k1, k2)

    lines = ["source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\tmax_containment"]
    for a, b, sh, c1, c2, c3 in zip(
        (iu + 1).tolist(),
        (ju + 1).tolist(),
        s.tolist(),
        cmin.tolist(),
        cavg.tolist(),
        cmax.tolist(),
    ):
        lines.append(
            f"{a}\t{b}\t{sh}\t{format_float_cpp(c1)}\t{format_float_cpp(c2)}\t{format_float_cpp(c3)}"
        )
    with open(prefix + "_kSpider_pairwise.tsv", "w") as f:
        f.write("\n".join(lines))
        f.write("\n")
    return int(nz.sum())


def write_pairwise_rows_coo(
    path: str,
    gi: np.ndarray,
    gj: np.ndarray,
    shared: np.ndarray,
    kmer_counts: np.ndarray,
    header: bool,
) -> None:
    """Append pre-sorted COO pair rows (0-based ids) to the pairwise TSV.

    Used by the panel-streamed engine (ops/tiled_pairwise.py); emits the
    exact row format of ``write_pairwise_tsv``."""
    from kspider_tpu.io import native

    if native.enabled():
        try:
            if not native.available():
                raise RuntimeError(
                    f"native library failed to load: {native.load_error()!r}"
                )
            native.write_pairwise_coo(
                path, gi, gj, shared, kmer_counts, header
            )
            return
        except native.NativeRequiredError:
            raise
        except Exception as exc:
            native.report_fallback("write_pairwise_coo", exc)
    counts = np.asarray(kmer_counts, dtype=np.int64)
    cmin, cavg, cmax = containment_columns(
        np.asarray(shared, dtype=np.int64), counts[gi], counts[gj]
    )
    lines = []
    if header:
        lines.append(
            "source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\tmax_containment"
        )
    for a, b, sh, c1, c2, c3 in zip(
        (np.asarray(gi) + 1).tolist(),
        (np.asarray(gj) + 1).tolist(),
        np.asarray(shared).tolist(),
        cmin.tolist(),
        cavg.tolist(),
        cmax.tolist(),
    ):
        lines.append(
            f"{a}\t{b}\t{sh}\t{format_float_cpp(c1)}\t{format_float_cpp(c2)}\t{format_float_cpp(c3)}"
        )
    with open(path, "w" if header else "a") as f:
        if lines:
            f.write("\n".join(lines))
            f.write("\n")


AUTO_TILED_THRESHOLD = pairwise_ops.AUTO_TILED_THRESHOLD


def resolve_engine(engine: str, use_device: bool, n: int) -> str:
    """The engine the pairwise stage runs for N samples: ``auto`` on the
    device becomes :func:`~kspider_tpu.ops.pairwise.choose_engine`'s
    pick over this process's devices; anything else is kept."""
    if engine != "auto" or not use_device:
        return engine
    import jax

    return pairwise_ops.choose_engine(
        jax.default_backend(), len(jax.local_devices()), n
    )


def run_pairwise(
    prefix: str,
    index: Optional[ColorIndex] = None,
    use_device: bool = True,
    echo_timers: bool = True,
    engine: str = "auto",
    panel: int = 4096,
    min_shared: int = 1,
) -> Optional[np.ndarray]:
    """Full pairwise stage: load artifacts if needed, compute, emit TSVs.

    Returns the dense shared matrix, or None when the panel-streamed
    engine was used (``engine="tiled"`` or N > AUTO_TILED_THRESHOLD) —
    results then live only in the pairwise TSV."""
    import time

    from kspider_tpu.io import artifacts

    t0 = time.perf_counter()
    if index is None:
        from kspider_tpu.io import npz_index

        index = npz_index.load(prefix)
        if index is None:
            index = artifacts.load_index_artifacts(prefix)
    if echo_timers:
        print(f"mapping colors to groups: {time.perf_counter() - t0:.6g} secs")

    t0 = time.perf_counter()
    write_seq_to_kmers_tsv(prefix, index)
    if echo_timers:
        print(f"kmer counting: {time.perf_counter() - t0:.6g} secs")

    t0 = time.perf_counter()
    import contextlib
    import os as _os

    profile_dir = _os.environ.get("KSPIDER_PROFILE")
    if profile_dir:
        import jax

        profile_cm = jax.profiler.trace(profile_dir)
    else:
        profile_cm = contextlib.nullcontext()
    engine = resolve_engine(engine, use_device, index.num_groups)
    if echo_timers and use_device:
        import jax

        print(f"pairwise engine: {engine} over "
              f"{len(jax.local_devices())} device(s)")
    with profile_cm:
        if engine == "tiled":
            from kspider_tpu.ops import tiled_pairwise

            n_rows = tiled_pairwise.stream_pairwise_tsv(
                index, prefix, panel=panel, min_shared=min_shared,
                engine="auto" if use_device else "xla",
                echo_progress=echo_timers,
            )
            if echo_timers:
                print(
                    f"pairwise matrix construction: {time.perf_counter() - t0:.6g} secs"
                )
                print(
                    f"streamed {n_rows} pair rows to {prefix}_kSpider_pairwise.tsv"
                )
            return None
        shared = compute_shared_matrix(
            index, use_device=use_device, engine=engine
        )
    if echo_timers:
        print(
            f"pairwise matrix construction: {time.perf_counter() - t0:.6g} secs"
        )
        print(f"writing pairwise matrix to {prefix}_kSpider_pairwise.tsv")
    write_pairwise_tsv(prefix, index, shared, min_shared=min_shared)
    return shared

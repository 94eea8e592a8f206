"""Chunked, vectorized reader for the ``_kSpider_pairwise.tsv`` artifact.

Single source of truth for how the cluster and export stages stream the
pairwise TSV (and the row-aligned ``..ani_col.tsv`` column file) back in:
both stages in the reference re-parse the file with per-line ``float()``
(/root/reference/pykSpider/kSpider2/ks_clustering.py:63-117,
/root/reference/pykSpider/kSpider2/ks_export.py:44-60); here the parse is
``np.loadtxt`` over blocks of lines, whose float conversion is
``PyOS_string_to_double`` — bit-equal to ``float()``/strtod on every value
(a fast approximate parser differs by 1 ulp on many 17-significant-digit
reprs — enough to flip a threshold comparison sitting on the cutoff).

The pairwise/ani files are required to be row-aligned; a length mismatch
(stale or truncated ani file) raises instead of silently zip-truncating.
"""

import contextlib
import itertools
from typing import Iterator, List, Optional, Tuple

import numpy as np

#: rows parsed per chunk; the reference batches graph edges 10M at a time
#: (/root/reference/pykSpider/kSpider2/ks_clustering.py:26) — we bound the
#: *parse* at the same scale so a low --min-shared 100K-sample run
#: (10^8-10^9 TSV rows) streams in constant memory.
PAIRWISE_CHUNK_ROWS = 10_000_000

def _read_block(f, n: int) -> List[str]:
    return list(itertools.islice(f, n))


def _parse(lines: List[str], cols) -> np.ndarray:
    """Tab-separated lines -> float64 [rows, len(cols)] (ids < 2**53 stay
    exact)."""
    return np.loadtxt(lines, delimiter="\t", usecols=cols,
                      dtype=np.float64, ndmin=2)


def iter_pairwise_chunks(
    pairwise_tsv: str,
    dist_col: int,
    ani_file: Optional[str] = None,
    chunk_rows: int = PAIRWISE_CHUNK_ROWS,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(ids1 i64, ids2 i64, dist f64)`` chunks of at most
    ``chunk_rows`` rows.

    ``dist_col`` selects the distance column of the pairwise TSV
    (3=min_cont, 4=avg_cont, 5=max_cont); when ``ani_file`` is given the
    distance instead comes from the row-aligned single-column ani file
    and ``dist_col`` is ignored.
    """
    with contextlib.ExitStack() as stack:
        pw = stack.enter_context(open(pairwise_tsv))
        next(pw, None)  # header
        ani = None
        if ani_file is not None:
            ani = stack.enter_context(open(ani_file))
            next(ani, None)
        rows_pw = rows_ani = 0
        while True:
            pw_lines = _read_block(pw, chunk_rows)
            if ani is None:
                if not pw_lines:
                    return
                a = _parse(pw_lines, (0, 1, dist_col))
                yield a[:, 0].astype(np.int64), a[:, 1].astype(np.int64), a[:, 2]
                continue
            ani_lines = _read_block(ani, chunk_rows)
            if not pw_lines and not ani_lines:
                return
            rows_pw += len(pw_lines)
            rows_ani += len(ani_lines)
            if len(pw_lines) != len(ani_lines):
                raise ValueError(
                    f"row-aligned files disagree: {pairwise_tsv} has "
                    f">= {rows_pw} rows but {ani_file} has >= {rows_ani} "
                    f"(stale or truncated --estimate-ani output? re-run "
                    f"kspider pairwise --estimate-ani)"
                )
            a = _parse(pw_lines, (0, 1))
            yield (
                a[:, 0].astype(np.int64),
                a[:, 1].astype(np.int64),
                _parse(ani_lines, (0,))[:, 0],
            )

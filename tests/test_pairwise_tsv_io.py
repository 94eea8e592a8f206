"""Chunked pairwise-TSV reader: float() bit-parity and row alignment."""

import numpy as np
import pytest

from kspider_tpu.io import pairwise_tsv as pw_tsv


def _write_pairwise(path, rows):
    with open(path, "w") as f:
        f.write(
            "source_1\tsource_2\tshared_kmers\tmin_containment\t"
            "avg_containment\tmax_containment\n"
        )
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n")


def test_float_parse_bit_equal_to_strtod(rng, tmp_path):
    # the reference re-parses its own TSV with per-line float(); pandas'
    # default fast parser differs by 1 ulp on ~36% of 17-significant-digit
    # reprs, which can flip a threshold comparison — the reader must use
    # round_trip parsing.  repr(random()) exercises exactly those values.
    vals = rng.random(5000)
    strs = [repr(float(v)) for v in vals]
    pw = tmp_path / "x_kSpider_pairwise.tsv"
    _write_pairwise(
        pw, [(i + 1, i + 2, 10, s, s, s) for i, s in enumerate(strs)]
    )
    for col in (3, 4, 5):
        chunks = list(pw_tsv.iter_pairwise_chunks(str(pw), col))
        got = np.concatenate([c[2] for c in chunks])
        expect = np.array([float(s) for s in strs])
        assert got.tobytes() == expect.tobytes()


def test_ani_column_bit_equal_and_aligned(rng, tmp_path):
    vals = rng.random(1000)
    strs = [repr(float(v)) for v in vals]
    pw = tmp_path / "x_kSpider_pairwise.tsv"
    ani = tmp_path / "x_kSpider_pairwise.ani_col.tsv"
    _write_pairwise(
        pw, [(i + 1, i + 2, 10, 0.5, 0.5, 0.5) for i in range(len(strs))]
    )
    ani.write_text("avg_ani\n" + "\n".join(strs) + "\n")
    chunks = list(
        pw_tsv.iter_pairwise_chunks(str(pw), 99, str(ani), chunk_rows=256)
    )
    got = np.concatenate([c[2] for c in chunks])
    expect = np.array([float(s) for s in strs])
    assert got.tobytes() == expect.tobytes()
    ids1 = np.concatenate([c[0] for c in chunks])
    assert np.array_equal(ids1, np.arange(1, len(strs) + 1))


@pytest.mark.parametrize("ani_rows", [0, 5, 512, 999])
def test_ani_row_mismatch_raises(rng, tmp_path, ani_rows):
    # a stale/truncated --estimate-ani output (header-only, or any row
    # count short of the pairwise TSV — including an exact chunk
    # multiple) must raise, not silently zip-truncate the edge stream
    n = 1000
    pw = tmp_path / "x_kSpider_pairwise.tsv"
    ani = tmp_path / "x_kSpider_pairwise.ani_col.tsv"
    _write_pairwise(pw, [(i + 1, i + 2, 10, 0.5, 0.5, 0.5) for i in range(n)])
    ani.write_text(
        "avg_ani\n" + "".join(f"{0.5}\n" for _ in range(ani_rows))
    )
    with pytest.raises(ValueError, match="row-aligned"):
        list(
            pw_tsv.iter_pairwise_chunks(str(pw), 99, str(ani), chunk_rows=256)
        )


def test_ani_longer_than_pairwise_raises(rng, tmp_path):
    pw = tmp_path / "x_kSpider_pairwise.tsv"
    ani = tmp_path / "x_kSpider_pairwise.ani_col.tsv"
    _write_pairwise(pw, [(1, 2, 10, 0.5, 0.5, 0.5)])
    ani.write_text("avg_ani\n0.5\n0.5\n0.5\n")
    with pytest.raises(ValueError, match="row-aligned"):
        list(pw_tsv.iter_pairwise_chunks(str(pw), 99, str(ani)))


def test_cluster_uses_round_trip_parse(rng, tmp_path, monkeypatch):
    # end-to-end: an ani value 1 ulp below the cutoff under float() must
    # NOT cluster, even though pandas' fast parser would round it up
    from kspider_tpu.core import cluster as core_cluster

    monkeypatch.chdir(tmp_path)
    # 0.8999999999999999 < 0.9 under strtod; the fast parser misparses
    # some such boundary reprs upward.  Build one that actually differs:
    s_lo = float(np.nextafter(0.9, 0.0))
    prefix = str(tmp_path / "x")
    _write_pairwise(
        tmp_path / "x_kSpider_pairwise.tsv",
        [(1, 2, 10, repr(s_lo), repr(s_lo), repr(s_lo))],
    )
    with open(prefix + ".namesMap", "w") as f:
        f.write("2\n1 a\n2 b\n")
    out = core_cluster.cluster_index(
        prefix, cutoff=0.9, dist_type="max_cont", use_device=False
    )
    lines = open(out).read().splitlines()
    assert sorted(lines) == ["a", "b"]  # two singletons, not one cluster

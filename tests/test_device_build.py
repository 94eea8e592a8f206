"""Device-accelerated ingestion vs the host build."""

import numpy as np

from kspider_tpu.core.index import (
    build_index_device,
    build_index_from_hash_sets,
)
from kspider_tpu.ops.device_build import compact_multi_postings


def test_compact_matches_bruteforce(rng):
    from collections import defaultdict

    hashes = rng.integers(0, 400, size=3000, dtype=np.uint64) << np.uint64(30)
    hashes |= rng.integers(0, 3, size=3000, dtype=np.uint64)
    gids = rng.integers(0, 20, size=3000).astype(np.int32)
    h_out, g_out = compact_multi_postings(hashes, gids)
    d = defaultdict(set)
    for h, g in zip(hashes.tolist(), gids.tolist()):
        d[h].add(g)
    expect = sorted(
        (h, g) for h, gs in d.items() if len(gs) >= 2 for g in gs
    )
    assert sorted(zip(h_out.tolist(), g_out.tolist())) == expect


def test_device_build_equals_host_build(rng):
    n = 16
    universe = np.unique(rng.integers(0, 2**50, size=4000, dtype=np.uint64))
    arrays = []
    for _ in range(n):
        take = rng.random(len(universe)) < 0.25
        arrays.append(universe[take])
    names = [f"s{i}" for i in range(n)]
    host = build_index_from_hash_sets(names, arrays, ksize=21)
    dev = build_index_device(names, arrays, ksize=21)
    assert np.array_equal(host.color_offsets, dev.color_offsets)
    assert np.array_equal(host.color_members, dev.color_members)
    assert np.array_equal(host.color_counts, dev.color_counts)
    assert np.array_equal(host.color_ids, dev.color_ids)
    assert np.array_equal(host.group_kmer_count, dev.group_kmer_count)


def test_device_build_with_ghost_group(rng):
    a = np.array([1, 2, 3], dtype=np.uint64)
    b = np.array([3, 4], dtype=np.uint64)
    host = build_index_from_hash_sets(["a", "b", "ghost"], [a, b, None])
    dev = build_index_device(["a", "b", "ghost"], [a, b, None])
    assert np.array_equal(host.color_counts, dev.color_counts)
    assert np.array_equal(host.group_kmer_count, dev.group_kmer_count)


def test_index_cli_device_build_flag(tmp_path, rng, monkeypatch):
    # `kspider index --device-build` routes through build_index_device and
    # yields artifacts identical to the host build
    from tests.cli_runner import CliRunner

    from kspider_tpu.cli.main import cli
    from kspider_tpu.io import sigs as sigs_io

    sigs = tmp_path / "sigs"
    sigs.mkdir()
    universe = np.unique(rng.integers(0, 2**50, size=2000, dtype=np.uint64))
    for g in range(4):
        h = np.sort(rng.choice(universe, size=300, replace=False))
        sigs_io.write_sig(str(sigs / f"g{g}.sig"), f"g{g}", h.tolist(), 21)

    runner = CliRunner()
    outs = {}
    for flag, prefix in ((), "host"), (("--device-build",), "dev"):
        monkeypatch.chdir(tmp_path)
        res = runner.invoke(
            cli,
            ["index", "--sourmash", "--dir", str(sigs), "-k", "21",
             "-o", prefix, *flag],
        )
        assert res.exit_code == 0, res.output
        outs[prefix] = (tmp_path / f"{prefix}_color_to_sources.bin").read_bytes()
    assert outs["host"] == outs["dev"]

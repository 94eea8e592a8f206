"""Device-side bitmask packing (ops/bitmask.scatter_pack_device).

The streamed engine can ship sorted posting keys (4 bytes per posting)
instead of host-packed bitmask blocks (panel_pad/8 bytes per color) and
rebuild the packed masks on device — the H2D-thrifty path for sparse
panel sides.  These tests pin the scatter-built masks bit-for-bit
against the host packer and the streamed output byte-for-byte against
the host-pack policy, under every KSPIDER_DEVICE_PACK setting.
"""

import numpy as np
import pytest

from kspider_tpu.ops import bitmask as bm
from kspider_tpu.ops import pairwise as pw
from kspider_tpu.ops import tiled_pairwise as tp
from tests.test_pairwise_ops import random_csr
from tests.test_tiled_pairwise import assemble


def keys_from_csr(offsets, members, panel_pad, n_blocks, block):
    """Build scatter keys the way the plan does: segment-position-major,
    member-ascending, bucket-padded with ascending out-of-range values."""
    cnt = np.diff(offsets)
    seg = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
    keys = seg * panel_pad + np.asarray(members, dtype=np.int64)
    m = len(keys)
    bucket = max(512, 1 << (max(m, 1) - 1).bit_length())
    out = np.empty(bucket, dtype=np.int32)
    out[:m] = keys
    out[m:] = n_blocks * block * panel_pad + np.arange(
        bucket - m, dtype=np.int32
    )
    return out


@pytest.mark.parametrize("n,block,n_colors,panel_pad", [
    (700, 128, 500, 768),
    (1000, 256, 700, 1024),
])
def test_scatter_pack_matches_host_packer(rng, n, block, n_colors, panel_pad):
    o, m, _ = random_csr(rng, n_colors, n, max_degree=60, max_weight=10)
    # members ascending within each color (plan invariant)
    for c in range(n_colors):
        m[o[c]: o[c + 1]] = np.sort(m[o[c]: o[c + 1]])
    n_blocks = -(-n_colors // block)
    host = bm.pack_bitmask_blocks(
        np.concatenate([o, np.full(n_blocks * block - n_colors, o[-1])]),
        m, panel_pad, block,
    )
    keys = keys_from_csr(o, m, panel_pad, n_blocks, block)
    dev = np.asarray(bm.scatter_pack_device(keys, n_blocks, block, panel_pad))
    assert np.array_equal(dev, host)


def test_scatter_pack_empty_side(rng):
    keys = keys_from_csr(
        np.zeros(2, np.int64), np.zeros(0, np.int64), 256, 1, 128
    )
    dev = np.asarray(bm.scatter_pack_device(keys, 1, 128, 256))
    assert dev.shape == (1, 128, 32)
    assert not dev.any()


@pytest.mark.parametrize("policy", ["force", "auto", "off"])
def test_tiled_stream_identical_under_device_pack(rng, monkeypatch, policy):
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", policy)
    # low ratio so 'auto' actually flips some sides on this small workload
    monkeypatch.setenv("KSPIDER_DEVICE_PACK_RATIO", "1")
    n = 1100
    o, m, w = random_csr(rng, 900, n, max_degree=12, max_weight=40000)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    stats: dict = {}
    s = assemble(
        tp.iter_panel_pairs(plan, engine="xla", block=128, tile=128,
                            stats=stats),
        n,
    )
    assert np.array_equal(s, pw.shared_kmer_matrix_numpy(o, m, w, n))
    if policy == "force":
        assert stats["keys_sides"] > 0 and stats["bits_sides"] == 0
    elif policy == "off":
        assert stats["keys_sides"] == 0 and stats["bits_sides"] > 0
    else:
        assert stats["keys_sides"] + stats["bits_sides"] > 0


def test_tiled_pair_parallel_device_pack(rng, monkeypatch):
    """Pair-parallel multi-device dispatch with posting-key sides: the
    scatter materializes under each pair's placement context."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device virtual mesh")
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", "force")
    n = 900
    o, m, w = random_csr(rng, 700, n, max_degree=10, max_weight=500)
    plan = tp.build_panel_plan(o, m, w, n, panel=128)
    stats: dict = {}
    s = assemble(
        tp.iter_panel_pairs(plan, engine="auto", block=64, tile=128,
                            stats=stats),
        n,
    )
    assert stats["n_devices"] > 1
    assert stats["keys_sides"] > 0
    assert np.array_equal(s, pw.shared_kmer_matrix_numpy(o, m, w, n))


def test_device_pack_big_weights_exact(rng, monkeypatch):
    """The per-limb extraction path (total weight >= 2**31) composes with
    device-packed sides."""
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", "force")
    n = 300
    o, m, w = random_csr(rng, 200, n, max_degree=8, max_weight=100)
    w = w.astype(np.int64) * 30_000_000  # push total past 2**31
    plan = tp.build_panel_plan(o, m, w, n, panel=128)
    assert plan.max_weight_sum >= 2**31
    s = assemble(
        tp.iter_panel_pairs(plan, engine="xla", block=64, tile=128), n
    )
    assert np.array_equal(s, pw.shared_kmer_matrix_numpy(o, m, w, n))


def test_cli_device_pack_flag(tmp_path, rng):
    """`pairwise --device-pack force/off` through the real CLI: identical
    TSVs, flag accepted (the env-var path is covered above)."""
    from kspider_tpu.core.index import build_index_from_hash_sets
    from kspider_tpu.io import artifacts as artifacts_io
    from tests.test_models_cli import _run_cli

    names = [f"s{i}" for i in range(12)]
    pool = np.unique(rng.integers(0, 2**62, size=4000, dtype=np.uint64))
    sets = [
        np.unique(np.concatenate([pool[:300], pool[rng.random(len(pool)) < 0.1]]))
        for _ in names
    ]
    index = build_index_from_hash_sets(names, sets, ksize=21)
    artifacts_io.write_index_artifacts(str(tmp_path / "idx"), index)

    outs = {}
    for policy in ("force", "off"):
        r = _run_cli(
            ["pairwise", "-i", "idx", "--engine", "tiled", "--panel", "8",
             "--device-pack", policy, "--cpu"],
            cwd=tmp_path,
        )
        assert r.returncode == 0, r.stderr
        outs[policy] = (tmp_path / "idx_kSpider_pairwise.tsv").read_bytes()
    assert outs["force"] == outs["off"]
    assert outs["force"].count(b"\n") > 1


def test_policy_gates(monkeypatch):
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", "force")
    assert tp._resolve_device_pack("xla", None) == "force"
    assert tp._resolve_device_pack("sharded", None) == "off"
    assert tp._resolve_device_pack("xla", object()) == "off"
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", "bogus")
    with pytest.warns(RuntimeWarning):
        assert tp._resolve_device_pack("xla", None) == "auto"


def test_cache_composes_with_device_pack(rng, monkeypatch):
    """Cache + device-pack now compose: off-diagonal (reused) sides go
    through the device cache, diagonal (single-use) sides keep the
    posting-key path; output stays exact."""
    from kspider_tpu.ops import pairwise as pw

    monkeypatch.setenv("KSPIDER_DEVICE_PACK", "force")
    n = 600
    o, m, w = random_csr(rng, 500, n, max_degree=10, max_weight=1000)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    stats = {}
    s1 = np.zeros((n, n), dtype=np.int64)
    for _, _, gi, gj, vals in tp.iter_panel_pairs(
            plan, engine="xla", block=128, tile=128,
            cache_bytes=1 << 30, stats=stats):
        s1[gi, gj] += vals
        s1[gj, gi] += vals
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)
    # the cache really engaged for the off-diagonal sides
    assert stats["cache_misses"] > 0


def test_postings_keys_int32_overflow_guard():
    plan = tp.PanelPlan(
        n=8, panel=8, n_panels=1,
        mem_s=np.arange(4, dtype=np.int32),
        seg_start=np.array([0], np.int64), seg_count=np.array([4], np.int64),
        seg_color=np.array([0], np.int64),
        w_limbs=np.ones((1, 1), np.int8),
        pair_keys=np.array([0], np.int64), pair_off=np.array([0, 1], np.int64),
        ent_sega=np.array([0], np.int64), ent_segb=np.array([0], np.int64),
        max_weight_sum=4,
    )
    # bit-position space too large for int32 -> caller must host-pack
    assert tp._postings_keys(
        plan, 0, np.array([0]), panel_pad=2**20, n_blocks=2**10, block=2**10
    ) is None


def test_delta_keys_bit_exact(rng):
    """Delta-compressed keys decode to the identical packed bitmask."""
    import jax.numpy as jnp

    n_blocks, block, n_pad = 2, 64, 256
    total = n_blocks * block * n_pad
    m = 700
    keys = np.sort(rng.choice(total, size=m, replace=False)).astype(np.int32)
    bucket = bm.key_bucket(m)
    padded = np.empty(bucket, np.int32)
    padded[:m] = keys
    padded[m:] = total + np.arange(bucket - m, dtype=np.int32)

    ref = np.asarray(bm.scatter_pack_device(padded, n_blocks, block, n_pad))
    enc = bm.delta_encode_keys(padded, m)
    assert enc is not None
    first, d16 = enc
    assert d16.dtype == np.int16 and len(d16) == bucket
    got = np.asarray(bm.scatter_pack_device_delta(
        np.int32(first), jnp.asarray(d16), np.int32(m), n_blocks, block,
        n_pad))
    assert np.array_equal(got, ref)


def test_delta_keys_fallback_on_big_gap():
    keys = np.array([0, 40000, 40001, 40002], np.int32)  # gap > int16
    assert bm.delta_encode_keys(keys, 4) is None
    assert bm.delta_encode_keys(keys, 0) is None
    # small gaps qualify
    ok = bm.delta_encode_keys(np.array([5, 6, 32773], np.int32), 3)
    assert ok is not None and ok[0] == 5


def test_delta8_keys_bit_exact_with_escapes(rng):
    """u8-delta keys (escape channel for >255 gaps) decode to the
    identical packed bitmask, including mixed escape/literal runs."""
    import jax.numpy as jnp

    n_blocks, block, n_pad = 2, 64, 512
    total = n_blocks * block * n_pad
    # construct keys with small runs separated by big gaps (escapes)
    parts = []
    base = 0
    for _ in range(40):
        run = np.cumsum(rng.integers(1, 200, size=20))
        parts.append(base + run)
        base = int(parts[-1][-1]) + int(rng.integers(300, 2000))
        if base >= total - 5000:
            break
    keys = np.concatenate(parts).astype(np.int32)
    m = len(keys)
    bucket = bm.key_bucket(m)
    padded = np.empty(bucket, np.int32)
    padded[:m] = keys
    padded[m:] = total + np.arange(bucket - m, dtype=np.int32)

    ref = np.asarray(bm.scatter_pack_device(padded, n_blocks, block, n_pad))
    enc = bm.delta_encode_keys_u8(padded, m)
    assert enc is not None
    first, d8, exc = enc
    assert d8.dtype == np.uint8
    # every gap > 255 escapes into the exception array, in order
    gaps = np.diff(keys.astype(np.int64))
    n_exc = int((gaps > 255).sum())
    assert n_exc > 0
    assert np.array_equal(exc[:n_exc], gaps[gaps > 255])
    assert (exc[:n_exc] > 255).all()
    assert int((d8[1:m] == 0).sum()) == n_exc
    got = np.asarray(bm.scatter_pack_device_delta8(
        np.int32(first), jnp.asarray(d8), jnp.asarray(exc),
        np.int32(m), n_blocks, block, n_pad))
    assert np.array_equal(got, ref)


def test_encode_keys_best_selection():
    # dense small deltas -> d8 wins
    k = np.arange(5, 1000, 3, dtype=np.int32)
    pad = np.concatenate([k, 10**6 + np.arange(200, dtype=np.int32)])
    enc = bm.encode_keys_best(pad, len(k))
    assert enc is not None and enc[0] == "d8"
    # gaps >32767 everywhere -> d8 with many escapes may still beat raw,
    # but d16 must be skipped
    k2 = np.arange(10, dtype=np.int32) * 40000
    pad2 = np.concatenate([k2, 10**6 + np.arange(6, dtype=np.int32)])
    enc2 = bm.encode_keys_best(pad2, len(k2))
    assert enc2 is None or enc2[0] == "d8"
    assert bm.encode_keys_best(pad2, 0) is None


def test_tiled_stream_exact_with_delta8_escapes(rng, monkeypatch):
    """End-to-end streamed output stays exact when sides mix literal and
    escape deltas (sparse colors spread across a wide panel)."""
    monkeypatch.setenv("KSPIDER_DEVICE_PACK", "force")
    n = 1600
    o, m, w = random_csr(rng, 300, n, max_degree=5, max_weight=1000)
    plan = tp.build_panel_plan(o, m, w, n, panel=512)
    s = assemble(
        tp.iter_panel_pairs(plan, engine="xla", block=64, tile=128), n
    )
    assert np.array_equal(s, pw.shared_kmer_matrix_numpy(o, m, w, n))

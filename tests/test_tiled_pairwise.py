"""Panel-streamed pairwise engine vs the numpy/full-matrix references."""

import numpy as np
import pytest

from kspider_tpu.core import pairwise as core_pw
from kspider_tpu.ops import pairwise as pw
from kspider_tpu.ops import tiled_pairwise as tp
from tests.test_pairwise_ops import random_csr


def assemble(plan_iter, n):
    s = np.zeros((n, n), dtype=np.int64)
    for _, _, gi, gj, vals in plan_iter:
        assert (gi < gj).all()
        s[gi, gj] += vals
        s[gj, gi] += vals
    return s


def test_panel_plan_covers_all_pairs(rng):
    o, m, w = random_csr(rng, 400, 700, max_degree=9, max_weight=500)
    plan = tp.build_panel_plan(o, m, w, 700, panel=256)
    # every color with >=2 members in two panels appears in that pair's list
    degrees = np.diff(o)
    npan = plan.n_panels
    expect_pairs = set()
    for c in range(len(degrees)):
        ms = m[o[c] : o[c + 1]]
        if len(ms) < 2:
            continue
        pans = sorted(set(int(x) // 256 for x in ms))
        from collections import Counter

        cnt = Counter(int(x) // 256 for x in ms)
        for i, pa in enumerate(pans):
            for pb in pans[i:]:
                if pa == pb and cnt[pa] < 2:
                    continue
                expect_pairs.add(pa * npan + pb)
    assert set(plan.pair_keys.tolist()) == expect_pairs


@pytest.mark.parametrize("panel", [256, 512])
def test_tiled_matches_numpy(rng, panel):
    n = 1300  # spans multiple panels incl. a ragged last one
    o, m, w = random_csr(rng, 800, n, max_degree=14, max_weight=40000)
    plan = tp.build_panel_plan(o, m, w, n, panel=panel)
    s1 = assemble(
        tp.iter_panel_pairs(plan, engine="xla", block=128, tile=128), n
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)


def test_tiled_auto_uses_mesh_on_multidevice(rng):
    # engine="auto" on a multi-device backend (the 8-device virtual CPU
    # mesh here) must shard the color blocks, same rule as the
    # full-matrix dispatcher — and still be exact
    n = 600
    o, m, w = random_csr(rng, 400, n, max_degree=10, max_weight=1000)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    s1 = assemble(
        tp.iter_panel_pairs(plan, engine="auto", block=128, tile=128), n
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)


def test_tiled_pair_parallel_byte_identical_no_collectives(rng, tmp_path,
                                                           monkeypatch):
    """Panel-pair data parallelism (auto mode with many pairs on a
    multi-device backend): independent pairs round-robin to the 8
    virtual devices, ZERO per-pair collectives, and the streamed TSV is
    byte-identical to the single-device stream."""
    import jax

    from kspider_tpu.ops import tiled_pairwise as tpmod

    n = 2300  # 9 panels -> 45 candidate pairs >= 2 * 8 devices
    o, m, w = random_csr(rng, 1500, n, max_degree=14, max_weight=40000)
    counts = rng.integers(1, 100000, size=n).astype(np.int64)
    idx = _FakeIndex(o, m, w, n, counts)

    single_prefix = str(tmp_path / "single")
    tp.stream_pairwise_tsv(idx, single_prefix, panel=256, engine="xla",
                           block=128)

    def _no_collectives(*a, **k):
        raise AssertionError("pair-parallel mode must not psum")

    monkeypatch.setattr(tpmod, "_gram_rect_sharded", _no_collectives)
    stats = {}
    par_prefix = str(tmp_path / "par")
    tp.stream_pairwise_tsv(idx, par_prefix, panel=256, engine="auto",
                           block=128, stats=stats)
    assert stats["n_devices"] == len(jax.local_devices()) > 1
    single = open(single_prefix + "_kSpider_pairwise.tsv", "rb").read()
    par = open(par_prefix + "_kSpider_pairwise.tsv", "rb").read()
    assert par == single


def test_tiled_sharded_mesh_matches_numpy(rng):
    from kspider_tpu.parallel.mesh import make_mesh

    n = 1100
    o, m, w = random_csr(rng, 700, n, max_degree=12, max_weight=5000)
    plan = tp.build_panel_plan(o, m, w, n, panel=512)
    mesh = make_mesh(8)
    s1 = assemble(
        tp.iter_panel_pairs(plan, block=128, tile=128, mesh=mesh), n
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)


def test_tiled_psum_few_pairs_many_colors(rng):
    """The per-pair-psum leg at a non-toy shape: 2048 samples in two
    panels (<=3 panel pairs) with thousands of colors — the few-pairs
    regime where the dispatcher shards each pair's color blocks over the
    mesh and psums partial tiles (VERDICT r3 item 6)."""
    from kspider_tpu.parallel.mesh import make_mesh

    n = 2048
    o, m, w = random_csr(rng, 3000, n, max_degree=10, max_weight=300)
    plan = tp.build_panel_plan(o, m, w, n, panel=1024)
    assert len(plan.pair_keys) <= 3
    mesh = make_mesh(8)
    s1 = assemble(
        tp.iter_panel_pairs(plan, block=128, tile=256, mesh=mesh), n
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)


def test_tiled_min_shared_threshold(rng):
    n = 600
    o, m, w = random_csr(rng, 500, n, max_degree=10, max_weight=200)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    thresh = 150
    s = np.zeros((n, n), dtype=np.int64)
    for _, _, gi, gj, vals in tp.iter_panel_pairs(
        plan, engine="xla", block=128, tile=128, min_shared=thresh
    ):
        assert (vals >= thresh).all()
        s[gi, gj] = vals
    ref = pw.shared_kmer_matrix_numpy(o, m, w, n)
    ref_up = np.triu(ref, k=1)
    ref_up[ref_up < thresh] = 0
    assert np.array_equal(s, ref_up)


def test_tiled_small_cap_regrow(rng):
    # tiny cap0 floor + dense-ish result: the two-phase extract must pick
    # a gather capacity >= the true count on its own
    n = 300
    o, m, w = random_csr(rng, 600, n, max_degree=30, max_weight=50)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    s1 = assemble(
        tp.iter_panel_pairs(plan, engine="xla", block=128, tile=128, cap0=64),
        n,
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)


@pytest.mark.parametrize("engine", ["xla", "sharded"])
def test_tiled_big_weights_exact(rng, engine):
    """Total kept weight >= 2**31 (the r2 NotImplementedError case):
    per-limb extraction + int64 host recombine keeps the stream exact."""
    n = 700
    o, m, w = random_csr(rng, 60, n, max_degree=12, max_weight=50)
    w = w.astype(np.int64) * (1 << 27)  # total wdeg>=2 weight >> 2**31
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    assert plan.max_weight_sum >= 2**31
    from kspider_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4) if engine == "sharded" else None
    s1 = assemble(
        tp.iter_panel_pairs(plan, engine=engine, block=128, tile=128,
                            mesh=mesh),
        n,
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)


def test_tiled_big_weights_min_shared(rng):
    n = 400
    o, m, w = random_csr(rng, 50, n, max_degree=10, max_weight=40)
    w = w.astype(np.int64) * (1 << 28)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    assert plan.max_weight_sum >= 2**31
    thresh = int(3 << 28)
    s = np.zeros((n, n), dtype=np.int64)
    for _, _, gi, gj, vals in tp.iter_panel_pairs(
        plan, engine="xla", block=128, tile=128, min_shared=thresh
    ):
        assert (vals >= thresh).all()
        s[gi, gj] = vals
    ref = np.triu(pw.shared_kmer_matrix_numpy(o, m, w, n), k=1)
    ref[ref < thresh] = 0
    assert np.array_equal(s, ref)


def test_tiled_big_weights_multichunk_host_accumulate(rng, monkeypatch):
    """A big-weight pair spanning multiple super-block chunks takes the
    host int64 tile accumulation branch (per-limb int32 sums across
    chunks could overflow); forced here by shrinking the super-block."""
    monkeypatch.setattr(pw, "_MAX_COLORS_PER_CALL", 256)
    n = 100
    o, m, w = random_csr(rng, 600, n, max_degree=6, max_weight=30)
    w = w.astype(np.int64) * (1 << 23)  # 600 colors * ~2**27 avg >= 2**31
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    assert plan.max_weight_sum >= 2**31
    assert len(plan.ent_sega) > 256  # really spans >1 chunk
    s1 = assemble(
        tp.iter_panel_pairs(plan, engine="xla", block=128, tile=128), n
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)


class _FakeIndex:
    def __init__(self, o, m, w, n, counts):
        self.color_offsets = o
        self.color_members = m
        self.color_counts = w
        self.num_groups = n
        self.group_kmer_count = counts


def test_stream_tsv_matches_full_writer(rng, tmp_path):
    n = 700
    o, m, w = random_csr(rng, 900, n, max_degree=12, max_weight=30000)
    counts = rng.integers(1, 100000, size=n).astype(np.int64)
    idx = _FakeIndex(o, m, w, n, counts)

    shared = pw.shared_kmer_matrix_numpy(o, m, w, n)
    full_prefix = str(tmp_path / "full")
    core_pw.write_pairwise_tsv(full_prefix, idx, shared)

    stream_prefix = str(tmp_path / "stream")
    n_rows = tp.stream_pairwise_tsv(
        idx, stream_prefix, panel=256, engine="xla", block=128
    )
    full = open(full_prefix + "_kSpider_pairwise.tsv").read()
    streamed = open(stream_prefix + "_kSpider_pairwise.tsv").read()
    assert streamed == full
    assert n_rows == int((shared > 0).sum()) // 2


def test_stream_tsv_empty(rng, tmp_path):
    # all singleton colors -> zero pairs, header-only file
    o = np.arange(6, dtype=np.int64)
    m = np.arange(5, dtype=np.int64)
    w = np.ones(5, dtype=np.int64)
    counts = np.ones(5, dtype=np.int64)
    idx = _FakeIndex(o, m, w, 5, counts)
    prefix = str(tmp_path / "empty")
    n_rows = tp.stream_pairwise_tsv(idx, prefix, panel=256, engine="xla")
    assert n_rows == 0
    lines = open(prefix + "_kSpider_pairwise.tsv").read().splitlines()
    assert lines == [
        "source_1\tsource_2\tshared_kmers\tmin_containment\tavg_containment\tmax_containment"
    ]


def _global_color_csr(rng, n, panel, n_colors):
    """CSR of colors that each have one member in every panel — a panel's
    side selection is then identical across its whole row of pairs, the
    workload shape the device side cache exists for."""
    n_panels = -(-n // panel)
    m = np.stack(
        [rng.integers(p * panel, min((p + 1) * panel, n), size=n_colors)
         for p in range(n_panels)], axis=1,
    ).reshape(-1).astype(np.int64)
    o = (n_panels * np.arange(n_colors + 1)).astype(np.int64)
    w = rng.integers(1, 100, size=n_colors).astype(np.int64)
    return o, m, w


def test_tiled_device_cache_hits_exact(rng):
    # opt-in device-resident side cache (cache_bytes>0): on a
    # panel-spanning workload the repeated side selections must hit the
    # cache AND stay exact (wrong keying / stale reuse would corrupt the
    # shared counts silently)
    n = 1300
    o, m, w = _global_color_csr(rng, n, 256, 60)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    stats = {}
    s1 = assemble(
        tp.iter_panel_pairs(
            plan, engine="xla", block=128, tile=128,
            cache_bytes=1 << 30, stats=stats,
        ),
        n,
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)
    assert stats["cache_hits"] > 0
    assert stats["cache_misses"] > 0


def test_tiled_device_cache_eviction_exact(rng):
    # a tiny budget forces constant LRU eviction on a mixed workload;
    # output must be unchanged and the budget respected
    budget = 200_000
    n = 1300
    o, m, w = random_csr(rng, 800, n, max_degree=14, max_weight=40000)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    stats = {}
    s1 = assemble(
        tp.iter_panel_pairs(
            plan, engine="xla", block=128, tile=128,
            cache_bytes=budget, stats=stats,
        ),
        n,
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)
    assert stats["cache_misses"] > 0
    assert stats["cache_bytes"] <= budget


def test_tiled_device_cache_sharded_exact(rng):
    # the cache's NamedSharding device_put branch (mesh path) stays exact
    from kspider_tpu.parallel.mesh import make_mesh

    n = 600
    o, m, w = random_csr(rng, 500, n, max_degree=10, max_weight=1000)
    plan = tp.build_panel_plan(o, m, w, n, panel=256)
    mesh = make_mesh()
    stats = {}
    s1 = assemble(
        tp.iter_panel_pairs(
            plan, block=128, tile=128, mesh=mesh,
            cache_bytes=1 << 30, stats=stats,
        ),
        n,
    )
    s2 = pw.shared_kmer_matrix_numpy(o, m, w, n)
    assert np.array_equal(s1, s2)
    assert stats["cache_misses"] > 0


def _midsize_index(seed=7, n=600):
    from kspider_tpu.core.index import build_index_from_hash_sets

    rng = np.random.default_rng(seed)
    names = [f"s{i}" for i in range(n)]
    pool = np.unique(rng.integers(0, 2**62, size=4000, dtype=np.uint64))
    arrays = []
    for _ in range(n):
        take = rng.integers(20, 60)
        arrays.append(np.unique(rng.choice(pool, size=take, replace=False)))
    return build_index_from_hash_sets(names, arrays, ksize=21,
                                      params="kSize:21")


def test_stream_tsv_plan_reuse_byte_identical(tmp_path):
    """stream_pairwise_tsv(plan=prebuilt) == plan=None, byte for byte —
    the plan-reuse path callers hit after panel_row_work load estimation."""
    index = _midsize_index()
    p_auto = str(tmp_path / "auto")
    p_reuse = str(tmp_path / "reuse")
    n1 = tp.stream_pairwise_tsv(index, p_auto, panel=256, engine="xla",
                                block=128)
    plan = tp.build_panel_plan(index.color_offsets, index.color_members,
                               index.color_counts, index.num_groups, 256)
    n2 = tp.stream_pairwise_tsv(index, p_reuse, panel=256, engine="xla",
                                block=128, plan=plan)
    assert n1 == n2
    golden = open(p_auto + "_kSpider_pairwise.tsv", "rb").read()
    got = open(p_reuse + "_kSpider_pairwise.tsv", "rb").read()
    assert got == golden


def test_stream_tsv_plan_mismatch_raises(tmp_path):
    index = _midsize_index()
    plan = tp.build_panel_plan(index.color_offsets, index.color_members,
                               index.color_counts, index.num_groups, 256)
    # wrong panel
    with pytest.raises(ValueError, match="panel=256"):
        tp.stream_pairwise_tsv(index, str(tmp_path / "x"), panel=512,
                               engine="xla", block=128, plan=plan)
    # plan built from a DIFFERENT index (other sample count)
    other = _midsize_index(seed=11, n=500)
    plan_other = tp.build_panel_plan(
        other.color_offsets, other.color_members, other.color_counts,
        other.num_groups, 256)
    with pytest.raises(ValueError, match="different index"):
        tp.stream_pairwise_tsv(index, str(tmp_path / "y"), panel=256,
                               engine="xla", block=128, plan=plan_other)
    # same n but different postings (src_shape fingerprint catches it)
    other2 = _midsize_index(seed=13, n=600)
    plan_other2 = tp.build_panel_plan(
        other2.color_offsets, other2.color_members, other2.color_counts,
        other2.num_groups, 256)
    with pytest.raises(ValueError, match="different index"):
        tp.stream_pairwise_tsv(index, str(tmp_path / "z"), panel=256,
                               engine="xla", block=128, plan=plan_other2)

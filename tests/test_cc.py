"""Device connected components vs scipy."""

import numpy as np

from kspider_tpu.ops import cc


def test_simple_components():
    src = np.array([0, 1, 3], dtype=np.int32)
    dst = np.array([1, 2, 4], dtype=np.int32)
    labels = cc.connected_components(src, dst, 6)
    assert labels.tolist() == [0, 0, 0, 3, 3, 5]


def test_matches_scipy_random(rng):
    n = 500
    e = 800
    src = rng.integers(0, n, size=e).astype(np.int32)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    dev = cc.connected_components(src, dst, n)
    host = cc.connected_components_scipy(src, dst, n)
    assert np.array_equal(dev, host)


def test_chain_graph_log_convergence():
    # worst case for naive propagation: a long path
    n = 4097
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    labels = cc.connected_components(src, dst, n)
    assert np.all(labels == 0)


def test_no_edges():
    labels = cc.connected_components(
        np.empty(0, np.int32), np.empty(0, np.int32), 4
    )
    assert labels.tolist() == [0, 1, 2, 3]


def test_labels_to_clusters():
    labels = np.array([0, 0, 2, 2, 0, 5], dtype=np.int32)
    comps = cc.labels_to_clusters(labels)
    assert [c.tolist() for c in comps] == [[0, 1, 4], [2, 3], [5]]


def test_streamed_cluster_chunks_match_single_pass(tmp_path, rng):
    """cluster_index folds 10M-row TSV chunks into running labels; tiny
    chunk_rows must produce the identical clustering to one big chunk."""
    from kspider_tpu.core import cluster as cluster_core

    n = 40
    prefix = str(tmp_path / "idx")
    with open(prefix + ".namesMap", "w") as f:
        f.write(f"{n}\n")
        for i in range(1, n + 1):
            f.write(f"{i} s{i}\n")
    # random graph: ~150 edges above cutoff scattered among below-cutoff rows
    rows = []
    for _ in range(400):
        a, b = sorted(rng.choice(n, size=2, replace=False) + 1)
        d = float(rng.random())
        rows.append(f"{a}\t{b}\t10\t{d:.4f}\t{d:.4f}\t{d:.4f}")
    with open(prefix + "_kSpider_pairwise.tsv", "w") as f:
        f.write("h1\th2\th3\th4\th5\th6\n")
        f.write("\n".join(rows) + "\n")

    out_small = cluster_core.cluster_index(
        prefix, 0.5, use_device=False, chunk_rows=7
    )
    small = open(out_small).read()
    out_big = cluster_core.cluster_index(
        prefix, 0.5, use_device=False, chunk_rows=10**7
    )
    assert open(out_big).read() == small
    # and the device pointer-jumping path agrees with scipy
    out_dev = cluster_core.cluster_index(prefix, 0.5, use_device=True, chunk_rows=13)
    assert open(out_dev).read() == small


def test_cluster_from_index_matches_tsv_path(tmp_path, rng):
    """The TSV-free fused path (panel stream -> threshold -> CC) produces
    the same clusters as pairwise TSV -> cluster_index."""
    from kspider_tpu.core import cluster as cluster_core
    from kspider_tpu.core import pairwise as core_pairwise
    from kspider_tpu.core.index import build_index_from_hash_sets
    from kspider_tpu.io import artifacts as artifacts_io

    n = 24
    pool = np.unique(rng.integers(0, 2**63, size=30000, dtype=np.uint64))
    fams = [pool[i * 8000 : (i + 1) * 8000] for i in range(3)]
    arrays = []
    for i in range(n):
        fam = fams[i % 3]
        arrays.append(np.unique(np.concatenate([
            fam[rng.random(len(fam)) < 0.5],
            pool[24000 + i * 200 : 24000 + (i + 1) * 200],
        ])))
    names = [f"s{i}" for i in range(n)]
    index = build_index_from_hash_sets(names, arrays, ksize=21)
    prefix = str(tmp_path / "idx")
    artifacts_io.write_index_artifacts(prefix, index)
    shared = core_pairwise.compute_shared_matrix(index, use_device=False)
    core_pairwise.write_seq_to_kmers_tsv(prefix, index)
    core_pairwise.write_pairwise_tsv(prefix, index, shared)

    for cutoff in (0.2, 0.5):
        out_tsv = cluster_core.cluster_index(prefix, cutoff, use_device=False)
        via_tsv = open(out_tsv).read()
        out_fused = cluster_core.cluster_from_index(
            index, prefix, cutoff, use_device=False, panel=16, block=64
        )
        assert open(out_fused).read() == via_tsv, cutoff


# --- executed rustworkx-order differential (PARITY.md "component order") ---
#
# The reference iterates rx.connected_components(graph)
# (/root/reference/pykSpider/kSpider2/ks_clustering.py:119,129-137).
# rustworkx-core's connected_components scans node indices ascending and
# BFS-es each unvisited node, yielding components ordered by smallest
# member; each component reaches Python as a real set of ints.  The
# replica below executes that algorithm (ascending scan + BFS, members
# collected into a genuine CPython set in discovery order) so the PARITY
# claim rests on running code, not a reading of rustworkx-core.


def _rx_replica_components(n_nodes, edges):
    from collections import deque

    adj = [[] for _ in range(n_nodes)]
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)
    seen = [False] * n_nodes
    comps = []
    for s in range(n_nodes):  # ascending node scan
        if seen[s]:
            continue
        seen[s] = True
        comp = set()
        q = deque([s])
        while q:
            u = q.popleft()
            comp.add(u)  # CPython set insertion in BFS discovery order
            for v in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    q.append(v)
        comps.append(comp)
    return comps


def test_component_order_matches_rx_replica(rng):
    n = 800
    e = 600  # sparse: many singletons + mid components
    src = rng.integers(0, n, size=e).astype(np.int32)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    labels = np.asarray(cc.connected_components(src, dst, n))
    ours = cc.labels_to_clusters(labels)
    theirs = _rx_replica_components(n, zip(src.tolist(), dst.tolist()))
    assert len(ours) == len(theirs)
    for c_ours, c_theirs in zip(ours, theirs):
        # identical component ORDER (ascending by smallest member) and
        # identical MEMBERSHIP; our member order is normalized ascending
        assert set(c_ours.tolist()) == c_theirs
        assert c_ours.tolist() == sorted(c_ours.tolist())


def test_member_order_divergence_is_reference_accident():
    """Adversarial shape from PARITY.md: a {5, 1_000_000} component.

    Executed evidence that the reference's within-component member order
    is an accident of CPython set hash-table geometry: in an 8-slot set,
    1_000_000 % 8 == 0 lands before 5, so the reference would write
    '1000000,5' while this repo writes ascending '5,1000000'.  Every
    consumer-visible contract (membership, component order) still
    matches the replica."""
    comp = set()
    comp.add(5)
    comp.add(1_000_000)
    assert list(comp) == [1_000_000, 5]  # CPython set order: NOT ascending

    # same geometry at test-friendly scale: 10_000 % 8 == 0 also lands
    # before 5 in an 8-slot table
    assert list({5, 10_000}) == [10_000, 5]

    # that component through our pipeline: normalized ascending
    src = np.array([5], dtype=np.int64)
    dst = np.array([10_000], dtype=np.int64)
    labels = cc.connected_components_scipy(src, dst, 10_001)
    comps = cc.labels_to_clusters(np.asarray(labels))
    two = [c for c in comps if len(c) == 2]
    assert len(two) == 1 and two[0].tolist() == [5, 10_000]

    # and the rx replica agrees on membership + component order
    theirs = _rx_replica_components(10_001, [(5, 10_000)])
    assert {5, 10_000} in theirs
    # dense small ids (the common case): CPython set order IS ascending,
    # so reference output and ours coincide exactly there
    assert list({2, 3, 7}) == [2, 3, 7]

"""End-to-end scale run: 1K samples, full pipeline on one device.

Mirrors BASELINE.json config 3 ("1K bacterial genomes, containment
threshold sweep 0.3/0.5/0.8") with synthetic FracMinHash sketches:
32 families x 32 samples, ~5K hashes per sample (a 5 Mbp genome at
scaled=1000), family cores with per-sample subsampling plus private
hashes.

Usage: python benchmarks/e2e_scale.py [--samples 1024] [--cpu]
Prints a per-stage timing table and validates cluster structure.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_dataset(n_samples, hashes_per_sample, rng):
    fam_size = 32
    n_fams = n_samples // fam_size
    names, arrays = [], []
    core_frac = 0.6
    core_n = int(hashes_per_sample * core_frac)
    for fam in range(n_fams):
        fam_rng = np.random.default_rng(rng.integers(2**63))
        core = np.unique(
            fam_rng.integers(0, 2**63, size=int(core_n * 1.4), dtype=np.uint64)
        )[: core_n]
        for i in range(fam_size):
            take = fam_rng.random(len(core)) < 0.9
            own = np.unique(
                fam_rng.integers(
                    0, 2**63, size=hashes_per_sample - int(take.sum()),
                    dtype=np.uint64,
                )
            )
            names.append(f"f{fam:03d}_s{i:02d}")
            arrays.append(np.unique(np.concatenate([core[take], own])))
    return names, arrays


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--hashes", type=int, default=5000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--engine", default="auto")
    args = ap.parse_args()

    import jax

    from kspider_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from kspider_tpu.core import cluster as core_cluster
    from kspider_tpu.core import pairwise as core_pairwise
    from kspider_tpu.core.index import build_index_from_hash_sets
    from kspider_tpu.io import artifacts as artifacts_io

    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    names, arrays = make_dataset(args.samples, args.hashes, rng)
    t_gen = time.perf_counter() - t0
    total_postings = sum(len(a) for a in arrays)
    print(f"dataset gen:      {t_gen:8.3f}s", flush=True)

    t0 = time.perf_counter()
    index = build_index_from_hash_sets(names, arrays, ksize=31)
    t_index = time.perf_counter() - t0
    print(f"index build:      {t_index:8.3f}s  colors={index.num_colors}", flush=True)

    tmp = tempfile.mkdtemp()
    prefix = os.path.join(tmp, "scale")
    t0 = time.perf_counter()
    artifacts_io.write_index_artifacts(prefix, index)
    t_artifacts = time.perf_counter() - t0
    print(f"artifact write:   {t_artifacts:8.3f}s", flush=True)

    t0 = time.perf_counter()
    shared = core_pairwise.compute_shared_matrix(index, engine=args.engine)
    t_pairwise = time.perf_counter() - t0
    print(f"pairwise cold:    {t_pairwise:8.3f}s", flush=True)
    t0 = time.perf_counter()
    shared = core_pairwise.compute_shared_matrix(index, engine=args.engine)
    t_pairwise_warm = time.perf_counter() - t0

    t0 = time.perf_counter()
    core_pairwise.write_seq_to_kmers_tsv(prefix, index)
    n_pairs = core_pairwise.write_pairwise_tsv(prefix, index, shared)
    t_tsv = time.perf_counter() - t0

    cluster_times = {}
    n_clusters = {}
    for cutoff in (0.3, 0.5, 0.8):
        t0 = time.perf_counter()
        out = core_cluster.cluster_index(prefix, cutoff, use_device=not args.cpu)
        cluster_times[cutoff] = time.perf_counter() - t0
        with open(out) as f:
            n_clusters[cutoff] = sum(1 for _ in f)

    kmers_per_s = total_postings / t_index
    print(f"samples={args.samples} postings={total_postings} colors={index.num_colors} pairs={n_pairs}")
    print(f"dataset gen:      {t_gen:8.3f}s")
    print(f"index build:      {t_index:8.3f}s  ({kmers_per_s/1e6:.1f}M postings/s)")
    print(f"artifact write:   {t_artifacts:8.3f}s")
    print(f"pairwise matrix:  {t_pairwise:8.3f}s cold / {t_pairwise_warm:.3f}s warm (engine={args.engine})")
    print(f"tsv emission:     {t_tsv:8.3f}s")
    for cutoff, t in cluster_times.items():
        print(f"cluster @{cutoff}:    {t:8.3f}s -> {n_clusters[cutoff]} clusters")
    # structural sanity: family overlap is ~0.49 max containment by
    # construction (0.6 core x 0.9^2 subsampling), so families merge at
    # 0.3 and fully separate at 0.8
    assert n_clusters[0.3] == args.samples // 32, n_clusters
    assert n_clusters[0.8] == args.samples, n_clusters
    print("OK")


if __name__ == "__main__":
    main()

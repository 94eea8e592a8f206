"""Index-build backend A/B: host (native/numpy) vs device (lax.sort).

The index build is the stage replacing the reference's color-update loop
(/root/reference/src/sourmash_indexing.cpp:190-260).  This benchmark
measures "k-mers indexed/s" per backend on the same synthetic dataset —
the first metric in BASELINE.json — and verifies the two backends
produce identical ColorIndex contents.

Usage:
  python benchmarks/index_build.py [--samples 10240] [--hashes 2000]
         [--global-hashes 500] [--cpu] [--skip host|device]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.e2e_scale import make_dataset  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=10240)
    ap.add_argument("--hashes", type=int, default=2000)
    ap.add_argument("--global-hashes", type=int, default=500, dest="glob")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip", choices=["host", "device"], default=None,
                    help="run only the other backend (no cross-check)")
    ap.add_argument("--repeat", type=int, default=2,
                    help="timed passes per backend (first pass includes "
                         "compile; best is reported)")
    args = ap.parse_args()

    import jax

    from kspider_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from kspider_tpu.core.index import (
        build_index_device,
        build_index_from_hash_sets,
    )

    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    names, arrays = make_dataset(args.samples, args.hashes, rng)
    if args.glob:
        pool = np.unique(
            rng.integers(0, 2**63, size=int(args.glob * 1.4), dtype=np.uint64)
        )[: args.glob]
        arrays = [
            np.unique(np.concatenate([a, pool[rng.random(len(pool)) < 0.9]]))
            for a in arrays
        ]
    total = sum(len(a) for a in arrays)
    print(f"dataset gen: {time.perf_counter() - t0:.1f}s "
          f"({args.samples} samples, {total} postings)", flush=True)

    results = {}
    for label, builder in (
        ("host", build_index_from_hash_sets),
        ("device", build_index_device),
    ):
        if args.skip == label:
            continue
        best = None
        for r in range(max(1, args.repeat)):
            t0 = time.perf_counter()
            idx = builder(names, arrays, ksize=31)
            dt = time.perf_counter() - t0
            print(f"  {label} pass {r + 1}: {dt:8.3f}s "
                  f"({total / dt / 1e6:6.2f}M postings/s)", flush=True)
            best = dt if best is None else min(best, dt)
        results[label] = (best, idx)
        print(f"{label:6s} build: {best:8.3f}s  "
              f"{total / best / 1e6:6.2f}M postings/s  "
              f"colors={idx.num_colors}", flush=True)

    if len(results) == 2:
        _, hi = results["host"]
        _, di = results["device"]
        same = (
            np.array_equal(hi.color_offsets, di.color_offsets)
            and np.array_equal(hi.color_members, di.color_members)
            and np.array_equal(hi.color_counts, di.color_counts)
            and np.array_equal(hi.color_ids, di.color_ids)
            and np.array_equal(hi.group_kmer_count, di.group_kmer_count)
        )
        print("backends identical:", same, flush=True)
        if not same:
            raise SystemExit("MISMATCH between host and device index build")


if __name__ == "__main__":
    main()

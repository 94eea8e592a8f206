"""Large-N pairwise via the panel-streamed engine (ops/tiled_pairwise.py).

Synthetic workload = family-core sketches (as benchmarks/e2e_scale.py)
plus an optional *global* hash pool shared across all families: global
colors span every sample panel, exercising the off-diagonal rectangular
tiles; family colors stay within one panel and exercise the plan's tile
pruning (they touch only the diagonal pair).

Usage:
  python benchmarks/tiled_scale.py [--samples 32768] [--hashes 2000]
         [--global-hashes 500] [--panel 4096] [--cpu] [--validate 512]

Prints stage timings, pair-update throughput (sum_c C(deg_c, 2), the
reference hot-loop's work metric, /root/reference/src/pairwise.cpp:199-237),
and validates the first --validate samples' TSV rows against numpy.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.e2e_scale import make_dataset  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=32768)
    ap.add_argument("--hashes", type=int, default=2000)
    ap.add_argument("--global-hashes", type=int, default=500, dest="glob")
    ap.add_argument("--panel", type=int, default=4096)
    ap.add_argument("--min-shared", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--validate", type=int, default=512)
    ap.add_argument("--cache", action="store_true", dest="use_cache",
                    help="enable the device-resident packed-side LRU "
                         "(helps when colors span many panels)")
    ap.add_argument("--no-cache", action="store_true", dest="no_cache",
                    help=argparse.SUPPRESS)  # kept for A/B scripts
    ap.add_argument("--cutoffs", type=str, default="",
                    help="comma-separated cluster cutoffs (0..1) to run "
                         "after pairwise, closing the pipeline loop")
    ap.add_argument("--newick", action="store_true",
                    help="also build the newick tree during export")
    ap.add_argument("--device-build", action="store_true", dest="device_build",
                    help="run the index build's postings sort/dedup/"
                         "singleton filter on the accelerator "
                         "(core.index.build_index_device)")
    ap.add_argument("--device-pack", choices=["auto", "force", "off"],
                    default=None, dest="device_pack",
                    help="override KSPIDER_DEVICE_PACK for the run "
                         "(posting-key H2D + on-device scatter pack)")
    args = ap.parse_args()
    if args.device_pack is not None:
        # process-scoped: this script is a standalone entrypoint, the
        # override dies with the process (nothing imports main())
        os.environ["KSPIDER_DEVICE_PACK"] = args.device_pack

    import jax

    from kspider_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from kspider_tpu.core import pairwise as core_pairwise
    from kspider_tpu.core.index import (
        build_index_device,
        build_index_from_hash_sets,
    )
    from kspider_tpu.ops import pairwise as pw_ops
    from kspider_tpu.ops import tiled_pairwise as tp

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
    total_postings = sum(len(a) for a in arrays)
    print(f"dataset gen:      {time.perf_counter() - t0:8.3f}s "
          f"({total_postings} postings)", flush=True)

    t0 = time.perf_counter()
    if args.device_build:
        index = build_index_device(names, arrays, ksize=31)
    else:
        # consume=True frees each ~20 GB-total per-sample array as it is
        # copied into the flat posting buffer (the 1M-run RAM wall)
        index = build_index_from_hash_sets(names, arrays, ksize=31,
                                           consume=True)
    del arrays
    t_index = time.perf_counter() - t0
    backend = "device" if args.device_build else "host"
    print(f"index build:      {t_index:8.3f}s  colors={index.num_colors} "
          f"({total_postings / t_index / 1e6:.1f}M postings/s, {backend})",
          flush=True)

    degrees = np.diff(index.color_offsets)
    pair_updates = int((degrees.astype(np.int64) * (degrees - 1) // 2).sum())

    t0 = time.perf_counter()
    plan = tp.build_panel_plan(
        index.color_offsets, index.color_members, index.color_counts,
        index.num_groups, args.panel,
    )
    t_plan = time.perf_counter() - t0
    print(f"panel plan:       {t_plan:8.3f}s  panel_pairs={len(plan.pair_keys)} "
          f"entries={len(plan.ent_sega)}", flush=True)

    tmp = tempfile.mkdtemp()
    prefix = os.path.join(tmp, "tiled")
    t0 = time.perf_counter()
    n_rows = tp.stream_pairwise_tsv(
        index, prefix, panel=args.panel,
        engine="xla" if args.cpu else "auto",
        min_shared=args.min_shared, echo_progress=True,
        cache_bytes=(2 << 30) if args.use_cache
        else (0 if args.no_cache else None),  # None = auto (one accelerator)
        plan=plan,
    )
    t_stream = time.perf_counter() - t0
    print(f"tiled pairwise:   {t_stream:8.3f}s  rows={n_rows} "
          f"({pair_updates / t_stream / 1e9:.2f}G pair-updates/s incl. "
          f"plan+pack+stream)", flush=True)

    if args.validate:
        v = args.validate
        # restrict the color CSR to members < v and recompute with numpy
        off, mem, w = (index.color_offsets, index.color_members,
                       index.color_counts)
        degs = np.diff(off)
        cidx = np.repeat(np.arange(len(degs)), degs)
        mask = np.asarray(mem) < v
        sub_cnt = np.bincount(cidx[mask], minlength=len(degs))
        sub_off = np.zeros(len(degs) + 1, dtype=np.int64)
        np.cumsum(sub_cnt, out=sub_off[1:])
        ref = pw_ops.shared_kmer_matrix_numpy(
            sub_off, np.asarray(mem)[mask], w, v
        )
        got = np.zeros((v, v), dtype=np.int64)
        with open(prefix + "_kSpider_pairwise.tsv") as f:
            next(f)
            for line in f:
                parts = line.split("\t", 3)
                a, b = int(parts[0]) - 1, int(parts[1]) - 1
                if a < v and b < v:
                    got[a, b] = got[b, a] = int(parts[2])
        ref[ref < args.min_shared] = 0
        assert np.array_equal(got, ref), "validation mismatch"
        print(f"validated first {v} samples against numpy: OK", flush=True)

    size = os.path.getsize(prefix + "_kSpider_pairwise.tsv")
    print(f"samples={args.samples} tsv_rows={n_rows} tsv_bytes={size}")
    print(f"pair_updates={pair_updates} "
          f"throughput={pair_updates / t_stream / 1e9:.2f}G/s")

    if args.cutoffs:
        # close the pipeline loop at scale: cluster + export on the
        # streamed TSV.  Needs namesMap + seqToKmersNo alongside the TSV.
        from kspider_tpu.core import cluster as cluster_core
        from kspider_tpu.models import export as export_model

        with open(prefix + ".namesMap", "w") as f:
            f.write(f"{len(names)}\n")
            for i, name in enumerate(names, start=1):
                f.write(f"{i} {name}\n")
        core_pairwise.write_seq_to_kmers_tsv(prefix, index)
        for cutoff in (float(c) for c in args.cutoffs.split(",")):
            t0 = time.perf_counter()
            out = cluster_core.cluster_index(
                prefix, cutoff, use_device=not args.cpu
            )
            n_clusters = sum(1 for _ in open(out))
            print(f"cluster c={cutoff}: {time.perf_counter() - t0:8.3f}s  "
                  f"clusters={n_clusters}", flush=True)
        # the NxN distmat (and newick) are O(N^2) text by definition —
        # only produce them at N where that is sane
        with_distmat = args.samples <= 16384
        t0 = time.perf_counter()
        export_model.export_pairwise(
            prefix, newick=args.newick and with_distmat,
            distmat=with_distmat,
        )
        print(f"export:           {time.perf_counter() - t0:8.3f}s  "
              f"(labeled TSV"
              f"{f' + distmat {args.samples}x{args.samples}' if with_distmat else ''}"
              f"{' + newick' if args.newick and with_distmat else ''})",
              flush=True)

    print("OK")


if __name__ == "__main__":
    main()

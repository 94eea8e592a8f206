"""FASTA-path end-to-end scale benchmark: sketch -> index -> pairwise.

The reference's primary user flow starts at FASTA
(/root/reference/src/fastx_to_kf.cpp:16-100) and spends most user
wall-time in the per-k-mer hash/insert sketch loop.  Every other scale
benchmark here (tiled_scale, e2e_scale) injects synthetic postings
downstream of sketching; this one measures the ingest stage itself:

  1. generate a synthetic genome collection (families sharing a core
     sequence, per-sample point mutations) as .fa files;
  2. sketch every file (native streaming sketcher, thread pool over
     files — ctypes releases the GIL, mirroring the reference's OpenMP
     file-level parallelism in sigs_to_bins.cpp:107-110), reporting
     k-mers hashed/s and files/s;
  3. index the sketches and run pairwise + one cluster cutoff.

Usage:
  python benchmarks/fasta_scale.py [--files 1000] [--genome-len 20000]
         [--families 50] [--scale 10] [-k 21] [--threads N] [--cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_genomes(out_dir, n_files, genome_len, n_families, rng, line_width=80):
    """Write n_files FASTA genomes; families share a mutated core."""
    fam_cores = [
        rng.integers(0, 4, size=genome_len).astype(np.uint8)
        for _ in range(n_families)
    ]
    paths = []
    for i in range(n_files):
        fam = i % n_families
        g = fam_cores[fam].copy()
        # ~1% point mutations per sample + a private tail
        n_mut = max(1, genome_len // 100)
        pos = rng.integers(0, genome_len, size=n_mut)
        g[pos] = (g[pos] + rng.integers(1, 4, size=n_mut)) % 4
        tail = rng.integers(0, 4, size=genome_len // 20).astype(np.uint8)
        seq = BASES[np.concatenate([g, tail])].tobytes().decode()
        path = os.path.join(out_dir, f"g{fam:03d}_s{i:05d}.fa")
        with open(path, "w") as f:
            f.write(f">g{fam:03d}_s{i:05d}\n")
            for j in range(0, len(seq), line_width):
                f.write(seq[j : j + line_width] + "\n")
        paths.append(path)
    return paths


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=1000)
    ap.add_argument("--genome-len", type=int, default=20000, dest="glen")
    ap.add_argument("--families", type=int, default=50)
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("-k", "--ksize", type=int, default=21)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--min-shared", type=int, default=1)
    ap.add_argument("--keep", type=str, default=None,
                    help="keep working dir at this path (default: tmp, "
                         "deleted); an existing dir with the right file "
                         "count is reused without regeneration")
    ap.add_argument("--sketch-only", action="store_true",
                    help="stop after the sketch stage (thread sweeps)")
    args = ap.parse_args()

    import jax

    from kspider_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from kspider_tpu.core import cluster as core_cluster
    from kspider_tpu.core import pairwise as core_pairwise
    from kspider_tpu.core import sketch as core_sketch
    from kspider_tpu.core.index import build_index_from_hash_sets
    from kspider_tpu.io import native

    work = args.keep or tempfile.mkdtemp(prefix="fasta_scale_")
    fa_dir = os.path.join(work, "fa")
    os.makedirs(fa_dir, exist_ok=True)
    rng = np.random.default_rng(23)

    t0 = time.perf_counter()
    existing = sorted(
        os.path.join(fa_dir, f) for f in os.listdir(fa_dir)
        if f.endswith(".fa")
    )
    if args.keep and len(existing) == args.files:
        paths = existing
        gen_note = "reused"
    else:
        paths = make_genomes(fa_dir, args.files, args.glen, args.families,
                             rng)
        gen_note = "generated"
    total_bases = sum(os.path.getsize(p) for p in paths)
    print(f"dataset gen:      {time.perf_counter() - t0:8.3f}s "
          f"({args.files} files, {total_bases / 1e6:.0f}MB, {gen_note})",
          flush=True)
    print(f"native sketcher available: {native.available()}", flush=True)

    t0 = time.perf_counter()

    def sk(path):
        return core_sketch.sketch_single_end(path, args.ksize, args.scale)

    with ThreadPoolExecutor(max_workers=args.threads) as ex:
        results = list(ex.map(sk, paths))
    t_sketch = time.perf_counter() - t0
    total_kmers = sum(r.total_kmers for r in results)
    total_kept = sum(len(r.hashes) for r in results)
    print(f"sketch ({args.threads} threads): {t_sketch:8.3f}s  "
          f"{total_kmers / t_sketch / 1e6:6.1f}M kmers hashed/s  "
          f"{args.files / t_sketch:6.1f} files/s  "
          f"(kept {total_kept} of {total_kmers})", flush=True)

    if args.sketch_only:
        print("OK (sketch-only)")
        return

    names = [os.path.basename(p)[:-3] for p in paths]
    t0 = time.perf_counter()
    index = build_index_from_hash_sets(
        names, [r.hashes for r in results], ksize=args.ksize
    )
    t_index = time.perf_counter() - t0
    print(f"index build:      {t_index:8.3f}s  colors={index.num_colors}",
          flush=True)

    from kspider_tpu.io import artifacts as artifacts_io

    prefix = os.path.join(work, "fasta")
    t0 = time.perf_counter()
    artifacts_io.write_index_artifacts(prefix, index)
    t_art = time.perf_counter() - t0
    print(f"artifact write:   {t_art:8.3f}s", flush=True)

    t0 = time.perf_counter()
    core_pairwise.run_pairwise(
        prefix, index=index, use_device=not args.cpu, echo_timers=False,
        min_shared=args.min_shared,
    )
    with open(prefix + "_kSpider_pairwise.tsv") as f:
        n_rows = sum(1 for _ in f) - 1
    t_pw = time.perf_counter() - t0
    print(f"pairwise:         {t_pw:8.3f}s  rows={n_rows}", flush=True)

    t0 = time.perf_counter()
    out = core_cluster.cluster_index(prefix, 0.55, use_device=not args.cpu)
    with open(out) as f:
        n_clusters = sum(1 for _ in f)
    print(f"cluster c=0.55:   {time.perf_counter() - t0:8.3f}s  "
          f"clusters={n_clusters} (families={args.families})", flush=True)

    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()

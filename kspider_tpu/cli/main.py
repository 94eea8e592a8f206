"""All CLI commands.

Command surface and option names mirror the reference
(/root/reference/pykSpider/kSpider2/): sketch, index, pairwise, cluster,
export, hidden index_kmers/index_skipmers/index_protein, plus ``tools``
subcommands covering the reference's standalone executables
(/root/reference/CMakeLists.txt:49-74).
"""

import contextlib
import os
from glob import glob

import numpy as np

from kspider_tpu.cli.context import (
    UsageError,
    cli,
    existing_path,
    float_range,
    int_range,
    opt,
)


# ---------------------------------------------------------------------------
# sketch
# ---------------------------------------------------------------------------

@cli.command(
    "sketch",
    opt("-c", "--chunk-size", dest="chunk_size", type=int, default=3000, help="chunk size"),
    opt("-k", "--kmer-size", dest="ksize", required=True, type=int_range(7, 31), help="kmer size"),
    opt("--fastx", dest="fastx_path", type=existing_path, help="FASTX file path, works with interleaved paired-end and protein"),
    opt("--r1", dest="r1", type=existing_path, help="paired-end FASTX R1 file"),
    opt("--r2", dest="r2", type=existing_path, help="paired-end FASTX R2 file"),
    opt("--protein", dest="protein", action="store_true", help="parsing protein"),
    opt("--singletones", dest="singletons", action="store_true", help="remove singletones"),
    opt("--dayhoff", dest="dayhoff", action="store_true", help="parsing protein in dayhoff encoding"),
    opt("-s", "--scale", dest="scale", type=int, default=1, help="Downsampling ratio"),
    opt("--hasher", dest="hasher", default="sourmash", choices=["sourmash", "integer", "murmur_int"], help="k-mer hashing convention (default: sourmash)"),
    opt("-o", "--output", dest="output", default=None, help="output prefix (default: derived from input basename)"),
    opt("--format", dest="out_format", default="bin", choices=["bin", "sig"], help="sketch output format (default: bin)"),
    help_priority=1,
)
def sketch(log, fastx_path, r1, r2, chunk_size, ksize, protein, dayhoff, scale, singletons, hasher, output, out_format):
    """Sketch a FASTA/Q file into a hash set (.bin) or sourmash-style .sig."""
    from kspider_tpu.core import sketch as sketch_core
    from kspider_tpu.io import phmap as phmap_io
    from kspider_tpu.io import sigs as sigs_io

    if protein and (r1 or r2):
        log.ERROR("Protein can't be paired-end.")
    if fastx_path and (r1 or r2):
        log.ERROR("You can use either --fastx or --r1 --r2.")
    if not fastx_path and not (r1 and r2):
        log.ERROR("You need to provide --r1 --r2.")
    if protein and dayhoff:
        log.ERROR("You can use either --protein or --dayhoff")
    if scale > 100:
        log.WARNING("Deep downsampling (scale > 100); consider whether a sparser sketch still covers your genomes.")

    if r1 and r2:
        log.INFO("Processing paired-end reads.")
        res = sketch_core.sketch_paired_end(r1, r2, ksize, scale=scale, hasher=hasher, remove_singletons=singletons)
        base = output or sketch_core.paired_end_basename(r1)
    elif protein or dayhoff:
        log.INFO(f"Processing protein in {'dayhoff' if dayhoff else 'default'} mode.")
        res = sketch_core.sketch_protein(fastx_path, ksize, dayhoff=dayhoff, scale=scale)
        base = output or os.path.basename(fastx_path)
    else:
        log.INFO("Processing single-end reads.")
        res = sketch_core.sketch_single_end(fastx_path, ksize, scale=scale, hasher=hasher, remove_singletons=singletons)
        base = output or os.path.basename(fastx_path)

    out_dir = os.path.dirname(base)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if out_format == "sig":
        out_path = base + ".sig"
        sigs_io.write_sig(out_path, base, res.hashes.tolist(), ksize, scaled=scale)
    else:
        out_path = base + ".bin"
        phmap_io.write_hash_set(out_path, res.hashes)
    print(f"filename({base}): total({res.total_kmers}) inserted({res.inserted_kmers}) unique({len(res.hashes)})")
    log.SUCCESS("File(s) has been sketched.")


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------

@cli.command(
    "index",
    opt("--dir", dest="sketches_dir", required=True, help="Sketches directory (must contain only the sketches)"),
    opt("-k", "--kmer-size", dest="ksize", default=0, type=int, help="kmer size (required for --sourmash and --bins)"),
    opt("--sourmash", dest="sourmash", action="store_true", help="index sourmash signature (.sig) files"),
    opt("--bins", dest="bins", action="store_true", help="index .bin hash-set files"),
    opt("-o", "--output", dest="output_prefix", default=None, help="index output prefix (default: directory basename, in CWD)"),
    opt("--device-build", dest="device_build", action="store_true", help="run the postings sort/dedup/singleton filter on the accelerator (ops/device_build.py); the artifacts are identical to the host build"),
    help_priority=2,
)
def index(log, sketches_dir, sourmash, bins, ksize, output_prefix, device_build):
    """Index all sketches in a directory."""
    from kspider_tpu.core import dataset

    if not os.path.exists(sketches_dir):
        log.ERROR(f"{sketches_dir} does not exist!")

    if sourmash:
        if not ksize:
            log.ERROR("must select kSize when using --sourmash")
        log.INFO(f"Indexing sourmash sigs in {sketches_dir} with kSize={ksize}.")
        dataset.index_sigs_dir(sketches_dir, ksize, output_prefix=output_prefix, logger=log, device_build=device_build)
        log.SUCCESS("DONE!")
        return

    has_bins = bool(glob(f"{sketches_dir}/*.bin"))
    if bins or has_bins:
        if not ksize:
            log.ERROR("must select kSize when indexing .bin sketches")
        log.INFO(f"Indexing bins in {sketches_dir}.")
        dataset.index_bins_dir(sketches_dir, ksize, output_prefix=output_prefix, logger=log, device_build=device_build)
        log.SUCCESS("DONE!")
        return

    # reference consistency check for the kProcessor sketch path
    all_extra = glob(f"{sketches_dir}/*extra")
    all_phmap = glob(f"{sketches_dir}/*phmap")
    all_mqf = glob(f"{sketches_dir}/*mqf")
    if len(all_extra) != (len(all_phmap) + len(all_mqf)):
        log.ERROR("Inconsistent sketches files.")
    if not all_phmap and not all_mqf:
        log.ERROR(
            f"no sketches found in {sketches_dir}; expected .sig, .bin, or "
            ".phmap files"
        )
    log.INFO(f"Indexing sketches in {sketches_dir}.")
    try:
        dataset.index_kf_dir(sketches_dir, output_prefix=output_prefix, logger=log, device_build=device_build)
    except ValueError as e:
        log.ERROR(str(e))
    log.SUCCESS("DONE!")


# ---------------------------------------------------------------------------
# hidden FASTA index commands
# ---------------------------------------------------------------------------

@cli.command(
    "index_kmers",
    opt("-f", "--fasta", dest="fasta_file", required=True, type=existing_path, help="FASTA file"),
    opt("-n", "--names", dest="names_file", required=True, type=existing_path, help="Names file"),
    opt("-k", "--kmer-size", dest="ksize", required=True, type=int_range(7, 31), help="kmer size"),
    opt("-c", "--chunk-size", dest="chunk_size", type=int, default=3000, help="chunk size"),
    opt("--strand-specific", dest="strand_specific", action="store_true"),
    opt("-o", "--output", dest="output_prefix", default=None, help="index output file prefix"),
    help_priority=1, hidden=True,
)
def index_kmers(log, fasta_file, names_file, ksize, output_prefix, chunk_size, strand_specific):
    """FASTA file indexing by Kmers."""
    from kspider_tpu.core import fasta_index

    _validate_names(log, names_file)
    if not output_prefix:
        output_prefix = "idx_" + os.path.splitext(os.path.basename(fasta_file))[0]
    log.INFO("Indexing has begun, please wait ....")
    fasta_index.index_fasta(
        fasta_file, names_file, ksize, output_prefix,
        mode="kmers", canonical=not strand_specific, logger=log,
    )
    log.SUCCESS("Indexing has completed.")


@cli.command(
    "index_skipmers",
    opt("-f", "--fasta", dest="fasta_file", required=True, type=existing_path, help="FASTA file"),
    opt("-n", "--names", dest="names_file", required=True, type=existing_path, help="Names file"),
    opt("-k", "--kmer-size", dest="ksize", required=True, type=int, help="kmer size"),
    opt("-m", "--cycle-bases", dest="skip_m", required=True, type=int, help="used bases per cycle"),
    opt("--cycle-length", dest="skip_n", required=True, type=int, help="cycle length"),
    opt("-c", "--chunk-size", dest="chunk_size", type=int, default=3000, help="chunk size"),
    opt("-o", "--output", dest="output_prefix", default=None, help="index output file prefix"),
    help_priority=2, hidden=True,
)
def index_skipmers(log, fasta_file, names_file, ksize, skip_m, skip_n, chunk_size, output_prefix):
    """FASTA file indexing by Skipmers."""
    from kspider_tpu.core import fasta_index

    _validate_names(log, names_file)
    if skip_n < 1 or skip_n < skip_m or ksize < skip_m or ksize % skip_m != 0:
        raise UsageError(
            "Invalid skip-mer shape!\nConditions: 0 < m <= n < k & k must be multiple of m"
        )
    if not output_prefix:
        output_prefix = "idx_" + os.path.splitext(os.path.basename(fasta_file))[0]
    log.INFO("Indexing has begun, please wait ....")
    fasta_index.index_fasta(
        fasta_file, names_file, ksize, output_prefix,
        mode="skipmers", skip_m=skip_m, skip_n=skip_n, logger=log,
    )
    log.SUCCESS("Indexing has completed.")


@cli.command(
    "index_protein",
    opt("-f", "--fasta", dest="fasta_file", required=True, type=existing_path, help="FASTA file"),
    opt("-n", "--names", dest="names_file", required=True, type=existing_path, help="Names file"),
    opt("-k", "--kmer-size", dest="ksize", required=True, type=int_range(7, 31), help="kmer size"),
    opt("-c", "--chunk-size", dest="chunk_size", type=int, default=3000, help="chunk size"),
    opt("--dayhoff", dest="dayhoff", action="store_true", help="use Dayhoff encoding"),
    opt("-o", "--output", dest="output_prefix", default=None, help="index output file prefix"),
    help_priority=3, hidden=True,
)
def index_protein(log, fasta_file, names_file, ksize, output_prefix, chunk_size, dayhoff):
    """FASTA file indexing by Protein.

    Note: the reference routes both --dayhoff and default to the dayhoff
    indexer (bug at /root/reference/pykSpider/kSpider2/ks_index.py:108-113);
    here the flag selects the encoding correctly."""
    from kspider_tpu.core import fasta_index

    _validate_names(log, names_file)
    if not output_prefix:
        output_prefix = "idx_" + os.path.splitext(os.path.basename(fasta_file))[0]
    log.INFO("Indexing has begun, please wait ....")
    fasta_index.index_fasta(
        fasta_file, names_file, ksize, output_prefix,
        mode="protein", dayhoff=dayhoff, logger=log,
    )
    log.SUCCESS("Indexing has completed.")


def _validate_names(log, names_file):
    log.INFO("validating names file..")
    with open(names_file) as names:
        for i, line in enumerate(names, 1):
            if len(line.strip().split("\t")) != 2:
                log.ERROR(f"invalid names line detected at L{i}: '{line.strip()}'")


# ---------------------------------------------------------------------------
# pairwise
# ---------------------------------------------------------------------------

@cli.command(
    "pairwise",
    opt("-i", "--index-prefix", dest="index_prefix", required=True, help="Index file prefix"),
    opt("--estimate-ani", dest="ani", action="store_true", help="estimate ANI and write result in a new file with single column"),
    opt("-t", "--threads", dest="user_threads", default=1, type=int, help="number of cores (accepted for compatibility; the device engine ignores it)"),
    opt("-s", "--scale", dest="sourmash_scale", default=0, type=int, help="scale used in creating sourmash sigs (only when using --estimate-ani)"),
    opt("--cpu", dest="force_cpu", action="store_true", help="use the host (numpy) engine instead of the device"),
    opt("--engine", dest="engine", default="auto", choices=["auto", "bitmask", "scatter", "tiled"], help="co-occurrence engine (default: auto, the rule in ops/pairwise.choose_engine; tiled = panel-streamed, any N)"),
    opt("--panel", dest="panel", default=4096, type=int, help="sample-panel width for the tiled engine (default: 4096)"),
    opt("--min-shared", dest="min_shared", default=1, type=int, help="emit only pairs with at least this many shared k-mers (all engines; default: 1)"),
    opt("--device-pack", dest="device_pack", default=None, choices=["auto", "force", "off"], help="ship sparse panel sides as posting keys and build the bitmask on device (default: env KSPIDER_DEVICE_PACK or auto)"),
    opt("--coordinator", dest="coordinator", default=None, help="jax.distributed coordinator address (host:port) for multi-process runs; or env KSPIDER_COORDINATOR"),
    opt("--num-processes", dest="num_processes", default=None, type=int, help="total coordinated processes, one per card; or env KSPIDER_NUM_PROCESSES"),
    opt("--process-id", dest="process_id", default=None, type=int, help="this process's id in [0, num-processes); it takes card KSPIDER_LOCAL_RANK of its host if set, else id modulo the cards in CUDA_VISIBLE_DEVICES if set, else card id; or env KSPIDER_PROCESS_ID"),
    help_priority=3,
)
def pairwise(log, index_prefix, user_threads, ani, sourmash_scale, force_cpu, engine, panel, min_shared, device_pack, coordinator, num_processes, process_id):
    """Generate containment pairwise matrix."""
    with _scoped_env("KSPIDER_DEVICE_PACK", device_pack):
        _pairwise(log, index_prefix, user_threads, ani, sourmash_scale, force_cpu, engine, panel, min_shared, coordinator, num_processes, process_id)


@contextlib.contextmanager
def _scoped_env(name, value):
    """Set an environment variable for one command, so the flag doesn't
    leak into later in-process runs (tests, library embedders)."""
    if value is None:
        yield
        return
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def _pairwise(log, index_prefix, user_threads, ani, sourmash_scale, force_cpu, engine, panel, min_shared, coordinator, num_processes, process_id):
    from kspider_tpu.core import pairwise as core_pairwise
    from kspider_tpu.models import ani as ani_model
    from kspider_tpu.parallel import multiprocess as mp

    _, n_procs, _ = mp.resolve_flags(coordinator, num_processes, process_id)
    if not ani:
        if n_procs > 1:
            log.INFO(
                f"Constructing the containment pairwise matrix across "
                f"{n_procs} coordinated processes."
            )
            mp.run_multiprocess_pairwise(
                index_prefix, use_device=not force_cpu, engine=engine,
                panel=panel, min_shared=min_shared,
                coordinator=coordinator, num_processes=num_processes,
                process_id=process_id,
            )
            log.SUCCESS("Done.")
            return
        log.INFO("Constructing the containment pairwise matrix.")
        if sourmash_scale:
            log.WARNING("No need to provide -s/--scale when running this command.")
        core_pairwise.run_pairwise(
            index_prefix, use_device=not force_cpu, engine=engine,
            panel=panel, min_shared=min_shared,
        )
        log.SUCCESS("Done.")
        return

    pairwise_file = index_prefix + "_kSpider_pairwise.tsv"
    if not os.path.exists(pairwise_file):
        log.ERROR("Please, run the same command without --estimate-ani first, then run this command.")
    log.INFO("Estimating the ANI. This might take some time if the data is very large.")
    if user_threads > 1:
        # reference parity: ks_pairwise.py:40-41 warns that ANI estimation
        # is single-threaded
        log.WARNING("sorry, current ANI estimation implementation does not allow multithreading")
    if not sourmash_scale:
        log.ERROR("estimating ANI requires to provide --scale value")
    with open(f"{index_prefix}.extra") as extra:
        ksize = int(next(extra))
    ani_model.write_ani_column(index_prefix, ksize, sourmash_scale, logger=log)
    log.SUCCESS("Done.")


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------

@cli.command(
    "cluster",
    opt("-c", "--cutoff", dest="cutoff", type=float_range(0, 1), default=0.0, help="cluster sequences with (containment > cutoff) (default: 0.0)"),
    opt("-i", "--index-prefix", dest="index_prefix", required=True, help="Index file prefix"),
    opt("-d", "--dist-type", dest="distance_type", default="max_cont", help="select from ['min_cont', 'avg_cont', 'max_cont', 'ani'] (default: max_cont)"),
    opt("--cpu", dest="force_cpu", action="store_true", help="use scipy connected-components instead of the device kernel"),
    opt("--from-index", dest="from_index", action="store_true", help="cluster straight from the index via the panel-streamed engine (no pairwise TSV round-trip; min/avg/max metrics only)"),
    opt("--panel", dest="panel", default=4096, type=int, help="sample-panel width (--from-index mode; default: 4096)"),
    opt("--min-shared", dest="min_shared", default=1, type=int, help="ignore pairs below this many shared k-mers (--from-index mode; default: 1)"),
    help_priority=4,
)
def cluster(log, index_prefix, cutoff, distance_type, force_cpu, from_index, panel, min_shared):
    """Sequence clustering."""
    from kspider_tpu.core import cluster as core_cluster

    if from_index:
        from kspider_tpu.io import artifacts, npz_index

        index = npz_index.load(index_prefix)
        if index is None:
            index = artifacts.load_index_artifacts(index_prefix)
        out = core_cluster.cluster_from_index(
            index, index_prefix, cutoff, dist_type=distance_type,
            use_device=not force_cpu, panel=panel, min_shared=min_shared,
            logger=log,
        )
        log.SUCCESS(f"Clusters written to {out}")
        return
    log.INFO("Building the main graph...")
    out = core_cluster.cluster_index(
        index_prefix, cutoff, dist_type=distance_type, use_device=not force_cpu, logger=log
    )
    log.SUCCESS(f"Clusters written to {out}")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

@cli.command(
    "export",
    opt("-i", "--index-prefix", dest="index_prefix", required=True, help="Index file prefix"),
    opt("--newick", dest="newick", action="store_true", help="Convert pairwise (containment) matrix to newick format"),
    opt("-d", "--dist-type", dest="distance_type", default="max_cont", help="select from ['min_cont', 'avg_cont', 'max_cont', 'ani'] (default: max_cont)"),
    opt("-o", dest="overwritten_output", default="na", help="custom output file name prefix"),
    opt("--no-distmat", dest="no_distmat", action="store_true", help="skip the NxN distance matrix (O(N^2); auto-skipped above 16384 samples)"),
    opt("--force-distmat", dest="force_distmat", action="store_true", help="build the NxN distance matrix even above the auto-gate threshold"),
    help_priority=5,
)
def export(log, index_prefix, newick, distance_type, overwritten_output, no_distmat, force_distmat):
    """Export kSpider pairwise to multiple formats."""
    from kspider_tpu.models import export as export_model

    if no_distmat and force_distmat:
        log.ERROR("--no-distmat and --force-distmat are mutually exclusive")
    out = None if overwritten_output == "na" else overwritten_output
    distmat = False if no_distmat else (True if force_distmat else None)
    export_model.export_pairwise(
        index_prefix, distance_type=distance_type, newick=newick,
        output_prefix=out, logger=log, distmat=distmat,
    )


# ---------------------------------------------------------------------------
# tools (the reference's standalone executables)
# ---------------------------------------------------------------------------

tools = cli.group(
    "tools", "Utility tools (sig/bin conversion, dumps, validation).",
    help_priority=6,
)


@tools.command(
    "sig_to_bin",
    opt("sig_path", type=existing_path),
    opt("ksize", type=int),
    opt("min_abundance", type=int),
    opt("output_path"),
)
def sig_to_bin(log, sig_path, ksize, min_abundance, output_path):
    """Convert one .sig to a .bin hash set, filtering abundance >= MIN
    (reference /root/reference/sig_to_bin.cpp:21-65)."""
    from kspider_tpu.io import phmap as phmap_io
    from kspider_tpu.io import sigs as sigs_io

    mins = sigs_io.load_sig_mins(
        sig_path, ksize, min_abundance=min_abundance, first_entry_only=True
    )
    hashes = mins if mins is not None else np.empty(0, dtype=np.uint64)
    print(f"inserted {len(hashes)} hashes.")
    phmap_io.write_hash_set(output_path, np.unique(hashes))


@tools.command(
    "sigs_to_bins",
    opt("sigs_dir", type=existing_path),
    opt("ksize", type=int),
    opt("output_dir"),
    opt("threads", type=int, default=1, nargs="?"),
)
def sigs_to_bins(log, sigs_dir, ksize, output_dir, threads):
    """Batch-convert a directory of sigs to bins; resumable (skips already
    converted outputs, reference /root/reference/sigs_to_bins.cpp:94-102)."""
    from concurrent.futures import ThreadPoolExecutor

    from kspider_tpu.io import phmap as phmap_io
    from kspider_tpu.io import sigs as sigs_io

    os.makedirs(output_dir, exist_ok=True)
    pass1, _ = sigs_io.scan_sigs_dir(sigs_dir)
    todo = []
    skipped = 0
    for p in pass1:
        base = sigs_io.sig_basename(p)
        out = os.path.join(output_dir, base + ".bin")
        if os.path.exists(out):
            skipped += 1
            continue
        todo.append((p, out))
    print(f"Skipped {skipped} files as they already converted to bins.")

    def convert(args):
        p, out = args
        mins = sigs_io.load_sig_mins(p, ksize, first_entry_only=True)
        hashes = mins if mins is not None else np.empty(0, dtype=np.uint64)
        phmap_io.write_hash_set(out, np.unique(hashes))

    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        list(ex.map(convert, todo))
    print("Process completed.")


@tools.command("dump_bin", opt("bin_path", type=existing_path))
def dump_bin(log, bin_path):
    """Print all hashes in a .bin (reference export_bin.cpp:17-32)."""
    from kspider_tpu.io import phmap as phmap_io

    for h in phmap_io.read_hash_set(bin_path):
        print(h)


@tools.command(
    "dump_sig", opt("sig_path", type=existing_path), opt("ksize", type=int)
)
def dump_sig(log, sig_path, ksize):
    """Print all hashes in a .sig at k (reference export_sig.cpp:21-53)."""
    from kspider_tpu.io import sigs as sigs_io

    mins = sigs_io.load_sig_mins(sig_path, ksize)
    if mins is not None:
        for h in mins:
            print(h)


@tools.command("check_bin", opt("bin_path", type=existing_path))
def check_bin(log, bin_path):
    """Validate a .bin loads; print VALID_BIN: <n> (reference check_bin.cpp)."""
    from kspider_tpu.io import phmap as phmap_io

    try:
        hashes = phmap_io.read_hash_set(bin_path)
    except Exception as e:  # malformed dump
        print(f"INVALID_BIN: {e}")
        raise SystemExit(1)
    print(f"VALID_BIN: {len(hashes)}")


@tools.command(
    "validate",
    opt("sig_path", type=existing_path),
    opt("bin_path", type=existing_path),
    opt("ksize", type=int),
)
def validate(log, sig_path, bin_path, ksize):
    """Shared-hash count between a sig and a bin (reference validate.cpp:21-64)."""
    from kspider_tpu.io import phmap as phmap_io
    from kspider_tpu.io import sigs as sigs_io

    mins = sigs_io.load_sig_mins(sig_path, ksize)
    bin_hashes = phmap_io.read_hash_set(bin_path)
    shared = 0
    if mins is not None:
        shared = len(np.intersect1d(np.unique(mins), bin_hashes))
    print(f"shared_hashes: {shared}")


@tools.command(
    "validate_bins",
    opt("bins_dir", type=existing_path),
    opt("-o", "--report", dest="report_path", default="validate_bins_report.txt", help="report file (default: validate_bins_report.txt)"),
)
def validate_bins(log, bins_dir, report_path):
    """Integrity-sweep every .bin in a directory; write a report
    (reference /root/reference/validate_bins.sh:1-20)."""
    from kspider_tpu.io import phmap as phmap_io

    ok, bad = 0, 0
    with open(report_path, "w") as report:
        for entry in sorted(os.listdir(bins_dir)):
            if not entry.endswith(".bin"):
                continue
            path = os.path.join(bins_dir, entry)
            try:
                hashes = phmap_io.read_hash_set(path)
                report.write(f"{entry}\tVALID_BIN: {len(hashes)}\n")
                ok += 1
            except Exception as e:
                report.write(f"{entry}\tINVALID_BIN: {e}\n")
                bad += 1
    print(f"checked {ok + bad} bins: {ok} valid, {bad} invalid -> {report_path}")
    if bad:
        raise SystemExit(1)


@tools.command(
    "dump_kmer_count", opt("fastx_path", type=existing_path), opt("ksize", type=int)
)
def dump_kmer_count(log, fastx_path, ksize):
    """Print per-k-mer occurrence counts of a FASTX file
    (capability of the reference's disabled apps/dump_kmer_count.cpp)."""
    from collections import Counter

    from kspider_tpu.core import hashing
    from kspider_tpu.io import fastx as fastx_io

    counts = Counter()
    for _, seq in fastx_io.read_records(fastx_path):
        counts.update(hashing.kmer_hashes_sourmash(seq, ksize).tolist())
    for h, c in sorted(counts.items()):
        print(f"{h}\t{c}")


@tools.command(
    "normalize",
    opt("--r1", dest="r1", type=existing_path, required=True),
    opt("--r2", dest="r2", type=existing_path),
    opt("-k", "--kmer-size", dest="ksize", required=True, type=int),
    opt("--percentile", dest="percentile", type=float, default=5.0, help="drop k-mers in the lowest count percentile (default: 5.0)"),
    opt("--max-kmers", dest="max_kmers", type=int, default=100_000_000, help="cap on retained k-mers (default: 100000000)"),
    opt("-o", "--output", dest="output", required=True, help="output .bin path"),
)
def normalize(log, r1, r2, ksize, percentile, max_kmers, output):
    """Count-normalize reads into a hash set: drop the lowest-percentile
    k-mers by count, cap the total (capability of the reference's disabled
    apps/normalize_pe.cpp — including fixing its infinite-loop bug)."""
    from collections import Counter

    import numpy as np

    from kspider_tpu.core import hashing
    from kspider_tpu.io import fastx as fastx_io
    from kspider_tpu.io import phmap as phmap_io

    counts = Counter()
    for path in filter(None, [r1, r2]):
        for _, seq in fastx_io.read_records(path):
            counts.update(hashing.kmer_hashes_sourmash(seq, ksize).tolist())
    if not counts:
        phmap_io.write_hash_set(output, np.empty(0, dtype=np.uint64))
        print("no kmers found")
        return
    hashes = np.fromiter(counts.keys(), dtype=np.uint64, count=len(counts))
    vals = np.fromiter(counts.values(), dtype=np.int64, count=len(counts))
    order = np.argsort(vals, kind="stable")
    cutoff_idx = int(np.ceil(len(vals) * percentile / 100.0))
    cutoff = vals[order[cutoff_idx]] if cutoff_idx < len(vals) else vals.max() + 1
    keep = hashes[vals >= cutoff]
    removed = len(hashes) - len(keep)
    keep = np.sort(keep)[:max_kmers]
    phmap_io.write_hash_set(output, keep)
    print(
        f"kept {len(keep)} kmers (removed {removed} below count {cutoff}, "
        f"cap {max_kmers})"
    )


@tools.command(
    "repr_sketches",
    opt("pairwise_tsv", type=existing_path),
    opt("--threshold", dest="threshold", default=0.20, type=float, help="avg containment threshold (default: 0.2)"),
)
def repr_sketches(log, pairwise_tsv, threshold):
    """Node degrees over edges with avg containment > threshold, sorted
    descending (reference apps/repr_sketches.cpp:27-43)."""
    from collections import Counter

    degrees = Counter()
    with open(pairwise_tsv) as f:
        next(f)
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if float(parts[4]) > threshold:
                degrees[int(parts[0])] += 1
                degrees[int(parts[1])] += 1
    for node, deg in sorted(degrees.items(), key=lambda kv: (-kv[1], kv[0])):
        print(f"{node}: {deg}")


def main(argv=None):
    cli.main(argv)


if __name__ == "__main__":
    main()

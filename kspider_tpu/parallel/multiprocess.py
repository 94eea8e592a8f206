"""Real multi-process (``jax.distributed``) pairwise execution.

The reference's only parallelism is a single-node OpenMP split of the
color range (/root/reference/src/pairwise.cpp:199-237).  This module is
its multi-process replacement: N coordinated processes, each owning one
card (or, on the CPU, one host process), compute a partial shared-k-mer
matrix and merge it with **one psum over the global device mesh** — gloo
collectives between CPU processes, NCCL between GPU processes; the
program is the same ``shard_map`` either way.

One process per card: each process is given one card of its host through
``jax.distributed.initialize(local_device_ids=[...])`` (see
:func:`local_device_id`).  Without that every process would open every
visible card and reserve most of its memory, and the second process
would fail to start.

Two partitioning axes, both exact:

- **color slices** (:func:`run_distributed_pairwise`): processes split an
  existing index's color classes into contiguous blocks; partial Gram
  matrices sum to the full matrix because every color contributes
  independently.  This is the CLI path (``kspider pairwise
  --num-processes/--process-id/--coordinator``), a drop-in multi-host
  upgrade of the reference's OpenMP loop over the same artifacts.
- **hash ranges** (:func:`distributed_pairwise_from_hash_sets`):
  processes split the u64 hash space during ingestion
  (``parallel/distributed.my_hash_range``); each builds a local
  ColorIndex from only its range's postings, so index build, color
  construction, and pairwise all scale with process count.  Partials sum
  because a hash's postings never straddle ranges.

Process 0 writes byte-identical ``_kSpider_pairwise.tsv`` /
``_kSpider_seqToKmersNo.tsv`` artifacts; a global barrier holds the
other processes until the files are on disk.
"""

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from kspider_tpu.parallel import distributed

ENV_COORDINATOR = "KSPIDER_COORDINATOR"
ENV_NUM_PROCESSES = "KSPIDER_NUM_PROCESSES"
ENV_PROCESS_ID = "KSPIDER_PROCESS_ID"
ENV_LOCAL_RANK = "KSPIDER_LOCAL_RANK"


def resolve_flags(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[Optional[str], int, Optional[int]]:
    """Merge CLI flags with the KSPIDER_* environment fallbacks."""
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR) or None
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    return coordinator, int(num_processes or 1), process_id


def local_device_id(process_id: int) -> int:
    """The card of its host that process ``process_id`` owns.

    ``KSPIDER_LOCAL_RANK`` names it outright (for hosts that run
    different numbers of processes); otherwise, where
    ``CUDA_VISIBLE_DEVICES`` lists the host's cards, processes take them
    in turn (``process_id`` modulo their number, so hosts that each run
    one process per visible card give their processes cards 0..k-1);
    otherwise the card is ``process_id`` itself, which fits one host
    running every process."""
    rank = os.environ.get(ENV_LOCAL_RANK)
    if rank:
        return int(rank)
    visible = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if c.strip()]
    return process_id % len(visible) if visible else process_id


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize ``jax.distributed`` from flags/env; no-op single-process.

    Returns ``(process_index, process_count)`` as jax sees them; a second
    call in the same process reuses the first initialization.  Process
    ``process_id`` owns card :func:`local_device_id` of its host; the CPU
    backend ignores the card choice.
    """
    import jax

    coordinator, num_processes, process_id = resolve_flags(
        coordinator, num_processes, process_id
    )
    if num_processes > 1 and not jax.distributed.is_initialized():
        # CPU backends need a cross-process collective implementation;
        # gloo ships with jaxlib.  GPU backends use NCCL.
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=[local_device_id(process_id)],
        )
    return jax.process_index(), jax.process_count()


#: int64 arrays are psum-merged as base-2^16 int32 limbs: exact for any
#: value < 2^63 on every backend (jax's default 32-bit mode would
#: silently truncate int64), and each limb's cross-process
#: sum stays < 2^16 * n_processes << 2^31.
_LIMB_BITS = 16
_N_LIMBS = 4


def psum_across_processes(local: np.ndarray) -> np.ndarray:
    """Sum a per-process host array across all processes with one psum
    over the global device mesh (exact: each process contributes its
    array once, padded with zeros on its extra local devices)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    local = np.asarray(local)
    if jax.process_count() == 1:
        return local.copy()

    is_i64 = local.dtype == np.int64
    if is_i64:
        if (local < 0).any():
            raise ValueError("int64 psum merge expects non-negative counts")
        limbs = np.empty((_N_LIMBS,) + local.shape, dtype=np.int32)
        v = local
        for l in range(_N_LIMBS):
            limbs[l] = (v & np.int64((1 << _LIMB_BITS) - 1)).astype(np.int32)
            v = v >> np.int64(_LIMB_BITS)
        if (v != 0).any():
            raise ValueError("value exceeds 64-bit limb decomposition")
        payload = limbs
    else:
        payload = local

    devices = jax.devices()
    n_local = len(jax.local_devices())
    mesh = Mesh(np.array(devices), ("p",))
    stack = np.zeros((n_local,) + payload.shape, dtype=payload.dtype)
    stack[0] = payload
    garr = multihost_utils.host_local_array_to_global_array(
        stack, mesh, P("p")
    )

    def _body(x):
        return jax.lax.psum(jnp.sum(x, axis=0), "p")

    merge = jax.jit(
        jax.shard_map(_body, mesh=mesh, in_specs=P("p"), out_specs=P())
    )
    out = np.asarray(jax.device_get(merge(garr)))
    if is_i64:
        total = np.zeros(local.shape, dtype=np.int64)
        for l in range(_N_LIMBS - 1, -1, -1):
            total = (total << np.int64(_LIMB_BITS)) + out[l].astype(np.int64)
        return total
    return out


def barrier(name: str = "kspider") -> None:
    """Block until every process reaches this point."""
    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() > 1:
        multihost_utils.sync_global_devices(name)


def color_slice(
    n_colors: int, process_id: int, num_processes: int
) -> Tuple[int, int]:
    """Contiguous [lo, hi) color-class block for one process (the
    multi-host analogue of the reference's static OpenMP range split,
    /root/reference/src/pairwise.cpp:204-208)."""
    base = n_colors // num_processes
    rem = n_colors % num_processes
    lo = process_id * base + min(process_id, rem)
    hi = lo + base + (1 if process_id < rem else 0)
    return lo, hi


def _local_partial_from_slice(
    index, lo: int, hi: int, use_device: bool, engine: str = "auto"
):
    """Partial shared matrix from a contiguous color-class slice."""
    from kspider_tpu.core.pairwise import compute_shared_matrix
    from kspider_tpu.core.index import ColorIndex

    off = index.color_offsets
    sub = ColorIndex(
        names=index.names,
        group_kmer_count=index.group_kmer_count,
        color_ids=index.color_ids[lo:hi],
        color_offsets=(off[lo : hi + 1] - off[lo]).astype(np.int64),
        color_members=index.color_members[off[lo] : off[hi]],
        color_counts=index.color_counts[lo:hi],
        ksize=index.ksize,
        hash_mode=index.hash_mode,
        slicing_mode=index.slicing_mode,
        params=index.params,
    )
    return compute_shared_matrix(sub, use_device=use_device, engine=engine)


def run_distributed_pairwise(
    prefix: str,
    index=None,
    use_device: bool = True,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    echo_timers: bool = True,
    engine: str = "auto",
    min_shared: int = 1,
) -> Optional[np.ndarray]:
    """Color-sliced multi-process pairwise over an existing index.

    Every process loads the same artifacts, computes the Gram partial of
    its color block, and the partials are psum-merged; process 0 emits
    the reference-exact TSVs.  Returns the full matrix on every process.

    The merge is dense (each process holds the full NxN int64 partial),
    so ``engine`` must be a dense variant — the panel-streamed ``tiled``
    engine's sparse COO output cannot ride the exact psum merge and is
    rejected here; its scaling story is the single-process streamed path.
    """
    import time

    from kspider_tpu.core import pairwise as core_pairwise
    from kspider_tpu.io import artifacts

    if engine == "tiled":
        raise ValueError(
            "the panel-streamed 'tiled' engine is single-process only; "
            "multi-process pairwise merges dense partials "
            "(use --engine auto/bitmask/scatter, or drop "
            "--num-processes to stream)"
        )

    pid, nproc = initialize(coordinator, num_processes, process_id)
    if echo_timers:
        import jax

        print(f"process {pid}/{nproc}: local devices "
              f"{[d.id for d in jax.local_devices()]}")
    t0 = time.perf_counter()
    if index is None:
        from kspider_tpu.io import npz_index

        index = npz_index.load(prefix)
        if index is None:
            index = artifacts.load_index_artifacts(prefix)
    if echo_timers and pid == 0:
        print(f"mapping colors to groups: {time.perf_counter() - t0:.6g} secs")

    t0 = time.perf_counter()
    lo, hi = color_slice(index.num_colors, pid, nproc)
    partial = _local_partial_from_slice(index, lo, hi, use_device, engine)
    merged = psum_across_processes(partial)
    if echo_timers and pid == 0:
        print(
            f"pairwise matrix construction: {time.perf_counter() - t0:.6g} secs"
        )

    if pid == 0:
        core_pairwise.write_seq_to_kmers_tsv(prefix, index)
        core_pairwise.write_pairwise_tsv(
            prefix, index, merged, min_shared=min_shared
        )
    barrier("pairwise-tsv")
    return merged


def assign_panel_rows(work: np.ndarray, num_processes: int) -> np.ndarray:
    """Deterministic greedy balanced assignment of panel rows to
    processes: rows in descending work order go to the least-loaded
    process (ties by process id).  Every process computes the same
    assignment from the same plan, so no coordination is needed."""
    loads = np.zeros(num_processes, dtype=np.int64)
    owner = np.zeros(len(work), dtype=np.int64)
    for r in np.argsort(-np.asarray(work), kind="stable"):
        p = int(np.argmin(loads))  # argmin ties -> lowest id
        owner[r] = p
        loads[p] += int(work[r])
    return owner


def _part_path(prefix: str, pi: int) -> str:
    return f"{prefix}_kSpider_pairwise.row{pi:06d}.part"


def run_distributed_tiled_pairwise(
    prefix: str,
    index=None,
    panel: int = 4096,
    block: int = 1024,
    min_shared: int = 1,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    echo_timers: bool = True,
) -> int:
    """Multi-process panel-streamed pairwise (the 100K+-scale path).

    Panel rows partition the streamed TSV into disjoint contiguous
    blocks (ops/tiled_pairwise.filter_plan_rows), so each process
    computes whole panel rows — greedily load-balanced by pair-entry
    count — and writes one sorted part file per owned row.  Process 0
    concatenates the parts in row order into a TSV byte-identical to
    the single-process stream.  Requires a shared filesystem for the
    part files (the same requirement the artifact inputs already have).
    Returns the global pair-row count on every process.
    """
    import time

    from kspider_tpu.core import pairwise as core_pairwise
    from kspider_tpu.io import artifacts
    from kspider_tpu.ops import tiled_pairwise as tp

    pid, nproc = initialize(coordinator, num_processes, process_id)
    t0 = time.perf_counter()
    if index is None:
        from kspider_tpu.io import npz_index

        index = npz_index.load(prefix)
        if index is None:
            index = artifacts.load_index_artifacts(prefix)
    if echo_timers and pid == 0:
        print(f"mapping colors to groups: {time.perf_counter() - t0:.6g} secs")

    t0 = time.perf_counter()
    plan = tp.build_panel_plan(
        index.color_offsets, index.color_members, index.color_counts,
        index.num_groups, panel,
    )
    counts = np.where(index.group_kmer_count < 0, 0, index.group_kmer_count)
    owner = assign_panel_rows(tp.panel_row_work(plan), nproc)
    my_rows = np.flatnonzero(owner == pid)
    sub = tp.filter_plan_rows(plan, my_rows)
    # the part writer appends: process 0 clears ALL stale parts from any
    # crashed run (a previous run with a smaller --panel can leave rows
    # beyond this plan's n_panels), then everyone syncs before writing
    if pid == 0:
        import glob

        for part in glob.glob(f"{prefix}_kSpider_pairwise.row*.part"):
            os.remove(part)
    barrier("tiled-parts-clean")
    # explicit single-device engine: each process's rows are independent
    # by construction, so no panel pair needs a collective
    engine = "xla"

    total_local = 0
    current_row = -1
    buf_i: List[np.ndarray] = []
    buf_j: List[np.ndarray] = []
    buf_v: List[np.ndarray] = []

    def flush():
        nonlocal total_local
        if current_row < 0 or not buf_i:
            return
        gi = np.concatenate(buf_i)
        gj = np.concatenate(buf_j)
        sv = np.concatenate(buf_v)
        order = np.lexsort((gj, gi))
        core_pairwise.write_pairwise_rows_coo(
            _part_path(prefix, current_row),
            gi[order], gj[order], sv[order], counts, header=False,
        )
        total_local += len(gi)
        buf_i.clear()
        buf_j.clear()
        buf_v.clear()

    for pi, pj, gi, gj, vals in tp.iter_panel_pairs(
        sub, engine=engine, block=block, min_shared=min_shared, mesh=None,
    ):
        if pi != current_row:
            flush()
            current_row = pi
        buf_i.append(gi)
        buf_j.append(gj)
        buf_v.append(vals)
    flush()

    if pid == 0:
        core_pairwise.write_seq_to_kmers_tsv(prefix, index)
    barrier("tiled-parts")
    total = int(
        psum_across_processes(np.array([total_local], dtype=np.int64))[0]
    )
    if echo_timers and pid == 0:
        print(
            f"pairwise matrix construction: {time.perf_counter() - t0:.6g} secs"
        )

    if pid == 0:
        path = prefix + "_kSpider_pairwise.tsv"
        core_pairwise.write_pairwise_rows_coo(
            path,
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), counts, header=True,
        )
        with open(path, "ab") as out:
            for pi in range(plan.n_panels):
                part = _part_path(prefix, pi)
                if os.path.exists(part):
                    with open(part, "rb") as f:
                        while True:
                            chunk = f.read(1 << 24)
                            if not chunk:
                                break
                            out.write(chunk)
                    os.remove(part)
    barrier("tiled-tsv")
    return total


def run_multiprocess_pairwise(
    prefix: str,
    use_device: bool = True,
    engine: str = "auto",
    panel: int = 4096,
    min_shared: int = 1,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """CLI dispatcher: same engine auto rule as the single-process
    ``core.pairwise.run_pairwise`` — the panel-streamed path for
    ``--engine tiled`` or N above the auto threshold, the dense
    psum-merged path otherwise.  Initializes ``jax.distributed`` first:
    the rule asks the backend, which must not start before it."""
    from kspider_tpu.core.pairwise import resolve_engine
    from kspider_tpu.io import artifacts, npz_index

    initialize(coordinator, num_processes, process_id)
    index = npz_index.load(prefix)
    if index is None:
        index = artifacts.load_index_artifacts(prefix)
    if resolve_engine(engine, use_device, index.num_groups) == "tiled":
        run_distributed_tiled_pairwise(
            prefix, index=index, panel=panel,
            min_shared=min_shared, coordinator=coordinator,
            num_processes=num_processes, process_id=process_id,
        )
        return
    run_distributed_pairwise(
        prefix, index=index, use_device=use_device, engine=engine,
        coordinator=coordinator, num_processes=num_processes,
        process_id=process_id, min_shared=min_shared,
    )


def distributed_pairwise_from_hash_sets(
    names: Sequence[str],
    hash_arrays: Sequence[np.ndarray],
    prefix: str,
    ksize: int = 0,
    use_device: bool = False,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Hash-range-partitioned ingest + pairwise (the scaling path).

    Each process keeps only its ``my_hash_range`` slice of every sample's
    hashes, builds a **local** ColorIndex (sort/group cost divides by
    process count), computes its Gram partial, and one psum produces the
    exact global matrix; process 0 writes the TSVs.  The true per-group
    k-mer totals are threaded through so containments are exact.
    """
    from kspider_tpu.core import pairwise as core_pairwise
    from kspider_tpu.core.index import build_index_from_hash_sets

    pid, nproc = initialize(coordinator, num_processes, process_id)
    lo, hi = distributed.my_hash_range(pid, nproc)
    full_counts: List[Optional[int]] = [
        None if a is None else len(a) for a in hash_arrays
    ]
    sub = [
        None if a is None else distributed.filter_to_range(a, lo, hi)
        for a in hash_arrays
    ]
    local_index = build_index_from_hash_sets(
        list(names), sub, kmer_counts=full_counts, ksize=ksize,
        params=f"kSize:{ksize}",
    )
    partial = core_pairwise.compute_shared_matrix(local_index, use_device=use_device)
    merged = psum_across_processes(partial)
    if pid == 0:
        core_pairwise.write_seq_to_kmers_tsv(prefix, local_index)
        core_pairwise.write_pairwise_tsv(prefix, local_index, merged)
    barrier("pairwise-tsv")
    return merged

"""Measure the dense-vs-tiled multi-process crossover.

The multi-process dispatcher (parallel/multiprocess.run_multiprocess_
pairwise) reuses the single-process AUTO_TILED_THRESHOLD (16384) to pick
between:

- **dense**: each process computes a full NxN int64 partial and merges
  it with one psum of 4 x NxN int32 limbs over the global mesh — the
  collective payload grows quadratically (4GB at N=16384);
- **tiled**: each process streams whole panel rows to part files and
  process 0 concatenates — no NxN collective at all, but per-pair
  pack/dispatch overhead.

This script times both paths at several N with 2 coordinated CPU
processes (gloo) on the same synthetic family workload and prints a
table; the numbers justify (or move) the threshold.  Run:

    python benchmarks/mp_crossover.py [--sizes 2048,4096,8192] [--nproc 2]
"""

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WORKER = """
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from kspider_tpu.parallel import multiprocess as mp

mode, pid, nproc, port, prefix = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
)
coord = f"localhost:{{port}}"
if mode == "dense":
    mp.run_distributed_pairwise(
        prefix, use_device=False, coordinator=coord, num_processes=nproc,
        process_id=pid, echo_timers=False,
    )
else:
    mp.run_distributed_tiled_pairwise(
        prefix, use_device=False, panel=2048, block=1024,
        coordinator=coord, num_processes=nproc, process_id=pid,
        echo_timers=False,
    )
print("WORKER_OK", pid)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mode(tmp, mode, prefix, nproc):
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER.format(repo=REPO))
    port = free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, script, mode, str(pid), str(nproc), str(port),
             prefix],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=tmp,
        )
        for pid in range(nproc)
    ]
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=3600)
        if p.returncode != 0:
            raise RuntimeError(f"{mode} worker {pid}:\n{out.decode()}")
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="2048,4096,8192")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--hashes", type=int, default=1000)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from benchmarks.e2e_scale import make_dataset
    from kspider_tpu.core.index import build_index_from_hash_sets
    from kspider_tpu.io import artifacts as artifacts_io

    print(f"{'N':>7} {'dense (s)':>10} {'tiled (s)':>10} "
          f"{'psum payload':>13}")
    for n in (int(s) for s in args.sizes.split(",")):
        rng = np.random.default_rng(11)
        names, arrays = make_dataset(n, args.hashes, rng)
        index = build_index_from_hash_sets(names, arrays, ksize=21,
                                           params="kSize:21")
        tmp = tempfile.mkdtemp()
        prefix = os.path.join(tmp, "x")
        artifacts_io.write_index_artifacts(prefix, index)

        t_tiled = run_mode(tmp, "tiled", prefix, args.nproc)
        tiled_tsv = open(prefix + "_kSpider_pairwise.tsv", "rb").read()
        t_dense = run_mode(tmp, "dense", prefix, args.nproc)
        dense_tsv = open(prefix + "_kSpider_pairwise.tsv", "rb").read()
        assert dense_tsv == tiled_tsv, "dense/tiled TSV mismatch"
        payload = 4 * 4 * n * n / 1e9  # 4 int32 limb planes
        print(f"{n:>7} {t_dense:>10.1f} {t_tiled:>10.1f} "
              f"{payload:>11.1f}GB")


if __name__ == "__main__":
    main()

"""Device mesh construction for multi-device runs.

The reference's only parallelism is single-node OpenMP
(/root/reference/src/pairwise.cpp:202); this framework scales over a
``jax.sharding.Mesh`` of the local devices.  Axis convention:

- ``"shards"``: the color/hash-range data-parallel axis — color blocks are
  distributed over it and partial Gram matrices merged with one ``psum``.
  One axis fits cards joined all to all (NVLink within a host), and
  suffices while NxN fits one device; N-dimension tiling
  (ops/tiled_pairwise.py) rides on top for 100K-sample runs.

The mesh holds this process's devices only: in a multi-process run each
process computes over its own cards and the processes merge through
``parallel/multiprocess.psum_across_processes``.
"""

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

SHARD_AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None, axis: str = SHARD_AXIS) -> Mesh:
    devices = jax.local_devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))

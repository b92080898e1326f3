"""Batch-axis sharding helpers for the optimizer engines.

Device-mesh replacement for the reference's two remaining MPI protocols:

- MPI Fitch-Sankoff position sharding (src/usher-sampled/utils.cpp:113-481):
  positions are independent DP problems; sharding the position (lane) axis of
  the per-chunk leaf-mask tensor over a 1-D mesh runs each device on its own
  position slice with zero collectives -- the all-gather of results is the
  host transfer that already happens per chunk.
- MPI SPR move search distribution (src/matOptimize/optimize_tree.cpp:165-252):
  source nodes are independent scoring problems; sharding the source-batch
  axis of the move scorer replaces the leader's rate-based work distributor.

Both work by committing inputs with NamedShardings: jit then compiles an
SPMD program partitioned along the batch axis (XLA GSPMD), no shard_map
plumbing needed because the computations are element-independent along the
sharded axis.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def batch_mesh(n_devices: int | None = None, axis: str = "batch") -> Mesh:
    """A 1-D mesh over the first n_devices devices."""
    devs = jax.devices()
    if n_devices is None or n_devices <= 0:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), axis_names=(axis,))


def put_batch(mesh: Mesh, arr, axis_index: int, axis: str = "batch"):
    """Commit `arr` sharded along dimension `axis_index`."""
    spec = [None] * np.ndim(arr)
    spec[axis_index] = axis
    return jax.device_put(arr, NamedSharding(mesh, P(*spec)))


def put_replicated(mesh: Mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P()))

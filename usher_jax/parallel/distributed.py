"""Multi-host (DCN) scaffolding: jax.distributed entry + host-spanning mesh.

The reference distributes across nodes with MPI leader/follower protocols
(matOptimize work distribution src/matOptimize/optimize_tree.cpp:165-252,
usher-sampled placement src/usher-sampled/place_sample.cpp:591-662, FS
position scatter src/usher-sampled/utils.cpp:113-481).  The device-mesh
replacement needs no protocol code at all: `jax.distributed.initialize`
joins the processes, `jax.devices()` then spans every host, and the
existing mesh compositions work unchanged —

  - placement / SPR search: the batch axis shards across ALL devices
    (ops/interval.py shard_map; zero collectives, so the only DCN traffic
    is each host's own H2D),
  - whole-tree FS: the position axis shards across all devices
    (optimize/fitch.py position sharding),
  - tie-break argmin reductions ride XLA collectives (ICI within a host,
    DCN across hosts).

Activation is env-gated (the CLIs expose --distributed): set
  USHER_JAX_COORDINATOR   host:port of process 0 (jax convention)
  USHER_JAX_NUM_PROCESSES total process count
  USHER_JAX_PROCESS_ID    this process's id
or rely on jax.distributed's own auto-detection (SLURM / GKE / cloud pod
metadata) by leaving them unset.  Real N-host benchmarking requires pod
hardware; the degenerate 1-process path is covered by tests.
"""

from __future__ import annotations

import os
import sys


_initialized = False


def maybe_initialize(flag: bool = True) -> bool:
    """Initialize jax.distributed once (idempotent).  Returns True when the
    distributed runtime is live (including the degenerate 1-process case).
    """
    global _initialized
    if not flag:
        return False
    if _initialized:
        return True
    import jax
    kwargs = {}
    coord = os.environ.get("USHER_JAX_COORDINATOR")
    if coord:
        kwargs["coordinator_address"] = coord
        kwargs["num_processes"] = int(
            os.environ.get("USHER_JAX_NUM_PROCESSES", "1"))
        kwargs["process_id"] = int(
            os.environ.get("USHER_JAX_PROCESS_ID", "0"))
    try:
        try:
            jax.distributed.initialize(**kwargs)
        except ValueError:
            if kwargs:
                raise
            # no coordinator configured and no cluster auto-detection:
            # degenerate single-process init (self-coordinated)
            import socket
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            jax.distributed.initialize(
                coordinator_address=f"127.0.0.1:{port}",
                num_processes=1, process_id=0)
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise
    _initialized = True
    print(f"[distributed] process {jax.process_index()}/"
          f"{jax.process_count()}: {jax.local_device_count()} local / "
          f"{jax.device_count()} global devices", file=sys.stderr)
    return True


def global_batch_mesh(axis: str = "batch"):
    """1-D mesh over EVERY device of every process (the sample/source batch
    axis of the shard_map compositions; DCN carries only per-host H2D)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def is_leader() -> bool:
    """Output files are written by process 0 only (the reference's rank-0
    leader discipline)."""
    import jax
    return (not _initialized) or jax.process_index() == 0


def shadow_outputs(args, *attrs) -> None:
    """Follower processes in a multi-process run execute every (collective)
    computation but must not race the leader on output files: point the
    named path attributes of `args` into a throwaway directory (the
    reference's rank-0-writes discipline, usher_common.cpp leader-only
    output)."""
    import os
    import tempfile
    if is_leader():
        return
    import atexit
    import shutil
    shadow = tempfile.mkdtemp(prefix="usher_follower_")
    # followers still serialize their copies (they run the identical
    # program); the throwaway directory is removed at process exit so
    # repeated runs do not leak /tmp space
    atexit.register(shutil.rmtree, shadow, ignore_errors=True)
    for attr in attrs:
        val = getattr(args, attr, None)
        if val:
            setattr(args, attr,
                    os.path.join(shadow, os.path.basename(str(val))))


def fetch(x):
    """np.asarray for device arrays that may span processes.

    Single-process (and host numpy) inputs take the plain fast path; a
    multi-process global array that is not fully addressable is gathered
    with one collective (the moral equivalent of the reference's
    rank-0 result gathers, e.g. FS_gather_mut utils.cpp:354) so every
    process holds the full result — the replicated-host execution model
    all drivers here assume."""
    import numpy as np
    if isinstance(x, np.ndarray):
        return x
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))

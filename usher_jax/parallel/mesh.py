"""Multi-device sharded placement: the device-mesh replacement for the
reference's MPI leader/follower placement protocol
(/root/reference/src/usher-sampled/place_sample.cpp:591-662).

Design (SURVEY.md §2.4): instead of replicating the tree per MPI rank and
hand-distributing samples over request/response tags, the flat MAT's node
axis is sharded over the "model" mesh axis and the sample batch over the
"data" axis.  Scoring needs no cross-shard traffic at all (each (node-shard,
sample-shard) scores locally); the argmin + tie-break reduction over the node
axis is the only collective, and XLA inserts it from the sharding
annotations.  Parent path states are precomputed (one gather per tree
refresh) so the node shard is self-contained -- st and stp shard together.

Mesh axes:
  data   -- sample batch (the reference's work-distribution axis)
  model  -- tree node slots (the reference's replicated-tree axis, now sharded)
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.placement import score_with_stp


def auto_mesh_devices(want: int = -1) -> int:
    """Devices to shard placement over.  want >= 0 is taken as given (0 or
    1: no mesh); -1 (auto) means every device when the backend is an
    accelerator with more than one, and no mesh on the CPU."""
    if want != -1:
        return want
    nd = jax.device_count()
    return nd if nd > 1 and jax.default_backend() != "cpu" else 0


def make_mesh(n_devices: int | None = None, data: int | None = None) -> Mesh:
    """A 2-D (data, model) mesh over the first n_devices devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if data is None:
        # favor the node (model) axis: trees are large, batches modest
        data = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    model = n_devices // data
    dev_array = np.array(devs).reshape(data, model)
    return Mesh(dev_array, axis_names=("data", "model"))


def _placement_step(st, stp, ref, active, num_leaves, bfs_rank, is_leaf,
                    is_root_mask, g, E, miss):
    """Full placement step: score all nodes x all samples, then reduce to the
    per-sample best with the reference tie-break (usher_mapper.cpp:452-497).

    Returns (best_score [B], best_key [B], num_best [B]) where best_key packs
    (num_leaves, bfs_rank) of the winner; the host resolves the node.
    """
    score, num_common, node_num_mut = score_with_stp(
        st, stp, ref, active, g, E, miss)
    has_unique = num_common < node_num_mut[None, :]
    nc_pos = num_common > 0
    leaf = is_leaf[None, :]
    valid = (is_root_mask[None, :]
             | (leaf & nc_pos)
             | (~leaf & has_unique & nc_pos)
             | (~leaf & ~has_unique))
    valid = valid & active[None, :]

    big = jnp.int32(1 << 30)
    s = jnp.where(valid, score, big)
    best_score = jnp.min(s, axis=1)
    is_best = valid & (score == best_score[:, None])
    num_best = is_best.sum(axis=1, dtype=jnp.int32)
    neg = jnp.int32(-1)
    leaves_masked = jnp.where(is_best, num_leaves[None, :], neg)
    best_leaves = jnp.max(leaves_masked, axis=1)
    is_best2 = is_best & (num_leaves[None, :] == best_leaves[:, None])
    rank_masked = jnp.where(is_best2, bfs_rank[None, :], neg)
    best_rank = jnp.max(rank_masked, axis=1)
    return best_score, best_rank, num_best


def shard_flat_inputs(mesh: Mesh, st, stp, ref, active, num_leaves, bfs_rank,
                      is_leaf, is_root_mask, g, E, miss):
    """Place the flat-MAT arrays on the mesh: node axis on "model", sample
    batch on "data", reference row replicated."""
    node_sh = NamedSharding(mesh, P("model", None))
    node1_sh = NamedSharding(mesh, P("model"))
    rep_sh = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P("data", None))
    put = jax.device_put
    return (put(st, node_sh), put(stp, node_sh), put(ref, rep_sh),
            put(active, node1_sh), put(num_leaves, node1_sh),
            put(bfs_rank, node1_sh), put(is_leaf, node1_sh),
            put(is_root_mask, node1_sh),
            put(g, batch_sh), put(E, batch_sh), put(miss, batch_sh))


def sharded_placement_step(mesh: Mesh):
    """jit _placement_step with explicit output shardings on the mesh; the
    collectives (all-reduce min over the node axis) come from XLA."""
    out_sh = NamedSharding(mesh, P("data"))
    return jax.jit(_placement_step,
                   out_shardings=(out_sh, out_sh, out_sh))


def sharded_score_fn(mesh: Mesh):
    """jit the raw scorer with sharded outputs: score/num_common stay sharded
    (data, model) until the host pulls them; node_num_mut stays on "model".
    Used by PlacementEngine's mesh path (the follower-replica scoring of
    reference place_sample_follower.cpp:95-249, without the replicas)."""
    out = (NamedSharding(mesh, P("data", "model")),
           NamedSharding(mesh, P("data", "model")),
           NamedSharding(mesh, P("model")))
    return jax.jit(score_with_stp, out_shardings=out)


def sharded_sparse_score_fn(mesh: Mesh, k_slots: int):
    """Sparse (entry-column gather) scoring under the (data, model) mesh via
    shard_map: each device scores its node shard against its sample shard
    with the SAME scorer as single-device — so multi-device keeps the
    sparse-vs-dense advantage instead of falling back to the dense formula.
    stp ships precomputed (node shards are self-contained)."""
    from ..ops.placement_sparse import score_sparse_stp_T

    def body(st, stp, ref, pos, gval, kmiss):
        return score_sparse_stp_T(st, stp, ref, pos, gval, kmiss, k_slots)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("model", None), P("model", None), P(),
                  P("data", None), P("data", None), P("data", None)),
        out_specs=(P("model", "data"), P("model", "data"), P("model")))
    return jax.jit(f)

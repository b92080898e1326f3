"""Sparse placement scorer vs the dense one.

The sparse scorer (ops/placement_sparse.py) must be bit-identical to the
dense path (ops/placement.py score_batch) on any well-formed MAT + sample
batch, including ambiguous alleles, missing entries, lane padding, and
inactive slots.  Both are plain JAX, so the same code runs here and on the
GPU (where chip_smoke.py compares them at the bench headline shape).
"""

import numpy as np
import pytest

from usher_jax.core.flat import FlatMAT
from usher_jax.ops import placement as dev
from usher_jax.ops import placement_sparse as pp
from usher_jax.placement.driver import PlacementEngine

from test_placement import random_mat, random_sample


def _flat_from_seed(seed, n_leaves=20, n_positions=15):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=n_leaves, n_positions=n_positions)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    flat = FlatMAT(T, positions, refarr, "c")
    samples = [random_sample(rng, ref) for _ in range(5)]
    return T, flat, samples, rng


@pytest.mark.parametrize("seed", list(range(4)))
def test_sparse_matches_dense_kernel(seed):
    T, flat, samples, rng = _flat_from_seed(seed)
    st_dev, parent_dev = flat.sync()
    meta = flat.order_arrays()

    g, E, miss = flat.encode_samples(samples)
    score_d, nc_d, nnm_d = (np.asarray(x) for x in dev.score_batch(
        st_dev, parent_dev, flat.root_slot, np.asarray(flat.ref),
        meta["active"], g, E, miss))

    pos, gval, kmiss = pp.sparsify(samples, flat.pos_index, flat.P_pad)
    score_t, nc_t, nnm_s = pp.score_sparse_T(
        st_dev, parent_dev, flat.root_slot, np.asarray(flat.ref),
        pos, gval, kmiss, pos.shape[1])
    score_s = np.asarray(score_t).T
    nc_s = np.asarray(nc_t).T

    act = meta["active"]
    np.testing.assert_array_equal(np.asarray(nnm_s)[act], nnm_d[act])
    np.testing.assert_array_equal(score_s[:, act], score_d[:, act])
    np.testing.assert_array_equal(nc_s[:, act], nc_d[:, act])


@pytest.mark.parametrize("seed", [11, 12])
def test_sparse_fused_step_matches_dense_step(seed):
    T, flat, samples, rng = _flat_from_seed(seed)
    st_dev, parent_dev = flat.sync()
    meta = flat.order_arrays()

    g, E, miss = flat.encode_samples(samples)
    bs_d, slot_d, nb_d = (np.asarray(x) for x in dev.placement_step(
        st_dev, parent_dev, flat.root_slot, np.asarray(flat.ref),
        meta["active"], meta["is_leaf"], meta["is_root_mask"],
        meta["num_leaves"], meta["bfs_rank"], g, E, miss))

    pos, gval, kmiss = pp.sparsify(samples, flat.pos_index, flat.P_pad)
    bs_s, slot_s, nb_s = (np.asarray(x) for x in pp.placement_step_sparse(
        st_dev, parent_dev, flat.root_slot, np.asarray(flat.ref),
        meta["active"], meta["is_leaf"], meta["is_root_mask"],
        meta["num_leaves"], meta["bfs_rank"], pos, gval, kmiss,
        pos.shape[1]))

    np.testing.assert_array_equal(bs_s, bs_d)
    np.testing.assert_array_equal(slot_s, slot_d)
    np.testing.assert_array_equal(nb_s, nb_d)


def test_engine_backends_agree():
    """PlacementEngine with backend="sparse" produces the same SampleResults
    (winner, score, tie set) as backend="dense"."""
    T, flat, samples, rng = _flat_from_seed(99, n_leaves=30)
    eng_d = PlacementEngine(T, backend="dense")
    res_d = eng_d.score_samples(samples)
    eng_s = PlacementEngine(T, backend="sparse")
    res_s = eng_s.score_samples(samples)
    for rd, rs in zip(res_d, res_s):
        assert rd.best_score == rs.best_score
        assert rd.num_best == rs.num_best
        assert rd.best_node.identifier == rs.best_node.identifier
        assert ([n.identifier for n in rd.tied_nodes]
                == [n.identifier for n in rs.tied_nodes])
        assert rd.tied_has_unique == rs.tied_has_unique

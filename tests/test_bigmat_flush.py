"""Vectorized multi-child-insert flush == the sequential per-pending path.

_apply_child_run replaces k sequential O(N)-pass DFS updates with one
dominance-count pass; these tests pit it against the per-pending reference
implementation on randomized append batches (nested targets, repeated
targets, boundary-sharing chains) and check the full derived state.
"""

import numpy as np
import pytest

from usher_jax.core.bigmat import BigMAT

NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)


def random_big(rng, N=400, P=64):
    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    M = N - 1
    mut_ptr = np.arange(N + 1, dtype=np.int64) - 1
    mut_ptr[0] = 0
    mut_col = rng.integers(0, P, size=M).astype(np.int32)
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    mut_par = ref[mut_col].copy()
    mut_mut = NIBBLES[rng.integers(0, 4, size=M)]
    same = mut_par == mut_mut
    mut_mut[same] = NIBBLES[(np.searchsorted(NIBBLES, mut_mut[same]) + 1)
                            % 4]
    return BigMAT(parent, mut_ptr, mut_col, mut_par, mut_mut,
                  np.arange(P, dtype=np.int64), ref)


def snapshot(big):
    return {k: getattr(big, k).copy() for k in
            ("parent", "level", "dfs_of", "dfs_end_of", "dfs_order",
             "num_leaves", "child_key", "child_count", "base", "nc_base",
             "node_num_mut", "F", "is_leaf")}


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_child_run_matches_sequential(seed):
    rng = np.random.default_rng(seed)
    bigA = random_big(rng, N=400)
    rng2 = np.random.default_rng(seed)
    bigB = random_big(rng2, N=400)
    internals = np.nonzero(~bigA.is_leaf)[0]
    # repeated + nested targets, some with mutations
    targets = rng.choice(internals, size=48, replace=True)
    for t in targets:
        muts = []
        if rng.random() < 0.5:
            col = int(rng.integers(0, bigA.P))
            pv = int(bigA.ref[col])
            mv = int(NIBBLES[(np.searchsorted(NIBBLES, pv) + 1) % 4])
            muts = [(col, pv, mv)]
        bigA.queue_child_insert(int(t), muts)
        bigB.queue_child_insert(int(t), muts)
    bigA._flush()            # vectorized run path (len >= 2)
    # force B down the sequential path: one pending per flush
    for p in list(bigB._pending):
        bigB._pending = [p]
        bigB._flush()
    sa, sb = snapshot(bigA), snapshot(bigB)
    for kk in sa:
        np.testing.assert_array_equal(sa[kk], sb[kk], err_msg=kk)
    np.testing.assert_array_equal(bigA.bfs_rank, bigB.bfs_rank)
    # overlay identical (column-sorted stable)
    for a, b in zip(bigA._ov, bigB._ov):
        np.testing.assert_array_equal(a, b)


def test_chain_tree_appends_linear():
    """Depth-heavy chain tree: appends through the vectorized run keep
    exact DFS/leaf bookkeeping (the depth-quadratic host-walk concern)."""
    depth = 600
    parent = np.arange(-1, depth - 1, dtype=np.int32)
    parent[0] = 0
    mut_ptr = np.zeros(depth + 1, np.int64)
    big = BigMAT(parent, mut_ptr, np.zeros(0, np.int32),
                 np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                 np.arange(4, dtype=np.int64),
                 np.array([1, 2, 4, 8], np.uint8))
    for t in range(0, depth - 1, 7):
        big.queue_child_insert(t, [])
    big._flush()
    n_app = len(range(0, depth - 1, 7))
    assert big.N == depth + n_app
    # every chain node above an insert gained the inserted leaves
    gains = big.num_leaves[:depth] - 1
    expect = np.array([sum(1 for t in range(0, depth - 1, 7) if t >= i)
                       for i in range(depth)])
    np.testing.assert_array_equal(gains, expect)

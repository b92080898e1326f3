"""Segment-query placement kernel == full-matrix kernel, bit for bit.

interval_place_seg_dev answers the same tie-broken reduction as
interval_place_dev without materializing [n_pad, b_pad] matrices
(ops/interval.py, segment-query section).  These tests force both paths
through BigMAT.place_arrays (USHER_JAX_SEG toggle) on randomized trees,
batches with padding/ambiguity/missing entries, and incremental-append
overlays, asserting every output field equal — including num_best (the
count@min monoid is the part a classic overlapping sparse-table query
would get wrong) and the runner-up reduce.
"""

import os

import numpy as np
import pytest

from test_direct_exact import consistent_mat

NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)


def _toggle(big, pos, gval, kmiss, second):
    """Force both kernels regardless of the production default (the seg
    kernel is opt-in — gather-bound — but must stay bit-exact)."""
    old = os.environ.get("USHER_JAX_SEG")
    try:
        os.environ["USHER_JAX_SEG"] = "0"
        a = big.place_arrays(pos, gval, kmiss, with_second=second)
        os.environ["USHER_JAX_SEG"] = "1"
        b = big.place_arrays(pos, gval, kmiss, with_second=second)
    finally:
        if old is None:
            os.environ.pop("USHER_JAX_SEG", None)
        else:
            os.environ["USHER_JAX_SEG"] = old
    if not second:
        a, b = (a,), (b,)
    for ta, tb in zip(a, b):
        for f, (x, y) in enumerate(zip(ta, tb)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"field {f}")


def _batch(rng, big, B, K):
    pos = rng.integers(0, big.P, size=(B, K)).astype(np.int32)
    gval = NIBBLES[rng.integers(0, 4, size=(B, K))]
    kmiss = rng.random((B, K)) < 0.1
    pos[rng.random((B, K)) < 0.15] = big.P   # padding entries
    amb = rng.random((B, K)) < 0.1
    gval = np.where(amb, gval | NIBBLES[rng.integers(0, 4, size=(B, K))],
                    gval).astype(np.uint8)
    return pos, gval, kmiss


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seg_equals_full(seed):
    rng = np.random.default_rng(seed)
    ma, _state, _ = consistent_mat(rng, N=4000, P=600, n_mut=2)
    big = ma.to_bigmat()
    pos, gval, kmiss = _batch(rng, big, B=48, K=10)
    _toggle(big, pos, gval, kmiss, second=False)
    _toggle(big, pos, gval, kmiss, second=True)


@pytest.mark.parametrize("seed", [10, 11])
def test_seg_equals_full_with_overlay(seed):
    """After incremental appends the kernels must still agree (the
    overlay events reach the seg kernel as per-sample padded arrays)."""
    rng = np.random.default_rng(seed)
    ma, _state, _ = consistent_mat(rng, N=3000, P=500, n_mut=2)
    big = ma.to_bigmat()
    # a handful of child inserts + sibling splits with real mutations
    internals = np.nonzero(~big.is_leaf)[0]
    for t in range(6):
        u = int(internals[rng.integers(1, len(internals))])
        c = int(rng.integers(0, big.P))
        alt = int(NIBBLES[(np.searchsorted(NIBBLES, big.ref[c]) + 1) % 4])
        if t % 2 == 0:
            big.queue_child_insert(u, [(c, int(big.ref[c]), alt)])
        else:
            lo, hi = int(big.mut_ptr[u]), int(big.mut_ptr[u + 1])
            if hi == lo or int(big.parent[u]) == u:
                big.queue_child_insert(u, [(c, int(big.ref[c]), alt)])
            else:
                common = [(int(big.mut_col[lo]), int(big.mut_par[lo]),
                           int(big.mut_mut[lo]))]
                big.queue_sibling_split(u, common,
                                        [(c, int(big.ref[c]), alt)])
        big._flush()
    pos, gval, kmiss = _batch(rng, big, B=32, K=8)
    _toggle(big, pos, gval, kmiss, second=False)
    _toggle(big, pos, gval, kmiss, second=True)


def test_seg_empty_and_degenerate():
    """All-padding samples and single-entry samples resolve identically."""
    rng = np.random.default_rng(77)
    ma, _state, _ = consistent_mat(rng, N=1000, P=200, n_mut=2)
    big = ma.to_bigmat()
    B, K = 8, 6
    pos = np.full((B, K), big.P, np.int32)
    gval = np.zeros((B, K), np.uint8)
    kmiss = np.zeros((B, K), bool)
    pos[1, 0] = 5
    gval[1, 0] = NIBBLES[(np.searchsorted(NIBBLES, big.ref[5]) + 1) % 4]
    pos[2, 0] = 5
    gval[2, 0] = big.ref[5]          # ref-state entry
    kmiss[3, 0] = True
    pos[3, 0] = 9
    _toggle(big, pos, gval, kmiss, second=False)
    _toggle(big, pos, gval, kmiss, second=True)

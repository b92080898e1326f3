"""Independent naive-oracle property tests for the placement engines.

The existing host oracle (BigMAT.place_one_host) shares the event-algebra
formulas with the device engine, so agreement between them does not rule
out a shared transcription error.  This oracle is built FROM SCRATCH off
the semantic definition of the reference scorer (usher_mapper.cpp:167-504
as described in SURVEY.md): materialize the full root-path state vector
per node, apply the own-branch bm-rule per position, and count — no
difference arrays, no telescoped aggregates, no shared helpers.  Inputs
are randomized with heavy ambiguity codes and missing (N) entries.
"""

import numpy as np
import pytest

from usher_jax.core.bigmat import BigMAT

NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)


def random_consistent_big(rng, N, P, n_mut=2):
    """Chain-consistent CSR MAT + dense per-node path states."""
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    state = np.tile(ref, (N, 1))
    cols, pars, muts, ptr = [], [], [], [0]
    for i in range(N):
        if i:
            state[i] = state[parent[i]]
            for c in sorted(rng.choice(P, size=n_mut,
                                       replace=False).tolist()):
                pv = int(state[i, c])
                alts = [int(x) for x in NIBBLES if int(x) != pv]
                mv = alts[int(rng.integers(3))]
                state[i, c] = mv
                cols.append(c)
                pars.append(pv)
                muts.append(mv)
        ptr.append(len(cols))
    big = BigMAT(parent, np.array(ptr, np.int64),
                 np.array(cols, np.int32), np.array(pars, np.uint8),
                 np.array(muts, np.uint8),
                 np.arange(P, dtype=np.int64), ref)
    return big, state


def naive_score(big, state, sample):
    """(score, num_common, has_unique, valid) per node, straight from the
    semantic rules; `sample` is a dict pos->(gval, missing)."""
    N, P = state.shape
    ref = big.ref
    out = []
    for n in range(N):
        p_ = int(big.parent[n])
        above = state[p_] if p_ != n else state[0]
        # own branch mutations by column
        own = {}
        for k in range(int(big.mut_ptr[n]), int(big.mut_ptr[n + 1])):
            own[int(big.mut_col[k])] = (int(big.mut_par[k]),
                                        int(big.mut_mut[k]))
        score = 0
        nc = 0
        is_root = p_ == n
        for c in range(P):
            st = int(state[n, c])
            g, miss = sample.get(c, (None, False))
            # the bm-rule: an own mutation the sample does not carry is
            # scored against the state ABOVE the branch
            if c in own and not is_root:
                samp_state = 0xF if miss else (g if g is not None
                                               else int(ref[c]))
                if samp_state & st:
                    nc += 1
                    a_eff = st
                else:
                    a_eff = int(above[c])
            else:
                a_eff = st
            if g is not None and not miss:
                if (g & a_eff) == 0:
                    score += 1
            elif g is None:
                if a_eff != int(ref[c]):
                    score += 1
            # missing entries never cost
        num_mut = sum(1 for (pv, mv) in own.values() if pv != mv) \
            if not is_root else 0
        hu = nc < num_mut
        if is_root:
            valid = True
        elif int(big.is_leaf[n]):
            valid = nc > 0
        else:
            valid = (hu and nc > 0) or not hu
        out.append((score, nc, hu, valid))
    return out


def encode(big, sample, K=16):
    pos = np.full((1, K), big.P, np.int32)
    gval = np.zeros((1, K), np.uint8)
    kmiss = np.zeros((1, K), bool)
    for i, c in enumerate(sorted(sample)):
        g, miss = sample[c]
        pos[0, i] = c
        gval[0, i] = 0xF if miss else g
        kmiss[0, i] = miss
    return pos, gval, kmiss


def random_sample(rng, P, ref):
    sample = {}
    for c in rng.choice(P, size=int(rng.integers(2, 12)),
                        replace=False).tolist():
        r = rng.random()
        if r < 0.2:
            sample[int(c)] = (0, True)              # missing (N)
        elif r < 0.5:
            g = int(NIBBLES[rng.integers(4)])
            g |= int(NIBBLES[rng.integers(4)])      # ambiguity code
            sample[int(c)] = (g, False)
        else:
            g = int(NIBBLES[rng.integers(4)])
            if g == int(ref[c]) and rng.random() < 0.7:
                g = int(NIBBLES[(np.searchsorted(NIBBLES, g) + 1) % 4])
            sample[int(c)] = (g, False)
    return sample


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_interval_engine_vs_naive(seed):
    rng = np.random.default_rng(seed)
    big, state = random_consistent_big(rng, N=120, P=40)
    for _ in range(6):
        sample = random_sample(rng, big.P, big.ref)
        pos, gval, kmiss = encode(big, sample)
        # device interval engine, all nodes
        sT, ncT, nnm = big.score_batch_T(pos, gval, kmiss)
        oracle = naive_score(big, state, sample)
        for n, (score, nc, _hu, _valid) in enumerate(oracle):
            assert sT[n, 0] == score, (seed, n)
            assert ncT[n, 0] == nc, (seed, n)
        # host mirror: tie-broken best must equal the naive argmin
        best, slot, num_best, hu = big.place_one_host(pos, gval, kmiss)
        vscores = [s for (s, _n, _h, v) in oracle if v]
        assert best == min(vscores)
        assert num_best == sum(1 for (s, _n, _h, v) in oracle
                               if v and s == best)
        bs, bslot, bnb, bhu = big.place_arrays(pos, gval, kmiss)
        assert (int(bs[0]), int(bslot[0]), int(bnb[0]), bool(bhu[0])) \
            == (best, slot, num_best, hu)
        # naive tie-break: max leaves then max bfs rank among valid ties
        ties = [n for n, (s, _n2, _h, v) in enumerate(oracle)
                if v and s == best]
        lmax = max(int(big.num_leaves[n]) for n in ties)
        ties = [n for n in ties if int(big.num_leaves[n]) == lmax]
        want = max(ties, key=lambda n: int(big.bfs_rank[n]))
        assert slot == want
        assert hu == oracle[want][2]

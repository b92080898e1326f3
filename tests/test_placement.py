"""Device placement kernel vs. the independent host scorer on random MATs.

The host scorer (placement/mapper.py) is a direct transcription of the
reference semantics (usher_mapper.cpp:167-504); the device kernel
(ops/placement.py) is an algebraic reformulation.  Agreement on randomized
well-formed MATs + random (ambiguous/missing) samples is the core
correctness argument for the vectorized design.
"""

import numpy as np
import pytest

from usher_jax.core.flat import FlatMAT, collect_positions
from usher_jax.core.tree import Mutation, Tree
from usher_jax.io.newick import parse_newick_string
from usher_jax.ops import placement as dev
from usher_jax.placement.mapper import score_placement

BASES = [1, 2, 4, 8]
N = 15


def random_mat(rng, n_leaves=20, n_positions=15, mut_rate=0.35):
    """Random topology with well-formed branch mutations (par_nuc equals the
    parent's path state; mut != par), including back-to-ref mutations."""
    parts = [f"L{i}" for i in range(n_leaves)]
    while len(parts) > 1:
        k = int(rng.integers(2, min(4, len(parts)) + 1))
        group = [parts.pop(int(rng.integers(len(parts)))) for _ in range(k)]
        parts.append("(" + ",".join(group) + ")")
    T = parse_newick_string(parts[0] + ";")

    positions = list(range(100, 100 + n_positions))
    ref = {p: BASES[int(rng.integers(4))] for p in positions}

    # DFS assign mutations consistent with path states
    def walk(node, state):
        state = dict(state)
        if node.parent is not None:
            for p in positions:
                if rng.random() < mut_rate / n_positions * 6:
                    par = state.get(p, ref[p])
                    choices = [b for b in BASES if b != par]
                    mut = choices[int(rng.integers(3))]
                    node.add_mutation(Mutation("c", p, ref[p], par, mut))
                    state[p] = mut
        for ch in node.children:
            walk(ch, state)

    walk(T.root, {})
    # occasionally give the root a mutation
    if rng.random() < 0.5:
        p = positions[0]
        par = ref[p]
        mut = [b for b in BASES if b != par][0]
        T.root.add_mutation(Mutation("c", p, ref[p], par, mut))
        # fix descendants' par_nuc consistency: rebuild states below root
        # (simplest: drop conflicting child mutations at p whose par doesn't match)
        def fix(node, state):
            state = dict(state)
            for m in list(node.mutations):
                if node.parent is not None and m.position == p:
                    expected_par = state.get(p, ref[p])
                    if m.par_nuc != expected_par:
                        if m.mut_nuc == expected_par:
                            node.mutations.remove(m)
                            continue
                        m.par_nuc = expected_par
                state[m.position] = m.mut_nuc
            for ch in node.children:
                fix(ch, state)
        fix(T.root, {p: mut})
    return T, ref


def random_sample(rng, ref, n_entries=6):
    positions = sorted(rng.choice(list(ref), size=min(n_entries, len(ref)),
                                  replace=False).tolist())
    muts = []
    for p in positions:
        r = rng.random()
        m = Mutation("c", p, ref[p], ref[p])
        if r < 0.15:
            m.is_missing = True
            m.mut_nuc = N
        elif r < 0.35:
            m.mut_nuc = int(rng.integers(3, 15))  # ambiguous mask
        else:
            m.mut_nuc = BASES[int(rng.integers(4))]
            if m.mut_nuc == ref[p]:
                m.mut_nuc = BASES[(BASES.index(m.mut_nuc) + 1) % 4]
        muts.append(m)
    return muts


@pytest.mark.parametrize("seed", list(range(8)))
def test_device_matches_host_scorer(seed):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng)
    # position set = all segregating sites (as the VCF would provide)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    flat = FlatMAT(T, positions, refarr, "c")
    samples = [random_sample(rng, ref) for _ in range(4)]

    st_dev, parent_dev = flat.sync()
    meta = flat.order_arrays()
    g, E, miss = flat.encode_samples(samples)
    score, num_common, node_num_mut = (
        np.asarray(x) for x in dev.score_batch(
            st_dev, parent_dev, flat.root_slot, np.asarray(flat.ref),
            meta["active"], g, E, miss))
    valid, has_unique = dev.placement_outputs(
        score, num_common, node_num_mut, meta["is_root_mask"],
        meta["is_leaf"], meta["active"])

    for b, muts in enumerate(samples):
        for node in meta["bfs"]:
            host = score_placement(node, muts)
            s = node.slot
            assert score[b, s] == host.set_difference, (
                f"seed={seed} sample={b} node={node.identifier}: device "
                f"{score[b, s]} host {host.set_difference}")
            assert bool(valid[b, s]) == host.is_valid, (
                f"seed={seed} sample={b} node={node.identifier} validity")
            assert bool(has_unique[b, s]) == host.has_unique, (
                f"seed={seed} sample={b} node={node.identifier} has_unique")
            assert num_common[b, s] == host.num_common
            assert node_num_mut[s] == host.node_num_mut


def test_reduce_best_tiebreak_matches_sequential():
    """reduce_best must equal the reference's sequential BFS-order update rule
    (usher_mapper.cpp:458-497): strict improvement replaces; ties replace when
    leaves are greater, or equal leaves and later BFS index."""
    rng = np.random.default_rng(42)
    for _ in range(50):
        n = 40
        score = rng.integers(0, 6, size=(1, n)).astype(np.int32)
        valid = rng.random((1, n)) < 0.7
        valid[0, 0] = True
        leaves = rng.integers(1, 5, size=n).astype(np.int32)
        rank = np.arange(n, dtype=np.int32)

        # sequential emulation
        best, bj, bl, nb = 1 << 30, -1, -1, 0
        for j in range(n):
            if not valid[0, j]:
                continue
            if score[0, j] < best:
                best, bj, bl, nb = score[0, j], j, leaves[j], 1
            elif score[0, j] == best:
                if leaves[j] > bl or (leaves[j] == bl and bj < j):
                    bj, bl = j, leaves[j]
                nb += 1

        bs, bslot, num_best = dev.reduce_best(
            score, valid, leaves, rank)
        assert int(bs[0]) == best
        assert int(bslot[0]) == bj
        assert int(num_best[0]) == nb


def test_incremental_append_matches_rebuild():
    """After surgery-style appends, the incrementally maintained flat arrays
    must match a fresh rebuild from the tree."""
    rng = np.random.default_rng(3)
    T, ref = random_mat(rng, n_leaves=10)
    positions, refarr, chrom = collect_positions(T)
    flat = FlatMAT(T, positions, refarr, chrom)

    # graft a new leaf under a random internal node with one mutation
    internal = [n for n in T.breadth_first_expansion() if not n.is_leaf()]
    target = internal[int(rng.integers(len(internal)))]
    leaf = T.create_node("NEWLEAF", target)
    p = int(positions[0])
    # well-formed: par = path state of target at p
    state = ref[p]
    cur = target
    chain = []
    while cur is not None:
        chain.append(cur)
        cur = cur.parent
    for nd in reversed(chain):
        for m in nd.mutations:
            if m.position == p:
                state = m.mut_nuc
    mut = [b for b in BASES if b != state][0]
    leaf.add_mutation(Mutation("c", p, ref[p], state, mut))
    flat.add_node(leaf)

    st_dev, parent_dev = flat.sync()
    st_inc = np.asarray(st_dev)
    slots_inc = {n.identifier: n.slot for n in T.breadth_first_expansion()}
    flat2 = FlatMAT(T, positions, refarr, chrom)  # re-assigns slots
    for node in T.breadth_first_expansion():
        row_inc = st_inc[slots_inc[node.identifier]]
        row_new = flat2.st_host[node.slot]
        np.testing.assert_array_equal(row_inc, row_new,
                                      err_msg=f"node {node.identifier}")

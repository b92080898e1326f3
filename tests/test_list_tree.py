"""Property tests: ListTree structural ops == core.tree.Tree ops.

Random trees are engineered to trigger the hairy branches: zero-mutation
internal edges (collapse moves), identical-mutation siblings (move_node
merge cases), unary chains (mutation-list merges), zero-mutation leaf
polytomies (condense groups).
"""

import numpy as np
import pytest

from usher_jax.core.tree import Mutation, Tree
from usher_jax.io.newick import write_newick
from usher_jax.placement.list_tree import ListTree

NIBBLES = [1, 2, 4, 8]


def random_tree(rng, n_nodes=60, p_zero_muts=0.35, p_dup=0.2):
    """Random chain-consistent Tree whose shape exercises
    collapse/merge/condense (mut_par always equals the path state
    above, like a real MAT)."""
    T = Tree()
    root = T.create_node("node_0", None)
    nodes = [root]
    state = {id(root): {}}
    for i in range(1, n_nodes):
        parent = nodes[int(rng.integers(0, len(nodes)))]
        n = T.create_node(f"n{i}", parent)
        nodes.append(n)
        st = dict(state[id(parent)])
        r = rng.random()
        if r < p_zero_muts:
            pass  # zero-mutation branch
        elif r < p_zero_muts + p_dup and any(
                c is not n and c.mutations for c in parent.children):
            sib = next(c for c in parent.children
                       if c is not n and c.mutations)
            # duplicate a sibling's mutation list (merge trigger)
            for m in sib.mutations:
                n.add_mutation(m.copy())
                st[m.position] = m.mut_nuc
        else:
            for _ in range(int(rng.integers(1, 4))):
                pos = int(rng.integers(100, 140))
                par = st.get(pos, NIBBLES[int(rng.integers(0, 4))])
                alts = [x for x in NIBBLES if x != par]
                mut = alts[int(rng.integers(0, 3))]
                n.add_mutation(Mutation("chr", pos, par, par, mut))
                st[pos] = mut
        state[id(n)] = st
    T.curr_internal_node = n_nodes + 10
    return T


def tree_to_listtree(T: Tree) -> ListTree:
    lt = ListTree()
    dfs = T.depth_first_expansion()
    idx = {id(n): i for i, n in enumerate(dfs)}
    lt.names = [n.identifier for n in dfs]
    lt.parent = [idx[id(n.parent)] if n.parent is not None else -1
                 for n in dfs]
    lt.children = [[idx[id(c)] for c in n.children] for n in dfs]
    lt.muts = [[m.copy() for m in n.mutations] for n in dfs]
    lt.alive = [True] * len(dfs)
    lt.root = idx[id(T.root)]
    lt.curr_internal_node = T.curr_internal_node
    lt.condensed = [(k, list(v)) for k, v in T.condensed_nodes.items()]
    lt.num_annotations = T.get_num_annotations()
    if lt.num_annotations:
        lt.ann = [list(n.clade_annotations) for n in dfs]
    return lt


def nh(T: Tree) -> str:
    return write_newick(T, print_internal=True, print_branch_len=True)


@pytest.mark.parametrize("seed", range(12))
def test_collapse_parity(seed):
    rng = np.random.default_rng(seed)
    T = random_tree(rng)
    lt = tree_to_listtree(T)
    assert lt.write_newick() == nh(T)  # pre-op writer parity
    T.collapse_tree()
    lt.collapse_tree()
    assert lt.write_newick() == nh(T), seed
    assert lt.curr_internal_node == T.curr_internal_node, seed


@pytest.mark.parametrize("seed", range(8))
def test_condense_uncondense_parity(seed):
    rng = np.random.default_rng(100 + seed)
    T = random_tree(rng, p_zero_muts=0.55)
    lt = tree_to_listtree(T)
    T.condense_leaves()
    lt.condense_leaves()
    assert lt.write_newick() == nh(T), seed
    assert dict(lt.condensed) == {k: list(v)
                                  for k, v in T.condensed_nodes.items()}
    # uncondensed WRITER parity (leaf expansion without restructuring)
    assert lt.write_newick(uncondense=True) == write_newick(
        T, print_internal=True, print_branch_len=True,
        uncondense_leaves=True)
    # structural uncondense parity
    T.uncondense_leaves()
    lt.uncondense_leaves()
    assert lt.write_newick() == nh(T), seed


@pytest.mark.parametrize("seed", range(6))
def test_subtree_parity(seed):
    from usher_jax.matutils.tree_filter import get_subtree
    rng = np.random.default_rng(200 + seed)
    T = random_tree(rng)
    leaves = T.get_leaves_ids()
    pick = [leaves[int(i)] for i in
            rng.choice(len(leaves), size=min(8, len(leaves)),
                       replace=False)]
    lt = tree_to_listtree(T)
    s1 = get_subtree(T, pick)
    s2 = lt.get_subtree(pick)
    assert nh(s2) == nh(s1), seed


@pytest.mark.parametrize("seed", range(6))
def test_collapse_then_condense_parity(seed):
    """The -c input pipeline: collapse + condense, exactly as run_usher
    does before placement."""
    rng = np.random.default_rng(300 + seed)
    T = random_tree(rng, p_zero_muts=0.5, p_dup=0.25)
    lt = tree_to_listtree(T)
    T.collapse_tree()
    T.condense_leaves()
    lt.collapse_tree()
    lt.condense_leaves()
    assert lt.write_newick() == nh(T), seed
    assert dict(lt.condensed) == {k: list(v)
                                  for k, v in T.condensed_nodes.items()}

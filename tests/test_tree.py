import pytest

from usher_jax.core.tree import Mutation, Tree
from usher_jax.io.newick import parse_newick_string, write_newick


def M(pos, par, mut, ref=1):
    return Mutation("", pos, ref, par, mut)


def test_add_mutation_sorted_insert():
    T = parse_newick_string("(A,B);")
    a = T.get_node("A")
    a.add_mutation(M(10, 1, 2))
    a.add_mutation(M(5, 1, 4))
    a.add_mutation(M(7, 1, 8))
    assert [m.position for m in a.mutations] == [5, 7, 10]


def test_add_mutation_update_same_position():
    T = parse_newick_string("(A,B);")
    a = T.get_node("A")
    a.add_mutation(M(10, 1, 2))   # A->C
    a.add_mutation(M(10, 2, 4))   # C->G: net A->G
    assert len(a.mutations) == 1
    assert a.mutations[0].mut_nuc == 4


def test_add_mutation_reversal_removes():
    T = parse_newick_string("(A,B);")
    a = T.get_node("A")
    a.add_mutation(M(10, 1, 2))   # A->C
    a.add_mutation(M(10, 2, 1))   # C->A: cancels
    assert a.mutations == []


def test_bfs_dfs_order():
    T = parse_newick_string("((A,B),(C,D));")
    bfs = [n.identifier for n in T.breadth_first_expansion()]
    assert bfs == ["node_1", "node_2", "node_3", "A", "B", "C", "D"]
    dfs = [n.identifier for n in T.depth_first_expansion()]
    assert dfs == ["node_1", "node_2", "A", "B", "node_3", "C", "D"]
    n2 = T.get_node("node_2")
    assert (n2.dfs_idx, n2.dfs_end_idx) == (1, 4)


def test_num_leaves_and_parsimony():
    T = parse_newick_string("((A,B),(C,D));")
    T.get_node("A").add_mutation(M(1, 1, 2))
    T.get_node("node_3").add_mutation(M(2, 1, 4))
    assert T.get_num_leaves(T.root) == 4
    assert T.get_num_leaves(T.get_node("node_2")) == 2
    assert T.get_parsimony_score() == 2


def test_collapse_tree_zero_mutation_edges():
    T = parse_newick_string("((A,B),C);")
    n2 = T.get_node("node_2")
    T.get_node("A").add_mutation(M(1, 1, 2))
    # node_2 has no mutations -> its children collapse into root
    T.collapse_tree()
    kids = [c.identifier for c in T.root.children]
    assert set(kids) == {"A", "B", "C"}


def test_collapse_keeps_mutated_internal():
    T = parse_newick_string("((A,B),C);")
    T.get_node("node_2").add_mutation(M(1, 1, 2))
    T.collapse_tree()
    kids = [c.identifier for c in T.root.children]
    assert "node_2" in kids


def test_condense_leaves():
    T = parse_newick_string("((A,B,C),D);")
    T.condense_leaves()
    # A,B,C identical (no mutations) -> one condensed node
    assert len(T.condensed_nodes) == 1
    name = next(iter(T.condensed_nodes))
    assert name == "node_1_condensed_3_leaves"
    assert T.condensed_nodes[name] == ["A", "B", "C"]
    assert T.get_node("A") is None
    assert T.get_node(name) is not None
    # leaves now: condensed + D
    leaves = set(T.get_leaves_ids())
    assert leaves == {name, "D"}


def test_condense_skips_mutated_leaves():
    T = parse_newick_string("((A,B,C),D);")
    T.get_node("A").add_mutation(M(1, 1, 2))
    T.condense_leaves()
    name = next(iter(T.condensed_nodes))
    assert T.condensed_nodes[name] == ["B", "C"]
    assert T.get_node("A") is not None


def test_uncondense_roundtrip():
    T = parse_newick_string("((A,B,C),D);")
    T.condense_leaves()
    T.uncondense_leaves()
    assert not T.condensed_nodes
    leaves = set(T.get_leaves_ids())
    assert leaves == {"A", "B", "C", "D"}


def test_move_node_simple():
    T = parse_newick_string("((A,B),(C,D));")
    T.get_node("A").add_mutation(M(1, 1, 2))
    T.move_node("A", "node_3")
    assert T.get_node("A").parent.identifier == "node_3"
    assert T.get_node("A").level == 3
    # move_node leaves a single-child node_2 in place (the reference's
    # remove_child only removes empty parents; mutation_annotated_tree.cpp:1120)
    assert T.get_node("B").parent.identifier == "node_2"
    assert len(T.get_node("node_2").children) == 1


def test_clade_assignment():
    T = parse_newick_string("((A,B),C);")
    for n in T.breadth_first_expansion():
        n.clade_annotations = [""]
    T.get_node("node_2").clade_annotations = ["20A"]
    assert T.get_clade_assignment(T.get_node("A"), 0, True) == "20A"
    assert T.get_clade_assignment(T.get_node("C"), 0, True) == "UNDEFINED"
    assert T.get_clade_assignment(T.get_node("node_2"), 0, False) == "UNDEFINED"


def test_tree_copy_independent():
    T = parse_newick_string("((A,B),C);")
    T.get_node("A").add_mutation(M(1, 1, 2))
    T2 = T.copy()
    T2.get_node("A").add_mutation(M(5, 1, 4))
    assert len(T.get_node("A").mutations) == 1
    assert len(T2.get_node("A").mutations) == 2
    assert write_newick(T2) != ""

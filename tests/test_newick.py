import os

import pytest

from usher_jax.core.tree import Mutation, Tree
from usher_jax.io.newick import parse_newick_string, write_newick

from conftest import REFERENCE_TEST_DIR


def test_parse_simple():
    T = parse_newick_string("(A:1,B:2)root:3;")
    assert T.root is not None
    # internal labels are discarded; fresh preorder ids
    assert T.root.identifier == "node_1"
    names = [n.identifier for n in T.depth_first_expansion()]
    assert names == ["node_1", "A", "B"]
    assert T.get_node("A").branch_length == 1.0
    assert T.get_node("B").branch_length == 2.0
    assert T.root.branch_length == 3.0


def test_parse_nested_preorder_ids():
    T = parse_newick_string("((A,B),(C,(D,E)));")
    names = [n.identifier for n in T.depth_first_expansion()]
    assert names == ["node_1", "node_2", "A", "B", "node_3", "C", "node_4", "D", "E"]
    assert T.get_node("D").level == 4


def test_parse_missing_branch_lengths():
    T = parse_newick_string("(A,B);")
    assert T.get_node("A").branch_length == -1.0


def test_write_mutation_counts_as_lengths():
    T = parse_newick_string("(A:1,B:2);")
    T.get_node("A").add_mutation(Mutation("", 5, 1, 1, 2))
    T.get_node("A").add_mutation(Mutation("", 9, 1, 1, 4))
    out = write_newick(T)
    # branch length == number of mutations, input lengths ignored
    assert out == "(A:2,B:0)node_1:0;"


def test_write_without_internal_labels():
    T = parse_newick_string("((A,B),C);")
    out = write_newick(T, print_internal=False)
    assert out == "((A:0,B:0):0,C:0):0;"


def test_roundtrip_topology():
    s = "((A:0,B:0)node_2:0,(C:0,(D:0,E:0)node_4:0)node_3:0)node_1:0;"
    T = parse_newick_string(s)
    assert write_newick(T) == s


def test_condensed_leaf_expansion():
    T = parse_newick_string("(X,C);")
    T.condensed_nodes["X"] = ["s1", "s2", "s3"]
    out = write_newick(T, uncondense_leaves=True)
    # members comma-joined; branch length attaches after the last only
    assert out == "(s1,s2,s3:0,C:0)node_1:0;"


@pytest.mark.skipif(not os.path.isdir(REFERENCE_TEST_DIR),
                    reason="reference test data unavailable")
def test_parse_global_phylo():
    path = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
    with open(path) as f:
        s = f.readline().strip()
    T = parse_newick_string(s)
    leaves = [n for n in T.depth_first_expansion() if n.is_leaf()]
    assert len(leaves) == 422
    # writer emits a parseable tree with identical leaf set
    T2 = parse_newick_string(write_newick(T))
    leaves2 = [n.identifier for n in T2.depth_first_expansion() if n.is_leaf()]
    assert [l.identifier for l in leaves] == leaves2

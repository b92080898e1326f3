import os

from usher_jax.core.tree import Mutation, Tree
from usher_jax.io.newick import parse_newick_string, write_newick
from usher_jax.io.pbio import load_mat_pb, save_mat_pb


def make_tree():
    T = parse_newick_string("((A,B),(C,D));")
    T.get_node("A").add_mutation(Mutation("chr1", 10, 1, 1, 2))
    T.get_node("node_2").add_mutation(Mutation("chr1", 20, 4, 4, 8))
    T.get_node("C").add_mutation(Mutation("chr1", 10, 1, 1, 0b1010))  # ambiguous
    return T


def test_pb_roundtrip(tmp_path):
    T = make_tree()
    path = str(tmp_path / "out.pb")
    save_mat_pb(T, path)
    T2 = load_mat_pb(path)
    # topology: same newick when written without internal labels
    assert (write_newick(T, print_internal=False)
            == write_newick(T2, print_internal=False))
    # mutations preserved per node (positions + alleles)
    dfs1 = T.depth_first_expansion()
    dfs2 = T2.depth_first_expansion()
    assert len(dfs1) == len(dfs2)
    for n1, n2 in zip(dfs1, dfs2):
        m1 = [(m.position, m.ref_nuc, m.par_nuc, m.mut_nuc) for m in n1.mutations]
        m2 = [(m.position, m.ref_nuc, m.par_nuc, m.mut_nuc) for m in n2.mutations]
        assert m1 == m2
        assert [m.chrom for m in n2.mutations] == ["chr1"] * len(m2)


def test_pb_roundtrip_gz(tmp_path):
    T = make_tree()
    path = str(tmp_path / "out.pb.gz")
    save_mat_pb(T, path)
    T2 = load_mat_pb(path)
    assert len(T2.depth_first_expansion()) == len(T.depth_first_expansion())


def test_pb_condensed_nodes(tmp_path):
    T = parse_newick_string("((A,B,C),D);")
    T.condense_leaves()
    path = str(tmp_path / "out.pb")
    save_mat_pb(T, path)
    T2 = load_mat_pb(path)
    assert T2.condensed_nodes == T.condensed_nodes
    assert T2.condensed_leaves == {"A", "B", "C"}


def test_pb_clade_annotations(tmp_path):
    T = make_tree()
    for n in T.breadth_first_expansion():
        n.clade_annotations = ["", ""]
    T.get_node("node_2").clade_annotations = ["20A", "alpha"]
    path = str(tmp_path / "out.pb")
    save_mat_pb(T, path)
    T2 = load_mat_pb(path)
    # annotations stored in DFS order
    node2 = [n for n in T2.depth_first_expansion()
             if n.clade_annotations == ["20A", "alpha"]]
    assert len(node2) == 1


def test_pb_drops_par_equal_mut(tmp_path):
    T = make_tree()
    path = str(tmp_path / "out.pb")
    save_mat_pb(T, path)
    T2 = load_mat_pb(path)
    for n in T2.depth_first_expansion():
        for m in n.mutations:
            assert m.mut_nuc != m.par_nuc

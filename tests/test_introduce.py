"""matUtils introduce: hand-verifiable assignments/statistics + CLI smoke.

Reference semantics: src/matUtils/introduce.cpp (get_assignments :270,
get_association_index :108 incl. its integer-division quirk,
get_monophyletic_cladesize :200, find_introductions :476).
"""

import os

import pytest

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

from usher_jax.core.tree import Mutation, Tree
from usher_jax.matutils.introduce import (
    find_introductions, get_assignments, get_association_index,
    get_monophyletic_cladesize, read_two_column)


def _mut(pos, mut=2):
    return Mutation("c", pos, 1, 1, mut)


def build_tree():
    """root -> A(1 mut), I1(1) -> {B(0), C(1)}, I2(1) -> {D(1), E(1)}."""
    T = Tree()
    T.create_node("root")
    a = T.create_node("A", "root")
    a.add_mutation(_mut(10))
    i1 = T.create_node("I1", "root")
    i1.add_mutation(_mut(20))
    T.create_node("B", "I1")
    c = T.create_node("C", "I1")
    c.add_mutation(_mut(30))
    i2 = T.create_node("I2", "root")
    i2.add_mutation(_mut(40))
    d = T.create_node("D", "I2")
    d.add_mutation(_mut(50))
    e = T.create_node("E", "I2")
    e.add_mutation(_mut(60))
    return T


def test_assignments_hand_values():
    T = build_tree()
    asg = get_assignments(T, {"B", "C"})
    assert asg["B"] == 1.0 and asg["C"] == 1.0
    assert asg["A"] == 0.0 and asg["D"] == 0.0 and asg["E"] == 0.0
    assert asg["I1"] == 1.0        # all descendants IN
    assert asg["I2"] == 0.0        # all descendants OUT
    # root: in=2 out=3, min_to_in = 0(B)+1(I1) = 1, min_to_out = 1(A)
    # c = 1/(1 + (1/2)/(1/3)) = 1/(1+1.5) = 0.4
    assert abs(asg["root"] - 0.4) < 1e-6


def test_association_index_and_cladesize():
    T = build_tree()
    asg = get_assignments(T, {"B", "C"})
    # AI: root contributes (1 - 3//5)/2^4 = 1/16; I1/I2 fully one-trait -> 0
    assert abs(get_association_index(T, asg) - 0.0625) < 1e-9
    assert get_monophyletic_cladesize(T, asg) == 2


def test_find_introductions_single_region():
    T = build_tree()
    out = find_introductions(T, {"default": ["B", "C"]})
    header = out[0]
    assert header.startswith("sample\tintroduction_node\tintroduction_rank")
    body = out[1:]
    assert len(body) == 2
    rows = {l.split("\t")[0]: l.split("\t") for l in body}
    assert set(rows) == {"B", "C"}
    for name, f in rows.items():
        # introduction keyed at root (reference: root is always the
        # introduction point when the walk reaches it)
        assert f[1] == "default_root"
        assert f[2] == "1"                       # single cluster, rank 1
        assert f[6] == "2"                       # cluster_size
        assert f[8] == "1"                       # intro_confidence (I1 = 1)
        assert f[9] == "0"                       # parent_confidence (root->0)


def test_read_two_column(tmp_path):
    p = tmp_path / "samples.txt"
    p.write_text("s1\ns2\tregionA\ns3\tregionA\n")
    m = read_two_column(str(p))
    assert m == {"default": ["s1"], "regionA": ["s2", "s3"]}


def test_introduce_cli_smoke(tmp_path):
    """End-to-end on the reference smoke tree through the CLI."""
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.matutils_cli import main as matutils_main
    from usher_jax.io.pbio import load_mat_pb

    build = str(tmp_path / "b")
    pb = os.path.join(build, "out.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", build]) == 0
    T = load_mat_pb(pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()[:25]
    spath = str(tmp_path / "pop.txt")
    with open(spath, "w") as f:
        f.write("".join(s + "\n" for s in leaves))
    out = str(tmp_path / "intro.tsv")
    clus = str(tmp_path / "clusters.tsv")
    dump = str(tmp_path / "dump")
    assert matutils_main(["introduce", "-i", pb, "-s", spath, "-o", out,
                          "-u", clus, "-D", dump, "-a"]) == 0
    lines = open(out).read().rstrip("\n").split("\n")
    assert lines[0].startswith("sample\tintroduction_node")
    assert lines[0].rstrip("\n").endswith("monophyl_size\tassoc_index")
    names = {l.split("\t")[0] for l in lines[1:]}
    assert names == set(leaves)
    clines = open(clus).read().rstrip("\n").split("\n")
    assert clines[0].startswith("cluster_id\tsample_count")
    # cluster sizes sum to the population
    assert sum(int(l.split("\t")[1]) for l in clines[1:]) == len(leaves)
    assert os.path.exists(os.path.join(dump, "default_assignments.tsv"))


# --- arrays-path parity (matutils/introduce_arrays.py) ----------------------

def _ann_tree(rng):
    """Random chain-consistent Tree with clade annotations + condensible
    zero-mutation leaf groups (the introduce-relevant hairy branches)."""
    import numpy as np
    from test_list_tree import random_tree
    T = random_tree(rng, n_nodes=80)
    dfs = T.depth_first_expansion()
    for n in dfs:
        n.clade_annotations = ["", ""]
    # sprinkle annotations on some internal nodes
    internals = [n for n in dfs if not n.is_leaf()]
    for k, n in enumerate(internals[:: max(1, len(internals) // 6)]):
        n.clade_annotations[k % 2] = f"clade{k}"
    T.condense_leaves()
    return T


def _run_both(tmp_path, tag, pb, pop_text, **kw):
    """Drive the Tree and arrays paths with identical args; byte-compare
    every produced artifact and the returned rows."""
    from usher_jax.matutils.introduce import introduce_main
    from usher_jax.matutils.introduce_arrays import introduce_main_arrays

    spath = str(tmp_path / f"{tag}_pop.txt")
    with open(spath, "w") as f:
        f.write(pop_text)
    sides = {}
    for side, fn in (("tree", introduce_main),
                     ("arr", introduce_main_arrays)):
        d = tmp_path / f"{tag}_{side}"
        d.mkdir()
        out = fn(pb, spath, full_output=str(d / "out.tsv"),
                 cluster_output=str(d / "clusters.tsv"),
                 dump_assignments=str(d / "dump"),
                 clade_regions=str(d / "clades.tsv"), **kw)
        sides[side] = (out, d)
    out_t, dt = sides["tree"]
    out_a, da = sides["arr"]
    assert out_t == out_a
    for rel in ("out.tsv", "clusters.tsv", "clades.tsv"):
        assert (dt / rel).read_bytes() == (da / rel).read_bytes(), rel
    dumps_t = sorted(p.name for p in (dt / "dump").iterdir())
    assert dumps_t == sorted(p.name for p in (da / "dump").iterdir())
    for name in dumps_t:
        assert ((dt / "dump" / name).read_bytes()
                == (da / "dump" / name).read_bytes()), name
    return out_t


def test_introduce_arrays_parity_randomized(tmp_path):
    import numpy as np
    from usher_jax.io.pbio import save_mat_pb

    rng = np.random.default_rng(7)
    for trial in range(3):
        T = _ann_tree(rng)
        pb = str(tmp_path / f"t{trial}.pb")
        save_mat_pb(T, pb)
        T2 = T.copy()
        T2.uncondense_leaves()
        leaves = T2.get_leaves_ids()
        # two regions + some missing samples; flags cover look-ahead,
        # minimum gap, uncertainty, and add_info (AI permutations + rng)
        pop = "".join(
            s + ("\tR1\n" if i % 2 else "\tR2\n")
            for i, s in enumerate(leaves[: max(6, len(leaves) // 2)]))
        pop += "not_in_tree\tR1\n"
        out = _run_both(tmp_path, f"r{trial}", pb, pop,
                        additional_info=True, evaluate_metadata=True,
                        num_to_look=2, minimum_gap=1,
                        minimum_to_report=0.01, num_to_report=2)
        assert len(out) > 1


def test_introduce_arrays_parity_fixture(tmp_path):
    """Single-region default flags on the reference smoke tree."""
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.io.pbio import load_mat_pb

    build = str(tmp_path / "b")
    pb = os.path.join(build, "out.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", build]) == 0
    T = load_mat_pb(pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()[:25]
    out = _run_both(tmp_path, "fx", pb,
                    "".join(s + "\n" for s in leaves),
                    additional_info=True)
    assert len(out) == 26


def test_association_index_overflow_guard():
    """>1024-leaf polytomy: C++ pow saturates to inf (term 0); the Python
    2.0** would raise OverflowError without the guard."""
    T = Tree()
    T.create_node("root")
    for i in range(1100):
        n = T.create_node(f"L{i}", "root")
        n.add_mutation(_mut(10 + (i % 50)))
    asg = get_assignments(T, {f"L{i}" for i in range(0, 1100, 2)})
    val = get_association_index(T, asg)
    assert val == 0.0

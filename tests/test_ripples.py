"""RIPPLES recombination detection on a constructed recombinant."""

import os

import pytest

from usher_jax.core.tree import Mutation, Tree
from usher_jax.io.pbio import save_mat_pb, load_mat_pb
from usher_jax.cli.ripples_cli import main as ripples_cli
from usher_jax.ripples import RipplesOptions, ripples_main


def mk(pos, mut, par=1, ref=1):
    return Mutation(chrom="c", position=pos, ref_nuc=ref, par_nuc=par,
                    mut_nuc=mut)


def build_recombinant_tree():
    """Donor clade d1 carries G at {1100,2200,3300}; acceptor clade a1
    carries C at {15100,15200,15300}; leaf R (hanging off the root) carries
    all six -- a recombinant of the two."""
    T = Tree()
    root = T.create_node("root")
    d1 = T.create_node("d1", root)
    d1.mutations = [mk(1100, 4), mk(2200, 4), mk(3300, 4)]
    da = T.create_node("D1", d1)
    da.mutations = [mk(20000, 2)]
    db = T.create_node("D2", d1)
    db.mutations = [mk(20001, 2)]
    a1 = T.create_node("a1", root)
    a1.mutations = [mk(15100, 2), mk(15200, 2), mk(15300, 2)]
    aa = T.create_node("A1", a1)
    aa.mutations = [mk(20002, 2)]
    ab = T.create_node("A2", a1)
    ab.mutations = [mk(20003, 2)]
    r = T.create_node("R", root)
    r.mutations = [mk(1100, 4), mk(2200, 4), mk(3300, 4),
                   mk(15100, 2), mk(15200, 2), mk(15300, 2)]
    # background leaves so the tree isn't degenerate
    x = T.create_node("X", root)
    x.mutations = [mk(25000, 8)]
    return T


def test_ripples_detects_recombinant(tmp_path):
    T = build_recombinant_tree()
    pb = str(tmp_path / "recomb.pb")
    save_mat_pb(T, pb)
    outdir = str(tmp_path / "out")
    rc = ripples_cli(["-i", pb, "-d", outdir, "-n", "1",
                      "-l", "3", "-p", "3"])
    assert rc == 0
    lines = open(os.path.join(outdir, "recombination.tsv")).read().splitlines()
    assert lines[0].startswith("#recomb_node_id")
    body = [l for l in lines[1:] if l]
    assert body, "no recombination events reported"
    recombs = {l.split("\t")[0] for l in body}
    assert recombs == {"R"}
    row = body[0].split("\t")
    # donor/acceptor parsimony fields and the improvement condition
    orig = int(row[9])
    recomb_p = int(row[11])
    assert orig == 6
    assert recomb_p + 3 <= orig
    # descendants.tsv lists R
    desc = open(os.path.join(outdir, "descendants.tsv")).read().splitlines()
    assert any(l.startswith("R\t") for l in desc[1:])


def test_ripples_no_false_positive_on_clean_tree(tmp_path):
    """A tree with two unrelated long branches but no recombinant signal must
    report nothing."""
    T = Tree()
    root = T.create_node("root")
    b1 = T.create_node("b1", root)
    b1.mutations = [mk(1000, 4), mk(2000, 4), mk(3000, 4)]
    T.create_node("L1", b1).mutations = [mk(30000, 2)]
    T.create_node("L2", b1).mutations = [mk(30001, 2)]
    b2 = T.create_node("b2", root)
    b2.mutations = [mk(15000, 2), mk(16000, 2), mk(17000, 2)]
    T.create_node("L3", b2).mutations = [mk(30002, 2)]
    T.create_node("L4", b2).mutations = [mk(30003, 2)]
    pb = str(tmp_path / "clean.pb")
    save_mat_pb(T, pb)
    outdir = str(tmp_path / "out")
    rc = ripples_cli(["-i", pb, "-d", outdir, "-n", "1", "-l", "3", "-p", "3"])
    assert rc == 0
    body = [l for l in open(os.path.join(outdir, "recombination.tsv"))
            .read().splitlines()[1:] if l]
    assert body == []


def test_ripples_init_cli(tmp_path):
    """ripplesInit: long-branch count + Chronumental id map
    (reference init/main.cpp:13, init_pipeline.cpp:8-80)."""
    import os
    from usher_jax.cli.ripples_init_cli import main as init_main
    from usher_jax.io.pbio import save_mat_pb
    T = build_recombinant_tree()
    pb = str(tmp_path / "t.pb")
    save_mat_pb(T, pb)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        import io, contextlib
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = init_main(["-i", pb, "-l", "3", "-n", "2"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    count = int(buf.getvalue().strip())
    assert count >= 1
    lines = open(tmp_path / "ripples_to_chron_ids.txt").read().split("\n")
    assert lines[0] == "MAT_node_id\tchronumental_node_id"
    assert len([l for l in lines[1:] if l]) == len(
        T.depth_first_expansion())


def test_ripples_utils_cli(tmp_path):
    """ripplesUtils: trio parsing + helper files
    (reference util/ripplesUtils.cpp, parse_data.cpp)."""
    import os
    from usher_jax.cli.ripples_utils_cli import main as utils_main
    from usher_jax.io.pbio import save_mat_pb
    T = build_recombinant_tree()
    pb = str(tmp_path / "t.pb")
    save_mat_pb(T, pb)
    leaves = T.get_leaves_ids()
    internal = [n.identifier for n in T.depth_first_expansion()
                if not n.is_leaf() and n.parent is not None]
    pvals = str(tmp_path / "pvals.txt")
    with open(pvals, "w") as f:
        f.write("#recomb\ta\tb\tdonor\tdsib\tc\tacceptor\tasib\n")
        f.write(f"{leaves[0]}\tx\tx\t{leaves[1]}\ty\tx\t{internal[0]}\tn\n")
    data_dir = str(tmp_path / "data")
    rc = utils_main([pb, "--pvals", pvals, "--data-dir", data_dir])
    assert rc == 0
    names = set(open(os.path.join(data_dir,
                                  "allRelevantNodeNames.txt")).read().split())
    assert leaves[0] in names and leaves[1] in names and internal[0] in names
    ntp = open(os.path.join(data_dir, "nodeToParent.txt")).read().split("\n")
    assert ntp[0] == "node\tparent"
    assert any(l.startswith(leaves[1] + "\t") for l in ntp[1:])
    sp = open(os.path.join(data_dir, "sample_paths.txt")).read().split("\n")
    assert sp[0] == "sample_id\tpath_from_root"
    lv = [l for l in open(os.path.join(data_dir,
                                       "leaves.txt")).read().split("\n") if l]
    assert len(lv) == len(T.depth_first_expansion())

"""matUtils suite: extract/summary/annotate/uncertainty/merge/mask/fix."""

import json
import os

import numpy as np
import pytest

from usher_jax.cli.matutils_cli import main as matutils_main
from usher_jax.core.tree import Tree
from usher_jax.io.newick import parse_newick, parse_newick_string
from usher_jax.io.pbio import load_mat_pb, save_mat_pb
from usher_jax.io.vcf import read_vcf_sites
from usher_jax.ops.sankoff import assign_states_from_vcf

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")


@pytest.fixture(scope="module")
def mat_pb(tmp_path_factory):
    T = parse_newick(GLOBAL_NH)
    vcf = read_vcf_sites(GLOBAL_VCF)
    assign_states_from_vcf(T, vcf)
    d = tmp_path_factory.mktemp("matutils")
    pb = str(d / "mat.pb")
    T.condense_leaves()
    save_mat_pb(T, pb)
    return pb


def test_summary_console_and_tables(mat_pb, tmp_path, capsys):
    rc = matutils_main(["summary", "-i", mat_pb])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Total Nodes in Tree:" in out
    assert "Total Tree Parsimony:" in out

    rc = matutils_main(["summary", "-i", mat_pb, "-d", str(tmp_path),
                        "-s", "samples.tsv", "-m", "mutations.tsv",
                        "-H", "haplotypes.tsv", "-a", "aberrant.tsv"])
    assert rc == 0
    samples = open(tmp_path / "samples.tsv").read().splitlines()
    assert samples[0] == "sample\tparsimony\tparent_id"
    assert len(samples) > 400
    muts = open(tmp_path / "mutations.tsv").read().splitlines()
    assert muts[0] == "ID\toccurrence"
    assert len(muts) > 100
    assert open(tmp_path / "haplotypes.tsv").read().startswith(
        "mutation_set\tsample_count")


def test_extract_clade_free_outputs(mat_pb, tmp_path):
    T = load_mat_pb(mat_pb)
    some = T.get_leaves_ids()[:20]
    sf = tmp_path / "samples.txt"
    sf.write_text("\n".join(some) + "\n")
    rc = matutils_main([
        "extract", "-i", mat_pb, "-s", str(sf), "-d", str(tmp_path),
        "-t", "sub.nh", "-v", "sub.vcf", "-o", "sub.pb",
        "-u", "used.txt", "-S", "paths.tsv", "--write-diff", "sub.diff",
        "-j", "sub.json"])
    assert rc == 0
    used = open(tmp_path / "used.txt").read().split()
    # the input samples may include condensed-away duplicates; the subtree
    # must contain exactly the requested set
    assert set(used) == set(some)
    sub = parse_newick_string(open(tmp_path / "sub.nh").read().strip())
    assert set(sub.get_leaves_ids()) == set(some)

    # vcf: header + rows parse, genotype columns in DFS order
    lines = open(tmp_path / "sub.vcf").read().splitlines()
    assert lines[0] == "##fileformat=VCFv4.2"
    header = lines[1].split("\t")
    assert header[:9] == ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                          "FILTER", "INFO", "FORMAT"]
    assert set(header[9:]) == set(some)
    for row in lines[2:]:
        fields = row.split("\t")
        assert fields[8] == "GT"
        assert len(fields) == 9 + len(some)
        assert "AC=" in fields[7] and ";AN=" in fields[7]

    # diff: one header per sample
    diff = open(tmp_path / "sub.diff").read()
    assert diff.count(">") == len(some)

    # json: valid auspice v2 with all samples
    doc = json.load(open(tmp_path / "sub.json"))
    assert doc["version"] == "v2"

    def leaves(obj):
        if "children" not in obj:
            return [obj["name"]]
        out = []
        for c in obj["children"]:
            out.extend(leaves(c))
        return out
    assert set(leaves(doc["tree"])) == set(some)

    # pb roundtrip of the subtree
    T2 = load_mat_pb(str(tmp_path / "sub.pb"))
    T2.uncondense_leaves()
    assert set(T2.get_leaves_ids()) == set(some)


def test_extract_vcf_genotypes_roundtrip(mat_pb, tmp_path):
    """VCF written from the full MAT must reconstruct the same genotypes the
    MAT encodes (compareVCF-style oracle)."""
    rc = matutils_main(["extract", "-i", mat_pb, "-d", str(tmp_path),
                        "-v", "all.vcf"])
    assert rc == 0
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    # reconstruct from tree
    recon = {}
    stack = [(T.root, {})]
    while stack:
        node, state = stack.pop()
        if node.mutations:
            state = dict(state)
            for m in node.mutations:
                state[m.position] = (m.ref_nuc, m.mut_nuc)
        if node.is_leaf():
            recon[node.identifier] = state
        for ch in node.children:
            stack.append((ch, state))
    # parse the vcf and compare
    from usher_jax.core.nuc import nuc_id_from_char
    lines = open(tmp_path / "all.vcf").read().splitlines()
    header = lines[1].split("\t")
    names = header[9:]
    checked = 0
    for row in lines[2:]:
        f = row.split("\t")
        pos = int(f[1])
        ref = nuc_id_from_char(f[3])
        alts = [nuc_id_from_char(x) for x in f[4].split(",")]
        codes = [ref] + alts
        for name, gt in zip(names, f[9:]):
            want = recon[name].get(pos, (ref, ref))[1]
            assert codes[int(gt)] == want
            checked += 1
    assert checked > 10000


def test_annotate_by_nid_and_sample_clades(mat_pb, tmp_path):
    T = load_mat_pb(mat_pb)
    # pick an internal node with >10 leaves
    target = next(n for n in T.depth_first_expansion()
                  if not n.is_leaf() and len(T.get_leaves_ids(n.identifier)) > 10
                  and n.parent is not None)
    nid_file = tmp_path / "c2n.tsv"
    nid_file.write_text(f"20A\t{target.identifier}\n")
    out_pb = str(tmp_path / "ann.pb")
    rc = matutils_main(["annotate", "-i", mat_pb, "-o", out_pb,
                        "-C", str(nid_file)])
    assert rc == 0
    T2 = load_mat_pb(out_pb)
    n2 = T2.get_node(target.identifier)
    assert n2 is not None and "20A" in n2.clade_annotations

    # inference mode: members of that clade should map the clade root at (or
    # above) the target node
    T2u = load_mat_pb(out_pb)
    T2u.uncondense_leaves()
    members = [l for l in T2u.get_leaves_ids(target.identifier)][:30]
    cn = tmp_path / "cnames.tsv"
    cn.write_text("".join(f"CLADEX\t{m}\n" for m in members))
    out2 = str(tmp_path / "ann2.pb")
    rc = matutils_main(["annotate", "-i", mat_pb, "-o", out2,
                        "-c", str(cn), "-f", "0.8", "-s", "0.5"])
    assert rc == 0
    T3 = load_mat_pb(out2)
    annotated = [n.identifier for n in T3.depth_first_expansion()
                 if "CLADEX" in n.clade_annotations]
    assert len(annotated) == 1


def test_uncertainty(mat_pb, tmp_path):
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    some = T.get_leaves_ids()[:10]
    sf = tmp_path / "s.txt"
    sf.write_text("\n".join(some) + "\n")
    epps = str(tmp_path / "epps.tsv")
    locs = str(tmp_path / "locs.tsv")
    rc = matutils_main(["uncertainty", "-i", mat_pb, "-s", str(sf),
                        "-e", epps, "-o", locs])
    assert rc == 0
    lines = open(epps).read().splitlines()
    assert lines[0] == ("sample\tequally_parsimonious_placements\t"
                        "neighborhood_size")
    assert len(lines) == 11
    for l in lines[1:]:
        f = l.split("\t")
        assert int(f[1]) >= 1
        assert int(f[2]) >= 0


def test_merge(mat_pb, tmp_path):
    """Split the tree's samples into a base and an extension; merging the
    extension into a pruned base must restore every sample."""
    from usher_jax.matutils.tree_filter import filter_master
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    keep1 = leaves[:-10]  # base: missing last 10
    keep2 = leaves[:50] + leaves[-10:]  # extension: some shared + the 10

    T1 = filter_master(T, keep1, False, True)
    T2 = filter_master(T, keep2, False, True)
    pb1 = str(tmp_path / "t1.pb")
    pb2 = str(tmp_path / "t2.pb")
    save_mat_pb(T1, pb1)
    save_mat_pb(T2, pb2)
    out = str(tmp_path / "merged.pb")
    rc = matutils_main(["merge", "-1", pb1, "-2", pb2, "-o", out])
    assert rc == 0
    M = load_mat_pb(out)
    M.uncondense_leaves()
    assert set(M.get_leaves_ids()) == set(leaves)


def test_mask_rename_and_simplify(mat_pb, tmp_path):
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    name = T.get_leaves_ids()[0]
    rn = tmp_path / "rename.tsv"
    rn.write_text(f"{name}\trenamed_sample_1\n")
    out = str(tmp_path / "masked.pb")
    rc = matutils_main(["mask", "-i", mat_pb, "-o", out, "-r", str(rn)])
    assert rc == 0
    T2 = load_mat_pb(out)
    T2.uncondense_leaves()
    assert T2.get_node("renamed_sample_1") is not None

    out2 = str(tmp_path / "simple.pb")
    rc = matutils_main(["mask", "-i", mat_pb, "-o", out2, "-S"])
    assert rc == 0
    T3 = load_mat_pb(out2)
    assert all(l.identifier.startswith("l") for l in T3.get_leaves())


def test_fix_grandparent_reversion(tmp_path):
    from usher_jax.core.tree import Mutation

    def mk(pos, par, mut):
        return Mutation(chrom="c", position=pos, ref_nuc=par, par_nuc=par,
                        mut_nuc=mut)
    T = Tree()
    root = T.create_node("root")
    a = T.create_node("A", root)       # N > A
    a.mutations = [mk(100, 1, 4)]      # A100G
    b = T.create_node("B", a)          # A > B
    b.mutations = [mk(200, 1, 2)]      # A200C
    r = T.create_node("R", b)          # B > revA (leaf sample)
    r.mutations = [Mutation(chrom="c", position=100, ref_nuc=1, par_nuc=4,
                            mut_nuc=1)]
    T.create_node("L2", b)
    T.create_node("L3", a)
    pb = str(tmp_path / "fix_in.pb")
    out = str(tmp_path / "fix_out.pb")
    save_mat_pb(T, pb)
    rc = matutils_main(["fix", "-i", pb, "-o", out, "-c", "0"])
    assert rc == 0
    T2 = load_mat_pb(out)
    r2 = T2.get_node("R")
    # R moved under root (= A's parent) with B's mutation
    assert r2.parent.parent is None
    assert [m.get_string() for m in r2.mutations] == ["A200C"]


def test_extract_error_on_empty_selection(mat_pb, tmp_path):
    sf = tmp_path / "none.txt"
    sf.write_text("not_a_real_sample\n")
    rc = matutils_main(["extract", "-i", mat_pb, "-s", str(sf),
                        "-d", str(tmp_path), "-t", "x.nh"])
    assert rc == 1


def test_extract_select_nearest_add_random_clades(tmp_path):
    """-Y nearest expansion, -W random padding, --usher-clades-txt,
    --usher-anchor-samples (extract.cpp:103-110, 429-450, 558-583)."""
    import os
    import pytest
    scripts = REFERENCE_SCRIPTS_DIR
    if not os.path.exists(os.path.join(scripts, "testBranchLen2.nwk")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.matutils_cli import main as mu
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(scripts, "testBranchLen2.nwk"),
                       "-v", os.path.join(scripts, "testBranchLen2.vcf"),
                       "-o", pb, "-d", build]) == 0
    samples = tmp_path / "s.txt"
    samples.write_text("a\n")
    anchors = tmp_path / "anchor.txt"
    anchors.write_text("h\n")
    outdir = str(tmp_path / "ex")
    rc = mu(["extract", "-i", pb, "-s", str(samples), "-Y", "2", "-W", "1",
             "-X", "4", "--usher-anchor-samples", str(anchors),
             "-u", "used.txt", "-d", outdir])
    assert rc == 0
    used = open(os.path.join(outdir, "used.txt")).read().split()
    # a + 2 nearest + 1 random = 4 selected samples
    assert "a" in used and len(used) == 4
    # anchor 'h' appears in the single subtree even if not selected
    nh = open(os.path.join(outdir, "single-subtree.nh")).read()
    assert "h" in nh


def test_mask_local_snp_distance(tmp_path):
    """-D local masking: mutations on short paths overlapping nearby
    samples' missing intervals are deleted (mask.cpp:549-632)."""
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.io.pbio import load_mat_pb, save_mat_pb
    from usher_jax.cli.matutils_cli import main as mu
    T = Tree()
    T.create_node("root")
    anc = T.create_node("anc", "root")
    s1 = T.create_node("s1", "anc")
    s2 = T.create_node("s2", "anc")
    far = T.create_node("far", "root")
    # s1 has one mutation at pos 150 (inside s2's missing region)
    s1.add_mutation(Mutation("c", 150, 1, 1, 8))
    s2.add_mutation(Mutation("c", 300, 1, 1, 4))
    for m in range(5):
        far.add_mutation(Mutation("c", 400 + m, 1, 1, 2))
    pb = str(tmp_path / "in.pb")
    save_mat_pb(T, pb)
    diff = tmp_path / "d.diff"
    diff.write_text(">s1\n>s2\n-\t100\t100\n")
    out = str(tmp_path / "out.pb")
    assert mu(["mask", "-i", pb, "-o", out, "-D", "3",
               "-f", str(diff)]) == 0
    T2 = load_mat_pb(out)
    # s1's mutation at 150 lies in s2's missing [100, 200] -> masked
    assert len(T2.get_node("s1").mutations) == 0
    # s2's mutation at 300 is outside -> kept
    assert len(T2.get_node("s2").mutations) == 1
    # far's branch is >= D away -> untouched
    assert len(T2.get_node("far").mutations) == 5


def test_mask_get_closest_samples():
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.matutils.mask import get_closest_samples
    T = Tree()
    T.create_node("root")
    a = T.create_node("a", "root")
    b = T.create_node("b", "root")
    c = T.create_node("c", "root")
    b.add_mutation(Mutation("c", 10, 1, 1, 8))
    for m in range(4):
        c.add_mutation(Mutation("c", 20 + m, 1, 1, 8))
    # from a: b at distance 1, c at distance 4
    assert get_closest_samples(T, "a", 1) == ["b"]
    assert get_closest_samples(T, "a", 4) == ["b", "c"]


def test_annotate_clade_mutations(tmp_path):
    """-M direct clade-mutation assignment incl. lineage inheritance and
    -D details output (annotate.cpp:207-302)."""
    import os
    import pytest
    scripts = REFERENCE_SCRIPTS_DIR
    if not os.path.exists(os.path.join(scripts, "testBranchLen2.nwk")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.matutils_cli import main as mu
    from usher_jax.io.pbio import load_mat_pb
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(scripts, "testBranchLen2.nwk"),
                       "-v", os.path.join(scripts, "testBranchLen2.vcf"),
                       "-o", pb, "-d", build]) == 0
    # clade X = mutations of the a/b/c/d subtree (positions 1-5 shared);
    # clade Y inherits X plus position 6
    cm = tmp_path / "cm.tsv"
    cm.write_text("X\tA1T,A2T A3T,A4T,A5T\nY\tX A6T\n")
    out = str(tmp_path / "ann.pb")
    details = str(tmp_path / "details.tsv")
    rc = mu(["annotate", "-i", pb, "-o", out, "-M", str(cm),
             "-D", details, "-d", str(tmp_path)])
    assert rc == 0
    T = load_mat_pb(out)
    annotated = {c for n in T.depth_first_expansion()
                 for c in n.clade_annotations if c}
    assert "X" in annotated and "Y" in annotated
    dl = open(os.path.join(str(tmp_path), details)).read()
    assert dl.startswith("clade\t")


def test_uncertainty_fisher_test():
    from usher_jax.matutils.uncertainty import _fisher_test
    # symmetric 2x2 with no association -> p == 1
    assert _fisher_test(5, 5, 5, 5) == pytest.approx(1.0, abs=1e-9)
    # strong association -> small p (canonical example: tea-tasting 2x2)
    assert _fisher_test(10, 0, 0, 10) < 1e-4
    # compare against a hand-computed case: a=3,b=1,c=1,d=3
    # N=8, r=4, n=4; p = P(k in {0,1,3,4} pdf<=pdf(1)) = 2*(1+16)/70
    assert _fisher_test(3, 1, 1, 3) == pytest.approx(2 * 17 / 70)


def test_uncertainty_dropout_cli(tmp_path):
    """-d dropout scan runs and emits the reference's column header; a
    synthetic enriched mutation inside a big subtree is detected."""
    import numpy as np
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.io.pbio import save_mat_pb
    from usher_jax.cli.matutils_cli import main as mu
    rng = np.random.default_rng(0)
    T = Tree()
    T.create_node("root")
    hot = T.create_node("hot", "root")
    cold = T.create_node("cold", "root")
    # inside 'hot': 60 leaves, 15 of them carrying A100T plus noise
    for i in range(60):
        n = T.create_node(f"h{i}", "hot")
        if i < 15:
            n.add_mutation(Mutation("c", 100, 1, 1, 8))
        n.add_mutation(Mutation("c", int(rng.integers(200, 1000)), 1, 1, 4))
    # outside: 120 leaves with noise only (A100T absent)
    for i in range(120):
        n = T.create_node(f"c{i}", "cold")
        n.add_mutation(Mutation("c", int(rng.integers(200, 1000)), 1, 1, 4))
    pb = str(tmp_path / "in.pb")
    save_mat_pb(T, pb)
    out = str(tmp_path / "drop.tsv")
    assert mu(["uncertainty", "-i", pb, "-d", out]) == 0
    lines = open(out).read().splitlines()
    assert lines[0].startswith("mutation\tbranch\t")
    assert any(l.startswith("A100T\t") for l in lines[1:])


def test_extract_reroot_reference_rewrite(tmp_path):
    """--write-reroot-reference applies the new root's allele changes to
    the input fasta (filter.cpp:176-212)."""
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.io.pbio import save_mat_pb
    from usher_jax.cli.matutils_cli import main as mu
    T = Tree()
    T.create_node("root")
    mid = T.create_node("mid", "root")
    mid.add_mutation(Mutation("c", 2, 1, 1, 8))  # A2T
    T.create_node("l1", "mid").add_mutation(Mutation("c", 4, 1, 1, 4))
    T.create_node("l2", "mid")
    T.create_node("l3", "root")
    pb = str(tmp_path / "in.pb")
    save_mat_pb(T, pb)
    fa = tmp_path / "ref.fa"
    fa.write_text(">ref\nAAAAA\n")
    outdir = str(tmp_path / "o")
    # internal names become node_N through the pb roundtrip; mid == node_2
    rc = mu(["extract", "-i", pb, "-y", "node_2", "-f", str(fa),
             "--write-reroot-reference", "newref.fa",
             "-t", "t.nh", "-d", outdir])
    assert rc == 0
    content = open(os.path.join(outdir, "newref.fa")).read()
    assert content.splitlines()[1] == "ATAAA"  # A2T applied


def test_summary_pb_direct_byte_identical(tmp_path, mat_pb):
    """matUtils summary --pb-direct (flat arrays, no host tree) must
    byte-match the Tree path for the default summary, -s, -c, -m on the
    smoke MAT (which contains real condensed nodes)."""
    import contextlib
    import io as _io
    from usher_jax.cli.matutils_cli import main as mu_main

    d1 = str(tmp_path / "t")
    d2 = str(tmp_path / "a")
    o1, o2 = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(o1):
        assert mu_main(["summary", "-i", mat_pb, "-d", d1,
                        "-s", "s.tsv", "-c", "c.tsv", "-m", "m.tsv"]) == 0
    with contextlib.redirect_stdout(o2):
        assert mu_main(["summary", "-i", mat_pb, "-d", d2,
                        "--pb-direct",
                        "-s", "s.tsv", "-c", "c.tsv", "-m", "m.tsv"]) == 0
    for fn in ("s.tsv", "c.tsv", "m.tsv"):
        import os
        a = open(os.path.join(d1, fn)).read()
        b = open(os.path.join(d2, fn)).read()
        assert a == b, fn
    # default console summary
    o1, o2 = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(o1):
        assert mu_main(["summary", "-i", mat_pb, "-d", d1]) == 0
    with contextlib.redirect_stdout(o2):
        assert mu_main(["summary", "-i", mat_pb, "-d", d2,
                        "--pb-direct"]) == 0
    assert o1.getvalue() == o2.getvalue()


def test_summary_pb_direct_clades_annotated(tmp_path):
    """clade table parity on an annotated MAT (the smoke MAT carries no
    annotations, so build one)."""
    import io as _io
    from usher_jax.cli.matutils_cli import main as mu_main

    T = parse_newick_string("((A:1,B:1):1,(C:1,D:1):1):0;")
    root = T.root
    root.clade_annotations = ["19A", ""]
    root.children[0].clade_annotations = ["20A", "B.1"]
    root.children[1].clade_annotations = ["20B", ""]
    for n in T.depth_first_expansion():
        if not n.clade_annotations:
            n.clade_annotations = ["", ""]
    pb = str(tmp_path / "ann.pb")
    save_mat_pb(T, pb)
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    assert mu_main(["summary", "-i", pb, "-d", d1, "-c", "c.tsv"]) == 0
    assert mu_main(["summary", "-i", pb, "-d", d2, "--pb-direct",
                    "-c", "c.tsv"]) == 0
    a = open(os.path.join(d1, "c.tsv")).read()
    b = open(os.path.join(d2, "c.tsv")).read()
    assert a == b
    assert "20A" in a and "19A" in a


def test_extract_pb_direct_byte_identical(mat_pb, tmp_path):
    """extract --pb-direct (array selection + induced subtree, no full
    host tree) must byte-match the Tree path's writers for -s and -m
    selections on the smoke MAT."""
    from usher_jax.cli.matutils_cli import main as mu_main

    # pick some sample names from the MAT (including condensed members)
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    chosen = leaves[5:17]
    sf = tmp_path / "names.txt"
    sf.write_text("".join(s + "\n" for s in chosen))

    writers = ["-u", "used.txt", "-t", "t.nh", "-v", "v.vcf",
               "-S", "paths.txt"]
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    assert mu_main(["extract", "-i", mat_pb, "-s", str(sf),
                    "-d", d1] + writers) == 0
    assert mu_main(["extract", "-i", mat_pb, "-s", str(sf),
                    "--pb-direct", "-d", d2] + writers) == 0
    for fn in ("used.txt", "t.nh", "v.vcf", "paths.txt"):
        x = open(os.path.join(d1, fn)).read()
        y = open(os.path.join(d2, fn)).read()
        assert x == y, fn

    # mutation selection
    m = None
    for node in T.depth_first_expansion():
        if node.mutations:
            m = node.mutations[0].get_string()
            break
    d3, d4 = str(tmp_path / "t2"), str(tmp_path / "a2")
    assert mu_main(["extract", "-i", mat_pb, "-m", m,
                    "-d", d3, "-u", "used.txt", "-t", "t.nh"]) == 0
    assert mu_main(["extract", "-i", mat_pb, "-m", m, "--pb-direct",
                    "-d", d4, "-u", "used.txt", "-t", "t.nh"]) == 0
    for fn in ("used.txt", "t.nh"):
        assert open(os.path.join(d3, fn)).read() == \
            open(os.path.join(d4, fn)).read(), fn


def test_extract_pb_direct_clade_selection(tmp_path):
    """-c selection parity over arrays on an annotated MAT."""
    from usher_jax.cli.matutils_cli import main as mu_main
    from usher_jax.core.tree import Mutation

    T = parse_newick_string("((A:1,B:1):1,(C:1,D:1):1):0;")
    pos = {"A": (100, 1, 2), "B": (120, 1, 4), "C": (140, 2, 8),
           "D": (160, 4, 1)}
    for leaf, (p, par, mut) in pos.items():
        T.get_node(leaf).add_mutation(Mutation("c", p, par, par, mut))
    for n in T.depth_first_expansion():
        n.clade_annotations = [""]
    T.root.children[0].clade_annotations = ["20A"]
    pb = str(tmp_path / "ann.pb")
    save_mat_pb(T, pb)

    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    w = ["-u", "used.txt", "-t", "t.nh", "-S", "p.txt"]
    assert mu_main(["extract", "-i", pb, "-c", "20A", "-d", d1] + w) == 0
    assert mu_main(["extract", "-i", pb, "-c", "20A", "--pb-direct",
                    "-d", d2] + w) == 0
    for fn in ("used.txt", "t.nh", "p.txt"):
        assert open(os.path.join(d1, fn)).read() == \
            open(os.path.join(d2, fn)).read(), fn
    assert open(os.path.join(d2, "used.txt")).read() == "A\nB\n"


def test_extract_pb_direct_all_leaves_verbatim(mat_pb, tmp_path):
    """Selecting every leaf must reproduce the tree path's unchanged-tree
    behavior (filter_master returns T when the selection covers all
    leaves) — the verbatim prune-semantics builder, not the compressed
    subtree."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    sf = tmp_path / "all.txt"
    sf.write_text("".join(s + "\n" for s in T.get_leaves_ids()))
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    w = ["-u", "used.txt", "-t", "t.nh"]
    assert mu_main(["extract", "-i", mat_pb, "-s", str(sf),
                    "-d", d1] + w) == 0
    assert mu_main(["extract", "-i", mat_pb, "-s", str(sf),
                    "--pb-direct", "-d", d2] + w) == 0
    for fn in ("used.txt", "t.nh"):
        assert open(os.path.join(d1, fn)).read() == \
            open(os.path.join(d2, fn)).read(), fn


def test_extract_pb_direct_large_selection_prune_semantics(tmp_path):
    """Selections >= 10000 samples must reproduce get_sample_prune
    semantics (unary chains and original structure retained), matching
    filter_master's size dispatch — not the compressed subtree."""
    import numpy as np
    from usher_jax.cli.matutils_cli import main as mu_main
    from usher_jax.core.tree import Mutation, Tree

    rng = np.random.default_rng(2)
    T = Tree()
    T.create_node("root")
    names = ["root"]
    bases = [1, 2, 4, 8]
    for i in range(24000):
        parent = names[int(rng.integers(len(names)))]
        nid = f"L{i}"
        node = T.create_node(nid, parent)
        p = 100 + int(rng.integers(500))
        par = bases[int(rng.integers(4))]
        mut = bases[(bases.index(par) + 1) % 4]
        node.add_mutation(Mutation("c", p, par, par, mut))
        names.append(nid)
    pb = str(tmp_path / "big.pb")
    save_mat_pb(T, pb)

    T2 = load_mat_pb(pb)
    T2.uncondense_leaves()
    leaves = T2.get_leaves_ids()
    assert len(leaves) > 11000
    chosen = leaves[:10500]
    sf = tmp_path / "names.txt"
    sf.write_text("".join(s + "\n" for s in chosen))
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    w = ["-u", "used.txt", "-t", "t.nh"]
    assert mu_main(["extract", "-i", pb, "-s", str(sf), "-d", d1] + w) == 0
    assert mu_main(["extract", "-i", pb, "-s", str(sf), "--pb-direct",
                    "-d", d2] + w) == 0
    for fn in ("used.txt", "t.nh"):
        assert open(os.path.join(d1, fn)).read() == \
            open(os.path.join(d2, fn)).read(), fn


def test_mask_rename_pb_direct_byte_identical(mat_pb, tmp_path):
    """mask -r --pb-direct (names-blob surgery, no host tree) must
    byte-match the Tree path's renamed pb."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    leaves = [l for l in T.get_leaves_ids()][:4]
    rn = tmp_path / "rename.tsv"
    rn.write_text("".join(f"{s}\tRENAMED_{k}\n"
                          for k, s in enumerate(leaves))
                  + "NOSUCH\tX\n")
    o1, o2 = str(tmp_path / "t.pb"), str(tmp_path / "a.pb")
    assert mu_main(["mask", "-i", mat_pb, "-o", o1,
                    "-r", str(rn)]) == 0
    assert mu_main(["mask", "-i", mat_pb, "-o", o2, "--pb-direct",
                    "-r", str(rn)]) == 0
    assert open(o1, "rb").read() == open(o2, "rb").read()


def test_mask_rename_pb_direct_collision_raises(mat_pb, tmp_path):
    """Renaming onto an existing node name must fail like the Tree path
    (rename_node's ValueError), not silently emit a duplicate-name MAT."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    a, b = T.get_leaves_ids()[:2]
    rn = tmp_path / "r.tsv"
    rn.write_text(f"{a}\t{b}\n")
    # matutils_cli.main catches ValueError and exits 1 (both paths)
    assert mu_main(["mask", "-i", mat_pb, "-o", str(tmp_path / "o.pb"),
                    "--pb-direct", "-r", str(rn)]) == 1
    assert mu_main(["mask", "-i", mat_pb, "-o", str(tmp_path / "o2.pb"),
                    "-r", str(rn)]) == 1
    assert not (tmp_path / "o.pb").exists()


def test_annotate_nid_pb_direct_byte_identical(mat_pb, tmp_path):
    """annotate -C --pb-direct (annotation-blob surgery) must byte-match
    the Tree path, including append-vs-clear column behavior and the
    already-assigned warning."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    internal = [n.identifier for n in T.depth_first_expansion()
                if not n.is_leaf()][1:4]
    cn = tmp_path / "c.tsv"
    cn.write_text(f"20A\t{internal[0]}\n20B\t{internal[1]}\n"
                  f"DUP\t{internal[0]}\n")
    for clear in ([], ["-l"]):
        o1 = str(tmp_path / f"t{len(clear)}.pb")
        o2 = str(tmp_path / f"a{len(clear)}.pb")
        assert mu_main(["annotate", "-i", mat_pb, "-o", o1,
                        "-C", str(cn)] + clear) == 0
        assert mu_main(["annotate", "-i", mat_pb, "-o", o2, "--pb-direct",
                        "-C", str(cn)] + clear) == 0
        assert open(o1, "rb").read() == open(o2, "rb").read(), clear
    # missing node errors identically (rc 1 via the CLI's KeyError catch)
    cn.write_text("X\tNOSUCHNODE\n")
    assert mu_main(["annotate", "-i", mat_pb,
                    "-o", str(tmp_path / "x.pb"), "--pb-direct",
                    "-C", str(cn)]) == 1


def test_uncertainty_pb_direct_byte_identical(mat_pb, tmp_path):
    """uncertainty --pb-direct (array placement with self-exclusion via
    the runner-up reduce) must byte-match the Tree path's EPP and
    placement-location tables on the condensed smoke MAT."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    chosen = leaves[3:40:3] + ["NOSUCHSAMPLE"]
    sf = tmp_path / "s.txt"
    sf.write_text("".join(s + "\n" for s in chosen))
    d1, d2 = tmp_path / "t", tmp_path / "a"
    d1.mkdir(); d2.mkdir()
    assert mu_main(["uncertainty", "-i", mat_pb, "-s", str(sf),
                    "-e", str(d1 / "epps.tsv"),
                    "-o", str(d1 / "locs.tsv")]) == 0
    assert mu_main(["uncertainty", "-i", mat_pb, "-s", str(sf),
                    "--pb-direct",
                    "-e", str(d2 / "epps.tsv"),
                    "-o", str(d2 / "locs.tsv")]) == 0
    for fn in ("epps.tsv", "locs.tsv"):
        x = (d1 / fn).read_text()
        y = (d2 / fn).read_text()
        assert x == y, fn
    body = (d2 / "epps.tsv").read_text().splitlines()[1:]
    assert body and any(int(l.split("\t")[1]) >= 1 for l in body)


def test_extract_pb_direct_filters_byte_identical(mat_pb, tmp_path):
    """-e/-a/-b/-P selection filters over arrays must byte-match the
    Tree path's extract outputs."""
    from usher_jax.cli.matutils_cli import main as mu_main
    for flags in (["-a", "1"], ["-b", "2"], ["-P", "3"],
                  ["-e", "1", "-a", "2"]):
        tag = "".join(flags)
        d1 = str(tmp_path / ("t" + tag))
        d2 = str(tmp_path / ("a" + tag))
        w = ["-u", "used.txt", "-t", "t.nh"]
        r1 = mu_main(["extract", "-i", mat_pb, "-d", d1] + flags + w)
        r2 = mu_main(["extract", "-i", mat_pb, "-d", d2,
                      "--pb-direct"] + flags + w)
        assert r1 == r2, flags
        if r1 != 0:
            continue
        for fn in ("used.txt", "t.nh"):
            x = open(os.path.join(d1, fn)).read()
            y = open(os.path.join(d2, fn)).read()
            assert x == y, (fn, flags)


def test_extract_pb_direct_match_descendents_mrca(mat_pb, tmp_path):
    """-H regex, -I internal-descendants, and -U from-MRCA selection
    parity over arrays."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    internal = [n.identifier for n in T.depth_first_expansion()
                if not n.is_leaf() and len(n.children) > 1][2]
    leaves = T.get_leaves_ids()
    sf = tmp_path / "n.txt"
    sf.write_text("".join(s + "\n" for s in leaves[4:8]))
    for flags in (["-H", "Wuhan"], ["-I", internal],
                  ["-s", str(sf), "-U"]):
        tag = "".join(flags)[:12].replace("/", "_")
        d1 = str(tmp_path / ("t" + tag))
        d2 = str(tmp_path / ("a" + tag))
        w = ["-u", "used.txt", "-t", "t.nh"]
        assert mu_main(["extract", "-i", mat_pb, "-d", d1] + flags + w) == 0
        assert mu_main(["extract", "-i", mat_pb, "-d", d2,
                        "--pb-direct"] + flags + w) == 0
        for fn in ("used.txt", "t.nh"):
            x = open(os.path.join(d1, fn)).read()
            y = open(os.path.join(d2, fn)).read()
            assert x == y, (fn, flags)


def test_extract_pb_direct_density_filter(mat_pb, tmp_path):
    """--max-mutation-density parity over arrays (applied after the
    branch/path filters and before -U, like select_samples)."""
    from usher_jax.cli.matutils_cli import main as mu_main
    for flags in (["-H", "Wuhan", "--max-mutation-density", "1.5"],
                  ["-a", "2", "--max-mutation-density", "2.5", "-U"]):
        tag = str(len(flags))
        d1 = str(tmp_path / ("t" + tag))
        d2 = str(tmp_path / ("a" + tag))
        w = ["-u", "used.txt", "-t", "t.nh"]
        r1 = mu_main(["extract", "-i", mat_pb, "-d", d1] + flags + w)
        r2 = mu_main(["extract", "-i", mat_pb, "-d", d2,
                      "--pb-direct"] + flags + w)
        assert r1 == r2, flags
        if r1 != 0:
            continue
        for fn in ("used.txt", "t.nh"):
            assert open(os.path.join(d1, fn)).read() == \
                open(os.path.join(d2, fn)).read(), (fn, flags)


def test_extract_pb_direct_nearest_and_random(mat_pb, tmp_path):
    """-k nearest and -z/-W/-Z random fill parity over arrays (the random
    pool is BFS leaf order, so draws match the Tree path seed-for-seed)."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaf = T.get_leaves_ids()[10]
    sf = tmp_path / "n.txt"
    sf.write_text("".join(s + "\n" for s in T.get_leaves_ids()[4:8]))
    for flags in ([f"-k", f"{leaf}:5"],
                  ["-s", str(sf), "-z", "12"],
                  ["-s", str(sf), "-W", "6", "-Z"],
                  [f"-k", f"{leaf}:4", "-z", "2"]):
        tag = "".join(flags)[-10:].replace("/", "_").replace(":", "_")
        d1 = str(tmp_path / ("t" + tag))
        d2 = str(tmp_path / ("a" + tag))
        w = ["-u", "used.txt", "-t", "t.nh"]
        assert mu_main(["extract", "-i", mat_pb, "-d", d1] + flags + w) \
            == 0, flags
        assert mu_main(["extract", "-i", mat_pb, "-d", d2,
                        "--pb-direct"] + flags + w) == 0, flags
        for fn in ("used.txt", "t.nh"):
            assert open(os.path.join(d1, fn)).read() == \
                open(os.path.join(d2, fn)).read(), (fn, flags)


def test_extract_pb_direct_select_nearest(mat_pb, tmp_path):
    """-Y (nearest expansion per selected sample) parity over arrays."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    sf = tmp_path / "n.txt"
    sf.write_text("".join(s + "\n" for s in T.get_leaves_ids()[6:9]))
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    w = ["-u", "used.txt", "-t", "t.nh"]
    flags = ["-s", str(sf), "-Y", "3"]
    assert mu_main(["extract", "-i", mat_pb, "-d", d1] + flags + w) == 0
    assert mu_main(["extract", "-i", mat_pb, "-d", d2,
                    "--pb-direct"] + flags + w) == 0
    for fn in ("used.txt", "t.nh"):
        assert open(os.path.join(d1, fn)).read() == \
            open(os.path.join(d2, fn)).read(), fn


def test_extract_pb_direct_zshrink_order_parity(mat_pb, tmp_path):
    """-z SHRINK composed with every selection source must match the
    Tree path seed-for-seed — the rng indexes into the selection list,
    so leaf enumeration ORDER (BFS, per-carrier vs global) is part of
    the contract (review-confirmed regression)."""
    from usher_jax.cli.matutils_cli import main as mu_main
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    internal = [n.identifier for n in T.depth_first_expansion()
                if not n.is_leaf() and len(n.children) > 1][2]
    m = None
    for node in T.depth_first_expansion():
        if node.mutations:
            m = node.mutations[0].get_string()
            break
    sf = tmp_path / "n.txt"
    sf.write_text("".join(s + "\n" for s in T.get_leaves_ids()[4:8]))
    cases = (["-a", "2", "-z", "3"], ["-I", internal, "-z", "3"],
             ["-s", str(sf), "-U", "-z", "3"], ["-m", m, "-z", "3"],
             ["-z", "5"], ["-W", "4", "-s", str(sf)])
    for k, flags in enumerate(cases):
        d1 = str(tmp_path / f"t{k}")
        d2 = str(tmp_path / f"a{k}")
        w = ["-u", "used.txt", "-t", "t.nh"]
        assert mu_main(["extract", "-i", mat_pb, "-d", d1] + flags + w) \
            == 0, flags
        assert mu_main(["extract", "-i", mat_pb, "-d", d2,
                        "--pb-direct"] + flags + w) == 0, flags
        for fn in ("used.txt", "t.nh"):
            assert open(os.path.join(d1, fn)).read() == \
                open(os.path.join(d2, fn)).read(), (fn, flags)


def _leaf_dist(T, a, b):
    """Brute-force leaf-to-leaf mutation-path distance through the LCA."""
    na, nb = T.get_node(a), T.get_node(b)
    x, y = na, nb
    while x.level > y.level:
        x = x.parent
    while y.level > x.level:
        y = y.parent
    while x is not y:
        x = x.parent
        y = y.parent
    lca = x
    d = 0
    for n in (na, nb):
        cur = n
        while cur is not lca:
            d += len(cur.mutations)
            cur = cur.parent
    return d


def test_extract_closest_relatives(mat_pb, tmp_path):
    """-V/-q rows match a brute-force all-pairs closest computation
    (reference select.cpp:596-713 via extract.cpp:768-806)."""
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    sel = leaves[5:11]
    sf = tmp_path / "sel.txt"
    sf.write_text("".join(s + "\n" for s in sel))
    rc = matutils_main(["extract", "-i", mat_pb, "-s", str(sf),
                        "-d", str(tmp_path), "-V", "rel.tsv",
                        "-u", "u.txt"])
    assert rc == 0
    rows = {}
    for line in open(tmp_path / "rel.tsv").read().splitlines():
        name, rels, dist = line.split("\t")
        rows[name] = (set(rels.split(",")), int(dist))
    for s in sel:
        dists = [(_leaf_dist(T, s, o), o) for o in leaves if o != s]
        dmin = min(d for d, _ in dists)
        expect = {o for d, o in dists if d == dmin}
        assert s in rows
        got, gdist = rows[s]
        assert gdist == dmin, s
        assert got == expect, s

    # -q: exactly one relative, the lexicographically smallest
    rc = matutils_main(["extract", "-i", mat_pb, "-s", str(sf),
                        "-d", str(tmp_path), "-V", "rel1.tsv", "-q",
                        "-u", "u.txt"])
    assert rc == 0
    for line in open(tmp_path / "rel1.tsv").read().splitlines():
        name, rels, dist = line.split("\t")
        assert "," not in rels
        assert rels == min(rows[name][0])


def test_extract_within_distance(mat_pb, tmp_path):
    """--within-distance returns exactly the leaves within the threshold."""
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    sel = leaves[20:24]
    sf = tmp_path / "sel.txt"
    sf.write_text("".join(s + "\n" for s in sel))
    thresh = 6
    rc = matutils_main(["extract", "-i", mat_pb, "-s", str(sf),
                        "-d", str(tmp_path), "--within-distance", "wd.tsv",
                        "--distance-threshold", str(thresh),
                        "-u", "u.txt"])
    assert rc == 0
    rows = {}
    for line in open(tmp_path / "wd.tsv").read().splitlines():
        parts = line.split("\t")
        rows[parts[0]] = (set(parts[1].split(","))
                          if len(parts) > 1 and parts[1] else set())
    for s in sel:
        expect = {o for o in leaves
                  if o != s and _leaf_dist(T, s, o) <= thresh}
        assert rows[s] == expect, s


def test_extract_whitelist_metadata_dump(mat_pb, tmp_path):
    """-L forces retention; -Q dumps metadata rows for the final selection
    with 'missing' for absent values; --load-all-metadata keeps unselected
    rows available to the json writers."""
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    sel, wl = leaves[:3], leaves[10:12]
    sf = tmp_path / "sel.txt"
    sf.write_text("".join(s + "\n" for s in sel))
    wf = tmp_path / "wl.txt"
    wf.write_text("".join(s + "\n" for s in wl) + "no_such_sample\n")
    meta = tmp_path / "meta.tsv"
    meta.write_text("strain\tcountry\tlineage\n"
                    f"{sel[0]}\tUK\tB.1\n"
                    f"{wl[0]}\tUS\tB.2\n"
                    f"{leaves[40]}\tDE\tB.3\n")
    rc = matutils_main(["extract", "-i", mat_pb, "-s", str(sf),
                        "-L", str(wf), "-d", str(tmp_path),
                        "-M", str(meta), "-Q", "dump.tsv",
                        "-u", "used.txt"])
    assert rc == 0
    used = set(open(tmp_path / "used.txt").read().split())
    assert used == set(sel) | set(wl)
    lines = open(tmp_path / "dump.tsv").read().splitlines()
    assert lines[0] == "strain\tcountry\tlineage"
    vals = {l.split("\t")[0]: l.split("\t")[1:] for l in lines[1:]}
    assert set(vals) == set(sel) | set(wl)
    assert vals[sel[0]] == ["UK", "B.1"]
    assert vals[wl[0]] == ["US", "B.2"]
    assert vals[sel[1]] == ["missing", "missing"]


def test_extract_nearest_k_batch(mat_pb, tmp_path):
    """-K file:k writes one context json per listed sample
    (extract.cpp:731-767)."""
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    batch = leaves[30:33]
    bf = tmp_path / "batch.txt"
    bf.write_text("".join(s + "\n" for s in batch))
    rc = matutils_main(["extract", "-i", mat_pb, "-d", str(tmp_path),
                        "-K", f"{bf}:4", "-s", str(bf),
                        "-u", "u.txt"])
    assert rc == 0
    for s in batch:
        path = tmp_path / (s.replace("/", "_") + "_context.json")
        assert path.exists(), s
        data = json.loads(open(path).read())
        assert data  # non-empty auspice json


def test_merge_max_depth(mat_pb, tmp_path):
    """-d bounds the merge search to the consistent anchor's subtree; all
    samples still merge (at worst onto the anchor itself)."""
    from usher_jax.matutils.tree_filter import filter_master
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    keep1 = leaves[:-10]
    keep2 = leaves[:50] + leaves[-10:]
    T1 = filter_master(T, keep1, False, True)
    T2 = filter_master(T, keep2, False, True)
    pb1, pb2 = str(tmp_path / "t1.pb"), str(tmp_path / "t2.pb")
    save_mat_pb(T1, pb1)
    save_mat_pb(T2, pb2)
    for d in (1, 3):
        out = str(tmp_path / f"merged_{d}.pb")
        rc = matutils_main(["merge", "-1", pb1, "-2", pb2, "-o", out,
                            "-d", str(d)])
        assert rc == 0
        M = load_mat_pb(out)
        M.uncondense_leaves()
        assert set(M.get_leaves_ids()) == set(leaves)


def test_whole_mat_vcf_diff_arrays_parity(mat_pb, tmp_path):
    """Whole-MAT extract -v / --write-diff under --pb-direct (no
    selection) must byte-match the Tree writers on the uncondensed
    fixture MAT (convert.cpp:294, :325)."""
    from usher_jax.matutils.convert import make_vcf, make_diff
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    v1 = str(tmp_path / "t.vcf")
    d1 = str(tmp_path / "t.diff")
    make_vcf(T, v1)
    make_diff(T, d1)
    rc = matutils_main(["extract", "-i", mat_pb, "--pb-direct",
                        "-d", str(tmp_path / "a"), "-v", "a.vcf",
                        "--write-diff", "a.diff"])
    assert rc == 0
    assert open(v1).read() == open(tmp_path / "a" / "a.vcf").read()
    assert open(d1).read() == open(tmp_path / "a" / "a.diff").read()
    # -n no-genotypes variant
    v2 = str(tmp_path / "t2.vcf")
    make_vcf(T, v2, no_genotypes=True)
    rc = matutils_main(["extract", "-i", mat_pb, "--pb-direct",
                        "-d", str(tmp_path / "b"), "-v", "b.vcf", "-n"])
    assert rc == 0
    assert open(v2).read() == open(tmp_path / "b" / "b.vcf").read()


def test_whole_mat_json_arrays_parity(mat_pb, tmp_path):
    """Whole-MAT extract -j under --pb-direct (no selection) must
    byte-match the Tree JSON writer incl. metadata and annotated-clade
    columns (convert.cpp:585-663)."""
    from usher_jax.matutils.convert import write_json_from_mat, \
        read_metafile
    # annotate a copy so MAT_Clade columns are exercised
    T = load_mat_pb(mat_pb)
    for i, n in enumerate(T.depth_first_expansion()):
        n.clade_annotations = [f"C{i % 4}" if i % 7 == 0 else ""]
    pb2 = str(tmp_path / "ann.pb")
    save_mat_pb(T, pb2)
    T2 = load_mat_pb(pb2)
    T2.uncondense_leaves()
    leaves = T2.get_leaves_ids()
    meta = tmp_path / "meta.tsv"
    meta.write_text("strain\tcountry\n"
                    + "".join(f"{s}\tC{i % 3}\n"
                              for i, s in enumerate(leaves[:40])))
    metadata = read_metafile(str(meta), samples_to_use=set(leaves))
    j1 = str(tmp_path / "t.json")
    write_json_from_mat(T2, j1, title="ttl", metadata=metadata)
    rc = matutils_main(["extract", "-i", pb2, "--pb-direct",
                        "-d", str(tmp_path / "a"), "-j", "a.json",
                        "-M", str(meta), "-B", "ttl"])
    assert rc == 0
    assert open(j1).read() == open(tmp_path / "a" / "a.json").read()


def test_merge_arrays_parity(mat_pb, tmp_path):
    """--pb-direct merge must byte-match the Tree merge on the same
    inputs (merge.cpp:125 semantics; placement/apply/save run on the
    parity-proven direct machinery)."""
    from usher_jax.matutils.tree_filter import filter_master
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    keep1 = leaves[:-10]
    keep2 = leaves[:50] + leaves[-10:]
    T1 = filter_master(T, keep1, False, True)
    T2 = filter_master(T, keep2, False, True)
    pb1, pb2 = str(tmp_path / "t1.pb"), str(tmp_path / "t2.pb")
    save_mat_pb(T1, pb1)
    save_mat_pb(T2, pb2)
    for d in (20, 2):
        out_t = str(tmp_path / f"mt_{d}.pb")
        out_a = str(tmp_path / f"ma_{d}.pb")
        assert matutils_main(["merge", "-1", pb1, "-2", pb2,
                              "-o", out_t, "-d", str(d)]) == 0
        assert matutils_main(["merge", "-1", pb1, "-2", pb2, "--pb-direct",
                              "-o", out_a, "-d", str(d)]) == 0
        tb = open(out_t, "rb").read()
        ab = open(out_a, "rb").read()
        assert tb == ab, f"merged pb differs at max_depth={d}"


def test_merge_arrays_parity_novel_positions(mat_pb, tmp_path):
    """New samples carrying mutations at positions the base never saw
    (extra-position seeding), plus sibling new samples under one parent
    (in-batch touched/stale handling)."""
    from usher_jax.core.tree import Mutation
    from usher_jax.matutils.tree_filter import filter_master
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    keep1 = leaves[:-12]
    keep2 = leaves[:40] + leaves[-12:]
    T1 = filter_master(T, keep1, False, True)
    T2 = filter_master(T, keep2, False, True)
    # novel positions on a few new samples (absent from the base MAT);
    # single chromosome, like every real MAT (the arrays model stores one
    # chrom for the whole MAT where the pb stores one per mutation)
    for k, nm in enumerate(leaves[-12:-8]):
        n = T2.get_node(nm)
        if n is not None:
            n.add_mutation(Mutation("NC_045512v2", 900000 + k, 1, 1, 4))
    pb1, pb2 = str(tmp_path / "t1.pb"), str(tmp_path / "t2.pb")
    save_mat_pb(T1, pb1)
    save_mat_pb(T2, pb2)
    out_t = str(tmp_path / "mt.pb")
    out_a = str(tmp_path / "ma.pb")
    assert matutils_main(["merge", "-1", pb1, "-2", pb2,
                          "-o", out_t]) == 0
    assert matutils_main(["merge", "-1", pb1, "-2", pb2, "--pb-direct",
                          "-o", out_a]) == 0
    assert open(out_t, "rb").read() == open(out_a, "rb").read()


def test_find_epps_grouped_matches_plain(mat_pb, monkeypatch):
    """uncertainty's bulk re-scoring must be identical whether the
    shared-ancestry grouped engine or plain scoring runs underneath."""
    from usher_jax.io.pb_arrays import load_mat_arrays
    from usher_jax.matutils.arrays import find_epps
    ma = load_mat_arrays(mat_pb)
    T = load_mat_pb(mat_pb)
    T.uncondense_leaves()
    samples = T.get_leaves_ids()[:60]
    monkeypatch.setenv("USHER_JAX_GROUPED", "1")
    r_grp = find_epps(ma, samples)
    monkeypatch.setenv("USHER_JAX_GROUPED", "0")
    r_plain = find_epps(ma, samples)
    assert r_grp == r_plain

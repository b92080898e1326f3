"""End-to-end smoke: the reference's canonical workflow on its own fixtures.

  1) build a MAT from test/global_phylo.nh + test/global_samples.vcf, save .pb
  2) load the .pb and place test/new_samples.vcf (5 samples)

Oracles (SURVEY.md section 4): genotype reconstruction for every sample
(check_samples equivalence), parsimony-score consistency, output files
produced and well-formed, pb roundtrip stability.
"""

import os

import pytest

from usher_jax.cli.usher_cli import main as usher_main
from usher_jax.core.tree import Tree
from usher_jax.io.newick import parse_newick_string
from usher_jax.io.pbio import load_mat_pb
from usher_jax.io.vcf import read_vcf_sites

from conftest import REFERENCE_TEST_DIR

pytestmark = pytest.mark.skipif(not os.path.isdir(REFERENCE_TEST_DIR),
                                reason="reference test data unavailable")

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")


def reconstruct_leaf_states(T):
    out = {}
    stack = [(T.root, {})]
    while stack:
        node, state = stack.pop()
        if node.mutations:
            state = dict(state)
            for m in node.mutations:
                state[m.position] = m.mut_nuc
        if node.is_leaf():
            out[node.identifier] = state
        for ch in node.children:
            stack.append((ch, state))
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("usher_build"))
    pb = os.path.join(outdir, "out.pb")
    rc = usher_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb, "-d", outdir])
    assert rc == 0
    return outdir, pb


def test_build_outputs_exist(built):
    outdir, pb = built
    assert os.path.exists(os.path.join(outdir, "final-tree.nh"))
    # all 422 VCF samples are tree leaves -> no missing samples -> the
    # reference produces no placement_stats.tsv in this run either
    assert os.path.exists(pb)


def test_build_genotype_reconstruction_oracle(built):
    outdir, pb = built
    T = load_mat_pb(pb)
    T.uncondense_leaves()
    vcf = read_vcf_sites(GLOBAL_VCF)
    recon = reconstruct_leaf_states(T)
    leaf_ids = set(T.get_leaves_ids())
    checked = 0
    for site in vcf.sites:
        variant_by_col = {j: nuc for j, nuc in site.variants}
        for j, name in enumerate(vcf.sample_ids):
            if name not in leaf_ids:
                continue
            mask = variant_by_col.get(j, site.ref_nuc)
            got = recon[name].get(site.position, site.ref_nuc)
            assert got & mask, (
                f"{name}@{site.position}: reconstructed {got:04b} vs mask {mask:04b}")
            checked += 1
    assert checked > 100_000  # 422 samples x 423 sites


def test_build_final_tree_parseable_and_leafset(built):
    outdir, pb = built
    with open(os.path.join(outdir, "final-tree.nh")) as f:
        s = f.read()
    assert s.endswith(";")  # no trailing newline, like the reference
    T = parse_newick_string(s)
    orig = parse_newick_string(open(GLOBAL_NH).readline())
    assert set(T.get_leaves_ids()) == set(orig.get_leaves_ids())


def test_placement_of_new_samples(built, tmp_path):
    outdir, pb = built
    outdir2 = str(tmp_path / "place")
    pb2 = os.path.join(outdir2, "out2.pb")
    rc = usher_main(["-i", pb, "-v", NEW_VCF, "-o", pb2, "-d", outdir2])
    assert rc == 0

    stats = open(os.path.join(outdir2, "placement_stats.tsv")).read().strip().split("\n")
    assert len(stats) == 5
    names = [l.split("\t")[0] for l in stats]
    assert names == ["Sample1", "Sample2", "Sample3", "Sample4", "Sample5"]
    for line in stats:
        fields = line.split("\t")
        par = int(fields[1])
        epp = int(fields[2])
        assert 0 <= par <= 10
        assert epp >= 1

    # mutation paths present for all placed samples
    mp = open(os.path.join(outdir2, "mutation-paths.txt")).read().strip().split("\n")
    assert len(mp) == 5

    # every placed sample's reconstructed genotype must match its VCF entries
    T = load_mat_pb(pb2)
    T.uncondense_leaves()
    vcf = read_vcf_sites(NEW_VCF)
    recon = reconstruct_leaf_states(T)
    for site in vcf.sites:
        variant_by_col = {j: nuc for j, nuc in site.variants}
        for j, name in enumerate(vcf.sample_ids):
            assert name in recon, f"sample {name} missing from result tree"
            mask = variant_by_col.get(j, site.ref_nuc)
            got = recon[name].get(site.position, site.ref_nuc)
            assert got & mask, (
                f"{name}@{site.position}: {got:04b} vs mask {mask:04b}")


def test_placement_parsimony_scores_mode(built, tmp_path):
    outdir, pb = built
    outdir2 = str(tmp_path / "pmode")
    rc = usher_main(["-i", pb, "-v", NEW_VCF, "-d", outdir2, "-p"])
    assert rc == 0
    path = os.path.join(outdir2, "parsimony-scores.tsv")
    lines = open(path).read().strip().split("\n")
    assert lines[0].startswith("#Sample\tTree node\tParsimony score")
    body = [l for l in lines[1:] if l]
    # every sample x every node gets a row
    T = load_mat_pb(pb)
    n_nodes = len(T.depth_first_expansion())
    assert len(body) == 5 * n_nodes
    # each sample has at least one optimal row and optima agree with min
    import collections
    per_sample = collections.defaultdict(list)
    for l in body:
        f = l.split("\t")
        per_sample[f[0]].append((int(f[2]), f[4]))
    for name, rows in per_sample.items():
        best = min(r[0] for r in rows)
        assert all((r[1] == "y") == (r[0] == best) for r in rows)


def test_placement_subtree_outputs(built, tmp_path):
    """-k/-K subtree writers produce well-formed newick + mutation lists
    (reference get_random_single_subtree / get_random_sample_subtrees,
    mutation_annotated_tree.cpp:1693-1990)."""
    outdir, pb = built
    outdir2 = str(tmp_path / "subtrees")
    rc = usher_main(["-i", pb, "-v", NEW_VCF, "-d", outdir2,
                     "-k", "20", "-K", "50"])
    assert rc == 0

    single = os.path.join(outdir2, "single-subtree.nh")
    assert os.path.exists(single)
    sT = parse_newick_string(open(single).read())
    leaves = set(sT.get_leaves_ids())
    for name in ["Sample1", "Sample2", "Sample3", "Sample4", "Sample5"]:
        assert name in leaves
    assert len(leaves) >= 50
    assert os.path.exists(os.path.join(outdir2, "single-subtree-mutations.txt"))

    # -k: at least one numbered subtree containing Sample1
    sub1 = os.path.join(outdir2, "subtree-1.nh")
    assert os.path.exists(sub1)
    t1 = parse_newick_string(open(sub1).read())
    sub_leaves = set(t1.get_leaves_ids())
    assert any(f"Sample{i}" in sub_leaves for i in range(1, 6))
    assert len(sub_leaves) <= 21
    muts1 = open(os.path.join(outdir2, "subtree-1-mutations.txt")).read()
    assert ": " in muts1


def test_batched_placement_equals_sequential(built, tmp_path):
    """Batched scoring with the staleness discipline must reproduce the
    sequential reference semantics byte-for-byte (placement_stats.tsv and
    final-tree.nh identical at batch_size 1 vs 64)."""
    outdir, pb = built
    out_seq = str(tmp_path / "seq")
    out_bat = str(tmp_path / "bat")
    rc = usher_main(["-i", pb, "-v", NEW_VCF, "-d", out_seq,
                     "--batch-size", "1"])
    assert rc == 0
    rc = usher_main(["-i", pb, "-v", NEW_VCF, "-d", out_bat,
                     "--batch-size", "64"])
    assert rc == 0
    for fname in ["placement_stats.tsv", "final-tree.nh",
                  "mutation-paths.txt"]:
        a = open(os.path.join(out_seq, fname), "rb").read()
        b = open(os.path.join(out_bat, fname), "rb").read()
        assert a == b, f"{fname} differs between batch sizes"


def test_placement_matches_committed_goldens(built, tmp_path):
    """Byte-level goldens for the canonical smoke workload (SURVEY §4
    oracles).  The golden files were produced by a verified device run and are
    committed; any engine change that shifts placement output fails here."""
    outdir, pb = built
    outdir2 = str(tmp_path / "golden_place")
    rc = usher_main(["-i", pb, "-v", NEW_VCF, "-o",
                     os.path.join(outdir2, "o.pb"), "-d", outdir2])
    assert rc == 0
    gold = os.path.join(os.path.dirname(__file__), "goldens")
    for fname, gname in [("placement_stats.tsv", "smoke_placement_stats.tsv"),
                         ("final-tree.nh", "smoke_final_tree.nh"),
                         ("mutation-paths.txt", "smoke_mutation_paths.txt")]:
        got = open(os.path.join(outdir2, fname), "rb").read()
        want = open(os.path.join(gold, gname), "rb").read()
        assert got == want, f"{fname} deviates from committed golden"


def test_multiple_placements(built, tmp_path):
    """-M: forks one tree per co-optimal placement (Sample1 has EPP=2 on the
    smoke tree), writing final-tree-N.nh / mutation-paths-N.txt per tree
    (usher_common.cpp:556-780)."""
    outdir, pb = built
    outdir2 = str(tmp_path / "multi")
    rc = usher_main(["-i", pb, "-v", NEW_VCF, "-d", outdir2, "-M", "4"])
    assert rc == 0
    t1 = os.path.join(outdir2, "final-tree-1.nh")
    t2 = os.path.join(outdir2, "final-tree-2.nh")
    assert os.path.exists(t1) and os.path.exists(t2)
    T1 = parse_newick_string(open(t1).read())
    T2 = parse_newick_string(open(t2).read())
    # both trees contain all five samples; the trees differ in topology
    for name in [f"Sample{i}" for i in range(1, 6)]:
        assert name in set(T1.get_leaves_ids())
        assert name in set(T2.get_leaves_ids())
    assert open(t1).read() != open(t2).read()
    # stats: one line per (sample, tree) pair — Sample1 placed first creates
    # tree 2, later samples get two lines each
    stats = [l for l in open(os.path.join(outdir2, "placement_stats.tsv"))
             .read().split("\n") if l]
    names = [l.split("\t")[0] for l in stats]
    assert names.count("Sample1") == 1
    assert names.count("Sample5") == 2
    assert os.path.exists(os.path.join(outdir2, "mutation-paths-1.txt"))
    assert os.path.exists(os.path.join(outdir2, "mutation-paths-2.txt"))


def test_pb_roundtrip_through_newick_and_vcf(built, tmp_path):
    """External-anchor round-trip oracle (check_samples spirit,
    src/check_samples_place/main.cpp:9-50): export the built MAT back to
    its raw inputs (uncondensed newick + genotype VCF), rebuild a MAT
    from them through the full per-site Fitch-Sankoff assignment path,
    and demand the rebuilt pb byte-identical to a re-save of the
    original.  Any drift in the VCF writer, newick writer/parser, Sankoff
    assignment, condensation, or pb codec breaks the fixed point."""
    from usher_jax.io.pbio import save_mat_pb
    from usher_jax.matutils.convert import make_vcf
    from usher_jax.io.newick import write_newick

    _outdir, pb = built
    T = load_mat_pb(pb)
    T.uncondense_leaves()
    nh = str(tmp_path / "rt.nh")
    vcf = str(tmp_path / "rt.vcf")
    with open(nh, "w") as f:
        f.write(write_newick(T, print_internal=False,
                             print_branch_len=True))
    make_vcf(T, vcf)

    outdir2 = str(tmp_path / "rebuild")
    pb2 = os.path.join(outdir2, "rt.pb")
    rc = usher_main(["-t", nh, "-v", vcf, "-o", pb2, "-d", outdir2])
    assert rc == 0

    # canonical re-save of the original (same condense-before-save path)
    T0 = load_mat_pb(pb)
    pb0 = str(tmp_path / "resave.pb")
    save_mat_pb(T0, pb0)
    T0.uncondense_leaves()

    T2 = load_mat_pb(pb2)
    T2.uncondense_leaves()
    assert set(T2.get_leaves_ids()) == set(T0.get_leaves_ids())
    assert open(pb2, "rb").read() == open(pb0, "rb").read()

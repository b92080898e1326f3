"""usher-sampled CLI: batched placement, diff input, min-back pass."""

import os

import pytest

from usher_jax.cli.usher_cli import main as usher_main
from usher_jax.cli.usher_sampled_cli import main as sampled_main
from usher_jax.io.pbio import load_mat_pb
from usher_jax.io.vcf import read_vcf_sites

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")
REF_FA = os.path.join(REFERENCE_TEST_DIR, "NC_045512v2.fa")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("sampled_build"))
    pb = os.path.join(outdir, "out.pb")
    rc = usher_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb, "-d", outdir])
    assert rc == 0
    return pb


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


def test_sampled_vcf_placement(built, tmp_path):
    outdir = str(tmp_path / "out")
    pb2 = str(tmp_path / "out2.pb")
    rc = sampled_main(["-i", built, "-v", NEW_VCF, "-o", pb2, "-d", outdir,
                       "-B"])
    assert rc == 0
    stats = open(os.path.join(outdir, "placement_stats.tsv")).read().strip()
    assert len(stats.splitlines()) == 5
    T = load_mat_pb(pb2)
    T.uncondense_leaves()
    recon = reconstruct_leaf_states(T)
    vcf = read_vcf_sites(NEW_VCF)
    for site in vcf.sites:
        variant_by_col = {j: n for j, n in site.variants}
        for j, name in enumerate(vcf.sample_ids):
            assert name in recon
            mask = variant_by_col.get(j, site.ref_nuc)
            got = recon[name].get(site.position, site.ref_nuc)
            assert got & mask


def test_sampled_diff_placement(built, tmp_path):
    # derive a diff for the 5 new samples from the VCF
    vcf = read_vcf_sites(NEW_VCF)
    from usher_jax.core.nuc import char_from_nuc_id
    lines = []
    for j, name in enumerate(vcf.sample_ids):
        lines.append(f">{name}")
        for site in vcf.sites:
            v = dict(site.variants).get(j)
            if v is not None and v != site.ref_nuc:
                if v == 0xF:
                    lines.append(f"n\t{site.position}")
                else:
                    lines.append(f"{char_from_nuc_id(v)}\t{site.position}")
    diff_path = tmp_path / "new.diff"
    diff_path.write_text("\n".join(lines) + "\n")

    outdir = str(tmp_path / "outd")
    pb2 = str(tmp_path / "outd.pb")
    rc = sampled_main(["-i", built, "--diff", str(diff_path), "--ref", REF_FA,
                       "-o", pb2, "-d", outdir])
    assert rc == 0
    T = load_mat_pb(pb2)
    T.uncondense_leaves()
    for name in vcf.sample_ids:
        assert T.get_node(name) is not None


def test_sampled_interleaved_optimization(built, tmp_path):
    """A tiny parsimony_threshold forces an optimization round mid-stream."""
    outdir = str(tmp_path / "out")
    pb2 = str(tmp_path / "o.pb")
    rc = sampled_main(["-i", built, "-v", NEW_VCF, "-o", pb2, "-d", outdir,
                       "--parsimony_threshold", "1",
                       "--batch_size_per_process", "1",
                       "--optimization_radius", "2",
                       "--optimization_minutes", "1"])
    assert rc == 0
    T = load_mat_pb(pb2)
    T.uncondense_leaves()
    vcf = read_vcf_sites(NEW_VCF)
    for name in vcf.sample_ids:
        assert T.get_node(name) is not None


def test_min_back_reduces_back_mutations():
    """min_back FS must not increase parsimony and should not add back
    mutations relative to plain FS."""
    from usher_jax.core.flat import collect_positions
    from usher_jax.io.newick import parse_newick
    from usher_jax.ops.sankoff import assign_states_from_vcf
    from usher_jax.optimize.fitch import FitchEngine, leaf_masks_from_tree

    T = parse_newick(GLOBAL_NH)
    vcf = read_vcf_sites(GLOBAL_VCF)
    assign_states_from_vcf(T, vcf)
    positions, ref, chrom = collect_positions(T)

    def back_count(tree):
        n = 0
        for node in tree.depth_first_expansion():
            for m in node.mutations:
                if m.mut_nuc == m.ref_nuc:
                    n += 1
        return n

    fe = FitchEngine(T, positions)
    lm, ref_row = leaf_masks_from_tree(T, positions, fe.bfs)
    st_plain, _ = fe.run(lm, ref_row)
    plain_score = fe.rewrite_mutations(st_plain, lm, ref_row, chrom)
    plain_back = back_count(T)

    st_mb, _ = fe.run(lm, ref_row, min_back=True)
    mb_score = fe.rewrite_mutations(st_mb, lm, ref_row, chrom)
    mb_back = back_count(T)

    assert mb_score == plain_score  # parsimony is the primary objective
    assert mb_back <= plain_back


def test_sampled_subtrees_and_sort3(tmp_path):
    """-A sort, -K single subtree, clades passthrough on the sampled CLI."""
    import os
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.usher_sampled_cli import main as sampled_main
    scripts = REFERENCE_SCRIPTS_DIR
    if not os.path.exists(os.path.join(scripts, "testBranchLen2.nwk")):
        import pytest
        pytest.skip("reference fixtures unavailable")
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(scripts, "testBranchLen2.nwk"),
                       "-v", os.path.join(scripts, "testBranchLen2.vcf"),
                       "-o", pb, "-d", build]) == 0
    vcf = tmp_path / "new.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\tz2\n"
        "x\t1\t.\tA\tT\t.\t.\t.\t.\t1\t0\n"
        "x\t6\t.\tA\tT\t.\t.\t.\t.\t1\t1\n")
    outdir = str(tmp_path / "o")
    rc = sampled_main(["-i", pb, "-v", str(vcf), "-d", outdir,
                       "-A", "-K", "4"])
    assert rc == 0
    assert os.path.exists(os.path.join(outdir, "single-subtree.nh"))
    assert os.path.exists(os.path.join(outdir, "placement_stats.tsv"))


def test_sampled_multiple_placements(tmp_path):
    """-M > 1 routes through the multi-tree placer (per-tree outputs)."""
    import os
    import pytest
    scripts = REFERENCE_SCRIPTS_DIR
    if not os.path.exists(os.path.join(scripts, "testBranchLen2.nwk")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.usher_sampled_cli import main as sampled_main
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(scripts, "testBranchLen2.nwk"),
                       "-v", os.path.join(scripts, "testBranchLen2.vcf"),
                       "-o", pb, "-d", build]) == 0
    vcf = tmp_path / "new.vcf"
    # z1 ties between several placements (only shared mutations)
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\n"
        "x\t1\t.\tA\tT\t.\t.\t.\t.\t1\n"
        "x\t2\t.\tA\tT\t.\t.\t.\t.\t1\n")
    outdir = str(tmp_path / "o")
    rc = sampled_main(["-i", pb, "-v", str(vcf), "-d", outdir, "-M", "4"])
    assert rc == 0
    outs = os.listdir(outdir)
    assert any(f.startswith("final-tree") for f in outs)


def test_sampled_bigmat_engine(tmp_path):
    """usher-sampled --bigmat places through the CSR engine."""
    import os
    import pytest
    scripts = REFERENCE_SCRIPTS_DIR
    if not os.path.exists(os.path.join(scripts, "testBranchLen2.nwk")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.usher_sampled_cli import main as sampled_main
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(scripts, "testBranchLen2.nwk"),
                       "-v", os.path.join(scripts, "testBranchLen2.vcf"),
                       "-o", pb, "-d", build]) == 0
    vcf = tmp_path / "new.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\tz2\n"
        "x\t1\t.\tA\tT\t.\t.\t.\t.\t1\t0\n"
        "x\t6\t.\tA\tT\t.\t.\t.\t.\t1\t1\n")
    o1 = str(tmp_path / "dense")
    o2 = str(tmp_path / "big")
    assert sampled_main(["-i", pb, "-v", str(vcf), "-d", o1]) == 0
    assert sampled_main(["-i", pb, "-v", str(vcf), "-d", o2,
                         "--bigmat"]) == 0
    a = open(os.path.join(o1, "placement_stats.tsv")).read()
    b = open(os.path.join(o2, "placement_stats.tsv")).read()
    assert a == b
    a = open(os.path.join(o1, "final-tree.nh")).read()
    b = open(os.path.join(o2, "final-tree.nh")).read()
    assert a == b

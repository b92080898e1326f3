"""Golden byte-parity tests against the reference's own checked-in golden.

scripts/testBranchLen2.{sh,nwk,vcf} is the one reference test needing no
binary: build a MAT from an 8-leaf newick whose branch lengths equal the
per-branch mutation counts implied by the VCF, then write final-tree.nh.
The reference newick writer always emits branch length = #mutations
(mutation_annotated_tree.cpp:230 "band-aid fix"), prints internal node
names, and a trailing root length — so the expected output is the input
topology re-labelled with node_N internal names, byte-for-byte.
"""

import os

import pytest

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

from usher_jax.cli.usher_cli import main as usher_main

SCRIPTS = REFERENCE_SCRIPTS_DIR

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(SCRIPTS, "testBranchLen2.nwk")),
    reason="reference scripts unavailable")

# LIMITATION: this expected string is HAND-DERIVED, not emitted by the
# reference binary (which cannot be built in this environment — no MPI or
# boost).  It applies write_newick_string semantics
# (mutation_annotated_tree.cpp:215-346) to testBranchLen2.nwk's topology:
# every input branch length equals the mutation count Fitch-Sankoff must
# assign, so the golden is the input tree with internal labels.
EXPECTED_FINAL_TREE = ("((a:0,(b:0,(c:0,d:1)node_4:1)node_3:2,"
                       "((e:0,f:1)node_6:3,g:0)node_5:4)node_2:5,"
                       "h:0)node_1:0;")


def test_branchlen2_golden(tmp_path):
    outdir = str(tmp_path / "golden")
    rc = usher_main(["-t", os.path.join(SCRIPTS, "testBranchLen2.nwk"),
                     "-v", os.path.join(SCRIPTS, "testBranchLen2.vcf"),
                     "-o", os.path.join(outdir, "o.pb"),
                     "-l", "-d", outdir])
    assert rc == 0
    got = open(os.path.join(outdir, "final-tree.nh")).read()
    assert got == EXPECTED_FINAL_TREE


def test_branchlen2_golden_collapse_roundtrip(tmp_path):
    """Same run without -l: the band-aid writer makes the output identical
    (branch length is always the mutation count)."""
    outdir = str(tmp_path / "golden2")
    rc = usher_main(["-t", os.path.join(SCRIPTS, "testBranchLen2.nwk"),
                     "-v", os.path.join(SCRIPTS, "testBranchLen2.vcf"),
                     "-o", os.path.join(outdir, "o.pb"),
                     "-d", outdir])
    assert rc == 0
    got = open(os.path.join(outdir, "final-tree.nh")).read()
    assert got == EXPECTED_FINAL_TREE


def test_smoke_summary_goldens(tmp_path):
    """matUtils summary -A on the smoke MAT must be byte-stable (locks the
    samples/mutations/clades table formats + content)."""
    import filecmp
    from usher_jax.cli.matutils_cli import main as mu
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    build = str(tmp_path / "b")
    pb = os.path.join(build, "smoke.pb")
    rc = usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                     "-v", os.path.join(ref_dir, "global_samples.vcf"),
                     "-o", pb, "-d", build])
    assert rc == 0
    outdir = str(tmp_path / "sum")
    assert mu(["summary", "-i", pb, "-A", "-d", outdir]) == 0
    golden_dir = os.path.join(os.path.dirname(__file__), "goldens", "summary")
    for name in ("samples.tsv", "mutations.tsv", "clades.tsv"):
        got = os.path.join(outdir, name)
        want = os.path.join(golden_dir, name)
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"


def test_smoke_extract_writer_goldens(tmp_path):
    """matUtils extract format writers (VCF, MAPLE diff, newick) must be
    byte-stable on the smoke MAT."""
    import filecmp
    from usher_jax.cli.matutils_cli import main as mu
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    build = str(tmp_path / "b")
    pb = os.path.join(build, "smoke.pb")
    rc = usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                     "-v", os.path.join(ref_dir, "global_samples.vcf"),
                     "-o", pb, "-d", build])
    assert rc == 0
    outdir = str(tmp_path / "ex")
    assert mu(["extract", "-i", pb, "-v", "smoke.vcf",
               "--write-diff", "smoke.diff", "-t", "smoke.nh",
               "-d", outdir]) == 0
    golden_dir = os.path.join(os.path.dirname(__file__), "goldens", "extract")
    for name in ("smoke.vcf", "smoke.diff", "smoke.nh"):
        assert filecmp.cmp(os.path.join(outdir, name),
                           os.path.join(golden_dir, name),
                           shallow=False), f"{name} differs"

"""Workflow runner + native faToVcf tests (reference workflows/Snakefile)."""

import os
import sys

import pytest

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from usher_jax.cli.usher_cli import main as usher_main  # noqa: E402
from usher_jax.io.fatovcf import fa_to_vcf, read_fasta  # noqa: E402
from workflows.run import main as wf_main  # noqa: E402

SCRIPTS = REFERENCE_SCRIPTS_DIR

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(SCRIPTS, "testBranchLen2.nwk")),
    reason="reference scripts unavailable")

# 20-base alignment: ref (all A) + two user samples
ALIGNED_FA = """>ref
AAAAAAAAAAAAAAAAAAAA
>z1
TTTAATTAAAAAAAAAAAAN
>z2
TTTAAAAAAAAAAAAAAAA-
"""


@pytest.fixture(scope="module")
def small_mat(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("wf_build"))
    pb = os.path.join(outdir, "small.pb")
    rc = usher_main(["-t", os.path.join(SCRIPTS, "testBranchLen2.nwk"),
                     "-v", os.path.join(SCRIPTS, "testBranchLen2.vcf"),
                     "-o", pb, "-d", outdir])
    assert rc == 0
    return pb


def test_fatovcf_basic(tmp_path):
    fa = tmp_path / "aln.fa"
    fa.write_text(ALIGNED_FA)
    vcf = str(tmp_path / "out.vcf")
    n = fa_to_vcf(str(fa), vcf)
    assert n == 5  # positions 1,2,3,6,7 vary; N/- are missing, not variants
    lines = [l for l in open(vcf) if not l.startswith("#")]
    assert len(lines) == 5
    first = lines[0].split("\t")
    assert first[1] == "1" and first[3] == "A" and first[4] == "T"
    assert first[9:] == ["1", "1\n"]
    # N at pos 20 for z1, '-' for z2 -> no row for pos 20
    assert all(l.split("\t")[1] != "20" for l in lines)


def test_fatovcf_mask_sites(tmp_path):
    fa = tmp_path / "aln.fa"
    fa.write_text(ALIGNED_FA)
    mask = tmp_path / "mask.vcf"
    mask.write_text("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                    "ref\t2\t.\tA\tT\t.\tmask\t.\n")
    vcf = str(tmp_path / "out.vcf")
    n = fa_to_vcf(str(fa), vcf, mask_sites_vcf=str(mask))
    assert n == 4
    assert all(l.split("\t")[1] != "2"
               for l in open(vcf) if not l.startswith("#"))


def test_fatovcf_roundtrip_with_reader(tmp_path):
    """The produced VCF must parse through our own VCF reader."""
    from usher_jax.io.vcf import read_vcf_sites
    fa = tmp_path / "aln.fa"
    fa.write_text(ALIGNED_FA)
    vcf = str(tmp_path / "out.vcf")
    fa_to_vcf(str(fa), vcf)
    data = read_vcf_sites(vcf)
    assert data.sample_ids == ["z1", "z2"]
    assert len(data.sites) == 5


def test_workflow_usher_and_systematic(small_mat, tmp_path):
    # user VCF against the testBranchLen2 tree
    vcf = tmp_path / "user.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\n"
        "x\t1\t.\tA\tT\t.\t.\t.\t.\t1\n"
        "x\t2\t.\tA\tT\t.\t.\t.\t.\t1\n"
        "x\t6\t.\tA\tT\t.\t.\t.\t.\t1\n")
    outdir = str(tmp_path / "wf_out")
    rc = wf_main(["--runtype", "usher", "--vcf", str(vcf),
                  "--pb", small_mat, "--outdir", outdir])
    assert rc == 0
    assert os.path.exists(os.path.join(outdir, "user_seqs.pb"))
    assert os.path.exists(os.path.join(outdir, "final-tree.nh"))

    rc = wf_main(["--runtype", "systematic", "--vcf", str(vcf),
                  "--pb", small_mat, "--outdir", outdir])
    assert rc == 0
    report = open(os.path.join(outdir, "parsimony_report.txt")).read()
    assert report.startswith("variant\t")


def test_workflow_matutils_subtrees(small_mat, tmp_path):
    vcf = tmp_path / "user.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\n"
        "x\t1\t.\tA\tT\t.\t.\t.\t.\t1\n")
    outdir = str(tmp_path / "wf_out2")
    rc = wf_main(["--runtype", "matUtils", "--vcf", str(vcf),
                  "--pb", small_mat, "--outdir", outdir])
    assert rc == 0
    tsv = os.path.join(outdir, "subtree-assignments.tsv")
    assert os.path.exists(tsv)
    content = open(tsv).read()
    assert content.startswith("samples\tjson_file")
    assert "z1" in content
    # the JSON subtree file named in the tsv exists
    json_file = content.splitlines()[1].split("\t")[1]
    assert os.path.exists(json_file)


def test_extract_minimum_subtrees_flag(small_mat, tmp_path):
    """matUtils extract -N writes covering subtrees + assignments tsv
    (reference convert.cpp:665-798)."""
    from usher_jax.cli.matutils_cli import main as mu
    samples = tmp_path / "s.txt"
    samples.write_text("a\nb\n")
    outdir = str(tmp_path / "ex")
    rc = mu(["extract", "-i", small_mat, "-s", str(samples),
             "-N", "4", "-j", "q", "-d", outdir])
    assert rc == 0
    assert os.path.exists(os.path.join(outdir, "subtree-assignments.tsv"))
    assert os.path.exists(os.path.join(outdir, "q-subtree-0.json"))


def test_ripples_fleet_partitions():
    from workflows.ripples_fleet import get_partitions
    # reference stride semantics (run.py:29-40)
    assert get_partitions(10, 2) == [(0, 5), (6, 10)]
    assert get_partitions(7, 1) == [(0, 7)]


def test_ripples_fleet_dry_run(small_mat, capsys):
    from workflows.ripples_fleet import main as fleet_main
    rc = fleet_main(["-i", small_mat, "-n", "2", "-l", "3", "-N", "2",
                     "--dry-run", "-d", "/tmp/nonexistent_fleet"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.strip()]
    assert len(lines) == 2
    assert "-S 0" in lines[0] and "ripples_cli" in lines[0]


def test_ripples_fleet_one_process_per_gpu(small_mat, capsys, monkeypatch,
                                           tmp_path):
    """On a GPU host each shard is pinned to one card, and a card runs its
    shards in order (round robin over the visible cards)."""
    from workflows.ripples_fleet import main as fleet_main
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    rc = fleet_main(["-i", small_mat, "-n", "2", "-l", "3", "-N", "2",
                     "--dry-run", "-d", str(tmp_path / "fleet")])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 2
    assert all(l.startswith("CUDA_VISIBLE_DEVICES=3 ") for l in lines)
    assert "-S 0" in lines[0]


def test_ripples_fleet_runs_and_merges(small_mat, tmp_path):
    from workflows.ripples_fleet import main as fleet_main
    outdir = str(tmp_path / "fleet")
    rc = fleet_main(["-i", small_mat, "-n", "2", "-l", "3", "-N", "2",
                     "-d", outdir])
    assert rc == 0
    assert os.path.exists(os.path.join(outdir, "recombination.tsv"))
    assert os.path.exists(os.path.join(outdir, "descendants.tsv"))


def test_top_level_dispatcher(capsys):
    from usher_jax.__main__ import main as dispatch
    import sys
    old = sys.argv
    try:
        sys.argv = ["usher_jax", "--help"]
        assert dispatch() == 0
        assert "matUtils" in capsys.readouterr().err
        sys.argv = ["usher_jax", "nosuchtool"]
        assert dispatch() == 1
    finally:
        sys.argv = old


def test_align_requires_mafft(tmp_path):
    """--align shells out to mafft (rule align_seqs); without it on PATH
    the runner must fail with a clear message, not a stack trace."""
    import subprocess, sys, os
    fa = tmp_path / "u.fa"
    fa.write_text(">s1\nACGT\n")
    ref = tmp_path / "r.fa"
    ref.write_text(">ref\nACGT\n")
    env = dict(os.environ)
    env["PATH"] = "/usr/bin:/bin"   # no mafft
    out = subprocess.run(
        [sys.executable, "workflows/run.py", "--runtype", "systematic",
         "--fasta", str(fa), "--ref", str(ref), "--align",
         "--pb", "nonexistent.pb", "--outdir", str(tmp_path / "o")],
        capture_output=True, text=True, cwd="/root/repo", env=env)
    assert out.returncode == 1
    assert "needs mafft" in out.stderr

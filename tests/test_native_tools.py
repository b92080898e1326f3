"""Native codec + transpose tools + compareVCF + check_samples_place."""

import os

import pytest

from usher_jax.io import transpose
from usher_jax.io.vcf import read_vcf_sites

from conftest import REFERENCE_TEST_DIR

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")
REF_FA = os.path.join(REFERENCE_TEST_DIR, "NC_045512v2.fa")


def test_native_and_python_codecs_agree(tmp_path):
    samples = [
        ("alpha", [(241, 8), (3037, 8), (23403, 4)], [(1, 55), (29804, 29903)]),
        ("beta", [(100, 1)], [(7, 7)]),
        ("gamma", [], []),
    ]
    p1 = str(tmp_path / "native.tvcf")
    p2 = str(tmp_path / "py.tvcf")
    transpose._encode_py(samples, p2)
    assert transpose._decode_py(p2) == samples
    transpose.encode(samples, p1)
    assert transpose.decode(p1) == samples
    # cross-decoding: both containers must parse each other's bytes
    from usher_jax.native import HAVE_NATIVE
    if HAVE_NATIVE:
        from usher_jax.native import ext
        assert [(n, [(int(a), int(b)) for a, b in m],
                 [(int(s), int(e)) for s, e in r])
                for n, m, r in ext.transpose_decode(p2)] == samples
        assert transpose._decode_py(p1) == samples


def test_transpose_vcf_roundtrip(tmp_path):
    """VCF -> transposed -> VCF preserves every genotype."""
    from usher_jax.cli.transpose_vcf_cli import main as tv_main
    tvcf = str(tmp_path / "g.tvcf")
    out_vcf = str(tmp_path / "back.vcf")
    rc = tv_main(["encode", "-v", GLOBAL_VCF, "-o", tvcf])
    assert rc == 0
    rc = tv_main(["print_name", "-i", tvcf])
    assert rc == 0
    rc = tv_main(["to_vcf", "-i", tvcf, "-o", out_vcf, "-r", REF_FA])
    assert rc == 0

    orig = read_vcf_sites(GLOBAL_VCF)
    back = read_vcf_sites(out_vcf)
    assert back.sample_ids == orig.sample_ids
    orig_map = {s.position: dict(s.variants) for s in orig.sites}
    back_map = {s.position: dict(s.variants) for s in back.sites}
    checked = 0
    for pos, var in orig_map.items():
        got = back_map.get(pos, {})
        for col, nuc in var.items():
            assert got.get(col) == nuc, (pos, col)
            checked += 1
    assert checked > 1000


def test_compare_vcf(tmp_path, capsys):
    from usher_jax.cli.compare_vcf_cli import main as cmp_main
    rc = cmp_main([NEW_VCF, NEW_VCF])
    assert rc == 0
    # different files disagree
    rc = cmp_main([NEW_VCF, GLOBAL_VCF])
    assert rc in (0, 1)  # disjoint sample sets -> nothing shared to differ


def test_check_samples_place(tmp_path):
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.check_samples_cli import main as check_main
    outdir = str(tmp_path / "b")
    pb = os.path.join(outdir, "out.pb")
    rc = usher_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb, "-d", outdir])
    assert rc == 0
    out2 = str(tmp_path / "p")
    pb2 = os.path.join(out2, "out2.pb")
    rc = usher_main(["-i", pb, "-v", NEW_VCF, "-o", pb2, "-d", out2])
    assert rc == 0
    # oracle: result tree reproduces the original MAT and the new samples
    rc = check_main(["-i", pb, "-v", NEW_VCF, "-o", pb2])
    assert rc == 0
    # negative control: original MAT does NOT contain the new samples
    rc = check_main(["-v", NEW_VCF, "-o", pb])
    assert rc == 1


def test_parse_vcf_mt_matches_serial():
    """Parallel VCF pipeline (import_vcf_fast.cpp analog) must produce
    identical output to the serial parser."""
    import pytest
    from usher_jax.native import ext, HAVE_NATIVE
    if not HAVE_NATIVE or not hasattr(ext, "parse_vcf_mt"):
        pytest.skip("native extension not built")
    path = "/root/reference/test/global_samples.vcf"
    import os
    if not os.path.exists(path):
        pytest.skip("reference fixtures unavailable")
    a = ext.parse_vcf(path)
    b = ext.parse_vcf_mt(path, 3)
    assert a[0] == b[0]
    assert a[1] == b[1]

"""Detailed-mutations checkpoint roundtrip tests.

Reference format: mutation_detailed.proto + detailed_mutations_store.cpp
(chunked zlib blocks with per-node offsets, meta with refs/chroms/name map).
"""

import os

import pytest

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

from usher_jax.cli.usher_cli import main as usher_main
from usher_jax.io.detailed import (is_detailed_checkpoint,
                                   load_detailed_mutations,
                                   save_detailed_mutations)
from usher_jax.io.newick import write_newick
from usher_jax.io.pbio import load_mat_pb

SCRIPTS = REFERENCE_SCRIPTS_DIR

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(SCRIPTS, "testBranchLen2.nwk")),
    reason="reference scripts unavailable")


@pytest.fixture(scope="module")
def small_mat(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("detailed_build"))
    pb = os.path.join(outdir, "small.pb")
    rc = usher_main(["-t", os.path.join(SCRIPTS, "testBranchLen2.nwk"),
                     "-v", os.path.join(SCRIPTS, "testBranchLen2.vcf"),
                     "-o", pb, "-d", outdir])
    assert rc == 0
    return pb


def _tree_signature(T):
    sig = []
    for n in T.depth_first_expansion():
        sig.append((n.identifier,
                    n.parent.identifier if n.parent else None,
                    tuple((m.chrom, m.position, m.ref_nuc, m.par_nuc,
                           m.mut_nuc) for m in n.mutations),
                    tuple(n.clade_annotations)))
    return sig


def test_roundtrip_lossless(small_mat, tmp_path):
    T = load_mat_pb(small_mat)
    ckpt = str(tmp_path / "ck.detailed")
    save_detailed_mutations(T, ckpt, changed_ids={"a", "node_3"})
    T2, changed = load_detailed_mutations(ckpt)
    assert changed == {"a", "node_3"}
    assert _tree_signature(T) == _tree_signature(T2)
    assert T.condensed_nodes == T2.condensed_nodes
    # newick output identical
    assert write_newick(T, print_internal=True, print_branch_len=True) == \
        write_newick(T2, print_internal=True, print_branch_len=True)


def test_parsimony_preserved(small_mat, tmp_path):
    T = load_mat_pb(small_mat)
    ckpt = str(tmp_path / "ck2.detailed")
    save_detailed_mutations(T, ckpt)
    T2, _ = load_detailed_mutations(ckpt)
    assert T.get_parsimony_score() == T2.get_parsimony_score()


def test_sniffer(small_mat, tmp_path):
    T = load_mat_pb(small_mat)
    ckpt = str(tmp_path / "ck3.detailed")
    save_detailed_mutations(T, ckpt)
    assert is_detailed_checkpoint(ckpt)
    assert not is_detailed_checkpoint(small_mat)  # plain MAT pb
    assert not is_detailed_checkpoint(str(tmp_path / "missing"))


def test_matoptimize_resume_from_detailed(small_mat, tmp_path):
    from usher_jax.cli.matoptimize_cli import main as opt_main
    T = load_mat_pb(small_mat)
    ckpt = str(tmp_path / "ck4.detailed")
    save_detailed_mutations(T, ckpt, changed_ids={"a"})
    out = str(tmp_path / "opt.pb")
    rc = opt_main(["-a", ckpt, "-o", out, "-N", "2", "-r", "2"])
    assert rc == 0
    T2 = load_mat_pb(out)
    assert T2.get_parsimony_score() <= T.get_parsimony_score()


def test_multiblock_stream(tmp_path, monkeypatch):
    """Force multiple compressed blocks to exercise the parallel loader."""
    import usher_jax.io.detailed as det
    from usher_jax.core.tree import Mutation, Tree
    monkeypatch.setattr(det, "BLOCK_SIZE", 256)
    T = Tree()
    root = T.create_node("root", None, 0.0)
    for i in range(200):
        n = T.create_node(f"leaf_{i}", root, 1.0)
        n.mutations.append(Mutation(chrom="c", position=i + 1, ref_nuc=1,
                                    par_nuc=1, mut_nuc=8))
    ckpt = str(tmp_path / "multi.detailed")
    det.save_detailed_mutations(T, ckpt)
    T2, _ = det.load_detailed_mutations(ckpt)
    assert _tree_signature(T) == _tree_signature(T2)


def test_roundtrip_with_annotations_and_condensed(small_mat, tmp_path):
    from usher_jax.io.pbio import load_mat_pb
    T = load_mat_pb(small_mat)
    for i, n in enumerate(T.depth_first_expansion()):
        n.clade_annotations = [f"clade{i % 3}", ""] if i % 2 else []
    ckpt = str(tmp_path / "ann.detailed")
    save_detailed_mutations(T, ckpt)
    T2, _ = load_detailed_mutations(ckpt)
    assert _tree_signature(T) == _tree_signature(T2)

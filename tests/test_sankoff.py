"""Fitch-Sankoff construction tests: hand-checked toy cases plus the
genotype-reconstruction oracle (the reference's check_samples invariant:
every leaf's root-to-leaf mutation accumulation must be compatible with its
input genotype; see /root/reference/src/matOptimize/check_samples.cpp)."""

import numpy as np
import pytest

from usher_jax.core.nuc import nuc_id_from_char
from usher_jax.core.tree import Tree
from usher_jax.io.newick import parse_newick_string
from usher_jax.io.vcf import VcfData, VcfSite
from usher_jax.ops.sankoff import assign_states_from_vcf

A, C, G, T, N = 1, 2, 4, 8, 15


def make_vcf(sample_ids, sites):
    return VcfData(sample_ids=sample_ids,
                   sites=[VcfSite("chr", pos, ref, variants)
                          for pos, ref, variants in sites])


def reconstruct_leaf_states(T, positions, ref_by_pos):
    """position -> allele for each leaf by root->leaf accumulation."""
    out = {}
    stack = [(T.root, dict())]
    while stack:
        node, state = stack.pop()
        state = dict(state)
        for m in node.mutations:
            state[m.position] = m.mut_nuc
        if node.is_leaf():
            out[node.identifier] = {
                p: state.get(p, ref_by_pos[p]) for p in positions}
        for ch in node.children:
            stack.append((ch, state))
    return out


def test_single_site_two_leaves():
    tree = parse_newick_string("(L1,L2);")
    vcf = make_vcf(["L1", "L2"], [(100, C, [(0, T)])])  # L1 has C100T
    assign_states_from_vcf(tree, vcf)
    # most parsimonious: mutation on L1's branch only
    assert [m.get_string() for m in tree.get_node("L1").mutations] == ["C100T"]
    assert tree.get_node("L2").mutations == []
    assert tree.root.mutations == []


def test_shared_mutation_pushed_up():
    T = parse_newick_string("((L1,L2),L3);")
    vcf = make_vcf(["L1", "L2", "L3"], [(50, A, [(0, G), (1, G)])])
    assign_states_from_vcf(T, vcf)
    assert [m.get_string() for m in T.get_node("node_2").mutations] == ["A50G"]
    assert T.get_node("L1").mutations == []
    assert T.get_node("L2").mutations == []


def test_all_leaves_mutated_moves_to_root():
    T = parse_newick_string("((L1,L2),L3);")
    vcf = make_vcf(["L1", "L2", "L3"],
                   [(50, A, [(0, G), (1, G), (2, G)])])
    assign_states_from_vcf(T, vcf)
    assert [m.get_string() for m in T.root.mutations] == ["A50G"]
    assert T.get_parsimony_score() == 1


def test_parent_state_preferred_on_tie():
    # one leaf mutated out of two: tie at root between ref and alt resolves
    # to the parent (=ref) state, so exactly one mutation on the leaf branch.
    tree = parse_newick_string("(L1,L2);")
    vcf = make_vcf(["L1", "L2"], [(10, G, [(1, T)])])
    assign_states_from_vcf(tree, vcf)
    assert tree.get_parsimony_score() == 1
    assert [m.get_string() for m in tree.get_node("L2").mutations] == ["G10T"]


def test_missing_leaf_free():
    # N at a leaf should not force any mutation
    T = parse_newick_string("((L1,L2),L3);")
    vcf = make_vcf(["L1", "L2", "L3"], [(10, A, [(0, G), (1, N)])])
    assign_states_from_vcf(T, vcf)
    # L2 is missing; parsimony: G on L1 branch only (L2 follows parent state)
    assert T.get_parsimony_score() == 1


def test_ambiguous_leaf():
    # R = A|G; leaf can take either, so no mutation needed when sibling is A
    T = parse_newick_string("(L1,L2);")
    vcf = make_vcf(["L1", "L2"], [(10, A, [(0, nuc_id_from_char("R"))])])
    assign_states_from_vcf(T, vcf)
    assert T.get_parsimony_score() == 0


def _random_case(rng, n_leaves, n_sites):
    # random multifurcating topology
    newick_parts = [f"L{i}" for i in range(n_leaves)]
    while len(newick_parts) > 1:
        k = int(rng.integers(2, min(4, len(newick_parts)) + 1))
        group = []
        for _ in range(k):
            group.append(newick_parts.pop(int(rng.integers(len(newick_parts)))))
        newick_parts.append("(" + ",".join(group) + ")")
    T = parse_newick_string(newick_parts[0] + ";")
    sample_ids = [f"L{i}" for i in range(n_leaves)]
    sites = []
    bases = [1, 2, 4, 8]
    for s in range(n_sites):
        ref = bases[rng.integers(4)]
        variants = []
        for j in range(n_leaves):
            r = rng.random()
            if r < 0.25:
                choice = rng.integers(0, 6)
                if choice < 4:
                    nuc = bases[choice]
                    if nuc == ref:
                        continue
                elif choice == 4:
                    nuc = N
                else:
                    nuc = int(rng.integers(3, 15))  # ambiguous mask
                variants.append((j, nuc))
        sites.append((100 + s, ref, variants))
    return T, make_vcf(sample_ids, sites), sites


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reconstruction_oracle_random(seed):
    rng = np.random.default_rng(seed)
    T, vcf, sites = _random_case(rng, n_leaves=24, n_sites=12)
    assign_states_from_vcf(T, vcf)
    positions = [s.position for s in vcf.sites]
    ref_by_pos = {s.position: s.ref_nuc for s in vcf.sites}
    recon = reconstruct_leaf_states(T, positions, ref_by_pos)
    for site in vcf.sites:
        expected = {j: nuc for j, nuc in site.variants}
        for j, name in enumerate(vcf.sample_ids):
            mask = expected.get(j, site.ref_nuc)
            got = recon[name][site.position]
            assert got & mask, (
                f"leaf {name} pos {site.position}: reconstructed "
                f"{got:04b} incompatible with genotype mask {mask:04b}")


def test_oracle_matches_bruteforce_parsimony():
    """Total mutations must equal the exact Sankoff minimum per site."""
    rng = np.random.default_rng(7)
    T, vcf, _ = _random_case(rng, n_leaves=10, n_sites=6)

    # exact DP per site on the host for comparison
    def site_min(site):
        leaves = {j: nuc for j, nuc in site.variants}
        ref_nt = {1: 0, 2: 1, 4: 2, 8: 3}[site.ref_nuc]
        name_to_col = {name: j for j, name in enumerate(vcf.sample_ids)}

        def rec(node):
            if node.is_leaf():
                j = name_to_col[node.identifier]
                mask = leaves.get(j, site.ref_nuc)
                return [0 if (mask >> k) & 1 else 10 ** 6 for k in range(4)]
            tot = [0, 0, 0, 0]
            for ch in node.children:
                cs = rec(ch)
                m = min(cs)
                for k in range(4):
                    tot[k] += min(cs[k], m + 1)
            return tot

        sc = rec(T.root)
        # root attaches to the reference state
        m = min(sc)
        return min(sc[ref_nt], m + 1)

    per_site = [site_min(s) for s in vcf.sites]
    T2 = T  # assign in place
    assign_states_from_vcf(T2, vcf)
    assert T2.get_parsimony_score() == sum(per_site)

"""3SEQ-style ripples filtration tests."""

import os

import pytest

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

from usher_jax.ripples.filter import (max_descent, mnk_pvalue, pattern_mnk,
                                      trio_pattern)

SCRIPTS = REFERENCE_SCRIPTS_DIR


def test_max_descent():
    # makeMNK.py getK semantics
    assert max_descent("AAAA") == 0
    assert max_descent("AB") == 1
    assert max_descent("AABB") == 2
    assert max_descent("ABAB") == 1
    assert max_descent("BBAA") == 2  # walk goes -2 from peak 0
    assert max_descent("AABBBAAA") == 3


def test_pattern_mnk_orientation():
    # oriented by the first symbol (makeMNK.py:26-30)
    assert pattern_mnk("AABB") == (2, 2, 2)
    assert pattern_mnk("BBAA") == (2, 2, 2)
    assert pattern_mnk("") == (0, 0, 0)


def test_mnk_pvalue_exact_small():
    # k=0 always happens
    assert mnk_pvalue(3, 2, 0) == 1.0
    # cannot descend k with fewer than k downs
    assert mnk_pvalue(5, 2, 3) == 0.0
    # m=1, n=1: arrangements AB (descent 1), BA (descent 1) -> P(>=1)=1
    assert mnk_pvalue(1, 1, 1) == 1.0
    # m=2, n=1: AAB(1) ABA(1) BAA(1) -> P(>=1)=1
    assert mnk_pvalue(2, 1, 1) == 1.0
    # m=1, n=2: arrangements ABB(2) BAB(1->desc 2? walk B=-1 A=0 B=-1:
    # drawdowns: 1, 0, 1 -> max 1... recompute exactly by enumeration below


def _brute_pvalue(m, n, k):
    from itertools import permutations
    seqs = set(permutations("A" * m + "B" * n))
    hit = sum(1 for s in seqs if max_descent("".join(s)) >= k)
    return hit / len(seqs)


@pytest.mark.parametrize("m,n,k", [
    (1, 2, 1), (1, 2, 2), (2, 2, 1), (2, 2, 2), (3, 3, 2), (3, 3, 3),
    (4, 2, 2), (2, 4, 3), (5, 5, 3), (0, 3, 2), (3, 0, 1),
])
def test_mnk_pvalue_matches_bruteforce(m, n, k):
    assert mnk_pvalue(m, n, k) == pytest.approx(_brute_pvalue(m, n, k))


def test_trio_pattern_from_mat():
    from usher_jax.core.tree import Mutation, Tree
    T = Tree()
    T.create_node("root")
    d = T.create_node("donor", "root")
    a = T.create_node("acceptor", "root")
    r = T.create_node("recomb", "root")
    # donor: T at 10, 20; acceptor: G at 10, C at 30
    d.add_mutation(Mutation("c", 10, 1, 1, 8))
    d.add_mutation(Mutation("c", 20, 1, 1, 8))
    a.add_mutation(Mutation("c", 10, 1, 1, 4))
    a.add_mutation(Mutation("c", 30, 1, 1, 2))
    # recombinant matches donor at 10 and 20, acceptor at 30
    r.add_mutation(Mutation("c", 10, 1, 1, 8))
    r.add_mutation(Mutation("c", 20, 1, 1, 8))
    r.add_mutation(Mutation("c", 30, 1, 1, 2))
    assert trio_pattern(T, "recomb", "donor", "acceptor") == "AAB"


def test_filter_end_to_end(tmp_path):
    """Run ripples on a small MAT, then the filter CLI over its output."""
    if not os.path.exists(os.path.join(SCRIPTS, "testBranchLen2.nwk")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.ripples_cli import main as ripples_main
    from usher_jax.cli.ripples_filter_cli import main as filter_main
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(SCRIPTS, "testBranchLen2.nwk"),
                       "-v", os.path.join(SCRIPTS, "testBranchLen2.vcf"),
                       "-o", pb, "-d", build]) == 0
    rip = str(tmp_path / "rip")
    assert ripples_main(["-i", pb, "-d", rip, "-l", "3", "-n", "2"]) == 0
    out = str(tmp_path / "filtered.tsv")
    assert filter_main(["-i", pb,
                        "-r", os.path.join(rip, "recombination.tsv"),
                        "-o", out]) == 0
    content = open(out).read()
    assert content.startswith("#recomb_node_id\t")

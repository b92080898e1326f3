"""matOptimize equivalent: whole-tree FS reassignment + SPR optimization.

Oracles (SURVEY.md section 4): genotype reconstruction preserved exactly
(check_samples equivalence), parsimony never increases, and a tree with a
known suboptimal placement is repaired to the known optimum.
"""

import os

import numpy as np
import pytest

from usher_jax.core.flat import collect_positions
from usher_jax.core.tree import Mutation, Tree
from usher_jax.io.newick import parse_newick
from usher_jax.io.vcf import read_vcf_sites
from usher_jax.ops.sankoff import assign_states_from_vcf
from usher_jax.optimize import OptimizeOptions, optimize_tree
from usher_jax.optimize.fitch import FitchEngine, leaf_masks_from_tree

from conftest import REFERENCE_TEST_DIR

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")


def leaf_genotypes(T, positions):
    """leaf name -> {pos: allele-mask} accumulated root->leaf."""
    pos = set(int(p) for p in positions)
    out = {}
    stack = [(T.root, {})]
    while stack:
        node, state = stack.pop()
        if node.mutations:
            state = dict(state)
            for m in node.mutations:
                if m.position in pos:
                    state[m.position] = m.mut_nuc
        if node.is_leaf():
            out[node.identifier] = state
        for ch in node.children:
            stack.append((ch, state))
    return out


def mk_mut(pos, par, mut, ref=1):
    return Mutation(chrom="c", position=pos, ref_nuc=ref, par_nuc=par,
                    mut_nuc=mut)


def build_suboptimal_tree():
    """A tree where leaf D (genotype identical to B's clade) is misplaced
    under the A-clade: SPR moving D next to B saves mutations.

            root
           /    \\
         i1      i2
        /  \\   /  \\
       A    D  B    C

    positions 100,200: A=ref; B,C carry G at 100; D carries G at 100 too but
    sits under i1, costing an extra mutation.
    """
    T = Tree()
    root = T.create_node("root")
    i1 = T.create_node("i1", root)
    i2 = T.create_node("i2", root)
    a = T.create_node("A", i1)
    d = T.create_node("D", i1)
    b = T.create_node("B", i2)
    c = T.create_node("C", i2)
    # ref at 100 is A(1); clade i2 has G(4)
    i2.mutations = [mk_mut(100, 1, 4)]
    d.mutations = [mk_mut(100, 1, 4)]
    # distinguish B and C so i2 isn't collapsible
    b.mutations = [mk_mut(200, 1, 2)]
    return T


def test_fitch_reassignment_preserves_genotypes_and_score():
    T = parse_newick(GLOBAL_NH)
    vcf = read_vcf_sites(GLOBAL_VCF)
    assign_states_from_vcf(T, vcf)
    score0 = T.get_parsimony_score()
    positions, ref, chrom = collect_positions(T)
    geno_before = leaf_genotypes(T, positions)

    engine = FitchEngine(T, positions)
    leaf_masks, ref_row = leaf_masks_from_tree(T, positions, engine.bfs)
    states, masks = engine.run(leaf_masks, ref_row)
    score1 = engine.rewrite_mutations(states, leaf_masks, ref_row, chrom)

    assert score1 <= score0  # FS is optimal for the fixed topology
    assert score1 == T.get_parsimony_score()

    geno_after = leaf_genotypes(T, positions)
    assert set(geno_before) == set(geno_after)
    pos_ref = {int(p): int(r) for p, r in zip(positions, ref)}
    for name, g0 in geno_before.items():
        g1 = geno_after[name]
        for p in set(g0) | set(g1):
            m0 = g0.get(p, pos_ref[p])
            m1 = g1.get(p, pos_ref[p])
            assert m0 & m1, f"{name}@{p}: {m0:04b} vs {m1:04b}"


def test_spr_repairs_known_misplacement():
    T = build_suboptimal_tree()
    assert T.get_parsimony_score() == 3
    final = optimize_tree(T, OptimizeOptions(radius=8))
    assert final == 2
    d = T.get_node("D")
    # D must now sit inside the old i2 clade (with B and C)
    anc = {n.identifier for n in T.rsearch("D")}
    assert "i2" in anc or {c.identifier for c in d.parent.children} >= {"D"}
    # genotypes preserved
    positions, ref, chrom = collect_positions(T)
    geno = leaf_genotypes(T, positions)
    assert geno["D"].get(100) & 4
    assert geno["B"].get(100) & 4
    assert geno["A"].get(100, 1) & 1


def test_optimize_global_tree_monotone():
    T = parse_newick(GLOBAL_NH)
    vcf = read_vcf_sites(GLOBAL_VCF)
    assign_states_from_vcf(T, vcf)
    positions, _, _ = collect_positions(T)
    geno_before = leaf_genotypes(T, positions)
    score0 = T.get_parsimony_score()

    final = optimize_tree(T, OptimizeOptions(radius=4, max_iterations=3,
                                             source_chunk=256))
    assert final <= score0
    assert final == T.get_parsimony_score()

    # full genotype-preservation oracle after optimization
    positions2, ref2, _ = collect_positions(T)
    geno_after = leaf_genotypes(T, positions2)
    pos_ref = {int(p): int(r) for p, r in zip(positions2, ref2)}
    assert set(geno_before) == set(geno_after)
    checked = 0
    for name, g0 in geno_before.items():
        g1 = geno_after[name]
        for p in set(g0) | set(g1):
            m0 = g0.get(p, pos_ref.get(p, 0)) or 0xF
            m1 = g1.get(p, pos_ref.get(p, 0)) or 0xF
            assert m0 & m1, f"{name}@{p}: {m0:04b} vs {m1:04b}"
            checked += 1
    assert checked > 1000


def test_matoptimize_cli(tmp_path):
    from usher_jax.cli.matoptimize_cli import main as mato_main
    from usher_jax.io.pbio import save_mat_pb, load_mat_pb
    T = build_suboptimal_tree()
    pb_in = str(tmp_path / "in.pb")
    pb_out = str(tmp_path / "out.pb")
    save_mat_pb(T, pb_in)
    rc = mato_main(["-i", pb_in, "-o", pb_out, "-r", "8"])
    assert rc == 0
    T2 = load_mat_pb(pb_out)
    assert T2.get_parsimony_score() == 2


def test_matoptimize_diff_input(tmp_path):
    """-t newick -D diff -R ref.fa: genotypes from MAPLE diff
    (reference main.cpp:360-374)."""
    from usher_jax.cli.matoptimize_cli import main as mato_main
    from usher_jax.io.pbio import load_mat_pb
    ref_fa = str(tmp_path / "ref.fa")
    with open(ref_fa, "w") as f:
        f.write(">chr\n" + "A" * 30 + "\n")
    nh = str(tmp_path / "t.nh")
    with open(nh, "w") as f:
        f.write("((L1,L2),(L3,L4));\n")
    diff = str(tmp_path / "s.diff")
    with open(diff, "w") as f:
        # L1/L2 share C at 5; L3 has T at 9 and an N run
        f.write(">L1\nc\t5\n>L2\nc\t5\n>L3\nt\t9\nn\t12\t3\n>L4\n")
    out = str(tmp_path / "o.pb")
    rc = mato_main(["-t", nh, "-D", diff, "-R", ref_fa, "-o", out,
                    "-r", "4"])
    assert rc == 0
    T2 = load_mat_pb(out)
    # parsimony: one shared C mutation + one T mutation = 2
    assert T2.get_parsimony_score() == 2


def test_matoptimize_transposed_vcf_patch(tmp_path):
    """-i pb -V transposed.vcf restores ambiguous leaf bases
    (reference main.cpp:346-358)."""
    from usher_jax.cli.matoptimize_cli import main as mato_main
    from usher_jax.io import transpose
    from usher_jax.io.pbio import save_mat_pb, load_mat_pb
    T = build_suboptimal_tree()
    pb_in = str(tmp_path / "in.pb")
    save_mat_pb(T, pb_in)
    # one sample gets an ambiguous allele at an existing position
    T0 = load_mat_pb(pb_in)
    leaf = T0.get_leaves()[0]
    pos = T0.breadth_first_expansion()[1].mutations[0].position \
        if T0.breadth_first_expansion()[1].mutations else None
    positions, _, _ = collect_positions(T0)
    pos = int(positions[0])
    tv = str(tmp_path / "g.tvcf")
    transpose.encode([(leaf.identifier, [(pos, 0x5)], [])], tv)
    out = str(tmp_path / "o.pb")
    rc = mato_main(["-i", pb_in, "-V", tv, "-o", out, "-r", "4"])
    assert rc == 0
    assert os.path.exists(out)


def test_matoptimize_epp_mode(tmp_path):
    """-E writes an EPP-annotated newick (reference main.cpp:438-504)."""
    from usher_jax.cli.matoptimize_cli import main as mato_main
    from usher_jax.io.pbio import save_mat_pb
    from usher_jax.io.newick import parse_newick_string
    import os as _os
    T = build_suboptimal_tree()
    pb_in = str(tmp_path / "in.pb")
    save_mat_pb(T, pb_in)
    out_nwk = str(tmp_path / "epp.nwk")
    cwd = _os.getcwd()
    _os.chdir(tmp_path)
    try:
        rc = mato_main(["-i", pb_in, "-o", str(tmp_path / "x.pb"),
                        "-E", out_nwk, "-r", "4"])
    finally:
        _os.chdir(cwd)
    assert rc == 0
    s = open(out_nwk).read()
    T2 = parse_newick_string(s)
    # every branch length is a positive EPP count
    for n in T2.depth_first_expansion():
        if n.parent is not None:
            assert n.branch_length >= 1


def test_check_state_reassign_toggle(tmp_path, monkeypatch):
    """USHER_JAX_CHECK_STATE_REASSIGN=1 (the -DCHECK_STATE_REASSIGN analog)
    verifies the local FS patch against a full recompute each iteration."""
    import os
    import pytest
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.matoptimize_cli import main as opt_main
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", build]) == 0
    monkeypatch.setenv("USHER_JAX_CHECK_STATE_REASSIGN", "1")
    out = str(tmp_path / "opt.pb")
    assert opt_main(["-i", pb, "-o", out, "-N", "2", "-r", "4",
                     "--mesh-devices", "0"]) == 0


def test_apply_move_undo_roundtrip():
    """apply_move's undo log must restore the exact pre-move tree
    (topology, mutations, levels, node table) without an O(tree) snapshot."""
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.io.newick import write_newick
    from usher_jax.optimize.spr import Move, apply_move, revert_moves

    def build():
        T = Tree()
        T.create_node("root")
        import numpy as np
        rng = np.random.default_rng(3)
        bases = [1, 2, 4, 8]
        nodes = ["root"]
        for i in range(40):
            parent = nodes[int(rng.integers(len(nodes)))]
            n = T.create_node(f"n{i}", parent)
            p = int(rng.integers(100, 160))
            n.add_mutation(Mutation("c", p, 1, 1, bases[int(rng.integers(1, 4))]))
            nodes.append(f"n{i}")
        return T

    def signature(T):
        return (write_newick(T, print_internal=True, print_branch_len=True),
                {k: (tuple((m.position, m.par_nuc, m.mut_nuc)
                           for m in v.mutations), v.level,
                     v.parent.identifier if v.parent else None)
                 for k, v in T._all_nodes.items()})

    import numpy as np
    rng = np.random.default_rng(11)
    for trial in range(30):
        T = build()
        before = signature(T)
        ids = [k for k in T._all_nodes if k != "root"]
        logs = []
        applied = 0
        for _ in range(3):
            sid = ids[int(rng.integers(len(ids)))]
            did = ids[int(rng.integers(len(ids)))]
            s, d = T.get_node(sid), T.get_node(did)
            if s is None or d is None or s is d:
                continue
            # d must not be inside s's subtree, and not s's parent
            anc = d
            ok = True
            while anc is not None:
                if anc is s:
                    ok = False
                    break
                anc = anc.parent
            if not ok or d is s.parent or d.parent is None:
                continue
            mv = Move(src=s, dst=d, improvement=1,
                      sibling_split=bool(rng.integers(2)),
                      src_interval=(0, 0), dst_dfs=0)
            logs.append(apply_move(T, mv))
            applied += 1
        if applied:
            revert_moves(T, logs)
            assert signature(T) == before, f"trial {trial} mismatch"


def test_sparse_leaf_store_matches_dense():
    """SparseLeafStore materialization must equal the dense
    leaf_masks_from_tree rows at leaves (chunked and arbitrary columns)."""
    import numpy as np
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.core.flat import collect_positions
    from usher_jax.optimize.fitch import FitchEngine, leaf_masks_from_tree
    from usher_jax.optimize.leafstore import SparseLeafStore

    rng = np.random.default_rng(5)
    bases = [1, 2, 4, 8]
    T = Tree()
    T.create_node("root")
    nodes = ["root"]
    for i in range(60):
        parent = nodes[int(rng.integers(len(nodes)))]
        n = T.create_node(f"n{i}", parent)
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(100, 140))
            n.add_mutation(Mutation("c", p, 1, 1,
                                    bases[int(rng.integers(1, 4))]))
        nodes.append(f"n{i}")
    positions, ref, chrom = collect_positions(T)
    eng = FitchEngine(T, positions, chunk=8)
    dense, ref_row = leaf_masks_from_tree(T, positions, eng.bfs)
    store, ref_row2 = SparseLeafStore.from_tree(T, positions)
    np.testing.assert_array_equal(ref_row, ref_row2)
    P = len(positions)
    # chunked materialization
    for c0 in range(0, P, 7):
        c1 = min(c0 + 7, P)
        got = store.materialize(eng.bfs, eng.is_leaf, c0, c1)
        for i in range(eng.n):
            if eng.is_leaf[i]:
                np.testing.assert_array_equal(got[i], dense[i, c0:c1])
    # arbitrary column sets
    cols = np.array(sorted(rng.choice(P, size=min(9, P), replace=False)))
    got = store.materialize_cols(eng.bfs, eng.is_leaf, cols)
    for i in range(eng.n):
        if eng.is_leaf[i]:
            np.testing.assert_array_equal(got[i], dense[i][cols])
    # FS run equality through the provider path
    s1, m1 = eng.run(dense, ref_row)
    s2, m2 = eng.run(store, ref_row)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(m1, m2)
    # rewrite equality (scores + mutation lists)
    import copy
    T2 = T.copy()
    eng2 = FitchEngine(T2, positions, chunk=8)
    store2, _ = SparseLeafStore.from_tree(T2, positions)
    sc1 = eng.rewrite_mutations(s1, dense, ref_row, chrom)
    sc2 = eng2.rewrite_mutations(s2, store2, ref_row, chrom)
    assert sc1 == sc2
    from usher_jax.io.newick import write_newick
    assert write_newick(T, print_internal=True, print_branch_len=True) == \
        write_newick(T2, print_internal=True, print_branch_len=True)


def test_matoptimize_improves_smoke_tree(tmp_path):
    """The smoke MAT must actually improve (500 -> <=494 in 2 iterations at
    radius 4; measured 500->490).  Guards against silent no-op regressions
    in move finding/application."""
    import os
    import pytest
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.matoptimize_cli import main as opt_main
    from usher_jax.io.pbio import load_mat_pb
    build = str(tmp_path / "b")
    pb = os.path.join(build, "smoke.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", build]) == 0
    T0 = load_mat_pb(pb)
    assert T0.get_parsimony_score() == 500
    out = str(tmp_path / "opt.pb")
    assert opt_main(["-i", pb, "-o", out, "-N", "2", "-r", "4",
                     "--mesh-devices", "0"]) == 0
    T1 = load_mat_pb(out)
    assert T1.get_parsimony_score() <= 494


def test_big_move_finder_matches_dense():
    """BigMoveFinder (CSR + sparse SPR kernel + host masking) must produce
    the EXACT same move list as the dense MoveFinder."""
    import numpy as np
    from usher_jax.core.flat import collect_positions
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.optimize.fitch import FitchEngine
    from usher_jax.optimize.leafstore import SparseLeafStore
    from usher_jax.optimize.spr import MoveFinder
    from usher_jax.optimize.spr_big import BigMoveFinder

    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        bases = [1, 2, 4, 8]
        T = Tree()
        T.create_node("root")
        nodes = ["root"]
        for i in range(70):
            parent = nodes[int(rng.integers(len(nodes)))]
            nd = T.create_node(f"n{i}", parent)
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(100, 160))
                nd.add_mutation(Mutation("c", p, 1, 1,
                                         bases[int(rng.integers(1, 4))]))
            nodes.append(f"n{i}")
        positions, ref, chrom = collect_positions(T)
        eng = FitchEngine(T, positions, chunk=16)
        store, ref_row = SparseLeafStore.from_tree(T, positions)
        states, masks = eng.run(store, ref_row)
        eng.rewrite_mutations(states, store, ref_row, chrom)
        # re-run FS on the rewritten tree for canonical masks
        eng2 = FitchEngine(T, positions, chunk=16)
        states, masks = eng2.run(store, ref_row)

        dense = MoveFinder(T, states, masks, ref_row, eng2.bfs, eng2.parent,
                           chunk=32)
        big = BigMoveFinder(T, states, masks, ref_row, eng2.bfs, eng2.parent,
                            chunk=32, positions=positions)
        for radius in (2, 4, 1000):
            m1 = dense.find_moves(radius)
            m2 = big.find_moves(radius)
            sig1 = [(m.src.identifier, m.dst.identifier, m.improvement,
                     m.sibling_split) for m in m1]
            sig2 = [(m.src.identifier, m.dst.identifier, m.improvement,
                     m.sibling_split) for m in m2]
            assert sig1 == sig2, f"seed {seed} radius {radius}"


def test_matoptimize_spr_backend_big_identical(tmp_path):
    """matOptimize --spr-backend big must produce the identical optimized
    tree to the dense backend on the smoke MAT."""
    import os
    import pytest
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.matoptimize_cli import main as opt_main
    from usher_jax.io.newick import write_newick
    from usher_jax.io.pbio import load_mat_pb
    build = str(tmp_path / "b")
    pb = os.path.join(build, "smoke.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", build]) == 0
    o1 = str(tmp_path / "d.pb")
    o2 = str(tmp_path / "g.pb")
    assert opt_main(["-i", pb, "-o", o1, "-N", "2", "-r", "4",
                     "--mesh-devices", "0"]) == 0
    assert opt_main(["-i", pb, "-o", o2, "-N", "2", "-r", "4",
                     "--mesh-devices", "0", "--spr-backend", "big"]) == 0
    T1 = load_mat_pb(o1)
    T2 = load_mat_pb(o2)
    assert T1.get_parsimony_score() == T2.get_parsimony_score()
    assert write_newick(T1, print_internal=True, print_branch_len=True) == \
        write_newick(T2, print_internal=True, print_branch_len=True)


def test_matoptimize_stream_states_identical(tmp_path):
    """--stream-states (no [n, P] matrices anywhere; streamed FS per
    iteration) must produce the identical optimized tree to the dense
    driver on the smoke MAT."""
    import os
    import pytest
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.cli.matoptimize_cli import main as opt_main
    from usher_jax.io.newick import write_newick
    from usher_jax.io.pbio import load_mat_pb
    build = str(tmp_path / "b")
    pb = os.path.join(build, "smoke.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", build]) == 0
    o1 = str(tmp_path / "d.pb")
    o2 = str(tmp_path / "s.pb")
    assert opt_main(["-i", pb, "-o", o1, "-N", "2", "-r", "4",
                     "--mesh-devices", "0"]) == 0
    assert opt_main(["-i", pb, "-o", o2, "-N", "2", "-r", "4",
                     "--mesh-devices", "0", "--stream-states"]) == 0
    T1 = load_mat_pb(o1)
    T2 = load_mat_pb(o2)
    assert T1.get_parsimony_score() == T2.get_parsimony_score()
    assert write_newick(T1, print_internal=True, print_branch_len=True) == \
        write_newick(T2, print_internal=True, print_branch_len=True)


def test_streamed_patch_maintains_csr(monkeypatch, tmp_path):
    """Streamed incremental-patch iterations must maintain the array-form
    mutation set (csr_triplets) exactly — asserted against a from-scratch
    from_tree build on EVERY finder construction (USHER_JAX_CHECK_CSR),
    across several iterations with applied moves."""
    import numpy as np
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.optimize import OptimizeOptions, optimize_tree

    monkeypatch.setenv("USHER_JAX_CHECK_CSR", "1")
    rng = np.random.default_rng(9)
    bases = [1, 2, 4, 8]
    T = Tree(); T.create_node("root"); nodes = ["root"]
    for i in range(120):
        parent = nodes[int(rng.integers(len(nodes)))]
        nd = T.create_node(f"n{i}", parent)
        for _ in range(int(rng.integers(1, 3))):
            p = int(rng.integers(100, 140))
            nd.add_mutation(Mutation("c", p, 1, 1,
                                     bases[int(rng.integers(1, 4))]))
        nodes.append(f"n{i}")
    T2 = T.copy()
    sc_stream = optimize_tree(T, OptimizeOptions(
        radius=3, max_iterations=6, reduce_back_mutations=False,
        stream_states=True))
    sc_dense = optimize_tree(T2, OptimizeOptions(
        radius=3, max_iterations=6, reduce_back_mutations=False))
    assert sc_stream == sc_dense
    from usher_jax.io.newick import write_newick
    assert write_newick(T, print_internal=True, print_branch_len=True) == \
        write_newick(T2, print_internal=True, print_branch_len=True)

"""BigMAT (CSR + on-demand column materialization) vs the dense kernels.

The pandemic-scale representation must reproduce the dense FlatMAT scoring
bit-for-bit: same score matrix, same num_common, same winner under the
reference tie-break.  Also exercises the column-chunking path (max_cols
smaller than the batch's unique positions).
"""

import numpy as np
import pytest

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

from usher_jax.core.bigmat import BigMAT
from usher_jax.core.flat import FlatMAT
from usher_jax.ops import placement as dev

from test_placement import random_mat, random_sample


def _setup(seed, n_leaves=25, n_positions=18):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=n_leaves, n_positions=n_positions)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    samples = [random_sample(rng, ref) for _ in range(6)]
    return T, positions, refarr, samples


@pytest.mark.parametrize("seed", list(range(4)))
@pytest.mark.parametrize("max_cols", [2048, 4])
def test_bigmat_matches_dense(seed, max_cols):
    T, positions, refarr, samples = _setup(seed)
    flat = FlatMAT(T, positions, refarr, "c")
    st_dev, parent_dev = flat.sync()
    meta = flat.order_arrays()
    g, E, miss = flat.encode_samples(samples)
    score_d, nc_d, nnm_d = (np.asarray(x) for x in dev.score_batch(
        st_dev, parent_dev, flat.root_slot, np.asarray(flat.ref),
        meta["active"], g, E, miss))

    big = BigMAT.from_tree(T, positions, refarr)
    pos, gval, kmiss = big.sparsify(samples)
    score_T, nc_T, nnm_b = big.score_batch_T(pos, gval, kmiss,
                                             max_cols=max_cols)

    # map flat slots <-> big slots via node identity
    bfs = T.breadth_first_expansion()
    flat_slots = np.array([n.slot for n in bfs])
    np.testing.assert_array_equal(nnm_b, nnm_d[flat_slots])
    np.testing.assert_array_equal(score_T.T, score_d[:, flat_slots])
    np.testing.assert_array_equal(nc_T.T, nc_d[:, flat_slots])


@pytest.mark.parametrize("seed", [21, 22])
def test_bigmat_place_batch_matches_engine(seed):
    from usher_jax.placement.driver import PlacementEngine
    T, positions, refarr, samples = _setup(seed, n_leaves=30)
    big = BigMAT.from_tree(T, positions, refarr)
    bs, bslot, nb = big.place_batch(samples)

    eng = PlacementEngine(T, backend="dense",
                          extra_mutations=[m for s in samples for m in s])
    res = eng.score_samples(samples)
    for i, r in enumerate(res):
        assert int(bs[i]) == r.best_score
        assert int(nb[i]) == r.num_best
        assert big._nodes[int(bslot[i])].identifier == r.best_node.identifier


def test_bigmat_cli_byte_identical(tmp_path):
    """usher --bigmat must produce byte-identical outputs to the dense
    engine on the smoke workload (end-to-end: scoring, tie-breaks,
    surgery, epoch rebuilds across batches)."""
    import os
    import pytest
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    build = str(tmp_path / "b")
    pb = os.path.join(build, "out.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", build]) == 0
    dense = str(tmp_path / "dense")
    big = str(tmp_path / "big")
    new_vcf = os.path.join(ref_dir, "new_samples.vcf")
    assert usher_main(["-i", pb, "-v", new_vcf, "-d", dense,
                       "--mesh-devices", "0"]) == 0
    assert usher_main(["-i", pb, "-v", new_vcf, "-d", big,
                       "--bigmat", "--mesh-devices", "0"]) == 0
    for name in ("placement_stats.tsv", "final-tree.nh",
                 "mutation-paths.txt"):
        a = open(os.path.join(dense, name), "rb").read()
        b = open(os.path.join(big, name), "rb").read()
        assert a == b, f"{name} differs between bigmat and dense engines"


def test_bigmat_parsimony_scores_tsv(tmp_path):
    """usher -p --bigmat: per-node parsimony scores identical to dense."""
    import os
    import pytest
    scripts = REFERENCE_SCRIPTS_DIR
    if not os.path.exists(os.path.join(scripts, "testBranchLen2.nwk")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(scripts, "testBranchLen2.nwk"),
                       "-v", os.path.join(scripts, "testBranchLen2.vcf"),
                       "-o", pb, "-d", build]) == 0
    vcf = tmp_path / "new.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\n"
        "x\t1\t.\tA\tT\t.\t.\t.\t.\t1\n"
        "x\t6\t.\tA\tT\t.\t.\t.\t.\t1\n")
    d1 = str(tmp_path / "dense")
    d2 = str(tmp_path / "big")
    assert usher_main(["-i", pb, "-v", str(vcf), "-d", d1, "-p"]) == 0
    assert usher_main(["-i", pb, "-v", str(vcf), "-d", d2, "-p",
                       "--bigmat"]) == 0
    a = open(os.path.join(d1, "parsimony-scores.tsv")).read()
    b = open(os.path.join(d2, "parsimony-scores.tsv")).read()
    assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bigmat_spr_scoring_matches_dense(seed):
    """BigMAT.score_spr_T (sparse E=1-everywhere scoring with the base_spr
    aggregate) must equal the dense SPR formula used by
    optimize/spr.py _score_moves, including multi-bit ambiguity masks."""
    import jax.numpy as jnp
    from usher_jax.ops.placement import score_with_stp

    T, positions, refarr, samples = _setup(seed)
    big = BigMAT.from_tree(T, positions, refarr)
    N, P = big.N, big.P
    rng = np.random.default_rng(seed + 77)

    # dense st/stp from the CSR (materialize all columns)
    cols = np.arange(P)
    lo = big.csc_ptr[cols]
    hi = big.csc_ptr[cols + 1]
    counts = hi - lo
    import usher_jax.core.bigmat as bm
    flat_idx = np.repeat(lo, counts) + bm._ranges(counts)
    coo_col = np.repeat(cols, counts)
    coo_node = big.csc_node[flat_idx]
    coo_val = np.where(big.csc_eff[flat_idx], big.csc_mut[flat_idx], 0)
    m0 = np.zeros((N, P), dtype=np.uint8)
    m0[coo_node, coo_col] = coo_val
    val = m0.copy()
    for k in range(big.n_anc):
        val = np.where(val > 0, val, val[big.anc[k]])
    st = np.where(val > 0, val, refarr[None, :]).astype(np.uint8)
    stp = st[big.parent]
    stp[big.root_slot] = st[big.root_slot]

    # Fitch-mask-style g rows: mostly ref, some single/multi-bit deviations
    B, K = 5, 8
    g = np.tile(refarr, (B, 1))
    pos = np.full((B, K), P, dtype=np.int32)
    gval = np.zeros((B, K), dtype=np.uint8)
    for b in range(B):
        idx = rng.choice(P, size=min(K, P), replace=False)
        for j, p in enumerate(idx):
            v = int(rng.integers(1, 16))  # any mask incl. multi-bit
            if v == refarr[p]:
                v = (v % 15) + 1
            g[b, p] = v
            pos[b, j] = p
            gval[b, j] = v

    # dense SPR semantics (E=ones, miss=zeros)
    E = np.ones((B, P), dtype=bool)
    miss = np.zeros((B, P), dtype=bool)
    active = np.ones(N, dtype=bool)
    ds, dnc, dnnm = score_with_stp(
        jnp.asarray(st), jnp.asarray(stp), jnp.asarray(refarr),
        jnp.asarray(active), jnp.asarray(g), jnp.asarray(E),
        jnp.asarray(miss))
    ds, dnc = np.asarray(ds), np.asarray(dnc)

    ss_T, snc_T, snnm = big.score_spr_T(pos, gval, max_cols=16)
    np.testing.assert_array_equal(ss_T.T, ds)
    np.testing.assert_array_equal(snc_T.T, dnc)
    np.testing.assert_array_equal(snnm, np.asarray(dnnm))


def test_chain_consistency_checker():
    from usher_jax.core.bigmat import check_chain_consistency
    from usher_jax.core.tree import Mutation, Tree
    T = Tree()
    T.create_node("root")
    a = T.create_node("a", "root")
    b = T.create_node("b", "a")
    a.add_mutation(Mutation("c", 10, 1, 1, 8))
    b.add_mutation(Mutation("c", 10, 1, 8, 2))  # par matches a's mut: ok
    assert check_chain_consistency(T) == 0
    b.mutations[0].par_nuc = 1  # now inconsistent
    assert check_chain_consistency(T) == 1


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_interval_engine_matches_cols_path(seed):
    """The interval engine (DFS range-add scoring, ops/interval.py) must be
    bit-identical to the legacy column-materialization path in BOTH modes,
    on trees large enough to span several scan blocks."""
    T, positions, refarr, samples = _setup(seed, n_leaves=150,
                                           n_positions=40)
    big = BigMAT.from_tree(T, positions, refarr)
    pos, gval, kmiss = big.sparsify(samples)

    s_iv, nc_iv, _ = big.score_batch_T(pos, gval, kmiss)
    s_cols, nc_cols, _ = big.score_batch_T_cols(pos, gval, kmiss,
                                                max_cols=8)
    np.testing.assert_array_equal(s_iv, s_cols)
    np.testing.assert_array_equal(nc_iv, nc_cols)

    # SPR mode (E=1 everywhere, ambiguous masks allowed)
    rng = np.random.default_rng(seed)
    gv2 = gval.copy()
    nonpad = pos < big.P
    gv2[nonpad] = rng.integers(1, 16, size=int(nonpad.sum()),
                               dtype=np.uint8)
    s2_iv, nc2_iv, _ = big.score_spr_T(pos, gv2)
    s2_c, nc2_c, _ = big.score_spr_T_cols(pos, gv2, max_cols=8)
    np.testing.assert_array_equal(s2_iv, s2_c)
    np.testing.assert_array_equal(nc2_iv, nc2_c)


def test_dfs_numbering():
    """dfs_of/dfs_end_of computed by the vectorized level sweep must be a
    valid preorder: parent interval contains child intervals, siblings
    disjoint, every interval's width is the subtree size."""
    T, positions, refarr, _ = _setup(5, n_leaves=80)
    big = BigMAT.from_tree(T, positions, refarr)
    N = big.N
    assert sorted(big.dfs_of.tolist()) == list(range(N))
    for i in range(N):
        p = int(big.parent[i])
        if p != i:
            assert big.dfs_of[p] < big.dfs_of[i]
            assert big.dfs_end_of[i] <= big.dfs_end_of[p]
    # dfs_order is the inverse permutation
    np.testing.assert_array_equal(big.dfs_of[big.dfs_order],
                                  np.arange(N, dtype=np.int32))


def _assert_bigmat_equal(a, b):
    """Incrementally-maintained BigMAT must match a fresh from_tree build
    in every scoring-relevant array (slot numbering may differ — compare
    in DFS order via the node identity mapping)."""
    assert a.N == b.N
    # map a-slot -> b-slot by node identity
    b_slot = {id(n): i for i, n in enumerate(b._nodes)}
    amap = np.array([b_slot[id(n)] for n in a._nodes])
    np.testing.assert_array_equal(a.base, b.base[amap])
    np.testing.assert_array_equal(a.nc_base, b.nc_base[amap])
    np.testing.assert_array_equal(a.node_num_mut, b.node_num_mut[amap])
    np.testing.assert_array_equal(a.F, b.F[amap])
    np.testing.assert_array_equal(a.num_leaves, b.num_leaves[amap])
    np.testing.assert_array_equal(a.level, b.level[amap])
    np.testing.assert_array_equal(a.is_leaf, b.is_leaf[amap])
    np.testing.assert_array_equal(a.bfs_rank, b.bfs_rank[amap])
    np.testing.assert_array_equal(a.dfs_of, b.dfs_of[amap])
    np.testing.assert_array_equal(a.dfs_end_of, b.dfs_end_of[amap])


@pytest.mark.parametrize("seed", [41, 42])
def test_incremental_appends_match_rebuild(seed):
    """Place a stream of samples through BigPlacementEngine; the snapshot
    must be maintained by O(delta) appends (ZERO from_tree rebuilds after
    the first) and stay bit-identical to a from-scratch rebuild."""
    from usher_jax.core import bigmat as bm
    from usher_jax.placement.big_engine import BigPlacementEngine
    from usher_jax.placement.driver import PlacementEngine
    from usher_jax.placement.mapper import score_placement

    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=40, n_positions=25)
    samples = [(f"S{i}", random_sample(rng, ref)) for i in range(12)]
    T2 = T.copy()

    eng = BigPlacementEngine(
        T, extra_mutations=[m for _, s in samples for m in s])
    dense = PlacementEngine(
        T2, backend="dense",
        extra_mutations=[m for _, s in samples for m in s])

    builds = {"n": 0}
    orig = bm.BigMAT.from_tree.__func__

    def counting(cls, *a, **k):
        builds["n"] += 1
        return orig(cls, *a, **k)
    bm.BigMAT.from_tree = classmethod(counting)
    try:
        for name, muts in samples:
            muts.sort(key=lambda m: m.position)
            rb = eng.score_samples([muts])[0]
            rd = dense.score_samples([muts])[0]
            assert rb.best_score == rd.best_score
            assert rb.num_best == rd.num_best
            assert rb.best_node.identifier == rd.best_node.identifier
            db = score_placement(rb.best_node, muts)
            dd = score_placement(rd.best_node, muts)
            eng.apply_placement(name, rb, db.excess)
            dense.apply_placement(name, rd, dd.excess)
    finally:
        bm.BigMAT.from_tree = classmethod(orig)
    assert builds["n"] == 1, f"expected 1 initial build, got {builds['n']}"

    # evolved trees identical
    from usher_jax.io.newick import write_newick
    assert write_newick(T, print_internal=True, print_branch_len=True) == \
        write_newick(T2, print_internal=True, print_branch_len=True)

    # maintained arrays == from-scratch rebuild of the evolved tree
    eng._big._flush()
    fresh = bm.BigMAT.from_tree(T, eng.positions, eng.ref)
    _assert_bigmat_equal(eng._big, fresh)


def test_place_arrays_dev_expansion_with_overlay():
    """place_arrays (device-side CSC expansion + overlay events) must match
    the host-expansion scoring path after incremental appends."""
    from usher_jax.core.bigmat import BigMAT
    from usher_jax.placement.big_engine import BigPlacementEngine
    from usher_jax.placement.mapper import score_placement

    rng = np.random.default_rng(77)
    T, ref = random_mat(rng, n_leaves=35, n_positions=22)
    samples = [(f"S{i}", random_sample(rng, ref)) for i in range(8)]
    eng = BigPlacementEngine(
        T, extra_mutations=[m for _, s in samples for m in s])
    for name, muts in samples[:5]:
        muts.sort(key=lambda m: m.position)
        r = eng.score_samples([muts])[0]
        d = score_placement(r.best_node, muts)
        eng.apply_placement(name, r, d.excess)
    big = eng._ensure()
    assert big._ov is not None or big._appended  # overlay exercised

    probe = [s for _, s in samples[5:]]
    for muts in probe:
        muts.sort(key=lambda m: m.position)
    pos, gval, kmiss = big.sparsify(probe)
    # host path reference
    sT, ncT, nnm = big.score_batch_T(pos, gval, kmiss)
    from usher_jax.ops.placement import placement_outputs
    valid, _ = placement_outputs(sT.T, ncT.T, nnm, big.is_root_mask,
                                 big.is_leaf, big.active)
    valid = np.asarray(valid)
    vs = np.where(valid, sT.T, 1 << 30)
    exp_best = vs.min(axis=1)
    exp_nb = (valid & (sT.T == exp_best[:, None])).sum(axis=1)

    bs, slot, nb, hu = big.place_arrays(pos, gval, kmiss)
    np.testing.assert_array_equal(bs, exp_best)
    np.testing.assert_array_equal(nb, exp_nb)


def test_spr_scoring_after_incremental_appends():
    """base_spr / score_spr_T must be exact AFTER incremental appends
    (sibling split + child insert): compared against a from-scratch
    rebuild of the evolved tree (regression: the spr aggregates were
    derived from stale precompute-time snapshots)."""
    from usher_jax.core.bigmat import BigMAT
    from usher_jax.placement.big_engine import BigPlacementEngine
    from usher_jax.placement.mapper import score_placement

    rng = np.random.default_rng(55)
    T, ref = random_mat(rng, n_leaves=30, n_positions=18)
    samples = [(f"S{i}", random_sample(rng, ref)) for i in range(6)]
    eng = BigPlacementEngine(
        T, extra_mutations=[m for _, s in samples for m in s])
    for name, muts in samples:
        muts.sort(key=lambda m: m.position)
        r = eng.score_samples([muts])[0]
        d = score_placement(r.best_node, muts)
        eng.apply_placement(name, r, d.excess)
    big = eng._ensure()
    assert big._appended or big._pending
    big._flush()  # materialize queued appends before mapping nodes

    fresh = BigMAT.from_tree(T, eng.positions, eng.ref)
    b_slot = {id(n): i for i, n in enumerate(fresh._nodes)}
    amap = np.array([b_slot[id(n)] for n in big._nodes])
    np.testing.assert_array_equal(big.base_spr, fresh.base_spr[amap])

    K = 6
    pos = rng.integers(0, big.P, size=(4, K)).astype(np.int32)
    gval = np.array([1, 2, 4, 8], np.uint8)[
        rng.integers(0, 4, size=(4, K))]
    s1, n1, _ = big.score_spr_T(pos, gval)
    s2, n2, _ = fresh.score_spr_T(pos, gval)
    np.testing.assert_array_equal(s1, s2[amap])
    np.testing.assert_array_equal(n1, n2[amap])


def test_no_recompile_across_append_batches():
    """The device-expansion program must NOT recompile as incremental
    appends grow N (regression: raw [N]-shaped dfs arrays in the resident
    CSC cache changed the jit signature every flush; each recompile
    costs seconds to minutes)."""
    from usher_jax.ops import interval as iv
    from usher_jax.placement.big_engine import BigPlacementEngine
    from usher_jax.placement.mapper import score_placement

    rng = np.random.default_rng(3)
    T, ref = random_mat(rng, n_leaves=40, n_positions=25)
    samples = [(f"S{i}", random_sample(rng, ref)) for i in range(8)]
    eng = BigPlacementEngine(
        T, extra_mutations=[m for _, s in samples for m in s])
    sizes = []
    for name, muts in samples:
        muts.sort(key=lambda m: m.position)
        big = eng._ensure()
        pos, gval, kmiss = big.sparsify([muts])
        big.place_arrays(pos, gval, kmiss)
        r = eng.score_samples([muts])[0]
        d = score_placement(r.best_node, muts)
        eng.apply_placement(name, r, d.excess)
        sizes.append(iv.interval_place_dev._cache_size())
    # shapes settle after the first call; appends must not grow the cache
    assert sizes[-1] == sizes[1], sizes


def test_no_recompile_in_direct_serving_loop(tmp_path):
    """The FULL serving loop (place_arrays with the runner-up reduce +
    incremental appends + fallbacks) must settle on ONE compiled program
    after its first batch: per-batch jit-shape drift (overlay event
    buckets, per-batch mc) silently costs a compile or compiled-program
    reload on EVERY batch."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_direct_exact import (adversarial_samples, consistent_mat,
                                   _copy_sample)
    from usher_jax.io import pb_arrays as pa
    from usher_jax.ops import interval as iv
    from usher_jax.placement.direct import DirectOptions, DirectPlacer

    rng = np.random.default_rng(5)
    ma, state, is_leaf = consistent_mat(rng, N=250, P=120)
    pb = str(tmp_path / "t.pb")
    pa.save_arrays_to_pb(ma, pb)
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=64)
    placer = DirectPlacer(pb)
    placer.missing = [_copy_sample(s) for s in samples]
    sizes = []
    orig = DirectPlacer.apply_placement

    def spy(self, *a, **k):
        sizes.append(iv.interval_place_dev._cache_size())
        return orig(self, *a, **k)

    DirectPlacer.apply_placement = spy
    try:
        placer.place_all(DirectOptions(outdir=str(tmp_path / "o"),
                                       batch_size=8))
    finally:
        DirectPlacer.apply_placement = orig
    # after the second batch (overlay active) the program set is fixed
    later = [s for s in sizes[16:]]
    assert later and max(later) == min(later), sizes


@pytest.mark.parametrize("seed", list(range(5)))
@pytest.mark.parametrize("min_group", [2, 6, 10_000])
def test_place_arrays_grouped_matches_plain(seed, min_group):
    """Shared-ancestry decomposition (group columns + signed residuals)
    must be bit-identical to scoring the full entry sets — including
    back-mutation overrides (random_mat emits back-to-ref mutations) and
    the anchor=root degenerate case (min_group > batch)."""
    from usher_jax.matutils.arrays import _ancestral_set_triplets
    rng = np.random.default_rng(seed + 400)
    T, ref = random_mat(rng, n_leaves=60, n_positions=20, mut_rate=0.9)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    big = BigMAT.from_tree(T, positions, refarr)
    leaf_slots = np.nonzero(big.is_leaf)[0]
    slots = rng.choice(leaf_slots, size=40, replace=True).tolist()

    grouped = big.group_ancestral_batch(slots, min_group=min_group,
                                        gcap=3)

    full = [_ancestral_set_triplets(big, s) for s in slots]
    K = max((len(f) for f in full), default=0) or 1
    B = len(slots)
    pos = np.full((B, K), big.P, np.int32)
    gval = np.zeros((B, K), np.uint8)
    for i, f in enumerate(full):
        for k, (c, v) in enumerate(f):
            pos[i, k] = c
            gval[i, k] = v
    kmiss = np.zeros((B, K), bool)

    plain = big.place_arrays(pos, gval, kmiss)
    grp = big.place_arrays_grouped(*grouped)
    for a, b in zip(plain, grp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    p2 = big.place_arrays(pos, gval, kmiss, with_second=True)
    g2 = big.place_arrays_grouped(*grouped, with_second=True)
    for ta, tb in zip(p2, g2):
        for a, b in zip(ta, tb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

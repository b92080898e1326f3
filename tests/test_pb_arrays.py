"""Array-form parsimony.pb loading (io/pb_arrays.py) vs the Node-object
loader: identical trees, scoring aggregates, tie-break ranks, placements,
and newick output — via both the native C++ scanners and the pure-Python
fallback."""

import os
import numpy as np
import pytest

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

from usher_jax.core.bigmat import BigMAT
from usher_jax.core.flat import collect_positions
from usher_jax.io import pb_arrays as pa
from usher_jax.io.newick import write_newick
from usher_jax.io.pbio import load_mat_pb, save_mat_pb

from test_placement import random_mat, random_sample


def _roundtrip(tmp_path, seed, native):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=60, n_positions=30)
    # annotations + condensed metadata survive the array load
    for i, nd in enumerate(T.depth_first_expansion()):
        nd.clade_annotations = [f"c{i % 5}", ""]
    T.condensed_nodes["cn_1"] = ["x1", "x2"]
    path = str(tmp_path / "t.pb")
    save_mat_pb(T, path)

    T2 = load_mat_pb(path)
    positions, refarr, _ = collect_positions(T2)
    big1 = BigMAT.from_tree(T2, positions, refarr)

    if not native:
        import usher_jax.native as nat
        orig = nat.HAVE_NATIVE
        nat.HAVE_NATIVE = False
        try:
            ma = pa.load_mat_arrays(path)
        finally:
            nat.HAVE_NATIVE = orig
    else:
        ma = pa.load_mat_arrays(path)
    big2 = ma.to_bigmat()
    return T2, big1, big2, ma, rng, ref


@pytest.mark.parametrize("native", [True, False])
def test_array_load_matches_node_load(tmp_path, native):
    import usher_jax.native as nat
    if native and not nat.HAVE_NATIVE:
        pytest.skip("native extension not built")
    T2, big1, big2, ma, rng, ref = _roundtrip(tmp_path, 3, native)
    assert big1.N == big2.N == ma.n

    # match nodes by name (big1 slots are BFS, big2 slots are preorder)
    names1 = [nd.identifier for nd in big1._nodes]
    names2 = ma.names()
    m2 = {nm: i for i, nm in enumerate(names2)}
    amap = np.array([m2[nm] for nm in names1])
    np.testing.assert_array_equal(big1.base, big2.base[amap])
    np.testing.assert_array_equal(big1.nc_base, big2.nc_base[amap])
    np.testing.assert_array_equal(big1.node_num_mut,
                                  big2.node_num_mut[amap])
    np.testing.assert_array_equal(big1.num_leaves, big2.num_leaves[amap])
    np.testing.assert_array_equal(big1.level, big2.level[amap])
    np.testing.assert_array_equal(big1.bfs_rank, big2.bfs_rank[amap])
    np.testing.assert_array_equal(big1.dfs_of, big2.dfs_of[amap])
    np.testing.assert_array_equal(big1.dfs_end_of, big2.dfs_end_of[amap])
    np.testing.assert_array_equal(big1.positions, big2.positions)
    np.testing.assert_array_equal(big1.ref, big2.ref)

    # identical placements incl. EPP counts and the tie-break winner
    samples = [random_sample(rng, ref) for _ in range(6)]
    samples = [[m for m in s
                if m.position in set(big1.positions.tolist())]
               for s in samples]
    samples = [s for s in samples if s]
    bs1, slot1, nb1 = big1.place_batch(samples)
    bs2, slot2, nb2 = big2.place_batch(samples)
    np.testing.assert_array_equal(bs1, bs2)
    np.testing.assert_array_equal(nb1, nb2)
    for a, b in zip(slot1, slot2):
        assert names1[int(a)] == names2[int(b)]

    # metadata round-tripped
    assert ma.condensed == [("cn_1", ["x1", "x2"])]
    anns = ma.ann_blob.decode().split("\0")[:-1]
    assert len(anns) == int(ma.ann_counts.sum())

    # newick writer parity
    assert pa.write_newick_arrays(ma) == write_newick(
        T2, print_internal=True, print_branch_len=True)


def test_native_and_python_loaders_agree(tmp_path):
    import usher_jax.native as nat
    if not nat.HAVE_NATIVE:
        pytest.skip("native extension not built")
    _, _, bigN, maN, _, _ = _roundtrip(tmp_path, 5, True)
    _, _, bigP, maP, _, _ = _roundtrip(tmp_path, 5, False)
    np.testing.assert_array_equal(maN.parent, maP.parent)
    assert maN.names_blob == maP.names_blob
    np.testing.assert_array_equal(maN.mut_ptr, maP.mut_ptr)
    np.testing.assert_array_equal(maN.mut_col, maP.mut_col)
    np.testing.assert_array_equal(maN.mut_par, maP.mut_par)
    np.testing.assert_array_equal(maN.mut_mut, maP.mut_mut)
    assert maN.chrom == maP.chrom


def test_pb_direct_byte_identical_to_bigmat(tmp_path):
    """usher --pb-direct (no-Tree array driver) must produce byte-identical
    placement_stats.tsv / final-tree.nh / mutation-paths.txt to the
    Tree-backed --bigmat engine on the reference smoke fixture."""
    import os
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main

    pb = str(tmp_path / "out.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", str(tmp_path / "b"),
                       "--mesh-devices", "0"]) == 0

    d1 = str(tmp_path / "p1")
    d2 = str(tmp_path / "p2")
    assert usher_main(["-i", pb,
                       "-v", os.path.join(ref_dir, "new_samples.vcf"),
                       "-o", str(tmp_path / "o1.pb"), "-d", d1,
                       "--bigmat", "--mesh-devices", "0"]) == 0
    assert usher_main(["-i", pb,
                       "-v", os.path.join(ref_dir, "new_samples.vcf"),
                       "-d", d2, "--pb-direct",
                       "--mesh-devices", "0"]) == 0

    for fn in ("placement_stats.tsv", "final-tree.nh",
               "mutation-paths.txt"):
        with open(os.path.join(d1, fn)) as f1, \
                open(os.path.join(d2, fn)) as f2:
            assert f1.read() == f2.read(), fn


def test_save_arrays_roundtrip(tmp_path):
    """save_arrays_to_pb must be byte-compatible with save_mat_pb for the
    same tree, and roundtrip through both loaders."""
    rng = np.random.default_rng(13)
    T, ref = random_mat(rng, n_leaves=40, n_positions=20)
    for i, nd in enumerate(T.depth_first_expansion()):
        nd.clade_annotations = [f"a{i % 3}"]
    T.condensed_nodes["cn_2"] = ["y1", "y2"]
    p1 = str(tmp_path / "a.pb")
    p2 = str(tmp_path / "b.pb")
    save_mat_pb(T, p1)
    ma = pa.load_mat_arrays(p1)
    pa.save_arrays_to_pb(ma, p2)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    ma2 = pa.load_mat_arrays(p2)
    np.testing.assert_array_equal(ma.parent, ma2.parent)
    np.testing.assert_array_equal(ma.mut_ptr, ma2.mut_ptr)
    np.testing.assert_array_equal(ma.mut_col, ma2.mut_col)
    np.testing.assert_array_equal(ma.mut_mut, ma2.mut_mut)
    assert ma.names_blob == ma2.names_blob
    assert ma.condensed == ma2.condensed
    assert ma.ann_blob == ma2.ann_blob


@pytest.mark.parametrize("extra", [["-n"], ["-E", "0"], ["-e", "1"]])
def test_pb_direct_flag_parity(tmp_path, extra):
    """--pb-direct must match --bigmat under no-add and threshold flags
    too (stats tsv + final tree byte-equal)."""
    import os
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main

    pb = str(tmp_path / "out.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", str(tmp_path / "b"),
                       "--mesh-devices", "0"]) == 0
    d1, d2 = str(tmp_path / "p1"), str(tmp_path / "p2")
    base = ["-i", pb, "-v", os.path.join(ref_dir, "new_samples.vcf"),
            "--mesh-devices", "0"]
    assert usher_main(base + ["-d", d1, "--bigmat"] + extra) == 0
    assert usher_main(base + ["-d", d2, "--pb-direct"] + extra) == 0
    for fn in ("placement_stats.tsv", "final-tree.nh"):
        with open(os.path.join(d1, fn)) as f1, \
                open(os.path.join(d2, fn)) as f2:
            assert f1.read() == f2.read(), (fn, extra)


def test_pb_direct_mesh_identical(tmp_path):
    """--pb-direct --mesh-devices 8 (batch shard_map) must be byte-equal
    to single-device direct placement."""
    import os
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main

    pb = str(tmp_path / "out.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", str(tmp_path / "b"),
                       "--mesh-devices", "0"]) == 0
    d1, d2 = str(tmp_path / "p1"), str(tmp_path / "p2")
    base = ["-i", pb, "-v", os.path.join(ref_dir, "new_samples.vcf"),
            "--pb-direct"]
    assert usher_main(base + ["-d", d1, "--mesh-devices", "0"]) == 0
    assert usher_main(base + ["-d", d2, "--mesh-devices", "8"]) == 0
    for fn in ("placement_stats.tsv", "final-tree.nh",
               "mutation-paths.txt"):
        with open(os.path.join(d1, fn)) as f1, \
                open(os.path.join(d2, fn)) as f2:
            assert f1.read() == f2.read(), fn


def test_pb_direct_duplicate_sample_skipped(tmp_path):
    """A sample appearing twice in the VCF is placed once and warned about
    on the second occurrence (run_usher's mid-loop T.get_node check)."""
    rng = np.random.default_rng(21)
    T, ref = random_mat(rng, n_leaves=25, n_positions=15)
    pb = str(tmp_path / "t.pb")
    save_mat_pb(T, pb)
    positions = sorted(ref)
    bases = {1: "A", 2: "C", 4: "G", 8: "T"}
    vcf = str(tmp_path / "s.vcf")
    with open(vcf, "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                "DUP\tDUP\n")
        p0 = positions[0]
        r = ref[p0]
        alt = 1 if r != 1 else 2
        f.write(f"c\t{p0}\t.\t{bases[r]}\t{bases[alt]}\t.\t.\t.\tGT\t1\t1\n")
    from usher_jax.placement.direct import DirectOptions, run_usher_direct
    out = str(tmp_path / "o")
    assert run_usher_direct(pb, vcf, DirectOptions(outdir=out)) == 0
    tree = open(os.path.join(out, "final-tree.nh")).read()
    assert tree.count("DUP") == 1


def test_pb_direct_save_and_uncondensed_byte_identical(tmp_path):
    """--pb-direct -o (array-native re-condense + pb save) and -u
    (uncondensed newick) must byte-match the Tree-backed --bigmat
    outputs on the smoke fixture (which exercises real condensed
    nodes through expansion and re-condensation)."""
    import os
    ref_dir = REFERENCE_TEST_DIR
    if not os.path.exists(os.path.join(ref_dir, "global_phylo.nh")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main

    pb = str(tmp_path / "out.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", str(tmp_path / "b"),
                       "--mesh-devices", "0"]) == 0

    d1 = str(tmp_path / "p1")
    d2 = str(tmp_path / "p2")
    assert usher_main(["-i", pb,
                       "-v", os.path.join(ref_dir, "new_samples.vcf"),
                       "-o", str(tmp_path / "o1.pb"), "-d", d1, "-u",
                       "--bigmat", "--mesh-devices", "0"]) == 0
    assert usher_main(["-i", pb,
                       "-v", os.path.join(ref_dir, "new_samples.vcf"),
                       "-o", str(tmp_path / "o2.pb"), "-d", d2, "-u",
                       "--pb-direct", "--mesh-devices", "0"]) == 0

    with open(os.path.join(d1, "uncondensed-final-tree.nh")) as f1, \
            open(os.path.join(d2, "uncondensed-final-tree.nh")) as f2:
        assert f1.read() == f2.read()
    assert open(str(tmp_path / "o1.pb"), "rb").read() == \
        open(str(tmp_path / "o2.pb"), "rb").read()


def test_pb_direct_save_annotated_parity(tmp_path):
    """-o parity on an ANNOTATED MAT: placement-created nodes must carry
    the empty annotation columns the Tree path writes (review finding:
    previously zero entries)."""
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.io.newick import parse_newick_string
    from usher_jax.io.pbio import save_mat_pb
    from usher_jax.core.tree import Mutation

    T = parse_newick_string("((A:1,B:1):1,(C:1,D:1):1):0;")
    pos = {"A": (100, 1, 2), "B": (120, 1, 4), "C": (140, 2, 8),
           "D": (160, 4, 1)}
    for leaf, (p, par, mut) in pos.items():
        T.get_node(leaf).add_mutation(Mutation("c", p, par, par, mut))
    root = T.root
    for n in T.depth_first_expansion():
        n.clade_annotations = ["", ""]
    root.clade_annotations = ["19A", "X"]
    root.children[0].clade_annotations = ["20A", ""]
    pb = str(tmp_path / "ann.pb")
    save_mat_pb(T, pb)

    vcf = tmp_path / "s.vcf"
    vcf.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2\n"
        "c\t100\t.\tA\tC\t.\t.\t.\tGT\t1\t0\n"
        "c\t140\t.\tC\tT\t.\t.\t.\tGT\t0\t1\n")

    d1, d2 = str(tmp_path / "p1"), str(tmp_path / "p2")
    assert usher_main(["-i", pb, "-v", str(vcf),
                       "-o", str(tmp_path / "o1.pb"), "-d", d1,
                       "--bigmat", "--mesh-devices", "0"]) == 0
    assert usher_main(["-i", pb, "-v", str(vcf),
                       "-o", str(tmp_path / "o2.pb"), "-d", d2,
                       "--pb-direct", "--mesh-devices", "0"]) == 0
    assert open(str(tmp_path / "o1.pb"), "rb").read() == \
        open(str(tmp_path / "o2.pb"), "rb").read()


def test_save_vec_encoder_matches_loop(tmp_path, monkeypatch):
    """The vectorized node_mutations encoder must be byte-identical to
    the per-field loop, including ambiguous mut_nuc nibbles (packed
    multi-nt lists) and condensed/annotated MATs."""
    import numpy as np
    from usher_jax.io import pb_arrays as pa

    rng = np.random.default_rng(17)
    n, P = 400, 60
    parent = np.zeros(n, np.int32)
    parent[1:] = (rng.random(n - 1) * np.arange(1, n)).astype(np.int32)
    counts = rng.integers(0, 4, size=n)
    counts[0] = 0
    mut_ptr = np.zeros(n + 1, np.int64)
    mut_ptr[1:] = np.cumsum(counts)
    M = int(mut_ptr[-1])
    mut_col = rng.integers(0, P, size=M).astype(np.int32)
    NIB = np.array([1, 2, 4, 8], np.uint8)
    ref = NIB[rng.integers(0, 4, size=P)]
    mut_par = NIB[rng.integers(0, 4, size=M)]
    # ambiguous targets: mix single bases with multi-bit nibbles
    mut_mut = rng.integers(1, 16, size=M).astype(np.uint8)
    names = [f"s{i}" for i in range(n)]
    blob = ("\0".join(names) + "\0").encode()
    off = np.zeros(n + 1, np.int64)
    off[1:] = np.nonzero(np.frombuffer(blob, np.uint8) == 0)[0] + 1
    ma = pa.MatArrays(
        parent=parent, names_blob=blob, name_off=off,
        blen=np.full(n, -1.0), mut_ptr=mut_ptr, mut_col=mut_col,
        mut_par=mut_par, mut_mut=mut_mut,
        positions=np.arange(100, 100 + P, dtype=np.int64), ref=ref,
        chrom="NC_045512v2", condensed=[("s1", ["a", "b"])],
        ann_counts=np.ones(n, np.int32),
        ann_blob=("\0".join("c" for _ in range(n)) + "\0").encode())
    fast = str(tmp_path / "fast.pb")
    slow = str(tmp_path / "slow.pb")
    pa.save_arrays_to_pb(ma, fast)
    monkeypatch.setattr(pa, "_mutation_blocks_vec", lambda *a: None)
    pa.save_arrays_to_pb(ma, slow)
    assert open(fast, "rb").read() == open(slow, "rb").read()

"""Multi-chip sharded placement on the virtual 8-device CPU mesh: the
sharded step must agree exactly with the single-device kernel, and the
graft entry points must run."""

import numpy as np
import jax

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

from usher_jax.ops import placement as dev
from usher_jax.parallel import make_mesh, sharded_placement_step, shard_flat_inputs

import sys
sys.path.insert(0, "/root/repo")
from __graft_entry__ import _tiny_inputs, entry, dryrun_multichip  # noqa: E402


def test_mesh_shape():
    mesh = make_mesh(8)
    assert mesh.shape["data"] * mesh.shape["model"] == 8
    assert mesh.shape["data"] == 2


def test_sharded_matches_single_device():
    args = _tiny_inputs(N=64, P=128, B=8)
    (st, stp, ref, active, num_leaves, bfs_rank, is_leaf, is_root_mask,
     g, E, miss) = args

    # single-device ground truth
    score, num_common, node_num_mut = dev.score_with_stp(
        st, stp, ref, active, g, E, miss)
    score = np.asarray(score)
    valid, has_unique = dev.placement_outputs(
        np.asarray(score), np.asarray(num_common), np.asarray(node_num_mut),
        is_root_mask, is_leaf, active)
    bs, bslot, nb = dev.reduce_best(
        score, jax.numpy.asarray(valid), num_leaves, bfs_rank)

    mesh = make_mesh(8)
    sharded = shard_flat_inputs(mesh, *args)
    step = sharded_placement_step(mesh)
    best_score, best_rank, num_best = step(*sharded)

    np.testing.assert_array_equal(np.asarray(best_score), np.asarray(bs))
    np.testing.assert_array_equal(np.asarray(num_best), np.asarray(nb))
    np.testing.assert_array_equal(np.asarray(best_rank),
                                  bfs_rank[np.asarray(bslot)])


def test_entry_jittable():
    fn, args = entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (args[4].shape[0], args[0].shape[0])


def test_dryrun_multichip():
    dryrun_multichip(8)


def test_mesh_engine_end_to_end_byte_identical(tmp_path):
    """The full usher CLI run through the sharded (data, model) mesh path
    must produce byte-identical placement_stats.tsv / final-tree.nh /
    mutation-paths.txt to the single-device run — real samples, real
    surgery, staleness discipline included."""
    import os
    from usher_jax.cli.usher_cli import main as usher_main

    ref_dir = REFERENCE_TEST_DIR
    nh = os.path.join(ref_dir, "global_phylo.nh")
    vcf = os.path.join(ref_dir, "global_samples.vcf")
    new_vcf = os.path.join(ref_dir, "new_samples.vcf")
    if not os.path.exists(nh):
        import pytest
        pytest.skip("reference fixtures unavailable")

    build = str(tmp_path / "build")
    pb = os.path.join(build, "out.pb")
    assert usher_main(["-t", nh, "-v", vcf, "-o", pb, "-d", build,
                       "--mesh-devices", "0"]) == 0

    out_single = str(tmp_path / "single")
    out_mesh = str(tmp_path / "mesh")
    assert usher_main(["-i", pb, "-v", new_vcf, "-d", out_single,
                       "--mesh-devices", "0"]) == 0
    assert usher_main(["-i", pb, "-v", new_vcf, "-d", out_mesh,
                       "--mesh-devices", "8"]) == 0
    for fname in ["placement_stats.tsv", "final-tree.nh",
                  "mutation-paths.txt"]:
        a = open(os.path.join(out_single, fname), "rb").read()
        b = open(os.path.join(out_mesh, fname), "rb").read()
        assert a == b, f"{fname} differs between mesh and single-device"


def test_fitch_engine_mesh_identical(tmp_path):
    """Position-sharded Fitch-Sankoff (8-device CPU mesh) must produce
    bit-identical states/masks to single-device (the device-mesh analog of
    MPI position sharding, utils.cpp:113-481)."""
    import os
    import pytest
    scripts = REFERENCE_SCRIPTS_DIR
    if not os.path.exists(os.path.join(scripts, "testBranchLen2.nwk")):
        pytest.skip("reference fixtures unavailable")
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.core.flat import collect_positions
    from usher_jax.io.pbio import load_mat_pb
    from usher_jax.optimize.fitch import FitchEngine, leaf_masks_from_tree
    from usher_jax.parallel.shard import batch_mesh

    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(scripts, "testBranchLen2.nwk"),
                       "-v", os.path.join(scripts, "testBranchLen2.vcf"),
                       "-o", pb, "-d", build]) == 0
    T = load_mat_pb(pb)
    positions, ref, chrom = collect_positions(T)

    e1 = FitchEngine(T, positions, chunk=4)
    lm, rr = leaf_masks_from_tree(T, positions, e1.bfs)
    s1, m1 = e1.run(lm, rr)

    e2 = FitchEngine(T, positions, chunk=4, mesh=batch_mesh(8))
    s2, m2 = e2.run(lm, rr)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(m1, m2)


def test_optimize_mesh_identical(tmp_path):
    """matOptimize with FS/SPR sharded over the 8-device CPU mesh must give
    the same final tree as single-device (analog of the MPI SPR search,
    optimize_tree.cpp:165-252)."""
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
    pb = os.path.join(build, "o.pb")
    assert usher_main(["-t", os.path.join(ref_dir, "global_phylo.nh"),
                       "-v", os.path.join(ref_dir, "global_samples.vcf"),
                       "-o", pb, "-d", build]) == 0

    o1 = str(tmp_path / "opt1.pb")
    o8 = str(tmp_path / "opt8.pb")
    assert opt_main(["-i", pb, "-o", o1, "-N", "2", "-r", "4",
                     "--mesh-devices", "0"]) == 0
    assert opt_main(["-i", pb, "-o", o8, "-N", "2", "-r", "4",
                     "--mesh-devices", "8"]) == 0
    T1 = load_mat_pb(o1)
    T8 = load_mat_pb(o8)
    assert T1.get_parsimony_score() == T8.get_parsimony_score()
    assert write_newick(T1, print_internal=True, print_branch_len=True) == \
        write_newick(T8, print_internal=True, print_branch_len=True)


def test_bigmat_mesh_identical():
    """BigMAT interval scoring + placement + SPR search sharded over the
    8-device batch mesh must equal single-device bit-for-bit (mesh x
    pandemic-scale composition)."""
    import numpy as np
    from jax.sharding import Mesh
    import jax
    from usher_jax.core.bigmat import BigMAT
    from test_placement import random_mat, random_sample

    rng = np.random.default_rng(5)
    T, ref = random_mat(rng, n_leaves=120, n_positions=30)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    samples = [random_sample(rng, ref) for _ in range(19)]

    big1 = BigMAT.from_tree(T, positions, refarr)
    bigM = BigMAT.from_tree(T, positions, refarr)
    bigM.mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))

    pos, gval, kmiss = big1.sparsify(samples)
    s1, n1, _ = big1.score_batch_T(pos, gval, kmiss)
    sM, nM, _ = bigM.score_batch_T(pos, gval, kmiss)
    np.testing.assert_array_equal(s1, sM)
    np.testing.assert_array_equal(n1, nM)

    b1 = big1.place_batch(samples)
    bM = bigM.place_batch(samples)
    for a, b in zip(b1, bM):
        np.testing.assert_array_equal(a, b)


def test_big_move_finder_mesh_identical():
    """BigMoveFinder with the 8-device mesh must produce the same move list
    as single-device (replacing the reference's MPI SPR distribution,
    optimize_tree.cpp:165-252)."""
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from usher_jax.core.tree import Mutation, Tree
    from usher_jax.core.flat import collect_positions
    from usher_jax.optimize.fitch import FitchEngine
    from usher_jax.optimize.leafstore import SparseLeafStore
    from usher_jax.optimize.spr_big import BigMoveFinder

    rng = np.random.default_rng(3)
    bases = [1, 2, 4, 8]
    T = Tree(); T.create_node("root"); nodes = ["root"]
    for i in range(60):
        parent = nodes[int(rng.integers(len(nodes)))]
        nd = T.create_node(f"n{i}", parent)
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(100, 150))
            nd.add_mutation(Mutation("c", p, 1, 1,
                                     bases[int(rng.integers(1, 4))]))
        nodes.append(f"n{i}")
    positions, ref, chrom = collect_positions(T)
    eng = FitchEngine(T, positions, chunk=16)
    store, ref_row = SparseLeafStore.from_tree(T, positions)
    states, masks = eng.run(store, ref_row)
    eng.rewrite_mutations(states, store, ref_row, chrom)
    eng2 = FitchEngine(T, positions, chunk=16)
    states, masks = eng2.run(store, ref_row)

    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    f1 = BigMoveFinder(T, states, masks, ref_row, eng2.bfs, eng2.parent,
                       chunk=16, positions=positions)
    fM = BigMoveFinder(T, states, masks, ref_row, eng2.bfs, eng2.parent,
                       chunk=16, positions=positions, mesh=mesh)
    for radius in (2, 4, 1000):
        m1 = f1.find_moves(radius)
        m2 = fM.find_moves(radius)
        sig = lambda ms: [(m.src.identifier, m.dst.identifier,  # noqa: E731
                           m.improvement, m.sibling_split) for m in ms]
        assert sig(m1) == sig(m2), radius


def test_mesh_sparse_scorer_matches_dense():
    """The sharded sparse mesh scorer must equal the sharded dense
    scorer (multi-device keeps the sparse scorer's advantage)."""
    import numpy as np
    from usher_jax.core.tree import Tree
    from usher_jax.parallel.mesh import make_mesh
    from usher_jax.placement.driver import PlacementEngine
    from test_placement import random_mat, random_sample

    rng = np.random.default_rng(11)
    T, ref = random_mat(rng, n_leaves=60, n_positions=24)
    T2 = T.copy()
    samples = [random_sample(rng, ref) for _ in range(9)]
    mesh = make_mesh(8)
    eng_d = PlacementEngine(T, mesh=mesh, backend="dense",
                            extra_mutations=[m for s in samples for m in s])
    eng_s = PlacementEngine(T2, mesh=mesh, backend="sparse",
                            extra_mutations=[m for s in samples for m in s])
    r_d = eng_d.score_samples(samples)
    r_s = eng_s.score_samples(samples)
    for a, b in zip(r_d, r_s):
        assert a.best_score == b.best_score
        assert a.num_best == b.num_best
        assert a.best_node.identifier == b.best_node.identifier


def test_distributed_two_process_parity(tmp_path):
    """REAL 2-process jax.distributed execution: two CPU processes (4
    virtual devices each) join through a local coordinator, build the
    8-device GLOBAL mesh, and run placement + FS + SPR over it.  Process
    0's results must be byte-identical to a plain single-process run —
    the device-mesh replacement for the reference's three MPI protocols
    (src/usher-sampled/place_sample.cpp:591-662, utils.cpp:113-481,
    src/matOptimize/optimize_tree.cpp:165-252)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(__file__),
                          "distributed_worker.py")
    base_env = dict(os.environ)
    base_env["JAX_PLATFORMS"] = "cpu"

    # single-process golden (8 local virtual devices)
    env1 = dict(base_env)
    env1["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env1.pop("USHER_JAX_COORDINATOR", None)
    golden = tmp_path / "golden.json"
    out = subprocess.run([sys.executable, worker, str(golden)],
                         env=env1, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]

    # two distributed processes, 4 virtual devices each
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multi = tmp_path / "multi.json"
    procs = []
    for pid in range(2):
        env = dict(base_env)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["USHER_JAX_COORDINATOR"] = f"127.0.0.1:{port}"
        env["USHER_JAX_NUM_PROCESSES"] = "2"
        env["USHER_JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(multi)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for pid, p in enumerate(procs):
        sout, serr = p.communicate(timeout=600)
        assert p.returncode == 0, f"proc {pid}:\n{serr[-2000:]}"
        assert "worker done" in sout

    g = json.loads(golden.read_text())
    m = json.loads(multi.read_text())
    assert m["process_count"] == 2
    assert m["device_count"] == 8 == g["device_count"]
    for key in ("placement", "serve_stats", "serve_tree",
                "sampled_stats", "sampled_tree",
                "optimize_dense", "optimize_big"):
        assert g[key] == m[key], key
    # the sampled phase must actually have placed the widened workload
    assert len(m["sampled_stats"].splitlines()) >= 60
    assert m["sampled_wall_s"] > 0 and g["sampled_wall_s"] > 0


def test_distributed_degenerate_single_process(tmp_path):
    """--distributed must run the jax.distributed init path and a placement
    end-to-end in the degenerate 1-process case (real N-host runs need pod
    hardware; this proves the code path executes)."""
    import subprocess, sys, os
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax\n"
        "from usher_jax.parallel.distributed import (maybe_initialize,"
        " global_batch_mesh, is_leader)\n"
        "assert maybe_initialize()\n"
        "assert maybe_initialize()  # idempotent\n"
        "assert is_leader()\n"
        "m = global_batch_mesh()\n"
        "assert m.size == jax.device_count()\n"
        "print('distributed-ok', jax.process_count())\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd="/root/repo")
    assert out.returncode == 0, out.stderr
    assert "distributed-ok 1" in out.stdout

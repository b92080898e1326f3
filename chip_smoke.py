#!/usr/bin/env python
"""Bring-up check: the main paths once on the GPU, at real sizes.

    python chip_smoke.py              # one GPU: phases (a) to (d)
    python chip_smoke.py --four-gpus  # four GPUs: phase (a), then (e) only

  (a) device: the card's name and power limit (nvidia-smi) and JAX's
      devices; fails unless JAX's platform is gpu.
  (b) reference fixture, classic flow: usher builds a MAT from
      tests/fixtures/global_phylo.nh + global_samples.vcf and places
      new_samples.vcf; placement_stats.tsv and final-tree.nh must be
      byte-equal to tests/goldens/smoke_*.  matOptimize on the result must
      reach the final parsimony a CPU run reaches.
  (c) pandemic serving, the main path: a seeded 1M-node MAT over 30k sites
      written as a parsimony.pb and a 1,024-sample VCF (24 entries each),
      placed by `usher --pb-direct` in batches of 512.
  (d) device programs against their plain references, bit-identical (all
      outputs are integers): the interval engine against its numpy host
      mirror and the shared-ancestry path against the plain one at 1M x 30k,
      and the sparse placement step against the dense one (and 8 samples
      against the numpy scorer) at 100k x 512, B=1024.
  (e) --four-gpus: `usher --pb-direct --mesh-devices 4` on phase (c)'s
      inputs byte-equal to one device, and the fixture placed on the
      (data, model) mesh byte-equal to the goldens.

Every phase runs in this one process (one JAX client per card), the CLIs
through their main(argv).  Any failure makes the exit code non-zero.  The
last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}, printed
only when every phase passed.
"""

import argparse
import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
GOLDENS = os.path.join(REPO, "tests", "goldens")

# matOptimize's final parsimony on the placed reference fixture, as the same
# command reaches it on the CPU (JAX_PLATFORMS=cpu)
FIXTURE_OPT_PARSIMONY = 467

SEED = 20240
PANDEMIC = dict(N=1_000_000, P=30_000, B=1024, K=24, batch=512)
HOST_MIRROR_SAMPLES = 32
REPLACE_B = 256
NUMPY_SAMPLES = 8


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def same_bytes(a, b):
    check(filecmp.cmp(a, b, shallow=False), f"{a} differs from {b}")


def phase_device(n_devices):
    import jax
    devs = jax.devices()
    log(f"jax {jax.__version__}: {len(devs)} devices {devs}")
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform})")
    check(len(devs) >= n_devices, f"need {n_devices} GPUs, have {len(devs)}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in out.stdout.strip().splitlines():
        log(f"nvidia-smi: {line}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def peak_device_gib():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2**30


def place_fixture(tmp, mesh_devices):
    """Build the fixture MAT (one device) and place new_samples.vcf with
    the given --mesh-devices; returns (placed pb, output dir)."""
    from usher_jax.cli.usher_cli import main as usher
    out_pb = os.path.join(tmp, "fixture.pb")
    check(usher(["-t", os.path.join(FIXTURES, "global_phylo.nh"),
                 "-v", os.path.join(FIXTURES, "global_samples.vcf"),
                 "-o", out_pb, "-d", os.path.join(tmp, "fixture_build"),
                 "--mesh-devices", "0"]) == 0, "fixture build failed")
    outdir = os.path.join(tmp, f"fixture_place_m{mesh_devices}")
    placed = os.path.join(outdir, "placed.pb")
    check(usher(["-i", out_pb, "-v", os.path.join(FIXTURES,
                                                  "new_samples.vcf"),
                 "-o", placed, "-d", outdir,
                 "--mesh-devices", str(mesh_devices)]) == 0,
          "fixture placement failed")
    for name in ("placement_stats.tsv", "final-tree.nh"):
        same_bytes(os.path.join(outdir, name),
                   os.path.join(GOLDENS, "smoke_" + name.replace("-", "_")))
    log(f"fixture outputs byte-equal to the goldens "
        f"(--mesh-devices {mesh_devices})")
    return placed, outdir


def phase_fixture(tmp):
    from usher_jax.cli.matoptimize_cli import main as matoptimize
    from usher_jax.io.pbio import load_mat_pb
    placed, _ = place_fixture(tmp, 0)
    opt = os.path.join(tmp, "fixture_opt.pb")
    check(matoptimize(["-i", placed, "-o", opt]) == 0, "matOptimize failed")
    score = load_mat_pb(opt).get_parsimony_score()
    log(f"matOptimize final parsimony {score} "
        f"(CPU reaches {FIXTURE_OPT_PARSIMONY})")
    check(score == FIXTURE_OPT_PARSIMONY, "matOptimize parsimony differs")


def pandemic_inputs(tmp):
    from bench import write_direct_inputs
    t0 = time.time()
    pb, vcf = write_direct_inputs(np.random.default_rng(SEED),
                                  os.path.join(tmp, "pandemic"),
                                  PANDEMIC["N"], PANDEMIC["P"],
                                  PANDEMIC["B"], PANDEMIC["K"])
    log(f"generated {PANDEMIC['N']}-node x {PANDEMIC['P']}-site pb + "
        f"{PANDEMIC['B']}-sample VCF in {time.time()-t0:.1f} s (set-up)")
    return pb, vcf


def serve_direct(tmp, pb, vcf, mesh_devices):
    """usher --pb-direct through the CLI; returns (output dir, spans s)."""
    from usher_jax.cli.usher_cli import main as usher
    from usher_jax.utils.instrument import Instrumentor
    out = os.path.join(tmp, f"direct_m{mesh_devices}")
    trace = os.path.join(tmp, f"direct_m{mesh_devices}.trace.json")
    inst = Instrumentor.get()
    inst.begin_session(trace)
    t0 = time.time()
    try:
        rc = usher(["--pb-direct", "-i", pb, "-v", vcf, "-d", out,
                    "--batch-size", str(PANDEMIC["batch"]),
                    "--mesh-devices", str(mesh_devices)])
    finally:
        inst.end_session()
    total = time.time() - t0
    check(rc == 0, f"usher --pb-direct returned {rc}")
    with open(trace) as f:
        spans = {e["name"]: e["dur"] / 1e6
                 for e in json.load(f)["traceEvents"]
                 if e["name"].startswith("direct.")}
    spans["total"] = total
    return out, spans


def phase_serving(tmp):
    from usher_jax.io.newick import parse_newick
    pb, vcf = pandemic_inputs(tmp)
    out, spans = serve_direct(tmp, pb, vcf, 0)
    with open(os.path.join(out, "placement_stats.tsv")) as f:
        rows = [r for r in f.read().splitlines() if r]
    check(len(rows) == PANDEMIC["B"],
          f"placement_stats.tsv has {len(rows)} rows")
    T = parse_newick(os.path.join(out, "final-tree.nh"))
    n_leaves = len(T.get_leaves())
    check(T.root is not None and n_leaves > PANDEMIC["B"],
          "final-tree.nh does not parse to the placed tree")
    log(f"pandemic serving: {len(rows)} samples placed, final tree "
        f"{n_leaves} leaves; wall s: load {spans['direct.load']:.3f}, "
        f"place {spans['direct.place']:.3f} (compile included), write "
        f"{spans['direct.write']:.3f}, CLI total {spans['total']:.3f}; "
        f"{PANDEMIC['B'] / spans['direct.place']:.1f} samples/s in place; "
        f"peak device memory so far {peak_device_gib():.2f} GiB")


def random_entries(rng, B, K, P):
    from bench import NIBBLES
    pos = rng.integers(0, P, size=(B, K)).astype(np.int32)
    gval = NIBBLES[rng.integers(0, 4, size=(B, K))]
    return pos, gval, np.zeros((B, K), dtype=bool)


def check_interval_host_mirror(rng):
    from bench import synth_bigmat
    t0 = time.time()
    big = synth_bigmat(rng, PANDEMIC["N"], PANDEMIC["P"])
    log(f"built {PANDEMIC['N']}-node x {PANDEMIC['P']}-site CSR MAT in "
        f"{time.time()-t0:.1f} s (set-up)")
    pos, gval, kmiss = random_entries(rng, HOST_MIRROR_SAMPLES,
                                      PANDEMIC["K"], PANDEMIC["P"])
    t0 = time.time()
    bs, slot, nb, _hu = (np.asarray(x)
                         for x in big.place_arrays(pos, gval, kmiss))
    log(f"place_arrays B={HOST_MIRROR_SAMPLES}: {time.time()-t0:.1f} s "
        f"(compile included)")
    for b in range(HOST_MIRROR_SAMPLES):
        h = big.place_one_host(pos[b:b + 1], gval[b:b + 1], kmiss[b:b + 1])
        check((int(h[0]), int(h[1]), int(h[2])) == (bs[b], slot[b], nb[b]),
              f"sample {b}: device {(bs[b], slot[b], nb[b])} vs host "
              f"{tuple(int(x) for x in h[:3])}")
    log(f"interval engine == numpy host mirror on {HOST_MIRROR_SAMPLES} "
        f"samples at {PANDEMIC['N']} x {PANDEMIC['P']} (best_score, "
        f"best_slot, num_best)")


def check_grouped(rng):
    from bench import full_genotype_inputs, synth_lineage_bigmat
    t0 = time.time()
    big = synth_lineage_bigmat(rng, PANDEMIC["N"], PANDEMIC["P"])
    is_parent = np.zeros(big.N, bool)
    is_parent[big.parent] = True
    leaves = np.nonzero(~is_parent)[0]
    slots = rng.choice(leaves, size=REPLACE_B, replace=False).tolist()
    plain = full_genotype_inputs(big, slots)
    grouped = big.group_ancestral_batch(slots, min_group=3)
    log(f"lineage MAT + B={REPLACE_B} leaf re-placement inputs in "
        f"{time.time()-t0:.1f} s (set-up); full K={plain[0].shape[1]}, "
        f"{grouped[4].shape[0]} groups")
    r_plain = big.place_arrays(*plain)
    r_grp = big.place_arrays_grouped(*grouped)
    for name, a, b in zip(("best_score", "best_slot", "num_best",
                           "has_unique"), r_plain, r_grp):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"grouped {name} differs from plain")
    log(f"place_arrays_grouped == place_arrays for B={REPLACE_B} at "
        f"{PANDEMIC['N']} x {PANDEMIC['P']}")


def timed(fn, iters=5):
    """Steady-state seconds per call (first call excluded)."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.time()
    for _ in range(iters):
        jax.block_until_ready(fn())
    return (time.time() - t0) / iters


def check_sparse_step(rng):
    import jax.numpy as jnp
    from bench import (BATCH, N_NODES, P_SITES, dense_chunk,
                       dense_step_chunked, numpy_score_batch,
                       synth_flat_mat, synth_samples)
    from usher_jax.ops import placement as dense
    from usher_jax.ops import placement_sparse as sparse
    st, parent, ref, active, is_leaf, is_root, num_leaves, bfs_rank = \
        synth_flat_mat(rng)
    g, E, miss = synth_samples(rng, ref)
    pos, gval, kmiss = sparse.sparsify_dense(g, E, miss)
    node_args = tuple(jnp.asarray(x) for x in (
        st, parent, np.int32(0), ref, active, is_leaf, is_root, num_leaves,
        bfs_rank))
    sargs = node_args + tuple(jnp.asarray(x) for x in (pos, gval, kmiss))
    step = sparse.placement_step_sparse
    mem = step.lower(*sargs, pos.shape[1]).compile().memory_analysis()
    log(f"sparse step at {N_NODES} x {P_SITES}, B={BATCH}, "
        f"K={pos.shape[1]}: temp {mem.temp_size_in_bytes / 2**20:.1f} MiB")
    s_out = [np.asarray(x) for x in step(*sargs, pos.shape[1])]
    chunk = dense_chunk(node_args, g, E, miss)
    d_out = dense_step_chunked(node_args, g, E, miss, chunk)
    if chunk < BATCH:
        log(f"dense step compared in batch chunks of {chunk} (the whole "
            f"batch's temporaries exceed half the device memory)")
    for name, a, b in zip(("best_score", "best_slot", "num_best"),
                          s_out, d_out):
        check(np.array_equal(a, b), f"sparse {name} differs from dense")
    log(f"sparse step == dense step at {N_NODES} x {P_SITES}, B={BATCH}")

    t_sparse = timed(lambda: step(*sargs, pos.shape[1]))
    t_dense = timed(lambda: dense_step_chunked(node_args, g, E, miss,
                                               chunk), iters=3)
    log(f"step time at {N_NODES} x {P_SITES}, B={BATCH}: sparse "
        f"{t_sparse * 1e3:.3f} ms, dense {t_dense * 1e3:.3f} ms "
        f"(chunk {chunk}; host clock, block_until_ready)")

    n = NUMPY_SAMPLES
    stp = st[parent]
    stp[0] = st[0]
    ref_scores = numpy_score_batch(st, stp, ref, g[:n], E[:n], miss[:n])
    d_scores = np.asarray(dense.score_batch(
        *node_args[:4], node_args[4], g[:n], E[:n], miss[:n])[0])
    s_scores = np.asarray(sparse.score_sparse_T(
        *node_args[:4], pos[:n], gval[:n], kmiss[:n], pos.shape[1])[0]).T
    check(np.array_equal(d_scores, ref_scores), "dense != numpy scores")
    check(np.array_equal(s_scores, ref_scores), "sparse != numpy scores")
    log(f"sparse and dense scores == numpy scorer on {n} samples")


def phase_kernels(tmp):
    rng = np.random.default_rng(SEED + 1)
    check_interval_host_mirror(rng)
    check_grouped(rng)
    check_sparse_step(rng)
    log(f"peak device memory so far {peak_device_gib():.2f} GiB")


def phase_four(tmp):
    pb, vcf = pandemic_inputs(tmp)
    out1, sp1 = serve_direct(tmp, pb, vcf, 0)
    out4, sp4 = serve_direct(tmp, pb, vcf, 4)
    for name in ("placement_stats.tsv", "final-tree.nh",
                 "mutation-paths.txt"):
        same_bytes(os.path.join(out1, name), os.path.join(out4, name))
    log(f"usher --pb-direct: 4 devices byte-equal to 1 device; place wall "
        f"s: 1 device {sp1['direct.place']:.3f}, 4 devices "
        f"{sp4['direct.place']:.3f} (compile included)")
    place_fixture(tmp, 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU mesh phase (e)")
    args = ap.parse_args(argv)
    try:
        device = phase_device(4 if args.four_gpus else 1)
    except Exception:  # noqa: BLE001 — report and fail, print no result
        traceback.print_exc()
        log("[a] device: FAILED")
        return 1
    log("[a] device: ok")

    sys.path.insert(0, REPO)
    from usher_jax.native import HAVE_NATIVE
    from usher_jax.utils.instrument import enable_compile_cache
    log(f"native host extension: {'built' if HAVE_NATIVE else 'absent'}; "
        f"compile cache: {os.environ.get('JAX_COMPILATION_CACHE_DIR') or enable_compile_cache()}")
    phases = ([("e", "four-gpu mesh", phase_four)] if args.four_gpus else
              [("b", "reference fixture", phase_fixture),
               ("c", "pandemic serving", phase_serving),
               ("d", "kernels vs references", phase_kernels)])
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for key, name, fn in phases:
            t0 = time.time()
            try:
                fn(tmp)
                log(f"[{key}] {name}: ok ({time.time()-t0:.1f} s)")
            except Exception:  # noqa: BLE001 — every phase is reported
                traceback.print_exc()
                log(f"[{key}] {name}: FAILED ({time.time()-t0:.1f} s)")
                failed.append(key)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Worker for the REAL multi-process jax.distributed test.

Each process runs this file with USHER_JAX_COORDINATOR / NUM_PROCESSES /
PROCESS_ID set (the production activation path of
parallel/distributed.maybe_initialize).  All processes execute the same
replicated-host program — the execution model every driver here assumes,
mirroring the reference's follower tree replicas — over a GLOBAL device
mesh spanning both processes:

  placement  batch-axis shard_map over the global mesh (BigMAT path)
  FS         position-axis sharding inside optimize_tree
  SPR        source-batch sharding inside optimize_tree

Process 0 writes results to the given output file; the parent test
compares them byte-for-byte against a single-process run.

Run single-process (no env) to produce the golden.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)


def build_tree(seed=3):
    from usher_jax.core.tree import Mutation, Tree
    rng = np.random.default_rng(seed)
    bases = [1, 2, 4, 8]
    T = Tree()
    T.create_node("root")
    positions = list(range(100, 180))
    ref = {p: bases[int(rng.integers(4))] for p in positions}
    nodes = ["root"]
    for i in range(80):
        parent = nodes[int(rng.integers(len(nodes)))]
        nid = f"L{i}"
        node = T.create_node(nid, parent)
        p = positions[int(rng.integers(len(positions)))]
        par = ref[p]
        mut = bases[(bases.index(par) + 1 + int(rng.integers(3))) % 4]
        node.add_mutation(Mutation("c", p, ref[p], par, mut))
        nodes.append(nid)
    return T, ref


def sample_batch(ref, n, seed=11):
    from usher_jax.core.tree import Mutation
    rng = np.random.default_rng(seed)
    bases = [1, 2, 4, 8]
    out = []
    for _ in range(n):
        muts = []
        for p in sorted(rng.choice(sorted(ref), size=4,
                                   replace=False).tolist()):
            m = Mutation("c", int(p), ref[p], ref[p])
            m.mut_nuc = bases[int(rng.integers(4))]
            if m.mut_nuc == ref[p]:
                m.mut_nuc = bases[(bases.index(m.mut_nuc) + 1) % 4]
            muts.append(m)
        out.append(muts)
    return out


def main():
    from usher_jax.parallel.distributed import (global_batch_mesh,
                                                is_leader,
                                                maybe_initialize)
    distributed = bool(os.environ.get("USHER_JAX_COORDINATOR"))
    if distributed:
        assert maybe_initialize()
    out_path = sys.argv[1]
    results = {"process_count": jax.process_count() if distributed else 1,
               "device_count": jax.device_count()}

    # --- placement over the global mesh (BigMAT batch shard_map) ----------
    from usher_jax.core.bigmat import BigMAT
    from usher_jax.core.flat import collect_positions
    T, ref = build_tree()
    positions, refarr, _ = collect_positions(T)
    big = BigMAT.from_tree(T, positions, refarr)
    big.mesh = global_batch_mesh()
    posset = set(positions.tolist())
    batch = [[m for m in s if m.position in posset]
             for s in sample_batch(ref, 16)]
    bs, slot, nb = big.place_batch(batch)
    results["placement"] = {
        "best_score": np.asarray(bs).tolist(),
        "best_slot": np.asarray(slot).tolist(),
        "num_best": np.asarray(nb).tolist(),
    }

    # --- the serving CLI end-to-end over the global mesh -------------------
    # (usher --pb-direct --distributed: collective scoring on every
    # process, leader-only output files)
    import tempfile
    from usher_jax.cli.usher_cli import main as usher_main
    from usher_jax.io.pbio import save_mat_pb
    td = tempfile.mkdtemp(prefix="dw_")
    Ts, refs = build_tree(seed=5)
    pb_path = os.path.join(td, "t.pb")
    save_mat_pb(Ts, pb_path)
    tree_pos = sorted({m.position for n in Ts.depth_first_expansion()
                       for m in n.mutations})
    smp = sample_batch({p: refs[p] for p in tree_pos}, 6, seed=21)
    bases = {1: "A", 2: "C", 4: "G", 8: "T"}
    by_pos = {}
    for j, muts in enumerate(smp):
        for m in muts:
            by_pos.setdefault(m.position, {})[j] = m.mut_nuc
    vcf_path = os.path.join(td, "s.vcf")
    with open(vcf_path, "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"S{j}" for j in range(len(smp))) + "\n")
        for p in sorted(by_pos):
            r = refs[p]
            alts = sorted({v for v in by_pos[p].values() if v != r})
            if not alts:
                continue
            ai = {v: i + 1 for i, v in enumerate(alts)}
            row = [str(ai.get(by_pos[p].get(j), 0))
                   if j in by_pos[p] else "0" for j in range(len(smp))]
            f.write(f"c\t{p}\t.\t{bases[r]}\t"
                    + ",".join(bases[a] for a in alts)
                    + "\t.\t.\t.\tGT\t" + "\t".join(row) + "\n")
    serve_dir = os.path.join(td, "o")
    rc = usher_main(["-i", pb_path, "-v", vcf_path, "-d", serve_dir,
                     "--pb-direct", "--mesh-devices",
                     str(jax.device_count())]
                    + (["--distributed"] if distributed else []))
    assert rc == 0
    if is_leader():
        results["serve_stats"] = open(
            os.path.join(serve_dir, "placement_stats.tsv")).read()
        results["serve_tree"] = open(
            os.path.join(serve_dir, "final-tree.nh")).read()

    # --- usher-sampled on the 4k-leaf smoke fixture ------------------------
    # (interleaved optimization triggered mid-placement, batch scoring +
    # FS/SPR all sharded over the GLOBAL 2-process mesh — the reference's
    # interleaved leader protocol, src/usher-sampled/driver/main.cpp:58-188)
    import time as _time
    here = os.path.dirname(os.path.abspath(__file__))
    fdir = ("/root/reference/test"
            if os.path.isdir("/root/reference/test")
            else os.path.join(here, "fixtures"))
    from usher_jax.cli.usher_sampled_cli import main as sampled_main
    from usher_jax.io.newick import parse_newick
    from usher_jax.io.vcf import read_vcf
    from usher_jax.ops.sankoff import assign_states_from_vcf
    T4 = parse_newick(os.path.join(fdir, "global_phylo.nh"))
    _, vcf4 = read_vcf(T4, os.path.join(fdir, "global_samples.vcf"),
                       create_new_mat=True)
    assign_states_from_vcf(T4, vcf4)
    pb4 = os.path.join(td, "smoke.pb")
    save_mat_pb(T4, pb4)
    # widen the workload past one batch round: clone the 5 fixture
    # samples' genotype columns under fresh names
    lines = open(os.path.join(fdir,
                              "new_samples.vcf")).read().splitlines()
    hi = next(i for i, l in enumerate(lines) if l.startswith("#CHROM"))
    hdr = lines[hi].split("\t")
    fixed, names = hdr[:9], hdr[9:]
    reps = 16
    new_names = [f"{n}__r{k}" for k in range(reps) for n in names]
    out_lines = lines[:hi] + ["\t".join(fixed + new_names)]
    for l in lines[hi + 1:]:
        f = l.split("\t")
        out_lines.append("\t".join(f[:9] + f[9:] * reps))
    vcf4_path = os.path.join(td, "smoke_new.vcf")
    with open(vcf4_path, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    sampled_dir = os.path.join(td, "so")
    t0 = _time.time()
    rc = sampled_main(["-i", pb4, "-v", vcf4_path, "-d", sampled_dir,
                       "--parsimony_threshold", "0",
                       "--optimization_radius", "2",
                       "--batch_size_per_process", "1",
                       "--mesh-devices", str(jax.device_count())]
                      + (["--distributed"] if distributed else []))
    sampled_wall = _time.time() - t0
    assert rc == 0
    if is_leader():
        results["sampled_stats"] = open(
            os.path.join(sampled_dir, "placement_stats.tsv")).read()
        results["sampled_tree"] = open(
            os.path.join(sampled_dir, "final-tree.nh")).read()
        results["sampled_wall_s"] = round(sampled_wall, 3)

    # --- FS + SPR optimization sharded over the global mesh ----------------
    from usher_jax.io.newick import write_newick
    from usher_jax.optimize import OptimizeOptions, optimize_tree
    for backend in ("dense", "big"):
        T_opt, _ = build_tree()
        sc = optimize_tree(T_opt, OptimizeOptions(
            radius=4, max_iterations=2, reduce_back_mutations=False,
            mesh_devices=jax.device_count(), spr_backend=backend))
        results[f"optimize_{backend}"] = {
            "score": int(sc),
            "newick": write_newick(T_opt, print_internal=True,
                                   print_branch_len=True),
        }

    if is_leader():
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
    print(f"worker done (process "
          f"{jax.process_index() if distributed else 0})", flush=True)


if __name__ == "__main__":
    main()

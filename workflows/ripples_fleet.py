#!/usr/bin/env python
"""ripples fleet driver: partitioned parallel recombination scanning.

The reference partitions the candidate-node index space across a fleet of
GCP instances (scripts/recombination/run.py:29-40: ripplesInit counts the
long branches, get_partitions splits [0, count) into per-instance -S/-E
ranges, each instance runs `ripples -S start -E end`), then concatenates
the per-instance recombination/descendants TSVs.

This native driver does the same partitioning over local worker processes
(or emits the per-shard commands for an external scheduler with --dry-run):
the scale-out axis is candidate nodes, exactly as the reference's.

On a GPU host each shard is pinned to one card with CUDA_VISIBLE_DEVICES
and each card runs its shards one after another: a JAX process reserves
most of a card's memory when it first uses it, so a second process on the
same card would fail.  CPU workers (JAX_PLATFORMS=cpu) all run at once.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def get_partitions(long_branches: int, instances: int) -> list[tuple[int, int]]:
    """Reference partitioning, including its k+per+1 stride
    (scripts/recombination/run.py:29-40)."""
    partitions = []
    per_instance = long_branches // instances
    k = 0
    for i in range(1, instances + 1):
        if i == instances:
            partitions.append((k, long_branches))
            break
        partitions.append((k, k + per_instance))
        k += per_instance + 1
    return partitions


def gpu_ids(env) -> list[str]:
    """The GPUs shard workers may use, as CUDA_VISIBLE_DEVICES ids; empty
    when the workers run on the CPU."""
    if env.get("JAX_PLATFORMS", "").startswith("cpu"):
        return []
    vis = env.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [d.strip() for d in vis.split(",") if d.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    n = sum(line.startswith("GPU ") for line in out.stdout.splitlines())
    return [str(i) for i in range(n)]


def _run_in_order(cmds, env) -> int:
    rc = 0
    for cmd in cmds:
        rc |= subprocess.run(cmd, env=env).returncode
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ripples-fleet",
        description="Partition a ripples scan over worker processes "
                    "(scripts/recombination/run.py equivalent).")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--instances", "-n", type=int, default=2,
                   help="number of worker shards")
    p.add_argument("--branch-length", "-l", type=int, default=3)
    p.add_argument("--num-descendants", "-N", type=int, default=10)
    p.add_argument("--parsimony-improvement", "-P", type=int, default=3)
    p.add_argument("--samples-filename", "-s", default="")
    p.add_argument("--outdir", "-d", default="ripples_out")
    p.add_argument("--dry-run", action="store_true",
                   help="print the per-shard commands instead of running")
    args = p.parse_args(argv)

    # ripplesInit: count long branches for partitioning
    # (src/ripples/init/main.cpp:13)
    from usher_jax.io.pbio import load_mat_pb
    from usher_jax.ripples.init import count_long_branches
    T = load_mat_pb(args.input_mat)
    T.uncondense_leaves()
    n_long = count_long_branches(T, args.branch_length, args.num_descendants)
    print(f"{n_long} long branches", file=sys.stderr)
    if n_long == 0:
        print("Nothing to scan.", file=sys.stderr)
        return 0

    instances = max(1, min(args.instances, n_long))
    parts = get_partitions(n_long, instances)
    os.makedirs(args.outdir, exist_ok=True)

    cmds = []
    shard_dirs = []
    for i, (start, end) in enumerate(parts):
        shard_dir = os.path.join(args.outdir, f"shard_{i}")
        shard_dirs.append(shard_dir)
        cmd = [sys.executable, "-m", "usher_jax.cli.ripples_cli",
               "-i", args.input_mat, "-d", shard_dir,
               "-l", str(args.branch_length),
               "-n", str(args.num_descendants),
               "-p", str(args.parsimony_improvement),
               "-S", str(start), "-E", str(end)]
        if args.samples_filename:
            cmd += ["-s", args.samples_filename]
        cmds.append(cmd)

    env = dict(os.environ)
    env.setdefault("PYTHONPATH", REPO)
    gpus = gpu_ids(env)
    # one queue of shards per card (round robin), or one per shard on CPU
    queues = ([(None, [c]) for c in cmds] if not gpus else
              [(g, cmds[i::len(gpus)]) for i, g in enumerate(gpus)
               if cmds[i::len(gpus)]])
    if args.dry_run:
        for g, q in queues:
            for cmd in q:
                pin = f"CUDA_VISIBLE_DEVICES={g} " if g is not None else ""
                print(pin + " ".join(cmd))
        return 0

    with ThreadPoolExecutor(len(queues)) as pool:
        futs = [pool.submit(_run_in_order, q,
                            env if g is None
                            else {**env, "CUDA_VISIBLE_DEVICES": g})
                for g, q in queues]
        rc = 0
        for f in futs:
            rc |= f.result()
    if rc:
        print("ERROR: a shard failed", file=sys.stderr)
        return rc

    # concatenate shard outputs (run.py's gsutil compose equivalent)
    for name in ("recombination.tsv", "descendants.tsv"):
        out_path = os.path.join(args.outdir, name)
        with open(out_path, "w") as out:
            wrote_header = False
            for sd in shard_dirs:
                path = os.path.join(sd, name)
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    lines = f.readlines()
                if not lines:
                    continue
                if wrote_header:
                    lines = lines[1:]
                out.writelines(lines)
                wrote_header = True
        print(f"Merged {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

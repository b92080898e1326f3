"""usher-jax CLI: place samples from a VCF onto a tree by maximum parsimony.

Flag surface mirrors the reference `usher` binary (src/usher.cpp:47-86).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..core.tree import Tree
from ..io.newick import parse_newick
from ..io.pbio import load_mat_pb
from ..io.vcf import read_vcf
from ..placement.driver import UsherOptions, run_usher


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="usher-jax",
        description="UShER on JAX: place samples onto a mutation-annotated "
                    "tree by maximum parsimony.")
    p.add_argument("--vcf", "-v", required=True,
                   help="Input VCF file (uncompressed or gzip-compressed)")
    p.add_argument("--tree", "-t", default="", help="Input tree file (newick)")
    p.add_argument("--outdir", "-d", default=".",
                   help="Output directory to dump output and log files")
    p.add_argument("--load-mutation-annotated-tree", "-i", default="",
                   dest="din", help="Load mutation-annotated tree object")
    p.add_argument("--save-mutation-annotated-tree", "-o", default="",
                   dest="dout", help="Save output mutation-annotated tree object")
    p.add_argument("--sort-before-placement-1", "-s", action="store_true")
    p.add_argument("--sort-before-placement-2", "-S", action="store_true")
    p.add_argument("--sort-before-placement-3", "-A", action="store_true")
    p.add_argument("--reverse-sort", "-r", action="store_true")
    p.add_argument("--collapse-tree", "-c", action="store_true")
    p.add_argument("--collapse-output-tree", "-C", action="store_true")
    p.add_argument("--max-uncertainty-per-sample", "-e", type=int,
                   default=1_000_000)
    p.add_argument("--max-parsimony-per-sample", "-E", type=int,
                   default=1_000_000)
    p.add_argument("--write-uncondensed-final-tree", "-u", action="store_true")
    p.add_argument("--write-subtrees-size", "-k", type=int, default=0)
    p.add_argument("--write-single-subtree", "-K", type=int, default=0)
    p.add_argument("--write-parsimony-scores-per-node", "-p", action="store_true")
    p.add_argument("--multiple-placements", "-M", type=int, default=1)
    p.add_argument("--retain-input-branch-lengths", "-l", action="store_true")
    p.add_argument("--no-add", "-n", action="store_true")
    p.add_argument("--detailed-clades", "-D", action="store_true")
    p.add_argument("--threads", "-T", type=int, default=0,
                   help="Accepted for CLI parity; device parallelism is "
                        "managed by XLA")
    p.add_argument("--batch-size", type=int, default=64,
                   help="Samples scored per device call; results are exactly "
                        "the sequential reference semantics at any value")
    p.add_argument("--mesh-devices", type=int, default=-1,
                   help="Shard scoring over N devices (-1 auto, 0 off)")
    p.add_argument("--distributed", action="store_true",
                   help="Initialize jax.distributed for multi-host (DCN) meshes; "
                        "coordinator via USHER_JAX_COORDINATOR/NUM_PROCESSES/"
                        "PROCESS_ID env vars or auto-detection (parallel/distributed.py)")
    p.add_argument("--pb-direct", action="store_true",
                   help="No-Tree serving path: load the MAT as flat arrays "
                        "(io/pb_arrays.py, native scanners) and place "
                        "entirely over BigMAT — for pandemic-scale MATs "
                        "where host Node objects cost minutes/GBs. "
                        "Supports the full usher surface (-i/-v/-d/-n/-o/"
                        "-u/-e/-E, sorts -s/-S/-A/-r, -p, -c/-C, -D, "
                        "-k/-K, --batch-size) except -M>1 (Tree drivers)")
    p.add_argument("--bigmat", action="store_true",
                   help="Use the CSR BigMAT engine (O(N+M) memory) for "
                        "trees too large for the dense path-state matrix")
    p.add_argument("--version", action="version",
                   version="usher-jax (v0.1.0)")
    return p


def main(argv=None) -> int:
    from ..utils.instrument import (enable_compile_cache,
                                    maybe_begin_session_from_env)
    enable_compile_cache()
    maybe_begin_session_from_env()
    args = build_parser().parse_args(argv)
    if getattr(args, 'distributed', False) or os.environ.get('USHER_JAX_DISTRIBUTED'):
        from ..parallel.distributed import (maybe_initialize,
                                            shadow_outputs)
        maybe_initialize()
        # followers run every collective but only rank 0 writes the real
        # output files (the reference's leader discipline)
        shadow_outputs(args, "outdir", "dout")

    t0 = time.time()
    if getattr(args, "pb_direct", False):
        if not args.din:
            print("ERROR: --pb-direct requires -i MAT.pb", file=sys.stderr)
            return 1
        if args.multiple_placements > 1:
            print("ERROR: --pb-direct does not support -M>1 "
                  "(use the Tree drivers)", file=sys.stderr)
            return 1
        # the Tree driver's flag-combination validation (run_usher)
        if args.write_subtrees_size == 1:
            print("ERROR: print-subtrees-size should be larger than 1",
                  file=sys.stderr)
            return 1
        if args.no_add and (args.write_subtrees_size > 0
                            or args.write_single_subtree):
            print("ERROR: Sorry, cannot output subtrees when -n/--no-add "
                  "is specified.", file=sys.stderr)
            return 1
        if (args.sort_before_placement_1 + args.sort_before_placement_2
                + args.sort_before_placement_3) > 1:
            print("ERROR: Can't use two or more of sort-before-placement-1, "
                  "sort-before-placement-2 and sort-before-placement-3 "
                  "simultaneously.", file=sys.stderr)
            return 1
        if args.reverse_sort and not (args.sort_before_placement_1
                                      or args.sort_before_placement_2
                                      or args.sort_before_placement_3):
            print("ERROR: Can't use reverse-sort without sorting options",
                  file=sys.stderr)
            return 1
        from ..placement.direct import DirectOptions, run_usher_direct
        from ..parallel.mesh import auto_mesh_devices
        mesh = None
        want = auto_mesh_devices(args.mesh_devices)
        if want > 1:
            import jax
            import numpy as _np
            from jax.sharding import Mesh
            mesh = Mesh(_np.array(jax.devices()[:want]), ("batch",))
            print(f"Sharding direct placement over {want} devices.",
                  file=sys.stderr)
        return run_usher_direct(args.din, args.vcf, DirectOptions(
            outdir=args.outdir, batch_size=args.batch_size,
            max_uncertainty=args.max_uncertainty_per_sample,
            max_parsimony=args.max_parsimony_per_sample,
            no_add=args.no_add,
            uncondensed=args.write_uncondensed_final_tree,
            sort_before_placement_1=args.sort_before_placement_1,
            sort_before_placement_2=args.sort_before_placement_2,
            sort_before_placement_3=args.sort_before_placement_3,
            reverse_sort=args.reverse_sort,
            print_parsimony_scores=args.write_parsimony_scores_per_node,
            detailed_clades=args.detailed_clades,
            collapse_tree=args.collapse_tree,
            collapse_output_tree=args.collapse_output_tree,
            print_subtrees_size=args.write_subtrees_size,
            print_subtrees_single=args.write_single_subtree,
            dout_filename=args.dout or ""), mesh=mesh)
    if args.tree:
        print("Loading input tree.", file=sys.stderr)
        T = parse_newick(args.tree)
        if T.root is None:
            print("ERROR: Empty tree.", file=sys.stderr)
            return 1
        missing_samples, vcf = read_vcf(T, args.vcf, create_new_mat=True)
        print("Computing parsimonious assignments for input variants.",
              file=sys.stderr)
        from ..ops.sankoff import assign_states_from_vcf
        assign_states_from_vcf(T, vcf)
        print(f"Completed in {int((time.time()-t0)*1000)} msec \n", file=sys.stderr)
    elif args.din:
        print(f"Loading existing mutation-annotated tree object from file "
              f"{args.din}", file=sys.stderr)
        T = load_mat_pb(args.din)
        if T.root is None:
            print("ERROR: Empty tree.", file=sys.stderr)
            return 1
        missing_samples, vcf = read_vcf(T, args.vcf, create_new_mat=False)
    else:
        print("Error! No input tree or assignment file provided!", file=sys.stderr)
        return 1

    opts = UsherOptions(
        dout_filename=args.dout,
        outdir=args.outdir,
        batch_size=args.batch_size,
        mesh_devices=args.mesh_devices,
        use_bigmat=args.bigmat,
        max_trees=args.multiple_placements,
        max_uncertainty=args.max_uncertainty_per_sample,
        max_parsimony=args.max_parsimony_per_sample,
        sort_before_placement_1=args.sort_before_placement_1,
        sort_before_placement_2=args.sort_before_placement_2,
        sort_before_placement_3=args.sort_before_placement_3,
        reverse_sort=args.reverse_sort,
        collapse_tree=args.collapse_tree,
        collapse_output_tree=args.collapse_output_tree,
        print_uncondensed_tree=args.write_uncondensed_final_tree,
        print_parsimony_scores=args.write_parsimony_scores_per_node,
        retain_original_branch_len=args.retain_input_branch_lengths,
        no_add=args.no_add,
        detailed_clades=args.detailed_clades,
        print_subtrees_size=args.write_subtrees_size,
        print_subtrees_single=args.write_single_subtree,
    )
    return run_usher(T, missing_samples, opts, vcf)


if __name__ == "__main__":
    sys.exit(main())

"""ripplesInit-jax CLI (reference src/ripples/init/main.cpp:13): print the
number of long branches for job partitioning and write the ripples ->
Chronumental node-id map."""

from __future__ import annotations

import argparse
import sys

from ..io.pbio import load_mat_pb
from ..ripples.init import count_long_branches, write_chronumental_id_map


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ripplesInit-jax")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--branch-length", "-l", type=int, default=3,
                   help="Minimum branch length to consider for "
                        "recombination events")
    p.add_argument("--num-descendants", "-n", type=int, default=2,
                   help="Minimum number of leaves a node should have")
    args = p.parse_args(argv)

    T = load_mat_pb(args.input_mat)
    T.uncondense_leaves()
    write_chronumental_id_map(T)
    print(count_long_branches(T, args.branch_length, args.num_descendants))
    return 0


if __name__ == "__main__":
    sys.exit(main())

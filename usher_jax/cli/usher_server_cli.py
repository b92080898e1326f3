"""usher_server: daemon that polls an argument directory for placement jobs.

Mirrors the reference ``usher_server`` binary (src/usher_server.cpp:28-486):
it watches a directory for argument files, each containing one or more lines
of ``usher`` command-line arguments terminated by a termination character
(default '^').  Mutation-annotated trees listed in an optional MAT-list file
are pre-loaded and kept resident; a run consumes its tree (placement mutates
it), so consumed trees are re-loaded from disk at the top of the loop — the
same availability bookkeeping as the reference (usher_server.cpp:117-139,
316-359).  After a file's argument lines are processed the file is deleted
(usher_server.cpp:483).

Special argument lines (usher_server.cpp:259-313): ``--version`` prints the
version, ``--reload`` re-loads every MAT in the MAT-list file, ``--help``
prints usage; each continues to the next line rather than running a job.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..core.tree import Tree
from ..io.pbio import load_mat_pb
from ..io.vcf import read_vcf
from ..placement.driver import UsherOptions, run_usher


def _err(*a):
    print(*a, file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="usher-jax-server",
        description="usher_server: poll an argument directory and "
                    "run placement jobs against pre-loaded MATs.")
    p.add_argument("--arguments", "-a", required=True,
                   help="Input argument directory that will contain argument "
                        "files with arguments for usher [REQUIRED]")
    p.add_argument("--list-mutation-annotated-trees", "-i", default="",
                   dest="mat_list",
                   help="File containing list of mutation-annotated tree "
                        "objects")
    p.add_argument("--sleep-length", "-s", type=int, default=100,
                   help="Time in milliseconds between checks for input in the "
                        "argument directory")
    p.add_argument("--termination-char", "-c", type=int, default=94,
                   help="Character that marks an argument file as ready to be "
                        "read (default '^')")
    p.add_argument("--threads", "-T", type=int, default=0,
                   help="Accepted for CLI parity; device parallelism is "
                        "managed by XLA")
    p.add_argument("--once", action="store_true",
                   help="Process the argument files currently present, then "
                        "exit (for scripting/tests; the reference daemon "
                        "loops forever)")
    return p


def build_request_parser() -> argparse.ArgumentParser:
    """Per-request argument parser (usher_server.cpp:225-261).

    The server's request surface is the classic usher flag set minus ``-t``
    newick input (requests must load a MAT) and minus multi-tree ``-M``
    (max_trees is pinned to 1, usher_server.cpp:207).
    """
    p = argparse.ArgumentParser(prog="usher", add_help=False)
    p.add_argument("--vcf", "-v", default="")
    p.add_argument("--load-mutation-annotated-tree", "-i", default="",
                   dest="din")
    p.add_argument("--outdir", "-d", default=".")
    p.add_argument("--save-mutation-annotated-tree", "-o", default="",
                   dest="dout")
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
    p.add_argument("--write-parsimony-scores-per-node", "-p",
                   action="store_true")
    p.add_argument("--retain-input-branch-lengths", "-l", action="store_true")
    p.add_argument("--no-add", "-n", action="store_true")
    p.add_argument("--detailed-clades", "-D", action="store_true")
    p.add_argument("--version", action="store_true")
    p.add_argument("--reload", action="store_true")
    p.add_argument("--help", "-h", action="store_true", dest="want_help")
    return p


class MatStore:
    """Pre-loaded MAT collection with consumed-tree reload bookkeeping.

    ``trees[path]`` is the loaded Tree or None when it has been consumed by a
    run and must be re-loaded from disk (usher_server.cpp:88-139).  One extra
    slot holds the most recent MAT requested outside the list
    (usher_server.cpp:66-70, 329-359).
    """

    def __init__(self, mat_list_filename: str = ""):
        self.mat_list_filename = mat_list_filename
        self.trees: dict[str, Tree | None] = {}
        self.loaded_name = ""
        self.loaded_tree: Tree | None = None

    def _load(self, path: str) -> Tree:
        t0 = time.time()
        _err(f"Loading existing mutation-annotated tree object from file "
             f"{path}")
        T = load_mat_pb(path)
        _err(f"Completed in {int((time.time() - t0) * 1000)} msec \n")
        return T

    def load_list(self) -> bool:
        if not self.mat_list_filename:
            return True
        if not os.path.exists(self.mat_list_filename):
            print("MAT list file not found")
            return False
        self.trees = {}
        with open(self.mat_list_filename) as f:
            for line in f:
                path = line.rstrip("\n")
                if path:
                    self.trees[path] = self._load(path)
        return True

    def refresh_consumed(self) -> None:
        """Re-load any trees consumed by a previous run."""
        if self.loaded_name and self.loaded_tree is None:
            self.loaded_tree = self._load(self.loaded_name)
        for path, T in self.trees.items():
            if T is None:
                self.trees[path] = self._load(path)

    def acquire(self, path: str) -> Tree:
        """Hand out the tree for `path`, marking it consumed."""
        if path in self.trees:
            if self.trees[path] is None:
                self.trees[path] = self._load(path)
            T = self.trees[path]
            self.trees[path] = None
            return T
        if path != self.loaded_name:
            self.loaded_name = path
            self.loaded_tree = None
        if self.loaded_tree is None:
            self.loaded_tree = self._load(path)
        T = self.loaded_tree
        self.loaded_tree = None
        return T


def run_request(words: list[str], store: MatStore) -> int:
    """Parse and run one argument line.  Returns nonzero to stop reading the
    current file (usher_server.cpp:306-313, 477-480)."""
    parser = build_request_parser()
    try:
        args = parser.parse_args(words)
    except SystemExit:
        _err("Failed to parse arguments")
        return 1
    if args.version:
        print("UShER (v0.1.0 usher-jax)")
        return 0
    if args.reload:
        if store.mat_list_filename and not store.load_list():
            return 1
        return 0
    if args.want_help or not args.vcf or not args.din:
        _err("usher_server request requires -v VCF and -i MAT")
        return 0 if args.want_help else 1

    T = store.acquire(args.din)
    if T.root is None:
        _err("ERROR: Empty tree.")
        return 1
    _err("Loading VCF file")
    t0 = time.time()
    missing_samples, vcf = read_vcf(T, args.vcf, create_new_mat=False)
    _err(f"Completed in {int((time.time() - t0) * 1000)} msec \n")

    opts = UsherOptions(
        dout_filename=args.dout,
        outdir=args.outdir,
        max_trees=1,
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


def _file_ready(path: str, term_char: int) -> bool:
    """Ready = last or second-to-last byte is the termination character
    (usher_server.cpp:166-175)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return False
            f.seek(max(0, size - 2))
            tail = f.read()
    except OSError:
        return False
    return bytes([term_char]) in tail[-2:]


def process_arg_file(path: str, term_char: int, store: MatStore) -> None:
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        argument = line.replace(chr(term_char), "")
        if not argument.strip():
            continue
        _err(f"Argument: {argument} \n")
        if run_request(argument.split(), store) != 0:
            break
    os.remove(path)


def serve(arg_dir: str, store: MatStore, sleep_ms: int, term_char: int,
          once: bool = False) -> int:
    while True:
        store.refresh_consumed()
        entries = sorted(os.listdir(arg_dir))
        if not entries:
            if once:
                return 0
            _err("Waiting for more arguments\n")
            while not os.listdir(arg_dir):
                time.sleep(sleep_ms / 1000.0)
            entries = sorted(os.listdir(arg_dir))
        progressed = False
        for name in entries:
            path = os.path.join(arg_dir, name)
            if not os.path.isfile(path):
                continue
            if not _file_ready(path, term_char):
                continue
            try:
                process_arg_file(path, term_char, store)
            except Exception as e:
                # a bad job (e.g. nonexistent VCF path in an argument file)
                # must not crash the daemon; the reference daemon likewise
                # keeps serving (usher_server.cpp:40-49).  Remove the file so
                # a restart does not crash-loop on it.
                _err(f"ERROR processing {path}: {e}\n")
                try:
                    os.remove(path)
                except OSError:
                    pass
            progressed = True
        if once and not progressed:
            return 0
        if not once and not progressed:
            time.sleep(sleep_ms / 1000.0)


def main(argv=None) -> int:
    from ..utils.instrument import (enable_compile_cache,
                                    maybe_begin_session_from_env)
    enable_compile_cache()
    maybe_begin_session_from_env()
    args = build_parser().parse_args(argv)

    if not os.path.isdir(args.arguments):
        _err(f"ERROR: Argument directory provided is not a directory: "
             f"{args.arguments}!")
        return 1

    store = MatStore(args.mat_list)
    if not store.load_list():
        return 1
    return serve(args.arguments, store, args.sleep_length,
                 args.termination_char, once=args.once)


if __name__ == "__main__":
    sys.exit(main())

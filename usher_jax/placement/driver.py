"""Sample placement driver: the usher_common equivalent.

Orchestrates the end-to-end placement flow (reference src/usher_common.cpp):
optional collapse/condense of the input tree, optional sample sorting,
the per-sample placement loop (scored on device against ALL nodes at once),
tree surgery, and all output artifacts (final-tree.nh, placement_stats.tsv,
mutation-paths.txt, parsimony-scores.tsv, clades.txt, MAT .pb).

Deterministic semantics: the reference's racy shared-best parallel search is
replaced by an exact reduction -- the tie set is all VALID nodes achieving
the minimum score, the winner maximizes (subtree leaf count, BFS index)
(usher_mapper.cpp:458-497), which equals the reference's sequential-order
outcome.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np

from ..parallel.distributed import fetch as _fetch

from ..core.flat import FlatMAT, collect_positions
from ..core.tree import Mutation, MissingSample, Tree
from ..io.newick import write_newick
from ..io.pbio import save_mat_pb
from ..ops import placement as dev
from .mapper import score_placement


def _err(*a):
    print(*a, file=sys.stderr)


@dataclass
class UsherOptions:
    dout_filename: str = ""
    outdir: str = "."
    batch_size: int = 64
    # -1 = auto (shard over all devices when >1 GPU is attached),
    # 0 = single-device, N>1 = shard over the first N devices
    mesh_devices: int = -1
    max_trees: int = 1
    max_uncertainty: int = 1_000_000
    max_parsimony: int = 1_000_000
    use_bigmat: bool = False   # CSR BigMAT engine for trees too large for
                               # the dense [N, P] path-state matrix
    sort_before_placement_1: bool = False
    sort_before_placement_2: bool = False
    sort_before_placement_3: bool = False
    reverse_sort: bool = False
    collapse_tree: bool = False
    collapse_output_tree: bool = False
    print_uncondensed_tree: bool = False
    print_parsimony_scores: bool = False
    retain_original_branch_len: bool = False
    no_add: bool = False
    detailed_clades: bool = False
    print_subtrees_size: int = 0
    print_subtrees_single: int = 0


@dataclass
class SampleResult:
    """Exact placement result for one sample against a tree snapshot."""
    best_score: int
    num_best: int
    best_node: object
    best_has_unique: bool
    tied_nodes: list = field(default_factory=list)       # BFS order
    tied_has_unique: list = field(default_factory=list)
    scores_bfs: np.ndarray | None = None                 # per BFS node (for -p)
    valid_bfs: np.ndarray | None = None


class PlacementEngine:
    """Holds the device-resident flat MAT and runs batched scoring.

    backend selects the scorer: "dense" = ops.placement.score_batch
    (O(B*N*P) work), "sparse" = the entry-column gather of
    ops.placement_sparse (O(N*P) + O(B*N*K)), "auto" = sparse when the
    batch's padded entry-slot count is below the position count, dense
    otherwise.  The two are bit-identical (see
    tests/test_placement_pallas.py); the host oracle cross-check in
    run_usher guards every applied placement either way.
    """

    def __init__(self, T: Tree, vcf=None, extra_mutations=None,
                 backend: str = "auto", mesh=None):
        """extra_mutations: iterable of Mutation whose positions must join
        the segregating-position set (diff-ingested samples can mutate
        positions the tree does not).

        mesh: optional jax Mesh with ("data", "model") axes — node axis
        sharded over "model", sample batches over "data" (the device-mesh
        replacement for the reference's MPI follower protocol,
        place_sample.cpp:591-662)."""
        self.backend = backend
        self.mesh = mesh
        self._mesh_score = None
        positions, ref, chrom = collect_positions(T, vcf)
        if extra_mutations:
            pos_ref = {int(p): int(r) for p, r in zip(positions, ref)}
            for m in extra_mutations:
                if m.position >= 0 and m.position not in pos_ref:
                    pos_ref[m.position] = m.ref_nuc
                    chrom = chrom or m.chrom
            import numpy as _np
            positions = _np.array(sorted(pos_ref), dtype=_np.int64)
            ref = _np.array([pos_ref[p] for p in positions.tolist()],
                            dtype=_np.uint8)
        self.flat = FlatMAT(T, positions, ref, chrom, mesh=mesh)

    def score_samples(self, samples_mutations, want_matrix=False,
                      exclude_slots=None, restrict_slots=None):
        """Score a batch of samples against the current tree.

        exclude_slots: optional per-sample node slot to invalidate (self-
        mapping exclusion for uncertainty re-placement, reference
        uncertainty.cpp:218).
        restrict_slots: optional per-sample iterable of ALLOWED node slots
        (None entries mean unrestricted) — the matUtils merge search bound
        (merge.cpp:254-258: only nodes within --max-depth levels of the
        consistent anchor are candidates).
        Returns a list of SampleResult (one per sample)."""
        flat = self.flat
        st_dev, parent_dev = flat.sync()
        meta = flat.order_arrays()
        score, num_common, node_num_mut = self._score_matrices(
            st_dev, parent_dev, samples_mutations, meta["active"])
        valid, has_unique = dev.placement_outputs(
            score, num_common, node_num_mut, meta["is_root_mask"],
            meta["is_leaf"], meta["active"])
        if exclude_slots is not None:
            valid = np.asarray(valid).copy()
            for b, slot in enumerate(exclude_slots):
                if slot is not None and slot >= 0:
                    valid[b, slot] = False
        if restrict_slots is not None:
            valid = np.asarray(valid).copy()
            for b, allow in enumerate(restrict_slots):
                if allow is None:
                    continue
                mask = np.zeros(valid.shape[1], dtype=bool)
                mask[np.asarray(list(allow), dtype=np.int64)] = True
                valid[b] &= mask

        bfs = meta["bfs"]
        bfs_rank = meta["bfs_rank"]
        num_leaves = meta["num_leaves"]
        results = []
        for b in range(len(samples_mutations)):
            s_row, v_row, hu_row = score[b], valid[b], has_unique[b]
            vs = np.where(v_row, s_row, 1 << 30)
            best = int(vs.min())
            tied_slots = np.nonzero(v_row & (s_row == best))[0]
            if len(tied_slots) == 0:
                # only reachable under restrict_slots: every candidate in
                # the allowed set was invalid
                results.append(SampleResult(
                    best_score=best, num_best=0, best_node=None,
                    best_has_unique=False))
                continue
            # order tie set by BFS rank ascending
            tied_slots = tied_slots[np.argsort(bfs_rank[tied_slots], kind="stable")]
            # winner: max leaves then max BFS rank
            tl = num_leaves[tied_slots]
            cand = tied_slots[tl == tl.max()]
            best_slot = int(cand[np.argmax(bfs_rank[cand])])
            res = SampleResult(
                best_score=best,
                num_best=int(len(tied_slots)),
                best_node=flat._slot_node[best_slot],
                best_has_unique=bool(hu_row[best_slot]),
                tied_nodes=[flat._slot_node[s] for s in tied_slots],
                tied_has_unique=[bool(hu_row[s]) for s in tied_slots],
            )
            if want_matrix:
                slots = np.array([n.slot for n in bfs])
                res.scores_bfs = s_row[slots]
                res.valid_bfs = v_row[slots]
            results.append(res)
        return results

    def _resolve_backend(self, samples_mutations) -> str:
        if self.backend != "auto":
            return self.backend
        from ..ops import placement_sparse as pp
        kmax = max((len(m) for m in samples_mutations), default=0)
        if kmax > pp.MAX_ENTRY_SLOTS:
            return "dense"
        return "sparse" if pp.slot_count(kmax) < self.flat.P_pad else "dense"

    def _score_matrices(self, st_dev, parent_dev, samples_mutations, active):
        """Raw (score [B,N], num_common [B,N], node_num_mut [N]) numpy arrays
        from the selected kernel."""
        flat = self.flat
        if self.mesh is not None:
            return self._score_mesh(samples_mutations, active)
        if self._resolve_backend(samples_mutations) == "sparse":
            from ..ops import placement_sparse as pp
            pos, gval, kmiss = pp.sparsify(samples_mutations, flat.pos_index,
                                           flat.P_pad)
            score_t, nc_t, nnm = pp.score_sparse_T(
                st_dev, parent_dev, flat.root_slot, np.asarray(flat.ref),
                pos, gval, kmiss, pos.shape[1])
            return (np.asarray(score_t).T, np.asarray(nc_t).T,
                    np.asarray(nnm))
        g, E, miss = flat.encode_samples(samples_mutations)
        return tuple(np.asarray(x) for x in dev.score_batch(
            st_dev, parent_dev, flat.root_slot,
            np.asarray(flat.ref), active, g, E, miss))

    def _score_mesh(self, samples_mutations, active):
        """Sharded scoring over the (data, model) mesh: the sample batch is
        padded to the data-axis size, placed P("data", None); st/stp live
        sharded P("model", None) in the FlatMAT.  Identical math to the
        single-device path — the sparse scorer runs per-shard via
        shard_map when the backend resolves sparse (multi-device keeps the
        sparse-vs-dense advantage), the dense formula otherwise."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel import mesh as pmesh
        flat = self.flat
        st_dev, stp_dev = flat.sync_mesh()
        B = len(samples_mutations)
        dsize = self.mesh.shape["data"]
        Bp = -(-B // dsize) * dsize
        batch_sh = NamedSharding(self.mesh, P("data", None))
        ref_dev = jax.device_put(np.asarray(flat.ref),
                                 NamedSharding(self.mesh, P()))
        if self._resolve_backend(samples_mutations) == "sparse":
            from ..ops import placement_sparse as pp
            pos, gval, kmiss = pp.sparsify(samples_mutations,
                                           flat.pos_index, flat.P_pad)
            if Bp != B:
                pad = Bp - B
                K = pos.shape[1]
                pos = np.concatenate(
                    [pos, np.full((pad, K), flat.P_pad, np.int32)], 0)
                gval = np.concatenate(
                    [gval, np.zeros((pad, K), np.uint8)], 0)
                kmiss = np.concatenate(
                    [kmiss, np.zeros((pad, K), bool)], 0)
            fns = getattr(self, "_mesh_sparse_fns", None)
            if fns is None:
                fns = self._mesh_sparse_fns = {}
            fn = fns.get(pos.shape[1])
            if fn is None:
                fn = fns[pos.shape[1]] = pmesh.sharded_sparse_score_fn(
                    self.mesh, pos.shape[1])
            score_t, nc_t, nnm = fn(
                st_dev, stp_dev, ref_dev,
                jax.device_put(pos, batch_sh),
                jax.device_put(gval, batch_sh),
                jax.device_put(kmiss, batch_sh))
            score_t = _fetch(score_t)
            return (score_t.T[:B], _fetch(nc_t).T[:B],
                    _fetch(nnm))
        if self._mesh_score is None:
            self._mesh_score = pmesh.sharded_score_fn(self.mesh)
        g, E, miss = flat.encode_samples(samples_mutations)
        if Bp != B:
            pad = Bp - B
            g = np.concatenate([g, np.tile(flat.ref, (pad, 1))], 0)
            E = np.concatenate([E, np.zeros((pad, E.shape[1]), bool)], 0)
            miss = np.concatenate(
                [miss, np.zeros((pad, miss.shape[1]), bool)], 0)
        g = jax.device_put(g, batch_sh)
        E = jax.device_put(E, batch_sh)
        miss = jax.device_put(miss, batch_sh)
        active_dev = jax.device_put(active,
                                    NamedSharding(self.mesh, P("model")))
        score, nc, nnm = self._mesh_score(st_dev, stp_dev, ref_dev,
                                          active_dev, g, E, miss)
        return (_fetch(score)[:B], _fetch(nc)[:B], _fetch(nnm))

    # --- surgery ------------------------------------------------------------

    def apply_placement(self, sample_name: str, res: SampleResult,
                        excess: list[Mutation]) -> None:
        """Insert the sample at the winning node (reference
        usher_common.cpp:652-765)."""
        T = self.flat.tree
        best_node = res.best_node
        if best_node.is_leaf() or res.best_has_unique:
            # sibling: split the branch
            nid = T.new_internal_node_id()
            new_internal = T.create_node(nid, best_node.parent)
            sample_node = T.create_node(sample_name, new_internal)
            T.move_node(best_node.identifier, nid)

            curr_l1 = [m.copy() for m in best_node.mutations]
            best_node.clear_mutations()
            l1, l2, common = [], [], []
            for m1 in curr_l1:
                if not any((not m1.is_masked()) and m1.position == m2.position
                           and m1.mut_nuc == m2.mut_nuc for m2 in excess):
                    l1.append(m1.copy())
            for m1 in excess:
                matched = any((not m1.is_masked()) and m1.position == m2.position
                              and m1.mut_nuc == m2.mut_nuc for m2 in curr_l1)
                (common if matched else l2).append(m1.copy())
            for m in common:
                new_internal.add_mutation(m)
            for m in l1:
                best_node.add_mutation(m)
            for m in l2:
                sample_node.add_mutation(m)

            self.flat.add_node(new_internal)
            self.flat.add_node(sample_node)
            self.flat.reparent(best_node)
        else:
            # child
            sample_node = T.create_node(sample_name, best_node.identifier)
            curr_l1 = best_node.mutations
            for m1 in excess:
                if not any((not m1.is_masked()) and m1.position == m2.position
                           and m1.mut_nuc == m2.mut_nuc for m2 in curr_l1):
                    sample_node.add_mutation(m1.copy())
            self.flat.add_node(sample_node)


def run_usher(T: Tree, missing_samples: list[MissingSample], opts: UsherOptions,
              vcf=None) -> int:
    low_confidence_samples: list[str] = []

    if opts.print_subtrees_size == 1:
        _err("ERROR: print-subtrees-size should be larger than 1")
        return 1
    if (opts.sort_before_placement_1 + opts.sort_before_placement_2
            + opts.sort_before_placement_3) > 1:
        _err("ERROR: Can't use two or more of sort-before-placement-1, "
             "sort-before-placement-2 and sort-before-placement-3 simultaneously.")
        return 1
    if opts.reverse_sort and not (opts.sort_before_placement_1
                                  or opts.sort_before_placement_2
                                  or opts.sort_before_placement_3):
        _err("ERROR: Can't use reverse-sort without sorting options")
        return 1
    if opts.print_parsimony_scores and opts.max_trees > 1:
        _err("ERROR: cannot use --multiple-placements (-M) and "
             "--print_parsimony_scores (-p) options simulaneously.")
        return 1
    if opts.max_trees == 0:
        _err("ERROR: Number of trees specified by --multiple-placements (-M) "
             "should be >= 1")
        return 1
    if opts.max_trees > 1:
        return run_usher_multi(T, missing_samples, opts, vcf)
    if opts.no_add and (opts.print_subtrees_size > 0 or opts.print_subtrees_single):
        _err("ERROR: Sorry, cannot output subtrees when -n/--no-add is specified.")
        return 1

    os.makedirs(opts.outdir, exist_ok=True)
    outdir = os.path.realpath(opts.outdir)

    if opts.collapse_tree:
        _err("Collapsing input tree.")
        T.collapse_tree()
        _err("Condensing identical sequences.")
        T.condense_leaves()
        path = os.path.join(outdir, "condensed-tree.nh")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True,
                                 retain_original_branch_len=opts.retain_original_branch_len)
                    + "\n")

    _err(f"Found {len(missing_samples)} missing samples.\n")

    if opts.sort_before_placement_3:
        missing_samples.sort(key=lambda s: s.num_ambiguous)
        if opts.reverse_sort:
            missing_samples.reverse()

    mesh = None
    from ..parallel.mesh import auto_mesh_devices, make_mesh
    want = auto_mesh_devices(opts.mesh_devices)
    if want > 1:
        mesh = make_mesh(want)
        _err(f"Sharding placement over a {dict(mesh.shape)} device mesh.")
    if opts.use_bigmat:
        from .big_engine import BigPlacementEngine
        _err("Using the CSR BigMAT engine (pandemic-scale path).")
        engine = BigPlacementEngine(T, vcf, mesh=mesh)
    else:
        engine = PlacementEngine(T, vcf, mesh=mesh)
    flat = engine.flat

    if missing_samples:
        indexes = list(range(len(missing_samples)))

        if opts.print_parsimony_scores:
            path = os.path.join(outdir, "current-tree.nh")
            with open(path, "w") as f:
                f.write(write_newick(T, print_internal=True, print_branch_len=True)
                        + "\n")
        elif ((opts.sort_before_placement_1 or opts.sort_before_placement_2)
              and len(missing_samples) > 1):
            _err("Computing parsimony scores and number of parsimony-optimal "
                 "placements for new samples and using them to sort the samples.")
            for s in missing_samples:
                s.mutations.sort(key=lambda m: m.position)
            pres = engine.score_samples([s.mutations for s in missing_samples])
            best_scores = [r.best_score for r in pres]
            num_placements = [r.num_best for r in pres]
            if opts.sort_before_placement_1:
                indexes.sort(key=lambda i: (best_scores[i], num_placements[i]))
            else:
                indexes.sort(key=lambda i: (num_placements[i], best_scores[i]))
            if opts.reverse_sort:
                indexes.reverse()

        if not opts.print_parsimony_scores:
            _err("Adding missing samples to the tree.")

        stats_path = os.path.join(outdir, "placement_stats.tsv")
        stats_f = open(stats_path, "w")
        pars_f = None

        # Batched scoring with exact sequential semantics: a whole batch is
        # scored against a frozen tree snapshot in one device call; before
        # applying each proposal, cheap host checks prove it equals what a
        # sequential re-score would produce (or trigger an exact re-score).
        # Earlier applies in a batch only change (a) scores of the touched
        # node whose branch was split, (b) the two new nodes, (c) tie-break
        # metadata (leaf counts / BFS ranks) -- each is checked below.
        bsz = max(1, opts.batch_size)
        fresh_order = {"meta": None}  # lazily recomputed tie-break metadata

        def _fresh_rank_leaves():
            if fresh_order["meta"] is None:
                bfs = T.breadth_first_expansion()
                rank = {id(n): r for r, n in enumerate(bfs)}
                cnt: dict[int, int] = {}
                for n in reversed(bfs):
                    cnt[id(n)] = (1 if n.is_leaf()
                                  else sum(cnt[id(c)] for c in n.children))
                fresh_order["meta"] = (rank, cnt)
            return fresh_order["meta"]

        def _refresh_winner(res: SampleResult) -> None:
            """Re-resolve the tie-break (max leaves, then max BFS rank;
            usher_mapper.cpp:476-497) against the CURRENT tree when the
            snapshot's ordering metadata went stale."""
            rank, cnt = _fresh_rank_leaves()
            pairs = sorted(zip(res.tied_nodes, res.tied_has_unique),
                           key=lambda p: rank[id(p[0])])
            res.tied_nodes = [p[0] for p in pairs]
            res.tied_has_unique = [p[1] for p in pairs]
            best_i = max(range(len(pairs)),
                         key=lambda i: (cnt[id(pairs[i][0])],
                                        rank[id(pairs[i][0])]))
            res.best_node = pairs[best_i][0]
            res.best_has_unique = pairs[best_i][1]

        from ..utils.instrument import timeit
        flat_batches = [indexes[i:i + bsz] for i in range(0, len(indexes), bsz)]
        for batch_idx in flat_batches:
            batch = [missing_samples[i] for i in batch_idx]
            with timeit("placement:score_batch"):
                pres = engine.score_samples(
                    [s.mutations for s in batch],
                    want_matrix=opts.print_parsimony_scores)
            # nodes whose score could differ from the snapshot due to earlier
            # applies in this batch (split node + the nodes it created)
            check_nodes: list = []
            check_ids: set[str] = set()
            tree_dirty = False

            for s, res in zip(batch, pres):
                sample = s.name
                if T.get_node(sample) is not None:
                    _err(f"WARNING: Sample {sample} already in the tree! "
                         f"Ignoring.\n")
                    continue

                if opts.print_parsimony_scores and pars_f is None:
                    pars_path = os.path.join(outdir, "parsimony-scores.tsv")
                    _err(f"\nNow computing branch parsimony scores for adding the "
                         f"missing samples at each of the nodes in the existing tree "
                         f"without modifying the tree.\nThe branch parsimony scores "
                         f"will be written to file {pars_path}\n")
                    pars_f = open(pars_path, "w")
                    pars_f.write("#Sample\tTree node\tParsimony score\tOptimal (y/n)\t"
                                 "Parsimony-increasing mutations (for optimal nodes)\n")

                if check_nodes:
                    stale = any(t.identifier in check_ids
                                for t in res.tied_nodes)
                    if not stale:
                        for node in check_nodes:
                            d = score_placement(node, s.mutations,
                                                compute_vecs=False)
                            if d.is_valid and d.set_difference <= res.best_score:
                                stale = True
                                break
                    if stale:
                        res = engine.score_samples(
                            [s.mutations],
                            want_matrix=opts.print_parsimony_scores)[0]
                    elif res.num_best > 1 and tree_dirty:
                        _refresh_winner(res)

                best_set_difference = res.best_score
                num_best = res.num_best
                best_node = res.best_node
                total_nodes = len(flat.tree.breadth_first_expansion())

                # Cross-check device score against the exact host scorer for the
                # winner; also produces the excess/imputed vectors for surgery.
                detail = score_placement(best_node, s.mutations)
                if detail.set_difference != best_set_difference:
                    raise AssertionError(
                        f"device/host score mismatch for {sample} at "
                        f"{best_node.identifier}: {best_set_difference} vs "
                        f"{detail.set_difference}")

                if opts.print_parsimony_scores:
                    _err(f"Missing sample: {sample}\t Best parsimony score: "
                         f"{best_set_difference}\tNumber of parsimony-optimal "
                         f"placements: {num_best}")
                    bfs_nodes = flat.tree.breadth_first_expansion()
                    for k, node in enumerate(bfs_nodes):
                        sc = int(res.scores_bfs[k])
                        reported = sc if res.valid_bfs[k] else sc + 1
                        is_opt = "y" if reported == best_set_difference else "n"
                        pars_f.write(f"{sample}\t{node.identifier}\t{reported}\t\t{is_opt}\t")
                        if reported == best_set_difference:
                            det_k = score_placement(node, s.mutations)
                            if reported == 0:
                                pars_f.write("*")
                            n_print = min(reported, len(det_k.excess))
                            pars_f.write(",".join(
                                det_k.excess[i].get_string() for i in range(n_print)))
                        else:
                            pars_f.write("N/A")
                        pars_f.write("\n")
                    # the reference writes the (empty) per-sample stats terminator
                    # even in -p mode (usher_common.cpp:788)
                    stats_f.write("\n")
                    continue

                _err(f"Current tree size (#nodes): {total_nodes}\tSample name: "
                     f"{sample}\tParsimony score: {best_set_difference}\tNumber of "
                     f"parsimony-optimal placements: {num_best}")
                stats_f.write(f"{sample}\t{best_set_difference}\t{num_best}\t")

                if num_best > 1:
                    if opts.max_trees == 1:
                        low_confidence_samples.append(sample)
                    if num_best > opts.max_uncertainty:
                        _err(f"WARNING: Number of parsimony-optimal placements exceeds "
                             f"maximum allowed value ({opts.max_uncertainty}). Ignoring "
                             f"sample {sample}.")
                    elif best_set_difference <= opts.max_parsimony:
                        _err("WARNING: Multiple parsimony-optimal placements found. "
                             "Placement done without high confidence.")
                if best_set_difference > opts.max_parsimony:
                    _err(f"WARNING: Parsimony score of the most parsimonious placement "
                         f"exceeds the maximum allowed value ({opts.max_parsimony}). "
                         f"Ignoring sample {sample}.")

                if (num_best <= opts.max_uncertainty
                        and best_set_difference <= opts.max_parsimony):
                    # clade assignment over the tie set (usher_common.cpp:600-619)
                    num_annotations = T.get_num_annotations()
                    s.clade_assignments = []
                    s.best_clade_assignment = [""] * num_annotations
                    for c in range(num_annotations):
                        assignments = []
                        for node, hu in zip(res.tied_nodes, res.tied_has_unique):
                            include_self = (not node.is_leaf()) and (not hu)
                            clade = T.get_clade_assignment(node, c, include_self)
                            assignments.append(clade)
                            if node is best_node:
                                s.best_clade_assignment[c] = clade
                        assignments.sort()
                        s.clade_assignments.append(assignments)

                    if not opts.no_add and T.get_node(sample) is None:
                        parent_before = best_node.parent
                        engine.apply_placement(sample, res, detail.excess)
                        tree_dirty = True
                        fresh_order["meta"] = None
                        added = [T.get_node(sample)]
                        if best_node.parent is not parent_before:
                            # sibling split: the new internal node is a fresh
                            # candidate AND best_node's own score changed
                            # (its branch mutations were redistributed)
                            added.append(best_node.parent)
                            added.append(best_node)
                        for n in added:
                            if n is not None and n.identifier not in check_ids:
                                check_ids.add(n.identifier)
                                check_nodes.append(n)

                    if detail.imputed:
                        _err("Imputed mutations:\t" + ";".join(
                            f"{m.position}:{_nuc_char(m.mut_nuc)}" for m in detail.imputed))
                        stats_f.write(";".join(
                            f"{m.position}:{_nuc_char(m.mut_nuc)}" for m in detail.imputed))
                stats_f.write("\n")

        stats_f.close()
        if pars_f is not None:
            pars_f.close()
        if opts.print_parsimony_scores:
            return 0

    # --- outputs (usher_common.cpp:796-1044) --------------------------------

    if opts.collapse_output_tree:
        _err("Collapsing output tree.")
        T.collapse_tree()

    if opts.print_uncondensed_tree:
        path = os.path.join(outdir, "uncondensed-final-tree.nh")
        _err(f"Writing uncondensed final tree to file {path}")
        _err(f"The parsimony score for this tree is: {T.get_parsimony_score()}")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True,
                                 uncondense_leaves=True))
    else:
        path = os.path.join(outdir, "final-tree.nh")
        _err(f"Writing final tree to file {path}")
        _err(f"The parsimony score for this tree is: {T.get_parsimony_score()}")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True))

    if missing_samples:
        path = os.path.join(outdir, "mutation-paths.txt")
        _err(f"Writing mutation paths to file {path}")
        write_mutation_paths(T, [s.name for s in missing_samples], path)

        num_annotations = T.get_num_annotations()
        if num_annotations > 0:
            path = os.path.join(outdir, "clades.txt")
            _err(f"Writing clade annotations to file {path}")
            with open(path, "w") as f:
                for s in missing_samples:
                    if not s.best_clade_assignment:
                        continue
                    f.write(f"{s.name}\t")
                    cols = []
                    for k in range(num_annotations):
                        col = s.best_clade_assignment[k]
                        if opts.max_trees == 1 and opts.detailed_clades:
                            col += "*|"
                            hist = []
                            curr_clade, curr_count = "", 0
                            total = len(s.clade_assignments[k])
                            for clade in s.clade_assignments[k]:
                                if clade == curr_clade:
                                    curr_count += 1
                                else:
                                    if curr_count > 0:
                                        hist.append(f"{curr_clade}({curr_count}/{total})")
                                    curr_clade, curr_count = clade, 1
                            if curr_count > 0:
                                hist.append(f"{curr_clade}({curr_count}/{total})")
                            col += ",".join(hist)
                        cols.append(col)
                    f.write("\t".join(cols) + "\n")

    if opts.print_subtrees_single > 1 and missing_samples:
        from ..tools.subtrees import write_single_subtree
        _err(f"Computing the single subtree for added samples with "
             f"{opts.print_subtrees_single} random leaves.\n")
        T.uncondense_leaves()
        write_single_subtree(
            T, [s.name for s in missing_samples], outdir,
            opts.print_subtrees_single,
            retain_original_branch_len=opts.retain_original_branch_len)

    if opts.print_subtrees_size > 1 and missing_samples:
        from ..tools.subtrees import write_sample_subtrees
        _err("Computing subtrees for added samples.\n")
        T.uncondense_leaves()
        write_sample_subtrees(
            T, [s.name for s in missing_samples], outdir,
            opts.print_subtrees_size,
            retain_original_branch_len=opts.retain_original_branch_len)

    if low_confidence_samples:
        _err("WARNING: Following samples had multiple possibilities of "
             "parsimony-optimal placements:")
        for name in low_confidence_samples:
            _err(name)

    if opts.dout_filename:
        _err(f"Saving mutation-annotated tree object to file (after condensing "
             f"identical sequences) {opts.dout_filename}")
        if T.condensed_nodes:
            T.uncondense_leaves()
        T.condense_leaves()
        save_mat_pb(T, opts.dout_filename)

    return 0


def run_usher_multi(T: Tree, missing_samples: list[MissingSample],
                    opts: UsherOptions, vcf=None) -> int:
    """--multiple-placements (-M > 1): each sample is placed into EVERY tree
    accumulated so far; when a tree offers multiple parsimony-optimal
    placements and capacity remains, the tree is forked — one copy per
    co-optimal node in BFS order (usher_common.cpp:310-780; fork accounting
    :556-585; per-tree outputs :830-1011).

    Deviation from the reference: the fork's sibling-vs-child choice uses
    the tied node's own has_unique value (the reference indexes
    node_has_unique[k] with the fork counter, usher_common.cpp:653 — an
    out-of-range-looking index we do not reproduce)."""
    os.makedirs(opts.outdir, exist_ok=True)
    outdir = os.path.realpath(opts.outdir)

    if opts.collapse_tree:
        _err("Collapsing input tree.")
        T.collapse_tree()
        _err("Condensing identical sequences.")
        T.condense_leaves()
        path = os.path.join(outdir, "condensed-tree.nh")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True,
                                 retain_original_branch_len=opts.retain_original_branch_len)
                    + "\n")

    _err(f"Found {len(missing_samples)} missing samples.\n")
    if opts.sort_before_placement_3:
        missing_samples.sort(key=lambda s: s.num_ambiguous)
        if opts.reverse_sort:
            missing_samples.reverse()

    optimal_trees: list[Tree] = [T]
    engines: dict[int, PlacementEngine] = {0: PlacementEngine(T, vcf)}
    indexes = list(range(len(missing_samples)))

    if ((opts.sort_before_placement_1 or opts.sort_before_placement_2)
            and len(missing_samples) > 1):
        _err("Computing parsimony scores and number of parsimony-optimal "
             "placements for new samples and using them to sort the samples.")
        for s in missing_samples:
            s.mutations.sort(key=lambda m: m.position)
        pres = engines[0].score_samples(
            [s.mutations for s in missing_samples])
        best_scores = [r.best_score for r in pres]
        num_placements = [r.num_best for r in pres]
        if opts.sort_before_placement_1:
            indexes.sort(key=lambda i: (best_scores[i], num_placements[i]))
        else:
            indexes.sort(key=lambda i: (num_placements[i], best_scores[i]))
        if opts.reverse_sort:
            indexes.reverse()

    _err("Adding missing samples to the tree.")
    stats_path = os.path.join(outdir, "placement_stats.tsv")
    with open(stats_path, "w") as stats_f:
        for idx in indexes:
            s = missing_samples[idx]
            sample = s.name
            num_trees = len(optimal_trees)
            for t_idx in range(num_trees):
                Tt = optimal_trees[t_idx]
                if t_idx not in engines:
                    engines[t_idx] = PlacementEngine(Tt, vcf)
                eng = engines[t_idx]
                if num_trees > 1:
                    _err(f"==Tree {t_idx + 1}=== ")
                if Tt.get_node(sample) is not None:
                    _err(f"WARNING: Sample {sample} already in the tree! "
                         f"Ignoring.\n")
                    continue
                res = eng.score_samples([s.mutations])[0]
                total_nodes = Tt.num_nodes()
                _err(f"Current tree size (#nodes): {total_nodes}\tSample "
                     f"name: {sample}\tParsimony score: {res.best_score}\t"
                     f"Number of parsimony-optimal placements: "
                     f"{res.num_best}")
                stats_f.write(f"{sample}\t{res.best_score}\t{res.num_best}\t")
                if res.num_best > 1:
                    if res.num_best > opts.max_uncertainty:
                        _err(f"WARNING: Number of parsimony-optimal "
                             f"placements exceeds maximum allowed value "
                             f"({opts.max_uncertainty}). Ignoring sample "
                             f"{sample}.")
                    elif res.best_score <= opts.max_parsimony:
                        _err("WARNING: Multiple parsimony-optimal placements "
                             "found. Placement done without high confidence.")
                if res.best_score > opts.max_parsimony:
                    _err(f"WARNING: Parsimony score of the most parsimonious "
                         f"placement exceeds the maximum allowed value "
                         f"({opts.max_parsimony}). Ignoring sample {sample}.")

                if (res.num_best <= opts.max_uncertainty
                        and res.best_score <= opts.max_parsimony):
                    nb = res.num_best
                    if nb + len(optimal_trees) > opts.max_trees:
                        if (nb + len(optimal_trees) > opts.max_trees + 1
                                and opts.max_trees > 1):
                            _err(f"{nb} parsimony-optimal placements found "
                                 f"but total trees has already exceed the "
                                 f"max possible value ({opts.max_trees})!")
                        nb = max(1, 1 + opts.max_trees - len(optimal_trees))
                    curr_copy = Tt.copy() if nb > 1 else None
                    for k in range(nb):
                        if nb > 1 and k == 0:
                            _err(f"Creating {nb - 1} additional tree(s) for "
                                 f"{nb} parsimony-optimal placements.")
                        if k == 0:
                            target_T, target_eng = Tt, eng
                            node = res.tied_nodes[0]
                            hu = res.tied_has_unique[0]
                        else:
                            newT = curr_copy.copy()
                            optimal_trees.append(newT)
                            target_eng = PlacementEngine(newT, vcf)
                            engines[len(optimal_trees) - 1] = target_eng
                            target_T = newT
                            node = target_T.get_node(
                                res.tied_nodes[k].identifier)
                            hu = res.tied_has_unique[k]
                        if not opts.no_add and target_T.get_node(sample) is None:
                            detail = score_placement(node, s.mutations)
                            res_k = SampleResult(
                                best_score=res.best_score,
                                num_best=res.num_best, best_node=node,
                                best_has_unique=hu)
                            target_eng.apply_placement(sample, res_k,
                                                       detail.excess)
                            if detail.imputed:
                                imp = ";".join(
                                    f"{m.position}:{_nuc_char(m.mut_nuc)}"
                                    for m in detail.imputed)
                                _err("Imputed mutations:\t" + imp)
                                stats_f.write(imp)
                stats_f.write("\n")

    # --- per-tree outputs (usher_common.cpp:830-1011) -----------------------
    num_trees = len(optimal_trees)
    for t_idx, Tt in enumerate(optimal_trees):
        if opts.collapse_output_tree:
            _err("Collapsing output tree.")
            Tt.collapse_tree()
        suffix = f"-{t_idx + 1}" if num_trees > 1 else ""
        if opts.print_uncondensed_tree:
            path = os.path.join(outdir,
                                f"uncondensed-final-tree{suffix}.nh")
            _err(f"Writing uncondensed final tree to file {path}")
            with open(path, "w") as f:
                f.write(write_newick(Tt, print_internal=True,
                                     print_branch_len=True,
                                     uncondense_leaves=True))
        else:
            path = os.path.join(outdir, f"final-tree{suffix}.nh")
            _err(f"Writing final tree to file {path}")
            _err(f"The parsimony score for this tree is: "
                 f"{Tt.get_parsimony_score()}")
            with open(path, "w") as f:
                f.write(write_newick(Tt, print_internal=True,
                                     print_branch_len=True))
        if missing_samples:
            path = os.path.join(outdir, f"mutation-paths{suffix}.txt")
            _err(f"Writing mutation paths to file {path}")
            write_mutation_paths(Tt, [s.name for s in missing_samples], path)

    if opts.print_subtrees_single > 1 and missing_samples:
        from ..tools.subtrees import write_single_subtree
        for t_idx, Tt in enumerate(optimal_trees):
            Tt.uncondense_leaves()
            write_single_subtree(
                Tt, [s.name for s in missing_samples], outdir,
                opts.print_subtrees_single, tree_idx=t_idx,
                use_tree_idx=(num_trees > 1),
                retain_original_branch_len=opts.retain_original_branch_len)
    if opts.print_subtrees_size > 1 and missing_samples:
        from ..tools.subtrees import write_sample_subtrees
        for t_idx, Tt in enumerate(optimal_trees):
            Tt.uncondense_leaves()
            write_sample_subtrees(
                Tt, [s.name for s in missing_samples], outdir,
                opts.print_subtrees_size, tree_idx=t_idx,
                use_tree_idx=(num_trees > 1),
                retain_original_branch_len=opts.retain_original_branch_len)

    if opts.dout_filename:
        _err(f"Saving mutation-annotated tree object to file (after "
             f"condensing identical sequences) {opts.dout_filename}")
        if num_trees > 1:
            _err("WARNING: --multiple-placements option was used but only "
                 "the first mutation-annotated tree object will be saved to "
                 "file.")
        T0 = optimal_trees[0]
        if T0.condensed_nodes:
            T0.uncondense_leaves()
        T0.condense_leaves()
        save_mat_pb(T0, opts.dout_filename)
    return 0


def _nuc_char(nuc_id: int) -> str:
    from ..core.nuc import char_from_nuc_id
    return char_from_nuc_id(nuc_id)


def write_mutation_paths(T: Tree, samples: list[str], filename: str) -> None:
    """Root->sample branch mutation paths (reference
    mutation_annotated_tree.cpp:1991-2050)."""
    with open(filename, "w") as f:
        for sample in samples:
            node = T.get_node(sample)
            if node is None:
                continue
            chain = []
            cur = node
            while cur is not None:
                if cur.mutations:
                    chain.append(cur.identifier + ":"
                                 + ",".join(m.get_string() for m in cur.mutations)
                                 + " ")
                cur = cur.parent
            f.write(sample + "\t" + "".join(reversed(chain)) + "\n")

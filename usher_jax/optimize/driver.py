"""matOptimize-equivalent driver: iterative SPR parsimony optimization.

Mirrors the reference's outer loop (src/matOptimize/main.cpp:505-566):
radius doubling (radius < 0), iterate until the per-iteration improvement
drops below min_improvement * score (then drift for `drift_iterations`
accepting sideways moves), periodic checkpointing, wall-clock cap, and a
profitable-move log (main.cpp:433, optimize_tree.cpp:61-66).

Each iteration:
  1. whole-tree Fitch-Sankoff reassignment (vectorized; replaces
     reassign_states.cpp) -> canonical states + subtree Fitch sets + exact
     parsimony
  2. device move search: every source node re-placement-scored against all
     radius-bounded destinations in fused batches
  3. DFS-interval conflict resolution, batch apply, repeat

The parsimony guard (revert if an applied batch did not improve the FS-exact
score) replaces the reference's DEBUG_PARSIMONY_SCORE_CHANGE_CORRECT
checker: correctness does not depend on the move-scoring algebra.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from ..core.flat import collect_positions
from ..core.tree import Tree
from .fitch import FitchEngine
from .spr import MoveFinder, apply_move, resolve_conflicts


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


# --- graceful interruption (reference matOptimize/main.cpp:59-66) -----------
# SIGUSR2 requests a graceful stop: finish applying the current batch, save,
# exit.  SIGUSR1 requests a log flush.
_interrupted = False
_flush_requested = False


def _on_sigusr2(signum, frame):
    global _interrupted
    _interrupted = True


def _on_sigusr1(signum, frame):
    global _flush_requested
    _flush_requested = True


def install_signal_handlers() -> None:
    """Install SIGUSR1 (flush log) / SIGUSR2 (graceful stop) handlers; call
    from the CLI main thread."""
    import signal
    signal.signal(signal.SIGUSR1, _on_sigusr1)
    signal.signal(signal.SIGUSR2, _on_sigusr2)


def _interrupt_requested() -> bool:
    return _interrupted


@dataclass
class OptimizeOptions:
    radius: int = -1                 # <0: start at 2, double up to tree span
    min_improvement: float = 0.0005  # reference main.cpp:171
    max_iterations: int = 1000       # reference -N
    drift_iterations: int = 0        # reference -d
    max_hours: float = 0.0           # reference -M (0 = unlimited)
    source_chunk: int = 128
    checkpoint_path: str = ""        # reference -s intermediate pb
    checkpoint_minutes: float = 30.0
    profitable_src_log: str = ""     # reference -S
    node_proportion: float = 1.0     # reference -z
    seed: int = 0                    # reference -y
    exhaustive_first: bool = False
    reduce_back_mutations: bool = True  # final min-back FS pass (reference
                                        # matOptimize main.cpp:570-581 default)
    blacklist: frozenset = frozenset()  # node ids never moved (reference
                                        # --black_list_node_file)
    drift_nwk_stem: str = ""            # -b intermediate newicks while
                                        # drifting (reference main.cpp:181)
    initial_changed_ids: frozenset = frozenset()  # change flags restored
                                        # from a detailed checkpoint (-a)
    mesh_devices: int = 0    # >1: shard FS positions + SPR source batches
                             # over a 1-D device mesh (0/1 = single device)
    spr_backend: str = "dense"  # "big" scores moves through the CSR BigMAT
                             # path (no [N, P] device state matrices;
                             # bit-identical, optimize/spr_big.py)
    stream_states: bool = False  # pandemic-scale mode: never hold [n, P]
                             # states/masks; re-run the streamed full FS
                             # each iteration instead of the local patch
                             # (implies spr_backend "big")


def _tree_distance(a, b) -> int:
    """Hop distance between two nodes (walk both to their LCA)."""
    seen = {}
    cur, d = a, 0
    while cur is not None:
        seen[id(cur)] = d
        cur = cur.parent
        d += 1
    cur, d = b, 0
    while cur is not None:
        if id(cur) in seen:
            return d + seen[id(cur)]
        cur = cur.parent
        d += 1
    return d  # pragma: no cover (disjoint trees)


def _collect_affected(mv, affected: set, changed: set) -> None:
    """Positions whose FS states a move can perturb (mutations in the moved
    subtree + on both old and new root paths + merge partners) and the
    identifiers of the topology-change points (for change-flag selection,
    reference main_helper.cpp:79-141)."""
    s, d = mv.src, mv.dst
    stack = [s]
    while stack:
        nd = stack.pop()
        for m in nd.mutations:
            affected.add(m.position)
        stack.extend(nd.children)
    p = s.parent
    changed.add(s.identifier)
    changed.add(d.identifier)
    if p is not None:
        changed.add(p.identifier)
        for sib in p.children:
            if sib is not s:
                changed.add(sib.identifier)
                for m in sib.mutations:
                    affected.add(m.position)
    cur = p
    while cur is not None:
        for m in cur.mutations:
            affected.add(m.position)
        cur = cur.parent
    cur = d
    while cur is not None:
        for m in cur.mutations:
            affected.add(m.position)
        cur = cur.parent


def _ball_sources(finder, changed_ids: set, radius: int) -> list:
    """BFS-index sources within `radius` hops of any changed node —
    O(ball size), replacing full-tree rescans between iterations."""
    from collections import deque
    seeds = [i for i, nd in enumerate(finder.bfs)
             if nd.identifier in changed_ids]
    dist = {i: 0 for i in seeds}
    q = deque(seeds)
    while q:
        u = q.popleft()
        du = dist[u]
        if du >= radius:
            continue
        for v in finder.adj[u]:
            if v not in dist:
                dist[v] = du + 1
                q.append(v)
    return sorted(i for i in dist if i != 0)


def optimize_tree(T: Tree, opts: OptimizeOptions = OptimizeOptions()) -> int:
    """Optimize in place; returns the final parsimony score."""
    global _flush_requested
    t_start = time.time()
    t_checkpoint = t_start
    positions, ref, chrom = collect_positions(T)
    if len(positions) == 0:
        return 0
    pos_index = {int(p): i for i, p in enumerate(positions)}
    rng = np.random.default_rng(opts.seed)

    mesh = None
    if opts.mesh_devices > 1:
        import jax
        from ..parallel.shard import batch_mesh
        nd = min(opts.mesh_devices, len(jax.devices()))
        if nd > 1:
            mesh = batch_mesh(nd)
            _err(f"Sharding FS positions and SPR source batches over "
                 f"{nd} devices")

    log_f = open(opts.profitable_src_log, "w") if opts.profitable_src_log else None
    if log_f:
        log_f.write("source\tdestination\titeration\tscore.change\t"
                    "distance\tsubtree.size\n")

    doubling = opts.radius < 0
    max_level = max(n.level for n in T.breadth_first_expansion())
    radius = 2 if doubling else opts.radius

    engine = FitchEngine(T, positions, mesh=mesh)
    # persistent leaf genotypes (the reference's Original_State_t,
    # check_samples.cpp:35-41): the invariant of the whole optimization.
    # Sparse store: O(total deviations) instead of a dense [n, P] matrix
    # (optimize/leafstore.py).
    from .leafstore import SparseLeafStore
    leaf_store, ref_row = SparseLeafStore.from_tree(T, positions)

    def full_refresh():
        eng = FitchEngine(T, positions, mesh=mesh)
        st, mk = eng.run(leaf_store, ref_row)
        sc = eng.rewrite_mutations(st, leaf_store, ref_row, chrom)
        return eng, st, mk, sc

    def full_refresh_streamed():
        eng = FitchEngine(T, positions, mesh=mesh)
        sc, devs = eng.run_rewrite_streamed(leaf_store, ref_row, chrom)
        return eng, devs, sc

    stream = opts.stream_states
    # streamed mode pays a device round-trip per source chunk; bigger
    # batches amortize dispatch latency (results are chunk-invariant)
    source_chunk = opts.source_chunk
    if stream and source_chunk == 128:
        source_chunk = 512
    if stream:
        score, mask_devs = engine.run_rewrite_streamed(leaf_store, ref_row,
                                                       chrom)
        states = masks = None
    else:
        states, masks = engine.run(leaf_store, ref_row)
        score = engine.rewrite_mutations(states, leaf_store, ref_row, chrom)
    _err(f"Initial parsimony score {score}")

    drift_remaining = opts.drift_iterations
    iteration = 0
    changed_ids: set | None = (set(opts.initial_changed_ids)
                               if opts.initial_changed_ids else None)
    # None = scan every source
    while iteration < opts.max_iterations:
        iteration += 1
        if opts.max_hours and (time.time() - t_start) > opts.max_hours * 3600:
            _err("Exceeded max runtime, saving current tree")
            break
        if _interrupt_requested():
            _err("Interrupt requested (SIGUSR2), saving current tree")
            break

        if stream or opts.spr_backend == "big":
            from .spr_big import BigMoveFinder
            finder = BigMoveFinder(T, states,
                                   mask_devs if stream else masks,
                                   ref_row, engine.bfs,
                                   engine.parent, chunk=source_chunk,
                                   positions=positions, mesh=mesh,
                                   csr=(getattr(mask_devs, "csr_triplets",
                                                None) if stream else None))
        else:
            finder = MoveFinder(T, states, masks, ref_row, engine.bfs,
                                engine.parent, chunk=opts.source_chunk,
                                mesh=mesh)
        if changed_ids is not None:
            sources = _ball_sources(finder, changed_ids, radius)
        else:
            sources = list(range(1, finder.n))
        if opts.blacklist:
            sources = [i for i in sources
                       if finder.bfs[i].identifier not in opts.blacklist]
        if opts.node_proportion < 1.0 and sources:
            k = max(1, int(len(sources) * opts.node_proportion))
            pick = rng.choice(len(sources), size=k, replace=False)
            sources = sorted(sources[int(x)] for x in pick)
        from ..utils.instrument import timeit
        with timeit("optimize:find_moves"):
            moves = finder.find_moves(radius, sources=sources)
        accepted = resolve_conflicts(moves)

        if not accepted:
            if changed_ids is not None:
                # the changed-region scan is exhausted; fall back to one
                # full rescan before concluding convergence at this radius
                changed_ids = None
                continue
            if doubling and radius < 2 * max_level:
                radius *= 2
                _err(f"No profitable moves at radius {radius // 2}, "
                     f"doubling to {radius}")
                continue
            break

        affected: set = set()
        changed_new: set = set()
        for mv in accepted:
            _collect_affected(mv, affected, changed_new)
        undo_logs = []
        for mv in accepted:
            # distance BEFORE the apply perturbs levels (reference logs the
            # src-dst hop distance, optimize_tree.cpp:61-66)
            dist = _tree_distance(mv.src, mv.dst) if log_f else 0
            undo_logs.append(apply_move(T, mv))
            if mv.src.parent is not None:
                changed_new.add(mv.src.parent.identifier)
            if log_f:
                log_f.write(f"{mv.src.identifier}\t{mv.dst.identifier}\t"
                            f"{iteration}\t{-mv.improvement}\t{dist}\t"
                            f"{mv.src_interval[1]-mv.src_interval[0]}\n")

        if stream:
            # pandemic-scale path: patch ONLY the affected columns (the
            # same local FS discipline as the dense branch below) — the
            # per-iteration cost scales with |affected|, never O(n*P).
            # Fall back to the streamed full FS when the remap fails or
            # the affected set covers most of the genome.
            cols = sorted(pos_index[p] for p in affected if p in pos_index)
            new_engine = FitchEngine(T, positions, mesh=mesh)
            old_index = {id(nd): i for i, nd in enumerate(engine.bfs)}
            old_n = engine.n
            src_rows = np.empty(new_engine.n, dtype=np.int64)
            is_new_row = np.zeros(new_engine.n, dtype=bool)
            ok_remap = True
            for i, nd in enumerate(new_engine.bfs):
                j = old_index.get(id(nd))
                if j is None:
                    is_new_row[i] = True
                    ch = next((c for c in nd.children
                               if id(c) in old_index), None)
                    if ch is None:
                        ok_remap = False
                        break
                    j = old_index[id(ch)]
                src_rows[i] = j
            if not ok_remap or len(cols) > len(positions) // 2:
                engine, mask_devs, new_score = full_refresh_streamed()
            else:
                engine = new_engine
                cols_arr = np.asarray(cols, dtype=np.int64)
                lm_sub = leaf_store.materialize_cols(
                    engine.bfs, engine.is_leaf, cols_arr)
                with timeit("optimize:fs_patch_streamed"):
                    st_sub, mk_sub = engine.run(lm_sub, ref_row[cols_arr])
                engine.patch_mutations(st_sub, lm_sub, ref_row[cols_arr],
                                       chrom, positions[cols_arr])
                old_trips = getattr(mask_devs, "csr_triplets", None)
                mask_devs = mask_devs.remap_patch(
                    src_rows, cols_arr, mk_sub, ref_row[cols_arr])
                if old_trips is not None:
                    # patch the array-form mutation set the same way: keep
                    # surviving nodes' entries outside the patched columns,
                    # add the freshly solved entries at them (new nodes have
                    # no mutations outside the patch by construction)
                    o2n = np.full(old_n, -1, dtype=np.int64)
                    ident = ~is_new_row
                    o2n[src_rows[ident]] = np.nonzero(ident)[0]
                    tn, tc, tp, tm = old_trips
                    nn = o2n[tn]
                    take = np.searchsorted(cols_arr, tc)
                    inpatch = (take < len(cols_arr)) & (cols_arr[
                        np.minimum(take, max(len(cols_arr) - 1, 0))] == tc)                         if len(cols_arr) else np.zeros(len(tc), bool)
                    keep = (nn >= 0) & ~inpatch
                    ni, si, pv, mv = engine._mutation_arrays(
                        st_sub, lm_sub, ref_row[cols_arr])
                    mask_devs.csr_triplets = (
                        np.concatenate([nn[keep], ni]),
                        np.concatenate([tc[keep], cols_arr[si]]),
                        np.concatenate([tp[keep], pv]),
                        np.concatenate([tm[keep], mv]))
                new_score = T.get_parsimony_score()
                if os.environ.get("USHER_JAX_CHECK_STATE_REASSIGN"):
                    chk_engine, chk_devs, chk_score = full_refresh_streamed()
                    assert chk_score == new_score, (
                        f"CHECK_STATE_REASSIGN(streamed): local patch score "
                        f"{new_score} != full recompute {chk_score}")
                    engine, mask_devs = chk_engine, chk_devs
            if new_score > score:
                _err(f"Iteration {iteration}: batch regressed "
                     f"({score} -> {new_score}), reverting to single best "
                     f"move")
                from .spr import revert_moves
                revert_moves(T, undo_logs)
                undo0 = apply_move(T, accepted[0])
                engine, mask_devs, new_score = full_refresh_streamed()
                if new_score > score:
                    revert_moves(T, [undo0])
                    engine, mask_devs, new_score = full_refresh_streamed()
                    _finish_iteration = True
                else:
                    _finish_iteration = False
            else:
                _finish_iteration = False
            improvement = score - new_score
            _err(f"Iteration {iteration}: parsimony {score} -> {new_score} "
                 f"({len(accepted)} moves applied, radius {radius}, "
                 f"{len(sources)} sources scanned, streamed FS)")
            score = new_score
            changed_ids = changed_new
            if _finish_iteration:
                break
            if _flush_requested and log_f:
                log_f.flush()
                _flush_requested = False
            if opts.checkpoint_path and opts.checkpoint_minutes > 0 and (
                    time.time() - t_checkpoint) > opts.checkpoint_minutes * 60:
                from ..io.detailed import save_detailed_mutations
                save_detailed_mutations(T, opts.checkpoint_path,
                                        changed_ids=changed_ids)
                t_checkpoint = time.time()
                _err(f"Checkpoint saved to {opts.checkpoint_path}")
            if improvement < opts.min_improvement * max(score, 1):
                if drift_remaining > 0:
                    drift_remaining -= 1
                    if opts.drift_nwk_stem:
                        from ..io.newick import write_newick
                        with open(f"{opts.drift_nwk_stem}{iteration}.nwk",
                                  "w") as f:
                            f.write(write_newick(T, print_internal=True,
                                                 print_branch_len=True))
                    continue
                if doubling and radius < 2 * max_level:
                    radius *= 2
                    changed_ids = None
                    continue
                break
            continue

        # local FS patch-up (reference apply_move/backward_pass.cpp): only
        # the affected positions are re-solved; everything else keeps its
        # provably-still-optimal assignment
        cols = sorted(pos_index[p] for p in affected if p in pos_index)
        new_engine = FitchEngine(T, positions, mesh=mesh)
        old_index = {id(nd): i for i, nd in enumerate(engine.bfs)}
        src_rows = np.empty(new_engine.n, dtype=np.int64)
        ok_remap = True
        for i, nd in enumerate(new_engine.bfs):
            j = old_index.get(id(nd))
            if j is None:
                # freshly created internal node (sibling split): identical to
                # its surviving child's path state outside the patched columns
                ch = next((c for c in nd.children if id(c) in old_index),
                          None)
                if ch is None:
                    ok_remap = False
                    break
                j = old_index[id(ch)]
            src_rows[i] = j

        if not ok_remap or len(cols) > len(positions) // 2:
            engine, states, masks, new_score = full_refresh()
        else:
            engine = new_engine
            states = states[src_rows]
            masks = masks[src_rows]
            cols_arr = np.asarray(cols, dtype=np.int64)
            lm_sub = leaf_store.materialize_cols(engine.bfs, engine.is_leaf,
                                                 cols_arr)
            with timeit("optimize:fs_patch"):
                st_sub, mk_sub = engine.run(lm_sub, ref_row[cols_arr])
            engine.patch_mutations(st_sub, lm_sub, ref_row[cols_arr], chrom,
                                   positions[cols_arr])
            states[:, cols_arr] = st_sub
            masks[:, cols_arr] = mk_sub
            new_score = T.get_parsimony_score()

            if os.environ.get("USHER_JAX_CHECK_STATE_REASSIGN"):
                # invariant checker (reference -DCHECK_STATE_REASSIGN,
                # Fitch_Sankoff.cpp:286-313): the incremental patch must be
                # parsimony-equivalent to a full-tree recomputation
                chk_engine, chk_states, chk_masks, chk_score = full_refresh()
                assert chk_score == new_score, (
                    f"CHECK_STATE_REASSIGN: local FS patch score "
                    f"{new_score} != full recompute {chk_score}")
                engine, states, masks = chk_engine, chk_states, chk_masks

        if new_score > score:
            # guard: the batch interacted badly; revert (O(moves) undo log,
            # not an O(tree) snapshot) and apply only the single best move.
            # full_refresh rewrites all mutation lists from the persistent
            # leaf genotypes, erasing any partial FS-patch output.
            _err(f"Iteration {iteration}: batch regressed "
                 f"({score} -> {new_score}), reverting to single best move")
            from .spr import revert_moves
            revert_moves(T, undo_logs)
            undo0 = apply_move(T, accepted[0])
            engine, states, masks, new_score = full_refresh()
            if new_score > score:
                revert_moves(T, [undo0])
                engine, states, masks, new_score = full_refresh()
                break

        improvement = score - new_score
        _err(f"Iteration {iteration}: parsimony {score} -> {new_score} "
             f"({len(accepted)} moves applied, radius {radius}, "
             f"{len(sources)} sources scanned, {len(cols)} positions "
             f"patched)")
        score = new_score
        changed_ids = changed_new

        if _flush_requested and log_f:
            log_f.flush()
            _flush_requested = False

        if opts.checkpoint_path and opts.checkpoint_minutes > 0 and (
                time.time() - t_checkpoint) > opts.checkpoint_minutes * 60:
            # detailed-mutations format: chunked+compressed with per-node
            # offsets and change flags, so a resume restarts from the same
            # node-selection state (detailed_mutations_store.cpp:279-296)
            from ..io.detailed import save_detailed_mutations
            save_detailed_mutations(T, opts.checkpoint_path,
                                    changed_ids=changed_ids)
            t_checkpoint = time.time()
            _err(f"Checkpoint saved to {opts.checkpoint_path}")

        if improvement < opts.min_improvement * max(score, 1):
            if drift_remaining > 0:
                drift_remaining -= 1
                if opts.drift_nwk_stem:
                    from ..io.newick import write_newick
                    with open(f"{opts.drift_nwk_stem}{iteration}.nwk",
                              "w") as f:
                        f.write(write_newick(T, print_internal=True,
                                             print_branch_len=True))
            elif doubling and radius < 2 * max_level:
                radius *= 2
                changed_ids = None   # a wider radius needs a full rescan
            else:
                break

    if opts.reduce_back_mutations:
        # final pass: re-pick states minimizing (parsimony, back-mutations)
        engine = FitchEngine(T, positions, mesh=mesh)
        if stream:
            mb_score, _ = engine.run_rewrite_streamed(leaf_store, ref_row,
                                                      chrom, min_back=True)
            if mb_score > score:
                score, _ = engine.run_rewrite_streamed(leaf_store, ref_row,
                                                       chrom)
            else:
                score = mb_score
        else:
            states, masks = engine.run(leaf_store, ref_row, min_back=True)
            mb_score = engine.rewrite_mutations(states, leaf_store, ref_row,
                                                chrom)
            if mb_score > score:
                # never trade parsimony away; redo with the plain pass
                states, masks = engine.run(leaf_store, ref_row)
                score = engine.rewrite_mutations(states, leaf_store, ref_row,
                                                 chrom)
            else:
                score = mb_score

    if log_f:
        log_f.close()
    _err(f"Final parsimony score {score}")
    return score

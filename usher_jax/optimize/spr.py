"""SPR move search + application, on device.

The reference's move search is a 3.7k-LoC incremental delta algebra
(src/matOptimize/Profitable_Moves_Enumerators/) walking up/down from every
source node under TBB.  Here a move is scored EXACTLY as a re-placement: the
pruned subtree's Fitch major-allele set (from the vectorized whole-tree FS
backward pass) is the "sample genotype", and the existing fused placement
kernel scores it against every destination at once:

  new branch cost(s -> d) = #{p : fitch_set(s,p) & path_state(d,p) == 0}
    (with the kernel's branch-exclusion / sibling-split semantics)

  improvement(s -> d) = len(muts(s)) + collapse_bonus(s) - cost(s, d)

where collapse_bonus counts the mutations freed when pruning s leaves its
parent single-child and the parent's branch merges into the sibling's
(same-position merge semantics of the reference's add_mutation).  Fitch's
theorem makes the subtree-internal parsimony invariant to which major-set
state the new parent provides, so the improvement is exact given the current
state assignment; a full FS reassignment after each apply batch recovers any
additional gains (replacing the reference's local backward/forward patch-up,
apply_move/).  Conflicts are resolved by DFS-interval disjointness, the
vectorized analog of the reference's path-registration resolver
(priority_conflict_resolver.cpp).

Destination candidates are radius-bounded by hop distance like the
reference's `find_moves_bounded` radius (Profitable_Moves_Enumerators.hpp:166).
"""

from __future__ import annotations

import functools
import sys
from dataclasses import dataclass

import numpy as np

from ..parallel.distributed import fetch as _fetch
import jax
import jax.numpy as jnp

from ..core.tree import Node, Tree
from ..ops.placement import score_with_stp, valid_mask


@dataclass
class Move:
    src: Node
    dst: Node
    improvement: int
    sibling_split: bool
    src_interval: tuple[int, int]
    dst_dfs: int


@functools.partial(jax.jit, static_argnames=("L",))
def _score_moves(st, stp, ref, active, g, num_leaves, bfs_rank,
                 dfs_idx, level, anc_lo, anc_hi, anc_lvl,
                 src_level, src_lo, src_hi, src_parent, radius, L: int):
    """Score subtree masks g [B,P] against all radius-bounded dests in one
    fused call; returns per-source (best_cost [B], best_slot [B],
    best_has_unique [B]).

    Radius bounding is computed ON DEVICE (replacing the reference's per-node
    pointer walks and round 1's per-source host BFS): hop distance in a tree
    is level[src] + level[dst] - 2*level[lca], and lca level for all dsts at
    once is the deepest src-ancestor whose DFS interval contains dst — a max
    over the L padded ancestor slots (anc_lo/anc_hi/anc_lvl [B, L])."""
    E = jnp.ones(g.shape, dtype=jnp.bool_)
    miss = jnp.zeros(g.shape, dtype=jnp.bool_)
    score, num_common, node_num_mut = score_with_stp(
        st, stp, ref, active, g, E, miss)
    valid, has_unique = valid_mask(
        score, num_common, node_num_mut,
        jnp.zeros(st.shape[0], jnp.bool_).at[0].set(True),
        jnp.zeros(st.shape[0], jnp.bool_),  # dest leaves get sibling-split via has_unique anyway
        active)

    # device radius mask
    d = dfs_idx[None, :]
    lca_lvl = jnp.full((g.shape[0], st.shape[0]), -1, dtype=jnp.int32)
    for l in range(L):
        contains = (anc_lo[:, l:l + 1] <= d) & (d < anc_hi[:, l:l + 1])
        lca_lvl = jnp.maximum(lca_lvl,
                              jnp.where(contains, anc_lvl[:, l:l + 1], -1))
    dist = level[None, :] + src_level[:, None] - 2 * lca_lvl
    ok = dist <= radius
    in_sub = (d >= src_lo[:, None]) & (d < src_hi[:, None])
    ok = ok & ~in_sub
    idx = jnp.arange(st.shape[0], dtype=jnp.int32)[None, :]
    ok = ok & (idx != src_parent[:, None])
    valid = valid & ok

    big = jnp.int32(1 << 30)
    s = jnp.where(valid, score, big)
    best = jnp.min(s, axis=1)
    is_best = valid & (score == best[:, None])
    neg = jnp.int32(-1)
    leaves_masked = jnp.where(is_best, num_leaves[None, :], neg)
    best_leaves = jnp.max(leaves_masked, axis=1)
    is_best2 = is_best & (num_leaves[None, :] == best_leaves[:, None])
    rank_masked = jnp.where(is_best2, bfs_rank[None, :], neg)
    best_rank = jnp.max(rank_masked, axis=1)
    best_slot = jnp.argmax(
        (bfs_rank[None, :] == best_rank[:, None]) & is_best2, axis=1)
    hu_best = jnp.take_along_axis(has_unique, best_slot[:, None], axis=1)[:, 0]
    return best, best_slot.astype(jnp.int32), hu_best


def merge_count(a, b) -> int:
    """Length of add_mutation-merge of two sorted mutation lists (same-position
    entries chain a.par->b.mut, cancelling when equal)."""
    by_pos = {}
    n = 0
    for m in a:
        by_pos[m.position] = (m.par_nuc, m.mut_nuc)
        n += 1
    for m in b:
        prev = by_pos.get(m.position)
        if prev is None:
            by_pos[m.position] = (m.par_nuc, m.mut_nuc)
            n += 1
        else:
            par, mut = prev
            if mut != m.par_nuc and par != m.mut_nuc:
                pass  # inconsistent chain; keep updated allele (count same)
            if par == m.mut_nuc:
                n -= 1  # reversal cancels the entry
                del by_pos[m.position]
            else:
                by_pos[m.position] = (par, m.mut_nuc)
    return n


def collapse_bonus(s: Node) -> int:
    """Mutations freed by the parent-merge when pruning s leaves its parent
    with a single child."""
    p = s.parent
    if p is None or p.parent is None or len(p.children) != 2:
        return 0
    sib = p.children[0] if p.children[1] is s else p.children[1]
    return len(p.mutations) + len(sib.mutations) - merge_count(
        p.mutations, sib.mutations)


class MoveFinder:
    """One search round over a frozen tree snapshot."""

    def __init__(self, T: Tree, states: np.ndarray, masks: np.ndarray,
                 ref_row: np.ndarray, bfs: list[Node], parent: np.ndarray,
                 chunk: int = 128, mesh=None):
        """mesh: optional 1-D jax Mesh -- shards the source-node batch axis
        of the move scorer across devices (the device-mesh analog of the
        reference's MPI SPR work distributor,
        src/matOptimize/optimize_tree.cpp:165-252)."""
        self.T = T
        self.bfs = bfs
        self.parent = parent
        self.mesh = mesh
        # with a mesh, each device scores a `chunk`-wide source slice
        self.chunk = chunk * (mesh.size if mesh is not None else 1)
        n = len(bfs)
        self.n = n
        # flat arrays (BFS-indexed)
        st = (1 << states.astype(np.int32)).astype(np.uint8)
        stp = st[parent]
        stp[0] = st[0]
        self.st_host = st
        self.masks = masks
        self.ref_row = ref_row
        if mesh is not None:
            from ..parallel.shard import put_replicated
            dev = lambda a: put_replicated(mesh, jnp.asarray(a))  # noqa: E731
        else:
            dev = jnp.asarray
        self._dev = dev
        self.st = dev(st)
        self.stp = dev(stp)
        self.ref = dev(ref_row)
        self.active = dev(np.ones(n, dtype=np.bool_))

        # DFS intervals on BFS indices
        T.depth_first_expansion()
        self.bfs_index = {id(node): i for i, node in enumerate(bfs)}
        self.dfs_idx = np.array([node.dfs_idx for node in bfs], dtype=np.int64)
        self.dfs_end = np.array([node.dfs_end_idx for node in bfs], dtype=np.int64)
        self.level = np.array([node.level for node in bfs], dtype=np.int32)
        self.dfs_idx_dev = dev(self.dfs_idx.astype(np.int32))
        self.level_dev = dev(self.level)

        num_leaves = np.zeros(n, dtype=np.int32)
        for i in range(n - 1, 0, -1):
            if bfs[i].is_leaf():
                num_leaves[i] += 1
            num_leaves[parent[i]] += num_leaves[i]
        if bfs and bfs[0].is_leaf():
            num_leaves[0] += 1
        self.num_leaves = dev(num_leaves)
        self.bfs_rank = dev(np.arange(n, dtype=np.int32))

        # undirected adjacency for radius bounding
        self.adj: list[list[int]] = [[] for _ in range(n)]
        for i in range(1, n):
            self.adj[i].append(int(parent[i]))
            self.adj[parent[i]].append(i)

    def find_moves(self, radius: int, sources=None,
                   log=None) -> list[Move]:
        n = self.n
        bfs = self.bfs
        if sources is None:
            sources = [i for i in range(1, n)]
        moves: list[Move] = []
        max_level = int(self.level.max()) if n else 0
        eff_radius = radius if radius > 0 else 2 * max_level + 2

        for c0 in range(0, len(sources), self.chunk):
            idxs = sources[c0:c0 + self.chunk]
            B = len(idxs)
            Bp = self.chunk
            g = np.zeros((Bp, self.masks.shape[1]), dtype=np.uint8)
            oldcost = np.zeros(Bp, dtype=np.int64)
            paths = []
            for b, si in enumerate(idxs):
                node = bfs[si]
                g[b] = self.masks[si]
                oldcost[b] = len(node.mutations) + collapse_bonus(node)
                # proper ancestors, nearest first (the lca of src and any
                # dst outside src's subtree is one of these)
                path = []
                p = int(self.parent[si])
                while True:
                    path.append(p)
                    if p == 0:
                        break
                    p = int(self.parent[p])
                paths.append(path)
            g[B:] = 0xF
            maxL = max((len(p) for p in paths), default=1)
            L = -(-maxL // 8) * 8  # bucket the static dim
            anc_lo = np.zeros((Bp, L), dtype=np.int32)
            anc_hi = np.zeros((Bp, L), dtype=np.int32)
            anc_lvl = np.full((Bp, L), -1, dtype=np.int32)
            src_level = np.zeros(Bp, dtype=np.int32)
            src_lo = np.zeros(Bp, dtype=np.int32)
            src_hi = np.full(Bp, n, dtype=np.int32)
            src_parent = np.zeros(Bp, dtype=np.int32)
            for b, si in enumerate(idxs):
                for l, a in enumerate(paths[b]):
                    anc_lo[b, l] = self.dfs_idx[a]
                    anc_hi[b, l] = self.dfs_end[a]
                    anc_lvl[b, l] = self.level[a]
                src_level[b] = self.level[si]
                src_lo[b] = self.dfs_idx[si]
                src_hi[b] = self.dfs_end[si]
                src_parent[b] = self.parent[si]

            if self.mesh is not None:
                # source-batch axis sharded: each device scores its own
                # slice of sources against the replicated tree
                from ..parallel.shard import put_batch
                bat = lambda a: put_batch(self.mesh, a, 0)  # noqa: E731
            else:
                bat = jnp.asarray
            cost, slot, hu = (_fetch(x) for x in _score_moves(
                self.st, self.stp, self.ref, self.active, bat(g),
                self.num_leaves, self.bfs_rank,
                self.dfs_idx_dev, self.level_dev,
                bat(anc_lo), bat(anc_hi),
                bat(anc_lvl), bat(src_level),
                bat(src_lo), bat(src_hi),
                bat(src_parent), jnp.int32(eff_radius), L))
            for b, si in enumerate(idxs):
                imp = int(oldcost[b]) - int(cost[b])
                if imp > 0 and cost[b] < (1 << 29):
                    d = int(slot[b])
                    moves.append(Move(
                        src=bfs[si], dst=bfs[d], improvement=imp,
                        sibling_split=bool(hu[b]) or bfs[d].is_leaf(),
                        src_interval=(int(self.dfs_idx[si]), int(self.dfs_end[si])),
                        dst_dfs=int(self.dfs_idx[d])))
        return moves


def resolve_conflicts(moves: list[Move]) -> list[Move]:
    """Greedy by improvement; a move is deferred if its source subtree or
    destination touches an already-accepted move's region (the reference
    defers path-crossing moves, priority_conflict_resolver.cpp:17-29)."""
    accepted: list[Move] = []
    hot_nodes: set[int] = set()
    intervals: list[tuple[int, int]] = []
    dst_points: list[int] = []

    def covered(x: int) -> bool:
        return any(lo <= x < hi for lo, hi in intervals)

    for mv in sorted(moves, key=lambda m: (-m.improvement, m.src_interval[0])):
        lo, hi = mv.src_interval
        if any(not (hi <= l2 or h2 <= lo) for l2, h2 in intervals):
            continue
        if covered(mv.dst_dfs):
            continue
        if any(lo <= x < hi for x in dst_points):
            continue
        pid = id(mv.src.parent)
        did = id(mv.dst)
        dpid = id(mv.dst.parent) if mv.dst.parent is not None else 0
        if {id(mv.src), pid, did, dpid} & hot_nodes:
            continue
        accepted.append(mv)
        intervals.append((lo, hi))
        dst_points.append(mv.dst_dfs)
        hot_nodes.update({id(mv.src), pid, did, dpid})
    return accepted


def apply_move(T: Tree, mv: Move) -> list:
    """Topological SPR: prune src (merging a single-child parent away), then
    graft at dst (sibling split or child).  Branch mutations are left stale;
    the caller re-runs whole-tree FS to rewrite them.

    Returns an undo log for revert_moves() — O(move) records instead of the
    O(tree) snapshot a full copy would cost (the reference patches locally
    for the same reason, apply_move/)."""
    undo: list = []
    s, d = mv.src, mv.dst
    p = s.parent
    src_idx = p.children.index(s)
    p.children.remove(s)
    undo.append(("reattach_src", s, p, src_idx))
    if len(p.children) == 1 and p.parent is not None:
        c = p.children[0]
        # merge p away: c absorbs p's branch (mutations rewritten later)
        gp = p.parent
        i = gp.children.index(p)
        # snapshot BOTH lists: add_mutation's same-position merge rule
        # mutates Mutation objects in place, so shared references would
        # corrupt the undo state
        undo.append(("unmerge", p, gp, i, c, list(c.mutations),
                     list(p.mutations)))
        gp.children[i] = c
        c.parent = gp
        # keep merged mutation list roughly consistent for oldcost accounting
        merged = [m.copy() for m in p.mutations]
        tmp = [m.copy() for m in c.mutations]
        c.mutations = []
        for m in merged:
            c.add_mutation(m)
        for m in tmp:
            c.add_mutation(m)
        del T._all_nodes[p.identifier]
        T._update_levels(c)
    elif len(p.children) == 0:
        # pruning the last child: p becomes empty; remove upward, merging
        # single-child survivors like Tree.remove_node(move_level=True)
        node = p
        while node.parent is not None and not node.children:
            par = node.parent
            idx = par.children.index(node)
            par.children.remove(node)
            del T._all_nodes[node.identifier]
            undo.append(("undelete", node, par, idx))
            node = par
        if node.parent is not None and len(node.children) == 1:
            child = node.children[0]
            gp = node.parent
            i = gp.children.index(node)
            undo.append(("unmerge_full", node, gp, i, child,
                         list(child.mutations), child.branch_length,
                         list(child.clade_annotations),
                         list(node.mutations)))
            for k in range(len(node.clade_annotations)):
                if k < len(child.clade_annotations) \
                        and child.clade_annotations[k] == "":
                    child.clade_annotations[k] = node.clade_annotations[k]
            child.parent = gp
            child.branch_length += node.branch_length
            tmp = [m.copy() for m in child.mutations]
            child.mutations = []
            for m in node.mutations:
                child.add_mutation(m.copy())
            for m in tmp:
                child.add_mutation(m)
            gp.children[i] = child
            del T._all_nodes[node.identifier]
            T._update_levels(child)

    if mv.sibling_split and d.parent is not None:
        ni = Node(T.new_internal_node_id(), d.parent, -1.0)
        ni.clade_annotations = [""] * T.get_num_annotations()
        gp = d.parent
        i = gp.children.index(d)
        undo.append(("ungraft_split", ni, gp, i, d, s))
        gp.children[i] = ni
        T._all_nodes[ni.identifier] = ni
        d.parent = ni
        ni.children = [d, s]
        s.parent = ni
        T._update_levels(ni)
    else:
        undo.append(("ungraft_child", d, s))
        d.children.append(s)
        s.parent = d
        T._update_levels(s)
    return undo


def revert_moves(T: Tree, undo_logs: list) -> None:
    """Revert a sequence of apply_move undo logs (most recent first is
    handled internally: pass logs in application order)."""
    for undo in reversed(undo_logs):
        for op in reversed(undo):
            kind = op[0]
            if kind == "ungraft_child":
                _, d, s = op
                d.children.remove(s)
                s.parent = None
            elif kind == "ungraft_split":
                _, ni, gp, i, d, s = op
                gp.children[i] = d
                d.parent = gp
                s.parent = None
                del T._all_nodes[ni.identifier]
                T._update_levels(d)
            elif kind == "unmerge":
                _, p, gp, i, c, c_old_mut, p_old_mut = op
                gp.children[i] = p
                c.parent = p
                c.mutations = c_old_mut
                p.mutations = p_old_mut
                T._all_nodes[p.identifier] = p
                T._update_levels(p)
            elif kind == "unmerge_full":
                (_, node, gp, i, child, old_mut, old_bl, old_ann,
                 node_old_mut) = op
                gp.children[i] = node
                child.parent = node
                child.mutations = old_mut
                child.branch_length = old_bl
                child.clade_annotations = old_ann
                node.mutations = node_old_mut
                T._all_nodes[node.identifier] = node
                T._update_levels(node)
            elif kind == "undelete":
                _, node, par, idx = op
                par.children.insert(idx, node)
                T._all_nodes[node.identifier] = node
            elif kind == "reattach_src":
                _, s, p, idx = op
                p.children.insert(idx, s)
                s.parent = p
                T._update_levels(s)
            else:  # pragma: no cover
                raise AssertionError(f"unknown undo op {kind}")

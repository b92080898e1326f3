"""matOptimize -E: equally-parsimonious-placement counts per branch.

Reference: the epps_on_branch_len branch of matOptimize main.cpp:438-504 —
for every node, search radius-bounded re-placements that tie the current
branch cost, merge sibling-equivalent placements (remove_sibling,
main.cpp:101-118), write the count into the branch-length field of the
output newick and dump the tied node lists to "epps_dump".

On device: the tie sets come from the same fused re-placement scorer the
SPR search uses (one device call per source chunk scoring ALL radius-bounded
destinations), instead of the reference's per-node bounded DFS.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import jax
import jax.numpy as jnp

from ..core.tree import Tree
from ..ops.placement import score_with_stp, valid_mask
from .fitch import FitchEngine
from .spr import MoveFinder, collapse_bonus


@functools.partial(jax.jit, static_argnames=("L",))
def _tie_matrix(st, stp, ref, active, g, oldcost,
                dfs_idx, level, anc_lo, anc_hi, anc_lvl,
                src_level, src_lo, src_hi, src_parent, radius, L: int):
    """[B, N] bool: valid radius-bounded destinations whose re-placement cost
    equals the source's current branch cost."""
    E = jnp.ones(g.shape, dtype=jnp.bool_)
    miss = jnp.zeros(g.shape, dtype=jnp.bool_)
    score, num_common, node_num_mut = score_with_stp(
        st, stp, ref, active, g, E, miss)
    valid, _ = valid_mask(
        score, num_common, node_num_mut,
        jnp.zeros(st.shape[0], jnp.bool_).at[0].set(True),
        jnp.zeros(st.shape[0], jnp.bool_), active)
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
    return valid & ok & (score == oldcost[:, None])


def count_epps(T: Tree, radius: int, dump_path: str = "epps_dump") -> None:
    """Set every node's branch_length to its EPP count and write the tied
    node lists.  Mutates T's branch lengths in place."""
    from ..core.flat import collect_positions
    positions, ref, chrom = collect_positions(T)
    engine = FitchEngine(T, positions)
    from .leafstore import SparseLeafStore
    leaf_store, ref_row = SparseLeafStore.from_tree(T, positions)
    states, masks = engine.run(leaf_store, ref_row)
    finder = MoveFinder(T, states, masks, ref_row, engine.bfs, engine.parent)
    bfs = finder.bfs
    n = finder.n
    if radius < 0:
        radius = 2 * int(finder.level.max())

    dump_f = open(dump_path, "w")
    for c0 in range(0, n - 1, finder.chunk):
        idxs = list(range(1 + c0, min(1 + c0 + finder.chunk, n)))
        B = len(idxs)
        Bp = finder.chunk
        g = np.zeros((Bp, finder.masks.shape[1]), dtype=np.uint8)
        oldcost = np.zeros(Bp, dtype=np.int32)
        paths = []
        for b, si in enumerate(idxs):
            g[b] = finder.masks[si]
            oldcost[b] = len(bfs[si].mutations) + collapse_bonus(bfs[si])
            path = []
            p = int(finder.parent[si])
            while True:
                path.append(p)
                if p == 0:
                    break
                p = int(finder.parent[p])
            paths.append(path)
        g[B:] = 0xF
        oldcost[B:] = -1
        maxL = max((len(p) for p in paths), default=1)
        L = -(-maxL // 8) * 8
        anc_lo = np.zeros((Bp, L), dtype=np.int32)
        anc_hi = np.zeros((Bp, L), dtype=np.int32)
        anc_lvl = np.full((Bp, L), -1, dtype=np.int32)
        src_level = np.zeros(Bp, dtype=np.int32)
        src_lo = np.zeros(Bp, dtype=np.int32)
        src_hi = np.full(Bp, n, dtype=np.int32)
        src_parent = np.zeros(Bp, dtype=np.int32)
        for b, si in enumerate(idxs):
            for l, a in enumerate(paths[b]):
                anc_lo[b, l] = finder.dfs_idx[a]
                anc_hi[b, l] = finder.dfs_end[a]
                anc_lvl[b, l] = finder.level[a]
            src_level[b] = finder.level[si]
            src_lo[b] = finder.dfs_idx[si]
            src_hi[b] = finder.dfs_end[si]
            src_parent[b] = finder.parent[si]
        ties = np.asarray(_tie_matrix(
            finder.st, finder.stp, finder.ref, finder.active,
            jnp.asarray(g), jnp.asarray(oldcost),
            finder.dfs_idx_dev, finder.level_dev,
            jnp.asarray(anc_lo), jnp.asarray(anc_hi), jnp.asarray(anc_lvl),
            jnp.asarray(src_level), jnp.asarray(src_lo),
            jnp.asarray(src_hi), jnp.asarray(src_parent),
            jnp.int32(radius), L))
        for b, si in enumerate(idxs):
            node = bfs[si]
            tied = [bfs[j] for j in np.nonzero(ties[b])[0]]
            # sibling-equivalence filtering (remove_sibling, main.cpp:101)
            members = [node] + tied
            filtered = {id(x): False for x in members}

            def _remove_sibling(x):
                par = x.parent
                if par is None:
                    return
                if id(par) in filtered:
                    filtered[id(par)] = True
                for ch in par.children:
                    if ch is not x and id(ch) in filtered:
                        filtered[id(ch)] = True

            _remove_sibling(node)
            for x in members:
                if not filtered[id(x)]:
                    _remove_sibling(x)
            kept = [x for x in members if not filtered[id(x)]]
            node.branch_length = float(max(1, len(kept)))
            if len(kept) > 1:
                others = ",".join(x.identifier for x in kept
                                  if x is not node)
                if others:
                    dump_f.write(f"{node.identifier}:{others}\n")
    if bfs:
        bfs[0].branch_length = 1.0
    dump_f.close()
    print(f"EPP counts written to branch lengths; ties dumped to "
          f"{dump_path}", file=sys.stderr)

"""Whole-tree Fitch-Sankoff over all segregating positions, vectorized.

The reference runs one task per position walking the pointer tree with SSE
child-count kernels (src/matOptimize/Fitch_Sankoff.cpp:91-215).  Here ALL
positions are vector lanes and the tree is walked level-synchronously with
gather / scatter-add over the BFS-flattened parent array; positions are
chunked to bound device memory.

Normalized-cost DP: with unit transition costs, a child's contribution to
its parent is min(score_j, min_score+1); subtracting each row's min keeps
every stored score in {0,1} (the dropped offsets are per-row constants that
cannot change argmins or ties), so the whole DP state is uint8 regardless of
tree size.  Because a node's children all sit exactly one level below it,
each parent row is accumulated in one level pass (int32 scatter-add into a
compact unique-parents buffer, so polytomies of any width are safe), then
clipped and renormalized immediately.

Outputs per (node, position): the chosen state (forward pass, parent-
following tie-break exactly as reference set_state_from_cnt:54-87 /
usher_mapper.cpp:113-141) and the major-allele mask (the backward-pass
argmin set), which is the subtree's Fitch set used for SPR move scoring.
"""

from __future__ import annotations

import functools

import numpy as np

from ..parallel.distributed import fetch as _fetch
import jax
import jax.numpy as jnp

from ..core.tree import Mutation, Tree


def flatten_bfs(T: Tree):
    """BFS arrays: (bfs nodes, parent idx int32, is_leaf bool, levels) where
    levels is a list of int32 index arrays per tree level (ascending)."""
    bfs = T.breadth_first_expansion()
    n = len(bfs)
    idx = {id(node): i for i, node in enumerate(bfs)}
    parent = np.zeros(n, dtype=np.int32)
    is_leaf = np.zeros(n, dtype=bool)
    levels: dict[int, list[int]] = {}
    for i, node in enumerate(bfs):
        parent[i] = idx[id(node.parent)] if node.parent is not None else 0
        is_leaf[i] = node.is_leaf()
        levels.setdefault(node.level, []).append(i)
    keys = sorted(levels)
    level_arrays = [np.asarray(levels[k], dtype=np.int32) for k in keys]
    return bfs, parent, is_leaf, level_arrays


def leaf_masks_from_tree(T: Tree, positions: np.ndarray, bfs=None):
    """Reconstruct every leaf's genotype mask by root->leaf mutation
    accumulation over the segregating positions (the Original_State_t of the
    reference, check_samples.cpp:35-41).  Returns [n_bfs, P] uint8 with
    nonzero rows only at leaves; internal rows hold the recorded path state
    (useful as an FS warm reference)."""
    if bfs is None:
        bfs = T.breadth_first_expansion()
    pos_index = {int(p): i for i, p in enumerate(positions)}
    P = len(positions)
    n = len(bfs)
    idx = {id(node): i for i, node in enumerate(bfs)}
    ref_row = np.zeros(P, dtype=np.uint8)
    # reference alleles from recorded ref_nuc
    for node in bfs:
        for m in node.mutations:
            if m.position in pos_index:
                ref_row[pos_index[m.position]] = m.ref_nuc
    state = np.zeros((n, P), dtype=np.uint8)
    for i, node in enumerate(bfs):
        row = state[idx[id(node.parent)]] if node.parent is not None else ref_row
        if node.mutations:
            row = row.copy()
            for m in node.mutations:
                j = pos_index.get(m.position)
                if j is not None:
                    row[j] = m.mut_nuc
        state[i] = row
    return state, ref_row


@functools.partial(jax.jit, static_argnames=("n_levels", "max_u"))
def _fs_chunk(leaf_mask, is_leaf, parent_slot_pad, level_pad, level_len,
              uparent_pad, uparent_len, parent, ref_nt,
              n_levels: int, max_u: int):
    """One position-chunk of the normalized-cost Fitch-Sankoff DP.

    leaf_mask [N,S] uint8; level_pad [L,maxlen] int32 (padded with 0 and
    masked by level_len); uparent_pad [L,maxU]: the unique parent rows per
    level; parent_slot_pad [L,maxlen]: each level entry's parent's slot in
    that level's unique-parent list.
    Returns (states [N,S] int32, masks [N,S] uint8); scores are normalized,
    so a node's score row is 0 at its subtree-optimal (Fitch-set) states.
    """
    N, S = leaf_mask.shape
    k = jnp.arange(4, dtype=jnp.uint8)
    in_mask = ((leaf_mask[:, :, None] >> k[None, None, :]) & 1).astype(jnp.bool_)
    leaf_scores = jnp.where(in_mask, jnp.uint8(0), jnp.uint8(1))
    scores = jnp.where(is_leaf[:, None, None], leaf_scores, jnp.uint8(0))

    # backward (leaf -> root), level by level, deepest first
    for li in range(n_levels - 1, 0, -1):
        lev = level_pad[li]
        lmask = (jnp.arange(lev.shape[0]) < level_len[li])
        # normalized child rows are already the contributions (0/1)
        contrib = scores[lev].astype(jnp.int32)              # [L,S,4]
        slot = jnp.where(lmask, parent_slot_pad[li], max_u)
        acc = jnp.zeros((max_u, S, 4), dtype=jnp.int32)
        acc = acc.at[slot].add(contrib, mode="drop")
        acc_min = jnp.min(acc, axis=-1, keepdims=True)
        rows_new = jnp.minimum(acc - acc_min, 1).astype(jnp.uint8)
        up = uparent_pad[li]
        umask = (jnp.arange(up.shape[0]) < uparent_len[li])
        prev = scores[up]
        rows_new = jnp.where(umask[:, None, None], rows_new, prev)
        scores = scores.at[up].set(rows_new, mode="drop")

    masks_bits = (scores == 0)
    masks = (masks_bits.astype(jnp.uint8)
             * (jnp.uint8(1) << k[None, None, :])).sum(-1, dtype=jnp.uint8)

    # forward (root -> leaf): normalized rows have min 0
    def pick(sc, par_state):
        first = jnp.argmin(sc, axis=-1).astype(jnp.int32)
        par_sc = jnp.take_along_axis(sc, par_state[..., None], axis=-1)[..., 0]
        return jnp.where(par_sc == 0, par_state, first)

    states = jnp.zeros((N, S), dtype=jnp.int32)
    states = states.at[0].set(pick(scores[0], ref_nt))
    for li in range(1, n_levels):
        lev = level_pad[li]
        lmask = (jnp.arange(lev.shape[0]) < level_len[li])
        ps = states[parent[lev]]
        new = pick(scores[lev], ps)
        states = states.at[jnp.where(lmask, lev, N)].set(new, mode="drop")
    return states, masks


_BACK_K = 1 << 12  # parsimony weight; back-mutation counts stay below this


@functools.partial(jax.jit, static_argnames=("n_levels", "max_u"))
def _min_back_chunk(leaf_mask, is_leaf, parent_slot_pad, level_pad, level_len,
                    uparent_pad, uparent_len, parent, ref_nt,
                    n_levels: int, max_u: int):
    """Min-back-mutation Fitch-Sankoff: lexicographically minimize
    (parsimony, #back-mutations) -- a mutation a->b is "back" when b is the
    reference base (reference src/usher-sampled/Min_back_FS.cpp:55-192, a
    4x4 DP per node per position).

    Weighted-cost DP: edge cost(a->b) = 0 if a==b else K + (b==ref), K large.
    Scores are normalized per row (offsets are row constants) and clipped to
    2K+3: transitions add at most K+1, so any value above that bound can
    never win or tie a comparison (including the forward pass's
    score+cost sums), keeping the DP exact.
    """
    N, S = leaf_mask.shape
    K = jnp.int32(_BACK_K)
    k = jnp.arange(4, dtype=jnp.uint8)
    in_mask = ((leaf_mask[:, :, None] >> k[None, None, :]) & 1).astype(jnp.bool_)
    big = 2 * K + 3
    leaf_scores = jnp.where(in_mask, jnp.int32(0), big)
    scores = jnp.where(is_leaf[:, None, None], leaf_scores, jnp.int32(0))

    # cost[a, b] per position: 0 if a==b else K + (b == ref)
    a_idx = jnp.arange(4)[:, None]
    b_idx = jnp.arange(4)[None, :]
    # [S, 4(a), 4(b)]
    cost = jnp.where(a_idx[None] == b_idx[None], 0,
                     K + (b_idx[None] == ref_nt[:, None, None]).astype(jnp.int32))

    def contrib_of(child_rows):
        # child_rows [L,S,4(b)] -> contribution [L,S,4(a)]
        tot = child_rows[:, :, None, :] + cost[None]         # [L,S,a,b]
        return jnp.min(tot, axis=-1)

    for li in range(n_levels - 1, 0, -1):
        lev = level_pad[li]
        lmask = (jnp.arange(lev.shape[0]) < level_len[li])
        contrib = contrib_of(scores[lev])
        contrib = jnp.where(lmask[:, None, None], contrib, 0)
        slot = jnp.where(lmask, parent_slot_pad[li], max_u)
        acc = jnp.zeros((max_u, S, 4), dtype=jnp.int32)
        acc = acc.at[slot].add(contrib, mode="drop")
        acc_min = jnp.min(acc, axis=-1, keepdims=True)
        rows_new = jnp.minimum(acc - acc_min, big)
        up = uparent_pad[li]
        umask = (jnp.arange(up.shape[0]) < uparent_len[li])
        prev = scores[up]
        rows_new = jnp.where(umask[:, None, None], rows_new, prev)
        scores = scores.at[up].set(rows_new, mode="drop")

    # forward: child picks argmin_b(score[b] + cost(par->b)), parent-
    # following on ties
    def pick(sc, par_state):
        c_par = cost[jnp.arange(S)[None, :], par_state]      # [L,S,4]
        tot = sc + c_par
        mn = jnp.min(tot, axis=-1)
        first = jnp.argmin(tot, axis=-1).astype(jnp.int32)
        par_tot = jnp.take_along_axis(tot, par_state[..., None], axis=-1)[..., 0]
        return jnp.where(par_tot == mn, par_state, first)

    states = jnp.zeros((N, S), dtype=jnp.int32)
    # root: prefer ref when tied for min
    root_sc = scores[0]
    root_min = jnp.min(root_sc, axis=-1)
    ref_sc = jnp.take_along_axis(root_sc, ref_nt[:, None], axis=-1)[:, 0]
    root_pick = jnp.where(ref_sc == root_min, ref_nt,
                          jnp.argmin(root_sc, axis=-1).astype(jnp.int32))
    states = states.at[0].set(root_pick)
    for li in range(1, n_levels):
        lev = level_pad[li]
        lmask = (jnp.arange(lev.shape[0]) < level_len[li])
        ps = states[parent[lev]]
        new = pick(scores[lev], ps)
        states = states.at[jnp.where(lmask, lev, N)].set(new, mode="drop")
    masks_bits = (scores == 0)
    masks = (masks_bits.astype(jnp.uint8)
             * (jnp.uint8(1) << k[None, None, :])).sum(-1, dtype=jnp.uint8)
    return states, masks


class FitchEngine:
    """Caches the flattened topology + padded level arrays for repeated FS
    passes over the same tree snapshot."""

    def __init__(self, T: Tree, positions: np.ndarray, chunk: int = 512,
                 mesh=None):
        """mesh: optional 1-D jax Mesh -- shards the position axis of each
        DP chunk across devices (the device-mesh analog of the reference's
        MPI position sharding, src/usher-sampled/utils.cpp:113-481)."""
        self.T = T
        self.positions = positions
        self.bfs, self.parent, self.is_leaf, self.levels = flatten_bfs(T)
        self.n = len(self.bfs)
        self.mesh = mesh
        # with a mesh, each device works a `chunk`-wide position slice
        self.chunk = int(chunk) * (mesh.size if mesh is not None else 1)

        maxlen = max(len(a) for a in self.levels)
        # bucket the jit-static dims (level count, unique-parent width) so
        # tree surgery between iterations doesn't retrigger compilation:
        # extra levels have level_len == 0 and are exact no-ops in the DP
        L_real = len(self.levels)
        L = -(-L_real // 8) * 8
        uparents = []
        for a in self.levels:
            uparents.append(np.unique(self.parent[a]))
        max_u_real = max((len(u) for u in uparents[1:]), default=1) or 1
        self.max_u = 1 << (max_u_real - 1).bit_length() if max_u_real > 1 else 1
        self.n_levels = L
        self.level_pad = np.zeros((L, maxlen), dtype=np.int32)
        self.level_len = np.zeros(L, dtype=np.int32)
        self.uparent_pad = np.zeros((L, self.max_u), dtype=np.int32)
        self.uparent_len = np.zeros(L, dtype=np.int32)
        self.parent_slot_pad = np.zeros((L, maxlen), dtype=np.int32)
        for i, a in enumerate(self.levels):
            self.level_pad[i, :len(a)] = a
            self.level_len[i] = len(a)
            up = uparents[i]
            self.uparent_pad[i, :len(up)] = up
            self.uparent_len[i] = len(up)
            if i > 0:
                self.parent_slot_pad[i, :len(a)] = np.searchsorted(
                    up, self.parent[a])

    def run(self, leaf_masks, ref_row: np.ndarray,
            min_back: bool = False):
        """leaf_masks: [n,P] uint8 (rows meaningful at leaves) OR a
        SparseLeafStore (optimize/leafstore.py) materialized per chunk —
        the pandemic-scale path that never holds the dense matrix.
        ref_row [P].  min_back selects the (parsimony, #back-mutations)
        lexicographic DP (reference Min_back_FS.cpp).
        Returns (states [n,P] int8 0..3, masks [n,P] uint8)."""
        store = None
        if not isinstance(leaf_masks, np.ndarray):
            store = leaf_masks
        P = len(ref_row)
        ref_nt = np.zeros(P, dtype=np.int32)
        nz = ref_row > 0
        ref_nt[nz] = np.log2(ref_row[nz]).astype(np.int32)
        states = np.empty((self.n, P), dtype=np.int8)
        masks = np.empty((self.n, P), dtype=np.uint8)
        if self.mesh is not None:
            from ..parallel.shard import put_batch, put_replicated
            rep = lambda a: put_replicated(self.mesh, jnp.asarray(a))  # noqa: E731
        else:
            rep = jnp.asarray
        parent_dev = rep(self.parent)
        is_leaf_dev = rep(self.is_leaf)
        lp = rep(self.level_pad)
        ll = rep(self.level_len)
        up = rep(self.uparent_pad)
        ul = rep(self.uparent_len)
        psl = rep(self.parent_slot_pad)
        for c0 in range(0, P, self.chunk):
            c1 = min(c0 + self.chunk, P)
            if store is not None:
                lm = store.materialize(self.bfs, self.is_leaf, c0, c1)
            else:
                lm = leaf_masks[:, c0:c1]
            rn = ref_nt[c0:c1]
            pad = self.chunk - (c1 - c0)
            if pad:
                lm = np.pad(lm, ((0, 0), (0, pad)), constant_values=0xF)
                rn = np.pad(rn, (0, pad))
            if self.mesh is not None:
                # positions shard over the mesh: each device solves its
                # own position slice of the DP, no collectives
                lm_dev = put_batch(self.mesh, lm, 1)
                rn_dev = put_batch(self.mesh, rn, 0)
            else:
                lm_dev, rn_dev = jnp.asarray(lm), jnp.asarray(rn)
            fn = _min_back_chunk if min_back else _fs_chunk
            st, mk = fn(lm_dev, is_leaf_dev, psl,
                        lp, ll, up, ul, parent_dev, rn_dev,
                        n_levels=self.n_levels, max_u=self.max_u)
            states[:, c0:c1] = _fetch(st).astype(np.int8)[:, :c1 - c0]
            masks[:, c0:c1] = _fetch(mk)[:, :c1 - c0]
        return states, masks

    def run_rewrite_streamed(self, store, ref_row: np.ndarray, chrom: str,
                             min_back: bool = False):
        """Fused streamed pass: per position chunk, solve the DP, rewrite
        that chunk's branch mutations, and record the Fitch-mask deviations
        from ref — WITHOUT ever retaining the [n, P] states/masks matrices.
        The pandemic-scale optimizer path (each iteration re-runs this full
        pass instead of the local patch, the discipline of the reference's
        MPI FS rounds, utils.cpp:113-481).

        Returns (parsimony_score, MaskDeviations)."""
        P = len(ref_row)
        ref_nt = np.zeros(P, dtype=np.int32)
        nz = ref_row > 0
        ref_nt[nz] = np.log2(ref_row[nz]).astype(np.int32)
        if self.mesh is not None:
            from ..parallel.shard import put_batch, put_replicated
            rep = lambda a: put_replicated(self.mesh, jnp.asarray(a))  # noqa: E731
        else:
            rep = jnp.asarray
        parent_dev = rep(self.parent)
        is_leaf_dev = rep(self.is_leaf)
        lp = rep(self.level_pad)
        ll = rep(self.level_len)
        up = rep(self.uparent_pad)
        ul = rep(self.uparent_len)
        psl = rep(self.parent_slot_pad)
        devs = MaskDeviations(self.n)
        per_node: list[list] = [[] for _ in range(self.n)]
        total = 0
        trip_node, trip_col, trip_par, trip_mut = [], [], [], []
        for c0 in range(0, P, self.chunk):
            c1 = min(c0 + self.chunk, P)
            lm = store.materialize(self.bfs, self.is_leaf, c0, c1)
            rn = ref_nt[c0:c1]
            pad = self.chunk - (c1 - c0)
            lm_p, rn_p = lm, rn
            if pad:
                lm_p = np.pad(lm, ((0, 0), (0, pad)), constant_values=0xF)
                rn_p = np.pad(rn, (0, pad))
            if self.mesh is not None:
                lm_dev = put_batch(self.mesh, lm_p, 1)
                rn_dev = put_batch(self.mesh, rn_p, 0)
            else:
                lm_dev, rn_dev = jnp.asarray(lm_p), jnp.asarray(rn_p)
            fn = _min_back_chunk if min_back else _fs_chunk
            st, mk = fn(lm_dev, is_leaf_dev, psl,
                        lp, ll, up, ul, parent_dev, rn_dev,
                        n_levels=self.n_levels, max_u=self.max_u)
            st_h = _fetch(st).astype(np.int8)[:, :c1 - c0]
            mk_h = _fetch(mk)[:, :c1 - c0]
            devs.set_chunk(c0, mk_h, ref_row[c0:c1])
            ni, si, pv, mv = self._mutation_arrays(st_h, lm, ref_row[c0:c1])
            trip_node.append(ni)
            trip_col.append(si + c0)
            trip_par.append(pv)
            trip_mut.append(mv)
            chunk_nodes, chunk_total = self._mutation_lists(
                st_h, lm, ref_row[c0:c1], self.positions[c0:c1], chrom)
            total += chunk_total
            for i, muts in enumerate(chunk_nodes):
                if muts:
                    per_node[i].extend(muts)
        for i, node in enumerate(self.bfs):
            node.mutations = per_node[i]
        # array form of the whole-tree mutation set, so the SPR finder can
        # build its CSR snapshot without a per-mutation Python from_tree
        devs.csr_triplets = (
            np.concatenate(trip_node) if trip_node else np.zeros(0, np.int64),
            np.concatenate(trip_col) if trip_col else np.zeros(0, np.int64),
            np.concatenate(trip_par) if trip_par else np.zeros(0, np.uint8),
            np.concatenate(trip_mut) if trip_mut else np.zeros(0, np.uint8))
        return total, devs

    def _mutation_arrays(self, states, leaf_masks, ref_row):
        """Vectorized branch-mutation extraction from FS states: returns
        (node_idx i64, site_idx i64, par_nib u8, mut_nib u8) over the given
        position axis — the array form BigMAT consumes directly (no
        per-mutation Python)."""
        par_states = states[self.parent]
        par_states[0] = np.where(
            ref_row > 0, np.log2(np.maximum(ref_row, 1)).astype(np.int8), 0)
        leaf_arr = self.is_leaf
        par_nib = (1 << par_states.astype(np.int32)).astype(np.uint8)
        self_nib = (1 << states.astype(np.int32)).astype(np.uint8)
        internal_mut = (~leaf_arr[:, None]) & (self_nib != par_nib)
        leaf_mut = leaf_arr[:, None] & ((leaf_masks & par_nib) == 0)
        node_idx, site_idx = np.nonzero(internal_mut | leaf_mut)
        mut_v = np.where(leaf_arr[node_idx],
                         leaf_masks[node_idx, site_idx],
                         self_nib[node_idx, site_idx])
        keep = mut_v != 0
        return (node_idx[keep], site_idx[keep],
                par_nib[node_idx, site_idx][keep], mut_v[keep])

    def _mutation_lists(self, states, leaf_masks, ref_row, positions, chrom):
        """Per-node mutation lists implied by FS states over the given
        position axis (width of states/leaf_masks/ref_row).  Returns
        (per_node lists, total count)."""
        n = self.n
        node_idx, site_idx, par_v, mut_v = self._mutation_arrays(
            states, leaf_masks, ref_row)
        pos_v = np.asarray(positions)[site_idx]
        ref_v = ref_row[site_idx]
        per_node: list[list[Mutation]] = [[] for _ in range(n)]
        for ni, pos, r, pn, mn in zip(node_idx.tolist(), pos_v.tolist(),
                                      ref_v.tolist(), par_v.tolist(),
                                      mut_v.tolist()):
            per_node[ni].append(Mutation(chrom=chrom, position=pos,
                                         ref_nuc=r, par_nuc=pn, mut_nuc=mn))
        return per_node, len(node_idx)

    def patch_mutations(self, states: np.ndarray, leaf_masks: np.ndarray,
                        ref_row: np.ndarray, chrom: str,
                        col_positions) -> int:
        """Restricted rewrite: replace branch mutations ONLY at the given
        genome positions (the local FS patch-up of reference apply_move/
        backward_pass.cpp — topology changes only perturb states at
        positions mutated on the touched subtrees/paths).  The arrays here
        are restricted to those columns.  Returns the parsimony DELTA
        (#added - #removed) over the patched positions."""
        positions = np.asarray(col_positions)
        per_node, added = self._mutation_lists(states, leaf_masks, ref_row,
                                               positions, chrom)
        pos_set = {int(p) for p in positions}
        removed = 0
        for i, node in enumerate(self.bfs):
            old = node.mutations
            if not old and not per_node[i]:
                continue
            kept = [m for m in old if m.position not in pos_set]
            removed += len(old) - len(kept)
            if per_node[i]:
                merged = kept + per_node[i]
                merged.sort(key=lambda m: m.position)
                node.mutations = merged
            else:
                node.mutations = kept
        return added - removed

    def rewrite_mutations(self, states: np.ndarray, leaf_masks,
                          ref_row: np.ndarray, chrom: str) -> int:
        """Replace every node's branch mutations from the FS states.

        Internal nodes take single FS states; leaves keep their full original
        genotype mask as mut_nuc when the parent state is outside it
        (ambiguity-preserving, so genotype reconstruction stays exact).
        leaf_masks may be a dense [n, P] array or a SparseLeafStore
        (materialized per column chunk).  Returns the new total parsimony
        score."""
        if isinstance(leaf_masks, np.ndarray):
            per_node, total = self._mutation_lists(
                states, leaf_masks, ref_row, self.positions, chrom)
        else:
            store = leaf_masks
            P = len(ref_row)
            per_node = [[] for _ in range(self.n)]
            total = 0
            for c0 in range(0, P, self.chunk):
                c1 = min(c0 + self.chunk, P)
                lm = store.materialize(self.bfs, self.is_leaf, c0, c1)
                chunk_nodes, chunk_total = self._mutation_lists(
                    states[:, c0:c1], lm, ref_row[c0:c1],
                    self.positions[c0:c1], chrom)
                total += chunk_total
                for i, muts in enumerate(chunk_nodes):
                    if muts:
                        per_node[i].extend(muts)
        for i, node in enumerate(self.bfs):
            node.mutations = per_node[i]
        return total


class MaskDeviations:
    """Per-node sparse deviations of the FS Fitch masks from the reference
    row: CSR (row_ptr, cols, vals).  The streamed-states optimizer path
    (optimize/driver.py stream_states) keeps ONLY this instead of the dense
    [n, P] states/masks matrices; BigMoveFinder consumes it directly."""

    def __init__(self, n: int):
        self._rows: list = [None] * n
        self.n = n

    def set_chunk(self, c0: int, mk_chunk: np.ndarray,
                  ref_chunk: np.ndarray) -> None:
        rows, cols = np.nonzero(mk_chunk != ref_chunk[None, :])
        vals = mk_chunk[rows, cols]
        cols = cols + c0
        if len(rows) == 0:
            return
        # group by row (rows come sorted from nonzero)
        starts = np.searchsorted(rows, np.arange(self.n + 1))
        for i in range(self.n):
            lo, hi = starts[i], starts[i + 1]
            if hi > lo:
                prev = self._rows[i]
                if prev is None:
                    self._rows[i] = (cols[lo:hi].copy(), vals[lo:hi].copy())
                else:
                    self._rows[i] = (np.concatenate([prev[0], cols[lo:hi]]),
                                     np.concatenate([prev[1], vals[lo:hi]]))

    def deviations(self, i: int):
        """(cols int64[], mask values uint8[]) for node i; chunks were
        appended in ascending column order so cols are sorted."""
        entry = self._rows[i]
        if entry is None:
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint8))
        return entry

    def remap_patch(self, src_rows, cols_arr, mk_sub: np.ndarray,
                    ref_sub: np.ndarray) -> "MaskDeviations":
        """Incremental update after a local FS patch: new node order
        `src_rows` (new row i copies old row src_rows[i]), with deviations
        at `cols_arr` REPLACED from the freshly solved mk_sub [n, |cols|].
        Every column where a new/changed node's mask can differ from its
        copy source is in cols_arr (the affected-position set), so rows are
        exact (same argument as the dense engine's states/masks remap,
        optimize/driver.py)."""
        n = len(src_rows)
        out = MaskDeviations(n)
        colset = np.asarray(cols_arr, dtype=np.int64)
        empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint8))
        for i in range(n):
            j = int(src_rows[i])
            cols, vals = (self._rows[j] or empty) if 0 <= j < self.n \
                else empty
            if len(cols) and len(colset):
                take = np.searchsorted(colset, cols)
                inpatch = (take < len(colset)) & \
                    (colset[np.minimum(take, len(colset) - 1)] == cols)
                cols, vals = cols[~inpatch], vals[~inpatch]
            dev = np.nonzero(mk_sub[i] != ref_sub)[0] if len(colset) \
                else np.empty(0, dtype=np.int64)
            if len(dev):
                cols = np.concatenate([cols, colset[dev]])
                vals = np.concatenate([vals, mk_sub[i][dev]])
                o = np.argsort(cols, kind="stable")
                cols, vals = cols[o], vals[o]
            if len(cols):
                out._rows[i] = (cols, vals)
        return out

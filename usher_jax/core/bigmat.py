"""Pandemic-scale MAT: CSR mutation lists + on-demand column materialization.

The dense FlatMAT ([cap, P] path states) cannot hold the reference's target
tree (>2M leaves x ~30k segregating sites ~ 150 GB).  BigMAT stores what the
reference's compact MAT stores (8-byte packed mutations,
/root/reference/src/matOptimize/mutation_annotated_tree.hpp:105-240) as
struct-of-arrays: parent pointers + CSR per-node mutation lists, O(N + M)
memory (~tens of MB at full scale).

Placement scoring needs per-(node, entry-position) path states only at the
batch's entry columns.  These are materialized ON DEVICE by pointer-doubling
over precomputed 2^k-ancestor tables (log2(depth) gathers of [N, C]), then
scored by the same sparse scorer as the dense engine (ops/placement_sparse).
The no-entry aggregate terms (base / nc_base / node_num_mut) are exact
host-side precomputes over the CSR arrays, refreshed per tree epoch:

  base[n]  = sum over n's root-path positions of the no-entry score term
           = F[n] + sum_{m in M(n)} [matched ? 0 : (par!=ref) - (mut!=ref)]
  F[n]     = F[parent] + sum_{m in M(n)} [(mut!=ref) - (par!=ref)]

(level-synchronous vectorized sweep; derivation in ops/placement_sparse.py).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import placement_sparse as pp


@jax.jit
def _dead_bit_sync(meta, idx):
    """OR the dead bit into the resident CSC meta32 at idx (duplicate
    indices fine: .set is idempotent here)."""
    return meta.at[idx].set(meta[idx] | (1 << 10))


class BigMAT:
    """Flat CSR MAT over node slots 0..N-1.

    parent    int32[N]   parent slot (root -> itself); ANY order allowed
    mut_ptr   int64[N+1] CSR row pointers into the mutation arrays
    mut_col   int32[M]   column index (into positions) per mutation
    mut_par   uint8[M]   parent-state nibble
    mut_mut   uint8[M]   mutated-state nibble (nonzero; != mut_par)
    positions int64[P]   genome coordinates (sorted)
    ref       uint8[P]   reference allele nibble per position

    INVARIANT: mutation chains must be consistent — every mutation's
    mut_par equals the path state immediately above it (what the reference
    maintains everywhere and our FS rewrite guarantees).  The base/base_spr
    aggregates telescope per-position deltas along root paths; on an
    inconsistent tree they diverge from the materialized path states and
    scores are silently wrong.  Trees straight from external sources should
    be FS-canonicalized first (FitchEngine.rewrite_mutations).
    """

    _ranks_dirty = False

    @property
    def bfs_rank(self):
        """Exact BFS tie-break ranks; recomputed lazily after incremental
        appends (the full vectorized sweep is the dominant per-flush cost
        at pandemic scale, and most flush consumers never read ranks)."""
        if self._ranks_dirty:
            self._recompute_ranks()
        return self._bfs_rank

    @bfs_rank.setter
    def bfs_rank(self, v):
        self._bfs_rank = v
        self._ranks_dirty = False

    def __init__(self, parent, mut_ptr, mut_col, mut_par, mut_mut,
                 positions, ref, num_leaves=None, bfs_rank=None):
        self.parent = np.asarray(parent, dtype=np.int32)
        self.mut_ptr = np.asarray(mut_ptr, dtype=np.int64)
        self.mut_col = np.asarray(mut_col, dtype=np.int32)
        self.mut_par = np.asarray(mut_par, dtype=np.uint8)
        self.mut_mut = np.asarray(mut_mut, dtype=np.uint8)
        self.positions = np.asarray(positions, dtype=np.int64)
        self.ref = np.asarray(ref, dtype=np.uint8)
        self.N = len(self.parent)
        self.P = len(self.positions)
        self.pos_index = {int(p): i for i, p in enumerate(self.positions)}
        # incremental-append state (queue_* / _flush)
        self._pending: list = []
        self._appended = 0
        self.csc_dead = None     # lazily allocated bool over csc rows
        self._ov = None          # overlay mutations: (node, col, par, mut,
        #                          dead) column-sorted numpy arrays
        self._cols_stale = False  # legacy column path unusable after appends
        self.mesh = None         # optional 1-D jax Mesh: shard the sample /
        #                          source batch axis, replicate the CSR meta
        #                          (ops/interval.py shard_map composition)
        self._precompute(num_leaves, bfs_rank)

    # --- construction -------------------------------------------------------

    @classmethod
    def from_tree(cls, T, positions, ref):
        """Build from a host Tree (core/tree.py); node slots are BFS order so
        bfs_rank == slot, giving exact reference tie-break keys."""
        bfs = T.breadth_first_expansion()
        slot_of = {id(n): i for i, n in enumerate(bfs)}
        pos_index = {int(p): i for i, p in enumerate(positions)}
        N = len(bfs)
        parent = np.zeros(N, dtype=np.int32)
        counts = np.zeros(N + 1, dtype=np.int64)
        for i, n in enumerate(bfs):
            parent[i] = slot_of[id(n.parent)] if n.parent is not None else i
            counts[i + 1] = sum(1 for m in n.mutations if m.position >= 0)
        mut_ptr = np.cumsum(counts)
        M = int(mut_ptr[-1])
        mut_col = np.zeros(M, dtype=np.int32)
        mut_par = np.zeros(M, dtype=np.uint8)
        mut_mut = np.zeros(M, dtype=np.uint8)
        k = 0
        for n in bfs:
            for m in n.mutations:
                if m.position < 0:
                    continue
                mut_col[k] = pos_index[m.position]
                mut_par[k] = m.par_nuc
                mut_mut[k] = m.mut_nuc
                k += 1
        big = cls(parent, mut_ptr, mut_col, mut_par, mut_mut, positions, ref)
        big._nodes = bfs  # slot -> host node, for result interpretation
        return big

    # --- epoch precomputes --------------------------------------------------

    def _precompute(self, num_leaves=None, bfs_rank=None):
        N, parent = self.N, self.parent
        root_mask = parent == np.arange(N, dtype=np.int32)
        level = self._levels()
        self.level = level
        self.max_depth = int(level.max()) + 1

        # 2^k ancestor tables
        n_anc = 1
        while (1 << n_anc) < self.max_depth:
            n_anc += 1
        anc = np.zeros((n_anc, N), dtype=np.int32)
        anc[0] = parent
        for k in range(1, n_anc):
            anc[k] = anc[k - 1][anc[k - 1]]
        self.anc = anc
        self.n_anc = n_anc

        # per-mutation terms
        refm = self.ref[self.mut_col].astype(np.int32)
        mi = self.mut_mut.astype(np.int32)
        pi = self.mut_par.astype(np.int32)
        eff = mi != pi
        matched = (refm & mi) != 0
        f_delta_m = np.where(eff, (mi != refm).astype(np.int32)
                             - (pi != refm).astype(np.int32), 0)
        own_corr_m = np.where(eff & ~matched,
                              (pi != refm).astype(np.int32)
                              - (mi != refm).astype(np.int32), 0)
        nc_base_m = (eff & matched).astype(np.int32)

        mut_node = np.repeat(np.arange(N),
                             np.diff(self.mut_ptr).astype(np.int64))
        # the root's mutations are path state, not branch mutations (the
        # scorer forces stp[root] = st[root]; mapper counts node_num_mut only
        # when parent exists, usher_mapper.cpp:186) -- they contribute to F
        # (inherited term) but not to the intro/own aggregates
        root_mut = root_mask[mut_node]
        own_corr_m = np.where(root_mut, 0, own_corr_m)
        nc_base_m = np.where(root_mut, 0, nc_base_m)
        eff_branch = eff & ~root_mut
        f_delta = np.bincount(mut_node, weights=f_delta_m,
                              minlength=N).astype(np.int64)
        own_corr = np.bincount(mut_node, weights=own_corr_m,
                               minlength=N).astype(np.int64)
        self.nc_base = np.bincount(mut_node, weights=nc_base_m,
                                   minlength=N).astype(np.int32)
        self.node_num_mut = np.bincount(
            mut_node, weights=eff_branch.astype(np.int64),
            minlength=N).astype(np.int32)

        # level-synchronous prefix: F[n] = F[parent] + f_delta[n]
        F = np.zeros(N, dtype=np.int64)
        order = np.argsort(level, kind="stable")
        lvl_sorted = level[order]
        bounds = np.searchsorted(lvl_sorted, np.arange(self.max_depth + 1))
        for li in range(self.max_depth):
            idx = order[bounds[li]:bounds[li + 1]]
            if li == 0:
                F[idx] = f_delta[idx]
            else:
                F[idx] = F[parent[idx]] + f_delta[idx]
        self.F = F  # kept: incremental appends chain F[new] = F[parent] + ...
        self.base = (F + own_corr).astype(np.int32)

        # leaf / tie-break metadata
        child_count = np.bincount(parent[~root_mask], minlength=N)
        self.is_leaf = child_count == 0
        self.is_root_mask = root_mask
        self.root_slot = int(np.nonzero(root_mask)[0][0])
        if num_leaves is None:
            nl = self.is_leaf.astype(np.int64).copy()
            for li in range(self.max_depth - 1, 0, -1):
                idx = order[bounds[li]:bounds[li + 1]]
                np.add.at(nl, parent[idx], nl[idx])
            num_leaves = nl
        self.num_leaves = np.asarray(num_leaves, dtype=np.int32)
        self.bfs_rank = (np.arange(N, dtype=np.int32) if bfs_rank is None
                         else np.asarray(bfs_rank, dtype=np.int32))
        self.active = np.ones(N, dtype=bool)

        # inverted mutation index (CSC by column) for on-demand columns
        csc_order = np.argsort(self.mut_col, kind="stable")
        self._csc_order = csc_order
        self.csc_node = mut_node[csc_order].astype(np.int32)
        self.csc_mut = self.mut_mut[csc_order]
        self.csc_par = self.mut_par[csc_order]
        self.csc_eff = eff[csc_order]
        self.csc_root = root_mut[csc_order]
        self.csc_ptr = np.searchsorted(self.mut_col[csc_order],
                                       np.arange(self.P + 1))

        # DFS numbering (vectorized, no per-node Python):
        #   subtree sizes by reverse-level accumulation, then
        #   dfs_idx[n] = dfs_idx[parent] + 1 + (earlier siblings' sizes)
        # level-synchronously.  Subtrees are the contiguous DFS ranges the
        # interval scoring engine (ops/interval.py) range-adds over.
        sz = np.ones(N, dtype=np.int64)
        for li in range(self.max_depth - 1, 0, -1):
            idx = order[bounds[li]:bounds[li + 1]]
            np.add.at(sz, parent[idx], sz[idx])
        nr = np.nonzero(~root_mask)[0]
        ch_order = nr[np.argsort(parent[nr], kind="stable")]
        sizes = sz[ch_order]
        cs = np.cumsum(sizes)
        excl = cs - sizes
        if len(ch_order):
            seg = parent[ch_order]
            starts = np.r_[True, seg[1:] != seg[:-1]]
            seg_idx = np.cumsum(starts) - 1
            pre_sib_o = excl - excl[starts][seg_idx]
            pos_in_seg = np.arange(len(ch_order), dtype=np.int64)
            pos_in_seg -= pos_in_seg[starts][seg_idx]
        else:
            pre_sib_o = excl
            pos_in_seg = np.zeros(0, dtype=np.int64)
        pre_sib = np.zeros(N, dtype=np.int64)
        pre_sib[ch_order] = pre_sib_o
        # child-order keys for incremental BFS-rank recomputation (position
        # within the parent's children list; appended children get a
        # monotone counter so relative order always matches the host tree)
        self.child_key = np.zeros(N, dtype=np.int64)
        self.child_key[ch_order] = pos_in_seg
        self.child_count = np.bincount(parent[~root_mask],
                                       minlength=N).astype(np.int64)
        dfs_of = np.zeros(N, dtype=np.int64)
        for li in range(1, self.max_depth):
            idx = order[bounds[li]:bounds[li + 1]]
            dfs_of[idx] = dfs_of[parent[idx]] + 1 + pre_sib[idx]
        self.dfs_of = dfs_of.astype(np.int32)          # slot -> dfs row
        self.dfs_end_of = (dfs_of + sz).astype(np.int32)
        dfs_order = np.empty(N, dtype=np.int32)        # dfs row -> slot
        dfs_order[self.dfs_of] = np.arange(N, dtype=np.int32)
        self.dfs_order = dfs_order

        # kept for the lazy SPR-base precompute
        self._mut_node = mut_node
        self._root_mut = root_mut
        self._level_order = order
        self._level_bounds = bounds
        self._base_spr = None

    @property
    def base_spr(self):
        """Per-node aggregate for SPR move scoring: sum over ALL positions of
        the E=1-everywhere g==ref term ((ref & A_r) == 0) — the base the SPR
        scorer (optimize/spr.py _score_moves) decomposes around, which
        differs from the placement no-entry base (A_r != ref) whenever A_r is
        a multi-bit ambiguity mask containing ref.

        Derivation: at positions without a branch mutation at n the term is
        (ref & pathstate) == 0, which telescopes over the root path exactly
        like the placement F recurrence; n's own branch positions swap in the
        bm-aware term.  nc_base is IDENTICAL between the two modes."""
        if self._base_spr is None:
            self._flush()
            N = self.N
            # mutation set: base CSR minus tombstones, plus the overlay
            # from incremental appends (the precompute-time _mut_node /
            # level snapshots go stale after _flush, so everything here is
            # derived from CURRENT state)
            mut_node = np.repeat(
                np.arange(len(self.mut_ptr) - 1, dtype=np.int64),
                np.diff(self.mut_ptr).astype(np.int64))
            col = self.mut_col.astype(np.int64)
            par = self.mut_par.astype(np.int32)
            mut = self.mut_mut.astype(np.int32)
            rootm = self.is_root_mask[mut_node]
            if self.csc_dead is not None:
                dead_csr = np.zeros(len(mut_node), bool)
                dead_csr[self._csc_order[self.csc_dead]] = True
                keep = ~dead_csr
                mut_node, col = mut_node[keep], col[keep]
                par, mut, rootm = par[keep], mut[keep], rootm[keep]
            if self._ov is not None:
                mut_node = np.concatenate([mut_node,
                                           self._ov[0].astype(np.int64)])
                col = np.concatenate([col, self._ov[1].astype(np.int64)])
                par = np.concatenate([par, self._ov[2].astype(np.int32)])
                mut = np.concatenate([mut, self._ov[3].astype(np.int32)])
                rootm = np.concatenate(
                    [rootm, np.zeros(len(self._ov[0]), bool)])
            refm = self.ref[col].astype(np.int32)
            eff = mut != par
            matched = (refm & mut) != 0
            miss_mi = ((refm & mut) == 0).astype(np.int64)
            miss_pi = ((refm & par) == 0).astype(np.int64)
            g_delta_m = np.where(eff, miss_mi - miss_pi, 0)
            own_corr_m = np.where(eff & ~matched, miss_pi - miss_mi, 0)
            own_corr_m = np.where(rootm, 0, own_corr_m)
            g_delta = np.bincount(mut_node, weights=g_delta_m,
                                  minlength=N).astype(np.int64)
            own_corr = np.bincount(mut_node, weights=own_corr_m,
                                   minlength=N).astype(np.int64)
            level = self.level
            order = np.argsort(level, kind="stable")
            bounds = np.searchsorted(level[order],
                                     np.arange(int(level.max()) + 2))
            G = np.zeros(N, dtype=np.int64)
            parent = self.parent
            for li in range(len(bounds) - 1):
                idx = order[bounds[li]:bounds[li + 1]]
                if li == 0:
                    G[idx] = g_delta[idx]
                else:
                    G[idx] = G[parent[idx]] + g_delta[idx]
            self._base_spr = (G + own_corr).astype(np.int32)
        return self._base_spr

    def score_spr_T(self, pos, gval, max_cols: int = 2048):
        """SPR-mode scoring (E=1 everywhere, no missing): score_T/nc_T for a
        batch of subtree Fitch masks given as entry deviations from ref.
        Interval-engine path (ops/interval.py)."""
        self._flush()
        B, K = pos.shape
        kmiss = np.zeros((B, K), dtype=bool)
        s, n = self._score_interval(pos, gval, kmiss, spr=True)
        return s, n, self.node_num_mut

    def score_spr_T_cols(self, pos, gval, max_cols: int = 2048):
        """Legacy column-materialization SPR path (cross-check / fallback)."""
        kmiss = np.zeros(pos.shape, dtype=bool)
        s, n = self._score_cols_chunked(pos, gval, kmiss, max_cols,
                                        spr=True)
        return s, n, self.node_num_mut

    def _score_cols_chunked(self, pos, gval, kmiss, max_cols, spr):
        """Greedy column-budgeted chunking over the batch (shared by both
        legacy cols paths)."""
        B = pos.shape[0]
        score_T = np.empty((self.N, B), dtype=np.int32)
        nc_T = np.empty((self.N, B), dtype=np.int32)
        start = 0
        while start < B:
            end = start + 1
            cols = np.unique(pos[start][pos[start] < self.P])
            while end < B:
                cand = np.union1d(cols, pos[end][pos[end] < self.P])
                if len(cand) > max_cols:
                    break
                cols = cand
                end += 1
            s, n = self._score_chunk(pos[start:end], gval[start:end],
                                     kmiss[start:end], cols, spr=spr)
            score_T[:, start:end] = s
            nc_T[:, start:end] = n
            start = end
        return score_T, nc_T

    # --- interval engine ----------------------------------------------------

    @property
    def n_pad(self) -> int:
        """DFS row count padded to a deterministic x1.25 capacity ladder
        (2048-aligned).  Incremental appends grow N every batch; a tight
        bucket would change the jit shapes (= a full recompile) every
        ~2048 appends, so trade <=25% padded rows (masked inactive) for
        shape stability."""
        cap = 2048
        while cap < self.N:
            cap = -(-(cap * 5 // 4) // 2048) * 2048
        return cap

    def _events(self, pos, gval, kmiss, spr: bool, skip_base=False):
        """Difference-array events for a batch (host, fully vectorized).

        For every (sample entry, column mutation) pair, emits the DFS-range
        delta (domain allele change) and a width-1 delta at the mutation
        node (the bm-correction); num_common gets point events only.
        Derivation in ops/interval.py; the per-case formulas are exactly
        ops/placement_sparse._corr's."""
        P = self.P
        B = pos.shape[0]
        e = pos < P
        eb, ek = np.nonzero(e)
        cols = pos[eb, ek].astype(np.int64)
        gv = gval[eb, ek].astype(np.int32)
        km = kmiss[eb, ek]
        rk = self.ref[cols].astype(np.int32)
        # corr at reference-state nodes (sub_nobm(ref) == 0 in both modes)
        add0_src = ((~km) & ((gv & rk) == 0)).astype(np.int32)
        add0 = np.bincount(eb, weights=add0_src,
                           minlength=B).astype(np.int32)

        if skip_base:
            # overlay-only expansion (base CSC handled on device)
            z = np.zeros(0, np.int64)
            pe, u = z, z.astype(np.int32)
            am = ap = np.zeros(0, np.int32)
            rootm = effm = np.zeros(0, bool)
        else:
            lo = self.csc_ptr[cols]
            hi = self.csc_ptr[cols + 1]
            counts = (hi - lo).astype(np.int64)
            pe = np.repeat(np.arange(len(eb)), counts)
            flat = np.repeat(lo, counts) + _ranges(counts)
            u = self.csc_node[flat]
            am = self.csc_mut[flat].astype(np.int32)
            ap = self.csc_par[flat].astype(np.int32)
            rootm = self.csc_root[flat]
            effm = self.csc_eff[flat]
        if not skip_base and self.csc_dead is not None:
            # mutations moved off a node by a sibling split are tombstoned;
            # dead rows are simply absent from the tree
            alive = ~self.csc_dead[flat]
            pe, u, am, ap = pe[alive], u[alive], am[alive], ap[alive]
            rootm, effm = rootm[alive], effm[alive]
        if self._ov is not None:
            # overlay mutations from incremental appends, column-sorted
            ov_node, ov_col, ov_par, ov_mut = self._ov
            lo2 = np.searchsorted(ov_col, cols)
            hi2 = np.searchsorted(ov_col, cols, side="right")
            c2 = (hi2 - lo2).astype(np.int64)
            pe2 = np.repeat(np.arange(len(eb)), c2)
            flat2 = np.repeat(lo2, c2) + _ranges(c2)
            pe = np.concatenate([pe, pe2])
            u = np.concatenate([u, ov_node[flat2]])
            am = np.concatenate([am, ov_mut[flat2].astype(np.int32)])
            ap = np.concatenate([ap, ov_par[flat2].astype(np.int32)])
            rootm = np.concatenate([rootm, np.zeros(len(pe2), bool)])
            effm = np.concatenate(
                [effm, ov_mut[flat2] != ov_par[flat2]])
        gv_p = gv[pe]
        km_p = km[pe]
        rk_p = rk[pe]
        b_p = eb[pe].astype(np.int32)

        def corr_nobm(a):
            t1 = ((~km_p) & ((gv_p & a) == 0)).astype(np.int32)
            if spr:
                sub = ((rk_p & a) == 0).astype(np.int32)
            else:
                sub = (a != rk_p).astype(np.int32)
            return t1 - sub

        c_am = corr_nobm(am)
        d_range = c_am - corr_nobm(ap)
        matched = (gv_p & am) != 0
        a_eff = np.where(matched, am, ap)
        t1_bm = ((~km_p) & ((gv_p & a_eff) == 0)).astype(np.int32)
        if spr:
            a_r = np.where((rk_p & am) != 0, am, ap)
            sub_bm = ((rk_p & a_r) == 0).astype(np.int32)
        else:
            sub_bm = np.where((rk_p & am) != 0, am != rk_p,
                              ap != rk_p).astype(np.int32)
        # the root is never a branch mutation (stp[root] == st[root])
        d_point = np.where(rootm, 0, (t1_bm - sub_bm) - c_am)
        d_nc = np.where(effm & ~rootm,
                        ((gv_p & am) != 0).astype(np.int32)
                        - ((rk_p & am) != 0).astype(np.int32), 0)

        r = self.dfs_of[u].astype(np.int32)
        rend = self.dfs_end_of[u].astype(np.int32)
        # the range-start and the width-1 point share row r: combine, so a
        # pair costs at most 3 events (less host-to-device volume)
        ev_idx = np.concatenate([r, rend, r + 1])
        ev_b = np.concatenate([b_p, b_p, b_p])
        ev_val = np.concatenate([d_range + d_point, -d_range, -d_point])
        keep = ev_val != 0
        ev_idx, ev_b, ev_val = ev_idx[keep], ev_b[keep], ev_val[keep]
        nkeep = d_nc != 0
        nc_idx, nc_b, nc_val = r[nkeep], b_p[nkeep], d_nc[nkeep]
        return ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val, add0

    def _csc_dev(self):
        """Device-resident CSC index for IN-KERNEL event expansion
        (ops/interval.interval_place_dev): the base CSC is built exactly
        once per BigMAT (appends go to the overlay), so csc_ptr/csc_node/
        ref/meta32 stay resident on device ACROSS flushes.  Per flush the
        only device work is scattering the newly-tombstoned dead bits
        into the resident meta32 (a few indices) and re-uploading the two
        n_pad-sized DFS layout arrays — the multi-MB CSC index is never
        re-sent to the device."""
        cached = getattr(self, "_csc_dev_cache", None)
        if cached is not None:
            return cached
        stat = getattr(self, "_csc_static_dev", None)
        if stat is None:
            eff = self.csc_mut != self.csc_par
            meta32 = (self.csc_mut.astype(np.int32)
                      | (self.csc_par.astype(np.int32) << 4)
                      | (self.csc_root.astype(np.int32) << 8)
                      | (eff.astype(np.int32) << 9))
            if self.csc_dead is not None:
                meta32 = meta32 | (self.csc_dead.astype(np.int32) << 10)
            stat = (jnp.asarray(self.csc_ptr.astype(np.int32)),
                    jnp.asarray(self.csc_node),
                    jnp.asarray(self.ref))
            self._csc_static_dev = stat
            self._csc_meta_dev = jnp.asarray(meta32)
            self._csc_new_dead = []
        meta_dev = self._csc_meta_dev
        nd = getattr(self, "_csc_new_dead", None) or []
        if nd:
            idx = np.unique(np.concatenate(nd)).astype(np.int32)
            # bucket the index shape: eager/per-shape programs would
            # recompile EVERY flush — pad with duplicates (idempotent
            # .set) so one jitted program serves all flushes
            cap = 64
            while cap < len(idx):
                cap *= 2
            idxp = np.full(cap, idx[0], np.int32)
            idxp[:len(idx)] = idx
            meta_dev = _dead_bit_sync(meta_dev, jnp.asarray(idxp))
            self._csc_meta_dev = meta_dev
            self._csc_new_dead = []
        # dfs arrays padded to the n_pad capacity ladder: their raw [N]
        # shape grows on every flush and would retrigger a full recompile
        # of the *_dev programs per append batch (pad rows are never
        # indexed — csc_node only holds real slots)
        n_pad = self.n_pad
        dfs_p = np.full(n_pad, n_pad, np.int32)
        dfs_p[:self.N] = self.dfs_of
        dfe_p = np.full(n_pad, n_pad, np.int32)
        dfe_p[:self.N] = self.dfs_end_of
        cache = (stat[0], stat[1], meta_dev,
                 jnp.asarray(dfs_p), jnp.asarray(dfe_p), stat[2])
        self._csc_dev_cache = cache
        return cache

    def _dfs_meta(self, spr: bool):
        """Per-epoch DFS-ordered metadata, padded to n_pad and RESIDENT ON
        DEVICE (uploaded once per epoch, not per batch — the arrays are
        ~tens of MB at pandemic scale)."""
        key = "_dfs_meta_spr" if spr else "_dfs_meta_plc"
        cached = getattr(self, key, None)
        if cached is not None:
            return cached
        n_pad, N = self.n_pad, self.N
        o = self.dfs_order

        if self.mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(self.mesh, P())
            dev = lambda a: jax.device_put(a, rep)  # noqa: E731
        else:
            dev = jnp.asarray

        def padded(a, fill=0, dtype=None):
            out = np.full(n_pad, fill, dtype=dtype or a.dtype)
            out[:N] = a[o]
            return dev(out)

        base = self.base_spr if spr else self.base
        meta = {
            "base": padded(base.astype(np.int32)),
            "nc_base": padded(self.nc_base),
            "num_mut": padded(self.node_num_mut),
            "is_leaf": padded(self.is_leaf),
            "is_root": padded(self.is_root_mask),
            "active": padded(self.active, fill=False),
            "num_leaves": padded(self.num_leaves, fill=-1),
            "bfs_rank": padded(self.bfs_rank, fill=-1),
            "level": padded(self.level.astype(np.int32)),
        }
        setattr(self, key, meta)
        return meta

    def _batch_shapes(self, B, ev, nc):
        nd = self.mesh.size if self.mesh is not None else 1
        b_pad = max(8, nd)
        while b_pad < B:
            b_pad *= 2
        from ..ops import interval as iv
        if self.mesh is not None:
            bl = b_pad // nd
            evp = iv.shard_events(ev, nd, bl, self.n_pad)
            ncp = iv.shard_events(nc, nd, bl, self.n_pad)
        else:
            evp = iv.pad_events(*ev, self.n_pad)
            ncp = iv.pad_events(*nc, self.n_pad)
        return b_pad, evp, ncp

    def _score_interval(self, pos, gval, kmiss, spr: bool):
        """[N, B] score/nc via the interval engine (slot order)."""
        from ..ops import interval as iv
        B = pos.shape[0]
        *ev, add0 = self._events(pos, gval, kmiss, spr)
        b_pad, evp, ncp = self._batch_shapes(B, ev[:3], ev[3:6])
        meta = self._dfs_meta(spr)
        add0p = np.zeros(b_pad, np.int32)
        add0p[:B] = add0
        if self.mesh is not None:
            from ..parallel.distributed import fetch
            fn = iv._scores_sharded_fn(self.mesh, self.mesh.axis_names[0],
                                       self.n_pad, b_pad // self.mesh.size)
            score_dfs, nc_dfs = (fetch(x) for x in fn(
                *(jnp.asarray(a) for a in evp),
                *(jnp.asarray(a) for a in ncp),
                meta["base"], meta["nc_base"], jnp.asarray(add0p)))
        else:
            score_dfs, nc_dfs = (np.asarray(x) for x in iv.interval_scores(
                *(jnp.asarray(a) for a in evp),
                *(jnp.asarray(a) for a in ncp),
                meta["base"], meta["nc_base"],
                jnp.asarray(add0p), self.n_pad, b_pad))
        N = self.N
        score_T = np.empty((N, B), dtype=np.int32)
        nc_T = np.empty((N, B), dtype=np.int32)
        score_T[self.dfs_order] = score_dfs[:N, :B]
        nc_T[self.dfs_order] = nc_dfs[:N, :B]
        return score_T, nc_T

    def _levels(self):
        """Exact levels: #hops to root, O(depth) vectorized gathers."""
        N = self.N
        idx = np.arange(N, dtype=np.int32)
        level = np.zeros(N, dtype=np.int32)
        at = idx.copy()
        moving = self.parent[at] != at
        iters = 0
        while moving.any():
            at = np.where(moving, self.parent[at], at)
            level += moving
            moving = self.parent[at] != at
            iters += 1
            if iters > N:
                raise ValueError("parent pointers contain a cycle")
        return level

    # --- incremental placement appends --------------------------------------
    #
    # Placement surgery never changes an existing node's PATH STATE, so the
    # snapshot arrays can be maintained exactly under appends: new slots at
    # the end, vectorized DFS-row shifts, O(|mutations|) aggregate patches
    # via the F-prefix chain, and an overlay CSC for new/moved mutations.
    # This replaces the per-epoch from_tree Python rebuild (the reference's
    # followers patch their replicas the same way instead of re-receiving
    # the tree, place_sample_follower.cpp:95-249).  Queued by the engine,
    # flushed lazily at the next scoring call.

    def queue_child_insert(self, u_slot: int, s_muts, node=None) -> int:
        """Append a sample leaf under internal node u_slot.  s_muts is a
        list of (col, par_nibble, mut_nibble).  Returns the new slot."""
        slot = self.N + sum(1 if p[0] == "child" else 2
                            for p in self._pending)
        self._pending.append(("child", u_slot, s_muts, node))
        return slot

    def queue_sibling_split(self, u_slot: int, common, l2,
                            x_node=None, s_node=None) -> tuple[int, int]:
        """Split the branch above u_slot: new internal X takes `common`
        (removed from u's list), the new sample leaf under X takes `l2`.
        Returns (x_slot, s_slot).

        u_slot may itself still be queued (a serving batch frequently
        splits a sample it just inserted): queue order guarantees u's
        creation entry precedes this split in ``_pending``, so flush-time
        processing sees u fully materialized — no mid-batch flush needed
        (removing it took the 200k serve bench from 118 flushes/4096
        samples to one per batch)."""
        if u_slot < self.N and int(self.parent[u_slot]) == int(u_slot):
            raise ValueError("cannot sibling-split the root")
        base = self.N + sum(1 if p[0] == "child" else 2
                            for p in self._pending)
        self._pending.append(("split", u_slot, common, l2, x_node, s_node))
        return base, base + 1

    def _mut_terms(self, cols, par, mut):
        """Per-mutation aggregate contributions (same formulas as
        _precompute): (f_delta, own_corr, nc, eff) int64 arrays."""
        cols = np.asarray(cols, dtype=np.int64)
        pi = np.asarray(par, dtype=np.int32)
        mi = np.asarray(mut, dtype=np.int32)
        refm = self.ref[cols].astype(np.int32)
        eff = mi != pi
        matched = (refm & mi) != 0
        f_delta = np.where(eff, (mi != refm).astype(np.int64)
                           - (pi != refm).astype(np.int64), 0)
        own_corr = np.where(eff & ~matched,
                            (pi != refm).astype(np.int64)
                            - (mi != refm).astype(np.int64), 0)
        nc = (eff & matched).astype(np.int64)
        return f_delta, own_corr, nc, eff.astype(np.int64)

    def _flush(self) -> None:
        if not self._pending:
            return
        pend = self._pending
        self._pending = []
        n_new = sum(1 if p[0] == "child" else 2 for p in pend)
        N0 = self.N
        N = N0 + n_new
        self._appended += n_new
        self._cols_stale = True

        def grow(a, fill, dtype=None):
            out = np.full(N, fill, dtype=dtype or a.dtype)
            out[:N0] = a
            return out

        BIGROW = np.int32(1 << 30)
        self.parent = grow(self.parent, 0)
        self.level = grow(self.level, 0)
        self.is_leaf = grow(self.is_leaf, True)
        self.active = grow(self.active, True)
        self.num_leaves = grow(self.num_leaves, 1)
        self.base = grow(self.base, 0)
        self.nc_base = grow(self.nc_base, 0)
        self.node_num_mut = grow(self.node_num_mut, 0)
        self.F = grow(self.F, 0)
        self.child_key = grow(self.child_key, 0)
        self.child_count = grow(self.child_count, 0)
        self.dfs_of = grow(self.dfs_of, BIGROW)
        self.dfs_end_of = grow(self.dfs_end_of, BIGROW)
        self.is_root_mask = grow(self.is_root_mask, False)
        nodes = getattr(self, "_nodes", None)

        ov_new: list[tuple] = []   # (node, col, par, mut)
        ovq: dict[tuple, int] = {}  # (slot, col) -> ov_new index, for
        # splits whose target u was materialized earlier in THIS flush
        # (its mutations are still local to ov_new, not yet in _ov)
        slot = N0
        i = 0
        while i < len(pend):
            # maximal run of child inserts: ONE vectorized multi-insert
            # instead of per-pending O(N) shift passes (a serving batch
            # flushes hundreds of appends at once)
            j = i
            while j < len(pend) and pend[j][0] == "child":
                j += 1
            if j - i >= 2:
                run = pend[i:j]
                self._apply_child_run(run, slot, ov_new, ovq, nodes)
                slot += len(run)
                i = j
                continue
            p = pend[i]
            i += 1
            if p[0] == "child":
                _, u, s_muts, s_node = p
                s = slot
                slot += 1
                r_s = int(self.dfs_end_of[u])
                anc_mask = (self.dfs_end_of == r_s) & \
                    (self.dfs_of <= self.dfs_of[u])
                self.dfs_of += self.dfs_of >= r_s
                self.dfs_end_of += (self.dfs_end_of > r_s) | anc_mask
                self.dfs_of[s] = r_s
                self.dfs_end_of[s] = r_s + 1
                self.parent[s] = u
                self.level[s] = self.level[u] + 1
                self.child_key[s] = self.child_count[u]
                self.child_count[u] += 1
                self._leaf_count_walk(u)
                self._init_new_node(s, u, s_muts, ov_new, ovq)
                if nodes is not None:
                    nodes.append(s_node)
            else:
                _, u, common, l2, x_node, s_node = p
                x, s = slot, slot + 1
                slot += 2
                pold = int(self.parent[u])
                lo, hi = int(self.dfs_of[u]), int(self.dfs_end_of[u])
                # host surgery appends X at the END of p's children (and
                # moves u under X), so canonically u's subtree rotates past
                # its later siblings to the end of p's interval
                p_end = int(self.dfs_end_of[pold])
                if hi < p_end:
                    w = hi - lo
                    later_of = (self.dfs_of >= hi) & (self.dfs_of < p_end)
                    later_end = (self.dfs_end_of > hi) & \
                        (self.dfs_end_of <= p_end) & ~(self.dfs_of < hi)
                    sub_of = (self.dfs_of >= lo) & (self.dfs_of < hi)
                    sub_end = (self.dfs_end_of > lo) & (self.dfs_end_of <= hi)
                    self.dfs_of[later_of] -= w
                    self.dfs_end_of[later_end] -= w
                    self.dfs_of[sub_of] += p_end - hi
                    self.dfs_end_of[sub_end] += p_end - hi
                    lo, hi = lo + (p_end - hi), p_end
                # u's subtree deepens under X
                sub = (self.dfs_of >= lo) & (self.dfs_of < hi)
                self.level[sub] += 1
                # insert X's row immediately before u
                self.dfs_of += self.dfs_of >= lo
                self.dfs_end_of += self.dfs_end_of > lo
                self.dfs_of[x] = lo
                self.dfs_end_of[x] = int(self.dfs_end_of[u])
                self.parent[x] = pold
                self.parent[u] = x
                self.level[x] = self.level[u] - 1
                self.child_key[x] = self.child_count[pold]
                self.child_count[pold] += 1
                # s inserted inside X, BEFORE u's subtree (host surgery
                # makes X.children == [s, u], and from_tree's DFS follows
                # children-list order — keep the numberings identical)
                r_s = int(self.dfs_of[u])
                self.dfs_of += self.dfs_of >= r_s
                self.dfs_end_of += self.dfs_end_of > r_s
                self.dfs_of[s] = r_s
                self.dfs_end_of[s] = r_s + 1
                self.parent[s] = x
                self.level[s] = self.level[x] + 1
                # host surgery creates X, then s under X, then moves u:
                # X.children == [s, u]
                self.child_key[s] = 0
                self.child_key[u] = 1
                self.child_count[x] = 2
                self.is_leaf[x] = False
                self.num_leaves[x] = self.num_leaves[u] + 1
                self._leaf_count_walk(pold)
                # u loses `common`: patch aggregates + tombstone CSC rows
                if common:
                    cc = np.array([c for c, _, _ in common], np.int64)
                    cp = np.array([pn for _, pn, _ in common], np.int32)
                    cm = np.array([mn for _, _, mn in common], np.int32)
                    _, oc, nc, eff = self._mut_terms(cc, cp, cm)
                    self.base[u] -= int(oc.sum())
                    self.nc_base[u] -= int(nc.sum())
                    self.node_num_mut[u] -= int(eff.sum())
                    self._kill_muts(u, cc, ov_new, ovq)
                self._init_new_node(x, pold, common, ov_new, ovq)
                self._init_new_node(s, x, l2, ov_new, ovq)
                if nodes is not None:
                    nodes.append(x_node)
                    nodes.append(s_node)

        self.N = N
        self.max_depth = int(self.level.max()) + 1
        dfs_order = np.empty(N, dtype=np.int32)
        dfs_order[self.dfs_of] = np.arange(N, dtype=np.int32)
        self.dfs_order = dfs_order
        ov_new = [t for t in ov_new if t is not None]
        if ov_new:
            node_a = np.array([t[0] for t in ov_new], np.int32)
            col_a = np.array([t[1] for t in ov_new], np.int32)
            par_a = np.array([t[2] for t in ov_new], np.uint8)
            mut_a = np.array([t[3] for t in ov_new], np.uint8)
            if self._ov is not None:
                node_a = np.concatenate([self._ov[0], node_a])
                col_a = np.concatenate([self._ov[1], col_a])
                par_a = np.concatenate([self._ov[2], par_a])
                mut_a = np.concatenate([self._ov[3], mut_a])
            o = np.argsort(col_a, kind="stable")
            self._ov = (node_a[o], col_a[o], par_a[o], mut_a[o])
        self._ranks_dirty = True
        self._base_spr = None
        for k in ("_dfs_meta_spr", "_dfs_meta_plc", "_csc_dev_cache",
                  "_clade_dfs_cache"):
            if hasattr(self, k):
                delattr(self, k)

    def _apply_child_run(self, run, slot0: int, ov_new, ovq,
                         nodes) -> None:
        """Vectorized multi-insert: materialize a run of k child appends
        with ONE set of O(N) passes instead of k.

        Works in run-start coordinates.  Each insert lands at the end of
        its target's interval; the FINAL left-to-right order of the new
        rows is by (boundary c, deeper target first, queue order) — two
        same-boundary inserts at nested targets always end up deeper-first
        regardless of queue order (the deeper target's boundary is not
        extended by the shallower insert), matching the sequential path.
        Old-row shifts become dominance counts over the sorted insert
        keys: dfs_of += #(c_j <= dfs_of), and dfs_end_of += #(c_j < end
        OR (c_j == end AND target_dfs >= dfs_of)) — the tie case keeps
        last-child chains unextended while ancestors sharing the boundary
        grow, exactly the sequential anc_mask rule.  Subtree-leaf gains
        fall out as (end shifts - of shifts)."""
        k = len(run)
        us = np.array([p[1] for p in run], np.int64)
        if (us >= slot0).any():
            raise AssertionError("child-run target queued in the same run")
        c = self.dfs_end_of[us].astype(np.int64)
        du = self.dfs_of[us].astype(np.int64)
        M = np.int64(1) << 31

        of_old = self.dfs_of.astype(np.int64)
        end_old = self.dfs_end_of.astype(np.int64)
        sc = np.sort(c)
        ofc = np.searchsorted(sc, of_old, side="right")
        kk = np.sort(c * M + (M - 1 - du))
        endc = np.searchsorted(kk, end_old * M + (M - 1 - of_old),
                               side="right")
        self.dfs_of += ofc.astype(self.dfs_of.dtype)
        self.dfs_end_of += endc.astype(self.dfs_end_of.dtype)
        self.num_leaves += (endc - ofc).astype(self.num_leaves.dtype)

        # final row of insert j = c_j + (#inserts ordered before it)
        ordk = np.lexsort((np.arange(k), -du, c))
        rank = np.empty(k, np.int64)
        rank[ordk] = np.arange(k)
        slots = slot0 + np.arange(k)
        self.dfs_of[slots] = (c + rank).astype(self.dfs_of.dtype)
        self.dfs_end_of[slots] = (c + rank + 1).astype(
            self.dfs_end_of.dtype)
        self.parent[slots] = us
        self.level[slots] = self.level[us] + 1
        self.num_leaves[slots] = 1
        # child keys: same-target inserts append in queue order
        o2 = np.lexsort((np.arange(k), us))
        seq = np.arange(k, dtype=np.int64)
        grp_start = np.r_[True, us[o2][1:] != us[o2][:-1]]
        seq -= np.maximum.accumulate(np.where(grp_start, seq, 0))
        self.child_key[slots[o2]] = self.child_count[us[o2]] + seq
        np.add.at(self.child_count, us, 1)
        for j, p in enumerate(run):
            self._init_new_node(int(slots[j]), int(us[j]), p[2], ov_new,
                                ovq)
            if nodes is not None:
                nodes.append(p[3])

    def _init_new_node(self, slot, parent_slot, muts, ov_new,
                       ovq=None) -> None:
        """Aggregates for a new node from the F-prefix chain + its own
        mutation triplets; mutations go to the overlay."""
        if muts:
            cc = np.array([c for c, _, _ in muts], np.int64)
            cp = np.array([pn for _, pn, _ in muts], np.int32)
            cm = np.array([mn for _, _, mn in muts], np.int32)
            fd, oc, nc, eff = self._mut_terms(cc, cp, cm)
            self.F[slot] = self.F[parent_slot] + int(fd.sum())
            self.base[slot] = self.F[slot] + int(oc.sum())
            self.nc_base[slot] = int(nc.sum())
            self.node_num_mut[slot] = int(eff.sum())
            for (c, pn, mn) in muts:
                if ovq is not None:
                    ovq[(slot, int(c))] = len(ov_new)
                ov_new.append((slot, c, pn, mn))
        else:
            self.F[slot] = self.F[parent_slot]
            self.base[slot] = self.F[slot]
            self.nc_base[slot] = 0
            self.node_num_mut[slot] = 0

    def _leaf_count_walk(self, start_slot) -> None:
        """+1 leaf on start_slot and every ancestor (a placement adds
        exactly one leaf to each containing subtree)."""
        s = int(start_slot)
        while True:
            self.num_leaves[s] += 1
            p = int(self.parent[s])
            if p == s:
                break
            s = p

    def _kill_muts(self, u_slot, cols, ov_new=None, ovq=None) -> None:
        """Tombstone u's base-CSC (or overlay) mutations at `cols`.  When
        u was materialized earlier in the SAME flush, its mutations are
        still in the flush-local ov_new list — ovq indexes them."""
        for c in np.asarray(cols, dtype=np.int64):
            if ovq is not None:
                k = ovq.pop((int(u_slot), int(c)), None)
                if k is not None:
                    ov_new[k] = None
                    continue
            lo, hi = int(self.csc_ptr[c]), int(self.csc_ptr[c + 1])
            seg = self.csc_node[lo:hi]
            hit = np.nonzero(seg == u_slot)[0]
            if len(hit):
                if self.csc_dead is None:
                    self.csc_dead = np.zeros(len(self.csc_node), bool)
                self.csc_dead[lo + hit] = True
                if hasattr(self, "_csc_new_dead"):
                    # device meta32 is resident; sync these rows lazily
                    # at the next _csc_dev call (tiny scatter, no
                    # whole-index re-upload)
                    self._csc_new_dead.append(
                        (lo + hit).astype(np.int64))
                continue
            if self._ov is not None:
                lo2 = np.searchsorted(self._ov[1], c)
                hi2 = np.searchsorted(self._ov[1], c, side="right")
                hit2 = np.nonzero(self._ov[0][lo2:hi2] == u_slot)[0]
                if len(hit2):
                    keep = np.ones(len(self._ov[0]), bool)
                    keep[lo2 + hit2] = False
                    self._ov = tuple(a[keep] for a in self._ov)
                    continue
            raise AssertionError(
                f"mutation to remove not found: node {u_slot} col {int(c)}")

    def _recompute_ranks(self) -> None:
        """Exact BFS ranks from (level, parent rank, child key) — a
        vectorized level sweep reproducing the host tree's
        breadth_first_expansion order."""
        N = self.N
        level = self.level
        order = np.argsort(level, kind="stable")
        bounds = np.searchsorted(level[order],
                                 np.arange(int(level.max()) + 2))
        rank = np.zeros(N, dtype=np.int64)
        start = 0
        for li in range(len(bounds) - 1):
            idx = order[bounds[li]:bounds[li + 1]]
            if len(idx) == 0:
                continue
            if li == 0:
                rank[idx] = np.arange(len(idx))
            else:
                o2 = np.lexsort((self.child_key[idx],
                                 rank[self.parent[idx]]))
                rank[idx[o2]] = start + np.arange(len(idx))
            start += len(idx)
        self._bfs_rank = rank.astype(np.int32)
        self._ranks_dirty = False

    # --- sample encoding ----------------------------------------------------

    def sparsify(self, samples_mutations, k_slots=None):
        """Mutation lists -> (pos_cols [B,K] i32, gval [B,K] u8,
        kmiss [B,K] bool); padding slots get pos = P (mapped per-chunk)."""
        return pp.sparsify(samples_mutations, self.pos_index, self.P,
                           k_slots=k_slots)

    # --- scoring ------------------------------------------------------------

    def score_batch_T(self, pos, gval, kmiss, max_cols=2048):
        """Score a batch against every node: returns (score_T [N,B],
        num_common_T [N,B], node_num_mut [N]) numpy arrays.

        pos is in GLOBAL position-index space (>= P marks padding).
        Interval-engine path: one scatter + one [N, B] segmented cumsum on
        device, no per-column state materialization (ops/interval.py)."""
        self._flush()
        s, n = self._score_interval(pos, gval, kmiss, spr=False)
        return s, n, self.node_num_mut

    def score_batch_T_cols(self, pos, gval, kmiss, max_cols=2048):
        """Legacy column-materialization path (pointer-doubling ancestor
        gathers over the batch's unique columns).  Kept as a cross-check /
        fallback for the interval engine."""
        s, n = self._score_cols_chunked(pos, gval, kmiss, max_cols,
                                        spr=False)
        return s, n, self.node_num_mut

    def _score_chunk(self, pos, gval, kmiss, cols, spr: bool = False):
        if self._cols_stale:
            raise RuntimeError(
                "legacy column path is unavailable after incremental "
                "appends (ancestor tables are stale); use the interval "
                "engine or rebuild via from_tree")
        C = len(cols)
        # bucket the column axis to 512-multiples so chunk-to-chunk shape
        # drift doesn't retrigger compilation
        C_pad = max(128, -(-C // 512) * 512) if C > 128 else 128
        # m0: own branch-mutation allele per (node, column)
        lo = self.csc_ptr[cols]
        hi = self.csc_ptr[cols + 1]
        counts = hi - lo
        flat_idx = np.repeat(lo, counts) + _ranges(counts)
        coo_col = np.repeat(np.arange(C, dtype=np.int32), counts)
        coo_node = self.csc_node[flat_idx]
        coo_val = np.where(self.csc_eff[flat_idx], self.csc_mut[flat_idx], 0)
        m0 = np.zeros((self.N, C_pad), dtype=np.uint8)
        m0[coo_node, coo_col] = coo_val
        ref_cols = np.zeros(C_pad, dtype=np.uint8)
        ref_cols[:C] = self.ref[cols]
        # remap entry positions into column space
        col_of = np.full(self.P + 1, C_pad, dtype=np.int32)
        col_of[cols] = np.arange(C, dtype=np.int32)
        pos_cols = col_of[np.minimum(pos, self.P)]
        base = self.base_spr if spr else self.base
        score_t, nc_t = pp.score_cols_T(
            jnp.asarray(m0), jnp.asarray(self.anc), jnp.asarray(self.parent),
            np.int32(self.root_slot), jnp.asarray(ref_cols),
            jnp.asarray(base), jnp.asarray(self.nc_base),
            jnp.asarray(pos_cols), jnp.asarray(gval), jnp.asarray(kmiss),
            pos.shape[1], self.n_anc, spr=spr)
        return np.asarray(score_t), np.asarray(nc_t)

    def place_batch(self, samples_mutations, max_cols=2048):
        """Best placements for a batch: (best_score [B], best_slot [B],
        num_best [B]) with the reference tie-break and validity rules.
        Fully fused on device — only O(B) vectors cross the boundary."""
        pos, gval, kmiss = self.sparsify(samples_mutations)
        best_score, best_slot, num_best, _ = self.place_arrays(pos, gval,
                                                               kmiss)
        return best_score, best_slot, num_best

    def place_one_host(self, pos, gval, kmiss, full: bool = False):
        """Single-sample EXACT placement on the host (numpy mirror of the
        interval engine): one difference array + cumsum over N rows.  Used
        for mid-batch staleness re-scores, where a device dispatch plus the
        post-append metadata re-upload would dominate (the appends
        invalidate the device-resident epoch arrays).
        Returns (best_score, best_slot, num_best, hu_best) scalars;
        full=True appends the (is_best [N], hu [N]) masks (tie-set
        enumeration for detailed clade assignment)."""
        self._flush()
        *ev, add0 = self._events(pos, gval, kmiss, spr=False)
        ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val = ev
        N, n_pad = self.N, self.n_pad
        diff = np.zeros(n_pad + 1, np.int32)
        np.add.at(diff, ev_idx, ev_val)
        run = np.cumsum(diff[:n_pad], dtype=np.int32)
        score = self.base + np.int32(add0[0]) + run[self.dfs_of]
        ncv = np.zeros(n_pad + 1, np.int32)
        np.add.at(ncv, nc_idx, nc_val)
        nc = self.nc_base + ncv[self.dfs_of]
        hu = nc < self.node_num_mut
        nc_pos = nc > 0
        leaf = self.is_leaf
        valid = (self.is_root_mask
                 | (leaf & nc_pos)
                 | (~leaf & hu & nc_pos)
                 | (~leaf & ~hu)) & self.active
        s = np.where(valid, score, 1 << 30)
        best = int(s.min())
        is_best = valid & (score == best)
        num_best = int(is_best.sum())
        leaves = np.where(is_best, self.num_leaves, -1)
        is_best2 = is_best & (self.num_leaves == leaves.max())
        cand = np.nonzero(is_best2)[0]
        if len(cand) == 1:
            best_slot = int(cand[0])
        elif self._ranks_dirty and len(cand) <= 512:
            # max BFS rank without the global rank sweep: BFS order is
            # (level, root-path chain of child keys) lexicographic
            best_slot = int(max(cand.tolist(), key=self._bfs_chain_key))
        else:
            rank = np.where(is_best2, self.bfs_rank, -1)
            best_slot = int(np.argmax(
                (self.bfs_rank == rank.max()) & is_best2))
        if full:
            return (best, best_slot, num_best, bool(hu[best_slot]),
                    is_best, hu)
        return best, best_slot, num_best, bool(hu[best_slot])

    def _bfs_chain_key(self, slot: int):
        """Sort key equal to BFS order: (level, child-key chain from the
        root).  Within a level, BFS sorts by (parent's BFS order, child
        key); inductively that is the lexicographic chain order."""
        chain = []
        s = int(slot)
        while True:
            p = int(self.parent[s])
            if p == s:
                break
            chain.append(int(self.child_key[s]))
            s = p
        chain.reverse()
        return (int(self.level[slot]), tuple(chain))

    def _clade_dfs(self, clades):
        """DFS-ordered padded device copies of the per-annotation
        propagated clade-id arrays ((A, N) self / parent variants); cached
        per epoch like _dfs_meta (invalidated on flush — the caller grows
        the host arrays to N first)."""
        cached = getattr(self, "_clade_dfs_cache", None)
        if cached is not None:
            return cached
        clade_self, clade_par, n_clades = clades
        n_pad, N, o = self.n_pad, self.N, self.dfs_order
        A = len(clade_self)

        def padded(rows):
            out = np.zeros((A, n_pad), np.int32)
            for a in range(A):
                out[a, :N] = rows[a][o]
            return jnp.asarray(out)

        cache = (padded(clade_self), padded(clade_par), int(n_clades))
        self._clade_dfs_cache = cache
        return cache

    def place_arrays(self, pos, gval, kmiss, with_second: bool = False,
                     clades=None):
        """Device-reduced placement of pre-sparsified samples: returns
        (best_score [B], best_slot [B], num_best [B], hu_best [B]).

        with_second=True returns instead a pair of 4-tuples: the winner
        and the winner-row-masked runner-up (used by the exact-sequential
        serving driver; not composed with the mesh path).

        clades=(clade_self [A, N], clade_par [A, N], n_clades) appends a
        per-sample tie-set clade histogram [A, n_clades, B] as the last
        element of the returned tuple (-D detailed clades; not composed
        with the mesh path)."""
        return self.place_arrays_finish(
            self.place_arrays_begin(pos, gval, kmiss,
                                    with_second=with_second,
                                    clades=clades))

    def place_arrays_grouped(self, pos, gval, kmiss, sgn,
                             gpos, ggval, gkmiss, gsgn, grp_of,
                             closure=None, with_second: bool = False):
        """Exact placement scoring via the SHARED-ANCESTRY decomposition
        (ops/interval.interval_place_flatgrp_dev): group rows carry entry
        lists shared by many samples (expanded/scattered once per group),
        sample rows carry only signed residuals, grp_of maps samples to
        hierarchical anchors whose chain sums resolve in one closure
        matmul.  Bit-identical to place_arrays on the reconstructed full
        entry sets (tests/test_bigmat.py).  Real pandemic batches carry
        87.8% duplicate scatter events (bench phase real_batch_dedup).  Build
        inputs with group_ancestral_batch (EPP/uncertainty bulk
        re-scoring, reference usher_mapper re-scoring of existing
        leaves).

        Requires an overlay-free epoch (no incremental appends) and no
        mesh; one-shot bulk scoring is the target workload."""
        self._flush()
        if self._ov is not None:
            raise ValueError("grouped scoring requires an overlay-free "
                             "epoch (score before incremental appends)")
        if self.mesh is not None:
            raise ValueError("grouped scoring is not composed with the "
                             "mesh path")
        from ..ops import interval as iv
        B, G = pos.shape[0], gpos.shape[0]
        meta = self._dfs_meta(spr=False)
        margs = (meta["num_mut"], meta["is_leaf"], meta["is_root"],
                 meta["active"], meta["num_leaves"], meta["bfs_rank"])
        allpos = np.concatenate([pos.reshape(-1), gpos.reshape(-1)])
        e = allpos < self.P
        if e.any():
            cnts = self.csc_ptr[allpos[e] + 1] - self.csc_ptr[allpos[e]]
            mx = int(cnts.max())
        else:
            mx = 0
        mc = 32
        while mc < mx:
            mc = mc * 3 // 2
        if mc > 8192:
            raise ValueError(f"column occupancy {mx} exceeds the device "
                             f"expansion bound; use place_arrays")
        b_pad = 8
        while b_pad < B:
            b_pad *= 2
        g_pad = 8
        while g_pad < G:
            g_pad *= 2

        # FLAT entry-list packing: one row per real entry with its target
        # scan column — no [B, K] rectangle, one expansion/scatter/scan
        # pass for residuals and groups alike (a two-batch formulation
        # pays the fixed per-pass cost twice)
        def flat(p, gv, km, sg, col_of_row):
            m = p < self.P
            rows, ks = np.nonzero(m)
            return (p[rows, ks], gv[rows, ks], km[rows, ks],
                    sg[rows, ks], col_of_row[rows])

        rcols = np.arange(B, dtype=np.int32)
        gcols = b_pad + np.arange(G, dtype=np.int32)
        parts = [flat(pos.astype(np.int32), gval, kmiss, sgn, rcols),
                 flat(gpos.astype(np.int32), ggval, gkmiss, gsgn, gcols)]
        epos = np.concatenate([a[0] for a in parts])
        egval = np.concatenate([a[1] for a in parts])
        ekmiss = np.concatenate([a[2] for a in parts])
        esgn = np.concatenate([a[3] for a in parts])
        ecol = np.concatenate([a[4] for a in parts]).astype(np.int32)
        E = len(epos)
        e_pad = 512
        while e_pad < E:
            e_pad *= 2
        pd = e_pad - E
        epos = np.concatenate([epos, np.full(pd, self.P, np.int32)])
        egval = np.concatenate([egval, np.zeros(pd, np.uint8)])
        ekmiss = np.concatenate([ekmiss, np.zeros(pd, bool)])
        esgn = np.concatenate([esgn, np.ones(pd, np.int8)])
        ecol = np.concatenate([ecol, np.zeros(pd, np.int32)])

        grp_p = np.zeros(b_pad, np.int32)
        grp_p[:B] = grp_of
        cl_p = np.eye(g_pad, dtype=np.float32)
        if closure is not None:
            cl_p[:closure.shape[0], :closure.shape[1]] = closure
        csc = self._csc_dev()
        out = iv.interval_place_flatgrp_dev(
            *csc,
            jnp.asarray(epos.reshape(-1, 1)),
            jnp.asarray(egval.reshape(-1, 1)),
            jnp.asarray(ekmiss.reshape(-1, 1)),
            jnp.asarray(esgn.reshape(-1, 1)),
            jnp.asarray(ecol), jnp.asarray(grp_p), jnp.asarray(cl_p),
            meta["base"], meta["nc_base"], *margs,
            self.n_pad, b_pad, g_pad, mc, second=with_second)
        return self.place_arrays_finish(
            ("dev", (out, None, B, with_second, self.dfs_order, self.N)))

    def group_ancestral_batch(self, slots, min_group: int = 2,
                              gcap: int = 0):
        """Shared-ancestry inputs for place_arrays_grouped from a batch of
        EXISTING node slots (re-placement workloads: the sample set is the
        tree's own leaves, whose genotypes share every root-path mutation
        above their batch LCAs).

        HIERARCHICAL anchor forest: anchors are the LCA-compressed virtual
        tree's nodes covering >= min_group batch slots (closed under the
        virtual parent relation).  Each anchor's group row carries only
        the signed DELTA of its ancestral entry set vs its parent
        anchor's; the device resolves full chain sums with one [n_pad, G]
        x [G, G] closure matmul (ops/interval.py) — so a deep stem's
        mutations expand ONCE regardless of how many sub-anchors hang
        below it.  Sample rows carry the signed residual vs their own
        anchor's full set: +(col, value) for entries the anchor lacks,
        -(col, anchor value) where the below-path overrides one
        (back-mutations) — an exact linear split of the entry multiset.

        Returns (pos, gval, kmiss, sgn, gpos, ggval, gkmiss, grp_of,
        closure)."""
        self._flush()
        slots = [int(s) for s in slots]
        B = len(slots)
        parent = self.parent
        dfs_of, dfs_end_of = self.dfs_of, self.dfs_end_of
        level = self.level

        def lca(a, b):
            while level[a] > level[b]:
                a = int(parent[a])
            while level[b] > level[a]:
                b = int(parent[b])
            while a != b:
                a = int(parent[a])
                b = int(parent[b])
            return a

        uniq_slots = sorted(set(slots), key=lambda s: dfs_of[s])
        kept = set(uniq_slots)
        for a, b in zip(uniq_slots, uniq_slots[1:]):
            kept.add(lca(a, b))
        vnodes = sorted(kept, key=lambda s: dfs_of[s])
        vidx = {v: i for i, v in enumerate(vnodes)}
        vpar = [-1] * len(vnodes)
        stack: list[int] = []
        for i, v in enumerate(vnodes):
            d = dfs_of[v]
            while stack and not (dfs_of[vnodes[stack[-1]]] <= d
                                 < dfs_end_of[vnodes[stack[-1]]]):
                stack.pop()
            vpar[i] = stack[-1] if stack else -1
            stack.append(i)
        counts = [0] * len(vnodes)
        for s in slots:
            counts[vidx[s]] += 1
        for i in range(len(vnodes) - 1, -1, -1):
            if vpar[i] >= 0:
                counts[vpar[i]] += counts[i]
        is_anchor = [counts[i] >= min_group for i in range(len(vnodes))]

        def anchor_vi(i):
            """Deepest anchor at-or-above virtual node i (-1 if none)."""
            while i >= 0 and not is_anchor[i]:
                i = vpar[i]
            return i

        anchor_of = {}   # virtual index -> anchor virtual index
        for s in set(slots):
            anchor_of[vidx[s]] = anchor_vi(vidx[s])
        # ALL qualifying anchors, not just directly-used ones: counts are
        # monotone up the virtual tree, so this set is closed under the
        # parent-anchor relation — every chain ancestor holds its delta
        # row and the closure matmul telescopes exactly
        a_list = [i for i in range(len(vnodes)) if is_anchor[i]]
        if not a_list:
            # batch too small/diverse for any shared anchor: one empty
            # group keeps the call shape valid
            gid_of = np.zeros(B, np.int32)
            kr = 1
            closure = np.eye(1, dtype=np.float32)
            grp_rows = [[]]
        else:
            gid = {a: i for i, a in enumerate(a_list)}
            gid_of = np.array(
                [gid[anchor_of[vidx[s]]] if anchor_of[vidx[s]] >= 0 else 0
                 for s in slots], np.int32)
            closure = np.zeros((len(a_list), len(a_list)), np.float32)
            for a, g in gid.items():
                x = a
                while x >= 0:
                    if is_anchor[x]:
                        closure[gid[x], g] = 1.0
                    x = vpar[x]

        def anc_entries(slot):
            """Nearest CSR value per column from slot up; non-ref only."""
            seen: dict[int, int] = {}
            x = slot
            while True:
                for j in range(int(self.mut_ptr[x]),
                               int(self.mut_ptr[x + 1])):
                    c = int(self.mut_col[j])
                    if c not in seen:
                        seen[c] = int(self.mut_mut[j])
                p = int(parent[x])
                if p == x:
                    break
                x = p
            return {c: v for c, v in seen.items() if v != int(self.ref[c])}

        def delta_rows(su, sp_set):
            """Signed entry delta turning set(parent) into set(u)."""
            gu = anc_entries(su)
            row = []
            for c, v in gu.items():
                if sp_set.get(c) != v:
                    row.append((c, v, 1))
            for c, vp in sp_set.items():
                if gu.get(c) != vp:
                    row.append((c, vp, -1))
            return gu, row

        if a_list:
            a_sets: list[dict] = [None] * len(a_list)
            grp_rows = [None] * len(a_list)
            for g, a in enumerate(a_list):   # parents precede children
                pa = anchor_vi(vpar[a]) if vpar[a] >= 0 else -1
                p_set = a_sets[gid[pa]] if pa >= 0 else {}
                a_sets[g], grp_rows[g] = delta_rows(vnodes[a], p_set)

        def residual(s, a_slot, ga):
            below: dict[int, int] = {}
            x = s
            while x != a_slot:
                for j in range(int(self.mut_ptr[x]),
                               int(self.mut_ptr[x + 1])):
                    c = int(self.mut_col[j])
                    if c not in below:
                        below[c] = int(self.mut_mut[j])
                x = int(parent[x])
            row = []
            for c, v in below.items():
                ea = ga.get(c)
                if v != int(self.ref[c]) and v != ea:
                    row.append((c, v, 1))
                if ea is not None and ea != v:
                    row.append((c, ea, -1))
            return row

        if a_list:
            res_rows = [residual(s, vnodes[a_list[gid_of[i]]],
                                 a_sets[gid_of[i]])
                        for i, s in enumerate(slots)]
        else:
            full = [anc_entries(s) for s in slots]
            res_rows = [[(c, v, 1) for c, v in sorted(f.items())]
                        for f in full]

        def pack(rows, width):
            R = len(rows)
            pos = np.full((R, width), self.P, np.int32)
            gv = np.zeros((R, width), np.uint8)
            sg = np.ones((R, width), np.int8)
            for i, row in enumerate(rows):
                for k, (c, v, sgn_v) in enumerate(row):
                    pos[i, k] = c
                    gv[i, k] = v
                    sg[i, k] = sgn_v
            return pos, gv, np.zeros((R, width), bool), sg

        # straggler privatization: a sample with no shared anchor (alone
        # in its lineage within this batch) keeps a near-full residual,
        # and the rectangular [B, K_res] grid charges EVERY sample for
        # the worst row — move such residuals into a PRIVATE anchor
        # column chained under the sample's current anchor (column copy
        # in the closure); the gcap splitter below then bounds its width
        # like any other group row
        if a_list:
            rcap = 2 * gcap if gcap > 0 else 0
            if rcap:
                Gr0 = len(grp_rows)
                movers = [(i, int(gid_of[i]), row)
                          for i, row in enumerate(res_rows)
                          if len(row) > rcap]
                if movers:
                    G2 = Gr0 + len(movers)
                    cl2 = np.zeros((G2, G2), np.float32)
                    cl2[:Gr0, :Gr0] = closure
                    for q, (i, g_old, row) in enumerate(movers):
                        gn = Gr0 + q
                        cl2[:Gr0, gn] = closure[:Gr0, g_old]
                        cl2[gn, gn] = 1.0
                        grp_rows.append(row)
                        gid_of[i] = gn
                        res_rows[i] = []
                    closure = cl2

        # cap group-row width: a long delta (a deep lineage stem) would
        # rectangularize the whole [G, K_grp] grid — split it into a
        # CHAIN of pseudo-anchor rows instead; a pseudo row sits between
        # parent(g) and g on every chain through g, so its closure row is
        # a copy of g's (its entries join exactly the sums g's do)
        if a_list and gcap > 0:
            Gr = len(grp_rows)
            extra_rows, extra_src = [], []
            for g in range(Gr):
                row = grp_rows[g]
                if len(row) > gcap:
                    segs = [row[i:i + gcap]
                            for i in range(0, len(row), gcap)]
                    grp_rows[g] = segs[0]
                    for sgm in segs[1:]:
                        extra_rows.append(sgm)
                        extra_src.append(g)
            if extra_rows:
                G2 = Gr + len(extra_rows)
                cl2 = np.zeros((G2, G2), np.float32)
                cl2[:Gr, :Gr] = closure
                for q, g in enumerate(extra_src):
                    cl2[Gr + q, :Gr] = closure[g, :Gr]
                closure = cl2
                grp_rows = grp_rows + extra_rows

        kr = max((len(r) for r in res_rows), default=0) or 1
        kg = max((len(g) for g in grp_rows), default=0) or 1
        pos, gval, kmiss, sgn = pack(res_rows, kr)
        gpos, ggval, gkmiss, gsgn = pack(grp_rows, kg)
        return (pos, gval, kmiss, sgn, gpos, ggval, gkmiss, gsgn,
                gid_of, closure)

    def place_arrays_finish(self, handle):
        """Block on a place_arrays_begin handle and unpack.  The DFS-row
        mapping is the one captured at dispatch time — flushes between
        begin and finish (the pipelined serving loop) don't corrupt it."""
        kind, payload = handle
        if kind == "dedup":
            h2, inv, with_second, has_hist = payload
            res = self.place_arrays_finish(h2)

            def remap4(t):
                return tuple(np.asarray(x)[inv] for x in t)
            if with_second and has_hist:
                return (remap4(res[0]), remap4(res[1]),
                        res[2][:, :, inv])
            if with_second:
                return remap4(res[0]), remap4(res[1])
            if has_hist:
                return (*remap4(res[:4]), res[4][:, :, inv])
            return remap4(res)
        if kind == "done":
            return payload
        out, hist, B, with_second, dfs_order, N = payload
        # ONE host transfer for all outputs: each np.asarray is a
        # separate device-to-host round trip
        packed = np.asarray(jnp.stack(
            [o.astype(jnp.int32) for o in out]))
        res = self._unpack_place(packed, B, with_second,
                                 dfs_order=dfs_order, N=N)
        if hist is None:
            return res
        hist_np = np.asarray(hist)[:, :, :B]
        return (res + (hist_np,) if with_second else (*res, hist_np))

    def place_arrays_begin(self, pos, gval, kmiss,
                           with_second: bool = False, clades=None,
                           _dedup: bool = True):
        """Dispatch a placement batch WITHOUT blocking on the result
        (jax dispatch is asynchronous): returns a handle for
        place_arrays_finish.  The serving driver overlaps the next
        batch's device scoring with the current batch's host corrections
        (the enqueue-ahead discipline of the headline bench; reference
        leader pipelining, place_sample.cpp:450-584).  Paths that cannot
        dispatch async (mesh, oversized column occupancy) resolve
        synchronously into the handle.

        Exact-duplicate samples are scored once and fanned back out:
        snapshot scoring is per-sample independent, and real pandemic
        batches carry many identical variant sets (36.7% of the
        reference fixture's 422 genotype columns duplicate another)."""
        B0 = pos.shape[0]
        if _dedup and B0 > 1 and self.mesh is None:
            packed = np.concatenate(
                [pos.astype(np.int64), gval.astype(np.int64),
                 kmiss.astype(np.int64)], axis=1)
            _u, idx, inv = np.unique(packed, axis=0, return_index=True,
                                     return_inverse=True)
            if len(idx) < B0:
                h = self.place_arrays_begin(
                    pos[idx], gval[idx], kmiss[idx],
                    with_second=with_second, clades=clades,
                    _dedup=False)
                return ("dedup", (h, inv.reshape(-1), with_second,
                                  clades is not None))
        self._flush()
        from ..ops import interval as iv
        B = pos.shape[0]
        meta = self._dfs_meta(spr=False)
        margs = (meta["num_mut"], meta["is_leaf"], meta["is_root"],
                 meta["active"], meta["num_leaves"], meta["bfs_rank"])
        if (with_second or clades is not None) and self.mesh is not None:
            raise ValueError("with_second/clades are not composed with "
                             "the mesh sharded path")
        ckw = {}
        if clades is not None:
            cs, cp, nclades = self._clade_dfs(clades)
            ckw = dict(clade_self_dfs=cs, clade_par_dfs=cp,
                       n_clades=nclades)
        if self.mesh is None:
            # device-expansion fast path: the CSC index is resident on the
            # device, so per-batch H2D is just the [B, K] entry arrays.
            # In a serving loop (appends pending/applied) mc comes from the
            # GLOBAL max column occupancy so consecutive batches share ONE
            # compiled program — per-batch shape drift means a recompile
            # (or a cached-executable reload) every batch.
            # One-shot scoring keeps the tighter per-batch bound (the
            # global max inflates the expansion ~35% at the 1M shape).
            if self._appended or self._pending:
                mx = int(np.diff(self.csc_ptr).max()) if self.P else 0
            else:
                e = pos < self.P
                cnts = self.csc_ptr[pos[e] + 1] - self.csc_ptr[pos[e]]
                mx = int(cnts.max()) if cnts.size else 0
            mc = 32
            while mc < mx:
                mc = mc * 3 // 2
            if mc <= 8192:
                b_pad = 8
                while b_pad < B:
                    b_pad *= 2
                if b_pad != B:
                    padn = b_pad - B
                    pos = np.concatenate(
                        [pos, np.full((padn, pos.shape[1]), self.P,
                                      pos.dtype)], 0)
                    gval = np.concatenate(
                        [gval, np.zeros((padn, gval.shape[1]),
                                        gval.dtype)], 0)
                    kmiss = np.concatenate(
                        [kmiss, np.zeros((padn, kmiss.shape[1]), bool)], 0)
                if self._ov is not None:
                    *oev, _ = self._events(pos, gval, kmiss, spr=False,
                                           skip_base=True)
                else:
                    z = (np.zeros(0, np.int32),) * 3
                    oev = [*z, *z]
                csc = self._csc_dev()
                if clades is None and os.environ.get(
                        "USHER_JAX_SEG", "0") != "0":
                    # segment-query kernel: O(events * log N), no
                    # [n_pad, b_pad] matrices (ops/interval.py).  OPT-IN:
                    # bit-identical to the full-matrix kernel but its
                    # sparse-table walks are random-gather-bound; whether
                    # it beats the full-matrix scatter+scan path on the GPU
                    # is not measured yet
                    ovr, ovv = iv.pad_overlay_by_sample(
                        np.asarray(oev[0]), np.asarray(oev[1]),
                        np.asarray(oev[2]), b_pad, self.n_pad)
                    ovnr, ovnv = iv.pad_overlay_by_sample(
                        np.asarray(oev[3]), np.asarray(oev[4]),
                        np.asarray(oev[5]), b_pad, self.n_pad)
                    # true per-sample pair bound: the [K, mc] expansion is
                    # mostly padding, and the kernel's sort/table phases
                    # run at O(ecap) after compaction
                    if self.P:
                        pe = np.minimum(pos, self.P - 1).astype(np.int64)
                        cnts = self.csc_ptr[pe + 1] - self.csc_ptr[pe]
                        mx_pairs = int(np.where(pos < self.P, cnts, 0)
                                       .sum(axis=1).max())
                    else:
                        mx_pairs = 0
                    ecap = 32
                    while ecap < mx_pairs:
                        ecap *= 2
                    out = iv.interval_place_seg_dev(
                        *csc, jnp.asarray(pos.astype(np.int32)),
                        jnp.asarray(gval), jnp.asarray(kmiss),
                        jnp.asarray(ovr), jnp.asarray(ovv),
                        jnp.asarray(ovnr), jnp.asarray(ovnv),
                        meta["base"], meta["nc_base"], *margs,
                        self.n_pad, b_pad, mc, ecap,
                        second=with_second)
                    return ("dev", (out, None, B, with_second,
                                    self.dfs_order, self.N))
                # large bucket: the overlay grows every batch in a serving
                # loop, and each bucket crossing is a new jit shape
                ovp = iv.pad_events(*oev[:3], self.n_pad, bucket=4096)
                ovn = iv.pad_events(*oev[3:6], self.n_pad, bucket=4096)
                out = iv.interval_place_dev(
                    *csc, jnp.asarray(pos.astype(np.int32)),
                    jnp.asarray(gval), jnp.asarray(kmiss),
                    *(jnp.asarray(a) for a in ovp),
                    *(jnp.asarray(a) for a in ovn),
                    meta["base"], meta["nc_base"], *margs,
                    self.n_pad, b_pad, mc, second=with_second, **ckw)
                hist = None
                if clades is not None:
                    *out, hist = out
                return ("dev", (out, hist, B, with_second,
                                self.dfs_order, self.N))
        *ev, add0 = self._events(pos, gval, kmiss, spr=False)
        b_pad, evp, ncp = self._batch_shapes(B, ev[:3], ev[3:6])
        add0p = np.zeros(b_pad, np.int32)
        add0p[:B] = add0
        if self.mesh is not None:
            fn = iv._place_sharded_fn(self.mesh, self.mesh.axis_names[0],
                                      self.n_pad, b_pad // self.mesh.size)
            out = fn(*(jnp.asarray(a) for a in evp),
                     *(jnp.asarray(a) for a in ncp),
                     meta["base"], meta["nc_base"], jnp.asarray(add0p),
                     *margs)
            if not all(getattr(o, "is_fully_addressable", True)
                       for o in out):
                # multi-process mesh: one allgather per output (eager
                # jnp.stack cannot pack non-addressable global arrays)
                from ..parallel.distributed import fetch
                packed = np.stack([fetch(o).astype(np.int32) for o in out])
                return ("done", self._unpack_place(packed, B, with_second))
        else:
            out = iv.interval_place(
                *(jnp.asarray(a) for a in evp),
                *(jnp.asarray(a) for a in ncp),
                meta["base"], meta["nc_base"], jnp.asarray(add0p), *margs,
                self.n_pad, b_pad, second=with_second, **ckw)
        hist = None
        if clades is not None and self.mesh is None:
            *out, hist = out
        return ("dev", (out, hist, B, with_second,
                        self.dfs_order, self.N))

    def _unpack_place(self, packed, B, with_second, dfs_order=None,
                      N=None):
        if dfs_order is None:
            dfs_order, N = self.dfs_order, self.N

        def four(rows):
            best, best_row, num_best, hu = rows
            best_slot = dfs_order[np.minimum(best_row[:B], N - 1)]
            return (best[:B].astype(np.int32), best_slot.astype(np.int32),
                    num_best[:B].astype(np.int32), hu[:B].astype(bool))
        if not with_second:
            return four(packed[:4])
        return four(packed[:4]), four(packed[4:8])


def _ranges(counts):
    """[0..c0-1, 0..c1-1, ...] for a vector of counts (vectorized)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def check_chain_consistency(T) -> int:
    """Count mutations whose par_nuc differs from the path state above them
    (0 on any well-formed MAT; BigMAT's telescoped aggregates require 0).
    Debug helper for externally-sourced trees."""
    bad = 0
    stack = [(T.root, {})]
    while stack:
        node, state = stack.pop()
        new_state = state
        if node.mutations:
            new_state = dict(state)
            for m in node.mutations:
                if m.position < 0:
                    continue
                expect = state.get(m.position, m.ref_nuc)
                if node.parent is not None and m.par_nuc != expect:
                    bad += 1
                new_state[m.position] = m.mut_nuc
        for ch in node.children:
            stack.append((ch, new_state))
    return bad

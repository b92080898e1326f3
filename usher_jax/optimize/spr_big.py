"""CSR-backed SPR move search: the pandemic-scale MoveFinder.

The dense MoveFinder holds st/stp [N, P] on device — impossible at the
reference's >2M-leaf x ~30k-site scale.  This finder scores each source's
subtree Fitch mask as a SPARSE entry set (its deviations from the reference
row) through the DFS-interval engine (ops/interval.py): one scatter + one
segmented cumsum per chunk, with the radius bound computed on device as a
nested-interval count (the LCA level of (src, dst) for every dst is the
number of src-ancestor DFS intervals containing dst, minus one) and the
tie-broken argmin reduced on device — only O(chunk) vectors cross the
boundary.  Replaces both the reference's per-source pointer walks
(Profitable_Moves_Enumerators.hpp:166) and round 2's host O(depth*N)
radius loop.

Results are bit-identical to MoveFinder.find_moves (tested).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.bigmat import BigMAT
from ..core.tree import Tree
from .spr import Move, MoveFinder, collapse_bonus


def _fetch3(out):
    """ONE host transfer for the three per-chunk result vectors (each
    np.asarray is a separate device-to-host round trip).  Global arrays
    spanning processes go through the allgathering fetch instead."""
    if not all(getattr(o, "is_fully_addressable", True) for o in out):
        from ..parallel.distributed import fetch
        return tuple(fetch(o).astype(np.int32) for o in out)
    packed = np.asarray(jnp.stack([out[0].astype(jnp.int32),
                                   out[1].astype(jnp.int32),
                                   out[2].astype(jnp.int32)]))
    return packed[0], packed[1], packed[2]



class BigMoveFinder(MoveFinder):
    """MoveFinder drop-in whose scoring path never materializes [N, P]
    state matrices on device."""

    def __init__(self, T: Tree, states: np.ndarray, masks: np.ndarray,
                 ref_row: np.ndarray, bfs, parent: np.ndarray,
                 chunk: int = 128, positions=None, mesh=None, csr=None):
        """mesh: optional 1-D jax Mesh — shards the SOURCE batch axis of the
        interval-engine SPR scorer over devices with the CSR metadata
        replicated (the device-mesh analog of the reference's MPI SPR work
        distributor, optimize_tree.cpp:165-252).

        csr: optional (node_idx, col, par_nib, mut_nib) arrays (the
        streamed FS emits them, fitch.py run_rewrite_streamed) — builds the
        CSR snapshot directly, skipping the O(mutations) Python from_tree
        walk that dominated per-iteration host time at pandemic scale."""
        # host bookkeeping only — never upload [N, P] state matrices
        self.T = T
        self.bfs = bfs
        self.parent = parent
        self.mesh = mesh
        self.chunk = chunk * (mesh.size if mesh is not None else 1)
        n = len(bfs)
        self.n = n
        self.masks = masks   # dense [n, P] uint8 OR MaskDeviations
        self.ref_row = ref_row

        T.depth_first_expansion()
        self.bfs_index = {id(node): i for i, node in enumerate(bfs)}
        self.dfs_idx = np.array([node.dfs_idx for node in bfs],
                                dtype=np.int64)
        self.dfs_end = np.array([node.dfs_end_idx for node in bfs],
                                dtype=np.int64)
        self.level = np.array([node.level for node in bfs], dtype=np.int32)

        self.adj: list[list[int]] = [[] for _ in range(n)]
        for i in range(1, n):
            self.adj[i].append(int(parent[i]))
            self.adj[parent[i]].append(i)

        if positions is None:
            positions = np.arange(masks.shape[1], dtype=np.int64)
        if csr is not None:
            node_a, col_a, par_a, mut_a = csr
            order = np.argsort(node_a, kind="stable")
            counts = np.bincount(node_a, minlength=n).astype(np.int64)
            mut_ptr = np.zeros(n + 1, dtype=np.int64)
            mut_ptr[1:] = np.cumsum(counts)
            self.big = BigMAT(parent.astype(np.int32), mut_ptr,
                              col_a[order].astype(np.int32),
                              par_a[order], mut_a[order],
                              positions, ref_row)
            self.big._nodes = bfs
            import os
            if os.environ.get("USHER_JAX_CHECK_CSR"):
                # invariant checker: array-maintained triplets must equal a
                # from-scratch from_tree build (per-node column/allele sets)
                chk = BigMAT.from_tree(T, positions, ref_row)
                for i in range(n):
                    a = sorted(zip(
                        self.big.mut_col[self.big.mut_ptr[i]:
                                         self.big.mut_ptr[i + 1]].tolist(),
                        self.big.mut_par[self.big.mut_ptr[i]:
                                         self.big.mut_ptr[i + 1]].tolist(),
                        self.big.mut_mut[self.big.mut_ptr[i]:
                                         self.big.mut_ptr[i + 1]].tolist()))
                    b = sorted(zip(
                        chk.mut_col[chk.mut_ptr[i]:
                                    chk.mut_ptr[i + 1]].tolist(),
                        chk.mut_par[chk.mut_ptr[i]:
                                    chk.mut_ptr[i + 1]].tolist(),
                        chk.mut_mut[chk.mut_ptr[i]:
                                    chk.mut_ptr[i + 1]].tolist()))
                    assert a == b, (
                        f"CHECK_CSR: node {i} triplets diverge from "
                        f"from_tree: {a} vs {b}")
        else:
            self.big = BigMAT.from_tree(T, positions, ref_row)
        self.big.mesh = mesh
        # BigMAT slots are BFS order == our bfs indexing; verify cheaply
        if not np.array_equal(self.big.parent, parent.astype(np.int32)):
            raise AssertionError("BigMAT BFS order diverged from FitchEngine")
        self._num_leaves_h = np.asarray(self.big.num_leaves)
        self._bfs_rank_h = np.arange(self.n, dtype=np.int32)

    def _mc_for(self, pos):
        """Column-occupancy bound for device-side expansion (bucketed); None
        when too wide (host-event fallback)."""
        big = self.big
        e = pos < big.P
        if not e.any():
            return 32
        cnts = big.csc_ptr[pos[e] + 1] - big.csc_ptr[pos[e]]
        mc = 32
        mx = int(cnts.max())
        while mc < mx:
            mc = mc * 3 // 2
        return mc if mc <= 8192 else None

    def _dev_of(self, si):
        """(cols, mask values) where node si's Fitch mask deviates from the
        reference row -- from a dense masks matrix or MaskDeviations."""
        if isinstance(self.masks, np.ndarray):
            cols = np.nonzero(self.masks[si] != self.ref_row)[0]
            return cols, self.masks[si][cols]
        return self.masks.deviations(si)

    def find_moves(self, radius: int, sources=None, log=None) -> list[Move]:
        from ..ops import interval as iv
        big = self.big
        n = self.n
        bfs = self.bfs
        if sources is None:
            sources = [i for i in range(1, n)]
        moves: list[Move] = []
        max_level = int(self.level.max()) if n else 0
        eff_radius = radius if radius > 0 else 2 * max_level + 2
        meta = big._dfs_meta(spr=True)
        n_pad = big.n_pad
        dfs_of = big.dfs_of
        dfs_end_of = big.dfs_end_of

        for c0 in range(0, len(sources), self.chunk):
            idxs = sources[c0:c0 + self.chunk]
            B = len(idxs)
            b_pad = 8
            while b_pad < max(B, self.chunk):
                b_pad *= 2
            oldcost = np.zeros(B, dtype=np.int64)
            # sparse entries: deviations of each source's Fitch mask from ref
            devs = []
            max_k = 1
            anc_rows = []   # (dfs row, sample) per proper ancestor
            src_level = np.zeros(b_pad, dtype=np.int32)
            src_lo = np.full(b_pad, n_pad, dtype=np.int32)
            src_hi = np.full(b_pad, n_pad, dtype=np.int32)
            src_parent_row = np.full(b_pad, -1, dtype=np.int32)
            for b, si in enumerate(idxs):
                node = bfs[si]
                oldcost[b] = len(node.mutations) + collapse_bonus(node)
                cols, vals = self._dev_of(si)
                devs.append((cols, vals))
                max_k = max(max_k, len(cols))
                p = int(self.parent[si])
                while True:
                    anc_rows.append((dfs_of[p], dfs_end_of[p], b))
                    if p == 0:
                        break
                    p = int(self.parent[p])
                # BigMAT levels (0-based hops to root), matching meta["level"]
                # and the ancestor-count lca — host Tree levels are 1-based
                src_level[b] = big.level[si]
                src_lo[b] = dfs_of[si]
                src_hi[b] = dfs_end_of[si]
                src_parent_row[b] = dfs_of[int(self.parent[si])]

            # bucket the entry-slot axis (a jit dim on the device-
            # expansion path) so chunk-to-chunk deviation-count drift
            # doesn't multiply compilations
            K = 64
            while K < max_k:
                K = K * 3 // 2
            pos = np.full((B, K), big.P, dtype=np.int32)
            gval = np.zeros((B, K), dtype=np.uint8)
            for b, (cols, vals) in enumerate(devs):
                pos[b, :len(cols)] = cols
                gval[b, :len(cols)] = vals
            kmiss = np.zeros((B, K), dtype=bool)

            ar = np.asarray(anc_rows, dtype=np.int32).reshape(-1, 3)
            cnt_idx = np.concatenate([ar[:, 0], ar[:, 1]])
            cnt_b = np.concatenate([ar[:, 2], ar[:, 2]])
            cnt_val = np.concatenate([np.ones(len(ar), np.int32),
                                      -np.ones(len(ar), np.int32)])
            margs = (meta["num_mut"], meta["is_root"], meta["active"],
                     meta["num_leaves"], meta["bfs_rank"], meta["level"])
            if self.mesh is not None:
                *ev, add0 = big._events(pos, gval, kmiss, spr=True)
                add0p = np.zeros(b_pad, np.int32)
                add0p[:B] = add0
                nd = self.mesh.size
                bl = b_pad // nd
                evp = iv.shard_events(ev[:3], nd, bl, n_pad)
                ncp = iv.shard_events(ev[3:6], nd, bl, n_pad)
                cntp = iv.shard_events((cnt_idx, cnt_b, cnt_val), nd, bl,
                                       n_pad, bucket=1024)
                fn = iv._spr_sharded_fn(self.mesh, self.mesh.axis_names[0],
                                        n_pad, bl)
                cost, row, hu = _fetch3(fn(
                    *(jnp.asarray(a) for a in evp),
                    *(jnp.asarray(a) for a in ncp),
                    *(jnp.asarray(a) for a in cntp),
                    meta["base"], meta["nc_base"], jnp.asarray(add0p),
                    *margs,
                    jnp.asarray(src_level), jnp.asarray(src_lo),
                    jnp.asarray(src_hi), jnp.asarray(src_parent_row),
                    jnp.int32(eff_radius)))
            else:
                cntp = iv.pad_events(cnt_idx, cnt_b, cnt_val, n_pad,
                                     bucket=1024)
                mc = self._mc_for(pos)
                # the expansion materializes [b_pad, K, mc] intermediates;
                # one exceedingly deviant source (near-root subtree mask)
                # can inflate K unboundedly — fall back to host events
                # (linear in actual deviations) past a memory budget
                if mc is not None and b_pad * pos.shape[1] * mc > (1 << 25):
                    mc = None
                if mc is not None:
                    # device-side expansion from the resident CSC index:
                    # per-chunk H2D is the [B, K] deviation arrays, not the
                    # expanded event streams
                    pos_p = np.full((b_pad, pos.shape[1]), big.P, np.int32)
                    pos_p[:B] = pos
                    gval_p = np.zeros((b_pad, gval.shape[1]), np.uint8)
                    gval_p[:B] = gval
                    csc = big._csc_dev()
                    cost, row, hu = _fetch3(iv.interval_spr_dev(
                        *csc, jnp.asarray(pos_p), jnp.asarray(gval_p),
                        *(jnp.asarray(a) for a in cntp),
                        meta["base"], meta["nc_base"], *margs,
                        jnp.asarray(src_level), jnp.asarray(src_lo),
                        jnp.asarray(src_hi), jnp.asarray(src_parent_row),
                        jnp.int32(eff_radius), n_pad, b_pad, mc))
                else:
                    *ev, add0 = big._events(pos, gval, kmiss, spr=True)
                    add0p = np.zeros(b_pad, np.int32)
                    add0p[:B] = add0
                    evp = iv.pad_events(*ev[:3], n_pad)
                    ncp = iv.pad_events(*ev[3:6], n_pad)
                    cost, row, hu = _fetch3(iv.interval_spr(
                        *(jnp.asarray(a) for a in evp),
                        *(jnp.asarray(a) for a in ncp),
                        *(jnp.asarray(a) for a in cntp),
                        meta["base"], meta["nc_base"], jnp.asarray(add0p),
                        *margs,
                        jnp.asarray(src_level), jnp.asarray(src_lo),
                        jnp.asarray(src_hi), jnp.asarray(src_parent_row),
                        jnp.int32(eff_radius), n_pad, b_pad))

            slot = big.dfs_order[np.minimum(row[:B], big.N - 1)]
            for b, si in enumerate(idxs):
                imp = int(oldcost[b]) - int(cost[b])
                if imp > 0 and cost[b] < (1 << 29):
                    d = int(slot[b])
                    moves.append(Move(
                        src=bfs[si], dst=bfs[d], improvement=imp,
                        sibling_split=bool(hu[b]) or bfs[d].is_leaf(),
                        src_interval=(int(self.dfs_idx[si]),
                                      int(self.dfs_end[si])),
                        dst_dfs=int(self.dfs_idx[d])))
        return moves

    # -- host-side mirror of the device mask/reduction (cross-check only) ----

    def _reduce(self, idxs, score, nc, nnm, radius):
        """Numpy mirror of interval_spr's device mask + reduction
        (optimize/spr.py:55-108 semantics); kept as the test oracle for the
        device path (tests/test_optimize.py)."""
        B = len(idxs)
        n = self.n
        has_unique = nc < nnm[None, :]
        nc_pos = nc > 0
        root_mask = np.zeros(n, dtype=bool)
        root_mask[0] = True
        # is_leaf passed as zeros in the dense scorer: leaves get
        # sibling-split via has_unique
        valid = (root_mask[None, :]
                 | (has_unique & nc_pos)
                 | (~has_unique))

        lvl = self.level
        ok = np.zeros((B, n), dtype=bool)
        for b, si in enumerate(idxs):
            # lca level for every dest: deepest src-ancestor containing it
            lca_lvl = np.full(n, -1, dtype=np.int32)
            p = int(self.parent[si])
            while True:
                inside = (self.dfs_idx[p] <= self.dfs_idx) & \
                         (self.dfs_idx < self.dfs_end[p])
                lca_lvl = np.maximum(lca_lvl,
                                     np.where(inside, lvl[p], -1))
                if p == 0:
                    break
                p = int(self.parent[p])
            dist = lvl + lvl[si] - 2 * lca_lvl
            row = dist <= radius
            in_sub = (self.dfs_idx >= self.dfs_idx[si]) & \
                     (self.dfs_idx < self.dfs_end[si])
            row &= ~in_sub
            row[int(self.parent[si])] = False
            ok[b] = row
        valid = valid & ok

        big_c = np.int64(1 << 30)
        s = np.where(valid, score.astype(np.int64), big_c)
        best = s.min(axis=1)
        is_best = valid & (score == best[:, None])
        leaves_masked = np.where(is_best, self._num_leaves_h[None, :], -1)
        best_leaves = leaves_masked.max(axis=1)
        is_best2 = is_best & (self._num_leaves_h[None, :]
                              == best_leaves[:, None])
        rank_masked = np.where(is_best2, self._bfs_rank_h[None, :], -1)
        best_rank = rank_masked.max(axis=1)
        best_slot = np.argmax(
            (self._bfs_rank_h[None, :] == best_rank[:, None]) & is_best2,
            axis=1)
        hu_best = has_unique[np.arange(B), best_slot]
        return best, best_slot.astype(np.int32), hu_best

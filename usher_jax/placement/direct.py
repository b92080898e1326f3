"""No-Tree direct placement: parsimony.pb -> arrays -> place -> outputs.

The standard drivers (placement/driver.py, placement/big_engine.py) keep a
host Python Tree alongside the device arrays — at the reference's >2M-leaf
public MAT that costs minutes to build and ~GBs to hold.  This driver runs
the core usher placement flow entirely over BigMAT arrays loaded by
io/pb_arrays.py: device batch scoring with the snapshot maintained by
O(delta) incremental appends, the host oracle + surgery semantics applied
through lightweight array-backed node views, and array-native writers for
placement_stats.tsv / final-tree.nh / mutation-paths.txt.

Placement is EXACT SEQUENTIAL (the reference classic-usher semantics:
every sample scored against the tree with all previous samples applied,
usher_common.cpp:310).  One device call scores the whole batch against
the frozen batch snapshot; per-sample results are then corrected on the
host in O(depth * K) by _BatchState: scores of pre-existing nodes are
invariant under placement surgery, so only the batch's new/modified nodes
(exact score rows via the telescoped base/F aggregate chains), validity
flips on split nodes, and num_leaves tie-break boosts on insertion
ancestors can change the outcome.  The provably-ambiguous cases (winner
was itself split earlier in the batch; multi-way snapshot tie after a
split re-leveled BFS ranks) fall back to an exact full host re-score
(BigMAT.place_one_host).  USHER_JAX_DIRECT_SEQ=1 forces the fallback for
every post-apply sample (the reference's literal per-sample loop) — the
two modes are asserted byte-identical in tests.

Byte-identical outputs to `usher --bigmat` on the same inputs (tested on
the reference smoke fixture).  Scope: the serving core (-i/-v/-d/-n,
thresholds, batching); flags needing host-Tree machinery (collapse,
subtrees, clades, -M/-p, condensed handling, pb save) stay on the Tree
drivers.

Reference semantics: usher_common.cpp:310-780 (loop), usher_mapper.cpp:
167-504 (oracle, via placement/mapper.py unchanged), usher_common.cpp:
652-765 (surgery).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np

from ..core.nuc import N as NUC_N
from ..core.tree import Mutation, MissingSample
from ..io.pb_arrays import load_mat_arrays
from ..io.vcf import read_vcf_sites
from ..utils.instrument import now_us, record_span, timeit
from .mapper import score_placement


def _err(*a):
    print(*a, file=sys.stderr)


class ArrayNode:
    """The minimal Node surface score_placement and the surgery logic touch,
    backed by BigMAT arrays + the driver's per-node deltas (including the
    current batch's not-yet-flushed appends)."""

    __slots__ = ("d", "slot")

    def __init__(self, d: "DirectPlacer", slot: int):
        self.d = d
        self.slot = int(slot)

    @property
    def parent(self):
        p = self.d.parent_slot_of(self.slot)
        return None if p == self.slot else ArrayNode(self.d, p)

    @property
    def mutations(self):
        return self.d.mutations_of(self.slot)

    def is_leaf(self) -> bool:
        return self.d.is_leaf_of(self.slot)

    @property
    def identifier(self) -> str:
        return self.d.name_of(self.slot)


class _BatchState:
    """Exact-sequential correction of device batch scores.

    The device scored every sample against the frozen snapshot S0.  Under
    placement surgery, every node of S0 keeps its exact score for every
    sample (surgery never changes an existing node's root-path state), so
    the tree-at-apply-time result differs from the snapshot result only
    through
      (a) nodes CREATED by earlier applies in the batch (new leaves, split
          internals) — exact score rows computed from the parent's score
          via the telescoped base/F aggregate chain (bigmat._precompute
          derivation) plus the per-entry correction terms of
          bigmat._events,
      (b) split nodes whose OWN mutation list shrank (validity / num_best
          flips; score unchanged),
      (c) num_leaves growth on insertion ancestors (tie-break only), and
      (d) BFS-rank re-leveling of nodes inside split subtrees (tie-break
          only; unidentifiable from the snapshot winner alone).
    (a)-(c) are handled exactly here; a sample is sent to the full host
    re-score fallback when the snapshot winner was itself split (its
    replacement region is unknown) or when (d) may apply (snapshot
    num_best > 1 after a split).  Mirrors the stale-retry discipline of
    the reference leader (place_sample.cpp:479-520) but with an exactness
    guarantee instead of tolerated divergence.
    """

    INF = np.int64(1) << 40

    def __init__(self, placer: "DirectPlacer", pos, gval, kmiss):
        big = placer.big
        self.placer = placer
        self.big = big
        self.N0 = big.N
        # frozen snapshot refs: _flush replaces (grows) every array, so
        # these keep pointing at the batch-scoring-time state even if a
        # fallback flushes mid-batch
        self.parent0 = big.parent
        self.base0 = big.base
        self.dfs_of0 = big.dfs_of
        self.dfs_end_of0 = big.dfs_end_of
        self.dfs_order0 = big.dfs_order
        self.nc_base0 = big.nc_base
        self.num_mut0 = big.node_num_mut
        self.num_leaves0 = big.num_leaves
        self.is_leaf0 = big.is_leaf
        self.child_key0 = big.child_key
        self.child_count0 = big.child_count
        self.mut_ptr0 = big.mut_ptr
        self.mut_col0 = big.mut_col
        self.mut_par0 = big.mut_par
        self.mut_mut0 = big.mut_mut
        # nodes created/split by PREVIOUS batches live in the driver's
        # _mut_delta overlay, not the base CSR; snapshot it (shallow copy —
        # applies replace, never mutate, the per-slot lists)
        self.mut_delta0 = dict(placer._mut_delta)
        self.ref = big.ref
        self.root_slot = big.root_slot
        # frozen CSC view for the flushless full-snapshot resolver:
        # csc_ptr/node/etc. are epoch-stable objects, but the dead bits
        # mutate in place as this batch's splits tombstone mutations
        self.csc_ptr0 = big.csc_ptr
        self.csc_node0 = big.csc_node
        self.csc_mut0 = big.csc_mut
        self.csc_par0 = big.csc_par
        self.csc_root0 = big.csc_root
        self.csc_eff0 = big.csc_eff
        self.csc_dead0 = (None if big.csc_dead is None
                          else big.csc_dead.copy())
        self.ov0 = big._ov
        self.num_leaves_arr0 = big.num_leaves
        self.active0 = big.active
        self.is_root0 = big.is_root_mask

        B = pos.shape[0]
        self.B = B
        e = pos < big.P
        eb, ek = np.nonzero(e)
        cols = pos[eb, ek].astype(np.int64)
        order = np.argsort(cols, kind="stable")
        self._ecol = cols[order]
        self._eb = eb[order].astype(np.int64)
        self._egv = gval[eb, ek][order].astype(np.int64)
        self._ekm = kmiss[eb, ek][order]
        gv, km = gval[eb, ek].astype(np.int64), kmiss[eb, ek]
        self.add0 = np.bincount(
            eb, weights=((~km) & ((gv & big.ref[cols]) == 0)
                         ).astype(np.int64),
            minlength=B).astype(np.int64)
        self._col_cache: dict[int, tuple] = {}

        # batch-local overlays (slot-keyed; survive mid-batch flushes)
        self.probes: dict[int, tuple] = {}   # old slot -> (srow, ncrow, V)
        self.mod: dict[int, int] = {}        # split-u slot -> candidate idx
        self.recs: dict[int, dict] = {}      # new slot -> record
        self.parent_over: dict[int, int] = {}
        self.childkey_over: dict[int, int] = {}
        self.childcount: dict[int, int] = {}
        self.leaf_boost: dict[int, int] = {}
        self.mod_muts: dict[int, list] = {}   # split-u -> current l1
        self.splits = False
        # leaf-count bounds of split subtrees holding UNPROBED old nodes
        # (re-leveled by the split => BFS tie-break no longer certifiable
        # against them unless the finalists out-leaf the bound)
        self.opaque: list[tuple] = []
        self.applies = 0
        self.fallbacks = 0
        self.fb_reasons: dict[str, int] = {}

        capc = 3 * B + 8   # a split adds up to 3 rows (x, s, Mod-u)
        self.cS = np.empty((capc, B), np.int64)
        self.cNC = np.empty((capc, B), np.int64)
        self.cslot = np.empty(capc, np.int64)
        self.cleaf = np.empty(capc, bool)
        self.cnum_mut = np.empty(capc, np.int64)
        self.cmod = np.zeros(capc, bool)
        self.cvalid0 = np.zeros((capc, B), bool)
        self.ncand = 0

    # --- entry lookups ------------------------------------------------------

    def _col_entries(self, col: int):
        """Samples with an entry at `col`: (sample_idx, gval, kmiss)."""
        got = self._col_cache.get(col)
        if got is None:
            lo = np.searchsorted(self._ecol, col)
            hi = np.searchsorted(self._ecol, col, side="right")
            got = (self._eb[lo:hi], self._egv[lo:hi], self._ekm[lo:hi])
            self._col_cache[col] = got
        return got

    # --- per-mutation correction terms (bigmat._events, spr=False) ----------

    def _d_range(self, col, ap, am):
        idx, gv, km = self._col_entries(col)
        if len(idx) == 0:
            return idx, None
        rk = int(self.ref[col])
        t1_am = ((~km) & ((gv & am) == 0)).astype(np.int64)
        t1_ap = ((~km) & ((gv & ap) == 0)).astype(np.int64)
        return idx, (t1_am - int(am != rk)) - (t1_ap - int(ap != rk))

    def _d_point(self, col, ap, am):
        idx, gv, km = self._col_entries(col)
        if len(idx) == 0:
            return idx, None
        rk = int(self.ref[col])
        matched = (gv & am) != 0
        a_eff = np.where(matched, am, ap)
        t1_bm = ((~km) & ((gv & a_eff) == 0)).astype(np.int64)
        t1_am = ((~km) & ((gv & am) == 0)).astype(np.int64)
        sub_bm = int(am != rk) if (rk & am) else int(ap != rk)
        return idx, (t1_bm - sub_bm) - (t1_am - int(am != rk))

    def _own_full(self, col, ap, am):
        """d_range + d_point: a branch mutation's contribution at the node
        carrying it, relative to the parent state."""
        idx, gv, km = self._col_entries(col)
        if len(idx) == 0:
            return idx, None
        rk = int(self.ref[col])
        matched = (gv & am) != 0
        a_eff = np.where(matched, am, ap)
        t1_bm = ((~km) & ((gv & a_eff) == 0)).astype(np.int64)
        t1_ap = ((~km) & ((gv & ap) == 0)).astype(np.int64)
        sub_bm = int(am != rk) if (rk & am) else int(ap != rk)
        return idx, (t1_bm - sub_bm) - (t1_ap - int(ap != rk))

    def _nc_row(self, triplets):
        """(num_common row [B], num_mut) over a node's own mutations."""
        nc = np.zeros(self.B, np.int64)
        nm = 0
        for (c, ap, am) in triplets:
            if am == ap:
                continue
            nm += 1
            base = 1 if (int(self.ref[c]) & am) else 0
            nc += base
            idx, gv, _km = self._col_entries(c)
            if len(idx):
                nc[idx] += ((gv & am) != 0).astype(np.int64) - base
        return nc, nm

    # --- snapshot probes ----------------------------------------------------

    def _snap_muts(self, slot: int):
        """SNAPSHOT own-branch mutation triplets of an S0 slot: the
        batch-start _mut_delta overlay where present (nodes touched by
        previous batches), else the raw base CSR."""
        delta = self.mut_delta0.get(slot)
        if delta is not None:
            return self.placer._triplets(delta)
        lo, hi = int(self.mut_ptr0[slot]), int(self.mut_ptr0[slot + 1])
        return [(int(self.mut_col0[k]), int(self.mut_par0[k]),
                 int(self.mut_mut0[k])) for k in range(lo, hi)]

    def _max_child_leaves(self):
        """max snapshot leaf count among each node's children (0 for
        leaves) — one vectorized pass, computed on first split."""
        got = getattr(self, "_mcl", None)
        if got is None:
            got = np.zeros(self.N0, np.int64)
            nonroot = np.arange(self.N0) != self.parent0[:self.N0]
            np.maximum.at(got, self.parent0[:self.N0][nonroot],
                          self.num_leaves0[:self.N0][nonroot])
            self._mcl = got
        return got

    def probe_path(self, u: int) -> None:
        """Exact snapshot (score, num_common) rows for u and every S0
        ancestor, all B samples at once.  V accumulates the range-part of
        the entry corrections down the root path (the same telescoping the
        device cumsum performs over DFS order)."""
        path = []
        s = int(u)
        while s not in self.probes:
            path.append(s)
            p = int(self.parent0[s])
            if p == s:
                s = -1
                break
            s = p
        V = (self.probes[s][2].copy() if s >= 0
             else np.zeros(self.B, np.int64))
        for slot in reversed(path):
            own = self._snap_muts(slot)
            is_root = int(self.parent0[slot]) == slot
            for (c, ap, am) in own:
                idx, vals = self._d_range(c, ap, am)
                if vals is not None:
                    V[idx] += vals
            srow = self.base0[slot] + self.add0 + V
            nc = np.zeros(self.B, np.int64)
            if not is_root:
                for (c, ap, am) in own:
                    idx, pvals = self._d_point(c, ap, am)
                    if pvals is not None:
                        srow[idx] += pvals
                nc, _ = self._nc_row(own)
            self.probes[slot] = (srow, nc, V.copy())

    # --- current-view accessors ---------------------------------------------

    def parent_view(self, slot: int) -> int:
        p = self.parent_over.get(slot)
        if p is not None:
            return p
        return int(self.parent0[slot])

    def leaves_view(self, slot: int) -> int:
        rec = self.recs.get(slot)
        if rec is not None:
            return rec["leaves"]
        return int(self.num_leaves0[slot]) + self.leaf_boost.get(slot, 0)

    def chain_key(self, slot: int):
        """BFS-order key under the CURRENT tree: (level, root-path chain of
        child keys) — lexicographically identical to breadth-first rank
        (bigmat._bfs_chain_key, over the batch view)."""
        chain = []
        s = int(slot)
        while True:
            p = self.parent_view(s)
            if p == s:
                break
            ck = self.childkey_over.get(s)
            if ck is None:
                ck = int(self.child_key0[s])
            chain.append(ck)
            s = p
        chain.reverse()
        return (len(chain), tuple(chain))

    def _childkey_next(self, parent_slot: int) -> int:
        got = self.childcount.get(parent_slot)
        if got is None:
            if parent_slot < self.N0:
                got = int(self.child_count0[parent_slot])
            else:
                got = self.recs[parent_slot]["nchild"]
        self.childcount[parent_slot] = got + 1
        return got

    def _srow_of(self, slot: int):
        rec = self.recs.get(slot)
        if rec is not None:
            return rec["srow"]
        j = self.mod.get(slot)
        if j is not None:
            return self.cS[j]   # split-adjusted (see note_split)
        return self.probes[slot][0]

    def _cur_trips(self, slot: int):
        """CURRENT own-branch mutation triplets of any slot."""
        rec = self.recs.get(slot)
        if rec is not None:
            return rec["muts"]
        got = self.mod_muts.get(slot)
        if got is not None:
            return got
        return self._snap_muts(slot)

    def _detach_row(self, slot: int):
        """own_corr + OwnPoint of a node's current own mutations — the
        node-specific share of its score row (the bm-rule discount), which
        children do NOT inherit when chaining scores down a branch."""
        if slot == self.root_slot:
            return np.zeros(self.B, np.int64)
        out = np.zeros(self.B, np.int64)
        oc = 0
        for (c, ap, am) in self._cur_trips(slot):
            if am == ap:
                continue
            rk = int(self.ref[c])
            if (rk & am) == 0:
                oc += int(ap != rk) - int(am != rk)
            idx, pvals = self._d_point(c, ap, am)
            if pvals is not None:
                out[idx] += pvals
        return out + oc

    # --- apply bookkeeping --------------------------------------------------

    def _mut_sums(self, triplets):
        """(sum f_delta, sum own_corr, num eff) — bigmat._mut_terms."""
        fd = oc = nm = 0
        for (c, ap, am) in triplets:
            if am == ap:
                continue
            nm += 1
            rk = int(self.ref[c])
            fd += int(am != rk) - int(ap != rk)
            if (rk & am) == 0:
                oc += int(ap != rk) - int(am != rk)
        return fd, oc, nm

    def _add_cand(self, slot, srow, ncrow, leaf, num_mut,
                  is_mod=False, valid0=None) -> int:
        j = self.ncand
        if j == len(self.cS):
            for name in ("cS", "cNC", "cslot", "cleaf", "cnum_mut",
                         "cmod", "cvalid0"):
                a = getattr(self, name)
                setattr(self, name, np.concatenate([a, np.zeros_like(a)]))
        self.cS[j] = srow
        self.cNC[j] = ncrow
        self.cslot[j] = slot
        self.cleaf[j] = leaf
        self.cnum_mut[j] = num_mut
        self.cmod[j] = is_mod
        if valid0 is not None:
            self.cvalid0[j] = valid0
        self.ncand = j + 1
        return j

    def _new_rec(self, slot, parent_slot, triplets, leaf, leaves) -> None:
        """Score/nc rows for a batch-created node:
        score(child) = score(parent) - detach(parent)
                     + fd(child) + oc(child) + sum_own(d_range + d_point)
        (the telescoped F/base chain of bigmat._precompute, with the
        parent's node-specific bm-discount removed)."""
        fd, oc, _nm = self._mut_sums(triplets)
        srow = (self._srow_of(parent_slot)
                - self._detach_row(parent_slot) + (fd + oc))
        for (c, ap, am) in triplets:
            idx, vals = self._own_full(c, ap, am)
            if vals is not None:
                srow[idx] += vals
        ncrow, num_mut = self._nc_row(triplets)
        j = self._add_cand(slot, srow, ncrow, leaf, num_mut)
        self.recs[slot] = {
            "parent": parent_slot, "muts": list(triplets), "srow": srow,
            "ncrow": ncrow, "num_mut": num_mut, "leaf": leaf,
            "leaves": leaves, "nchild": 0, "cand": j, "anchor": None,
        }

    def _boost_walk(self, start: int) -> None:
        """+1 leaf on start and every current-view ancestor."""
        t = int(start)
        while True:
            rec = self.recs.get(t)
            if rec is not None:
                rec["leaves"] += 1
            else:
                self.leaf_boost[t] = self.leaf_boost.get(t, 0) + 1
            p = self.parent_view(t)
            if p == t:
                break
            t = p

    def note_child_insert(self, u: int, s_slot: int, l2_trip) -> None:
        if u < self.N0 and u not in self.probes:
            self.probe_path(u)
        self._new_rec(s_slot, u, l2_trip, leaf=True, leaves=1)
        self.parent_over[s_slot] = u
        self.childkey_over[s_slot] = self._childkey_next(u)
        self._boost_walk(u)
        self.applies += 1

    def note_split(self, u: int, x_slot: int, s_slot: int,
                   common_trip, l2_trip, l1_trip) -> None:
        if u < self.N0 and u not in self.probes:
            self.probe_path(u)
        pold = self.parent_view(u)
        if pold < self.N0 and pold not in self.probes:
            self.probe_path(pold)

        # u: mutation list shrinks to l1.  Moving `common` up to x keeps
        # every DESCENDANT's score exact (the range part of the correction
        # survives on x) but u ITSELF loses the own-branch treatment of
        # those mutations: the no-entry own_corr discount leaves base, and
        # the per-entry d_point leaves u's row —
        #   score_after(u) = score_before(u) - sum_common(own_corr + d_point)
        nc_new, nm_new = self._nc_row(l1_trip)
        mod_delta = np.zeros(self.B, np.int64)
        oc_common = 0
        for (c, ap, am) in common_trip:
            if am == ap:
                continue
            rk = int(self.ref[c])
            if (rk & am) == 0:
                oc_common += int(ap != rk) - int(am != rk)
            idx, pvals = self._d_point(c, ap, am)
            if pvals is not None:
                mod_delta[idx] += pvals
        srow_u = self._srow_of(u) - oc_common - mod_delta
        if u in self.recs:
            # u was created THIS batch: it already has a (non-Mod)
            # candidate row — update it in place; it was never part of the
            # device num_best, so it keeps counting via the new-node path
            rec = self.recs[u]
            j = rec["cand"]
            rec["srow"] = srow_u
            rec["muts"] = list(l1_trip)
            self.cS[j] = srow_u
            self.cNC[j] = nc_new
            self.cnum_mut[j] = nm_new
            rec["ncrow"], rec["num_mut"] = nc_new, nm_new
        else:
            leaf_u = bool(self.is_leaf0[u])
            j = self.mod.get(u)
            if j is None:
                nc0 = self.probes[u][1]
                nm0 = int(self.num_mut0[u])
                hu0 = nc0 < nm0
                if leaf_u:
                    valid0 = nc0 > 0
                else:
                    valid0 = (hu0 & (nc0 > 0)) | ~hu0
                j = self._add_cand(u, srow_u, nc_new, leaf_u, nm_new,
                                   is_mod=True, valid0=valid0)
                self.mod[u] = j
            else:
                self.cS[j] = srow_u
                self.cNC[j] = nc_new
                self.cnum_mut[j] = nm_new
            self.mod_muts[u] = list(l1_trip)

        leaves_u = self.leaves_view(u)
        self._new_rec(x_slot, pold, common_trip, leaf=False,
                      leaves=leaves_u + 1)
        # the old node whose snapshot subtree this split re-levels: the
        # subtree's interior (minus the tracked anchor itself) is the only
        # place an unprobed tied node's BFS rank can change
        anchor = u if u < self.N0 else self.recs[u]["anchor"]
        self.recs[x_slot]["anchor"] = anchor
        if anchor is not None and (int(self.dfs_end_of0[anchor])
                                   - int(self.dfs_of0[anchor])) > 1:
            # the unknown re-leveled ties are STRICT descendants of the
            # anchor (the anchor itself is a tracked Mod candidate), so
            # their leaf counts are bounded by the anchor's largest child
            self.opaque.append((int(anchor),
                                int(self._max_child_leaves()[anchor])))
        self.recs[x_slot]["nchild"] = 2
        self.parent_over[x_slot] = pold
        self.childkey_over[x_slot] = self._childkey_next(pold)
        self.parent_over[u] = x_slot
        self.childkey_over[u] = 1
        self._new_rec(s_slot, x_slot, l2_trip, leaf=True, leaves=1)
        self.parent_over[s_slot] = x_slot
        self.childkey_over[s_slot] = 0
        self.childcount[x_slot] = 2
        self.splits = True
        self._boost_walk(pold)
        self.applies += 1

    # --- per-sample resolution ----------------------------------------------

    def _old_valid(self, slot: int, i: int):
        """(score, valid, hu) of an UNMODIFIED S0 node from its probe row
        (validity is snapshot validity — unchanged for unmodified nodes)."""
        srow, ncrow, _ = self.probes[slot]
        sc = int(srow[i])
        nc = int(ncrow[i])
        nm = int(self.num_mut0[slot])
        hu = nc < nm
        if slot == self.root_slot:
            valid = True
        elif self.is_leaf0[slot]:
            valid = nc > 0
        else:
            valid = (hu and nc > 0) or not hu
        return sc, valid, hu

    def resolve(self, i: int, best0: int, w0: int, nb0: int, hu0: bool,
                second=None, collect=None):
        """Exact tree-at-apply-time result for sample i, or None when only
        the full host re-score can certify it.  `second` is the device's
        winner-row-masked runner-up (b2, w2, nb2, hu2) arrays — consulted
        when the snapshot winner was modified by an earlier apply.

        collect (a dict, -D detailed clades) receives how the final TIE
        SET relates to the device snapshot: mode="snap" with
        deltas=[(slot, leaf, hu, sign)] membership edits against the
        snapshot histogram; mode="explicit" with members=[(slot, leaf,
        hu)] enumerating it outright; mode=None when only a full host
        re-score can produce it."""
        if collect is not None:
            collect["mode"] = None
        if self.applies == 0:
            if collect is not None:
                collect["mode"] = "snap"
                collect["deltas"] = []
            return best0, w0, nb0, hu0
        r = self._resolve_core(i, best0, w0, nb0, hu0, exclude=None,
                               collect=collect)
        if r is not self._NEED_SECOND:
            return r
        if second is None:
            self._note_fb("full_no_second")
            return self._resolve_full(i, collect=collect)
        b2, w2, nb2, hu2 = (int(second[0][i]), int(second[1][i]),
                            int(second[2][i]), bool(second[3][i]))
        if nb2 == 0 or b2 >= (1 << 30):
            # no second-place among pre-existing nodes: only this batch's
            # candidates remain — the bestc<best0 machinery covers it with
            # an infinite old-best
            b2, w2, hu2 = int(self.INF), -1, False
        r = self._resolve_core(i, b2, w2, nb2, hu2, exclude=w0)
        if r is self._NEED_SECOND:
            self._note_fb("full_second_stuck")
            return self._resolve_full(i, collect=collect)
        return r

    def _note_fb(self, reason: str) -> None:
        self.fb_reasons[reason] = self.fb_reasons.get(reason, 0) + 1


    # --- flushless full-snapshot resolution ---------------------------------

    def _snapshot_rows(self, i: int):
        """EXACT (score, nc) rows for sample i over every S0 node from the
        frozen snapshot — a single-sample vectorized mirror of
        bigmat._events + place_one_host over the FROZEN refs: no flush, no
        device dispatch, usable regardless of how many applies separate
        the snapshot from this sample's turn."""
        from ..core.bigmat import _ranges
        sel = self._eb == i
        cols = self._ecol[sel]
        gv_e = self._egv[sel]
        km_e = self._ekm[sel]
        rk_e = self.ref[cols].astype(np.int64)
        add0 = int(self.add0[i])
        lo = self.csc_ptr0[cols]
        hi = self.csc_ptr0[cols + 1]
        counts = (hi - lo).astype(np.int64)
        pe = np.repeat(np.arange(len(cols)), counts)
        flat = np.repeat(lo, counts) + _ranges(counts)
        u = self.csc_node0[flat]
        am = self.csc_mut0[flat].astype(np.int64)
        ap = self.csc_par0[flat].astype(np.int64)
        rootm = self.csc_root0[flat]
        effm = self.csc_eff0[flat]
        if self.csc_dead0 is not None:
            alive = ~self.csc_dead0[flat]
            pe, u, am, ap = pe[alive], u[alive], am[alive], ap[alive]
            rootm, effm = rootm[alive], effm[alive]
        if self.ov0 is not None:
            ov_node, ov_col, ov_par, ov_mut = self.ov0
            lo2 = np.searchsorted(ov_col, cols)
            hi2 = np.searchsorted(ov_col, cols, side="right")
            c2 = (hi2 - lo2).astype(np.int64)
            pe2 = np.repeat(np.arange(len(cols)), c2)
            flat2 = np.repeat(lo2, c2) + _ranges(c2)
            pe = np.concatenate([pe, pe2])
            u = np.concatenate([u, ov_node[flat2]])
            am = np.concatenate([am, ov_mut[flat2].astype(np.int64)])
            ap = np.concatenate([ap, ov_par[flat2].astype(np.int64)])
            rootm = np.concatenate([rootm, np.zeros(len(pe2), bool)])
            effm = np.concatenate([effm, ov_mut[flat2] != ov_par[flat2]])
        gv_p = gv_e[pe]
        km_p = km_e[pe]
        rk_p = rk_e[pe]

        def corr_nobm(a):
            t1 = ((~km_p) & ((gv_p & a) == 0)).astype(np.int64)
            return t1 - (a != rk_p).astype(np.int64)

        c_am = corr_nobm(am)
        d_range = c_am - corr_nobm(ap)
        matched = (gv_p & am) != 0
        a_eff = np.where(matched, am, ap)
        t1_bm = ((~km_p) & ((gv_p & a_eff) == 0)).astype(np.int64)
        sub_bm = np.where((rk_p & am) != 0, am != rk_p,
                          ap != rk_p).astype(np.int64)
        d_point = np.where(rootm, 0, (t1_bm - sub_bm) - c_am)
        d_nc = np.where(effm & ~rootm,
                        ((gv_p & am) != 0).astype(np.int64)
                        - ((rk_p & am) != 0).astype(np.int64), 0)
        N0 = self.N0
        r = self.dfs_of0[u].astype(np.int64)
        rend = self.dfs_end_of0[u].astype(np.int64)
        diff = np.zeros(N0 + 1, np.int64)
        np.add.at(diff, r, d_range + d_point)
        np.add.at(diff, np.minimum(r + 1, N0), -d_point)
        np.add.at(diff, rend, -d_range)
        run = np.cumsum(diff[:N0])
        dr = self.dfs_of0[:N0].astype(np.int64)
        srow = self.base0[:N0].astype(np.int64) + add0 + run[dr]
        ncd = np.zeros(N0 + 1, np.int64)
        np.add.at(ncd, r, d_nc)
        ncrow = self.nc_base0[:N0].astype(np.int64) + ncd[dr]
        return srow, ncrow

    def _resolve_full(self, i: int, collect=None):
        """Complete tree-at-apply-time resolution from the snapshot rows
        plus the tracked candidate overlay — the fallback when the
        incremental certificates fail.  None only when the tie set blows
        the enumeration cap (then the flush-based host oracle runs)."""
        srow, ncrow = self._snapshot_rows(i)
        N0 = self.N0
        hu_v = ncrow < self.num_mut0[:N0]
        ncp = ncrow > 0
        leaf = self.is_leaf0[:N0]
        valid = (self.is_root0[:N0]
                 | (leaf & ncp)
                 | (~leaf & hu_v & ncp)
                 | (~leaf & ~hu_v)) & self.active0[:N0]
        if self.mod:
            # split nodes' CURRENT rows live in the candidate overlay
            valid = valid.copy()
            for slot in self.mod:
                valid[slot] = False
        sc0 = np.where(valid, srow, self.INF)
        best0 = int(sc0.min())
        n = self.ncand
        if n:
            colS = self.cS[:n, i]
            colNC = self.cNC[:n, i]
            hu_c = colNC < self.cnum_mut[:n]
            valid_c = np.where(self.cleaf[:n], colNC > 0,
                               (hu_c & (colNC > 0)) | ~hu_c)
            scc = np.where(valid_c, colS, self.INF)
            bestc = int(scc.min())
        else:
            scc = np.zeros(0, np.int64)
            hu_c = np.zeros(0, bool)
            bestc = int(self.INF)
        best = min(best0, bestc)
        if best >= int(self.INF):
            return None
        s0_ties = np.nonzero(sc0 == best)[0]
        c_ties = np.nonzero(scc == best)[0]
        nb = len(s0_ties) + len(c_ties)
        if nb > 4096:
            return None
        entries = ([(int(s), None) for s in s0_ties]
                   + [(int(self.cslot[j]), int(j)) for j in c_ties])
        slot_w, j_w = max(entries, key=lambda e: (
            self.leaves_view(e[0]), self.chain_key(e[0])))
        hu_w = (bool(hu_c[j_w]) if j_w is not None
                else bool(hu_v[slot_w]))
        if collect is not None:
            collect["mode"] = "explicit"
            collect["members"] = (
                [(int(s), bool(leaf[s]), bool(hu_v[s])) for s in s0_ties]
                + [(int(self.cslot[j]), bool(self.cleaf[j]),
                    bool(hu_c[j])) for j in c_ties])
        return best, slot_w, nb, hu_w

    _NEED_SECOND = object()

    def _resolve_core(self, i: int, best0: int, w0: int, nb0: int,
                      hu0: bool, exclude, collect=None):
        """One resolution pass against a device (best, winner, count, hu)
        where `exclude` names a slot masked out of that device count."""
        n = self.ncand
        if n:
            colS = self.cS[:n, i]
            colNC = self.cNC[:n, i]
            hu_c = colNC < self.cnum_mut[:n]
            valid_c = np.where(self.cleaf[:n], colNC > 0,
                               (hu_c & (colNC > 0)) | ~hu_c)
            sc = np.where(valid_c, colS, self.INF)
            bestc = int(sc.min())
        else:
            sc = np.zeros(0, np.int64)
            bestc = int(self.INF)

        jw0 = self.mod.get(w0) if w0 >= 0 else None
        if jw0 is not None and int(sc[jw0]) != best0:
            # the device winner was split and no longer attains its score:
            # the next-in-line among pre-existing nodes is needed
            return self._NEED_SECOND

        def _explicit(ties):
            if collect is not None:
                collect["mode"] = "explicit"
                collect["members"] = [
                    (int(self.cslot[j]), bool(self.cleaf[j]),
                     bool(hu_c[j])) for j in ties]

        if w0 < 0:
            # old nodes exhausted: winner must come from the candidates
            if bestc >= int(self.INF):
                return self._NEED_SECOND
            ties = np.nonzero(sc == bestc)[0]
            _explicit(ties)
            jw = max(ties, key=lambda j: (self.leaves_view(
                int(self.cslot[j])), self.chain_key(int(self.cslot[j]))))
            return (bestc, int(self.cslot[jw]), len(ties), bool(hu_c[jw]))

        if bestc < best0:
            ties = np.nonzero(sc == bestc)[0]
            nb = len(ties)
            _explicit(ties)
            jw = max(ties, key=lambda j: (self.leaves_view(
                int(self.cslot[j])), self.chain_key(int(self.cslot[j]))))
            return (bestc, int(self.cslot[jw]), nb, bool(hu_c[jw]))

        # Mod re-accounting at the snapshot best score: a split node left
        # the device count if its score/validity moved, joins it if it now
        # attains best0 validly (`exclude` was row-masked in this pass's
        # device count, so it was never part of it)
        adj = 0
        deltas = [] if collect is not None else None
        if n:
            for j in np.nonzero(self.cmod[:n])[0]:
                slot = int(self.cslot[j])
                s0 = int(self.probes[slot][0][i])
                was = (slot != exclude and s0 == best0
                       and bool(self.cvalid0[j, i]))
                now = (int(colS[j]) == best0) and bool(valid_c[j])
                adj += int(now) - int(was)
                if deltas is not None:
                    leaf = bool(self.cleaf[j])
                    if was:
                        # the device counted u with its SNAPSHOT hu
                        nc0 = int(self.probes[slot][1][i])
                        hu0s = nc0 < int(self.num_mut0[slot])
                        deltas.append((slot, leaf, hu0s, -1))
                    if now:
                        deltas.append((slot, leaf, bool(hu_c[j]), +1))

        cand_ties = (np.nonzero(sc == best0)[0] if bestc == best0
                     else np.zeros(0, np.int64))
        new_ties = [int(j) for j in cand_ties if not self.cmod[j]]
        if deltas is not None:
            for j in new_ties:
                deltas.append((int(self.cslot[j]), bool(self.cleaf[j]),
                               bool(hu_c[j]), +1))
            collect["mode"] = "snap"
            collect["deltas"] = deltas

        chal: list[int] = []
        if nb0 > 1:
            for slot in self.leaf_boost:
                if slot >= self.N0 or slot in self.mod or slot == w0:
                    continue
                pr = self.probes.get(slot)
                if pr is None:
                    continue
                sc_s, valid_s, _hu_s = self._old_valid(slot, i)
                if sc_s == best0 and valid_s:
                    chal.append(slot)
            if self.opaque:
                # a split re-leveled the interior of an old subtree: an
                # unprobed tied node in there could now out-rank the
                # finalists — but only if its leaf count (bounded by the
                # subtree root's) reaches the finalists' max.  ENUMERATE
                # the (small) re-leveled subtrees via snapshot probes and
                # add their qualifying ties as challengers; bail to the
                # full host re-score only past a size cap.
                bar = self.leaves_view(w0)
                for j in cand_ties:
                    bar = max(bar, self.leaves_view(int(self.cslot[j])))
                for slot in chal:
                    bar = max(bar, self.leaves_view(slot))
                hot = [a for a, b in self.opaque if b >= bar]
                if hot:
                    total = sum(int(self.dfs_end_of0[a])
                                - int(self.dfs_of0[a]) - 1 for a in hot)
                    if total > 512:
                        self._note_fb("full_opaque")
                        return self._resolve_full(i, collect=collect)
                    seen: set[int] = set()
                    for a in hot:
                        rows = range(int(self.dfs_of0[a]) + 1,
                                     int(self.dfs_end_of0[a]))
                        for rr in rows:
                            s2 = int(self.dfs_order0[rr])
                            if (s2 in seen or s2 in self.mod
                                    or s2 == w0 or s2 == exclude):
                                continue
                            seen.add(s2)
                            if self.leaves_view(s2) < bar:
                                continue
                            self.probe_path(s2)
                            sc_s, valid_s, _hu_s = self._old_valid(s2, i)
                            if sc_s == best0 and valid_s:
                                chal.append(s2)

        nb = nb0 + adj + len(new_ties)
        fin: dict[int, int | None] = {w0: jw0}      # slot -> cand idx
        for j in cand_ties:
            fin[int(self.cslot[j])] = int(j)
        for slot in chal:
            fin.setdefault(slot, None)
        if len(fin) == 1:
            j_w = fin[w0]
            hu_w = (bool(self.cNC[j_w, i] < self.cnum_mut[j_w])
                    if j_w is not None else hu0)
            return best0, w0, nb, hu_w
        slot_w, j_w = max(fin.items(), key=lambda kv: (
            self.leaves_view(kv[0]), self.chain_key(kv[0])))
        if j_w is not None:
            return best0, slot_w, nb, bool(
                self.cNC[j_w, i] < self.cnum_mut[j_w])
        if slot_w == w0:
            return best0, w0, nb, hu0
        _sc, _valid, hu_w = self._old_valid(slot_w, i)
        return best0, slot_w, nb, hu_w


@dataclass
class DirectOptions:
    outdir: str = "."
    batch_size: int = 64
    max_uncertainty: int = 1_000_000
    max_parsimony: int = 1_000_000
    no_add: bool = False
    uncondensed: bool = False          # -u
    dout_filename: str = ""            # -o
    sort_before_placement_1: bool = False  # -s (usher_common.cpp:330-379)
    sort_before_placement_2: bool = False  # -S
    sort_before_placement_3: bool = False  # -A
    reverse_sort: bool = False             # -r
    print_parsimony_scores: bool = False   # -p (usher_common.cpp:466-521)
    detailed_clades: bool = False          # -D (usher_common.cpp:957-985)
    collapse_tree: bool = False            # -c (usher_common.cpp:275-297)
    collapse_output_tree: bool = False     # -C (usher_common.cpp:798-801)
    print_subtrees_size: int = 0           # -k (usher_common.cpp:893-905)
    print_subtrees_single: int = 0         # -K (usher_common.cpp:884-891)


class DirectPlacer:
    def __init__(self, pb_path: str, vcf_path: str | None = None,
                 mesh=None, collapse: bool = False, ma=None,
                 extra_pos_ref=None, counter=None):
        """mesh: optional jax Mesh (flattened to 1-D) — batch-axis
        shard_map composition for the device scoring calls
        (ops/interval.py; CSR metadata replicated per device).

        collapse (-c): collapse the input tree + condense identical
        sequences BEFORE placement (usher_common.cpp:275-297), as list
        ops — condensed-tree.nh text is stashed for place_all to write.

        ma / extra_pos_ref / counter: library entry (matUtils merge):
        drive placement over a caller-prepared MatArrays, extending the
        position set by {position: ref_nuc} pairs absent from the MAT
        (merge samples can mutate positions the base never saw), with an
        explicit internal-node id counter (the caller's uncondense
        consumed ids the default heuristic cannot see)."""
        if ma is None:
            ma = load_mat_arrays(pb_path)
        self.ma = ma
        self.chrom = ma.chrom
        # internal-node counter continues the parsed numbering (node ids are
        # node_1..node_K in '(' order, matching Tree.new_internal_node_id)
        names = ma.names()
        self._condensed_nh: str | None = None
        if collapse:
            # the duplicate-sample VCF check below still sees the
            # PRE-collapse names (the Tree driver reads the VCF first)
            pre_condensed = {leaf for _, ls in ma.condensed for leaf in ls}
            pre_names = set(names)
            from .list_tree import ListTree
            _err("Collapsing input tree.")
            lt = ListTree.from_arrays(ma)
            lt.collapse_tree()
            _err("Condensing identical sequences.")
            lt.condense_leaves()
            self._condensed_nh = lt.write_newick() + "\n"
            self._counter_override = lt.curr_internal_node
            pos_index = {int(p): i for i, p in enumerate(ma.positions)}
            ma = lt.to_arrays(ma.positions, ma.ref, self.chrom, pos_index)
            self.ma = ma
            names = ma.names()
        self._names = names
        self._extra_names: list[str] = []
        self.condensed_leaves = {leaf for _, ls in ma.condensed
                                 for leaf in ls}
        if collapse:
            # already-in-tree warnings match the Tree flow's pre-collapse
            # name set
            self.condensed_leaves |= pre_condensed | pre_names

        self.missing: list[MissingSample] = []
        positions = ma.positions
        ref = ma.ref
        if vcf_path:
            vcf = read_vcf_sites(vcf_path)
            self.missing = self._collect_missing(vcf, set(names))
            pos_ref = dict(zip(positions.tolist(), ref.tolist()))
            for site in vcf.sites:
                pos_ref.setdefault(site.position, site.ref_nuc)
                self.chrom = self.chrom or site.chrom
            positions = np.array(sorted(pos_ref), dtype=np.int64)
            ref = np.array([pos_ref[p] for p in positions.tolist()],
                           dtype=np.uint8)
            # remap the CSR columns into the extended position space
            new_col = np.searchsorted(positions,
                                      ma.positions[ma.mut_col]).astype(
                                          np.int32)
            from ..core.bigmat import BigMAT
            self.big = BigMAT(ma.parent, ma.mut_ptr, new_col, ma.mut_par,
                              ma.mut_mut, positions, ref)
            self.big._recompute_ranks()
        elif extra_pos_ref:
            pos_ref = dict(zip(positions.tolist(), ref.tolist()))
            for p, r in extra_pos_ref.items():
                pos_ref.setdefault(int(p), int(r))
            positions = np.array(sorted(pos_ref), dtype=np.int64)
            ref = np.array([pos_ref[p] for p in positions.tolist()],
                           dtype=np.uint8)
            new_col = np.searchsorted(positions,
                                      ma.positions[ma.mut_col]).astype(
                                          np.int32)
            from ..core.bigmat import BigMAT
            self.big = BigMAT(ma.parent, ma.mut_ptr, new_col, ma.mut_par,
                              ma.mut_mut, positions, ref)
            self.big._recompute_ranks()
        else:
            self.big = ma.to_bigmat()
        if mesh is not None and len(mesh.axis_names) > 1:
            from jax.sharding import Mesh
            mesh = Mesh(np.asarray(mesh.devices).reshape(-1), ("batch",))
        self.big.mesh = mesh
        # internal-node counter continues the parser's numbering: one
        # node_<k> per '(' (= one per internal node; condensed LEAF names
        # may also start with node_ and must not count).  After a -c
        # collapse, the counter continues from the collapse's own id
        # consumption instead (Tree.new_internal_node_id state).
        self._internal_counter = counter if counter is not None else (
            getattr(self, "_counter_override", None) or int(
                (~self.big.is_leaf).sum()))
        self._init_clades()
        # per-node mutation-list deltas (split/appended nodes); everything
        # else reads the CSR directly
        self._mut_delta: dict[int, list] = {}
        self._placed: set[str] = set()
        self._bs: _BatchState | None = None   # current batch's overlay
        self._bs_next: _BatchState | None = None  # pipelined next batch
        # extra per-new-slot views for not-yet-flushed appends
        self._leaf_over: dict[int, bool] = {}

    # --- clade annotations --------------------------------------------------

    def _init_clades(self) -> None:
        """Interned + root-to-leaf propagated clade-id arrays per
        annotation column (the array form of Tree.get_clade_assignment,
        mutation_annotated_tree.cpp:950-958): clade_self[a][n] = nearest
        ancestor-or-self non-empty annotation; clade_par[a][n] = the same
        excluding n's own annotation.  Id 0 = UNDEFINED."""
        from ..io import pb_arrays as pa
        anns, ncols = pa.ann_lists(self.ma, self.ma.n)
        self.num_annotations = ncols
        self._clade_tables: list[list[str]] = []
        self._clade_self: list[np.ndarray] = []
        self._clade_par: list[np.ndarray] = []
        if ncols == 0:
            return
        big = self.big
        n0 = self.ma.n
        level = big.level[:n0]
        parent = big.parent[:n0]
        order = np.argsort(level, kind="stable")
        bounds = np.searchsorted(level[order],
                                 np.arange(int(level.max()) + 2))
        for a in range(ncols):
            index = {"": 0}
            table = ["UNDEFINED"]
            own = np.zeros(n0, np.int32)
            for i in range(n0):
                s = anns[i][a] if a < len(anns[i]) else ""
                if not s:
                    continue
                got = index.get(s)
                if got is None:
                    got = index[s] = len(table)
                    table.append(s)
                own[i] = got
            cs = own.copy()
            for li in range(1, len(bounds) - 1):
                idx = order[bounds[li]:bounds[li + 1]]
                if len(idx) == 0:
                    continue
                cs[idx] = np.where(own[idx] != 0, own[idx],
                                   cs[parent[idx]])
            cp = cs[parent]
            cp[big.root_slot] = 0   # no ancestor above the root
            self._clade_tables.append(table)
            self._clade_self.append(cs)
            self._clade_par.append(cp)

    def _sync_clades(self) -> None:
        """Grow the propagated arrays to big.N: placement-created nodes
        carry no annotations, so they inherit the parent's propagated
        clade; a split never moves annotations, so existing entries stay
        exact (x interposes with an empty annotation)."""
        if not self.num_annotations:
            return
        big = self.big
        n_old = len(self._clade_self[0])
        if n_old == big.N:
            return
        for a in range(self.num_annotations):
            cs = np.empty(big.N, np.int32)
            cs[:n_old] = self._clade_self[a]
            cp = np.empty(big.N, np.int32)
            cp[:n_old] = self._clade_par[a]
            for slot in range(n_old, big.N):
                p = int(big.parent[slot])
                cs[slot] = cs[p]
                cp[slot] = cs[p]
            self._clade_self[a] = cs
            self._clade_par[a] = cp

    def _clade_id_of(self, slot: int, a: int,
                     include_self: bool = True) -> int:
        """Clade id of a slot under the CURRENT view (queued surgery
        included); batch-created nodes have no annotations, so both
        include_self variants resolve at the nearest materialized
        ancestor."""
        s = int(slot)
        cs = self._clade_self[a]
        if not include_self:
            if s < len(cs):
                return int(self._clade_par[a][s])
            p = self.parent_slot_of(s)
            if p == s:
                return 0
            s = p
        while s >= len(cs):
            s = self.parent_slot_of(s)
        return int(cs[s])

    def _member_clade(self, a: int, slot: int, leaf: bool,
                      hu: bool) -> int:
        """Tie-set member's clade contribution: include_self = !leaf &&
        !hu (usher_common.cpp:608-612)."""
        if slot < len(self._clade_self[a]):
            arr = (self._clade_par[a] if (leaf or hu)
                   else self._clade_self[a])
            return int(arr[slot])
        return self._clade_id_of(slot, a, True)

    def _host_clade_hist(self, is_best, hu_row):
        """Histogram from a full host tie mask (fallback path; arrays are
        flushed + synced by the caller)."""
        big = self.big
        tied = np.nonzero(is_best)[0]
        use_par = big.is_leaf[tied] | hu_row[tied]
        out = []
        for a in range(self.num_annotations):
            ids = np.where(use_par, self._clade_par[a][tied],
                           self._clade_self[a][tied])
            out.append(np.bincount(
                ids, minlength=len(self._clade_tables[a])))
        return out

    # --- node views ---------------------------------------------------------

    def name_of(self, slot: int) -> str:
        if slot < len(self._names):
            return self._names[slot]
        return self._extra_names[slot - len(self._names)]

    def parent_slot_of(self, slot: int) -> int:
        """CURRENT-view parent (includes this batch's queued surgery)."""
        bs = self._bs
        if bs is not None:
            p = bs.parent_over.get(slot)
            if p is not None:
                return p
        if slot < self.big.N:
            return int(self.big.parent[slot])
        raise IndexError(f"unknown slot {slot}")

    def is_leaf_of(self, slot: int) -> bool:
        got = self._leaf_over.get(slot)
        if got is not None:
            return got
        return bool(self.big.is_leaf[slot])

    def mutations_of(self, slot: int):
        delta = self._mut_delta.get(slot)
        if delta is not None:
            return delta
        big = self.big
        lo, hi = int(big.mut_ptr[slot]), int(big.mut_ptr[slot + 1])
        out = []
        for k in range(lo, hi):
            col = int(big.mut_col[k])
            pos = int(big.positions[col])
            out.append(Mutation(self.chrom, pos, int(big.ref[col]),
                                int(big.mut_par[k]), int(big.mut_mut[k])))
        return out

    def node(self, slot: int) -> ArrayNode:
        return ArrayNode(self, slot)

    # --- VCF ----------------------------------------------------------------

    def _collect_missing(self, vcf, tree_names: set):
        missing: list[MissingSample] = []
        col_to_ms: dict[int, MissingSample] = {}
        for j, name in enumerate(vcf.sample_ids):
            if name in tree_names or name in self.condensed_leaves:
                _err(f"WARNING: Ignoring sample {name} as it is already "
                     f"in the tree.")
            else:
                ms = MissingSample(name)
                missing.append(ms)
                col_to_ms[j] = ms
        for site in vcf.sites:
            for j, nuc in site.variants:
                ms = col_to_ms.get(j)
                if ms is None:
                    continue
                m = Mutation(chrom=site.chrom, position=site.position,
                             ref_nuc=site.ref_nuc, par_nuc=site.ref_nuc)
                if nuc == NUC_N:
                    m.is_missing = True
                    m.mut_nuc = NUC_N
                else:
                    m.mut_nuc = nuc
                ms.mutations.append(m)
                if m.mut_nuc & (m.mut_nuc - 1):
                    ms.num_ambiguous += 1
        return missing

    # --- surgery (usher_common.cpp:652-765 / big_engine semantics) ----------

    def _triplets(self, muts):
        out = []
        for m in muts:
            if m.position < 0:
                continue
            out.append((self.big.pos_index[m.position], int(m.par_nuc),
                        int(m.mut_nuc)))
        return out

    def apply_placement(self, sample_name: str, best_slot: int,
                        hu_best: bool, excess) -> list[int]:
        big = self.big
        changed = []
        if self.is_leaf_of(best_slot) or hu_best:
            self._internal_counter += 1
            nid = f"node_{self._internal_counter}"
            curr_l1 = [m.copy() for m in self.mutations_of(best_slot)]
            l1, l2, common = [], [], []
            for m1 in curr_l1:
                if not any((not m1.is_masked())
                           and m1.position == m2.position
                           and m1.mut_nuc == m2.mut_nuc for m2 in excess):
                    l1.append(m1.copy())
            for m1 in excess:
                matched = any((not m1.is_masked())
                              and m1.position == m2.position
                              and m1.mut_nuc == m2.mut_nuc
                              for m2 in curr_l1)
                (common if matched else l2).append(m1.copy())
            ct, l2t = self._triplets(common), self._triplets(l2)
            l1t = self._triplets(l1)
            x_slot, s_slot = big.queue_sibling_split(best_slot, ct, l2t)
            self._extra_names.append(nid)
            self._extra_names.append(sample_name)
            self._mut_delta[best_slot] = sorted(
                l1, key=lambda m: m.position)
            self._mut_delta[x_slot] = sorted(
                common, key=lambda m: m.position)
            self._mut_delta[s_slot] = sorted(l2, key=lambda m: m.position)
            self._leaf_over[x_slot] = False
            self._leaf_over[s_slot] = True
            for bsx in (self._bs, self._bs_next):
                if bsx is not None:
                    bsx.note_split(best_slot, x_slot, s_slot, ct, l2t,
                                   l1t)
            changed = [s_slot, x_slot, best_slot]
        else:
            curr_l1 = self.mutations_of(best_slot)
            l2 = [m1.copy() for m1 in excess
                  if not any((not m1.is_masked())
                             and m1.position == m2.position
                             and m1.mut_nuc == m2.mut_nuc
                             for m2 in curr_l1)]
            l2t = self._triplets(l2)
            s_slot = big.queue_child_insert(best_slot, l2t)
            self._extra_names.append(sample_name)
            self._mut_delta[s_slot] = sorted(l2, key=lambda m: m.position)
            self._leaf_over[s_slot] = True
            for bsx in (self._bs, self._bs_next):
                if bsx is not None:
                    bsx.note_child_insert(best_slot, s_slot, l2t)
            changed = [s_slot]
        return changed

    def _assign_clades(self, s, best_slot: int, hu_best: bool,
                       num_best: int, detailed: bool, collect,
                       dev_hist, i: int, host_masks) -> None:
        """Fill s.best_clade_assignment (always) and s.clade_assignments
        (-D: per-column (clade, count) runs over the tie set, in sorted
        clade order) — exact tree-at-apply-time values, assembled from the
        device snapshot histogram plus the resolve membership edits, or a
        full host row when only that can certify (usher_common.cpp:
        600-619)."""
        A = self.num_annotations
        include_self = (not self.is_leaf_of(best_slot)) and (not hu_best)
        s.best_clade_assignment = [
            self._clade_tables[a][
                self._clade_id_of(best_slot, a, include_self)]
            for a in range(A)]
        if not detailed:
            return
        mode = collect.get("mode") if collect is not None else None
        if host_masks is not None:
            self._sync_clades()
            hists = self._host_clade_hist(*host_masks)
        elif mode == "snap" and dev_hist is not None:
            hists = [dev_hist[a, :, i].astype(np.int64).copy()
                     for a in range(A)]
            for (slot, leaf, hu, sign) in collect["deltas"]:
                for a in range(A):
                    hists[a][self._member_clade(a, slot, leaf, hu)] += sign
        elif mode == "explicit":
            hists = [np.zeros(len(self._clade_tables[a]), np.int64)
                     for a in range(A)]
            for (slot, leaf, hu) in collect["members"]:
                for a in range(A):
                    hists[a][self._member_clade(a, slot, leaf, hu)] += 1
        else:
            # resolved through the runner-up reduce: the snapshot
            # histogram is based elsewhere — one exact host row
            p1, g1, k1 = self.big.sparsify([s.mutations])
            _b, _s, _n, _h, ib, hur = self.big.place_one_host(
                p1, g1, k1, full=True)
            self._sync_clades()
            hists = self._host_clade_hist(ib, hur)
        s.clade_assignments = []
        for a in range(A):
            table = self._clade_tables[a]
            h = hists[a]
            total = int(h[:len(table)].sum())
            if total != num_best:
                raise AssertionError(
                    f"clade histogram mismatch for {s.name} column {a}: "
                    f"{total} vs num_best {num_best}")
            order = sorted(range(len(table)), key=lambda cid: table[cid])
            s.clade_assignments.append(
                [(table[cid], int(h[cid])) for cid in order if h[cid] > 0])

    def _write_clades(self, path: str, detailed: bool) -> None:
        """clades.txt (usher_common.cpp:941-989 / driver.py:627-653):
        per placed sample the best clade per annotation column; -D appends
        '*|clade(count/total),...' histogram runs over the tie set."""
        with open(path, "w") as f:
            for s in self.missing:
                if not s.best_clade_assignment:
                    continue
                f.write(f"{s.name}\t")
                cols = []
                for k in range(self.num_annotations):
                    col = s.best_clade_assignment[k]
                    if detailed:
                        col += "*|"
                        total = sum(c for _, c in s.clade_assignments[k])
                        col += ",".join(
                            f"{clade}({cnt}/{total})"
                            for clade, cnt in s.clade_assignments[k])
                    cols.append(col)
                f.write("\t".join(cols) + "\n")

    # --- the placement loop -------------------------------------------------

    def _dry_run_scores(self, bsz: int):
        """(best_score, num_best) per missing sample against the unmodified
        tree — the sort-before-placement pre-pass (usher_common.cpp:
        330-379) as chunked device batches with no applies."""
        big = self.big
        best_scores: list[int] = []
        num_placements: list[int] = []
        for b0 in range(0, len(self.missing), bsz):
            batch = self.missing[b0:b0 + bsz]
            for s in batch:
                s.mutations.sort(key=lambda m: m.position)
            pos, gval, kmiss = big.sparsify([s.mutations for s in batch])
            bs, _slot, nb, _hu = big.place_arrays(pos, gval, kmiss)
            best_scores.extend(int(x) for x in bs)
            num_placements.extend(int(x) for x in nb)
        return best_scores, num_placements

    def _sorted_indexes(self, opts: DirectOptions, bsz: int) -> list[int]:
        """Placement order under the sort flags (usher_common.cpp:322-379):
        -A by ambiguous-mutation count; -s/-S by a dry-run (score, EPPs) /
        (EPPs, score) pre-pass; -r reverses the sorted order."""
        indexes = list(range(len(self.missing)))
        if ((opts.sort_before_placement_1 or opts.sort_before_placement_2)
              and len(self.missing) > 1):
            _err("Computing parsimony scores and number of parsimony-optimal "
                 "placements for new samples and using them to sort the "
                 "samples.")
            best_scores, num_placements = self._dry_run_scores(bsz)
            if opts.sort_before_placement_1:
                indexes.sort(key=lambda i: (best_scores[i],
                                            num_placements[i]))
            else:
                indexes.sort(key=lambda i: (num_placements[i],
                                            best_scores[i]))
            if opts.reverse_sort:
                indexes.reverse()
        return indexes

    def _valid_rows(self, score_T, nc_T):
        """Reference validity + has-unique per [N, B] score/nc columns
        (usher_mapper.cpp:452-455; matches place_one_host)."""
        big = self.big
        hu = nc_T < big.node_num_mut[:, None]
        nc_pos = nc_T > 0
        leaf = big.is_leaf[:, None]
        valid = (big.is_root_mask[:, None]
                 | (leaf & nc_pos)
                 | (~leaf & hu & nc_pos)
                 | (~leaf & ~hu)) & big.active[:, None]
        return valid, hu

    def _print_parsimony_scores(self, opts: DirectOptions,
                                outdir: str) -> None:
        """-p: per-node branch parsimony scores for every sample, no tree
        modification (usher_common.cpp:466-521 / placement/driver.py -p
        branch), computed from the full [N, B] device score matrix."""
        big = self.big
        path = os.path.join(outdir, "current-tree.nh")
        with open(path, "w") as f:
            f.write(self.write_newick() + "\n")
        stats_f = open(os.path.join(outdir, "placement_stats.tsv"), "w")
        pars_path = os.path.join(outdir, "parsimony-scores.tsv")
        pars_f = None
        bfs_order = np.argsort(big.bfs_rank, kind="stable")
        bsz = max(1, opts.batch_size)
        for b0 in range(0, len(self.missing), bsz):
            batch = self.missing[b0:b0 + bsz]
            for s in batch:
                s.mutations.sort(key=lambda m: m.position)
            pos, gval, kmiss = big.sparsify([s.mutations for s in batch])
            score_T, nc_T, _ = big.score_batch_T(pos, gval, kmiss)
            valid, _hu = self._valid_rows(score_T, nc_T)
            for i, s in enumerate(batch):
                if pars_f is None:
                    _err(f"\nNow computing branch parsimony scores for "
                         f"adding the missing samples at each of the nodes "
                         f"in the existing tree without modifying the tree."
                         f"\nThe branch parsimony scores will be written "
                         f"to file {pars_path}\n")
                    pars_f = open(pars_path, "w")
                    pars_f.write(
                        "#Sample\tTree node\tParsimony score\t"
                        "Optimal (y/n)\t"
                        "Parsimony-increasing mutations (for optimal "
                        "nodes)\n")
                s_col = score_T[:, i]
                v_col = valid[:, i]
                vs = np.where(v_col, s_col, 1 << 30)
                best = int(vs.min())
                num_best = int((vs == best).sum())
                _err(f"Missing sample: {s.name}\t Best parsimony score: "
                     f"{best}\tNumber of parsimony-optimal placements: "
                     f"{num_best}")
                for slot in bfs_order:
                    sc = int(s_col[slot])
                    reported = sc if v_col[slot] else sc + 1
                    is_opt = "y" if reported == best else "n"
                    pars_f.write(f"{s.name}\t{self.name_of(int(slot))}\t"
                                 f"{reported}\t\t{is_opt}\t")
                    if reported == best:
                        det = score_placement(self.node(int(slot)),
                                              s.mutations)
                        if reported == 0:
                            pars_f.write("*")
                        n_print = min(reported, len(det.excess))
                        pars_f.write(",".join(
                            det.excess[k].get_string()
                            for k in range(n_print)))
                    else:
                        pars_f.write("N/A")
                    pars_f.write("\n")
                stats_f.write("\n")
        stats_f.close()
        if pars_f is not None:
            pars_f.close()

    def place_all(self, opts: DirectOptions) -> None:
        os.makedirs(opts.outdir, exist_ok=True)
        outdir = os.path.realpath(opts.outdir)
        big = self.big
        if self._condensed_nh is not None:
            # -c: the collapse itself ran at load time (__init__)
            with open(os.path.join(outdir, "condensed-tree.nh"),
                      "w") as f:
                f.write(self._condensed_nh)
        _err(f"Found {len(self.missing)} missing samples.\n")
        t_us = now_us()
        bsz = max(1, opts.batch_size)
        if opts.sort_before_placement_3:
            # the Tree driver sorts the sample LIST itself, before the -p
            # branch (driver.py:356-359), so downstream writers
            # (mutation-paths.txt) follow the sorted order too
            self.missing.sort(key=lambda s: s.num_ambiguous)
            if opts.reverse_sort:
                self.missing.reverse()
        if opts.print_parsimony_scores:
            self._print_parsimony_scores(opts, outdir)
            return
        indexes = self._sorted_indexes(opts, bsz)
        stats_f = open(os.path.join(outdir, "placement_stats.tsv"), "w")

        seq_mode = bool(os.environ.get("USHER_JAX_DIRECT_SEQ"))
        want_clades = self.num_annotations > 0
        detailed = opts.detailed_clades and want_clades
        use_dev_hist = detailed and big.mesh is None and not seq_mode
        n_clades = (max(len(t) for t in self._clade_tables)
                    if want_clades else 0)
        with_second = big.mesh is None

        def _dispatch(batch):
            """Enqueue a batch's device scoring WITHOUT blocking and
            snapshot its _BatchState at the same tree state the device
            sees — the serving pipeline scores batch j+1 while batch j's
            host corrections run (the headline bench's enqueue-ahead
            discipline; reference place_sample.cpp:450-584).  The state
            records every apply made between its snapshot and its
            resolution (including the whole previous batch), which the
            correction machinery already handles exactly."""
            for s in batch:
                s.mutations.sort(key=lambda m: m.position)
            pos, gval, kmiss = big.sparsify([s.mutations for s in batch])
            if use_dev_hist:
                # clade arrays must cover every flushed slot before the
                # device call snapshots them
                big._flush()
                self._sync_clades()
                cl = (self._clade_self, self._clade_par, n_clades)
                h = big.place_arrays_begin(pos, gval, kmiss,
                                           with_second=True, clades=cl)
            elif with_second:
                h = big.place_arrays_begin(pos, gval, kmiss,
                                           with_second=True)
            else:
                h = big.place_arrays_begin(pos, gval, kmiss)
            return h, _BatchState(self, pos, gval, kmiss)

        # enqueue-ahead pipelining pays a doubled per-apply bookkeeping
        # cost (every apply notifies two batch states), so the synchronous
        # order is the default; USHER_JAX_DIRECT_PIPE=1 turns the lookahead
        # on (whether it wins on the GPU is not measured yet)
        pipelined = bool(os.environ.get("USHER_JAX_DIRECT_PIPE"))
        batch_lists = [[self.missing[i] for i in indexes[b0:b0 + bsz]]
                       for b0 in range(0, len(indexes), bsz)]
        pending = (_dispatch(batch_lists[0])
                   if batch_lists and pipelined else None)
        for j, batch in enumerate(batch_lists):
            if pending is None:
                pending = _dispatch(batch)
            h, st = pending
            res = big.place_arrays_finish(h)
            dev_hist = None
            if use_dev_hist:
                (bs, slot, nb, hu), second, dev_hist = res
            elif with_second:
                (bs, slot, nb, hu), second = res
            else:
                bs, slot, nb, hu = res
                second = None
            # overlap: enqueue batch j+1 against the CURRENT state before
            # batch j's host corrections/applies run
            pending = (_dispatch(batch_lists[j + 1])
                       if pipelined and j + 1 < len(batch_lists) else None)
            self._bs = st
            self._bs_next = pending[1] if pending is not None else None
            self._total_batches = getattr(self, "_total_batches", 0) + 1
            for i, s in enumerate(batch):
                if s.name in self._placed:
                    # duplicate within the VCF: the Tree driver's mid-loop
                    # T.get_node check skips it the same way
                    _err(f"WARNING: Sample {s.name} already in the tree! "
                         f"Ignoring.\n")
                    continue
                collect = {} if detailed else None
                if seq_mode and st.applies:
                    r = None   # the reference's literal per-sample loop
                else:
                    r = st.resolve(i, int(bs[i]), int(slot[i]),
                                   int(nb[i]), bool(hu[i]), second=second,
                                   collect=collect)
                host_masks = None
                if r is None:
                    # uncertifiable from the snapshot: exact full host
                    # re-score against the current tree (numpy interval
                    # engine — a device dispatch would re-upload the
                    # post-append epoch metadata every time)
                    st.fallbacks += 1
                    p1, g1, k1 = big.sparsify([s.mutations])
                    if detailed:
                        (best_score, best_slot, num_best, hu_best,
                         ib_mask, hu_row) = big.place_one_host(
                            p1, g1, k1, full=True)
                        host_masks = (ib_mask, hu_row)
                    else:
                        best_score, best_slot, num_best, hu_best = \
                            big.place_one_host(p1, g1, k1)
                else:
                    best_score, best_slot, num_best, hu_best = r
                    best_score, best_slot = int(best_score), int(best_slot)
                    num_best, hu_best = int(num_best), bool(hu_best)

                detail = score_placement(self.node(best_slot), s.mutations)
                if detail.set_difference != best_score:
                    raise AssertionError(
                        f"device/host score mismatch for {s.name} at "
                        f"{self.name_of(best_slot)}: {best_score} vs "
                        f"{detail.set_difference}")

                total_nodes = big.N + sum(
                    1 if p[0] == "child" else 2 for p in big._pending)
                _err(f"Current tree size (#nodes): {total_nodes}\tSample "
                     f"name: {s.name}\tParsimony score: {best_score}\t"
                     f"Number of parsimony-optimal placements: {num_best}")
                stats_f.write(f"{s.name}\t{best_score}\t{num_best}\t")

                if num_best > 1:
                    if num_best > opts.max_uncertainty:
                        _err(f"WARNING: Number of parsimony-optimal "
                             f"placements exceeds maximum allowed value "
                             f"({opts.max_uncertainty}). Ignoring sample "
                             f"{s.name}.")
                    elif best_score <= opts.max_parsimony:
                        _err("WARNING: Multiple parsimony-optimal "
                             "placements found. Placement done without "
                             "high confidence.")
                if best_score > opts.max_parsimony:
                    _err(f"WARNING: Parsimony score of the most "
                         f"parsimonious placement exceeds the maximum "
                         f"allowed value ({opts.max_parsimony}). Ignoring "
                         f"sample {s.name}.")

                if (num_best <= opts.max_uncertainty
                        and best_score <= opts.max_parsimony):
                    if want_clades:
                        # before apply, like the Tree driver
                        # (usher_common.cpp:600-619)
                        self._assign_clades(s, best_slot, hu_best,
                                            num_best, detailed, collect,
                                            dev_hist, i, host_masks)
                    if not opts.no_add:
                        self.apply_placement(
                            s.name, best_slot, hu_best, detail.excess)
                        self._placed.add(s.name)
                    if detail.imputed:
                        from ..placement.driver import _nuc_char
                        imp = ";".join(
                            f"{m.position}:{_nuc_char(m.mut_nuc)}"
                            for m in detail.imputed)
                        _err("Imputed mutations:\t" + imp)
                        stats_f.write(imp)
                stats_f.write("\n")
            self._total_fallbacks = (getattr(self, "_total_fallbacks", 0)
                                     + st.fallbacks)
            agg = getattr(self, "_fb_reasons", {})
            for k, v in st.fb_reasons.items():
                agg[k] = agg.get(k, 0) + v
            self._fb_reasons = agg
        stats_f.close()
        if self.missing:
            _err(f"[direct] {getattr(self, '_total_fallbacks', 0)} full "
                 f"host re-scores over "
                 f"{len(self.missing)} samples "
                 f"({getattr(self, '_total_batches', 0)} batches) "
                 f"{getattr(self, '_fb_reasons', {})}")
        self._bs = self._bs_next = None
        big._flush()
        t_us = record_span("direct.place", t_us)

        lt = None
        if opts.collapse_output_tree:
            # structural collapse over lists (Tree.collapse_tree
            # semantics incl. merge-on-move; usher_common.cpp:798-801)
            from .list_tree import ListTree
            _err("Collapsing output tree.")
            lt = ListTree.from_placer(self)
            lt.collapse_tree()

        if opts.uncondensed:
            path = os.path.join(outdir, "uncondensed-final-tree.nh")
            _err(f"Writing uncondensed final tree to file {path}")
            if lt is not None:
                nh, total = (lt.write_newick(uncondense=True),
                             lt.parsimony_score())
            else:
                nh, total = self.write_newick(uncondense=True,
                                              with_score=True)
            _err(f"The parsimony score for this tree is: {total}")
            with open(path, "w") as f:
                f.write(nh)
        else:
            path = os.path.join(outdir, "final-tree.nh")
            _err(f"Writing final tree to file {path}")
            with open(path, "w") as f:
                f.write(lt.write_newick() if lt is not None
                        else self.write_newick())
        path = os.path.join(outdir, "mutation-paths.txt")
        _err(f"Writing mutation paths to file {path}")
        with open(path, "w") as f:
            for s in self.missing:
                f.write(lt.mutation_path(s.name) if lt is not None
                        else self._mutation_path(s.name))
        if self.missing and self.num_annotations > 0:
            path = os.path.join(outdir, "clades.txt")
            _err(f"Writing clade annotations to file {path}")
            self._write_clades(path, detailed)
        if opts.print_subtrees_single > 1 and self.missing:
            from .list_tree import ListTree, write_single_subtree_lt
            _err(f"Computing the single subtree for added samples with "
                 f"{opts.print_subtrees_single} random leaves.\n")
            if lt is None:
                lt = ListTree.from_placer(self)
            lt.uncondense_leaves()
            write_single_subtree_lt(
                lt, [s.name for s in self.missing], outdir,
                opts.print_subtrees_single)
        if opts.print_subtrees_size > 1 and self.missing:
            from .list_tree import ListTree, write_sample_subtrees_lt
            _err("Computing subtrees for added samples.\n")
            if lt is None:
                lt = ListTree.from_placer(self)
            lt.uncondense_leaves()
            write_sample_subtrees_lt(
                lt, [s.name for s in self.missing], outdir,
                opts.print_subtrees_size)
        if opts.dout_filename:
            _err(f"Saving mutation-annotated tree object to file (after "
                 f"condensing identical sequences) {opts.dout_filename}")
            if lt is not None:
                self._save_lt(lt, opts.dout_filename)
            else:
                self.save_pb(opts.dout_filename)
        record_span("direct.write", t_us)

    # --- array-native writers ----------------------------------------------

    def write_newick(self, uncondense: bool = False,
                     with_score: bool = False):
        """final-tree.nh: internal labels, branch length = mutation count
        (write_newick semantics over the appended arrays).  With
        uncondense, a condensed leaf expands to its comma-joined member
        names with one branch length after the last (io/newick.py
        write_newick's uncondense_leaves form).

        Vectorized fragment-sort construction: each node contributes an
        open "(" at its DFS rank (internal only), a close/label at its DFS
        end, and a "," when a next sibling follows; fragments sort by
        (coordinate, close<comma<open, deeper-closes-first).  At a shared
        end coordinate the closing nodes form a descendant chain, of which
        only the top can have a next sibling — so one comma per coordinate,
        after all closes, is exact."""
        big = self.big
        big._flush()
        N = big.N
        counts = np.zeros(N, np.int64)
        nbase = self.ma.n
        counts[:nbase] = np.diff(self.ma.mut_ptr)
        for slot, muts in self._mut_delta.items():
            counts[slot] = len(muts)
        r = big.dfs_of.astype(np.int64)
        e = big.dfs_end_of.astype(np.int64)
        internal = e > r + 1
        has_next = e < e[big.parent]
        nh, ni = int(has_next.sum()), int(internal.sum())
        cmap = dict(self.ma.condensed) if uncondense else {}

        def label(i):
            nm = self.name_of(i)
            if cmap and not internal[i]:
                members = cmap.get(nm)
                if members is not None:
                    nm = ",".join(members)
            return f"{nm}:{int(counts[i])}"

        frags = [(")" if internal[i] else "") + label(i)
                 for i in range(N)]
        frags.extend([","] * nh)
        frags.extend(["("] * ni)
        pos = np.concatenate([e, e[has_next], r[internal]])
        kind = np.concatenate([np.zeros(N, np.int8),
                               np.ones(nh, np.int8),
                               np.full(ni, 2, np.int8)])
        lvl = np.concatenate([-big.level.astype(np.int64),
                              np.zeros(nh + ni, np.int64)])
        order = np.lexsort((lvl, kind, pos))
        nh_str = "".join([frags[i] for i in order]) + ";"
        if with_score:
            return nh_str, int(counts.sum())
        return nh_str

    def save_pb(self, path: str) -> None:
        """-o: the Tree driver's save discipline (driver.py:683-686 /
        usher_common.cpp:1033-1041) over arrays: expand the loaded
        condensed nodes, re-condense identical (zero-mutation polytomy)
        leaves fresh, and write a parsimony.pb byte-compatible with
        save_mat_pb — no host Node objects (placement/list_tree.py)."""
        from .list_tree import ListTree
        self._save_lt(ListTree.from_placer(self), path)

    def _save_lt(self, lt, path: str) -> None:
        from ..io import pb_arrays as pa
        lt.uncondense_leaves()
        lt.condense_leaves()
        self._internal_counter = lt.curr_internal_node
        big = self.big
        ma2 = lt.to_arrays(big.positions, big.ref, self.chrom,
                           big.pos_index)
        pa.save_arrays_to_pb(ma2, path)

    def _mutation_path(self, sample_name: str) -> str:
        try:
            slot = len(self._names) + self._extra_names.index(sample_name)
        except ValueError:
            return ""
        chain = []
        cur = slot
        while True:
            muts = self.mutations_of(cur)
            if muts:
                chain.append(self.name_of(cur) + ":"
                             + ",".join(m.get_string() for m in muts) + " ")
            p = int(self.big.parent[cur])
            if p == cur:
                break
            cur = p
        return sample_name + "\t" + "".join(reversed(chain)) + "\n"


def run_usher_direct(pb_path: str, vcf_path: str,
                     opts: DirectOptions, mesh=None) -> int:
    with timeit("direct.load"):
        placer = DirectPlacer(pb_path, vcf_path, mesh=mesh,
                              collapse=opts.collapse_tree)
    placer.place_all(opts)
    return 0

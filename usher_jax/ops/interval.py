"""DFS-interval scoring: the pandemic-scale placement/SPR scoring engine.

Replaces per-batch [N, C] path-state materialization (round 2's
pointer-doubling column path) with an observation about the scoring math:
at an entry column c, the per-(sample, node) correction term is a pure
function of (st, stp) at (n, c), and st is PIECEWISE CONSTANT over the
nested DFS intervals cut by the branch mutations in column c (the nearest
ancestor carrying a mutation at c determines st; stp differs from st only
AT the mutation-carrying nodes themselves).  So for a batch:

  score_T[n, b] = base[n] + add0[b] + cumsum_over_dfs(diff)[dfs(n), b]
  nc_T[n, b]    = nc_base[n] + point_scatter[dfs(n), b]

where `diff` receives, for every (sample entry, column mutation) pair,
 - a range delta over the mutation node's DFS interval
   (corr_nobm(mut_allele) - corr_nobm(par_allele)), and
 - a width-1 delta at the mutation node itself
   (corr_bm(mut, par) - corr_nobm(mut)),
and add0[b] accumulates the corr at reference-state nodes.  Per-batch
device cost is one scatter of O(sum over entries of column occupancy)
updates plus one [N, B] segmented cumsum — independent of how many unique
columns the batch touches, with NO dense per-column tensors anywhere.

Exactly the math of ops/placement_sparse._corr (case analysis in
core/bigmat.py builds the deltas); semantics of the reference scorer
usher_mapper.cpp:167-504 / the SPR re-placement formulation of
optimize/spr.py.  The cumsum telescopes the same per-position recurrence
the reference maintains incrementally while walking the tree.

Reduction (validity + tie-broken argmin + radius masks for SPR) runs on
device so only O(B) vectors cross the host-device link.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 30)


def _scan_rows(d):
    """Inclusive cumsum along axis 0 of an int32 [R, B] array.

    Two-level block scan: within-block prefix sums via a lower-triangular
    f32 matmul (exact for |values| < 2^24 — scoring deltas are O(entries),
    orders of magnitude below), block totals scanned associatively.  One
    device-memory read+write of the array instead of log2(R) shifted-add
    passes.
    """
    R, B = d.shape
    BLK = 256
    Rp = -(-R // BLK) * BLK
    if Rp != R:
        d = jnp.pad(d, ((0, Rp - R), (0, 0)))
    db = d.reshape(Rp // BLK, BLK, B).astype(jnp.float32)
    tri = jnp.tril(jnp.ones((BLK, BLK), jnp.float32))
    within = jnp.einsum("ij,njb->nib", tri, db,
                        precision=jax.lax.Precision.HIGHEST)
    totals = db.sum(axis=1)                         # [nb, B]
    prefix = jnp.cumsum(totals, axis=0) - totals    # exclusive
    out = (within + prefix[:, None, :]).astype(jnp.int32)
    return out.reshape(Rp, B)[:R]


@functools.partial(jax.jit, static_argnames=("n_pad", "b_pad"))
def interval_scores(ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val,
                    base_dfs, nc_base_dfs, add0,
                    n_pad: int, b_pad: int):
    """Score + num_common matrices in DFS order.

    ev_idx/ev_b/ev_val [R] int32  difference-array events (idx in 0..n_pad;
                                  idx == n_pad marks padding)
    nc_*               [Rn] int32 num_common point events (idx in 0..n_pad)
    base_dfs, nc_base_dfs [n_pad] int32, add0 [b_pad] int32
    Returns (score_dfs [n_pad, b_pad], nc_dfs [n_pad, b_pad]) int32.
    """
    diff = jnp.zeros((n_pad + 1, b_pad), jnp.int32)
    diff = diff.at[ev_idx, ev_b.astype(jnp.int32)].add(
        ev_val.astype(jnp.int32))
    run = _scan_rows(diff[:n_pad])
    score = base_dfs[:, None] + add0[None, :] + run
    ncd = jnp.zeros((n_pad + 1, b_pad), jnp.int32)
    ncd = ncd.at[nc_idx, nc_b.astype(jnp.int32)].add(
        nc_val.astype(jnp.int32))
    nc = nc_base_dfs[:, None] + ncd[:n_pad]
    return score, nc


def _tie_reduce(score, valid, num_leaves, bfs_rank):
    """Tie-broken argmin over the node axis (axis 0) of [N, B] inputs:
    min score, then max subtree leaves, then max BFS rank — the reference
    sequential-order winner (usher_mapper.cpp:458-497)."""
    s = jnp.where(valid, score, BIG)
    best = jnp.min(s, axis=0)
    is_best = valid & (score == best[None, :])
    num_best = is_best.sum(axis=0, dtype=jnp.int32)
    neg = jnp.int32(-1)
    lm = jnp.where(is_best, num_leaves[:, None], neg)
    best_leaves = jnp.max(lm, axis=0)
    is_best2 = is_best & (num_leaves[:, None] == best_leaves[None, :])
    rm = jnp.where(is_best2, bfs_rank[:, None], neg)
    best_rank = jnp.max(rm, axis=0)
    best_row = jnp.argmax((bfs_rank[:, None] == best_rank[None, :])
                          & is_best2, axis=0)
    return best, best_row.astype(jnp.int32), num_best


def _clade_hist(score, nc, valid, hu, best, is_leaf_dfs,
                clade_self_dfs, clade_par_dfs, n_clades: int):
    """Per-sample clade histogram over the TIE SET (valid nodes attaining
    the best score): hist[a, c, b] = #tied nodes whose clade assignment in
    annotation column a is c.  A tied node contributes its own propagated
    clade unless it is a leaf or has unique mutations, in which case the
    parent's (include_self = !leaf && !hu, usher_common.cpp:600-619).
    Clade ids are 0 (UNDEFINED) .. n_clades-1, precomputed per epoch by
    the host (placement/direct.py)."""
    A = clade_self_dfs.shape[0]
    n_pad, b_pad = score.shape
    tie = (valid & (score == best[None, :])).astype(jnp.int32)
    use_par = is_leaf_dfs[:, None] | hu
    bcol = jax.lax.broadcasted_iota(jnp.int32, (n_pad, b_pad), 1)
    hists = []
    for a in range(A):
        sel = jnp.where(use_par, clade_par_dfs[a][:, None],
                        clade_self_dfs[a][:, None])
        h = jnp.zeros((n_clades, b_pad), jnp.int32)
        h = h.at[sel.reshape(-1), bcol.reshape(-1)].add(tie.reshape(-1))
        hists.append(h)
    return jnp.stack(hists)


def _finish_place(score, nc, num_mut_dfs, is_leaf_dfs, is_root_dfs,
                  active_dfs, num_leaves_dfs, bfs_rank_dfs,
                  second: bool = False, clades=None):
    """Placement validity + tie-broken argmin + winner hu (the reference
    validity cases, usher_mapper.cpp:452-455) — shared by the host- and
    device-expansion entry points.

    second=True additionally reruns the reduction with the winner's row
    masked out — the runner-up result the incremental serving driver
    (placement/direct._BatchState) falls back on when the snapshot winner
    was modified by an earlier apply in the same batch.

    clades=(clade_self_dfs [A, n_pad], clade_par_dfs [A, n_pad],
    n_clades) appends the tie-set clade histogram (-D detailed clades)
    as a final [A, n_clades, b_pad] output."""
    hu = nc < num_mut_dfs[:, None]
    nc_pos = nc > 0
    leaf = is_leaf_dfs[:, None]
    valid = (is_root_dfs[:, None]
             | (leaf & nc_pos)
             | (~leaf & hu & nc_pos)
             | (~leaf & ~hu)) & active_dfs[:, None]
    best, best_row, num_best = _tie_reduce(score, valid, num_leaves_dfs,
                                           bfs_rank_dfs)
    hu_best = jnp.take_along_axis(hu, best_row[None, :], axis=0)[0]
    out = (best, best_row, num_best, hu_best)
    if second:
        rows = jax.lax.broadcasted_iota(jnp.int32, (score.shape[0], 1), 0)
        valid2 = valid & (rows != best_row[None, :])
        best2, best_row2, num_best2 = _tie_reduce(
            score, valid2, num_leaves_dfs, bfs_rank_dfs)
        hu2 = jnp.take_along_axis(hu, best_row2[None, :], axis=0)[0]
        out = out + (best2, best_row2, num_best2, hu2)
    if clades is not None:
        clade_self_dfs, clade_par_dfs, n_clades = clades
        out = out + (_clade_hist(score, nc, valid, hu, best, is_leaf_dfs,
                                 clade_self_dfs, clade_par_dfs, n_clades),)
    return out


def _finish_spr(score, nc, cnt, num_mut_dfs, is_root_dfs, active_dfs,
                num_leaves_dfs, bfs_rank_dfs, level_dfs,
                src_level, src_lo, src_hi, src_parent_row, radius,
                n_pad: int):
    """SPR validity + device radius mask (lca level from the nested
    ancestor-interval count) + reduction — shared by the host- and
    device-expansion entry points."""
    hu = nc < num_mut_dfs[:, None]
    nc_pos = nc > 0
    # dest leaves get sibling-split via has_unique (optimize/spr.py:70-75)
    valid = (is_root_dfs[:, None] | (hu & nc_pos) | (~hu)) \
        & active_dfs[:, None]
    lca_lvl = cnt - 1
    dist = level_dfs[:, None] + src_level[None, :] - 2 * lca_lvl
    rows = jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0)
    in_sub = (rows >= src_lo[None, :]) & (rows < src_hi[None, :])
    ok = (dist <= radius) & ~in_sub & (rows != src_parent_row[None, :])
    valid = valid & ok
    best, best_row, _ = _tie_reduce(score, valid, num_leaves_dfs,
                                    bfs_rank_dfs)
    hu_best = jnp.take_along_axis(hu, best_row[None, :], axis=0)[0]
    return best, best_row, hu_best


@functools.partial(jax.jit, static_argnames=("n_pad", "b_pad", "second",
                                             "n_clades"))
def interval_place(ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val,
                   base_dfs, nc_base_dfs, add0,
                   num_mut_dfs, is_leaf_dfs, is_root_dfs, active_dfs,
                   num_leaves_dfs, bfs_rank_dfs,
                   n_pad: int, b_pad: int, second: bool = False,
                   clade_self_dfs=None, clade_par_dfs=None,
                   n_clades: int = 0):
    """Fused: interval scoring + placement validity + tie-broken argmin.
    Returns (best_score [B], best_dfs_row [B], num_best [B], hu_best [B])
    — only O(B) crosses the device boundary.  second=True appends the
    winner-row-masked runner-up 4-tuple; n_clades>0 appends the tie-set
    clade histogram (see _finish_place)."""
    score, nc = interval_scores(ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val,
                                base_dfs, nc_base_dfs, add0, n_pad, b_pad)
    clades = (None if n_clades == 0
              else (clade_self_dfs, clade_par_dfs, n_clades))
    return _finish_place(score, nc, num_mut_dfs, is_leaf_dfs, is_root_dfs,
                         active_dfs, num_leaves_dfs, bfs_rank_dfs,
                         second=second, clades=clades)


def _expand_events(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                   pos, gval, kmiss, P: int, mc: int, spr: bool):
    """DEVICE-side event expansion: per (entry, column-mutation) pair deltas
    computed from the RESIDENT CSC index (uploaded once per epoch), so the
    per-batch H2D is just the [B, K] entry arrays.  Same case analysis as
    core/bigmat.py _events; mc bounds the column occupancy (pairs padded).

    csc_meta packs per-mutation fields: am | ap<<4 | root<<8 | eff<<9 |
    dead<<10.  Returns flattened (rows, b, val) difference events (3
    streams) + (nc_rows, nc_b, nc_val) point events; padding targets row
    `dead_row` (caller passes n_pad).
    """
    B, K = pos.shape
    valid_e = pos < P
    cols = jnp.clip(pos, 0, P - 1).astype(jnp.int32)
    lo = csc_ptr[cols]                        # [B, K]
    cnt = jnp.where(valid_e, csc_ptr[cols + 1] - lo, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (B, K, mc), 2)
    pair_ok = j < cnt[:, :, None]
    flat = jnp.clip(lo[:, :, None] + j, 0, csc_node.shape[0] - 1)
    u = csc_node[flat]
    m = csc_meta[flat]
    am = m & 0xF
    ap = (m >> 4) & 0xF
    rootm = (m >> 8) & 1
    effm = (m >> 9) & 1
    dead = (m >> 10) & 1
    pair_ok = pair_ok & (dead == 0)

    gv = gval.astype(jnp.int32)[:, :, None]
    km = kmiss[:, :, None]
    return (u, am, ap, rootm, effm, pair_ok, gv, km)


def _entry_deltas(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                  ref_cols, pos, gval, kmiss, n_pad, mc: int, spr: bool,
                  sgn=None, col_offset: int = 0, col_index=None):
    """Expansion + delta evaluation for one entry batch: returns
    (r, rend, flat_b, d_range, d_point, d_nc, add0) ready to scatter.
    sgn (+1/-1 per entry) negates contributions (signed residuals of the
    shared-ancestry decomposition); col_offset shifts the scatter columns
    (group batches land past the sample columns); col_index [B] overrides
    the row->column iota entirely (the FLAT entry-list packing: rows are
    individual entries with arbitrary target columns — no rectangular
    [B, K] waste)."""
    P = ref_cols.shape[0]
    B, K = pos.shape
    (u, am, ap, rootm, effm, pair_ok, gv, km) = _expand_events(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
        pos, gval, kmiss, P, mc, spr)
    valid_e = pos < P
    cols = jnp.clip(pos, 0, P - 1).astype(jnp.int32)
    rk_e = jnp.where(valid_e, ref_cols[cols].astype(jnp.int32), 0)
    rk = rk_e[:, :, None]

    def corr_nobm(a):
        t1 = ((~km) & ((gv & a) == 0)).astype(jnp.int32)
        if spr:
            sub = ((rk & a) == 0).astype(jnp.int32)
        else:
            sub = (a != rk).astype(jnp.int32)
        return t1 - sub

    c_am = corr_nobm(am)
    d_range = c_am - corr_nobm(ap)
    matched = (gv & am) != 0
    a_eff = jnp.where(matched, am, ap)
    t1_bm = ((~km) & ((gv & a_eff) == 0)).astype(jnp.int32)
    if spr:
        a_r = jnp.where((rk & am) != 0, am, ap)
        sub_bm = ((rk & a_r) == 0).astype(jnp.int32)
    else:
        sub_bm = jnp.where((rk & am) != 0, (am != rk).astype(jnp.int32),
                           (ap != rk).astype(jnp.int32))
    d_point = jnp.where(rootm == 1, 0, (t1_bm - sub_bm) - c_am)
    d_nc = jnp.where((effm == 1) & (rootm == 0),
                     ((gv & am) != 0).astype(jnp.int32)
                     - ((rk & am) != 0).astype(jnp.int32), 0)
    ok = pair_ok.astype(jnp.int32)
    if sgn is not None:
        ok = ok * sgn.astype(jnp.int32)[:, :, None]
    d_range = d_range * ok
    d_point = d_point * ok
    d_nc = d_nc * ok

    r = jnp.where(pair_ok, dfs_of[u], n_pad)
    rend = jnp.where(pair_ok, dfs_end_of[u], n_pad)
    if col_index is not None:
        flat_b = jnp.broadcast_to(
            col_index.astype(jnp.int32)[:, None, None],
            (B, K, mc)).reshape(-1)
    else:
        flat_b = (jax.lax.broadcasted_iota(jnp.int32, (B, K, mc), 0)
                  + col_offset).reshape(-1)
    add0_ind = ((~kmiss) & valid_e
                & ((gval.astype(jnp.int32) & rk_e) == 0)).astype(jnp.int32)
    if sgn is not None:
        add0_ind = add0_ind * sgn.astype(jnp.int32)
    add0 = jnp.sum(add0_ind, axis=1, dtype=jnp.int32)
    return r, rend, flat_b, d_range, d_point, d_nc, add0


def _dev_score_nc(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                  ref_cols, pos, gval, kmiss,
                  ov_idx, ov_b, ov_val, ovn_idx, ovn_b, ovn_val,
                  base_dfs, nc_base_dfs, n_pad, b_pad, mc, spr,
                  extra_cols: int = 0, cnt=None):
    """Shared core of the *_dev entry points: device-side expansion, delta
    evaluation, scatter (+ optional extra cnt channel folded into the same
    scan), cumsum, add0.  Returns (score, nc[, cnt_run])."""
    r, rend, flat_b, d_range, d_point, d_nc, add0 = _entry_deltas(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of, ref_cols,
        pos, gval, kmiss, n_pad, mc, spr)

    width = b_pad + extra_cols
    diff = jnp.zeros((n_pad + 1, width), jnp.int32)
    diff = diff.at[r.reshape(-1), flat_b].add(
        (d_range + d_point).reshape(-1))
    diff = diff.at[rend.reshape(-1), flat_b].add((-d_range).reshape(-1))
    diff = diff.at[jnp.minimum(r + 1, n_pad).reshape(-1), flat_b].add(
        (-d_point).reshape(-1))
    ncd = jnp.zeros((n_pad + 1, b_pad), jnp.int32)
    ncd = ncd.at[r.reshape(-1), flat_b].add(d_nc.reshape(-1))
    # overlay events from incremental appends (host-expanded, small)
    diff = diff.at[ov_idx, ov_b.astype(jnp.int32)].add(
        ov_val.astype(jnp.int32))
    if cnt is not None:
        cnt_idx, cnt_b, cnt_val = cnt
        diff = diff.at[cnt_idx, b_pad + cnt_b.astype(jnp.int32)].add(
            cnt_val.astype(jnp.int32))
    run = _scan_rows(diff[:n_pad])
    ncd = ncd.at[ovn_idx, ovn_b.astype(jnp.int32)].add(
        ovn_val.astype(jnp.int32))
    B = pos.shape[0]
    add0 = jnp.pad(add0, (0, b_pad - B))
    score = base_dfs[:, None] + add0[None, :] + run[:, :b_pad]
    nc = nc_base_dfs[:, None] + ncd[:n_pad]
    if cnt is not None:
        return score, nc, run[:, b_pad:]
    return score, nc


@functools.partial(jax.jit,
                   static_argnames=("n_pad", "b_pad", "mc", "spr",
                                    "second", "n_clades"))
def interval_place_dev(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                       ref_cols, pos, gval, kmiss,
                       ov_idx, ov_b, ov_val, ovn_idx, ovn_b, ovn_val,
                       base_dfs, nc_base_dfs,
                       num_mut_dfs, is_leaf_dfs, is_root_dfs, active_dfs,
                       num_leaves_dfs, bfs_rank_dfs,
                       n_pad: int, b_pad: int, mc: int, spr: bool = False,
                       second: bool = False,
                       clade_self_dfs=None, clade_par_dfs=None,
                       n_clades: int = 0):
    """interval_place with DEVICE-side event expansion from the resident
    CSC index: per-batch H2D is only the [B, K] entry arrays plus the
    (small) overlay event streams from incremental appends.  add0 is also
    computed on device.  Bit-identical to the host-expansion path
    (tested).  second=True appends the runner-up 4-tuple; n_clades>0
    appends the tie-set clade histogram."""
    score, nc = _dev_score_nc(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of, ref_cols,
        pos, gval, kmiss, ov_idx, ov_b, ov_val, ovn_idx, ovn_b, ovn_val,
        base_dfs, nc_base_dfs, n_pad, b_pad, mc, spr)
    clades = (None if n_clades == 0
              else (clade_self_dfs, clade_par_dfs, n_clades))
    return _finish_place(score, nc, num_mut_dfs, is_leaf_dfs, is_root_dfs,
                         active_dfs, num_leaves_dfs, bfs_rank_dfs,
                         second=second, clades=clades)


@functools.partial(jax.jit,
                   static_argnames=("n_pad", "b_pad", "g_pad", "mc",
                                    "second"))
def interval_place_flatgrp_dev(csc_ptr, csc_node, csc_meta, dfs_of,
                               dfs_end_of, ref_cols,
                               epos, egval, ekmiss, esgn, ecol, grp_of,
                               closure,
                               base_dfs, nc_base_dfs,
                               num_mut_dfs, is_leaf_dfs, is_root_dfs,
                               active_dfs, num_leaves_dfs, bfs_rank_dfs,
                               n_pad: int, b_pad: int, g_pad: int,
                               mc: int, second: bool = False):
    """Shared-ancestry scoring with the FLAT entry-list packing: every
    entry (residual and group alike) is one [E, 1] row with an explicit
    target scan column ecol [E] (0..b_pad-1 = samples, b_pad.. = group
    columns).  ONE expansion grid of exactly E*mc lanes, ONE scatter set,
    ONE scan over width b_pad+g_pad — the rectangular [B, K] waste and
    the duplicated per-pass fixed costs of the two-batch formulation are
    both gone (profiled ~60 ms fixed per pass at the 1M shape).  The
    per-sample combine is a stacked [n_pad, 2*g_pad] x [2*g_pad, ...]
    closure-and-gather matmul; bit-identical to place_arrays on the
    reconstructed full entry sets (tests/test_bigmat.py)."""
    r, rend, flat_b, d_range, d_point, d_nc, add0_e = _entry_deltas(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of, ref_cols,
        epos, egval, ekmiss, n_pad, mc, False, sgn=esgn, col_index=ecol)
    width = b_pad + g_pad
    diff = jnp.zeros((n_pad + 1, width), jnp.int32)
    diff = diff.at[r.reshape(-1), flat_b].add(
        (d_range + d_point).reshape(-1))
    diff = diff.at[rend.reshape(-1), flat_b].add((-d_range).reshape(-1))
    diff = diff.at[jnp.minimum(r + 1, n_pad).reshape(-1), flat_b].add(
        (-d_point).reshape(-1))
    ncd = jnp.zeros((n_pad + 1, width), jnp.int32)
    ncd = ncd.at[r.reshape(-1), flat_b].add(d_nc.reshape(-1))
    ncd = ncd[:n_pad]
    run = _scan_rows(diff[:n_pad])
    add0 = jnp.zeros(width, jnp.int32).at[ecol.astype(jnp.int32)].add(
        add0_e)
    g = grp_of.astype(jnp.int32)
    M = closure.astype(jnp.float32)[:, g]        # [g_pad, b_pad]
    resolved_run = jnp.einsum(
        "ng,gb->nb", run[:, b_pad:].astype(jnp.float32), M,
        precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    resolved_ncd = jnp.einsum(
        "ng,gb->nb", ncd[:, b_pad:].astype(jnp.float32), M,
        precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    add0_c = add0[:b_pad] + jnp.matmul(
        add0[b_pad:].astype(jnp.float32), M,
        precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    score = base_dfs[:, None] + add0_c[None, :] + run[:, :b_pad] \
        + resolved_run
    nc = nc_base_dfs[:, None] + ncd[:, :b_pad] + resolved_ncd
    return _finish_place(score, nc, num_mut_dfs, is_leaf_dfs, is_root_dfs,
                         active_dfs, num_leaves_dfs, bfs_rank_dfs,
                         second=second)


@functools.partial(jax.jit, static_argnames=("n_pad", "b_pad", "mc"))
def interval_spr_dev(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                     ref_cols, pos, gval,
                     cnt_idx, cnt_b, cnt_val,
                     base_dfs, nc_base_dfs,
                     num_mut_dfs, is_root_dfs, active_dfs,
                     num_leaves_dfs, bfs_rank_dfs, level_dfs,
                     src_level, src_lo, src_hi, src_parent_row, radius,
                     n_pad: int, b_pad: int, mc: int):
    """interval_spr with device-side event expansion: the per-chunk H2D is
    the [B, K] source-deviation arrays + the (tiny) ancestor-interval
    events, instead of the fully expanded (entry x column-mutation) event
    streams.  Bit-identical to interval_spr (tested)."""
    B, K = pos.shape
    kmiss = jnp.zeros((B, K), dtype=jnp.bool_)
    z = jnp.zeros(0, jnp.int32)
    score, nc, cnt = _dev_score_nc(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of, ref_cols,
        pos, gval, kmiss, z, z, z, z, z, z,
        base_dfs, nc_base_dfs, n_pad, b_pad, mc, spr=True,
        extra_cols=b_pad, cnt=(cnt_idx, cnt_b, cnt_val))

    return _finish_spr(score, nc, cnt, num_mut_dfs, is_root_dfs,
                       active_dfs, num_leaves_dfs, bfs_rank_dfs, level_dfs,
                       src_level, src_lo, src_hi, src_parent_row, radius,
                       n_pad)


@functools.partial(jax.jit, static_argnames=("n_pad", "b_pad"))
def interval_spr(ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val,
                 cnt_idx, cnt_b, cnt_val,
                 base_dfs, nc_base_dfs, add0,
                 num_mut_dfs, is_root_dfs, active_dfs,
                 num_leaves_dfs, bfs_rank_dfs, level_dfs,
                 src_level, src_lo, src_hi, src_parent_row, radius,
                 n_pad: int, b_pad: int):
    """Fused SPR destination search for a batch of pruned sources.

    On top of interval_place's machinery, the radius bound is ALSO a
    nested-interval computation: the LCA level of (src, dst) for every dst
    equals (#proper-ancestors-of-src whose DFS interval contains dst) - 1,
    so cnt_* scatters +1 over each ancestor interval and shares the same
    difference-array cumsum (replacing the reference's per-node pointer
    walks, Profitable_Moves_Enumerators.hpp:166, and round 2's host
    O(depth*N) loop).  src_lo/src_hi/src_parent_row are DFS rows.
    Returns (best_cost [B], best_dfs_row [B], hu_best [B]).
    """
    # stack the score and ancestor-count channels into one scan
    diff = jnp.zeros((n_pad + 1, 2 * b_pad), jnp.int32)
    diff = diff.at[ev_idx, ev_b.astype(jnp.int32)].add(
        ev_val.astype(jnp.int32))
    diff = diff.at[cnt_idx, b_pad + cnt_b.astype(jnp.int32)].add(
        cnt_val.astype(jnp.int32))
    run = _scan_rows(diff[:n_pad])
    score = base_dfs[:, None] + add0[None, :] + run[:, :b_pad]
    cnt = run[:, b_pad:]

    ncd = jnp.zeros((n_pad + 1, b_pad), jnp.int32)
    ncd = ncd.at[nc_idx, nc_b.astype(jnp.int32)].add(
        nc_val.astype(jnp.int32))
    nc = nc_base_dfs[:, None] + ncd[:n_pad]
    return _finish_spr(score, nc, cnt, num_mut_dfs, is_root_dfs,
                       active_dfs, num_leaves_dfs, bfs_rank_dfs, level_dfs,
                       src_level, src_lo, src_hi, src_parent_row, radius,
                       n_pad)


def pad_events(idx, b, val, n_pad, bucket: int = 4096):
    """Bucket event arrays (x1.5 growth) so batch-to-batch event-count
    drift doesn't retrigger compilation; padding events target the dead row
    n_pad with value 0.  Sample ids ship as int16 and values as int8
    (|delta| <= 4) to cut host-to-device volume; the kernels upcast on
    device."""
    r = len(idx)
    cap = bucket
    while cap < r:
        cap = cap * 3 // 2
    pi = np.full(cap, n_pad, np.int32)
    pb = np.zeros(cap, np.int16)
    pv = np.zeros(cap, np.int8)
    pi[:r] = idx
    pb[:r] = b
    pv[:r] = val
    return pi, pb, pv


# --- multi-chip composition (batch-axis shard_map) ---------------------------
#
# The device-mesh analog of the reference's replicated-tree / sharded-samples
# follower protocol (place_sample.cpp:591-662): the CSR metadata (tens of MB
# even at 2M nodes) is replicated per device, the sample/source batch and its
# event streams are sharded, and each device runs the identical single-device
# program on its shard.  Placement needs zero collectives (outputs are
# per-sample); results are bit-identical to single-device by construction.

def shard_events(ev, nd, bl, n_pad, bucket: int = 4096):
    """Split raw (idx, b, val) events by destination device (sample b // bl)
    into [nd, Rd] stacks with a common bucket; sample ids become local."""
    idx, b, val = (np.asarray(idx_) for idx_ in ev)
    d = b // bl
    order = np.argsort(d, kind="stable")
    idx, b, d = idx[order], b[order], d[order]
    val = np.asarray(ev[2])[order]
    counts = np.bincount(d, minlength=nd)
    cap = bucket
    mx = int(counts.max()) if len(counts) else 0
    while cap < mx:
        cap = cap * 3 // 2
    out_i = np.full((nd, cap), n_pad, np.int32)
    out_b = np.zeros((nd, cap), np.int16)
    out_v = np.zeros((nd, cap), np.int8)
    start = 0
    for dd in range(nd):
        c = int(counts[dd])
        out_i[dd, :c] = idx[start:start + c]
        out_b[dd, :c] = b[start:start + c] - dd * bl
        out_v[dd, :c] = val[start:start + c]
        start += c
    return out_i, out_b, out_v


@functools.lru_cache(maxsize=None)
def _place_sharded_fn(mesh, axis, n_pad: int, bl: int):
    from jax.sharding import PartitionSpec as P
    ev_spec = P(axis, None)
    rep = P()

    def body(ei, eb, ev, ni, nb, nv, base, ncb, a0,
             nm, lf, rt, ac, nl, br):
        return interval_place(ei[0], eb[0], ev[0], ni[0], nb[0], nv[0],
                              base, ncb, a0, nm, lf, rt, ac, nl, br,
                              n_pad, bl)

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(ev_spec,) * 6 + (rep, rep, P(axis))
                      + (rep,) * 6,
                      out_specs=(P(axis),) * 4)
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _scores_sharded_fn(mesh, axis, n_pad: int, bl: int):
    from jax.sharding import PartitionSpec as P
    ev_spec = P(axis, None)
    rep = P()

    def body(ei, eb, ev, ni, nb, nv, base, ncb, a0):
        return interval_scores(ei[0], eb[0], ev[0], ni[0], nb[0], nv[0],
                               base, ncb, a0, n_pad, bl)

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(ev_spec,) * 6 + (rep, rep, P(axis)),
                      out_specs=(P(None, axis),) * 2)
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _spr_sharded_fn(mesh, axis, n_pad: int, bl: int):
    from jax.sharding import PartitionSpec as P
    ev_spec = P(axis, None)
    rep = P()

    def body(ei, eb, ev, ni, nb, nv, ci, cb, cv, base, ncb, a0,
             nm, rt, ac, nl, br, lv, sl, slo, shi, spr_, radius):
        return interval_spr(ei[0], eb[0], ev[0], ni[0], nb[0], nv[0],
                            ci[0], cb[0], cv[0], base, ncb, a0,
                            nm, rt, ac, nl, br, lv, sl, slo, shi, spr_,
                            radius, n_pad, bl)

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(ev_spec,) * 9 + (rep, rep, P(axis))
                      + (rep,) * 6 + (P(axis),) * 4 + (rep,),
                      out_specs=(P(axis),) * 3)
    return jax.jit(f)


# --- segment-query placement: O(events * log N) instead of O(N * B) ---------
#
# The [n_pad, b_pad] score matrix is piecewise constant per sample: between
# a sample's difference-array event rows, score(n) = base(n) + add0 + R
# with R the event prefix at the segment, and nc(n) = nc_base(n) (nc point
# events only touch event rows).  So validity off event rows is the STATIC
# validity, and the tie-broken argmin over a segment is a precomputed
# range-min-monoid query over (base, count@min, num_leaves, bfs_rank, row)
# restricted to statically-valid rows.  Per sample the reduction touches
# only ~3*K*occupancy event rows exactly plus one sparse-table query per
# segment — the device-side analog of the reference's per-sample
# mutation-list walk (usher_mapper.cpp:167-504), with the same results as
# the full-matrix kernel (bit-identical; cross-checked in
# tests/test_interval_seg.py).

_SEG_INF = jnp.int32(BIG)


def _seg_combine(a, b):
    """Monoid combine for (key, cnt, lv, rk, row): min key; equal keys sum
    counts and keep the (num_leaves, bfs_rank)-max winner — the reference
    tie-break (usher_mapper.cpp:458-497)."""
    ka, ca, la, ra, wa = a
    kb, cb, lb, rb, wb = b
    key = jnp.minimum(ka, kb)
    cnt = jnp.where(ka == kb, ca + cb, jnp.where(kb < ka, cb, ca))
    b_wins = (kb < ka) | ((kb == ka)
                          & ((lb > la) | ((lb == la) & (rb > ra))))
    lv = jnp.where(b_wins, lb, la)
    rk = jnp.where(b_wins, rb, ra)
    row = jnp.where(b_wins, wb, wa)
    return key, cnt, lv, rk, row


def _build_seg_table(base_dfs, nc_base_dfs, num_mut_dfs, is_leaf_dfs,
                     is_root_dfs, active_dfs, num_leaves_dfs,
                     bfs_rank_dfs, n_pad: int):
    """Sparse table of the static-valid monoid over DFS rows: T[k][i]
    summarizes rows [i, i + 2^k).  Built on device each call (log2(n_pad)
    vectorized combines — microseconds next to the per-batch work)."""
    hu_s = nc_base_dfs < num_mut_dfs
    ncp = nc_base_dfs > 0
    leaf = is_leaf_dfs
    static_valid = (is_root_dfs | (leaf & ncp) | (~leaf & hu_s & ncp)
                    | (~leaf & ~hu_s)) & active_dfs
    key0 = jnp.where(static_valid, base_dfs, _SEG_INF)
    rows0 = jax.lax.iota(jnp.int32, n_pad)
    levels = [(key0, jnp.ones(n_pad, jnp.int32), num_leaves_dfs,
               bfs_rank_dfs, rows0)]
    L = max(1, int(n_pad).bit_length())
    pad_cell = (jnp.full(1, _SEG_INF), jnp.zeros(1, jnp.int32),
                jnp.full(1, -1, jnp.int32), jnp.full(1, -1, jnp.int32),
                jnp.full(1, n_pad, jnp.int32))
    for k in range(1, L):
        sh = 1 << (k - 1)
        prev = levels[-1]
        shifted = tuple(
            jnp.concatenate([p[sh:], jnp.broadcast_to(pc, (min(sh, n_pad),))])
            for p, pc in zip(prev, pad_cell))
        levels.append(_seg_combine(prev, shifted))
    return (tuple(jnp.stack([lv[f] for lv in levels]) for f in range(5)),
            hu_s, L)


def _seg_query(table, L, l, r):
    """Range query over [l, r] (inclusive; empty when l > r) — DISJOINT
    binary-lifting walk (the classic two-overlapping-lookup trick is only
    valid for idempotent monoids; count@min is not idempotent)."""
    tk, tc, tl, tr, tw = table
    n_pad = tk.shape[1]
    acc = (jnp.full_like(l, _SEG_INF), jnp.zeros_like(l),
           jnp.full_like(l, -1), jnp.full_like(l, -1),
           jnp.full_like(l, n_pad))
    cur = jnp.clip(l, 0, n_pad)
    rem = jnp.maximum(r - l + 1, 0)
    for k in range(L - 1, -1, -1):
        step = 1 << k
        take = rem >= step
        idx = jnp.clip(cur, 0, n_pad - 1)
        cell = (tk[k, idx], tc[k, idx], tl[k, idx], tr[k, idx],
                tw[k, idx])
        cand = _seg_combine(acc, cell)
        acc = tuple(jnp.where(take, c, a) for c, a in zip(cand, acc))
        cur = jnp.where(take, cur + step, cur)
        rem = jnp.where(take, rem - step, rem)
    return acc


def _seg_reduce(cands):
    """(best, best_row, num_best, hu_best) from candidate tuples
    (score, cnt, lv, rk, row, hu) each [B, S] — the same min / count /
    (leaves, rank)-max semantics as _tie_reduce over full matrices."""
    score, cnt, lv, rk, row, hu = cands
    best = jnp.min(score, axis=1)
    at = score == best[:, None]
    num_best = jnp.sum(jnp.where(at, cnt, 0), axis=1)
    neg = jnp.int32(-1)
    lvm = jnp.where(at, lv, neg)
    best_lv = jnp.max(lvm, axis=1)
    at2 = at & (lv == best_lv[:, None])
    rkm = jnp.where(at2, rk, neg)
    best_rk = jnp.max(rkm, axis=1)
    j = jnp.argmax(at2 & (rk == best_rk[:, None]), axis=1)
    best_row = jnp.take_along_axis(row, j[:, None], axis=1)[:, 0]
    hu_best = jnp.take_along_axis(hu, j[:, None], axis=1)[:, 0]
    return best, best_row.astype(jnp.int32), num_best.astype(jnp.int32), \
        hu_best


def _seg_candidates(table, hu_s, L, rows_sorted, P_incl, add0,
                    nc_events, base_dfs, nc_base_dfs, num_mut_dfs,
                    is_leaf_dfs, is_root_dfs, active_dfs, num_leaves_dfs,
                    bfs_rank_dfs, n_pad: int, exclude_row=None):
    """Candidate set for one reduction pass: exact evaluations at the
    (deduplicated) event rows + one monoid query per inter-event segment.
    exclude_row [B] masks one DFS row (the runner-up pass)."""
    B, Et = rows_sorted.shape
    # keep-LAST duplicate: its inclusive prefix is the full sum at the row
    keep = jnp.concatenate(
        [rows_sorted[:, :-1] != rows_sorted[:, 1:],
         jnp.ones((B, 1), bool)], axis=1)
    rc = jnp.clip(rows_sorted, 0, n_pad - 1)
    # nc at each row: every nc event's row IS a score-event row (pair
    # starts and overlay-nc boundaries are in the stream by construction),
    # so the nc values ride the SAME sort as a payload channel and the
    # per-row sum is a prefix difference across the duplicate group —
    # no searchsorted (vmapped searchsorted lowers to per-element scans)
    ncP = nc_events   # inclusive prefix of the sorted nc payload
    iota = jax.lax.broadcasted_iota(jnp.int32, (B, Et), 1)
    kept_idx = jnp.where(keep, iota, -1)
    prev_kept = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32),
         jax.lax.cummax(kept_idx, axis=1)[:, :-1]], axis=1)
    ncP0 = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), ncP], axis=1)
    nc_at = ncP - jnp.take_along_axis(ncP0, prev_kept + 1, axis=1)
    nc_r = nc_base_dfs[rc] + nc_at
    hu_r = nc_r < num_mut_dfs[rc]
    ncp_r = nc_r > 0
    leaf_r = is_leaf_dfs[rc]
    valid_r = (is_root_dfs[rc] | (leaf_r & ncp_r)
               | (~leaf_r & hu_r & ncp_r)
               | (~leaf_r & ~hu_r)) & active_dfs[rc]
    score_r = base_dfs[rc] + add0[:, None] + P_incl
    mask_r = keep & (rows_sorted < n_pad) & valid_r
    if exclude_row is not None:
        mask_r = mask_r & (rows_sorted != exclude_row[:, None])
    exact = (jnp.where(mask_r, score_r, _SEG_INF),
             jnp.ones((B, Et), jnp.int32),
             num_leaves_dfs[rc], bfs_rank_dfs[rc], rows_sorted, hu_r)

    # segments: [prev_row + 1, row - 1] with R = prefix at prev_row;
    # sentinel -1/0 in front, n_pad behind (padding rows land there)
    pr_rows = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), rows_sorted], axis=1)
    pr_P = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), P_incl], axis=1)
    nx_rows = jnp.concatenate(
        [rows_sorted, jnp.full((B, 1), n_pad, jnp.int32)], axis=1)
    l = pr_rows + 1
    r = nx_rows - 1
    if exclude_row is None:
        key, cnt, lv, rk, row = _seg_query(table, L, l, r)
        seg = (jnp.where(key >= _SEG_INF, _SEG_INF,
                         key + add0[:, None] + pr_P),
               cnt, lv, rk, row, hu_s[jnp.clip(row, 0, n_pad - 1)])
        return tuple(jnp.concatenate([a, b], axis=1)
                     for a, b in zip(exact, seg))
    # runner-up pass: split the segment containing the excluded row
    w = exclude_row[:, None]
    contains = (l <= w) & (w <= r)
    k1, c1, l1_, r1_, w1 = _seg_query(table, L, l,
                                      jnp.where(contains, w - 1, r))
    k2, c2, l2_, r2_, w2 = _seg_query(
        table, L, jnp.where(contains, w + 1, jnp.int32(1)),
        jnp.where(contains, r, jnp.int32(0)))
    segs = []
    for kq, cq, lq, rq, wq in ((k1, c1, l1_, r1_, w1),
                               (k2, c2, l2_, r2_, w2)):
        segs.append((jnp.where(kq >= _SEG_INF, _SEG_INF,
                               kq + add0[:, None] + pr_P),
                     cq, lq, rq, wq,
                     hu_s[jnp.clip(wq, 0, n_pad - 1)]))
    return tuple(jnp.concatenate([a, b, c], axis=1)
                 for a, b, c in zip(exact, *segs))


@functools.partial(jax.jit,
                   static_argnames=("n_pad", "b_pad", "mc", "ecap",
                                    "second"))
def interval_place_seg_dev(csc_ptr, csc_node, csc_meta, dfs_of,
                           dfs_end_of, ref_cols, pos, gval, kmiss,
                           ov_rows, ov_vals, ovn_rows, ovn_vals,
                           base_dfs, nc_base_dfs,
                           num_mut_dfs, is_leaf_dfs, is_root_dfs,
                           active_dfs, num_leaves_dfs, bfs_rank_dfs,
                           n_pad: int, b_pad: int, mc: int, ecap: int,
                           second: bool = False):
    """Placement via segment queries: device-side event expansion like
    interval_place_dev, but no [n_pad, b_pad] matrices are ever formed.
    ov_rows/ov_vals are PER-SAMPLE padded overlay score events (row n_pad
    = padding); ovn_* the overlay nc point events.  ecap bounds the REAL
    (non-padding) pair count of any sample (host-verified): the [K, mc]
    expansion is mostly padding, and compacting to ecap slots before the
    sort/gather phases is what keeps them small.  Returns the same
    (best, best_dfs_row, num_best, hu_best)[ + runner-up 4-tuple]."""
    P = ref_cols.shape[0]
    B, K = pos.shape
    (u, am, ap, rootm, effm, pair_ok, gv, km) = _expand_events(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
        pos, gval, kmiss, P, mc, False)
    valid_e = pos < P
    cols = jnp.clip(pos, 0, P - 1).astype(jnp.int32)
    rk_e = jnp.where(valid_e, ref_cols[cols].astype(jnp.int32), 0)
    rk = rk_e[:, :, None]

    def corr_nobm(a):
        t1 = ((~km) & ((gv & a) == 0)).astype(jnp.int32)
        return t1 - (a != rk).astype(jnp.int32)

    c_am = corr_nobm(am)
    d_range = c_am - corr_nobm(ap)
    matched = (gv & am) != 0
    a_eff = jnp.where(matched, am, ap)
    t1_bm = ((~km) & ((gv & a_eff) == 0)).astype(jnp.int32)
    sub_bm = jnp.where((rk & am) != 0, (am != rk).astype(jnp.int32),
                       (ap != rk).astype(jnp.int32))
    d_point = jnp.where(rootm == 1, 0, (t1_bm - sub_bm) - c_am)
    d_nc = jnp.where((effm == 1) & (rootm == 0),
                     ((gv & am) != 0).astype(jnp.int32)
                     - ((rk & am) != 0).astype(jnp.int32), 0)
    ok = pair_ok.astype(jnp.int32)
    d_range = (d_range * ok).reshape(B, K * mc)
    d_point = (d_point * ok).reshape(B, K * mc)
    d_nc = (d_nc * ok).reshape(B, K * mc)
    r_s = jnp.where(pair_ok, dfs_of[u], n_pad).reshape(B, K * mc)
    r_e = jnp.where(pair_ok, dfs_end_of[u], n_pad).reshape(B, K * mc)

    # compact the ok pairs into ecap slots (cumsum-position scatter):
    # everything downstream (sorts, table walks) runs at O(ecap), not
    # O(K * mc).  Every PAD pair gets a unique overflow destination —
    # funnelling ~K*mc pads into one shared slot makes the scatter's
    # duplicate handling serialize.
    okf = pair_ok.reshape(B, K * mc)
    lane = jax.lax.broadcasted_iota(jnp.int32, (B, K * mc), 1)
    dst = jnp.where(okf, jnp.cumsum(okf, axis=1) - 1, ecap + lane)
    bcol = jax.lax.broadcasted_iota(jnp.int32, (B, K * mc), 0)

    def compact(x, fill):
        out = jnp.full((B, ecap + K * mc), fill, x.dtype)
        out = out.at[bcol.reshape(-1), dst.reshape(-1)].set(
            x.reshape(-1), unique_indices=True, mode="drop")
        return out[:, :ecap]

    d_range = compact(d_range, 0)
    d_point = compact(d_point, 0)
    d_nc = compact(d_nc, 0)
    r_s = compact(r_s, jnp.int32(n_pad))
    r_e = compact(r_e, jnp.int32(n_pad))

    add0 = jnp.sum(((~kmiss) & valid_e
                    & ((gval.astype(jnp.int32) & rk_e) == 0)),
                   axis=1, dtype=jnp.int32)

    # per-sample score events (3 per pair) + overlay events + the overlay
    # nc rows as zero-val boundaries (their rows must split segments)
    ev_rows = jnp.concatenate(
        [r_s, jnp.minimum(r_s + 1, n_pad), r_e, ov_rows, ovn_rows],
        axis=1)
    ev_vals = jnp.concatenate(
        [d_range + d_point, -d_point, -d_range, ov_vals,
         jnp.zeros_like(ovn_rows)], axis=1)
    # nc payload channel aligned with the event streams: pair starts
    # carry d_nc, overlay-nc boundary rows carry ovn_vals, the rest 0
    ev_ncv = jnp.concatenate(
        [d_nc, jnp.zeros_like(d_point), jnp.zeros_like(d_range),
         jnp.zeros_like(ov_vals), ovn_vals], axis=1)
    order = jnp.argsort(ev_rows, axis=1)
    rows_sorted = jnp.take_along_axis(ev_rows, order, axis=1)
    vals_sorted = jnp.take_along_axis(ev_vals, order, axis=1)
    P_incl = jnp.cumsum(vals_sorted, axis=1)
    nc_events = jnp.cumsum(
        jnp.take_along_axis(ev_ncv, order, axis=1), axis=1)

    table, hu_s, L = _build_seg_table(
        base_dfs, nc_base_dfs, num_mut_dfs, is_leaf_dfs, is_root_dfs,
        active_dfs, num_leaves_dfs, bfs_rank_dfs, n_pad)
    margs = (base_dfs, nc_base_dfs, num_mut_dfs, is_leaf_dfs,
             is_root_dfs, active_dfs, num_leaves_dfs, bfs_rank_dfs)
    cands = _seg_candidates(table, hu_s, L, rows_sorted, P_incl, add0,
                            nc_events, *margs, n_pad)
    best, best_row, num_best, hu_best = _seg_reduce(cands)
    out = (best, best_row, num_best, hu_best)
    if second:
        cands2 = _seg_candidates(table, hu_s, L, rows_sorted, P_incl,
                                 add0, nc_events, *margs, n_pad,
                                 exclude_row=best_row)
        out = out + _seg_reduce(cands2)
    return out


def pad_overlay_by_sample(idx, b, val, b_pad: int, n_pad: int,
                          bucket: int = 64):
    """Flat overlay event streams (row, sample, val) -> per-sample padded
    [b_pad, E] arrays for the segment kernel (padding row = n_pad)."""
    counts = np.bincount(b, minlength=b_pad) if len(b) else \
        np.zeros(b_pad, np.int64)
    mx = int(counts.max()) if len(b) else 0
    E = bucket
    while E < mx:
        E *= 2
    rows = np.full((b_pad, E), n_pad, np.int32)
    vals = np.zeros((b_pad, E), np.int32)
    if len(b):
        order = np.argsort(b, kind="stable")
        ofs = np.cumsum(counts) - counts   # group start per sample
        pos_in = np.arange(len(b)) - ofs[b[order]]
        rows[b[order], pos_in] = idx[order]
        vals[b[order], pos_in] = val[order]
    return rows, vals

"""Batched placement scoring for sparse samples (plain JAX).

Mathematically identical to ops.placement.score_batch (the reference scoring
semantics of usher_mapper.cpp:167-504 — see ops/placement.py for the
derivation), but restructured around the workload's sparsity: a sample has
only a few dozen VCF entries out of the P segregating sites, and at every
no-entry position the per-(sample,node) term collapses to a sample-
independent value.

Decomposition (exact, by case analysis on g == ref at no-entry positions):

  score[b,n]      = base[n]    + sum_k corr(b, n, pos[b,k])
  num_common[b,n] = nc_base[n] + sum_k corr_nc(b, n, pos[b,k])

  base[n]    = sum_p [ (ref & st) != 0 ? st != ref
                       : (st != stp ? stp != ref : 1) ]
               (the no-entry g == ref case of the dense term1|term2,
               valid for ambiguous multi-bit states too)
  nc_base[n] = #{p : st != stp  and  (ref & st) != 0}

and the per-entry corrections only need st/stp at the K entry positions of
sample b.  Those are read by one column gather of the packed states
(st | stp << 4, one byte per (node, position)) into [N, B, K]; XLA fuses the
gather, the case analysis and the K-slot sum into one reduction, so the
[N, B, K] tensor never reaches device memory.  (On an H100 this node-major
form measured ~6x faster than gathering rows of the position-major
transpose, which XLA did not fuse; PERF.md.)

Work drops from O(B*N*P) (dense path) to O(N*P) + O(B*N*K).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .placement import reduce_best

# Largest entry-slot count K the host encoders (sparsify*) produce.  A sample
# with more VCF entries than this is scored by the dense path.
MAX_ENTRY_SLOTS = 1024


def _no_entry_terms(st, stp, ref):
    """(base [N], nc_base [N], node_num_mut [N]) int32: the sample-
    independent aggregates over every position."""
    sti = st.astype(jnp.int32)
    stpi = stp.astype(jnp.int32)
    refi = ref.astype(jnp.int32)[None, :]
    bm = sti != stpi
    # no-entry term with g == ref: A = (bm & ~matched) ? stp : st, term =
    # A != ref.  (At lane-padding positions ref == st == 0 this is exactly
    # 0, unlike the shortcut "(ref & st) == 0 implies st != ref" which
    # assumes ref != 0.)
    base = jnp.where(bm & ((refi & sti) == 0), stpi != refi,
                     sti != refi).sum(1, dtype=jnp.int32)
    nc_base = (bm & ((refi & sti) != 0)).sum(1, dtype=jnp.int32)
    node_num_mut = bm.sum(1, dtype=jnp.int32)
    return base, nc_base, node_num_mut


def _corr(st_k, stp_k, gv, kvalid, kmiss, rk, spr: bool):
    """Per-(sample, slot, node) correction terms: what an entry changes
    against the no-entry aggregate.  st_k/stp_k are the gathered states,
    gv/kvalid/kmiss/rk the per-slot sample allele, slot validity, missing
    flag and reference allele (broadcast against the node axis)."""
    bm = st_k != stp_k
    matched = (gv & st_k) != 0
    matched_r = (rk & st_k) != 0
    a = jnp.where(bm & ~matched, stp_k, st_k)
    term1 = jnp.where(~kmiss & ((gv & a) == 0), 1, 0)
    # what this position contributed to base[n] (the g == ref value), to be
    # replaced by term1.  Two base semantics exist:
    #  - placement (spr=False): no-entry term (A_r != ref)
    #  - SPR (spr=True): E=1-everywhere term ((ref & A_r) == 0)
    #    (optimize/spr.py _score_moves; differs when A_r is a multi-bit
    #    ambiguity mask containing ref)
    if spr:
        a_r = jnp.where(bm & ~matched_r, stp_k, st_k)
        sub = jnp.where((rk & a_r) == 0, 1, 0)
    else:
        sub = jnp.where(bm & ~matched_r,
                        jnp.where(stp_k != rk, 1, 0),
                        jnp.where(st_k != rk, 1, 0))
    corr = jnp.where(kvalid, term1 - sub, 0)
    nca = jnp.where(bm & matched, 1, 0)
    ncb = jnp.where(bm & matched_r, 1, 0)
    corr_nc = jnp.where(kvalid, nca - ncb, 0)
    return corr, corr_nc


def _entry_sums(st, stp, ref, pos, gval, kmiss, spr: bool = False):
    """Per-sample K-slot sums of the corrections: (cs [N, B], ns [N, B])
    int32.  pos [B, K] indexes st's column axis; pos >= st.shape[1] marks a
    padding slot."""
    P = st.shape[1]
    posi = pos.astype(jnp.int32)
    kvalid = (posi < P)[None]                            # [1, B, K]
    pc = jnp.clip(posi, 0, P - 1)
    packed = st.astype(jnp.uint8) | (stp.astype(jnp.uint8) << 4)
    v = packed[:, pc].astype(jnp.int32)                  # [N, B, K]
    rk = ref.astype(jnp.int32)[pc][None]
    corr, corr_nc = _corr(v & 0xF, v >> 4, gval.astype(jnp.int32)[None],
                          kvalid, kmiss.astype(bool)[None], rk, spr)
    return corr.sum(2, dtype=jnp.int32), corr_nc.sum(2, dtype=jnp.int32)


def _parent_states(st, parent, root_slot):
    stp = st[parent]
    return stp.at[root_slot].set(st[root_slot])


@functools.partial(jax.jit, static_argnames=("k_slots",))
def score_sparse_T(st, parent, root_slot, ref, pos, gval, kmiss, k_slots: int):
    """Node-major sparse scoring.

    st     [N, P] uint8   path-state nibbles
    parent [N]    int32
    ref    [P]    uint8
    pos    [B, K] int32   entry positions (>= P means padding slot)
    gval   [B, K] uint8   sample allele mask per entry (0xF at missing)
    kmiss  [B, K] bool    entry is missing (N)
    k_slots = K (kept static so each slot count compiles once).

    Returns (score_T [N, B] int32, num_common_T [N, B] int32,
             node_num_mut [N] int32) — exactly score_batch's outputs,
    transposed, without the inactive-slot masking (callers mask).
    """
    return score_sparse_stp_T(st, _parent_states(st, parent, root_slot),
                              ref, pos, gval, kmiss, k_slots)


@functools.partial(jax.jit, static_argnames=("k_slots",))
def score_sparse_stp_T(st, stp, ref, pos, gval, kmiss, k_slots: int):
    """score_sparse_T with the parent states supplied directly — the form
    the sharded mesh path uses (stp is precomputed per tree refresh so a
    node shard is self-contained; parallel/mesh.py)."""
    base, nc_base, node_num_mut = _no_entry_terms(st, stp, ref)
    cs, ns = _entry_sums(st, stp, ref, pos, gval, kmiss)
    return base[:, None] + cs, nc_base[:, None] + ns, node_num_mut


@functools.partial(jax.jit, static_argnames=("k_slots", "n_anc", "spr"))
def score_cols_T(m0, anc, parent, root_slot, ref_cols, base, nc_base,
                 pos, gval, kmiss, k_slots: int, n_anc: int,
                 spr: bool = False):
    """Column-subset scoring for CSR-backed MATs (core/bigmat.py): path
    states at the batch's C entry columns are materialized on device by
    pointer-doubling over ancestor tables, then scored like score_sparse_T.

    m0       [N, C] uint8  node's OWN branch-mutation allele at column c
                           (0 = none; alleles are nonzero nibbles)
    anc      [n_anc, N] i32  anc[k] = 2^k-th ancestor (root points to itself)
    ref_cols [C] uint8     reference allele per column
    base, nc_base [N] i32  full-genome no-entry aggregates (host precomputed)
    pos      [B, K] i32    entry COLUMN indices (>= C marks padding)
    Returns (score_T [N, B], num_common_T [N, B]) int32.
    """
    val = m0
    for k in range(n_anc):
        val = jnp.where(val > 0, val, val[anc[k]])
    st_cols = jnp.where(val > 0, val, ref_cols[None, :])
    stp_cols = _parent_states(st_cols, parent, root_slot)
    cs, ns = _entry_sums(st_cols, stp_cols, ref_cols, pos, gval, kmiss,
                         spr=spr)
    return base[:, None] + cs, nc_base[:, None] + ns


def valid_mask_T(score_t, nc_t, node_num_mut, is_root_mask, is_leaf, active):
    """Node-major validity (ops.placement.valid_mask transposed)."""
    has_unique = nc_t < node_num_mut[:, None]
    nc_pos = nc_t > 0
    leaf = is_leaf[:, None]
    valid = (is_root_mask[:, None]
             | (leaf & nc_pos)
             | (~leaf & has_unique & nc_pos)
             | (~leaf & ~has_unique))
    return valid & active[:, None], has_unique


def reduce_best_T(score_t, valid_t, num_leaves, bfs_rank):
    """Per-sample argmin over the node axis with the reference tie-break
    (ops.placement.reduce_best on [N, B] inputs)."""
    return reduce_best(score_t.T, valid_t.T, num_leaves, bfs_rank)


@functools.partial(jax.jit, static_argnames=("k_slots",))
def placement_step_sparse(st, parent, root_slot, ref, active, is_leaf,
                          is_root_mask, num_leaves, bfs_rank,
                          pos, gval, kmiss, k_slots: int):
    """Sparse equivalent of ops.placement.placement_step: gathered scoring
    + validity + tie-broken argmin in one jitted program.  Returns
    (best_score [B], best_slot [B], num_best [B])."""
    stp = _parent_states(st, parent, root_slot)
    base, nc_base, nnm = _no_entry_terms(st, stp, ref)
    cs, ns = _entry_sums(st, stp, ref, pos, gval, kmiss)
    score_t = base[:, None] + cs                         # [N, B]
    valid_t, _ = valid_mask_T(score_t, nc_base[:, None] + ns, nnm,
                              is_root_mask, is_leaf, active)
    return reduce_best_T(score_t, valid_t, num_leaves, bfs_rank)


def slot_count(kmax: int, k_slots=None) -> int:
    """Power-of-two slot count >= kmax (at least k_slots or 8)."""
    K = k_slots or 8
    while K < max(kmax, 1):
        K *= 2
    if K > MAX_ENTRY_SLOTS:
        raise ValueError(f"sample has {kmax} entries > "
                         f"MAX_ENTRY_SLOTS={MAX_ENTRY_SLOTS}")
    return K


def sparsify(samples_mutations, pos_index, P, k_slots=None):
    """Host-side: mutation lists -> (pos [B,K] i32, gval [B,K] u8,
    kmiss [B,K] bool) padded to a power-of-two K <= MAX_ENTRY_SLOTS.
    Attribute extraction is one flat pass; slot assignment is vectorized."""
    from ..core.nuc import N as NUC_N
    B = len(samples_mutations)
    lens = np.fromiter((len(m) for m in samples_mutations),
                       dtype=np.int64, count=B)
    kmax = int(lens.max()) if B else 1
    K = slot_count(kmax, k_slots)
    pos = np.full((B, K), P, dtype=np.int32)
    gval = np.zeros((B, K), dtype=np.uint8)
    kmiss = np.zeros((B, K), dtype=bool)
    total = int(lens.sum())
    if total:
        flat = [m for muts in samples_mutations for m in muts]
        try:
            fpos = np.fromiter((pos_index[m.position] for m in flat),
                               dtype=np.int32, count=total)
        except KeyError:
            bad = next(m.position for m in flat
                       if m.position not in pos_index)
            raise KeyError(f"sample position {bad} not in MAT")
        fmiss = np.fromiter((m.is_missing for m in flat),
                            dtype=bool, count=total)
        fval = np.fromiter((m.mut_nuc for m in flat),
                           dtype=np.uint8, count=total)
        b_idx = np.repeat(np.arange(B), lens)
        starts = np.cumsum(lens) - lens
        k_idx = np.arange(total) - np.repeat(starts, lens)
        pos[b_idx, k_idx] = fpos
        gval[b_idx, k_idx] = np.where(fmiss, NUC_N, fval)
        kmiss[b_idx, k_idx] = fmiss
    return pos, gval, kmiss


def sparsify_dense(g, E, miss, k_slots=None):
    """Host-side: dense (g, E, miss) sample encoding -> sparse slot arrays
    (fully vectorized).  Requires g == ref at ~E positions
    (encode_samples guarantees this)."""
    g = np.asarray(g)
    E = np.asarray(E)
    miss = np.asarray(miss)
    B, P = g.shape
    counts = E.sum(1)
    K = slot_count(int(counts.max()) if B else 1, k_slots)
    pos = np.full((B, K), P, dtype=np.int32)
    gval = np.zeros((B, K), dtype=np.uint8)
    kmiss = np.zeros((B, K), dtype=bool)
    b_idx, p_idx = np.nonzero(E)          # row-major: sorted by (b, p)
    if len(b_idx):
        starts = np.cumsum(counts) - counts
        k_idx = np.arange(len(b_idx)) - starts[b_idx]
        pos[b_idx, k_idx] = p_idx
        gval[b_idx, k_idx] = g[b_idx, p_idx]
        kmiss[b_idx, k_idx] = miss[b_idx, p_idx]
    return pos, gval, kmiss

"""RIPPLES recombination detection, on device.

Semantics transcribed from reference src/ripples/main.cpp:167-714 with the
ripples-fast prefix-count acceleration (src/ripples/ripples_fast/ripples.hpp
Mut_Count_t) realized as device tensor ops:

For each candidate node (branch length >= branch_len, >= num_descendants
leaves): the node's root-path mutation set is the "pruned sample".  ONE
fused device pass produces the per-(node, position) parsimony-cost indicator
matrix C[n,p] (the summand of the placement score), so

  full placement score[n]             = sum_p C[n,p]
  donor score  (i,j)[n]               = sum_{p in [pos_i, pos_{j-1}]} C[n,p]
  acceptor score (i,j)[n]             = score[n] - donor score[n]

via a single cumulative sum along the sorted position axis -- every
breakpoint pair for every node costs O(1) gathers instead of the reference's
O(nodes x mutations) rescans per pair.  Donor/acceptor pairing, interval
refinement against the donor's path mutations, and interval merging
(combine_intervals, main.cpp:133-164) run on host exactly as the reference.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..core.flat import FlatMAT, collect_positions
from ..core.tree import Mutation, Tree
from ..ops.placement import score_with_stp


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclass
class RipplesOptions:
    branch_len: int = 3            # -l
    num_descendants: int = 10      # -n
    parsimony_improvement: int = 3 # -p
    min_range: int = 1_000         # -r
    max_range: int = 10_000_000    # -R
    start_idx: int = -1            # -S
    end_idx: int = -1              # -E
    outdir: str = "."
    samples_file: str = ""


@dataclass
class RecombNode:
    name: str
    node_parsimony: int
    parsimony: int
    is_sibling: str


@dataclass
class RecombInterval:
    d: RecombNode
    a: RecombNode
    start_range_low: int
    start_range_high: int
    end_range_low: int
    end_range_high: int


def pruned_sample_mutations(node) -> list[Mutation]:
    """Node->root path mutations, nearest-per-position, net-reference entries
    dropped, par_nuc reset to ref (reference Pruned_Sample::add_mutation,
    main.cpp:68-82)."""
    positions: set[int] = set()
    out: list[Mutation] = []
    cur = node
    while cur is not None:
        for m in cur.mutations:
            if m.position not in positions:
                if m.ref_nuc != m.mut_nuc:
                    mm = m.copy()
                    mm.par_nuc = mm.ref_nuc
                    out.append(mm)
            positions.add(m.position)
        cur = cur.parent
    out.sort(key=lambda m: m.position)
    return out


@jax.jit
def _cost_matrix(st, stp, ref, active, g, E, miss):
    """Per-(node,position) cost indicators + per-node totals + has_unique."""
    bm = st != stp
    gb = g[:, None, :]
    matched = (gb & st[None, :, :]) != 0
    excl = bm[None, :, :] & ~matched
    A = jnp.where(excl, stp[None, :, :], st[None, :, :])
    Eb = E[:, None, :]
    term1 = Eb & (~miss[:, None, :]) & ((gb & A) == 0)
    term2 = (~Eb) & (A != ref[None, None, :])
    C = (term1 | term2)[0]                                   # [N,P]
    num_common = (bm[None, :, :] & matched)[0].sum(-1, dtype=jnp.int32)
    node_num_mut = bm.sum(-1, dtype=jnp.int32)
    has_unique = num_common < node_num_mut
    total = C.sum(-1, dtype=jnp.int32)
    csum = jnp.cumsum(C.astype(jnp.int32), axis=-1)
    return csum, total, has_unique


def combine_intervals(pairs: list[RecombInterval]) -> list[RecombInterval]:
    """Merge adjacent equal-scoring intervals (reference main.cpp:133-164)."""
    pairs = sorted(pairs, key=lambda p: p.end_range_low)
    i = 0
    while i < len(pairs):
        j = i + 1
        while j < len(pairs):
            pi, pj = pairs[i], pairs[j]
            if (pi.d.name == pj.d.name and pi.a.name == pj.a.name
                    and pi.start_range_low == pj.start_range_low
                    and pi.start_range_high == pj.start_range_high
                    and pi.end_range_high == pj.end_range_low
                    and pi.d.parsimony + pi.a.parsimony
                    == pj.d.parsimony + pj.a.parsimony):
                pi.end_range_high = pj.end_range_high
                del pairs[j]
            else:
                j += 1
        i += 1
    pairs.sort(key=lambda p: p.start_range_low)
    i = 0
    while i < len(pairs):
        j = i + 1
        while j < len(pairs):
            pi, pj = pairs[i], pairs[j]
            if (pi.d.name == pj.d.name and pi.a.name == pj.a.name
                    and pi.end_range_low == pj.end_range_low
                    and pi.end_range_high == pj.end_range_high
                    and pi.start_range_high == pj.start_range_low
                    and pi.d.parsimony + pi.a.parsimony
                    == pj.d.parsimony + pj.a.parsimony):
                pi.start_range_high = pj.start_range_high
                del pairs[j]
            else:
                j += 1
        i += 1
    return pairs


def ripples_main(T: Tree, opts: RipplesOptions) -> int:
    T.uncondense_leaves()
    bfs = T.breadth_first_expansion()

    # candidate long branches (main.cpp:196-254)
    if opts.samples_file:
        from ..matutils.select import read_sample_names
        cand_set: set[str] = set()
        for s in read_sample_names(opts.samples_file):
            n = T.get_node(s)
            if n is None:
                _err(f"ERROR: Node id {s} not found!")
                return 1
            cur = n
            while cur is not None:
                cand_set.add(cur.identifier)
                cur = cur.parent
        candidates = sorted(cand_set)
    else:
        candidates = sorted(
            n.identifier for n in bfs
            if n.parent is not None and len(n.mutations) >= opts.branch_len
            and T.get_num_leaves(n) >= opts.num_descendants)
    # the reference shuffles with seed 0 for load balancing across -S/-E
    import random
    random.Random(0).shuffle(candidates)
    _err(f"Found {len(candidates)} long branches")

    os.makedirs(opts.outdir, exist_ok=True)
    desc_file = open(os.path.join(opts.outdir, "descendants.tsv"), "w")
    desc_file.write("#node_id\tdescendants\n")
    recomb_file = open(os.path.join(opts.outdir, "recombination.tsv"), "w")
    recomb_file.write(
        "#recomb_node_id\tbreakpoint-1_interval\tbreakpoint-2_interval\t"
        "donor_node_id\tdonor_is_sibling\tdonor_parsimony\tacceptor_node_id\t"
        "acceptor_is_sibling\tacceptor_parsimony\toriginal_parsimony\t"
        "min_starting_parsimony\trecomb_parsimony\n")

    s = 0
    e = len(candidates)
    if opts.start_idx >= 0 and opts.end_idx >= 0:
        s = opts.start_idx
        e = min(opts.end_idx, e)

    positions, ref, chrom = collect_positions(T)
    flat = FlatMAT(T, positions, ref, chrom)
    st_dev, parent_dev = flat.sync()
    stp = np.asarray(st_dev)[np.asarray(parent_dev)]
    stp[flat.root_slot] = np.asarray(st_dev)[flat.root_slot]
    stp_dev = jnp.asarray(stp)
    active = np.zeros(flat.cap, dtype=bool)
    num_leaves_arr = np.zeros(flat.cap, dtype=np.int64)
    meta = flat.order_arrays()
    active = meta["active"]
    num_leaves_arr = meta["num_leaves"]
    ref_dev = jnp.asarray(flat.ref)
    active_dev = jnp.asarray(active)

    GENOME_SIZE = 10 ** 9
    num_done = 0
    for idx in range(s, e):
        nid = candidates[idx]
        node = T.get_node(nid)
        _err(f"At node id: {nid}")
        orig_parsimony = len(node.mutations)

        sample_muts = pruned_sample_mutations(node)
        num_mutations = len(sample_muts)
        if num_mutations == 0:
            num_done += 1
            continue

        g, E, miss = flat.encode_samples([sample_muts])
        csum, total, has_unique = _cost_matrix(
            st_dev, stp_dev, ref_dev, active_dev,
            jnp.asarray(g), jnp.asarray(E), jnp.asarray(miss))
        csum = np.asarray(csum)
        total = np.asarray(total)
        has_unique = np.asarray(has_unique)

        # node eligibility: enough descendants, not in candidate's subtree
        T.depth_first_expansion()
        lo, hi = node.dfs_idx, node.dfs_end_idx
        eligible = np.zeros(flat.cap, dtype=bool)
        names = [None] * flat.cap
        leaf_or_unique = has_unique.copy()
        for n2 in bfs:
            slot = n2.slot
            names[slot] = n2.identifier
            if (num_leaves_arr[slot] >= opts.num_descendants
                    and not (lo <= n2.dfs_idx < hi)):
                eligible[slot] = True
            if n2.is_leaf():
                leaf_or_unique[slot] = True

        pos_of = [m.position for m in sample_muts]
        col_of = [flat.pos_index[p] for p in pos_of]

        valid_pairs: list[RecombInterval] = []
        has_recomb = False
        for i in range(num_mutations):
            for j in range(i, num_mutations):
                start_range_high = pos_of[i]
                start_range_low = pos_of[i - 1] if i >= 1 else 0
                end_range_high = GENOME_SIZE
                end_range_low = pos_of[j - 1] if j >= 1 else 0

                donor_count = j - i
                acceptor_count = num_mutations - donor_count
                if (donor_count < opts.branch_len
                        or acceptor_count < opts.branch_len
                        or end_range_low - start_range_high < opts.min_range
                        or end_range_low - start_range_high > opts.max_range):
                    continue

                # donor interval = positions in [pos_i, pos_{j-1}]
                hi_col = col_of[j - 1] if j >= 1 else 0
                lo_col = col_of[i]
                donor_p = csum[:, hi_col] - (csum[:, lo_col - 1]
                                             if lo_col > 0 else 0)
                acceptor_p = total - donor_p

                thr = orig_parsimony - opts.parsimony_improvement
                acc_ok = eligible & (acceptor_p <= thr)
                don_ok = eligible & (donor_p <= thr)
                if not acc_ok.any() or not don_ok.any():
                    continue

                # reference sorts candidates by (interval parsimony, name)
                acc_slots = np.nonzero(acc_ok)[0]
                don_slots = np.nonzero(don_ok)[0]
                acc_list = sorted(
                    ((int(acceptor_p[k]), names[k], k) for k in acc_slots))
                don_list = sorted(
                    ((int(donor_p[k]), names[k], k) for k in don_slots))

                found = None
                for dp, dname, dk in don_list[:1000]:
                    for ap_, aname, ak in acc_list[:1000]:
                        if (dname != aname and dname != nid and aname != nid
                                and orig_parsimony >= dp + ap_
                                + opts.parsimony_improvement):
                            found = (dp, dname, dk, ap_, aname, ak)
                            break
                    if found:
                        break
                if not found:
                    continue
                dp, dname, dk, ap_, aname, ak = found

                # refine breakpoint intervals against donor-path and sample
                # mutations (main.cpp:609-663)
                donor_path = pruned_sample_mutations(T.get_node(dname))
                sample_pos = set(pos_of)
                donor_pos = {m.position for m in donor_path}
                for p in donor_pos:
                    if start_range_low < p <= start_range_high and \
                            p not in sample_pos:
                        start_range_low = p
                    if end_range_low < p <= end_range_high and \
                            p not in sample_pos:
                        end_range_high = p
                for p in sample_pos:
                    if start_range_low < p <= start_range_high and \
                            p not in donor_pos:
                        start_range_low = p
                    if end_range_low < p <= end_range_high and \
                            p not in donor_pos:
                        end_range_high = p

                d = RecombNode(dname, int(total[dk]), dp,
                               "y" if leaf_or_unique[dk] else "n")
                a = RecombNode(aname, int(total[ak]), ap_,
                               "y" if leaf_or_unique[ak] else "n")
                valid_pairs.append(RecombInterval(
                    d, a, start_range_low, start_range_high,
                    end_range_low, end_range_high))
                has_recomb = True

        valid_pairs = combine_intervals(valid_pairs)
        for p in valid_pairs:
            erh = ("GENOME_SIZE" if p.end_range_high == GENOME_SIZE
                   else str(p.end_range_high))
            recomb_file.write(
                f"{nid}\t({p.start_range_low},{p.start_range_high})\t"
                f"({p.end_range_low},{erh})\t{p.d.name}\t{p.d.is_sibling}\t"
                f"{p.d.node_parsimony}\t{p.a.name}\t{p.a.is_sibling}\t"
                f"{p.a.node_parsimony}\t{orig_parsimony}\t"
                f"{min(orig_parsimony, p.d.node_parsimony, p.a.node_parsimony)}\t"
                f"{p.d.parsimony + p.a.parsimony}\n")
        recomb_file.flush()

        num_done += 1
        if has_recomb:
            desc_file.write(nid + "\t" + ",".join(
                l.identifier for l in T.get_leaves(nid)) + ",\n")
            desc_file.flush()
            _err(f"Done {num_done}/{len(candidates)} branches "
                 f"[RECOMBINATION FOUND!]\n")
        else:
            _err(f"Done {num_done}/{len(candidates)} branches\n")

    desc_file.close()
    recomb_file.close()
    return 0

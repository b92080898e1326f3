"""Benchmark: batched maximum-parsimony placement scoring throughput.

Headline workload: BASELINE.json config #3 scale -- a synthetic 100k-node
MAT over 512 segregating sites, a batch of 1024 samples, every sample
scored against EVERY tree node (the reference's hot loop #1,
usher_mapper.cpp:167-504) plus the validity + argmin/tie-break reduction,
all as ONE jitted device step, via the sparse entry-column scorer
(ops/placement_sparse.placement_step_sparse, bit-identical to the dense
path, which the run cross-checks).

Metric: samples placed/sec (scoring + best-placement reduction; host tree
surgery is amortized bookkeeping in both systems).

vs_baseline: the reference binary cannot be built in this image (no MPI /
boost), so the baseline is the same scoring math executed by single-core
vectorized numpy, scaled x64 (a stand-in for 64-thread CPU UShER; numpy's
fused elementwise loops are comparable to the reference's memory-bound C++
scan, and the reference's early-exit pruning is offset by numpy's SIMD).

Needs a GPU: without one it exits non-zero, unless JAX_PLATFORMS=cpu asks
for a CPU run explicitly (then only the headline and the reference fixture
run, and the numbers describe XLA's CPU backend).

Prints ONE json line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Supplementary phases (BASELINE.md's declared metrics) print labeled JSON
lines to STDERR, each naming the device:
  node_score_evals_per_sec      headline workload, N*B / t
  dense_cross_check             dense path on the headline workload
  realistic_100k_x_30k          genome-width tree via the interval engine
  pandemic_1m_x_30k             1M-node CSR MAT via the interval engine
  reference_fixture             4k-leaf global_phylo.nh + 423-site VCF
  mesh8_overhead_ratio          sharded-vs-single wall ratio on the
                                8-device virtual CPU mesh (structure check,
                                not device scaling)
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
FIXTURES = os.path.join(REPO, "tests", "fixtures")

N_NODES = 100_000
P_SITES = 512
BATCH = 1024
MUTS_PER_SAMPLE = 16
NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)

_T0 = time.time()


def _progress(msg, t0=_T0):
    print(f"[bench +{time.time()-t0:.1f}s] {msg}", file=sys.stderr, flush=True)


def device_info():
    """The device as JAX reports it (named in every result line)."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": jax.device_count()}


# the phases that run in CPU-only subprocesses on 8 virtual devices
VIRTUAL_CPU8 = {"platform": "cpu", "kind": "cpu", "count": 8}


def _aux(phase, device=None, **kv):
    print(json.dumps({"phase": phase, **kv,
                      "device": device or device_info()}),
          file=sys.stderr, flush=True)


def synth_flat_mat(rng):
    """Random MAT as flat arrays: parent pointers (topologically ordered),
    path states derived root->leaf with ~3 branch mutations per node."""
    ref = NIBBLES[rng.integers(0, 4, size=P_SITES)]
    parent = np.zeros(N_NODES, dtype=np.int32)
    parent[1:] = (rng.random(N_NODES - 1)
                  * np.arange(N_NODES - 1)).astype(np.int32)
    st = np.zeros((N_NODES, P_SITES), dtype=np.uint8)
    st[0] = ref
    n_mut = 3
    mut_pos = rng.integers(0, P_SITES, size=(N_NODES, n_mut))
    mut_allele = NIBBLES[rng.integers(0, 4, size=(N_NODES, n_mut))]
    for i in range(1, N_NODES):
        row = st[parent[i]].copy()
        row[mut_pos[i]] = mut_allele[i]
        st[i] = row

    is_leaf = np.ones(N_NODES, dtype=bool)
    is_leaf[parent[1:]] = False
    is_leaf[0] = False
    num_leaves = np.zeros(N_NODES, dtype=np.int32)
    num_leaves[is_leaf] = 1
    for i in range(N_NODES - 1, 0, -1):
        num_leaves[parent[i]] += num_leaves[i]
    active = np.ones(N_NODES, dtype=bool)
    is_root = np.zeros(N_NODES, dtype=bool)
    is_root[0] = True
    bfs_rank = np.arange(N_NODES, dtype=np.int32)  # topo order ~ BFS for ties
    return st, parent, ref, active, is_leaf, is_root, num_leaves, bfs_rank


def synth_samples(rng, ref):
    g = np.tile(ref, (BATCH, 1))
    E = np.zeros((BATCH, P_SITES), dtype=bool)
    miss = np.zeros((BATCH, P_SITES), dtype=bool)
    for b in range(BATCH):
        idx = rng.choice(P_SITES, size=MUTS_PER_SAMPLE, replace=False)
        g[b, idx] = NIBBLES[rng.integers(0, 4, size=MUTS_PER_SAMPLE)]
        E[b, idx] = True
    return g, E, miss


def numpy_score_batch(st, stp, ref, g, E, miss):
    """Single-core numpy version of the same scoring (the CPU baseline)."""
    bm = st != stp
    B = g.shape[0]
    scores = np.empty((B, st.shape[0]), dtype=np.int32)
    for b in range(B):
        matched = (g[b][None, :] & st) != 0
        excl = bm & ~matched
        A = np.where(excl, stp, st)
        term1 = E[b][None, :] & (~miss[b][None, :]) & ((g[b][None, :] & A) == 0)
        term2 = (~E[b][None, :]) & (A != ref[None, :])
        scores[b] = (term1 | term2).sum(axis=-1)
    return scores


def synth_bigmat(rng, N, P, n_mut=2):
    """Synthetic CSR MAT for the interval-engine phases."""
    from usher_jax.core.bigmat import BigMAT
    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    M = n_mut * (N - 1)
    mut_ptr = np.zeros(N + 1, dtype=np.int64)
    mut_ptr[2:] = n_mut * np.arange(1, N, dtype=np.int64)
    mut_col = rng.integers(0, P, size=M).astype(np.int32)
    mut_mut = NIBBLES[rng.integers(0, 4, size=M)]
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    mut_par = ref[mut_col].copy()
    same = mut_par == mut_mut
    mut_mut[same] = NIBBLES[(np.searchsorted(NIBBLES, mut_mut[same]) + 1) % 4]
    positions = np.arange(P, dtype=np.int64)
    return BigMAT(parent, mut_ptr, mut_col, mut_par, mut_mut, positions, ref)


def bench_interval(rng, N, P, B, K, label):
    """samples/s + evals/s of BigMAT.place_arrays (device-reduced interval
    engine) at the given shape, with an honest numpy-x64 anchor: the SAME
    difference-array scoring run single-core on the host (place_one_host),
    scaled x64 as the 64-thread-CPU stand-in (measured at the shapes
    where the scatter bound bites, not only the 512-site legacy shape)."""
    t0 = time.time()
    big = synth_bigmat(rng, N, P)
    _progress(f"{label}: built {N}-node CSR MAT in {time.time()-t0:.1f}s")
    pos = rng.integers(0, P, size=(B, K)).astype(np.int32)
    gval = NIBBLES[rng.integers(0, 4, size=(B, K))]
    kmiss = np.zeros((B, K), dtype=bool)
    Kp = 32
    pos = np.concatenate(
        [pos, np.full((B, Kp - K), P, np.int32)], axis=1)
    gval = np.concatenate([gval, np.zeros((B, Kp - K), np.uint8)], axis=1)
    kmiss = np.concatenate([kmiss, np.zeros((B, Kp - K), bool)], axis=1)
    # numpy single-core anchor (same math, host difference-array engine)
    nb = 4
    t0 = time.time()
    for b in range(nb):
        big.place_one_host(pos[b:b + 1], gval[b:b + 1], kmiss[b:b + 1])
    cpu_rate_64t = nb / (time.time() - t0) * 64
    _progress(f"{label}: numpy 1-core x64 anchor = "
              f"{cpu_rate_64t:.0f} samples/s")
    t0 = time.time()
    big.place_arrays(pos, gval, kmiss)
    compile_s = time.time() - t0
    _progress(f"{label}: first batch (compile incl.) {compile_s:.1f}s")
    iters = 5 if compile_s < 120 else 2
    t0 = time.time()
    for _ in range(iters):
        big.place_arrays(pos, gval, kmiss)
    dt = (time.time() - t0) / iters
    _aux(label, ms_per_batch=round(dt * 1e3, 1), B=B,
         samples_per_sec=round(B / dt, 1),
         node_score_evals_per_sec=round(N * B / dt),
         numpy_x64_samples_per_sec=round(cpu_rate_64t, 1),
         vs_baseline=round(B / dt / cpu_rate_64t, 2))
    return dt


def synth_lineage_bigmat(rng, N, P, n_lineages=64, stem=30, n_mut=2):
    """Lineage-structured synthetic MAT: n_lineages mutation-carrying
    stems of `stem` chained branches below the root (the Pango-clade
    backbone of the public MAT), each carrying a random recursive
    subtree.  Uniformly-drawn leaves then share their lineage's stem
    mutations — the structural-sharing regime real batches measure
    (87.8% duplicate scatter events, bench phase real_batch_dedup),
    which the flat random-recursive synth_bigmat topology lacks (its
    random leaf pairs meet near the root)."""
    from usher_jax.core.bigmat import BigMAT
    parent = np.zeros(N, dtype=np.int32)
    idx = 1
    stem_end = np.zeros(n_lineages, np.int32)
    for li in range(n_lineages):
        prev = 0
        for _ in range(stem):
            parent[idx] = prev
            prev = idx
            idx += 1
        stem_end[li] = prev
    rem = N - idx
    i_arr = np.arange(rem)
    li_arr = i_arr % n_lineages
    t_arr = i_arr // n_lineages          # index within the lineage body
    u = (rng.random(rem) * (t_arr + 1)).astype(np.int64)
    parent[idx:] = np.where(u == 0, stem_end[li_arr],
                            idx + (u - 1) * n_lineages + li_arr)
    M = n_mut * (N - 1)
    mut_ptr = np.zeros(N + 1, dtype=np.int64)
    mut_ptr[2:] = n_mut * np.arange(1, N, dtype=np.int64)
    mut_col = rng.integers(0, P, size=M).astype(np.int32)
    mut_mut = NIBBLES[rng.integers(0, 4, size=M)]
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    mut_par = ref[mut_col].copy()
    same = mut_par == mut_mut
    mut_mut[same] = NIBBLES[(np.searchsorted(NIBBLES, mut_mut[same]) + 1)
                            % 4]
    positions = np.arange(P, dtype=np.int64)
    return BigMAT(parent, mut_ptr, mut_col, mut_par, mut_mut, positions,
                  ref)


def full_genotype_inputs(big, slots):
    """Entry arrays (pos, gval, kmiss) holding the full genotype (every
    root-path mutation) of each node in slots: the plain form of a
    re-placement batch."""
    from usher_jax.matutils.arrays import _ancestral_set_triplets
    full = [_ancestral_set_triplets(big, s) for s in slots]
    K = max(len(f) for f in full)
    pos = np.full((len(slots), K), big.P, np.int32)
    gval = np.zeros((len(slots), K), np.uint8)
    for i, f in enumerate(full):
        for k, (c, v) in enumerate(f):
            pos[i, k] = c
            gval[i, k] = v
    return pos, gval, np.zeros((len(slots), K), bool)


def bench_replace_grouped(rng, N, P, B, min_group=3,
                          label="replace_1m_grouped", lineage=True):
    """Re-placement of the MAT's OWN leaves (the EPP/uncertainty bulk
    workload, reference usher uncertainty re-scoring) — plain full-
    genotype scoring vs the shared-ancestry decomposition
    (BigMAT.place_arrays_grouped).  Leaf genotypes share every root-path
    mutation above their batch anchors, so the sharing here is
    STRUCTURAL (phylogenetic descent), not manufactured: the honest
    real-distribution case."""
    t0 = time.time()
    big = (synth_lineage_bigmat if lineage else synth_bigmat)(rng, N, P)
    _progress(f"{label}: built {N}-node "
              f"{'lineage-structured ' if lineage else ''}CSR MAT in "
              f"{time.time()-t0:.1f}s")
    par = set(big.parent.tolist())
    leaves = np.array([i for i in range(big.N) if i not in par])
    slots = rng.choice(leaves, size=B, replace=False).tolist()
    # chunk at 512: bounds the grouped combine's gathered [n_pad, B] adds,
    # which sit on top of the plain path's peak memory at the 1M shape
    cb = min(512, B)
    chunks = [slots[o:o + cb] for o in range(0, B, cb)]
    t0 = time.time()
    grouped = [big.group_ancestral_batch(c, min_group=min_group)
               for c in chunks]
    group_host_s = time.time() - t0

    plain_in = [full_genotype_inputs(big, c) for c in chunks]
    K = max(p[0].shape[1] for p in plain_in)
    k_res = max(g[0].shape[1] for g in grouped)
    k_grp = max(g[4].shape[1] for g in grouped)
    G = sum(g[4].shape[0] for g in grouped)
    _progress(f"{label}: full grid {B}x{K}, grouped {B}x{k_res} + "
              f"{G}x{k_grp} over {len(chunks)} chunks "
              f"(host grouping {group_host_s:.2f}s)")

    for pi, gi in zip(plain_in, grouped):
        r_plain = big.place_arrays(*pi)
        r_grp = big.place_arrays_grouped(*gi)
        for a, b in zip(r_plain, r_grp):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    iters = 4
    t0 = time.time()
    for _ in range(iters):
        for pi in plain_in:
            big.place_arrays(*pi)
    dt_plain = (time.time() - t0) / iters
    t0 = time.time()
    for _ in range(iters):
        for gi in grouped:
            big.place_arrays_grouped(*gi)
    dt_grp = (time.time() - t0) / iters
    _aux(label, B=B, N=N, K_full=K, K_res=k_res, groups=G,
         K_grp=k_grp, min_group=min_group,
         plain_samples_per_sec=round(B / dt_plain, 1),
         grouped_samples_per_sec=round(B / dt_grp, 1),
         speedup=round(dt_plain / dt_grp, 2),
         group_host_s=round(group_host_s, 2),
         note="re-placement of the MAT's own leaves (EPP bulk workload); "
              "grouped = shared-ancestry decomposition, bit-identical "
              "(asserted in-run)")


def bench_reference_fixture():
    """Placement throughput on the reference's own smoke fixture: the
    4k-leaf SARS-CoV-2 tree (global_phylo.nh) + 423-site VCF, samples
    replicated to a full batch (test/ fixtures, SURVEY.md §4)."""
    ref_dir = FIXTURES
    from usher_jax.io.newick import parse_newick
    from usher_jax.io.vcf import read_vcf
    from usher_jax.ops.sankoff import assign_states_from_vcf
    from usher_jax.placement.driver import PlacementEngine
    t0 = time.time()
    T = parse_newick(os.path.join(ref_dir, "global_phylo.nh"))
    missing, vcf = read_vcf(T, os.path.join(ref_dir, "global_samples.vcf"),
                            create_new_mat=True)
    assign_states_from_vcf(T, vcf)
    _progress(f"fixture: built MAT from newick+VCF in {time.time()-t0:.1f}s "
              f"({len(T.breadth_first_expansion())} nodes)")
    new, _ = read_vcf(T, os.path.join(ref_dir, "new_samples.vcf"),
                      create_new_mat=False)
    batch = []
    while len(batch) < 64:
        batch.extend(s.mutations for s in new)
    batch = batch[:64]
    for muts in batch:
        muts.sort(key=lambda m: m.position)
    eng = PlacementEngine(T, extra_mutations=[m for s in batch for m in s])
    t0 = time.time()
    eng.score_samples(batch)
    compile_s = time.time() - t0
    iters = 3 if compile_s < 120 else 1
    t0 = time.time()
    for _ in range(iters):
        res = eng.score_samples(batch)
    dt = (time.time() - t0) / iters
    n = len(T.breadth_first_expansion())
    assert all(r.best_score < 20 for r in res)  # sanity, not parity:
    # byte-level fixture parity is enforced by ci.sh's smoke goldens
    _aux("reference_fixture", nodes=n, sites=423, B=len(batch),
         ms_per_batch=round(dt * 1e3, 1),
         samples_per_sec=round(len(batch) / dt, 1))


def write_direct_inputs(rng, outdir, N, P, B, K):
    """Write a seeded N-node MAT over P sites as outdir/big.pb (random
    recursive topology, 2 branch mutations per node) and a VCF of B samples
    with K random entries each as outdir/s.vcf.  Returns (pb, vcf)."""
    from usher_jax.io import pb_arrays as pa

    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    n_mut = 2
    M = n_mut * (N - 1)
    mut_ptr = np.zeros(N + 1, dtype=np.int64)
    mut_ptr[2:] = n_mut * np.arange(1, N, dtype=np.int64)
    mut_col = rng.integers(0, P, size=M).astype(np.int32)
    mut_mut = NIBBLES[rng.integers(0, 4, size=M)]
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    mut_par = ref[mut_col].copy()
    same = mut_par == mut_mut
    mut_mut[same] = NIBBLES[(np.searchsorted(NIBBLES, mut_mut[same]) + 1)
                            % 4]
    is_leaf = np.ones(N, bool)
    is_leaf[parent[1:]] = False
    is_leaf[0] = False
    names = "\0".join(
        (f"L{i}" if is_leaf[i] else f"I{i}") for i in range(N)) + "\0"
    names_b = names.encode()
    name_off = np.zeros(N + 1, np.int64)
    name_off[1:] = np.nonzero(np.frombuffer(names_b, np.uint8) == 0)[0] + 1
    ma = pa.MatArrays(
        parent=parent, names_blob=names_b, name_off=name_off,
        blen=np.full(N, -1.0), mut_ptr=mut_ptr, mut_col=mut_col,
        mut_par=mut_par, mut_mut=mut_mut,
        positions=np.arange(100, 100 + P, dtype=np.int64), ref=ref,
        chrom="chr")
    os.makedirs(outdir, exist_ok=True)
    pb = os.path.join(outdir, "big.pb")
    pa.save_arrays_to_pb(ma, pb)

    # a VCF of B samples x K mutations (rows only for variant positions);
    # fully vectorized generation — the naive per-cell loop is minutes at
    # B=4096
    bases = {1: "A", 2: "C", 4: "G", 8: "T"}
    spos = rng.integers(0, P, size=(B, K))
    salt = NIBBLES[rng.integers(0, 4, size=(B, K))]
    fp = spos.ravel()
    fv = salt.ravel().astype(np.int64)
    fb = np.repeat(np.arange(B), K)
    keep = fv != ref[fp]
    fp, fv, fb = fp[keep], fv[keep], fb[keep]
    cols, col_inv = np.unique(fp, return_inverse=True)
    # per-column alt index: rank of the allele among the column's distinct
    # non-ref alleles (sorted), 1-based
    order = np.lexsort((fv, col_inv))
    ci, vi = col_inv[order], fv[order]
    newv = np.r_[True, (ci[1:] != ci[:-1]) | (vi[1:] != vi[:-1])]
    newc = np.r_[True, ci[1:] != ci[:-1]]
    rankv = np.cumsum(newv)
    alt_idx = np.zeros(len(fp), np.int64)
    alt_idx[order] = rankv - np.maximum.accumulate(
        np.where(newc, rankv, 0)) + 1
    R = len(cols)
    G = np.zeros((R, B), np.uint8)
    G[col_inv, fb] = alt_idx.astype(np.uint8)
    # alts string per column (distinct alleles only, sorted)
    alt_strs = [""] * R
    for r_i, v_i, is_newc in zip(ci[newv], vi[newv], newc[newv]):
        alt_strs[r_i] = (bases[int(v_i)] if is_newc
                         else alt_strs[r_i] + "," + bases[int(v_i)])
    cells = np.empty((R, 2 * B), np.uint8)
    cells[:, 0::2] = G + ord("0")
    cells[:, 1::2] = ord("\t")
    vcf = os.path.join(outdir, "s.vcf")
    with open(vcf, "wb") as f:
        f.write(("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                 "FORMAT\t" + "\t".join(f"S{b}" for b in range(B))
                 + "\n").encode())
        for r_i in range(R):
            pre = (f"chr\t{100 + int(cols[r_i])}\t.\t"
                   f"{bases[int(ref[cols[r_i]])]}\t{alt_strs[r_i]}"
                   f"\t.\t.\t.\tGT\t")
            f.write(pre.encode() + cells[r_i, :-1].tobytes() + b"\n")
    return pb, vcf


def bench_direct_e2e(rng):
    """END-TO-END no-Tree serving (usher --pb-direct): generate a 200k-node
    parsimony.pb + a 4096-sample VCF, then load -> place -> write outputs
    with zero host Node objects (io/pb_arrays.py + placement/direct.py).
    Placement is exact-sequential (classic usher semantics) via the
    batched snapshot-correction engine (placement/direct._BatchState)."""
    import tempfile
    from usher_jax.placement.direct import DirectOptions, run_usher_direct

    B = 4096
    tmpd = tempfile.mkdtemp(prefix="usher_direct_")
    t0 = time.time()
    pb, vcf = write_direct_inputs(rng, tmpd, 200_000, 30_000, B, 24)
    _progress(f"direct: wrote 200k-node pb + VCF in {time.time()-t0:.1f}s")
    t0 = time.time()
    run_usher_direct(pb, vcf, DirectOptions(outdir=os.path.join(tmpd, "o"),
                                            batch_size=512))
    total = time.time() - t0
    _aux("direct_e2e_200k", total_s=round(total, 1), B=B,
         samples_per_sec=round(B / total, 1),
         note="pb load + exact-sequential place + outputs, "
              "zero host Node objects")


def bench_pandemic_optimize(rng):
    """One streamed-SPR source-scan round at pandemic scale: a 1M-node x
    30k-site CSR MAT, 2048 source nodes scored against every in-radius
    destination via the device-expansion SPR engine (the exact per-chunk
    call of optimize/spr_big.BigMoveFinder.find_moves).  Reported in the
    reference's own telemetry unit, source nodes searched/min
    (optimize_tree.cpp:36,209 — its distributor initializes at 100
    nodes/min/thread)."""
    from usher_jax.ops import interval as iv
    import jax.numpy as jnp
    from usher_jax.optimize.spr_big import _fetch3

    N, P = 1_000_000, 30_000
    t0 = time.time()
    # DEDICATED rng: the source set must be identical run-to-run even when
    # earlier phases are skipped
    rng = np.random.default_rng(1234)
    big = synth_bigmat(rng, N, P)
    _progress(f"pandemic-optimize: built {N}-node CSR MAT "
              f"in {time.time()-t0:.1f}s")
    n_srcs, chunk, radius = 2048, 512, 8
    sources = rng.integers(1, N, size=n_srcs)
    chunk_times: list = []
    meta = big._dfs_meta(spr=True)
    n_pad = big.n_pad
    dfs_of, dfs_end_of = big.dfs_of, big.dfs_end_of
    margs = (meta["num_mut"], meta["is_root"], meta["active"],
             meta["num_leaves"], meta["bfs_rank"], meta["level"])
    csc = big._csc_dev()
    mc = 32
    mx = int(np.diff(big.csc_ptr).max())
    while mc < mx:
        mc = mc * 3 // 2
    t0 = time.time()
    compile_s = None
    for c0 in range(0, n_srcs, chunk):
        idxs = sources[c0:c0 + chunk]
        B = len(idxs)
        b_pad = chunk
        # per-source deviations: the source's own branch mutations (the
        # synthetic stand-in for its subtree Fitch-mask deviations)
        K = 32
        pos = np.full((b_pad, K), P, np.int32)
        gval = np.zeros((b_pad, K), np.uint8)
        src_level = np.zeros(b_pad, np.int32)
        src_lo = np.full(b_pad, n_pad, np.int32)
        src_hi = np.full(b_pad, n_pad, np.int32)
        src_parent_row = np.full(b_pad, -1, np.int32)
        anc_rows = []
        for b, si in enumerate(idxs.tolist()):
            lo, hi = int(big.mut_ptr[si]), int(big.mut_ptr[si + 1])
            k = min(K, hi - lo)
            pos[b, :k] = big.mut_col[lo:lo + k]
            gval[b, :k] = big.mut_mut[lo:lo + k]
            src_level[b] = big.level[si]
            src_lo[b] = dfs_of[si]
            src_hi[b] = dfs_end_of[si]
            src_parent_row[b] = dfs_of[int(big.parent[si])]
            p = int(big.parent[si])
            while True:
                anc_rows.append((dfs_of[p], dfs_end_of[p], b))
                if p == int(big.parent[p]):
                    break
                p = int(big.parent[p])
        ar = np.asarray(anc_rows, dtype=np.int32).reshape(-1, 3)
        cnt_idx = np.concatenate([ar[:, 0], ar[:, 1]])
        cnt_b = np.concatenate([ar[:, 2], ar[:, 2]])
        cnt_val = np.concatenate([np.ones(len(ar), np.int32),
                                  -np.ones(len(ar), np.int32)])
        cntp = iv.pad_events(cnt_idx, cnt_b, cnt_val, n_pad, bucket=65536)
        cost, row, hu = _fetch3(iv.interval_spr_dev(
            *csc, jnp.asarray(pos), jnp.asarray(gval),
            *(jnp.asarray(a) for a in cntp),
            meta["base"], meta["nc_base"], *margs,
            jnp.asarray(src_level), jnp.asarray(src_lo),
            jnp.asarray(src_hi), jnp.asarray(src_parent_row),
            jnp.int32(radius), n_pad, b_pad, mc))
        if compile_s is None:
            compile_s = time.time() - t0
            _progress(f"pandemic-optimize: first chunk (compile incl.) "
                      f"{compile_s:.1f}s")
        else:
            chunk_times.append(time.time() - t0)
        t0 = time.time()
    scanned = n_srcs - chunk  # first chunk excluded (compile)
    # MEDIAN chunk time: one slow chunk cannot swing the reported rate
    med = float(np.median(chunk_times))
    dt = med * len(chunk_times)
    _aux("pandemic_optimize", N=N, P=P, radius=radius,
         sources_scanned=scanned, seconds=round(sum(chunk_times), 2),
         ms_per_source=round(med / chunk * 1e3, 3),
         nodes_searched_per_min=round(scanned * 60 / dt),
         chunk_times_s=[round(t, 2) for t in chunk_times],
         note="median-chunk rate, fixed seeded source set; streamed SPR "
              "source scan, device-expansion engine; reference telemetry "
              "unit optimize_tree.cpp:36")


def bench_mesh_overhead(N=200_000, label="mesh8_overhead_ratio",
                        iters=5, timeout=900):
    """Sharded-vs-single wall ratio on the 8-device VIRTUAL CPU mesh, in a
    CPU-only subprocess (virtual devices share the same host cores, so this
    measures the COMPOSITION OVERHEAD of the shard_map path, not real
    scaling — ~1.0 means sharding is free)."""
    code = r"""
import os, time, json, sys
import numpy as np
import jax
sys.path.insert(0, %r)
from jax.sharding import Mesh
sys.argv = ['bench-mesh']
from bench import synth_bigmat, NIBBLES
rng = np.random.default_rng(7)
N = int(os.environ.get('USHER_BENCH_MESH_N', '200000'))
P, B, K = 30_000, 512, 24
big1 = synth_bigmat(rng, N, P)
bigM = synth_bigmat(np.random.default_rng(7), N, P)
bigM.mesh = Mesh(np.array(jax.devices()[:8]), ('batch',))
pos = rng.integers(0, P, size=(B, K)).astype(np.int32)
gval = NIBBLES[rng.integers(0, 4, size=(B, K))]
kmiss = np.zeros((B, K), dtype=bool)
out = {}
iters = int(os.environ.get('USHER_BENCH_MESH_ITERS', '3'))
for tag, big in (('mesh1', big1), ('mesh8', bigM)):
    big.place_arrays(pos, gval, kmiss)
    ts = []
    for _ in range(iters):
        t0 = time.time()
        r = big.place_arrays(pos, gval, kmiss)
        ts.append(time.time() - t0)
    out[tag] = float(np.median(ts))  # median: host-contention robust
    out[tag + '_best0'] = int(r[0][0])
assert out['mesh1_best0'] == out['mesh8_best0']
print(json.dumps(out))
""" % (REPO,)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["USHER_BENCH_MESH_N"] = str(N)
    env["USHER_BENCH_MESH_ITERS"] = str(iters)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    try:
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True,
                             timeout=timeout)
        if out.returncode != 0:
            _progress(f"mesh-overhead phase failed: {out.stderr[-400:]}")
            return
        d = json.loads(out.stdout.strip().splitlines()[-1])
        ratio = d["mesh8"] / d["mesh1"]
        _aux(label, device=VIRTUAL_CPU8, N=N,
             ratio=round(ratio, 3),
             bound_ok=bool(ratio <= 1.15),
             mesh1_ms=round(d["mesh1"] * 1e3, 1),
             mesh8_ms=round(d["mesh8"] * 1e3, 1),
             note="median-of-iters; virtual CPU mesh: composition "
                  "overhead (bound ratio<=1.15), not scaling")
    except subprocess.TimeoutExpired:
        _progress("mesh-overhead phase timed out; skipping")


def bench_real_batch_dedup():
    """Duplication structure of a REAL sample batch (the reference
    fixture's 422 genotype columns placed as queries): how much of the
    difference-array event stream is shared across the batch, and how
    many samples are exact variant-set duplicates (scored once by
    place_arrays' dedup fan-out)."""
    ref_dir = FIXTURES
    from usher_jax.io.newick import parse_newick
    from usher_jax.io.vcf import read_vcf, read_vcf_sites
    from usher_jax.ops.sankoff import assign_states_from_vcf
    from usher_jax.core.flat import collect_positions
    from usher_jax.core.bigmat import BigMAT
    T = parse_newick(os.path.join(ref_dir, "global_phylo.nh"))
    _m, vcf = read_vcf(T, os.path.join(ref_dir, "global_samples.vcf"),
                       create_new_mat=True)
    assign_states_from_vcf(T, vcf)
    positions, refarr, _c = collect_positions(T)
    big = BigMAT.from_tree(T, positions, refarr)
    v = read_vcf_sites(os.path.join(ref_dir, "global_samples.vcf"))
    posidx = {int(p): i for i, p in enumerate(positions)}
    per = {j: [] for j in range(len(v.sample_ids))}
    for site in v.sites:
        for j, nuc in site.variants:
            c = posidx.get(site.position)
            if c is not None:
                per[j].append((c, nuc))
    entries = np.array([(j, c, g) for j, ms in per.items()
                        for (c, g) in ms], np.int64)
    occ = np.diff(big.csc_ptr)
    tot = int(occ[entries[:, 1]].sum())
    uniq_pairs = np.unique(entries[:, 1:3], axis=0)
    uq = int(occ[uniq_pairs[:, 0]].sum())
    sets = {}
    for j, ms in per.items():
        sets.setdefault(tuple(sorted(ms)), []).append(j)
    B = len(per)
    _aux("real_batch_dedup", B=B, entries=int(len(entries)),
         scatter_events_total=tot, scatter_events_unique=uq,
         entry_event_duplication_pct=round(100 * (1 - uq / tot), 1),
         exact_duplicate_samples_pct=round(100 * (1 - len(sets) / B), 1),
         note="reference fixture's real genotype columns as a placement "
              "batch; exact-duplicate samples are scored once "
              "(place_arrays dedup fan-out)")


def bench_two_process_ratio(timeout=900):
    """2-process vs 1-process wall-clock of the usher-sampled smoke run
    (tests/distributed_worker.py sampled phase): REAL jax.distributed
    across two CPU processes vs one process with the same 8 virtual
    devices.  Virtual devices share host cores, so ~1.0 means the
    cross-process collectives + leader discipline are structurally free;
    real N-host scaling needs several hosts."""
    import socket
    worker = os.path.join(REPO, "tests", "distributed_worker.py")
    base_env = dict(os.environ)
    base_env["JAX_PLATFORMS"] = "cpu"

    def run_single(tmp):
        env = dict(base_env)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env.pop("USHER_JAX_COORDINATOR", None)
        out = subprocess.run([sys.executable, worker, tmp], env=env,
                             capture_output=True, text=True,
                             timeout=timeout)
        return out.returncode, out.stderr

    def run_multi(tmp):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for pid in range(2):
            env = dict(base_env)
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
            env["USHER_JAX_COORDINATOR"] = f"127.0.0.1:{port}"
            env["USHER_JAX_NUM_PROCESSES"] = "2"
            env["USHER_JAX_PROCESS_ID"] = str(pid)
            procs.append(subprocess.Popen(
                [sys.executable, worker, tmp], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        errs = []
        rc = 0
        for p in procs:
            _sout, serr = p.communicate(timeout=timeout)
            rc |= p.returncode
            errs.append(serr)
        return rc, "\n".join(errs)

    import tempfile
    try:
        t1 = os.path.join(tempfile.mkdtemp(prefix="b2p_"), "one.json")
        rc, err = run_single(t1)
        if rc != 0:
            _progress(f"two-process phase (single) failed: {err[-300:]}")
            return
        t2 = os.path.join(tempfile.mkdtemp(prefix="b2p_"), "two.json")
        rc, err = run_multi(t2)
        if rc != 0:
            _progress(f"two-process phase (multi) failed: {err[-300:]}")
            return
        one = json.load(open(t1))
        two = json.load(open(t2))
        assert one["sampled_stats"] == two["sampled_stats"]
        assert one["sampled_tree"] == two["sampled_tree"]
        ratio = two["sampled_wall_s"] / one["sampled_wall_s"]
        _aux("two_process_ratio", device=VIRTUAL_CPU8,
             one_proc_s=one["sampled_wall_s"],
             two_proc_s=two["sampled_wall_s"],
             ratio=round(ratio, 3), outputs_identical=True,
             note="usher-sampled smoke fixture, interleaved optimization, "
                  "real 2-process jax.distributed vs single process on "
                  "the same 8 virtual CPU devices")
    except (subprocess.TimeoutExpired, Exception) as e:  # noqa: BLE001
        _progress(f"two-process phase skipped: {e}")


def dense_chunk(node_args, g, E, miss, budget_bytes=None):
    """Largest batch chunk (halving from the whole batch) whose compiled
    ops.placement.placement_step keeps its temporaries within budget_bytes
    (by default half the device's memory limit): XLA may materialise a
    [B, N, P] intermediate."""
    import jax
    from usher_jax.ops import placement as dev
    if budget_bytes is None:
        stats = jax.devices()[0].memory_stats() or {}
        budget_bytes = stats.get("bytes_limit", 16 << 30) // 2
    chunk = g.shape[0]
    while chunk > 1:
        spec = [jax.ShapeDtypeStruct((chunk,) + x.shape[1:], x.dtype)
                for x in (g, E, miss)]
        mem = dev.placement_step.lower(*node_args, *spec).compile() \
            .memory_analysis()
        if mem is None or mem.temp_size_in_bytes <= budget_bytes:
            break
        chunk //= 2
    return chunk


def dense_step_chunked(node_args, g, E, miss, chunk):
    """ops.placement.placement_step over the batch in chunks of `chunk`
    samples (the tail padded to the compiled shape).  Returns
    (best_score, best_slot, num_best) numpy arrays."""
    from usher_jax.ops import placement as dev
    B = g.shape[0]
    outs = []
    for c0 in range(0, B, chunk):
        sl = [x[c0:c0 + chunk] for x in (g, E, miss)]
        if sl[0].shape[0] < chunk:
            pad = chunk - sl[0].shape[0]
            sl = [np.concatenate([x, np.repeat(x[-1:], pad, 0)]) for x in sl]
        outs.append(dev.placement_step(*node_args, *sl))
    return tuple(np.concatenate([np.asarray(o[i]) for o in outs])[:B]
                 for i in range(3))


def main():
    import jax
    import jax.numpy as jnp
    from usher_jax.ops import placement_sparse as pp
    from usher_jax.utils.instrument import enable_compile_cache

    dev0 = device_info()
    if dev0["platform"] != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        print(f"bench: no GPU found (JAX sees {dev0}); set JAX_PLATFORMS=cpu "
              f"to measure the CPU backend on purpose", file=sys.stderr)
        sys.exit(2)
    on_cpu = dev0["platform"] == "cpu"
    if not on_cpu:
        _progress("card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    enable_compile_cache()

    rng = np.random.default_rng(42)
    st, parent, ref, active, is_leaf, is_root, num_leaves, bfs_rank = \
        synth_flat_mat(rng)
    g, E, miss = synth_samples(rng, ref)
    _progress(f"synthetic MAT built ({N_NODES} nodes, {P_SITES} sites, "
              f"B={BATCH}) on {dev0}")

    # baseline FIRST (pure CPU): single-core numpy on a subsample,
    # extrapolated to 64 threads
    Bs = 4
    stp_host = st[parent]
    stp_host[0] = st[0]
    t0 = time.time()
    numpy_score_batch(st, stp_host, ref, g[:Bs], E[:Bs], miss[:Bs])
    cpu_dt = time.time() - t0
    cpu_rate_64t = (Bs / cpu_dt) * 64
    _progress(f"numpy 1-core: {cpu_dt/Bs*1e3:.1f} ms/sample "
              f"-> x64 = {cpu_rate_64t:.0f} samples/s")

    pos, gval, kmiss = pp.sparsify_dense(g, E, miss)
    node_args = tuple(jnp.asarray(x) for x in (
        st, parent, np.int32(0), ref, active, is_leaf, is_root, num_leaves,
        bfs_rank))
    sargs = node_args + tuple(jnp.asarray(x) for x in (pos, gval, kmiss))

    def _run_sparse():
        return pp.placement_step_sparse(*sargs, pos.shape[1])

    t0 = time.time()
    sbest = jax.block_until_ready(_run_sparse())
    sparse_compile_s = time.time() - t0
    _progress(f"placement_step_sparse compiled ({sparse_compile_s:.1f}s)")

    iters = 5
    t0 = time.time()
    for _ in range(iters):
        sbest = jax.block_until_ready(_run_sparse())
    sync_dt = (time.time() - t0) / iters
    _progress(f"sparse sync: {sync_dt*1e3:.2f} ms/batch")

    # PIPELINED throughput: enqueue all batches, wait once at the end —
    # the serving discipline (batch i+1's dispatch overlaps batch i's
    # execution)
    t0 = time.time()
    outs = [_run_sparse() for _ in range(iters)]
    jax.block_until_ready(outs)
    sdt = (time.time() - t0) / iters
    sparse_rate = BATCH / sdt
    _progress(f"sparse pipelined: {sdt*1e3:.2f} ms/batch -> "
              f"{sparse_rate:.0f} samples/s")
    _aux("headline_sync_latency", ms_per_batch=round(sync_dt * 1e3, 3),
         pipelined_ms=round(sdt * 1e3, 3),
         note="sync = one wait per batch; headline uses the pipelined "
              "(serving-discipline) rate")

    # headline metric immediately — everything below is supplementary and
    # must not cost the metric if the run is time-capped
    headline = {
        "metric": "samples_placed_per_sec",
        "value": round(sparse_rate, 2),
        "unit": "samples/s (B=%d, %d-node MAT, %d sites, 1 device, "
                "pipelined)" % (BATCH, N_NODES, P_SITES),
        "vs_baseline": round(sparse_rate / cpu_rate_64t, 3),
        "device": dev0,
    }
    print(json.dumps(headline), flush=True)
    _aux("node_score_evals_per_sec",
         value=round(N_NODES * BATCH / sdt),
         workload="headline")

    try:
        if on_cpu:
            # XLA's CPU backend materialises the dense step's [B, N, P]
            # intermediate, and the genome-width phases take hours there
            _progress("CPU run: only the headline and the reference fixture")
            bench_reference_fixture()
            return
        t0 = time.time()
        chunk = dense_chunk(node_args, g, E, miss)
        best = dense_step_chunked(node_args, g, E, miss, chunk)
        _progress(f"placement_step (dense) compiled + run, batch chunk "
                  f"{chunk} ({time.time()-t0:.1f}s)")
        for a, b in zip(best, sbest):
            np.testing.assert_array_equal(a, np.asarray(b))
        _progress("sparse == dense on the bench workload")
        t0 = time.time()
        for _ in range(iters):
            dense_step_chunked(node_args, g, E, miss, chunk)
        dt = (time.time() - t0) / iters
        _aux("dense_cross_check", ms_per_batch=round(dt * 1e3, 3),
             batch_chunk=chunk, sparse_speedup=round(dt / sdt, 2))

        if time.time() - _T0 < 900:
            # genome-width realistic shape (the scale the reference's
            # fixtures actually have: ~30k segregating sites)
            bench_interval(rng, 100_000, 30_000, 1024, 24,
                           "realistic_100k_x_30k")
        if time.time() - _T0 < 1200:
            # pandemic scale: 1M-node CSR MAT (>2M-leaf class,
            # reference README.md:23)
            bench_interval(rng, 1_000_000, 30_000, 1024, 24,
                           "pandemic_1m_x_30k")
        if time.time() - _T0 < 1350:
            bench_replace_grouped(rng, 1_000_000, 30_000, 1024)
        if time.time() - _T0 < 1500:
            bench_reference_fixture()
        if time.time() - _T0 < 1800:
            bench_direct_e2e(rng)
        if time.time() - _T0 < 2100:
            bench_pandemic_optimize(rng)
        if os.environ.get("USHER_BENCH_MESH", "1") != "0" \
                and time.time() - _T0 < 1800:
            bench_mesh_overhead()
            if time.time() - _T0 < 2400:
                # the multi-device structure check at the shape where
                # sharding matters
                bench_mesh_overhead(N=1_000_000,
                                    label="mesh8_overhead_ratio_1m",
                                    iters=3, timeout=1800)
        bench_real_batch_dedup()
        if time.time() - _T0 < 2700:
            bench_two_process_ratio()
    finally:
        # re-emit the headline last, so a supplementary phase's labeled
        # JSON (stderr) can never displace it as the last JSON-looking line
        print(json.dumps(headline), flush=True)


if __name__ == "__main__":
    main()

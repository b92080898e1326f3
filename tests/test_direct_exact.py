"""Exact-sequential equivalence of the batched direct driver.

The --pb-direct driver resolves each sample against the tree WITH all
previous samples applied (reference classic-usher semantics,
usher_common.cpp:310).  The batched fast path (_BatchState) must be
byte-equivalent to the literal per-sample loop (USHER_JAX_DIRECT_SEQ=1
forces a full host re-score for every post-apply sample).  Workloads are
adversarial: near-duplicate samples that pile onto the same nodes, exact
mutation-set duplicates (ties + splits of fresh nodes), ambiguous and
missing entries.
"""

import os

import numpy as np
import pytest

from usher_jax.core.tree import Mutation, MissingSample
from usher_jax.io import pb_arrays as pa
from usher_jax.placement.direct import DirectOptions, DirectPlacer

NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)


def consistent_mat(rng, N, P, n_mut=2):
    """Chain-consistent random MatArrays (mut_par == path state above)."""
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    state = np.tile(ref, (N, 1))
    rows_col, rows_par, rows_mut, ptr = [], [], [], [0]
    for i in range(N):
        if i == 0:
            ptr.append(0)
            continue
        state[i] = state[parent[i]]
        cols = rng.choice(P, size=n_mut, replace=False)
        for c in sorted(cols.tolist()):
            par = int(state[i, c])
            alts = [int(x) for x in NIBBLES if int(x) != par]
            mut = alts[int(rng.integers(0, 3))]
            state[i, c] = mut
            rows_col.append(c)
            rows_par.append(par)
            rows_mut.append(mut)
        ptr.append(len(rows_col))
    is_leaf = np.ones(N, bool)
    is_leaf[parent[1:]] = False
    is_leaf[0] = False
    names = "\0".join((f"L{i}" if is_leaf[i] else f"I{i}")
                      for i in range(N)) + "\0"
    names_b = names.encode()
    name_off = np.zeros(N + 1, np.int64)
    name_off[1:] = np.nonzero(np.frombuffer(names_b, np.uint8) == 0)[0] + 1
    ma = pa.MatArrays(
        parent=parent, names_blob=names_b, name_off=name_off,
        blen=np.full(N, -1.0),
        mut_ptr=np.array(ptr, np.int64),
        mut_col=np.array(rows_col, np.int32),
        mut_par=np.array(rows_par, np.uint8),
        mut_mut=np.array(rows_mut, np.uint8),
        positions=np.arange(100, 100 + P, dtype=np.int64),
        ref=ref, chrom="chr")
    return ma, state, is_leaf


def adversarial_samples(rng, ma, state, is_leaf, n_samples):
    """Sample list engineered for batch-interaction: leaf-copies with few
    extra mutations (pile-ups, splits, retries), exact duplicates (ties),
    ambiguity + missing entries."""
    N, P = state.shape
    positions = ma.positions
    ref = ma.ref
    leaves = np.nonzero(is_leaf)[0]
    # the pb roundtrip keeps only positions that appear in mutations; the
    # no-VCF test path has no site-union step, so draw only from those
    used = np.unique(ma.mut_col)
    samples = []
    for si in range(n_samples):
        kind = int(rng.integers(0, 4))
        muts = {}
        if kind in (0, 1):
            # near-duplicate of a leaf: its deviations from ref + extras
            leaf = int(leaves[rng.integers(0, len(leaves))])
            dev = np.nonzero(state[leaf] != ref)[0]
            for c in dev.tolist():
                muts[c] = int(state[leaf, c])
            for _ in range(int(rng.integers(0, 3))):
                c = int(used[rng.integers(0, len(used))])
                muts[c] = int(NIBBLES[rng.integers(0, 4)])
        elif kind == 2 and samples:
            # exact mutation-set duplicate of an earlier sample
            prev = samples[int(rng.integers(0, len(samples)))]
            for m in prev.mutations:
                muts[int(np.searchsorted(positions, m.position))] = \
                    int(m.mut_nuc)
        else:
            for _ in range(int(rng.integers(1, 8))):
                c = int(used[rng.integers(0, len(used))])
                muts[c] = int(NIBBLES[rng.integers(0, 4)])
        # sprinkle ambiguity codes and missing entries
        for c in list(muts):
            r = rng.random()
            if r < 0.08:
                muts[c] = muts[c] | int(NIBBLES[rng.integers(0, 4)])
            elif r < 0.14:
                muts[c] = 0xF
        s = MissingSample(f"S{si}")
        for c in sorted(muts):
            v = muts[c]
            if v == int(ref[c]):
                continue
            m = Mutation("chr", int(positions[c]), int(ref[c]),
                         int(ref[c]), v)
            if v == 0xF:
                m.is_missing = True
            s.mutations.append(m)
        samples.append(s)
    return samples


def run_mode(tmp_path, pb, samples, outname, seq: bool, batch_size: int):
    outdir = tmp_path / outname
    old = os.environ.pop("USHER_JAX_DIRECT_SEQ", None)
    try:
        if seq:
            os.environ["USHER_JAX_DIRECT_SEQ"] = "1"
        placer = DirectPlacer(str(pb))
        placer.missing = [_copy_sample(s) for s in samples]
        placer.place_all(DirectOptions(outdir=str(outdir),
                                       batch_size=batch_size))
    finally:
        if old is not None:
            os.environ["USHER_JAX_DIRECT_SEQ"] = old
        else:
            os.environ.pop("USHER_JAX_DIRECT_SEQ", None)
    return {f: (outdir / f).read_text()
            for f in ("placement_stats.tsv", "final-tree.nh",
                      "mutation-paths.txt")}


def _copy_sample(s):
    c = MissingSample(s.name)
    c.mutations = [m.copy() for m in s.mutations]
    c.num_ambiguous = s.num_ambiguous
    return c


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_batched_equals_sequential(tmp_path, seed):
    rng = np.random.default_rng(seed)
    ma, state, is_leaf = consistent_mat(rng, N=300, P=150)
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=48)
    a = run_mode(tmp_path, pb, samples, f"batched{seed}", seq=False,
                 batch_size=48)
    b = run_mode(tmp_path, pb, samples, f"seq{seed}", seq=True,
                 batch_size=48)
    for f in a:
        assert a[f] == b[f], f"{f} differs (seed {seed})"


def test_batched_equals_sequential_multi_batch(tmp_path):
    rng = np.random.default_rng(7)
    ma, state, is_leaf = consistent_mat(rng, N=400, P=200)
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=60)
    a = run_mode(tmp_path, pb, samples, "batched", seq=False, batch_size=16)
    b = run_mode(tmp_path, pb, samples, "seq", seq=True, batch_size=16)
    for f in a:
        assert a[f] == b[f]


def write_vcf_for(path, ma, samples) -> None:
    """Write a VCF carrying the samples' mutation sets (both drivers
    consume the same file)."""
    bases = {1: "A", 2: "C", 4: "G", 8: "T", 0xF: "N"}
    by_pos = {}
    for j, s in enumerate(samples):
        for m in s.mutations:
            by_pos.setdefault(m.position, {})[j] = int(m.mut_nuc)
    iupac = {3: "M", 5: "R", 9: "W", 6: "S", 10: "Y", 12: "K",
             7: "V", 11: "H", 13: "D", 14: "B"}
    bases.update({k: v for k, v in iupac.items()})
    pos_ref = {int(p): int(r)
               for p, r in zip(ma.positions.tolist(), ma.ref.tolist())}
    with open(path, "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(s.name for s in samples) + "\n")
        for p in sorted(by_pos):
            r = pos_ref[p]
            alts = sorted({v for v in by_pos[p].values() if v != r})
            if not alts:
                continue
            ai = {v: i + 1 for i, v in enumerate(alts)}
            row = [str(ai.get(by_pos[p].get(j), 0))
                   if j in by_pos[p] else "0"
                   for j in range(len(samples))]
            f.write(f"chr\t{p}\t.\t{bases[r]}\t"
                    + ",".join(bases[a] for a in alts)
                    + "\t.\t.\t.\tGT\t" + "\t".join(row) + "\n")


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
def test_direct_matches_tree_driver_randomized(tmp_path, seed):
    """--pb-direct must byte-match the Tree-backed --bigmat driver on
    randomized adversarial workloads, not just the smoke fixture: same
    pb, same VCF, byte-identical stats/newick/paths."""
    rng = np.random.default_rng(seed)
    ma, state, is_leaf = consistent_mat(rng, N=250, P=120)
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=40)
    vcf = tmp_path / "s.vcf"
    write_vcf_for(vcf, ma, samples)

    from usher_jax.cli.usher_cli import main as usher_main
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d1,
                       "--bigmat", "--mesh-devices", "0"]) == 0
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d2,
                       "--pb-direct", "--mesh-devices", "0",
                       "--batch-size", "16"]) == 0
    for fn in ("placement_stats.tsv", "final-tree.nh",
               "mutation-paths.txt"):
        x = open(os.path.join(d1, fn)).read()
        y = open(os.path.join(d2, fn)).read()
        assert x == y, (fn, seed)


@pytest.mark.parametrize("flags", [["-s"], ["-S"], ["-A"],
                                   ["-s", "-r"], ["-A", "-r"]])
def test_direct_sort_flags_match_tree_driver(tmp_path, flags):
    """--pb-direct with sort-before-placement 1/2/3 (+reverse) must
    byte-match the Tree --bigmat driver: the sorted placement ORDER feeds
    the surgery sequence, so stats/newick/paths all depend on it
    (usher_common.cpp:322-379)."""
    rng = np.random.default_rng(21)
    ma, state, is_leaf = consistent_mat(rng, N=250, P=120)
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=36)
    vcf = tmp_path / "s.vcf"
    write_vcf_for(vcf, ma, samples)

    from usher_jax.cli.usher_cli import main as usher_main
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d1,
                       "--bigmat", "--mesh-devices", "0"] + flags) == 0
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d2,
                       "--pb-direct", "--mesh-devices", "0",
                       "--batch-size", "16"] + flags) == 0
    for fn in ("placement_stats.tsv", "final-tree.nh",
               "mutation-paths.txt"):
        x = open(os.path.join(d1, fn)).read()
        y = open(os.path.join(d2, fn)).read()
        assert x == y, (fn, flags)


def test_direct_parsimony_scores_match_tree_driver(tmp_path):
    """--pb-direct -p (per-node branch parsimony scores, no tree
    modification) must byte-match the Tree --bigmat driver's
    parsimony-scores.tsv / current-tree.nh (usher_common.cpp:466-521)."""
    rng = np.random.default_rng(23)
    ma, state, is_leaf = consistent_mat(rng, N=180, P=100)
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=10)
    vcf = tmp_path / "s.vcf"
    write_vcf_for(vcf, ma, samples)

    from usher_jax.cli.usher_cli import main as usher_main
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d1,
                       "--bigmat", "--mesh-devices", "0", "-p"]) == 0
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d2,
                       "--pb-direct", "--mesh-devices", "0",
                       "--batch-size", "4", "-p"]) == 0
    for fn in ("parsimony-scores.tsv", "current-tree.nh",
               "placement_stats.tsv"):
        x = open(os.path.join(d1, fn)).read()
        y = open(os.path.join(d2, fn)).read()
        assert x == y, fn


def annotate_mat(rng, ma, ncols=2, n_clades=5):
    """Attach random clade annotations (ncols columns) to ~20% of
    internal nodes, returning a new MatArrays."""
    n = ma.n
    is_internal = np.zeros(n, bool)
    is_internal[ma.parent[1:]] = True
    is_internal[0] = True
    parts = []
    counts = np.zeros(n, np.int32)
    for i in range(n):
        row = []
        for a in range(ncols):
            if is_internal[i] and rng.random() < 0.2:
                row.append(f"clade_{a}_{int(rng.integers(0, n_clades))}")
            else:
                row.append("")
        parts.extend(row)
        counts[i] = ncols
    ma.ann_counts = counts
    ma.ann_blob = ("\0".join(parts) + "\0").encode()
    return ma


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_direct_clades_match_tree_driver(tmp_path, seed):
    """--pb-direct clades.txt (basic and -D detailed histogram) must
    byte-match the Tree --bigmat driver on annotated randomized
    workloads (usher_common.cpp:600-619, 941-989)."""
    rng = np.random.default_rng(seed)
    ma, state, is_leaf = consistent_mat(rng, N=250, P=120)
    annotate_mat(rng, ma)
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=36)
    vcf = tmp_path / "s.vcf"
    write_vcf_for(vcf, ma, samples)

    from usher_jax.cli.usher_cli import main as usher_main
    for extra in ([], ["-D"]):
        d1 = str(tmp_path / ("t" + "".join(extra)))
        d2 = str(tmp_path / ("a" + "".join(extra)))
        assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d1,
                           "--bigmat", "--mesh-devices", "0"]
                          + extra) == 0
        assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d2,
                           "--pb-direct", "--mesh-devices", "0",
                           "--batch-size", "12"] + extra) == 0
        for fn in ("clades.txt", "placement_stats.tsv", "final-tree.nh"):
            x = open(os.path.join(d1, fn)).read()
            y = open(os.path.join(d2, fn)).read()
            assert x == y, (fn, extra, seed)


@pytest.mark.parametrize("seed", [41, 42])
def test_direct_clades_batched_equals_sequential(tmp_path, seed):
    """-D clade histograms from the device snapshot + membership edits
    must equal the literal per-sample host loop byte-for-byte."""
    rng = np.random.default_rng(seed)
    ma, state, is_leaf = consistent_mat(rng, N=300, P=150)
    annotate_mat(rng, ma)
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=48)

    def run(outname, seq):
        outdir = tmp_path / outname
        old = os.environ.pop("USHER_JAX_DIRECT_SEQ", None)
        try:
            if seq:
                os.environ["USHER_JAX_DIRECT_SEQ"] = "1"
            placer = DirectPlacer(str(pb))
            placer.missing = [_copy_sample(s) for s in samples]
            placer.place_all(DirectOptions(outdir=str(outdir),
                                           batch_size=48,
                                           detailed_clades=True))
        finally:
            if old is not None:
                os.environ["USHER_JAX_DIRECT_SEQ"] = old
            else:
                os.environ.pop("USHER_JAX_DIRECT_SEQ", None)
        return {f: (outdir / f).read_text()
                for f in ("clades.txt", "placement_stats.tsv",
                          "final-tree.nh")}

    a = run(f"b{seed}", False)
    b = run(f"s{seed}", True)
    for f in a:
        assert a[f] == b[f], (f, seed)


@pytest.mark.parametrize("flags", [["-C"], ["-c"], ["-c", "-C"],
                                   ["-C", "-u"]])
def test_direct_collapse_matches_tree_driver(tmp_path, flags):
    """--pb-direct -c (input collapse+condense before placement) and -C
    (output collapse) must byte-match the Tree --bigmat driver
    (usher_common.cpp:275-297, 798-801), including the saved pb."""
    rng = np.random.default_rng(51)
    ma, state, is_leaf = consistent_mat(rng, N=220, P=110)
    # sprinkle zero-mutation branches so collapse has work to do
    keep = rng.random(len(ma.mut_col)) > 0.25
    # drop ~25% of mutations (keeps chains consistent only if we drop
    # whole-branch lists; instead zero out entire nodes' lists)
    zap = rng.random(ma.n) < 0.3
    new_ptr = [0]
    mc, mp, mm = [], [], []
    for i in range(ma.n):
        if not zap[i]:
            lo, hi = int(ma.mut_ptr[i]), int(ma.mut_ptr[i + 1])
            mc.extend(ma.mut_col[lo:hi])
            mp.extend(ma.mut_par[lo:hi])
            mm.extend(ma.mut_mut[lo:hi])
        new_ptr.append(len(mc))
    # zapping breaks chain consistency; rebuild par chain top-down
    ma.mut_ptr = np.array(new_ptr, np.int64)
    ma.mut_col = np.array(mc, np.int32)
    ma.mut_par = np.array(mp, np.uint8)
    ma.mut_mut = np.array(mm, np.uint8)
    st = np.tile(ma.ref, (ma.n, 1))
    for i in range(ma.n):
        if i:
            st[i] = st[ma.parent[i]]
        lo, hi = int(ma.mut_ptr[i]), int(ma.mut_ptr[i + 1])
        for k in range(lo, hi):
            c = int(ma.mut_col[k])
            ma.mut_par[k] = st[i, c]
            if int(ma.mut_mut[k]) == int(st[i, c]):
                ma.mut_mut[k] = [x for x in (1, 2, 4, 8)
                                 if x != int(st[i, c])][0]
            st[i, c] = ma.mut_mut[k]
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, st, is_leaf, n_samples=24)
    vcf = tmp_path / "s.vcf"
    write_vcf_for(vcf, ma, samples)

    from usher_jax.cli.usher_cli import main as usher_main
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d1,
                       "-o", os.path.join(d1, "out.pb"),
                       "--bigmat", "--mesh-devices", "0"] + flags) == 0
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d2,
                       "-o", os.path.join(d2, "out.pb"),
                       "--pb-direct", "--mesh-devices", "0",
                       "--batch-size", "8"] + flags) == 0
    files = ["placement_stats.tsv", "mutation-paths.txt"]
    files.append("uncondensed-final-tree.nh" if "-u" in flags
                 else "final-tree.nh")
    if "-c" in flags:
        files.append("condensed-tree.nh")
    for fn in files:
        x = open(os.path.join(d1, fn)).read()
        y = open(os.path.join(d2, fn)).read()
        assert x == y, (fn, flags)
    with open(os.path.join(d1, "out.pb"), "rb") as f1, \
            open(os.path.join(d2, "out.pb"), "rb") as f2:
        assert f1.read() == f2.read(), flags


@pytest.mark.parametrize("flags", [["-K", "20"], ["-k", "15"],
                                   ["-k", "10", "-C"]])
def test_direct_subtrees_match_tree_driver(tmp_path, flags):
    """--pb-direct -k/-K usher-style subtree outputs must byte-match the
    Tree --bigmat driver (same rng sequence and traversal orders;
    mutation_annotated_tree.cpp:1693-1990)."""
    rng = np.random.default_rng(61)
    ma, state, is_leaf = consistent_mat(rng, N=260, P=120)
    pb = tmp_path / "t.pb"
    pa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples=20)
    vcf = tmp_path / "s.vcf"
    write_vcf_for(vcf, ma, samples)

    from usher_jax.cli.usher_cli import main as usher_main
    d1, d2 = str(tmp_path / "t"), str(tmp_path / "a")
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d1,
                       "--bigmat", "--mesh-devices", "0"] + flags) == 0
    assert usher_main(["-i", str(pb), "-v", str(vcf), "-d", d2,
                       "--pb-direct", "--mesh-devices", "0",
                       "--batch-size", "8"] + flags) == 0
    names1 = sorted(os.listdir(d1))
    names2 = sorted(os.listdir(d2))
    assert names1 == names2, flags
    subtree_files = [n for n in names1
                     if n.startswith(("subtree", "single-subtree"))]
    assert subtree_files, flags
    for fn in names1:
        x = open(os.path.join(d1, fn)).read()
        y = open(os.path.join(d2, fn)).read()
        assert x == y, (fn, flags)

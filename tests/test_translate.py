"""matUtils summary --translate + taxodium export (reference translate.cpp)."""

import gzip
import os

import pytest

from usher_jax.core.nuc import A, C, G
from usher_jax.core.nuc import T as T_NT
from usher_jax.core.tree import Mutation, Tree
from usher_jax.io import proto_wire as pw
from usher_jax.matutils.translate import (build_codon_map, build_reference,
                                          save_taxodium_tree, translate_main)
from usher_jax.matutils.summary import write_node_stats, write_roho_table

# ATG GCT TGT TAA -> M A C *
REF_SEQ = "ATGGCTTGTTAA"


@pytest.fixture()
def gene_files(tmp_path):
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">ref\n" + REF_SEQ + "\n")
    gtf = tmp_path / "genes.gtf"
    gtf.write_text('ref\ttest\tCDS\t1\t12\t.\t+\t.\tgene_id "GENE1";\n')
    return str(fasta), str(gtf)


def _mk_tree():
    T = Tree()
    root = T.create_node("node_root")
    l1 = T.create_node("L1", parent=root)
    l1.mutations = [Mutation("ref", 5, C, C, A)]  # codon2 GCT->GAT: A2D
    l2 = T.create_node("L2", parent=root)
    l2.mutations = [Mutation("ref", 6, T_NT, T_NT, A)]  # codon2 GCT->GCA: A2A (syn)
    return T


def test_translate_tsv(tmp_path, gene_files):
    fasta, gtf = gene_files
    T = _mk_tree()
    out = str(tmp_path / "aa.tsv")
    translate_main(T, out, gtf, fasta)
    lines = open(out).read().splitlines()
    assert lines[0].startswith("node_id\taa_mutations\tnt_mutations")
    rows = {l.split("\t")[0]: l.split("\t") for l in lines[1:]}
    assert rows["L1"][1] == "GENE1:A2D"
    assert rows["L1"][2] == "C5A"
    assert rows["L1"][3] == "GCT>GAT"
    assert rows["L1"][4] == "1"
    # sibling branch must see the *undone* codon state (GCT, not GAT)
    assert rows["L2"][1] == "GENE1:A2A"
    assert rows["L2"][3] == "GCT>GCA"


def test_codon_map_minus_strand(tmp_path):
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">ref\n" + REF_SEQ + "\n")
    gtf = tmp_path / "genes.gtf"
    gtf.write_text('ref\ttest\tCDS\t1\t12\t.\t-\t.\tgene_id "NEG1";\n')
    reference = build_reference(str(fasta))
    cmap = build_codon_map(str(gtf), reference)
    # first '-'-strand codon starts at 0-based pos 11 walking down:
    # complement(A),complement(A),complement(T) = TTA = Leu
    c = cmap[11][0]
    assert c.nucleotides == "TTA"
    assert c.protein == "L"
    assert c.start_position == 11


def test_taxodium_export(tmp_path, gene_files):
    fasta, gtf = gene_files
    T = _mk_tree()
    meta = tmp_path / "meta.tsv"
    meta.write_text("strain\tdate\tcountry\nL1\t2020-03-01\tUSA\n"
                    "L2\t2020-04-01\tUK\n")
    out = str(tmp_path / "tree.taxodium.pb")
    save_taxodium_tree(T, out, [str(meta)], gtf, fasta, title="t",
                       description="d")
    buf = open(out, "rb").read()
    node_data = mutation_mapping = None
    mutation_mapping = []
    titles = {}
    for fn, wt, val in pw.iter_fields(buf):
        if fn == 1:
            node_data = val
        elif fn == 4:
            mutation_mapping.append(bytes(val).decode())
        elif fn in (6, 7):
            titles[fn] = bytes(val).decode()
    assert titles == {6: "d", 7: "t"}
    # root gets "fake" X_..._aa mutations for every codon
    assert "GENE1:X_1_M" in mutation_mapping
    # only NONsynonymous real mutations appear
    assert "GENE1:A_2_D" in mutation_mapping
    assert "GENE1:A_2_A" not in mutation_mapping

    names, parents, xs, ys, num_tips = [], [], [], [], []
    metadata_singles = []
    for fn, wt, val in pw.iter_fields(node_data):
        if fn == 1:
            names.append(bytes(val).decode())
        elif fn == 2:
            xs = pw.decode_packed_float(val)
        elif fn == 3:
            ys = pw.decode_packed_float(val)
        elif fn == 8:
            parents = pw.decode_packed_int32(val)
        elif fn == 11:
            num_tips = pw.decode_packed_int32(val)
        elif fn == 12:
            metadata_singles.append(val)
    assert len(names) == 3
    assert names[0] == ""          # internal "node_" -> empty name
    assert set(names[1:]) == {"L1", "L2"}
    assert parents[0] == 0
    assert num_tips[0] == 2
    assert len(xs) == 3 and len(ys) == 3
    # country metadata column became a MetadataSingleValuePerNode
    assert len(metadata_singles) == 1
    mapping = []
    for fn, wt, val in pw.iter_fields(metadata_singles[0]):
        if fn == 3:
            mapping.append(bytes(val).decode())
    assert set(mapping) == {"", "USA", "UK"}


def test_node_stats_and_roho(tmp_path):
    # two sibling subtrees under root; mutation G2A occurs on c1 only
    T = Tree()
    root = T.create_node("node_root")
    c1 = T.create_node("node_c1", parent=root)
    c1.mutations = [Mutation("ref", 2, T_NT, T_NT, A)]
    c2 = T.create_node("node_c2", parent=root)
    c2.mutations = [Mutation("ref", 3, G, G, C)]
    for i in range(7):
        T.create_node(f"s1_{i}", parent=c1)
    for i in range(8):
        T.create_node(f"s2_{i}", parent=c2)

    ns = str(tmp_path / "nodestats.tsv")
    write_node_stats(T, ns)
    lines = open(ns).read().splitlines()
    assert lines[0] == "node\tleaf_count\tmut_count\tmut_density\trev_from_lineage"
    stats = {l.split("\t")[0]: l.split("\t") for l in lines[1:]}
    assert stats["node_root"][1] == "15"
    assert stats["node_c1"][1] == "7"
    assert stats["node_c1"][2] == "1"

    rh = str(tmp_path / "roho.tsv")
    write_roho_table(T, rh)
    lines = open(rh).read().splitlines()
    assert lines[0].startswith("mutation\tparent_node\tchild_count")
    rows = [l.split("\t") for l in lines[1:]]
    assert len(rows) == 2  # T2A on c1 and G3C on c2 are both candidates
    by_mut = {r[0]: r for r in rows}
    # T2A: with=7, without=[8] -> median 8, roho=log10(7/8)
    assert by_mut["T2A"][4] == "7"
    assert by_mut["T2A"][5] == "8"
    assert abs(float(by_mut["T2A"][6]) - (-0.0579919)) < 1e-4


def _bigger_tree():
    """Condensed + polytomy-rich tree to stress the array path's
    uncondense replay and rotation."""
    import numpy as np
    rng = np.random.default_rng(3)
    nts = [A, C, G, T_NT]
    T = Tree()
    root = T.create_node("node_root")
    nodes = [root]
    state = {id(root): {}}
    for i in range(60):
        parent = nodes[int(rng.integers(len(nodes)))]
        n = T.create_node(f"s{i}", parent)
        st = dict(state[id(parent)])
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(REF_SEQ)))
            ref_nt = {"A": A, "C": C, "G": G, "T": T_NT}[REF_SEQ[p]]
            par = st.get(p, ref_nt)
            alts = [x for x in nts if x != par]
            mut = alts[int(rng.integers(3))]
            n.add_mutation(Mutation("ref", p, ref_nt, par, mut))
            st[p] = mut
        state[id(n)] = st
        nodes.append(n)
    T.condense_leaves()
    return T


def test_translate_arrays_parity(tmp_path, gene_files):
    """translate_arrays (no-Tree path) must byte-match translate_main on
    a condensed randomized tree through the pb roundtrip."""
    from usher_jax.io.pbio import save_mat_pb
    from usher_jax.io.pb_arrays import load_mat_arrays
    from usher_jax.matutils.translate_arrays import translate_arrays
    fasta, gtf = gene_files
    T = _bigger_tree()
    pb = str(tmp_path / "t.pb")
    save_mat_pb(T, pb)

    T2 = __import__("usher_jax.io.pbio", fromlist=["load_mat_pb"]) \
        .load_mat_pb(pb)
    out1 = str(tmp_path / "tree.tsv")
    translate_main(T2, out1, gtf, fasta)

    ma = load_mat_arrays(pb)
    out2 = str(tmp_path / "arr.tsv")
    translate_arrays(ma, out2, gtf, fasta)
    assert open(out1).read() == open(out2).read()


def test_taxodium_arrays_parity(tmp_path, gene_files):
    """save_taxodium_arrays must byte-match save_taxodium_tree (incl.
    rotation, uncondense, metadata interning, y layout)."""
    from usher_jax.io.pbio import load_mat_pb, save_mat_pb
    from usher_jax.io.pb_arrays import load_mat_arrays
    from usher_jax.matutils.translate_arrays import save_taxodium_arrays
    fasta, gtf = gene_files
    T = _bigger_tree()
    pb = str(tmp_path / "t.pb")
    save_mat_pb(T, pb)
    leaves = load_mat_pb(pb)
    leaves.uncondense_leaves()
    meta = tmp_path / "meta.tsv"
    rows = ["strain\tdate\tcountry\tgenbank_accession"]
    for i, lid in enumerate(leaves.get_leaves_ids()[:30]):
        rows.append(f"{lid}\t2020-0{1 + i % 9}-01\tC{i % 5}\tGB{i}")
    meta.write_text("\n".join(rows) + "\n")

    out1 = str(tmp_path / "tree.taxodium.pb")
    save_taxodium_tree(load_mat_pb(pb), out1, [str(meta)], gtf, fasta,
                       title="t", description="d", include_nt=True)
    ma = load_mat_arrays(pb)
    out2 = str(tmp_path / "arr.taxodium.pb")
    save_taxodium_arrays(ma, out2, [str(meta)], gtf, fasta,
                         title="t", description="d", include_nt=True)
    with open(out1, "rb") as f1, open(out2, "rb") as f2:
        assert f1.read() == f2.read()


def test_cli_pb_direct_translate_and_taxodium(tmp_path, gene_files):
    """matUtils summary --pb-direct -t and extract --pb-direct -l run the
    array writers end-to-end and match the tree path byte-for-byte."""
    from usher_jax.cli.matutils_cli import main as mu_main
    from usher_jax.io.pbio import save_mat_pb
    fasta, gtf = gene_files
    T = _bigger_tree()
    pb = str(tmp_path / "t.pb")
    save_mat_pb(T, pb)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    assert mu_main(["summary", "-i", pb, "-d", d1, "-t", "aa.tsv",
                    "-g", gtf, "-f", fasta]) == 0
    assert mu_main(["summary", "-i", pb, "-d", d2, "-t", "aa.tsv",
                    "-g", gtf, "-f", fasta, "--pb-direct"]) == 0
    assert open(os.path.join(d1, "aa.tsv")).read() == \
        open(os.path.join(d2, "aa.tsv")).read()

    assert mu_main(["extract", "-i", pb, "-d", d1, "-l", "tax.pb",
                    "-g", gtf, "-f", fasta, "-B", "ttl"]) == 0
    assert mu_main(["extract", "-i", pb, "-d", d2, "-l", "tax.pb",
                    "-g", gtf, "-f", fasta, "-B", "ttl",
                    "--pb-direct"]) == 0
    with open(os.path.join(d1, "tax.pb"), "rb") as f1, \
            open(os.path.join(d2, "tax.pb"), "rb") as f2:
        assert f1.read() == f2.read()

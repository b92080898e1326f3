"""Native fasta-alignment -> VCF converter (UCSC faToVcf analog).

The reference workflow depends on the UCSC `faToVcf` binary (downloaded, not
in-repo: install/installUbuntu.sh:27-29; used by workflows/Snakefile rule
create_vcf with -maskSites=problematic_sites).  This is a from-scratch
equivalent covering the UShER pipeline's usage:

- input: a multi-fasta alignment (sequences already aligned to the reference
  coordinate system, e.g. mafft --keeplength output); the first sequence is
  the reference unless `reference` names another record
- output: VCF with one row per segregating site; genotype columns index the
  ALT list; 'N' and '-' are missing calls ('.'); other IUPAC ambiguity codes
  are kept as alleles (faToVcf default; UShER's VCF reader resolves them)
- mask_sites: positions whose FILTER column is "mask" in the given VCF
  (the problematic-sites convention) are excluded
"""

from __future__ import annotations

import gzip
import sys

_MISSING = {"N", "-", "?", "*"}


def read_fasta(path: str) -> list[tuple[str, str]]:
    """Ordered (name, sequence) records; names cut at first whitespace."""
    opener = gzip.open if path.endswith(".gz") else open
    records: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(">"):
                if name is not None:
                    records.append((name, "".join(chunks)))
                name = line[1:].split()[0]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        records.append((name, "".join(chunks)))
    return records


def read_mask_sites(path: str) -> set[int]:
    """1-based positions with FILTER == 'mask' (problematic-sites VCF)."""
    masked: set[int] = set()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) >= 7 and fields[6].lower() == "mask":
                try:
                    masked.add(int(fields[1]))
                except ValueError:
                    pass
    return masked


def fa_to_vcf(aligned_fasta: str, out_vcf: str, reference: str = "",
              mask_sites_vcf: str = "", chrom: str = "") -> int:
    """Convert; returns the number of variant rows written."""
    records = read_fasta(aligned_fasta)
    if not records:
        print(f"ERROR: no sequences in {aligned_fasta}", file=sys.stderr)
        return 0
    if reference:
        ref_idx = next((i for i, (n, _) in enumerate(records)
                        if n == reference), None)
        if ref_idx is None:
            print(f"ERROR: reference {reference} not found in "
                  f"{aligned_fasta}", file=sys.stderr)
            return 0
    else:
        ref_idx = 0
    ref_name, ref_seq = records[ref_idx]
    ref_seq = ref_seq.upper()
    chrom = chrom or ref_name
    samples = [(n, s.upper()) for i, (n, s) in enumerate(records)
               if i != ref_idx]
    L = len(ref_seq)
    for n, s in samples:
        if len(s) != L:
            print(f"ERROR: sequence {n} length {len(s)} != reference "
                  f"length {L}; sequences must be aligned "
                  f"(mafft --keeplength)", file=sys.stderr)
            return 0
    masked = read_mask_sites(mask_sites_vcf) if mask_sites_vcf else set()

    rows = 0
    opener = gzip.open if out_vcf.endswith(".gz") else open
    with opener(out_vcf, "wt") as out:
        out.write("##fileformat=VCFv4.2\n")
        out.write(f"##reference={ref_name}\n")
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(n for n, _ in samples) + "\n")
        for i in range(L):
            pos = i + 1
            if pos in masked:
                continue
            ref_c = ref_seq[i]
            if ref_c in _MISSING:
                continue
            alts: list[str] = []
            alt_index: dict[str, int] = {}
            gts: list[str] = []
            any_alt = False
            for _, s in samples:
                c = s[i]
                if c in _MISSING:
                    gts.append(".")
                elif c == ref_c:
                    gts.append("0")
                else:
                    if c not in alt_index:
                        alt_index[c] = len(alts) + 1
                        alts.append(c)
                    gts.append(str(alt_index[c]))
                    any_alt = True
            if not any_alt:
                continue
            ac = [gts.count(str(k + 1)) for k in range(len(alts))]
            an = sum(1 for g in gts if g != ".")
            out.write(f"{chrom}\t{pos}\t{ref_c}{pos}{alts[0]}\t{ref_c}\t"
                      f"{','.join(alts)}\t.\t.\t"
                      f"AC={','.join(map(str, ac))};AN={an}\tGT\t"
                      + "\t".join(gts) + "\n")
            rows += 1
    return rows


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="faToVcf-jax",
        description="Convert an aligned multi-fasta to VCF (UCSC faToVcf "
                    "equivalent for the UShER pipeline).")
    p.add_argument("fasta", help="aligned multi-fasta (first record = "
                                 "reference unless -ref given)")
    p.add_argument("vcf", help="output VCF (.gz supported)")
    p.add_argument("-ref", "--reference", default="",
                   help="name of the reference record")
    p.add_argument("-maskSites", "--mask-sites", default="",
                   help="VCF whose FILTER=mask rows name positions to drop")
    p.add_argument("--chrom", default="", help="CHROM column value "
                                               "(default: reference name)")
    args = p.parse_args(argv)
    n = fa_to_vcf(args.fasta, args.vcf, args.reference, args.mask_sites,
                  args.chrom)
    print(f"Wrote {n} variant rows to {args.vcf}", file=sys.stderr)
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())

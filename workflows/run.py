#!/usr/bin/env python
"""usher-jax workflow runner: the reference Snakefile's pipelines, natively.

Mirrors workflows/Snakefile (reference): one command chains sample
preparation, placement, and the requested analysis.  Run types
(Snakefile:10-28):

  usher       place user samples onto the base MAT
  matUtils    extract covering subtrees around the user samples as
              auspice.us-compatible JSON (-N 500 -j user)
  translate   amino-acid translation of all mutations (needs --gtf --ref)
  taxodium    taxodium-format protobuf of the updated tree
  introduce   introduction/cluster inference on the user samples
  ripples     recombination scan restricted to the user samples
  systematic  per-site parsimony-increase report (parsimony_report.txt)
  outbreak    extract the subtree around the user samples (pb/json/nwk/vcf)

Differences from the reference workflow, by necessity and design:
- no network: the base MAT (--pb), reference fasta (--ref), GTF (--gtf) and
  metadata (--metadata) are local inputs instead of wget-ed artifacts
  (Snakefile rules download_reference/download_protobuf/download_metadata)
- alignment: sequences must already be aligned to reference coordinates
  (the reference shells out to mafft --keeplength); pass either an aligned
  fasta (--fasta, converted by the native faToVcf equivalent, optionally
  masked with --mask-sites) or a ready VCF (--vcf)
- the augur run type shells out to the external augur toolchain in the
  reference and is not reproduced here

Outputs land in --outdir (default ./output) with the Snakefile's filenames.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RUNTYPES = ["usher", "matUtils", "translate", "taxodium", "introduce",
            "ripples", "systematic", "outbreak"]


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


def _need(args, names):
    missing = [n for n in names if not getattr(args, n)]
    if missing:
        _err(f"ERROR: run type '{args.runtype}' requires "
             + ", ".join("--" + n.replace("_", "-") for n in missing))
        raise SystemExit(1)


class Pipeline:
    def __init__(self, args):
        self.args = args
        self.outdir = args.outdir
        os.makedirs(self.outdir, exist_ok=True)
        # downloads must run before any per-rule _need() input check so
        # --download can actually satisfy --ref/--mask-sites/--pb
        self._maybe_download()

    def out(self, name):
        return os.path.join(self.outdir, name)

    # rule download_reference / download_masking / download_protobuf
    # (Snakefile:47-57,72-82,95-105): fetch the standard public artifacts
    # into --outdir/data when --download is given and the input is absent
    DOWNLOADS = {
        "ref": ("wuhCor1.fa.gz",
                "https://hgdownload.soe.ucsc.edu/goldenPath/wuhCor1/"
                "bigZips/wuhCor1.fa.gz"),
        "mask_sites": ("problematic_sites_sarsCov2.vcf",
                       "https://raw.githubusercontent.com/W-L/"
                       "ProblematicSites_SARS-CoV2/master/"
                       "problematic_sites_sarsCov2.vcf"),
        "pb": ("public-latest.all.masked.pb.gz",
               "http://hgdownload.soe.ucsc.edu/goldenPath/wuhCor1/"
               "UShER_SARS-CoV-2/public-latest.all.masked.pb.gz"),
    }

    def _maybe_download(self) -> None:
        if not self.args.download:
            return
        import gzip as _gzip
        import urllib.request
        data = os.path.join(self.outdir, "data")
        os.makedirs(data, exist_ok=True)
        for attr, (fname, url) in self.DOWNLOADS.items():
            if getattr(self.args, attr):
                continue
            dst = os.path.join(data, fname)
            if not os.path.exists(dst):
                _err(f"Downloading {url}")
                urllib.request.urlretrieve(url, dst)
            if dst.endswith(".gz") and attr == "ref":
                plain = dst[:-3]
                if not os.path.exists(plain):
                    with _gzip.open(dst, "rb") as fi, \
                            open(plain, "wb") as fo:
                        fo.write(fi.read())
                dst = plain
            setattr(self.args, attr, dst)

    # rule align_seqs (Snakefile:59-70): mafft --keeplength against the
    # reference; shells out when mafft is installed, else asks for
    # pre-aligned input (the container image here has no aligner)
    def _maybe_align(self) -> str:
        fasta = self.args.fasta
        if not self.args.align:
            return fasta
        _need(self.args, ["ref"])
        import shutil
        import subprocess
        if shutil.which("mafft") is None:
            _err("ERROR: --align needs mafft on PATH (the reference "
                 "workflow's aligner, Snakefile:70); install it or pass "
                 "pre-aligned sequences without --align")
            raise SystemExit(1)
        aln = self.out("aligned_seqs.fa")
        if not os.path.exists(aln):
            threads = str(os.cpu_count() or 1)
            with open(aln, "w") as f:
                subprocess.run(
                    ["mafft", "--thread", threads, "--auto",
                     "--keeplength", "--addfragments", fasta,
                     self.args.ref],
                    stdout=f, check=True)
        return aln

    # rule create_vcf (Snakefile:84-93) -- native faToVcf equivalent
    def vcf(self) -> str:
        if self.args.vcf:
            return self.args.vcf
        _need(self.args, ["fasta"])
        path = self.out("aligned_seqs.vcf")
        if not os.path.exists(path):
            from usher_jax.io.fatovcf import fa_to_vcf, read_fasta
            fasta = self._maybe_align()
            if self.args.ref and not self.args.align:
                # prepend the reference record (rule align_seqs output
                # contains ref + user seqs; mafft --addfragments already
                # emitted it when --align ran)
                ref_recs = read_fasta(self.args.ref)
                user_recs = read_fasta(fasta)
                merged = self.out("aligned_seqs.fa")
                with open(merged, "w") as f:
                    for n, s in ref_recs[:1] + user_recs:
                        f.write(f">{n}\n{s}\n")
                fasta = merged
            n = fa_to_vcf(fasta, path,
                          mask_sites_vcf=self.args.mask_sites)
            if n == 0:
                raise SystemExit(1)
        return path

    # rule get_sample_ids (Snakefile:123-131)
    def sample_ids(self) -> str:
        path = self.out("user_samples.txt")
        if os.path.exists(path):
            return path
        names: list[str] = []
        if self.args.fasta:
            from usher_jax.io.fatovcf import read_fasta
            names = [n for n, _ in read_fasta(self.args.fasta)]
        else:
            import gzip
            opener = gzip.open if self.vcf().endswith(".gz") else open
            with opener(self.vcf(), "rt") as f:
                for line in f:
                    if line.startswith("#CHROM"):
                        names = line.rstrip("\n").split("\t")[9:]
                        break
        with open(path, "w") as f:
            f.write("".join(n + "\n" for n in names))
        return path

    # rule usher (Snakefile:107-121)
    def usher(self) -> str:
        _need(self.args, ["pb"])
        updated = self.out("user_seqs.pb")
        if not os.path.exists(updated):
            from usher_jax.cli.usher_cli import main as usher_main
            rc = usher_main(["-i", self.args.pb, "-v", self.vcf(),
                             "-o", updated, "-d", self.outdir])
            if rc != 0:
                raise SystemExit(rc)
        return updated

    # rule introduce (Snakefile:133-146)
    def introduce(self):
        pb = self.usher()
        from usher_jax.cli.matutils_cli import main as mu
        rc = mu(["introduce", "-i", pb, "-s", self.sample_ids(),
                 "--cluster-output", self.out("user_seqs.clusters.txt"),
                 "--full-output", self.out("user_seqs.introductions.txt")])
        if rc:
            raise SystemExit(rc)

    # rule translate (Snakefile:170-183)
    def translate(self):
        _need(self.args, ["gtf", "ref"])
        pb = self.usher()
        from usher_jax.cli.matutils_cli import main as mu
        rc = mu(["summary", "-i", pb,
                 "-t", self.out("user_seqs.translation.tsv"),
                 "-g", self.args.gtf, "-f", self.args.ref,
                 "-d", "."])
        if rc:
            raise SystemExit(rc)

    # rule extract_subtrees (Snakefile:185-199)
    def matUtils(self):
        pb = self.usher()
        from usher_jax.cli.matutils_cli import main as mu
        cmd = ["extract", "-i", pb, "-s", self.sample_ids(),
               "-N", "500", "-j", "user", "-d", self.outdir]
        if self.args.metadata:
            cmd += ["-M", self.args.metadata]
        rc = mu(cmd)
        if rc:
            raise SystemExit(rc)

    # rule taxodium (Snakefile:201-215)
    def taxodium(self):
        _need(self.args, ["gtf", "ref"])
        pb = self.usher()
        from usher_jax.cli.matutils_cli import main as mu
        cmd = ["extract", "-i", pb, "-l", self.out("user_seqs.taxodium.pb"),
               "-g", self.args.gtf, "-f", self.args.ref, "-d", "."]
        if self.args.metadata:
            cmd += ["-M", self.args.metadata]
        rc = mu(cmd)
        if rc:
            raise SystemExit(rc)

    # rule ripples (Snakefile:217-228)
    def ripples(self):
        pb = self.usher()
        from usher_jax.cli.ripples_cli import main as rp
        rc = rp(["-i", pb, "-s", self.sample_ids(), "-d", self.outdir])
        if rc:
            raise SystemExit(rc)

    # rules extract_parsimony_difference + create_report (Snakefile:230-284)
    def systematic(self):
        """Intentional deviations from the reference pipeline: (a) variants
        present only in the user-augmented summary are INCLUDED (the
        reference's shell `join` silently drops variants absent from the
        public file — their whole parsimony weight is user-contributed, which
        is exactly what this report surfaces); (b) sample counts subtract the
        summary header line (the reference's `wc -l` counts it), so
        per-sample rates use true sample counts."""
        _need(self.args, ["pb"])
        pb = self.usher()
        from usher_jax.cli.matutils_cli import main as mu
        user_m = self.out("parsimony_user_data.txt")
        pub_m = self.out("parsimony_public.txt")
        pub_s = self.out("samples_public.txt")
        tot_s = self.out("samples_total.txt")
        if mu(["summary", "-i", pb, "-s", tot_s, "-m", user_m, "-d", "."]):
            raise SystemExit(1)
        if mu(["summary", "-i", self.args.pb, "-s", pub_s, "-m", pub_m,
               "-d", "."]):
            raise SystemExit(1)

        def counts(path):
            out = {}
            with open(path) as f:
                next(f, None)  # header
                for line in f:
                    fields = line.rstrip("\n").split("\t")
                    if len(fields) >= 2:
                        out[fields[0]] = int(fields[1])
            return out

        pub = counts(pub_m)
        tot = counts(user_m)
        total_samples = max(sum(1 for _ in open(tot_s)) - 1, 1)
        public_samples = max(sum(1 for _ in open(pub_s)) - 1, 1)
        user_samples = max(total_samples - public_samples, 1)
        diffs = []
        for var, t in tot.items():
            p = pub.get(var, 0)
            if t != p:
                diffs.append((var, p, t, t - p))
        diffs.sort(key=lambda r: -r[3])
        with open(self.out("parsimony_report.txt"), "w") as f:
            f.write("variant\tparsimony_public\tparsimony_total\t"
                    "parsimony_user\tparsimony_public/sample\t"
                    "parsimony_user/sample\n")
            for var, p, t, d in diffs:
                f.write(f"{var}\t{p}\t{t}\t{d}\t{p / total_samples}\t"
                        f"{d / user_samples}\n")

    # rules outbreak_samples + outbreak (Snakefile:286-310)
    def outbreak(self):
        pb = self.usher()
        from usher_jax.cli.matutils_cli import main as mu
        rc = mu(["extract", "-i", pb, "-s", self.sample_ids(),
                 "-o", "user_seqs.outbreak.pb",
                 "-j", "user_seqs.outbreak.json",
                 "-t", "user_seqs.outbreak.nwk",
                 "-v", "user_seqs.outbreak.vcf",
                 "-u", "user_seqs.outbreak.txt",
                 "-d", self.outdir])
        if rc:
            raise SystemExit(rc)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="usher-jax-workflow",
        description="Run the usher/matUtils/ripples pipelines "
                    "(workflows/Snakefile equivalent).")
    p.add_argument("--runtype", required=True, choices=RUNTYPES + ["augur"])
    p.add_argument("--fasta", default="",
                   help="user sequences, aligned to reference coordinates")
    p.add_argument("--vcf", default="", help="user sample VCF (alternative "
                                             "to --fasta)")
    p.add_argument("--pb", default="", help="base mutation-annotated tree")
    p.add_argument("--ref", default="", help="reference fasta")
    p.add_argument("--gtf", default="", help="gene annotation GTF")
    p.add_argument("--metadata", default="", help="metadata tsv/csv "
                                                  "(comma-separated list)")
    p.add_argument("--mask-sites", default="",
                   help="problematic-sites VCF; FILTER=mask positions are "
                        "dropped during fasta->VCF conversion")
    p.add_argument("--align", action="store_true",
                   help="run mafft --keeplength against --ref first "
                        "(rule align_seqs; needs mafft on PATH)")
    p.add_argument("--download", action="store_true",
                   help="fetch the public reference/masking/MAT artifacts "
                        "for any of --ref/--mask-sites/--pb not given "
                        "(rules download_*; needs network)")
    p.add_argument("--outdir", default="output")
    args = p.parse_args(argv)

    if args.runtype == "augur":
        import shutil
        if shutil.which("augur") is None:
            _err("ERROR: the augur run type drives the external augur "
                 "toolchain (Snakefile:330-417); augur is not on PATH. "
                 "Install nextstrain-augur, or run augur on the outbreak "
                 "outputs.")
            return 1
        # delegate to the external toolchain over our outbreak outputs,
        # the same handoff the reference's rules perform
        pipe = Pipeline(args)
        pipe.outbreak()
        import subprocess
        tree_nwk = pipe.out("user_seqs.outbreak.nwk")
        aln = pipe.out("aligned_seqs.fa")
        refine_dir = pipe.out("augur")
        os.makedirs(refine_dir, exist_ok=True)
        subprocess.run(
            ["augur", "refine", "--tree", tree_nwk,
             "--output-tree", os.path.join(refine_dir, "tree.nwk"),
             "--output-node-data",
             os.path.join(refine_dir, "branch_lengths.json")]
            + (["--alignment", aln] if os.path.exists(aln) else []),
            check=True)
        _err(f"augur refine outputs in {refine_dir}")
        return 0
    if not args.fasta and not args.vcf:
        _err("ERROR: provide --fasta (aligned) or --vcf")
        return 1

    pipe = Pipeline(args)
    getattr(pipe, args.runtype)()
    _err(f"Run type {args.runtype} complete; outputs in {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

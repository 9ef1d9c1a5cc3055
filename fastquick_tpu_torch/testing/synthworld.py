"""Synthetic PE world generator shared by the device-QC differential
test and the multichip dryrun.

Builds a >=10k-read paired-end world over a fresh random genome with
the adversarial features the device paths must survive (reference
behaviors being exercised: the drand48 repeat draw of bwase.c:19-97,
the gapped-read refine path of bwase.c:339, the k-mer filter):

- REPEATS: two pairs of markers share identical flank windows, so
  their reads hit two reduced-reference contigs (c1 == 2);
- GAPPED reads: fragments with 1-2bp deletions/insertions;
- mismatched reads (~2 errors) and pure-junk pairs (filter fodder).

Returns the index prefix plus the two FASTQ paths; callers drive the
align CLI or the device QC step over them.

build_production_world makes the production-scale world of
tools/stress_production_scale.py (9,000 short + 1,000 long markers on a
~32 Mbp genome, 100,000 read pairs of 150 bp) from a seed.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

N_MARKERS = 60
FLANK = 250
SPACING = 2500
READ_LEN = 100
INSERT = 300
DEPTH = 88  # pairs per marker: 60*88*2 + ~10% junk pairs ~= 11.6k reads


def build_synth_pe_world(tmp, seed: int = 4242, n_markers: int = N_MARKERS,
                         depth: int = DEPTH, build_index: bool = True
                         ) -> dict:
    """Write genome/site-VCF/dbSNP/FASTQ fixtures under `tmp` (a str or
    Path) and optionally build the reduced index.  Returns dict(tmp,
    fq1, fq2, n_reads, ref_fa, cand, dbsnp[, idx_prefix])."""
    tmp = str(tmp)
    rng = np.random.default_rng(seed)
    glen = n_markers * SPACING + 10000
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    positions = [(i + 1) * SPACING for i in range(n_markers)]
    # repeats: markers 10/11 and 30/31 get identical flank windows
    for src, dst in ((10, 11), (30, 31)):
        if dst >= n_markers:
            continue
        ps, pd = positions[src] - 1, positions[dst] - 1
        genome[pd - FLANK:pd + FLANK + 1] = \
            genome[ps - FLANK:ps + FLANK + 1]
    gstr = "".join("ACGT"[c] for c in genome)
    ref_fa = os.path.join(tmp, "genome.fa")
    with open(ref_fa, "w") as fh:
        fh.write(">1\n")
        for i in range(0, glen, 60):
            fh.write(gstr[i:i + 60] + "\n")
    refs = [gstr[p - 1] for p in positions]
    alts = ["ACGT"[(genome[p - 1] + int(rng.integers(1, 4))) % 4]
            for p in positions]
    cand = os.path.join(tmp, "cand.vcf")
    with open(cand, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\n")
        for p, r, a in zip(positions, refs, alts):
            fh.write(f"1\t{p}\trs{p}\t{r}\t{a}\t.\tPASS\tAF=0.3000\n")
    dbsnp = os.path.join(tmp, "dbsnp.vcf")
    with open(dbsnp, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\n")
        for p, r, a in zip(positions, refs, alts):
            fh.write(f"1\t{p}\trs{p}\t{r}\t{a}\t.\tPASS\t.\n")

    comp = str.maketrans("ACGT", "TGCA")
    fq1 = os.path.join(tmp, "r_1.fq.gz")
    fq2 = os.path.join(tmp, "r_2.fq.gz")
    n_reads = 0
    with gzip.open(fq1, "wt") as f1, gzip.open(fq2, "wt") as f2:
        rid = 0
        for m, pos in enumerate(positions):
            for d in range(depth):
                insert = int(rng.integers(INSERT - 50, INSERT + 50))
                fs = max(0, pos - 1 - int(rng.integers(
                    READ_LEN // 2, insert - READ_LEN)))
                frag = list(gstr[fs:fs + insert])
                kind = rid % 10
                if kind == 3:  # mismatches (~2 errors)
                    for _ in range(2):
                        j = int(rng.integers(0, len(frag)))
                        frag[j] = "ACGT"[(("ACGT".index(frag[j])
                                           + int(rng.integers(1, 4))) % 4)]
                elif kind == 5:  # deletion in the fragment -> gapped read
                    j = int(rng.integers(10, READ_LEN - 10))
                    dl = int(rng.integers(1, 3))
                    frag = frag[:j] + frag[j + dl:]
                elif kind == 7:  # insertion -> gapped read
                    j = int(rng.integers(10, READ_LEN - 10))
                    frag = (frag[:j]
                            + ["ACGT"[int(rng.integers(0, 4))]]
                            + frag[j:])
                frag = "".join(frag)
                if len(frag) < READ_LEN + 10:
                    frag = frag + gstr[fs + insert:fs + insert + 20]
                r1 = frag[:READ_LEN]
                r2 = frag[-READ_LEN:].translate(comp)[::-1]
                q = "".join(chr(33 + 30 + int(rng.integers(0, 10)))
                            for _ in range(READ_LEN))
                f1.write(f"@sim{rid}/1\n{r1}\n+\n{q}\n")
                f2.write(f"@sim{rid}/2\n{r2}\n+\n{q}\n")
                rid += 1
                n_reads += 2
                if kind == 9:  # junk pair (k-mer filter fodder)
                    j1 = "".join("ACGT"[c]
                                 for c in rng.integers(0, 4, READ_LEN))
                    j2 = "".join("ACGT"[c]
                                 for c in rng.integers(0, 4, READ_LEN))
                    f1.write(f"@junk{rid}/1\n{j1}\n+\n{q}\n")
                    f2.write(f"@junk{rid}/2\n{j2}\n+\n{q}\n")
                    rid += 1
                    n_reads += 2
    out = dict(tmp=tmp, fq1=fq1, fq2=fq2, n_reads=n_reads, ref_fa=ref_fa,
               cand=cand, dbsnp=dbsnp)
    if build_index:
        from fastquick_tpu_torch.cli import main

        idx_prefix = os.path.join(tmp, "idx")
        rc = main(["index", "--siteVCF", cand, "--dbsnpVCF", dbsnp,
                   "--ref", ref_fa, "--out_prefix", idx_prefix,
                   "--var_short", "100", "--var_long", "0"])
        assert rc == 0
        out["idx_prefix"] = idx_prefix
    return out


def build_production_world(tmp, seed: int = 0, n_short: int = 9000,
                           n_long: int = 1000, n_pairs: int = 100_000,
                           read_len: int = 150, build_index: bool = True
                           ) -> dict:
    """The production-scale world of tools/stress_production_scale.py:run:
    markers every 3,200 bp of a random genome ((markers + 2) * 3,200 bp),
    30% of the pairs covering a marker and 70% drawn from the background
    genome, inserts of 250-419 bp, reads of `read_len` bp at quality 40.
    Writes g.fa, cand.vcf, dbsnp.vcf (every 7th marker) and the two
    FASTQs under `tmp`; optionally builds the index with the port's CLI.
    Returns dict(tmp, fq1, fq2, n_reads, genome_len, ref_fa, cand,
    dbsnp[, idx_prefix])."""
    tmp = str(tmp)
    rng = np.random.default_rng(seed)
    spacing = 3200
    n_markers = n_short + n_long
    glen = (n_markers + 2) * spacing
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    gbytes = np.frombuffer(b"ACGT", np.uint8)[genome].tobytes()
    gstr = gbytes.decode()
    positions = [(i + 1) * spacing for i in range(n_markers)]
    ref_fa = os.path.join(tmp, "g.fa")
    with open(ref_fa, "w") as fh:
        fh.write(">1\n")
        fh.write("\n".join(gstr[i:i + 60] for i in range(0, glen, 60)))
        fh.write("\n")
    cand = os.path.join(tmp, "cand.vcf")
    dbsnp = os.path.join(tmp, "dbsnp.vcf")
    head = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
            "FILTER\tINFO\n")
    afs = rng.uniform(0.05, 0.95, n_markers)
    with open(cand, "w") as fc, open(dbsnp, "w") as fd:
        fc.write(head)
        fd.write(head)
        for j, p in enumerate(positions):
            r = gstr[p - 1]
            a = "ACGT"[("ACGT".index(r) + 1) % 4]
            fc.write(f"1\t{p}\trs{p}\t{r}\t{a}\t.\tPASS\tAF={afs[j]:.3f}\n")
            if j % 7 == 0:
                fd.write(f"1\t{p}\trs{p}\t{r}\t{a}\t.\tPASS\t.\n")
    comp = str.maketrans("ACGT", "TGCA")
    fq1 = os.path.join(tmp, "r_1.fq.gz")
    fq2 = os.path.join(tmp, "r_2.fq.gz")
    marker = rng.integers(0, 10, n_pairs) < 3
    which = rng.integers(0, n_markers, n_pairs)
    inserts = rng.integers(250, 420, n_pairs)
    qual = "I" * read_len
    with gzip.open(fq1, "wt", compresslevel=1) as f1, \
            gzip.open(fq2, "wt", compresslevel=1) as f2:
        for i in range(n_pairs):
            ins = int(inserts[i])
            if marker[i]:
                pos = positions[int(which[i])]
                fs = max(0, pos - 1 - int(rng.integers(60, ins - 60)))
            else:
                fs = int(rng.integers(0, glen - ins))
            frag = gstr[fs:fs + ins]
            f1.write(f"@s{i}/1\n{frag[:read_len]}\n+\n{qual}\n")
            f2.write(f"@s{i}/2\n{frag[-read_len:].translate(comp)[::-1]}"
                     f"\n+\n{qual}\n")
    out = dict(tmp=tmp, fq1=fq1, fq2=fq2, n_reads=2 * n_pairs,
               genome_len=glen, ref_fa=ref_fa, cand=cand, dbsnp=dbsnp)
    if build_index:
        from fastquick_tpu_torch.cli import main

        idx_prefix = os.path.join(tmp, "idx")
        rc = main(["index", "--siteVCF", cand, "--dbsnpVCF", dbsnp,
                   "--ref", ref_fa, "--out_prefix", idx_prefix,
                   "--var_short", str(n_short), "--var_long", str(n_long)])
        assert rc == 0
        out["idx_prefix"] = idx_prefix
    return out


def write_panel(world: dict, n_samples: int = 60, every: int = 4,
                seed: int = 0) -> str:
    """The SVD reference panel of tools/stress_production_scale.py:135-149
    for a world of this module: `n_samples` samples genotyped at every
    `every`-th marker of the world's cand.vcf (its REF and ALT), each
    genotype drawn Binomial(2, 0.3) from `seed`.  Writes and returns
    <tmp>/panel.vcf (``pop+con --RefVCF`` writes its SVD files beside
    it)."""
    from ..io.vcf import VcfReader

    rng = np.random.default_rng(seed)
    path = os.path.join(world["tmp"], "panel.vcf")
    with VcfReader(world["cand"]) as r:
        recs = list(r)[::every]
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(f"S{k}" for k in range(n_samples)) + "\n")
        gts = np.array(["0/0", "0/1", "1/1"])
        for rec in recs:
            gt = "\t".join(gts[rng.binomial(2, 0.3, n_samples)])
            fh.write(f"{rec.chrom}\t{rec.pos}\trs{rec.pos}\t{rec.ref}\t"
                     f"{rec.alt}\t.\tPASS\t.\tGT\t{gt}\n")
    return path

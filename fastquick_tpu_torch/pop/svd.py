"""SVD resource construction from a reference-panel VCF.

Equivalent of SVDcalculator (VerifyBamID/SVDcalculator.cpp): build the
markers x samples hard-genotype matrix from PL/GL/GT fields (:84-181),
row-center by the mean, thin SVD (the reference uses Eigen JacobiSVD in
float32; we use numpy float32 SVD -- column signs may differ, which only
flips PC orientation), and write the .UD/.V/.mu/.bed files (:246-279,
10 columns each).
"""

from __future__ import annotations

import numpy as np

from ..io.vcf import VcfReader
from ..utils.logging import error, notice

ACCEPT_CHR = ({str(i) for i in range(1, 23)}
              | {f"chr{i}" for i in range(1, 23)})
MAX_PHRED = 255


def _genotype_from_sample(fmt_keys: list[str], sample: str) -> int:
    d = dict(zip(fmt_keys, sample.split(":")))
    if "PL" in d:
        pl = [int(x) for x in d["PL"].split(",")[:3]]
    elif "GL" in d:
        pl = [int(-10.0 * float(x)) for x in d["GL"].split(",")[:3]]
    elif "GT" in d:
        gt = d["GT"].replace("|", "/").split("/")
        try:
            geno = int(gt[0]) + int(gt[1])
        except (ValueError, IndexError):
            geno = 0
        return geno
    else:
        error("Cannot recognize GT, GL or PL key in FORMAT field")
    if any(p < 0 for p in pl):
        error("Negative PL or Positive GL observed")
    pl = [min(p, MAX_PHRED) for p in pl]
    min_geno = -1
    min_phred = MAX_PHRED
    for g, p in enumerate(pl):
        if p < min_phred:
            min_phred = p
            min_geno = g
    return min_geno


def process_ref_vcf(vcf_path: str) -> None:
    """ProcessRefVCF: writes <vcf_path>.{UD,V,mu,bed}."""
    rows: list[list[int]] = []
    bed_rows: list[tuple[str, int, str, str]] = []
    samples: list[str] = []
    prev_name = None
    with VcfReader(vcf_path) as reader:
        samples = list(reader.samples)
        if not samples:
            error("No individual genotype information exist in the input "
                  "VCF file %s", vcf_path)
        for rec in reader:
            name = f"{rec.chrom}:{rec.pos}"
            if name == prev_name:
                error("Duplicated Marker at %s", name)
            if rec.chrom not in ACCEPT_CHR:
                continue
            if len(rec.ref) > 1 or len(rec.alts[0]) > 1:
                continue
            if not rec.rest:
                continue
            fmt_keys = rec.rest[0].split(":")
            genos = [_genotype_from_sample(fmt_keys, s) for s in rec.rest[1:]]
            bed_rows.append((rec.chrom, rec.pos, rec.ref[0], rec.alts[0][0]))
            rows.append(genos)
            prev_name = name
    n_markers = len(rows)
    n_samples = len(samples)
    notice("Number of Markers:%d", n_markers)
    notice("Number of Individuals:%d", n_samples)
    geno = np.array(rows, dtype=np.float32)  # markers x samples
    mu = geno.mean(axis=1)
    geno -= mu[:, None]
    # thin SVD (float32 like Eigen JacobiSVD<MatrixXf>)
    U, S, Vt = np.linalg.svd(geno, full_matrices=False)
    UD = U * S[None, :]
    V = Vt.T
    n_out = min(10, UD.shape[1])

    def fmtf(x: float) -> str:
        import math

        if math.isnan(x):
            return "nan"
        return f"{x:.6g}"

    with open(vcf_path + ".mu", "w") as fmu, \
            open(vcf_path + ".UD", "w") as fud, \
            open(vcf_path + ".bed", "w") as fbed:
        for i, (chrom, pos, ref, alt) in enumerate(bed_rows):
            fmu.write(f"{chrom}:{pos}\t{fmtf(float(mu[i]))}\n")
            fbed.write(f"{chrom}\t{pos - 1}\t{pos}\t{ref}\t{alt}\n")
            fud.write("\t".join(fmtf(float(UD[i, j])) for j in range(n_out))
                      + "\t\n")
    with open(vcf_path + ".V", "w") as fpc:
        for k, s in enumerate(samples):
            fpc.write(s + "\t"
                      + "\t".join(fmtf(float(V[k, j])) for j in range(n_out))
                      + "\t\n")

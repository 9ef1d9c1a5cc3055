"""Contamination-estimator cases from a seed, with no external resource.

write_panel writes a reference-panel VCF (two populations, so the panel's
first PC separates them); ``pop+con --RefVCF`` builds the SVD resources
(.UD, .mu, .bed, .V) beside it.  simulate_pileup then draws a sample's
marker pileup under the estimator's own generative model (the model of
tests/test_popcon.py:33-79: each base from the contaminating sample with
probability alpha, an alt allele with probability genotype / 2, a flip at
the base error rate), with allele frequencies from that SVD's means (.mu,
PC coordinates 0), and writes it as a .Pileup file.  Every estimator
under test reads the same files.
"""

from __future__ import annotations

import numpy as np

from ..pop.estimator import MAX_AF, MIN_AF, ContaminationEstimator

SPACING = 1000  # bp between the panel's markers
DEPTH = 8.0  # mean bases a marker (Poisson)
QUAL = 30  # the simulated bases' quality


def write_panel(path: str, n_markers: int = 400, n_samples: int = 40,
                seed: int = 0) -> str:
    """A panel of `n_markers` biallelic SNPs on chromosome 1 (every
    SPACING bp) x `n_samples` GT samples, half of them from each of two
    populations whose allele frequencies differ by up to 0.3."""
    rng = np.random.default_rng(seed)
    af = rng.uniform(0.1, 0.9, n_markers)
    shift = rng.uniform(-0.15, 0.15, n_markers)
    pop_af = np.clip(np.stack([af - shift, af + shift]), 0.01, 0.99)
    ref = rng.integers(0, 4, n_markers)
    alt = (ref + rng.integers(1, 4, n_markers)) % 4
    pop = np.arange(n_samples) % 2
    geno = rng.binomial(2, pop_af[pop].T)  # (markers, samples)
    gts = np.array(["0/0", "0/1", "1/1"])
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\tFORMAT\t"
                 + "\t".join(f"P{p}S{k}" for k, p in enumerate(pop)) + "\n")
        for m in range(n_markers):
            pos = (m + 1) * SPACING
            fh.write(f"1\t{pos}\trs{pos}\t{'ACGT'[ref[m]]}\t"
                     f"{'ACGT'[alt[m]]}\t.\tPASS\t.\tGT\t"
                     + "\t".join(gts[geno[m]]) + "\n")
    return path


def simulate_pileup(svd_prefix: str, path: str, seed: int,
                    alpha_true: float) -> str:
    """Write a .Pileup of one sample at the markers of `svd_prefix`.bed:
    Poisson(DEPTH) bases a marker at base quality QUAL; both the intended
    sample and the contaminant draw their genotypes from the panel's mean
    allele frequencies."""
    rng = np.random.default_rng(seed)
    est = ContaminationEstimator()
    est.read_choose_bed(svd_prefix + ".bed")
    est.read_mean(svd_prefix + ".mu")
    af = np.clip(est.means / 2.0, MIN_AF, MAX_AF)
    g1 = rng.binomial(2, af)  # contaminating sample
    g2 = rng.binomial(2, af)  # intended sample
    eps = 10 ** (-QUAL / 10.0)
    with open(path, "w") as fh:
        for i, (chrom, pos) in enumerate(est.pos_vec):
            d = rng.poisson(DEPTH)
            if d == 0:
                continue
            ref, alt = est.choose_bed[chrom][pos]
            bases = []
            for _ in range(d):
                g = g1[i] if rng.random() < alpha_true else g2[i]
                is_alt = rng.random() < g / 2.0
                if rng.random() < eps:
                    is_alt = not is_alt
                bases.append(alt.upper() if is_alt else ".")
            fh.write(f"{chrom}\t{pos}\t{ref}\t{d}\t{''.join(bases)}\t"
                     f"{chr(QUAL + 33) * d}\n")
    return path


def estimator_from_files(estimator_cls, read_pileup_file, svd_prefix: str,
                         pileup_path: str, num_pc: int = 2):
    """An estimator of `estimator_cls` over the SVD files and the .Pileup,
    read as ``pop+con --PileupFile`` reads them (sanity check off), so
    either package's classes can be passed."""
    est = estimator_cls(num_pc=num_pc, epsilon=1e-8)
    est.read_choose_bed(svd_prefix + ".bed")
    est.read_matrix_ud(svd_prefix + ".UD")
    est.read_mean(svd_prefix + ".mu")
    est.viewer = read_pileup_file(est.choose_bed, pileup_path)
    est.viewer.is_pileup_input = True
    est.is_sanity_check_disabled = True
    return est

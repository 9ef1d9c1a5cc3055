"""pop+con driver: fastquick pop+con.

Equivalent of runVB2 (reference VerifyBamID/vb2Main.cpp:32-277): flag set,
SVD-on-the-fly path, sanity check, the optimization ladder, and the
.Ancestry / .selfSM outputs (+ "Contamination Level" appended to
.Summary).

Counterpart of fastquick_tpu/pop/driver.py.  ``--DeviceLLK`` evaluates the
likelihood with pop/device_llk.DeviceLLK on the torch device named by
``--device`` (cuda, the default, or cpu for the plain PyTorch path); cuda
without a CUDA device raises.  The flag sets device_llk.DEVICE_DEFAULT for
the run and restores it however the run ends.  Where torch.distributed is
initialised with more than one rank, ``--DeviceLLK`` shards the markers
over them (parallel/mesh.make_mesh over the default group), as the
reference does when it sees more than one device; every rank runs the
whole command on the same sample, and DeviceLLK raises on every rank
where their inputs differ."""

from __future__ import annotations

import os

from ..io.fasta import FastaFile
from ..params import ParamList
from ..utils.logging import error, notice, warning
from .estimator import ContaminationEstimator, _fmt
from .pileup import pileup_from_bam, read_pileup_file


def run_popcon(argv: list[str]) -> int:
    from . import device_llk

    saved = device_llk.DEVICE_DEFAULT
    try:
        return _run_popcon(argv)
    finally:
        device_llk.DEVICE_DEFAULT = saved


def _run_popcon(argv: list[str]) -> int:
    pl = ParamList()
    pl.group("Input/Output Files")
    pl.add("BamFile", "Empty", "Bam/Cram file for the sample")
    pl.add("PileupFile", "Empty", "Pileup file for the sample")
    pl.add("Reference", "Empty", "Reference file")
    pl.add("SVDPrefix", "Empty", "SVD files prefix (.UD/.mu/.bed)")
    pl.add("Output", "result", "Prefix of output files")
    pl.group("Model Selection Options")
    pl.add("WithinAncestry", False, "same-population contamination model")
    pl.add("DisableSanityCheck", False, "disable marker sanity check")
    pl.add("DisableBAQ", False, "disable BAQ realignment on BAM input "
           "(the reference's mpileup always applies it)")
    pl.add("NumPC", 4, "number of PCs for AF inference")
    pl.add("FixPC", "Empty", "fixed PCs (PC1:PC2:...)")
    pl.add("FixAlpha", -1.0, "fixed contamination alpha")
    pl.add("KnownAF", "Empty", "known allele frequency file")
    pl.add("NumThread", 4, "likelihood threads")
    pl.add("DeviceLLK", False, "evaluate the mixture likelihood on the "
           "torch device of --device (float32)")
    pl.add("device", "cuda", "torch device of --DeviceLLK: cuda | cpu")
    pl.add("Seed", 12345, "random number seed")
    pl.add("Epsilon", 1e-8, "minimization convergence threshold")
    pl.add("OutputPileup", False, "output temp pileup file")
    pl.add("Verbose", False, "verbose progress")
    pl.group("Construction of SVD Auxiliary Files")
    pl.add("RefVCF", "Empty", "reference panel VCF for SVD build")
    pl.group("Deprecated Options")
    pl.add("UDPath", "Empty", "UD matrix file")
    pl.add("MeanPath", "Empty", "Mean matrix file")
    pl.add("BedPath", "Empty", "marker bed file")
    pl.read(argv)
    pl.status()

    if pl["NumPC"] > 4 and pl["RefVCF"] == "Empty" and pl["SVDPrefix"] != "Empty":
        error("--NumPC only permits as large as 4 PCs with the bundled "
              "SVD resources; prepare your own with --RefVCF")

    if pl["RefVCF"] != "Empty":
        notice("Specified --RefVCF reference panel VCF file, doing SVD on "
               "the fly...")
        from .svd import process_ref_vcf

        process_ref_vcf(pl["RefVCF"])
        notice("Success!")
        return 0

    if pl["SVDPrefix"] != "Empty":
        ud_path = pl["SVDPrefix"] + ".UD"
        mean_path = pl["SVDPrefix"] + ".mu"
        bed_path = pl["SVDPrefix"] + ".bed"
    else:
        ud_path, mean_path, bed_path = pl["UDPath"], pl["MeanPath"], pl["BedPath"]
        if "Empty" in (ud_path, mean_path, bed_path):
            error("--SVDPrefix (or --UDPath/--MeanPath/--BedPath) is required")

    if pl["BamFile"] == "Empty" and pl["PileupFile"] == "Empty":
        error("--BamFile or --PileupFile is required")
    if pl["BamFile"] != "Empty" and pl["Reference"] == "Empty":
        error("--Reference is required")

    est = ContaminationEstimator(num_pc=pl["NumPC"], num_thread=pl["NumThread"],
                                 epsilon=pl["Epsilon"])
    est.verbose = pl["Verbose"]
    est.use_device = pl["DeviceLLK"]
    if est.use_device:
        from ..utils.device import resolve_device
        from . import device_llk

        # raises for cuda without CUDA, before any input is read
        device_llk.DEVICE_DEFAULT = resolve_device(pl["device"])
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            from ..parallel.mesh import make_mesh

            est.device_mesh = make_mesh()
    est.is_heter = not pl["WithinAncestry"]
    est.is_sanity_check_disabled = pl["DisableSanityCheck"]
    est.read_choose_bed(bed_path)

    if pl["FixPC"] != "Empty":
        notice("you specified --FixPC, this will override dynamic PC estimation")
        pcs = [float(t) for t in pl["FixPC"].split(":")]
        if len(pcs) < pl["NumPC"]:
            error("--FixPC provided smaller dimension than --NumPC")
        est.PC[1] = pcs[: pl["NumPC"]]
        est.is_pc_fixed = True
    elif abs(pl["FixAlpha"] + 1.0) > 1e-15:
        notice("you specified --FixAlpha, this will override dynamic alpha "
               "estimation")
        est.alpha = pl["FixAlpha"]
        est.is_alpha_fixed = True
    if pl["KnownAF"] != "Empty":
        est.is_af_known = True
        est.is_pc_fixed = True
        est.is_heter = False
        est.read_af(pl["KnownAF"])

    est.read_matrix_ud(ud_path)
    est.read_mean(mean_path)

    if pl["BamFile"] != "Empty":
        ref = FastaFile(pl["Reference"])

        def fetch(chrom, pos):
            s = ref.fetch(chrom, pos, pos)
            if s is None:
                s = ref.fetch("chr" + chrom, pos, pos)
            return s if s else None

        def fetch_range(chrom, start0, end0):
            # 0-based half-open window for BAQ; clamped at contig ends
            s = ref.fetch(chrom, start0 + 1, end0)
            if s is None:
                s = ref.fetch("chr" + chrom, start0 + 1, end0)
            return s or ""

        est.viewer = pileup_from_bam(est.bed_vec, est.choose_bed,
                                     pl["BamFile"], fetch,
                                     ref_range_fetch=fetch_range,
                                     baq=not pl["DisableBAQ"])
    else:
        est.viewer = read_pileup_file(est.choose_bed, pl["PileupFile"])
        est.viewer.is_pileup_input = True

    if pl["OutputPileup"]:
        with open(pl["Output"] + ".Pileup", "w") as fout:
            for chrom, _beg, end in est.bed_vec:
                v = est.viewer
                if chrom not in v.pos_index or end not in v.pos_index[chrom]:
                    continue
                bases = v.get_base(chrom, end)
                if bases:
                    quals = v.get_qual(chrom, end)
                    fout.write(f"{chrom}\t{end}\t"
                               f"{est.choose_bed[chrom][end][0]}\t"
                               f"{len(bases)}\t{''.join(bases)}\t"
                               f"{''.join(chr(q) for q in quals)}\n")

    if not pl["DisableSanityCheck"]:
        if est.sanity_check():
            notice("Passing Marker Sanity Check...")
        else:
            warning("Insufficient Available markers, check input bam depth "
                    "distribution in output pileup file after specifying "
                    "--OutputPileup")
            return 1

    est.optimize(pl["Output"])

    # vb1-compatible .selfSM
    headers = ("#SEQ_ID\tRG\tCHIP_ID\t#SNPS\t#READS\tAVG_DP\tFREEMIX\t"
               "FREELK1\tFREELK0\tFREE_RH\tFREE_RA\tCHIPMIX\tCHIPLK1\t"
               "CHIPLK0\tCHIP_RH\tCHIP_RA\tDPREF\tRDPHET\tRDPALT")
    with open(pl["Output"] + ".selfSM", "w") as fout:
        fout.write(headers + "\n")
        nreads = ("NA" if est.viewer.is_pileup_input
                  else str(est.viewer.num_bases))
        alpha = (est.global_alpha if est.global_alpha < 0.5
                 else 1.0 - est.global_alpha)
        fout.write(f"{est.viewer.seq_sm}\tNA\tNA\t{est.num_marker}\t{nreads}"
                   f"\t{_fmt(est.viewer.avg_depth)}\t{_fmt(alpha)}\t"
                   f"{_fmt(-est.llk1)}\t{_fmt(-est.llk0)}\tNA\tNA\t"
                   f"NA\tNA\tNA\tNA\tNA\tNA\tNA\tNA\n")
    notice("Success!")
    return 0

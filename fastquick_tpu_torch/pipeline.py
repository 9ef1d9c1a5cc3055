"""End-to-end pipeline driver: fastquick all.

Equivalent of the reference's 545-line shell driver
(bin/FASTQuick_template.sh): step selection
(All | AllButIndex | Index | Align | Contamination | Ancestry |
Visualize, template :169-192; Ancestry and Contamination select the
same pop+con stage, and Align/Contamination/Ancestry also run the
visualize stage, :182-190), index -> SVD resource prep -> align ->
pop+con -> report with the same file-presence idempotence (index
skipped when artifacts exist :324-326, SVD resources when present
:377-385, align refuses to overwrite a finished .Summary :467-470).

Counterpart of fastquick_tpu/pipeline.py with ``--device cuda|cpu``
(default cuda), passed to align (whose auto engine takes the device QC
path on cuda) and to pop+con.  cuda without a CUDA device raises before
any stage runs.
"""

from __future__ import annotations

import os

from .params import ParamList
from .utils.logging import error, notice, warning

STEPS = {"All", "AllButIndex", "Index", "Align", "Contamination",
         "Ancestry", "Visualize"}


def run_pipeline(argv: list[str]) -> int:
    pl = ParamList()
    pl.group("Pipeline")
    pl.add("steps", "All", "All|AllButIndex|Index|Align|Contamination|"
           "Ancestry|Visualize")
    pl.add("output", "Empty", "output prefix [Required]")
    pl.add("index", "Empty", "index prefix (defaults to <output> dir /index)")
    pl.add("device", "cuda", "torch device of align and pop+con: cuda | cpu")
    pl.group("Index stage")
    pl.add("reference", "Empty", "whole-genome reference FASTA")
    pl.add("dbSNP", "Empty", "dbSNP VCF")
    pl.add("candidateVCF", "Empty", "candidate site VCF (e.g. 1000g/hapmap)")
    pl.add("predefinedVCF", "Empty", "predefined marker VCF")
    pl.add("callableRegion", "Empty", "callable-region BED or mask FASTA")
    pl.add("targetRegion", "Empty", "target region BED")
    pl.group("Align stage")
    pl.add("fastqList", "Empty", "tab-delimited fastq list")
    pl.add("fastq_1", "Empty", "pair end 1 fastq")
    pl.add("fastq_2", "Empty", "pair end 2 fastq")
    pl.group("Contamination stage")
    pl.add("SVDPrefix", "Empty", "SVD resource prefix")
    pl.add("RefVCF", "Empty", "reference panel VCF (SVD on the fly)")
    pl.add("DisableSanityCheck", False, "pass --DisableSanityCheck to "
           "pop+con (the reference driver never disables it; its example "
           "scripts do)")
    pl.group("Report stage")
    pl.add("PopLabels", "Empty", "sample->population labels (1000g.pop)")
    pl.read(argv)
    pl.status()

    steps = pl["steps"]
    if steps not in STEPS:
        error("Unknown --steps %s (choose from %s)", steps, "|".join(sorted(STEPS)))
    if pl["output"] == "Empty":
        error("--output is required")
    from .utils.device import resolve_device

    resolve_device(pl["device"])  # raises for cuda without CUDA

    out_prefix = pl["output"]
    idx_prefix = pl["index"]
    if idx_prefix == "Empty":
        idx_prefix = os.path.join(os.path.dirname(out_prefix) or ".", "index")

    from .cli import run_index

    do_index = steps in ("All", "Index")
    do_align = steps in ("All", "AllButIndex", "Align")
    do_con = steps in ("All", "AllButIndex", "Contamination", "Ancestry")
    # every non-index step runs visualization (template :182-190)
    do_vis = steps in ("All", "AllButIndex", "Align", "Contamination",
                       "Ancestry", "Visualize")

    new_ref = idx_prefix + ".FASTQuick.fa"
    if do_index:
        if os.path.exists(new_ref + ".index.npz"):
            notice("Index artifacts exist at %s, skipping index step", new_ref)
        else:
            args = ["--dbsnpVCF", pl["dbSNP"], "--ref", pl["reference"],
                    "--out_prefix", idx_prefix]
            if pl["predefinedVCF"] != "Empty":
                args += ["--predefinedVCF", pl["predefinedVCF"]]
            else:
                args += ["--siteVCF", pl["candidateVCF"]]
            if pl["callableRegion"] != "Empty":
                args += ["--callableRegion", pl["callableRegion"]]
            if pl["targetRegion"] != "Empty":
                args += ["--regionList", pl["targetRegion"]]
            rc = run_index(args)
            if rc != 0:
                return rc

    svd_prefix = pl["SVDPrefix"]
    if do_con and svd_prefix == "Empty" and pl["RefVCF"] != "Empty":
        # SVD resources on the fly (template :387-459)
        if os.path.exists(pl["RefVCF"] + ".UD"):
            notice("SVD resources exist for %s, skipping", pl["RefVCF"])
        else:
            from .pop.driver import run_popcon

            rc = run_popcon(["--RefVCF", pl["RefVCF"]])
            if rc != 0:
                return rc
        svd_prefix = pl["RefVCF"]

    if do_align:
        if os.path.exists(out_prefix + ".Summary"):
            # overwrite guard (template :467-470)
            error("%s.Summary exists; refusing to overwrite a finished "
                  "align run", out_prefix)
        from .align.driver import run_align

        args = ["--index_prefix", idx_prefix, "--out_prefix", out_prefix,
                "--device", pl["device"]]
        if pl["fastqList"] != "Empty":
            args += ["--fq_list", pl["fastqList"]]
        else:
            args += ["--fastq_1", pl["fastq_1"]]
            if pl["fastq_2"] != "Empty":
                args += ["--fastq_2", pl["fastq_2"]]
        rc = run_align(args)
        if rc != 0:
            return rc

    if do_con:
        if svd_prefix == "Empty":
            warning("No --SVDPrefix/--RefVCF; skipping contamination stage")
        else:
            from .pop.driver import run_popcon

            args = ["--PileupFile", out_prefix + ".Pileup",
                    "--SVDPrefix", svd_prefix,
                    "--Output", out_prefix, "--device", pl["device"]]
            if pl["DisableSanityCheck"]:
                args.insert(0, "--DisableSanityCheck")
            rc = run_popcon(args)
            if rc != 0:
                return rc

    if do_vis:
        from .report.report import generate_report

        generate_report(out_prefix,
                        svd_prefix=None if svd_prefix == "Empty" else svd_prefix,
                        pop_path=None if pl["PopLabels"] == "Empty"
                        else pl["PopLabels"])
    notice("Pipeline finished.")
    return 0

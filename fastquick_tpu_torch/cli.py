"""fastquick-torch CLI: index | align | pop+con | report | all | merge.

The port's counterpart of fastquick_tpu/cli.py (reference binary dispatch,
src/FASTQuick.cpp:654-672, with the same flag names).  ``align``, ``all``
and ``pop+con --DeviceLLK`` run on the CUDA device unless ``--device cpu``
is given.

    python -m fastquick_tpu_torch.cli index --siteVCF ... --out_prefix idx
    python -m fastquick_tpu_torch.cli align --fastq_1 r1.fq.gz \\
        --fastq_2 r2.fq.gz --index_prefix idx --out_prefix out --device_qc
    python -m fastquick_tpu_torch.cli all --steps AllButIndex --index idx \\
        --fastq_1 r1.fq.gz --fastq_2 r2.fq.gz --RefVCF panel.vcf \\
        --output out
"""

from __future__ import annotations

import os
import sys

from .params import ParamList
from .utils.logging import FastQuickError, cputime, error, notice, realtime

def run_index(argv: list[str]) -> int:
    t_real = realtime()
    pl = ParamList()
    pl.group("Input/Output Files")
    pl.add("siteVCF", "Empty", "VCF file with candidate variant sites")
    pl.add("predefinedVCF", "Empty", "VCF file with predefined variant sites")
    pl.add("regionList", "Empty", "Bed file with target region list")
    pl.add("dbsnpVCF", "Empty", "dbSNP VCF file")
    pl.add("ref", "Empty", "Reference FASTA file")
    pl.add("out_prefix", "Empty", "Prefix of all the output index files")
    pl.add("callableRegion", "Empty", "Repeat Mask FASTA file or Bed file")
    pl.group("Parameters for Reference Sequence")
    pl.add("var_long", 1000, "number of variants with long flanking region")
    pl.add("var_short", 9000, "number of variants with short flanking region")
    pl.add("flank_len", 250, "flanking region length around each marker")
    pl.add("flank_long_len", 1000, "long flanking region length around each marker")
    pl.read(argv)
    pl.status()

    if pl["out_prefix"] == "Empty":
        error("--out_prefix is required")
    if pl["ref"] == "Empty":
        error("--ref is required")
    if pl["dbsnpVCF"] == "Empty":
        error("--dbsnpVCF is required")
    if pl["siteVCF"] == "Empty" and pl["predefinedVCF"] == "Empty":
        error("Either --siteVCF or --predefinedVCF is required")

    from .index.builder import build_index, write_param
    from .index.refbuilder import RefBuilder

    new_ref = pl["out_prefix"] + ".FASTQuick.fa"
    if os.path.exists(new_ref + ".index.npz"):
        notice("Index file exists, exit...")
        return 0
    notice("Index file doesn't exist, building...")
    rb = RefBuilder(
        vcf_path=pl["siteVCF"], ref_path=pl["ref"], new_ref=new_ref,
        dbsnp_path=pl["dbsnpVCF"], mask_path=pl["callableRegion"],
        flank_short_len=pl["flank_len"], flank_long_len=pl["flank_long_len"],
        num_variant_short=pl["var_short"], num_variant_long=pl["var_long"])
    if pl["predefinedVCF"] == "Empty":
        rb.select_marker(pl["regionList"])
    else:
        rb.input_predefined_marker(pl["predefinedVCF"])
    rb.prepare_ref_seq()
    build_index(new_ref)
    write_param(new_ref, pl["ref"], pl["regionList"], pl["dbsnpVCF"],
                pl["var_long"], pl["var_short"], pl["flank_len"],
                pl["flank_long_len"])
    notice("Real time: %.3f sec; CPU: %.3f sec", realtime() - t_real, cputime())
    return 0


def run_align(argv: list[str]) -> int:
    from .align.driver import run_align as _run

    return _run(argv)


def run_popcon(argv: list[str]) -> int:
    from .pop.driver import run_popcon as _run

    return _run(argv)


def run_report(argv: list[str]) -> int:
    from .report.report import run_report as _run

    return _run(argv)


USAGE = """\
Program: fastquick-torch (FASTQuick on PyTorch + CUDA)

Usage:   fastquick-torch <command> [options]

Command: index      build reduced-reference alignment index
         align      align FASTQ reads + collect QC statistics
                    (--device cuda|cpu, default cuda; --shard_out)
         merge      combine align --shard_out states into final statistics
         pop+con    estimate genetic ancestry and contamination
                    (--DeviceLLK --device cuda|cpu)
         report     render the final QC report
         all        run the whole pipeline (index -> align -> pop+con ->
                    report; --device cuda|cpu, default cuda)
"""


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    try:
        if cmd == "index":
            return run_index(rest)
        if cmd == "align":
            return run_align(rest)
        if cmd in ("pop+con", "popcon", "pop"):
            return run_popcon(rest)
        if cmd == "report":
            return run_report(rest)
        if cmd == "all":
            from .pipeline import run_pipeline

            return run_pipeline(rest)
        if cmd == "merge":
            from .align.driver import run_merge

            return run_merge(rest)
    except FastQuickError:
        return 1
    print(USAGE, file=sys.stderr)
    print(f"Unknown command: {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())

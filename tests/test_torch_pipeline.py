"""The port's ``all``, ``align --shard_out`` + ``merge`` and ``report``
against fastquick_tpu's, on the CPU.

``all --device cpu`` on the synthetic end-to-end world
(tests/test_synthetic_e2e.py) must write every file the reference's
``all`` writes byte-identical: the 12 align product files, .selfSM,
.Ancestry, the SVD files of its own copy of the panel and the
.FinalReport.html.  Shards and their merge are held to a single run under
the comparisons of tests/test_shard_merge.py, with the default engine and
with ``--device_qc``, and each shard's arrays to the reference's shard of
the same half."""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from tests.test_shard_merge import _split_fastq  # noqa: E402
from tests.test_synthetic_e2e import simulate_fastqs, world  # noqa: E402,F401

ALL_OUTPUTS = ("Summary", "DepthDist", "GCDist", "EmpRepDist",
               "EmpCycleDist", "RawInsertSizeDist",
               "AdjustedInsertSizeDist", "SexChromInfo", "Pileup", "vcf",
               "InsertSizeTable", "bam")
POPCON_OUTPUTS = ("selfSM", "Ancestry", "FinalReport.html")
SVD_FILES = ("UD", "mu", "bed", "V")
# the order-insensitive outputs a merge must reproduce exactly
MERGE_FILES = ("DepthDist", "GCDist", "EmpRepDist", "EmpCycleDist",
               "RawInsertSizeDist", "AdjustedInsertSizeDist")


def _mains():
    from fastquick_tpu.cli import main as jax_main
    from fastquick_tpu_torch.cli import main as torch_main

    return jax_main, torch_main


@pytest.fixture(scope="module")
def all_runs(world, tmp_path_factory):
    """``all`` of each package over the same FASTQs, each in a directory
    of its own with its own copy of the panel."""
    jax_main, torch_main = _mains()
    tmp = tmp_path_factory.mktemp("torch_all")
    fq1, fq2 = str(tmp / "a_1.fq.gz"), str(tmp / "a_2.fq.gz")
    simulate_fastqs(world, fq1, fq2, alpha=0.0)
    for name, main, extra in (("ref", jax_main, []),
                              ("port", torch_main, ["--device", "cpu"])):
        d = tmp / name
        d.mkdir()
        shutil.copy(world["panel"], d / "panel.vcf")
        assert main(["all", "--output", str(d / "out"),
                     "--index", str(d / "index"),
                     "--reference", world["ref_fa"], "--dbSNP",
                     world["dbsnp"], "--candidateVCF", world["cand"],
                     "--fastq_1", fq1, "--fastq_2", fq2,
                     "--RefVCF", str(d / "panel.vcf"),
                     "--DisableSanityCheck", *extra]) == 0
    return tmp


@pytest.mark.parametrize("sfx", ALL_OUTPUTS + POPCON_OUTPUTS)
def test_all_product_file_byte_identical(all_runs, sfx):
    ref, port = all_runs / f"ref/out.{sfx}", all_runs / f"port/out.{sfx}"
    assert ref.exists() and port.exists(), sfx
    assert filecmp.cmp(ref, port, shallow=False), sfx


@pytest.mark.parametrize("sfx", SVD_FILES)
def test_all_svd_file_byte_identical(all_runs, sfx):
    ref = all_runs / f"ref/panel.vcf.{sfx}"
    port = all_runs / f"port/panel.vcf.{sfx}"
    assert filecmp.cmp(ref, port, shallow=False), sfx


def test_all_on_cuda_raises_without_cuda(world, tmp_path, monkeypatch):
    """No stage runs when ``all`` asks for a card that is not there."""
    _, torch_main = _mains()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shutil.copy(world["panel"], tmp_path / "panel.vcf")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["all", "--steps", "AllButIndex",
                    "--output", str(tmp_path / "out"),
                    "--index", str(tmp_path / "index"),
                    "--fastq_1", "nonexistent.fq",
                    "--RefVCF", str(tmp_path / "panel.vcf")])
    assert sorted(os.listdir(tmp_path)) == ["panel.vcf"]


# ---------------------------------------------------------- shard + merge

ENGINES = {"default": ["--device", "cpu"],
           "device_qc": ["--device_qc", "--device", "cpu"]}


@pytest.fixture(scope="module")
def shard_world(world, tmp_path_factory):
    """FASTQs of tests/test_shard_merge.py split into two halves, the
    index, and the reference's shard of each half."""
    jax_main, torch_main = _mains()
    tmp = tmp_path_factory.mktemp("torch_shards")
    fq1, fq2 = str(tmp / "s_1.fq.gz"), str(tmp / "s_2.fq.gz")
    simulate_fastqs(world, fq1, fq2, alpha=0.0, depth=6, seed=21)
    idx = str(tmp / "idx")
    assert torch_main(["index", "--siteVCF", world["cand"], "--dbsnpVCF",
                       world["dbsnp"], "--ref", world["ref_fa"],
                       "--out_prefix", idx, "--var_short", "200",
                       "--var_long", "0"]) == 0
    halves = {}
    for h in "ab":
        halves[h] = (str(tmp / f"{h}_1.fq.gz"), str(tmp / f"{h}_2.fq.gz"))
    _split_fastq(fq1, halves["a"][0], halves["b"][0])
    _split_fastq(fq2, halves["a"][1], halves["b"][1])
    for h, (f1, f2) in halves.items():
        assert jax_main(["align", "--fastq_1", f1, "--fastq_2", f2,
                         "--index_prefix", idx, "--out_prefix",
                         str(tmp / f"ref_{h}"), "--shard_out"]) == 0
    return dict(tmp=tmp, fq=(fq1, fq2), idx=idx, halves=halves)


@pytest.fixture(scope="module", params=list(ENGINES))
def shard_runs(request, shard_world):
    """The port's single run, its two shards and their merge."""
    _, torch_main = _mains()
    tmp, idx = shard_world["tmp"], shard_world["idx"]
    eng = request.param
    fq1, fq2 = shard_world["fq"]
    assert torch_main(["align", "--fastq_1", fq1, "--fastq_2", fq2,
                       "--index_prefix", idx, "--out_prefix",
                       str(tmp / f"{eng}_single"), *ENGINES[eng]]) == 0
    for h, (f1, f2) in shard_world["halves"].items():
        assert torch_main(["align", "--fastq_1", f1, "--fastq_2", f2,
                           "--index_prefix", idx, "--out_prefix",
                           str(tmp / f"{eng}_{h}"), "--shard_out",
                           *ENGINES[eng]]) == 0
        assert not (tmp / f"{eng}_{h}.Summary").exists()
    assert torch_main(["merge", "--index_prefix", idx, "--out_prefix",
                       str(tmp / f"{eng}_merged"), str(tmp / f"{eng}_a"),
                       str(tmp / f"{eng}_b")]) == 0
    return eng


def _pileup_depths(path):
    out = {}
    for line in open(path):
        c = line.split("\t")
        out[int(c[1])] = (int(c[3]), "".join(sorted(c[4].upper())))
    return out


def test_merge_matches_single_run(shard_world, shard_runs):
    tmp, eng = shard_world["tmp"], shard_runs
    single, merged = tmp / f"{eng}_single", tmp / f"{eng}_merged"
    for f in MERGE_FILES:
        assert (open(f"{single}.{f}").read()
                == open(f"{merged}.{f}").read()), f"{f} differs"
    assert (open(f"{single}.Summary").read().splitlines()
            == open(f"{merged}.Summary").read().splitlines())
    assert (_pileup_depths(f"{single}.Pileup")
            == _pileup_depths(f"{merged}.Pileup"))


@pytest.mark.parametrize("half", "ab")
def test_shard_arrays_equal_reference(shard_world, shard_runs, half):
    tmp = shard_world["tmp"]
    port = np.load(tmp / f"{shard_runs}_{half}.shard.npz")
    ref = np.load(tmp / f"ref_{half}.shard.npz")
    assert sorted(port.files) == sorted(ref.files)
    for name in ref.files:
        if name == "meta_json":
            want = json.loads(ref[name].tobytes())
            assert json.loads(port[name].tobytes()) == want
        else:
            assert port[name].dtype == ref[name].dtype, name
            np.testing.assert_array_equal(port[name], ref[name], err_msg=name)


def test_merge_on_repeat_world_matches_reference(tmp_path):
    """On the synthetic PE world, whose repeat markers draw their reads'
    hits from the drand48 stream that each shard restarts, a merge need
    not equal a single run; the port's shards and merge must still equal
    the reference's, file for file."""
    from fastquick_tpu_torch.testing.synthworld import build_synth_pe_world

    jax_main, torch_main = _mains()
    w = build_synth_pe_world(tmp_path, n_markers=40, depth=30)
    halves = [tuple(str(tmp_path / f"{h}_{r}.fq.gz") for r in (1, 2))
              for h in "ab"]
    _split_fastq(w["fq1"], halves[0][0], halves[1][0])
    _split_fastq(w["fq2"], halves[0][1], halves[1][1])
    for name, main, extra in (("ref", jax_main, []),
                              ("port", torch_main, ["--device", "cpu"])):
        for h, (f1, f2) in zip("ab", halves):
            assert main(["align", "--fastq_1", f1, "--fastq_2", f2,
                         "--index_prefix", w["idx_prefix"], "--out_prefix",
                         str(tmp_path / f"{name}_{h}"), "--shard_out",
                         *extra]) == 0
        assert main(["merge", "--index_prefix", w["idx_prefix"],
                     "--out_prefix", str(tmp_path / f"{name}_merged"),
                     str(tmp_path / f"{name}_a"),
                     str(tmp_path / f"{name}_b")]) == 0
    for sfx in ALL_OUTPUTS[:-1]:  # merge writes every product file but bam
        assert filecmp.cmp(tmp_path / f"ref_merged.{sfx}",
                           tmp_path / f"port_merged.{sfx}",
                           shallow=False), sfx


# ---------------------------------------------------------------- report


def _report_inputs(tmp_path):
    """The inputs of tests/test_misc_features.py::test_report_generation."""
    prefix = str(tmp_path / "r")
    with open(prefix + ".DepthDist", "w") as fh:
        for i in range(50):
            fh.write(f"{i}\t{100 - i}\n")
    with open(prefix + ".EmpRepDist", "w") as fh:
        for i in range(40):
            fh.write(f"{i}\t1\t100\t{i * 0.9}\n")
    with open(prefix + ".EmpCycleDist", "w") as fh:
        for i in range(100):
            fh.write(f"{i + 1}\t1\t50\t30.0\t0\n")
    with open(prefix + ".GCDist", "w") as fh:
        for i in range(101):
            fh.write(f"{i}\t{i * 10}\t{max(1, i)}\t1.0\n")
    with open(prefix + ".RawInsertSizeDist", "w") as fh:
        for i in range(600):
            fh.write(f"{i}\t{max(0, 300 - abs(i - 350))}\n")
    with open(prefix + ".AdjustedInsertSizeDist", "w") as fh:
        for i in range(600):
            fh.write(f"{i}\t{max(0.0, 1 - abs(i - 350) / 300):.4f}\n")
    with open(prefix + ".Summary", "w") as fh:
        fh.write("Statistics : Value\nEstimated Read Depth : 5.0[5/1]\n")
    with open(prefix + ".FASTQ.csv", "w") as fh:
        fh.write("FASTQ_1,FASTQ_2\na.fq,b.fq\n")
    with open(prefix + ".Sequence.csv", "w") as fh:
        fh.write("FASTQ,Reads,Bases\na.fq,100,8000\n")
    svd = str(tmp_path / "panel")
    with open(svd + ".V", "w") as fh:
        for i in range(8):
            fh.write(f"S{i}\t{i * 0.01}\t{-i * 0.02}\t{i * 0.005}"
                     f"\t{0.1 - i * 0.01}\n")
    pop = str(tmp_path / "pops")
    with open(pop, "w") as fh:
        for i in range(8):
            fh.write(f"S{i}\t{'CEU' if i % 2 else 'YRI'}\n")
    with open(prefix + ".Ancestry", "w") as fh:
        fh.write("PC\tContaminatingSample\tIntendedSample\n")
        for i in range(4):
            fh.write(f"{i + 1}\t0.0{i}\t0.0{i + 1}\n")
    return prefix, svd, pop


def test_report_byte_identical(tmp_path):
    from fastquick_tpu.report.report import generate_report

    _, torch_main = _mains()
    prefix, svd, pop = _report_inputs(tmp_path)
    ref = generate_report(prefix, svd_prefix=svd, pop_path=pop,
                          out_path=str(tmp_path / "ref.html"))
    assert torch_main(["report", "--in_prefix", prefix, "--SVDPrefix", svd,
                       "--PopLabels", pop,
                       "--out", str(tmp_path / "port.html")]) == 0
    html = (tmp_path / "port.html").read_text()
    assert html.count("data:image/png;base64") == 4
    assert filecmp.cmp(ref, tmp_path / "port.html", shallow=False)


def test_report_missing_input(tmp_path):
    from fastquick_tpu_torch.report.report import (
        ReportInputError,
        generate_report,
    )

    _, torch_main = _mains()
    with pytest.raises(ReportInputError):
        generate_report(str(tmp_path / "nothing"))
    assert torch_main(["report", "--in_prefix",
                       str(tmp_path / "nothing")]) == 1


# ----------------------------------------------------------------- guards


def test_pipeline_overwrite_guard(tmp_path):
    _, torch_main = _mains()
    (tmp_path / "out.Summary").write_text("done\n")
    rc = torch_main(["all", "--steps", "Align", "--output",
                     str(tmp_path / "out"), "--index", str(tmp_path / "idx"),
                     "--fastq_1", "nonexistent.fq", "--device", "cpu"])
    assert rc != 0  # refused to overwrite
    assert (tmp_path / "out.Summary").read_text() == "done\n"


def test_unknown_step_rejected(tmp_path):
    _, torch_main = _mains()
    rc = torch_main(["all", "--steps", "Bogus", "--output",
                     str(tmp_path / "x")])
    assert rc != 0


@pytest.mark.parametrize("cmd", ["merge", "pop+con", "popcon", "pop",
                                 "report", "all"])
def test_cli_dispatches_every_command(cmd, capsys):
    from fastquick_tpu_torch.cli import USAGE

    _, torch_main = _mains()
    assert torch_main([cmd]) == 1  # a required flag is missing
    err = capsys.readouterr().err
    assert "not yet ported" not in err and "Unknown command" not in err
    if cmd not in ("popcon", "pop"):  # aliases of pop+con
        assert f"\n         {cmd} " in USAGE

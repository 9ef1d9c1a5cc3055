"""The port's ``align --device_qc --device cpu`` end to end against
fastquick_tpu's ``align`` on the synthetic paired-end world (~11.7k reads
with repeats, gapped reads, mismatches and junk): all 12 product files,
BAM included, must be byte-identical, with the default (resident) search
kernel and with the scan path (``FQ_BS_PALLAS=2``).  Without ``--device
cpu`` the port's ``align`` runs on CUDA and raises where there is none."""

import filecmp

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.testing.synthworld import build_synth_pe_world  # noqa: E402

ALL_OUTPUTS = ("Summary", "DepthDist", "GCDist", "EmpRepDist",
               "EmpCycleDist", "RawInsertSizeDist",
               "AdjustedInsertSizeDist", "SexChromInfo", "Pileup", "vcf",
               "InsertSizeTable", "bam")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    w = build_synth_pe_world(tmp)
    assert w["n_reads"] >= 10000, w["n_reads"]
    return dict(tmp=tmp, args=["--fastq_1", w["fq1"], "--fastq_2", w["fq2"],
                               "--index_prefix", w["idx_prefix"]])


@pytest.fixture(scope="module")
def outputs(world):
    from fastquick_tpu.cli import main as jax_main
    from fastquick_tpu_torch.align import driver
    from fastquick_tpu_torch.cli import main as torch_main

    tmp = world["tmp"]
    assert jax_main(["align", *world["args"],
                     "--out_prefix", str(tmp / "ref")]) == 0
    assert torch_main(["align", *world["args"], "--out_prefix",
                       str(tmp / "port"), "--device_qc",
                       "--device", "cpu"]) == 0
    return tmp, dict(driver.LAST_RUN_STATS)


@pytest.mark.parametrize("sfx", ALL_OUTPUTS)
def test_product_file_byte_identical(outputs, sfx):
    tmp, _ = outputs
    ref, port = tmp / f"ref.{sfx}", tmp / f"port.{sfx}"
    assert ref.exists() and port.exists(), sfx
    assert filecmp.cmp(ref, port, shallow=False), sfx


@pytest.fixture(scope="module")
def scan_stats(world, outputs):
    """The same device run on the scan path (FQ_BS_PALLAS=2)."""
    from fastquick_tpu_torch.align import driver
    from fastquick_tpu_torch.cli import main as torch_main

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FQ_BS_PALLAS", "2")
        assert torch_main(["align", *world["args"], "--out_prefix",
                           str(world["tmp"] / "scan"), "--device_qc",
                           "--device", "cpu"]) == 0
    return dict(driver.LAST_RUN_STATS)


@pytest.mark.parametrize("sfx", ALL_OUTPUTS)
def test_scan_path_product_file_byte_identical(world, scan_stats, sfx):
    ref, scan = world["tmp"] / f"ref.{sfx}", world["tmp"] / f"scan.{sfx}"
    assert scan.exists(), sfx
    assert filecmp.cmp(ref, scan, shallow=False), sfx


def test_scan_path_ran(outputs, scan_stats):
    _, stats = outputs
    assert scan_stats["search_kernel"] == "scan"
    assert scan_stats["searched"] == stats["searched"]
    # every read takes one lane; 1,024 lanes need many refill rounds
    assert scan_stats["rounds"] > scan_stats["searched"] // 1024
    assert scan_stats["busy"] > 0
    assert sum(scan_stats["fb_causes"].values()) >= scan_stats["fallback"]


def test_device_path_ran(outputs):
    _, stats = outputs
    assert stats["engine"] == "device" and stats["device"] == "cpu"
    assert stats["search_kernel"] == "resident" and stats["rounds"] == 0
    assert stats["searched"] > 10000
    # the exact redo took only a small share, and every cause is named
    assert 0 <= stats["fallback"] < stats["searched"] // 4
    assert sum(stats["fb_causes"].values()) >= stats["fallback"]


def test_align_on_cuda_raises_without_cuda(world, monkeypatch):
    from fastquick_tpu_torch.cli import main as torch_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["align", *world["args"], "--out_prefix",
                    str(world["tmp"] / "nocuda"), "--device_qc"])
    assert not (world["tmp"] / "nocuda.bam").exists()

"""The port's pop+con against fastquick_tpu's, with no external resource.

The SVD resources come from a seeded synthetic panel through ``pop+con
--RefVCF`` (testing/popcon_cases.py), or from the panel of the synthetic
end-to-end world (tests/test_synthetic_e2e.py), whose align output feeds
the CLI cases.  The port's float32 DeviceLLK on the CPU is held to the
numpy likelihood and to the reference's DeviceLLK at the reference's own
tolerance (rel 2e-5, tests/test_device_llk.py); everything the numpy path
writes must be byte-identical."""

import filecmp
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch.testing import popcon_cases  # noqa: E402
from tests.test_synthetic_e2e import (  # noqa: E402,F401 (fixtures)
    pipeline,
    simulate_fastqs,
    world,
)

SVD_FILES = (".UD", ".mu", ".bed", ".V")
POINTS = [([0.0, 0.0], 0.03), ([0.05, -0.02], 0.2), ([-0.1, 0.1], 0.45)]


def _mains():
    from fastquick_tpu.cli import main as jax_main
    from fastquick_tpu_torch.cli import main as torch_main

    return jax_main, torch_main


@pytest.fixture(scope="module")
def panels(tmp_path_factory):
    """One seeded panel, a copy for each package, each SVD built by its
    own ``pop+con --RefVCF``; a pileup of alpha 0.1 against the port's."""
    jax_main, torch_main = _mains()
    tmp = tmp_path_factory.mktemp("torch_popcon")
    src = popcon_cases.write_panel(str(tmp / "src.vcf"), seed=11)
    (tmp / "jax").mkdir()
    (tmp / "port").mkdir()
    ref, port = str(tmp / "jax" / "panel.vcf"), str(tmp / "port" / "panel.vcf")
    shutil.copy(src, ref)
    shutil.copy(src, port)
    assert jax_main(["pop+con", "--RefVCF", ref]) == 0
    assert torch_main(["pop+con", "--RefVCF", port]) == 0
    pile = popcon_cases.simulate_pileup(port, str(tmp / "s.Pileup"), seed=3,
                                        alpha_true=0.1)
    return dict(tmp=tmp, ref=ref, port=port, pileup=pile)


def _estimators(panels, pileup=None):
    """(port estimator, reference estimator) over the same files."""
    from fastquick_tpu.pop import estimator as jest
    from fastquick_tpu.pop import pileup as jpile
    from fastquick_tpu_torch.pop import estimator as test
    from fastquick_tpu_torch.pop import pileup as tpile

    pileup = pileup or panels["pileup"]
    return (popcon_cases.estimator_from_files(
                test.ContaminationEstimator, tpile.read_pileup_file,
                panels["port"], pileup),
            popcon_cases.estimator_from_files(
                jest.ContaminationEstimator, jpile.read_pileup_file,
                panels["port"], pileup))


@pytest.mark.parametrize("sfx", SVD_FILES)
def test_svd_build_byte_identical(panels, sfx):
    ref, port = panels["ref"] + sfx, panels["port"] + sfx
    assert filecmp.cmp(ref, port, shallow=False), sfx


@pytest.mark.parametrize("point", POINTS, ids=["p0", "p1", "p2"])
def test_device_llk_three_ways(panels, point):
    from fastquick_tpu.pop.device_llk import DeviceLLK as JaxLLK
    from fastquick_tpu_torch.pop.device_llk import DeviceLLK

    est, _ = _estimators(panels)
    est._prepare()
    args = (est._counts, est._UD_act, est._means_act)
    dev = DeviceLLK(*args, device="cpu")
    pc, a = point
    got = dev(pc, pc, a)
    assert got == pytest.approx(est.compute_mix_llks(pc, pc, a), rel=2e-5)
    assert got == pytest.approx(JaxLLK(*args)(pc, pc, a), rel=2e-5)


def test_device_llk_known_af(panels):
    from fastquick_tpu.pop.device_llk import DeviceLLK as JaxLLK
    from fastquick_tpu_torch.pop.device_llk import DeviceLLK

    est, _ = _estimators(panels)
    est._prepare()
    kaf = np.random.default_rng(0).uniform(0.05, 0.95, est._counts.shape[0])
    est.is_af_known = True
    est._known_af_act = kaf
    args = (est._counts, est._UD_act, est._means_act)
    got = DeviceLLK(*args, known_af=kaf, device="cpu")([0.0, 0.0],
                                                       [0.0, 0.0], 0.25)
    want = est.compute_mix_llks([0.0, 0.0], [0.0, 0.0], 0.25)
    assert got == pytest.approx(want, rel=2e-5)
    assert got == pytest.approx(
        JaxLLK(*args, known_af=kaf)([0.0, 0.0], [0.0, 0.0], 0.25), rel=2e-5)


@pytest.mark.parametrize("heter", [False, True],
                         ids=["within_ancestry", "heter"])
def test_numpy_optimize_identical(panels, heter):
    port, ref = _estimators(panels)
    tmp = panels["tmp"]
    for est, name in ((port, "port"), (ref, "ref")):
        est.is_heter = heter
        est.optimize(str(tmp / f"opt_{name}_{heter}"))
    assert port.global_alpha == ref.global_alpha
    assert port.global_pc == ref.global_pc
    assert filecmp.cmp(tmp / f"opt_port_{heter}.Ancestry",
                       tmp / f"opt_ref_{heter}.Ancestry", shallow=False)


def test_device_optimize_alpha(panels, monkeypatch):
    from fastquick_tpu_torch.pop import device_llk

    port, _ = _estimators(panels)
    dev, _ = _estimators(panels)
    port.optimize(str(panels["tmp"] / "np"))
    monkeypatch.setattr(device_llk, "DEVICE_DEFAULT", "cpu")
    dev.use_device = True
    dev.optimize(str(panels["tmp"] / "dev"))
    assert isinstance(dev._device_llk, device_llk.DeviceLLK)
    a_np = min(port.global_alpha, 1 - port.global_alpha)
    a_dev = min(dev.global_alpha, 1 - dev.global_alpha)
    assert a_dev == pytest.approx(a_np, abs=5e-3)
    assert a_dev == pytest.approx(0.1, abs=0.05)


def test_device_llk_mesh_raises(panels):
    from fastquick_tpu_torch.pop.device_llk import DeviceLLK

    est, _ = _estimators(panels)
    est._prepare()
    with pytest.raises(TypeError, match="mesh"):
        DeviceLLK(est._counts, est._UD_act, est._means_act, mesh=object(),
                  device="cpu")


def test_device_llk_needs_cuda_by_default(panels, monkeypatch):
    """No silent CPU: DeviceLLK's default device and ``pop+con
    --DeviceLLK`` without ``--device cpu`` raise where CUDA is absent."""
    from fastquick_tpu_torch.pop import device_llk

    _, torch_main = _mains()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    est, _ = _estimators(panels)
    est._prepare()
    with pytest.raises(RuntimeError, match="cuda"):
        device_llk.DeviceLLK(est._counts, est._UD_act, est._means_act)
    out = panels["tmp"] / "nocuda"
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["pop+con", "--DeviceLLK", "--DisableSanityCheck",
                    "--PileupFile", panels["pileup"], "--SVDPrefix",
                    panels["port"], "--NumPC", "2", "--Output", str(out)])
    assert not (panels["tmp"] / "nocuda.selfSM").exists()
    assert device_llk.DEVICE_DEFAULT == "cuda"


def test_popcon_device_llk_cli_on_cpu(panels):
    """``pop+con --DeviceLLK --device cpu`` runs DeviceLLK and restores
    the module default after its run; its FREEMIX is numpy's within the
    tolerance of tests/test_device_llk.py."""
    from fastquick_tpu_torch.pop import device_llk

    _, torch_main = _mains()
    tmp = panels["tmp"]
    common = ["--DisableSanityCheck", "--PileupFile", panels["pileup"],
              "--SVDPrefix", panels["port"], "--NumPC", "2"]
    assert torch_main(["pop+con", *common, "--Output", str(tmp / "cli_np")]) \
        == 0
    assert torch_main(["pop+con", *common, "--DeviceLLK", "--device", "cpu",
                       "--Output", str(tmp / "cli_dev")]) == 0
    assert device_llk.DEVICE_DEFAULT == "cuda"
    fm = [float((tmp / f"cli_{k}.selfSM").read_text().splitlines()[1]
                .split("\t")[6]) for k in ("np", "dev")]
    assert fm[1] == pytest.approx(fm[0], abs=5e-3)


@pytest.fixture(scope="module")
def contaminated(world, pipeline):
    """The contaminated sample of tests/test_synthetic_e2e.py:216-230,
    aligned by the reference package."""
    jax_main, _ = _mains()
    tmp = world["tmp"]
    fq1, fq2 = str(tmp / "c_1.fq.gz"), str(tmp / "c_2.fq.gz")
    simulate_fastqs(world, fq1, fq2, alpha=0.15, depth=12, seed=9)
    assert jax_main(["align", "--fastq_1", fq1, "--fastq_2", fq2,
                     "--index_prefix", str(tmp / "idx"),
                     "--out_prefix", str(tmp / "cont")]) == 0
    return tmp / "cont"


@pytest.mark.parametrize("source", ["pileup", "bam"])
@pytest.mark.parametrize("sample", ["clean", "cont"])
def test_popcon_cli_byte_identical(world, pipeline, contaminated, tmp_path,
                                   sample, source):
    jax_main, torch_main = _mains()
    src = pipeline / sample
    if source == "pileup":
        inp = ["--PileupFile", f"{src}.Pileup"]
    else:
        inp = ["--BamFile", f"{src}.bam", "--Reference", world["ref_fa"]]
    common = ["--DisableSanityCheck", *inp, "--SVDPrefix", world["panel"],
              "--NumPC", "2"]
    assert jax_main(["pop+con", *common, "--Output",
                     str(tmp_path / "ref")]) == 0
    assert torch_main(["pop+con", *common, "--Output",
                       str(tmp_path / "port")]) == 0
    for sfx in (".selfSM", ".Ancestry"):
        assert filecmp.cmp(tmp_path / f"ref{sfx}", tmp_path / f"port{sfx}",
                           shallow=False), sfx
    freemix = float((tmp_path / "port.selfSM").read_text().splitlines()[1]
                    .split("\t")[6])
    assert (freemix < 0.05) if sample == "clean" else (0.05 < freemix < 0.3)

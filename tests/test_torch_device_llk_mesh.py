"""The port's marker-sharded DeviceLLK (pop/device_llk.DeviceLLK(mesh=...))
over gloo ranks on the CPU, started by parallel/mesh.spawn (the ranks run
fastquick_tpu_torch.testing.mesh_cases.llk_case and never import JAX):

- at three points, on a seeded panel of 401 markers (so the markers are
  padded to a multiple of the ranks), 2 ranks and 2 x 2: every rank's
  value equal, and within 1e-5 relative of the port's unsharded DeviceLLK
  and of fastquick_tpu's sharded DeviceLLK on the conftest's virtual mesh
  (float32 sums in another order: the reference's own mesh tolerance,
  tests/test_device_llk.py:43-44);
- ``pop+con --DeviceLLK --device cpu`` in each of 2 ranks: the driver
  shards the likelihood over the initialised group, and every rank's
  FREEMIX is within 5e-3 of the numpy path's; given another sample's
  pileup in one rank, the command raises on the ranks instead of summing
  the two samples' likelihoods."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch.parallel.mesh import spawn  # noqa: E402
from fastquick_tpu_torch.testing import mesh_cases, popcon_cases  # noqa: E402

from test_torch_popcon import POINTS  # noqa: E402

LAYOUTS = {"1d": (2, None), "2d": (4, 2)}  # ranks, hosts


def _freemix(prefix: str) -> float:
    with open(prefix + ".selfSM") as fh:
        return float(fh.read().splitlines()[1].split("\t")[6])


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """A seeded panel's SVD (the port's ``pop+con --RefVCF``), a pileup of
    alpha 0.1 against it, and the numpy path's FREEMIX on it."""
    from fastquick_tpu_torch.cli import main as torch_main

    tmp = tmp_path_factory.mktemp("llk_mesh")
    svd = popcon_cases.write_panel(str(tmp / "panel.vcf"), n_markers=401,
                                   seed=11)
    assert torch_main(["pop+con", "--RefVCF", svd]) == 0
    pile = popcon_cases.simulate_pileup(svd, str(tmp / "s.Pileup"), seed=3,
                                        alpha_true=0.1)
    assert torch_main(["pop+con", "--DisableSanityCheck", "--PileupFile",
                       pile, "--SVDPrefix", svd, "--Output",
                       str(tmp / "numpy")]) == 0
    other = popcon_cases.simulate_pileup(svd, str(tmp / "o.Pileup"), seed=4,
                                         alpha_true=0.0)
    return dict(tmp=tmp, svd=svd, pileup=pile, other=other,
                freemix=_freemix(str(tmp / "numpy")))


@pytest.fixture(scope="module")
def runs(panel):
    """Every rank's llk_case results, per layout (the command in the 2-rank
    run only)."""
    out = {}
    for layout, (n, hosts) in LAYOUTS.items():
        case = dict(svd=panel["svd"], pileup=panel["pileup"], device="cpu",
                    points=POINTS)
        if layout == "1d":
            case["cli"] = str(panel["tmp"] / "mesh")
        out[layout] = spawn(mesh_cases.llk_case, n, (case,), hosts=hosts)
    return out


def _estimator(panel):
    from fastquick_tpu_torch.pop.estimator import ContaminationEstimator
    from fastquick_tpu_torch.pop.pileup import read_pileup_file

    est = popcon_cases.estimator_from_files(
        ContaminationEstimator, read_pileup_file, panel["svd"],
        panel["pileup"])
    est._prepare()
    return est


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_llk_matches_unsharded_and_jax(panel, runs, layout):
    from fastquick_tpu.parallel.mesh import make_mesh, make_mesh_2d
    from fastquick_tpu.pop.device_llk import DeviceLLK as JaxLLK
    from fastquick_tpu_torch.pop.device_llk import DeviceLLK

    n, _ = LAYOUTS[layout]
    est = _estimator(panel)
    args = (est._counts, est._UD_act, est._means_act)
    assert est._counts.shape[0] % n != 0, "no padding: the case is vacuous"
    unsharded = DeviceLLK(*args, device="cpu")
    if layout == "1d":
        jllk = JaxLLK(*args, mesh=make_mesh(2), axis="dp")
    else:
        jllk = JaxLLK(*args, mesh=make_mesh_2d(2, 2), axis=("host", "chip"))
    ranks = runs[layout]
    for r, res in enumerate(ranks):
        assert res["markers"] == est._counts.shape[0]
        assert res["values"] == ranks[0]["values"], f"rank {r}"
    for (pc, a), got in zip(POINTS, ranks[0]["values"]):
        want = unsharded(pc, pc, a)
        assert got == pytest.approx(want, rel=1e-5), (pc, a)
        assert got == pytest.approx(jllk(pc, pc, a), rel=1e-5), (pc, a)
        assert got == pytest.approx(est.compute_mix_llks(pc, pc, a),
                                    rel=2e-5), (pc, a)


def test_popcon_device_llk_shards_over_ranks(panel, runs):
    """Each rank's ``pop+con --DeviceLLK`` was given the mesh by the
    driver; the ranks agree, and FREEMIX is within 5e-3 of numpy's."""
    fms = []
    for r, res in enumerate(runs["1d"]):
        assert res["cli_sharded"], f"rank {r}'s DeviceLLK had no mesh"
        fms.append(_freemix(res["cli_prefix"]))
    assert fms[0] == fms[1]
    assert abs(fms[0] - panel["freemix"]) <= 5e-3, (fms, panel["freemix"])


def test_popcon_device_llk_refuses_different_samples(panel):
    """Two ranks given different pileups: the sharded DeviceLLK compares
    its inputs over the mesh and both ranks' ``pop+con`` raise, where a
    sum would give a FREEMIX of neither sample."""
    import torch.multiprocessing as mp

    case = dict(svd=panel["svd"], pileup=panel["pileup"], device="cpu",
                points=[], cli=str(panel["tmp"] / "mixed"),
                cli_pileups=[panel["pileup"], panel["other"]])
    with pytest.raises(mp.ProcessRaisedException,
                       match="every rank must estimate the same sample"):
        spawn(mesh_cases.llk_case, 2, (case,), timeout_s=120)


def test_device_llk_mesh_pads_with_zero_rows():
    """A padding marker as the mesh adds it (zero counts, UD 0, means 1:
    af 0.5) adds nothing: three markers' likelihood equals theirs padded
    with one such marker."""
    from fastquick_tpu_torch.pop.device_llk import DeviceLLK

    rng = np.random.default_rng(5)
    counts = rng.poisson(2.0, (3, 282)).astype(np.float64)
    UD = rng.normal(0, 0.1, (3, 2))
    means = rng.uniform(0.2, 1.8, 3)
    base = DeviceLLK(counts, UD, means, device="cpu")
    pad = DeviceLLK(np.concatenate([counts, np.zeros((1, 282))]),
                    np.concatenate([UD, np.zeros((1, 2))]),
                    np.concatenate([means, np.ones(1)]), device="cpu")
    for pc, a in POINTS:
        assert pad(pc, pc, a) == pytest.approx(base(pc, pc, a), rel=1e-6)

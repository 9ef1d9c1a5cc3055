"""The port's mesh (fastquick_tpu_torch.parallel.mesh over torch.distributed)
on the CPU: gloo ranks started by parallel/mesh.spawn over a FileStore, one
torch thread each, against fastquick_tpu's mesh step on the conftest's
virtual 8-device mesh (make_mesh(2), make_mesh_2d(2, 2)) and against the
port's single-process step.  The ranks run fastquick_tpu_torch.testing.
mesh_cases and never import JAX; the reference runs in this process.

- the group layer: axis sizes and indices, all_gather in rank order, psum,
  pmax, the gather over both axes of a ('host', 'chip') mesh in global
  shard order;
- the exact-match step (make_sharded_qc_step) on tests/test_multichip.py's
  reads, 2 ranks and 2 x 2;
- the full step on tests/test_qc_full.py's worlds (B = 64): the pair world
  with seeded duplicates over 2 ranks, the ragged single-end world over
  2 x 2;
- qc_program.dryrun_multichip(2, device="cpu") on a small synthetic world,
  and parallel/scaling.measure_scaling's agreement check.

Every accumulator, n_pcr_dup, _pair_rows and _drand_state must be identical
(value and dtype); the insert-size estimate's floats within 1e-6
relative."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.align.opts import GapOpt  # noqa: E402
from fastquick_tpu_torch.parallel.mesh import spawn  # noqa: E402
from fastquick_tpu_torch.testing import mesh_cases  # noqa: E402

import qc_step_oracle as qso  # noqa: E402

from test_qc_full import (  # noqa: E402
    make_pair_reads,
    make_ragged_reads,
    md_table_for,
    opt_args_for,
)

LAYOUTS = {"1d": (2, None), "2d": (4, 2)}  # ranks, hosts


def same(want: dict, got: dict, what: str) -> None:
    """Every key of `want` equal in `got` (numpy dicts; _pair_rows
    nested), dtypes included; _ii within 1e-6 relative."""
    bad = []
    for k, w in want.items():
        if k == "_pair_keys":
            continue
        if isinstance(w, dict):
            bad += [f"{k}.{kk}" for kk, ww in w.items()
                    if not _eq(np.asarray(ww), got[k][kk])]
        elif k == "_ii":
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-6,
                                       err_msg=f"{what}: _ii")
        elif not _eq(np.asarray(w), got[k]):
            bad.append(k)
    assert not bad, f"{what}: differ in {bad}"


def _eq(a, b) -> bool:
    b = np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def world():
    import __graft_entry__ as ge
    from fastquick_tpu.ops.qc_full import synthetic_site_tables

    text, dev = ge._tiny_index()
    tables = synthetic_site_tables(np.asarray(text))
    fm_arrays = {"words": dev.words, "occ": dev.occ, "sa": dev.sa,
                 "L2": dev.L2, "primary": dev.primary}
    return np.asarray(text), dev, tables, fm_arrays


def _cases(world):
    """Per layout: the exact-match case and the full-step case (the pair
    world over 2 ranks, the ragged single-end world over 2 x 2)."""
    import __graft_entry__ as ge

    text, dev, _, _ = world
    L = 100
    md = np.array(md_table_for(L, GapOpt()))
    exact = dict(kind="exact", arrays=ge._make_reads(text, 64, 76))
    pair = dict(kind="full", arrays=make_pair_reads(text, 32, L),
                opt_args=opt_args_for(dev, L), md=md, pair_mode=True)
    ragged = dict(kind="full", arrays=make_ragged_reads(text, 64, L),
                  opt_args=opt_args_for(dev, L), md=md, pair_mode=False)
    return {"1d": [dict(kind="collectives"), exact, pair],
            "2d": [dict(kind="collectives"), exact, ragged]}


@pytest.fixture(scope="module")
def runs(world):
    """Every rank's results of each layout's cases, and the port's
    single-process results of the same cases."""
    cases = _cases(world)
    out = {}
    for layout, (n, hosts) in LAYOUTS.items():
        out[layout] = dict(
            ranks=spawn(mesh_cases.step_cases, n, (cases[layout],),
                        hosts=hosts),
            single=mesh_cases.step_cases(None, cases[layout][1:]),
            cases=cases[layout])
    return out


def _jax_mesh(layout):
    from fastquick_tpu.parallel.mesh import make_mesh, make_mesh_2d

    if layout == "1d":
        return make_mesh(2), "dp"
    return make_mesh_2d(2, 2), ("host", "chip")


def _put(mesh, axis, arrays):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return [jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, P(axis) if a.ndim == 1 else P(axis, None))) for a in arrays]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collectives(runs, layout):
    n, hosts = LAYOUTS[layout]
    ranks = [r[0] for r in runs[layout]["ranks"]]
    x = np.array([[r, 10 * r] for r in range(n)], np.int32)
    for r, got in enumerate(ranks):
        assert got["shard"] == r
        np.testing.assert_array_equal(got["everything"], x)
        if hosts is None:
            assert got["shape"] == {"dp": 2} and got["coords"] == {"dp": r}
            members = {"dp": list(range(n))}
        else:
            h, c = divmod(r, n // hosts)
            assert got["shape"] == {"host": 2, "chip": 2}
            assert got["coords"] == {"host": h, "chip": c}
            # 'chip' groups: contiguous ranks; 'host' groups: strided
            members = {"chip": [2 * h, 2 * h + 1], "host": [c, 2 + c]}
        for ax, m in members.items():
            np.testing.assert_array_equal(got[ax]["all_gather"], x[m])
            np.testing.assert_array_equal(got[ax]["psum"], x[m].sum(0))
            np.testing.assert_array_equal(got[ax]["pmax"], x[m].max(0))
        assert got["flags"].dtype == np.bool_


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_exact_step_matches_jax(world, runs, layout):
    from fastquick_tpu.parallel.mesh import make_sharded_qc_step

    _, dev, _, fm_arrays = world
    mesh, axis = _jax_mesh(layout)
    seqs, rseqs, lens, quals = runs[layout]["cases"][1]["arrays"]
    want = make_sharded_qc_step(mesh, fm_arrays, dev.n, axis=axis)(
        *_put(mesh, axis, (seqs, rseqs, lens, quals)))
    want = {k: np.asarray(v) for k, v in want.items()}
    for r, res in enumerate(runs[layout]["ranks"]):
        same(want, res[1]["stats"], f"{layout} rank {r}")
    same(want, runs[layout]["single"][0]["stats"], "single process")
    assert int(want["n_mapped"]) > 0 and int(want["n_reads"]) == 64


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_full_step_matches_jax_and_single(world, runs, layout):
    """2 ranks: the pair world (duplicates, insert sizes, rows); 2 x 2: the
    ragged single-end world.  fastquick_tpu's step takes each read as
    align --device_qc orients it (tests/qc_step_oracle.py)."""
    from fastquick_tpu.parallel.mesh import make_sharded_qc_full_step

    _, dev, tables, fm_arrays = world
    case = runs[layout]["cases"][2]
    mesh, axis = _jax_mesh(layout)
    step = make_sharded_qc_full_step(
        mesh, fm_arrays, tables, case["opt_args"], axis=axis,
        md_table=jnp.asarray(case["md"]), pair_mode=case["pair_mode"])
    want = step(*_put(mesh, axis, qso.relay(*case["arrays"])))
    single = runs[layout]["single"][1]
    for r, res in enumerate(runs[layout]["ranks"]):
        got = res[2]
        same(want, dict(got["stats"], _pair_rows=got["rows"]),
             f"{layout} rank {r} against JAX")
        same(single["stats"], got["stats"], f"{layout} rank {r} against "
             "the single process")
        if case["pair_mode"]:
            for k, v in single["rows"].items():
                assert _eq(v, got["rows"][k]), k
    if case["pair_mode"]:
        stats = runs[layout]["ranks"][0][2]["stats"]
        assert int(stats["n_pcr_dup"]) == int(want["n_pcr_dup"]) > 0
        assert int(stats["n_pair_reads"]) > 0
    assert int(want["n_mapped"]) > 40


def test_dryrun_multichip_on_cpu(tmp_path):
    """mesh-2 (gloo ranks) against one device, on a small synthetic
    world: 13 product files byte-identical."""
    from fastquick_tpu_torch import qc_program as qp

    res = qp.dryrun_multichip(2, device="cpu", tmp=str(tmp_path),
                              world_kw=dict(n_markers=12, depth=20))
    assert len(res["files"]) == 13 and res["n_mapped"] > 0
    assert res["n_pair_reads"] > 0
    two = res["runs"][2][1]["runs"]["synth"]  # rank 1
    assert two["launches"] == {k: 0 for k in two["launches"]}  # the CPU
    assert "exchange" in two["times"]


def test_measure_scaling_ranks_agree(tmp_path):
    """measure_scaling on the CPU, on a small synthetic world through
    run_with_fill: every rank's merged accumulators at 2 ranks equal one
    rank's (it raises otherwise)."""
    from fastquick_tpu_torch.parallel.scaling import (comm_report,
                                                      measure_scaling)
    from fastquick_tpu_torch.testing.synthworld import build_synth_pe_world

    w = build_synth_pe_world(str(tmp_path), n_markers=12, depth=20)
    spec = dict(tmp=str(tmp_path), idx_prefix=w["idx_prefix"], fq1=w["fq1"],
                fq2=w["fq2"], device="cpu", pileup_cap=128,
                runs=[dict(name="synth", kernel="resident", fill=True)])
    rows = measure_scaling(spec, (1, 2))
    assert [r["ranks"] for r in rows] == [1, 2]
    assert rows[0]["n_mapped"] == rows[1]["n_mapped"] > 0
    assert rows[1]["exchange_s"] > 0 and rows[0]["reads_per_sec"] > 0
    model = comm_report()
    assert model[0]["nvlink_ms"] == 0 and model[-1]["net_ms"] > 0


def test_spawn_raises_when_a_rank_fails():
    """A rank that raises (5 rows over 2 ranks) makes spawn raise, with
    the rank's error, after the other rank is stopped."""
    import torch.multiprocessing as mp

    bad = dict(kind="exact", arrays=tuple(np.zeros((5, 8), np.int32)
                                          for _ in range(4)))
    with pytest.raises(mp.ProcessRaisedException, match="5 rows over 2"):
        spawn(mesh_cases.step_cases, 2, ([bad],), timeout_s=60)

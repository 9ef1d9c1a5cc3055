"""The port's mesh step on indexed FASTQ worlds over gloo ranks on the CPU
(fastquick_tpu_torch.testing.mesh_cases.world_case through parallel/mesh.
spawn), against fastquick_tpu's make_sharded_qc_full_step at the same
shape on the conftest's virtual mesh and against the port's
single-process run:

- 128 pairs of the drand48 repeat world (tests/test_drand48_qc.py) at pool
  96, over a 2 x 2 mesh: run_with_fill, each rank redoing the fallback
  reads of its own rows with the host engine, drand48 on;
- the occurrence-overflow world (tests/test_pe_occ_overflow.py) over 2
  ranks, its pairs interleaved so that both ranks hold repeat pairs, with
  an ovf_cap of 12: the second pairing pass's budget runs out inside rank
  1's rows, so its base (the pairs of rank 0) decides which pairs it
  takes.

Every accumulator, n_pcr_dup, _pair_rows and _drand_state must be
identical; the insert-size estimate's floats within 1e-6 relative."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch import qc_program as qp  # noqa: E402
from fastquick_tpu_torch.parallel.mesh import spawn  # noqa: E402
from fastquick_tpu_torch.testing import mesh_cases  # noqa: E402

import qc_step_oracle as qso  # noqa: E402

from test_drand48_qc import world as drand_world  # noqa: E402,F401
from test_pe_occ_overflow import world as occ_world  # noqa: E402,F401
from test_pe_qc_differential import _load, _read_pairs  # noqa: E402
from test_qc_resident import N_PAIRS  # noqa: E402
from test_torch_mesh import same  # noqa: E402
from test_torch_qc_program import RESIDENT_OPTS  # noqa: E402

OVF_CAP = 12


def _case(world, **kw):
    return dict(tmp=str(world["tmp"]), idx_prefix=str(world["tmp"] / "idx"),
                fq1=world["fq1"], fq2=world["fq2"], L=128, **kw)


def _port_arrays(case):
    """The batch world_case builds from `case`, as numpy arrays (seqs,
    rseqs, quals, lens), and the world."""
    w = qp.world_from_files(case["tmp"], case["idx_prefix"], case["fq1"],
                            case["fq2"], "a_1.fq", "a_2.fq", device="cpu",
                            L=case["L"])
    n = case.get("n_pairs") or w["n_pairs"]
    order = np.asarray(case.get("pair_order", np.arange(n)))
    rows = np.stack([2 * order, 2 * order + 1], 1).reshape(-1)
    return [a.numpy()[rows] for a in w["arrays"]], w, rows


def _jax_step(world, opt_args, md, mesh, axis, arrays, fb_fill=None):
    from fastquick_tpu.ops.fm import DeviceFM
    from fastquick_tpu.ops.qc_full import build_site_tables
    from fastquick_tpu.parallel.mesh import make_sharded_qc_full_step
    from fastquick_tpu.stats.collector import StatCollector

    idx, opt, new_ref = _load(world)
    sc = StatCollector()
    sc.restore_vcf_sites(new_ref, opt)
    tables = build_site_tables(idx, sc, opt)
    dev = DeviceFM.build(idx.fm_fwd, idx.fm_rev)
    fm = {"words": dev.words, "occ": dev.occ, "sa": dev.sa, "L2": dev.L2,
          "primary": dev.primary}
    step = make_sharded_qc_full_step(mesh, fm, tables, opt_args, axis=axis,
                                     md_table=jnp.asarray(md),
                                     pair_mode=True)
    fill = None if fb_fill is None else tuple(jnp.asarray(a)
                                              for a in fb_fill)
    # each read as align --device_qc orients it (tests/qc_step_oracle.py)
    return step(*qso.relay(*arrays), fb_fill=fill)


def _check(want, ranks, single, n_pairs):
    for r, res in enumerate(ranks):
        got = dict(res["stats"], _pair_rows={
            k: v for k, v in res["rows"].items()})
        want_r = dict(want, _pair_rows={k: np.asarray(v)[:n_pairs]
                                        for k, v in want["_pair_rows"]
                                        .items()})
        same(want_r, got, f"rank {r} against JAX")
        same(dict(single["stats"], _pair_rows=single["rows"]), got,
             f"rank {r} against the single process")


def test_drand48_fill_2x2_matches_jax(drand_world):  # noqa: F811
    """run_with_fill over 2 x 2 ranks at pool 96: the fill pass with each
    rank's own host redo equals the reference's mesh step given the same
    fill, and the port's single-process recipe."""
    from fastquick_tpu.align.engine import HostEngine
    from fastquick_tpu.ops.qc_full import pack_host_hits
    from fastquick_tpu.parallel.mesh import make_mesh_2d

    case = _case(drand_world, n_pairs=N_PAIRS, fill=True,
                 opts=dict(RESIDENT_OPTS, pool=96))
    ranks = spawn(mesh_cases.world_case, 4, (case,), hosts=2)
    single = mesh_cases.world_case(None, case)
    assert single["fallback_first"] > 0, "pool 96 forced no fallback"

    arrays, w, _ = _port_arrays(case)
    w["opt_args"].update(case["opts"])
    w["arrays"] = tuple(torch.from_numpy(a) for a in arrays)
    w["reads"], w["names"] = w["reads"][: 2 * N_PAIRS], w["names"][:N_PAIRS]
    w["n_pairs"] = N_PAIRS
    _, _, pr = qp.run_single(w, per_read=True)
    fb = pr["fallback"].numpy() != 0
    idx, opt, _ = _load(drand_world)
    b0, b1 = _read_pairs(drand_world, idx, opt)
    flat = [p for i in range(N_PAIRS) for p in (b0[i], b1[i])]
    rows_idx = np.nonzero(fb)[0]
    redo = [flat[b] for b in rows_idx]
    HostEngine(idx).align_batch(redo, opt)
    fill = pack_host_hits(redo, rows_idx, fb.shape[0])
    want = _jax_step(drand_world, dict(w["opt_args"]),
                     w["md_table"].numpy(), make_mesh_2d(2, 2),
                     ("host", "chip"), arrays, fill)
    _check(want, ranks, single, N_PAIRS)
    for res in ranks:
        assert res["fallback_first"] == single["fallback_first"]
        assert int(res["stats"]["n_fallback"]) == 0
    assert "_drand_state" in want and int(want["n_mapped"]) > 0


def test_ovf_budget_crosses_rank_boundary(occ_world):  # noqa: F811
    """The repeat pairs (16-31) interleaved with the unique ones (0-15):
    each rank holds 8 repeat pairs, whose mapped ends overflow k_occ = 32;
    with an ovf_cap of 12, rank 1 may take only what rank 0 left."""
    from fastquick_tpu.parallel.mesh import make_mesh

    order = np.stack([np.arange(16), np.arange(16, 32)], 1).reshape(-1)
    case = _case(occ_world, pair_order=order.tolist(),
                 opts=dict(k_occ2=512, ovf_cap=OVF_CAP))
    ranks = spawn(mesh_cases.world_case, 2, (case,))
    single = mesh_cases.world_case(None, case)
    arrays, w, _ = _port_arrays(case)
    w["opt_args"].update(case["opts"])
    want = _jax_step(occ_world, dict(w["opt_args"]), w["md_table"].numpy(),
                     make_mesh(2), "dp", arrays)
    _check(want, ranks, single, 32)
    # rank 0 holds at most 8 < OVF_CAP overflow pairs, so the pairs left
    # past the budget are rank 1's: its base decided them
    assert int(want["n_pair_ovf"]) == int(single["stats"]["n_pair_ovf"]) > 0

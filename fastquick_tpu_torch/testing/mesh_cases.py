"""Rank functions for parallel/mesh.spawn: the mesh cases that the tests
and chip_smoke.py run over gloo ranks.  Each takes (mesh, case) and
returns numpy values, so that the caller can hold every rank's result
against a single-process run and against the reference package's mesh
step (which the caller runs: these never import it).  A mesh of None runs
the same case in this process on one device.

- step_cases: the mesh's collectives on rank-dependent values, the
  sharded full step (parallel/mesh.make_sharded_qc_full_step) or the
  exact-match step (make_sharded_qc_step) on given reads over
  qc_program.tiny_index's world, each rank its block of the rows;
- world_case: qc_program.mesh_stats or run_with_fill on a world from
  files, cut to its first n_pairs pairs and with its pairs in pair_order;
- llk_case: DeviceLLK sharded over the markers on SVD files and a pileup,
  at given points, and optionally ``pop+con --DeviceLLK`` through the
  driver's mesh hook.
"""

from __future__ import annotations

import contextlib
import sys
import time
from unittest import mock

import numpy as np
import torch

from .. import qc_program as qp
from ..ops.qc_full import synthetic_site_tables
from ..parallel.mesh import (
    local_rows,
    make_sharded_qc_full_step,
    make_sharded_qc_step,
)


def _numpy(d):
    if d is None:
        return None
    return {k: (_numpy(v) if isinstance(v, dict)
                else v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


def _collectives(mesh) -> dict:
    """Every helper of the mesh on x = [r, 10 r] (r: this rank's shard
    index), and the gather over every axis in global shard order."""
    from ..parallel.mesh import _gather

    r = mesh.shard_index()
    x = torch.tensor([r, 10 * r], dtype=torch.int32)
    out = dict(shard=r, shape=dict(mesh.shape),
               coords={ax: mesh.axis_index(ax) for ax in mesh.axis_names},
               flags=mesh.all_gather(torch.tensor([r % 2 == 1]),
                                     mesh.axis_names[-1]).numpy(),
               everything=_gather(mesh, x, mesh.axis_names).numpy())
    for ax in mesh.axis_names:
        out[ax] = {f.__name__: f(x, ax).numpy()
                   for f in (mesh.all_gather, mesh.psum, mesh.pmax)}
    return out


def _step_case(mesh, case: dict, text, fm) -> dict:
    if case["kind"] == "collectives":
        return _collectives(mesh)
    arrays = case["arrays"]
    if mesh is None:
        mine = [torch.from_numpy(a) for a in arrays]
    else:
        lo, nb = local_rows(mesh, arrays[0].shape[0])
        mine = [torch.from_numpy(a[lo: lo + nb]) for a in arrays]
    if case["kind"] == "exact":  # arrays: seqs, rseqs, lens, quals
        if mesh is None:
            from ..parallel.mesh import qc_step_local

            return dict(stats=_numpy(qc_step_local(fm, fm.n, None, 0,
                                                   *mine)))
        step = make_sharded_qc_step(mesh, fm, fm.n, axis=mesh.axis_names)
        return dict(stats=_numpy(step(*mine)))
    # "full"; arrays: seqs, rseqs, quals, lens
    tables = synthetic_site_tables(text, device=fm.device)
    md = torch.from_numpy(case["md"])
    if mesh is None:
        from ..ops.qc_full import count_pcr_dups, qc_step_full

        out = qc_step_full(fm, tables, case["opt_args"], *mine, md_table=md,
                           pair_mode=case["pair_mode"])
        if case["pair_mode"]:
            out["n_pcr_dup"] = count_pcr_dups(out.pop("_pair_keys"))
    else:
        out = make_sharded_qc_full_step(
            mesh, fm, tables, case["opt_args"], md_table=md,
            pair_mode=case["pair_mode"], axis=mesh.axis_names)(*mine)
    rows = out.pop("_pair_rows", None)
    return dict(stats=_numpy(out), rows=_numpy(rows))


def step_cases(mesh, cases: list) -> list:
    """Each case: kind ("collectives", "full" or "exact"), arrays (numpy,
    the whole batch: seqs, rseqs, quals, lens for "full"; seqs, rseqs,
    lens, quals for "exact"), and for "full" opt_args, md (the maxdiff
    table) and pair_mode."""
    text, fm = qp.tiny_index(device="cpu")
    return [_step_case(mesh, c, text, fm) for c in cases]


def world_case(mesh, case: dict) -> dict:
    """case: tmp, idx_prefix, fq1, fq2 (a world's files), L, n_pairs (its
    first pairs, default all), pair_order (a permutation of those pairs),
    opts (opt_args overrides), fill (run_with_fill with the host engine,
    else mesh_stats).  Returns the merged stats, the rows and the first
    pass's fallback count."""
    from ..align.engine import HostEngine

    w = qp.world_from_files(case["tmp"], case["idx_prefix"], case["fq1"],
                            case["fq2"], "a_1.fq", "a_2.fq", device="cpu",
                            L=case.get("L", 128))
    n = case.get("n_pairs") or w["n_pairs"]
    order = np.asarray(case.get("pair_order", np.arange(n)))
    rows = np.stack([2 * order, 2 * order + 1], 1).reshape(-1)
    idx = torch.from_numpy(rows)
    w["arrays"] = tuple(a[idx] for a in w["arrays"])
    w["reads"] = [w["reads"][r] for r in rows]
    w["names"] = [w["names"][i] for i in order]
    w["n_pairs"] = n
    w["n_base"] = sum(p.full_len for p in w["reads"])
    w["opt_args"].update(case.get("opts", {}))
    fb1 = None
    if case.get("fill"):
        stats, prow, fb1 = qp.run_with_fill(w, engine=HostEngine(w["idx"]),
                                            mesh=mesh)
    else:
        stats, prow = qp.mesh_stats(w, mesh)
    return dict(stats=_numpy(stats), rows=prow, fallback_first=fb1)


def llk_case(mesh, case: dict) -> dict:
    """case: svd (the SVD files' prefix), pileup, device, points ([(pc,
    alpha)]), num_pc (the estimator's, default 2); cli: an output prefix
    for ``pop+con --DeviceLLK`` at its defaults (each rank writes
    <cli>_r<rank>), run with torch.distributed initialised, so through
    the driver's mesh hook; cli_pileups: the command's pileup for each
    rank (default: pileup).  Returns the sharded likelihood at each
    point, the markers, a call's mean time over case["reps"] calls (host
    clock, its sum and sync included), and the command's output prefix,
    wall time and whether its DeviceLLK was given a mesh."""
    from ..cli import main as cli_main
    from ..pop.device_llk import DeviceLLK
    from ..pop.estimator import ContaminationEstimator
    from ..pop.pileup import read_pileup_file
    from .popcon_cases import estimator_from_files

    est = estimator_from_files(ContaminationEstimator, read_pileup_file,
                               case["svd"], case["pileup"],
                               num_pc=case.get("num_pc", 2))
    est._prepare()
    axis = mesh.axis_names if mesh is not None else "dp"
    llk = DeviceLLK(est._counts, est._UD_act, est._means_act, mesh=mesh,
                    axis=axis, device=case["device"])
    out = dict(values=[llk(pc, pc, a) for pc, a in case["points"]],
               markers=int(est._counts.shape[0]))
    reps = case.get("reps", 0)
    if reps:
        pc, a = case["points"][0]
        t0 = time.perf_counter()
        for _ in range(reps):
            llk(pc, pc, a)
        out["call_ms"] = (time.perf_counter() - t0) / reps * 1e3
    if case.get("cli"):
        rank = 0 if mesh is None else mesh.shard_index()
        prefix = f"{case['cli']}_r{rank}"
        pileup = (case["cli_pileups"][rank] if "cli_pileups" in case
                  else case["pileup"])
        meshes = []
        init = DeviceLLK.__init__

        def record(self, *args, **kw):
            meshes.append(kw.get("mesh"))
            init(self, *args, **kw)

        t0 = time.perf_counter()
        # the estimator's report goes to stderr: stdout is the caller's
        with mock.patch.object(DeviceLLK, "__init__", record), \
                contextlib.redirect_stdout(sys.stderr):
            rc = cli_main(["pop+con", "--DeviceLLK", "--DisableSanityCheck",
                           "--PileupFile", pileup, "--SVDPrefix",
                           case["svd"], "--Output", prefix, "--device",
                           case["device"]])
        if rc != 0:
            raise RuntimeError(f"pop+con --DeviceLLK returned {rc}")
        out.update(cli_prefix=prefix, cli_s=time.perf_counter() - t0,
                   cli_sharded=bool(meshes) and all(
                       m is not None for m in meshes))
    return out

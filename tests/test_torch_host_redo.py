"""The one-program step's exact redo (ops/host_redo.py): the card's retry
of the pool overflows, then the engine's redo as arrays, against the route
through Read objects: copies of the fallback rows' reads,
NativeEngine.align_batch and pack_host_hits.  The world is the
benchmark's, cut small (portbench/gen: 30 markers, 100 2 x 150 panel
pairs), its fallback rows those of a first pass at pool 16, plain PyTorch
on the CPU (the retry through the plain search).

- host_redo.fill's (fb_n, fb_rows) bit-identical to the object route's on
  the same rows: default options, the control options (fnr -1, max_diff
  1), rows of mixed lengths, filtered rows among the fallbacks, a rank's
  block past the first row with padding rows, an engine whose OUT_CAP
  sends rows on to its Python oracle, and a step cap that stops some of
  the retried rows, which the engine then redoes;
- rows whose first-pass bits hold another cause than the pool never
  enter the retry; the counters add up;
- run_with_fill with a NativeEngine equal to run_with_fill with a
  HostEngine, with the retry finishing every row and with both routes.
"""

import copy
import os
from unittest import mock

import numpy as np
import pytest
import torch

from fastquick_tpu_torch import qc_program as qp
from fastquick_tpu_torch.align.engine import HostEngine, NativeEngine
from fastquick_tpu_torch.ops import host_redo
from fastquick_tpu_torch.ops.qc_full import pack_host_hits
from fastquick_tpu_torch.ops.search_kernels import (
    FB_AMAX,
    FB_POOL,
    FB_SCORE,
    FB_STEPCAP,
)
from portbench import run
from portbench.gen import reads, world

torch.set_num_threads(1)  # one intra-op thread per test worker

PAIRS = 100
POOL = 16


def program_world(work: str) -> dict:
    """The program cell's world, cut small, on the CPU at pool 16 (the
    cell's chain and step cap)."""
    cfg = run.load_json(run.HERE, "configs", "fqdefault_program.json")
    cfg["world"].update(n_markers=30)
    cfg["index"].update(var_long=5, var_short=25)
    index = world.ensure_index(cfg, os.path.join(work, "index"))
    mix = run.load_json(run.HERE, "traffic", "panel.json")
    s = reads.sample(world.genome(cfg["world"]), cfg["index"], mix, PAIRS,
                     2**31 + 11)
    fq = (os.path.join(work, "r_1.fq.gz"), os.path.join(work, "r_2.fq.gz"))
    reads.write_fastq(s, *fq, mix["fastq_gzip_level"])
    w = qp.world_from_files(work, index, *fq, "r_1.fq", "r_2.fq",
                            device="cpu", L=cfg["padded_len"])
    w["opt_args"].update(cfg["opt_args"], pool=POOL)
    return w


@pytest.fixture(scope="module")
def cell_world(tmp_path_factory):
    """The world at pool 16 and its first pass's fallback bits."""
    w = program_world(str(tmp_path_factory.mktemp("host_redo")))
    _, _, pr = qp.run_single(w, per_read=True)
    fb = pr["fallback"].numpy()
    assert (fb != 0).sum() > PAIRS // 2, "pool 16 forced few fallbacks"
    assert (fb == FB_POOL).sum() > PAIRS // 2, "few pool overflows to retry"
    return w, fb


def object_fill(w, engine, fb, lo, B):
    """The route through Read objects (the reference): copies of the
    block's fallback rows' reads, the engine's align_batch and
    pack_host_hits."""
    rows_idx = np.nonzero(fb)[0]
    rows_idx = rows_idx[lo + rows_idx < B]
    rs = [copy.copy(w["reads"][lo + b]) for b in rows_idx]
    if rs:
        engine.align_batch(rs, w["opt"])
    return pack_host_hits(rs, rows_idx, len(fb)), rs


@pytest.fixture
def retried():
    """host_redo.card_retry wrapped: each call's rows and done mask."""
    calls = []
    real = host_redo.card_retry

    def rec(world, rows, max_gapo):
        out = real(world, rows, max_gapo)
        calls.append((np.array(rows), out[0].copy()))
        return out

    with mock.patch.object(host_redo, "card_retry", rec):
        yield calls


def _shortened(w, fb):
    """The world with its fallback rows' reads cut to 12-25 bases (the
    longest 25), so that L and max_gapo follow the longest, and short
    reads hold several hits."""
    rs = list(w["reads"])
    for i, b in enumerate(np.nonzero(fb)[0]):
        p = copy.copy(rs[b])
        p.len = min(p.len, (12, 16, 20, 25)[i % 4])
        rs[b] = p
    opt = copy.copy(w["opt"])
    opt.max_gapo = 3  # above bwa_cal_maxdiff(25) = 2: the longest decides
    return dict(w, reads=rs, opt=opt)


def _filtered(w, fb):
    rs = list(w["reads"])
    for b in np.nonzero(fb)[0][::3]:
        rs[b] = copy.copy(rs[b])
        rs[b].filtered = True
    return dict(w, reads=rs)


def _control(w, fb):
    opt = copy.copy(w["opt"])
    opt.fnr, opt.max_diff = -1.0, 1
    return dict(w, opt=opt)


def _stepcap(w, fb):
    """The retry's step cap (the first pass's) low enough to stop some of
    the rows it takes."""
    return dict(w, opt_args=dict(w["opt_args"], step_cap=STEPCAP_LOW))


STEPCAP_LOW = 240  # about the median steps of a retried row here


CASES = {
    # name: (the world changed, rank block (lo, nb) or None, OUT_CAP)
    "default": (None, None, None),
    "control": (_control, None, None),
    "mixed_lengths": (_shortened, None, None),
    "filtered": (_filtered, None, None),
    # the last of three ranks over 200 rows padded to 204: rows 136-203
    "rank_block": (None, (136, 68), None),
    "oracle": (_shortened, None, 2),
    "stepcap": (_stepcap, None, None),
}


def _case(cell_world, case):
    """(world, fallback bits of the block, lo, B, engine) of a CASES entry;
    padding rows carry pool bits, and hold no read."""
    w0, fb0 = cell_world
    change, block, cap = CASES[case]
    w = dict(w0) if change is None else change(w0, fb0 != 0)
    B = len(w["reads"])
    lo, nb = block or (0, B)
    fb = np.zeros(nb, np.int32)
    fb[: min(nb, B - lo)] = fb0[lo: lo + nb]
    fb[B - lo:] = FB_POOL
    engine = NativeEngine(w["idx"])
    if cap is not None:
        engine.OUT_CAP = cap
        # the step cap's bit: every fallback row goes to the engine, whose
        # oracle then takes those with more hits than OUT_CAP
        fb[fb != 0] = FB_STEPCAP
    return w, fb, lo, B, engine


@pytest.mark.parametrize("case", sorted(CASES))
def test_fill_equals_object_route(cell_world, retried, case):
    w, fb, lo, B, engine = _case(cell_world, case)
    (got_n, got_rows), counts = host_redo.fill(w, engine, fb, lo, B, "cpu")
    (want_n, want_rows), rs = object_fill(w, engine, fb, lo, B)
    assert got_n.dtype == got_rows.dtype == torch.int32
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    assert (want_n > 0).sum() > 10, "few rows with hits: vacuous"
    kept = [p for p in rs if not p.filtered]
    (rows, done), = retried
    assert counts["card_retry_done"] + counts["redo_rows"] == len(kept)
    assert (counts["card_retry_done"] > 0) == (case != "oracle")
    if case == "filtered":
        assert 0 < len(kept) < len(rs)
    if case == "rank_block":
        assert (want_n[B - lo:] == -1).all() and len(rs) < (fb != 0).sum()
    if case == "mixed_lengths":
        assert max(p.len for p in kept) == 25
    # the engine's rows: those the retry did not finish; the oracle takes
    # the ones whose hits overflow OUT_CAP
    fin = set(rows[done].tolist())
    engine_rows = [p for p, b in zip(rs, np.nonzero(fb)[0])
                   if not p.filtered and lo + b not in fin]
    assert counts["redo_rows"] == len(engine_rows)
    over = sum(len(p.aln) > engine.OUT_CAP for p in engine_rows)
    assert counts["redo_oracle_rows"] == over
    assert (over > 0) == (case == "oracle")
    if case == "stepcap":  # the retry stopped some rows: both routes ran
        assert counts["card_retry_done"] < counts["card_retry_rows"]
        assert counts["redo_rows"] > 0


def test_retry_takes_pool_overflows_only(cell_world, retried):
    """Rows whose first-pass bits hold the score, hit-count or step-cap
    cause, alone or beside the pool's, go straight to the engine; the fill
    stays the object route's."""
    w, fb, lo, B, engine = _case(cell_world, "stepcap")
    pool = np.nonzero(fb == FB_POOL)[0]
    others = (FB_SCORE, FB_AMAX, FB_STEPCAP, FB_POOL | FB_STEPCAP)
    moved = pool[: 4 * len(others)]
    fb[moved] = np.resize(others, len(moved))
    (got_n, got_rows), counts = host_redo.fill(w, engine, fb, lo, B, "cpu")
    (want_n, want_rows), _ = object_fill(w, engine, fb, lo, B)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    (rows, _), = retried
    assert not set(rows.tolist()) & set(moved.tolist())
    assert counts["card_retry_rows"] == len(pool) - len(moved) > 0
    assert counts["redo_rows"] >= len(moved)


@pytest.mark.parametrize("case", ["rank_block", "stepcap"])
def test_retry_counts(cell_world, retried, case):
    """card_retry_rows: the block's real, unfiltered rows whose bits are the
    pool's alone; card_retry_done + redo_rows: its real, unfiltered
    fallback rows; the launches: one a level the retry reached."""
    w, fb, lo, B, engine = _case(cell_world, case)
    _, counts = host_redo.fill(w, engine, fb, lo, B, "cpu")
    unfilt = np.zeros(len(fb), bool)  # real rows the filter kept
    unfilt[: B - lo] = ~host_redo.host_rows(w)["filtered"][lo: lo + len(fb)]
    (rows, done), = retried
    assert counts["card_retry_rows"] == len(rows) == int(
        (unfilt & (fb == FB_POOL)).sum())
    assert counts["card_retry_done"] == int(done.sum())
    assert counts["card_retry_done"] + counts["redo_rows"] == int(
        (unfilt & (fb != 0)).sum())
    assert 1 <= counts["card_retry_launches"] <= 3


def test_native_run_equals_host_run(cell_world):
    """run_with_fill with a NativeEngine (the array route) equals it with a
    HostEngine (the object route): stats, rows, fallback count; the
    counters count the rows each engine redid and the rows the retry
    finished (here all of them)."""
    w, fb = cell_world
    w = dict(w)
    got = qp.run_with_fill(w, engine=NativeEngine(w["idx"]))
    c_nat = dict(qp.LAST_RUN_STATS["counts"])
    want = qp.run_with_fill(w, engine=HostEngine(w["idx"]))
    c_host = dict(qp.LAST_RUN_STATS["counts"])
    qp.same_run(got[:2], want[:2], "native against host engine")
    assert got[2] == want[2] == int((fb != 0).sum())
    n = int(sum(not w["reads"][b].filtered for b in np.nonzero(fb)[0]))
    for c in (c_nat, c_host):
        assert c["card_retry_done"] + c["redo_rows"] == n > 0
        assert c["card_retry_rows"] == int((fb == FB_POOL).sum())
    assert c_nat["card_retry_done"] == c_host["card_retry_done"] > 0
    assert c_nat["redo_oracle_rows"] == 0
    assert c_host["redo_oracle_rows"] == c_host["redo_rows"]
    assert int(got[0]["n_fallback"]) == 0


def test_native_run_equals_host_run_both_routes(cell_world):
    """As above at a step cap that stops some rows in the first pass and in
    the retry: the engine and the retry both fill rows of one call."""
    w, _ = cell_world
    w = dict(w, opt_args=dict(w["opt_args"], step_cap=STEPCAP_LOW))
    got = qp.run_with_fill(w, engine=NativeEngine(w["idx"]))
    c_nat = dict(qp.LAST_RUN_STATS["counts"])
    want = qp.run_with_fill(w, engine=HostEngine(w["idx"]))
    c_host = dict(qp.LAST_RUN_STATS["counts"])
    qp.same_run(got[:2], want[:2], "native against host engine")
    assert got[2] == want[2] == c_nat["first_pass_fallback"]
    for k in ("card_retry_rows", "card_retry_done", "redo_rows"):
        assert c_nat[k] == c_host[k], k
    assert c_nat["card_retry_done"] > 0 and c_nat["redo_rows"] > 0
    assert int(got[0]["n_fallback"]) == 0

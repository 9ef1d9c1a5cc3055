"""The one-program step's host redo as arrays (ops/host_redo.py) against
the route through Read objects: copies of the fallback rows' reads,
NativeEngine.align_batch and pack_host_hits.  The world is the
benchmark's, cut small (portbench/gen: 30 markers, 100 2 x 150 panel
pairs), its fallback rows those of a first pass at pool 16, plain PyTorch
on the CPU.

- host_redo.fill's (fb_n, fb_rows) bit-identical to the object route's on
  the same rows: default options, the control options (fnr -1, max_diff
  1), rows of mixed lengths, filtered rows among the fallbacks, a rank's
  block past the first row with padding rows, and an engine whose
  OUT_CAP sends rows on to its Python oracle;
- run_with_fill with a NativeEngine equal to run_with_fill with a
  HostEngine, and the redo's counters.
"""

import copy
import os

import numpy as np
import pytest
import torch

from fastquick_tpu_torch import qc_program as qp
from fastquick_tpu_torch.align.engine import HostEngine, NativeEngine
from fastquick_tpu_torch.ops import host_redo
from fastquick_tpu_torch.ops.qc_full import pack_host_hits
from portbench import run
from portbench.gen import reads, world

torch.set_num_threads(1)  # one intra-op thread per test worker

PAIRS = 100
POOL = 16


@pytest.fixture(scope="module")
def cell_world(tmp_path_factory):
    """The world at pool 16 and its first pass's fallback flags."""
    cfg = run.load_json(run.HERE, "configs", "fqdefault_program.json")
    cfg["world"].update(n_markers=30)
    cfg["index"].update(var_long=5, var_short=25)
    work = str(tmp_path_factory.mktemp("host_redo"))
    index = world.ensure_index(cfg, os.path.join(work, "index"))
    mix = run.load_json(run.HERE, "traffic", "panel.json")
    s = reads.sample(world.genome(cfg["world"]), cfg["index"], mix, PAIRS,
                     2**31 + 11)
    fq = (os.path.join(work, "r_1.fq.gz"), os.path.join(work, "r_2.fq.gz"))
    reads.write_fastq(s, *fq, mix["fastq_gzip_level"])
    w = qp.world_from_files(work, index, *fq, "r_1.fq", "r_2.fq",
                            device="cpu", L=cfg["padded_len"])
    w["opt_args"].update(cfg["opt_args"], pool=POOL)
    _, _, pr = qp.run_single(w, per_read=True)
    fb = pr["fallback"].numpy() != 0
    assert fb.sum() > PAIRS // 2, "pool 16 forced few fallbacks"
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


CASES = {
    # name: (the world changed, rank block (lo, nb) or None, OUT_CAP)
    "default": (None, None, None),
    "control": (_control, None, None),
    "mixed_lengths": (_shortened, None, None),
    "filtered": (_filtered, None, None),
    # the last of three ranks over 200 rows padded to 204: rows 136-203
    "rank_block": (None, (136, 68), None),
    "oracle": (_shortened, None, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fill_equals_object_route(cell_world, case):
    w0, fb0 = cell_world
    change, block, cap = CASES[case]
    w = dict(w0) if change is None else change(w0, fb0)
    B = len(w["reads"])
    lo, nb = block or (0, B)
    fb = np.zeros(nb, bool)
    fb[: min(nb, B - lo)] = fb0[lo: lo + nb]
    fb[B - lo:] = True  # padding rows flagged: they hold no read
    engine = NativeEngine(w["idx"])
    if cap is not None:
        engine.OUT_CAP = cap
    (got_n, got_rows), counts = host_redo.fill(w, engine, fb, lo, B, "cpu")
    (want_n, want_rows), rs = object_fill(w, engine, fb, lo, B)
    assert got_n.dtype == got_rows.dtype == torch.int32
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    assert (want_n > 0).sum() > 10, "few rows with hits: vacuous"
    kept = [p for p in rs if not p.filtered]
    assert counts["redo_rows"] == len(kept)
    if case == "filtered":
        assert 0 < len(kept) < len(rs)
    if case == "rank_block":
        assert (want_n[B - lo:] == -1).all() and len(rs) < fb.sum()
    if case == "mixed_lengths":
        assert max(p.len for p in kept) == 25
    # the oracle takes the rows whose hits overflow OUT_CAP
    over = sum(len(p.aln) > engine.OUT_CAP for p in kept)
    assert counts["redo_oracle_rows"] == over
    assert (over > 0) == (case == "oracle")


def test_native_run_equals_host_run(cell_world):
    """run_with_fill with a NativeEngine (the array route) equals it with a
    HostEngine (the object route): stats, rows, fallback count; the
    counters count the rows each engine redid."""
    w, fb = cell_world
    w = dict(w)
    got = qp.run_with_fill(w, engine=NativeEngine(w["idx"]))
    c_nat = dict(qp.LAST_RUN_STATS["counts"])
    want = qp.run_with_fill(w, engine=HostEngine(w["idx"]))
    c_host = dict(qp.LAST_RUN_STATS["counts"])
    qp.same_run(got[:2], want[:2], "native against host engine")
    assert got[2] == want[2] == int(fb.sum())
    n = int(sum(not w["reads"][b].filtered for b in np.nonzero(fb)[0]))
    assert c_nat["redo_rows"] == c_host["redo_rows"] == n > 0
    assert c_nat["redo_oracle_rows"] == 0
    assert c_host["redo_oracle_rows"] == n
    assert int(got[0]["n_fallback"]) == 0

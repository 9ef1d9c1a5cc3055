"""The metric arithmetic: the window's rate with the unit in flight, the
per-read stage times, the idle share's union of intervals, the frozen
bound and the accumulation's roofline share."""

import os
import time

import numpy as np
import torch  # noqa: F401  (imported before the timed set-up below)
import pytest

from portbench import bounds, run, trace
from portbench.run import HERE


def metric(name):
    return run.load_module(os.path.join(HERE, "metrics", name + ".py"))


def test_union_and_gaps():
    iv = np.array([[0, 10], [5, 20], [30, 40], [35, 36], [50, 60]], float)
    assert trace.union_s(iv) == pytest.approx(40e-6)
    g = trace.gaps(iv, -5, 70)
    assert g.tolist() == [[-5, 0], [20, 30], [40, 50], [60, 70]]
    assert trace.union_s(np.zeros((0, 2))) == 0.0


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation",
           "name": "portbench.program 0", "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 100,
           "dur": 300},
          {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 90,
           "dur": 400}]
    t = 0
    # two passes: memsets, walk, scan, fill, select; one kernel between
    for k in range(2):
        for name, d in (("Memset (Device)", 5), ("Memset (Device)", 5),
                        ("void fq_accum_walk_kernel<true, true>", 50),
                        ("Memset (Device)", 2), ("fq_accum_scan_kernel", 3),
                        ("fq_accum_fill_kernel", 4),
                        ("fq_accum_select_kernel", 6), ("other", 10)):
            ev.append({"ph": "X", "cat": "gpu_memset" if "Memset" in name
                       else "kernel", "name": name, "ts": 500 + t,
                       "dur": d})
            t += d + (k + 1)
    # one kernel outside the window
    ev.append({"ph": "X", "cat": "kernel", "name": "late", "ts": 5000,
               "dur": 10})
    return ev


def test_summary_window_busy_and_gaps():
    s = trace.Summary(_events())
    assert s.window_s == pytest.approx(1e-3)
    busy = 2 * (5 + 5 + 50 + 2 + 3 + 4 + 6 + 10)
    assert s.busy_s == pytest.approx(busy * 1e-6)
    idle = metric("device_idle_share.program").read({"trace": s})
    assert idle == pytest.approx(1 - busy / 1000)
    top = s.top_gaps(2)
    assert top[0][0] == "program 0 / aten::copy_" or top[0][1] > 0.0004
    assert top[0][1] == pytest.approx(500e-6)
    ops = dict(s.top_ops(10))
    assert ops["void fq_accum_walk_kernel<true, true>"] == \
        pytest.approx(100e-6)
    assert "late" not in ops


def test_accumulate_roofline_times_second_passes():
    s = trace.Summary(_events())
    m = metric("accumulate_roofline")
    assert m._groups(s) == pytest.approx([75e-6, 75e-6])
    w = dict(B=200000, n_cover=10 ** 7, n_reg=8 * 10 ** 6,
             n_entry_reads=20000, S=4550000, M=10000, cap=64)
    b, by = bounds.walk_bound(**w)
    assert by == "bytes"
    assert m.read({"trace": s, "work": w}) == pytest.approx(100 * b / 75e-6)
    assert m.read({"trace": None, "work": w}) is None


def test_frozen_bound_equals_the_ports():
    from fastquick_tpu_torch.utils import bounds as port

    args = (200000, 12_830_000, 9_880_000, 23178, 4_550_000, 10000, 64, 4,
            25)
    ms, by = port.walk_bound(*args)
    s, by2 = bounds.walk_bound(*args)
    assert (s * 1e3, by2) == (pytest.approx(ms), by)


def test_stage_and_share_readers():
    r = {"stage_t": {"io+filter": 2.0, "search": 1.0, "pe": 0.5,
                     "mate-sw": 0.25, "stats+out": 4.0},
         "reads": 1_000_000, "searched": 800, "fallback": 8}
    ctx = {"readings": r}
    for name, want in (("io_filter", 2.0), ("search", 1.0), ("pe", 0.5),
                       ("mate_sw", 0.25), ("stats_out", 4.0)):
        assert metric(f"{name}_us_per_read.align").read(ctx) == \
            pytest.approx(want)
    assert metric("redo_share.align").read(ctx) == pytest.approx(0.01)
    assert metric("redo_share.align").read({"readings": {}}) is None
    p = {"times": {"first_pass": 1.0, "host_redo": 6.0, "search": 0.2,
                   "pairing": 0.1}, "wall": 8.0, "calls": 4,
         "first_fallback": 30, "rows_searched": 300}
    ctx = {"readings": p}
    assert metric("host_redo_share.program").read(ctx) == 0.75
    assert metric("fill_pass_ms.program").read(ctx) == pytest.approx(75.0)
    assert metric("first_pass_fallback_share.program").read(ctx) == 0.1


class _Slow:
    """A driver whose unit of work takes `dt` seconds."""
    dt = 0.2

    def __init__(self, *a, **k):
        self.readings = {}

    def setup(self):
        time.sleep(0.3)

    def step(self, i):
        time.sleep(self.dt)
        return 1000

    def free(self):
        pass

    def judge(self, limits):
        return {k: 0 for k in limits}, 0


def test_window_counts_the_unit_in_flight(monkeypatch):
    real = run.load_module

    def load(path):
        if "drivers" in path:
            return type("M", (), {"Driver": _Slow})
        return real(path)

    monkeypatch.setattr(run, "load_module", load)
    c = run.cell(run.load_json(run.ROOT, "BENCHMARK.json"), "align.panel")
    res = run.run_cell(c, 1, 0.5, False, device="cpu",
                       t0=time.time() - 1.0)
    n = res["attempted"]
    assert n == 3                   # 0.0, 0.2, 0.4: the third in flight
    rate = res["metrics"]["align_reads_per_s"]["value"]
    assert rate == pytest.approx(n * 1000 / (n * _Slow.dt), rel=0.15)
    assert res["metrics"]["setup_s"]["value"] == pytest.approx(1.3, abs=0.2)
    assert res["correct"] and list(res)[-1] == "checks"

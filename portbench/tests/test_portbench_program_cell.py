"""The one-program cell, program.panel: its tiny run judged correct, its
frozen bounds, and the two rooflines that read the fill pass's search and
pairing launches against the last call's counts."""

import os

import pytest

from portbench import bounds_program, program_passes, run, trace
from portbench.run import HERE

from .cases import tiny_program_cell


def metric(name):
    return run.load_module(os.path.join(HERE, "metrics", name + ".py"))


def test_cell_in_the_benchmark():
    c = run.cell(run.load_json(run.ROOT, "BENCHMARK.json"), "program.panel")
    assert c["cfg"]["name"] == "fqdefault_program"
    assert {m["name"] for m in c["e2e"]} == {"align_reads_per_s", "setup_s"}
    assert {m["name"] for m in c["per_layer"]} == {
        "first_pass_fallback_share.program", "host_redo_share.program",
        "fill_pass_ms.program", "device_idle_share.program",
        "accumulate_roofline", "search_roofline.program",
        "pairing_roofline.program"}


def test_tiny_program_cell_is_judged_correct(tmp_path):
    c = tiny_program_cell()
    mod = run.load_module(os.path.join(HERE, "drivers", "program.py"))
    d = mod.Driver(c["cfg"], c["mix"], 2**31 + 3, str(tmp_path), "cpu",
                   os.path.join(HERE, ".cache"), trace=True)
    d.setup()
    d.step(0)
    counts = program_passes.program_counts()
    assert counts["fill_pass"]["search"]["rows"] == \
        d.readings["rows_searched"]
    d.free()
    got, failed = d.judge(c["cfg"]["limits"])
    assert got["dense_off"] == 0 and got["pileup_off"] == 0, got
    assert got["misplaced_share"] == 0 and got["isize_off_share"] == 0
    assert failed == 0


def test_frozen_bounds_equal_the_ports():
    from fastquick_tpu_torch.ops.search_kernels import SearchParams
    from fastquick_tpu_torch.utils import bounds as port

    import torch

    P = SearchParams(L=160, SL=32, NP=256, step_cap=10240, s_mm=3,
                     s_gapo=11, s_gape=4, max_gapo=1, max_gape=6,
                     indel_end_skip=5, max_del_occ=10, max_entries=2000000,
                     max_top2=30, max_seed_diff=2, CH=4)
    n_aln = torch.tensor([0, 3, 60, 1])
    ms, by = port.search_bound(P, 200_000, 6_500_000, n_aln, 9_000_000, 4)
    s, by2 = bounds_program.search_bound(160, 32, 200_000, 6_500_000, 52,
                                         9_000_000)
    assert (s * 1e3, by2) == (pytest.approx(ms), by)
    args = (100_000, 1_002_925, 500_000, 379_653, 2.77e6, 1001)
    ms, by = port.pairing_bound(*args)
    s, by2 = bounds_program.pairing_bound(*args)
    assert (s * 1e3, by2) == (pytest.approx(ms), by)


SEARCH = dict(rows=190_000, launches=1, busy_steps=9_000_000, hit_rows=500,
              L=160, seed_len=32, table_bytes=6_500_000)
SWEEP = dict(pairs=100_000, valid=1_000_000, reverse=500_000, words=380_000,
             compares=2.77e6, penalty_len=1001)
SWEEP2 = dict(SWEEP, pairs=64, valid=20_000, reverse=10_000, words=900)


def _stats(fill_sweeps):
    return {"stage_t": {}, "counts": {
        "rows_searched": 190_000, "first_pass_fallback": 1000,
        "first_pass": {"search": SEARCH, "pairing": [SWEEP]},
        "fill_pass": {"search": SEARCH, "pairing": fill_sweeps}}}


def _window(calls, fill_sweeps):
    """A traced window of `calls` calls: each a first-pass search (200 us)
    and pairing launch (100 us), then the fill pass's search (300 us) and
    pairing launches (150 us each), among other kernels."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 0, "dur": 100_000}]
    t = 10

    def k(name, d):
        nonlocal t
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                   "dur": d})
        t += d + 5

    for _ in range(calls):
        k("fq_width_kernel", 20)
        k("fq_search_chain_kernel(FmView, SearchParams)", 200)
        k("void fq_pairing_warp_kernel(FqPairIn)", 100)
        k("fq_accum_walk_kernel", 30)
        k("fq_search_chain_kernel(FmView, SearchParams)", 300)
        k("void fq_pairing_warp_kernel(FqPairIn)", 150)
        for _ in fill_sweeps[1:]:
            k("fq_pairing_block_kernel(FqPairIn)", 150)
    return trace.Summary(ev)


def test_rooflines_read_the_fill_pass(monkeypatch):
    from fastquick_tpu_torch import qc_program as qp

    for sweeps in ([SWEEP], [SWEEP, SWEEP2]):
        monkeypatch.setattr(qp, "LAST_RUN_STATS", _stats(sweeps))
        ctx = {"trace": _window(3, sweeps)}
        b, _ = bounds_program.search_bound(160, 32, 190_000, 6_500_000, 500,
                                           9_000_000)
        assert metric("search_roofline.program").read(ctx) == \
            pytest.approx(100 * b / 300e-6)
        b = sum(bounds_program.pairing_bound(*s.values())[0]
                for s in sweeps)
        assert metric("pairing_roofline.program").read(ctx) == \
            pytest.approx(100 * b / (150e-6 * len(sweeps)))


def test_rooflines_read_nothing_without_counts(monkeypatch):
    from fastquick_tpu_torch import qc_program as qp

    ctx = {"trace": _window(2, [SWEEP])}
    names = ("search_roofline.program", "pairing_roofline.program")
    # a program that publishes no counts, as the parent's
    monkeypatch.delattr(qp, "LAST_RUN_STATS")
    assert [metric(n).read(ctx) for n in names] == [None, None]
    # an untimed call: no pass's work
    monkeypatch.setattr(qp, "LAST_RUN_STATS", {"counts": {
        "rows_searched": 5, "first_pass_fallback": 1}}, raising=False)
    assert [metric(n).read(ctx) for n in names] == [None, None]
    # launches that are not whole calls, and no trace
    monkeypatch.setattr(qp, "LAST_RUN_STATS", _stats([SWEEP, SWEEP2]))
    assert [metric(n).read(ctx) for n in names][1] is None
    assert [metric(n).read({"trace": None}) for n in names] == [None, None]

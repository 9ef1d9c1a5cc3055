"""The readers of the align call's spans (fastquick_tpu_torch/utils/
spans.py): each its value on a synthetic window, and nothing where its
span is missing, as on a program that has no such span."""

import os

import pytest

from portbench import run
from portbench.run import HERE

SPAN_READERS = {
    "call_setup_us_per_read.align": "call.setup",
    "call_finish_us_per_read.align": "call.finish",
    "refine_us_per_read.align": "refine",
    "kmer_upload_us_per_read.align": "kmer.upload",
    "search_redo_wait_us_per_read.align": "search.redo_wait",
    "stats_wait_us_per_read.align": "wait.stats",
}
STAGE_T = {"call": 20.0, "call.setup": 2.5, "call.finish": 1.5,
           "refine": 0.75, "io+filter": 3.0, "kmer.upload": 1.0,
           "search": 1.0, "search.redo_wait": 0.25, "mate-sw": 2.0,
           "sw.device": 0.5, "wait.stats": 5.0}


def metric(name):
    return run.load_module(os.path.join(HERE, "metrics", name + ".py"))


def ctx(stage_t, reads=1_000_000):
    return {"readings": {"stage_t": stage_t, "reads": reads}}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader(name):
    m = metric(name)
    span = SPAN_READERS[name]
    assert m.read(ctx(STAGE_T)) == pytest.approx(STAGE_T[span])
    rest = {k: v for k, v in STAGE_T.items() if k != span}
    assert m.read(ctx(rest)) is None
    assert m.read(ctx(STAGE_T, reads=0)) is None


def test_mate_sw_host_reader_is_the_self_time():
    m = metric("mate_sw_host_us_per_read.align")
    assert m.read(ctx(STAGE_T)) == pytest.approx(1.5)
    for gone in ("mate-sw", "sw.device"):
        rest = {k: v for k, v in STAGE_T.items() if k != gone}
        assert m.read(ctx(rest)) is None


def test_span_readers_on_a_parent_window():
    # the stages the program timed before it had spans
    parent = {"io+filter": 2.0, "search": 1.0, "pe": 0.5, "mate-sw": 0.25,
              "refine": 0.1, "stats-enq": 0.01, "stats+out": 4.0}
    for name in (*SPAN_READERS, "mate_sw_host_us_per_read.align"):
        if name != "refine_us_per_read.align":
            assert metric(name).read(ctx(parent)) is None, name


def test_every_span_reader_is_in_the_benchmark():
    spec = run.load_json(run.ROOT, "BENCHMARK.json")
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in (*SPAN_READERS, "mate_sw_host_us_per_read.align"):
        m = per_layer[name]
        assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
            "us/read", "program_span", "align_reads_per_s", ["align.panel"])

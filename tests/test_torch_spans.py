"""utils/spans.py: one align call's tally of named host spans, and the
profiler ranges the spans open while a torch.profiler session records."""

import json
import sys
import threading
import time

import torch

from fastquick_tpu_torch.utils import spans


def test_nested_spans_add_up_and_a_child_counts_in_its_parent():
    with spans.call() as tally:
        with spans.span("outer"):
            with spans.span("inner"):
                time.sleep(0.02)
            with spans.span("inner"):
                time.sleep(0.01)
            time.sleep(0.01)
    got = tally.seconds()
    assert set(got) == {"call", "outer", "inner"}
    assert got["inner"] >= 0.03
    assert got["outer"] >= got["inner"] + 0.01
    assert got["call"] >= got["outer"]


def test_a_span_outside_a_call_adds_to_no_tally():
    with spans.span("loose"):
        pass
    with spans.call() as tally:
        pass
    with spans.span("after"):
        pass
    assert set(tally.seconds()) == {"call"}


def test_a_call_inside_a_call_has_its_own_tally():
    with spans.call() as outer:
        with spans.call("program") as inner:
            with spans.span("program.fill_pass"):
                pass
        with spans.span("after"):
            pass
    assert set(inner.seconds()) == {"program", "program.fill_pass"}
    assert set(outer.seconds()) == {"call", "after"}


def test_threads_the_call_starts_add_into_its_tally():
    with spans.call() as tally:
        def work():
            with spans.span("worker"):
                time.sleep(0.01)

        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    assert tally.seconds()["worker"] >= 0.01


def test_tally_add_loses_no_update_across_threads():
    tally = spans.Tally()
    n_threads, n_adds = 8, 1000
    barrier = threading.Barrier(n_threads)

    def adder():
        barrier.wait()
        for _ in range(n_adds):
            tally.add("x", 0.25)
            tally.add("y", 1.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=adder) for _ in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    # quarters and ones add exactly in floating point
    assert tally.seconds() == {"x": 0.25 * n_threads * n_adds,
                               "y": 1.0 * n_threads * n_adds}


def test_no_profiler_range_without_a_recording_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with spans.call():
        with spans.span("quiet"):
            pass
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("loud"):
            pass
    assert opened == ["fq.loud"]


def _traced_spans(tmp_path, **profile_kw) -> list:
    """Spans opened on the main thread and on a second one under a CPU
    profiler: the exported trace's fq. user annotations."""
    def work():
        with spans.span("second"):
            time.sleep(0.005)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            **profile_kw) as prof:
        with spans.span("main"):
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    return [(e["name"], e["tid"]) for e in ev
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(spans.PREFIX)]


def test_main_thread_span_in_the_chrome_trace(tmp_path):
    names = [n for n, _ in _traced_spans(tmp_path)]
    assert "fq.main" in names


def test_every_threads_span_in_the_chrome_trace(tmp_path):
    from torch._C._profiler import _ExperimentalConfig

    all_threads = _ExperimentalConfig(profile_all_threads=True)
    got = dict(_traced_spans(tmp_path, experimental_config=all_threads))
    assert set(got) == {"fq.main", "fq.second"}
    assert got["fq.main"] != got["fq.second"]

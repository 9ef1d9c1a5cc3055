"""Named host spans of one call of the port, on the profiler's clock: an
``align`` call, or a call of the one-program step's recipe
(``qc_program.run_with_fill``).

``with span(name):`` adds the span's wall time (two ``time.perf_counter``
reads) into the tally of the call in progress, under the tally's lock, from
whichever thread the work runs on: the main thread, the prefetch and stats
threads the call starts, the BAM writer.  A span opened outside any call
(bench.py, a step run alone) adds to no tally.  Spans nest, and a child's
time also counts in its parent.

While a ``torch.profiler`` session records, each span also opens
``record_function("fq." + name)`` on its own thread, so the spans land in
the exported Chrome trace on the clock of the device's kernel, memcpy and
memset intervals.  The profiler records the spans of the thread that
started it, and those of every thread when started with
``_ExperimentalConfig(profile_all_threads=True)``.

No span belongs inside a loop over reads, pairs or jobs: a span costs a few
microseconds, and a call opens a few dozen.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext

import torch

PREFIX = "fq."


class Tally:
    """Seconds by span name, added to from several threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._seconds[name] = self._seconds.get(name, 0.0) + seconds

    def seconds(self) -> dict[str, float]:
        with self._lock:
            return dict(self._seconds)


# the tally of the call in progress (one runs at a time in a process)
_current: Tally | None = None


@contextmanager
def span(name: str):
    tally = _current
    # the profiler's own flag, true on every thread while a session records
    with (torch.profiler.record_function(PREFIX + name)
          if torch.autograd.profiler._is_profiler_enabled else nullcontext()):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if tally is not None:
                tally.add(name, time.perf_counter() - t0)


@contextmanager
def call(name: str = "call"):
    """One call (align's ``call``, the one-program recipe's ``program``): a
    fresh tally that its spans add into, yielded, under the call's own span
    `name`."""
    global _current
    outer, tally = _current, Tally()
    _current = tally
    try:
        with span(name):
            yield tally
    finally:
        _current = outer

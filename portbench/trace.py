"""The traced window: ``torch.profiler`` over CPU and CUDA, its Chrome
trace read back into device intervals, the harness's own spans and the
host's operations.

``busy_s`` is the union of kernel, memcpy and memset intervals inside the
window; the idle gaps are the spaces between them, each named by the
harness's span (``record_function``) and the innermost host operation
running at the gap's middle.
"""

from __future__ import annotations

import json
import os

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


class Trace:
    def __init__(self, path: str):
        self.path = path
        self.prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return torch.profiler.record_function

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def read(self) -> "Summary":
        with open(self.path) as fh:
            ev = json.load(fh)
        ev = ev["traceEvents"] if isinstance(ev, dict) else ev
        os.remove(self.path)
        return Summary(ev)


def union_s(iv: np.ndarray) -> float:
    """Seconds covered by the union of [start, end) intervals in us."""
    if len(iv) == 0:
        return 0.0
    iv = iv[np.argsort(iv[:, 0])]
    end = np.maximum.accumulate(iv[:, 1])
    start = iv[:, 0]
    # a new run starts where an interval begins after every earlier end
    new = np.concatenate([[True], start[1:] > end[:-1]])
    run_id = np.cumsum(new) - 1
    s = start[new]
    e = np.zeros(len(s))
    np.maximum.at(e, run_id, end)
    return float((e - s).sum()) / 1e6


def gaps(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The idle [start, end) gaps (us) between the intervals in [lo, hi]."""
    if len(iv) == 0:
        return np.array([[lo, hi]])
    iv = iv[np.argsort(iv[:, 0])]
    end = np.maximum.accumulate(iv[:, 1])
    starts = np.concatenate([iv[:, 0], [hi]])
    ends = np.concatenate([[lo], end])
    g = np.stack([ends, starts], 1)
    return g[g[:, 1] > g[:, 0]]


class Summary:
    def __init__(self, events: list):
        dev, names, spans, ops = [], [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            t0, d = float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                dev.append((t0, t0 + d))
                names.append(e.get("name", cat))
            elif cat == "user_annotation" and \
                    e.get("name", "").startswith(SPAN_PREFIX):
                spans.append((t0, t0 + d, e["name"][len(SPAN_PREFIX):]))
            elif cat == "cpu_op":
                ops.append((t0, t0 + d, e.get("name", "?")))
        self.dev = np.asarray(dev, float).reshape(-1, 2)
        self.names = names
        self.spans = spans
        self.ops = sorted(ops)
        window = [s for s in spans if s[2] == "window"]
        if window:
            self.lo, self.hi = window[0][0], window[0][1]
        elif spans:
            self.lo = min(s[0] for s in spans)
            self.hi = max(s[1] for s in spans)
        else:
            self.lo, self.hi = 0.0, 0.0
        inside = (self.dev[:, 1] > self.lo) & (self.dev[:, 0] < self.hi)
        self.dev_in = np.clip(self.dev[inside], self.lo, self.hi)
        self.names_in = [n for n, k in zip(names, inside) if k]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_s(self.dev_in)

    def top_ops(self, k: int = 10) -> list:
        tot: dict = {}
        for (a, b), n in zip(self.dev_in, self.names_in):
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def _at(self, t: float) -> str:
        span = [s for s in self.spans if s[0] <= t < s[1] and
                s[2] != "window"]
        name = min(span, key=lambda s: s[1] - s[0])[2] if span else "window"
        op = [o for o in self.ops if o[0] <= t < o[1]]
        if op:
            name += " / " + min(op, key=lambda o: o[1] - o[0])[2]
        return name

    def top_gaps(self, k: int = 10) -> list:
        g = gaps(self.dev_in, self.lo, self.hi)
        order = np.argsort(g[:, 0] - g[:, 1])[:k]
        return [[self._at((g[i, 0] + g[i, 1]) / 2),
                 float(g[i, 1] - g[i, 0]) / 1e6] for i in order]

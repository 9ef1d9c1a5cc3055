"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload align.panel --seed 7 \\
        --seconds 45 --trace 0

From the root of a checkout.  BENCHMARK.json names the cell; the cell
names a configuration (``portbench/configs/<name>.json``, whose "driver"
names ``portbench/drivers/<driver>.py``) and a traffic mix
(``portbench/traffic/<name>.json``); each metric is read by
``portbench/metrics/<name>.py``.  A run sets up and warms up, measures
for ``--seconds`` (the unit of work in flight at the deadline runs to its
end and counts), then, with the port's state freed, judges what the
window produced against the plain reference (``portbench/reference``)
and prints one JSON line last on standard output.  ``--trace 1`` runs the
window under torch.profiler and prints the per-layer metrics instead of
the end-to-end ones.

Caches stay in the checkout: the index in ``portbench/.cache/``, the
port's kernels in its own ``build/``.  Samples and outputs go to a
directory under $TMPDIR that the run removes.  A run without as many CUDA
cards as the cell asks for exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "fastquick_tpu")


def process_start() -> float:
    """This process's start on the wall clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(ln.split()[1]) for ln in fh
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(path: str):
    """The module at `path` (a file of drivers/ or metrics/, whose name may
    hold dots), as a member of its folder's package."""
    pkg = "portbench." + os.path.basename(os.path.dirname(path))
    name = pkg + "." + os.path.basename(path)[:-3].replace(".", "__")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(spec: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix and metrics, found by name."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    cfg = load_json(ROOT, cfg_entry["file"])
    mix = load_json(HERE, "traffic", wl["traffic"] + ".json")

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]

    return dict(wl=wl, cfg=cfg, mix=mix, e2e=mine(spec["end_to_end"]),
                per_layer=mine(spec["per_layer"]))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             control: bool = False, work_root: str | None = None) -> dict:
    """One run of cell `c` (see cell()); returns the result object."""
    import torch

    t0 = process_start() if t0 is None else t0
    cfg, mix, wl = c["cfg"], c["mix"], c["wl"]
    drv_mod = load_module(os.path.join(HERE, "drivers",
                                       cfg["driver"] + ".py"))
    work = tempfile.mkdtemp(prefix="portbench-", dir=work_root)
    cache = os.path.join(HERE, ".cache")
    os.makedirs(cache, exist_ok=True)
    cuda = device != "cpu"
    try:
        drv = drv_mod.Driver(cfg, mix, seed, work, device, cache,
                             control=control, trace=trace)
        drv.setup()
        if cuda:
            torch.cuda.synchronize()
        tr = None
        span = contextlib.nullcontext
        if trace:
            from .trace import Trace

            tr = Trace(os.path.join(work, "trace.json"))
            span = tr.start()
        t_start = time.time()
        setup_s = t_start - t0
        deadline = time.perf_counter() + seconds
        w0 = time.perf_counter()
        units = steps = 0
        with span("portbench.window"):
            while steps == 0 or time.perf_counter() < deadline:
                with span(f"portbench.{cfg['driver']} {steps}"):
                    units += drv.step(steps)
                steps += 1
            if cuda:
                torch.cuda.synchronize()
        span_s = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated(0) if cuda else 0
        summary = None
        if tr is not None:
            tr.stop()
            summary = tr.read()
        drv.free()
        limits = cfg["limits"]
        numbers, failed = drv.judge(limits)
        ctx = dict(workload=wl["name"], readings=drv.readings,
                   trace=summary, setup_s=setup_s, span_s=span_s,
                   units=units, work=getattr(drv, "work_counts", None))
        metrics = {}
        for m in (c["per_layer"] if trace else c["e2e"]):
            v = load_module(os.path.join(HERE, "metrics",
                                         m["name"] + ".py")).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        checks = {k: {"value": numbers[k], "limit": lim}
                  for k, lim in limits.items()}
        correct = all(numbers[k] <= lim for k, lim in limits.items())
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": wl["chips"] if cuda else 1,
               "memory_peak_bytes": int(peak)}
        if cuda:
            dev["power_limit"] = power_limit()
        res = {"correct": correct, "attempted": steps, "failed": failed,
               "metrics": metrics, "device": dev}
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
            res["breakdown"] = {"device_ops": summary.top_ops(10),
                                "idle_gaps": summary.top_gaps(10)}
        res["checks"] = checks
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    c = cell(load_json(ROOT, "BENCHMARK.json"), a.workload)

    import torch

    need = c["wl"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {need} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found; no result", file=sys.stderr)
        return 2
    res = run_cell(c, a.seed, a.seconds, bool(a.trace), t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for k, v in res["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time ``align --device_qc``'s dense-statistics flushes on the card.

    python3 tools/dense_flush_probe.py --port DIR --work DIR [--tag NAME]

Imports fastquick_tpu_torch from the checkout DIR (so that two trees can
be measured in one process each, on one card, in one call), builds the
production world of tools/stress_production_scale.py (``--seed``,
``--pairs``) under --work (reused when a run before left it there), runs
the port's ``align --device_qc`` on it once and prints one JSON line: the
dense sites S, the DeviceDenseStats.flush calls, the host-clock seconds
inside them, the device-to-host copies they made and their bytes, the
align's wall time and its phases.  chip_smoke.py's production phase
counts its own run with ``timed_flush``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock


@contextlib.contextmanager
def timed_flush(device_qc, rec: dict):
    """Count into rec, inside the block: DeviceDenseStats.flush's calls
    ("flushes"), host-clock seconds ("flush_s"), the CUDA tensors it
    copied to the host ("copies") and their bytes ("bytes_to_host"), and
    the stats' dense sites ("S")."""
    import torch

    cls = device_qc.DeviceDenseStats
    flush, cpu = cls.flush, torch.Tensor.cpu
    rec.update(S=None, flushes=0, flush_s=0.0, copies=0, bytes_to_host=0)
    inside = [False]

    def counted_cpu(t, *a, **kw):
        if inside[0] and t.is_cuda:
            rec["copies"] += 1
            rec["bytes_to_host"] += t.numel() * t.element_size()
        return cpu(t, *a, **kw)

    def timed(self, collector):
        rec["S"] = int(self.S)
        inside[0] = True
        t0 = time.perf_counter()
        try:
            return flush(self, collector)
        finally:
            rec["flush_s"] += time.perf_counter() - t0
            rec["flushes"] += 1
            inside[0] = False

    with mock.patch.object(cls, "flush", timed), \
            mock.patch.object(torch.Tensor, "cpu", counted_cpu):
        yield rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", required=True,
                    help="checkout whose fastquick_tpu_torch is measured")
    ap.add_argument("--work", required=True, help="world and outputs")
    ap.add_argument("--tag", default="run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=100_000)
    args = ap.parse_args()
    port = Path(args.port).resolve()
    sys.path.insert(0, str(port))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe measures the card")
    from fastquick_tpu_torch.align import device_qc, driver
    from fastquick_tpu_torch.cli import main as cli
    from fastquick_tpu_torch.testing.synthworld import build_production_world

    if not Path(device_qc.__file__).resolve().is_relative_to(port):
        raise SystemExit(f"imported {device_qc.__file__}, not from {port}")
    work = Path(args.work)
    saved = work / "world.json"
    work.mkdir(parents=True, exist_ok=True)
    with open(work / f"{args.tag}.log", "w") as logf, \
            contextlib.redirect_stderr(logf):
        if saved.exists():
            w = json.loads(saved.read_text())
        else:
            w = build_production_world(work, seed=args.seed,
                                       n_pairs=args.pairs)
            w = {k: w[k] for k in ("fq1", "fq2", "idx_prefix")}
            saved.write_text(json.dumps(w))
        rec: dict = {}
        t0 = time.perf_counter()
        with timed_flush(device_qc, rec):
            rc = cli(["align", "--fastq_1", w["fq1"], "--fastq_2", w["fq2"],
                      "--index_prefix", w["idx_prefix"], "--out_prefix",
                      str(work / args.tag), "--device_qc"])
        wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"align exited {rc}")
    print(json.dumps(dict(
        tag=args.tag, port=str(port), wall_s=wall,
        stage_t=driver.LAST_RUN_STATS.get("stage_t"), **rec,
        card=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

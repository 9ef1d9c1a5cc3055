"""A window of the one-program step on a device-resident batch:
``qc_program.run_with_fill`` back to back at qc_full's defaults, the
fallback reads redone by the native engine.

Set-up builds or loads the index, draws one batch from the seed, loads it
with ``world_from_files`` (the k-mer bitmaps on the card) and runs the
recipe once as the warm-up.  After the window the last call's products
are written with ``write_product`` and judged.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from ..gen import reads, world
from ..reference import judge
from ..reference.sites import Sites

# the port's own lower-tolerance search: at most one difference a read
CONTROL_MAX_DIFF = 1


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, work: str,
                 device: str, cache: str, control: bool = False,
                 trace: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.work, self.device, self.cache = work, device, cache
        self.control = control
        self.trace = trace  # a traced run synchronises each stage
        self.last = None
        self.readings: dict = {"times": {}, "first_fallback": 0,
                               "rows_searched": 0, "calls": 0, "reads": 0,
                               "wall": 0.0}

    def setup(self) -> None:
        from fastquick_tpu_torch import qc_program as qp
        from fastquick_tpu_torch.align.engine import NativeEngine

        cfg = self.cfg
        self.index = world.ensure_index(cfg, self.cache)
        self.g = world.genome(cfg["world"])
        self.s = reads.sample(self.g, cfg["index"], self.mix,
                              cfg["batch_pairs"], self.seed)
        fq = (os.path.join(self.work, "r_1.fq.gz"),
              os.path.join(self.work, "r_2.fq.gz"))
        reads.write_fastq(self.s, *fq, self.mix["fastq_gzip_level"])
        with contextlib.redirect_stdout(sys.stderr):
            w = qp.world_from_files(self.work, self.index, *fq, "r_1.fq",
                                    "r_2.fq", device=self.device,
                                    L=cfg["padded_len"],
                                    bitmaps=cfg["bitmaps"])
        w["opt_args"].update(cfg["opt_args"])
        if self.control:
            w["opt"].fnr = -1.0
            w["opt"].max_diff = CONTROL_MAX_DIFF
            w["opt_args"]["max_diff"] = CONTROL_MAX_DIFF
            w["md_table"] = w["md_table"].clamp(max=CONTROL_MAX_DIFF)
        self.world = w
        self.engine = NativeEngine(w["idx"])
        self._call()
        self.readings.update(times={}, first_fallback=0, rows_searched=0,
                             calls=0, reads=0, wall=0.0)

    def _call(self):
        from fastquick_tpu_torch import qc_program as qp

        times = {} if self.trace else None
        with contextlib.redirect_stdout(sys.stderr):
            stats, rows, fb = qp.run_with_fill(
                self.world, engine=self.engine,
                pileup_cap=self.cfg["pileup_cap"], kernel=self.cfg["kernel"],
                times=times)
        r = self.readings
        r["first_fallback"] += fb
        r["calls"] += 1
        if times is not None:
            for k, v in times.items():
                r["times"][k] = r["times"].get(k, 0.0) + v
        self.last = (stats, rows)
        return stats

    def step(self, i: int) -> int:
        import time

        t0 = time.perf_counter()
        stats = self._call()
        r = self.readings
        r["rows_searched"] += int(stats["n_reads"]) - int(stats["n_filtered"])
        n = 2 * self.world["n_pairs"]
        if self.device != "cpu":
            torch.cuda.synchronize()
        r["wall"] += time.perf_counter() - t0
        r["reads"] += n
        return n

    def free(self) -> None:
        """Products of the last call written; the world's tensors freed."""
        from fastquick_tpu_torch import qc_program as qp

        stats, rows = self.last
        self.prefix = os.path.join(self.work, "prod")
        with contextlib.redirect_stdout(sys.stderr):
            qp.write_product(self.prefix, stats, rows, self.world["names"],
                             self.world)
        self.rows = {k: v for k, v in rows.items()}
        self.last = None
        self.world = None
        self.engine = None
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def judge(self, limits: dict) -> tuple[dict, int]:
        """The last call's numbers, and 1 if one broke its limit."""
        sites = Sites(self.g, self.cfg["index"])
        pl = judge.placements_from_rows(self.rows, sites,
                                        self.s["read_len"])
        d: dict = {}
        out = judge.judge(self.prefix, self.s, sites, pl,
                          cap=self.cfg["pileup_cap"], keep=d)
        # the accumulation's work, for its roofline
        elig = pl["eligible"]
        self.work_counts = dict(
            B=2 * self.s["n_pairs"],
            n_cover=int(np.minimum(pl["len"][elig],
                                   self.cfg["padded_len"]).sum()),
            n_reg=int(d["depth"].sum()), n_entry_reads=d["entry_reads"],
            S=sites.n_sites, M=len(sites.pos), cap=self.cfg["pileup_cap"])
        return out, int(any(out[n] > lim for n, lim in limits.items()))

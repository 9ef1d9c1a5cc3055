"""A window of ``align --device_qc`` calls, one a sample, as FASTQuick.sh
runs it: each call loads the index, uploads the k-mer bitmaps and sites,
aligns the sample's pairs and writes the 12 product files.

Set-up builds or loads the index, draws ``distinct_samples`` samples from
the seed (FASTQs under the work directory) and runs the first once as the
warm-up.  The window cycles through them; each call's outputs go to their
own prefix and are judged after the window.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

from ..gen import reads, world
from ..reference import judge
from ..reference.sites import Sites

# the port's own lower-tolerance search: at most one difference a read
# instead of the configuration's -n 0.02 (7 at 150 bp)
CONTROL_ARGS = ["--n", "1"]


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, work: str,
                 device: str, cache: str, control: bool = False,
                 trace: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.work, self.device, self.cache = work, device, cache
        self.control = control
        self.samples: list[dict] = []
        self.fastqs: list[tuple[str, str]] = []
        self.runs: list[tuple[int, str]] = []
        self.readings: dict = {"stage_t": {}, "searched": 0, "fallback": 0,
                               "reads": 0}

    def setup(self) -> None:
        cfg = self.cfg
        self.index = world.ensure_index(cfg, self.cache)
        self.g = world.genome(cfg["world"])
        ss = np.random.SeedSequence(self.seed)
        for k, child in enumerate(ss.spawn(cfg["distinct_samples"])):
            s = reads.sample(self.g, cfg["index"], self.mix,
                             cfg["sample_pairs"],
                             int(child.generate_state(1, np.uint64)[0]))
            fq = (os.path.join(self.work, f"s{k}_1.fq.gz"),
                  os.path.join(self.work, f"s{k}_2.fq.gz"))
            reads.write_fastq(s, *fq, self.mix["fastq_gzip_level"])
            self.samples.append(s)
            self.fastqs.append(fq)
        self._align(0, os.path.join(self.work, "warm"))

    def _align(self, k: int, out: str) -> dict:
        from fastquick_tpu_torch.align import driver
        from fastquick_tpu_torch.cli import main

        fq1, fq2 = self.fastqs[k]
        argv = ["align", "--fastq_1", fq1, "--fastq_2", fq2,
                "--index_prefix", self.index, "--out_prefix", out,
                *self.cfg["align_args"], "--device", self.device]
        if self.control:
            argv += CONTROL_ARGS
        with contextlib.redirect_stdout(sys.stderr):
            rc = main(argv)
        if rc != 0:
            raise RuntimeError(f"align exited {rc} on sample {k}")
        return dict(driver.LAST_RUN_STATS)

    def step(self, i: int) -> int:
        k = i % len(self.samples)
        out = os.path.join(self.work, f"run{i}")
        st = self._align(k, out)
        self.runs.append((k, out))
        r = self.readings
        for name, v in st.get("stage_t", {}).items():
            r["stage_t"][name] = r["stage_t"].get(name, 0.0) + v
        r["searched"] += st.get("searched", 0)
        r["fallback"] += st.get("fallback", 0)
        n = 2 * self.samples[k]["n_pairs"]
        r["reads"] += n
        return n

    def free(self) -> None:
        pass

    def judge(self, limits: dict) -> tuple[dict, int]:
        """The worst reading of each number over the window's samples, and
        the samples that broke a limit."""
        sites = Sites(self.g, self.cfg["index"])
        worst: dict = {}
        failed = 0
        for k, out in self.runs:
            s = self.samples[k]
            pl = judge.placements_from_bam(out + ".bam")
            got = judge.judge(out, s, sites, pl)
            failed += any(got[n] > lim for n, lim in limits.items())
            for name, v in got.items():
                pick = min if name == "certain_reads" else max
                worst[name] = pick(worst.get(name, v), v)
        return worst, failed

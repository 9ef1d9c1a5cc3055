"""Readings for the limits of ``correct``: the numbers that sound runs and
the control give, seed after seed, in one process.

    python3 -m portbench.control --workload align.panel \\
        --seeds 11,12,13 --seconds 1 [--control]

The control is the port with its own lower-tolerance search switched on
(the driver's ``control`` hook: at most one difference a read, where the
configuration states -n 0.02, 7 differences at 150 bp); it breaks the
configuration's guarantee that a read within the aligner's limits is
placed.  Each seed prints one JSON line: the seed, whether it was the
control, ``correct`` and each number beside its limit.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)
    c = run.cell(run.load_json(run.ROOT, "BENCHMARK.json"), a.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in a.seeds.split(",")):
        res = run.run_cell(c, seed, a.seconds, False, control=a.control)
        print(json.dumps({"seed": seed, "control": a.control,
                          "correct": res["correct"],
                          "metrics": res["metrics"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A/B sweep of the search engine's settings on the bench world.

Counterpart of the repository's tools/sweep_tpu.py.  Several
``BatchEngine`` configs run in one process on bench.py's world (its
index and ``FQ_SWEEP_READS`` of its reads); each is checked against the
native engine's hits, so a speed experiment cannot trade away a result,
and prints one JSON line: reads/s (best of ``FQ_SWEEP_REPS`` passes),
``ok``, iterations, fallback reads, the busy share of the lanes' steps,
the bytes the searches must move and that count's share of the card's HBM
rate, and the kernel launches of the timed passes.

    python -m fastquick_tpu_torch.sweep [--device cuda|cpu] \\
        "lanes,pool,chain[,inner[,kernel]]" ...

``kernel`` is ``resident`` (the default) or ``scan``; lanes and inner
set the scan kernel's lanes and steps a round.  With no configs it runs
the root sweep's ladder.  The root sweep's ablations (FQ_BS_ABLATE) switch
off blocks of a TPU lockstep kernel the port does not have: any other
fifth token raises.  A config that fails, or whose hits differ from the
native engine's, is printed with its error, and the sweep then exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .align.opts import GapOpt
from .bench import (
    build_index,
    device_info,
    hit_keys,
    make_reads,
    run_cuda,
    run_native,
)
from .utils.device import resolve_device

KERNELS = ("resident", "scan")
# the root sweep's ladder (tools/sweep_tpu.py), on the resident kernel
DEFAULT_CONFIGS = ("1024,512,4,32", "2048,512,4,32", "4096,512,4,32",
                   "4096,256,4,32", "1024,512,1,32")


def parse_config(arg: str) -> dict:
    """"lanes,pool,chain[,inner[,kernel]]" -> BatchEngine keywords."""
    parts = arg.split(",")
    if not 3 <= len(parts) <= 5:
        raise ValueError(f"config {arg!r}: lanes,pool,chain[,inner[,kernel]]")
    lanes, pool, chain = (int(x) for x in parts[:3])
    inner = int(parts[3]) if len(parts) > 3 else 32
    kernel = parts[4] if len(parts) > 4 else "resident"
    if kernel not in KERNELS:
        raise ValueError(f"config {arg!r}: kernel {kernel!r} is not resident "
                         "or scan (the TPU kernel's ablations are not "
                         "ported)")
    return dict(lanes=lanes, pool=pool, chain=chain, inner=inner,
                pallas=kernel)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="*", default=list(DEFAULT_CONFIGS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    configs = [(arg, parse_config(arg)) for arg in args.configs]
    dev = resolve_device(args.device)
    env = os.environ.get
    n_reads = int(env("FQ_SWEEP_READS", 8192))
    read_len = int(env("FQ_BENCH_READ_LEN", 151))
    reps = int(env("FQ_SWEEP_REPS", 2))
    t0 = time.perf_counter()
    idx = build_index(int(env("FQ_BENCH_REF_BP", 2_000_000)))
    reads = make_reads(idx, n_reads, read_len, seed=1)
    opt = GapOpt()
    gold_reads = make_reads(idx, n_reads, read_len, seed=1)
    run_native(idx, gold_reads, opt, 1)
    gold = hit_keys(gold_reads)
    del gold_reads
    info = device_info(dev)
    print(f"# world and native hits ready in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    failed = False
    for arg, kw in configs:
        line = {"config": arg}
        try:
            r = run_cuda(idx, reads, opt, dev, reps, gold, **kw)
            line.update(
                reads_per_sec=round(r["rps"], 1), ok=r["ok"],
                iters=r["iters"], fallback=r["fallback_reads"],
                busy_frac=r["busy_lane_frac"], bytes_moved=r["bytes_moved"],
                hbm_sol_frac=r["hbm_sol_frac"], kernel=r["kernel"],
                launches=r["launches"], warm_s=round(r["warm_s"], 3))
            if not r["ok"]:
                line["error"] = (f"read {r['first_mismatch']}'s hits differ "
                                 "from the native engine's")
        except Exception as e:  # reported on its line; the sweep goes on
            line["error"] = f"{type(e).__name__}: {e}"[:300]
        failed |= "error" in line
        line["device"] = info
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

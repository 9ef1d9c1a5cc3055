#!/usr/bin/env python3
"""Where the accumulation walk's time goes, on the card.

    python3 tools/accumulate_lab.py [--reps 10]

Builds csrc/accumulate.cu as it is and with one part taken out at a time
(nvcc, sm_90a, into build/accumulate_lab/), and times each build's walk
and order launches by CUDA events on a batch made as chip_smoke.py phase
2 makes its 200,000 x 150 one (testing/accumulate_cases.qc_case, the
same text size, markers and options, seed 0): the one-program
step's walk (sums and entries) and order, the walk's dense sums alone,
and a DeviceDenseStats chunk of 4,096 x 150 into resident sums; each
also on the same reads sorted by position.  A build with a part taken
out computes wrong sums: only the first is held to the plain versions.
Prints one line a build and one JSON line with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "fastquick_tpu_torch" / "csrc"
LAB = REPO / "build" / "accumulate_lab"

# name -> (what it takes out, [(source text, replacement)]); none touches
# the entry list, so the order launch runs on every build
BUILDS = {
    "as built": ("nothing", []),
    "no site adds": ("the depth, q20 and q30 atomics", [(
        "          atomicAdd(out + s, 1);\n"
        "          if (tier > 0) atomicAdd(q20 + s, 1);\n"
        "          if (tier > 1) atomicAdd(q30 + s, 1);\n",
        "          if (s == -7) atomicAdd(out + s, tier);\n")]),
    "no sums": ("every sum of a base in a region (the text word unread)", [(
        "        if (in[g]) {\n          const int mism",
        "        if (in[g] && o[g].code == 77) {\n          const int mism")]),
    "no select": ("the order's select kernel", [(
        "  fq_accum_select_kernel<<<",
        "  if (M < 0) fq_accum_select_kernel<<<")]),
    "scan only": ("the order's fill and select kernels", [
        ("  fq_accum_fill_kernel<<<", "  if (M < 0) fq_accum_fill_kernel<<<"),
        ("  fq_accum_select_kernel<<<",
         "  if (M < 0) fq_accum_select_kernel<<<")]),
}


def build_lib(name: str, edits: list):
    import chip_smoke as cs
    from fastquick_tpu_torch.kernels import build

    d = LAB / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for f in ("accumulate.cu", "accumulate_body.cuh", "fq_common.cuh"):
        shutil.copy(SRC / f, d / f)
    text = (d / "accumulate.cu").read_text()
    for a, b in edits:
        if a not in text:
            raise SystemExit(f"{name}: the source no longer has {a!r}")
        text = text.replace(a, b)
    (d / "accumulate.cu").write_text(text)
    so = d / "libfq_accumulate.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                        str(d / "accumulate.cu"), "-o", str(so)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.fq_accum_walk_launch.restype = ctypes.c_int
    lib.fq_accum_walk_launch.argtypes = (build._ACC_ARGS + build._WALK_ARGS
                                         + [ctypes.c_void_p])
    lib.fq_accum_order_launch.restype = ctypes.c_int
    lib.fq_accum_order_launch.argtypes = (build._ACC_ARGS + build._ORDER_ARGS
                                          + [ctypes.c_void_p])
    regs = {k: v.get("registers") for k, v in
            cs.parse_ptxas(r.stderr).items() if "walk" in k}
    return lib, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the lab measures the card")
    import chip_smoke as cs
    from fastquick_tpu_torch.ops import accumulate as acc
    from fastquick_tpu_torch.ops.qc_full import synthetic_site_tables
    from fastquick_tpu_torch.testing import accumulate_cases as ac

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = "cuda"
    # chip_smoke.py phase 2's text size, markers and batch options
    rng = np.random.default_rng(0)
    text = rng.integers(0, 4, 6_500_000).astype(np.uint8)
    n_text = len(text)
    tables = synthetic_site_tables(text, cs.ACC_MARKERS, cs.ACC_FLANK,
                                   device=dev)
    mpos = np.linspace(cs.ACC_FLANK, n_text - cs.ACC_FLANK - 1,
                       cs.ACC_MARKERS).astype(np.int64)
    case = ac.qc_case(rng, text, mpos, cs.ACC_READS, cs.ACC_L,
                      deep_markers=cs.ACC_DEEP[0],
                      deep_reads=cs.ACC_DEEP[1], pileup_cap=cs.ACC_CAP)
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in case.items()
         if k not in ("pileup_cap", "marker_base")}
    names = ("seqs", "rseqs", "quals", "lens", "eligible", "pos", "strand")
    by_pos = torch.argsort(t["pos"])
    inputs = {"as given": ([t[k] for k in names], t["mapq"]),
              "sorted by position": ([t[k][by_pos] for k in names],
                                     t["mapq"][by_pos])}
    planes, mapq = inputs["as given"]
    want = acc.step_outputs(
        acc.accumulate_plain(tables, n_text, *planes),
        acc.pileup_plain(tables, n_text, *planes, mapq, cs.ACC_CAP, None))
    rc = ac.ref_case(rng, text, mpos, cs.DQC_READS, cs.DQC_L, wrap=0.01)
    r = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in rc.items()}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def timed(lib, call, walk, tail):
        ev = []
        for _ in range(args.reps + 1):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            if lib.fq_accum_walk_launch(*call.args, *walk.tail, stream):
                raise SystemExit("walk launch failed")
            e[1].record()
            if tail is not None and lib.fq_accum_order_launch(
                    *call.args, *tail, stream):
                raise SystemExit("order launch failed")
            e[2].record()
            ev.append(e)
        torch.cuda.synchronize()
        return (float(np.median([a.elapsed_time(b) for a, b, _ in ev[1:]])),
                float(np.median([b.elapsed_time(c) for _, b, c in ev[1:]])))

    def step(lib, pl, mq, entries, order, check):
        call = acc.acc_call(tables, n_text, acc.MODE_READ, pl[0], pl[1],
                            pl[2], pl[3], pl[5], pl[6], pl[4], mq)
        walk = acc.walk_call(call, tables, entries=entries)
        tail = pile = None
        if entries:
            tail, pile = acc.order_call(call, tables, walk, cs.ACC_CAP, None)
        w, o = timed(lib, call, walk, tail if order else None)
        if check:
            got = acc.unpack_dense(walk.out, tables.n_sites)
            if entries:
                got = acc.step_outputs(got, pile)
            keys = want if entries else got
            if any(not torch.equal(got[k], want[k]) for k in keys):
                raise SystemExit("the build as it is != plain")
        return w, o

    def chunk(lib):
        call = acc.acc_call(tables, n_text, acc.MODE_REF, r["codes"], None,
                            r["quals"], r["lens"], r["pos"], r["strand"])
        sums = torch.zeros(acc.dense_size(tables.n_sites),
                           dtype=torch.int32, device=dev)
        return timed(lib, call, acc.walk_call(call, tables, out=sums),
                     None)[0]

    out = dict(card=card, builds={})
    for name, (what, edits) in BUILDS.items():
        lib, regs = build_lib(name, edits)
        res = dict(takes_out=what, registers=regs,
                   chunk_ms=chunk(lib))
        for how, (pl, mq) in inputs.items():
            check = name == "as built" and how == "as given"
            w, o = step(lib, pl, mq, True, True, check)
            res[how] = dict(step_walk_ms=w, order_ms=o,
                            dense_walk_ms=step(lib, pl, mq, False, False,
                                               check)[0])
        out["builds"][name] = res
        g, s = res["as given"], res["sorted by position"]
        print(f"{name} (takes out {what}; registers {regs}): step walk "
              f"{g['step_walk_ms']:.4f} ms, order {g['order_ms']:.4f} ms, "
              f"dense walk {g['dense_walk_ms']:.4f} ms, chunk "
              f"{res['chunk_ms']:.4f} ms; reads sorted by position: step "
              f"walk {s['step_walk_ms']:.4f}, dense walk "
              f"{s['dense_walk_ms']:.4f} ms", flush=True)
    sums = torch.empty(acc.dense_size(tables.n_sites), dtype=torch.int32,
                       device=dev)
    e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    sums.zero_()
    e[0].record()
    for _ in range(args.reps):
        sums.zero_()
    e[1].record()
    torch.cuda.synchronize()
    out["zero_output_ms"] = e[0].elapsed_time(e[1]) / args.reps
    print(f"zeroing the dense output ({4 * sums.numel()} bytes): "
          f"{out['zero_output_ms']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Scaling harness: data-parallel QC at 1..N ranks, measured and modeled.

Counterpart of fastquick_tpu/parallel/scaling.py.  Two outputs:

  - MEASURED (measure_scaling): qc_program.mesh_job's run of one world
    from files (production_spec: the production world at qc_full's
    defaults, through run_with_fill) over 1..N ranks started by
    parallel/mesh.spawn, its wall time and reads a second, and a check
    that every rank's merged accumulators equal one rank's.  On the CPU
    (gloo) it is that check and nothing more; ranks that share one card
    measure no scaling either, as they share its SMs and its memory.
    Only ranks with a card each measure scaling.
  - MODELED (accumulator_bytes, model_comm_time, modeled_efficiency,
    comm_report): the bytes of the step's final sum and of the
    per-marker count gather, an analytic time over the links, and the
    efficiency at a given per-shard compute time.  The collectives
    inside the step (the drand48 draw's gathered hit lists, 576 bytes a
    read; the pair keys and rows) are not in the model.

Model: a sum of P bytes costs ~2*(n-1)/n * P on the wire per rank
(reduce-scatter + all-gather); the pileup-count gather ships (n-1)/n *
M*4 more.  Link rates are data-sheet figures: NVLink 4 between the cards
of one H100 host, 450 GB/s each way a card (NVIDIA H100 data sheet), and
across hosts one 400 Gb/s NDR InfiniBand port a card (50 GB/s; the
ConnectX-7 data sheet, one port a card as on an HGX H100 board).
STEP_LAT is an assumed 1 us a ring step, not a measured figure.
Collectives ride NVLink within a host and the network across hosts (mesh
axes ('host', 'chip') reduce the chip axis first).
"""

from __future__ import annotations

import time

import numpy as np

NVLINK_BW = 4.5e11  # bytes/s each way a card, NVLink 4 (H100 data sheet)
NET_BW = 5.0e10     # bytes/s a card, 400 Gb/s NDR InfiniBand (ConnectX-7)
STEP_LAT = 1e-6     # seconds a ring step (assumed)


def accumulator_bytes(n_sites: int, n_markers: int,
                      pileup_cap: int = 64) -> dict:
    """Static psum payload of the full QC step (ops/qc_full)."""
    dense = 3 * n_sites * 4
    hists = 5 * 256 * 4
    pileup = n_markers * pileup_cap * 4 + n_markers * 4
    counters = 16 * 4
    gather_cnt = n_markers * 4  # phase-A all-gather of per-marker counts
    return {"dense": dense, "hists": hists, "pileup": pileup,
            "counters": counters, "allgather_counts": gather_cnt,
            "psum_total": dense + hists + pileup + counters}


def model_comm_time(n_devices: int, payload: dict,
                    chips_per_host: int | None = None) -> dict:
    """Analytic collective time for the step's merges on n_devices.

    chips_per_host=None models one NVLink domain (one host); otherwise
    hosts = n_devices // chips_per_host communicate hierarchically: the
    full sum over NVLink within a host, then the host-axis share over the
    network."""
    P = payload["psum_total"]
    G = payload["allgather_counts"]

    def ring(n, bytes_, bw):
        if n <= 1:
            return 0.0
        wire = 2.0 * (n - 1) / n * bytes_ + (n - 1) / n * G
        return wire / bw + 2 * (n - 1) * STEP_LAT

    if chips_per_host is None or n_devices <= chips_per_host:
        t_nv = ring(n_devices, P, NVLINK_BW)
        return {"nvlink_s": t_nv, "net_s": 0.0, "total_s": t_nv}
    hosts = max(1, n_devices // chips_per_host)
    t_nv = ring(chips_per_host, P, NVLINK_BW)
    t_net = ring(hosts, P, NET_BW)
    return {"nvlink_s": t_nv, "net_s": t_net, "total_s": t_nv + t_net}


def modeled_efficiency(compute_s: float, n_devices: int, payload: dict,
                       chips_per_host: int | None = None) -> float:
    """Efficiency = per-shard compute / (compute + modeled comm): with
    data-parallel sharding the per-shard compute is constant, so only
    the collective adds."""
    comm = model_comm_time(n_devices, payload, chips_per_host)["total_s"]
    return compute_s / (compute_s + comm)


def comm_report(n_sites: int = 1_805, n_markers: int = 9_787,
                pileup_cap: int = 64,
                compute_s: float = 0.5,
                chips_per_host: int = 8) -> list[dict]:
    """Payload + modeled efficiency per mesh size, defaults sized like the
    example panel (n_sites) and the hapmap 9,787-marker production panel,
    8 cards a host (an HGX H100 board).  A model, not a measurement."""
    payload = accumulator_bytes(n_sites, n_markers, pileup_cap)
    rows = []
    for nd in (1, 2, 4, 8, 16, 32, 64, 256):
        t = model_comm_time(nd, payload, chips_per_host)
        rows.append({
            "devices": nd,
            "psum_bytes": payload["psum_total"],
            "nvlink_ms": round(t["nvlink_s"] * 1e3, 3),
            "net_ms": round(t["net_s"] * 1e3, 3),
            "modeled_efficiency": round(
                modeled_efficiency(compute_s, nd, payload,
                                   chips_per_host), 4),
        })
    return rows


def measure_scaling(spec: dict, rank_counts=(1, 2),
                    backend: str = "gloo") -> list[dict]:
    """qc_program.mesh_job's runs of one world from files (spec: its
    spec) at each rank count, the whole batch split over the ranks (ranks
    from parallel/mesh.spawn on spec["device"]: with nccl, a card a rank;
    with gloo, all on one).  For spec's last run: the slowest rank's wall
    time (the world's load apart) and stage times, the longest exchange
    (the second pass's under run_with_fill), load time and peak device
    memory, reads a second, efficiency against the first count's rate a
    rank, and the model's bytes and time.  Raises unless every rank's
    merged accumulators equal the first count's (n_reads aside: it counts
    padding rows)."""
    from .. import qc_program as qp
    from .mesh import spawn

    qp.build_native()  # built once, here: the ranks load them
    if spec.get("device", "cuda") == "cuda":
        from ..kernels import build

        build.cuda_library()
    name = spec["runs"][-1]["name"]
    results, ref, base = [], None, None
    for nd in rank_counts:
        ranks = spawn(qp.mesh_job, nd, (spec,), backend=backend)
        runs = [r["runs"][name] for r in ranks]
        ref = ref or runs[0]["stats"]
        for r, got in enumerate(runs):
            bad = [k for k in ref if k != "n_reads" and not (
                np.allclose(ref[k], got["stats"][k], rtol=1e-6, atol=0)
                if k == "_ii" else np.array_equal(ref[k], got["stats"][k]))]
            if bad:
                raise AssertionError(f"{nd} ranks: rank {r} merged {bad} "
                                     f"unlike {rank_counts[0]} rank(s)")
        slowest = max(runs, key=lambda x: x["wall_s"])
        wall = slowest["wall_s"]
        rps = 2 * ranks[0]["n_pairs"] / wall
        base = base or rps / nd
        payload = accumulator_bytes(int(ref["depth"].shape[0]),
                                    int(ref["pileup_cnt"].shape[0]))
        peaks = [r["peak_bytes"] for r in ranks]
        results.append({
            "ranks": nd, "device": spec.get("device", "cuda"),
            "backend": backend, "reads": 2 * ranks[0]["n_pairs"],
            "wall_s": wall, "stages": slowest["times"],
            "exchange_s": max(x["times"].get("exchange", 0.0) for x in runs),
            "load_s": max(r["load_s"] for r in ranks),
            "peak_bytes": None if None in peaks else max(peaks),
            "fallback_first": runs[0]["fallback_first"],
            "reads_per_sec": rps,
            "efficiency_measured": rps / (base * nd),
            "n_mapped": int(ref["n_mapped"]),
            "psum_bytes": payload["psum_total"],
            "modeled_comm_ms": model_comm_time(nd, payload)["total_s"] * 1e3,
            "efficiency_modeled": modeled_efficiency(wall, nd, payload),
        })
    return results


def production_spec(tmp: str, pairs: int = 100_000, device: str = "cuda",
                    seed: int = 0) -> dict:
    """Build testing/synthworld's production world (10,000 markers,
    `pairs` pairs of 150 bp) and its index under tmp; returns mesh_job's
    spec for it at qc_full's defaults (pool 256, chain 4, cap 64 L), the
    k-mer filter on and the exact redo by the card's retry and the native
    engine: run_with_fill twice, the first a warm-up."""
    from ..testing.synthworld import build_production_world

    w = build_production_world(tmp, seed=seed, n_pairs=pairs)
    # the world's own pool is 512; qc_full's defaults are the reference's
    opts = dict(pool=256, chain=4, step_cap=64 * 160)
    runs = [dict(name=n, kernel="resident", fill=True, opts=opts)
            for n in ("warm", "resident")]
    return dict(tmp=tmp, idx_prefix=w["idx_prefix"], fq1=w["fq1"],
                fq2=w["fq2"], device=device, L=160, bitmaps=True,
                pileup_cap=64, engine="native", runs=runs)


if __name__ == "__main__":
    import json
    import sys
    import tempfile

    # python -m fastquick_tpu_torch.parallel.scaling [cuda|cpu [gloo|nccl
    # [pairs]]]: the production world's run_with_fill measured (gloo
    # ranks on one device: an equality check, not a scaling number; nccl:
    # a card a rank, at 1, 2, 4, ... cards) and the model at the
    # production panel's scale
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    backend = sys.argv[2] if len(sys.argv) > 2 else "gloo"
    pairs = int(sys.argv[3]) if len(sys.argv) > 3 else 100_000
    counts = (1, 2)
    if backend == "nccl":
        import torch

        counts = tuple(n for n in (1, 2, 4, 8)
                       if n <= torch.cuda.device_count())
    with tempfile.TemporaryDirectory(prefix="fq_scaling_") as tmp:
        t0 = time.perf_counter()
        spec = production_spec(tmp, pairs, dev)
        print(f"# production world of {pairs} pairs built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        for r in measure_scaling(spec, counts, backend):
            print(json.dumps(r), flush=True)
    print("# the communication model (data-sheet link rates) at the "
          "production panel's scale:")
    for r in comm_report():
        print(json.dumps(r))

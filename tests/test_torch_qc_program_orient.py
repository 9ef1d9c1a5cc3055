"""The one-program QC step through its normal path on the benchmark's
world, cut small (portbench/gen: 30 markers, a few hundred 2 x 150 panel
pairs on both strands with NovaSeq's binned qualities), plain PyTorch on
the CPU: qc_program.world_from_files -> run_with_fill -> write_product.

- The plain reference (portbench/reference/judge.py) rebuilds the dense
  sums and the pileups from the step's placements and the sample's own
  bases and qualities: they must be equal (dense_off and pileup_off 0),
  and the placements within the configuration's limits.
- EmpRepDist, EmpCycleDist and Pileup must be byte-identical to what
  align --device_qc's collector writes for the step's placements
  (testing/collector_oracle.py).
- run_with_fill's spans and counters (LAST_RUN_STATS).
"""

import os

import numpy as np
import pytest
import torch

from fastquick_tpu_torch import qc_program as qp
from fastquick_tpu_torch.testing.collector_oracle import (
    align_products,
    counted_rows,
)
from portbench import run
from portbench.gen import reads, world
from portbench.reference import judge
from portbench.reference.sites import Sites

torch.set_num_threads(2)

SEEDS = (11, 2**31 + 3, 3_000_000_004)
PAIRS = 300
STAGES = {"search", "drand48", "se_mapq", "pairing", "second_pass",
          "pair_status", "accumulate"}


@pytest.fixture(scope="module")
def cfg():
    c = run.load_json(run.HERE, "configs", "fqdefault_program.json")
    c["world"].update(n_markers=30)
    c["index"].update(var_long=5, var_short=25)
    return c


@pytest.fixture(scope="module")
def index(cfg, tmp_path_factory):
    return world.ensure_index(cfg, str(tmp_path_factory.mktemp("index")))


_RUNS: dict = {}


def program_run(cfg, index, seed, tmp_path_factory):
    """(sample, world, stats, rows, products' prefix, times) of one
    run_with_fill call at the cell's settings, once a seed."""
    if seed not in _RUNS:
        work = str(tmp_path_factory.mktemp(f"program{seed}"))
        mix = run.load_json(run.HERE, "traffic", "panel.json")
        g = world.genome(cfg["world"])
        s = reads.sample(g, cfg["index"], mix, PAIRS, seed)
        fq = (os.path.join(work, "r_1.fq.gz"), os.path.join(work, "r_2.fq.gz"))
        reads.write_fastq(s, *fq, mix["fastq_gzip_level"])
        w = qp.world_from_files(work, index, *fq, "r_1.fq", "r_2.fq",
                                device="cpu", L=cfg["padded_len"])
        w["opt_args"].update(cfg["opt_args"])
        times: dict = {}
        stats, rows, _ = qp.run_with_fill(w, pileup_cap=cfg["pileup_cap"],
                                          kernel=cfg["kernel"], times=times)
        prefix = os.path.join(work, "prod")
        qp.write_product(prefix, stats, rows, w["names"], w)
        _RUNS[seed] = (g, s, w, stats, rows, prefix, times,
                       dict(qp.LAST_RUN_STATS))
    return _RUNS[seed]


@pytest.mark.parametrize("seed", SEEDS)
def test_products_judged_correct(cfg, index, seed, tmp_path_factory):
    g, s, w, stats, rows, prefix, _, _ = program_run(cfg, index, seed,
                                                     tmp_path_factory)
    sites = Sites(g, cfg["index"])
    pl = judge.placements_from_rows(rows, sites, s["read_len"])
    got = judge.judge(prefix, s, sites, pl, cap=cfg["pileup_cap"])
    lim = cfg["limits"]
    assert got["dense_off"] == 0 and got["pileup_off"] == 0, got
    assert got["misplaced_share"] <= lim["misplaced_share"], got
    assert got["isize_off_share"] <= lim["isize_off_share"], got
    assert got["certain_reads"] > PAIRS // 2
    # the reads that decide it: both strands, more than one quality
    counted = counted_rows(rows, w["n_pairs"])
    assert {strand for _, _, strand, _ in counted} == {0, 1}
    q = np.concatenate([w["reads"][r].qual for r, *_ in counted])
    assert len(np.unique(q)) > 1


@pytest.mark.parametrize("seed", SEEDS)
def test_oriented_files_equal_align(cfg, index, seed, tmp_path_factory,
                                    tmp_path):
    _, _, w, _, rows, prefix, _, _ = program_run(cfg, index, seed,
                                                 tmp_path_factory)
    want = align_products(str(tmp_path / "align"), rows, w)
    for sfx in ("EmpRepDist", "EmpCycleDist", "Pileup"):
        a = next(f for f in want if f.endswith("." + sfx))
        with open(prefix + "." + sfx) as fg, open(a) as fa:
            assert fg.read() == fa.read(), sfx


def test_counters_and_spans(cfg, index, tmp_path_factory):
    _, _, w, stats, _, _, times, st = program_run(cfg, index, SEEDS[0],
                                                  tmp_path_factory)
    assert set(times) == STAGES | {"first_pass", "host_redo"}
    assert set(st) == {"stage_t", "counts"}
    t = st["stage_t"]
    assert {"program", "program.first_pass", "program.host_redo",
            "program.fill_pass"} | STAGES <= set(t)
    assert t["program"] >= t["program.first_pass"] + t["program.fill_pass"]
    assert t["program.fill_pass"] >= t["accumulate"] / 2
    c = st["counts"]
    B = 2 * w["n_pairs"]
    assert c["rows_searched"] == B - int(stats["n_filtered"]) > 0
    assert 0 <= c["first_pass_fallback"] <= c["rows_searched"]
    # the card's retry takes the pool overflows, the native engine the
    # rest of the fallback rows (none is filtered), each in a span inside
    # the redo's
    assert 0 < c["card_retry_rows"] <= c["first_pass_fallback"]
    assert 0 < c["card_retry_done"] <= c["card_retry_rows"]
    assert c["card_retry_launches"] >= 1
    assert c["card_retry_done"] + c["redo_rows"] == c["first_pass_fallback"]
    assert c["redo_oracle_rows"] == 0
    assert t["program.host_redo"] >= t["program.host_redo.card"] > 0
    assert ("program.host_redo.native" in t) == (c["redo_rows"] > 0)
    assert t["program.host_redo"] >= t["program.host_redo.card"] + t.get(
        "program.host_redo.native", 0.0)
    for p in ("first_pass", "fill_pass"):
        sr = c[p]["search"]
        assert sr["rows"] == c["rows_searched"] and sr["launches"] == 1
        assert sr["busy_steps"] > 0 and 0 <= sr["hit_rows"] <= 48 * B
        assert (sr["L"], sr["seed_len"]) == (cfg["padded_len"], 32)
        assert sr["table_bytes"] == w["fm"].kernel_table_bytes()
        sw = c[p]["pairing"]
        assert 1 <= len(sw) <= 2 and sw[0]["pairs"] == w["n_pairs"]
        for x in sw:
            assert 0 <= x["reverse"] <= x["valid"]
            assert 0 <= x["words"] <= x["valid"]
            assert x["compares"] >= 0 and x["penalty_len"] >= 1
    assert c["fill_pass"]["pairing"][0]["valid"] > 0
    # the search is the same in both passes: the fill replaces its output
    assert c["first_pass"]["search"] == c["fill_pass"]["search"]
    qp.run_with_fill(w, pileup_cap=cfg["pileup_cap"], kernel=cfg["kernel"])
    assert set(qp.LAST_RUN_STATS["counts"]) == {
        "rows_searched", "first_pass_fallback", "card_retry_rows",
        "card_retry_done", "card_retry_launches", "redo_rows",
        "redo_oracle_rows"}

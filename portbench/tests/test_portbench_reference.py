"""The plain reference against the port run with ``--device cpu`` on a
tiny index: every number of a sound run at its best, and each perturbed
output rejected."""

import copy
import os

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import judge
from portbench.reference.sites import CHOP, Sites

from .cases import tiny_cell, tiny_program_cell

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    c = tiny_cell()
    mod = run.load_module(os.path.join(run.HERE, "drivers", "align.py"))
    work = str(tmp_path_factory.mktemp("align"))
    d = mod.Driver(c["cfg"], c["mix"], 2**31 + 3, work, "cpu",
                   os.path.join(run.HERE, ".cache"))
    d.setup()
    d.step(0)
    k, out = d.runs[0]
    s = d.samples[k]
    sites = Sites(d.g, c["cfg"]["index"])
    pl = judge.placements_from_bam(out + ".bam")
    return dict(d=d, out=out, s=s, sites=sites, pl=pl, limits=c["cfg"][
        "limits"])


def test_sites_rederive_the_ports_index(aligned):
    from fastquick_tpu_torch.index.builder import load_index

    idx = load_index(aligned["d"].index + ".FASTQuick.fa")
    sites = aligned["sites"]
    assert [c.offset for c in idx.contigs] == sites.offset.tolist()
    assert [c.length for c in idx.contigs] == (2 * sites.flank + 1).tolist()
    assert sites.n_sites == int((2 * (sites.flank - CHOP) + 1).sum())


def test_sound_run_reads_zero(aligned):
    a = aligned
    got = judge.judge(a["out"], a["s"], a["sites"], a["pl"])
    assert got["certain_reads"] > 100
    for k in a["limits"]:
        assert got[k] == 0, k
    d = judge.dense(a["pl"], a["s"], a["sites"])
    assert d["pileup"] and d["mis_rep"].sum() > 0 and d["depth"].sum() > 0


def _certain_row(a):
    certain, _ = judge.truth_subs(a["s"], a["sites"])
    pl = a["pl"]
    for i in range(len(pl["pair"])):
        if certain[pl["end"][i], pl["pair"][i]]:
            return i
    raise AssertionError("no certain read")


def test_a_moved_read_is_rejected(aligned):
    a = aligned
    pl = copy.deepcopy(a["pl"])
    pl["pos"][_certain_row(a)] += 1
    got = judge.judge(a["out"], a["s"], a["sites"], pl)
    assert got["misplaced_share"] > 0 and got["dense_off"] > 0


def test_a_mapped_background_read_is_rejected(aligned):
    a = aligned
    s = copy.deepcopy(a["s"])
    s["on"][a["pl"]["pair"][_certain_row(a)]] = False
    got = judge.judge(a["out"], s, a["sites"], a["pl"])
    assert got["background_mapped"] > 0


@pytest.mark.parametrize("sfx,line,edit", [
    ("DepthDist", 3, lambda f: f"{f[0]}\t{int(f[1]) + 1}"),
    ("EmpRepDist", 37, lambda f: "\t".join([f[0], str(int(f[1]) + 1)]
                                           + f[2:])),
    ("EmpCycleDist", 5, lambda f: "\t".join(f[:2] + [str(int(f[2]) - 1)]
                                            + f[3:])),
    ("Pileup", 0, lambda f: "\t".join(f[:4] + [f[4][::-1]] + f[5:])),
    ("InsertSizeTable", None, None),
])
def test_an_altered_file_is_rejected(aligned, tmp_path, sfx, line, edit):
    a = aligned
    pre = str(tmp_path / "alt")
    for name in ("DepthDist", "EmpRepDist", "EmpCycleDist", "Pileup",
                 "InsertSizeTable", "Summary"):
        with open(a["out"] + "." + name) as src, \
                open(pre + "." + name, "w") as dst:
            dst.write(src.read())
    path = pre + "." + sfx
    lines = open(path).read().splitlines()
    if sfx == "InsertSizeTable":
        i = next(k for k, ln in enumerate(lines) if "PropPair" in ln)
        f = lines[i].split("\t")
        f[3] = str(int(f[3]) + 1)
        lines[i] = "\t".join(f)
        key = "isize_off_share"
    else:
        if sfx == "Pileup":
            line = next(k for k, ln in enumerate(lines)
                        if len(set(ln.split("\t")[4])) > 1)
        lines[line] = edit(lines[line].split("\t"))
        key = "pileup_off" if sfx == "Pileup" else "dense_off"
    open(path, "w").write("\n".join(lines) + "\n")
    got = judge.judge(pre, a["s"], a["sites"], a["pl"])
    assert got[key] > 0


def test_program_rows_rederive_the_placements(tmp_path):
    """The one-program step's rows read as placements: every read the
    reference must place is placed (its dense statistics are the
    program's fault recorded in PERF.md, so they are not asserted)."""
    c = tiny_program_cell()
    mod = run.load_module(os.path.join(run.HERE, "drivers", "program.py"))
    d = mod.Driver(c["cfg"], c["mix"], 2**31 + 3, str(tmp_path), "cpu",
                   os.path.join(run.HERE, ".cache"))
    d.setup()
    d.step(0)
    d.free()
    got, _ = d.judge(c["cfg"]["limits"])
    assert got["certain_reads"] > 100
    assert got["misplaced_share"] == 0 and got["isize_off_share"] == 0
    assert got["background_mapped"] == 0
    w = d.work_counts
    assert w["B"] == 300 and 0 < w["n_reg"] <= w["n_cover"]
    assert np.isfinite(got["dense_off"])

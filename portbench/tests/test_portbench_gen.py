"""The traffic generator: determinism per seed, the mix's shares,
duplicates, genotypes, and the FASTQ it writes."""

import gzip
import json
import os

import numpy as np
import pytest

from portbench.gen import reads, world
from portbench.run import HERE

MIX = json.load(open(os.path.join(HERE, "traffic", "panel.json")))
CFG = json.load(open(os.path.join(HERE, "configs", "fqdefault_align.json")))


@pytest.fixture(scope="module")
def g():
    w = dict(CFG["world"], n_markers=200)
    return world.genome(w)


@pytest.fixture(scope="module")
def big(g):
    return reads.sample(g, CFG["index"], MIX, 20000, 2**31 + 5)


def test_same_seed_same_sample(g):
    a = reads.sample(g, CFG["index"], MIX, 500, 2**33 + 1)
    b = reads.sample(g, CFG["index"], MIX, 500, 2**33 + 1)
    c = reads.sample(g, CFG["index"], MIX, 500, 2**33 + 2)
    for k in ("reads", "quals", "origin", "insert", "indel"):
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["reads"], c["reads"])


def test_genome_is_fixed_by_the_configuration():
    a = world.genome(dict(CFG["world"], n_markers=20))
    b = world.genome(dict(CFG["world"], n_markers=20))
    assert np.array_equal(a["codes"], b["codes"])
    assert len(a["codes"]) == 22 * CFG["world"]["spacing"]
    assert (a["alt"] == (a["ref"] + 1) % 4).all()
    assert a["dbsnp"].sum() == 3  # markers 0, 7, 14


def test_shares(big):
    assert abs(big["on"].mean() - MIX["on_target"]) < 0.02
    assert abs(big["dup"].mean() - MIX["dup_rate"]) < 0.01
    per_read = 1 - (1 - MIX["indel_rate"]) ** MIX["read_len"]
    assert abs(big["indel"].mean() - per_read) < 0.005
    q37 = (big["quals"] == 37).mean()
    assert 0.85 <= q37 < 0.95
    assert set(np.unique(big["quals"])) <= set(MIX["qual_levels"])
    ins = big["insert"]
    assert ins.min() >= MIX["insert_min"] and ins.max() <= MIX["insert_max"]
    assert abs(ins.mean() - MIX["insert_mean"]) < 5


def test_duplicates_copy_a_fragment(big):
    dup = np.nonzero(big["dup"] & big["on"])[0]
    keys = set(zip(big["origin"][0][~big["dup"]].tolist(),
                   big["insert"][~big["dup"]].tolist()))
    hit = sum((int(big["origin"][0][i]), int(big["insert"][i])) in keys
              for i in dup)
    assert hit == len(dup)


def test_reads_come_from_their_origin(g, big):
    L = MIX["read_len"]
    for e in (0, 1):
        i = np.nonzero(big["on"] & ~big["indel"][e])[0][:2000]
        org = big["origin"][e][i] - 1
        ref = g["codes"][org[:, None] + np.arange(L)]
        rev = big["strand"][e][i]
        ref = np.where(rev[:, None], 3 - ref[:, ::-1], ref)
        rate = (big["reads"][e][i] != ref).mean()
        assert rate < 0.02          # the quality-implied errors, ~0.5%
    # the two ends of a pair on opposite strands, insert apart
    on = big["on"]
    assert (big["strand"][0][on] != big["strand"][1][on]).all()
    lo = np.minimum(big["origin"][0], big["origin"][1])[on]
    hi = np.maximum(big["origin"][0], big["origin"][1])[on] + L
    assert np.array_equal(hi - lo, big["insert"][on])


def test_genotypes_under_hardy_weinberg(g, big):
    gt = big["genotype"]
    p = g["af"]
    assert abs((gt == 0).mean() - ((1 - p) ** 2).mean()) < 0.08
    on = big["on"]
    carry, mk = big["carry"][on], big["marker"][on]
    assert not carry[gt[mk] == 0].any()
    assert carry[gt[mk] == 2].all()
    half = carry[gt[mk] == 1].mean()
    assert 0.4 < half < 0.6


def test_fastq_roundtrip(g, tmp_path):
    s = reads.sample(g, CFG["index"], MIX, 50, 9)
    fq = (str(tmp_path / "a_1.fq.gz"), str(tmp_path / "a_2.fq.gz"))
    reads.write_fastq(s, *fq, 1)
    for e, path in enumerate(fq):
        lines = gzip.open(path, "rt").read().splitlines()
        assert len(lines) == 4 * 50
        assert lines[4] == f"@s1/{e + 1}"
        assert lines[5] == "".join("ACGT"[c] for c in s["reads"][e][1])
        assert lines[7] == "".join(chr(q + 33) for q in s["quals"][e][1])

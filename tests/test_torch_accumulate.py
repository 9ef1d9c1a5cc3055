"""The per-base accumulation kernels' bodies (csrc/accumulate_body.cuh and
the steps of csrc/accumulate.cu, built for the host with g++ as
fq_accum_walk_host and fq_accum_order_host and called with the arguments
ops/accumulate's wrappers give the launches) against the plain versions
(accumulate_plain, pileup_plain, dense_accumulate_plain), in each of the
walk's modes: the one-program step's one walk for the sums and the entry
list, the sums alone, the entries alone, DeviceDenseStats' chunks added
into resident sums; DeviceDenseStats itself with its flushes deferred and
one drain against a drain a flush; and the plain versions against
fastquick_tpu: qc_step_full's accumulators, with the search replaced by
hit rows that place each read (an index whose suffix arrays are the
identity), and DeviceDenseStats (its jitted program and the whole class).
Cases (testing/accumulate_cases.py) reach ragged strand-1 reads, reads
past the text's end and before its start, qualities above 93 and below
0 (and, for DeviceDenseStats, characters that wrap past 255), reads
longer than 256 and 1,024 bases, markers past the pileup cap with and
without slot offsets, a marker read many times by one read, no eligible
read, one read, no read, no entry and an entry at every site.  Every
output exact and of the plain version's dtype and shape."""

import shutil
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.align import device_qc as jdq  # noqa: E402
from fastquick_tpu.ops import qc_full as jq  # noqa: E402
from fastquick_tpu_torch.kernels import build  # noqa: E402
from fastquick_tpu_torch.ops import accumulate as acc  # noqa: E402
from fastquick_tpu_torch.ops import qc_full as tq  # noqa: E402
from fastquick_tpu_torch.testing import accumulate_cases as ac  # noqa: E402

import qc_step_oracle as qso  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++")

HOST_BLOCKS = 3  # the host runs the walk kernel's grid-stride loop


def _qc_args(case):
    """accumulate's / pileup's tensors (the planes, lens, eligible, pos,
    strand; mapq) from a qc_case."""
    t = {k: torch.from_numpy(np.asarray(case[k])) for k in
         ("seqs", "rseqs", "quals", "lens", "eligible", "pos", "strand",
          "mapq")}
    return [t[k] for k in ("seqs", "rseqs", "quals", "lens", "eligible",
                           "pos", "strand")], t["mapq"]


def _host_walk(tables, n_text, mode, seqs, rseqs, quals, lens, pos, strand,
               eligible=None, mapq=None, **kw):
    """(call, walk): the host build of the walk on what the wrappers
    would launch (walk_call's dense, out, entries in kw)."""
    call = acc.acc_call(tables, n_text, mode, seqs, rseqs, quals, lens, pos,
                        strand, eligible, mapq)
    walk = acc.walk_call(call, tables, **kw)
    assert build.host_library().fq_accum_walk_host(
        *call.args, HOST_BLOCKS, *walk.tail) == 0
    return call, walk


def _host_order(call, tables, walk, cap, marker_base):
    tail, pile = acc.order_call(call, tables, walk, cap, marker_base)
    assert build.host_library().fq_accum_order_host(*call.args, *tail) == 0
    return pile


def _host_dense(tables, n_text, mode, *args, eligible=None, out=None):
    return _host_walk(tables, n_text, mode, *args, eligible=eligible,
                      out=out)[1].out


def _host_accumulate(tables, n_text, seqs, rseqs, quals, lens, eligible,
                     pos, strand):
    return acc.unpack_dense(_host_dense(
        tables, n_text, acc.MODE_READ, seqs, rseqs, quals, lens, pos,
        strand, eligible=eligible), tables.n_sites)


def _host_pileup(tables, n_text, seqs, rseqs, quals, lens, eligible, pos,
                 strand, mapq, cap, marker_base):
    call, walk = _host_walk(tables, n_text, acc.MODE_READ, seqs, rseqs,
                            quals, lens, pos, strand, eligible, mapq,
                            dense=False, entries=True)
    return _host_order(call, tables, walk, cap, marker_base)


def _host_accumulate_pileup(tables, n_text, seqs, rseqs, quals, lens,
                            eligible, pos, strand, mapq, cap, marker_base):
    """The one-program step's one walk (sums and entries) and the order,
    host build; also the walk's entry list."""
    call, walk = _host_walk(tables, n_text, acc.MODE_READ, seqs, rseqs,
                            quals, lens, pos, strand, eligible, mapq,
                            entries=True)
    pile = _host_order(call, tables, walk, cap, marker_base)
    M = int(tables.n_markers)
    listed = walk.ent[:int(walk.counts[M])]
    return acc.step_outputs(acc.unpack_dense(walk.out, tables.n_sites),
                             pile), listed


def _same(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        assert torch.equal(g, w), (what, k)


def _host_equals_plain(tables, n_text, planes, mapq, cap, marker_base,
                       what):
    dense = acc.accumulate_plain(tables, n_text, *planes)
    _same(_host_accumulate(tables, n_text, *planes), dense, what)
    pile = acc.pileup_plain(tables, n_text, *planes, mapq, cap, marker_base)
    _same(_host_pileup(tables, n_text, *planes, mapq, cap, marker_base),
          pile, what)
    return dense, pile


@pytest.mark.parametrize("name", [*ac.QC_EDGE, "marker_at_zero"])
def test_qc_host_equals_plain(name):
    """The host build of both kernels against accumulate_plain and
    pileup_plain on the one-program step's inputs."""
    spec, text, case = ac.edge_case(name)
    tables = ac.edge_tables(name, spec, text, "cpu")
    planes, mapq = _qc_args(case)
    mb = None if case["marker_base"] is None else torch.from_numpy(
        case["marker_base"])
    dense, pile = _host_equals_plain(tables, len(text), planes, mapq,
                                     case["pileup_cap"], mb, name)
    n_reg = int(dense["n_base_mapped"])
    if name == "no_eligible":
        assert n_reg == 0 and int(pile["pileup_cnt"].sum()) == 0
    else:
        assert n_reg > 0 and int(pile["pileup_cnt"].sum()) > 0
    if name in ("mixed", "offsets", "long", "marker_at_zero"):
        assert int(pile["pileup_ovf"]) > 0  # markers past the cap
    if name == "longest":  # the pack's cycle clamp
        cyc = tq.unpack_entry(pile["pileup"].numpy())[4]
        assert (cyc == 1023).sum() >= 2
    if name == "marker_at_zero":  # one read, many entries at marker 0
        assert int(pile["pileup_cnt"][0]) > 10


@pytest.mark.parametrize("name", list(ac.REF_EDGE))
def test_ref_host_equals_plain(name):
    """The host build of the dense kernel in DeviceDenseStats' mode
    against dense_accumulate_plain (in the dense layout, int32)."""
    spec, text, case = ac.edge_case(name, ref=True)
    tables = ac.edge_tables(name, spec, text, "cpu")
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in case.items()}
    want = acc.dense_accumulate(tables, len(text), t["pos"], t["strand"],
                                t["codes"], t["quals"], t["lens"])
    got = _host_dense(tables, len(text), acc.MODE_REF, t["codes"], None,
                      t["quals"], t["lens"], t["pos"], t["strand"])
    assert want.dtype == got.dtype == torch.int32
    assert got.shape == want.shape and torch.equal(got, want)
    assert int(acc.unpack_dense(want, tables.n_sites)["n_base_mapped"]) > 0


def _stub_step_inputs(case, n_text):
    """Each package's qc_step_full arguments with its search replaced by
    search_rows' hits through an identity suffix array."""
    n_aln, alns = ac.search_rows(case, n_text)
    ident = np.stack([np.arange(n_text + 1)] * 2).astype(np.int32)
    planes = [np.asarray(case[k], np.int32) for k in ("seqs", "rseqs",
                                                      "quals", "lens")]
    opt_args = {"n_text": n_text, "max_diff": 4, "use_seed": False}
    return n_aln, alns, ident, planes, opt_args


@pytest.mark.parametrize("name", list(ac.QC_EDGE))
def test_qc_step_matches_jax(name):
    """fastquick_tpu's qc_step_full (given the reads as align --device_qc
    orients them, tests/qc_step_oracle.py) against the port's (on the CPU,
    the plain versions), both with the search stubbed: every accumulator;
    then the host build on the inputs the port's step handed its
    accumulate and pileup wrappers."""
    spec, text, case = ac.edge_case(name)
    B = len(case["lens"])
    n_text = len(text)
    n_aln, alns, ident, planes, opt_args = _stub_step_inputs(case, n_text)
    cap, mb = case["pileup_cap"], case["marker_base"]

    def jax_search(*a, **k):
        return (jnp.asarray(n_aln), jnp.asarray(alns), jnp.zeros(B, jnp.int32),
                0, 0)

    fm = {"sa": jnp.asarray(ident), "words": None, "occ": None,
          "L2": None, "primary": None}
    jt = jq.synthetic_site_tables(text, spec[1], spec[2])
    jmb = None if mb is None else jnp.asarray(mb)
    with mock.patch.object(jq, "_search_kernel", jax_search):
        # one compiled program (eager ops compile one by one: ~10x longer);
        # the planes relaid as fastquick_tpu's accumulation reads them
        want = jax.jit(lambda *a: qso.step()(
            fm, jt, opt_args, *a, pileup_cap=cap, marker_base=jmb))(
                *(jnp.asarray(a) for a in planes))

    calls = []

    def record(fn):
        def run(*args):
            calls.append((fn, args))
            return fn(*args)
        return run

    def port_search(fm, P, **inp):
        return (torch.from_numpy(n_aln), torch.from_numpy(alns),
                torch.zeros(B, dtype=torch.int32))

    tables = ac.edge_tables(name, spec, text, "cpu")
    with mock.patch.object(tq, "read_inputs", lambda *a: {}), \
            mock.patch.object(tq, "resident_search", port_search), \
            mock.patch.object(tq, "accumulate", record(tq.accumulate)), \
            mock.patch.object(tq, "pileup", record(tq.pileup)):
        got = tq.qc_step_full(
            SimpleNamespace(sa=torch.from_numpy(ident)), tables, opt_args,
            *(torch.from_numpy(a) for a in planes), pileup_cap=cap,
            marker_base=None if mb is None else torch.from_numpy(mb))
    assert want.keys() == got.keys()
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k
    assert int(want["n_eligible"]) == int(case["eligible"].sum())

    (fa, a_args), (fp, p_args) = calls
    assert (fa, fp) == (acc.accumulate, acc.pileup)
    _same(_host_accumulate(*a_args), acc.accumulate_plain(*a_args), name)
    _same(_host_pileup(*p_args), acc.pileup_plain(*p_args), name)


@pytest.mark.parametrize("name", list(ac.REF_EDGE))
def test_ref_matches_jax(name):
    """dense_accumulate_plain against fastquick_tpu's DeviceDenseStats
    program (its jitted accum, over the same site tables)."""
    spec, text, case = ac.edge_case(name, ref=True)
    jt = jq.synthetic_site_tables(text, spec[1], spec[2])
    with mock.patch.object(jq, "build_site_tables", lambda *a: jt):
        stats = jdq.DeviceDenseStats(SimpleNamespace(l_pac=len(text)), None,
                                     None)
    want = stats._fn(jt, *(jnp.asarray(case[k], dt) for k, dt in (
        ("pos", jnp.int32), ("strand", jnp.int32), ("codes", jnp.uint8),
        ("quals", jnp.uint8), ("lens", jnp.int32))))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in case.items()}
    got = acc.dense_accumulate_plain(
        ac.edge_tables(name, spec, text, "cpu"), len(text), t["pos"], t["strand"],
        t["codes"], t["quals"], t["lens"])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(np.asarray(want[1]).sum()) > 0


def _step_case(name):
    """(text, tables, planes, mapq, cap, marker_base) of a one-program
    edge case; "empty" is "mixed" with no read, "no_markers" "mixed" with
    every marker word cleared (eligible reads, no entry), "all_markers"
    "mixed" with a marker at every site (a walk block lists more entries
    than its shared buffer holds)."""
    base = "mixed" if name in ("empty", "no_markers", "all_markers") \
        else name
    spec, text, case = ac.edge_case(base)
    tables = ac.edge_tables(base, spec, text, "cpu")
    if name == "empty":
        case = {k: v[:0] if isinstance(v, np.ndarray) and k != "marker_base"
                else v for k, v in case.items()}
    if name == "no_markers":
        tables.marker_id[:] = -1
    if name == "all_markers":
        ac.mark_every_site(tables)
    planes, mapq = _qc_args(case)
    mb = None if case["marker_base"] is None else torch.from_numpy(
        case["marker_base"])
    return text, tables, planes, mapq, case["pileup_cap"], mb


@pytest.mark.parametrize("name", [*ac.QC_EDGE, "marker_at_zero", "empty",
                                  "no_markers", "all_markers"])
def test_qc_walk_equals_plain(name):
    """The one-program step's one walk (dense sums and the entry list),
    then the order, host build, against accumulate_plain and pileup_plain
    in every output; the list holds each entry once (no grid walk after
    it); accumulate_pileup on the CPU is the plain pair."""
    text, tables, planes, mapq, cap, mb = _step_case(name)
    n_text = len(text)
    want = acc.step_outputs(acc.accumulate_plain(tables, n_text, *planes),
                             acc.pileup_plain(tables, n_text, *planes, mapq,
                                              cap, mb))
    got, listed = _host_accumulate_pileup(tables, n_text, *planes, mapq, cap,
                                          mb)
    _same(got, want, name)
    assert list(got) == list(want)
    _same(acc.accumulate_pileup(tables, n_text, *planes, mapq, cap, mb),
          want, name)
    pacp, in_reg = acc._plain_bases(tables, n_text, *planes)[:2]
    on_mk = (in_reg & (tables.marker_id[pacp] >= 0)).reshape(-1)
    assert sorted(listed.tolist()) == on_mk.nonzero()[:, 0].tolist()
    n_entries = int(want["pileup_cnt"].sum())
    assert len(listed) == n_entries
    if name in ("empty", "no_markers", "no_eligible"):
        assert n_entries == 0
    if name == "no_markers":
        assert int(want["n_base_mapped"]) > 0
    if name == "all_markers":  # more than a walk block's buffer holds
        assert n_entries > 3 * 1024
    if name in ("mixed", "offsets"):  # more than 32 entries at a marker
        assert int(want["pileup_cnt"].max()) > 32
        assert int(want["pileup_ovf"]) > 0


@pytest.mark.parametrize("name", list(ac.REF_EDGE))
def test_ref_walk_adds_to_resident_sums(name):
    """DeviceDenseStats' walk into resident sums, host build: the case's
    reads in three chunks added to one output (zeroed once, by the
    caller) equal the plain sums of the chunks, mod 2^32 as int32."""
    spec, text, case = ac.edge_case(name, ref=True)
    tables = ac.edge_tables(name, spec, text, "cpu")
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in case.items()}
    B = len(case["lens"])
    out = torch.zeros(acc.dense_size(tables.n_sites), dtype=torch.int32)
    want = torch.zeros_like(out, dtype=torch.int64)
    for lo, hi in ((0, B // 3), (B // 3, B // 2), (B // 2, B)):
        c = {k: v[lo:hi] for k, v in t.items()}
        args = (c["codes"], None, c["quals"], c["lens"], c["pos"],
                c["strand"])
        assert _host_dense(tables, len(text), acc.MODE_REF, *args,
                           out=out) is out
        want += acc.pack_dense_plain(acc.dense_accumulate_plain(
            tables, len(text), c["pos"], c["strand"], c["codes"],
            c["quals"], c["lens"]), tables.n_sites)
    assert torch.equal(out, want.to(torch.int32))
    assert int(acc.unpack_dense(out, tables.n_sites)["n_base_mapped"]) > 0


class _Read:
    def __init__(self, pos, strand, seq, qual):
        self.pos, self.strand, self.len = pos, strand, len(seq)
        self.seq, self.qual = seq, qual


def _reads_of(case) -> list:
    """A ref_case's reads as DeviceDenseStats.add takes them: codes and
    phred + 33 characters as sequenced (strand 1 reverse-complemented)."""
    out = []
    for i, ln in enumerate(case["lens"]):
        codes = case["codes"][i, :ln]
        chars = case["quals"][i, :ln] + np.uint8(33)
        if case["strand"][i]:
            codes = np.where(codes < 4, 3 - codes, 4)[::-1]
            chars = chars[::-1]
        out.append(_Read(int(case["pos"][i]), int(case["strand"][i]),
                         codes.astype(np.uint8), chars.astype(np.uint8)))
    return out


class _Collector:
    """The arrays DeviceDenseStats adds into, and flush_dense."""

    def __init__(self, S, dense_device=None):
        self.sites = SimpleNamespace(**{k: np.zeros(S, np.int64)
                                        for k in ("depth", "q20", "q30")})
        for k in ("emp_rep_dist", "emp_cycle_dist", "mis_emp_rep_dist",
                  "mis_emp_cycle_dist"):
            setattr(self, k, np.zeros(256, np.int64))
        self.dense_device = dense_device

    def flush_dense(self):
        self.dense_device.flush(self)

    def arrays(self):
        return [self.sites.depth, self.sites.q20, self.sites.q30,
                self.emp_rep_dist, self.emp_cycle_dist,
                self.mis_emp_rep_dist, self.mis_emp_cycle_dist]


DQC_CHUNK = 512  # DeviceDenseStats' chunk in this test (4,096 in use)
DQC_BATCHES = (1300, 700, 2100)  # reads a batch: several chunks each


@pytest.mark.parametrize("drain_cells", [None, 3 * DQC_CHUNK * 150])
def test_device_dense_stats_deferred(drain_cells):
    """The port's DeviceDenseStats on the CPU: flushes deferred at each
    batch end (flush_batch, as the driver makes them) and one drain at
    the end give the collector's arrays exactly what a drain after every
    batch gives, and what fastquick_tpu's DeviceDenseStats gives on the
    same reads; with drain_cells lowered, drains inside the flushes change
    nothing."""
    from fastquick_tpu_torch.align import device_qc as tdq

    rng = np.random.default_rng(12)
    text, mpos = ac.world(rng, 6000, 10, 60)
    batches = [_reads_of(ac.ref_case(rng, text, mpos, n, 150, wrap=0.02,
                                     deep_markers=2, deep_reads=30))
               for n in DQC_BATCHES]
    tables = ac.edge_tables("chunk", (6000, 10, 60), text, "cpu")
    S = tables.n_sites
    idx = SimpleNamespace(l_pac=len(text))

    def port(deferred: bool):
        with mock.patch.object(tdq, "build_site_tables", lambda *a: tables), \
                mock.patch.object(tdq, "_PAD_B", DQC_CHUNK), \
                mock.patch.object(tdq, "DRAIN_CELLS",
                                  drain_cells or tdq.DRAIN_CELLS):
            stats = tdq.DeviceDenseStats(idx, None, None, "cpu")
            coll = _Collector(S, stats)
            for reads in batches:
                for p in reads:
                    stats.add(p)
                if deferred:
                    tdq.flush_batch(coll)
                else:
                    stats.flush(coll)
            if deferred and drain_cells is None:  # all still on the device
                assert not any(a.any() for a in coll.arrays())
            if deferred:
                coll.flush_dense()
        return stats, coll

    jt = jq.synthetic_site_tables(text, 10, 60)
    with mock.patch.object(jq, "build_site_tables", lambda *a: jt), \
            mock.patch.object(jdq, "_PAD_B", DQC_CHUNK):
        jstats = jdq.DeviceDenseStats(idx, None, None)
        want = _Collector(S)
        for reads in batches:
            for p in reads:
                jstats.add(p)
            jstats.flush(want)
    assert want.sites.depth.sum() > 0 and want.mis_emp_rep_dist.sum() > 0

    every, got_every = port(False)
    once, got_once = port(True)
    for g, e, w in zip(got_once.arrays(), got_every.arrays(), want.arrays()):
        assert np.array_equal(g, w) and np.array_equal(e, w)
    if drain_cells is None:
        assert (every.drains, once.drains) == (len(DQC_BATCHES), 1)
    else:  # drains inside the flushes: at most 3 chunks' cells a drain
        chunks = sum(-(-n // DQC_CHUNK) for n in DQC_BATCHES)
        assert once.drains >= -(-chunks // 3) > len(DQC_BATCHES)

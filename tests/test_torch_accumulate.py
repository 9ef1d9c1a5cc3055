"""The per-base accumulation kernels' bodies (csrc/accumulate_body.cuh and
the steps of csrc/accumulate.cu, built for the host with g++ as
fq_accum_dense_host and fq_accum_pileup_host and called with the
arguments ops/accumulate's wrappers give the launches) against the plain
versions (accumulate_plain, pileup_plain, dense_accumulate_plain), and the
plain versions against fastquick_tpu: qc_step_full's accumulators, with
the search replaced by hit rows that place each read (an index whose
suffix arrays are the identity), and DeviceDenseStats' jitted program.
Cases (testing/accumulate_cases.py) reach ragged strand-1 reads, reads
past the text's end and before its start, qualities above 93 and below
0 (and, for DeviceDenseStats, characters that wrap past 255), reads
longer than 256 and 1,024 bases, markers past the pileup cap with and
without slot offsets, a marker read many times by one read, no eligible
read and one read.  Every output exact and of the plain version's dtype
and shape."""

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

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++")

HOST_BLOCKS = 3  # the host runs the dense kernel's grid-stride walk


def _qc_args(case):
    """accumulate's / pileup's tensors (the planes, lens, eligible, pos,
    strand; mapq) from a qc_case."""
    t = {k: torch.from_numpy(np.asarray(case[k])) for k in
         ("seqs", "rseqs", "quals", "lens", "eligible", "pos", "strand",
          "mapq")}
    return [t[k] for k in ("seqs", "rseqs", "quals", "lens", "eligible",
                           "pos", "strand")], t["mapq"]


def _host_dense(tables, n_text, mode, *args, eligible=None):
    call, dense3, out = acc.dense_call(tables, n_text, mode, *args,
                                       eligible=eligible)
    assert build.host_library().fq_accum_dense_host(
        *call.args, HOST_BLOCKS, build.ptr(dense3), build.ptr(out)) == 0
    return out


def _host_accumulate(tables, n_text, seqs, rseqs, quals, lens, eligible,
                     pos, strand):
    return acc.unpack_dense(_host_dense(
        tables, n_text, acc.MODE_READ, seqs, rseqs, quals, lens, pos,
        strand, eligible=eligible), tables.n_sites)


def _host_pileup(tables, n_text, seqs, rseqs, quals, lens, eligible, pos,
                 strand, mapq, cap, marker_base):
    call, tail, (pile, cnt, ovf) = acc.pileup_call(
        tables, n_text, seqs, rseqs, quals, lens, eligible, pos, strand,
        mapq, cap, marker_base)
    assert build.host_library().fq_accum_pileup_host(*call.args,
                                                     *tail) == 0
    return {"pileup": pile, "pileup_cnt": cnt, "pileup_ovf": ovf[0]}


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
    """fastquick_tpu's qc_step_full against the port's (on the CPU, the
    plain versions), both with the search stubbed: every accumulator;
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
        # one compiled program (eager ops compile one by one: ~10x longer)
        want = jax.jit(lambda *a: jq.qc_step_full(
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

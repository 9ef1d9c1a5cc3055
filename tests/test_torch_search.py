"""The port's BatchEngine (plain PyTorch search on the CPU) against
fastquick_tpu's XLA search and HostEngine; hit compaction against
_compact_hits; lane independence of the plain search; the search
kernel's per-read body, built for the host with g++, against the plain
version, in read order and in a shuffled one; and the chain length CH
(exact-walk bases a step) of the plain version and of the host build
against the XLA search's CH_STEPS.  Every comparison is exact."""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.align.engine import HostEngine  # noqa: E402
from fastquick_tpu.align.opts import GapOpt  # noqa: E402
from fastquick_tpu.ops import batch_search as jbs  # noqa: E402
from fastquick_tpu_torch.align.seqs import Read as TRead  # noqa: E402
from fastquick_tpu_torch.index.builder import (  # noqa: E402
    ContigInfo as TContig,
    ReducedIndex as TIndex,
)
from fastquick_tpu_torch.index.kmerfilter import KmerFilter as TKmer  # noqa: E402
from fastquick_tpu_torch.ops import batch_search as tbs  # noqa: E402
from fastquick_tpu_torch.ops.search_kernels import search_plain  # noqa: E402

from test_batch_engine import aln_key, make_idx, make_read, synth_reads  # noqa: E402


def port_idx(idx):
    """The same index as the port's ReducedIndex (FM arrays shared)."""
    c = idx.contigs[0]
    contig = TContig(*[getattr(c, f) for f in c.__dataclass_fields__])
    return TIndex(fm_fwd=idx.fm_fwd, fm_rev=idx.fm_rev, text=idx.text,
                  contigs=[contig], contig_offsets=idx.contig_offsets,
                  kmer=TKmer([np.zeros(0, np.uint32)] * 6, thresh=0),
                  ambs=[])


def port_reads(reads):
    out = []
    for p in reads:
        q = TRead()
        for f in ("len", "full_len", "clip_len", "seq", "rseq", "qual"):
            v = getattr(p, f)
            setattr(q, f, v.copy() if isinstance(v, np.ndarray) else v)
        out.append(q)
    return out


@pytest.mark.parametrize("pool,step_cap", [(512, 768), (1024, 1536)])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_xla_and_host(seed, pool, step_cap):
    idx = make_idx(seed=seed)
    reads_h = synth_reads(idx, 60, seed + 10)
    reads_x = synth_reads(idx, 60, seed + 10)
    reads_t = port_reads(synth_reads(idx, 60, seed + 10))
    HostEngine(idx).align_batch(reads_h, GapOpt())
    ex = jbs.BatchEngine(idx, max_batch=64, pool=pool, step_cap=step_cap,
                         pallas=False)
    ex.align_batch(reads_x, GapOpt())
    et = tbs.BatchEngine(port_idx(idx), "cpu", pool=pool, step_cap=step_cap)
    et.align_batch(reads_t, GapOpt())
    assert et.last_fallback == ex.last_fallback
    assert et.last_fb_causes == ex.last_fb_causes
    for i, (h, x, t) in enumerate(zip(reads_h, reads_x, reads_t)):
        hk = [aln_key(a) for a in h.aln]
        xk = [aln_key(a) for a in x.aln]
        tk = [aln_key(a) for a in t.aln]
        assert tk == xk, f"read {i}: port {tk} vs xla {xk}"
        assert tk == hk, f"read {i}: port {tk} vs host {hk}"


def test_n_bases_and_lengths():
    idx = make_idx(seed=5)
    codes = [idx.text[500:600].copy()]
    codes[0][50] = 4
    for ln in (36, 70, 151):
        start = 1000 + ln * 7
        codes.append(idx.text[start:start + ln].copy())
    rh = [make_read(c.copy()) for c in codes]
    rt = port_reads([make_read(c.copy()) for c in codes])
    HostEngine(idx).align_batch(rh, GapOpt())
    tbs.BatchEngine(port_idx(idx), "cpu").align_batch(rt, GapOpt())
    for h, t in zip(rh, rt):
        assert [aln_key(a) for a in h.aln] == [aln_key(a) for a in t.aln]


def test_compact_hits_matches_jax():
    rng = np.random.default_rng(7)
    N = 64
    n_aln = rng.integers(0, 6, N).astype(np.int32)
    n_aln[3] = 48
    alns = rng.integers(0, 1 << 20, (N, 48, 3)).astype(np.int32)
    fb = np.where(rng.random(N) < 0.2, 8, 0).astype(np.int32)
    for K_CAP in (3 * N, 40):  # roomy, and small enough to spill
        want = jbs._compact_hits(jnp.asarray(n_aln), jnp.asarray(alns),
                                 jnp.asarray(fb), K_CAP)
        got = tbs.compact_hits(torch.from_numpy(n_aln),
                               torch.from_numpy(alns), torch.from_numpy(fb),
                               K_CAP)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _chunk(idx, reads, pool=1024):
    """Search-kernel inputs of one chunk, as BatchEngine builds them."""
    eng = tbs.BatchEngine(port_idx(idx), "cpu", pool=pool)
    packed, aux, P = tbs.pack_chunk(reads, GapOpt(), pool)
    inp = tbs.chunk_inputs(eng.dev, torch.from_numpy(packed),
                           torch.from_numpy(aux), P)
    return eng.dev, P, inp


def test_lane_independence():
    """A read's result must not depend on its lane or its neighbours: the
    one-thread-per-read CUDA kernel relies on it."""
    idx = make_idx(seed=3)
    reads = port_reads(synth_reads(idx, 150, 33))
    fm, P, inp = _chunk(idx, reads, pool=256)
    P = dataclasses.replace(P, step_cap=400)  # exercise the fallbacks too
    ref = search_plain(fm, P, lanes=256, **inp)
    small = search_plain(fm, P, lanes=64, **inp)
    for a, b in zip(ref, small):
        assert torch.equal(a, b)
    perm = np.random.default_rng(4).permutation(len(reads))
    fm2, P2, inp2 = _chunk(idx, [reads[i] for i in perm], pool=256)
    P2 = dataclasses.replace(P2, step_cap=400)
    assert P2 == P
    shuf = search_plain(fm2, P2, lanes=64, **inp2)
    for a, b in zip(ref, shuf):
        assert torch.equal(a[:len(reads)][torch.from_numpy(perm)],
                           b[:len(reads)])
    assert int((ref[2] != 0).sum()) > 0, "world should exercise fallbacks"


def _host_search(fm, P, inp, order):
    """The g++ build of the resident kernel's body (fq_search_host): reads
    taken in `order` on a few reused workspaces.  Returns (n_aln, alns, fb,
    steps, hwm)."""
    from fastquick_tpu_torch.kernels.build import host_library

    N = inp["seqs0"].shape[0]
    i32 = torch.int32
    alns = torch.zeros((N, 48, 3), dtype=i32)
    n_aln, fb, steps, hwm = (torch.zeros(N, dtype=i32) for _ in range(4))
    wid = inp["widths"].clone()
    args = [inp["seqs0"].to(torch.uint8)] + [
        inp[k].to(i32).contiguous()
        for k in ("lens", "md", "use_seed", "n_n")]
    order = torch.as_tensor(order, dtype=i32)
    sp = P.to_array()

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    assert host_library().fq_search_host(
        p(fm.kernel_table()), fm.host_params().ctypes.data_as(
            ctypes.c_void_p), sp.ctypes.data_as(ctypes.c_void_p),
        *[p(a) for a in args], N, p(wid), p(inp["seed_w"].contiguous()),
        p(order), p(alns), p(n_aln), p(fb), p(steps), p(hwm)) == 0
    return n_aln, alns, fb, steps, hwm


def _plain_with_hwm(fm, P, inp):
    hwm = torch.zeros(inp["seqs0"].shape[0], dtype=torch.int32)
    return (*search_plain(fm, P, **inp, hwm=hwm), hwm)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("seed", [2, 6])
@pytest.mark.parametrize("pool,step_cap", [(512, 768), (1024, 1536)])
def test_search_body_host_build_matches_plain(pool, step_cap, seed):
    """The resident kernel's body against the plain version, pool
    high-water marks included, at both pool/cap pairs and on two
    worlds."""
    idx = make_idx(seed=seed)
    reads = port_reads(synth_reads(idx, 120, seed + 10))
    fm, P, inp = _chunk(idx, reads, pool)
    P = dataclasses.replace(P, step_cap=step_cap)
    want = _plain_with_hwm(fm, P, inp)
    got = _host_search(fm, P, inp, np.arange(inp["seqs0"].shape[0]))
    for name, a, b in zip(("n_aln", "alns", "fb", "steps", "hwm"), got,
                          want):
        assert torch.equal(a, b), name
    assert int(want[4].max()) > 64, "some read should hold many slots"


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_search_body_host_build_any_pull_order():
    """A read's result must not depend on the order reads are taken or on
    its workspace's history: a shuffled order, on reused workspaces, must
    give every read the same result."""
    idx = make_idx(seed=3)
    reads = port_reads(synth_reads(idx, 150, 33))
    fm, P, inp = _chunk(idx, reads, pool=256)
    P = dataclasses.replace(P, step_cap=400)  # exercise the fallbacks too
    want = _plain_with_hwm(fm, P, inp)
    order = np.random.default_rng(5).permutation(inp["seqs0"].shape[0])
    got = _host_search(fm, P, inp, order)
    for name, a, b in zip(("n_aln", "alns", "fb", "steps", "hwm"), got,
                          want):
        assert torch.equal(a, b), name
    assert int((want[2] != 0).sum()) > 0, "world should exercise fallbacks"


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_search_body_depth_independent(tmp_path):
    """A read the search finishes has one result at any pool depth, which
    the one-program step's retry of pool overflows (ops/host_redo.py)
    rests on: the g++ build at 2,048 and 32,767 slots, on the program
    cell's tiny world (pool 16, chain 4), gives every row that finishes at
    both the same hits, steps and pool high-water mark, and every row the
    pool of 16 stopped finishes at both; the rows that finish at 16 keep
    theirs."""
    from fastquick_tpu_torch.ops.qc_full import search_params
    from fastquick_tpu_torch.ops.search_kernels import FB_POOL
    from test_torch_host_redo import program_world

    w = program_world(str(tmp_path))
    seqs, _, _, lens = w["arrays"]
    P = search_params(w["opt_args"], seqs.shape[1])
    assert (P.NP, P.CH) == (16, 4)
    lens = lens.long()
    inp = tbs.read_inputs(w["fm"], seqs, lens, w["md_table"].long()[lens],
                          lens > P.SL, P)
    order = np.arange(seqs.shape[0])
    first = _host_search(w["fm"], P, inp, order)
    deep = [_host_search(w["fm"], dataclasses.replace(P, NP=n), inp, order)
            for n in (2048, 32767)]
    both = (deep[0][2] == 0) & (deep[1][2] == 0)
    pool = first[2] == FB_POOL
    assert int(pool.sum()) > 50, "pool 16 stopped few rows: vacuous"
    assert bool(both[pool].all())
    assert int((deep[0][0][both] > 0).sum()) > 50, "few rows with hits"
    for i in (0, 1, 3, 4):  # n_aln, alns, steps, pool high-water marks
        assert torch.equal(deep[0][i][both], deep[1][i][both])
    assert int(deep[0][4][pool].max()) > 16
    done = first[2] == 0
    for i in (0, 1, 3, 4):
        assert torch.equal(first[i][done], deep[0][i][done])


def _xla_search(fm, P, inp, chain):
    """fastquick_tpu's XLA _search_kernel on the chunk's inputs, every read
    on its own lane.  Returns (n_aln, alns, fb) as numpy and the busy
    steps (the sum of the reads' steps)."""
    N = inp["seqs0"].shape[0]
    n_aln, alns, fb, _, busy = jbs._search_kernel(
        jnp.asarray(fm.words.numpy()), jnp.asarray(fm.occ.numpy()),
        jnp.asarray(fm.sa.numpy()), jnp.asarray(fm.L2.numpy()),
        jnp.asarray(fm.primary.numpy()),
        jnp.asarray(inp["seqs0"].numpy().astype(np.int8)),
        jnp.asarray(inp["lens"].numpy().astype(np.int32)),
        jnp.asarray(inp["md"].numpy().astype(np.int32)),
        jnp.asarray(inp["use_seed"].numpy()),
        B=N, NP=P.NP, K_INNER=16, CH_STEPS=chain, step_cap=P.step_cap,
        s_mm=P.s_mm, s_gapo=P.s_gapo, s_gape=P.s_gape, max_gapo=P.max_gapo,
        max_gape=P.max_gape, indel_end_skip=P.indel_end_skip,
        max_del_occ=P.max_del_occ, max_entries=P.max_entries,
        max_top2=P.max_top2, seed_len=P.SL, max_seed_diff=P.max_seed_diff,
        n_text=fm.n)
    return (np.asarray(n_aln), np.asarray(alns), np.asarray(fb)), int(busy)


@pytest.fixture(scope="module")
def chain_world():
    """A chunk at pool 512 and a step cap of 160 that binds: one step cap
    for all, so the chain length changes which reads reach it."""
    idx = make_idx(seed=8)
    reads = port_reads(synth_reads(idx, 200, 18))
    fm, P, inp = _chunk(idx, reads, 512)
    return fm, dataclasses.replace(P, step_cap=160), inp


@pytest.mark.parametrize("chain", [1, 4])
def test_chain_plain_matches_xla(chain_world, chain):
    """The plain search at chain length 1 and 4 against the XLA search at
    CH_STEPS 1 and 4: hits, fallback sets and steps."""
    fm, P, inp = chain_world
    P = dataclasses.replace(P, CH=chain)
    got = search_plain(fm, P, **inp)
    want, busy = _xla_search(fm, P, inp, chain)
    for name, g, w in zip(("n_aln", "alns", "fb"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[3].long().sum()) == busy
    assert int((got[2] != 0).sum()) > 0, "the step cap should bind"


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_chain_host_build_matches_plain(chain_world):
    """The chain kernel's body (CH = 4) against the plain version, read for
    read, pool high-water marks included; CH changes the steps and the
    fallback set, and not the hits of the reads both finish."""
    fm, P, inp = chain_world
    P4 = dataclasses.replace(P, CH=4)
    want = _plain_with_hwm(fm, P4, inp)
    got = _host_search(fm, P4, inp, np.arange(inp["seqs0"].shape[0]))
    for name, a, b in zip(("n_aln", "alns", "fb", "steps", "hwm"), got,
                          want):
        assert torch.equal(a, b), name
    one = _plain_with_hwm(fm, P, inp)
    assert int(want[3].long().sum()) < int(one[3].long().sum())
    assert not torch.equal(want[2] != 0, one[2] != 0), \
        "CH should change the fallback set at this cap"
    both = (want[2] == 0) & (one[2] == 0)
    assert torch.equal(want[0][both], one[0][both])
    assert torch.equal(want[1][both], one[1][both])


@pytest.mark.parametrize("chain", [1, 4])
def test_engine_chain_matches_jax_and_native(chain):
    """BatchEngine(chain=) on the CPU against the reference engine's XLA
    path at the same chain length, pool and step cap (hits, fallback
    count and causes) and against the native engine (hits)."""
    from fastquick_tpu.align.engine import NativeEngine

    idx = make_idx(seed=9)
    reads_n = synth_reads(idx, 80, 19)
    reads_x = synth_reads(idx, 80, 19)
    reads_t = port_reads(synth_reads(idx, 80, 19))
    NativeEngine(idx).align_batch(reads_n, GapOpt())
    ex = jbs.BatchEngine(idx, max_batch=128, pool=512, step_cap=768,
                         chain=chain, pallas=False)
    ex.align_batch(reads_x, GapOpt())
    et = tbs.BatchEngine(port_idx(idx), "cpu", pool=512, step_cap=768,
                         chain=chain)
    assert et.chain == chain
    et.align_batch(reads_t, GapOpt())
    assert et.last_fallback == ex.last_fallback
    assert et.last_fb_causes == ex.last_fb_causes
    for i, (n, x, t) in enumerate(zip(reads_n, reads_x, reads_t)):
        tk = [aln_key(a) for a in t.aln]
        assert tk == [aln_key(a) for a in x.aln], f"read {i} vs xla"
        assert sorted(tk) == sorted(aln_key(a) for a in n.aln), (
            f"read {i} vs native")


def test_scan_path_refuses_chain():
    """The scan kernel walks one base a step: any other chain length
    raises when the engine is made (the reference's engine drops to its
    XLA path instead)."""
    with pytest.raises(ValueError, match="chain 2"):
        tbs.BatchEngine(port_idx(make_idx(seed=1)), "cpu", pallas="scan",
                        chain=2)
    assert tbs.BatchEngine(port_idx(make_idx(seed=1)), "cpu", pallas="scan",
                           chain=1).chain == 1

"""The port's one-program QC step (ops/qc_full.qc_step_full, plain PyTorch
on the CPU) against fastquick_tpu's, on the worlds of tests/
test_qc_full.py: the ragged single-end world and the paired-end world
with seeded duplicates.  The same reads, made from a seed with numpy, go
through both (fastquick_tpu's given each read as align --device_qc
orients it, tests/qc_step_oracle.py); every accumulator must be
identical in value and dtype,
and so must every per-pair row field, n_pcr_dup and the insert-size
estimate (its floats within 1e-6 relative)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.ops import qc_full as jq  # noqa: E402
from fastquick_tpu_torch import qc_program as qp  # noqa: E402
from fastquick_tpu_torch.ops import qc_full as tq  # noqa: E402
from fastquick_tpu_torch.ops.fm import DeviceFM  # noqa: E402

import qc_step_oracle as qso  # noqa: E402

from test_qc_full import (  # noqa: E402
    make_pair_reads,
    make_ragged_reads,
    md_table_for,
    opt_args_for,
)

TABLE_FIELDS = ("site_idx", "marker_id", "text", "dbsnp", "is_xy",
                "contig_id", "contig_off", "contig_len")


def port_tables(t):
    """The reference package's SiteTables as the port's, on the CPU."""
    return tq.SiteTables.from_numpy(
        *(np.array(getattr(t, f)) for f in TABLE_FIELDS), t.n_sites,
        t.n_markers)


def port_fm(dev):
    """The reference package's DeviceFM as the port's, on the CPU."""
    return DeviceFM.from_numpy(*(np.array(x) for x in (
        dev.words, dev.occ, dev.sa, dev.L2, dev.primary)), dev.n)


def assert_same(want: dict, got: dict, rows_got: dict | None = None):
    """Every key of the reference's output (numpy or jax arrays, with
    _pair_rows a dict) equal in the port's (tensors); _ii within 1e-6
    relative; _pair_keys compared as n_pcr_dup by the caller."""
    bad = []
    for k, w in want.items():
        if k == "_pair_keys":
            continue
        if k == "_pair_rows":
            for kk, ww in w.items():
                g = rows_got[kk] if rows_got is not None else got[k][kk]
                g, ww = np.asarray(g), np.asarray(ww)
                if g.dtype != ww.dtype or not np.array_equal(g, ww):
                    bad.append(f"_pair_rows.{kk}")
            continue
        g = got[k].cpu().numpy()
        w = np.asarray(w)
        if k == "_ii":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        elif g.dtype != w.dtype or g.shape != w.shape \
                or not np.array_equal(g, w):
            bad.append(f"{k} ({g.dtype}{g.shape} vs {w.dtype}{w.shape})")
    assert not bad, f"port != reference: {bad}"


@pytest.fixture(scope="module")
def world():
    import __graft_entry__ as ge

    text, dev = ge._tiny_index()
    tables = jq.synthetic_site_tables(np.asarray(text))
    fm_arrays = {"words": dev.words, "occ": dev.occ, "sa": dev.sa,
                 "L2": dev.L2, "primary": dev.primary}
    return text, dev, tables, fm_arrays


def _both(world, reads, **kw):
    text, dev, tables, fm_arrays = world
    L = reads[0].shape[1]
    opt_args = opt_args_for(dev, L)
    from fastquick_tpu.align.opts import GapOpt

    md = md_table_for(L, GapOpt())
    want = qso.step()(fm_arrays, tables, opt_args,
                      *(jnp.asarray(a) for a in reads), md_table=md, **kw)
    got = tq.qc_step_full(port_fm(dev), port_tables(tables), opt_args,
                          *(torch.from_numpy(a) for a in reads),
                          md_table=torch.from_numpy(np.asarray(md)), **kw)
    return want, got


def test_synthetic_site_tables_match(world):
    text, _, tables, _ = world
    got = tq.synthetic_site_tables(np.asarray(text), device="cpu")
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(tables, f)))
    assert (got.n_sites, got.n_markers) == (tables.n_sites, tables.n_markers)


def test_ragged_se_world_matches_jax(world):
    text = np.asarray(world[0])
    seqs, rseqs, quals, lens = make_ragged_reads(text, 64, 100)
    want, got = _both(world, (seqs, rseqs, quals, lens),
                      return_per_read=True)
    assert_same(want[0], got[0])
    for k in ("kept", "mapped", "eligible", "fallback", "host_redo"):
        np.testing.assert_array_equal(got[1][k].numpy(),
                                      np.asarray(want[1][k]), err_msg=k)
    assert int(want[0]["n_mapped"]) > 40


def test_pair_world_matches_jax(world):
    """The pair world of test_pair_mode_mesh_equals_single, one device."""
    text = np.asarray(world[0])
    seqs, rseqs, quals, lens = make_pair_reads(text, 32, 100)
    want, got = _both(world, (seqs, rseqs, quals, lens), pair_mode=True)
    assert_same(want, got)
    n_dup = int(jq.count_pcr_dups(want["_pair_keys"]))
    assert int(tq.count_pcr_dups(got["_pair_keys"])) == n_dup > 0
    assert int(want["n_pair_reads"]) > 0


def test_helpers_match_jax():
    """ragged_unreverse, _pileup_ranks, _approx_mapq and count_pcr_dups on
    seeded random inputs."""
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 5, (40, 33)).astype(np.int32)
    lens = rng.integers(0, 34, 40).astype(np.int32)
    np.testing.assert_array_equal(
        tq.ragged_unreverse(torch.from_numpy(arr),
                            torch.from_numpy(lens)).numpy(),
        np.asarray(jq.ragged_unreverse(jnp.asarray(arr), jnp.asarray(lens))))
    mk = rng.integers(-1, 9, 500).astype(np.int32)
    np.testing.assert_array_equal(
        tq._pileup_ranks(torch.from_numpy(mk),
                         torch.from_numpy(mk >= 0)).numpy(),
        np.asarray(jq._pileup_ranks(jnp.asarray(mk), jnp.asarray(mk >= 0))))
    c1 = rng.integers(0, 4, 300).astype(np.int32)
    c2 = rng.integers(0, 300, 300).astype(np.int32)
    eq = rng.integers(0, 2, 300).astype(bool)
    np.testing.assert_array_equal(
        tq._approx_mapq(*(torch.from_numpy(a) for a in (c1, c2, eq))).numpy(),
        np.asarray(jq._approx_mapq(*(jnp.asarray(a) for a in (c1, c2, eq)))))
    keys = rng.integers(0, 4, (200, 3)).astype(np.int32)
    keys[rng.random(200) < 0.3] = 0x7FFFFFFF
    assert int(tq.count_pcr_dups(torch.from_numpy(keys))) == int(
        jq.count_pcr_dups(jnp.asarray(keys)))


def test_entry_runs_on_cpu():
    """qc_program.entry's step on the CPU: the graft entry's counters."""
    import __graft_entry__ as ge

    fn, args = qp.entry(device="cpu")
    got = fn(*args)
    jfn, jargs = ge.entry()
    want = jfn(*jargs)
    for k in ("n_reads", "n_mapped", "n_eligible", "n_base_mapped",
              "n_fallback", "pileup_ovf"):
        assert int(got[k]) == int(want[k]), k


def test_depth_pileup_matches_jax():
    """ops/pileup.depth_pileup on seeded reads, some past the reference's
    end (dropped) and some unmapped."""
    from fastquick_tpu.ops.pileup import depth_pileup as jdp
    from fastquick_tpu_torch.ops.pileup import depth_pileup as tdp

    rng = np.random.default_rng(2)
    B, L, n_ref = 300, 60, 5000
    pos = rng.integers(0, n_ref, B).astype(np.int32)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    mapped = rng.random(B) < 0.8
    quals = rng.integers(0, 45, (B, L)).astype(np.int32)
    want = jdp(*(jnp.asarray(a) for a in (pos, lens, mapped, quals)), n_ref)
    got = tdp(*(torch.from_numpy(a) for a in (pos, lens, mapped, quals)),
              n_ref)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), k


def test_scan_kernel_on_few_lanes_matches_resident(world):
    """kernel="scan" on 8 lanes (refills all the way through the batch)
    equals the resident kernel at chain 1: the per-read results do not
    depend on the lanes."""
    text, dev, tables, _ = world
    seqs, rseqs, quals, lens = make_ragged_reads(np.asarray(text), 64, 100)
    from fastquick_tpu.align.opts import GapOpt

    md = torch.from_numpy(np.array(md_table_for(100, GapOpt())))
    opt_args = dict(opt_args_for(dev, 100), chain=1, lanes=8)
    args = (port_fm(dev), port_tables(tables), opt_args,
            *(torch.from_numpy(a) for a in (seqs, rseqs, quals, lens)))
    scan = tq.qc_step_full(*args, md_table=md, kernel="scan")
    res = tq.qc_step_full(*args, md_table=md)
    assert_same({k: v.numpy() for k, v in res.items()}, scan)
    with pytest.raises(ValueError, match="chain=1 only"):
        tq.qc_step_full(*args[:2], dict(opt_args, chain=4), *args[3:],
                        kernel="scan")


def test_scan_chunk_refuses_interior_padding():
    """Padding rows (md < 0) before the last real read idle a scan lane
    each for good; as many as the lanes would end no round, so the scan
    path refuses them."""
    from fastquick_tpu_torch.align.opts import GapOpt as TGapOpt
    from fastquick_tpu_torch.ops.batch_search import chunk_inputs, pack_chunk
    from fastquick_tpu_torch.ops.search_kernels import scan_chunk

    import __graft_entry__ as ge

    text, dev = ge._tiny_index()
    seqs, _, lens, _ = qp.make_reads(np.asarray(text), 20, 60)

    class _R:
        def __init__(self, codes):
            self.len, self.seq = len(codes), codes

    reads = [_R(seqs[b, :lens[b]].astype(np.uint8)) for b in range(20)]
    packed, aux, P = pack_chunk(reads, TGapOpt(), 256, kernel="scan")
    inp = chunk_inputs(port_fm(dev), torch.from_numpy(packed),
                       torch.from_numpy(aux), P)
    inp["md"][2:6] = -1  # four padding rows among the reads
    with pytest.raises(ValueError, match="idle all 4 scan lanes"):
        scan_chunk(port_fm(dev), P, 4, 16, **inp)
    out = scan_chunk(port_fm(dev), P, 5, 16, **inp)
    assert int(out[0][:20].sum()) > 0 and int(out[0][2:6].abs().sum()) == 0

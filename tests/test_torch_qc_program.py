"""The port's one-program QC step on indexed FASTQ worlds, through
fastquick_tpu_torch.qc_program (plain PyTorch on the CPU), against
fastquick_tpu's step on the same files:

- 128 pairs of the drand48 repeat world (tests/test_drand48_qc.py, as
  tests/test_qc_resident.py subsamples it), drand48 on, with the resident
  and the scan search;
- the same pairs at pool 96: the first pass's fallback set, then
  run_with_fill (the host engine's hit lists as fb_fill) against the
  reference's fill pass;
- the same pairs with the k-mer bitmaps applied in the step at chain 4;
- the occurrence-overflow world (tests/test_pe_occ_overflow.py), whose
  repeat pairs need the second pairing pass;
- the product files qc_program.write_product writes, byte for byte
  against __graft_entry__._write_product.

fastquick_tpu's step is given each read as align --device_qc orients it
(tests/qc_step_oracle.py).  Every accumulator, n_pcr_dup and every
per-pair row field must be identical; the insert-size estimate's floats
within 1e-6 relative.  On the drand48 world, EmpRepDist, EmpCycleDist and
Pileup are also held to what align --device_qc's collector writes for the
step's placements (testing/collector_oracle.py)."""

import filecmp
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch import qc_program as qp  # noqa: E402
from fastquick_tpu_torch.testing.collector_oracle import (  # noqa: E402
    align_products,
)

import qc_step_oracle as qso  # noqa: E402

from test_drand48_qc import world as drand_world  # noqa: E402,F401
from test_pe_occ_overflow import _device_run as occ_run  # noqa: E402
from test_pe_occ_overflow import world as occ_world  # noqa: E402,F401
from test_pe_qc_differential import _load  # noqa: E402
from test_qc_resident import N_PAIRS, _accs  # noqa: E402
from test_torch_qc_full import assert_same  # noqa: E402


def port_world(world, n_pairs=None, **opt_args):
    """The port's world over the reference world's index and FASTQs (on
    the CPU, reads padded to 128 as the reference tests pad them), cut to
    the first n_pairs pairs, with opt_args overrides."""
    w = qp.world_from_files(world["tmp"], str(world["tmp"] / "idx"),
                            world["fq1"], world["fq2"], "a_1.fq", "a_2.fq",
                            device="cpu", L=128)
    if n_pairs is not None:
        w["arrays"] = tuple(a[:2 * n_pairs] for a in w["arrays"])
        w["reads"] = w["reads"][:2 * n_pairs]
        w["names"] = w["names"][:n_pairs]
        w["n_pairs"] = n_pairs
        w["n_base"] = sum(p.full_len for p in w["reads"])
    w["opt_args"].update(opt_args)
    return w


RESIDENT_OPTS = dict(pool=512, step_cap=768, chain=1, inner=32)


@pytest.fixture(scope="module")
def drand_ref(drand_world):  # noqa: F811
    """The reference's step on the 128 pairs at pool 512, cap 768."""
    with qso.oriented():
        return _accs(drand_world, None, 0, pool=512, step_cap=768)


ALIGN_HELD = ("EmpRepDist", "EmpCycleDist", "Pileup")


def same_as_align(stats, rows, w, tmp_path):
    """EmpRepDist, EmpCycleDist and Pileup of the step byte-identical to
    align --device_qc's collector's on the step's placements."""
    got = qp.write_product(str(tmp_path / "step"), stats, rows, w["names"],
                           w)
    want = align_products(str(tmp_path / "align"), rows, w)
    for sfx in ALIGN_HELD:
        g = next(f for f in got if f.endswith("." + sfx))
        a = next(f for f in want if f.endswith("." + sfx))
        assert filecmp.cmp(g, a, shallow=False), sfx


@pytest.mark.parametrize("kernel", ["resident", "scan"])
def test_drand48_world_matches_jax(drand_world, drand_ref,  # noqa: F811
                                   kernel, tmp_path):
    w = port_world(drand_world, N_PAIRS, **RESIDENT_OPTS)
    stats, rows = qp.run_single(w, kernel=kernel)
    assert_same(drand_ref, stats, rows)
    assert int(stats["n_pcr_dup"]) == int(drand_ref["n_pcr_dup"])
    assert int(drand_ref["n_mapped"]) > 0
    same_as_align(stats, rows, w, tmp_path)


def test_product_files_match_graft_entry(drand_world, drand_ref,  # noqa: F811
                                         tmp_path):
    import __graft_entry__ as ge

    w = port_world(drand_world, N_PAIRS, **RESIDENT_OPTS)
    stats, rows = qp.run_single(w)
    idx, opt, new_ref = _load(drand_world)
    jw = dict(idx=idx, opt=opt, new_ref=new_ref, fname1=w["fname1"],
              fname2=w["fname2"], n_pairs=w["n_pairs"], n_base=w["n_base"])
    jrows = drand_ref["_pair_rows"]
    want = ge._write_product(str(tmp_path / "ref"), drand_ref, jrows,
                             w["names"], jw)
    got = qp.write_product(str(tmp_path / "port"), stats, rows, w["names"],
                           w)
    assert [os.path.basename(f).split(".", 1)[1] for f in got] == \
        [os.path.basename(f).split(".", 1)[1] for f in want]
    assert len(got) >= 12, got
    diffs = [g for g, r in zip(got, want)
             if not filecmp.cmp(g, r, shallow=False)]
    assert not diffs, diffs
    same_as_align(stats, rows, w, tmp_path)


def test_fill_pass_matches_jax(drand_world):  # noqa: F811
    """At pool 96 the first pass falls back on some reads (the same set as
    the reference's); run_with_fill then equals the reference's fill pass
    on every accumulator, with no fallback left."""
    from fastquick_tpu.align.engine import HostEngine
    from fastquick_tpu.ops.qc_full import pack_host_hits
    from fastquick_tpu_torch.align.engine import HostEngine as THostEngine
    from test_pe_qc_differential import _read_pairs

    opts = dict(RESIDENT_OPTS, pool=96)
    w = port_world(drand_world, N_PAIRS, **opts)
    with qso.oriented():
        want1, pr = _accs(drand_world, None, 0, pool=96, step_cap=768,
                          per_read=True)
    got1, rows1, pr_t = qp.run_single(w, per_read=True)
    fb_mask = np.asarray(pr["fallback"]) != 0
    assert fb_mask.any(), "pool=96 forced no fallback; test is vacuous"
    np.testing.assert_array_equal(pr_t["fallback"].numpy() != 0, fb_mask)
    assert_same(want1, got1, rows1)

    idx, opt, _ = _load(drand_world)
    b0, b1 = _read_pairs(drand_world, idx, opt)
    eng = HostEngine(idx)
    eng.align_batch([p for p in b0[:N_PAIRS] if not p.filtered], opt)
    eng.align_batch([p for p in b1[:N_PAIRS] if not p.filtered], opt)
    flat = [p for i in range(N_PAIRS) for p in (b0[i], b1[i])]
    rows_idx = [b for b in range(len(flat)) if fb_mask[b]]
    fill = pack_host_hits([flat[b] for b in rows_idx], rows_idx,
                          fb_mask.shape[0])
    with qso.oriented():
        want = _accs(drand_world, None, 0, pool=96, step_cap=768,
                     fb_fill=fill)
    times = {}
    got, rows, n_fb = qp.run_with_fill(w, engine=THostEngine(w["idx"]),
                                       times=times)
    assert n_fb == int(fb_mask.sum())
    assert int(want["n_fallback"]) == int(got["n_fallback"]) == 0
    assert_same(want, got, rows)
    assert {"search", "drand48", "pairing", "host_redo"} <= set(times)


def test_bitmaps_chain4_matches_jax(drand_world):  # noqa: F811
    """The k-mer bitmaps applied in the step (the reads they drop get
    md = -1 and stay out of the dense search chunk, their results scattered
    back as zeros) at qc_full's default chain length 4, drand48 on: every
    accumulator and row as the reference's step given the same bitmaps."""
    import warnings

    from fastquick_tpu.ops.fm import DeviceFM as JDeviceFM
    from fastquick_tpu.ops.qc_full import (build_site_tables,
                                           count_pcr_dups, qc_step_full)
    from fastquick_tpu.stats.collector import StatCollector

    w = port_world(drand_world, N_PAIRS, **dict(RESIDENT_OPTS, chain=4))
    assert sum(p.filtered for p in w["reads"]) > 0, "no read filtered"
    kmer = w["idx"].kmer
    stacked = kmer.bitmaps_uint32()  # (6, 2^27) uint32
    kmer._byte_bitmaps = None  # keep one 3 GiB copy alive, not two
    bitmaps = jnp.asarray(stacked)
    del stacked
    with warnings.catch_warnings():  # the port reads JAX's buffer as is
        warnings.simplefilter("ignore", UserWarning)
        w["bitmaps"] = torch.from_numpy(np.asarray(bitmaps).view(np.int32))
    w["thresh"] = kmer.thresh
    stats, rows, pr = qp.run_single(w, per_read=True)
    del w["bitmaps"]

    idx, opt, new_ref = _load(drand_world)
    sc = StatCollector()
    sc.restore_vcf_sites(new_ref, opt)
    tables = build_site_tables(idx, sc, opt)
    dev = JDeviceFM.build(idx.fm_fwd, idx.fm_rev)
    fm = {"words": dev.words, "occ": dev.occ, "sa": dev.sa, "L2": dev.L2,
          "primary": dev.primary}
    opt_args = dict(w["opt_args"])
    md_t = jnp.asarray(w["md_table"].numpy())

    @jax.jit
    def step(bm, s, r, q, ln):
        return qso.step(qc_step_full)(fm, tables, opt_args, s, r, q, ln,
                                      bitmaps=bm,
                            thresh=kmer.thresh, md_table=md_t,
                            pair_mode=True, return_per_read=True)

    want, want_pr = step(bitmaps, *(jnp.asarray(a.numpy())
                                    for a in w["arrays"]))
    del bitmaps
    want["n_pcr_dup"] = count_pcr_dups(want.pop("_pair_keys"))
    assert_same(want, stats, rows)
    assert int(stats["n_pcr_dup"]) == int(want["n_pcr_dup"])
    assert set(pr) == set(want_pr)
    for k, v in want_pr.items():
        np.testing.assert_array_equal(pr[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert not np.asarray(want_pr["kept"]).all(), "the bitmaps kept all"
    assert int(want["n_mapped"]) > 0


def test_occ_overflow_world_matches_jax(occ_world):  # noqa: F811
    """Repeat pairs past k_occ = 32 occurrences take the second pairing
    pass (k_occ2 = 512): pairs, rows and counters as the reference's."""
    with qso.oriented():
        _, want = occ_run(occ_world, k_occ2=512)
    w = port_world(occ_world, k_occ2=512)
    stats, rows = qp.run_single(w)
    assert_same(want, stats, rows)
    assert int(stats["n_pcr_dup"]) == int(want["n_pcr_dup"])
    assert int(want["n_pair_ovf"]) == 0
    with qso.oriented():
        _, want32 = occ_run(occ_world, k_occ2=32)
    w["opt_args"]["k_occ2"] = 32
    stats32, rows32 = qp.run_single(w)
    assert_same(want32, stats32, rows32)
    assert int(stats32["n_pair_ovf"]) >= 10

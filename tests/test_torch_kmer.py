"""The port's k-mer filter (plain PyTorch) against fastquick_tpu.ops.kmer
and the host KmerFilter, with N codes; exact equality."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.index.kmerfilter import KmerFilterBuilder  # noqa: E402
from fastquick_tpu.ops import kmer as jk  # noqa: E402
from fastquick_tpu_torch.ops import kmer as tk  # noqa: E402


def test_kmer_halves_match_jax():
    rng = np.random.default_rng(0)
    chunks = rng.integers(0, 5, (256, 32)).astype(np.int32)  # incl. N = 4
    chunks[:8, 15:18] = 4  # N around the half boundary (the bit spill)
    whi, wlo = jk.kmer_halves(jnp.asarray(chunks))
    thi, tlo = tk.kmer_halves(torch.from_numpy(chunks))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(whi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(wlo))


def test_projections_match_jax():
    rng = np.random.default_rng(1)
    kmers = rng.integers(0, 2**63, 200).astype(np.uint64)
    hi = (kmers >> np.uint64(32)).astype(np.uint32)
    lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = np.asarray(jk.projections(jnp.asarray(hi), jnp.asarray(lo)))
    got = tk.projections(torch.from_numpy(hi.astype(np.int64)),
                         torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_filter_reads_matches_jax_and_host():
    from fastquick_tpu.index.seq import encode, reverse_complement_str

    rng = np.random.default_rng(2)
    flank = 260
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 2 * flank + 1))
    b = KmerFilterBuilder()
    b.add_seq(seq, ("A", "C"))
    filt = b.finalize()
    B, L = 96, 120
    seqs = np.zeros((B, L), dtype=np.int32)
    lens = np.full(B, L, dtype=np.int32)
    for i in range(B):
        s = int(rng.integers(0, len(seq) - L))
        if i % 3 == 0:
            codes = encode(seq[s:s + L])
        elif i % 3 == 1:
            codes = encode(reverse_complement_str(seq[s:s + L]))
        else:
            codes = rng.integers(0, 4, L).astype(np.uint8)
        if i % 5 == 0:
            codes = codes.copy()
            codes[int(rng.integers(0, L))] = 4
        seqs[i] = codes
    lens[::7] = 70  # only two in-bounds chunks
    want_host = np.array([filt.is_read_kept(seqs[i, :lens[i]])
                          for i in range(B)])
    stacked = filt.bitmaps_uint32()  # (6, 2^27) uint32
    filt._byte_bitmaps = None  # keep one 3 GiB copy alive, not two
    want = np.asarray(jk.filter_reads(jnp.asarray(stacked), jnp.asarray(seqs),
                                      jnp.asarray(lens), filt.thresh))
    tb = tk.load_kmer_bitmaps(stacked, "cpu")
    assert np.shares_memory(tb.numpy(), stacked)
    got = tk.filter_reads(tb, torch.from_numpy(seqs), torch.from_numpy(lens),
                          filt.thresh).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_host)
    # per-table form (what the align driver passes): same answers
    rows = tk.load_kmer_bitmaps(list(stacked), "cpu")
    got_rows = tk.filter_reads(rows, torch.from_numpy(seqs),
                               torch.from_numpy(lens), filt.thresh).numpy()
    np.testing.assert_array_equal(got_rows, want)
    assert want.sum() > 20 and (~want).sum() > 15

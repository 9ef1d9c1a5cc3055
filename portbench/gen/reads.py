"""One general generator of paired-end samples, driven by a traffic mix's
parameters (``traffic/<name>.json``) and a seed.

Everything is drawn with NumPy in whole-sample arrays.  A pair is either
on target (its fragment laid over a uniformly chosen base of a marker's
flank) or background (two random reads absent from the genome).  The
sample's genotype at each marker comes from the marker's AF under
Hardy-Weinberg; PCR duplicates copy another pair's fragment; qualities
take NovaSeq's binned levels and each base is substituted at its
quality's error probability; a read may carry one 1-base indel.

The truth it keeps (origin, strand, insert, indel flag, kind) is input
data for the reference, which never sees the port's work.
"""

from __future__ import annotations

import gzip

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def flanks(g: dict, index_cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """Each marker's flank as 1-based closed [lo, hi]: the first var_long
    markers in VCF order take the long flank (the index's selection rule,
    which accepts every marker of this layout)."""
    n = len(g["pos"])
    f = np.where(np.arange(n) < index_cfg["var_long"],
                 index_cfg["flank_long_len"], index_cfg["flank_len"])
    return g["pos"] - f, g["pos"] + f


def sample(g: dict, index_cfg: dict, mix: dict, n_pairs: int,
           seed: int) -> dict:
    """A sample of n_pairs pairs: reads (codes 0..3, (2, n, L) uint8, in
    sequencing orientation), quals (phred, (2, n, L)) and the truth."""
    rng = np.random.default_rng(seed)
    L = mix["read_len"]
    codes = g["codes"]
    glen = len(codes)
    lo, hi = flanks(g, index_cfg)

    # genotype: ALT copies at each marker under Hardy-Weinberg
    gt = rng.binomial(2, g["af"])

    on = rng.random(n_pairs) < mix["on_target"]
    insert = np.clip(np.rint(rng.normal(mix["insert_mean"], mix["insert_sd"],
                                        n_pairs)),
                     mix["insert_min"], mix["insert_max"]).astype(np.int64)
    # a flank base, uniform over all flank bases, that the fragment covers
    width = hi - lo + 1
    cum = np.cumsum(width)
    t = rng.integers(0, int(cum[-1]), n_pairs)
    mk = np.searchsorted(cum, t, side="right")
    base0 = lo[mk] - 1 + (t - (cum[mk] - width[mk]))  # 0-based genome
    start = base0 - rng.integers(0, insert)
    start = np.clip(start, 0, glen - insert - 2)
    flip = rng.random(n_pairs) < 0.5
    carry = rng.random(n_pairs) < gt[mk] / 2.0

    # PCR duplicates: copies of another pair's fragment (and kind)
    dup = rng.random(n_pairs) < mix["dup_rate"]
    src = np.arange(n_pairs)
    orig = np.nonzero(~dup)[0]
    if len(orig):
        src[dup] = orig[rng.integers(0, len(orig), int(dup.sum()))]
    for a in (on, insert, mk, start, flip, carry):
        a[:] = a[src]

    # each read's source: L + 1 bases in sequencing orientation
    # read 1 from the fragment's start (forward) unless flipped
    fwd_start = start                       # the forward read's 0-based start
    rev_start = start + insert - L          # the reverse read's
    k = np.arange(L + 1)
    reads = np.empty((2, n_pairs, L + 1), np.uint8)
    strand = np.empty((2, n_pairs), bool)   # True: reverse strand
    origin = np.empty((2, n_pairs), np.int64)  # 1-based leftmost base
    for e in (0, 1):
        is_rev = flip if e == 0 else ~flip
        strand[e] = is_rev
        origin[e] = np.where(is_rev, rev_start, fwd_start) + 1
        fpos = np.where(is_rev[:, None],
                        rev_start[:, None] + L - 1 - k[None, :],
                        fwd_start[:, None] + k[None, :])
        fpos = np.clip(fpos, 0, glen - 1)
        b = codes[fpos]
        # the fragment's allele at its marker
        m0 = g["pos"][mk] - 1
        at = (fpos == m0[:, None]) & carry[:, None]
        b = np.where(at, g["alt"][mk][:, None], b)
        b = np.where(is_rev[:, None], 3 - b, b)
        reads[e] = b
    # background pairs: random reads (a duplicate copies its source's)
    bg = rng.integers(0, 4, (2, n_pairs, L + 1)).astype(np.uint8)
    bg = bg[:, src]
    reads = np.where(on[None, :, None], reads, bg)

    # one 1-base indel in a read that draws one
    p_indel = 1.0 - (1.0 - mix["indel_rate"]) ** L
    indel = rng.random((2, n_pairs)) < p_indel
    ins = rng.random((2, n_pairs)) < 0.5
    m = mix["indel_margin"]
    at = rng.integers(m, L - m, (2, n_pairs))
    idx = np.broadcast_to(np.arange(L, dtype=np.int32),
                          (2, n_pairs, L)).copy()
    col = np.arange(L)[None, None, :]
    dele = indel & ~ins
    idx = np.where(dele[..., None] & (col >= at[..., None]), idx + 1, idx)
    inse = indel & ins
    idx = np.where(inse[..., None] & (col > at[..., None]), idx - 1, idx)
    out = np.take_along_axis(reads, idx, axis=2)
    extra = rng.integers(0, 4, (2, n_pairs)).astype(np.uint8)
    hit = inse[..., None] & (col == at[..., None])
    out = np.where(hit, extra[..., None], out)

    # binned qualities, Q37 falling toward the 3' end
    frac = (np.arange(L) / max(L - 1, 1)) ** 2
    p37 = mix["q37_first"] + (mix["q37_last"] - mix["q37_first"]) * frac
    levels = np.asarray(mix["qual_levels"], np.uint8)
    split = np.cumsum(mix["low_split"])
    u = rng.random((2, n_pairs, L))
    v = rng.random((2, n_pairs, L))
    low = levels[1 + np.searchsorted(split, v * split[-1], side="right")
                 .clip(0, len(levels) - 2)]
    qual = np.where(u < p37[None, None, :], levels[0], low).astype(np.uint8)
    err = rng.random((2, n_pairs, L)) < 10.0 ** (-qual.astype(float) / 10)
    shift = rng.integers(1, 4, (2, n_pairs, L)).astype(np.uint8)
    out = np.where(err, (out + shift) % 4, out).astype(np.uint8)

    return dict(reads=out, quals=qual, on=on, insert=insert, marker=mk,
                strand=strand, origin=origin, indel=indel, dup=dup,
                carry=carry, genotype=gt, n_pairs=n_pairs, read_len=L)


def write_fastq(s: dict, fq1: str, fq2: str, level: int) -> None:
    """The sample's two FASTQs, gzipped at `level`; pair i is named s<i>."""
    n, L = s["n_pairs"], s["read_len"]
    names = [f"@s{i}/" for i in range(n)]
    for e, path in ((0, fq1), (1, fq2)):
        seq = ACGT[s["reads"][e]]
        qual = (s["quals"][e] + 33).astype(np.uint8)
        sep = np.frombuffer(b"\n+\n", np.uint8)
        body = np.concatenate([seq, np.broadcast_to(sep, (n, 3)), qual,
                               np.full((n, 1), 10, np.uint8)], axis=1)
        rows = body.tobytes()
        w = 2 * L + 4
        tag = str(e + 1)
        text = b"".join(b"%s%s\n%s" % (names[i].encode(), tag.encode(),
                                       rows[i * w:(i + 1) * w])
                        for i in range(n))
        with open(path, "wb") as fh:
            fh.write(gzip.compress(text, compresslevel=level))

"""The plain reference's judgement of one sample's outputs.

It reads the generator's truth and the genome (``gen/``), the flanks and
sites it derives itself (``reference/sites.py``), and the port's outputs,
which it only judges: the placements (the BAM, or the one-program step's
rows), the InsertSizeTable, DepthDist, EmpRepDist, EmpCycleDist, Summary
and Pileup.  Each number is a count or a share that a sound run holds to
its limit (``configs/<name>.json`` "limits"):

- ``misplaced_share``: of the reads the generator laid inside a flank with
  no indel, at most 5 substitutions and at most 2 in either 32-base end
  (a unique hit within the aligner's seed and max-diff limits), the share
  not reported at their origin, strand, a full-length match, their
  substitution count as NM and mapQ >= 20 (a read the k-mer filter
  dropped counts here);
- ``background_mapped``: background reads (random, absent from the
  genome) reported mapped;
- ``isize_off_share``: of the pairs with both ends such reads, the share
  whose InsertSizeTable row is not PropPair with the true insert;
- ``dense_off``: entries that differ between the port's DepthDist,
  EmpRepDist, EmpCycleDist and Summary (Q20, Q30 fractions, mapped bases)
  and the same sums worked out here from the placements it reported and
  the sample's own bases and qualities;
- ``pileup_off``: markers whose Pileup line differs from the one worked
  out here from those placements, in the port's read order.
"""

from __future__ import annotations

import re

import numpy as np

from .bam import read_bam
from .sites import CHOP

SEED = 32
MAX_SUBS = 5
SEED_SUBS = 2
MIN_MAPQ = 20
DEPTH_BINS = 1024
HIST_BINS = 256
_NAME = re.compile(r"s(\d+)")


def truth_subs(s: dict, sites) -> tuple[np.ndarray, np.ndarray]:
    """(certain, subs): which reads (2, n) the aligner must place at their
    origin, and each read's substitutions against the genome there."""
    L = s["read_len"]
    n = s["n_pairs"]
    org = s["origin"] - 1                                  # 0-based
    span = np.clip(org[..., None] + np.arange(L), 0, sites.glen - 1)
    ref = sites.codes[span]
    ref = np.where(s["strand"][..., None], 3 - ref[..., ::-1], ref)
    diff = s["reads"] != ref                               # read orientation
    subs = diff.sum(-1)
    mk = np.broadcast_to(s["marker"], (2, n))
    inside = (s["origin"] >= sites.lo[mk]) & \
        (s["origin"] + L - 1 <= sites.hi[mk])
    certain = (s["on"][None, :] & ~s["indel"] & inside
               & (subs <= MAX_SUBS)
               & (diff[..., :SEED].sum(-1) <= SEED_SUBS)
               & (diff[..., -SEED:].sum(-1) <= SEED_SUBS))
    return certain, subs


def placements_from_bam(path: str) -> dict:
    """The BAM's records as output-ordered arrays: pair, end, mapped, pos
    (1-based genome), strand, mapq, cigar, NM."""
    _, recs = read_bam(path)
    out = {k: [] for k in ("pair", "end", "mapped", "pos", "strand", "mapq",
                           "cigar", "nm")}
    for r in recs:
        out["pair"].append(int(_NAME.match(r["name"]).group(1)))
        out["end"].append(0 if r["flag"] & 0x40 else 1)
        out["mapped"].append(not r["flag"] & 0x4)
        out["pos"].append(r["pos"] + 1)
        out["strand"].append(bool(r["flag"] & 0x10))
        out["mapq"].append(r["mapq"])
        out["cigar"].append(r["cigar"])
        out["nm"].append(-1 if r["NM"] is None else r["NM"])
    pl = {k: np.asarray(v) for k, v in out.items() if k != "cigar"}
    pl["cigar"] = out["cigar"]
    pl["eligible"] = pl["mapped"] & (pl["mapq"] >= MIN_MAPQ)
    return pl


def placements_from_rows(rows: dict, sites, L: int) -> dict:
    """The one-program step's rows (text positions) as output-ordered
    arrays; a read's contig is the one its first base lies in."""
    n = len(rows["mapped0"])
    cols = {}
    for k in ("mapped", "pos", "strand", "mapq", "len", "n_mm", "n_gapo",
              "n_gape"):
        cols[k] = np.stack([np.asarray(rows[f"{k}0"]),
                            np.asarray(rows[f"{k}1"])], 1).reshape(-1)
    t = cols["pos"].astype(np.int64)
    cid = np.clip(sites.contig_of_text(t), 0, len(sites.offset) - 1)
    gapped = (cols["n_gapo"] > 0) | (cols["n_gape"] > 0)
    mapped = cols["mapped"].astype(bool)
    pl = dict(pair=np.repeat(np.arange(n), 2), end=np.tile([0, 1], n),
              mapped=mapped, pos=sites.genome_pos(t, cid),
              strand=cols["strand"].astype(bool), mapq=cols["mapq"],
              nm=np.where(gapped, -1, cols["n_mm"]), len=cols["len"])
    full = mapped & ~gapped & (cols["len"] == L)
    pl["cigar"] = [[("M", L)] if f else None for f in full]
    pl["eligible"] = mapped & (cols["mapq"] >= MIN_MAPQ) & ~gapped
    return pl


def misplaced(pl: dict, s: dict, certain, subs) -> tuple[float, int]:
    """(misplaced_share, background_mapped)."""
    L = s["read_len"]
    ok = np.zeros_like(certain)
    full = np.array([c == [("M", L)] for c in pl["cigar"]], bool)
    p, e = pl["pair"], pl["end"]
    good = (pl["mapped"] & full & (pl["mapq"] >= MIN_MAPQ)
            & (pl["pos"] == s["origin"][e, p])
            & (pl["strand"] == s["strand"][e, p])
            & (pl["nm"] == subs[e, p]))
    ok[e[good], p[good]] = True
    n_cert = int(certain.sum())
    bad = int((certain & ~ok).sum())
    bg = int((pl["mapped"] & ~s["on"][p]).sum())
    return bad / max(n_cert, 1), bg


def isize_off(path: str, s: dict, certain) -> float:
    both = certain[0] & certain[1]
    good = np.zeros(s["n_pairs"], bool)
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            i = int(_NAME.match(f[0]).group(1))
            if f[14] == "PropPair" and int(f[3]) == s["insert"][i]:
                good[i] = True
    return float((both & ~good).sum()) / max(int(both.sum()), 1)


def _ref_oriented(s: dict, p: np.ndarray, e: np.ndarray, strand):
    seq = s["reads"][e, p]
    qual = s["quals"][e, p]
    rev = strand[:, None]
    return (np.where(rev, 3 - seq[:, ::-1], seq),
            np.where(rev, qual[:, ::-1], qual))


def _segments(cigar, L):
    """(read offset, genome offset, length) of each M segment."""
    out, r, g = [], 0, 0
    for op, n in cigar:
        if op in "M=X":
            out.append((r, g, n))
            r += n
            g += n
        elif op in "IS":
            r += n
        elif op in "DN":
            g += n
    return out


def dense(pl: dict, s: dict, sites, cap: int | None = None) -> dict:
    """The per-site and per-quality sums and the marker pileups that the
    eligible placements imply, in output order."""
    L = s["read_len"]
    idx = np.nonzero(pl["eligible"])[0]
    p, e = pl["pair"][idx], pl["end"][idx]
    strand = pl["strand"][idx]
    seq, qual = _ref_oriented(s, p, e, strand)
    rows, cols, gpos = [], [], []
    for k, i in enumerate(idx):
        for r0, g0, n in _segments(pl["cigar"][i] or [("M", L)], L):
            rows.append(np.full(n, k))
            cols.append(r0 + np.arange(n))
            gpos.append(pl["pos"][i] + g0 + np.arange(n))
    if rows:
        rows, cols, gpos = (np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(gpos))
    else:
        rows = cols = gpos = np.zeros(0, np.int64)
    gpos = np.clip(gpos, 0, sites.glen + 1)
    site = sites.site_of[gpos]
    on = site >= 0
    bq = qual[rows, cols].astype(np.int64)
    base = seq[rows, cols]
    cyc = np.where(strand[rows], L - 1 - cols, cols)
    gref = sites.codes[np.clip(gpos - 1, 0, sites.glen - 1)]
    mism = (base != gref) & (base < 4) & ~sites.dbsnp[gpos]
    o = on
    depth = np.bincount(site[o], minlength=sites.n_sites)
    out = dict(
        depth=depth,
        q20=int((bq[o] >= 20).sum()), q30=int((bq[o] >= 30).sum()),
        emp_rep=np.bincount(bq[o], minlength=HIST_BINS),
        mis_rep=np.bincount(bq[o & mism], minlength=HIST_BINS),
        emp_cycle=np.bincount(cyc[o], minlength=HIST_BINS),
        mis_cycle=np.bincount(cyc[o & mism], minlength=HIST_BINS))
    # marker pileups: every M base at a marker, in output order
    mk = sites.marker_at[gpos]
    at = np.nonzero(mk >= 0)[0]
    at = at[np.lexsort((cols[at], rows[at]))]
    pile: dict[int, list] = {}
    for j in at:
        m = int(mk[j])
        ent = pile.setdefault(m, [])
        if cap is not None and len(ent) >= cap:
            continue
        k = rows[j]
        ent.append(("ACGTN"[base[j]], int(bq[j]),
                    int(pl["mapq"][idx[k]]), bool(strand[k]), int(cyc[j])))
    out["pileup"] = pile
    out["entry_reads"] = len(np.unique(rows[at]))
    return out


def _read_table(path: str, ncol: int) -> np.ndarray:
    rows = [line.split("\t")[:ncol] for line in open(path)]
    return np.asarray(rows, np.int64).reshape(-1, ncol)


def _fmt(v: float) -> str:
    return f"{v:.6g}"


def dense_off(prefix: str, d: dict, sites) -> int:
    """Entries of the port's files that differ from the sums in d."""
    depth = d["depth"]
    cov = depth[depth > 0]
    want = np.bincount(np.clip(cov, 0, DEPTH_BINS - 1),
                       minlength=DEPTH_BINS)
    region = int((2 * (sites.flank - CHOP) + 1).sum())
    want[0] = region - len(cov)
    got = _read_table(prefix + ".DepthDist", 2)[:, 1]
    bad = int((got != want).sum())
    rep = _read_table(prefix + ".EmpRepDist", 3)
    bad += int((rep[:, 1] != d["mis_rep"][:HIST_BINS]).sum())
    bad += int((rep[:, 2] != d["emp_rep"][:HIST_BINS]).sum())
    cyc = _read_table(prefix + ".EmpCycleDist", 3)
    bad += int((cyc[:, 1] != d["mis_cycle"][:HIST_BINS]).sum())
    bad += int((cyc[:, 2] != d["emp_cycle"][:HIST_BINS]).sum())
    mapped = int(depth.sum())
    lines = {}
    for line in open(prefix + ".Summary"):
        k, _, v = line.partition(" : ")
        lines[k.strip()] = v.strip()
    frac = (lambda x: _fmt(0 if mapped == 0 else x / mapped))
    bad += lines.get("Q20 Base Fraction") != frac(d["q20"])
    bad += lines.get("Q30 Base Fraction") != frac(d["q30"])
    erd = lines.get("Estimated Read Depth", "")
    bad += not erd.endswith(f"[{mapped}/{region}]")
    return bad


def pileup_off(prefix: str, d: dict, sites) -> int:
    want = {}
    for m, ent in d["pileup"].items():
        bases = "".join(b.upper() if st else b.lower()
                        for b, _, _, st, _ in ent)
        quals = "".join(chr(q + 33) for _, q, _, _, _ in ent)
        maqs = "".join(chr(mq + 33) for _, _, mq, _, _ in ent)
        cycles = ",".join(str(c) for *_, c in ent)
        want[int(sites.pos[m])] = (f"{len(ent)}\t{bases}\t{quals}\t{maqs}\t"
                                   f"{cycles}")
    got = {}
    for line in open(prefix + ".Pileup"):
        f = line.rstrip("\n").split("\t", 3)
        got[int(f[1])] = f[3]
    return sum(want.get(k) != got.get(k) for k in set(want) | set(got))


def judge(prefix: str, s: dict, sites, pl: dict, cap: int | None = None,
          keep: dict | None = None) -> dict:
    """Every number of one sample's outputs (see the module's list);
    `keep`, when given, receives the reference's sums."""
    certain, subs = truth_subs(s, sites)
    share, bg = misplaced(pl, s, certain, subs)
    d = dense(pl, s, sites, cap)
    if keep is not None:
        keep.update(d)
    return dict(misplaced_share=share, background_mapped=bg,
                isize_off_share=isize_off(prefix + ".InsertSizeTable", s,
                                          certain),
                dense_off=dense_off(prefix, d, sites),
                pileup_off=pileup_off(prefix, d, sites),
                certain_reads=int(certain.sum()))

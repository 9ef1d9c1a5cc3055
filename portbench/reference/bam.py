"""A plain reader of BAM records (SAM spec section 4.2): BGZF is a run of
gzip members, which Python's gzip module reads as one stream."""

from __future__ import annotations

import gzip
import struct

import numpy as np

# 4-bit base codes "=ACMGRSVTWYHKDBN" -> 0..3 for ACGT, 4 otherwise
_NT16 = np.full(16, 4, np.uint8)
_NT16[[1, 2, 4, 8]] = [0, 1, 2, 3]
_TAG_SIZE = {b"A": 1, b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4,
             b"f": 4}
_INT_FMT = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i",
            b"I": "<I"}


def _tags(buf: bytes, off: int, end: int) -> dict:
    out = {}
    while off < end:
        tag, typ = buf[off:off + 2], buf[off + 2:off + 3]
        off += 3
        if typ in _INT_FMT:
            out[tag] = struct.unpack_from(_INT_FMT[typ], buf, off)[0]
            off += _TAG_SIZE[typ]
        elif typ in _TAG_SIZE:
            off += _TAG_SIZE[typ]
        elif typ in (b"Z", b"H"):
            z = buf.index(b"\0", off)
            out[tag] = buf[off:z].decode()
            off = z + 1
        elif typ == b"B":
            sub = buf[off:off + 1]
            n = struct.unpack_from("<i", buf, off + 1)[0]
            off += 5 + n * _TAG_SIZE[sub]
        else:
            raise ValueError(f"unknown BAM tag type {typ!r}")
    return out


def read_bam(path: str) -> tuple[list[str], list[dict]]:
    """(reference names, records): each record a dict of name, flag, ref
    (index or -1), pos (0-based), mapq, cigar [(op char, length)], seq
    (codes 0..4, uint8), qual (phred, uint8) and NM (or None)."""
    with gzip.open(path, "rb") as fh:
        buf = fh.read()
    if buf[:4] != b"BAM\1":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", buf, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", buf, off)[0]
        refs.append(buf[off + 4:off + 4 + ln - 1].decode())
        off += 8 + ln
    recs = []
    ops = "MIDNSHP=X"
    while off < len(buf):
        size = struct.unpack_from("<i", buf, off)[0]
        (ref, pos, l_name, mapq, _bin, n_cig, flag, l_seq, _nref, _npos,
         _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, off + 4)
        p = off + 36
        name = buf[p:p + l_name - 1].decode()
        p += l_name
        cig = struct.unpack_from(f"<{n_cig}I", buf, p)
        p += 4 * n_cig
        packed = np.frombuffer(buf, np.uint8, (l_seq + 1) // 2, p)
        p += (l_seq + 1) // 2
        hi_lo = np.stack([packed >> 4, packed & 15], axis=1).reshape(-1)
        seq = _NT16[hi_lo[:l_seq]]
        qual = np.frombuffer(buf, np.uint8, l_seq, p).copy()
        p += l_seq
        tags = _tags(buf, p, off + 4 + size)
        recs.append(dict(name=name, flag=flag, ref=ref, pos=pos, mapq=mapq,
                         cigar=[(ops[c & 15], c >> 4) for c in cig],
                         seq=seq, qual=qual, NM=tags.get(b"NM")))
        off += 4 + size
    return refs, recs

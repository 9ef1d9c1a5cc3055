"""BAM record encoding + minimal reader.

Equivalent of the reference's libStatGen BamInterface (misc/bam/) writing
path: binary BAM over BGZF.  Provides record packing for the align stage
and a simple whole-file reader used by pop+con's pileup when given a BAM.
"""

from __future__ import annotations

import struct

import numpy as np

from .bgzf import BgzfWriter, bgzf_read_all

# BAM cigar op codes: MIDNSHP=X
BAM_CIGAR_OPS = "MIDNSHP=X"
# our internal FROM_M/I/D/S codes -> BAM op
FROM_TO_BAM = {0: 0, 1: 1, 2: 2, 3: 4}

SEQ_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}

# ASCII (upper+lowercased) -> 4-bit nibble lookup for fast packing
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in SEQ_NT16.items():
    _NT16_LUT[ord(_c)] = _i
    _NT16_LUT[ord(_c.lower())] = _i


def pack_seq_nibbles(seq: str) -> bytes:
    """4-bit pack a sequence string (vectorized)."""
    codes = _NT16_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


# 2-bit code (0..4 = ACGTN) -> BAM nibble, for the no-string fast path
_CODE_NIBBLE = np.array([1, 2, 4, 8, 15], dtype=np.uint8)


def pack_code_nibbles(codes: np.ndarray) -> bytes:
    """4-bit pack an encoded (0..4) sequence array directly."""
    nib = _CODE_NIBBLE[codes]
    if len(nib) % 2:
        nib = np.concatenate([nib, np.zeros(1, np.uint8)])
    return ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    def __init__(self, path: str, header_text: str,
                 refs: list[tuple[str, int]]):
        self._w = BgzfWriter(path)
        self.tid = {name: i for i, (name, _) in enumerate(refs)}
        # per-writer keyed cigar-bytes cache: (ops) -> (bytes, n, span)
        self._cig_cache: dict[tuple, tuple[bytes, int, int]] = {}
        hdr = header_text.encode()
        out = b"BAM\x01" + struct.pack("<i", len(hdr)) + hdr
        out += struct.pack("<i", len(refs))
        for name, length in refs:
            nm = name.encode() + b"\x00"
            out += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)
        self._w.write(out)

    def write_record(self, qname: str, flag: int, rname: str, pos1: int,
                     mapq: int, cigar: list[tuple[int, int]] | None,
                     rnext: str, pnext1: int, tlen: int, seq, qual,
                     tags: bytes) -> None:
        """pos1/pnext1 are 1-based (0 = unmapped '*').  seq is a str or
        an encoded (0..4) uint8 array; qual a str or phred+33 uint8
        array (the array forms skip a string round-trip).  One shared
        encoder: delegates to the batched write_records."""
        self.write_records([(qname, flag, rname, pos1, mapq, cigar,
                             rnext, pnext1, tlen, seq, qual, tags)])

    # packed record-header prefix (everything before the name), exactly
    # the struct of write_record -- numpy structured dtype, unaligned
    _HDR_DT = np.dtype([("refid", "<i4"), ("pos", "<i4"), ("lname", "u1"),
                        ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"),
                        ("flag", "<u2"), ("lseq", "<i4"), ("nref", "<i4"),
                        ("npos", "<i4"), ("tlen", "<i4")])

    def write_records(self, recs: list[tuple]) -> None:
        """Batched write_record: same per-record bytes, one BGZF write.

        Each item carries write_record's arguments.  The per-record
        struct/numpy packing of write_record dominates the BAM writer
        thread at production scale (~93us/record profiled); batching
        moves the seq/qual nibble+phred packing to one whole-chunk numpy
        pass per read length and the 32-byte headers to one structured
        array, leaving only dict lookups and byte joins per record."""
        n = len(recs)
        if n == 0:
            return
        assert self._HDR_DT.itemsize == 32
        hdr = np.zeros(n, dtype=self._HDR_DT)
        names: list[bytes] = []
        cigs: list[bytes] = []
        tags_l: list[bytes] = []
        sq_l: list[bytes | None] = [None] * n
        ql_l: list[bytes | None] = [None] * n
        # group vectorizable seq/qual rows by read length
        by_len: dict[int, list[int]] = {}
        cig_cache = self._cig_cache
        tid = self.tid
        for i, (qname, flag, rname, pos1, mapq, cigar, rnext, pnext1,
                tlen, seq, qual) in enumerate(
                    (r[:11] for r in recs)):
            tags_l.append(recs[i][11])
            refid = tid.get(rname, -1)
            name = qname.encode() + b"\x00"
            names.append(name)
            if cigar:
                key = tuple(map(tuple, cigar))
                ent = cig_cache.get(key)
                if ent is None:
                    cig = b"".join(
                        struct.pack("<I", (ln << 4) | FROM_TO_BAM[op])
                        for op, ln in cigar)
                    span = sum(ln for op, ln in cigar if op in (0, 2))
                    if len(cig_cache) > 1 << 16:
                        cig_cache.clear()
                    ent = cig_cache.setdefault(key, (cig, len(cigar), span))
                cig, n_cigar, span = ent
            else:
                cig, n_cigar, span = b"", 0, None
            cigs.append(cig)
            if isinstance(seq, np.ndarray):
                l_seq = len(seq)
                by_len.setdefault(l_seq, []).append(i)
            else:
                l_seq = 0 if seq in ("*", "") else len(seq)
                sq_l[i] = pack_seq_nibbles(seq) if l_seq else b""
            if l_seq:
                if qual is None:
                    ql_l[i] = b"\xff" * l_seq
                elif isinstance(qual, str):
                    ql_l[i] = (b"\xff" * l_seq if qual == "*" else
                               (np.frombuffer(qual.encode("latin1"),
                                              dtype=np.uint8)
                                - 33).astype(np.uint8).tobytes())
                elif not isinstance(seq, np.ndarray):
                    # str seq + array qual: no grouped pass for this row
                    ql_l[i] = (qual.astype(np.uint8) - 33).tobytes()
                # ndarray-seq rows' array quals ride the grouped pass
            else:
                sq_l[i] = b""
                ql_l[i] = b""
            pos = pos1 - 1
            if span is not None:
                end = pos + span
            elif l_seq:
                end = pos + l_seq
            else:
                end = pos + 1
            hdr[i] = (refid, pos, len(name), mapq,
                      reg2bin(max(pos, 0), max(end, 1)), n_cigar, flag,
                      l_seq, refid if rnext == "=" else tid.get(rnext, -1),
                      pnext1 - 1, tlen)
        for L, idxs in by_len.items():
            g = len(idxs)
            M = np.empty((g, L), dtype=np.uint8)
            Q = np.empty((g, L), dtype=np.uint8)
            any_q = False
            for k, i in enumerate(idxs):
                M[k] = recs[i][9]
                q = recs[i][10]
                if isinstance(q, np.ndarray):
                    Q[k] = q
                    any_q = True
                elif ql_l[i] is None:  # loud like the unbatched path was
                    raise TypeError(
                        f"unsupported qual type {type(q).__name__}")
            nib = _CODE_NIBBLE[M]
            if L % 2:
                nib = np.concatenate(
                    [nib, np.zeros((g, 1), np.uint8)], axis=1)
            packed = ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8)
            pb = packed.tobytes()
            W = (L + 1) // 2
            qb = (Q - 33).tobytes() if any_q else b""
            for k, i in enumerate(idxs):
                sq_l[i] = pb[k * W:(k + 1) * W]
                if ql_l[i] is None:
                    ql_l[i] = qb[k * L:(k + 1) * L]
        hb = hdr.tobytes()
        parts: list[bytes] = []
        for i in range(n):
            tail = names[i] + cigs[i] + sq_l[i] + ql_l[i] + tags_l[i]
            parts.append((32 + len(tail)).to_bytes(4, "little", signed=True))
            parts.append(hb[32 * i:32 * i + 32])
            parts.append(tail)
        self._w.write(b"".join(parts))

    def close(self) -> None:
        self._w.close()


_TAG_I = struct.Struct("<i").pack
_tag_pre: dict[tuple[str, bytes], bytes] = {}


def _pre(name: str, kind: bytes) -> bytes:
    key = (name, kind)
    v = _tag_pre.get(key)
    if v is None:
        v = _tag_pre.setdefault(key, name.encode() + kind)
    return v


def tag_A(name: str, v: str) -> bytes:
    return _pre(name, b"A") + v.encode()[:1]


def tag_i(name: str, v: int) -> bytes:
    return _pre(name, b"i") + _TAG_I(v)


def tag_Z(name: str, v: str) -> bytes:
    return _pre(name, b"Z") + v.encode() + b"\x00"


class BamReader:
    """Minimal whole-file BAM reader yielding dict records."""

    def __init__(self, path: str):
        data = bgzf_read_all(path)
        assert data[:4] == b"BAM\x01", "not a BAM file"
        (l_text,) = struct.unpack_from("<i", data, 4)
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.refs: list[tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", data, off)
            off += 4
            name = data[off:off + l_name - 1].decode()
            off += l_name
            (l_ref,) = struct.unpack_from("<i", data, off)
            off += 4
            self.refs.append((name, l_ref))
        self.header_text = data[8:8 + l_text].decode(errors="replace")
        self._data = data
        self._off = off

    def __iter__(self):
        data = self._data
        off = self._off
        n = len(data)
        while off + 4 <= n:
            (block,) = struct.unpack_from("<i", data, off)
            off += 4
            rec = data[off:off + block]
            off += block
            (refid, pos, l_qname, mapq, _bin, n_cig, flag, l_seq, nref,
             npos, tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
            p = 32
            qname = rec[p:p + l_qname - 1].decode()
            p += l_qname
            cigar = []
            for _ in range(n_cig):
                (c,) = struct.unpack_from("<I", rec, p)
                p += 4
                cigar.append((BAM_CIGAR_OPS[c & 0xF], c >> 4))
            seq = bytearray()
            for i in range((l_seq + 1) // 2):
                b = rec[p + i]
                seq.append(b >> 4)
                if len(seq) < l_seq:
                    seq.append(b & 0xF)
            p += (l_seq + 1) // 2
            seq_s = "".join("=ACMGRSVTWYHKDBN"[c] for c in seq[:l_seq])
            qual = rec[p:p + l_seq]
            p += l_seq
            yield {
                "qname": qname, "flag": flag, "refid": refid, "pos": pos,
                "mapq": mapq, "cigar": cigar, "seq": seq_s,
                "qual": bytes(qual), "next_refid": nref, "next_pos": npos,
                "tlen": tlen, "tags_raw": rec[p:],
            }

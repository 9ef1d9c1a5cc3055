"""Gapped refinement, MD/NM computation, trimming correction.

Equivalents of refine_gapped_core (reference libbwa/bwase.c:183-232),
bwa_cal_md1 (:234-296), bwa_correct_trimmed (:298-337),
bwa_refine_gapped (:339-417) and pos_end (:419-433), operating on the
unpacked text codes instead of the 2-bit .pac."""

from __future__ import annotations

import numpy as np

from .dp import FROM_D, FROM_I, FROM_M, FROM_S, global_cigar

Cigar = list[tuple[int, int]]  # [(op, len)] with FROM_* ops


def refine_gapped_core(text: np.ndarray, length: int, seq: np.ndarray,
                       pos: int, ext: int) -> tuple[Cigar, int]:
    """bwase.c:183-232 with is_end_correct == 1.  Returns (cigar, new_pos).

    NB: the C keeps ``__pos = *_pos`` (the pre-refine coordinate) and,
    for ext < 0, adjusts it only by the net I-D shift of the cigar --
    it does NOT rebase to the extracted window start (the window is
    end-anchored at pos+len, so its start is pos - |ext|).  Round 4's
    SAM differential vs the compiled reference caught this repo
    rebasing to the window start, shifting forward-strand gapped reads
    by |ext|; parity restored here."""
    l_pac = len(text)
    if pos > l_pac:  # bwase.c:192 quirk: wrapped bwtint reinterpreted
        pos = np.int64(np.int32(np.uint64(pos) & 0xFFFFFFFF))
    ref_len = length + abs(ext)
    if ext > 0:
        lo = pos
        hi = min(pos + ref_len, l_pac)
    else:
        x = pos + length  # is_end_correct
        lo = max(x - ref_len, 0)
        hi = min(x, l_pac)
    ref_seq = text[lo:hi]
    cigar = global_cigar(ref_seq, seq[:length])
    new_pos = pos

    if ext < 0:  # fix coordinate for forward-strand reads
        shift = 0
        for op, ln in cigar:
            if op == FROM_D:
                shift -= ln
            elif op == FROM_I:
                shift += ln
        new_pos += shift

    if cigar and cigar[0][0] == FROM_D:  # 5'-end deletion
        new_pos += cigar[0][1]
        cigar = cigar[1:]
    if cigar and cigar[-1][0] == FROM_D:  # 3'-end deletion
        cigar = cigar[:-1]
    # I at either end becomes S
    if cigar and cigar[-1][0] == FROM_I:
        cigar[-1] = (FROM_S, cigar[-1][1])
    if cigar and cigar[0][0] == FROM_I:
        cigar[0] = (FROM_S, cigar[0][1])
    return cigar, new_pos


try:
    import ctypes as _ct

    _MD_BUF = _ct.create_string_buffer(4096)
except Exception:  # pragma: no cover
    _MD_BUF = b""


def bwa_cal_md1(cigar: Cigar | None, length: int, pos: int, seq: np.ndarray,
                text: np.ndarray) -> tuple[str, int]:
    """MD string + NM (bwase.c:234-296); native fast path."""
    from ..native import get_sw_lib

    lib = get_sw_lib()
    if lib is not None:
        import ctypes

        n_cig = len(cigar) if cigar else 0
        cig = np.array([(op << 28) | ln for op, ln in (cigar or [])],
                       dtype=np.uint32)
        seq_c = np.ascontiguousarray(seq, dtype=np.uint8)
        cap = 2 * length + 32
        global _MD_BUF
        if len(_MD_BUF) < cap:  # reused scratch; md_nm NUL-terminates
            _MD_BUF = ctypes.create_string_buffer(max(cap, 4096))
        buf = _MD_BUF
        cp = ctypes.c_void_p
        nm = lib.md_nm(cig.ctypes.data_as(cp), n_cig, length, int(pos),
                       seq_c.ctypes.data_as(cp),
                       text.ctypes.data_as(cp), len(text), buf, cap)
        if nm >= 0:
            return buf.value.decode("ascii"), nm
    return _bwa_cal_md1_py(cigar, length, pos, seq, text)


def bwa_cal_md1_batch(items, text: np.ndarray) -> None:
    """Set s.md, s.nm for each (read, oriented-seq) pair with ONE native
    md_nm_batch call (flattened cigars/seqs); the per-read ctypes +
    numpy marshalling of bwa_cal_md1 dominates at batch scale."""
    from ..native import get_sw_lib

    lib = get_sw_lib()
    n = len(items)
    if n == 0:
        return
    if lib is None or not hasattr(lib, "md_nm_batch"):
        for s, seq in items:
            s.md, s.nm = _bwa_cal_md1_py(s.cigar, s.len, s.pos, seq, text)
        return
    import ctypes

    cig_off = np.zeros(n, np.int64)
    cig_n = np.zeros(n, np.int32)
    lens = np.zeros(n, np.int32)
    poses = np.zeros(n, np.int64)
    seq_off = np.zeros(n, np.int64)
    cig_flat: list[int] = []
    seq_parts = []
    off = 0
    maxlen = 1
    for i, (s, seq) in enumerate(items):
        c = s.cigar
        if c:
            cig_off[i] = len(cig_flat)
            cig_n[i] = len(c)
            for op, ln in c:
                cig_flat.append((op << 28) | ln)
        lens[i] = s.len
        poses[i] = s.pos
        seq_off[i] = off
        seq_parts.append(np.ascontiguousarray(seq[: s.len], dtype=np.uint8))
        off += s.len
        if s.len > maxlen:
            maxlen = s.len
    seqs = (np.concatenate(seq_parts) if seq_parts
            else np.zeros(1, np.uint8))
    cig = np.asarray(cig_flat, dtype=np.uint32)
    if cig.size == 0:
        cig = np.zeros(1, np.uint32)
    stride = 2 * maxlen + 32
    buf = ctypes.create_string_buffer(n * stride)
    nm = np.zeros(n, np.int32)
    cp = ctypes.c_void_p
    lib.md_nm_batch(
        cig.ctypes.data_as(cp), cig_off.ctypes.data_as(cp),
        cig_n.ctypes.data_as(cp), seqs.ctypes.data_as(cp),
        seq_off.ctypes.data_as(cp), lens.ctypes.data_as(cp),
        poses.ctypes.data_as(cp), text.ctypes.data_as(cp),
        len(text), buf, stride, nm.ctypes.data_as(cp), n)
    raw = buf.raw
    for i, (s, seq) in enumerate(items):
        v = int(nm[i])
        if v < 0:  # cap overflow: per-read fallback (never with 2L+32)
            s.md, s.nm = _bwa_cal_md1_py(s.cigar, s.len, s.pos, seq, text)
        else:
            o = i * stride
            s.md = raw[o:raw.index(0, o)].decode("ascii")
            s.nm = v


def _bwa_cal_md1_py(cigar: Cigar | None, length: int, pos: int,
                    seq: np.ndarray, text: np.ndarray) -> tuple[str, int]:
    """Pure-python MD/NM (reference implementation + fallback)."""
    l_pac = len(text)
    x, y = pos, 0
    nm = 0
    u = 0
    out: list[str] = []
    if cigar:
        for op, ln in cigar:
            if op == FROM_M:
                for z in range(ln):
                    if x + z >= l_pac:
                        break
                    c = int(text[x + z])
                    if c > 3 or int(seq[y + z]) > 3 or c != int(seq[y + z]):
                        out.append(str(u))
                        out.append("ACGTN"[c])
                        nm += 1
                        u = 0
                    else:
                        u += 1
                x += ln
                y += ln
            elif op in (FROM_I, FROM_S):
                y += ln
                if op == FROM_I:
                    nm += ln
            elif op == FROM_D:
                out.append(str(u))
                out.append("^")
                for z in range(ln):
                    if x + z >= l_pac:
                        break
                    out.append("ACGT"[int(text[x + z])])
                u = 0
                x += ln
                nm += ln
    else:
        for z in range(length):
            c = int(text[x + z]) if x + z < l_pac else 4
            if c > 3 or int(seq[y + z]) > 3 or c != int(seq[y + z]):
                out.append(str(u))
                out.append("ACGTN"[c])
                nm += 1
                u = 0
            else:
                u += 1
    out.append(str(u))
    return "".join(out), nm


def bwa_correct_trimmed(s) -> None:
    """bwase.c:298-337: re-extend quality-trimmed reads with soft clips."""
    if s.len == s.full_len:
        return
    clip = s.full_len - s.len
    if s.strand == 0:
        if s.cigar and s.cigar[-1][0] == FROM_S:
            s.cigar[-1] = (FROM_S, s.cigar[-1][1] + clip)
        else:
            if s.cigar is None:
                s.cigar = [(FROM_M, s.len)]
            s.cigar = s.cigar + [(FROM_S, clip)]
    else:
        if s.cigar and s.cigar[0][0] == FROM_S:
            s.cigar[0] = (FROM_S, s.cigar[0][1] + clip)
        else:
            if s.cigar is None:
                s.cigar = [(FROM_M, s.len)]
            s.cigar = [(FROM_S, clip)] + s.cigar
    s.len = s.full_len


def pos_end(p) -> int:
    """bwase.c:419-433."""
    if p.cigar:
        x = p.pos
        for op, ln in p.cigar:
            if op in (FROM_M, FROM_D):
                x += ln
        return x
    return p.pos + p.len


def pos_end_multi(q, length: int) -> int:
    if q.cigar:
        x = q.pos
        for op, ln in q.cigar:
            if op in (FROM_M, FROM_D):
                x += ln
        return x
    return q.pos + length


def cigar_string(cigar: Cigar | None, length: int) -> str:
    if not cigar:
        return f"{length}M"
    return "".join(f"{ln}{'MIDS'[op]}" for op, ln in cigar)

"""FASTA random access with .fai indexes.

Equivalent of the reference's vendored faidx (misc/faidx.c: fai_load,
fai_build, fai_fetch).  Supports plain (uncompressed) FASTA.  Regions use
samtools syntax ``chrom:start-end`` with 1-based inclusive coordinates;
out-of-range coordinates are clamped like fai_fetch does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int  # file offset of first base
    line_bases: int
    line_bytes: int


class FastaFile:
    """Random-access FASTA reader backed by a .fai index (built if absent)."""

    def __init__(self, path: str):
        self.path = path
        self.entries: dict[str, FaiEntry] = {}
        self.order: list[str] = []
        fai = path + ".fai"
        if not os.path.exists(fai):
            build_fai(path, fai)
        with open(fai) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                e = FaiEntry(parts[0], int(parts[1]), int(parts[2]), int(parts[3]), int(parts[4]))
                self.entries[e.name] = e
                self.order.append(e.name)
        self._fh = open(path, "rb")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def has(self, name: str) -> bool:
        return name in self.entries

    def fetch(self, chrom: str, start: int, end: int) -> str | None:
        """Fetch [start, end] 1-based inclusive; clamps to sequence bounds.

        Returns None if chrom is absent (caller may retry with a 'chr'
        prefix, mirroring RefBuilder ExtractSeq reference
        src/RefBuilder.cpp:19-36).
        """
        e = self.entries.get(chrom)
        if e is None:
            return None
        beg = max(1, start) - 1  # 0-based
        fin = min(e.length, end)  # inclusive 1-based => exclusive 0-based
        if beg >= fin:
            return ""
        # translate sequence offset -> file offset accounting for newlines
        first_line = beg // e.line_bases
        self._fh.seek(e.offset + first_line * e.line_bytes + (beg % e.line_bases))
        need = fin - beg
        raw = self._fh.read(need + (need // e.line_bases + 2) * (e.line_bytes - e.line_bases))
        # C-speed newline strip; the first `need` non-newline bytes are
        # in-sequence (fin is clamped to the record), so any trailing
        # next-record bytes in the over-read fall off the slice
        return raw.translate(None, b"\r\n")[:need].decode("ascii")

    def fetch_region(self, chrom: str, start: int, end: int) -> str:
        """fai_fetch with the reference's chr-prefix fallback; raises if absent."""
        seq = self.fetch(chrom, start, end)
        if seq is None:
            seq = self.fetch("chr" + chrom, start, end)
        if seq is None:
            from ..utils.logging import error

            error("Cannot find %s:%d-%d from the reference file!", chrom, start, end)
        return seq


def build_fai(path: str, fai_path: str | None = None) -> list[FaiEntry]:
    """Build a samtools-compatible .fai for an uncompressed FASTA."""
    entries: list[FaiEntry] = []
    name = None
    length = 0
    offset = 0
    line_bases = 0
    line_bytes = 0
    first_line = True
    with open(path, "rb") as fh:
        while True:
            line_off = fh.tell()
            line = fh.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append(FaiEntry(name, length, offset, line_bases, line_bytes))
                name = line[1:].split()[0].decode("ascii")
                length = 0
                offset = fh.tell()
                line_bases = 0
                line_bytes = 0
                first_line = True
            else:
                stripped = line.rstrip(b"\r\n")
                if first_line and stripped:
                    line_bases = len(stripped)
                    line_bytes = len(line)
                    first_line = False
                length += len(stripped)
    if name is not None:
        entries.append(FaiEntry(name, length, offset, line_bases, line_bytes))
    if fai_path:
        with open(fai_path, "w") as out:
            for e in entries:
                out.write(f"{e.name}\t{e.length}\t{e.offset}\t{e.line_bases}\t{e.line_bytes}\n")
    return entries


def read_fasta(path: str) -> list[tuple[str, str]]:
    """Read all (name, seq) pairs from an uncompressed FASTA."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    out: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    with opener(path, "rt") as fh:
        for line in fh:
            line = line.rstrip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                # header after '>' up to first whitespace
                name = line[1:].split()[0]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, "".join(chunks)))
    return out

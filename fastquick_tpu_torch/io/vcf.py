"""Minimal VCF reader/writer (plain or gzip/BGZF text).

Equivalent of the reference's vendored libStatGen VCF layer (misc/vcf/:
VcfFileReader, VcfRecord, VcfHeader) restricted to what the pipeline needs:
site records with INFO parsing, header metadata lines, and round-trip
writing.  BGZF files are valid multi-member gzip streams, so Python's gzip
handles both.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Iterator


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 1-based
    id: str
    ref: str
    alt: str
    qual: str
    filter: str
    info: str
    rest: list[str] = field(default_factory=list)  # FORMAT + sample columns

    _info_cache: dict | None = None

    def info_dict(self) -> dict[str, str]:
        if self._info_cache is None:
            d: dict[str, str] = {}
            if self.info not in (".", ""):
                for item in self.info.split(";"):
                    if "=" in item:
                        k, v = item.split("=", 1)
                        d[k] = v
                    else:
                        d[item] = ""
            self._info_cache = d
        return self._info_cache

    def get_af(self) -> float | None:
        """INFO/AF as float, or None if absent (Skip() gate,
        reference src/RefBuilder.cpp:80-88; stod stops at first non-numeric
        so comma-separated AF lists take the first value)."""
        s = self.info_dict().get("AF")
        if s is None:
            return None
        # std::stod semantics: parse leading float, ignore trailing chars
        num = ""
        for ch in s:
            if ch.isdigit() or ch in ".+-eE":
                num += ch
            else:
                break
        try:
            return float(num)
        except ValueError:
            return None

    @property
    def alts(self) -> list[str]:
        return self.alt.split(",")

    def to_line(self) -> str:
        cols = [self.chrom, str(self.pos), self.id, self.ref, self.alt,
                self.qual, self.filter, self.info] + self.rest
        return "\t".join(cols)


class VcfReader:
    """Streaming site-record reader; header lines collected on open."""

    def __init__(self, path: str):
        self.path = path
        self._fh = _open_text(path)
        self.meta_lines: list[str] = []  # '##...' lines
        self.header_line: str = ""  # '#CHROM...'
        self.samples: list[str] = []
        pos = None
        while True:
            line = self._fh.readline()
            if not line:
                break
            if line.startswith("##"):
                self.meta_lines.append(line.rstrip("\n"))
            elif line.startswith("#"):
                self.header_line = line.rstrip("\n")
                cols = self.header_line.split("\t")
                if len(cols) > 9:
                    self.samples = cols[9:]
                break
            else:
                # headerless VCF; push back by re-opening
                self._pushback = line
                break
        self._pushback: str | None = getattr(self, "_pushback", None)

    def __iter__(self) -> Iterator[VcfRecord]:
        if self._pushback is not None:
            line, self._pushback = self._pushback, None
            rec = parse_vcf_line(line)
            if rec:
                yield rec
        for line in self._fh:
            rec = parse_vcf_line(line)
            if rec:
                yield rec

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_vcf_line(line: str) -> VcfRecord | None:
    line = line.rstrip("\n")
    if not line or line.startswith("#"):
        return None
    c = line.split("\t")
    if len(c) < 8:
        c = c + ["."] * (8 - len(c))
    return VcfRecord(c[0], int(c[1]), c[2], c[3], c[4], c[5], c[6], c[7], c[8:])


def normalize_chrom(chrom: str) -> str:
    """Uppercase and strip a leading 'chr' (reference src/RefBuilder.cpp:343-347)."""
    c = chrom.upper()
    if "CHR" in c:
        c = c[3:]
    return c


def write_vcf(path: str, meta_lines: list[str], header_line: str,
              records: list[VcfRecord]) -> None:
    with open(path, "w") as out:
        for m in meta_lines:
            out.write(m + "\n")
        if header_line:
            out.write(header_line + "\n")
        for r in records:
            out.write(r.to_line() + "\n")

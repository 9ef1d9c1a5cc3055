"""BGZF blocked-gzip writer/reader (the BAM container framing).

Equivalent of the reference's BGZF layer (libStatGen InputFile BGZF mode,
misc/bam/BamInterface writing).  Each block is an independent gzip member
with a BSIZE extra field; EOF is the fixed 28-byte empty block.
"""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes([
    0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xFF, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1B, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00,
])

MAX_BLOCK = 65280


class BgzfWriter:
    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK:
            self._flush_block(self._buf[:MAX_BLOCK])
            del self._buf[:MAX_BLOCK]

    def _flush_block(self, chunk: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = co.compress(bytes(chunk)) + co.flush()
        bsize = len(comp) + 25 + 1
        header = struct.pack(
            "<BBBBIBBHBBHH",
            0x1F, 0x8B, 0x08, 0x04, 0, 0, 0xFF, 6, 0x42, 0x43, 2, bsize)
        footer = struct.pack("<II", zlib.crc32(bytes(chunk)) & 0xFFFFFFFF,
                             len(chunk))
        self._fh.write(header + comp + footer)

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()


def bgzf_read_all(path: str) -> bytes:
    """Read a whole BGZF file (gzip handles concatenated members)."""
    import gzip

    with gzip.open(path, "rb") as fh:
        return fh.read()

"""Binary per-position GC-content records.

Equivalent of the reference's _GCstruct (src/Utility.h:31-68): each record
is ``uint32 len`` followed by ``len`` uint8 GC counts (count of G/C bases in
the 100bp window centered at each flank position).  One record per marker,
concatenated in marker order into the ``.gc`` file.
"""

from __future__ import annotations

import struct

import numpy as np


def write_gc_records(path: str, records: list[np.ndarray]) -> None:
    with open(path, "wb") as out:
        for gc in records:
            arr = np.asarray(gc, dtype=np.uint8)
            out.write(struct.pack("<I", arr.size))
            out.write(arr.tobytes())


def read_gc_records(path: str) -> list[np.ndarray]:
    out: list[np.ndarray] = []
    with open(path, "rb") as fh:
        while True:
            hdr = fh.read(4)
            if len(hdr) < 4:
                break
            (n,) = struct.unpack("<I", hdr)
            out.append(np.frombuffer(fh.read(n), dtype=np.uint8).copy())
    return out

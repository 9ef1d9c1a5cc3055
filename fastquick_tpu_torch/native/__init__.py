"""Native (C++) runtime components, built on demand with g++.

The reference's data loader is C (libbwa kseq + zlib); this package holds
the TPU-native equivalents, exposed through ctypes (no pybind11 in the
environment).  Falls back to the pure-Python paths when no compiler is
available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "_fastq_loader.so")
_SRC = os.path.join(_HERE, "fastq_loader.cpp")
_ALN_SO = os.path.join(_HERE, "_aligner.so")
_ALN_SRC = os.path.join(_HERE, "aligner.cpp")
_SW_SO = os.path.join(_HERE, "_sw.so")
_SW_SRC = os.path.join(_HERE, "sw.cpp")

_lib = None
_tried = False
_aln_lib = None
_aln_tried = False
_sw_lib = None
_sw_tried = False


def get_sw_lib():
    """Build (once) and load the native DP aligners; None if unavailable."""
    global _sw_lib, _sw_tried
    if _sw_lib is not None or _sw_tried:
        return _sw_lib
    _sw_tried = True
    try:
        if (not os.path.exists(_SW_SO)
                or os.path.getmtime(_SW_SO) < os.path.getmtime(_SW_SRC)):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-pthread", "-o", _SW_SO, _SW_SRC],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_SW_SO)
        lib.sw_global.restype = ctypes.c_longlong
        lib.sw_global.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
        lib.sw_local.restype = ctypes.c_longlong
        lib.sw_local.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p]
        lib.sw_local_batch.restype = None
        lib.sw_local_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.set_bits.restype = None
        lib.set_bits.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong]
        lib.set_bits32.restype = None
        lib.set_bits32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong]
        lib.md_nm.restype = ctypes.c_int
        lib.md_nm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_char_p, ctypes.c_int]
        lib.md_nm_batch.restype = None
        lib.md_nm_batch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        _sw_lib = lib
    except Exception as e:  # pragma: no cover
        print(f"[fastquick_tpu_torch.native] native sw unavailable: {e}",
              file=sys.stderr)
        _sw_lib = None
    return _sw_lib


def get_aligner_lib():
    """Build (once) and load the native aligner; None if unavailable."""
    global _aln_lib, _aln_tried
    if _aln_lib is not None or _aln_tried:
        return _aln_lib
    _aln_tried = True
    try:
        if (not os.path.exists(_ALN_SO)
                or os.path.getmtime(_ALN_SO) < os.path.getmtime(_ALN_SRC)):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-pthread", "-o", _ALN_SO, _ALN_SRC],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_ALN_SO)
        lib.aln_create.restype = ctypes.c_void_p
        lib.aln_create.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int32] \
            + [ctypes.c_void_p] * 4 + [ctypes.c_int32, ctypes.c_int64]
        lib.aln_destroy.argtypes = [ctypes.c_void_p]
        lib.aln_batch.restype = None
        lib.aln_batch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p] + [ctypes.c_int] * 13
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
        _aln_lib = lib
    except Exception as e:  # pragma: no cover
        print(f"[fastquick_tpu_torch.native] native aligner unavailable: {e}",
              file=sys.stderr)
        _aln_lib = None
    return _aln_lib


def get_lib():
    """Build (once) and load the native loader; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC, "-lz"],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_SO)
        lib.fq_open.restype = ctypes.c_void_p
        lib.fq_open.argtypes = [ctypes.c_char_p]
        lib.fq_close.argtypes = [ctypes.c_void_p]
        lib.fq_read_batch.restype = ctypes.c_int
        lib.fq_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.fq_trim_len.restype = ctypes.c_int
        lib.fq_trim_len.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int]
        _lib = lib
    except Exception as e:  # pragma: no cover - environment dependent
        print(f"[fastquick_tpu_torch.native] native loader unavailable: {e}",
              file=sys.stderr)
        _lib = None
    return _lib

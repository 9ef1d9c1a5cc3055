"""Build and load the port's kernels at first use.

The CUDA sources in ``fastquick_tpu_torch/csrc/*.cu`` are compiled with
nvcc for ``sm_90a`` (one nvcc per source, all started together), linked
into one shared library with a plain C interface and loaded with ctypes.
The library goes to ``build/fastquick_tpu_torch/<hash of the sources>/``
at the repository root, so a changed source is rebuilt and an unchanged
one is reused.  A failed build raises; nothing falls back to the plain
versions.

``host_library()`` builds the same per-item bodies with g++ (csrc/
host_kernels.cpp) for the CPU tests.

Each kernel wrapper adds one to ``launch_counts[name]`` where it launches
its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "fastquick_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

# "search_chain": the resident search kernel's chain-length build (CH > 1);
# "search_retry": its retry entry (ops/host_redo.py), at any CH
launch_counts = {"width": 0, "search": 0, "search_chain": 0,
                 "search_retry": 0, "scan": 0, "sw": 0, "drand48": 0,
                 "pairing": 0, "accumulate": 0, "pileup": 0}
build_info: dict = {}

_lock = threading.Lock()
_cuda_lib = None
_host_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# fq_pairing_launch's and fq_pairing_host's inputs (csrc/pairing_body.cuh
# FQ_PAIR_IN_ARGS); the outputs, the scratch (and the launch's stream)
# follow
_PAIRING_ARGS = ([_I, _I] + [_P] * 7 + [_L, _P, _L, _P, _P, _P, _P]
                 + [_I, _L, _I, _I])
# the accumulation kernels' inputs (csrc/accumulate_body.cuh
# FQ_ACC_IN_ARGS); then the walk's out, zero_out, ent, counts and M, or
# the order's marker_base, M, cap, ent, counts, pileup, off and bucket
# (and the launch's stream; the walk's host build takes its grid first)
_ACC_ARGS = [_P] * 12 + [_L] + [_I] * 4
_WALK_ARGS = [_P, _I, _P, _P, _I]
_ORDER_ARGS = [_P, _I, _I] + [_P] * 5


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".cpp"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return found


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def _build_cuda(out: Path) -> None:
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp, src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = []
        for src, obj, p in procs:
            so, se = p.communicate()
            logs.append(f"== {src.name}\n{so}{se}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{so}{se}")
        tmp_so = Path(tmp, out.name)
        r = _run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                  "-shared", "-o", str(tmp_so)]
                 + [str(obj) for _, obj, _ in procs])
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
        (out.parent / "ptxas.txt").write_text("\n".join(logs))
        os.replace(tmp_so, out)
    build_info["cuda_build_s"] = time.perf_counter() - t0


def _build_host(out: Path) -> None:
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_so = Path(tmp, out.name)
        r = _run(["g++", *GXX_FLAGS, "-I", str(CSRC), "-o", str(tmp_so),
                  str(CSRC / "host_kernels.cpp")])
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on host_kernels.cpp:\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp_so, out)


def cuda_library() -> ctypes.CDLL:
    """The nvcc-built kernel library (built on first call)."""
    global _cuda_lib
    with _lock:
        if _cuda_lib is None:
            d = BUILD_ROOT / source_hash()
            d.mkdir(parents=True, exist_ok=True)
            out = d / "libfq_kernels.so"
            if not out.exists():
                _build_cuda(out)
            build_info["cuda_dir"] = str(d)
            lib = ctypes.CDLL(str(out))
            lib.fq_width_launch.restype = _I
            lib.fq_width_launch.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P,
                                            _P]
            lib.fq_search_launch.restype = _I
            lib.fq_search_launch.argtypes = ([_P] * 8 + [_I] + [_P] * 10)
            lib.fq_search_retry_launch.restype = _I
            lib.fq_search_retry_launch.argtypes = \
                lib.fq_search_launch.argtypes
            lib.fq_scan_launch.restype = _I
            lib.fq_scan_launch.argtypes = ([_P] * 8 + [_I] + [_P] * 8
                                           + [_I] * 3 + [_P] * 3)
            lib.fq_scan_max_lanes.restype = _I
            lib.fq_scan_max_lanes.argtypes = []
            lib.fq_sw_launch.restype = _I
            lib.fq_sw_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P] * 2
            lib.fq_drand48_launch.restype = _I
            lib.fq_drand48_launch.argtypes = [_P, _P, _I] + [_P] * 5
            lib.fq_pairing_launch.restype = _I
            lib.fq_pairing_launch.argtypes = _PAIRING_ARGS + [_P] * 5
            lib.fq_accum_walk_launch.restype = _I
            lib.fq_accum_walk_launch.argtypes = _ACC_ARGS + _WALK_ARGS + [_P]
            lib.fq_accum_order_launch.restype = _I
            lib.fq_accum_order_launch.argtypes = (_ACC_ARGS + _ORDER_ARGS
                                                  + [_P])
            _cuda_lib = lib
        return _cuda_lib


def host_library() -> ctypes.CDLL:
    """The g++ build of the kernels' bodies (CPU tests only)."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            d = BUILD_ROOT / source_hash()
            d.mkdir(parents=True, exist_ok=True)
            out = d / "libfq_host.so"
            if not out.exists():
                _build_host(out)
            lib = ctypes.CDLL(str(out))
            lib.fq_width_host.restype = _I
            lib.fq_width_host.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P]
            lib.fq_search_host.restype = _I
            lib.fq_search_host.argtypes = ([_P] * 8 + [_I] + [_P] * 8)
            lib.fq_scan_host.restype = _I
            lib.fq_scan_host.argtypes = ([_P] * 8 + [_I] + [_P] * 6
                                         + [_I] * 3 + [_P])
            lib.fq_sw_host.restype = _I
            lib.fq_sw_host.argtypes = [_P] * 4 + [_I] * 3 + [_P]
            lib.fq_drand48_host.restype = _I
            lib.fq_drand48_host.argtypes = [_P, _P, _I] + [_P] * 4
            lib.fq_pairing_host.restype = _I
            lib.fq_pairing_host.argtypes = _PAIRING_ARGS + [_P] * 4
            lib.fq_accum_walk_host.restype = _I
            lib.fq_accum_walk_host.argtypes = _ACC_ARGS + [_I] + _WALK_ARGS
            lib.fq_accum_order_host.restype = _I
            lib.fq_accum_order_host.argtypes = _ACC_ARGS + _ORDER_ARGS
            _host_lib = lib
        return _host_lib


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer as a ctypes pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(*tensors) -> None:
    """Raise unless every tensor lies on a CUDA device."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("kernel inputs must all lie on the CUDA device")


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaGetLastError() code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")

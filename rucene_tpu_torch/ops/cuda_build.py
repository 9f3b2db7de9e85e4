"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source for sm_90a into one shared library with a plain
C interface, cached in the gitignored ``rucene_tpu_torch/build/`` under a
hash of the sources and flags; ctypes loads it. Nothing here runs at
import time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
build_log = ""  # nvcc's output of the build this process made, if any

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p)
    "rtt_decode_blocks": [_P] * 9 + [ctypes.c_int64, ctypes.c_int, _P],
    "rtt_decode_score_blocks": [_P] * 11 + [ctypes.c_int64, _P],
    "rtt_combine_lanes": [_P] * 7 + [ctypes.c_int] * 3 + [ctypes.c_int64, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def kernels():
    """The loaded kernel library (built on the first call)."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = sorted(
        os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR) if f.endswith(".cu")
    )
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"rtt_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
            capture_output=True, text=True, timeout=600,
        )
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel entry."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")

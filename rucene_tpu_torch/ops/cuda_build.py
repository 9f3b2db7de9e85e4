"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

One nvcc per source, all started together, compiles each for sm_90a; a
last nvcc links the objects into one shared library with a plain C
interface, cached in the gitignored ``rucene_tpu_torch/build/`` under a
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""  # nvcc's output of the build this process made, if any

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p)
    "rtt_decode_blocks": [_P] * 9 + [ctypes.c_int64, ctypes.c_int, _P],
    "rtt_decode_score_blocks": [_P] * 11 + [ctypes.c_int64, _P],
    "rtt_combine_lanes": [_P] * 8 + [ctypes.c_int] * 3 + [ctypes.c_int64, _P],
    "rtt_segment_sum_ordered": [_P] * 4 + [ctypes.c_int64, _P],
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
        tmp = f"{so_path}.{os.getpid()}"
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
        procs = [
            subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)
        ]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        link = None
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run(
                [_nvcc(), *ARCH_FLAGS, "-shared", "-o", f"{tmp}.so", *objs],
                capture_output=True, text=True, timeout=600,
            )
            logs.append(link.stdout + link.stderr)
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        build_log = "".join(logs)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(f"{tmp}.so", so_path)
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

"""ctypes bindings for the native runtime (native/rucene_native.cpp).

Builds the shared library on first import with g++ (cached in
native/build/, keyed by source hash) and degrades gracefully to the pure
Python paths when no toolchain is available: `available` is False and
callers must check it.

Port changes (held against rucene_tpu/native/__init__.py by
tests/test_torch_host.py): it builds the same native/*.cpp sources, but
into a gitignored directory of its own.
- _BUILD_DIR: rucene_tpu_torch/native/build instead of native/build.
- _build_and_load: g++ writes a file named for its process, which
  os.replace then moves into place. The directory is not committed, so
  every test worker of a fresh checkout builds at once; with one shared
  temporary name a worker could find its output moved or rewritten under
  it and run without the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRCS = [
    os.path.join(_HERE, "native", "rucene_native.cpp"),
    os.path.join(_HERE, "native", "scalar_engine.cpp"),
]
# the port's own build directory: native/build/ holds libraries built with
# -march=native on other hosts, which may not run on this one
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

_lib = None
available = False


def _build_and_load():
    global _lib, available
    srcs = [s for s in _SRCS if os.path.exists(s)]
    if not srcs:
        return
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"rucene_native_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                 *srcs, "-o", tmp],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, OSError):
            return
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return

    lib.rtpu_inv_create.restype = ctypes.c_void_p
    lib.rtpu_inv_free.argtypes = [ctypes.c_void_p]
    lib.rtpu_inv_add_doc.restype = ctypes.c_int32
    lib.rtpu_inv_add_doc.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.rtpu_inv_add_docs.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32),
    ]
    for name in ("rtpu_inv_num_terms", "rtpu_inv_term_bytes_len",
                 "rtpu_inv_num_postings", "rtpu_inv_num_positions"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.rtpu_inv_export.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint8), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
    ]
    lib.rtpu_lz4_compress.restype = ctypes.c_int64
    lib.rtpu_lz4_compress.argtypes = [
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64,
    ]
    lib.rtpu_lz4_decompress.restype = ctypes.c_int64
    lib.rtpu_lz4_decompress.argtypes = [
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64,
    ]
    if hasattr(lib, "rtpu_scalar_search"):
        lib.rtpu_scalar_search.restype = ctypes.c_int32
        lib.rtpu_scalar_search.argtypes = [
            np.ctypeslib.ndpointer(np.uint32),  # data
            np.ctypeslib.ndpointer(np.int32),   # blk_off
            np.ctypeslib.ndpointer(np.int32),   # blk_doc_bits
            np.ctypeslib.ndpointer(np.int32),   # blk_freq_bits
            np.ctypeslib.ndpointer(np.int32),   # blk_base
            np.ctypeslib.ndpointer(np.int32),   # blk_count
            np.ctypeslib.ndpointer(np.int32),   # blk_last
            np.ctypeslib.ndpointer(np.int32),   # blk_pos_base
            np.ctypeslib.ndpointer(np.uint32),  # positions
            ctypes.POINTER(ctypes.c_uint8),     # live (nullable)
            ctypes.c_int32,                     # max_doc
            np.ctypeslib.ndpointer(np.float32),  # caches [R,256]
            ctypes.c_int32,                     # n_queries
            np.ctypeslib.ndpointer(np.int64),   # q_clause_start
            np.ctypeslib.ndpointer(np.int32),   # q_min_should
            np.ctypeslib.ndpointer(np.uint8),   # q_match_all
            np.ctypeslib.ndpointer(np.float32),  # q_boost
            np.ctypeslib.ndpointer(np.int32),   # c_block_start
            np.ctypeslib.ndpointer(np.int32),   # c_block_count
            np.ctypeslib.ndpointer(np.float32),  # c_weight
            np.ctypeslib.ndpointer(np.uint8),   # c_occur
            np.ctypeslib.ndpointer(np.int32),   # c_cache_idx
            np.ctypeslib.ndpointer(np.int32),   # c_phrase_id
            np.ctypeslib.ndpointer(np.int32),   # c_pos_width
            np.ctypeslib.ndpointer(np.int64),   # c_pos_word_start
            ctypes.c_int32,                     # k
            np.ctypeslib.ndpointer(np.int32),   # out_docs
            np.ctypeslib.ndpointer(np.float32),  # out_scores
            np.ctypeslib.ndpointer(np.int64),   # out_totals
        ]
    _lib = lib
    available = True


_build_and_load()


class NativeInverter:
    """Handle over the C++ inversion accumulator for one field."""

    def __init__(self):
        if not available:
            raise RuntimeError("native library unavailable")
        self._h = ctypes.c_void_p(_lib.rtpu_inv_create())

    def add_doc(self, doc_id: int, text: bytes, lowercase: bool, base_pos: int = 0) -> int:
        """Returns the token count (field-length contribution)."""
        return _lib.rtpu_inv_add_doc(
            self._h, doc_id, text, len(text), 1 if lowercase else 0, base_pos
        )

    def add_docs(self, doc_ids: np.ndarray, concat: bytes, offsets: np.ndarray,
                 lowercase: bool) -> np.ndarray:
        """Bulk add: one C call for a chunk of docs; returns token counts."""
        n = len(doc_ids)
        counts = np.zeros(n, np.int32)
        _lib.rtpu_inv_add_docs(
            self._h, concat, offsets.astype(np.int64), n,
            doc_ids.astype(np.int32), 1 if lowercase else 0, counts,
        )
        return counts

    def export(self):
        """-> (terms list[str], post_start i64[T+1], docs i32[P], freqs i32[P],
        pos_start i64[T+1], positions i32[O]) with terms byte-sorted."""
        t = _lib.rtpu_inv_num_terms(self._h)
        nb = _lib.rtpu_inv_term_bytes_len(self._h)
        p = _lib.rtpu_inv_num_postings(self._h)
        o = _lib.rtpu_inv_num_positions(self._h)
        term_bytes = np.empty(max(nb, 1), np.uint8)
        term_offsets = np.empty(t + 1, np.int64)
        post_start = np.empty(t + 1, np.int64)
        pos_start = np.empty(t + 1, np.int64)
        docs = np.empty(max(p, 1), np.int32)
        freqs = np.empty(max(p, 1), np.int32)
        positions = np.empty(max(o, 1), np.int32)
        if t:
            _lib.rtpu_inv_export(
                self._h, term_bytes, term_offsets, post_start, pos_start,
                docs, freqs, positions,
            )
        else:
            term_offsets[:] = 0
            post_start[:] = 0
            pos_start[:] = 0
        raw = term_bytes.tobytes()
        terms = [
            raw[term_offsets[i]: term_offsets[i + 1]].decode("utf-8")
            for i in range(t)
        ]
        return terms, post_start, docs[:p], freqs[:p], pos_start, positions[:o]

    def close(self):
        if self._h:
            _lib.rtpu_inv_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def lz4_compress(data: bytes) -> bytes:
    if not available:
        raise RuntimeError("native library unavailable")
    src = np.frombuffer(data, np.uint8)
    cap = len(data) + len(data) // 128 + 64
    dst = np.empty(cap, np.uint8)
    n = _lib.rtpu_lz4_compress(src, len(data), dst, cap)
    if n < 0:
        raise ValueError("lz4 compression failed (incompressible beyond cap)")
    return dst[:n].tobytes()


def lz4_decompress(data: bytes, original_size: int) -> bytes:
    if not available:
        raise RuntimeError("native library unavailable")
    if original_size == 0:
        return b""
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(original_size, np.uint8)
    n = _lib.rtpu_lz4_decompress(src, len(data), dst, original_size)
    if n != original_size:
        raise ValueError(f"lz4 decompression failed ({n} != {original_size})")
    return dst.tobytes()

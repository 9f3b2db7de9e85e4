"""Pure-Python LZ4 block decompressor.

Fallback so indexes written with the native LZ4 encoder stay readable on
hosts without a C++ toolchain (the reverse of native/rucene_native.cpp's
encoder). Decompression only — writing falls back to zlib instead.
"""

from __future__ import annotations


def lz4_decompress(src: bytes, original_size: int) -> bytes:
    if original_size == 0:
        return b""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = (token & 15)
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - off
        if start < 0:
            raise ValueError("corrupt lz4 stream (bad offset)")
        for j in range(mlen):  # byte-wise: overlapping copies are the norm
            out.append(out[start + j])
    if len(out) != original_size:
        raise ValueError(f"lz4 decompression size mismatch ({len(out)} != {original_size})")
    return bytes(out)

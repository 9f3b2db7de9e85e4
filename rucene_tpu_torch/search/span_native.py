"""Native (C++) serving path for span-tree evaluation.

Nested and unordered span-near shapes cannot reduce to the device term /
synonym / phrase pipelines (spans.py device_equivalent returns None), and
their Python spans_for_doc walk is per-doc host work — the last query
family with a per-doc Python serving cost (VERDICT r3 item 7). This module
flattens a span tree into node tables and evaluates every candidate doc in
ONE C call (native/scalar_engine.cpp:rtpu_span_eval), which reuses the
scalar engine's block decoder and position runs.

The Python spans_for_doc path stays as the semantics oracle
(tests/test_spans.py parity asserts bit-identical scores): the C++ side
reproduces the exact float chain including numpy's f64 pairwise summation
of the sloppy-freq terms.

Reference analog: src/core/search/query/spans/span_near.rs:1067
(NearSpansUnordered), span_or.rs, span.rs:458 (SpanScorer).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from rucene_tpu_torch import native as _native

_registered = False


def _register() -> bool:
    global _registered
    if _registered:
        return True
    if not _native.available or not hasattr(_native._lib, "rtpu_span_eval"):
        return False
    i32 = np.ctypeslib.ndpointer(np.int32)
    _native._lib.rtpu_span_eval.restype = ctypes.c_int32
    _native._lib.rtpu_span_eval.argtypes = [
        np.ctypeslib.ndpointer(np.uint32), i32, i32, i32, i32, i32, i32, i32,
        np.ctypeslib.ndpointer(np.uint32), ctypes.c_int32,
        ctypes.c_int32, i32, i32, np.ctypeslib.ndpointer(np.uint8), i32,
        i32, i32, i32,
        i32, i32, i32, np.ctypeslib.ndpointer(np.int64),
        i32, ctypes.c_int32,
        ctypes.c_float, np.ctypeslib.ndpointer(np.float32),
        ctypes.POINTER(ctypes.c_uint8),  # norms (nullable)
        np.ctypeslib.ndpointer(np.uint8), np.ctypeslib.ndpointer(np.float32),
    ]
    _registered = True
    return True


def _segment_arrays(packed):
    """Contiguous i32/u32 views of the packed block tables, cached on the
    PackedSegment (snapshots share it, so the conversion cost is once)."""
    arrs = getattr(packed, "_span_native_arrays", None)
    if arrs is None:
        arrs = (
            np.ascontiguousarray(packed.data, np.uint32),
            np.ascontiguousarray(packed.blk_off, np.int32),
            np.ascontiguousarray(packed.blk_doc_bits, np.int32),
            np.ascontiguousarray(packed.blk_freq_bits, np.int32),
            np.ascontiguousarray(packed.blk_base, np.int32),
            np.ascontiguousarray(packed.blk_count, np.int32),
            np.ascontiguousarray(packed.blk_last_doc, np.int32),
            np.ascontiguousarray(packed.blk_pos_base, np.int32),
            np.ascontiguousarray(packed.positions, np.uint32),
        )
        packed._span_native_arrays = arrs
    return arrs


def _flatten(query, leaf):
    """Span tree -> node tables (root = node 0), or None if the tree
    contains a shape the C++ evaluator doesn't model."""
    from rucene_tpu_torch.search.spans import (
        SpanBoostQuery,
        SpanNearQuery,
        SpanOrQuery,
        SpanTermQuery,
    )

    nodes: list[dict] = []
    kids: list[list[int]] = []

    def walk(q) -> int | None:
        while type(q) is SpanBoostQuery:  # geometry-transparent wrapper
            q = q.query
        ni = len(nodes)
        if type(q) is SpanTermQuery:
            rec = leaf.term_record(q.term.field, q.term.text)
            nodes.append(
                dict(
                    type=0, slop=0, inorder=0, minw=1,
                    bs=rec.block_start if rec else 0,
                    bc=rec.block_count if rec else 0,
                    pw=rec.pos_width if rec else 0,
                    pws=rec.pos_word_start if rec else 0,
                )
            )
            kids.append([])
            return ni
        if type(q) is SpanOrQuery:
            nodes.append(dict(type=1, slop=0, inorder=0, minw=q.min_width(),
                              bs=0, bc=0, pw=0, pws=0))
            kids.append([])
            cs = []
            for c in q.clauses:
                ci = walk(c)
                if ci is None:
                    return None
                cs.append(ci)
            kids[ni] = cs
            return ni
        if type(q) is SpanNearQuery:
            nodes.append(dict(type=2, slop=q.slop,
                              inorder=1 if q.in_order else 0,
                              minw=q.min_width(), bs=0, bc=0, pw=0, pws=0))
            kids.append([])
            cs = []
            for c in q.clauses:
                ci = walk(c)
                if ci is None:
                    return None
                cs.append(ci)
            kids[ni] = cs
            return ni
        return None  # unknown SpanQuery subclass -> Python oracle path

    if walk(query) is None:
        return None

    n = len(nodes)
    child_start = np.zeros(n, np.int32)
    child_count = np.zeros(n, np.int32)
    children: list[int] = []
    for i, cs in enumerate(kids):
        child_start[i] = len(children)
        child_count[i] = len(cs)
        children.extend(cs)
    return (
        np.asarray([nd["type"] for nd in nodes], np.int32),
        np.asarray([nd["slop"] for nd in nodes], np.int32),
        np.asarray([nd["inorder"] for nd in nodes], np.uint8),
        np.asarray([nd["minw"] for nd in nodes], np.int32),
        child_start,
        child_count,
        np.asarray(children or [0], np.int32),
        np.asarray([nd["bs"] for nd in nodes], np.int32),
        np.asarray([nd["bc"] for nd in nodes], np.int32),
        np.asarray([nd["pw"] for nd in nodes], np.int32),
        np.asarray([nd["pws"] for nd in nodes], np.int64),
    )


def eval_spans(query, leaf, cand, w2, cache_row, norms):
    """(match u8[n_cand], scores f32[n_cand]) or None if the native path
    can't serve this tree (unavailable lib, disabled, unknown node)."""
    if os.environ.get("RUCENE_SPAN_NATIVE", "1") == "0":
        return None
    if not _register():
        return None
    flat = _flatten(query, leaf)
    if flat is None:
        return None
    (ntype, nslop, nord, nminw, cstart, ccount, children,
     tbs, tbc, tpw, tpws) = flat
    (data, blk_off, blk_dbits, blk_fbits, blk_base, blk_count, blk_last,
     blk_posb, positions) = _segment_arrays(leaf.packed)

    cand = np.ascontiguousarray(cand, np.int32)
    n_cand = len(cand)
    out_match = np.zeros(max(n_cand, 1), np.uint8)
    out_scores = np.zeros(max(n_cand, 1), np.float32)
    if n_cand == 0:
        return out_match[:0], out_scores[:0]
    norms_arr = (
        None if norms is None else np.ascontiguousarray(norms, np.uint8)
    )
    norms_ptr = (
        norms_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if norms_arr is not None
        else None
    )
    rc = _native._lib.rtpu_span_eval(
        data, blk_off, blk_dbits, blk_fbits, blk_base, blk_count, blk_last,
        blk_posb, positions, np.int32(leaf.max_doc),
        np.int32(len(ntype)), ntype, nslop, nord, nminw, cstart, ccount,
        children, tbs, tbc, tpw, tpws,
        cand, np.int32(n_cand),
        ctypes.c_float(float(w2)),
        np.ascontiguousarray(cache_row, np.float32), norms_ptr,
        out_match, out_scores,
    )
    if rc != 0:
        return None
    return out_match[:n_cand], out_scores[:n_cand]

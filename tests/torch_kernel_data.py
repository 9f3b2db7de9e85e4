"""Inputs for the port's kernel tests, built with numpy and rucene_tpu_torch
only (no jax), so the GPU-marked tests also run on a card host without it.
"""

from __future__ import annotations

import numpy as np


def synthetic_items(w=40, b=8, md=4096, seed=0, dense_frac=0.7):
    """Decoded work items for the combine: blocks of up to 128 ascending docs
    (md + 1 on lanes past a block's count); item i is block i, so
    blk_first / blk_last are the items' own doc ranges. Returns (docs
    i32[w,128], scores f32[w,128], rows, encs, valid, blk_first, blk_last)."""
    rng = np.random.default_rng(seed)
    docs = np.full((w, 128), md + 1, np.int32)
    sc = np.zeros((w, 128), np.float32)
    rows = np.sort(rng.integers(0, b, w)).astype(np.int32)
    encs = rng.choice([1, 256, 65536], w).astype(np.int32)
    valid = np.ones(w, bool)
    valid[-2:] = False  # padding items
    blk_first = np.zeros(w, np.int64)
    blk_last = np.zeros(w, np.int64)
    for i in range(w):
        if rng.random() < dense_frac:
            start = int(rng.integers(0, md - 400))
            d = start + np.sort(rng.choice(400, 128, replace=False))
        else:  # sparse item spanning most of the doc space -> residue
            d = np.sort(rng.choice(md, 128, replace=False))
        n = int(rng.integers(40, 129))  # tail blocks have fewer lanes
        docs[i, :n] = d[:n]
        sc[i, :n] = rng.random(n).astype(np.float32) * 3.0
        blk_first[i] = d[0]
        blk_last[i] = d[n - 1]
    return docs, sc, rows, encs, valid, blk_first, blk_last


def combine_arrays(rows, encs, valid):
    """The six work arrays build_combine_batch reads, for synthetic items."""
    w = len(rows)
    return (np.arange(w, dtype=np.int32), rows, np.ones(w, np.float32),
            np.zeros(w, np.int32), encs, valid)


def combine_entries(b=8, md=8192, w=60, max_span=16, seed=0, c_bucket=512):
    """Hand-built combine entries over synthetic items: each item lists
    every bucket its valid lanes overlap (so items repeat across buckets,
    up to ``max_span`` of them), some items sit on bucket edges, and some
    are all-invalid (target md + 1 on every lane) with one entry each.
    Returns numpy (bucket_ptr i32[NB+1], target i32[w,128], sc f32[w,128],
    e_item i32[E], e_row i32[E], e_enc i32[E], rows i32[w], encs i32[w])."""
    rng = np.random.default_rng(seed)
    n_buckets = md // c_bucket
    target = np.full((w, 128), md + 1, np.int32)
    sc = np.zeros((w, 128), np.float32)
    rows = rng.integers(0, b, w).astype(np.int32)
    encs = rng.choice([1, 256, 65536], w).astype(np.int32)
    e_bucket, e_item = [], []
    for i in range(w):
        kind = i % 5
        if kind == 4:  # all-invalid: one entry in some bucket
            e_bucket.append(int(rng.integers(0, n_buckets)))
            e_item.append(i)
            continue
        n = int(rng.choice([1, 37, 128, int(rng.integers(2, 129))]))
        if kind == 3:  # straddles a bucket edge
            edge = c_bucket * int(rng.integers(1, n_buckets))
            d = edge - n // 2 + np.arange(n)
        else:  # spans up to max_span buckets
            span = int(rng.integers(1, max_span + 1)) * c_bucket - c_bucket // 2
            gap = max(1, span // 128)
            start = int(rng.integers(0, max(1, md - gap * n)))
            d = start + gap * np.arange(n)
        d = d[(d >= 0) & (d < md)]
        if not len(d):
            d = np.array([int(rng.integers(0, md))])
        target[i, : len(d)] = d
        sc[i, : len(d)] = rng.random(len(d)).astype(np.float32) * 3.0
        for bk in range(d[0] // c_bucket, d[-1] // c_bucket + 1):
            e_bucket.append(bk)
            e_item.append(i)
    order = np.argsort(e_bucket, kind="stable")
    e_bucket = np.asarray(e_bucket)[order]
    e_item = np.asarray(e_item, np.int32)[order]
    bucket_ptr = np.searchsorted(e_bucket, np.arange(n_buckets + 1)).astype(np.int32)
    return (bucket_ptr, target, sc, e_item, rows[e_item], encs[e_item], rows, encs)


def synthetic_blocks(seed=0):
    """Packed blocks at every FOR width 0-32 and EF low widths 0, 1, 5, 12
    and 20, each with count 1, 37 and 128, freq widths 0-32 and random
    words (unary planes hold 128 ones), with 2 zero pad words at the end.
    Bases cover the whole int32 range, so doc ids wrap. Returns int32
    tensors (data[N], off, dbits, fbits, base, count [W])."""
    import torch

    from rucene_tpu_torch.util.packing import EF_TAG, EF_UNARY_WORDS

    rng = np.random.default_rng(seed)
    words, off, dbits, fbits, base, count = [], [], [], [], [], []
    at = 0
    kinds = [(db, 4 * db) for db in range(33)]
    kinds += [(EF_TAG + l, 4 * l + EF_UNARY_WORDS) for l in (0, 1, 5, 12, 20)]
    for db, doc_words in kinds:
        for n in (1, 37, 128):
            fb = int(rng.integers(0, 33))
            plane = rng.integers(0, 2**32, doc_words + 4 * fb + 32, dtype=np.uint64)
            if db >= EF_TAG:
                l = db - EF_TAG
                ones = np.sort(rng.choice(EF_UNARY_WORDS * 32, 128, replace=False))
                bits = np.zeros(EF_UNARY_WORDS * 32, np.uint64)
                bits[ones] = 1
                unary = (bits.reshape(EF_UNARY_WORDS, 32) << np.arange(32, dtype=np.uint64)).sum(1)
                plane[4 * l : 4 * l + EF_UNARY_WORDS] = unary
            words.append(plane.astype(np.uint32))
            off.append(at)
            dbits.append(db)
            fbits.append(fb)
            base.append(int(rng.integers(-(2**31), 2**31)))
            count.append(n)
            at += len(plane)
    words.append(np.zeros(2, np.uint32))
    data = np.concatenate(words).view(np.int32)
    return tuple(
        torch.from_numpy(np.asarray(a, np.int32).copy()) for a in (data, off, dbits, fbits, base, count)
    )


def port_segment(kind: str):
    """A packed segment built by rucene_tpu_torch: "ef_heavy" (a skewed hot
    term forces Elias-Fano blocks) or "plain" (FOR wins every block)."""
    from rucene_tpu_torch import Document, TextField
    from rucene_tpu_torch.codec.postings import pack_segment
    from rucene_tpu_torch.index.memory import SegmentBuffer

    rng = np.random.default_rng(77 if kind == "ef_heavy" else 78)
    if kind == "ef_heavy":
        words = [f"v{i}" for i in range(25)]
        texts = [" ".join(rng.choice(words, int(rng.integers(3, 41)))) for _ in range(400)]
        texts = [t + (" efhot" if (i < 70 or 330 <= i < 390) else "") for i, t in enumerate(texts)]
    else:
        texts = [" ".join(f"u{int(x)}" for x in rng.integers(0, 5000, size=10)) for _ in range(300)]
    buf = SegmentBuffer()
    for t in texts:
        d = Document()
        d.add(TextField("body", t))
        buf.add_document(d)
    return pack_segment(buf.finish())

"""Shared corpora for the port's query-surface tests (sorted search,
collapse, spans, synonyms, rescoring, explain, the parser, highlighting):
one index built by rucene_tpu, carried across with packed_from_reference
and served by both packages on the CPU.

Every doc has a ``body`` text; most have numeric doc values ``price``
(a few distinct values) and ``stock``, every doc a ``grp`` collapse key.
"""

from __future__ import annotations

import numpy as np

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot

SPAN_WORDS = [f"w{i}" for i in range(25)]


def dv_docs(n: int, seed: int, key_card: int = 7, words=None):
    """(text, price or None, stock or None, grp) per doc."""
    rng = np.random.default_rng(seed)
    if words is None:
        from tests.conftest import random_corpus

        texts = random_corpus(rng, n)
    else:
        probs = 1.0 / np.arange(1, len(words) + 1) ** 1.1
        probs /= probs.sum()
        texts = [
            " ".join(rng.choice(words, size=int(rng.integers(5, 30)), p=probs))
            for _ in range(n)
        ]
    out = []
    for i, t in enumerate(texts):
        price = int(rng.integers(0, key_card)) * 3 - 5 if i % 5 else None
        stock = int(rng.integers(0, 9)) if i % 7 else None
        out.append((t, price, stock, int(rng.integers(0, 11))))
    return out


def pack_docs(rows):
    buf = SegmentBuffer()
    for text, price, stock, grp in rows:
        d = R.Document()
        d.add(R.TextField("body", text))
        if price is not None:
            d.add(R.NumericDocValuesField("price", price))
        if stock is not None:
            d.add(R.NumericDocValuesField("stock", stock))
        d.add(R.NumericDocValuesField("grp", grp))
        buf.add_document(d)
    return pack_segment(buf.finish())


def leaves_for(rows, n_segments: int = 1, deletes: bool = False, seed: int = 0):
    """[(reference PackedSegment, live or None)] over ``n_segments`` even
    slices of ``rows``; with deletes about one doc in seven is dead."""
    rng = np.random.default_rng(1000 + seed)
    bounds = np.linspace(0, len(rows), n_segments + 1).astype(int)
    out = []
    for si in range(n_segments):
        packed = pack_docs(rows[bounds[si] : bounds[si + 1]])
        live = None
        if deletes:
            live = np.ones(packed.max_doc, bool)
            live[rng.integers(0, packed.max_doc, size=max(1, packed.max_doc // 7))] = False
        out.append((packed, live))
    return out


def ref_searcher(leaves):
    return R.IndexSearcher(
        RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
    )


def port_searcher(leaves, device="cpu"):
    return T.IndexSearcher(
        IndexReader([
            SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
            for i, (p, lv) in enumerate(leaves)
        ]),
        device=device,
    )


def both(leaves):
    return ref_searcher(leaves), port_searcher(leaves)


def assert_field_docs_equal(got, want):
    """Sorted results: total hits, doc ids and sort values exact, scores
    within the strict tolerance."""
    from tests.torch_hitcheck import RTOL

    assert got.total_hits == want.total_hits
    assert [(fd.doc, list(fd.fields)) for fd in got.field_docs] == [
        (fd.doc, list(fd.fields)) for fd in want.field_docs
    ]
    for g, w in zip(got.field_docs, want.field_docs):
        assert abs(g.score - w.score) <= RTOL * max(1.0, abs(w.score)), (g, w)


def assert_bit_equal(got, want):
    """Hit lists equal bit for bit: total hits, docs and f32 scores."""
    assert got.total_hits == want.total_hits
    assert [d for d, _ in got.score_docs] == [d for d, _ in want.score_docs]
    g = np.asarray([s for _, s in got.score_docs], np.float32)
    w = np.asarray([s for _, s in want.score_docs], np.float32)
    assert np.array_equal(g, w), (g, w)

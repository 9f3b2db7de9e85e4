"""Shared inputs of the port's pair and tf-plane route tests
(tests/test_torch_pair.py, tests/test_torch_planes.py) and of the
differential fuzz (tests/test_torch_fuzz.py).

A small Zipf corpus packed by rucene_tpu, carried into the port with
packed_from_reference, the same rows built with each package's query
classes, and the reference's answer for them. The reference runs with its
own default routing: its answer is the truth the port is held to, whatever
route the port takes.
"""

from __future__ import annotations

import os

import numpy as np

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot

OCC = {"S": "should", "M": "must", "F": "filter", "N": "must_not"}
ROUTE_ENV = ("RUCENE_DECODED", "RUCENE_PLANES", "RUCENE_PAIR", "RUCENE_STRATEGY")


def zipf_texts(n_docs: int, vocab: int, seed: int, lo: int = 3, hi: int = 8):
    """Short docs over a Zipf vocabulary: many ties, dense head terms."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    texts = []
    for _ in range(n_docs):
        toks = rng.choice(vocab, size=int(rng.integers(lo, hi)), p=p)
        texts.append(" ".join(words[t] for t in toks))
    return texts, words


TS_MAX = 1000  # the filter fields' point values lie in [0, TS_MAX)


def ref_segments(texts, n_segments: int = 1, title: bool = False, filters: bool = False):
    """rucene_tpu PackedSegments over ``texts`` split into n_segments;
    ``title`` adds a second field holding each doc's first word;
    ``filters`` gives every doc an IntPoint ``ts`` in [0, TS_MAX) and one
    doc in 3 a StringField ``tag`` (c00-c29), drawn from a fixed seed."""
    rng = np.random.default_rng(99)
    ts = rng.integers(0, TS_MAX, len(texts))
    tag = rng.integers(0, 30, len(texts))
    per = len(texts) // n_segments
    out = []
    for s in range(n_segments):
        buf = SegmentBuffer()
        for i in range(s * per, (s + 1) * per):
            t = texts[i]
            d = R.Document()
            d.add(R.TextField("body", t))
            if title:
                d.add(R.TextField("title", t.split()[0]))
            if filters:
                d.add(R.IntPoint("ts", int(ts[i])))
                if i % 3 == 0:
                    d.add(R.StringField("tag", f"c{tag[i]:02d}"))
            buf.add_document(d)
        out.append(pack_segment(buf.finish()))
    return out


def layout(kind: str, texts):
    """[(reference packed, live or None)] for one index layout: one
    segment, two segments, or one segment with every third doc deleted."""
    if kind == "two":
        return [(p, None) for p in ref_segments(texts, 2)]
    (packed,) = ref_segments(texts)
    if kind == "deletes":
        live = np.ones(packed.max_doc, bool)
        live[::3] = False
        return [(packed, live)]
    return [(packed, None)]


def query(pkg, row, msm: int = 0):
    """A BooleanQuery of (occur letter, field, term) clauses, or a TermQuery
    for a one-clause row marked "T"."""
    if len(row) == 1 and row[0][0] == "T":
        return pkg.TermQuery(pkg.Term(row[0][1], row[0][2]))
    q = pkg.BooleanQuery(min_should_match=msm)
    for occ, field, term in row:
        getattr(q, OCC[occ])(pkg.TermQuery(pkg.Term(field, term)))
    return q


def ref_search(leaves, rows, k: int, msm=None, env=None):
    """The reference's TopDocs for ``rows`` (its default routing, no
    pruning; ``env`` sets route variables for this search alone)."""
    saved = {v: os.environ.pop(v) for v in ROUTE_ENV if v in os.environ}
    os.environ.update(env or {})
    try:
        s = R.IndexSearcher(
            RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
        )
        qs = [query(R, r, 0 if msm is None else msm[i]) for i, r in enumerate(rows)]
        return s.search_batch(qs, k=k, prune=False)
    finally:
        for v in env or {}:
            os.environ.pop(v, None)
        os.environ.update(saved)


def port_searcher(leaves):
    """A CPU IndexSearcher over fresh snapshots of the same segments: its
    device forms are built under the environment of its first search."""
    return T.IndexSearcher(
        IndexReader([
            SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
            for i, (p, lv) in enumerate(leaves)
        ]),
        device="cpu",
    )


def port_queries(rows, msm=None):
    return [query(T, r, 0 if msm is None else msm[i]) for i, r in enumerate(rows)]

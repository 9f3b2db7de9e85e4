"""Score-combine rows (DisjunctionMax, ConstantScore, Filter, Boosting),
MatchAllDocs rows, ``count`` and ``search_batch(timeout_s=)`` on the
port against rucene_tpu, on the CPU.

A Zipf corpus with a body and a title field, built by rucene_tpu (one
segment, two segments, one segment with deletes), is carried across with
packed_from_reference and served by both packages, the port's leaves
decoded and packed. Score-combine rows run on both branches of the flat
executor (RUCENE_STRATEGY=dense: the combine kernel's twin plus a
scatter-max for dismax; =candidate: index_add_ and a segmented max over
the sorted groups), beside plain rows in one batch (a batch holding
such a row takes no tf planes, so RUCENE_PLANES=1 changes nothing). Hit
lists compare complete under tests/torch_hitcheck.py, and a truncated
list is the bit-exact head of the complete one.
"""

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 2000


def _docs(n=900, seed=41):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        body = " ".join(f"w{int(x) % 60}" for x in rng.zipf(1.35, size=int(rng.integers(4, 20))))
        title = " ".join(f"w{int(x) % 60}" for x in rng.zipf(1.35, size=3))
        out.append((body, title))
    return out


def _pack(docs):
    buf = SegmentBuffer()
    for body, title in docs:
        d = R.Document()
        d.add(R.TextField("body", body))
        d.add(R.TextField("title", title))
        buf.add_document(d)
    return pack_segment(buf.finish())


def _layout(kind):
    docs = _docs()
    if kind == "two":
        return [(_pack(docs[:500]), None), (_pack(docs[500:]), None)]
    packed = _pack(docs)
    if kind == "deletes":
        live = np.random.default_rng(5).random(packed.max_doc) > 0.25
        return [(packed, live)]
    return [(packed, None)]


def _t(pkg, field, word, boost=1.0):
    return pkg.TermQuery(pkg.Term(field, word), boost=boost)


def _or(pkg, *words, field="body"):
    q = pkg.BooleanQuery()
    for w in words:
        q.should(_t(pkg, field, w))
    return q


def _rows(pkg):
    """Score-combine rows beside plain rows."""
    must_not = pkg.BooleanQuery()
    must_not.must(_t(pkg, "body", "w4"))
    must_not.must_not(_t(pkg, "body", "w11"))
    pos = pkg.BooleanQuery()
    pos.must(_t(pkg, "body", "w10"))
    pos.should(_t(pkg, "body", "w20"))
    rows = [
        _t(pkg, "body", "w3"),
        _or(pkg, "w2", "w7"),
        pkg.DisjunctionMaxQuery([_t(pkg, "body", "w3"), _t(pkg, "title", "w3")]),
        pkg.DisjunctionMaxQuery([_t(pkg, "body", "w5"), _t(pkg, "body", "w9")], tie_breaker=0.3),
        pkg.DisjunctionMaxQuery([_t(pkg, "body", "w1"), _t(pkg, "title", "w2")], tie_breaker=1.0),
        pkg.DisjunctionMaxQuery(
            [_t(pkg, "body", "w2", 2.0), _t(pkg, "title", "w2"), _t(pkg, "body", "w8")],
            tie_breaker=0.3, boost=1.5,
        ),
        pkg.DisjunctionMaxQuery([_t(pkg, "body", "w6"), _t(pkg, "title", "zz_missing")]),
        pkg.ConstantScoreQuery(_t(pkg, "body", "w7"), boost=2.5),
        pkg.ConstantScoreQuery(_or(pkg, "w12", "w13"), boost=2.0),
        pkg.ConstantScoreQuery(must_not, boost=0.75),
        pkg.FilterQuery(_t(pkg, "body", "w6")),
        pkg.BoostingQuery(_t(pkg, "body", "w8"), _t(pkg, "body", "w15"), 0.2),
        pkg.BoostingQuery(pos, _or(pkg, "w30", "w31"), 0.5),
        pkg.BoostingQuery(_or(pkg, "w1", "w4"), _t(pkg, "title", "w0"), 0.5),
    ]
    return rows


@pytest.fixture(scope="module", params=["one", "two", "deletes"])
def index(request):
    leaves = _layout(request.param)
    ref = R.IndexSearcher(
        RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
    )
    want = ref.search_batch(_rows(R), k=K_ALL, prune=False)
    assert max(td.total_hits for td in want) < K_ALL

    def port():
        return T.IndexSearcher(
            IndexReader([
                SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
                for i, (p, lv) in enumerate(leaves)
            ]),
            device="cpu",
        )

    return port, ref, want


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("strategy", ["dense", "candidate"])
def test_extras_match_reference(index, strategy, decoded, monkeypatch):
    port, _ref, want = index
    monkeypatch.setenv("RUCENE_STRATEGY", strategy)
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    monkeypatch.setenv("RUCENE_PLANES", "1")
    METRICS.reset()
    searcher = port()
    got = searcher.search_batch(_rows(T), k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert counters.get(f"search.strategy.{strategy}", 0) > 0
    assert counters.get("route.plane_rows", 0) == 0  # a batch with extras takes no planes
    assert_batches_strict(got, want)
    for h, full in zip(searcher.search_batch(_rows(T), k=7), got):
        assert h.total_hits == full.total_hits
        assert h.score_docs == full.score_docs[:7]


@pytest.mark.parametrize("deletes", [False, True])
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_match_all_rows(deletes, decoded, monkeypatch):
    """MatchAll rows (boost 1 and 3), alone and beside term and dismax rows,
    with k above the live count: every live doc in doc order, at the
    boost; a truncated list is the complete one's head."""
    leaves = _layout("two")
    if deletes:
        leaves = [(p, np.arange(p.max_doc) % 4 != i) for i, (p, _lv) in enumerate(leaves)]

    def rows(pkg):
        return [
            pkg.MatchAllDocsQuery(),
            _t(pkg, "body", "w3"),
            pkg.MatchAllDocsQuery(boost=3.0),
            pkg.DisjunctionMaxQuery([_t(pkg, "body", "w3"), _t(pkg, "title", "w3")]),
            pkg.ConstantScoreQuery(pkg.MatchAllDocsQuery(), boost=2.0),
        ]

    ref = R.IndexSearcher(
        RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
    )
    want = ref.search_batch(rows(R), k=K_ALL, prune=False)
    n_live = sum(p.max_doc if lv is None else int(lv.sum()) for p, lv in leaves)
    assert want[0].total_hits == n_live < K_ALL
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    searcher = T.IndexSearcher(
        IndexReader([
            SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
            for i, (p, lv) in enumerate(leaves)
        ]),
        device="cpu",
    )
    got = searcher.search_batch(rows(T), k=K_ALL)
    assert_batches_strict(got, want)
    assert {s for _, s in got[2].score_docs} == {3.0}
    alone = searcher.search_batch([T.MatchAllDocsQuery(boost=3.0)], k=K_ALL)
    assert alone[0] == got[2]
    for h, full in zip(searcher.search_batch(rows(T), k=9), got):
        assert h.total_hits == full.total_hits
        assert h.score_docs == full.score_docs[:9]


def test_count(index):
    port, ref, _want = index
    searcher = port()
    for q_port, q_ref in zip(_rows(T) + [T.MatchAllDocsQuery()], _rows(R) + [R.MatchAllDocsQuery()]):
        assert searcher.count(q_port) == ref.count(q_ref)


def test_timeout(monkeypatch):
    """timeout_s=0 on a two-segment reader: the deadline passes before the
    first leaf, so both packages skip every leaf, set timed_out and return
    empty (partial) results, on the term path and the mixed path alike. A
    generous budget returns the complete answer and clears timed_out."""
    leaves = _layout("two")
    ref = R.IndexSearcher(RefReader([RefSnapshot(f"s{i}", p) for i, (p, _lv) in enumerate(leaves)]))
    searcher = T.IndexSearcher(
        IndexReader([SegmentSnapshot(f"s{i}", packed_from_reference(p)) for i, (p, _lv) in enumerate(leaves)]),
        device="cpu",
    )

    def rows(pkg):
        mixed = pkg.BooleanQuery()
        mixed.must(pkg.PhraseQuery("body", ["w0", "w1"]))
        mixed.should(_t(pkg, "body", "w2"))
        return _rows(pkg)[:4] + [mixed]

    want_partial = ref.search_batch(rows(R), k=K_ALL, timeout_s=0)
    assert ref.timed_out
    got = searcher.search_batch(rows(T), k=K_ALL, timeout_s=0)
    assert searcher.timed_out
    assert_batches_strict(got, want_partial)
    assert all(td.total_hits == 0 for td in got)
    full = searcher.search_batch(rows(T), k=K_ALL, timeout_s=600)
    assert not searcher.timed_out
    assert_batches_strict(full, ref.search_batch(rows(R), k=K_ALL, prune=False))


def test_match_all_with_clauses_raises_item9():
    """MatchAll beside a term clause, and beside a range, is the
    reference's host route (it never reaches its device path): the port
    answers it on the host engine, counted under route.host, equal to the
    reference."""
    def rows(pkg):
        with_term = pkg.BooleanQuery()
        with_term.must(pkg.MatchAllDocsQuery())
        with_term.should(_t(pkg, "body", "w3"))
        with_range = pkg.BooleanQuery()
        with_range.must(pkg.MatchAllDocsQuery(boost=2.0))
        with_range.filter(pkg.ExistsQuery("title"))
        return [with_term, with_range]

    rq = rows(T)[0].rewrite()
    assert rq.match_all and rq.clauses
    packed = _pack(_docs(50))
    want = R.IndexSearcher(RefReader([RefSnapshot("s0", packed)])).search_batch(rows(R), k=K_ALL)
    searcher = T.IndexSearcher(
        IndexReader([SegmentSnapshot("s0", packed_from_reference(packed))]), device="cpu"
    )
    METRICS.reset()
    got = searcher.search_batch(rows(T), k=K_ALL)
    assert METRICS.snapshot()["counters"].get("route.host", 0) == 2
    assert_batches_strict(got, want)

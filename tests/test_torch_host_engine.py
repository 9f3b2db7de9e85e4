"""The host route of the port (search/host_engine.py, a copy of
rucene_tpu's numpy engine, and IndexSearcher._search_host) against
rucene_tpu, on the CPU.

One corpus built by rucene_tpu (a body, an IntPoint ``ts`` and on some
docs a StringField ``tag``) is carried across with packed_from_reference.
- host_engine.evaluate_query of the port equals the reference's, match
  mask and f32 scores bit for bit, for every kind of row the reference
  evaluates on its host: a rewrite that needs host evaluation (dismax over
  booleans, constant-score and boosting rows over phrases), nested clause
  groups, more than 8 ranges, match-all beside clauses, SHOULD, sloppy,
  gapped and MUST_NOT phrases inside booleans;
- those rows through search_batch (one and two leaves, with deletes,
  decoded and packed) equal the reference's search_batch under the strict
  tests/torch_hitcheck.py, each counted under ``route.host``;
- without the native scalar engine, the phrase rows it would take are
  answered by the host engine, equal to the reference;
- a boolean whose rewrite refuses a nested clause with required members
  (the reference raises there) is answered on the host route, equal to
  the flat row it means.
"""

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.search import host_engine as ref_host
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.search import host_engine, phrase_path
from rucene_tpu_torch.search.similarity import CollectionStats
from rucene_tpu_torch.util.metrics import METRICS
from tests.conftest import random_corpus
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 1000


def _pack(texts, seed):
    rng = np.random.default_rng(seed)
    buf = SegmentBuffer()
    for i, t in enumerate(texts):
        d = R.Document()
        d.add(R.TextField("body", t))
        d.add(R.IntPoint("ts", int(rng.integers(0, 1000))))
        if i % 3:
            d.add(R.StringField("tag", f"c{int(rng.integers(0, 20)):02d}"))
        buf.add_document(d)
    return pack_segment(buf.finish())


def _layout(kind):
    texts = random_corpus(np.random.default_rng(61), 420, min_len=3, max_len=30)
    if kind.startswith("two"):
        leaves = [(_pack(texts[:200], 1), None), (_pack(texts[200:], 2), None)]
    else:
        leaves = [(_pack(texts, 1), None)]
    if kind.endswith("deletes"):
        leaves = [(p, np.arange(p.max_doc) % 4 != i) for i, (p, _lv) in enumerate(leaves)]
    return leaves


def _t(pkg, word, boost=1.0):
    return pkg.TermQuery(pkg.Term("body", word), boost=boost)


def _bool(pkg, *clauses, msm=0):
    q = pkg.BooleanQuery(min_should_match=msm)
    for occ, sub in clauses:
        getattr(q, occ)(sub)
    return q


def _host_rows(pkg):
    """name -> a row the reference evaluates on its host."""
    group = _bool(pkg, ("should", _t(pkg, "fox")), ("should", _t(pkg, "dog")))
    ph = pkg.PhraseQuery("body", ["the", "quick"])
    return {
        "group_must": _bool(pkg, ("must", group), ("must", _t(pkg, "the"))),
        "group_not": _bool(pkg, ("must_not", group), ("should", _t(pkg, "lazy")),
                           ("should", _t(pkg, "over"))),
        "group_filter": _bool(pkg, ("filter", group), ("should", _t(pkg, "brown"))),
        "nine_ranges": _bool(pkg, ("should", _t(pkg, "fox")), *[
            ("filter", pkg.PointRangeQuery("ts", lo, lo + 700)) for lo in range(0, 270, 30)
        ]),
        "match_all_range": _bool(pkg, ("must", pkg.MatchAllDocsQuery(boost=2.0)),
                                 ("filter", pkg.PointRangeQuery("ts", 100, 400))),
        "match_all_term": _bool(pkg, ("must", pkg.MatchAllDocsQuery()), ("should", _t(pkg, "fox"))),
        "dismax_bools": pkg.DisjunctionMaxQuery([
            _bool(pkg, ("should", _t(pkg, "fox")), ("should", _t(pkg, "dog"))),
            _bool(pkg, ("must", _t(pkg, "the")), ("should", _t(pkg, "lazy"))),
        ], tie_breaker=0.3),
        "const_phrase": pkg.ConstantScoreQuery(ph, 2.5),
        "boosting_phrase": pkg.BoostingQuery(ph, _t(pkg, "fox"), 0.5),
        "should_phrase": _bool(pkg, ("should", ph), ("should", _t(pkg, "dog"))),
        "sloppy_in_bool": _bool(pkg, ("must", pkg.PhraseQuery("body", ["quick", "fox"], slop=2)),
                                ("should", _t(pkg, "dog"))),
        "gapped_in_bool": _bool(pkg, ("must", pkg.PhraseQuery("body", ["the", "fox"], positions=[0, 2])),
                                ("filter", pkg.ExistsQuery("tag"))),
        "not_phrase": _bool(pkg, ("must_not", ph), ("should", _t(pkg, "the"))),
        "two_phrases": _bool(pkg, ("must", ph), ("must", pkg.PhraseQuery("body", ["lazy", "dog"]))),
        "prefix_group": _bool(pkg, ("must", group), ("filter", pkg.PrefixQuery("tag", "c1"))),
    }


@pytest.fixture(scope="module")
def snapshots():
    (packed, _lv), = _layout("one")
    live = np.arange(packed.max_doc) % 6 != 0
    return (RefSnapshot("s0", packed, live=live),
            SegmentSnapshot("s0", packed_from_reference(packed), live=live))


@pytest.mark.parametrize("name", sorted(_host_rows(T)))
def test_evaluate_query_matches_reference(snapshots, name):
    """The port's evaluate_query (and the hits it ranks) equal the
    reference's on the same leaf, with the reference's statistics."""
    ref_leaf, leaf = snapshots
    ref_searcher = R.IndexSearcher(RefReader([ref_leaf]))
    q_ref, q = _host_rows(R)[name], _host_rows(T)[name]
    doc_freqs, stats = ref_searcher._gather_stats_query(q_ref)
    want_m, want_s = ref_host.evaluate_query(ref_leaf, q_ref, ref_searcher.similarity, stats, doc_freqs)
    sim = T.BM25Similarity()
    port_stats = {f: CollectionStats(**vars(st)) for f, st in stats.items()}
    got_m, got_s = host_engine.evaluate_query(leaf, q, sim, port_stats, doc_freqs)
    assert np.array_equal(got_m, want_m)
    assert np.array_equal(got_s, want_s)
    assert got_s.dtype == np.float32
    got_h = host_engine.hits_from_dense(leaf, got_m, got_s, 50)
    want_h = ref_host.hits_from_dense(ref_leaf, want_m, want_s, 50)
    assert got_h.total_hits == want_h.total_hits
    assert np.array_equal(got_h.docs, want_h.docs) and np.array_equal(got_h.scores, want_h.scores)


@pytest.fixture(scope="module", params=["one", "two", "two_deletes"])
def index(request):
    leaves = _layout(request.param)
    ref = R.IndexSearcher(
        RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
    )
    names = sorted(_host_rows(R))
    want = ref.search_batch([_host_rows(R)[n] for n in names], k=K_ALL, prune=False)
    assert max(td.total_hits for td in want) < K_ALL
    assert sum(td.total_hits > 0 for td in want) >= len(names) - 2
    return leaves, names, want


def _port(leaves):
    return T.IndexSearcher(
        IndexReader([
            SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
            for i, (p, lv) in enumerate(leaves)
        ]),
        device="cpu",
    )


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_host_rows_match_reference(index, decoded, monkeypatch):
    """Every host row beside a device row and a phrase row, in one batch:
    each host row counted under route.host, all answered as the reference
    answers them; a truncated list is the complete one's head."""
    leaves, names, want = index
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    rows = [_host_rows(T)[n] for n in names]
    extra = [_t(T, "fox"), T.PhraseQuery("body", ["the", "quick"])]
    ref_extra = _ref(leaves).search_batch(
        [_t(R, "fox"), R.PhraseQuery("body", ["the", "quick"])], k=K_ALL, prune=False
    )
    searcher = _port(leaves)
    METRICS.reset()
    got = searcher.search_batch(rows + extra, k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert counters.get("route.host", 0) == len(rows)
    assert counters.get("route.device", 0) == 1 and counters.get("route.phrase", 0) == 1
    assert_batches_strict(got, want + ref_extra)
    for h, full in zip(searcher.search_batch(rows, k=4), got):
        assert h.total_hits == full.total_hits
        assert h.score_docs == full.score_docs[:4]


def _ref(leaves):
    return R.IndexSearcher(
        RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
    )


def test_phrase_rows_without_native_engine(index, monkeypatch):
    """No native scalar engine: the exact rows the scalar route would take
    on a small leaf, and sloppy rows, are answered by the host engine."""
    leaves, _names, _want = index
    rows = [("the", "quick", 0), ("lazy", "dog", 0), ("quick", "fox", 3), ("fox", "the", 1)]
    want = _ref(leaves).search_batch(
        [R.PhraseQuery("body", [a, b], slop=s) for a, b, s in rows], k=K_ALL, prune=False
    )
    searcher = _port(leaves)

    def no_engine(*_a, **_k):
        raise RuntimeError("native library unavailable")

    monkeypatch.setattr(searcher, "_scalar_engine_for", no_engine)
    phrase_path._PLANE_CACHE.clear()
    got = searcher.search_batch([T.PhraseQuery("body", [a, b], slop=s) for a, b, s in rows], k=K_ALL)
    assert_batches_strict(got, want)


def test_nested_required_boolean_on_host(index):
    """``+(+a +b) +c``: the flat rewrite refuses the nested clause with
    required members; the host route evaluates it clause by clause, equal
    to the flat ``+a +b +c`` row (same operands, same order of sums)."""
    leaves, _names, _want = index
    inner = _bool(T, ("must", _t(T, "the")), ("must", _t(T, "fox")))
    nested = _bool(T, ("must", inner), ("must", _t(T, "dog")))
    flat = _bool(R, ("must", _t(R, "the")), ("must", _t(R, "fox")), ("must", _t(R, "dog")))
    want = _ref(leaves).search_batch([flat], k=K_ALL, prune=False)
    searcher = _port(leaves)
    METRICS.reset()
    got = searcher.search_batch([nested], k=K_ALL)
    assert METRICS.snapshot()["counters"].get("route.host", 0) == 1
    assert_batches_strict(got, want)

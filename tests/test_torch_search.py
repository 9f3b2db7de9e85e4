"""The port's term/boolean slice end to end on the CPU against rucene_tpu.

One index built by rucene_tpu (one segment, two segments, one segment with
deletes) is carried across with packed_from_reference and served by both
packages: rucene_tpu's IndexSearcher.search_batch(prune=False) and the
port's search_batch, on the same seeded rows built with each package's own
query classes. Hits compare strictly (tests/torch_hitcheck.py): total_hits
equal, the same docs, scores within 4e-7, bit-equal ties doc-ascending,
and hits trading places only where their scores are within 4e-7 (three or
more clause scores sum in each executor's own order). Lists are compared
complete (k above every row's hit count); a truncated list must then be,
bit for bit, the head of the port's complete one, so ties at the k-th
boundary are broken by doc id.

Packed serving (RUCENE_DECODED=0: the scoring decode's twin on the CPU)
must match the reference the same way and equal the port's decoded run
bit for bit. With the row-class split forced on (SPLIT_MIN_DOCS=0),
single-term rows take the single route exactly when no leaf has deletes,
and, on decoded leaves, two-term AND / OR rows the pair route, as the
route counters show.
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
from rucene_tpu_torch.search import searcher as searcher_mod
from rucene_tpu_torch.util.metrics import METRICS
from tests.conftest import WORDS, make_docs, random_corpus
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 1000  # above every row's hit count: complete lists
OCC = {"S": "should", "M": "must", "F": "filter", "N": "must_not"}


def _pack(seed, n_docs):
    rng = np.random.default_rng(seed)
    texts = random_corpus(rng, n_docs)
    buf = SegmentBuffer()
    for d in make_docs(texts):
        buf.add_document(d)
    return pack_segment(buf.finish())


def _leaves(kind):
    """[(packed, live or None)] for one index layout."""
    if kind == "one":
        return [(_pack(21, 300), None)]
    if kind == "two":
        return [(_pack(22, 220), None), (_pack(23, 180), None)]
    packed = _pack(24, 300)
    live = np.random.default_rng(25).random(packed.max_doc) > 0.3
    return [(packed, live)]


def _row_specs(seed=9, n=48):
    """(occur string, terms, min_should_match) rows: term, OR, AND,
    MUST_NOT, min_should, FILTER; some terms are absent from the index."""
    rng = np.random.default_rng(seed)
    vocab = WORDS + ["absent", "nowhere"]
    shapes = [("T", 1, 0), ("SS", 2, 0), ("MM", 2, 0), ("MN", 2, 0),
              ("SSN", 3, 0), ("SSS", 3, 2), ("MF", 2, 0), ("SSSS", 4, 3),
              ("MSS", 3, 1)]
    out = []
    for i in range(n):
        occ, nt, msm = shapes[i % len(shapes)]
        terms = [str(t) for t in rng.choice(vocab, nt, replace=False)]
        out.append((occ, terms, msm))
    return out


def _single_specs():
    return [("T", [w], 0) for w in WORDS + ["absent"]]


def _query(pkg, spec):
    occ, terms, msm = spec
    if occ == "T":
        return pkg.TermQuery(pkg.Term("body", terms[0]))
    q = pkg.BooleanQuery(min_should_match=msm)
    for o, t in zip(occ, terms):
        getattr(q, OCC[o])(pkg.TermQuery(pkg.Term("body", t)))
    return q


@pytest.fixture(scope="module", params=["one", "two", "deletes"])
def index(request):
    leaves = _leaves(request.param)
    ref = R.IndexSearcher(
        RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
    )
    specs = _row_specs()
    want = ref.search_batch([_query(R, s) for s in specs], k=K_ALL, prune=False)
    want_single = ref.search_batch(
        [_query(R, s) for s in _single_specs()], k=K_ALL, prune=False
    )

    def port():
        return T.IndexSearcher(
            IndexReader([
                SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
                for i, (p, lv) in enumerate(leaves)
            ]),
            device="cpu",
        )

    return port, specs, want, want_single, ref


@pytest.mark.parametrize("strategy", ["auto", "dense", "candidate"])
def test_slice_matches_reference(index, strategy, monkeypatch):
    port, specs, want, *_ = index
    monkeypatch.setenv("RUCENE_STRATEGY", strategy)
    METRICS.reset()
    searcher = port()
    got = searcher.search_batch([_query(T, s) for s in specs], k=K_ALL)
    assert max(td.total_hits for td in want) < K_ALL
    assert_batches_strict(got, want)
    counters = METRICS.snapshot()["counters"]
    if strategy != "auto":
        assert counters.get(f"search.strategy.{strategy}", 0) > 0
    assert counters["route.device"] == len(specs)
    for k in (1, 10):
        head = searcher.search_batch([_query(T, s) for s in specs], k=k)
        for h, full in zip(head, got):
            assert h.total_hits == full.total_hits
            assert h.score_docs == full.score_docs[:k]


def test_search_and_async_agree(index):
    port, specs, want, *_ = index
    s = port()
    collect = s.search_batch_async([_query(T, x) for x in specs[:8]], k=K_ALL)
    assert_batches_strict(collect(), want[:8])
    assert_batches_strict([s.search(_query(T, specs[0]), k=K_ALL)], want[:1])


def _unported(pkg):
    """Rows beyond plain term / boolean rows, each with the route counter
    it moves."""
    nested = pkg.BooleanQuery()
    inner = pkg.BooleanQuery()
    inner.should(pkg.TermQuery(pkg.Term("body", "fox")))
    inner.should(pkg.TermQuery(pkg.Term("body", "dog")))
    nested.must(inner)
    nested.must(pkg.TermQuery(pkg.Term("body", "the")))
    mixed_phrase = pkg.BooleanQuery()
    mixed_phrase.must(pkg.PhraseQuery("body", ["quick", "fox"]))
    mixed_phrase.should(pkg.TermQuery(pkg.Term("body", "dog")))
    return {
        "mixed_phrase": (mixed_phrase, "route.mixed"),
        "range": (pkg.PointRangeQuery("n", 1, 5), "route.device"),
        "exists": (pkg.ExistsQuery("body"), "route.device"),
        "match_all": (pkg.MatchAllDocsQuery(), "route.device"),
        "dismax": (pkg.DisjunctionMaxQuery(
            [pkg.TermQuery(pkg.Term("body", "fox")), pkg.TermQuery(pkg.Term("body", "dog"))],
            tie_breaker=0.1,
        ), "route.device"),
        "const": (pkg.ConstantScoreQuery(pkg.TermQuery(pkg.Term("body", "fox")), 2.0),
                  "route.device"),
        "group": (nested, "route.host"),
    }


@pytest.mark.parametrize("name", sorted(_unported(T)))
def test_unported_rows_raise(index, name):
    """Each kind beside a term row matches the reference (complete lists,
    and a truncated list is the complete one's head) on its route: range
    and exists rows on the device path, a nested group on the host route.
    None raises."""
    port, *_, ref = index
    q, route = _unported(T)[name]
    rows = [T.TermQuery(T.Term("body", "fox")), q]
    ref_rows = [R.TermQuery(R.Term("body", "fox")), _unported(R)[name][0]]
    want = ref.search_batch(ref_rows, k=K_ALL, prune=False)
    searcher = port()
    METRICS.reset()
    got = searcher.search_batch(rows, k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert counters.get(route, 0) == 1 + (route == "route.device")
    assert_batches_strict(got, want)
    for h, full in zip(searcher.search_batch(rows, k=5), got):
        assert h.total_hits == full.total_hits
        assert h.score_docs == full.score_docs[:5]


def test_packed_matches_reference_and_decoded(index, monkeypatch):
    """RUCENE_DECODED=0: no decoded planes, hits match the reference, and
    equal the port's decoded run bit for bit (complete and truncated)."""
    port, specs, want, *_ = index
    rows = [_query(T, s) for s in specs]
    monkeypatch.setenv("RUCENE_DECODED", "0")
    packed = port()
    got = packed.search_batch(rows, k=K_ALL)
    assert all(lf.device.docs_dec is None for lf in packed.reader.leaves)
    assert_batches_strict(got, want)
    monkeypatch.setenv("RUCENE_DECODED", "1")
    decoded = port()
    assert decoded.search_batch(rows, k=K_ALL) == got
    assert all(lf.device.docs_dec is not None for lf in decoded.reader.leaves)
    assert decoded.search_batch(rows, k=10) == packed.search_batch(rows, k=10)


def test_forced_dedup_on_decoded_is_bit_identical(index, monkeypatch):
    """RUCENE_DEDUP=1 attaches the decode-dedup tables on decoded segments
    too (off by default there): the hits stay bit-identical."""
    port, specs, want, *_ = index
    rows = [_query(T, s) for s in specs]
    monkeypatch.setenv("RUCENE_DECODED", "1")
    METRICS.reset()
    plain = port().search_batch(rows, k=K_ALL)
    assert METRICS.snapshot()["counters"].get("search.decode_dedup_items", 0) == 0
    monkeypatch.setenv("RUCENE_DEDUP", "1")
    deduped = port().search_batch(rows, k=K_ALL)
    assert METRICS.snapshot()["counters"].get("search.decode_dedup_items", 0) > 0
    assert deduped == plain
    assert_batches_strict(deduped, want)


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_routes_by_row_class(index, decoded, monkeypatch):
    """With the split forced on, a mixed batch's term rows take the single
    route, and a single-term batch is one single-route call, unless a leaf
    has deletes: then those rows stay generic. On decoded leaves the
    two-term AND / OR rows take the pair route. Hits match the
    reference."""
    port, specs, want, want_single, _ref = index
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    monkeypatch.setattr(searcher_mod, "SPLIT_MIN_DOCS", 0)
    searcher = port()
    deletes = any(lf.live is not None for lf in searcher.reader.leaves)
    singles = [_query(T, s) for s in _single_specs()]
    n_term = sum(occ == "T" for occ, _, _ in specs)
    METRICS.reset()
    got = searcher.search_batch([_query(T, s) for s in specs], k=K_ALL)
    got_single = searcher.search_batch(singles, k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert_batches_strict(got, want)
    assert_batches_strict(got_single, want_single)
    n_single = 0 if deletes else n_term + len(singles)
    n_pair = sum(occ in ("SS", "MM") for occ, _, _ in specs) if decoded == "1" else 0
    assert counters.get("route.single", 0) == n_single
    # pair rows count per leaf call, as the reference counts them
    assert counters.get("route.pair_rows", 0) == n_pair * len(searcher.reader.leaves)
    assert counters.get("route.flat", 0) == len(specs) + len(singles) - n_single - n_pair

"""Differential fuzz of the port's routes against rucene_tpu, on the CPU
(after tests/test_fuzz_differential.py:31-92).

A two-segment Zipf index built by rucene_tpu, with and without deletes,
its docs carrying an IntPoint ``ts`` and (one in 3) a StringField
``tag``, is carried across with packed_from_reference. Seeded random rows
of every kind go through both packages in one batch:
- TermQuery and BooleanQuery rows: 1-5 clauses of every occur,
  min_should_match 0-2, clause boosts;
- boolean rows with range, exists and prefix clauses of every occur
  beside term clauses, and filter-only rows;
- pure phrase rows (slop 0-2), and mixed rows (term clauses plus one MUST
  or FILTER exact phrase, some with a range FILTER);
- DisjunctionMax, ConstantScore and Boosting rows, and MatchAll rows;
- host rows: nested clause groups, dismax over booleans, match-all
  beside a clause, more than 8 ranges;
- synonym rows (a SpanOrQuery of 2-3 terms) and unordered span-near rows
  (2-3 distinct terms, slop 0-8), drawn after the rows above.
A second fuzz serves random boolean rows sorted by 1-2 numeric doc-values
fields (search_sorted) and collapsed by one (search_collapse) from both
packages, sort values and doc ids exact.
The port runs with the row-class split forced on
(SPLIT_MIN_DOCS = 0) and a tf plane for every term (RUCENE_PLANES=1), on
decoded and on packed leaves, so that every route fires: the single route
(leaves without deletes), the plane and pair routes (decoded leaves: a
term too frequent in one doc for a u8 tf plane keeps its two-term rows
off the planes, so they take the pair route), the
flat executor, the phrase routes and the mixed rows, as their counters
show. Complete hit lists compare under tests/torch_hitcheck.py: rows of
three or more scoring clauses sum in each executor's own order.
"""

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.search import searcher as searcher_mod
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import assert_batches_strict
from tests.torch_route_data import TS_MAX, port_searcher, ref_segments, zipf_texts

K_ALL = 1200  # above every row's hit count: complete lists
# a term with a freq above 255 in one doc of each segment: it gets no u8 tf
# plane, so the rows that hold it take the pair route, not the planes
HOT = "hot"
N_ROWS = 160
N_SPAN_ROWS = 24
OCCURS = ("should", "must", "filter", "must_not")


def _term(pkg, word, boost=1.0):
    return pkg.TermQuery(pkg.Term("body", word), boost=boost)


def _filter_maker(rng):
    """One range, exists or prefix query over the filter fields."""
    u = rng.random()
    if u < 0.5:
        lo = int(rng.integers(-50, TS_MAX))
        hi = lo + int(rng.integers(0, TS_MAX // 3))
        return lambda pkg: pkg.PointRangeQuery("ts", lo, hi)
    if u < 0.7:
        field = str(rng.choice(["tag", "ts", "body", "nope"]))
        return lambda pkg: pkg.ExistsQuery(field)
    prefix, boost = str(rng.choice(["c", "c0", "c1", "c2", "c07", "d"])), float(rng.choice([1.0, 0.5]))
    return lambda pkg: pkg.PrefixQuery("tag", prefix, boost=boost)


def _draw(rng, words, bigrams):
    """One row, as a function that makes it with either package."""
    kind = int(rng.integers(0, 16))
    pick = lambda n: [str(w) for w in rng.choice(words, n, replace=False)]  # noqa: E731
    if kind in (10, 11):  # term clauses beside 1-3 filter clauses
        n = int(rng.integers(0 if kind == 11 else 1, 3))
        terms = pick(n)
        occs = [OCCURS[int(rng.integers(0, 4))] for _ in range(n)]
        filters = [_filter_maker(rng) for _ in range(int(rng.integers(1, 4)))]
        f_occs = [OCCURS[int(rng.integers(0, 4))] for _ in filters]

        def filtered(pkg):
            q = pkg.BooleanQuery()
            for t, o in zip(terms, occs):
                getattr(q, o)(_term(pkg, t))
            for f, o in zip(filters, f_occs):
                getattr(q, o)(f(pkg))
            return q
        return filtered
    if kind == 12:  # a filter alone, or constant-scored
        f, const = _filter_maker(rng), rng.random() < 0.3
        return lambda pkg: pkg.ConstantScoreQuery(f(pkg), 2.0) if const else f(pkg)
    if kind == 13:  # host rows: a nested group, or match-all beside a clause
        terms, occ = pick(3), OCCURS[int(rng.integers(0, 3))]
        match_all = rng.random() < 0.3

        def host(pkg):
            q = pkg.BooleanQuery()
            if match_all:
                q.must(pkg.MatchAllDocsQuery())
                q.should(_term(pkg, terms[0]))
                return q
            inner = pkg.BooleanQuery()
            inner.should(_term(pkg, terms[0]))
            inner.should(_term(pkg, terms[1]))
            getattr(q, occ)(inner)
            q.must(_term(pkg, terms[2]))
            return q
        return host
    if kind == 14:  # host rows: dismax over booleans, or 9 ranges
        terms, nine = pick(3), rng.random() < 0.4
        bounds = [(int(x), int(x) + TS_MAX // 2) for x in rng.integers(0, TS_MAX // 2, 9)]

        def host2(pkg):
            if nine:
                q = pkg.BooleanQuery()
                q.should(_term(pkg, terms[0]))
                for lo, hi in bounds:
                    q.filter(pkg.PointRangeQuery("ts", lo, hi))
                return q
            a = pkg.BooleanQuery()
            a.should(_term(pkg, terms[0]))
            a.should(_term(pkg, terms[1]))
            return pkg.DisjunctionMaxQuery([a, _term(pkg, terms[2])], tie_breaker=0.3)
        return host2
    if kind == 15:  # mixed rows with a range FILTER
        ph, term, f = bigrams[int(rng.integers(0, len(bigrams)))], pick(1)[0], _filter_maker(rng)

        def mixed_range(pkg):
            q = pkg.BooleanQuery()
            q.must(pkg.PhraseQuery("body", list(ph)))
            q.should(_term(pkg, term))
            q.filter(f(pkg))
            return q
        return mixed_range
    if kind == 0:
        w, b = pick(1)[0], float(rng.choice([0.5, 1.0, 2.0]))
        return lambda pkg: _term(pkg, w, b)
    if kind == 3:  # AND2 / OR2: the pair route's rows, with HOT off the planes
        terms = pick(2) if rng.random() < 0.5 else [HOT, pick(1)[0]]
        occ = "should" if rng.random() < 0.5 else "must"

        def pair(pkg):
            q = pkg.BooleanQuery()
            for t in terms:
                getattr(q, occ)(_term(pkg, t))
            return q
        return pair
    if kind in (1, 2):
        n = int(rng.integers(1, 6))
        terms = pick(n)
        occs = [OCCURS[int(rng.integers(0, 4))] for _ in range(n)]
        boosts = [float(rng.choice([1.0, 1.5])) for _ in range(n)]
        msm = int(rng.integers(0, 3))

        def boolean(pkg):
            q = pkg.BooleanQuery(min_should_match=msm)
            for t, o, b in zip(terms, occs, boosts):
                getattr(q, o)(_term(pkg, t, b))
            return q
        return boolean
    if kind == 4:
        ph, slop = bigrams[int(rng.integers(0, len(bigrams)))], int(rng.integers(0, 3))
        return lambda pkg: pkg.PhraseQuery("body", list(ph), slop=slop)
    if kind == 5:
        ph = bigrams[int(rng.integers(0, len(bigrams)))]
        ph_occ = "filter" if rng.random() < 0.3 else "must"
        n = int(rng.integers(1, 3))
        terms = pick(n)
        occs = [OCCURS[int(rng.integers(0, 4))] for _ in range(n)]

        def mixed(pkg):
            q = pkg.BooleanQuery()
            getattr(q, ph_occ)(pkg.PhraseQuery("body", list(ph)))
            for t, o in zip(terms, occs):
                getattr(q, o)(_term(pkg, t))
            return q
        return mixed
    if kind == 6:
        terms, tie = pick(int(rng.integers(2, 4))), float(rng.choice([0.0, 0.3, 1.0]))
        return lambda pkg: pkg.DisjunctionMaxQuery([_term(pkg, t) for t in terms], tie_breaker=tie)
    if kind == 7:
        terms, boost = pick(int(rng.integers(1, 3))), float(rng.choice([0.0, 2.0]))

        def const(pkg):
            q = pkg.BooleanQuery()
            for t in terms:
                q.should(_term(pkg, t))
            return pkg.ConstantScoreQuery(q, boost=boost)
        return const
    if kind == 8:
        pos, neg, f = pick(2), pick(1)[0], float(rng.choice([0.2, 0.5]))

        def boosting(pkg):
            q = pkg.BooleanQuery()
            for t in pos:
                q.should(_term(pkg, t))
            return pkg.BoostingQuery(q, _term(pkg, neg), f)
        return boosting
    boost = float(rng.choice([1.0, 3.0]))
    return lambda pkg: pkg.MatchAllDocsQuery(boost=boost)


def _span_maker(rng, words):
    """A synonym row or an unordered span-near row of distinct terms."""
    from rucene_tpu.search import spans as ref_spans
    from rucene_tpu_torch.search import spans as port_spans

    terms = [str(w) for w in rng.choice(words, int(rng.integers(2, 4)), replace=False)]
    near, slop = rng.random() < 0.5, int(rng.integers(0, 9))

    def span(pkg):
        sp = ref_spans if pkg is R else port_spans
        members = [sp.SpanTermQuery(pkg.Term("body", t)) for t in terms]
        return sp.SpanNearQuery(members, slop=slop, in_order=False) if near else sp.SpanOrQuery(members)
    return span


def _row_makers(texts, words):
    rng = np.random.default_rng(2024)
    bigrams = []
    for t in texts[:200]:
        w = t.split()
        if len(w) >= 2:
            j = int(rng.integers(0, len(w) - 1))
            bigrams.append((w[j], w[j + 1]))
    vocab = words + ["zz_missing"]
    makers = [_draw(rng, vocab, bigrams) for _ in range(N_ROWS)]
    span_rng = np.random.default_rng(2025)
    return makers + [_span_maker(span_rng, words) for _ in range(N_SPAN_ROWS)]


@pytest.fixture(scope="module")
def corpus():
    texts, words = zipf_texts(700, 40, seed=17, lo=3, hi=12)
    texts[349] = texts[699] = " ".join([HOT] * 300 + ["w1"])  # one in each segment
    return ref_segments(texts, 2, filters=True), _row_makers(texts, words)


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("deletes", [False, True])
def test_fuzz_routes_match_reference(corpus, deletes, decoded, monkeypatch):
    segments, makers = corpus
    leaves = [
        (p, (np.arange(p.max_doc) % 7 != i) if deletes else None) for i, p in enumerate(segments)
    ]
    ref = R.IndexSearcher(RefReader([
        RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)
    ]))
    want = ref.search_batch([b(R) for b in makers], k=K_ALL, prune=False)
    assert max(td.total_hits for td in want) < K_ALL
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    monkeypatch.setenv("RUCENE_PLANES", "1")
    monkeypatch.setattr(searcher_mod, "SPLIT_MIN_DOCS", 0)
    phrase_path._PLANE_CACHE.clear()
    METRICS.reset()
    got = port_searcher(leaves).search_batch([b(T) for b in makers], k=K_ALL)
    assert_batches_strict(got, want)
    counters = METRICS.snapshot()["counters"]
    moved = ["route.flat", "route.phrase", "route.mixed", "route.host", "search.strategy.dense",
             "route.synonym", "route.span_unordered"]
    moved += [] if deletes else ["route.single"]
    moved += ["route.plane_rows", "route.pair_rows"] if decoded == "1" else []
    assert all(counters.get(name, 0) > 0 for name in moved), sorted(counters.items())


@pytest.mark.parametrize("deletes", [False, True])
def test_fuzz_sorted_and_collapse_rows(deletes):
    """Random boolean rows (1-4 term clauses of every occur, some with a
    range) sorted by one or two doc-values fields in random directions,
    and collapsed by one, from two segments: the reference's field docs
    exactly, its collapse keys' best docs exactly."""
    from rucene_tpu.search import sort_field as ref_sf
    from rucene_tpu_torch.search import sort_field as port_sf
    from tests.torch_surface_data import assert_field_docs_equal, both, dv_docs, leaves_for

    ref, port = both(leaves_for(dv_docs(360, 41), 2, deletes, seed=41))
    rng = np.random.default_rng(77)
    from tests.conftest import WORDS

    for _ in range(24):
        n = int(rng.integers(1, 5))
        terms = [str(w) for w in rng.choice(WORDS, n, replace=False)]
        occs = [OCCURS[int(rng.integers(0, 4))] for _ in range(n)]
        with_range = rng.random() < 0.3
        fields = [str(f) for f in rng.choice(["price", "stock", "grp"], int(rng.integers(1, 3)), replace=False)]
        revs = [bool(rng.random() < 0.5) for _ in fields]
        collapse = str(rng.choice(["grp", "price"]))
        k = int(rng.choice([5, 40]))

        def row(pkg):
            q = pkg.BooleanQuery()
            for t, o in zip(terms, occs):
                getattr(q, o)(_term(pkg, t))
            if with_range or all(o == "must_not" for o in occs):
                q.filter(pkg.PointRangeQuery("nope", 0, 1) if with_range else pkg.MatchAllDocsQuery())
            return q

        def sort(sf):
            return sf.Sort([sf.SortField(f, sf.SortFieldType.LONG, reverse=r) for f, r in zip(fields, revs)])

        assert_field_docs_equal(port.search_sorted(row(T), k, sort(port_sf)),
                                ref.search_sorted(row(R), k, sort(ref_sf)))
        got, want = port.search_collapse(row(T), k, collapse), ref.search_collapse(row(R), k, collapse)
        assert got.total_hits == want.total_hits
        assert [d for d, _ in got.score_docs] == [d for d, _ in want.score_docs]
        assert_batches_strict([got], [want])

"""Differential fuzz of the port's routes against rucene_tpu, on the CPU
(after tests/test_fuzz_differential.py:31-92).

A two-segment Zipf index built by rucene_tpu, with and without deletes,
is carried across with packed_from_reference. Seeded random rows of every
kind the port serves go through both packages in one batch:
- TermQuery and BooleanQuery rows: 1-5 clauses of every occur,
  min_should_match 0-2, clause boosts;
- pure phrase rows (slop 0-2), and mixed rows (term clauses plus one MUST
  or FILTER exact phrase);
- DisjunctionMax, ConstantScore and Boosting rows, and MatchAll rows.
Rows whose rewrite the port does not serve (host evaluation) are
redrawn. The port runs with the row-class split forced on
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
from tests.torch_route_data import port_searcher, ref_segments, zipf_texts

K_ALL = 1200  # above every row's hit count: complete lists
# a term with a freq above 255 in one doc of each segment: it gets no u8 tf
# plane, so the rows that hold it take the pair route, not the planes
HOT = "hot"
N_ROWS = 160
OCCURS = ("should", "must", "filter", "must_not")


def _term(pkg, word, boost=1.0):
    return pkg.TermQuery(pkg.Term("body", word), boost=boost)


def _draw(rng, words, bigrams):
    """One row, as a function that makes it with either package."""
    kind = int(rng.integers(0, 10))
    pick = lambda n: [str(w) for w in rng.choice(words, n, replace=False)]  # noqa: E731
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


def _row_makers(texts, words):
    rng = np.random.default_rng(2024)
    bigrams = []
    for t in texts[:200]:
        w = t.split()
        if len(w) >= 2:
            j = int(rng.integers(0, len(w) - 1))
            bigrams.append((w[j], w[j + 1]))
    vocab = words + ["zz_missing"]
    out = []
    while len(out) < N_ROWS:
        build = _draw(rng, vocab, bigrams)
        try:
            rq = build(T).rewrite()
        except NotImplementedError:  # _NeedsHostEval too: host evaluation
            continue
        if searcher_mod.unported_reason(rq) is None:
            out.append(build)
    return out


@pytest.fixture(scope="module")
def corpus():
    texts, words = zipf_texts(700, 40, seed=17, lo=3, hi=12)
    texts[349] = texts[699] = " ".join([HOT] * 300 + ["w1"])  # one in each segment
    return ref_segments(texts, 2), _row_makers(texts, words)


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
    moved = ["route.flat", "route.phrase", "route.mixed"]
    moved += [] if deletes else ["route.single"]
    moved += ["route.plane_rows", "route.pair_rows"] if decoded == "1" else []
    assert all(counters.get(name, 0) > 0 for name in moved), counters

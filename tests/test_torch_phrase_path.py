"""Pure phrase rows end to end on the CPU: the port's IndexSearcher against
rucene_tpu's on one index built by rucene_tpu (carried across with
packed_from_reference), route by route.

Each case pins a route through the searchers' instance attributes, as
tests/test_phrase_device.py does (PHRASE_SCALAR_MAX_DOCS,
PHRASE_PLANE_MIN_DOCS, PHRASE_PLANE_ITEM_MIN), on both searchers, and
asserts the port's route counters. Hits compare under
tests/torch_hitcheck.py (complete lists, scores within 4e-7), with the
port's segments packed (RUCENE_DECODED=0: K1's twin decodes the work) and
decoded. Every row set holds a phrase with a term absent from the index.
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
from rucene_tpu_torch.native import available as native_available
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.search.searcher import device_row
from rucene_tpu_torch.util.metrics import METRICS
from tests.conftest import WORDS, make_docs, random_corpus
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 1000


def _pack(texts):
    buf = SegmentBuffer()
    for d in make_docs(texts):
        buf.add_document(d)
    return pack_segment(buf.finish())


def _texts(seed=41, n=600):
    return random_corpus(np.random.default_rng(seed), n)


def _overflow_texts():
    """A doc with 40 "hot" (past the candidate tables' 32 occurrences: the
    row retries on planes) and one with 80 (past the planes' 64: the row
    goes to the scalar engine), among ordinary docs."""
    rng = np.random.default_rng(5)
    base = random_corpus(rng, 300)
    return (base[:100] + ["hot " * 40 + "spot cold"] + base[100:200]
            + ["hot " * 80 + "spot"] + ["hot spot here"] * 5 + ["hot cold"] * 3 + base[200:])


def _phrase_specs(texts, seed, n=24, slop=0):
    """(terms, slop) rows: bigrams and trigrams from the corpus text, a
    repeated term, random pairs, and a phrase with an absent term."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = texts[int(rng.integers(0, len(texts)))].split()
        if len(words) < 3 or i % 6 == 5:
            out.append(([str(t) for t in rng.choice(WORDS, 2)], slop))
            continue
        j = int(rng.integers(0, len(words) - 2))
        out.append((words[j : j + (3 if i % 3 == 0 else 2)], slop))
    out.append((["quick", "absent"], slop))
    out.append((["brown", "brown"], slop))
    return out


def _phrase(pkg, spec):
    terms, slop = spec
    return pkg.PhraseQuery("body", list(terms), slop=slop)


def _mixed(pkg, spec):
    """A term row, an OR row and an AND row around each phrase row."""
    if spec[0] == "T":
        return pkg.TermQuery(pkg.Term("body", spec[1]))
    if spec[0] in ("OR", "AND"):
        q = pkg.BooleanQuery()
        for t in spec[1]:
            (q.should if spec[0] == "OR" else q.must)(pkg.TermQuery(pkg.Term("body", t)))
        return q
    return _phrase(pkg, spec[1])


def _mixed_specs(texts):
    out = []
    for i, ph in enumerate(_phrase_specs(texts, seed=8, n=12)):
        a, b = WORDS[i % len(WORDS)], WORDS[(3 * i + 1) % len(WORDS)]
        out += [("T", a), ("OR", [a, b]), ("AND", [b, a]), ("P", ph)]
    return out


CAND = {"PHRASE_SCALAR_MAX_DOCS": 0}
PLANES = {"PHRASE_SCALAR_MAX_DOCS": 0, "PHRASE_PLANE_MIN_DOCS": 1, "PHRASE_PLANE_ITEM_MIN": 1}

# name -> (texts, deletes?, row specs, query builder, pins, counters that must be > 0)
CASES = {
    "candidate_exact": (_texts, False, lambda t: _phrase_specs(t, 1), _phrase, CAND,
                        ["search.phrase_device"]),
    "candidate_sloppy": (_texts, False, lambda t: _phrase_specs(t, 2, slop=2)
                         + _phrase_specs(t, 3, n=6, slop=5), _phrase, CAND,
                         ["search.phrase_device"]),
    "planes": (_texts, False, lambda t: _phrase_specs(t, 4), _phrase, PLANES,
               ["search.phrase_plane", "search.phrase_plane_build"]),
    "scalar": (_texts, False, lambda t: _phrase_specs(t, 5), _phrase, {},
               ["search.phrase_scalar_route"]),
    "overflow": (_overflow_texts, False,
                 lambda t: [(["hot", "spot"], 0), (["hot", "cold"], 0), (["spot", "cold"], 0)]
                 + _phrase_specs(t, 6, n=8), _phrase, CAND,
                 ["search.phrase_device", "search.phrase_plane", "search.phrase_host_fallback"]),
    "deletes": (_texts, True, lambda t: _phrase_specs(t, 7) + _phrase_specs(t, 9, n=6, slop=3),
                _phrase, CAND, ["search.phrase_device"]),
    "mixed_batch": (_texts, False, _mixed_specs, _mixed, CAND,
                    ["search.phrase_device", "route.device", "route.phrase"]),
}


def _pin(searcher, pins):
    for name, v in pins.items():
        setattr(searcher, name, v)
    return searcher


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name = request.param
    make_texts, deletes, make_specs, build, pins, counters = CASES[name]
    if name in ("scalar", "overflow") and not native_available:
        pytest.skip("native scalar engine unavailable")
    texts = make_texts()
    packed = _pack(texts)
    live = np.random.default_rng(17).random(packed.max_doc) > 0.3 if deletes else None
    specs = make_specs(texts)
    ref = _pin(R.IndexSearcher(RefReader([RefSnapshot("s0", packed, live=live)])), pins)
    want = ref.search_batch([build(R, s) for s in specs], k=K_ALL, prune=False)
    assert max(td.total_hits for td in want) < K_ALL
    assert any(td.total_hits for td in want)
    port_packed = packed_from_reference(packed)

    def port():
        reader = IndexReader([SegmentSnapshot("s0", port_packed, live=live)])
        return _pin(T.IndexSearcher(reader, device="cpu"), pins)

    return name, port, [build(T, s) for s in specs], want, counters


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_route_matches_reference(case, decoded, monkeypatch):
    name, port, rows, want, counters = case
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    phrase_path._PLANE_CACHE.clear()
    METRICS.reset()
    searcher = port()
    got = searcher.search_batch(rows, k=K_ALL)
    assert_batches_strict(got, want)
    snap = METRICS.snapshot()["counters"]
    for c in counters:
        assert snap.get(c, 0) > 0, (c, snap)
    n_phrase = sum(isinstance(q, T.PhraseQuery) for q in rows)
    assert snap.get("route.phrase", 0) == n_phrase
    assert snap.get("route.device", 0) == len(rows) - n_phrase
    if name == "scalar":
        assert snap["search.phrase_scalar_route"] == sum(q.slop == 0 for q in rows)
    assert all((lf.device.docs_dec is None) == (decoded == "0") for lf in searcher.reader.leaves)
    # a truncated list is the head of the complete one
    for h, full in zip(searcher.search_batch(rows, k=5), got):
        assert h.total_hits == full.total_hits
        assert h.score_docs == full.score_docs[:5]


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_sloppy_overflow_raises_item9(decoded, monkeypatch):
    """A sloppy row whose candidates overflow the tables has no device
    route and no scalar route: the host engine evaluates it, as in the
    reference (counted under search.phrase_host_fallback), and its answer
    equals the reference's."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    packed = _pack(_overflow_texts())
    rows = [("spot", "cold"), ("hot", "spot")]
    ref = _pin(R.IndexSearcher(RefReader([RefSnapshot("s0", packed)])), CAND)
    want = ref.search_batch([R.PhraseQuery("body", list(r), slop=1) for r in rows], k=K_ALL)
    reader = IndexReader([SegmentSnapshot("s0", packed_from_reference(packed))])
    searcher = _pin(T.IndexSearcher(reader, device="cpu"), CAND)
    METRICS.reset()
    got = searcher.search_batch([T.PhraseQuery("body", list(r), slop=1) for r in rows], k=K_ALL)
    assert METRICS.snapshot()["counters"].get("search.phrase_host_fallback", 0) == 1
    assert got[0].total_hits > 0 and got[1].total_hits > 0
    assert_batches_strict(got, want)


def _phrase_rows(pkg):
    """Rows with phrases, each with the route it takes."""
    mixed = pkg.BooleanQuery()
    mixed.must(pkg.PhraseQuery("body", ["quick", "fox"]))
    mixed.should(pkg.TermQuery(pkg.Term("body", "dog")))
    should = pkg.BooleanQuery()
    should.should(pkg.PhraseQuery("body", ["quick", "fox"]))
    filt = pkg.BooleanQuery()
    filt.filter(pkg.PhraseQuery("body", ["quick", "fox"]))
    return {
        "exact": (pkg.PhraseQuery("body", ["quick", "fox"]), "route.phrase"),
        "sloppy": (pkg.PhraseQuery("body", ["quick", "fox", "dog"], slop=32), "route.phrase"),
        "should": (should, "route.phrase"),
        "eight": (pkg.PhraseQuery("body", ["the"] * 8), "route.phrase"),
        "mixed": (mixed, "route.mixed"),
        "filter": (filt, "route.host"),
        "gapped": (pkg.PhraseQuery("body", ["quick", "fox"], positions=[0, 2]), "route.host"),
        "nine": (pkg.PhraseQuery("body", ["the"] * 9), "route.host"),
        "slop": (pkg.PhraseQuery("body", ["quick", "fox"], slop=33), "route.host"),
    }


@pytest.mark.parametrize("name", sorted(_phrase_rows(T)))
def test_phrase_routing_agrees_with_unported_reason(name):
    """A row with phrases takes the phrase route, the mixed route or the
    host route as the reference routes it (never the device rows' path),
    counted, and is answered as the reference answers it."""
    q, route = _phrase_rows(T)[name]
    packed = _pack(_texts(n=50))
    searcher = T.IndexSearcher(
        IndexReader([SegmentSnapshot("s0", packed_from_reference(packed))]), device="cpu",
    )
    rq = q.rewrite()
    assert not device_row(rq)
    assert searcher._phrase_device_eligible(rq) == (route == "route.phrase")
    assert searcher._mixed_device_eligible(rq) == (route == "route.mixed")
    ref = R.IndexSearcher(RefReader([RefSnapshot("s0", packed)]))
    METRICS.reset()
    got = searcher.search(q, k=K_ALL)
    assert METRICS.snapshot()["counters"].get(route, 0) == 1
    assert_batches_strict([got], [ref.search(_phrase_rows(R)[name][0], k=K_ALL)])

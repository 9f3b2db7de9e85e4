"""Mixed boolean rows (term clauses plus one required exact phrase) on the
port's device path (search/phrase_path._search_mixed_device over
executor.execute_mixed_planes) against rucene_tpu, on the CPU.

One Zipf corpus built by rucene_tpu (one segment, two segments, each
with and without deletes) is carried across with packed_from_reference
and served by both packages; the port's leaves are decoded
(RUCENE_DECODED=1: lane gathers from the residency) and packed (=0: the
scoring decode's twin). The rows cover the cases of
tests/test_mixed_boolean_device.py: every occur of the term clauses, a
FILTER phrase, all-MUST_NOT term clauses (the phrase alone decides the
match), a phrase term absent from one leaf and from the index. Complete
hit lists compare under tests/torch_hitcheck.py (a row holds at most two
scoring term clauses and the phrase); a truncated list must be the
bit-exact head of the complete one, and the packed run must equal the
decoded one bit for bit.

Rows outside the mixed route (a SHOULD phrase, slop 1, nine terms or a
gap) take the host route, as the reference's do, and a range clause
rides the mixed route as a filter plane; each is answered as the
reference answers it. So are the two spills the reference reruns on its
host engine, each counted under ``search.mixed_host_spill``: a row whose
planes admission denied, and a row whose term matches meet a plane's
overflow column (a phrase past PMAX positions).
"""

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.util.metrics import METRICS as REF_METRICS
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.ops import cuda_combine, cuda_decode
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 1000
OCC = {"S": "should", "M": "must", "F": "filter", "N": "must_not"}
# a phrase only the first segment holds ("solo" docs go there)
SOLO = ["solo1", "solo2"]


def _texts(n=500, seed=21):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)]
    probs = 1.0 / np.arange(1, 41) ** 1.1
    probs /= probs.sum()
    texts = [
        " ".join(rng.choice(words, size=int(rng.integers(5, 25)), p=probs))
        for _ in range(n)
    ]
    for i in range(0, 60, 6):  # in the first segment of either layout
        texts[i] = texts[i] + " solo1 solo2 w1"
    return texts


def _pack(texts):
    buf = SegmentBuffer()
    for t in texts:
        d = R.Document()
        d.add(R.TextField("body", t))
        buf.add_document(d)
    return pack_segment(buf.finish())


def _leaves(n_segments: int, deletes: bool, texts=None):
    texts = _texts() if texts is None else texts
    bounds = np.linspace(0, len(texts), n_segments + 1).astype(int)
    out = []
    for s in range(n_segments):
        packed = _pack(texts[bounds[s] : bounds[s + 1]])
        live = None
        if deletes:
            live = np.ones(packed.max_doc, bool)
            live[s::5] = False
        out.append((packed, live))
    return out


def _bigrams(texts, n):
    out = []
    for t in texts[60:]:
        w = t.split()
        for j in range(0, len(w) - 1, 3):
            out.append([w[j], w[j + 1]])
            if len(out) >= n:
                return out
    return out


def _row_specs(texts):
    """(phrase terms, phrase occur, [(occur letter, term)]) rows: every
    occur of one and two term clauses around a corpus bigram, a trigram,
    a FILTER phrase, all-MUST_NOT clauses, a phrase of one leaf, and
    phrases with a term absent from the index."""
    clause_sets = [
        [("S", "w0")], [("M", "w0")], [("F", "w1")], [("N", "w3")],
        [("S", "w1"), ("S", "w2")], [("M", "w0"), ("S", "w4")],
        [("S", "w0"), ("N", "w3")], [("M", "w2"), ("F", "w5")],
        [("F", "w1"), ("S", "w6")], [("N", "w2"), ("N", "w7")],
        [("M", "w0"), ("N", "w1")], [("S", "w9"), ("F", "w0")],
    ]
    rows = []
    for i, ph in enumerate(_bigrams(texts, 24)):
        rows.append((ph, "M" if i % 4 else "F", clause_sets[i % len(clause_sets)]))
    words = texts[70].split()
    rows.append((words[:3], "M", [("S", "w0"), ("S", "w1")]))
    rows.append((SOLO, "M", [("S", "w1")]))
    rows.append((SOLO, "F", [("N", "w3")]))
    rows.append((["w0", "zz_missing"], "M", [("S", "w1")]))
    rows.append((["w1", "w0"], "M", [("M", "zz_missing")]))
    return rows


def _query(pkg, spec):
    terms, ph_occ, clauses = spec
    q = pkg.BooleanQuery()
    getattr(q, OCC[ph_occ])(pkg.PhraseQuery("body", list(terms)))
    for occ, t in clauses:
        getattr(q, OCC[occ])(pkg.TermQuery(pkg.Term("body", t)))
    return q


def _ref_searcher(leaves):
    return R.IndexSearcher(
        RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
    )


def _port_searcher(leaves):
    return T.IndexSearcher(
        IndexReader([
            SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
            for i, (p, lv) in enumerate(leaves)
        ]),
        device="cpu",
    )


@pytest.fixture(scope="module", params=["one", "two", "one_deletes", "two_deletes"])
def index(request):
    n_segments = 2 if request.param.startswith("two") else 1
    texts = _texts()
    leaves = _leaves(n_segments, request.param.endswith("deletes"), texts)
    specs = _row_specs(texts)
    want = _ref_searcher(leaves).search_batch([_query(R, s) for s in specs], k=K_ALL)
    assert max(td.total_hits for td in want) < K_ALL
    assert sum(td.total_hits > 0 for td in want) >= len(specs) // 2
    return leaves, specs, want


def _serve(leaves, specs, k, decoded, monkeypatch):
    """The port's answer, with the calls of the combine's and the scoring
    decode's plain twins (what their wrappers run on CPU tensors)."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    calls = {"combine": 0, "decode_score": 0}

    def counted(name, fn):
        def wrap(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(cuda_combine, "combine_lanes_plain",
                        counted("combine", cuda_combine.combine_lanes_plain))
    monkeypatch.setattr(cuda_decode, "decode_score_blocks_plain",
                        counted("decode_score", cuda_decode.decode_score_blocks_plain))
    phrase_path._PLANE_CACHE.clear()
    METRICS.reset()
    searcher = _port_searcher(leaves)
    got = searcher.search_batch([_query(T, s) for s in specs], k=k)
    return searcher, got, dict(METRICS.snapshot()["counters"], **calls)


def test_mixed_matches_reference(index, monkeypatch):
    leaves, specs, want = index
    runs = {}
    for decoded in ("1", "0"):
        searcher, got, counters = _serve(leaves, specs, K_ALL, decoded, monkeypatch)
        assert counters.get("route.mixed", 0) == len(specs)
        assert counters.get("route.device", 0) == counters.get("route.phrase", 0) == 0
        assert counters.get("search.mixed_host_spill", 0) == 0
        assert counters["combine"] > 0  # the dense term accumulators
        assert (counters["decode_score"] > 0) == (decoded == "0")
        assert all((lf.device.docs_dec is None) == (decoded == "0") for lf in searcher.reader.leaves)
        assert_batches_strict(got, want)
        runs[decoded] = got
        for h, full in zip(searcher.search_batch([_query(T, s) for s in specs], k=5), got):
            assert h.total_hits == full.total_hits
            assert h.score_docs == full.score_docs[:5]
    assert runs["0"] == runs["1"]


def test_mixed_rows_beside_term_and_phrase_rows(index, monkeypatch):
    """A batch of term, pure phrase and mixed rows: each kind on its route
    (counted), every row as the reference answers it."""
    leaves, specs, want = index
    rows = [("T", "w2"), ("P", ["w0", "w1"])] + [("X", s) for s in specs[:8]]

    def build(pkg, row):
        kind, spec = row
        if kind == "T":
            return pkg.TermQuery(pkg.Term("body", spec))
        if kind == "P":
            return pkg.PhraseQuery("body", spec)
        return _query(pkg, spec)

    ref_want = _ref_searcher(leaves).search_batch([build(R, r) for r in rows], k=K_ALL)
    monkeypatch.setenv("RUCENE_DECODED", "1")
    METRICS.reset()
    got = _port_searcher(leaves).search_batch([build(T, r) for r in rows], k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert (counters["route.device"], counters["route.phrase"], counters["route.mixed"]) == (1, 1, 8)
    assert_batches_strict(got, ref_want)


def _boundary_rows(pkg):
    """Rows with term clauses and a phrase at the mixed route's edges, each
    with the route it takes."""
    def row(phrase, occ="must", extra=None):
        q = pkg.BooleanQuery()
        getattr(q, occ)(phrase)
        q.should(pkg.TermQuery(pkg.Term("body", "w0")))
        if extra is not None:
            q.filter(extra)
        return q

    return {
        "should_phrase": (row(pkg.PhraseQuery("body", ["w0", "w1"]), "should"), "route.host"),
        "slop1": (row(pkg.PhraseQuery("body", ["w0", "w1"], slop=1)), "route.host"),
        "nine_terms": (row(pkg.PhraseQuery("body", ["w0"] * 9)), "route.host"),
        "gapped": (row(pkg.PhraseQuery("body", ["w0", "w1"], positions=[0, 2])), "route.host"),
        "range": (row(pkg.PhraseQuery("body", ["w0", "w1"]),
                      extra=pkg.PointRangeQuery("n", 1, 5)), "route.mixed"),
    }


@pytest.mark.parametrize("name", sorted(_boundary_rows(T)))
def test_mixed_eligibility_boundaries(name):
    q, route = _boundary_rows(T)[name]
    leaves = _leaves(1, False)
    searcher = _port_searcher(leaves)
    rq = q.rewrite()
    assert searcher._mixed_device_eligible(rq) == (route == "route.mixed")
    assert not searcher._phrase_device_eligible(rq)
    want = _ref_searcher(leaves).search_batch([_boundary_rows(R)[name][0]], k=K_ALL)
    METRICS.reset()
    got = searcher.search_batch([q], k=K_ALL)
    assert METRICS.snapshot()["counters"].get(route, 0) == 1
    assert_batches_strict(got, want)


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_admission_denied_row_raises_item9(decoded, monkeypatch):
    """A row whose phrase planes admission denies (forced: admission on at
    any size, an empty resident set) is the reference's host rerun: it is
    counted under search.mixed_host_spill and answered on the host route,
    equal to the reference."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    leaves = _leaves(1, False)
    specs = _row_specs(_texts())[:4]
    want = _ref_searcher(leaves).search_batch([_query(R, s) for s in specs], k=K_ALL)
    phrase_path._PLANE_CACHE.clear()
    searcher = _port_searcher(leaves)
    searcher.PLANE_ADMIT_MIN_DOCS = 0
    searcher._plane_resident_terms = lambda leaf, field: ((), frozenset())
    METRICS.reset()
    got = searcher.search_batch([_query(T, s) for s in specs], k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert counters.get("search.mixed_host_spill", 0) == len(specs)
    assert counters.get("search.phrase_plane_denied", 0) > 0
    assert_batches_strict(got, want)


def _overflow_texts():
    """Ordinary docs, and one where "hot spot" also stands past position
    128 (the width of a four-word plane): its plane overflows there."""
    base = _texts(200, seed=3)
    return base[:100] + ["hot spot " + "w0 " * 140 + "hot spot"] + ["hot spot w0"] * 4 + base[100:]


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_plane_overflow_row_raises_item9(decoded, monkeypatch):
    """A row whose term matches meet a doc the phrase planes flag for the
    host (ov_count > 0): the reference reruns it on its host engine and
    counts it; so does the port, and both rows equal the reference's (the
    row that misses that doc is served on the device)."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    leaves = [(_pack(_overflow_texts()), None)]
    hot = ("hot spot".split(), "M", [("M", "w0")])
    cold = ("hot spot".split(), "M", [("N", "w0")])
    REF_METRICS.reset()
    want = _ref_searcher(leaves).search_batch([_query(R, hot), _query(R, cold)], k=K_ALL)
    assert REF_METRICS.snapshot()["counters"].get("search.mixed_host_spill", 0) == 1
    phrase_path._PLANE_CACHE.clear()
    searcher = _port_searcher(leaves)
    METRICS.reset()
    got = searcher.search_batch([_query(T, hot), _query(T, cold)], k=K_ALL)
    assert METRICS.snapshot()["counters"].get("search.mixed_host_spill", 0) == 1
    assert_batches_strict(got, want)

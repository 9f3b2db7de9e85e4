"""The port's sharded search (rucene_tpu_torch/parallel/sharded.py) against
rucene_tpu's on the CPU, after tests/test_sharded.py.

The same segments, packed by rucene_tpu and carried across with
packed_from_reference, serve the reference's ShardedSearcher on a mesh of
its 8 virtual CPU devices and the port's on meshes of S x dp = 4 x 1 and
2 x 2 CPU cells (one CPU device named in each cell): terms, booleans,
fewer and more segments than shards, match-all, phrases in the shard
program, fallback rows, and ranges in the shard program, decoded and
packed. Every TopDocs equals the reference's sharded and one-reader
answers under tests/torch_hitcheck.py's strict rules over complete hit
lists (scores within RTOL 4e-7), and the route counters say which rows the
mesh took.
"""

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.parallel import sharded as ref_sharded
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.parallel import sharded
from rucene_tpu_torch.util.metrics import METRICS
from tests.conftest import WORDS, random_corpus
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 1000
MESHES = [(4, 1), (2, 2)]


def _segments(parts, filters=False, seed=31):
    rng = np.random.default_rng(seed)
    out = []
    for part in parts:
        buf = SegmentBuffer()
        for i, t in enumerate(part):
            d = R.Document()
            d.add(R.TextField("body", t))
            if filters:
                d.add(R.IntPoint("price", int(rng.integers(0, 100))))
                if i % 2 == 0:
                    d.add(R.NumericDocValuesField("rank", i))
            buf.add_document(d)
        out.append(pack_segment(buf.finish()))
    return out


def _check(segs, make_rows, mesh, k=K_ALL, decoded="1", monkeypatch=None, no_fallback=False):
    """The port's sharded answers against the reference's sharded and
    one-reader answers; returns the port's route counters."""
    if monkeypatch is not None:
        monkeypatch.setenv("RUCENE_DECODED", decoded)
    ref_reader = RefReader([RefSnapshot(f"p{i}", p) for i, p in enumerate(segs)])
    want = R.IndexSearcher(ref_reader).search_batch(make_rows(R), k=k)
    ref_mesh = ref_sharded.make_mesh(n_shards=mesh[0], n_dp=2)
    want_sh = ref_sharded.ShardedSearcher(
        ref_sharded.ShardedIndex(ref_mesh, ref_reader)
    ).search_batch(make_rows(R), k=k)
    reader = IndexReader([SegmentSnapshot(f"p{i}", packed_from_reference(p))
                          for i, p in enumerate(segs)])
    s, dp = mesh
    ss = sharded.ShardedSearcher(
        sharded.ShardedIndex(sharded.make_mesh(s, dp, devices=["cpu"] * (s * dp)), reader)
    )
    METRICS.reset()
    got = ss.search_batch(make_rows(T), k=k)
    counters = METRICS.snapshot()["counters"]
    if no_fallback:
        assert ss._fallback is None and counters.get("route.mesh_fallback", 0) == 0
    assert_batches_strict(got, want)
    assert_batches_strict(got, want_sh)
    return counters, ss


@pytest.fixture(scope="module")
def four_segments():
    corpus = random_corpus(np.random.default_rng(99), 400)
    return _segments([corpus[0:90], corpus[90:210], corpus[210:290], corpus[290:400]])


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_term_queries(four_segments, monkeypatch, mesh, decoded):
    rows = lambda P: [P.TermQuery(P.Term("body", w))  # noqa: E731
                      for w in ["the", "fox", "tensor", "merge", "pack", "dog"]]
    counters, _ = _check(four_segments, rows, mesh, decoded=decoded, monkeypatch=monkeypatch,
                         no_fallback=True)
    assert counters["route.mesh"] == 6


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_boolean_queries(four_segments, monkeypatch, mesh, decoded):
    rng = np.random.default_rng(3)
    picks = [rng.choice(WORDS, size=3, replace=False) for _ in range(8)]

    def rows(P):
        out = []
        for w in picks:
            q = P.BooleanQuery()
            q.must(P.TermQuery(P.Term("body", w[0])))
            q.should(P.TermQuery(P.Term("body", w[1])))
            q.must_not(P.TermQuery(P.Term("body", w[2])))
            out.append(q)
        return out

    counters, _ = _check(four_segments, rows, mesh, decoded=decoded, monkeypatch=monkeypatch,
                         no_fallback=True)
    assert counters["route.mesh"] == 8


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_fewer_segments_than_shards(mesh):
    corpus = random_corpus(np.random.default_rng(17), 120)
    segs = _segments([corpus[:50], corpus[50:]])
    rows = lambda P: [P.TermQuery(P.Term("body", "the")), P.TermQuery(P.Term("body", "fox"))]  # noqa: E731
    _check(segs, rows, mesh, no_fallback=True)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_more_segments_than_shards(mesh):
    corpus = random_corpus(np.random.default_rng(23), 320)
    segs = _segments([corpus[i * 20 : (i + 1) * 20] for i in range(16)])

    def rows(P):
        out = [P.TermQuery(P.Term("body", w)) for w in ["the", "fox", "engine", "dog"]]
        out.append(P.BooleanQuery().must(P.TermQuery(P.Term("body", "quick")))
                   .should(P.TermQuery(P.Term("body", "lazy"))))
        return out

    _check(segs, rows, mesh, no_fallback=True)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_match_all_and_mixed(four_segments, mesh):
    rows = lambda P: [  # noqa: E731
        P.MatchAllDocsQuery(), P.TermQuery(P.Term("body", "fox")),
        P.MatchAllDocsQuery(boost=2.5), P.TermQuery(P.Term("body", "engine")),
    ]
    counters, _ = _check(four_segments, rows, mesh, no_fallback=True)
    assert counters["route.mesh"] == 4


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_phrases_in_program(four_segments, monkeypatch, mesh, decoded):
    """Pure phrase rows run in the shard program, not on the fallback."""
    rows = lambda P: [  # noqa: E731
        P.PhraseQuery("body", ["quick", "brown"]), P.TermQuery(P.Term("body", "fox")),
        P.PhraseQuery("body", ["lazy", "dog"]), P.PhraseQuery("body", ["quick", "brown", "fox"]),
        P.PhraseQuery("body", ["the", "quick"], slop=2),
    ]
    counters, _ = _check(four_segments, rows, mesh, decoded=decoded, monkeypatch=monkeypatch,
                         no_fallback=True)
    assert counters["route.mesh_phrase"] == 4 and counters["route.mesh"] == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_fallback_rows(four_segments, mesh):
    """Rows outside the shard program (a phrase beside a term, a nested
    group, dismax) answer through one cached per-leaf searcher."""
    def rows(P):
        mixed = P.BooleanQuery()
        mixed.must(P.PhraseQuery("body", ["quick", "brown"]))
        mixed.must(P.TermQuery(P.Term("body", "fox")))
        inner = P.BooleanQuery().should(P.TermQuery(P.Term("body", "lazy"))).should(
            P.TermQuery(P.Term("body", "dog")))
        grouped = P.BooleanQuery().must(inner).must(P.TermQuery(P.Term("body", "the")))
        dm = P.DisjunctionMaxQuery(
            [P.TermQuery(P.Term("body", "fox")), P.TermQuery(P.Term("body", "the"))],
            tie_breaker=0.3,
        )
        return [mixed, P.TermQuery(P.Term("body", "dog")), grouped, dm]

    counters, ss = _check(four_segments, rows, mesh)
    assert counters["route.mesh_fallback"] == 3 and counters["route.mesh"] == 1
    fb = ss._fallback
    assert fb is not None
    ss.search_batch(rows(T)[:1], k=5)
    assert ss._fallback is fb


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_ranges_in_program(monkeypatch, mesh, decoded):
    """Range and exists rows run in the shard program (filter planes a
    shard), on both executor branches."""
    rng = np.random.default_rng(31)
    parts = [[" ".join(f"w{rng.integers(0, 20)}" for _ in range(10)) for _ in range(200)]
             for _ in range(4)]
    segs = _segments(parts, filters=True)

    def rows(P):
        tq = lambda t: P.TermQuery(P.Term("body", t))  # noqa: E731
        return [
            P.PointRangeQuery("price", 10, 60),
            P.BooleanQuery().must(tq("w3")).filter(P.PointRangeQuery("price", 0, 50)),
            P.BooleanQuery().should(tq("w5")).should(P.PointRangeQuery("price", 80, 99)),
            P.ExistsQuery("rank"),
            P.BooleanQuery().must(tq("w1")).must_not(P.PointRangeQuery("price", 20, 90)),
        ]

    counters, _ = _check(segs, rows, mesh, k=50, decoded=decoded, monkeypatch=monkeypatch,
                         no_fallback=True)
    assert counters["route.mesh"] == 5


def test_make_mesh_needs_enough_devices():
    with pytest.raises(ValueError):
        sharded.make_mesh(4, 1, devices=["cpu"] * 3)
    mesh = sharded.make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"shard": 2, "dp": 2} and not mesh.multi_process


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_sharded_both_executor_branches(monkeypatch, decoded):
    """A one-segment 12,000-doc index split over 4 shards: rows of rare
    terms take the candidate branch a shard, head-term rows the dense one
    (the combine kernel's twin on the CPU)."""
    from rucene_tpu_torch.ops import cuda_combine

    texts = random_corpus(np.random.default_rng(5), 12000)
    rare = [f"r{i}" for i in range(8)]
    texts = [t + (f" {rare[i % 8]}" if i % 997 == 0 else "") for i, t in enumerate(texts)]
    segs = _segments([texts])
    calls = []
    monkeypatch.setattr(cuda_combine, "combine_lanes_plain",
                        lambda *a, f=cuda_combine.combine_lanes_plain: calls.append(1) or f(*a))
    sparse = lambda P: [P.TermQuery(P.Term("body", w)) for w in rare[:2]]  # noqa: E731
    dense = lambda P: [  # noqa: E731
        P.BooleanQuery().should(P.TermQuery(P.Term("body", a))).must(P.TermQuery(P.Term("body", b)))
        for a, b in (("the", "fox"), ("dog", "lazy"), ("quick", "over"))
    ]
    counters, _ = _check(segs, sparse, (4, 1), decoded=decoded, monkeypatch=monkeypatch,
                         no_fallback=True)
    assert counters.get("search.strategy.candidate", 0) == 4 and not calls
    counters, _ = _check(segs, dense, (4, 1), decoded=decoded, monkeypatch=monkeypatch,
                         no_fallback=True)
    assert counters.get("search.strategy.dense", 0) == 4 and len(calls) >= 4

"""Range, exists and prefix filters on the port (search/filter_path.py, the
executors' FilterPlanes, the reader's doc-set accessors) against
rucene_tpu, on the CPU.

One corpus built by rucene_tpu gives every doc a body, an IntPoint ``ts``,
a FloatPoint ``price``, a 2-D IntPoint ``loc``, and on some docs a
StringField ``tag`` and a value in each doc-values family. It is carried
across with packed_from_reference (one leaf, two leaves, one leaf with
deletes) and served by both packages:
- the reader's accessors (exists_mask, point_range_docs in 1-D and 2-D,
  prefix_terms / prefix_docs, the doc-values accessors,
  read_postings(with_positions=True)) equal the reference's array for
  array;
- _apply_planes_dense / _apply_planes_lanes equal the reference's on the
  same seeded inputs, exactly;
- filter rows through search_batch, decoded and packed, on both executor
  branches (candidate-complete rows alone under every strategy, and a
  batch with range-only rows, which must take the dense branch even when
  RUCENE_STRATEGY asks for candidates), and mixed rows with ranges, match
  the reference's search_batch under the strict tests/torch_hitcheck.py
  on complete hit lists;
- the three faults repaired with the filter path, one test each:
  conjunction pruning of a ``+term +range`` row, a SHOULD term beside a
  SHOULD range taken as a single-term row, and a filter plane cached for
  one device served to another.
"""

import numpy as np
import pytest
import torch

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.search import executor as ref_executor
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.doc.field import float_to_sortable_int
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.search import executor
from rucene_tpu_torch.search.cache import DEVICE_PLANE_CACHE
from rucene_tpu_torch.search.query import Occur, RangeClause
from rucene_tpu_torch.util.metrics import METRICS
from tests.conftest import WORDS, random_corpus
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 1000
N_DOCS = 480
DV_FIELDS = ("dv_num", "dv_bin", "dv_sorted", "dv_snum", "dv_sset")


def _docs(n=N_DOCS, seed=31):
    """(text, ts, price, loc, tag or None, dv or None) per doc."""
    rng = np.random.default_rng(seed)
    texts = random_corpus(rng, n, min_len=3, max_len=24)
    out = []
    for i, t in enumerate(texts):
        tag = f"c{int(rng.integers(0, 40)):02d}" if i % 3 else None
        dv = int(rng.integers(0, 50)) if i % 4 == 1 else None
        out.append((t, int(rng.integers(0, 1000)), float(rng.normal(50.0, 20.0)),
                    (int(rng.integers(0, 100)), int(rng.integers(0, 100))), tag, dv))
    return out


def _pack(rows):
    buf = SegmentBuffer()
    for text, ts, price, loc, tag, dv in rows:
        d = R.Document()
        d.add(R.TextField("body", text))
        d.add(R.IntPoint("ts", ts))
        d.add(R.FloatPoint("price", price))
        d.add(R.IntPoint("loc", *loc))
        if tag is not None:
            d.add(R.StringField("tag", tag))
        if dv is not None:
            d.add(R.NumericDocValuesField("dv_num", dv))
            d.add(R.BinaryDocValuesField("dv_bin", f"b{dv}".encode()))
            d.add(R.SortedDocValuesField("dv_sorted", f"s{dv}"))
            d.add(R.SortedNumericDocValuesField("dv_snum", dv))
            d.add(R.SortedNumericDocValuesField("dv_snum", dv + 7))
            d.add(R.SortedSetDocValuesField("dv_sset", f"x{dv % 5}"))
        buf.add_document(d)
    return pack_segment(buf.finish())


def _layout(kind):
    rows = _docs()
    if kind.startswith("two"):
        leaves = [(_pack(rows[:260]), None), (_pack(rows[260:]), None)]
    else:
        leaves = [(_pack(rows), None)]
    if kind.endswith("deletes"):
        leaves = [(p, np.arange(p.max_doc) % 5 != i) for i, (p, _lv) in enumerate(leaves)]
    return leaves


def _ref_searcher(leaves):
    return R.IndexSearcher(
        RefReader([RefSnapshot(f"s{i}", p, live=lv) for i, (p, lv) in enumerate(leaves)])
    )


def _port_searcher(leaves, device="cpu"):
    return T.IndexSearcher(
        IndexReader([
            SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
            for i, (p, lv) in enumerate(leaves)
        ]),
        device=device,
    )


def _t(pkg, word, boost=1.0):
    return pkg.TermQuery(pkg.Term("body", word), boost=boost)


def _bool(pkg, *clauses):
    q = pkg.BooleanQuery()
    for occ, sub in clauses:
        getattr(q, occ)(sub)
    return q


def _complete_rows(pkg):
    """Rows whose every possible match holds a required term's lane."""
    ts = pkg.PointRangeQuery("ts", 100, 600)
    return [
        _bool(pkg, ("must", _t(pkg, "fox")), ("must", ts)),
        _bool(pkg, ("must", _t(pkg, "dog")), ("should", _t(pkg, "the")),
              ("should", pkg.PointRangeQuery("ts", 0, 300, boost=2.0))),
        _bool(pkg, ("must", _t(pkg, "quick")), ("must_not", pkg.PointRangeQuery("ts", 500, None))),
        _bool(pkg, ("must", _t(pkg, "lazy")), ("should", _t(pkg, "over")),
              ("filter", pkg.PrefixQuery("tag", "c1"))),
        _bool(pkg, ("filter", _t(pkg, "search")), ("must", pkg.ExistsQuery("dv_num"))),
        _bool(pkg, ("must", _t(pkg, "index")), ("filter", pkg.PointRangeQuery("price", 30.0, 60.5))),
        _bool(pkg, ("must", _t(pkg, "query")), ("filter", pkg.PointRangeQuery("loc", (10, 20), (70, None)))),
        _bool(pkg, ("must", _t(pkg, "score")), ("should", _t(pkg, "block")), ("should", _t(pkg, "term")),
              ("must", pkg.ExistsQuery("tag", boost=0.5)), ("must_not", pkg.PrefixQuery("tag", "c0"))),
        pkg.ConstantScoreQuery(_bool(pkg, ("must", _t(pkg, "the")), ("filter", ts)), 3.0),
        _bool(pkg, ("must", _t(pkg, "fox")), ("must", _t(pkg, "the"))),
    ]


def _open_rows(pkg):
    """Rows a doc may match through its ranges alone."""
    return [
        pkg.PointRangeQuery("ts", 250, 400),
        _bool(pkg, ("should", _t(pkg, "fox")), ("should", pkg.PointRangeQuery("ts", 0, 120))),
        _bool(pkg, ("must", pkg.ExistsQuery("tag")), ("should", _t(pkg, "dog"))),
        pkg.PrefixQuery("tag", "c2", boost=1.5),
        _bool(pkg, ("should", _t(pkg, "lazy")), ("must_not", pkg.PointRangeQuery("ts", 0, 700))),
        pkg.PointRangeQuery("price", None, 40.0),
        pkg.PointRangeQuery("loc", (None, 50), (30, None)),
        _bool(pkg, ("should", pkg.PrefixQuery("tag", "c3")), ("should", pkg.ExistsQuery("dv_sset")),
              ("should", pkg.PointRangeQuery("ts", 900, None)), ("must_not", pkg.ExistsQuery("dv_bin"))),
        pkg.FilterQuery(pkg.ExistsQuery("dv_snum")),
        pkg.MatchAllDocsQuery(),
        _t(pkg, "fox"),
    ] + [pkg.ExistsQuery(f) for f in DV_FIELDS + ("body", "ts", "price", "loc", "nope")]


def _mixed_rows(pkg):
    """Term clauses and ranges around one exact phrase."""
    def row(words, *clauses):
        return _bool(pkg, ("must", pkg.PhraseQuery("body", list(words))), *clauses)

    return [
        row(["the", "fox"], ("should", _t(pkg, "dog")), ("filter", pkg.PointRangeQuery("ts", 100, 700))),
        row(["quick", "brown"], ("must", _t(pkg, "the")), ("must_not", pkg.PrefixQuery("tag", "c1"))),
        row(["over", "the"], ("should", _t(pkg, "lazy")),
            ("should", pkg.PointRangeQuery("price", 40.0, None, boost=0.5))),
        _bool(pkg, ("filter", pkg.PhraseQuery("body", ["the", "the"])), ("must_not", _t(pkg, "fox")),
              ("must", pkg.ExistsQuery("tag"))),
    ]


@pytest.fixture(scope="module", params=["one", "two", "one_deletes", "two_deletes"])
def index(request):
    leaves = _layout(request.param)
    ref = _ref_searcher(leaves)
    want = {
        name: ref.search_batch(rows(R), k=K_ALL, prune=False)
        for name, rows in (("complete", _complete_rows), ("open", _open_rows), ("mixed", _mixed_rows))
    }
    assert all(max(td.total_hits for td in w) < K_ALL for w in want.values())
    assert all(sum(td.total_hits > 0 for td in w) >= len(w) // 2 for w in want.values())
    return leaves, want


# --- the reader's accessors ----------------------------------------------------


@pytest.fixture(scope="module")
def snapshots():
    (packed, _lv), = _layout("one")
    return RefSnapshot("s0", packed), SegmentSnapshot("s0", packed_from_reference(packed))


@pytest.mark.parametrize("field", DV_FIELDS + ("body", "tag", "ts", "price", "loc", "nope"))
def test_exists_mask_matches_reference(snapshots, field):
    ref, port = snapshots
    assert np.array_equal(port.exists_mask(field), ref.exists_mask(field))


def test_point_range_docs_match_reference(snapshots):
    ref, port = snapshots
    enc = float_to_sortable_int
    cases = [
        ("ts", 100, 600), ("ts", None, 50), ("ts", 990, None), ("ts", 700, 600), ("ts", None, None),
        ("price", enc(30.0), enc(60.5)), ("price", None, enc(-1.0)),
        ("loc", (10, 20), (70, None)), ("loc", (None, None), (5, 5)), ("nope", 0, 9),
    ]
    for field, lo, hi in cases:
        got, want = port.point_range_docs(field, lo, hi), ref.point_range_docs(field, lo, hi)
        assert np.array_equal(got, want), (field, lo, hi)
        assert got.dtype == np.int64


def test_prefix_terms_and_docs_match_reference(snapshots):
    ref, port = snapshots
    for field, prefix in (("tag", "c"), ("tag", "c1"), ("tag", "c07"), ("tag", "z"), ("body", "qu"),
                          ("nope", "a")):
        assert port.prefix_terms(field, prefix) == ref.prefix_terms(field, prefix)
        assert np.array_equal(port.prefix_docs(field, prefix), ref.prefix_docs(field, prefix))


def test_doc_values_accessors_match_reference(snapshots):
    ref, port = snapshots
    assert np.array_equal(port.numeric_doc_values("dv_num")[0], ref.numeric_doc_values("dv_num")[0])
    assert np.array_equal(port.numeric_doc_values("dv_num")[1], ref.numeric_doc_values("dv_num")[1])
    assert port.binary_doc_values("dv_bin") == ref.binary_doc_values("dv_bin")
    for name in ("sorted_doc_values", "sorted_numeric_doc_values", "sorted_set_doc_values"):
        field = {"sorted_doc_values": "dv_sorted", "sorted_numeric_doc_values": "dv_snum",
                 "sorted_set_doc_values": "dv_sset"}[name]
        got, want = getattr(port, name)(field), getattr(ref, name)(field)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a == b) if isinstance(a, list) else np.array_equal(a, b)
    for name in ("numeric_doc_values", "binary_doc_values", "sorted_doc_values",
                 "sorted_numeric_doc_values", "sorted_set_doc_values"):
        assert getattr(port, name)("nope") is None and getattr(ref, name)("nope") is None


def test_read_postings_with_positions_matches_reference(snapshots):
    ref, port = snapshots
    for text in WORDS + ["absent"]:
        want = ref.read_postings("body", text, with_positions=True)
        got = port.read_postings("body", text, with_positions=True)
        if want is None:
            assert got is None
            continue
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        docs, freqs, positions = port.read_postings("body", text)
        assert positions is None and np.array_equal(docs, want[0]) and np.array_equal(freqs, want[1])
    assert port.read_postings("tag", "c01", with_positions=True)[2].shape[0] > 0


# --- the folds ------------------------------------------------------------------


def _fold_inputs(seed=3, b=40, md=96, p=5, r=3):
    rng = np.random.default_rng(seed)
    planes = rng.random((p, md)) < 0.4
    idx = rng.integers(-1, p, (b, r)).astype(np.int32)
    enc = rng.choice([executor.ENC_REQUIRED, executor.ENC_SHOULD, executor.ENC_NOT], (b, r)).astype(np.int32)
    boost = rng.choice([0.0, 1.0, 0.5, 2.5], (b, r)).astype(np.float32)
    acc = rng.random((b, md)).astype(np.float32) * 3
    cnt = rng.integers(0, 1 << 17, (b, md)).astype(np.int32)
    return planes, idx, enc, boost, acc, cnt


def _planes(mod, arrays, to):
    planes, idx, enc, boost = arrays
    return mod.FilterPlanes(planes=to(planes), idx=to(idx), enc=to(enc), boost=to(boost))


def test_apply_planes_dense_matches_reference():
    import jax.numpy as jnp

    planes, idx, enc, boost, acc, cnt = _fold_inputs()
    want_s, want_c = ref_executor._apply_planes_dense(
        jnp.asarray(acc), jnp.asarray(cnt), _planes(ref_executor, (planes, idx, enc, boost), jnp.asarray)
    )
    got_s, got_c = executor._apply_planes_dense(
        torch.from_numpy(acc.copy()), torch.from_numpy(cnt.copy()),
        _planes(executor, (planes, idx, enc, boost), torch.from_numpy),
    )
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))


def test_apply_planes_lanes_matches_reference():
    import jax.numpy as jnp

    planes, idx, enc, boost, _acc, _cnt = _fold_inputs(seed=4)
    b, md = idx.shape[0], planes.shape[1]
    rng = np.random.default_rng(5)
    n = 700
    rows = rng.integers(0, b + 2, n).astype(np.int32)  # rows past b: padding groups
    docs = rng.integers(0, md, n).astype(np.int32)
    sums = rng.random(n).astype(np.float32)
    encs = rng.integers(0, 1 << 17, n).astype(np.int32)
    want_s, want_c = ref_executor._apply_planes_lanes(
        jnp.asarray(sums), jnp.asarray(encs), jnp.asarray(rows), jnp.asarray(docs), b,
        _planes(ref_executor, (planes, idx, enc, boost), jnp.asarray),
    )
    got_s, got_c = executor._apply_planes_lanes(
        torch.from_numpy(sums), torch.from_numpy(encs), torch.from_numpy(rows).long(),
        torch.from_numpy(docs).long(), b, _planes(executor, (planes, idx, enc, boost), torch.from_numpy),
    )
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))


# --- filter rows through search_batch ------------------------------------------------


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("strategy", ["auto", "dense", "candidate"])
def test_filter_rows_match_reference(index, strategy, decoded, monkeypatch):
    """Candidate-complete rows alone take the strategy asked for; with the
    range-only rows beside them the batch takes the dense branch whatever
    RUCENE_STRATEGY says. Both match the reference, and a truncated list is
    the complete one's head."""
    leaves, want = index
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    monkeypatch.setenv("RUCENE_STRATEGY", strategy)
    searcher = _port_searcher(leaves)
    METRICS.reset()
    got = searcher.search_batch(_complete_rows(T), k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert_batches_strict(got, want["complete"])
    if strategy != "auto":
        assert counters.get(f"search.strategy.{strategy}", 0) > 0
    assert counters["route.device"] == len(_complete_rows(T))
    rows = _complete_rows(T) + _open_rows(T)
    METRICS.reset()
    got = searcher.search_batch(rows, k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert_batches_strict(got, want["complete"] + want["open"])
    assert counters.get("search.strategy.candidate", 0) == 0
    assert counters.get("search.strategy.dense", 0) > 0
    assert counters["route.device"] == len(rows) and counters.get("route.host", 0) == 0
    for h, full in zip(searcher.search_batch(rows, k=6), got):
        assert h.total_hits == full.total_hits
        assert h.score_docs == full.score_docs[:6]


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_mixed_rows_with_ranges_match_reference(index, decoded, monkeypatch):
    leaves, want = index
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    METRICS.reset()
    got = _port_searcher(leaves).search_batch(_mixed_rows(T), k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert counters.get("route.mixed", 0) == len(_mixed_rows(T))
    assert counters.get("search.mixed_host_spill", 0) == 0
    assert_batches_strict(got, want["mixed"])


def test_packed_equals_decoded_bit_for_bit(index, monkeypatch):
    """Rows with at most two scoring term clauses and any ranges give the
    same f32 scores on every route (the planes add after the term sums)."""
    leaves, _want = index
    rows = _complete_rows(T)[:7] + _open_rows(T) + _mixed_rows(T)
    runs = {}
    for decoded in ("0", "1"):
        monkeypatch.setenv("RUCENE_DECODED", decoded)
        runs[decoded] = _port_searcher(leaves).search_batch(rows, k=K_ALL)
    assert runs["0"] == runs["1"]


def test_filter_planes_cached_across_batches(index):
    """A repeated batch builds no filter plane and no stack: the device
    plane cache misses do not grow."""
    leaves, want = index
    searcher = _port_searcher(leaves)
    rows = _complete_rows(T) + _open_rows(T)
    searcher.search_batch(rows, k=K_ALL)
    misses = DEVICE_PLANE_CACHE.misses
    got = searcher.search_batch(rows, k=K_ALL)
    assert DEVICE_PLANE_CACHE.misses == misses
    assert_batches_strict(got, want["complete"] + want["open"])


# --- the repaired faults ---------------------------------------------------------


def test_conjunction_pruning_keeps_term_plus_range_rows(index, monkeypatch):
    """``+term +range``: a required range counts in n_required but has no
    lanes, so conjunction pruning must count the row's required term
    clauses only, or it drops every item of the row and nothing matches."""
    leaves, _want = index
    rows = [_complete_rows(pkg)[0] for pkg in (R, T)]
    want = _ref_searcher(leaves).search_batch([rows[0]], k=K_ALL, prune=False)
    assert want[0].total_hits > 0
    for decoded in ("0", "1"):
        monkeypatch.setenv("RUCENE_DECODED", decoded)
        assert_batches_strict(_port_searcher(leaves).search_batch([rows[1]], k=K_ALL), want)


def test_should_term_beside_should_range_is_not_single(index, monkeypatch):
    """``term OR range`` holds one SHOULD term clause: it is not a pure
    single-term row (the single route would drop the range's docs and
    scores)."""
    from rucene_tpu_torch.search import searcher as searcher_mod

    leaves, _want = index
    monkeypatch.setattr(searcher_mod, "SPLIT_MIN_DOCS", 0)
    rows = [_open_rows(pkg)[1] for pkg in (R, T)]
    want = _ref_searcher(leaves).search_batch([rows[0], R.TermQuery(R.Term("body", "fox"))], k=K_ALL,
                                              prune=False)
    searcher = _port_searcher(leaves)
    rq = rows[1].rewrite()
    assert not searcher._pure_row(rq, np.ones(1, np.float32))
    METRICS.reset()
    got = searcher.search_batch([rows[1], T.TermQuery(T.Term("body", "fox"))], k=K_ALL)
    assert_batches_strict(got, want)
    deletes = any(lv is not None for _p, lv in leaves)
    assert METRICS.snapshot()["counters"].get("route.single", 0) == (0 if deletes else 1)


def test_filter_plane_is_keyed_by_device(index):
    """Two snapshots of one segment under one name, served on two devices:
    the plane and the stack cached for the first are not served to the
    second (a second device is faked with the meta device)."""
    leaves, _want = index
    packed = packed_from_reference(leaves[0][0])
    cpu_leaf = IndexReader([SegmentSnapshot("s0", packed)]).to("cpu").leaves[0]
    other = SegmentSnapshot("s0", packed)
    other.torch_device = torch.device("meta")
    other._device = cpu_leaf.device  # its doc axis; the planes it gets are its own
    searcher = _port_searcher(leaves)
    rcl = RangeClause(Occur.FILTER, "ts", 100, 600)
    plane = searcher._leaf_plane(cpu_leaf, rcl)
    assert plane.device.type == "cpu" and searcher._leaf_plane(cpu_leaf, rcl) is plane
    misses = DEVICE_PLANE_CACHE.misses
    moved = searcher._leaf_plane(other, rcl)
    assert moved.device.type == "meta" and DEVICE_PLANE_CACHE.misses == misses + 1
    tables = searcher._range_filter_tables([T.PointRangeQuery("ts", 100, 600).rewrite()], 1)
    assert searcher._leaf_filters(cpu_leaf, *tables).planes.device.type == "cpu"
    assert searcher._leaf_filters(other, *tables).planes.device.type == "meta"
    assert torch.equal(
        searcher._leaf_filters(cpu_leaf, *tables).planes[0], torch.from_numpy(
            np.isin(np.arange(cpu_leaf.device.max_doc_padded), cpu_leaf.point_range_docs("ts", 100, 600))
        )
    )

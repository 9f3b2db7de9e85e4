"""NRT serving on the port against rucene_tpu, on the CPU: the port's
IndexWriter writes and deletes, its readers serve every route, and the
reference's reader over the same committed files gives the answers.

- Deletes that arrive after a route's caches were filled (the single and
  flat routes, the pair and tf-plane routes, the phrase candidate tables,
  position planes and scalar engine, mixed rows, filter planes and the
  host route), on decoded and packed leaves: the refreshed reader answers
  as the reference does, builds no device form, and the reader acquired
  before the deletes still answers as before.
- A reader acquired before a merging refresh keeps its doc bases and its
  answers bit for bit (the reference's readers lose theirs: ROADMAP.md §3).
- with_deletes and delete-by-query keep the segment's device tensors.
- A CPU reader and a reader on another device (the meta device stands in
  for a card) over one snapshot do not reset each other's forms.
- The doc-values overlays against the reference's accessors.
- A SearcherManager with an ingest thread: every acknowledged commit is
  visible after the next refresh, and every marker is found once.
"""

import threading
import time

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.index.reader import open_directory_reader as ref_open
from rucene_tpu.store.directory import FSDirectory as RefFS
from rucene_tpu_torch.index.reader import IndexReader
from rucene_tpu_torch.native import available as native_available
from rucene_tpu_torch.search.cache import DEVICE_PLANE_CACHE
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import assert_batches_strict
from tests.torch_route_data import zipf_texts

K_ALL = 1000
N_DOCS = 600


@pytest.fixture(scope="module")
def corpus():
    texts, words = zipf_texts(N_DOCS, 40, seed=12, lo=3, hi=12)
    return texts, words


def _write(path, texts, max_buffered=200):
    """The port's writer over an FSDirectory: three segments, each doc with
    an id, a body, an IntPoint ``ts`` and on one doc in three a ``tag``."""
    w = T.IndexWriter(
        T.FSDirectory(str(path)),
        T.IndexWriterConfig(max_buffered_docs=max_buffered, merge_on_commit=False),
    )
    for i, t in enumerate(texts):
        d = T.Document()
        d.add(T.StringField("id", str(i)))
        d.add(T.TextField("body", t))
        d.add(T.IntPoint("ts", (i * 37) % 1000))
        if i % 3 == 0:
            d.add(T.StringField("tag", f"c{i % 30:02d}"))
        w.add_document(d)
    w.commit()
    return w


def _delete(w, pkg=T):
    """Deletes by term on one doc in four, and by query on a mid body word."""
    for i in range(1, N_DOCS, 4):
        w.delete_documents_by_term(pkg.Term("id", str(i)))
    w.delete_documents_by_query(pkg.TermQuery(pkg.Term("body", "w17")))
    w.commit()


def _tq(P, t):
    return P.TermQuery(P.Term("body", t))


def _bq(P, *clauses):
    q = P.BooleanQuery()
    for occ, t in clauses:
        getattr(q, occ)(_tq(P, t) if isinstance(t, str) else t)
    return q


def _rows(P, route, words):
    ws = words
    if route == "single":
        return [_tq(P, w) for w in ws[:12]]
    if route == "flat":
        return [_bq(P, ("should", ws[i]), ("should", ws[i + 1]), ("must_not", ws[i + 5]))
                for i in range(8)]
    if route in ("pair", "planes"):
        return ([_bq(P, ("should", ws[i]), ("should", ws[i + 2])) for i in range(6)]
                + [_bq(P, ("must", ws[i]), ("must", ws[i + 3])) for i in range(6)])
    if route.startswith("phrase"):
        return [P.PhraseQuery("body", [ws[i], ws[j]]) for i, j in
                ((0, 1), (1, 0), (0, 2), (2, 3), (1, 1), (4, 0), (0, 39))]
    if route == "mixed":
        return [_bq(P, ("should", ws[i + 3]), ("must", P.PhraseQuery("body", [ws[i], ws[i + 1]])))
                for i in range(5)]
    if route == "filter":
        return ([_bq(P, ("must", ws[i]), ("filter", P.PointRangeQuery("ts", 100 * i, 100 * i + 400)))
                 for i in range(4)]
                + [_bq(P, ("should", ws[i]), ("filter", P.PrefixQuery("tag", "c1"))) for i in range(3)]
                + [_bq(P, ("must", ws[2]), ("filter", P.ExistsQuery("tag")))])
    if route == "host":
        inner = _bq(P, ("should", ws[3]), ("should", ws[4]))
        return [_bq(P, ("must", ws[i]), ("must", _bq(P, ("should", ws[3]), ("should", ws[4]))))
                for i in range(3)] + [_bq(P, ("should", ws[0]), ("filter", inner))]
    raise ValueError(route)


# route -> (environment, searcher attributes, counter of its rows after the
# deletes, counter before them where it differs)
ROUTES = {
    "single": ({"RUCENE_PLANES": "0"}, {}, "route.flat", "route.single"),
    "flat": ({"RUCENE_PLANES": "0", "RUCENE_PAIR": "0"}, {}, "route.flat", None),
    "pair": ({"RUCENE_PLANES": "0"}, {}, "route.pair_rows", None),
    "planes": ({"RUCENE_PLANES": "1"}, {}, "route.plane_rows", None),
    "phrase_candidates": ({}, {"PHRASE_SCALAR_MAX_DOCS": 0}, "search.phrase_device", None),
    "phrase_planes": ({}, {"PHRASE_SCALAR_MAX_DOCS": 0, "PHRASE_PLANE_MIN_DOCS": 1,
                           "PHRASE_PLANE_ITEM_MIN": 1}, "search.phrase_plane", None),
    "phrase_scalar": ({}, {}, "search.phrase_scalar_route", None),
    "mixed": ({}, {}, "route.mixed", None),
    "filter": ({"RUCENE_PLANES": "0"}, {}, "route.device", None),
    "host": ({}, {}, "route.host", None),
}
CASES = [(r, d) for r in ROUTES for d in ("0", "1") if not (r in ("pair", "planes") and d == "0")]

_REF_ANSWERS: dict = {}


def _ref_answers(route, state, path, words):
    """The reference's answers over the port's committed files (its own
    routing): the same for the decoded and the packed case."""
    key = (route, state)
    if key not in _REF_ANSWERS:
        s = R.IndexSearcher(ref_open(RefFS(str(path))))
        _REF_ANSWERS[key] = s.search_batch(_rows(R, route, words), k=K_ALL)
    return _REF_ANSWERS[key]


def _searcher(reader, attrs):
    s = T.IndexSearcher(reader, device="cpu")
    for name, v in attrs.items():
        setattr(s, name, v)
    return s


def _count(name):
    return METRICS.snapshot()["counters"].get(name, 0)


@pytest.mark.parametrize("route,decoded", CASES)
def test_deletes_after_route_caches_filled(corpus, tmp_path, monkeypatch, route, decoded):
    if route == "phrase_scalar" and not native_available:
        pytest.skip("the scalar engine needs the native library")
    texts, words = corpus
    env, attrs, counter, counter_before = ROUTES[route]
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    w = _write(tmp_path, texts)
    rows = _rows(T, route, words)

    METRICS.reset()
    s1 = _searcher(w.get_reader(), attrs)
    before = s1.search_batch(rows, k=K_ALL)
    assert _count(counter_before or counter) > 0, METRICS.snapshot()["counters"]
    assert_batches_strict(before, _ref_answers(route, "before", tmp_path, words))
    assert any(td.total_hits for td in before)
    # host routes build no device form; the rest one for each leaf
    host_only = route in ("phrase_scalar", "host")
    assert _count("reader.device_builds") == (0 if host_only else len(s1.reader.leaves))
    plane_builds = _count("search.phrase_plane_build")
    cache_hits = DEVICE_PLANE_CACHE.hits

    _delete(w)
    METRICS.reset()
    s2 = _searcher(w.get_reader(), attrs)
    assert sum(lf.del_count for lf in s2.reader.leaves) > 0
    after = s2.search_batch(rows, k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert counters.get(counter, 0) > 0, counters
    assert counters.get("reader.device_builds", 0) == 0  # a delete refresh builds no form
    if route == "phrase_planes":
        assert counters.get("search.phrase_plane_build", 0) == 0 < plane_builds
    if route == "filter":
        assert DEVICE_PLANE_CACHE.hits > cache_hits  # the planes cached before the deletes
    assert_batches_strict(after, _ref_answers(route, "after", tmp_path, words))
    assert [td.total_hits for td in after] != [td.total_hits for td in before]
    # the reader acquired before the deletes is a point in time
    assert s1.search_batch(rows, k=K_ALL) == before
    w.close()


def _seg_texts():
    """Three 10-doc segments; segment s holds the token ``s{s}`` in every
    doc, beside shared words."""
    rng = np.random.default_rng(4)
    words = ["alpha", "beta", "gamma", "delta"]
    return [f"s{i // 10} " + " ".join(rng.choice(words, 4)) for i in range(30)]


def test_reader_keeps_doc_bases_across_merging_refresh(tmp_path, monkeypatch):
    """A reader acquired before a merging refresh answers its rows bit for
    bit as before, held against the reference's answers taken before the
    merge (its answers after the merge are wrong: its readers share the
    writer's snapshots and their doc bases)."""
    monkeypatch.setenv("RUCENE_DECODED", "1")
    w = _write(tmp_path, _seg_texts(), max_buffered=10)
    rows = [_tq(T, "s2"), _tq(T, "s1"), _bq(T, ("should", "s0"), ("should", "alpha")),
            T.PhraseQuery("body", ["alpha", "beta"]),
            _bq(T, ("must", "s2"), ("filter", T.PointRangeQuery("ts", 0, 600)))]
    r1 = w.get_reader()
    s1 = T.IndexSearcher(r1, device="cpu")
    first = s1.search_batch(rows, k=K_ALL)
    want = R.IndexSearcher(ref_open(RefFS(str(tmp_path)))).search_batch(
        [_tq(R, "s2"), _tq(R, "s1"), _bq(R, ("should", "s0"), ("should", "alpha")),
         R.PhraseQuery("body", ["alpha", "beta"]),
         _bq(R, ("must", "s2"), ("filter", R.PointRangeQuery("ts", 0, 600)))], k=K_ALL)
    assert_batches_strict(first, want)
    assert [sd.doc for sd in first[0].score_docs] == list(range(20, 30))
    layout = [(lf.name, lf.doc_base) for lf in r1.leaves]
    assert layout == [("_0", 0), ("_1", 10), ("_2", 20)]

    w.delete_documents_by_term(T.Term("body", "s0"))
    w.force_merge(2)
    r2 = w.get_reader()
    assert [lf.doc_base for lf in r2.leaves] == [0, 10] and r2.leaves[1].name == "_2"
    assert [(lf.name, lf.doc_base) for lf in r1.leaves] == layout
    assert s1.search_batch(rows, k=K_ALL) == first
    assert r1.document(20) == r1.leaves[2].document(0)
    got = T.IndexSearcher(r2, device="cpu").search(_tq(T, "s2"), K_ALL)
    assert [sd.doc for sd in got.score_docs] == list(range(10, 20))
    w.close()


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_deletes_keep_device_tensors(corpus, tmp_path, monkeypatch, decoded):
    """with_deletes and delete-by-query share every device tensor but the
    live mask; a delete refresh counts no device build."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    texts, words = corpus
    w = _write(tmp_path, texts)
    s1 = T.IndexSearcher(w.get_reader(), device="cpu")
    s1.search(_tq(T, words[0]), 10)
    old = [lf.device for lf in s1.reader.leaves]
    METRICS.reset()
    w.delete_documents_by_query(_bq(T, ("must", words[1]), ("must", words[2])))
    s2 = T.IndexSearcher(w.get_reader(), device="cpu")
    s2.search(_tq(T, words[0]), 10)
    for lf, dev in zip(s2.reader.leaves, old):
        assert lf.device.data is dev.data and lf.device.norms is dev.norms
        assert lf.device.docs_dec is dev.docs_dec  # None when packed
        assert (lf.device.live is dev.live) == (lf.live is None)
    assert any(lf.live is not None for lf in s2.reader.leaves)
    assert _count("reader.device_builds") == 0
    snap = s2.reader.leaves[0]
    live = np.ones(snap.max_doc, bool)
    live[::2] = False
    moved = snap.with_deletes(live)
    assert moved.torch_device == snap.torch_device
    assert moved.device.data is snap.device.data
    assert moved.device.live[: snap.max_doc].cpu().numpy().tolist() == live.tolist()
    assert not moved.device.live[snap.max_doc:].any()
    dv = moved.with_dv_updates("rank", {0: 5})
    assert dv.device is moved.device and dv.plane_slots is moved.plane_slots
    assert _count("reader.device_builds") == 0
    w.close()


def test_readers_on_two_devices_keep_their_forms(corpus, tmp_path, monkeypatch):
    """Two readers over one pooled snapshot, one on the CPU and one on
    another device (the meta device stands in for a card): serving one
    never drops or rebuilds the other's form. The reference moved the
    shared snapshot instead, so each switch rebuilt the segment."""
    monkeypatch.setenv("RUCENE_DECODED", "0")
    texts, _words = corpus
    w = _write(tmp_path, texts[:200])
    snap = w._pool["_0"]
    cpu_reader = IndexReader([snap]).to("cpu")
    other = IndexReader([snap]).to("meta")
    METRICS.reset()
    a = cpu_reader.leaves[0].device
    b = other.leaves[0].device
    assert a.data.device.type == "cpu" and b.data.device.type == "meta"
    for _ in range(3):
        other.to("meta")
        cpu_reader.to("cpu")
        assert cpu_reader.leaves[0].device is a and other.leaves[0].device is b
    assert snap.torch_device.type == "cpu" and snap._device is None
    assert _count("reader.device_builds") == 2
    # a third reader on the CPU finds the form the first one built
    assert IndexReader([snap]).to("cpu").leaves[0].device.data is a.data
    assert _count("reader.device_builds") == 2
    w.close()


def test_dv_overlays_match_reference(tmp_path):
    """The numeric and binary overlays through the five accessors and
    exists_mask, port against reference, on the NRT reader and after
    commit and reopen."""
    def build(P, writer, path):
        w = writer(path)
        for i in range(50):
            d = P.Document()
            d.add(P.StringField("id", str(i)))
            d.add(P.TextField("body", f"doc{i} common"))
            if i % 3:
                d.add(P.NumericDocValuesField("rank", i))
            if i % 4:
                d.add(P.BinaryDocValuesField("blob", f"v{i}".encode()))
            d.add(P.SortedDocValuesField("cat", f"k{i % 3}"))
            w.add_document(d)
        w.update_numeric_doc_value(P.Term("id", "3"), "rank", 300)  # had no value
        w.update_numeric_doc_value(P.Term("body", "common"), "fresh", 7)  # a new column
        w.update_binary_doc_value(P.Term("id", "8"), "blob", b"new8")  # had no value
        w.update_binary_doc_value(P.Term("id", "9"), "blob", b"new9")
        return w

    from rucene_tpu.index.writer import IndexWriter as RefWriter

    pw = build(T, T.IndexWriter, T.FSDirectory(str(tmp_path / "p")))
    rw = build(R, RefWriter, RefFS(str(tmp_path / "r")))

    def views(reader):
        out = []
        for lf in reader.leaves:
            row = []
            for f in ("rank", "fresh"):
                v = lf.numeric_doc_values(f)
                row.append(None if v is None else (v[0].tolist(), v[1].tolist()))
            row += [lf.binary_doc_values("blob"), lf.binary_doc_values("none"),
                    lf.sorted_doc_values("cat")[1].tolist(),
                    lf.sorted_numeric_doc_values("cat"), lf.sorted_set_doc_values("cat")]
            row += [lf.exists_mask(f).tolist() for f in ("rank", "fresh", "blob")]
            out.append(row)
        return out

    assert views(pw.get_reader()) == views(rw.get_reader())
    pw.commit()
    rw.commit()
    assert views(T.open_directory_reader(T.FSDirectory(str(tmp_path / "p")))) == views(
        ref_open(RefFS(str(tmp_path / "r")))
    )
    pw.close()
    rw.close()


def test_searcher_manager_with_ingest_thread(corpus, tmp_path):
    """An ingest thread adds chunks and commits, each commit with a marker
    doc; the foreground refreshes and serves. After each refresh the
    reader holds every doc acknowledged before it; at the end each marker
    is found exactly once, and the answers equal the reference's over the
    committed files."""
    texts, words = corpus
    w = T.IndexWriter(
        T.FSDirectory(str(tmp_path)),
        T.IndexWriterConfig(max_buffered_docs=120, merge_on_commit=False),
    )
    mgr = T.SearcherManager(w, searcher_factory=lambda r: T.IndexSearcher(r, device="cpu"))
    acked = [0]  # docs acknowledged by the last commit
    n_markers = [0]
    stop = threading.Event()
    errors = []

    def ingest():
        try:
            i = 0
            while not stop.is_set() and i < len(texts):
                docs = []
                for t in texts[i : i + 20]:
                    d = T.Document()
                    d.add(T.TextField("body", t))
                    docs.append(d)
                w.add_documents(docs)
                i += len(docs)
                if i % 40 == 0:
                    m = T.Document()
                    m.add(T.StringField("marker", f"m{n_markers[0]}"))
                    w.add_document(m)
                    w.commit()
                    n_markers[0] += 1
                    acked[0] = i + n_markers[0]
                time.sleep(0.02)
        except BaseException as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=ingest)
    th.start()
    rows = [_tq(T, words[i]) for i in range(6)] + [T.PhraseQuery("body", [words[0], words[1]])]
    refreshes = 0
    t0 = time.monotonic()
    while th.is_alive() and time.monotonic() - t0 < 20:
        seen = acked[0]
        mgr.maybe_refresh()
        refreshes += 1
        s = mgr.acquire()
        assert s.reader.num_docs >= seen
        s.search_batch(rows, k=10)
        mgr.release(s)
    stop.set()
    th.join()
    assert not errors, errors
    w.commit()
    mgr.maybe_refresh()
    s = mgr.acquire()
    assert refreshes > 1 and n_markers[0] > 1 and len(s.reader.leaves) > 1
    assert s.reader.num_docs == acked[0] == len(texts) + n_markers[0]
    marks = s.search_batch(
        [T.TermQuery(T.Term("marker", f"m{j}")) for j in range(n_markers[0])], k=5
    )
    assert [td.total_hits for td in marks] == [1] * n_markers[0]
    want = R.IndexSearcher(ref_open(RefFS(str(tmp_path)))).search_batch(
        [_tq(R, words[i]) for i in range(6)] + [R.PhraseQuery("body", [words[0], words[1]])],
        k=K_ALL,
    )
    assert_batches_strict(s.search_batch(rows, k=K_ALL), want)
    assert not mgr.maybe_refresh()
    w.close()


def test_scalar_engine_follows_refreshed_stats(corpus, tmp_path):
    """The scalar phrase engine of a segment is cached across readers; a
    refresh that adds docs changes the collection statistics, and the
    next reader's phrase scores must use them (the reference's cached
    engine keeps its first BM25 norm table: ROADMAP.md §3)."""
    if not native_available:
        pytest.skip("the scalar engine needs the native library")
    texts, words = corpus
    w = _write(tmp_path, texts[:300], max_buffered=150)
    rows = [T.PhraseQuery("body", [words[0], words[1]]), T.PhraseQuery("body", [words[1], words[0]])]
    METRICS.reset()
    T.IndexSearcher(w.get_reader(), device="cpu").search_batch(rows, k=K_ALL)
    for t in texts[300:]:  # longer docs: the average length moves
        d = T.Document()
        d.add(T.TextField("body", f"{t} {t} {t}"))
        w.add_document(d)
    w.commit()
    got = T.IndexSearcher(w.get_reader(), device="cpu").search_batch(rows, k=K_ALL)
    assert _count("search.phrase_scalar_route") > 0 and _count("route.phrase") == 2 * len(rows)
    want = R.IndexSearcher(ref_open(RefFS(str(tmp_path)))).search_batch(
        [R.PhraseQuery("body", [words[0], words[1]]), R.PhraseQuery("body", [words[1], words[0]])],
        k=K_ALL,
    )
    assert_batches_strict(got, want)
    w.close()


def test_exists_filter_follows_dv_updates(tmp_path):
    """An ExistsQuery over a doc-values field, cached as a host doc set and
    a device plane, then a numeric and a binary update that give docs the
    field: the next reader's rows count them, as a reference reader
    opened fresh on the commit does (the reference's own NRT reader keeps
    the cached set: ROADMAP.md §3); a delete keeps the cached plane."""
    w = T.IndexWriter(T.FSDirectory(str(tmp_path)), T.IndexWriterConfig(merge_on_commit=False))
    for i in range(40):
        d = T.Document()
        d.add(T.StringField("id", str(i)))
        d.add(T.TextField("body", "common" if i % 5 else "common rare"))
        if i % 2:
            d.add(T.NumericDocValuesField("rank", i))
        if i % 3 == 0:
            d.add(T.BinaryDocValuesField("blob", b"x"))
        w.add_document(d)

    def rows(P):
        return [_bq(P, ("must", "common"), ("filter", P.ExistsQuery("rank"))),
                _bq(P, ("should", "rare"), ("filter", P.ExistsQuery("blob"))),
                _bq(P, ("must", "common"), ("must_not", P.ExistsQuery("rank")))]

    for _ in range(3):  # cached from the second use on
        first = T.IndexSearcher(w.get_reader(), device="cpu").search_batch(rows(T), k=K_ALL)
    w.update_numeric_doc_value(T.Term("id", "0"), "rank", 7)
    w.update_binary_doc_value(T.Term("id", "5"), "blob", b"y")
    w.commit()
    got = T.IndexSearcher(w.get_reader(), device="cpu").search_batch(rows(T), k=K_ALL)
    want = R.IndexSearcher(ref_open(RefFS(str(tmp_path)))).search_batch(rows(R), k=K_ALL)
    assert_batches_strict(got, want)
    assert [td.total_hits for td in got] == [first[0].total_hits + 1, first[1].total_hits + 1,
                                             first[2].total_hits - 1]
    hits = DEVICE_PLANE_CACHE.hits
    w.delete_documents_by_term(T.Term("id", "1"))
    w.commit()
    T.IndexSearcher(w.get_reader(), device="cpu").search_batch(rows(T), k=K_ALL)
    assert DEVICE_PLANE_CACHE.hits > hits
    w.close()


def test_planes_of_merged_segments_are_released(corpus, tmp_path, monkeypatch):
    """Position planes built for segments that a merge then takes away go
    once no reader holds those segments (the next plane fetch drops
    them): the cache holds a weak reference to each segment, where the
    reference's entries pin theirs until the LRU evicts them."""
    import gc

    from rucene_tpu_torch.search import phrase_path

    monkeypatch.setenv("RUCENE_DECODED", "1")
    texts, words = corpus
    w = _write(tmp_path, texts)
    attrs = ROUTES["phrase_planes"][1]
    rows = _rows(T, "phrase_planes", words)
    s1 = _searcher(w.get_reader(), attrs)
    before = s1.search_batch(rows, k=K_ALL)
    old = {id(lf.packed) for lf in s1.reader.leaves}
    held = [key for (seg,), key, _v in phrase_path._PLANE_CACHE.items() if id(seg) in old]
    assert held
    w.force_merge(1)
    s2 = _searcher(w.get_reader(), attrs)
    del s1
    gc.collect()
    after = s2.search_batch(rows, k=K_ALL)  # builds the merged segment's planes
    # no entry of a freed segment is left, so none of the merged-away ones
    assert all(seg is not None for (seg,), _k, _v in phrase_path._PLANE_CACHE.items())
    merged = id(s2.reader.leaves[0].packed)
    assert any(id(seg) == merged for (seg,), _k, _v in phrase_path._PLANE_CACHE.items())
    assert [td.total_hits for td in after] == [td.total_hits for td in before]
    w.close()


def test_scalar_engines_of_merged_segments_are_released(corpus, tmp_path):
    """Scalar phrase engines built for small segments that a merge then
    takes away keep none of them alive once no reader holds them, and
    leave the cache at the next engine build: an engine holds its leaf by
    proxy and the cache holds each segment and live mask by weak
    reference."""
    import gc
    import weakref

    from rucene_tpu_torch.search import phrase_path

    if not native_available:
        pytest.skip("the scalar engine needs the native library")
    texts, words = corpus
    w = _write(tmp_path, texts)
    rows = _rows(T, "phrase_scalar", words)
    METRICS.reset()
    s1 = T.IndexSearcher(w.get_reader(), device="cpu")
    before = s1.search_batch(rows, k=K_ALL)
    assert _count("search.phrase_scalar_route") > 0
    old = [weakref.ref(lf.packed) for lf in s1.reader.leaves]
    assert len(old) > 1
    held = {id(seg) for (seg, _live), _k, _v in phrase_path._SCALAR_ENGINE_CACHE.items()}
    assert all(id(o()) in held for o in old)
    w.force_merge(1)
    s2 = T.IndexSearcher(w.get_reader(), device="cpu")
    del s1
    gc.collect()
    assert all(o() is None for o in old)
    after = s2.search_batch(rows, k=K_ALL)  # builds the merged segment's engine
    assert all(seg is not None for (seg, _live), _k, _v in phrase_path._SCALAR_ENGINE_CACHE.items())
    merged = id(s2.reader.leaves[0].packed)
    assert any(id(seg) == merged for (seg, _live), _k, _v in phrase_path._SCALAR_ENGINE_CACHE.items())
    assert [td.total_hits for td in after] == [td.total_hits for td in before]
    w.close()

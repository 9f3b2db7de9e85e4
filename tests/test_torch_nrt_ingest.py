"""An append-only stream into the port's writer, served through NRT
refreshes, on the CPU.

(a) LogDocMergePolicy against cases worked by hand from Lucene 6.2.1's
    LogMergePolicy.findMerges and findForcedMerges: every candidate is a
    run of adjacent segments.
(b) A stream of block adds, refreshes that merge (merge_on_refresh) on a
    ConcurrentMergeScheduler's threads: doc i of every NRT reader is the
    i-th doc added, and the last reader answers as a single-segment index
    of the same docs does, and as portbench's plain BM25 over the same
    prefix. The same stream under TieredMergePolicy reorders the docs,
    which is why the stream needs the order-keeping policy.
(c) A refresh builds device forms for the new leaves only; the base
    leaf's form and its phrase planes survive it.
(d) The write side's spans and counters open and count.
(e) Merges in the ConcurrentMergeScheduler's worker processes: the same
    stream keeps its order and its merges join the readers; a worker's
    merge writes the bytes a thread's merge writes, deletes, stored fields
    of a memory-mapped segment and doc-value updates included; a failed
    merge surfaces in the writer; closing the scheduler ends its workers.
"""

import threading

import numpy as np
import pytest

import rucene_tpu_torch as T
from portbench import check
from portbench import corpus as pb_corpus
from portbench.reference import bm25
from portbench.traffic import Row
from rucene_tpu_torch.index.log_merge_policy import LogDocMergePolicy
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import assert_batches_strict

# --- (a) the policy against hand-worked cases --------------------------------


def _named(sizes):
    return {f"s{i}": s for i, s in enumerate(sizes)}


def _runs(cands):
    return [[int(n[1:]) for n in c.segments] for c in cands]


# sizes in index order -> the runs Lucene 6.2.1 merges (segment positions)
FIND_MERGES = {
    # 25 flushes of 100 docs: all under the floor (1,000 docs), one level
    "equal_flushes": ([100] * 25, [list(range(0, 10)), list(range(10, 20))]),
    # a 1M base alone on its level; the 12 flushes after it on the floor's
    "base_then_flushes": ([1_000_000] + [500] * 12, [list(range(1, 11))]),
    # merged 5,000s (level 3.7) keep to their range; the floor bounds it
    "merged_then_flushes": ([1_000_000, 5000, 5000, 5000] + [500] * 10, [list(range(4, 14))]),
    # a larger segment breaks the run: the 6 before it form a range that
    # ends at it, the 9 after are too few
    "broken_by_larger": ([100] * 5 + [50_000] + [100] * 9, []),
    # a segment to the right on the top level pulls the small ones left of
    # it into its range: the first 10 adjacent merge, not the big one
    "small_left_of_top": ([100] * 12 + [50_000] + [100] * 3, [list(range(0, 10))]),
    "fewer_than_ten": ([100] * 9, []),
    "ten_exactly": ([200] * 10, [list(range(0, 10))]),
    # two levels of ten: 10 x 20,000 (level 4.3) and 10 x 2,000 (3.3)
    "two_levels": ([20_000] * 10 + [2000] * 10, [list(range(0, 10)), list(range(10, 20))]),
    # an empty segment counts as one doc
    "empty_segment": ([0] * 10, [list(range(0, 10))]),
}


@pytest.mark.parametrize("case", sorted(FIND_MERGES))
def test_log_doc_policy_find_merges(case):
    sizes, want = FIND_MERGES[case]
    got = _runs(LogDocMergePolicy().find_merges(_named(sizes)))
    assert got == want
    for run in got:
        assert run == list(range(run[0], run[0] + len(run)))


FORCED = {
    # runs of ten from the end while enough are left
    "tens_from_the_end": ([100] * 25, 1, [list(range(15, 25)), list(range(5, 15))]),
    "all_into_one": ([100] * 6, 1, [list(range(0, 6))]),
    # the cheapest adjacent run of 3 under twice its left neighbour
    "cheapest_run": ([1000, 50, 40, 30, 500], 3, [[1, 2, 3]]),
    "already_few": ([100, 100], 2, []),
}


@pytest.mark.parametrize("case", sorted(FORCED))
def test_log_doc_policy_forced_merges(case):
    sizes, max_segments, want = FORCED[case]
    assert _runs(LogDocMergePolicy().find_forced_merges(_named(sizes), max_segments)) == want


# --- (b) the stream -----------------------------------------------------------

SPEC = {"docs": 1300, "vocab": 400, "exponent": 1.1, "min_words": 4, "max_words": 24, "seed": 5}
BASE = 300
CHUNK = 20
CHUNKS_A_REFRESH = (1, 3, 2)  # flushes of unequal size, as a timed stream makes


@pytest.fixture(scope="module")
def corpus():
    c = pb_corpus.build(SPEC)
    return c, pb_corpus.texts(c, 0, c.n_docs)


def _docs(texts, lo):
    out = []
    for i, t in enumerate(texts):
        d = T.Document()
        d.add(T.StringField("id", str(lo + i), stored=True))
        d.add(T.TextField("body", t))
        out.append(d)
    return out


def _writer(path, texts, policy, base=BASE, processes=False):
    w = T.IndexWriter(T.FSDirectory(str(path)), T.IndexWriterConfig(
        max_buffered_docs=10**6, merge_policy=policy,
        merge_scheduler=T.ConcurrentMergeScheduler(max_threads=2, processes=processes),
        merge_on_commit=False, merge_on_refresh=True, commit_on_close=False))
    w.add_documents(_docs(texts[:base], 0))
    w.commit()
    return w


def _stream(w, mgr, texts, on_refresh, lo=BASE):
    """Adds chunks of CHUNK docs and refreshes after 1, 3, 2, ... of them;
    on_refresh(searcher, docs acknowledged) after each refresh; at the end
    waits for the merges and refreshes once more."""
    i, r = lo, 0
    while i < len(texts):
        for _ in range(CHUNKS_A_REFRESH[r % len(CHUNKS_A_REFRESH)]):
            if i < len(texts):
                hi = min(i + CHUNK, len(texts))
                w.add_documents(_docs(texts[i:hi], i))
                i = hi
        r += 1
        mgr.maybe_refresh()
        on_refresh(mgr.acquire(), i)
    w.config.merge_scheduler.sync()
    mgr.maybe_refresh()
    on_refresh(mgr.acquire(), i)


def _ids(reader):
    return [int(reader.document(d)["id"]) for d in range(reader.max_doc)]


def test_log_policy_keeps_arrival_order(corpus, tmp_path):
    c, texts = corpus
    w = _writer(tmp_path, texts, LogDocMergePolicy())
    mgr = T.SearcherManager(w, searcher_factory=lambda r: T.IndexSearcher(r, device="cpu"))
    merges = METRICS.snapshot()["counters"].get("writer.merges", 0)
    seen = []

    def in_order(s, acked):
        assert s.reader.max_doc == acked
        assert _ids(s.reader) == list(range(acked))
        seen.append(len(s.reader.leaves))

    _stream(w, mgr, texts, in_order)
    assert not w.merge_exceptions
    assert METRICS.snapshot()["counters"]["writer.merges"] - merges >= 2
    assert max(seen) >= 10 and seen[-1] < max(seen)  # the merges joined the readers

    # the last reader against one segment of the same docs, and against the
    # plain reference over the same prefix
    s = mgr.acquire()
    one = T.IndexWriter(T.FSDirectory(str(tmp_path / "one")),
                        T.IndexWriterConfig(max_buffered_docs=10**6))
    one.add_documents(_docs(texts, 0))
    one.commit()
    single = T.IndexSearcher(T.open_directory_reader(T.FSDirectory(str(tmp_path / "one"))),
                             device="cpu")
    assert len(single.reader.leaves) == 1
    words = [f"w{t}" for t in (3, 7, 12, 40, 90, 150)]
    qs = [T.TermQuery(T.Term("body", x)) for x in words[:3]]
    for a, b in ((0, 1), (2, 4), (3, 5)):
        q = T.BooleanQuery()
        q.should(T.TermQuery(T.Term("body", words[a])))
        q.should(T.TermQuery(T.Term("body", words[b])))
        qs.append(q)
    q = T.BooleanQuery()
    q.must(T.TermQuery(T.Term("body", words[0])))
    q.must(T.TermQuery(T.Term("body", words[2])))
    qs.append(q)
    phrase = tuple(int(t) for t in c.tokens[c.offsets[700]:c.offsets[700] + 2])
    qs.append(T.PhraseQuery("body", [f"w{t}" for t in phrase]))
    got = s.search_batch(qs, k=50)
    assert_batches_strict(got, single.search_batch(qs, k=50))

    ref = bm25.Scorer(bm25.Index(c.tokens, c.offsets, len(c.probs)), c.n_docs)
    rows = ([Row("term", (), (t,), ()) for t in (3, 7, 12)]
            + [Row("or2", (), (a, b), ()) for a, b in ((3, 7), (12, 90), (40, 150))]
            + [Row("and2", (3, 12), (), ()), Row("phrase", (), (), phrase)])
    for td, row in zip(got, rows):
        kept = check.Kept(0, c.n_docs, td.total_hits, np.array([sd.doc for sd in td.score_docs]),
                          np.array([sd.score for sd in td.score_docs], np.float64))
        assert td.total_hits > 0
        numbers = check.compare(kept, ref.answer(row, 50), 50)
        assert all(v <= check.LIMITS[n] for n, v in numbers.items()), (row, numbers)
    w.close()


def test_tiered_policy_reorders_the_stream(corpus, tmp_path):
    _c, texts = corpus
    w = _writer(tmp_path, texts, T.TieredMergePolicy())
    mgr = T.SearcherManager(w, searcher_factory=lambda r: T.IndexSearcher(r, device="cpu"))
    out_of_order = []

    def check(s, acked):
        assert s.reader.max_doc == acked
        ids = _ids(s.reader)
        assert sorted(ids) == list(range(acked))
        out_of_order.append(ids != list(range(acked)))

    _stream(w, mgr, texts, check)
    assert not w.merge_exceptions
    assert out_of_order[-1]
    w.close()


def test_ingest_thread_and_refreshes_keep_arrival_order(corpus, tmp_path):
    """An ingest thread adds chunks while the main thread refreshes, with a
    switch interval far below the default so the threads and the merge
    threads interleave often: every reader holds exactly the docs
    acknowledged under the ingest lock when it was opened, in order."""
    import sys
    import threading

    _c, texts = corpus
    w = _writer(tmp_path, texts, LogDocMergePolicy(min_merge_docs=10))
    lock = threading.Lock()
    acked = [BASE]
    errors = []

    def ingest():
        try:
            for lo in range(BASE, len(texts), CHUNK):
                docs = _docs(texts[lo:lo + CHUNK], lo)
                with lock:
                    w.add_documents(docs)
                    acked[0] = lo + len(docs)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    class Locked:
        def get_reader(self):
            with lock:
                r = w.get_reader()
                r.acked = acked[0]
            return r

    mgr = T.SearcherManager(Locked(), searcher_factory=lambda r: T.IndexSearcher(r, device="cpu"))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        th = threading.Thread(target=ingest)
        th.start()
        readers = 0
        while th.is_alive() or readers < 3:
            mgr.maybe_refresh()
            r = mgr.acquire().reader
            assert r.max_doc == r.acked and _ids(r) == list(range(r.acked))
            readers += 1
        th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not th.is_alive() and not errors and not w.merge_exceptions
    w.config.merge_scheduler.sync()
    mgr.maybe_refresh()
    r = mgr.acquire().reader
    assert _ids(r) == list(range(len(texts)))
    w.close()


# --- (c) a refresh builds only what is new -----------------------------------


def test_refresh_builds_new_leaves_only(corpus, tmp_path, monkeypatch):
    """The base is larger than the policy's floor, so no merge takes it;
    every refresh builds one device form a new leaf (the merged ones
    included), and the base's form and phrase planes are the ones built
    before the stream."""
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setattr(T.IndexSearcher, "PHRASE_PLANE_MIN_DOCS", 1)
    monkeypatch.setattr(T.IndexSearcher, "PHRASE_PLANE_ITEM_MIN", 1)
    _c, texts = corpus
    w = _writer(tmp_path, texts, LogDocMergePolicy(min_merge_docs=100), base=600)

    def factory(r):
        s = T.IndexSearcher(r, device="cpu")
        for leaf in s.reader.leaves:
            _ = leaf.device  # the new leaves' forms, inside the refresh
        return s

    mgr = T.SearcherManager(w, searcher_factory=factory)
    s0 = mgr.acquire()
    assert len(s0.reader.leaves) == 1
    assert s0.prewarm_phrase_planes("body", min_blocks=1) > 0
    base = s0.reader.leaves[0]
    form, planes = base._forms[base.torch_device], dict(phrase_path._PLANE_CACHE)
    builds, plane_builds = (METRICS.snapshot()["counters"].get(n, 0) for n in
                            ("reader.device_builds", "search.phrase_plane_build"))
    names = {base.name}
    new = [0]

    def check(s, acked):
        fresh = {lf.name for lf in s.reader.leaves} - names
        new[0] += len(fresh)
        names.update(fresh)
        assert s.reader.leaves[0].source is base.source
        assert s.reader.leaves[0]._forms[base.torch_device] is form
        assert METRICS.snapshot()["counters"]["reader.device_builds"] - builds == new[0]

    _stream(w, mgr, texts, check, lo=600)
    assert new[0] > 10
    counters = METRICS.snapshot()["counters"]
    assert counters.get("search.phrase_plane_build", 0) == plane_builds
    s = mgr.acquire()
    assert s.search_batch([T.PhraseQuery("body", ["w0", "w1"])], k=5)[0].total_hits > 0
    for key, ent in planes.items():
        assert phrase_path._PLANE_CACHE.get(key) is ent
    w.close()


# --- (d) spans and counters ---------------------------------------------------


def test_write_side_spans_and_counters(corpus, tmp_path):
    _c, texts = corpus
    METRICS.reset()
    w = _writer(tmp_path, texts[:700], LogDocMergePolicy())
    mgr = T.SearcherManager(w, searcher_factory=lambda r: T.IndexSearcher(r, device="cpu"))
    _stream(w, mgr, texts[:700], lambda s, acked: s.search(T.TermQuery(T.Term("body", "w1")), 5))
    snap = METRICS.snapshot()
    timers, counters = snap["timers"], snap["counters"]
    adds = 1 + (700 - BASE) // CHUNK  # the base's block and the stream's chunks
    assert timers["writer.add_documents"]["count"] == adds
    refreshes = timers["nrt.refresh"]["count"]
    # every refresh calls get_reader once; so did the manager's first reader
    assert timers["writer.get_reader"]["count"] == refreshes + 1
    assert timers["writer.flush"]["count"] == counters["writer.flushes"]
    assert timers["writer.merge"]["count"] == counters["writer.merges"] >= 1
    assert counters["writer.merged_docs"] >= BASE + 9 * CHUNK  # the base and 9 flushes
    # one search a refresh, each walking that reader's leaves
    assert counters["search.leaves"] >= refreshes
    assert counters["search.queries"] == refreshes
    w.close()


# --- (e) merges in worker processes -------------------------------------------


def _segment_bytes(seg, path):
    from rucene_tpu_torch.codec import files as segfiles

    segfiles.write_segment(T.FSDirectory(str(path)), "_m", seg)
    with open(path / "_m.seg", "rb") as f:
        return f.read()


def test_process_merges_keep_arrival_order(corpus, tmp_path):
    """The stream of (b) with each merge in a worker process: every reader
    holds the docs in arrival order, and the merges join the readers."""
    _c, texts = corpus
    w = _writer(tmp_path, texts, LogDocMergePolicy(), processes=True)
    mgr = T.SearcherManager(w, searcher_factory=lambda r: T.IndexSearcher(r, device="cpu"))
    merges = METRICS.snapshot()["counters"].get("writer.merges", 0)
    seen = []

    def in_order(s, acked):
        assert s.reader.max_doc == acked
        assert _ids(s.reader) == list(range(acked))
        seen.append(len(s.reader.leaves))

    _stream(w, mgr, texts, in_order)
    assert not w.merge_exceptions
    assert METRICS.snapshot()["counters"]["writer.merges"] - merges >= 2
    assert max(seen) >= 10 and seen[-1] < max(seen)
    workers = list(w.config.merge_scheduler._idle)
    assert workers
    w.close()
    assert all(wk.proc.returncode == 0 for wk in workers)


def test_process_merge_writes_the_thread_merge_bytes(corpus, tmp_path):
    """Three flushed segments, the first reopened memory-mapped from its
    commit (stored fields read lazily), with deletes and a doc-value
    update on them: the worker's merged segment is the thread's, byte for
    byte."""
    from rucene_tpu_torch.index.merge import merge_segments
    from rucene_tpu_torch.index.merge_scheduler import ConcurrentMergeScheduler

    _c, texts = corpus
    w = T.IndexWriter(T.FSDirectory(str(tmp_path / "idx")), T.IndexWriterConfig(
        max_buffered_docs=10**6, merge_on_commit=False, commit_on_close=False))
    for lo, hi in ((0, 120), (120, 200), (200, 260)):
        docs = _docs(texts[lo:hi], lo)
        for i, d in enumerate(docs):
            d.add(T.NumericDocValuesField("n", lo + i))
        w.add_documents(docs)
        w.commit()
    w.delete_documents_by_term(T.Term("id", "5"))
    w.delete_documents_by_term(T.Term("id", "150"))
    w.update_numeric_doc_value(T.Term("id", "7"), "n", 1000)
    w.commit()
    reader = T.open_directory_reader(T.FSDirectory(str(tmp_path / "idx")))
    snaps = [leaf.source for leaf in reader.leaves]
    assert len(snaps) == 3 and sum(s.live is not None for s in snaps) == 2
    sched = ConcurrentMergeScheduler(max_threads=1, processes=True)
    try:
        got = sched.segment_merge(snaps)
    finally:
        sched.close()
    want = merge_segments(snaps)
    assert got.max_doc == want.max_doc == 258
    assert _segment_bytes(got, tmp_path / "a") == _segment_bytes(want, tmp_path / "b")
    w.close()


def test_failed_process_merge_surfaces_in_the_writer(corpus, tmp_path):
    """An input the worker cannot merge: the merge thread records the error
    in merge_exceptions, the inputs stay searchable, and the scheduler
    closes its workers."""
    _c, texts = corpus
    w = T.IndexWriter(T.FSDirectory(str(tmp_path)), T.IndexWriterConfig(
        max_buffered_docs=10**6, merge_on_commit=False, merge_on_refresh=True,
        commit_on_close=False, merge_policy=LogDocMergePolicy(merge_factor=2, min_merge_docs=1),
        merge_scheduler=T.ConcurrentMergeScheduler(max_threads=1, processes=True)))
    w.add_documents(_docs(texts[:50], 0))
    w.flush()
    w.add_documents(_docs(texts[50:100], 50))
    w.flush()
    for info in w._all_infos():
        w._snapshot(info).packed.blk_off = None  # the worker's decode fails on it
    assert w.maybe_merge() == 1
    w.config.merge_scheduler.sync()
    assert len(w.merge_exceptions) == 1
    assert "merge failed in its worker process" in str(w.merge_exceptions[0])
    assert len(w._all_infos()) == 2 and not w._merging
    w.config.merge_scheduler.close()
    assert w.config.merge_scheduler._idle == []


def test_scheduler_close_ends_its_workers():
    from rucene_tpu_torch.index.merge_scheduler import ConcurrentMergeScheduler

    sched = ConcurrentMergeScheduler(max_threads=2, processes=True)
    got = {}

    def one(key):
        got[key] = sched.segment_merge([])

    threads = [threading.Thread(target=one, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [g.max_doc for g in got.values()] == [0, 0]
    workers = list(sched._idle)
    assert 1 <= len(workers) <= 2 and all(wk.proc.poll() is None for wk in workers)
    sched.close()
    assert all(wk.proc.returncode == 0 for wk in workers) and sched._idle == []

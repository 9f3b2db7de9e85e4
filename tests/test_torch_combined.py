"""The combined multi-segment view (rucene_tpu_torch/index/combined.py and
IndexSearcher(combine_segments=True)) against rucene_tpu on the CPU.

One index written by the port's IndexWriter into an FSDirectory, read by
both packages: the port's combined searcher must answer as the reference's
per-leaf searcher and its combined searcher do (tests/torch_hitcheck.py's
strict rules over complete hit lists, scores within RTOL 4e-7), on decoded
and packed views, with deletes, ranges and match-all rows, across an NRT
refresh. Then the view cache: reuse, a live-plane swap on deletes, no
stale mask served through a recycled id(), no view served to a reader on
another device, and field_gid compaction. The reference's WAND test over
the view (tests/test_combined_view.py:76) is in tests/test_torch_prune.py.
"""

import gc

import numpy as np
import pytest
import torch

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.index.reader import open_directory_reader as ref_open
from rucene_tpu.store.directory import FSDirectory as RefFS
from rucene_tpu_torch.index import combined
from rucene_tpu_torch.index.reader import SegmentSnapshot
from rucene_tpu_torch.util.metrics import METRICS
from tests.conftest import random_corpus
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 1000


def _write(path, n_docs, max_buffered, delete_every=None, seed=7):
    rng = np.random.default_rng(seed)
    texts = random_corpus(rng, n_docs)
    w = T.IndexWriter(
        T.FSDirectory(str(path)),
        T.IndexWriterConfig(max_buffered_docs=max_buffered, merge_on_commit=False),
    )
    for i, t in enumerate(texts):
        d = T.Document()
        d.add(T.StringField("id", str(i), stored=True))
        d.add(T.TextField("body", t))
        d.add(T.TextField("title", " ".join(t.split()[:3])))
        d.add(T.IntPoint("ts", (i * 37) % 500))
        w.add_document(d)
    if delete_every:
        for i in range(0, n_docs, delete_every):
            w.delete_documents_by_term(T.Term("id", str(i)))
    w.commit()
    return w, texts


def _queries(P):
    tq = lambda f, t: P.TermQuery(P.Term(f, t))
    return [
        tq("body", "the"),
        tq("body", "fox"),
        tq("title", "the"),
        P.BooleanQuery().should(tq("body", "fox")).should(tq("body", "dog")),
        P.BooleanQuery().must(tq("body", "the")).must(tq("body", "of")),
        P.BooleanQuery().must(tq("body", "the")).must_not(tq("body", "fox")),
        P.BooleanQuery().should(tq("body", "fox")).should(tq("title", "the"))
        .should(tq("body", "zzz_absent")),
        P.BooleanQuery().must(tq("body", "quick")).filter(P.PointRangeQuery("ts", 50, 300)),
        P.BooleanQuery().should(tq("body", "lazy")).should(P.PointRangeQuery("ts", 400, 450)),
        P.MatchAllDocsQuery(),
    ]


def _port(path, **kw):
    return T.IndexSearcher(T.open_directory_reader(T.FSDirectory(str(path))), device="cpu", **kw)


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("max_buffered,delete_every", [(40, None), (25, 9), (13, 5)])
def test_combined_matches_per_leaf(tmp_path, monkeypatch, decoded, max_buffered, delete_every):
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    monkeypatch.setenv("RUCENE_PLANES", "0")
    monkeypatch.setenv("RUCENE_PAIR", "0")
    w, _ = _write(tmp_path, 200, max_buffered, delete_every)
    ref_reader = ref_open(RefFS(str(tmp_path)))
    assert len(ref_reader.leaves) > 1
    want = R.IndexSearcher(ref_reader).search_batch(_queries(R), k=K_ALL)
    want_comb = R.IndexSearcher(ref_reader, combine_segments=True).search_batch(
        _queries(R), k=K_ALL
    )
    METRICS.reset()
    comb = _port(tmp_path, combine_segments=True)
    got = comb.search_batch(_queries(T), k=K_ALL)
    counters = METRICS.snapshot()["counters"]
    assert counters.get("reader.combined_builds") == 1
    assert_batches_strict(got, want)
    assert_batches_strict(got, want_comb)
    assert_batches_strict(got, _port(tmp_path).search_batch(_queries(T), k=K_ALL))
    # truncated lists are the exact head of the complete ones (rows of at
    # most two scoring clauses: their sums do not depend on order)
    for k in (5, 17):
        for a, b in zip(comb.search_batch(_queries(T)[:6], k=k), got[:6]):
            assert a.total_hits == b.total_hits and a.score_docs == b.score_docs[:k]
    w.close()


def test_combined_single_leaf_and_refresh(tmp_path):
    w, _ = _write(tmp_path, 60, 1000)
    r = w.get_reader()
    assert len(r.leaves) == 1
    s = T.IndexSearcher(r, device="cpu", combine_segments=True)  # per leaf
    assert s.search(T.TermQuery(T.Term("body", "the")), 5).total_hits > 0
    assert s._combined is None
    for i in range(5):
        doc = T.Document()
        doc.add(T.StringField("id", f"n{i}", stored=True))
        doc.add(T.TextField("body", "freshly added the document"))
        w.add_document(doc)
    w.commit()
    s2 = T.IndexSearcher(w.get_reader(), device="cpu", combine_segments=True)
    rows = [T.TermQuery(T.Term("body", "the")), T.TermQuery(T.Term("body", "freshly"))]
    got = s2.search_batch(rows, k=K_ALL)
    assert s2._combined is not None
    ref = R.IndexSearcher(ref_open(RefFS(str(tmp_path))))
    assert_batches_strict(
        got, ref.search_batch([R.TermQuery(R.Term("body", "the")),
                               R.TermQuery(R.Term("body", "freshly"))], k=K_ALL)
    )
    w.close()


def test_combined_stored_coherent(tmp_path):
    """Doc ids from the combined path address the same stored docs."""
    w, texts = _write(tmp_path, 120, 30)
    r = w.get_reader()
    td = T.IndexSearcher(r, device="cpu", combine_segments=True).search(
        T.TermQuery(T.Term("body", "fox")), 10
    )
    assert td.score_docs
    for sd in td.score_docs:
        assert "fox" in texts[int(r.document(sd.doc)["id"])].split()
    w.close()


def _leaf(name, text):
    from rucene_tpu_torch.codec.postings import pack_segment
    from rucene_tpu_torch.index.memory import SegmentBuffer

    buf = SegmentBuffer()
    doc = T.Document()
    doc.add(T.TextField("body", text))
    buf.add_document(doc)
    return SegmentSnapshot(name, pack_segment(buf.finish()))


def _leaves():
    return [_leaf("c0", "alpha beta"), _leaf("c1", "beta gamma"), _leaf("c2", "gamma delta")]


def test_combined_view_cache_reuse():
    """Same leaves: the same view. A delete refresh swaps the live plane
    and shares the rest."""
    leaves = _leaves()
    v1 = combined.cached_combined_view(leaves, "cpu")
    assert combined.cached_combined_view(leaves, "cpu") is v1
    live = np.ones(1, bool)
    live[0] = False
    leaves2 = [leaves[0].with_deletes(live)] + leaves[1:]
    v3 = combined.cached_combined_view(leaves2, "cpu")
    assert v3 is not v1 and v3.device.data is v1.device.data
    s = T.IndexSearcher(T.IndexReader(leaves2), device="cpu", combine_segments=True)
    hits = s.search_batch([T.TermQuery(T.Term("body", w)) for w in ("alpha", "beta", "gamma")], 5)
    assert [td.total_hits for td in hits] == [0, 1, 2]


def test_no_stale_live_mask_through_a_recycled_id():
    """A view cached under one live mask is not served for a new mask that
    lands at the freed one's id() (the reference keys the masks by id()
    and keeps no reference to them)."""
    leaves = _leaves()
    seg = leaves[0].packed
    r1 = T.IndexReader([SegmentSnapshot("c0", seg, live=np.zeros(1, bool))] + leaves[1:])
    alpha = [T.TermQuery(T.Term("body", "alpha"))]
    assert T.IndexSearcher(r1, device="cpu", combine_segments=True).search_batch(
        alpha, 5)[0].total_hits == 0
    old_id = id(r1.leaves[0].live)
    del r1
    gc.collect()
    held, mask = [], None
    for _ in range(50_000):  # new all-live masks, kept, until one takes the freed id
        m = np.ones(1, bool)
        if id(m) == old_id:
            mask = m
            break
        held.append(m)
    assert mask is not None, "no new mask took the freed mask's id()"
    r2 = T.IndexReader([SegmentSnapshot("c0", seg, live=mask)] + leaves[1:])
    got = T.IndexSearcher(r2, device="cpu", combine_segments=True).search_batch(alpha, 5)
    assert got[0].total_hits == 1


def test_view_keyed_by_device():
    """A view built for one device is not served to a reader of the same
    segments on another ("cpu:0", a device name of its own, stands in for
    a second card)."""
    leaves = _leaves()
    v_cpu = combined.cached_combined_view(leaves, torch.device("cpu"))
    v_other = combined.cached_combined_view(leaves, torch.device("cpu", 0))
    assert v_other is not v_cpu
    assert combined.cached_combined_view(leaves, torch.device("cpu")) is v_cpu
    assert combined.cached_combined_view(leaves, torch.device("cpu", 0)) is v_other


def test_field_gid_compacts_across_refreshes():
    """A refresh that drops every leaf holding a field drops the field's id
    from the view's numbering; the fields kept keep their ids."""
    from rucene_tpu_torch.codec.postings import pack_segment
    from rucene_tpu_torch.index.memory import SegmentBuffer

    def seg(name, field):
        buf = SegmentBuffer()
        d = T.Document()
        d.add(T.TextField("body", "alpha"))
        d.add(T.TextField(field, "beta"))
        buf.add_document(d)
        return SegmentSnapshot(name, pack_segment(buf.finish()))

    gids = []
    for i in range(6):  # each refresh: one new field, one gone
        leaves = [seg(f"a{i}", f"f{i}"), seg(f"b{i}", f"f{i + 1}")]
        view = combined.cached_combined_view(leaves, "cpu")
        gids.append(dict(view.field_gid))
        assert set(view.field_gid) == {"body", f"f{i}", f"f{i + 1}"}
        assert sorted(view.field_gid.values()) == [0, 1, 2]
        s = T.IndexSearcher(T.IndexReader(leaves), device="cpu", combine_segments=True)
        assert s.search(T.TermQuery(T.Term(f"f{i + 1}", "beta")), 5).total_hits == 1
    for before, after in zip(gids, gids[1:]):
        assert after["body"] == before["body"]


def test_combined_view_timeout_interruptible(tmp_path):
    """A timed batch takes the per-leaf loop, whose deadline is checked
    between leaves; an untimed one takes the view and agrees."""
    w, _ = _write(tmp_path, 120, 30)
    s = T.IndexSearcher(w.get_reader(), device="cpu", combine_segments=True)
    q = [T.TermQuery(T.Term("body", "the"))]
    res = s.search_batch(q, k=5, timeout_s=0.0)
    assert s.timed_out is True and res[0].total_hits == 0
    res2 = s.search_batch(q, k=5, timeout_s=30.0)
    assert s.timed_out is False and res2[0].total_hits > 0
    assert s._combined is None
    res3 = s.search_batch(q, k=5)
    assert s._combined is not None and res3 == res2
    w.close()

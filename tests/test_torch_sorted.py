"""Sorted search and field collapse on the port (search/sorted_path.py,
executor.execute_flat_sorted / execute_collapse) against rucene_tpu, on
the CPU.

Corpora built by rucene_tpu (numeric doc values ``price``, ``stock`` and
``grp`` beside the body; some docs lack ``price`` or ``stock``) are
carried across with packed_from_reference and served by both packages.
Sort values, doc ids, total hits and collapse keys are compared exactly,
scores under the strict tolerance of tests/torch_hitcheck.py:
- 1-3 sort fields x reverse x deletes x 1 or 3 segments, boolean rows,
  match-all, the score sort (the host path, counted under route.host);
- the executors against the reference's on one leaf's inputs;
- early-terminated sorted search on an index sorted by the writer;
- collapse with and without deletes;
- a refresh through both packages' IndexWriters;
- the rank-table cache: a new searcher over unchanged leaves reuses it,
  a merged-away segment is not pinned by it, and a doc-values update gets
  new ranks.
"""

import gc
import weakref

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.search import sort_field as ref_sf
from rucene_tpu_torch.search import sort_field as port_sf
from rucene_tpu_torch.search import sorted_path
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import assert_topdocs_strict
from tests.torch_surface_data import assert_field_docs_equal, both, dv_docs, leaves_for

K = 12
FIELDS = ["price", "stock", "grp"]

_LAYOUTS: dict = {}


def layout(n_segments, deletes, n=300, seed=5):
    key = (n_segments, deletes, n, seed)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = both(leaves_for(dv_docs(n, seed), n_segments, deletes, seed=seed))
    return _LAYOUTS[key]


def sort_of(pkg_sf, n_fields, reverse, score=False):
    fields = [
        pkg_sf.SortField(f, pkg_sf.SortFieldType.LONG, reverse=(reverse if i % 2 == 0 else not reverse))
        for i, f in enumerate(FIELDS[:n_fields])
    ]
    if score:
        fields.append(pkg_sf.SortField(None, pkg_sf.SortFieldType.SCORE))
    return pkg_sf.Sort(fields)


def rows(pkg):
    t = lambda w: pkg.TermQuery(pkg.Term("body", w))  # noqa: E731
    return [
        t("the"), t("fox"), t("engine"),
        pkg.BooleanQuery().must(t("quick")).should(t("dog")),
        pkg.BooleanQuery().should(t("lazy")).should(t("tensor")).must_not(t("index")),
        pkg.BooleanQuery().must(t("score")).filter(pkg.PointRangeQuery("nope", 0, 5)),
    ]


@pytest.mark.parametrize("n_segments", [1, 3])
@pytest.mark.parametrize("deletes", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_fields", [1, 2, 3])
def test_sorted_matches_reference(n_fields, reverse, deletes, n_segments):
    ref, port = layout(n_segments, deletes)
    rs, ps = sort_of(ref_sf, n_fields, reverse), sort_of(port_sf, n_fields, reverse)
    for rq, pq in zip(rows(R), rows(T)):
        assert port._sorted_device_eligible(pq, ps) == ref._sorted_device_eligible(rq, rs)
        assert_field_docs_equal(port.search_sorted(pq, K, ps), ref.search_sorted(rq, K, rs))


def test_sorted_match_all_and_score_sort():
    """Match-all rows on the device path; a sort with a SCORE field on the
    host path, counted under route.host."""
    ref, port = layout(3, True)
    rs, ps = sort_of(ref_sf, 2, False), sort_of(port_sf, 2, False)
    assert port._sorted_device_eligible(T.MatchAllDocsQuery(), ps)
    assert_field_docs_equal(
        port.search_sorted(T.MatchAllDocsQuery(), K, ps),
        ref.search_sorted(R.MatchAllDocsQuery(), K, rs),
    )
    rs, ps = sort_of(ref_sf, 1, True, score=True), sort_of(port_sf, 1, True, score=True)
    METRICS.reset()
    for rq, pq in zip(rows(R)[:4], rows(T)[:4]):
        assert not port._sorted_device_eligible(pq, ps)
        assert_field_docs_equal(port.search_sorted(pq, K, ps), ref.search_sorted(rq, K, rs))
    assert METRICS.snapshot()["counters"].get("route.host", 0) == 4


def test_sorted_executor_matches_reference():
    """execute_flat_sorted and execute_collapse against the reference's on
    one leaf's inputs (the same rank columns): keys, docs, hits exact,
    scores bit-equal for these two-clause rows."""
    ref, port = layout(1, True)
    sort = sort_of(port_sf, 2, True)
    _n, ranks, _v = port._composite_rank_tables(sort)
    for rq_ref, rq_port in zip(rows(R)[:4], rows(T)[:4]):
        rr, pr = rq_ref.rewrite(), rq_port.rewrite()
        (_li, leaf, fq, combine, filters), = list(port._single_row_leaf_batches(pr))
        (_li2, rleaf, rfq, has_ef, rfilters), = list(ref._single_row_leaf_batches(rr))
        keycol = port._key_column(leaf, ranks[0], np.float32)
        got = [x.numpy() for x in sorted_exec(leaf, fq, combine, keycol, filters)]
        from rucene_tpu.search.executor import execute_collapse as ref_collapse
        from rucene_tpu.search.executor import execute_flat_sorted as ref_sorted

        want = [np.asarray(x) for x in ref_sorted(
            rleaf.device, rfq, ref_column(rleaf, ranks[0], np.float32), K, has_ef=has_ef,
            filters=rfilters,
        )]
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        kc = port._key_column(leaf, ranks[0] % 5, np.int32)
        from rucene_tpu_torch.search.executor import execute_collapse

        got = [x.numpy() for x in execute_collapse(leaf.device, fq, combine, kc, 4, filters=filters)]
        want = [np.asarray(x) for x in ref_collapse(
            rleaf.device, rfq, ref_column(rleaf, ranks[0] % 5, np.int32), 4, has_ef=has_ef,
            filters=rfilters,
        )]
        for g, w in zip(got, want):
            assert np.array_equal(g, w)  # key 4 is dropped, as mode="drop" does


def ref_column(leaf, col, dtype):
    """A key column over the reference leaf's own padded doc axis."""
    import jax.numpy as jnp

    out = np.zeros(leaf.device.max_doc_padded, dtype)
    out[: leaf.max_doc] = col[: leaf.max_doc]
    return jnp.asarray(out)


def sorted_exec(leaf, fq, combine, keycol, filters):
    from rucene_tpu_torch.search.executor import execute_flat_sorted

    return execute_flat_sorted(leaf.device, fq, combine, keycol, K, filters=filters)


def test_sorted_dense_match_runs_the_combine(monkeypatch):
    """Sorted and collapse rows reach the combine kernel's entry (its twin
    on the CPU): the row's real combine tables, not an all-residue call."""
    from rucene_tpu_torch.ops import cuda_combine

    calls = []
    real = cuda_combine.combine_lanes_plain

    def spy(*a, **kw):
        calls.append(int(a[3].numel()))  # entries combined
        return real(*a, **kw)

    monkeypatch.setattr(cuda_combine, "combine_lanes_plain", spy)
    _ref, port = layout(1, False)
    port.search_sorted(T.TermQuery(T.Term("body", "the")), K, sort_of(port_sf, 1, False))
    port.search_collapse(T.TermQuery(T.Term("body", "the")), K, "grp")
    assert len(calls) == 2 and min(calls) > 0


@pytest.mark.parametrize("n_segments,deletes", [(1, False), (3, False), (3, True)])
def test_collapse_matches_reference(n_segments, deletes):
    ref, port = layout(n_segments, deletes, n=280, seed=29)
    for field in ("grp", "price"):
        for rq, pq in zip(rows(R), rows(T)):
            got = port.search_collapse(pq, 4, field)
            want = ref.search_collapse(rq, 4, field)
            assert got.total_hits == want.total_hits
            assert [d for d, _ in got.score_docs] == [d for d, _ in want.score_docs]
            assert_topdocs_strict(got, want)


def _write(pkg, path, docs, index_sort=None, buffered=40):
    if pkg is R:
        from rucene_tpu.index.writer import IndexWriter, IndexWriterConfig
        from rucene_tpu.store.directory import FSDirectory
    else:
        from rucene_tpu_torch import FSDirectory, IndexWriter, IndexWriterConfig
    kw = {} if index_sort is None else {"index_sort": index_sort}
    w = IndexWriter(FSDirectory(str(path)), IndexWriterConfig(max_buffered_docs=buffered, **kw))
    for i, (text, price, stock, grp) in enumerate(docs):
        d = pkg.Document()
        d.add(pkg.StringField("id", str(i)))
        d.add(pkg.TextField("body", text))
        if price is not None:
            d.add(pkg.NumericDocValuesField("price", price))
        if stock is not None:
            d.add(pkg.NumericDocValuesField("stock", stock))
        d.add(pkg.NumericDocValuesField("grp", grp))
        w.add_document(d)
    return w


def _port_searcher(w):
    return T.IndexSearcher(w.get_reader(), device="cpu")


def test_early_terminated_matches_reference(tmp_path):
    docs = dv_docs(200, 7)
    ws = [
        _write(P, tmp_path / name, docs, index_sort=sf.Sort([sf.SortField("stock", sf.SortFieldType.LONG)]))
        for P, sf, name in ((R, ref_sf, "r"), (T, port_sf, "p"))
    ]
    ref, port = R.IndexSearcher(ws[0].get_reader()), _port_searcher(ws[1])
    rs = ref_sf.Sort([ref_sf.SortField("stock", ref_sf.SortFieldType.LONG)])
    ps = port_sf.Sort([port_sf.SortField("stock", port_sf.SortFieldType.LONG)])
    for rq, pq in zip(rows(R)[:4], rows(T)[:4]):
        for limit in (3, 10):
            assert_field_docs_equal(
                port.search_sorted_early_terminated(pq, 8, ps, limit),
                ref.search_sorted_early_terminated(rq, 8, rs, limit),
            )
    for w in ws:
        w.close()


def test_sorted_across_writer_refresh(tmp_path):
    """Both writers take the same docs, deletes and a doc-values update;
    sorted and collapse rows agree before and after each refresh."""
    docs = dv_docs(240, 11)
    ws = [_write(P, tmp_path / name, docs[:160]) for P, name in ((R, "r"), (T, "p"))]
    rs, ps = sort_of(ref_sf, 2, True), sort_of(port_sf, 2, True)

    def check():
        ref, port = R.IndexSearcher(ws[0].get_reader()), _port_searcher(ws[1])
        for rq, pq in zip(rows(R)[:4], rows(T)[:4]):
            assert_field_docs_equal(port.search_sorted(pq, K, ps), ref.search_sorted(rq, K, rs))
            got, want = port.search_collapse(pq, 5, "grp"), ref.search_collapse(rq, 5, "grp")
            assert [d for d, _ in got.score_docs] == [d for d, _ in want.score_docs]
            assert_topdocs_strict(got, want)

    check()
    for (P, w) in ((R, ws[0]), (T, ws[1])):
        for i, (text, price, stock, grp) in enumerate(docs[160:], start=160):
            d = P.Document()
            d.add(P.StringField("id", str(i)))
            d.add(P.TextField("body", text))
            d.add(P.NumericDocValuesField("price", price if price is not None else 1))
            d.add(P.NumericDocValuesField("grp", grp))
            w.add_document(d)
        w.delete_documents_by_term(P.Term("id", "3"))
        w.update_numeric_doc_value(P.Term("id", "7"), "price", -100)
        w.commit()
    check()
    for w in ws:
        w.force_merge(1)
        w.commit()
    check()
    for w in ws:
        w.close()


def test_rank_cache_survives_refresh():
    """A new searcher over the same leaves (an NRT refresh that changed
    nothing) finds the rank tables: no new entry."""
    _ref, port = layout(3, False)
    sort = sort_of(port_sf, 1, False)
    q = T.TermQuery(T.Term("body", "the"))
    port.search_sorted(q, 5, sort)
    n_before = len(sorted_path._RANK_CACHE)
    again = T.IndexSearcher(T.IndexReader([lf.source for lf in port.reader.leaves]), device="cpu")
    again.search_sorted(q, 5, sort)
    assert len(sorted_path._RANK_CACHE) == n_before


def test_rank_cache_pins_no_merged_segment(tmp_path):
    """Rank tables of segments a merge takes away do not keep those
    segments alive once no reader holds them (the reference's entries
    hold their segments)."""
    w = _write(T, tmp_path, dv_docs(200, 13))
    w.commit()
    s1 = _port_searcher(w)
    sort = sort_of(port_sf, 2, False)
    s1.search_sorted(T.TermQuery(T.Term("body", "the")), 5, sort)
    s1.search_collapse(T.TermQuery(T.Term("body", "the")), 5, "grp")
    old = [weakref.ref(lf.packed) for lf in s1.reader.leaves]
    assert len(old) > 1
    w.force_merge(1)
    w.commit()
    s2 = _port_searcher(w)
    del s1
    gc.collect()
    assert all(o() is None for o in old)
    s2.search_sorted(T.TermQuery(T.Term("body", "the")), 5, sort)
    assert all(all(p is not None for p in segs) for segs, _k, _v in sorted_path._RANK_CACHE.items())
    w.close()


def test_rank_cache_follows_dv_update(tmp_path):
    """A doc-values update makes a snapshot of the same segment; its sorted
    and collapse answers read the new values, as a fresh reference index
    with the update does."""
    docs = dv_docs(120, 17)
    ws = [_write(P, tmp_path / name, docs, buffered=1000) for P, name in ((R, "r"), (T, "p"))]
    rs, ps = sort_of(ref_sf, 1, False), sort_of(port_sf, 1, False)
    q_r, q_p = R.MatchAllDocsQuery(), T.MatchAllDocsQuery()
    port = _port_searcher(ws[1])
    before = port.search_sorted(q_p, 5, ps)
    port.search_collapse(q_p, 5, "grp")
    top = before.field_docs[0].doc
    for P, w in ((R, ws[0]), (T, ws[1])):
        w.update_numeric_doc_value(P.Term("id", str(top)), "price", 10_000)
        w.update_numeric_doc_value(P.Term("id", str(top)), "grp", 99)
    ref, port = R.IndexSearcher(ws[0].get_reader()), _port_searcher(ws[1])
    after = port.search_sorted(q_p, 5, ps)
    assert after.field_docs[0].doc != top
    assert_field_docs_equal(after, ref.search_sorted(q_r, 5, rs))
    got, want = port.search_collapse(q_p, 50, "grp"), ref.search_collapse(q_r, 50, "grp")
    assert [d for d, _ in got.score_docs] == [d for d, _ in want.score_docs]
    for w in ws:
        w.close()

"""The port's IndexWriter against rucene_tpu's, on the CPU.

Each case drives both packages' write paths through the same operations
(the cases of tests/test_writer.py, the doc-values updates of
tests/test_dv_codec.py and the index sort of tests/test_features3.py) and
compares what each observes: doc counts, file lists, leaf layouts, merge
candidates, raised error classes, stored fields and complete hit lists
(strictly, tests/torch_hitcheck.py). The port searches on the CPU.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from tests.torch_hitcheck import assert_topdocs_strict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(port: bool):
    if port:
        import rucene_tpu_torch as P
        from rucene_tpu_torch.codec import files
        from rucene_tpu_torch.index import merge, reader, writer
        from rucene_tpu_torch.search import search_manager, sort_field
        from rucene_tpu_torch.store import directory

        searcher = lambda r: P.IndexSearcher(r, device="cpu")  # noqa: E731
    else:
        import rucene_tpu as P
        from rucene_tpu.codec import files
        from rucene_tpu.index import merge, reader, writer
        from rucene_tpu.search import search_manager, sort_field
        from rucene_tpu.store import directory

        searcher = P.IndexSearcher
    return SimpleNamespace(
        P=P, files=files, merge=merge, reader=reader, writer=writer, dir=directory,
        sort=sort_field, searcher=searcher,
        manager=lambda w: search_manager.SearcherManager(w, searcher_factory=searcher),
    )


def _doc(m, i: int, text: str):
    d = m.P.Document()
    d.add(m.P.StringField("id", str(i), stored=True))
    d.add(m.P.TextField("body", text))
    return d


def _tq(m, field, text):
    return m.P.TermQuery(m.P.Term(field, text))


def _ids(r, td):
    return sorted(r.document(sd.doc)["id"] for sd in td.score_docs)


# --- the scenarios: each returns what its package observed ------------------


def store_roundtrip(m, tmp):
    d = m.dir.FSDirectory(str(tmp / "idx"))
    out = d.create_output("x.bin")
    out.write_header("x.bin")
    out.write(b"hello world payload")
    out.write_footer()
    out.close()
    raw = d.read_file("x.bin")
    got = [raw, m.dir.check_footer(raw, "x.bin")]
    bad = bytearray(raw)
    bad[15] ^= 0xFF
    with pytest.raises(m.dir.CorruptIndexError):
        m.dir.check_footer(bytes(bad), "x.bin")
    return got


def commit_and_reopen(m, tmp):
    d = m.dir.FSDirectory(str(tmp / "idx"))
    with m.writer.IndexWriter(d) as w:
        for i, t in enumerate(["fox jumps", "lazy dog", "fox fox dog"]):
            w.add_document(_doc(m, i, t))
        w.commit()
    reader = m.reader.open_directory_reader(d)
    td = m.searcher(reader).search(_tq(m, "body", "fox"), k=10)
    return [reader.num_docs, td, _ids(reader, td)]


def two_phase_commit_files(m, tmp):
    d = m.dir.FSDirectory(str(tmp / "idx"))
    w = m.writer.IndexWriter(d)
    w.add_document(_doc(m, 0, "hello world"))
    w.commit()
    first = sorted(d.list_all())
    w.add_document(_doc(m, 1, "second commit"))
    w.commit()
    w.close()
    return [first, sorted(d.list_all()), m.files.SEGMENTS_PREFIX]


def nrt_reader_and_manager(m, tmp):
    w = m.writer.IndexWriter(m.dir.RAMDirectory())
    w.add_document(_doc(m, 0, "alpha beta"))
    mgr = m.manager(w)
    q = _tq(m, "body", "alpha")
    got = [mgr.acquire().search(q, 5)]
    w.add_document(_doc(m, 1, "alpha gamma"))
    got += [mgr.acquire().search(q, 5), mgr.maybe_refresh(), mgr.acquire().search(q, 5)]
    got += [mgr.maybe_refresh()]
    w.close()
    return got


def delete_and_update(m, tmp):
    w = m.writer.IndexWriter(m.dir.RAMDirectory())
    for i, t in enumerate(["fox one", "fox two", "dog three"]):
        w.add_document(_doc(m, i, t))
    w.delete_documents_by_term(m.P.Term("id", "0"))
    r = w.get_reader()
    got = [r.num_docs, m.searcher(r).search(_tq(m, "body", "fox"), 5)]
    w.update_document(m.P.Term("id", "1"), _doc(m, 1, "cat two"))
    s2 = m.searcher(w.get_reader())
    got += [s2.search(_tq(m, "body", t), 5) for t in ("fox", "cat", "dog")]
    w.delete_documents_by_term(m.P.Term("body", "bird"))
    w.add_document(_doc(m, 9, "bird nine"))
    got += [m.searcher(w.get_reader()).search(_tq(m, "body", "bird"), 5)]
    w.close()
    return got


def delete_by_query(m, tmp):
    P = m.P
    d = m.dir.FSDirectory(str(tmp / "dbq"))
    w = m.writer.IndexWriter(d, m.writer.IndexWriterConfig(max_buffered_docs=4))
    for i in range(10):
        doc = P.Document()
        doc.add(P.StringField("id", str(i), stored=True))
        doc.add(P.TextField("body", f"tok{i} {'hot' if i % 2 == 0 else 'cold'}"))
        doc.add(P.IntPoint("year", 2000 + i))
        w.add_document(doc)
    w.delete_documents_by_query(P.PointRangeQuery("year", 2003, 2005))
    r = w.get_reader()
    s = m.searcher(r)
    got = [r.num_docs] + [s.search(_tq(m, "body", t), 5) for t in ("tok4", "tok6", "hot")]
    w.delete_documents_by_query(
        P.BooleanQuery().must(_tq(m, "body", "hot")).must(_tq(m, "body", "tok0"))
    )
    late = P.Document()
    late.add(P.StringField("id", "99", stored=True))
    late.add(P.TextField("body", "tok0 hot late"))
    w.add_document(late)
    r2 = w.get_reader()
    td = m.searcher(r2).search(_tq(m, "body", "tok0"), 5)
    got += [td, _ids(r2, td), w.num_deleted_docs(), w.has_uncommitted_changes()]
    w.commit()
    w.close()
    r3 = m.reader.open_directory_reader(d)
    got += [r3.num_docs, m.searcher(r3).search(_tq(m, "body", "hot"), 10)]
    return got


def deletes_survive_commit_reopen(m, tmp):
    d = m.dir.FSDirectory(str(tmp / "idx"))
    w = m.writer.IndexWriter(d)
    for i in range(5):
        w.add_document(_doc(m, i, f"term{i} common"))
    w.commit()
    w.delete_documents_by_term(m.P.Term("id", "2"))
    w.commit()
    w.close()
    r = m.reader.open_directory_reader(d)
    s = m.searcher(r)
    return [r.num_docs, s.search(_tq(m, "body", "common"), 10), s.search(_tq(m, "body", "term2"), 10),
            sorted(d.list_all())]


def rollback(m, tmp):
    w = m.writer.IndexWriter(m.dir.RAMDirectory())
    w.add_document(_doc(m, 0, "committed doc"))
    w.commit()
    w.add_document(_doc(m, 1, "uncommitted doc"))
    w.rollback()
    td = m.searcher(w.get_reader()).search(_tq(m, "body", "doc"), 5)
    w.close()
    return [td]


def force_merge(m, tmp):
    w = m.writer.IndexWriter(m.dir.RAMDirectory(), m.writer.IndexWriterConfig(max_buffered_docs=2))
    texts = [f"word{i} shared fox" if i % 2 == 0 else f"word{i} shared" for i in range(10)]
    for i, t in enumerate(texts):
        w.add_document(_doc(m, i, t))
    w.delete_documents_by_term(m.P.Term("id", "4"))
    r0 = w.get_reader()
    before = m.searcher(r0).search(_tq(m, "body", "fox"), 20)
    layout0 = [(lf.name, lf.doc_base, lf.num_docs) for lf in r0.leaves]
    w.force_merge(1)
    r1 = w.get_reader()
    after = m.searcher(r1).search(_tq(m, "body", "fox"), 20)
    got = [layout0, before, _ids(r0, before), [(lf.name, lf.doc_base) for lf in r1.leaves],
           r1.num_docs, after, _ids(r1, after)]
    w.close()
    return got


def auto_merge_policy(m, tmp):
    cfg = m.writer.IndexWriterConfig(
        max_buffered_docs=1, merge_policy=m.merge.TieredMergePolicy(merge_factor=4, segs_per_tier=4)
    )
    w = m.writer.IndexWriter(m.dir.RAMDirectory(), cfg)
    for i in range(12):
        w.add_document(_doc(m, i, f"common token{i}"))
    w.commit()
    r = w.get_reader()
    got = [[(lf.name, lf.max_doc) for lf in r.leaves], r.num_docs,
           m.searcher(r).search(_tq(m, "body", "common"), 20)]
    w.close()
    return got


def merge_policy_size_cap_and_deletes_reclaim(m, tmp):
    p = m.merge.TieredMergePolicy(merge_factor=4, segs_per_tier=1, max_merged_segment_docs=100)
    sizes = {"_big": 90, "_a": 30, "_b": 30, "_c": 30, "_d": 40}
    p2 = m.merge.TieredMergePolicy(merge_factor=10, segs_per_tier=10, deletes_pct_allowed=30.0)
    return [
        [c.segments for c in p.find_merges(sizes)],
        [c.segments for c in p2.find_merges({"_x": 50, "_y": 100}, deletes={"_x": 40, "_y": 5})],
        [c.segments for c in p.find_forced_merges(sizes, 2)],
    ]


def writer_reclaims_deletes_via_policy(m, tmp):
    cfg = m.writer.IndexWriterConfig(
        max_buffered_docs=10, merge_policy=m.merge.TieredMergePolicy(deletes_pct_allowed=25.0)
    )
    w = m.writer.IndexWriter(m.dir.RAMDirectory(), cfg)
    for i in range(20):
        w.add_document(_doc(m, i, f"tok{i} shared"))
    w.commit()
    for i in range(4):
        w.delete_documents_by_term(m.P.Term("id", str(i)))
    w.commit()
    got = [[(i.name, i.del_count) for i in w._infos.segments]]
    r = w.get_reader()
    got += [r.num_docs, m.searcher(r).search(_tq(m, "body", "shared"), 20)]
    w.close()
    return got


def merged_scores_match_unmerged(m, tmp):
    texts = [f"fox alpha{i % 3} beta{i % 5} fox" for i in range(40)]
    w1 = m.writer.IndexWriter(m.dir.RAMDirectory(), m.writer.IndexWriterConfig(max_buffered_docs=7))
    w2 = m.writer.IndexWriter(m.dir.RAMDirectory(), m.writer.IndexWriterConfig(max_buffered_docs=1000))
    for i, t in enumerate(texts):
        w1.add_document(_doc(m, i, t))
        w2.add_document(_doc(m, i, t))
    w1.force_merge(1)
    ta = m.searcher(w1.get_reader()).search(_tq(m, "body", "fox"), 40)
    tb = m.searcher(w2.get_reader()).search(_tq(m, "body", "fox"), 40)
    assert ta.score_docs == tb.score_docs
    w1.close()
    w2.close()
    return [ta, tb]


def write_lock_excludes_second_writer(m, tmp):
    got = []
    for d in (m.dir.FSDirectory(str(tmp / "lk")), m.dir.RAMDirectory()):
        w1 = m.writer.IndexWriter(d)
        with pytest.raises(m.dir.LockObtainFailedError):
            m.writer.IndexWriter(d)
        w1.close()
        m.writer.IndexWriter(d).close()  # released on close
        got.append(sorted(d.list_all()))
    return got


def crashed_writer_does_not_wedge_lock(m, tmp):
    """A lock FILE left by a dead writer never blocks; a live holder in
    another process (the port's FSDirectory, so both packages are held
    off by one flock) excludes until it dies."""
    path = str(tmp / "crash")
    d = m.dir.FSDirectory(path)
    proc = subprocess.Popen(["true"])
    proc.wait()
    with open(d._p("write.lock"), "w") as f:
        f.write(str(proc.pid))
    w = m.writer.IndexWriter(d)
    w.add_document(_doc(m, 0, "alive again"))
    w.commit()
    w.close()
    got = [d.file_exists("write.lock")]
    m.writer.IndexWriter(d).close()
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import time; from rucene_tpu_torch.store.directory import FSDirectory; "
         f"FSDirectory({path!r}).obtain_lock(); print('LOCKED', flush=True); time.sleep(60)"],
        stdout=subprocess.PIPE, text=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
    )
    try:
        got.append(holder.stdout.readline().strip())
        with pytest.raises(m.dir.LockObtainFailedError):
            m.writer.IndexWriter(d)
        holder.kill()
        holder.wait()
        m.writer.IndexWriter(d).close()
    finally:
        if holder.poll() is None:
            holder.kill()
            holder.wait()
    return got


def max_merged_segment_mb_cap(m, tmp):
    mp = m.merge.TieredMergePolicy(merge_factor=4, segs_per_tier=1, max_merged_segment_mb=1.0)
    kb = 1024
    sizes = {f"s{i}": 100 for i in range(5)}
    byte_sizes = {"s0": 100 * kb, "s1": 200 * kb, "s2": 300 * kb, "s3": 300 * kb, "s4": 600 * kb}
    return [
        [c.segments for c in mp.find_merges(sizes, byte_sizes=byte_sizes)],
        [c.segments for c in mp.find_merges(sizes)],
    ]


def block_add_contiguity_and_nrt_current(m, tmp):
    P = m.P
    w = m.writer.IndexWriter(m.dir.FSDirectory(str(tmp)), m.writer.IndexWriterConfig(max_buffered_docs=4))
    for i in range(3):
        w.add_document(_doc(m, f"s{i}", "single"))
    w.add_documents([_doc(m, f"b{i}", "blocked") for i in range(6)])
    r = w.get_reader()
    got = [w.nrt_is_current(r), m.searcher(r).search(_tq(m, "body", "blocked"), k=10),
           [(lf.name, lf.doc_base) for lf in r.leaves]]
    w.add_document(_doc(m, "late", "single"))
    got.append(w.nrt_is_current(r))
    r2 = w.get_reader()
    got += [w.nrt_is_current(r2), w.nrt_is_current(r)]
    w.update_documents(P.Term("body", "blocked"), [_doc(m, f"nb{i}", "reblocked") for i in range(2)])
    s3 = m.searcher(w.get_reader())
    got += [s3.search(_tq(m, "body", "blocked"), k=10), s3.search(_tq(m, "body", "reblocked"), k=10)]
    w.close()
    return got


def dv_updates(m, tmp):
    """Numeric and binary doc-values updates by term: visible to the NRT
    reader, persisted across commit and reopen, carried through a merge."""
    P = m.P
    d = m.dir.FSDirectory(str(tmp / "dv"))
    w = m.writer.IndexWriter(d, m.writer.IndexWriterConfig(max_buffered_docs=25))
    for i in range(60):
        doc = P.Document()
        doc.add(P.TextField("body", f"doc{i} common"))
        doc.add(P.NumericDocValuesField("rank", i * 3))
        doc.add(P.BinaryDocValuesField("blob", f"val/{i % 4}".encode()))
        w.add_document(doc)
    w.update_numeric_doc_value(P.Term("body", "doc9"), "rank", 777)
    w.update_binary_doc_value(P.Term("body", "doc30"), "blob", b"PATCHED")
    w.update_numeric_doc_value(P.Term("body", "nobody"), "rank", 1)

    def columns(r):
        out = []
        for lf in r.leaves:
            vals, present = lf.numeric_doc_values("rank")
            out.append((lf.name, vals.tolist(), present.tolist(), lf.binary_doc_values("blob")))
        return out

    got = [columns(w.get_reader())]
    w.commit()
    got.append(sorted(d.list_all()))
    got.append(columns(m.reader.open_directory_reader(d)))
    w.force_merge(1)
    w.commit()
    w.close()
    got.append(columns(m.reader.open_directory_reader(d)))
    return got


def index_sort(m, tmp):
    """IndexWriterConfig.index_sort: docs reordered by a numeric column at
    flush, stored fields and postings following the permutation."""
    P = m.P
    w = m.writer.IndexWriter(
        m.dir.RAMDirectory(),
        m.writer.IndexWriterConfig(index_sort=m.sort.Sort.by("rank"), max_buffered_docs=4),
    )
    for i, rank in enumerate([50, 10, 40, 20, 30, 5, 45]):
        doc = _doc(m, i, f"common word{i}")
        doc.add(P.NumericDocValuesField("rank", rank))
        w.add_document(doc)
    w.commit()
    r = w.get_reader()
    s = m.searcher(r)
    got = [[lf.numeric_doc_values("rank")[0].tolist() for lf in r.leaves],
           [r.document(i)["id"] for i in range(r.max_doc)],
           s.search(_tq(m, "body", "common"), 10), s.search(_tq(m, "body", "word1"), 10)]
    w.close()
    return got


SCENARIOS = [
    store_roundtrip, commit_and_reopen, two_phase_commit_files, nrt_reader_and_manager,
    delete_and_update, delete_by_query, deletes_survive_commit_reopen, rollback, force_merge,
    auto_merge_policy, merge_policy_size_cap_and_deletes_reclaim,
    writer_reclaims_deletes_via_policy, merged_scores_match_unmerged,
    write_lock_excludes_second_writer, crashed_writer_does_not_wedge_lock,
    max_merged_segment_mb_cap, block_add_contiguity_and_nrt_current, dv_updates, index_sort,
]


def _assert_same(got, want, where="") -> None:
    if hasattr(want, "score_docs"):
        assert_topdocs_strict(got, want)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_writer_parity(scenario, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = scenario(_pkg(False), tmp_path / "ref")
    got = scenario(_pkg(True), tmp_path / "port")
    assert want, scenario.__name__
    _assert_same(got, want)

"""The plain reference (portbench/reference) against rucene_tpu_torch on
the CPU: every row class of the two mixes, at k=100 and k=1000, over one
committed segment, over a writer's flushed segments (a prefix of the
corpus), and after a merge."""

import numpy as np
import pytest

from portbench import check, traffic
from portbench import corpus as corpus_mod
from portbench.index_cache import documents
from portbench.reference import bm25

SPEC = {"docs": 3000, "vocab": 20000, "exponent": 1.1, "min_words": 8, "max_words": 104,
        "seed": 7}
MIXES = ("mix", "manyword")


@pytest.fixture(scope="module")
def corpus():
    return corpus_mod.build(SPEC)


@pytest.fixture(scope="module")
def index(corpus):
    return bm25.Index(corpus.tokens, corpus.offsets, SPEC["vocab"])


def _write(tmp_path, corpus, chunks, max_buffered, merge=False):
    import rucene_tpu_torch as rt

    w = rt.IndexWriter(rt.FSDirectory(str(tmp_path)),
                       rt.IndexWriterConfig(max_buffered_docs=max_buffered, merge_on_commit=False))
    lo = 0
    for hi in chunks:
        w.add_documents(documents(corpus_mod.texts(corpus, lo, hi), "body"))
        w.flush()
        lo = hi
    w.commit()
    if merge:
        w.force_merge(1)
        w.commit()
    reader = w.get_reader()
    w.close()
    return rt.IndexSearcher(reader, device="cpu")


def _held(searcher, corpus, index, rows, k, n_docs):
    kept = []
    res = searcher.search_batch(traffic.to_queries(rows, "body"), k=k)
    for i, td in enumerate(res):
        sd = td.score_docs
        kept.append(check.Kept(i, n_docs, td.total_hits, np.array([s.doc for s in sd]),
                               np.array([s.score for s in sd])))
    sc = bm25.Scorer(index, n_docs)
    return check.judge(kept, lambda kr: sc.answer(rows[kr.row], k), k)


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("k", (100, 1000))
@pytest.mark.parametrize("layout", ("one_segment", "flushed_prefix", "merged"))
def test_reference_equals_port(tmp_path, corpus, index, mix, k, layout):
    chunks, n_docs, merge = {
        "one_segment": ([3000], 3000, False),
        "flushed_prefix": ([1000, 1700, 2300], 2300, False),
        "merged": ([800, 1600, 3000], 3000, True),
    }[layout]
    searcher = _write(tmp_path, corpus, chunks, 10**6, merge)
    assert searcher.reader.max_doc == n_docs
    tr = dict(traffic.load(mix), queries_per_pass=96)
    rows = traffic.build_rows(tr, corpus, 11)
    assert {r.cls for r in rows} == {c["name"] for c in tr["classes"]}
    got = _held(searcher, corpus, index, rows, k, n_docs)
    assert got["count_err"] == 0
    assert got["score_err"] <= check.LIMITS["score_err"]
    assert got["rank_gap"] <= check.LIMITS["rank_gap"]


def test_norms_match_lucene_table():
    """SmallFloat byte315: 1/sqrt(len) for the lengths a doc can have, and
    the decoded lengths Lucene's NORM_TABLE holds (powers of two exact)."""
    lengths = np.array([1, 4, 8, 16, 63, 64, 100])
    b = bm25.float_to_byte315(np.float32(1.0) / np.sqrt(lengths).astype(np.float32))
    f = bm25.byte315_to_float(b)
    assert list(b[:4]) == [124, 120, 117, 116]  # 1, 1/2, ~1/sqrt(8), 1/4
    assert 1.0 / f[0] ** 2 == 1.0 and 1.0 / f[1] ** 2 == 4.0 and 1.0 / f[3] ** 2 == 16.0
    assert np.all(np.diff(1.0 / f**2) >= 0)


def test_bf16_rounds_to_eight_bits():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.14159265])
    assert list(bm25.bf16(x)) == [1.0, 1.0, 1.0078125, 3.140625]

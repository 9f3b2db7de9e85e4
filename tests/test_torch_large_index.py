"""The port at the size of the whole MS MARCO passage collection (8,841,823
passages in one segment, portbench's zipf8m) and its regime at a small
size.

At 8.8M docs a 256-row many-word batch splits by row class: the rows
whose every term holds a tf plane take the plane route, and the rest go to
the flat executor's dense branch over the whole doc axis, since only part
of the eligible terms fit the 8 GiB plane cap. Here that regime runs on a
few thousand docs with the plane budget cut to a part of the eligible
terms, and every answer is held against portbench's plain numpy BM25
(no code of the program) under the benchmark's own comparison
(portbench/check.py) at RTOL. The dense branch's lane counter is held
against a hand count. The budgets at the full size are pinned in
tests/test_torch_budgets.py and tests/test_torch_planes.py.
"""

import math

import numpy as np
import pytest

import rucene_tpu_torch as T
from portbench import check, index_cache, traffic
from portbench import corpus as pb_corpus
from portbench.reference import bm25
from portbench.traffic import Row
from rucene_tpu_torch.codec import device as codec_device
from rucene_tpu_torch.search import searcher as searcher_mod
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import RTOL

DOCS = 3000
SPEC = {"docs": DOCS, "vocab": 2000, "exponent": 1.1, "min_words": 8, "max_words": 104,
        "seed": 7}
CONFIG = {"name": "large-index-test", "docs": DOCS, "corpus": SPEC, "field": "body",
          "writer": {"max_buffered_docs": DOCS, "merge_on_commit": False}}
PLANES = 40  # tf planes the cut budget holds: a part of the eligible terms
K = 1000


@pytest.fixture(scope="module")
def corpus():
    return pb_corpus.build(SPEC)


@pytest.fixture(scope="module")
def committed(corpus, tmp_path_factory):
    """One committed segment of the corpus, written as the benchmark's cells
    write theirs (IndexWriter.add_documents of one block)."""
    cache = str(tmp_path_factory.mktemp("large_index"))
    return index_cache.committed(CONFIG, corpus, DOCS, lambda _msg: None, cache)


@pytest.fixture(scope="module")
def scorer(corpus):
    return bm25.Scorer(bm25.Index(corpus.tokens, corpus.offsets, len(corpus.probs)), DOCS)


def _searcher(path):
    return T.IndexSearcher(T.open_directory_reader(T.FSDirectory(path)), device="cpu")


def _doc_freqs(corpus):
    vocab = len(corpus.probs)
    doc = np.repeat(np.arange(corpus.n_docs, dtype=np.int64), np.diff(corpus.offsets))
    pairs = np.unique(doc * vocab + corpus.tokens)
    return np.bincount(pairs % vocab, minlength=vocab)


def test_partial_planes_and_dense_branch_against_the_reference(committed, corpus, scorer,
                                                               monkeypatch):
    """Many-word rows (4/5 OR of 3-10 terms, 1/5 ``+a +b c d``) at k=1000
    over a segment whose plane budget holds PLANES of its eligible terms:
    the batch splits, the all-planed rows take the plane route and the rest
    the dense branch; every row's hits, scores and total_hits match the
    reference."""
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PAIR", "1")
    monkeypatch.setattr(searcher_mod, "SPLIT_MIN_DOCS", 0)
    monkeypatch.setattr(codec_device, "plane_policy",
                        lambda mdp, own=0: (PLANES * mdp, max(mdp // 512, 4)))
    s = _searcher(committed)
    mix = traffic.load("manyword")
    rows = traffic.build_rows({**mix, "queries_per_pass": 512}, corpus, 2**33 + 7)
    METRICS.reset()
    got = []
    for lo in range(0, len(rows), 256):
        got += s.search_batch(traffic.to_queries(rows[lo:lo + 256], "body"), k=K)
    counters = METRICS.snapshot()["counters"]
    leaf = s.reader.leaves[0]
    eligible = int((_doc_freqs(corpus) >= max(leaf.device.max_doc_padded // 512, 4)).sum())
    assert leaf.device.tf_planes.shape[0] == PLANES < eligible
    assert 0 < counters["route.plane_rows"] < len(rows)
    assert counters["search.strategy.dense"] > 0 and counters["route.flat"] > 0
    kept = [check.Kept(i, DOCS, td.total_hits, np.array([sd.doc for sd in td.score_docs]),
                       np.array([sd.score for sd in td.score_docs])) for i, td in enumerate(got)]
    readings = check.judge(kept, lambda kr: scorer.answer(rows[kr.row], K), K)
    assert readings["count_err"] == 0, readings
    assert readings["score_err"] <= RTOL and readings["rank_gap"] <= RTOL, readings


def test_dense_counters_match_a_hand_count(committed, corpus, monkeypatch):
    """One batch of OR rows forced onto the dense branch: search.dense_lanes
    is 128 a work item, one item a (row, term, 128-doc block)."""
    monkeypatch.setenv("RUCENE_PLANES", "0")
    monkeypatch.setenv("RUCENE_STRATEGY", "dense")
    s = _searcher(committed)
    rng = np.random.default_rng(11)
    rows = [Row("or", (), tuple(int(t) for t in rng.choice(np.arange(10, 400), n, replace=False)),
                ()) for n in rng.integers(3, 11, size=48)]
    df = _doc_freqs(corpus)
    items = sum(math.ceil(df[t] / 128) for r in rows for t in r.should)
    s.search_batch(traffic.to_queries(rows, "body"), k=K)  # the device form's build
    METRICS.reset()
    s.search_batch(traffic.to_queries(rows, "body"), k=K)
    counters = METRICS.snapshot()["counters"]
    assert counters["search.strategy.dense"] == 1
    assert counters["search.dense_lanes"] == 128 * items

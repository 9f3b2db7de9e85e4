"""The port's pair-gallop route (AND2 / OR2 rows, executor.execute_flat_pair)
against rucene_tpu, on the CPU.

One Zipf corpus packed by rucene_tpu (one segment, two segments, one with
deletes) is carried across with packed_from_reference. Rows of two term
clauses, both SHOULD or both MUST, drawn from the vocabulary, plus the
same term twice, one absent term and two absent terms, are served by the
port on decoded leaves (RUCENE_DECODED=1), where every row takes the pair
route (``route.pair_rows``), and by the reference; complete hit lists
compare under tests/torch_hitcheck.py. Truncated lists (k = 5 and 100)
must be the bit-exact heads of the complete ones, and every list must
equal the port's flat route (RUCENE_PAIR=0) bit for bit: a sum of two
clause scores is exact in either order, and both routes score a clause
with the same operands.

Also: the MAXP overflow rerun on the flat executor
(``search.pair_overflow_rows``), a mixed batch split by row class, rows
over two fields (the probe's own denominators), execute_flat_pair held
directly against the generic executor's two branches, and build_pair_work
against the reference's tables up to their pads.
"""

import numpy as np
import pytest
import torch

from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.search import pair_path as ref_pair
from rucene_tpu.util.metrics import METRICS as REF_METRICS
from rucene_tpu_torch.search import executor, flat_tables, pair_path
from rucene_tpu_torch.search import searcher as searcher_mod
from rucene_tpu_torch.search.searcher import TopDocs
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import assert_batches_strict
from tests.torch_route_data import (
    layout,
    port_queries,
    port_searcher,
    ref_search,
    ref_segments,
    zipf_texts,
)

K_ALL = 4000  # above every row's hit count: complete lists


def _rows(words, seed=11, n=40):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        occ = "S" if i % 2 == 0 else "M"
        t1, t2 = (words[int(j)] for j in rng.integers(0, len(words), 2))
        rows.append([(occ, "body", t1), (occ, "body", t2)])
    for occ in "SM":  # edge shapes: the same term twice, absent terms
        rows.append([(occ, "body", "w1"), (occ, "body", "w1")])
        rows.append([(occ, "body", "w1"), (occ, "body", "zz_missing")])
        rows.append([(occ, "body", "zz_missing"), (occ, "body", "yy_missing")])
    return rows


@pytest.fixture(scope="module")
def corpus():
    return zipf_texts(3000, 60, seed=3)


@pytest.fixture(scope="module", params=["one", "two", "deletes"])
def index(request, corpus):
    texts, words = corpus
    leaves = layout(request.param, texts)
    rows = _rows(words)
    return leaves, rows, ref_search(leaves, rows, K_ALL)


def _serve(monkeypatch, leaves, rows, k, pair="1"):
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PAIR", pair)
    METRICS.reset()
    got = port_searcher(leaves).search_batch(port_queries(rows), k=k)
    return got, METRICS.snapshot()["counters"]


def test_pair_matches_reference(index, monkeypatch):
    leaves, rows, want = index
    got, counters = _serve(monkeypatch, leaves, rows, K_ALL)
    assert counters.get("route.pair_rows", 0) == len(rows) * len(leaves)  # a leaf call
    assert counters.get("route.flat", 0) == 0
    assert max(td.total_hits for td in want) < K_ALL
    assert_batches_strict(got, want)
    flat, flat_counters = _serve(monkeypatch, leaves, rows, K_ALL, pair="0")
    assert flat_counters.get("route.flat", 0) == len(rows)
    assert got == flat


@pytest.mark.parametrize("k", [5, 100])
def test_pair_truncated_lists(index, k, monkeypatch):
    """The OR merge (top-k of the probing extent, top-2k of the partial
    one, each doc once) at small k: the bit-exact head of the complete
    list, and equal to the flat route."""
    leaves, rows, _want = index
    full, _ = _serve(monkeypatch, leaves, rows, K_ALL)
    got, counters = _serve(monkeypatch, leaves, rows, k)
    assert counters.get("route.pair_rows", 0) == len(rows) * len(leaves)
    for g, f in zip(got, full):
        assert g.total_hits == f.total_hits
        assert g.score_docs == f.score_docs[:k]
    flat, _ = _serve(monkeypatch, leaves, rows, k, pair="0")
    assert got == flat


def _overflow_segment(n_segments=1):
    """A sparse owner whose wide blocks each overlap many narrow blocks of
    a locally dense probe term: its probe-slot count passes MAXP_CAP. With
    n_segments, each segment holds the whole pattern."""
    a_docs = set(range(0, 64 * 1024, 20))
    b_docs = set(range(30000, 32900))
    texts = []
    for i in range(64 * 1024):
        toks = ["filler"]
        if i in a_docs:
            toks.append("ta")
        if i in b_docs:
            toks.append("tb")
        texts.append(" ".join(toks))
    return ref_segments(texts * n_segments, n_segments)


@pytest.mark.parametrize("n_segments", [1, 2])
def test_pair_overflow_reruns_on_flat(n_segments, monkeypatch):
    """The overflow rows rerun on the flat executor, and the route
    counters count as the reference's do: pair rows a leaf call without
    the overflow rows, overflow rows a leaf."""
    leaves = [(p, None) for p in _overflow_segment(n_segments)]
    rows = [[(occ, "body", "ta"), (occ, "body", "tb")] for occ in "MS"]
    rows.append([("M", "body", "ta"), ("M", "body", "filler")])
    REF_METRICS.reset()
    # decoded as the port's leaves are (the reference serves small
    # segments packed unless told): its pair route needs decoded leaves
    want = ref_search(leaves, rows, 8000, env={"RUCENE_DECODED": "1"})
    ref_counters = REF_METRICS.snapshot()["counters"]
    got, counters = _serve(monkeypatch, leaves, rows, 8000)
    names = ("route.pair_rows", "route.plane_rows", "search.pair_overflow_rows")
    assert {n: counters.get(n, 0) for n in names} == {n: ref_counters.get(n, 0) for n in names}
    assert counters.get("search.pair_overflow_rows", 0) == 2 * n_segments
    assert counters.get("route.pair_rows", 0) == n_segments  # the AND row with "filler"
    assert_batches_strict(got, want)
    flat, _ = _serve(monkeypatch, leaves, rows, 8000, pair="0")
    assert got == flat
    head, _ = _serve(monkeypatch, leaves, rows, 20)
    assert head == [TopDocs(f.total_hits, f.score_docs[:20]) for f in got]


def test_pair_rows_split_from_a_mixed_batch(corpus, monkeypatch):
    """With the split forced on, a batch of single-term, pair and
    three-clause rows sends each class to its route, and every row
    matches the reference."""
    texts, words = corpus
    leaves = layout("one", texts)
    pair_rows = _rows(words, seed=12, n=12)
    rows = pair_rows + [[("T", "body", w)] for w in words[:6]]
    rows += [[("M", "body", "w2"), ("S", "body", "w3"), ("S", "body", "w5")],
             [("M", "body", "w0"), ("N", "body", "w1")]]
    want = ref_search(leaves, rows, K_ALL)
    monkeypatch.setattr(searcher_mod, "SPLIT_MIN_DOCS", 0)
    got, counters = _serve(monkeypatch, leaves, rows, K_ALL)
    assert_batches_strict(got, want)
    assert counters.get("route.pair_rows", 0) == len(pair_rows)
    assert counters.get("route.single", 0) == 6
    assert counters.get("route.flat", 0) == 2


def test_pair_rows_over_two_fields(corpus, monkeypatch):
    """A clause on each of two fields: the probe reads its own blocks'
    denominators (not the owner lane's)."""
    texts, words = corpus
    leaves = [(p, None) for p in ref_segments(texts, title=True)]
    rng = np.random.default_rng(13)
    rows = []
    for i in range(16):
        occ = "S" if i % 2 == 0 else "M"
        a, b = (words[int(j)] for j in rng.integers(0, 20, 2))
        rows.append([(occ, "body", a), (occ, "title", b)])
    want = ref_search(leaves, rows, K_ALL)
    got, counters = _serve(monkeypatch, leaves, rows, K_ALL)
    assert counters.get("route.pair_rows", 0) == len(rows)
    assert_batches_strict(got, want)
    flat, _ = _serve(monkeypatch, leaves, rows, K_ALL, pair="0")
    assert got == flat


def _tables(searcher, rows):
    plans = [searcher._plan_for(q) for q in port_queries(rows)]
    rqs = [p.rq for p in plans]
    doc_freqs, stats = searcher._gather_stats(rqs, plans)
    b = len(rqs)
    weight, occur, n_req, min_sh, _ma, _bo = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, 2, plans=plans
    )
    leaf = searcher.reader.leaves[0]
    bs, bc, fid = flat_tables.build_leaf_tables(leaf, rqs, b, 2, plans=plans)
    cache = flat_tables.build_leaf_cache(leaf, searcher.similarity, stats)
    return leaf, rqs, weight, occur, n_req, min_sh, bs, bc, fid, cache


@pytest.mark.parametrize("k", [5, 100])
@pytest.mark.parametrize("kind", ["one", "deletes"])
def test_execute_flat_pair_equals_generic(corpus, kind, k, monkeypatch):
    """execute_flat_pair against execute_flat_impl (candidate and dense
    branches) on the same rows: total_hits exact, scores and docs
    bit-equal."""
    texts, words = corpus
    monkeypatch.setenv("RUCENE_DECODED", "1")
    s = port_searcher(layout(kind, texts))
    rows = _rows(words, seed=14)
    leaf, rqs, weight, occur, n_req, min_sh, bs, bc, fid, cache = _tables(s, rows)
    dev = leaf.device
    work, ph, bad = pair_path.build_pair_work(leaf, rqs, weight, fid, bs, bc, len(rqs))
    assert bad == []
    q = flat_tables.make_flat_batch(work, n_req, min_sh, cache, dev)
    max_p, max_s = ph.pop("max_lanes_p") // 128, ph.pop("max_lanes_s") // 128
    pb = executor.PairBatch(**{n: torch.from_numpy(a) for n, a in ph.items()})
    got = executor.execute_flat_pair(
        dev, q, pb, k, max_p, max_s, with_live=leaf.live is not None, same_field=True
    )
    arrays = flat_tables.build_flat_work(bs, bc, weight, fid, occur)[:6]
    fq = flat_tables.make_flat_batch(arrays, n_req, min_sh, cache, dev)
    combine = flat_tables.build_combine_batch(
        arrays, len(rqs), leaf.packed.blk_first_doc, leaf.packed.blk_last_doc,
        dev.max_doc_padded, dev.device,
    )
    for cb in (None, combine):
        want = executor.execute_flat_impl(dev, fq, k, combine=cb)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)
    # the probe's own denominators give the same bits on one field
    again = executor.execute_flat_pair(
        dev, q, pb, k, max_p, max_s, with_live=leaf.live is not None, same_field=False
    )
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_build_pair_work_matches_reference(corpus, monkeypatch):
    """The port's owner work list and probe-slot tables equal the
    reference's once its pow2 pads are cut away."""
    texts, words = corpus
    monkeypatch.setenv("RUCENE_DECODED", "1")
    s = port_searcher(layout("one", texts))
    rows = _rows(words, seed=15)
    leaf, rqs, weight, _occ, _nr, _ms, bs, bc, fid, _c = _tables(s, rows)
    work, ph, bad = pair_path.build_pair_work(leaf, rqs, weight, fid, bs, bc, len(rqs))
    ref_leaf = RefSnapshot("s", layout("one", texts)[0][0])
    r_work, r_ph, r_bad = ref_pair.build_pair_work(ref_leaf, rqs, weight, fid, bs, bc, len(rqs))
    n = work[6]
    assert n == r_work[6] and bad == r_bad and len(work[0]) == max(n, 1)
    for a, r in zip(work[:6] + work[7:], r_work[:6] + r_work[7:]):
        np.testing.assert_array_equal(a[:n], r[:n])
    maxp = ph["pr_slots"].shape[1]
    assert maxp == max(1, int((ph["pr_slots"][:n] >= 0).sum(axis=1).max()))
    np.testing.assert_array_equal(ph["pr_slots"][:n], r_ph["pr_slots"][:n, :maxp])
    assert (r_ph["pr_slots"][:n, maxp:] == -1).all()
    for name in ("oi_mode", "oi_pw"):
        np.testing.assert_array_equal(ph[name][:n], r_ph[name][:n])
    for name in ("row_p_start", "row_p_items", "row_s_start", "row_s_items"):
        np.testing.assert_array_equal(ph[name], r_ph[name][: len(rqs)])
    assert ph["max_lanes_p"] == int(ph["row_p_items"].max()) * 128
    assert ph["max_lanes_s"] == int(ph["row_s_items"].max()) * 128

"""The port's dense tf-plane route (codec/device.add_tf_planes,
executor.execute_planes) against rucene_tpu, on the CPU.

One Zipf corpus packed by rucene_tpu (one segment, two segments, one with
deletes) is carried across with packed_from_reference and served by the
port on decoded leaves with every term planed (RUCENE_PLANES=1: the
corpus is far under the automatic gate's 2^19 docs), where every row
takes the plane route (``route.plane_rows``), and by the reference.
Rows cover the plain boolean algebra: SHOULD / MUST / FILTER / MUST_NOT
mixes, min_should_match, the same term twice and absent terms. Complete
hit lists compare under tests/torch_hitcheck.py; truncated lists (k = 3
and 64) must be the bit-exact heads of the complete ones. Against the
port's flat route (RUCENE_PLANES=0) every list matches under the same
check, and rows of at most two scoring clauses bit for bit.

Also: rows over two fields (a denominator row per clause, same_fid -1),
single-term rows on a leaf with deletes (the single route declines them,
so they take the planes), execute_planes held directly against the
generic executor, the planes and denominator planes against the
reference's, and plane_policy's gate and budget.
"""

import numpy as np
import pytest
import torch

import rucene_tpu_torch as T
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.search import flat_tables as ref_tables
from rucene_tpu_torch.codec import device as device_mod
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.search import executor, flat_tables, plane_path
from rucene_tpu_torch.search.query import Occur
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

K_ALL = 3000  # above every row's hit count: complete lists


def _rows(words, seed=21, n=40):
    """(rows, min_should_match per row) over the boolean algebra."""
    rng = np.random.default_rng(seed)

    def t():
        return ("body", words[int(rng.integers(0, len(words)))])

    shapes = ["SS", "MM", "MSS", "MN", "MF", "SSN", "FS", "MMMN"]
    rows = [[(o,) + t() for o in shapes[i % len(shapes)]] for i in range(n)]
    msm = [0] * n
    rows.append([("S",) + t() for _ in range(3)])  # explicit min_should_match
    msm.append(2)
    rows.append([("S",) + t() for _ in range(4)])
    msm.append(3)
    rows.append([("M", "body", "w1"), ("M", "body", "w1")])
    rows.append([("M", "body", "w1"), ("M", "body", "zz_miss")])
    rows.append([("S", "body", "w1"), ("S", "body", "zz_miss")])
    rows.append([("S", "body", "w2"), ("N", "body", "zz_miss")])
    msm += [0] * 4
    return rows, msm


def _scoring(row):
    return sum(o in "SM" for o, _f, _t in row)


@pytest.fixture(scope="module")
def corpus():
    return zipf_texts(2500, 50, seed=5, hi=9)


@pytest.fixture(scope="module", params=["one", "two", "deletes"])
def index(request, corpus):
    texts, words = corpus
    leaves = layout(request.param, texts)
    rows, msm = _rows(words)
    return leaves, rows, msm, ref_search(leaves, rows, K_ALL, msm)


def _serve(monkeypatch, leaves, rows, msm, k, planes="1"):
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PLANES", planes)
    METRICS.reset()
    got = port_searcher(leaves).search_batch(port_queries(rows, msm), k=k)
    return got, METRICS.snapshot()["counters"]


def _assert_route_agrees(got, flat, rows):
    assert_batches_strict(got, flat)
    for g, f, row in zip(got, flat, rows):
        if _scoring(row) <= 2:
            assert g == f


def test_planes_match_reference(index, monkeypatch):
    leaves, rows, msm, want = index
    got, counters = _serve(monkeypatch, leaves, rows, msm, K_ALL)
    assert counters.get("route.plane_rows", 0) == len(rows) * len(leaves)  # a leaf call
    assert counters.get("route.flat", 0) == 0
    assert max(td.total_hits for td in want) < K_ALL
    assert_batches_strict(got, want)
    flat, flat_counters = _serve(monkeypatch, leaves, rows, msm, K_ALL, planes="0")
    assert flat_counters.get("route.plane_rows", 0) == 0
    _assert_route_agrees(got, flat, rows)


@pytest.mark.parametrize("k", [3, 64])
def test_planes_truncated_lists(index, k, monkeypatch):
    leaves, rows, msm, _want = index
    full, _ = _serve(monkeypatch, leaves, rows, msm, K_ALL)
    got, counters = _serve(monkeypatch, leaves, rows, msm, k)
    assert counters.get("route.plane_rows", 0) == len(rows) * len(leaves)
    for g, f in zip(got, full):
        assert g.total_hits == f.total_hits
        assert g.score_docs == f.score_docs[:k]


def test_planes_two_fields(corpus, monkeypatch):
    texts, words = corpus
    leaves = [(p, None) for p in ref_segments(texts, title=True)]
    rng = np.random.default_rng(24)
    rows = []
    for i in range(12):
        a, b = (words[int(j)] for j in rng.integers(0, 30, 2))
        occ = "SM"[i % 2]
        rows.append([(occ, "body", a), (occ, "title", b)])
    rows.append([("M", "body", "w0"), ("S", "title", "w1"), ("N", "title", "w3")])
    want = ref_search(leaves, rows, K_ALL)
    got, counters = _serve(monkeypatch, leaves, rows, None, K_ALL)
    assert counters.get("route.plane_rows", 0) == len(rows)
    assert_batches_strict(got, want)
    flat, _ = _serve(monkeypatch, leaves, rows, None, K_ALL, planes="0")
    _assert_route_agrees(got, flat, rows)


def test_single_term_rows_take_planes_with_deletes(corpus, monkeypatch):
    """The single route needs leaves without deletes; on a leaf with
    deletes plain term rows take the planes (their total_hits counts live
    docs only)."""
    texts, words = corpus
    leaves = layout("deletes", texts)
    rows = [[("T", "body", w)] for w in words[:12] + ["zz_miss"]]
    want = ref_search(leaves, rows, K_ALL)
    got, counters = _serve(monkeypatch, leaves, rows, None, K_ALL)
    assert counters.get("route.plane_rows", 0) == len(rows)
    assert_batches_strict(got, want)
    no_deletes, counters = _serve(monkeypatch, layout("one", texts), rows, None, K_ALL)
    assert counters.get("route.single", 0) == len(rows)
    assert counters.get("route.plane_rows", 0) == 0


def _plane_tables(searcher, rows, msm):
    plans = [searcher._plan_for(q) for q in port_queries(rows, msm)]
    rqs = [p.rq for p in plans]
    doc_freqs, stats = searcher._gather_stats(rqs, plans)
    b = len(rqs)
    t = max(len(rq.all_slots()) for rq in rqs)
    weight, occur, n_req, min_sh, _ma, _bo = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, t, plans=plans
    )
    leaf = searcher.reader.leaves[0]
    cache = flat_tables.build_leaf_cache(leaf, searcher.similarity, stats)
    return leaf, rqs, plans, weight, occur, n_req, min_sh, cache


@pytest.mark.parametrize("k", [5, 100])
@pytest.mark.parametrize("kind", ["one", "deletes"])
def test_execute_planes_equals_generic(corpus, kind, k, monkeypatch):
    """execute_planes (through the searcher's tables, with and without the
    shared denominator row) against execute_flat_impl's two branches on
    the same two-clause rows: total_hits exact, scores and docs
    bit-equal."""
    texts, words = corpus
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PLANES", "1")
    s = port_searcher(layout(kind, texts))
    rows, msm = _rows(words, seed=25)
    keep = [i for i, r in enumerate(rows) if len(r) == 2]
    rows, msm = [rows[i] for i in keep], [msm[i] for i in keep]
    leaf, rqs, plans, weight, occur, n_req, min_sh, cache = _plane_tables(s, rows, msm)
    dev = leaf.device
    got = s._run_planes(leaf, rqs, weight, occur, cache, n_req, min_sh, k, plans)
    bs, bc, fid = flat_tables.build_leaf_tables(leaf, rqs, len(rqs), 2, plans=plans)
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
    # the per-clause denominator gather (same_fid -1) gives the same bits
    slot = np.stack([flat_tables.leaf_rows_for(leaf, rq, p)["pslot"] for rq, p in zip(rqs, plans)])
    kind_enc = np.where(occur == int(Occur.SHOULD), executor.ENC_SHOULD, executor.ENC_REQUIRED)
    kind_enc = np.where(occur == int(Occur.MUST_NOT), executor.ENC_NOT, kind_enc)
    kind_enc = np.where(occur == int(Occur.FILTER), executor.ENC_REQUIRED, kind_enc)
    pb = executor.PlaneBatch(
        slot=torch.from_numpy(slot), kindenc=torch.from_numpy(np.where(slot >= 0, kind_enc, 0).astype(np.int32)),
        weight=torch.from_numpy(weight), fid=torch.zeros(slot.shape, dtype=torch.int32),
        n_required=torch.from_numpy(n_req), min_should=torch.from_numpy(min_sh),
    )
    cvp = flat_tables.cval_plane_for(dev, cache)
    again = executor.execute_planes(dev.tf_planes, cvp, dev.live, pb, k, same_fid=-1)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_tf_planes_match_reference(corpus, monkeypatch):
    """The port's u8 planes equal the reference's row for row over the
    real docs (the reference pads its doc axis to a power of two and its
    row count to a power of two), with the same term -> row map; the
    denominator planes equal the reference's too."""
    texts, _words = corpus
    (packed,) = ref_segments(texts, title=True)
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PLANES", "1")
    monkeypatch.setenv("RUCENE_SEG_FLOORS", "0")
    ref = RefSnapshot("s", packed)
    port = port_searcher([(packed, None)]).reader.leaves[0]
    rdev, pdev = ref.device, port.device
    assert port.plane_slots == ref.plane_slots and port.plane_slots
    md = packed.max_doc
    p = len(port.plane_slots)
    assert pdev.tf_planes.shape == (p, pdev.max_doc_padded)
    np.testing.assert_array_equal(pdev.tf_planes[:, :md].numpy(), np.asarray(rdev.tf_planes)[:p, :md])
    assert not pdev.tf_planes[:, md:].any()
    s = port_searcher([(packed, None)])
    plans = [s._plan_for(q) for q in port_queries([[("S", "body", "w1"), ("S", "title", "w2")]])]
    _df, stats = s._gather_stats([pl.rq for pl in plans], plans)
    cache = flat_tables.build_leaf_cache(port, s.similarity, stats)
    want = np.asarray(ref_tables.cval_plane_for(rdev, cache))
    got = flat_tables.cval_plane_for(pdev, cache).numpy()
    np.testing.assert_array_equal(got[:, :md], want[:, :md])


def test_plane_policy(monkeypatch):
    """auto: planes from 2^19 docs, df_min = mdp // 512; the budget is the
    card's 80 GB less the segment, a 256-row batch's transients and the
    phrase plane cap, halved, at most 8 GB; 0 turns planes off; 1 planes
    every term; anything else raises."""
    monkeypatch.delenv("RUCENE_PLANES", raising=False)
    mdp = 1_000_448  # the bench corpus' doc axis at 1M docs
    assert device_mod.plane_policy(mdp) == (8 << 30, 1954)
    assert device_mod.plane_policy(1 << 18) == (0, 0)
    big = 8_800_256
    budget, df_min = device_mod.plane_policy(big, 3 << 30)
    transient = 256 * 20 * big
    assert budget == min(8 << 30, ((80 << 30) - (3 << 30) - transient - (16 << 30)) // 2)
    assert df_min == big // 512
    assert device_mod.plane_policy(mdp, 70 << 30) == (0, 1954)
    monkeypatch.setenv("RUCENE_PLANES", "0")
    assert device_mod.plane_policy(mdp) == (0, 0)
    monkeypatch.setenv("RUCENE_PLANES", "1")
    assert device_mod.plane_policy(4096) == (8 << 30, 1)
    monkeypatch.setenv("RUCENE_PLANES", "yes")
    with pytest.raises(ValueError):
        device_mod.plane_policy(mdp)


def test_planes_off_below_the_gate_and_on_packed_leaves(corpus, monkeypatch):
    """Under auto a small segment gets no planes, and a packed one none
    under RUCENE_PLANES=1: their rows keep the lane routes."""
    texts, _words = corpus
    (packed,) = ref_segments(texts)
    for decoded, planes in (("1", "auto"), ("0", "1")):
        monkeypatch.setenv("RUCENE_DECODED", decoded)
        monkeypatch.setenv("RUCENE_PLANES", planes)
        leaf = port_searcher([(packed, None)]).reader.leaves[0]
        assert leaf.device.tf_planes is None and leaf.plane_slots == {}


def test_plane_row_chunk():
    per = plane_path.PLANE_PEAK_BYTES_PER_ROW_DOC
    assert plane_path.plane_row_chunk(256, 1024) == 256
    rows = plane_path.PLANE_CHUNK_BYTES // (per * 1_000_448)
    assert plane_path.plane_row_chunk(256, 1_000_448) == min(256, rows)
    assert plane_path.plane_row_chunk(256, 8_842_240) == 16  # 8,841,823 docs
    assert plane_path.plane_row_chunk(256, 1 << 40) == 1


def test_plane_chunks_concatenate(corpus, monkeypatch):
    """Rows served in several execute_planes calls (a one-row chunk) equal
    one call's."""
    texts, words = corpus
    rows, msm = _rows(words, seed=26, n=12)
    leaves = layout("one", texts)
    one, _ = _serve(monkeypatch, leaves, rows, msm, 50)
    monkeypatch.setattr(plane_path, "PLANE_CHUNK_BYTES", 1)
    many, counters = _serve(monkeypatch, leaves, rows, msm, 50)
    assert counters.get("route.plane_rows", 0) == len(rows)
    assert many == one


def test_planes_port_reader_reset(corpus, monkeypatch):
    """Moving a reader to another device drops its planes' rows with its
    device form; they come back with the next build."""
    texts, _words = corpus
    (packed,) = ref_segments(texts)
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PLANES", "1")
    from rucene_tpu_torch.codec.postings import packed_from_reference

    reader = IndexReader([SegmentSnapshot("s", packed_from_reference(packed))])
    leaf = T.IndexSearcher(reader, device="cpu").reader.leaves[0]
    assert leaf.device.tf_planes is not None and leaf.plane_slots
    leaf.torch_device = torch.device("meta")  # as if it had lived elsewhere
    reader.to("cpu")
    assert leaf._device is None and leaf.plane_slots == {}
    assert leaf.device.tf_planes is not None and leaf.plane_slots

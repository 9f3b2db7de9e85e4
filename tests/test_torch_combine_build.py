"""flat_tables.build_combine_batch, which sorts the dense combine's entries on
the batch's device from host counts, against the tables the reference's
builder gives (ops/combine_tables.build_combine_tables at the port's
512-doc bucket, one entry a step, run once a 32-row chunk with its
per-bucket dummies and pow2 step padding dropped): every chunk's
bucket_ptr, e_item, e_row, e_enc, residue and residue_ptr equal, on
synthetic items, edge cases and a combined view's blocks. Then the
counters the build moves, and, on the card (``gpu``, skips here), the
build under torch's sync debug mode, its tables against the CPU build's,
and a manyword-shaped batch whose answers equal those from the old
tables bit for bit:

    python -m pytest --noconftest tests/test_torch_combine_build.py -m gpu -q
"""

import numpy as np
import pytest
import torch

import rucene_tpu_torch as T
from rucene_tpu_torch.drivers.workload import pack_corpus
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.ops.combine_tables import MAX_ROWS, SPARSE_SPAN, build_combine_tables
from rucene_tpu_torch.ops.cuda_combine import C_BUCKET
from rucene_tpu_torch.search import flat_tables
from rucene_tpu_torch.search import searcher as searcher_mod
from rucene_tpu_torch.search.executor import CombineBatch, FlatQueryBatch
from rucene_tpu_torch.util.metrics import METRICS
from torch_kernel_data import combine_arrays, synthetic_items


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def old_tables(arrays, b, bf, bl, md):
    """Each chunk's (bucket_ptr, e_item, e_row, e_enc, residue,
    residue_ptr) as numpy, built the way build_combine_batch built them on
    the host before it sorted on the device."""
    wi_block, wi_row, _w, _f, wi_enc, wi_valid = arrays
    bf = np.asarray(bf, np.int64)
    bl = np.asarray(bl, np.int64)
    out = []
    for lo in range(0, b, MAX_ROWS):
        in_chunk = (wi_row >= lo) & (wi_row < lo + MAX_ROWS)
        tbl = build_combine_tables(
            wi_block, wi_row - lo, wi_enc, wi_valid & in_chunk, len(wi_block), bf, bl, md,
            c_bucket=C_BUCKET, g_entries=1,
        )
        live = tbl.e_item >= 0
        ptr = np.searchsorted(tbl.g_bucket[live], np.arange(tbl.n_buckets + 1))
        residue, residue_ptr = flat_tables.residue_passes(
            tbl.residue_items, wi_row, wi_block, bf, bl
        )
        out.append((ptr, tbl.e_item[live], tbl.e_row[live], tbl.e_enc[live], residue, residue_ptr))
    return out


def old_batches(arrays, b, bf, bl, md, device):
    """old_tables as CombineBatches on ``device``, for the executor."""
    return tuple(
        CombineBatch(
            bucket_ptr=torch.from_numpy(ptr.astype(np.int32)).to(device),
            e_item=torch.from_numpy(e_item).to(device),
            e_row=torch.from_numpy(e_row).to(device),
            e_enc=torch.from_numpy(e_enc).to(device),
            residue=torch.from_numpy(residue.astype(np.int64)).to(device),
            row_lo=c * MAX_ROWS,
            residue_ptr=residue_ptr,
        )
        for c, (ptr, e_item, e_row, e_enc, residue, residue_ptr)
        in enumerate(old_tables(arrays, b, bf, bl, md))
    )


def work_batch(arrays, device="cpu"):
    """A FlatQueryBatch that carries ``arrays`` on ``device`` (the fields
    build_combine_batch reads; the others inert)."""
    wi_block, wi_row, wi_weight, wi_fid, wi_enc, wi_valid = (
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
    )
    one = torch.ones(1, dtype=torch.int32, device=device)
    return FlatQueryBatch(wi_block, wi_row, wi_weight, wi_fid, wi_enc, wi_valid, one, one,
                          torch.zeros((1, 256), device=device))


def assert_same_tables(got, want):
    assert len(got) == len(want)
    for c, (cb, (ptr, e_item, e_row, e_enc, residue, residue_ptr)) in enumerate(zip(got, want)):
        assert cb.row_lo == c * MAX_ROWS
        assert cb.bucket_ptr.dtype == torch.int32 and cb.e_item.dtype == torch.int32
        assert cb.e_row.dtype == torch.int32 and cb.e_enc.dtype == torch.int32
        assert cb.residue.dtype == torch.int64
        assert np.array_equal(cb.bucket_ptr.cpu().numpy(), ptr), f"chunk {c}: bucket_ptr"
        assert np.array_equal(cb.e_item.cpu().numpy(), e_item), f"chunk {c}: e_item"
        assert np.array_equal(cb.e_row.cpu().numpy(), e_row), f"chunk {c}: e_row"
        assert np.array_equal(cb.e_enc.cpu().numpy(), e_enc), f"chunk {c}: e_enc"
        assert np.array_equal(cb.residue.cpu().numpy(), residue), f"chunk {c}: residue"
        assert tuple(cb.residue_ptr) == tuple(residue_ptr), f"chunk {c}: residue_ptr"


def _synthetic(seed, b, w, md=8192):
    _docs, _sc, rows, encs, valid, bf, bl = synthetic_items(w=w, b=b, md=md, seed=seed)
    return combine_arrays(rows, encs, valid), b, bf, bl, md


def _empty_chunk():
    """Rows in chunks 0 and 2 of three: chunk 1 has no item."""
    arrays, _b, bf, bl, md = _synthetic(5, 32, 90)
    rows = arrays[1].copy()
    rows[len(rows) // 2:] += 2 * MAX_ROWS
    return (arrays[0], rows) + arrays[2:], 96, bf, bl, md


def _all_invalid():
    arrays, b, bf, bl, md = _synthetic(6, 40, 50)
    return arrays[:5] + (np.zeros(len(arrays[0]), bool),), b, bf, bl, md


def _span_edges():
    """Items spanning 1, SPARSE_SPAN - 1, SPARSE_SPAN and SPARSE_SPAN + 1
    buckets, some on a bucket's edge, a block whose first doc lies past its
    last (a list head's loose first doc), in two rows of each of two
    chunks, items of a row overlapping."""
    md = 64 * C_BUCKET
    spans = [(0, 1), (C_BUCKET - 1, 2), (3 * C_BUCKET, SPARSE_SPAN - 1),
             (5 * C_BUCKET, SPARSE_SPAN), (7 * C_BUCKET + 11, SPARSE_SPAN + 1),
             (C_BUCKET * 20, SPARSE_SPAN + 1), (C_BUCKET * 20 + 3, SPARSE_SPAN)]
    bf = np.array([f for f, _ in spans] + [9 * C_BUCKET], np.int64)
    bl = np.array([f - f % C_BUCKET + n * C_BUCKET - 1 for f, n in spans] + [9 * C_BUCKET - 5],
                  np.int64)
    n_blk = len(bf)
    blocks = np.tile(np.arange(n_blk, dtype=np.int32), 4)
    rows = np.repeat(np.array([0, 5, 33, 40], np.int32), n_blk)
    encs = np.tile(np.array([1, 256, 65536, 256], np.int32), 2 * n_blk)[: len(blocks)]
    w = len(blocks)
    arrays = (blocks, rows, np.ones(w, np.float32), np.zeros(w, np.int32), encs, np.ones(w, bool))
    return arrays, 41, bf, bl, md


def _nothing_matches(empty_blocks):
    """build_flat_work's one inert item when no clause has a block, over a
    segment with blocks or with none."""
    zeros = np.zeros((3, 2), np.int32)
    arrays = flat_tables.build_flat_work(zeros, zeros, np.zeros((3, 2), np.float32), zeros,
                                         zeros)[:6]
    assert len(arrays[0]) == 1 and not arrays[5].any()
    if empty_blocks:
        return arrays, 3, np.zeros(0, np.int64), np.zeros(0, np.int64), 4 * C_BUCKET
    return arrays, 3, np.array([0, 700], np.int64), np.array([600, 2000], np.int64), 4 * C_BUCKET


def _multi_leaf_searcher(n_leaves=3, n_docs=1500, vocab=30, seed=21, **kw):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    snaps = []
    for s in range(n_leaves):
        texts = [" ".join(f"w{t}" for t in rng.choice(vocab, int(rng.integers(3, 9)),
                                                          p=p / p.sum()))
                 for _ in range(n_docs + 400 * s)]
        snaps.append(SegmentSnapshot(f"s{s}", pack_corpus(texts)))
    return T.IndexSearcher(IndexReader(snaps), device="cpu", **kw), [f"w{i}" for i in range(vocab)]


def _combined_view():
    """A combined view's blocks (three leaves, view doc space) and its own
    bucket tables."""
    searcher, _words = _multi_leaf_searcher(combine_segments=True)
    view = searcher._combined_view()
    rng = np.random.default_rng(2)
    w, b = 700, 70
    blocks = rng.integers(0, view.n_blocks, w).astype(np.int32)
    arrays = (blocks, np.sort(rng.integers(0, b, w)).astype(np.int32), np.ones(w, np.float32),
              np.zeros(w, np.int32), rng.choice([1, 256, 65536], w).astype(np.int32),
              rng.random(w) < 0.95)
    return (arrays, b, view.blk_first_host, view.blk_last_host, view.device.max_doc_padded,
            view.device.buckets)


CASES = {
    "synthetic-0": lambda: _synthetic(0, 8, 40, md=4096),
    "synthetic-1": lambda: _synthetic(1, 32, 96),
    "synthetic-2": lambda: _synthetic(2, 64, 300, md=16384),
    "synthetic-3": lambda: _synthetic(3, 256, 900, md=32768),
    "rows-not-a-multiple-of-32": lambda: _synthetic(4, 40, 300),
    "chunk-without-items": _empty_chunk,
    "all-items-invalid": _all_invalid,
    "span-edges": _span_edges,
    "nothing-matches": lambda: _nothing_matches(False),
    "nothing-matches-no-blocks": lambda: _nothing_matches(True),
    "combined-view": _combined_view,
}


@pytest.mark.parametrize("lend_work", [False, True], ids=["uploads", "lent"])
@pytest.mark.parametrize("case", list(CASES))
def test_tables_equal_the_reference_builders(case, lend_work):
    """Every chunk's tables equal the reference builder's; with the work
    list uploaded here or lent by a FlatQueryBatch; the bucket tables a
    device form's own (the combined view) or built by the call."""
    arrays, b, bf, bl, md, *buckets = CASES[case]()
    q = work_batch(arrays) if lend_work else None
    got = flat_tables.build_combine_batch(arrays, b, bf, bl, md, "cpu", q=q,
                                          buckets=buckets[0] if buckets else None)
    want = old_tables(arrays, b, bf, bl, md)
    assert_same_tables(got, want)
    if case == "span-edges":  # both sides of SPARSE_SPAN were reached
        assert sum(len(r) for *_, r, _p in want) == 8
        assert all(len(p) > 2 for *_, p in want)  # overlapping residue items: two passes
    if case == "chunk-without-items":
        assert got[1].e_item.numel() == 0 and not got[1].bucket_ptr.any()
    if case == "combined-view":
        assert sum(len(t[1]) for t in want) > len(arrays[0])


def _manyword_rows(words, seed, n):
    """Manyword-shaped rows: 4/5 OR of 3-10 terms, 1/5 ``+a +b c d``."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        q = T.BooleanQuery()
        if i % 5 == 4:
            a, b_, c, d = rng.choice(words, 4, replace=False)
            q.must(T.TermQuery(T.Term("body", str(a))))
            q.must(T.TermQuery(T.Term("body", str(b_))))
            q.should(T.TermQuery(T.Term("body", str(c))))
            q.should(T.TermQuery(T.Term("body", str(d))))
        else:
            for t in rng.choice(words, int(rng.integers(3, 11)), replace=False):
                q.should(T.TermQuery(T.Term("body", str(t))))
        rows.append(q)
    return rows


def _dense_search(monkeypatch, searcher, rows, k, old):
    """search_batch on the flat executor's dense branch; with ``old`` the
    searcher's combine tables are the reference builder's."""
    monkeypatch.setenv("RUCENE_STRATEGY", "dense")
    monkeypatch.setenv("RUCENE_PAIR", "0")
    monkeypatch.setenv("RUCENE_PLANES", "0")
    if old:
        monkeypatch.setattr(
            searcher_mod, "build_combine_batch",
            lambda arrays, b, bf, bl, md, device, q=None, buckets=None:
                old_batches(arrays, b, bf, bl, md, device),
        )
    METRICS.reset()
    out = searcher.search_batch(rows, k)
    assert METRICS.snapshot()["counters"].get("search.strategy.dense", 0) >= 1
    return out


def _assert_same_topdocs(got, want):
    for r, (g, w_) in enumerate(zip(got, want)):
        assert g.total_hits == w_.total_hits, f"row {r}"
        assert [(sd.doc, sd.score) for sd in g.score_docs] == \
            [(sd.doc, sd.score) for sd in w_.score_docs], f"row {r}"


def test_counters_count_entries_and_residue(monkeypatch):
    """One dense _run_work adds its entries and residue items to
    search.combine_entries and search.combine_residue_items; a candidate
    call adds to neither."""
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PLANES", "0")
    searcher, _words = _multi_leaf_searcher(n_leaves=1, n_docs=30_000, vocab=400, seed=8)
    leaf = searcher.reader.leaves[0]
    dev = leaf.device
    rng = np.random.default_rng(9)
    w, b = 400, 40
    nb = leaf.packed.num_blocks
    arrays = (rng.integers(0, nb, w).astype(np.int32),
              np.sort(rng.integers(0, b, w)).astype(np.int32),
              rng.random(w).astype(np.float32), np.zeros(w, np.int32),
              np.full(w, 256, np.int32), np.ones(w, bool))
    bf, bl = leaf.packed.blk_first_doc, leaf.packed.blk_last_doc
    want = old_tables(arrays, b, bf, bl, dev.max_doc_padded)
    n_entries = sum(len(t[1]) for t in want)
    n_residue = sum(len(t[4]) for t in want)
    assert n_entries > 0 and n_residue > 0
    cache = flat_tables.build_leaf_cache(leaf, searcher.similarity, {})
    args = (dev, (bf, bl), arrays, cache, np.zeros(b, np.int32), np.ones(b, np.int32), 10, True)
    for strategy, entries, residue in (("dense", n_entries, n_residue), ("candidate", 0, 0)):
        METRICS.reset()
        searcher_mod.IndexSearcher._run_work(*args, strategy=strategy)
        counters = METRICS.snapshot()["counters"]
        assert counters.get("search.combine_entries", 0) == entries, strategy
        assert counters.get("search.combine_residue_items", 0) == residue, strategy


def _zipf_leaf_searcher(device, n_docs, vocab, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    lens = rng.integers(8, 40, n_docs)
    toks = rng.choice(vocab, int(lens.sum()), p=p / p.sum())
    texts = [" ".join(f"w{t}" for t in doc) for doc in np.split(toks, np.cumsum(lens)[:-1])]
    reader = IndexReader([SegmentSnapshot("s0", pack_corpus(texts))])
    return T.IndexSearcher(reader, device=device), [f"w{i}" for i in range(10, 400)]


@pytest.mark.parametrize("decoded", ["1", "0"])
def test_manyword_batch_answers_equal_the_old_tables(monkeypatch, decoded):
    """A manyword-shaped batch on the dense branch, residue included, gives
    the same top-k, scores and total_hits whichever builder made its
    tables."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    searcher, words = _zipf_leaf_searcher("cpu", 20_000, 2000, seed=31)
    rows = _manyword_rows(words, seed=32, n=40)
    want = _dense_search(monkeypatch, searcher, rows, 100, old=True)
    monkeypatch.undo()
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    METRICS.reset()
    got = _dense_search(monkeypatch, searcher, rows, 100, old=False)
    assert METRICS.snapshot()["counters"]["search.combine_residue_items"] > 0
    _assert_same_topdocs(got, want)


@pytest.mark.gpu
def test_build_on_card_makes_no_sync_and_equals_the_cpu_build(card):
    """On the card the build waits for nothing (torch's sync debug mode
    raises on any host synchronisation), lent the work list or uploading
    it, given the bucket tables a device form holds (built with it, in
    set-up), and its tables equal the CPU build's and the reference
    builder's."""
    arrays, b, bf, bl, md = _synthetic(7, 256, 20_000, md=1 << 18)
    from rucene_tpu_torch.codec.device import block_buckets

    q = work_batch(arrays, card)
    buckets = block_buckets(bf, bl, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lent = flat_tables.build_combine_batch(arrays, b, bf, bl, md, card, q=q, buckets=buckets)
        uploaded = flat_tables.build_combine_batch(arrays, b, bf, bl, md, card, buckets=buckets)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = old_tables(arrays, b, bf, bl, md)
    assert_same_tables(lent, want)
    assert_same_tables(uploaded, want)
    on_cpu = flat_tables.build_combine_batch(arrays, b, bf, bl, md, "cpu")
    for g, c in zip(lent, on_cpu):
        for x, y in zip(g, c):
            assert (x == y) if isinstance(x, (int, tuple)) else torch.equal(x.cpu(), y)


@pytest.mark.gpu
@pytest.mark.parametrize("decoded", ["1", "0"])
def test_manyword_batch_on_card_equals_the_old_tables(card, monkeypatch, decoded):
    """A manyword-shaped 256-row batch through IndexSearcher on the card:
    top-k, scores and total_hits bit-equal with the old tables."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    searcher, words = _zipf_leaf_searcher(card, 200_000, 2000, seed=41)
    rows = _manyword_rows(words, seed=42, n=256)
    want = _dense_search(monkeypatch, searcher, rows, 1000, old=True)
    monkeypatch.undo()
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    got = _dense_search(monkeypatch, searcher, rows, 1000, old=False)
    _assert_same_topdocs(got, want)

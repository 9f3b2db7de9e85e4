"""The port's single-term route and decode-dedup against rucene_tpu.

- flat_tables.dedupe_work equals the reference's distinct blocks, fids
  and inverse, up to the reference's pow2 padding; every item's fid equals
  its distinct block's (a block belongs to one field).
- executor.execute_flat_single on a packed segment (its lanes through the
  scoring decode's twin) and execute_flat_single_dec on a decoded one
  match the reference's execute_flat_single (use_pallas=False, its plain
  XLA decode) under tests/torch_hitcheck.py, on a random corpus and on a
  tie-heavy one (equal tf and equal length everywhere).
- The single route equals the generic flat executor bit for bit, in both
  of its branches.

The same packed index (packed_from_reference) and the same numpy work
tables feed both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rucene_tpu_torch as T
from rucene_tpu import Document, TextField
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.search import executor as ref_exec
from rucene_tpu.search import flat_tables as ref_tables
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.search import executor, flat_tables
from rucene_tpu_torch.search.searcher import TopDocs
from tests.conftest import WORDS, make_docs, random_corpus
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 1000  # above every term's doc_freq: complete lists


def _segment(kind):
    rng = np.random.default_rng(31)
    if kind == "random":
        texts = random_corpus(rng, 300)
    else:  # every doc holds 4 distinct words once: equal tf, equal norm byte
        texts = [" ".join(rng.choice(WORDS[:12], 4, replace=False)) for _ in range(400)]
    buf = SegmentBuffer()
    for d in make_docs(texts):
        buf.add_document(d)
    return pack_segment(buf.finish())


@pytest.fixture(scope="module", params=["random", "ties"])
def segment(request):
    return _segment(request.param)


def _tables(packed, decoded, monkeypatch):
    """The port's leaf (built packed or decoded) and the numpy tables of a
    batch of single-term rows, one per word (plus an absent one)."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    searcher = T.IndexSearcher(
        IndexReader([SegmentSnapshot("s", packed_from_reference(packed))]), device="cpu"
    )
    terms = WORDS + ["absent"]
    plans = [searcher._plan_for(T.TermQuery(T.Term("body", t))) for t in terms]
    rqs = [p.rq for p in plans]
    doc_freqs, stats = searcher._gather_stats(rqs, plans)
    b = len(rqs)
    weight, occur, n_req, min_sh, _ma, _bo = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, 1
    )
    leaf = searcher.reader.leaves[0]
    bs, bc, fid = flat_tables.build_leaf_tables(leaf, rqs, b, 1)
    work = flat_tables.build_flat_work(bs, bc, weight, fid, occur)
    n = work[6]
    rows = np.arange(b)
    starts = np.searchsorted(work[1][:n], rows)
    counts = np.searchsorted(work[1][:n], rows, side="right") - starts
    return dict(
        leaf=leaf, work=work, n_req=n_req, min_sh=min_sh, bs=bs[:, 0], bc=bc[:, 0],
        weight=weight[:, 0], starts=starts, counts=counts,
        hits=np.array([doc_freqs[("body", t)] for t in terms], np.int32),
        cache=flat_tables.build_leaf_cache(leaf, searcher.similarity, stats),
    )


def _t(a, dtype=np.int32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def _port_single(tb, k):
    dev = tb["leaf"].device
    max_items = max(int(tb["counts"].max()), 1)
    if dev.docs_dec is None:
        q = flat_tables.make_flat_batch(
            tb["work"], tb["n_req"], tb["min_sh"], tb["cache"], dev, dedupe=True
        )
        return executor.execute_flat_single(
            dev, q, _t(tb["starts"]), _t(tb["counts"]), _t(tb["hits"]), k, max_items
        )
    return executor.execute_flat_single_dec(
        dev, flat_tables.cval_table_for(dev, tb["cache"]), _t(tb["bs"]), _t(tb["bc"]),
        _t(tb["weight"], np.float32), _t(tb["hits"]), int(tb["bc"].sum()), k, max_items,
    )


def _topdocs(s, d, h):
    s, d, h = (np.asarray(x) for x in (s, d, h))
    out = []
    for i in range(len(h)):
        keep = s[i] > -np.inf
        out.append(TopDocs(int(h[i]), docs=d[i][keep].astype(np.int64), scores=s[i][keep]))
    return out


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_single_matches_reference(segment, decoded, monkeypatch):
    """Packed: execute_flat_single; decoded: execute_flat_single_dec; both
    against the reference's execute_flat_single on its own device form."""
    tb = _tables(segment, decoded, monkeypatch)
    assert (tb["leaf"].device.docs_dec is None) == (decoded == "0")
    monkeypatch.setenv("RUCENE_SEG_FLOORS", "0")
    ref_dev = RefSnapshot("s", segment).device
    assert (ref_dev.docs_dec is None) == (decoded == "0")
    fq = ref_tables.make_flat_batch(
        tb["work"], tb["n_req"], tb["min_sh"], tb["cache"], dedupe=True, dev=ref_dev
    )
    max_items = max(int(tb["counts"].max()), 1)
    want = ref_exec.execute_flat_single(
        ref_dev, fq, jnp.asarray(tb["starts"].astype(np.int32)),
        jnp.asarray(tb["counts"].astype(np.int32)), jnp.asarray(tb["hits"]),
        k=K_ALL, max_lanes=(1 << (max_items - 1).bit_length()) * 128, has_ef=True,
    )
    got = _port_single(tb, K_ALL)
    assert int(tb["hits"].max()) < K_ALL
    assert_batches_strict(_topdocs(*got), _topdocs(*want))


@pytest.mark.parametrize("k", [3, K_ALL])
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_single_equals_generic(segment, decoded, k, monkeypatch):
    """The single route's (scores, docs, total_hits) equal the generic
    executor's bit for bit, candidate and dense branches alike."""
    tb = _tables(segment, decoded, monkeypatch)
    leaf = tb["leaf"]
    dev = leaf.device
    got = _port_single(tb, k)
    arrays = tb["work"][:6]
    q = flat_tables.make_flat_batch(arrays, tb["n_req"], tb["min_sh"], tb["cache"], dev, dedupe=True)
    combine = flat_tables.build_combine_batch(
        arrays, len(tb["n_req"]), leaf.packed.blk_first_doc, leaf.packed.blk_last_doc,
        dev.max_doc_padded, dev.device,
    )
    for cb in (None, combine):
        want = executor.execute_flat_impl(dev, q, k, pure_disjunction=True, combine=cb)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)


def test_dedupe_work_matches_reference():
    rng = np.random.default_rng(4)
    w, n = 300, 260
    wi_block = np.zeros(w, np.int32)
    wi_block[:n] = rng.integers(0, 50, n)
    wi_fid = (wi_block % 3).astype(np.int32)
    wi_valid = np.arange(w) < n
    r_ub, r_uv, r_uf, r_inv = ref_tables.dedupe_work(wi_block, wi_valid, wi_fid)
    ub, uv, uf, inv = flat_tables.dedupe_work(wi_block, wi_valid, wi_fid)
    d = int(r_uv.sum())
    assert len(ub) == d and uv.all() and len(uv) == d  # exact, no pad
    np.testing.assert_array_equal(ub, r_ub[:d])
    np.testing.assert_array_equal(uf, r_uf[:d])
    np.testing.assert_array_equal(inv, r_inv)
    np.testing.assert_array_equal(ub[inv[:n]], wi_block[:n])
    # no repeated block, or no valid item: nothing to share
    assert flat_tables.dedupe_work(np.arange(8, dtype=np.int32), np.ones(8, bool), wi_fid[:8]) is None
    assert flat_tables.dedupe_work(wi_block, np.zeros(w, bool), wi_fid) is None


def test_dedupe_fid_is_every_items_fid(monkeypatch):
    """On a two-field index, rows over both fields: the distinct block's fid
    (first occurrence) is the fid of every item that shares the block, and
    packed serving equals decoded serving bit for bit."""
    rng = np.random.default_rng(8)
    buf = SegmentBuffer()
    for body in random_corpus(rng, 250):
        d = Document()
        d.add(TextField("body", body))
        d.add(TextField("title", " ".join(rng.choice(WORDS[:8], 3))))
        buf.add_document(d)
    packed = packed_from_reference(pack_segment(buf.finish()))
    q_rows = []
    for i in range(24):
        q = T.BooleanQuery()
        for f, t in (("body", WORDS[i % 10]), ("title", WORDS[(i * 3) % 8])):
            q.should(T.TermQuery(T.Term(f, t)))
        q_rows.append(q)
    monkeypatch.setenv("RUCENE_DECODED", "0")
    s = T.IndexSearcher(IndexReader([SegmentSnapshot("s", packed)]), device="cpu")
    plans = [s._plan_for(q) for q in q_rows]
    rqs = [p.rq for p in plans]
    doc_freqs, stats = s._gather_stats(rqs, plans)
    weight, occur, *_ = flat_tables.build_clause_tables(rqs, s.similarity, doc_freqs, stats, 24, 2)
    bs, bc, fid = flat_tables.build_leaf_tables(s.reader.leaves[0], rqs, 24, 2)
    assert len(set(fid.ravel().tolist())) == 2
    work = flat_tables.build_flat_work(bs, bc, weight, fid, occur)
    _ub, _uv, ufid, inv = flat_tables.dedupe_work(work[0], work[5], work[3])
    n = work[6]
    np.testing.assert_array_equal(ufid[inv[:n]], work[3][:n])
    packed_hits = s.search_batch(q_rows, k=K_ALL)
    monkeypatch.setenv("RUCENE_DECODED", "1")
    s2 = T.IndexSearcher(IndexReader([SegmentSnapshot("s", packed)]), device="cpu")
    assert s2.search_batch(q_rows, k=K_ALL) == packed_hits

"""Doc-range split views (rucene_tpu_torch/codec/split.py, a verbatim copy)
against rucene_tpu's on the CPU, after tests/test_split.py.

One segment packed by rucene_tpu and carried across with
packed_from_reference: both packages split it into the same arrays; a
split view's blocks, its straddling blocks re-packed past the original
words included, decode through the port's decode kernels' twins (K1 and
K2) as split._decode_block decodes them; the port's ShardedSearcher over
the split segment answers as the reference's ShardedSearcher and its
one-reader searcher do (tests/torch_hitcheck.py's strict rules over
complete hit lists, scores within RTOL 4e-7).
"""

import numpy as np
import pytest
import torch

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.codec.split import split_packed_segment as ref_split
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.parallel import sharded as ref_sharded
from rucene_tpu_torch.codec.device import build_device_segment
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.codec.split import _decode_block, split_packed_segment
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.ops import cuda_decode
from rucene_tpu_torch.parallel import sharded
from tests.torch_hitcheck import assert_batches_strict

K_ALL = 5000
ARRAYS = ("blk_off", "blk_doc_bits", "blk_freq_bits", "blk_base", "blk_count",
          "blk_max_freq", "blk_first_doc", "blk_last_doc", "blk_pos_base", "data")


def _corpus(n_docs=3000, vocab=120, seed=3):
    """Zipf-ish docs over w0..w{vocab}, every other one with ``dense``
    (Elias-Fano blocks), beside normal FOR blocks."""
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n_docs):
        words = [f"w{int(rng.zipf(1.3)) % vocab}" for _ in range(int(rng.integers(4, 16)))]
        if i % 2 == 0:
            words.append("dense")
        texts.append(" ".join(words))
    return texts


def _ref_packed(texts):
    buf = SegmentBuffer()
    for i, t in enumerate(texts):
        d = R.Document()
        d.add(R.TextField("body", t))
        d.add(R.IntPoint("num", i % 97))
        buf.add_document(d)
    return pack_segment(buf.finish())


@pytest.fixture(scope="module")
def segment():
    ref = _ref_packed(_corpus())
    return ref, packed_from_reference(ref)


@pytest.mark.parametrize("n_parts", [2, 3, 7])
def test_split_equals_reference(segment, n_parts):
    ref, port = segment
    want = ref_split(ref, n_parts)
    got = split_packed_segment(port, n_parts)
    assert len(got) == len(want) == n_parts
    for g, w in zip(got, want):
        assert g.max_doc == w.max_doc and g.is_split_view
        for name in ARRAYS:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        for f in ("doc_freq", "block_start", "block_count"):
            np.testing.assert_array_equal(
                getattr(g.fields["body"], f), getattr(w.fields["body"], f), err_msg=f
            )
        np.testing.assert_array_equal(g.norms["body"], w.norms["body"])
        np.testing.assert_array_equal(g.points["num"][1], w.points["num"][1])


@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("n_parts", [2, 7])
def test_split_blocks_decode_on_the_port(segment, n_parts, decoded):
    """Every block of every split view, the extension blocks past the
    original words included, through the decode twin (K1) or the scoring
    decode twin (K2): docs and freqs equal split._decode_block's."""
    _ref, port = segment
    for sp in split_packed_segment(port, n_parts):
        seg = build_device_segment(sp, "cpu")
        nb = sp.num_blocks
        tables = (seg.blk_off, seg.blk_doc_bits, seg.blk_freq_bits, seg.blk_base, seg.blk_count)
        if decoded:
            docs, freqs, _norms = cuda_decode.decode_blocks(seg.data, *tables)
        else:
            cache = torch.zeros((1, 256), dtype=torch.float32)
            docs, freqs, _cval = cuda_decode.decode_score_blocks(
                seg.data, *tables, seg.blk_fid, cache
            )
        beyond = np.flatnonzero(sp.blk_off >= len(_ref.data))  # re-packed partial blocks
        assert len(beyond) > 0
        for bi in range(nb):
            d, f = _decode_block(sp, bi)
            c = int(sp.blk_count[bi])
            np.testing.assert_array_equal(docs[bi, :c].numpy(), d)
            np.testing.assert_array_equal(freqs[bi, :c].numpy(), f)
            assert ((d >= 0) & (d < sp.max_doc)).all()


def test_split_view_occurrence_accessors_raise(segment):
    _ref, port = segment
    snap = SegmentSnapshot("s0", split_packed_segment(port, 2)[0])
    with pytest.raises(ValueError, match="split view"):
        snap.read_postings("body", "w1", with_positions=True)
    assert snap.read_postings("body", "w1") is not None  # docs and freqs stay


def _queries(P):
    tq = lambda t: P.TermQuery(P.Term("body", t))
    return [
        tq("w1"),
        tq("dense"),
        P.BooleanQuery().must(tq("w1")).must(tq("w2")),
        P.BooleanQuery().should(tq("w3")).should(tq("w9")),
        P.PointRangeQuery("num", 10, 40),
        P.PhraseQuery("body", ["w1", "w2"]),
        P.PhraseQuery("body", ["dense", "w1"], slop=2),
    ]


@pytest.mark.parametrize("deletes", [False, True])
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_sharded_split_hot(segment, monkeypatch, deletes, decoded):
    """A one-segment reader on a 4-shard mesh: split_hot spreads the
    segment over every shard, and the answers equal the reference's
    sharded and one-reader searchers'."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    ref, port = segment
    live = None
    if deletes:
        live = np.ones(ref.max_doc, bool)
        live[::5] = False
    ref_reader = RefReader([RefSnapshot("big", ref, live=live)])
    want = R.IndexSearcher(ref_reader).search_batch(_queries(R), k=K_ALL)
    want_sh = ref_sharded.ShardedSearcher(
        ref_sharded.ShardedIndex(ref_sharded.make_mesh(4, 2), ref_reader)
    ).search_batch(_queries(R), k=K_ALL)
    reader = IndexReader([SegmentSnapshot("big", port, live=live)])
    idx = sharded.ShardedIndex(sharded.make_mesh(4, 1, devices=["cpu"] * 4), reader)
    assert len(idx.leaves) == 4 and all(lf.packed.is_split_view for lf in idx.leaves)
    got = sharded.ShardedSearcher(idx).search_batch(_queries(T), k=K_ALL)
    assert_batches_strict(got, want)
    assert_batches_strict(got, want_sh)


def test_split_hot_opt_out(segment):
    _ref, port = segment
    reader = IndexReader([SegmentSnapshot("big", port)])
    mesh = sharded.make_mesh(4, 1, devices=["cpu"] * 4)
    assert len(sharded.ShardedIndex(mesh, reader, split_hot=False).leaves) == 1

"""The phrase path's block selection on the CPU: the port's batched
selection (search/phrase_path.select_phrase_blocks, behind the memo of
_phrase_blocks_for_rows) against rucene_tpu's _phrase_blocks_uncached
array for array, on packed (RUCENE_DECODED=0: K1's twin decodes the rare
blocks) and decoded leaves, whole and split by doc range, and the serving
path, which must not decode postings on the host.

The corpus is tests/test_torch_phrase_path.py's, with a term in every
third doc (``mid``: a rarest term of many blocks under the budget), three
leading docs of ``near`` and five trailing docs of ``far`` (a term whose
one block holds none of the rarest term's docs), and ``edge`` in the last
doc of ``mid``'s first block.
"""

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.split import split_packed_segment as ref_split
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.search.phrase_path import PhrasePathMixin as RefMixin
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.codec.split import split_packed_segment
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.util.metrics import METRICS
from tests.test_torch_phrase_path import CAND, K_ALL, _overflow_texts, _pack, _phrase_specs, _texts
from tests.torch_hitcheck import assert_batches_strict

BUDGET = 1200  # above mid's df (1,000), under every corpus word's (about 1,700)


def _select_texts():
    body = [t + " mid" if i % 3 == 0 else t for i, t in enumerate(_texts(n=3000))]
    body[3 * 127] += " edge"  # mid's 128th doc: the last of its first block
    return ["near"] * 3 + body + ["far"] * 5


ROWS = {
    "select": [
        ["mid", "fox"],  # a rarest term of 8 blocks
        ["near", "far"],  # far's block holds no near doc: nothing kept
        ["far", "the"],  # only the's last block kept
        ["mid", "mid"],  # a repeated term
        ["brown", "mid", "dog"],  # a trigram, its rarest term in the middle
        ["quick", "brown"],  # over the budget
        ["the", "mid", "the", "far"],
        ["edge", "mid"],  # edge's one doc is the last of mid's first block
    ],
    "overflow": [["hot", "spot"], ["spot", "cold"], ["hot", "cold"], ["hot", "spot", "cold"],
                 ["the", "fox"], ["dog", "the", "quick"]],
}
TEXTS = {"select": _select_texts, "overflow": _overflow_texts}


@pytest.fixture(scope="module", params=sorted(ROWS))
def corpus(request):
    return request.param, _pack(TEXTS[request.param]())


def _wants(leaf, rows):
    return [("body", terms, [leaf.term_record("body", t) for t in terms]) for terms in rows]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        for a, b in zip(g, w):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def _leaves(packed, view):
    """(port leaf, reference leaf): the whole segment, or the middle of
    its three doc-range split views (codec/split.py)."""
    port = packed_from_reference(packed)
    if view == "split":
        packed, port = ref_split(packed, 3)[1], split_packed_segment(port, 3)[1]
    return (IndexReader([SegmentSnapshot("s0", port)]).leaves[0],
            RefReader([RefSnapshot("s0", packed)]).leaves[0])


@pytest.mark.parametrize("view", ["whole", "split"])
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_selection_matches_reference(corpus, decoded, view, monkeypatch):
    """One call selects every miss; then a call of hits and misses mixed
    (and a row twice) selects only the new misses, and every row still
    equals the reference's selection."""
    name, packed = corpus
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    leaf, ref_leaf = _leaves(packed, view)
    # a split view keeps the records of terms with no doc in its range:
    # the reference's selection raises on one, the port's keeps nothing
    rows, empty = [], []
    for t in ROWS[name]:
        recs = [leaf.term_record("body", w) for w in t]
        if all(recs):
            (rows if min(r.doc_freq for r in recs) else empty).append(t)
    for blocks, slots in phrase_path.select_phrase_blocks(
        leaf, [w[2] for w in _wants(leaf, empty)], BUDGET
    ):
        assert len(blocks) == len(slots) == 0
    assert bool(empty) == (view == "split")
    want = [
        RefMixin._phrase_blocks_uncached(ref_leaf, f, t, recs, BUDGET)
        for f, t, recs in _wants(ref_leaf, rows)
    ]
    if (name, view) == ("select", "whole"):
        assert len(want[0][0]) > 8 and want[5] is None
        assert not (want[1][1] == 1).any() and (want[1][1] == 0).any()
        assert (want[7][1] == 1).sum() == 1
    assert len(rows) >= 3 and any(w is not None for w in want)
    phrase_path._BLOCKSEL_CACHE.clear()
    METRICS.reset()
    first = rows[::2]
    got = phrase_path.PhrasePathMixin._phrase_blocks_for_rows(leaf, _wants(leaf, first), BUDGET)
    _assert_same(got, want[::2])
    assert (leaf.device.docs_dec is None) == (decoded == "0")
    snap = METRICS.snapshot()["counters"]
    assert snap.get("search.phrase_select_device", 0) == sum(w is not None for w in want[::2])
    assert snap.get("search.phrase_select_waits", 0) == any(w is not None for w in want[::2])

    METRICS.reset()
    again = rows + [rows[1]]
    got = phrase_path.PhrasePathMixin._phrase_blocks_for_rows(leaf, _wants(leaf, again), BUDGET)
    _assert_same(got, want + [want[1]])
    snap = METRICS.snapshot()["counters"]
    assert snap.get("search.phrase_select_device", 0) == sum(w is not None for w in want[1::2])
    assert snap.get("search.phrase_select_waits", 0) == any(w is not None for w in want[1::2])


def test_all_over_budget_selects_nothing(corpus):
    name, packed = corpus
    leaf = IndexReader([SegmentSnapshot("s0", packed_from_reference(packed))]).leaves[0]
    METRICS.reset()
    got = phrase_path.select_phrase_blocks(leaf, [w[2] for w in _wants(leaf, ROWS[name])], 0)
    assert got == [None] * len(ROWS[name])
    assert "search.phrase_select_waits" not in METRICS.snapshot()["counters"]


@pytest.mark.parametrize("decoded", ["0", "1"])
def test_serving_path_decodes_no_postings_on_host(decoded, monkeypatch):
    """A pure phrase batch over two leaves on the candidate route: hits
    equal the reference's with the host postings decode made to raise,
    one selected phrase a leaf for each distinct phrase whose terms the
    leaf holds, and one wait a leaf."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    texts = _texts()
    packs = [_pack(texts[:300]), _pack(texts[300:])]
    specs = _phrase_specs(texts, 1)
    ref = R.IndexSearcher(RefReader([RefSnapshot(f"s{i}", p) for i, p in enumerate(packs)]))
    for k, v in CAND.items():
        setattr(ref, k, v)
    want = ref.search_batch([R.PhraseQuery("body", list(t), slop=s) for t, s in specs], k=K_ALL)

    def refuse(*_a, **_k):
        raise AssertionError("read_postings on the phrase serving path")

    monkeypatch.setattr(SegmentSnapshot, "read_postings", refuse)
    reader = IndexReader([SegmentSnapshot(f"s{i}", packed_from_reference(p))
                          for i, p in enumerate(packs)])
    searcher = T.IndexSearcher(reader, device="cpu")
    for k, v in CAND.items():
        setattr(searcher, k, v)
    phrase_path._BLOCKSEL_CACHE.clear()
    METRICS.reset()
    got = searcher.search_batch([T.PhraseQuery("body", list(t), slop=s) for t, s in specs],
                                k=K_ALL)
    assert_batches_strict(got, want)
    misses = sum(
        len({tuple(t) for t, _s in specs
             if all(leaf.term_record("body", w) is not None for w in t)})
        for leaf in reader.leaves
    )
    snap = METRICS.snapshot()["counters"]
    assert snap["search.phrase_device"] > 0
    assert snap["search.phrase_select_device"] == misses
    assert snap["search.phrase_select_waits"] == len(reader.leaves)

"""The batched position-plane build on the CPU
(search/phrase_path._phrase_planes_for_many, ops/phrase_plane.
build_position_planes) against build_position_plane a term, bit for bit.

- A want list with repeated terms, cache hits, an absent term and terms
  admission denies builds its misses in one call and caches each plane
  under its own storage, on packed (K1's twin) and decoded leaves at 2 and
  4 words a doc; "hot" (a doc past FMAX occurrences) and "tail" (a
  position past the plane) set both overflow causes.
- Misses past a quarter of the plane budget build in chunks of it.
- A numpy model of csrc/phrase_plane.cu's per-item algorithm, run over
  plane_work_items' table and one work_lanes call, equals the twin: the
  kernel itself runs only on a card (tests/test_torch_phrase_plane_card.py).
"""

import numpy as np
import pytest
import torch

import rucene_tpu_torch as T
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.ops import phrase_plane
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_phrase_data import packed_segment, phrase_texts

_PACKED = {}
MISSES = ["hot", "tail", "the", "spot", "quick", "brown"]


def _port_packed():
    if "p" not in _PACKED:
        from rucene_tpu_torch.codec.postings import packed_from_reference

        _PACKED["p"] = packed_from_reference(packed_segment(phrase_texts()))
    return _PACKED["p"]


@pytest.fixture
def searcher(monkeypatch, request):
    decoded, words = request.param
    monkeypatch.setenv("RUCENE_DECODED", "1" if decoded else "0")
    s = T.IndexSearcher(IndexReader([SegmentSnapshot("s0", _port_packed())]), device="cpu")
    leaf = s.reader.leaves[0]
    assert (leaf.device.docs_dec is not None) == decoded
    monkeypatch.setattr(s, "_plane_words", lambda _leaf, _field: words)
    phrase_path._PLANE_CACHE.clear()
    METRICS.reset()
    yield s, leaf, words
    phrase_path._PLANE_CACHE.clear()


def _single(leaf, term, words):
    """build_position_plane of one term, as the per-term path built it."""
    rec = leaf.term_record("body", term)
    blocks = np.arange(rec.block_start, rec.block_start + rec.block_count)
    return phrase_plane.build_position_plane(
        leaf.device, torch.from_numpy(blocks), rec.pos_width, rec.pos_word_start,
        words=words, fwin=phrase_plane.FMAX,
    )


def _equal(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _counter(name):
    return METRICS.snapshot()["counters"].get(name, 0)


CASES = [(d, w) for d in (False, True) for w in (2, 4)]
IDS = [f"{'decoded' if d else 'packed'}-{w}w" for d, w in CASES]


@pytest.mark.parametrize("searcher", CASES, ids=IDS, indirect=True)
def test_batched_fetch_equals_per_term(searcher, monkeypatch):
    s, leaf, words = searcher
    monkeypatch.setattr(s, "PLANE_ADMIT_MIN_DOCS", 0)  # admission on at this size
    resident = ("hot", "tail", "the", "quick", "brown")
    monkeypatch.setattr(s, "_plane_resident_terms",
                        lambda _leaf, _field: (resident, frozenset(resident)))
    hit = s._phrase_plane_for(leaf, "body", "quick")  # a hit in the call below
    assert _counter("search.phrase_plane_build_calls") == 1
    METRICS.reset()
    wants = [("body", t) for t in ("hot", "quick", "tail", "nosuchterm", "hot", "spot", "the",
                                   "tail", "brown", "fox")]
    got = s._phrase_planes_for_many(leaf, wants, admit=True)
    assert got[("body", "quick")] is hit
    assert got[("body", "nosuchterm")] is None
    assert got[("body", "spot")] is False and got[("body", "fox")] is False  # not resident
    built = ("hot", "tail", "the", "brown")
    assert _counter("search.phrase_plane_build") == len(built)
    assert _counter("search.phrase_plane_build_calls") == 1
    assert _counter("search.phrase_plane_denied") == 2
    singles = {t: _single(leaf, t, words) for t in built + ("quick",)}
    for t, want in singles.items():
        assert _equal(got[("body", t)], want), t
    assert got[("body", "hot")][1].any() and got[("body", "tail")][1].any()  # both overflow causes
    cached = [v for _a, _k, v in phrase_path._PLANE_CACHE.items()]
    assert len(cached) == len(singles)
    ptrs = [t.untyped_storage().data_ptr() for p, o in cached for t in (p, o)]
    assert len(set(ptrs)) == len(ptrs)  # each plane and column owns its storage
    assert phrase_path._PLANE_CACHE.nbytes == sum(p.nbytes + o.nbytes for p, o in singles.values())


@pytest.mark.parametrize("searcher", [(True, 2), (False, 4)], ids=["decoded-2w", "packed-4w"],
                         indirect=True)
def test_misses_past_a_quarter_budget_build_in_chunks(searcher, monkeypatch):
    s, leaf, words = searcher
    plane_bytes = leaf.device.max_doc_padded * (words * 4 + 1)
    # a quarter of the budget holds two planes; the whole budget all six
    monkeypatch.setattr(s, "_plane_budget_bytes", lambda _leaf: 8 * plane_bytes + 7)
    got = s._phrase_planes_for_many(leaf, [("body", t) for t in MISSES])
    assert _counter("search.phrase_plane_build") == len(MISSES)
    assert _counter("search.phrase_plane_build_calls") == 3
    assert len(phrase_path._PLANE_CACHE) == len(MISSES)
    for t in MISSES:
        assert _equal(got[("body", t)], _single(leaf, t, words)), t
    METRICS.reset()
    again = s._phrase_planes_for_many(leaf, [("body", t) for t in MISSES])
    assert all(again[k] is got[k] for k in got) and _counter("search.phrase_plane_build") == 0


def _kernel_model(dev, terms, words):
    """csrc/phrase_plane.cu's algorithm in numpy, item by item and lane by
    lane, over plane_work_items' table and one work_lanes call."""
    items = phrase_plane.plane_work_items(terms)
    md = dev.max_doc_padded
    planes = [np.zeros((md, words), np.uint64) for _ in terms]
    overflows = [np.zeros(md, bool) for _ in terms]
    blk = torch.from_numpy(items[0])
    docs, freqs, _valid = phrase_plane.work_lanes(dev, blk, dev.blk_count[blk])
    docs, freqs = docs.numpy(), freqs.numpy()
    pos_base = dev.blk_pos_base[blk].numpy()
    positions = dev.positions.numpy().view(np.uint32)
    last = len(positions) - 1
    for i in range(items.shape[1]):
        t, width, start = (int(x) for x in items[1:, i])
        occ = np.cumsum(freqs[i]) - freqs[i]  # the block-wide exclusive scan
        for lane in np.flatnonzero(freqs[i] > 0):
            f, doc = int(freqs[i, lane]), int(docs[i, lane])
            over, pos = f > phrase_plane.FMAX, 0
            bitpos = (int(pos_base[i]) + int(occ[lane])) * width
            for _j in range(min(f, phrase_plane.FMAX)):
                w0 = min(max(start + (bitpos >> 5), 0), last)
                w1 = min(max(start + (bitpos >> 5) + 1, 0), last)
                pair = (int(positions[w1]) << 32) | int(positions[w0])
                pos += (pair >> (bitpos & 31)) & ((1 << width) - 1)
                bitpos += width
                if pos >= 32 * words:
                    over = True
                    break
                planes[t][doc, pos >> 5] += 1 << (pos & 31)  # the atomicAdd
            overflows[t][doc] |= over
    return [((p & 0xFFFFFFFF).astype(np.uint32).view(np.int32), o)
            for p, o in zip(planes, overflows)]


@pytest.mark.parametrize("searcher", CASES, ids=IDS, indirect=True)
def test_kernel_model_equals_twin(searcher):
    _s, leaf, words = searcher
    terms = []
    for t in MISSES:
        rec = leaf.term_record("body", t)
        terms.append((np.arange(rec.block_start, rec.block_start + rec.block_count),
                      rec.pos_width, rec.pos_word_start, phrase_plane.FMAX))
    model = _kernel_model(leaf.device, terms, words)
    twin = phrase_plane.build_position_planes(leaf.device, terms, words)
    assert len(twin) == len(terms)
    for t, (mp, mo), (tp, to) in zip(MISSES, model, twin):
        assert np.array_equal(mp, tp.numpy()) and np.array_equal(mo, to.numpy()), t
    assert any(o.any() for _p, o in model)

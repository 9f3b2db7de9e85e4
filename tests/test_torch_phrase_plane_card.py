"""The batched position-plane build on the card (``gpu``, skips here):
ops/phrase_plane.build_position_planes (csrc/phrase_plane.cu) against its
twin, build_position_plane a term run on the same card, bit for bit,
planes and overflow columns, on decoded and packed (K1) leaves at 2 and 4
words a doc; each call one kernel launch:

    python -m pytest --noconftest tests/test_torch_phrase_plane_card.py -m gpu -q

Two segments: the CPU tests' shape (700 docs, "hot" 70 times in a doc,
"tail" past position 128) and about 1M random docs whose terms under 64
blocks are built 40 at a time, as a serving call builds its misses; there
the searcher's own fetch (_phrase_planes_for_many) is held to one build
call and one launch too. tests/test_torch_phrase_plane_batch.py holds the
CPU path.
"""

import numpy as np
import pytest
import torch

from rucene_tpu_torch.drivers.workload import build_corpus, pack_corpus
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.ops import phrase_plane
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.search.searcher import IndexSearcher
from rucene_tpu_torch.util.metrics import METRICS

SMALL_TERMS = ["hot", "tail", "the", "spot", "quick", "end"]
BIG_DOCS = 1_000_000


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def small(card):
    texts = build_corpus(700, seed=3)[0]
    texts[10] = "hot " * 70 + "spot"
    texts[20] = "the " * 130 + "tail end quick"
    texts[40] = "hot spot tail end"
    return pack_corpus(texts)


@pytest.fixture(scope="module")
def big(card):
    """About 1M docs of 4-16 words from 50,000 (Zipf 1.0); one doc in
    50,000 repeats a mid-band word 70 times and runs past 64 positions."""
    rng = np.random.default_rng(11)
    vocab = np.array([f"w{i}" for i in range(50_000)])
    p = 1.0 / np.arange(1, len(vocab) + 1)
    lens = rng.integers(4, 17, BIG_DOCS)
    toks = rng.choice(len(vocab), size=int(lens.sum()), p=p / p.sum())
    ends = np.cumsum(lens)
    texts = [" ".join(vocab[toks[e - n : e]]) for e, n in zip(ends, lens)]
    for j, i in enumerate(range(0, BIG_DOCS, 50_000)):
        texts[i] = f"w{300 + j} " * 70 + texts[i]
    return pack_corpus(texts)


def _terms(leaf, names):
    return [phrase_path.plane_term(leaf, leaf.term_record("body", t)) for t in names]


def _launches():
    return METRICS.snapshot()["counters"].get(phrase_plane.LAUNCH_COUNTER, 0)


def _held_to_twin(leaf, names, words):
    """One build_position_planes call of ``names`` equals the twin a term
    on the card, in one launch; returns the planes' overflow count."""
    terms = _terms(leaf, names)
    before = _launches()
    got = phrase_plane.build_position_planes(leaf.device, terms, words)
    assert _launches() - before == 1
    n_over = 0
    for name, (blocks, width, start, fwin), (plane, overflow) in zip(names, terms, got):
        want = phrase_plane.build_position_plane(
            leaf.device, torch.from_numpy(blocks).to(leaf.torch_device), width, start,
            words=words, fwin=fwin,
        )
        torch.cuda.synchronize()
        assert plane.shape == want[0].shape and overflow.shape == want[1].shape, name
        assert torch.equal(plane, want[0]) and torch.equal(overflow, want[1]), name
        n_over += int(overflow.sum())
    return n_over


@pytest.mark.gpu
@pytest.mark.parametrize("words", [2, 4])
@pytest.mark.parametrize("decoded", ["1", "0"])
def test_kernel_equals_twin_on_the_small_segment(card, small, decoded, words, monkeypatch):
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    leaf = IndexReader([SegmentSnapshot("s0", small)]).to(card).leaves[0]
    assert (leaf.device.docs_dec is None) == (decoded == "0")
    assert _held_to_twin(leaf, SMALL_TERMS, words) > 0  # "hot" and "tail" overflow


@pytest.mark.gpu
@pytest.mark.parametrize("decoded", ["1", "0"])
def test_kernel_equals_twin_at_a_million_docs(card, big, decoded, monkeypatch):
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    s = IndexSearcher(IndexReader([SegmentSnapshot("s0", big)]), device=card)
    leaf = s.reader.leaves[0]
    pf = big.fields["body"]
    bc = np.asarray(pf.block_count)
    folds = [pf.term_ord["w300"], pf.term_ord["w301"]]  # the 70-fold words
    under = np.setdiff1d(np.flatnonzero((bc >= 1) & (bc < 64)), folds)
    picks = np.r_[folds, np.random.default_rng(5).choice(under, size=38, replace=False)]
    names = [pf.terms[int(o)] for o in picks]
    assert bc[picks].max() < 64 and bc[picks].sum() > 40
    for words in (2, 4):
        assert _held_to_twin(leaf, names, words) > 0

    phrase_path._PLANE_CACHE.clear()
    METRICS.reset()
    got = s._phrase_planes_for_many(leaf, [("body", t) for t in names])
    counters = METRICS.snapshot()["counters"]
    assert counters["search.phrase_plane_build"] == len(names)
    assert counters["search.phrase_plane_build_calls"] == 1
    assert counters[phrase_plane.LAUNCH_COUNTER] == 1
    words = s._plane_words(leaf, "body")
    for name, (blocks, width, start, fwin) in zip(names, _terms(leaf, names)):
        want = phrase_plane.build_position_plane(
            leaf.device, torch.from_numpy(blocks).to(card), width, start, words=words, fwin=fwin,
        )
        assert torch.equal(got[("body", name)][0], want[0])
        assert torch.equal(got[("body", name)][1], want[1])
    phrase_path._PLANE_CACHE.clear()

"""The phrase path's block selection on the card (``gpu``, skips here):
select_phrase_blocks on a decoded and a packed (K1) leaf on the card
equals the same call on a CPU leaf of the segment, with one wait a call,
and a call made while the default stream is busy returns without waiting
for it (its work runs on a stream of its own):

    python -m pytest --noconftest tests/test_torch_phrase_select_card.py -m gpu -q

tests/test_torch_phrase_select.py holds the CPU selection against the
reference package's.
"""

import time

import pytest
import torch

from rucene_tpu_torch.drivers.workload import build_corpus, pack_corpus, sample_bigrams
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.util.metrics import METRICS

BUDGET = 4000  # some bigrams' rarest term is over it


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def corpus():
    texts, _vocab, _probs = build_corpus(40_000, seed=3)
    rows = [list(b) for b in sample_bigrams(texts, 96, seed=5)]
    rows += [a + b[1:] for a, b in zip(rows[:16], rows[16:32])]  # trigrams
    return pack_corpus(texts), rows


def _select(leaf, rows):
    recs = [[leaf.term_record("body", t) for t in row] for row in rows]
    return phrase_path.select_phrase_blocks(leaf, recs, BUDGET)


@pytest.mark.gpu
@pytest.mark.parametrize("decoded", ["1", "0"])
def test_card_selection_equals_cpu_and_leaves_the_default_stream(card, corpus, decoded,
                                                                 monkeypatch):
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    seg, rows = corpus
    want = _select(IndexReader([SegmentSnapshot("s0", seg)]).leaves[0], rows)
    assert any(w is None for w in want) and sum(w is not None for w in want) > 64
    leaf = IndexReader([SegmentSnapshot("s0", seg)]).to(card).leaves[0]
    METRICS.reset()
    got = _select(leaf, rows)
    assert (leaf.device.docs_dec is None) == (decoded == "0")
    snap = METRICS.snapshot()["counters"]
    assert snap["search.phrase_select_waits"] == 1
    assert snap["search.phrase_select_device"] == sum(w is not None for w in want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert all((a == b).all() and a.dtype == b.dtype for a, b in zip(g, w))

    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000_000)  # about two seconds on the default stream
    t0 = time.perf_counter()
    again = _select(leaf, rows)
    took = time.perf_counter() - t0
    busy = not torch.cuda.current_stream(card).query()
    torch.cuda.synchronize()
    assert busy and took < 0.5, (busy, took)
    assert all((g is None) == (a is None) for g, a in zip(got, again))

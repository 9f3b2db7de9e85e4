"""Strict hit-list comparison for the PyTorch port against rucene_tpu.

Unlike tests/hitcheck.py there is no slack at the k-th boundary: total_hits
equal and the same docs. Scores agree within RTOL: f32 division may round
differently between frameworks, and sums of three or more clause scores
follow each executor's own association order, a few ULPs apart. Each list
must itself be in (score desc, doc asc) order, so bit-equal ties ascend by
doc; two hits may trade places between the lists only where their scores
are within RTOL of each other (a summation-order difference).
Imports numpy only, so the GPU smoke can use it without jax.
"""

from __future__ import annotations

import numpy as np

RTOL = 4e-7


def _pairs(td):
    sd = td.score_docs
    return [int(d) for d, _ in sd], np.asarray([s for _, s in sd], np.float32)


def _assert_ordered(docs, s, side):
    for i in range(len(docs) - 1):
        assert s[i] >= s[i + 1], f"{side}: scores not descending at {i}"
        if s[i] == s[i + 1]:
            assert docs[i] < docs[i + 1], f"{side}: bit-equal tie not doc-ascending at {i}"


def assert_topdocs_strict(got, want, rtol: float = RTOL) -> None:
    assert got.total_hits == want.total_hits, (
        f"total_hits {got.total_hits} != {want.total_hits}"
    )
    g_docs, g_s = _pairs(got)
    w_docs, w_s = _pairs(want)
    assert sorted(g_docs) == sorted(w_docs), f"doc sets differ:\n got {g_docs}\nwant {w_docs}"
    _assert_ordered(g_docs, g_s, "got")
    _assert_ordered(w_docs, w_s, "want")
    w_score = dict(zip(w_docs, w_s))
    for d, s in zip(g_docs, g_s):
        assert abs(s - w_score[d]) <= rtol * max(1.0, abs(w_score[d])), (d, s, w_score[d])
    for i, (gd, wd) in enumerate(zip(g_docs, w_docs)):
        if gd != wd:
            a, b = w_score[gd], w_score[wd]
            assert abs(a - b) <= rtol * max(1.0, abs(b)), (
                f"position {i}: doc {gd} ({a}) vs {wd} ({b}) beyond the tie tolerance"
            )


class _Hits:
    def __init__(self, total_hits, score_docs):
        self.total_hits = total_hits
        self.score_docs = score_docs


def assert_pruned_strict(got, want, rtol: float = RTOL) -> None:
    """A pruned answer (WAND, search_batch(prune=True)) against the
    exhaustive one: got.total_hits at most want's, a pruned row's count
    being a lower bound, and the hits equal under assert_topdocs_strict."""
    assert got.total_hits <= want.total_hits, (
        f"pruned total_hits {got.total_hits} > exhaustive {want.total_hits}"
    )
    assert_topdocs_strict(_Hits(want.total_hits, got.score_docs), want, rtol)


def assert_truncated_within_rtol(got, want_wide, k: int, rtol: float = RTOL) -> None:
    """A truncated top-k of a row whose scores sum three or more clause
    scores in an unspecified order (the combine kernel's and index_add_'s
    atomic adds on the card), against the same row's exhaustive answer at
    a wider k. A doc's score may then differ by a few ULPs between two
    runs, so docs within rtol of the k-th score may trade places across
    the boundary: that is the sum's order, not the engine's choice. Held:
    got in (score desc, doc asc) order with min(k, hits) entries; its
    total_hits at most want_wide's; each of its docs in want_wide with a
    score within rtol (or, past want_wide's end, a score within rtol of
    its last); and every doc of want_wide scoring above got's k-th score
    by more than rtol is in got. A hit missed by more than the sum's noise
    fails."""
    assert got.total_hits <= want_wide.total_hits, (
        f"total_hits {got.total_hits} > exhaustive {want_wide.total_hits}"
    )
    g_docs, g_s = _pairs(got)
    w_docs, w_s = _pairs(want_wide)
    assert len(g_docs) == min(k, len(w_docs)), f"{len(g_docs)} hits, expected {min(k, len(w_docs))}"
    _assert_ordered(g_docs, g_s, "got")
    _assert_ordered(w_docs, w_s, "want")
    w_score = dict(zip(w_docs, w_s))
    full = len(w_docs) < want_wide.total_hits  # want_wide is truncated too
    floor = float(w_s[-1]) + rtol * max(1.0, abs(float(w_s[-1]))) if len(w_docs) else 0.0
    for d, s in zip(g_docs, g_s):
        if d not in w_score:  # past want_wide's end: only inside its last tie band
            assert full and s <= floor, (
                f"doc {d} ({s}) is not among the exhaustive top {len(w_docs)}"
            )
            continue
        assert abs(s - w_score[d]) <= rtol * max(1.0, abs(w_score[d])), (d, s, w_score[d])
    if len(g_docs) == k:
        edge = float(g_s[-1]) + rtol * max(1.0, abs(float(g_s[-1])))
        taken = set(g_docs)
        missed = [(d, s) for d, s in zip(w_docs, w_s) if s > edge and d not in taken]
        assert not missed, f"hits above the k-th score {g_s[-1]} missed: {missed[:5]}"


def assert_batches_strict(got, want, rtol: float = RTOL) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        try:
            assert_topdocs_strict(g, w, rtol)
        except AssertionError as e:
            raise AssertionError(f"row {i}: {e}") from None

"""The comparison that decides ``correct``: the window's own answers
against the plain reference (``portbench/reference``).

During the window a ``Sampler`` keeps a uniform sample, drawn from the
seed (reservoir sampling), of the rows the window answered, with the
number of docs the answering searcher held. Once the window has closed
each kept row is answered again by the reference over that many docs, and
compared:

- ``score_err``: the largest ``|program score - reference score of the
  same doc|`` over the kept rows' hits, each over its row's best reference
  score;
- ``rank_gap``: the largest ``|reference's i-th best score - reference
  score of the program's i-th doc|``, over the row's best reference score:
  a doc that is not in the top k, a lost hit or a wrong order shows here;
  two docs whose scores differ by rounding alone may trade places;
- ``count_err``: rows whose ``total_hits`` or number of hits differs from
  the reference's, that repeat a doc, or whose equal scores are not in doc
  order;
- ``failed_rows``: rows that raised or came back empty-handed (the run's
  ``failed``).

``LIMITS`` holds each number's limit; a run is correct when every number
is at or under its limit. PERF.md gives the readings each limit was set
from.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LIMITS = {
    "score_err": 1e-5,
    "rank_gap": 1e-5,
    "count_err": 0,
    "failed_rows": 0,
}


class Kept(NamedTuple):
    row: int  # index into the pass's rows
    n_docs: int  # docs the answering searcher held
    total: int
    docs: np.ndarray
    scores: np.ndarray


class Sampler:
    """A uniform sample of ``size`` answered rows (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed % 2**63, 7])
        self.seen = 0
        self.kept: list = []

    def offer(self, rows, results, n_docs: int) -> None:
        """rows: pass indices of a batch; results: its TopDocs."""
        m = len(rows)
        slots = self.rng.integers(0, self.seen + np.arange(1, m + 1))
        for i in range(m):
            if self.seen + i < self.size:
                self.kept.append((rows[i], n_docs, results[i]))
            elif slots[i] < self.size:
                self.kept[slots[i]] = (rows[i], n_docs, results[i])
        self.seen += m

    def take(self) -> list:
        """The kept rows as plain arrays (the program's objects dropped)."""
        out = []
        for row, n_docs, td in self.kept:
            sd = td.score_docs
            out.append(Kept(row, n_docs, int(td.total_hits),
                            np.array([s.doc for s in sd], np.int64),
                            np.array([s.score for s in sd], np.float64)))
        self.kept = []
        return out


def compare(kept: Kept, ref, k: int) -> dict:
    """The numbers of one row: the program's answer against the reference's
    Answer (portbench.reference.bm25.Answer)."""
    out = {"score_err": 0.0, "rank_gap": 0.0, "count_err": 0}
    docs, scores = kept.docs, kept.scores
    if (kept.total != ref.total or len(docs) != min(k, ref.total)
            or len(np.unique(docs)) != len(docs)
            or np.any((scores[1:] == scores[:-1]) & (docs[1:] < docs[:-1]))):
        out["count_err"] = 1
    n = min(len(docs), len(ref.docs))
    if n == 0:
        return out
    top = ref.scores[0] if ref.scores[0] > 0 else 1.0
    at = np.searchsorted(ref.match_docs, docs[:n])
    at = np.minimum(at, len(ref.match_docs) - 1)
    found = ref.match_docs[at] == docs[:n]  # a doc that does not match reads 1
    mine = np.where(found, ref.match_scores[at], 0.0)
    out["score_err"] = float(np.max(np.where(found, np.abs(scores[:n] - mine) / top, 1.0)))
    out["rank_gap"] = float(np.max(np.where(found, np.abs(ref.scores[:n] - mine) / top, 1.0)))
    return out


def judge(kept: list, answer, k: int, extra: dict | None = None) -> dict:
    """{number: reading} over the kept rows; answer(kept) gives the
    reference's Answer for one of them."""
    readings = {"score_err": 0.0, "rank_gap": 0.0, "count_err": 0}
    for kr in kept:
        one = compare(kr, answer(kr), k)
        readings["score_err"] = max(readings["score_err"], one["score_err"])
        readings["rank_gap"] = max(readings["rank_gap"], one["rank_gap"])
        readings["count_err"] += one["count_err"]
    readings.update(extra or {})
    return readings


def verdict(readings: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}})."""
    checks = {name: {"value": v, "limit": LIMITS[name]} for name, v in readings.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks

"""Second-pass rescoring of first-pass hits.

reference: rucene src/core/search/scorer/rescorer.rs:32-130 (Rescorer /
QueryRescorer): re-rank the top first-pass hits by combining their original
score with a (usually more expensive) rescore query's score.

Port changes (held against rucene_tpu/search/rescorer.py by
tests/test_torch_host.py):
- QueryRescorer.rescore: a rescore on the host path (a rescore query
  without a flat device form) counts one row under ``route.host``, so no
  row leaves the device unseen.
"""

from __future__ import annotations

import numpy as np

from rucene_tpu_torch.search import host_engine
from rucene_tpu_torch.search.searcher import IndexSearcher, ScoreDoc, TopDocs


class QueryRescorer:
    """combined = first_pass + rescore_weight * second_query_score (for
    docs the second query matches), reference QueryRescorer semantics."""

    def __init__(self, rescore_query, rescore_weight: float = 1.0):
        self.query = rescore_query
        self.weight = np.float32(rescore_weight)

    def rescore(self, searcher: IndexSearcher, first: TopDocs, top_n: int) -> TopDocs:
        if not first.score_docs:
            return first
        doc_freqs, stats = searcher._gather_stats_query(self.query)

        # device probe path: one dense executor dispatch + gather per leaf
        # (executor.execute_probe) when the rescore query rewrites to the
        # flat device form; host dense eval remains the general fallback
        rq = None
        if not hasattr(self.query, "host_eval"):
            try:
                cand = self.query.rewrite()
                if not cand.phrases and not cand.groups and not cand.match_all:
                    rq = cand
            except Exception:
                rq = None

        heads = list(first.score_docs[:top_n])
        if rq is not None:
            by_leaf: dict[int, list[int]] = {}
            leaves = {leaf.doc_base: leaf for leaf in searcher.reader.leaves}
            bases = sorted(leaves)
            for i, sd in enumerate(heads):
                base = max(b for b in bases if b <= sd.doc)
                by_leaf.setdefault(base, []).append(i)
            combined = np.asarray([sd.score for sd in heads], np.float32)
            for base, idxs in by_leaf.items():
                locs = np.asarray([heads[i].doc - base for i in idxs], np.int64)
                ok, sc = searcher._probe_device(
                    rq, leaves[base], locs, stats, doc_freqs
                )
                for j, i in enumerate(idxs):
                    if ok[j]:
                        combined[i] = np.float32(
                            combined[i] + self.weight * np.float32(sc[j])
                        )
            out = [ScoreDoc(sd.doc, float(combined[i])) for i, sd in enumerate(heads)]
            out.sort(key=lambda s: (-s.score, s.doc))
            return TopDocs(first.total_hits, out + list(first.score_docs[top_n:]))

        # per-leaf dense evaluation of the rescore query (host fallback)
        from rucene_tpu_torch.util.metrics import METRICS

        METRICS.incr("route.host")
        leaf_eval = {}
        for leaf in searcher.reader.leaves:
            leaf_eval[leaf.doc_base] = (
                leaf,
                host_engine.evaluate_query(
                    leaf, self.query, searcher.similarity, stats, doc_freqs
                ),
            )
        bases = sorted(leaf_eval)
        out = []
        for sd in heads:
            base = max(b for b in bases if b <= sd.doc)
            leaf, (match, acc) = leaf_eval[base]
            local = sd.doc - base
            sc = np.float32(sd.score)
            if match[local]:
                sc = np.float32(sc + self.weight * np.float32(acc[local]))
            out.append(ScoreDoc(sd.doc, float(sc)))
        out.sort(key=lambda s: (-s.score, s.doc))
        return TopDocs(first.total_hits, out + list(first.score_docs[top_n:]))

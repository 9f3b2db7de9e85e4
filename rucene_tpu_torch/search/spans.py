"""Span queries: positional query family.

reference: rucene src/core/search/query/spans/ (SpanQuery span.rs:47, Spans
protocol :165, SpanScorer :458, span_term.rs, span_near.rs, span_or.rs,
span_boost.rs).

A span is a (start_position, end_position) interval inside one doc. Scoring
follows SpanScorer: freq(doc) = sum over matching spans of
sloppy_freq(span_width - min_width) with sloppy_freq(d) = 1/(d+1)
(bm25_similarity.rs:66-68), fed into the BM25 tf formula; the weight is the
summed idf of all contained terms.

Evaluation is host-side numpy over the positions stream (the positional
analog of the phrase path); device offload rides the same candidate
pipeline later.
"""

from __future__ import annotations

import numpy as np

from rucene_tpu_torch.doc.term import Term
from rucene_tpu_torch.search.query import Query


class SpanQuery(Query):
    field: str

    def extract_terms(self) -> list[Term]:
        raise NotImplementedError

    def spans_for_doc(self, cache: dict, leaf, local_doc: int) -> np.ndarray:
        """[:,2] array of (start, end) position intervals, sorted by start."""
        raise NotImplementedError

    def candidate_docs(self, leaf) -> np.ndarray:
        raise NotImplementedError

    def min_width(self) -> int:
        raise NotImplementedError

    # shared host evaluation: candidates -> spans -> sloppy freq -> BM25
    def host_eval(self, leaf, sim, stats, doc_freqs):
        md = leaf.max_doc
        match = np.zeros(md, dtype=bool)
        acc = np.zeros(md, dtype=np.float32)
        terms = self.extract_terms()
        if not terms or self.field not in stats:
            return match, acc
        st = stats[self.field]
        doc_count = st.doc_count if st.doc_count != -1 else st.max_doc
        idf_sum = np.float32(0.0)
        for t in terms:
            idf_sum = np.float32(idf_sum + sim.idf(doc_freqs[(t.field, t.text)], doc_count))
        w2 = np.float32(np.float32(idf_sum * np.float32(self.boost)) * np.float32(sim.k1 + np.float32(1.0)))
        has_norms = self.field in leaf.packed.norms
        cache_row = sim.cache_row(st if has_norms else None)
        norms = leaf.packed.norms.get(self.field)
        mw = self.min_width()
        cand = self.candidate_docs(leaf)

        # native serving path: flatten the span tree and evaluate every
        # candidate in one C call (span_native.py; VERDICT r3 item 7 — no
        # per-doc Python in any family's serving path). The loop below is
        # the oracle it is parity-tested against.
        from rucene_tpu_torch.search import span_native

        res = span_native.eval_spans(self, leaf, cand, w2, cache_row, norms)
        if res is not None:
            m_c, s_c = res
            if len(cand):
                ca = np.asarray(cand, np.int64)
                match[ca] = m_c.astype(bool)
                acc[ca] = s_c
            return match, acc

        pos_cache: dict = {}
        for d in cand:
            spans = self.spans_for_doc(pos_cache, leaf, int(d))
            if len(spans) == 0:
                continue
            widths = spans[:, 1] - spans[:, 0]
            # overlapping sub-spans (duplicate clause terms) can make
            # width < min_width; clamp the distance at 0 so the slop
            # factor caps at 1 instead of dividing by zero (NaN scores)
            freq = np.float32(
                np.sum(1.0 / (1.0 + np.maximum(widths - mw, 0))).astype(np.float32)
            )
            nb = int(norms[d]) if norms is not None else 0
            cval = cache_row[nb]
            acc[d] = np.float32(w2 * freq / (freq + cval))
            match[d] = True
        return match, acc


class SpanTermQuery(SpanQuery):
    """reference span_term.rs"""

    def __init__(self, term: Term, boost: float = 1.0):
        self.term = term
        self.field = term.field
        self.boost = boost

    def device_equivalent(self):
        """All spans have width 1, so freq == tf and the SpanScorer formula
        reduces to exactly the TermQuery BM25 score -> device term path."""
        from rucene_tpu_torch.search.query import TermQuery

        return TermQuery(self.term, boost=self.boost)

    def extract_terms(self) -> list[Term]:
        return [self.term]

    def min_width(self) -> int:
        return 1

    def candidate_docs(self, leaf) -> np.ndarray:
        p = leaf.read_postings(self.term.field, self.term.text)
        return p[0] if p is not None else np.zeros(0, np.int64)

    def spans_for_doc(self, cache, leaf, local_doc):
        key = ("term", self.term.field, self.term.text)
        entry = cache.get(key)
        if entry is None:
            p = leaf.read_postings(self.term.field, self.term.text, with_positions=True)
            if p is None:
                entry = cache[key] = ({}, None)
            else:
                docs, freqs, pos = p
                starts = np.concatenate([[0], np.cumsum(freqs)])
                entry = cache[key] = ({int(d): i for i, d in enumerate(docs)}, (starts, pos))
        idx_map, data = entry
        if data is None or local_doc not in idx_map:
            return np.zeros((0, 2), np.int64)
        starts, pos = data
        row = idx_map[local_doc]
        p = pos[starts[row] : starts[row + 1]]
        return np.stack([p, p + 1], axis=1)


class SpanOrQuery(SpanQuery):
    """Union of sub-spans (reference span_or.rs)."""

    def __init__(self, clauses: list[SpanQuery], boost: float = 1.0):
        if not clauses:
            raise ValueError("SpanOrQuery needs clauses")
        self.clauses = clauses
        self.field = clauses[0].field
        if any(c.field != self.field for c in clauses):
            raise ValueError("SpanOrQuery clauses must share a field")
        self.boost = boost

    def extract_terms(self) -> list[Term]:
        return [t for c in self.clauses for t in c.extract_terms()]

    def min_width(self) -> int:
        return min(c.min_width() for c in self.clauses)

    def candidate_docs(self, leaf) -> np.ndarray:
        parts = [c.candidate_docs(leaf) for c in self.clauses]
        return np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)

    def synonym_terms(self):
        """(field, member texts, boost) when every clause is a plain
        SpanTermQuery: all spans have width 1, so freq(doc) = sum of
        member tfs — the device synonym path (executor.execute_synonym)."""
        if not all(
            type(c) is SpanTermQuery and c.boost == 1.0 for c in self.clauses
        ):
            return None
        return (self.field, [c.term.text for c in self.clauses], self.boost)

    def spans_for_doc(self, cache, leaf, local_doc):
        parts = [c.spans_for_doc(cache, leaf, local_doc) for c in self.clauses]
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.zeros((0, 2), np.int64)
        allp = np.concatenate(parts)
        return allp[np.lexsort((allp[:, 1], allp[:, 0]))]


class SpanNearQuery(SpanQuery):
    """Sub-spans within `slop` positions, optionally in order
    (reference span_near.rs)."""

    def __init__(self, clauses: list[SpanQuery], slop: int, in_order: bool, boost: float = 1.0):
        if len(clauses) < 2:
            raise ValueError("SpanNearQuery needs >= 2 clauses")
        self.clauses = clauses
        self.slop = slop
        self.in_order = in_order
        self.field = clauses[0].field
        if any(c.field != self.field for c in clauses):
            raise ValueError("SpanNearQuery clauses must share a field")
        self.boost = boost

    def device_equivalent(self):
        """Ordered near over plain term children IS this engine's sloppy
        phrase (greedy chain, total gap <= slop, freq = sum 1/(gap+1) —
        phrase_scorer.rs:442 analog), so it rides the device phrase
        pipeline. Unordered or nested spans stay on the host."""
        if not self.in_order:
            return None
        if not all(
            type(c) is SpanTermQuery and c.boost == 1.0 for c in self.clauses
        ):
            return None
        from rucene_tpu_torch.search.query import PhraseQuery

        return PhraseQuery(
            self.field,
            [c.term.text for c in self.clauses],
            boost=self.boost,
            slop=self.slop,
        )

    def extract_terms(self) -> list[Term]:
        return [t for c in self.clauses for t in c.extract_terms()]

    def min_width(self) -> int:
        return sum(c.min_width() for c in self.clauses)

    def candidate_docs(self, leaf) -> np.ndarray:
        cand = None
        for c in self.clauses:
            docs = c.candidate_docs(leaf)
            cand = docs if cand is None else np.intersect1d(cand, docs, assume_unique=False)
            if len(cand) == 0:
                break
        return cand if cand is not None else np.zeros(0, np.int64)

    def spans_for_doc(self, cache, leaf, local_doc):
        subs = [c.spans_for_doc(cache, leaf, local_doc) for c in self.clauses]
        if any(len(s) == 0 for s in subs):
            return np.zeros((0, 2), np.int64)
        out = []
        if self.in_order:
            # greedy ordered matching (NearSpansOrdered semantics)
            for s0 in subs[0]:
                start, end = int(s0[0]), int(s0[1])
                ok = True
                for sub in subs[1:]:
                    nxt = sub[sub[:, 0] >= end]
                    if len(nxt) == 0:
                        ok = False
                        break
                    end = int(nxt[0, 1])
                if ok:
                    width = end - start
                    if width - self.min_width() <= self.slop:
                        out.append((start, end))
        else:
            # unordered: every distinct (min start, max end) over one-span-
            # per-clause assignments with width <= cap. Enumerated over
            # candidate (start, end) pairs instead of the combo product
            # (which is exponential in clause count x frequency): (s, e)
            # is achievable iff every clause has a span inside [s, e],
            # some clause has an inside-span starting at s, some has one
            # ending at e, and those two witnesses are distinct clauses
            # (or one span realizes both ends).
            cap = self.min_width() + self.slop
            starts = np.unique(np.concatenate([s[:, 0] for s in subs]))
            ends = np.unique(np.concatenate([s[:, 1] for s in subs]))
            for s0 in starts:
                for e0 in ends[(ends > s0) & (ends - s0 <= cap)]:
                    inside = [
                        sub[(sub[:, 0] >= s0) & (sub[:, 1] <= e0)]
                        for sub in subs
                    ]
                    if any(len(iv) == 0 for iv in inside):
                        continue
                    c_start = [j for j, iv in enumerate(inside) if (iv[:, 0] == s0).any()]
                    c_end = [j for j, iv in enumerate(inside) if (iv[:, 1] == e0).any()]
                    if not c_start or not c_end:
                        continue
                    distinct = len(set(c_start) | set(c_end)) >= 2
                    both = any(
                        ((inside[j][:, 0] == s0) & (inside[j][:, 1] == e0)).any()
                        for j in c_start
                    )
                    if distinct or both:
                        out.append((int(s0), int(e0)))
            out = list(set(out))
        if not out:
            return np.zeros((0, 2), np.int64)
        arr = np.array(sorted(out), dtype=np.int64)
        return arr


class SpanBoostQuery(SpanQuery):
    """Boost wrapper over any span query (reference span_boost.rs)."""

    def __init__(self, query: SpanQuery, boost: float):
        self.query = query
        self.field = query.field
        self.boost = boost * getattr(query, "boost", 1.0)

    def device_equivalent(self):
        de = getattr(self.query, "device_equivalent", None)
        eq = de() if de is not None else None
        if eq is None:
            return None
        eq.boost = self.boost  # total boost (already includes the inner one)
        return eq

    def synonym_terms(self):
        st = getattr(self.query, "synonym_terms", None)
        inner = st() if st is not None else None
        if inner is None:
            return None
        field, texts, _b = inner
        return (field, texts, self.boost)  # total boost

    def extract_terms(self):
        return self.query.extract_terms()

    def min_width(self) -> int:
        return self.query.min_width()

    def candidate_docs(self, leaf):
        return self.query.candidate_docs(leaf)

    def spans_for_doc(self, cache, leaf, local_doc):
        return self.query.spans_for_doc(cache, leaf, local_doc)

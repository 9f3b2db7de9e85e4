"""Pure-numpy mirror of the device engine.

Two jobs:
1. Parity oracle: tests assert the jitted executor produces bit-identical
   scores/ordering to this implementation (the analog of the reference's
   scorer unit tests, e.g. bulk_scorer.rs:157-201).
2. Execution path for queries needing positional verification (PhraseQuery)
   until the device phrase kernel lands: phrase freq is computed here and
   scored with the same f32 BM25 semantics.

Float discipline: all scoring in np.float32, accumulation in clause order —
identical operation order to search.executor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rucene_tpu_torch.index.reader import SegmentSnapshot
from rucene_tpu_torch.search.query import Occur, RewrittenQuery
from rucene_tpu_torch.search.similarity import BM25Similarity, CollectionStats


@dataclass
class HostHits:
    total_hits: int
    docs: np.ndarray  # i32[<=k] segment-local doc ids
    scores: np.ndarray  # f32[<=k]


def phrase_postings(
    leaf: SegmentSnapshot, field: str, terms: list[str], slop: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Phrase virtual postings: (docs, phrase_freqs).

    slop=0: exact consecutive positions (ExactPhraseScorer,
    phrase_scorer.rs:122); freqs are occurrence counts.
    slop>0: ordered matching with total gap <= slop; freq = sum of
    sloppy_freq(distance) = 1/(distance+1) per match (SloppyPhraseScorer
    analog, phrase_scorer.rs:442) — returned as f32-compatible floats.
    """
    # None entries are positional holes (gapped phrases, slop == 0 only:
    # PhraseQuery.positions) — they constrain alignment but read nothing
    slots = [j for j, t in enumerate(terms) if t is not None]
    terms = [terms[j] for j in slots]
    lists = []
    for t in terms:
        p = leaf.read_postings(field, t, with_positions=True)
        if p is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        lists.append(p)

    # conjunction of doc sets, tracking per-term row indices
    cand = lists[0][0]
    idxs = [np.arange(len(cand))]
    for docs_j, _, _ in lists[1:]:
        cand, ia, ib = np.intersect1d(cand, docs_j, assume_unique=True, return_indices=True)
        idxs = [ix[ia] for ix in idxs]
        idxs.append(ib)

    out_docs: list[int] = []
    out_freqs: list[int] = []
    # per-term position extents
    starts = []
    for docs_j, freqs_j, pos_j in lists:
        s = np.concatenate([[0], np.cumsum(freqs_j)])
        starts.append((s, pos_j))
    n = len(terms)
    for ci in range(len(cand)):
        if slop == 0:
            first = None
            for j in range(n):
                row = idxs[j][ci]
                s, pos_j = starts[j]
                p = pos_j[s[row] : s[row + 1]] - slots[j]
                first = p if first is None else np.intersect1d(first, p, assume_unique=True)
                if len(first) == 0:
                    break
            pf = len(first) if first is not None else 0
        else:
            plists = []
            for j in range(n):
                row = idxs[j][ci]
                s, pos_j = starts[j]
                plists.append(pos_j[s[row] : s[row + 1]])
            # histogram accumulation: pf = sum_d count(distance==d)/(d+1),
            # f32, ascending d — the exact operation order of the device
            # kernel (phrase_device.py) so parity is bit-identical
            dist_counts = np.zeros(slop + 1, np.int64)
            for p0 in plists[0]:
                prev = int(p0)
                ok = True
                for j in range(1, n):
                    nxt = plists[j][plists[j] > prev]
                    if len(nxt) == 0:
                        ok = False
                        break
                    prev = int(nxt[0])
                if ok:
                    distance = (prev - int(p0)) - (n - 1)
                    if distance <= slop:
                        dist_counts[distance] += 1
            pf = np.float32(0.0)
            for d in range(slop + 1):
                if dist_counts[d]:
                    pf = np.float32(
                        pf
                        + np.float32(dist_counts[d])
                        * np.float32(1.0 / (d + 1.0))
                    )
        if pf > 0:
            out_docs.append(int(cand[ci]))
            out_freqs.append(pf)
    return np.asarray(out_docs, dtype=np.int64), np.asarray(out_freqs, dtype=np.float64)


def execute_on_segment(
    leaf: SegmentSnapshot,
    rq: RewrittenQuery,
    sim: BM25Similarity,
    stats: dict[str, CollectionStats],
    doc_freqs: dict[tuple[str, str], int],
    k: int | None,
) -> HostHits:
    """Run one rewritten query against one segment, returning top-k hits
    ordered by (score desc, doc asc) — or the full match set if k is None."""
    match, acc = evaluate_rewritten(leaf, rq, sim, stats, doc_freqs)
    return hits_from_dense(leaf, match, acc, k)


def hits_from_dense(
    leaf: SegmentSnapshot, match: np.ndarray, acc: np.ndarray, k: int | None
) -> HostHits:
    md = leaf.max_doc
    if leaf.live is not None:
        match = match & leaf.live[:md]
    total = int(match.sum())
    scores = np.where(match, acc, -np.inf).astype(np.float32)
    if k is None:  # full match set, ascending doc order (sorted-search path)
        docs = np.nonzero(match)[0]
        return HostHits(total_hits=total, docs=docs.astype(np.int32), scores=acc[docs])
    order = np.lexsort((np.arange(md), -scores))[: min(k, md)]
    order = order[scores[order] > -np.inf]
    return HostHits(total_hits=total, docs=order.astype(np.int32), scores=scores[order])


def extract_terms_of(query) -> list:
    """Terms a query needs statistics for (Weight::extract_terms analog)."""
    from rucene_tpu_torch.doc.term import Term

    if hasattr(query, "extract_terms"):
        return list(query.extract_terms())
    rq = query.rewrite()
    out = [c.term for c in rq.clauses]
    out.extend(c.term for _, ms in rq.groups for c in ms)
    for f, ts, _boost, _slop in rq.phrases:
        out.extend(Term(f, t) for t in ts if t is not None)
    return out


def evaluate_query(leaf, query, sim, stats, doc_freqs) -> tuple[np.ndarray, np.ndarray]:
    """(match bool[max_doc], scores f32[max_doc]) for any query: special
    queries (spans, dismax) implement host_eval; booleans nesting them
    combine recursively; the rest go through the rewritten evaluator."""
    from rucene_tpu_torch.search.query import _NeedsHostEval

    if hasattr(query, "host_eval"):
        return query.host_eval(leaf, sim, stats, doc_freqs)
    try:
        rq = query.rewrite()
    except _NeedsHostEval:
        return _evaluate_boolean_generic(leaf, query, sim, stats, doc_freqs)
    return evaluate_rewritten(leaf, rq, sim, stats, doc_freqs)


def _evaluate_boolean_generic(leaf, bq, sim, stats, doc_freqs):
    """BooleanQuery whose clauses may be arbitrary queries (spans, dismax,
    constant-score, nested booleans): evaluate each clause recursively and
    combine with the same count semantics as the flat evaluator."""
    md = leaf.max_doc
    acc = np.zeros(md, dtype=np.float32)
    req_count = np.zeros(md, dtype=np.int32)
    should_count = np.zeros(md, dtype=np.int32)
    has_not = np.zeros(md, dtype=bool)
    n_required = 0
    n_should = 0
    for occur, sub in bq.clauses:
        m, s = evaluate_query(leaf, sub, sim, stats, doc_freqs)
        o = int(occur)
        if o in (int(Occur.SHOULD), int(Occur.MUST)):
            acc = (acc + np.where(m, s, np.float32(0.0))).astype(np.float32)
        if o in (int(Occur.MUST), int(Occur.FILTER)):
            n_required += 1
            req_count += m
        elif o == int(Occur.SHOULD):
            n_should += 1
            should_count += m
        else:
            has_not |= m
    mm = bq.min_should_match
    if n_required == 0 and n_should > 0:
        mm = max(1, mm)
    match = (req_count == n_required) & (should_count >= mm) & ~has_not
    return match, acc


def evaluate_rewritten(
    leaf: SegmentSnapshot,
    rq: RewrittenQuery,
    sim: BM25Similarity,
    stats: dict[str, CollectionStats],
    doc_freqs: dict[tuple[str, str], int],
) -> tuple[np.ndarray, np.ndarray]:
    md = leaf.max_doc
    acc = np.zeros(md, dtype=np.float32)
    req_count = np.zeros(md, dtype=np.int32)
    should_count = np.zeros(md, dtype=np.int32)
    has_not = np.zeros(md, dtype=bool)
    n_required = rq.n_required + rq.n_required_phrases
    cache_rows: dict[str, np.ndarray] = {}

    def cache_for(field: str) -> np.ndarray:
        row = cache_rows.get(field)
        if row is None:
            has_norms = field in leaf.packed.norms
            row = sim.cache_row(stats[field] if has_norms else None)
            cache_rows[field] = row
        return row

    def norm_bytes(field: str, docs: np.ndarray) -> np.ndarray:
        norms = leaf.packed.norms.get(field)
        if norms is None:
            return np.zeros(len(docs), dtype=np.int64)
        return norms[docs].astype(np.int64)

    for clause in rq.clauses:
        field, text = clause.term.field, clause.term.text
        p = leaf.read_postings(field, text)
        if p is None:
            continue
        docs, freqs, _ = p
        if clause.occur in (Occur.SHOULD, Occur.MUST):
            w2 = sim.term_weight(doc_freqs[(field, text)], stats[field], clause.boost)
            tf = freqs.astype(np.float32)
            cval = cache_for(field)[norm_bytes(field, docs)]
            acc[docs] += (w2 * tf / (tf + cval)).astype(np.float32)
        if clause.occur in (Occur.MUST, Occur.FILTER):
            req_count[docs] += 1
        elif clause.occur == Occur.SHOULD:
            should_count[docs] += 1
        elif clause.occur == Occur.MUST_NOT:
            has_not[docs] = True

    for occ, members in rq.groups:
        g_match = np.zeros(md, dtype=bool)
        for clause in members:
            field, text = clause.term.field, clause.term.text
            p = leaf.read_postings(field, text)
            if p is None:
                continue
            docs, freqs, _ = p
            g_match[docs] = True
            if occ in (Occur.SHOULD, Occur.MUST):
                w2 = sim.term_weight(doc_freqs[(field, text)], stats[field], clause.boost)
                tf = freqs.astype(np.float32)
                cval = cache_for(field)[norm_bytes(field, docs)]
                acc[docs] += (w2 * tf / (tf + cval)).astype(np.float32)
        if occ in (Occur.MUST, Occur.FILTER):
            req_count[g_match] += 1
        elif occ == Occur.SHOULD:
            should_count[g_match] += 1
        elif occ == Occur.MUST_NOT:
            has_not |= g_match

    for r in rq.ranges:
        from rucene_tpu_torch.search.cache import DEFAULT_QUERY_CACHE

        docs = DEFAULT_QUERY_CACHE.get_or_compute(
            leaf, r.cache_key, lambda r=r: r.doc_set(leaf)
        )
        if r.occur in (Occur.SHOULD, Occur.MUST):
            acc[docs] += np.float32(r.boost)  # constant-score semantics
        if r.occur in (Occur.MUST, Occur.FILTER):
            req_count[docs] += 1
        elif r.occur == Occur.SHOULD:
            should_count[docs] += 1
        elif r.occur == Occur.MUST_NOT:
            has_not[docs] = True

    for pi, (field, terms, boost, slop) in enumerate(rq.phrases):
        occ = rq.phrase_occur(pi)
        docs, pfreqs = phrase_postings(leaf, field, terms, slop)
        # phrase weight: sum of per-term idfs (PhraseWeight -> Similarity with
        # all terms' stats; reference BM25Similarity::idf sums over terms)
        doc_count = stats[field].doc_count if stats[field].doc_count != -1 else stats[field].max_doc
        idf_sum = np.float32(0.0)
        for t in terms:
            if t is None:
                continue
            idf_sum = np.float32(idf_sum + sim.idf(doc_freqs[(field, t)], doc_count))
        w = np.float32(idf_sum * np.float32(boost))
        w2 = np.float32(w * np.float32(sim.k1 + np.float32(1.0)))
        if len(docs):
            if occ in (Occur.SHOULD, Occur.MUST):
                tf = pfreqs.astype(np.float32)
                cval = cache_for(field)[norm_bytes(field, docs)]
                acc[docs] += (w2 * tf / (tf + cval)).astype(np.float32)
            if occ in (Occur.MUST, Occur.FILTER):
                req_count[docs] += 1
            elif occ == Occur.SHOULD:
                should_count[docs] += 1

    match = (req_count == n_required) & (should_count >= rq.effective_min_should())
    if rq.match_all and n_required == 0 and rq.n_should == 0:
        match = np.ones(md, dtype=bool)
        acc[:] = np.float32(rq.boost)
    match &= ~has_not
    return match, acc

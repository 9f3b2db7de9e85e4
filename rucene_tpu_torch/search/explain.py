"""Score explanation trees with per-child breakdowns.

The reference builds a real tree per query type: term weights nest
idf/tfNorm (term_query.rs:183-215, bm25_similarity.rs explain_tf_norm),
booleans sum per-clause weight nodes (boolean_query.rs explain), dismax
combines per-disjunct trees ("max plus {tie} times others of:",
disjunction_max_query.rs:43-74), spans explain through their SimWeight
(spans/span.rs). This module mirrors that structure; values replicate
the engine's own f32 arithmetic so explain(q, doc).value equals the
score search returns (tests/test_explain_generic.py pins it).

Only truly unmodeled shapes fall back to a single generic node whose
value comes from the exact recursive host evaluator.
"""

from __future__ import annotations

import numpy as np

from rucene_tpu_torch.search import host_engine
from rucene_tpu_torch.search.explanation import Explanation, no_match
from rucene_tpu_torch.search.query import (
    BooleanQuery,
    BoostingQuery,
    BoostQuery,
    ConstantScoreQuery,
    DisjunctionMaxQuery,
    Occur,
    Query,
    _NeedsHostEval,
)


def explain(searcher, query: Query, doc: int) -> Explanation:
    leaf = None
    for lf in reversed(searcher.reader.leaves):
        if doc >= lf.doc_base:
            leaf = lf
            break
    if leaf is None:
        return no_match(f"doc {doc} out of range")
    local = doc - leaf.doc_base

    # --- combining query types: recurse per child, reference-shaped ---
    if isinstance(query, DisjunctionMaxQuery):
        subs = [explain(searcher, sq, doc) for sq in query.queries]
        matching = [e for e in subs if e.match]
        if not matching:
            return no_match("no matching clause in DisjunctionMaxQuery")
        vals = np.asarray([e.value for e in matching], np.float32)
        mx = np.float32(vals.max())
        others = np.float32(vals.sum(dtype=np.float32) - mx)
        tb = np.float32(query.tie_breaker)
        val = float(np.float32(np.float32(query.boost) * (mx + tb * others)))
        desc = (
            f"max plus {float(tb)} times others of:"
            if query.tie_breaker
            else "max of:"
        )
        return Explanation(True, val, desc, subs)

    if isinstance(query, BoostQuery):
        inner = explain(searcher, query.query, doc)
        if not inner.match:
            return inner
        return Explanation(
            True,
            float(np.float32(np.float32(inner.value) * np.float32(query.boost))),
            "product of:",
            [inner, Explanation(True, float(query.boost), "boost")],
        )

    if isinstance(query, ConstantScoreQuery):  # FilterQuery subclasses this
        dfq, stq = searcher._gather_stats_query(query)
        m, _ = host_engine.evaluate_query(
            leaf, query.query, searcher.similarity, stq, dfq
        )
        if not m[local]:
            return no_match("wrapped query does not match")
        return Explanation(
            True,
            float(query.boost),
            f"ConstantScore({type(query.query).__name__}), product of:",
            [Explanation(True, float(query.boost), "boost"),
             Explanation(True, 1.0, "queryNorm")],
        )

    if isinstance(query, BoostingQuery):
        pos = explain(searcher, query.positive, doc)
        if not pos.match:
            return no_match("positive query does not match")
        dfq, stq = searcher._gather_stats_query(query)
        nm, _ = host_engine.evaluate_query(
            leaf, query.negative, searcher.similarity, stq, dfq
        )
        if not nm[local]:
            return pos
        nb = np.float32(query.negative_boost)
        return Explanation(
            True,
            float(np.float32(np.float32(pos.value) * nb)),
            "product of:",
            [pos, Explanation(True, float(nb), "negativeBoost (negative query matched)")],
        )

    from rucene_tpu_torch.search.spans import SpanQuery

    if isinstance(query, SpanQuery):
        return _span_tree(searcher, query, leaf, local, doc)

    try:
        rq = query.rewrite()
    except (_NeedsHostEval, NotImplementedError):
        rq = None
    if rq is None or not rq.plain:
        if isinstance(query, BooleanQuery):
            # host-eval booleans (excluded phrases, nested specials): exact
            # value from the recursive evaluator, per-clause child trees
            dfq, stq = searcher._gather_stats_query(query)
            m, acc = host_engine.evaluate_query(
                leaf, query, searcher.similarity, stq, dfq
            )
            if not m[local]:
                return no_match(f"doc {doc} does not match the query")
            details = []
            for occ, sub in query.clauses:
                if occ == Occur.MUST_NOT:
                    continue
                e = explain(searcher, sub, doc)
                if e.match and occ in (Occur.SHOULD, Occur.MUST):
                    details.append(e)
            return Explanation(True, float(acc[local]), "sum of:", details)
        return _generic(searcher, query, leaf, local)

    return _plain_tree(searcher, rq, leaf, local, doc)


def _generic(searcher, query, leaf, local) -> Explanation:
    """Last resort: one node whose value is the exact evaluator's score."""
    dfq, stq = searcher._gather_stats_query(query)
    m, acc = host_engine.evaluate_query(
        leaf, query, searcher.similarity, stq, dfq
    )
    if not m[local]:
        return no_match("no matching clause (generic evaluation)")
    return Explanation(
        True, float(acc[local]),
        f"{type(query).__name__} score, generic recursive evaluation",
    )


def _idf_node(sim, doc_freqs, stats, field: str, text: str):
    st = stats[field]
    doc_count = st.doc_count if st.doc_count != -1 else st.max_doc
    df = doc_freqs[(field, text)]
    idf = float(sim.idf(df, doc_count))
    return idf, Explanation(
        True,
        idf,
        "idf, computed as log(1 + (docCount - docFreq + 0.5) / (docFreq + 0.5)) from:",
        [
            Explanation(True, float(df), "docFreq"),
            Explanation(True, float(doc_count), "docCount"),
        ],
    )


def _tf_norm_node(sim, stats, leaf, local, field: str, freq: float):
    """tfNorm node shared by term/phrase/span weights."""
    st = stats[field]
    if field in leaf.packed.norms:
        avgdl = float(sim.avg_field_length(st))
        from rucene_tpu_torch.util.small_float import norm_table

        dl = float(norm_table()[int(leaf.packed.norms[field][local])])
        val = (freq * (float(sim.k1) + 1.0)) / (
            freq
            + float(sim.k1) * (1.0 - float(sim.b) + float(sim.b) * dl / avgdl)
        )
        return val, Explanation(
            True,
            val,
            "tfNorm, computed as (freq * (k1 + 1)) / (freq + k1 * "
            "(1 - b + b * fieldLength / avgFieldLength)) from:",
            [
                Explanation(True, freq, "termFreq"),
                Explanation(True, float(sim.k1), "parameter k1"),
                Explanation(True, float(sim.b), "parameter b"),
                Explanation(True, avgdl, "avgFieldLength"),
                Explanation(True, dl, "fieldLength"),
            ],
        )
    val = (freq * (float(sim.k1) + 1.0)) / (freq + float(sim.k1))
    return val, Explanation(
        True,
        val,
        "tfNorm, computed as (freq * (k1 + 1)) / (freq + k1) from:",
        [Explanation(True, freq, "termFreq")],
    )


def _span_tree(searcher, query, leaf, local, doc) -> Explanation:
    """Span family: idf-sum + tfNorm over the sloppy span frequency —
    the same SimWeight shape the reference's SpanScorer explains through
    (spans/span.rs SpanScorer, spans.py host_eval is the value oracle)."""
    sim = searcher.similarity
    terms = query.extract_terms()
    field = query.field
    dfq, stq = searcher._gather_stats_query(query)
    if not terms or field not in stq:
        return no_match("span query over empty field")
    spans = query.spans_for_doc({}, leaf, local)
    if len(spans) == 0:
        return no_match(f"no spans in doc {doc}")
    widths = spans[:, 1] - spans[:, 0]
    mw = query.min_width()
    freq = float(
        np.float32(np.sum(1.0 / (1.0 + np.maximum(widths - mw, 0))).astype(np.float32))
    )
    idf_nodes = []
    idf_sum = np.float32(0.0)
    st = stq[field]
    doc_count = st.doc_count if st.doc_count != -1 else st.max_doc
    for t in terms:
        idf_sum = np.float32(idf_sum + sim.idf(dfq[(t.field, t.text)], doc_count))
        _, node = _idf_node(sim, dfq, stq, t.field, t.text)
        idf_nodes.append(node)
    # value replicates host_eval's f32 chain bit-for-bit (cache_row cval)
    has_norms = field in leaf.packed.norms
    cache_row = sim.cache_row(st if has_norms else None)
    nb = int(leaf.packed.norms[field][local]) if has_norms else 0
    cval = cache_row[nb]
    w2 = np.float32(
        np.float32(idf_sum * np.float32(query.boost))
        * np.float32(sim.k1 + np.float32(1.0))
    )
    f32 = np.float32(freq)
    val = float(np.float32(w2 * f32 / (f32 + cval)))
    _, tf_node = _tf_norm_node(sim, stq, leaf, local, field, freq)
    name = type(query).__name__
    return Explanation(
        True,
        val,
        f"weight({field}:{name} in {doc}) [BM25Similarity], product of:",
        [Explanation(True, float(idf_sum), "idf(), sum of:", idf_nodes), tf_node],
    )


def _plain_tree(searcher, rq, leaf, local, doc) -> Explanation:
    """Flat rewritten queries: per-clause term/range/phrase weight nodes
    summed (boolean_query.rs explain / term_query.rs:183-215)."""
    sim = searcher.similarity
    doc_freqs, stats = searcher._gather_stats([rq])
    hits = host_engine.execute_on_segment(
        leaf, rq, sim, stats, doc_freqs, None
    )
    matched = local in set(hits.docs.tolist())
    details: list[Explanation] = []

    def term_detail(field: str, text: str, boost: float):
        """weight(...) node for one term at this doc, or None if absent."""
        p = leaf.read_postings(field, text)
        if p is None:
            return None
        pdocs, pfreqs, _ = p
        idx = np.searchsorted(pdocs, local)
        if idx >= len(pdocs) or pdocs[idx] != local:
            return None
        freq = float(pfreqs[idx])
        idf, idf_node = _idf_node(sim, doc_freqs, stats, field, text)
        _, tf_node = _tf_norm_node(sim, stats, leaf, local, field, freq)
        weight_val = idf * float(boost) * tf_node.value
        return Explanation(
            True,
            weight_val,
            f"weight({field}:{text} in {doc}) [BM25Similarity], product of:",
            [idf_node, tf_node],
        )

    for c in rq.clauses:
        if c.occur == Occur.MUST_NOT:
            continue
        node = term_detail(c.term.field, c.term.text, c.boost)
        if node is not None and c.occur in (Occur.SHOULD, Occur.MUST):
            details.append(node)

    # nested pure-SHOULD groups score their matching members
    # (boolean_query.rs nested BooleanWeight explain)
    for occ, members in rq.groups:
        if occ == Occur.MUST_NOT:
            continue
        for c in members:
            node = term_detail(c.term.field, c.term.text, c.boost)
            if node is not None and occ in (Occur.SHOULD, Occur.MUST):
                details.append(node)

    # point ranges: constant-score contributions
    # (point_range_query.rs explain)
    for rcl in rq.ranges:
        if rcl.occur == Occur.MUST_NOT:
            continue
        docs_in = rcl.doc_set(leaf)
        if local in set(int(x) for x in docs_in) and rcl.occur in (
            Occur.SHOULD,
            Occur.MUST,
        ):
            label = (
                f"ConstantScore(_exists_:{rcl.field})"
                if rcl.kind == "exists"
                else f"ConstantScore({rcl.field}:[{rcl.lower} TO {rcl.upper}])"
            )
            details.append(Explanation(True, float(rcl.boost), label))

    # phrases: weight = boost * sum(idf) with tf = phrase freq
    # (phrase_query.rs explain)
    for field, terms, boost, slop in rq.phrases:
        pdocs, pfreqs = host_engine.phrase_postings(leaf, field, terms, slop)
        idx = np.searchsorted(pdocs, local) if len(pdocs) else 0
        if len(pdocs) == 0 or idx >= len(pdocs) or pdocs[idx] != local:
            continue
        freq = float(pfreqs[idx])
        idf_nodes = []
        idf_sum = 0.0
        for t in terms:
            one, node = _idf_node(sim, doc_freqs, stats, field, t)
            idf_sum += one
            idf_nodes.append(node)
        _, tf_node = _tf_norm_node(sim, stats, leaf, local, field, freq)
        phrase_txt = " ".join(terms)
        details.append(
            Explanation(
                True,
                idf_sum * float(boost) * tf_node.value,
                f'weight({field}:"{phrase_txt}" in {doc}) [BM25Similarity], product of:',
                [
                    Explanation(True, idf_sum, "idf(), sum of:", idf_nodes),
                    tf_node,
                ],
            )
        )

    if rq.match_all and not details:
        details.append(Explanation(True, float(rq.boost), "*:*, product of:"))

    if not matched:
        return no_match(f"doc {doc} does not match the query")
    total = float(np.float32(sum(np.float32(d.value) for d in details)))
    if len(details) == 1:
        # single-clause query: the weight node IS the explanation (the
        # reference's TermQuery explain returns it directly, not a sum)
        only = details[0]
        return Explanation(True, total, only.description, only.details)
    return Explanation(True, total, "sum of:", details)

"""Query algebra (reference: rucene src/core/search/query/).

Queries rewrite to a flat clause table the batch executor understands:
term clauses with occur kind + boost, plus query-level boolean controls.
PhraseQuery rewrites to a conjunction plus a positional verification stage
(the two-phase analog, see searcher.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field, replace as dc_replace

from rucene_tpu_torch.doc.term import Term


class Occur(enum.IntEnum):
    # values match executor OCC_* constants
    SHOULD = 0
    MUST = 1
    FILTER = 2
    MUST_NOT = 3


@dataclass(frozen=True)
class TermClause:
    occur: Occur
    term: Term
    boost: float = 1.0


@dataclass(frozen=True)
class RangeClause:
    """Constant-score doc-set clause: a 1-D point range encoded to sortable
    int64 space (reference point_range_query.rs:366) or, with
    kind="exists", a field-presence filter (exists_query.rs:30) — both
    evaluate to a per-leaf doc set with constant score `boost`."""

    occur: Occur
    field: str
    lower: int | None  # inclusive, None = open
    upper: int | None  # inclusive, None = open
    boost: float = 1.0
    kind: str = "range"  # "range" | "exists" | "prefix"
    text: str | None = None  # kind="prefix": the term prefix

    def doc_set(self, leaf):
        """Matching local doc ids on one leaf (uncached)."""
        import numpy as np

        if self.kind == "exists":
            return np.flatnonzero(leaf.exists_mask(self.field)).astype(np.int64)
        if self.kind == "prefix":
            return leaf.prefix_docs(self.field, self.text or "")
        return leaf.point_range_docs(self.field, self.lower, self.upper)

    @property
    def cache_key(self) -> tuple:
        return (self.kind, self.field, self.lower, self.upper, self.text)


@dataclass
class RewrittenQuery:
    """Flat executable form: term clauses + boolean controls."""

    clauses: list[TermClause] = dc_field(default_factory=list)
    min_should_match: int = 0
    match_all: bool = False  # MatchAllDocsQuery component
    boost: float = 1.0
    # phrase verification groups: (field, [terms in order], boost, slop)
    phrases: list[tuple[str, list[str], float, int]] = dc_field(default_factory=list)
    # occur per phrase, aligned with `phrases`; missing entries mean MUST
    # (Lucene boolean semantics: a SHOULD phrase is optional and counts
    # toward min_should_match, boolean_query.rs:196-272)
    phrase_occurs: list = dc_field(default_factory=list)
    ranges: list[RangeClause] = dc_field(default_factory=list)
    # nested pure-disjunction sub-clauses: (occur, [terms]) — a group matches
    # if ANY member matches; scoring sums matching members' BM25
    groups: list[tuple[Occur, list[TermClause]]] = dc_field(default_factory=list)
    # DisjunctionMaxQuery combine (disjunction_max_query.rs:43): when set,
    # row score = max(member scores) + tie * (sum - max) over the SHOULD
    # term clauses instead of the boolean sum
    dismax_tie: float | None = None
    # ConstantScoreQuery (match_all_query.rs ConstantScoreQuery): matched
    # docs score this constant instead of the accumulated BM25
    const_score: float | None = None
    # BoostingQuery (boosting_query.rs:29): docs matching ANY demote term
    # have their final score multiplied by the factor (at most one group)
    demotes: list[tuple[float, list[TermClause]]] = dc_field(default_factory=list)

    @property
    def plain(self) -> bool:
        """No score-combine extras (dismax/const/demote)."""
        return (
            self.dismax_tie is None
            and self.const_score is None
            and not self.demotes
        )

    def all_slots(self) -> list[tuple[int, TermClause]]:
        """Every term slot in table order: clauses (own occur) then demote
        members (OCC_DEMOTE = 4, weightless presence-only)."""
        out = [(int(c.occur), c) for c in self.clauses]
        for _factor, members in self.demotes:
            out.extend((4, c) for c in members)
        return out

    @property
    def n_required(self) -> int:
        return (
            sum(1 for c in self.clauses if c.occur in (Occur.MUST, Occur.FILTER))
            + sum(1 for r in self.ranges if r.occur in (Occur.MUST, Occur.FILTER))
            + sum(1 for occ, _ in self.groups if occ in (Occur.MUST, Occur.FILTER))
        )

    def phrase_occur(self, i: int) -> Occur:
        return self.phrase_occurs[i] if i < len(self.phrase_occurs) else Occur.MUST

    @property
    def n_required_phrases(self) -> int:
        return sum(
            1
            for i in range(len(self.phrases))
            if self.phrase_occur(i) in (Occur.MUST, Occur.FILTER)
        )

    @property
    def n_should(self) -> int:
        return sum(1 for c in self.clauses if c.occur == Occur.SHOULD) + sum(
            1 for r in self.ranges if r.occur == Occur.SHOULD
        )

    def effective_min_should(self) -> int:
        """Lucene semantics: if there are no required clauses, at least one
        SHOULD clause must match (boolean_query.rs:196-272)."""
        mm = self.min_should_match
        if (
            self.n_required == 0
            and not self.match_all
            and self.n_required_phrases == 0
        ):
            mm = max(1, mm)
        return mm


class _NeedsHostEval(Exception):
    """Raised by rewrite() when a sub-query needs host evaluation; the
    searcher then routes the whole query through the generic host boolean
    evaluator."""

    def __init__(self, query):
        self.query = query


class Query:
    boost: float = 1.0

    def rewrite(self) -> RewrittenQuery:
        raise NotImplementedError


@dataclass
class TermQuery(Query):
    """reference term_query.rs:38"""

    term: Term
    boost: float = 1.0

    def rewrite(self) -> RewrittenQuery:
        return RewrittenQuery(clauses=[TermClause(Occur.SHOULD, self.term, self.boost)])

    def __repr__(self) -> str:
        return f"TermQuery({self.term}, boost={self.boost})"


@dataclass
class MatchAllDocsQuery(Query):
    """reference match_all_query.rs — constant score `boost` for every live doc."""

    boost: float = 1.0

    def rewrite(self) -> RewrittenQuery:
        return RewrittenQuery(match_all=True, boost=self.boost)


@dataclass
class BoostQuery(Query):
    query: Query
    boost: float = 1.0

    def rewrite(self) -> RewrittenQuery:
        rq = self.query.rewrite()
        rq.clauses = [
            TermClause(c.occur, c.term, c.boost * self.boost) for c in rq.clauses
        ]
        rq.phrases = [(f, ts, b * self.boost, sl) for (f, ts, b, sl) in rq.phrases]
        rq.ranges = [
            dc_replace(r, boost=r.boost * self.boost) for r in rq.ranges
        ]
        rq.boost *= self.boost
        return rq


@dataclass
class PhraseQuery(Query):
    """Phrase query. slop=0: exact consecutive positions
    (ExactPhraseScorer, phrase_scorer.rs:122; device pipeline). slop>0:
    ordered matching with a gap budget and sloppy-freq scoring
    (SloppyPhraseScorer analog, phrase_scorer.rs:442; host path).

    `positions` (reference phrase_query.rs:51): explicit ascending term
    positions — gaps become None hole slots in the rewritten term list
    ("a ? b" for removed stopwords). Internally a None entry in `terms`
    means "any token here". Gapped phrases require slop == 0 (the
    reference's sloppy matcher threads offsets; unsupported here)."""

    field: str
    terms: list  # list[str | None]; None = positional hole
    boost: float = 1.0
    slop: int = 0
    positions: list[int] | None = None

    def __post_init__(self):
        if self.positions is not None:
            ps = list(self.positions)
            if len(ps) != len(self.terms):
                raise ValueError("terms and positions lengths differ")
            if any(t is None for t in self.terms):
                raise ValueError("explicit positions with None terms")
            if sorted(set(ps)) != ps:
                raise ValueError("positions must be ascending and unique")
            base = ps[0]
            slots: list = [None] * (ps[-1] - base + 1)
            for t, p in zip(self.terms, ps):
                slots[p - base] = t
            self.terms = slots
            self.positions = None
        if self.slop and any(t is None for t in self.terms):
            raise ValueError("gapped phrases require slop == 0")

    def rewrite(self) -> RewrittenQuery:
        real = [t for t in self.terms if t is not None]
        if len(real) == 1 and len(self.terms) == 1:
            return RewrittenQuery(
                clauses=[TermClause(Occur.SHOULD, Term(self.field, real[0]), self.boost)]
            )
        return RewrittenQuery(
            phrases=[(self.field, list(self.terms), self.boost, self.slop)]
        )


class ConstantScoreQuery(Query):
    """Matches whatever the wrapped query matches, scoring a constant
    `boost` (reference match_all_query.rs ConstantScoreQuery)."""

    def __init__(self, query: Query, boost: float = 1.0):
        self.query = query
        self.boost = boost

    def extract_terms(self):
        from rucene_tpu_torch.search.host_engine import extract_terms_of

        return extract_terms_of(self.query)

    def rewrite(self) -> RewrittenQuery:
        """Device form: the wrapped query's match logic with the final
        score overridden to `boost` (executor const_score row). Shapes the
        flat executor can't match exactly fall back to host_eval."""
        try:
            rq = self.query.rewrite()
        except NotImplementedError:
            raise _NeedsHostEval(self)
        if rq.phrases or not rq.plain:
            raise _NeedsHostEval(self)  # phrase verify / nested combine
        rq.const_score = float(self.boost)
        rq.boost = self.boost  # match_all component scores the constant too
        return rq

    def host_eval(self, leaf, sim, stats, doc_freqs):
        import numpy as np

        from rucene_tpu_torch.search import host_engine

        m, _ = host_engine.evaluate_query(leaf, self.query, sim, stats, doc_freqs)
        return m, np.where(m, np.float32(self.boost), np.float32(0.0)).astype(np.float32)


class FilterQuery(ConstantScoreQuery):
    """Non-scoring filter wrapper (reference filter_query.rs): constant 0."""

    def __init__(self, query: Query):
        super().__init__(query, boost=0.0)


class ExistsQuery(Query):
    """Matches docs that HAVE the field — via norms, doc values, points or
    postings (reference exists_query.rs:30; mask built by
    SegmentSnapshot.exists_mask). Rewrites to an exists-kind RangeClause,
    so it rides the device filter-plane path like point ranges."""

    def __init__(self, field: str, boost: float = 1.0):
        self.field = field
        self.boost = boost

    def extract_terms(self):
        return []

    def rewrite(self) -> RewrittenQuery:
        return RewrittenQuery(
            ranges=[
                RangeClause(
                    Occur.SHOULD, self.field, None, None, self.boost,
                    kind="exists",
                )
            ]
        )


class PrefixQuery(Query):
    """Matches docs containing any term starting with `prefix`, constant
    score = boost (Lucene PrefixQuery under its default CONSTANT_SCORE
    rewrite; term enumeration via the sorted term dict — the job the
    reference's blocktree FST index does for prefix seeks,
    blocktree_reader.rs:1364). Rides the device filter-plane path."""

    def __init__(self, field: str, prefix: str, boost: float = 1.0):
        self.field = field
        self.prefix = prefix
        self.boost = boost

    def extract_terms(self):
        return []

    def rewrite(self) -> RewrittenQuery:
        return RewrittenQuery(
            ranges=[
                RangeClause(
                    Occur.SHOULD, self.field, None, None, self.boost,
                    kind="prefix", text=self.prefix,
                )
            ]
        )


class BoostingQuery(Query):
    """Demote (not exclude) docs matching `negative`: positive scores are
    multiplied by negative_boost where the negative query matches
    (reference boosting_query.rs:29)."""

    def __init__(self, positive: Query, negative: Query, negative_boost: float):
        self.positive = positive
        self.negative = negative
        self.negative_boost = negative_boost
        self.boost = 1.0

    def extract_terms(self):
        from rucene_tpu_torch.search.host_engine import extract_terms_of

        return extract_terms_of(self.positive) + extract_terms_of(self.negative)

    def rewrite(self) -> RewrittenQuery:
        """Device form: positive's rewritten query plus a demote group —
        weightless presence slots whose match multiplies the row score by
        negative_boost (executor ENC_DEMOTE bits)."""
        try:
            pos = self.positive.rewrite()
            neg = self.negative.rewrite()
        except NotImplementedError:
            raise _NeedsHostEval(self)
        if pos.phrases or not pos.plain:
            raise _NeedsHostEval(self)
        neg_ok = (
            neg.plain
            and not neg.phrases
            and not neg.ranges
            and not neg.groups
            and not neg.match_all
            and neg.clauses
            and all(c.occur == Occur.SHOULD for c in neg.clauses)
        )
        if not neg_ok:
            raise _NeedsHostEval(self)
        pos.demotes = [
            (
                float(self.negative_boost),
                [TermClause(Occur.SHOULD, c.term, c.boost) for c in neg.clauses],
            )
        ]
        return pos

    def host_eval(self, leaf, sim, stats, doc_freqs):
        import numpy as np

        from rucene_tpu_torch.search import host_engine

        pm, ps = host_engine.evaluate_query(leaf, self.positive, sim, stats, doc_freqs)
        nm, _ = host_engine.evaluate_query(leaf, self.negative, sim, stats, doc_freqs)
        scores = np.where(nm, (ps * np.float32(self.negative_boost)).astype(np.float32), ps)
        return pm, scores.astype(np.float32)


class DisjunctionMaxQuery(Query):
    """score = max(sub scores) + tie_breaker * (sum of other sub scores)
    (reference disjunction_max_query.rs / DisjunctionMaxScorer
    disjunction_scorer.rs:111)."""

    def __init__(self, queries: list[Query], tie_breaker: float = 0.0, boost: float = 1.0):
        if not queries:
            raise ValueError("DisjunctionMaxQuery needs sub-queries")
        self.queries = queries
        self.tie_breaker = tie_breaker
        self.boost = boost

    def rewrite(self) -> RewrittenQuery:
        """Device form when every sub is a single scoring term (the
        multi-field search shape): one SHOULD clause per sub with a
        max + tie*(sum-max) combine (executor dismax path). Folding the
        outer boost into member weights is exact: both max and sum scale
        linearly. Multi-clause subs fall back to host_eval."""
        members = []
        for q in self.queries:
            try:
                sq = q.rewrite()
            except NotImplementedError:
                raise _NeedsHostEval(self)
            if (
                len(sq.clauses) != 1
                or sq.clauses[0].occur != Occur.SHOULD
                or sq.phrases
                or sq.ranges
                or sq.groups
                or sq.match_all
                or not sq.plain
            ):
                raise _NeedsHostEval(self)
            c = sq.clauses[0]
            members.append(TermClause(Occur.SHOULD, c.term, c.boost * self.boost))
        return RewrittenQuery(clauses=members, dismax_tie=float(self.tie_breaker))

    def extract_terms(self):
        out = []
        for q in self.queries:
            if hasattr(q, "extract_terms"):
                out.extend(q.extract_terms())
            else:
                rq = q.rewrite()
                out.extend(c.term for c in rq.clauses)
                out.extend(c.term for _, ms in rq.groups for c in ms)
                for f, ts, _boost, _slop in rq.phrases:
                    out.extend(Term(f, t) for t in ts if t is not None)
        return out

    def host_eval(self, leaf, sim, stats, doc_freqs):
        import numpy as np

        from rucene_tpu_torch.search import host_engine

        md = leaf.max_doc
        best = np.zeros(md, dtype=np.float32)
        total = np.zeros(md, dtype=np.float32)
        any_match = np.zeros(md, dtype=bool)
        for q in self.queries:
            m, s = host_engine.evaluate_query(leaf, q, sim, stats, doc_freqs)
            s = np.where(m, s, 0.0).astype(np.float32)
            best = np.maximum(best, s)
            total = (total + s).astype(np.float32)
            any_match |= m
        tie = np.float32(self.tie_breaker)
        score = (best + tie * (total - best)).astype(np.float32)
        score = (score * np.float32(self.boost)).astype(np.float32)
        return any_match, np.where(any_match, score, 0.0).astype(np.float32)


@dataclass
class PointRangeQuery(Query):
    """1-D numeric range over IntPoint/FloatPoint values; constant score =
    boost (reference point_range_query.rs:366, ConstantScoreWeight)."""

    field: str
    lower: int | float | None
    upper: int | float | None
    boost: float = 1.0

    def _encode(self, v):
        if v is None:
            return None
        from rucene_tpu_torch.doc.field import float_to_sortable_int

        if isinstance(v, tuple):
            return tuple(
                None if x is None else (float_to_sortable_int(x) if isinstance(x, float) else int(x))
                for x in v
            )
        if isinstance(v, float):
            return float_to_sortable_int(v)
        return int(v)

    def rewrite(self) -> RewrittenQuery:
        return RewrittenQuery(
            ranges=[
                RangeClause(
                    Occur.SHOULD,
                    self.field,
                    self._encode(self.lower),
                    self._encode(self.upper),
                    self.boost,
                )
            ]
        )


class BooleanQuery(Query):
    """reference boolean_query.rs:29. Clauses must currently be TermQuery /
    PhraseQuery / PointRangeQuery / nested pure-SHOULD BooleanQuery."""

    def __init__(self, min_should_match: int = 0, boost: float = 1.0):
        self.clauses: list[tuple[Occur, Query]] = []
        self.min_should_match = min_should_match
        self.boost = boost

    def add(self, query: Query, occur: Occur) -> "BooleanQuery":
        self.clauses.append((occur, query))
        return self

    # builder conveniences
    def must(self, q: Query) -> "BooleanQuery":
        return self.add(q, Occur.MUST)

    def should(self, q: Query) -> "BooleanQuery":
        return self.add(q, Occur.SHOULD)

    def filter(self, q: Query) -> "BooleanQuery":
        return self.add(q, Occur.FILTER)

    def must_not(self, q: Query) -> "BooleanQuery":
        return self.add(q, Occur.MUST_NOT)

    def extract_terms(self):
        from rucene_tpu_torch.search.host_engine import extract_terms_of

        out = []
        for _, sub in self.clauses:
            out.extend(extract_terms_of(sub))
        return out

    def rewrite(self) -> RewrittenQuery:
        out = RewrittenQuery(min_should_match=self.min_should_match, boost=self.boost)
        for occur, sub in self.clauses:
            de = getattr(sub, "device_equivalent", None)
            if de is not None:
                eq = de()  # span children with exact flat equivalents
                sub = eq if eq is not None else sub
            try:
                sq = sub.rewrite()
            except (_NeedsHostEval, NotImplementedError):
                raise _NeedsHostEval(self)
            if not sq.plain:
                # a 1-member dismax is exactly its term; other nested
                # combines (dismax/const/boosting children) stay host-side
                if (
                    sq.dismax_tie is not None
                    and len(sq.clauses) == 1
                    and sq.const_score is None
                    and not sq.demotes
                    and not sq.phrases
                    and not sq.ranges
                    and not sq.groups
                ):
                    sq.dismax_tie = None
                else:
                    raise _NeedsHostEval(self)
            if sq.match_all:
                if occur in (Occur.MUST, Occur.SHOULD, Occur.FILTER):
                    out.match_all = True  # matches everything; contributes no count
                    continue
                raise _NeedsHostEval(self)  # MUST_NOT match-all: nothing matches (generic path returns empty)
            if sq.ranges and len(sq.ranges) == 1 and not sq.clauses and not sq.phrases:
                r = sq.ranges[0]
                out.ranges.append(
                    dc_replace(r, occur=occur, boost=r.boost * self.boost)
                )
                continue
            if sq.phrases:
                if occur == Occur.MUST_NOT:
                    # the flat executor has no excluded-phrase plane;
                    # the recursive host evaluator applies it exactly
                    raise _NeedsHostEval(self)
                if (
                    sq.clauses or sq.ranges or sq.groups or sq.match_all
                    or any(o != Occur.MUST for o in sq.phrase_occurs)
                ):
                    # phrase-bearing child with more structure: flattening
                    # would drop clauses / garble occurs — evaluate the
                    # boolean generically on the host (recursive, exact)
                    raise _NeedsHostEval(self)
                out.phrases.extend(
                    (f, ts, b * self.boost, sl) for (f, ts, b, sl) in sq.phrases
                )
                out.phrase_occurs.extend([occur] * len(sq.phrases))
                continue
            if len(sq.clauses) == 1 and not sq.phrases:
                c = sq.clauses[0]
                out.clauses.append(TermClause(occur, c.term, c.boost * self.boost))
            elif occur == Occur.SHOULD and sq.n_required == 0 and sq.min_should_match <= 1:
                # flatten nested pure disjunction
                out.clauses.extend(
                    TermClause(Occur.SHOULD, c.term, c.boost * self.boost)
                    for c in sq.clauses
                )
            elif sq.n_required == 0 and sq.min_should_match <= 1 and not sq.phrases:
                # required/excluded pure disjunction -> clause group
                out.groups.append(
                    (
                        occur,
                        [
                            TermClause(Occur.SHOULD, c.term, c.boost * self.boost)
                            for c in sq.clauses
                        ],
                    )
                )
            else:
                raise NotImplementedError(
                    f"nested boolean clause with occur={occur} not supported yet"
                )
        return out

"""IndexSearcher: batched entry point over a point-in-time IndexReader
(counterpart of rucene_tpu/search/searcher.py: the generic flat route with
its filter planes, score-combine rows and match-all rows, the single-term
route, the pair and tf-plane routes, the pure phrase routes, the mixed
phrase rows and the host route).

A batch splits by row kind, as the reference's does:
- device rows: term and boolean rows with at most 8 range clauses, no
  nested clause group, and no match-all beside other clauses (dismax,
  constant-score, boosting and match-all rows among them) go to the device
  path below;
- pure phrase rows (one PhraseQuery of 2-8 terms, MUST or SHOULD, with no
  other clause) and mixed rows (term clauses and up to 8 range clauses
  plus one required exact phrase) go to search/phrase_path.py;
- synonym rows (a SpanOrQuery of plain SpanTermQuery members) go to
  search/filter_path.py's synonym path, and span-near rows over plain
  terms and SpanOr groups of them (unordered, or ordered with slop 0) to
  the span-group route of search/phrase_path.py;
- every other row (a rewrite that needs host evaluation, nested groups,
  more than 8 ranges, match-all beside clauses, a SHOULD, sloppy or
  gapped phrase inside a boolean, a nested span tree) goes to the host
  route: the numpy engine of search/host_engine.py, one leaf at a time
  (span trees through search/span_native.py's C++ evaluator).
A query with a ``device_equivalent`` (SpanTermQuery, an ordered span-near
of plain terms) is planned as that term or phrase row, as the reference's
``_rewrite_query`` does. The device paths are queued before any is
collected, in that order, so the phrase work queues behind the term rows'
kernels, and the host rows run while all of it is in flight. Counters
``route.device``, ``route.phrase``, ``route.mixed``, ``route.synonym``,
``route.span_unordered`` and ``route.host`` count the rows of each. The
batch's host phases are the reference's trace spans (util/metrics.trace):
``search.device.dispatch``, ``search.phrases.dispatch`` and
``search.mixed.dispatch`` around the queueing, and ``search.device``,
``search.phrases``, ``search.mixed``, ``search.synonyms`` and
``search.span_unordered`` around each path's finish in collect().
Inside the device path's spans, stage spans of the port's own (none
inside another of its kind, none adding a device sync): in the dispatch
``search.device.tables`` (statistics, clause tables, row classes, each
leaf's block tables, work lists and plane slots),
``search.device.conj_prune`` (prune_conjunctions),
``search.device.combine_tables`` (build_combine_batch) and
``search.device.launch`` (uploads and executor calls of every route); in
the collect ``search.device.wait`` (each copy of a result to the host)
and ``search.device.merge`` (the rows' hit lists), and where WAND's
second pass reruns rows, its combine tables and launch. The phrase path
has its own (search/phrase_path.py); the mixed, synonym and span paths
keep only their outer spans.

Beside search_batch: search_sorted, search_sorted_early_terminated and
search_collapse (search/sorted_path.py), explain (search/explain.py) and,
for the rescorer, _probe_device (search/filter_path.py).

Device rows run per leaf on the searcher's torch device, over decoded or
packed segments alike; leaf hits merge by (score desc, global doc asc).
Four routes (counters: ``route.single`` and ``route.flat`` rows a batch;
``route.plane_rows`` and ``route.pair_rows`` rows a leaf call, the pair
count without the rows that overflow, as the reference counts them):
- single: a batch of plain term rows (one positive-weight SHOULD clause)
  over leaves without deletes goes to execute_flat_single_dec on a
  decoded leaf, execute_flat_single on a packed one; total_hits is the
  term's doc_freq, so a leaf with deletes keeps such rows generic;
- planes: plain rows of 1-8 term clauses whose every term has a resident
  tf plane in every leaf (codec/device.add_tf_planes, RUCENE_PLANES), and
  whose densest clause has df * PLANE_ROUTE_DIV >= a leaf's doc axis, go
  to execute_planes (single-term rows the single route takes stay there);
- pair: AND2 / OR2 rows of two positive term clauses, when every leaf is
  decoded (RUCENE_PAIR=0 turns the route off), go to execute_flat_pair.
  Rows whose probe-slot count overflows MAXP_CAP in a leaf rerun there on
  the flat executor, merged per row (``search.pair_overflow_rows``, rows
  per leaf), as the reference does;
- flat: everything else, through the generic flat executor. Range,
  exists and prefix clauses ride it as cached filter planes
  (search/filter_path.py); a batch in which some row with ranges has no
  required term clause is not candidate-complete and takes the dense
  branch, whatever else picks the strategy.
On a corpus of SPLIT_MIN_DOCS or more, a mixed batch splits into single,
pure-disjunction, other, pair and plane rows (the reference's row classes
0-4; rows with ranges are "other"), each its own executor call. Below it a
batch takes the planes only if every row may, else the pair route only if
every row may and the batch is not all single-term rows. Packed leaves
have neither tf planes nor the pair route, so their boolean rows stay
generic, as the reference's do. A batch holding a dismax, constant-score
or boosting row takes no tf planes (their RowExtras exist only on the flat
executor), and match-all rows take execute_match_all per leaf, merged over
the flat executor's answer for them. Collection statistics are computed
once per searcher.

``search_batch(timeout_s=)`` checks its deadline between leaves on the
term path and the mixed path; leaves not reached are skipped and
``timed_out`` is set, so results are partial, as the reference's are.

``IndexSearcher(reader, combine_segments=True)`` serves a batch's device
rows over several leaves with one executor call on the reader's combined
view (index/combined.py; _search_device_combined), as the reference does:
not a timed batch (one call cannot be interrupted between leaves, so it
keeps the per-leaf loop), and not the pair or tf-plane routes, which stay
per leaf, as do the phrase, mixed, synonym, span and host paths.

``search_batch(prune=)`` is the reference's block-max WAND
(_run_pruned_view): pass 1 scores each pure disjunction's highest-bound
blocks, up to max(4k, 512) docs a row; the k-th score is a threshold t; a
deferred block whose bound (its own block-max score plus the other
clauses' best blocks, rounded up: _wand_bound) reaches t makes its row
rerun in full in pass 2.
``total_hits`` of a row that did not rerun is a lower bound, as Lucene's
WAND reports it. prune=True forces it (no single, pair or plane route),
False turns it off, and None (the default) engages it per sub-batch by
_auto_prune_decision: 2^22 docs or more (RUCENE_PRUNE_AUTO_MIN_DOCS), k
<= 32, every row a pure disjunction of two or more term clauses, and not
the pair route; RUCENE_PRUNE=0/1 forces the rule. Rows with ranges or
score-combine overrides never prune. Counters: ``search.pruned_blocks``
(deferred blocks whose bound fell below the threshold),
``search.prune_rerun_rows`` (rows pass 2 reran) and
``search.auto_prune_batches``.
search_batch_async queues pass 1; collect() reads its scores (one sync)
and queues pass 2 for the affected rows only.

Left out of the reference: the A/B knobs RUCENE_PLANE_TERMS,
RUCENE_PLANES_ROUTE_DIV, RUCENE_PAIR_PROBE and RUCENE_PAIR_TOPK (the pair
route's probe variant is picked from the batch: one field for both
clauses of every row, or not).
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from typing import NamedTuple

import numpy as np
import torch

from rucene_tpu_torch.index.reader import IndexReader
from rucene_tpu_torch.search.executor import (
    ENC_NOT,
    ENC_REQUIRED,
    ENC_SHOULD,
    PairBatch,
    PlaneBatch,
    RowExtras,
    dense_strategy,
    execute_flat_impl,
    execute_flat_pair,
    execute_flat_single,
    execute_flat_single_dec,
    execute_match_all,
    execute_planes,
)
from rucene_tpu_torch.search.flat_tables import (
    QueryPlan,
    build_clause_tables,
    build_combine_batch,
    build_flat_work,
    build_leaf_cache,
    build_leaf_tables,
    cval_plane_for,
    cval_table_for,
    leaf_rows_for,
    make_flat_batch,
    prune_conjunctions,
)
from rucene_tpu_torch.search import host_engine
from rucene_tpu_torch.search.filter_path import FilterPathMixin, view_filters
from rucene_tpu_torch.search.pair_path import build_pair_work, pair2_eligible
from rucene_tpu_torch.search.phrase_path import PhrasePathMixin
from rucene_tpu_torch.search.plane_path import plane_row_chunk, plane_structural
from rucene_tpu_torch.search.query import (
    BooleanQuery,
    Occur,
    Query,
    RewrittenQuery,
    _NeedsHostEval,
)
from rucene_tpu_torch.search.similarity import BM25Similarity, CollectionStats
from rucene_tpu_torch.search.sorted_path import SortedPathMixin
from rucene_tpu_torch.util.metrics import METRICS, trace

SPLIT_MIN_DOCS = 1 << 19  # corpus size from which mixed batches split by row class
# a row takes the planes when its densest clause has df * PLANE_ROUTE_DIV
# >= the leaf's doc axis: the plane math is O(md) a row whatever the df,
# the lane routes scale with the densest clause's blocks
PLANE_ROUTE_DIV = 512


class ScoreDoc(NamedTuple):
    doc: int  # global doc id (doc_base + segment-local id)
    score: float


class TopDocs:
    """Top-k results; score_docs boxes the merged arrays lazily."""

    __slots__ = ("total_hits", "_docs", "_scores", "_sd")

    def __init__(self, total_hits: int, score_docs: list[ScoreDoc] | None = None,
                 docs=None, scores=None):
        self.total_hits = total_hits
        self._sd = score_docs
        self._docs = docs
        self._scores = scores

    @property
    def score_docs(self) -> list[ScoreDoc]:
        if self._sd is None:
            self._sd = [
                ScoreDoc(d, s)
                for d, s in zip(self._docs.tolist(), self._scores.tolist())
            ]
        return self._sd

    def __repr__(self) -> str:
        return f"TopDocs(total_hits={self.total_hits}, score_docs={self.score_docs})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TopDocs)
            and self.total_hits == other.total_hits
            and self.score_docs == other.score_docs
        )


def device_row(rq: RewrittenQuery | None) -> bool:
    """A row the device path serves (the reference's device rows): a
    rewrite without phrases or nested groups, at most 8 range clauses, and
    no match-all beside other clauses."""
    return (
        rq is not None
        and not rq.phrases
        and not rq.groups
        and len(rq.ranges) <= 8
        and not (rq.match_all and (rq.clauses or rq.ranges))
    )


class IndexSearcher(PhrasePathMixin, SortedPathMixin, FilterPathMixin):
    def __init__(
        self,
        reader: IndexReader,
        similarity: BM25Similarity | None = None,
        device="cuda",
        combine_segments: bool = False,
    ):
        """device: where the reader's segments and every batch live; the
        reader is moved there (IndexReader.to). combine_segments=True
        searches all leaves with one executor call over their combined
        view (index/combined.py): the win case is an NRT index of many
        small segments."""
        self.reader = reader.to(device)
        self.device = torch.device(device)
        self.similarity = similarity or BM25Similarity()
        self.combine_segments = combine_segments
        self._combined = None
        self._stats: dict[str, CollectionStats] = {}
        self._plan_cache: dict[int, QueryPlan] = {}
        self._deadline: float | None = None  # time.monotonic() budget of the batch
        self.timed_out = False  # the last batch skipped leaves past its deadline

    # --- statistics ---
    def collection_stats(self, field: str) -> CollectionStats:
        st = self._stats.get(field)
        if st is None:
            st = self.reader.collection_stats(field)
            self._stats[field] = st
        return st

    # --- public API ---
    def search(self, query: Query, k: int = 10) -> TopDocs:
        return self.search_batch([query], k)[0]

    def count(self, query: Query) -> int:
        return self.search(query, 1).total_hits

    def search_batch(
        self, queries: list[Query], k: int = 10, timeout_s: float | None = None,
        prune: bool | None = None,
    ) -> list[TopDocs]:
        """timeout_s: a wall-clock budget; leaves not reached in time are
        skipped and ``timed_out`` is set (partial results). prune: block-max
        WAND for pure disjunctions, None engaging it by the automatic rule
        (module docstring); pruned rows' total_hits are lower bounds."""
        return self.search_batch_async(queries, k, timeout_s=timeout_s, prune=prune)()

    def search_batch_async(
        self, queries: list[Query], k: int = 10, timeout_s: float | None = None,
        prune: bool | None = None,
    ):
        """Pipelined entry point: queues every device operation of this batch
        now and returns a collect() closure producing the TopDocs. A serving
        loop keeps several batches in flight; the host builds batch N+1's
        tables while the device runs batch N. In-flight batches share no
        timeout state: pass timeout_s only when collecting before the next
        batch is queued.

        RUCENE_STRATEGY=dense|candidate forces an executor branch (A/B)."""
        self._deadline = None if timeout_s is None else time.monotonic() + timeout_s
        self.timed_out = False
        t_start = time.perf_counter()
        METRICS.incr("search.queries", len(queries))
        plans = [self._plan_for(q) for q in queries]
        device_idx = [i for i, p in enumerate(plans) if device_row(p.rq)]
        taken = set(device_idx)
        phrase_idx = [
            i for i, p in enumerate(plans) if i not in taken and self._phrase_device_eligible(p.rq)
        ]
        taken |= set(phrase_idx)
        mixed_idx = [
            i for i, p in enumerate(plans) if i not in taken and self._mixed_device_eligible(p.rq)
        ]
        taken |= set(mixed_idx)
        syn_idx = [
            i for i, q in enumerate(queries)
            if i not in taken and getattr(q, "synonym_terms", None) is not None
            and q.synonym_terms() is not None
        ]
        taken |= set(syn_idx)
        spanu_idx = [
            i for i, q in enumerate(queries)
            if i not in taken and self._span_unordered_eligible(q)
        ]
        taken |= set(spanu_idx)
        host_idx = [i for i in range(len(plans)) if i not in taken]
        METRICS.incr("route.device", len(device_idx))
        METRICS.incr("route.phrase", len(phrase_idx))
        METRICS.incr("route.mixed", len(mixed_idx))
        METRICS.incr("route.synonym", len(syn_idx))
        METRICS.incr("route.span_unordered", len(spanu_idx))
        METRICS.incr("route.host", len(host_idx))
        # queue every device path before collecting any, in the reference's
        # order: the phrase, mixed, synonym and span work queues behind the
        # term rows' kernels, and the scalar phrase rows and the host rows
        # run on the host while all of it is in flight. The trace spans are
        # the reference's: one around each of the first three dispatches,
        # one around each path's finish in collect() (the host rows have
        # none)
        paths = []  # (row indices, finish, collect span or None)
        if device_idx:
            with trace("search.device.dispatch"):
                finish = self._search_device(
                    [plans[i].rq for i in device_idx], k, [plans[i] for i in device_idx],
                    prune=prune,
                )
            paths.append((device_idx, finish, "search.device"))
        if phrase_idx:
            with trace("search.phrases.dispatch"):
                finish = self._search_phrases_device(
                    [queries[i] for i in phrase_idx], [plans[i].rq for i in phrase_idx], k,
                    _defer=True,
                )
            paths.append((phrase_idx, finish, "search.phrases"))
        if mixed_idx:
            with trace("search.mixed.dispatch"):
                finish = self._search_mixed_device(
                    [queries[i] for i in mixed_idx], [plans[i].rq for i in mixed_idx], k,
                    _defer=True,
                )
            paths.append((mixed_idx, finish, "search.mixed"))
        if syn_idx:
            paths.append((syn_idx, self._search_synonym_device(
                [queries[i] for i in syn_idx], k, _defer=True
            ), "search.synonyms"))
        if spanu_idx:
            paths.append((spanu_idx, self._search_span_unordered_device(
                [queries[i] for i in spanu_idx], k, _defer=True
            ), "search.span_unordered"))
        if host_idx:
            host_hits = [self._search_host(queries[i], k) for i in host_idx]
            paths.append((host_idx, lambda: host_hits, None))

        def collect() -> list[TopDocs]:
            out: list[TopDocs | None] = [None] * len(queries)
            for idx, finish, span in paths:
                with trace(span) if span else nullcontext():
                    hits = finish()
                for i, td in zip(idx, hits):
                    out[i] = td
            METRICS.observe("search.batch", time.perf_counter() - t_start)
            return out  # type: ignore[return-value]

        return collect

    def _combined_view(self):
        if self._combined is None:
            from rucene_tpu_torch.index.combined import cached_combined_view

            self._combined = cached_combined_view(self.reader.leaves, self.device)
        return self._combined

    def _past_deadline(self) -> bool:
        if self._deadline is not None and time.monotonic() > self._deadline:
            self.timed_out = True
            return True
        return False

    # --- shared helpers ---
    @staticmethod
    def _rewrite_query(q) -> RewrittenQuery | None:
        """The row form of a query: its device_equivalent's rewrite where it
        has one (a SpanTermQuery is a term row, an ordered span-near of
        plain terms a phrase row), else its own; None when it needs host
        evaluation."""
        de = getattr(q, "device_equivalent", None)
        if de is not None:
            eq = de()
            if eq is not None:
                return eq.rewrite()
        try:
            return q.rewrite()
        except (_NeedsHostEval, NotImplementedError):
            return None

    def _plan_for(self, q) -> QueryPlan:
        pc = self._plan_cache
        ent = pc.get(id(q))
        if ent is not None and ent.q is q:
            return ent
        plan = QueryPlan(q, self._rewrite_query(q))
        if len(pc) >= 16384:  # bounded: drop the oldest quarter
            for key in list(pc.keys())[:4096]:
                pc.pop(key, None)
        pc[id(q)] = plan
        return plan

    def _gather_stats(self, rqs: list[RewrittenQuery], plans=None):
        doc_freqs: dict[tuple[str, str], int] = {}
        fields: set[str] = set()
        for idx, rq in enumerate(rqs):
            plan = plans[idx] if plans is not None else None
            terms = plan.stats_terms if plan is not None else None
            if terms is None:
                group_clauses = [c for _, members in rq.groups for c in members]
                terms = [(c.term.field, c.term.text) for c in list(rq.clauses) + group_clauses]
                terms += [(f, t) for f, ph_terms, _b, _s in rq.phrases for t in ph_terms if t is not None]
                if plan is not None:
                    plan.stats_terms = terms
            for key in terms:
                fields.add(key[0])
                if key not in doc_freqs:
                    doc_freqs[key] = self.reader.doc_freq(*key)  # memoized
            fields.update(f for f, _t, _b, _s in rq.phrases)
        stats = {f: self.collection_stats(f) for f in fields}
        return doc_freqs, stats

    def _merge_leaf_hits(
        self, per_leaf: list[tuple[int, np.ndarray, np.ndarray, int]], k: int
    ) -> TopDocs:
        """per_leaf: (doc_base, local_docs, scores, hits). Order by
        (score desc, global doc asc)."""
        total = sum(h for _, _, _, h in per_leaf)
        if not per_leaf:
            return TopDocs(0, [])
        if len(per_leaf) == 1:
            # executor rows are already (score desc, doc asc) with -inf
            # padding at the tail: no re-sort needed for a single leaf
            base, d, sc, _h = per_leaf[0]
            m = min(int((sc > -np.inf).sum()), k)
            return TopDocs(
                total_hits=total,
                docs=base + d[:m].astype(np.int64),
                scores=sc[:m],
            )
        gdocs = np.concatenate([base + d.astype(np.int64) for base, d, _, _ in per_leaf])
        scores = np.concatenate([s for _, _, s, _ in per_leaf])
        keep = scores > -np.inf
        gdocs, scores = gdocs[keep], scores[keep]
        order = np.lexsort((gdocs, -scores))[:k]
        return TopDocs(
            total_hits=total, docs=gdocs[order], scores=scores[order]
        )

    # --- device path ---
    @staticmethod
    def _pure_row(rq, wrow) -> bool:
        """All-SHOULD positive-weight row of term clauses only, with
        min_should <= 1: it matches exactly where its score is > 0, so it
        needs no clause counts."""
        return (
            rq.n_required == 0
            and rq.effective_min_should() <= 1
            and not rq.match_all
            and not rq.ranges
            and rq.plain
            and bool(rq.clauses)
            and all(c.occur == Occur.SHOULD for c in rq.clauses)
            and all(wrow[j] > 0 for j in range(len(rq.clauses)))
        )

    def _auto_prune_decision(self, rqs, k: int) -> bool:
        """The reference's rule for prune=None: every row a pure positive
        disjunction of two or more plain term clauses, at least
        RUCENE_PRUNE_AUTO_MIN_DOCS docs (2^22) and k <= 32;
        RUCENE_PRUNE=0/1 forces it."""
        env = os.environ.get("RUCENE_PRUNE")
        if env in ("0", "1"):
            return env == "1"
        total = sum(lf.max_doc for lf in self.reader.leaves)
        min_docs = int(os.environ.get("RUCENE_PRUNE_AUTO_MIN_DOCS", 1 << 22))
        if total < min_docs or k > 32:
            return False
        return all(
            rq.n_required == 0
            and rq.effective_min_should() <= 1
            and rq.plain
            and not rq.match_all
            and not rq.ranges
            and len(rq.clauses) >= 2
            and all(c.occur == Occur.SHOULD for c in rq.clauses)
            for rq in rqs
        )

    def _search_device(self, rqs: list[RewrittenQuery], k: int, plans, _stats=None,
                       prune: bool | None = None):
        """Queue one executor call per leaf; return finish() -> TopDocs.
        prune routes as the reference's does: off for a batch with
        score-combine overrides or ranges, no single, pair or plane route
        under prune=True, and None decided per sub-batch after the split."""
        sim = self.similarity
        b = len(rqs)
        with trace("search.device.tables"):
            doc_freqs, stats = _stats if _stats is not None else self._gather_stats(rqs, plans)
            t = max(max((len(rq.all_slots()) for rq in rqs), default=1), 1)
            weight, occur, n_required, min_should, match_all_rows, boosts = build_clause_tables(
                rqs, sim, doc_freqs, stats, b, t, plans=plans
            )
            plain = all(rq.plain for rq in rqs)
            if not plain:
                prune = False  # WAND bounds do not model the score-combine overrides
            pure_rows = [self._pure_row(rq, weight[i]) for i, rq in enumerate(rqs)]
            # total_hits of a single-term row is its doc_freq: exact only
            # when no leaf has deletes
            no_deletes = all(lf.live is None for lf in self.reader.leaves)
            single_rows = [
                p and no_deletes and len(rq.clauses) == 1 for p, rq in zip(pure_rows, rqs)
            ]
            pair_rows = self._pair_rows(rqs, weight) if prune is not True else [False] * b
            # RowExtras exist only on the flat executor: a batch holding a
            # dismax, constant-score or boosting row takes no tf planes
            plane_rows = (
                self._plane_rows(rqs, plans, single_rows) if plain and prune is not True
                else [False] * b
            )
            if any(rq.ranges for rq in rqs):
                prune = False  # nor the filter planes' constant scores

            # large corpora: split by row class (the reference's classes 0-4)
            # so single-term rows skip the combine, pure disjunctions skip the
            # clause counts, and pair and plane rows take their own routes
            cls = [
                4 if pl else 0 if s and not prune else 3 if pr else 1 if p else 2
                for s, p, pr, pl in zip(single_rows, pure_rows, pair_rows, plane_rows)
            ]
        if (
            b > 1
            and len(set(cls)) > 1
            and sum(lf.max_doc for lf in self.reader.leaves) >= SPLIT_MIN_DOCS
        ):
            groups = [[i for i, c in enumerate(cls) if c == g] for g in sorted(set(cls))]
            starters = [
                (idxs, self._search_device(
                    [rqs[i] for i in idxs], k, [plans[i] for i in idxs],
                    _stats=(doc_freqs, stats), prune=prune,
                ))
                for idxs in groups
            ]

            def finish_split() -> list[TopDocs]:
                out: list[TopDocs | None] = [None] * b
                for idxs, finish in starters:
                    for i, r in zip(idxs, finish()):
                        out[i] = r
                return out  # type: ignore[return-value]

            return finish_split

        with trace("search.device.tables"):
            # range clauses ride as filter planes: a batch in which a doc may
            # match through its ranges alone has no candidate lane for it, so
            # it takes the dense branch whatever else picks the strategy
            filter_tables, strategy = None, os.environ.get("RUCENE_STRATEGY", "auto")
            if any(rq.ranges for rq in rqs):
                filter_tables = self._range_filter_tables(rqs, b)
                if not self._ranges_complete(rqs):
                    strategy = "dense"
            # conjunction pruning intersects required term clauses only: a
            # range meets its requirement through its plane, not lanes
            n_required_terms = np.array(
                [sum(c.occur in (Occur.MUST, Occur.FILTER) for c in rq.clauses) for rq in rqs],
                np.int32,
            )
            pure = all(pure_rows)
            # a match-all row has no clause, so it is never single (nor pure,
            # pair or plane): a batch holding one takes the flat executor
            single = all(single_rows) and not prune
            plane = all(plane_rows)
            pair2 = all(pair_rows) and not single and not plane
            if prune is None:
                prune = (not pair2) and self._auto_prune_decision(rqs, k)
                if prune:
                    METRICS.incr("search.auto_prune_batches")
            if not (plane or pair2):  # those two count per leaf call
                METRICS.incr("route.single" if single else "route.flat", b)
        extras, with_dismax, boosts_t = None, False, None
        if not plain or match_all_rows.any():  # the rows' extras and match-all boosts go up
            with trace("search.device.launch"):
                if not plain:
                    extras, with_dismax = _row_extras(rqs, self.device)
                if match_all_rows.any():
                    boosts_t = _put(boosts, self.device, np.float32)
        if (
            self.combine_segments and len(self.reader.leaves) > 1
            and self._deadline is None and not pair2 and not plane
        ):
            return self._search_device_combined(
                rqs, k, stats, weight, occur, n_required, min_should, match_all_rows,
                boosts_t, t, pure, single, filter_tables, strategy, n_required_terms,
                extras, with_dismax, prune,
            )
        pending = []  # (doc_base, result, match-all result or None)
        for leaf in self.reader.leaves:
            if self._past_deadline():
                break  # partial results: the leaves left are skipped
            with trace("search.device.tables"):
                cache = build_leaf_cache(leaf, sim, stats)
                # the flat work list, unless the planes, the pair route or
                # the decoded single route take the batch
                flat = not (plane or pair2 or (single and leaf.device.docs_dec is not None))
                if not plane:
                    block_start, block_count, field_id = build_leaf_tables(
                        leaf, rqs, b, t, plans=plans
                    )
                if single:
                    lane_cnt = np.array(
                        [leaf_rows_for(leaf, rq, plans[i])["df"][0] for i, rq in enumerate(rqs)],
                        np.int32,
                    )
                if flat:
                    work = build_flat_work(block_start, block_count, weight, field_id, occur)
                    filters = self._leaf_filters(leaf, *filter_tables) if filter_tables else None
            if plane:
                res = self._run_planes(
                    leaf, rqs, weight, occur, cache, n_required, min_should, k, plans
                )
                pending.append((leaf.doc_base, res, None))
                continue
            if pair2:
                res = self._run_pair(
                    leaf, rqs, weight, field_id, block_start, block_count, cache,
                    n_required, min_should, occur, k,
                )
                pending.append((leaf.doc_base, res, None))
                continue
            if not flat:  # single, on a decoded leaf
                res = self._run_single_dec(
                    leaf, block_start[:, 0], block_count[:, 0], weight[:, 0], lane_cnt, cache, k,
                )
                pending.append((leaf.doc_base, res, None))
                continue
            with trace("search.device.conj_prune"):
                work, _ = prune_conjunctions(
                    work, n_required_terms, (leaf.packed.blk_first_doc, leaf.packed.blk_last_doc),
                )
            if single:
                res = self._run_single_view(
                    leaf.device, work, lane_cnt, cache, n_required, min_should, k
                )
            elif prune:
                res = self._run_pruned_view(
                    leaf.device, _blk_ranges(leaf), leaf.packed.blk_max_freq, work, cache,
                    n_required, min_should, k, pure,
                )
            else:
                res = self._run_work(
                    leaf.device, _blk_ranges(leaf), work[:6], cache, n_required, min_should, k,
                    pure, extras, with_dismax, filters=filters, strategy=strategy,
                )
            ma = None
            if boosts_t is not None:
                with trace("search.device.launch"):
                    ma = execute_match_all(leaf.device, boosts_t, k)
            pending.append((leaf.doc_base, res, ma))

        def finish() -> list[TopDocs]:
            got = [(doc_base, _host_result(res), None if ma is None else _host_result(ma))
                   for doc_base, res, ma in pending]
            with trace("search.device.merge"):
                per_query_leaf: list[list] = [[] for _ in range(b)]
                for doc_base, (s, d, h), ma in got:
                    if ma is not None:
                        ms, mdoc, mh = ma
                        s = np.where(match_all_rows[:, None], ms, s)
                        d = np.where(match_all_rows[:, None], mdoc, d)
                        h = np.where(match_all_rows, mh, h)
                    for i in range(b):
                        per_query_leaf[i].append((doc_base, d[i], s[i], int(h[i])))
                return [self._merge_leaf_hits(per_query_leaf[i], k) for i in range(b)]

        return finish

    def _pair_rows(self, rqs, weight) -> list[bool]:
        """Rows the pair route may take (the reference's pair2 flag): two
        positive term clauses, AND2 or OR2 (pair_path.pair2_eligible),
        with every leaf decoded; RUCENE_PAIR=0 turns the route off."""
        if os.environ.get("RUCENE_PAIR", "1") == "0" or not all(
            lf.device.docs_dec is not None for lf in self.reader.leaves
        ):
            return [False] * len(rqs)
        return [pair2_eligible(rq, weight[i]) for i, rq in enumerate(rqs)]

    def _plane_rows(self, rqs, plans, single_rows) -> list[bool]:
        """Rows the tf-plane route takes: every leaf holds planes, the row
        is plain with 1-8 term clauses (plane_path.plane_structural), every
        term present in a leaf has a plane row there, and in some leaf the
        densest clause has df * PLANE_ROUTE_DIV >= the doc axis
        (RUCENE_PLANES=1 waives that, for tests). A single-term row the
        single route takes stays there. Cached on the plan."""
        leaves = self.reader.leaves
        if not all(lf.device.tf_planes is not None and lf.plane_slots for lf in leaves):
            return [False] * len(rqs)
        force = os.environ.get("RUCENE_PLANES") == "1"
        out = []
        for i, rq in enumerate(rqs):
            plan = plans[i] if plans else None
            pl = plan.flags.get("plane") if plan is not None else None
            if pl is None:
                pl, hot = plane_structural(rq), False
                for lf in leaves if pl else ():
                    row = leaf_rows_for(lf, rq, plan)
                    if not row["plane_ok"]:
                        pl = False
                        break
                    if len(row["df"]) and int(row["df"].max()) * PLANE_ROUTE_DIV >= lf.device.max_doc_padded:
                        hot = True
                pl = pl and (hot or force)
                if plan is not None:
                    plan.flags["plane"] = pl
            out.append(pl and (len(rq.clauses) >= 2 or not single_rows[i]))
        return out

    def _run_planes(self, leaf, rqs, weight, occur, cache, n_required, min_should, k, plans):
        """Dense tf-plane calls (executor.execute_planes) for a leaf, in
        row chunks whose peak stays within plane_path.plane_row_chunk's
        budget."""
        dev = leaf.device
        b, t = weight.shape
        with trace("search.device.tables"):
            slot = np.full((b, t), -1, np.int32)
            fid = np.zeros((b, t), np.int32)
            for i, rq in enumerate(rqs):
                row = leaf_rows_for(leaf, rq, plans[i] if plans else None)
                n = len(row["pslot"])
                slot[i, :n] = row["pslot"]
                fid[i, :n] = row["fid"]
            # occur -> count encoding, inert where the slot is (padding, or a
            # term absent from this leaf: a required one then matches nothing)
            kind = np.select(
                [(occur == int(Occur.MUST)) | (occur == int(Occur.FILTER)),
                 occur == int(Occur.SHOULD), occur == int(Occur.MUST_NOT)],
                [ENC_REQUIRED, ENC_SHOULD, ENC_NOT], 0,
            )
            on = slot >= 0
            kind = np.where(on, kind, 0)
            fids = np.unique(fid[on])
            same_fid = int(fids[0]) if len(fids) == 1 else (0 if len(fids) == 0 else -1)
        METRICS.incr("route.plane_rows", b)
        with trace("search.device.launch"):
            cvp = cval_plane_for(dev, cache)
            d = dev.device
            parts = []
            rows_per = plane_row_chunk(b, dev.max_doc_padded)
            for s in range(0, b, rows_per):
                e = s + rows_per
                pb = PlaneBatch(
                    slot=_put(slot[s:e], d), kindenc=_put(kind[s:e], d),
                    weight=_put(weight[s:e], d, np.float32), fid=_put(fid[s:e], d),
                    n_required=_put(n_required[s:e], d), min_should=_put(min_should[s:e], d),
                )
                parts.append(execute_planes(dev.tf_planes, cvp, dev.live, pb, k, same_fid))
            if len(parts) == 1:
                return parts[0]
            return tuple(torch.cat(x) for x in zip(*parts))

    def _run_pair(self, leaf, rqs, weight, field_id, block_start, block_count, cache,
                  n_required, min_should, occur, k):
        """Pair-gallop call (executor.execute_flat_pair) for a leaf's AND2 /
        OR2 rows. Rows whose probe-slot count overflows MAXP_CAP rerun on
        the flat executor (their block counts only), merged per row."""
        dev = leaf.device
        d = dev.device
        with trace("search.device.tables"):
            work, ph, bad_rows = build_pair_work(
                leaf, rqs, weight, field_id, block_start, block_count, len(rqs)
            )
        METRICS.incr("route.pair_rows", len(rqs) - len(bad_rows))
        with trace("search.device.launch"):
            q = make_flat_batch(work, n_required, min_should, cache, dev)
            max_p = ph.pop("max_lanes_p") // 128
            max_s = ph.pop("max_lanes_s") // 128
            pb = PairBatch(**{name: _put(a, d, a.dtype) for name, a in ph.items()})
            same_field = all(rq.clauses[0].term.field == rq.clauses[1].term.field for rq in rqs)
            res = execute_flat_pair(
                dev, q, pb, k, max_p, max_s, with_live=leaf.live is not None,
                same_field=same_field,
            )
        if not bad_rows:
            return res
        METRICS.incr("search.pair_overflow_rows", len(bad_rows))
        bad = np.zeros(len(rqs), bool)
        bad[bad_rows] = True
        with trace("search.device.tables"):
            work2 = build_flat_work(
                block_start, np.where(bad[:, None], block_count, 0), weight, field_id, occur
            )
        res2 = self._run_work(
            dev, _blk_ranges(leaf), work2[:6], cache, n_required, min_should, k, False
        )
        with trace("search.device.launch"):
            bad_t = _put(bad, d, np.bool_)
            return tuple(
                torch.where(bad_t[:, None] if x.dim() == 2 else bad_t, y, x)
                for x, y in zip(res, res2)
            )

    def _run_single_view(self, dev, work, lane_cnt, cache, n_required, min_should, k):
        """Single-term rows over a leaf's flat work list (a packed leaf's
        route, through the scoring decode): per-row top-k over the row's
        own item extent (executor.execute_flat_single)."""
        wi_row, n = work[1], work[6]
        with trace("search.device.launch"):
            rows = np.arange(len(lane_cnt))
            starts = np.searchsorted(wi_row[:n], rows)
            counts = np.searchsorted(wi_row[:n], rows, side="right") - starts
            q = make_flat_batch(work, n_required, min_should, cache, dev, dedupe=True)
            return execute_flat_single(
                dev, q, _put(starts, dev.device), _put(counts, dev.device),
                _put(lane_cnt, dev.device), k, max(int(counts.max()), 1),
            )

    def _run_single_dec(self, leaf, bs, bc, w_row, lane_cnt, cache, k):
        """Single-term rows on a decoded leaf: the work list is expanded on
        the device from per-row block ranges
        (executor.execute_flat_single_dec)."""
        dev = leaf.device
        with trace("search.device.launch"):
            return execute_flat_single_dec(
                dev, cval_table_for(dev, cache), _put(bs, dev.device), _put(bc, dev.device),
                _put(w_row, dev.device, np.float32), _put(lane_cnt, dev.device), int(bc.sum()),
                k, max(int(bc.max()), 1),
            )

    @staticmethod
    def _run_work(dev, blk_ranges, arrays, cache, n_required, min_should, k, pure,
                  extras=None, with_dismax=False, filters=None, strategy=None):
        """One executor call for a work list over ``dev`` (a leaf's device
        form, or a combined view's), whose blocks span ``blk_ranges`` (host
        first and last docs a block). strategy: the executor branch
        ("auto", "dense" or "candidate"; None reads RUCENE_STRATEGY)."""
        if strategy is None:
            strategy = os.environ.get("RUCENE_STRATEGY", "auto")
        n_items = len(arrays[0])
        dense = dense_strategy(len(n_required), dev.max_doc_padded, n_items, strategy)
        with trace("search.device.launch"):
            q = make_flat_batch(arrays, n_required, min_should, cache, dev, dedupe=True)
        combine = None
        if dense:
            with trace("search.device.combine_tables"):
                combine = build_combine_batch(
                    arrays, len(n_required), *blk_ranges, dev.max_doc_padded, dev.device,
                    q=q, buckets=dev.buckets,
                )
        with trace("search.device.launch"):
            return execute_flat_impl(
                dev, q, k, pure_disjunction=pure, combine=combine, extras=extras,
                with_dismax=with_dismax, filters=filters,
            )

    def _run_pruned_view(self, dev, blk_ranges, blk_max_freq, work, cache, n_required,
                         min_should, k, pure):
        """Block-max WAND, two passes, over a leaf's or a combined view's
        work list (the reference's host numpy, save that a segment without
        blocks bounds nothing, where the reference's indexing raises, and
        that the bound is rounded up, _wand_bound). Pass 1 scores each
        prunable row's highest-bound items until max(4k, 512) docs;
        its k-th score t is a lower bound of the true k-th. A deferred item
        can hold a top-k doc only if its bound (the item's block-max score
        plus every other clause's best) is >= t (ties kept); rows with such
        an item rerun in full. Returns the executor's tensors when nothing
        is deferred, else a callable that reads pass 1 (one sync), queues
        pass 2 for the affected rows and returns host (scores, docs,
        hits); total_hits of an unaffected row is a lower bound."""
        wi_block, wi_row, wi_weight, wi_fid, wi_enc, wi_valid, n_items, wi_tslot = work
        w = len(wi_block)
        b_rows = len(n_required)
        n_blocks = len(blk_max_freq)
        with trace("search.device.tables"):
            # upper bound per item: w * bmf / (bmf + the field's least cache value)
            bmf = blk_max_freq[np.clip(wi_block, 0, max(n_blocks - 1, 0))].astype(
                np.float32
            ) if n_blocks else np.zeros(w, np.float32)
            cval_min = cache.min(axis=1)[np.clip(wi_fid, 0, cache.shape[0] - 1)]
            with np.errstate(invalid="ignore"):
                ub = np.where(wi_valid, wi_weight * bmf / (bmf + cval_min), -np.inf)

            bound = _wand_bound(ub, wi_row, wi_tslot, wi_valid, b_rows)

            # prunable rows: pure disjunction, min_should <= 1
            prunable_rows = (n_required == 0) & (min_should <= 1)
            item_prunable = prunable_rows[wi_row] & wi_valid & (wi_enc == ENC_SHOULD)

            # pass-1 selection: per row, highest-ub items until >= 4k docs seen
            order = np.lexsort((-ub, wi_row))  # by row, ub desc
            cnt_sorted = np.where(item_prunable[order], 128, 0)
            row_sorted = wi_row[order]
            csum = np.cumsum(cnt_sorted)
            row_start = np.searchsorted(row_sorted, row_sorted, side="left")
            within = csum - csum[row_start] + cnt_sorted[row_start]
            keep_sorted = within <= max(4 * k, 512)
            pass1 = np.ones(w, dtype=bool)
            pass1[order[item_prunable[order] & ~keep_sorted]] = False  # deferred items
            pass1 &= wi_valid

        if pass1.sum() == wi_valid.sum():  # nothing to prune
            return self._run_work(dev, blk_ranges, work[:6], cache, n_required, min_should, k,
                                  pure)
        res1 = self._run_work(dev, blk_ranges, _subset_work(work, pass1), cache, n_required,
                              min_should, k, pure)

        def finish():
            s1, d1, h1 = _host_result(res1)
            t = s1[:, k - 1]
            deferred = (~pass1) & wi_valid
            survivors = deferred & (bound >= t[wi_row])
            affected = np.zeros(b_rows, dtype=bool)
            affected[wi_row[survivors]] = True
            METRICS.incr("search.pruned_blocks", int((deferred & ~survivors).sum()))
            METRICS.incr("search.prune_rerun_rows", int(affected.sum()))
            if not affected.any():
                return s1, d1, h1
            # the affected rows rerun with their full work lists
            sub2 = _subset_work(work, wi_valid & affected[wi_row])
            s2, d2, h2 = _host_result(self._run_work(
                dev, blk_ranges, sub2, cache, n_required, min_should, k, pure
            ))
            return (np.where(affected[:, None], s2, s1), np.where(affected[:, None], d2, d1),
                    np.where(affected, h2, h1))

        return finish

    def _search_device_combined(
        self, rqs, k, stats, weight, occur, n_required, min_should, match_all_rows,
        boosts_t, t, pure, single, filter_tables, strategy, n_required_terms, extras,
        with_dismax, prune,
    ):
        """Every leaf in ONE executor call over the combined view: each
        (row, clause) takes one block range per leaf (build_combined_tables);
        conjunction pruning groups a clause's blocks across leaves. Returns
        finish() -> TopDocs."""
        from rucene_tpu_torch.index.combined import build_combined_tables

        leaves = self.reader.leaves
        sim = self.similarity
        b = len(rqs)
        with trace("search.device.tables"):
            view = self._combined_view()
            cache = np.zeros((max(len(view.field_gid), 1), 256), np.float32)
            for name, g in view.field_gid.items():
                has_norms = any(name in leaf.packed.norms for leaf in leaves)
                cache[g] = sim.cache_row(stats.get(name) if has_norms else None)
            block_start, block_count, field_id = build_combined_tables(view, leaves, rqs, b, t)
            length = view.n_leaves
            work = build_flat_work(
                block_start, block_count, np.repeat(weight, length, axis=1), field_id,
                np.repeat(occur, length, axis=1),
            )
            # tslot -> clause id: a clause's blocks in every leaf intersect as one
            work = work[:7] + (work[7] // length,)
            blk_ranges = (view.blk_first_host, view.blk_last_host)
            if single:
                # one clause a row; its items span every leaf, ascending in the
                # view's doc space, so the single-term lane path applies
                lane_cnt = np.zeros(b, np.int32)
                for i, rq in enumerate(rqs):
                    c = rq.clauses[0]
                    for leaf in leaves:
                        rec = leaf.term_record(c.term.field, c.term.text)
                        if rec is not None:
                            lane_cnt[i] += rec.doc_freq
            filters = (
                view_filters(view, leaves, *filter_tables) if filter_tables else None
            )
        with trace("search.device.conj_prune"):
            work, _ = prune_conjunctions(work, n_required_terms, blk_ranges)
        dev = view.device
        if single:
            res = self._run_single_view(dev, work, lane_cnt, cache, n_required, min_should, k)
        elif prune:
            res = self._run_pruned_view(
                dev, blk_ranges, view.blk_max_freq, work, cache, n_required, min_should, k, pure,
            )
        else:
            res = self._run_work(
                dev, blk_ranges, work[:6], cache, n_required, min_should, k, pure, extras,
                with_dismax, filters=filters, strategy=strategy,
            )
        ma = None
        if boosts_t is not None:
            with trace("search.device.launch"):
                ma = execute_match_all(dev, boosts_t, k)

        def finish() -> list[TopDocs]:
            s, d, h = _host_result(res)
            ma_host = None if ma is None else _host_result(ma)
            with trace("search.device.merge"):
                if ma_host is not None:
                    ms, mdoc, mh = ma_host
                    s = np.where(match_all_rows[:, None], ms, s)
                    d = np.where(match_all_rows[:, None], mdoc, d)
                    h = np.where(match_all_rows, mh, h)
                out = []
                for i in range(b):
                    keep = s[i] > -np.inf
                    out.append(TopDocs(
                        total_hits=int(h[i]), docs=view.map_docs(d[i][keep], leaves),
                        scores=s[i][keep],
                    ))
                return out

        return finish

    # --- explain (Weight::explain, term_query.rs:183-215) ---
    def explain(self, query: Query, doc: int):
        """The score explanation tree of ``query`` at global ``doc``
        (search/explain.py): its value equals the score search returns."""
        from rucene_tpu_torch.search.explain import explain as _explain

        return _explain(self, query, doc)

    # --- host route ---
    def _search_host(self, query: Query, k: int) -> TopDocs:
        """One row through the numpy host engine, leaf by leaf (the
        reference's host path: host_engine.evaluate_query, then the
        (score desc, doc asc) top-k of each leaf, merged). A boolean whose
        flat rewrite refuses a nested clause with required members (the
        reference raises NotImplementedError there) is evaluated clause by
        clause with the generic boolean evaluator, which is exact."""
        doc_freqs, stats = self._gather_stats_query(query)
        sim = self.similarity
        per_leaf = []
        for leaf in self.reader.leaves:
            try:
                match, acc = host_engine.evaluate_query(leaf, query, sim, stats, doc_freqs)
            except NotImplementedError:
                if not isinstance(query, BooleanQuery):
                    raise
                match, acc = host_engine._evaluate_boolean_generic(
                    leaf, query, sim, stats, doc_freqs
                )
            hits = host_engine.hits_from_dense(leaf, match, acc, k)
            per_leaf.append((leaf.doc_base, hits.docs, hits.scores, hits.total_hits))
        return self._merge_leaf_hits(per_leaf, k)

    def _gather_stats_query(self, query: Query):
        """Statistics for any query: the terms it names (extract_terms, as
        Weight::extract_terms does), else those of its rewrite."""
        if hasattr(query, "extract_terms"):
            doc_freqs: dict[tuple[str, str], int] = {}
            for t in query.extract_terms():
                key = (t.field, t.text)
                if key not in doc_freqs:
                    doc_freqs[key] = self.reader.doc_freq(*key)
            return doc_freqs, {f: self.collection_stats(f) for f, _t in doc_freqs}
        try:
            return self._gather_stats([query.rewrite()])
        except _NeedsHostEval:
            return {}, {}


def _row_extras(rqs, device) -> tuple[RowExtras, bool]:
    """The batch's RowExtras on ``device`` and whether a row is a dismax
    row."""
    b = len(rqs)
    dm_tie = np.full(b, -1.0, np.float32)
    const_on = np.zeros(b, bool)
    const_val = np.zeros(b, np.float32)
    demote = np.ones(b, np.float32)
    for i, rq in enumerate(rqs):
        if rq.dismax_tie is not None:
            dm_tie[i] = rq.dismax_tie
        if rq.const_score is not None:
            const_on[i] = True
            const_val[i] = rq.const_score
        if rq.demotes:
            demote[i] = rq.demotes[0][0]
    extras = RowExtras(
        dm_tie=_put(dm_tie, device, np.float32), const_on=_put(const_on, device, np.bool_),
        const_val=_put(const_val, device, np.float32), demote=_put(demote, device, np.float32),
    )
    return extras, bool((dm_tie >= 0).any())


def _wand_bound(ub, wi_row, wi_tslot, wi_valid, b_rows):
    """f32[W]: the most a doc in item i can score, its item's upper bound
    ub[i] plus every other clause's best-block bound, rounded up so that
    no f32 sum of the row's clause scores, in any order, exceeds it. The
    reference sums in f32 and subtracts the item's clause back out
    (``row_sum - clause_max``), which can round below the true sum of the
    other clauses: a doc that ties the pass-1 k-th score at a lower doc id
    is then pruned (ROADMAP.md §3). Here the sums are taken in f64 (exact
    to far below an f32 ULP for the few clauses of a row) and widened by
    one f32 rounding a clause before the cast, then one ULP up."""
    t_slots = int(wi_tslot.max()) + 1 if len(ub) else 1
    clause_maxub = np.full((b_rows, t_slots), -np.inf, np.float32)
    np.maximum.at(clause_maxub, (wi_row, wi_tslot), np.where(wi_valid, ub, -np.inf))
    finite = np.isfinite(clause_maxub)
    clause_maxub_pos = np.where(finite, clause_maxub, 0.0).astype(np.float64)
    others = clause_maxub_pos.sum(axis=1)[wi_row] - clause_maxub_pos[wi_row, wi_tslot]
    n_terms = finite.sum(axis=1)[wi_row]
    with np.errstate(invalid="ignore"):
        wide = (ub.astype(np.float64) + others) * (1.0 + n_terms * 2.0**-23)
    return np.nextafter(wide.astype(np.float32), np.float32(np.inf))


def _subset_work(work, mask):
    """The masked items of a work list, as its first six arrays (at least
    one item: an invalid one when the mask is empty)."""
    idx = np.nonzero(mask)[0]
    n = len(idx)
    w = max(n, 1)
    out = tuple(np.zeros(w, a.dtype) for a in work[:5]) + (np.zeros(w, bool),)
    for o, a in zip(out[:5], work[:5]):
        o[:n] = a[idx]
    out[5][:n] = True
    return out


def _host_result(res):
    """(scores, docs, hits) on the host: a pruned call's finish() result,
    or an executor's tensors, copied under the ``search.device.wait``
    span (the copy waits for the work queued before it)."""
    if callable(res):
        return res()
    with trace("search.device.wait"):
        return tuple(x.cpu().numpy() for x in res)


def _blk_ranges(leaf) -> tuple[np.ndarray, np.ndarray]:
    return leaf.packed.blk_first_doc, leaf.packed.blk_last_doc


def _put(a, device, dtype=np.int32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

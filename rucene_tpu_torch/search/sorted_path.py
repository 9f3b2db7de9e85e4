"""Sort-by-field and field-collapse paths, mixed into IndexSearcher
(counterpart of rucene_tpu/search/sorted_path.py).

reference: rucene src/core/search/sort_field (field_comparator.rs:124-367
comparator composition, collapse_top_docs.rs:239, search_group.rs) and
collector/early_terminating.rs:17. Per-doc comparator calls become per-leaf
composite rank columns (directions folded in), so the device always sorts
ascending by one f32 key; field collapse is a scatter-max best-per-key
table per leaf (executor.execute_collapse), merged on the host. Both
evaluate their row through executor._dense_match: the combine kernel on
the dense branch, the scoring decode on packed leaves.

Rank tables are cached module-wide, so a new searcher after an NRT
refresh that changed nothing reuses them. The cache is an
index/derived.DerivedCache anchored on every leaf's packed segment, so,
unlike the reference's, whose entries hold their leaves' segments, it
keeps no merged-away segment alive. The key names each leaf's doc-values
overlays of the sorted fields by content, so a doc-values update gets new
ranks and a delete keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from rucene_tpu_torch.index.derived import DerivedCache
from rucene_tpu_torch.search import host_engine
from rucene_tpu_torch.search.query import Query
from rucene_tpu_torch.util.metrics import METRICS

# anchored on the leaves' packed segments: (tail, per-leaf state) -> tables
_RANK_CACHE = DerivedCache(32)


def _overlay_state(leaf, fields) -> tuple:
    """The leaf's numeric doc-values overlays of ``fields``, by content."""
    return tuple(
        (f, tuple(sorted(leaf.dv_updates[f].items())))
        for f in sorted(fields) if leaf.dv_updates.get(f)
    )


class SortedPathMixin:
    # --- sorted search (reference sort_field machinery) ---
    def _rank_cached(self, tail: tuple, fields, compute):
        """Rank tables from ``compute``, cached by what they depend on: each
        leaf's packed data (the anchors) and doc-values overlays of
        ``fields`` (the key, after ``tail``), not the searcher, so a new
        searcher over the same leaves finds them."""
        leaves = self.reader.leaves
        anchors = tuple(lf.packed for lf in leaves)
        key = tail + tuple((lf.max_doc, _overlay_state(lf, fields)) for lf in leaves)
        got = _RANK_CACHE.get(anchors, key)
        return got if got is not None else _RANK_CACHE.put(anchors, key, compute())

    def _dv_rank_tables(self, field: str):
        """Global order-preserving rank tables for a numeric DV field:
        (sorted unique values across all leaves, per-leaf i32 rank column
        over [max_doc]). Sorting by rank is sorting by value, and ranks
        are f32-exact below 2^24, the device sort key. Missing values rank
        as 0 (Lucene's default missing value)."""

        def compute():
            cols = []
            for leaf in self.reader.leaves:
                dv = leaf.numeric_doc_values(field)
                if dv is None:
                    cols.append(np.zeros(leaf.max_doc, np.int64))
                else:
                    cols.append(np.where(dv[1], dv[0], 0))
            uniq = np.unique(np.concatenate(cols)) if cols else np.zeros(1, np.int64)
            ranks = [np.searchsorted(uniq, c).astype(np.int32) for c in cols]
            return uniq, ranks

        return self._rank_cached(("1f", field), (field,), compute)

    def _composite_rank_tables(self, sort):
        """Lexicographic rank tables over 1..N numeric sort fields with the
        per-field directions folded in (field_comparator.rs:124-367): per
        doc c = ((r0' * n1) + r1') * n2 + ..., r_i' flipped for a
        descending field, so ascending composite order is the requested
        order. Returns (n_keys, per-leaf i32 composite rank columns,
        per-field values aligned to composite rank)."""
        fields = list(sort.fields)

        def compute():
            per = [self._dv_rank_tables(sf.field) for sf in fields]
            comps = []
            for li, leaf in enumerate(self.reader.leaves):
                c = np.zeros(leaf.max_doc, np.int64)
                for (u, ranks), sf in zip(per, fields):
                    r = ranks[li][: leaf.max_doc].astype(np.int64)
                    if sf.reverse:
                        r = (len(u) - 1) - r
                    c = c * len(u) + r
                comps.append(c)
            uniq_c = np.unique(np.concatenate(comps)) if comps else np.zeros(1, np.int64)
            crank = [np.searchsorted(uniq_c, c).astype(np.int32) for c in comps]
            vals_per_field: list[np.ndarray] = []
            rem = uniq_c.copy()
            for (u, _), sf in zip(reversed(per), reversed(fields)):
                r = rem % len(u)
                rem = rem // len(u)
                if sf.reverse:
                    r = (len(u) - 1) - r
                vals_per_field.append(u[r])
            vals_per_field.reverse()
            return len(uniq_c), crank, vals_per_field

        tail = ("comp", tuple((sf.field, sf.reverse) for sf in fields))
        return self._rank_cached(tail, [sf.field for sf in fields], compute)

    def _sorted_device_eligible(self, query: Query, sort) -> bool:
        from rucene_tpu_torch.search.sort_field import SortFieldType

        if not 1 <= len(sort.fields) <= 3:
            return False
        if any(sf.type in (SortFieldType.SCORE, SortFieldType.DOC) for sf in sort.fields):
            return False  # score / doc sorts take the host path
        if hasattr(query, "host_eval"):
            return False
        try:
            rq = query.rewrite()
        except Exception:
            return False
        if rq.phrases or rq.groups or (rq.match_all and (rq.clauses or rq.ranges)):
            return False
        if len(rq.ranges) > 8 or not rq.plain:
            return False
        # the composite int64 key must not overflow, and composite ranks
        # must stay f32-exact (< 2^24 distinct key tuples)
        prod = 1
        for sf in sort.fields:
            uniq, _ = self._dv_rank_tables(sf.field)
            prod *= max(len(uniq), 1)
            if prod >= 2**62:
                return False
        n_keys, _, _ = self._composite_rank_tables(sort)
        return n_keys < 2**24

    def _single_row_leaf_batches(self, rq):
        """One keyed row's executor inputs per leaf: (li, leaf, FlatQueryBatch,
        its combine tables, filter planes or None). Clause tables are built
        once; the combine tables are the row's real ones, so the dense
        match goes through the combine kernel."""
        from rucene_tpu_torch.search.flat_tables import (
            build_clause_tables,
            build_combine_batch,
            build_flat_work,
            build_leaf_cache,
            build_leaf_tables,
            make_flat_batch,
        )

        rqs = [rq]
        sim = self.similarity
        doc_freqs, stats = self._gather_stats(rqs)
        t = max(len(rq.all_slots()), 1)
        weight, occur, n_required, min_should, _, _ = build_clause_tables(
            rqs, sim, doc_freqs, stats, 1, t
        )
        filter_tables = self._range_filter_tables(rqs, 1) if rq.ranges else None
        for li, leaf in enumerate(self.reader.leaves):
            dev = leaf.device
            cache = build_leaf_cache(leaf, sim, stats)
            bs, bc, fid = build_leaf_tables(leaf, rqs, 1, t)
            work = build_flat_work(bs, bc, weight, fid, occur)[:6]
            fq = make_flat_batch(work, n_required, min_should, cache, dev, dedupe=True)
            combine = build_combine_batch(
                work, 1, leaf.packed.blk_first_doc, leaf.packed.blk_last_doc,
                dev.max_doc_padded, dev.device, q=fq, buckets=dev.buckets,
            )
            filters = self._leaf_filters(leaf, *filter_tables) if filter_tables else None
            yield li, leaf, fq, combine, filters

    @staticmethod
    def _key_column(leaf, col: np.ndarray, dtype) -> torch.Tensor:
        """A leaf's per-doc key column over its padded doc axis, on its
        device (0 on the padding docs, which never match)."""
        out = np.zeros(leaf.device.max_doc_padded, dtype)
        out[: leaf.max_doc] = col[: leaf.max_doc]
        return torch.from_numpy(out).to(leaf.torch_device)

    def _search_sorted_device(self, query: Query, k: int, sort) -> "TopFieldDocs":
        """One executor call per leaf: the dense boolean match and the top-k
        by (composite rank, doc) (executor.execute_flat_sorted); every
        leaf's results come back in one transfer each, then merge on the
        host."""
        from rucene_tpu_torch.search.executor import execute_flat_sorted
        from rucene_tpu_torch.search.sort_field import FieldDoc, SortFieldType, TopFieldDocs

        _n_keys, ranks, vals_per_field = self._composite_rank_tables(sort)
        rq = query.rewrite()
        pending = []
        for li, leaf, fq, combine, filters in self._single_row_leaf_batches(rq):
            keycol = self._key_column(leaf, ranks[li], np.float32)
            res = execute_flat_sorted(leaf.device, fq, combine, keycol, k, filters=filters)
            pending.append((leaf, torch.cat([x.reshape(-1).double() for x in res])))
        total = 0
        all_docs, all_keys, all_scores = [], [], []
        for leaf, flat in pending:
            flat = flat.cpu().numpy()
            keys = flat[:k].astype(np.float32)
            scores = flat[k : 2 * k].astype(np.float32)
            docs = flat[2 * k : 3 * k].astype(np.int64)
            got = scores > -np.inf
            total += int(flat[3 * k])
            all_docs.append(docs[got] + leaf.doc_base)
            all_keys.append(keys[got].astype(np.int64))
            if rq.match_all:  # constant-score rows: no clause contributions
                all_scores.append(np.full(int(got.sum()), rq.boost, np.float32))
            else:
                all_scores.append(scores[got])
        gdocs = np.concatenate(all_docs) if all_docs else np.zeros(0, np.int64)
        gkeys = np.concatenate(all_keys) if all_keys else np.zeros(0, np.int64)
        gscores = np.concatenate(all_scores) if all_scores else np.zeros(0, np.float32)
        order = np.lexsort((gdocs, gkeys))[:k]  # directions already folded
        fds = []
        for i in order:
            row_vals = []
            for sf, vals in zip(sort.fields, vals_per_field):
                v = vals[gkeys[i]]
                if sf.type in (SortFieldType.DOUBLE, SortFieldType.FLOAT):
                    row_vals.append(float(v))
                else:
                    row_vals.append(int(v))
            fds.append(FieldDoc(int(gdocs[i]), float(gscores[i]), row_vals))
        return TopFieldDocs(total, fds, sort)

    def search_sorted(self, query: Query, k: int, sort) -> "TopFieldDocs":
        """Sort matches by field values instead of relevance (searcher.rs
        search with SortAndFormats). Ties break by global doc id ascending.
        Numeric-field sorts (1-3 fields, mixed directions) run on the
        device through composite ranks (one executor call per leaf);
        other shapes take the host match path, the exact oracle, counted
        under ``route.host``."""
        try:
            eligible = self._sorted_device_eligible(query, sort)
        except Exception:
            eligible = False
        if eligible:
            return self._search_sorted_device(query, k, sort)
        return self._search_sorted_host(query, k, sort)

    def _search_sorted_host(
        self, query: Query, k: int, sort, per_leaf_limit: int | None = None
    ) -> "TopFieldDocs":
        """Host sorted search (the exact oracle for shapes the device path
        declines). per_leaf_limit turns on early termination: only the
        first N matches a segment (doc order is sort order on a sorted
        index) count, and total_hits becomes a lower bound. Counted under
        ``route.host``."""
        from rucene_tpu_torch.search.sort_field import (
            FieldDoc,
            SortFieldType,
            TopFieldDocs,
            sort_keys_for_leaf,
        )

        METRICS.incr("route.host")
        doc_freqs, stats = self._gather_stats_query(query)
        all_docs, all_scores, all_keys = [], [], None
        total = 0
        for leaf in self.reader.leaves:
            match, acc = host_engine.evaluate_query(leaf, query, self.similarity, stats, doc_freqs)
            if per_leaf_limit is None:
                hits = host_engine.hits_from_dense(leaf, match, acc, None)
                total += hits.total_hits
                docs, scores = hits.docs, hits.scores
            else:
                if leaf.live is not None:
                    match = match & leaf.live[: leaf.max_doc]
                docs = np.nonzero(match)[0][:per_leaf_limit]
                total += len(docs)
                scores = acc[docs]
            keys = sort_keys_for_leaf(leaf, sort, docs, scores)
            all_docs.append(docs.astype(np.int64) + leaf.doc_base)
            all_scores.append(scores)
            if all_keys is None:
                all_keys = [[kk] for kk in keys]
            else:
                for i, kk in enumerate(keys):
                    all_keys[i].append(kk)
        if not all_docs:
            return TopFieldDocs(0, [], sort)
        gdocs = np.concatenate(all_docs)
        gscores = np.concatenate(all_scores)
        key_cols = [np.concatenate(c) for c in all_keys] if all_keys else []
        # lexsort: the last key is primary, the doc id the final tie-break;
        # SCORE sorts descending by default, others ascending
        lex = [gdocs]
        for sf, col in zip(reversed(sort.fields), reversed(key_cols)):
            desc = (sf.type == SortFieldType.SCORE) != sf.reverse
            lex.append(-col.astype(np.float64) if desc else col)
        order = np.lexsort(tuple(lex))[:k]
        fds = [
            FieldDoc(int(gdocs[i]), float(gscores[i]), [col[i].item() for col in key_cols])
            for i in order
        ]
        return TopFieldDocs(total, fds, sort)

    def search_sorted_early_terminated(self, query: Query, k: int, sort, per_leaf_limit: int):
        """Early-terminating sorted search over an index sorted by the same
        sort (collector/early_terminating.rs:17)."""
        return self._search_sorted_host(query, k, sort, per_leaf_limit=per_leaf_limit)

    def search_collapse(self, query: Query, k: int, collapse_field: str) -> "TopDocs":
        """Field collapse: only the best hit per collapse key
        (collapse_top_docs.rs:239, search_group.rs: Zhihu's grouping
        extension). The key is the numeric DV value; docs without the
        field collapse under key 0. Device path: the dense match and a
        scatter-max best-per-key table per leaf, merged on the host; other
        shapes take the host path, counted under ``route.host``."""
        try:
            from rucene_tpu_torch.search.sort_field import Sort, SortField, SortFieldType

            eligible = self._sorted_device_eligible(
                query, Sort([SortField(collapse_field, SortFieldType.LONG)])
            )
        except Exception:
            eligible = False
        if eligible:
            return self._search_collapse_device(query, k, collapse_field)
        return self._search_collapse_host(query, k, collapse_field)

    def _search_collapse_device(self, query: Query, k: int, collapse_field: str) -> "TopDocs":
        from rucene_tpu_torch.search.executor import execute_collapse
        from rucene_tpu_torch.search.searcher import TopDocs

        # collapse keys: the raw DV column (0 for docs without the field, as
        # the host path reads dv[0]) ranked globally, so leaves merge exactly
        def compute():
            cols = []
            for leaf in self.reader.leaves:
                dv = leaf.numeric_doc_values(collapse_field)
                cols.append(
                    dv[0].astype(np.int64) if dv is not None else np.zeros(leaf.max_doc, np.int64)
                )
            uniq = np.unique(np.concatenate(cols)) if cols else np.zeros(1, np.int64)
            ranks = [np.searchsorted(uniq, c).astype(np.int32) for c in cols]
            return uniq, ranks

        uniq, ranks = self._rank_cached(("collapse", collapse_field), (collapse_field,), compute)
        n_keys = max(len(uniq), 1)
        rq = query.rewrite()
        pending = []
        for li, leaf, fq, combine, filters in self._single_row_leaf_batches(rq):
            keycol = self._key_column(leaf, ranks[li], np.int32)
            bsc, bdoc, hits = execute_collapse(leaf.device, fq, combine, keycol, n_keys, filters=filters)
            pending.append((leaf, bsc[0], bdoc[0], hits))
        total = 0
        best_scores = np.full(len(uniq), -np.inf, np.float32)
        best_docs = np.full(len(uniq), np.int64(2**62), np.int64)
        for leaf, bsc, bdoc, hits in pending:
            total += int(hits[0])
            sc = bsc.cpu().numpy()[: len(uniq)]
            dc = bdoc.cpu().numpy()[: len(uniq)].astype(np.int64) + leaf.doc_base
            # merge: (score desc, global doc asc) per key
            better = (sc > best_scores) | ((sc == best_scores) & (dc < best_docs))
            upd = better & (sc > -np.inf)
            best_scores = np.where(upd, sc, best_scores)
            best_docs = np.where(upd, dc, best_docs)
        live_keys = best_scores > -np.inf
        ksc = best_scores[live_keys]
        kdoc = best_docs[live_keys]
        order = np.lexsort((kdoc, -ksc))[:k]
        return TopDocs(total, docs=kdoc[order], scores=ksc[order])

    def _search_collapse_host(self, query: Query, k: int, collapse_field: str) -> "TopDocs":
        from rucene_tpu_torch.search.searcher import ScoreDoc, TopDocs

        METRICS.incr("route.host")
        doc_freqs, stats = self._gather_stats_query(query)
        best: dict[int, tuple[float, int]] = {}  # key -> (score, gdoc)
        total = 0
        for leaf in self.reader.leaves:
            match, acc = host_engine.evaluate_query(leaf, query, self.similarity, stats, doc_freqs)
            if leaf.live is not None:
                match = match & leaf.live[: leaf.max_doc]
            docs = np.nonzero(match)[0]
            total += len(docs)
            dv = leaf.numeric_doc_values(collapse_field)
            keys = dv[0][docs] if dv is not None else np.zeros(len(docs), np.int64)
            for d, key, sc in zip(docs, keys, acc[docs]):
                gdoc = int(d) + leaf.doc_base
                cur = best.get(int(key))
                if cur is None or (-sc, gdoc) < (-cur[0], cur[1]):
                    best[int(key)] = (float(sc), gdoc)
        hits = sorted(best.values(), key=lambda t: (-t[0], t[1]))[:k]
        return TopDocs(total, [ScoreDoc(doc, sc) for sc, doc in hits])

"""Range, exists and prefix filters as cached device planes (counterpart of
rucene_tpu/search/filter_path.py's filter half), mixed into IndexSearcher.

A RangeClause (PointRangeQuery, ExistsQuery, PrefixQuery) is a
constant-score doc set: its local doc ids on a leaf come from the reader
(SegmentSnapshot.point_range_docs, exists_mask, prefix_docs) through the
host query cache, and become one bool[md] plane on the leaf's torch
device, cached across batches in DEVICE_PLANE_CACHE (search/cache.py).
A batch's distinct filters stack into one [P, md] tensor, cached under the
tuple of their keys, and ride the executors as executor.FilterPlanes.

Every device cache key names the leaf's torch device: the cache keys a
leaf by (id(packed), name), and one PackedSegment may be served by
readers on several devices (IndexReader.to), so a plane built for one
device must never be handed to another.

The mixin also holds the reference's two other one-executor paths of
this module: synonym rows (``_search_synonym_device``: a SpanOrQuery over
plain terms, executor.execute_synonym) and the rescorer's probe
(``_probe_device``: one rewritten row read at given docs,
executor.execute_probe, through the combine kernel).

view_filters is the reference's ``_view_filters``: the planes of a
combined view (index/combined.py), each leaf's doc set at its view doc
base, cached on the view itself (so on its device) under the filter's key
and the leaves' doc-values overlays; a module function, since the sharded
searcher (parallel/sharded.py) builds them per shard too.

Left out of the reference: the pow2 pads of the stack, the synonym batch
and the probe list.
"""

from __future__ import annotations

import numpy as np
import torch

from rucene_tpu_torch.search.cache import DEFAULT_QUERY_CACHE, DEVICE_PLANE_CACHE
from rucene_tpu_torch.search.executor import FilterPlanes, execute_probe, execute_synonym
from rucene_tpu_torch.search.flat_tables import (
    build_clause_tables,
    build_combine_batch,
    build_flat_work,
    build_leaf_cache,
    build_leaf_tables,
    build_range_filter_tables,
    make_flat_batch,
)
from rucene_tpu_torch.search.query import Occur


def view_filters(view, leaves, keys, idx, enc, boost) -> FilterPlanes:
    """FilterPlanes in a combined view's doc space: each leaf's doc set of
    a filter lands at the leaf's view doc base. The planes and their stack
    are cached on the view, keyed by the filters and by the count of each
    leaf's doc-values overlays (an update that an exists set reads makes a
    new plane, as search/cache.py keys it)."""
    d = view.device.device
    mdp = view.device.max_doc_padded
    overlays = tuple(
        sum(len(m) for m in lf.dv_updates.values()) + sum(len(m) for m in lf.bdv_updates.values())
        for lf in leaves
    )

    def plane_of(rcl):
        key = ("plane", rcl.cache_key, overlays)
        got = view.planes.get(key)
        if got is None:
            m = np.zeros(mdp, bool)
            for li, leaf in enumerate(leaves):
                docs = DEFAULT_QUERY_CACHE.get_or_compute(
                    leaf, rcl.cache_key, lambda leaf=leaf: rcl.doc_set(leaf)
                )
                m[int(view.doc_bases[li]) + np.asarray(docs, np.int64)] = True
            if len(view.planes) >= 512:  # bounded: start over
                view.planes.clear()
            got = view.planes[key] = torch.from_numpy(m).to(d)
        return got

    skey = ("stack", tuple(r.cache_key for r in keys), overlays)
    planes = view.planes.get(skey)
    if planes is None:
        planes = view.planes[skey] = torch.stack([plane_of(r) for r in keys])
    return FilterPlanes(
        planes=planes,
        idx=torch.from_numpy(idx).to(d),
        enc=torch.from_numpy(enc).to(d),
        boost=torch.from_numpy(boost).to(d),
    )


class FilterPathMixin:
    def _range_filter_tables(self, rqs, b: int):
        return build_range_filter_tables(rqs, b)

    def _leaf_plane(self, leaf, rcl) -> torch.Tensor:
        """bool[md] plane of one filter clause on one leaf's device, cached
        across batches."""
        mdp = leaf.device.max_doc_padded

        def compute():
            docs = DEFAULT_QUERY_CACHE.get_or_compute(
                leaf, rcl.cache_key, lambda: rcl.doc_set(leaf)
            )
            m = np.zeros(mdp, bool)
            m[np.asarray(docs, np.int64)] = True
            return torch.from_numpy(m).to(leaf.torch_device)

        return DEVICE_PLANE_CACHE.get_or_compute(
            leaf, ("plane", str(leaf.torch_device)) + rcl.cache_key, compute
        )

    def _leaf_filters(self, leaf, keys, idx, enc, boost) -> FilterPlanes:
        """FilterPlanes of a batch on one leaf: the stack of its distinct
        filters' planes (cached under their keys) and the row slot tables
        (flat_tables.build_range_filter_tables)."""
        d = leaf.torch_device

        def stack():
            return torch.stack([self._leaf_plane(leaf, r) for r in keys])

        planes = DEVICE_PLANE_CACHE.get_or_compute(
            leaf, ("stack", str(d), tuple(r.cache_key for r in keys)), stack
        )
        return FilterPlanes(
            planes=planes,
            idx=torch.from_numpy(idx).to(d),
            enc=torch.from_numpy(enc).to(d),
            boost=torch.from_numpy(boost).to(d),
        )

    @staticmethod
    def _ranges_complete(rqs) -> bool:
        """Candidate-branch completeness with filter planes: every possible
        match carries a decoded term lane, i.e. every row with ranges has a
        required term clause. Otherwise a doc that matches only through
        its ranges never becomes a candidate, and the batch must take the
        dense branch."""
        return all(
            not rq.ranges or any(c.occur in (Occur.MUST, Occur.FILTER) for c in rq.clauses)
            for rq in rqs
        )

    # --- synonym device path ---
    def _search_synonym_device(self, queries, k: int, _defer: bool = False):
        """SpanOrQuery rows over plain term members: freq(doc) is the sum of
        the member tfs, scored by ONE BM25 application with the summed-idf
        weight (span_or.rs through SpanScorer's width-1 spans). One
        executor.execute_synonym call a leaf for the whole batch.
        _defer=True returns a finish() closure that reads the results."""
        sim = self.similarity
        infos = [q.synonym_terms() for q in queries]
        b = len(infos)
        t = max(len(ts) for _f, ts, _b in infos)

        doc_freqs: dict[tuple[str, str], int] = {}
        for field, texts, _b in infos:
            for text in texts:
                if (field, text) not in doc_freqs:
                    doc_freqs[(field, text)] = self.reader.doc_freq(field, text)
        stats = {f: self.collection_stats(f) for f, _ts, _b in infos}

        w_row = np.zeros(b, np.float32)
        for i, (field, texts, boost) in enumerate(infos):
            st = stats[field]
            doc_count = st.doc_count if st.doc_count != -1 else st.max_doc
            idf_sum = np.float32(0.0)
            for text in texts:
                idf_sum = np.float32(idf_sum + sim.idf(doc_freqs[(field, text)], doc_count))
            w = np.float32(idf_sum * np.float32(boost))
            w_row[i] = np.float32(w * np.float32(sim.k1 + np.float32(1.0)))

        n_required = np.zeros(b, np.int32)
        min_should = np.ones(b, np.int32)
        weight = np.ones((b, t), np.float32)
        occur = np.zeros((b, t), np.int32)  # SHOULD
        pending = []
        for leaf in self.reader.leaves:
            dev = leaf.device
            cache = build_leaf_cache(leaf, sim, stats)
            block_start = np.zeros((b, t), np.int32)
            block_count = np.zeros((b, t), np.int32)
            field_id = np.zeros((b, t), np.int32)
            fid_row = np.zeros(b, np.int32)
            for i, (field, texts, _b) in enumerate(infos):
                pf = leaf.packed.fields.get(field)
                if pf is None:
                    continue
                fid_row[i] = pf.field_id
                for j, text in enumerate(texts):
                    rec = leaf.term_record(field, text)
                    if rec is not None:
                        block_start[i, j] = rec.block_start
                        block_count[i, j] = rec.block_count
                        field_id[i, j] = pf.field_id
            work = build_flat_work(block_start, block_count, weight, field_id, occur)[:6]
            fq = make_flat_batch(work, n_required, min_should, cache, dev, dedupe=True)
            d = leaf.torch_device
            res = execute_synonym(
                dev, fq, torch.from_numpy(fid_row).to(d), torch.from_numpy(w_row).to(d), k
            )
            pending.append((leaf.doc_base, res))

        def finish():
            per_query_leaf: list[list] = [[] for _ in range(b)]
            for doc_base, res in pending:
                s, dd, h = (x.cpu().numpy() for x in res)
                for i in range(b):
                    per_query_leaf[i].append((doc_base, dd[i], s[i], int(h[i])))
            return [self._merge_leaf_hits(per_query_leaf[i], k) for i in range(b)]

        return finish if _defer else finish()

    def _probe_device(self, rq, leaf, locs, stats, doc_freqs):
        """(match, score) of one rewritten row at given local docs of one
        leaf: one dense executor call and a gather (executor.execute_probe),
        the rescorer's second pass."""
        sim = self.similarity
        t = max(len(rq.all_slots()), 1)
        weight, occur, n_required, min_should, _, _ = build_clause_tables(
            [rq], sim, doc_freqs, stats, 1, t
        )
        dev = leaf.device
        cache = build_leaf_cache(leaf, sim, stats)
        bs, bc, fid = build_leaf_tables(leaf, [rq], 1, t)
        work = build_flat_work(bs, bc, weight, fid, occur)[:6]
        filters = (
            self._leaf_filters(leaf, *self._range_filter_tables([rq], 1)) if rq.ranges else None
        )
        fq = make_flat_batch(work, n_required, min_should, cache, dev, dedupe=True)
        combine = build_combine_batch(
            work, 1, leaf.packed.blk_first_doc, leaf.packed.blk_last_doc,
            dev.max_doc_padded, dev.device, q=fq, buckets=dev.buckets,
        )
        probe = torch.from_numpy(np.asarray(locs, np.int32)).to(leaf.torch_device)
        ok, sc = execute_probe(dev, fq, combine, probe, filters=filters)
        return ok.cpu().numpy(), sc.cpu().numpy()

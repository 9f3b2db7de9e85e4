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

Left out of the reference: ``_view_filters`` (the combined multi-segment
view, ROADMAP.md §1 item 10), the synonym device path and
``_probe_device`` (item 9), and the pow2 pad of the stack.
"""

from __future__ import annotations

import numpy as np
import torch

from rucene_tpu_torch.search.cache import DEFAULT_QUERY_CACHE, DEVICE_PLANE_CACHE
from rucene_tpu_torch.search.executor import FilterPlanes
from rucene_tpu_torch.search.flat_tables import build_range_filter_tables
from rucene_tpu_torch.search.query import Occur


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

"""Per-leaf filter result cache.

reference: rucene src/core/search/cache/ (LRUQueryCache query_cache.rs:229,
UsageTrackingQueryCachingPolicy cache_policy.rs:60 with its frequency ring
buffer, lru_cache.rs:50). Note the reference wires the cache but
force-disables it at searcher.rs:696-702; here it is live for host-path
filter work (range/exists doc sets), keyed by (leaf id, filter key).

Port changes (held against rucene_tpu/search/cache.py by
tests/test_torch_host.py):
- LRUQueryCache.get_or_compute: the key also counts the doc-values updates
  the snapshot overlays. An exists set reads the overlays, and a
  snapshot made by an update shares its segment (and so its key) with
  the one before it; the reference serves the set cached before the
  update. Overlays only grow along a segment's snapshots, so their count
  names them, and a delete (which keeps them) still hits.
"""

from __future__ import annotations

from collections import OrderedDict, deque

import numpy as np


class UsageTrackingCachingPolicy:
    """Cache a filter once it has been seen `min_frequency` times within the
    last `history` uses (cache_policy.rs:60-160 semantics, simplified)."""

    def __init__(self, history: int = 256, min_frequency: int = 2):
        self._recent: deque = deque(maxlen=history)
        self.min_frequency = min_frequency

    def should_cache(self, key) -> bool:
        self._recent.append(key)
        return sum(1 for k in self._recent if k == key) >= self.min_frequency


class LRUQueryCache:
    def __init__(self, max_entries: int = 1024, policy: UsageTrackingCachingPolicy | None = None):
        self._entries: OrderedDict = OrderedDict()
        self.max_entries = max_entries
        self.policy = policy or UsageTrackingCachingPolicy()
        self.hits = 0
        self.misses = 0

    def get_or_compute(self, leaf, key, compute) -> np.ndarray:
        overlays = sum(len(m) for m in leaf.dv_updates.values()) + sum(
            len(m) for m in leaf.bdv_updates.values()
        )
        return self.get_or_compute_keyed(
            (id(leaf.packed), leaf.name, key, overlays), compute, anchor=leaf.packed
        )

    def get_or_compute_keyed(self, full_key, compute, anchor=None):
        """anchor: the object whose id() participates in full_key. Entries
        hold a WEAK ref to it and a hit requires identity — a freed
        segment's recycled id() must never serve another index's doc set
        (this flaked as a wrong-corpus filter plane under full-suite churn;
        weak refs so the cache never pins dead segments)."""
        hit = self._entries.get(full_key)
        if hit is not None:
            ref, value = hit
            if ref is None or ref() is anchor:
                self._entries.move_to_end(full_key)
                self.hits += 1
                return value
            del self._entries[full_key]  # recycled id(): stale entry
        self.misses += 1
        value = compute()
        if self.policy.should_cache(full_key):
            import weakref

            ref = None
            if anchor is not None:
                try:
                    ref = weakref.ref(anchor)
                except TypeError:
                    ref = None
            self._entries[full_key] = (ref, value)
            if len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return value

    def clear(self) -> None:
        self._entries.clear()


DEFAULT_QUERY_CACHE = LRUQueryCache()


class _AlwaysCachePolicy:
    def should_cache(self, key) -> bool:
        return True


# Device-resident filter planes (bool[mdp] per distinct range/exists
# filter per leaf/view): building one costs a host scatter + an upload,
# so repeats across batches must hit on first reuse — always-cache LRU,
# bounded by entry count (planes are ~max_doc/8 KB each).
DEVICE_PLANE_CACHE = LRUQueryCache(max_entries=256, policy=_AlwaysCachePolicy())

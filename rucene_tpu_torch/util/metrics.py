"""Process-wide counters and timers (counterpart: rucene_tpu/util/metrics.py,
without its profiler hooks).

Counters in use:
- ``route.device`` / ``route.phrase``: term and boolean rows, and pure
  phrase rows (search/searcher.py);
- ``route.single`` / ``route.flat``: term and boolean rows per route;
- ``search.phrase_device`` / ``search.phrase_plane`` /
  ``search.phrase_scalar_route`` / ``search.phrase_host_fallback``: phrase
  rows per route, ``search.phrase_plane_build`` / ``_denied`` (planes
  built, fetches refused), ``search.phrase_pruned_blocks``
  (search/phrase_path.py);
- ``search.queries``, ``search.flat_lanes``, ``search.conj_pruned_blocks``;
- ``search.decode_dedup_items``: work items whose block decode was shared;
- ``search.strategy.dense`` / ``search.strategy.candidate``: executor calls
  per branch;
- ``kernel.<name>``: launches of a CUDA kernel, counted by its wrapper
  right where it launches (never for the CPU twin);
- ``reader.device_builds``: device forms built for a segment on a device
  (index/reader.py; a delete or doc-values update builds none);
- ``writer.flushes``, ``writer.merges``, ``writer.merge_errors`` and the
  ``writer.flush`` timer (index/writer.py).
"""

from __future__ import annotations

import threading
from collections import defaultdict


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)
        self.timer_totals: dict[str, float] = defaultdict(float)
        self.timer_counts: dict[str, int] = defaultdict(int)

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timer_totals[name] += seconds
            self.timer_counts[name] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timers": {
                    k: {"total_s": self.timer_totals[k], "count": self.timer_counts[k]}
                    for k in self.timer_totals
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timer_totals.clear()
            self.timer_counts.clear()


METRICS = Metrics()  # process-wide default registry

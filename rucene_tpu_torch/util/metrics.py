"""Process-wide counters and timers (counterpart of
rucene_tpu/util/metrics.py).

Counters in use:
- ``route.device`` / ``route.phrase``: term and boolean rows, and pure
  phrase rows (search/searcher.py);
- ``route.single`` / ``route.flat``: term and boolean rows per route;
- ``search.phrase_device`` / ``search.phrase_plane`` /
  ``search.phrase_scalar_route`` / ``search.phrase_host_fallback``: phrase
  rows per route, ``search.phrase_plane_build`` / ``_denied`` (planes
  built, fetches refused), ``search.phrase_pruned_blocks``
  (search/phrase_path.py);
- ``search.queries``, ``search.conj_pruned_blocks``;
- ``search.decode_dedup_items``: work items whose block decode was shared;
- ``search.combine_entries`` / ``search.combine_residue_items``: the dense
  combine's entries and residue items (flat_tables.build_combine_batch);
- ``search.strategy.dense`` / ``search.strategy.candidate``: executor calls
  per branch;
- ``kernel.<name>``: launches of a CUDA kernel, counted by its wrapper
  right where it launches (never for the CPU twin);
- ``reader.device_builds``: device forms built for a segment on a device
  (index/reader.py; a delete or doc-values update builds none);
- ``search.leaves``: leaves a batch's dispatch walks, the reader's leaf
  count once a batch (search/searcher.py);
- ``writer.flushes``, ``writer.merges``, ``writer.merge_errors``,
  ``writer.merged_docs`` (docs written by merges) (index/writer.py).

Timers in use (``snapshot()["timers"]``: total_s, count, mean_ms, max_ms):
- ``search.batch``: a batch from search_batch_async to the end of its
  collect();
- the host phases of a batch, as ``trace`` spans (search/searcher.py):
  ``search.device.dispatch``, ``search.phrases.dispatch`` and
  ``search.mixed.dispatch`` (queueing the term, phrase and mixed paths:
  host time, no device sync), then in collect() ``search.device``,
  ``search.phrases``, ``search.mixed``, ``search.synonyms`` and
  ``search.span_unordered`` (each path's finish, its wait for the
  device included);
- the term path's stages (search/searcher.py), inside
  ``search.device.dispatch``: ``search.device.tables`` (statistics,
  clause tables, row classes, each leaf's block tables, work lists and
  plane slots), ``search.device.conj_prune`` (prune_conjunctions),
  ``search.device.combine_tables`` (build_combine_batch),
  ``search.device.launch`` (each route's uploads and executor calls);
  inside ``search.device``: ``search.device.wait`` (each copy of a result
  to the host) and ``search.device.merge`` (the rows' hit lists);
- the phrase path's stages (search/phrase_path.py):
  ``search.phrases.select`` (statistics, then once a leaf the block
  selection and routing), within it ``search.phrases.postings`` (the
  selections the memo lacks), ``search.phrases.launch`` (uploads, the
  candidate pipeline, the plane dispatch, the collect's plane retry),
  within it ``search.phrases.plane_build`` (a position plane built on a
  cache miss), ``search.phrases.scalar`` (each scalar-engine call, in
  dispatch or collect), and inside ``search.phrases``
  ``search.phrases.wait`` (the results' copies to the host) and
  ``search.phrases.merge`` (the rows' hit lists);
- set-up: ``reader.open`` (index/reader.open_directory_reader),
  ``reader.device_build`` (a segment's device form) and
  ``search.prewarm_planes`` (prewarm_phrase_planes);
- the write side (index/writer.py), as ``trace`` spans: ``writer.flush``,
  ``writer.add_documents`` (a block's inversion into the buffer),
  ``writer.merge`` (a merge and its write, on the merge scheduler's
  thread) and ``writer.get_reader`` (an NRT reader: flush, and with
  merge_on_refresh the merge's registration); ``nrt.refresh``
  (search/search_manager.py: the whole of maybe_refresh, the new
  searcher's device builds within it).

Port changes (the drift guard in tests/test_torch_host.py compares the
rest with the reference):
- trace: annotates a torch.profiler capture with record_function where
  the reference annotates a jax.profiler one;
- start_profiler: a torch.profiler.profile of the CPU activity, and of
  the CUDA activity when the device is CUDA (the default when a card is
  present), in place of jax.profiler.start_trace;
- stop_profiler: writes the capture as a Chrome trace under start's
  log_dir and returns its path;
- _PROFILER: the running capture and its log_dir.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)
        self.timer_totals: dict[str, float] = defaultdict(float)
        self.timer_counts: dict[str, int] = defaultdict(int)
        self.timer_max: dict[str, float] = defaultdict(float)

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timer_totals[name] += seconds
            self.timer_counts[name] += 1
            if seconds > self.timer_max[name]:
                self.timer_max[name] = seconds

    @contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timers": {
                    k: {
                        "total_s": self.timer_totals[k],
                        "count": self.timer_counts[k],
                        "mean_ms": 1000.0 * self.timer_totals[k] / max(1, self.timer_counts[k]),
                        "max_ms": 1000.0 * self.timer_max[k],
                    }
                    for k in self.timer_totals
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timer_totals.clear()
            self.timer_counts.clear()
            self.timer_max.clear()


METRICS = Metrics()  # process-wide default registry


@contextmanager
def trace(name: str, registry: Metrics | None = None):
    """Scoped timing that also annotates a torch.profiler capture, so a
    trace shows the engine's host phases (e.g. 'search.device') beside the
    device timeline. It adds no device sync: around a dispatch it measures
    host time, around a collect the wait for the device as well."""
    from torch.profiler import record_function

    reg = registry or METRICS
    t0 = time.perf_counter()
    with record_function(name):
        try:
            yield
        finally:
            reg.observe(name, time.perf_counter() - t0)


_PROFILER = {}  # the running capture: its "prof" and "log_dir"


def start_profiler(log_dir: str, device=None) -> None:
    """Begin a torch.profiler capture: CPU activity, and CUDA activity when
    ``device`` is CUDA (default: when a card is present). stop_profiler
    writes it under log_dir as a Chrome trace (chrome://tracing,
    Perfetto). One capture at a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _PROFILER:
        raise RuntimeError("a profiler capture is already running")
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    _PROFILER.update(prof=prof, log_dir=log_dir)


def stop_profiler() -> str:
    """End the capture and write it to ``<log_dir>/trace-<pid>-<ns>.pt.trace.json``;
    returns that path."""
    import os

    if not _PROFILER:
        raise RuntimeError("no profiler capture is running")
    prof, log_dir = _PROFILER.pop("prof"), _PROFILER.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path

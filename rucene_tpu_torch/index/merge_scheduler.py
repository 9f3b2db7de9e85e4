"""Merge schedulers + merge IO rate limiting.

reference: rucene src/core/index/merge/merge_scheduler.rs:41
(SerialMergeScheduler :61, ConcurrentMergeScheduler :141, default threads
min(3, ncpu/2) :147) and merge_rate_limiter.rs:32.

ConcurrentMergeScheduler runs merges on daemon threads so commit() returns
before merging finishes; the writer's lock serializes the actual segment
swap. The rate limiter bounds merge byte throughput and carries the abort
flag that force-stops in-flight merges on writer close.
"""

from __future__ import annotations

import os
import threading
import time


class MergeRateLimiter:
    """MB/s throttle + abort flag (reference merge_rate_limiter.rs:32-110)."""

    def __init__(self, mb_per_sec: float | None = None):
        self.mb_per_sec = mb_per_sec
        self._aborted = False
        self._bytes_since_pause = 0
        self._last = time.monotonic()
        self.total_paused_s = 0.0

    def abort(self) -> None:
        self._aborted = True

    @property
    def aborted(self) -> bool:
        return self._aborted

    def check_abort(self) -> None:
        if self._aborted:
            raise MergeAbortedError("merge aborted")

    def pause(self, num_bytes: int) -> None:
        """Account bytes; sleep when over budget."""
        self.check_abort()
        if not self.mb_per_sec:
            return
        self._bytes_since_pause += num_bytes
        elapsed = time.monotonic() - self._last
        expected = self._bytes_since_pause / (self.mb_per_sec * 1024 * 1024)
        if expected > elapsed:
            sleep_s = min(expected - elapsed, 0.25)
            time.sleep(sleep_s)
            self.total_paused_s += sleep_s
        if elapsed > 1.0:
            self._last = time.monotonic()
            self._bytes_since_pause = 0


class MergeAbortedError(RuntimeError):
    pass


class SerialMergeScheduler:
    """Run merges inline on the calling thread (merge_scheduler.rs:61)."""

    def merge(self, run_one_merge) -> None:
        run_one_merge()

    def close(self) -> None:
        pass


class ConcurrentMergeScheduler:
    """Run merges on background daemon threads with a max-thread cap
    (merge_scheduler.rs:141-250)."""

    def __init__(self, max_threads: int | None = None):
        self.max_threads = max_threads or min(3, max(1, (os.cpu_count() or 2) // 2))
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._closed = False

    def merge(self, run_one_merge) -> None:
        def _run_logged():
            # the writer records merge failures (merge_exceptions / tragedy)
            # before re-raising; don't also crash the daemon thread
            try:
                run_one_merge()
            except Exception:
                import logging

                logging.getLogger(__name__).exception("background merge failed")

        with self._lock:
            if self._closed:
                run_one_merge()
                return
            self._threads = [t for t in self._threads if t.is_alive()]
            if len(self._threads) >= self.max_threads:
                # merge-count stall: run inline (reference stall at :225-250)
                run_one_merge()
                return
            t = threading.Thread(target=_run_logged, daemon=True, name="rucene-tpu-merge")
            self._threads.append(t)
            t.start()

    def sync(self) -> None:
        for t in list(self._threads):
            t.join()

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self.sync()

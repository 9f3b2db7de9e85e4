"""Merge schedulers + merge IO rate limiting.

reference: rucene src/core/index/merge/merge_scheduler.rs:41
(SerialMergeScheduler :61, ConcurrentMergeScheduler :141, default threads
min(3, ncpu/2) :147) and merge_rate_limiter.rs:32.

ConcurrentMergeScheduler runs merges on daemon threads so commit() returns
before merging finishes; the writer's lock serializes the actual segment
swap. The rate limiter bounds merge byte throughput and carries the abort
flag that force-stops in-flight merges on writer close.

Port changes (held against rucene_tpu/index/merge_scheduler.py by
tests/test_torch_host.py):
- SerialMergeScheduler.segment_merge: the writer's segment merge, on the
  calling thread (index/merge.merge_segments).
- ConcurrentMergeScheduler.__init__: ``processes`` (off by default).
- ConcurrentMergeScheduler.segment_merge: with ``processes``, a merge
  thread hands its segment merge to a worker process and waits for the
  merged segment: the merge then holds none of the writer's process's
  interpreter lock, which Lucene's merge threads never contend for and a
  Python merge thread otherwise takes from every other thread of the
  process (serving ones too). A worker is a fresh interpreter fed pickled
  segments through a pipe, so a process that holds a CUDA context forks
  nothing; idle workers are kept for the next merge.
- ConcurrentMergeScheduler.close: closes the worker processes.
- _merge_in_worker: added; a worker's merge of the pickled inputs.
- _write_frame: added; one length-prefixed pickle on the pipe.
- _read_frame: added; the next one.
- _worker_main: added; the worker process's loop.
- _MergeWorker: added; a worker process and its pipe.
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


def _merge_in_worker(parts: list) -> object:
    """merge_segments over (name, packed, live, dv_updates, bdv_updates) of
    each input, in a worker process."""
    from rucene_tpu_torch.index.merge import merge_segments
    from rucene_tpu_torch.index.reader import SegmentSnapshot

    snaps = []
    for name, packed, live, dv, bdv in parts:
        snap = SegmentSnapshot(name, packed, live)
        snap.dv_updates, snap.bdv_updates = dv, bdv
        snaps.append(snap)
    return merge_segments(snaps)


def _write_frame(f, obj) -> None:
    import pickle

    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(len(blob).to_bytes(8, "little"))
    f.write(blob)
    f.flush()


def _read_frame(f):
    """The next pickled object of a length-prefixed stream, or EOFError."""
    import pickle

    head = f.read(8)
    if len(head) < 8:
        raise EOFError
    return pickle.loads(f.read(int.from_bytes(head, "little")))


def _worker_main() -> None:
    """A merge worker: merges each job read from stdin and writes back
    (True, merged segment) or (False, the error's traceback), until stdin
    closes."""
    import sys

    inp, out = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # nothing printed may break a frame
    while True:
        try:
            parts = _read_frame(inp)
        except EOFError:
            return
        try:
            res = (True, _merge_in_worker(parts))
        except Exception:
            import traceback

            res = (False, traceback.format_exc())
        _write_frame(out, res)


class _MergeWorker:
    """A Python process that runs segment merges for one merge thread at a
    time. It is started with a fresh interpreter (not forked, and not
    through multiprocessing, which would import the caller's main module
    anew) and exits when its stdin closes, the writer's process's end
    included."""

    def __init__(self):
        import subprocess
        import sys

        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "from rucene_tpu_torch.index.merge_scheduler import _worker_main; _worker_main()"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
        )

    def run(self, parts: list) -> object:
        try:
            _write_frame(self.proc.stdin, parts)
            ok, value = _read_frame(self.proc.stdout)
        except (EOFError, BrokenPipeError) as e:
            raise RuntimeError(f"merge worker exited (code {self.proc.poll()})") from e
        if not ok:
            raise RuntimeError(f"merge failed in its worker process:\n{value}")
        return value

    def close(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        self.proc.wait()


class SerialMergeScheduler:
    """Run merges inline on the calling thread (merge_scheduler.rs:61)."""

    def merge(self, run_one_merge) -> None:
        run_one_merge()

    def segment_merge(self, snapshots: list) -> object:
        from rucene_tpu_torch.index.merge import merge_segments

        return merge_segments(snapshots)

    def close(self) -> None:
        pass


class ConcurrentMergeScheduler:
    """Run merges on background daemon threads with a max-thread cap
    (merge_scheduler.rs:141-250)."""

    def __init__(self, max_threads: int | None = None, processes: bool = False):
        self.max_threads = max_threads or min(3, max(1, (os.cpu_count() or 2) // 2))
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._closed = False
        # each merge's segment merge in a worker process (segment_merge)
        self.processes = processes
        self._idle: list[_MergeWorker] = []

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

    def segment_merge(self, snapshots: list) -> object:
        """The merged segment of ``snapshots``: merged on the calling merge
        thread, or with ``processes`` by an idle worker process (one is
        started where none is idle) while the thread waits."""
        if not self.processes:
            from rucene_tpu_torch.index.merge import merge_segments

            return merge_segments(snapshots)
        with self._lock:
            worker = self._idle.pop() if self._idle else None
        if worker is None:
            worker = _MergeWorker()
        try:
            merged = worker.run(
                [(s.name, s.packed, s.live, s.dv_updates, s.bdv_updates) for s in snapshots]
            )
        except BaseException:
            worker.close()
            raise
        with self._lock:
            if self._closed:
                worker.close()
            else:
                self._idle.append(worker)
        return merged

    def sync(self) -> None:
        for t in list(self._threads):
            t.join()

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self.sync()
        with self._lock:
            idle, self._idle = self._idle, []
        for worker in idle:
            worker.close()

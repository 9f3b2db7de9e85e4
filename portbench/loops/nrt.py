"""The NRT loop: a committed base that takes an append-only stream of new
passages while it serves, in the shape of luceneutil's NRTPerfTest: docs
arrive at a fixed rate, the searcher reopens at a fixed interval, and
searches run alongside.

Set-up copies the configuration's committed base (``index_cache.
committed``, the base's ``base_writer``) into a directory of its own under
the cache, opens the stream's ``IndexWriter`` on it (the configuration's
``writer``: LogDocMergePolicy, a ConcurrentMergeScheduler whose merges
run in worker processes, merges on refresh, no commit) and a ``SearcherManager`` over ``IndexSearcher(reader,
device=...)`` whose factory builds each new leaf's device form, prewarms
the base's phrase planes and draws the stream's texts (the corpus's docs
after the base). It then warms up: one and a half ``merge_factor``
refreshes, each after one interval's docs added at once, a batch or so
served after each; the tenth starts a merge, which is waited for, so the
window starts mid-way to the next merge with the merged leaf in.

In the window a daemon thread adds chunks of ``chunk_docs`` docs on the
arrival schedule ``t0 + i * chunk_docs / docs_per_s``: it sleeps when
ahead and never skips a chunk when behind. The serving thread runs the
closed loop of ``closed.py`` (``in_flight`` batches through
``search_batch_async``, query objects built anew) and, before a dispatch,
refreshes once ``refresh_s`` has gone by since the last refresh. The
refresh holds the ingest (one lock around ``add_documents`` and the
count) for its ``get_reader``, so the new searcher holds exactly the docs
acknowledged so far; each batch's rows go to the sampler with that count,
and the reference answers them over that prefix of the corpus. A searcher
that lost an acknowledged doc, holds one twice or out of order fails
``count_err`` or ``rank_gap``.

Rows answered by a searcher whose refresh found the writer more than one
interval behind its schedule (judged when the refresh stops the ingest)
count as failed (``failed_rows``): the freshness promise is broken for
them. A writer or merge error fails every
row collected after it.

- ``qps``: rows answered over the window, from its start to the last
  collect;
- ``batch_p95_ms``: the 95th percentile of each batch's time from its
  dispatch to the end of its ``collect()``.

The traced stretch is ``closed.py``'s, but the profiler starts before the
window's clock and the stream, and stops after the window: its start and
its stop stall the host for seconds, which would hold the writer behind
its schedule. ``layers`` holds the window's
timers and counters, ``batches``, ``refreshes``, the window's ``seconds``
and ``n_docs``, the docs of the traced stretch's last searcher.
"""

from __future__ import annotations

import os
import shutil
import sys
import threading
import time
import traceback
from collections import deque
from typing import NamedTuple

import numpy as np
from torch.profiler import record_function

from portbench import corpus as corpus_mod
from portbench import index_cache, traffic
from portbench.check import Sampler
from portbench.loops import HostLoad, Out, slices, timer_delta

REUSE_STATE = False  # a window adds docs to the index: each seed starts from the base


class Searcher(NamedTuple):
    searcher: object
    n_docs: int  # docs acknowledged when its reader was opened
    fresh: bool  # the writer was within one interval of its schedule then


class Stream:
    """The stream's docs, its writer and the ingest lock: ``add`` adds the
    next chunk and counts it under the lock; ``get_reader`` (the writer as
    the SearcherManager sees it) opens a reader under the same lock."""

    def __init__(self, writer, texts: list, field: str, base_docs: int, chunk: int,
                 rate: float, refresh_s: float):
        self.writer, self.texts, self.field = writer, texts, field
        self.base_docs, self.chunk, self.rate, self.refresh_s = base_docs, chunk, rate, refresh_s
        self.lock = threading.Lock()
        self.acked = 0  # stream docs acknowledged
        self.t0 = None  # the arrival schedule's start; None: docs arrive at once (warm-up)
        self.first = 0  # stream docs acknowledged when the schedule started
        self.at_reader = (base_docs, True)  # the last reader's docs and freshness
        self.error: Exception | None = None
        self.stop = threading.Event()
        self.thread: threading.Thread | None = None

    def add(self) -> bool:
        """Adds the next chunk; False once the stream is spent."""
        lo = self.acked
        hi = min(lo + self.chunk, len(self.texts))
        if hi <= lo:
            return False
        docs = index_cache.documents(self.texts[lo:hi], self.field)
        with self.lock:
            self.writer.add_documents(docs)
            self.acked = hi
        return True

    def scheduled(self, t: float) -> int:
        """Stream docs the schedule has brought by time t."""
        if self.t0 is None or t < self.t0:
            return self.first
        n = int((t - self.t0) * self.rate / self.chunk) + 1
        return min(self.first + n * self.chunk, len(self.texts))

    def get_reader(self):
        with self.lock:
            # the reader holds what was acknowledged when the ingest stopped,
            # so that moment is held to the schedule: the time get_reader
            # itself takes is not charged to the writer
            due = self.scheduled(time.perf_counter() - self.refresh_s)
            reader = self.writer.get_reader()
            self.at_reader = (self.base_docs + self.acked, self.acked >= due)
        return reader

    def start(self) -> None:
        """The ingest thread, on the arrival schedule from now."""
        self.first, self.t0 = self.acked, time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True, name="portbench-ingest")
        self.thread.start()

    def _run(self) -> None:
        i = 0
        try:
            while not self.stop.is_set():
                wait = self.t0 + i * self.chunk / self.rate - time.perf_counter()
                if wait > 0 and self.stop.wait(wait):
                    return
                if not self.add():
                    return
                i += 1
        except Exception as e:  # noqa: BLE001 - fails the rows after it
            self.error = e
            traceback.print_exc(file=sys.stderr)

    def halt(self) -> None:
        self.stop.set()
        if self.thread is not None:
            self.thread.join(timeout=60)


class State:
    def __init__(self, stream: Stream, manager, batches: list, path: str):
        self.stream, self.manager, self.batches, self.path = stream, manager, batches, path
        self.current = Searcher(manager.acquire(), *stream.at_reader)
        self.last_refresh = time.perf_counter()
        # (time, stream docs acked, scheduled, leaves, merges, on schedule, seconds)
        self.refreshes: list = []

    def broken(self) -> bool:
        return self.stream.error is not None or bool(self.stream.writer.merge_exceptions)

    def refresh(self) -> None:
        from rucene_tpu_torch.util.metrics import METRICS

        now = self.last_refresh = time.perf_counter()
        try:
            self.manager.maybe_refresh()
        except Exception as e:  # noqa: BLE001 - fails the rows after it
            self.stream.error = e
            traceback.print_exc(file=sys.stderr)
            return
        self.current = Searcher(self.manager.acquire(), *self.stream.at_reader)
        self.refreshes.append((now, self.current.n_docs - self.stream.base_docs,
                               self.stream.scheduled(now),
                               len(self.current.searcher.reader.leaves),
                               METRICS.counters.get("writer.merges", 0), self.current.fresh,
                               time.perf_counter() - now))


def _writer_config(params: dict):
    from rucene_tpu_torch import (ConcurrentMergeScheduler, IndexWriterConfig,
                                  LogDocMergePolicy)

    pol, sched = params["merge_policy"], params["merge_scheduler"]
    return IndexWriterConfig(
        max_buffered_docs=params["max_buffered_docs"],
        merge_policy=LogDocMergePolicy(merge_factor=pol["merge_factor"],
                                       min_merge_docs=pol["min_merge_docs"]),
        merge_scheduler=ConcurrentMergeScheduler(processes=sched["processes"]),
        merge_on_commit=params["merge_on_commit"],
        merge_on_refresh=params["merge_on_refresh"],
        commit_on_close=False)


def _private_copy(src: str, cache_dir: str) -> str:
    """The committed base, hard-linked (copied where links fail) into a
    directory of this run's own: the writer only adds files, and never
    writes into the cached commit."""
    dst = os.path.join(cache_dir, f".nrt-{os.getpid()}-{time.time_ns()}")

    def link(a, b):
        try:
            os.link(a, b)
        except OSError:
            shutil.copy2(a, b)

    shutil.copytree(src, dst, copy_function=link)
    return dst


def setup(cell) -> State:
    import rucene_tpu_torch as rt

    cfg, mix = cell.config, cell.traffic
    wcfg = _writer_config(cfg["writer"])  # fails here where the program lacks the stream's parts
    base = cfg["base_docs"]
    committed = index_cache.committed({**cfg, "writer": cfg["base_writer"]}, cell.corpus, base,
                                      cell.log, cell.cache_dir)
    path = _private_copy(committed, cell.cache_dir)
    try:
        writer = rt.IndexWriter(rt.FSDirectory(path), wcfg)
        texts = corpus_mod.texts(cell.corpus, base, cell.corpus.n_docs)
        stream = Stream(writer, texts, cfg["field"], base, mix["chunk_docs"], mix["docs_per_s"],
                        cfg["refresh_s"])

        def factory(reader):
            s = rt.IndexSearcher(reader, device=cell.device)
            for leaf in s.reader.leaves:
                _ = leaf.device  # a new leaf's form, built inside the refresh
            return s

        manager = rt.SearcherManager(stream, searcher_factory=factory)
        b = mix["batch"]
        state = State(stream, manager, [list(range(i, min(i + b, len(cell.rows))))
                                        for i in range(0, len(cell.rows), b)], path)
        if cfg.get("prewarm_phrase_planes"):
            n = state.current.searcher.prewarm_phrase_planes(cfg["field"])
            cell.log(f"prewarmed {n} phrase planes")
        _warm(cell, state)
    except BaseException:
        if "writer" in locals():
            writer.close()
        shutil.rmtree(path, ignore_errors=True)
        raise
    return state


def _warm(cell, state: State) -> None:
    """One and a half merge_factor refreshes of one interval's docs each,
    a batch or so served after each: the merge_factor-th starts a merge,
    which is waited for, so the window starts mid-way to the next one with
    the merged leaf in. The rest of the warm batches follow the last."""
    stream, mix = state.stream, cell.traffic
    factor = cell.config["writer"]["merge_policy"]["merge_factor"]
    n_refresh = factor + factor // 2
    per_interval = int(mix["docs_per_s"] * cell.config["refresh_s"])
    n_warm = mix["warm_batches"]
    sent = 0
    for r in range(n_refresh):
        target = stream.acked + per_interval
        while stream.acked < target and stream.add():
            pass
        state.refresh()
        if r == factor - 1:
            stream.writer.config.merge_scheduler.sync()
        upto = (r + 1) * (n_warm - 1) // n_refresh
        got = serve(cell, state, lambda i, upto=upto, sent=sent: sent + i >= upto, first=sent,
                    refresh=False)
        sent += got["batches"]
    got = serve(cell, state, lambda i: sent + i >= n_warm, first=sent, refresh=False)
    cell.log(f"warm-up: {len(state.refreshes)} refreshes, {stream.acked} stream docs, "
             f"{len(state.current.searcher.reader.leaves)} leaves, "
             f"{sent + got['batches']} batches, {got['failed']} rows failed")
    if state.broken():
        raise RuntimeError(f"the stream failed in warm-up: {state.stream.error!r} "
                           f"{state.stream.writer.merge_exceptions!r}")
    state.refreshes.clear()


def serve(cell, state: State, stop, sampler: Sampler | None = None, on_collect=None,
          first: int = 0, refresh: bool = True) -> dict:
    """The pass's batches in order from batch ``first``, ``in_flight``
    queued, until stop(batches sent), each on the searcher current at its
    dispatch, refreshed first once ``refresh_s`` has gone by; then every
    queued batch is collected. on_collect(row indices, searcher) follows
    each collect."""
    k, depth, field = cell.traffic["k"], cell.traffic["in_flight"], cell.config["field"]
    refresh_s = cell.config["refresh_s"]
    pending: deque = deque()
    lat: list = []
    causes: list = []  # (leaves, refreshes run in its flight, their seconds) of each batch
    done_at: list = []  # (time, rows answered) of each collect
    tally = {"done": 0, "failed": 0, "stale": 0}

    def fail(idx):
        tally["failed"] += len(idx)
        if tally["failed"] == len(idx):  # the first failure's traceback
            traceback.print_exc(file=sys.stderr)

    def collect_one():
        t, idx, collect, cur = pending.popleft()
        try:
            with record_function("portbench.collect"):
                res = collect()
        except Exception:  # noqa: BLE001 - a batch that raises fails its rows
            fail(idx)
            return
        now = time.perf_counter()
        lat.append(now - t)
        flight = [r[6] for r in state.refreshes if r[0] >= t]
        causes.append((len(cur.searcher.reader.leaves), len(flight), sum(flight)))
        ok = [(i, r) for i, r in zip(idx, res) if r is not None]
        if not cur.fresh or state.broken():
            tally["stale"] += len(ok)
            ok = []
        done_at.append((now, len(ok)))
        tally["done"] += len(ok)
        tally["failed"] += len(idx) - len(ok)
        if sampler is not None and ok:
            sampler.offer([i for i, _ in ok], [r for _, r in ok], cur.n_docs)
        if on_collect is not None:
            on_collect(idx, cur)

    b = 0
    while not stop(b):
        if refresh and time.perf_counter() - state.last_refresh >= refresh_s:
            state.refresh()
        cur = state.current
        idx = state.batches[(first + b) % len(state.batches)]
        b += 1
        qs = traffic.to_queries([cell.rows[i] for i in idx], field)
        t = time.perf_counter()
        try:
            with record_function("portbench.dispatch"):
                collect = cur.searcher.search_batch_async(qs, k=k)
        except Exception:  # noqa: BLE001 - a batch that raises fails its rows
            fail(idx)
            continue
        pending.append((t, idx, collect, cur))
        while len(pending) >= depth:
            collect_one()
    while pending:
        collect_one()
    return {"batches": b, "lat": lat, "causes": causes, "done_at": done_at, **tally}


def window(cell, state: State, seconds: float, tracer) -> Out:
    from rucene_tpu_torch.util.metrics import METRICS

    sampler = Sampler(cell.traffic["sample_rows"], cell.seed)
    before = METRICS.snapshot()
    stream = state.stream
    traced: list = []
    tracing = {"collects": -1, "n_docs": None}  # collects since the profiler started; -1: none
    if tracer is not None:
        # started before the window's clock and the stream: under ingest its
        # start-up stalls the loop 10 s or more, which would leave too few
        # of the window's batches for the traced stretch
        tracer.start()
        tracing["collects"] = 0

    def on_collect(idx, cur):
        n = tracing["collects"]
        if n < 0:
            return
        tracing["collects"] = n = n + 1
        if n == 2:
            tracer.begin()
        elif 2 < n <= 2 + cell.traffic["trace_batches"]:
            traced.append(idx)
            tracing["n_docs"] = cur.n_docs
            if n == 2 + cell.traffic["trace_batches"]:
                tracer.end()  # the profiler stops after the window: its stop stalls the host

    stream.start()
    t0 = stream.t0
    deadline = t0 + seconds
    first = cell.traffic["warm_batches"]
    try:
        with HostLoad() as host:
            got = serve(cell, state, lambda i: time.perf_counter() >= deadline, sampler,
                        on_collect, first)
        wall = time.perf_counter() - t0
    finally:
        stream.halt()
    after = METRICS.snapshot()
    if first + got["batches"] > len(state.batches):
        cell.log(f"the window wrapped round the pass of {len(state.batches)} batches: rows repeat")
    lat_ms = 1000.0 * np.asarray(got["lat"])
    p95 = float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("nan")
    q = np.percentile(lat_ms, [0, 25, 50, 75, 95, 100]) if len(lat_ms) else [float("nan")] * 6
    merges = after["counters"].get("writer.merges", 0) - before["counters"].get("writer.merges", 0)
    cell.log(f"window: {got['done']} rows in {wall:.3f} s, {got['batches']} batches; batch ms "
             f"min {q[0]:.2f} q1 {q[1]:.2f} p50 {q[2]:.2f} q3 {q[3]:.2f} p95 {q[4]:.2f} "
             f"max {q[5]:.2f} over {len(lat_ms)} batches")
    cell.log(f"rows a second in tenths of the window: {slices(got['done_at'], t0, seconds)}")
    cell.log(f"stream: {stream.acked - stream.first} docs acknowledged in the window "
             f"({(stream.acked - stream.first) / wall:.1f} docs/s), {len(state.refreshes)} "
             f"refreshes ({sum(not r[5] for r in state.refreshes)} behind schedule), {merges} "
             f"merges started, {got['stale']} rows on a stale searcher")
    cell.log(_causes(got["lat"], got["causes"]))
    cell.log("by tenth (docs acknowledged / scheduled at its last refresh, leaves, merges "
             "started in the window by then): "
             + _tenths(state.refreshes, stream, t0, seconds, before["counters"].get("writer.merges", 0)))
    timers = timer_delta(before, after)
    n = max(1, len(got["lat"]))
    cell.log("spans over the window, ms a batch (count): " + ", ".join(
        f"{name} {1000.0 * sec / n:.2f} ({cnt})" for name, (sec, cnt) in sorted(timers.items())
        if cnt and name.startswith(("search.", "reader.", "nrt.", "writer."))))
    cell.log(host.line)
    if state.broken():
        cell.log(f"the stream failed: {stream.error!r} {stream.writer.merge_exceptions!r}")
    trace = None
    if tracer is not None:
        tracer.stop()
        if len(traced) == cell.traffic["trace_batches"]:
            trace = tracer.result()
            if trace is None:
                cell.log("the capture lacks the traced window's span: no trace")
        else:
            cell.log("the window closed before the traced window did: no trace")
            traced = []
    deltas = {name: v - before["counters"].get(name, 0) for name, v in after["counters"].items()}
    return Out(
        end_to_end={"qps": got["done"] / wall, "batch_p95_ms": p95},
        attempted=got["done"] + got["failed"], failed=got["failed"], kept=sampler.take(),
        layers={"timers": timers, "counters": deltas,
                "batches": len(got["lat"]), "refreshes": len(state.refreshes), "seconds": wall,
                "n_docs": tracing["n_docs"] or state.current.n_docs},
        traced=traced, trace=trace, checks={})


def _tenths(refreshes: list, stream: Stream, t0: float, seconds: float, merges0: int) -> str:
    out = []
    width = seconds / 10
    for j in range(10):
        last = [r for r in refreshes if t0 + j * width <= r[0] < t0 + (j + 1) * width]
        if last:
            _t, acked, due, leaves, merges = last[-1][:5]
            out.append(f"{acked - stream.first}/{due - stream.first} {leaves}L {merges - merges0}M")
        else:
            out.append("-")
    return ", ".join(out)


def _causes(lat: list, causes: list) -> str:
    """What the window's batches met in flight, and what its slowest five
    met: the swing of batch_p95_ms, tied to its leaves and refreshes."""
    if not lat:
        return "no batch collected"
    leaves = np.asarray([c[0] for c in causes])
    flight = np.asarray([c[1] for c in causes])
    slow = sorted(range(len(lat)), key=lambda i: -lat[i])[:5]
    return (f"leaves a batch mean {leaves.mean():.2f} min {leaves.min()} max {leaves.max()}; "
            f"refreshes in a batch's flight mean {flight.mean():.2f}; slowest batches (ms, leaves, "
            f"refreshes in flight, their ms): " + ", ".join(
                f"{1000.0 * lat[i]:.1f} {causes[i][0]}L {causes[i][1]}R {1000.0 * causes[i][2]:.1f}"
                for i in slow))


def close(state: State) -> None:
    """Stops the ingest, closes the writer (no commit; its merges joined)
    and removes the run's copy of the base."""
    state.stream.halt()
    try:
        state.stream.writer.close()
    finally:
        shutil.rmtree(state.path, ignore_errors=True)

"""The closed loop over a committed index: a frozen copy of the bench's
``serve_mix`` (``rucene_tpu_torch/drivers/bench.py``).

Set-up opens the configuration's committed index
(``rucene_tpu_torch.open_directory_reader``, as a deployment restarts a
searcher), builds an ``IndexSearcher`` on the card, prewarms the phrase
planes where the configuration says so, and serves the pass's first
``warm_batches`` batches through the window's own loop.

The window goes on with the next batch of the pass, keeping ``in_flight``
batches of ``batch`` rows in flight through
``IndexSearcher.search_batch_async`` and collecting the oldest when that
many are queued, until ``seconds`` have gone by; then it collects what is
queued. It wraps round to the pass's start only once the pass is spent
(and says so on standard error), so no row the warm-up or the window sent
comes again while the pass lasts. Each batch's query objects are built
anew, as a client's requests are.

- ``qps``: rows answered over the window, from its start to the last
  collect;
- ``batch_p95_ms``: the 95th percentile of each batch's time from its
  dispatch to the end of its ``collect()``, over every batch of the window.

With a tracer, the profiler starts at the window's first collect (its
start-up stalls the loop for seconds); the traced window opens two
collects later and closes ``trace_batches`` collects after that, batches
in flight all through.
"""

from __future__ import annotations

import sys
import time
import traceback
from collections import deque
from typing import NamedTuple

import numpy as np
from torch.profiler import record_function

from portbench import index_cache, traffic
from portbench.check import Sampler
from portbench.loops import HostLoad, Out, slices, timer_delta

REUSE_STATE = True  # the searcher holds no state that a window changes


class State(NamedTuple):
    searcher: object
    batches: list  # row indices of each batch of a pass


def setup(cell) -> State:
    import rucene_tpu_torch as rt

    path = index_cache.committed(cell.config, cell.corpus, cell.config["docs"], cell.log,
                                   cell.cache_dir)
    searcher = rt.IndexSearcher(rt.open_directory_reader(rt.FSDirectory(path)), device=cell.device)
    if cell.config.get("prewarm_phrase_planes"):
        n = searcher.prewarm_phrase_planes(cell.config["field"])
        cell.log(f"prewarmed {n} phrase planes")
    b = cell.traffic["batch"]
    state = State(searcher, [list(range(i, min(i + b, len(cell.rows))))
                             for i in range(0, len(cell.rows), b)])
    n_warm = cell.traffic["warm_batches"]
    warm = serve(cell, state, lambda i: i >= n_warm)
    if warm["failed"]:
        cell.log(f"warm-up: {warm['failed']} rows failed")
    return state


def serve(cell, state: State, stop, sampler: Sampler | None = None, on_collect=None,
          first: int = 0) -> dict:
    """The pass's batches in order from batch ``first``, ``in_flight``
    queued, until stop(batches sent); then every queued batch is
    collected. on_collect(row indices) follows each collect."""
    k, depth, field = cell.traffic["k"], cell.traffic["in_flight"], cell.config["field"]
    searcher = state.searcher
    n_docs = searcher.reader.max_doc
    pending: deque = deque()
    lat: list = []
    done_at: list = []  # (time, rows answered) of each collect
    tally = {"done": 0, "failed": 0}

    def fail(idx):
        tally["failed"] += len(idx)
        if tally["failed"] == len(idx):  # the first failure's traceback
            traceback.print_exc(file=sys.stderr)

    def collect_one():
        t, idx, collect = pending.popleft()
        try:
            with record_function("portbench.collect"):
                res = collect()
        except Exception:  # noqa: BLE001 - a batch that raises fails its rows
            fail(idx)
            return
        now = time.perf_counter()
        lat.append(now - t)
        ok = [(i, r) for i, r in zip(idx, res) if r is not None]
        done_at.append((now, len(ok)))
        tally["done"] += len(ok)
        tally["failed"] += len(idx) - len(ok)
        if sampler is not None and ok:
            sampler.offer([i for i, _ in ok], [r for _, r in ok], n_docs)
        if on_collect is not None:
            on_collect(idx)

    b = 0
    while not stop(b):
        idx = state.batches[(first + b) % len(state.batches)]
        b += 1
        qs = traffic.to_queries([cell.rows[i] for i in idx], field)
        t = time.perf_counter()
        try:
            with record_function("portbench.dispatch"):
                collect = searcher.search_batch_async(qs, k=k)
        except Exception:  # noqa: BLE001 - a batch that raises fails its rows
            fail(idx)
            continue
        pending.append((t, idx, collect))
        while len(pending) >= depth:
            collect_one()
    while pending:
        collect_one()
    return {"batches": b, "lat": lat, "done_at": done_at, **tally}


def window(cell, state: State, seconds: float, tracer) -> Out:
    from rucene_tpu_torch.util.metrics import METRICS

    sampler = Sampler(cell.traffic["sample_rows"], cell.seed)
    before = METRICS.snapshot()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    traced: list = []
    tracing = {"collects": -1}  # collects since the profiler started; -1: not yet

    def on_collect(idx):
        n = tracing["collects"]
        if n < 0:
            if tracer is not None:
                tracer.start()
                tracing["collects"] = 0
            return
        tracing["collects"] = n = n + 1
        if n == 2:
            tracer.begin()
        elif 2 < n <= 2 + cell.traffic["trace_batches"]:
            traced.append(idx)
            if n == 2 + cell.traffic["trace_batches"]:
                tracer.end()
                tracer.stop()

    first = cell.traffic["warm_batches"]
    with HostLoad() as host:
        got = serve(cell, state, lambda i: time.perf_counter() >= deadline, sampler, on_collect,
                    first)
    wall = time.perf_counter() - t0
    if first + got["batches"] > len(state.batches):
        cell.log(f"the window wrapped round the pass of {len(state.batches)} batches: rows repeat")
    timers = timer_delta(before, METRICS.snapshot())
    lat_ms = 1000.0 * np.asarray(got["lat"])
    p95 = float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("nan")
    q = np.percentile(lat_ms, [0, 25, 50, 75, 95, 100]) if len(lat_ms) else [float("nan")] * 6
    cell.log(f"window: {got['done']} rows in {wall:.3f} s, {got['batches']} batches; batch ms "
             f"min {q[0]:.2f} q1 {q[1]:.2f} p50 {q[2]:.2f} q3 {q[3]:.2f} p95 {q[4]:.2f} "
             f"max {q[5]:.2f} over {len(lat_ms)} batches")
    cell.log(f"rows a second in tenths of the window: {slices(got['done_at'], t0, seconds)}")
    cell.log(host.line)
    trace = None
    if tracer is not None:
        if len(traced) == cell.traffic["trace_batches"]:
            trace = tracer.result()
            if trace is None:
                cell.log("the capture lacks the traced window's span: no trace")
        else:
            cell.log("the window closed before the traced window did: no trace")
            if tracing["collects"] >= 0:
                tracer.stop()
            traced = []
    return Out(
        end_to_end={"qps": got["done"] / wall, "batch_p95_ms": p95},
        attempted=got["done"] + got["failed"], failed=got["failed"], kept=sampler.take(),
        layers={"timers": timers, "batches": len(got["lat"]),
                "n_docs": state.searcher.reader.max_doc},
        traced=traced, trace=trace, checks={})


def close(state: State) -> None:
    """Nothing to release but the references, which the caller drops."""

"""Serving loops, found by the ``loop`` key of a traffic mix
(``portbench/loops/<loop>.py``). Each module has

- ``setup(cell) -> state``: opens the system under test and warms up every
  shape the window will use;
- ``window(cell, state, seconds, tracer) -> Out``: drives the system for
  ``seconds`` (and, with a tracer, a short traced stretch);
- ``close(state)``: frees the program's state before the reference runs;
- ``REUSE_STATE``: whether one state may serve windows of other seeds'
  rows (``portbench/control.py`` reads a dozen seeds in one process).
"""

from __future__ import annotations

import gc
import resource
import time
from typing import NamedTuple


class Out(NamedTuple):
    end_to_end: dict  # end-to-end metric name -> value
    attempted: int  # query rows sent in the window
    failed: int  # rows that raised or came back empty-handed
    kept: list  # check.Kept rows for the reference
    layers: dict  # raw readings for the per-layer metric readers
    traced: list  # row indices of each batch in the traced stretch
    trace: object  # trace.Trace of the traced stretch, or None
    checks: dict  # loop-specific numbers compared (check.LIMITS)


def timer_delta(before: dict, after: dict) -> dict:
    """{timer: (seconds, count)} of a METRICS snapshot pair."""
    out = {}
    for name, t in after["timers"].items():
        b = before["timers"].get(name, {"total_s": 0.0, "count": 0})
        out[name] = (t["total_s"] - b["total_s"], t["count"] - b["count"])
    return out


class HostLoad:
    """What the host did over a window, for the log: the process's CPU
    seconds (user, system) against the wall clock, and the time spent in
    Python's cyclic collector, a generation at a time."""

    def __init__(self):
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._t = 0.0

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._t
            self.gc_n[g] += 1

    def __enter__(self):
        self._r0, self._w0 = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        r, wall = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter() - self._w0
        self.line = (f"host over {wall:.3f} s: user {r.ru_utime - self._r0.ru_utime:.3f} s, "
                     f"sys {r.ru_stime - self._r0.ru_stime:.3f} s; collector "
                     + ", ".join(f"gen{g} {n} x {s:.3f} s" for g, (n, s) in
                                 enumerate(zip(self.gc_n, self.gc_s))))
        return False


def slices(done_at: list, t0: float, seconds: float, n: int = 10) -> list:
    """Rows a second in each of n equal slices of [t0, t0 + seconds), from
    (time, rows) of each collect."""
    width = seconds / n
    out = [0] * n
    for t, rows in done_at:
        i = int((t - t0) / width)
        if 0 <= i < n:
            out[i] += rows
    return [round(x / width, 1) for x in out]

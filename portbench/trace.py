"""The traced stretch of a ``--trace 1`` run: a torch.profiler capture of
a few batches, reduced in memory (nothing is written to disk).

- ``busy_s``: the union of the device's kernel, memcpy and memset
  intervals (``rucene_tpu_torch/drivers/profile_bench.py``'s arithmetic,
  copied); the device-side ranges of ``record_function`` spans cover gaps
  between kernels and are left out;
- ``window_s``: the traced window's length: ``begin()`` opens a host span,
  ``portbench.traced``, and ``end()`` closes it, and the window is that
  span's own time range in the capture, so its ends and the device events
  are read on one clock (the profiler's). A loop starts the profiler a
  batch or more before ``begin()``, so the profiler's own start-up
  (hundreds of ms to seconds) falls outside, and the window sees the loop
  in its steady state, with batches in flight;
- ``device_ops``: the ten device operations that took most time;
- ``idle_gaps``: the device's idle time within the window, summed by the
  innermost host span open at each gap's start (the program's ``search.*``
  spans, or the harness's ``portbench.*`` spans around its calls), the
  ten largest.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SPAN = "portbench.traced"  # the host span that marks the traced window


class Trace(NamedTuple):
    busy_s: float
    window_s: float
    device_ops: list  # [[name, seconds], ...]
    idle_gaps: list  # [[host span, seconds], ...]


def union(spans) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Tracer:
    """start() the profiler, begin() and end() the traced window, stop()
    the profiler; result() once the run's window has closed."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self._span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def begin(self) -> None:
        from torch.profiler import record_function

        self._span = record_function(SPAN)
        self._span.__enter__()

    def end(self) -> None:
        self._span.__exit__(None, None, None)
        self._span = None

    def stop(self) -> None:
        if self._span is not None:  # the run's window closed inside the traced one
            self.end()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()

    def result(self) -> Trace | None:
        """The capture reduced over the span from begin() to end() (the
        profiler's post-processing takes seconds)."""
        prof, self._prof = self._prof, None
        return reduce(prof.events())


def reduce(events, top: int = 10) -> Trace | None:
    """Events (times in us on the profiler's clock) clipped to the host span
    ``SPAN``'s time range; None where the capture lacks the span."""
    cuda = torch.autograd.DeviceType.CUDA
    marks = [e for e in events if e.name == SPAN and e.device_type != cuda]
    if len(marks) != 1:
        return None
    begin_us, end_us = marks[0].time_range.start, marks[0].time_range.end
    window_s = (end_us - begin_us) / 1e6
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            a, b = max(a, begin_us), min(b, end_us)
            if b <= a:
                continue
            if not e.is_user_annotation:
                dev.append((a, b, e.name))
        elif e.is_user_annotation and e.name != SPAN:  # a record_function span on the host
            host.append((a, b, e.name))
    busy = union((a, b) for a, b, _ in dev)
    busy_us = sum(b - a for a, b in busy)
    by_op: dict = {}
    for a, b, name in dev:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (b - a) / 1e6
    gaps: dict = {}
    edges = [begin_us] + [x for iv in busy for x in iv] + [end_us]
    host.sort()
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        label = "host: no span"
        for a, b, name in host:  # the innermost span open at g0 starts last
            if a > g0:
                break
            if b > g0:
                label = name
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return Trace(busy_us / 1e6, window_s, rank(by_op), rank(gaps))

"""The harness's own arithmetic: the trace reduction, the rate slices, the
sampler and the comparison."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import check, run, trace
from portbench.loops import slices
from portbench.reference import bm25


def _ev(a, b, name, cuda=False, span=False):
    import torch

    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b), name=name,
                           device_type=dt, is_user_annotation=span)


def test_trace_reduce_busy_and_gaps():
    """The traced span runs 0-1000 us. Kernels at 100-300 and 200-400 us and
    700-800 us: busy 400 us. Idle 0-100 under no span, 400-700 under
    search.device (the innermost span open at 400), 800-1000 under
    portbench.collect."""
    events = [
        _ev(0, 1000, trace.SPAN, span=True),
        _ev(100, 300, "k1", cuda=True), _ev(200, 400, "k2", cuda=True),
        _ev(700, 800, "k1", cuda=True), _ev(150, 160, "search.device", cuda=True, span=True),
        _ev(50, 950, "portbench.dispatch", span=True), _ev(350, 650, "search.device", span=True),
        _ev(790, 990, "portbench.collect", span=True), _ev(0, 5, "aten::add"),
    ]
    t = trace.reduce(events)
    assert t.busy_s == pytest.approx(400e-6)
    assert t.window_s == pytest.approx(0.001)
    assert t.device_ops == [["k1", pytest.approx(300e-6)], ["k2", pytest.approx(200e-6)]]
    gaps = dict((k, v) for k, v in t.idle_gaps)
    assert gaps == {"search.device": pytest.approx(300e-6), "portbench.collect": pytest.approx(200e-6),
                    "host: no span": pytest.approx(100e-6)}


def test_trace_window_is_the_span_on_the_captures_clock():
    """The capture's clock starts long before the traced span (a profiler
    that stalled 2.5 s as it started): the window is the span's own range,
    2,500,000-2,600,000 us. A kernel before it, one across its start and one
    after it count only inside."""
    t0 = 2_500_000
    events = [
        _ev(1_000, 900_000, "k_startup", cuda=True),
        _ev(t0 - 50, t0 + 50, "k_across", cuda=True),
        _ev(t0 + 60_000, t0 + 70_000, "k_inside", cuda=True),
        _ev(t0 + 100_500, t0 + 200_000, "k_after", cuda=True),
        _ev(t0, t0 + 100_000, trace.SPAN, span=True),
        _ev(t0, t0 + 100_000, trace.SPAN, cuda=True, span=True),  # its device-side range
    ]
    t = trace.reduce(events)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(10_050e-6)
    assert [n for n, _ in t.device_ops] == ["k_inside", "k_across"]
    assert dict(t.idle_gaps) == {"host: no span": pytest.approx(0.1 - 10_050e-6)}
    assert trace.reduce([e for e in events if e.name != trace.SPAN]) is None


def test_rate_slices():
    """Collects at 0.5 s (256 rows), 1.5 s (256), 1.9 s (128) and 2.5 s
    (past a 2 s window) in slices of 1 s."""
    done = [(10.5, 256), (11.5, 256), (11.9, 128), (12.5, 256)]
    assert slices(done, 10.0, 2.0, n=2) == [256.0, 384.0]


def test_reported_by_workloads_list():
    entries = [{"name": "a", "workloads": ["x.y"]}, {"name": "b", "workloads": ["z"]},
               {"name": "setup_s"}]
    assert [m["name"] for m in run.reported(entries, "x.y")] == ["a", "setup_s"]


def test_sampler_keeps_a_uniform_sample():
    s = check.Sampler(50, seed=3)
    for b in range(40):
        s.offer(list(range(b * 10, b * 10 + 10)), [b] * 10, 100)
    assert len(s.kept) == 50 and s.seen == 400
    rows = sorted(r for r, _, _ in s.kept)
    assert len(set(rows)) == 50 and rows[-1] > 200  # late rows are kept too


def test_compare_reads_each_fault():
    ref = bm25.top_k(np.array([1, 2, 3, 4]), np.array([1.0, 3.0, 2.0, 3.0]), 3)
    assert list(ref.docs) == [2, 4, 3]
    ok = check.Kept(0, 5, 4, np.array([2, 4, 3]), np.array([3.0, 3.0, 2.0000001]))
    assert check.compare(ok, ref, 3) == {"score_err": pytest.approx(1e-7 / 3), "rank_gap": 0.0,
                                          "count_err": 0}
    wrong_doc = check.Kept(0, 5, 4, np.array([2, 4, 1]), np.array([3.0, 3.0, 2.0]))
    assert check.compare(wrong_doc, ref, 3)["rank_gap"] == pytest.approx(1 / 3)
    unknown = check.Kept(0, 5, 4, np.array([2, 4, 9]), np.array([3.0, 3.0, 2.0]))
    assert check.compare(unknown, ref, 3)["score_err"] == 1.0
    ties = check.Kept(0, 5, 4, np.array([4, 2, 3]), np.array([3.0, 3.0, 2.0]))
    assert check.compare(ties, ref, 3)["count_err"] == 1
    short = check.Kept(0, 5, 3, np.array([2, 4]), np.array([3.0, 3.0]))
    assert check.compare(short, ref, 3)["count_err"] == 1
    assert check.verdict({"score_err": 2e-5, "count_err": 0})[0] is False

"""The port's util/metrics.py against the reference's, and the searcher's
trace spans.

(a) The same sequence of incr / observe / timed / trace calls gives equal
    snapshots in rucene_tpu_torch.util.metrics.Metrics and
    rucene_tpu.util.metrics.Metrics, mean_ms and max_ms included, under one
    scripted clock (time.perf_counter patched in both).
(b) start_profiler / stop_profiler write a Chrome trace on the CPU holding
    the trace spans, and drivers.profile_bench.analyze reads them back.
(c) One batch on the same index (a rucene_tpu index carried across with
    packed_from_reference) gives the reference's IndexSearcher and the
    port's the same ``search.*`` timer names and counts: the bench mix,
    and a batch that takes every path (term, phrase, mixed, synonym,
    span-unordered and host rows).
"""

import json
import os

import numpy as np
import pytest

import bench as ref_bench
import rucene_tpu as R
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.search import spans as ref_spans
from rucene_tpu.util import metrics as ref_metrics

import rucene_tpu_torch as T
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.drivers import profile_bench
from rucene_tpu_torch.drivers import workload
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.search import spans as port_spans
from rucene_tpu_torch.util import metrics as port_metrics


class _Clock:
    """perf_counter that steps by the next of ``steps`` on each call."""

    def __init__(self, steps):
        self.t = 100.0
        self.steps = list(steps)
        self.i = 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


def _run(mod, seq):
    reg = mod.Metrics()
    for op, *args in seq:
        if op == "incr":
            reg.incr(*args)
        elif op == "observe":
            reg.observe(*args)
        elif op == "reset":
            reg.reset()
        elif op in ("timed", "trace", "raise"):
            cm = reg.timed(args[0]) if op != "trace" else mod.trace(args[0], reg)
            try:
                with cm:
                    if op == "raise":
                        raise KeyError(args[0])
            except KeyError:
                pass
    return reg.snapshot()


SEQUENCES = {
    "counters": [("incr", "a"), ("incr", "a", 3), ("incr", "b", 0), ("incr", "c", 7)],
    "observe": [("observe", "t", 0.25), ("observe", "t", 0.5), ("observe", "t", 0.125),
                ("observe", "u", 0.0), ("incr", "a")],
    "timed": [("timed", "x"), ("timed", "x"), ("raise", "x"), ("timed", "y"),
              ("observe", "x", 2.0), ("incr", "n", 2)],
    "trace": [("trace", "search.device"), ("trace", "search.device"), ("timed", "search.batch"),
              ("trace", "search.phrases.dispatch")],
    "reset": [("timed", "x"), ("incr", "a"), ("reset",), ("timed", "x"), ("observe", "y", 1.5)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_snapshot_equals_reference(monkeypatch, name):
    seq = SEQUENCES[name]
    steps = [0.001, 0.25, 0.003, 0.5, 0.0625, 0.125]
    snaps = []
    for mod in (ref_metrics, port_metrics):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(steps))
        snaps.append(_run(mod, seq))
    ref, port = snaps
    assert port == ref
    for t in port["timers"].values():
        assert set(t) == {"total_s", "count", "mean_ms", "max_ms"}


def test_timed_keeps_mean_and_max(monkeypatch):
    monkeypatch.setattr(port_metrics.time, "perf_counter", _Clock([1.0, 0.25, 1.0, 0.75]))
    reg = port_metrics.Metrics()
    for _ in range(2):
        with reg.timed("x"):
            pass
    t = reg.snapshot()["timers"]["x"]
    assert t["count"] == 2 and t["total_s"] == pytest.approx(1.0)
    assert t["mean_ms"] == pytest.approx(500.0) and t["max_ms"] == pytest.approx(750.0)


def test_profiler_writes_a_trace_on_the_cpu(tmp_path):
    import torch

    reg = port_metrics.Metrics()
    port_metrics.start_profiler(str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError):
        port_metrics.start_profiler(str(tmp_path))  # one capture at a time
    try:
        with port_metrics.trace("search.device", reg):
            torch.arange(1000).sum()
        with port_metrics.trace("search.device", reg):
            torch.ones(10).cumsum(0)
    finally:
        path = port_metrics.stop_profiler()
    with pytest.raises(RuntimeError):
        port_metrics.stop_profiler()
    assert os.path.dirname(path) == str(tmp_path) and path.endswith(".pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "search.device" for e in events) == 2
    out = profile_bench.analyze(str(tmp_path))
    assert out["spans"]["search.device"][1] == reg.snapshot()["timers"]["search.device"]["count"]
    assert out["busy"] is None and out["ops"]  # host ops: no device events on the CPU


# --- (c) the searcher's spans -------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    texts, vocab, probs = ref_bench.build_corpus(3000)
    ref_packed = ref_bench.pack_corpus(texts)
    return texts, vocab, probs, ref_packed


def _every_path(P, S, vocab, texts):
    """Rows of every path: term, boolean, phrase, mixed (phrase MUST +
    term), synonym (SpanOr of terms), unordered span-near, and a host row
    (a nested group)."""
    tq = lambda w: P.TermQuery(P.Term("body", w))  # noqa: E731
    st = lambda w: S.SpanTermQuery(P.Term("body", w))  # noqa: E731
    w1, w2 = texts[0].split()[:2]
    a, b, c = (str(vocab[i]) for i in (11, 12, 13))
    return [
        tq(a),
        P.BooleanQuery().should(tq(a)).should(tq(b)),
        P.PhraseQuery("body", [w1, w2]),
        P.BooleanQuery().must(P.PhraseQuery("body", [w1, w2])).should(tq(c)),
        S.SpanOrQuery([st(a), st(b)]),
        S.SpanNearQuery([st(a), st(c)], slop=3, in_order=False),
        P.BooleanQuery().must(P.BooleanQuery().should(tq(a)).should(tq(b))).must(tq(c)),
    ]


def _timer_counts(metrics_mod):
    timers = metrics_mod.METRICS.snapshot()["timers"]
    return {n: t["count"] for n, t in timers.items() if n.startswith("search.")}


@pytest.mark.parametrize("batch", ["bench_mix", "every_path"])
def test_search_spans_equal_reference(corpus, batch):
    texts, vocab, probs, ref_packed = corpus
    if batch == "bench_mix":
        ref_q = ref_bench.build_queries(64, vocab, probs, phrase_texts=texts[:5000])
        port_q = workload.build_queries(64, vocab, probs, phrase_texts=texts[:5000])
    else:
        ref_q = _every_path(R, ref_spans, vocab, texts)
        port_q = _every_path(T, port_spans, vocab, texts)
    ref_s = R.IndexSearcher(RefReader([RefSnapshot("bench", ref_packed)]))
    port_s = T.IndexSearcher(
        IndexReader([SegmentSnapshot("bench", packed_from_reference(ref_packed))]), device="cpu")
    counts = []
    for mod, s, q in ((ref_metrics, ref_s, ref_q), (port_metrics, port_s, port_q)):
        s.search_batch(q, k=10)  # plans, plane and cache builds
        mod.METRICS.reset()
        s.search_batch(q, k=10)
        counts.append(_timer_counts(mod))
    ref, port = counts
    assert port == ref
    assert port["search.batch"] == 1
    spans = {"search.device.dispatch", "search.phrases.dispatch", "search.device", "search.phrases"}
    if batch == "every_path":
        spans |= {"search.mixed.dispatch", "search.mixed", "search.synonyms",
                  "search.span_unordered"}
    assert set(port) == spans | {"search.batch"}
    assert np.all(np.array(list(port.values())) == 1)

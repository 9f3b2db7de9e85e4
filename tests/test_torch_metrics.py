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
    port's the same counts of the reference's ``search.*`` timers: the
    bench mix, and a batch that takes every path (term, phrase, mixed,
    synonym, span-unordered and host rows); the port's other ``search.*``
    timers are its stage spans, as many as the batch's routes imply.
(d) A capture of an index opened from a directory, its phrase planes
    prewarmed, and one batch of term and phrase rows routed to every
    phrase route holds each stage and set-up span as a host
    record_function event, as often as METRICS timed it; each lies
    within its parent span, and no two stage spans of one path overlap.
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
from rucene_tpu_torch.native import available as native_available
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
    assert {n: port.get(n) for n in ref} == ref
    assert port["search.batch"] == 1
    spans = {"search.device.dispatch", "search.phrases.dispatch", "search.device", "search.phrases"}
    if batch == "every_path":
        spans |= {"search.mixed.dispatch", "search.mixed", "search.synonyms",
                  "search.span_unordered"}
    assert set(ref) == spans | {"search.batch"}
    assert np.all(np.array(list(ref.values())) == 1)
    # one leaf of 3,000 docs, under SPLIT_MIN_DOCS: the term and boolean
    # rows take the flat route in one call, on the dense branch; the exact
    # phrase rows go to the scalar engine (a leaf under
    # PHRASE_SCALAR_MAX_DOCS), or without it to the candidate pipeline
    counters = port_metrics.METRICS.snapshot()["counters"]
    assert counters["route.flat"] == counters["route.device"]
    assert counters["search.strategy.dense"] == 1
    stages = {
        "search.device.tables": 3,  # row classes, the batch's tables, the leaf's
        "search.device.conj_prune": 1, "search.device.combine_tables": 1,
        "search.device.launch": 2,  # the uploads; after the combine build, the executor call
        "search.device.wait": 1, "search.device.merge": 1,
        "search.phrases.select": 2,  # statistics, the leaf's selection
        "search.phrases.merge": 1,
    }
    if native_available:
        assert counters["search.phrase_scalar_route"] == counters["route.phrase"]
        stages["search.phrases.scalar"] = 1
    else:
        assert counters["search.phrase_device"] == counters["route.phrase"]
        # the block selections are memoized from the first batch
        stages.update({"search.phrases.launch": 1, "search.phrases.wait": 1})
    assert {n: c for n, c in port.items() if n not in ref} == stages


# --- (d) the stage and set-up spans in a capture ----------------------------

# each stage span and the spans it lies within: the path's outer spans, or
# for a child its parent stage; set-up spans lie within none
PARENTS = {
    "search.device.tables": ("search.device.dispatch",),
    "search.device.conj_prune": ("search.device.dispatch",),
    "search.device.combine_tables": ("search.device.dispatch",),
    "search.device.launch": ("search.device.dispatch",),
    "search.device.wait": ("search.device",),
    "search.device.merge": ("search.device",),
    "search.phrases.select": ("search.phrases.dispatch",),
    "search.phrases.postings": ("search.phrases.select",),
    "search.phrases.launch": ("search.phrases.dispatch", "search.phrases"),
    "search.phrases.plane_build": ("search.phrases.launch",),
    "search.phrases.scalar": ("search.phrases.dispatch", "search.phrases"),
    "search.phrases.wait": ("search.phrases",),
    "search.phrases.merge": ("search.phrases",),
    "reader.open": (),
    "reader.device_build": (),
    "search.prewarm_planes": (),
}
# spans of one path that never overlap (children left out)
DISJOINT = [
    ["search.device.tables", "search.device.conj_prune", "search.device.combine_tables",
     "search.device.launch", "search.device.wait", "search.device.merge"],
    ["search.phrases.select", "search.phrases.launch", "search.phrases.scalar",
     "search.phrases.wait", "search.phrases.merge"],
    ["reader.open", "reader.device_build", "search.prewarm_planes"],
]


def test_stage_spans_in_a_capture(corpus, tmp_path):
    """One batch of term, OR, AND and phrase rows on an index of 3,000 docs
    opened from a directory. The searcher's phrase thresholds are lowered
    so that the batch takes every phrase route: a rare exact phrase the
    candidate pipeline (its block selection a memo miss), an exact phrase
    of the two most frequent words the position planes (built on a cache
    miss), and a sloppy one of the same words the scalar call; the
    prewarm builds no plane, so the plane build falls in the batch."""
    texts, vocab, probs, _ref_packed = corpus
    directory = T.RAMDirectory()
    w = T.IndexWriter(directory)
    docs = []
    for t in texts:
        d = T.Document()
        d.add(T.TextField("body", t))
        docs.append(d)
    w.add_documents(docs)
    w.commit()
    w.close()

    tq = lambda x: T.TermQuery(T.Term("body", x))  # noqa: E731
    a, b = str(vocab[0]), str(vocab[1])
    port_metrics.METRICS.reset()
    port_metrics.start_profiler(str(tmp_path), device="cpu")
    try:
        s = T.IndexSearcher(T.open_directory_reader(directory), device="cpu")
        s.PHRASE_SCALAR_MAX_DOCS = 0  # no small-leaf shortcut to the scalar engine
        s.PHRASE_PLANE_MIN_DOCS = 0  # planes on any leaf
        s.PHRASE_ROW_DF_BUDGET = 100  # rows of a rarer df_min take the candidate tables
        s.prewarm_phrase_planes("body", min_blocks=1 << 30)
        df = lambda x: s.reader.doc_freq("body", x)  # noqa: E731
        rare = next(p for t in texts for p in zip(t.split(), t.split()[1:])
                    if max(df(p[0]), df(p[1])) <= 30 and p[0] != p[1])
        assert min(df(a), df(b)) > 100
        qs = [tq(a), T.BooleanQuery().should(tq(a)).should(tq(b)),
              T.BooleanQuery().must(tq(a)).must(tq(b)),
              T.PhraseQuery("body", list(rare)), T.PhraseQuery("body", [a, b]),
              T.PhraseQuery("body", [a, b], slop=2)]
        s.search_batch(qs, k=10)
    finally:
        path = port_metrics.stop_profiler()
    counters = port_metrics.METRICS.snapshot()["counters"]
    assert counters["search.phrase_device"] == 1 and counters["search.phrase_plane"] == 1
    assert counters["search.phrase_host_fallback"] == 1
    timers = {n: t["count"] for n, t in port_metrics.METRICS.snapshot()["timers"].items()}
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans: dict = {}
    for e in events:
        spans.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for name, parents in PARENTS.items():
        assert len(spans.get(name, ())) == timers.get(name) > 0, name
        for a0, a1 in spans[name]:
            if parents:
                assert any(p0 <= a0 and a1 <= p1 for p in parents for p0, p1 in spans[p]), name
    for group in DISJOINT:
        ivs = sorted(iv for name in group for iv in spans[name])
        for (_a0, a1), (b0, _b1) in zip(ivs, ivs[1:]):
            assert a1 <= b0

"""The readers of the program's stage and set-up spans
(portbench/metrics/searcher.{flat_tables,launch,wait,merge,phrase_select,
phrase_scalar}_ms.py and setup.program_s.py) on hand-made readings: each
gives the sum of its spans, never a child on top of its parent, and None
where the program times none of its spans (a program without them)."""

import pytest

from portbench import run

BOTH = ["zipf1m.mix", "zipf1m.manyword"]
NEW = {  # metric: (unit, layer, moves, workloads)
    "searcher.flat_tables_ms": ("ms", "searcher", "qps", BOTH),
    "searcher.launch_ms": ("ms", "searcher", "qps", BOTH),
    "searcher.wait_ms": ("ms", "searcher", "qps", BOTH),
    "searcher.merge_ms": ("ms", "searcher", "qps", BOTH),
    "searcher.phrase_select_ms": ("ms", "searcher", "qps", ["zipf1m.mix"]),
    "searcher.phrase_scalar_ms": ("ms", "searcher", "qps", ["zipf1m.mix"]),
    "setup.program_s": ("s", "reader", "setup_s", BOTH),
}
# a window's timers: (seconds, count), over 4 batches
TIMERS = {
    "search.batch": (9.0, 4),
    "search.device.dispatch": (1.0, 4), "search.phrases.dispatch": (1.5, 4),
    "search.device": (0.6, 4), "search.phrases": (0.2, 4),
    "search.device.tables": (0.30, 12), "search.device.conj_prune": (0.05, 4),
    "search.device.combine_tables": (0.15, 4), "search.device.launch": (0.20, 8),
    "search.phrases.launch": (0.10, 4), "search.phrases.plane_build": (0.07, 1),
    "search.device.wait": (0.40, 4), "search.phrases.wait": (0.02, 4),
    "search.device.merge": (0.12, 4), "search.phrases.merge": (0.04, 4),
    "search.phrases.select": (0.60, 8), "search.phrases.postings": (0.50, 4),
    "search.phrases.scalar": (0.08, 2),
}
WANT = {  # ms a batch
    "searcher.flat_tables_ms": 1000 * (0.30 + 0.05 + 0.15) / 4,
    "searcher.launch_ms": 1000 * (0.20 + 0.10) / 4,
    "searcher.wait_ms": 1000 * (0.40 + 0.02) / 4,
    "searcher.merge_ms": 1000 * (0.12 + 0.04) / 4,
    "searcher.phrase_select_ms": 1000 * 0.60 / 4,  # postings lies inside select
    "searcher.phrase_scalar_ms": 1000 * 0.08 / 4,
}
OUTER = ("search.batch", "search.device.dispatch", "search.phrases.dispatch", "search.device",
         "search.phrases")


def _ctx(timers, batches=4):
    return run.Ctx({"timers": timers, "batches": batches, "n_docs": 1000}, None, [], [], 10,
                   None, 1000, "cpu")


@pytest.mark.parametrize("name", sorted(WANT))
def test_stage_reader_sums_its_spans(name):
    assert run.reader(name).read(_ctx(TIMERS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_stage_reader_none_without_its_spans(name):
    """A program with only the outer spans (the stage spans' parents), and
    a window that served no batch."""
    outer = {s: TIMERS[s] for s in OUTER}
    assert run.reader(name).read(_ctx(outer)) is None
    assert run.reader(name).read(_ctx(TIMERS, batches=0)) is None


def test_scalar_reads_zero_where_no_scalar_call_was_made():
    timers = {s: t for s, t in TIMERS.items() if s != "search.phrases.scalar"}
    assert run.reader("searcher.phrase_scalar_ms").read(_ctx(timers)) == 0.0
    no_phrases = {s: t for s, t in timers.items() if not s.startswith("search.phrases.")}
    assert run.reader("searcher.phrase_scalar_ms").read(_ctx(no_phrases)) is None


def test_setup_program_s_reads_the_process_metrics(monkeypatch):
    """The three set-up spans summed from the process's registry, the plane
    builds inside the prewarm not added again; None where none was timed."""
    from rucene_tpu_torch.util import metrics

    reg = metrics.Metrics()
    monkeypatch.setattr(metrics, "METRICS", reg)
    read = run.reader("setup.program_s").read
    assert read(_ctx(TIMERS)) is None
    for name, s in (("reader.open", 1.5), ("reader.device_build", 2.0),
                    ("search.phrases.plane_build", 3.0), ("search.prewarm_planes", 3.25),
                    ("search.device.tables", 0.5)):
        reg.observe(name, s)
    assert read(_ctx(TIMERS)) == pytest.approx(1.5 + 2.0 + 3.25)


def test_entries_in_benchmark_json():
    per_layer = {m["name"]: m for m in run.load_bench()["per_layer"]}
    for name, (unit, layer, moves, workloads) in NEW.items():
        m = per_layer[name]
        assert (m["unit"], m["layer"], m["moves"], m["workloads"]) == (unit, layer, moves, workloads)
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert callable(run.reader(name).read)

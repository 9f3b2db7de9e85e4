"""The cell nrt1m.ingest at toy size on the CPU: a sound run is correct and
reports its metrics, and a run whose stream is broken underneath is not,
once for each fault the cell adds (a searcher that misses the last
acknowledged chunk, a writer held behind its schedule, a merge policy
that reorders the docs); the readers of its three per-layer metrics on
hand-made readings."""

import json
import os
import time

import pytest

import pb_tiny
from portbench import run
from portbench.loops import nrt

CELL = "nrt1m.ingest"
CORPUS = {"vocab": 3000, "exponent": 1.1, "min_words": 8, "max_words": 104, "seed": 99}
SIZES = {"configs": {"nrt1m": {"docs": 11000, "base_docs": 3000, "refresh_s": 0.25,
                               "corpus": CORPUS}},
         "traffic": {"ingest": {"queries_per_pass": 4096, "docs_per_s": 1000, "chunk_docs": 50,
                                "warm_batches": 6, "trace_batches": 4, "sample_rows": 60}}}
NEW = {"nrt.refresh_ms": "ms", "writer.host_frac": "frac", "searcher.leaves_per_batch": "leaves"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.make_root(str(tmp_path_factory.mktemp("root")), SIZES)


def one_run(root, trace=False, seed=2**31 + 17):
    return run.run_cell(CELL, seed, 2.0, trace, device="cpu", root=root,
                        t_start=time.perf_counter())


def _files(root):
    pb = os.path.join(root, "portbench")
    return {os.path.join(d, p): open(os.path.join(pb, d, p)).read()
            for d in ("configs", "traffic", "metrics")
            for p in os.listdir(os.path.join(pb, d)) if not p.startswith("__")}


def test_sound_run_is_correct(root):
    before = _files(root)
    line = one_run(root)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    traced = one_run(root, trace=True, seed=2**33 + 5)
    assert traced["correct"], traced["checks"]
    for name, unit in NEW.items():
        assert traced["metrics"][name]["unit"] == unit
    assert traced["metrics"]["searcher.leaves_per_batch"]["value"] >= 2
    assert 0 < traced["metrics"]["writer.host_frac"]["value"] < 1
    assert "setup.program_s" not in traced["metrics"]
    assert _files(root) == before
    cache = os.path.join(root, "portbench", ".cache")
    assert not [d for d in os.listdir(cache) if d.startswith(".nrt-")]  # each run's copy went


def test_searcher_missing_the_last_chunk_is_not_correct(root, monkeypatch):
    """The writer acknowledges a chunk but makes it searchable only with
    the next one: every refresh's searcher lacks the last chunk."""
    from rucene_tpu_torch.index.writer import IndexWriter

    one_run(root)  # the committed base, built with the sound writer
    orig = IndexWriter.add_documents
    held = {}

    def late(self, docs):
        prev, held[id(self)] = held.get(id(self)), list(docs)
        if prev:
            orig(self, prev)

    monkeypatch.setattr(IndexWriter, "add_documents", late)
    line = one_run(root)
    assert not line["correct"]
    assert line["checks"]["count_err"]["value"] > 0


def test_writer_behind_its_schedule_is_not_correct(root, monkeypatch):
    """From the window's start each chunk takes 0.3 s to add, six times
    its share of the schedule: the refreshes find the writer more than an
    interval behind, and their searchers' rows fail."""
    from rucene_tpu_torch.index.writer import IndexWriter

    slow = {"on": False}
    start, add = nrt.Stream.start, IndexWriter.add_documents

    def late_start(self):
        slow["on"] = True
        start(self)

    def slow_add(self, docs):
        if slow["on"]:
            time.sleep(0.3)
        add(self, docs)

    monkeypatch.setattr(nrt.Stream, "start", late_start)
    monkeypatch.setattr(IndexWriter, "add_documents", slow_add)
    line = one_run(root)
    assert not line["correct"]
    assert line["checks"]["failed_rows"]["value"] > 0


def test_reordering_merge_policy_is_not_correct(root, monkeypatch):
    """TieredMergePolicy in the stream's place: it merges the smallest
    segments wherever they lie, and the docs leave their arrival order.
    At 3 a merge from 5 segments the warm-up's equal flushes make two
    merged segments, and the next merge takes the first of them and the
    two newest flushes, across the second."""
    import rucene_tpu_torch as rt

    monkeypatch.setattr(rt, "LogDocMergePolicy", lambda merge_factor, min_merge_docs:
                        rt.TieredMergePolicy(merge_factor=3, segs_per_tier=3))
    line = one_run(root)
    assert not line["correct"]
    checks = line["checks"]
    assert (checks["rank_gap"]["value"] > checks["rank_gap"]["limit"]
            or checks["count_err"]["value"] > 0)


def _ctx(layers):
    return run.Ctx(layers, None, [], [], 10, None, 1000, "cpu")


LAYERS = {"timers": {"nrt.refresh": (0.6, 20), "writer.add_documents": (1.5, 300),
                     "writer.flush": (0.9, 20), "writer.merge": (0.6, 2),
                     "writer.get_reader": (1.0, 20), "search.device.dispatch": (3.0, 100)},
          "counters": {"search.leaves": 1450, "search.queries": 25600},
          "batches": 100, "refreshes": 20, "seconds": 30.0, "n_docs": 1000}
WANT = {"nrt.refresh_ms": 30.0, "writer.host_frac": (1.5 + 0.9) / 30.0,
        "searcher.leaves_per_batch": 14.5}


@pytest.mark.parametrize("name", sorted(WANT))
def test_new_reader_on_hand_made_readings(name):
    assert run.reader(name).read(_ctx(LAYERS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_new_reader_none_without_its_readings(name):
    """A program without the spans and the counter (the parent's), and a
    window that served no batch."""
    bare = {"timers": {"search.device.dispatch": (3.0, 100)}, "counters": {},
            "batches": 100, "seconds": 30.0}
    assert run.reader(name).read(_ctx(bare)) is None
    assert run.reader(name).read(_ctx({"timers": {}, "counters": {}, "batches": 0,
                                       "seconds": 0.0})) is None


def test_entries_in_benchmark_json():
    bench = run.load_bench()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, unit in NEW.items():
        m = per_layer[name]
        assert (m["unit"], m["workloads"]) == (unit, [CELL])
        assert callable(run.reader(name).read)
    assert CELL not in per_layer["setup.program_s"]["workloads"]
    wl = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert wl["chips"] == 1 and wl["config"] == "nrt1m" and wl["traffic"] == "ingest"
    with open(os.path.join(run.ROOT, "portbench", "traffic", "ingest.json")) as f:
        mix = json.load(f)
    with open(os.path.join(run.ROOT, "portbench", "configs", "nrt1m.json")) as f:
        cfg = json.load(f)
    # the stream's capacity holds 150 s at the cell's rate
    assert cfg["docs"] - cfg["base_docs"] >= 150 * mix["docs_per_s"]
    assert mix["docs_per_s"] % 250 == 0

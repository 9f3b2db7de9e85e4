"""The configuration zipf8m (the whole MS MARCO passage collection, one
segment on one card), its cell zipf8m.manyword and the reader of
searcher.dense_lanes_per_batch."""

import json
import os
import time

import pb_tiny
import pytest

from portbench import run

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
CELL = "zipf8m.manyword"
METRIC = "searcher.dense_lanes_per_batch"


def _config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_zipf8m_is_zipf1m_at_the_whole_collection():
    """Only the doc count and what follows from it differ: one segment of
    every doc, no phrase planes prewarmed, the assumptions that says so,
    and nothing cut."""
    z1, z8 = _config("zipf1m"), _config("zipf8m")
    differ = {k for k in set(z1) | set(z8) if z1.get(k) != z8.get(k)}
    assert differ == {"name", "deployment", "docs", "prewarm_phrase_planes", "writer", "assumed",
                      "reduced"}
    assert z8["name"] == "zipf8m" and z8["docs"] == 8_841_823
    assert z8["writer"]["max_buffered_docs"] >= z8["docs"]
    assert z8["writer"]["merge_on_commit"] is False
    assert z8["prewarm_phrase_planes"] is False and z8["reduced"] == {}
    assert z1["assumed"].items() <= z8["assumed"].items()
    assert "force-merged" in z8["assumed"]["segments"]


def test_cell_entries_in_benchmark_json():
    bench = run.load_bench()
    cfg = next(c for c in bench["configs"] if c["name"] == "zipf8m")
    assert cfg["file"] == "portbench/configs/zipf8m.json" and cfg["reduced"] == []
    wl = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("zipf8m", "manyword", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("qps", "batch_p95_ms", "searcher.dispatch_ms", "device.idle_frac",
                 "kernels.postings_roofline"):
        assert CELL in metrics[name]["workloads"]
    assert "workloads" not in metrics["setup_s"]
    m = metrics[METRIC]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "Mlanes", "lower", "program_counter", "searcher", "qps")
    assert {CELL, "zipf1m.manyword"} <= set(m["workloads"])


def test_dense_lanes_reader_on_hand_made_readings(monkeypatch):
    """The process's counter over its batches (search.batch); None without
    a batch or without the counter (a program that counts no lanes)."""
    from rucene_tpu_torch.util import metrics

    read = run.reader(METRIC).read
    reg = metrics.Metrics()
    monkeypatch.setattr(metrics, "METRICS", reg)
    ctx = run.Ctx({"timers": {}, "batches": 3, "n_docs": 1000}, None, [], [], 1000, None, 1000,
                  "cpu")
    assert read(ctx) is None
    for _ in range(5):
        reg.observe("search.batch", 0.1)
    assert read(ctx) is None
    reg.incr("search.dense_lanes", 128 * 100_000)
    reg.incr("search.dense_lanes", 128 * 150_000)
    assert read(ctx) == pytest.approx(128 * 250_000 / 5 / 1e6)


def test_toy_cell_is_correct(tmp_path):
    """The cell's path (the configuration's committed segment, the many-word
    traffic, the closed loop) at a toy size, untraced and traced."""
    root = pb_tiny.make_root(str(tmp_path), {"configs": {"zipf8m": {"docs": 3000}},
                                             "traffic": {"manyword": {"queries_per_pass": 1024}}})
    plain = run.run_cell(CELL, 2**32 + 5, 1.0, False, device="cpu", root=root,
                         t_start=time.perf_counter())
    assert plain["correct"], plain["checks"]
    assert {"qps", "batch_p95_ms", "setup_s"} <= set(plain["metrics"])
    traced = run.run_cell(CELL, 2**32 + 6, 1.0, True, device="cpu", root=root,
                          t_start=time.perf_counter())
    assert traced["correct"], traced["checks"]
    assert traced["metrics"][METRIC]["value"] > 0
    assert any(d.startswith("zipf8m-3000-") for d in os.listdir(os.path.join(root, "portbench",
                                                                             ".cache")))

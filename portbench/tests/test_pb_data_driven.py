"""The harness takes up a configuration, a traffic mix and a per-layer
metric from new files and new BENCHMARK.json entries alone: no file that
is there is edited."""

import json
import os
import time

import pb_tiny
from portbench import run

TOY_METRIC = '''"""toy.rows_a_pass: rows in the traffic's pass."""


def read(ctx):
    return float(len(ctx.rows))
'''


def test_new_files_alone(tmp_path):
    root = pb_tiny.make_root(str(tmp_path))
    pb = os.path.join(root, "portbench")
    before = {p: open(os.path.join(pb, d, p)).read()
              for d in ("configs", "traffic", "metrics")
              for p in os.listdir(os.path.join(pb, d)) if not p.startswith("__")}
    with open(os.path.join(pb, "configs", "zipf1m.json")) as f:
        toy = json.load(f)
    toy.update(name="toyconf", docs=1500, corpus={**toy["corpus"], "vocab": 3000, "seed": 99})
    with open(os.path.join(pb, "configs", "toyconf.json"), "w") as f:
        json.dump(toy, f)
    with open(os.path.join(pb, "traffic", "toymix.json"), "w") as f:
        json.dump({"loop": "closed", "queries_per_pass": 96, "batch": 32, "k": 10, "in_flight": 2,
                   "warm_batches": 2, "band": [5, 1000],
                   "classes": [{"name": "or3", "share": 1, "should": [3, 3]}],
                   "sample_rows": 40, "trace_batches": 2}, f)
    with open(os.path.join(pb, "metrics", "toy.rows_a_pass.py"), "w") as f:
        f.write(TOY_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toyconf", "source": "https://example.org/toy",
                             "file": "portbench/configs/toyconf.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"].append({"name": "toyconf.toymix", "config": "toyconf",
                               "traffic": "toymix", "chips": 1, "why": "toy"})
    for m in bench["end_to_end"]:
        if m["name"] in ("qps", "batch_p95_ms"):
            m["workloads"].append("toyconf.toymix")
    bench["per_layer"].append({"name": "toy.rows_a_pass", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "traffic", "moves": "qps",
                               "workloads": ["toyconf.toymix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    plain = run.run_cell("toyconf.toymix", 17, 1.0, False, device="cpu", root=root,
                         t_start=time.perf_counter())
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    traced = run.run_cell("toyconf.toymix", 18, 1.0, True, device="cpu", root=root,
                          t_start=time.perf_counter())
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["toy.rows_a_pass"] == {"value": 96.0, "unit": "rows"}
    assert "device.idle_frac" not in traced["metrics"]  # no device events on the CPU
    assert any(d.startswith("toyconf-1500-") for d in os.listdir(os.path.join(pb, ".cache")))
    for p, text in before.items():
        d = next(d for d in ("configs", "traffic", "metrics") if os.path.exists(os.path.join(pb, d, p)))
        assert open(os.path.join(pb, d, p)).read() == text

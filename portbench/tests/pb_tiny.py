"""A checkout root of tiny cells for CPU tests: BENCHMARK.json and the data
files copied from the repository, the configurations cut to a few
thousand docs and the passes to a few thousand rows, so a run of each
cell takes seconds on the CPU."""

from __future__ import annotations

import json
import os
import shutil

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
SIZES = {"configs": {"zipf1m": {"docs": 4000}},
         "traffic": {"mix": {"queries_per_pass": 4096}, "manyword": {"queries_per_pass": 2048}}}


def make_root(path: str, sizes: dict = SIZES) -> str:
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(PKG, d), os.path.join(path, "portbench", d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d, cuts in sizes.items():
        for name, cut in cuts.items():
            p = os.path.join(path, "portbench", d, f"{name}.json")
            with open(p) as f:
                data = json.load(f)
            data.update(cut)
            with open(p, "w") as f:
                json.dump(data, f)
    return path

"""Run one cell of the benchmark once, on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (a ``workloads`` entry of
``BENCHMARK.json``) names a configuration and a traffic mix; the harness
finds every part by name:

- the configuration: the file its ``configs`` entry names
  (``portbench/configs/<config>.json``);
- the traffic mix: ``portbench/traffic/<traffic>.json``, read by the one
  generator (``portbench/traffic.py``), whose ``loop`` names the serving
  loop, ``portbench/loops/<loop>.py``;
- each per-layer metric: its reader, ``portbench/metrics/<metric>.py``.

A run builds the corpus (the configuration's dataset) and the traffic
(from ``--seed``), sets up and warms the system under test, drives it for
``--seconds``, checks a sample of the window's answers against the plain
reference (``portbench/reference``, ``portbench/check.py``), and prints
one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; last, ``checks``, each number
compared with its limit, which also close standard error.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and if ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``rucene_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import NamedTuple  # noqa: E402

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "rucene_tpu")


def one_host_thread() -> None:
    """One thread for the CPU pools of torch, OpenMP and the BLAS libraries
    (set before they load): the program's host work is one thread of Python
    and numpy, and no pool thread spins beside it on the card host's few
    cores."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def log(msg: str) -> None:
    print(f"# [{time.perf_counter() - T_START:8.2f}s] {msg}", file=sys.stderr, flush=True)


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    corpus: object
    rows: list
    seed: int
    device: object
    log: object
    cache_dir: str  # the committed indexes' cache (portbench/.cache)


class Ctx(NamedTuple):
    """What a per-layer metric's reader gets."""

    layers: dict  # the loop's raw readings (timers over the window, spans)
    trace: object  # trace.Trace of the traced stretch, or None
    rows: list  # the pass's rows
    traced: list  # row indices of each traced batch
    k: int
    index: object  # the reference's postings (reference.bm25.Index)
    n_docs: int
    device_kind: str


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def reader(name: str, root: str = ROOT):
    """The per-layer metric reader portbench/metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reported(entries: list, workload: str) -> list:
    """The metric entries a cell reports: those whose ``workloads`` list it,
    and every entry without the key."""
    return [m for m in entries if workload in m.get("workloads", [workload])]


def load_cell(workload: str, root: str = ROOT):
    """(BENCHMARK.json, the workload entry, its configuration, its traffic
    mix, the configuration's corpus, its serving loop module)."""
    from portbench import corpus as corpus_mod
    from portbench import traffic

    bench = load_bench(root)
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    mix = traffic.load(wl["traffic"], os.path.join(root, "portbench", "traffic"))
    corpus = corpus_mod.build({**config["corpus"], "docs": config["docs"]})
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")
    return bench, wl, config, mix, corpus, loop


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: str = ROOT, t_start: float = T_START) -> dict:
    """One run of a cell; returns the result line (a dict)."""
    import torch

    from portbench import check, traffic
    from portbench.reference import bm25
    from portbench.trace import Tracer

    bench, wl, config, mix, corpus, loop = load_cell(workload, root)
    dev = torch.device(device)
    rows = traffic.build_rows(mix, corpus, seed)
    log(f"{workload}: {corpus.n_docs} docs, {len(rows)} rows a pass, seed {seed}")
    cell = Cell(workload, config, mix, corpus, rows, seed, dev, log,
                os.path.join(root, "portbench", ".cache"))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state = loop.setup(cell)
    gc.collect()
    gc.freeze()  # set-up's objects: the window's collections do not walk them
    setup_s = time.perf_counter() - t_start
    log(f"set-up done in {setup_s:.2f} s")
    out = loop.window(cell, state, seconds, Tracer(dev) if trace else None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    loop.close(state)
    del state
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    index = bm25.Index(corpus.tokens, corpus.offsets, len(corpus.probs))
    scorers: dict = {}

    def answer(kept):
        sc = scorers.get(kept.n_docs)
        if sc is None:
            sc = scorers[kept.n_docs] = bm25.Scorer(index, kept.n_docs)
        return sc.answer(rows[kept.row], mix["k"])

    extra = {"failed_rows": out.failed, **out.checks}
    readings = check.judge(out.kept, answer, mix["k"], extra)
    if not out.kept:
        log("no answered row to check")
        readings["count_err"] = 1
    correct, checks = check.verdict(readings)
    log(f"reference: {len(out.kept)} rows checked in {time.perf_counter() - t_ref:.2f} s")

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    metrics = {}
    e2e = reported(bench["end_to_end"], workload)
    if trace:
        ctx = Ctx(out.layers, out.trace, rows, out.traced, mix["k"], index,
                  out.layers.get("n_docs", corpus.n_docs), kind)
        for m in reported(bench["per_layer"], workload):
            value = reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **out.end_to_end}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                       "count": wl["chips"] if cuda else 0, "memory_peak_bytes": peak}}
    if trace and out.trace is not None:
        line["device"].update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        line["breakdown"] = {"device_ops": out.trace.device_ops, "idle_gaps": out.trace.idle_gaps}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = os.path.join(PKG, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    one_host_thread()

    import torch

    torch.set_num_threads(1)

    wl = next((w for w in load_bench()["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

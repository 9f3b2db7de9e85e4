"""A torch.profiler capture of the bench's batches, and where its time
went (counterpart of tools/profile_bench.py).

    python -m rucene_tpu_torch.drivers.profile_bench [--docs N] [--batches 3] [--reader packed]
        [--log-dir profile_out] [--analyze-only] [--device cpu]

``capture`` warms the searcher up on the batches, then traces them through
util/metrics.start_profiler / stop_profiler, which write a Chrome trace
under the log directory. ``analyze`` reads the newest trace there and
prints, from that one capture:
  - per CUDA kernel (and memcpy / memset), its ms and launch count, the
    top 25 (on a capture without device events, the host's ops instead);
  - the device's busy share: the union of the device events' intervals
    over the traced span, from the first event to the last;
  - the host spans' totals: the engine's trace spans (search.batch's
    phases, util/metrics' timer list) and any other record_function.
Keep a capture to 1-3 batches: with the CUDA activity on, a trace of a
1M-doc pass runs to hundreds of MB.

``profile_fn`` is the in-process form chip_smoke.py uses: (kernel ms a
pass, busy share over the wall time, the top kernels) of a callable.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_fn(one_pass, passes: int = 3, top: int = 10):
    """(kernel ms per pass, device busy share: the union of kernel
    intervals over the wall time, the ``top`` kernels by device time as
    [name, ms per pass]) over ``passes`` calls of one_pass() on the card.
    Span annotations on the device timeline are not kernels and are left
    out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(passes):
            one_pass()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the device-side ranges of record_function spans (util/metrics.trace)
    # cover gaps between kernels: not device work
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    total = sum(b - a for a, b in spans)
    busy = _union_us(spans)
    by_name: dict = {}
    for e in events:
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return total / 1e3 / passes, busy / wall_us, [[n, us / 1e3 / passes] for n, us in ranked]


def capture(log_dir: str, searcher, batches, k: int = 100, warm: int = 2) -> str:
    """Serve each batch ``warm`` times, then once more under the profiler;
    returns the trace's path."""
    from rucene_tpu_torch.util.metrics import start_profiler, stop_profiler

    for _ in range(warm):
        for b in batches:
            searcher.search_batch(b, k=k)
    start_profiler(log_dir, searcher.device)
    t0 = time.perf_counter()
    try:
        for b in batches:
            searcher.search_batch(b, k=k)
        if searcher.device.type == "cuda":
            torch.cuda.synchronize(searcher.device)
    finally:
        wall = time.perf_counter() - t0
        path = stop_profiler()
    rows = sum(len(b) for b in batches)
    print(f"# traced {len(batches)} batches in {wall:.3f}s ({rows / wall:.0f} QPS under the "
          f"profiler) -> {path}", file=sys.stderr, flush=True)
    return path


def latest_trace(log_dir: str) -> str:
    paths = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {log_dir}")
    return max(paths, key=os.path.getmtime)


def analyze(path: str, top: int = 25) -> dict:
    """Print the capture's figures (the top ``top`` ops) and return them:
    ``ops`` [name, ms, count] of every device op by ms (host ops without
    device events), ``busy`` (device busy
    share over the span; None without device events), ``span_ms`` and
    ``spans`` {record_function name: [ms, count]}."""
    if os.path.isdir(path):
        path = latest_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path} holds no complete events")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ops = dev or [e for e in events if e.get("cat") == "cpu_op"]
    t_min = min(e["ts"] for e in events)
    t_max = max(e["ts"] + e["dur"] for e in events)
    span_us = max(t_max - t_min, 1e-9)
    tot: dict = {}
    cnt: dict = {}
    for e in ops:
        tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"] / 1e3
        cnt[e["name"]] = cnt.get(e["name"], 0) + 1
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])
    busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in dev) / span_us if dev else None
    spans: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ms, n = spans.get(e["name"], (0.0, 0))
            spans[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    kind = "device kernels" if dev else "host ops (no device events in this capture)"
    print(f"=== {path}: {len(events)} events over {span_us / 1e3:.2f} ms")
    print(f"-- top {min(top, len(ranked))} {kind} by total ms")
    for name, ms in ranked[:top]:
        print(f"   {ms:9.3f}ms  x{cnt[name]:<5d} {name[:110]}")
    if busy is None:
        print("-- device busy: not measured (no device events)")
    else:
        print(f"-- device busy {100 * busy:.1f}% of the traced span")
    print("-- host spans")
    for name, (ms, n) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        print(f"   {ms:9.3f}ms  x{n:<5d} {name}")
    return {"ops": [[n, ms, cnt[n]] for n, ms in ranked], "busy": busy,
            "span_ms": span_us / 1e3, "spans": {n: list(v) for n, v in spans.items()}}


def main(argv=None) -> dict:
    from rucene_tpu_torch.drivers import bench, require_device
    from rucene_tpu_torch.drivers import workload as wl

    p = argparse.ArgumentParser(prog="python -m rucene_tpu_torch.drivers.profile_bench")
    p.add_argument("--docs", type=int, default=0,
                   help="corpus size (default: largest cached <= 1M, else 50000)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--batches", type=int, default=3, help="passes of the batch traced")
    p.add_argument("--cache", default=bench.DEFAULT_CACHE)
    p.add_argument("--reader", choices=("decoded", "packed"), default="decoded")
    p.add_argument("--device", default="cuda")
    p.add_argument("--log-dir", default="profile_out")
    p.add_argument("--analyze-only", action="store_true")
    args = p.parse_args(argv)
    if not args.analyze_only:
        dev = require_device(args.device)
        n_docs = args.docs or wl.default_docs(args.cache, "zipf")
        packed, queries = bench.bench_index(n_docs, args.batch, "zipf", args.cache)
        searcher = bench.open_searcher(packed, dev, args.reader)
        searcher.prewarm_phrase_planes()
        capture(args.log_dir, searcher, [queries] * args.batches, args.k)
    return analyze(args.log_dir)


if __name__ == "__main__":
    main()

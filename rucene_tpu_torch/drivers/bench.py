"""The bench on the port: batched BM25 search QPS on one card (counterpart
of bench.py's ``main`` and ``main_nrt``).

    python -m rucene_tpu_torch.drivers.bench [--docs N] [--reader packed] [--device cpu]
    python -m rucene_tpu_torch.drivers.bench --nrt [--seconds 45] [--refresh-s 0.5]

Prints one JSON line on stdout, with bench.py's keys:
  {"metric": ..., "value": QPS, "unit": "queries/sec/chip",
   "vs_baseline": QPS / baseline QPS, "bandwidth_frac": x}
and its context lines on stderr: rows per route, the timers of the timed
passes only (search.batch and the trace spans of util/metrics), the batch
latency p50 / p99, the postings traffic, the index build and the
baseline.

Workload (drivers/workload.py, bench.py's): the Zipf corpus (or
``--corpus pytext``), the mix of 3/8 single-term, 2/8 OR, 2/8 AND and 1/8
exact phrase rows, 512 queries, batch 256, k=100. ``--docs`` defaults to
the largest corpus in the ``--cache`` directory of at most 1M docs, else
50,000; a cold build is packed and cached there (``--cache ''`` turns the
cache off). ``--reader decoded`` builds the decoded residency (through
the decode kernel), ``--reader packed`` keeps the postings packed (each
batch decodes through the scoring decode kernel). Serving: the resident
phrase planes are prewarmed, one warm pass runs the whole mix, then
``serve_mix`` keeps ``--pipeline`` batches (3) in flight for at least 3
passes and 5 s, at most 20 passes.

- vs_baseline: a live run, on the same host and the same packed index, of
  the port's single-core scalar C++ engine (search/scalar_engine.py, the
  median of 5-9 passes) or, with ``--baseline numpy`` or when the native
  engine is missing, of the numpy host engine over 32 rows. BASELINE.json's
  pinned figure is not read: it was measured on another host.
- bandwidth_frac: the decoded lanes the executors touched in the timed
  passes (``search.flat_lanes``, 10 bytes a lane: i32 doc, u16 freq, f32
  cval) over the wall time, as a share of the H100's 3.35 TB/s. The
  reference adds its ``search.plane_bytes`` counter, which the port does
  not keep (ROADMAP.md, left out on purpose), so plane traffic is not
  counted. On the CPU it is null: it names a device metric.
- ``--nrt`` (bench.py's main_nrt, BASELINE.json config 4): a writer thread
  adds docs (``--ingest-rate`` a second, 250 a chunk, a commit every
  2,000) to a RAMDirectory index of ``--docs`` base docs (200,000) while
  the foreground serves 256 queries in batches of 128 through a
  SearcherManager refreshed every ``--refresh-s`` seconds, for
  ``--seconds``; ``--combine`` serves each reader through its combined
  view. vs_baseline is 0.0, as bench.py prints it.

bench.py's BENCH_PRUNE has no counterpart: WAND is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np

from rucene_tpu_torch.drivers import device_name, require_device
from rucene_tpu_torch.drivers import workload as wl

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
LANE_BYTES = 10  # i32 doc + u16 freq + f32 cval
DEFAULT_CACHE = os.path.join(tempfile.gettempdir(), "rtpu_bench_cache")
ROUTE_KEYS = (
    "route.device", "route.phrase", "route.synonym", "route.host",
    "search.phrase_host_fallback", "search.phrase_plane_build",
    "search.phrase_plane_denied", "search.conj_pruned_blocks",
)


def log(msg: str) -> None:
    print(f"# {msg}", flush=True, file=sys.stderr)


class Served(NamedTuple):
    qps: float
    reps: int
    wall_s: float
    batch_ms: list  # each batch, from its dispatch to the end of its collect()
    results: list  # the last pass's TopDocs, in query order


def serve_mix(searcher, queries, batch: int = 256, k: int = 100, depth: int = 3,
              min_s: float = 5.0, max_reps: int = 20) -> Served:
    """Pipelined passes over ``queries`` on an open searcher: ``depth``
    batches in flight (search_batch_async), so batch N+1's host work
    overlaps batch N's device work; at least 3 passes and ``min_s``
    seconds, at most ``max_reps`` passes."""
    depth = max(1, depth)
    pending: deque = deque()
    results: list = [None] * len(queries)
    batch_ms: list = []

    def collect_one():
        t_dispatch, start, collect = pending.popleft()
        results[start : start + batch] = collect()
        batch_ms.append(1000.0 * (time.perf_counter() - t_dispatch))

    t0 = time.perf_counter()
    reps = 0
    while time.perf_counter() - t0 < min_s or reps < 3:
        for start in range(0, len(queries), batch):
            pending.append((time.perf_counter(), start,
                            searcher.search_batch_async(queries[start : start + batch], k=k)))
            while len(pending) >= depth:
                collect_one()
        reps += 1
        if reps >= max_reps:
            break
    while pending:
        collect_one()
    wall = time.perf_counter() - t0
    return Served(reps * len(queries) / wall, reps, wall, batch_ms, results)


def latency_line(batch_ms) -> str:
    p50, p99 = np.percentile(np.asarray(batch_ms), [50, 99])
    return f"batch latency p50 {p50:.2f} ms, p99 {p99:.2f} ms over {len(batch_ms)} batches"


def open_searcher(packed, device, reader: str = "decoded"):
    """An IndexSearcher over one segment on ``device``, its device form
    built now under RUCENE_DECODED: 1 for ``decoded``, 0 for ``packed``."""
    from rucene_tpu_torch import IndexSearcher
    from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot

    searcher = IndexSearcher(IndexReader([SegmentSnapshot("bench", packed)]), device=device)
    prev = os.environ.get("RUCENE_DECODED")
    os.environ["RUCENE_DECODED"] = {"decoded": "1", "packed": "0"}[reader]
    try:
        for leaf in searcher.reader.leaves:
            leaf.device  # noqa: B018 - builds the device form under the knob
    finally:
        if prev is None:
            os.environ.pop("RUCENE_DECODED")
        else:
            os.environ["RUCENE_DECODED"] = prev
    return searcher


def bench_index(n_docs: int, n_queries: int, corpus_kind: str, cache_dir: str | None):
    """(packed segment, the mix's queries): the cached segment when
    ``cache_dir`` holds it, else the corpus packed (and cached). A cached
    Zipf index draws its phrase bigrams from 2,000 fresh
    docs of the same distribution (seed 77), as bench.py does."""
    from rucene_tpu_torch.codec import files as segfiles
    from rucene_tpu_torch.store.directory import FSDirectory

    t0 = time.time()
    packed = None
    seg_name = wl.segment_name(corpus_kind, n_docs)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cdir = FSDirectory(cache_dir)
        if cdir.file_exists(segfiles.segment_file(seg_name)):
            log(f"loading cached index {seg_name} from {cache_dir}")
            packed = segfiles.read_segment(cdir, seg_name)
    if corpus_kind == "pytext":
        texts, vocab, probs = wl.build_corpus_pytext(
            n_docs if packed is None else min(n_docs, 200_000))
        phrase_texts = texts[:5000]
    elif packed is not None:
        texts = None
        vocab, probs = wl.zipf_vocab()
        phrase_texts, _, _ = wl.build_corpus(2000, seed=77)
    else:
        texts, vocab, probs = wl.build_corpus(n_docs)
        phrase_texts = texts[:5000]
    queries = wl.build_queries(n_queries, vocab, probs, phrase_texts=phrase_texts)
    log(f"corpus ready ({time.time() - t0:.0f}s)")
    if packed is None:
        packed = wl.pack_corpus(texts, log=lambda m: log(f"{m} ({time.time() - t0:.0f}s)"))
        if cache_dir:
            wl.cache_segment(cache_dir, seg_name, packed)
            log(f"cached to {cache_dir}")
    return packed, queries


def baseline_qps(searcher, queries, k: int, kind: str) -> tuple[float, str]:
    """(QPS, label) of the single-core baseline on this host over the
    searcher's one leaf: the scalar C++ engine (the median pass of 5-9,
    at least 10 s) or the numpy host engine (32 rows)."""
    from rucene_tpu_torch.search import host_engine

    leaf = searcher.reader.leaves[0]
    rqs = [q.rewrite() for q in queries]
    doc_freqs, stats = searcher._gather_stats(rqs)
    if kind == "scalar":
        from rucene_tpu_torch.search.scalar_engine import ScalarSearcher

        try:
            sc = ScalarSearcher(leaf, searcher.similarity, stats, doc_freqs)
            sc.search_batch(rqs, k=k)  # warm pass
            rep_times = []
            t0 = time.time()
            while time.time() - t0 < 10.0 or len(rep_times) < 5:
                r0 = time.time()
                sc.search_batch(rqs, k=k)
                rep_times.append(time.time() - r0)
                if len(rep_times) >= 9:
                    break
            return len(rqs) / float(np.median(rep_times)), (
                f"single-core scalar C++ engine (median of {len(rep_times)} reps, "
                f"spread {min(rep_times):.2f}-{max(rep_times):.2f}s)")
        except (RuntimeError, ValueError) as e:
            log(f"scalar baseline unavailable ({e}); falling back to numpy")
    sample = rqs[:: max(1, len(rqs) // 32)][:32]
    t0 = time.time()
    for rq in sample:
        host_engine.execute_on_segment(leaf, rq, searcher.similarity, stats, doc_freqs, k)
    return len(sample) / (time.time() - t0), "single-core numpy engine"


def timed_delta(full: dict, warm: dict):
    """(counter deltas, [(timer, seconds, count)] by seconds) of the timed
    passes."""
    counters = {key: v - warm["counters"].get(key, 0) for key, v in full["counters"].items()}
    wt = warm["timers"]
    timers = sorted(
        ((name, t["total_s"] - wt.get(name, {}).get("total_s", 0.0),
          t["count"] - wt.get(name, {}).get("count", 0)) for name, t in full["timers"].items()),
        key=lambda x: -x[1],
    )
    return counters, timers


def main(args) -> dict:
    from rucene_tpu_torch.util.metrics import METRICS

    dev = require_device(args.device)
    n_queries = args.queries or 512
    batch = args.batch or 256
    n_docs = args.docs or wl.default_docs(args.cache, args.corpus)
    t0 = time.time()
    packed, queries = bench_index(n_docs, n_queries, args.corpus, args.cache)
    searcher = open_searcher(packed, dev, args.reader)
    build_s = time.time() - t0
    log(f"index ready ({build_s:.0f}s), {args.reader} reader on {device_name(dev)}, searching")
    tw = time.time()
    n_planes = searcher.prewarm_phrase_planes()
    log(f"prewarmed {n_planes} phrase planes in {time.time() - tw:.0f}s")

    for i in range(0, n_queries, batch):  # warm pass
        searcher.search_batch(queries[i : i + batch], k=args.k)
    warm = METRICS.snapshot()
    served = serve_mix(searcher, queries, batch, args.k, args.pipeline)
    counters, timers = timed_delta(METRICS.snapshot(), warm)
    log("routes: " + " ".join(f"{key.split('.', 1)[1]}={counters.get(key, 0)}"
                              for key in ROUTE_KEYS))
    log("timers(timed-only): " + " ".join(
        f"{name}={tot:.2f}s/{cnt}" for name, tot, cnt in timers[:12] if cnt))
    log(latency_line(served.batch_ms) + f" (pipeline depth {args.pipeline})")

    base_qps, base_label = baseline_qps(searcher, queries, args.k, args.baseline)
    lanes = counters.get("search.flat_lanes", 0)
    total_bytes = lanes * LANE_BYTES
    bytes_per_s = total_bytes / served.wall_s
    bandwidth_frac = round(bytes_per_s / HBM_BYTES_PER_S, 4) if dev.type == "cuda" else None
    share = "not a device figure" if bandwidth_frac is None else (
        f"{100 * bandwidth_frac:.2f}% of HBM peak")
    log(f"postings traffic: {total_bytes / 1e9:.2f} GB of decoded lanes over "
        f"{served.wall_s:.2f}s = {bytes_per_s / 1e9:.1f} GB/s ({share})")
    result = {
        "metric": f"BM25 top-{args.k} QPS, {n_docs} docs, mixed term/bool/phrase "
        f"batch={batch}, {args.reader} reader on {device_name(dev)}",
        "value": round(served.qps, 1),
        "unit": "queries/sec/chip",
        "vs_baseline": round(served.qps / base_qps, 2),
        "bandwidth_frac": bandwidth_frac,
    }
    print(json.dumps(result), flush=True)
    print(f"# index build: {build_s:.1f}s ({n_docs / build_s:.0f} docs/s), "
          f"index {packed.index_bytes() / 1e6:.1f} MB, "
          f"baseline({base_label}): {base_qps:.1f} qps", file=sys.stderr, flush=True)
    return result


def main_nrt(args) -> dict:
    """Concurrent ingest, NRT refresh and batched search (BASELINE.json
    config 4); see the module docstring."""
    from rucene_tpu_torch import Document, IndexSearcher, TextField
    from rucene_tpu_torch.index.merge import TieredMergePolicy
    from rucene_tpu_torch.index.writer import IndexWriter, IndexWriterConfig
    from rucene_tpu_torch.search.search_manager import SearcherManager
    from rucene_tpu_torch.store.directory import RAMDirectory

    dev = require_device(args.device)
    n_docs = args.docs or 200_000
    n_queries = args.queries or 256
    batch = args.batch or 128
    k = args.k

    texts, vocab, probs = wl.build_corpus(n_docs + 50_000)
    queries = wl.build_queries(n_queries, vocab, probs, phrase_texts=texts[:5000])

    def docs_of(chunk):
        out = []
        for t in chunk:
            d = Document()
            d.add(TextField("body", t))
            out.append(d)
        return out

    # merges wait while serving (the reference throttles them the same way)
    w = IndexWriter(RAMDirectory(), IndexWriterConfig(
        max_buffered_docs=25_000, merge_policy=TieredMergePolicy(segs_per_tier=64),
        merge_on_commit=False,
    ))
    w.add_documents(docs_of(texts[:n_docs]))
    w.commit()
    log(f"nrt: base index {n_docs} docs ready on {device_name(dev)}")
    mgr = SearcherManager(w, searcher_factory=lambda r: IndexSearcher(
        r, device=dev, combine_segments=args.combine))
    stop = threading.Event()
    ingested = [0]
    failed: list = []

    def ingest():
        chunk = 250
        i = n_docs + 2000  # the warm refresh took the first 2,000
        try:
            while not stop.is_set() and i < len(texts):
                t0 = time.time()
                docs = docs_of(texts[i : i + chunk])
                w.add_documents(docs)
                i += len(docs)
                ingested[0] += len(docs)
                if ingested[0] % 2000 < chunk:
                    w.commit()
                if args.ingest_rate > 0:
                    time.sleep(max(0.0, chunk / args.ingest_rate - (time.time() - t0)))
        except Exception as e:  # noqa: BLE001 - reported by the serving thread
            failed.append(e)

    def warm_pass():
        s = mgr.acquire()
        try:
            for i in range(0, n_queries, batch):
                s.search_batch(queries[i : i + batch], k=k)
        finally:
            mgr.release(s)

    warm_pass()
    w.add_documents(docs_of(texts[n_docs : n_docs + 2000]))
    w.commit()
    mgr.maybe_refresh()
    warm_pass()

    th = threading.Thread(target=ingest, daemon=True)
    th.start()
    served = refreshes = 0
    refresh_cost = 0.0
    batch_ms = []
    last_refresh = time.time()
    t0 = time.time()
    qi = 0
    try:
        while time.time() - t0 < args.seconds and not failed:
            if time.time() - last_refresh >= args.refresh_s:
                r0 = time.time()
                mgr.maybe_refresh()
                refresh_cost += time.time() - r0
                refreshes += 1
                last_refresh = time.time()
            s = mgr.acquire()
            try:
                b0 = time.perf_counter()
                s.search_batch(queries[qi : qi + batch] or queries[:batch], k=k)
                batch_ms.append(1000.0 * (time.perf_counter() - b0))
            finally:
                mgr.release(s)
            served += batch
            qi = (qi + batch) % n_queries
        wall = time.time() - t0
    finally:
        stop.set()
        th.join(timeout=60)
        w.close()
    if failed:
        raise RuntimeError("the ingest thread failed") from failed[0]
    result = {
        "metric": f"NRT BM25 top-{k} QPS under concurrent ingest, {n_docs} base docs, "
        f"refresh every {args.refresh_s}s, on {device_name(dev)}",
        "value": round(served / wall, 1),
        "unit": "queries/sec/chip",
        "vs_baseline": 0.0,
    }
    print(json.dumps(result), flush=True)
    log(f"nrt: ingested {ingested[0]} docs ({ingested[0] / wall:.0f}/s) while serving; "
        f"{refreshes} refreshes, mean {1000 * refresh_cost / max(refreshes, 1):.0f} ms; "
        + latency_line(batch_ms))
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rucene_tpu_torch.drivers.bench", description=__doc__.split("\n\n")[0])
    p.add_argument("--nrt", action="store_true", help="concurrent ingest + NRT search")
    p.add_argument("--docs", type=int, default=0,
                   help="corpus size (default: largest cached <= 1M, else 50000; --nrt 200000)")
    p.add_argument("--queries", type=int, default=0, help="queries in the mix (512; --nrt 256)")
    p.add_argument("--batch", type=int, default=0, help="rows a batch (256; --nrt 128)")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--corpus", choices=("zipf", "pytext"), default="zipf")
    p.add_argument("--cache", default=DEFAULT_CACHE,
                   help="directory of packed bench indexes ('' turns it off)")
    p.add_argument("--reader", choices=("decoded", "packed"), default="decoded")
    p.add_argument("--pipeline", type=int, default=3, help="batches in flight")
    p.add_argument("--baseline", choices=("scalar", "numpy"), default="scalar")
    p.add_argument("--device", default="cuda")
    p.add_argument("--refresh-s", type=float, default=0.5, help="--nrt: seconds between refreshes")
    p.add_argument("--seconds", type=float, default=45.0, help="--nrt: serving window")
    p.add_argument("--ingest-rate", type=float, default=2000.0,
                   help="--nrt: docs a second (0: unthrottled)")
    p.add_argument("--combine", action="store_true",
                   help="--nrt: serve each reader through its combined view")
    return p.parse_args(argv)


if __name__ == "__main__":
    _args = parse_args()
    (main_nrt if _args.nrt else main)(_args)

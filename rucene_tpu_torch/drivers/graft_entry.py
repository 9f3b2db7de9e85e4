"""Graft entry points on the port (counterpart of __graft_entry__.py).

- ``entry(device="cuda")`` -> (fn, example_args): the flat executor's
  batched BM25 step on one 512-doc segment, 16 term and two-term OR rows
  at k=10; ``fn(*example_args)`` returns (scores f32[16,10], docs
  i32[16,10], total_hits i32[16]).
- ``dryrun_multichip(n, device="cuda")``: one sharded serving step over n
  shards in n processes (parallel/multi_host.py: NCCL, one card a
  process; gloo on the CPU): each process loads its own shard of an index
  on disk (ShardedIndex.from_directory) and ShardedSearcher serves the
  reference's rows (boolean, exact and sloppy phrase, range, range + term,
  ordered span-near; dismax and unordered span-near on the fallback,
  counted), every answer held against a one-process IndexSearcher over
  the same files.

    python -m rucene_tpu_torch.drivers.graft_entry [--device cpu] [--shards N]

The reference's tpu_kernel_parity_smoke has no counterpart here:
chip_smoke.py's phases 7, 9 and 14 hold each CUDA kernel against its
plain twin on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from rucene_tpu_torch.drivers import require_device

RTOL = 4e-7  # tests/torch_hitcheck.py's tolerance
WORKER_TIMEOUT_S = 600
VOCAB = [f"term{i}" for i in range(200)]


def _texts(n_docs: int, seed: int = 0) -> list[str]:
    """The reference's smoke corpus: VOCAB at 1/rank weights, 5-29 words a
    doc."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, len(VOCAB) + 1)
    weights /= weights.sum()
    return [
        " ".join(rng.choice(VOCAB, size=int(rng.integers(5, 30)), p=weights))
        for _ in range(n_docs)
    ]


def _build_index(n_docs: int, seed: int = 0, n_segments: int = 1):
    """Tiny synthetic index (the texts above, an IntPoint ``n`` per doc)
    as an IndexReader of n_segments packed segments."""
    from rucene_tpu_torch import Document, IntPoint, TextField
    from rucene_tpu_torch.codec.postings import pack_segment
    from rucene_tpu_torch.index.memory import SegmentBuffer
    from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot

    texts = _texts(n_docs, seed)
    bounds = np.linspace(0, n_docs, n_segments + 1).astype(int)
    snaps = []
    for si in range(n_segments):
        buf = SegmentBuffer()
        for gj in range(bounds[si], bounds[si + 1]):
            d = Document()
            d.add(TextField("body", texts[gj]))
            d.add(IntPoint("n", gj))
            buf.add_document(d)
        snaps.append(SegmentSnapshot(f"s{si}", pack_segment(buf.finish())))
    return IndexReader(snaps), VOCAB


def entry(device="cuda"):
    """(fn, example_args): the batched BM25 search step on one segment.
    fn decodes the postings blocks of every (row, clause), scores them with
    BM25, applies the boolean masks and returns the exact top-k, ties by
    doc id: the serving path's forward step."""
    from rucene_tpu_torch import BooleanQuery, IndexSearcher, Term, TermQuery
    from rucene_tpu_torch.search.executor import execute_flat_impl
    from rucene_tpu_torch.search.flat_tables import (
        build_clause_tables,
        build_flat_work,
        build_leaf_cache,
        build_leaf_tables,
        make_flat_batch,
    )

    dev = require_device(device)
    reader, vocab = _build_index(512)
    searcher = IndexSearcher(reader, device=dev)
    queries = []
    for i in range(16):
        if i % 2 == 0:
            queries.append(TermQuery(Term("body", vocab[i % 50])))
        else:
            q = BooleanQuery()
            q.should(TermQuery(Term("body", vocab[i % 50])))
            q.should(TermQuery(Term("body", vocab[(i * 3) % 50])))
            queries.append(q)
    rqs = [q.rewrite() for q in queries]
    doc_freqs, stats = searcher._gather_stats(rqs)
    b, t = 16, 2
    weight, occur, n_required, min_should, _, _ = build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, t
    )
    leaf = reader.leaves[0]
    cache = build_leaf_cache(leaf, searcher.similarity, stats)
    bs, bc, fid = build_leaf_tables(leaf, rqs, b, t)
    work = build_flat_work(bs, bc, weight, fid, occur)
    fq = make_flat_batch(work, n_required, min_should, cache, leaf.device)

    def fn(seg, fq):
        return execute_flat_impl(seg, fq, k=10)

    return fn, (leaf.device, fq)


def _dryrun_queries(vocab, n_docs: int):
    """(rows, how many the shard program serves): the reference's dry-run
    rows, the last two on the fallback."""
    from rucene_tpu_torch import (
        BooleanQuery,
        DisjunctionMaxQuery,
        PhraseQuery,
        PointRangeQuery,
        Term,
        TermQuery,
    )
    from rucene_tpu_torch.search.spans import SpanNearQuery, SpanTermQuery

    queries = []
    for i in range(8):
        q = BooleanQuery()
        q.must(TermQuery(Term("body", vocab[i % 20])))
        q.should(TermQuery(Term("body", vocab[(i + 7) % 20])))
        queries.append(q)
    queries.append(PhraseQuery("body", [vocab[0], vocab[1]]))  # exact
    queries.append(PhraseQuery("body", [vocab[1], vocab[0]], slop=2))  # sloppy
    queries.append(PointRangeQuery("n", n_docs // 4, 3 * n_docs // 4))
    rb = BooleanQuery()  # range + term
    rb.must(TermQuery(Term("body", vocab[0])))
    rb.must(PointRangeQuery("n", 0, n_docs // 2))
    queries.append(rb)
    st = lambda w: SpanTermQuery(Term("body", w))  # noqa: E731
    queries.append(SpanNearQuery([st(vocab[0]), st(vocab[2])], slop=0, in_order=True))
    n_mesh = len(queries)
    queries.append(DisjunctionMaxQuery(
        [TermQuery(Term("body", vocab[3])), TermQuery(Term("body", vocab[4]))], tie_breaker=0.5))
    queries.append(SpanNearQuery([st(vocab[0]), st(vocab[5])], slop=4, in_order=False))
    return queries, n_mesh


def _check_parity(got, want) -> None:
    """The reference dry run's check: equal hit counts and doc sets, scores
    within RTOL, order differing only within score ties."""
    for qi, (g_td, w_td) in enumerate(zip(got, want)):
        if g_td.total_hits != w_td.total_hits:
            raise AssertionError(f"q{qi}: sharded total_hits {g_td.total_hits} != "
                                 f"single-process {w_td.total_hits}")
        g = [(int(sd.doc), float(sd.score)) for sd in g_td.score_docs]
        w = [(int(sd.doc), float(sd.score)) for sd in w_td.score_docs]
        if {d for d, _ in g} != {d for d, _ in w}:
            raise AssertionError(f"q{qi}: doc sets differ: {({d for d, _ in g}) ^ ({d for d, _ in w})}")
        ws = dict(w)
        for d, s in g:
            if abs(s - ws[d]) > RTOL * max(1.0, abs(ws[d])):
                raise AssertionError(f"q{qi} doc {d}: score {s} vs {ws[d]}")
        for (gd, gs), (wd, _) in zip(g, w):
            if gd != wd and abs(gs - ws[wd]) > RTOL * max(1.0, abs(ws[wd])):
                raise AssertionError(f"q{qi}: order differs beyond ties ({gd} vs {wd})")


def _worker(store: str, index_dir: str, n: int, rank: int, device: str) -> dict:
    """One process of dryrun_multichip's world."""
    from rucene_tpu_torch import FSDirectory, IndexSearcher, open_directory_reader
    from rucene_tpu_torch.parallel import multi_host as mh
    from rucene_tpu_torch.parallel.sharded import ShardedIndex, ShardedSearcher
    from rucene_tpu_torch.util.metrics import METRICS

    cpu = device == "cpu"
    mh.initialize(f"file://{store}", world_size=n, rank=rank, backend="gloo" if cpu else "nccl")
    mesh = mh.make_pod_mesh(devices=["cpu"] if cpu else None, partition="index")
    index = ShardedIndex.from_directory(mesh, FSDirectory(index_dir))
    queries, n_mesh = _dryrun_queries(VOCAB, 64 * n)
    c0 = METRICS.snapshot()["counters"]
    results = ShardedSearcher(index).search_batch(queries, k=5)
    c1 = METRICS.snapshot()["counters"]
    fb = c1.get("route.mesh_fallback", 0) - c0.get("route.mesh_fallback", 0)
    if fb != len(queries) - n_mesh:
        raise AssertionError(f"{fb} fallback rows, expected {len(queries) - n_mesh} "
                             "(dismax + unordered span)")
    if not any(td.total_hits > 0 for td in results):
        raise AssertionError("the sharded step matched nothing")
    dev = "cpu" if cpu else f"cuda:{mh.local_devices()[0].index}"
    single = IndexSearcher(open_directory_reader(FSDirectory(index_dir)), device=dev)
    _check_parity(results, single.search_batch(queries, k=5))
    return {"rank": rank, "shape": [mesh.shape["shard"], mesh.shape["dp"]],
            "owned": sorted(index.owned), "rows": len(queries),
            "hits": [[td.total_hits, [[int(d), float(s)] for d, s in td.score_docs]]
                     for td in results]}


def dryrun_multichip(n_devices: int, device="cuda") -> list[dict]:
    """One sharded serving step over ``n_devices`` shards, one process
    each (see the module docstring); returns each rank's output. On the
    card it needs n_devices cards."""
    from rucene_tpu_torch import Document, FSDirectory, IndexWriter, IndexWriterConfig, IntPoint
    from rucene_tpu_torch import TextField

    dev = require_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} processes need {n_devices} cards, "
                           f"torch sees {torch.cuda.device_count()}")
    n_docs = 64 * n_devices
    texts = _texts(n_docs)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="rtpu_dryrun_") as tmp:
        index_dir = os.path.join(tmp, "index")
        w = IndexWriter(FSDirectory(index_dir),
                        IndexWriterConfig(max_buffered_docs=64, merge_on_commit=False))
        for i, t in enumerate(texts):  # one 64-doc segment a shard
            d = Document()
            d.add(TextField("body", t))
            d.add(IntPoint("n", i))
            w.add_document(d)
        w.commit()
        w.close()
        store = os.path.join(tmp, "store")
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(filter(None, [pkg_root, os.environ.get("PYTHONPATH")]))}
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "rucene_tpu_torch.drivers.graft_entry", "--worker",
                 store, index_dir, str(n_devices), str(r), str(dev.type)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            )
            for r in range(n_devices)
        ]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
                if p.returncode != 0:
                    raise RuntimeError(f"dry-run worker failed (rc {p.returncode}):\n{err[-3000:]}")
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    if any(o["hits"] != outs[0]["hits"] for o in outs):
        raise AssertionError("the processes' answers differ")
    print(f"dryrun_multichip OK: {n_devices} processes, mesh={outs[0]['shape']} "
          f"(shard x dp) on {dev.type}, {outs[0]['rows']} queries, "
          f"hits={[h[0] for h in outs[0]['hits']]}, parity vs a one-process searcher verified",
          flush=True)
    return outs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m rucene_tpu_torch.drivers.graft_entry")
    p.add_argument("--device", default="cuda")
    p.add_argument("--shards", type=int, default=0,
                   help="dryrun_multichip's processes (default: the cards, or none on the CPU)")
    args = p.parse_args(argv)
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry OK:", [type(o).__name__ for o in out], [tuple(o.shape) for o in out])
    n = args.shards
    if not n and torch.device(args.device).type == "cuda":
        n = torch.cuda.device_count()
    if n > 1:
        dryrun_multichip(n, args.device)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        store, index_dir, n, rank, device = sys.argv[2:7]
        print(json.dumps(_worker(store, index_dir, int(n), int(rank), device)), flush=True)
    else:
        main()

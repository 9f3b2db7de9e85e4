"""Stage-level times of the flat executor on one 256-row batch of the
bench's term and boolean rows (counterpart of tools/profile_candidate.py).

    python -m rucene_tpu_torch.drivers.profile_candidate [--docs N] [--reader packed]
        [--stages decode,scatter,topk,dense,candidate] [--device cpu]

The corpus and its cache are drivers/workload.py's and drivers/bench.py's
(``--docs`` defaults to the largest cached corpus of at most 1M docs,
else 50,000); the rows are the mix without phrases (workload.build_queries,
seed 13), flattened into one work list as the searcher's flat route
builds it (deduplicated blocks). Each stage prints one line as it lands,
in the reference's order:
  - ``decode+score``: decode_score_lanes, the scoring decode kernel (K2)
    on a packed reader, row gathers of the resident planes on a decoded
    one;
  - ``decode+scatter_score`` / ``decode+scatter_counts``: the decode, then
    the lanes' scores / clause encodings into dense [B, md] planes (the
    reference's ``.at[].add``): the scores in item order, grouped by slot
    as the executor's candidate branch groups them
    (ops/ordered_sum.grouped_sums_ordered, the ordered-sum kernel on the
    card), the counts through an ``index_add_``;
  - ``topk_dense[B,md]``: topk_score_doc at ``--k`` (100) over the scattered
    scores (-inf where 0), the block-max chunk pass of ops/topk.exact_top_k
    when the row is wide enough; its answer is held equal to
    stable_top_k's. Beside it ``torch.topk[B,md]``, one torch.topk over the
    raw f32 rows (the reference's ``lax.top_k`` line), which breaks ties
    in no set order;
  - ``full_dense`` / ``full_candidate``: execute_flat_impl on each branch
    (the dense one through the combine kernel, K3).
Times are the least of 3 runs after a warm one: CUDA events on the card,
the host clock on the CPU. Runs on the card (``cuda``) unless given
``--device cpu``; without a card it fails.
"""

from __future__ import annotations

import argparse
import time

import torch

STAGES = ("decode", "scatter", "topk", "dense", "candidate")


def timeit(fn, dev: torch.device, reps: int = 3, warmup: int = 1) -> float:
    """Least seconds of fn() over ``reps`` runs after ``warmup``."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return min(ts)


def batch_work(searcher, queries):
    """(FlatQueryBatch, work arrays, b, leaf) of ``queries`` on the
    searcher's one leaf: the flat route's tables at t=2."""
    from rucene_tpu_torch.search.flat_tables import (
        build_clause_tables,
        build_flat_work,
        build_leaf_cache,
        build_leaf_tables,
        make_flat_batch,
    )

    rqs = [q.rewrite() for q in queries]
    doc_freqs, stats = searcher._gather_stats(rqs)
    b = len(rqs)
    weight, occur, n_required, min_should, _, _ = build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, 2
    )
    leaf = searcher.reader.leaves[0]
    cache = build_leaf_cache(leaf, searcher.similarity, stats)
    bs, bc, fid = build_leaf_tables(leaf, rqs, b, 2)
    work = build_flat_work(bs, bc, weight, fid, occur)[:6]
    q = make_flat_batch(work, n_required, min_should, cache, leaf.device, dedupe=True)
    return q, work, b, leaf


def profile(searcher, queries, stages=STAGES, k: int = 100, out=print) -> dict:
    """{stage: seconds} of the executor's stages on ``queries`` (one
    batch) at ``k``, each printed through ``out`` as it lands; ``topk_equal`` says
    whether topk_score_doc's answer equalled stable_top_k's and
    ``chunk_pass`` whether exact_top_k took its chunk pass there."""
    from rucene_tpu_torch.ops import topk
    from rucene_tpu_torch.ops.ordered_sum import grouped_sums_ordered
    from rucene_tpu_torch.search.executor import decode_score_lanes, execute_flat_impl
    from rucene_tpu_torch.search.flat_tables import build_combine_batch

    q, work, b, leaf = batch_work(searcher, queries)
    dev = leaf.device
    md = dev.max_doc_padded
    n_items = int(work[5].sum())
    gdev = searcher.device
    out(f"# md={md} items={n_items} L={n_items * 128} b*md={b * md} 12L={12 * n_items * 128} "
        f"branch={'dense' if b * md <= 12 * n_items * 128 else 'candidate'} on {gdev}")
    results: dict = {}

    def put(key, secs):
        results[key] = secs
        out(f"{key:28s} {secs * 1e3:9.3f} ms")

    if "decode" in stages:
        put("decode+score", timeit(lambda: decode_score_lanes(dev, q), gdev))

    def scatter(values_of):
        target, sc, valid = decode_score_lanes(dev, q)
        rows = q.wi_row.long()[:, None]
        trash = b * md
        lanes = torch.arange(target.numel(), device=target.device).view(target.shape)
        idx = torch.where(target < md, rows * md + target, trash + lanes).reshape(-1)
        vals = values_of(sc, valid).reshape(-1)
        acc = torch.zeros(trash + 1, dtype=vals.dtype, device=vals.device)
        if vals.dtype == torch.float32:  # in item order, as the executor sums
            slot, _perm, _gid, sums = grouped_sums_ordered(idx, vals, trash)
            acc[slot.clamp(max=trash)] = sums
        else:
            acc.index_add_(0, idx.clamp(max=trash), vals)
        return acc[: b * md].view(b, md)

    def scores_of(sc, _valid):
        return sc

    def counts_of(_sc, valid):
        return torch.where(valid, q.wi_enc[:, None], 0)

    if "scatter" in stages:
        put("decode+scatter_score", timeit(lambda: scatter(scores_of), gdev))
        put("decode+scatter_counts", timeit(lambda: scatter(counts_of), gdev))
        if "topk" in stages:
            acc = scatter(scores_of)
            rows = torch.where(acc > 0, acc, -torch.inf)
            got = topk.topk_score_doc(rows, k)
            want_v, want_i = topk.stable_top_k(rows, k)
            want_d = torch.where(want_v > -torch.inf, want_i, topk.DOC_PAD)
            results["topk_equal"] = bool(torch.equal(got[0], want_v) and torch.equal(got[1], want_d))
            results["chunk_pass"] = topk.chunk_pass_engages(rows.shape[1], k)
            put("topk_dense[B,md]", timeit(lambda: topk.topk_score_doc(rows, k), gdev))
            put("torch.topk[B,md]", timeit(lambda: torch.topk(rows, k, dim=1), gdev))
            out(f"# topk_score_doc equals stable_top_k: {results['topk_equal']}; "
                f"chunk pass engaged: {results['chunk_pass']}")
    if "dense" in stages:
        combine = build_combine_batch(work, b, leaf.packed.blk_first_doc, leaf.packed.blk_last_doc,
                                      md, gdev)
        put("full_dense", timeit(lambda: execute_flat_impl(dev, q, k, combine=combine), gdev))
    if "candidate" in stages:
        put("full_candidate", timeit(lambda: execute_flat_impl(dev, q, k), gdev))
    out("# done")
    return results


def main(argv=None) -> dict:
    from rucene_tpu_torch.drivers import bench, device_name, require_device
    from rucene_tpu_torch.drivers import workload as wl

    p = argparse.ArgumentParser(prog="python -m rucene_tpu_torch.drivers.profile_candidate")
    p.add_argument("--docs", type=int, default=0,
                   help="corpus size (default: largest cached <= 1M, else 50000)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--cache", default=bench.DEFAULT_CACHE,
                   help="directory of packed bench indexes ('' turns it off)")
    p.add_argument("--reader", choices=("decoded", "packed"), default="decoded")
    p.add_argument("--stages", default=",".join(STAGES),
                   help="comma-separated subset of " + ",".join(STAGES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device)
    n_docs = args.docs or wl.default_docs(args.cache, "zipf")
    packed, _ = bench.bench_index(n_docs, 0, "zipf", args.cache)
    vocab, probs = wl.zipf_vocab()
    queries = wl.build_queries(args.batch, vocab, probs)
    searcher = bench.open_searcher(packed, dev, args.reader)
    print(f"# n_docs={n_docs}, {args.reader} reader on {device_name(dev)}", flush=True)
    return profile(searcher, queries, args.stages.split(","), args.k,
                   out=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()

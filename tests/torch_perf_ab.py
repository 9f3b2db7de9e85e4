"""Same-card A/B measurement of the port's kernels and serving, one tree at
a time (not a pytest module).

    python3 tests/torch_perf_ab.py --root DIR --label NAME [--phrases]

imports ``rucene_tpu_torch`` from DIR (a checkout of the port) and the
corpus, query, replay and timing helpers from this checkout's
``chip_smoke.py``, so two trees are measured by one harness. On the 1M-doc bench corpus (``BENCH_DOCS`` overrides) it measures:
  - QPS of the bench mix from a decoded and from a packed reader (the
    smoke's ``serve``: pipelined, three batches deep);
  - kernel time per pass, the device busy share (the union of kernel
    intervals over the wall time) and the ten kernels that took the most
    device time under ``torch.profiler``, over three pipelined passes of
    each reader, and each reader's peak device memory;
  - K1 over every block and K2 on the first batch's single-term rows,
    timed like the smoke (cold L2, host launch time excluded), and the
    executor's dense combine step (``_combine_dense``: K3 and what feeds
    it) on the head-band pair batch served by the packed reader, timed
    the same way;
  - the rows each route took over the serving passes (``route.*``
    counters) and the decoded segment's tf-plane bytes (0 for a tree
    without them).
Without ``--phrases`` the mix has no phrase rows (AND rows take their
place), so a tree that serves no phrases is measured on the same rows as
one that does. ``--phrases`` serves the bench's whole mix (bigrams from the
first 5,000 docs) and prewarms each reader's phrase planes first, after
dropping the other reader's; the tree must serve phrases. It prints one
JSON line. Run it for the parent and the change in turns (parent, change,
change, parent) inside one chip call to compare them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time


def _load_smoke():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--phrases", action="store_true",
                    help="serve the whole mix, phrase rows included (the tree must serve them)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    smoke = _load_smoke()
    import torch

    if not torch.cuda.is_available():
        print("torch_perf_ab: no CUDA device", file=sys.stderr)
        return 1
    from rucene_tpu_torch import IndexSearcher
    from rucene_tpu_torch.codec.device import build_device_segment
    from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
    from rucene_tpu_torch.ops import cuda_build, cuda_decode
    from rucene_tpu_torch.search import executor
    from rucene_tpu_torch.util.metrics import METRICS

    import rucene_tpu_torch

    dev = torch.device("cuda", 0)
    out = {"label": args.label, "package": os.path.dirname(rucene_tpu_torch.__file__),
           "card": smoke.card_line(), "phrases": args.phrases}
    cuda_build.kernels()
    n_docs = int(os.environ.get("BENCH_DOCS", 1_000_000))
    texts, vocab, probs = smoke.build_corpus(n_docs)
    queries = smoke.build_queries(
        smoke.N_QUERIES, vocab, probs, phrase_texts=texts[:5000] if args.phrases else None
    )
    packed = smoke.pack_corpus(texts)
    del texts

    def reader():
        return IndexSearcher(IndexReader([SegmentSnapshot("bench", packed)]), device=dev)

    for name, decoded in (("decoded", "1"), ("packed", "0")):
        os.environ["RUCENE_DECODED"] = decoded
        torch.cuda.reset_peak_memory_stats()
        s = reader()
        seg = s.reader.leaves[0].device  # build the segment's device form now
        tf_planes = getattr(seg, "tf_planes", None)
        out[f"{name}_tf_plane_mib"] = 0.0 if tf_planes is None else tf_planes.numel() / 2**20
        if args.phrases:
            from rucene_tpu_torch.search import phrase_path

            phrase_path._PLANE_CACHE.clear()  # the other reader's planes
            t = time.perf_counter()
            out[f"{name}_prewarm_planes"] = s.prewarm_phrase_planes()
            torch.cuda.synchronize()
            out[f"{name}_prewarm_s"] = time.perf_counter() - t
        for i in range(0, len(queries), smoke.BATCH):  # warm pass
            s.search_batch(queries[i:i + smoke.BATCH], k=smoke.K)
        METRICS.reset()
        qps, _ = smoke.serve(s, queries)
        routes = {k: v for k, v in METRICS.snapshot()["counters"].items() if k.startswith("route.")}
        ms, busy, top = smoke.profile_passes(s, queries)
        out[name] = {"qps": qps, "kernel_ms_per_pass": ms, "busy_share": busy,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "routes": routes, "top_kernels_ms_per_pass": top}
        if name == "decoded":
            searcher = s
        else:
            packed_searcher = s
        del s
    os.environ.pop("RUCENE_DECODED")

    # K1 over every block
    seg = build_device_segment(packed, dev)
    tables = (seg.data, seg.blk_off, seg.blk_doc_bits, seg.blk_freq_bits, seg.blk_base, seg.blk_count)
    fdt = searcher.reader.leaves[0].device.freqs_dec.dtype
    out["k1_ms"] = smoke.cuda_ms(cuda_decode.decode_blocks, (*tables, fdt), reps=8, copies=2)
    del seg, tables

    # K2 on the first packed batch's single-term rows
    k2_args = smoke.single_k2_call(packed_searcher, queries[:smoke.BATCH])
    out["k2_blocks"] = int(k2_args[1].shape[0])
    out["k2_ms"] = smoke.cuda_ms(cuda_decode.decode_score_blocks, k2_args)

    # K3 on the head-band pair batch, as the packed reader's dense combine
    # step runs it (accumulators, the kernel and whatever the tree feeds it)
    dense_q = smoke.head_pair_queries(vocab)
    q, cb, target, sc, valid = smoke.head_band_combine_call(packed_searcher, dense_q)
    md = packed_searcher.reader.leaves[0].device.max_doc_padded
    out["k3_step_ms"] = smoke.cuda_ms(
        executor._combine_dense, (q, target, sc, valid, len(dense_q), md, (cb,))
    )
    out["k3_entries"] = int(cb.e_item.numel())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Pre-build the packed bench index cache (counterpart of
tools/build_bench_cache.py).

    python -m rucene_tpu_torch.drivers.build_bench_cache [n_docs] [zipf|pytext] [--cache DIR]

drivers.bench defaults to the largest cached corpus of at most 1M docs, and
its 8.8M-doc runs need a cache: packing 8.8M docs in the serving process
takes minutes. This builds the corpus (drivers/workload.py), packs it and
publishes ``bench-<corpus>-<docs>.seg`` atomically (workload.cache_segment).
An existing file is trusted only if it reads back (its footer and
checksums); a torn or stale one is rebuilt. It runs on the host alone and
touches no device. Both packages write byte-identical segment files, so
the cache serves tools/build_bench_cache.py's readers too, and theirs this
package's.
"""

from __future__ import annotations

import argparse
import os
import time

from rucene_tpu_torch.drivers import workload as wl
from rucene_tpu_torch.drivers.bench import DEFAULT_CACHE


def build(n_docs: int, corpus_kind: str, cache_dir: str) -> str:
    """Build (or validate) the cached segment; returns its path."""
    from rucene_tpu_torch.codec import files as segfiles
    from rucene_tpu_torch.store.directory import FSDirectory

    seg_name = wl.segment_name(corpus_kind, n_docs)
    path = os.path.join(cache_dir, segfiles.segment_file(seg_name))
    os.makedirs(cache_dir, exist_ok=True)
    cdir = FSDirectory(cache_dir)
    if cdir.file_exists(segfiles.segment_file(seg_name)):
        try:  # trust the cache only if it parses
            segfiles.read_segment(cdir, seg_name)
            print(f"already cached (validated): {seg_name}", flush=True)
            return path
        except Exception as e:  # noqa: BLE001 - any failure to read back means rebuild
            print(f"existing {seg_name} invalid ({e}); rebuilding", flush=True)
            cdir.delete_file(segfiles.segment_file(seg_name))
    t0 = time.time()
    if corpus_kind == "pytext":
        texts, _, _ = wl.build_corpus_pytext(n_docs)
    else:
        texts, _, _ = wl.build_corpus(n_docs)
    print(f"corpus built ({time.time() - t0:.0f}s)", flush=True)
    packed = wl.pack_corpus(texts, log=lambda m: print(f"{m} ({time.time() - t0:.0f}s)", flush=True))
    del texts
    wl.cache_segment(cache_dir, seg_name, packed)
    print(f"cached {seg_name} to {cache_dir} ({packed.index_bytes() / 1e6:.1f} MB, "
          f"{time.time() - t0:.0f}s total)", flush=True)
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(prog="python -m rucene_tpu_torch.drivers.build_bench_cache")
    p.add_argument("n_docs", type=int, nargs="?", default=1_000_000)
    p.add_argument("corpus_kind", nargs="?", choices=("zipf", "pytext"), default="zipf")
    p.add_argument("--cache", default=DEFAULT_CACHE)
    args = p.parse_args(argv)
    return build(args.n_docs, args.corpus_kind, args.cache)


if __name__ == "__main__":
    main()

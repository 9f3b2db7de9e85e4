"""Committed indexes, built once per checkout through the program's public
writer and kept in ``portbench/.cache/`` (gitignored).

An index is built in a directory of its own under ``.cache`` and renamed
into place, so a run that is cut leaves no index a later run would take.
Its name is its content key: the configuration's name and parameters and a
digest of the program's sources that decide the files (codec, writer,
analysis, documents, store, util), so a change to any of them builds anew.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

SOURCE_DIRS = ("analysis", "codec", "doc", "index", "store", "util")


def source_digest() -> str:
    import rucene_tpu_torch

    pkg = os.path.dirname(os.path.abspath(rucene_tpu_torch.__file__))
    h = hashlib.sha256()
    for d in SOURCE_DIRS:
        for fn in sorted(os.listdir(os.path.join(pkg, d))):
            if fn.endswith(".py"):
                h.update(fn.encode())
                with open(os.path.join(pkg, d, fn), "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


def writer_config(params: dict):
    """The program's IndexWriterConfig for a configuration's ``writer``
    block: ``max_buffered_docs``, ``segs_per_tier`` and ``merge_on_commit``."""
    from rucene_tpu_torch import IndexWriterConfig, TieredMergePolicy

    kw = {"max_buffered_docs": params["max_buffered_docs"],
          "merge_on_commit": params.get("merge_on_commit", True)}
    if "segs_per_tier" in params:
        kw["merge_policy"] = TieredMergePolicy(segs_per_tier=params["segs_per_tier"])
    return IndexWriterConfig(**kw)


def documents(texts: list, field: str) -> list:
    from rucene_tpu_torch import Document, TextField

    out = []
    for t in texts:
        d = Document()
        d.add(TextField(field, t))
        out.append(d)
    return out


def committed(config: dict, corpus, n_docs: int, log, cache_dir: str) -> str:
    """The directory of a commit of the corpus's first ``n_docs`` docs,
    added as one block through ``IndexWriter.add_documents`` (one segment:
    the block lands whole, and ``max_buffered_docs`` decides no flush
    inside it), built now if the cache lacks it."""
    from portbench import corpus as corpus_mod
    from rucene_tpu_torch import FSDirectory, IndexWriter

    key = json.dumps([config["name"], config["docs"], config["corpus"], config["field"], n_docs,
                      config["writer"], source_digest()], sort_keys=True)
    path = os.path.join(cache_dir, f"{config['name']}-{n_docs}-"
                        f"{hashlib.sha256(key.encode()).hexdigest()[:16]}")
    if os.path.isdir(path):
        return path
    t0 = time.perf_counter()
    os.makedirs(cache_dir, exist_ok=True)
    tmp = os.path.join(cache_dir, f".build-{os.path.basename(path)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        w = IndexWriter(FSDirectory(tmp), writer_config(config["writer"]))
        w.add_documents(documents(corpus_mod.texts(corpus, 0, n_docs), config["field"]))
        w.commit()
        w.close()
        lock = os.path.join(tmp, "write.lock")
        if os.path.exists(lock):
            os.remove(lock)
        try:
            os.rename(tmp, path)
        except OSError:  # another run published it first
            if not os.path.isdir(path):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"built the committed index {os.path.basename(path)} in {time.perf_counter() - t0:.1f} s")
    return path

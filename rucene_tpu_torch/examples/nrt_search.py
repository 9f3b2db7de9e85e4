"""NRT search loop (counterpart of examples/nrt_search.py): concurrent
indexing and searching with SearcherManager, one executor call over all
segments (the combined view), a snippet from postings offsets, and a
commit / reopen cycle: the shape of a production search service.

Run: python -m rucene_tpu_torch.examples.nrt_search [--device cpu]

The ``[nrt]`` progress lines depend on how the ingest thread and the
refreshes interleave, as the reference's do; the last says 3 docs.
"""

import argparse
import tempfile
import threading
import time

import numpy as np

import rucene_tpu_torch as rt
from rucene_tpu_torch.drivers import require_device
from rucene_tpu_torch.index.reader import open_directory_reader
from rucene_tpu_torch.index.writer import IndexWriter, IndexWriterConfig
from rucene_tpu_torch.search.search_manager import SearcherManager
from rucene_tpu_torch.store.directory import FSDirectory

DOCS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast auburn fox outpaces the sleeping hound",
    "search engines rank documents by term statistics",
    "the dog sleeps while the fox hunts at night",
    "term frequency and document length drive the score",
]


def main(device="cuda") -> None:
    dev = require_device(device)
    path = tempfile.mkdtemp(prefix="rtpu_nrt_")
    directory = FSDirectory(path)
    writer = IndexWriter(directory, IndexWriterConfig(max_buffered_docs=2))

    # NRT searchers over many small segments: combine_segments searches
    # them all with one executor call
    manager = SearcherManager(
        writer,
        searcher_factory=lambda r: rt.IndexSearcher(r, device=dev, combine_segments=True),
    )

    stop = threading.Event()

    def ingest():
        for i, text in enumerate(DOCS):
            doc = rt.Document()
            doc.add(rt.StringField("id", str(i), stored=True))
            doc.add(rt.TextField("body", text, stored=True, offsets=True))
            writer.add_document(doc)
            time.sleep(0.05)
        stop.set()

    t = threading.Thread(target=ingest)
    t.start()

    seen = 0
    while not stop.is_set() or seen < len(DOCS):
        manager.maybe_refresh()
        searcher = manager.acquire()
        hits = searcher.search(rt.TermQuery(rt.Term("body", "fox")), k=10)
        if hits.total_hits != seen:
            seen = hits.total_hits
            print(f"[nrt] fox now matches {seen} docs "
                  f"({len(searcher.reader.leaves)} segments)")
        time.sleep(0.02)
        if stop.is_set() and seen == 3:
            break
    t.join()

    # snippet from postings offsets (no term vectors needed)
    searcher = manager.acquire()
    top = searcher.search(rt.TermQuery(rt.Term("body", "fox")), k=1).score_docs[0]
    reader = searcher.reader
    leaf = next(lf for lf in reversed(reader.leaves) if top.doc >= lf.doc_base)
    local = top.doc - leaf.doc_base
    docs, freqs, _, offs, _ = leaf.read_postings("body", "fox", with_offsets=True)
    k = int(np.searchsorted(docs, local))
    occ = int(freqs[:k].sum())
    start, end = int(offs[0][occ]), int(offs[1][occ])
    body = leaf.document(local)["body"]
    print(f"[hl] ...{body[max(0, start - 15):start]}[{body[start:end]}]{body[end:end + 15]}...")

    # durability: commit, drop everything, reopen from disk
    writer.commit()
    writer.close()
    r2 = open_directory_reader(directory)
    s2 = rt.IndexSearcher(r2, device=dev, combine_segments=True)
    final = s2.search(rt.TermQuery(rt.Term("body", "fox")), k=10)
    print(f"[reopen] {r2.num_docs} docs on disk, fox matches {final.total_hits}")
    if final.total_hits != 3:
        raise AssertionError(f"fox matches {final.total_hits} docs after the reopen, not 3")


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m rucene_tpu_torch.examples.nrt_search")
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)

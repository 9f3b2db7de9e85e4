"""DocumentsWriter: concurrent ingestion with per-thread segment buffers.

reference: rucene src/core/index/writer/doc_writer.rs:102 (DocumentsWriter)
+ doc_writer_per_thread.rs:658 (DocumentsWriterPerThreadPool): each indexing
thread owns a private in-RAM segment so ingestion never contends.

Here each worker thread owns a SegmentBuffer (the DWPT) and flushes it as
an independent segment. The C++ inversion path releases the GIL inside
tokenize/hash calls, so threads genuinely overlap on the hot loop. Doc ids
across threads are assigned per segment (like Lucene, global ordering
across concurrently-added docs is unspecified).
"""

from __future__ import annotations

import queue
import threading

from rucene_tpu_torch.doc.document import Document
from rucene_tpu_torch.index.writer import IndexWriter


def add_documents_parallel(
    writer: IndexWriter,
    docs: list[Document],
    num_threads: int = 4,
    docs_per_segment: int | None = None,
) -> None:
    """Index `docs` across worker threads, each building private segments
    that are handed to the writer at flush boundaries."""
    from rucene_tpu_torch.index.memory import SegmentBuffer

    docs_per_segment = docs_per_segment or writer.config.max_buffered_docs
    work: queue.Queue = queue.Queue()
    chunk = max(64, len(docs) // (num_threads * 8) or 1)
    for i in range(0, len(docs), chunk):
        work.put(docs[i : i + chunk])
    finished: list[BaseException | None] = [None] * num_threads

    def worker(tid: int) -> None:
        try:
            buf = SegmentBuffer(writer.config.analyzer)
            while True:
                try:
                    batch = work.get_nowait()
                except queue.Empty:
                    break
                buf.add_documents_bulk(batch)
                if buf.num_docs >= docs_per_segment:
                    writer.add_flushed_buffer(buf)
                    buf = SegmentBuffer(writer.config.analyzer)
            if buf.num_docs:
                writer.add_flushed_buffer(buf)
        except BaseException as e:  # surfaced after join
            finished[tid] = e

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(num_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in finished:
        if e is not None:
            raise e

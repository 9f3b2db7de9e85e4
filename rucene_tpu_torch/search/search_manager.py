"""SearcherManager: NRT searcher turnover.

reference: rucene src/core/search/search_manager.rs:44 (SearcherManager /
ReferenceManager). The reference's acquire/release ref-count protocol exists
because readers own file handles; here snapshots are immutable
host+device arrays owned by Python's GC, so acquire/release degenerate to
handing out the current searcher — kept for API parity. Refresh is cheap:
unchanged segments share device tensors between readers.

Port changes (held against rucene_tpu/search/search_manager.py by
tests/test_torch_host.py):
- SearcherManager.maybe_refresh: a reader's leaves are its own views of the
  writer's snapshots (index/reader.SegmentSnapshot.view), so "nothing
  changed" compares the snapshots the views were made from (``source``),
  not the views; the whole of it is the ``nrt.refresh`` span (the
  writer's ``writer.get_reader`` and whatever the searcher factory builds,
  device forms among it, lie within). Only leaves the old reader lacked get
  a device form: the others are views of the snapshots it served, whose
  forms, tf planes and phrase planes every view shares.
"""

from __future__ import annotations

import threading
from typing import Callable

from rucene_tpu_torch.index.reader import IndexReader
from rucene_tpu_torch.index.writer import IndexWriter
from rucene_tpu_torch.search.searcher import IndexSearcher


class SearcherManager:
    def __init__(
        self,
        writer: IndexWriter,
        searcher_factory: Callable[[IndexReader], IndexSearcher] | None = None,
    ):
        self._writer = writer
        self._factory = searcher_factory or IndexSearcher
        self._lock = threading.Lock()
        self._listeners: list[Callable[[], None]] = []
        self._current = self._factory(writer.get_reader())

    def acquire(self) -> IndexSearcher:
        with self._lock:
            return self._current

    def release(self, searcher: IndexSearcher) -> None:
        pass  # GC-managed; parity no-op

    def add_refresh_listener(self, fn: Callable[[], None]) -> None:
        self._listeners.append(fn)

    def maybe_refresh(self) -> bool:
        """Swap in a new point-in-time searcher if the index changed."""
        from rucene_tpu_torch.util.metrics import trace

        with trace("nrt.refresh"), self._lock:
            new_reader = self._writer.get_reader()
            old = self._current.reader
            same = len(new_reader.leaves) == len(old.leaves) and all(
                a.source is b.source for a, b in zip(new_reader.leaves, old.leaves)
            )
            if same:
                return False
            self._current = self._factory(new_reader)
        for fn in self._listeners:
            fn()
        return True

"""IndexWriter: ingestion, flush, two-phase commit, NRT readers, deletes,
merges.

reference: rucene src/core/index/writer/index_writer.rs:191 (API surface at
:376-651 — add_document / update_document / delete_documents_by_terms /
commit / get_reader / force_merge), doc_writer.rs (flush), bufferd_updates.rs
(delete application), index_file_deleter.rs (ref-counted GC),
delete_policy.rs (KeepOnlyLastCommit).

Differences by design:
- the default path ingests into one SegmentBuffer; concurrent ingestion
  uses per-thread buffers handed over via add_flushed_buffer
  (index/doc_writer.py — the DWPT-pool analog; the C++ inverter releases
  the GIL so threads overlap on the hot loop);
- flush packs the buffer into device tensors AND writes the .seg file
  immediately (no fsync until commit), like Lucene;
- deletes buffer as (term, watermark) pairs and apply functionally at
  flush/commit/get_reader, producing new live masks (no in-place mutation
  of any open reader's state).

Port changes (held against rucene_tpu/index/writer.py by
tests/test_torch_host.py):
- IndexWriter._delete_in_segment: delete-by-query gathers its statistics
  through a searcher on the CPU (the reference's searcher defaults to its
  accelerator; the port's default, ``cuda``, fails on a CPU-only host, and
  no device work is needed: the statistics and the host engine's match
  read host arrays only). The searcher's reader serves its own view of the
  pooled snapshot, so no other reader's device forms are touched.
- IndexWriterConfig: ``merge_on_refresh`` (off by default): get_reader
  calls maybe_merge after its flush, as Lucene's IndexWriter.getReader
  does; with a ConcurrentMergeScheduler the merge runs on its thread and
  the merged segment joins at the next refresh.
- IndexWriter.add_documents: the inversion into the buffer is the
  ``writer.add_documents`` span.
- IndexWriter._flush_buffer: ``writer.flush`` is a ``trace`` span (a
  ``METRICS`` timer, as before, and a profiler event), over the same
  interval.
- IndexWriter.get_reader: the ``writer.get_reader`` span, and the merge on
  refresh.
- IndexWriter.maybe_merge: with ``merge_on_refresh`` the policy sees the
  flushed, uncommitted segments too; an order-keeping policy
  (``adjacent_only``, index/log_merge_policy.py) sees every segment in
  index order, those already merging among them.
- IndexWriter._register_merge: inputs are looked up among the flushed
  segments too.
- IndexWriter._merge_job: the ``writer.merge`` span (the merge and its
  write) and the ``writer.merged_docs`` counter; the segment merge is the
  scheduler's (``segment_merge``: on the merge thread, or in a worker
  process with ``ConcurrentMergeScheduler(processes=True)``).
- IndexWriter._commit_merge: inputs may be flushed, uncommitted segments;
  the merged segment takes the first input's place, among the flushed
  segments where any input was one (IndexWriter._drop_merged).
- IndexWriter._drop_merged: one segment list with a merge's inputs
  replaced by its output.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field

import numpy as np

from rucene_tpu_torch.analysis import Analyzer, LowercaseWhitespaceAnalyzer
from rucene_tpu_torch.codec import files as segfiles
from rucene_tpu_torch.codec.files import SegmentCommitInfo, SegmentInfos
from rucene_tpu_torch.codec.postings import pack_segment
from rucene_tpu_torch.doc.document import Document
from rucene_tpu_torch.doc.term import Term
from rucene_tpu_torch.index.memory import SegmentBuffer
from rucene_tpu_torch.index.merge import TieredMergePolicy, merge_segments
from rucene_tpu_torch.index.merge_scheduler import SerialMergeScheduler
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.store.directory import Directory
from rucene_tpu_torch.util.metrics import METRICS


def _seg_name(n: int) -> str:
    # base-36 like Lucene's _0, _1, ... _a, ...
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    if n == 0:
        return "_0"
    out = ""
    while n:
        out = digits[n % 36] + out
        n //= 36
    return "_" + out


@dataclass
class IndexWriterConfig:
    analyzer: Analyzer = dc_field(default_factory=LowercaseWhitespaceAnalyzer)
    max_buffered_docs: int = 4096  # FlushByCountsPolicy analog
    commit_on_close: bool = True
    merge_policy: TieredMergePolicy = dc_field(default_factory=TieredMergePolicy)
    merge_scheduler: object = dc_field(default_factory=SerialMergeScheduler)
    merge_on_commit: bool = True
    merge_on_refresh: bool = False  # get_reader calls maybe_merge after its flush
    index_sort: object | None = None  # search.sort_field.Sort; applied at flush


@dataclass
class _PendingDelete:
    term: Term | None  # exactly one of term/query is set
    buffer_watermark: int  # buffered docs with id < watermark are affected
    applies_to_segments: list[str]  # segment names existing when queued
    query: object | None = None  # delete-by-query (index_writer.rs
    # delete_documents_by_queries): matches evaluated per segment at apply


@dataclass
class _PendingDVUpdate:
    term: Term
    field: str
    value: int | bytes  # int -> numeric column, bytes -> binary column
    buffer_watermark: int
    applies_to_segments: list[str]
    binary: bool = False


@dataclass
class _MergeRegistration:
    """A merge registered under the writer lock: inputs are point-in-time
    snapshots, the output name is reserved, and the input segments are
    marked merging so no overlapping merge is scheduled (reference
    index_writer.rs merge_init :2791 / register_merge)."""

    names: list[str]
    infos: list[SegmentCommitInfo]
    snaps: list[SegmentSnapshot]
    new_name: str


class IndexWriter:
    def __init__(self, directory: Directory, config: IndexWriterConfig | None = None):
        self.directory = directory
        self.config = config or IndexWriterConfig()
        # exclusive writer lock: two writers on one directory corrupt it
        self._write_lock = (
            directory.obtain_lock() if hasattr(directory, "obtain_lock") else None
        )
        self._lock = threading.RLock()
        self._infos: SegmentInfos = segfiles.read_segments_file(directory)
        # reader pool: segment name -> current snapshot (with live deletes)
        self._pool: dict[str, SegmentSnapshot] = {}
        self._live_dirty: set[str] = set()
        # flushed but not yet committed
        self._uncommitted: list[SegmentCommitInfo] = []
        self._change_gen = 0  # bumps on every content mutation (nrt_is_current)
        self._buffer = SegmentBuffer(self.config.analyzer)
        self._pending_deletes: list[_PendingDelete] = []
        self._pending_dv_updates: list[_PendingDVUpdate] = []
        self._dv_dirty: set[str] = set()
        self._closed = False
        self._tragedy: BaseException | None = None
        # in-flight merge bookkeeping (all guarded by self._lock)
        self._merging: set[str] = set()  # input segment names of running merges
        self._merge_protected: set[str] = set()  # output files gc must not touch
        self._segments_changed = False  # a merge committed since last commit()
        self.merge_exceptions: list[BaseException] = []  # surfaced, never swallowed

    # ---------- helpers ----------
    def _ensure_open(self) -> None:
        if self._closed:
            raise RuntimeError("IndexWriter is closed")
        if self._tragedy is not None:
            raise RuntimeError(f"IndexWriter hit an unrecoverable error: {self._tragedy!r}")

    def _all_infos(self) -> list[SegmentCommitInfo]:
        return list(self._infos.segments) + list(self._uncommitted)

    def _snapshot(self, info: SegmentCommitInfo) -> SegmentSnapshot:
        snap = self._pool.get(info.name)
        if snap is None:
            packed = segfiles.read_segment(self.directory, info.name)
            live = None
            if info.del_gen >= 0:
                live = segfiles.read_live(self.directory, info.name, info.del_gen)
            snap = SegmentSnapshot(info.name, packed, live=live)
            if info.dv_gen >= 0:
                num_u, bin_u = segfiles.read_dv_updates(
                    self.directory, info.name, info.dv_gen
                )
                for f, m in num_u.items():
                    snap = snap.with_dv_updates(f, m)
                for f, m in bin_u.items():
                    snap = snap.with_binary_dv_updates(f, m)
            self._pool[info.name] = snap
        return snap

    # ---------- ingestion ----------
    def add_document(self, doc: Document) -> int:
        with self._lock:
            self._ensure_open()
            self._change_gen += 1
            self._buffer.add_document(doc)
            n = self._buffer.num_docs
            if n >= self.config.max_buffered_docs:
                self._flush_buffer()
            return n

    def add_documents(self, docs: list[Document]) -> None:
        """Atomic BLOCK add: the docs land contiguously in one segment
        with consecutive ids (reference index_writer.rs:436 — block-join
        consumers rely on contiguity), unlike a loop of add_document which
        may flush mid-list."""
        from rucene_tpu_torch.util.metrics import trace

        with self._lock:
            self._ensure_open()
            self._change_gen += 1
            with trace("writer.add_documents"):
                self._buffer.add_documents_bulk(list(docs))
            if self._buffer.num_docs >= self.config.max_buffered_docs:
                self._flush_buffer()

    def update_documents(self, term: Term, docs: list[Document]) -> None:
        """Atomic delete-then-block-add (reference index_writer.rs:452)."""
        with self._lock:
            self._ensure_open()
            self.delete_documents_by_term(term)
            self.add_documents(docs)

    def delete_documents_by_term(self, term: Term) -> None:
        with self._lock:
            self._ensure_open()
            self._change_gen += 1
            self._pending_deletes.append(
                _PendingDelete(
                    term=term,
                    buffer_watermark=self._buffer.num_docs,
                    applies_to_segments=[i.name for i in self._all_infos()],
                )
            )

    def delete_documents_by_query(self, query) -> None:
        """Delete every doc matching an arbitrary query (reference
        index_writer.rs delete_documents_by_queries). Same watermark
        semantics as term deletes: docs added AFTER the call are not
        affected; matching is evaluated per segment at apply time."""
        with self._lock:
            self._ensure_open()
            self._change_gen += 1
            self._pending_deletes.append(
                _PendingDelete(
                    term=None,
                    query=query,
                    buffer_watermark=self._buffer.num_docs,
                    applies_to_segments=[i.name for i in self._all_infos()],
                )
            )

    def update_numeric_doc_value(self, term: Term, field: str, value: int) -> None:
        """In-place numeric DV update for all docs matching term, without
        re-indexing (reference index_writer.rs update_numeric_doc_value /
        doc_values_update.rs)."""
        with self._lock:
            self._ensure_open()
            self._change_gen += 1
            self._pending_dv_updates.append(
                _PendingDVUpdate(
                    term=term,
                    field=field,
                    value=int(value),
                    buffer_watermark=self._buffer.num_docs,
                    applies_to_segments=[i.name for i in self._all_infos()],
                )
            )

    def update_binary_doc_value(self, term: Term, field: str, value: bytes) -> None:
        """In-place binary DV update for all docs matching term
        (reference doc_values_update.rs BinaryDocValuesUpdate)."""
        with self._lock:
            self._ensure_open()
            self._change_gen += 1
            self._pending_dv_updates.append(
                _PendingDVUpdate(
                    term=term,
                    field=field,
                    value=bytes(value),
                    buffer_watermark=self._buffer.num_docs,
                    applies_to_segments=[i.name for i in self._all_infos()],
                    binary=True,
                )
            )

    def update_document(self, term: Term, doc: Document) -> None:
        """Atomic delete-then-add (reference index_writer.rs:394)."""
        with self._lock:
            self._ensure_open()
            self.delete_documents_by_term(term)
            self.add_document(doc)

    def nrt_is_current(self, reader: IndexReader) -> bool:
        """Does `reader` reflect every change made through this writer
        (reference index_writer.rs:516 nrt_is_current)?"""
        with self._lock:
            return getattr(reader, "_writer_gen", -1) == self._change_gen

    def delete_all(self) -> None:
        with self._lock:
            self._ensure_open()
            self._change_gen += 1
            self._buffer = SegmentBuffer(self.config.analyzer)
            self._pending_deletes.clear()
            self._uncommitted.clear()
            self._infos.segments = []
            self._pool.clear()
            self._live_dirty.clear()

    def has_uncommitted_changes(self) -> bool:
        """True when buffered docs, flushed-uncommitted segments, pending
        deletes/DV-updates, or dirty live masks exist (reference
        index_writer.rs has_uncommitted_changes)."""
        with self._lock:
            return bool(
                self._buffer.num_docs
                or self._uncommitted
                or self._pending_deletes
                or self._pending_dv_updates
                or self._live_dirty
                or self._dv_dirty
            )

    def num_deleted_docs(self) -> int:
        """Deleted-but-not-purged docs across all segments (reference
        index_writer.rs num_deleted_docs)."""
        with self._lock:
            return sum(i.del_count for i in self._all_infos())

    @property
    def num_docs(self) -> int:
        """Docs visible to the next reader (buffered + live committed)."""
        with self._lock:
            n = self._buffer.num_docs
            for info in self._all_infos():
                snap = self._pool.get(info.name)
                if snap is not None:
                    n += snap.num_docs
                else:
                    n += info.max_doc - info.del_count
            return n

    # ---------- flush & deletes ----------
    def _flush_buffer(self) -> None:
        """Pack the in-RAM buffer into a real segment + write its file
        (no fsync; durability comes at commit)."""
        if self._buffer.num_docs == 0:
            self._apply_pending_deletes(flushed_name=None)
            self._apply_pending_dv_updates(flushed_name=None)
            return
        from rucene_tpu_torch.util.metrics import trace

        METRICS.incr("writer.flushes")
        with trace("writer.flush"):
            seg_data = self._buffer.finish()
            if self.config.index_sort is not None:
                from rucene_tpu_torch.index.index_sorting import sort_segment_data

                seg_data = sort_segment_data(seg_data, self.config.index_sort)
            name = _seg_name(self._infos.counter)
            self._infos.counter += 1
            packed = pack_segment(seg_data)
            segfiles.write_segment(self.directory, name, packed)
            snap = SegmentSnapshot(name, packed)
            self._pool[name] = snap
            info = SegmentCommitInfo(
                name=name, max_doc=packed.max_doc, dims=segfiles.packed_dims(packed)
            )
            self._uncommitted.append(info)
            self._buffer = SegmentBuffer(self.config.analyzer)
            # pending deletes/updates may also target the freshly flushed segment
            self._apply_pending_deletes(flushed_name=name)
            self._apply_pending_dv_updates(flushed_name=name)

    def _apply_pending_deletes(self, flushed_name: str | None) -> None:
        """BufferedUpdatesStream::apply_deletes_and_updates analog
        (reference bufferd_updates.rs:365)."""
        if not self._pending_deletes:
            return
        for pd in self._pending_deletes:
            targets = list(pd.applies_to_segments)
            for info in self._all_infos():
                if info.name in targets:
                    self._delete_in_segment(info, pd, watermark=None)
                elif info.name == flushed_name:
                    self._delete_in_segment(info, pd, watermark=pd.buffer_watermark)
        self._pending_deletes.clear()

    def _delete_in_segment(
        self, info: SegmentCommitInfo, pd: _PendingDelete, watermark: int | None
    ) -> None:
        snap = self._snapshot(info)
        if pd.term is not None:
            p = snap.read_postings(pd.term.field, pd.term.text)
            if p is None:
                return
            docs = p[0]
        else:  # delete-by-query: per-segment host evaluation (match only)
            from rucene_tpu_torch.index.reader import IndexReader
            from rucene_tpu_torch.search import host_engine
            from rucene_tpu_torch.search.searcher import IndexSearcher

            s = IndexSearcher(IndexReader([snap]), device="cpu")
            doc_freqs, stats = s._gather_stats_query(pd.query)
            match, _acc = host_engine.evaluate_query(
                snap, pd.query, s.similarity, stats, doc_freqs
            )
            docs = np.nonzero(match)[0]
        if watermark is not None:
            docs = docs[docs < watermark]
        if len(docs) == 0:
            return
        live = snap.live.copy() if snap.live is not None else np.ones(snap.max_doc, dtype=bool)
        before = int(live.sum())
        live[docs] = False
        after = int(live.sum())
        if after == before:
            return
        new_snap = snap.with_deletes(live)
        self._pool[info.name] = new_snap
        info.del_count = snap.max_doc - after
        self._live_dirty.add(info.name)

    def _apply_pending_dv_updates(self, flushed_name: str | None) -> None:
        if not self._pending_dv_updates:
            return
        for pu in self._pending_dv_updates:
            targets = set(pu.applies_to_segments)
            for info in self._all_infos():
                watermark = None
                if info.name in targets:
                    pass
                elif info.name == flushed_name:
                    watermark = pu.buffer_watermark
                else:
                    continue
                snap = self._snapshot(info)
                p = snap.read_postings(pu.term.field, pu.term.text)
                if p is None:
                    continue
                docs = p[0]
                if watermark is not None:
                    docs = docs[docs < watermark]
                if len(docs) == 0:
                    continue
                if pu.binary:
                    self._pool[info.name] = snap.with_binary_dv_updates(
                        pu.field, {int(d): pu.value for d in docs}
                    )
                else:
                    self._pool[info.name] = snap.with_dv_updates(
                        pu.field, {int(d): pu.value for d in docs}
                    )
                self._dv_dirty.add(info.name)
        self._pending_dv_updates.clear()

    def add_flushed_buffer(self, buffer) -> None:
        """Accept a privately built SegmentBuffer (DWPT handoff): pack it as
        a new segment under the writer lock (doc_writer.rs ticket queue
        analog — per-thread inversion happens outside the lock)."""
        seg_data = buffer.finish()  # outside the lock: the expensive part
        if self.config.index_sort is not None:
            from rucene_tpu_torch.index.index_sorting import sort_segment_data

            seg_data = sort_segment_data(seg_data, self.config.index_sort)
        packed = pack_segment(seg_data)
        with self._lock:
            self._ensure_open()
            name = _seg_name(self._infos.counter)
            self._infos.counter += 1
            segfiles.write_segment(self.directory, name, packed)
            self._pool[name] = SegmentSnapshot(name, packed)
            self._uncommitted.append(
                SegmentCommitInfo(
                    name=name, max_doc=packed.max_doc,
                    dims=segfiles.packed_dims(packed),
                )
            )

    def flush(self) -> None:
        with self._lock:
            self._ensure_open()
            self._flush_buffer()

    # ---------- commit ----------
    def commit(self) -> int:
        """Two-phase commit (reference index_writer.rs:630,1698): flush,
        apply deletes, persist live files, fsync everything referenced,
        pending_segments_N -> rename, GC unreferenced files."""
        with self._lock:
            self._ensure_open()
            try:
                self._flush_buffer()
                # persist dirty live masks with bumped del gens
                for info in self._all_infos():
                    if info.name in self._live_dirty:
                        snap = self._pool[info.name]
                        info.del_gen = info.del_gen + 1 if info.del_gen >= 0 else 0
                        segfiles.write_live(self.directory, info.name, info.del_gen, snap.live)
                    if info.name in self._dv_dirty:
                        snap = self._pool[info.name]
                        info.dv_gen = info.dv_gen + 1 if info.dv_gen >= 0 else 0
                        segfiles.write_dv_updates(
                            self.directory, info.name, info.dv_gen,
                            snap.dv_updates, snap.bdv_updates,
                        )
                self._live_dirty.clear()
                self._dv_dirty.clear()

                self._infos.segments = self._all_infos()
                self._uncommitted = []
                self._infos.version += 1
                self.directory.sync(self._infos.files())
                pending = segfiles.write_segments_file(self.directory, self._infos)
                segfiles.finish_segments_file(self.directory, self._infos, pending)
                self._gc_files()
                self._segments_changed = False
                if self.config.merge_on_commit:
                    self.maybe_merge()
                return self._infos.version
            except Exception as e:  # tragedy: poison the writer
                self._tragedy = e
                raise

    def _gc_files(self) -> None:
        """KeepOnlyLastCommit + ref-count GC
        (reference index_file_deleter.rs:34-80, delete_policy.rs:92)."""
        referenced = set(self._infos.files())
        referenced.add(f"{segfiles.SEGMENTS_PREFIX}{self._infos.generation}")
        referenced.add("write.lock")
        for info in self._uncommitted:
            referenced.update(info.files())
        referenced.update(self._merge_protected)  # in-flight merge outputs
        for name in self.directory.list_all():
            if name in referenced:
                continue
            if (
                name.endswith(".seg")
                or name.endswith(".liv")
                or name.endswith(".dvu")
                or name.startswith(segfiles.SEGMENTS_PREFIX)
                or name.startswith(segfiles.PENDING_PREFIX)
            ):
                try:
                    self.directory.delete_file(name)
                except OSError:
                    pass

    # ---------- readers ----------
    def get_reader(self) -> IndexReader:
        """NRT reader: point-in-time over flushed segments + fresh deletes,
        without fsync (reference index_writer.rs:287,1071). With
        ``merge_on_refresh`` it then calls maybe_merge, as Lucene's getReader
        does after its full flush."""
        from rucene_tpu_torch.util.metrics import trace

        with trace("writer.get_reader"), self._lock:
            self._ensure_open()
            self._flush_buffer()
            leaves = [self._snapshot(info) for info in self._all_infos()]
            reader = IndexReader(leaves)
            reader._writer_gen = self._change_gen
            if self.config.merge_on_refresh:
                self.maybe_merge()
            return reader

    # ---------- merge ----------
    def maybe_merge(self) -> int:
        """Find merge candidates and hand them to the scheduler. The heavy
        merge work runs OUTSIDE the writer lock (reference
        merge_scheduler.rs:141-250 — ConcurrentMergeScheduler exists so a
        running merge never blocks add_document); only registration (here)
        and the final swap (_commit_merge) hold it."""
        regs: list[_MergeRegistration] = []
        with self._lock:
            self._ensure_open()
            self._flush_buffer()
            # with merge_on_refresh the flushed segments are what a refresh
            # merges, so the policy sees them (Lucene's one segment list)
            pool = self._all_infos() if self.config.merge_on_refresh else self._infos.segments
            if getattr(self.config.merge_policy, "adjacent_only", False):
                # an order-keeping policy merges runs of adjacent segments,
                # so it sees every one in index order; _register_merge
                # refuses a run that holds a merging segment
                eligible = list(pool)
            else:
                eligible = [i for i in pool if i.name not in self._merging]
            sizes = {i.name: (i.max_doc - i.del_count) for i in eligible}
            deletes = {i.name: i.del_count for i in eligible}
            byte_sizes = None
            if getattr(self.config.merge_policy, "max_merged_segment_mb", None):
                byte_sizes = {}
                for i in eligible:
                    try:
                        byte_sizes[i.name] = self.directory.file_size(
                            segfiles.segment_file(i.name)
                        )
                    except OSError:
                        byte_sizes[i.name] = 0
            for cand in self.config.merge_policy.find_merges(
                sizes, deletes, byte_sizes=byte_sizes
            ):
                reg = self._register_merge(cand.segments)
                if reg is not None:
                    regs.append(reg)
        for reg in regs:
            self.config.merge_scheduler.merge(lambda r=reg: self._merge_job(r))
        return len(regs)

    def _register_merge(self, names: list[str]) -> _MergeRegistration | None:
        """Under the writer lock: validate inputs, snapshot them, reserve the
        output name, mark inputs merging (index_writer.rs merge_init)."""
        wanted = set(names)
        if wanted & self._merging:
            return None  # an overlapping merge is in flight; policy retries later
        infos = [i for i in self._all_infos() if i.name in wanted]
        if not infos:
            return None
        if len(infos) == 1 and infos[0].del_count == 0:
            return None  # singleton rewrite only pays off when it drops deletes
        snaps = [self._snapshot(i) for i in infos]
        new_name = _seg_name(self._infos.counter)
        self._infos.counter += 1
        self._merging.update(i.name for i in infos)
        self._merge_protected.add(segfiles.segment_file(new_name))
        return _MergeRegistration([i.name for i in infos], infos, snaps, new_name)

    def _merge_job(self, reg: _MergeRegistration) -> None:
        """Run one registered merge: the segment merge and output write
        happen WITHOUT the writer lock; the swap takes it. Errors are
        recorded in self.merge_exceptions and re-raised — the serial
        scheduler propagates them to the caller, the concurrent one logs
        (reference index_writer.rs feeds merge failures into the tragedy
        path instead of dropping them)."""
        from rucene_tpu_torch.util.metrics import trace

        try:
            METRICS.incr("writer.merges")
            with trace("writer.merge"):
                merged = self.config.merge_scheduler.segment_merge(reg.snaps)
                if merged.max_doc > 0:
                    segfiles.write_segment(self.directory, reg.new_name, merged)
            METRICS.incr("writer.merged_docs", merged.max_doc)
            with self._lock:
                self._commit_merge(reg, merged)
        except Exception as e:
            METRICS.incr("writer.merge_errors")
            with self._lock:
                self.merge_exceptions.append(e)
                self._merging.difference_update(reg.names)
                self._merge_protected.discard(segfiles.segment_file(reg.new_name))
            raise

    def _commit_merge(self, reg: _MergeRegistration, merged) -> None:
        """Swap the merged segment in (reference index_writer.rs:3465
        commit_merge + :3216 commit_merged_deletes). Deletes and DV updates
        that landed on the inputs WHILE the merge ran are remapped into the
        merged doc space so no update is lost. Caller holds self._lock."""
        self._merging.difference_update(reg.names)
        self._merge_protected.discard(segfiles.segment_file(reg.new_name))
        current = {i.name for i in self._all_infos()}
        if (
            self._closed
            or self._tragedy is not None
            or not all(n in current for n in reg.names)
        ):
            # stale merge (writer closed / inputs already replaced): drop output
            try:
                self.directory.delete_file(segfiles.segment_file(reg.new_name))
            except OSError:
                pass
            return

        # pending deletes/DV updates queued against the inputs must apply
        # BEFORE the inputs disappear (their applies_to_segments lists name
        # the old segments); apply against the inputs now and strip them
        # from the pending targets — other targets apply later as usual.
        drop = set(reg.names)
        for pd in self._pending_deletes:
            hit = [i for i in reg.infos if i.name in pd.applies_to_segments]
            for info in hit:
                self._delete_in_segment(info, pd, watermark=None)
            if hit:
                pd.applies_to_segments = [
                    n for n in pd.applies_to_segments if n not in drop
                ]
        for pu in self._pending_dv_updates:
            hit_names = [n for n in reg.names if n in pu.applies_to_segments]
            for name in hit_names:
                info = next(i for i in reg.infos if i.name == name)
                snap = self._snapshot(info)
                p = snap.read_postings(pu.term.field, pu.term.text)
                if p is not None and len(p[0]):
                    by_doc = {int(d): pu.value for d in p[0]}
                    if pu.binary:
                        self._pool[info.name] = snap.with_binary_dv_updates(
                            pu.field, by_doc
                        )
                    else:
                        self._pool[info.name] = snap.with_dv_updates(
                            pu.field, by_doc
                        )
            if hit_names:
                pu.applies_to_segments = [
                    n for n in pu.applies_to_segments if n not in drop
                ]

        all_dead = merged.max_doc == 0  # fully-deleted inputs: drop, no output
        new_info = None
        if not all_dead:
            new_info = SegmentCommitInfo(
                name=reg.new_name, max_doc=merged.max_doc,
                dims=segfiles.packed_dims(merged),
            )
            new_snap = SegmentSnapshot(reg.new_name, merged)
            # remap updates that arrived during the merge: merged layout is
            # the concatenation of each input's live docs in order
            # (merge.py _remap: new_id = cumsum(live)-1+base)
            carried_dead: list[np.ndarray] = []
            dv_carry: dict[str, dict[int, int]] = {}
            bdv_carry: dict[str, dict[int, bytes]] = {}
            base = 0
            for snap0 in reg.snaps:
                cur = self._pool.get(snap0.name, snap0)
                live0 = (
                    snap0.live
                    if snap0.live is not None
                    else np.ones(snap0.max_doc, dtype=bool)
                )
                newid = np.cumsum(live0) - 1 + base
                if cur is not snap0:
                    live_now = (
                        cur.live
                        if cur.live is not None
                        else np.ones(cur.max_doc, dtype=bool)
                    )
                    newly_dead = live0 & ~live_now
                    if newly_dead.any():
                        carried_dead.append(newid[newly_dead])
                    for f, m in cur.dv_updates.items():
                        oldm = snap0.dv_updates.get(f, {})
                        for d, v in m.items():
                            if oldm.get(d) != v and live0[d]:
                                dv_carry.setdefault(f, {})[int(newid[d])] = v
                    for f, m in cur.bdv_updates.items():
                        oldm = snap0.bdv_updates.get(f, {})
                        for d, v in m.items():
                            if oldm.get(d) != v and live0[d]:
                                bdv_carry.setdefault(f, {})[int(newid[d])] = v
                base += int(live0.sum())
            if carried_dead:
                live_new = np.ones(merged.max_doc, dtype=bool)
                live_new[np.concatenate(carried_dead)] = False
                new_snap = new_snap.with_deletes(live_new)
                new_info.del_count = merged.max_doc - int(live_new.sum())
                self._live_dirty.add(reg.new_name)
            for f, m in dv_carry.items():
                new_snap = new_snap.with_dv_updates(f, m)
            for f, m in bdv_carry.items():
                new_snap = new_snap.with_binary_dv_updates(f, m)
            if dv_carry or bdv_carry:
                self._dv_dirty.add(reg.new_name)
            self._pool[reg.new_name] = new_snap

        # the merged segment holds uncommitted docs where any input was a
        # flushed segment: it stays among those, so commit writes it
        flushed = any(i.name in drop for i in self._uncommitted)
        self._infos.segments = self._drop_merged(
            self._infos.segments, drop, None if flushed else new_info)
        self._uncommitted = self._drop_merged(
            self._uncommitted, drop, new_info if flushed else None)
        self._segments_changed = True

    def _drop_merged(self, infos, drop: set, new_info) -> list[SegmentCommitInfo]:
        """``infos`` without the merge's inputs ``drop``, with ``new_info``
        (None: nothing) in the first input's place. Caller holds the lock."""
        kept: list[SegmentCommitInfo] = []
        inserted = False
        for info in infos:
            if info.name in drop:
                if not inserted and new_info is not None:
                    kept.append(new_info)
                    inserted = True
                self._pool.pop(info.name, None)
                self._live_dirty.discard(info.name)
                self._dv_dirty.discard(info.name)
            else:
                kept.append(info)
        return kept

    def _drain_merges(self) -> None:
        sched = self.config.merge_scheduler
        if hasattr(sched, "sync"):
            sched.sync()

    def force_merge(self, max_segments: int = 1) -> None:
        """reference index_writer.rs:580,2440. Waits for in-flight
        background merges first, then merges inline."""
        self._drain_merges()
        with self._lock:
            self._ensure_open()
            self._flush_buffer()
            self._infos.segments = self._all_infos()
            self._uncommitted = []
            while len(self._infos.segments) > max_segments:
                sizes = {i.name: (i.max_doc - i.del_count) for i in self._infos.segments}
                cands = self.config.merge_policy.find_forced_merges(sizes, max_segments)
                if not cands:
                    break
                for cand in cands:
                    reg = self._register_merge(cand.segments)
                    if reg is not None:
                        self._merge_job(reg)

    def force_merge_deletes(self) -> None:
        """Rewrite every segment carrying deletes, dropping dead docs
        (reference MergePolicy::find_forced_deletes_merges /
        index_writer.rs force_merge_deletes)."""
        self._drain_merges()
        with self._lock:
            self._ensure_open()
            self._flush_buffer()
            self._infos.segments = self._all_infos()
            self._uncommitted = []
            with_dels = [i.name for i in self._infos.segments if i.del_count > 0
                         or (self._pool.get(i.name) is not None
                             and self._pool[i.name].del_count > 0)]
            for name in with_dels:
                info = next(i for i in self._infos.segments if i.name == name)
                snap = self._snapshot(info)
                if snap.del_count == 0:
                    continue
                merged = merge_segments([snap])
                new_name = _seg_name(self._infos.counter)
                self._infos.counter += 1
                segfiles.write_segment(self.directory, new_name, merged)
                new_info = SegmentCommitInfo(
                    name=new_name, max_doc=merged.max_doc,
                    dims=segfiles.packed_dims(merged),
                )
                self._pool[new_name] = SegmentSnapshot(new_name, merged)
                self._infos.segments = [
                    new_info if i.name == name else i for i in self._infos.segments
                ]
                self._pool.pop(name, None)
                self._live_dirty.discard(name)

    # ---------- lifecycle ----------
    def rollback(self) -> None:
        """Restore last commit (reference index_writer.rs:336,1383)."""
        with self._lock:
            self._infos = segfiles.read_segments_file(self.directory)
            self._uncommitted = []
            self._pending_deletes = []
            self._pending_dv_updates = []
            self._dv_dirty.clear()
            self._buffer = SegmentBuffer(self.config.analyzer)
            self._pool.clear()
            self._live_dirty.clear()
            self._tragedy = None

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            if self.config.commit_on_close and self._tragedy is None:
                self.commit()
        # join background merges OUTSIDE the writer lock (they take it)
        sched = self.config.merge_scheduler
        if hasattr(sched, "close"):
            sched.close()
        # merges that completed after the final commit changed the segment
        # list; persist them so the merged form survives reopen (the
        # reference waits for merges before its close commit)
        if (
            self.config.commit_on_close
            and self._tragedy is None
            and self._segments_changed
        ):
            saved = self.config.merge_on_commit
            self.config.merge_on_commit = False
            try:
                self.commit()
            finally:
                self.config.merge_on_commit = saved
        with self._lock:
            self._closed = True
            if self._write_lock is not None:
                self._write_lock.release()
                self._write_lock = None

    def __enter__(self) -> "IndexWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self._closed = True
            if self._write_lock is not None:
                self._write_lock.release()
                self._write_lock = None

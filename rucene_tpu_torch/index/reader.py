"""Read side: SegmentSnapshot and IndexReader (counterpart of
rucene_tpu/index/reader.py).

A snapshot is immutable: NRT refreshes, deletes and doc-values updates make
new snapshots of a segment (with_deletes, with_dv_updates,
with_binary_dv_updates) that share its packed postings and their device
forms. A segment's device form is built once per torch device, lazily, on
the first search that needs it (decoded or packed as
codec/device.decoded_policy says, RUCENE_DECODED, read then; a decoded
form also gets its dense tf planes, codec/device.add_tf_planes,
RUCENE_PLANES, and their rows, plane_slots). Each counts one
``reader.device_builds``. A snapshot with deletes serves that form under
its own live mask (codec/device.with_live): one upload of the mask, no
decode.

An IndexReader serves views of its snapshots (SegmentSnapshot.view): each
view carries this reader's doc base and torch device and shares the rest
with its snapshot. So a reader's global doc ids never move when another
reader is built over some of the same snapshots (the writer's pool hands
one snapshot to every NRT reader), and moving one reader to a device
(IndexReader.to) never drops another reader's device tensors. The
reference writes both onto the shared snapshot; ROADMAP.md §3 lists that
fault.

The small-segment shape floors of the reference, and its rule that serves
small segments packed, are left out: they exist to reuse compiled XLA
programs and to spare the TPU host link (codec/device.decoded_policy
states the port's rule).
"""

from __future__ import annotations

import bisect
import copy
from dataclasses import dataclass

import numpy as np
import torch

from rucene_tpu_torch.codec.device import (
    DeviceSegment,
    add_decoded_planes,
    add_tf_planes,
    build_device_segment,
    decoded_policy,
    with_live,
)
from rucene_tpu_torch.codec.postings import PackedSegment
from rucene_tpu_torch.search.similarity import CollectionStats
from rucene_tpu_torch.util.metrics import METRICS
from rucene_tpu_torch.util.packing import (
    EF_TAG,
    EF_UNARY_WORDS,
    decode_ef_doc_plane,
    unpack_block,
)


def _decode_positions(
    pos_data: np.ndarray, word_start: int, width: int, total: int, freqs: np.ndarray
) -> np.ndarray:
    """Unpack a term's fixed-width position deltas and restore absolute
    positions per doc run (delta[0] of a run is already absolute)."""
    if total == 0:
        return np.zeros(0, np.int64)
    nwords = (total * width + 31) // 32 + 1
    words = pos_data[word_start : word_start + nwords].astype(np.uint64)
    deltas = unpack_block(words, width, n=total).astype(np.int64)
    c = np.cumsum(deltas)
    run_start = np.concatenate([[0], np.cumsum(freqs)])[:-1].astype(np.int64)
    base = c[run_start] - deltas[run_start]  # cumsum before each run
    return c - np.repeat(base, freqs)


@dataclass(frozen=True)
class TermRecord:
    ord: int
    doc_freq: int
    total_tf: int
    block_start: int
    block_count: int
    pos_start: int  # global occurrence index of the term's first position
    pos_width: int = 32  # packed position-delta bit width
    pos_word_start: int = 0  # word offset of the term's position stream


class SegmentSnapshot:
    """One immutable segment view: host metadata + device tensors.

    Shared by every snapshot of the segment: ``packed`` and ``_forms``
    ({torch device: (DeviceSegment with every real doc live, plane
    rows)}). Shared by a snapshot and its reader views: ``live``, the
    doc-values overlays and ``_live_forms`` ({torch device: the form under
    this live mask}). Per view: ``doc_base``, ``torch_device`` and the
    memo of the form it serves (``_device``, ``plane_slots``)."""

    def __init__(self, name: str, packed: PackedSegment, live: np.ndarray | None = None):
        self.name = name
        self.packed = packed
        self.live = live  # None => all live
        self.source = self  # the snapshot a reader's view was made from
        self.doc_base = 0  # assigned by IndexReader, on its view
        self.torch_device = torch.device("cpu")  # set by IndexReader.to, on its view
        self._device: DeviceSegment | None = None
        # hot-term tf-plane rows {term block_start -> plane row} of the
        # served form; set with it (codec/device.add_tf_planes)
        self.plane_slots: dict[int, int] = {}
        self._forms: dict = {}
        self._live_forms: dict = {}
        # numeric / binary doc-values updates overlaying the segment's
        # columns (reference doc_values_update.rs: update by term, no reindex)
        self.dv_updates: dict[str, dict[int, int]] = {}
        self.bdv_updates: dict[str, dict[int, bytes]] = {}
        self._bkd_cache: dict = {}  # field -> BKD tree of its multi-dim points

    @property
    def device(self) -> DeviceSegment:
        """This view's device form on ``torch_device``: built on first
        access for the segment, then shared by every snapshot and view of
        it; a live mask of its own costs one upload."""
        if self._device is None:
            d = self.torch_device
            # setdefault: two threads that build at once keep one form
            form = self._forms.get(d)
            if form is None:
                form = self._forms.setdefault(d, self._build_form(d))
            dev = self._live_forms.get(d)
            if dev is None:
                dev = form[0] if self.live is None else with_live(form[0], self.live)
                dev = self._live_forms.setdefault(d, dev)
            self._device = dev
            self.plane_slots = form[1]
        return self._device

    def _build_form(self, d: torch.device):
        packed = self.packed
        dev = build_device_segment(packed, d)
        mf = int(packed.blk_max_freq.max()) if packed.num_blocks else 0
        decoded, fdt = decoded_policy(packed.num_blocks, mf)
        slots: dict[int, int] = {}
        if decoded:
            dev = add_decoded_planes(dev, freq_dtype=fdt)
            dev, slots = add_tf_planes(dev, packed)
        METRICS.incr("reader.device_builds")
        return dev, slots

    def view(self, doc_base: int) -> "SegmentSnapshot":
        """A reader's view: this snapshot under ``doc_base``, on this
        snapshot's torch device until the reader moves it."""
        v = copy.copy(self)
        v.doc_base = doc_base
        return v

    @property
    def max_doc(self) -> int:
        return self.packed.max_doc

    @property
    def del_count(self) -> int:
        return 0 if self.live is None else int(self.max_doc - self.live.sum())

    @property
    def num_docs(self) -> int:
        return self.max_doc - self.del_count

    def with_deletes(self, live: np.ndarray) -> "SegmentSnapshot":
        """New snapshot under an updated live mask. Its device form is the
        segment's, under the new mask, made when it is first served."""
        snap = self._clone_for_updates()
        snap.live = live.copy()
        snap._live_forms = {}
        snap._device = None
        snap.plane_slots = {}
        return snap

    def with_dv_updates(self, field: str, by_doc: dict[int, int]) -> "SegmentSnapshot":
        """New snapshot with numeric doc-values overridden for some docs."""
        snap = self._clone_for_updates()
        snap.dv_updates.setdefault(field, {}).update(by_doc)
        return snap

    def with_binary_dv_updates(
        self, field: str, by_doc: dict[int, bytes]
    ) -> "SegmentSnapshot":
        """New snapshot with binary doc-values overridden for some docs
        (reference doc_values_update.rs BinaryDocValuesUpdate)."""
        snap = self._clone_for_updates()
        snap.bdv_updates.setdefault(field, {}).update(by_doc)
        return snap

    def _clone_for_updates(self) -> "SegmentSnapshot":
        """A new snapshot of this segment, on this snapshot's torch device:
        the packed postings, their device forms and (same live mask) the
        form it serves shared, the doc-values overlays copied."""
        snap = copy.copy(self)
        snap.source = snap
        snap.doc_base = 0
        snap.dv_updates = {f: dict(m) for f, m in self.dv_updates.items()}
        snap.bdv_updates = {f: dict(m) for f, m in self.bdv_updates.items()}
        return snap

    # --- term dictionary ---
    def term_record(self, field: str, text: str) -> TermRecord | None:
        pf = self.packed.fields.get(field)
        if pf is None:
            return None
        ord_ = pf.term_ord.get(text)
        if ord_ is None:
            return None
        return TermRecord(
            ord=ord_,
            doc_freq=int(pf.doc_freq[ord_]),
            total_tf=int(pf.total_tf[ord_]),
            block_start=int(pf.block_start[ord_]),
            block_count=int(pf.block_count[ord_]),
            pos_start=int(pf.pos_start[ord_]),
            pos_width=int(pf.pos_width[ord_]) if pf.pos_width is not None else 32,
            pos_word_start=int(pf.pos_word_start[ord_]) if pf.pos_word_start is not None else 0,
        )

    def terms_iterator(self, field: str) -> "TermsIterator | None":
        """Ordered term enumeration with seek (reference TermIterator:
        blocktree SegmentTermIterator, blocktree_reader.rs:907)."""
        pf = self.packed.fields.get(field)
        if pf is None:
            return None
        return TermsIterator(self, field, pf)

    def prefix_terms(self, field: str, prefix: str) -> list[str]:
        """All terms starting with ``prefix``, in order (a bisect range of
        the sorted term list)."""
        pf = self.packed.fields.get(field)
        if pf is None:
            return []
        lo = bisect.bisect_left(pf.terms, prefix)
        hi = lo
        while hi < len(pf.terms) and pf.terms[hi].startswith(prefix):
            hi += 1
        return pf.terms[lo:hi]

    def prefix_docs(self, field: str, prefix: str) -> np.ndarray:
        """Union of doc ids over all terms with ``prefix`` (PrefixQuery's
        constant-score doc set)."""
        parts = [
            p[0]
            for t in self.prefix_terms(field, prefix)
            if (p := self.read_postings(field, t)) is not None
        ]
        if not parts:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(parts)).astype(np.int64)

    def field_stats(self, field: str) -> CollectionStats | None:
        st = self.packed.stats.get(field)
        if st is None:
            return None
        return CollectionStats(
            field=field,
            max_doc=self.max_doc,
            doc_count=st.doc_count,
            sum_total_term_freq=st.sum_total_term_freq,
        )

    # --- host-side postings decode ---
    def read_postings(
        self,
        field: str,
        text: str,
        with_positions: bool = False,
        with_offsets: bool = False,
        with_payloads: bool = False,
    ):
        """Host decode of one term's postings: (docs i64[df], freqs
        i64[df], positions i64[sum(freqs)] or None), plus the
        occurrence-aligned (starts, ends) offsets and the payload list when
        either is asked for; None for an absent term. Occurrence j of doc i
        sits at positions[cumfreq[i] + j]."""
        rec = self.term_record(field, text)
        if rec is None:
            return None
        p = self.packed
        docs = np.empty(rec.doc_freq, dtype=np.int64)
        freqs = np.empty(rec.doc_freq, dtype=np.int64)
        out = 0
        for bi in range(rec.block_start, rec.block_start + rec.block_count):
            cnt = int(p.blk_count[bi])
            off = int(p.blk_off[bi])
            dbits = int(p.blk_doc_bits[bi])
            fbits = int(p.blk_freq_bits[bi])
            if dbits >= EF_TAG:
                dwlen = 4 * (dbits - EF_TAG) + EF_UNARY_WORDS
                v = decode_ef_doc_plane(p.data[off : off + dwlen], dbits - EF_TAG)
                docs[out : out + cnt] = int(p.blk_base[bi]) + v[:cnt]
            else:
                dwlen = 4 * dbits
                dwords = p.data[off : off + dwlen].astype(np.uint64)
                deltas = unpack_block(dwords, dbits)[:cnt].astype(np.int64)
                docs[out : out + cnt] = int(p.blk_base[bi]) + np.cumsum(deltas)
            fwords = p.data[off + dwlen : off + dwlen + 4 * fbits].astype(np.uint64)
            freqs[out : out + cnt] = unpack_block(fwords, fbits)[:cnt]
            out += cnt
        positions = None
        total = int(freqs.sum())
        if with_positions or with_offsets or with_payloads:
            positions = _decode_positions(
                p.positions, rec.pos_word_start, rec.pos_width, total, freqs
            )
        if not (with_offsets or with_payloads):
            return docs, freqs, positions
        a = int(rec.pos_start)  # the term's first global occurrence
        offsets = None
        if with_offsets and p.off_starts is not None:
            offsets = (p.off_starts[a : a + total], p.off_ends[a : a + total])
        payloads = None
        if with_payloads and p.pay is not None:
            payloads = list(p.pay[a : a + total])
        return docs, freqs, positions, offsets, payloads

    def document(self, local_doc: int) -> dict[str, object]:
        """Stored fields of one doc."""
        return self.packed.stored[local_doc]

    def term_vector(self, local_doc: int, field: str) -> dict[str, list] | None:
        """Per-doc mini inverted index: {term: [(pos, start, end), ...]}
        (reference term_vectors_reader.rs)."""
        tvs = self.packed.term_vectors
        if tvs is None or local_doc >= len(tvs):
            return None
        return tvs[local_doc].get(field)

    def exists_mask(self, field: str) -> np.ndarray:
        """bool[max_doc]: docs that have the field, through norms, any
        doc-values family (updates applied), points or postings
        (exists_query.rs:30)."""
        md = self.max_doc
        m = np.zeros(md, dtype=bool)
        norms = self.packed.norms.get(field)
        if norms is not None:
            m |= norms[:md] > 0
        dv = self.numeric_doc_values(field)
        if dv is not None:
            m |= dv[1][:md]
        bdv = self.binary_doc_values(field)
        if bdv is not None:
            m |= np.array([v is not None for v in bdv[:md]], bool)
        sdv = self.sorted_doc_values(field)
        if sdv is not None:
            m |= sdv[1][:md] >= 0
        sndv = self.sorted_numeric_doc_values(field)
        if sndv is not None:
            m |= np.diff(sndv[1][: md + 1]) > 0
        ssdv = self.sorted_set_doc_values(field)
        if ssdv is not None:
            m |= np.diff(ssdv[2][: md + 1]) > 0
        pt = self.packed.points.get(field)
        if pt is not None:
            m[pt[1]] = True
        pf = self.packed.fields.get(field)
        if pf is not None and field not in self.packed.norms:
            # untokenized / omit-norms indexed fields: walk the postings
            for t in pf.terms:
                m[self.read_postings(field, t)[0]] = True
        return m

    def point_range_docs(self, field: str, lower, upper) -> np.ndarray:
        """Docs whose point value lies in [lower, upper] (inclusive, None an
        open end). 1-D points are a sorted column: two binary searches and
        a slice. Multi-dimensional points (tuple bounds) intersect the BKD
        tree's leaf boxes (util/bkd.py, bkd_reader.rs:68)."""
        pt = self.packed.points.get(field)
        if pt is None:
            return np.zeros(0, dtype=np.int64)
        vals, docs = pt
        if vals.ndim == 2:
            from rucene_tpu_torch.util.bkd import bkd_range_docs, tree_from_leaf_ordered

            tree = self._bkd_cache.get(field)
            if tree is None:
                tree = self._bkd_cache[field] = tree_from_leaf_ordered(vals, docs)
            return bkd_range_docs(tree, lower, upper)
        lo = 0 if lower is None else int(np.searchsorted(vals, lower, side="left"))
        hi = len(vals) if upper is None else int(np.searchsorted(vals, upper, side="right"))
        return np.unique(docs[lo:hi]).astype(np.int64)

    def numeric_doc_values(self, field: str) -> tuple[np.ndarray, np.ndarray] | None:
        """(values i64[max_doc], present bool[max_doc]) or None, with this
        snapshot's numeric updates applied."""
        base = self.packed.numeric_dv.get(field)
        over = self.dv_updates.get(field)
        if not over:
            return base
        if base is None:
            vals = np.zeros(self.max_doc, np.int64)
            present = np.zeros(self.max_doc, bool)
        else:
            vals, present = base[0].copy(), base[1].copy()
        docs = np.fromiter(over.keys(), dtype=np.int64, count=len(over))
        vv = np.fromiter(over.values(), dtype=np.int64, count=len(over))
        vals[docs] = vv
        present[docs] = True
        return vals, present

    def binary_doc_values(self, field: str) -> list | None:
        """Per-doc bytes or None, with this snapshot's binary updates
        applied."""
        base = (self.packed.binary_dv or {}).get(field)
        over = self.bdv_updates.get(field)
        if not over:
            return base
        out = list(base) if base is not None else [None] * self.max_doc
        for d, v in over.items():
            out[d] = v
        return out

    def sorted_doc_values(self, field: str):
        """(values sorted list[str], ords i32[max_doc] with -1 missing)."""
        return (self.packed.sorted_dv or {}).get(field)

    def sorted_numeric_doc_values(self, field: str):
        """(flat sorted values i64, offsets i64[max_doc+1])."""
        return (self.packed.sorted_numeric_dv or {}).get(field)

    def sorted_set_doc_values(self, field: str):
        """(values list[str], flat ords i32, offsets i64[max_doc+1])."""
        return (self.packed.sorted_set_dv or {}).get(field)


class TermsIterator:
    """Ordered enumeration over one field's term dictionary (reference
    TermIterator protocol: next / seek_exact / seek_ceil / term / ord /
    doc_freq / total_term_freq / postings, blocktree_reader.rs:907)."""

    END = "END"
    FOUND = "FOUND"
    NOT_FOUND = "NOT_FOUND"

    def __init__(self, snap: SegmentSnapshot, field: str, pf):
        self._snap = snap
        self._field = field
        self._pf = pf
        self._ord = -1  # positioned before the first term

    def next(self) -> str | None:
        if self._ord + 1 >= len(self._pf.terms):
            self._ord = len(self._pf.terms)
            return None
        self._ord += 1
        return self._pf.terms[self._ord]

    def seek_exact(self, text: str) -> bool:
        o = self._pf.term_ord.get(text)
        if o is None:
            return False
        self._ord = o
        return True

    def seek_ceil(self, text: str) -> str:
        """Position at the smallest term >= text: FOUND / NOT_FOUND (at the
        successor) / END."""
        o = bisect.bisect_left(self._pf.terms, text)
        self._ord = o
        if o >= len(self._pf.terms):
            return self.END
        return self.FOUND if self._pf.terms[o] == text else self.NOT_FOUND

    def seek_ord(self, ord_: int) -> None:
        if not 0 <= ord_ < len(self._pf.terms):
            raise IndexError(f"term ord {ord_} out of range")
        self._ord = ord_

    def term(self) -> str | None:
        if 0 <= self._ord < len(self._pf.terms):
            return self._pf.terms[self._ord]
        return None

    def ord(self) -> int:
        return self._ord

    def doc_freq(self) -> int:
        return int(self._pf.doc_freq[self._ord])

    def total_term_freq(self) -> int:
        return int(self._pf.total_tf[self._ord])

    def postings(self, with_positions: bool = False):
        t = self.term()
        if t is None:
            raise ValueError("iterator is unpositioned")
        return self._snap.read_postings(self._field, t, with_positions=with_positions)


class IndexReader:
    """Point-in-time composite over segment snapshots, served from one
    torch device at a time (IndexReader.to). ``leaves`` are this reader's
    views of the snapshots it was given (SegmentSnapshot.view)."""

    def __init__(self, leaves: list[SegmentSnapshot]):
        self.leaves = []
        base = 0
        for leaf in leaves:
            self.leaves.append(leaf.view(base))
            base += leaf.max_doc
        self.max_doc = base
        # point-in-time reader: doc freqs are immutable (deletes do not
        # change df, as in Lucene), so they are memoized across batches
        self._df_cache: dict[tuple[str, str], int] = {}

    def to(self, device) -> "IndexReader":
        """Serve every leaf from ``device``. Only this reader's views move:
        a form built on another device stays with the segment for the
        readers that serve it there."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        for leaf in self.leaves:
            if leaf.torch_device != device:
                leaf.torch_device = device
                leaf._device = None
                leaf.plane_slots = {}
        return self

    @property
    def num_docs(self) -> int:
        return sum(leaf.num_docs for leaf in self.leaves)

    def collection_stats(self, field: str) -> CollectionStats:
        doc_count = 0
        sum_ttf = 0
        for leaf in self.leaves:
            st = leaf.field_stats(field)
            if st is not None:
                doc_count += st.doc_count
                sum_ttf += st.sum_total_term_freq
        return CollectionStats(
            field=field,
            max_doc=self.max_doc,
            doc_count=doc_count if doc_count else -1,
            sum_total_term_freq=sum_ttf,
        )

    def doc_freq(self, field: str, text: str) -> int:
        got = self._df_cache.get((field, text))
        if got is None:
            got = sum(
                rec.doc_freq
                for leaf in self.leaves
                if (rec := leaf.term_record(field, text)) is not None
            )
            if len(self._df_cache) > 1 << 20:
                self._df_cache.clear()
            self._df_cache[(field, text)] = got
        return got

    def document(self, doc: int) -> dict[str, object]:
        """Stored fields of a global doc id of this reader."""
        for leaf in reversed(self.leaves):
            if doc >= leaf.doc_base:
                return leaf.document(doc - leaf.doc_base)
        raise IndexError(f"doc {doc} out of range")


def load_segment_snapshot(directory, info) -> SegmentSnapshot:
    """Load one committed segment (with its live and doc-values update
    generations) as a snapshot."""
    from rucene_tpu_torch.codec import files as segfiles

    packed = segfiles.read_segment(directory, info.name)
    live = (
        segfiles.read_live(directory, info.name, info.del_gen)
        if info.del_gen >= 0
        else None
    )
    snap = SegmentSnapshot(info.name, packed, live=live)
    if info.dv_gen >= 0:
        num_u, bin_u = segfiles.read_dv_updates(directory, info.name, info.dv_gen)
        for f, m in num_u.items():
            snap = snap.with_dv_updates(f, m)
        for f, m in bin_u.items():
            snap = snap.with_binary_dv_updates(f, m)
    return snap


def open_directory_reader(directory) -> IndexReader:
    """Open the latest commit (reference directory_reader.rs:62). Nothing
    touches a device until the reader is searched."""
    from rucene_tpu_torch.codec import files as segfiles

    infos = segfiles.read_segments_file(directory)
    return IndexReader([load_segment_snapshot(directory, info) for info in infos.segments])

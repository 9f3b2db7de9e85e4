"""Read side: SegmentSnapshot and IndexReader (counterpart of
rucene_tpu/index/reader.py, slimmed to what the query classes read: the
term dictionary, host postings with positions, and the doc sets of the
range, exists and prefix filters over points, every doc-values family,
norms and postings).

A snapshot builds its DeviceSegment lazily on first search, on the device
its reader names, decoded or packed as codec/device.decoded_policy says
(RUCENE_DECODED, read when the segment is built). A decoded segment also
gets its dense tf planes then (codec/device.add_tf_planes, RUCENE_PLANES),
and the snapshot their rows (plane_slots). The small-segment shape
floors of the reference, and its rule that serves small segments packed,
are left out: they exist to reuse compiled XLA programs and to spare the
TPU host link. So are the doc-values update overlays (``dv_updates``,
``bdv_updates``), which come with the writer and NRT (ROADMAP.md §1 item
10): the doc-values accessors read the segment's own columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rucene_tpu_torch.codec.device import (
    DeviceSegment,
    add_decoded_planes,
    add_tf_planes,
    build_device_segment,
    decoded_policy,
)
from rucene_tpu_torch.codec.postings import PackedSegment
from rucene_tpu_torch.search.similarity import CollectionStats
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
    """One immutable segment view: host metadata + device tensors."""

    def __init__(self, name: str, packed: PackedSegment, live: np.ndarray | None = None):
        self.name = name
        self.packed = packed
        self.live = live  # None => all live
        self.doc_base = 0  # assigned by IndexReader
        self.torch_device = torch.device("cpu")  # set by IndexReader.to
        self._device: DeviceSegment | None = None
        # hot-term tf-plane rows {term block_start -> plane row}; filled
        # when the device segment is built (codec/device.add_tf_planes)
        self.plane_slots: dict[int, int] = {}
        self._bkd_cache: dict = {}  # field -> BKD tree of its multi-dim points

    @property
    def device(self) -> DeviceSegment:
        """Device tensors, decoded or packed, built on first access."""
        if self._device is None:
            packed = self.packed
            dev = build_device_segment(packed, self.torch_device, self.live)
            mf = int(packed.blk_max_freq.max()) if packed.num_blocks else 0
            decoded, fdt = decoded_policy(packed.num_blocks, mf)
            self.plane_slots = {}
            if decoded:
                dev = add_decoded_planes(dev, freq_dtype=fdt)
                dev, self.plane_slots = add_tf_planes(dev, packed)
            self._device = dev
        return self._device

    @property
    def max_doc(self) -> int:
        return self.packed.max_doc

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

    def prefix_terms(self, field: str, prefix: str) -> list[str]:
        """All terms starting with ``prefix``, in order (a bisect range of
        the sorted term list)."""
        import bisect

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

    def read_postings(self, field: str, text: str, with_positions: bool = False):
        """Host decode of one term's postings: (docs i64[df], freqs
        i64[df], positions i64[sum(freqs)] or None), or None for an absent
        term. Occurrence j of doc i sits at positions[cumfreq[i] + j]."""
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
        if with_positions:
            positions = _decode_positions(
                p.positions, rec.pos_word_start, rec.pos_width, int(freqs.sum()), freqs
            )
        return docs, freqs, positions

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


    def exists_mask(self, field: str) -> np.ndarray:
        """bool[max_doc]: docs that have the field, through norms, any
        doc-values family, points or postings (exists_query.rs:30)."""
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
        """(values i64[max_doc], present bool[max_doc]) or None."""
        return self.packed.numeric_dv.get(field)

    def binary_doc_values(self, field: str) -> list | None:
        """Per-doc bytes or None."""
        return (self.packed.binary_dv or {}).get(field)

    def sorted_doc_values(self, field: str):
        """(values sorted list[str], ords i32[max_doc] with -1 missing)."""
        return (self.packed.sorted_dv or {}).get(field)

    def sorted_numeric_doc_values(self, field: str):
        """(flat sorted values i64, offsets i64[max_doc+1])."""
        return (self.packed.sorted_numeric_dv or {}).get(field)

    def sorted_set_doc_values(self, field: str):
        """(values list[str], flat ords i32, offsets i64[max_doc+1])."""
        return (self.packed.sorted_set_dv or {}).get(field)

class IndexReader:
    """Point-in-time composite over segment snapshots, served from one
    torch device at a time (IndexReader.to)."""

    def __init__(self, leaves: list[SegmentSnapshot]):
        self.leaves = leaves
        base = 0
        for leaf in leaves:
            leaf.doc_base = base
            base += leaf.max_doc
        self.max_doc = base
        self._df_cache: dict[tuple[str, str], int] = {}

    def to(self, device) -> "IndexReader":
        """Serve every leaf from ``device``; device tensors already built on
        another device are dropped and rebuilt lazily."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        for leaf in self.leaves:
            if leaf.torch_device != device:
                leaf.torch_device = device
                leaf._device = None
                leaf.plane_slots = {}
        return self

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

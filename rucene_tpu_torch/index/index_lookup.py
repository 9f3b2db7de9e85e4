"""LeafIndexLookup: scripting-style access to index statistics per doc.

reference: rucene src/core/index/reader/index_lookup.rs:25 (TermPosition,
LeafIndexLookup) — the Zhihu extension mirroring Elasticsearch's `_index`
script variable: per-term df/ttf and per-doc tf/positions/offsets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rucene_tpu_torch.index.reader import SegmentSnapshot


@dataclass
class TermPosition:
    position: int
    start_offset: int = -1
    end_offset: int = -1
    payload: bytes | None = None

    # PayloadHelper-style decodes (the reference declares these but leaves
    # them unimplemented!(), index_lookup.rs:48-70; big-endian like Lucene)
    def payload_as_int(self, default: int = 0) -> int:
        if not self.payload or len(self.payload) < 4:
            return default
        return int.from_bytes(self.payload[:4], "big", signed=True)

    def payload_as_float(self, default: float = 0.0) -> float:
        if not self.payload or len(self.payload) < 4:
            return default
        import struct

        return struct.unpack(">f", self.payload[:4])[0]

    def payload_as_string(self, default: str = "") -> str:
        if not self.payload:
            return default
        return self.payload.decode("utf-8", "replace")


class IndexField:
    def __init__(self, leaf: SegmentSnapshot, field: str):
        self._leaf = leaf
        self.field = field

    def __getitem__(self, term: str) -> "IndexFieldTerm":
        return IndexFieldTerm(self._leaf, self.field, term)


class IndexFieldTerm:
    def __init__(self, leaf: SegmentSnapshot, field: str, term: str):
        self._leaf = leaf
        self.field = field
        self.term = term
        rec = leaf.term_record(field, term)
        self.df = rec.doc_freq if rec else 0  # document frequency
        self.ttf = rec.total_tf if rec else 0  # total term frequency
        self._postings = None

    def _load(self):
        if self._postings is None:
            p = self._leaf.read_postings(
                self.field, self.term,
                with_positions=True, with_offsets=True, with_payloads=True,
            )
            if p is None:
                z = np.zeros(0, np.int64)
                self._postings = (z, z, z, None, None)
            else:
                self._postings = p
        return self._postings

    def tf(self, doc: int) -> int:
        docs, freqs, *_ = self._load()
        i = np.searchsorted(docs, doc)
        return int(freqs[i]) if i < len(docs) and docs[i] == doc else 0

    def positions(self, doc: int) -> list[TermPosition]:
        docs, freqs, pos, offs, pays = self._load()
        i = np.searchsorted(docs, doc)
        if i >= len(docs) or docs[i] != doc:
            return []
        start = int(freqs[:i].sum())
        end = start + int(freqs[i])
        out = [TermPosition(int(p)) for p in pos[start:end]]
        # offsets: prefer the inline postings plane; fall back to term vectors
        if offs is not None:
            for j, tp in enumerate(out):
                s, e = int(offs[0][start + j]), int(offs[1][start + j])
                if s >= 0:
                    tp.start_offset, tp.end_offset = s, e
        else:
            tv = self._leaf.term_vector(doc, self.field)
            if tv and self.term in tv:
                by_pos = {p: (s, e) for p, s, e in tv[self.term]}
                for tp in out:
                    if tp.position in by_pos:
                        tp.start_offset, tp.end_offset = by_pos[tp.position]
        if pays is not None:
            for j, tp in enumerate(out):
                tp.payload = pays[start + j]
        return out


class LeafIndexLookup:
    """`lookup[field][term].tf(doc)` etc. over one segment."""

    def __init__(self, leaf: SegmentSnapshot):
        self._leaf = leaf

    def __getitem__(self, field: str) -> IndexField:
        return IndexField(self._leaf, field)

    def field_statistics(self, field: str):
        return self._leaf.field_stats(field)

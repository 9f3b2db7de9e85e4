"""Doc-range splitting of one packed segment — the hot-leaf TP analog.

Segment-granularity sharding (parallel/sharded.py) cannot parallelize a
single huge segment: a force-merged index lands whole on shard 0 while
the other devices idle (SURVEY §2.7: "splitting one huge posting list
across devices — support via block-range sharding"; the reference's
parallel search has the same per-leaf limit, searcher.rs:419-470 — this
goes beyond it). A split produces N search-only PackedSegment views over
contiguous doc ranges:

- blocks fully inside a range are REUSED: the sub-view's block table
  points at the original packed words; only blk_base / blk_first_doc /
  blk_last_doc are rebased by -lo (decode then yields range-local ids);
- a block straddling a cut (at most 2 per term per range) is decoded on
  the host and re-packed as partial FOR blocks appended to a small
  extension of the data array — every sub-view block then lies fully
  inside its range, so NO executor masking is needed and per-term doc
  freqs stay exact (sum of blk_count);
- positions are shared whole: blk_pos_base keeps indexing the original
  per-term streams, so the device phrase pipelines work unchanged;
- norms / live / stored / DV families / points slice by doc range.

Search-only: occurrence-aligned planes (host read_postings positions,
offsets, payloads) assume a term's stream starts at its pos_start, which
a leading partial block breaks — those accessors raise on split views.
Memory note: each sub-view references the FULL data/positions arrays
(plus a small extension); splitting parallelizes compute, not capacity.
"""

from __future__ import annotations

import numpy as np

from rucene_tpu_torch.codec.postings import (
    BLOCK_SIZE,
    PackedField,
    PackedSegment,
    _bits_for,
    _scatter_pack,
)
from rucene_tpu_torch.index.memory import FieldStats
from rucene_tpu_torch.util.packing import (
    EF_TAG,
    EF_UNARY_WORDS,
    decode_ef_doc_plane,
    doc_plane_words_np,
    unpack_block,
)


def _decode_block(p: PackedSegment, bi: int) -> tuple[np.ndarray, np.ndarray]:
    """(absolute doc ids, freqs) of one block, host-side."""
    cnt = int(p.blk_count[bi])
    off = int(p.blk_off[bi])
    dbits = int(p.blk_doc_bits[bi])
    fbits = int(p.blk_freq_bits[bi])
    if dbits >= EF_TAG:
        dwlen = 4 * (dbits - EF_TAG) + EF_UNARY_WORDS
        v = decode_ef_doc_plane(p.data[off : off + dwlen], dbits - EF_TAG)
        docs = int(p.blk_base[bi]) + v[:cnt].astype(np.int64)
    else:
        dwlen = 4 * dbits
        dwords = p.data[off : off + dwlen].astype(np.uint64)
        deltas = unpack_block(dwords, dbits)[:cnt].astype(np.int64)
        docs = int(p.blk_base[bi]) + np.cumsum(deltas)
    fwords = p.data[off + dwlen : off + dwlen + 4 * fbits].astype(np.uint64)
    freqs = unpack_block(fwords, fbits)[:cnt].astype(np.int64)
    return docs, freqs


class _PartialBlocks:
    """Collects partial-block values; packs them all at once at the end."""

    def __init__(self):
        self.dvals: list[np.ndarray] = []
        self.fvals: list[np.ndarray] = []
        self.nvals: list[np.ndarray] = []
        self.meta: list[tuple] = []  # (base, count, max_freq, first, last, pos_base)

    def add(self, local_docs, freqs, norm_bytes, base, pos_base) -> int:
        c = len(local_docs)
        prev = np.concatenate([[base], local_docs[:-1]])
        deltas = local_docs - prev
        row = np.zeros(BLOCK_SIZE, np.int32)
        row[:c] = deltas
        frow = np.zeros(BLOCK_SIZE, np.int32)
        frow[:c] = freqs
        nrow = np.zeros(BLOCK_SIZE, np.int32)
        nrow[:c] = norm_bytes
        self.dvals.append(row)
        self.fvals.append(frow)
        self.nvals.append(nrow)
        self.meta.append(
            (base, c, int(freqs.max()), int(local_docs[0]), int(local_docs[-1]), pos_base)
        )
        return len(self.meta) - 1

    def pack(self, ext_word_base: int):
        """-> (ext_words u32[], blk meta arrays...) with blk_off already
        offset by ext_word_base."""
        n = len(self.meta)
        if n == 0:
            z = np.zeros(0, np.int64)
            return np.zeros(0, np.uint32), z, z, z, z, z, z, z, z, z
        dvals = np.stack(self.dvals)
        fvals = np.stack(self.fvals)
        nvals = np.stack(self.nvals)
        dbits = _bits_for(dvals.max(axis=1)).astype(np.int32)
        fbits = _bits_for(fvals.max(axis=1)).astype(np.int32)
        counts = np.asarray([m[1] for m in self.meta], np.int64)
        norm_words = (counts * 8 + 31) // 32
        dplane = doc_plane_words_np(dbits).astype(np.int64)
        words_per = dplane + 4 * fbits.astype(np.int64) + norm_words
        off = np.concatenate([[0], np.cumsum(words_per)])
        total = int(off[-1])
        out = np.zeros(total + 1, np.int64)
        _scatter_pack(out, dvals, dbits, off[:-1])
        _scatter_pack(out, fvals, fbits, off[:-1] + dplane)
        _scatter_pack(
            out, nvals, np.full(n, 8, np.int32),
            off[:-1] + dplane + 4 * fbits.astype(np.int64), n_words=norm_words,
        )
        return (
            out.astype(np.uint32),
            off[:-1] + ext_word_base,
            dbits.astype(np.int64),
            fbits.astype(np.int64),
            np.asarray([m[0] for m in self.meta], np.int64),  # base
            counts,
            np.asarray([m[2] for m in self.meta], np.int64),  # max freq
            np.asarray([m[3] for m in self.meta], np.int64),  # first
            np.asarray([m[4] for m in self.meta], np.int64),  # last
            np.asarray([m[5] for m in self.meta], np.int64),  # pos base
        )


def _slice_dv(packed: PackedSegment, lo: int, hi: int) -> dict:
    out = {}
    out["numeric_dv"] = {
        f: (v[0][lo:hi], v[1][lo:hi]) for f, v in (packed.numeric_dv or {}).items()
    }
    out["binary_dv"] = (
        {f: v[lo:hi] for f, v in packed.binary_dv.items()}
        if packed.binary_dv
        else None
    )
    out["sorted_dv"] = (
        {f: (v[0], v[1][lo:hi]) for f, v in packed.sorted_dv.items()}
        if packed.sorted_dv
        else None
    )
    sn = {}
    for f, (flat, offs) in (packed.sorted_numeric_dv or {}).items():
        o = offs[lo : hi + 1]
        sn[f] = (flat[o[0] : o[-1]], o - o[0])
    out["sorted_numeric_dv"] = sn or None
    ss = {}
    for f, v in (packed.sorted_set_dv or {}).items():
        vals, flat, offs = v
        o = offs[lo : hi + 1]
        ss[f] = (vals, flat[o[0] : o[-1]], o - o[0])
    out["sorted_set_dv"] = ss or None
    pts = {}
    for f, (vals, docs) in (packed.points or {}).items():
        sel = (docs >= lo) & (docs < hi)
        pts[f] = (vals[sel], docs[sel] - lo)
    out["points"] = pts
    return out


def split_packed_segment(
    packed: PackedSegment, n_parts: int
) -> list[PackedSegment]:
    """Split into n_parts doc-contiguous search-only sub-segments."""
    md = packed.max_doc
    if n_parts <= 1 or md < n_parts:
        return [packed]
    bounds = np.linspace(0, md, n_parts + 1).astype(np.int64)
    return [
        _slice_packed(packed, int(bounds[i]), int(bounds[i + 1]))
        for i in range(n_parts)
    ]


def _slice_packed(p: PackedSegment, lo: int, hi: int) -> PackedSegment:
    bf = p.blk_first_doc.astype(np.int64)
    bl = p.blk_last_doc.astype(np.int64)

    new_fields: dict[str, PackedField] = {}
    partials = _PartialBlocks()
    # per NEW block: source old-block id, or -(partial_row)-2 for partials
    src_rows: list[np.ndarray] = []
    # per field/term bookkeeping
    per_field_starts: dict[str, np.ndarray] = {}
    per_field_counts: dict[str, np.ndarray] = {}
    per_field_df: dict[str, np.ndarray] = {}
    nb_new = 0

    for name, pf in p.fields.items():
        t_n = len(pf.terms)
        starts = np.zeros(t_n, np.int64)
        counts = np.zeros(t_n, np.int64)
        dfs = np.zeros(t_n, np.int64)
        narr = p.norms.get(name)
        for ti in range(t_n):
            s = int(pf.block_start[ti])
            e = s + int(pf.block_count[ti])
            if e == s:
                starts[ti] = nb_new
                continue
            # intersecting old blocks of this term
            isect = np.flatnonzero((bf[s:e] < hi) & (bl[s:e] >= lo)) + s
            starts[ti] = nb_new
            if len(isect) == 0:
                continue
            rows = []
            for bi in isect:
                bi = int(bi)
                if bf[bi] >= lo and bl[bi] < hi:
                    rows.append(bi)  # wholly inside: reuse
                    continue
                docs, freqs = _decode_block(p, bi)
                sel = (docs >= lo) & (docs < hi)
                c = int(sel.sum())
                if c == 0:
                    continue
                local = docs[sel] - lo
                # base: previous in-range local doc, or -1 at range head
                k0 = int(np.argmax(sel))  # first selected index
                if k0 == 0:
                    # preceding doc is in an earlier block (or none)
                    base = (bl[bi - 1] - lo) if bi > int(isect[0]) else -1
                    if rows and rows[-1] >= 0:
                        base = bl[rows[-1]] - lo
                    elif rows:
                        base = partials.meta[-rows[-1] - 2][4]
                    else:
                        base = -1
                else:
                    base = int(docs[k0 - 1]) - lo  # same block, below lo
                    if base < -1:
                        base = -1
                    # deltas must stay positive: base < local[0] always
                    base = min(base, int(local[0]) - 1)
                    if k0 > 0:
                        # previous doc is below lo: decode gives exact gap,
                        # but any base < local[0] is valid for a FOR block
                        base = int(local[0]) - 1 if base < 0 else base
                pos_base = int(p.blk_pos_base[bi]) + int(freqs[:k0].sum())
                nb_bytes = (
                    narr[docs[sel]].astype(np.int32)
                    if narr is not None
                    else np.zeros(c, np.int32)
                )
                pr = partials.add(
                    local, freqs[sel].astype(np.int64), nb_bytes,
                    int(base), pos_base,
                )
                rows.append(-pr - 2)
            if rows:
                src_rows.append(np.asarray(rows, np.int64))
                counts[ti] = len(rows)
                # df = sum of counts (reused blocks keep blk_count; partial
                # counts are in partials.meta)
                dfs[ti] = sum(
                    int(p.blk_count[r]) if r >= 0 else partials.meta[-r - 2][1]
                    for r in rows
                )
                nb_new += len(rows)
        per_field_starts[name] = starts
        per_field_counts[name] = counts
        per_field_df[name] = dfs

    src = (
        np.concatenate(src_rows) if src_rows else np.zeros(0, np.int64)
    )
    ext_words, p_off, p_db, p_fb, p_base, p_cnt, p_mf, p_first, p_last, p_pb = (
        partials.pack(len(p.data))
    )

    def gather(old_arr, partial_arr, rebase=0):
        out = np.empty(len(src), np.int64)
        reuse = src >= 0
        out[reuse] = old_arr[src[reuse]].astype(np.int64) + rebase
        out[~reuse] = partial_arr[(-src[~reuse] - 2)]
        return out

    blk_off = gather(p.blk_off, p_off)
    blk_doc_bits = gather(p.blk_doc_bits, p_db)
    blk_freq_bits = gather(p.blk_freq_bits, p_fb)
    blk_base = gather(p.blk_base, p_base, rebase=-lo)
    blk_count = gather(p.blk_count, p_cnt)
    blk_max_freq = gather(p.blk_max_freq, p_mf)
    blk_first = gather(p.blk_first_doc, p_first, rebase=-lo)
    blk_last = gather(p.blk_last_doc, p_last, rebase=-lo)
    blk_pos_base = gather(p.blk_pos_base, p_pb)

    for name, pf in p.fields.items():
        new_fields[name] = PackedField(
            name=name,
            field_id=pf.field_id,
            terms=pf.terms,
            term_ord=pf.term_ord,
            doc_freq=per_field_df[name],
            total_tf=np.zeros(len(pf.terms), np.int64),  # see module doc
            block_start=per_field_starts[name].astype(np.int32),
            block_count=per_field_counts[name].astype(np.int32),
            pos_start=pf.pos_start,
            pos_width=pf.pos_width,
            pos_word_start=pf.pos_word_start,
        )

    # field stats: doc_count / sum_ttf are GLOBAL inputs; carry them on the
    # first slice only so any cross-slice sum stays exact
    if lo == 0:
        stats = p.stats
    else:
        stats = {
            f: FieldStats(doc_count=0, sum_total_term_freq=0)
            for f in p.stats
        }

    dv = _slice_dv(p, lo, hi)
    sub = PackedSegment(
        max_doc=hi - lo,
        field_infos=p.field_infos,
        fields=new_fields,
        stats=stats,
        blk_off=blk_off.astype(np.int32),
        blk_doc_bits=blk_doc_bits.astype(np.int32),
        blk_freq_bits=blk_freq_bits.astype(np.int32),
        blk_base=blk_base.astype(np.int32),
        blk_count=blk_count.astype(np.int32),
        blk_max_freq=blk_max_freq.astype(np.int32),
        blk_first_doc=blk_first.astype(np.int32),
        blk_last_doc=blk_last.astype(np.int32),
        blk_pos_base=blk_pos_base.astype(np.int32),
        data=(
            np.concatenate([p.data, ext_words]) if len(ext_words) else p.data
        ),
        positions=p.positions,
        norms={f: v[lo:hi] for f, v in p.norms.items()},
        stored=p.stored[lo:hi] if p.stored else p.stored,
        numeric_dv=dv["numeric_dv"],
        points=dv["points"],
        term_vectors=(
            p.term_vectors[lo:hi] if p.term_vectors else p.term_vectors
        ),
        binary_dv=dv["binary_dv"],
        sorted_dv=dv["sorted_dv"],
        sorted_numeric_dv=dv["sorted_numeric_dv"],
        sorted_set_dv=dv["sorted_set_dv"],
        off_starts=None,  # occurrence-aligned planes don't survive slicing
        off_ends=None,
        pay=None,
    )
    sub.is_split_view = True  # type: ignore[attr-defined]
    return sub

"""Whole-segment columnar postings decode (host, vectorized numpy).

Merging re-reads every posting of every term (reference SegmentMerger
drives codec readers the same way, segment_merger.rs:36). Doing that via
per-term block loops is Python-bound; here all blocks of a segment decode
in a handful of vectorized passes — blocks grouped by bit width so each
group unpacks as one strided numpy operation.
"""

from __future__ import annotations

import numpy as np

from rucene_tpu_torch.codec.postings import PackedSegment
from rucene_tpu_torch.util.packing import (
    BLOCK_SIZE,
    EF_TAG,
    EF_UNARY_WORDS,
    doc_plane_words_np,
)


def read_all_postings(packed: PackedSegment) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode every block: returns (docs i64[NB,128], freqs i64[NB,128],
    valid bool[NB,128]) in block order (term-major)."""
    nb = packed.num_blocks
    docs = np.zeros((nb, BLOCK_SIZE), np.int64)
    freqs = np.zeros((nb, BLOCK_SIZE), np.int64)
    lane = np.arange(BLOCK_SIZE)
    valid = lane[None, :] < packed.blk_count[:, None]
    if nb == 0:
        return docs, freqs, valid

    data = packed.data.astype(np.uint64)
    padded = np.concatenate([data, np.zeros(1, np.uint64)])

    def unpack_group(offs: np.ndarray, bits: int) -> np.ndarray:
        """Unpack len(offs) blocks at one fixed width: [G, 128] uint64."""
        bitpos = lane[None, :] * bits  # [1,128]
        widx = offs[:, None] + (bitpos >> 5)
        shift = (bitpos & 31).astype(np.uint64)
        lo = padded[widx] >> shift
        hi = np.where(
            shift == 0, np.uint64(0), padded[np.minimum(widx + 1, len(padded) - 1)] << (np.uint64(32) - shift)
        )
        mask = np.uint64(0xFFFFFFFF) if bits == 32 else (np.uint64(1) << np.uint64(bits)) - np.uint64(1)
        return (lo | hi) & mask

    blk_off = packed.blk_off.astype(np.int64)
    for bits in np.unique(packed.blk_doc_bits):
        sel = np.flatnonzero(packed.blk_doc_bits == bits)
        if bits >= EF_TAG:
            # Elias-Fano plane: low bits FOR-packed, high bits unary
            l = int(bits) - EF_TAG
            if l:
                low = unpack_group(blk_off[sel], l).astype(np.int64)
            else:
                low = np.zeros((len(sel), BLOCK_SIZE), np.int64)
            uw = padded[
                blk_off[sel][:, None] + 4 * l + np.arange(EF_UNARY_WORDS)
            ].astype(np.uint32)
            b384 = (
                (uw[:, :, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
            ).reshape(len(sel), -1)
            cum = np.cumsum(b384, axis=1)  # rank 0..128
            cnt = np.zeros((len(sel), BLOCK_SIZE + 1), np.int64)
            np.add.at(cnt, (np.arange(len(sel))[:, None], cum), 1)
            select = np.cumsum(cnt, axis=1)[:, :BLOCK_SIZE]
            hi = select - np.arange(BLOCK_SIZE)[None, :]
            docs[sel] = packed.blk_base[sel, None] + ((hi << l) + low)
        else:
            deltas = unpack_group(blk_off[sel], int(bits)).astype(np.int64)
            docs[sel] = packed.blk_base[sel, None] + np.cumsum(deltas, axis=1)
    dplane = doc_plane_words_np(packed.blk_doc_bits).astype(np.int64)
    for bits in np.unique(packed.blk_freq_bits):
        sel = np.flatnonzero(packed.blk_freq_bits == bits)
        offs = blk_off[sel] + dplane[sel]
        freqs[sel] = unpack_group(offs, int(bits)).astype(np.int64)

    docs[~valid] = -1
    freqs[~valid] = 0
    return docs, freqs, valid


def segment_postings_columnar(packed: PackedSegment):
    """Flatten the whole segment to columnar postings:
    (field_name[] aligned with gterm ranges is the caller's business)
    returns per-global-term CSR: (post_start i64[T+1], docs i64[P],
    freqs i64[P]) in global term order."""
    docs_b, freqs_b, valid = read_all_postings(packed)
    # blocks are laid out term-major; valid lanes concatenate to postings
    flat_docs = docs_b[valid]
    flat_freqs = freqs_b[valid]
    # per-term extents from doc_freq
    t_total = sum(len(pf.terms) for pf in packed.fields.values())
    df = np.zeros(t_total, np.int64)
    pos = 0
    for name in sorted(packed.fields, key=lambda n: packed.fields[n].field_id):
        pf = packed.fields[name]
        df[pos : pos + len(pf.terms)] = pf.doc_freq
        pos += len(pf.terms)
    post_start = np.concatenate([[0], np.cumsum(df)])
    return post_start, flat_docs, flat_freqs


def decode_all_positions(packed: PackedSegment, flat_freqs: np.ndarray) -> np.ndarray:
    """Decode the whole segment's positions back to absolute values in global
    occurrence order (merge path). flat_freqs = per-posting freqs in global
    term order (from segment_postings_columnar) — they delimit the per-doc
    delta runs. Vectorized: occurrences grouped by per-term width."""
    # per-term width/word-start/ttf in global term order
    widths, wstarts, ttfs, pstarts = [], [], [], []
    for name in sorted(packed.fields, key=lambda n: packed.fields[n].field_id):
        pf = packed.fields[name]
        widths.append(pf.pos_width.astype(np.int64))
        wstarts.append(pf.pos_word_start.astype(np.int64))
        ttfs.append(pf.total_tf.astype(np.int64))
        pstarts.append(pf.pos_start.astype(np.int64))
    if not widths:
        return np.zeros(0, np.int64)
    width = np.concatenate(widths)
    wstart = np.concatenate(wstarts)
    ttf = np.concatenate(ttfs)
    pstart = np.concatenate(pstarts)
    total = int(ttf.sum())
    if total == 0:
        return np.zeros(0, np.int64)

    occ_term = np.repeat(np.arange(len(ttf)), ttf)
    within = np.arange(total) - pstart[occ_term]
    deltas = np.zeros(total, np.int64)
    padded = np.concatenate([packed.positions.astype(np.uint64), np.zeros(1, np.uint64)])
    for wb in np.unique(width[ttf > 0]):
        sel = np.flatnonzero(width[occ_term] == wb)
        bitpos = within[sel] * int(wb)
        widx = wstart[occ_term[sel]] + (bitpos >> 5)
        shift = (bitpos & 31).astype(np.uint64)
        lo = padded[widx] >> shift
        hi = np.where(
            shift == 0,
            np.uint64(0),
            padded[np.minimum(widx + 1, len(padded) - 1)] << (np.uint64(32) - shift),
        )
        mask = np.uint64(0xFFFFFFFF) if wb == 32 else (np.uint64(1) << np.uint64(wb)) - np.uint64(1)
        deltas[sel] = ((lo | hi) & mask).astype(np.int64)

    # deltas -> absolute per doc run
    c = np.cumsum(deltas)
    run_start = np.concatenate([[0], np.cumsum(flat_freqs)])[:-1].astype(np.int64)
    base = c[run_start] - deltas[run_start]
    return c - np.repeat(base, flat_freqs)

"""Device-side phrase execution, exact and sloppy (counterpart of
rucene_tpu/search/phrase_device.py).

reference: rucene src/core/search/scorer/phrase_scorer.rs:122
(ExactPhraseScorer): conjunction of the phrase terms, then per-doc
verification that positions line up consecutively; scoring is BM25 with
freq = number of phrase occurrences. Sloppy (phrase_scorer.rs:442): an
ordered greedy chain (first slot-j position strictly after the previous
slot's pick), match iff total gap <= slop, freq = sum of 1/(distance+1)
per slot-0 occurrence.

One call per batch of candidate rows, in torch ops on the segment's device:

  1. the lanes of every (row, slot, block) work item (slot = the term's
     place in the phrase), each with its offset into the term's position
     stream (blk_pos_base + running freq sum). A decoded segment gathers
     its planes' rows; a packed one decodes through K1
     (ops/cuda_decode.decode_blocks);
  2. lanes sorted by one int64 key ``row << 34 | doc << 3 | slot`` (stable
     torch.sort, payloads gathered by the permutation): a (row, doc) group
     is a candidate iff it has one lane per slot — the conjunction;
  3. candidates scattered into [C, nmax] tables; the parking row
     ``cand_cap + 1`` takes padding lanes and is never read (several lanes
     may land there, and torch leaves the winner of such a write undefined
     on CUDA);
  4. each slot's position window unpacked in int64 (``& 0xFFFFFFFF``),
     then verified: exact rows count slot-0 positions p with p + j in slot
     j; sloppy rows run the greedy chain;
  5. BM25 with tf = phrase freq, then the exact top-k in two stable sorts:
     the distinct (score desc, doc asc) keys of ops/topk, then the row.
     9 + 32 + 31 bits do not fit one int64 key.

Rows with more candidates than cand_cap (all rows of the call) or a
candidate occurrence count above fmax are flagged and rerouted by the
caller, so results stay exact. The reference's static programs (slop
bucket, has_ef, pow2 padding) go: ``nmax``, ``fwin`` and ``slop_max`` are
the batch's own sizes, which give the same results as the reference's
static ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rucene_tpu_torch.ops.phrase_plane import unpack_positions, work_lanes
from rucene_tpu_torch.ops.topk import score_doc_keys

NMAX = 8  # max phrase length (terms); longer -> host
SLOP_CAP = 32  # max device slop; wider -> host
DOC_PAD = 2**31 - 1
_BIG = 2**30


class PhraseBatch(NamedTuple):
    wi_block: torch.Tensor  # i32[W] block id
    wi_row: torch.Tensor  # i32[W] query row
    wi_slot: torch.Tensor  # i32[W] term position within the phrase
    wi_valid: torch.Tensor  # bool[W]
    n_terms: torch.Tensor  # i32[B]
    weight: torch.Tensor  # f32[B] = boost * sum(idf) * (k1+1)
    fid: torch.Tensor  # i32[B] field row (cache/norms)
    cache: torch.Tensor  # f32[F,256]
    # position-stream coordinates per work item (a candidate's lane carries
    # its own stream's offsets)
    wi_pos_width: torch.Tensor  # i32[W] packed position-delta width
    wi_pos_start: torch.Tensor  # i32[W] word offset of the term's stream
    slop: torch.Tensor  # i32[B] per-row slop (0 = exact)


def _shift_in(x: torch.Tensor, first) -> torch.Tensor:
    """x shifted one place right along dim 0, ``first`` in front."""
    return torch.cat([x.new_full((1,), first), x[:-1]])


def execute_phrases_impl(
    dev, pb: PhraseBatch, k: int, cand_cap: int, fmax: int,
    slop_max: int = 0, nmax: int = NMAX, fwin: int | None = None,
):
    """Returns (scores f32[B,k], docs i32[B,k], hits i32[B], overflow bool[B]).

    slop_max: the batch's largest slop (0: every row exact). nmax: its
    longest phrase. fwin: positions read per (candidate, slot), fmax or
    less when the caller knows every freq of the work's blocks is at most
    fwin; any of these at or above the batch's own values gives the same
    results."""
    b = pb.n_terms.shape[0]
    md = dev.max_doc_padded
    d = dev.device
    fwin = fmax if fwin is None else fwin

    blk = pb.wi_block.long()
    cnt = torch.where(pb.wi_valid, dev.blk_count[blk], 0)
    docs, freqs, valid = work_lanes(dev, blk, cnt)  # [W, 128]
    pos_off = dev.blk_pos_base[blk].long()[:, None] + (freqs.cumsum(1) - freqs)

    # ---- flatten lanes and group by (row, doc) ----
    f_doc = torch.where(valid, docs, DOC_PAD).reshape(-1).long()
    f_row = pb.wi_row.long()[:, None].expand_as(docs).reshape(-1)
    f_slot = pb.wi_slot.long()[:, None].expand_as(docs).reshape(-1)
    f_ok = valid.reshape(-1) & dev.live[f_doc.clamp(0, md - 1)] & (f_doc < md)
    key_row = torch.where(f_ok, f_row, b)
    key_doc = torch.where(f_ok, f_doc, DOC_PAD)
    order = torch.sort((key_row << 34) | (key_doc << 3) | f_slot, stable=True).indices
    s_row, s_doc, s_slot = key_row[order], key_doc[order], f_slot[order]
    s_pos = pos_off.reshape(-1)[order]
    s_freq = freqs.reshape(-1)[order]
    s_item = order // docs.shape[1]
    s_pw = pb.wi_pos_width.long()[s_item]
    s_ws = pb.wi_pos_start.long()[s_item]

    # group extents: a candidate group has exactly n_terms lanes, slots 0..n-1
    real = s_row < b
    is_start = real & ((s_row != _shift_in(s_row, -1)) | (s_doc != _shift_in(s_doc, -1)))
    park = cand_cap + 1
    gid = torch.where(real, is_start.long().cumsum(0) - 1, park).clamp(0, park)
    grp_count = torch.zeros(cand_cap + 2, dtype=torch.int64, device=d)
    grp_count.index_add_(0, gid, real.long())
    start_gid = torch.where(is_start, gid, park)
    grp_row = torch.full((cand_cap + 2,), b, dtype=torch.int64, device=d)
    grp_row[start_gid] = s_row
    grp_doc = torch.full((cand_cap + 2,), DOC_PAD, dtype=torch.int64, device=d)
    grp_doc[start_gid] = s_doc
    slot_c = s_slot.clamp(0, nmax - 1)

    def table(src, fill):
        t = torch.full((cand_cap + 2, nmax), fill, dtype=torch.int64, device=d)
        t[gid, slot_c] = src
        return t[:cand_cap]

    tbl_pos, tbl_freq = table(s_pos, 0), table(s_freq, 0)
    tbl_pw, tbl_ws = table(s_pw, 1), table(s_ws, 0)

    c_row = grp_row[:cand_cap]
    c_doc = grp_doc[:cand_cap]
    safe_row = c_row.clamp(0, b - 1)
    n_of_row = pb.n_terms.long()[safe_row]  # [C]
    c_ok = (c_row < b) & (grp_count[:cand_cap] == n_of_row)

    # overflow: too many groups, or a candidate occurrence count above fmax
    too_many = is_start.sum() > cand_cap
    freq_over = torch.zeros(b + 1, dtype=torch.bool, device=d)
    freq_over[torch.where(c_ok & (tbl_freq.amax(1) > fmax), c_row, b)] = True
    overflow = freq_over[:b] | too_many

    # ---- position windows: unpack fixed-width deltas + cumsum ----
    fidx = torch.arange(fwin, dtype=torch.int64, device=d)
    occ = tbl_pos[:, :, None] + fidx  # [C, nmax, fwin]
    pvalid = fidx < tbl_freq[:, :, None]
    deltas = unpack_positions(dev.positions, tbl_ws[:, :, None], tbl_pw[:, :, None], occ)
    del occ
    pwin = torch.where(pvalid, torch.where(pvalid, deltas, 0).cumsum(-1), -_BIG)
    del deltas

    base_pos = pwin[:, 0, :]  # [C, fwin] slot-0 positions
    base_valid = pvalid[:, 0, :]
    if slop_max == 0:
        # exact: slot j must contain p0 + j (ExactPhraseScorer); pf = matches
        match_f0 = base_valid
        for j in range(1, nmax):
            need = (j < n_of_row)[:, None]
            hit = (pwin[:, j, None, :] == (base_pos[:, :, None] + j)).any(-1)
            match_f0 = match_f0 & (hit | ~need)
        pf = (match_f0 & base_valid).sum(1).to(torch.float32)  # [C]
    else:
        # sloppy: greedy ordered chain; sloppy freq 1/(distance+1) summed
        # as an ascending-distance histogram, in the reference's order
        prev = base_pos
        found = base_valid
        for j in range(1, nmax):
            need = (j < n_of_row)[:, None]
            cand = pwin[:, j, None, :]
            gt = (cand > prev[:, :, None]) & pvalid[:, j, None, :]
            nxt = torch.where(gt, cand, _BIG).amin(-1)  # [C, fwin]
            found = found & ((nxt < _BIG) | ~need)
            prev = torch.where(need, nxt.clamp(max=_BIG), prev)
        distance = prev - base_pos - (n_of_row[:, None] - 1)
        row_slop = pb.slop.long()[safe_row][:, None]
        matched_f0 = found & base_valid & (distance <= row_slop)
        pf = torch.zeros(base_pos.shape[0], dtype=torch.float32, device=d)
        for dd in range(slop_max + 1):
            n_at = (matched_f0 & (distance == dd)).sum(1).to(torch.float32)
            pf = pf + n_at * np.float32(1.0 / (dd + 1.0))

    # ---- BM25 with tf = phrase_freq ----
    safe_doc = c_doc.clamp(0, md - 1)
    fid_r = pb.fid.long()[safe_row]
    norm_b = dev.norms.reshape(-1)[fid_r * md + safe_doc].long()
    cval = pb.cache.reshape(-1)[fid_r * 256 + norm_b]
    score = pb.weight[safe_row] * pf / (pf + cval)
    matched = c_ok & (pf > 0)

    # ---- exact per-row top-k over candidates: (score desc, doc asc),
    # then a stable pass by row ----
    keys = score_doc_keys(
        torch.where(matched, score, -torch.inf), torch.where(matched, c_doc, DOC_PAD)
    )
    by_score = torch.sort(keys, descending=True, stable=True).indices
    key_r = torch.where(matched, c_row, b)[by_score]
    by_row = torch.sort(key_r, stable=True).indices
    o = by_score[by_row]
    o_row = key_r[by_row]
    fresh = o_row < b  # docs unique per row already
    fint = fresh.long()
    c_excl = fint.cumsum(0) - fint
    idx = torch.arange(cand_cap, device=d)
    row_start = torch.cummax(torch.where(o_row != _shift_in(o_row, -1), idx, 0), 0).values
    rank = c_excl - c_excl[row_start]
    sel = fresh & (rank < k)
    at = (torch.where(sel, o_row, b), torch.where(sel, rank, 0))  # parking row b
    out_scores = torch.full((b + 1, k), -torch.inf, dtype=torch.float32, device=d)
    out_scores[at] = score[o]
    out_docs = torch.full((b + 1, k), DOC_PAD, dtype=torch.int32, device=d)
    out_docs[at] = c_doc[o].to(torch.int32)
    hits = torch.zeros(b + 1, dtype=torch.int64, device=d)
    hits.index_add_(0, torch.where(fresh, o_row, b), fint)
    return out_scores[:b], out_docs[:b], hits[:b].to(torch.int32), overflow

"""Dense position-plane phrase matching (counterpart of
rucene_tpu/ops/phrase_plane.py): heavy exact phrases, whose candidate
tables (search/phrase_device.py) would not fit.

Each term becomes a bit plane over the whole doc space, built once per
(leaf, field, term) and cached by the searcher (search/phrase_path.py):

    plane[doc] = 32 * words bits, bit p set iff the term occurs at position p

An n-term exact phrase is then a shifted AND and a popcount per doc:

    pf[doc] = popcount( plane_0 & (plane_1 >> 1) & ... & (plane_n >> n-1) )

followed by BM25 and the dense top-k. Docs with more than FMAX
occurrences of a term, or a position past the plane, are flagged in the
term's overflow column; a row that meets one goes whole to the scalar
engine, so results stay exact.

torch has no unsigned 32-bit type worth trusting on CUDA, so the plane is
int32 holding the u32 bits: the build's scatter adds distinct powers of
two with ``index_add_`` (a term's (doc, position) bits are distinct, so the
sum is the OR, bit 31 included as -2^31; integer atomics keep it
deterministic), ``_shift_right`` masks the sign fill of ``>>``, and the
popcount is a SWAR count on int64 lanes (two plane words a lane, the sign
bit counted apart so that no step overflows). The position stream is
unpacked in int64 with ``& 0xFFFFFFFF`` (``unpack_positions``).

On a packed leaf a build chunk's docs and freqs come from the decode
kernel (ops/cuda_decode.decode_blocks, K1) over the chunk's gathered block
tables; on a decoded leaf they are row gathers of the resident planes
(``work_lanes``). The reference's ``lax.scan`` over BUILD_CHUNK items is a
plain chunk loop. Left out: ``MAX_BUILD_ITEMS`` and its slicing in the
caller (a TPU worker fault), and the pow2 work padding.

``build_position_planes`` builds many terms' planes of one leaf at once:
on a card one work list over all their blocks, one ``work_lanes`` call and
one launch of csrc/phrase_plane.cu (counter ``kernel.build_position_planes``);
on the CPU its twin, ``build_position_plane`` a term.

``phrase_plane_search`` is the reference's single-row function, a one-row
call of ``phrase_plane_search_many``.

Unordered span-near rows (``span_unordered_plane_search_many``) use the
same planes: per window width, an AND of each term's smeared plane with
witness bits at both ends, popcounts weighted by the sloppy factor.
"""

from __future__ import annotations

import numpy as np
import torch

from rucene_tpu_torch.ops import cuda_decode
from rucene_tpu_torch.ops.decode import INVALID_DOC
from rucene_tpu_torch.ops.topk import DOC_PAD, topk_score_doc
from rucene_tpu_torch.util.metrics import METRICS
from rucene_tpu_torch.util.packing import BLOCK_SIZE

PMAX = 128  # positions per doc covered by a full-width plane (4 words)
WORDS = PMAX // 32
# occurrences decoded per (term, doc): a doc with more only sets the
# overflow column
FMAX = 64
# work items per build step: bounds the [C, 128, fwin] int64 temporaries
# (268 MB each at fwin = FMAX)
BUILD_CHUNK = 4096
LAUNCH_COUNTER = "kernel.build_position_planes"
# work items per kernel launch: bounds its lanes (12 bytes each, 50 MB)
LAUNCH_ITEMS = 32768

_U32 = 0xFFFFFFFF
_SIGN_OFF = 0x7FFFFFFFFFFFFFFF
_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def work_lanes(dev, blk: torch.Tensor, count: torch.Tensor):
    """Lanes of the blocks ``blk`` (int64[W]) with ``count`` (int[W], 0
    for an inert item): (docs i32[W, 128] with INVALID_DOC past count,
    freqs i64[W, 128] with 0 past count, valid bool[W, 128]). A decoded
    segment gathers its planes' rows; a packed one decodes the blocks
    through K1 (its twin for CPU tensors)."""
    valid = torch.arange(BLOCK_SIZE, device=blk.device) < count[:, None]
    if dev.docs_dec is not None:
        docs = torch.where(valid, dev.docs_dec[blk], INVALID_DOC)
        freqs = torch.where(valid, dev.freqs_dec[blk].long(), 0)
        return docs, freqs, valid
    docs, freqs, _norms = cuda_decode.decode_blocks(
        dev.data, dev.blk_off[blk], dev.blk_doc_bits[blk], dev.blk_freq_bits[blk],
        dev.blk_base[blk], count.to(torch.int32).contiguous(),
    )
    return docs, freqs.long(), valid


def unpack_positions(positions: torch.Tensor, word_start, width, occ: torch.Tensor) -> torch.Tensor:
    """Position deltas (int64, occ's shape) at occurrence indices ``occ``
    of the streams starting at word ``word_start`` with ``width`` bits a
    delta (ints or int64 tensors broadcasting against occ). positions:
    int32 words holding u32 bits, read two at a time."""
    bitpos = occ * width
    widx = word_start + (bitpos >> 5)
    lim = positions.shape[0] - 1
    w0 = positions[widx.clamp(0, lim)].long() & _U32
    w1 = positions[(widx + 1).clamp(0, lim)].long() & _U32
    mask = (torch.ones_like(bitpos) << width) - 1
    return (((w1 << 32) | w0) >> (bitpos & 31)) & mask


def build_position_plane(
    dev,
    wi_block: torch.Tensor,  # int[W] the term's block ids
    pos_width: int,  # packed position-delta width
    pos_word_start: int,  # word offset of the term's stream
    words: int = WORDS,
    fwin: int = FMAX,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (plane i32[md, words] holding u32 bits, overflow bool[md]).

    words: u32 words per doc (2 or 4; positions covered = 32 * words).
    fwin: occurrences read per lane, FMAX or less when the caller knows
    every freq of these blocks is at most fwin (the plane is the same).

    One step per BUILD_CHUNK items: decode, unpack each lane's positions,
    flag overflowing docs, then index_add_ each position's bit into the
    flat plane (a drop bucket past the md docs takes the masked lanes)."""
    md = dev.max_doc_padded
    d = dev.device
    pmax = 32 * words
    plane = torch.zeros(md * words + words, dtype=torch.int32, device=d)
    overflow = torch.zeros(md + 1, dtype=torch.bool, device=d)
    fidx = torch.arange(fwin, dtype=torch.int64, device=d)
    for s in range(0, wi_block.shape[0], BUILD_CHUNK):
        blk = wi_block[s : s + BUILD_CHUNK].long()
        docs, freqs, valid = work_lanes(dev, blk, dev.blk_count[blk])
        pos_off = dev.blk_pos_base[blk].long()[:, None] + (freqs.cumsum(1) - freqs)
        occ = pos_off[:, :, None] + fidx  # [C, 128, fwin]
        pvalid = valid[:, :, None] & (fidx < freqs[:, :, None])
        deltas = unpack_positions(dev.positions, pos_word_start, pos_width, occ)
        pwin = torch.where(pvalid, deltas, 0).cumsum(-1)  # absolute positions
        del occ, deltas
        over_lane = valid & (
            (freqs > FMAX) | (torch.where(pvalid, pwin, 0).amax(-1) >= pmax)
        )
        overflow[torch.where(over_lane, docs.long(), md)] = True  # md: drop bucket
        on = pvalid & (pwin < pmax)
        word_idx = torch.where(on, docs.long()[:, :, None] * words + (pwin >> 5), md * words)
        bitval = torch.where(on, torch.ones_like(pwin) << (pwin & 31), 0).to(torch.int32)  # bit 31 wraps
        plane.index_add_(0, word_idx.reshape(-1), bitval.reshape(-1))
    return plane[: md * words].view(md, words), overflow[:md]


def plane_work_items(terms) -> np.ndarray:
    """The work list of a build of ``terms`` ((blocks, pos_width,
    pos_word_start, fwin) each), over their blocks end to end: int64[4, W]
    rows block id, target plane (the term's index), delta width and the
    word where the term's stream starts."""
    sizes = np.array([len(t[0]) for t in terms], np.int64)
    items = np.empty((4, int(sizes.sum())), np.int64)
    if items.shape[1]:
        items[0] = np.concatenate([np.asarray(t[0], np.int64) for t in terms])
    items[1] = np.repeat(np.arange(len(terms)), sizes)
    items[2] = np.repeat(np.array([t[1] for t in terms], np.int64), sizes)
    items[3] = np.repeat(np.array([t[2] for t in terms], np.int64), sizes)
    return items


def build_position_planes(dev, terms, words: int = WORDS) -> list:
    """-> [(plane i32[md, words], overflow bool[md])], a pair of tensors of
    its own for each of ``terms`` ((blocks int[W_t], pos_width,
    pos_word_start, fwin) each, build_position_plane's arguments).

    A CPU leaf runs the twin, build_position_plane a term. On a card: the
    zeroed pairs, one upload of the work list (plane_work_items) and the
    pairs' pointers, then a work_lanes call and a launch of
    csrc/phrase_plane.cu a LAUNCH_ITEMS items; nothing waits for the
    device. The kernel reads min(freq, FMAX) occurrences a lane whatever
    fwin says, so it equals the twin where fwin covers each block's freqs
    up to FMAX, as callers pass it."""
    d = dev.device
    md = dev.max_doc_padded
    if d.type == "cpu":
        return [
            build_position_plane(dev, torch.from_numpy(np.asarray(b, np.int64)), width, start,
                                 words=words, fwin=fwin)
            for b, width, start, fwin in terms
        ]
    if d.type != "cuda":
        raise ValueError(f"build_position_planes: unsupported device {d}")
    pos = dev.positions
    if pos is None or pos.device != d or pos.dtype != torch.int32 or pos.dim() != 1:
        raise ValueError("build_position_planes: the leaf's positions must be int32[P] on its device")
    if not 1 <= words <= WORDS or any(not 0 <= t[1] <= 32 for t in terms):
        raise ValueError("build_position_planes: words in 1-4 and delta widths in 0-32")
    from rucene_tpu_torch.ops.cuda_build import check, kernels

    out = [(torch.zeros((md, words), dtype=torch.int32, device=d),
            torch.zeros(md, dtype=torch.bool, device=d)) for _ in terms]
    items = plane_work_items(terms)
    n, n_t = items.shape[1], len(terms)
    if n == 0:
        return out
    ptrs = [p.data_ptr() for p, _ in out] + [o.data_ptr() for _, o in out]
    up = torch.from_numpy(np.concatenate([items.reshape(-1), np.array(ptrs, np.int64)]))
    up = up.pin_memory().to(d, non_blocking=True)
    tab = up[: 4 * n].view(4, n)
    blk = tab[0]
    count, pos_base = dev.blk_count[blk], dev.blk_pos_base[blk]
    lib = kernels()
    stream = torch.cuda.current_stream(d).cuda_stream
    for s in range(0, n, LAUNCH_ITEMS):
        e = min(n, s + LAUNCH_ITEMS)
        docs, freqs, _valid = work_lanes(dev, blk[s:e], count[s:e])  # i32 and i64 [W, 128]
        rc = lib.rtt_build_position_planes(
            docs.data_ptr(), freqs.data_ptr(), tab[1, s:e].data_ptr(), pos_base[s:e].data_ptr(),
            tab[2, s:e].data_ptr(), tab[3, s:e].data_ptr(), pos.data_ptr(), pos.shape[0] - 1,
            up[4 * n :].data_ptr(), up[4 * n + n_t :].data_ptr(), e - s, words, md, FMAX, stream,
        )
        check(rc, "rtt_build_position_planes")
        METRICS.incr(LAUNCH_COUNTER)
    return out


def min_bytes(dev, terms, planes) -> int:
    """Device-memory bytes a build of ``terms`` must move: each work item's
    lanes (a 4-byte doc and an 8-byte freq) and table entries (28 bytes)
    read once, the delta bits of each lane's first FMAX occurrences read
    once, and each plane word and overflow byte that ends non-zero written
    once (``planes``: the build's result). The zeroed pairs are the
    allocator's and not counted."""
    items = plane_work_items(terms)
    blk = torch.from_numpy(items[0]).to(dev.device)
    _docs, freqs, _valid = work_lanes(dev, blk, dev.blk_count[blk])
    width = torch.from_numpy(items[2]).to(dev.device)
    delta_bits = int((freqs.clamp(max=FMAX).sum(1) * width).sum())
    written = sum(int((p != 0).sum()) * 4 + int(o.sum()) for p, o in planes)
    return items.shape[1] * (BLOCK_SIZE * 12 + 28) + (delta_bits + 7) // 8 + written


def _shift_right(plane: torch.Tensor, j: int) -> torch.Tensor:
    """Logical right shift of each doc's 32 * words-bit mask by j (< 32)
    bits; plane: int32[..., words] holding u32 bits."""
    if j == 0:
        return plane
    nxt = torch.cat([plane[..., 1:], torch.zeros_like(plane[..., :1])], dim=-1)
    return ((plane >> j) & ((1 << (32 - j)) - 1)) | (nxt << (32 - j))


def _popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Set bits per doc of int32[..., words] (words even) -> int64[...]:
    SWAR on int64 lanes of two words, with the sign bit counted apart so
    that every step stays non-negative."""
    v = x.contiguous().view(torch.int64)
    sign = (v < 0).long()
    v = v & _SIGN_OFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4  # a count per byte
    v = v + (v >> 8)
    v = v + (v >> 16)
    v = v + (v >> 32)  # the low byte sums all eight
    return ((v & 0x7F) + sign).sum(-1)


def phrase_freqs(planes: tuple, overflows: tuple, live: torch.Tensor, n_terms: int):
    """The stacked verify of R same-arity exact phrases: each slot's planes
    stack to [R, md, words], then the shifted AND and its popcount give
    each doc's phrase frequency. Returns (pf f32[R, md], needs_host
    bool[R, md]): a live doc where every term is present (bits or the
    overflow column) and some term overflowed, so its pf is not exact.
    planes: flat, row-major, R x n_terms x i32[md, words]; overflows the
    same of bool[md]."""

    def slot(src, j):
        return torch.stack(src[j::n_terms])

    p0 = slot(planes, 0)
    acc = p0
    ov_any = slot(overflows, 0)
    present_all = (p0 != 0).any(-1) | ov_any
    for j in range(1, n_terms):
        pj = slot(planes, j)
        oj = slot(overflows, j)
        acc = acc & _shift_right(pj, j)
        present_all = present_all & ((pj != 0).any(-1) | oj)
        ov_any = ov_any | oj
        del pj
    pf = _popcount_words(acc).to(torch.float32)
    return pf, present_all & ov_any & live


def phrase_plane_search_many(
    planes: tuple,  # flat, row-major: R rows x n_terms x i32[md, words]
    overflows: tuple,  # R x n_terms x bool[md]
    live: torch.Tensor,  # bool[md]
    denoms: tuple,  # R x f32[md] per-row BM25 denominator planes
    weights: torch.Tensor,  # f32[R]
    k: int,
    n_terms: int,
) -> tuple:
    """R same-arity exact phrase rows at once (phrase_freqs), then BM25
    and the dense top-k. Rows with ov_count > 0 are re-verified whole by
    the caller's scalar path. Returns (scores f32[R, k], docs i32[R, k],
    hits i32[R], ov_count i32[R])."""
    pf, needs_host = phrase_freqs(planes, overflows, live, n_terms)
    match = (pf > 0) & live & ~needs_host
    score = weights[:, None] * pf / (pf + torch.stack(denoms))
    top_scores, top_docs = topk_score_doc(torch.where(match, score, -torch.inf), k)
    hits = match.sum(1).to(torch.int32)
    ov_count = needs_host.sum(1).to(torch.int32)
    return top_scores, top_docs, hits, ov_count


def phrase_plane_search(
    planes: tuple,  # n_terms x i32[md, words]
    overflows: tuple,  # n_terms x bool[md]
    live: torch.Tensor,  # bool[md]
    denom_row: torch.Tensor,  # f32[md] the field's BM25 denominator a doc
    weight,  # f32 boost * sum(idf) * (k1 + 1)
    k: int,
    n_terms: int,
    ov_cap: int = 1024,
) -> tuple:
    """One exact phrase row from its planes (the reference's single-row
    function): a one-row call of phrase_plane_search_many. Returns
    (scores f32[k], docs i32[k], hits i32, ov_docs i32[min(ov_cap, md)],
    ov_count i32): ov_docs lists, ascending and padded with 2^31 - 1, the
    docs whose pf is not exact (some term overflowed there); ov_count >
    ov_cap means the caller must re-verify the whole row."""
    w = torch.as_tensor(weight, dtype=torch.float32, device=live.device).reshape(1)
    scores, docs, hits, ov_count = phrase_plane_search_many(
        planes, overflows, live, (denom_row,), w, k, n_terms
    )
    cap = min(ov_cap, live.shape[0])
    ov_docs = torch.full((cap,), DOC_PAD, dtype=torch.int32, device=live.device)
    if int(ov_count[0]):
        needs_host = phrase_freqs(planes, overflows, live, n_terms)[1][0]
        idx = needs_host.nonzero().flatten()[:cap]
        ov_docs[: idx.numel()] = idx.to(torch.int32)
    return scores[0], docs[0], hits[0], ov_docs, ov_count[0]


def _span_unordered_pf(planes_row, n_terms: int, slop: int) -> torch.Tensor:
    """Exact unordered span-near frequency per doc from one row's position
    planes (the host contract of spans.py's SpanNearQuery unordered
    enumeration): an interval [s, s + w) counts iff every clause occurs
    inside it, some clause occurs at each end, and the two end witnesses
    are distinct clauses; the sloppy freq sums 1 / (1 + w - n) over them.
    With one term a position this is bit algebra per width w in
    [n, n + slop] (w - 1 < 32):
      valid_w[p] = AND_t smear_w(P_t)[p] & U[p] & U[p + w - 1]
                   & ~OR_t (P_t[p] & P_t[p + w - 1])
    with U the OR of the planes. Duplicate clause terms break the
    distinctness reduction: the caller keeps such rows on the host.

    The widths add in ascending order, as the reference's do, each as one
    fused multiply-add ``pf = f32(cnt * wgt + pf)``: XLA contracts the
    reference's ``pf + cnt * wgt`` into an FMA, so a separate f32 product
    and sum differ from it by an ULP. The FMA is computed in f64, where
    ``cnt * wgt + pf`` is exact (an 8-bit count times a 24-bit weight plus
    an f32 within 2^8), then rounded once."""
    u = planes_row[0]
    for t in range(1, n_terms):
        u = u | planes_row[t]
    smears = list(planes_row)
    pf = None
    for w in range(2, n_terms + slop + 1):
        sh = w - 1
        smears = [s | _shift_right(p, sh) for s, p in zip(smears, planes_row)]
        if w < n_terms:
            continue
        allin = smears[0]
        for t in range(1, n_terms):
            allin = allin & smears[t]
        pair_bad = planes_row[0] & _shift_right(planes_row[0], sh)
        for t in range(1, n_terms):
            pair_bad = pair_bad | (planes_row[t] & _shift_right(planes_row[t], sh))
        valid = allin & u & _shift_right(u, sh) & ~pair_bad
        prod = _popcount_words(valid).double() * float(np.float32(1.0) / np.float32(1 + w - n_terms))
        pf = (prod if pf is None else prod + pf.double()).float()
    if pf is None:  # n_terms < 2: the caller never sends one
        pf = torch.zeros(planes_row[0].shape[0], dtype=torch.float32, device=planes_row[0].device)
    return pf


def span_unordered_plane_search_many(
    planes: tuple,  # flat, row-major: R rows x n_terms x i32[md, words]
    overflows: tuple,  # R x n_terms x bool[md]
    live: torch.Tensor,  # bool[md]
    denoms: tuple,  # R x f32[md]
    weights: torch.Tensor,  # f32[R]
    k: int,
    n_terms: int,
    slop: int,
) -> tuple:
    """R unordered span-near rows of one (arity, slop) at once, the
    contract of phrase_plane_search_many: rows with ov_count > 0 rerun on
    the host. Returns (scores f32[R, k], docs i32[R, k], hits i32[R],
    ov_count i32[R])."""
    pf_rows, needs_rows = [], []
    for r in range(len(planes) // n_terms):
        p = planes[r * n_terms : (r + 1) * n_terms]
        o = overflows[r * n_terms : (r + 1) * n_terms]
        pf_rows.append(_span_unordered_pf(p, n_terms, slop))
        ov_any = o[0]
        present_all = (p[0] != 0).any(-1) | o[0]
        for j in range(1, n_terms):
            ov_any = ov_any | o[j]
            present_all = present_all & ((p[j] != 0).any(-1) | o[j])
        needs_rows.append(present_all & ov_any & live)
    pf = torch.stack(pf_rows)
    needs_host = torch.stack(needs_rows)
    match = (pf > 0) & live & ~needs_host
    score = weights[:, None] * pf / (pf + torch.stack(denoms))
    top_scores, top_docs = topk_score_doc(torch.where(match, score, -torch.inf), k)
    return top_scores, top_docs, match.sum(1).to(torch.int32), needs_host.sum(1).to(torch.int32)

"""The batched boolean/BM25 executors (counterpart of
rucene_tpu/search/executor.py: execute_flat_impl with its RowExtras,
execute_flat_single, execute_flat_single_dec, execute_planes,
execute_flat_pair, execute_match_all, execute_mixed_planes,
execute_flat_sorted, execute_collapse, execute_probe and execute_synonym).

A batch of queries runs against one segment as a FLAT WORK LIST, one item
per (query, clause, 128-doc block):

  1. decode each item's block (decode_score_lanes) — a gather from the
     residency planes on a decoded segment, the scoring decode kernel
     (ops/cuda_decode.decode_score_blocks) on a packed one, once per
     distinct block when the batch carries dedup tables — and score every
     lane with BM25 (weight * tf / (tf + cval), the reference's f32
     operation order); FILTER / MUST_NOT clauses carry weight 0;
  2. combine same-(row, doc) contributions and clause-count encodings;
  3. apply boolean semantics (MUST/FILTER counts, min_should_match,
     MUST_NOT, live docs);
  4. exact top-k by (score desc, doc asc).

Step 2 has two branches, picked by the reference's shape rule
``b * md <= 12 * lanes`` (dense_strategy; the rule picks a strategy,
never a result): dense [b, md] accumulators filled by the combine kernel
(ops/cuda_combine.py) plus its sparse residue, or candidate lanes sorted
by (row, doc) and summed per group (ops/ordered_sum.py).

Summation rule, on the card and on the CPU: a (row, doc)'s f32 score is
+0.0 plus each of its contributions in work-list item order (row, clause,
block), one rounding an add. The combine kernel adds its entries in that
order and the candidate groups are ordered segmented sums; the tf-plane
route adds clause by clause from +0.0 and agrees. One exception: the
dense branch adds its residue items after the kernel's sum (in item order
among themselves), so where a residue item lands the order is the
kernel's items, then the residue's. Either way a batch's answers are a
fixed function of its work list, run after run. Integer counts are exact
in any order. The reference's scatters and associative scan
keep an order of their own, so a sum of three or more clauses may differ
from its by float association (tests/torch_hitcheck.py RTOL).

Single-term rows (one positive-weight clause, no deletes) skip steps 2-3:
each row's lanes are one posting list in doc order, so a per-row top-k
over its own item extent (ops/topk.extent_top_k_lanes) is the answer and
the term's doc_freq its total_hits.

Two routes of their own serve plain boolean rows on decoded segments:
- execute_planes: rows whose terms all have resident u8 tf planes
  (codec/device.add_tf_planes) evaluate dense [B, md] elementwise math
  per clause, then the dense top-k;
- execute_flat_pair: rows of two positive term clauses (AND2 / OR2) keep
  the denser clause's lanes as owners and look each owner doc up in the
  other clause's overlapping blocks (PairBatch), so no [B, md]
  accumulator and no lane sort is needed.
Neither reaches a Pallas kernel in the reference; both are torch ops.

Range, exists and prefix clauses ride as FilterPlanes: cached per-doc
bool planes whose constant scores and clause counts fold into the term
sums (dense accumulators or candidate groups) before the match.
Score-combine rows (dismax, constant-score, boosting) take the flat
executor with RowExtras applied to each (row, doc) sum before the match;
match-all rows take execute_match_all; mixed rows (term clauses plus one
exact phrase) take execute_mixed_planes: the term clauses' dense
accumulators through the combine kernel (_dense_match) and the phrase's
position planes (ops/phrase_plane.phrase_freqs). Sorted, collapse and
probe rows (search/sorted_path.py, the rescorer) take _dense_match too
and read its [B, md] match and scores by sort key, collapse key or doc;
synonym rows (SpanOrQuery over terms) sum their members' tfs densely and
score once.

Clause kinds follow BooleanQuery: SHOULD=0 MUST=1 FILTER=2 MUST_NOT=3, and
OCC_DEMOTE=4 for a BoostingQuery's negative members.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rucene_tpu_torch.codec.device import DeviceSegment
from rucene_tpu_torch.ops.combine_tables import MAX_ROWS
from rucene_tpu_torch.ops.cuda_combine import combine_lanes
from rucene_tpu_torch.ops.cuda_decode import decode_score_blocks
from rucene_tpu_torch.ops.decode import INVALID_DOC
from rucene_tpu_torch.ops.ordered_sum import grouped_sums_ordered
from rucene_tpu_torch.ops.phrase_plane import phrase_freqs
from rucene_tpu_torch.ops.topk import (
    DOC_PAD,
    _pad_to_k,
    extent_top_k_lanes,
    score_doc_keys,
    topk_score_doc,
)
from rucene_tpu_torch.util.metrics import METRICS

OCC_DEMOTE = 4  # BoostingQuery negative member: weightless presence bit

# clause-count encodings packed into one int32 accumulator:
# bits 16+: required (MUST|FILTER) matches, bits 8-15: SHOULD matches,
# bits 4-7: demote (BoostingQuery negative) matches, bits 0-3: MUST_NOT
# matches (so MUST_NOT and demote groups each cap at 15 members)
ENC_REQUIRED = 1 << 16
ENC_SHOULD = 1 << 8
ENC_DEMOTE = 1 << 4
ENC_NOT = 1


class FlatQueryBatch(NamedTuple):
    """Device form of a query batch as a flat block work list."""

    wi_block: torch.Tensor  # i32[W] block id in the segment
    wi_row: torch.Tensor  # i32[W] query row
    wi_weight: torch.Tensor  # f32[W] boost * idf * (k1+1); 0 for non-scoring
    wi_fid: torch.Tensor  # i32[W] norms/cache row
    wi_enc: torch.Tensor  # i32[W] clause-count encoding
    wi_valid: torch.Tensor  # bool[W]
    n_required: torch.Tensor  # i32[B]
    min_should: torch.Tensor  # i32[B]
    cache: torch.Tensor  # f32[F,256] norm byte -> BM25 denominator
    # decode-dedup tables (flat_tables.dedupe_work), None without dedup
    wi_ublock: torch.Tensor | None = None  # i32[D] distinct blocks
    wi_uvalid: torch.Tensor | None = None  # bool[D]
    wi_ufid: torch.Tensor | None = None  # i32[D] cache row per distinct block
    wi_inv: torch.Tensor | None = None  # i32[W] item -> distinct block
    cval_dec: torch.Tensor | None = None  # f32[NB,128] resident denominators (decoded segments)


class CombineBatch(NamedTuple):
    """Dense-combine entries for one chunk of up to 32 query rows
    (flat_tables.build_combine_batch)."""

    bucket_ptr: torch.Tensor  # i32[NBk+1] entry offsets per doc bucket
    e_item: torch.Tensor  # i32[E] work item per entry
    e_row: torch.Tensor  # i32[E] chunk-local row
    e_enc: torch.Tensor  # i32[E] clause-count encoding
    residue: torch.Tensor  # i64[R] items left to the residue passes, by (pass, item)
    row_lo: int  # first global row of the chunk
    # host offsets of each residue pass in ``residue`` (flat_tables.residue_passes)
    residue_ptr: tuple[int, ...] = (0,)


class RowExtras(NamedTuple):
    """Per-row score-combine overrides for the flat executor; rows without
    the feature carry inert values. Applied to the accumulated (row, doc)
    score in this order:
    1. dismax (disjunction_max_query.rs:43): (1 - tie) * max + tie * sum
       of the member scores, for rows with tie >= 0;
    2. demote (boosting_query.rs:29): score * factor where a demote member
       matched (the ENC_DEMOTE count bits);
    3. const (ConstantScoreQuery): score = const wherever matched."""

    dm_tie: torch.Tensor  # f32[B] tie breaker; < 0: not a dismax row
    const_on: torch.Tensor  # bool[B]
    const_val: torch.Tensor  # f32[B]
    demote: torch.Tensor  # f32[B] factor (1.0 inert)


def _apply_extras(score, counts, max_sc, ex: RowExtras, rows=None):
    """RowExtras on combined scores: dense [B, md] (rows None, per-row
    values broadcast down a column) or per candidate group (``rows`` the
    group's row). max_sc: the member max, None without dismax rows."""

    def per(v):
        return v[:, None] if rows is None else v[rows]

    if max_sc is not None:
        tie = per(ex.dm_tie)
        score = torch.where(tie >= 0.0, (1.0 - tie) * max_sc + tie * score, score)
    demote_hit = ((counts >> 4) & 0xF) > 0
    score = torch.where(demote_hit, score * per(ex.demote), score)
    return torch.where(per(ex.const_on), per(ex.const_val), score)


class FilterPlanes(NamedTuple):
    """Constant-score doc-set clauses (point ranges, exists, prefixes) as
    dense per-doc bool planes: one [md] plane per distinct filter of the
    batch (cached on the device across batches by the searcher,
    search/filter_path.py). Each row references up to R of them by index,
    with its own occur encoding and constant score; idx -1 is inert."""

    planes: torch.Tensor  # bool[P, md]
    idx: torch.Tensor  # i32[B, R] plane per row slot; -1 inert
    enc: torch.Tensor  # i32[B, R] clause-count encoding (ENC_* units)
    boost: torch.Tensor  # f32[B, R] constant score (0 for FILTER / MUST_NOT)


FOLD_ROWS = 32  # rows per [rows, md] gather when folding planes densely


def _apply_planes_dense(acc_score, acc_counts, filters: FilterPlanes):
    """Fold filter planes into dense [B, md] accumulators, in place: each
    referenced plane adds its occur encoding and constant score wherever
    set, slot by slot after the term sums (host_engine's range fold).
    Rows go FOLD_ROWS at a time, so a slot's gathered planes and their
    addend take FOLD_ROWS * md * 5 bytes, not B * md * 5."""
    b = acc_score.shape[0]
    p = filters.planes.shape[0]
    for r in range(filters.idx.shape[1]):  # R <= 8
        for lo in range(0, b, FOLD_ROWS):
            rows = slice(lo, lo + FOLD_ROWS)
            pidx = filters.idx[rows, r]
            on = filters.planes[pidx.clamp(0, p - 1).long()] & (pidx >= 0)[:, None]
            acc_score[rows] += torch.where(on, filters.boost[rows, r, None], 0.0)
            acc_counts[rows] += torch.where(on, filters.enc[rows, r, None], 0)
    return acc_score, acc_counts


def _apply_planes_lanes(sum_sc, sum_enc, g_row, safe_docs, b: int, filters: FilterPlanes):
    """Fold filter planes into candidate group totals (one gather a slot):
    group i of row g_row[i] at doc safe_docs[i]. The caller guarantees
    candidate completeness (search/filter_path._ranges_complete): every
    possible match holds a decoded lane, so no match is filter membership
    alone."""
    p = filters.planes.shape[0]
    row = g_row.clamp(0, b - 1).long()
    for r in range(filters.idx.shape[1]):
        pidx = filters.idx[row, r]
        on = (pidx >= 0) & filters.planes[pidx.clamp(0, p - 1).long(), safe_docs]
        sum_sc = sum_sc + torch.where(on, filters.boost[row, r], 0.0)
        sum_enc = sum_enc + torch.where(on, filters.enc[row, r], 0)
    return sum_sc, sum_enc


def dense_strategy(b: int, md: int, n_items: int, strategy: str = "auto") -> bool:
    """The reference's shape rule (executor.py:352): dense accumulators when
    ``b * md <= 12 * lanes``; "dense" / "candidate" force a branch."""
    if strategy not in ("auto", "dense", "candidate"):
        raise ValueError(f"unknown strategy {strategy!r}")
    return strategy == "dense" or (strategy == "auto" and b * md <= 12 * n_items * 128)


def decode_score_lanes(dev: DeviceSegment, q: FlatQueryBatch):
    """Decode each item's block and score its lanes. Returns (target
    i32[W,128] doc id or md+1 for invalid lanes, sc f32[W,128], valid
    bool[W,128])."""
    return _decode_lanes(dev, q)[:3]


def _decode_lanes(dev: DeviceSegment, q: FlatQueryBatch):
    """decode_score_lanes with each lane's term frequency: (target, sc,
    valid, freqs i32[W,128], 0 on invalid lanes).

    With dedup tables the decode runs once per distinct block and its lanes
    expand to items through wi_inv: an item's lanes are valid where its
    block's are and the item is. Scores are bit-identical either way. The
    reference's XLA unpack branch for packed segments is not ported: on the
    CPU the scoring decode's wrapper runs its plain twin."""
    md = dev.max_doc_padded
    dedup = q.wi_ublock is not None
    blk = (q.wi_ublock if dedup else q.wi_block).long()
    bvalid = q.wi_uvalid if dedup else q.wi_valid
    bfid = q.wi_ufid if dedup else q.wi_fid
    lane = torch.arange(128, device=blk.device)
    if dev.docs_dec is not None:
        sb = blk.clamp(0, dev.docs_dec.shape[0] - 1)
        cnt = torch.where(bvalid, dev.blk_count[sb], 0)
        valid = lane < cnt[:, None]
        docs = torch.where(valid, dev.docs_dec[sb], INVALID_DOC)
        freqs = torch.where(valid, dev.freqs_dec[sb].to(torch.int32), 0)
        cval = q.cval_dec[sb]
    else:
        cnt = torch.where(bvalid, dev.blk_count[blk], 0)
        docs, freqs, cval = decode_score_blocks(
            dev.data, dev.blk_off[blk], dev.blk_doc_bits[blk], dev.blk_freq_bits[blk],
            dev.blk_base[blk], cnt, bfid, q.cache,
        )
        valid = lane < cnt[:, None]
    if dedup:
        inv = q.wi_inv.long()
        docs, freqs, cval = docs[inv], freqs[inv], cval[inv]
        valid = valid[inv] & q.wi_valid[:, None]
        freqs = torch.where(valid, freqs, 0)
    tf = freqs.to(torch.float32)
    sc = q.wi_weight[:, None] * tf / (tf + cval)
    sc = torch.where(valid, sc, 0.0)
    target = torch.where(valid, docs, md + 1)
    return target, sc, valid, torch.where(valid, freqs, 0)


def _residue_passes(combine):
    """Each residue pass's items over all chunks (i64, device): a pass
    reaches a (row, doc) slot at most once, and a slot's passes come in
    item order (flat_tables.residue_passes)."""
    for j in range(max(len(cb.residue_ptr) for cb in combine) - 1):
        parts = [cb.residue[cb.residue_ptr[j]:cb.residue_ptr[j + 1]]
                 for cb in combine if j + 1 < len(cb.residue_ptr)]
        yield parts[0] if len(parts) == 1 else torch.cat(parts)


def _combine_dense(q, target, sc, valid, b, md, combine):
    """Dense [b, md] score and count accumulators: the combine kernel per
    32-row chunk (reading the items' lanes in place), then the sparse
    residue items pass by pass, each pass's lanes added to distinct slots
    with a gather and a put, so a slot's residue lanes add in item order
    after the kernel's sum."""
    trash = b * md  # one spare slot takes every out-of-range lane
    acc_s = torch.empty(trash + 1, dtype=torch.float32, device=sc.device)
    acc_c = torch.empty(trash + 1, dtype=torch.int32, device=sc.device)
    acc_s[trash] = 0.0
    acc_c[trash] = 0
    score2d = acc_s[:trash].view(b, md)
    count2d = acc_c[:trash].view(b, md)
    for cb in combine:
        hi = min(cb.row_lo + MAX_ROWS, b)
        combine_lanes(
            cb.bucket_ptr, target, sc, cb.e_item, cb.e_row, cb.e_enc,
            score2d[cb.row_lo:hi], count2d[cb.row_lo:hi],
        )
    for items in _residue_passes(combine):
        rt = target[items].long()
        rows = q.wi_row[items].long()[:, None]
        # slots below trash are distinct within a pass; only trash repeats
        idx = torch.where(rt < md, rows * md + rt, trash).reshape(-1)
        acc_s[idx] = acc_s[idx] + sc[items].reshape(-1)
        renc = torch.where(valid[items], q.wi_enc[items][:, None], 0)
        acc_c[idx] = acc_c[idx] + renc.reshape(-1)
    return score2d, count2d


def _boolean_match(counts, n_required, min_should):
    req_count = counts >> 16
    should_count = (counts >> 8) & 0xFF
    has_not = (counts & 0xF) > 0
    return (req_count == n_required) & (should_count >= min_should) & ~has_not


def execute_flat_impl(
    dev: DeviceSegment,
    q: FlatQueryBatch,
    k: int,
    pure_disjunction: bool = False,
    combine: tuple[CombineBatch, ...] | None = None,
    extras: RowExtras | None = None,
    with_dismax: bool = False,
    filters: FilterPlanes | None = None,
):
    """Returns (scores f32[B,k], docs i32[B,k], total_hits i32[B]).

    pure_disjunction (caller-guaranteed: every row all-SHOULD with positive
    weights, min_should <= 1) matches on score > 0 and skips the counts.
    ``combine`` (flat_tables.build_combine_batch) selects the dense branch;
    None selects the candidate branch. ``extras`` (never with
    pure_disjunction) applies RowExtras to the combined scores before the
    match; with_dismax (some row has dismax_tie >= 0) also takes the
    member max: a scatter-max into [B, md] in the dense branch, a
    segmented max over the sorted groups in the candidate branch.
    ``filters`` (never with pure_disjunction) folds the batch's filter
    planes into the term sums and counts before the extras: into the dense
    accumulators, or onto the candidate groups, which the caller must make
    candidate-complete (search/filter_path._ranges_complete)."""
    b = q.n_required.shape[0]
    md = dev.max_doc_padded
    target, sc, valid = decode_score_lanes(dev, q)

    if combine is not None:
        METRICS.incr("search.strategy.dense")
        acc_score, acc_counts = _combine_dense(q, target, sc, valid, b, md, combine)
        if pure_disjunction:
            match = acc_score > 0.0
        else:
            if filters is not None:
                _apply_planes_dense(acc_score, acc_counts, filters)
            if extras is not None:
                acc_max = None
                if with_dismax:
                    idx = torch.where(
                        target < md, q.wi_row.long()[:, None] * md + target, b * md
                    ).reshape(-1)
                    acc_max = torch.zeros(b * md + 1, dtype=torch.float32, device=sc.device)
                    acc_max = acc_max.scatter_reduce_(0, idx, sc.reshape(-1), "amax")
                    acc_max = acc_max[: b * md].view(b, md)
                acc_score = _apply_extras(acc_score, acc_counts, acc_max, extras)
            match = _boolean_match(
                acc_counts, q.n_required[:, None], q.min_should[:, None]
            )
        match &= dev.live[None, :]
        scores = torch.where(match, acc_score, -torch.inf)
        top_scores, top_docs = topk_score_doc(scores, k)
        total_hits = match.sum(dim=1, dtype=torch.int32)
        return top_scores, top_docs, total_hits

    METRICS.incr("search.strategy.candidate")
    dvc = target.device
    n_lanes = target.numel()
    cdocs = target.reshape(-1).long()
    crows = q.wi_row.long()[:, None].expand_as(target).reshape(-1)
    # sort lanes by (row, doc), one int64 key, stably, so each doc's
    # contributions are contiguous and in item order; out-of-range lanes
    # key a group each from pad_key up, past every real group
    stride = md + 1
    pad_key = (b + 1) * stride
    lanes = torch.arange(n_lanes, device=dvc)
    key = torch.where(cdocs < md, crows * stride + cdocs, pad_key + lanes)
    g_key, perm, gid, sum_sc = grouped_sums_ordered(key, sc.reshape(-1), pad_key)
    g_row = g_key // stride
    g_doc = g_key % stride
    safe_doc = g_doc.clamp(max=md - 1)
    if pure_disjunction:
        g_match = sum_sc > 0.0
    else:
        lane_enc = torch.where(valid, q.wi_enc[:, None], 0).reshape(-1)
        sum_enc = torch.zeros(n_lanes, dtype=torch.int32, device=dvc).index_add_(
            0, gid, lane_enc[perm]
        )
        safe_row = g_row.clamp(max=b - 1)
        if filters is not None:
            sum_sc, sum_enc = _apply_planes_lanes(sum_sc, sum_enc, g_row, safe_doc, b, filters)
        if extras is not None:
            max_sc = None
            if with_dismax:
                max_sc = torch.zeros(n_lanes, dtype=torch.float32, device=dvc).scatter_reduce_(
                    0, gid, sc.reshape(-1)[perm], "amax"
                )
            sum_sc = _apply_extras(sum_sc, sum_enc, max_sc, extras, rows=safe_row)
        g_match = _boolean_match(sum_enc, q.n_required[safe_row], q.min_should[safe_row])
    g_match &= (g_key < pad_key) & dev.live[safe_doc]

    # order groups by (row, score desc, doc asc): (score, doc) as one
    # distinct int64 key, then a stable pass by row
    sd_key = torch.where(
        g_match, score_doc_keys(sum_sc, g_doc.clamp(max=DOC_PAD)), torch.iinfo(torch.int64).min
    )
    _, p1 = torch.sort(sd_key, descending=True, stable=True)
    row_key = torch.where(g_match, g_row, b)[p1]
    s_row, p2 = torch.sort(row_key, stable=True)
    order = p1[p2]
    per_row = torch.zeros(b + 1, dtype=torch.int64, device=dvc).index_add_(
        0, s_row, torch.ones_like(s_row)
    )
    row_start = torch.cumsum(per_row, 0) - per_row
    rank = torch.arange(n_lanes, device=dvc) - row_start[s_row]
    sel = (s_row < b) & (rank < k)
    slot = torch.where(sel, s_row * k + rank, b * k)
    top_scores = torch.full((b * k + 1,), -torch.inf, dtype=torch.float32, device=dvc)
    top_scores[slot] = sum_sc[order]
    top_docs = torch.full((b * k + 1,), DOC_PAD, dtype=torch.int32, device=dvc)
    top_docs[slot] = g_doc[order].to(torch.int32)
    top_scores[b * k] = -torch.inf
    return (
        top_scores[: b * k].view(b, k),
        top_docs[: b * k].view(b, k),
        per_row[:b].to(torch.int32),
    )


def execute_match_all(dev: DeviceSegment, boost: torch.Tensor, k: int):
    """MatchAllDocsQuery rows (match_all_query.rs): every live doc matches
    with the row's constant ``boost`` (f32[B]). Scores are equal, so the
    top-k under (score desc, doc asc) is the first k live docs: a cumsum
    and a searchsorted, no [B, md] top-k. Returns (scores f32[B,k], docs
    i32[B,k], total_hits i32[B])."""
    md = dev.max_doc_padded
    kk = min(k, md)
    rank = torch.cumsum(dev.live.to(torch.int32), 0)
    n_live = rank[-1]
    tgt = torch.arange(1, kk + 1, dtype=torch.int32, device=rank.device)
    pos = torch.searchsorted(rank, tgt, side="left").to(torch.int32)
    valid = tgt <= n_live
    b = boost.shape[0]
    top_docs = torch.where(valid, pos, DOC_PAD).expand(b, kk)
    top_scores = torch.where(valid[None, :], boost[:, None], -torch.inf)
    top_scores, top_docs = _pad_to_k(top_scores, top_docs, k)
    return top_scores, top_docs, n_live.to(torch.int32).expand(b)


def _dense_match(dev: DeviceSegment, q: FlatQueryBatch, combine: tuple[CombineBatch, ...],
                 filters: FilterPlanes | None = None):
    """Dense boolean evaluation of q's term clauses and filter planes:
    (match bool[B, md], acc_score f32[B, md]). The accumulators come from
    _combine_dense (the combine kernel plus its residue), under the
    module's summation rule; the planes fold in after."""
    b = q.n_required.shape[0]
    md = dev.max_doc_padded
    target, sc, valid = decode_score_lanes(dev, q)
    acc_score, acc_counts = _combine_dense(q, target, sc, valid, b, md, combine)
    if filters is not None:
        _apply_planes_dense(acc_score, acc_counts, filters)
    match = _boolean_match(acc_counts, q.n_required[:, None], q.min_should[:, None])
    return match & dev.live[None, :], acc_score


def execute_mixed_planes(
    dev: DeviceSegment,
    q: FlatQueryBatch,  # term clauses only: n_required / min_should are term-side
    combine: tuple[CombineBatch, ...],  # flat_tables.build_combine_batch of q's work
    planes: tuple,  # flat, row-major: B rows x n_terms x i32[md, words]
    overflows: tuple,  # B x n_terms x bool[md]
    denoms: tuple,  # B x f32[md] the phrase field's denominator planes
    weights: torch.Tensor,  # f32[B] phrase weight boost * sum(idf) * (k1+1); 0 FILTER
    k: int,
    n_terms: int,
    filters: FilterPlanes | None = None,  # the rows' range clauses
):
    """Mixed boolean rows (term clauses and up to 8 range clauses plus one
    required exact phrase): the dense match and scores of the term clauses
    and filter planes (_dense_match), the phrase's
    frequency per doc from its position planes (ops/phrase_plane.
    phrase_freqs, the stacked verify), then ``acc + w * pf / (pf +
    denom)`` where the terms match and pf > 0, and the dense top-k. The
    phrase is required through pf > 0, so a row whose term clauses are
    all MUST_NOT or FILTER matches docs no lane touched (the combine
    writes every element of its tiles). Docs the planes flag for the
    host (a term's overflow column) are left out of the match; ov_count
    counts those the terms match: such a row needs the reference's host
    rerun. Returns (scores f32[B,k], docs i32[B,k], hits i32[B], ov_count
    i32[B])."""
    match_t, acc = _dense_match(dev, q, combine, filters)
    pf, needs_host = phrase_freqs(planes, overflows, dev.live, n_terms)
    ph_score = weights[:, None] * pf / (pf + torch.stack(denoms))
    match = match_t & (pf > 0) & ~needs_host
    scores = torch.where(match, acc + ph_score, -torch.inf)
    del acc, ph_score, pf
    top_scores, top_docs = topk_score_doc(scores, k)
    hits = match.sum(1, dtype=torch.int32)
    ov_count = (needs_host & match_t).sum(1, dtype=torch.int32)
    return top_scores, top_docs, hits, ov_count


def execute_flat_sorted(
    dev: DeviceSegment,
    q: FlatQueryBatch,
    combine: tuple[CombineBatch, ...],  # flat_tables.build_combine_batch of q's work
    keycol: torch.Tensor,  # f32[md] order-preserving sort key (rank) per doc
    k: int,
    filters: FilterPlanes | None = None,
):
    """Sort-by-field search (field_comparator.rs:367): the dense boolean
    match (_dense_match), then the top-k by (key asc, doc asc) over a
    per-doc key column of ranks (exact in f32 below 2^24 distinct keys;
    the caller folds directions into them and maps ranks back to
    values). Returns (top_keys f32[B,k], scores f32[B,k], docs i32[B,k],
    total_hits i32[B])."""
    match, acc_score = _dense_match(dev, q, combine, filters)
    sortval = torch.where(match, -keycol[None, :], -torch.inf)
    top_negkeys, top_docs = topk_score_doc(sortval, k)
    got = top_negkeys > -torch.inf
    top_keys = torch.where(got, -top_negkeys, 0.0)
    safe = top_docs.clamp(0, dev.max_doc_padded - 1).long()
    scores = torch.where(got, torch.gather(acc_score, 1, safe), -torch.inf)
    return top_keys, scores, top_docs, match.sum(1, dtype=torch.int32)


def execute_collapse(
    dev: DeviceSegment,
    q: FlatQueryBatch,
    combine: tuple[CombineBatch, ...],
    keycol: torch.Tensor,  # i32[md] collapse-key rank per doc
    n_keys: int,
    filters: FilterPlanes | None = None,
):
    """Field collapse (collapse_top_docs.rs:239): the best (score desc, doc
    asc) hit per collapse key, as a scatter-max of the matched scores per
    key, then a scatter-min of the doc ids that reach their key's best.
    Keys outside [0, n_keys) are dropped. Returns (best_score f32[B, K],
    -inf for an absent key; best_doc i32[B, K]; total_hits i32[B]); the
    caller merges leaves and takes the top-k."""
    match, acc_score = _dense_match(dev, q, combine, filters)
    b, md = match.shape
    trash = b * n_keys
    inside = (keycol >= 0) & (keycol < n_keys)
    rows = torch.arange(b, device=match.device)[:, None]
    slot = torch.where(inside[None, :], rows * n_keys + keycol.long()[None, :], trash)
    msc = torch.where(match, acc_score, -torch.inf)
    best = torch.full((trash + 1,), -torch.inf, dtype=torch.float32, device=match.device)
    best.scatter_reduce_(0, slot.reshape(-1), msc.reshape(-1), "amax")
    at_best = match & inside[None, :] & (acc_score == best[slot])
    doc_ids = torch.arange(md, dtype=torch.int32, device=match.device)
    mdoc = torch.where(at_best, doc_ids[None, :], DOC_PAD)
    best_doc = torch.full((trash + 1,), DOC_PAD, dtype=torch.int32, device=match.device)
    best_doc.scatter_reduce_(0, slot.reshape(-1), mdoc.reshape(-1), "amin")
    return (
        best[:trash].view(b, n_keys),
        best_doc[:trash].view(b, n_keys),
        match.sum(1, dtype=torch.int32),
    )


def execute_probe(
    dev: DeviceSegment,
    q: FlatQueryBatch,  # one row
    combine: tuple[CombineBatch, ...],
    probe_docs: torch.Tensor,  # i32[P] local doc ids
    filters: FilterPlanes | None = None,
):
    """One row evaluated densely, read at given docs: (ok bool[P], score
    f32[P], 0 where not ok) -- the rescorer's second-pass lookup
    (rescorer.rs:130 QueryRescorer::combine inputs)."""
    match, acc_score = _dense_match(dev, q, combine, filters)
    safe = probe_docs.clamp(0, dev.max_doc_padded - 1).long()
    ok = (probe_docs >= 0) & match[0, safe]
    return ok, torch.where(ok, acc_score[0, safe], 0.0)


def execute_synonym(
    dev: DeviceSegment,
    q: FlatQueryBatch,  # a row per SpanOrQuery, its member terms as clauses
    fid_row: torch.Tensor,  # i32[B] norms / cache row of the row's field
    w_row: torch.Tensor,  # f32[B] boost * sum(member idf) * (k1 + 1)
    k: int,
):
    """SpanOrQuery over plain term members (span_or.rs through SpanScorer):
    every span has width 1, so freq(doc) is the SUM of the member tfs and
    the score ONE BM25 application with the summed-idf weight, unlike the
    boolean executor's score per clause. Member tfs sum into a dense
    [B, md] plane (integers, exact in any order), the per-doc norm reads
    the field's norms row, then the dense top-k. Returns (scores
    f32[B,k], docs i32[B,k], total_hits i32[B])."""
    b = q.n_required.shape[0]
    md = dev.max_doc_padded
    target, _sc, _valid, freqs = _decode_lanes(dev, q)
    idx = torch.where(target < md, q.wi_row.long()[:, None] * md + target, b * md)
    tf = torch.zeros(b * md + 1, dtype=torch.float32, device=target.device)
    tf.index_put_((idx.reshape(-1),), freqs.reshape(-1).to(torch.float32), accumulate=True)
    tf = tf[: b * md].view(b, md)
    fid = fid_row.long()
    cval = torch.gather(q.cache[fid], 1, dev.norms[fid].long())
    match = (tf > 0.0) & dev.live[None, :]
    score = w_row[:, None] * tf / (tf + cval)
    top_scores, top_docs = topk_score_doc(torch.where(match, score, -torch.inf), k)
    return top_scores, top_docs, match.sum(1, dtype=torch.int32)


class PlaneBatch(NamedTuple):
    """Device tables for the dense tf-plane executor (execute_planes):
    boolean rows whose term clauses all live as resident u8 tf planes.
    Each row is up to T slots; slot -1 is inert (padding, or a term absent
    from this segment, which for a required clause matches nothing)."""

    slot: torch.Tensor  # i32[B, T] plane row per clause; -1 inert
    kindenc: torch.Tensor  # i32[B, T] ENC_REQUIRED/ENC_SHOULD/ENC_NOT; 0 pad
    weight: torch.Tensor  # f32[B, T] boost*idf*(k1+1); 0 for non-scoring
    fid: torch.Tensor  # i32[B, T] norms/cache row per clause
    n_required: torch.Tensor  # i32[B]
    min_should: torch.Tensor  # i32[B]


def execute_planes(
    planes: torch.Tensor,  # u8[P, md]
    cval_planes: torch.Tensor,  # f32[F, md] BM25 denominators per doc
    live: torch.Tensor,  # bool[md]
    pb: PlaneBatch,
    k: int,
    same_fid: int,
):
    """Dense boolean/BM25 evaluation over resident tf planes: per clause
    the gathered u8 rows as f32, ``(w * tf) / (tf + cv)`` added into a
    [B, md] f32 accumulator and the clause's count encoding where tf > 0;
    then the boolean match, ``live``, and the dense top-k. Each clause's
    score takes the lane executor's operands and operation order, so
    two-clause sums are bit-identical to it.

    same_fid >= 0: every clause shares that norms row, so one [md] cval
    row broadcasts instead of a per-row [B, md] gather. Temporaries are
    updated in place to keep the per-(row, doc) peak down
    (plane_path.plane_row_chunk sizes calls by it). Returns (scores
    f32[B,k], docs i32[B,k], total_hits i32[B])."""
    p, md = planes.shape
    b, t = pb.slot.shape
    nf = cval_planes.shape[0]
    acc = torch.zeros((b, md), dtype=torch.float32, device=planes.device)
    cnt = torch.zeros((b, md), dtype=torch.int32, device=planes.device)
    cv_shared = cval_planes[same_fid][None, :] if same_fid >= 0 else None
    for i in range(t):  # T <= 8
        sl = pb.slot[:, i]
        tf = planes[sl.clamp(0, p - 1).long()].to(torch.float32)
        tf.mul_((sl >= 0)[:, None])  # an inert slot reads tf 0
        cv = (
            cv_shared
            if cv_shared is not None
            else cval_planes[pb.fid[:, i].clamp(0, nf - 1).long()]
        )
        cnt.add_(torch.where(tf > 0.0, pb.kindenc[:, i, None], 0))
        num = tf * pb.weight[:, i, None]
        acc.add_(num.div_(tf.add_(cv)))
        del tf, num
    match = _boolean_match(cnt, pb.n_required[:, None], pb.min_should[:, None])
    del cnt
    match &= live[None, :]
    total_hits = match.sum(dim=1, dtype=torch.int32)
    scores = acc.masked_fill_(~match, -torch.inf)
    del match
    top_scores, top_docs = topk_score_doc(scores, k)
    return top_scores, top_docs, total_hits


class PairBatch(NamedTuple):
    """Device tables for the pair-gallop executor (execute_flat_pair), the
    batched analog of the reference's doc-at-a-time leapfrog
    (conjunction_scorer.rs over skip_reader.rs:118), for rows of exactly
    two positive term clauses (AND2 / OR2).

    Owner work items are blocks whose lanes are the row's candidate
    matches: the DENSER clause's blocks (narrow doc spans, so few probe
    blocks overlap each) carry a [MAXP] table of the overlapping probe
    (other-clause) block ids. OR2 rows keep a second extent of the
    sparser clause's lanes with partial scores (own clause only)."""

    oi_mode: torch.Tensor  # i32[W] 1=OR-probing 2=OR-partial 3=AND-probing
    oi_pw: torch.Tensor  # f32[W] probe clause weight (0 if probe absent)
    pr_slots: torch.Tensor  # i32[W, MAXP] probe block ids, -1 inert (tail)
    row_p_start: torch.Tensor  # i32[B] first owner item, probing extent
    row_p_items: torch.Tensor  # i32[B]
    row_s_start: torch.Tensor  # i32[B] partial (OR sparse) extent
    row_s_items: torch.Tensor  # i32[B]


PROBE_WINDOW_ELEMS = 1 << 25  # probe-window elements per chunk of owner items


def _probe(dev, q, p: PairBatch, target, same_field: bool):
    """The probe clause's tf and BM25 denominator at each owner lane's doc
    (tf 0 where the probe list lacks it). An item's probe window, its
    slots' decoded docs side by side, is sorted: the slots are
    consecutive blocks of one term, only a term's last block is short,
    and the pad lanes and -1 slots read INVALID_DOC, which sorts last.
    So a batched searchsorted of the item's 128 owner docs into its
    window finds each doc's one possible position, and the tf and
    denominator there equal the reference's masked sums over a broadcast
    compare bit for bit, at [W, MAXP * 128] of memory in place of
    [W, 128, MAXP * 128]. same_field: the probe doc's denominator is the
    owner lane's own (same doc, same norms row), the reference's
    "nopcv" variant."""
    w, maxp = p.pr_slots.shape
    nbr = dev.docs_dec.shape[0]
    win_len = maxp * 128
    ch = max(1, PROBE_WINDOW_ELEMS // win_len)
    ptf = torch.empty((w, 128), dtype=torch.float32, device=target.device)
    pcv = (
        q.cval_dec[q.wi_block.long().clamp(0, nbr - 1)]
        if same_field
        else torch.empty_like(ptf)
    )
    for o in range(0, w, ch):
        slots = p.pr_slots[o : o + ch]
        sb = slots.long().clamp(0, nbr - 1)
        win = torch.where(
            (slots >= 0)[:, :, None], dev.docs_dec[sb], INVALID_DOC
        ).reshape(-1, win_len)
        tg = target[o : o + ch].contiguous()
        pos = torch.searchsorted(win, tg).clamp_(max=win_len - 1)
        found = win.gather(1, pos) == tg
        blk = sb.gather(1, pos // 128)
        lane = pos % 128
        ptf[o : o + ch] = torch.where(found, dev.freqs_dec[blk, lane].to(torch.float32), 0.0)
        if not same_field:
            pcv[o : o + ch] = q.cval_dec[blk, lane]
    return ptf, pcv


def _dedup_merge(cs, cd, k: int):
    """Top-k of concatenated candidates, each doc once at its higher score:
    order by (score desc, doc asc), then stably by doc, so each doc's
    first entry is its best; drop the rest; top-k of what remains."""
    _, p1 = torch.sort(score_doc_keys(cs, cd), dim=1, descending=True, stable=True)
    cs, cd = cs.gather(1, p1), cd.gather(1, p1)
    cd, p2 = torch.sort(cd, dim=1, stable=True)
    cs = cs.gather(1, p2)
    dup = torch.zeros_like(cd, dtype=torch.bool)
    dup[:, 1:] = (cd[:, 1:] == cd[:, :-1]) & (cd[:, 1:] != DOC_PAD)
    cs = cs.masked_fill(dup, -torch.inf)
    cd = cd.masked_fill(dup, DOC_PAD)
    _, tj = torch.topk(score_doc_keys(cs, cd), k, dim=1)
    ts = cs.gather(1, tj)
    td = torch.where(ts > -torch.inf, cd.gather(1, tj), DOC_PAD)
    return ts, td


def execute_flat_pair(
    dev: DeviceSegment,
    q: FlatQueryBatch,
    p: PairBatch,
    k: int,
    max_items_p: int,  # >= every row_p_items
    max_items_s: int,  # >= every row_s_items; 0 without OR rows
    with_live: bool = False,
    same_field: bool = False,
):
    """Two-term-clause boolean rows via pair gallop (see PairBatch).
    Decoded residency only; no decode dedup (q as make_flat_batch builds
    it for the owner work list). with_live: gather the live mask per lane
    (segments with deletes). same_field (caller-guaranteed: both clauses
    of every row on one field): the probe's denominator is the owner
    lane's own (_probe).

    Owner lanes score their own clause; a lane whose doc the probe list
    holds adds the probe clause's score, in the lane executor's operand
    order. Modes: AND (3) matches members only; OR probing (1) matches
    every owner lane with its full score; OR partial (2) the sparser
    clause's lanes with their own score. The per-extent top-k
    (ops/topk.extent_top_k_lanes) is exact within an extent; an OR row
    merges the probing extent's top-k with the partial extent's top-2k,
    each doc once at its higher score. That is exact: if 2k partial
    entries outrank a candidate, at most k of them are duplicates of
    probing entries, and the rest outrank it with exact scores.
    total_hits is exact from per-item counts: the probing extent counts
    live owner lanes outside the probe list (OR) or inside it (AND), the
    partial extent every live lane. Returns (scores f32[B,k], docs
    i32[B,k], total_hits i32[B])."""
    md = dev.max_doc_padded
    w = p.pr_slots.shape[0]
    target, sc, valid = decode_score_lanes(dev, q)
    ptf, pcv = _probe(dev, q, p, target, same_field)
    member = ptf > 0.0  # real postings have tf >= 1
    psc = torch.where(member, p.oi_pw[:, None] * ptf / torch.where(member, ptf + pcv, 1.0), 0.0)
    alive = valid & dev.live[target.clamp(0, md - 1)] if with_live else valid
    mode = p.oi_mode[:, None]
    match = alive & (member | (mode != 3))
    score = torch.where(match, sc + torch.where(mode == 2, 0.0, psc), -torch.inf)
    count_lane = torch.where(
        mode == 1, alive & ~member, torch.where(mode == 2, alive, match)
    )
    docm = torch.where(match, target, DOC_PAD)

    top_scores, top_docs = extent_top_k_lanes(
        score, docm, p.row_p_start, p.row_p_items, max_items_p, k
    )
    if max_items_s > 0:
        ts_s, td_s = extent_top_k_lanes(
            score, docm, p.row_s_start, p.row_s_items, max_items_s, 2 * k
        )
        top_scores, top_docs = _dedup_merge(
            torch.cat([top_scores, ts_s], dim=1), torch.cat([top_docs, td_s], dim=1), k
        )

    # exact total hits: prefix sums of per-item counts, read per extent
    csum = torch.zeros(w + 1, dtype=torch.int64, device=sc.device)
    csum[1:] = torch.cumsum(count_lane.sum(dim=1), 0)

    def ext_hits(start, items):
        start = start.long()
        return csum[start + items.long()] - csum[start]

    total_hits = ext_hits(p.row_p_start, p.row_p_items) + ext_hits(p.row_s_start, p.row_s_items)
    return top_scores, top_docs.to(torch.int32), total_hits.to(torch.int32)


def _single_top_k(sc, docs, valid, row_item_start, row_item_count, max_items, k):
    # a real posting always scores > 0 here (one positive-weight clause,
    # tf >= 1); invalid lanes score 0
    matched = valid & (sc > 0.0)
    score_l = torch.where(matched, sc, -torch.inf)
    docm = torch.where(matched, docs, DOC_PAD)
    return extent_top_k_lanes(score_l, docm, row_item_start, row_item_count, max_items, k)


def execute_flat_single(
    dev: DeviceSegment,
    q: FlatQueryBatch,
    row_item_start: torch.Tensor,  # i32[B] first work item of each row
    row_item_count: torch.Tensor,  # i32[B] work items of each row
    row_hits: torch.Tensor,  # i32[B] live postings: the row's total_hits
    k: int,
    max_items: int,  # >= every row_item_count
):
    """Single-scoring-clause rows (plain term queries), no deleted docs:
    each row's lanes are one posting list in doc order, so no cross-clause
    combine and no dense [B, max_doc] accumulator is needed; the top-k
    runs over the row's own item extent. Lanes come from
    decode_score_lanes, so on a packed segment from the scoring decode
    kernel. Memory and time do not depend on max_doc.

    Caller guarantees: one scoring clause per row with positive weight, no
    MUST_NOT / FILTER, dev.live all-true over real docs, and every row's
    work items contiguous in the flat list. Returns (scores f32[B,k], docs
    i32[B,k], total_hits i32[B])."""
    target, sc, valid = decode_score_lanes(dev, q)
    top_scores, top_docs = _single_top_k(
        sc, target, valid, row_item_start, row_item_count, max_items, k
    )
    return top_scores, top_docs, row_hits.to(torch.int32)


def execute_flat_single_dec(
    dev: DeviceSegment,
    cval_dec: torch.Tensor,  # f32[NB,128] resident BM25 denominators
    block_start: torch.Tensor,  # i32[B] the row's first block
    block_count: torch.Tensor,  # i32[B] the row's blocks
    weight: torch.Tensor,  # f32[B] the row's clause weight
    row_hits: torch.Tensor,  # i32[B] live postings: the row's total_hits
    n_items: int,  # sum of block_count
    k: int,
    max_items: int,  # >= every block_count
):
    """Decoded-residency single-term rows with the work list expanded on
    the device from per-row block ranges (repeat_interleave over the row
    ids, cumsum for the extents): the host sends four [B] tables instead of
    a flat work list. The reference's _fill_extents (a scan in place of a
    per-item gather, which serialises on the TPU) and the i32 bitcast of
    the weights it needs are not ported: items gather their row's values.
    Same score math and extent top-k as execute_flat_single; the same
    caller guarantees, plus decoded residency."""
    dvc = block_count.device
    bc = block_count.long()
    starts = torch.cumsum(bc, 0) - bc
    row = torch.repeat_interleave(torch.arange(bc.shape[0], device=dvc), bc, output_size=n_items)
    blk = block_start.long()[row] + torch.arange(n_items, device=dvc) - starts[row]
    sb = blk.clamp(0, dev.docs_dec.shape[0] - 1)
    valid = torch.arange(128, device=dvc) < dev.blk_count[sb][:, None]
    docs = torch.where(valid, dev.docs_dec[sb], INVALID_DOC)
    tf = torch.where(valid, dev.freqs_dec[sb].to(torch.int32), 0).to(torch.float32)
    sc = weight[row][:, None] * tf / (tf + cval_dec[sb])
    top_scores, top_docs = _single_top_k(sc, docs, valid, starts, bc, max_items, k)
    return top_scores, top_docs, row_hits.to(torch.int32)

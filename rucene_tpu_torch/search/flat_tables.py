"""Flat batch-table builders: queries -> executor work lists (counterpart of
rucene_tpu/search/flat_tables.py).

Host numpy assembly of the per-(query, clause, 128-doc block) work list and
the decode-dedup tables, plus the one place executor inputs move to the
device (make_flat_batch); the dense-combine entry tables, sorted on the
batch's device from host counts (build_combine_batch); and the
tf-plane executor's dense denominator planes (cval_plane_for), and the
filter slot tables of range rows (build_range_filter_tables, without the
reference's pow2 slot pad). Left out of the reference: the W floor of 1024 and the pow2 pads (of the work list
and of dedup's distinct-block count, whose floor of 8 is the Pallas
kernel's item group), which keep XLA shapes reusable, and the TPU gates
on the combine kernel. On CUDA every dense-branch call goes through it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rucene_tpu_torch.index.derived import DerivedCache
from rucene_tpu_torch.search.executor import (
    ENC_DEMOTE,
    ENC_NOT,
    ENC_REQUIRED,
    ENC_SHOULD,
    OCC_DEMOTE,
    CombineBatch,
    FlatQueryBatch,
)
from rucene_tpu_torch.search.query import Occur
from rucene_tpu_torch.util.metrics import METRICS


class QueryPlan:
    """Per-(searcher, query) cached host work: rewrite, per-clause weights,
    per-leaf term resolution. All of it is reader-stable, so a repeated
    query pays none of it again. Entries pin the query object (an
    identity-keyed cache must never serve a recycled id())."""

    __slots__ = ("q", "rq", "clause_row", "stats_terms", "leaf_rows", "flags")

    def __init__(self, q, rq):
        self.q = q
        self.rq = rq
        self.clause_row = None  # (w[T], occ[T], nreq, msm, match_all, boost)
        self.stats_terms = None  # [(field, text)] for _gather_stats
        self.leaf_rows: dict = {}  # id(leaf) -> per-leaf resolution dict
        self.flags: dict = {}  # reader-stable routing decisions (searcher)


def clause_row_for(rq, sim, doc_freqs, stats, plan=None):
    """One row's segment-independent tables, cached on the plan."""
    if plan is not None and plan.clause_row is not None:
        return plan.clause_row
    slots = rq.all_slots()
    wrow = np.zeros(len(slots), np.float32)
    orow = np.zeros(len(slots), np.int32)
    for j, (occ, c) in enumerate(slots):
        orow[j] = occ
        if occ in (int(Occur.SHOULD), int(Occur.MUST)):
            wrow[j] = sim.term_weight(
                doc_freqs[(c.term.field, c.term.text)], stats[c.term.field],
                c.boost,
            )
    row = (wrow, orow, rq.n_required, rq.effective_min_should(), rq.match_all, rq.boost)
    if plan is not None:
        plan.clause_row = row
    return row


def build_clause_tables(rqs, sim, doc_freqs, stats, b: int, t: int, plans=None):
    """Segment-independent per-batch tables: weights [b, t], occur kinds
    [b, t] (demote members OCC_DEMOTE), required-clause counts [b],
    min_should [b], match-all rows bool[b] and their constant scores
    f32[b]."""
    weight = np.zeros((b, t), dtype=np.float32)
    occur = np.zeros((b, t), dtype=np.int32)
    n_required = np.zeros(b, dtype=np.int32)
    min_should = np.ones(b, dtype=np.int32)
    match_all_rows = np.zeros(b, dtype=bool)
    boosts = np.ones(b, dtype=np.float32)
    for i, rq in enumerate(rqs):
        wrow, orow, nreq, msm, ma, bo = clause_row_for(
            rq, sim, doc_freqs, stats, plans[i] if plans else None
        )
        n_required[i] = nreq
        min_should[i] = msm
        match_all_rows[i] = ma
        boosts[i] = bo
        weight[i, : len(wrow)] = wrow
        occur[i, : len(orow)] = orow
    return weight, occur, n_required, min_should, match_all_rows, boosts


def leaf_rows_for(leaf, rq, plan=None):
    """One row's per-segment term resolution (block ranges, norms rows,
    doc_freqs, tf-plane rows), cached on the plan per leaf identity.
    ``pslot`` is -1 for a term without a plane row (or absent);
    ``plane_ok`` says every term present in the leaf has one. Read the
    plane rows after the leaf's device form is built."""
    lid = id(leaf)
    if plan is not None:
        row = plan.leaf_rows.get(lid)
        if row is not None:
            return row
    slots = rq.all_slots()
    bs = np.zeros(len(slots), np.int32)
    bc = np.zeros(len(slots), np.int32)
    fid = np.zeros(len(slots), np.int32)
    df = np.zeros(len(slots), np.int32)
    pslot = np.full(len(slots), -1, np.int32)
    plane_slots = getattr(leaf, "plane_slots", None)
    plane_ok = True
    for j, (_occ, c) in enumerate(slots):
        rec = leaf.term_record(c.term.field, c.term.text)
        if rec is None:
            continue
        bs[j] = rec.block_start
        bc[j] = rec.block_count
        fid[j] = leaf.packed.fields[c.term.field].field_id
        df[j] = rec.doc_freq
        ps = plane_slots.get(rec.block_start) if plane_slots else None
        if ps is None:
            plane_ok = False
        else:
            pslot[j] = ps
    row = dict(bs=bs, bc=bc, fid=fid, df=df, pslot=pslot, plane_ok=plane_ok)
    if plan is not None:
        plan.leaf_rows[lid] = row
    return row


def build_leaf_tables(leaf, rqs, b: int, t: int, plans=None):
    """Per-segment term resolution: block ranges + norms-row ids."""
    block_start = np.zeros((b, t), dtype=np.int32)
    block_count = np.zeros((b, t), dtype=np.int32)
    field_id = np.zeros((b, t), dtype=np.int32)
    for i, rq in enumerate(rqs):
        row = leaf_rows_for(leaf, rq, plans[i] if plans else None)
        n = len(row["bs"])
        block_start[i, :n] = row["bs"]
        block_count[i, :n] = row["bc"]
        field_id[i, :n] = row["fid"]
    return block_start, block_count, field_id


def build_flat_work(block_start, block_count, weight, field_id, occur):
    """Flatten [B,T] slot tables into the executor's block work list: one
    entry per (query, clause, block), rows ascending. At least one item
    (an invalid one when nothing matches), so device shapes never vanish."""
    b, t = block_start.shape
    enc_slot = (
        np.where((occur == int(Occur.MUST)) | (occur == int(Occur.FILTER)), ENC_REQUIRED, 0)
        + np.where(occur == int(Occur.SHOULD), ENC_SHOULD, 0)
        + np.where(occur == int(Occur.MUST_NOT), ENC_NOT, 0)
        + np.where(occur == OCC_DEMOTE, ENC_DEMOTE, 0)
    ).astype(np.int32)

    bs = block_start.ravel()
    bc = block_count.ravel()
    sel = bc > 0
    bs, bc = bs[sel], bc[sel]
    rows = np.repeat(np.arange(b, dtype=np.int32), t)[sel]
    wsl = weight.ravel()[sel]
    fid = field_id.ravel()[sel]
    enc = enc_slot.ravel()[sel]

    n = int(bc.sum())
    item_slot = np.repeat(np.arange(len(bc)), bc)
    start_of = np.concatenate([[0], np.cumsum(bc)])[:-1]
    within = np.arange(n) - start_of[item_slot]
    slot_flat = np.flatnonzero(sel)  # original (row*t + tslot) per slot

    w = max(n, 1)
    wi_block = np.zeros(w, np.int32)
    wi_row = np.zeros(w, np.int32)
    wi_weight = np.zeros(w, np.float32)
    wi_fid = np.zeros(w, np.int32)
    wi_enc = np.zeros(w, np.int32)
    wi_valid = np.zeros(w, bool)
    wi_tslot = np.zeros(w, np.int32)  # clause index (conjunction pruning)
    wi_block[:n] = bs[item_slot] + within
    wi_row[:n] = rows[item_slot]
    wi_weight[:n] = wsl[item_slot]
    wi_fid[:n] = fid[item_slot]
    wi_enc[:n] = enc[item_slot]
    wi_valid[:n] = True
    wi_tslot[:n] = (slot_flat % t)[item_slot]
    return wi_block, wi_row, wi_weight, wi_fid, wi_enc, wi_valid, n, wi_tslot


def prune_conjunctions(work, n_required: np.ndarray, blk_ranges):
    """EXACT conjunction pruning: drop work items whose block doc-range
    cannot overlap some required (MUST/FILTER) clause of the same query
    (the batched analog of the reference's skip-list leapfrog). A doc in a
    dropped block fails that required clause, so results are unchanged.

    work: the 8-tuple from build_flat_work; blk_ranges = (blk_first_doc,
    blk_last_doc) host arrays. Returns a (possibly) smaller 8-tuple plus
    the number of dropped items."""
    wi_block, wi_row, wi_weight, wi_fid, wi_enc, wi_valid, n_items, wi_tslot = work

    if n_items == 0 or not (np.asarray(n_required) >= 1).any():
        return work, 0
    blk_first, blk_last = blk_ranges
    n = n_items
    blk = wi_block[:n]
    row = wi_row[:n]
    slot = wi_tslot[:n]
    enc = wi_enc[:n]

    starts = blk_first[blk].astype(np.int64)
    ends = blk_last[blk].astype(np.int64)

    is_req = (enc >> 16) > 0  # bits 16+ carry the required count
    keep = np.ones(n, bool)
    # wi_row ascending (build_flat_work order): row segments are contiguous
    row_starts = np.searchsorted(row, np.arange(len(n_required)), side="left")
    row_ends = np.searchsorted(row, np.arange(len(n_required)), side="right")
    for r in np.flatnonzero(np.asarray(n_required) >= 1):
        lo, hi = int(row_starts[r]), int(row_ends[r])
        if hi - lo < 1:
            continue
        slots_r = slot[lo:hi]
        req_slots = np.unique(slots_r[is_req[lo:hi]])
        if len(req_slots) < int(n_required[r]):
            # a required term is absent from this view: the row cannot match
            keep[lo:hi] = False
            continue
        if len(req_slots) == 0 or hi - lo <= 1:
            continue
        for t in req_slots:
            m = slots_r == t
            f = starts[lo:hi][m]  # ascending (runs are block/doc ordered)
            lmax = np.maximum.accumulate(ends[lo:hi][m])
            others = np.flatnonzero(~m)
            if len(others) == 0:
                continue
            # survive iff some interval of clause t overlaps [start, end]:
            # last interval with f <= end must reach back past start
            j = np.searchsorted(f, ends[lo:hi][others], side="right") - 1
            ok = (j >= 0) & (lmax[np.maximum(j, 0)] >= starts[lo:hi][others])
            keep[lo + others] &= ok
    dropped = int(n - keep.sum())
    if dropped == 0:
        return work, 0
    METRICS.incr("search.conj_pruned_blocks", dropped)
    idx = np.flatnonzero(keep)
    m = len(idx)
    w = max(m, 1)
    out = (
        np.zeros(w, np.int32),
        np.zeros(w, np.int32),
        np.zeros(w, np.float32),
        np.zeros(w, np.int32),
        np.zeros(w, np.int32),
        np.zeros(w, bool),
    )
    out[0][:m] = wi_block[idx]
    out[1][:m] = wi_row[idx]
    out[2][:m] = wi_weight[idx]
    out[3][:m] = wi_fid[idx]
    out[4][:m] = wi_enc[idx]
    out[5][:m] = True
    tslot = np.zeros(w, np.int32)
    tslot[:m] = wi_tslot[idx]
    return out + (m, tslot), dropped


def dedupe_work(wi_block, wi_valid, wi_fid):
    """Distinct-block decode tables: Zipf query mixes repeat hot terms
    across rows, so the same blocks appear in many work items; decode each
    once ([D] axis) and let the items gather its lanes. Returns (wi_ublock
    i32[D], wi_uvalid bool[D], wi_ufid i32[D], wi_inv i32[W]), or None when
    no block repeats. D is the exact distinct count. A block belongs to one
    field, so the fid of its first item is every item's."""
    n = int(wi_valid.sum())
    if n == 0:
        return None
    vb = wi_block[:n]
    ub, first_idx = np.unique(vb, return_index=True)
    if len(ub) == n:
        return None
    inv = np.zeros(len(wi_block), np.int32)
    inv[:n] = np.searchsorted(ub, vb)
    METRICS.incr("search.decode_dedup_items", n - len(ub))
    return (
        ub.astype(np.int32), np.ones(len(ub), bool),
        wi_fid[:n][first_idx].astype(np.int32), inv,
    )


# of a device form's norm_dec / norms tensor, keyed by the stats' bytes
_CVAL_CACHE = DerivedCache(8)
_CVAL_PLANE_CACHE = DerivedCache(8)


def cval_table_for(dev, cache: np.ndarray) -> torch.Tensor | None:
    """f32[NB,128] BM25 denominators cache[fid, norm_byte] per resident
    lane, built once per (device segment, stats); None for a packed
    segment."""
    if dev.norm_dec is None:
        return None
    key = cache.tobytes()
    tbl = _CVAL_CACHE.get((dev.norm_dec,), key)
    if tbl is None:
        cache_flat = torch.from_numpy(cache.reshape(-1)).to(dev.device)
        idx = dev.blk_fid.long()[:, None] * 256 + dev.norm_dec.long()
        tbl = _CVAL_CACHE.put((dev.norm_dec,), key, cache_flat[idx])
    return tbl


def cval_plane_for(dev, cache: np.ndarray) -> torch.Tensor:
    """f32[F, MDp] BM25 denominators per doc for the tf-plane executor:
    ``cache[f, norms[f, d]]``, bit-identical to the lane path's per-lane
    lookup (same table, same norm byte). Built once per (norms plane,
    stats)."""
    key = cache.tobytes()
    planes = _CVAL_PLANE_CACHE.get((dev.norms,), key)
    if planes is None:
        tbl = torch.from_numpy(np.ascontiguousarray(cache, np.float32)).to(dev.device)
        planes = _CVAL_PLANE_CACHE.put((dev.norms,), key, torch.gather(tbl, 1, dev.norms.long()))
    return planes


def _to(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def make_flat_batch(work, n_required, min_should, cache, dev, dedupe: bool = False) -> FlatQueryBatch:
    """Device FlatQueryBatch from a host work tuple (build_flat_work /
    prune_conjunctions output), on ``dev``'s device with its cval table
    (decoded segments). dedupe=True attaches the decode-dedup tables on a
    packed segment only: on a decoded one a decode is one row gather and
    the host's unique / searchsorted costs more than it saves
    (RUCENE_DEDUP=1 forces them there too)."""
    wi_block, wi_row, wi_weight, wi_fid, wi_enc, wi_valid = work[:6]
    if dedupe and dev.docs_dec is not None:
        dedupe = os.environ.get("RUCENE_DEDUP") == "1"
    dd = dedupe_work(wi_block, wi_valid, wi_fid) if dedupe else None
    d = dev.device
    ub, uvalid, ufid, inv = (None,) * 4 if dd is None else (_to(a, d) for a in dd)
    return FlatQueryBatch(
        wi_block=_to(wi_block, d), wi_row=_to(wi_row, d),
        wi_weight=_to(wi_weight, d), wi_fid=_to(wi_fid, d),
        wi_enc=_to(wi_enc, d), wi_valid=_to(wi_valid, d),
        n_required=_to(n_required, d), min_should=_to(min_should, d),
        cache=_to(cache, d), wi_ublock=ub, wi_uvalid=uvalid, wi_ufid=ufid,
        wi_inv=inv, cval_dec=cval_table_for(dev, cache),
    )


def residue_passes(residue, wi_row, wi_block, blk_first, blk_last):
    """The dense branch's residue items (ascending item ids) split into
    passes that it can add without float atomics: within a pass no two
    lanes reach one (row, doc) slot, and two items of one row whose doc
    ranges overlap fall in passes in item order. A row's items open a new
    pass where an item's first doc is not past the previous item's last
    doc; the blocks of one clause rise, so a row takes at most one pass a
    clause. Returns (items ordered by (pass, item), host offsets of each
    pass)."""
    if not len(residue):
        return residue, (0,)
    blk = wi_block[residue]
    row = wi_row[residue]
    new_row = np.r_[True, row[1:] != row[:-1]]
    run = np.cumsum(new_row | np.r_[True, blk_first[blk[1:]] <= blk_last[blk[:-1]]]) - 1
    row_head = np.maximum.accumulate(np.where(new_row, np.arange(len(residue)), 0))
    pas = run - run[row_head]
    order = np.argsort(pas, kind="stable")
    ptr = np.searchsorted(pas[order], np.arange(int(pas.max()) + 2))
    return residue[order], tuple(int(x) for x in ptr)


def _put_async(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An upload that leaves the host free: from pinned memory, not
    waited for, on a card; a plain tensor on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def build_combine_batch(arrays, b: int, blk_first, blk_last, mdp: int, device,
                        q: FlatQueryBatch | None = None, buckets=None):
    """Dense-combine entry tables, one CombineBatch per 32-row chunk:
    entries (work item x overlapped C_BUCKET doc bucket) sorted by bucket,
    with per-bucket offsets, as the combine kernel walks them.
    Items overlapping more than SPARSE_SPAN buckets go to the residue
    (global rows), split into passes (residue_passes).

    One pass for every chunk. The host reads each item's bucket span from
    ``buckets`` (codec/device.block_buckets of ``blk_first`` /
    ``blk_last``; a device form's own, else built here), counts each
    chunk's entries and picks the residue. The device expands the dense
    items into entries, keys each by (chunk, bucket) and sorts the keys
    stably, so a bucket's entries keep work-list item order (the order of
    ops/combine_tables' builder); each chunk's tables are views of the one
    sorted array. ``q`` (make_flat_batch of ``arrays``) lends its device
    copy of the work list; without it the list is uploaded. The work
    list's rows ascend (build_flat_work). Every size comes from the host,
    so nothing here waits for the device."""
    from rucene_tpu_torch.codec.device import block_buckets
    from rucene_tpu_torch.ops.combine_tables import MAX_ROWS, SPARSE_SPAN
    from rucene_tpu_torch.ops.cuda_combine import C_BUCKET

    if mdp % C_BUCKET:
        raise ValueError(f"doc axis {mdp} is not a multiple of {C_BUCKET}")
    d = torch.device(device)
    wi_block, wi_row, _w, _f, wi_enc, wi_valid = arrays
    if buckets is None:
        buckets = block_buckets(blk_first, blk_last, d)
    if q is None:
        d_block, d_row, d_enc, d_valid = (
            _put_async(a, d) for a in (wi_block, wi_row, wi_enc, wi_valid)
        )
    else:
        d_block, d_row, d_enc, d_valid = q.wi_block, q.wi_row, q.wi_enc, q.wi_valid
    n_buckets = mdp // C_BUCKET
    n_chunks = -(-b // MAX_ROWS)

    # host: each chunk's items and entries, and the residue
    span = np.where(wi_valid, buckets.span[wi_block], 0)
    reps = np.where(span <= SPARSE_SPAN, span, 0)
    residue = np.flatnonzero(span > SPARSE_SPAN)
    item_ptr = np.searchsorted(wi_row, np.arange(n_chunks + 1) * MAX_ROWS)
    entry_ptr = np.zeros(len(reps) + 1, np.int64)
    np.cumsum(reps, dtype=np.int64, out=entry_ptr[1:])
    entry_ptr = entry_ptr[item_ptr]
    n_entries = int(entry_ptr[-1])
    METRICS.incr("search.combine_entries", n_entries)
    METRICS.incr("search.combine_residue_items", len(residue))

    # device: one entry per (dense item, overlapped bucket), sorted by (chunk, bucket)
    span_d = buckets.span_d.index_select(0, d_block).to(torch.int32)
    reps_d = torch.where(d_valid & (span_d <= SPARSE_SPAN), span_d, 0)
    item = torch.repeat_interleave(reps_d, output_size=n_entries)
    first_entry = torch.cumsum(reps_d, 0, dtype=torch.int32) - reps_d
    within = (torch.arange(n_entries, dtype=torch.int32, device=d)
              - first_entry.index_select(0, item))
    bucket = buckets.first.index_select(0, d_block.index_select(0, item)) + within
    row = d_row.index_select(0, item)
    key, order = torch.sort(torch.div(row, MAX_ROWS, rounding_mode="floor") * n_buckets + bucket,
                            stable=True)
    e_item = item.index_select(0, order)
    e_row = torch.remainder(row.index_select(0, order), MAX_ROWS)
    e_enc = d_enc.index_select(0, e_item)
    ptr = torch.searchsorted(
        key, torch.arange(n_chunks * n_buckets + 1, dtype=torch.int32, device=d), out_int32=True
    ).unfold(0, n_buckets + 1, n_buckets)
    bucket_ptr = ptr - ptr[:, :1]  # row c: chunk c's offsets, rebased to its first entry

    # host: each chunk's residue in passes, uploaded once
    res_ptr = np.searchsorted(residue, item_ptr)
    passes = [
        residue_passes(residue[res_ptr[c]:res_ptr[c + 1]], wi_row, wi_block, blk_first, blk_last)
        for c in range(n_chunks)
    ]
    residue_d = (
        _put_async(np.concatenate([items for items, _ in passes]), d) if len(residue)
        else torch.zeros(0, dtype=torch.int64, device=d)
    )
    return tuple(
        CombineBatch(
            bucket_ptr=bucket_ptr[c],
            e_item=e_item[entry_ptr[c]:entry_ptr[c + 1]],
            e_row=e_row[entry_ptr[c]:entry_ptr[c + 1]],
            e_enc=e_enc[entry_ptr[c]:entry_ptr[c + 1]],
            residue=residue_d[res_ptr[c]:res_ptr[c + 1]],
            row_lo=c * MAX_ROWS,
            residue_ptr=ptrs,
        )
        for c, (_, ptrs) in enumerate(passes)
    )


def build_range_filter_tables(rqs, b: int):
    """A batch's range, exists and prefix clauses as distinct filter keys
    and [b, R] slot tables (plane index, occur encoding, constant score),
    R the most range clauses of a row. Rows without ranges carry idx -1
    (inert). Returns (keys: a representative RangeClause per distinct
    cache_key, idx, enc, boost)."""
    keys: list = []
    key_pos: dict[tuple, int] = {}
    for rq in rqs:
        for r in rq.ranges:
            if r.cache_key not in key_pos:
                key_pos[r.cache_key] = len(keys)
                keys.append(r)
    r_slots = max(max((len(rq.ranges) for rq in rqs), default=1), 1)
    idx = np.full((b, r_slots), -1, np.int32)
    enc = np.zeros((b, r_slots), np.int32)
    boost = np.zeros((b, r_slots), np.float32)
    for i, rq in enumerate(rqs):
        for j, r in enumerate(rq.ranges):
            idx[i, j] = key_pos[r.cache_key]
            if r.occur in (Occur.MUST, Occur.FILTER):
                enc[i, j] = ENC_REQUIRED
            elif r.occur == Occur.SHOULD:
                enc[i, j] = ENC_SHOULD
            else:
                enc[i, j] = ENC_NOT
            if r.occur in (Occur.MUST, Occur.SHOULD):
                boost[i, j] = np.float32(r.boost)  # constant score
    return keys, idx, enc, boost


def build_leaf_cache(leaf, sim, stats) -> np.ndarray:
    """Per-segment [F,256] norm-byte -> BM25 denominator cache."""
    packed = leaf.packed
    n_fields = max((pf.field_id for pf in packed.fields.values()), default=-1) + 1
    cache = np.zeros((max(n_fields, 1), 256), dtype=np.float32)
    for name, pf in packed.fields.items():
        has_norms = name in packed.norms
        cache[pf.field_id] = sim.cache_row(stats.get(name) if has_norms else None)
    return cache

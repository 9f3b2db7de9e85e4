"""Host-side tables for the pair-gallop boolean executor. A copy of
rucene_tpu/search/pair_path.py.

The reference evaluates AND/OR of two terms with a doc-at-a-time
iterator leapfrog over skip lists (rucene
src/core/search/scorer/conjunction_scorer.rs, disjunction_scorer.rs:24,
skip_reader.rs:118). The batched analog (executor.execute_flat_pair)
keeps owner lanes — the DENSER clause's blocks, plus the sparser
clause's blocks for OR — and resolves each owner lane's membership in
the other list with a broadcast compare against the few probe blocks
overlapping its own block. This module builds the owner work list and
the per-item [MAXP] probe-slot table from host-resident block doc-range
metadata (the same structure skip lists encode), with vectorized numpy.

Eligibility (pair2_eligible): rows of exactly two positive term clauses
(MUST+MUST, or SHOULD+SHOULD with effective min_should <= 1), plain (no
dismax/const/demote), no ranges/phrases/groups, decoded-residency
devices. Rows whose probe-slot count exceeds MAXP_CAP (pathological
local density inversion) are reported back for old-path fallback.

Port changes:
- build_pair_work: no pow2 pads. The work list holds exactly its owner
  items (at least one), the probe-slot table is [W, MAXP] with MAXP the
  largest slot count kept, and max_lanes_p / max_lanes_s are the largest
  extents' items times 128. The pads only kept XLA shapes reusable; the
  port's probe (a searchsorted over each item's window) wants the window
  no wider than it is.
"""

from __future__ import annotations

import numpy as np

from rucene_tpu_torch.search.query import Occur
from rucene_tpu_torch.util import next_pow2

MAXP_CAP = 16  # per-owner-block probe-slot cap; beyond -> row falls back


def pair2_eligible(rq, weight_row) -> bool:
    """One row's eligibility (weights must be resolvable: positive for
    scoring slots). weight_row: f32[t_pad] for this row."""
    if (
        not rq.plain
        or rq.match_all
        or rq.ranges
        or rq.phrases
        or rq.groups
        or len(rq.clauses) != 2
    ):
        return False
    occs = [c.occur for c in rq.clauses]
    if all(o == Occur.SHOULD for o in occs):
        if rq.effective_min_should() > 1:
            return False
    elif all(o == Occur.MUST for o in occs):
        # min_should_match > 0 with zero SHOULD clauses matches nothing
        # (boolean_query.rs min_should semantics) — not modeled here
        if rq.effective_min_should() != 0:
            return False
    else:
        return False
    return bool(weight_row[0] > 0 and weight_row[1] > 0)


def build_pair_work(leaf, rqs, weight, field_id, block_start, block_count,
                    b_pad: int | None = None):
    """Owner work list + probe-slot tables for one leaf.

    Returns (work_tuple, pair_host, bad_rows): work_tuple feeds
    make_flat_batch (wi_block..wi_valid, n, wi_tslot); pair_host is a
    dict matching executor.PairBatch plus static max_lanes_p/max_lanes_s;
    bad_rows lists row indices whose slot count exceeded MAXP_CAP (their
    extents are omitted — the caller must serve them another way)."""
    b = b_pad or next_pow2(max(len(rqs), 1), 1)
    blk_first = leaf.packed.blk_first_doc
    blk_last = leaf.packed.blk_last_doc

    ext = []  # (row, start_blk, count, weight, fid, mode, pw, ps, pc)
    bad_rows: list[int] = []
    for i, rq in enumerate(rqs):
        s0 = int(block_start[i, 0])
        c0 = int(block_count[i, 0])
        s1 = int(block_start[i, 1])
        c1 = int(block_count[i, 1])
        w0 = float(weight[i, 0])
        w1 = float(weight[i, 1])
        f0 = int(field_id[i, 0])
        f1 = int(field_id[i, 1])
        is_and = rq.clauses[0].occur == Occur.MUST
        # denser clause owns the probing extent (narrow block spans bound
        # the probe-slot count); the sparser is the probe / partial side
        if c1 > c0:
            (sd, cd, wd, fd), (ss, cs, ws, fs) = (s1, c1, w1, f1), (s0, c0, w0, f0)
        else:
            (sd, cd, wd, fd), (ss, cs, ws, fs) = (s0, c0, w0, f0), (s1, c1, w1, f1)
        if is_and:
            if c0 == 0 or c1 == 0:
                continue  # a required term is absent: row matches nothing
            ext.append((i, sd, cd, wd, fd, 3, ws, ss, cs))
        else:
            if cd > 0:
                ext.append((i, sd, cd, wd, fd, 1, ws if cs else 0.0, ss, cs))
            if cs > 0:
                ext.append((i, ss, cs, ws, fs, 2, 0.0, 0, 0))

    # probe-slot ranges per probing extent (vectorized per extent)
    slot_lo = []
    slot_n = []
    maxp = 1
    for (_i, s, c, _w, _f, _mode, _pw, ps, pc) in ext:
        if pc > 0:
            lo = np.searchsorted(blk_last[ps : ps + pc], blk_first[s : s + c],
                                 side="left")
            hi = np.searchsorted(blk_first[ps : ps + pc], blk_last[s : s + c],
                                 side="right")
            n = np.maximum(hi - lo, 0).astype(np.int32)
            slot_lo.append(ps + lo.astype(np.int32))
            slot_n.append(n)
            mx = int(n.max()) if c else 0
            maxp = max(maxp, min(mx, MAXP_CAP + 1))
        else:
            slot_lo.append(np.zeros(c, np.int32))
            slot_n.append(np.zeros(c, np.int32))
    overflow = [
        e[0] for e, n in zip(ext, slot_n) if len(n) and int(n.max()) > MAXP_CAP
    ]
    if overflow:
        bad = set(overflow)
        bad_rows = sorted(bad)
        keep = [j for j, e in enumerate(ext) if e[0] not in bad]
        ext = [ext[j] for j in keep]
        slot_lo = [slot_lo[j] for j in keep]
        slot_n = [slot_n[j] for j in keep]
        maxp = max(
            [1] + [int(n.max()) for n in slot_n if len(n)]
        )
    maxp = max(maxp, 1)

    n_items = sum(e[2] for e in ext)
    w_pad = max(n_items, 1)
    work = (
        np.zeros(w_pad, np.int32),
        np.zeros(w_pad, np.int32),
        np.zeros(w_pad, np.float32),
        np.zeros(w_pad, np.int32),
        np.zeros(w_pad, np.int32),
        np.zeros(w_pad, bool),
        n_items,
        np.zeros(w_pad, np.int32),
    )
    oi_mode = np.zeros(w_pad, np.int32)
    oi_pw = np.zeros(w_pad, np.float32)
    pr_slots = np.full((w_pad, maxp), -1, np.int32)
    row_p = np.zeros((b, 2), np.int32)
    row_s = np.zeros((b, 2), np.int32)
    pos = 0
    for (ri, s, c, wgt, fid, mode, pw, _ps, _pc), lo, n in zip(
        ext, slot_lo, slot_n
    ):
        work[0][pos : pos + c] = np.arange(s, s + c, dtype=np.int32)
        work[1][pos : pos + c] = ri
        work[2][pos : pos + c] = wgt
        work[3][pos : pos + c] = fid
        work[5][pos : pos + c] = True
        oi_mode[pos : pos + c] = mode
        oi_pw[pos : pos + c] = pw
        if len(n) and n.max() > 0:
            # slots: lo[j] .. lo[j]+n[j) per item j, padded -1
            cols = np.arange(maxp, dtype=np.int32)[None, :]
            mat = lo[:, None] + cols
            mat = np.where(cols < n[:, None], mat, -1)
            pr_slots[pos : pos + c] = mat
        if mode == 2:
            row_s[ri] = (pos, c)
        else:
            row_p[ri] = (pos, c)
        pos += c

    max_p = int(row_p[:, 1].max()) if len(ext) else 0
    max_s = int(row_s[:, 1].max()) if len(ext) else 0
    pair_host = dict(
        oi_mode=oi_mode,
        oi_pw=oi_pw,
        pr_slots=pr_slots,
        row_p_start=row_p[:, 0].copy(),
        row_p_items=row_p[:, 1].copy(),
        row_s_start=row_s[:, 0].copy(),
        row_s_items=row_s[:, 1].copy(),
        max_lanes_p=max(max_p, 1) * 128,
        max_lanes_s=max_s * 128,
    )
    return work, pair_host, bad_rows

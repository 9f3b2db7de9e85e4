"""Exact top-k, ordered (score desc, doc asc).

Counterpart of rucene_tpu/ops/topk.py: ``topk_score_doc`` (dense score
rows), ``stable_top_k`` and ``extent_top_k_lanes`` (per-row top-k over
work-item extents of a [W, 128] lane grid). ``torch.topk`` promises no
order among equal values, so each (score, doc) pair becomes one distinct
int64 key: the score's order-preserving int32 bits in the high half,
``2^31 - 1 - doc`` in the low half. A larger key is a better hit, no two
keys are equal, and ``torch.topk`` over the keys is exact by
construction. The reference's f32 / i32 ``_distinct_keys`` and its
value-then-selection passes work around TPU top-k tie faults and have no
counterpart.

Every dense top-k goes through ``exact_top_k``, the reference's block-max
candidate pass: each row's 256-doc chunk maxima pick the top-k chunks by
(max desc, chunk asc), and the exact selection runs over those k * 256
columns only (128-doc chunks when k > 128), plus the ``n % chunk`` tail.
The candidate set holds the true top-k: were a winner w in a chunk not
picked, each of the k picked chunks would hold a hit beating w (a higher
score, or an equal one at a lower column, since a picked chunk of equal
max lies before w's), k hits in all. Each candidate is keyed with its
original column, so one ``torch.topk`` over the candidates is the answer
and needs no index map. The engagement rules are the reference's, so
both packages take the same branch at the same shape: rows of
``_FAST_MIN_N`` columns or more, when the k chunks cover under half the
row. The reference's ``RUCENE_FAST_TOPK=0`` switch, an A/B knob with
the same results, has no counterpart.
"""

from __future__ import annotations

import torch

DOC_PAD = 2**31 - 1
_FAST_MIN_N = 32_768  # the chunk pass engages from this row width
_CHUNK = 256  # docs a chunk (128 when k > 128)


def _score_order_bits(scores: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 whose order is the floats' order (-0.0 maps to +0.0;
    -inf is the least finite-or-infinite key)."""
    bits = (scores + 0.0).contiguous().view(torch.int32).long()
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def score_doc_keys(scores: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Distinct int64 keys ordering hits by (score desc, doc asc) when
    sorted descending; docs must lie in [0, 2^31 - 1]."""
    return (_score_order_bits(scores) << 32) | (DOC_PAD - docs.long())


def topk_score_doc(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """scores: f32[B, N] with -inf for non-matching docs; doc id == column.

    Returns (top_scores f32[B,k], top_docs i32[B,k]); slots beyond the number
    of matches hold (-inf, 2^31-1)."""
    vals, idx = exact_top_k(scores, k)
    return _pad_to_k(vals, torch.where(vals > -torch.inf, idx, DOC_PAD), k)


def stable_top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over f32[B, N] ordered (value desc, index asc). Returns
    (vals f32[B, kk], idx i32[B, kk]) with kk = min(k, N)."""
    n = scores.shape[1]
    cols = torch.arange(n, device=scores.device)
    _, idx = torch.topk(score_doc_keys(scores, cols), min(k, n), dim=1)
    return torch.gather(scores, 1, idx), idx.to(torch.int32)


def _chunk(kk: int) -> int:
    return _CHUNK if kk <= 128 else 128


def chunk_pass_engages(n: int, k: int) -> bool:
    """Whether exact_top_k takes its chunk pass over rows of n columns at
    k (the reference's rules): n >= _FAST_MIN_N and the k chunks cover
    under half the row."""
    kk = min(k, n)
    chunk = _chunk(kk)
    return not (n < _FAST_MIN_N or kk >= n // chunk or kk * chunk * 2 >= n)


def exact_top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """stable_top_k through the block-max chunk pass on wide rows (module
    docstring); bit-equal to stable_top_k at every shape. Returns (vals
    f32[B, kk], idx i32[B, kk]) with kk = min(k, N)."""
    b, n = scores.shape
    kk = min(k, n)
    if not chunk_pass_engages(n, kk):
        return stable_top_k(scores, kk)
    chunk = _chunk(kk)
    c = n // chunk
    dvc = scores.device
    cmax = scores[:, : c * chunk].reshape(b, c, chunk).amax(dim=2)  # [B, C]
    cj = torch.arange(c, device=dvc).expand(b, c)
    _, cidx = torch.topk(score_doc_keys(cmax, cj), kk, dim=1)  # (max desc, chunk asc)
    cidx = torch.sort(cidx, dim=1).values
    cols = (cidx[:, :, None] * chunk + torch.arange(chunk, device=dvc)).reshape(b, kk * chunk)
    if n > c * chunk:  # the tail pseudo-chunk
        cols = torch.cat([cols, torch.arange(c * chunk, n, device=dvc).expand(b, n - c * chunk)], 1)
    cand = torch.gather(scores, 1, cols)
    _, j = torch.topk(score_doc_keys(cand, cols), kk, dim=1)
    return torch.gather(cand, 1, j), torch.gather(cols, 1, j).to(torch.int32)


def _pad_to_k(vals: torch.Tensor, docs: torch.Tensor, k: int):
    """Widen [B, kk] results to [B, k] with (-inf, 2^31 - 1) slots."""
    b, kk = vals.shape
    if kk < k:
        vals = torch.cat([vals, vals.new_full((b, k - kk), -torch.inf)], dim=1)
        docs = torch.cat([docs, docs.new_full((b, k - kk), DOC_PAD)], dim=1)
    return vals, docs


def extent_top_k_lanes(
    score: torch.Tensor,
    docm: torch.Tensor,
    start: torch.Tensor,
    items: torch.Tensor,
    max_items: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-row top-k over contiguous work-item extents of flat lane
    arrays: row r owns items ``start[r] : start[r] + items[r]``. Selection
    runs at item granularity first, so the [B, max_items * 128] row view is
    never built:

      1. the per-item lane max ([W]);
      2. per row, the top-min(k, max_items) items by (max desc, item asc)
         over its [max_items] item-max view. Any item holding a true top-k
         hit is among them: otherwise each chosen item would hold a hit
         beating it, k hits in all;
      3. those items' lanes ([B, ksel * 128]), selected by the distinct
         (score, doc) keys.

    score/docm: [W, 128], non-matching lanes at (-inf, 2^31 - 1), docs
    distinct within a row; start/items: int[B]. Returns (scores f32[B, k],
    docs i32[B, k]) padded with (-inf, 2^31 - 1)."""
    w = score.shape[0]
    b = start.shape[0]
    dvc = score.device
    mi = max(max_items, 1)
    ksel = min(k, mi)
    j = torch.arange(mi, device=dvc)
    start = start.long()
    items = items.long()
    if w == 0:
        cand_s = torch.full((b, 0), -torch.inf, device=dvc)
        cand_d = torch.full((b, 0), DOC_PAD, dtype=torch.int32, device=dvc)
    else:
        cmax = score.max(dim=1).values
        in_row = j[None, :] < items[:, None]
        gi = (start[:, None] + j[None, :]).clamp(0, w - 1)
        crows = torch.where(in_row, cmax[gi], -torch.inf)  # [B, mi]
        _, cidx = torch.topk(score_doc_keys(crows, j.expand(b, mi)), ksel, dim=1)
        cidx = torch.sort(cidx, dim=1).values  # doc-ascending candidate layout
        sel_ok = (cidx < items[:, None])[:, :, None]
        gi = (start[:, None] + cidx).clamp(0, w - 1)
        cand_s = torch.where(sel_ok, score[gi], -torch.inf).reshape(b, ksel * 128)
        cand_d = torch.where(sel_ok, docm[gi], DOC_PAD).reshape(b, ksel * 128)
    kk = min(k, cand_s.shape[1])
    _, tj = torch.topk(score_doc_keys(cand_s, cand_d), kk, dim=1)
    ts = torch.gather(cand_s, 1, tj)
    td = torch.where(ts > -torch.inf, torch.gather(cand_d, 1, tj), DOC_PAD).to(torch.int32)
    return _pad_to_k(ts, td, k)

"""Ordered segmented f32 sum (csrc/ordered_sum.cu) and its plain twin.

The port's summation rule: the f32 score of a (row, doc) is +0.0 plus each
of its contributions, added in work-list item order (row, clause, block),
one rounding an add. The executor sorts a batch's lanes stably by their
(row, doc) slot, so each slot's lanes form one contiguous group in item
order; ``segment_sum_ordered`` sums each group left to right, and
``grouped_sums_ordered`` sorts lanes by key and sums each key's group. They
serve the flat executor's candidate branch (search/executor.py) and the
candidate profiler (drivers/profile_candidate.py).

Not a TPU kernel's counterpart: the reference's XLA scatters and scans
add in a fixed order by themselves, while on the card index_add_,
index_put_(accumulate=True) and scatter_add_ add with float atomics in an
order that changes from run to run.

Bound: device-memory bytes (min_bytes): each lane's value and start flag
read once, each group's sum written once. The group ids the wrapper passes
are a convenience (they follow from the flags by a scan) and are not
counted. A CPU tensor goes to the plain
twin (an index_add_ on the CPU, which adds in index order); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from rucene_tpu_torch.util.metrics import METRICS

LAUNCH_COUNTER = "kernel.segment_sum_ordered"


def group_ids(seg_start: torch.Tensor) -> torch.Tensor:
    """i64 group of each lane: 0 at lane 0, +1 at each later group start."""
    return torch.cumsum(seg_start, 0) - 1


def min_bytes(seg_start: torch.Tensor) -> int:
    """Device-memory bytes a segmented sum must move: each lane's f32 value
    and bool start flag, and each group's f32 sum."""
    groups = int(seg_start.sum())
    return seg_start.numel() * 5 + groups * 4


def segment_sum_ordered_plain(values, seg_start, gid=None):
    """The twin: out[g] = +0.0 + each value of group g in lane order (an
    index_add_ into zeros on the CPU, which adds in index order; tensors on
    another device go there and back, as index_add_ on the card adds with
    atomics); out has one slot a lane, 0 past the last group."""
    if gid is None:
        gid = group_ids(seg_start)
    out = torch.zeros(values.shape[0], dtype=values.dtype).index_add_(0, gid.cpu(), values.cpu())
    return out.to(values.device)


def segment_sum_ordered(values, seg_start, gid=None):
    """values f32[N] sorted so that each group is contiguous and in item
    order; seg_start bool[N] true at each group's first lane (lane 0
    included); gid i64[N] (group_ids(seg_start), computed when None).
    Returns f32[N]: each group's left-to-right sum from +0.0 at its group
    id, 0 in the slots past the last group."""
    n = values.shape[0]
    if gid is None:
        gid = group_ids(seg_start)
    if values.device.type == "cpu":
        return segment_sum_ordered_plain(values, seg_start, gid)
    from rucene_tpu_torch.ops.cuda_build import check, kernels

    if values.device.type != "cuda":
        raise ValueError(f"segment_sum_ordered: unsupported device {values.device}")
    for t, dt in ((values, torch.float32), (seg_start, torch.bool), (gid, torch.int64)):
        if (t.device != values.device or t.dtype != dt or tuple(t.shape) != (n,)
                or not t.is_contiguous()):
            raise ValueError("segment_sum_ordered: bad device, dtype, shape or layout")
    out = torch.zeros_like(values)
    if n == 0:
        return out
    rc = kernels().rtt_segment_sum_ordered(
        values.data_ptr(), seg_start.data_ptr(), gid.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    check(rc, "rtt_segment_sum_ordered")
    METRICS.incr(LAUNCH_COUNTER)
    return out


def grouped_sums_ordered(key, values, fill: int):
    """Lanes grouped by i64 ``key`` and summed in lane order: the lanes are
    sorted by key stably, so each key's lanes form one contiguous group in
    their input order, and each group is summed by segment_sum_ordered.
    A lane to be dropped must carry a key of its own, past every real key,
    so that no long group forms. Returns (g_key, perm, gid, sums): i64[N]
    each group's key at its group id (``fill`` past the last group), the
    sort permutation, each sorted lane's group id, and f32[N] each group's
    sum at its group id (0 past the last group)."""
    o_key, perm = torch.sort(key, stable=True)
    seg_start = torch.ones(key.numel(), dtype=torch.bool, device=key.device)
    seg_start[1:] = o_key[1:] != o_key[:-1]
    gid = group_ids(seg_start)
    sums = segment_sum_ordered(values[perm], seg_start, gid)
    g_key = torch.full_like(o_key, fill).scatter_(0, gid, o_key)
    return g_key, perm, gid, sums

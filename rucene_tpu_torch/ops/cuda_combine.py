"""Wrapper of the CUDA dense-combine kernel (csrc/combine.cu) and its twin.

Replaces rucene_tpu/ops/pallas_combine.py::combine_lanes_pallas: the dense
executor branch's accumulation of decoded lanes into per-row [rows,
max_doc] score and clause-count planes. Entries (work item x overlapped
doc bucket, from ops/combine_tables.py) arrive sorted by bucket;
``bucket_ptr[b]:bucket_ptr[b+1]`` are bucket b's entries, and each names
the item whose lanes it adds, read in place from the decode's [W, 128]
output.

Bound: device-memory bytes (min_bytes), mostly the rows x max_doc x 8
bytes of output. Each CTA zeroes a shared-memory tile of one bucket
(C_BUCKET docs) by up to 8 rows, gathers its group's entries of the
bucket into a shared list in entry order, and gives each tile row to one
warp, which adds that row's entries one after another with plain
shared-memory adds (four lanes a thread, 16-byte loads); the tile leaves
in 16-byte stores; six such CTAs share an SM, so one's write-out overlaps
another's adds. Summation rule: a (row, doc)'s score is +0.0 plus its
lanes in entry order, which within a bucket is work-list item order
(ops/combine_tables.py sorts entries by bucket stably), one rounding an
add; the twin follows the same rule (an index_add_ on the CPU), so the
two are bit-equal and a call is a fixed function of its input. C_BUCKET
is 512, half the TPU's 1024, and stays so: a smaller bucket would send
more items to the executor's residue (SPARSE_SPAN counts buckets) and
cost the host more entries. The bf16 three-limb split and one-hot matmuls
of the TPU kernel have no counterpart: scores add in f32 and counts in
int32.

A CPU tensor goes to the plain twin; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from rucene_tpu_torch.ops.combine_tables import MAX_ROWS
from rucene_tpu_torch.util.metrics import METRICS
from rucene_tpu_torch.util.packing import BLOCK_SIZE

LAUNCH_COUNTER = "kernel.combine_lanes"
C_BUCKET = 512  # docs per bucket; must divide codec/device.DOC_AXIS_MULTIPLE


def _check_out(out_score, out_counts, md):
    rows = out_score.shape[0]
    if (
        out_score.dtype != torch.float32 or out_counts.dtype != torch.int32
        or out_score.shape != (rows, md) or out_counts.shape != (rows, md)
        or rows > MAX_ROWS
        or not (out_score.is_contiguous() and out_counts.is_contiguous())
    ):
        raise ValueError("combine_lanes: out must be contiguous f32/i32 [<=32, md]")


def min_bytes(target, e_item, n_buckets: int, n_rows: int) -> int:
    """Device-memory bytes the combine must move: the lanes of each distinct
    item once (every doc id, and the score of each lane that lands in a
    bucket), 12 bytes of entry tables per entry, the bucket offsets, and
    both output planes written once."""
    items = torch.unique(e_item.long())
    lanes = target[items]
    landed = int(((lanes >= 0) & (lanes < n_buckets * C_BUCKET)).sum())
    return (
        items.numel() * BLOCK_SIZE * 4 + landed * 4 + e_item.numel() * 12
        + (n_buckets + 1) * 4 + n_rows * n_buckets * C_BUCKET * 8
    )


def combine_lanes_plain(bucket_ptr, target, sc, e_item, e_row, e_enc, out_score, out_counts):
    """The twin: add every in-bucket lane of every entry's item into the
    outputs (overwritten, not accumulated into). A (row, doc)'s score is
    +0.0 plus its lanes in entry order, the kernel's order, so the two
    agree bit for bit: the scores are an index_add_ on the CPU, which adds
    in index order (index_add_ on the card adds with atomics, so tensors
    on the card go to the CPU and back); counts are exact int32 sums."""
    rows, md = out_score.shape
    n_buckets = bucket_ptr.shape[0] - 1
    per_bucket = (bucket_ptr[1:] - bucket_ptr[:-1]).long()
    e_bucket = torch.repeat_interleave(
        torch.arange(n_buckets, device=target.device), per_bucket
    )
    item = e_item.long()
    local = target[item].long() - (e_bucket * C_BUCKET)[:, None]
    r = e_row.long()[:, None]
    keep = (local >= 0) & (local < C_BUCKET) & (r >= 0) & (r < rows)
    trash = rows * md
    idx = torch.where(keep, r * md + e_bucket[:, None] * C_BUCKET + local, trash).reshape(-1)
    # a slot lies in one bucket, whose entries are in item order, so the
    # lanes reach each slot in item order
    acc_s = torch.zeros(trash + 1, dtype=torch.float32).index_add_(
        0, idx.cpu(), sc[item].reshape(-1).cpu()
    )
    acc_c = torch.zeros(trash + 1, dtype=torch.int32, device=target.device)
    acc_c.index_put_(
        (idx,), e_enc.to(torch.int32)[:, None].expand_as(local).reshape(-1), accumulate=True,
    )
    out_score.copy_(acc_s[:trash].view(rows, md).to(out_score.device))
    out_counts.copy_(acc_c[:trash].view(rows, md))
    return out_score, out_counts


def combine_lanes(bucket_ptr, target, sc, e_item, e_row, e_enc, out_score, out_counts):
    """bucket_ptr i32[NB+1] entry offsets per bucket; target i32[W,128]
    absolute doc ids per item lane (ids outside the entry's bucket are
    ignored); sc f32[W,128]; e_item i32[E] item of each entry (in [0, W));
    e_row i32[E] chunk-local row (< 32); e_enc i32[E] clause-count
    encoding. Writes every element of out_score f32[rows, NB*C_BUCKET] and
    out_counts i32[rows, NB*C_BUCKET] (rows <= 32) and returns them."""
    n_buckets = bucket_ptr.shape[0] - 1
    _check_out(out_score, out_counts, n_buckets * C_BUCKET)
    if target.device.type == "cpu":
        return combine_lanes_plain(bucket_ptr, target, sc, e_item, e_row, e_enc,
                                   out_score, out_counts)
    from rucene_tpu_torch.ops.cuda_build import check, kernels

    if target.device.type != "cuda":
        raise ValueError(f"combine_lanes: unsupported device {target.device}")
    w, e = target.shape[0], e_item.shape[0]
    expect = (
        (bucket_ptr, torch.int32, (n_buckets + 1,)),
        (target, torch.int32, (w, BLOCK_SIZE)),
        (sc, torch.float32, (w, BLOCK_SIZE)),
        (e_item, torch.int32, (e,)),
        (e_row, torch.int32, (e,)),
        (e_enc, torch.int32, (e,)),
        (out_score, torch.float32, out_score.shape),
        (out_counts, torch.int32, out_score.shape),
    )
    for t, dt, shape in expect:
        if (t.device != target.device or t.dtype != dt or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError("combine_lanes: bad device, dtype, shape or layout")
    if any(t.data_ptr() % 16 for t in (target, sc, out_score, out_counts)):
        raise ValueError("combine_lanes: lanes and outputs must be 16-byte aligned")
    rc = kernels().rtt_combine_lanes(
        bucket_ptr.data_ptr(), target.data_ptr(), sc.data_ptr(), e_item.data_ptr(),
        e_row.data_ptr(), e_enc.data_ptr(), out_score.data_ptr(), out_counts.data_ptr(),
        n_buckets, C_BUCKET, out_score.shape[0], out_score.shape[1],
        torch.cuda.current_stream(target.device).cuda_stream,
    )
    check(rc, "rtt_combine_lanes")
    METRICS.incr(LAUNCH_COUNTER)
    return out_score, out_counts

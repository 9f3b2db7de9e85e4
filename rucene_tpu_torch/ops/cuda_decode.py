"""Wrappers of the CUDA decode kernels (csrc/decode.cu) and their plain twins.

``decode_blocks`` replaces rucene_tpu/ops/pallas_decode.py::
decode_work_items_pallas (K1). The port runs it once per segment to build
the decoded residency (codec/device.add_decoded_planes): one work item per
postings block.

``decode_score_blocks`` replaces decode_score_work_items_pallas (K2): a
packed segment's executor calls decode its work items' blocks per batch
(search/executor.decode_score_lanes), and the kernel copies each lane's
BM25 denominator ``cache[fid, norm_byte]`` out of the [F, 256] table in
place of the norm byte.

Bound: device-memory bytes (min_bytes): the blocks' packed words and
tables read once, 7-12 bytes a lane written once, with no reuse. At one
batch's blocks that is a few microseconds of bandwidth, so the kernels are
built against latency: a warp decodes one block, four consecutive lanes a
thread, with no shared memory and no barrier; the header comes in one
round trip and every plane's words in the next; FOR ids take an
in-register scan plus one warp shuffle scan, Elias-Fano ids a shuffle scan
of the 12 unary words' popcounts; stores are 16 bytes a thread. The Mosaic
machinery of the TPU kernels (8-bit-limb matmul word fetch, shift-add
scan, aligned 2048-word DMA windows, G=8 grouping, chunking for SMEM, the
one-hot cval select and the static has_ef program split) has no
counterpart here.

A CPU tensor goes to the plain twin (ops/decode.py); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from rucene_tpu_torch.ops.decode import (
    decode_doc_blocks,
    decode_freq_blocks,
    decode_norm_blocks,
    doc_plane_words,
)
from rucene_tpu_torch.util.metrics import METRICS
from rucene_tpu_torch.util.packing import BLOCK_SIZE

LAUNCH_COUNTER = "kernel.decode_blocks"
SCORE_LAUNCH_COUNTER = "kernel.decode_score_blocks"
PLAIN_CHUNK = 65536  # items per twin step: bounds its [W, 384] temporaries


def min_bytes(off, dbits, fbits, count, lane_bytes: int, fid=None) -> int:
    """Device-memory bytes a decode of W items must move: its [W] tables
    (five, six with fid) read once, the packed words of each distinct
    block with a live lane read once, the [256] cache row of each field
    those blocks use (fid given: K2), and lane_bytes for each of the
    W x 128 output lanes written once."""
    live = count > 0
    norm_words = (count[live].long() * 8 + 31) // 32  # one byte a valid lane, as packed
    words = doc_plane_words(dbits[live].long()) + 4 * fbits[live].long() + norm_words
    blocks, inv = torch.unique(off[live], return_inverse=True)
    block_words = torch.zeros_like(blocks, dtype=torch.int64).scatter_(0, inv, words)
    n_tables = 5 if fid is None else 6
    rows = 0 if fid is None else torch.unique(fid[live]).numel()
    w = off.shape[0]
    return (
        w * n_tables * 4 + int(block_words.sum()) * 4 + rows * 256 * 4
        + w * BLOCK_SIZE * lane_bytes
    )


def decode_blocks_plain(data, off, dbits, fbits, base, count, freq_dtype=torch.int32):
    """The twin: (docs i32[W,128], freqs freq_dtype[W,128], norms u8[W,128])."""
    docs_p, freqs_p, norms_p = [], [], []
    for s in range(0, max(off.shape[0], 1), PLAIN_CHUNK):
        sl = slice(s, s + PLAIN_CHUNK)
        docs, valid = decode_doc_blocks(data, off[sl], dbits[sl], base[sl], count[sl])
        docs_p.append(docs)
        freqs_p.append(decode_freq_blocks(data, off[sl], dbits[sl], fbits[sl], valid).to(freq_dtype))
        norms_p.append(decode_norm_blocks(data, off[sl], dbits[sl], fbits[sl], valid).to(torch.uint8))
    return torch.cat(docs_p), torch.cat(freqs_p), torch.cat(norms_p)


def _check_tables(name, data, tables):
    w = tables[0].shape[0]
    for t in (data, *tables):
        if t.device != data.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous int32 tensors on one device")
    if any(t.shape != (w,) for t in tables) or data.dim() != 1:
        raise ValueError(f"{name}: data must be 1-D and the tables [W]")
    return w


def decode_blocks(data, off, dbits, fbits, base, count, freq_dtype=torch.int32):
    """Decode W postings blocks: data int32[N] packed words (at least 2 zero
    words past the last block), the rest int32[W] per-item tables. Returns
    (docs i32[W,128] with INVALID_DOC past count, freqs freq_dtype[W,128],
    norm bytes u8[W,128]); freq_dtype is torch.int16 or torch.int32."""
    tables = (off, dbits, fbits, base, count)
    if data.device.type == "cpu":
        return decode_blocks_plain(data, *tables, freq_dtype=freq_dtype)
    if data.device.type != "cuda":
        raise ValueError(f"decode_blocks: unsupported device {data.device}")
    from rucene_tpu_torch.ops.cuda_build import check, kernels

    w = _check_tables("decode_blocks", data, tables)
    if freq_dtype not in (torch.int16, torch.int32):
        raise ValueError(f"decode_blocks: freq_dtype {freq_dtype} unsupported")
    docs = torch.empty((w, BLOCK_SIZE), dtype=torch.int32, device=data.device)
    freqs = torch.empty((w, BLOCK_SIZE), dtype=freq_dtype, device=data.device)
    norms = torch.empty((w, BLOCK_SIZE), dtype=torch.uint8, device=data.device)
    if w == 0:
        return docs, freqs, norms
    rc = kernels().rtt_decode_blocks(
        data.data_ptr(), *(t.data_ptr() for t in tables),
        docs.data_ptr(), freqs.data_ptr(), norms.data_ptr(),
        w, freqs.element_size(), torch.cuda.current_stream(data.device).cuda_stream,
    )
    check(rc, "rtt_decode_blocks")
    METRICS.incr(LAUNCH_COUNTER)
    return docs, freqs, norms


def decode_score_blocks_plain(data, off, dbits, fbits, base, count, fid, cache):
    """The twin of K2: decode_blocks_plain, then the gather
    ``cache.reshape(-1)[fid * 256 + norm]`` on valid lanes (0.0 past count).
    Returns (docs i32[W,128], freqs i32[W,128], cval f32[W,128])."""
    docs, freqs, norms = decode_blocks_plain(data, off, dbits, fbits, base, count)
    valid = torch.arange(BLOCK_SIZE, device=data.device) < count[:, None]
    idx = torch.where(valid, fid.long()[:, None] * 256 + norms.long(), 0)
    cval = torch.where(valid, cache.reshape(-1)[idx], 0.0)
    return docs, freqs, cval


def decode_score_blocks(data, off, dbits, fbits, base, count, fid, cache):
    """Decode W postings blocks and copy each valid lane's BM25 denominator
    ``cache[fid[item], norm_byte]``: data and the int32[W] tables as for
    decode_blocks, fid int32[W] cache rows, cache f32[F, 256]. Returns
    (docs i32[W,128] with INVALID_DOC past count, freqs i32[W,128], cval
    f32[W,128]); lanes past count hold freq 0 and cval 0."""
    tables = (off, dbits, fbits, base, count, fid)
    if data.device.type == "cpu":
        return decode_score_blocks_plain(data, *tables, cache)
    if data.device.type != "cuda":
        raise ValueError(f"decode_score_blocks: unsupported device {data.device}")
    from rucene_tpu_torch.ops.cuda_build import check, kernels

    w = _check_tables("decode_score_blocks", data, tables)
    if (
        cache.device != data.device or cache.dtype != torch.float32
        or cache.dim() != 2 or cache.shape[1] != 256 or not cache.is_contiguous()
    ):
        raise ValueError("decode_score_blocks: cache must be contiguous f32[F, 256] on data's device")
    docs = torch.empty((w, BLOCK_SIZE), dtype=torch.int32, device=data.device)
    freqs = torch.empty((w, BLOCK_SIZE), dtype=torch.int32, device=data.device)
    cval = torch.empty((w, BLOCK_SIZE), dtype=torch.float32, device=data.device)
    if w == 0:
        return docs, freqs, cval
    rc = kernels().rtt_decode_score_blocks(
        data.data_ptr(), *(t.data_ptr() for t in tables), cache.data_ptr(),
        docs.data_ptr(), freqs.data_ptr(), cval.data_ptr(),
        w, torch.cuda.current_stream(data.device).cuda_stream,
    )
    check(rc, "rtt_decode_score_blocks")
    METRICS.incr(SCORE_LAUNCH_COUNTER)
    return docs, freqs, cval

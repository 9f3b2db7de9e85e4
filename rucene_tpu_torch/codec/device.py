"""Device-resident segment tensors (counterpart of rucene_tpu/codec/device.py).

A DeviceSegment holds one segment's block tables, live mask, ``blk_fid``,
norms plane and position stream as torch tensors on one device, in one of
two forms (decoded_policy picks):
- decoded: every block decoded once into resident planes by the decode
  kernel (ops/cuda_decode.decode_blocks) on CUDA, its plain twin on the
  CPU; the packed words are dropped;
- packed: the packed words stay, with their pad, and each batch decodes
  its work items' blocks with the scoring decode kernel
  (ops/cuda_decode.decode_score_blocks); the planes stay None.

The norms plane (u8[F, MDp]), the packed position stream and the
per-block position bases serve the phrase path (search/phrase_device.py,
ops/phrase_plane.py) in both forms.

Every form also holds its blocks' dense-combine buckets (block_buckets:
each block's first bucket and span, on the host and on the device), read
by search/flat_tables.build_combine_batch.

A decoded segment may also hold dense tf planes (add_tf_planes): one u8
row per hot term, ``tf_planes[slot, doc]`` = the term's freq there (0
absent), scattered once from the decoded residency. The tf-plane executor
(search/executor.execute_planes) reads them; SegmentSnapshot.plane_slots
maps a term's block_start to its row. plane_policy re-derives the
reference's byte budget for the card.

Left out, as TPU-only machinery: the +2048-word Mosaic pad (a pad of 2 zero
words keeps every 2-word read in bounds, in the postings words and the
position stream alike), the pow2 doc-axis, block and position buckets (the
doc axis rounds up to a multiple of 1024 so dense combine tiles divide it;
the tf planes hold exactly one row per term, no pow2 pad row) and
``blk_max_freq`` (callers read the host copy).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from rucene_tpu_torch.codec.postings import PackedSegment
from rucene_tpu_torch.ops.cuda_combine import C_BUCKET
from rucene_tpu_torch.util import round_up

DATA_PAD_WORDS = 2  # zero words past the last block: 2-word reads stay in bounds
DOC_AXIS_MULTIPLE = 1024  # max_doc_padded: whole dense-combine buckets

# The card's memory, fixed, so that a leaf on the CPU (tests) budgets and
# routes as the card does: both plane budgets (phrase_plane_budget,
# tf_plane_budget) derive from it, never from what a device reports.
CARD_BYTES = 80 << 30
# batch transients per (row, doc) of a 256-row batch: dense f32 + i32
# accumulators, masked scores and int64 top-k keys (decoded_policy's 45 GB
# at 256 rows over 8.8M docs)
BATCH_ROWS = 256
TRANSIENT_BYTES_PER_ROW_DOC = 20
PHRASE_PLANE_CAP = 16 << 30  # the phrase position-plane cache's ceiling
TF_PLANE_CAP = 8 << 30  # the tf planes' ceiling (plane_policy)
PLANE_CHUNK = 65536  # blocks per tf-plane scatter step


class BlockBuckets(NamedTuple):
    """Each block's doc buckets in the dense combine (ops/cuda_combine.
    C_BUCKET docs a bucket), built once with a device form, so that
    search/flat_tables.build_combine_batch builds a batch's entry tables
    on the device: the span on the host (entry counts and the residue),
    the first bucket and the span on the device (each entry's bucket)."""

    span: np.ndarray  # i8[NB] buckets a block's doc range overlaps, capped at 127
    first: torch.Tensor  # i32[NB] the block's first bucket
    span_d: torch.Tensor  # i8[NB] ``span`` on the device


def block_buckets(blk_first, blk_last, device) -> BlockBuckets:
    """BlockBuckets from a block table's first and last docs (one inert
    block where it has none, as one_block_min): a block overlaps buckets
    ``first // C_BUCKET`` to ``max(last // C_BUCKET, first // C_BUCKET)``,
    as ops/combine_tables.build_combine_tables counts them."""
    first = np.asarray(blk_first, np.int64) // C_BUCKET
    last = np.maximum(np.asarray(blk_last, np.int64) // C_BUCKET, first)
    span = np.minimum(last - first + 1, 127).astype(np.int8)
    first = one_block_min(first.astype(np.int32))
    span = span if len(span) else np.zeros(1, np.int8)
    return BlockBuckets(
        span=span,
        first=torch.from_numpy(first).to(device),
        span_d=torch.from_numpy(span).to(device),
    )


@dataclass
class DeviceSegment:
    data: torch.Tensor  # i32[W + pad] packed postings words (u32 bits)
    blk_off: torch.Tensor  # i32[NB]
    blk_doc_bits: torch.Tensor  # i32[NB]
    blk_freq_bits: torch.Tensor  # i32[NB]
    blk_base: torch.Tensor  # i32[NB]
    blk_count: torch.Tensor  # i32[NB]
    live: torch.Tensor  # bool[MDp] (padding docs are dead)
    blk_fid: torch.Tensor | None = None  # i32[NB] norms/cache row per block
    norms: torch.Tensor | None = None  # u8[F, MDp] norm bytes (zero rows for norm-less fields)
    positions: torch.Tensor | None = None  # i32[P + pad] packed position deltas (u32 bits)
    blk_pos_base: torch.Tensor | None = None  # i32[NB] within-term occurrence index of a block's start
    # --- decoded residency (add_decoded_planes); None when packed ---
    docs_dec: torch.Tensor | None = None  # i32[NB,128] local doc ids, INVALID pad
    freqs_dec: torch.Tensor | None = None  # i16|i32[NB,128], 0 pad
    norm_dec: torch.Tensor | None = None  # u8[NB,128] norm bytes
    # --- dense tf planes (add_tf_planes); None when off ---
    tf_planes: torch.Tensor | None = None  # u8[P, MDp] hot-term freqs, 0 absent
    # --- the blocks' dense-combine buckets (block_buckets) ---
    buckets: BlockBuckets | None = None

    @property
    def max_doc_padded(self) -> int:
        return self.live.shape[0]

    @property
    def device(self) -> torch.device:
        return self.live.device


def build_device_segment(
    packed: PackedSegment, device, live: np.ndarray | None = None
) -> DeviceSegment:
    """Upload a packed segment's words (with their pad), block tables,
    per-block field ids and live mask to ``device``: the packed form."""
    mdp = round_up(max(packed.max_doc, 1), DOC_AXIS_MULTIPLE)
    live_arr = np.zeros(mdp, dtype=bool)
    live_arr[: packed.max_doc] = True if live is None else live[: packed.max_doc]
    data = np.zeros(len(packed.data) + DATA_PAD_WORDS, np.uint32)
    data[: len(packed.data)] = packed.data
    positions = np.zeros(len(packed.positions) + DATA_PAD_WORDS, np.uint32)
    positions[: len(packed.positions)] = packed.positions
    n_fields = max((pf.field_id for pf in packed.fields.values()), default=-1) + 1
    norms = np.zeros((max(n_fields, 1), mdp), np.uint8)
    for name, pf in packed.fields.items():
        if name in packed.norms:
            norms[pf.field_id, : packed.max_doc] = packed.norms[name]

    def put(a, dtype=torch.int32):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # a lazily opened segment's mapped file
            a = a.copy()
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return DeviceSegment(
        data=put(data.view(np.int32)),
        blk_off=put(one_block_min(packed.blk_off)),
        blk_doc_bits=put(one_block_min(packed.blk_doc_bits)),
        blk_freq_bits=put(one_block_min(packed.blk_freq_bits)),
        blk_base=put(one_block_min(packed.blk_base)),
        blk_count=put(one_block_min(packed.blk_count)),
        live=put(live_arr, torch.bool),
        blk_fid=put(one_block_min(blk_fid_host(packed))),
        norms=put(norms, torch.uint8),
        positions=put(positions.view(np.int32)),
        blk_pos_base=put(one_block_min(packed.blk_pos_base)),
        buckets=block_buckets(packed.blk_first_doc, packed.blk_last_doc, device),
    )


def one_block_min(table: np.ndarray) -> np.ndarray:
    """A block table, or one empty block where it has none: a segment
    without postings (docs holding only points or doc values) still gets
    a row for the inert item a work list keeps (flat_tables.build_flat_work
    keeps at least one), whose block count is 0."""
    return table if len(table) else np.zeros(1, np.int32)


def with_live(dev: DeviceSegment, live: np.ndarray) -> DeviceSegment:
    """The same form under another live mask (the .liv generation's
    analog): one upload of the mask; the words, the decoded planes, the tf
    planes, the norms and the block tables are shared, not rebuilt."""
    mdp = dev.max_doc_padded
    arr = np.zeros(mdp, dtype=bool)
    arr[: len(live)] = live[:mdp]
    return replace(dev, live=torch.from_numpy(arr).to(dev.device))


def blk_fid_host(packed: PackedSegment) -> np.ndarray:
    """i32[NB] norms/cache row per block, from the per-term block ranges."""
    nb = packed.num_blocks
    out = np.zeros(nb, np.int32)
    for pf in packed.fields.values():
        starts = np.clip(np.asarray(pf.block_start, np.int64), 0, nb)
        counts = np.clip(np.asarray(pf.block_count, np.int64), 0, None)
        counts = np.minimum(counts, nb - starts)
        total = int(counts.sum())
        if total == 0:
            continue
        csum = np.cumsum(counts) - counts
        idx = np.arange(total) - csum.repeat(counts) + starts.repeat(counts)
        out[idx] = pf.field_id
    return out


def add_decoded_planes(dev: DeviceSegment, freq_dtype=torch.int32) -> DeviceSegment:
    """Decode every postings block once into resident planes (one decode
    kernel launch on CUDA; the twin on the CPU), then drop the packed words:
    every consumer of a decoded segment reads the planes. The norms plane,
    the position stream and the block position bases stay."""
    from rucene_tpu_torch.ops.cuda_decode import decode_blocks

    docs, freqs, norms = decode_blocks(
        dev.data, dev.blk_off, dev.blk_doc_bits, dev.blk_freq_bits,
        dev.blk_base, dev.blk_count, freq_dtype=freq_dtype,
    )
    return replace(
        dev,
        data=dev.data[:DATA_PAD_WORDS].clone(),
        docs_dec=docs,
        freqs_dec=freqs,
        norm_dec=norms,
    )


def decoded_policy(n_blocks: int, max_freq: int) -> tuple[bool, torch.dtype]:
    """(decoded?, freq dtype) under the RUCENE_DECODED knob: ``0`` serves
    the segment packed, ``1`` decoded, ``auto`` (the default) decoded when
    it fits the residency budget.

    Freqs are int16 when every freq fits (< 32768), else int32. The budget
    covers the planes plus the per-stats cval table, RUCENE_DECODED_MAX_MB.
    Its default, 32 GB, is 40% of an 80 GB card: the rest holds the batch
    transients, which at 256 rows over 8.8M docs (dense f32 + i32
    accumulators, masked scores and int64 top-k keys) come to about 45 GB.

    Small segments (NRT flush segments of 2,000-25,000 docs) follow the
    same rule. The reference serves segments of 32K docs or fewer packed,
    on floored shapes, to reuse compiled XLA programs and to spare the TPU
    host link; the port has neither. On an H100 80GB HBM3 at 700 W, two
    runs of tests/torch_nrt_ab.py (chip_smoke.py's NRT phase, legs
    decoded, packed, packed, decoded in one process) served 453.4, 346.0
    and 490.4, 454.2 QPS decoded against 342.0, 318.3 and 520.6, 514.5
    packed, with 509.8, 586.8 and 458.0, 449.6 ms from a refresh to the
    end of its first batch against 575.9, 630.4 and 423.6, 420.3: the
    runs disagree on the sign, so neither form wins, and small segments
    get no rule of their own."""
    env = os.environ.get("RUCENE_DECODED", "auto")
    if env not in ("0", "1", "auto"):
        raise ValueError(f"RUCENE_DECODED={env!r}: expected 0, 1 or auto")
    fdt = torch.int16 if max_freq < (1 << 15) else torch.int32
    if env != "auto":
        return env == "1", fdt
    fb = 2 if fdt == torch.int16 else 4
    per_block = 128 * (4 + fb + 1 + 4) + 4  # docs+freq+norm+cval lanes, fid
    limit = int(os.environ.get("RUCENE_DECODED_MAX_MB", 32768)) << 20
    return n_blocks * per_block <= limit, fdt


def device_bytes(dev: DeviceSegment) -> int:
    """Bytes of every tensor a DeviceSegment holds."""
    return sum(
        t.numel() * t.element_size() for t in vars(dev).values() if isinstance(t, torch.Tensor)
    )


# --- dense tf planes ----------------------------------------------------------


def _card_left(mdp: int, dev_bytes: int) -> int:
    """CARD_BYTES less a segment's own tensors (``dev_bytes``) and a
    256-row batch's transients over its doc axis (20 bytes a (row, doc):
    5.1 GB at 1M docs, 45 GB at 8.8M)."""
    return CARD_BYTES - dev_bytes - BATCH_ROWS * TRANSIENT_BYTES_PER_ROW_DOC * mdp


def phrase_plane_budget(mdp: int, dev_bytes: int) -> int:
    """The phrase position-plane cache's byte budget for a segment of doc
    axis ``mdp`` whose own tensors take ``dev_bytes``: half of what
    _card_left leaves, so the allocator keeps room, clamped to 1 GB ..
    PHRASE_PLANE_CAP (16 GB). The card is the fixed CARD_BYTES on every
    device, so a CPU leaf budgets as a card's does, and the budget stays
    the same for the segment's lifetime."""
    return max(1 << 30, min(PHRASE_PLANE_CAP, _card_left(mdp, dev_bytes) // 2))


def tf_plane_budget(mdp: int, dev_bytes: int) -> int:
    """The dense tf planes' byte budget under the same rule: half of what
    _card_left leaves once the phrase cache's ceiling is set aside, capped
    at TF_PLANE_CAP (8 GB); 0 when nothing is left.

    Both budgets are a leaf's, against the whole card. The phrase planes
    share one cache that evicts against the budget of the leaf fetching,
    so it never holds much more than the largest leaf's budget (16 GB at
    most). The tf planes are each leaf's own: n leaves of 2^19 docs or more
    may hold up to n x 8 GB together. Leaves under 2^19 docs (every NRT
    flush segment) hold none unless RUCENE_PLANES=1."""
    return max(0, min(TF_PLANE_CAP, (_card_left(mdp, dev_bytes) - PHRASE_PLANE_CAP) // 2))


def plane_policy(mdp: int, dev_bytes: int = 0) -> tuple[int, int]:
    """(budget_bytes, df_min) for dense tf planes under RUCENE_PLANES:
    ``0`` no planes, ``1`` every term that fits (tests), ``auto`` (the
    default) terms with df >= mdp // 512 on segments of 2^19 docs or more.

    The reference caps the planes at 4 GB up to 4M docs (2 GB above),
    sized for about 14 GB of usable TPU memory. Here the budget is
    tf_plane_budget: the fixed card (CARD_BYTES, 80 GB) less the segment's
    own tensors (``dev_bytes``; the decoded residency is at most 32 GB,
    decoded_policy), a 256-row batch's transients and the phrase cache's
    16 GB ceiling, halved, capped at 8 GB. At 1M docs that is the 8 GB
    cap; at 8.8M docs it depends on the residency (tests/
    test_torch_budgets.py pins both). df_min keeps the reference's
    mdp // 512; the port's doc axis rounds to 1024, not to a power of
    two, so at 1M docs df_min is 1954 where the reference's is 2048
    (routes differ at the margin, results do not)."""
    env = os.environ.get("RUCENE_PLANES", "auto")
    if env not in ("0", "1", "auto"):
        raise ValueError(f"RUCENE_PLANES={env!r}: expected 0, 1 or auto")
    if env == "0":
        return 0, 0
    budget = tf_plane_budget(mdp, dev_bytes)
    if env == "1":
        return budget, 1
    if mdp < (1 << 19):
        # small segments: the lane paths are already cheap there
        return 0, 0
    return budget, max(mdp // 512, 4)


def select_plane_terms(packed: PackedSegment, mdp: int, budget_bytes: int,
                       df_min: int):
    """Pick the plane-resident terms: df >= df_min, per-block max freq
    <= 255 (u8 exactness), ordered by (-df, block_start), capped by the
    byte budget. Returns (blk_ids i32[NBsel], slot_ids i32[NBsel],
    slots {block_start -> slot}) or None."""
    cap = budget_bytes // max(mdp, 1)
    if cap <= 0:
        return None
    bmf = np.asarray(packed.blk_max_freq)
    rows: list[tuple[int, int, int]] = []  # (df, block_start, block_count)
    for pf in packed.fields.values():
        df = np.asarray(pf.doc_freq)
        bs = np.asarray(pf.block_start)
        bc = np.asarray(pf.block_count)
        for t in np.flatnonzero((df >= df_min) & (bc > 0)):
            s, c = int(bs[t]), int(bc[t])
            if int(bmf[s : s + c].max()) > 255:
                continue
            rows.append((int(df[t]), s, c))
    if not rows:
        return None
    rows.sort(key=lambda r: (-r[0], r[1]))
    rows = rows[: int(cap)]
    slots = {s: i for i, (_df, s, _c) in enumerate(rows)}
    blk_ids = np.concatenate(
        [np.arange(s, s + c, dtype=np.int32) for _df, s, c in rows]
    )
    slot_ids = np.repeat(
        np.arange(len(rows), dtype=np.int32),
        np.asarray([c for _df, _s, c in rows]),
    )
    return blk_ids, slot_ids, slots


def add_tf_planes(dev: DeviceSegment, packed: PackedSegment):
    """Build the hot-term u8 tf planes from the decoded residency. Returns
    (dev', {block_start -> plane row}); (dev, {}) when off or when nothing
    qualifies. The reference's drop-mode scatter becomes a scatter into a
    flat buffer with one spare element: pad lanes (INVALID_DOC) write
    there, and it is never read. Real (row, doc) pairs are unique, so the
    assignment is deterministic; u8 is exact because select_plane_terms
    skips terms with a block max freq above 255."""
    if dev.docs_dec is None or not packed.num_blocks:
        return dev, {}
    mdp = dev.max_doc_padded
    budget, df_min = plane_policy(mdp, device_bytes(dev))
    if budget <= 0:
        return dev, {}
    sel = select_plane_terms(packed, mdp, budget, df_min)
    if sel is None:
        return dev, {}
    blk_ids, slot_ids, slots = sel
    trash = len(slots) * mdp
    flat = torch.zeros(trash + 1, dtype=torch.uint8, device=dev.device)
    for s in range(0, len(blk_ids), PLANE_CHUNK):
        blk = torch.from_numpy(blk_ids[s : s + PLANE_CHUNK]).to(dev.device).long()
        row = torch.from_numpy(slot_ids[s : s + PLANE_CHUNK]).to(dev.device).long()
        d = dev.docs_dec[blk].long()  # [C,128] INVALID_DOC pad
        idx = torch.where(d < mdp, row[:, None] * mdp + d, trash)
        flat[idx.reshape(-1)] = dev.freqs_dec[blk].reshape(-1).to(torch.uint8)
    return replace(dev, tf_planes=flat[:trash].view(len(slots), mdp)), slots

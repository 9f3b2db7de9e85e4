"""Single-dispatch multi-segment search (counterpart of
rucene_tpu/index/combined.py): a CombinedView concatenates every leaf's
packed postings into ONE DeviceSegment, so a whole NRT index is searched
with one executor call instead of one per leaf.

The flat executor takes any block table, so N segments are more rows in
the same tables:
- block ids: the leaves' block tables concatenated (a leaf's term block
  ranges shift by its block base, build_combined_tables);
- doc space: leaves laid out back to back at bases rounded up to 1024
  docs; a block's ``blk_base`` shifts by its leaf's base, so a decoded doc
  lands directly in the view's doc space (map_docs takes it back to the
  reader's);
- norms: [global field, docs]; a leaf lacking a field keeps zero rows
  (never matched, never scored); ``blk_fid`` names the global rows
  (combined_blk_fid);
- live: concatenated, padding docs dead.
Each (query, clause) fans out to one block range PER LEAF; a doc lives in
exactly one leaf, so the clause-count encodings stay exact.

The device form is codec/device's: the words, tables and masks uploaded
once, then, as decoded_policy says, the decoded residency through the
decode kernel (K1), over the view's blocks at once. ``with_positions``
also concatenates the position streams (the sharded phrase step reads
them through ``pos_word_bases``); without it the phrase paths stay per
leaf. No tf planes: the pair and tf-plane routes stay per leaf.

cached_combined_view keeps one view per torch device. The reference's
cache is one global entry keyed by id() of the leaves' packed segments and
live masks, holding the segments but not the masks: a freed mask's id()
can come back as another reader's new mask, and a view built on one
device is served to a reader on another. Here an entry holds weak
references to the segments and the masks and hits only on identity, on
its own device (ROADMAP.md §3). A miss compacts the field numbering to the
fields some current leaf has before it extends it, so ``field_gid`` does
not grow across refreshes.

The view keeps ``blk_max_freq`` on the host, the leaves' block maxima in
the view's block order: the block-max bounds of WAND pruning over the view
(the searcher's _run_pruned_view) read it; it needs no device copy.

Left out, as TPU-only machinery: ``bucket_sizes`` (pow2 doc, block and
word axes that let refreshes reuse compiled XLA programs), the +2048-word
pad, ``as_numpy`` (the stacking of shards to one shape) and the host copy
that fed the static has_ef program (``blk_dbits_host``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from rucene_tpu_torch.codec.device import (
    DATA_PAD_WORDS,
    DOC_AXIS_MULTIPLE,
    DeviceSegment,
    add_decoded_planes,
    blk_fid_host,
    block_buckets,
    decoded_policy,
    one_block_min,
)
from rucene_tpu_torch.util import round_up
from rucene_tpu_torch.util.metrics import METRICS


@dataclass
class CombinedView:
    device: DeviceSegment
    doc_bases: np.ndarray  # i64[L] view doc base per leaf
    blk_bases: np.ndarray  # i64[L] block-table offset per leaf
    field_gid: dict[str, int]  # field name -> global norms row
    n_leaves: int
    n_blocks: int
    blk_first_host: np.ndarray  # i64[NB] first doc per block, view doc space
    blk_last_host: np.ndarray  # i64[NB] last doc per block, view doc space
    blk_max_freq: np.ndarray  # i32[NB] max term freq per block (WAND bounds)
    pos_word_bases: np.ndarray | None = None  # i64[L] position-word offset per leaf
    # filter planes in the view's doc space ({key: bool[md] tensor}; a
    # live-mask swap shares them: liveness is applied by the executors)
    planes: dict = field(default_factory=dict)

    def map_docs(self, view_docs: np.ndarray, leaves) -> np.ndarray:
        """View doc ids -> reader-global doc ids (monotone, so result
        order is kept)."""
        view_docs = np.asarray(view_docs, np.int64)
        li = np.searchsorted(self.doc_bases, view_docs, side="right") - 1
        li = np.clip(li, 0, self.n_leaves - 1)
        real = np.asarray([leaf.doc_base for leaf in leaves], np.int64)
        return real[li] + (view_docs - self.doc_bases[li])


def _live_plane(leaves, doc_bases: np.ndarray, md_total: int) -> np.ndarray:
    live = np.zeros(md_total, bool)
    for li, leaf in enumerate(leaves):
        b = int(doc_bases[li])
        md = leaf.packed.max_doc
        live[b : b + md] = True if leaf.live is None else leaf.live[:md]
    return live


# {torch device: (segment refs, live refs, view)}: one view per device,
# the last one built there
_VIEW_CACHE: dict = {}


def _alive(refs, objs) -> bool:
    return len(refs) == len(objs) and all(
        (r is None and o is None) or (r is not None and r() is o) for r, o in zip(refs, objs)
    )


def cached_combined_view(leaves, device) -> CombinedView:
    """build_combined_view with reuse across NRT refreshes, per device: the
    same segments under the same live masks -> the same view; the same
    segments under new masks -> the view with a new live plane (one
    upload; the words, tables and decoded planes are shared); anything
    else -> a rebuild, which replaces the device's entry."""
    device = torch.device(device)
    packs = [lf.packed for lf in leaves]
    lives = [lf.live for lf in leaves]
    entry = _VIEW_CACHE.get(device)
    if entry is not None and _alive(entry[0], packs):
        seg_refs, live_refs, view = entry
        if _alive(live_refs, lives):
            return view
        live = _live_plane(leaves, view.doc_bases, view.device.max_doc_padded)
        view = replace(view, device=replace(view.device, live=torch.from_numpy(live).to(device)))
        _VIEW_CACHE[device] = (seg_refs, [None if x is None else weakref.ref(x) for x in lives], view)
        return view
    # a structural change (a refresh added or merged segments): keep the
    # prior numbering of the fields some leaf still has, then extend it
    gid = None
    if entry is not None:
        have = {name for p in packs for name in p.fields}
        kept = [n for n, _g in sorted(entry[2].field_gid.items(), key=lambda x: x[1]) if n in have]
        gid = {n: i for i, n in enumerate(kept)}
        for name in sorted(have - set(gid)):
            gid[name] = len(gid)
    view = build_combined_view(leaves, device, field_gid=gid)
    _VIEW_CACHE[device] = (
        [weakref.ref(p) for p in packs],
        [None if x is None else weakref.ref(x) for x in lives],
        view,
    )
    return view


def combined_blk_fid(leaves, field_gid: dict[str, int]) -> np.ndarray:
    """i32[NB_total] global norms / cache row per concatenated block (each
    leaf's field ids remapped through field_gid): the decoded residency's
    cval table index (flat_tables.cval_table_for)."""
    parts = []
    for leaf in leaves:
        p = leaf.packed
        nf = max((pf.field_id for pf in p.fields.values()), default=-1) + 2
        remap = np.zeros(nf, np.int32)
        for name, pf in p.fields.items():
            remap[pf.field_id] = field_gid[name]
        parts.append(remap[blk_fid_host(p)])
    if not parts:
        return np.zeros(0, np.int32)
    return np.concatenate(parts)


def build_combined_view(
    leaves, device, field_gid: dict[str, int] | None = None, with_positions: bool = False
) -> CombinedView:
    """Concatenate the leaves' packed segments into one DeviceSegment on
    ``device``. field_gid pins the global norms-row numbering (the shards
    of a ShardedIndex share one); with_positions also concatenates the
    position streams."""
    if field_gid is None:
        names = sorted({name for leaf in leaves for name in leaf.packed.fields})
        field_gid = {name: i for i, name in enumerate(names)}
    n_fields = max(len(field_gid), 1)
    n = len(leaves)
    doc_bases = np.zeros(n, np.int64)
    blk_bases = np.zeros(n, np.int64)
    pos_word_bases = np.zeros(n, np.int64)
    data_p, off_p, dbits_p, fbits_p, base_p, cnt_p, first_p, last_p, bmf_p = (
        [] for _ in range(9)
    )
    pos_p, posb_p = [], []
    word_base = doc_base = nb_total = pos_base = 0
    for li, leaf in enumerate(leaves):
        p = leaf.packed
        doc_bases[li] = doc_base
        blk_bases[li] = nb_total
        pos_word_bases[li] = pos_base
        data_p.append(p.data)
        off_p.append(p.blk_off.astype(np.int64) + word_base)
        dbits_p.append(p.blk_doc_bits)
        fbits_p.append(p.blk_freq_bits)
        base_p.append(p.blk_base.astype(np.int64) + doc_base)
        cnt_p.append(p.blk_count)
        bmf_p.append(p.blk_max_freq)
        first_p.append(p.blk_first_doc.astype(np.int64) + doc_base)
        last_p.append(p.blk_last_doc.astype(np.int64) + doc_base)
        posb_p.append(p.blk_pos_base)
        if with_positions:
            pos_p.append(p.positions)
            pos_base += len(p.positions)
        word_base += len(p.data)
        doc_base += round_up(max(p.max_doc, 1), DOC_AXIS_MULTIPLE)
        nb_total += p.num_blocks
    md_total = int(doc_base)

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)

    data = np.zeros(word_base + DATA_PAD_WORDS, np.uint32)
    data[:word_base] = cat(data_p, np.uint32)
    positions = np.zeros(pos_base + DATA_PAD_WORDS, np.uint32)
    positions[:pos_base] = cat(pos_p, np.uint32)
    norms = np.zeros((n_fields, md_total), np.uint8)
    for li, leaf in enumerate(leaves):
        p = leaf.packed
        b = int(doc_bases[li])
        for name in p.fields:
            if name in p.norms:
                norms[field_gid[name], b : b + p.max_doc] = p.norms[name]
    live = _live_plane(leaves, doc_bases, md_total)
    blk_off = cat(off_p, np.int64)
    if len(blk_off) and int(blk_off.max()) >= 2**31:
        raise ValueError("a combined view holds at most 2^31 postings words")

    def put(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    dev = DeviceSegment(
        data=put(data.view(np.int32)),
        blk_off=put(one_block_min(blk_off.astype(np.int32))),
        blk_doc_bits=put(one_block_min(cat(dbits_p, np.int32))),
        blk_freq_bits=put(one_block_min(cat(fbits_p, np.int32))),
        blk_base=put(one_block_min(cat(base_p, np.int32))),
        blk_count=put(one_block_min(cat(cnt_p, np.int32))),
        live=put(live, torch.bool),
        blk_fid=put(one_block_min(combined_blk_fid(leaves, field_gid))),
        norms=put(norms, torch.uint8),
        positions=put(positions.view(np.int32)),
        blk_pos_base=put(one_block_min(cat(posb_p, np.int32))),
        buckets=block_buckets(cat(first_p, np.int64), cat(last_p, np.int64), device),
    )
    blk_max_freq = cat(bmf_p, np.int32)
    decoded, fdt = decoded_policy(nb_total, int(blk_max_freq.max()) if nb_total else 0)
    if decoded and nb_total:
        dev = add_decoded_planes(dev, freq_dtype=fdt)
    METRICS.incr("reader.combined_builds")
    return CombinedView(
        device=dev,
        doc_bases=doc_bases,
        blk_bases=blk_bases,
        field_gid=field_gid,
        n_leaves=n,
        n_blocks=nb_total,
        blk_first_host=cat(first_p, np.int64),
        blk_last_host=cat(last_p, np.int64),
        blk_max_freq=blk_max_freq,
        pos_word_bases=pos_word_bases if with_positions else None,
    )


def build_combined_tables(view: CombinedView, leaves, rqs, b: int, t: int):
    """Per-clause block ranges across ALL leaves: [b, t*L] slot tables
    (clause j, leaf l -> column j*L + l), block ids in view coordinates."""
    length = view.n_leaves
    block_start = np.zeros((b, t * length), np.int32)
    block_count = np.zeros((b, t * length), np.int32)
    field_id = np.zeros((b, t * length), np.int32)
    for i, rq in enumerate(rqs):
        for j, (_occ, c) in enumerate(rq.all_slots()):
            gfid = view.field_gid.get(c.term.field, 0)
            for li, leaf in enumerate(leaves):
                rec = leaf.term_record(c.term.field, c.term.text)
                if rec is not None:
                    col = j * length + li
                    block_start[i, col] = int(view.blk_bases[li]) + rec.block_start
                    block_count[i, col] = rec.block_count
                    field_id[i, col] = gfid
    return block_start, block_count, field_id

"""Segment merging: concat + remap as array ops.

reference: rucene src/core/index/merge/ (SegmentMerger segment_merger.rs:36,
TieredMergePolicy merge_policy.rs:414, MergeScheduler merge_scheduler.rs:41).

The merge itself is column-oriented: per field a k-way term merge, and per
term a concatenation of live-filtered, remapped doc arrays (the DocIdMerger
analog, doc_id_merger.rs:137) — all numpy; the result is re-packed by
codec.pack_segment, which re-chooses per-block bit widths (deleted docs
shrink deltas, so merged segments recompress).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from rucene_tpu_torch.codec.postings import PackedSegment, pack_segment
from rucene_tpu_torch.index.field_infos import FieldInfos
from rucene_tpu_torch.index.memory import FieldStats, SegmentData
from rucene_tpu_torch.index.reader import SegmentSnapshot


def _remap(snapshots: list[SegmentSnapshot]) -> tuple[list[np.ndarray], list[np.ndarray], int]:
    """Per segment: (live mask, old local doc -> new global doc), new max_doc."""
    masks, maps = [], []
    base = 0
    for snap in snapshots:
        live = snap.live if snap.live is not None else np.ones(snap.max_doc, dtype=bool)
        newid = np.cumsum(live) - 1 + base
        newid = np.where(live, newid, -1).astype(np.int64)
        masks.append(live)
        maps.append(newid)
        base += int(live.sum())
    return masks, maps, base


def merge_segments(snapshots: list[SegmentSnapshot]) -> PackedSegment:
    """Merge N snapshots (dropping deleted docs) into one packed segment."""
    masks, maps, new_max_doc = _remap(snapshots)

    field_infos = FieldInfos()
    for snap in snapshots:
        for fi in snap.packed.field_infos:
            field_infos.get_or_add(fi.name).update(fi)
            # preserve index options etc. via update(); numbering is fresh

    all_fields = sorted({f for snap in snapshots for f in snap.packed.fields})
    terms_out: dict[str, dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
    offsets_out: dict[str, dict[str, tuple[np.ndarray, np.ndarray]]] = {}
    payloads_out: dict[str, dict[str, list]] = {}
    stats_out: dict[str, FieldStats] = {}

    # one vectorized whole-segment decode per snapshot, shared across fields
    from rucene_tpu_torch.codec.bulk_read import decode_all_positions, segment_postings_columnar

    columnar = [segment_postings_columnar(s.packed) for s in snapshots]
    decoded_positions = [
        decode_all_positions(s.packed, col[2]) for s, col in zip(snapshots, columnar)
    ]
    # per snapshot: global-term offset of each field (field_id order)
    field_tbase = []
    for snap in snapshots:
        offs = {}
        pos = 0
        for name in sorted(snap.packed.fields, key=lambda n: snap.packed.fields[n].field_id):
            offs[name] = pos
            pos += len(snap.packed.fields[name].terms)
        field_tbase.append(offs)

    for field in all_fields:
        # union of sorted term lists
        import heapq

        seg_terms = [
            snap.packed.fields[field].terms if field in snap.packed.fields else []
            for snap in snapshots
        ]
        union: list[str] = []
        for t in heapq.merge(*seg_terms):
            if not union or union[-1] != t:
                union.append(t)
        umap_cache = {t: i for i, t in enumerate(union)}

        tid_parts, doc_parts, freq_parts, posrun_parts, poslen_parts = [], [], [], [], []
        pos_offset = 0
        pos_arrays = []
        any_off = any(s.packed.off_starts is not None for s in snapshots)
        any_pay = any(s.packed.pay is not None for s in snapshots)
        offs_arrays, offe_arrays, pay_arrays = [], [], []
        for si, snap in enumerate(snapshots):
            pf = snap.packed.fields.get(field)
            seg_positions = decoded_positions[si]
            if pf is None:
                continue
            post_start, docs_all, freqs_all = columnar[si]
            t0 = field_tbase[si][field]
            s0, e0 = int(post_start[t0]), int(post_start[t0 + len(pf.terms)])
            fdocs = docs_all[s0:e0]
            ffreqs = freqs_all[s0:e0]
            df = pf.doc_freq.astype(np.int64)
            # per-posting local term ord and union term id
            tid_local = np.repeat(np.arange(len(pf.terms)), df)
            remap = np.fromiter((umap_cache[t] for t in pf.terms), np.int64, len(pf.terms))
            tids = remap[tid_local]
            # per-posting position run starts (within this segment's stream)
            cf = np.cumsum(ffreqs) - ffreqs
            term_first = np.concatenate([[0], np.cumsum(df)])[:-1]
            within = cf - np.repeat(cf[term_first] if len(cf) else np.zeros(0, np.int64), df)
            run_start = np.repeat(pf.pos_start.astype(np.int64), df) + within + pos_offset
            # live filter + doc remap
            keep = masks[si][fdocs]
            tid_parts.append(tids[keep])
            doc_parts.append(maps[si][fdocs[keep]])
            freq_parts.append(ffreqs[keep])
            posrun_parts.append(run_start[keep])
            poslen_parts.append(ffreqs[keep])
            pos_arrays.append(seg_positions)
            if any_off:
                so = snap.packed.off_starts
                offs_arrays.append(
                    so if so is not None else np.full(len(seg_positions), -1, np.int32)
                )
                eo = snap.packed.off_ends
                offe_arrays.append(
                    eo if eo is not None else np.full(len(seg_positions), -1, np.int32)
                )
            if any_pay:
                pa = snap.packed.pay
                if pa is None:
                    pa = np.empty(len(seg_positions), dtype=object)
                pay_arrays.append(pa)
            pos_offset += len(seg_positions)

        st = FieldStats()
        if tid_parts:
            tids = np.concatenate(tid_parts)
            ndocs = np.concatenate(doc_parts)
            nfreqs = np.concatenate(freq_parts)
            runs = np.concatenate(posrun_parts)
            order = np.lexsort((ndocs, tids))
            tids = tids[order]
            ndocs = ndocs[order].astype(np.int32)
            nfreqs_i64 = nfreqs[order]
            runs = runs[order]
            nfreqs = nfreqs_i64.astype(np.int32)
            pos_all = (
                np.concatenate(pos_arrays) if pos_arrays else np.zeros(0, np.int32)
            )
            # gather position runs in merged posting order
            total_pos = int(nfreqs_i64.sum())
            moffs = mends = mpay = None
            if total_pos:
                bases = np.concatenate([[0], np.cumsum(nfreqs_i64)])[:-1]
                idx = np.repeat(runs - bases, nfreqs_i64) + np.arange(total_pos)
                mpos = pos_all[idx].astype(np.int32)
                # offsets/payloads are occurrence-aligned with the positions
                # stream, so the same gather carries them through the merge
                if any_off:
                    off_all = np.concatenate(offs_arrays)
                    moffs = off_all[idx].astype(np.int32)
                    mends = np.concatenate(offe_arrays)[idx].astype(np.int32)
                if any_pay:
                    mpay = np.concatenate(pay_arrays)[idx]
            else:
                mpos = np.zeros(0, np.int32)
            # CSR per union term
            final_df = np.bincount(tids, minlength=len(union)).astype(np.int64)
            pstart = np.concatenate([[0], np.cumsum(final_df)])
            fstart = np.concatenate([[0], np.cumsum(nfreqs_i64)])
            fout: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
            f_offs: dict[str, tuple[np.ndarray, np.ndarray]] = {}
            f_pays: dict[str, list] = {}
            for u, term in enumerate(union):
                a, z = int(pstart[u]), int(pstart[u + 1])
                if a == z:
                    continue
                # zero-copy views into the columnar arrays
                oa, oz = int(fstart[a]), int(fstart[z])
                fout[term] = (ndocs[a:z], nfreqs[a:z], mpos[oa:oz])
                if moffs is not None:
                    f_offs[term] = (moffs[oa:oz], mends[oa:oz])
                if mpay is not None:
                    f_pays[term] = list(mpay[oa:oz])
                st.sum_doc_freq += z - a
            if fout:
                terms_out[field] = fout
                if f_offs and any(int(s.max(initial=-1)) >= 0 for s, _ in f_offs.values()):
                    offsets_out[field] = f_offs
                if f_pays and any(p is not None for ps in f_pays.values() for p in ps):
                    payloads_out[field] = f_pays
        stats_out[field] = st

    # norms / stored / dv: live-filtered concat
    norms_out: dict[str, np.ndarray] = {}
    norm_fields = sorted({f for snap in snapshots for f in snap.packed.norms})
    for field in norm_fields:
        parts = []
        for si, snap in enumerate(snapshots):
            src = snap.packed.norms.get(field)
            if src is None:
                src = np.zeros(snap.max_doc, dtype=np.uint8)
            parts.append(src[masks[si]])
        norms_out[field] = np.concatenate(parts) if parts else np.zeros(0, np.uint8)

    stored_out: list[dict[str, object]] = []
    any_tv = any(snap.packed.term_vectors is not None for snap in snapshots)
    tv_out: list | None = [] if any_tv else None
    for si, snap in enumerate(snapshots):
        tvs = snap.packed.term_vectors
        for d in range(snap.max_doc):
            if masks[si][d]:
                stored_out.append(snap.packed.stored[d])
                if tv_out is not None:
                    tv_out.append(tvs[d] if tvs is not None else {})

    dv_out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    dv_fields = sorted(
        {f for snap in snapshots for f in snap.packed.numeric_dv}
        | {f for snap in snapshots for f in snap.dv_updates}
    )
    for field in dv_fields:
        vparts, pparts = [], []
        for si, snap in enumerate(snapshots):
            dv = snap.numeric_doc_values(field)  # updates applied
            if dv is None:
                vparts.append(np.zeros(int(masks[si].sum()), np.int64))
                pparts.append(np.zeros(int(masks[si].sum()), bool))
            else:
                vparts.append(np.asarray(dv[0])[masks[si]])
                pparts.append(np.asarray(dv[1])[masks[si]])
        dv_out[field] = (np.concatenate(vparts), np.concatenate(pparts))

    # field stats: doc_count / sum_ttf recomputed from surviving postings
    for field in all_fields:
        st = stats_out[field]
        fout = terms_out.get(field, {})
        if fout:
            # docs with field = union of docs across terms; compute via norms
            # when present, else from postings
            if field in norms_out:
                st.doc_count = int((norms_out[field] > 0).sum())
            else:
                seen = np.zeros(new_max_doc, dtype=bool)
                for d, _, _ in fout.values():
                    seen[d] = True
                st.doc_count = int(seen.sum())
            st.sum_total_term_freq = int(sum(int(f.sum()) for _, f, _ in fout.values()))

    points_out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    pt_fields = sorted({f for snap in snapshots for f in snap.packed.points})
    for field in pt_fields:
        vparts, dparts = [], []
        for si, snap in enumerate(snapshots):
            pt = snap.packed.points.get(field)
            if pt is None:
                continue
            vals, docs = pt
            keep = masks[si][docs]
            vparts.append(vals[keep])
            dparts.append(maps[si][docs[keep]])
        if vparts:
            v = np.concatenate(vparts)
            dd = np.concatenate(dparts)
            if v.ndim == 2:  # multi-dim: rebuild the BKD leaf order
                from rucene_tpu_torch.util.bkd import build_bkd

                t = build_bkd(v, dd.astype(np.int32))
                points_out[field] = (t.vals, t.docs)
            else:
                order = np.lexsort((dd, v))
                points_out[field] = (v[order], dd[order].astype(np.int32))

    def live_docs_of(si):
        return np.nonzero(masks[si])[0]

    bdv_fields = sorted(
        {f for s in snapshots if s.packed.binary_dv for f in s.packed.binary_dv}
        | {f for s in snapshots for f in s.bdv_updates}
    )
    bdv_out = {}
    for field in bdv_fields:
        per_doc = []
        for si, snap in enumerate(snapshots):
            col = snap.binary_doc_values(field)  # updates applied
            for d in live_docs_of(si):
                per_doc.append(col[d] if col is not None else None)
        bdv_out[field] = per_doc

    sdv_fields = sorted({f for s in snapshots if s.packed.sorted_dv for f in s.packed.sorted_dv})
    sdv_out = {}
    for field in sdv_fields:
        # global value dict = union; remap per-segment ords
        union = sorted({
            v
            for s in snapshots
            if s.packed.sorted_dv and field in s.packed.sorted_dv
            for v in s.packed.sorted_dv[field][0]
        })
        vmap = {v: i for i, v in enumerate(union)}
        ords_out = np.full(new_max_doc, -1, np.int32)
        for si, snap in enumerate(snapshots):
            e = (snap.packed.sorted_dv or {}).get(field)
            if e is None:
                continue
            values, ords = e
            remap = np.array([vmap[v] for v in values], np.int32) if values else np.zeros(0, np.int32)
            for d in live_docs_of(si):
                o = ords[d]
                if o >= 0:
                    ords_out[maps[si][d]] = remap[o]
        sdv_out[field] = (union, ords_out)

    sndv_fields = sorted({f for s in snapshots if s.packed.sorted_numeric_dv for f in s.packed.sorted_numeric_dv})
    sndv_out = {}
    for field in sndv_fields:
        flat, offs = [], np.zeros(new_max_doc + 1, np.int64)
        rows = [[] for _ in range(new_max_doc)]
        for si, snap in enumerate(snapshots):
            e = (snap.packed.sorted_numeric_dv or {}).get(field)
            if e is None:
                continue
            fl, of = e
            for d in live_docs_of(si):
                rows[maps[si][d]] = list(fl[of[d] : of[d + 1]])
        for d in range(new_max_doc):
            flat.extend(rows[d])
            offs[d + 1] = len(flat)
        sndv_out[field] = (np.asarray(flat, np.int64), offs)

    ssdv_fields = sorted({f for s in snapshots if s.packed.sorted_set_dv for f in s.packed.sorted_set_dv})
    ssdv_out = {}
    for field in ssdv_fields:
        union = sorted({
            v
            for s in snapshots
            if s.packed.sorted_set_dv and field in s.packed.sorted_set_dv
            for v in s.packed.sorted_set_dv[field][0]
        })
        vmap = {v: i for i, v in enumerate(union)}
        rows = [[] for _ in range(new_max_doc)]
        for si, snap in enumerate(snapshots):
            e = (snap.packed.sorted_set_dv or {}).get(field)
            if e is None:
                continue
            values, flat_ords, of = e
            remap = np.array([vmap[v] for v in values], np.int32) if values else np.zeros(0, np.int32)
            for d in live_docs_of(si):
                rows[maps[si][d]] = sorted(remap[flat_ords[of[d] : of[d + 1]]].tolist())
        flat_o, offs = [], np.zeros(new_max_doc + 1, np.int64)
        for d in range(new_max_doc):
            flat_o.extend(rows[d])
            offs[d + 1] = len(flat_o)
        ssdv_out[field] = (union, np.asarray(flat_o, np.int32), offs)

    seg = SegmentData(
        max_doc=new_max_doc,
        field_infos=field_infos,
        terms=terms_out,
        norms=norms_out,
        stats=stats_out,
        stored=stored_out,
        numeric_dv=dv_out,
        points=points_out,
        term_vectors=tv_out,
        binary_dv=bdv_out or None,
        sorted_dv=sdv_out or None,
        sorted_numeric_dv=sndv_out or None,
        sorted_set_dv=ssdv_out or None,
        offsets=offsets_out or None,
        payloads=payloads_out or None,
    )
    return pack_segment(seg)


@dataclass
class MergeCandidate:
    segments: list[str]  # segment names


class TieredMergePolicy:
    """Size-tiered selection (simplified TieredMergePolicy,
    reference merge_policy.rs:414): merge the `merge_factor` smallest
    segments whenever at least `segs_per_tier + merge_factor - 1` segments
    exist; force_merge collapses everything.

    max_merged_segment_docs / max_merged_segment_mb cap merge output size
    (merge_policy.rs:455): segments over half a cap are never merge
    inputs, and a candidate is trimmed so its combined live doc count and
    byte size stay under the caps. deletes_pct_allowed triggers reclaim
    rewrites of segments whose delete ratio exceeds it, independent of the
    tier threshold (reference find_forced_deletes_merges)."""

    def __init__(
        self,
        merge_factor: int = 10,
        segs_per_tier: int = 10,
        max_merged_segment_docs: int | None = None,
        deletes_pct_allowed: float = 50.0,
        max_merged_segment_mb: float | None = None,
    ):
        self.merge_factor = merge_factor
        self.segs_per_tier = segs_per_tier
        self.max_merged_segment_docs = max_merged_segment_docs
        self.deletes_pct_allowed = deletes_pct_allowed
        self.max_merged_segment_mb = max_merged_segment_mb

    def find_merges(
        self,
        sizes: dict[str, int],
        deletes: dict[str, int] | None = None,
        byte_sizes: dict[str, int] | None = None,
    ) -> list[MergeCandidate]:
        out: list[MergeCandidate] = []
        claimed: set[str] = set()

        # deletes-percentage reclaim: rewrite high-garbage segments even
        # when the tier threshold isn't met (a 1-segment merge drops dead
        # docs and re-packs)
        if deletes:
            for name, size in sizes.items():
                dels = deletes.get(name, 0)
                total = size + dels
                if total > 0 and 100.0 * dels / total > self.deletes_pct_allowed:
                    out.append(MergeCandidate([name]))
                    claimed.add(name)

        cap = self.max_merged_segment_docs
        bcap = (
            int(self.max_merged_segment_mb * 1024 * 1024)
            if self.max_merged_segment_mb is not None and byte_sizes is not None
            else None
        )
        bsz = byte_sizes or {}
        pool = {
            n: s
            for n, s in sizes.items()
            if n not in claimed
            and (cap is None or s <= cap // 2)
            and (bcap is None or bsz.get(n, 0) <= bcap // 2)
        }
        if len(pool) >= self.segs_per_tier + self.merge_factor - 1:
            by_size = sorted(pool, key=lambda n: pool[n])
            cand = by_size[: self.merge_factor]

            def fits(names):
                if cap is not None and sum(pool[n] for n in names) > cap:
                    return False
                if bcap is not None and sum(bsz.get(n, 0) for n in names) > bcap:
                    return False
                return True

            # trim the biggest inputs until the output fits both caps
            while len(cand) > 2 and not fits(cand):
                cand.pop()
            if len(cand) >= 2 and fits(cand):
                out.append(MergeCandidate(cand))
        return out

    def find_forced_merges(self, sizes: dict[str, int], max_segments: int) -> list[MergeCandidate]:
        if len(sizes) <= max_segments:
            return []
        by_size = sorted(sizes, key=lambda n: sizes[n])
        n_merge = len(sizes) - max_segments + 1
        return [MergeCandidate(by_size[:n_merge])]

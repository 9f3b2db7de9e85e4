"""Phrase routes for IndexSearcher (counterpart of
rucene_tpu/search/phrase_path.py): pure phrase rows (one PhraseQuery of
2-8 terms, MUST or SHOULD, with no other clause) and mixed rows (term
clauses and up to 8 range clauses plus one exact MUST or FILTER phrase,
_search_mixed_device: the term clauses through the flat work list and the
combine kernel, the ranges through their filter planes
(search/filter_path.py), the phrase through its position planes, one
executor.execute_mixed_planes call per arity and chunk of rows).

Three routes per (pure phrase row, leaf):
  1. candidate pipeline (search/phrase_device.py): block selection driven
     by the rarest term, then position verify over candidate tables;
  2. position planes (ops/phrase_plane.py): per-term bit planes and a
     shifted-AND verify, O(max_doc) — mid and heavy exact rows on leaves
     of PHRASE_PLANE_MIN_DOCS or more, planes LRU-cached on the device and
     prewarmed for the resident set;
  3. scalar C++ engine (search/scalar_engine.py): exact rows on leaves
     under PHRASE_SCALAR_MAX_DOCS, and the exact residue the device routes
     cannot take.
What the scalar engine cannot take (a sloppy row the candidate tables
declined, or any row without the native library) the numpy host engine
evaluates (search/host_engine.py, _scalar_fallback), as the reference
does; no row is answered approximately.

Counters (rows unless named): ``search.phrase_device``,
``search.phrase_plane``, ``search.phrase_plane_build`` (planes built),
``search.phrase_plane_denied`` (plane fetches refused by admission),
``search.phrase_scalar_route``, ``search.phrase_host_fallback`` (rows the
scalar engine or the host engine took after a device route declined
them) and ``search.phrase_pruned_blocks`` (blocks the selection dropped);
``search.mixed_host_spill`` (mixed rows a leaf sends back: their planes
admission denied, or their term matches meet a plane's overflow column;
each such row reruns whole on the host route).

Caches are module-wide as in the reference, so searchers over one segment
share them. The plane caches and the memos hold a weak reference to the
packed segment their key's id() names, and a hit requires it to be that
segment: a segment merged away in NRT serving goes once no reader holds
it, and its device planes at the next plane fetch (drop_dead_planes; the
reference's entries pin their segment until the LRU evicts them, under a
budget of up to 16 GB). The scalar engine cache holds its segment.
Position planes and denominator planes are keyed by (segment, torch
device) as well. Left out: span groups and synonyms (ROADMAP.md §1 item
9), the pow2 row pads, the static slop / has_ef programs,
``MAX_BUILD_ITEMS``' slicing of hot terms, and the ``search.plane_bytes``
roofline counter.

reference: ExactPhraseScorer/SloppyPhraseScorer
(src/core/search/scorer/phrase_scorer.rs:122,442) lead with the lowest-df
term; conjunction_scorer.rs orders by cost.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from rucene_tpu_torch.codec.device import device_bytes, phrase_plane_budget
from rucene_tpu_torch.util.metrics import METRICS

# position-plane cache: (id(packed), device, field, term) -> (plane,
# overflow, weak packed-ref); denominator planes under (id(packed), device,
# "denom", fid, cache row bytes) with overflow None. Byte-budgeted LRU.
# The weak reference lets a segment that no reader or writer holds any
# more (merged away in NRT serving) go, and drop_dead_planes frees its
# planes at the next plane fetch.
_PLANE_CACHE: dict = {}

# candidate block-selection memo: (id(packed), field, terms, budget) ->
# ((blocks, slots) | None, weak packed-ref). Popular phrases repeat across
# batches; the selection host-decodes the rarest term's postings.
_BLOCKSEL_CACHE: dict = {}
_BLOCKSEL_CAP = 8192

# resident-set memo: (id(packed), field) -> (ordered terms tuple, term set,
# weak packed-ref). Keyed without the budget, so admission is stable for a
# segment's lifetime. See _plane_resident_terms.
_RESIDENT_CACHE: dict = {}

# plane-width memo: (id(packed), field) -> (words, weak packed-ref).
_PLANE_WORDS_CACHE: dict = {}

# scalar C++ engine cache: id(packed) -> (engine, live-ref, packed-ref)
_SCALAR_ENGINE_CACHE: dict = {}


def drop_dead_planes() -> int:
    """Drop the plane-cache entries of segments that have been freed;
    returns the bytes released."""
    freed = 0
    for key, (plane, overflow, ref) in list(_PLANE_CACHE.items()):
        if ref() is None and _PLANE_CACHE.pop(key, None) is not None:
            freed += plane.numel() * plane.element_size()
            freed += 0 if overflow is None else overflow.numel()
    return freed


def _plane_hit(key, packed):
    """The entry under ``key`` if it was built for ``packed``, moved to the
    LRU's end; None otherwise (an entry of a freed segment whose id() came
    back with another segment goes)."""
    got = _PLANE_CACHE.pop(key, None)
    if got is None or got[2]() is not packed:
        return None
    _PLANE_CACHE[key] = got
    return got


def _plane_cache_bytes() -> int:
    total = 0
    for plane, overflow, _ref in _PLANE_CACHE.values():
        total += plane.numel() * plane.element_size()
        if overflow is not None:
            total += overflow.numel()
    return total


def _seg_key(leaf) -> tuple:
    return (id(leaf.packed), str(leaf.torch_device))


def _idf_weight(sim, stats, doc_freqs, field, terms, boost) -> np.float32:
    """boost * sum(idf) * (k1 + 1), f32 at every step in reference order."""
    st = stats[field]
    doc_count = st.doc_count if st.doc_count != -1 else st.max_doc
    idf_sum = np.float32(0.0)
    for t in terms:
        idf_sum = np.float32(idf_sum + sim.idf(doc_freqs[(field, t)], doc_count))
    w = np.float32(idf_sum * np.float32(boost))
    return np.float32(w * np.float32(sim.k1 + np.float32(1.0)))


def resident_plane_count(budget: int, mdp: int, words: int, frac: float) -> int:
    """Planes of ``words`` u32 words a doc (plus the overflow byte) that
    ``frac`` of a plane budget holds over doc axis ``mdp``; at least one."""
    return max(1, int(budget * frac) // max(mdp * (words * 4 + 1), 1))


class PhrasePathMixin:
    """Phrase routing + execution; mixed into IndexSearcher. Relies on the
    searcher for: reader, similarity, _gather_stats, _merge_leaf_hits."""

    # per-row rarest-term df budget: candidates are bounded by df_min, so
    # rows fit the device pipeline up to the 65536-candidate table cap;
    # above it planes or the scalar engine take the row
    PHRASE_ROW_DF_BUDGET = 60000
    PHRASE_ROW_ITEM_BUDGET = 4096
    # exact rows whose selected work exceeds this many blocks verify on
    # position planes instead of candidate tables (on leaves big enough for
    # planes to amortize their cache footprint)
    PHRASE_PLANE_ITEM_MIN = 64
    PHRASE_PLANE_MIN_DOCS = 200_000
    # rows per phrase_plane_search_many call at 1M docs: bounds the [R, md]
    # transients (scaled down on bigger leaves)
    PHRASE_PLANE_CHUNK = 64
    # below this leaf size, exact rows go straight to the scalar engine
    PHRASE_SCALAR_MAX_DOCS = 200_000
    # fraction of the plane budget the resident set may fill; the rest is
    # headroom for denominator planes and on-demand builds
    PLANE_RESIDENT_FRAC = 0.75
    # admission only bites on big leaves: below this doc count a plane
    # build is cheap, so any term may be built on demand
    PLANE_ADMIT_MIN_DOCS = 2_000_000

    def _phrase_device_eligible(self, rq) -> bool:
        """A pure phrase row the phrase routes serve: one phrase of 2 to
        NMAX terms without gaps, MUST or SHOULD (SHOULD equals MUST for a
        lone phrase), slop at most SLOP_CAP, and no other clause."""
        from rucene_tpu_torch.search.phrase_device import NMAX, SLOP_CAP
        from rucene_tpu_torch.search.query import Occur

        return (
            rq is not None
            and len(rq.phrases) == 1
            and rq.phrase_occur(0) in (Occur.MUST, Occur.SHOULD)
            and not rq.clauses
            and not rq.ranges
            and not rq.groups
            and not rq.match_all
            and 0 <= rq.phrases[0][3] <= SLOP_CAP
            and 2 <= len(rq.phrases[0][1]) <= NMAX
            and all(t is not None for t in rq.phrases[0][1])
        )

    def _mixed_device_eligible(self, rq) -> bool:
        """A mixed row _search_mixed_device serves: term clauses, at most 8
        range clauses and one exact MUST or FILTER phrase of 2-8 terms
        without gaps, in a plain row with no groups and no match-all.
        Sloppy, SHOULD and multi-phrase mixes take the host route."""
        from rucene_tpu_torch.search.query import Occur

        return (
            rq is not None
            and len(rq.phrases) == 1
            and rq.phrase_occur(0) in (Occur.MUST, Occur.FILTER)
            and bool(rq.clauses)
            and not rq.groups
            and len(rq.ranges) <= 8
            and not rq.match_all
            and rq.plain
            and rq.phrases[0][3] == 0
            and 2 <= len(rq.phrases[0][1]) <= 8
            and all(t is not None for t in rq.phrases[0][1])
        )

    @staticmethod
    def _phrase_blocks_for_row(leaf, field, terms, recs, budget_df: int):
        """Candidate-driven block selection for one phrase row, memoized per
        (segment, field, terms, budget): see _phrase_blocks_uncached."""
        ck = (id(leaf.packed), field, tuple(terms), budget_df)
        hit = _BLOCKSEL_CACHE.pop(ck, None)
        if hit is not None and hit[1]() is leaf.packed:
            _BLOCKSEL_CACHE[ck] = hit  # refresh LRU position
            return hit[0]
        picked = PhrasePathMixin._phrase_blocks_uncached(leaf, field, terms, recs, budget_df)
        _BLOCKSEL_CACHE[ck] = (picked, weakref.ref(leaf.packed))
        while len(_BLOCKSEL_CACHE) > _BLOCKSEL_CAP:
            _BLOCKSEL_CACHE.pop(next(iter(_BLOCKSEL_CACHE)))
        return picked

    @staticmethod
    def _phrase_blocks_uncached(leaf, field, terms, recs, budget_df: int):
        """The block form of the reference's rarest-term leapfrog:
        host-decode the rarest term's doc ids, keep only the blocks of every
        other term whose doc range contains one of them. Returns (blocks,
        slots) arrays, or None when df_min exceeds budget_df."""
        dfs = [r.doc_freq for r in recs]
        rare = int(np.argmin(dfs))
        if dfs[rare] > budget_df:
            return None
        field_docs = None
        blk_parts, slot_parts = [], []
        bf, bl = leaf.packed.blk_first_doc, leaf.packed.blk_last_doc
        for j, rec in enumerate(recs):
            all_b = np.arange(rec.block_start, rec.block_start + rec.block_count, dtype=np.int32)
            if j == rare:
                blk_parts.append(all_b)
                slot_parts.append(np.full(len(all_b), j, np.int32))
                continue
            if field_docs is None:
                p = leaf.read_postings(field, terms[rare])
                field_docs = np.asarray(p[0], np.int64) if p is not None else np.zeros(0, np.int64)
            # keep blocks whose [first, last] contains some rare-term doc
            idx = np.searchsorted(field_docs, bf[all_b].astype(np.int64), side="left")
            hit = (idx < len(field_docs)) & (
                field_docs[np.minimum(idx, max(len(field_docs) - 1, 0))]
                <= bl[all_b].astype(np.int64)
            )
            keep_b = all_b[hit] if len(field_docs) else all_b[:0]
            blk_parts.append(keep_b)
            slot_parts.append(np.full(len(keep_b), j, np.int32))
        return np.concatenate(blk_parts), np.concatenate(slot_parts)

    def _search_phrases_device(self, queries, rqs, k: int, _defer: bool = False):
        """Batch of pure phrase rows. Per leaf: block selection first, then
        rows whose pruned work fits the candidate tables run the pipeline,
        mid and heavy exact rows run on position planes, and the scalar
        engine takes the rest in one call per leaf.

        _defer=True returns a finish() closure: the candidate and plane
        work is queued on the device and the scalar rows evaluated on the
        host (overlapping it) before returning; every read of a device
        result waits until finish()."""
        from rucene_tpu_torch.search.flat_tables import build_leaf_cache
        from rucene_tpu_torch.search.phrase_device import PhraseBatch, execute_phrases_impl

        sim = self.similarity
        doc_freqs, stats = self._gather_stats(rqs)
        b_actual = len(rqs)

        per_query_leaf = [[] for _ in range(b_actual)]
        deferred_jobs = []  # (leaf, cand_job | None, plane_futs)
        for leaf in self.reader.leaves:
            # ---- small-leaf shortcut: exact rows go straight to the
            # scalar engine ----
            direct_sc: list[int] = []
            if leaf.max_doc < self.PHRASE_SCALAR_MAX_DOCS:
                try:
                    self._scalar_engine_for(leaf, sim, stats, doc_freqs)
                    direct_sc = [i for i, rq in enumerate(rqs) if rq.phrases[0][3] == 0]
                except RuntimeError:
                    pass  # no native engine: keep the device pipeline
            direct_set = set(direct_sc)

            # ---- per-row candidate-driven block selection ----
            blk_list, row_list, slot_list, pw_list, ws_list = [], [], [], [], []
            fid_of = np.zeros(b_actual, np.int32)
            absent = np.zeros(b_actual, bool)
            sc_rows: list[int] = []
            plane_pref: list[int] = []  # routed straight to position planes
            total_before = 0
            for i, rq in enumerate(rqs):
                if i in direct_set:
                    continue
                field, terms, _b, _s = rq.phrases[0]
                pf = leaf.packed.fields.get(field)
                recs = [leaf.term_record(field, t) for t in terms] if pf else []
                if pf is None or any(r is None for r in recs):
                    absent[i] = True
                    continue
                fid_of[i] = pf.field_id
                plane_ok = rq.phrases[0][3] == 0 and leaf.max_doc >= self.PHRASE_PLANE_MIN_DOCS
                picked = self._phrase_blocks_for_row(
                    leaf, field, terms, recs, self.PHRASE_ROW_DF_BUDGET
                )
                if picked is None or len(picked[0]) > self.PHRASE_ROW_ITEM_BUDGET:
                    sc_rows.append(i)  # truly heavy: planes or scalar
                    continue
                if (
                    plane_ok
                    and len(picked[0]) >= self.PHRASE_PLANE_ITEM_MIN
                    and self._planes_admitted(leaf, field, terms)
                ):
                    plane_pref.append(i)  # mid-weight: planes beat the tables
                    continue
                total_before += sum(r.block_count for r in recs)
                blocks_i, slots_i = picked
                blk_list.append(blocks_i)
                row_list.append(np.full(len(blocks_i), i, np.int32))
                slot_list.append(slots_i)
                pw_list.append(np.asarray([r.pos_width for r in recs], np.int32)[slots_i])
                ws_list.append(np.asarray([r.pos_word_start for r in recs], np.int32)[slots_i])
            if blk_list:
                blocks = np.concatenate(blk_list)
                rows_a = np.concatenate(row_list)
                slots_a = np.concatenate(slot_list)
                pws_a = np.concatenate(pw_list)
                wss_a = np.concatenate(ws_list)
            else:
                blocks = rows_a = slots_a = pws_a = wss_a = np.zeros(0, np.int32)
            pruned = total_before - len(blocks)
            if pruned > 0:
                METRICS.incr("search.phrase_pruned_blocks", pruned)

            cnt_r = np.bincount(rows_a, minlength=b_actual)
            sc_set = set(sc_rows)
            plane_set = set(plane_pref)
            dev_rows = [
                i for i in range(b_actual)
                if not absent[i] and i not in sc_set and cnt_r[i] > 0
            ]
            # rows with a missing term or fully-pruned work match nothing
            for i in np.flatnonzero(absent | (cnt_r == 0)):
                if int(i) in sc_set or int(i) in plane_set or int(i) in direct_set:
                    continue  # answered by the plane/scalar paths
                per_query_leaf[i].append(
                    (leaf.doc_base, np.zeros(0, np.int32), np.zeros(0, np.float32), 0)
                )

            cand_job = None  # (bmap, dev_rows, result tensors)
            if dev_rows:
                bmap = {gi: li for li, gi in enumerate(dev_rows)}
                nb = len(dev_rows)
                n_terms = np.zeros(nb, np.int32)
                weight = np.zeros(nb, np.float32)
                slop = np.zeros(nb, np.int32)
                fid = np.zeros(nb, np.int32)
                for gi in dev_rows:
                    li = bmap[gi]
                    field, terms, boost, sl = rqs[gi].phrases[0]
                    weight[li] = _idf_weight(sim, stats, doc_freqs, field, terms, boost)
                    n_terms[li] = len(terms)
                    slop[li] = sl
                    fid[li] = fid_of[gi]
                dsel = np.isin(rows_a, dev_rows)
                d_blocks = blocks[dsel]
                d_rows = np.asarray([bmap[gi] for gi in rows_a[dsel]], np.int32)
                w = len(d_blocks)
                cand_cap = min(w * 128, 65536)
                fmax = 32
                fwin = min(fmax, max(int(leaf.packed.blk_max_freq[d_blocks].max()), 1))
                d = leaf.torch_device
                cache = build_leaf_cache(leaf, sim, stats)
                pb = PhraseBatch(
                    wi_block=_put(d_blocks, d), wi_row=_put(d_rows, d),
                    wi_slot=_put(slots_a[dsel], d),
                    wi_valid=torch.ones(w, dtype=torch.bool, device=d),
                    n_terms=_put(n_terms, d), weight=_put(weight, d, np.float32),
                    fid=_put(fid, d), cache=_put(cache, d, np.float32),
                    wi_pos_width=_put(pws_a[dsel], d), wi_pos_start=_put(wss_a[dsel], d),
                    slop=_put(slop, d),
                )
                res = execute_phrases_impl(
                    leaf.device, pb, k=k, cand_cap=cand_cap, fmax=fmax,
                    slop_max=int(slop.max()), nmax=int(n_terms.max()), fwin=fwin,
                )
                METRICS.incr("search.phrase_device", len(dev_rows))
                cand_job = (bmap, dev_rows, res)

            # ---- heavy/mid rows: position planes; rows a plane cannot
            # serve exactly (slop > 0, or overflow docs) join the scalar
            # call. Queued here, collected in finish() ----
            heavy_rows = plane_pref + [i for i in sc_rows if rqs[i].phrases[0][3] == 0]
            pset = set(heavy_rows)
            scalar_rows = [i for i in sc_rows if i not in pset]
            plane_rows = []
            for i in heavy_rows:
                field_i, terms_i = rqs[i].phrases[0][0], rqs[i].phrases[0][1]
                if self._planes_admitted(leaf, field_i, terms_i):
                    plane_rows.append(i)
                else:
                    scalar_rows.append(i)
            plane_futs = []
            if plane_rows:
                plane_futs, plane_spill, early_done = self._dispatch_phrase_planes(
                    leaf, plane_rows, rqs, sim, stats, doc_freqs, k
                )
                scalar_rows.extend(plane_spill)
                METRICS.incr("search.phrase_plane", len(early_done))
                for gi, (dd, ss, hh) in early_done.items():
                    per_query_leaf[gi].append((leaf.doc_base, dd, ss, hh))

            # ---- scalar C++ rows: host work, running while the device
            # work above is in flight ----
            if scalar_rows:
                METRICS.incr("search.phrase_host_fallback", len(scalar_rows))
            if direct_sc:
                METRICS.incr("search.phrase_scalar_route", len(direct_sc))
            host_rows = scalar_rows + direct_sc
            if host_rows:
                hits = self._scalar_fallback_batch(
                    leaf, [rqs[i] for i in host_rows], [queries[i] for i in host_rows],
                    sim, stats, doc_freqs, k,
                )
                for gi, hh in zip(host_rows, hits):
                    per_query_leaf[gi].append((leaf.doc_base, hh.docs, hh.scores, hh.total_hits))
            deferred_jobs.append((leaf, cand_job, plane_futs))

        def finish() -> list:
            for leaf, cand_job, plane_futs in deferred_jobs:
                overflow_rows: list[int] = []
                if cand_job is not None:
                    bmap, dev_rows, res = cand_job
                    s, d, h, ov = (x.cpu().numpy() for x in res)
                    for gi in dev_rows:
                        li = bmap[gi]
                        if ov[li]:
                            overflow_rows.append(gi)
                        else:
                            per_query_leaf[gi].append((leaf.doc_base, d[li], s[li], int(h[li])))
                done, spill = self._plane_collect(plane_futs)
                METRICS.incr("search.phrase_plane", len(done))
                for gi, (dd, ss, hh) in done.items():
                    per_query_leaf[gi].append((leaf.doc_base, dd, ss, hh))
                # rare residue: exact candidate-table overflow rows retry on
                # the plane path; plane-overflow rows rerun on the scalar
                # engine, sloppy overflow rows on the host engine
                plane_retry = [i for i in overflow_rows if rqs[i].phrases[0][3] == 0]
                pset2 = set(plane_retry)
                late_scalar = [i for i in overflow_rows if i not in pset2]
                if plane_retry:
                    done2, spill2 = self._search_phrase_planes(
                        leaf, plane_retry, rqs, sim, stats, doc_freqs, k
                    )
                    METRICS.incr("search.phrase_plane", len(done2))
                    for gi, (dd, ss, hh) in done2.items():
                        per_query_leaf[gi].append((leaf.doc_base, dd, ss, hh))
                    spill = spill + spill2
                late_scalar = late_scalar + spill
                if late_scalar:
                    METRICS.incr("search.phrase_host_fallback", len(late_scalar))
                    hits = self._scalar_fallback_batch(
                        leaf, [rqs[i] for i in late_scalar], [queries[i] for i in late_scalar],
                        sim, stats, doc_freqs, k,
                    )
                    for gi, hh in zip(late_scalar, hits):
                        per_query_leaf[gi].append((leaf.doc_base, hh.docs, hh.scores, hh.total_hits))
            return [self._merge_leaf_hits(per_query_leaf[i], k) for i in range(b_actual)]

        if _defer:
            return finish
        return finish()

    def _plane_budget_bytes(self, leaf) -> int:
        """Plane-cache byte budget for this leaf: codec/device.
        phrase_plane_budget over its doc axis and its own tensors, the
        same rule as the tf planes' and the same on every device. At 1M
        docs that is the 16 GB cap: the resident set holds about 1,300
        half-width planes of 9.2 MB."""
        dev = leaf.device
        return phrase_plane_budget(dev.max_doc_padded, device_bytes(dev))

    def _plane_admission_active(self, leaf) -> bool:
        return leaf.device.max_doc_padded > self.PLANE_ADMIT_MIN_DOCS

    def _plane_words(self, leaf, field: str) -> int:
        """u32 words per doc for this (leaf, field)'s position planes: 2
        (64 positions) when every doc's length provably fits, else 4. The
        bound comes from the norm bytes: norm_table[b] = 1/f^2 >= len
        whenever boost <= 1. A doc a boost pushed past it only sets the
        overflow column."""
        key = (id(leaf.packed), field)
        got = _PLANE_WORDS_CACHE.get(key)
        if got is not None and got[1]() is leaf.packed:
            return got[0]
        from rucene_tpu_torch.util.small_float import norm_table

        words = 4
        nb = leaf.packed.norms.get(field)
        if nb is not None and len(nb):
            if float(norm_table()[np.asarray(nb)].max()) <= 64.0:
                words = 2
        _PLANE_WORDS_CACHE[key] = (words, weakref.ref(leaf.packed))
        if len(_PLANE_WORDS_CACHE) > 256:
            _PLANE_WORDS_CACHE.pop(next(iter(_PLANE_WORDS_CACHE)))
        return words

    def _plane_resident_terms(self, leaf, field: str):
        """(ordered tuple, set) of the block-count-descending prefix of the
        field's terms that fits PLANE_RESIDENT_FRAC of the plane budget:
        the serving-time admission set on big leaves (planes are built on
        the query path only for terms that will stay cached)."""
        key = (id(leaf.packed), field)
        got = _RESIDENT_CACHE.get(key)
        if got is not None and got[2]() is leaf.packed:
            return got[0], got[1]
        pf = leaf.packed.fields.get(field)
        if pf is None:
            out = ((), frozenset())
        else:
            n = min(len(pf.terms), resident_plane_count(
                self._plane_budget_bytes(leaf), leaf.device.max_doc_padded,
                self._plane_words(leaf, field), self.PLANE_RESIDENT_FRAC,
            ))
            bc = np.asarray(pf.block_count)
            order = np.argsort(bc, kind="stable")[::-1][:n]
            keep = order[bc[order] >= 1]
            terms = tuple(pf.terms[int(o)] for o in keep)
            out = (terms, frozenset(terms))
        _RESIDENT_CACHE[key] = (out[0], out[1], weakref.ref(leaf.packed))
        if len(_RESIDENT_CACHE) > 64:
            _RESIDENT_CACHE.pop(next(iter(_RESIDENT_CACHE)))
        return out

    def _planes_admitted(self, leaf, field: str, terms) -> bool:
        """True when every term is already cached or in the resident set —
        routing this row to planes cannot thrash the cache."""
        if not self._plane_admission_active(leaf):
            return True  # small leaf: on-demand builds are cheap
        res = None
        for t in terms:
            got = _PLANE_CACHE.get(_seg_key(leaf) + (field, t))
            if got is not None and got[2]() is leaf.packed:
                continue
            if res is None:
                res = self._plane_resident_terms(leaf, field)[1]
            if t not in res:
                return False
        return True

    def _phrase_plane_for(self, leaf, field: str, term: str):
        """Device-cached (plane, overflow) for one term, LRU-bounded by the
        plane budget (evicting before the build, so a new plane never
        stacks on a full cache). None for an absent term."""
        from rucene_tpu_torch.ops.phrase_plane import FMAX, build_position_plane

        key = _seg_key(leaf) + (field, term)
        got = _plane_hit(key, leaf.packed)
        if got is not None:
            return got[0], got[1]
        rec = leaf.term_record(field, term)
        if rec is None:
            return None
        blocks = np.arange(rec.block_start, rec.block_start + rec.block_count, dtype=np.int32)
        drop_dead_planes()
        budget = self._plane_budget_bytes(leaf)
        p_words = self._plane_words(leaf, field)
        new_bytes = leaf.device.max_doc_padded * (p_words * 4 + 1)  # plane + overflow
        while len(_PLANE_CACHE) > 1 and _plane_cache_bytes() > budget - new_bytes:
            _PLANE_CACHE.pop(next(iter(_PLANE_CACHE)))
        fwin = min(FMAX, max(int(leaf.packed.blk_max_freq[blocks].max()), 1)) if len(blocks) else 1
        plane, overflow = build_position_plane(
            leaf.device, _put(blocks, leaf.torch_device), rec.pos_width,
            rec.pos_word_start, words=p_words, fwin=fwin,
        )
        METRICS.incr("search.phrase_plane_build")
        _PLANE_CACHE[key] = (plane, overflow, weakref.ref(leaf.packed))
        while len(_PLANE_CACHE) > 1 and _plane_cache_bytes() > budget:
            _PLANE_CACHE.pop(next(iter(_PLANE_CACHE)))
        return plane, overflow

    def _phrase_planes_for_many(self, leaf, wants, admit: bool = False):
        """(plane, overflow) for many (field, term) pairs: cache hits at
        once, misses built one after another (each build's launches queue
        behind the last). Returns dict[(field, term)] -> (plane, overflow)
        | None (absent term) | False (admit=True and the term is outside
        the resident set: the caller routes the row elsewhere)."""
        out: dict = {}
        for field, term in wants:
            fkey = (field, term)
            if fkey in out:
                continue
            key = _seg_key(leaf) + (field, term)
            got = _plane_hit(key, leaf.packed)
            if got is not None:
                out[fkey] = (got[0], got[1])
                continue
            if leaf.term_record(field, term) is None:
                out[fkey] = None
                continue
            if (
                admit
                and self._plane_admission_active(leaf)
                and term not in self._plane_resident_terms(leaf, field)[1]
            ):
                out[fkey] = False  # denied: would thrash the cache
                METRICS.incr("search.phrase_plane_denied")
                continue
            out[fkey] = self._phrase_plane_for(leaf, field, term)
        return out

    def prewarm_phrase_planes(self, field: str = "body", min_blocks: int | None = None) -> int:
        """Build the resident position-plane set off the serving path: the
        resident terms of at least min_blocks blocks (PHRASE_PLANE_ITEM_MIN
        by default) on every leaf of PHRASE_PLANE_MIN_DOCS or more. After
        it the query path builds no plane for those terms. Returns the
        number of planes built or found cached. Call at index load."""
        if min_blocks is None:
            min_blocks = self.PHRASE_PLANE_ITEM_MIN
        built = 0
        for leaf in self.reader.leaves:
            if leaf.max_doc < self.PHRASE_PLANE_MIN_DOCS:
                continue
            pf = leaf.packed.fields.get(field)
            if pf is None:
                continue
            ordered, _res = self._plane_resident_terms(leaf, field)
            wants = [
                (field, t) for t in ordered
                if int(pf.block_count[pf.term_ord[t]]) >= min_blocks
            ]
            if wants:
                got = self._phrase_planes_for_many(leaf, wants)
                built += sum(1 for v in got.values() if v is not None)
        return built

    def _denom_plane_for(self, leaf, fid: int, cache_row: np.ndarray):
        """Device-cached f32[mdp] BM25 denominator plane for one field,
        cache_row[norm_byte[doc]], built once per (leaf, field, stats)."""
        key = _seg_key(leaf) + ("denom", fid, cache_row.tobytes())
        got = _plane_hit(key, leaf.packed)
        if got is not None:
            return got[0]
        row = torch.from_numpy(np.ascontiguousarray(cache_row, np.float32)).to(leaf.torch_device)
        denom = row[leaf.device.norms[fid].long()]
        _PLANE_CACHE[key] = (denom, None, weakref.ref(leaf.packed))
        return denom

    def _search_mixed_device(self, queries, rqs, k: int, _defer: bool = False):
        """Mixed rows (term clauses and ranges plus one required exact
        phrase): per leaf, the phrase planes fetched with admission, then
        one executor.execute_mixed_planes call per (arity, chunk of rows),
        whose term clauses take the flat work list, the lane decode and
        the combine kernel, and whose ranges take the chunk's filter
        planes. A FILTER phrase is weighted 0. A term absent from a leaf
        (phrase or required clause) means no hit there.

        Two kinds of row go back, as in the reference: rows whose planes
        admission denied, and rows whose term matches meet a plane's
        overflow column (ov_count > 0). Each is counted under
        ``search.mixed_host_spill`` (a row a leaf) and reruns whole on the
        host route (_search_host), exactly.

        _defer=True returns a finish() closure: every leaf's calls are
        queued now, every read of a result waits until finish()."""
        from rucene_tpu_torch.search.executor import execute_mixed_planes
        from rucene_tpu_torch.search.flat_tables import (
            build_clause_tables,
            build_combine_batch,
            build_flat_work,
            build_leaf_cache,
            build_leaf_tables,
            make_flat_batch,
        )
        from rucene_tpu_torch.search.query import Occur

        sim = self.similarity
        b = len(rqs)
        doc_freqs, stats = self._gather_stats(rqs)
        per_query_leaf: list[list] = [[] for _ in range(b)]
        spilled: set[int] = set()
        futures = []  # (leaf, rows, result tensors)
        for leaf in self.reader.leaves:
            if self._past_deadline():
                break  # partial results, as on the term path
            cache = build_leaf_cache(leaf, sim, stats)
            dev = leaf.device
            mdp = dev.max_doc_padded
            plane_map = self._phrase_planes_for_many(
                leaf, [(rq.phrases[0][0], t) for rq in rqs for t in rq.phrases[0][1]],
                admit=True,
            )
            by_arity: dict[int, list[int]] = {}
            for i, rq in enumerate(rqs):
                by_arity.setdefault(len(rq.phrases[0][1]), []).append(i)
            chunk_rows = max(1, min(self.PHRASE_PLANE_CHUNK, (self.PHRASE_PLANE_CHUNK << 20) // mdp))
            for nt, idxs in sorted(by_arity.items()):
                for c0 in range(0, len(idxs), chunk_rows):
                    cells = []  # (gi, planes, overflows, denom, weight)
                    for gi in idxs[c0 : c0 + chunk_rows]:
                        field, terms, boost, _sl = rqs[gi].phrases[0]
                        got = [plane_map.get((field, t)) for t in terms]
                        if any(g is False for g in got):
                            spilled.add(gi)  # admission denied
                            METRICS.incr("search.mixed_host_spill")
                            continue
                        if any(g is None for g in got):
                            continue  # a phrase term absent here: no hit
                        fid = leaf.packed.fields[field].field_id
                        w = _idf_weight(sim, stats, doc_freqs, field, terms, boost)
                        if rqs[gi].phrase_occur(0) == Occur.FILTER:
                            w = np.float32(0.0)  # a required, unscored phrase
                        cells.append((
                            gi, [g[0] for g in got], [g[1] for g in got],
                            self._denom_plane_for(leaf, fid, cache[fid]), w,
                        ))
                    if not cells:
                        continue
                    sub = [rqs[gi] for gi, *_ in cells]
                    nb = len(sub)
                    t = max(len(rq.clauses) for rq in sub)
                    weight, occur, n_req, min_should, _ma, _bo = build_clause_tables(
                        sub, sim, doc_freqs, stats, nb, t
                    )
                    bs, bc, fids = build_leaf_tables(leaf, sub, nb, t)
                    work = build_flat_work(bs, bc, weight, fids, occur)[:6]
                    filters = (
                        self._leaf_filters(leaf, *self._range_filter_tables(sub, nb))
                        if any(rq.ranges for rq in sub) else None
                    )
                    METRICS.incr("search.flat_lanes", int(work[5].sum()) * 128)
                    fq = make_flat_batch(work, n_req, min_should, cache, dev, dedupe=True)
                    combine = build_combine_batch(
                        work, nb, leaf.packed.blk_first_doc, leaf.packed.blk_last_doc,
                        mdp, dev.device,
                    )
                    res = execute_mixed_planes(
                        dev, fq, combine,
                        tuple(p for c in cells for p in c[1]),
                        tuple(o for c in cells for o in c[2]),
                        tuple(c[3] for c in cells),
                        _put([c[4] for c in cells], dev.device, np.float32), k, nt,
                        filters=filters,
                    )
                    futures.append((leaf, [c[0] for c in cells], res))

        def finish() -> list:
            for leaf, gis, res in futures:
                s, d, h, ovc = (x.cpu().numpy() for x in res)
                for li, gi in enumerate(gis):
                    if int(ovc[li]) > 0:
                        spilled.add(gi)
                        METRICS.incr("search.mixed_host_spill")
                        continue
                    keep = s[li] > -np.inf
                    per_query_leaf[gi].append((leaf.doc_base, d[li][keep], s[li][keep], int(h[li])))
            return [
                self._search_host(queries[i], k) if i in spilled
                else self._merge_leaf_hits(per_query_leaf[i], k)
                for i in range(b)
            ]

        if _defer:
            return finish
        return finish()

    def _search_phrase_planes(self, leaf, rows, rqs, sim, stats, doc_freqs, k):
        """Exact rows via position planes, collected now: (done: gi ->
        (docs, scores, hits), spill: rows for the scalar engine)."""
        futs, spill, done = self._dispatch_phrase_planes(leaf, rows, rqs, sim, stats, doc_freqs, k)
        d2, sp2 = self._plane_collect(futs)
        done.update(d2)
        spill.extend(sp2)
        return done, spill

    def _dispatch_phrase_planes(self, leaf, rows, rqs, sim, stats, doc_freqs, k):
        """Queue the plane search of ``rows``: returns (futures, spill,
        done). Rows go in groups bounded by live plane bytes (the LRU can
        only free planes no group holds): a group's terms take at most a
        quarter of the budget. All groups but the last are collected here,
        so a deferred caller pins one group's planes."""
        from rucene_tpu_torch.search.flat_tables import build_leaf_cache

        cache = build_leaf_cache(leaf, sim, stats)
        mdp = leaf.device.max_doc_padded
        w0 = self._plane_words(leaf, rqs[rows[0]].phrases[0][0]) if rows else 4
        plane_bytes = mdp * (w0 * 4 + 1)
        max_terms_live = max(8, (self._plane_budget_bytes(leaf) // 4) // max(plane_bytes, 1))
        groups: list[list[int]] = []
        cur: list[int] = []
        cur_terms: set = set()
        for gi in rows:
            field, terms, _b, _sl = rqs[gi].phrases[0]
            tset = {(field, t) for t in terms}
            if cur and len(cur_terms | tset) > max_terms_live:
                groups.append(cur)
                cur, cur_terms = [], set()
            cur.append(gi)
            cur_terms |= tset
        if cur:
            groups.append(cur)
        done: dict = {}
        spill: list[int] = []
        futures: list = []
        for n, grp in enumerate(groups):
            futs, sp = self._plane_group_dispatch(leaf, grp, rqs, sim, stats, doc_freqs, k, cache, mdp)
            spill.extend(sp)
            if n < len(groups) - 1:
                d2, sp2 = self._plane_collect(futs)
                done.update(d2)
                spill.extend(sp2)
            else:
                futures.extend(futs)
        return futures, spill, done

    def _plane_group_dispatch(self, leaf, rows, rqs, sim, stats, doc_freqs, k, cache, mdp):
        """One bounded group: fetch or build its planes and queue one
        phrase_plane_search_many per (arity, row chunk); returns ((gis,
        result tensors) list, spill)."""
        from rucene_tpu_torch.ops.phrase_plane import phrase_plane_search_many

        spill: list[int] = []
        plane_map = self._phrase_planes_for_many(
            leaf, [(rqs[gi].phrases[0][0], t) for gi in rows for t in rqs[gi].phrases[0][1]],
            admit=True,
        )
        by_arity: dict[int, list[tuple]] = {}
        for gi in rows:
            field, terms, boost, _sl = rqs[gi].phrases[0]
            got = [plane_map.get((field, t)) for t in terms]
            if not all(got):  # absent (None) or admission-denied (False)
                spill.append(gi)
                continue
            fid = leaf.packed.fields[field].field_id
            by_arity.setdefault(len(terms), []).append((
                gi, [g[0] for g in got], [g[1] for g in got],
                self._denom_plane_for(leaf, fid, cache[fid]),
                _idf_weight(sim, stats, doc_freqs, field, terms, boost),
            ))
        # rows per call scale inversely with the doc space: the search holds
        # several [R, md] transients
        chunk_rows = max(1, min(self.PHRASE_PLANE_CHUNK, (self.PHRASE_PLANE_CHUNK << 20) // max(mdp, 1)))
        futures = []
        for nt, grp in sorted(by_arity.items()):
            for c0 in range(0, len(grp), chunk_rows):
                chunk = grp[c0 : c0 + chunk_rows]
                res = phrase_plane_search_many(
                    tuple(p for row in chunk for p in row[1]),
                    tuple(o for row in chunk for o in row[2]),
                    leaf.device.live, tuple(row[3] for row in chunk),
                    _put([row[4] for row in chunk], leaf.torch_device, np.float32),
                    k=k, n_terms=nt,
                )
                futures.append(([row[0] for row in chunk], res))
        return futures, spill

    @staticmethod
    def _plane_collect(futures):
        """Collect (gis, result) pairs from _plane_group_dispatch: (done: gi
        -> (docs, scores, hits), spill rows whose planes overflowed — they
        rerun on the scalar engine)."""
        done: dict = {}
        spill: list[int] = []
        for gis, res in futures:
            s, d, h, ovc = (x.cpu().numpy() for x in res)
            for li, gi in enumerate(gis):
                if int(ovc[li]) > 0:
                    spill.append(gi)
                    continue
                keep = s[li] > -np.inf
                done[gi] = (d[li][keep], s[li][keep], int(h[li]))
        return done, spill

    def _scalar_fallback_batch(self, leaf, rqs, queries, sim, stats, doc_freqs, k):
        """Batched scalar-engine evaluation on one leaf; the numpy host
        engine per row (_scalar_fallback) where the engine cannot take the
        batch: a sloppy or gapped phrase, or no native library."""
        supported = all(
            rq is not None and not rq.groups and not rq.ranges and rq.plain
            and all(sl == 0 for (_f, _t, _b, sl) in rq.phrases)
            and all(t is not None for (_f, ts, _b, _s) in rq.phrases for t in ts)
            for rq in rqs
        )
        if supported:
            try:
                sc = self._scalar_engine_for(leaf, sim, stats, doc_freqs)
                return sc.search_batch(rqs, k=k)
            except (RuntimeError, ValueError):
                pass
        return [
            self._scalar_fallback(leaf, rq, q, sim, stats, doc_freqs, k)
            for rq, q in zip(rqs, queries)
        ]

    def _scalar_engine_for(self, leaf, sim, stats, doc_freqs):
        from rucene_tpu_torch.search.scalar_engine import ScalarSearcher

        key = id(leaf.packed)
        cached = _SCALAR_ENGINE_CACHE.get(key)
        if cached is None or cached[1] is not leaf.live or cached[2] is not leaf.packed:
            cached = (ScalarSearcher(leaf, sim, stats, doc_freqs), leaf.live, leaf.packed)
            _SCALAR_ENGINE_CACHE[key] = cached
            while len(_SCALAR_ENGINE_CACHE) > 64:
                _SCALAR_ENGINE_CACHE.pop(next(iter(_SCALAR_ENGINE_CACHE)))
        else:
            eng = cached[0]
            if eng.sim is not sim or eng.stats != stats:
                # its BM25 norm tables were made from the old statistics: an
                # NRT refresh that adds docs changes them (the reference
                # keeps serving the stale tables)
                eng._cache_rows, eng._cache_idx = [], {}
            eng.sim = sim
            eng.stats = stats
            eng.doc_freqs = doc_freqs
        return cached[0]

    def _scalar_fallback(self, leaf, rq, query, sim, stats, doc_freqs, k):
        """One query on one leaf through the scalar C++ engine, or the numpy
        host engine where the shape is unsupported or the native library
        is absent. The host engine reads the Query object, so queries with
        their own evaluator (host_eval) take it."""
        from rucene_tpu_torch.search import host_engine

        if rq is not None and not rq.groups and not rq.ranges and rq.plain and all(
            sl == 0 for (_f, _t, _b, sl) in rq.phrases
        ):
            try:
                sc = self._scalar_engine_for(leaf, sim, stats, doc_freqs)
                return sc.search_batch([rq], k=k)[0]
            except (RuntimeError, ValueError):
                pass
        m, acc = host_engine.evaluate_query(leaf, query, sim, stats, doc_freqs)
        return host_engine.hits_from_dense(leaf, m, acc, k)


def _put(a, device, dtype=np.int32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

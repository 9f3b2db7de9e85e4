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
``search.phrase_plane_build_calls`` (the batched builds that built them),
``search.phrase_plane_denied`` (plane fetches refused by admission),
``search.phrase_scalar_route``, ``search.phrase_host_fallback`` (rows the
scalar engine or the host engine took after a device route declined
them) and ``search.phrase_pruned_blocks`` (blocks the selection dropped);
``search.phrase_select_device`` (phrases whose blocks a leaf selected on
its device) and ``search.phrase_select_waits`` (those selections' waits,
one a leaf call); ``search.mixed_host_spill`` (mixed rows a leaf sends
back: their planes admission denied, or their term matches meet a plane's
overflow column; each such row reruns whole on the host route).

Stage spans of the pure phrase path (util/metrics.trace), inside the
searcher's ``search.phrases.dispatch`` and ``search.phrases``:
``search.phrases.select`` (the statistics, then once a leaf the rows'
block selection and routing, with ``search.phrases.postings`` around the
selections the memo lacks: their host tables, the one device pass and its
wait), ``search.phrases.launch`` (the candidate tables' uploads and
pipeline, the plane dispatch, and in collect the plane retry of overflow
rows; ``search.phrases.plane_build`` around the planes a fetch misses,
built in one pass, whichever path asks), ``search.phrases.scalar``
(each scalar-engine call), ``search.phrases.wait`` (the copies of the
candidate and plane results) and ``search.phrases.merge`` (the rows' hit
lists). ``search.prewarm_planes`` times prewarm_phrase_planes. The mixed
and span routes keep only the searcher's outer spans.

Position, span-group and denominator planes, block selections, resident
sets, plane widths and scalar engines are derived from a packed segment and
held by module-wide instances of index/derived.DerivedCache, so searchers
over one segment share them. DerivedCache holds each segment (and a scalar
engine's live mask) by weak reference: a segment merged away in NRT
serving goes once no reader holds it, and its entries at the next insert.

Span-near rows whose children are plain terms or SpanOr groups of plain
terms, all distinct, ride the position planes too
(_search_span_unordered_device, ``route.span_unordered``): unordered ones
of slop <= 24 through ops/phrase_plane.span_unordered_plane_search_many,
ordered slop-0 ones through phrase_plane_search_many over the group
planes; rows that meet an overflow column rerun on the host
(``search.span_host_spill``). Left out: the pow2 row pads, the static
slop / has_ef programs,
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
from rucene_tpu_torch.index.derived import DerivedCache
from rucene_tpu_torch.ops.phrase_plane import work_lanes
from rucene_tpu_torch.util.metrics import METRICS, trace

# (device, field, term or ("or", members) | "denom", fid, stats) ->
# (plane, overflow or None), within the plane budget (_plane_budget_bytes)
_PLANE_CACHE = DerivedCache()
_BLOCKSEL_CACHE = DerivedCache(8192)  # (field, terms, budget) -> (blocks, slots) | None
# field -> (ordered terms, term set), without the budget: admission is
# stable for a segment's lifetime
_RESIDENT_CACHE = DerivedCache(64)
_PLANE_WORDS_CACHE = DerivedCache(256)  # field -> u32 plane words a doc
_SCALAR_ENGINE_CACHE = DerivedCache(64)  # of (packed segment, live mask)
_MISS = object()  # a block selection may be None


def _plane_at(leaf, key: tuple) -> tuple:
    """(anchors, key) of ``leaf``'s planes under ``key`` on its device."""
    return (leaf.packed,), (str(leaf.torch_device),) + key


def _plane_put(leaf, key: tuple, plane, overflow, budget: int | None):
    nbytes = plane.nbytes + (0 if overflow is None else overflow.nbytes)
    return _PLANE_CACHE.put(*_plane_at(leaf, key), (plane, overflow), nbytes, budget)


def plane_term(leaf, rec) -> tuple:
    """ops/phrase_plane.build_position_planes' argument for the term record
    ``rec`` of ``leaf``: (its block ids, delta width, first stream word,
    fwin: its blocks' largest freq, at most FMAX)."""
    from rucene_tpu_torch.ops.phrase_plane import FMAX

    blocks = np.arange(rec.block_start, rec.block_start + rec.block_count)
    fwin = min(FMAX, max(int(leaf.packed.blk_max_freq[blocks].max()), 1)) if len(blocks) else 1
    return blocks, rec.pos_width, rec.pos_word_start, fwin


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


def _concat_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The ranges [starts[i], starts[i] + counts[i]) end to end (int64)."""
    ends = np.cumsum(counts)
    return np.arange(ends[-1], dtype=np.int64) + np.repeat(starts - (ends - counts), counts)


def select_phrase_blocks(leaf, recs_list, budget_df: int) -> list:
    """The block form of the reference's rarest-term leapfrog for a batch
    of phrases on one leaf, ``recs_list`` each phrase's term records: a
    phrase keeps its rarest term's blocks whole and, of every other term,
    the blocks whose [blk_first_doc, blk_last_doc] holds one of the rarest
    term's doc ids. Returns per phrase (blocks i32, slots i32) in slot
    order, or None when its smallest df exceeds budget_df.

    The doc ids stay on the leaf's device: the rare blocks' lanes
    (work_lanes: a gather of the decoded planes, or K1 on a packed leaf)
    make one non-decreasing key array (phrase << 32 | doc), a pad lane
    taking its block's last doc through a running max, and one
    searchsorted tests every other block's range against it. One upload
    and one copy of the keep mask back a call, counted under
    ``search.phrase_select_device`` (phrases) and
    ``search.phrase_select_waits``."""
    out: list = [None] * len(recs_list)
    sel = []  # (phrase index, its records, its rarest slot)
    for n, recs in enumerate(recs_list):
        dfs = [r.doc_freq for r in recs]
        rare = int(np.argmin(dfs))
        if dfs[rare] <= budget_df:
            sel.append((n, recs, rare))
    if not sel:
        return out
    # a term of a phrase: the phrase, its slot, its record, whether rarest
    t_miss, t_slot, t_rec, t_rare = zip(*[
        (m, j, r, j == rare) for m, (_n, recs, rare) in enumerate(sel) for j, r in enumerate(recs)
    ])
    counts = np.asarray([r.block_count for r in t_rec], np.int64)
    blk = _concat_ranges(np.asarray([r.block_start for r in t_rec], np.int64), counts)
    miss = np.repeat(np.asarray(t_miss, np.int64), counts)
    slot = np.repeat(np.asarray(t_slot, np.int32), counts)
    keep = np.repeat(np.asarray(t_rare, bool), counts)  # the rarest's blocks stay whole
    other = ~keep
    tag = miss[other] << 32
    keep[other] = _keep_blocks(
        leaf.device, blk[keep], miss[keep],
        tag | leaf.packed.blk_first_doc[blk[other]], tag | leaf.packed.blk_last_doc[blk[other]],
    )
    METRICS.incr("search.phrase_select_device", len(sel))
    blk_k, slot_k = blk[keep].astype(np.int32), slot[keep]
    bounds = np.searchsorted(miss[keep], np.arange(len(sel) + 1))
    for m, (n, _recs, _rare) in enumerate(sel):
        out[n] = (blk_k[bounds[m] : bounds[m + 1]], slot_k[bounds[m] : bounds[m + 1]])
    return out


# the block selection's stream a card, and the device forms (by their
# blk_count) it has ordered after the stream that built them
_SELECT_STREAMS: dict = {}
_SELECT_FENCED = DerivedCache()


def _keep_blocks(dev, rare_blk, rare_miss, lo, hi) -> np.ndarray:
    """bool[len(lo)]: whether some lane of a rare block of phrase p lies in
    [lo, hi], the other term's block range tagged with its phrase p in the
    high word. On a card the work runs on a stream of its own: it reads
    only the leaf's static device form and this call's upload, so the
    wait does not queue behind earlier batches' kernels."""
    up = torch.from_numpy(np.concatenate([rare_blk, rare_miss, lo, hi]))
    r = len(rare_blk)
    if dev.device.type == "cuda":
        side = _select_stream(dev)
        up = up.pin_memory()
        with torch.cuda.stream(side):
            got = torch.empty(len(lo), dtype=torch.bool, pin_memory=True)
            got.copy_(_keep_mask(dev, up.to(dev.device, non_blocking=True), r), non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
    else:
        got = _keep_mask(dev, up, r)
    METRICS.incr("search.phrase_select_waits")
    return got.numpy()


def _keep_mask(dev, up: torch.Tensor, r: int) -> torch.Tensor:
    """_keep_blocks' device work over ``up`` = [rare blocks | their
    phrases | lo | hi] (int64), the rare blocks the first r."""
    blk, miss = up[:r], up[r : 2 * r]
    lo, hi = up[2 * r :].view(2, -1)
    docs, _freqs, valid = work_lanes(dev, blk, dev.blk_count[blk])
    key = torch.where(valid, (miss[:, None] << 32) | docs.long(), -1).reshape(-1)
    # a sentinel past every range stands for "no doc at or after lo"
    key = torch.cat([key.cummax(0).values, key.new_full((1,), torch.iinfo(torch.int64).max)])
    return key[torch.searchsorted(key, lo)] <= hi


def _select_stream(dev):
    """The block selection's stream on dev's card. A device form seen the
    first time is ordered after the current stream, which built it."""
    side = _SELECT_STREAMS.get(dev.device)
    if side is None:
        side = _SELECT_STREAMS.setdefault(dev.device, torch.cuda.Stream(dev.device))
    if not _SELECT_FENCED.get((dev.blk_count,)):
        side.wait_stream(torch.cuda.current_stream(dev.device))
        _SELECT_FENCED.put((dev.blk_count,), (), True)
    return side


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
    def _phrase_blocks_for_rows(leaf, wants, budget_df: int) -> list:
        """Candidate-driven block selection for phrase rows, ``wants`` a
        list of (field, terms, term records): each row's selection
        memoized per (segment, field, terms, budget), the misses selected
        together under the ``search.phrases.postings`` span (see
        select_phrase_blocks)."""
        out: list = [None] * len(wants)
        misses: dict = {}  # cache key -> the rows that want it
        seg = (leaf.packed,)
        for n, (field, terms, _recs) in enumerate(wants):
            ck = (field, tuple(terms), budget_df)
            hit = _BLOCKSEL_CACHE.get(seg, ck, _MISS)
            if hit is _MISS:
                misses.setdefault(ck, []).append(n)
            else:
                out[n] = hit
        if misses:
            with trace("search.phrases.postings"):
                picks = select_phrase_blocks(
                    leaf, [wants[rows[0]][2] for rows in misses.values()], budget_df
                )
                for (ck, rows), picked in zip(misses.items(), picks):
                    _BLOCKSEL_CACHE.put(seg, ck, picked)
                    for n in rows:
                        out[n] = picked
        return out

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
        with trace("search.phrases.select"):
            doc_freqs, stats = self._gather_stats(rqs)
        b_actual = len(rqs)

        per_query_leaf = [[] for _ in range(b_actual)]
        deferred_jobs = []  # (leaf, cand_job | None, plane_futs)
        for leaf in self.reader.leaves:
            with trace("search.phrases.select"):
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
                present = []  # (row, field, terms, term records)
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
                    present.append((i, field, terms, recs))
                picks = self._phrase_blocks_for_rows(
                    leaf, [p[1:] for p in present], self.PHRASE_ROW_DF_BUDGET
                )
                big_leaf = leaf.max_doc >= self.PHRASE_PLANE_MIN_DOCS
                for (i, field, terms, recs), picked in zip(present, picks):
                    plane_ok = rqs[i].phrases[0][3] == 0 and big_leaf
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

                # ---- the candidate rows' tables ----
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
                    cache = build_leaf_cache(leaf, sim, stats)

                # ---- heavy/mid rows: position planes; rows a plane cannot
                # serve exactly (slop > 0, or overflow docs) join the scalar
                # call ----
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

            # ---- queued here, collected in finish() ----
            cand_job = None  # (bmap, dev_rows, result tensors)
            plane_futs = []
            if dev_rows or plane_rows:
                with trace("search.phrases.launch"):
                    if dev_rows:
                        d = leaf.torch_device
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
                with trace("search.phrases.scalar"):
                    hits = self._scalar_fallback_batch(
                        leaf, [rqs[i] for i in host_rows], [queries[i] for i in host_rows],
                        sim, stats, doc_freqs, k,
                    )
                    for gi, hh in zip(host_rows, hits):
                        per_query_leaf[gi].append(
                            (leaf.doc_base, hh.docs, hh.scores, hh.total_hits)
                        )
            deferred_jobs.append((leaf, cand_job, plane_futs))

        def finish() -> list:
            for leaf, cand_job, plane_futs in deferred_jobs:
                overflow_rows: list[int] = []
                done: dict = {}
                spill: list[int] = []
                if cand_job is not None or plane_futs:
                    with trace("search.phrases.wait"):
                        if cand_job is not None:
                            bmap, dev_rows, res = cand_job
                            s, d, h, ov = (x.cpu().numpy() for x in res)
                            for gi in dev_rows:
                                li = bmap[gi]
                                if ov[li]:
                                    overflow_rows.append(gi)
                                else:
                                    per_query_leaf[gi].append(
                                        (leaf.doc_base, d[li], s[li], int(h[li]))
                                    )
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
                    with trace("search.phrases.launch"):
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
                    with trace("search.phrases.scalar"):
                        hits = self._scalar_fallback_batch(
                            leaf, [rqs[i] for i in late_scalar],
                            [queries[i] for i in late_scalar], sim, stats, doc_freqs, k,
                        )
                    for gi, hh in zip(late_scalar, hits):
                        per_query_leaf[gi].append((leaf.doc_base, hh.docs, hh.scores, hh.total_hits))
            with trace("search.phrases.merge"):
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
        got = _PLANE_WORDS_CACHE.get((leaf.packed,), field)
        if got is not None:
            return got
        from rucene_tpu_torch.util.small_float import norm_table

        words = 4
        nb = leaf.packed.norms.get(field)
        if nb is not None and len(nb):
            if float(norm_table()[np.asarray(nb)].max()) <= 64.0:
                words = 2
        return _PLANE_WORDS_CACHE.put((leaf.packed,), field, words)

    def _plane_resident_terms(self, leaf, field: str):
        """(ordered tuple, set) of the block-count-descending prefix of the
        field's terms that fits PLANE_RESIDENT_FRAC of the plane budget:
        the serving-time admission set on big leaves (planes are built on
        the query path only for terms that will stay cached)."""
        got = _RESIDENT_CACHE.get((leaf.packed,), field)
        if got is not None:
            return got
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
        return _RESIDENT_CACHE.put((leaf.packed,), field, out)

    def _planes_admitted(self, leaf, field: str, terms) -> bool:
        """True when every term is already cached or in the resident set —
        routing this row to planes cannot thrash the cache."""
        if not self._plane_admission_active(leaf):
            return True  # small leaf: on-demand builds are cheap
        res = None
        for t in terms:
            if _PLANE_CACHE.peek(*_plane_at(leaf, (field, t))) is not None:
                continue
            if res is None:
                res = self._plane_resident_terms(leaf, field)[1]
            if t not in res:
                return False
        return True

    def _phrase_plane_for(self, leaf, field: str, term: str):
        """Device-cached (plane, overflow) for one term (a one-want
        _phrase_planes_for_many); None for an absent term."""
        return self._phrase_planes_for_many(leaf, [(field, term)])[(field, term)]

    def _phrase_planes_for_many(self, leaf, wants, admit: bool = False):
        """(plane, overflow) for many (field, term) pairs: cache hits at
        once, then every miss built in one pass (_build_planes). Returns
        dict[(field, term)] -> (plane, overflow) | None (absent term) |
        False (admit=True and the term is outside the resident set: the
        caller routes the row elsewhere)."""
        out: dict = {}
        misses: dict = {}  # (field, term) -> its term record
        for field, term in wants:
            fkey = (field, term)
            if fkey in out or fkey in misses:
                continue
            got = _PLANE_CACHE.get(*_plane_at(leaf, fkey))
            if got is not None:
                out[fkey] = got
                continue
            rec = leaf.term_record(field, term)
            if rec is None:
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
            misses[fkey] = rec
        if misses:
            out.update(self._build_planes(leaf, misses))
        return out

    def _build_planes(self, leaf, misses: dict) -> dict:
        """Build the position planes of ``misses`` ((field, term) -> term
        record) and put each in the cache under its key: one
        ops/phrase_plane.build_position_planes call a field and chunk of
        at most a quarter of the plane budget, room made in the cache
        before each (so new planes never stack on a full cache). Counts
        planes (``search.phrase_plane_build``) and calls
        (``search.phrase_plane_build_calls``). Returns dict[(field, term)]
        -> (plane, overflow)."""
        from rucene_tpu_torch.ops.phrase_plane import build_position_planes

        budget = self._plane_budget_bytes(leaf)
        mdp = leaf.device.max_doc_padded
        by_field: dict = {}
        for fkey, rec in misses.items():
            by_field.setdefault(fkey[0], []).append((fkey, rec))
        out: dict = {}
        with trace("search.phrases.plane_build"):
            for field, todo in by_field.items():
                p_words = self._plane_words(leaf, field)
                plane_bytes = mdp * (p_words * 4 + 1)  # plane + overflow
                per_call = max(1, (budget // 4) // plane_bytes)
                for c0 in range(0, len(todo), per_call):
                    part = todo[c0 : c0 + per_call]
                    _PLANE_CACHE.make_room(budget, plane_bytes * len(part))
                    terms = [plane_term(leaf, rec) for _fkey, rec in part]
                    built = build_position_planes(leaf.device, terms, p_words)
                    METRICS.incr("search.phrase_plane_build", len(part))
                    METRICS.incr("search.phrase_plane_build_calls")
                    for (fkey, _rec), (plane, overflow) in zip(part, built):
                        out[fkey] = _plane_put(leaf, fkey, plane, overflow, budget)
        return out

    def prewarm_phrase_planes(self, field: str = "body", min_blocks: int | None = None) -> int:
        """Build the resident position-plane set off the serving path: the
        resident terms of at least min_blocks blocks (PHRASE_PLANE_ITEM_MIN
        by default) on every leaf of PHRASE_PLANE_MIN_DOCS or more. After
        it the query path builds no plane for those terms. Returns the
        number of planes built or found cached. Call at index load.

        Timed as ``search.prewarm_planes``; a leaf's device form is built
        first, under its own ``reader.device_build`` span, so that the two
        spans do not nest."""
        if min_blocks is None:
            min_blocks = self.PHRASE_PLANE_ITEM_MIN
        leaves = [
            leaf for leaf in self.reader.leaves
            if leaf.max_doc >= self.PHRASE_PLANE_MIN_DOCS and field in leaf.packed.fields
        ]
        for leaf in leaves:
            _ = leaf.device
        built = 0
        with trace("search.prewarm_planes"):
            for leaf in leaves:
                pf = leaf.packed.fields[field]
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
        key = ("denom", fid, cache_row.tobytes())
        got = _PLANE_CACHE.get(*_plane_at(leaf, key))
        if got is not None:
            return got[0]
        row = torch.from_numpy(np.ascontiguousarray(cache_row, np.float32)).to(leaf.torch_device)
        return _plane_put(leaf, key, row[leaf.device.norms[fid].long()], None, None)[0]

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
                    fq = make_flat_batch(work, n_req, min_should, cache, dev, dedupe=True)
                    combine = build_combine_batch(
                        work, nb, leaf.packed.blk_first_doc, leaf.packed.blk_last_doc,
                        mdp, dev.device, q=fq, buckets=dev.buckets,
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

    def _span_group_info(self, q):
        """(groups, slop, ordered, field, boost) when a SpanNearQuery can ride
        the position planes, else None. groups: per child, its term texts
        (a SpanTermQuery is a singleton, a SpanOrQuery of plain terms one
        OR-plane group). All member terms must be distinct (a position then
        names one child, so the witness algebra holds), member boosts 1,
        2-8 children; unordered rows take slop <= 24, ordered ones only
        slop 0 (greedy chain is consecutive there), and reach this route
        only with SpanOr children (plain-term ordered rows rewrite to a
        phrase through device_equivalent)."""
        from rucene_tpu_torch.search.spans import (
            SpanBoostQuery,
            SpanNearQuery,
            SpanOrQuery,
            SpanTermQuery,
        )

        boost = None
        while type(q) is SpanBoostQuery:
            if boost is None:
                boost = q.boost  # the outermost wrapper carries the total
            q = q.query
        if type(q) is not SpanNearQuery or not (2 <= len(q.clauses) <= 8):
            return None
        if q.in_order:
            if q.slop != 0:
                return None
        elif not (0 <= q.slop <= 24):
            return None
        groups: list[list[str]] = []
        for c in q.clauses:
            if type(c) is SpanTermQuery and c.boost == 1.0:
                groups.append([c.term.text])
            elif (
                type(c) is SpanOrQuery
                and c.boost == 1.0
                and c.clauses
                and all(type(m) is SpanTermQuery and m.boost == 1.0 for m in c.clauses)
            ):
                groups.append([m.term.text for m in c.clauses])
            else:
                return None
        flat = [t for g in groups for t in g]
        if len(set(flat)) != len(flat):
            return None
        return groups, q.slop, q.in_order, q.field, (q.boost if boost is None else boost)

    def _span_unordered_eligible(self, q) -> bool:
        return self._span_group_info(q) is not None

    def _search_span_unordered_device(self, queries, k: int, _defer: bool = False):
        """Span-near rows on the position planes (span_near.rs
        NearSpansUnordered; ordered slop-0 rows with SpanOr children as
        exact phrases over group planes): one call per (leaf, (arity, slop,
        order), chunk of rows), phrase_plane_search_many for the ordered
        rows and span_unordered_plane_search_many for the rest. A row that
        meets a plane's overflow column in a leaf is counted under
        ``search.span_host_spill`` (once, at its first such leaf, as the
        reference counts it) and reruns whole on the host route.
        _defer=True returns a finish() closure that reads the results."""
        from rucene_tpu_torch.ops.phrase_plane import (
            phrase_plane_search_many,
            span_unordered_plane_search_many,
        )
        from rucene_tpu_torch.search.flat_tables import build_leaf_cache

        sim = self.similarity
        b = len(queries)
        infos = [self._span_group_info(q) for q in queries]
        stats_of = [self._gather_stats_query(q) for q in queries]
        futures = []  # (leaf, rows, result tensors)
        for leaf in self.reader.leaves:
            if self._past_deadline():
                break
            mdp = leaf.device.max_doc_padded
            by_shape: dict[tuple, list[int]] = {}
            for i in range(b):
                groups, slop, ordered, _f, _b = infos[i]
                by_shape.setdefault((len(groups), slop, ordered), []).append(i)
            chunk_rows = max(1, min(self.PHRASE_PLANE_CHUNK, (self.PHRASE_PLANE_CHUNK << 20) // mdp))
            for (nt, slop, ordered), idxs in sorted(by_shape.items()):
                for c0 in range(0, len(idxs), chunk_rows):
                    cells = []  # (gi, planes, overflows, denom, weight)
                    for gi in idxs[c0 : c0 + chunk_rows]:
                        groups, _slop, _ord, field, boost = infos[gi]
                        doc_freqs, stats = stats_of[gi]
                        pf_field = leaf.packed.fields.get(field)
                        if pf_field is None or field not in stats:
                            continue  # no such field here: no hits
                        got = [self._group_plane_for(leaf, field, members) for members in groups]
                        if any(g is None for g in got):
                            continue  # a whole child absent here: no hits
                        terms = [t for members in groups for t in members]
                        cache = build_leaf_cache(leaf, sim, stats)
                        fid = pf_field.field_id
                        cells.append((
                            gi, [g[0] for g in got], [g[1] for g in got],
                            self._denom_plane_for(leaf, fid, cache[fid]),
                            _idf_weight(sim, stats, doc_freqs, field, terms, boost),
                        ))
                    if not cells:
                        continue
                    args = (
                        tuple(p for c in cells for p in c[1]),
                        tuple(o for c in cells for o in c[2]),
                        leaf.device.live, tuple(c[3] for c in cells),
                        _put([c[4] for c in cells], leaf.torch_device, np.float32),
                    )
                    if ordered:
                        # slop-0 ordered is consecutive alignment: the exact
                        # phrase AND-shift over the group planes
                        res = phrase_plane_search_many(*args, k=k, n_terms=nt)
                    else:
                        res = span_unordered_plane_search_many(*args, k=k, n_terms=nt, slop=slop)
                    futures.append((leaf, [c[0] for c in cells], res))

        def finish() -> list:
            per_query_leaf: list[list] = [[] for _ in range(b)]
            spilled: set[int] = set()
            for leaf, gis, res in futures:
                s, d, h, ovc = (x.cpu().numpy() for x in res)
                for li, gi in enumerate(gis):
                    if gi in spilled:
                        continue
                    if int(ovc[li]) > 0:
                        spilled.add(gi)
                        METRICS.incr("search.span_host_spill")
                        continue
                    keep = s[li] > -np.inf
                    per_query_leaf[gi].append((leaf.doc_base, d[li][keep], s[li][keep], int(h[li])))
            return [
                self._search_host(queries[i], k) if i in spilled
                else self._merge_leaf_hits(per_query_leaf[i], k)
                for i in range(b)
            ]

        return finish if _defer else finish()

    def _group_plane_for(self, leaf, field: str, members):
        """(plane, overflow) of a span child: a term's position plane, or for
        a SpanOr group the OR of its members' planes (the span union),
        cached like term planes under the segment and device, so the ORs
        run once per distinct group. None when no member is present."""
        if len(members) == 1:
            return self._phrase_plane_for(leaf, field, members[0])
        key = (field, ("or",) + tuple(sorted(members)))
        got = _PLANE_CACHE.get(*_plane_at(leaf, key))
        if got is not None:
            return got
        subs = self._phrase_planes_for_many(leaf, [(field, t) for t in members])
        gp = go = None
        for t in members:
            sub = subs[(field, t)]
            if sub is None:
                continue  # an absent member adds nothing to the union
            gp = sub[0] if gp is None else (gp | sub[0])
            go = sub[1] if go is None else (go | sub[1])
        if gp is None:
            return None
        return _plane_put(leaf, key, gp, go, self._plane_budget_bytes(leaf))

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

        # the engine reads its leaf only inside a call: it holds a proxy,
        # bound anew at each fetch, so a cached engine pins no segment
        proxy = weakref.proxy(leaf)
        anchors = (leaf.packed, leaf.live)
        eng = _SCALAR_ENGINE_CACHE.get(anchors)
        if eng is None:
            return _SCALAR_ENGINE_CACHE.put(anchors, (), ScalarSearcher(proxy, sim, stats, doc_freqs))
        if eng.sim is not sim or eng.stats != stats:
            # its BM25 norm tables were made from the old statistics: an
            # NRT refresh that adds docs changes them (the reference keeps
            # serving the stale tables)
            eng._cache_rows, eng._cache_idx = [], {}
        eng.leaf, eng.sim, eng.stats, eng.doc_freqs = proxy, sim, stats, doc_freqs
        return eng

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

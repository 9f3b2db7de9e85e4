"""Scalar CPU searcher over the packed segment format (a copy of
rucene_tpu/search/scalar_engine.py, held to it by tests/test_torch_host.py).

A faithful reproduction of the reference's scalar hot loops — 128-doc block
decode, skip-list advance, doc-at-a-time conjunction/disjunction, heap
top-k, exact-phrase position verify — in C++ (native/scalar_engine.cpp,
built by rucene_tpu_torch.native), driven from one core over the same
packed index the device serves. The port's phrase path
(search/phrase_path.py) sends it exact phrase rows on leaves under
PHRASE_SCALAR_MAX_DOCS and the exact residue the device routes cannot take.

Reference loops mirrored: bulk_scorer.rs:89-154 (block refill + scoring),
skip_reader.rs:118 (advance), conjunction_scorer.rs / disjunction_scorer.rs
(DAAT combination), collector/top_docs.rs:68-77 (tie-broken heap),
phrase_scorer.rs:122 (ExactPhraseScorer).

Scope: term clauses (all occurs), exact phrases (slop=0), match-all,
min_should_match, live-doc filtering. Ranges/groups/sloppy phrases raise
ValueError.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rucene_tpu_torch import native as _native
from rucene_tpu_torch.search.host_engine import HostHits
from rucene_tpu_torch.search.query import Occur

_OCC = {
    int(Occur.SHOULD): 0,
    int(Occur.MUST): 1,
    int(Occur.MUST_NOT): 2,
    int(Occur.FILTER): 3,
}


class ScalarSearcher:
    """Batched scalar search on one segment snapshot."""

    def __init__(self, leaf, sim, stats, doc_freqs):
        if not _native.available or not hasattr(_native._lib, "rtpu_scalar_search"):
            raise RuntimeError("native scalar engine unavailable")
        self.leaf = leaf
        self.sim = sim
        self.stats = stats
        self.doc_freqs = doc_freqs
        p = leaf.packed
        self._data = np.ascontiguousarray(p.data, np.uint32)
        self._blk_off = np.ascontiguousarray(p.blk_off, np.int32)
        self._blk_dbits = np.ascontiguousarray(p.blk_doc_bits, np.int32)
        self._blk_fbits = np.ascontiguousarray(p.blk_freq_bits, np.int32)
        self._blk_base = np.ascontiguousarray(p.blk_base, np.int32)
        self._blk_count = np.ascontiguousarray(p.blk_count, np.int32)
        self._blk_last = np.ascontiguousarray(p.blk_last_doc, np.int32)
        self._blk_posb = np.ascontiguousarray(p.blk_pos_base, np.int32)
        self._positions = np.ascontiguousarray(p.positions, np.uint32)
        self._live = (
            None
            if leaf.live is None
            else np.ascontiguousarray(leaf.live[: leaf.max_doc], np.uint8)
        )
        self._cache_rows: list[np.ndarray] = []
        self._cache_idx: dict[str, int] = {}

    def _field_cache(self, field: str) -> int:
        ci = self._cache_idx.get(field)
        if ci is None:
            has_norms = field in self.leaf.packed.norms
            row = self.sim.cache_row(self.stats[field] if has_norms else None)
            ci = len(self._cache_rows)
            self._cache_rows.append(np.ascontiguousarray(row, np.float32))
            self._cache_idx[field] = ci
        return ci

    def search_batch(self, rqs, k: int) -> list[HostHits]:
        leaf, sim = self.leaf, self.sim
        nq = len(rqs)
        q_start = np.zeros(nq + 1, np.int64)
        q_minsh = np.zeros(nq, np.int32)
        q_mall = np.zeros(nq, np.uint8)
        q_boost = np.zeros(nq, np.float32)
        bs, bc, wts, occ, cix, pid, pw, pws = [], [], [], [], [], [], [], []
        dead = np.zeros(nq, bool)  # required clause missing -> no hits
        next_pid = 0
        for qi, rq in enumerate(rqs):
            if rq.groups or rq.ranges or not rq.plain:
                raise ValueError(
                    "scalar engine: groups/ranges/dismax/const/demote unsupported"
                )
            n_should_ph = 0
            for i in range(len(rq.phrases)):
                oc = int(rq.phrase_occur(i))
                if oc == int(Occur.SHOULD):
                    if rq.clauses or len(rq.phrases) > 1 or rq.min_should_match > 1:
                        raise ValueError(
                            "scalar engine: optional phrase mixed with other "
                            "clauses unsupported (engine promotes phrases to "
                            "required)"
                        )
                    n_should_ph += 1
                elif oc != int(Occur.MUST):
                    raise ValueError(
                        "scalar engine: MUST_NOT/FILTER phrases unsupported"
                    )
            # phrases are promoted to required below; a lone SHOULD phrase
            # bumped mm to 1 (no required clauses), which the promotion
            # already satisfies — don't double-require it via min_should
            q_minsh[qi] = max(0, rq.effective_min_should() - n_should_ph)
            q_mall[qi] = 1 if rq.match_all else 0
            q_boost[qi] = np.float32(rq.boost)
            for cl in rq.clauses:
                field, text = cl.term.field, cl.term.text
                rec = leaf.term_record(field, text)
                if rec is None:
                    if int(cl.occur) in (int(Occur.MUST), int(Occur.FILTER)):
                        dead[qi] = True
                    continue  # missing SHOULD/NOT contributes nothing
                bs.append(rec.block_start)
                bc.append(rec.block_count)
                if int(cl.occur) in (int(Occur.SHOULD), int(Occur.MUST)):
                    wts.append(
                        sim.term_weight(
                            self.doc_freqs[(field, text)],
                            self.stats[field],
                            cl.boost,
                        )
                    )
                else:
                    wts.append(0.0)
                occ.append(_OCC[int(cl.occur)])
                cix.append(self._field_cache(field))
                pid.append(-1)
                pw.append(0)
                pws.append(0)
            for field, terms, boost, slop in rq.phrases:
                if slop != 0:
                    raise ValueError("scalar engine: sloppy phrases unsupported")
                recs = [leaf.term_record(field, t) for t in terms]
                if any(r is None for r in recs):
                    dead[qi] = True
                    continue
                doc_count = (
                    self.stats[field].doc_count
                    if self.stats[field].doc_count != -1
                    else self.stats[field].max_doc
                )
                idf_sum = np.float32(0.0)
                for t in terms:
                    idf_sum = np.float32(
                        idf_sum + sim.idf(self.doc_freqs[(field, t)], doc_count)
                    )
                w = np.float32(idf_sum * np.float32(boost))
                w2 = np.float32(w * np.float32(sim.k1 + np.float32(1.0)))
                for rec in recs:
                    bs.append(rec.block_start)
                    bc.append(rec.block_count)
                    wts.append(w2)
                    occ.append(1)
                    cix.append(self._field_cache(field))
                    pid.append(next_pid)
                    pw.append(rec.pos_width)
                    pws.append(rec.pos_word_start)
                next_pid += 1
            q_start[qi + 1] = len(bs)

        caches = (
            np.concatenate(self._cache_rows)
            if self._cache_rows
            else np.full(256, float(sim.k1), np.float32)
        )
        nc = len(bs)
        out_docs = np.empty((nq, k), np.int32)
        out_scores = np.empty((nq, k), np.float32)
        out_totals = np.zeros(nq, np.int64)

        c_bs = np.asarray(bs or [0], np.int32)
        c_bc = np.asarray(bc or [0], np.int32)
        c_w = np.asarray(wts or [0], np.float32)
        c_o = np.asarray(occ or [0], np.uint8)
        c_ci = np.asarray(cix or [0], np.int32)
        c_pid = np.asarray(pid or [-1], np.int32)
        c_pw = np.asarray(pw or [0], np.int32)
        c_pws = np.asarray(pws or [0], np.int64)

        # queries with a dead required clause: zero their clause range by
        # flagging min_should unattainably high on an empty clause set is
        # fragile — instead blank the whole query (the C engine emits empty
        # results for clauseless non-match-all queries)
        if dead.any():
            keep = ~dead
            # rebuild per-query clause ranges, dropping dead queries' clauses
            sel = np.zeros(nc, bool)
            new_start = np.zeros(nq + 1, np.int64)
            for qi in range(nq):
                if keep[qi]:
                    sel[q_start[qi] : q_start[qi + 1]] = True
                new_start[qi + 1] = new_start[qi] + (
                    q_start[qi + 1] - q_start[qi] if keep[qi] else 0
                )
            q_start = new_start
            q_mall[dead] = 0
            if nc:
                c_bs, c_bc, c_w, c_o, c_ci, c_pid, c_pw, c_pws = (
                    a[sel] if len(a) == nc else a
                    for a in (c_bs, c_bc, c_w, c_o, c_ci, c_pid, c_pw, c_pws)
                )
                if not len(c_bs):
                    c_bs, c_bc, c_w, c_o, c_ci, c_pid, c_pw, c_pws = (
                        np.asarray([0], np.int32), np.asarray([0], np.int32),
                        np.asarray([0], np.float32), np.asarray([0], np.uint8),
                        np.asarray([0], np.int32), np.asarray([-1], np.int32),
                        np.asarray([0], np.int32), np.asarray([0], np.int64),
                    )

        lib = _native._lib
        live_ptr = (
            self._live.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if self._live is not None
            else None
        )
        rc = lib.rtpu_scalar_search(
            self._data, self._blk_off, self._blk_dbits, self._blk_fbits,
            self._blk_base, self._blk_count, self._blk_last, self._blk_posb,
            self._positions, live_ptr, np.int32(leaf.max_doc),
            np.ascontiguousarray(caches, np.float32),
            np.int32(nq), q_start, q_minsh, q_mall, q_boost,
            c_bs, c_bc, c_w, c_o, c_ci, c_pid, c_pw, c_pws,
            np.int32(k), out_docs, out_scores, out_totals,
        )
        if rc != 0:
            raise RuntimeError(f"scalar engine failed (rc={rc})")
        hits = []
        for qi in range(nq):
            m = int((out_docs[qi] >= 0).sum())
            hits.append(
                HostHits(
                    total_hits=int(out_totals[qi]),
                    docs=out_docs[qi, :m].copy(),
                    scores=out_scores[qi, :m].copy(),
                )
            )
        return hits

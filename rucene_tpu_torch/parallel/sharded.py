"""Multi-device search: segment shards on a [shard, dp] grid of torch
devices and a top-k merge (counterpart of rucene_tpu/parallel/sharded.py).

The reference is rucene's leaf-sliced thread-pool search with
channel-merged collectors (searcher.rs:419-470, 527-630,
collector/top_docs.rs:120) on a TPU mesh. Here:

- Mesh: a [shard, dp] grid of torch devices (make_mesh); segments shard
  over "shard", a batch's rows over "dp". Each cell also names the process
  that owns it (multi_host.make_pod_mesh); in one process every cell is
  its own. A device may stand in several cells: the CPU tests have one CPU
  device where the reference's tests get eight virtual ones, and a
  one-card host still runs four shards.
- ShardedIndex: the leaves (one hot segment split by doc range, codec/
  split.py, when there are fewer segments than shards) partition into at
  most S contiguous groups; each group becomes one combined view
  (index/combined.py) on each of its cells' devices: its own DeviceSegment,
  decoded through the decode kernel (K1) once a shard when decoded_policy
  says so. Shard si's docs sit at ``si * stride + view doc``: monotone in
  the reader's doc order, so the merge's (score desc, doc asc) order is
  Lucene's.
- ShardedSearcher.search_batch: the generic flat executor a (shard, dp)
  cell, its dense branch through the combine kernel (K3) where the
  reference's shape rule picks it, the scoring decode (K2) on packed
  shards; match-all rows (execute_match_all) and range rows (filter planes
  a shard, search/filter_path.view_filters); pure phrase rows through the
  phrase pipeline (search/phrase_device.execute_phrases_impl) over the
  shard's position streams. Each dp column's shard results gather onto its
  first shard's device and merge by one distinct int64 (score, doc) key;
  hit counts add. Rows outside the shard program (mixed phrase and term
  booleans, groups, dismax / constant-score / boosting, host-evaluated
  shapes) go to a cached per-leaf IndexSearcher over the reader, or, in
  partial mode, to exact local evaluation with global statistics.
  Counters: ``route.mesh``, ``route.mesh_phrase``, ``route.mesh_fallback``
  (rows).
- Several processes (multi_host): every process runs the cells it owns;
  the doc freqs of partial mode sum over the processes with one
  all_reduce, and each batch's [B, k] scores and reader doc ids gather
  with all_gather_into_tensor, its hit counts with one all_reduce.

Left out, as TPU machinery: the stacking and padding of every shard to
one shape, the filler shards, the global-array plumbing (_global_stack,
_global_cells, _host_rows) and the processes' OR of has_ef, all of which
exist so that shard_map runs one program on equal shapes; the phrase
step's static capacity ladder (a chunk's candidate table is sized from its
rows' doc freqs, so no row overflows; one that would still goes the
fallback way); ``_maybe_decode_stacked`` / ``_decode_stacked`` and
``cval_stacked`` become the views' own decode and
flat_tables.cval_table_for.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rucene_tpu_torch.index.combined import build_combined_tables, build_combined_view
from rucene_tpu_torch.index.reader import IndexReader
from rucene_tpu_torch.parallel import multi_host
from rucene_tpu_torch.search.executor import execute_match_all
from rucene_tpu_torch.search.filter_path import view_filters
from rucene_tpu_torch.search.flat_tables import (
    build_clause_tables,
    build_flat_work,
    build_range_filter_tables,
)
from rucene_tpu_torch.search.query import Occur, Query, _NeedsHostEval
from rucene_tpu_torch.search.searcher import IndexSearcher, ScoreDoc, TopDocs
from rucene_tpu_torch.search.similarity import BM25Similarity, CollectionStats
from rucene_tpu_torch.ops.topk import DOC_PAD, score_doc_keys
from rucene_tpu_torch.util.metrics import METRICS

PHRASE_CAND_CAP = 1 << 21  # (row, doc) groups a phrase call holds, at most


class Mesh:
    """A [shard, dp] grid of torch devices; ``ranks[s, d]`` is the process
    owning cell (s, d), whose device is None in every other process."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray | None = None):
        self.devices = devices
        self.ranks = np.zeros(devices.shape, np.int64) if ranks is None else ranks
        self.shape = {"shard": devices.shape[0], "dp": devices.shape[1]}

    @property
    def multi_process(self) -> bool:
        return len(set(self.ranks.flat)) > 1


def make_mesh(n_shards: int, n_dp: int = 1, devices=None) -> Mesh:
    """An n_shards x n_dp mesh over ``devices`` (default: every CUDA card),
    shard-major. Port change: a device may be named more than once (one
    card, or the CPU, can hold several shards)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_shards * n_dp:
        raise ValueError(f"need {n_shards * n_dp} devices, have {len(devices)}")
    grid = np.empty((n_shards, n_dp), dtype=object)
    for i in range(n_shards * n_dp):
        grid[i // n_dp, i % n_dp] = devices[i]
    return Mesh(grid, np.full((n_shards, n_dp), multi_host.process_index(), np.int64))


def _safe_rewrite(q):
    """The shard program's row form, as IndexSearcher's rewrite ladder:
    device_equivalent first (span-term -> term, ordered span-near ->
    phrase: those rows then ride the mesh), host-evaluated shapes -> None."""
    de = getattr(q, "device_equivalent", None)
    if de is not None:
        eq = de()
        if eq is not None:
            return eq.rewrite()
    if hasattr(q, "host_eval"):
        return None
    try:
        return q.rewrite()
    except (_NeedsHostEval, NotImplementedError):
        return None


def _split_hot_leaves(leaves, s: int):
    """Doc-range-split the largest snapshots so every shard gets work when
    the index has fewer segments than shards (a force-merged index's one
    segment would otherwise land whole on shard 0). Returns search-only
    sub-leaves in doc order; global statistics and doc freqs keep coming
    from the original reader. Each sub-leaf references the full words and
    position streams (codec/split.py)."""
    from rucene_tpu_torch.codec.split import split_packed_segment
    from rucene_tpu_torch.index.reader import SegmentSnapshot

    total = sum(lf.max_doc for lf in leaves)
    if total == 0:
        return leaves
    # largest-remainder apportionment of s parts over leaves by doc count
    quotas = [s * lf.max_doc / total for lf in leaves]
    parts = [max(1, int(q)) for q in quotas]
    while sum(parts) < s:
        best, best_r = -1, -1.0
        for i, lf in enumerate(leaves):
            r = quotas[i] - parts[i]
            if parts[i] < lf.max_doc and r > best_r:
                best, best_r = i, r
        if best < 0:
            break
        parts[best] += 1
    out = []
    for lf, n in zip(leaves, parts):
        if n <= 1 or lf.max_doc < 2 * n:
            out.append(lf)
            continue
        subs = split_packed_segment(lf.packed, n)
        if len(subs) <= 1:
            out.append(lf)
            continue
        lo = 0
        for j, sp in enumerate(subs):
            hi = lo + sp.max_doc
            live = None if lf.live is None else lf.live[lo:hi]
            snap = SegmentSnapshot(f"{lf.name}[{j}]", sp, live=live)
            snap.doc_base = lf.doc_base + lo
            for f, m in lf.dv_updates.items():
                sub_m = {d - lo: v for d, v in m.items() if lo <= d < hi}
                if sub_m:
                    snap.dv_updates[f] = sub_m
            for f, m in lf.bdv_updates.items():
                sub_m = {d - lo: v for d, v in m.items() if lo <= d < hi}
                if sub_m:
                    snap.bdv_updates[f] = sub_m
            out.append(snap)
            lo = hi
    return out


def _partition_leaves(leaves, s: int) -> list[list]:
    """Contiguous, doc-balanced partition of the leaves into <= s groups.
    Contiguity keeps shard doc spaces monotone in reader-global doc order,
    which preserves exact (score desc, doc asc) tie-breaks in the merge."""
    if len(leaves) <= s:
        return [[lf] for lf in leaves]
    sizes = np.asarray([max(lf.max_doc, 1) for lf in leaves], dtype=np.float64)
    cum = np.cumsum(sizes)
    total = cum[-1]
    groups: list[list] = []
    start = 0
    for g in range(s):
        target = total * (g + 1) / s
        end = int(np.searchsorted(cum, target, side="left")) + 1
        end = max(end, start + 1)
        end = min(end, len(leaves) - (s - g - 1))  # leave >= 1 leaf a group
        if g == s - 1:
            end = len(leaves)
        groups.append(leaves[start:end])
        start = end
        if start >= len(leaves):
            break
    return [g for g in groups if g]


class ShardedIndex:
    """Leaves partitioned into <= S contiguous groups; each group is one
    combined view on each device of its mesh row that this process owns.
    ``cell_views[si][dj]`` is cell (si, dj)'s view (None where another
    process owns it), ``views[si]`` the shard's first own one,
    ``build_s[si]`` the seconds its views took."""

    def __init__(self, mesh: Mesh, reader: IndexReader, split_hot: bool = True):
        self.mesh = mesh
        self.reader = reader
        self.partial = False
        self.global_stats = None
        s = mesh.shape["shard"]
        leaves = list(reader.leaves)
        if not leaves:
            raise ValueError("cannot shard an empty reader")
        if split_hot and len(leaves) < s:
            leaves = _split_hot_leaves(leaves, s)
        self.leaves = leaves
        self.n_shards = s
        self.groups = _partition_leaves(leaves, s)
        # one global field numbering: every shard's norms / cache rows align
        names = sorted({name for lf in leaves for name in lf.packed.fields})
        self.field_gid = {name: i for i, name in enumerate(names)}
        self.owned = set(range(len(self.groups)))
        self._build_views()
        self.stride = max(v.device.max_doc_padded for v in self.views if v is not None)

    def _build_views(self):
        me = multi_host.process_index()
        self.cell_views = [[None] * self.mesh.shape["dp"] for _ in range(self.n_shards)]
        self.views = [None] * self.n_shards
        self.build_s = [0.0] * self.n_shards
        for si, group in enumerate(self.groups):
            if group is None or si not in self.owned:
                continue
            t = time.perf_counter()
            by_device: dict = {}
            for dj in range(self.mesh.shape["dp"]):
                d = self.mesh.devices[si, dj]
                if self.mesh.ranks[si, dj] != me:
                    continue
                if d not in by_device:
                    by_device[d] = build_combined_view(
                        group, d, field_gid=self.field_gid, with_positions=True
                    )
                self.cell_views[si][dj] = by_device[d]
                if self.views[si] is None:
                    self.views[si] = by_device[d]
            if by_device and next(iter(by_device)).type == "cuda":
                torch.cuda.synchronize(next(iter(by_device)))
            self.build_s[si] = time.perf_counter() - t

    def own_cells(self):
        """(si, dj) of every cell this process runs."""
        return [
            (si, dj)
            for si in range(len(self.groups))
            for dj in range(self.mesh.shape["dp"])
            if self.cell_views[si][dj] is not None
        ]

    def map_docs(self, shard_docs: np.ndarray) -> np.ndarray:
        """Shard doc ids (shard * stride + view doc) -> reader-global ids."""
        shard_docs = np.asarray(shard_docs, dtype=np.int64)
        out = np.empty(len(shard_docs), dtype=np.int64)
        si = shard_docs // self.stride
        local = shard_docs % self.stride
        if (si >= len(self.groups)).any():
            raise ValueError("doc id beyond the last shard")
        for g in range(len(self.groups)):
            m = si == g
            if not m.any():
                continue
            if self.views[g] is not None:
                out[m] = self.views[g].map_docs(local[m], self.groups[g])
            elif self.partial:
                pads, reals = self._meta_doc_map[g]
                li = np.clip(np.searchsorted(pads, local[m], side="right") - 1, 0, len(pads) - 1)
                out[m] = reals[li] + (local[m] - pads[li])
            else:
                raise ValueError(f"doc id from unloaded shard {g}")
        return out

    # ---------- partial loading ----------

    @classmethod
    def from_directory(cls, mesh: Mesh, directory, owned_shards=None):
        """Open a committed index with each process loading ONLY the
        segment groups of the shard rows it owns: the path for an index
        that does not fit one host. Needs the commit's per-segment dims
        metadata (this codebase's writers record it); a commit without it
        loads whole."""
        from rucene_tpu_torch.codec import files as segfiles
        from rucene_tpu_torch.index.reader import load_segment_snapshot, open_directory_reader
        from rucene_tpu_torch.util import round_up

        infos = segfiles.read_segments_file(directory)
        if not infos.segments:
            raise ValueError("cannot shard an empty index")
        if any(i.dims is None for i in infos.segments):
            return cls(mesh, open_directory_reader(directory))  # legacy
        s = mesh.shape["shard"]
        groups_meta = _partition_leaves(infos.segments, s)
        me = multi_host.process_index()
        owned = {si for si in range(len(groups_meta)) if (mesh.ranks[si] == me).any()}
        if owned_shards is not None:
            owned &= set(owned_shards)

        self = cls.__new__(cls)
        self.mesh = mesh
        self.partial = True
        self.owned = owned
        self.reader = None
        self.n_shards = s

        # global field numbering and collection stats from commit metadata
        field_names = sorted({f for i in infos.segments for f in i.dims["fields"]})
        self.field_gid = {n: i for i, n in enumerate(field_names)}
        gmax_doc = sum(i.max_doc for i in infos.segments)
        self.global_stats = {}
        for f in field_names:
            dc = sttf = 0
            for i in infos.segments:
                st = (i.dims.get("stats") or {}).get(f)
                if st:
                    dc += st[0]
                    sttf += st[1]
            self.global_stats[f] = CollectionStats(
                field=f, max_doc=gmax_doc, doc_count=dc, sum_total_term_freq=sttf
            )
        # every shard's doc axis and doc-id map from metadata alone, so
        # every process agrees on the stride and maps any shard's ids
        pad = lambda i: round_up(max(i.max_doc, 1), 1024)  # noqa: E731
        self.stride = max(sum(pad(i) for i in g) for g in groups_meta)
        base_of = np.concatenate([[0], np.cumsum([i.max_doc for i in infos.segments])])
        info_pos = {i.name: n for n, i in enumerate(infos.segments)}
        self._meta_doc_map = []
        for g in groups_meta:
            pads = np.concatenate([[0], np.cumsum([pad(i) for i in g])])[:-1]
            reals = np.asarray([base_of[info_pos[i.name]] for i in g], np.int64)
            self._meta_doc_map.append((pads.astype(np.int64), reals))
        self.groups = [None] * len(groups_meta)
        self.leaves = []
        for si in sorted(owned):
            leaves = []
            for info in groups_meta[si]:
                lf = load_segment_snapshot(directory, info)
                lf.doc_base = int(base_of[info_pos[info.name]])
                leaves.append(lf)
            self.groups[si] = leaves
            self.leaves.extend(leaves)
        self._build_views()
        return self

    def local_doc_freq(self, field: str, text: str) -> int:
        """Doc freq over THIS process's loaded leaves (partial mode)."""
        total = 0
        for lf in self.leaves:
            rec = lf.term_record(field, text)
            if rec is not None:
                total += rec.doc_freq
        return total


class ShardedSearcher:
    """Batch searcher over a ShardedIndex: every own (shard, dp) cell
    queued, then one merge a dp column (and one gather across processes)."""

    def __init__(self, index: ShardedIndex, similarity: BM25Similarity | None = None):
        self.index = index
        self.reader = index.reader
        self.similarity = similarity or BM25Similarity()
        self._stats: dict[str, CollectionStats] = {}
        self._fallback = None

    def collection_stats(self, field: str) -> CollectionStats:
        st = self._stats.get(field)
        if st is None:
            if self.index.partial:
                st = self.index.global_stats.get(field) or CollectionStats(field, 0, 0, 0)
            else:
                st = self.reader.collection_stats(field)
            self._stats[field] = st
        return st

    def _doc_freqs_global(self, keys: list[tuple[str, str]]) -> dict:
        """Per-term doc freqs. In partial mode each process counts its own
        leaves and one all_reduce sums them (shard counts are disjoint)."""
        if not self.index.partial:
            return {k: self.reader.doc_freq(*k) for k in keys}
        local = np.asarray([self.index.local_doc_freq(f, t) for f, t in keys], np.int64)
        if self.index.mesh.multi_process and len(keys):
            local = multi_host.allreduce_sum(local)
        return {k: int(v) for k, v in zip(keys, local)}

    def _fallback_searcher(self) -> IndexSearcher:
        """Cached per-leaf searcher over the reader, on the mesh's first
        device, for the rows the shard program does not cover (full mode;
        partial mode has _search_exact_local_batch)."""
        if self._fallback is None:
            dev = next(d for d in self.index.mesh.devices.flat if d is not None)
            self._fallback = IndexSearcher(self.reader, self.similarity, device=dev)
        return self._fallback

    def _search_exact_local_batch(self, queries, k: int) -> list[TopDocs]:
        """Partial-mode coverage for shapes outside the shard program: each
        process evaluates the queries exactly over its own leaves with
        GLOBAL statistics (summed doc freqs), then the per-process top-k
        lists merge across processes in one gather."""
        from rucene_tpu_torch.search import host_engine

        sim = self.similarity
        keys: list[tuple[str, str]] = []
        fields: set[str] = set()
        for query in queries:
            for t in host_engine.extract_terms_of(query):
                fields.add(t.field)
                if (t.field, t.text) not in keys:
                    keys.append((t.field, t.text))
        doc_freqs = self._doc_freqs_global(keys)
        stats = {f: self.collection_stats(f) for f in fields}
        cands: list[list] = [[] for _ in queries]  # (score, global doc)
        totals = [0] * len(queries)
        for lf in self.index.leaves:
            for qi, query in enumerate(queries):
                m, acc = host_engine.evaluate_query(lf, query, sim, stats, doc_freqs)
                hh = host_engine.hits_from_dense(lf, m, acc, k)
                totals[qi] += hh.total_hits
                cands[qi].extend(
                    (float(s2), int(lf.doc_base + d)) for d, s2 in zip(hh.docs, hh.scores)
                )
        return self._allgather_topk_batch(cands, totals, k)

    def _allgather_topk_batch(self, cands, totals, k: int) -> list[TopDocs]:
        """Merge per-process (score, global doc) candidates and hit counts
        across processes with one gather of [Q, k] tables (nothing to
        gather in one process)."""
        q_n = len(cands)
        if self.index.mesh.multi_process and q_n:
            docs = np.full((q_n, k), -1, np.int64)
            scores = np.full((q_n, k), -np.inf, np.float32)
            for qi, cand in enumerate(cands):
                for x, (s2, d) in enumerate(sorted(cand, key=lambda t: (-t[0], t[1]))[:k]):
                    scores[qi, x], docs[qi, x] = s2, d
            gs, gd = multi_host.allgather(scores), multi_host.allgather(docs)
            totals = multi_host.allreduce_sum(np.asarray(totals, np.int64)).tolist()
            cands = [
                [(float(s2), int(d)) for s2, d in zip(gs[:, qi].ravel(), gd[:, qi].ravel()) if d >= 0]
                for qi in range(q_n)
            ]
        out = []
        for cand, total in zip(cands, totals):
            cand.sort(key=lambda t: (-t[0], t[1]))
            out.append(TopDocs(int(total), [ScoreDoc(d, s2) for s2, d in cand[:k]]))
        return out

    @staticmethod
    def _phrase_mesh_eligible(rq) -> bool:
        """Pure phrase rows the shard program executes (as
        IndexSearcher._phrase_device_eligible)."""
        from rucene_tpu_torch.search.phrase_device import NMAX, SLOP_CAP

        return (
            rq is not None
            and len(rq.phrases) == 1
            and not rq.clauses
            and not rq.ranges
            and not rq.groups
            and not rq.match_all
            and 0 <= rq.phrases[0][3] <= SLOP_CAP
            and 2 <= len(rq.phrases[0][1]) <= NMAX
            and all(t is not None for t in rq.phrases[0][1])
            and rq.phrase_occur(0) in (Occur.SHOULD, Occur.MUST)
        )

    def search_batch(self, queries: list[Query], k: int = 10) -> list[TopDocs]:
        rqs = [_safe_rewrite(q) for q in queries]
        phrase_idx = [
            i for i, rq in enumerate(rqs)
            if rq is not None and rq.phrases and self._phrase_mesh_eligible(rq)
        ]
        fallback_idx = [
            i for i, rq in enumerate(rqs)
            if rq is None
            or (rq.phrases and i not in phrase_idx)
            or len(rq.ranges) > 8
            or rq.groups
            or not rq.plain  # dismax / constant-score / boosting
            or (rq.match_all and (rq.clauses or rq.ranges))
        ]
        taken = set(phrase_idx) | set(fallback_idx)
        mesh_idx = [i for i in range(len(queries)) if i not in taken]
        METRICS.incr("route.mesh", len(mesh_idx))
        METRICS.incr("route.mesh_phrase", len(phrase_idx))
        METRICS.incr("route.mesh_fallback", len(fallback_idx))
        out: list[TopDocs | None] = [None] * len(queries)
        # every process takes the same steps in the same order, so their
        # collectives pair up
        if mesh_idx:
            got = self._search_mesh([rqs[i] for i in mesh_idx], k)
            for i, td in zip(mesh_idx, got):
                out[i] = td
        if phrase_idx:
            got = self._search_phrases([queries[i] for i in phrase_idx],
                                       [rqs[i] for i in phrase_idx], k)
            for i, td in zip(phrase_idx, got):
                out[i] = td
        if fallback_idx:
            for i, td in zip(fallback_idx, self._search_fallback([queries[i] for i in fallback_idx], k)):
                out[i] = td
        return out  # type: ignore[return-value]

    def _search_fallback(self, queries, k: int) -> list[TopDocs]:
        if self.index.partial:
            return self._search_exact_local_batch(queries, k)
        return self._fallback_searcher().search_batch(queries, k=k)

    def _cache(self, stats) -> np.ndarray:
        """One [F, 256] BM25 denominator table over the global field ids."""
        sim = self.similarity
        cache = np.zeros((max(len(self.index.field_gid), 1), 256), np.float32)
        for name, g in self.index.field_gid.items():
            has_norms = any(name in lf.packed.norms for lf in self.index.leaves) or (
                self.index.partial and not self.index.leaves
            )
            cache[g] = sim.cache_row(stats.get(name) if has_norms else None)
        return cache

    def _rows_of(self, dj: int, b: int) -> tuple[int, int]:
        dp = self.index.mesh.shape["dp"]
        per = -(-b // dp)
        return min(dj * per, b), min((dj + 1) * per, b)

    def _search_mesh(self, rqs, k: int) -> list[TopDocs]:
        """Term, boolean, range and match-all rows: the flat executor in
        every own cell over its shard's view, then the merge."""
        sim = self.similarity
        fields, keys = set(), []
        for rq in rqs:
            for c in rq.clauses:
                fields.add(c.term.field)
                if (c.term.field, c.term.text) not in keys:
                    keys.append((c.term.field, c.term.text))
        doc_freqs = self._doc_freqs_global(keys)
        stats = {f: self.collection_stats(f) for f in fields}
        b = len(rqs)
        t = max(max((len(rq.all_slots()) for rq in rqs), default=1), 1)
        weight, occur, n_required, min_should, ma_rows, boosts = build_clause_tables(
            rqs, sim, doc_freqs, stats, b, t
        )
        cache = self._cache(stats)
        any_ranges = any(rq.ranges for rq in rqs)
        pure = not ma_rows.any() and not any_ranges and all(
            IndexSearcher._pure_row(rq, weight[i]) for i, rq in enumerate(rqs)
        )
        strategy, ftab = "auto", None
        if any_ranges:
            ftab = build_range_filter_tables(rqs, b)
            if not IndexSearcher._ranges_complete(rqs):
                strategy = "dense"
        cells = []  # (si, dj, lo, hi, (scores, docs, hits) on the cell's device)
        for si in sorted({si for si, _dj in self.index.own_cells()}):
            group = self.index.groups[si]
            view0 = self.index.views[si]
            bs, bc, fid = build_combined_tables(view0, group, rqs, b, t)
            length = view0.n_leaves
            wt_x = np.repeat(weight, length, axis=1)
            occ_x = np.repeat(occur, length, axis=1)
            for dj, view in enumerate(self.index.cell_views[si]):
                lo, hi = self._rows_of(dj, b)
                if view is None or lo >= hi:
                    continue
                rows = slice(lo, hi)
                work = build_flat_work(bs[rows], bc[rows], wt_x[rows], fid[rows], occ_x[rows])
                filters = None
                if ftab is not None:
                    fkeys, fidx, fenc, fboost = ftab
                    filters = view_filters(view, group, fkeys, fidx[rows], fenc[rows], fboost[rows])
                dev = view.device
                s, d, h = IndexSearcher._run_work(
                    dev, (view.blk_first_host, view.blk_last_host), work[:6], cache,
                    n_required[rows], min_should[rows], k, pure, filters=filters,
                    strategy=strategy,
                )
                if ma_rows[rows].any():
                    ms, mdoc, mh = execute_match_all(
                        dev, torch.from_numpy(boosts[rows]).to(dev.device), k
                    )
                    ma = torch.from_numpy(ma_rows[rows]).to(dev.device)
                    s = torch.where(ma[:, None], ms, s)
                    d = torch.where(ma[:, None], mdoc, d)
                    h = torch.where(ma, mh, h)
                cells.append((si, dj, lo, hi, (s, d, h)))
        return self._merge(cells, b, k)

    def _merge(self, cells, b: int, k: int) -> list[TopDocs]:
        """Shard results -> TopDocs: each dp column's cells gather onto the
        column's first shard's device, where one distinct int64 key a hit
        (score desc, shard doc asc) picks the top k and the hit counts
        add; across processes, one gather of the [B, k] lists."""
        scores = np.full((b, k), -np.inf, np.float32)
        docs = np.full((b, k), -1, np.int64)
        hits = np.zeros(b, np.int64)
        stride = self.index.stride
        for dj in sorted({c[1] for c in cells}):
            col = [c for c in cells if c[1] == dj]
            lo, hi = col[0][2], col[0][3]
            dev0 = col[0][4][0].device
            s_all, d_all = [], []
            h = torch.zeros(hi - lo, dtype=torch.int64, device=dev0)
            for si, _dj, _lo, _hi, (s, d, hh) in col:
                s = s.to(dev0)
                s_all.append(s)
                d_all.append(torch.where(s > -torch.inf, d.to(dev0).long() + si * stride, DOC_PAD))
                h += hh.to(dev0).long()
            s_cat = torch.cat(s_all, dim=1)
            d_cat = torch.cat(d_all, dim=1)
            kk = min(k, s_cat.shape[1])
            top = torch.topk(score_doc_keys(s_cat, d_cat), kk, dim=1).indices
            ts = torch.gather(s_cat, 1, top).cpu().numpy()
            td = torch.gather(d_cat, 1, top).cpu().numpy()
            hits[lo:hi] = h.cpu().numpy()
            for r in range(hi - lo):
                keep = ts[r] > -np.inf
                n = int(keep.sum())
                scores[lo + r, :n] = ts[r][keep]
                docs[lo + r, :n] = self.index.map_docs(td[r][keep])
        if self.index.mesh.multi_process:
            return self._gather_merge(scores, docs, hits, k)
        return [
            TopDocs(int(hits[i]), docs=docs[i][scores[i] > -np.inf],
                    scores=scores[i][scores[i] > -np.inf])
            for i in range(b)
        ]

    def _gather_merge(self, scores, docs, hits, k: int) -> list[TopDocs]:
        """Every process's [B, k] lists (reader doc ids; -inf and -1 where
        a process has no hit) gathered, merged by (score desc, doc asc)."""
        gs = multi_host.allgather(scores)  # [P, B, k]
        gd = multi_host.allgather(docs)
        hits = multi_host.allreduce_sum(hits)
        out = []
        for i in range(scores.shape[0]):
            s = gs[:, i].ravel()
            d = gd[:, i].ravel()
            keep = s > -np.inf
            s, d = s[keep], d[keep]
            order = np.lexsort((d, -s))[:k]
            out.append(TopDocs(int(hits[i]), docs=d[order], scores=s[order]))
        return out

    def _search_phrases(self, queries, rqs, k: int) -> list[TopDocs]:
        """Pure phrase rows on the mesh: the phrase pipeline in every own
        cell over its shard's view (decode or gather, conjunction, position
        verify), then the same merge as the term rows. A call's candidate
        table holds a chunk of rows whose terms' doc freqs in the shard add
        up to at most PHRASE_CAND_CAP (a row alone past it gets a table of
        its own size), and its occurrence window is the largest freq of
        its blocks, so no row overflows; a row flagged all the same goes
        the fallback way."""
        from rucene_tpu_torch.search.phrase_device import PhraseBatch, execute_phrases_impl
        from rucene_tpu_torch.search.phrase_path import _idf_weight

        sim = self.similarity
        keys, fields = [], set()
        for rq in rqs:
            field, terms, _b, _s = rq.phrases[0]
            fields.add(field)
            for t in terms:
                if (field, t) not in keys:
                    keys.append((field, t))
        doc_freqs = self._doc_freqs_global(keys)
        stats = {f: self.collection_stats(f) for f in fields}
        cache = self._cache(stats)
        b = len(rqs)
        weight = np.zeros(b, np.float32)
        n_terms = np.zeros(b, np.int32)
        slop = np.zeros(b, np.int32)
        fid = np.zeros(b, np.int32)
        for i, rq in enumerate(rqs):
            field, terms, boost, slop[i] = rq.phrases[0]
            weight[i] = _idf_weight(sim, stats, doc_freqs, field, terms, boost)
            n_terms[i] = len(terms)
            fid[i] = self.index.field_gid.get(field, 0)

        cells, flagged = [], set()
        for si in sorted({si for si, _dj in self.index.own_cells()}):
            group = self.index.groups[si]
            view0 = self.index.views[si]
            # per row: its work items (block, slot, pos width, pos start),
            # its (row, doc) group bound and its largest block freq
            items, bound, fmax = [], np.zeros(b, np.int64), np.ones(b, np.int64)
            for i, rq in enumerate(rqs):
                field, terms, _b, _s = rq.phrases[0]
                row = []
                for li, lf in enumerate(group):
                    for j, term in enumerate(terms):
                        rec = lf.term_record(field, term)
                        if rec is None:
                            continue
                        blks = np.arange(rec.block_start, rec.block_start + rec.block_count)
                        if not len(blks):
                            continue
                        ws = int(view0.pos_word_bases[li]) + rec.pos_word_start
                        row.append(np.stack([
                            blks + int(view0.blk_bases[li]), np.full(len(blks), j),
                            np.full(len(blks), rec.pos_width), np.full(len(blks), ws),
                        ], axis=1))
                        bound[i] += rec.doc_freq
                        fmax[i] = max(fmax[i], int(lf.packed.blk_max_freq[blks].max()))
                items.append(np.concatenate(row) if row else np.zeros((0, 4), np.int64))
            for dj, view in enumerate(self.index.cell_views[si]):
                lo, hi = self._rows_of(dj, b)
                if view is None or lo >= hi:
                    continue
                dev = view.device
                d = dev.device
                put = lambda a, dt=torch.int32: torch.from_numpy(np.ascontiguousarray(a)).to(d, dt)  # noqa: E731
                chunks, cur, tot = [], [], 0
                for i in range(lo, hi):
                    if cur and tot + bound[i] > PHRASE_CAND_CAP:
                        chunks.append(cur)
                        cur, tot = [], 0
                    cur.append(i)
                    tot += int(bound[i])
                if cur:
                    chunks.append(cur)
                for rows in chunks:
                    it = [items[i] for i in rows]
                    wi = np.concatenate(it) if it else np.zeros((0, 4), np.int64)
                    wrow = np.repeat(np.arange(len(rows)), [len(x) for x in it])
                    if not len(wi):  # no term of these rows in the shard
                        wi, wrow = np.zeros((1, 4), np.int64), np.zeros(1, np.int64)
                        valid = np.zeros(1, bool)
                    else:
                        valid = np.ones(len(wi), bool)
                    pb = PhraseBatch(
                        wi_block=put(wi[:, 0]), wi_row=put(wrow), wi_slot=put(wi[:, 1]),
                        wi_valid=put(valid, torch.bool), n_terms=put(n_terms[rows]),
                        weight=put(weight[rows], torch.float32), fid=put(fid[rows]),
                        cache=put(cache, torch.float32), wi_pos_width=put(np.maximum(wi[:, 2], 1)),
                        wi_pos_start=put(wi[:, 3]), slop=put(slop[rows]),
                    )
                    fw = int(fmax[rows].max())
                    res = execute_phrases_impl(
                        dev, pb, k=k, cand_cap=max(int(bound[rows].sum()), 1), fmax=fw,
                        slop_max=int(slop[rows].max()), nmax=int(n_terms[rows].max()), fwin=fw,
                    )
                    cells.append((si, dj, rows, res))
        # one cell a (shard, chunk): regroup by dp column for the merge
        merged = []
        for si, dj, rows, (s, d, h, ov) in cells:
            ovn = ov.cpu().numpy()
            flagged.update(r for r, o in zip(rows, ovn) if o)
            merged.append((si, dj, rows, (s, d, h)))
        by_col = self._phrase_cells_by_column(merged)
        out = self._merge(by_col, b, k)
        if self.index.mesh.multi_process:  # every process reroutes the same rows
            fl = np.zeros(b, np.int64)
            fl[list(flagged)] = 1
            flagged = set(np.flatnonzero(multi_host.allreduce_sum(fl)).tolist())
        if flagged:
            idx = sorted(flagged)
            METRICS.incr("route.mesh_fallback", len(idx))
            for i, td in zip(idx, self._search_fallback([queries[i] for i in idx], k)):
                out[i] = td
        return out

    @staticmethod
    def _phrase_cells_by_column(cells):
        """Phrase results of row chunks -> one (si, dj, lo, hi, result) a
        (shard, dp column), rows in their column's order (chunks of a
        column cover its rows in order)."""
        out = []
        for key in sorted({(si, dj) for si, dj, _r, _x in cells}):
            parts = [(rows, res) for si, dj, rows, res in cells if (si, dj) == key]
            lo, hi = parts[0][0][0], parts[-1][0][-1] + 1
            res = tuple(torch.cat([p[1][n] for p in parts]) for n in range(3))
            out.append((key[0], key[1], lo, hi, res))
        return out

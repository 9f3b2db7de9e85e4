"""GPU smoke of the PyTorch/CUDA port (rucene_tpu_torch) on one card.

    python3 chip_smoke.py            # 1M-doc bench corpus (BENCH_DOCS overrides)

Builds the CUDA kernels and the native library from this checkout, then:
  1. prints the toolchain and the card (name, power limit);
  2. builds the bench's Zipf corpus (bench.py's generator and seed, from
     rucene_tpu_torch/drivers/workload.py, so nothing imports rucene_tpu or
     jax), its query mix with phrase rows (bigrams from the first 5,000
     docs, as bench.py draws them) and the same mix without them, packs
     the corpus (each doc also with an IntPoint ``ts`` and, one in 4, a
     StringField ``tag``: workload.pack_corpus with FIELDS_SEED) and opens
     it with the port's IndexReader;
  3. builds the decoded residency through the decode kernel and holds it
     against the plain twin on the CPU, every block bit for bit; logs the
     dense tf planes the residency build scattered (count, bytes, df_min)
     and rebuilds them once, timed, holding the rebuild equal to them;
     then prewarms the resident phrase planes
     (searcher.prewarm_phrase_planes, as bench.py does) and logs their
     count, seconds and bytes;
  4. serves the bench's whole mix (512 queries, batch 256, k=100, 64
     phrase rows) through search_batch_async: a warm pass, then timed
     pipelined passes; then the mix without phrases (qps_no_phrase, the
     figure earlier runs recorded). Every phrase row must take the phrase
     route, both device phrase routes (candidate tables and position
     planes) must be taken, and at 1M docs no phrase row may go to the
     scalar engine or the host. Every two-term row must take the pair
     route, the tf-plane route or a rerun on the flat executor (a pair
     row whose probe slots overflow, search.pair_overflow_rows), and at
     1M docs pair and planes must both be taken;
  5. measures the peak device memory and time of the first batch's plane
     rows and pair rows, each served alone (the plane executor's peak per
     (row, doc) sizes its row chunks, plane_path.plane_row_chunk);
  6. serves 16 of the mix's queries, two of each of its 8 kinds
     (single-term, OR, AND, phrase), on the CPU and compares them hit for
     hit, logging each row's route on the card;
  7. checks each kernel's launch count on its path (the decode kernel in
     step 3, and that the mix's single-term rows took the single route),
     then replays the residency decode against its plain PyTorch version
     on the card, and times both;
  8. packed serving: a second reader over the same segment, built with
     RUCENE_DECODED=0 (no decoded planes, so no tf planes and no pair
     route: its two-term rows take the flat executor, as the reference's
     packed reader's do), drops the decoded reader's phrase planes,
     prewarms its own and serves the whole mix the same way with the
     plain decode twins disabled: term and boolean rows decode through the
     scoring decode kernel, phrase rows and plane builds through the
     decode kernel. Then it serves 32 two-term rows over head-band terms
     through the same search_batch (dense regime, no forced strategy), so
     the combine kernel runs on this serving path even if the mix takes
     only the candidate branch: the decoded reader sends no row to the
     flat executor's dense branch any more (its head-band rows are plane
     rows), and the packed reader is the serving path that keeps the
     combine. Launches and routes are counted on this path alone, and the
     16 sampled TopDocs must equal the decoded run's bit for bit (pair and
     plane rows against the flat executor's);
  9. replays the head-band batch's combine call on the packed reader
     against its plain version, bit for bit, times both, and the
     combine's library yardstick (zeroed planes plus index_add_ of the
     items' valid lanes, which the port never calls); then the scoring
     decode of the first packed batch's single-term rows against its
     plain version: docs, freqs and cval bit-equal; times both; then the
     largest ordered-sum call of phase 10's score-combine batch on the
     packed reader (the flat executor's candidate groups;
     ordered_sum_replay) against its plain version (a CPU index_add_),
     bit for bit, timed beside both and one torch.segment_reduce; then a
     serving call's plane build on the decoded reader (plane_build_replay:
     20 resident misses of under 64 blocks in one build_position_planes
     call, csrc/phrase_plane.cu) against its twin, 20 per-term
     build_position_plane calls, bit for bit, timed on the device and on
     the host's clock, the kernel alone under the profiler;
 10. mixed rows and score-combine rows on both readers
     (serve_combine_rows): 256 mixed rows (an exact bigram from the
     first 5,000 docs, MUST or FILTER, beside 1-2 term clauses of the
     bench's band), then 112 score-combine rows (dismax, constant-score,
     boosting, match-all) and 16 head-band dismax rows as their own
     batch. Each stage runs with its counts set to 0 just before and read
     just after: every mixed row on route.mixed and none spilled, the
     combine kernel launched by the mixed rows on both readers and the
     scoring decode on the packed one, the score-combine rows on both
     executor branches; the packed answers equal the decoded ones bit for
     bit, 16 mixed and 16 score-combine rows equal the CPU run; each
     stage's kernel time and device busy share under torch.profiler, and
     the peak of one 64-row mixed chunk;
 11. filter rows and host rows on both readers (serve_filter_rows; the
     rows of filter_queries, seed 23, after Lucene's nightly benchmark's
     IntNRQ / Prefix3 tasks beside term queries): stage A, 256 filter rows
     in one batch (term MUST or two terms SHOULD beside a ``ts`` window of
     1-90 days, a term beside a tag prefix or ExistsQuery(tag), windows
     alone, and 32 mixed rows with a window); stage B, its 96 term-MUST
     rows alone; stage C, 16 host rows (nested groups, 9 ranges, match-all
     with a window, dismax over booleans). Gates: every non-mixed row of A
     and B on route.device and every mixed row on route.mixed, no host row
     and no spill there; the dense branch in A and the candidate branch in
     B; K3 launched by A on both readers and K2 on the packed one; no
     filter plane built by a timed pass; packed equal to decoded bit for
     bit; 16 rows of A and the 16 host rows equal to the CPU run; route.host
     exactly 16 in C (and 0 in the bench mix). Logs each stage's QPS, A's
     kernel time and busy share, the dense batch's peak a (row, doc), the
     filter planes cached and the host stage's seconds;
 12. NRT on the card (serve_nrt, after phases 1-11, 13 and 14's device
     state is released), in the shape of bench.py's main_nrt at its defaults: the
     write path (IndexWriter, SearcherManager, deletes by term and by
     query, a merging refresh, FSDirectory, open_directory_reader,
     check_index) under a 45 s serving window with ingest; its gates and
     figures are in serve_nrt's docstring, and its kernel launches count
     in the kernels' JSON rows. It also holds K1 and K3 at a flush
     segment's shapes against their plain twins (nrt_kernel_replay; the
     figures under ``nrt.replay``, K3's error in its row's max_abs_err).
     Two stages ride it: the combined view (serve_combined: the reader of
     the window's end, 55-60 leaves, through IndexSearcher(reader,
     combine_segments=True), equal to the per-leaf answers, its build
     seconds and ms a batch beside the per-leaf ones; ``nrt.combined``) and
     the multi-process stage (serve_multi_process: the on-disk index opened
     by ShardedIndex.from_directory in partial mode from one spawned
     process a card, up to 4, over NCCL, equal to the one-process answers;
     ``nrt.multi_process``). It runs after phases 13 and 14.
 13. the query surface on both readers (serve_query_surface; the rows of
     surface_queries, seed 29, after luceneutil's TermDTSort,
     HighTermMonthSort and TermGroup10K tasks, over the corpus's numeric
     doc values ts, month and grp): S, 76 search_sorted rows (by ts
     descending, by (month, ts descending), 4 by score on the host path);
     C, 40 search_collapse rows by grp; N, one batch of 104 span and
     synonym rows (SpanOr synonyms, unordered span-near, ordered slop-0
     rows with a SpanOr child, span-term and ordered plain-term rows that
     plan as term and phrase rows, 8 nested trees on the host route
     through the native span evaluator); R, 32 first passes rescored over
     their top 50 by QueryRescorer's probe path; E, explain of 16 (row,
     hit) pairs and 16 query strings parsed and served. Its gates and
     figures are in serve_query_surface's docstring; the figures print
     under ``query_surface`` and its launches count in the kernels' rows.
 14. sharded search on both readers (serve_sharded; BASELINE.json config
     5's segment-sharded index): ShardedIndex(make_mesh(4, 1), reader)
     splits the one segment into 4 doc-range shards (one card: cuda:0
     four times), each a combined view decoded through K1 (packed on the
     packed reader), and ShardedSearcher serves the bench mix, the rows of
     sharded_queries (the graft's sharded rows at bench widths, seed 31)
     and the head-band rows. Its gates and figures are in serve_sharded's
     docstring; the figures print under ``sharded``, its launches count in
     the kernels' rows, and shard_kernel_replay holds K1, K2 and K3 at a
     shard's shapes (K3's error in its row's max_abs_err).
 15. the port's entry points (serve_drivers, after phase 14, before phase
     12; rucene_tpu_torch/drivers and examples): the bench's serving loop
     (drivers.bench.serve_mix) over the whole mix on both readers, every
     TopDocs equal to phase 4's and 8's; both examples as subprocesses on
     the card, their lines equal to a --device cpu run; ``drivers.bench
     --nrt`` at 20,000 base docs for 5 s; and a drivers.profile_bench
     capture of two packed batches, whose trace holds the batch's host
     spans as often as util/metrics timed them and K1, K2 and K3 by name.
     Its figures print under ``drivers``, its in-process launches under
     ``drivers_launches`` and in the kernels' rows.
 16. block-max pruning on both readers (serve_pruning, after phase 15,
     before phase 12): ops/topk.exact_top_k's chunk pass held bit-equal to
     stable_top_k on the dense rows of phase 9's head-band batch and timed
     beside it, the mix profiled with and without it (stable_top_k patched in);
     WAND (search_batch(prune=)) on 3-term and 2-term band OR rows at
     k = 10 and 32 against exhaustive serving, and the automatic rule under
     a lowered threshold; and a skewed 200,000-doc corpus in 4 segments
     where pruning fires, per leaf and combined. Stage S (serve_sum_order)
     holds the summation rule (a (row, doc)'s f32 score is +0.0 plus its
     contributions in work-list item order): the many-word rows of
     sum_order_queries (256 OR rows of 3-8 band terms, 64 rows ``+a +b c
     d``, seed 41) served three times at k = 10, 100 and 1,000 on both
     readers and on the combined view over the packed segment split in
     4, every run bit-equal to the first (phase 14 does the same on its
     sharded indexes); K3 bit-equal to its twin on a many-word call; the
     64 packed ``and`` rows bit-equal to a packed CPU reader's answers.
     Its gates are in serve_pruning's and serve_sum_order's docstrings;
     its figures print under ``topk``, ``pruning`` and ``sum_order``, its
     launches under ``pruning_launches`` and in the kernels' rows.
The kernels' rows: K1 (decode_blocks), K2 (decode_score_blocks), K3
(combine_lanes) and the port's own ordered-sum kernel
(segment_sum_ordered, csrc/ordered_sum.cu), each with its launches summed
over the phases' main-path runs; a kernel that never launched fails the
run. The plane-build kernel's row (build_position_planes,
csrc/phrase_plane.cu) counts the decoded reader's prewarm and mix (phases
3-4), where it must launch. Each kernel's bound is the bytes it must move at the replayed shape (its
wrapper module's min_bytes) over the card's 3.35 TB/s. Kernel times are
the mean of back-to-back runs over rotating copies of their inputs (cold
L2), enqueued behind a sleep so that host launch time is not counted
(cuda_ms). Any failure raises. The last three lines are the kernels'
JSON record (with qps, packed_qps, qps_no_phrase, tf_plane_mib,
pair_rows, plane_rows, phase 10's mixed_qps, mixed_packed_qps,
extras_qps, mixed_rows and the mixed chunk's bytes a (row, doc), and
phase 11's filter_qps, filter_packed_qps, filter_kernel_ms_busy,
filter_planes and host_rows, phase 13's figures under ``query_surface``,
phase 14's under ``sharded`` with its launches under ``sharded_launches``,
phase 15's under ``drivers`` and ``drivers_launches``, phase 16's under
``topk``, ``pruning``, ``sum_order`` and ``pruning_launches``, phase 9's
ordered-sum replay under ``ordered_sum`` and plane-build replay under
``plane_build``, and phase 12's figures under
``nrt`` with its launches under ``nrt_launches``), the card's name and
power limit, and the device line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from rucene_tpu_torch.drivers.bench import serve_mix
from rucene_tpu_torch.drivers.profile_bench import profile_fn
from rucene_tpu_torch.drivers.workload import (
    YEAR_S,
    build_corpus,
    build_queries,
    pack_corpus,
    sample_bigrams,
)

K = 100
BATCH = 256
N_QUERIES = 512
K1_SOURCE = "rucene_tpu_torch/csrc/decode.cu"
K2_SOURCE = K1_SOURCE
K3_SOURCE = "rucene_tpu_torch/csrc/combine.cu"
K4_SOURCE = "rucene_tpu_torch/csrc/ordered_sum.cu"
K5_SOURCE = "rucene_tpu_torch/csrc/phrase_plane.cu"
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
FIELDS_SEED = 23  # pack_corpus: the ts / tag / doc-value fields of phases 10-14


T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, with the seconds since the script started."""
    print(f"# [{time.perf_counter() - T0:6.1f}s] {msg}", flush=True)


# --- the phases' rows (the bench's corpus and mix: drivers/workload.py) ------


def head_pair_queries(vocab, n: int = 32, seed: int = 5):
    """Two-term OR rows over head-band terms (ranks 0-63): dense postings,
    so the executor's shape rule takes the dense branch."""
    from rucene_tpu_torch import BooleanQuery, Term, TermQuery

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b = rng.choice(64, 2, replace=False)
        q = BooleanQuery()
        q.should(TermQuery(Term("body", vocab[a])))
        q.should(TermQuery(Term("body", vocab[b])))
        out.append(q)
    return out


def band_sampler(vocab, probs, rng, lo: int = 10, hi: int = 5000):
    """A draw of one term from the bench's rank band (bench.py:142),
    weighted by its Zipf probability."""
    band = np.arange(lo, min(hi, len(vocab)))
    band_p = probs[band] / probs[band].sum()
    return lambda: vocab[rng.choice(band, p=band_p)]


def mixed_queries(phrase_texts, vocab, probs, n: int = 256, seed: int = 17):
    """Phase 10's mixed rows: one exact bigram from phrase_texts (bench.
    sample_bigrams), MUST in 3 rows of 4 and FILTER in the fourth, beside
    1-2 term clauses from the bench's band, SHOULD 1/2, MUST 1/4,
    MUST_NOT 1/4: at most two scoring term clauses, so a row's sum is
    exact in any order."""
    from rucene_tpu_torch import BooleanQuery, PhraseQuery, Term, TermQuery

    rng = np.random.default_rng(seed)
    term = band_sampler(vocab, probs, rng)
    bigrams = sample_bigrams(phrase_texts, n)
    out = []
    for i in range(n):
        q = BooleanQuery()
        (q.filter if i % 4 == 3 else q.must)(PhraseQuery("body", list(bigrams[i % len(bigrams)])))
        for _ in range(int(rng.integers(1, 3))):
            u = rng.random()
            (q.should if u < 0.5 else q.must if u < 0.75 else q.must_not)(
                TermQuery(Term("body", term()))
            )
        out.append(q)
    return out


def extras_queries(vocab, probs, seed: int = 19):
    """Phase 10's score-combine rows: (112 rows, 16 head-band rows). The
    112 draw their terms from ranks 200-5000 of the bench's band, sparse
    enough that their batch takes the flat executor's candidate branch:
    32 two-term DisjunctionMax rows (tie 0.0 and 0.3), 32 ConstantScore
    rows over a two-term OR (boost 2.0), 32 Boosting rows (a two-term OR
    demoted by a third term, factor 0.5) and 16 MatchAll rows (boost 1.0
    and 3.0). The 16 are two-term DisjunctionMax rows over ranks 0-63,
    served as their own batch: dense postings, so the dense branch (the
    combine kernel) carries the extras."""
    from rucene_tpu_torch import (
        BooleanQuery,
        BoostingQuery,
        ConstantScoreQuery,
        DisjunctionMaxQuery,
        MatchAllDocsQuery,
        Term,
        TermQuery,
    )

    rng = np.random.default_rng(seed)
    term = band_sampler(vocab, probs, rng, lo=200)

    def t(w=None):
        return TermQuery(Term("body", term() if w is None else w))

    def or2():
        q = BooleanQuery()
        q.should(t())
        q.should(t())
        return q

    rows = [DisjunctionMaxQuery([t(), t()], tie_breaker=0.3 * (i % 2)) for i in range(32)]
    rows += [ConstantScoreQuery(or2(), 2.0) for _ in range(32)]
    rows += [BoostingQuery(or2(), t(), 0.5) for _ in range(32)]
    rows += [MatchAllDocsQuery(boost=1.0 + 2.0 * (i % 2)) for i in range(16)]
    head = [
        DisjunctionMaxQuery([t(vocab[a]), t(vocab[b])], tie_breaker=0.3 * (i % 2))
        for i, (a, b) in enumerate(rng.choice(64, 2, replace=False) for _ in range(16))
    ]
    return rows, head


MONTH_STARTS = np.cumsum([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30]) * 86400


def filter_queries(phrase_texts, vocab, probs, seed: int = 23):
    """Phase 11's rows: (stage A: 256 filter rows, the indices of its 96
    term-MUST rows (stage B), stage C: 16 host rows). A ``ts`` window is 1,
    7, 30 or 90 days from one of 12 month starts; term-MUST rows draw their
    term from ranks 200-5000 of the bench's band, the rest from 10-5000.
    Stage A, in blocks: 64 rows term MUST + window FILTER; 64 rows two
    terms SHOULD + window FILTER; 32 rows term MUST + PrefixQuery(tag,
    c0-c9 or c00-c99) FILTER; 32 rows term SHOULD + ExistsQuery(tag) MUST;
    32 windows alone; 32 mixed rows, an exact bigram from phrase_texts MUST
    + window FILTER + a term SHOULD (a mixed row holds a term clause; a
    phrase and a window alone is a host row, as in the reference). Stage C,
    4 of each: a nested pure-SHOULD group, 9
    nested windows, match-all + window FILTER, dismax over two-clause
    booleans."""
    from rucene_tpu_torch import (
        BooleanQuery,
        DisjunctionMaxQuery,
        ExistsQuery,
        MatchAllDocsQuery,
        PhraseQuery,
        PointRangeQuery,
        PrefixQuery,
        Term,
        TermQuery,
    )

    rng = np.random.default_rng(seed)
    band = band_sampler(vocab, probs, rng)
    sparse = band_sampler(vocab, probs, rng, lo=200)

    def t(w):
        return TermQuery(Term("body", w))

    def window(days=None, start=None):
        start = int(MONTH_STARTS[rng.integers(12)]) if start is None else start
        days = int(rng.choice([1, 7, 30, 90])) if days is None else days
        return PointRangeQuery("ts", start, start + days * 86400 - 1)

    def row(*clauses):
        q = BooleanQuery()
        for occ, sub in clauses:
            getattr(q, occ)(sub)
        return q

    def prefix():
        return PrefixQuery("tag", f"c{rng.integers(10)}" if rng.random() < 0.5 else f"c{rng.integers(100):02d}")

    bigrams = sample_bigrams(phrase_texts, 32, seed=seed)
    stage_a = [row(("must", t(sparse())), ("filter", window())) for _ in range(64)]
    stage_a += [row(("should", t(band())), ("should", t(band())), ("filter", window())) for _ in range(64)]
    stage_a += [row(("must", t(sparse())), ("filter", prefix())) for _ in range(32)]
    stage_a += [row(("should", t(band())), ("must", ExistsQuery("tag"))) for _ in range(32)]
    stage_a += [window() for _ in range(32)]
    stage_a += [row(("must", PhraseQuery("body", list(bigrams[i % len(bigrams)]))),
                    ("should", t(band())), ("filter", window())) for i in range(32)]
    stage_b = list(range(64)) + list(range(128, 160))
    host = []
    for _ in range(4):
        host.append(row(("must", row(("should", t(band())), ("should", t(band())))), ("must", t(band()))))
    for _ in range(4):
        start = int(MONTH_STARTS[rng.integers(9)])
        host.append(row(("must", t(band())),
                        *[("filter", window(90, start + d * 86400)) for d in range(9)]))
    for _ in range(4):
        host.append(row(("must", MatchAllDocsQuery(boost=2.0)), ("filter", window())))
    for _ in range(4):
        host.append(DisjunctionMaxQuery([
            row(("should", t(band())), ("should", t(band()))),
            row(("must", t(band())), ("should", t(band()))),
        ], tie_breaker=0.3))
    return stage_a, stage_b, host


# --- measurement helpers ------------------------------------------------------


def cuda_ms(fn, args, reps: int = 20, copies: int = 4) -> float:
    """Mean device time of fn(*args) over reps back-to-back runs, after a
    warm run. The runs rotate over ``copies`` clones of every tensor
    argument and each run's result is kept to the end, so a run finds
    neither its inputs nor its outputs in the 50 MB L2 unless the caller's
    working set is that small. A sleep kernel holds the card until every
    run is enqueued, so host launch time is not counted (unless fn
    synchronises); the gap between two launches on the stream is."""
    sets = [args] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(copies - 1)
    ]
    fn(*args)
    torch.cuda.synchronize()
    kept = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for i in range(reps):
        kept.append(fn(*sets[i % copies]))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_passes(searcher, queries, passes: int = 3, top: int = 10):
    """(kernel ms per pass, device busy share: the union of kernel
    intervals over the wall time, the ``top`` kernels by device time as
    [name, ms per pass]) over pipelined passes under torch.profiler."""

    def one_pass():
        pending = []
        for i in range(0, len(queries), BATCH):
            pending.append(searcher.search_batch_async(queries[i:i + BATCH], k=K))
            while len(pending) >= 3:
                pending.pop(0)()
        while pending:
            pending.pop(0)()

    return profile_fn(one_pass, passes, top)


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_MS


def serve(searcher, queries, depth: int = 3, min_s: float = 5.0, max_reps: int = 10):
    """The bench's serving loop (drivers.bench.serve_mix) at batch BATCH
    and k=K; returns (qps, last pass's TopDocs)."""
    served = serve_mix(searcher, queries, BATCH, K, depth, min_s, max_reps)
    torch.cuda.synchronize()
    return served.qps, served.results


def phrase_gates(counters, n_rows: int, n_phrase: int, n_queries: int, full: bool, where: str):
    """The phrase gates over one serving stage's counter deltas: every
    phrase row took the phrase route and no row the host route; at full
    size both device phrase routes were taken and no phrase row went to
    the scalar engine or the host."""
    rows = counters.get("route.device", 0) + counters.get("route.phrase", 0)
    passes = rows // n_queries
    if counters.get("route.host", 0) or counters.get("route.mixed", 0):
        raise AssertionError(f"{where}: {counters.get('route.host', 0)} host and "
                             f"{counters.get('route.mixed', 0)} mixed rows in the bench mix")
    if rows != passes * n_queries or counters.get("route.phrase", 0) != passes * n_phrase:
        raise AssertionError(f"{where}: {counters.get('route.phrase', 0)} phrase-route rows "
                             f"over {rows} rows, expected {n_phrase} in every {n_queries}")
    log(f"{where} phrase rows: " + " ".join(
        f"{k}={counters.get(k, 0)}" for k in (
            "route.phrase", "search.phrase_device", "search.phrase_plane",
            "search.phrase_plane_build", "search.phrase_plane_denied",
            "search.phrase_scalar_route", "search.phrase_host_fallback",
            "search.phrase_pruned_blocks",
        )
    ) + f" over {passes} passes")
    if not full:
        return
    for name in ("search.phrase_device", "search.phrase_plane"):
        if counters.get(name, 0) <= 0:
            raise AssertionError(f"{where}: no phrase row took {name}")
    for name in ("search.phrase_scalar_route", "search.phrase_host_fallback"):
        if counters.get(name, 0):
            raise AssertionError(f"{where}: {counters[name]} phrase rows took {name}")


def route_gates(counters, n_two_term: int, n_queries: int, split: bool, where: str):
    """The two-term gates over one serving stage's counter deltas: on a
    corpus that splits batches by row class (2^19 docs or more, where the
    tf planes are on as well) every two-term row took the pair or the
    tf-plane route, and both were taken. The one leaf counts each row
    once: a pair row that overflows MAXP_CAP counts under
    search.pair_overflow_rows, not route.pair_rows. Returns (pair rows,
    plane rows)."""
    rows = counters.get("route.device", 0) + counters.get("route.phrase", 0)
    passes = rows // n_queries
    pair = counters.get("route.pair_rows", 0)
    plane = counters.get("route.plane_rows", 0)
    over = counters.get("search.pair_overflow_rows", 0)
    log(f"{where} two-term rows: route.pair_rows={pair} route.plane_rows={plane} "
        f"search.pair_overflow_rows={over} over {passes} passes")
    if counters.get("route.host", 0):
        raise AssertionError(f"{where}: {counters['route.host']} rows took the host route")
    if not split:
        return pair, plane
    if pair + plane + over != passes * n_two_term:
        raise AssertionError(f"{where}: {pair} pair + {plane} plane + {over} overflow rows over "
                             f"{passes} passes, expected {n_two_term} two-term rows in every pass")
    if pair <= 0 or plane <= 0:
        raise AssertionError(f"{where}: the pair route ({pair}) or the plane route ({plane}) "
                             "was never taken")
    return pair, plane


def launch_counters() -> dict:
    """Each kernel's name in the JSON line -> its wrapper's launch counter."""
    from rucene_tpu_torch.ops import cuda_combine, cuda_decode, ordered_sum

    return {"decode_blocks": cuda_decode.LAUNCH_COUNTER,
            "decode_score_blocks": cuda_decode.SCORE_LAUNCH_COUNTER,
            "combine_lanes": cuda_combine.LAUNCH_COUNTER,
            "segment_sum_ordered": ordered_sum.LAUNCH_COUNTER}


def launches_in(*counters: dict) -> dict:
    """Each kernel's launches summed over the counter snapshots given."""
    return {name: sum(c.get(key, 0) for c in counters) for name, key in launch_counters().items()}


def counter_delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


@contextlib.contextmanager
def plain_decode_refused():
    """The plain decode twins raise while the block runs: packed serving
    must decode through the kernels."""
    from rucene_tpu_torch.ops import cuda_decode

    def refuse(*_a, **_k):
        raise AssertionError("a plain decode twin ran on the card during packed serving")

    twins = (cuda_decode.decode_blocks_plain, cuda_decode.decode_score_blocks_plain)
    cuda_decode.decode_blocks_plain = cuda_decode.decode_score_blocks_plain = refuse
    try:
        yield
    finally:
        cuda_decode.decode_blocks_plain, cuda_decode.decode_score_blocks_plain = twins


def serve_packed(packed, queries, dense_q, dev, card, split, n_phrase, full):
    """Phase 8: a reader over ``packed`` whose segment is built with
    RUCENE_DECODED=0, serving the mix with the plain decode twins replaced
    by a raise, after dropping the decoded reader's position planes and
    prewarming its own (through K1), then the head-band rows ``dense_q``
    (through K3). Counts are reset just before and read just after.
    Returns (searcher, qps, last pass's TopDocs, launches)."""
    from rucene_tpu_torch.ops import cuda_combine
    from rucene_tpu_torch import IndexSearcher
    from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
    from rucene_tpu_torch.ops import cuda_decode
    from rucene_tpu_torch.search import phrase_path
    from rucene_tpu_torch.util.metrics import METRICS

    prev = os.environ.get("RUCENE_DECODED")
    phrase_path._PLANE_CACHE.clear()  # the decoded reader's planes
    METRICS.reset()
    torch.cuda.reset_peak_memory_stats()
    os.environ["RUCENE_DECODED"] = "0"
    try:
        with plain_decode_refused():
            searcher = IndexSearcher(IndexReader([SegmentSnapshot("bench", packed)]), device=dev)
            pdev = searcher.reader.leaves[0].device
    finally:
        if prev is None:
            os.environ.pop("RUCENE_DECODED")
        else:
            os.environ["RUCENE_DECODED"] = prev
    with plain_decode_refused():
        if pdev.docs_dec is not None or pdev.freqs_dec is not None or pdev.norm_dec is not None:
            raise AssertionError("the packed reader built decoded planes")
        t = time.perf_counter()
        n_planes = searcher.prewarm_phrase_planes()
        torch.cuda.synchronize()
        log(f"packed reader prewarmed {n_planes} phrase planes in {time.perf_counter() - t:.2f}s "
            f"({phrase_path._PLANE_CACHE.nbytes / 2**20:.0f} MiB) through the decode kernel")
        before = METRICS.snapshot()["counters"]
        for i in range(0, len(queries), BATCH):  # warm pass
            searcher.search_batch(queries[i : i + BATCH], k=K)
        qps, results = serve(searcher, queries)
        mix_counters = METRICS.snapshot()["counters"]
        searcher.search_batch(dense_q, k=K)
        torch.cuda.synchronize()
    counters = METRICS.snapshot()["counters"]  # the packed path ends here
    k3 = counters.get(cuda_combine.LAUNCH_COUNTER, 0)
    mix_k3 = mix_counters.get(cuda_combine.LAUNCH_COUNTER, 0)
    log(f"combine launches on the packed path: {mix_k3} in the mix, "
        f"{k3 - mix_k3} for the head-band rows")
    if k3 <= 0:
        raise AssertionError("the combine kernel never launched on the packed path")
    if counters.get("route.pair_rows", 0) or counters.get("route.plane_rows", 0):
        raise AssertionError("the packed reader took the pair or the tf-plane route")
    k1 = counters.get(cuda_decode.LAUNCH_COUNTER, 0)
    k1_serving = k1 - before.get(cuda_decode.LAUNCH_COUNTER, 0)
    k2 = counters.get(cuda_decode.SCORE_LAUNCH_COUNTER, 0)
    log(f"packed mix: {qps:.1f} QPS ({len(queries)} queries, batch {BATCH}, k={K}) on {card}; "
        f"packed words {pdev.data.numel() * 4 / 2**20:.0f} MiB, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("packed routes: " + " ".join(f"{k}={v}" for k, v in sorted(counters.items())))
    if k2 <= 0:
        raise AssertionError("the scoring decode kernel never launched on the packed path")
    if split and counters.get("route.single", 0) <= 0:
        raise AssertionError("no packed row took the single-term route")
    if k1_serving <= 0:
        raise AssertionError("the packed reader's phrase rows never launched the decode kernel")
    log(f"decode kernel launches on the packed path: {k1} ({k1 - k1_serving} in the prewarm, "
        f"{k1_serving} serving phrase rows)")
    phrase_gates(counter_delta(mix_counters, before), len(queries), n_phrase, len(queries),
                 full, "packed mix")
    return searcher, qps, results, launches_in(counters)


def serve_combine_rows(searchers, cpu_searcher, mixed_q, extras_q, head_q, card, full):
    """Phase 10: the mixed rows, then the score-combine rows (the 112,
    then the 16 head-band rows as their own batch), on each reader of
    ``searchers`` ({"decoded": ..., "packed": ...}; the packed one with the
    plain decode twins refused). Each stage is warmed once, then its
    counts are set to 0, it is served (pipelined passes) and its counts
    are read. Gates: every mixed row on route.mixed and none spilled;
    the combine kernel launched by the mixed rows on both readers and the
    scoring decode on the packed one; both executor branches taken by the
    score-combine rows; the packed answers equal to the decoded ones bit
    for bit; 16 mixed and 16 score-combine rows served on the card equal
    to the same rows served by the port on the CPU. Returns a dict of
    QPS, launches, routes, device time and peak figures."""
    from rucene_tpu_torch.ops import cuda_combine, cuda_decode
    from rucene_tpu_torch.util.metrics import METRICS
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import assert_topdocs_strict  # numpy-only test helper

    out = {"launches": {}, "results": {}}
    for name, searcher in searchers.items():
        guard = plain_decode_refused() if name == "packed" else contextlib.nullcontext()
        with guard:
            searcher.search_batch(mixed_q, k=K)  # warm: planes of terms first seen here
            METRICS.reset()
            qps, mixed_res = serve(searcher, mixed_q)
            mixed = METRICS.snapshot()["counters"]
            searcher.search_batch(extras_q, k=K)
            searcher.search_batch(head_q, k=K)
            METRICS.reset()
            extras_qps, extras_res = serve(searcher, extras_q)
            head_res = searcher.search_batch(head_q, k=K)
            torch.cuda.synchronize()
            extras = METRICS.snapshot()["counters"]
        rows = sum(mixed.get(f"route.{r}", 0) for r in ("device", "phrase", "mixed"))
        passes = rows // len(mixed_q)
        if rows != passes * len(mixed_q) or mixed.get("route.mixed", 0) != rows:
            raise AssertionError(f"{name}: {mixed.get('route.mixed', 0)} of {rows} mixed rows "
                                 "took route.mixed")
        if mixed.get("search.mixed_host_spill", 0):
            raise AssertionError(f"{name}: {mixed['search.mixed_host_spill']} mixed rows spilled")
        k3_mixed = mixed.get(cuda_combine.LAUNCH_COUNTER, 0)
        k2_mixed = mixed.get(cuda_decode.SCORE_LAUNCH_COUNTER, 0)
        if k3_mixed <= 0:
            raise AssertionError(f"{name}: the mixed rows never launched the combine kernel")
        if name == "packed" and k2_mixed <= 0:
            raise AssertionError("packed: the mixed rows never launched the scoring decode")
        dense = extras.get("search.strategy.dense", 0)
        cand = extras.get("search.strategy.candidate", 0)
        if full and (dense <= 0 or cand <= 0):
            raise AssertionError(f"{name}: the score-combine rows took the dense branch {dense} "
                                 f"and the candidate branch {cand} times; both must be taken")
        log(f"{name} mixed rows: {qps:.1f} QPS ({len(mixed_q)} rows, k={K}) on {card}; "
            f"{passes} passes, route.mixed={mixed.get('route.mixed', 0)}, combine launches "
            f"{k3_mixed}, scoring decode launches {k2_mixed}, decode launches "
            f"{mixed.get(cuda_decode.LAUNCH_COUNTER, 0)}, phrase planes built "
            f"{mixed.get('search.phrase_plane_build', 0)}")
        log(f"{name} score-combine rows: {extras_qps:.1f} QPS ({len(extras_q)} rows) on {card}; "
            f"strategy dense={dense} candidate={cand}, combine launches "
            f"{extras.get(cuda_combine.LAUNCH_COUNTER, 0)}, routes " + " ".join(
                f"{k}={v}" for k, v in sorted(extras.items()) if k.startswith("route.")))
        for kname, n in launches_in(mixed, extras).items():
            out["launches"][kname] = out["launches"].get(kname, 0) + n
        out[f"{name}_mixed_qps"] = qps
        out[f"{name}_extras_qps"] = extras_qps
        out["results"][name] = (mixed_res, extras_res + head_res)
        ms, busy, top = profile_passes(searcher, mixed_q)
        out[f"{name}_mixed_profile"] = (ms, busy)
        log(f"{name} mixed rows under torch.profiler: {ms:.2f} ms of kernels a pass of "
            f"{len(mixed_q)} rows, device busy {100 * busy:.1f}%; top kernels (ms a pass): "
            + "; ".join(f"{n} {t:.2f}" for n, t in top[:6]))
        ms, busy, _top = profile_passes(searcher, extras_q)
        out[f"{name}_extras_profile"] = (ms, busy)
        log(f"{name} score-combine rows under torch.profiler: {ms:.2f} ms of kernels a pass of "
            f"{len(extras_q)} rows, device busy {100 * busy:.1f}%")

    dec, pkd = out["results"]["decoded"], out["results"]["packed"]
    for kind, a, b in (("mixed", dec[0], pkd[0]), ("score-combine", dec[1], pkd[1])):
        for i, (x, y) in enumerate(zip(a, b)):
            if x.total_hits != y.total_hits or x.score_docs != y.score_docs:
                raise AssertionError(f"packed {kind} row {i} differs from the decoded run")
    log(f"packed answers equal the decoded ones bit for bit ({len(dec[0])} mixed rows, "
        f"{len(dec[1])} score-combine rows)")

    # the peak and time of one 64-row mixed chunk (one arity, one call a leaf)
    peak, ms, moved = route_peak(searchers["decoded"], mixed_q[:64])
    mdp = searchers["decoded"].reader.leaves[0].device.max_doc_padded
    out["mixed_chunk_bytes_per_row_doc"] = peak / (64 * mdp)
    log(f"a 64-row mixed chunk served alone (decoded): peak {peak / 2**20:.1f} MiB above the "
        f"resident set ({out['mixed_chunk_bytes_per_row_doc']:.1f} bytes a (row, doc)), "
        f"{ms:.3f} ms between events; routes {moved}")

    t = time.perf_counter()
    m_idx = list(range(0, len(mixed_q), len(mixed_q) // 16))[:16]
    for i, want in zip(m_idx, cpu_searcher.search_batch([mixed_q[i] for i in m_idx], k=K)):
        assert_topdocs_strict(dec[0][i], want)
    all_extras = extras_q + head_q
    e_idx = [0, 9, 18, 27, 32, 41, 50, 59, 64, 73, 82, 91, 96, 105, 112, 121]
    for i, want in zip(e_idx, cpu_searcher.search_batch([all_extras[i] for i in e_idx], k=K)):
        assert_topdocs_strict(dec[1][i], want)
    log(f"16 mixed and 16 score-combine rows match the CPU run hit for hit "
        f"({time.perf_counter() - t:.1f}s)")
    del out["results"]
    return out


def plane_cache_figures() -> tuple[int, float]:
    """(filter planes, MiB) held in the device plane cache, stacks aside."""
    from rucene_tpu_torch.search.cache import DEVICE_PLANE_CACHE

    planes = [v for key, (_ref, v) in DEVICE_PLANE_CACHE._entries.items() if key[2][0] == "plane"]
    return len(planes), sum(p.numel() * p.element_size() for p in planes) / 2**20


def serve_filter_rows(searchers, cpu_searcher, stage_a, stage_b, host_q, card, full):
    """Phase 11: the filter rows on each reader of ``searchers`` (the
    packed one with the plain decode twins refused), in three stages, each
    warmed once, then its counts set to 0, served and read. Stage A: the
    256 rows, pipelined passes; stage B: its 96 term-MUST rows alone;
    stage C: the 16 host rows, one batch. Gates: in A and B every non-mixed
    row on route.device and every mixed row on route.mixed, route.host and
    search.mixed_host_spill 0; the dense branch taken in A and (at full
    size) the candidate branch in B; K3 launched by A on both readers and
    K2 on the packed one; the timed passes build no filter plane (the
    device plane cache's misses do not grow); packed answers equal the
    decoded ones bit for bit; 16 rows of A (every kind) and all of C equal
    the CPU run; route.host exactly 16 in C. Returns QPS, launches,
    profiles, the dense batch's peak and the host stage's seconds."""
    from rucene_tpu_torch.ops import cuda_combine, cuda_decode
    from rucene_tpu_torch.search.cache import DEVICE_PLANE_CACHE
    from rucene_tpu_torch.util.metrics import METRICS
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import assert_topdocs_strict  # numpy-only test helper

    b_q = [stage_a[i] for i in stage_b]
    n_mixed = 32
    dense_rows = stage_a[:-n_mixed]
    out = {"launches": {}, "results": {}}
    for name, searcher in searchers.items():
        guard = plain_decode_refused() if name == "packed" else contextlib.nullcontext()
        with guard:
            searcher.search_batch(stage_a, k=K)  # warm: filter and phrase planes built here
            searcher.search_batch(b_q, k=K)
            METRICS.reset()
            misses = DEVICE_PLANE_CACHE.misses
            qps, a_res = serve(searcher, stage_a)
            a_cnt = METRICS.snapshot()["counters"]
            a_misses = DEVICE_PLANE_CACHE.misses - misses
            METRICS.reset()
            misses = DEVICE_PLANE_CACHE.misses
            b_qps, b_res = serve(searcher, b_q)
            b_cnt = METRICS.snapshot()["counters"]
            b_misses = DEVICE_PLANE_CACHE.misses - misses
            METRICS.reset()
            t = time.perf_counter()
            c_res = searcher.search_batch(host_q, k=K)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t
            c_cnt = METRICS.snapshot()["counters"]
        for stage, cnt, rows, mixed in (("A", a_cnt, len(stage_a), n_mixed), ("B", b_cnt, len(b_q), 0)):
            passes = (cnt.get("route.device", 0) + cnt.get("route.mixed", 0)) // rows
            if (passes < 1 or cnt.get("route.device", 0) != passes * (rows - mixed)
                    or cnt.get("route.mixed", 0) != passes * mixed):
                raise AssertionError(f"{name} stage {stage}: routes {cnt}, expected {rows - mixed} "
                                     f"device and {mixed} mixed rows a pass")
            for bad in ("route.host", "route.phrase", "search.mixed_host_spill"):
                if cnt.get(bad, 0):
                    raise AssertionError(f"{name} stage {stage}: {bad}={cnt[bad]}")
        if a_misses or b_misses:
            raise AssertionError(f"{name}: the timed passes built {a_misses} + {b_misses} filter "
                                 "planes or stacks")
        if a_cnt.get("search.strategy.dense", 0) <= 0:
            raise AssertionError(f"{name} stage A never took the dense branch")
        if full and b_cnt.get("search.strategy.candidate", 0) <= 0:
            raise AssertionError(f"{name} stage B never took the candidate branch")
        k3 = a_cnt.get(cuda_combine.LAUNCH_COUNTER, 0)
        k2 = a_cnt.get(cuda_decode.SCORE_LAUNCH_COUNTER, 0)
        if k3 <= 0:
            raise AssertionError(f"{name}: stage A never launched the combine kernel")
        if name == "packed" and (k2 <= 0 or b_cnt.get(cuda_decode.SCORE_LAUNCH_COUNTER, 0) <= 0):
            raise AssertionError("packed: the filter rows never launched the scoring decode")
        if c_cnt.get("route.host", 0) != len(host_q) or c_cnt.get("route.device", 0):
            raise AssertionError(f"{name} stage C: routes {c_cnt}, expected {len(host_q)} host rows")
        log(f"{name} filter rows: stage A {qps:.1f} QPS ({len(stage_a)} rows, k={K}) on {card}; "
            f"strategy dense={a_cnt.get('search.strategy.dense', 0)} candidate="
            f"{a_cnt.get('search.strategy.candidate', 0)}, combine launches {k3}, scoring decode "
            f"launches {k2}; stage B {b_qps:.1f} QPS ({len(b_q)} rows), strategy "
            f"candidate={b_cnt.get('search.strategy.candidate', 0)} "
            f"dense={b_cnt.get('search.strategy.dense', 0)}; stage C: {len(host_q)} host rows "
            f"in {host_s:.3f}s")
        for kname, n in launches_in(a_cnt, b_cnt, c_cnt).items():
            out["launches"][kname] = out["launches"].get(kname, 0) + n
        out[f"{name}_qps"] = qps
        out[f"{name}_host_s"] = host_s
        out["results"][name] = (a_res, b_res, c_res)
        ms, busy, top = profile_passes(searcher, stage_a)
        out[f"{name}_profile"] = (ms, busy)
        log(f"{name} stage A under torch.profiler: {ms:.2f} ms of kernels a pass of "
            f"{len(stage_a)} rows, device busy {100 * busy:.1f}%; top kernels (ms a pass): "
            + "; ".join(f"{n} {t:.2f}" for n, t in top[:6]))

    dec, pkd = out["results"]["decoded"], out["results"]["packed"]
    for stage, a, b in zip("ABC", dec, pkd):
        for i, (x, y) in enumerate(zip(a, b)):
            if x.total_hits != y.total_hits or x.score_docs != y.score_docs:
                raise AssertionError(f"packed stage {stage} row {i} differs from the decoded run")
    log(f"packed answers equal the decoded ones bit for bit ({len(dec[0])} + {len(dec[1])} + "
        f"{len(dec[2])} rows)")

    peak, ms, moved = route_peak(searchers["decoded"], dense_rows)
    mdp = searchers["decoded"].reader.leaves[0].device.max_doc_padded
    out["dense_bytes_per_row_doc"] = peak / (len(dense_rows) * mdp)
    out["planes"], plane_mib = plane_cache_figures()
    log(f"stage A's {len(dense_rows)} dense rows served alone (decoded): peak {peak / 2**20:.1f} MiB "
        f"above the resident set ({out['dense_bytes_per_row_doc']:.1f} bytes a (row, doc)), "
        f"{ms:.3f} ms between events; routes {moved}; {out['planes']} filter planes cached "
        f"({plane_mib:.1f} MiB)")

    t = time.perf_counter()
    a_idx = [0, 21, 63, 64, 100, 127, 128, 143, 160, 191, 192, 210, 224, 240, 241, 255]
    for i, want in zip(a_idx, cpu_searcher.search_batch([stage_a[i] for i in a_idx], k=K)):
        assert_topdocs_strict(dec[0][i], want)
    for i, want in enumerate(cpu_searcher.search_batch(host_q, k=K)):
        assert_topdocs_strict(dec[2][i], want)
    log(f"16 stage-A rows (every kind) and {len(host_q)} host rows match the CPU run hit for hit "
        f"({time.perf_counter() - t:.1f}s)")
    del out["results"]
    return out


# --- phase 13: the query surface (sorted, collapse, spans, rescore, explain) -

SURFACE_SEED = 29


def surface_queries(phrase_texts, vocab, probs, seed: int = SURFACE_SEED):
    """Phase 13's rows, drawn from ``seed``: band terms at ranks 10-5000 as
    the other phases draw them, head-band terms at ranks 0-63, words and
    bigrams from the docs of ``phrase_texts``. Returns a dict of stages:
    - "S", 76 (query, Sort) rows after luceneutil's TermDTSort and
      HighTermMonthSort tasks: 32 single-term rows by ts descending, 32
      two-term AND rows by (month, ts descending), 8 head-band two-term OR
      rows by ts descending, and 4 single-term rows by score, then ts (the
      host path);
    - "C", 40 rows collapsed by grp (TermGroup10K): 32 band terms, 8
      head-band two-term ORs;
    - "N", 104 span and synonym rows for one batch: 32 SpanOrQuery rows of
      2-3 band terms; 32 unordered SpanNearQuery rows of 2-3 distinct words
      from one window of a doc, slop 0-8, so that they match; 16 ordered
      slop-0 rows over a bigram with a band term ORed to one side; 8
      SpanTermQuery rows; 8 ordered plain-term span-near rows over a bigram
      (the device_equivalent rows); 8 nested trees over words of rank 100
      or more (an ordered near inside an unordered near, or a SpanOr of
      two nears: the host route, which decodes their postings on the
      host);
    - "R", 32 (first-pass term row, rescore query) pairs, the rescore query
      a two-term SHOULD boolean of band terms, of head-band terms in the
      last 8;
    - "E", 16 (query string, the same query built by hand) pairs."""
    from rucene_tpu_torch import (
        BooleanQuery,
        PhraseQuery,
        PointRangeQuery,
        Sort,
        SortField,
        Term,
        TermQuery,
    )
    from rucene_tpu_torch.search.sort_field import SortFieldType
    from rucene_tpu_torch.search.spans import SpanNearQuery, SpanOrQuery, SpanTermQuery

    rng = np.random.default_rng(seed)
    band = band_sampler(vocab, probs, rng)

    def t(w, field="body", boost=1.0):
        return TermQuery(Term(field, w), boost=boost)

    def st(w):
        return SpanTermQuery(Term("body", w))

    def bq(*clauses):
        q = BooleanQuery()
        for occ, sub in clauses:
            getattr(q, occ)(sub)
        return q

    def distinct(n, avoid=()):
        out: list = []
        while len(out) < n:
            w = str(band())
            if w not in out and w not in avoid:
                out.append(w)
        return out

    def head_or():
        a, b = rng.choice(64, 2, replace=False)
        return bq(("should", t(vocab[a])), ("should", t(vocab[b])))

    def window_words(n, span, lo=0):
        """n distinct words of one doc, the first at a window's start and
        the rest inside its ``span`` positions, in doc order; each of rank
        ``lo`` or more (the vocabulary is w<rank>)."""
        while True:
            words = phrase_texts[int(rng.integers(0, len(phrase_texts)))].split()
            if len(words) < span:
                continue
            j = int(rng.integers(0, len(words) - span + 1))
            pos = [j] + sorted(rng.choice(np.arange(j + 1, j + span), n - 1, replace=False).tolist())
            picked = [words[p] for p in pos]
            if len(set(picked)) == n and min(int(w[1:]) for w in picked) >= lo:
                return picked

    bigrams = [bg for bg in sample_bigrams(phrase_texts, 64, seed=seed) if bg[0] != bg[1]]
    lng = SortFieldType.LONG
    ts_desc = Sort([SortField("ts", lng, reverse=True)])
    month_ts = Sort([SortField("month", lng), SortField("ts", lng, reverse=True)])
    by_score = Sort([SortField(None, SortFieldType.SCORE), SortField("ts", lng)])
    stages = {
        "S": [(t(band()), ts_desc) for _ in range(32)]
        + [(bq(*(("must", t(w)) for w in distinct(2))), month_ts) for _ in range(32)]
        + [(head_or(), ts_desc) for _ in range(8)]
        + [(t(band()), by_score) for _ in range(4)],
        "C": [t(band()) for _ in range(32)] + [head_or() for _ in range(8)],
    }
    spans = [SpanOrQuery([st(w) for w in distinct(int(rng.integers(2, 4)))]) for _ in range(32)]
    for _ in range(32):
        n, slop = int(rng.integers(2, 4)), int(rng.integers(0, 9))
        words = [str(w) for w in rng.permutation(window_words(n, n + slop))]
        spans.append(SpanNearQuery([st(w) for w in words], slop=slop, in_order=False))
    for i in range(16):
        a, b = bigrams[i]
        x = distinct(1, avoid=(a, b))[0]
        kids = [SpanOrQuery([st(a), st(x)]), st(b)] if i % 2 else [st(a), SpanOrQuery([st(b), st(x)])]
        spans.append(SpanNearQuery(kids, slop=0, in_order=True))
    spans += [st(band()) for _ in range(8)]
    spans += [SpanNearQuery([st(a), st(b)], slop=0, in_order=True) for a, b in bigrams[16:24]]
    for i in range(8):  # words of rank 100 or more: the host reads their postings
        if i % 2:
            a, b, c = window_words(3, 5, lo=100)
            inner = SpanNearQuery([st(a), st(b)], slop=2, in_order=True)
            spans.append(SpanNearQuery([inner, st(c)], slop=5, in_order=False))
        else:
            (a, b), (c, d) = window_words(2, 2, lo=100), window_words(2, 3, lo=100)
            spans.append(SpanOrQuery([SpanNearQuery([st(a), st(b)], slop=1, in_order=True),
                                      SpanNearQuery([st(c), st(d)], slop=2, in_order=False)]))
    stages["N"] = spans
    pairs = [(t(band()), bq(*(("should", t(w)) for w in distinct(2)))) for _ in range(24)]
    stages["R"] = pairs + [(t(band()), head_or()) for _ in range(8)]
    strings = []
    for i in range(2):
        a, b, c = distinct(3)
        p1, p2 = bigrams[24 + i]
        lo = int(MONTH_STARTS[rng.integers(12)])
        hi = lo + 30 * 86400 - 1
        tag = f"c{int(rng.integers(1000)):03d}"
        strings += [
            (f"+{a} -{b}", bq(("must", t(a)), ("must_not", t(b)))),
            (f"{a} AND {b}", bq(("must", t(a)), ("must", t(b)))),
            (f"{a} OR {b}", bq(("should", t(a)), ("should", t(b)))),
            (f'"{p1} {p2}"~2', PhraseQuery("body", [p1, p2], slop=2)),
            (f"body:{a}^2", t(a, boost=2.0)),
            (f"+{a} +({b} OR {c})", bq(("must", t(a)), ("must", bq(("should", t(b)), ("should", t(c)))))),
            (f"{a} AND ts:[{lo} TO {hi}]", bq(("must", t(a)), ("must", PointRangeQuery("ts", lo, hi)))),
            (f"tag:{tag} OR {a}", bq(("should", t(tag, field="tag")), ("should", t(a)))),
        ]
    stages["E"] = strings
    return stages


def field_docs_equal(got, want, exact: bool = True) -> bool:
    """Sorted results: total hits, docs and sort values equal; scores equal
    (exact) or within the strict RTOL."""
    from torch_hitcheck import RTOL

    if got.total_hits != want.total_hits or len(got.field_docs) != len(want.field_docs):
        return False
    for g, w in zip(got.field_docs, want.field_docs):
        if g.doc != w.doc or list(g.fields) != list(w.fields):
            return False
        if (g.score != w.score) if exact else abs(g.score - w.score) > RTOL * max(1.0, abs(w.score)):
            return False
    return True


def serve_query_surface(searchers, cpu_searcher, rows, mix_pairs, card):
    """Phase 13 on each reader of ``searchers`` (the packed one with the
    plain decode twins refused): the stages of surface_queries, each warmed
    once, then served with its counts set to 0 just before and read just
    after. S: search_sorted over its 76 rows; C: search_collapse by grp;
    N: one search_batch of the 104 span and synonym rows; R: the 32 first
    passes, each rescored over its top 50 by QueryRescorer (weight 2.0);
    E: explain of 16 (row, hit) pairs (6 from S, 6 from N and the 4 of
    ``mix_pairs`` from the bench mix) and the 16 query strings, parsed and
    served beside the same queries built by hand.

    Gates, each failing the run: the native span evaluator built and every
    nested row of N evaluated through it; N's routes (32 synonym, 48
    span_unordered, 8 host, 8 device, 8 phrase, 0 mixed); the combine kernel
    launched with entries to combine in S, C and R on both readers; the
    scoring decode launched in S, C and N on the packed reader and never on
    the decoded one; 4 host rows in S, none in C; each explanation's value
    its hit's score within RTOL; each parsed row's hits those of the row
    built by hand; the packed answers equal to the decoded ones bit for
    bit; 8 rows a stage equal to the CPU reader's (sort values, docs and
    collapse keys exact, scores within RTOL). Returns the figures under
    each reader's name and the launches."""
    from rucene_tpu_torch import native, parse_query_string
    from rucene_tpu_torch.ops import cuda_combine, cuda_decode
    from rucene_tpu_torch.search import executor, phrase_path, span_native
    from rucene_tpu_torch.search.rescorer import QueryRescorer
    from rucene_tpu_torch.util.metrics import METRICS
    from torch_hitcheck import RTOL, assert_topdocs_strict

    if not native.available or not span_native._register():
        raise AssertionError("the native span evaluator (rtpu_span_eval) did not build")
    kernel_counters = launch_counters()
    entries = [0]  # combine entries handed to the kernel in a stage
    native_calls: list = []
    real_combine, real_eval = executor.combine_lanes, span_native.eval_spans

    def combine_counted(bucket_ptr, target, sc, e_item, *rest):
        entries[0] += int(e_item.numel())
        return real_combine(bucket_ptr, target, sc, e_item, *rest)

    def eval_counted(*a, **kw):
        res = real_eval(*a, **kw)
        native_calls.append(res is not None)
        return res

    def stage(fn):
        """(result, seconds, counters, combine entries) of fn(), its counts
        set to 0 just before and read just after."""
        torch.cuda.synchronize()
        METRICS.reset()
        entries[0] = 0
        native_calls.clear()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, METRICS.snapshot()["counters"], entries[0]

    s_rows, c_rows, n_rows, r_rows, e_rows = (rows[s] for s in "SCNRE")
    out = {"launches": dict.fromkeys(kernel_counters, 0)}
    results = {}
    executor.combine_lanes, span_native.eval_spans = combine_counted, eval_counted
    try:
        for name, searcher in searchers.items():
            guard = plain_decode_refused() if name == "packed" else contextlib.nullcontext()
            fig: dict = {}
            with guard:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                run_s = lambda: [searcher.search_sorted(q, K, srt) for q, srt in s_rows]  # noqa: E731
                run_c = lambda: [searcher.search_collapse(q, K, "grp") for q in c_rows]  # noqa: E731
                run_n = lambda: searcher.search_batch(n_rows, k=K)  # noqa: E731
                t0 = time.perf_counter()
                run_s()  # warm: the rank tables
                run_c()
                fig["warm_sc_s"] = time.perf_counter() - t0
                keys = {(id(seg), k) for (seg,), k, _v in phrase_path._PLANE_CACHE.items()}
                run_n()  # warm: the span planes of terms first seen here
                torch.cuda.synchronize()
                built = [v for (seg,), k, v in phrase_path._PLANE_CACHE.items()
                         if (id(seg), k) not in keys]
                fig["span_planes"] = len(built)
                fig["span_plane_mib"] = sum(
                    p.numel() * p.element_size() + (0 if o is None else o.numel())
                    for p, o in built
                ) / 2**20
                s_res, s_sec, s_cnt, s_ent = stage(run_s)
                c_res, c_sec, c_cnt, c_ent = stage(run_c)
                n_res, n_sec, n_cnt, _ = stage(run_n)
                n_native = list(native_calls)
                firsts = searcher.search_batch([f for f, _ in r_rows], k=K)
                r_res, r_sec, r_cnt, r_ent = stage(lambda: [
                    QueryRescorer(q2, rescore_weight=2.0).rescore(searcher, first, top_n=50)
                    for (_f, q2), first in zip(r_rows, firsts)
                ])
                picks = [(q, fd.doc, fd.score) for (q, _srt), res in zip(s_rows, s_res)
                         for fd in res.field_docs[:1]][:72:12]
                picks += [(q, d, sc) for q, res in zip(n_rows, n_res)
                          for d, sc in res.score_docs[:1]][::17][:6]
                picks += mix_pairs
                e_res, e_sec, _e_cnt, _ = stage(lambda: [searcher.explain(q, d) for q, d, _s in picks])
                parsed = [parse_query_string(s, "body") for s, _h in e_rows]
                got_p = searcher.search_batch(parsed, k=K)
                got_h = searcher.search_batch([h for _s, h in e_rows], k=K)
                s_prof = profile_fn(run_s, passes=1)
                n_prof = profile_fn(run_n, passes=1)
                torch.cuda.synchronize()
                fig["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            # gates
            for st_name, cnt, ent in (("S", s_cnt, s_ent), ("C", c_cnt, c_ent), ("R", r_cnt, r_ent)):
                if cnt.get(cuda_combine.LAUNCH_COUNTER, 0) <= 0 or ent <= 0:
                    raise AssertionError(f"{name} stage {st_name}: the combine kernel combined "
                                         f"{ent} entries in {cnt.get(cuda_combine.LAUNCH_COUNTER, 0)} "
                                         "launches")
            for st_name, cnt in (("S", s_cnt), ("C", c_cnt), ("N", n_cnt)):
                k2 = cnt.get(cuda_decode.SCORE_LAUNCH_COUNTER, 0)
                if (name == "packed") != (k2 > 0):
                    raise AssertionError(f"{name} stage {st_name}: {k2} scoring decode launches")
            if s_cnt.get("route.host", 0) != 4 or c_cnt.get("route.host", 0) != 0:
                raise AssertionError(f"{name}: host rows S {s_cnt.get('route.host', 0)} (want 4), "
                                     f"C {c_cnt.get('route.host', 0)} (want 0)")
            want_routes = {"synonym": 32, "span_unordered": 48, "host": 8, "device": 8,
                           "phrase": 8, "mixed": 0}
            got_routes = {r: n_cnt.get(f"route.{r}", 0) for r in want_routes}
            if got_routes != want_routes:
                raise AssertionError(f"{name} stage N: routes {got_routes}, want {want_routes}")
            if len(n_native) < 8 or not all(n_native):
                raise AssertionError(f"{name} stage N: nested rows' native evaluations {n_native}")
            for (q, d, sc), ex in zip(picks, e_res):
                if not ex.match or abs(ex.value - sc) > RTOL * max(1.0, abs(sc)):
                    raise AssertionError(f"{name}: explain of {type(q).__name__} at doc {d} gave "
                                         f"{ex.value}, search {sc}")
            for (s, _h), a, b in zip(e_rows, got_p, got_h):
                if a != b or a.total_hits <= 0:
                    raise AssertionError(f"{name}: {s!r} served {a.total_hits} hits unlike its "
                                         "hand-built query")
            fig.update({
                "sorted_qps": len(s_rows) / s_sec, "collapse_qps": len(c_rows) / c_sec,
                "span_qps": len(n_rows) / n_sec, "rescore_ms_row": 1e3 * r_sec / len(r_rows),
                "explain_ms_call": 1e3 * e_sec / len(picks),
                "sorted_kernel_ms_busy": list(s_prof[:2]), "span_kernel_ms_busy": list(n_prof[:2]),
                "combine_entries": {"S": s_ent, "C": c_ent, "R": r_ent},
                "span_host_spill": n_cnt.get("search.span_host_spill", 0),
                "launches": {k: sum(c.get(v, 0) for c in (s_cnt, c_cnt, n_cnt, r_cnt))
                             for k, v in kernel_counters.items()},
            })
            for k, v in fig["launches"].items():
                out["launches"][k] += v
            out[name] = fig
            results[name] = (s_res, c_res, n_res, r_res, got_p)
            log(f"{name} query surface on {card}: sorted {fig['sorted_qps']:.1f} QPS ({len(s_rows)} "
                f"rows, 4 on the host), collapse {fig['collapse_qps']:.1f} QPS, spans and synonyms "
                f"{fig['span_qps']:.1f} QPS ({len(n_rows)} rows, routes {got_routes}, "
                f"span_host_spill {fig['span_host_spill']}, {sum(n_native)} native span "
                f"evaluations), rescore {fig['rescore_ms_row']:.2f} ms a row, explain "
                f"{fig['explain_ms_call']:.2f} ms a call; combine entries {fig['combine_entries']}; "
                f"launches {fig['launches']}; sorted pass {s_prof[0]:.2f} ms of kernels, busy "
                f"{100 * s_prof[1]:.1f}%; span pass {n_prof[0]:.2f} ms, busy {100 * n_prof[1]:.1f}%; "
                f"{fig['span_planes']} span planes built ({fig['span_plane_mib']:.1f} MiB); peak "
                f"{fig['peak_gib']:.2f} GiB")
    finally:
        executor.combine_lanes, span_native.eval_spans = real_combine, real_eval

    dec, pkd = results["decoded"], results["packed"]
    for i, (a, b) in enumerate(zip(dec[0], pkd[0])):
        if not field_docs_equal(b, a):
            raise AssertionError(f"packed sorted row {i} differs from the decoded run")
    for st_name, a_list, b_list in zip("CNRE", dec[1:], pkd[1:]):
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            if a != b:
                raise AssertionError(f"packed stage {st_name} row {i} differs from the decoded run")
    log("packed answers equal the decoded ones bit for bit (S, C, N, R and the parsed rows)")

    t0 = time.perf_counter()
    for i in (0, 9, 32, 41, 64, 70, 72, 75):
        q, srt = s_rows[i]
        if not field_docs_equal(dec[0][i], cpu_searcher.search_sorted(q, K, srt), exact=False):
            raise AssertionError(f"sorted row {i} differs from the CPU run")
    for i in (0, 7, 16, 31, 32, 35, 38, 39):
        want = cpu_searcher.search_collapse(c_rows[i], K, "grp")
        if [d for d, _ in dec[1][i].score_docs] != [d for d, _ in want.score_docs]:
            raise AssertionError(f"collapse row {i}: best docs differ from the CPU run")
        assert_topdocs_strict(dec[1][i], want)
    n_idx = (0, 31, 32, 63, 64, 80, 88, 96)
    for i, want in zip(n_idx, cpu_searcher.search_batch([n_rows[i] for i in n_idx], k=K)):
        assert_topdocs_strict(dec[2][i], want)
    r_idx = (0, 5, 12, 23, 24, 27, 29, 31)
    firsts = cpu_searcher.search_batch([r_rows[i][0] for i in r_idx], k=K)
    for i, first in zip(r_idx, firsts):
        want = QueryRescorer(r_rows[i][1], rescore_weight=2.0).rescore(cpu_searcher, first, top_n=50)
        assert_topdocs_strict(dec[3][i], want)
    e_idx = (0, 1, 2, 3, 4, 6, 7, 8)
    for i, want in zip(e_idx, cpu_searcher.search_batch(
            [parse_query_string(e_rows[i][0], "body") for i in e_idx], k=K)):
        assert_topdocs_strict(dec[4][i], want)
    log(f"8 rows of each of S, C, N, R and E match the CPU run ({time.perf_counter() - t0:.1f}s)")
    return out


# --- phase 14: sharded search (parallel/sharded.py, BASELINE.json config 5) -

SHARDS = 4  # the graft's mesh of 4 shards (__graft_entry__.py:300-303)
SHARD_SEED = 31


def sharded_queries(phrase_texts, vocab, probs, seed: int = SHARD_SEED):
    """Phase 14's rows beside the bench mix: the sharded rows of
    __graft_entry__.py:308-330 at the bench's widths, and rows the shard
    program leaves to the fallback. Returns (rows, planned route counts).
    16 boolean MUST + SHOULD rows over the bench's band (ranks 10-5000); 8
    exact bigrams from phrase_texts, 4 sloppy ones (the pair reversed,
    slop 2) and 4 ordered slop-0 SpanNearQuery rows (a phrase row through
    device_equivalent); 8 ``ts`` windows of 1-30 days alone and 8 band
    terms MUST beside a window MUST; then the fallback rows: 4 two-term
    DisjunctionMax rows, 2 unordered SpanNearQuery rows (slop 4) and 2
    exact bigrams MUST beside a band term SHOULD."""
    from rucene_tpu_torch import (
        BooleanQuery,
        DisjunctionMaxQuery,
        PhraseQuery,
        PointRangeQuery,
        Term,
        TermQuery,
    )
    from rucene_tpu_torch.search.spans import SpanNearQuery, SpanTermQuery

    rng = np.random.default_rng(seed)
    term = band_sampler(vocab, probs, rng)
    bigrams = sample_bigrams(phrase_texts, 32, seed=seed)

    def t(w):
        return TermQuery(Term("body", w))

    def window():
        lo = int(rng.integers(0, YEAR_S - 30 * 86400))
        return PointRangeQuery("ts", lo, lo + int(rng.integers(1, 31)) * 86400 - 1)

    def span(a, b, slop, in_order):
        return SpanNearQuery([SpanTermQuery(Term("body", a)), SpanTermQuery(Term("body", b))],
                             slop=slop, in_order=in_order)

    rows = [BooleanQuery().must(t(term())).should(t(term())) for _ in range(16)]
    rows += [PhraseQuery("body", list(bigrams[i])) for i in range(8)]
    rows += [PhraseQuery("body", [bigrams[i][1], bigrams[i][0]], slop=2) for i in range(8, 12)]
    rows += [span(*bigrams[i], 0, True) for i in range(12, 16)]
    rows += [window() for _ in range(8)]
    rows += [BooleanQuery().must(t(term())).must(window()) for _ in range(8)]
    rows += [DisjunctionMaxQuery([t(term()), t(term())], tie_breaker=0.3) for _ in range(4)]
    rows += [span(*bigrams[i], 4, False) for i in range(16, 18)]
    rows += [BooleanQuery().must(PhraseQuery("body", list(bigrams[i]))).should(t(term()))
             for i in range(18, 20)]
    return rows, {"route.mesh": 32, "route.mesh_phrase": 16, "route.mesh_fallback": 8}


def serve_sharded_sync(ss, queries, min_s: float = 4.0, max_reps: int = 6):
    """(QPS, last pass's TopDocs) of passes over ``queries`` in batches of
    BATCH through ShardedSearcher.search_batch."""
    t0 = time.perf_counter()
    reps = 0
    results = []
    while reps < 2 or (time.perf_counter() - t0 < min_s and reps < max_reps):
        results = []
        for i in range(0, len(queries), BATCH):
            results.extend(ss.search_batch(queries[i:i + BATCH], k=K))
        reps += 1
    torch.cuda.synchronize()
    return reps * len(queries) / (time.perf_counter() - t0), results


def shard_kernel_replay(index, searcher, dense_q, dev) -> dict:
    """K1, K2 and K3 at a shard's shapes against their plain twins on the
    card: K1 over every block of shard 0's split view (its re-packed
    straddling blocks included), bit for bit; K2 (on a packed index) over
    the distinct blocks of the head-band rows ``dense_q`` on shard 0, bit
    for bit; K3 over the same rows' combine call on shard 0's view, bit for
    bit. Times each against its twin."""
    from rucene_tpu_torch.codec.device import build_device_segment
    from rucene_tpu_torch.index.combined import build_combined_tables
    from rucene_tpu_torch.ops import cuda_combine, cuda_decode
    from rucene_tpu_torch.search import executor, flat_tables

    view, group = index.views[0], index.groups[0]
    sp = group[0].packed
    out: dict = {"shard_docs": int(sp.max_doc), "shard_blocks": int(view.n_blocks)}
    seg = build_device_segment(sp, dev)
    tables = (seg.data, seg.blk_off, seg.blk_doc_bits, seg.blk_freq_bits, seg.blk_base, seg.blk_count)
    got = cuda_decode.decode_blocks(*tables, torch.int16)
    want = cuda_decode.decode_blocks_plain(*tables, freq_dtype=torch.int16)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError("the decode kernel differs from its twin at a shard's shapes")
    out["decode_blocks"] = {
        "blocks": int(sp.num_blocks),
        # straddling blocks re-packed past the segment's own words
        "repacked": int((sp.blk_off >= len(searcher.reader.leaves[0].packed.data)).sum()),
        "ms": cuda_ms(cuda_decode.decode_blocks, (*tables, torch.int16), reps=8, copies=2),
        "plain_ms": cuda_ms(cuda_decode.decode_blocks_plain, (*tables, torch.int16), reps=2, copies=1),
    }
    del seg, tables, got, want
    rqs = [searcher._plan_for(q).rq for q in dense_q]
    doc_freqs, stats = searcher._gather_stats(rqs)
    b = len(rqs)
    weight, occur, n_req, min_sh, _ma, _bo = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, 2
    )
    bs, bc, fid = build_combined_tables(view, group, rqs, b, 2)
    work = flat_tables.build_flat_work(bs, bc, weight, fid, occur)[:6]
    gdev = view.device
    if not executor.dense_strategy(b, gdev.max_doc_padded, len(work[0])):
        raise AssertionError("the head-band rows are not in the dense regime on a shard")
    cache = np.zeros((max(len(index.field_gid), 1), 256), np.float32)
    for name, g in index.field_gid.items():
        cache[g] = searcher.similarity.cache_row(stats.get(name) if name in sp.norms else None)
    q = flat_tables.make_flat_batch(work, n_req, min_sh, cache, gdev, dedupe=True)
    if gdev.docs_dec is None:
        ub, uf = q.wi_ublock.long(), q.wi_ufid
        k2_args = (gdev.data, gdev.blk_off[ub], gdev.blk_doc_bits[ub], gdev.blk_freq_bits[ub],
                   gdev.blk_base[ub], gdev.blk_count[ub], uf, q.cache)
        got = cuda_decode.decode_score_blocks(*k2_args)
        want = cuda_decode.decode_score_blocks_plain(*k2_args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError("the scoring decode kernel differs from its twin on a shard")
        out["decode_score_blocks"] = {
            "blocks": int(ub.numel()), "ms": cuda_ms(cuda_decode.decode_score_blocks, k2_args),
            "plain_ms": cuda_ms(cuda_decode.decode_score_blocks_plain, k2_args, reps=5, copies=1),
            "max_abs_err": 0,
        }
    cb = flat_tables.build_combine_batch(
        work, b, view.blk_first_host, view.blk_last_host, gdev.max_doc_padded, dev,
        q=q, buckets=gdev.buckets,
    )[0]
    target, sc, _valid = executor.decode_score_lanes(gdev, q)
    shape = (b, gdev.max_doc_padded)
    args = (cb.bucket_ptr, target, sc, cb.e_item, cb.e_row, cb.e_enc)
    out_k = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))
    out_p = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))
    cuda_combine.combine_lanes(*args, *out_k)
    cuda_combine.combine_lanes_plain(*args, *out_p)
    err = k3_bit_equal(out_k, out_p, "at a shard's shapes")
    out["combine_lanes"] = {
        "entries": int(cb.e_item.numel()), "rows": b, "max_doc_padded": int(gdev.max_doc_padded),
        "max_abs_err": err, "ms": cuda_ms(cuda_combine.combine_lanes, (*args, *out_k)),
        "plain_ms": cuda_ms(cuda_combine.combine_lanes_plain, (*args, *out_p), reps=2, copies=1),
    }
    return out


def serve_sharded(searchers, cpu_searcher, mix, mix_answers, dense_q, graft, card, dev, sum_q):
    """Phase 14: the sharded path (parallel/sharded.py; BASELINE.json
    config 5's segment-sharded index, on one card) on both readers. Per
    reader (``searchers``: the decoded and the packed one-reader searchers
    of phases 3-9): a ShardedIndex over its reader on make_mesh(4, 1) (one
    card: cuda:0 four times; more cards: one shard a card, up to 4), whose
    one segment _split_hot_leaves splits by doc range into 4 shards, each
    a combined view of its own (the packed one built with
    RUCENE_DECODED=0); then the bench mix (512 queries, batch 256, k=100),
    the rows of sharded_queries and the 32 head-band rows ``dense_q``
    through ShardedSearcher.search_batch, stage S's many-word rows
    (``sum_q``, sum_order_queries) SUM_REPEATS times at each k of SUM_KS,
    timed passes of the mix, and a profiled pass. Counts are set to 0 just
    before the index is built and read after the last batch.

    Gates (each raises): every TopDocs of the mix equals the one-reader
    answers of phases 4-8 (``mix_answers``) and every other row the
    one-reader searcher's, under tests/torch_hitcheck.py (rows of at most
    two scoring clauses); stage S's rows bit-equal run to run and all on
    route.mesh; 8 mix rows and 12 sharded rows equal the CPU run;
    the route counters as planned (the mix's 448 term rows on route.mesh
    and 64 phrase rows on route.mesh_phrase a pass, the sharded rows'
    32 / 16 / 8); K1 launched once a shard by the decoded index's build
    and never in its serving, K2 never on the decoded index and in the
    packed one's serving, K3 on both; on the packed index no plain decode
    twin runs. Then shard_kernel_replay holds the three kernels at a
    shard's shapes. Returns the phase's figures and launches."""
    from rucene_tpu_torch.ops import cuda_decode
    from rucene_tpu_torch.parallel.sharded import ShardedIndex, ShardedSearcher, make_mesh
    from rucene_tpu_torch.util.metrics import METRICS
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import assert_topdocs_strict  # numpy-only test helper

    n_cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i % n_cards) if n_cards > 1 else dev for i in range(SHARDS)]
    rows, planned = graft
    n_phrase = sum(type(q).__name__ == "PhraseQuery" for q in mix)
    figures: dict = {"shards": SHARDS, "devices": [str(d) for d in devices]}
    launches = dict.fromkeys(launch_counters(), 0)
    cpu_idx = list(range(0, len(mix), len(mix) // 8))[:8]
    cpu_mix = cpu_searcher.search_batch([mix[i] for i in cpu_idx], k=K)
    row_idx = [0, 1, 2, 3, 16, 17, 24, 28, 32, 40, 48, 54]  # every kind but the span fallback
    cpu_rows = cpu_searcher.search_batch([rows[i] for i in row_idx], k=K)

    def delta(before):
        return counter_delta(METRICS.snapshot()["counters"], before)

    for kind, searcher in searchers.items():
        one_rows = searcher.search_batch(rows, k=K)
        one_dense = searcher.search_batch(dense_q, k=K)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prev = os.environ.get("RUCENE_DECODED")
        refuse = plain_decode_refused if kind == "packed" else contextlib.nullcontext
        METRICS.reset()  # the phase's counts, for this reader
        with refuse():
            if kind == "packed":
                os.environ["RUCENE_DECODED"] = "0"
            try:
                t = time.perf_counter()
                index = ShardedIndex(make_mesh(SHARDS, 1, devices=devices), searcher.reader)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t
            finally:
                if prev is None:
                    os.environ.pop("RUCENE_DECODED", None)
                else:
                    os.environ["RUCENE_DECODED"] = prev
            k1_build = METRICS.snapshot()["counters"].get(cuda_decode.LAUNCH_COUNTER, 0)
            ss = ShardedSearcher(index, searcher.similarity)
            for i in range(0, len(mix), BATCH):  # warm pass
                ss.search_batch(mix[i:i + BATCH], k=K)
            before = METRICS.snapshot()["counters"]
            qps, got = serve_sharded_sync(ss, mix)
            mix_routes = delta(before)
            before = METRICS.snapshot()["counters"]
            got_rows = ss.search_batch(rows, k=K)
            row_routes = delta(before)
            before = METRICS.snapshot()["counters"]
            got_dense = ss.search_batch(dense_q, k=K)
            dense_routes = delta(before)
            before = METRICS.snapshot()["counters"]
            t = time.perf_counter()
            served_identically(lambda r, k: ss.search_batch(r, k=k), sum_q,
                               f"phase 14 S, {kind} shards")
            sum_s = time.perf_counter() - t
            sum_routes = delta(before)
            torch.cuda.synchronize()
        counters = METRICS.snapshot()["counters"]  # the path ends here
        peak = torch.cuda.max_memory_allocated() / 2**30
        moved = launches_in(counters)
        for name in launches:
            launches[name] += moved[name]
        passes = mix_routes.get("route.mesh_phrase", 0) // max(n_phrase, 1)
        route_of = lambda c: {r: c.get(r, 0) for r in planned}  # noqa: E731
        want_mix = {"route.mesh": (len(mix) - n_phrase) * passes,
                    "route.mesh_phrase": n_phrase * passes, "route.mesh_fallback": 0}
        if passes < 2 or route_of(mix_routes) != want_mix:
            raise AssertionError(f"{kind} sharded mix routes {route_of(mix_routes)} != {want_mix}")
        if route_of(row_routes) != planned:
            raise AssertionError(f"{kind} sharded rows' routes {route_of(row_routes)} != {planned}")
        if dense_routes.get("route.mesh", 0) != len(dense_q):
            raise AssertionError(f"{kind} head-band rows' routes {route_of(dense_routes)}")
        n_sum = len(SUM_KS) * SUM_REPEATS * sum(len(r) for r in sum_q.values())
        if sum_routes.get("route.mesh", 0) != n_sum:
            raise AssertionError(f"{kind} stage S rows' routes {route_of(sum_routes)}, "
                                 f"expected {n_sum} on route.mesh")
        if kind == "decoded":
            if k1_build != SHARDS or moved["decode_blocks"] != SHARDS:
                raise AssertionError(f"decoded shards: K1 {k1_build} at the build, "
                                     f"{moved['decode_blocks']} in all, not once a shard")
            if moved["decode_score_blocks"]:
                raise AssertionError("K2 launched on the decoded shards")
        elif k1_build or moved["decode_score_blocks"] <= 0:
            raise AssertionError(f"packed shards: K1 at the build {k1_build}, K2 "
                                 f"{moved['decode_score_blocks']}")
        if moved["combine_lanes"] <= 0:
            raise AssertionError(f"K3 never launched on the {kind} shards")
        for name, g_all, w_all in (("mix", got, mix_answers[kind]), ("sharded rows", got_rows, one_rows),
                                   ("head-band rows", got_dense, one_dense)):
            for i, (g, w) in enumerate(zip(g_all, w_all)):
                try:
                    assert_topdocs_strict(g, w)
                except AssertionError as e:
                    raise AssertionError(f"{kind} sharded {name} row {i}: {e}") from None
        for i, w in zip(cpu_idx, cpu_mix):
            assert_topdocs_strict(got[i], w)
        for i, w in zip(row_idx, cpu_rows):
            assert_topdocs_strict(got_rows[i], w)

        def one_pass():
            for i in range(0, len(mix), BATCH):
                ss.search_batch(mix[i:i + BATCH], k=K)

        with refuse():
            ms, busy, top = profile_fn(one_pass, passes=2, top=8)
        figures[kind] = {
            "qps": qps, "build_s": build_s, "shard_build_s": index.build_s,
            "shard_docs": [sum(lf.max_doc for lf in g) for g in index.groups],
            "shard_blocks": [v.n_blocks for v in index.views], "kernel_ms_busy": [ms, busy],
            "sum_order_s": sum_s,
            "top_kernels": top, "peak_gib": peak, "launches": moved,
            "routes": {r: counters.get(r, 0) for r in ("route.mesh", "route.mesh_phrase",
                                                        "route.mesh_fallback")},
        }
        log(f"phase 14, {kind}: ShardedIndex over {SHARDS} shards on {', '.join(map(str, devices))} "
            f"built in {build_s:.2f}s (a shard: {', '.join(f'{s:.2f}' for s in index.build_s)}s; "
            f"{figures[kind]['shard_docs']} docs, {figures[kind]['shard_blocks']} blocks); mix "
            f"{qps:.1f} QPS ({len(mix)} queries, batch {BATCH}, k={K}) on {card}; kernels "
            f"{ms:.1f} ms a pass, busy {busy:.1%}; peak {peak:.2f} GiB; launches {moved}; routes "
            f"{figures[kind]['routes']}; every row equals the one-reader answers, 20 the CPU run; "
            f"stage S's {sum(len(r) for r in sum_q.values())} many-word rows served "
            f"{SUM_REPEATS} times at k = {', '.join(map(str, SUM_KS))}, every run bit-equal to "
            f"the first ({sum_s:.1f}s); "
            "top kernels (ms a pass): " + "; ".join(f"{n} {v:.2f}" for n, v in top))
        figures[f"{kind}_replay"] = shard_kernel_replay(index, searcher, dense_q, dev)
        del index, ss, got, got_rows, got_dense
    log("phase 14 kernels at a shard's shapes: " + json.dumps(
        {k: figures[k] for k in ("decoded_replay", "packed_replay")}))
    return figures, launches


# --- phase 15: the port's entry points (rucene_tpu_torch/drivers, examples) --

DRIVER_NRT_DOCS = 20_000  # drivers.bench --nrt's base docs
DRIVER_NRT_SECONDS = 5.0
DRIVER_TIMEOUT_S = 300  # each subprocess
K_NAMES = {  # each kernel's name in a torch.profiler trace
    "decode_blocks": "decode_blocks_kernel",
    "decode_score_blocks": "decode_score_blocks_kernel",
    "combine_lanes": "combine_lanes_kernel",
}


def run_module(args, where: str) -> tuple[str, str]:
    """(stdout, stderr) of ``python -m <args>`` from this checkout; a
    non-zero exit or a run past DRIVER_TIMEOUT_S raises."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", *args], cwd=root, capture_output=True,
                          text=True, timeout=DRIVER_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"{where} failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    return proc.stdout, proc.stderr


def serve_drivers(searchers, mix, mix_answers, dense_q, card) -> tuple[dict, dict]:
    """Phase 15: the port's own entry points, on the 1M-doc readers of
    phases 3-9 (``searchers``: decoded, packed; the packed one with the
    plain decode twins refused), after phase 14:
      A. drivers.bench.serve_mix, the bench's serving loop, over the whole
         mix on each reader (counts set to 0 just before, read just
         after): every TopDocs equal to phase 4's (decoded) or phase 8's
         (packed) last pass under tests/torch_hitcheck.py; its QPS and
         batch latency p50 / p99;
      B. both examples (rucene_tpu_torch.examples) as subprocesses on the
         card and with --device cpu: examples.stable_lines of the two runs
         equal;
      C. ``python -m rucene_tpu_torch.drivers.bench --nrt`` on the card at
         DRIVER_NRT_DOCS base docs for DRIVER_NRT_SECONDS: its JSON line
         has bench.py's keys and a QPS above 0, and it ingested docs;
      D. drivers.profile_bench.capture of 2 batches on the packed reader
         (the mix's first batch, then the head-band rows), analysed from
         the trace file: the batch's host spans appear as often as
         util/metrics counted them, and K1, K2 and K3 appear by name.
    Returns (figures, launches of A and D)."""
    import tempfile

    from rucene_tpu_torch.drivers import bench as drv_bench
    from rucene_tpu_torch.drivers import profile_bench
    from rucene_tpu_torch.examples import stable_lines
    from rucene_tpu_torch.util.metrics import METRICS
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import assert_topdocs_strict  # numpy-only test helper

    counter_of = launch_counters()
    launches = dict.fromkeys(counter_of, 0)

    def count_launches():
        c = METRICS.snapshot()["counters"]
        for name, key in counter_of.items():
            launches[name] += c.get(key, 0)

    figures: dict = {}
    # A. the bench's serving loop on both readers
    for kind, searcher in searchers.items():
        refuse = plain_decode_refused if kind == "packed" else contextlib.nullcontext
        METRICS.reset()
        with refuse():
            served = drv_bench.serve_mix(searcher, mix, BATCH, K)
        count_launches()
        for i, (g, w) in enumerate(zip(served.results, mix_answers[kind])):
            try:
                assert_topdocs_strict(g, w)
            except AssertionError as e:
                raise AssertionError(f"phase 15 serve_mix, {kind} row {i}: {e}") from None
        p50, p99 = np.percentile(served.batch_ms, [50, 99])
        figures[f"{kind}_serve_mix"] = {"qps": served.qps, "reps": served.reps,
                                        "batch_ms_p50": float(p50), "batch_ms_p99": float(p99)}
        log(f"phase 15, {kind}: drivers.bench.serve_mix {served.qps:.1f} QPS over {served.reps} "
            f"passes on {card}, {drv_bench.latency_line(served.batch_ms)}; all {len(mix)} rows "
            f"equal phase {4 if kind == 'decoded' else 8}'s")

    # B. the examples, on the card and on the CPU
    for name in ("example", "nrt_search"):
        t = time.perf_counter()
        on_card, _ = run_module([f"rucene_tpu_torch.examples.{name}"], f"examples.{name} on the card")
        card_s = time.perf_counter() - t
        on_cpu, _ = run_module([f"rucene_tpu_torch.examples.{name}", "--device", "cpu"],
                               f"examples.{name} on the CPU")
        want, got = stable_lines(on_cpu), stable_lines(on_card)
        if got != want:
            raise AssertionError(f"examples.{name}: the card printed {got}, the CPU {want}")
        figures[f"example_{name}_s"] = card_s
        log(f"phase 15: examples.{name} on the card in {card_s:.1f}s prints the CPU run's "
            f"{len(got)} lines")

    # C. the NRT bench
    stdout, stderr = run_module(["rucene_tpu_torch.drivers.bench", "--nrt", "--docs",
                                 str(DRIVER_NRT_DOCS), "--seconds", str(DRIVER_NRT_SECONDS)],
                                "drivers.bench --nrt")
    line = json.loads(stdout.strip().splitlines()[-1])
    if set(line) != {"metric", "value", "unit", "vs_baseline"} or not line["value"] > 0:
        raise AssertionError(f"drivers.bench --nrt printed {line}")
    ingest = [ln for ln in stderr.splitlines() if ln.startswith("# nrt: ingested")]
    if not ingest or ingest[-1].split()[3] == "0":
        raise AssertionError(f"drivers.bench --nrt ingested nothing: {ingest}")
    figures["nrt_bench"] = {"qps": line["value"], "log": ingest[-1]}
    log(f"phase 15: drivers.bench --nrt ({DRIVER_NRT_DOCS} base docs, {DRIVER_NRT_SECONDS}s): "
        f"{line['value']} QPS on {card}; {ingest[-1][2:]}")

    # D. a profile of two batches on the packed reader
    packed = searchers["packed"]
    batches = [mix[:BATCH], dense_q]
    with tempfile.TemporaryDirectory(prefix="rtpu_prof_") as tmp, plain_decode_refused():
        for b in batches:  # capture's warm pass, counted outside the capture
            packed.search_batch(b, k=K)
        METRICS.reset()
        path = profile_bench.capture(tmp, packed, batches, K, warm=0)
        count_launches()
        timers = METRICS.snapshot()["timers"]
        trace_mb = os.path.getsize(path) / 2**20
        prof = profile_bench.analyze(path)
    want_spans = {n: t["count"] for n, t in timers.items() if n != "search.batch"}
    got_spans = {n: c for n, (_ms, c) in prof["spans"].items() if n.startswith("search.")}
    if got_spans != want_spans or "search.phrases" not in got_spans:
        raise AssertionError(f"profile spans {got_spans} != the timers' {want_spans}")
    names = " ".join(n for n, _ms, _c in prof["ops"])  # every device op, ranked
    missing = [k for k, v in K_NAMES.items() if v not in names]
    if missing:
        raise AssertionError(f"the profile's top kernels lack {missing}: {names[:2000]}")
    figures["profile"] = {"busy": prof["busy"], "span_ms": prof["span_ms"], "trace_mib": trace_mb,
                          "spans": prof["spans"], "top": prof["ops"][:8]}
    log(f"phase 15: profile_bench capture of 2 packed batches ({trace_mb:.1f} MiB trace): device "
        f"busy {prof['busy']:.1%} of {prof['span_ms']:.1f} ms; spans {got_spans}; K1, K2 and K3 "
        "among the top kernels")
    return figures, launches


# --- phase 16: block-max pruning (ops/topk.exact_top_k, search_batch(prune=)) --

PRUNE_SEED = 37  # phase 16's WAND rows
TOPK_KS = (10, 100, 1000)
WAND_KS = (10, 32)
WIDE_K = 1000  # the exhaustive answer the 3-term pruned rows are held to
AUTO_MIN_DOCS = 524_288  # RUCENE_PRUNE_AUTO_MIN_DOCS for the auto stage
HOT_DOCS = 200_000  # stage F's corpus
HOT_IMPACT = 50  # one doc in HOT_IMPACT repeats a cold word 6 times
TOPK_MARKS = ("topk", "kthvalue", "kthcounts", "withinkcounts")  # radix-select kernels


def wand_queries(vocab, probs, terms: int, n: int = BATCH, seed: int = PRUNE_SEED):
    """Pure-OR rows of ``terms`` distinct terms from the bench's band
    (ranks 10-5000, Zipf-weighted), drawn from ``seed``."""
    from rucene_tpu_torch import BooleanQuery, Term, TermQuery

    rng = np.random.default_rng(seed)
    draw = band_sampler(vocab, probs, rng)
    out = []
    for _ in range(n):
        words: list = []
        while len(words) < terms:
            w = draw()
            if w not in words:
                words.append(w)
        q = BooleanQuery()
        for w in words:
            q.should(TermQuery(Term("body", w)))
        out.append(q)
    return out


def hot_cold_texts(n: int = HOT_DOCS, seed: int = 42):
    """tests/test_combined_view.py:76's skewed corpus at ``n`` docs of 12
    words ("hot" at weight 400 against 300 cold words at 1), with one doc
    in HOT_IMPACT whose first 6 words are one cold word: the block maxima
    then vary, as WAND needs (on the corpus alone no deferred block falls
    below the threshold)."""
    rng = np.random.default_rng(seed)
    words = ["hot"] + [f"cold{i}" for i in range(300)]
    probs = np.ones(len(words))
    probs[0] = 400
    probs /= probs.sum()
    widx = rng.choice(len(words), size=(n, 12), p=probs)
    impact = rng.random(n) < 1.0 / HOT_IMPACT
    widx[impact, :6] = rng.integers(1, len(words), int(impact.sum()))[:, None]
    return [" ".join(words[j] for j in row) for row in widx]


def dense_topk_rows(searcher, rows) -> torch.Tensor:
    """The f32 [B, md] rows the executors hand topk_score_doc while
    ``searcher`` serves ``rows`` (the dense branch, or the tf-plane
    route's dense math), concatenated."""
    from rucene_tpu_torch.search import executor

    md = searcher.reader.leaves[0].device.max_doc_padded
    seen = []
    orig = executor.topk_score_doc

    def spy(scores, k):
        if scores.dim() == 2 and scores.shape[1] == md and scores.dtype == torch.float32:
            seen.append(scores.clone())
        return orig(scores, k)

    executor.topk_score_doc = spy
    try:
        searcher.search_batch(rows, k=K)
    finally:
        executor.topk_score_doc = orig
    if not seen:
        raise AssertionError("no dense row reached topk_score_doc")
    return torch.cat(seen)


def serve_pruning(searchers, mix, mix_answers, dense_q, vocab, probs, card, dev, cpu_searcher,
                  sum_q, hot_docs: int = HOT_DOCS) -> tuple[dict, dict]:
    """Phase 16, block-max pruning, on the 1M-doc readers of phases 3-9
    (``searchers``: decoded, packed; the packed one with the plain decode
    twins refused), after phase 15:
      T. top-k: the [B, md] f32 rows the executors pass to topk_score_doc
         for phase 9's head-band batch (plane rows on the decoded reader,
         the dense branch on the packed one; real BM25 rows with ties),
         tiled to 256 rows: exact_top_k (the chunk pass, which must
         engage) bit-equal to stable_top_k at k = 10, 100 and 1,000, both
         timed with cuda_ms beside one torch.topk over the raw rows and
         the bound, one read of the rows; then one torch.profiler pass of
         the bench mix with the chunk pass and one with stable_top_k patched in
         on each reader: kernel ms a pass, the radix-select kernels' ms
         (TOPK_MARKS) and busy, every TopDocs equal to phase 4's or 8's.
      W. WAND on the 1M-doc corpus: 256 pure-OR rows of 3 band terms
         (seed PRUNE_SEED) on both readers, and 256 of 2 terms on the
         packed one, at k = 10 and 32, served with prune=False and
         prune=True (drivers.bench.serve_mix): hits equal under
         tests/torch_hitcheck.py (assert_pruned_strict for the 2-term
         rows; a 3-term row's two runs may take different routes or
         strategies (tf planes exhaustively and the flat executor
         pruned on the decoded reader, the dense branch at WIDE_K), whose
         sums may differ where a residue item lands, so the 3-term rows
         are held by assert_truncated_within_rtol to their exhaustive
         answer at k=WIDE_K; the rows that pass assert_pruned_strict
         against the exhaustive run at k are counted, and the rows that
         cross the k-th hit logged with each crossing doc's scores),
         pruned total_hits never above the exhaustive; QPS both ways,
         search.pruned_blocks, search.prune_rerun_rows and the busy
         share of a pruned pass. Then
         prune=None with RUCENE_PRUNE_AUTO_MIN_DOCS=524288:
         search.auto_prune_batches > 0 on the 3-term rows at k=10 and 0 on
         the bench mix at k=100.
      F. pruning that fires: hot_cold_texts at ``hot_docs`` docs, written
         by the port's IndexWriter into 4 segments, served per leaf and
         through the combined view on the card at k = 1 and 5:
         search.pruned_blocks > 0 each way, hits equal to prune=False's.
      S. the summation rule, before F (serve_sum_order): the rows of
         ``sum_q`` served three times at k = 10, 100 and 1,000 on both
         readers and a combined view, every run bit-equal to the first;
         K3 bit-equal to its twin on a many-word call; 64 packed rows
         bit-equal to a packed CPU reader's answers (``cpu_searcher``'s
         decoded answers beside them are counted, not held).
    Each stage runs with its counts set to 0 just before and read just
    after. Returns ({"topk": ..., "pruning": ...}, launches)."""
    from rucene_tpu_torch import IndexSearcher, IndexWriter, IndexWriterConfig
    from rucene_tpu_torch import Document, RAMDirectory, TextField
    from rucene_tpu_torch.ops import topk
    from rucene_tpu_torch.util.metrics import METRICS
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import (
        assert_pruned_strict,
        assert_topdocs_strict,
        assert_truncated_within_rtol,
    )

    counter_of = launch_counters()
    launches = dict.fromkeys(counter_of, 0)

    def count_launches():
        c = METRICS.snapshot()["counters"]
        for name, key in counter_of.items():
            launches[name] += c.get(key, 0)

    def refuse(kind):
        return plain_decode_refused() if kind == "packed" else contextlib.nullcontext()

    @contextlib.contextmanager
    def env(name, value):
        prev = os.environ.get(name)
        os.environ[name] = value
        try:
            yield
        finally:
            if prev is None:
                os.environ.pop(name)
            else:
                os.environ[name] = prev

    @contextlib.contextmanager
    def top_k_by(way):
        """Every dense top-k (topk_score_doc) through the chunk pass, or
        through stable_top_k over the whole row for the A/B."""
        orig = topk.exact_top_k
        if way == "stable":
            topk.exact_top_k = topk.stable_top_k
        try:
            yield
        finally:
            topk.exact_top_k = orig

    topk_fig: dict = {}
    # T. the top-k over real dense rows, then the mix both ways
    for kind, searcher in searchers.items():
        METRICS.reset()
        with refuse(kind):
            rows = dense_topk_rows(searcher, dense_q)
        count_launches()
        b0, md = rows.shape
        rows = rows.repeat((BATCH + b0 - 1) // b0, 1)[:BATCH].contiguous()
        bound = bound_ms(rows.numel() * 4)
        per_k = {}
        for k in TOPK_KS:
            if not topk.chunk_pass_engages(md, k):
                raise AssertionError(f"phase 16: the chunk pass does not engage at [{BATCH}, {md}] "
                                     f"k={k}")
            got, want = topk.exact_top_k(rows, k), topk.stable_top_k(rows, k)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"phase 16, {kind}: exact_top_k differs from stable_top_k "
                                     f"at k={k}")
            ms = cuda_ms(topk.exact_top_k, (rows, k), reps=10, copies=2)
            stable_ms = cuda_ms(topk.stable_top_k, (rows, k), reps=10, copies=2)
            lib_ms = cuda_ms(torch.topk, (rows, k), reps=10, copies=2)
            per_k[str(k)] = {"ms": ms, "stable_ms": stable_ms, "torch_topk_ms": lib_ms}
            log(f"phase 16 T, {kind}: top-{k} of [{BATCH}, {md}] f32 rows ({b0} head-band rows "
                f"tiled): chunk pass {ms:.4f} ms, stable_top_k {stable_ms:.4f} ms, one torch.topk "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms (one read of the rows); bit-equal")
        del rows, got, want
        passes = {}
        for way in ("chunk", "stable"):
            results: list = [None] * len(mix)

            def one_pass(searcher=searcher, results=results):
                pending = []
                for i in range(0, len(mix), BATCH):
                    pending.append((i, searcher.search_batch_async(mix[i:i + BATCH], k=K)))
                    while len(pending) >= 3:
                        j, collect = pending.pop(0)
                        results[j:j + BATCH] = collect()
                while pending:
                    j, collect = pending.pop(0)
                    results[j:j + BATCH] = collect()

            METRICS.reset()
            with top_k_by(way), refuse(kind):
                one_pass()  # warm
                kernel_ms, busy, ranked = profile_fn(one_pass, 1, 1000)
            count_launches()
            for i, (g, w) in enumerate(zip(results, mix_answers[kind])):
                try:
                    assert_topdocs_strict(g, w)
                except AssertionError as e:
                    raise AssertionError(f"phase 16 T, {kind} top-k by {way}, row {i}: "
                                         f"{e}") from None
            select_ms = sum(ms for name, ms in ranked
                            if any(m in name.lower() for m in TOPK_MARKS))
            passes[way] = {
                "kernel_ms": kernel_ms, "busy": busy, "radix_select_ms": select_ms,
                "top": ranked[:6]}
            log(f"phase 16 T, {kind} mix, top-k by {way}: {kernel_ms:.2f} ms of "
                f"kernels a pass, radix-select kernels {select_ms:.3f} ms, busy {busy:.1%}; "
                f"all {len(mix)} rows equal phase {4 if kind == 'decoded' else 8}'s")
        topk_fig[kind] = {"rows": [BATCH, md], "bound_ms": bound, "k": per_k, "mix": passes}

    # W. WAND on the bench corpus
    or3 = wand_queries(vocab, probs, 3)
    or2 = wand_queries(vocab, probs, 2, seed=PRUNE_SEED + 1)
    wand: dict = {}
    for kind, searcher in searchers.items():
        sets = {"or3": or3, **({"or2": or2} if kind == "packed" else {})}
        METRICS.reset()
        with refuse(kind):
            wide = searcher.search_batch(or3, k=WIDE_K, prune=False)
        count_launches()

        def check(pruned, exact, name, k, where):
            """2-term rows: strict; 3-term rows sum in an unspecified order
            on the card, so near the k-th score they are held to the wide
            exhaustive answer (tests/torch_hitcheck.py). Returns the 3-term
            rows that the strict check would refuse, each with the docs
            that are in one list only and their scores in the pruned run,
            the exhaustive run at k and the one at WIDE_K (None where a
            list lacks the doc; ``exact`` None: no such rows are sought)."""
            swapped = []
            for i, p in enumerate(pruned):
                e = wide[i] if exact is None else exact[i]
                try:
                    if name == "or2":
                        assert_pruned_strict(p, e)
                    else:
                        assert_truncated_within_rtol(p, wide[i], k)
                except AssertionError as err:
                    raise AssertionError(f"phase 16 {where}, {kind} {name} k={k} row {i}: "
                                         f"{err}") from None
                if exact is None:
                    continue
                try:
                    assert_pruned_strict(p, e)
                except AssertionError:
                    ps, es, ws = ({sd.doc: sd.score for sd in x.score_docs}
                                  for x in (p, e, wide[i]))
                    swapped.append({"row": i, "docs": [
                        [int(d)] + [None if x.get(d) is None else float(x[d]) for x in (ps, es, ws)]
                        for d in sorted(set(ps) ^ set(es))]})
            if swapped:
                log(f"phase 16 {where}, {kind} {name} k={k}: {len(swapped)} rows differ from the "
                    f"exhaustive run at the k-th hit (doc, pruned, exhaustive, wide scores): "
                    f"{json.dumps(swapped[:4])}")
            return swapped

        for name, rows in sets.items():
            for k in WAND_KS:
                fig = {}
                with refuse(kind):
                    for prune in (False, True):
                        METRICS.reset()
                        served = serve_mix(searcher, rows, BATCH, k, 3, 1.0, 4, prune=prune)
                        torch.cuda.synchronize()
                        c = METRICS.snapshot()["counters"]
                        count_launches()
                        fig["pruned" if prune else "exhaustive"] = {
                            "qps": served.qps, "passes": served.reps,
                            "pruned_blocks": c.get("search.pruned_blocks", 0),
                            "rerun_rows": c.get("search.prune_rerun_rows", 0)}
                        if prune:
                            pruned = served.results
                        else:
                            exact = served.results
                    METRICS.reset()
                    _ms, busy, _top = profile_fn(
                        lambda: searcher.search_batch(rows, k=k, prune=True), 1, 1)
                    count_launches()
                fig["pruned"]["busy"] = busy
                fig["order_swaps"] = check(pruned, exact, name, k, "W")
                fig["strict_rows"] = len(rows) - len(fig["order_swaps"])
                lower = sum(p.total_hits < e.total_hits for p, e in zip(pruned, exact))
                fig["lower_bound_rows"] = lower
                wand[f"{kind}_{name}_k{k}"] = fig
                pr, ex = fig["pruned"], fig["exhaustive"]
                log(f"phase 16 W, {kind} {name} k={k}: {ex['qps']:.1f} QPS exhaustive, "
                    f"{pr['qps']:.1f} pruned (busy {busy:.1%} of a pruned batch); "
                    f"search.pruned_blocks {pr['pruned_blocks']}, rows rerun "
                    f"{pr['rerun_rows']} of {pr['passes'] * len(rows)}, {lower} rows with a "
                    f"lower-bound total_hits; hits equal; {fig['strict_rows']} of {len(rows)} "
                    f"rows pass assert_pruned_strict against the exhaustive run at k={k}")
        with env("RUCENE_PRUNE_AUTO_MIN_DOCS", str(AUTO_MIN_DOCS)), refuse(kind):
            METRICS.reset()
            auto = searcher.search_batch(or3, k=10)
            n_auto = METRICS.snapshot()["counters"].get("search.auto_prune_batches", 0)
            count_launches()
            METRICS.reset()
            for i in range(0, len(mix), BATCH):
                searcher.search_batch(mix[i:i + BATCH], k=K)
            n_mix = METRICS.snapshot()["counters"].get("search.auto_prune_batches", 0)
            count_launches()
        if n_auto <= 0 or n_mix:
            raise AssertionError(f"phase 16 W, {kind}: search.auto_prune_batches {n_auto} on the "
                                 f"3-term rows at k=10 and {n_mix} on the mix at k={K}")
        wand[f"{kind}_auto"] = {"or3_k10_batches": n_auto, "mix_k100_batches": n_mix,
                                "order_swaps": check(auto, None, "or3", 10, "W auto")}
        log(f"phase 16 W, {kind}: prune=None under RUCENE_PRUNE_AUTO_MIN_DOCS={AUTO_MIN_DOCS}: "
            f"search.auto_prune_batches {n_auto} on the 3-term rows at k=10, {n_mix} on the "
            f"mix at k={K}")

    # S. the summation rule: many-word rows, each batch served three times
    sum_fig = serve_sum_order(searchers, cpu_searcher, sum_q, dev, count_launches)

    # F. pruning that fires: the skewed corpus in 4 segments
    t = time.perf_counter()
    texts = hot_cold_texts(hot_docs)
    w = IndexWriter(RAMDirectory(), IndexWriterConfig(max_buffered_docs=hot_docs // 4,
                                                      merge_on_commit=False))
    for text in texts:
        d = Document()
        d.add(TextField("body", text))
        w.add_document(d)
    reader = w.get_reader()
    write_s = time.perf_counter() - t
    if len(reader.leaves) < 4:
        raise AssertionError(f"phase 16 F: {len(reader.leaves)} segments, expected 4 or more")
    from rucene_tpu_torch import BooleanQuery, Term, TermQuery

    rows = [BooleanQuery().should(TermQuery(Term("body", "hot")))
            .should(TermQuery(Term("body", f"cold{i}"))) for i in range(16)]
    fires: dict = {}
    for mode, combine in (("per_leaf", False), ("combined", True)):
        METRICS.reset()
        s = IndexSearcher(reader, device=dev, combine_segments=combine)
        blocks = 0
        for k in (1, 5):
            exact = s.search_batch(rows, k=k, prune=False)
            before = METRICS.snapshot()["counters"].get("search.pruned_blocks", 0)
            pruned = s.search_batch(rows, k=k, prune=True)
            blocks += METRICS.snapshot()["counters"].get("search.pruned_blocks", 0) - before
            for i, (p, e) in enumerate(zip(pruned, exact)):
                try:
                    assert_pruned_strict(p, e)
                except AssertionError as err:
                    raise AssertionError(f"phase 16 F, {mode} k={k} row {i}: {err}") from None
        torch.cuda.synchronize()
        count_launches()
        if blocks <= 0:
            raise AssertionError(f"phase 16 F, {mode}: search.pruned_blocks stayed 0 on the card")
        fires[mode] = blocks
        log(f"phase 16 F, {mode}: search.pruned_blocks {blocks} over 16 rows at k=1 and 5 on "
            f"{card}; hits equal prune=False's")
        del s
    w.close()
    log(f"phase 16 F: {hot_docs} docs written into {len(reader.leaves)} segments in "
        f"{write_s:.1f}s; launches of the phase {launches}")
    return {"topk": topk_fig, "pruning": {"wand": wand, "fires": fires,
                                         "hot_docs": hot_docs, "write_s": write_s},
            "sum_order": sum_fig}, launches


SUM_SEED = 41  # stage S's many-word rows
SUM_KS = (10, 100, 1000)
SUM_REPEATS = 3
SUM_CPU_ROWS = 64  # packed rows held bit for bit to the port's CPU answers


def sum_order_queries(vocab, probs, seed: int = SUM_SEED) -> dict:
    """Stage S's rows, drawn from ``seed`` over the bench's band (ranks
    10-5000, Zipf-weighted): {"or": 256 pure-OR rows of 3-8 distinct terms,
    "and": 64 rows ``+a +b c d``} (MS MARCO-like many-word rows)."""
    from rucene_tpu_torch import BooleanQuery, Term, TermQuery

    rng = np.random.default_rng(seed)
    draw = band_sampler(vocab, probs, rng)

    def words(n):
        out: list = []
        while len(out) < n:
            w = draw()
            if w not in out:
                out.append(w)
        return out

    def t(w):
        return TermQuery(Term("body", w))

    or_rows = []
    for _ in range(BATCH):
        q = BooleanQuery()
        for w in words(int(rng.integers(3, 9))):
            q.should(t(w))
        or_rows.append(q)
    and_rows = []
    for _ in range(SUM_CPU_ROWS):
        a, b, c, d = words(4)
        and_rows.append(BooleanQuery().must(t(a)).must(t(b)).should(t(c)).should(t(d)))
    return {"or": or_rows, "and": and_rows}


def served_identically(search, row_sets: dict, where: str, ks=SUM_KS,
                       repeats: int = SUM_REPEATS) -> dict:
    """Each batch of ``row_sets`` ({name: rows}) served ``repeats`` times at
    each k of ``ks`` through ``search(rows, k)``; raises unless every run's
    TopDocs equal the first run's bit for bit (f32 score bits, docs,
    total_hits). Returns {(name, k): the first run's TopDocs}."""
    out = {}
    for name, rows in row_sets.items():
        for k in ks:
            runs = [search(rows, k) for _ in range(repeats)]
            for r, run in enumerate(runs[1:], 2):
                for i, (a, b) in enumerate(zip(run, runs[0])):
                    if a.total_hits != b.total_hits or a.score_docs != b.score_docs:
                        diff = sorted(set(a.score_docs) ^ set(b.score_docs))[:6]
                        raise AssertionError(
                            f"{where}: {name} row {i} at k={k}, run {r} differs from run 1: "
                            f"hits {a.total_hits} / {b.total_hits}, (doc, score) in one run "
                            f"only: {diff}")
            out[(name, k)] = runs[0]
    return out


def residue_slots(searcher, rows) -> int:
    """(row, doc) slots a residue item's lane reaches (the items the dense
    branch adds after the combine kernel, pass by pass) for ``rows`` on
    ``searcher``'s first leaf, whatever branch the batch takes."""
    q, combine, target, _sc, valid = flat_combine_call(searcher, rows)
    md = searcher.reader.leaves[0].device.max_doc_padded
    residue = torch.cat([cb.residue for cb in combine])
    if not residue.numel():
        return 0
    rt = target[residue].long()
    keys = q.wi_row[residue].long()[:, None] * md + rt
    return int(torch.unique(keys[valid[residue] & (rt < md)]).numel())


def serve_sum_order(searchers, cpu_searcher, sum_q, dev, count_launches) -> dict:
    """Phase 16 stage S, the summation rule on the card (a (row, doc)'s f32
    score is +0.0 plus its contributions in work-list item order): the
    rows of sum_order_queries (256 OR rows of 3-8 band terms, 64 rows
    ``+a +b c d``) served SUM_REPEATS times at k = 10, 100 and 1,000 on the
    decoded and the packed reader and on the combined view over the packed
    segment split in 4 doc ranges (packed leaves; phase 14 serves them on
    its sharded indexes): every run bit-equal to the first
    (served_identically). Then, on the packed reader, K3 bit-equal to its
    twin on the combine call of the first 32 OR rows, and its 64 ``and``
    rows at k=100 bit-equal to a packed CPU reader's answers to the same
    batch. Printed only: the decoded reader's rows that differ from the
    port's CPU answers (``cpu_searcher``; planes on one side and the flat
    executor on the other may take another order where a residue item
    lands), and the (row, doc) slots a residue item reaches. Each serving
    stage runs with its counts set to 0 just before and read just after
    (``count_launches``). Returns the stage's figures."""
    from rucene_tpu_torch import IndexSearcher
    from rucene_tpu_torch.codec.split import split_packed_segment
    from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
    from rucene_tpu_torch.ops import cuda_combine
    from rucene_tpu_torch.util.metrics import METRICS

    def refuse(kind):
        return plain_decode_refused() if kind == "packed" else contextlib.nullcontext()

    def search_of(s):
        return lambda rows, k: s.search_batch(rows, k=k)

    fig: dict = {"rows": {n: len(r) for n, r in sum_q.items()}, "ks": list(SUM_KS),
                 "repeats": SUM_REPEATS}
    answers = {}
    for kind, searcher in searchers.items():
        t = time.perf_counter()
        METRICS.reset()
        with refuse(kind):
            answers[kind] = served_identically(search_of(searcher), sum_q, f"phase 16 S, {kind}")
        torch.cuda.synchronize()
        c = METRICS.snapshot()["counters"]
        count_launches()
        fig[kind] = {"s": time.perf_counter() - t,
                     "strategy": {b: c.get(f"search.strategy.{b}", 0) for b in ("dense", "candidate")},
                     "routes": {r: c.get(f"route.{r}", 0)
                                for r in ("flat", "plane_rows", "pair_rows", "single")}}
        log(f"phase 16 S, {kind}: {len(sum_q['or'])} OR rows of 3-8 terms and "
            f"{len(sum_q['and'])} rows +a +b c d, served {SUM_REPEATS} times at k = "
            f"{', '.join(map(str, SUM_KS))}: every run bit-equal to the first "
            f"({fig[kind]['s']:.1f}s; strategy {fig[kind]['strategy']}, routes {fig[kind]['routes']})")

    # the combined view over the packed segment split in 4 doc ranges
    packed = searchers["packed"].reader.leaves[0].packed
    t = time.perf_counter()
    parts = split_packed_segment(packed, 4)
    prev = os.environ.get("RUCENE_DECODED")
    os.environ["RUCENE_DECODED"] = "0"
    try:
        with plain_decode_refused():
            comb = IndexSearcher(IndexReader([SegmentSnapshot(f"bench[{i}]", p)
                                              for i, p in enumerate(parts)]),
                                 searchers["packed"].similarity, device=dev, combine_segments=True)
            comb._combined_view()
            torch.cuda.synchronize()
            split_s = time.perf_counter() - t
            t = time.perf_counter()
            METRICS.reset()
            comb_answers = served_identically(search_of(comb), sum_q, "phase 16 S, combined view")
            torch.cuda.synchronize()
            c = METRICS.snapshot()["counters"]
            count_launches()
    finally:
        if prev is None:
            os.environ.pop("RUCENE_DECODED", None)
        else:
            os.environ["RUCENE_DECODED"] = prev
    if c.get("reader.combined_builds", 0) > 1:
        raise AssertionError(f"phase 16 S: {c['reader.combined_builds']} combined views built")
    same = sum(a.total_hits == b.total_hits and a.score_docs == b.score_docs
               for key in comb_answers for a, b in zip(comb_answers[key], answers["packed"][key]))
    fig["combined"] = {"leaves": len(parts), "split_s": split_s, "s": time.perf_counter() - t,
                       "rows_equal_packed": same,
                       "rows": sum(len(v) for v in comb_answers.values())}
    log(f"phase 16 S, combined view over the packed segment split in {len(parts)} "
        f"({split_s:.1f}s to split and build): every run bit-equal to the first "
        f"({fig['combined']['s']:.1f}s); {same} of {fig['combined']['rows']} rows equal the "
        "one-leaf packed reader's bit for bit")
    del comb, parts

    # K3 on one many-word call of the packed reader, bit for bit
    packed_s = searchers["packed"]
    with plain_decode_refused():
        _q, combine, target, sc, _valid = flat_combine_call(packed_s, sum_q["or"][:MAX_CALL_ROWS])
    cb = combine[0]
    b = min(len(sum_q["or"]), MAX_CALL_ROWS)
    shape = (b, packed_s.reader.leaves[0].device.max_doc_padded)
    args = (cb.bucket_ptr, target, sc, cb.e_item, cb.e_row, cb.e_enc)
    out_k = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))
    out_p = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))
    cuda_combine.combine_lanes(*args, *out_k)
    cuda_combine.combine_lanes_plain(*args, *out_p)
    k3_bit_equal(out_k, out_p, "on the many-word call")
    fig["k3_many_word"] = {"rows": b, "entries": int(cb.e_item.numel())}
    log(f"phase 16 S: combine kernel bit-equal to its twin on the first {b} OR rows' call "
        f"({int(cb.e_item.numel())} entries)")
    del out_k, out_p, args, target, sc, combine

    # the packed reader's 64 ``and`` rows against a packed CPU reader
    prev = os.environ.get("RUCENE_DECODED")
    os.environ["RUCENE_DECODED"] = "0"
    try:
        cpu_packed = IndexSearcher(IndexReader([SegmentSnapshot("bench", packed)]),
                                   packed_s.similarity, device="cpu")
        t = time.perf_counter()
        cpu_and = cpu_packed.search_batch(sum_q["and"], k=K)
    finally:
        if prev is None:
            os.environ.pop("RUCENE_DECODED", None)
        else:
            os.environ["RUCENE_DECODED"] = prev
    for i, (g, w) in enumerate(zip(answers["packed"][("and", K)], cpu_and)):
        if g.total_hits != w.total_hits or g.score_docs != w.score_docs:
            raise AssertionError(f"phase 16 S: packed row {i} (+a +b c d) differs from the "
                                 "port's CPU answer")
    cpu_dec = cpu_searcher.search_batch(sum_q["and"], k=K)
    dec_diff = sum(g.total_hits != w.total_hits or g.score_docs != w.score_docs
                   for g, w in zip(answers["decoded"][("and", K)], cpu_dec))
    fig["cpu"] = {"packed_rows_equal": len(cpu_and), "decoded_rows_differing": dec_diff,
                  "s": time.perf_counter() - t}
    res = {name: residue_slots(packed_s, rows) for name, rows in sum_q.items()}
    fig["residue_slots"] = res
    log(f"phase 16 S: {len(cpu_and)} packed rows +a +b c d at k={K} bit-equal to a packed CPU "
        f"reader's answers to the same batch; {dec_diff} of {len(cpu_dec)} decoded rows differ "
        f"from the CPU searcher's; (row, doc) slots a residue item reaches: {res}")
    return fig


# --- phase 12: NRT on the card (bench.py:519-640 main_nrt, its defaults) -----

NRT_BASE = 200_000  # base docs through the writer
NRT_EXTRA = 50_000  # corpus docs past the base: the warm refresh and the ingest
NRT_QUERIES = 256
NRT_BATCH = 128
NRT_REFRESH_S = 0.5
NRT_RATE = 2000  # ingest docs a second
NRT_CHUNK = 250  # docs an add_documents call, beside one marker doc
NRT_SEGMENT_DOCS = 25_000  # the writer's max_buffered_docs
NRT_COMMIT_EVERY = 2000  # ingested docs between two commits
NRT_WARM = 2000  # docs of the warm refresh
NRT_DEAD_MARKERS = 64
NRT_DEAD_RANK = 3000  # the bench rank of the body word deleted by query
NRT_MERGE_TO = 9  # force_merge's target after the window: the flush segments merge into one
NRT_SECONDS = 45.0  # the serving window


def plane_bytes_off(leaves) -> int:
    """Bytes of phrase position planes on the card held for segments that
    none of ``leaves`` serves (freed segments whose planes the next plane
    fetch drops included)."""
    from rucene_tpu_torch.search import phrase_path

    live = {id(lf.packed) for lf in leaves}
    return sum(
        plane.numel() * plane.element_size() + (0 if ov is None else ov.numel())
        for (seg,), _key, (plane, ov) in phrase_path._PLANE_CACHE.items()
        if plane.is_cuda and (seg is None or id(seg) not in live)
    )


def nrt_kernel_replay(searcher, leaf, dense_q, dev) -> dict:
    """K1 and K3 at an NRT flush segment's shapes against their plain
    twins on the same inputs. K1: the decoded residency the decode kernel
    built for ``leaf`` on the main path, every block bit for bit against
    the twin on the CPU (left out when the leaf is served packed). K3: the
    combine call of the head-band pair rows ``dense_q`` on the leaf's dense
    branch, the kernel on ``dev`` and the twin (which adds on the CPU), bit
    for bit. Returns each kernel's figures; the K3 replay's one launch is
    not a main-path launch."""
    from rucene_tpu_torch.codec.device import build_device_segment
    from rucene_tpu_torch.ops import cuda_combine, cuda_decode

    out = {"segment": leaf.name, "max_doc": leaf.max_doc}
    gdev = leaf.device
    if gdev.docs_dec is not None:
        cpu_seg = build_device_segment(leaf.packed, "cpu")
        want = cuda_decode.decode_blocks_plain(
            cpu_seg.data, cpu_seg.blk_off, cpu_seg.blk_doc_bits, cpu_seg.blk_freq_bits,
            cpu_seg.blk_base, cpu_seg.blk_count, freq_dtype=gdev.freqs_dec.dtype,
        )
        for got, ref in zip((gdev.docs_dec, gdev.freqs_dec, gdev.norm_dec), want):
            if not torch.equal(got.cpu(), ref):
                raise AssertionError(f"decode kernel differs from its twin on NRT segment {leaf.name}")
        out["decode_blocks"] = {"blocks": leaf.packed.num_blocks, "max_abs_err": 0}
    _q, cb, target, sc, _valid = head_band_combine_call(searcher, dense_q, leaf)
    shape = (len(dense_q), gdev.max_doc_padded)
    args = (cb.bucket_ptr, target, sc, cb.e_item, cb.e_row, cb.e_enc)
    out_k = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))
    out_p = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))
    cuda_combine.combine_lanes(*args, *out_k)
    cuda_combine.combine_lanes_plain(*args, *out_p)
    err = k3_bit_equal(out_k, out_p, f"on NRT segment {leaf.name}")
    out["combine_lanes"] = {"entries": int(cb.e_item.numel()), "rows": shape[0],
                            "max_doc_padded": shape[1], "max_abs_err": err}
    return out


def serve_nrt(dev, card, seconds: float = NRT_SECONDS, disk: bool = True,
              n_base: int = NRT_BASE) -> dict:
    """Phase 12: NRT on the card, in the shape of bench.py main_nrt at its
    defaults (BASELINE.json config 4). The corpus is build_corpus(n_base +
    50,000) (seed 7); its first ``n_base`` docs (200,000 by default) go
    through the port's IndexWriter into
    a RAMDirectory (max_buffered_docs 25,000, TieredMergePolicy with 64
    segments a tier, no merge on commit) and are committed; 256 queries
    from build_queries (phrase texts from the first 5,000 docs) serve in
    batches of 128 at k=100 through a SearcherManager on ``dev``. A warm
    pass, a warm refresh of 2,000 docs, then a serving window of
    ``seconds`` (45 by default): an ingest thread adds 250-doc
    chunks, each beside one marker doc with a token of its own, at 2,000
    docs a second and commits every 2,000 docs; the foreground refreshes
    every 0.5 s and serves batches. The ingest thread only calls the
    writer: device forms are built by the serving thread, in search_batch.

    Gates (each raises): after each refresh the reader's num_docs covers
    every commit acknowledged before it; at the end (stop, commit,
    refresh) one batch of marker TermQuerys finds each marker once;
    route.host stays 0; the device builds equal the segments served for
    the first time. Then 64 markers are deleted by term and the body word
    of bench rank 3,000 by query, and a refresh: those rows find nothing,
    the refresh builds no device form, and the 16 sampled rows (two of
    each bench kind) equal a CPU reader opened with open_directory_reader
    on the committed directory. Then a merging refresh (force_merge into
    9 segments: the flush segments become one): a searcher acquired
    before it answers its 16 rows bit for bit the same after it, the new
    searcher equals the CPU reader over the merged commit, and only the
    merged segment is built on the card. Then, with the phase's counts
    read, nrt_kernel_replay holds K1 and K3 at the shapes of the smallest
    flush segment against their plain twins. Last, the on-disk stage: the
    base docs committed by the port's writer into an FSDirectory under a
    temporary directory, opened with open_directory_reader on the card,
    answer the 16 rows as the in-memory base reader did, bit for bit;
    tools/check_index finds the index clean, and a copy with one byte of
    a segment file flipped raises CorruptIndexError (``disk=False`` skips
    this stage); then the base docs go to a second FSDirectory in 8
    add_documents calls of 25,000 (8 flush segments), and the
    multi-process stage (serve_multi_process) opens it in partial mode from
    spawned processes over NCCL.
    Between the read-back and the deletes, serve_combined serves the
    reader of the window's end (55-60 leaves) through its combined view.

    Returns the phase's figures (QPS, ingest rate, refreshes and their
    times, batch latencies, leaves, merges, device builds, peak memory,
    plane bytes held for segments no reader serves, kernel launches, the
    replay's figures, the combined view's and the multi-process stage's)."""
    import gc
    import shutil
    import tempfile
    import threading

    from rucene_tpu_torch import (
        CorruptIndexError,
        Document,
        FSDirectory,
        IndexSearcher,
        IndexWriter,
        IndexWriterConfig,
        RAMDirectory,
        SearcherManager,
        StringField,
        Term,
        TermQuery,
        TextField,
        TieredMergePolicy,
        open_directory_reader,
    )
    from rucene_tpu_torch.codec import files as segfiles
    from rucene_tpu_torch.tools.check_index import check_index
    from rucene_tpu_torch.util.metrics import METRICS
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import assert_topdocs_strict  # numpy-only test helper

    t = time.perf_counter()
    texts, vocab, probs = build_corpus(n_base + NRT_EXTRA)
    queries = build_queries(NRT_QUERIES, vocab, probs, phrase_texts=texts[:5000])
    no_phrase = build_queries(NRT_QUERIES, vocab, probs)
    sample_idx = [i for kind in range(8) for i in (kind, kind + 8 * (NRT_QUERIES // 8 - 1))]
    sample = [queries[i] for i in sample_idx]
    log(f"NRT corpus of {len(texts)} docs and {len(queries)} queries in {time.perf_counter() - t:.1f}s")

    def docs_of(lo, hi):
        out = []
        for text in texts[lo:hi]:
            d = Document()
            d.add(TextField("body", text))
            out.append(d)
        return out

    def writer_on(directory):
        return IndexWriter(directory, IndexWriterConfig(
            max_buffered_docs=NRT_SEGMENT_DOCS, merge_policy=TieredMergePolicy(segs_per_tier=64),
            merge_on_commit=False,
        ))

    def compare(got, want, where):
        for i, g, x in zip(sample_idx, got, want):
            try:
                assert_topdocs_strict(g, x)
            except AssertionError as e:
                raise AssertionError(f"{where}: query {i}: {e}") from None

    def same_bits(got, want, where):
        for i, g, x in zip(sample_idx, got, want):
            if g.total_hits != x.total_hits or g.score_docs != x.score_docs:
                raise AssertionError(f"{where}: query {i} differs")

    served: set = set()  # segments a searcher served in this phase

    def run(searcher, rows):
        served.update(lf.name for lf in searcher.reader.leaves)
        return searcher.search_batch(rows, k=K)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    METRICS.reset()  # the phase's counts
    t = time.perf_counter()
    ram = RAMDirectory()
    w = writer_on(ram)
    w.add_documents(docs_of(0, n_base))
    w.commit()
    index_s = time.perf_counter() - t
    mgr = SearcherManager(w, searcher_factory=lambda r: IndexSearcher(r, device=dev))
    s0 = mgr.acquire()
    log(f"NRT base index: {n_base} docs through the writer in {index_s:.1f}s, "
        f"{len(s0.reader.leaves)} segments")
    t = time.perf_counter()
    for i in range(0, NRT_QUERIES, NRT_BATCH):  # warm, as bench.py
        run(s0, queries[i : i + NRT_BATCH])
    base_answers = run(s0, sample)  # the on-disk stage's reference
    mgr.release(s0)
    w.add_documents(docs_of(n_base, n_base + NRT_WARM))
    w.commit()
    mgr.maybe_refresh()
    s0 = mgr.acquire()
    for i in range(0, NRT_QUERIES, NRT_BATCH):
        run(s0, queries[i : i + NRT_BATCH])
    mgr.release(s0)
    torch.cuda.synchronize()
    log(f"NRT warm passes and warm refresh in {time.perf_counter() - t:.1f}s")

    stop = threading.Event()
    state = {"ingested": 0, "markers": 0, "acked": n_base + NRT_WARM, "commits": 0, "error": None}

    def ingest():
        try:
            i = n_base + NRT_WARM
            while not stop.is_set() and i < len(texts):
                t0 = time.perf_counter()
                docs = docs_of(i, i + NRT_CHUNK)
                marker = Document()
                marker.add(StringField("marker", f"m{state['markers']}"))
                w.add_documents(docs + [marker])
                i += len(docs)
                state["ingested"] += len(docs)
                state["markers"] += 1
                if state["ingested"] % NRT_COMMIT_EVERY < NRT_CHUNK:
                    w.commit()
                    state["commits"] += 1
                    state["acked"] = n_base + NRT_WARM + state["ingested"] + state["markers"]
                time.sleep(max(0.0, len(docs) / NRT_RATE - (time.perf_counter() - t0)))
        except BaseException as e:  # raised by the foreground
            state["error"] = e

    lat, first_lat, refresh_ms, to_first, leaves_at = [], [], [], [], []
    refreshes = changed_refreshes = 0
    served_q = qi = 0
    pending = None  # start of a refresh whose first batch has not run yet
    th = threading.Thread(target=ingest, daemon=True)
    t0 = time.perf_counter()
    last = t0
    th.start()
    while time.perf_counter() - t0 < seconds:
        if time.perf_counter() - last >= NRT_REFRESH_S:
            acked = state["acked"]
            r0 = time.perf_counter()
            changed = mgr.maybe_refresh()
            refresh_ms.append((time.perf_counter() - r0) * 1e3)
            refreshes += 1
            last = time.perf_counter()
            s = mgr.acquire()
            if s.reader.num_docs < acked:
                raise AssertionError(f"refresh {refreshes}: {s.reader.num_docs} docs, "
                                     f"{acked} acknowledged before it")
            mgr.release(s)
            if changed:
                changed_refreshes += 1
                pending = r0
        s = mgr.acquire()
        b0 = time.perf_counter()
        rows = queries[qi : qi + NRT_BATCH]
        run(s, rows)
        b_ms = (time.perf_counter() - b0) * 1e3
        mgr.release(s)
        lat.append(b_ms)
        leaves_at.append(len(s.reader.leaves))
        if pending is not None:
            first_lat.append(b_ms)
            to_first.append((time.perf_counter() - pending) * 1e3)
            pending = None
        served_q += len(rows)
        qi = (qi + NRT_BATCH) % NRT_QUERIES
    wall = time.perf_counter() - t0
    stop.set()
    th.join(timeout=60)
    if th.is_alive() or state["error"] is not None:
        raise AssertionError(f"the ingest thread failed: {state['error']!r}")
    leaves_window = len(mgr.acquire().reader.leaves)
    nrt_qps = served_q / wall
    ingest_docs_s = state["ingested"] / wall
    # batch time against the leaves it walked: the per-leaf cost that a
    # combined multi-segment view would take away
    per_leaf_ms, base_ms = np.polyfit(leaves_at, lat, 1)
    log(f"NRT window: {nrt_qps:.1f} QPS over {wall:.1f}s ({served_q} queries, batch {NRT_BATCH}, "
        f"k={K}) on {card}; ingested {state['ingested']} docs ({ingest_docs_s:.0f}/s) and "
        f"{state['markers']} markers in {state['commits']} commits; {refreshes} refreshes "
        f"({changed_refreshes} with changes), mean {np.mean(refresh_ms):.1f} ms, max "
        f"{np.max(refresh_ms):.1f} ms; batch p50 {np.percentile(lat, 50):.1f} ms, p99 "
        f"{np.percentile(lat, 99):.1f} ms; first batch after a refresh p50 "
        f"{np.percentile(first_lat, 50):.1f} ms, refresh to first batch mean "
        f"{np.mean(to_first):.1f} ms, max {np.max(to_first):.1f} ms; {leaves_window} leaves; "
        f"batch ms = {base_ms:.1f} + {per_leaf_ms:.2f} a leaf (least squares over "
        f"{min(leaves_at)}-{max(leaves_at)} leaves)")

    # acknowledged writes read back
    w.commit()
    mgr.maybe_refresh()
    s = mgr.acquire()
    n_markers = state["markers"]
    want_docs = n_base + NRT_WARM + state["ingested"] + n_markers
    if s.reader.num_docs != want_docs:
        raise AssertionError(f"{s.reader.num_docs} docs after the final refresh, {want_docs} added")
    marks = run(s, [TermQuery(Term("marker", f"m{j}")) for j in range(n_markers)])
    if [td.total_hits for td in marks] != [1] * n_markers:
        bad = [j for j, td in enumerate(marks) if td.total_hits != 1]
        raise AssertionError(f"markers not found exactly once: {bad[:10]}")
    counters = METRICS.snapshot()["counters"]
    builds = window_builds = counters.get("reader.device_builds", 0)
    if counters.get("route.host", 0):
        raise AssertionError(f"route.host={counters['route.host']} in the NRT bench mix")
    if builds != len(served):
        raise AssertionError(f"{builds} device builds for {len(served)} segments served")
    log(f"NRT: {n_markers} markers found once each in {len(s.reader.leaves)} leaves; "
        f"{builds} device builds for {len(served)} segments served; route.host 0")
    combined = serve_combined(s, queries, no_phrase, dev)

    # deletes reach every route; a delete refresh builds nothing
    step = max(1, n_markers // NRT_DEAD_MARKERS)
    dead = [f"m{j}" for j in range(0, n_markers, step)][:NRT_DEAD_MARKERS]
    dead_word = str(vocab[NRT_DEAD_RANK])
    for m in dead:
        w.delete_documents_by_term(Term("marker", m))
    w.delete_documents_by_query(TermQuery(Term("body", dead_word)))
    w.commit()
    mgr.maybe_refresh()
    s = mgr.acquire()
    gone = run(s, [TermQuery(Term("marker", m)) for m in dead] + [TermQuery(Term("body", dead_word))])
    if any(td.total_hits for td in gone):
        raise AssertionError("a deleted marker or the deleted word still matches on the card")
    del_builds = METRICS.snapshot()["counters"].get("reader.device_builds", 0) - builds
    if del_builds:
        raise AssertionError(f"the delete refresh built {del_builds} device forms")
    deleted = s.reader.max_doc - s.reader.num_docs
    card_sample = run(s, sample)
    t = time.perf_counter()
    cpu = IndexSearcher(open_directory_reader(ram), device="cpu")
    compare(card_sample, cpu.search_batch(sample, k=K), "after the deletes")
    log(f"NRT deletes: {len(dead)} markers and {dead_word!r} ({deleted} docs) gone on the card, "
        f"no device build; 16 rows equal a CPU reader over the commit "
        f"({time.perf_counter() - t:.1f}s)")
    del cpu

    # a merging refresh: the searcher acquired before it keeps its answers
    s_old = mgr.acquire()
    old_answers = run(s_old, sample)
    builds = METRICS.snapshot()["counters"].get("reader.device_builds", 0)
    t = time.perf_counter()
    w.force_merge(NRT_MERGE_TO)
    w.commit()
    merge_s = time.perf_counter() - t
    mgr.maybe_refresh()
    s_new = mgr.acquire()
    new_names = {lf.name for lf in s_new.reader.leaves} - served
    new_answers = run(s_new, sample)
    same_bits(s_old.search_batch(sample, k=K), old_answers, "the searcher held across the merge")
    merge_builds = METRICS.snapshot()["counters"].get("reader.device_builds", 0) - builds
    if merge_builds != len(new_names):
        raise AssertionError(f"the merging refresh built {merge_builds} forms for "
                             f"{len(new_names)} new segments")
    cpu = IndexSearcher(open_directory_reader(ram), device="cpu")
    compare(new_answers, cpu.search_batch(sample, k=K), "after the merge")
    del cpu, s_old
    gc.collect()
    run(s_new, queries[:NRT_BATCH])  # a plane fetch drops the planes of freed segments
    dead_plane_bytes = plane_bytes_off(s_new.reader.leaves)
    counters = METRICS.snapshot()["counters"]
    merges = counters.get("writer.merges", 0)
    leaves_end = len(s_new.reader.leaves)
    log(f"NRT merge: {leaves_window} -> {leaves_end} leaves in {merge_s:.1f}s ({merges} merges), "
        f"{merge_builds} device build; the searcher acquired before it answers bit for bit as "
        f"before; 16 rows equal the CPU reader; phrase planes held for segments no reader serves: "
        f"{dead_plane_bytes} bytes on the card")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = launches_in(counters)
    # K1 and K3 at a flush segment's shapes (the smallest leaf the delete
    # refresh served) against their twins, after the phase's counts are read
    small = min(s.reader.leaves, key=lambda lf: lf.max_doc)
    replay = nrt_kernel_replay(s, small, head_pair_queries(vocab), dev)
    log(f"NRT kernels at segment {small.name}'s shapes ({small.max_doc} docs): "
        + ("decode kernel bit-equal to the twin over "
           f"{replay['decode_blocks']['blocks']} blocks; " if "decode_blocks" in replay else "")
        + f"combine kernel bit-equal to the twin ({replay['combine_lanes']['entries']} entries, "
        f"{replay['combine_lanes']['rows']} rows x {replay['combine_lanes']['max_doc_padded']} docs, "
        f"max abs err {replay['combine_lanes']['max_abs_err']:.3g})")
    del s_new, s
    w.close()
    mgr = w = None

    figures = {
        "nrt_qps": nrt_qps, "ingest_docs_s": ingest_docs_s, "refreshes": refreshes,
        "refreshes_changed": changed_refreshes,
        "refresh_ms": [float(np.mean(refresh_ms)), float(np.max(refresh_ms))],
        "batch_ms_p50_p99": [float(np.percentile(lat, 50)), float(np.percentile(lat, 99))],
        "first_batch_ms_p50_max": [float(np.percentile(first_lat, 50)), float(np.max(first_lat))],
        "refresh_to_first_batch_ms": [float(np.mean(to_first)), float(np.max(to_first))],
        "batch_ms_fit": [float(base_ms), float(per_leaf_ms)],
        "leaves": [leaves_window, leaves_end], "merges": merges,
        "device_builds": window_builds + merge_builds, "peak_gib": peak_gib,
        "dead_plane_bytes": dead_plane_bytes, "launches": launches, "replay": replay,
        "markers": n_markers, "deleted_docs": deleted, "index_s": index_s, "merge_s": merge_s,
        "decoded": os.environ.get("RUCENE_DECODED", "auto"), "combined": combined,
    }
    log(f"NRT kernel launches in the phase: {launches}; peak {peak_gib:.2f} GiB")
    # fresh segments are built through the decode kernel, or served packed
    # through the scoring decode
    kernel = "decode_score_blocks" if figures["decoded"] == "0" else "decode_blocks"
    if launches[kernel] <= 0:
        raise AssertionError(f"kernel {kernel} never launched in the NRT phase")
    if not disk:
        return figures

    # the on-disk stage
    tmp = tempfile.mkdtemp(prefix="rtt_nrt_")
    try:
        t = time.perf_counter()
        fs = FSDirectory(os.path.join(tmp, "index"))
        fw = writer_on(fs)
        fw.add_documents(docs_of(0, n_base))
        fw.commit()
        fw.close()
        disk_write_s = time.perf_counter() - t
        t = time.perf_counter()
        on_disk = IndexSearcher(open_directory_reader(fs), device=dev)
        same_bits(on_disk.search_batch(sample, k=K), base_answers, "the on-disk reader")
        disk_open_s = time.perf_counter() - t
        del on_disk
        t = time.perf_counter()
        st = check_index(fs)
        if not st.clean:
            raise AssertionError("check_index: " + st.render())
        check_s = time.perf_counter() - t
        bad_dir = os.path.join(tmp, "flipped")
        shutil.copytree(fs.path, bad_dir)
        seg = max((n for n in os.listdir(bad_dir) if n.endswith(".seg")),
                  key=lambda n: os.path.getsize(os.path.join(bad_dir, n)))
        with open(os.path.join(bad_dir, seg), "r+b") as f:
            f.seek(os.path.getsize(os.path.join(bad_dir, seg)) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0x01]))
        try:
            segfiles.read_segment(FSDirectory(bad_dir), seg[: -len(".seg")], lazy=False)
        except CorruptIndexError:
            pass
        else:
            raise AssertionError(f"a flipped byte in {seg} went unnoticed")
        # the multi-process stage's index: the base docs in one flush
        # segment a NRT_SEGMENT_DOCS, as the writer cuts them under load
        mp_dir = FSDirectory(os.path.join(tmp, "sharded"))
        mw = writer_on(mp_dir)
        for lo in range(0, n_base, NRT_SEGMENT_DOCS):
            mw.add_documents(docs_of(lo, min(lo + NRT_SEGMENT_DOCS, n_base)))
        mw.commit()
        mw.close()
        mp_reader = IndexSearcher(open_directory_reader(mp_dir), device=dev)
        one_reader = []
        for i in range(0, NRT_QUERIES, NRT_BATCH):
            one_reader.extend(mp_reader.search_batch(queries[i:i + NRT_BATCH], k=K))
        mp_segments = len(mp_reader.reader.leaves)
        del mp_reader
        figures["multi_process"] = serve_multi_process(mp_dir.path, queries, one_reader, dev)
        figures["multi_process"]["segments"] = mp_segments
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"NRT on disk: the port's writer committed {n_base} docs to an FSDirectory in "
        f"{disk_write_s:.1f}s; open_directory_reader served the 16 rows on the card bit for bit "
        f"as the in-memory base reader ({disk_open_s:.1f}s); check_index clean ({check_s:.1f}s); "
        f"a flipped byte in {seg} raised CorruptIndexError")
    figures["check_index_s"] = check_s
    return figures


def serve_combined(searcher, queries, no_phrase, dev) -> dict:
    """Phase 12's combined-view stage, over the NRT reader at the end of the
    serving window (55-60 leaves): IndexSearcher(reader,
    combine_segments=True) builds the reader's combined view (timed, with
    the decode kernel's launch) and serves the phase's 256 queries and the
    same mix without phrase rows in batches of 128, in turns with the
    per-leaf ``searcher`` (per-leaf, combined, combined, per-leaf a batch).
    Gates: every row equals the per-leaf answer (tests/torch_hitcheck.py;
    rows of at most two scoring clauses), one view built. Returns the view's
    build seconds, leaves, and the ms a batch of both."""
    from rucene_tpu_torch import IndexSearcher
    from rucene_tpu_torch.util.metrics import METRICS
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import assert_topdocs_strict  # numpy-only test helper

    before = METRICS.snapshot()["counters"]
    comb = IndexSearcher(searcher.reader, searcher.similarity, device=dev, combine_segments=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    view = comb._combined_view()
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t
    out = {"leaves": len(searcher.reader.leaves), "view_s": view_s, "view_blocks": view.n_blocks,
           "decoded": view.device.docs_dec is not None}
    for name, rows in (("mix", queries), ("no_phrase", no_phrase)):
        batches = [rows[i:i + NRT_BATCH] for i in range(0, len(rows), NRT_BATCH)]
        for b in batches:  # warm both
            searcher.search_batch(b, k=K)
            comb.search_batch(b, k=K)
        ms = {"per_leaf": [], "combined": []}
        for b in batches:
            for which, s in (("per_leaf", searcher), ("combined", comb), ("combined", comb),
                             ("per_leaf", searcher)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = s.search_batch(b, k=K)
                torch.cuda.synchronize()
                ms[which].append((time.perf_counter() - t) * 1e3)
                if which == "per_leaf":
                    want = got
                else:
                    comb_got = got
            for i, (g, w) in enumerate(zip(comb_got, want)):
                try:
                    assert_topdocs_strict(g, w)
                except AssertionError as e:
                    raise AssertionError(f"combined view, {name} row {i}: {e}") from None
        out[name] = {k: float(np.mean(v)) for k, v in ms.items()}
    moved = counter_delta(METRICS.snapshot()["counters"], before)
    if moved.get("reader.combined_builds", 0) != 1:
        raise AssertionError(f"{moved.get('reader.combined_builds', 0)} combined views built")
    out["decode_blocks"] = moved.get("kernel.decode_blocks", 0)
    log(f"NRT combined view over {out['leaves']} leaves: built in {view_s:.3f}s "
        f"({view.n_blocks} blocks, decoded {out['decoded']}, K1 {out['decode_blocks']}); ms a "
        f"128-row batch, per-leaf / combined: mix {out['mix']['per_leaf']:.1f} / "
        f"{out['mix']['combined']:.1f}, without phrases {out['no_phrase']['per_leaf']:.1f} / "
        f"{out['no_phrase']['combined']:.1f}; every row equals the per-leaf answer")
    return out


def query_spec(q) -> list:
    """A bench row as JSON: ["t", w], ["or", a, b], ["and", a, b] or ["p", a, b]."""
    name = type(q).__name__
    if name == "TermQuery":
        return ["t", q.term.text]
    if name == "PhraseQuery":
        return ["p", *q.rewrite().phrases[0][1]]
    rq = q.rewrite()
    return ["and" if rq.n_required else "or", *(c.term.text for c in rq.clauses)]


def query_from_spec(spec):
    from rucene_tpu_torch import BooleanQuery, PhraseQuery, Term, TermQuery

    kind, *words = spec
    if kind == "t":
        return TermQuery(Term("body", words[0]))
    if kind == "p":
        return PhraseQuery("body", words)
    q = BooleanQuery()
    for w in words:
        (q.must if kind == "and" else q.should)(TermQuery(Term("body", w)))
    return q


def mp_worker(argv) -> int:
    """One process of the multi-process stage (``chip_smoke.py --mp-worker
    INIT WORLD RANK BACKEND INDEX_DIR QUERIES_JSON OUT``): joins the group
    (NCCL on its card; gloo on the CPU for a rehearsal), opens the index in
    partial mode on a pod mesh of SHARDS shards (SHARDS // WORLD on its
    device), serves the queries in batches of NRT_BATCH (a warm pass, then
    a timed one) and writes its answers and figures to OUT.RANK."""
    from rucene_tpu_torch import FSDirectory
    from rucene_tpu_torch.ops import cuda_build
    from rucene_tpu_torch.parallel import multi_host
    from rucene_tpu_torch.parallel.sharded import ShardedIndex, ShardedSearcher
    from rucene_tpu_torch.util.metrics import METRICS

    init, world, rank, backend, index_dir, queries_json, out = argv
    world, rank = int(world), int(rank)
    multi_host.initialize(init, world_size=world, rank=rank, backend=backend)
    if backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
        cuda_build.kernels()
    else:
        dev = torch.device("cpu")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with open(queries_json) as f:
        queries = [query_from_spec(s) for s in json.load(f)]
    per = max(SHARDS // world, 1)
    mesh = multi_host.make_pod_mesh(shards_per_host=per, devices=[dev] * per, partition="index")
    METRICS.reset()
    t = time.perf_counter()
    index = ShardedIndex.from_directory(mesh, FSDirectory(index_dir))
    sync()
    load_s = time.perf_counter() - t
    ss = ShardedSearcher(index)
    for i in range(0, len(queries), NRT_BATCH):
        ss.search_batch(queries[i:i + NRT_BATCH], k=K)
    sync()
    t = time.perf_counter()
    got = []
    for i in range(0, len(queries), NRT_BATCH):
        got.extend(ss.search_batch(queries[i:i + NRT_BATCH], k=K))
    sync()
    qps = len(queries) / (time.perf_counter() - t)
    counters = METRICS.snapshot()["counters"]
    with open(f"{out}.{rank}", "w") as f:
        json.dump({
            "rank": rank, "world": world, "backend": torch.distributed.get_backend(),
            "device": str(dev), "mesh": mesh.shape, "owned": sorted(index.owned),
            "loaded_segments": len(index.leaves), "load_s": load_s, "qps": qps,
            "launches": launches_in(counters),
            "routes": {r: counters.get(r, 0) for r in ("route.mesh", "route.mesh_phrase",
                                                        "route.mesh_fallback")},
            "hits": [[td.total_hits, [[int(d), float(s)] for d, s in td.score_docs]] for td in got],
        }, f)
    torch.distributed.destroy_process_group()
    return 0


def serve_multi_process(index_dir: str, queries, one_reader, dev, backend: str = "nccl") -> dict:
    """The multi-process stage: ShardedIndex.from_directory in partial
    mode over phase 12's second on-disk index, behind multi_host.initialize with
    NCCL, in a world of one spawned process a card (up to 4; a world of 1
    on one card), each owning SHARDS // world shards (backend="gloo": two
    CPU processes, a rehearsal without a card). Gates: every process
    exits 0 within 600 s (a process past it is killed and fails the
    stage); each answers every query as this process's one-process
    partial-mode ShardedSearcher on the same directory, and as the
    one-reader ``one_reader`` answers, under tests/torch_hitcheck.py; the
    processes together load every segment once. Returns the world's
    figures.""" 
    import socket
    import tempfile

    from rucene_tpu_torch import FSDirectory
    from rucene_tpu_torch.parallel.sharded import ShardedIndex, ShardedSearcher, make_mesh
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import assert_topdocs_strict  # numpy-only test helper

    world = min(torch.cuda.device_count(), SHARDS) if backend == "nccl" else 2
    one = ShardedSearcher(ShardedIndex.from_directory(
        make_mesh(SHARDS, 1, devices=[dev] * SHARDS), FSDirectory(index_dir)))
    want = []
    for i in range(0, len(queries), NRT_BATCH):
        want.extend(one.search_batch(queries[i:i + NRT_BATCH], k=K))
    for i, (g, w) in enumerate(zip(want, one_reader)):
        assert_topdocs_strict(g, w)
    del one
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="rtt_mp_")
    qpath = os.path.join(tmp, "queries.json")
    with open(qpath, "w") as f:
        json.dump([query_spec(q) for q in queries], f)
    out = os.path.join(tmp, "out")
    t = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mp-worker", f"tcp://localhost:{port}",
             str(world), str(r), backend, index_dir, qpath, out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"multi-process rank {r} exited {p.returncode}:\n{logs[r][-4000:]}")
    from rucene_tpu_torch.codec import files as segfiles

    n_segments = len(segfiles.read_segments_file(FSDirectory(index_dir)).segments)
    ranks = []
    for r in range(world):
        with open(f"{out}.{r}") as f:
            res = json.load(f)
        from rucene_tpu_torch.search.searcher import ScoreDoc, TopDocs

        for i, ((n, sd), w) in enumerate(zip(res["hits"], want)):
            g = TopDocs(n, [ScoreDoc(d, np.float32(s)) for d, s in sd])
            try:
                assert_topdocs_strict(g, w)
            except AssertionError as e:
                raise AssertionError(f"multi-process rank {r} row {i}: {e}") from None
        res.pop("hits")
        ranks.append(res)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    if sum(r["loaded_segments"] for r in ranks) != n_segments:
        raise AssertionError(f"the world loaded {[r['loaded_segments'] for r in ranks]} of "
                             f"{n_segments} segments")
    log(f"multi-process stage: a world of {world} over {backend} ({', '.join(r['device'] for r in ranks)}), "
        f"partial mode on {ranks[0]['mesh']} shards; {len(queries)} queries equal the one-process "
        f"sharded searcher's and the one-reader answers on every rank; "
        + "; ".join(f"rank {r['rank']}: owned {r['owned']}, {r['loaded_segments']} segments "
                    f"loaded in {r['load_s']:.2f}s, {r['qps']:.1f} QPS, launches {r['launches']}"
                    for r in ranks)
        + f"; {wall:.1f}s wall")
    return {"world": world, "wall_s": wall, "ranks": ranks}


def k3_bit_equal(out_k, out_p, where: str) -> float:
    """Raise unless the combine kernel's (scores, counts) equal its twin's
    bit for bit; return the scores' max abs difference (0.0)."""
    torch.cuda.synchronize()
    if not torch.equal(out_k[1], out_p[1]):
        raise AssertionError(f"combine kernel counts differ from the twin {where}")
    if not torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32)):
        err = float((out_k[0] - out_p[0]).abs().max())
        raise AssertionError(f"combine kernel scores differ from the twin {where} "
                             f"(max abs err {err})")
    return float((out_k[0] - out_p[0]).abs().max())


def ordered_sum_calls(searcher, batch, k: int = K) -> list:
    """The (values, seg_start, gid) of every ordered-sum call the executor
    makes while ``searcher`` serves ``batch`` at ``k``, cloned."""
    from rucene_tpu_torch.ops import ordered_sum

    seen = []
    orig = ordered_sum.segment_sum_ordered

    def spy(values, seg_start, gid=None):
        gid = ordered_sum.group_ids(seg_start) if gid is None else gid
        seen.append((values.clone(), seg_start.clone(), gid.clone()))
        return orig(values, seg_start, gid)

    # the candidate branch calls it through ordered_sum.grouped_sums_ordered
    ordered_sum.segment_sum_ordered = spy
    try:
        searcher.search_batch(batch, k=k)
    finally:
        ordered_sum.segment_sum_ordered = orig
    return seen


def ordered_sum_replay(searcher, batch) -> dict:
    """The largest ordered-sum call of ``batch`` on ``searcher`` (the
    packed reader's candidate groups), replayed: the kernel bit-equal to its plain
    version (a CPU index_add_), both timed beside the byte bound and one
    torch.segment_reduce over the same groups (the library yardstick,
    which the port never calls; whether it equals the kernel bit for bit is
    logged, not held)."""
    from rucene_tpu_torch.ops import ordered_sum

    calls = ordered_sum_calls(searcher, batch)
    if not calls:
        raise AssertionError("the batch made no ordered-sum call")
    args = max(calls, key=lambda c: c[0].numel())
    got = ordered_sum.segment_sum_ordered(*args)
    want = ordered_sum.segment_sum_ordered_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("the ordered-sum kernel differs from its plain version")
    values, seg_start, _gid = args
    starts = torch.nonzero(seg_start).flatten()
    lengths = torch.diff(torch.cat([starts, starts.new_tensor([values.numel()])]))

    def library(v, ln):
        return torch.segment_reduce(v, "sum", lengths=ln)

    n_bytes = ordered_sum.min_bytes(seg_start)
    out = {
        "calls": len(calls), "lanes": int(values.numel()), "groups": int(starts.numel()),
        "longest_group": int(lengths.max()), "max_abs_err": 0.0,
        "ms": cuda_ms(ordered_sum.segment_sum_ordered, args),
        "plain_ms": cuda_ms(ordered_sum.segment_sum_ordered_plain, args, reps=3, copies=1),
        "library_ms": cuda_ms(library, (values, lengths)),
        "library_equal": bool(torch.equal(library(values, lengths), got[: starts.numel()])),
        "bytes": n_bytes, "bound_ms": bound_ms(n_bytes),
    }
    log(f"ordered-sum kernel bit-equal to its plain version over {out['lanes']} lanes in "
        f"{out['groups']} groups (the largest of {out['calls']} calls; longest group "
        f"{out['longest_group']}): {out['ms']:.4f} ms, plain (CPU index_add_) "
        f"{out['plain_ms']:.3f} ms, torch.segment_reduce {out['library_ms']:.4f} ms (bit-equal: "
        f"{out['library_equal']}); must move {n_bytes} bytes, bound {out['bound_ms']:.4f} ms")
    return out


PLANE_MISSES = 20  # the plane-build replay's misses, as a serving call builds them


def plane_build_replay(searcher) -> dict:
    """A serving call's plane build, replayed on ``searcher``'s leaf:
    PLANE_MISSES resident terms of under 64 blocks (those a batch builds on
    a miss; the prewarm holds the larger ones) built by one
    build_position_planes call, bit-equal to the twin (build_position_plane
    a term on the card, the per-term path before the kernel). Timed: the
    whole call and the twin's 20 builds on the device (cuda_ms) and on the
    host's clock (enqueue, no wait), and the kernel alone under the
    profiler, beside the kernel's byte bound (ops/phrase_plane.min_bytes)."""
    from rucene_tpu_torch.ops import phrase_plane
    from rucene_tpu_torch.search import phrase_path

    leaf = searcher.reader.leaves[0]
    pf = leaf.packed.fields["body"]
    ordered, _res = searcher._plane_resident_terms(leaf, "body")
    small = [t for t in ordered if int(pf.block_count[pf.term_ord[t]]) < 64]
    names = [small[int(i)] for i in np.linspace(0, len(small) - 1, PLANE_MISSES)]
    terms = [phrase_path.plane_term(leaf, leaf.term_record("body", t)) for t in names]
    words = searcher._plane_words(leaf, "body")
    dev = leaf.device

    uploaded = [torch.from_numpy(b).to(dev.device) for b, *_ in terms]

    def per_term(dev, terms, words, uploaded=uploaded):
        return [phrase_plane.build_position_plane(dev, blk, w, s, words=words, fwin=f)
                for blk, (_b, w, s, f) in zip(uploaded, terms)]

    def old_path(dev, terms, words):  # each miss uploaded, then built
        return per_term(dev, terms, words, [torch.from_numpy(b).to(dev.device) for b, *_ in terms])

    def host_ms(fn, reps=10):
        fn(dev, terms, words)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn(dev, terms, words)
        took = (time.perf_counter() - t) * 1e3 / reps
        torch.cuda.synchronize()
        return took

    got = phrase_plane.build_position_planes(dev, terms, words)
    want = per_term(dev, terms, words)
    torch.cuda.synchronize()
    for t, (gp, go), (wp, wo) in zip(names, got, want):
        if not (torch.equal(gp, wp) and torch.equal(go, wo)):
            raise AssertionError(f"the plane-build kernel differs from its twin on {t!r}")
    _ms, _busy, top = profile_fn(lambda: phrase_plane.build_position_planes(dev, terms, words),
                                 passes=5, top=40)
    kernel = [ms for name, ms in top if "build_position_planes_kernel" in name]
    if not kernel:
        raise AssertionError("no build_position_planes_kernel in the profiler's kernels")
    n_bytes = phrase_plane.min_bytes(dev, terms, got)
    out = {
        "terms": len(terms), "blocks": int(sum(len(b) for b, *_ in terms)), "words": words,
        "max_abs_err": 0.0, "kernel_ms": kernel[0],
        "ms": cuda_ms(phrase_plane.build_position_planes, (dev, terms, words), reps=10, copies=1),
        "plain_ms": cuda_ms(per_term, (dev, terms, words), reps=3, copies=1),
        "host_ms": host_ms(phrase_plane.build_position_planes), "plain_host_ms": host_ms(old_path),
        "bytes": n_bytes, "bound_ms": bound_ms(n_bytes),
    }
    log(f"plane-build kernel bit-equal to its twin over {out['terms']} misses ({out['blocks']} "
        f"blocks, {words} words a doc): kernel {out['kernel_ms']:.4f} ms, whole call "
        f"{out['ms']:.4f} ms on the device and {out['host_ms']:.3f} ms on the host; "
        f"{len(terms)} per-term builds {out['plain_ms']:.4f} ms on the device and "
        f"{out['plain_host_ms']:.3f} ms on the host, uploads included; the kernel must move "
        f"{n_bytes} bytes, "
        f"bound {out['bound_ms']:.5f} ms")
    return out


def single_k2_call(searcher, batch):
    """The scoring decode call the searcher makes for ``batch``'s single-term
    rows on its packed leaf: (data, off, dbits, fbits, base, count, fid,
    cache) over the distinct blocks of those rows' work list."""
    from rucene_tpu_torch.search import flat_tables

    plans = [searcher._plan_for(q) for q in batch]
    rqs = [p.rq for p in plans]
    doc_freqs, stats = searcher._gather_stats(rqs, plans)
    b = len(rqs)
    weight, occur, *_ = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, 2, plans=plans
    )
    idx = [i for i, rq in enumerate(rqs)
           if searcher._pure_row(rq, weight[i]) and len(rq.clauses) == 1]
    rqs = [rqs[i] for i in idx]
    plans = [plans[i] for i in idx]
    weight, occur, *_ = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, len(rqs), 1, plans=plans
    )
    leaf = searcher.reader.leaves[0]
    bs, bc, fid = flat_tables.build_leaf_tables(leaf, rqs, len(rqs), 1, plans=plans)
    work = flat_tables.build_flat_work(bs, bc, weight, fid, occur)
    dd = flat_tables.dedupe_work(work[0], work[5], work[3])
    ublock, ufid = (work[0], work[3]) if dd is None else (dd[0], dd[2])
    dev = leaf.device
    blk = torch.from_numpy(ublock).to(dev.device).long()
    cache = flat_tables.build_leaf_cache(leaf, searcher.similarity, stats)
    return (
        dev.data, dev.blk_off[blk], dev.blk_doc_bits[blk], dev.blk_freq_bits[blk],
        dev.blk_base[blk], dev.blk_count[blk], torch.from_numpy(ufid).to(dev.device),
        torch.from_numpy(cache).to(dev.device),
    )


MAX_CALL_ROWS = 32  # rows of one combine call (ops/combine_tables.MAX_ROWS)


def flat_combine_call(searcher, rows, leaf=None):
    """The flat executor's inputs for ``rows`` on ``leaf`` (the searcher's
    first leaf by default), as the searcher builds them for the dense
    branch: (FlatQueryBatch, CombineBatches a 32-row chunk, target
    i32[W,128], sc f32[W,128], valid bool[W,128]), the lanes as
    decode_score_lanes returns them."""
    from rucene_tpu_torch.search import executor, flat_tables

    plans = [searcher._plan_for(q) for q in rows]
    rqs = [p.rq for p in plans]
    doc_freqs, stats = searcher._gather_stats(rqs, plans)
    b = len(rqs)
    t = max(len(rq.all_slots()) for rq in rqs)
    weight, occur, n_req, min_sh, _ma, _bo = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, t, plans=plans
    )
    leaf = searcher.reader.leaves[0] if leaf is None else leaf
    gdev = leaf.device
    bs, bc, fid = flat_tables.build_leaf_tables(leaf, rqs, b, t, plans=plans)
    work = flat_tables.build_flat_work(bs, bc, weight, fid, occur)[:6]
    cache = flat_tables.build_leaf_cache(leaf, searcher.similarity, stats)
    q = flat_tables.make_flat_batch(work, n_req, min_sh, cache, gdev, dedupe=True)
    combine = flat_tables.build_combine_batch(
        work, b, leaf.packed.blk_first_doc, leaf.packed.blk_last_doc, gdev.max_doc_padded,
        leaf.torch_device, q=q, buckets=gdev.buckets,
    )
    target, sc, valid = executor.decode_score_lanes(gdev, q)
    return q, combine, target, sc, valid


def head_band_combine_call(searcher, dense_q, leaf=None):
    """The combine call the searcher makes for the head-band pair rows
    ``dense_q`` on ``leaf`` (its first leaf by default) when they take the
    flat executor's dense branch: (FlatQueryBatch, CombineBatch, target,
    sc, valid) as flat_combine_call gives them; raises unless the rows are
    in the dense regime."""
    from rucene_tpu_torch.search import executor

    q, combine, target, sc, valid = flat_combine_call(searcher, dense_q, leaf)
    md = (searcher.reader.leaves[0] if leaf is None else leaf).device.max_doc_padded
    if not executor.dense_strategy(len(dense_q), md, q.wi_block.numel()):
        raise AssertionError("the head-band pair batch is not in the dense regime")
    return q, combine[0], target, sc, valid


def is_two_term(q) -> bool:
    """A BooleanQuery of two term clauses (the mix's OR and AND rows)."""
    return type(q).__name__ == "BooleanQuery" and len(q.rewrite().clauses) == 2


def row_route(searcher, q) -> str:
    """The route counters one row moves when served alone (a lone row
    takes its row class's route, as it does in the split batch)."""
    from rucene_tpu_torch.util.metrics import METRICS

    before = METRICS.snapshot()["counters"]
    searcher.search_batch([q], k=K)
    moved = counter_delta(METRICS.snapshot()["counters"], before)
    names = ("route.single", "route.plane_rows", "route.pair_rows", "route.flat",
             "search.phrase_device", "search.phrase_plane", "search.phrase_scalar_route")
    return "+".join(n.split(".", 1)[1] for n in names if moved.get(n, 0)) or "none"


def route_rows(searcher, batch) -> dict:
    """The rows of ``batch`` each of the tf-plane and pair routes takes
    (the searcher's own row flags, as its split reads them)."""
    from rucene_tpu_torch.search import flat_tables

    plans = [searcher._plan_for(q) for q in batch]
    idx = [i for i, p in enumerate(plans) if not searcher._phrase_device_eligible(p.rq)]
    rqs = [plans[i].rq for i in idx]
    doc_freqs, stats = searcher._gather_stats(rqs, [plans[i] for i in idx])
    t = max(len(rq.all_slots()) for rq in rqs)
    weight, *_ = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, len(rqs), t, plans=[plans[i] for i in idx]
    )
    single = [searcher._pure_row(rq, weight[j]) and len(rq.clauses) == 1 for j, rq in enumerate(rqs)]
    plane = searcher._plane_rows(rqs, [plans[i] for i in idx], single)
    pair = searcher._pair_rows(rqs, weight)
    return {
        "plane": [batch[i] for j, i in enumerate(idx) if plane[j]],
        "pair": [batch[i] for j, i in enumerate(idx) if pair[j] and not plane[j]],
    }


def route_peak(searcher, rows):
    """(peak bytes above what was allocated before, ms between events,
    route counters moved) of one search_batch of ``rows``."""
    from rucene_tpu_torch.util.metrics import METRICS

    searcher.search_batch(rows, k=K)  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = METRICS.snapshot()["counters"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    searcher.search_batch(rows, k=K)
    end.record()
    torch.cuda.synchronize()
    moved = counter_delta(METRICS.snapshot()["counters"], before)
    return (torch.cuda.max_memory_allocated() - base, start.elapsed_time(end),
            {k: v for k, v in moved.items() if k.startswith("route.") and v})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dataclasses import replace

    from rucene_tpu_torch import IndexSearcher
    from rucene_tpu_torch.codec.device import (
        add_tf_planes,
        build_device_segment,
        device_bytes,
        plane_policy,
    )
    from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
    from rucene_tpu_torch.ops import cuda_build, cuda_combine, cuda_decode
    from rucene_tpu_torch.ops import phrase_plane as phrase_plane_ops
    from rucene_tpu_torch.search import phrase_path
    from rucene_tpu_torch.search import searcher as searcher_mod
    from rucene_tpu_torch.util.metrics import METRICS
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_hitcheck import assert_topdocs_strict  # numpy-only test helper

    dev = torch.device("cuda", 0)
    n_docs = int(os.environ.get("BENCH_DOCS", 1_000_000))

    # 1. toolchain and card
    nvcc = subprocess.run(
        [cuda_build._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    card = card_line()
    log(f"nvcc: {nvcc}")
    from importlib import metadata

    try:
        triton = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton = "absent"
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, triton {triton}")
    log(f"card: {card}; torch sees {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    cuda_build.kernels()
    log(f"kernels built in {time.perf_counter() - t:.1f}s; nvcc said:\n{cuda_build.build_log.strip()}")

    # 2. corpus -> packed index -> reader
    t = time.perf_counter()
    texts, vocab, probs = build_corpus(n_docs)
    queries = build_queries(N_QUERIES, vocab, probs, phrase_texts=texts[:5000])
    queries_no_phrase = build_queries(N_QUERIES, vocab, probs)
    n_phrase = sum(type(q).__name__ == "PhraseQuery" for q in queries)
    mixed_q = mixed_queries(texts[:5000], vocab, probs)  # phase 10's rows
    extras_q, head_extras_q = extras_queries(vocab, probs)
    filter_a, filter_b, host_q = filter_queries(texts[:5000], vocab, probs)  # phase 11's rows
    surface_q = surface_queries(texts[:5000], vocab, probs)  # phase 13's rows
    sharded_q = sharded_queries(texts[:5000], vocab, probs)  # phase 14's rows
    sum_q = sum_order_queries(vocab, probs)  # phase 14's and 16's many-word rows
    packed = pack_corpus(texts, fields_seed=FIELDS_SEED)
    del texts
    from rucene_tpu_torch.util.packing import EF_TAG

    n_ef = int((packed.blk_doc_bits >= EF_TAG).sum())
    tag = packed.fields["tag"]
    log(
        f"packed {n_docs} docs in {time.perf_counter() - t:.1f}s (corpus, queries and packing): "
        f"{packed.num_blocks} blocks ({n_ef} Elias-Fano, {int(tag.block_count.sum())} of the "
        f"{len(tag.terms)} tag terms), {len(packed.data)} words, {len(packed.points['ts'][0])} ts points"
    )
    reader = IndexReader([SegmentSnapshot("bench", packed)])
    searcher = IndexSearcher(reader, device=dev)
    leaf = reader.leaves[0]
    # at full size the device must answer every phrase row
    full = n_docs >= max(searcher.PHRASE_SCALAR_MAX_DOCS, searcher.PHRASE_PLANE_MIN_DOCS)

    METRICS.reset()  # counts from here to the read below are the main path's
    # 3. decoded residency through the decode kernel
    t = time.perf_counter()
    gdev = leaf.device
    torch.cuda.synchronize()
    log(f"residency built in {time.perf_counter() - t:.2f}s "
        f"(freqs {gdev.freqs_dec.dtype}, {torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated)")
    cpu_seg = build_device_segment(packed, "cpu")
    t = time.perf_counter()
    want = cuda_decode.decode_blocks_plain(
        cpu_seg.data, cpu_seg.blk_off, cpu_seg.blk_doc_bits, cpu_seg.blk_freq_bits,
        cpu_seg.blk_base, cpu_seg.blk_count, freq_dtype=gdev.freqs_dec.dtype,
    )
    log(f"CPU twin decoded every block in {time.perf_counter() - t:.1f}s")
    k1_err = 0
    for got, ref in zip((gdev.docs_dec, gdev.freqs_dec, gdev.norm_dec), want):
        got = got.cpu()
        if not torch.equal(got, ref):
            bad = (got != ref).any(dim=1).nonzero().flatten()[:5].tolist()
            raise AssertionError(f"decode kernel differs from its twin at blocks {bad}")
        k1_err = max(k1_err, int((got.long() - ref.long()).abs().max()))
    log(f"decode kernel bit-equal to the twin over all {packed.num_blocks} blocks")
    tf_planes = gdev.tf_planes
    if tf_planes is None:
        raise AssertionError("the decoded residency holds no tf planes")
    tf_plane_mib = tf_planes.numel() / 2**20
    _budget, df_min = plane_policy(gdev.max_doc_padded, device_bytes(gdev) - tf_planes.numel())
    torch.cuda.synchronize()
    t = time.perf_counter()
    rebuilt, slots = add_tf_planes(replace(gdev, tf_planes=None), packed)
    torch.cuda.synchronize()
    tf_plane_s = time.perf_counter() - t
    if slots != leaf.plane_slots or not torch.equal(rebuilt.tf_planes, tf_planes):
        raise AssertionError("a rebuild of the tf planes differs from the residency's")
    del rebuilt
    log(f"tf planes: {tf_planes.shape[0]} terms with df >= {df_min}, {tf_plane_mib:.0f} MiB, "
        f"built in {tf_plane_s:.3f}s (a timed rebuild, equal to the residency's)")
    t = time.perf_counter()
    n_planes = searcher.prewarm_phrase_planes()
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t
    plane_mib = phrase_path._PLANE_CACHE.nbytes / 2**20
    log(f"prewarmed {n_planes} phrase planes in {prewarm_s:.2f}s: {plane_mib:.0f} MiB "
        f"({searcher._plane_words(leaf, 'body')} words a doc; plane budget "
        f"{searcher._plane_budget_bytes(leaf) / 2**30:.1f} GiB)")

    # 4. the bench's whole mix, pipelined, then the mix without phrases
    torch.cuda.reset_peak_memory_stats()
    before = METRICS.snapshot()["counters"]
    t = time.perf_counter()
    for i in range(0, len(queries), BATCH):  # warm pass
        searcher.search_batch(queries[i : i + BATCH], k=K)
    log(f"warm pass of the whole mix in {time.perf_counter() - t:.2f}s")
    qps, mix_results = serve(searcher, queries)
    torch.cuda.synchronize()
    mix_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"bench mix: {qps:.1f} QPS ({N_QUERIES} queries, {n_phrase} phrase rows, batch {BATCH}, "
        f"k={K}) on {card}; peak device memory {mix_peak:.2f} GiB")
    mix_counters = counter_delta(METRICS.snapshot()["counters"], before)
    phrase_gates(mix_counters, N_QUERIES, n_phrase, N_QUERIES, full, "decoded mix")
    split = n_docs >= searcher_mod.SPLIT_MIN_DOCS  # else mixed batches stay whole
    two_term = sum(is_two_term(q) for q in queries)
    pair_rows, plane_rows = route_gates(mix_counters, two_term, N_QUERIES, split, "decoded mix")
    before = METRICS.snapshot()["counters"]
    for i in range(0, len(queries_no_phrase), BATCH):  # warm pass
        searcher.search_batch(queries_no_phrase[i : i + BATCH], k=K)
    qps_no_phrase, _ = serve(searcher, queries_no_phrase)
    log(f"bench mix without phrases: {qps_no_phrase:.1f} QPS on {card}")
    counters = METRICS.snapshot()["counters"]  # the main path ends here
    route_gates(counter_delta(counters, before), sum(is_two_term(q) for q in queries_no_phrase),
                N_QUERIES, split, "decoded mix without phrases")
    launches = launches_in(counters)
    log(f"kernel launches on the decoded path: {launches}")
    log("routes: " + " ".join(
        f"{k}={v}" for k, v in sorted(counters.items()) if not k.startswith("kernel.")
    ))
    if launches["decode_blocks"] <= 0:
        raise AssertionError("kernel decode_blocks never launched on the decoded path")
    plane_launches = counters.get(phrase_plane_ops.LAUNCH_COUNTER, 0)
    if n_planes and plane_launches <= 0:
        raise AssertionError("the plane-build kernel never launched on the decoded path")
    if split and counters.get("route.single", 0) <= 0:
        raise AssertionError("no mix row took the single-term route on the decoded reader")

    # 5. peak memory and time of the first batch's plane rows and pair rows
    batch = queries[:BATCH]
    for name, rows in route_rows(searcher, batch).items():
        if not rows:
            log(f"first batch: no {name} rows")
            continue
        peak, ms, moved = route_peak(searcher, rows)
        per = peak / (len(rows) * gdev.max_doc_padded)
        log(f"first batch's {len(rows)} {name} rows served alone: peak {peak / 2**20:.1f} MiB above "
            f"the resident set ({per:.1f} bytes a (row, doc)), {ms:.3f} ms between events; "
            f"routes {moved}")

    # 6. 16 queries on the CPU, hit for hit: two of each of the mix's 8 kinds
    sample_idx = [i for kind in range(8) for i in (kind, kind + 8 * 31)]
    routes = {i: row_route(searcher, queries[i]) for i in sample_idx}
    cpu_reader = IndexReader([SegmentSnapshot("bench", packed)])
    cpu_searcher = IndexSearcher(cpu_reader, device="cpu")
    t = time.perf_counter()
    cpu_hits = cpu_searcher.search_batch([queries[i] for i in sample_idx], k=K)
    for i, want_td in zip(sample_idx, cpu_hits):
        assert_topdocs_strict(mix_results[i], want_td)
    log(f"16 queries ({', '.join(sorted({type(queries[i]).__name__ for i in sample_idx}))}) "
        f"match the CPU run hit for hit ({time.perf_counter() - t:.1f}s); routes on the card: "
        + ", ".join(f"{i}:{routes[i]}" for i in sample_idx))

    # 7. the decode kernel against its plain version on the card, and times
    seg = build_device_segment(packed, dev)
    tables = (seg.data, seg.blk_off, seg.blk_doc_bits, seg.blk_freq_bits, seg.blk_base, seg.blk_count)
    fdt = gdev.freqs_dec.dtype
    k1_bytes = cuda_decode.min_bytes(
        seg.blk_off, seg.blk_doc_bits, seg.blk_freq_bits, seg.blk_count,
        lane_bytes=4 + torch.empty(0, dtype=fdt).element_size() + 1,
    )
    k1_ms = cuda_ms(cuda_decode.decode_blocks, (*tables, fdt), reps=8, copies=2)
    k1_plain_ms = cuda_ms(cuda_decode.decode_blocks_plain, (*tables, fdt), reps=2, copies=1)
    log(f"decode kernel: {k1_ms:.4f} ms over {packed.num_blocks} blocks, twin {k1_plain_ms:.3f} ms; "
        f"must move {k1_bytes} bytes, bound {bound_ms(k1_bytes):.4f} ms")
    del seg, tables

    # 8. packed serving at full size: a second reader over the same segment
    dense_q = head_pair_queries(vocab)
    packed_searcher, packed_qps, packed_results, p8_launches = serve_packed(
        packed, queries, dense_q, dev, card, split, n_phrase, full
    )
    for i in sample_idx:
        got_td, want_td = packed_results[i], mix_results[i]
        if got_td.total_hits != want_td.total_hits or got_td.score_docs != want_td.score_docs:
            raise AssertionError(f"packed query {i} differs from the decoded run")
    log("16 packed queries (two of each kind) equal the decoded run's bit for bit "
        "(docs, f32 scores, total_hits)")

    # 9. the head-band batch's combine call on the packed reader against
    # its plain version on the card, and the library yardstick
    _q, cb, target, sc, _valid = head_band_combine_call(packed_searcher, dense_q)
    pdev = packed_searcher.reader.leaves[0].device
    b = len(dense_q)
    args = (cb.bucket_ptr, target, sc, cb.e_item, cb.e_row, cb.e_enc)
    shape = (b, pdev.max_doc_padded)
    out_k = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))
    out_p = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))
    cuda_combine.combine_lanes(*args, *out_k)
    cuda_combine.combine_lanes_plain(*args, *out_p)
    torch.cuda.synchronize()
    k3_err = k3_bit_equal(out_k, out_p, "on the head-band call")
    log(f"combine kernel bit-equal to the twin ({int(cb.e_item.numel())} entries); "
        f"{int(cb.residue.numel())} residue items go to the executor's residue passes")
    k3_ms = cuda_ms(cuda_combine.combine_lanes, (*args, *out_k))
    k3_plain_ms = cuda_ms(cuda_combine.combine_lanes_plain, (*args, *out_p), reps=2, copies=1)
    # the library yardstick: zeroed planes, then index_add_ of every valid
    # lane of the entries' items at row * md + doc (built before the timer)
    md = pdev.max_doc_padded
    items = torch.unique(cb.e_item.long())
    item_row = torch.zeros(target.shape[0], dtype=torch.int64, device=dev)
    item_row[cb.e_item.long()] = cb.e_row.long()
    item_enc = torch.zeros(target.shape[0], dtype=torch.int32, device=dev)
    item_enc[cb.e_item.long()] = cb.e_enc
    lanes = target[items].long()
    keep = lanes < md
    flat = (item_row[items][:, None] * md + lanes)[keep]
    lane_sc = sc[items][keep]
    lane_enc = item_enc[items][:, None].expand_as(lanes)[keep]
    out_l = (torch.empty(shape, device=dev), torch.empty(shape, dtype=torch.int32, device=dev))

    def library(out_s, out_c, flat, lane_sc, lane_enc):
        out_s.zero_()
        out_c.zero_()
        out_s.view(-1).index_add_(0, flat, lane_sc)
        out_c.view(-1).index_add_(0, flat, lane_enc)

    library(*out_l, flat, lane_sc, lane_enc)
    torch.cuda.synchronize()
    if not torch.equal(out_l[1], out_k[1]):
        raise AssertionError("the index_add_ yardstick's counts differ from the combine kernel's")
    k3_lib_ms = cuda_ms(library, (*out_l, flat, lane_sc, lane_enc))
    k3_bytes = cuda_combine.min_bytes(target, cb.e_item, cb.bucket_ptr.numel() - 1, b)
    log(f"combine kernel: {k3_ms:.4f} ms, twin {k3_plain_ms:.3f} ms, index_add_ yardstick "
        f"{k3_lib_ms:.4f} ms ({int(flat.numel())} lanes of {items.numel()} items); "
        f"must move {k3_bytes} bytes, bound {bound_ms(k3_bytes):.4f} ms")
    del _q, cb, args, out_k, out_p, out_l, target, sc, _valid, flat, lane_sc, lane_enc

    # then the scoring decode of the first packed batch's single-term rows
    # against its plain version on the card
    k2_args = single_k2_call(packed_searcher, queries[:BATCH])
    got = cuda_decode.decode_score_blocks(*k2_args)
    want = cuda_decode.decode_score_blocks_plain(*k2_args)
    torch.cuda.synchronize()
    for name, g, w in zip(("docs", "freqs", "cval"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"scoring decode kernel {name} differ from the twin")
    k2_err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    k2_ms = cuda_ms(cuda_decode.decode_score_blocks, k2_args)
    k2_plain_ms = cuda_ms(cuda_decode.decode_score_blocks_plain, k2_args, reps=5, copies=1)
    k2_bytes = cuda_decode.min_bytes(*k2_args[1:4], k2_args[5], lane_bytes=12, fid=k2_args[6])
    log(f"scoring decode kernel bit-equal to the twin over {k2_args[1].shape[0]} distinct blocks: "
        f"{k2_ms:.4f} ms, twin {k2_plain_ms:.4f} ms; must move {k2_bytes} bytes, "
        f"bound {bound_ms(k2_bytes):.4f} ms")
    # then the largest ordered sum of the score-combine rows' candidate
    # call against its plain version (a CPU index_add_) and
    # torch.segment_reduce
    k4 = ordered_sum_replay(packed_searcher, extras_q)
    # then a serving call's plane build on the decoded reader against its
    # twin, the per-term builds
    k5 = plane_build_replay(searcher)

    # 10. mixed phrase rows and score-combine rows on both readers
    p10 = serve_combine_rows(
        {"decoded": searcher, "packed": packed_searcher}, cpu_searcher, mixed_q, extras_q,
        head_extras_q, card, full,
    )

    # 11. filter rows and host rows on both readers
    p11 = serve_filter_rows(
        {"decoded": searcher, "packed": packed_searcher}, cpu_searcher, filter_a, filter_b,
        host_q, card, full,
    )

    # 13. the query surface on both readers: sorted search, collapse, spans
    # and synonyms, rescoring, explain and the query-string parser
    mix_pairs = [(queries[i], *mix_results[i].score_docs[0]) for i in (0, 3, 5, 7)]
    p13 = serve_query_surface(
        {"decoded": searcher, "packed": packed_searcher}, cpu_searcher, surface_q, mix_pairs, card,
    )

    # 14. sharded search on both readers: the one segment split over 4 shards
    p14, p14_launches = serve_sharded(
        {"decoded": searcher, "packed": packed_searcher}, cpu_searcher, queries,
        {"decoded": mix_results, "packed": packed_results}, dense_q, sharded_q, card, dev, sum_q,
    )

    # 15. the port's entry points on both readers: the bench's serving loop,
    # the examples, the NRT bench and a profile capture
    p15, p15_launches = serve_drivers(
        {"decoded": searcher, "packed": packed_searcher}, queries,
        {"decoded": mix_results, "packed": packed_results}, dense_q, card,
    )

    # 16. block-max pruning on both readers: the chunk pass under the dense
    # top-k, WAND on the bench corpus, and a skewed corpus where it fires
    p16, p16_launches = serve_pruning(
        {"decoded": searcher, "packed": packed_searcher}, queries,
        {"decoded": mix_results, "packed": packed_results}, dense_q, vocab, probs, card, dev,
        cpu_searcher, sum_q,
    )
    del cpu_reader, cpu_searcher

    # 12. NRT on the card, after releasing phases 1-11's device state
    del searcher, packed_searcher, reader, leaf, gdev, tf_planes, pdev, k2_args, got, want
    del items, item_row, item_enc, lanes, keep
    from rucene_tpu_torch.search.cache import DEVICE_PLANE_CACHE

    phrase_path._PLANE_CACHE.clear()
    DEVICE_PLANE_CACHE.clear()
    p12 = serve_nrt(dev, card)
    nrt_launches = p12.pop("launches")
    for r in p12["multi_process"]["ranks"]:  # the spawned processes' launches
        for name, n in r["launches"].items():
            nrt_launches[name] += n
    k3_err = max(k3_err, p12["replay"]["combine_lanes"]["max_abs_err"],
                 *(p14[f"{kind}_replay"]["combine_lanes"]["max_abs_err"]
                   for kind in ("decoded", "packed")))

    phases = (launches, p8_launches, p10["launches"], p11["launches"], p13["launches"],
              nrt_launches, p14_launches, p15_launches, p16_launches)
    total = {name: sum(p.get(name, 0) for p in phases) for name in launch_counters()}
    for name, n in total.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    print(json.dumps({"kernels": [
        {"name": "decode_blocks", "route": "cuda", "source": K1_SOURCE,
         "replaces": "rucene_tpu/ops/pallas_decode.py:256",
         "launches": total["decode_blocks"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": bound_ms(k1_bytes),
         "bound_by": "bytes", "library_ms": None},
        {"name": "decode_score_blocks", "route": "cuda", "source": K2_SOURCE,
         "replaces": "rucene_tpu/ops/pallas_decode.py:330",
         "launches": total["decode_score_blocks"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": bound_ms(k2_bytes),
         "bound_by": "bytes", "library_ms": None},
        {"name": "combine_lanes", "route": "cuda", "source": K3_SOURCE,
         "replaces": "rucene_tpu/ops/pallas_combine.py:114",
         "launches": total["combine_lanes"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": bound_ms(k3_bytes),
         "bound_by": "bytes", "library_ms": k3_lib_ms},
        {"name": "segment_sum_ordered", "route": "cuda", "source": K4_SOURCE,
         "replaces": "none: the port's own kernel (ordered sums where the reference's "
                     "XLA scatters keep their order)",
         "launches": total["segment_sum_ordered"], "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": "bytes", "library_ms": k4["library_ms"]},
        {"name": "build_position_planes", "route": "cuda", "source": K5_SOURCE,
         "replaces": "none: the port's own kernel (a leaf's missing position planes in one "
                     "pass, where the reference builds each with XLA ops)",
         "launches": plane_launches, "max_abs_err": k5["max_abs_err"],
         "ms": k5["kernel_ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
    ], "qps": qps, "packed_qps": packed_qps, "qps_no_phrase": qps_no_phrase,
        "n_docs": n_docs, "n_phrase_rows": n_phrase, "prewarm_planes": n_planes,
        "prewarm_s": prewarm_s, "plane_mib": plane_mib, "mix_peak_gib": mix_peak,
        "tf_plane_mib": tf_plane_mib, "tf_plane_s": tf_plane_s, "pair_rows": pair_rows,
        "plane_rows": plane_rows, "mixed_rows": len(mixed_q),
        "mixed_qps": p10["decoded_mixed_qps"], "mixed_packed_qps": p10["packed_mixed_qps"],
        "extras_qps": p10["decoded_extras_qps"], "extras_packed_qps": p10["packed_extras_qps"],
        "mixed_chunk_bytes_per_row_doc": p10["mixed_chunk_bytes_per_row_doc"],
        "mixed_kernel_ms_busy": [p10["decoded_mixed_profile"], p10["packed_mixed_profile"]],
        "extras_kernel_ms_busy": [p10["decoded_extras_profile"], p10["packed_extras_profile"]],
        "filter_qps": p11["decoded_qps"], "filter_packed_qps": p11["packed_qps"],
        "filter_kernel_ms_busy": [p11["decoded_profile"], p11["packed_profile"]],
        "filter_dense_bytes_per_row_doc": p11["dense_bytes_per_row_doc"],
        "filter_planes": p11["planes"], "host_rows": len(host_q),
        "host_s": [p11["decoded_host_s"], p11["packed_host_s"]],
        "query_surface": {"decoded": p13["decoded"], "packed": p13["packed"]},
        "nrt": p12, "nrt_launches": nrt_launches, "sharded": p14,
        "sharded_launches": p14_launches, "drivers": p15, "drivers_launches": p15_launches,
        "topk": p16["topk"], "pruning": p16["pruning"], "pruning_launches": p16_launches,
        "sum_order": p16["sum_order"], "ordered_sum": k4, "plane_build": k5}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:  # one process of phase 12's multi-process stage
        sys.exit(mp_worker(sys.argv[2:]))
    sys.exit(main())

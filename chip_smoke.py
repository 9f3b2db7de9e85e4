"""GPU smoke of the PyTorch/CUDA port (rucene_tpu_torch) on one card.

    python3 chip_smoke.py            # 1M-doc bench corpus (BENCH_DOCS overrides)

Builds the CUDA kernels and the native library from this checkout, then:
  1. prints the toolchain and the card (name, power limit);
  2. builds the bench's Zipf corpus (bench.py's generator and seed,
     reimplemented here so nothing imports rucene_tpu or jax), its query
     mix with phrase rows (bigrams from the first 5,000 docs, as bench.py
     draws them) and the same mix without them, packs the corpus (each doc
     also with an IntPoint ``ts`` and, one in 4, a StringField ``tag``,
     pack_corpus) and opens it with the port's IndexReader;
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
     against its plain version, times both, and the combine's library
     yardstick (zeroed planes plus index_add_ of the items' valid lanes,
     which the port never calls); then the scoring decode of the first
     packed batch's single-term rows against its plain version: docs,
     freqs and cval bit-equal; times both;
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
     filter planes cached and the host stage's seconds.
Each kernel's bound is the bytes it must move at the replayed shape (its
wrapper module's min_bytes) over the card's 3.35 TB/s. Kernel times are
the mean of back-to-back runs over rotating copies of their inputs (cold
L2), enqueued behind a sleep so that host launch time is not counted
(cuda_ms). Any failure raises. The last three lines are the kernels'
JSON record (with qps, packed_qps, qps_no_phrase, tf_plane_mib,
pair_rows, plane_rows, phase 10's mixed_qps, mixed_packed_qps,
extras_qps, mixed_rows and the mixed chunk's bytes a (row, doc), and
phase 11's filter_qps, filter_packed_qps, filter_kernel_ms_busy,
filter_planes and host_rows), the card's name and power limit, and the
device line.
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

K = 100
BATCH = 256
N_QUERIES = 512
K1_SOURCE = "rucene_tpu_torch/csrc/decode.cu"
K2_SOURCE = K1_SOURCE
K3_SOURCE = "rucene_tpu_torch/csrc/combine.cu"
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


# --- the bench workload (bench.py:38-172) ------------------------------------


def zipf_vocab(vocab_size: int = 20000):
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    vocab = np.array([f"w{i}" for i in range(vocab_size)])
    return vocab, probs


def build_corpus(n_docs: int, vocab_size: int = 20000, seed: int = 7):
    rng = np.random.default_rng(seed)
    vocab, probs = zipf_vocab(vocab_size)
    lengths = rng.integers(8, 64, size=n_docs)
    token_ids = rng.choice(vocab_size, size=int(lengths.sum()), p=probs)
    texts = []
    off = 0
    for n in lengths:
        texts.append(" ".join(vocab[token_ids[off : off + n]]))
        off += n
    return texts, vocab, probs


def sample_bigrams(texts, n: int, seed: int = 77) -> list[tuple[str, str]]:
    """bench.sample_bigrams: consecutive word pairs drawn from corpus text."""
    rng = np.random.default_rng(seed)
    out = []
    if not texts:
        return out
    for _ in range(n * 4):
        words = texts[int(rng.integers(0, len(texts)))].split()
        if len(words) < 2:
            continue
        j = int(rng.integers(0, len(words) - 1))
        out.append((words[j], words[j + 1]))
        if len(out) >= n:
            break
    return out


def build_queries(n_queries: int, vocab, probs, seed: int = 13, phrase_texts=None):
    """bench.build_queries: 3/8 single-term, 2/8 two-term OR, 2/8 two-term
    AND from the mid-frequency band, and 1/8 two-term exact phrases drawn
    from phrase_texts (without phrase texts, AND rows take their place)."""
    from rucene_tpu_torch import BooleanQuery, PhraseQuery, Term, TermQuery

    rng = np.random.default_rng(seed)
    band = np.arange(10, min(5000, len(vocab)))
    band_p = probs[band] / probs[band].sum()
    bigrams = sample_bigrams(phrase_texts or [], (n_queries + 7) // 8)
    queries = []
    bi = 0
    for i in range(n_queries):
        kind = i % 8
        t1 = vocab[rng.choice(band, p=band_p)]
        t2 = vocab[rng.choice(band, p=band_p)]
        if kind == 7 and bigrams:
            w1, w2 = bigrams[bi % len(bigrams)]
            bi += 1
            queries.append(PhraseQuery("body", [w1, w2]))
        elif kind in (0, 1, 2):
            queries.append(TermQuery(Term("body", t1)))
        elif kind in (3, 4):
            q = BooleanQuery()
            q.should(TermQuery(Term("body", t1)))
            q.should(TermQuery(Term("body", t2)))
            queries.append(q)
        else:
            q = BooleanQuery()
            q.must(TermQuery(Term("body", t1)))
            q.must(TermQuery(Term("body", t2)))
            queries.append(q)
    return queries


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


YEAR_S = 365 * 86400  # the ts field holds a second of one year
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


def pack_corpus(texts, seed: int = 23):
    """The packed segment of ``texts`` in ``body``, each doc with an
    IntPoint ``ts`` (a second of one year, uniform) and, on one doc in 4, a
    StringField ``tag`` (c000-c999, uniform), drawn from ``seed``: the
    time and category a content search filters by."""
    from rucene_tpu_torch import Document, IntPoint, StringField, TextField
    from rucene_tpu_torch.codec.postings import pack_segment
    from rucene_tpu_torch.index.memory import SegmentBuffer

    rng = np.random.default_rng(seed)
    ts = rng.integers(0, YEAR_S, len(texts)).tolist()
    tag = rng.integers(0, 1000, len(texts)).tolist()
    tagged = (rng.random(len(texts)) < 0.25).tolist()
    buf = SegmentBuffer()
    docs = []
    for i, t in enumerate(texts):
        d = Document()
        d.add(TextField("body", t))
        d.add(IntPoint("ts", ts[i]))
        if tagged[i]:
            d.add(StringField("tag", f"c{tag[i]:03d}"))
        docs.append(d)
    buf.add_documents_bulk(docs)
    del docs
    return pack_segment(buf.finish())


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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pending = []
        for _ in range(passes):
            for i in range(0, len(queries), BATCH):
                pending.append(searcher.search_batch_async(queries[i:i + BATCH], k=K))
                while len(pending) >= 3:
                    pending.pop(0)()
        while pending:
            pending.pop(0)()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total = sum(b - a for a, b in spans)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in events:
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return total / 1e3 / passes, busy / wall_us, [[n, us / 1e3 / passes] for n, us in ranked]


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_MS


def serve(searcher, queries, depth: int = 3, min_s: float = 5.0, max_reps: int = 10):
    """Pipelined passes over the queries (batch BATCH); returns (qps, last
    pass's TopDocs)."""
    from collections import deque

    t0 = time.perf_counter()
    reps = 0
    pending: deque = deque()
    results = []
    while reps < 3 or (time.perf_counter() - t0 < min_s and reps < max_reps):
        results = []
        for i in range(0, len(queries), BATCH):
            pending.append(searcher.search_batch_async(queries[i : i + BATCH], k=K))
            while len(pending) >= depth:
                results.extend(pending.popleft()())
        while pending:
            results.extend(pending.popleft()())
        reps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return reps * len(queries) / wall, results


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
    Returns (searcher, qps, last pass's TopDocs, K1 launches, K2
    launches, K3 launches)."""
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
            f"({phrase_path._plane_cache_bytes() / 2**20:.0f} MiB) through the decode kernel")
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
    return searcher, qps, results, k1, k2, k3


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
        for kname, counter in (("decode_blocks", cuda_decode.LAUNCH_COUNTER),
                               ("decode_score_blocks", cuda_decode.SCORE_LAUNCH_COUNTER),
                               ("combine_lanes", cuda_combine.LAUNCH_COUNTER)):
            out["launches"][kname] = (out["launches"].get(kname, 0) + mixed.get(counter, 0)
                                      + extras.get(counter, 0))
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
        for kname, counter in (("decode_blocks", cuda_decode.LAUNCH_COUNTER),
                               ("decode_score_blocks", cuda_decode.SCORE_LAUNCH_COUNTER),
                               ("combine_lanes", cuda_combine.LAUNCH_COUNTER)):
            out["launches"][kname] = out["launches"].get(kname, 0) + sum(
                c.get(counter, 0) for c in (a_cnt, b_cnt, c_cnt)
            )
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


def head_band_combine_call(searcher, dense_q):
    """The combine call the searcher makes for the head-band pair rows
    ``dense_q`` on its (packed) leaf: (FlatQueryBatch, CombineBatch,
    target i32[W,128], sc f32[W,128], valid bool[W,128]), the lanes as
    decode_score_lanes returns them."""
    from rucene_tpu_torch.search import executor, flat_tables

    plans = [searcher._plan_for(q) for q in dense_q]
    rqs = [p.rq for p in plans]
    doc_freqs, stats = searcher._gather_stats(rqs, plans)
    b = len(rqs)
    weight, occur, n_req, min_sh, _ma, _bo = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, 2, plans=plans
    )
    leaf = searcher.reader.leaves[0]
    gdev = leaf.device
    bs, bc, fid = flat_tables.build_leaf_tables(leaf, rqs, b, 2, plans=plans)
    work = flat_tables.build_flat_work(bs, bc, weight, fid, occur)[:6]
    if not executor.dense_strategy(b, gdev.max_doc_padded, len(work[0])):
        raise AssertionError("the head-band pair batch is not in the dense regime")
    cache = flat_tables.build_leaf_cache(leaf, searcher.similarity, stats)
    q = flat_tables.make_flat_batch(work, n_req, min_sh, cache, gdev, dedupe=True)
    cb = flat_tables.build_combine_batch(
        work, b, leaf.packed.blk_first_doc, leaf.packed.blk_last_doc, gdev.max_doc_padded,
        leaf.torch_device,
    )[0]
    target, sc, valid = executor.decode_score_lanes(gdev, q)
    return q, cb, target, sc, valid


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
    packed = pack_corpus(texts)
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
    plane_mib = phrase_path._plane_cache_bytes() / 2**20
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
    launches = {"decode_blocks": counters.get(cuda_decode.LAUNCH_COUNTER, 0)}
    log(f"kernel launches on the decoded path: {launches}")
    log("routes: " + " ".join(
        f"{k}={v}" for k, v in sorted(counters.items()) if not k.startswith("kernel.")
    ))
    if launches["decode_blocks"] <= 0:
        raise AssertionError("kernel decode_blocks never launched on the decoded path")
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
    packed_searcher, packed_qps, packed_results, k1_packed, k2_launches, k3_launches = serve_packed(
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
    if not torch.equal(out_k[1], out_p[1]):
        raise AssertionError("combine kernel counts differ from the twin")
    k3_err = float((out_k[0] - out_p[0]).abs().max())
    tol = 1e-5 * float(out_p[0].abs().max().clamp(min=1.0))
    if k3_err > tol:
        raise AssertionError(f"combine kernel scores differ from the twin by {k3_err} > {tol}")
    log(f"combine kernel matches the twin ({int(cb.e_item.numel())} entries, "
        f"max abs err {k3_err:.3g}, tolerance 1e-5 relative); "
        f"{int(cb.residue.numel())} residue items go to the executor's scatter")
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
    del cpu_reader, cpu_searcher

    print(json.dumps({"kernels": [
        {"name": "decode_blocks", "route": "cuda", "source": K1_SOURCE,
         "replaces": "rucene_tpu/ops/pallas_decode.py:256",
         "launches": launches["decode_blocks"] + k1_packed + p10["launches"]["decode_blocks"]
         + p11["launches"]["decode_blocks"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": bound_ms(k1_bytes),
         "bound_by": "bytes", "library_ms": None},
        {"name": "decode_score_blocks", "route": "cuda", "source": K2_SOURCE,
         "replaces": "rucene_tpu/ops/pallas_decode.py:330",
         "launches": k2_launches + p10["launches"]["decode_score_blocks"]
         + p11["launches"]["decode_score_blocks"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": bound_ms(k2_bytes),
         "bound_by": "bytes", "library_ms": None},
        {"name": "combine_lanes", "route": "cuda", "source": K3_SOURCE,
         "replaces": "rucene_tpu/ops/pallas_combine.py:114",
         "launches": k3_launches + p10["launches"]["combine_lanes"] + p11["launches"]["combine_lanes"],
         "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": bound_ms(k3_bytes),
         "bound_by": "bytes", "library_ms": k3_lib_ms},
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
        "host_s": [p11["decoded_host_s"], p11["packed_host_s"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

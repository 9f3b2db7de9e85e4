"""The port on the card: each CUDA kernel against its plain PyTorch twin,
and the term/boolean slice and the phrase routes served on the card
against the same rows on the CPU (whose twins tests/test_torch_search.py
and tests/test_torch_phrase_path.py hold against rucene_tpu).

Marked ``gpu``: each test skips without a CUDA device (a CUDA kernel has no
CPU mode). The module imports no jax, so it also runs on a card host
without it:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q
"""

import numpy as np
import pytest
import torch

import rucene_tpu_torch as T
from rucene_tpu_torch.codec.device import build_device_segment
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.ops import cuda_decode
from rucene_tpu_torch.ops.combine_tables import SPARSE_SPAN
from rucene_tpu_torch.ops.cuda_combine import C_BUCKET, combine_lanes, combine_lanes_plain
from rucene_tpu_torch.ops.cuda_decode import (
    decode_blocks,
    decode_blocks_plain,
    decode_score_blocks,
    decode_score_blocks_plain,
)
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.search import searcher as searcher_mod
from rucene_tpu_torch.search.flat_tables import build_combine_batch
from rucene_tpu_torch.util.metrics import METRICS
from rucene_tpu_torch.util.packing import EF_TAG
from torch_hitcheck import assert_batches_strict
from torch_kernel_data import (
    combine_arrays,
    combine_entries,
    port_segment,
    synthetic_blocks,
    synthetic_items,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ef_heavy", "plain"])
@pytest.mark.parametrize("freq_dtype", [torch.int16, torch.int32])
def test_decode_kernel_matches_twin(card, kind, freq_dtype):
    packed = port_segment(kind)
    if kind == "ef_heavy":
        assert (packed.blk_doc_bits >= EF_TAG).any()
    seg = build_device_segment(packed, "cpu")
    tables = (seg.data, seg.blk_off, seg.blk_doc_bits, seg.blk_freq_bits,
              seg.blk_base, seg.blk_count)
    want = decode_blocks_plain(*tables, freq_dtype=freq_dtype)
    got = decode_blocks(*(t.to(card) for t in tables), freq_dtype=freq_dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ef_heavy", "plain"])
def test_decode_score_kernel_matches_twin(card, kind):
    """K2 on every block (repeated, some items inert with count 0) with a
    3-row cache and varying fid: docs, freqs and cval bit-equal."""
    packed = port_segment(kind)
    seg = build_device_segment(packed, "cpu")
    nb = packed.num_blocks
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, nb, 3 * nb))
    count = seg.blk_count[idx].clone()
    count[::7] = 0  # inert items
    fid = torch.from_numpy((np.arange(len(idx)) % 3).astype(np.int32))
    cache = torch.from_numpy(np.abs(rng.standard_normal((3, 256))).astype(np.float32) + 0.25)
    args = (seg.data, seg.blk_off[idx], seg.blk_doc_bits[idx], seg.blk_freq_bits[idx],
            seg.blk_base[idx], count, fid, cache)
    want = decode_score_blocks_plain(*args)
    got = decode_score_blocks(*(a.to(card) for a in args))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("freq_dtype", [torch.int16, torch.int32])
def test_decode_kernels_every_width(card, seed, freq_dtype):
    """K1 and K2 on synthetic blocks at every FOR width 0-32 and EF low
    widths 0, 1, 5, 12, 20, with count 1, 37 and 128 (and K2 on inert
    copies): bit-equal to the twins, int32 wrap included."""
    data, off, dbits, fbits, base, count = synthetic_blocks(seed)
    if freq_dtype == torch.int16:
        fbits = fbits.clamp(max=15)  # the residency stores int16 freqs only below 2^15
    tables = (data, off, dbits, fbits, base, count)
    want = decode_blocks_plain(*tables, freq_dtype=freq_dtype)
    got = decode_blocks(*(t.to(card) for t in tables), freq_dtype=freq_dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    idx = torch.arange(2 * off.shape[0]) % off.shape[0]
    cnt = count[idx].clone()
    cnt[off.shape[0]:: 3] = 0  # inert items
    rng = np.random.default_rng(seed)
    fid = torch.from_numpy((np.arange(len(idx)) % 3).astype(np.int32))
    cache = torch.from_numpy(np.abs(rng.standard_normal((3, 256))).astype(np.float32) + 0.25)
    args = (data, off[idx], dbits[idx], fbits[idx], base[idx], cnt, fid, cache)
    want = decode_score_blocks_plain(*args)
    got = decode_score_blocks(*(a.to(card) for a in args))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [1, 7, 32])
@pytest.mark.parametrize("seed", [2, 6])
def test_combine_kernel_matches_twin(card, seed, n_rows):
    """Hand-built entries (items repeated over up to SPARSE_SPAN buckets,
    straddling bucket edges, all-invalid items) for 1, 7 and 32 rows:
    counts exact, scores within 1e-5 relative, every element written."""
    md = 2 * SPARSE_SPAN * C_BUCKET
    ptr, target, sc, e_item, e_row, e_enc, *_ = combine_entries(
        b=n_rows, md=md, w=200, max_span=SPARSE_SPAN, seed=seed
    )
    args = tuple(torch.from_numpy(a).to(card) for a in (ptr, target, sc, e_item, e_row, e_enc))

    def out():
        return (torch.full((n_rows, md), np.nan, device=card),
                torch.full((n_rows, md), -1, dtype=torch.int32, device=card))

    got = combine_lanes(*args, *out())
    want = combine_lanes_plain(*args, *out())
    assert torch.equal(got[1], want[1])
    err = (got[0] - want[0]).abs()
    assert bool((err <= 1e-5 * want[0].abs().clamp(min=1.0)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("seed,b,w", [(1, 32, 96), (4, 7, 300)])
def test_combine_kernel_on_executor_tables(card, seed, b, w):
    """The executor's own entry tables (build_combine_batch) over synthetic
    items, lanes read in place."""
    md = 4096
    docs, sc, rows, encs, valid, bf, bl = synthetic_items(w=w, b=b, md=md, seed=seed)
    (cb,) = build_combine_batch(combine_arrays(rows, encs, valid), b, bf, bl, md, card)
    args = (cb.bucket_ptr, torch.from_numpy(docs).to(card), torch.from_numpy(sc).to(card),
            cb.e_item, cb.e_row, cb.e_enc)

    def out():
        return (torch.full((b, md), np.nan, device=card),
                torch.full((b, md), -1, dtype=torch.int32, device=card))

    got = combine_lanes(*args, *out())
    want = combine_lanes_plain(*args, *out())
    assert torch.equal(got[1], want[1])
    err = (got[0] - want[0]).abs()
    assert bool((err <= 1e-5 * want[0].abs().clamp(min=1.0)).all())


def _slice_rows(vocab, seed=9, n=48):
    """Term, OR, AND, MUST_NOT, min_should and FILTER rows."""
    rng = np.random.default_rng(seed)
    shapes = [("T", 0), ("SS", 0), ("MM", 0), ("MN", 0), ("SSN", 0),
              ("SSS", 2), ("MF", 0), ("SSSS", 3), ("MSS", 1)]
    occ_fn = {"S": "should", "M": "must", "F": "filter", "N": "must_not"}
    rows = []
    for i in range(n):
        occ, msm = shapes[i % len(shapes)]
        terms = rng.choice(vocab, max(len(occ), 1), replace=False)
        if occ == "T":
            rows.append(T.TermQuery(T.Term("body", str(terms[0]))))
            continue
        q = T.BooleanQuery(min_should_match=msm)
        for o, t in zip(occ, terms):
            getattr(q, occ_fn[o])(T.TermQuery(T.Term("body", str(t))))
        rows.append(q)
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["auto", "dense", "candidate"])
def test_slice_on_card_matches_cpu(card, strategy, monkeypatch):
    """Two segments, one with deletes: every row's complete hit list on the
    card equals the CPU's under tests/torch_hitcheck.py."""
    monkeypatch.setenv("RUCENE_STRATEGY", strategy)
    segs = [port_segment("ef_heavy"), port_segment("plain")]
    live = np.random.default_rng(3).random(segs[1].max_doc) > 0.3

    def searcher(device):
        return T.IndexSearcher(IndexReader([
            SegmentSnapshot("a", segs[0]), SegmentSnapshot("b", segs[1], live=live),
        ]), device=device)

    vocab = [f"v{i}" for i in range(25)] + ["efhot", "u17", "u4242", "absent"]
    rows = _slice_rows(vocab)
    want = searcher("cpu").search_batch(rows, k=1000)
    got = searcher(card).search_batch(rows, k=1000)
    assert max(td.total_hits for td in want) < 1000
    assert_batches_strict(got, want)


def _is_pair(q) -> bool:
    """A two-clause row, both SHOULD or both MUST (_slice_rows' SS / MM)."""
    if not isinstance(q, T.BooleanQuery):
        return False
    occ = {c.occur for c in q.rewrite().clauses}
    return len(q.rewrite().clauses) == 2 and len(occ) == 1 and occ <= {T.Occur.SHOULD, T.Occur.MUST}


def _refuse(*_a, **_k):
    raise AssertionError("a plain decode twin ran for a CUDA tensor")


@pytest.mark.gpu
@pytest.mark.parametrize("deletes", [False, True])
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_routes_on_card_match_cpu(card, decoded, deletes, monkeypatch):
    """Packed (RUCENE_DECODED=0) and decoded serving of a mixed batch, split
    by row class, and of a single-term batch, over two segments (one with
    deletes when asked): the card's TopDocs equal the CPU's bit for bit,
    the single route runs exactly when no leaf has deletes, decoded
    leaves send the two-term rows to the pair route, packed leaves go
    through the scoring decode kernel, and no plain twin runs on the
    card."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    monkeypatch.setattr(searcher_mod, "SPLIT_MIN_DOCS", 0)
    segs = [port_segment("ef_heavy"), port_segment("plain")]
    live = np.random.default_rng(3).random(segs[1].max_doc) > 0.3 if deletes else None

    def searcher(device):
        return T.IndexSearcher(IndexReader([
            SegmentSnapshot("a", segs[0]), SegmentSnapshot("b", segs[1], live=live),
        ]), device=device)

    vocab = [f"v{i}" for i in range(25)] + ["efhot", "u17", "u4242", "absent"]
    rows = _slice_rows(vocab)
    singles = [T.TermQuery(T.Term("body", t)) for t in vocab]
    want = [searcher("cpu").search_batch(x, k=1000) for x in (rows, singles)]
    monkeypatch.setattr(cuda_decode, "decode_blocks_plain", _refuse)
    monkeypatch.setattr(cuda_decode, "decode_score_blocks_plain", _refuse)
    METRICS.reset()
    s = searcher(card)
    got = [s.search_batch(x, k=1000) for x in (rows, singles)]
    counters = METRICS.snapshot()["counters"]
    assert_batches_strict(got[0], want[0])
    assert got[1] == want[1]  # one clause: the same f32 operations
    n_single = len(singles) + sum(isinstance(r, T.TermQuery) for r in rows)
    n_pair = sum(_is_pair(r) for r in rows) if decoded == "1" else 0
    n_rows = len(rows) + len(singles)
    assert counters.get("route.single", 0) == (0 if deletes else n_single)
    assert counters.get("route.pair_rows", 0) == n_pair * 2  # rows a leaf call
    assert counters.get("route.single", 0) + counters.get("route.flat", 0) + n_pair == n_rows
    k2 = counters.get(cuda_decode.SCORE_LAUNCH_COUNTER, 0)
    assert (k2 > 0) == (decoded == "0")
    assert all((lf.device.docs_dec is None) == (decoded == "0") for lf in s.reader.leaves)


_PHRASE_PINS = {
    "candidate": {"PHRASE_SCALAR_MAX_DOCS": 0},
    "sloppy": {"PHRASE_SCALAR_MAX_DOCS": 0},
    "planes": {"PHRASE_SCALAR_MAX_DOCS": 0, "PHRASE_PLANE_MIN_DOCS": 1,
               "PHRASE_PLANE_ITEM_MIN": 1},
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(_PHRASE_PINS))
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_phrase_routes_on_card_match_cpu(card, route, decoded, monkeypatch):
    """Phrase rows (2 and 3 terms, exact or sloppy, one with an absent
    term) beside term rows, over two segments, one with deletes, on each
    device phrase route: the card's TopDocs match the CPU's, packed leaves
    decode the phrase work through the decode kernel, and no plain twin
    runs on the card."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    segs = [port_segment("ef_heavy"), port_segment("plain")]
    live = np.random.default_rng(3).random(segs[1].max_doc) > 0.3
    rng = np.random.default_rng(12)
    vocab = [f"v{i}" for i in range(25)] + ["efhot"]
    slop = 3 if route == "sloppy" else 0
    rows = [T.PhraseQuery("body", [str(t) for t in rng.choice(vocab, 2 + i % 2)], slop=slop)
            for i in range(40)]
    rows += [T.PhraseQuery("body", ["v1", "absent"], slop=slop),
             T.TermQuery(T.Term("body", "v3")), T.TermQuery(T.Term("body", "u17"))]

    def searcher(device):
        s = T.IndexSearcher(IndexReader([
            SegmentSnapshot("a", segs[0]), SegmentSnapshot("b", segs[1], live=live),
        ]), device=device)
        for name, v in _PHRASE_PINS[route].items():
            setattr(s, name, v)
        return s

    phrase_path._PLANE_CACHE.clear()
    want = searcher("cpu").search_batch(rows, k=1000)
    monkeypatch.setattr(cuda_decode, "decode_blocks_plain", _refuse)
    monkeypatch.setattr(cuda_decode, "decode_score_blocks_plain", _refuse)
    s = searcher(card)
    for lf in s.reader.leaves:
        lf.device  # the residency's own decode launches are not counted
    METRICS.reset()
    got = s.search_batch(rows, k=1000)
    counters = METRICS.snapshot()["counters"]
    assert_batches_strict(got, want)
    assert sum(td.total_hits for td in want) > 0
    assert counters.get("route.phrase", 0) == 41
    route_counter = "search.phrase_plane" if route == "planes" else "search.phrase_device"
    assert counters.get(route_counter, 0) > 0
    assert (counters.get(cuda_decode.LAUNCH_COUNTER, 0) > 0) == (decoded == "0")


@pytest.mark.gpu
@pytest.mark.parametrize("deletes", [False, True])
@pytest.mark.parametrize("route", ["pair", "planes"])
def test_pair_and_plane_routes_on_card_match_cpu(card, route, deletes, monkeypatch):
    """Two-term AND / OR rows on the pair route, and the boolean algebra on
    the tf-plane route (every term planed), over two decoded segments (one
    with deletes when asked): the card's TopDocs equal the CPU's under
    tests/torch_hitcheck.py, two-clause rows bit for bit, every row on the
    route named, and no plain decode twin runs on the card."""
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PLANES", "1" if route == "planes" else "0")
    segs = [port_segment("ef_heavy"), port_segment("plain")]
    live = np.random.default_rng(3).random(segs[1].max_doc) > 0.3 if deletes else None

    def searcher(device):
        return T.IndexSearcher(IndexReader([
            SegmentSnapshot("a", segs[0]), SegmentSnapshot("b", segs[1], live=live),
        ]), device=device)

    vocab = [f"v{i}" for i in range(25)] + ["efhot", "u17", "u4242", "absent"]
    if route == "pair":
        rng = np.random.default_rng(8)
        rows = []
        for i in range(48):
            q = T.BooleanQuery()
            for t in rng.choice(vocab, 2):
                getattr(q, "should" if i % 2 else "must")(T.TermQuery(T.Term("body", str(t))))
            rows.append(q)
    else:
        rows = [r for r in _slice_rows(vocab) if not isinstance(r, T.TermQuery)]
    want = searcher("cpu").search_batch(rows, k=1000)
    monkeypatch.setattr(cuda_decode, "decode_blocks_plain", _refuse)
    monkeypatch.setattr(cuda_decode, "decode_score_blocks_plain", _refuse)
    s = searcher(card)
    for lf in s.reader.leaves:
        lf.device
    METRICS.reset()
    got = s.search_batch(rows, k=1000)
    counters = METRICS.snapshot()["counters"]
    # rows a leaf call, over the two leaves
    assert counters.get("route.pair_rows" if route == "pair" else "route.plane_rows", 0) == 2 * len(rows)
    assert sum(td.total_hits for td in want) > 0
    assert max(td.total_hits for td in want) < 1000
    assert_batches_strict(got, want)
    for g, w, q in zip(got, want, rows):
        if len(q.rewrite().clauses) <= 2:
            assert g == w
    head = s.search_batch(rows, k=10)
    assert [h.score_docs for h in head] == [g.score_docs[:10] for g in got]


@pytest.mark.gpu
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_mixed_and_score_combine_rows_on_card_match_cpu(card, decoded, monkeypatch):
    """Mixed rows (term clauses plus a MUST or FILTER exact phrase) and
    score-combine rows (dismax, constant-score, boosting, match-all) over
    two segments, one with deletes, on both executor branches: the card's
    TopDocs equal the CPU's under tests/torch_hitcheck.py, the mixed rows
    launch the combine kernel (and on packed leaves the scoring decode),
    and no plain decode twin runs on the card."""
    from rucene_tpu_torch.ops import cuda_combine

    monkeypatch.setenv("RUCENE_DECODED", decoded)
    segs = [port_segment("ef_heavy"), port_segment("plain")]
    live = np.random.default_rng(3).random(segs[1].max_doc) > 0.3
    rng = np.random.default_rng(21)
    vocab = [f"v{i}" for i in range(25)] + ["efhot", "u17"]

    def t(w):
        return T.TermQuery(T.Term("body", str(w)))

    mixed = []
    for i in range(24):
        q = T.BooleanQuery()
        (q.filter if i % 4 == 3 else q.must)(T.PhraseQuery("body", [str(w) for w in rng.choice(vocab, 2)]))
        for occ in ("should", "must", "must_not")[: 1 + i % 3]:
            getattr(q, occ)(t(rng.choice(vocab)))
        mixed.append(q)
    extras = [T.DisjunctionMaxQuery([t(a), t(b)], tie_breaker=0.3 * (i % 2))
              for i, (a, b) in enumerate(rng.choice(vocab, (8, 2)))]
    extras += [T.ConstantScoreQuery(t(w), 2.0) for w in rng.choice(vocab, 4)]
    extras += [T.BoostingQuery(t(a), t(b), 0.5) for a, b in rng.choice(vocab, (4, 2))]
    extras += [T.MatchAllDocsQuery(boost=3.0)]

    def searcher(device):
        return T.IndexSearcher(IndexReader([
            SegmentSnapshot("a", segs[0]), SegmentSnapshot("b", segs[1], live=live),
        ]), device=device)

    phrase_path._PLANE_CACHE.clear()
    cpu = searcher("cpu")
    want_mixed, want_extras = cpu.search_batch(mixed, k=1000), cpu.search_batch(extras, k=1000)
    monkeypatch.setattr(cuda_decode, "decode_blocks_plain", _refuse)
    monkeypatch.setattr(cuda_decode, "decode_score_blocks_plain", _refuse)
    s = searcher(card)
    for lf in s.reader.leaves:
        lf.device
    METRICS.reset()
    got = s.search_batch(mixed, k=1000)
    counters = METRICS.snapshot()["counters"]
    assert counters.get("route.mixed", 0) == len(mixed)
    assert counters.get(cuda_combine.LAUNCH_COUNTER, 0) > 0
    assert (counters.get(cuda_decode.SCORE_LAUNCH_COUNTER, 0) > 0) == (decoded == "0")
    assert sum(td.total_hits for td in want_mixed) > 0
    assert_batches_strict(got, want_mixed)
    assert max(td.total_hits for td in want_extras) < 1000
    for strategy in ("dense", "candidate"):
        monkeypatch.setenv("RUCENE_STRATEGY", strategy)
        assert_batches_strict(s.search_batch(extras, k=1000), want_extras)


@pytest.mark.gpu
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_filter_and_host_rows_on_card_match_cpu(card, decoded, monkeypatch):
    """Range, exists and prefix rows (candidate-complete and range-only,
    on both executor branches), mixed rows with a range and host rows over
    two segments, one with deletes: the card's TopDocs equal the CPU's
    under tests/torch_hitcheck.py, the filter planes live on the card, the
    host rows are counted under route.host, and no plain decode twin runs
    on the card."""
    from rucene_tpu_torch.codec.postings import pack_segment
    from rucene_tpu_torch.index.memory import SegmentBuffer

    rng = np.random.default_rng(13)
    words = [f"v{i}" for i in range(30)]

    def seg(n):
        buf = SegmentBuffer()
        for i in range(n):
            d = T.Document()
            d.add(T.TextField("body", " ".join(rng.choice(words, int(rng.integers(3, 30))))))
            d.add(T.IntPoint("ts", int(rng.integers(0, 1000))))
            if i % 4 == 0:
                d.add(T.StringField("tag", f"c{int(rng.integers(0, 100)):02d}"))
            buf.add_document(d)
        return pack_segment(buf.finish())

    segs = [seg(1500), seg(900)]
    live = np.random.default_rng(3).random(segs[1].max_doc) > 0.3

    def t(w):
        return T.TermQuery(T.Term("body", str(w)))

    def row(*clauses):
        q = T.BooleanQuery()
        for occ, sub in clauses:
            getattr(q, occ)(sub)
        return q

    def window():
        lo = int(rng.integers(0, 900))
        return T.PointRangeQuery("ts", lo, lo + int(rng.integers(1, 300)))

    complete = [row(("must", t(rng.choice(words))), ("filter", window())) for _ in range(8)]
    complete += [row(("must", t(rng.choice(words))), ("should", t(rng.choice(words))),
                     ("filter", T.PrefixQuery("tag", f"c{i}"))) for i in range(4)]
    open_rows = [window() for _ in range(4)]
    open_rows += [row(("should", t(rng.choice(words))), ("must", T.ExistsQuery("tag"))) for _ in range(4)]
    open_rows += [row(("should", t(a)), ("should", t(b)), ("must_not", window()))
                  for a, b in rng.choice(words, (4, 2))]
    mixed = [row(("must", T.PhraseQuery("body", [str(w) for w in rng.choice(words, 2)])),
                 ("should", t(rng.choice(words))), ("filter", window())) for _ in range(6)]
    host = [row(("must", row(("should", t(a)), ("should", t(b)))), ("must", t(c)))
            for a, b, c in rng.choice(words, (3, 3))]
    host += [row(("must", T.MatchAllDocsQuery()), ("filter", window())) for _ in range(2)]
    rows = complete + open_rows + mixed + host

    def searcher(device):
        return T.IndexSearcher(IndexReader([
            SegmentSnapshot("a", segs[0]), SegmentSnapshot("b", segs[1], live=live),
        ]), device=device)

    monkeypatch.setenv("RUCENE_DECODED", decoded)
    phrase_path._PLANE_CACHE.clear()
    cpu = searcher("cpu")
    want, want_complete = cpu.search_batch(rows, k=2000), cpu.search_batch(complete, k=2000)
    assert max(td.total_hits for td in want) < 2000 and sum(td.total_hits > 0 for td in want) > len(rows) // 2
    monkeypatch.setattr(cuda_decode, "decode_blocks_plain", _refuse)
    monkeypatch.setattr(cuda_decode, "decode_score_blocks_plain", _refuse)
    s = searcher(card)
    METRICS.reset()
    got = s.search_batch(rows, k=2000)
    counters = METRICS.snapshot()["counters"]
    assert counters.get("route.host", 0) == len(host)
    assert counters.get("route.mixed", 0) == len(mixed)
    assert counters.get("search.strategy.dense", 0) > 0
    assert_batches_strict(got, want)
    leaf = s.reader.leaves[0]
    assert s._leaf_plane(leaf, complete[0].rewrite().ranges[0]).device.type == card.type
    for strategy in ("dense", "candidate"):
        monkeypatch.setenv("RUCENE_STRATEGY", strategy)
        METRICS.reset()
        assert_batches_strict(s.search_batch(complete, k=2000), want_complete)
        assert METRICS.snapshot()["counters"].get(f"search.strategy.{strategy}", 0) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("decoded", ["0", "1"])
def test_query_surface_on_card_matches_cpu(card, decoded, monkeypatch):
    """Sorted and collapse rows, span and synonym rows (unordered, ordered
    with a SpanOr child, nested on the host route) and the rescorer's probe
    over two segments, one with deletes: the card's answers equal the
    CPU's (sort values and docs exactly, scores under
    tests/torch_hitcheck.py), the route counters are the CPU's, and no
    plain decode twin runs on the card."""
    from rucene_tpu_torch.codec.postings import pack_segment
    from rucene_tpu_torch.index.memory import SegmentBuffer
    from rucene_tpu_torch.search.rescorer import QueryRescorer
    from rucene_tpu_torch.search.sort_field import SortFieldType
    from rucene_tpu_torch.search.spans import SpanNearQuery, SpanOrQuery, SpanTermQuery

    rng = np.random.default_rng(29)
    words = [f"v{i}" for i in range(30)]

    def seg(n):
        buf = SegmentBuffer()
        for _ in range(n):
            d = T.Document()
            d.add(T.TextField("body", " ".join(rng.choice(words, int(rng.integers(3, 30))))))
            d.add(T.NumericDocValuesField("ts", int(rng.integers(0, 5000))))
            d.add(T.NumericDocValuesField("grp", int(rng.integers(0, 40))))
            buf.add_document(d)
        return pack_segment(buf.finish())

    segs = [seg(1500), seg(900)]
    live = np.random.default_rng(3).random(segs[1].max_doc) > 0.3

    def searcher(device):
        return T.IndexSearcher(IndexReader([
            SegmentSnapshot("a", segs[0]), SegmentSnapshot("b", segs[1], live=live),
        ]), device=device)

    def t(w):
        return T.TermQuery(T.Term("body", str(w)))

    def st(w):
        return SpanTermQuery(T.Term("body", str(w)))

    def or2(a, b):
        return T.BooleanQuery().should(t(a)).should(t(b))

    sort = T.Sort([T.SortField("grp", SortFieldType.LONG), T.SortField("ts", SortFieldType.LONG, reverse=True)])
    keyed = [t(w) for w in rng.choice(words, 4)] + [or2(*rng.choice(words, 2, replace=False)) for _ in range(3)]
    spans = [SpanOrQuery([st(w) for w in rng.choice(words, 2, replace=False)]) for _ in range(4)]
    spans += [SpanNearQuery([st(w) for w in rng.choice(words, 3, replace=False)], slop=4, in_order=False)
              for _ in range(4)]
    spans += [SpanNearQuery([SpanOrQuery([st("v1"), st("v2")]), st("v3")], slop=0, in_order=True),
              SpanNearQuery([SpanNearQuery([st("v0"), st("v1")], 2, True), st("v2")], 4, False)]

    def serve(s):
        METRICS.reset()
        sorted_ = [s.search_sorted(q, 50, sort) for q in keyed]
        collapsed = [s.search_collapse(q, 50, "grp") for q in keyed]
        span_hits = s.search_batch(spans, k=2000)
        routes = {k: v for k, v in METRICS.snapshot()["counters"].items() if k.startswith("route.")}
        first = s.search(t("v5"), 60)
        rescored = QueryRescorer(or2("v6", "v7"), 2.0).rescore(s, first, top_n=40)
        return sorted_, collapsed, span_hits, routes, rescored

    monkeypatch.setenv("RUCENE_DECODED", decoded)
    phrase_path._PLANE_CACHE.clear()
    want = serve(searcher("cpu"))
    monkeypatch.setattr(cuda_decode, "decode_blocks_plain", _refuse)
    monkeypatch.setattr(cuda_decode, "decode_score_blocks_plain", _refuse)
    got = serve(searcher(card))
    for g, w in zip(got[0], want[0]):
        assert g.total_hits == w.total_hits
        assert [(fd.doc, fd.fields) for fd in g.field_docs] == [(fd.doc, fd.fields) for fd in w.field_docs]
    for g, w in zip(got[1], want[1]):
        assert [d for d, _ in g.score_docs] == [d for d, _ in w.score_docs]
    assert_batches_strict(got[1], want[1])
    assert_batches_strict(got[2], want[2])
    assert got[3] == want[3] and got[3]["route.span_unordered"] == 5 and got[3]["route.host"] == 1
    assert_batches_strict([got[4]], [want[4]])

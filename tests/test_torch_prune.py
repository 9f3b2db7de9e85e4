"""Block-max WAND pruning (IndexSearcher.search_batch(prune=)) against
rucene_tpu on the CPU.

- the automatic rule (_auto_prune_decision) answers as the reference's on
  the same rows, under RUCENE_PRUNE and RUCENE_PRUNE_AUTO_MIN_DOCS (the
  reference's tests/test_auto_prune.py), and engages on a pure-OR batch
  only where the pair route does not take it;
- the routing: prune=True takes no single, pair or tf-plane route; rows
  with ranges or score-combine overrides never prune;
- pruned answers equal exhaustive ones (the reference's
  tests/test_topk_paths.py:122-163 and tests/test_combined_view.py:76),
  total_hits at most the exhaustive count, and the port's pruned TopDocs,
  total_hits included, equal the reference's search_batch(prune=True) on
  the same index (packed_from_reference, or one directory read by both);
- the differential fuzz the reference lost (ADVICE.md, medium #1):
  seeded skewed corpora in a norm-less field with deletes, random pure-OR
  rows of 2-5 terms at k = 1, 5, 10 and 32, pruned against exhaustive and
  against the reference, search.pruned_blocks > 0 on every seed; docs
  with at most two row words compare strictly, docs with three to five
  (sums in each run's own order, ROADMAP.md §3, summation order) under
  assert_truncated_within_rtol against a k=64 exhaustive answer; and the
  prune=True leg of the combined-vs-per-leaf fuzz;
- the reference's f32 WAND bound can round one ULP under a doc's score
  and lose a tied hit at a lower doc id (ROADMAP.md §3): a directed
  two-clause case shows the reference losing it and the port keeping it,
  and the port's bound covers every summation order.
"""

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.doc.field import Field, FieldType, IndexOptions
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot
from rucene_tpu.index.reader import open_directory_reader as ref_open
from rucene_tpu.store.directory import FSDirectory as RefFS
from rucene_tpu.util.metrics import METRICS as REF_METRICS
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.search import searcher as searcher_mod
from rucene_tpu_torch.util.metrics import METRICS
from tests.conftest import random_corpus
from tests.torch_hitcheck import (
    assert_batches_strict,
    assert_pruned_strict,
    assert_truncated_within_rtol,
)


def _ref_segment(texts, field_type=None):
    """A reference segment of ``texts`` in ``body``: a TextField, or a
    field of ``field_type``."""
    buf = SegmentBuffer()
    for t in texts:
        d = R.Document()
        d.add(R.TextField("body", t) if field_type is None else Field("body", t, field_type))
        buf.add_document(d)
    return pack_segment(buf.finish())


def _pair(leaves):
    """(reference searcher, port CPU searcher) over [(reference packed,
    live or None)]."""
    ref = R.IndexSearcher(RefReader([RefSnapshot(f"s{i}", p, live=lv)
                                     for i, (p, lv) in enumerate(leaves)]))
    port = T.IndexSearcher(IndexReader([
        SegmentSnapshot(f"s{i}", packed_from_reference(p), live=lv)
        for i, (p, lv) in enumerate(leaves)
    ]), device="cpu")
    return ref, port


def _or(P, words, field="body"):
    q = P.BooleanQuery()
    for w in words:
        q.should(P.TermQuery(P.Term(field, w)))
    return q


def _counter(name):
    return METRICS.snapshot()["counters"].get(name, 0)


# --- the automatic rule (tests/test_auto_prune.py) ------------------------------


def _auto_texts(n=800, vocab=50, seed=9):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    return [" ".join(rng.choice(words, size=int(rng.integers(5, 25)), p=probs)) for _ in range(n)]


def _auto_rows(P, n=8):
    return [_or(P, [f"w{i % 20}", f"w{(i * 3 + 5) % 20}"]) for i in range(n)]


@pytest.fixture(scope="module")
def auto_index():
    return [(_ref_segment(_auto_texts()), None)]


def test_auto_rule(auto_index, monkeypatch):
    ref, port = _pair(auto_index)

    def rows(P):
        conj = P.BooleanQuery().must(P.TermQuery(P.Term("body", "w0"))).must(
            P.TermQuery(P.Term("body", "w1")))
        dismax = P.DisjunctionMaxQuery(
            [P.TermQuery(P.Term("body", "w0")), P.TermQuery(P.Term("body", "w1"))], 0.1)
        ranged = _or(P, ["w0", "w1"]).should(P.PointRangeQuery("ts", 1, 5))
        msm = _or(P, ["w0", "w1", "w2"])
        msm.min_should_match = 2
        return {
            "ors": [q.rewrite() for q in _auto_rows(P)],
            "with_conj": [q.rewrite() for q in _auto_rows(P) + [conj]],
            "single": [P.TermQuery(P.Term("body", "w0")).rewrite()],
            "dismax": [dismax.rewrite()],
            "ranged": [ranged.rewrite()],
            "msm2": [msm.rewrite()],
            "match_all": [P.MatchAllDocsQuery().rewrite()],
        }

    want_rows, got_rows = rows(R), rows(T)

    def same(k, expect=None):
        for name in want_rows:
            want = ref._auto_prune_decision(want_rows[name], k=k)
            assert port._auto_prune_decision(got_rows[name], k=k) == want, (name, k)
            if expect is not None and name == "ors":
                assert want == expect

    monkeypatch.delenv("RUCENE_PRUNE", raising=False)
    monkeypatch.delenv("RUCENE_PRUNE_AUTO_MIN_DOCS", raising=False)
    same(10, expect=False)  # 800 docs, under the 2^22 default
    monkeypatch.setenv("RUCENE_PRUNE_AUTO_MIN_DOCS", "100")
    same(10, expect=True)
    same(32, expect=True)
    same(33, expect=False)  # k too large
    same(1000, expect=False)
    assert not port._auto_prune_decision(got_rows["with_conj"], k=10)
    assert not port._auto_prune_decision(got_rows["single"], k=10)  # 1 clause
    monkeypatch.setenv("RUCENE_PRUNE_AUTO_MIN_DOCS", "801")
    same(10, expect=False)
    monkeypatch.setenv("RUCENE_PRUNE_AUTO_MIN_DOCS", "800")
    same(10, expect=True)
    monkeypatch.setenv("RUCENE_PRUNE", "0")  # forced off / on, whatever the rows
    same(10, expect=False)
    monkeypatch.setenv("RUCENE_PRUNE", "1")
    same(1000, expect=True)
    assert port._auto_prune_decision(got_rows["single"], k=1000)


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("pair", ["0", "1"])
def test_auto_prune_parity_and_engagement(auto_index, monkeypatch, decoded, pair):
    """prune=None engages on a pure-OR batch above the lowered threshold
    unless the pair route takes it (decoded leaves, RUCENE_PAIR on), as in
    the reference; hits equal prune=False's, total_hits at most its, and
    the answer equals the reference's, total_hits included."""
    monkeypatch.setenv("RUCENE_PRUNE_AUTO_MIN_DOCS", "100")
    monkeypatch.delenv("RUCENE_PRUNE", raising=False)
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    monkeypatch.setenv("RUCENE_PAIR", pair)
    monkeypatch.setenv("RUCENE_PLANES", "0")
    ref, port = _pair(auto_index)
    before = _counter("search.auto_prune_batches")
    auto = port.search_batch(_auto_rows(T), k=10)
    engaged = _counter("search.auto_prune_batches") - before
    assert engaged == (0 if decoded == "1" and pair == "1" else 1)
    off = port.search_batch(_auto_rows(T), k=10, prune=False)
    for a, b in zip(auto, off):
        assert_pruned_strict(a, b)
    ref_before = REF_METRICS.snapshot()["counters"].get("search.auto_prune_batches", 0)
    want = ref.search_batch(_auto_rows(R), k=10)
    ref_engaged = REF_METRICS.snapshot()["counters"].get(
        "search.auto_prune_batches", 0) - ref_before
    assert ref_engaged == engaged
    assert_batches_strict(auto, want)


# --- routing -------------------------------------------------------------------


def test_prune_routing(auto_index, monkeypatch):
    """prune=True: no single, pair or plane route, every leaf through the
    pruned runner; ranges or a score-combine row in the batch turn pruning
    off, as the reference's routing does."""
    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_PLANES", "1")
    monkeypatch.setenv("RUCENE_PAIR", "1")
    _, port = _pair(auto_index)
    calls = []
    orig = searcher_mod.IndexSearcher._run_pruned_view
    monkeypatch.setattr(searcher_mod.IndexSearcher, "_run_pruned_view",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    term_rows = [T.TermQuery(T.Term("body", f"w{i}")) for i in range(4)]
    cases = [
        (term_rows, True, "route.single"),
        (_auto_rows(T), True, "route.pair_rows"),
        (_auto_rows(T), True, "route.plane_rows"),
        (_auto_rows(T) + [_or(T, ["w0"]).should(T.PointRangeQuery("ts", 0, 9))], False, None),
        (_auto_rows(T) + [T.ConstantScoreQuery(T.TermQuery(T.Term("body", "w3")), 2.0)],
         False, None),
    ]
    for rows, pruned, not_taken in cases:
        del calls[:]
        before = METRICS.snapshot()["counters"]
        got = port.search_batch(rows, k=5, prune=True)
        moved = {k: v - before.get(k, 0) for k, v in METRICS.snapshot()["counters"].items()}
        assert bool(calls) == pruned, rows
        if not_taken:
            assert not moved.get(not_taken, 0) and moved.get("route.flat", 0) == len(rows)
        for a, b in zip(got, port.search_batch(rows, k=5, prune=False)):
            assert_pruned_strict(a, b)


# --- pruned equals exhaustive (tests/test_topk_paths.py:122-163) -----------------


def test_pruned_matches_exact():
    """Skewed impacts: a few high-tf docs, a long tail of tf=1 blocks whose
    bound cannot reach the top-10 threshold, so some rows keep their pass-1
    answer (total_hits a lower bound). Equal to exhaustive and to the
    reference, total_hits included."""
    rng = np.random.default_rng(404)
    texts = ["boost boost boost boost boost pad pad pad" for _ in range(300)]
    texts += ["boost pad pad pad pad pad pad pad" for _ in range(3700)]
    texts += random_corpus(rng, 500)
    ref, port = _pair([(_ref_segment(texts), None)])

    def rows(P):
        return [P.TermQuery(P.Term("body", "boost")), P.TermQuery(P.Term("body", "pad")),
                _or(P, ["boost", "fox"])]

    before = _counter("search.pruned_blocks")
    pruned = port.search_batch(rows(T), k=10, prune=True)
    assert _counter("search.pruned_blocks") > before
    exact = port.search_batch(rows(T), k=10)
    lower = 0
    for p, e in zip(pruned, exact):
        assert_pruned_strict(p, e)
        lower += p.total_hits < e.total_hits
    assert lower > 0  # some row kept its pass-1 answer
    assert_batches_strict(pruned, ref.search_batch(rows(R), k=10, prune=True))


def test_pruned_safe_on_uniform_ties():
    """Uniform corpora give every block the same bound: every deferred
    block survives and the rows rerun in full."""
    rng = np.random.default_rng(405)
    ref, port = _pair([(_ref_segment(random_corpus(rng, 3000)), None)])

    def rows(P):
        return [P.TermQuery(P.Term("body", w)) for w in ["the", "fox", "dog"]]

    pruned = port.search_batch(rows(T), k=10, prune=True)
    for p, e in zip(pruned, port.search_batch(rows(T), k=10)):
        assert p.total_hits == e.total_hits and p.score_docs == e.score_docs
    assert_batches_strict(pruned, ref.search_batch(rows(R), k=10, prune=True))


# --- the combined view (tests/test_combined_view.py:76) --------------------------


def test_combined_pruned_matches_exact(tmp_path):
    """WAND over the combined view of a skewed 6-segment index written by
    the port: equal to the exact combined answer (total_hits at most its)
    and to the reference's combined pruned answer over the same files."""
    rng = np.random.default_rng(42)
    words = ["hot"] + [f"cold{i}" for i in range(300)]
    probs = np.ones(len(words))
    probs[0] = 400
    probs /= probs.sum()
    w = T.IndexWriter(T.FSDirectory(str(tmp_path)),
                      T.IndexWriterConfig(max_buffered_docs=150, merge_on_commit=False))
    widx = rng.choice(len(words), size=(900, 12), p=probs)
    for i in range(900):
        doc = T.Document()
        doc.add(T.StringField("id", str(i)))
        doc.add(T.TextField("body", " ".join(words[j] for j in widx[i])))
        w.add_document(doc)
    w.commit()
    reader = T.open_directory_reader(T.FSDirectory(str(tmp_path)))
    assert len(reader.leaves) > 1

    def rows(P):
        return [_or(P, ["hot", f"cold{i}"]) for i in range(8)]

    comb = T.IndexSearcher(reader, device="cpu", combine_segments=True)
    exact = comb.search_batch(rows(T), k=5)
    pruned = comb.search_batch(rows(T), k=5, prune=True)
    for a, b in zip(pruned, exact):
        assert_pruned_strict(a, b)
    ref_comb = R.IndexSearcher(ref_open(RefFS(str(tmp_path))), combine_segments=True)
    assert_batches_strict(pruned, ref_comb.search_batch(rows(R), k=5, prune=True))
    w.close()


# --- the lost fuzz (ADVICE.md, medium #1) -----------------------------------------

FUZZ_DOCS = 20_000
FUZZ_VOCAB = 200
TOPIC_SHARE = 0.03  # the head of each segment: docs repeating several row words
NO_NORMS = FieldType(index_options=IndexOptions.DOCS_AND_FREQS, tokenized=True,
                     omit_norms=True)


def _fuzz_texts(seed, many):
    """Zipf words over 20,000 docs, in two segments. The first 3% of each
    segment are topic docs: row words from the 30 most frequent, each 2-6
    times, two a doc (three to five with ``many``), so the high-bound
    blocks sit together and pass 1 finds hits that beat deferred blocks.
    1 doc in 250 is short and repeats one Zipf word 4-9 times. The rest
    hold one or two Zipf words, a stop word ``s0`` beside one in 4 docs
    of 5 (with ``many``: ``s0`` and two to four words), plus 2-17 filler
    words no row names."""
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(FUZZ_VOCAB)]
    p = 1.0 / np.arange(1, FUZZ_VOCAB + 1)
    p /= p.sum()
    half = FUZZ_DOCS // 2
    texts = []
    for i in range(FUZZ_DOCS):
        u = rng.random()
        if i % half < TOPIC_SHARE * half:
            m = int(rng.integers(3, 6)) if many else 2
            toks = [w for w in rng.choice(words[:30], m, replace=False)
                    for _ in range(int(rng.integers(2, 7)))]
            toks += [f"p{int(x)}" for x in rng.integers(0, 50, int(rng.integers(0, 4)))]
        elif u < 0.004:
            toks = [words[rng.choice(FUZZ_VOCAB, p=p)]] * int(rng.integers(4, 10))
            toks += [f"p{int(x)}" for x in rng.integers(0, 50, int(rng.integers(0, 3)))]
        else:
            if many:
                toks = ["s0"] + list(rng.choice(words, int(rng.integers(2, 5)), replace=False,
                                                p=p))
            else:
                toks = (["s0", words[rng.choice(FUZZ_VOCAB, p=p)]] if u < 0.8
                        else list(rng.choice(words, 2, replace=False, p=p)))
            toks += [f"p{int(x)}" for x in rng.integers(0, 50, int(rng.integers(2, 18)))]
        rng.shuffle(toks)
        texts.append(" ".join(toks))
    return texts


def _fuzz_index(seed, many=False):
    """Two reference segments of the seed's texts in a field without norms,
    a tenth of each segment's docs deleted. Without norms a block's bound
    is the best score it holds, not a looser one over every doc length,
    so deferred blocks fall below the pass-1 threshold on every seed and
    a bound that rounds below a score would show."""
    texts = _fuzz_texts(seed, many)
    rng = np.random.default_rng(seed + 1)
    half = len(texts) // 2
    out = []
    for part in (texts[:half], texts[half:]):
        packed = _ref_segment(part, NO_NORMS)
        out.append((packed, rng.random(packed.max_doc) >= 0.1))
    return out


def _fuzz_rows(seed, n=32):
    """Pure-OR rows of 2-5 terms from the 30 most frequent words, half of
    them with the stop word."""
    rng = np.random.default_rng(seed + 100)
    rows = []
    for _ in range(n):
        m = int(rng.integers(2, 6))
        ws = ["s0"] if rng.random() < 0.5 else []
        ws += [f"t{int(w)}" for w in rng.choice(30, m - len(ws), replace=False)]
        rows.append(ws)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_pruned_vs_exact(seed):
    """Docs hold at most two row words: every score is a sum of at most
    two clause scores, exact in any order, so truncated lists compare
    strictly, against exhaustive serving and against the reference."""
    ref, port = _pair(_fuzz_index(seed))
    rows = _fuzz_rows(seed)
    pruned_blocks = 0
    for k in (1, 5, 10, 32):
        before = _counter("search.pruned_blocks")
        pruned = port.search_batch([_or(T, r) for r in rows], k=k, prune=True)
        pruned_blocks += _counter("search.pruned_blocks") - before
        exact = port.search_batch([_or(T, r) for r in rows], k=k, prune=False)
        for i, (p, e) in enumerate(zip(pruned, exact)):
            try:
                assert_pruned_strict(p, e)
            except AssertionError as err:
                raise AssertionError(f"k={k} row {i} {rows[i]}: {err}") from None
        assert_batches_strict(pruned, ref.search_batch([_or(R, r) for r in rows], k=k, prune=True))
    assert pruned_blocks > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_pruned_vs_exact_many_words(seed):
    """Docs hold three to five row words, so rows of 3-5 terms bound and
    sum three or more clauses. Those sums follow each run's own order, so
    truncated lists are held by assert_truncated_within_rtol to the
    exhaustive answer at k=64: the port's pruned answer and the
    reference's."""
    ref, port = _pair(_fuzz_index(seed, many=True))
    rows = _fuzz_rows(seed)
    wide = port.search_batch([_or(T, r) for r in rows], k=64, prune=False)
    assert max(len(r) for r in rows) >= 4
    pruned_blocks = 0
    for k in (1, 5, 10, 32):
        before = _counter("search.pruned_blocks")
        pruned = port.search_batch([_or(T, r) for r in rows], k=k, prune=True)
        pruned_blocks += _counter("search.pruned_blocks") - before
        want = ref.search_batch([_or(R, r) for r in rows], k=k, prune=True)
        for i, (p, r, e) in enumerate(zip(pruned, want, wide)):
            try:
                assert_truncated_within_rtol(p, e, k)
                assert_truncated_within_rtol(r, e, k)
            except AssertionError as err:
                raise AssertionError(f"k={k} row {i} {rows[i]}: {err}") from None
    assert pruned_blocks > 0


def test_pruned_keeps_a_tie_below_the_f32_bound():
    """A deferred doc that ties the pass-1 k-th score at a lower doc id.
    Row ``a OR b`` at k=1 over a norm-less field: doc 0 (``a b b b``) sits
    in a's first block, whose only tf is 1, so it is the block deferred;
    doc 128 (``a b b b``) in a pass-1 block scores the same. The bound of
    doc 0's block is exactly its best score, and the reference's f32
    ``row_sum - clause_max`` lands one ULP under it, so the reference
    prunes the block and answers doc 128. The port's bound is rounded up:
    it reruns the row and answers doc 0, as exhaustive serving does."""
    texts = ["a b b b"] + ["a"] * 127
    for _ in range(3):  # three pass-1 blocks of a, each with a tf-4 doc
        texts += ["a"] * 5 + ["a a a a"] + ["a"] * 122
    texts[128] = "a b b b"
    texts += ["z"] * 91  # 603 docs: at these idfs the f32 sums round low
    ref, port = _pair([(_ref_segment(texts, NO_NORMS), None)])
    exact = port.search_batch([_or(T, ["a", "b"])], k=1, prune=False)[0]
    assert [d.doc for d in exact.score_docs] == [0]
    s = exact.score_docs[0].score
    pruned = port.search_batch([_or(T, ["a", "b"])], k=1, prune=True)[0]
    assert_pruned_strict(pruned, exact)
    want = ref.search_batch([_or(R, ["a", "b"])], k=1, prune=True)[0]
    assert [(d.doc, d.score) for d in want.score_docs] == [(128, s)]  # the reference's fault


def test_wand_bound_covers_every_summation_order():
    """searcher._wand_bound is at least every f32 sum, in any order, of a
    doc's clause scores when each is at its bound, on random rows of 2-6
    clauses; the reference's f32 formula falls below such a sum."""
    rng = np.random.default_rng(3)
    ref_low = 0
    for _ in range(300):
        n = int(rng.integers(2, 7))
        ub = (rng.random(n) * 10).astype(np.float32)
        got = searcher_mod._wand_bound(ub, np.zeros(n, np.int64), np.arange(n),
                                       np.ones(n, bool), 1)
        pos = np.asarray(ub, np.float32)
        ref_bound = ub + (pos.sum() - pos).astype(np.float32)
        for _ in range(6):
            order = rng.permutation(n)
            acc = np.float32(0.0)
            for j in order:
                acc = np.float32(acc + ub[j])
            assert (got >= acc).all()
            ref_low += int((ref_bound < acc).any())
    assert ref_low > 0


def test_fuzz_combined_vs_per_leaf_pruned():
    """The prune=True leg of the combined-vs-per-leaf fuzz: random boolean
    rows of every occur over the fuzz corpus, per leaf and through the
    combined view, exhaustive and pruned. The pass-1 selection runs per
    leaf or over the view, so pruned total_hits differ between the two:
    each is held to at most the exhaustive count."""
    _, port = _pair(_fuzz_index(4))
    comb = T.IndexSearcher(port.reader, device="cpu", combine_segments=True)
    rng = np.random.default_rng(777)
    occurs = ("should", "must", "filter", "must_not")
    rows = []
    for _ in range(48):
        q = T.BooleanQuery(min_should_match=int(rng.integers(0, 2)))
        for w in rng.choice(["s0"] + [f"t{i}" for i in range(30)], int(rng.integers(1, 5)),
                            replace=False):
            getattr(q, occurs[int(rng.integers(0, 4)) if rng.random() < 0.4 else 0])(
                T.TermQuery(T.Term("body", str(w))))
        rows.append(q)
    exact = port.search_batch(rows, k=15, prune=False)
    assert_batches_strict(comb.search_batch(rows, k=15, prune=False), exact)
    for searcher in (port, comb):
        for p, e in zip(searcher.search_batch(rows, k=15, prune=True), exact):
            assert_pruned_strict(p, e)


# --- the truncated-list check for order-dependent sums ---------------------------


def test_truncated_within_rtol_check():
    """tests/torch_hitcheck.assert_truncated_within_rtol, which phase 16 of
    chip_smoke.py holds 3-term pruned rows to: docs a few ULPs apart may
    trade places across the k-th score, a hit missed by more fails, as do
    a wrong score, a disorder and a total above the exhaustive one."""
    def td(total, pairs):
        return searcher_mod.TopDocs(total, [searcher_mod.ScoreDoc(d, s) for d, s in pairs])

    x = float(np.float32(3.0))
    up = float(np.nextafter(np.float32(x), np.float32(10.0)))
    want = td(50, [(1, 5.0), (2, 4.0), (7, up), (3, x), (4, x), (5, 2.0)])
    assert_truncated_within_rtol(td(50, [(1, 5.0), (2, 4.0), (7, up)]), want, 3)
    # doc 3's sum came out one ULP higher: it ranks before doc 7 and takes the 3rd slot
    assert_truncated_within_rtol(td(40, [(1, 5.0), (2, 4.0), (3, up)]), want, 3)
    bad = [
        td(50, [(1, 5.0), (7, up), (3, x)]),  # doc 2 (4.0) missed
        td(50, [(1, 5.0), (2, 4.1), (7, up)]),  # a score off by more than rtol
        td(50, [(2, 4.0), (1, 5.0), (7, up)]),  # not in score order
        td(51, [(1, 5.0), (2, 4.0), (7, up)]),  # total above the exhaustive
        td(50, [(1, 5.0), (2, 4.0), (9, 3.5)]),  # a doc the exhaustive run lacks
        td(50, [(1, 5.0), (2, 4.0)]),  # too few hits
    ]
    for got in bad:
        with pytest.raises(AssertionError):
            assert_truncated_within_rtol(got, want, 3)
    # past the wide list's end, only inside its last tie band
    wide = td(50, [(1, 5.0), (2, x), (3, x)])
    assert_truncated_within_rtol(td(50, [(1, 5.0), (8, x)]), wide, 2)
    with pytest.raises(AssertionError):
        assert_truncated_within_rtol(td(50, [(1, 5.0), (8, 4.5)]), wide, 2)


# --- a leaf without postings ------------------------------------------------------


@pytest.mark.parametrize("decoded", ["0", "1"])
@pytest.mark.parametrize("combine", [False, True])
def test_leaf_without_postings(monkeypatch, decoded, combine):
    """A segment whose docs hold only a point field has no postings block.
    Term and boolean rows over it beside a text segment answer as the
    reference's (the device form keeps one empty block for the work
    list's inert item), pruned or not. The reference's pruned path indexes
    the empty block-max table and raises (ROADMAP.md §3); the port's does
    not."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    text = _ref_segment(["a b c", "a a b", "c d"] * 50)
    buf = SegmentBuffer()
    for i in range(20):
        d = R.Document()
        d.add(R.IntPoint("ts", i))
        buf.add_document(d)
    points = pack_segment(buf.finish())
    assert points.num_blocks == 0
    ref, port = _pair([(text, None), (points, None)])
    if combine:
        port = T.IndexSearcher(port.reader, device="cpu", combine_segments=True)

    def rows(P):
        t = lambda w: P.TermQuery(P.Term("body", w))  # noqa: E731
        return [_or(P, ["a", "c"]), t("a"), P.BooleanQuery().must(t("a")).must(t("c"))]

    want = ref.search_batch(rows(R), k=3, prune=False)
    assert_batches_strict(port.search_batch(rows(T), k=3, prune=False), want)
    for p, w in zip(port.search_batch(rows(T), k=3, prune=True), want):
        assert_pruned_strict(p, w)
    with pytest.raises(IndexError):
        ref.search_batch(rows(R), k=3, prune=True)

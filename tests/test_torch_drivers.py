"""The port's entry points (rucene_tpu_torch/drivers, rucene_tpu_torch/
examples) on the CPU, against the repo's drivers, which import rucene_tpu.

- drivers.workload's builders equal bench.py's: corpora, vocabulary, the
  bigram sampler, the mix, the default-docs rule;
- build_bench_cache writes the bytes bench.cache_segment writes, and
  rebuilds a torn cache file;
- drivers.bench prints a JSON line with bench.py's keys but its
  bandwidth share, and serve_mix's
  TopDocs on an index carried across with packed_from_reference equal the
  reference's (tests/torch_hitcheck.py), decoded and packed; ``--nrt``
  ingests while it serves;
- BENCH_PRUNE parses as bench.py's, reaches search_batch(prune=) in
  ``main`` and ``serve_mix``, and labels the metric ``+prune``;
- drivers.profile_bench captures and analyses two batches;
- drivers.profile_candidate prints every stage on the CPU, its top-k stage
  taking the block-max chunk pass and equal to stable_top_k;
- both examples print the reference's lines;
- graft_entry.entry's top-10 equals the reference executor's on
  __graft_entry__.entry's segment and rows (with has_ef, as the
  reference's searcher calls it), and dryrun_multichip(2) runs over gloo;
- every entry point asked for the card where there is none fails and
  prints no result.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench as ref_bench
import rucene_tpu as R
from rucene_tpu.index.reader import IndexReader as RefReader
from rucene_tpu.index.reader import SegmentSnapshot as RefSnapshot

from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.drivers import (
    bench,
    build_bench_cache,
    graft_entry,
    profile_bench,
    profile_candidate,
)
from rucene_tpu_torch.drivers import workload as wl
from rucene_tpu_torch.examples import stable_lines
from rucene_tpu_torch.native import available as native_available
from tests.torch_hitcheck import assert_batches_strict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}  # bench.py's, but its bandwidth share
N_DOCS = 3000


def _rows(q):
    rq = q.rewrite()
    return (
        type(q).__name__,
        [(int(c.occur), c.term.field, c.term.text) for c in rq.clauses],
        [(f, list(ts), b, s) for f, ts, b, s in rq.phrases],
    )


@pytest.fixture(scope="module")
def corpus():
    texts, vocab, probs = ref_bench.build_corpus(N_DOCS)
    return texts, vocab, probs, ref_bench.pack_corpus(texts)


# --- workload -----------------------------------------------------------------


def test_workload_equals_bench(tmp_path):
    texts, vocab, probs = wl.build_corpus(400, seed=3)
    r_texts, r_vocab, r_probs = ref_bench.build_corpus(400, seed=3)
    assert texts == r_texts and list(vocab) == list(r_vocab) and np.array_equal(probs, r_probs)
    z_vocab, z_probs = wl.zipf_vocab(500)
    r_vocab, r_probs = ref_bench.zipf_vocab(500)
    assert list(z_vocab) == list(r_vocab) and np.array_equal(z_probs, r_probs)
    assert wl.sample_bigrams(texts, 30, seed=5) == ref_bench.sample_bigrams(texts, 30, seed=5)
    for phrase_texts in (None, texts):
        mine = wl.build_queries(48, z_vocab, z_probs, seed=2, phrase_texts=phrase_texts)
        ref = ref_bench.build_queries(48, r_vocab, r_probs, seed=2, phrase_texts=phrase_texts)
        assert [_rows(q) for q in mine] == [_rows(q) for q in ref]
    for name in ("bench-zipf-2000.seg", "bench-zipf-1000001.seg", "bench-pytext-9.seg", "x.seg"):
        (tmp_path / name).write_bytes(b"")
    for kind in ("zipf", "pytext", "other"):
        assert wl.default_docs(str(tmp_path), kind) == ref_bench._default_docs(str(tmp_path), kind)
    assert wl.default_docs(str(tmp_path), "zipf") == 2000
    assert wl.default_docs(None, "zipf") == ref_bench._default_docs("", "zipf") == 50000


def test_pytext_corpus_equals_bench():
    texts, vocab, probs = wl.build_corpus_pytext(300)
    r_texts, r_vocab, r_probs = ref_bench.build_corpus_pytext(300)
    assert texts == r_texts and list(vocab) == list(r_vocab) and np.array_equal(probs, r_probs)


def test_cache_builder_writes_the_reference_bytes(tmp_path):
    texts, _, _ = ref_bench.build_corpus(1500)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    ref_bench.cache_segment(str(ref_dir), "bench-zipf-1500", ref_bench.pack_corpus(texts))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = build_bench_cache.main(["1500", "zipf", "--cache", str(port_dir)])
    assert os.path.basename(path) == "bench-zipf-1500.seg"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir)) == ["bench-zipf-1500.seg"]
    assert (port_dir / "bench-zipf-1500.seg").read_bytes() == (ref_dir / "bench-zipf-1500.seg").read_bytes()
    assert wl.default_docs(str(port_dir), "zipf") == 1500
    # a second run validates the file; a torn one is rebuilt to the same bytes
    with contextlib.redirect_stdout(out):
        build_bench_cache.main(["1500", "--cache", str(port_dir)])
        assert "already cached (validated)" in out.getvalue()
        good = (port_dir / "bench-zipf-1500.seg").read_bytes()
        (port_dir / "bench-zipf-1500.seg").write_bytes(good[: len(good) // 2])
        build_bench_cache.main(["1500", "--cache", str(port_dir)])
    assert "invalid" in out.getvalue()
    assert (port_dir / "bench-zipf-1500.seg").read_bytes() == good


# --- the bench driver ---------------------------------------------------------


@pytest.mark.parametrize("reader", ["decoded", "packed"])
def test_serve_mix_equals_reference(corpus, reader):
    texts, vocab, probs, ref_packed = corpus
    queries = wl.build_queries(64, vocab, probs, phrase_texts=texts[:5000])
    ref_q = ref_bench.build_queries(64, vocab, probs, phrase_texts=texts[:5000])
    searcher = bench.open_searcher(packed_from_reference(ref_packed), "cpu", reader)
    assert (searcher.reader.leaves[0].device.docs_dec is not None) == (reader == "decoded")
    served = bench.serve_mix(searcher, queries, batch=16, k=100, depth=3, min_s=0.0)
    assert served.reps == 3 and len(served.batch_ms) == 3 * 4 and served.qps > 0
    want = R.IndexSearcher(RefReader([RefSnapshot("bench", ref_packed)])).search_batch(ref_q, k=100)
    assert_batches_strict(served.results, want)


def test_bench_main_prints_bench_keys(corpus, tmp_path, capsys):
    texts, vocab, probs, ref_packed = corpus
    # the reference's cache file, read by the port's driver
    ref_bench.cache_segment(str(tmp_path), f"bench-zipf-{N_DOCS}", ref_packed)
    args = bench.parse_args(["--device", "cpu", "--queries", "64", "--batch", "32",
                             "--cache", str(tmp_path), "--baseline", "numpy"])
    result = bench.main(args)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == BENCH_KEYS and line == result
    assert f"{N_DOCS} docs" in line["metric"] and line["value"] > 0 and line["vs_baseline"] > 0
    assert "postings traffic" not in err  # the lane counter and its figure are gone
    assert f"loading cached index bench-zipf-{N_DOCS}" in err
    routes = next(ln for ln in err.splitlines() if ln.startswith("# routes:"))
    assert "device=" in routes and "phrase=" in routes and "host=0" in routes
    timers = next(ln for ln in err.splitlines() if ln.startswith("# timers(timed-only):"))
    for span in ("search.batch=", "search.device.dispatch=", "search.phrases=",
                 "search.device.tables=", "search.device.launch="):
        assert span in timers
    assert "batch latency p50" in err and "baseline(single-core numpy engine)" in err


@pytest.mark.parametrize("value,want", [
    (None, None), ("auto", None), ("", None), ("1", True), ("0", False), ("yes", False),
])
def test_bench_prune_parses_as_bench_py(monkeypatch, value, want):
    """bench.py:288-289: ``auto`` or empty -> prune=None, else ``1``."""
    if value is None:
        monkeypatch.delenv("BENCH_PRUNE", raising=False)
    else:
        monkeypatch.setenv("BENCH_PRUNE", value)
    assert bench.bench_prune() is want
    raw = "auto" if value is None else value
    assert (None if raw in ("auto", "") else raw == "1") is want  # bench.py's own lines


def test_bench_prune_reaches_the_searcher(corpus, tmp_path, monkeypatch, capsys):
    """BENCH_PRUNE=1: every search_batch(_async) of ``main`` gets
    prune=True, and the metric says ``+prune``; serve_mix passes its
    prune= on."""
    texts, vocab, probs, ref_packed = corpus
    ref_bench.cache_segment(str(tmp_path), f"bench-zipf-{N_DOCS}", ref_packed)
    seen = []
    from rucene_tpu_torch.search import searcher as searcher_mod

    orig = searcher_mod.IndexSearcher.search_batch_async

    def spy(self, queries, k=10, timeout_s=None, prune=None):
        seen.append(prune)
        return orig(self, queries, k, timeout_s=timeout_s, prune=prune)

    monkeypatch.setattr(searcher_mod.IndexSearcher, "search_batch_async", spy)
    monkeypatch.setenv("BENCH_PRUNE", "1")
    args = bench.parse_args(["--device", "cpu", "--queries", "64", "--batch", "32",
                             "--cache", str(tmp_path), "--baseline", "numpy"])
    line = bench.main(args)
    assert line["metric"].endswith(" +prune") and seen and all(p is True for p in seen)
    del seen[:]
    monkeypatch.setenv("BENCH_PRUNE", "auto")
    assert "+prune" not in bench.main(args)["metric"] and set(seen) == {None}
    capsys.readouterr()
    searcher = bench.open_searcher(packed_from_reference(ref_packed), "cpu", "packed")
    del seen[:]
    queries = wl.build_queries(32, vocab, probs)
    served = bench.serve_mix(searcher, queries, batch=16, k=10, min_s=0.0, prune=False)
    assert set(seen) == {False} and served.reps == 3


def test_nrt_driver_ingests_while_serving(capsys):
    args = bench.parse_args(["--nrt", "--device", "cpu", "--docs", "2000", "--seconds", "2"])
    result = bench.main_nrt(args)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == result and set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["value"] > 0 and line["vs_baseline"] == 0.0
    ingest = next(ln for ln in err.splitlines() if ln.startswith("# nrt: ingested"))
    assert int(ingest.split()[3]) > 0 and "refreshes" in ingest and "p99" in ingest


def test_profile_bench_on_the_cpu(tmp_path, capsys):
    log_dir = str(tmp_path / "prof")
    out = profile_bench.main(["--device", "cpu", "--docs", "2000", "--batch", "32",
                              "--batches", "2", "--cache", "", "--log-dir", log_dir])
    # per batch: the outer spans, and the stages of one 2,000-doc leaf (the
    # flat route's three table spans, on the dense branch; the phrase rows
    # on the scalar engine, or without it on the candidate pipeline)
    per_batch = {
        "search.device.dispatch": 1, "search.phrases.dispatch": 1,
        "search.device": 1, "search.phrases": 1,
        "search.device.tables": 3, "search.device.conj_prune": 1,
        "search.device.combine_tables": 1,
        "search.device.launch": 2,  # the uploads; after the combine build, the executor call
        "search.device.wait": 1, "search.device.merge": 1,
        "search.phrases.select": 2, "search.phrases.merge": 1,
    }
    if native_available:
        per_batch["search.phrases.scalar"] = 1
    else:
        per_batch.update({"search.phrases.launch": 1, "search.phrases.wait": 1})
    assert {n: c for n, (_ms, c) in out["spans"].items()} == {
        n: 2 * c for n, c in per_batch.items()}
    again = profile_bench.main(["--analyze-only", "--log-dir", log_dir])
    assert again["spans"] == out["spans"] and again["ops"] == out["ops"]
    assert "-- host spans" in capsys.readouterr().out


def test_profile_candidate_on_the_cpu(capsys):
    """Every stage of the reference's tools/profile_candidate.py prints,
    in its order; at 40,000 docs and k=10 the rows are wide enough for
    the chunk pass (32,768 columns or more), whose answer equals
    stable_top_k's."""
    out = profile_candidate.main(["--device", "cpu", "--docs", "40000", "--cache", "",
                                  "--batch", "64", "--k", "10"])
    printed = capsys.readouterr().out
    stages = ["decode+score", "decode+scatter_score", "decode+scatter_counts",
              "topk_dense[B,md]", "torch.topk[B,md]", "full_dense", "full_candidate"]
    assert [ln.split()[0] for ln in printed.splitlines() if ln.split()[0] in stages] == stages
    assert all(out[s] > 0 for s in stages)
    assert out["chunk_pass"] is True and out["topk_equal"] is True


# --- the examples -------------------------------------------------------------


def _run(args, env=None):
    proc = subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": REPO, **(env or {})})
    return proc


@pytest.mark.parametrize("name", ["example", "nrt_search"])
def test_example_prints_the_reference_lines(name):
    ref = _run([os.path.join("examples", f"{name}.py")], {"JAX_PLATFORMS": "cpu"})
    port = _run(["-m", f"rucene_tpu_torch.examples.{name}", "--device", "cpu"])
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    want = stable_lines(ref.stdout)
    assert stable_lines(port.stdout) == want
    assert len(want) >= 3 and any("fox" in ln for ln in want)


# --- the graft entry ----------------------------------------------------------


def test_graft_entry_equals_reference():
    """The port's step against the reference's on the same rows and
    segment. The reference's entry() calls its executor without
    ``has_ef``, so rows whose postings hold Elias-Fano blocks lose hits
    there (ROADMAP.md §3, faults of the reference): it is held here with
    has_ef=True, as its searcher calls it, and its own fn must differ on
    exactly the rows the searcher answers otherwise."""
    import jax

    import __graft_entry__ as ref_graft
    from rucene_tpu.search.executor import execute_flat_impl

    ref_fn, ref_args = ref_graft.entry()
    r_scores, r_docs, r_hits = (np.asarray(x) for x in jax.jit(
        lambda seg, fq: execute_flat_impl(seg, fq, k=10, has_ef=True))(*ref_args))
    fn, args = graft_entry.entry("cpu")
    scores, docs, hits = (x.numpy() for x in fn(*args))
    assert scores.shape == r_scores.shape == (16, 10)
    assert np.array_equal(hits, r_hits) and np.array_equal(docs, r_docs)
    np.testing.assert_allclose(scores, r_scores, rtol=4e-7, atol=0)
    assert (hits > 0).all()
    searcher = R.IndexSearcher(ref_graft._build_index(512)[0])
    assert hits.tolist() == [td.total_hits for td in searcher.search_batch(_graft_rows(R), k=10)]
    no_ef_hits = np.asarray(jax.jit(ref_fn)(*ref_args)[2])
    assert (no_ef_hits != hits).any() and (no_ef_hits <= hits).all()


def _graft_rows(P):
    """entry()'s 16 rows: term rows and two-term OR rows."""
    vocab = graft_entry.VOCAB
    rows = []
    for i in range(16):
        if i % 2 == 0:
            rows.append(P.TermQuery(P.Term("body", vocab[i % 50])))
        else:
            rows.append(P.BooleanQuery().should(P.TermQuery(P.Term("body", vocab[i % 50])))
                        .should(P.TermQuery(P.Term("body", vocab[(i * 3) % 50]))))
    return rows


def test_dryrun_multichip_over_gloo(capsys):
    outs = graft_entry.dryrun_multichip(2, device="cpu")
    assert [o["rank"] for o in outs] == [0, 1]
    assert [o["owned"] for o in outs] == [[0], [1]]
    assert all(o["shape"] == [2, 1] and o["rows"] == 15 for o in outs)
    assert any(n > 0 for n, _ in outs[0]["hits"])
    assert "dryrun_multichip OK" in capsys.readouterr().out


# --- no card: fail, never fall back to the CPU ----------------------------------


@pytest.mark.parametrize("module", [
    "rucene_tpu_torch.drivers.bench",
    "rucene_tpu_torch.drivers.profile_bench",
    "rucene_tpu_torch.drivers.profile_candidate",
    "rucene_tpu_torch.drivers.graft_entry",
    "rucene_tpu_torch.examples.example",
    "rucene_tpu_torch.examples.nrt_search",
])
def test_entry_point_needs_the_card(module):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    proc = _run(["-m", module, *(["--docs", "2000", "--cache", ""] if "bench" in module else [])])
    assert proc.returncode != 0
    assert "finds no CUDA card" in proc.stderr
    assert not proc.stdout.strip()

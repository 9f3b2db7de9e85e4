"""The port's host layer: it runs without jax, and its copied modules stay
the reference's modules.

(a) In a subprocess whose import system refuses ``jax``, import
    rucene_tpu_torch, build a 200-doc index and search it on the CPU, a
    filter row and a host row among the rows, then write the same docs
    with IndexWriter into a temporary FSDirectory, reopen them with
    open_directory_reader and serve two rows (and again through the
    combined view), serve three rows on a two-shard mesh
    (rucene_tpu_torch.parallel) and lay out a pod mesh, serve a parsed query
    string, a SpanOrQuery, an unordered SpanNearQuery, a sorted row and a
    collapse row from an index with doc values, serve a pruned OR row
    (search_batch(prune=True)), and import every entry
    point (rucene_tpu_torch.drivers, rucene_tpu_torch.examples): the card's
    host has no jax.
(b) Drift guard: every host module the port copies from rucene_tpu equals
    its original (syntax tree, module docstring aside) once the import
    prefix is mapped, apart from the definitions its docstring lists under
    "Port changes". The index format and the query semantics cannot drift
    apart unnoticed.
(c) chip_smoke.py's corpus, bigram sampler and query builder, which it
    imports from rucene_tpu_torch/drivers/workload.py, reproduce bench.py's,
    phrase rows included.
"""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = [
    "analysis/__init__.py",
    "analysis/tokenizer.py",
    "codec/bulk_read.py",
    "codec/dv_codec.py",
    "codec/files.py",
    "codec/postings.py",
    "codec/split.py",
    "doc/__init__.py",
    "doc/document.py",
    "doc/field.py",
    "doc/term.py",
    "highlight/__init__.py",
    "highlight/fvh.py",
    "index/doc_writer.py",
    "index/field_infos.py",
    "index/index_lookup.py",
    "index/index_sorting.py",
    "index/memory.py",
    "index/merge.py",
    "index/merge_scheduler.py",
    "index/writer.py",
    "native/__init__.py",
    "ops/combine_tables.py",
    "search/cache.py",
    "search/explain.py",
    "search/explanation.py",
    "search/host_engine.py",
    "search/pair_path.py",
    "search/plane_path.py",
    "search/query.py",
    "search/query_string.py",
    "search/rescorer.py",
    "search/scalar_engine.py",
    "search/search_manager.py",
    "search/similarity.py",
    "search/sort_field.py",
    "search/span_native.py",
    "search/spans.py",
    "store/__init__.py",
    "store/directory.py",
    "tools/__init__.py",
    "tools/check_index.py",
    "util/__init__.py",
    "util/bkd.py",
    "util/front_coding.py",
    "util/lz4_py.py",
    "util/metrics.py",
    "util/packing.py",
    "util/small_float.py",
]

_NO_JAX_SCRIPT = r"""
import importlib.abc, json, sys

class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ModuleNotFoundError(f"No module named {name!r} (blocked)")
        return None

sys.meta_path.insert(0, _NoJax())
import numpy as np
import rucene_tpu_torch as T
from rucene_tpu_torch.codec.postings import pack_segment
from rucene_tpu_torch.index.memory import SegmentBuffer
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot

rng = np.random.default_rng(7)
words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
buf = SegmentBuffer()
texts = [" ".join(rng.choice(words, int(rng.integers(3, 15)))) for _ in range(200)]
for text in texts:
    d = T.Document()
    d.add(T.TextField("body", text))
    buf.add_document(d)
searcher = T.IndexSearcher(
    IndexReader([SegmentSnapshot("s", pack_segment(buf.finish()))]), device="cpu"
)
q = T.BooleanQuery()
q.must(T.TermQuery(T.Term("body", "alpha")))
q.should(T.TermQuery(T.Term("body", "beta")))
q.must_not(T.TermQuery(T.Term("body", "eta")))
inner = T.BooleanQuery()
inner.should(T.TermQuery(T.Term("body", "zeta")))
inner.should(T.TermQuery(T.Term("body", "theta")))
nested = T.BooleanQuery()
nested.must(inner)
nested.filter(T.ExistsQuery("body"))
hits = searcher.search_batch(
    [T.TermQuery(T.Term("body", "gamma")), q, T.PhraseQuery("body", ["alpha", "beta"]), nested],
    k=10,
)
por = T.BooleanQuery().should(T.TermQuery(T.Term("body", "gamma"))).should(
    T.TermQuery(T.Term("body", "zeta")))
pruned = [searcher.search_batch([por], k=3, prune=p)[0] for p in (True, False)]
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    w = T.IndexWriter(T.FSDirectory(tmp), T.IndexWriterConfig(max_buffered_docs=64))
    for text in texts:
        d = T.Document()
        d.add(T.TextField("body", text))
        w.add_document(d)
    w.commit()
    w.close()
    disk = T.IndexSearcher(T.open_directory_reader(T.FSDirectory(tmp)), device="cpu")
    on_disk = [disk.search(q, 10) for q in (T.TermQuery(T.Term("body", "gamma")), q)]
    in_memory = [searcher.search(q, 10) for q in (T.TermQuery(T.Term("body", "gamma")), q)]
    leaves = len(disk.reader.leaves)
    comb = T.IndexSearcher(T.open_directory_reader(T.FSDirectory(tmp)), device="cpu",
                           combine_segments=True)
    combined = [comb.search(q, 10) for q in (T.TermQuery(T.Term("body", "gamma")), q)]
from rucene_tpu_torch.parallel import multi_host, sharded

mesh = sharded.make_mesh(2, 1, devices=["cpu", "cpu"])
on_mesh = sharded.ShardedSearcher(sharded.ShardedIndex(mesh, searcher.reader)).search_batch(
    [T.TermQuery(T.Term("body", "gamma")), q, T.PhraseQuery("body", ["alpha", "beta"])], k=10
)
from rucene_tpu_torch.search.sort_field import SortFieldType
from rucene_tpu_torch.search.spans import SpanNearQuery, SpanOrQuery, SpanTermQuery

w2 = T.IndexWriter(T.RAMDirectory(), T.IndexWriterConfig(max_buffered_docs=64))
for i, text in enumerate(texts):
    d = T.Document()
    d.add(T.TextField("body", text))
    d.add(T.NumericDocValuesField("rank", i % 17))
    w2.add_document(d)
dv = T.IndexSearcher(w2.get_reader(), device="cpu")
st = lambda w: SpanTermQuery(T.Term("body", w))
surface = dv.search_batch(
    [T.parse_query_string('+alpha -"beta gamma"'), SpanOrQuery([st("zeta"), st("eta")]),
     SpanNearQuery([st("alpha"), st("delta")], slop=2, in_order=False)],
    k=10,
)
srt = dv.search_sorted(T.TermQuery(T.Term("body", "gamma")), 10,
                       T.Sort([T.SortField("rank", SortFieldType.LONG, reverse=True)]))
col = dv.search_collapse(T.TermQuery(T.Term("body", "gamma")), 10, "rank")
import rucene_tpu_torch.drivers.bench, rucene_tpu_torch.drivers.build_bench_cache
import rucene_tpu_torch.drivers.graft_entry, rucene_tpu_torch.drivers.profile_bench
import rucene_tpu_torch.drivers.profile_candidate
import rucene_tpu_torch.drivers.workload, rucene_tpu_torch.examples.example
import rucene_tpu_torch.examples.nrt_search
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "rucene_tpu"))
print(json.dumps({
    "loaded": loaded,
    "hits": [[h.total_hits, [[d, s] for d, s in h.score_docs]] for h in hits],
    "disk": [[h.total_hits, [[d, s] for d, s in h.score_docs]] for h in on_disk],
    "memory": [[h.total_hits, [[d, s] for d, s in h.score_docs]] for h in in_memory],
    "leaves": leaves,
    "combined": [[h.total_hits, [[d, s] for d, s in h.score_docs]] for h in combined],
    "mesh": [[h.total_hits, [[d, s] for d, s in h.score_docs]] for h in on_mesh],
    "pod": multi_host.make_pod_mesh(devices=["cpu"]).shape,
    "surface": [[h.total_hits, len(h.score_docs)] for h in surface],
    "sorted": [srt.total_hits, [fd.fields[0] for fd in srt.field_docs]],
    "collapse": [col.total_hits, len(col.score_docs)],
    "pruned": [[h.total_hits, [[d, s] for d, s in h.score_docs]] for h in pruned],
}))
"""


def test_port_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    (n1, top1), (n2, top2), (n3, top3), (n4, top4) = out["hits"]
    assert n1 > 0 and n2 > 0 and n3 > 0 and n4 > 0
    assert len(top4) == min(10, n4)
    assert len(top3) == min(10, n3)
    assert len(top1) == 10 and len(top2) == min(10, n2)
    assert all(a[1] >= b[1] for a, b in zip(top2, top2[1:]))
    # the write path: an index written to disk by the port's IndexWriter
    # (four segments) and opened with open_directory_reader
    assert out["leaves"] == 4
    assert out["disk"] == out["memory"] and out["disk"][0][0] == n1
    # the combined view over the four segments, and a two-shard mesh
    # (the one segment split in two) over the in-memory reader
    assert out["combined"] == out["disk"]
    assert [m[0] for m in out["mesh"]] == [n1, n2, n3]
    assert out["mesh"][0] == out["hits"][0] and out["pod"] == {"shard": 1, "dp": 1}
    # a parsed query string, a synonym row, an unordered span row, a sorted
    # row and a collapse row
    assert all(n > 0 and m == min(10, n) for n, m in out["surface"])
    n_sorted, values = out["sorted"]
    assert n_sorted > 0 and values == sorted(values, reverse=True) and len(values) == 10
    assert out["collapse"][0] == n_sorted and 0 < out["collapse"][1] <= 10
    # a pruned OR row (WAND) answers as the exhaustive one
    (np_, top_p), (ne, top_e) = out["pruned"]
    assert top_p == top_e and len(top_e) == 3 and 0 < np_ <= ne


# --- (b) drift guard ----------------------------------------------------------


def _listed_changes(tree: ast.Module) -> set[str]:
    doc = ast.get_docstring(tree) or ""
    if "Port changes" not in doc:
        return set()
    return set(re.findall(r"^- ([\w.]+):", doc.split("Port changes", 1)[1], re.M))


def _prune(body, prefix: str, changed: set[str], seen: set[str]):
    """Drop the listed definitions (by qualified name) from a body."""
    out = []
    for node in body:
        name = None
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            name = node.targets[0].id
        qual = prefix + name if name else None
        if qual in changed:
            seen.add(qual)
            continue
        if isinstance(node, ast.ClassDef):
            node.body = _prune(node.body, qual + ".", changed, seen)
        out.append(node)
    return out


def _tree_without(src: str, changed: set[str]):
    tree = ast.parse(src)
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    seen: set[str] = set()
    tree.body = _prune(tree.body, "", changed, seen)
    return ast.dump(tree), seen


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_reference(rel):
    with open(os.path.join(REPO, "rucene_tpu", rel)) as f:
        original = re.sub(r"\brucene_tpu\b", "rucene_tpu_torch", f.read())
    with open(os.path.join(REPO, "rucene_tpu_torch", rel)) as f:
        copy = f.read()
    changed = _listed_changes(ast.parse(copy))
    want, _ = _tree_without(original, changed)
    got, seen = _tree_without(copy, changed)
    assert seen == changed, f"listed but not defined in the copy: {changed - seen}"
    assert got == want, f"rucene_tpu_torch/{rel} drifted from rucene_tpu/{rel}"


# --- (c) the smoke's workload is the bench's ---------------------------------


def test_smoke_workload_matches_bench():
    import bench
    import chip_smoke
    from rucene_tpu_torch.drivers import workload

    for name in ("build_corpus", "sample_bigrams", "build_queries", "pack_corpus", "YEAR_S"):
        assert getattr(chip_smoke, name) is getattr(workload, name)
    texts, vocab, probs = chip_smoke.build_corpus(300)
    b_texts, b_vocab, b_probs = bench.build_corpus(300)
    assert texts == b_texts
    assert np.array_equal(probs, b_probs) and list(vocab) == list(b_vocab)

    def rows(q):
        rq = q.rewrite()
        return (
            type(q).__name__,
            [(int(c.occur), c.term.field, c.term.text) for c in rq.clauses],
            [(f, list(ts), b, s) for f, ts, b, s in rq.phrases],
        )

    assert chip_smoke.sample_bigrams(texts, 40) == bench.sample_bigrams(b_texts, 40)
    assert chip_smoke.sample_bigrams(texts, 5, seed=3) == bench.sample_bigrams(b_texts, 5, seed=3)
    for phrase_texts in (None, texts):
        mine = chip_smoke.build_queries(64, vocab, probs, phrase_texts=phrase_texts)
        ref = bench.build_queries(64, b_vocab, b_probs, phrase_texts=phrase_texts)
        assert [rows(q) for q in mine] == [rows(q) for q in ref]
    phrase_at = [i for i, q in enumerate(ref) if type(q).__name__ == "PhraseQuery"]
    assert phrase_at == list(range(7, 64, 8))


# --- (d) phase 12's core on the card ------------------------------------------


@pytest.mark.gpu
def test_nrt_core_on_card():
    """Refresh, delete and read back on the card: a SearcherManager on
    CUDA over the port's writer. Markers added in chunks are found once
    after a refresh; deleted markers and a word deleted by query find
    nothing after the next; the rows equal a CPU reader opened on the
    committed directory; a searcher acquired before a merging refresh
    answers bit for bit as before, and the delete refresh builds no
    device form."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import rucene_tpu_torch as T
    from rucene_tpu_torch.util.metrics import METRICS
    from torch_hitcheck import assert_batches_strict

    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(60)]
    ram = T.RAMDirectory()
    w = T.IndexWriter(ram, T.IndexWriterConfig(max_buffered_docs=400, merge_on_commit=False))
    mgr = T.SearcherManager(w, searcher_factory=lambda r: T.IndexSearcher(r, device="cuda"))
    rows = [T.TermQuery(T.Term("body", words[i])) for i in range(4)] + [
        T.BooleanQuery().should(T.TermQuery(T.Term("body", "w1"))).should(
            T.TermQuery(T.Term("body", "w5"))),
        T.BooleanQuery().must(T.TermQuery(T.Term("body", "w2"))).must(
            T.TermQuery(T.Term("body", "w3"))),
        T.PhraseQuery("body", ["w0", "w1"]),
    ]
    for chunk in range(12):
        docs = []
        for _ in range(150):
            d = T.Document()
            d.add(T.TextField("body", " ".join(rng.choice(words, int(rng.integers(4, 20))))))
            docs.append(d)
        m = T.Document()
        m.add(T.StringField("marker", f"m{chunk}"))
        w.add_documents(docs + [m])
        if chunk % 3 == 2:
            w.commit()
            mgr.maybe_refresh()
            mgr.acquire().search_batch(rows, k=50)
    w.commit()
    mgr.maybe_refresh()
    s = mgr.acquire()
    marks = s.search_batch([T.TermQuery(T.Term("marker", f"m{j}")) for j in range(12)], k=5)
    assert [td.total_hits for td in marks] == [1] * 12
    METRICS.reset()
    for j in range(0, 12, 2):
        w.delete_documents_by_term(T.Term("marker", f"m{j}"))
    w.delete_documents_by_query(T.TermQuery(T.Term("body", "w40")))
    w.commit()
    assert mgr.maybe_refresh()
    s = mgr.acquire()
    gone = s.search_batch([T.TermQuery(T.Term("marker", f"m{j}")) for j in range(0, 12, 2)]
                          + [T.TermQuery(T.Term("body", "w40"))], k=5)
    assert all(td.total_hits == 0 for td in gone)
    card = s.search_batch(rows, k=50)
    assert METRICS.snapshot()["counters"].get("reader.device_builds", 0) == 0
    cpu = T.IndexSearcher(T.open_directory_reader(ram), device="cpu")
    assert_batches_strict(card, cpu.search_batch(rows, k=50))
    w.force_merge(2)
    w.commit()
    assert mgr.maybe_refresh()
    assert s.search_batch(rows, k=50) == card
    merged = mgr.acquire().search_batch(rows, k=50)
    assert_batches_strict(merged, T.IndexSearcher(T.open_directory_reader(ram), device="cpu")
                          .search_batch(rows, k=50))
    w.close()

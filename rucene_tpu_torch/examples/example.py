"""End-to-end example (counterpart of examples/example.py, the workload of
the reference's examples/example.rs): index documents, commit, NRT
reopen, TermQuery search, highlight.

Run: python -m rucene_tpu_torch.examples.example [--device cpu]
"""

import argparse
import tempfile

import rucene_tpu_torch as rt
from rucene_tpu_torch.drivers import require_device
from rucene_tpu_torch.highlight import FastVectorHighlighter, FieldQuery
from rucene_tpu_torch.index.writer import IndexWriter
from rucene_tpu_torch.search.search_manager import SearcherManager
from rucene_tpu_torch.store.directory import FSDirectory


def main(device="cuda"):
    dev = require_device(device)
    path = tempfile.mkdtemp(prefix="rucene_tpu_example_")
    directory = FSDirectory(path)
    writer = IndexWriter(directory)

    docs = [
        "The quick brown fox jumps over the lazy dog",
        "A quick brown cat naps in the warm afternoon sun",
        "The dog barks at the quick brown fox by the river",
        "TPU native search engines score documents in batches",
    ]
    for i, text in enumerate(docs):
        doc = rt.Document()
        doc.add(rt.StringField("id", f"doc{i}", stored=True))
        doc.add(rt.TextField("body", text, stored=True, term_vectors=True))
        writer.add_document(doc)
    writer.commit()
    print(f"committed {len(docs)} docs to {path}")

    # NRT: add one more doc, visible via maybe_refresh without a commit
    manager = SearcherManager(writer, searcher_factory=lambda r: rt.IndexSearcher(r, device=dev))
    extra = rt.Document()
    extra.add(rt.StringField("id", "doc4", stored=True))
    extra.add(rt.TextField("body", "a very quick fox indeed", stored=True, term_vectors=True))
    writer.add_document(extra)
    manager.maybe_refresh()
    searcher = manager.acquire()

    query = rt.TermQuery(rt.Term("body", "fox"))
    top = searcher.search(query, k=10)
    print(f"\nTermQuery(body:fox): {top.total_hits} hits")
    highlighter = FastVectorHighlighter()
    fq = FieldQuery.build(query)
    for sd in top.score_docs:
        stored = searcher.reader.document(sd.doc)
        frags = highlighter.get_best_fragments(fq, searcher.reader, sd.doc, "body")
        print(f"  {stored['id']}  score={sd.score:.4f}  {frags[0] if frags else stored['body']}")

    bq = rt.BooleanQuery()
    bq.must(rt.TermQuery(rt.Term("body", "quick")))
    bq.must_not(rt.TermQuery(rt.Term("body", "dog")))
    top2 = searcher.search(bq, k=10)
    print(f"\nquick AND NOT dog: {[searcher.reader.document(sd.doc)['id'] for sd in top2.score_docs]}")

    pq = rt.PhraseQuery("body", ["quick", "brown"])
    top3 = searcher.search(pq, k=10)
    print(f'phrase "quick brown": {[searcher.reader.document(sd.doc)["id"] for sd in top3.score_docs]}')

    # prefix + query-string syntax
    top4 = searcher.search(rt.PrefixQuery("body", "qu"), k=10)
    print(f"prefix qu*: {top4.total_hits} hits")
    from rucene_tpu_torch.search.query_string import parse_query_string

    qs = parse_query_string("quick AND NOT dog", default_field="body")
    print(f'"quick AND NOT dog": {searcher.search(qs, k=10).total_hits} hits')

    # spans: unordered proximity
    from rucene_tpu_torch.search.spans import SpanNearQuery, SpanTermQuery

    near = SpanNearQuery(
        [SpanTermQuery(rt.Term("body", "quick")), SpanTermQuery(rt.Term("body", "fox"))],
        slop=2,
        in_order=False,
    )
    print(f"near(quick, fox, slop=2): {searcher.search(near, k=10).total_hits} hits")

    writer.close()


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m rucene_tpu_torch.examples.example")
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)

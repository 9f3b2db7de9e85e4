"""The rest of the port's query surface against rucene_tpu, on the CPU:
the rescorer (search/rescorer.py) on its device probe path
(executor.execute_probe) and its host path, explanation trees
(search/explain.py), the query-string parser (search/query_string.py)
and the highlighter (highlight/fvh.py).

One index built by rucene_tpu (stored bodies with term vectors, an
IntPoint ``price``, a StringField ``tag``) is carried across with
packed_from_reference, in one and in two segments, and served by both
packages. Explanation trees must equal the reference's node for node
(match, value, description, children), and each value must equal the
port's search score within the strict RTOL of tests/torch_hitcheck.py;
parsed queries must be the reference's query, node for node, and serve
its hits; fragments must be the reference's strings.
"""

import enum

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.search import spans as ref_spans
from rucene_tpu_torch.search import spans as port_spans
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import RTOL, assert_topdocs_strict
from tests.torch_surface_data import port_searcher, ref_searcher

WORDS = ["apple", "pie", "red", "green", "blue", "tart", "crust", "sweet", "sour", "bake",
         "oven", "warm", "cold", "fresh", "fruit", "sugar"]
K = 50


def _corpus(n=240, seed=19):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.9
    probs /= probs.sum()
    return [
        (" ".join(rng.choice(WORDS, size=int(rng.integers(3, 24)), p=probs)),
         int(rng.integers(0, 60)), f"t{int(rng.integers(0, 6))}")
        for _ in range(n)
    ]


def _pack(docs):
    buf = SegmentBuffer()
    for text, price, tag in docs:
        d = R.Document()
        d.add(R.TextField("body", text, stored=True, term_vectors=True))
        d.add(R.IntPoint("price", price))
        d.add(R.StringField("tag", tag))
        buf.add_document(d)
    return pack_segment(buf.finish())


@pytest.fixture(scope="module", params=[1, 2], ids=["one_leaf", "two_leaves"])
def pair(request):
    docs = _corpus()
    cut = np.linspace(0, len(docs), request.param + 1).astype(int)
    leaves = [(_pack(docs[a:b]), None) for a, b in zip(cut, cut[1:])]
    return ref_searcher(leaves), port_searcher(leaves)


def _t(pkg, w, field="body", boost=1.0):
    return pkg.TermQuery(pkg.Term(field, w), boost=boost)


def _spans(pkg):
    return ref_spans if pkg is R else port_spans


def queries(pkg):
    """Rows of every kind explain builds a tree for."""
    sp = _spans(pkg)
    st = lambda w: sp.SpanTermQuery(pkg.Term("body", w))  # noqa: E731
    b = pkg.BooleanQuery
    return [
        _t(pkg, "apple"),
        b().must(_t(pkg, "apple")).should(_t(pkg, "pie", boost=2.0)).must_not(_t(pkg, "cold")),
        pkg.PhraseQuery("body", ["apple", "pie"]),
        b().must(_t(pkg, "red")).filter(pkg.PointRangeQuery("price", 10, 40)),
        b().should(_t(pkg, "tart")).should(pkg.PointRangeQuery("price", 0, 5)),
        pkg.DisjunctionMaxQuery([_t(pkg, "sweet"), _t(pkg, "sour")], tie_breaker=0.3),
        pkg.ConstantScoreQuery(_t(pkg, "crust"), boost=3.0),
        pkg.BoostingQuery(_t(pkg, "fruit"), _t(pkg, "cold"), negative_boost=0.25),
        pkg.BoostQuery(_t(pkg, "oven"), 1.5),
        b().must(_t(pkg, "bake")).must_not(pkg.PhraseQuery("body", ["warm", "oven"])),
        sp.SpanNearQuery([st("apple"), st("red")], slop=3, in_order=False),
        sp.SpanOrQuery([st("green"), st("blue")]),
    ]


def canon(x):
    """A comparable form of a query or explanation tree of either
    package: class name and attributes, recursively."""
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (np.floating, float)):
        return float(x)
    if hasattr(x, "__dict__") or hasattr(x, "__dataclass_fields__"):
        attrs = vars(x) if hasattr(x, "__dict__") else {
            f: getattr(x, f) for f in x.__dataclass_fields__
        }
        return (type(x).__name__, {k: canon(v) for k, v in attrs.items() if not k.startswith("_")})
    return x


def test_explain_trees_match_reference(pair):
    ref, port = pair
    for rq, pq in zip(queries(R), queries(T)):
        hits = port.search(pq, K)
        assert_topdocs_strict(hits, ref.search(rq, K))
        docs = [d for d, _ in hits.score_docs[:4]] + [0, port.reader.max_doc - 1]
        for doc in docs:
            got, want = port.explain(pq, doc), ref.explain(rq, doc)
            assert canon(got) == canon(want), (type(pq).__name__, doc)
        for doc, score in hits.score_docs[:4]:
            ex = port.explain(pq, doc)
            assert ex.match and abs(ex.value - score) <= RTOL * max(1.0, abs(score)), (
                type(pq).__name__, doc, ex.value, score,
            )


QUERY_STRINGS = [
    "apple",
    "+apple -cold",
    "apple AND pie",
    "red OR blue",
    "apple NOT green",
    '"apple pie"',
    '"apple pie"~2',
    "body:apple^2",
    "apple^2.5 pie",
    "(red OR blue) AND pie",
    "price:[10 TO 25]",
    "apple AND price:[10 TO 25]",
    "tag:t3 AND fruit",
    "_exists_:tag",
    '+sweet "warm oven"',
    "+fresh +(sugar OR crust)",
]


def _by_hand(pkg):
    """The query strings' queries built from the classes, for the rows
    whose shape is plain."""
    b = pkg.BooleanQuery
    return {
        "apple": _t(pkg, "apple"),
        "+apple -cold": b().must(_t(pkg, "apple")).must_not(_t(pkg, "cold")),
        "apple AND pie": b().must(_t(pkg, "apple")).must(_t(pkg, "pie")),
        "red OR blue": b().should(_t(pkg, "red")).should(_t(pkg, "blue")),
        '"apple pie"': pkg.PhraseQuery("body", ["apple", "pie"]),
        "body:apple^2": _t(pkg, "apple", boost=2.0),
        "price:[10 TO 25]": pkg.PointRangeQuery("price", 10, 25),
        "tag:t3 AND fruit": b().must(_t(pkg, "t3", field="tag")).must(_t(pkg, "fruit")),
    }


def test_query_strings_parse_and_serve_as_the_reference(pair):
    ref, port = pair
    hand = _by_hand(T)
    parsed_p = [T.parse_query_string(s, "body") for s in QUERY_STRINGS]
    parsed_r = [R.parse_query_string(s, "body") for s in QUERY_STRINGS]
    for s, p, r in zip(QUERY_STRINGS, parsed_p, parsed_r):
        assert canon(p) == canon(r), s
    got = port.search_batch(parsed_p, K)
    for s, g, w in zip(QUERY_STRINGS, got, ref.search_batch(parsed_r, K)):
        assert g.total_hits > 0, s
        assert_topdocs_strict(g, w)
    by_hand = port.search_batch([hand[s] for s in hand], K)
    for s, h in zip(hand, by_hand):
        assert h == got[QUERY_STRINGS.index(s)], s


@pytest.mark.parametrize("weight", [1.0, 10.0])
def test_rescorer_matches_reference(pair, weight, monkeypatch):
    """QueryRescorer on its probe path (a flat rescore query, through the
    combine kernel's entry: its twin here) and on its host path (a phrase
    or span rescore query, counted under route.host), against the
    reference's."""
    from rucene_tpu.search.rescorer import QueryRescorer as RefRescorer
    from rucene_tpu_torch.ops import cuda_combine
    from rucene_tpu_torch.search.rescorer import QueryRescorer

    ref, port = pair
    combined = []
    real = cuda_combine.combine_lanes_plain
    monkeypatch.setattr(
        cuda_combine, "combine_lanes_plain",
        lambda *a, **kw: (combined.append(int(a[3].numel())), real(*a, **kw))[1],
    )
    firsts = [_t(R, "apple"), R.BooleanQuery().should(_t(R, "red")).should(_t(R, "pie"))]
    firsts_p = [_t(T, "apple"), T.BooleanQuery().should(_t(T, "red")).should(_t(T, "pie"))]
    second = [
        (R.BooleanQuery().should(_t(R, "pie")).should(_t(R, "crust")),
         T.BooleanQuery().should(_t(T, "pie")).should(_t(T, "crust")), True),
        (R.BooleanQuery().must(_t(R, "tart")).filter(R.PointRangeQuery("price", 0, 30)),
         T.BooleanQuery().must(_t(T, "tart")).filter(T.PointRangeQuery("price", 0, 30)), True),
        (R.PhraseQuery("body", ["apple", "pie"]), T.PhraseQuery("body", ["apple", "pie"]), False),
        (ref_spans.SpanNearQuery([ref_spans.SpanTermQuery(R.Term("body", "red")),
                                  ref_spans.SpanTermQuery(R.Term("body", "fruit"))], 4, False),
         port_spans.SpanNearQuery([port_spans.SpanTermQuery(T.Term("body", "red")),
                                   port_spans.SpanTermQuery(T.Term("body", "fruit"))], 4, False),
         False),
    ]
    for fr, fp in zip(firsts, firsts_p):
        first_r, first_p = ref.search(fr, 40), port.search(fp, 40)
        assert_topdocs_strict(first_p, first_r)
        for sr, sp_, probe in second:
            n = len(combined)
            want = RefRescorer(sr, rescore_weight=weight).rescore(ref, first_r, top_n=25)
            METRICS.reset()
            got = QueryRescorer(sp_, rescore_weight=weight).rescore(port, first_p, top_n=25)
            assert_topdocs_strict(got, want)
            assert (len(combined) > n) == probe  # the probe path runs the combine
            assert METRICS.snapshot()["counters"].get("route.host", 0) == (0 if probe else 1)
            if probe:
                assert min(combined[n:]) > 0


def test_highlighter_matches_reference(pair):
    from rucene_tpu.highlight import FastVectorHighlighter as RefFVH
    from rucene_tpu.highlight import FieldQuery as RefFieldQuery
    from rucene_tpu_torch.highlight import FastVectorHighlighter, FieldQuery

    ref, port = pair
    qs = [
        (_t(R, "apple"), _t(T, "apple")),
        (R.PhraseQuery("body", ["apple", "pie"]), T.PhraseQuery("body", ["apple", "pie"])),
        (R.BooleanQuery().should(_t(R, "red")).should(_t(R, "oven")),
         T.BooleanQuery().should(_t(T, "red")).should(_t(T, "oven"))),
    ]
    seen = 0
    for rq, pq in qs:
        for doc, _s in port.search(pq, 8).score_docs:
            for size in (20, 60):
                got = FastVectorHighlighter().get_best_fragments(
                    FieldQuery.build(pq), port.reader, doc, "body", frag_char_size=size
                )
                want = RefFVH().get_best_fragments(
                    RefFieldQuery.build(rq), ref.reader, doc, "body", frag_char_size=size
                )
                assert got == want
                seen += bool(got)
    assert seen > 10

"""Span and synonym rows on the port against rucene_tpu, on the CPU.

One corpus built by rucene_tpu (25 Zipf-weighted words) is carried across
with packed_from_reference and served by both packages:
- unordered span-near rows on the position planes
  (ops/phrase_plane.span_unordered_plane_search_many), over terms x slop x
  one or two segments, with deletes, with SpanOr children (unordered and
  ordered slop 0), under a SpanBoostQuery: bit-equal to the reference's
  device route, and the route counters equal the reference's;
- shapes the route declines (duplicate or overlapping terms, nested
  trees): the host route, equal to the reference's;
- synonym rows (a SpanOrQuery of terms, executor.execute_synonym),
  bit-equal, on one and two segments with deletes;
- nested span trees through the C++ evaluator (search/span_native.py)
  and through the Python oracle (RUCENE_SPAN_NATIVE=0): the same answers
  as the reference's under each;
- the device_equivalent step of the searcher's planning: a
  SpanTermQuery is a term row (route.device) and an ordered span-near of
  plain terms a phrase row (route.phrase);
- span group planes are keyed by the torch device and go with their
  segment.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.search import spans as ref_spans
from rucene_tpu.util.metrics import METRICS as REF_METRICS
from rucene_tpu_torch.search import phrase_path
from rucene_tpu_torch.search import spans as port_spans
from rucene_tpu_torch.util.metrics import METRICS
from tests.torch_hitcheck import assert_batches_strict
from tests.torch_surface_data import SPAN_WORDS, assert_bit_equal, both, dv_docs, leaves_for

K = 25


def build(pkg, spec):
    """A span query of either package from a nested spec: ("t", word),
    ("or", [specs]), ("near", [specs], slop, in_order), ("boost", spec, b)."""
    sp = ref_spans if pkg is R else port_spans
    kind = spec[0]
    if kind == "t":
        return sp.SpanTermQuery(pkg.Term("body", spec[1]))
    if kind == "or":
        return sp.SpanOrQuery([build(pkg, s) for s in spec[1]])
    if kind == "near":
        return sp.SpanNearQuery([build(pkg, s) for s in spec[1]], slop=spec[2], in_order=spec[3])
    return sp.SpanBoostQuery(build(pkg, spec[1]), spec[2])


def near(words, slop, ordered=False):
    return ("near", [("t", w) for w in words], slop, ordered)


def syn(words):
    return ("or", [("t", w) for w in words])


_LAYOUTS: dict = {}


def layout(n_segments=1, deletes=False):
    key = (n_segments, deletes)
    if key not in _LAYOUTS:
        rows = dv_docs(400, 33, words=SPAN_WORDS)
        _LAYOUTS[key] = both(leaves_for(rows, n_segments, deletes, seed=3))
    return _LAYOUTS[key]


ROUTES = ("device", "phrase", "mixed", "synonym", "span_unordered", "host")


def routes(metrics):
    """The row counters of the batch's routes, counted at dispatch."""
    c = metrics.snapshot()["counters"]
    return {r: c.get(f"route.{r}", 0) for r in ROUTES}


def serve(specs, n_segments=1, deletes=False, bit_equal=True):
    """Serve the rows from both packages; hold the hits (bit for bit, or
    strictly) and the route counters equal. Returns the port's routes."""
    ref, port = layout(n_segments, deletes)
    REF_METRICS.reset()
    METRICS.reset()
    want = ref.search_batch([build(R, s) for s in specs], K)
    got = port.search_batch([build(T, s) for s in specs], K)
    if bit_equal:
        for g, w in zip(got, want):
            assert_bit_equal(g, w)
    else:
        assert_batches_strict(got, want)
    assert routes(METRICS) == routes(REF_METRICS)
    return routes(METRICS)


@pytest.mark.parametrize("n_segments", [1, 2])
@pytest.mark.parametrize(
    "words,slop",
    [(["w0", "w1"], 0), (["w0", "w1"], 3), (["w1", "w4"], 8), (["w0", "w1", "w2"], 2),
     (["w0", "w2", "w5"], 6)],
)
def test_span_unordered_parity(words, slop, n_segments):
    got = serve([near(words, slop)], n_segments)
    assert got["span_unordered"] == 1 and got["host"] == 0


def test_span_unordered_with_deletes():
    got = serve([near(["w0", "w1"], 4), near(["w2", "w3", "w1"], 5)], 2, deletes=True)
    assert got["span_unordered"] == 2


@pytest.mark.parametrize("ordered,slop", [(False, 4), (True, 0)])
def test_span_or_children(ordered, slop):
    """A SpanOr child rides its group plane (the OR of its members'
    planes): unordered, and ordered slop 0 as an exact phrase."""
    spec = ("near", [syn(["w0", "w3"]), ("t", "w1")], slop, ordered)
    got = serve([spec], 2)
    assert got["span_unordered"] == 1


def test_span_boost_wrapper_rides_device():
    got = serve([("boost", near(["w0", "w1"], 3), 2.5)])
    assert got["span_unordered"] == 1


def test_ineligible_spans_take_the_host_route():
    """Duplicate terms, overlapping SpanOr members, nested near, or-of-near
    and an ordered sloppy near over an OR child: the host route, as in the
    reference."""
    specs = [
        near(["w0", "w0"], 3),
        ("near", [syn(["w0", "w1"]), ("t", "w1")], 2, False),
        ("near", [near(["w0", "w1"], 1), ("t", "w2")], 2, False),
        ("or", [near(["w0", "w2"], 1, True), near(["w3", "w1"], 2)]),
        ("near", [syn(["w0", "w2"]), ("t", "w1")], 2, True),
    ]
    got = serve(specs)
    assert got["host"] == len(specs) and got["span_unordered"] == 0


@pytest.mark.parametrize("n_segments,deletes", [(1, False), (2, True)])
def test_synonym_rows(n_segments, deletes):
    specs = [syn(["w0", "w3"]), syn(["w1", "w2", "w7"]), syn(["w4", "zzz_missing"]),
             ("boost", syn(["w5", "w6"]), 1.5)]
    got = serve(specs, n_segments, deletes)
    assert got["synonym"] == len(specs)


def test_device_equivalent_rows():
    """A SpanTermQuery plans as a term row and an ordered span-near of plain
    terms as a phrase row (the reference's _rewrite_query): the device and
    phrase routes take them, not the host."""
    specs = [("t", "w2"), ("boost", ("t", "w3"), 2.0), near(["w0", "w1"], 0, True),
             near(["w1", "w2"], 2, True)]
    got = serve(specs, 2, bit_equal=False)
    assert got["device"] == 2 and got["phrase"] == 2 and got["host"] == 0


TREES = [
    ("near", [near(["w0", "w1"], 2, True), ("t", "w2")], 5, False),
    ("near", [near(["w1", "w3"], 3), ("t", "w0")], 6, True),
    near(["w1", "w1", "w2"], 5),
    ("or", [near(["w0", "w2"], 1, True), near(["w3", "w1"], 2)]),
    ("near", [("boost", ("t", "w0"), 3.0), ("boost", ("t", "w4"), 0.5), ("t", "w0")], 4, False),
    ("near", [("or", [("t", "zzz_missing"), ("t", "w2")]), ("t", "w0")], 3, True),
]


@pytest.mark.parametrize("native", ["1", "0"])
def test_nested_span_trees(native, monkeypatch):
    """Nested trees on the host route, through the C++ evaluator and the
    Python oracle, equal to the reference under the same switch."""
    monkeypatch.setenv("RUCENE_SPAN_NATIVE", native)
    got = serve(TREES, 2)
    assert got["host"] == len(TREES)


def test_nested_trees_take_the_native_evaluator(monkeypatch):
    """With the native library built, every nested tree's host evaluation
    goes through rtpu_span_eval, not the Python loop."""
    from rucene_tpu_torch import native
    from rucene_tpu_torch.search import span_native

    assert native.available
    _ref, port = layout(2)
    calls = []
    real = span_native.eval_spans

    def spy(*a, **kw):
        res = real(*a, **kw)
        calls.append(res is not None)
        return res

    monkeypatch.setattr(span_native, "eval_spans", spy)
    port.search_batch([build(T, s) for s in TREES], K)
    assert calls and all(calls) and len(calls) >= len(TREES)


def test_group_planes_keyed_by_device():
    """A SpanOr group plane built for a leaf on one device is not served to
    a view of the same segment on another device ("cpu:0", a device name
    of its own whose tensors the CPU can build, stands in for a second
    card)."""
    _ref, port = layout(1)
    cpu_leaf = port.reader.leaves[0]
    members = ["w0", "w3"]
    gp, _go = port._group_plane_for(cpu_leaf, "body", members)
    assert port._group_plane_for(cpu_leaf, "body", members)[0] is gp
    other = T.IndexReader([cpu_leaf.source]).leaves[0]
    other.torch_device = torch.device("cpu", 0)
    other._device = cpu_leaf.device
    moved, _ = port._group_plane_for(other, "body", members)
    assert moved is not gp and torch.equal(moved, gp)
    keys = [k for (seg,), k, _v in phrase_path._PLANE_CACHE.items()
            if seg is cpu_leaf.packed and k[0] == str(cpu_leaf.torch_device)]
    assert any(k[2] == ("or", "w0", "w3") for k in keys)


def test_group_planes_released_with_their_segment(tmp_path):
    """Group planes of segments a merge takes away go once no reader holds
    them: the cache pins no merged-away segment."""
    w = T.IndexWriter(T.FSDirectory(str(tmp_path)), T.IndexWriterConfig(max_buffered_docs=150))
    for text, *_ in dv_docs(400, 33, words=SPAN_WORDS):
        d = T.Document()
        d.add(T.TextField("body", text))
        w.add_document(d)
    w.commit()
    rows = [build(T, ("near", [syn(["w0", "w3"]), ("t", "w1")], 4, False))]
    s1 = T.IndexSearcher(w.get_reader(), device="cpu")
    before = s1.search_batch(rows, K)
    old = [weakref.ref(lf.packed) for lf in s1.reader.leaves]
    assert len(old) > 1
    assert any(
        isinstance(k[2], tuple) and seg is o()
        for (seg,), k, _v in phrase_path._PLANE_CACHE.items() for o in old
    )
    w.force_merge(1)
    s2 = T.IndexSearcher(w.get_reader(), device="cpu")
    del s1
    gc.collect()
    after = s2.search_batch(rows, K)  # builds the merged segment's planes
    assert all(o() is None for o in old)
    assert all(seg is not None for (seg,), _k, _v in phrase_path._PLANE_CACHE.items())
    assert [td.total_hits for td in after] == [td.total_hits for td in before]
    w.close()


def test_unordered_pf_matches_reference():
    """_span_unordered_pf on the same planes equals the reference's bit for
    bit (one row of three distinct terms, slop 0-8), the reference under
    jit as its search runs it (XLA contracts its multiply-adds)."""
    import jax
    import jax.numpy as jnp

    from rucene_tpu.ops import phrase_plane as ref_pp
    from rucene_tpu_torch.ops import phrase_plane as port_pp

    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2**32, size=(3, 300, 4), dtype=np.uint64).astype(np.uint32)
    bits &= rng.integers(0, 2**32, size=bits.shape, dtype=np.uint64).astype(np.uint32)
    # one term a position: clear overlaps
    bits[1] &= ~bits[0]
    bits[2] &= ~(bits[0] | bits[1])
    for slop in (0, 3, 8):
        want = np.asarray(jax.jit(ref_pp._span_unordered_pf, static_argnums=(1, 2))(
            tuple(jnp.asarray(b) for b in bits), 3, slop
        ))
        got = port_pp._span_unordered_pf(
            tuple(torch.from_numpy(b.view(np.int32)) for b in bits), 3, slop
        ).numpy()
        assert np.array_equal(got, want), slop

"""ops/phrase_plane.py against rucene_tpu/ops/phrase_plane.py on the CPU.

The port's int32 planes must equal the reference's u32 planes viewed as
int32, bit for bit, with equal overflow columns, on packed segments (K1's
twin decodes) and decoded ones, at 2 and 4 words a doc. "hot" has a doc
past FMAX occurrences and "tail" one past PMAX positions, so the overflow
column is exercised. phrase_plane_search_many must give equal top-k docs,
hits and ov_count, scores within 4e-7, and the single-row
phrase_plane_search the same plus equal host-verify doc lists.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rucene_tpu.ops import phrase_plane as ref_plane
from rucene_tpu.search.searcher import work_has_ef
from rucene_tpu.search.similarity import BM25Similarity
from rucene_tpu.util import next_pow2
from rucene_tpu_torch.ops import phrase_plane
from tests.torch_hitcheck import RTOL
from tests.torch_phrase_data import packed_segment, phrase_texts, segments, term_blocks

_PACKED = {}


def _packed():
    if "p" not in _PACKED:
        _PACKED["p"] = packed_segment(phrase_texts())
    return _PACKED["p"]


def _stream(packed, term):
    pf = packed.fields["body"]
    o = pf.term_ord[term]
    return int(pf.pos_width[o]), int(pf.pos_word_start[o])


def _ref_plane(ref_dev, packed, term, words):
    blocks = term_blocks(packed, term)
    w_pad = next_pow2(len(blocks), 8)
    wb = np.zeros(w_pad, np.int32)
    wv = np.zeros(w_pad, bool)
    wb[: len(blocks)] = blocks
    wv[: len(blocks)] = True
    width, start = _stream(packed, term)
    p, o = ref_plane.build_position_plane(
        ref_dev, jnp.asarray(wb), jnp.asarray(wv), jnp.asarray(np.int32(width)),
        jnp.asarray(np.int32(start)),
        has_ef=work_has_ef(packed.blk_doc_bits, wb, wv, dev=ref_dev), words=words,
    )
    return p, o


def _port_plane(port_dev, packed, term, words, fwin=phrase_plane.FMAX):
    width, start = _stream(packed, term)
    return phrase_plane.build_position_plane(
        port_dev, torch.from_numpy(term_blocks(packed, term)), width, start,
        words=words, fwin=fwin,
    )


@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("words", [2, 4])
@pytest.mark.parametrize("term", ["hot", "tail", "the"])
def test_build_position_plane_bit_equal(term, words, decoded):
    packed = _packed()
    ref_dev, port_dev, port_packed = segments(packed, decoded)
    md = packed.max_doc
    p_ref, o_ref = _ref_plane(ref_dev, packed, term, words)
    want = np.asarray(p_ref).view(np.int32)[:md]
    blocks = term_blocks(packed, term)
    tight = min(phrase_plane.FMAX, int(port_packed.blk_max_freq[blocks].max()))
    for fwin in (phrase_plane.FMAX, tight):
        p, o = _port_plane(port_dev, packed, term, words, fwin)
        assert p.dtype == torch.int32 and p.shape == (port_dev.max_doc_padded, words)
        assert np.array_equal(p.numpy()[:md], want)
        assert np.array_equal(o.numpy()[:md], np.asarray(o_ref)[:md])
        assert not p[md:].any() and not o[md:].any()
    if term in ("hot", "tail") or words == 2:
        assert o.any()  # a doc past FMAX occurrences or past the plane


def test_shift_right_and_popcount_match_u32():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2**32, size=(500, 4), dtype=np.uint64).astype(np.uint32)
    u[:5] = 0xFFFFFFFF
    x = torch.from_numpy(u.view(np.int32))
    for j in range(32):
        want = np.asarray(ref_plane._shift_right(jnp.asarray(u), j))
        assert np.array_equal(phrase_plane._shift_right(x, j).numpy(), want.view(np.int32))
    pop = np.unpackbits(u.view(np.uint8), axis=1).sum(1)
    assert np.array_equal(phrase_plane._popcount_words(x).numpy(), pop)
    assert np.array_equal(phrase_plane._popcount_words(x[:, :2]).numpy(),
                          np.unpackbits(u[:, :2].view(np.uint8), axis=1).sum(1))


@pytest.mark.parametrize("decoded", [False, True])
def test_phrase_plane_search_many_matches(decoded):
    """Arity 2 and 3 rows over shared planes, with deletes: top-k docs,
    hits and ov_count equal, scores within RTOL."""
    packed = _packed()
    ref_dev, port_dev, _ = segments(packed, decoded)
    md = packed.max_doc
    words = 2
    terms = ["hot", "spot", "tail", "end", "quick", "brown", "fox", "the", "lazy", "dog"]
    ref_planes = {t: _ref_plane(ref_dev, packed, t, words) for t in terms}
    port_planes = {t: _port_plane(port_dev, packed, t, words) for t in terms}
    rng = np.random.default_rng(9)
    live = np.zeros(port_dev.max_doc_padded, bool)
    live[:md] = rng.random(md) > 0.2
    live[[10, 20, 30, 40]] = True
    norms = np.zeros(port_dev.max_doc_padded, np.int64)
    norms[:md] = packed.norms["body"]
    sim = BM25Similarity()
    cache_row = sim.cache_row(None) + np.float32(0.5) * rng.random(256).astype(np.float32)
    denom = cache_row[norms].astype(np.float32)
    rows = {2: [["hot", "spot"], ["tail", "end"], ["quick", "brown"], ["brown", "fox"],
                ["the", "tail"], ["lazy", "dog"], ["the", "the"]],
            3: [["hot", "spot", "tail"], ["quick", "brown", "fox"], ["the", "lazy", "dog"]]}
    k = 50
    totals = np.zeros(2, np.int64)
    for nt, rr in rows.items():
        weights = (1.0 + rng.random(len(rr))).astype(np.float32)
        flat = [t for r in rr for t in r]
        want = ref_plane.phrase_plane_search_many(
            tuple(ref_planes[t][0] for t in flat), tuple(ref_planes[t][1] for t in flat),
            jnp.asarray(live[: ref_dev.max_doc_padded]),
            tuple(jnp.asarray(denom[: ref_dev.max_doc_padded]) for _ in rr),
            jnp.asarray(weights), k=k, n_terms=nt,
        )
        got = phrase_plane.phrase_plane_search_many(
            tuple(port_planes[t][0] for t in flat), tuple(port_planes[t][1] for t in flat),
            torch.from_numpy(live), tuple(torch.from_numpy(denom) for _ in rr),
            torch.from_numpy(weights), k=k, n_terms=nt,
        )
        ws, wd, wh, wo = (np.asarray(a) for a in want)
        gs, gd, gh, go = (a.numpy() for a in got)
        assert np.array_equal(gd, wd) and np.array_equal(gh, wh) and np.array_equal(go, wo)
        fin = np.isfinite(ws)
        assert np.array_equal(np.isfinite(gs), fin)
        assert np.all(np.abs(gs[fin] - ws[fin]) <= RTOL * np.maximum(1.0, np.abs(ws[fin])))
        totals += (wh.sum(), wo.sum())
    assert (totals > 0).all()  # some hits, and some rows the scalar engine must redo


@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("row,ov_cap", [
    (["quick", "brown"], 1024), (["quick", "brown", "fox"], 1024), (["hot", "spot"], 1024),
    (["hot", "spot"], 1), (["the", "tail"], 1024),
])
def test_phrase_plane_search_single_row_matches(decoded, row, ov_cap):
    """The single-row phrase_plane_search against rucene_tpu/ops/phrase_plane.py:323:
    top-k docs, hits, the host-verify docs and their count equal, scores
    within RTOL; "hot" rows meet overflowed docs, one with a cap below
    their count."""
    packed = _packed()
    ref_dev, port_dev, _ = segments(packed, decoded)
    md = packed.max_doc
    words = 2
    rng = np.random.default_rng(5)
    live = np.zeros(port_dev.max_doc_padded, bool)
    live[:md] = rng.random(md) > 0.1
    norms = np.zeros(port_dev.max_doc_padded, np.int64)
    norms[:md] = packed.norms["body"]
    denom = BM25Similarity().cache_row(None)[norms].astype(np.float32)
    weight = np.float32(1.75)
    ref_p = [_ref_plane(ref_dev, packed, t, words) for t in row]
    port_p = [_port_plane(port_dev, packed, t, words) for t in row]
    want = ref_plane.phrase_plane_search(
        tuple(p for p, _ in ref_p), tuple(o for _, o in ref_p),
        jnp.asarray(live[: ref_dev.max_doc_padded]), jnp.asarray(denom[: ref_dev.max_doc_padded]),
        jnp.asarray(weight), k=20, n_terms=len(row), ov_cap=ov_cap,
    )
    got = phrase_plane.phrase_plane_search(
        tuple(p for p, _ in port_p), tuple(o for _, o in port_p), torch.from_numpy(live),
        torch.from_numpy(denom), weight, k=20, n_terms=len(row), ov_cap=ov_cap,
    )
    ws, wd, wh, wov, woc = (np.asarray(a) for a in want)
    gs, gd, gh, gov, goc = (a.numpy() for a in got)
    assert gs.shape == (20,) and gd.dtype == np.int32
    assert np.array_equal(gd, wd) and int(gh) == int(wh) and int(goc) == int(woc)
    n_ov = min(len(wov), int(woc))
    assert np.array_equal(gov[:n_ov], wov[:n_ov]) and (gov[n_ov:] == 2**31 - 1).all()
    fin = np.isfinite(ws)
    assert np.array_equal(np.isfinite(gs), fin)
    assert np.all(np.abs(gs[fin] - ws[fin]) <= RTOL * np.maximum(1.0, np.abs(ws[fin])))
    if row[0] == "hot":
        assert int(goc) > 0

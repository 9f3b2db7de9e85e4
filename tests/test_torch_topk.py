"""The port's exact top-k (rucene_tpu_torch/ops/topk.py) against
rucene_tpu.ops.topk: topk_score_doc, stable_top_k and extent_top_k_lanes
give equal scores and docs (indices), slot for slot, on rows with heavy
ties (the cases tests/test_ops_topk.py pins) and on tie-heavy lane grids.
exact_top_k's block-max chunk pass is held bit-equal to stable_top_k and
to the reference's exact_top_k on rows wide enough to engage it (65,536
columns, and 70,001 so the tail pseudo-chunk is used) at k = 1, 10, 100,
129 (128-doc chunks) and 1,000, and both packages take the same branch at
the reference's engagement rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rucene_tpu.ops import topk as ref
from rucene_tpu.ops.topk import topk_score_doc as ref_topk
from rucene_tpu_torch.ops import topk as port
from rucene_tpu_torch.ops.topk import (
    chunk_pass_engages,
    exact_top_k,
    extent_top_k_lanes,
    score_doc_keys,
    stable_top_k,
    topk_score_doc,
)

_NAMES = ["random_holes", "all_ties", "tie_clusters", "few_matches", "no_matches",
          "quantized", "zeros_and_negatives"]


def _rows(name):
    rng = np.random.default_rng(11)
    n = 4096
    if name == "random_holes":
        s = rng.random((4, n)).astype(np.float32)
        s[s < 0.5] = -np.inf
    elif name == "all_ties":
        s = np.full((2, n), 1.5, np.float32)
    elif name == "tie_clusters":
        s = np.full((3, n), -np.inf, np.float32)
        s[0, :200] = 3.0  # 200 ties straddling k: smallest docs win
        s[1, ::7] = 1.25
        s[1, 100:110] = 9.0
        s[2, :] = 2.5
    elif name == "few_matches":
        s = np.full((2, n), -np.inf, np.float32)
        s[0, [5, 99, 4000]] = [1.0, 2.0, 3.0]
    elif name == "no_matches":
        s = np.full((3, n), -np.inf, np.float32)
    elif name == "quantized":  # BM25-like: few distinct values, many ties
        s = (rng.integers(1, 6, (4, n)) * np.float32(0.37)).astype(np.float32)
        s[rng.random((4, n)) < 0.3] = -np.inf
    elif name == "zeros_and_negatives":
        s = rng.choice(np.asarray([-2.0, -0.0, 0.0, 0.5, -np.inf], np.float32), (3, n))
    return s


@pytest.mark.parametrize("name", _NAMES)
@pytest.mark.parametrize("k", [1, 16, 100])
def test_topk_matches_reference(name, k):
    s = _rows(name)
    want_s, want_d = (np.asarray(x) for x in ref_topk(jnp.asarray(s), k))
    got_s, got_d = topk_score_doc(torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_topk_k_exceeds_n():
    s = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    want_s, want_d = (np.asarray(x) for x in ref_topk(jnp.asarray(s), 8))
    got_s, got_d = topk_score_doc(torch.from_numpy(s), 8)
    assert got_s.shape == (1, 8)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_keys_order_score_desc_doc_asc():
    rng = np.random.default_rng(3)
    scores = rng.choice(np.asarray([-1.5, -0.0, 0.0, 0.25, 7.0, np.inf, -np.inf], np.float32), 500)
    docs = rng.permutation(500)
    keys = score_doc_keys(torch.from_numpy(scores), torch.from_numpy(docs))
    got = torch.argsort(keys, descending=True).numpy()
    want = np.lexsort((docs, -scores.astype(np.float64)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", _NAMES)
@pytest.mark.parametrize("k", [1, 100, 5000])
def test_stable_top_k_matches_reference(name, k):
    s = _rows(name)
    want_v, want_i = (np.asarray(x) for x in ref.stable_top_k(jnp.asarray(s), k))
    got_v, got_i = stable_top_k(torch.from_numpy(s), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)


def _lane_grid(seed, b, max_items, distinct):
    """Single-term-style lanes: row r owns a contiguous extent of items
    (some empty), docs ascend along the extent, scores take ``distinct``
    values (ties everywhere), some lanes are unmatched (-inf, 2^31-1)."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, max_items + 1, b)
    items[0] = max_items
    start = np.concatenate([[0], np.cumsum(items)[:-1]])
    w = max(int(items.sum()), 1)
    score = (rng.integers(1, distinct + 1, (w, 128)) * np.float32(0.75)).astype(np.float32)
    docm = np.zeros((w, 128), np.int32)
    for r in range(b):
        n = int(items[r]) * 128
        docs = np.sort(rng.choice(50_000, n, replace=False)).astype(np.int32)
        docm[start[r]:start[r] + items[r]] = docs.reshape(-1, 128)
    off = rng.random((w, 128)) < 0.2
    score[off] = -np.inf
    docm[off] = 2**31 - 1
    return score, docm, start.astype(np.int32), items.astype(np.int32)


@pytest.mark.parametrize("seed,b,max_items,distinct", [(1, 6, 9, 3), (2, 4, 40, 1), (3, 8, 5, 7)])
@pytest.mark.parametrize("k", [1, 10, 100, 2000])
def test_extent_top_k_lanes_matches_reference(seed, b, max_items, distinct, k):
    score, docm, start, items = _lane_grid(seed, b, max_items, distinct)
    want_s, want_d = (np.asarray(x) for x in ref.extent_top_k_lanes(
        jnp.asarray(score), jnp.asarray(docm), jnp.asarray(start), jnp.asarray(items),
        max_items, k,
    ))
    got_s, got_d = extent_top_k_lanes(
        torch.from_numpy(score), torch.from_numpy(docm), torch.from_numpy(start),
        torch.from_numpy(items), max_items, k,
    )
    assert got_s.shape == (b, k) and got_d.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_extent_top_k_lanes_empty_grid():
    got_s, got_d = extent_top_k_lanes(
        torch.zeros((0, 128)), torch.zeros((0, 128), dtype=torch.int32),
        torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32), 1, 5,
    )
    assert torch.isneginf(got_s).all() and (got_d == 2**31 - 1).all()


# --- exact_top_k: the block-max chunk pass ---------------------------------------

_WIDE = ["all_ties", "tie_clusters", "holes", "few_matches"]
# one XLA program a shape, not one a jnp op
_REF_EXACT = jax.jit(ref.exact_top_k, static_argnums=1)
_REF_TOPK = jax.jit(ref_topk, static_argnums=1)


def _wide_rows(name, n):
    """Three rows of n columns: ties everywhere, tie clusters across 128-
    and 256-column chunk boundaries, -inf holes, fewer matches than k."""
    rng = np.random.default_rng(n + len(name))
    if name == "all_ties":
        s = np.full((3, n), 1.5, np.float32)
        s[1, ::3] = -np.inf
        s[2, n - 7:] = 2.0  # the best hits in the tail pseudo-chunk
    elif name == "tie_clusters":
        s = np.full((3, n), -np.inf, np.float32)
        s[0, 250:262] = 3.0  # across a 256 boundary
        s[0, 511:513] = 3.0
        s[0, 1000:4000:7] = 2.0
        s[1, 120:140] = 5.0  # across a 128 boundary
        s[1, 380:390] = 5.0
        s[1, ::11] = 1.0
        s[2] = (rng.integers(1, 5, n) * np.float32(0.37)).astype(np.float32)
        s[2, rng.random(n) < 0.3] = -np.inf
    elif name == "holes":
        s = rng.random((3, n)).astype(np.float32)
        s[s < 0.5] = -np.inf
        s[1] = np.round(s[1], 2)
    else:
        s = np.full((3, n), -np.inf, np.float32)
        s[0, [3, 999, n - 1]] = [1.0, 2.0, 2.0]
        s[1, rng.choice(n, 40, replace=False)] = 0.5
    return s


@pytest.mark.parametrize("name", _WIDE)
@pytest.mark.parametrize("n", [65_536, 70_001])
@pytest.mark.parametrize("k", [1, 10, 100, 129, 1000])
def test_exact_top_k_bit_equal(name, n, k):
    s = _wide_rows(name, n)
    t = torch.from_numpy(s)
    got_v, got_i = exact_top_k(t, k)
    want_v, want_i = stable_top_k(t, k)
    assert got_i.dtype == torch.int32
    assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)
    ref_v, ref_i = (np.asarray(x) for x in _REF_EXACT(jnp.asarray(s), k))
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    ts, td = topk_score_doc(t, k)
    rs, rd = (np.asarray(x) for x in _REF_TOPK(jnp.asarray(s), k))
    np.testing.assert_array_equal(td.numpy(), rd)
    np.testing.assert_array_equal(ts.numpy(), rs)


def _full_width_calls(mod, monkeypatch, fn, scores, k):
    """Whether fn(scores, k) ran ``mod``'s stable_top_k over the whole row
    (the fallback) rather than over the chunk pass's candidates."""
    widths = []
    orig = mod.stable_top_k

    def spy(x, kk):
        widths.append(x.shape[1])
        return orig(x, kk)

    monkeypatch.setattr(mod, "stable_top_k", spy)
    fn(scores, k)
    monkeypatch.setattr(mod, "stable_top_k", orig)
    return scores.shape[1] in widths


@pytest.mark.parametrize("n,k,engaged", [
    (32_767, 1, False),  # n < _FAST_MIN_N
    (32_768, 1, True),
    (32_768, 63, True),
    (32_768, 64, False),  # kk * chunk * 2 >= n
    (33_000, 129, False),  # 128-doc chunks: 129 * 128 * 2 >= n
    (33_025, 129, True),
    (65_536, 128, False),  # 128 * 256 * 2 >= n
    (65_537, 127, True),
    (300, 5, False),
])
def test_chunk_pass_engagement_rules(monkeypatch, n, k, engaged):
    """The port takes the chunk pass exactly where the reference does (its
    three rules; the reference's RUCENE_FAST_TOPK is left unset)."""
    s = _wide_rows("holes", n)[:1]
    monkeypatch.delenv("RUCENE_FAST_TOPK", raising=False)
    assert chunk_pass_engages(n, k) == engaged
    assert _full_width_calls(port, monkeypatch, exact_top_k, torch.from_numpy(s), k) != engaged
    ref_trace = jax.make_jaxpr(lambda x: ref.exact_top_k(x, k))  # traced, never run
    ref_calls = _full_width_calls(ref, monkeypatch, lambda x, _: ref_trace(x), jnp.asarray(s), k)
    assert ref_calls != engaged
    got = exact_top_k(torch.from_numpy(s), k)
    want = stable_top_k(torch.from_numpy(s), k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_topk_score_doc_takes_the_chunk_pass(monkeypatch):
    """topk_score_doc reaches exact_top_k (the reference's :218)."""
    calls = []
    orig = port.exact_top_k
    monkeypatch.setattr(port, "exact_top_k", lambda s, k: calls.append(k) or orig(s, k))
    s = torch.from_numpy(_wide_rows("tie_clusters", 65_536))
    topk_score_doc(s, 10)
    assert calls == [10]

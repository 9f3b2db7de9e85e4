"""The port's exact top-k (rucene_tpu_torch/ops/topk.py) against
rucene_tpu.ops.topk: topk_score_doc, stable_top_k and extent_top_k_lanes
give equal scores and docs (indices), slot for slot, on rows with heavy
ties (the cases tests/test_ops_topk.py pins) and on tie-heavy lane grids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rucene_tpu.ops import topk as ref
from rucene_tpu.ops.topk import topk_score_doc as ref_topk
from rucene_tpu_torch.ops.topk import (
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

"""index/derived.DerivedCache: entries held by weak reference to their
anchors, the count and byte bounds, and the device in a plane's key."""

import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rucene_tpu_torch.index.derived import DerivedCache
from rucene_tpu_torch.search.phrase_path import _plane_at


class _Obj:
    pass


ANCHORS = {
    "object": _Obj,
    "ndarray": lambda: np.zeros(4),
    "tensor": lambda: torch.zeros(4),
}


def _keys(cache) -> list:
    return [key for _a, key, _v in cache.items()]


@pytest.mark.parametrize("kind", list(ANCHORS))
def test_recycled_id_never_hits(kind):
    """An anchor freed and replaced by a new object at the same id() gets
    no hit, and the dead entry leaves when the new one goes in."""
    make = ANCHORS[kind]
    cache = DerivedCache(8)
    a = make()
    old = id(a)
    cache.put((a,), "k", "old")
    del a
    gc.collect()
    held = []
    for _ in range(10_000):
        b = make()
        if id(b) == old:
            break
        held.append(b)
    else:
        pytest.skip("no object came back at the freed id()")
    assert cache.get((b,), "k") is None and cache.peek((b,), "k", "miss") == "miss"
    cache.put((b,), "k", "new")
    assert cache.get((b,), "k") == "new" and len(cache) == 1


@pytest.mark.parametrize("dies", [0, 1])
def test_entry_dies_with_either_anchor(dies):
    cache = DerivedCache(8)
    pair = [_Obj(), _Obj()]
    other = _Obj()
    cache.put(tuple(pair), "k", 1)
    cache.put((other,), "k", 2)
    assert cache.get(tuple(pair), "k") == 1
    del pair[dies]
    gc.collect()
    assert [sum(a is None for a in anchors) for anchors, _k, _v in cache.items()] == [0, 1]
    cache.put((other,), "k2", 3)
    assert _keys(cache) == ["k", "k2"] and cache.get((other,), "k") == 2


@pytest.mark.parametrize("step", ["put", "make_room"])
def test_dead_entries_leave_at_next_insert(step):
    """A dead anchor's entries stay until the next put or make_room, and
    take their bytes with them."""
    cache = DerivedCache()
    a, b = _Obj(), _Obj()
    for n in range(3):
        cache.put((a,), n, n, nbytes=10)
    cache.put((b,), "b", "b", nbytes=5)
    del a
    gc.collect()
    assert len(cache) == 4 and cache.nbytes == 35
    if step == "put":
        cache.put((b,), "c", "c", nbytes=5)
    else:
        cache.make_room(1000, 0)
    assert all(anchors == (b,) for anchors, _k, _v in cache.items())
    assert cache.nbytes == 5 * len(cache)


@pytest.mark.parametrize(("read", "evicted"), [("get", "b"), ("peek", "a")])
def test_count_bound_evicts_least_recently_used(read, evicted):
    """get moves an entry to the end of the eviction order; peek leaves it
    where it was."""
    cache = DerivedCache(3)
    seg = _Obj()
    for key in "abc":
        cache.put((seg,), key, key.upper())
    assert getattr(cache, read)((seg,), "a") == "A"
    assert cache.peek((seg,), "b") == "B"
    cache.put((seg,), "d", "D")
    assert len(cache) == 3 and evicted not in _keys(cache)
    assert sorted(_keys(cache) + [evicted]) == list("abcd")


@pytest.mark.parametrize(
    ("sizes", "budget", "kept"),
    [
        ([10, 10, 10], 30, [0, 1, 2]),  # fits
        ([10, 10, 10, 10], 30, [1, 2, 3]),  # the oldest goes first
        ([10, 20, 15], 30, [2]),  # as many as it takes
        ([50], 30, [0]),  # the last entry stays, whatever its size
        ([10, 10, 10, 10], None, [0, 1, 2, 3]),  # no budget: no eviction
    ],
)
def test_byte_budget(sizes, budget, kept):
    cache = DerivedCache()
    seg = _Obj()
    for n, size in enumerate(sizes):
        cache.put((seg,), n, n, nbytes=size, budget=budget)
    assert _keys(cache) == kept
    assert cache.nbytes == sum(sizes[n] for n in kept)


@pytest.mark.parametrize(
    ("extra", "kept"), [(0, [0, 1, 2]), (10, [1, 2]), (25, [2]), (100, [2])]
)
def test_make_room_leaves_room_for_extra(extra, kept):
    """make_room(budget, extra) evicts the oldest until the rest and extra
    fit the budget, keeping the last entry."""
    cache = DerivedCache()
    seg = _Obj()
    for n in range(3):
        cache.put((seg,), n, n, nbytes=10)
    cache.make_room(30, extra)
    assert _keys(cache) == kept and cache.nbytes == 10 * len(kept)
    if len(kept) > 1:
        assert cache.nbytes <= 30 - extra


@pytest.mark.parametrize("devices", [("cpu", "cpu:0"), ("cpu", "meta")])
def test_same_key_on_two_devices_gives_two_entries(devices):
    """A plane key names the leaf's torch device: two views of one segment
    on two devices hold two entries."""
    cache = DerivedCache()
    seg = _Obj()
    leaves = [SimpleNamespace(packed=seg, torch_device=torch.device(d)) for d in devices]
    for n, leaf in enumerate(leaves):
        assert cache.get(*_plane_at(leaf, ("body", "w0"))) is None
        cache.put(*_plane_at(leaf, ("body", "w0")), n, nbytes=1, budget=10)
    assert len(cache) == 2
    assert [cache.get(*_plane_at(leaf, ("body", "w0"))) for leaf in leaves] == [0, 1]


def test_clear():
    cache = DerivedCache()
    seg = _Obj()
    cache.put((seg,), "k", 1, nbytes=7)
    cache.clear()
    assert len(cache) == 0 and cache.nbytes == 0 and cache.get((seg,), "k") is None
    cache.put((seg,), "k", 2, nbytes=3)
    assert cache.get((seg,), "k") == 2 and cache.nbytes == 3

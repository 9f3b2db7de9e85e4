"""State derived from segments, and when it dies (DerivedCache).

An entry is built from its anchors (a packed segment, a live mask, a device
form's tensor) and a key that names the rest of what it depends on. The
cache holds anchors by weak reference only, and a hit requires each to be
alive and the very object the entry was built from, so an object freed and
replaced at the same id() never hits; a None anchor matches only None.
Entries of dead anchors leave at the next put or make_room, one check an
anchor object. No weakref.finalize callbacks: they would run on whichever
thread drops the last reference, the NRT ingest thread among them. Calls
are not locked: a searcher serves from one thread.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict


class DerivedCache:
    """``entries``: at most this many, the least recently used out first.
    None: bounded by bytes, each put naming its entry's bytes and the
    budget to fit (None: evict nothing); the last entry always stays."""

    def __init__(self, entries: int | None = None):
        self._cap = entries
        # (anchor ids, key) -> [value, weak refs (None for a None anchor), bytes]
        self._entries: OrderedDict = OrderedDict()
        self._refs: dict = {}  # anchor id -> weak ref, one an anchor object
        self.nbytes = 0

    def _find(self, anchors, key):
        ek = (tuple(map(id, anchors)), key)
        ent = self._entries.get(ek)
        if ent is None or any(r is not None and r() is not a for r, a in zip(ent[1], anchors)):
            return ek, None
        return ek, ent

    def get(self, anchors, key=(), default=None):
        """The value built from ``anchors`` under ``key``, now the most
        recently used; ``default`` on a miss."""
        ek, ent = self._find(anchors, key)
        if ent is None:
            return default
        self._entries.move_to_end(ek)
        return ent[0]

    def peek(self, anchors, key=(), default=None):
        """As get, leaving the eviction order alone."""
        ent = self._find(anchors, key)[1]
        return default if ent is None else ent[0]

    def put(self, anchors, key, value, nbytes: int = 0, budget: int | None = None):
        """Store and return ``value``, built from ``anchors`` under ``key``,
        after dropping the entries of dead anchors; then evict the oldest
        past the count bound or the byte ``budget``."""
        self._drop_dead()
        ek = (tuple(map(id, anchors)), key)
        if ek in self._entries:
            self._remove(ek)
        refs = tuple(None if a is None else weakref.ref(a) for a in anchors)
        for aid, ref in zip(ek[0], refs):
            if ref is not None:
                self._refs[aid] = ref
        self._entries[ek] = [value, refs, nbytes]
        self.nbytes += nbytes
        if self._cap is not None:
            while len(self._entries) > self._cap:
                self._remove(next(iter(self._entries)))
        elif budget is not None:
            self._evict_to(budget)
        return value

    def make_room(self, budget: int, extra: int) -> None:
        """Before building ``extra`` bytes: drop the entries of dead anchors,
        then evict the oldest until the rest and ``extra`` fit ``budget``."""
        self._drop_dead()
        self._evict_to(budget - extra)

    def items(self):
        """(anchors, key, value) of each entry, oldest first; a dead anchor
        reads None."""
        for (_ids, key), (value, refs, _n) in list(self._entries.items()):
            yield tuple(None if r is None else r() for r in refs), key, value

    def clear(self) -> None:
        self._entries.clear()
        self._refs.clear()
        self.nbytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _evict_to(self, limit: int) -> None:
        while len(self._entries) > 1 and self.nbytes > limit:
            self._remove(next(iter(self._entries)))

    def _remove(self, ek) -> None:
        self.nbytes -= self._entries.pop(ek)[2]

    def _drop_dead(self) -> None:
        dead = {aid for aid, ref in self._refs.items() if ref() is None}
        if dead:
            for aid in dead:
                del self._refs[aid]
            for ek in [ek for ek in self._entries if not dead.isdisjoint(ek[0])]:
                self._remove(ek)

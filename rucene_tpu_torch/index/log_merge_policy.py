"""LogDocMergePolicy: Lucene 6.2.1's LogMergePolicy over doc counts
(org.apache.lucene.index.LogDocMergePolicy, LogMergePolicy.findMerges and
findForcedMerges), at Lucene's defaults.

It merges runs of adjacent segments only, so a merged segment holds its
inputs' docs in their order and an index's doc ids keep the order its docs
were added in. The TieredMergePolicy of index/merge.py merges the smallest
segments wherever they lie, which reorders the docs of an append-only
stream; under BM25 with byte norms equal scores are common, and they are
ordered by doc id, so a reordered index can answer a row with other docs.

Levels, as Lucene computes them (in float32): a segment's level is
log(docs) / log(merge_factor), and the level floor is
log(min_merge_docs) / log(merge_factor). Walking the segments in index
order, the highest level among those left sets a range: from there to the
last segment at or above ``LEVEL_LOG_SPAN`` below it (at or above the
floor, where that is higher; every segment left, where the highest is at
or under the floor). In the range each run of ``merge_factor`` adjacent
segments is a merge; the walk goes on after the range. Lucene's
``maxMergeDocs`` is left out: its default (Integer.MAX_VALUE) caps
nothing.

The policy sees every segment of the index in order (``adjacent_only``:
IndexWriter.maybe_merge hands it the merging segments too); a run that
holds a segment already merging is a candidate the writer refuses, as
Lucene skips it.
"""

from __future__ import annotations

import math

import numpy as np

from rucene_tpu_torch.index.merge import MergeCandidate

LEVEL_LOG_SPAN = 0.75


class LogDocMergePolicy:
    """Lucene 6.2.1's LogDocMergePolicy: merge factor 10, min merge docs
    1,000."""

    adjacent_only = True

    def __init__(self, merge_factor: int = 10, min_merge_docs: int = 1000):
        self.merge_factor = merge_factor
        self.min_merge_docs = min_merge_docs

    def _levels(self, sizes: list[int]) -> tuple[list[np.float32], np.float32]:
        norm = np.float32(math.log(self.merge_factor))
        levels = [np.float32(np.float32(math.log(max(s, 1))) / norm) for s in sizes]
        floor = (np.float32(math.log(self.min_merge_docs) / float(norm))
                 if self.min_merge_docs > 0 else np.float32(0.0))
        return levels, floor

    def find_merges(
        self,
        sizes: dict[str, int],
        deletes: dict[str, int] | None = None,
        byte_sizes: dict[str, int] | None = None,
    ) -> list[MergeCandidate]:
        """sizes: {segment name: live docs}, in index order."""
        names = list(sizes)
        levels, floor = self._levels([sizes[n] for n in names])
        out: list[MergeCandidate] = []
        start, n = 0, len(names)
        while start < n:
            top = max(levels[start:])
            if top <= floor:
                bottom = np.float32(-1.0)
            else:
                bottom = np.float32(float(top) - LEVEL_LOG_SPAN)
                if bottom < floor:
                    bottom = floor
            upto = n - 1
            while upto >= start and levels[upto] < bottom:
                upto -= 1
            end = start + self.merge_factor
            while end <= upto + 1:
                out.append(MergeCandidate(names[start:end]))
                start, end = end, end + self.merge_factor
            start = upto + 1
        return out

    def find_forced_merges(self, sizes: dict[str, int], max_segments: int) -> list[MergeCandidate]:
        """Lucene's findForcedMergesMaxNumSegments: runs of merge_factor
        from the end while enough segments are left; else one last merge,
        of every segment for max_segments 1, or the cheapest adjacent run
        that leaves max_segments and is under twice its left neighbour."""
        names = list(sizes)
        last = len(names)
        if last <= max_segments:
            return []
        out: list[MergeCandidate] = []
        while last - max_segments + 1 >= self.merge_factor:
            out.append(MergeCandidate(names[last - self.merge_factor:last]))
            last -= self.merge_factor
        if out:
            return out
        if max_segments == 1:
            return [MergeCandidate(names[:last])] if last > 1 else []
        width = last - max_segments + 1
        best_start, best = 0, 0
        for i in range(last - width + 1):
            total = sum(sizes[s] for s in names[i:i + width])
            if i == 0 or (total < 2 * sizes[names[i - 1]] and total < best):
                best_start, best = i, total
        return [MergeCandidate(names[best_start:best_start + width])]

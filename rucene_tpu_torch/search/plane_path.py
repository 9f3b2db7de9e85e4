"""Host-side routing/tables for the dense tf-plane executor
(executor.execute_planes). A copy of rucene_tpu/search/plane_path.py.

The reference serves high-df boolean clauses through the same skip-list
leapfrog as everything else (rucene src/core/search/scorer/
conjunction_scorer.rs, disjunction_scorer.rs:24); once a clause's df
passes ~md/512 its postings are effectively a dense column, so the plane
route keeps a resident u8 tf plane per hot term
(codec/device.add_tf_planes) and evaluates [B, md] elementwise math: no
probe compares, no scatter, and two dict lookups per clause of host table
work instead of per-block work lists.

Eligibility is exact-semantics-preserving: plain boolean rows (any mix of
SHOULD / MUST / FILTER / MUST_NOT term clauses, honoring
min_should_match) whose every term PRESENT in a segment has a plane
there. A term absent from a segment rides as an inert slot (-1), which
matches the lane executor's behavior (required-absent => row matches
nothing in that segment).

Port changes:
- plane_row_chunk: rows per call bound the executor's measured peak, not
  its f32 accumulator alone. Eager torch keeps several [B, md]
  temporaries alive per clause step (the u8 gather and its f32 cast, the
  product, the count update) and the top-k's int64 keys after them. No
  env override (RUCENE_PLANE_ROWS_MB) and no pow2 rounding (the
  reference's keeps compiled shapes reusable).
- PLANE_PEAK_BYTES_PER_ROW_DOC: execute_planes' peak device memory per
  (row, doc), measured on an H100 (PERF.md).
- PLANE_CHUNK_BYTES: the peak one execute_planes call may reach.
"""

from __future__ import annotations

PLANE_T_CAP = 8  # max clauses per row (ENC_NOT nibble caps MUST_NOT at 15)


def plane_structural(rq) -> bool:
    """Row-shape eligibility (segment-independent)."""
    return (
        rq.plain
        and not rq.match_all
        and not rq.ranges
        and not rq.phrases
        and not rq.groups
        and 1 <= len(rq.clauses) <= PLANE_T_CAP
    )


PLANE_PEAK_BYTES_PER_ROW_DOC = 30  # execute_planes' peak on an H100: 29.1 (PERF.md)
PLANE_CHUNK_BYTES = 4 << 30  # peak allowed to one execute_planes call


def plane_row_chunk(b_pad: int, mdp: int) -> int:
    """Rows per execute_planes call: its peak, PLANE_PEAK_BYTES_PER_ROW_DOC
    a (row, doc), stays under PLANE_CHUNK_BYTES (143 rows at 1M docs, 16
    at 8.8M)."""
    rows = PLANE_CHUNK_BYTES // (PLANE_PEAK_BYTES_PER_ROW_DOC * max(mdp, 1))
    return max(1, min(b_pad, rows))

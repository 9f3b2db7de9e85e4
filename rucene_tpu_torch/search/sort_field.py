"""Sort-by-field machinery.

reference: rucene src/core/search/sort_field/sort_field.rs:62 (SortField,
SortFieldType), field_comparator.rs (RelevanceComparator :234,
NumericDocValuesComparator :367), collapse_top_docs.rs (TopDocs containers).

Sorted search runs on the host match path: the boolean matcher produces the
match set, then keys come from numeric doc values (missing values sort as
0, like Lucene's default missing value). Ties always break by global doc id
ascending.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field

import numpy as np


class SortFieldType(enum.Enum):
    SCORE = "score"
    DOC = "doc"
    LONG = "long"
    INT = "int"
    DOUBLE = "double"
    FLOAT = "float"


@dataclass(frozen=True)
class SortField:
    field: str | None = None
    type: SortFieldType = SortFieldType.SCORE
    reverse: bool = False  # for SCORE: reverse=False means best first

    @staticmethod
    def score() -> "SortField":
        return SortField(None, SortFieldType.SCORE)

    @staticmethod
    def doc() -> "SortField":
        return SortField(None, SortFieldType.DOC)


@dataclass
class Sort:
    fields: list[SortField] = dc_field(default_factory=lambda: [SortField.score()])

    @staticmethod
    def by(field: str, type: SortFieldType = SortFieldType.LONG, reverse: bool = False) -> "Sort":
        return Sort([SortField(field, type, reverse)])


@dataclass
class FieldDoc:
    doc: int
    score: float
    fields: list  # sort key values in Sort order


@dataclass
class TopFieldDocs:
    total_hits: int
    field_docs: list[FieldDoc]
    sort: Sort


def sort_keys_for_leaf(leaf, sort: Sort, docs: np.ndarray, scores: np.ndarray) -> list[np.ndarray]:
    """Materialize each SortField's key values for segment-local docs."""
    keys: list[np.ndarray] = []
    for sf in sort.fields:
        if sf.type == SortFieldType.SCORE:
            keys.append(scores.astype(np.float64))
        elif sf.type == SortFieldType.DOC:
            keys.append(docs.astype(np.int64))
        else:
            dv = leaf.numeric_doc_values(sf.field)
            if dv is None:
                vals = np.zeros(len(docs), dtype=np.int64)
            else:
                vals = dv[0][docs]
                vals = np.where(dv[1][docs], vals, 0)  # missing -> 0
            if sf.type in (SortFieldType.DOUBLE, SortFieldType.FLOAT):
                keys.append(vals.view(np.float64) if vals.dtype == np.float64 else vals.astype(np.float64))
            else:
                keys.append(vals.astype(np.int64))
    return keys

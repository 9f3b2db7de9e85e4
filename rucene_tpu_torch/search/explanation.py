"""Score explanation trees (reference: rucene src/core/search/explanation.rs
and Weight::explain at term_query.rs:183-215, bm25_similarity.rs idf_explain
/ explain_tf_norm)."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field


@dataclass
class Explanation:
    match: bool
    value: float
    description: str
    details: list["Explanation"] = dc_field(default_factory=list)

    def __str__(self) -> str:
        return self._render(0)

    def _render(self, depth: int) -> str:
        out = "  " * depth + f"{self.value} = {self.description}\n"
        for d in self.details:
            out += d._render(depth + 1)
        return out


def no_match(description: str) -> Explanation:
    return Explanation(False, 0.0, description)

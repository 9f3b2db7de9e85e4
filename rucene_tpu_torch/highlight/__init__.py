"""Highlighting (reference: rucene src/core/highlight/)."""

from rucene_tpu_torch.highlight.fvh import FastVectorHighlighter, FieldQuery

__all__ = ["FastVectorHighlighter", "FieldQuery"]

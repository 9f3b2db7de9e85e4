"""Operational tools (CheckIndex etc.)."""

from rucene_tpu_torch.tools.check_index import CheckIndexStatus, check_index, exorcise

__all__ = ["CheckIndexStatus", "check_index", "exorcise"]

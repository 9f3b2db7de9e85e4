"""Host-engine result type (counterpart of rucene_tpu/search/host_engine.py).

Only ``HostHits`` is ported: the scalar C++ engine (search/scalar_engine.py)
returns it. The dense numpy evaluation of rows that need host evaluation is
ROADMAP.md §1 item 9.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class HostHits:
    total_hits: int
    docs: np.ndarray  # i32[<=k] segment-local doc ids
    scores: np.ndarray  # f32[<=k]

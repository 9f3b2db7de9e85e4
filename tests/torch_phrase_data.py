"""One small phrase index served by both packages' device segments, for the
module-level phrase tests (tests/test_torch_phrase_device.py and
tests/test_torch_phrase_plane.py). Imports rucene_tpu, so CPU tests only."""

from __future__ import annotations

import numpy as np
import torch

from rucene_tpu.codec import device as ref_device
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu_torch.codec import device as port_device
from rucene_tpu_torch.codec.postings import packed_from_reference
from tests.conftest import make_docs, random_corpus


def phrase_texts(seed: int = 3, n: int = 700) -> list[str]:
    """Random word docs (3-40 tokens) plus docs that overflow: "hot" 70
    times (past FMAX), "tail" at position 130 (past PMAX), "brown" 40 times
    (past the candidate tables' 32)."""
    rng = np.random.default_rng(seed)
    texts = random_corpus(rng, n)
    texts[10] = "hot " * 70 + "spot"
    texts[20] = "the " * 130 + "tail end quick"
    texts[30] = "quick " + "brown " * 40 + "fox"
    texts[40] = "hot spot tail end"
    return texts


def packed_segment(texts):
    buf = SegmentBuffer()
    for d in make_docs(texts):
        buf.add_document(d)
    return pack_segment(buf.finish())


def segments(packed, decoded: bool):
    """(reference DeviceSegment, port DeviceSegment on the CPU, port
    PackedSegment), both packed or both decoded."""
    ref = ref_device.build_device_segment(packed)
    port_packed = packed_from_reference(packed)
    port = port_device.build_device_segment(port_packed, "cpu")
    if decoded:
        ref = ref_device.add_decoded_planes(
            ref, packed.num_blocks, ref_device.blk_fid_host(packed)
        )
        port = port_device.add_decoded_planes(port, freq_dtype=torch.int16)
    return ref, port, port_packed


def term_blocks(packed, term: str, field: str = "body") -> np.ndarray:
    pf = packed.fields[field]
    o = pf.term_ord[term]
    s, c = int(pf.block_start[o]), int(pf.block_count[o])
    return np.arange(s, s + c, dtype=np.int32)

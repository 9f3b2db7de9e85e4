"""The two plane budgets of the port (codec/device.py) follow one rule: the
fixed card (CARD_BYTES, 80 GiB) less a segment's own tensors and a 256-row
batch's transients over its doc axis, halved, whatever device the segment
sits on. The phrase position-plane cache gets 1-16 GiB, the dense tf
planes what is left once that 16 GiB ceiling is set aside, up to 8 GiB.

Pinned at 1M docs (the bench corpus, both at their caps) and at 8.8M
docs (BASELINE.json's MS MARCO passage axis, where the segment's own
bytes move both), with the phrase resident set (planes that 3/4 of the
phrase budget holds: 2 words a doc when every doc fits 64 positions, 4
otherwise). A CPU leaf and a leaf whose tensors report a CUDA device get
the same budgets, the same tf-plane policy and the same resident-set
size: no number reads the device (no card is needed to check it).
"""

from dataclasses import fields
from types import SimpleNamespace

import pytest
import torch

from rucene_tpu_torch.codec import device as codec_device
from rucene_tpu_torch.codec.device import (
    DeviceSegment,
    device_bytes,
    phrase_plane_budget,
    plane_policy,
    tf_plane_budget,
)
from rucene_tpu_torch.search.phrase_path import PhrasePathMixin, resident_plane_count
from rucene_tpu_torch.util import round_up

GIB = 1 << 30
MS_MARCO_DOCS = 8_841_823
# the segment's own tensors at 8,841,823 docs in one segment, before its
# tf planes, as read on an H100 (portbench's zipf8m: 2,719,472 blocks
# decoded, norms, positions, block tables)
OWN_AT_8M = 2_963_748_572

# (docs, the segment's own bytes) -> (phrase budget, tf budget, resident
# planes at 2 words, at 4 words)
PINNED = {
    (1_000_000, 4 * GIB): (16 * GIB, 8 * GIB, 1431, 757),
    (1_000_000, 32 * GIB): (16 * GIB, 8 * GIB, 1431, 757),
    (MS_MARCO_DOCS, OWN_AT_8M): (16 * GIB, 8 * GIB, 161, 85),
    (MS_MARCO_DOCS, 4 * GIB): (16 * GIB, 8 * GIB, 161, 85),
    (MS_MARCO_DOCS, 12 * GIB): (13_871_087_616, 5_281_153_024, 130, 69),
    (MS_MARCO_DOCS, 32 * GIB): (3_133_669_376, 0, 29, 15),
}


@pytest.mark.parametrize("docs,own", sorted(PINNED))
def test_budgets_pinned(docs, own):
    mdp = round_up(docs, codec_device.DOC_AXIS_MULTIPLE)
    phrase, tf, res2, res4 = PINNED[(docs, own)]
    assert phrase_plane_budget(mdp, own) == phrase
    assert tf_plane_budget(mdp, own) == tf
    frac = PhrasePathMixin.PLANE_RESIDENT_FRAC
    assert resident_plane_count(phrase, mdp, 2, frac) == res2
    assert resident_plane_count(phrase, mdp, 4, frac) == res4
    # one rule: both halve what the card leaves; the tf planes also set
    # the phrase cache's ceiling aside
    left = codec_device.CARD_BYTES - own - 256 * 20 * mdp
    assert phrase == max(GIB, min(16 * GIB, left // 2))
    assert tf == max(0, min(8 * GIB, (left - 16 * GIB) // 2))


class _CudaTyped(DeviceSegment):
    """The same tensors, reporting a CUDA device (the old phrase budget
    read the card's memory for such a segment)."""

    @property
    def device(self) -> torch.device:
        return torch.device("cuda", 0)


def _segment(docs: int) -> DeviceSegment:
    """A DeviceSegment of a ``docs`` doc axis: live mask and one norms row
    at full size, small block tables."""
    mdp = round_up(docs, codec_device.DOC_AXIS_MULTIPLE)
    small = torch.zeros(1024, dtype=torch.int32)
    return DeviceSegment(
        data=torch.zeros(4096, dtype=torch.int32), blk_off=small, blk_doc_bits=small,
        blk_freq_bits=small, blk_base=small, blk_count=small,
        live=torch.ones(mdp, dtype=torch.bool), blk_fid=small,
        norms=torch.zeros((1, mdp), dtype=torch.uint8),
        positions=torch.zeros(4096, dtype=torch.int32), blk_pos_base=small,
    )


@pytest.mark.parametrize("docs", [1_000_000, MS_MARCO_DOCS])
def test_cpu_and_cuda_typed_leaf_agree(docs, monkeypatch):
    cpu = _segment(docs)
    cuda_typed = _CudaTyped(**{f.name: getattr(cpu, f.name) for f in fields(DeviceSegment)})
    assert cuda_typed.device.type == "cuda" and cpu.device.type == "cpu"
    monkeypatch.setenv("RUCENE_PLANES", "auto")
    searcher = PhrasePathMixin()
    got = []
    for dev in (cpu, cuda_typed):
        budget = searcher._plane_budget_bytes(SimpleNamespace(device=dev))
        got.append((
            budget, plane_policy(dev.max_doc_padded, device_bytes(dev)),
            resident_plane_count(budget, dev.max_doc_padded, 2, searcher.PLANE_RESIDENT_FRAC),
        ))
    assert got[0] == got[1]
    mdp = cpu.max_doc_padded
    assert got[0][0] == phrase_plane_budget(mdp, device_bytes(cpu))
    assert got[0][1] == (tf_plane_budget(mdp, device_bytes(cpu)), max(mdp // 512, 4))

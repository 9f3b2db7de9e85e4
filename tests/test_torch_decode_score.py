"""The port's scoring decode (K2's twin decode_score_blocks_plain and its
wrapper, rucene_tpu_torch/ops/cuda_decode.py) against rucene_tpu's
decode_score_work_items_pallas in interpret mode, bit for bit on valid
lanes, on the EF-heavy and plain corpora of tests/test_torch_decode.py
with a 3-row random cache and a varying fid (the model is
tests/test_pallas_decode.py::test_pallas_scoring_decode_matches_gather)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rucene_tpu.codec import device as ref_device
from rucene_tpu.ops.pallas_decode import G, decode_score_work_items_pallas
from rucene_tpu.util.packing import EF_TAG
from rucene_tpu_torch.codec.device import build_device_segment
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.ops.cuda_decode import (
    decode_blocks_plain,
    decode_score_blocks,
    decode_score_blocks_plain,
    min_bytes,
)
from rucene_tpu_torch.ops.decode import INVALID_DOC
from tests.test_torch_decode import _CORPORA


@pytest.fixture(scope="module", params=sorted(_CORPORA))
def case(request):
    """(packed, item block ids, fid, cache, port tables per item)."""
    packed = _CORPORA[request.param]()
    if request.param == "ef_heavy":
        assert (np.asarray(packed.blk_doc_bits) >= EF_TAG).any()
    nb = packed.num_blocks
    w = ((nb + G - 1) // G) * G
    idx = np.arange(w) % nb  # pad by repeating valid blocks
    rng = np.random.default_rng(57)
    cache = (np.abs(rng.standard_normal((3, 256))) + 0.25).astype(np.float32)
    fid = (np.arange(w) % 3).astype(np.int32)
    seg = build_device_segment(packed_from_reference(packed), "cpu")
    t_idx = torch.from_numpy(idx)
    tables = tuple(a[t_idx] for a in (seg.blk_off, seg.blk_doc_bits, seg.blk_freq_bits,
                                      seg.blk_base, seg.blk_count))
    args = (seg.data, *tables, torch.from_numpy(fid), torch.from_numpy(cache))
    return packed, idx, fid, cache, args


def test_twin_matches_pallas_interpret(case):
    """docs, freqs and cval of the twin equal the Pallas scoring kernel's
    on every valid lane; cval bit for bit (a copy of a table entry)."""
    packed, idx, fid, cache, args = case
    dev = ref_device.build_device_segment(packed)

    def col(a):
        return jnp.asarray(np.asarray(a)[idx])

    data2d = jax.lax.bitcast_convert_type(dev.data, jnp.int32).reshape(-1, 128)
    p_docs, p_freqs, p_cval = decode_score_work_items_pallas(
        data2d, col(dev.blk_off), col(dev.blk_doc_bits), col(dev.blk_freq_bits),
        col(dev.blk_base), jnp.asarray(fid), jnp.asarray(cache), interpret=True,
    )
    docs, freqs, cval = decode_score_blocks_plain(*args)
    valid = np.arange(128)[None, :] < np.asarray(packed.blk_count)[idx][:, None]
    assert valid.sum() > 0
    np.testing.assert_array_equal(docs.numpy()[valid], np.asarray(p_docs)[valid])
    np.testing.assert_array_equal(freqs.numpy()[valid], np.asarray(p_freqs)[valid])
    np.testing.assert_array_equal(
        cval.numpy().view(np.int32)[valid], np.asarray(p_cval).view(np.int32)[valid]
    )


def test_twin_is_decode_then_gather(case):
    """The twin is decode_blocks_plain plus cache[fid, norm] on valid lanes;
    lanes past count (an inert item has count 0) hold INVALID_DOC, 0, 0."""
    _packed, _idx, fid, cache, args = case
    count = args[5].clone()
    count[::5] = 0
    args = args[:5] + (count,) + args[6:]
    docs, freqs, cval = decode_score_blocks_plain(*args)
    d_docs, d_freqs, d_norms = decode_blocks_plain(*args[:6])
    assert torch.equal(docs, d_docs) and torch.equal(freqs, d_freqs)
    valid = (np.arange(128)[None, :] < count.numpy()[:, None])
    want = cache.reshape(-1)[fid[:, None] * 256 + d_norms.numpy().astype(np.int64)]
    np.testing.assert_array_equal(cval.numpy()[valid], want[valid])
    assert (docs.numpy()[~valid] == INVALID_DOC).all()
    assert (freqs.numpy()[~valid] == 0).all() and (cval.numpy()[~valid] == 0).all()


def test_wrapper_takes_the_twin_on_cpu(case):
    *_, args = case
    got = decode_score_blocks(*args)
    want = decode_score_blocks_plain(*args)
    for g, w, dt in zip(got, want, (torch.int32, torch.int32, torch.float32)):
        assert g.dtype == w.dtype == dt
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", ["decode_blocks", "decode_score_blocks"])
def test_min_bytes_hand_count(kernel):
    """Four items: a FOR block (5-bit docs, 2-bit freqs: 20 + 8 + 32 norm
    words), an EF block of 37 lanes (low width 3: 12 + 12 doc words, 1-bit
    freqs: 4, and ceil(37 / 4) = 10 norm words),
    the first block again (read once) and an inert item (count 0: no
    words, no cache row). K1 writes 4 + 2 + 1 bytes a lane, K2 12 and reads
    the cache rows of fields 0 and 1."""
    t = torch.tensor
    off, dbits, fbits = t([0, 60, 0, 120]), t([5, EF_TAG + 3, 5, 7]), t([2, 1, 2, 3])
    count = t([128, 37, 128, 0])
    words = (60 + 38) * 4
    if kernel == "decode_blocks":
        want = 4 * 5 * 4 + words + 4 * 128 * 7
        assert min_bytes(off, dbits, fbits, count, lane_bytes=7) == want == 4056
    else:
        want = 4 * 6 * 4 + words + 2 * 1024 + 4 * 128 * 12
        got = min_bytes(off, dbits, fbits, count, lane_bytes=12, fid=t([0, 1, 0, 5]))
        assert got == want == 8680

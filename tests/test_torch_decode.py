"""The port's postings decode (rucene_tpu_torch: ops/decode.py twin, the
decode kernel's wrapper, codec/device.add_decoded_planes) against
rucene_tpu's XLA decoder and its Pallas kernel in interpret mode — bit for
bit, on the EF-heavy and plain corpora of tests/test_pallas_decode.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rucene_tpu.codec import device as ref_device
from rucene_tpu.codec.postings import pack_segment
from rucene_tpu.index.memory import SegmentBuffer
from rucene_tpu.ops.pallas_decode import G, decode_work_items_pallas
from rucene_tpu.util.packing import EF_TAG
from rucene_tpu_torch.codec.device import add_decoded_planes, build_device_segment
from rucene_tpu_torch.codec.postings import packed_from_reference
from rucene_tpu_torch.ops.cuda_decode import decode_blocks, decode_blocks_plain
from tests.conftest import make_docs, random_corpus
from torch_kernel_data import synthetic_blocks


def _ef_heavy_segment():
    rng = np.random.default_rng(77)
    texts = random_corpus(rng, 400)
    texts = [
        t + (" efhot" if (i < 70 or 330 <= i < 390) else "")
        for i, t in enumerate(texts)
    ]
    buf = SegmentBuffer()
    for d in make_docs(texts):
        buf.add_document(d)
    return pack_segment(buf.finish())


def _plain_segment():
    # uniform wide vocab: moderate deltas everywhere, FOR wins every block
    rng = np.random.default_rng(78)
    texts = [
        " ".join(f"u{int(x)}" for x in rng.integers(0, 5000, size=10))
        for _ in range(300)
    ]
    buf = SegmentBuffer()
    for d in make_docs(texts):
        buf.add_document(d)
    return pack_segment(buf.finish())


_CORPORA = {"ef_heavy": _ef_heavy_segment, "plain": _plain_segment}


@pytest.fixture(scope="module", params=sorted(_CORPORA))
def packed(request):
    p = _CORPORA[request.param]()
    if request.param == "ef_heavy":
        assert (np.asarray(p.blk_doc_bits) >= EF_TAG).any()
    return p


def _port_tables(packed):
    seg = build_device_segment(packed_from_reference(packed), "cpu")
    return seg, (seg.data, seg.blk_off, seg.blk_doc_bits, seg.blk_freq_bits,
                 seg.blk_base, seg.blk_count)


def test_twin_matches_reference_decoder(packed):
    """Every block, every lane: the twin equals rucene_tpu's XLA decoder
    (codec/device._decode_chunk) bit for bit, padding lanes included."""
    dev = ref_device.build_device_segment(packed)
    nb = packed.num_blocks
    x_docs, x_freqs, x_norms = ref_device._decode_chunk(
        dev.data, dev.blk_off[:nb], dev.blk_doc_bits[:nb], dev.blk_freq_bits[:nb],
        dev.blk_base[:nb], dev.blk_count[:nb], has_ef=True,
    )
    _, tables = _port_tables(packed)
    docs, freqs, norms = decode_blocks_plain(*tables)
    np.testing.assert_array_equal(docs.numpy(), np.asarray(x_docs))
    np.testing.assert_array_equal(freqs.numpy(), np.asarray(x_freqs))
    np.testing.assert_array_equal(norms.numpy(), np.asarray(x_norms))


def test_twin_matches_pallas_interpret(packed):
    """The twin equals decode_work_items_pallas(interpret=True) on the
    lanes the caller keeps (the kernel leaves lanes past count unmasked)."""
    dev = ref_device.build_device_segment(packed)
    nb = packed.num_blocks
    w = ((nb + G - 1) // G) * G
    idx = np.arange(w) % nb  # pad by repeating valid blocks

    def col(a):
        return np.asarray(a)[idx]

    data2d = jax.lax.bitcast_convert_type(dev.data, jnp.int32).reshape(-1, 128)
    p_docs, p_freqs, p_norms = decode_work_items_pallas(
        data2d, *(jnp.asarray(col(a)) for a in (
            dev.blk_off, dev.blk_doc_bits, dev.blk_freq_bits, dev.blk_base)),
        interpret=True,
    )
    seg, _ = _port_tables(packed)
    t_idx = torch.from_numpy(idx)
    docs, freqs, norms = decode_blocks_plain(
        seg.data, *(a[t_idx] for a in (seg.blk_off, seg.blk_doc_bits,
                                       seg.blk_freq_bits, seg.blk_base, seg.blk_count)),
    )
    valid = np.arange(128)[None, :] < np.asarray(packed.blk_count)[idx][:, None]
    for got, want in ((docs, p_docs), (freqs, p_freqs), (norms, p_norms)):
        np.testing.assert_array_equal(
            np.where(valid, got.numpy(), 0), np.where(valid, np.asarray(want), 0)
        )


def test_decoded_planes_match_reference(packed, monkeypatch):
    """add_decoded_planes equals the reference's decoded residency
    (RUCENE_DECODED=1) on every real block."""
    from rucene_tpu.index.reader import SegmentSnapshot

    monkeypatch.setenv("RUCENE_DECODED", "1")
    monkeypatch.setenv("RUCENE_SEG_FLOORS", "0")
    ref = SegmentSnapshot("s", packed).device
    nb = packed.num_blocks
    mine = build_device_segment(packed_from_reference(packed), "cpu")
    mine = add_decoded_planes(mine, freq_dtype=torch.int16)
    np.testing.assert_array_equal(mine.docs_dec.numpy(), np.asarray(ref.docs_dec)[:nb])
    np.testing.assert_array_equal(
        mine.freqs_dec.numpy().astype(np.int64), np.asarray(ref.freqs_dec)[:nb].astype(np.int64)
    )
    np.testing.assert_array_equal(mine.norm_dec.numpy(), np.asarray(ref.norm_dec)[:nb])
    np.testing.assert_array_equal(mine.blk_fid.numpy(), np.asarray(ref.blk_fid)[:nb])


def test_wrapper_takes_the_twin_on_cpu(packed):
    _, tables = _port_tables(packed)
    for got, want in zip(decode_blocks(*tables, freq_dtype=torch.int16),
                         decode_blocks_plain(*tables, freq_dtype=torch.int16)):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)



@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_reference_on_every_width(seed):
    """Synthetic blocks at every FOR width 0-32 and several EF low widths,
    counts 1, 37 and 128, bases across the int32 range (ids wrap): the
    twin equals rucene_tpu's XLA decoder bit for bit on every lane. The GPU
    tests hold the kernels to the twin on the same blocks."""
    data, off, dbits, fbits, base, count = synthetic_blocks(seed)
    x_docs, x_freqs, x_norms = ref_device._decode_chunk(
        jnp.asarray(data.numpy().view(np.uint32)), *(jnp.asarray(t.numpy()) for t in (
            off, dbits, fbits, base, count)), has_ef=True,
    )
    docs, freqs, norms = decode_blocks_plain(data, off, dbits, fbits, base, count)
    np.testing.assert_array_equal(docs.numpy(), np.asarray(x_docs))
    np.testing.assert_array_equal(freqs.numpy(), np.asarray(x_freqs))
    np.testing.assert_array_equal(norms.numpy(), np.asarray(x_norms))

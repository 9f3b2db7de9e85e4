"""search/phrase_device.py against rucene_tpu/search/phrase_device.py on
the CPU: one numpy PhraseBatch through both execute_phrases (jitted
execute_phrases_impl) and the port's execute_phrases_impl, for
exact and sloppy rows, on packed segments (K1's twin decodes the work) and
decoded ones. Docs, hits and overflow flags must be equal, scores within
4e-7 relative. Besides the full tables, a batch runs with fmax 2 (rows
whose candidates occur more often overflow) and with a candidate cap below
the group count (every row overflows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rucene_tpu.search import phrase_device as ref_pd
from rucene_tpu.search.searcher import work_has_ef
from rucene_tpu.search.similarity import BM25Similarity
from rucene_tpu_torch.search import phrase_device
from tests.torch_hitcheck import RTOL
from tests.torch_phrase_data import packed_segment, phrase_texts, segments, term_blocks

_PACKED = {}

PHRASES = [
    (["quick", "brown"], 0), (["brown", "fox"], 0), (["hot", "spot"], 0),
    (["tail", "end", "quick"], 0), (["the", "the"], 0), (["lazy", "dog", "the"], 0),
    (["quick", "brown"], 2), (["fox", "dog", "the"], 4), (["hot", "spot"], 1),
    (["the", "lazy"], 32), (["brown", "brown"], 0), (["search", "engine"], 3),
]


def _packed():
    if "p" not in _PACKED:
        _PACKED["p"] = packed_segment(phrase_texts())
    return _PACKED["p"]


def _batch(packed, rows, seed=4):
    """A numpy PhraseBatch over every block of each row's terms, padded
    with inert items to a multiple of 8."""
    pf = packed.fields["body"]
    blk, row, slot, pw, ws = [], [], [], [], []
    for r, (terms, _slop) in enumerate(rows):
        for j, t in enumerate(terms):
            b = term_blocks(packed, t)
            o = pf.term_ord[t]
            blk.append(b)
            row.append(np.full(len(b), r, np.int32))
            slot.append(np.full(len(b), j, np.int32))
            pw.append(np.full(len(b), pf.pos_width[o], np.int32))
            ws.append(np.full(len(b), pf.pos_word_start[o], np.int32))
    n = sum(len(b) for b in blk)
    w = -(-(n + 3) // 8) * 8

    def pad(parts, fill=0):
        out = np.full(w, fill, np.int32)
        out[:n] = np.concatenate(parts)
        return out

    rng = np.random.default_rng(seed)
    sim = BM25Similarity()
    cache = np.stack([sim.cache_row(None) + np.float32(0.3) * rng.random(256).astype(np.float32)])
    return dict(
        wi_block=pad(blk), wi_row=pad(row), wi_slot=pad(slot),
        wi_valid=np.arange(w) < n,
        n_terms=np.asarray([len(t) for t, _ in rows], np.int32),
        weight=(1.0 + rng.random(len(rows))).astype(np.float32),
        fid=np.full(len(rows), pf.field_id, np.int32),
        cache=cache.astype(np.float32),
        wi_pos_width=pad(pw, 1), wi_pos_start=pad(ws),
        slop=np.asarray([s for _, s in rows], np.int32),
    )


def _run_both(decoded, rows, k, cap, fmax):
    packed = _packed()
    ref_dev, port_dev, _ = segments(packed, decoded)
    nb = _batch(packed, rows)
    if cap is None:
        cap = min(len(nb["wi_block"]) * 128, 65536)
    slop_max = int(nb["slop"].max())
    want = ref_pd.execute_phrases(
        ref_dev, ref_pd.PhraseBatch(**{f: jnp.asarray(v) for f, v in nb.items()}),
        k=k, cand_cap=cap, fmax=fmax, slop_max=0 if slop_max == 0 else ref_pd.SLOP_CAP,
        has_ef=work_has_ef(packed.blk_doc_bits, nb["wi_block"], nb["wi_valid"], dev=ref_dev),
    )
    got = phrase_device.execute_phrases_impl(
        port_dev, phrase_device.PhraseBatch(**{f: torch.from_numpy(v) for f, v in nb.items()}),
        k=k, cand_cap=cap, fmax=fmax, slop_max=slop_max,
        nmax=int(nb["n_terms"].max()),
    )
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _assert_equal(want, got):
    (ws, wd, wh, wo), (gs, gd, gh, go) = want, got
    assert np.array_equal(gd, wd), "docs differ"
    assert np.array_equal(gh, wh) and np.array_equal(go, wo)
    fin = np.isfinite(ws)
    assert np.array_equal(np.isfinite(gs), fin)
    assert np.all(np.abs(gs[fin] - ws[fin]) <= RTOL * np.maximum(1.0, np.abs(ws[fin])))


@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("kind", ["exact", "sloppy"])
def test_execute_phrases_matches_reference(kind, decoded):
    rows = [r for r in PHRASES if (r[1] == 0) == (kind == "exact")]
    want, got = _run_both(decoded, rows, k=40, cap=None, fmax=32)
    _assert_equal(want, got)
    assert want[2].sum() > 0  # some rows match
    assert want[3].any()  # "brown" x 40 overflows fmax 32


@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("cap,fmax", [(None, 2), (64, 32)])
def test_execute_phrases_overflow_flags_match(decoded, cap, fmax):
    want, got = _run_both(decoded, PHRASES, k=10, cap=cap, fmax=fmax)
    _assert_equal(want, got)
    assert want[3].any()
    if cap is not None:
        assert want[3].all()  # too many groups: every row overflows

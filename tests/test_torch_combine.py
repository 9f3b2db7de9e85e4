"""The port's dense combine (ops/cuda_combine.py twin, fed by
flat_tables.build_combine_batch at the port's 512-doc bucket) against
rucene_tpu's hist-matmul kernel in interpret mode and its scatter oracle,
on tests/test_combine_kernel.py-style synthetic tables and on hand-built
entries. Counts exact, scores within 1e-5 relative (sum order differs:
float association only)."""

import numpy as np
import pytest
import torch

from rucene_tpu.ops.combine_tables import build_combine_tables
from rucene_tpu.ops.pallas_combine import combine_lanes_pallas, combine_lanes_reference
from rucene_tpu_torch.ops.cuda_combine import C_BUCKET, combine_lanes, min_bytes
from rucene_tpu_torch.search.flat_tables import build_combine_batch
from torch_kernel_data import combine_arrays, combine_entries, synthetic_items

RTOL = 1e-5


def _port_combine(docs, sc, rows, encs, valid, bf, bl, b, md):
    """Dense accumulators the way the executor builds them: the combine
    wrapper per 32-row chunk on the items' own lanes, then a plain scatter
    of the residue."""
    arrays = combine_arrays(rows, encs, valid)
    acc_s = torch.zeros((b, md), dtype=torch.float32)
    acc_c = torch.zeros((b, md), dtype=torch.int32)
    t_docs = torch.from_numpy(docs)
    t_sc = torch.from_numpy(sc)
    residue = []
    for cb in build_combine_batch(arrays, b, bf, bl, md, "cpu"):
        assert cb.e_item.dtype == torch.int32
        hi = min(cb.row_lo + 32, b)
        combine_lanes(cb.bucket_ptr, t_docs, t_sc, cb.e_item, cb.e_row, cb.e_enc,
                      acc_s[cb.row_lo:hi], acc_c[cb.row_lo:hi])
        residue.extend(cb.residue.tolist())
    acc_s = acc_s.numpy().astype(np.float64)
    acc_c = acc_c.numpy().astype(np.int64)
    for it in residue:
        lanes = docs[it] < md
        np.add.at(acc_s[rows[it]], docs[it][lanes], sc[it][lanes])
        np.add.at(acc_c[rows[it]], docs[it][lanes], encs[it])
    return acc_s, acc_c


def _assert_close(acc_s, acc_c, want_s, want_c):
    assert np.array_equal(acc_c, want_c), "counts differ"
    err = np.abs(acc_s - want_s)
    assert (err <= RTOL * np.maximum(1.0, np.abs(want_s))).all(), f"max err {err.max()}"


def _hand_combine(b, md, seed):
    """combine_entries through the wrapper (the twin on the CPU), and the
    item-level inputs for the references."""
    ptr, target, sc, e_item, e_row, e_enc, rows, encs = combine_entries(b=b, md=md, seed=seed)
    out_s = torch.full((b, md), np.nan)
    out_c = torch.full((b, md), -1, dtype=torch.int32)
    combine_lanes(*(torch.from_numpy(a) for a in (ptr, target, sc, e_item, e_row, e_enc)),
                  out_s, out_c)
    return (out_s.numpy().astype(np.float64), out_c.numpy().astype(np.int64),
            (ptr, target, sc, e_item, e_row, e_enc, rows, encs))


@pytest.mark.parametrize("seed,b,w", [(0, 8, 40), (1, 32, 96), (2, 40, 120)])
def test_twin_matches_scatter_oracle(seed, b, w):
    md = 4096
    docs, sc, rows, encs, valid, bf, bl = synthetic_items(w=w, b=b, md=md, seed=seed)
    acc_s, acc_c = _port_combine(docs, sc, rows, encs, valid, bf, bl, b, md)
    want_s, want_c = combine_lanes_reference(docs, sc, rows, encs, valid, b, md)
    _assert_close(acc_s, acc_c, want_s, want_c)


@pytest.mark.parametrize("seed", [0, 3])
def test_twin_matches_pallas_interpret(seed):
    """Same items through rucene_tpu's combine kernel (interpret mode) at the
    port's bucket width, residue folded the same way."""
    md, b = 4096, 8
    docs, sc, rows, encs, valid, bf, bl = synthetic_items(md=md, b=b, seed=seed)
    w = len(rows)
    tbl = build_combine_tables(
        np.arange(w, dtype=np.int32), rows, encs, valid, w, bf, bl, md,
        c_bucket=C_BUCKET,
    )
    safe = np.clip(tbl.e_item, 0, w - 1)
    live = tbl.e_item >= 0
    p_s, p_c = combine_lanes_pallas(
        tbl.g_bucket, tbl.g_first,
        np.where(live[:, None], docs[safe], md + 1).astype(np.int32),
        np.where(live[:, None], sc[safe], 0.0).astype(np.float32),
        tbl.e_row, tbl.e_enc.astype(np.float32),
        n_buckets=tbl.n_buckets, c_bucket=C_BUCKET, interpret=True,
    )
    p_s = np.asarray(p_s)[:b, :md].astype(np.float64)
    p_c = np.asarray(p_c)[:b, :md].astype(np.int64)
    for it in tbl.residue_items:
        lanes = docs[it] < md
        np.add.at(p_s[rows[it]], docs[it][lanes], sc[it][lanes])
        np.add.at(p_c[rows[it]], docs[it][lanes], encs[it])
    acc_s, acc_c = _port_combine(docs, sc, rows, encs, valid, bf, bl, b, md)
    _assert_close(acc_s, acc_c, p_s, p_c)


@pytest.mark.parametrize("seed", [4, 9])
def test_repeated_and_invalid_items_match_oracle_and_pallas(seed):
    """Entries that repeat items across up to 16 buckets, straddle bucket
    edges and name all-invalid items: the wrapper against the scatter
    oracle over the items, and against rucene_tpu's kernel (interpret mode)
    fed the same entries with their lanes expanded, 8 to a grid step."""
    b, md = 8, 8192
    acc_s, acc_c, (ptr, target, sc, e_item, e_row, e_enc, rows, encs) = _hand_combine(b, md, seed)
    assert len(np.unique(e_item)) < len(e_item)  # items repeat across buckets
    assert (target[e_item] > md).all(axis=1).any()  # some entries have no lane
    want_s, want_c = combine_lanes_reference(
        target, sc, rows, encs, np.ones(len(rows), bool), b, md
    )
    _assert_close(acc_s, acc_c, want_s, want_c)

    g = 8  # the reference kernel's entries per grid step: pad each bucket
    docs_e, sc_e, row_e, enc_e, g_bucket, g_first = [], [], [], [], [], []
    for bucket in range(len(ptr) - 1):
        ent = np.arange(ptr[bucket], ptr[bucket + 1])
        steps = max(1, -(-len(ent) // g))
        pad = steps * g - len(ent)
        docs_e.append(np.concatenate([target[e_item[ent]], np.full((pad, 128), md + 1)]))
        sc_e.append(np.concatenate([sc[e_item[ent]], np.zeros((pad, 128))]))
        row_e.append(np.concatenate([e_row[ent], np.zeros(pad)]))
        enc_e.append(np.concatenate([e_enc[ent], np.zeros(pad)]))
        g_bucket += [bucket] * steps
        g_first += [1] + [0] * (steps - 1)
    p_s, p_c = combine_lanes_pallas(
        np.asarray(g_bucket, np.int32), np.asarray(g_first, np.int32),
        np.concatenate(docs_e).astype(np.int32), np.concatenate(sc_e).astype(np.float32),
        np.concatenate(row_e).astype(np.int32), np.concatenate(enc_e).astype(np.float32),
        n_buckets=len(ptr) - 1, c_bucket=C_BUCKET, interpret=True,
    )
    _assert_close(acc_s, acc_c, np.asarray(p_s)[:b].astype(np.float64),
                  np.asarray(p_c)[:b].astype(np.int64))


@pytest.mark.parametrize("n_rows", [1, 7, 32])
def test_row_counts_match_oracle(n_rows):
    """Calls of 1, 7 and 32 rows: every output element is written (the
    outputs start as NaN / -1), counts exact."""
    md = 4096
    acc_s, acc_c, (_p, target, sc, _i, _r, _e, rows, encs) = _hand_combine(n_rows, md, n_rows)
    want_s, want_c = combine_lanes_reference(
        target, sc, rows, encs, np.ones(len(rows), bool), n_rows, md
    )
    _assert_close(acc_s, acc_c, want_s, want_c)


def test_bucket_offsets_cover_every_entry():
    """Entries sorted by bucket, offsets monotone and complete; every entry
    lies in a bucket its item overlaps; the builder's inert entries gone."""
    md, b = 4096, 8
    docs, sc, rows, encs, valid, bf, bl = synthetic_items(md=md, b=b, seed=5)
    arrays = combine_arrays(rows, encs, valid)
    (cb,) = build_combine_batch(arrays, b, bf, bl, md, "cpu")
    ptr = cb.bucket_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == cb.e_item.numel() and (np.diff(ptr) >= 0).all()
    assert len(ptr) == md // C_BUCKET + 1
    items = cb.e_item.numpy()
    assert (items >= 0).all()
    for bucket in range(len(ptr) - 1):
        for it in items[ptr[bucket]:ptr[bucket + 1]]:
            assert bf[it] // C_BUCKET <= bucket <= bl[it] // C_BUCKET


def test_min_bytes_hand_count():
    """Two buckets, two rows: item 0 has 128 lanes strided over both
    buckets (two entries), item 1 ten lanes in bucket 1, item 2 is never
    named. 2 items x 128 doc ids x 4 B + 138 landed scores x 4 B + 3
    entries x 12 B + 3 offsets x 4 B + 2 rows x 1024 docs x 8 B."""
    md = 2 * C_BUCKET
    target = torch.full((3, 128), md + 1, dtype=torch.int32)
    target[0] = torch.arange(128) * 8
    target[1, :10] = 600 + torch.arange(10)
    target[2] = torch.arange(128)
    e_item = torch.tensor([0, 0, 1], dtype=torch.int32)
    want = 1024 + 552 + 36 + 12 + 16384
    assert min_bytes(target, e_item, n_buckets=2, n_rows=2) == want == 18008


def test_wrapper_rejects_bad_outputs():
    ptr = torch.zeros(9, dtype=torch.int32)
    lanes = torch.zeros((1, 128), dtype=torch.int32)
    e = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError):
        combine_lanes(ptr, lanes, lanes.float(), e, e, e,
                      torch.zeros((33, 8 * C_BUCKET)),  # more than 32 rows
                      torch.zeros((33, 8 * C_BUCKET), dtype=torch.int32))

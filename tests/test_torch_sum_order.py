"""The port's summation rule: the f32 score of a (row, doc) is +0.0 plus each
of its contributions, added in work-list item order (row, clause, block),
one rounding an add, on the card and on the CPU.

Held here, on the CPU, with inputs drawn from numpy seeds:
- ops/ordered_sum.segment_sum_ordered (its plain twin here) against a numpy
  left-to-right f32 loop, np.add.at and the reference's ``.at[].add``
  scatter (jax on the CPU), on crafted groups whose orders give different
  sums and on seeded groups of 1-12 lanes;
- the combine kernel's twin (ops/cuda_combine.combine_lanes_plain) on one
  row's entries from 3-6 clauses in one bucket, against the left-to-right
  sum in item order;
- flat_tables.build_combine_batch: each bucket's entries in item order;
- execute_flat_impl's dense branch (no residue), its candidate branch and
  execute_planes bit-equal to each other and to the left-to-right sums of
  the decoded lanes, on OR rows of 3-8 terms;
- flat_tables.residue_passes: no pass reaches a (row, doc) twice, and
  overlapping items of a row fall in passes in item order; the dense
  branch with residue items: the kernel's items in item order, then the
  residue's, run after run;
- repeated large calls (200,000 lanes and more, several torch threads) of
  the twin and of the dense branch: bit-equal run to run and to the
  left-to-right sums (an index_put_ with accumulate, which the dense
  branch used before, adds from several threads: out of item order, and
  not always in the same order).
The ``gpu`` twins of the first two hold the kernels to the same sums on
the card, and skip here:

    python -m pytest --noconftest tests/test_torch_sum_order.py -m gpu -q
"""

import numpy as np
import pytest
import torch

import rucene_tpu_torch as T
from rucene_tpu_torch.drivers.workload import pack_corpus
from rucene_tpu_torch.index.reader import IndexReader, SegmentSnapshot
from rucene_tpu_torch.ops.cuda_combine import C_BUCKET, combine_lanes, combine_lanes_plain
from rucene_tpu_torch.ops.ordered_sum import (
    group_ids,
    segment_sum_ordered,
    segment_sum_ordered_plain,
)
from rucene_tpu_torch.search import executor, flat_tables
from torch_kernel_data import combine_arrays, synthetic_items

TINY = np.float32(2.0**-24)  # half an ULP of 1.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def l2r_groups(values, seg_start):
    """Each group's numpy f32 sum, +0.0 then left to right."""
    out = []
    for v, st in zip(values.astype(np.float32), seg_start):
        if st:
            out.append(np.float32(0.0))
        out[-1] = np.float32(out[-1] + v)
    return np.asarray(out, np.float32)


def l2r_slots(keys, values):
    """(slot keys, sums): each slot's +0.0 plus its values in input order,
    f32, one rounding an add (vectorized by position within the slot)."""
    order = np.argsort(keys, kind="stable")
    k, v = keys[order], values[order].astype(np.float32)
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    lens = np.diff(np.r_[starts, len(k)])
    acc = np.zeros(len(starts), np.float32)
    for j in range(int(lens.max(initial=0))):
        m = lens > j
        acc[m] = acc[m] + v[starts[m] + j]
    return k[starts], acc


def crafted_groups():
    """Groups whose left-to-right sum differs from the pairwise or reversed
    one: [1, 2^-24, 2^-24] is 1.0 left to right and 1.0000001 pairwise."""
    groups = [[1.0, TINY, TINY], [TINY, TINY, 1.0], [3.0], [1.0, TINY, TINY, TINY, TINY],
              [0.5, 2.0**-25, 2.0**-25, 2.0**-25]]
    values = np.concatenate([np.asarray(g, np.float32) for g in groups])
    seg = np.zeros(len(values), bool)
    seg[np.cumsum([0] + [len(g) for g in groups[:-1]])] = True
    return values, seg


def seeded_groups(seed, n_groups=400):
    """Groups of 1-12 lanes, values over 2^-30..8 so that order matters."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 13, n_groups)
    n = int(lens.sum())
    values = (rng.random(n) * 2.0 ** rng.integers(-30, 4, n)).astype(np.float32)
    seg = np.zeros(n, bool)
    seg[np.r_[0, np.cumsum(lens)[:-1]]] = True
    return values, seg


def _sum(values, seg, dev="cpu"):
    return segment_sum_ordered(torch.from_numpy(values).to(dev), torch.from_numpy(seg).to(dev))


def test_ordered_sum_crafted_groups():
    values, seg = crafted_groups()
    got = _sum(values, seg).numpy()
    want = l2r_groups(values, seg)
    assert got[0] == np.float32(1.0) and got[1] == np.float32(1.0000001)
    assert np.array_equal(got[: len(want)], want)
    assert not got[len(want):].any()
    # the data tells the orders apart
    rev = [l2r_groups(g[::-1], np.r_[True, np.zeros(len(g) - 1, bool)])[0]
           for g in np.split(values, np.flatnonzero(seg)[1:])]
    assert not np.array_equal(np.asarray(rev, np.float32), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_sum_seeded_groups(seed):
    """Bit-equal to the left-to-right loop, to np.add.at, and to the
    reference's ``.at[].add`` scatter (which XLA runs in index order on the
    CPU); an explicit group-id argument changes nothing."""
    import jax.numpy as jnp

    values, seg = seeded_groups(seed)
    want = l2r_groups(values, seg)
    gid = np.cumsum(seg) - 1
    got = _sum(values, seg).numpy()
    assert np.array_equal(got[: len(want)], want)
    t_gid = group_ids(torch.from_numpy(seg))
    assert np.array_equal(t_gid.numpy(), gid)
    again = segment_sum_ordered_plain(torch.from_numpy(values), torch.from_numpy(seg), t_gid)
    assert torch.equal(again, torch.from_numpy(got))
    at = np.zeros(len(want), np.float32)
    np.add.at(at, gid, values)
    assert np.array_equal(at, want)
    ref = np.asarray(jnp.zeros(len(want), jnp.float32).at[gid].add(values))
    assert np.array_equal(ref, want)
    exact = [np.float32(g.sum(dtype=np.float64)) for g in np.split(values, np.flatnonzero(seg)[1:])]
    assert not np.array_equal(np.asarray(exact, np.float32), want)  # order matters in this data


def one_row_entries(n_clauses, seed):
    """One row's entries from ``n_clauses`` clauses in one bucket: a block a
    clause (distinct docs of the bucket), scores whose sums depend on the
    order. Returns (numpy tables for combine_lanes, oracle [C_BUCKET])."""
    rng = np.random.default_rng(seed)
    target = np.full((n_clauses, 128), C_BUCKET + 1, np.int32)
    sc = np.zeros((n_clauses, 128), np.float32)
    pool = np.array([1.0, 3.0, TINY, 2.0**-23, 2.0**-25, 0.75], np.float32)
    for c in range(n_clauses):
        n = int(rng.integers(96, 129))
        target[c, :n] = np.sort(rng.choice(C_BUCKET // 2, n, replace=False))  # overlapping docs
        sc[c, :n] = pool[rng.integers(0, len(pool), n)] * np.float32(1 + c / 8)
    e_item = np.arange(n_clauses, dtype=np.int32)
    tables = (np.array([0, n_clauses], np.int32), target, sc, e_item,
              np.zeros(n_clauses, np.int32), np.full(n_clauses, 256, np.int32))
    valid = target < C_BUCKET
    keys, sums = l2r_slots(target[valid].astype(np.int64), sc[valid])
    want = np.zeros(C_BUCKET, np.float32)
    want[keys] = sums
    rkeys, rsums = l2r_slots(target[::-1][valid[::-1]].astype(np.int64), sc[::-1][valid[::-1]])
    assert not np.array_equal(rsums, sums)  # order matters in this data
    return tables, want


def _combine(tables, dev="cpu", fn=combine_lanes):
    t = tuple(torch.from_numpy(a).to(dev) for a in tables)
    out_s = torch.full((1, C_BUCKET), np.nan, device=dev)
    out_c = torch.full((1, C_BUCKET), -1, dtype=torch.int32, device=dev)
    return fn(*t, out_s, out_c)


@pytest.mark.parametrize("n_clauses", [3, 4, 5, 6])
def test_combine_twin_adds_in_item_order(n_clauses):
    tables, want = one_row_entries(n_clauses, seed=n_clauses)
    got_s, got_c = _combine(tables)
    assert np.array_equal(got_s[0].numpy(), want)
    hits = np.bincount(tables[1][tables[1] < C_BUCKET], minlength=C_BUCKET)
    assert np.array_equal(got_c[0].numpy(), hits * 256)


@pytest.mark.parametrize("seed,b,w", [(1, 32, 96), (4, 40, 300), (7, 8, 60)])
def test_combine_batch_entries_in_item_order(seed, b, w):
    """Each chunk's entries are sorted by bucket and, within a bucket, by
    work item (the work list's order); bucket_ptr bounds each bucket."""
    md = 8192
    _docs, _sc, rows, encs, valid, bf, bl = synthetic_items(w=w, b=b, md=md, seed=seed)
    arrays = combine_arrays(rows, encs, valid)
    batches = flat_tables.build_combine_batch(arrays, b, bf, bl, md, "cpu")
    assert len(batches) == -(-b // 32)
    n_entries = 0
    for cb in batches:
        ptr = cb.bucket_ptr.numpy()
        items = cb.e_item.numpy()
        n_entries += len(items)
        for bucket in range(len(ptr) - 1):
            seg = items[ptr[bucket]:ptr[bucket + 1]]
            assert (np.diff(seg) > 0).all(), f"bucket {bucket}: {seg}"
            assert (bf[seg] // C_BUCKET <= bucket).all() and (bl[seg] // C_BUCKET >= bucket).all()
    assert n_entries > w // 2


def _or_rows(words, seed, n=40, lo=3, hi=9):
    """OR rows of 3-8 distinct terms from the head of the vocabulary."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = T.BooleanQuery()
        for t in rng.choice(words, int(rng.integers(lo, hi)), replace=False):
            q.should(T.TermQuery(T.Term("body", str(t))))
        out.append(q)
    return out


def _zipf_searcher(n_docs, vocab, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    texts = [" ".join(f"w{t}" for t in rng.choice(vocab, int(rng.integers(3, 9)), p=p / p.sum()))
             for _ in range(n_docs)]
    reader = IndexReader([SegmentSnapshot("s0", pack_corpus(texts))])
    return T.IndexSearcher(reader, device="cpu"), [f"w{i}" for i in range(vocab)]


def _flat_call(searcher, rows):
    """The flat executor's inputs for ``rows`` on the first leaf, as the
    searcher builds them: (leaf, FlatQueryBatch, CombineBatches, host
    tables for _run_planes)."""
    plans = [searcher._plan_for(q) for q in rows]
    rqs = [p.rq for p in plans]
    doc_freqs, stats = searcher._gather_stats(rqs, plans)
    b = len(rqs)
    t = max(len(rq.all_slots()) for rq in rqs)
    weight, occur, n_req, min_sh, _ma, _bo = flat_tables.build_clause_tables(
        rqs, searcher.similarity, doc_freqs, stats, b, t, plans=plans
    )
    leaf = searcher.reader.leaves[0]
    dev = leaf.device
    cache = flat_tables.build_leaf_cache(leaf, searcher.similarity, stats)
    bs, bc, fid = flat_tables.build_leaf_tables(leaf, rqs, b, t, plans=plans)
    arrays = flat_tables.build_flat_work(bs, bc, weight, fid, occur)[:6]
    fq = flat_tables.make_flat_batch(arrays, n_req, min_sh, cache, dev)
    combine = flat_tables.build_combine_batch(
        arrays, b, leaf.packed.blk_first_doc, leaf.packed.blk_last_doc, dev.max_doc_padded,
        dev.device,
    )
    return leaf, fq, combine, (rqs, weight, occur, cache, n_req, min_sh, plans)


def _lane_oracle(dev, fq, reverse=False, residue_last=None):
    """The decoded lanes of each (row, doc) summed left to right in item
    order (numpy; in reverse item order with ``reverse``; with the items
    ``residue_last`` after all others: the others in item order, then
    these in the order given), as a dense [b, md] f32 array (0 where no
    lane)."""
    target, sc, _valid = executor.decode_score_lanes(dev, fq)
    md = dev.max_doc_padded
    b = fq.n_required.shape[0]
    t = target.numpy().astype(np.int64)
    rows = np.broadcast_to(fq.wi_row.numpy()[:, None], t.shape)
    sc = sc.numpy()
    if reverse:
        t, rows, sc = t[::-1], rows[::-1], sc[::-1]
    if residue_last is not None:
        last = np.zeros(len(t), bool)
        last[residue_last] = True
        order = np.r_[np.flatnonzero(~last), residue_last]
        t, rows, sc = t[order], rows[order], sc[order]
    keep = t < md
    keys, sums = l2r_slots((rows * md + t)[keep], sc[keep])
    dense = np.zeros(b * md, np.float32)
    dense[keys] = sums
    return dense.reshape(b, md)


def _assert_top_equals_oracle(got, oracle):
    scores, docs, hits = (x.numpy() for x in got)
    for r in range(len(hits)):
        assert int(hits[r]) == int((oracle[r] > 0).sum()), f"row {r}"
        n = min(int(hits[r]), scores.shape[1])
        assert np.array_equal(scores[r, :n], oracle[r, docs[r, :n]]), f"row {r}"


@pytest.mark.parametrize("decoded", ["1", "0"])
def test_executors_agree_bit_for_bit(decoded, monkeypatch):
    """OR rows of 3-8 terms: the dense branch (no residue item), the
    candidate branch and (on decoded leaves) execute_planes return the same
    scores, docs and hits, and each returned score is the left-to-right sum
    of the row's decoded lanes at that doc, in item order."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    monkeypatch.setenv("RUCENE_PLANES", "1")
    searcher, words = _zipf_searcher(3000, 40, seed=11)
    rows = _or_rows(words[:24], seed=12)
    leaf, fq, combine, (rqs, weight, occur, cache, n_req, min_sh, plans) = _flat_call(searcher, rows)
    assert all(cb.residue.numel() == 0 for cb in combine)
    k = 4000  # above every row's hits: complete lists
    dense = executor.execute_flat_impl(leaf.device, fq, k, combine=combine)
    cand = executor.execute_flat_impl(leaf.device, fq, k)
    for d, c in zip(dense, cand):
        assert torch.equal(d, c)
    oracle = _lane_oracle(leaf.device, fq)
    _assert_top_equals_oracle(dense, oracle)
    if decoded == "1":
        planes = searcher._run_planes(leaf, rqs, weight, occur, cache, n_req, min_sh, k, plans)
        for p, d in zip(planes, dense):
            assert torch.equal(p, d)
    # the data tells the orders apart: the reverse item order sums otherwise
    assert not np.array_equal(_lane_oracle(leaf.device, fq, reverse=True), oracle)


def term_blocks(rng, n_terms, md):
    """Each term's blocks: 1-6 of them, doc ranges rising over [0, md).
    Returns (first block id of each term, block count, blk_first,
    blk_last)."""
    counts = rng.integers(1, 7, n_terms)
    firsts, lasts = [], []
    for n in counts:
        cuts = np.sort(rng.choice(md, 2 * int(n), replace=False))
        firsts.append(cuts[0::2])
        lasts.append(cuts[1::2])
    start = np.r_[0, np.cumsum(counts)[:-1]]
    return start, counts, np.concatenate(firsts), np.concatenate(lasts)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_residue_passes_split(seed):
    """Rows of 1-6 clauses (a term may repeat in a row), every block a
    residue item: each pass holds pairwise disjoint doc ranges within a
    row, items of a row whose ranges overlap fall in passes in item order,
    and a row takes no more passes than it has clauses."""
    rng = np.random.default_rng(seed)
    md = 1 << 16
    start, counts, bf, bl = term_blocks(rng, 12, md)
    rows, blocks, n_clauses = [], [], []
    for r in range(int(rng.integers(3, 9))):
        terms = rng.integers(0, 12, int(rng.integers(1, 7)))
        n_clauses.append(len(terms))
        for t in terms:
            blocks += range(start[t], start[t] + counts[t])
            rows += [r] * int(counts[t])
    wi_row = np.asarray(rows, np.int32)
    wi_block = np.asarray(blocks, np.int32)
    residue = np.arange(len(blocks), dtype=np.int32)
    items, ptr = flat_tables.residue_passes(residue, wi_row, wi_block, bf, bl)
    assert ptr[0] == 0 and ptr[-1] == len(residue) and (np.diff(ptr) > 0).all()
    assert sorted(items.tolist()) == residue.tolist()
    pass_of = np.empty(len(residue), np.int64)
    for j in range(len(ptr) - 1):
        got = items[ptr[j]:ptr[j + 1]]
        assert (np.diff(got) > 0).all()  # item order within a pass
        pass_of[got] = j
        for r in np.unique(wi_row[got]):
            mine = got[wi_row[got] == r]
            lo, hi = bf[wi_block[mine]], bl[wi_block[mine]]
            order = np.argsort(lo)
            assert (lo[order][1:] > hi[order][:-1]).all(), f"pass {j} row {r}"
    for r in np.unique(wi_row):
        mine = np.flatnonzero(wi_row == r)
        assert len(np.unique(pass_of[mine])) <= n_clauses[r]
        lo, hi = bf[wi_block[mine]], bl[wi_block[mine]]
        for a in range(len(mine)):
            for c in range(a + 1, len(mine)):
                if lo[c] <= hi[a] and lo[a] <= hi[c]:
                    assert pass_of[mine[a]] < pass_of[mine[c]]
    empty, eptr = flat_tables.residue_passes(residue[:0], wi_row, wi_block, bf, bl)
    assert len(empty) == 0 and eptr == (0,)


def _residue_searcher(seed, n_docs=12_000):
    """Head terms h0-h3 in most docs, filler words, and five sparse terms
    r0-r4 together in every 80th doc (1-3 times each): a block of r spans
    over 10,000 docs, more than SPARSE_SPAN buckets, so it is a residue
    item; its docs also hold head terms (the combine kernel's items)."""
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n_docs):
        w = [f"h{rng.integers(0, 4)}" for _ in range(int(rng.integers(1, 4)))]
        w += [f"f{rng.integers(0, 500)}" for _ in range(int(rng.integers(0, 8)))]
        if i % 80 == 7:
            for r in range(5):
                w += [f"r{r}"] * int(rng.integers(1, 4))
        texts.append(" ".join(rng.permutation(w)))
    reader = IndexReader([SegmentSnapshot("s0", pack_corpus(texts))])
    rows = []
    for _ in range(16):
        q = T.BooleanQuery()
        terms = [f"h{x}" for x in rng.choice(4, int(rng.integers(1, 3)), replace=False)]
        terms += [f"r{x}" for x in rng.choice(5, int(rng.integers(2, 6)), replace=False)]
        for t in rng.permutation(terms):
            q.should(T.TermQuery(T.Term("body", t)))
        rows.append(q)
    return T.IndexSearcher(reader, device="cpu"), rows


@pytest.mark.parametrize("decoded", ["1", "0"])
def test_dense_residue_after_kernel_items(decoded, monkeypatch):
    """OR rows of head terms (the combine kernel's items) and sparse terms
    (residue items, several passes a row): each score is +0.0 plus the
    kernel items' lanes in item order, then the residue items' lanes in
    item order; three runs are bit-equal. The data tells the orders apart:
    the residue in reverse pass order, or in full item order among the
    kernel's items, sums otherwise."""
    monkeypatch.setenv("RUCENE_DECODED", decoded)
    searcher, rows = _residue_searcher(seed=21)
    leaf, fq, combine, _host = _flat_call(searcher, rows)
    assert max(len(cb.residue_ptr) for cb in combine) > 2  # two passes or more
    residue = np.concatenate([cb.residue.numpy() for cb in combine])
    k = 12_000  # above every row's hits: complete lists
    runs = [executor.execute_flat_impl(leaf.device, fq, k, combine=combine) for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)
    oracle = _lane_oracle(leaf.device, fq, residue_last=np.sort(residue))
    _assert_top_equals_oracle(runs[0], oracle)
    reversed_passes = np.concatenate([
        cb.residue.numpy()[cb.residue_ptr[j]:cb.residue_ptr[j + 1]]
        for cb in combine for j in reversed(range(len(cb.residue_ptr) - 1))
    ])
    assert not np.array_equal(_lane_oracle(leaf.device, fq, residue_last=reversed_passes), oracle)
    assert not np.array_equal(_lane_oracle(leaf.device, fq), oracle)


def large_entries(seed=5, b=32, n_buckets=64):
    """One 32-row combine call with more than 200,000 lanes: rows of 3-6
    clauses, each clause 8-16 blocks of sorted distinct docs over the whole
    doc range (so a block's entries span several buckets), items in (row,
    clause, block) order, scores over 2^-20..4. Returns (numpy tables,
    item rows, md)."""
    rng = np.random.default_rng(seed)
    md = n_buckets * C_BUCKET
    targets, scores, item_rows = [], [], []
    for r in range(b):
        for _c in range(int(rng.integers(3, 7))):
            nb = int(rng.integers(8, 17))
            docs = np.sort(rng.choice(md, nb * 128, replace=False)).astype(np.int32)
            targets.append(docs.reshape(nb, 128))
            scores.append((rng.random((nb, 128)) * 2.0 ** rng.integers(-20, 3, (nb, 128)))
                          .astype(np.float32))
            item_rows += [r] * nb
    target = np.concatenate(targets)
    sc = np.concatenate(scores)
    item_rows = np.asarray(item_rows, np.int32)
    first, last = target[:, 0] // C_BUCKET, target[:, -1] // C_BUCKET
    span = last - first + 1
    e_item = np.repeat(np.arange(len(target)), span)
    e_bucket = np.repeat(first, span) + np.arange(len(e_item)) - np.repeat(np.cumsum(span) - span, span)
    order = np.argsort(e_bucket, kind="stable")
    e_item, e_bucket = e_item[order].astype(np.int32), e_bucket[order]
    ptr = np.searchsorted(e_bucket, np.arange(n_buckets + 1)).astype(np.int32)
    tables = (ptr, target, sc, e_item, item_rows[e_item], np.full(len(e_item), 256, np.int32))
    return tables, item_rows, md


@pytest.fixture
def threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(max(prev, 4))
    yield
    torch.set_num_threads(prev)


def test_large_twin_calls_reproducible(threads):
    """Three calls of the combine twin on over 200,000 lanes of 3-6-clause
    rows, with several torch threads: bit-equal to each other and to the
    left-to-right sums in item order."""
    tables, item_rows, md = large_entries()
    target, sc = tables[1], tables[2]
    assert target.size >= 200_000
    b = 32
    t = tuple(torch.from_numpy(a) for a in tables)
    runs = []
    for _ in range(3):
        out = (torch.empty((b, md)), torch.empty((b, md), dtype=torch.int32))
        runs.append(combine_lanes_plain(*t, *out))
    for s, c in runs[1:]:
        assert torch.equal(s, runs[0][0]) and torch.equal(c, runs[0][1])
    keys, sums = l2r_slots((item_rows[:, None].astype(np.int64) * md + target).ravel(), sc.ravel())
    want = np.zeros(b * md, np.float32)
    want[keys] = sums
    assert np.array_equal(runs[0][0].numpy().ravel(), want)


def test_large_dense_calls_reproducible(threads, monkeypatch):
    """Three execute_flat_impl calls on the dense branch over more than
    200,000 lanes of 3-6-clause OR rows (a packed leaf: the scoring decode's
    twin), with several torch threads: scores, docs and hits bit-equal run
    to run, and each score the left-to-right sum of its lanes."""
    monkeypatch.setenv("RUCENE_DECODED", "0")
    searcher, words = _zipf_searcher(40_000, 30, seed=3)
    rows = _or_rows(words[:16], seed=4, n=12, lo=3, hi=7)
    leaf, fq, combine, _host = _flat_call(searcher, rows)
    assert fq.wi_row.numel() * 128 >= 200_000
    assert all(cb.residue.numel() == 0 for cb in combine)
    k = 1000
    runs = [executor.execute_flat_impl(leaf.device, fq, k, combine=combine) for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)
    _assert_top_equals_oracle(runs[0], _lane_oracle(leaf.device, fq))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_sum_kernel_on_card(card, seed):
    """The ordered-sum kernel bit-equal to its plain twin and to the
    left-to-right loop, on the crafted and the seeded groups."""
    for values, seg in (crafted_groups(), seeded_groups(seed)):
        got = _sum(values, seg, card).cpu()
        assert torch.equal(got, _sum(values, seg))
        want = l2r_groups(values, seg)
        assert np.array_equal(got.numpy()[: len(want)], want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_clauses", [3, 4, 5, 6])
def test_combine_kernel_item_order_on_card(card, n_clauses):
    """The combine kernel on one row's entries from 3-6 clauses in one
    bucket: the left-to-right sum in item order, as its twin gives; and
    on the large call, bit-equal to the twin on the card."""
    tables, want = one_row_entries(n_clauses, seed=n_clauses)
    got_s, _got_c = _combine(tables, card)
    assert np.array_equal(got_s[0].cpu().numpy(), want)
    twin_s, _ = _combine(tables, card, combine_lanes_plain)
    assert torch.equal(got_s, twin_s)
    big, _rows, md = large_entries(seed=n_clauses)
    t = tuple(torch.from_numpy(a).to(card) for a in big)
    outs = [(torch.empty((32, md), device=card), torch.empty((32, md), dtype=torch.int32, device=card))
            for _ in range(2)]
    got = combine_lanes(*t, *outs[0])
    want2 = combine_lanes_plain(*t, *outs[1])
    assert torch.equal(got[0], want2[0]) and torch.equal(got[1], want2[1])

"""Several processes over torch.distributed
(rucene_tpu_torch/parallel/multi_host.py) on the CPU, after
tests/test_multi_host.py and tests/test_partial_load.py.

A world of two processes joins a gloo group through a ``file://`` store in
the test's temporary directory. Each loads only its own shard of an index
the port's writer committed (ShardedIndex.from_directory, partial mode) and
serves term, boolean, range, match-all, phrase and fallback rows: doc
freqs sum with one all_reduce, results gather with all_gather_into_tensor.
Both processes' answers must equal the reference's one-reader searcher
over the same files and the port's one-process searcher
(tests/torch_hitcheck.py's strict rules over complete hit lists, scores
within RTOL 4e-7). The replicated layout (the whole index in each
process, the batch's rows split between them) is held the same way. Each
process has a time limit, so a hung rendezvous fails the test instead of
stalling the suite.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import rucene_tpu as R
import rucene_tpu_torch as T
from rucene_tpu.index.reader import open_directory_reader as ref_open
from rucene_tpu.store.directory import FSDirectory as RefFS
from rucene_tpu_torch.parallel import multi_host as mh
from rucene_tpu_torch.parallel import sharded
from tests.conftest import random_corpus
from tests.torch_hitcheck import assert_batches_strict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_ALL = 2000
WORLD_TIMEOUT_S = 240

_WORKER = r"""
import json, sys
import rucene_tpu_torch as T
from rucene_tpu_torch.parallel import multi_host as mh
from rucene_tpu_torch.parallel import sharded
from tests.test_torch_multi_host import rows

store, index, rank, partition = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
mh.initialize(f"file://{store}", world_size=2, rank=rank, backend="gloo")
mesh = mh.make_pod_mesh(devices=["cpu"], partition=partition)
directory = T.FSDirectory(index)
if partition == "index":
    idx = sharded.ShardedIndex.from_directory(mesh, directory)
else:
    idx = sharded.ShardedIndex(mesh, T.open_directory_reader(directory))
got = sharded.ShardedSearcher(idx).search_batch(rows(T), k=int(sys.argv[5]))
print(json.dumps({
    "shape": [mesh.shape["shard"], mesh.shape["dp"]], "owned": sorted(idx.owned),
    "loaded": len(idx.leaves),
    "hits": [[td.total_hits, [[int(d), float(s)] for d, s in td.score_docs]] for td in got],
}))
"""


def rows(P):
    """Every row kind of the shard program and its fallbacks."""
    tq = lambda t: P.TermQuery(P.Term("body", t))  # noqa: E731
    mixed = P.BooleanQuery().must(P.PhraseQuery("body", ["quick", "brown"])).should(tq("the"))
    grouped = P.BooleanQuery().must(P.BooleanQuery().should(tq("fox")).should(tq("the"))).must(
        tq("dog"))
    return [
        tq("the"), tq("fox"), tq("tensor"),
        P.BooleanQuery().must(tq("quick")).should(tq("lazy")).must_not(tq("dog")),
        P.BooleanQuery().must(tq("index")).filter(P.PointRangeQuery("ts", 100, 600)),
        P.PointRangeQuery("ts", 900, 950),
        P.MatchAllDocsQuery(),
        P.PhraseQuery("body", ["quick", "brown"]),
        P.PhraseQuery("body", ["the", "lazy"], slop=2),
        mixed, grouped,
        P.DisjunctionMaxQuery([tq("fox"), tq("the")], tie_breaker=0.4),
    ]


@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    path = tmp_path_factory.mktemp("mh") / "index"
    texts = random_corpus(np.random.default_rng(77), 1200)
    w = T.IndexWriter(T.FSDirectory(str(path)),
                      T.IndexWriterConfig(max_buffered_docs=150, merge_on_commit=False))
    for i, t in enumerate(texts):
        d = T.Document()
        d.add(T.StringField("id", str(i), stored=True))
        d.add(T.TextField("body", t))
        d.add(T.IntPoint("ts", (i * 37) % 1000))
        w.add_document(d)
    w.commit()
    w.close()
    return str(path)


def _world(tmp_path, index, partition, k=K_ALL):
    """Both processes' outputs; a process past the time limit is killed
    and fails the test."""
    store = str(tmp_path / "store")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, store, index, str(r), partition, str(k)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": REPO},
        )
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _topdocs(out):
    from rucene_tpu_torch.search.searcher import ScoreDoc, TopDocs

    return [TopDocs(n, [ScoreDoc(d, np.float32(s)) for d, s in sd]) for n, sd in out["hits"]]


@pytest.mark.parametrize("partition", ["index", "replicated"])
def test_two_process_world_equals_one_process(committed, tmp_path, partition):
    want = R.IndexSearcher(ref_open(RefFS(committed))).search_batch(rows(R), k=K_ALL)
    one = sharded.ShardedSearcher(sharded.ShardedIndex.from_directory(
        sharded.make_mesh(2, 1, devices=["cpu"] * 2), T.FSDirectory(committed)
    )).search_batch(rows(T), k=K_ALL)
    assert_batches_strict(one, want)
    outs = _world(tmp_path, committed, partition)
    n_segments = len(T.open_directory_reader(T.FSDirectory(committed)).leaves)
    for rank, out in enumerate(outs):
        if partition == "index":  # each process loads its own shard only
            assert out["shape"] == [2, 1] and out["owned"] == [rank]
            assert 0 < out["loaded"] < n_segments
        else:  # one shard a process, the batch's rows split between them
            assert out["shape"] == [1, 2] and out["owned"] == [0]
        assert_batches_strict(_topdocs(out), want)
        assert_batches_strict(_topdocs(out), one)
    assert outs[0]["hits"] == outs[1]["hits"]


def test_pod_mesh_single_process_layout():
    """One process: make_pod_mesh lays its devices out as the reference's
    single-host mesh; initialize without an address does nothing."""
    mh.initialize()
    assert mh.process_count() == 1 and mh.process_index() == 0
    mesh = mh.make_pod_mesh(shards_per_host=4, devices=["cpu"] * 8)
    assert mesh.shape == {"shard": 4, "dp": 2} and not mesh.multi_process
    assert mh.make_pod_mesh(devices=["cpu"] * 4, partition="index").shape == {"shard": 1, "dp": 4}
    with pytest.raises(ValueError):
        mh.make_pod_mesh(shards_per_host=3, devices=["cpu"] * 8)
    assert mh.process_local_query_slice(100) == slice(0, 100)


def test_partial_load_reads_only_owned_segments(committed):
    """from_directory with owned_shards loads those shards' segments only;
    statistics come from the commit's metadata."""
    from rucene_tpu_torch.codec import files as segfiles

    mesh = sharded.make_mesh(4, 1, devices=["cpu"] * 4)
    idx = sharded.ShardedIndex.from_directory(mesh, T.FSDirectory(committed), owned_shards={1, 2})
    groups = sharded._partition_leaves(
        segfiles.read_segments_file(T.FSDirectory(committed)).segments, 4
    )
    assert {lf.name for lf in idx.leaves} == {i.name for si in (1, 2) for i in groups[si]}
    assert idx.views[0] is None and idx.views[3] is None and idx.views[1] is not None
    assert idx.global_stats["body"].doc_count == 1200
    word = "fox"
    reader = T.open_directory_reader(T.FSDirectory(committed))
    full = sharded.ShardedIndex.from_directory(mesh, T.FSDirectory(committed))
    assert full.local_doc_freq("body", word) == reader.doc_freq("body", word)

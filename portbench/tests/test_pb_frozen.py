"""The yardstick is frozen: the corpus, the traffic generator and the byte
count give fixed values, pinned here (not against the program's copies,
which later changes may alter)."""

import json
import os

import numpy as np
import pytest

from portbench import corpus as corpus_mod
from portbench import traffic
from portbench.metrics.postings_bytes import batch_bytes
from portbench.reference import bm25
from portbench.traffic import Row

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

PINNED = {
    ("mix", 0): [("term", (), (46,), ()), ("term", (), (986,), ()), ("term", (), (1002,), ()),
                 ("or2", (), (10, 3093), ()), ("or2", (), (13, 59), ()),
                 ("and2", (2887, 16), (), ()), ("and2", (56, 811), (), ()),
                 ("phrase2", (), (), (4, 22)), ("term", (), (578,), ())],
    ("mix", 1): [("term", (), (462,), ()), ("term", (), (669,), ()), ("term", (), (3726,), ()),
                 ("or2", (), (30, 15), ()), ("or2", (), (361, 218), ()),
                 ("and2", (736, 24), (), ()), ("and2", (4921, 10), (), ()),
                 ("phrase2", (), (), (135, 0)), ("term", (), (13,), ())],
    ("manyword", 0): [("or_many", (), (44, 1912, 32, 1669, 36, 1195, 355, 741, 59), ()),
                      ("or_many", (), (248, 1934, 286, 28, 17, 2638, 37, 1463), ()),
                      ("or_many", (), (16, 559, 1270, 822, 131, 65, 13), ()),
                      ("or_many", (), (12, 17, 13, 332, 250), ()),
                      ("must2_should2", (2428, 273), (47, 4991), ())],
    ("manyword", 1): [("or_many", (), (61, 69, 27, 44, 144, 978), ()),
                      ("or_many", (), (87, 75, 44, 41, 782, 12, 107), ()),
                      ("or_many", (), (36, 1374, 485, 1988, 589, 278, 16, 376, 11), ()),
                      ("or_many", (), (1842, 30, 16, 49, 253, 23, 20, 22, 856, 38), ()),
                      ("must2_should2", (266, 21), (454, 27), ())],
}
CORPUS = {"zipf1m": ([5, 0, 12, 6, 1, 297, 0, 6, 91, 87], 56013153, [0, 99, 167, 241])}
MIX_CONFIG = {"mix": "zipf1m", "manyword": "zipf1m"}


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for name in CORPUS:
        with open(os.path.join(CONFIGS, f"{name}.json")) as f:
            cfg = json.load(f)
        out[name] = corpus_mod.build({**cfg["corpus"], "docs": cfg["docs"]})
    return out


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_pinned(corpora, name):
    first, n_tokens, offsets = CORPUS[name]
    c = corpora[name]
    assert c.tokens[:10].tolist() == first
    assert len(c.tokens) == n_tokens == c.offsets[-1]
    assert c.offsets[:4].tolist() == offsets


@pytest.mark.parametrize("mix,seed", sorted(PINNED))
def test_traffic_pinned(corpora, mix, seed):
    tr = traffic.load(mix)
    rows = traffic.build_rows(tr, corpora[MIX_CONFIG[mix]], seed)
    want = PINNED[(mix, seed)]
    assert [tuple(r) for r in rows[:len(want)]] == want
    assert len(rows) == tr["queries_per_pass"]
    if mix == "manyword":  # rows of 3-10 terms: a pass repeats next to none
        assert len(set(rows)) >= len(rows) - 16


@pytest.mark.parametrize("mix", ("mix", "manyword"))
def test_seeds_send_the_same_classes_and_rank_mix(corpora, mix):
    """Every seed sends each class in the same places, and nearly the same
    multiset of term ranks (stratified draws)."""
    tr = traffic.load(mix)
    a = traffic.build_rows(tr, corpora["zipf1m"], 3)
    b = traffic.build_rows(tr, corpora["zipf1m"], 2**31 + 5)
    assert [r.cls for r in a] == [r.cls for r in b]
    ra = sorted(t for r in a for t in r.must + r.should)
    rb = sorted(t for r in b for t in r.must + r.should)
    if mix == "mix":
        assert len(ra) == len(rb)
    qa, qb = np.quantile(ra, [0.25, 0.5, 0.75]), np.quantile(rb, [0.25, 0.5, 0.75])
    assert np.all(np.abs(qa - qb) <= 0.1 * qa + 2)


def test_postings_bytes_hand_counted():
    """doc0 = w0 w1 w2 w1, doc1 = w1 w1 w3, doc2 = w2 w0 w1. Terms 0-3 have
    2 + 3 + 2 + 1 = 8 postings of 7 bytes (56); the phrase's terms w0 and
    w1 have 2 + 5 = 7 positions of 4 bytes (28); 3 rows write 10 hits of 8
    bytes (240)."""
    tokens = np.array([0, 1, 2, 1, 1, 1, 3, 2, 0, 1], np.int32)
    offsets = np.array([0, 4, 7, 10])
    index = bm25.Index(tokens, offsets, 4)
    rows = [Row("term", (), (1,), ()), Row("phrase2", (), (), (0, 1)), Row("and2", (2, 3), (), ())]
    assert batch_bytes(rows, 10, index, 3) == 56 + 28 + 240
    assert batch_bytes(rows[:1], 10, index, 1) == 7 + 80  # doc0 alone holds w1

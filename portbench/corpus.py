"""The Zipf corpus a configuration indexes: its dataset, fixed by the
configuration's corpus seed, as MS MARCO is fixed.

A frozen copy of the bench's generator (``rucene_tpu_torch/drivers/
workload.py`` ``zipf_vocab`` / ``build_corpus``): ``vocab`` words ``w0`` ..
``w{vocab-1}`` with Zipf probabilities ``1 / rank ** exponent``, each doc
``min_words`` to ``max_words`` words long. The same seed gives the same
token ids as the bench's generator, so the same texts.

The benchmark keeps the corpus as token ids (``Corpus``): the traffic
draws its phrases from them, the reference builds its postings from them,
and only the program is handed texts (``texts``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Corpus(NamedTuple):
    tokens: np.ndarray  # int32 [n_tokens]: every doc's word ids, doc after doc
    offsets: np.ndarray  # int64 [n_docs + 1]: doc d holds tokens[offsets[d]:offsets[d + 1]]
    probs: np.ndarray  # float64 [vocab]: each word's Zipf probability

    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1


def zipf_probs(vocab: int, exponent: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**exponent
    return probs / probs.sum()


def build(spec: dict) -> Corpus:
    """The corpus of a configuration's ``corpus`` block: ``docs``, ``vocab``,
    ``exponent``, ``min_words``, ``max_words`` (inclusive) and ``seed``."""
    rng = np.random.default_rng(spec["seed"])
    probs = zipf_probs(spec["vocab"], spec["exponent"])
    lengths = rng.integers(spec["min_words"], spec["max_words"] + 1, size=spec["docs"])
    tokens = rng.choice(spec["vocab"], size=int(lengths.sum()), p=probs).astype(np.int32)
    offsets = np.zeros(spec["docs"] + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return Corpus(tokens, offsets, probs)


def word(term_id: int) -> str:
    return f"w{term_id}"


def texts(corpus: Corpus, lo: int, hi: int) -> list[str]:
    """The texts of docs lo..hi-1, as the program indexes them."""
    vocab = np.array([word(i) for i in range(len(corpus.probs))], dtype=object)
    off = corpus.offsets
    return [" ".join(vocab[corpus.tokens[off[d]:off[d + 1]]]) for d in range(lo, hi)]

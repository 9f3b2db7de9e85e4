"""The plain reference: Lucene 6.2.1's BM25 over postings built from the
corpus's token ids, in numpy, with no code of the program.

- Norms: Lucene's ``SmallFloat.floatToByte315(1 / sqrt(length))`` per doc,
  decoded as ``1 / f**2`` (``BM25Similarity.NORM_TABLE``).
- Score of a term in a doc: ``idf * (k1 + 1) * tf / (tf + k1 * (1 - b + b *
  dl / avgdl))`` with ``idf = ln(1 + (docCount - df + 0.5) / (df + 0.5))``,
  ``avgdl = sumTotalTermFreq / docCount`` and ``dl`` the decoded norm;
  Lucene 6's coord and query norm are 1 under BM25.
- An exact phrase scores as one term whose tf is the number of positions
  where the phrase starts, and whose idf is the sum of its terms' idfs.
- A boolean row matches the docs that hold every required term, or, with
  none required, any optional one; its score is the sum of its matching
  clauses' scores. ``total_hits`` counts the matches.
- Answers are the top k by score descending, then doc ascending.

Statistics are those of the first ``n_docs`` docs: a searcher over a
writer's flushed segments holds a prefix of the corpus, in the order it
was added.

``precision="f64"`` is the reference. ``precision="bf16"`` is the control:
the same arithmetic with every value and every operation rounded to
bfloat16, the precision below the float32 that the configuration states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

K1 = 1.2
B = 0.75


def float_to_byte315(x) -> np.ndarray:
    """Lucene's SmallFloat.floatToByte315 of float32 values (3 mantissa bits,
    zero exponent 15)."""
    bits = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    small = bits >> 21
    lo = (63 - 15) << 3
    out = np.where(small <= lo, np.where(bits <= 0, 0, 1), small - lo)
    return np.where(small >= lo + 0x100, 255, out).astype(np.uint8)


def byte315_to_float(b) -> np.ndarray:
    b = np.asarray(b, np.int64)
    bits = ((b << 21) + ((63 - 15) << 24)).astype(np.uint32)
    return np.where(b == 0, 0.0, bits.view(np.float32).astype(np.float64))


def bf16(x) -> np.ndarray:
    """x rounded to the nearest bfloat16 (ties to even), as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


class Answer(NamedTuple):
    total: int  # docs that match
    docs: np.ndarray  # int64: the top k, score descending then doc ascending
    scores: np.ndarray  # float64: their scores
    match_docs: np.ndarray  # int64: every match, doc ascending
    match_scores: np.ndarray  # float64: their scores


class Index:
    """Postings of every term, built from the corpus: term -> its
    positions (ascending) and each position's doc."""

    def __init__(self, tokens: np.ndarray, offsets: np.ndarray, vocab: int):
        self.tokens = tokens
        self.offsets = offsets
        self.ptr = np.zeros(vocab + 1, np.int64)
        np.cumsum(np.bincount(tokens, minlength=vocab), out=self.ptr[1:])
        narrow = tokens.astype(np.uint16) if vocab <= 1 << 16 else tokens
        self.pos = np.argsort(narrow, kind="stable")  # a radix sort on 16-bit keys
        lengths = np.diff(offsets)
        self.pos_doc = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)[self.pos]
        norm = float_to_byte315(np.float32(1.0) / np.sqrt(lengths).astype(np.float32))
        f = byte315_to_float(np.arange(256))
        with np.errstate(divide="ignore"):
            self.norm_len = 1.0 / (f * f)  # decoded length of each norm byte
        self.dl = self.norm_len[norm]
        self._postings: dict = {}

    def _span(self, t: int, n_docs: int) -> tuple[int, int]:
        lo, hi = int(self.ptr[t]), int(self.ptr[t + 1])
        return lo, lo + int(np.searchsorted(self.pos[lo:hi], self.offsets[n_docs]))

    def postings(self, t: int, n_docs: int) -> tuple[np.ndarray, np.ndarray]:
        """(docs ascending, tf) of term t among the first n_docs docs."""
        got = self._postings.get((t, n_docs))
        if got is None:
            lo, hi = self._span(t, n_docs)
            docs = self.pos_doc[lo:hi]
            starts = np.flatnonzero(np.r_[len(docs) > 0, docs[1:] != docs[:-1]])
            tf = np.diff(np.r_[starts, len(docs)])
            got = self._postings[(t, n_docs)] = (docs[starts].astype(np.int64), tf)
        return got

    def total_term_freq(self, t: int, n_docs: int) -> int:
        lo, hi = self._span(t, n_docs)
        return hi - lo

    def phrase_postings(self, terms, n_docs: int) -> tuple[np.ndarray, np.ndarray]:
        """(docs ascending, phrase freq): the positions where the exact
        phrase starts, inside one doc, counted per doc."""
        lo, hi = self._span(terms[0], n_docs)
        p = self.pos[lo:hi]
        docs = self.pos_doc[lo:hi]
        ok = p + len(terms) <= self.offsets[docs.astype(np.int64) + 1]
        for i, t in enumerate(terms[1:], 1):
            ok &= self.tokens[np.minimum(p + i, len(self.tokens) - 1)] == t
        docs, freq = np.unique(docs[ok], return_counts=True)
        return docs.astype(np.int64), freq


class Scorer:
    """BM25 over the first ``n_docs`` docs of an Index, in f64 or bf16."""

    def __init__(self, index: Index, n_docs: int, precision: str = "f64"):
        self.index = index
        self.n_docs = n_docs
        self.r = bf16 if precision == "bf16" else (lambda v: np.asarray(v, np.float64))
        avgdl = float(index.offsets[n_docs]) / n_docs
        r = self.r
        self.k_norm = r(r(K1) * r(r(1 - B) + r(r(B) * r(index.dl[:n_docs]) / r(avgdl))))
        self._df: dict = {}

    def df(self, t: int) -> int:
        d = self._df.get(t)
        if d is None:
            d = self._df[t] = len(self.index.postings(t, self.n_docs)[0])
        return d

    def idf(self, t: int) -> float:
        n, df = self.n_docs, self.df(t)
        return float(self.r(np.log(1.0 + (n - df + 0.5) / (df + 0.5))))

    def _clause(self, docs, tf, idf):
        r = self.r
        w = r(r(idf) * r(K1 + 1))
        return r(r(w * r(tf)) / r(r(tf) + self.k_norm[docs]))

    def clause(self, t: int):
        docs, tf = self.index.postings(t, self.n_docs)
        return docs, self._clause(docs, tf, self.idf(t))

    def phrase(self, terms):
        docs, freq = self.index.phrase_postings(terms, self.n_docs)
        idf = 0.0
        for t in terms:
            idf = float(self.r(idf + self.idf(t)))
        return docs, self._clause(docs, freq, idf)

    def answer(self, row, k: int) -> Answer:
        """The reference's answer to a traffic Row at k."""
        if row.phrase:
            docs, scores = self.phrase(row.phrase)
            return top_k(docs, scores, k)
        n = self.n_docs
        acc = np.zeros(n)
        need = np.zeros(n, np.int32)
        seen = np.zeros(n, bool)
        for t in row.must + row.should:
            docs, s = self.clause(t)
            acc[docs] = self.r(acc[docs] + s)
            seen[docs] = True
            if t in row.must:
                need[docs] += 1
        match = need == len(row.must) if row.must else seen
        docs = np.flatnonzero(match & seen)
        return top_k(docs, acc[docs], k)


def top_k(docs: np.ndarray, scores: np.ndarray, k: int) -> Answer:
    """docs ascending with their scores -> the Answer at k."""
    sel = np.arange(len(docs))
    if len(docs) > k:
        kth = np.partition(-scores, k - 1)[k - 1]
        sel = np.flatnonzero(-scores <= kth)
    order = sel[np.lexsort((docs[sel], -scores[sel]))][:k]
    return Answer(len(docs), docs[order], scores[order], docs, scores)

"""The least bytes a batch's postings work needs, counted from its rows and
the corpus's own doc freqs and positions (the reference's postings), so
the same rows give the same count whatever serves them.

Each distinct term of the batch is read once, a posting at
``POSTING_BYTES``: a 4-byte doc id (docs run to 2^31), a 2-byte freq (a
doc's freq fits 16 bits: docs hold at most 104 words here) and the doc's
1-byte norm (Lucene's norm byte). Each distinct term of a phrase row adds
``POSITION_BYTES`` a position (a 4-byte position; every occurrence of the
term). Each row writes ``k`` hits of ``HIT_BYTES`` (a 4-byte doc and a
4-byte f32 score). Nothing else is counted: no dense [rows x docs] plane,
no doc-length table, no re-read of a posting another clause shares.
"""

from __future__ import annotations

POSTING_BYTES = 4 + 2 + 1
POSITION_BYTES = 4
HIT_BYTES = 4 + 4


def batch_bytes(rows, k: int, index, n_docs: int) -> int:
    """Bytes of one batch of traffic Rows over the first n_docs docs."""
    terms, phrase_terms = set(), set()
    for r in rows:
        terms.update(r.must, r.should, r.phrase)
        phrase_terms.update(r.phrase)
    n = sum(len(index.postings(t, n_docs)[0]) for t in terms) * POSTING_BYTES
    n += sum(index.total_term_freq(t, n_docs) for t in phrase_terms) * POSITION_BYTES
    return n + len(rows) * k * HIT_BYTES

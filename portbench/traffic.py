"""The one traffic generator: it reads a mix's parameters from
``portbench/traffic/<name>.json`` and draws one pass of query rows from
``--seed``.

A mix file holds:

- ``loop``: the serving loop that drives the rows (``portbench/loops/
  <loop>.py``), and that loop's own parameters (``batch``, ``k``,
  ``in_flight``, ``warm_batches``);
- ``queries_per_pass``: rows a pass, all drawn anew; the loop serves the
  pass from its start and wraps round only once the pass is spent, so a
  pass longer than a window's rows repeats no row within the window;
- ``band``: ``[lo, hi)``, the word ranks that term clauses draw from,
  each weighted by its Zipf probability (the bench's band, 10-4,999);
- ``classes``: the row classes, each with ``share`` (rows of a period of
  ``sum(shares)``), ``must`` (required terms), ``should`` (``[lo, hi]``
  optional terms, the count drawn per row) or ``phrase`` (an exact phrase
  of that many consecutive words of a corpus doc);
- ``sample_rows``: rows of the window whose answers the reference checks.

Row i takes class ``period[i % len(period)]``, where the period lists each
class ``share`` times in file order, so every seed sends the same classes in
the same places. The seed draws everything else: the optional-term counts,
the terms and the phrases. Term draws are stratified over the band's
probability mass (one uniform in each of D equal strata, strata shuffled),
so every seed's pass holds nearly the same multiset of term ranks, in
another order; a term repeated within a row is swapped with the next draw
that the row lacks. Phrases are consecutive words at a uniform doc and
position of the corpus (as the bench's ``sample_bigrams`` draws them).

A row is plain data (``Row``); ``to_queries`` turns rows into the
program's query objects, a row of one optional term and nothing else into
a ``TermQuery``, as the bench's mix sends it.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from portbench.corpus import Corpus, word

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


class Row(NamedTuple):
    cls: str
    must: tuple  # term ids, required
    should: tuple  # term ids, optional
    phrase: tuple  # term ids of an exact phrase (a row with a phrase has no terms)


def load(name: str, directory: str = TRAFFIC_DIR) -> dict:
    with open(os.path.join(directory, f"{name}.json")) as f:
        return json.load(f)


def period(traffic: dict) -> list[dict]:
    return [c for c in traffic["classes"] for _ in range(c["share"])]


def build_rows(traffic: dict, corpus: Corpus, seed: int) -> list[Row]:
    """One pass of ``traffic["queries_per_pass"]`` rows drawn from seed."""
    rng = np.random.default_rng(seed % 2**63)
    per = period(traffic)
    n = traffic["queries_per_pass"]
    kinds = [per[i % len(per)] for i in range(n)]
    n_terms = []
    for c in kinds:
        lo, hi = c.get("should", [0, 0])
        n_terms.append((c.get("must", 0), int(rng.integers(lo, hi + 1))))
    lo, hi = traffic["band"]
    band = np.arange(lo, min(hi, len(corpus.probs)))
    cdf = np.cumsum(corpus.probs[band])
    cdf /= cdf[-1]
    total = sum(m + s for m, s in n_terms)
    u = (rng.permutation(total) + rng.random(total)) / total
    draws = band[np.minimum(np.searchsorted(cdf, u, side="right"), len(band) - 1)].tolist()
    rows = []
    at = 0
    for c, (n_must, n_should) in zip(kinds, n_terms):
        if "phrase" in c:
            rows.append(Row(c["name"], (), (), _phrase(corpus, rng, c["phrase"])))
            continue
        picked: list = []
        for _ in range(n_must + n_should):
            j = at
            while j < len(draws) and draws[j] in picked:
                j += 1
            while j == len(draws):  # every later draw is in the row: draw afresh
                t = int(band[min(np.searchsorted(cdf, rng.random(), side="right"), len(band) - 1)])
                if t not in picked:
                    draws.append(t)
            draws[at], draws[j] = draws[j], draws[at]
            picked.append(draws[at])
            at += 1
        rows.append(Row(c["name"], tuple(picked[:n_must]), tuple(picked[n_must:]), ()))
    return rows


def _phrase(corpus: Corpus, rng, length: int) -> tuple:
    off = corpus.offsets
    while True:
        d = int(rng.integers(0, corpus.n_docs))
        n = int(off[d + 1] - off[d])
        if n >= length:
            j = int(off[d]) + int(rng.integers(0, n - length + 1))
            return tuple(int(t) for t in corpus.tokens[j:j + length])


def to_queries(rows, field: str):
    """The program's query objects for ``rows`` (new objects each call)."""
    from rucene_tpu_torch import BooleanQuery, PhraseQuery, Term, TermQuery

    out = []
    for r in rows:
        if r.phrase:
            out.append(PhraseQuery(field, [word(t) for t in r.phrase]))
        elif not r.must and len(r.should) == 1:
            out.append(TermQuery(Term(field, word(r.should[0]))))
        else:
            q = BooleanQuery()
            for t in r.must:
                q.must(TermQuery(Term(field, word(t))))
            for t in r.should:
                q.should(TermQuery(Term(field, word(t))))
            out.append(q)
    return out

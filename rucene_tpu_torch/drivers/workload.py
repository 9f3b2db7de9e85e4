"""The bench's corpus, query mix and index cache (counterpart of bench.py's
builders, lines 38-246).

- ``zipf_vocab`` / ``build_corpus``: the synthetic Zipf corpus (20,000
  words, exponent 1.1, 8-63 words a doc, seed 7);
- ``build_corpus_pytext``: passages of real English text harvested from
  the installed Python packages' sources;
- ``sample_bigrams`` / ``build_queries``: the mix, 3/8 single-term, 2/8
  two-term OR, 2/8 two-term AND from the mid-frequency band and 1/8
  two-term exact phrases drawn from corpus text (seed 13);
- ``pack_corpus``: texts -> SegmentBuffer -> pack_segment, the body field
  alone as bench.py packs it, or with the filter, sort and group fields
  of chip_smoke.py's phases 10-14 (``fields_seed``);
- ``cache_segment`` / ``default_docs``: the on-disk bench cache
  (``bench-<corpus>-<docs>.seg``). Both packages write byte-identical
  segment files, so either package's cache serves either package.

The same seeds give the same texts, vocabulary and rows as bench.py's
(tests/test_torch_drivers.py holds them equal).
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import sysconfig
from collections import Counter

import numpy as np

YEAR_S = 365 * 86400  # the ts field holds a second of one year
MONTH_S = YEAR_S // 12  # the ``month`` doc value is ts // MONTH_S
N_GROUPS = 10_000  # grp: luceneutil's TermGroup10K


def zipf_vocab(vocab_size: int = 20000):
    """The analytic Zipf unigram model the synthetic corpus draws from:
    query construction needs only this, not the text."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    vocab = np.array([f"w{i}" for i in range(vocab_size)])
    return vocab, probs


def build_corpus(n_docs: int, vocab_size: int = 20000, seed: int = 7):
    rng = np.random.default_rng(seed)
    vocab, probs = zipf_vocab(vocab_size)
    lengths = rng.integers(8, 64, size=n_docs)
    token_ids = rng.choice(vocab_size, size=int(lengths.sum()), p=probs)
    texts = []
    off = 0
    for n in lengths:
        texts.append(" ".join(vocab[token_ids[off : off + n]]))
        off += n
    return texts, vocab, probs


def build_corpus_pytext(n_docs: int, seed: int = 7):
    """Real-text corpus: passages of 15-60 lowercased words from the
    docstrings, comments and identifiers of the installed Python packages,
    wrapped around when they run out; vocabulary and unigram probabilities
    measured from the text, so query sampling works as on the Zipf
    corpus."""
    rng = np.random.default_rng(seed)
    word_re = re.compile(r"[a-zA-Z][a-zA-Z0-9_]{1,30}")
    texts: list[str] = []
    cur: list[str] = []
    roots = [
        p for p in sys.path if p.endswith("site-packages") or p.endswith("dist-packages")
    ] or [sysconfig.get_paths()["purelib"]]

    def py_files():  # lazy walk: stops as soon as enough text is harvested
        for r in roots:
            for dirpath, dirnames, filenames in os.walk(r):
                dirnames.sort()
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)

    target_len = int(rng.integers(15, 60))
    for path in py_files():
        try:
            with open(path, errors="ignore") as f:
                data = f.read()
        except OSError:
            continue
        for w in word_re.findall(data):
            cur.append(w.lower())
            if len(cur) >= target_len:
                texts.append(" ".join(cur))
                cur = []
                target_len = int(rng.integers(15, 60))
                if len(texts) >= n_docs:
                    break
        if len(texts) >= n_docs:
            break
    if len(texts) < n_docs:  # wrap around for very large corpora
        base = list(texts)
        while len(texts) < n_docs and base:
            texts.append(base[len(texts) % len(base)])
    counts: Counter = Counter()
    for t in texts[:: max(1, len(texts) // 200_000)]:
        counts.update(t.split())
    vocab_counts = counts.most_common()
    vocab = np.array([w for w, _ in vocab_counts])
    freqs = np.array([c for _, c in vocab_counts], np.float64)
    return texts, vocab, freqs / freqs.sum()


def sample_bigrams(texts, n: int, seed: int = 77) -> list[tuple[str, str]]:
    """Consecutive word pairs for phrase queries, drawn from corpus text."""
    rng = np.random.default_rng(seed)
    out = []
    if not texts:
        return out
    for _ in range(n * 4):
        words = texts[int(rng.integers(0, len(texts)))].split()
        if len(words) < 2:
            continue
        j = int(rng.integers(0, len(words) - 1))
        out.append((words[j], words[j + 1]))
        if len(out) >= n:
            break
    return out


def build_queries(n_queries: int, vocab, probs, seed: int = 13, phrase_texts=None):
    """The mix: 3/8 single-term, 2/8 two-term OR, 2/8 two-term AND from
    the mid-frequency band (ranks 10-4999), and 1/8 two-term exact phrases
    drawn from phrase_texts (without phrase texts, AND rows take their
    place)."""
    from rucene_tpu_torch import BooleanQuery, PhraseQuery, Term, TermQuery

    rng = np.random.default_rng(seed)
    band = np.arange(10, min(5000, len(vocab)))
    band_p = probs[band] / probs[band].sum()
    bigrams = sample_bigrams(phrase_texts or [], (n_queries + 7) // 8)
    queries = []
    bi = 0
    for i in range(n_queries):
        kind = i % 8
        t1 = vocab[rng.choice(band, p=band_p)]
        t2 = vocab[rng.choice(band, p=band_p)]
        if kind == 7 and bigrams:
            w1, w2 = bigrams[bi % len(bigrams)]
            bi += 1
            queries.append(PhraseQuery("body", [w1, w2]))
        elif kind in (0, 1, 2):
            queries.append(TermQuery(Term("body", t1)))
        elif kind in (3, 4):
            q = BooleanQuery()
            q.should(TermQuery(Term("body", t1)))
            q.should(TermQuery(Term("body", t2)))
            queries.append(q)
        else:
            q = BooleanQuery()
            q.must(TermQuery(Term("body", t1)))
            q.must(TermQuery(Term("body", t2)))
            queries.append(q)
    return queries


def pack_corpus(texts, log=lambda m: None, fields_seed: int | None = None):
    """The packed segment of ``texts`` in ``body`` (the C++ inverter, one
    bulk add). fields_seed=None packs the body alone, as bench.py does.
    With a seed each doc also gets an IntPoint ``ts`` (a second of one
    year, uniform) and, on one doc in 4, a StringField ``tag`` (c000-c999,
    uniform), the time and category a content search filters by, and the
    numeric doc values ``ts``, ``month`` (ts // MONTH_S) and ``grp``
    (uniform 0-9,999, drawn after the others, so the earlier fields keep
    their values), all drawn from that seed."""
    from rucene_tpu_torch import Document, IntPoint, NumericDocValuesField, StringField, TextField
    from rucene_tpu_torch.codec.postings import pack_segment
    from rucene_tpu_torch.index.memory import SegmentBuffer

    if fields_seed is not None:
        rng = np.random.default_rng(fields_seed)
        ts = rng.integers(0, YEAR_S, len(texts)).tolist()
        tag = rng.integers(0, 1000, len(texts)).tolist()
        tagged = (rng.random(len(texts)) < 0.25).tolist()
        grp = rng.integers(0, N_GROUPS, len(texts)).tolist()
    buf = SegmentBuffer()
    docs = []
    for i, t in enumerate(texts):
        d = Document()
        d.add(TextField("body", t))
        if fields_seed is not None:
            d.add(IntPoint("ts", ts[i]))
            if tagged[i]:
                d.add(StringField("tag", f"c{tag[i]:03d}"))
            d.add(NumericDocValuesField("ts", ts[i]))
            d.add(NumericDocValuesField("month", ts[i] // MONTH_S))
            d.add(NumericDocValuesField("grp", grp[i]))
        docs.append(d)
    buf.add_documents_bulk(docs)
    del docs
    log("inverted")
    packed = pack_segment(buf.finish())
    log("packed")
    return packed


def segment_name(corpus_kind: str, n_docs: int) -> str:
    return f"bench-{corpus_kind}-{n_docs}"


def cache_segment(cache_dir: str, seg_name: str, packed) -> None:
    """Publish a packed index into the bench cache atomically: write it
    under its final name in a temporary subdirectory (the file's header
    holds its name, so a temporary name would fail the read-side check),
    then os.replace it into place. An interrupted build never leaves a
    torn .seg that a later run would take as valid."""
    from rucene_tpu_torch.codec import files as segfiles
    from rucene_tpu_torch.store.directory import FSDirectory

    fname = segfiles.segment_file(seg_name)
    tmp_dir = os.path.join(cache_dir, f".tmp-{os.getpid()}")
    os.makedirs(tmp_dir, exist_ok=True)
    try:
        segfiles.write_segment(FSDirectory(tmp_dir), seg_name, packed)
        os.replace(os.path.join(tmp_dir, fname), os.path.join(cache_dir, fname))
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def default_docs(cache_dir: str | None, corpus_kind: str) -> int:
    """The largest cached corpus of at most 1M docs, else 50,000."""
    best = 0
    if cache_dir and os.path.isdir(cache_dir):
        for fn in os.listdir(cache_dir):
            m = re.fullmatch(rf"bench-{corpus_kind}-(\d+)\.seg", fn)
            if m and int(m.group(1)) <= 1_000_000:
                best = max(best, int(m.group(1)))
    return best or 50000

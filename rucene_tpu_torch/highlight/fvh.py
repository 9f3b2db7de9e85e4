"""FastVectorHighlighter: term-vector-driven snippet extraction.

reference: rucene src/core/highlight/fvh_highlighter.rs:33
(FastVectorHighlighter), mod.rs:503 (FieldQuery), :673 (FieldTermStack),
:822 (FieldPhraseList), frag_list_builder.rs (SimpleFragListBuilder),
fragments_builder.rs (BaseFragmentsBuilder).

Pipeline (same stages as the reference):
  FieldQuery      : query -> the terms/phrases to highlight per field
  FieldTermStack  : doc's term vector filtered to query terms, by position
  FieldPhraseList : match single terms + consecutive phrase runs -> weighted
                    char spans
  frag list       : greedy windows of frag_char_size covering the spans
  fragments       : stored text + <b>...</b> (or custom tags) around spans
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from rucene_tpu_torch.index.reader import IndexReader
from rucene_tpu_torch.search.query import Query


@dataclass
class _PhraseMatch:
    start: int  # char offsets
    end: int
    boost: float


@dataclass
class FieldQuery:
    """Terms and phrase sequences to highlight, per field
    (reference highlight/mod.rs:503)."""

    terms: dict[str, dict[str, float]] = dc_field(default_factory=dict)  # field->term->boost
    phrases: dict[str, list[tuple[list[str], float]]] = dc_field(default_factory=dict)

    @staticmethod
    def build(query: Query, field_match: bool = True) -> "FieldQuery":
        fq = FieldQuery()
        rq = query.rewrite()
        for c in rq.clauses:
            if c.occur == 3:  # MUST_NOT never highlights
                continue
            fq.terms.setdefault(c.term.field, {})[c.term.text] = max(
                c.boost, fq.terms.get(c.term.field, {}).get(c.term.text, 0.0)
            )
        for _, members in rq.groups:
            for c in members:
                fq.terms.setdefault(c.term.field, {})[c.term.text] = max(
                    c.boost, fq.terms.get(c.term.field, {}).get(c.term.text, 0.0)
                )
        for f, terms, boost, _slop in rq.phrases:
            if any(t is None for t in terms):
                # gapped phrase (positional holes): highlight the real
                # terms individually — fragment scoring still sees them
                for t in terms:
                    if t is not None:
                        fq.terms.setdefault(f, {})[t] = max(
                            boost, fq.terms.get(f, {}).get(t, 0.0)
                        )
                continue
            fq.phrases.setdefault(f, []).append((terms, boost))
            for t in terms:
                fq.terms.setdefault(f, {}).setdefault(t, 0.0)
        return fq


class SimpleBoundaryScanner:
    """Moves fragment edges to natural boundaries so snippets never cut
    mid-word (reference highlight/mod.rs:1062 SimpleBoundaryScanner:
    DEFAULT_MAX_SCAN=20, DEFAULT_BOUNDARY_CHARS)."""

    BOUNDARY_CHARS = frozenset(".,!? \t\n")

    def __init__(self, max_scan: int = 20, boundary_chars=None):
        self.max_scan = max_scan
        self.chars = (
            frozenset(boundary_chars) if boundary_chars is not None
            else self.BOUNDARY_CHARS
        )

    def find_start(self, text: str, start: int) -> int:
        """Scan BACKWARD from start for a boundary char; the fragment
        begins just after it. No boundary within max_scan -> start."""
        if start <= 0:
            return 0
        lo = max(0, start - self.max_scan)
        for i in range(start, lo - 1, -1):
            if i > 0 and text[i - 1] in self.chars:
                return i
        return start

    def find_end(self, text: str, end: int) -> int:
        """Scan FORWARD from end for a boundary char; the fragment ends on
        it. No boundary within max_scan -> end."""
        n = len(text)
        if end >= n:
            return n
        hi = min(n, end + self.max_scan)
        for i in range(end, hi):
            if text[i] in self.chars:
                return i
        return end


class FastVectorHighlighter:
    def __init__(
        self,
        phrase_highlight: bool = True,
        field_match: bool = True,
        phrase_limit: int = 256,
        boundary_scanner: SimpleBoundaryScanner | None = None,
    ):
        self.phrase_highlight = phrase_highlight
        self.field_match = field_match
        self.phrase_limit = phrase_limit
        self.boundary_scanner = boundary_scanner or SimpleBoundaryScanner()

    def get_best_fragments(
        self,
        field_query: FieldQuery,
        reader: IndexReader,
        doc_id: int,
        field_name: str,
        stored_field: str | None = None,
        frag_char_size: int = 100,
        max_num_fragments: int = 3,
        pre_tag: str = "<b>",
        post_tag: str = "</b>",
        score_order: bool = True,
    ) -> list[str]:
        stored_field = stored_field or field_name
        leaf = None
        for lf in reversed(reader.leaves):
            if doc_id >= lf.doc_base:
                leaf = lf
                break
        if leaf is None:
            return []
        local = doc_id - leaf.doc_base
        tv = leaf.term_vector(local, field_name)
        if tv is None:
            return []
        text = leaf.document(local).get(stored_field)
        if isinstance(text, list):
            # multi-valued stored field: indexing accumulates offsets with
            # a 1-char gap as if the values were space-joined
            # (index/memory.py char_base) — join the same way so term
            # vector offsets line up with the display text
            if not all(isinstance(v, str) for v in text):
                return []
            text = " ".join(text)
        if not isinstance(text, str):
            return []

        matches = self._phrase_list(field_query, field_name, tv)
        if not matches:
            return []
        frags = self._frag_list(matches, frag_char_size, len(text))
        if score_order:
            frags.sort(key=lambda f: -f[2])
        out = []
        bs = self.boundary_scanner
        for fstart, fend, _score, spans in frags[:max_num_fragments]:
            # snap edges to boundaries without cutting into any span
            fstart = min(bs.find_start(text, fstart), spans[0][0])
            fend = max(bs.find_end(text, fend), spans[-1][1])
            out.append(self._build_fragment(text, fstart, fend, spans, pre_tag, post_tag))
        return out

    # --- FieldTermStack + FieldPhraseList ---
    def _phrase_list(self, fq: FieldQuery, field: str, tv: dict) -> list[_PhraseMatch]:
        q_terms = fq.terms.get(field, {})
        if not q_terms:
            return []
        # position -> (term, start, end) for query terms only
        stack: dict[int, tuple[str, int, int]] = {}
        for term, occs in tv.items():
            if term in q_terms:
                for pos, start, end in occs:
                    stack[pos] = (term, start, end)

        matches: list[_PhraseMatch] = []
        used_positions: set[int] = set()
        # phrases first (longest-match semantics like the reference)
        if self.phrase_highlight:
            for terms, boost in fq.phrases.get(field, []):
                n = len(terms)
                for pos, (t0, s0, _e0) in sorted(stack.items()):
                    if t0 != terms[0] or pos in used_positions:
                        continue
                    ok = True
                    for j in range(1, n):
                        nxt = stack.get(pos + j)
                        if nxt is None or nxt[0] != terms[j]:
                            ok = False
                            break
                    if ok:
                        last = stack[pos + n - 1]
                        matches.append(_PhraseMatch(s0, last[2], boost * n))
                        used_positions.update(range(pos, pos + n))
                        if len(matches) >= self.phrase_limit:
                            return matches
        # then single terms with a positive boost (phrase-only terms have 0)
        for pos, (term, start, end) in sorted(stack.items()):
            if pos in used_positions:
                continue
            boost = q_terms.get(term, 0.0)
            if boost > 0:
                matches.append(_PhraseMatch(start, end, boost))
                if len(matches) >= self.phrase_limit:
                    break
        matches.sort(key=lambda m: m.start)
        return matches

    # --- SimpleFragListBuilder ---
    def _frag_list(self, matches: list[_PhraseMatch], frag_size: int, text_len: int):
        frags = []
        i = 0
        while i < len(matches):
            window_start = max(0, matches[i].start - max(0, (frag_size - (matches[i].end - matches[i].start)) // 4))
            window_end = min(text_len, window_start + frag_size)
            spans = []
            score = 0.0
            while i < len(matches) and matches[i].end <= window_end:
                spans.append((matches[i].start, matches[i].end))
                score += matches[i].boost
                i += 1
            if not spans:  # match longer than the window: take it whole
                spans = [(matches[i].start, matches[i].end)]
                window_end = matches[i].end
                score += matches[i].boost
                i += 1
            frags.append((window_start, window_end, score, spans))
        return frags

    # --- BaseFragmentsBuilder ---
    def _build_fragment(self, text, fstart, fend, spans, pre, post) -> str:
        out = []
        cur = fstart
        for s, e in spans:
            s, e = max(s, fstart), min(e, fend)
            out.append(text[cur:s])
            out.append(pre)
            out.append(text[s:e])
            out.append(post)
            cur = e
        out.append(text[cur:fend])
        return "".join(out)

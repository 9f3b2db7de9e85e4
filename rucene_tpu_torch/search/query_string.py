"""Mini query-string parser (reference: rucene src/core/search/query/
query_string.rs:28, QueryStringQueryBuilder — an ES-style subset).

Grammar:
  expr     := or_expr
  or_expr  := and_expr (OR and_expr)*
  and_expr := unary (AND unary)*
  unary    := [+|-] atom
  atom     := '(' expr ')' | '"' phrase '"' | [field:]token | [field:]'"'...'"'
              | [field:][lower TO upper] range

'+term' => MUST, '-term' / 'NOT term' => MUST_NOT, bare terms => SHOULD
(unless joined by AND, which promotes both sides to MUST).
"""

from __future__ import annotations

import re

from rucene_tpu_torch.doc.term import Term
from rucene_tpu_torch.search.query import (
    BooleanQuery,
    Occur,
    PhraseQuery,
    PointRangeQuery,
    Query,
    TermQuery,
)

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<lparen>\() |
        (?P<rparen>\)) |
        (?P<and>AND\b) |
        (?P<or>OR\b) |
        (?P<not>NOT\b) |
        (?P<plus>\+) |
        (?P<minus>-) |
        (?P<phrase>(?:(?P<pfield>[\w.]+):)?"(?P<ptext>[^"]*)"
                   (?:~(?P<pslop>\d+))?(?:\^(?P<pboost>[\d.]+))?) |
        (?P<range>(?:(?P<rfield>[\w.]+):)?\[(?P<lo>[^\s\]]+)\s+TO\s+(?P<hi>[^\s\]]+)\]) |
        (?P<term>(?:(?P<tfield>[\w.]+):)?(?P<ttext>[^\s()+\-"^~][^\s()"^]*)
                 (?:\^(?P<tboost>[\d.]+))?)
    )""",
    re.VERBOSE,
)


class QueryStringParser:
    def __init__(self, query: str, default_field: str = "body", lowercase: bool = True):
        self.tokens = self._lex(query)
        self.pos = 0
        self.default_field = default_field
        self.lowercase = lowercase

    def _lex(self, s: str):
        out = []
        i = 0
        while i < len(s):
            m = _TOKEN_RE.match(s, i)
            if m is None or m.end() == i:
                if s[i:].strip():
                    raise ValueError(f"query syntax error at: {s[i:]!r}")
                break
            out.append(m)
            i = m.end()
        return out

    def _peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def _next(self):
        tok = self._peek()
        if tok is not None:
            self.pos += 1
        return tok

    def parse(self) -> Query:
        q = self._or_expr()
        if self._peek() is not None:
            raise ValueError("trailing tokens in query string")
        return q

    def _or_expr(self) -> Query:
        parts = [self._and_expr()]
        while (tok := self._peek()) is not None and tok.lastgroup != "rparen":
            if tok.group("or"):
                self._next()
                parts.append(self._and_expr())
            else:
                parts.append(self._and_expr())  # bare adjacency = OR/SHOULD
        if len(parts) == 1 and not isinstance(parts[0], _Signed):
            return parts[0]
        bq = BooleanQuery()
        for p in parts:
            if isinstance(p, _Signed):
                bq.add(p.query, p.occur)
            else:
                bq.should(p)
        return bq

    def _and_expr(self) -> Query:
        parts = [self._unary()]
        while (tok := self._peek()) is not None and tok.group("and"):
            self._next()
            parts.append(self._unary())
        if len(parts) == 1:
            p = parts[0]
            return p
        bq = BooleanQuery()
        for p in parts:
            if isinstance(p, _Signed):
                bq.add(p.query, Occur.MUST_NOT if p.occur == Occur.MUST_NOT else Occur.MUST)
            else:
                bq.must(p)
        return bq

    def _unary(self):
        tok = self._peek()
        if tok is None:
            raise ValueError("unexpected end of query string")
        if tok.group("plus"):
            self._next()
            return _Signed(Occur.MUST, self._atom())
        if tok.group("minus") or tok.group("not"):  # NOT x == -x
            self._next()
            return _Signed(Occur.MUST_NOT, self._atom())
        return self._atom()

    def _atom(self) -> Query:
        tok = self._next()
        if tok is None:
            raise ValueError("unexpected end of query string")
        if tok.group("lparen"):
            q = self._or_expr()
            close = self._next()
            if close is None or not close.group("rparen"):
                raise ValueError("missing closing paren")
            return q
        if tok.group("phrase"):
            field = tok.group("pfield") or self.default_field
            text = tok.group("ptext")
            words = text.lower().split() if self.lowercase else text.split()
            boost = float(tok.group("pboost") or 1.0)
            slop = int(tok.group("pslop") or 0)  # "a b"~2 (query_string.rs:184)
            if len(words) == 1:
                return TermQuery(Term(field, words[0]), boost=boost)
            return PhraseQuery(field, words, boost=boost, slop=slop)
        if tok.group("range"):
            field = tok.group("rfield") or self.default_field
            lo, hi = tok.group("lo"), tok.group("hi")
            parse_b = lambda s: None if s == "*" else (float(s) if "." in s else int(s))
            return PointRangeQuery(field, parse_b(lo), parse_b(hi))
        if tok.group("term"):
            field = tok.group("tfield") or self.default_field
            text = tok.group("ttext")
            if self.lowercase:
                text = text.lower()
            boost = float(tok.group("tboost") or 1.0)  # term^2 (query_string.rs:199)
            if field == "_exists_":  # ES syntax (query_string.rs field_or_exists)
                from rucene_tpu_torch.search.query import ExistsQuery

                return ExistsQuery(tok.group("ttext"), boost=boost)
            if text.endswith("*") and len(text) > 1 and "*" not in text[:-1]:
                from rucene_tpu_torch.search.query import PrefixQuery

                return PrefixQuery(field, text[:-1], boost=boost)
            return TermQuery(Term(field, text), boost=boost)
        raise ValueError(f"unexpected token {tok.group()!r}")


class _Signed:
    def __init__(self, occur: Occur, query: Query):
        self.occur = occur
        self.query = query


def parse_query_string(s: str, default_field: str = "body", lowercase: bool = True) -> Query:
    return QueryStringParser(s, default_field, lowercase).parse()

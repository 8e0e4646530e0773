"""Predicate / expression parser (the port's own copy of
``delta_tpu.expr.parser``): the same tokenizer, grammar and trees, so a SQL
string parses to the same expression in both packages.

Grammar (precedence climbing, low -> high):
    OR < AND < NOT < comparison (= == != <> < <= > >= <=> IS IN BETWEEN LIKE)
    < additive (+ -) < multiplicative (* / %) < unary (- +) < primary
    (literal, column, CAST, CASE, function call, parenthesised expression)
"""
from __future__ import annotations

import re
from typing import List, Optional

from delta_tpu_torch.expr import ir
from delta_tpu_torch.schema.types import parse_data_type
from delta_tpu_torch.utils import errors

__all__ = ["parse_expression", "parse_predicate"]

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?[LlDd]?)
  | (?P<str>'(?:[^']|'')*'|"(?:[^"]|"")*")
  | (?P<bq>`(?:[^`]|``)+`)
  | (?P<op><=>|==|!=|<>|<=|>=|<|>|=|\+|-|\*|/|%|\(|\)|,|\.)
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "AND", "OR", "NOT", "IN", "IS", "NULL", "TRUE", "FALSE", "BETWEEN",
    "LIKE", "CAST", "AS", "CASE", "WHEN", "THEN", "ELSE", "END",
}


class _Tok:
    def __init__(self, kind: str, text: str):
        self.kind = kind  # num | str | id | kw | op | bq
        self.text = text

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def _tokenize(s: str) -> List[_Tok]:
    out: List[_Tok] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise errors.cannot_tokenize_predicate(s[pos:pos+20])
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        kind = m.lastgroup
        if kind == "id" and text.upper() in _KEYWORDS:
            out.append(_Tok("kw", text.upper()))
        else:
            out.append(_Tok(kind, text))
    return out


class _Parser:
    def __init__(self, tokens: List[_Tok], source: str):
        self.toks = tokens
        self.i = 0
        self.source = source

    def peek(self, k: int = 0) -> Optional[_Tok]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise errors.unexpected_end_of_expression(self.source)
        self.i += 1
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[_Tok]:
        t = self.peek()
        if t and t.kind == kind and (text is None or t.text == text):
            self.i += 1
            return t
        return None

    def expect(self, kind: str, text: Optional[str] = None) -> _Tok:
        t = self.accept(kind, text)
        if t is None:
            raise errors.parse_expected(text or kind, self.peek(), self.source)
        return t

    def parse(self) -> ir.Expression:
        e = self.parse_or()
        if self.peek() is not None:
            raise errors.trailing_tokens(self.peek(), self.source)
        return e

    def parse_or(self) -> ir.Expression:
        left = self.parse_and()
        while self.accept("kw", "OR"):
            left = ir.Or(left, self.parse_and())
        return left

    def parse_and(self) -> ir.Expression:
        left = self.parse_not()
        while self.accept("kw", "AND"):
            left = ir.And(left, self.parse_not())
        return left

    def parse_not(self) -> ir.Expression:
        if self.accept("kw", "NOT"):
            return ir.Not(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ir.Expression:
        left = self.parse_additive()
        t = self.peek()
        if t is None:
            return left
        if t.kind == "op" and t.text in ("=", "==", "!=", "<>", "<", "<=", ">", ">=", "<=>"):
            self.next()
            right = self.parse_additive()
            return {
                "=": ir.Eq, "==": ir.Eq, "!=": ir.Ne, "<>": ir.Ne,
                "<": ir.Lt, "<=": ir.Le, ">": ir.Gt, ">=": ir.Ge,
                "<=>": ir.NullSafeEq,
            }[t.text](left, right)
        if t.kind == "kw" and t.text == "IS":
            self.next()
            negate = self.accept("kw", "NOT") is not None
            self.expect("kw", "NULL")
            return ir.IsNotNull(left) if negate else ir.IsNull(left)
        negate = False
        if t.kind == "kw" and t.text == "NOT" and self.peek(1) and self.peek(1).kind == "kw" \
                and self.peek(1).text in ("IN", "BETWEEN", "LIKE"):
            self.next()
            negate = True
            t = self.peek()
        if t and t.kind == "kw" and t.text == "IN":
            self.next()
            self.expect("op", "(")
            opts = [self.parse_additive()]
            while self.accept("op", ","):
                opts.append(self.parse_additive())
            self.expect("op", ")")
            e: ir.Expression = ir.In(left, opts)
            return ir.Not(e) if negate else e
        if t and t.kind == "kw" and t.text == "BETWEEN":
            self.next()
            lo = self.parse_additive()
            self.expect("kw", "AND")
            hi = self.parse_additive()
            e = ir.And(ir.Ge(left, lo), ir.Le(left, hi))
            return ir.Not(e) if negate else e
        if t and t.kind == "kw" and t.text == "LIKE":
            self.next()
            e = ir.Like(left, self.parse_additive())
            return ir.Not(e) if negate else e
        return left

    def parse_additive(self) -> ir.Expression:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("+", "-"):
                self.next()
                right = self.parse_multiplicative()
                left = (ir.Add if t.text == "+" else ir.Sub)(left, right)
            else:
                return left

    def parse_multiplicative(self) -> ir.Expression:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("*", "/", "%"):
                self.next()
                right = self.parse_unary()
                left = {"*": ir.Mul, "/": ir.Div, "%": ir.Mod}[t.text](left, right)
            else:
                return left

    def parse_unary(self) -> ir.Expression:
        if self.accept("op", "-"):
            return ir.Neg(self.parse_unary())
        if self.accept("op", "+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> ir.Expression:
        t = self.next()
        if t.kind == "num":
            text = t.text
            if text[-1] in "LlDd" and not text[-1].isdigit():
                suffix, text = text[-1].lower(), text[:-1]
                return ir.Literal(int(text) if suffix == "l" else float(text))
            if "." in text or "e" in text.lower():
                return ir.Literal(float(text))
            return ir.Literal(int(text))
        if t.kind == "str":
            q = t.text[0]
            return ir.Literal(t.text[1:-1].replace(q * 2, q))
        if t.kind == "kw":
            if t.text == "NULL":
                return ir.Literal(None)
            if t.text == "TRUE":
                return ir.Literal(True)
            if t.text == "FALSE":
                return ir.Literal(False)
            if t.text == "CAST":
                self.expect("op", "(")
                e = self.parse_or()
                self.expect("kw", "AS")
                type_name = self._parse_type_name()
                self.expect("op", ")")
                return ir.Cast(e, parse_data_type(type_name))
            if t.text == "CASE":
                branches = []
                while self.accept("kw", "WHEN"):
                    c = self.parse_or()
                    self.expect("kw", "THEN")
                    v = self.parse_or()
                    branches.append((c, v))
                default = None
                if self.accept("kw", "ELSE"):
                    default = self.parse_or()
                self.expect("kw", "END")
                return ir.CaseWhen(branches, default)
            if t.text == "NOT":
                return ir.Not(self.parse_not())
            raise errors.unexpected_keyword(t.text, self.source)
        if t.kind == "op" and t.text == "(":
            e = self.parse_or()
            self.expect("op", ")")
            return e
        if t.kind in ("id", "bq"):
            name = t.text[1:-1].replace("``", "`") if t.kind == "bq" else t.text
            # function call?
            if t.kind == "id" and self.peek() and self.peek().kind == "op" and self.peek().text == "(":
                self.next()
                args: List[ir.Expression] = []
                if not self.accept("op", ")"):
                    args.append(self.parse_or())
                    while self.accept("op", ","):
                        args.append(self.parse_or())
                    self.expect("op", ")")
                lname = name.lower()
                if lname == "coalesce":
                    return ir.Coalesce(*args)
                if lname == "startswith" and len(args) == 2:
                    return ir.StartsWith(args[0], args[1])
                return ir.Func(name, args)
            # dotted column path → single column name "a.b.c"
            parts = [name]
            while self.peek() and self.peek().kind == "op" and self.peek().text == ".":
                self.next()
                nxt = self.next()
                if nxt.kind not in ("id", "bq"):
                    raise errors.bad_column_path(self.source)
                parts.append(nxt.text[1:-1].replace("``", "`") if nxt.kind == "bq" else nxt.text)
            return ir.Column(".".join(parts))
        raise errors.unexpected_token(t, self.source)

    def _parse_type_name(self) -> str:
        tok = self.next()
        if tok.kind not in ("id", "kw"):
            raise errors.expected_type_name(tok)
        name = tok.text.lower()
        if name == "decimal" and self.accept("op", "("):
            p = self.next().text
            self.expect("op", ",")
            s = self.next().text
            self.expect("op", ")")
            return f"decimal({p},{s})"
        return name


def parse_expression(s: str) -> ir.Expression:
    if isinstance(s, ir.Expression):
        return s
    return _Parser(_tokenize(s), s).parse()


def parse_predicate(s: str) -> ir.Expression:
    """Alias with intent: the result is used as a boolean filter."""
    return parse_expression(s)

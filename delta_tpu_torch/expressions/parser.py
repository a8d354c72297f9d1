"""A small SQL-like parser for predicates and expressions.

A copy of `delta_tpu/expressions/parser.py:18-234`, building the port's
own `expressions/tree.py` nodes (which `expressions/eval.py` evaluates).
Persisted expressions (CHECK constraints in `delta.constraints.*`,
generated-column expressions in field metadata) need a stable textual
form; ALTER TABLE parses them to find the columns they depend on. The
subset:

    a.b = 5, x > 'abc', flag, NOT deleted, id IS NOT NULL,
    c IN (1, 2, 3), (a = 1 AND b = 2) OR c < 3.0

Grammar (precedence low to high): OR, AND, NOT, comparison / IS NULL /
IN, atom (literal, column, parenthesized). Strings use single quotes
with '' escaping; TRUE, FALSE and NULL are literals; a backquoted name
(`a b`.`c`) may hold any character but a backquote. Arithmetic is not
supported (nothing evaluates it): it fails at parse time (`ParseError`).
`to_sql` writes an expression back in a form that parses to the same
tree.
"""

from __future__ import annotations

import re
from typing import List, Optional

from delta_tpu_torch.expressions.tree import (
    Column,
    Comparison,
    Expression,
    In,
    IsNotNull,
    IsNull,
    Literal,
    Not,
    And,
    Or,
)

_TOKEN_RE = re.compile(
    r"""
    \s*(
        (?P<string>'(?:[^']|'')*') |
        (?P<number>-?\d+\.\d+([eE][+-]?\d+)?|-?\d+) |
        (?P<op><=|>=|!=|<>|=|<|>) |
        (?P<lparen>\() |
        (?P<rparen>\)) |
        (?P<comma>,) |
        (?P<ident>[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*) |
        (?P<backtick>`[^`]+`(\.`[^`]+`)*)
    )
    """,
    re.VERBOSE,
)

_KEYWORDS = {"AND", "OR", "NOT", "IS", "NULL", "IN", "TRUE", "FALSE"}


class ParseError(ValueError):
    error_class = "DELTA_FAILED_RECOGNIZE_PREDICATE"


def _tokenize(s: str) -> List[tuple]:
    out = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise ParseError(f"cannot tokenize {s[pos:]!r}")
        pos = m.end()
        if m.group("string") is not None:
            out.append(("str", m.group("string")[1:-1].replace("''", "'")))
        elif m.group("number") is not None:
            text = m.group("number")
            out.append(("num", float(text) if ("." in text or "e" in text.lower()) else int(text)))
        elif m.group("op") is not None:
            op = m.group("op")
            out.append(("op", "!=" if op == "<>" else op))
        elif m.group("lparen"):
            out.append(("(", "("))
        elif m.group("rparen"):
            out.append((")", ")"))
        elif m.group("comma"):
            out.append((",", ","))
        elif m.group("backtick") is not None:
            parts = [p.strip("`") for p in m.group("backtick").split("`.`")]
            out.append(("col", tuple(parts)))
        else:
            ident = m.group("ident")
            if ident.upper() in _KEYWORDS and "." not in ident:
                out.append(("kw", ident.upper()))
            else:
                out.append(("col", tuple(ident.split("."))))
    return out


class _Parser:
    def __init__(self, tokens: List[tuple]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[tuple]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> tuple:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of expression")
        self.pos += 1
        return t

    def expect(self, kind: str, value=None) -> tuple:
        t = self.next()
        if t[0] != kind or (value is not None and t[1] != value):
            raise ParseError(f"expected {value or kind}, got {t}")
        return t

    def parse(self) -> Expression:
        e = self.parse_or()
        if self.peek() is not None:
            raise ParseError(f"trailing tokens: {self.tokens[self.pos:]}")
        return e

    def parse_or(self) -> Expression:
        left = self.parse_and()
        while (t := self.peek()) and t == ("kw", "OR"):
            self.next()
            left = Or(left, self.parse_and())
        return left

    def parse_and(self) -> Expression:
        left = self.parse_not()
        while (t := self.peek()) and t == ("kw", "AND"):
            self.next()
            left = And(left, self.parse_not())
        return left

    def parse_not(self) -> Expression:
        if (t := self.peek()) and t == ("kw", "NOT"):
            self.next()
            return Not(self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Expression:
        left = self.parse_atom()
        t = self.peek()
        if t is None:
            return left
        if t[0] == "op":
            op = self.next()[1]
            right = self.parse_atom()
            return Comparison(op, left, right)
        if t == ("kw", "IS"):
            self.next()
            if self.peek() == ("kw", "NOT"):
                self.next()
                self.expect("kw", "NULL")
                return IsNotNull(left)
            self.expect("kw", "NULL")
            return IsNull(left)
        if t == ("kw", "IN"):
            self.next()
            self.expect("(")
            values = []
            while True:
                v = self.parse_atom()
                if not isinstance(v, Literal):
                    raise ParseError("IN list must contain literals")
                values.append(v.value)
                nxt = self.next()
                if nxt[0] == ")":
                    break
                if nxt[0] != ",":
                    raise ParseError(f"expected , or ) in IN list, got {nxt}")
            return In(left, tuple(values))
        return left

    def parse_atom(self) -> Expression:
        t = self.next()
        if t[0] == "(":
            e = self.parse_or()
            self.expect(")")
            return e
        if t[0] == "str":
            return Literal(t[1])
        if t[0] == "num":
            return Literal(t[1])
        if t[0] == "kw":
            if t[1] == "TRUE":
                return Literal(True)
            if t[1] == "FALSE":
                return Literal(False)
            if t[1] == "NULL":
                return Literal(None)
            raise ParseError(f"unexpected keyword {t[1]}")
        if t[0] == "col":
            return Column(t[1])
        raise ParseError(f"unexpected token {t}")


def parse_expression(s: str) -> Expression:
    return _Parser(_tokenize(s)).parse()


def to_sql(expr: Expression) -> str:
    """Serialize an expression back to the parseable textual form."""
    if isinstance(expr, Column):
        return ".".join(
            f"`{p}`" if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", p) else p
            for p in expr.name_path
        )
    if isinstance(expr, Literal):
        v = expr.value
        if v is None:
            return "NULL"
        if isinstance(v, bool):
            return "TRUE" if v else "FALSE"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return repr(v)
    if isinstance(expr, Comparison):
        return f"{to_sql(expr.left)} {expr.op} {to_sql(expr.right)}"
    if isinstance(expr, And):
        return f"({to_sql(expr.left)} AND {to_sql(expr.right)})"
    if isinstance(expr, Or):
        return f"({to_sql(expr.left)} OR {to_sql(expr.right)})"
    if isinstance(expr, Not):
        return f"NOT ({to_sql(expr.child)})"
    if isinstance(expr, IsNull):
        return f"{to_sql(expr.child)} IS NULL"
    if isinstance(expr, IsNotNull):
        return f"{to_sql(expr.child)} IS NOT NULL"
    if isinstance(expr, In):
        vals = ", ".join(to_sql(Literal(v)) for v in expr.values)
        return f"{to_sql(expr.child)} IN ({vals})"
    raise ValueError(f"cannot serialize {expr!r}")

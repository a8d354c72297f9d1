"""SQL SELECT lexer + recursive-descent parser.

Grammar: the SELECT subset of Spark SQL that the TPC-DS corpus and the
delta SQL tests exercise — implicit comma joins, explicit
INNER/LEFT/RIGHT/FULL [OUTER]/CROSS JOIN ... ON, WHERE / GROUP BY /
HAVING / ORDER BY / LIMIT, scalar + IN + EXISTS subqueries, CASE WHEN,
BETWEEN, IN lists, LIKE, IS [NOT] NULL, CAST(x AS type), INTERVAL n
DAYS, arithmetic, and table refs that are quoted paths, catalog names,
or parenthesized sub-selects, each with optional alias and time travel
(VERSION/TIMESTAMP AS OF).

Pure syntax here; name resolution and execution live in executor.py.
The counterpart of `delta_tpu/sqlengine/parser.py`, whole: it parses the
full grammar, including what this package's executor refuses, and its
trees are equal in `repr` to the reference's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from delta_tpu_torch.errors import SqlParseError


# ------------------------------------------------------------- AST ----

@dataclass(frozen=True)
class Col:
    parts: Tuple[str, ...]  # ('dt', 'd_year') or ('d_year',)

    @property
    def text(self) -> str:
        return ".".join(self.parts)


@dataclass(frozen=True)
class Lit:
    value: object  # int | float | str | bool | None


@dataclass(frozen=True)
class Star:
    pass


@dataclass(frozen=True)
class BinOp:
    op: str  # + - * / ||
    left: object
    right: object


@dataclass(frozen=True)
class Cmp:
    op: str  # = <> < <= > >=
    left: object
    right: object


@dataclass(frozen=True)
class And:
    items: Tuple[object, ...]


@dataclass(frozen=True)
class Or:
    items: Tuple[object, ...]


@dataclass(frozen=True)
class Not:
    item: object


@dataclass(frozen=True)
class Func:
    name: str  # lowercase
    args: Tuple[object, ...]
    distinct: bool = False
    star: bool = False  # count(*)


@dataclass(frozen=True)
class Window:
    """`func(...) OVER (PARTITION BY ... [ORDER BY ...])` — the
    windowed-aggregate surface of the TPC-DS corpus (q12/q20/q98
    revenue ratios, q53/q63/q89 partition averages, rank/row_number)."""
    func: "Func"
    partition_by: Tuple[object, ...] = ()
    order_by: Tuple[Tuple[object, bool], ...] = ()  # (expr, asc)
    # frame with ORDER BY: "range" (SQL default; peers share values)
    # or "rows" (strict running frame)
    frame: str = "range"


@dataclass(frozen=True)
class CaseWhen:
    whens: Tuple[Tuple[object, object], ...]  # (condition, value)
    else_: object = None


@dataclass(frozen=True)
class Between:
    item: object
    lo: object
    hi: object
    negated: bool = False


@dataclass(frozen=True)
class InList:
    item: object
    values: Tuple[object, ...]
    negated: bool = False


@dataclass(frozen=True)
class InSelect:
    item: object
    select: "Select"
    negated: bool = False


@dataclass(frozen=True)
class Exists:
    select: "Select"
    negated: bool = False


@dataclass(frozen=True)
class ScalarSelect:
    select: "Select"


@dataclass(frozen=True)
class IsNull:
    item: object
    negated: bool = False


@dataclass(frozen=True)
class Like:
    item: object
    pattern: str
    negated: bool = False


@dataclass(frozen=True)
class Cast:
    item: object
    type_name: str  # lowercase: date, int, bigint, double, string...


@dataclass(frozen=True)
class Interval:
    n: int
    unit: str  # 'day'


@dataclass(frozen=True)
class Neg:
    item: object


@dataclass(frozen=True)
class SelectItem:
    expr: object
    alias: Optional[str]
    # original source text of the expression (output-column naming for
    # unaliased expressions, Spark-style)
    text: str = ""


@dataclass(frozen=True)
class TableRef:
    kind: str            # 'path' | 'name' | 'subquery'
    value: object        # str for path/name, Select for subquery
    alias: Optional[str]
    tt_version: Optional[int] = None
    tt_timestamp: Optional[str] = None


@dataclass(frozen=True)
class JoinClause:
    ref: TableRef
    kind: str   # 'inner' | 'left outer' | 'right outer' | 'full outer' | 'cross'
    on: object  # expression or None (cross)


@dataclass
class Select:
    items: List[SelectItem] = field(default_factory=list)
    froms: List[TableRef] = field(default_factory=list)   # comma list
    joins: List[JoinClause] = field(default_factory=list)  # explicit JOINs
    where: object = None
    group_by: List[object] = field(default_factory=list)
    having: object = None
    order_by: List[Tuple[object, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False


@dataclass
class Query:
    """Full query: optional WITH clause + one or more UNION ALL'd
    selects + trailing ORDER BY/LIMIT applying to the union result.
    A bare SELECT parses as Query(ctes=[], selects=[sel]) and the
    executor unwraps it."""

    ctes: List[Tuple[str, "Query"]] = field(default_factory=list)
    selects: List[Select] = field(default_factory=list)
    # "all" | "distinct", one per additional select (left-assoc fold)
    union_ops: List[str] = field(default_factory=list)
    order_by: List[Tuple[object, bool]] = field(default_factory=list)
    limit: Optional[int] = None


# ------------------------------------------------------------ lexer ---

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<dstr>"(?:[^"]|"")*")
  | (?P<bstr>`[^`]*`)
  | (?P<op><=|>=|<>|!=|\|\||[=<>(),.*/+\-])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "HAVING",
    "ORDER", "LIMIT", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER",
    "CROSS", "ON", "AS", "AND", "OR", "NOT", "IN", "EXISTS", "BETWEEN",
    "LIKE", "IS", "NULL", "CASE", "WHEN", "THEN", "ELSE", "END", "CAST",
    "INTERVAL", "ASC", "DESC", "VERSION", "TIMESTAMP", "OF", "UNION",
    "INTERSECT", "EXCEPT",
    "TRUE", "FALSE", "OVER", "PARTITION", "WITH", "ALL", "ROWS",
    "RANGE", "UNBOUNDED", "PRECEDING", "CURRENT", "ROW", "FOLLOWING",
}


@dataclass(frozen=True)
class Token:
    kind: str   # 'num' | 'str' | 'dstr' | 'bstr' | 'op' | 'ident' | 'end'
    value: str
    pos: int

    def is_kw(self, *names: str) -> bool:
        return self.kind == "ident" and self.value.upper() in names


def tokenize(s: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    n = len(s)
    while pos < n:
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            raise SqlParseError(f"cannot tokenize SQL at {s[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "str":
            text = text[1:-1].replace("''", "'")
        elif kind == "dstr":
            text = text[1:-1].replace('""', '"')
        elif kind == "bstr":
            text = text[1:-1]
        out.append(Token(kind, text, m.start()))
    out.append(Token("end", "", n))
    return out


# ----------------------------------------------------------- parser ---

# identifiers that terminate an alias-less table/column position
_STOP_ALIAS = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "ON", "JOIN",
    "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "UNION",
    "INTERSECT", "EXCEPT", "AND",
    "OR", "NOT", "VERSION", "TIMESTAMP", "SELECT", "WHEN", "THEN",
    "ELSE", "END", "ASC", "DESC", "BY", "AS", "IN", "IS", "BETWEEN",
    "LIKE", "EXISTS", "CASE",
}

_AGG_FUNCS = {"count", "sum", "min", "max", "avg", "stddev_samp",
              "var_samp"}


class _P:
    def __init__(self, tokens: List[Token], src: str):
        self.toks = tokens
        self.i = 0
        self.src = src

    # -- stream helpers -------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "end":
            self.i += 1
        return t

    def accept_op(self, *ops: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "op" and t.value in ops:
            self.next()
            return t.value
        return None

    def accept_kw(self, *names: str) -> Optional[str]:
        t = self.peek()
        if t.is_kw(*names):
            self.next()
            return t.value.upper()
        return None

    def expect_kw(self, name: str) -> None:
        if not self.accept_kw(name):
            raise SqlParseError(
                f"expected {name} at {self._ctx()}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlParseError(f"expected {op!r} at {self._ctx()}")

    def _ctx(self) -> str:
        t = self.peek()
        return repr(self.src[t.pos:t.pos + 30]) if t.kind != "end" \
            else "<end of statement>"

    # -- entry ----------------------------------------------------------
    def parse_select(self) -> Select:
        self.expect_kw("SELECT")
        sel = Select()
        sel.distinct = bool(self.accept_kw("DISTINCT"))
        sel.items.append(self._select_item())
        while self.accept_op(","):
            sel.items.append(self._select_item())
        if self.accept_kw("FROM"):
            sel.froms.append(self._table_ref())
            while True:
                if self.accept_op(","):
                    sel.froms.append(self._table_ref())
                    continue
                kind = self._join_kind()
                if kind is None:
                    break
                ref = self._table_ref()
                on = None
                if kind != "cross":
                    if not self.accept_kw("ON"):
                        raise SqlParseError("JOIN requires ON")
                    on = self._expr()
                sel.joins.append(JoinClause(ref, kind, on))
        if self.accept_kw("WHERE"):
            sel.where = self._expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            sel.group_by.append(self._expr())
            while self.accept_op(","):
                sel.group_by.append(self._expr())
        if self.accept_kw("HAVING"):
            sel.having = self._expr()
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            sel.order_by.append(self._order_item())
            while self.accept_op(","):
                sel.order_by.append(self._order_item())
        if self.accept_kw("LIMIT"):
            t = self.next()
            if t.kind != "num":
                raise SqlParseError(f"LIMIT expects a number, got {t.value!r}")
            sel.limit = int(t.value)
        return sel

    def _order_item(self) -> Tuple[object, bool]:
        e = self._expr()
        asc = True
        if self.accept_kw("DESC"):
            asc = False
        else:
            self.accept_kw("ASC")
        return (e, asc)

    def _select_item(self) -> SelectItem:
        t = self.peek()
        if t.kind == "op" and t.value == "*":
            self.next()
            return SelectItem(Star(), None, "*")
        start = t.pos
        e = self._expr()
        end = self.peek().pos
        text = self.src[start:end].strip()
        alias = None
        if self.accept_kw("AS"):
            alias = self._ident_token().value
        else:
            nt = self.peek()
            if nt.kind == "ident" and nt.value.upper() not in _STOP_ALIAS:
                alias = self.next().value
        return SelectItem(e, alias, text)

    def _ident_token(self) -> Token:
        t = self.next()
        if t.kind not in ("ident", "bstr", "dstr"):
            raise SqlParseError(f"expected identifier, got {t.value!r}")
        return t

    # -- table refs -----------------------------------------------------
    def _table_ref(self) -> TableRef:
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            self.next()
            # full query: `from (select ... union all select ...) x`
            sub = self._query()
            self.expect_op(")")
            alias = self._opt_alias()
            if not sub.ctes and len(sub.selects) == 1 \
                    and not sub.order_by and sub.limit is None:
                sub = sub.selects[0]
            return TableRef("subquery", sub, alias)
        if t.kind in ("str", "dstr"):
            self.next()
            kind, value = "path", t.value
        elif t.kind == "ident":
            # delta.`/path` is a path; plain dotted idents are names
            if (t.value.lower() == "delta" and self.peek(1).kind == "op"
                    and self.peek(1).value == "."
                    and self.peek(2).kind == "bstr"):
                self.next(); self.next()
                kind, value = "path", self.next().value
            else:
                parts = [self._ident_token().value]
                while (self.peek().kind == "op" and self.peek().value == "."
                       and self.peek(1).kind in ("ident", "bstr")):
                    self.next()
                    parts.append(self._ident_token().value)
                kind, value = "name", ".".join(parts)
        elif t.kind == "bstr":
            self.next()
            kind, value = "path", t.value
        else:
            raise SqlParseError(f"expected table reference at {self._ctx()}")
        tt_version = tt_ts = None
        if self.accept_kw("VERSION"):
            self.expect_kw("AS")
            self.expect_kw("OF")
            tok = self.next()
            if tok.kind != "num":
                raise SqlParseError("VERSION AS OF expects a number")
            tt_version = int(tok.value)
        elif self.accept_kw("TIMESTAMP"):
            self.expect_kw("AS")
            self.expect_kw("OF")
            tok = self.next()
            if tok.kind not in ("num", "str"):
                raise SqlParseError("TIMESTAMP AS OF expects a value")
            # preserve the literal kind: _timestamp_ms only treats a
            # leading quote as "parse as ISO", so a bare ISO string
            # would fall through to int() and crash
            tt_ts = tok.value if tok.kind == "num" else f"'{tok.value}'"
        if (tt_version is not None or tt_ts is not None) and \
                self.peek().is_kw("VERSION", "TIMESTAMP") and \
                self.peek(1).is_kw("AS"):
            # `DeltaErrors.multipleTimeTravelSyntaxUsed`
            raise SqlParseError(
                "cannot specify time travel in multiple formats "
                "(VERSION AS OF and TIMESTAMP AS OF)",
                error_class="DELTA_UNSUPPORTED_TIME_TRAVEL_MULTIPLE_FORMATS")
        alias = self._opt_alias()
        return TableRef(kind, value, alias, tt_version, tt_ts)

    def _opt_alias(self) -> Optional[str]:
        if self.accept_kw("AS"):
            return self._ident_token().value
        t = self.peek()
        if t.kind == "ident" and t.value.upper() not in _STOP_ALIAS:
            return self.next().value
        return None

    def _join_kind(self) -> Optional[str]:
        t = self.peek()
        if t.is_kw("JOIN"):
            self.next()
            return "inner"
        if t.is_kw("INNER") and self.peek(1).is_kw("JOIN"):
            self.next(); self.next()
            return "inner"
        for kw, kind in (("LEFT", "left outer"), ("RIGHT", "right outer"),
                         ("FULL", "full outer")):
            if t.is_kw(kw):
                self.next()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                return kind
        if t.is_kw("CROSS"):
            self.next()
            self.expect_kw("JOIN")
            return "cross"
        return None

    # -- expressions ----------------------------------------------------
    def _expr(self) -> object:
        return self._or()

    def _or(self) -> object:
        items = [self._and()]
        while self.accept_kw("OR"):
            items.append(self._and())
        return items[0] if len(items) == 1 else Or(tuple(items))

    def _and(self) -> object:
        items = [self._not()]
        while self.accept_kw("AND"):
            items.append(self._not())
        return items[0] if len(items) == 1 else And(tuple(items))

    def _not(self) -> object:
        if self.accept_kw("NOT"):
            return Not(self._not())
        return self._predicate()

    def _predicate(self) -> object:
        left = self._additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">",
                                          ">="):
            op = self.next().value
            if op == "!=":
                op = "<>"
            right = self._additive()
            return Cmp(op, left, right)
        if t.is_kw("IS"):
            self.next()
            negated = bool(self.accept_kw("NOT"))
            self.expect_kw("NULL")
            return IsNull(left, negated)
        negated = False
        if t.is_kw("NOT") and self.peek(1).is_kw("BETWEEN", "IN", "LIKE"):
            self.next()
            negated = True
            t = self.peek()
        if t.is_kw("BETWEEN"):
            self.next()
            lo = self._additive()
            self.expect_kw("AND")
            hi = self._additive()
            return Between(left, lo, hi, negated)
        if t.is_kw("IN"):
            self.next()
            self.expect_op("(")
            if self.peek().is_kw("SELECT"):
                sub = self.parse_select()
                self.expect_op(")")
                return InSelect(left, sub, negated)
            vals = [self._expr()]
            while self.accept_op(","):
                vals.append(self._expr())
            self.expect_op(")")
            return InList(left, tuple(vals), negated)
        if t.is_kw("LIKE"):
            self.next()
            pat = self.next()
            if pat.kind != "str":
                raise SqlParseError("LIKE expects a string pattern")
            return Like(left, pat.value, negated)
        return left

    def _additive(self) -> object:
        left = self._multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                op = self.next().value
                left = BinOp(op, left, self._multiplicative())
            else:
                return left

    def _multiplicative(self) -> object:
        left = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/"):
                op = self.next().value
                left = BinOp(op, left, self._unary())
            else:
                return left

    def _unary(self) -> object:
        if self.accept_op("-"):
            item = self._unary()
            if isinstance(item, Lit) and isinstance(item.value, (int, float)):
                return Lit(-item.value)
            return Neg(item)
        self.accept_op("+")
        return self._primary()

    def _primary(self) -> object:
        t = self.peek()
        if t.kind == "num":
            self.next()
            v = float(t.value) if "." in t.value else int(t.value)
            return Lit(v)
        if t.kind == "str":
            self.next()
            return Lit(t.value)
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().is_kw("SELECT"):
                sub = self.parse_select()
                self.expect_op(")")
                return ScalarSelect(sub)
            e = self._expr()
            self.expect_op(")")
            return e
        if t.is_kw("NULL"):
            self.next()
            return Lit(None)
        if t.is_kw("TRUE"):
            self.next()
            return Lit(True)
        if t.is_kw("FALSE"):
            self.next()
            return Lit(False)
        if t.is_kw("CASE"):
            return self._case()
        if t.is_kw("CAST"):
            self.next()
            self.expect_op("(")
            item = self._expr()
            self.expect_kw("AS")
            type_parts = [self._ident_token().value]
            if self.accept_op("("):  # e.g. decimal(7,2)
                depth = 1
                while depth:
                    tok = self.next()
                    if tok.kind == "end":
                        raise SqlParseError("unterminated CAST type")
                    if tok.kind == "op" and tok.value == "(":
                        depth += 1
                    elif tok.kind == "op" and tok.value == ")":
                        depth -= 1
            self.expect_op(")")
            return Cast(item, type_parts[0].lower())
        if t.is_kw("INTERVAL"):
            self.next()
            num = self.next()
            if num.kind != "num":
                raise SqlParseError("INTERVAL expects a number")
            unit_tok = self._ident_token().value.lower().rstrip("s")
            if unit_tok not in ("day",):
                raise SqlParseError(f"unsupported INTERVAL unit {unit_tok!r}")
            return Interval(int(num.value), unit_tok)
        if t.is_kw("EXISTS"):
            self.next()
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return Exists(sub)
        if t.kind in ("ident", "bstr"):
            # function call?
            if (t.kind == "ident" and self.peek(1).kind == "op"
                    and self.peek(1).value == "("
                    and t.value.upper() not in _STOP_ALIAS):
                name = self.next().value.lower()
                self.next()  # (
                distinct = bool(self.accept_kw("DISTINCT"))
                if self.accept_op("*"):
                    self.expect_op(")")
                    f = Func(name, (), distinct=distinct, star=True)
                elif self.accept_op(")"):
                    f = Func(name, ())
                else:
                    args = [self._expr()]
                    while self.accept_op(","):
                        args.append(self._expr())
                    self.expect_op(")")
                    f = Func(name, tuple(args), distinct=distinct)
                if self.peek().is_kw("OVER"):
                    return self._window(f)
                return f
            parts = [self._ident_token().value]
            while (self.peek().kind == "op" and self.peek().value == "."
                   and self.peek(1).kind in ("ident", "bstr")):
                self.next()
                parts.append(self._ident_token().value)
            return Col(tuple(parts))
        raise SqlParseError(f"unexpected token at {self._ctx()}")


def parse_select(statement: str) -> Select:
    """Parse one SELECT statement (no trailing garbage allowed)."""
    toks = tokenize(statement.strip().rstrip(";"))
    p = _P(toks, statement)
    sel = p.parse_select()
    if p.peek().kind != "end":
        raise SqlParseError(f"unexpected trailing SQL at {p._ctx()}")
    return sel


def walk(node, fn):
    """Depth-first visit of every AST node (expressions + nested
    selects are NOT entered; see walk_exprs for same-scope walks)."""
    fn(node)
    for child in _children(node):
        walk(child, fn)


def _children(node):
    if isinstance(node, (BinOp, Cmp)):
        return (node.left, node.right)
    if isinstance(node, (And, Or)):
        return node.items
    if isinstance(node, (Not, Neg)):
        return (node.item,)
    if isinstance(node, Func):
        return node.args
    if isinstance(node, CaseWhen):
        out = [x for w in node.whens for x in w]
        if node.else_ is not None:
            out.append(node.else_)
        return tuple(out)
    if isinstance(node, Between):
        return (node.item, node.lo, node.hi)
    if isinstance(node, InList):
        return (node.item,) + node.values
    if isinstance(node, (InSelect, Like, IsNull)):
        return (node.item,)
    if isinstance(node, Cast):
        return (node.item,)
    return ()


def _parse_case(self: _P) -> object:
    self.expect_kw("CASE")
    # simple form `CASE expr WHEN v THEN r ...` desugars to the
    # searched form `CASE WHEN expr = v THEN r ...` (q39's
    # `case mean when 0 then null else ... end`)
    operand = None
    if not self.peek().is_kw("WHEN"):
        operand = self._expr()
    whens = []
    while self.accept_kw("WHEN"):
        cond = self._expr()
        if operand is not None:
            cond = Cmp("=", operand, cond)
        self.expect_kw("THEN")
        val = self._expr()
        whens.append((cond, val))
    else_ = None
    if self.accept_kw("ELSE"):
        else_ = self._expr()
    self.expect_kw("END")
    if not whens:
        raise SqlParseError("CASE requires at least one WHEN")
    return CaseWhen(tuple(whens), else_)


_P._case = _parse_case


def _parse_window(self: _P, f: Func) -> Window:
    self.expect_kw("OVER")
    self.expect_op("(")
    part: list = []
    order: list = []
    if self.accept_kw("PARTITION"):
        self.expect_kw("BY")
        part.append(self._expr())
        while self.accept_op(","):
            part.append(self._expr())
    if self.accept_kw("ORDER"):
        self.expect_kw("BY")
        while True:
            e = self._expr()
            asc = True
            if self.accept_kw("DESC"):
                asc = False
            else:
                self.accept_kw("ASC")
            order.append((e, asc))
            if not self.accept_op(","):
                break
    frame = "range"
    if self.peek().is_kw("ROWS") or self.peek().is_kw("RANGE"):
        # only the SQL-default-shaped frame is supported:
        # [ROWS|RANGE] BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW
        frame = "rows" if self.next().value.lower() == "rows" else "range"
        self.expect_kw("BETWEEN")
        self.expect_kw("UNBOUNDED")
        self.expect_kw("PRECEDING")
        self.expect_kw("AND")
        self.expect_kw("CURRENT")
        self.expect_kw("ROW")
    self.expect_op(")")
    return Window(f, tuple(part), tuple(order), frame)


_P._window = _parse_window


def _parse_query(self: _P) -> Query:
    q = Query()
    if self.accept_kw("WITH"):
        while True:
            name = self._ident_token().value
            self.expect_kw("AS")
            self.expect_op("(")
            q.ctes.append((name, self._query()))
            self.expect_op(")")
            if not self.accept_op(","):
                break
    q.selects.append(self._set_operand())
    while self.peek().is_kw("UNION", "INTERSECT", "EXCEPT"):
        kw = self.next().value.upper()
        if kw == "UNION":
            q.union_ops.append("all" if self.accept_kw("ALL")
                               else "distinct")
        else:
            q.union_ops.append(kw.lower())
        q.selects.append(self._set_operand())
    if len(q.selects) > 1:
        # a trailing ORDER BY/LIMIT binds to the set-op result, not
        # the final branch — but ONLY when the final operand is a bare
        # SELECT; a parenthesized operand keeps its own clauses
        last = q.selects[-1]
        if isinstance(last, Select):
            q.order_by, last.order_by = last.order_by, []
            q.limit, last.limit = last.limit, None
        # INTERSECT binds tighter than UNION/EXCEPT (standard SQL):
        # fold intersect pairs into nested sub-queries left-to-right
        sels, ops = [q.selects[0]], []
        for op, sel in zip(q.union_ops, q.selects[1:]):
            if op == "intersect":
                prev = sels.pop()
                sels.append(Query(selects=[prev, sel],
                                  union_ops=["intersect"]))
            else:
                ops.append(op)
                sels.append(sel)
        q.selects, q.union_ops = sels, ops
    return q


def _parse_set_operand(self: _P):
    """One operand of a set-op chain: a SELECT, or a parenthesized
    query (q87's `(select ...) except (select ...)`)."""
    t = self.peek()
    if t.kind == "op" and t.value == "(":
        self.next()
        sub = self._query()
        self.expect_op(")")
        if not sub.ctes and len(sub.selects) == 1 \
                and not sub.order_by and sub.limit is None:
            inner = sub.selects[0]
            if not inner.order_by and inner.limit is None:
                return inner
            # keep the Query wrapper: a parenthesized branch's own
            # ORDER BY/LIMIT must not be hoisted to the set-op result
        return sub
    return self.parse_select()


_P._set_operand = _parse_set_operand
_P._query = _parse_query


def parse_query(statement: str) -> Query:
    """Parse a full query: [WITH ...] select [UNION ALL select]..."""
    toks = tokenize(statement.strip().rstrip(";"))
    p = _P(toks, statement)
    q = p._query()
    if p.peek().kind != "end":
        raise SqlParseError(f"unexpected trailing SQL at {p._ctx()}")
    return q

"""SELECT executor: query folding (WITH, set operations), name
resolution, scan pushdown, join planning, subqueries, evaluation over the
port's Columns, aggregation, ordering.

Counterpart of `delta_tpu/sqlengine/executor.py` (`execute_select` `:50`,
`_run_query` `:63`, `_Exec` `:344`):

1. A query (`_run_query`) binds its WITH clauses in order: each CTE is
   materialized once as a `Frame` and sees the bindings before it, never
   its siblings; a nested WITH never leaks outward. Its branches run in
   turn and fold left to right: UNION ALL stacks them by position
   (`frame.concat_frames`), UNION, INTERSECT and EXCEPT have set semantics (the
   rows distinct, NULL equal to NULL: `group_codes`' codes; INTERSECT and
   EXCEPT test membership through `DeviceSpine.match_codes`). A trailing
   ORDER BY names output columns or ordinals only; LIMIT follows.
2. A SELECT block (`_Exec.run`): every source resolves to a Delta
   snapshot (a path, or a name through the catalog, with VERSION /
   TIMESTAMP AS OF), a CTE (its Columns under each reference's alias,
   not copied) or a subquery in FROM. A scanned source is read with the
   columns the query names and the WHERE conjuncts that name it alone
   pushed into `Snapshot.scan(filter=...)` (partition pruning, and stats
   skipping on the card through kernel K7); a pushed conjunct is applied
   again with SQL's semantics once its tables are joined, so the scan is
   only ever a superset. A CTE or subquery source is filtered by such
   conjuncts before any join.
3. Joins: JOIN ... ON clauses and the implicit comma list, through the
   equi-join edges of the WHERE conjuncts (and those common to every
   branch of an OR, q13 and q48's shape); among the comma list and the
   leading INNER and CROSS joins the most connected, then the smallest,
   table joins next (the reference's greedy order); a table with no edge
   is cross-joined. LEFT, RIGHT and FULL OUTER joins, and every join
   after one, keep clause order on their ON keys. A conjunct applies as
   soon as its tables are joined, unless it holds a subquery (after the
   joins) or names a side an outer join can null-extend: that one is
   never pushed into a scan or made a join key, and filters after the
   joins. A NULL key never matches; the rows a preserved side loses to
   one are appended null-extended (`_merge_null_safe`).
4. Subqueries in expressions: an uncorrelated one runs once (a scalar, an
   IN set, EXISTS); a correlated one is decorrelated on its equality
   conjuncts (`_correlation`, with the OR factoring of q41): a scalar
   groups the subquery by its correlation columns (K10) and looks each
   outer key tuple up in the groups (`DeviceSpine.lookup`: a left join on
   the card); IN and EXISTS are semi-joins (`DeviceSpine.member`).
   Three-valued IN holds, a NULL outer key makes EXISTS and IN false, a
   correlated COUNT over no rows is 0 and any other aggregate NULL.
5. The residual WHERE, then GROUP BY aggregation (NULL group keys kept, a
   sum of no values NULL; COUNT, SUM, AVG (DISTINCT ...) over each
   group's distinct values; GROUP BY ROLLUP's levels stacked, with
   `grouping(k)`), HAVING, the projection with its window functions
   (over the rows, or over the aggregated rows), DISTINCT, ORDER BY with
   Spark's null order (NULLS FIRST ascending, LAST descending) and
   LIMIT.

Joins, lookups, membership tests, every aggregate, every window and the
ORDER BY sort run on the engine's device through
`sqlengine/device.py::DeviceSpine` (K10 for the aggregates, DISTINCT
aggregates and partition windows; K11 for ranks and running windows).
The result is an `SqlResult`: a `Batch` that also keeps the output names
in order, repeats included.

Refused before any table is read, with the reference's error classes,
wherever the query holds them (a CTE body, a derived table, a subquery,
a set-operation branch): DISTINCT inside a window function, a window
function other than SUM, AVG, MIN, MAX, COUNT, row_number, rank and
dense_rank, and a rank without ORDER BY (`check_supported`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from delta_tpu_torch import obs
from delta_tpu_torch.errors import (
    AmbiguousColumnError,
    CatalogTableError,
    DeltaError,
    SqlParseError,
    SubqueryShapeError,
    UnresolvedColumnError,
    UnsupportedSqlError,
)
from delta_tpu_torch.models.batch import Batch, Column
from delta_tpu_torch.sqlengine import frame as fv
from delta_tpu_torch.sqlengine.device import DeviceSpine, group_codes
from delta_tpu_torch.sqlengine.frame import Frame
from delta_tpu_torch.sqlengine.parser import (
    And, Between, BinOp, CaseWhen, Cast, Cmp, Col, Exists, Func, InList,
    InSelect, Interval, IsNull, Like, Lit, Neg, Not, Or, Query,
    ScalarSelect, Select, SelectItem, Star, TableRef, Window, parse_query,
)

_NUMERIC_TYPES = {"byte", "short", "integer", "long", "float", "double"}
_AGGS = {"count", "sum", "min", "max", "avg", "stddev_samp", "var_samp"}
_SUBQUERY = (ScalarSelect, InSelect, Exists)

QUERIES = obs.counter("sql.queries")
# wall nanoseconds of each phase of the queries run (the scans with their
# snapshot loads; the joins with their key coding and gathers; the
# aggregates with their key coding; the ORDER BY sort)
SCAN_NS = obs.counter("sql.scan_ns")
JOIN_NS = obs.counter("sql.join_ns")
GROUP_NS = obs.counter("sql.group_ns")
SORT_NS = obs.counter("sql.sort_ns")


class SqlResult(Batch):
    """A query's rows: a `Batch` keyed by output name, with `names` the
    output names in select-list order. Where a name repeats, its later
    columns are keyed `name#2`, `name#3`, ... and `names` keeps the name
    itself, so no column is lost."""

    def __init__(self, names: List[str], columns: List[Column], n: int):
        super().__init__(dict(zip(_unique(names), columns)), n)
        self.names = list(names)

    @property
    def num_columns(self) -> int:
        return len(self.names)

    def column_at(self, i: int) -> Column:
        return list(self.columns.values())[i]

    def rows(self) -> List[tuple]:
        """The rows as tuples of Python values (None where NULL)."""
        cols = [c.to_python() for c in self.columns.values()]
        if not cols:
            return [()] * self.num_rows
        return list(zip(*cols))


def _unique(names: List[str]) -> List[str]:
    """`names` with each repeat keyed `name#2`, `name#3`, ..."""
    out, seen = [], set()
    for name in names:
        key, k = name, 1
        while key in seen:
            k += 1
            key = f"{name}#{k}"
        seen.add(key)
        out.append(key)
    return out


# ---------------------------------------------------------------- API --

def execute_select(statement_or_ast, engine=None, catalog=None,
                   ctes=None) -> SqlResult:
    """Run one query (text, `Select` or `Query`) against Delta tables:
    paths, or names through `catalog`. On `engine`'s device (the
    catalog's engine when none is given; the card when neither is).
    `ctes` binds names to `Frame`s, as a WITH clause would."""
    if isinstance(statement_or_ast, Select):
        q = Query(selects=[statement_or_ast])
    elif isinstance(statement_or_ast, Query):
        q = statement_or_ast
    else:
        q = parse_query(statement_or_ast)
    if engine is None:
        if catalog is not None:
            engine = catalog.engine
        else:
            from delta_tpu_torch.engine import TorchEngine

            engine = TorchEngine()
    check_supported(q)
    QUERIES.inc()
    out, names = _run_query(q, engine, catalog, dict(ctes or {}))
    return SqlResult(names, list(out.cols.values()), len(out))


def _positional(cols: List[Column], n: int) -> Frame:
    return Frame({f"__c{j}": c for j, c in enumerate(cols)}, n)


def _distinct(frame: Frame) -> Frame:
    """The first row of each distinct row, in order (NULL equals NULL)."""
    if not frame.cols or not len(frame):
        return frame
    _, _, first = group_codes(list(frame.cols.values()))
    return frame.take(np.sort(first))


def _run_query(q: Query, engine, catalog, ctes) -> Tuple[Frame, List[str]]:
    """A full query (module docstring, 1.): its rows as a Frame keyed by
    position (`__c0`, `__c1`, ...) and its output names."""
    for name, sub in q.ctes:
        # a CTE body sees the bindings before it, not its siblings'; a
        # copy of the bindings keeps its own nested WITH from leaking
        frame, names = _run_query(sub, engine, catalog, dict(ctes))
        ctes[name.lower()] = frame.rekey(_unique(names))
    frames: List[Frame] = []
    out_names: List[str] = []
    for i, sel in enumerate(q.selects):
        if isinstance(sel, Query):  # a parenthesized nested query
            frame, names = _run_query(sel, engine, catalog, dict(ctes))
        else:
            names, cols, n = _Exec(engine, catalog, ctes).run(sel)
            frame = _positional(cols, n)
        if i == 0:
            out_names = names
        elif len(names) != len(out_names):
            raise SqlParseError(
                f"set operation branches have different widths "
                f"({len(out_names)} vs {len(names)})",
                error_class="DELTA_UNION_WIDTH_MISMATCH")
        frames.append(frame)
    spine = DeviceSpine(engine.device)
    result = frames[0]
    for op, f in zip(q.union_ops, frames[1:]):
        if op in ("all", "distinct"):
            result = fv.concat_frames([result, f])
            if op == "distinct":
                result = _distinct(result)
            continue
        # INTERSECT and EXCEPT are distinct, and NULL equals NULL: codes
        # over both sides' rows, then each left row's membership
        a, b = _distinct(result), _distinct(f)
        both = fv.concat_frames([a, b])
        codes, _, _ = group_codes(list(both.cols.values()))
        got = spine.match_codes(codes[:len(a)], codes[len(a):])
        keep = got >= 0 if op == "intersect" else got < 0
        result = both.head(len(a)).filter(keep)
    if q.order_by:
        lower = [n.lower() for n in out_names]
        cols = list(result.cols.values())
        keys, ascs = [], []
        for e, asc in q.order_by:
            if isinstance(e, Lit) and isinstance(e.value, int) \
                    and not isinstance(e.value, bool) \
                    and 1 <= e.value <= len(out_names):
                pos = e.value - 1
            elif (isinstance(e, Col) and len(e.parts) == 1
                    and e.parts[0].lower() in lower):
                pos = lower.index(e.parts[0].lower())
            else:
                raise UnsupportedSqlError(
                    "ORDER BY after a set operation must name output "
                    f"columns or ordinals; got {_render(e)!r}",
                    error_class="DELTA_ORDER_BY_AFTER_UNION",
                    construct="ORDER BY expression after a set operation")
            keys.append(cols[pos])
            ascs.append(asc)
        with _Clock(SORT_NS):
            result = result.take(spine.sort_permutation(keys, ascs))
    if q.limit is not None:
        result = result.head(q.limit)
    return result, out_names


_RANKS = ("rank", "row_number", "dense_rank")
_WINDOW_AGGS = ("sum", "avg", "min", "max", "count")


def check_supported(q) -> None:
    """The window shapes the reference refuses, refused before any table
    is read, wherever the query (a `Query` or a `Select`) holds them: its
    CTE bodies, set-operation branches, derived tables and subqueries.
    The errors are the reference's (`_window_eval`, `executor.py:1702`):
    DISTINCT inside a window, a function other than the aggregates and
    the ranks, a rank without ORDER BY."""
    if isinstance(q, Select):
        _check_select(q)
        return
    for _, sub in q.ctes:
        check_supported(sub)
    for sel in q.selects:
        check_supported(sel)


def _check_window(e: Window) -> None:
    name = e.func.name
    if e.func.distinct:
        raise UnsupportedSqlError(
            f"DISTINCT inside window function {name} is not supported",
            error_class="DELTA_UNSUPPORTED_DISTINCT_IN_WINDOW",
            construct=f"{name.upper()}(DISTINCT) OVER")
    if name not in _RANKS + _WINDOW_AGGS:
        raise UnsupportedSqlError(
            f"unsupported window function {name!r}",
            error_class="DELTA_UNSUPPORTED_WINDOW_FUNCTION",
            construct=f"{name}() OVER")
    if name in _RANKS and not e.order_by:
        raise SqlParseError(f"{name}() requires ORDER BY",
                            error_class="DELTA_WINDOW_REQUIRES_ORDER",
                            construct=f"{name}() OVER without ORDER BY")


def _check_select(sel: Select) -> None:
    nested = []

    def chk(e):
        if isinstance(e, _SUBQUERY):
            nested.append(e.select)
        elif isinstance(e, Window):
            _check_window(e)

    for e in ([it.expr for it in sel.items] + [sel.where, sel.having]
              + list(sel.group_by) + [o for o, _ in sel.order_by]
              + [j.on for j in sel.joins]):
        _walk_all(e, chk)
    for ref in list(sel.froms) + [j.ref for j in sel.joins]:
        if ref.kind == "subquery":
            check_supported(ref.value)
    for sub in nested:
        _check_select(sub)


def _walk_all(e, fn):
    """`_walk_exprs` that also enters window functions themselves."""
    if e is None:
        return
    _walk_exprs(e, fn)
    if isinstance(e, Window):
        _walk_all(e.func, fn)


# ------------------------------------------------------------ helpers --

def _canon(e, resolve) -> str:
    """Canonical key of an expression with its columns resolved:
    `dt.d_year` and a bare `d_year` of the same column share a key."""
    if isinstance(e, Col):
        return f"col:{resolve(e)}"
    if isinstance(e, Lit):
        return f"lit:{e.value!r}"
    if isinstance(e, (BinOp, Cmp)):
        return f"({_canon(e.left, resolve)}{e.op}{_canon(e.right, resolve)})"
    if isinstance(e, And):
        return "and(" + ",".join(_canon(x, resolve) for x in e.items) + ")"
    if isinstance(e, Or):
        return "or(" + ",".join(_canon(x, resolve) for x in e.items) + ")"
    if isinstance(e, Not):
        return f"not({_canon(e.item, resolve)})"
    if isinstance(e, Neg):
        return f"neg({_canon(e.item, resolve)})"
    if isinstance(e, Func):
        inner = "*" if e.star else ",".join(
            _canon(a, resolve) for a in e.args)
        d = "distinct " if e.distinct else ""
        return f"{e.name}({d}{inner})"
    if isinstance(e, CaseWhen):
        parts = [f"when {_canon(c, resolve)} then {_canon(v, resolve)}"
                 for c, v in e.whens]
        if e.else_ is not None:
            parts.append(f"else {_canon(e.else_, resolve)}")
        return "case(" + ";".join(parts) + ")"
    if isinstance(e, Between):
        neg = "not " if e.negated else ""
        return (f"{neg}between({_canon(e.item, resolve)},"
                f"{_canon(e.lo, resolve)},{_canon(e.hi, resolve)})")
    if isinstance(e, InList):
        neg = "not " if e.negated else ""
        return (f"{neg}in({_canon(e.item, resolve)};"
                + ",".join(_canon(v, resolve) for v in e.values) + ")")
    if isinstance(e, IsNull):
        return f"isnull({_canon(e.item, resolve)},{e.negated})"
    if isinstance(e, Like):
        return f"like({_canon(e.item, resolve)},{e.pattern!r},{e.negated})"
    if isinstance(e, Cast):
        return f"cast({_canon(e.item, resolve)} as {e.type_name})"
    if isinstance(e, Interval):
        return f"interval:{e.n}:{e.unit}"
    if isinstance(e, Window):
        parts = ",".join(_canon(p, resolve) for p in e.partition_by)
        orders = ",".join(f"{_canon(o, resolve)}:{a}" for o, a in e.order_by)
        return (f"win({_canon(e.func, resolve)};part={parts};"
                f"ord={orders};{e.frame})")
    if isinstance(e, _SUBQUERY):
        return f"subquery:{id(e)}"
    raise UnsupportedSqlError(f"cannot canonicalize {type(e).__name__}")


def _split_and(e) -> list:
    if isinstance(e, And):
        out = []
        for x in e.items:
            out.extend(_split_and(x))
        return out
    return [e] if e is not None else []


def _walk_exprs(e, fn):
    """Visit e and its sub-expressions (not into subqueries)."""
    if e is None:
        return
    fn(e)
    if isinstance(e, (BinOp, Cmp)):
        _walk_exprs(e.left, fn)
        _walk_exprs(e.right, fn)
    elif isinstance(e, (And, Or)):
        for x in e.items:
            _walk_exprs(x, fn)
    elif isinstance(e, (Not, Neg, IsNull, Like, Cast)):
        _walk_exprs(e.item, fn)
    elif isinstance(e, Func):
        for a in e.args:
            _walk_exprs(a, fn)
    elif isinstance(e, CaseWhen):
        for c, v in e.whens:
            _walk_exprs(c, fn)
            _walk_exprs(v, fn)
        _walk_exprs(e.else_, fn)
    elif isinstance(e, Between):
        _walk_exprs(e.item, fn)
        _walk_exprs(e.lo, fn)
        _walk_exprs(e.hi, fn)
    elif isinstance(e, InList):
        _walk_exprs(e.item, fn)
        for v in e.values:
            _walk_exprs(v, fn)
    elif isinstance(e, InSelect):
        _walk_exprs(e.item, fn)
    elif isinstance(e, Window):
        for a in e.func.args:
            _walk_exprs(a, fn)
        for p in e.partition_by:
            _walk_exprs(p, fn)
        for o, _ in e.order_by:
            _walk_exprs(o, fn)


def _render(e) -> str:
    """Spark-style output name of an unaliased expression."""
    if isinstance(e, Col):
        return e.parts[-1]
    if isinstance(e, Func):
        if e.star:
            return f"{e.name}(*)"
        d = "distinct " if e.distinct else ""
        return f"{e.name}({d}{', '.join(_render(a) for a in e.args)})"
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, BinOp):
        return f"({_render(e.left)} {e.op} {_render(e.right)})"
    return type(e).__name__.lower()


def _sub_aliases(e, alias_map):
    """Replace select-list alias references (HAVING total > 5 where total
    aliases SUM(v))."""
    if isinstance(e, Col) and len(e.parts) == 1 and e.parts[0] in alias_map:
        return alias_map[e.parts[0]]
    if isinstance(e, (BinOp, Cmp)):
        return dataclasses.replace(e, left=_sub_aliases(e.left, alias_map),
                                   right=_sub_aliases(e.right, alias_map))
    if isinstance(e, (And, Or)):
        return dataclasses.replace(e, items=tuple(
            _sub_aliases(x, alias_map) for x in e.items))
    if isinstance(e, (Not, Neg, IsNull, Cast, Like)):
        return dataclasses.replace(e, item=_sub_aliases(e.item, alias_map))
    if isinstance(e, Between):
        return dataclasses.replace(
            e, item=_sub_aliases(e.item, alias_map),
            lo=_sub_aliases(e.lo, alias_map), hi=_sub_aliases(e.hi, alias_map))
    if isinstance(e, InList):
        return dataclasses.replace(
            e, item=_sub_aliases(e.item, alias_map),
            values=tuple(_sub_aliases(v, alias_map) for v in e.values))
    if isinstance(e, Window):
        return dataclasses.replace(
            e, func=_sub_aliases(e.func, alias_map),
            partition_by=tuple(_sub_aliases(p, alias_map)
                               for p in e.partition_by),
            order_by=tuple((_sub_aliases(o, alias_map), asc)
                           for o, asc in e.order_by))
    if isinstance(e, Func):
        return dataclasses.replace(e, args=tuple(
            _sub_aliases(a, alias_map) for a in e.args))
    if isinstance(e, CaseWhen):
        return dataclasses.replace(
            e, whens=tuple((_sub_aliases(c, alias_map),
                            _sub_aliases(v, alias_map)) for c, v in e.whens),
            else_=_sub_aliases(e.else_, alias_map)
            if e.else_ is not None else None)
    return e


def _merge_null_safe(spine: DeviceSpine, left: Frame, right: Frame,
                     lk: List[str], rk: List[str], how: str = "inner"
                     ) -> Frame:
    """SQL equi-join (reference `:273`): a row with a NULL key never
    matches; the rows a preserved side (`how` "left", "right", "outer")
    loses to a NULL key are appended null-extended."""
    lnull = fv.null_rows([left[k] for k in lk])
    rnull = fv.null_rows([right[k] for k in rk])
    lm = left.filter(~lnull) if lnull.any() else left
    rm = right.filter(~rnull) if rnull.any() else right
    merged = spine.merge(lm, rm, lk, rk, how)
    extra = []
    none = np.empty(0, np.int64)
    if how in ("left", "outer") and lnull.any():
        rows = np.flatnonzero(lnull)
        extra.append(spine.gather(left, right.take(none), rows,
                                  np.full(len(rows), -1, np.int64)))
    if how in ("right", "outer") and rnull.any():
        rows = np.flatnonzero(rnull)
        extra.append(spine.gather(left.take(none), right,
                                  np.full(len(rows), -1, np.int64), rows))
    return fv.concat_frames([merged] + extra) if extra else merged


# the sides of each outer join that it can null-extend (reference `:44`)
_NULL_SUPPLYING = {"left outer": ("right",), "right outer": ("left",),
                   "full outer": ("left", "right")}
_HOW = {"inner": "inner", "left outer": "left", "right outer": "right",
        "full outer": "outer"}


class _Clock:
    """Adds the wall nanoseconds of a `with` block to a counter."""

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        self.t = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.counter.inc(time.perf_counter_ns() - self.t)


# -------------------------------------------------------- the executor --

class _Exec:
    def __init__(self, engine, catalog, ctes=None):
        self.engine = engine
        self.catalog = catalog
        # name (lower case) -> the CTE's Frame, keyed by its output names
        self.ctes = ctes if ctes is not None else {}
        self.spine = DeviceSpine(engine.device)
        self._outer_aliases: set = set()
        self._uncorrelated: Dict[int, Frame] = {}

    # -- table materialization ------------------------------------------
    def _snapshot(self, ref: TableRef):
        from delta_tpu_torch.table import Table

        if ref.kind == "path":
            from delta_tpu_torch.sql import check_path

            check_path(ref.value)
            table = Table.for_path(ref.value, self.engine)
        else:
            if self.catalog is None:
                raise CatalogTableError(
                    f"table name {ref.value!r} requires a catalog "
                    "(pass catalog=)")
            table = self.catalog.table(ref.value)
        if ref.tt_version is not None:
            return table.snapshot_at(ref.tt_version)
        if ref.tt_timestamp is not None:
            from delta_tpu_torch.sql import timestamp_ms

            return table.snapshot_as_of_timestamp(
                timestamp_ms(ref.tt_timestamp))
        return table.latest_snapshot()

    def _select_frame(self, sel) -> Frame:
        """A nested SELECT block or query under the bindings in scope, as
        a Frame keyed by its output names (repeats `name#2`, ...)."""
        if isinstance(sel, Query):
            frame, names = _run_query(sel, self.engine, self.catalog,
                                      dict(self.ctes))
        else:
            names, cols, n = _Exec(self.engine, self.catalog,
                                   self.ctes).run(sel)
            frame = _positional(cols, n)
        return frame.rekey(_unique(names))

    def run(self, sel: Select) -> Tuple[List[str], List[Column], int]:
        # ---- source inventory -----------------------------------------
        sources: List[dict] = []
        seen_aliases = set()
        for i, ref in enumerate(list(sel.froms) + [j.ref for j in sel.joins]):
            if ref.kind == "subquery":
                src = {"alias": ref.alias or f"_s{i}",
                       "frame": self._select_frame(ref.value)}
            elif ref.kind == "name" and ref.value.lower() in self.ctes:
                # a WITH binding: its Columns, shared by every reference
                src = {"alias": ref.alias or ref.value,
                       "frame": self.ctes[ref.value.lower()]}
            else:
                with _Clock(SCAN_NS):
                    snap = self._snapshot(ref)
                src = {"alias": ref.alias or (
                           ref.value.split(".")[-1] if ref.kind == "name"
                           else f"_t{i}"),
                       "snap": snap, "frame": None,
                       "cols": [f.name for f in snap.schema.fields],
                       "types": {f.name: f.type_name
                                 for f in snap.schema.fields}}
            if src["frame"] is not None:
                src["cols"] = src["frame"].names
            alias = src["alias"]
            if alias.lower() in seen_aliases:
                raise AmbiguousColumnError(f"duplicate table alias {alias!r}")
            seen_aliases.add(alias.lower())
            sources.append(src)
        join_aliases = [sources[len(sel.froms) + k]["alias"]
                        for k in range(len(sel.joins))]
        by_alias = {s["alias"]: s for s in sources}
        # case-insensitive, as Spark: SR_FEE resolves to sr_fee
        lower_alias = {s["alias"].lower(): s["alias"] for s in sources}
        col_owners: Dict[str, List[tuple]] = {}
        for s in sources:
            s["lower_cols"] = {c.lower(): c for c in s["cols"]}
            for c in s["cols"]:
                col_owners.setdefault(c.lower(), []).append((s["alias"], c))

        def resolve(col: Col) -> str:
            if len(col.parts) >= 2:
                alias = lower_alias.get(col.parts[-2].lower())
                if alias is None:
                    raise UnresolvedColumnError(
                        f"table alias {col.parts[-2]!r} not found for "
                        f"column {col.text!r}")
                actual = by_alias[alias]["lower_cols"].get(
                    col.parts[-1].lower())
                if actual is None:
                    raise UnresolvedColumnError(
                        f"column {col.text!r} not found in {alias!r}")
                return f"{alias}.{actual}"
            name = col.parts[0]
            owners = col_owners.get(name.lower(), [])
            if len(owners) == 1:
                alias, actual = owners[0]
                return f"{alias}.{actual}"
            if not owners:
                raise UnresolvedColumnError(
                    f"column {name!r} not found; not in scope of any table "
                    f"({sorted(by_alias)})")
            raise AmbiguousColumnError(
                f"column {name!r} is ambiguous (in "
                f"{[a for a, _ in owners]}); qualify it with a table alias")

        self._resolve = resolve
        self._outer_aliases = set(by_alias)

        # ---- referenced columns per alias (projection) ----------------
        needed: Dict[str, set] = {s["alias"]: set() for s in sources}
        select_star = any(isinstance(it.expr, Star) for it in sel.items)

        def note(e):
            if isinstance(e, Col):
                try:
                    phys = resolve(e)
                except DeltaError:
                    return  # raises properly during evaluation
                alias, name = phys.split(".", 1)
                needed[alias].add(name)
            elif isinstance(e, _SUBQUERY):
                # a correlated subquery's outer columns (its WHERE names
                # them) must survive the projection; its own names that
                # do not resolve here are skipped
                _walk_exprs(e.select.where,
                            lambda x: note(x) if isinstance(x, Col) else None)

        for it in sel.items:
            _walk_exprs(it.expr, note)
        for e in ([sel.where, sel.having] + sel.group_by
                  + [o for o, _ in sel.order_by] + [j.on for j in sel.joins]):
            _walk_exprs(e, note)
        if select_star:
            for s in sources:
                needed[s["alias"]] = set(s["cols"])

        # ---- pushdown -------------------------------------------------
        # a conjunct on a side an outer join can null-extend filters after
        # that join, never in the scan (reference `:494-528`)
        conjuncts = _split_and(sel.where)
        null_supplying = set()
        for k, j in enumerate(sel.joins):
            sides = _NULL_SUPPLYING.get(j.kind, ())
            if "right" in sides:
                null_supplying.add(join_aliases[k])
            if "left" in sides:
                null_supplying.update(
                    s["alias"] for s in sources[:len(sel.froms) + k])
        pushed: Dict[str, list] = {s["alias"]: [] for s in sources}
        frame_pushed: Dict[str, list] = {s["alias"]: [] for s in sources}
        for conj in conjuncts:
            target = self._sole_alias(conj, resolve)
            if not target or target in null_supplying:
                continue
            if by_alias[target]["frame"] is not None:
                # a CTE or subquery source is filtered before any join
                # (q4's six-way self-join would multiply first)
                frame_pushed[target].append(conj)
                continue
            tree = self._to_tree(conj, resolve, by_alias[target]["types"])
            if tree is not None:
                pushed[target].append(tree)

        # ---- materialize ----------------------------------------------
        applied = set()
        for s in sources:
            alias = s["alias"]
            # schema order: SELECT * presents columns in table order
            cols = [c for c in s["cols"] if c in needed[alias]] \
                or s["cols"][:1]
            if s["frame"] is not None:
                frame = s["frame"]
                frame = Frame({f"{alias}.{c}": frame[c] for c in cols},
                              len(frame))
                for conj in frame_pushed[alias]:
                    frame = self._apply_mask(
                        frame, fv.truth(self._eval(conj, frame)))
                    applied.add(id(conj))
                s["frame"] = frame
                continue
            filt = None
            for t in pushed[alias]:
                filt = t if filt is None else (filt & t)
            with _Clock(SCAN_NS):
                s["frame"] = self._scan(s["snap"], filt, cols, alias)

        # ---- joins ----------------------------------------------------
        with _Clock(JOIN_NS):
            current, consumed = self._join(
                sel, sources, by_alias, join_aliases, conjuncts, resolve,
                applied, null_supplying)

        # ---- residual WHERE -------------------------------------------
        residual = [c for c in conjuncts
                    if id(c) not in consumed and id(c) not in applied]
        if residual:
            mask = None
            for conj in residual:
                m = fv.truth(self._eval(conj, current))
                mask = m if mask is None else (mask & m)
            current = self._apply_mask(current, mask)
        return self._project(sel, current, resolve)

    def _scan(self, snap, filt, cols: List[str], alias: str) -> Frame:
        batch = snap.scan(filter=filt, columns=cols).to_batch()
        return Frame({f"{alias}.{c}": fv.from_batch_column(batch.column(c))
                      for c in cols}, batch.num_rows)

    @staticmethod
    def _apply_mask(frame: Frame, mask) -> Frame:
        if isinstance(mask, (bool, np.bool_)):
            return frame if mask else frame.head(0)
        return frame.filter(mask)

    def _join(self, sel, sources, by_alias, join_aliases, conjuncts,
              resolve, applied, null_supplying):
        """The FROM list and the JOIN clauses joined (reference
        `:560-790`). The implicit list and the leading INNER and CROSS
        joins commute: the most connected, then the smallest, table joins
        next, WHERE equi-edges counting as keys. An outer join and every
        join after it keep clause order, on their ON keys alone. A WHERE
        equi-edge or conjunct naming a side an outer join can null-extend
        never becomes a key or an early filter: it filters after the
        joins."""
        implicit = [s["alias"] for s in sources
                    if s["alias"] not in set(join_aliases)]
        edges = []   # (alias_a, col_a, alias_b, col_b, conj)
        consumed = set()

        def col_eq(c):
            if (isinstance(c, Cmp) and c.op == "="
                    and isinstance(c.left, Col) and isinstance(c.right, Col)):
                try:
                    return resolve(c.left), resolve(c.right)
                except DeltaError:
                    return None
            return None

        for conj in conjuncts:
            eq = col_eq(conj)
            if eq:
                pa_, pb_ = eq
                aa, ab = pa_.split(".", 1)[0], pb_.split(".", 1)[0]
                if aa != ab:
                    edges.append((aa, pa_, ab, pb_, conj))
            elif isinstance(conj, Or):
                # an equality common to every branch of an OR is an
                # equi-join edge (q13, q48: each branch repeats
                # `cd_demo_sk = ss_cdemo_sk`); the OR stays a filter
                branch_sets = []
                for br in conj.items:
                    eqs = set()
                    for c in _split_and(br):
                        e2 = col_eq(c)
                        if e2:
                            eqs.add(tuple(sorted(e2)))
                    branch_sets.append(eqs)
                for pa_, pb_ in (set.intersection(*branch_sets)
                                 if branch_sets else ()):
                    aa, ab = pa_.split(".", 1)[0], pb_.split(".", 1)[0]
                    if aa != ab:
                        edges.append((aa, pa_, ab, pb_, None))
        # edges on a null-supplying side stay residual filters
        edges = [e for e in edges if not ({e[0], e[2]} & null_supplying)]

        joined = set()

        def conj_aliases(conj):
            # a conjunct that holds a subquery applies after the joins
            aliases = set()
            blocked = []

            def chk(x):
                if isinstance(x, Col):
                    try:
                        aliases.add(resolve(x).split(".", 1)[0])
                    except DeltaError:
                        blocked.append(x)
                elif isinstance(x, _SUBQUERY):
                    blocked.append(x)
            _walk_exprs(conj, chk)
            return None if blocked else aliases

        def apply_eager(frame):
            for conj in conjuncts:
                if id(conj) in consumed or id(conj) in applied:
                    continue
                al = conj_aliases(conj)
                if al is None or not al or not al <= joined \
                        or al & null_supplying:
                    continue
                frame = self._apply_mask(
                    frame, fv.truth(self._eval(conj, frame)))
                applied.add(id(conj))
            return frame

        def connecting(a):
            return [(pl, pr) if al in joined else (pr, pl)
                    for (al, pl, ar, pr, c) in edges
                    if (al in joined and ar == a) or (ar in joined and al == a)]

        def consume(a):
            for (al, pl, ar, pr, c) in edges:
                if c is not None and {al, ar} <= joined | {a}:
                    consumed.add(id(c))

        first_alias = sources[0]["alias"]
        current = by_alias[first_alias]["frame"]
        joined.add(first_alias)
        current = apply_eager(current)
        remaining = [a for a in implicit if a != first_alias]
        while remaining:
            # most connecting equi-edges first, then the smallest frame
            pick = None
            best = None
            for a in remaining:
                keys = connecting(a)
                if keys:
                    score = (len(keys), -len(by_alias[a]["frame"]))
                    if best is None or score > best:
                        best, pick = score, (a, keys)
            if pick is None:  # no connecting predicate: cross join
                a = remaining[0]
                current = self.spine.cross(current, by_alias[a]["frame"])
            else:
                a, keys = pick
                current = _merge_null_safe(
                    self.spine, current, by_alias[a]["frame"],
                    [k for k, _ in keys], [k for _, k in keys])
                consume(a)
            joined.add(a)
            remaining.remove(a)
            current = apply_eager(current)

        def on_keys(a, j):
            lk, rk = [], []
            for conj in _split_and(j.on):
                if not (isinstance(conj, Cmp) and conj.op == "="
                        and isinstance(conj.left, Col)
                        and isinstance(conj.right, Col)):
                    raise UnsupportedSqlError(
                        "JOIN ON supports conjunctions of column = column "
                        f"equalities; got {_render(conj)!r}",
                        error_class="DELTA_UNSUPPORTED_JOIN_CONDITION",
                        construct="JOIN ON condition")
                pl, pr = resolve(conj.left), resolve(conj.right)
                if pl.split(".", 1)[0] == a and pr.split(".", 1)[0] != a:
                    pl, pr = pr, pl
                if pr.split(".", 1)[0] != a:
                    raise UnsupportedSqlError(
                        f"JOIN keys {pl!r}/{pr!r} do not span the two sides",
                        construct="JOIN ON condition")
                if pl.split(".", 1)[0] not in joined:
                    return None
                lk.append(pl)
                rk.append(pr)
            return lk, rk

        # the leading INNER and CROSS joins in greedy order, as the
        # implicit pool (WHERE equi-edges count as keys); an outer join
        # and everything after it keep clause order
        explicit = list(zip(join_aliases, sel.joins))
        n_prefix = 0
        while n_prefix < len(explicit) \
                and explicit[n_prefix][1].kind in ("inner", "cross"):
            n_prefix += 1
        pool, tail = explicit[:n_prefix], explicit[n_prefix:]
        while pool:
            best = None
            best_score = None
            for a, j in pool:
                if j.kind == "cross":
                    keys = connecting(a)
                else:
                    on = on_keys(a, j)
                    if on is None:
                        continue
                    keys = list(zip(on[0], on[1])) + connecting(a)
                score = (len(keys), -len(by_alias[a]["frame"]))
                if best_score is None or score > best_score:
                    best_score, best = score, (a, keys)
            if best is None:
                raise UnsupportedSqlError(
                    "JOIN ON ordering is unsatisfiable: every remaining "
                    "join references aliases joined later",
                    construct="JOIN ON order")
            a, keys = best
            if keys:
                current = _merge_null_safe(
                    self.spine, current, by_alias[a]["frame"],
                    [l for l, _ in keys], [r for _, r in keys])
                consume(a)
            else:
                current = self.spine.cross(current, by_alias[a]["frame"])
            joined.add(a)
            pool = [(pa, pj) for pa, pj in pool if pa != a]
            current = apply_eager(current)
        for a, j in tail:
            right = by_alias[a]["frame"]
            if j.kind == "cross":
                current = self.spine.cross(current, right)
            else:
                on = on_keys(a, j)
                if on is None:
                    raise UnsupportedSqlError(
                        f"JOIN ON for {a!r} references aliases joined "
                        "after it", construct="JOIN ON order")
                current = _merge_null_safe(self.spine, current, right,
                                           on[0], on[1], _HOW[j.kind])
            joined.add(a)
            current = apply_eager(current)
        return current, consumed

    # -- projection / aggregation / order -------------------------------
    def _project(self, sel: Select, df: Frame, resolve):
        has_agg = any(_has_agg(e) for e in [it.expr for it in sel.items]
                      + [sel.having] + [o for o, _ in sel.order_by])
        if sel.having is not None and not sel.group_by and not has_agg:
            raise SqlParseError(
                "HAVING without GROUP BY requires an aggregate",
                error_class="DELTA_HAVING_WITHOUT_GROUP_BY")

        alias_map = {it.alias: it.expr for it in sel.items if it.alias}
        env = None
        if has_agg or sel.group_by:
            with _Clock(GROUP_NS):
                df, env = self._aggregate(sel, df, resolve)
        n = len(df)

        out_cols: List = []
        out_names: List[str] = []
        for item_idx, it in enumerate(sel.items):
            if isinstance(it.expr, Star):
                if env is not None:
                    raise SqlParseError(
                        "SELECT * cannot combine with GROUP BY/aggregates",
                        error_class="DELTA_STAR_WITH_AGGREGATE")
                for c in df.names:
                    out_cols.append(df[c])
                    out_names.append(c.split(".", 1)[1] if "." in c else c)
                continue
            # lateral aliases (Spark): an item may name an earlier item's
            # alias, unless a source column of that name exists
            expr = it.expr
            lateral = {}
            for prev in sel.items[:item_idx]:
                if not prev.alias:
                    continue
                try:
                    resolve(Col((prev.alias,)))
                    continue
                except DeltaError:
                    lateral[prev.alias] = prev.expr
            if lateral:
                expr = _sub_aliases(expr, lateral)
            out_cols.append(fv.broadcast(self._eval_out(expr, df, env,
                                                        resolve), n))
            if it.alias:
                out_names.append(it.alias)
            elif isinstance(it.expr, Col):
                out_names.append(it.expr.parts[-1])
            elif isinstance(it.expr, Func):
                out_names.append(_render(it.expr))
            else:
                out_names.append(it.text or _render(it.expr))

        # HAVING
        if sel.having is not None:
            mask = fv.truth(self._eval_out(_sub_aliases(sel.having, alias_map),
                                           df, env, resolve))
            if isinstance(mask, (bool, np.bool_)):
                mask = np.full(n, bool(mask))
            keep = np.flatnonzero(mask)
            df = df.take(keep)
            out_cols = [c.take(keep) for c in out_cols]
            n = len(df)

        if sel.distinct and out_cols:
            from delta_tpu_torch.sqlengine.device import group_codes

            _, _, first = group_codes(out_cols)
            keep = np.sort(first)
            df = df.take(keep)
            out_cols = [c.take(keep) for c in out_cols]
            n = len(keep)

        # ORDER BY
        if sel.order_by:
            keys, ascs = [], []
            for e, asc in sel.order_by:
                if isinstance(e, Col) and len(e.parts) == 1 \
                        and e.parts[0] in alias_map \
                        and e.parts[0] in out_names:
                    # an alias: its output column (a window in it is not
                    # evaluated twice)
                    keys.append(out_cols[out_names.index(e.parts[0])])
                    ascs.append(asc)
                    continue
                e = _sub_aliases(e, alias_map)
                s = None
                if isinstance(e, Lit) and isinstance(e.value, int) \
                        and not isinstance(e.value, bool) \
                        and 1 <= e.value <= len(out_names):
                    s = out_cols[e.value - 1]  # ORDER BY 2, 1, 3
                elif isinstance(e, Col) and len(e.parts) == 1 \
                        and e.parts[0] in out_names:
                    s = out_cols[out_names.index(e.parts[0])]
                if s is None:
                    s = fv.broadcast(self._eval_out(e, df, env, resolve), n)
                keys.append(s)
                ascs.append(asc)
            with _Clock(SORT_NS):
                perm = self.spine.sort_permutation(keys, ascs)
            out_cols = [c.take(perm) for c in out_cols]

        if sel.limit is not None:
            n = min(n, sel.limit)
            out_cols = [c.slice(0, n) for c in out_cols]
        return out_names, out_cols, n

    def _aggregate(self, sel: Select, df: Frame, resolve):
        """GROUP BY (reference `:927-1055`): the aggregates of each group
        through K10, DISTINCT ones over each group's distinct values. With
        GROUP BY ROLLUP (k1, ..., kn) every key prefix, from the longest
        to the empty one, is aggregated and the levels are stacked: a
        rolled-up key is NULL and `grouping(k)` is 1 on its rows, else
        0."""
        canon = lambda e: _canon(e, resolve)  # noqa: E731
        key_exprs = list(sel.group_by)
        rollup = len(key_exprs) == 1 and isinstance(key_exprs[0], Func) \
            and key_exprs[0].name == "rollup"
        if rollup:
            key_exprs = list(key_exprs[0].args)
        key_names, key_cols = [], []
        for e in key_exprs:
            k = canon(e)
            if k in key_names:
                continue
            key_names.append(k)
            key_cols.append(fv.broadcast(self._eval(e, df), len(df)))

        agg_specs: Dict[str, Func] = {}

        def collect(e):
            if isinstance(e, Func) and e.name in _AGGS:
                agg_specs.setdefault(canon(e), e)

        for it in sel.items:
            _walk_exprs(it.expr, collect)
        _walk_exprs(sel.having, collect)
        for o, _ in sel.order_by:
            _walk_exprs(o, collect)

        specs = []
        for k, f in agg_specs.items():
            if f.star:
                if f.name != "count":
                    raise SqlParseError(
                        f"* argument is only allowed in count(*), not "
                        f"{f.name}(*)")
                specs.append((f.name, None, False))
                continue
            if len(f.args) != 1:
                raise SqlParseError(f"{f.name} takes exactly one argument")
            specs.append((f.name, fv.broadcast(self._eval(f.args[0], df),
                                               len(df)), f.distinct))
        if not rollup:
            out_keys, aggs = self.spine.groupby(key_cols, specs, len(df))
            cols = dict(zip(key_names, out_keys))
            cols.update(zip(agg_specs, aggs))
            n = len(out_keys[0]) if key_cols else 1
            return Frame(cols, n), set(cols)
        frames = []
        for level, out_keys, aggs in self._rollup_levels(key_cols, specs,
                                                         len(df)):
            n = len(out_keys[0]) if level else 1
            cols = {}
            for j, name in enumerate(key_names):
                cols[name] = out_keys[j] if j < level else \
                    Column.nulls(key_cols[j].values.dtype, n)
            cols.update(zip(agg_specs, aggs))
            for j, name in enumerate(key_names):
                cols[f"grouping({name})"] = Column(
                    np.full(n, int(j >= level), np.int64))
            frames.append(Frame(cols, n))
        out = fv.concat_frames(frames)
        return out, set(out.cols)

    def _rollup_levels(self, key_cols: List[Column], specs: List[tuple],
                       n_rows: int):
        """(level, the level's key Columns, its aggregates) of GROUP BY
        ROLLUP, from the longest key prefix to the empty one. The longest
        aggregates the rows. Where every aggregate is a plain SUM, COUNT,
        MIN, MAX or AVG, each shorter prefix aggregates the groups of the
        level before it (sums of sums and of counts, the least of minima,
        AVG from its sum and count), through K10 like the rows: a group
        with one child takes the child's value bit for bit, so a tie that
        exact arithmetic makes across levels (q67 ranks across them) is a
        tie on the card too, whatever order its atomics summed the rows
        in. Otherwise (a DISTINCT aggregate, a variance) each level
        aggregates the rows."""
        plain = all(not d and name in ("sum", "count", "min", "max", "avg")
                    for name, _, d in specs)
        ext = list(specs)
        hidden = {}  # avg spec index -> (its sum's index, its count's)
        if plain:
            for i, (name, arg, _) in enumerate(specs):
                if name == "avg":
                    hidden[i] = (len(ext), len(ext) + 1)
                    ext.append(("sum", Column(arg.values.astype(np.float64),
                                              arg.valid), False))
                    ext.append(("count", arg, False))
        level = len(key_cols)
        keys, aggs = self.spine.groupby(key_cols, ext, n_rows)
        yield level, keys, aggs[:len(specs)]
        for level in range(level - 1, -1, -1):
            if not plain:
                keys, aggs = self.spine.groupby(key_cols[:level], specs,
                                                n_rows)
                yield level, keys, aggs
                continue
            # an AVG's own column is not rolled up: its sum and count are
            rolled = [i for i in range(len(ext)) if i not in hidden]
            ops = [ext[i][0] if ext[i][0] in ("min", "max") else "sum"
                   for i in rolled]
            keys, got = self.spine.groupby(
                keys[:level], [(op, aggs[i], False)
                               for op, i in zip(ops, rolled)],
                len(keys[0]))
            aggs = [None] * len(ext)
            for i, col in zip(rolled, got):
                aggs[i] = col
            for i, (name, _, _) in enumerate(ext):
                if name == "count":  # a sum of no counts is 0
                    aggs[i] = Column(np.where(fv.valid_of(aggs[i]),
                                              aggs[i].values, 0))
            for i, (si, ci) in hidden.items():
                total, count = aggs[si], aggs[ci]
                with np.errstate(all="ignore"):
                    mean = total.values / np.maximum(count.values, 1)
                aggs[i] = fv.column(mean, count.values > 0)
            yield level, keys, aggs[:len(specs)]

    def _eval_out(self, e, df: Frame, env, resolve):
        """Evaluate in the post-aggregation environment when there is
        one, else in the row environment."""
        if env is None:
            return self._eval(e, df)
        canon = _canon(e, resolve)
        if canon in env:
            return df[canon]
        ev = lambda x: self._eval_out(x, df, env, resolve)  # noqa: E731
        if isinstance(e, Col):
            raise SqlParseError(
                f"column {e.text!r} in SELECT/HAVING/ORDER BY must appear in "
                "GROUP BY or inside an aggregate")
        if isinstance(e, Func) and e.name in _AGGS:
            raise UnsupportedSqlError(f"aggregate {e.name} not computed")
        if isinstance(e, Window):
            return self._window_eval(e, df, ev)
        if isinstance(e, ScalarSelect):
            # over aggregated rows (HAVING sum(x) > (SELECT ...)): only an
            # uncorrelated scalar, as in the reference (`:1186`)
            if self._correlation(e.select):
                raise UnsupportedSqlError(
                    "correlated scalar subquery over an aggregated result "
                    "is not supported",
                    error_class="DELTA_UNSUPPORTED_CORRELATED_SUBQUERY",
                    construct="correlated subquery after GROUP BY")
            return self._scalar_value(e.select)
        return self._eval_node(e, df, ev)

    # -- row-environment evaluation -------------------------------------
    def _eval(self, e, df: Frame):
        if isinstance(e, Col):
            return df[self._resolve(e)]
        if isinstance(e, Func) and e.name in _AGGS:
            raise SqlParseError(
                f"aggregate {e.name}(...) is not allowed here",
                error_class="DELTA_AGGREGATION_NOT_SUPPORTED")
        if isinstance(e, Star):
            raise SqlParseError("* is only allowed as a lone select item")
        if isinstance(e, _SUBQUERY):
            return self._eval_subquery(e, df)
        if isinstance(e, Window):
            return self._window_eval(e, df, lambda x: self._eval(x, df))
        return self._eval_node(e, df, lambda x: self._eval(x, df))

    # -- windows ----------------------------------------------------------
    def _window_eval(self, e: Window, df: Frame, ev) -> Column:
        """A window function over `df`'s rows (reference `_window_eval`,
        `:1702-1806`); `ev` evaluates its expressions in the caller's
        environment (rows, or aggregated rows). SUM, AVG, MIN, MAX and
        COUNT without ORDER BY: per partition through K10
        (`DeviceSpine.partition_transform`); with ORDER BY: running, K11
        (`window_running`); row_number, rank and dense_rank: K11
        (`window_rank`). Both sort on the card."""
        _check_window(e)
        n = len(df)
        name = e.func.name
        parts = [fv.broadcast(ev(p), n) for p in e.partition_by]
        items = [(fv.broadcast(ev(o), n), asc) for o, asc in e.order_by]
        if name in _RANKS:
            return self.spine.window_rank(parts, items, name, n)
        if e.func.star:
            if name != "count":
                raise SqlParseError(
                    f"* argument is only allowed in count(*), not "
                    f"{name}(*)")
            arg = None
        else:
            if len(e.func.args) != 1:
                raise SqlParseError(f"{name} takes exactly one argument")
            arg = fv.broadcast(ev(e.func.args[0]), n)
        if items:
            return self.spine.window_running(parts, items, name, arg,
                                             e.frame, n)
        return self.spine.partition_transform(parts, name, arg, n)

    @staticmethod
    def _eval_node(e, df: Frame, ev):
        """The operators of both environments; `ev` evaluates children."""
        n = len(df)
        if isinstance(e, Lit):
            return e.value
        if isinstance(e, Neg):
            return fv.neg(ev(e.item))
        if isinstance(e, BinOp):
            return fv.binop(e.op, ev(e.left), ev(e.right))
        if isinstance(e, Cmp):
            return fv.compare(e.op, ev(e.left), ev(e.right))
        if isinstance(e, And):
            out = None
            for x in e.items:
                m = fv.kleene(ev(x), n)
                out = m if out is None else fv.k_and(out, m)
            return out
        if isinstance(e, Or):
            out = None
            for x in e.items:
                m = fv.kleene(ev(x), n)
                out = m if out is None else fv.k_or(out, m)
            return out
        if isinstance(e, Not):
            return fv.k_not(fv.kleene(ev(e.item), n))
        if isinstance(e, IsNull):
            return fv.is_null_test(ev(e.item), e.negated)
        if isinstance(e, Between):
            v = ev(e.item)
            m = fv.k_and(fv.kleene(fv.compare(">=", v, ev(e.lo)), n),
                         fv.kleene(fv.compare("<=", v, ev(e.hi)), n))
            return fv.k_not(m) if e.negated else m
        if isinstance(e, InList):
            m = fv.kleene(fv.in_list(ev(e.item), [ev(x) for x in e.values],
                                     n), n)
            return fv.k_not(m) if e.negated else m
        if isinstance(e, Like):
            m = fv.kleene(fv.like(ev(e.item), e.pattern), n)
            return fv.k_not(m) if e.negated else m
        if isinstance(e, CaseWhen):
            conds = [fv.truth(ev(c)) for c, _ in e.whens]
            conds = [c if isinstance(c, np.ndarray) else np.full(n, bool(c))
                     for c in conds]
            vals = [ev(v) for _, v in e.whens]
            default = ev(e.else_) if e.else_ is not None else None
            return fv.case_when(conds, vals, default, n)
        if isinstance(e, Cast):
            return fv.cast(ev(e.item), e.type_name)
        if isinstance(e, Interval):
            return np.timedelta64(e.n, "D")
        if isinstance(e, Func):
            if e.star:
                raise SqlParseError(
                    f"* argument is only allowed in count(*), not "
                    f"{e.name}(*)")
            return fv.apply_func(e.name, [ev(a) for a in e.args], n)
        raise UnsupportedSqlError(
            f"unsupported expression {type(e).__name__}",
            construct=type(e).__name__)

    # -- subqueries -----------------------------------------------------
    def _eval_subquery(self, e, df: Frame):
        """A subquery in the row environment (reference `_eval`
        `:1291-1330`): correlated ones are decorrelated, uncorrelated ones
        run once per executor."""
        corr = self._correlation(e.select)
        if isinstance(e, ScalarSelect):
            if corr:
                return self._correlated_scalar(e.select, corr, df)
            return self._scalar_value(e.select)
        if isinstance(e, InSelect):
            if corr:
                m = self._correlated_semi(e.select, corr, df, item=e.item)
            else:
                rows = self._uncorrelated_frame(e.select)
                if len(rows.cols) != 1:
                    raise SqlParseError("IN subquery must return one column")
                m = _in_membership(self.spine, fv.broadcast(
                    self._eval(e.item, df), len(df)), rows.column_at(0))
            return fv.k_not(m) if e.negated else m
        if corr:  # EXISTS
            m = self._correlated_semi(e.select, corr, df)
            return fv.k_not(m) if e.negated else m
        flag = len(self._uncorrelated_frame(e.select)) > 0
        return (not flag) if e.negated else flag

    def _uncorrelated_frame(self, sub: Select) -> Frame:
        got = self._uncorrelated.get(id(sub))
        if got is None:
            got = self._uncorrelated[id(sub)] = self._select_frame(sub)
        return got

    def _scalar_value(self, sub: Select):
        rows = self._uncorrelated_frame(sub)
        if len(rows.cols) != 1:
            raise SqlParseError("scalar subquery must return one column")
        if len(rows) > 1:
            raise SubqueryShapeError(
                f"scalar subquery returned {len(rows)} rows, not one")
        if not len(rows):
            return None
        return _scalar_of(rows.column_at(0))

    @staticmethod
    def _inner_aliases(sub: Select) -> set:
        out = set()
        for ref in list(sub.froms) + [j.ref for j in sub.joins]:
            if ref.alias:
                out.add(ref.alias.lower())
            elif ref.kind == "name":
                out.add(ref.value.split(".")[-1].lower())
        return out

    def _inner_columns(self, sub: Select) -> set:
        """The lower-case column names of the subquery's own sources (a
        schema read; snapshots cache their metadata)."""
        out = set()
        for ref in list(sub.froms) + [j.ref for j in sub.joins]:
            try:
                if ref.kind == "subquery":
                    inner = ref.value.selects[0] \
                        if isinstance(ref.value, Query) else ref.value
                    for it in inner.items:
                        if it.alias:
                            out.add(it.alias.lower())
                        elif isinstance(it.expr, Col):
                            out.add(it.expr.parts[-1].lower())
                elif ref.kind == "name" and ref.value.lower() in self.ctes:
                    out |= {c.lower()
                            for c in self.ctes[ref.value.lower()].names}
                else:
                    snap = self._snapshot(ref)
                    if snap.schema is not None:
                        out |= {f.name.lower() for f in snap.schema.fields}
            except (DeltaError, OSError):
                pass  # an unknown source: its columns are unknown
        return out

    def _correlation(self, sub: Select) -> Optional["_CorrInfo"]:
        """The subquery's equality correlation (reference `:1379`): WHERE
        conjuncts `outer.col = inner_col`, the outer side qualified by an
        outer alias (q1, q30, q81) or a bare name only the outer scope
        has (q32, q92's `i_item_sk`); an equality repeated in every
        branch of an OR is factored out (q41); other conjuncts naming an
        outer column are residuals, applied after the semi-join's pairs.
        None when uncorrelated; raises where outer references have no
        equality to decorrelate on."""
        inner = self._inner_aliases(sub)
        outer = {a.lower() for a in self._outer_aliases}
        inner_cols = None  # read when first needed

        def is_outer(c) -> bool:
            nonlocal inner_cols
            if not isinstance(c, Col):
                return False
            if len(c.parts) >= 2:
                return (c.parts[-2].lower() not in inner
                        and c.parts[-2].lower() in outer)
            # a bare name is outer only where the subquery's sources do
            # not have it and the outer scope resolves it
            if inner_cols is None:
                inner_cols = self._inner_columns(sub)
            if c.parts[0].lower() in inner_cols:
                return False
            try:
                self._resolve(c)
                return True
            except DeltaError:
                return False

        def outer_eq(conj):
            if (isinstance(conj, Cmp) and conj.op == "="
                    and isinstance(conj.left, Col)
                    and isinstance(conj.right, Col)):
                lo, ro = is_outer(conj.left), is_outer(conj.right)
                if lo != ro:
                    return ((conj.left, conj.right) if lo
                            else (conj.right, conj.left))
            return None

        corr = []        # [(outer Col, inner Col)]
        residual = []    # conjuncts naming outer columns, not equalities
        where_rest = []  # the inner-only conjuncts (OR-factored ones rebuilt)
        for conj in _split_and(sub.where):
            eq = outer_eq(conj)
            if eq:
                corr.append(eq)
                continue
            if isinstance(conj, Or):
                branch_splits = [_split_and(b) for b in conj.items]
                common = next(
                    (cand for cand in branch_splits[0]
                     if outer_eq(cand)
                     and all(cand in bs for bs in branch_splits)), None)
                if common is not None:
                    leftover = []
                    for bs in branch_splits:
                        for c in bs:
                            if c != common:
                                _walk_exprs(c, lambda x: leftover.append(x)
                                            if is_outer(x) else None)
                    if leftover:
                        residual.append(conj)
                        continue
                    corr.append(outer_eq(common))
                    branches = []
                    for bs in branch_splits:
                        rest = tuple(c for c in bs if c != common)
                        if not rest:
                            # a branch that was only the equality: the OR
                            # holds wherever the key matches
                            branches = None
                            break
                        branches.append(rest[0] if len(rest) == 1
                                        else And(rest))
                    if branches is not None:
                        where_rest.append(Or(tuple(branches)))
                    continue
            has_outer = []
            _walk_exprs(conj, lambda x: has_outer.append(x)
                        if is_outer(x) else None)
            (residual if has_outer else where_rest).append(conj)
        if not corr:
            if residual:
                raise UnsupportedSqlError(
                    "correlated subquery has outer references but no "
                    "equality correlation to decorrelate on",
                    error_class="DELTA_UNSUPPORTED_CORRELATED_SUBQUERY",
                    construct="correlated subquery without an equality")
            return None
        return _CorrInfo(corr, where_rest, residual, is_outer)

    def _decorrelated_frame(self, sub: Select, info: "_CorrInfo",
                            extra_items: List[SelectItem],
                            aggregate: bool) -> Tuple[Frame, List[str]]:
        """`sub` without its correlation conjuncts, its inner correlation
        columns as `__ck0`, `__ck1`, ...: the GROUP BY keys (aggregate:
        K10 reduces each group) or distinct output columns. Returns (the
        Frame, the key names)."""
        if sub.group_by or sub.having:
            raise UnsupportedSqlError(
                "correlated subquery with its own GROUP BY/HAVING is not "
                "supported",
                error_class="DELTA_UNSUPPORTED_CORRELATED_SUBQUERY",
                construct="correlated subquery with GROUP BY")
        where = None
        if info.where_rest:
            where = info.where_rest[0] if len(info.where_rest) == 1 \
                else And(tuple(info.where_rest))
        keys = [f"__ck{k}" for k in range(len(info.corr))]
        inner_sel = Select(
            items=[SelectItem(i, alias=k)
                   for k, (_o, i) in zip(keys, info.corr)] + extra_items,
            froms=list(sub.froms), joins=list(sub.joins), where=where,
            group_by=[i for _o, i in info.corr] if aggregate else [],
            distinct=not aggregate)
        names, cols, n = _Exec(self.engine, self.catalog,
                               self.ctes).run(inner_sel)
        return Frame(dict(zip(_unique(names), cols)), n), keys

    def _outer_keys(self, info: "_CorrInfo", df: Frame) -> List[Column]:
        return [fv.broadcast(self._eval(o, df), len(df))
                for o, _i in info.corr]

    def _correlated_scalar(self, sub: Select, info: "_CorrInfo",
                           df: Frame) -> Column:
        """Per outer row, the aggregate of the inner rows of its key: the
        decorrelated subquery grouped by its correlation columns on the
        card (K10), then a left join of the outer key tuples against the
        groups (`DeviceSpine.lookup`). A key with no group takes the
        aggregate of no rows (COUNT 0, else NULL); a NULL outer key
        NULL."""
        if info.residual:
            raise UnsupportedSqlError(
                "correlated scalar subquery with non-equality outer "
                "references is not supported",
                error_class="DELTA_UNSUPPORTED_CORRELATED_SUBQUERY",
                construct="correlated scalar subquery with a residual")
        if len(sub.items) != 1 or isinstance(sub.items[0].expr, Star):
            raise SqlParseError("scalar subquery must return one column")
        val_item = SelectItem(sub.items[0].expr, alias="__cv")
        if not _has_agg(val_item.expr):
            raise UnsupportedSqlError(
                "correlated scalar subquery must aggregate (else it may "
                "return more than one row per outer row)",
                error_class="DELTA_UNSUPPORTED_CORRELATED_SUBQUERY",
                construct="correlated scalar subquery without an aggregate")
        groups, keys = self._decorrelated_frame(sub, info, [val_item],
                                                aggregate=True)
        outer = self._outer_keys(info, df)
        idx = self.spine.lookup(outer, [groups[k] for k in keys])
        cv = groups["__cv"]
        hit = idx >= 0
        if len(cv):
            at = np.where(hit, idx, 0)
            values, valid = cv.values[at], hit & fv.valid_of(cv)[at]
        else:
            values, valid = np.zeros(len(df), cv.values.dtype), hit
        default = self._empty_agg_value(val_item.expr)
        if default is not None:
            fill = ~hit & ~fv.null_rows(outer)
            values[fill] = default
            valid = valid | fill
        return fv.column(values, valid)

    def _empty_agg_value(self, expr):
        """The value of an aggregate expression over no rows: COUNT 0,
        any other aggregate NULL, constants folded through; None where it
        does not fold."""
        def sub(e):
            if isinstance(e, Func) and e.name in _AGGS:
                return Lit(0) if e.name == "count" else Lit(None)
            if isinstance(e, (BinOp, Cmp)):
                return dataclasses.replace(e, left=sub(e.left),
                                           right=sub(e.right))
            if isinstance(e, (Neg, Cast)):
                return dataclasses.replace(e, item=sub(e.item))
            return e
        try:
            v = self._eval(sub(expr), Frame({}, 0))
        except (DeltaError, KeyError, TypeError, ValueError):
            return None  # not a constant: NULL, as the reference has it
        return None if fv.is_col(v) or fv.is_null(v) else v

    def _correlated_semi(self, sub: Select, info: "_CorrInfo", df: Frame,
                         item=None) -> Column:
        """EXISTS, or IN with `item`, against a correlated subquery: semi-
        joins of the outer key tuples against the decorrelated subquery's
        distinct rows (`DeviceSpine.member`). Three-valued IN: a NULL in
        a key's inner values makes a miss NULL, a NULL item against a key
        with inner rows is NULL; a NULL outer key makes EXISTS and IN
        false."""
        if info.residual:
            if item is not None:
                raise UnsupportedSqlError(
                    "correlated IN with non-equality outer references is "
                    "not supported",
                    error_class="DELTA_UNSUPPORTED_CORRELATED_SUBQUERY",
                    construct="correlated IN with a residual")
            return self._correlated_exists_residual(sub, info, df)
        extra = []
        if item is not None:
            if len(sub.items) != 1 or isinstance(sub.items[0].expr, Star):
                raise SqlParseError("IN subquery must return one column")
            extra = [SelectItem(sub.items[0].expr, alias="__cv")]
        inner, keys = self._decorrelated_frame(sub, info, extra,
                                               aggregate=False)
        outer = self._outer_keys(info, df)
        inner_keys = [inner[k] for k in keys]
        if item is None:
            return Column(self.spine.member(outer, inner_keys))
        seen = self.spine.member(outer, inner_keys)
        cv = inner["__cv"]
        ok = fv.valid_of(cv)
        v = fv.broadcast(self._eval(item, df), len(df))
        with_value = np.flatnonzero(ok)
        hit = self.spine.member(outer + [v],
                                [k.take(with_value) for k in inner_keys]
                                + [cv.take(with_value)])
        null_value = np.flatnonzero(~ok)
        has_null = self.spine.member(outer, [k.take(null_value)
                                             for k in inner_keys]) \
            if len(null_value) else np.zeros(len(df), bool)
        unknown = seen & ~hit & (~fv.valid_of(v) | has_null)
        return fv.column(hit, ~unknown)

    def _correlated_exists_residual(self, sub: Select, info: "_CorrInfo",
                                    df: Frame) -> Column:
        """EXISTS with equality correlation and residual conjuncts naming
        outer columns (q94's `<>`): the outer key tuples joined to the
        decorrelated inner rows, the residuals applied to the pairs, then
        reduced per outer row."""
        inner_cols, outer_cols = [], []

        def reg(c):
            if not isinstance(c, Col):
                return
            side = outer_cols if info.is_outer(c) else inner_cols
            if c not in side:
                side.append(c)

        for rc in info.residual:
            _walk_exprs(rc, reg)
        extra = [SelectItem(c, alias=f"__rin_{j}")
                 for j, c in enumerate(inner_cols)]
        inner, keys = self._decorrelated_frame(sub, info, extra,
                                               aggregate=False)
        n = len(df)
        cols = {k: c for k, c in zip(keys, self._outer_keys(info, df))}
        for j, c in enumerate(outer_cols):
            cols[f"__out_{j}"] = fv.broadcast(self._eval(c, df), n)
        cols["__rowid"] = Column(np.arange(n, dtype=np.int64))
        inner_keys = [f"__ick{k}" for k in range(len(keys))]
        inner = inner.rekey(inner_keys + inner.names[len(keys):])
        with _Clock(JOIN_NS):
            pairs = _merge_null_safe(self.spine, Frame(cols, n), inner,
                                     keys, inner_keys)

        def flat(c):
            if info.is_outer(c):
                return Col((f"__out_{outer_cols.index(c)}",))
            return Col((f"__rin_{inner_cols.index(c)}",))

        outer_resolve = self._resolve
        self._resolve = lambda col: col.parts[-1]
        try:
            mask = np.ones(len(pairs), bool)
            for rc in info.residual:
                m = fv.truth(self._eval(_rewrite_cols(rc, flat), pairs))
                mask &= m if isinstance(m, np.ndarray) else bool(m)
        finally:
            self._resolve = outer_resolve
        flags = np.zeros(n, bool)
        flags[pairs["__rowid"].values[mask]] = True
        return Column(flags)

    # -- pushdown helpers ------------------------------------------------
    @staticmethod
    def _sole_alias(conj, resolve) -> Optional[str]:
        aliases = set()
        bad = False

        def note(e):
            nonlocal bad
            if isinstance(e, Col):
                try:
                    aliases.add(resolve(e).split(".", 1)[0])
                except DeltaError:
                    bad = True
            elif isinstance(e, _SUBQUERY):
                bad = True  # never pushed into a scan or a source

        _walk_exprs(conj, note)
        if bad or len(aliases) != 1:
            return None
        return next(iter(aliases))

    @staticmethod
    def _to_tree(conj, resolve, types: Dict[str, str]):
        """The conjunct in the scan's expression tree (file pruning), or
        None for a shape it cannot take, or where a literal's type does
        not match its column's (a string against a date column): those
        the executor's own coercions apply after the scan, as it applies
        every conjunct."""
        from delta_tpu_torch.expressions import col as t_col, lit as t_lit

        def name(c: Col) -> str:
            return resolve(c).split(".", 1)[1]

        def fits(c: Col, v) -> bool:
            if isinstance(v, float) and v != v:
                return False
            t = types.get(name(c))
            if isinstance(v, bool):
                return t == "boolean"
            if isinstance(v, (int, float)):
                return t in _NUMERIC_TYPES
            if isinstance(v, str):
                return t == "string"
            return False

        def conv(e):
            if isinstance(e, Cmp):
                l, r = e.left, e.right
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                        "=": "=", "<>": "<>"}
                op = e.op
                if isinstance(r, Col) and isinstance(l, Lit):
                    l, r, op = r, l, flip[e.op]
                if not (isinstance(l, Col) and isinstance(r, Lit)) \
                        or not fits(l, r.value):
                    return None
                c, v = t_col(name(l)), t_lit(r.value)
                return {"=": c == v, "<>": c != v, "<": c < v, "<=": c <= v,
                        ">": c > v, ">=": c >= v}[op]
            if isinstance(e, Between) and not e.negated:
                lo = conv(Cmp(">=", e.item, e.lo))
                hi = conv(Cmp("<=", e.item, e.hi))
                return lo & hi if lo is not None and hi is not None \
                    else None
            if isinstance(e, InList) and not e.negated:
                if isinstance(e.item, Col) and e.values and all(
                        isinstance(v, Lit) and fits(e.item, v.value)
                        for v in e.values):
                    return t_col(name(e.item)).is_in(
                        *[v.value for v in e.values])
                return None
            if isinstance(e, (And, Or)):
                out = None
                for x in e.items:
                    c = conv(x)
                    if c is None:
                        return None
                    out = c if out is None else (
                        out & c if isinstance(e, And) else out | c)
                return out
            return None

        return conv(conj)


class _CorrInfo:
    """A correlated subquery's decorrelation: its equality pairs (outer
    Col, inner Col), the inner-only WHERE rest (OR-factored equalities
    taken out) and the residual conjuncts naming outer columns."""

    def __init__(self, corr, where_rest, residual, is_outer):
        self.corr = corr
        self.where_rest = where_rest
        self.residual = residual
        self.is_outer = is_outer

    def __bool__(self):
        return bool(self.corr)


def _has_agg(e) -> bool:
    found = []
    _walk_exprs(e, lambda x: found.append(x)
                if isinstance(x, Func) and x.name in _AGGS else None)
    return bool(found)


def _rewrite_cols(e, fn):
    """`e` rebuilt with every Col node replaced by fn(col)."""
    if isinstance(e, Col):
        return fn(e)
    if isinstance(e, (BinOp, Cmp)):
        return dataclasses.replace(e, left=_rewrite_cols(e.left, fn),
                                   right=_rewrite_cols(e.right, fn))
    if isinstance(e, (And, Or)):
        return dataclasses.replace(
            e, items=tuple(_rewrite_cols(x, fn) for x in e.items))
    if isinstance(e, (Not, Neg, IsNull, Like, Cast)):
        return dataclasses.replace(e, item=_rewrite_cols(e.item, fn))
    if isinstance(e, Between):
        return dataclasses.replace(
            e, item=_rewrite_cols(e.item, fn), lo=_rewrite_cols(e.lo, fn),
            hi=_rewrite_cols(e.hi, fn))
    if isinstance(e, InList):
        return dataclasses.replace(
            e, item=_rewrite_cols(e.item, fn),
            values=tuple(_rewrite_cols(v, fn) for v in e.values))
    if isinstance(e, Func):
        return dataclasses.replace(
            e, args=tuple(_rewrite_cols(a, fn) for a in e.args))
    if isinstance(e, CaseWhen):
        return dataclasses.replace(
            e, whens=tuple((_rewrite_cols(c, fn), _rewrite_cols(v, fn))
                           for c, v in e.whens),
            else_=_rewrite_cols(e.else_, fn) if e.else_ is not None
            else None)
    cols = []
    _walk_exprs(e, lambda x: cols.append(x) if isinstance(x, Col) else None)
    if cols:
        raise UnsupportedSqlError(
            f"unsupported expression {type(e).__name__} in a correlated "
            "residual predicate", construct=type(e).__name__)
    return e


def _in_membership(spine: DeviceSpine, v: Column, values: Column) -> Column:
    """`v IN (values)`, three-valued (reference `:2133`): NULL for a NULL
    item, a miss NULL where the values hold a NULL; the membership test a
    semi-join on the card."""
    ok = fv.valid_of(values)
    hit = spine.member([v], [values.take(np.flatnonzero(ok))])
    valid = fv.valid_of(v) & (hit | bool(ok.all()))
    return fv.column(hit, valid)


def _scalar_of(c: Column):
    """Row 0 of a Column as the executor's scalar: a Python number, str
    or bool, a numpy datetime64, or None."""
    if c.valid is not None and not c.valid[0]:
        return None
    v = c.values[0]
    if isinstance(v, np.generic) and v.dtype.kind in "biuf":
        return v.item()
    return v

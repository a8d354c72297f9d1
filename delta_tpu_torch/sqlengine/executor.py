"""SELECT executor: name resolution, scan pushdown, join planning,
evaluation over the port's Columns, aggregation, ordering.

Counterpart of `delta_tpu/sqlengine/executor.py` for one SELECT block
(`execute_select` `:50`, `_run_query` `:63`, `_Exec.run` `:379`):

1. Every table reference resolves to a Delta snapshot (a path, or a name
   through the catalog, with VERSION / TIMESTAMP AS OF), the referenced
   columns of each are collected, and each is scanned with that
   projection and the WHERE conjuncts that name it alone pushed into
   `Snapshot.scan(filter=...)` (partition pruning, and stats skipping on
   the card through kernel K7). A pushed conjunct is applied again with
   SQL's semantics once its tables are joined, so the scan is only ever
   a superset.
2. Joins: INNER JOIN ... ON clauses and the implicit comma list, through
   the equi-join edges of the WHERE conjuncts (and those common to every
   branch of an OR, q13 and q48's shape); the most connected, then the
   smallest, table joins next (the reference's greedy order); a table
   with no edge is cross-joined. A conjunct applies as soon as its
   tables are joined. A NULL key never matches (`_merge_null_safe`).
3. The residual WHERE, then GROUP BY aggregation (NULL group keys kept, a
   sum of no values NULL), HAVING, the projection, DISTINCT, ORDER BY
   with Spark's null order (NULLS FIRST ascending, LAST descending) and
   LIMIT.

Joins, every aggregate and the ORDER BY sort run on the engine's device
through `sqlengine/device.py::DeviceSpine` (K10 for the aggregates). The
result is an `SqlResult`: a `Batch` that also keeps the output names in
order, repeats included.

Outside this slice, and refused with `UnsupportedSqlError` naming the
construct before any table is read: WITH, UNION / INTERSECT / EXCEPT, a
subquery in any position, outer joins, window functions, ROLLUP and
DISTINCT inside an aggregate (COUNT(DISTINCT)).
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
    UnresolvedColumnError,
    UnsupportedSqlError,
)
from delta_tpu_torch.models.batch import Batch, Column
from delta_tpu_torch.sqlengine import frame as fv
from delta_tpu_torch.sqlengine.device import DeviceSpine
from delta_tpu_torch.sqlengine.frame import Frame
from delta_tpu_torch.sqlengine.parser import (
    And, Between, BinOp, CaseWhen, Cast, Cmp, Col, Exists, Func, InList,
    InSelect, Interval, IsNull, Like, Lit, Neg, Not, Or, Query,
    ScalarSelect, Select, Star, TableRef, Window, parse_query,
)

_NUMERIC_TYPES = {"byte", "short", "integer", "long", "float", "double"}
_AGGS = {"count", "sum", "min", "max", "avg", "stddev_samp", "var_samp"}

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
        keyed = {}
        for name, c in zip(names, columns):
            key, k = name, 1
            while key in keyed:
                k += 1
                key = f"{name}#{k}"
            keyed[key] = c
        super().__init__(keyed, n)
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


# ---------------------------------------------------------------- API --

def execute_select(statement_or_ast, engine=None, catalog=None) -> SqlResult:
    """Run one SELECT (text, `Select` or `Query`) against Delta tables:
    paths, or names through `catalog`. On `engine`'s device (the
    catalog's engine when none is given; the card when neither is)."""
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
    sel = check_supported(q)
    QUERIES.inc()
    names, cols, n = _Exec(engine, catalog).run(sel)
    return SqlResult(names, cols, n)


def _refuse(construct: str):
    raise UnsupportedSqlError(
        f"{construct} is not supported by this package's SQL yet",
        construct=construct)


def check_supported(q: Query) -> Select:
    """The query's one SELECT block, or UnsupportedSqlError naming the
    first construct outside this slice."""
    if q.ctes:
        _refuse("WITH")
    if len(q.selects) > 1 or q.union_ops:
        op = q.union_ops[0] if q.union_ops else "intersect"
        _refuse({"all": "UNION ALL", "distinct": "UNION"}.get(
            op, op.upper()))
    sel = q.selects[0]
    if isinstance(sel, Query):
        if len(sel.selects) > 1:
            _refuse({"all": "UNION ALL", "distinct": "UNION"}.get(
                sel.union_ops[0] if sel.union_ops else "intersect",
                "INTERSECT"))
        _refuse("subquery")
    found = []

    def chk(e):
        if isinstance(e, (ScalarSelect, InSelect, Exists)):
            found.append("subquery")
        elif isinstance(e, Window):
            found.append("window function (OVER)")
        elif isinstance(e, Func):
            if e.name == "rollup":
                found.append("ROLLUP")
            elif e.distinct and e.name == "count":
                found.append("COUNT(DISTINCT)")
            elif e.distinct:
                found.append(f"{e.name.upper()}(DISTINCT)")

    for ref in list(sel.froms) + [j.ref for j in sel.joins]:
        if ref.kind == "subquery":
            _refuse("subquery")
    for j in sel.joins:
        if j.kind not in ("inner", "cross"):
            _refuse(j.kind.upper() + " JOIN")
    for e in ([it.expr for it in sel.items] + [sel.where, sel.having]
              + list(sel.group_by) + [o for o, _ in sel.order_by]
              + [j.on for j in sel.joins]):
        _walk_all(e, chk)
    if found:
        _refuse(found[0])
    return sel


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


def _null_keys(frame: Frame, keys: List[str]) -> np.ndarray:
    bad = np.zeros(len(frame), bool)
    for k in keys:
        if frame[k].valid is not None:
            bad |= ~frame[k].valid
    return bad


def _merge_null_safe(spine: DeviceSpine, left: Frame, right: Frame,
                     lk: List[str], rk: List[str]) -> Frame:
    """SQL inner join: a row with a NULL key never matches."""
    lnull = _null_keys(left, lk)
    rnull = _null_keys(right, rk)
    if lnull.any():
        left = left.filter(~lnull)
    if rnull.any():
        right = right.filter(~rnull)
    return spine.merge(left, right, lk, rk)


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
    def __init__(self, engine, catalog):
        self.engine = engine
        self.catalog = catalog
        self.spine = DeviceSpine(engine.device)

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

    def run(self, sel: Select) -> Tuple[List[str], List[Column], int]:
        # ---- source inventory -----------------------------------------
        sources: List[dict] = []
        seen_aliases = set()
        with _Clock(SCAN_NS):
            for i, ref in enumerate(list(sel.froms)
                                    + [j.ref for j in sel.joins]):
                snap = self._snapshot(ref)
                alias = ref.alias or (ref.value.split(".")[-1]
                                      if ref.kind == "name" else f"_t{i}")
                if alias.lower() in seen_aliases:
                    raise AmbiguousColumnError(
                        f"duplicate table alias {alias!r}")
                seen_aliases.add(alias.lower())
                sources.append({"alias": alias, "snap": snap,
                                "cols": [f.name for f in snap.schema.fields],
                                "types": {f.name: f.type_name
                                          for f in snap.schema.fields}})
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

        for it in sel.items:
            _walk_exprs(it.expr, note)
        for e in ([sel.where, sel.having] + sel.group_by
                  + [o for o, _ in sel.order_by] + [j.on for j in sel.joins]):
            _walk_exprs(e, note)
        if select_star:
            for s in sources:
                needed[s["alias"]] = set(s["cols"])

        # ---- pushdown -------------------------------------------------
        conjuncts = _split_and(sel.where)
        pushed: Dict[str, list] = {s["alias"]: [] for s in sources}
        for conj in conjuncts:
            target = self._sole_alias(conj, resolve)
            if target:
                tree = self._to_tree(conj, resolve,
                                     by_alias[target]["types"])
                if tree is not None:
                    pushed[target].append(tree)

        # ---- materialize ----------------------------------------------
        with _Clock(SCAN_NS):
            for s in sources:
                filt = None
                for t in pushed[s["alias"]]:
                    filt = t if filt is None else (filt & t)
                # schema order: SELECT * presents columns in table order
                cols = [c for c in s["cols"] if c in needed[s["alias"]]] \
                    or s["cols"][:1]
                s["frame"] = self._scan(s["snap"], filt, cols, s["alias"])

        # ---- joins ----------------------------------------------------
        with _Clock(JOIN_NS):
            current, consumed, applied = self._join(
                sel, sources, by_alias, join_aliases, conjuncts, resolve)

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
              resolve):
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

        applied = set()
        joined = set()

        def conj_aliases(conj):
            aliases = set()
            blocked = []

            def chk(x):
                if isinstance(x, Col):
                    try:
                        aliases.add(resolve(x).split(".", 1)[0])
                    except DeltaError:
                        blocked.append(x)
            _walk_exprs(conj, chk)
            return None if blocked else aliases

        def apply_eager(frame):
            for conj in conjuncts:
                if id(conj) in consumed or id(conj) in applied:
                    continue
                al = conj_aliases(conj)
                if al is None or not al or not al <= joined:
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

        # the explicit INNER/CROSS joins in greedy order, as the implicit
        # pool (WHERE equi-edges count as keys)
        pool = list(zip(join_aliases, sel.joins))
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
        return current, consumed, applied

    # -- projection / aggregation / order -------------------------------
    def _project(self, sel: Select, df: Frame, resolve):
        has_agg = False

        def check_agg(e):
            nonlocal has_agg
            if isinstance(e, Func) and e.name in _AGGS:
                has_agg = True

        for it in sel.items:
            _walk_exprs(it.expr, check_agg)
        _walk_exprs(sel.having, check_agg)
        for o, _ in sel.order_by:
            _walk_exprs(o, check_agg)
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
        canon = lambda e: _canon(e, resolve)  # noqa: E731
        key_exprs = list(sel.group_by)
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
                specs.append((f.name, None))
                continue
            if len(f.args) != 1:
                raise SqlParseError(f"{f.name} takes exactly one argument")
            specs.append((f.name, fv.broadcast(self._eval(f.args[0], df),
                                               len(df))))
        out_keys, aggs = self.spine.groupby(key_cols, specs, len(df))
        cols = dict(zip(key_names, out_keys))
        cols.update(zip(agg_specs, aggs))
        n = 1 if not key_cols else len(out_keys[0])
        return Frame(cols, n), set(cols)

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
        return self._eval_node(e, df, lambda x: self._eval(x, df))

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

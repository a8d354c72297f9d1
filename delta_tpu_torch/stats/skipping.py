"""Data skipping: drop files whose min/max/nullCount stats prove that a
predicate cannot match.

Counterpart of `delta_tpu/stats/skipping.py` (reference
`stats/DataSkippingReader.scala:287`). A file is skipped only when its
stats PROVE that no row can match; missing stats (a null stats string, a
missing column, a value that cannot be read) keep it.

The stats index (`StatsIndex`) parses every file's `stats` JSON at once
into typed columns (`numRecords`, `minValues.*`, `maxValues.*`,
`nullCount.*`). The reference does that with one call of Arrow's JSON
reader, whose type inference decides which columns get device lanes; this
module infers types the way Arrow does, so that both packages build the
same index from the same strings:

- integers read as int64 (past int64: float64), numbers with a fraction
  or exponent make the column float64; booleans; strings;
- a string column whose every value is an ISO date or a date-time to the
  second (`YYYY-MM-DD[(T| )HH[:MM[:SS]][Z|±HH[[:]MM]]]`, offsets applied)
  reads as a timestamp (in seconds), any other string column as strings;
  so date stats become timestamps, while the writers' timestamp stats
  (`%Y-%m-%dT%H:%M:%S.%f%z`, with a fraction) stay strings;
- a column that holds two kinds (number and string, object and number,
  ...), invalid JSON, a non-object row or a number past float64's range
  fail the whole parse (the bare tokens NaN, Infinity and -Infinity read
  as doubles); the parse is then retried once with every `:"NaN"`,
  `:"Infinity"` and `:"-Infinity"` value nulled (a non-finite float
  stat beside finite ones), and if that fails too there is no index and
  every file is kept;
- struct fields appear in order of first appearance; a struct that is
  null in a row makes its leaves null there;
- raw newlines in a row are flattened to spaces first (pretty-printed
  stats).

The rows are parsed as one JSON array by `json.loads`; a duplicate key
in one object, which Arrow refuses, is not detected (the last value
wins).

With the snapshot's state, `skipping_mask` plans through the resident
lane matrix (`stats/device_index.py`): every conjunct the compiler can
express runs in one call of `ops/skipping.py::skip_mask_block` (kernel K7
on the card, its plain version on a CPU engine), counted in
`scan.device_plans`; the rest (strings, inexact literals, missing
columns, an AND under an OR) walks the per-conjunct ladder here
(`_conjunct_keep`), counted in `scan.device_fallbacks`. Both AND into one
mask. Without a state (the conflict checker's winners) only the ladder
runs, as in the reference.

Decimal stats are JSON numbers, which the parse rounds to the nearest
float64 (Spark writes a decimal's digits, the reference `float(value)`),
while a decimal compares exactly with a `Decimal` or an integer literal
(`expressions/eval.py`). Before either route, `exact_bounds` turns such
a comparison into a float one that can only keep more: `col > L` and
`col >= L` become `col >= f`, f the largest double not above L (rounding
is monotone, so a row at or past L has a stat at or past f); `<` and
`<=` take the smallest double not below L; `=` both; IN the range of
its values so widened; `!=` skips nothing. A float literal is left as it is: a decimal
beside a float compares as float64 in both packages.

Under column mapping the stats keys are physical names: after
`exact_bounds`, `_to_physical` rewrites each conjunct's logical column
paths to physical ones (a conjunct naming a column the schema lacks is
dropped: it keeps every file), so the lanes and the ladder read the
physical keys, as the reference does (`stats/skipping.py:300-365`).
"""

from __future__ import annotations

import dataclasses
import decimal
import itertools
import json
import math
import re
from fractions import Fraction
from typing import Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch import obs
from delta_tpu_torch.columnmapping import is_mapped, physical_name_path
from delta_tpu_torch.expressions.eval import (
    Kleene,
    UnsupportedComparison,
    Values,
    compare,
    literal_values,
)
from delta_tpu_torch.expressions.tree import (
    And,
    Column,
    Comparison,
    Expression,
    In,
    IsNotNull,
    IsNull,
    Literal,
    Not,
    Or,
)
from delta_tpu_torch.models.schema import (
    decimal_precision_scale,
    schema_from_json,
)
from delta_tpu_torch.utils.timestamps import parse_timestamp_s

_DEVICE_PLANS = obs.counter("scan.device_plans")
_DEVICE_FALLBACKS = obs.counter("scan.device_fallbacks")

MAX_STRING_PREFIX_LENGTH = 32  # stats/collection.py's string stat cap

_NONFINITE_RE = re.compile(r':\s*"(?:NaN|Infinity|-Infinity)"')
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


class _Invalid(Exception):
    """The rows do not parse as Arrow would parse them."""


class _Struct:
    """A parsed object column: its fields in order of first appearance,
    and its own validity."""

    def __init__(self, fields: Dict[str, object], valid: np.ndarray):
        self.fields = fields
        self.valid = valid


def _finite_float(s: str) -> float:
    f = float(s)
    if f in (float("inf"), float("-inf")):
        raise _Invalid(f"number too big for a double: {s[:40]}")
    return f


# Arrow reads the bare tokens NaN, Infinity and -Infinity as doubles
# (also Inf and -NaN, which json refuses: those rows fail the parse)
_DECODER = json.JSONDecoder(parse_float=_finite_float)


def _parse_rows(texts: List[str]) -> list:
    """Every row as a dict, or raise _Invalid."""
    try:
        rows = _DECODER.decode("[" + ",".join(texts) + "]")
    except (ValueError, RecursionError) as e:
        raise _Invalid(str(e)) from None
    if len(rows) != len(texts) or not all(type(r) is dict for r in rows):
        raise _Invalid("a row is not one JSON object")
    return rows


_KINDS = {bool: "bool", int: "number", float: "number", str: "string",
          dict: "object", list: "array"}


def _infer(values: list, parent_valid: np.ndarray):
    """The typed column of one field over every row (None where the row
    lacks it or holds null)."""
    n = len(values)
    valid = np.fromiter((v is not None for v in values), bool, n)
    present = [v for v in values if v is not None]
    types = set(map(type, present))
    kinds = {_KINDS.get(t, "?") for t in types}
    if len(kinds) > 1:
        raise _Invalid(f"a column changed kind: {sorted(kinds)}")
    kind = kinds.pop() if kinds else "null"
    valid &= parent_valid
    if kind == "null":
        return Values("null", np.zeros(n, bool), valid)
    if kind == "object":
        names = dict.fromkeys(itertools.chain.from_iterable(present))
        return _Struct({name: _infer(
            [v.get(name) if v is not None else None for v in values], valid)
            for name in names}, valid)
    if kind == "array":
        data = np.empty(n, object)
        data[:] = values
        return Values("other", data, valid)
    filled = values if len(present) == n else \
        [(0 if kind != "string" else "") if v is None else v for v in values]
    if kind == "bool":
        return Values("bool", np.array(filled, bool), valid)
    if kind == "number":
        if float not in types:
            try:  # an integer past int64 makes the column float64
                return Values("int", np.array(filled, np.int64), valid)
            except OverflowError:
                pass
        return Values("float", np.array(filled, np.float64), valid)
    secs = [parse_timestamp_s(v) for v in present]
    if all(t is not None for t in secs):
        data = np.zeros(n, np.int64)
        data[valid if len(present) < n else slice(None)] = \
            np.asarray(secs, np.int64) * 1_000_000
        return Values("ts", data, valid)
    data = np.empty(n, object)
    data[:] = filled
    return Values("string", data, valid)


def _parse_table(texts: List[str]) -> Optional[_Struct]:
    rows = _parse_rows(texts)
    n = len(rows)
    return _infer(rows, np.ones(n, bool))


class StatsIndex:
    """Parsed stats for a batch of files: a struct of typed columns (None
    when nothing parsed: no stats at all, or a parse Arrow would refuse)."""

    def __init__(self, table: Optional[_Struct], n: int):
        self._table = table
        self.n = n

    @staticmethod
    def from_stats(stats: Sequence[Optional[str]]) -> "StatsIndex":
        n = len(stats)
        if n == 0 or all(s is None for s in stats):
            return StatsIndex(None, n)
        texts = ["{}" if s is None else
                 s.replace("\r", " ").replace("\n", " ") for s in stats]
        try:
            table = _parse_table(texts)
        except _Invalid:
            texts = [_NONFINITE_RE.sub(":null", s) for s in texts]
            try:
                table = _parse_table(texts)
            except _Invalid:
                return StatsIndex(None, n)
        return StatsIndex(table, n)

    def _leaf(self, group: str, name_path: tuple):
        """The column at `group.name_path` (a Values, or a _Struct for an
        inner node); None when the index lacks it."""
        if self._table is None:
            return None
        node = self._table.fields.get(group)
        if not isinstance(node, _Struct):
            return None
        for part in name_path:
            if not isinstance(node, _Struct) or part not in node.fields:
                return None
            node = node.fields[part]
        return node

    def num_records(self):
        if self._table is None:
            return None
        return self._table.fields.get("numRecords")

    def min_values(self, name_path):
        return self._leaf("minValues", name_path)

    def max_values(self, name_path):
        return self._leaf("maxValues", name_path)

    def null_count(self, name_path):
        return self._leaf("nullCount", name_path)


def _cmp(op: str, col, value) -> Kleene:
    """`col op value` for a parsed column (raises UnsupportedComparison
    where Arrow has no kernel)."""
    if not isinstance(col, Values):
        raise UnsupportedComparison("a struct column compares with nothing")
    return compare(op, col, literal_values(value, len(col)))


def _max_truncated(maxv) -> Optional[Kleene]:
    """Per-file "this string max MAY be truncated" mask: the writers cap
    string maxValues at MAX_STRING_PREFIX_LENGTH characters with an
    upward tie-break, so a max at the cap may differ from the true max."""
    if not isinstance(maxv, Values) or maxv.kind != "string":
        return None
    lens = np.fromiter((len(s) for s in maxv.data), np.int64, len(maxv))
    return Kleene((lens >= MAX_STRING_PREFIX_LENGTH) & maxv.valid,
                  maxv.valid.copy())


def _cmp_keep(op: str, minv, maxv, value) -> Optional[Kleene]:
    """Keep-condition for `col op value` from the min/max columns; None =
    cannot decide (keep). A truncated string max is only a lower bound of
    the true max, so every max-dependent verdict keeps such files."""
    try:
        trunc = _max_truncated(maxv)
        if op == "=":
            if minv is None or maxv is None:
                return None
            hi = _cmp(">=", maxv, value)
            if trunc is not None:
                hi = hi | trunc
            return _cmp("<=", minv, value) & hi
        if op in ("<", "<="):
            return None if minv is None else _cmp(op, minv, value)
        if op in (">", ">="):
            if maxv is None:
                return None
            keep = _cmp(op, maxv, value)
            return keep if trunc is None else keep | trunc
        if op == "!=":
            if minv is None or maxv is None:
                return None
            all_eq = _cmp("=", minv, value) & _cmp("=", maxv, value)
            if trunc is not None:
                all_eq = all_eq & ~trunc
            return ~all_eq
    except UnsupportedComparison:
        return None
    return None


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}
_NEG = {"=": "!=", "!=": "=", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}


def _conjunct_keep(conj: Expression, index: StatsIndex) -> Optional[Kleene]:
    """Nullable keep-mask for one conjunct; None or NULL = keep."""
    if isinstance(conj, Or):
        left = _conjunct_keep(conj.left, index)
        right = _conjunct_keep(conj.right, index)
        if left is None or right is None:
            return None
        return left | right
    if isinstance(conj, Comparison):
        if isinstance(conj.left, Column) and isinstance(conj.right, Literal):
            colref, lit, op = conj.left, conj.right, conj.op
        elif isinstance(conj.right, Column) \
                and isinstance(conj.left, Literal):
            colref, lit, op = conj.right, conj.left, _FLIP[conj.op]
        else:
            return None
        if lit.value is None:
            return None
        keep = _cmp_keep(op, index.min_values(colref.name_path),
                         index.max_values(colref.name_path), lit.value)
        # an all-null column cannot match `col op lit`
        nc = index.null_count(colref.name_path)
        nr = index.num_records()
        if nc is not None and nr is not None:
            try:
                if not isinstance(nc, Values) or not isinstance(nr, Values):
                    raise UnsupportedComparison("struct operand")
                not_all_null = compare("<", nc, nr)
                keep = not_all_null if keep is None else keep & not_all_null
            except UnsupportedComparison:
                pass
        return keep
    if isinstance(conj, IsNull):
        if isinstance(conj.child, Column):
            nc = index.null_count(conj.child.name_path)
            if nc is None:
                return None
            try:
                return _cmp(">", nc, 0)
            except UnsupportedComparison:
                return None
        return None
    if isinstance(conj, IsNotNull):
        if isinstance(conj.child, Column):
            nc = index.null_count(conj.child.name_path)
            nr = index.num_records()
            if nc is None or nr is None:
                return None
            try:
                if not isinstance(nc, Values) or not isinstance(nr, Values):
                    raise UnsupportedComparison("struct operand")
                return compare("<", nc, nr)
            except UnsupportedComparison:
                return None
        return None
    if isinstance(conj, In):
        return _in_keep(conj, index)
    if isinstance(conj, Not):
        inner = conj.child
        if isinstance(inner, Comparison):
            return _conjunct_keep(
                Comparison(_NEG[inner.op], inner.left, inner.right), index)
        if isinstance(inner, IsNull):
            return _conjunct_keep(IsNotNull(inner.child), index)
        if isinstance(inner, IsNotNull):
            return _conjunct_keep(IsNull(inner.child), index)
        return None
    return None


def _in_keep(conj: In, index: StatsIndex) -> Optional[Kleene]:
    """IN: a range prefilter over min(values)..max(values) (the verdict
    itself past 64 values), then the OR of one `=` per value."""
    if not isinstance(conj.child, Column) or not conj.values:
        return None
    if any(v is None for v in conj.values):
        return None
    pre = None
    try:
        lo, hi = min(conj.values), max(conj.values)
    except TypeError:  # mixed, uncomparable values
        lo = hi = None
    if lo is not None:
        k_lo = _conjunct_keep(Comparison(">=", conj.child, Literal(lo)),
                              index)
        k_hi = _conjunct_keep(Comparison("<=", conj.child, Literal(hi)),
                              index)
        if k_lo is not None and k_hi is not None:
            pre = k_lo & k_hi
        elif k_lo is not None or k_hi is not None:
            pre = k_lo if k_lo is not None else k_hi
    if pre is not None:
        if len(conj.values) > 64:
            return pre
        if not pre.filled(True).any():
            return pre  # nothing survives the range
    keeps = None
    for v in conj.values:
        k = _conjunct_keep(Comparison("=", conj.child, Literal(v)), index)
        if k is None:
            return pre
        keeps = k if keeps is None else keeps | k
    if keeps is not None and pre is not None:
        keeps = keeps & pre
    return keeps


def _double_at_or_below(v) -> float:
    f = float(v)
    return math.nextafter(f, -math.inf) if Fraction(f) > Fraction(v) else f


def _double_at_or_above(v) -> float:
    f = float(v)
    return math.nextafter(f, math.inf) if Fraction(f) < Fraction(v) else f


def _exact_literal(value, on_decimal: bool) -> bool:
    """A literal that compares exactly (a finite Decimal; an integer
    beside a decimal column) where the stats may be rounded."""
    if isinstance(value, decimal.Decimal):
        return value.is_finite()
    return on_decimal and isinstance(value, (int, np.integer)) \
        and not isinstance(value, (bool, np.bool_))


def _bounds(expr: Expression, decimals: set) -> Optional[Expression]:
    """`expr` with every exact comparison against possibly rounded stats
    widened to float bounds (module docstring); None: it skips nothing."""
    if isinstance(expr, (Or, And)):
        left = _bounds(expr.left, decimals)
        right = _bounds(expr.right, decimals)
        if left is None or right is None:
            return None
        return type(expr)(left, right)
    if isinstance(expr, Not) and isinstance(expr.child, Comparison):
        c = expr.child
        return _bounds(Comparison(_NEG[c.op], c.left, c.right), decimals)
    if isinstance(expr, In) and isinstance(expr.child, Column):
        on_dec = expr.child.name_path in decimals
        if not any(_exact_literal(v, on_dec) for v in expr.values):
            return expr
        if any(v is None for v in expr.values):
            return None
        try:
            lo, hi = min(expr.values), max(expr.values)
        except TypeError:
            return None
        return _bounds(And(Comparison(">=", expr.child, Literal(lo)),
                           Comparison("<=", expr.child, Literal(hi))),
                       decimals)
    if not isinstance(expr, Comparison):
        return expr
    if isinstance(expr.left, Column) and isinstance(expr.right, Literal):
        colref, value, op = expr.left, expr.right.value, expr.op
    elif isinstance(expr.right, Column) and isinstance(expr.left, Literal):
        colref, value, op = expr.right, expr.left.value, _FLIP[expr.op]
    else:
        return expr
    if not _exact_literal(value, colref.name_path in decimals):
        return expr
    below = Comparison(">=", colref, Literal(_double_at_or_below(value)))
    above = Comparison("<=", colref, Literal(_double_at_or_above(value)))
    if op in (">", ">="):
        return below
    if op in ("<", "<="):
        return above
    return And(below, above) if op == "=" else None


def exact_bounds(conjuncts: List[Expression], metadata) -> List[Expression]:
    """The conjuncts with exact comparisons widened (`_bounds`), a
    top-level AND split, those that skip nothing dropped."""
    decimals = set()
    if metadata is not None and metadata.schemaString:
        for f in json.loads(metadata.schemaString).get("fields", []):
            if decimal_precision_scale(f.get("type")) is not None:
                decimals.add((f.get("name"),))
    out: List[Expression] = []
    for conj in conjuncts:
        b = _bounds(conj, decimals)
        if isinstance(b, And):
            out.extend([b.left, b.right])
        elif b is not None:
            out.append(b)
    return out


def _to_physical(expr: Expression, schema) -> Optional[Expression]:
    """`expr` with its logical column paths rewritten to physical ones;
    None when a path names no field (the conjunct then keeps)."""
    if isinstance(expr, Column):
        phys = physical_name_path(schema, expr.name_path)
        return Column(phys) if phys is not None else None
    children = expr.children()
    if not children:
        return expr
    new_children = []
    for c in children:
        nc = _to_physical(c, schema)
        if nc is None:
            return None
        new_children.append(nc)
    names = [f.name for f in dataclasses.fields(expr)
             if isinstance(getattr(expr, f.name), Expression)]
    return dataclasses.replace(expr, **dict(zip(names, new_children)))


def skipping_mask(stats: Optional[Sequence[Optional[str]]],
                  conjuncts: List[Expression], metadata, engine=None,
                  state=None) -> np.ndarray:
    """Boolean keep-mask over files (True = must read the file).

    With `state` (the snapshot's `SnapshotState`), the files are the
    state's live files in row order and their index is the state's
    resident one (`stats` is then not read); every compilable conjunct
    runs in one `skip_mask_block` call on the engine's device (kernel K7
    on the card) and only the rest walks the ladder. Without a state,
    the index is parsed from `stats` and only the ladder runs."""
    n = len(state.live_rows) if state is not None else len(stats)
    keep = np.ones(n, dtype=bool)
    if n == 0 or not conjuncts:
        return keep
    conjuncts = exact_bounds(conjuncts, metadata)
    if metadata is not None and is_mapped(metadata.configuration):
        schema = schema_from_json(metadata.schemaString)
        conjuncts = [p for p in (_to_physical(c, schema) for c in conjuncts)
                     if p is not None]
    if not conjuncts:
        return keep
    rs = None
    if state is not None:
        from delta_tpu_torch.stats.device_index import snapshot_stats_index

        rs = snapshot_stats_index(state, engine)
        index = rs.host_index
    else:
        index = StatsIndex.from_stats(stats)
    if index._table is None:
        return keep
    fallback = conjuncts
    if rs is not None and rs.has_lanes:
        from delta_tpu_torch.ops.skipping import skip_mask_block
        from delta_tpu_torch.stats.device_index import compile_conjuncts

        block, fallback = compile_conjuncts(conjuncts, rs)
        if block is not None:
            vals, valid = rs.device_lanes()
            keep &= skip_mask_block(vals, valid, block, n).cpu().numpy()
            _DEVICE_PLANS.inc()
    if rs is not None and fallback:
        # semantic, not a failure: strings, inexact literals, columns
        # without lanes, an AND under an OR
        _DEVICE_FALLBACKS.inc(len(fallback))
    for conj in fallback:
        mask = _conjunct_keep(conj, index)
        if mask is not None:
            keep &= mask.filled(True)  # NULL (missing stats) keeps
    return keep

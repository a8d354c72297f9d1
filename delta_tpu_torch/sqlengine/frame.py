"""Rows and values of the SQL executor: a `Frame` of named `Column`s
(numpy values plus validity) and SQL's value semantics over them.

The reference evaluates over data frames (`delta_tpu/sqlengine/
executor.py`); this package keeps its rows in the port's `Column`s and
writes the same semantics over them:

- a value is a `Column` or a Python scalar (int, float, str, bool, None,
  `np.datetime64`, `np.timedelta64`); None is SQL's NULL;
- a float NaN is NULL, as the reference reads it (its frames treat NaN
  as missing) and as sqlite stores it: `column()` folds every NaN of a
  float column into its validity, and arithmetic that yields NaN yields
  NULL;
- predicates are three-valued (Kleene): a bool `Column` whose invalid
  rows are UNKNOWN; `truth()` collapses UNKNOWN to false at a filter
  boundary (WHERE, HAVING, CASE), as `_truth` does (`:1917`);
- comparisons and arithmetic are NULL where an operand is NULL
  (`_with_nulls`, `:2149`); IN is NULL for a NULL item, and a miss is
  NULL when the list holds a NULL (`_in_membership`, `:2133`);
- a date column is datetime64[D] (`models/schema.py`), compared with a
  string literal by parsing the literal as a date (`_coerce_datetime`);
  `INTERVAL n DAYS` is a timedelta64[D].
"""

from __future__ import annotations

import datetime
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch.errors import UnsupportedSqlError
from delta_tpu_torch.models.batch import Column, decimal_precision_scale


class Frame:
    """An ordered set of equal-length named Columns (the reference's
    data frame)."""

    __slots__ = ("cols", "n")

    def __init__(self, cols: Dict[str, Column], n: int):
        self.cols = dict(cols)
        self.n = int(n)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, name: str) -> Column:
        return self.cols[name]

    @property
    def names(self) -> List[str]:
        return list(self.cols)

    def take(self, idx: np.ndarray) -> "Frame":
        return Frame({k: c.take(idx) for k, c in self.cols.items()},
                     len(idx))

    def filter(self, mask: np.ndarray) -> "Frame":
        return self.take(np.flatnonzero(mask))

    def head(self, k: int) -> "Frame":
        k = min(int(k), self.n)
        return Frame({name: c.slice(0, k) for name, c in self.cols.items()},
                     k)

    def column_at(self, i: int) -> Column:
        return list(self.cols.values())[i]

    def rekey(self, names: Sequence[str]) -> "Frame":
        """The same Columns (not copied) under new names, by position."""
        return Frame(dict(zip(names, self.cols.values())), self.n)


def concat_frames(frames: Sequence[Frame]) -> Frame:
    """Frames stacked by position, under the first one's names (UNION ALL).
    Each position's Columns take one type, as the reference's positional
    concatenation gives them: ints and floats together are float64, a
    Column with no valid row (a branch of NULLs, or no rows) takes the
    others' type, and any other mix is object."""
    frames = list(frames)
    out = {}
    for pos, name in enumerate(frames[0].names):
        parts = [f.column_at(pos) for f in frames]
        out[name] = Column.concat(_unified(parts))
    return Frame(out, sum(len(f) for f in frames))


def _unified(parts: List[Column]) -> List[Column]:
    typed = {id(p) for p in parts if len(p) and valid_of(p).any()}
    dtypes = {p.values.dtype for p in parts if id(p) in typed} \
        or {parts[0].values.dtype}
    if len(dtypes) == 1:
        dtype = dtypes.pop()
    elif all(d.kind in "iub" for d in dtypes):
        dtype = np.dtype(np.int64)
    elif all(d.kind in "iubf" for d in dtypes):
        dtype = np.dtype(np.float64)
    elif all(d.kind == "M" for d in dtypes):
        dtype = np.result_type(*dtypes)
    else:
        dtype = np.dtype(object)
    out = []
    for p in parts:
        if p.values.dtype == dtype:
            out.append(Column(p.values, p.valid))
        elif id(p) not in typed:
            out.append(Column.nulls(dtype, len(p)))
        elif dtype == object:
            vals = np.empty(len(p), object)
            vals[:] = p.values.tolist()
            out.append(Column(vals, p.valid))
        else:
            out.append(Column(p.values.astype(dtype), p.valid))
    return out


# ------------------------------------------------------------- values ---

def column(values, valid: Optional[np.ndarray] = None) -> Column:
    """A Column of `values` under `valid`, NaN folded into NULL and an
    all-true mask dropped."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        nan = np.isnan(values)
        if nan.any():
            valid = ~nan if valid is None else (valid & ~nan)
            values = np.where(nan, 0.0, values)
    if valid is not None and bool(valid.all()):
        valid = None
    return Column(values, valid)


def from_batch_column(c: Column) -> Column:
    """A scanned column in the executor's form: int types widened to
    int64, decimals as float64 (the reference reads them as floats), NaN
    as NULL."""
    v = c.values
    ps = decimal_precision_scale(c.data_type)
    if ps is not None:
        v = np.array([float(x) for x in v.tolist()], np.float64) \
            / 10.0 ** ps[1] if v.dtype == object \
            else v.astype(np.float64) / 10.0 ** ps[1]
    elif v.dtype.kind == "i" and v.dtype != np.int64:
        v = v.astype(np.int64)
    elif v.dtype == np.float32:
        v = v.astype(np.float64)
    return column(v, c.valid)


def is_col(x) -> bool:
    return isinstance(x, Column)


def is_null(x) -> bool:
    """A NULL scalar: None, a float NaN or a NaT."""
    if x is None:
        return True
    if isinstance(x, float):
        return x != x
    if isinstance(x, (np.datetime64, np.timedelta64)):
        return bool(np.isnat(x))
    return False


def valid_of(c: Column) -> np.ndarray:
    return np.ones(len(c), bool) if c.valid is None else c.valid


def null_rows(cols: Sequence[Column]) -> np.ndarray:
    """The rows where any of the (equal-length) Columns is NULL."""
    bad = np.zeros(len(cols[0]), bool)
    for c in cols:
        if c.valid is not None:
            bad |= ~c.valid
    return bad


def _and_valid(*parts) -> Optional[np.ndarray]:
    out = None
    for p in parts:
        if is_col(p) and p.valid is not None:
            out = p.valid if out is None else (out & p.valid)
    return out


def broadcast(x, n: int) -> Column:
    """A scalar as a Column of n rows (NULL: float64, every row null)."""
    if is_col(x):
        return x
    if is_null(x):
        return Column(np.zeros(n, np.float64), np.zeros(n, bool))
    if isinstance(x, str):
        out = np.empty(n, object)
        out[:] = x
        return Column(out)
    if isinstance(x, bool):
        return Column(np.full(n, x, bool))
    if isinstance(x, int):
        return Column(np.full(n, x, np.int64))
    if isinstance(x, float):
        return Column(np.full(n, x, np.float64))
    return Column(np.full(n, x))


def _raw(x):
    return x.values if is_col(x) else x


def is_string(x) -> bool:
    return (is_col(x) and x.values.dtype == object) or isinstance(x, str)


def _is_datetime(x) -> bool:
    return (is_col(x) and x.values.dtype.kind == "M") \
        or isinstance(x, (np.datetime64, datetime.date))


_DATE_TEXT = re.compile(r"\s*(\d{4})-(\d{1,2})-(\d{1,2})(.*)$", re.S)


def parse_date(text: str):
    """A date (or timestamp) literal as numpy datetime64: '2000-3-1' is
    read as 2000-03-01, as the reference reads it."""
    m = _DATE_TEXT.match(text)
    if m is None:
        raise UnsupportedSqlError(f"cannot read {text!r} as a date",
                                  error_class="DELTA_INVALID_DATE_LITERAL")
    y, mo, d, rest = m.groups()
    iso = f"{y}-{int(mo):02d}-{int(d):02d}"
    rest = rest.strip()
    if not rest:
        return np.datetime64(iso, "D")
    return np.datetime64(f"{iso}T{rest.replace(' ', 'T')}", "us")


def _coerce_datetime(l, r):
    """Make string literals comparable to date columns."""
    if _is_datetime(l) and isinstance(r, str):
        r = parse_date(r)
    elif _is_datetime(r) and isinstance(l, str):
        l = parse_date(l)
    return l, r


# ---------------------------------------------------- three-valued ---

def kleene(x, n: int) -> Column:
    """A predicate value as a bool Column (invalid rows UNKNOWN)."""
    if is_col(x):
        if x.values.dtype == bool:
            return x
        return Column(np.asarray(x.values != 0, bool) if x.values.dtype
                      != object else np.array([bool(v) for v in x.values],
                                              bool), x.valid)
    if is_null(x):
        return Column(np.zeros(n, bool), np.zeros(n, bool))
    return Column(np.full(n, bool(x)))


def _tf(c: Column):
    """(definitely true, definitely false) masks."""
    v = valid_of(c)
    return c.values & v, ~c.values & v


def k_and(a: Column, b: Column) -> Column:
    ta, fa = _tf(a)
    tb, fb = _tf(b)
    t, f = ta & tb, fa | fb
    return column(t, t | f)


def k_or(a: Column, b: Column) -> Column:
    ta, fa = _tf(a)
    tb, fb = _tf(b)
    t, f = ta | tb, fa & fb
    return column(t, t | f)


def k_not(a: Column) -> Column:
    t, f = _tf(a)
    return column(f, t | f)


def truth(m) -> "np.ndarray | bool":
    """Collapse three-valued logic at a filter boundary: UNKNOWN is
    false."""
    if is_col(m):
        vals = m.values
        if vals.dtype != bool:
            vals = kleene(m, len(m)).values
        return vals & valid_of(m)
    if is_null(m):
        return False
    return bool(m)


# ------------------------------------------------------- operators ---

def binop(op: str, l, r):
    """Arithmetic and `||`; NULL where an operand is NULL."""
    if is_null(l) or is_null(r):
        return None
    if op == "||":
        return concat(l, r)
    if op not in ("+", "-", "*", "/"):
        raise UnsupportedSqlError(f"unsupported operator {op!r}",
                                  error_class="DELTA_UNSUPPORTED_SQL_OPERATOR")
    lv, rv = _raw(l), _raw(r)
    with np.errstate(all="ignore"):
        if op == "+":
            res = lv + rv
        elif op == "-":
            res = lv - rv
        elif op == "*":
            res = lv * rv
        else:
            res = np.true_divide(lv, rv)
    if not is_col(l) and not is_col(r):
        res = res.item() if isinstance(res, np.generic) else res
        return None if is_null(res) else res
    return column(res, _and_valid(l, r))


def neg(x):
    if is_null(x):
        return None
    if is_col(x):
        return Column(-x.values, x.valid)
    return -x


def _str_values(x, n: int):
    if not is_col(x):
        return np.full(n, str(x), object), None
    v = x.values
    if v.dtype == object:
        return v, x.valid
    return np.array([str(e) for e in v.tolist()], object), x.valid


def concat(*parts):
    """String concatenation (`||`, concat()); NULL where a part is."""
    if any(is_null(p) for p in parts):
        return None
    n = next((len(p) for p in parts if is_col(p)), None)
    if n is None:
        return "".join(str(p) for p in parts)
    out = None
    valid = None
    for p in parts:
        v, m = _str_values(p, n)
        out = v if out is None else out + v
        if m is not None:
            valid = m if valid is None else (valid & m)
    return column(out.astype(object), valid)


def compare(op: str, l, r):
    """= <> < <= > >= with NULL where an operand is NULL."""
    l, r = _coerce_datetime(l, r)
    if is_null(l) or is_null(r):
        return None
    lv, rv = _raw(l), _raw(r)
    if op == "=":
        res = lv == rv
    elif op == "<>":
        res = lv != rv
    elif op == "<":
        res = lv < rv
    elif op == "<=":
        res = lv <= rv
    elif op == ">":
        res = lv > rv
    elif op == ">=":
        res = lv >= rv
    else:
        raise UnsupportedSqlError(f"unsupported comparison {op!r}")
    if not is_col(l) and not is_col(r):
        return bool(res)
    return Column(np.asarray(res, bool), _and_valid(l, r))


def in_list(v, vals: Sequence, n: int):
    """SQL IN over literal values (and columns); three-valued."""
    has_null = any(not is_col(x) and is_null(x) for x in vals)
    vals = [x for x in vals if is_col(x) or not is_null(x)]
    if _is_datetime(v):
        vals = [parse_date(x) if isinstance(x, str) else x for x in vals]
    if not is_col(v):
        if is_null(v):
            return None
        v = broadcast(v, n)
    scalars = [x for x in vals if not is_col(x)]
    if v.values.dtype == object:
        s = set(scalars)
        hit = np.fromiter((e in s for e in v.values), bool, len(v))
    elif scalars:
        hit = np.isin(v.values, np.array(scalars))
    else:
        hit = np.zeros(len(v), bool)
    out = Column(hit, v.valid)
    for x in vals:
        if is_col(x):
            out = k_or(out, compare("=", v, x))
    if has_null:
        t, f = _tf(out)
        out = column(t, t)  # a miss is UNKNOWN
    return out


def like(s, pattern: str):
    rx = re.compile("^" + "".join(
        ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
        for ch in pattern) + "$")
    if not is_col(s):
        return None if is_null(s) else bool(rx.match(str(s)))
    v, m = _str_values(s, len(s))
    return Column(np.fromiter((rx.match(e) is not None for e in v), bool,
                              len(v)), m)


def is_null_test(x, negated: bool):
    if is_col(x):
        isna = ~valid_of(x)
        return Column(~isna if negated else isna)
    isna = is_null(x)
    return (not isna) if negated else isna


def case_when(conds: List[np.ndarray], vals: list, default, n: int) -> Column:
    """CASE WHEN over evaluated branches: the first true condition's value
    (conditions already collapsed by `truth`)."""
    parts = list(vals) + [default]
    kinds = set()
    for p in parts:
        if not is_col(p) and is_null(p):
            continue
        if is_string(p):
            kinds.add("O")
        elif is_col(p):
            kinds.add(p.values.dtype.kind)
        elif isinstance(p, bool):
            kinds.add("b")
        elif isinstance(p, int):
            kinds.add("i")
        elif isinstance(p, float):
            kinds.add("f")
        else:
            kinds.add(np.asarray(p).dtype.kind)
    if "O" in kinds:
        dtype = object
    elif "f" in kinds:
        dtype = np.float64
    elif "M" in kinds:
        dtype = next(p.values.dtype if is_col(p) else np.asarray(p).dtype
                     for p in parts if _is_datetime(p))
    elif kinds <= {"b"} and kinds:
        dtype = bool
    else:
        dtype = np.int64
    d = broadcast(default, n)
    out = np.asarray(d.values).astype(dtype)
    valid = valid_of(d).copy()
    for cond, val in zip(reversed(conds), reversed(vals)):
        b = broadcast(val, n)
        out = np.where(cond, np.asarray(b.values).astype(dtype), out)
        valid = np.where(cond, valid_of(b), valid)
    if dtype is object:
        out = out.astype(object)
    return column(out, valid)


def cast(v, type_name: str):
    if is_null(v):
        return None
    if type_name == "date":
        if is_col(v):
            if v.values.dtype == object:
                vals = np.array([parse_date(s) if ok else np.datetime64(0, "D")
                                 for s, ok in zip(v.values, valid_of(v))],
                                "datetime64[D]")
                return Column(vals, v.valid)
            return Column(v.values.astype("datetime64[D]"), v.valid)
        return parse_date(v) if isinstance(v, str) \
            else np.datetime64(v, "D")
    if type_name in ("int", "integer", "bigint", "long", "smallint"):
        if is_col(v):
            vals = v.values
            if vals.dtype == object:
                vals = np.array([int(x) if ok else 0 for x, ok in
                                 zip(vals, valid_of(v))], np.int64)
            else:
                vals = np.trunc(vals).astype(np.int64) \
                    if vals.dtype.kind == "f" else vals.astype(np.int64)
            return Column(vals, v.valid)
        return int(v)
    if type_name in ("double", "float", "real") \
            or type_name.startswith("decimal"):
        if is_col(v):
            vals = v.values
            if vals.dtype == object:
                vals = np.array([float(x) if ok else 0.0 for x, ok in
                                 zip(vals, valid_of(v))], np.float64)
            return column(vals.astype(np.float64), v.valid)
        return float(v)
    if type_name in ("string", "varchar", "char", "text"):
        if is_col(v):
            vals, m = _str_values(v, len(v))
            return Column(vals, m)
        return str(v)
    raise UnsupportedSqlError(f"unsupported CAST target {type_name!r}",
                              error_class="DELTA_UNSUPPORTED_CAST_TARGET")


# ------------------------------------------------------- functions ---

def _substr(s, start: int, length: Optional[int], n: int):
    lo = start - 1
    hi = None if length is None else lo + length
    if not is_col(s):
        return None if is_null(s) else str(s)[lo:hi]
    v, m = _str_values(s, n)
    return Column(np.array([e[lo:hi] for e in v], object), m)


def _coalesce(args, n: int):
    out = args[0]
    for nxt in args[1:]:
        if not is_col(out):
            if is_null(out):
                out = nxt
            continue
        if out.valid is None:
            break
        fill = broadcast(nxt, n)
        dtype = object if out.values.dtype == object \
            or fill.values.dtype == object else np.result_type(
                out.values.dtype, fill.values.dtype)
        vals = np.where(out.valid, out.values.astype(dtype),
                        fill.values.astype(dtype))
        out = column(vals.astype(dtype), out.valid | valid_of(fill))
    return out


def _round_half_up(v, digits: int):
    scale = 10.0 ** digits
    if is_col(v):
        with np.errstate(all="ignore"):
            r = np.sign(v.values) * np.floor(np.abs(v.values) * scale + 0.5) \
                / scale
        return column(r, v.valid)
    if is_null(v):
        return None
    return float(np.sign(v) * np.floor(abs(v) * scale + 0.5) / scale)


def apply_func(name: str, args: list, n: int):
    """A scalar function of the reference's `_apply_func` (`:1856`)."""
    if name in ("substr", "substring"):
        length = int(args[2]) if len(args) > 2 else None
        return _substr(args[0], int(args[1]), length, n)
    if name in ("upper", "lower", "length"):
        s = args[0]
        if not is_col(s):
            if is_null(s):
                return None
            s = str(s)
            return {"upper": s.upper(), "lower": s.lower(),
                    "length": len(s)}[name]
        v, m = _str_values(s, n)
        if name == "length":
            return Column(np.fromiter((len(e) for e in v), np.int64, len(v)),
                          m)
        f = str.upper if name == "upper" else str.lower
        return Column(np.array([f(e) for e in v], object), m)
    if name == "abs":
        a = args[0]
        if is_col(a):
            return Column(np.abs(a.values), a.valid)
        return None if is_null(a) else abs(a)
    if name == "round":
        return _round_half_up(args[0], int(args[1]) if len(args) > 1 else 0)
    if name == "coalesce":
        return _coalesce(args, n)
    if name == "concat":
        return concat(*args)
    if name in ("year", "month"):
        a = args[0]
        if not is_col(a):
            if is_null(a):
                return None
            a = Column(np.array([a], "datetime64[D]"))
            return int(apply_func(name, [a], 1).values[0])
        if name == "year":
            vals = a.values.astype("datetime64[Y]").astype(np.int64) + 1970
        else:
            vals = a.values.astype("datetime64[M]").astype(np.int64) % 12 + 1
        return Column(vals, a.valid)
    raise UnsupportedSqlError(f"unsupported function {name!r}",
                              error_class="DELTA_UNSUPPORTED_FUNCTION",
                              construct=f"{name}()")

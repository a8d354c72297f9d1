"""Host evaluation of expressions over a `models.batch.Batch` (or a
`NamespacedBatch`, whose columns are named `space.column`), with SQL
three-valued logic.

Counterpart of `delta_tpu/expressions/eval.py:35-95`
(`evaluate_predicate_host`), which evaluates with Arrow compute. Here every
intermediate is a `Values`: a kind, numpy data and a validity mask (False
= NULL). Comparisons involving NULL are NULL; AND and OR are Kleene (false
wins over NULL in AND, true wins in OR); NOT keeps NULL; IS [NOT] NULL and
IN give definite booleans. `evaluate_predicate` turns NULL into False
(WHERE semantics).

Comparisons follow Arrow's kernel rules, so that both packages accept and
refuse the same operand types: numbers compare with numbers (an integer
beside a float compares as float64, through Arrow's safe cast, which
refuses the comparison when a valid integer lies past ±2^53), booleans with booleans, strings with
strings (by code point, which is UTF-8 byte order), dates and timestamps
with each other as microseconds, except a zone-less timestamp with a zoned
one, which Arrow refuses; a NULL-typed operand gives NULL against
anything; any other pair raises `UnsupportedComparison`. IN casts its
values to the column's kind first, as Arrow's `is_in` casts its value set
(an integer to a float, a date string to a date; a number never to a
string). A `datetime64[us]`
column of a Batch holds a Delta `timestamp`, UTC instants: it is zoned
(Arrow's `timestamp[us, tz=UTC]`), and compares with a zoned `datetime`
literal (at its UTC instant) or a date, not with a naive `datetime`; a
`timestamp_ntz` column (its `Column.data_type`) is zone-less and compares
with a naive one. Byte and short columns compare as integers, never
wrapping. A decimal column or `Decimal` literal compares exactly with
another decimal or an integer (both at the larger scale, as Arrow's
common decimal type), and as float64 with a float; binary compares with
binary, or a string's UTF-8 bytes, byte by byte.
"""

from __future__ import annotations

import datetime
import decimal
import math
import operator
import re
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from delta_tpu_torch.errors import InvalidArgumentError
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
    StartsWith,
)
from delta_tpu_torch.models.batch import NamespacedBatch, decimal_value, zeros
from delta_tpu_torch.models.schema import decimal_precision_scale
from delta_tpu_torch.utils.timestamps import string_to_us

_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_US = datetime.timedelta(microseconds=1)


class UnsupportedComparison(TypeError):
    """No Arrow comparison kernel matches the two operand kinds."""


class UnsupportedCast(InvalidArgumentError):
    """A SET value that Arrow refuses for its column type (`cast_values`,
    `constant_values`): a type pair with no cast, or a value out of the
    type's range (CAST_INVALID_INPUT for a string that does not parse)."""

    error_class = "DELTA_UPDATE_SCHEMA_MISMATCH_EXPRESSION"


@dataclass
class Values:
    """One operand: `kind` is one of null, bool, int, float, string, date
    (int64 days), ts (int64 microseconds, zone-less), tsz (int64
    microseconds of a UTC instant, zoned), dec (unscaled integers at
    `scale`: int64, or object of Python ints), binary (object of bytes),
    other;
    `data` a numpy array (object of str for string); `valid` bool;
    `zone` the tzinfo of a zoned literal whose zone is not UTC (Arrow
    prints its local time); `float32` True for the values of a float32
    column (Arrow prints their shortest float32 digits)."""

    kind: str
    data: np.ndarray
    valid: np.ndarray
    zone: object = None
    float32: bool = False
    scale: int = 0

    def __len__(self) -> int:
        return int(self.valid.shape[0])


@dataclass
class Kleene:
    """A nullable boolean array: `value` where `known`, NULL elsewhere
    (value is False where unknown)."""

    value: np.ndarray
    known: np.ndarray

    def __and__(self, o: "Kleene") -> "Kleene":
        false = (self.known & ~self.value) | (o.known & ~o.value)
        known = false | (self.known & o.known)
        return Kleene(known & ~false, known)

    def __or__(self, o: "Kleene") -> "Kleene":
        true = (self.known & self.value) | (o.known & o.value)
        known = true | (self.known & o.known)
        return Kleene(true, known)

    def __invert__(self) -> "Kleene":
        return Kleene(self.known & ~self.value, self.known)

    def filled(self, default: bool) -> np.ndarray:
        return np.where(self.known, self.value, default)


def scalar_kind(value) -> Tuple[str, object]:
    """(kind, encoded value) of a Python literal, as `pa.scalar` types
    it; ("other", value) for a type no comparison here accepts."""
    if value is None:
        return "null", None
    if isinstance(value, (bool, np.bool_)):
        return "bool", bool(value)
    if isinstance(value, (int, np.integer)):
        v = int(value)
        return ("int", v) if -(1 << 63) <= v < (1 << 63) else ("other", v)
    if isinstance(value, (float, np.floating)):
        return "float", float(value)
    if isinstance(value, str):
        return "string", value
    if isinstance(value, bytes):
        return "binary", value
    if isinstance(value, decimal.Decimal) and value.is_finite():
        scale = max(0, -value.as_tuple().exponent)
        return "dec", (int(value.scaleb(scale)), scale)
    if isinstance(value, datetime.datetime):
        if value.tzinfo is not None:
            return "tsz", (value - _EPOCH_UTC) // _US
        return "ts", (value - _EPOCH) // _US
    if isinstance(value, datetime.date):
        return "date", (value - datetime.date(1970, 1, 1)).days
    return "other", value


def literal_values(value, n: int) -> Values:
    kind, v = scalar_kind(value)
    if kind == "null":
        return Values("null", np.zeros(n, bool), np.zeros(n, bool))
    scale = 0
    if kind == "dec":
        v, scale = v
    if kind in ("string", "other", "binary") or kind == "dec" and not (
            -(1 << 63) <= v < (1 << 63)):
        data = np.empty(n, object)
        data[:] = [v] * n
    else:
        data = np.full(n, v, dtype={"bool": bool, "int": np.int64,
                                    "float": np.float64}.get(kind, np.int64))
    zone = value.tzinfo if kind == "tsz" and str(value.tzinfo) != "UTC" \
        else None
    return Values(kind, data, np.ones(n, bool), zone, scale=scale)


def column_values(values: np.ndarray, valid, data_type=None) -> Values:
    """A Batch column (its `Column.data_type` where it has one) as
    Values."""
    n = values.shape[0]
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    ps = decimal_precision_scale(data_type)
    if ps is not None:
        return Values("dec", values, valid, scale=ps[1])
    if data_type == "binary":
        return Values("binary", values, valid)
    if data_type == "timestamp_ntz":
        return Values("ts", values.astype("datetime64[us]").view(np.int64),
                      valid)
    if data_type is not None and not isinstance(data_type, str):
        return Values("other", values, valid)  # a nested column
    k = values.dtype.kind
    if k == "b":
        return Values("bool", values, valid)
    if k in "iu":
        return Values("int", values.astype(np.int64, copy=False), valid)
    if k == "f":
        return Values("float", values.astype(np.float64, copy=False), valid,
                      float32=values.dtype == np.float32)
    if k == "O":
        return Values("string", values, valid)
    if k == "M":
        unit = np.datetime_data(values.dtype)[0]
        if unit == "D":
            return Values("date", values.view(np.int64), valid)
        return Values("tsz", values.astype("datetime64[us]").view(np.int64),
                      valid)
    return Values("other", values, valid)


_TEMPORAL = ("date", "ts", "tsz")
_F64_EXACT_INT = 1 << 53
_DATE_RE = re.compile(r"\d{4}-\d{2}-\d{2}")
_OPS = {
    "=": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
}
_PY_OPS = {
    "=": operator.eq, "!=": operator.ne, "<": operator.lt,
    "<=": operator.le, ">": operator.gt, ">=": operator.ge,
}


def _as_float64(v: Values) -> np.ndarray:
    """An int or float operand as float64; an int one by Arrow's safe
    cast, which refuses when a valid value lies past ±2^53."""
    d = v.data[v.valid] if v.kind == "int" else None
    if d is not None and bool(((d > _F64_EXACT_INT)
                               | (d < -_F64_EXACT_INT)).any()):
        raise UnsupportedComparison(
            "an integer past 2^53 does not cast exactly to a float")
    return v.data.astype(np.float64)


def _at_scale(v: Values, scale: int) -> np.ndarray:
    """An int or dec operand's unscaled integers at `scale` (>= its own):
    int64 where every product fits, else Python ints."""
    by = scale - (v.scale if v.kind == "dec" else 0)
    d = v.data
    if by == 0:
        return d
    factor = 10 ** by
    if d.dtype != object and len(d):
        peak = max(abs(int(d.min())), abs(int(d.max())))
        if peak * factor < (1 << 63):
            return d * np.int64(factor)
    out = np.empty(len(d), object)
    out[:] = [int(x) * factor for x in d.tolist()]
    return out


def _dec_as_float64(v: Values) -> np.ndarray:
    """A dec operand as float64, each value rounded once (Arrow casts a
    decimal beside a float to float64)."""
    d = v.data
    if d.dtype != object and v.scale <= 22 and (not len(d) or max(
            abs(int(d.min())), abs(int(d.max()))) <= _F64_EXACT_INT):
        return d.astype(np.float64) / 10.0 ** v.scale
    return np.array([float(decimal_value(int(x), v.scale))
                     for x in d.tolist()], np.float64)


def _common(a: Values, b: Values):
    """The two operands' data in one comparable domain, or raise."""
    ka, kb = a.kind, b.kind
    if ka == kb and ka in ("bool", "int", "float", "date", "ts", "tsz",
                           "binary"):
        return a.data, b.data
    if "dec" in (ka, kb) and {ka, kb} <= {"dec", "int"}:
        scale = max(v.scale for v in (a, b) if v.kind == "dec")
        return _at_scale(a, scale), _at_scale(b, scale)
    if {ka, kb} == {"dec", "float"}:
        return tuple(_dec_as_float64(v) if v.kind == "dec" else v.data
                     for v in (a, b))
    if {ka, kb} == {"binary", "string"}:  # Arrow casts the string
        return tuple(v.data if v.kind == "binary" else np.array(
            [x.encode("utf-8") for x in v.data.tolist()] + [None],
            object)[:-1] for v in (a, b))
    if {ka, kb} == {"int", "float"}:
        return _as_float64(a), _as_float64(b)
    if ka in _TEMPORAL and kb in _TEMPORAL and {ka, kb} != {"ts", "tsz"}:
        to_us = (lambda v: v.data * 86_400_000_000 if v.kind == "date"
                 else v.data)
        return to_us(a), to_us(b)
    if ka == kb == "string":
        return a.data, b.data
    raise UnsupportedComparison(f"no comparison of {ka} with {kb}")


def compare(op: str, a: Values, b: Values) -> Kleene:
    """`a op b` elementwise, NULL where either side is NULL."""
    n = len(a)
    if a.kind == "null" or b.kind == "null":
        return Kleene(np.zeros(n, bool), np.zeros(n, bool))
    x, y = _common(a, b)
    known = a.valid & b.valid
    if x.dtype == object or y.dtype == object:
        fn = _PY_OPS[op]
        value = np.zeros(n, bool)
        idx = np.nonzero(known)[0]
        value[idx] = [fn(x[i], y[i]) for i in idx.tolist()]
    else:
        value = _OPS[op](x, y) & known
    return Kleene(value, known)


def _resolve_column(batch, name_path: Tuple[str, ...]) -> Values:
    """A one-part path names a column of a `Batch`; a two-part path
    `space.name` a column of one batch of a `NamespacedBatch`."""
    name = name_path
    if isinstance(batch, NamespacedBatch) and len(name) == 2:
        batch, name = batch.spaces.get(name[0]), name[1:]
    if batch is None or isinstance(batch, NamespacedBatch) \
            or len(name) != 1 or name[0] not in batch.column_names:
        raise KeyError(f"column {'.'.join(name_path)} not in batch")
    c = batch.column(name[0])
    return column_values(c.values, c.valid, c.data_type)


def _cast_to(kind: str, v):
    """One IN-list value cast to the child's kind, as Arrow's `is_in`
    casts its value set (a safe cast: raise where it would lose)."""
    k, enc = scalar_kind(v)
    if k == kind:
        return enc
    if kind == "float" and k == "int":
        return float(enc)
    if kind == "int" and k == "float" and enc.is_integer():
        return int(enc)
    if kind == "date" and k == "string" and _DATE_RE.fullmatch(enc):
        try:
            return (datetime.date.fromisoformat(enc)
                    - datetime.date(1970, 1, 1)).days
        except ValueError:
            pass
    if kind in ("ts", "tsz") and k == "date":
        return enc * 86_400_000_000
    if kind == "ts" and k == "string":
        us = string_to_us(enc)
        if us is not None:
            return us
    raise UnsupportedComparison(f"cannot cast {v!r} to {kind}")


def _is_in(child: Values, values: tuple) -> Kleene:
    n = len(child)
    has_null = any(v is None for v in values)
    present = [v for v in values if v is not None]
    out = np.zeros(n, bool)
    if present and child.kind in ("dec", "binary"):
        for v in present:  # exact: one `=` per value
            out |= compare("=", child, literal_values(v, n)).filled(False)
    elif present and child.kind != "null":
        if child.kind not in ("bool", "int", "float", "string", "date", "ts",
                              "tsz"):
            raise UnsupportedComparison(f"IN over a {child.kind} column")
        kinds = {scalar_kind(v)[0] for v in present}
        if len(kinds) > 1 and kinds != {"int", "float"}:
            raise UnsupportedComparison(f"IN list of mixed kinds {kinds}")
        wanted = [_cast_to(child.kind, v) for v in present]
        out = np.isin(child.data, np.array(wanted, dtype=child.data.dtype))
    out = np.where(child.valid, out, has_null)
    return Kleene(out, np.ones(n, bool))


def _eval(expr: Expression, batch):
    """Values for a column or literal, Kleene for a predicate."""
    n = batch.num_rows
    if isinstance(expr, Column):
        return _resolve_column(batch, expr.name_path)
    if isinstance(expr, Literal):
        return literal_values(expr.value, n)
    if isinstance(expr, Comparison):
        return compare(expr.op, _as_values(_eval(expr.left, batch)),
                       _as_values(_eval(expr.right, batch)))
    if isinstance(expr, And):
        return _as_kleene(_eval(expr.left, batch)) \
            & _as_kleene(_eval(expr.right, batch))
    if isinstance(expr, Or):
        return _as_kleene(_eval(expr.left, batch)) \
            | _as_kleene(_eval(expr.right, batch))
    if isinstance(expr, Not):
        return ~_as_kleene(_eval(expr.child, batch))
    if isinstance(expr, (IsNull, IsNotNull)):
        child = _eval(expr.child, batch)
        valid = child.known if isinstance(child, Kleene) else child.valid
        if isinstance(child, Values) and child.kind == "null":
            valid = np.zeros(n, bool)
        value = ~valid if isinstance(expr, IsNull) else valid.copy()
        return Kleene(value, np.ones(n, bool))
    if isinstance(expr, In):
        return _is_in(_as_values(_eval(expr.child, batch)),
                      tuple(expr.values))
    if isinstance(expr, StartsWith):
        child = _as_values(_eval(expr.child, batch))
        if child.kind == "null":
            return Kleene(np.zeros(n, bool), np.zeros(n, bool))
        if child.kind != "string":
            raise UnsupportedComparison(
                f"STARTS WITH over a {child.kind} column")
        value = np.zeros(n, bool)
        idx = np.nonzero(child.valid)[0]
        value[idx] = [child.data[i].startswith(expr.prefix)
                      for i in idx.tolist()]
        return Kleene(value, child.valid.copy())
    from delta_tpu_torch.errors import InvalidArgumentError

    raise InvalidArgumentError(
        f"cannot evaluate {expr!r}",
        error_class="DELTA_CANNOT_EVALUATE_EXPRESSION")


def _as_values(v) -> Values:
    if isinstance(v, Kleene):
        return Values("bool", v.value, v.known)
    return v


def _as_kleene(v) -> Kleene:
    if isinstance(v, Kleene):
        return v
    if v.kind == "null":
        return Kleene(np.zeros(len(v), bool), np.zeros(len(v), bool))
    if v.kind != "bool":
        raise UnsupportedComparison(f"a {v.kind} operand is not a predicate")
    return Kleene(v.data & v.valid, v.valid.copy())


def evaluate(expr: Expression, batch) -> Kleene:
    """The predicate `expr` over `batch`, NULLs kept."""
    return _as_kleene(_eval(expr, batch))


def evaluate_predicate(expr: Expression, batch) -> np.ndarray:
    """Boolean selection with NULL -> False (WHERE semantics)."""
    return evaluate(expr, batch).filled(False).astype(bool)


# ---------------------------------------------------------------- SET values

_INT_RE = re.compile(r"-?\d+")
_FLOAT_RE = re.compile(r"[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|nan|inf|"
                       r"infinity)", re.IGNORECASE)
_BOOL_STRINGS = {"true": True, "false": False, "1": True, "0": False}
_US_PER_DAY = 86_400_000_000
_NUMPY = {"long": np.int64, "integer": np.int32, "double": np.float64,
          "float": np.float32, "boolean": bool}


def _int_bounds(type_name: str) -> Tuple[int, int]:
    bits = 64 if type_name == "long" else 32
    return -(1 << (bits - 1)), 1 << (bits - 1)


def _parse_each(v: Values, parse) -> list:
    """`parse` of every valid string (0 for a NULL row); a string it
    refuses raises UnsupportedCast."""
    out = []
    for s, ok in zip(v.data.tolist(), v.valid.tolist()):
        x = parse(s) if ok else 0
        if x is None:
            raise UnsupportedCast(f"cannot cast {s!r}",
                                  error_class="CAST_INVALID_INPUT")
        out.append(x)
    return out


def _parse_int(type_name: str):
    lo, hi = _int_bounds(type_name)

    def parse(s):
        x = int(s) if _INT_RE.fullmatch(s) else None
        return x if x is not None and lo <= x < hi else None
    return parse


def _parse_date(s: str):
    if not _DATE_RE.fullmatch(s):
        return None
    try:
        return (datetime.date.fromisoformat(s)
                - datetime.date(1970, 1, 1)).days
    except ValueError:
        return None


def _float_str(x: float, float32: bool) -> str:
    """A float as Arrow's cast to string prints it: the shortest digits
    that read back as the same float (float32 or float64), in fixed
    notation for a decimal exponent in [-6, 10), else as
    `<digits>e<sign><exponent>`; nan, inf, -inf and -0 by name."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    f = np.float32(x) if float32 else np.float64(x)
    digits, exp = np.format_float_scientific(
        f, unique=True, trim="-").split("e")
    if -6 <= int(exp) < 10:
        return np.format_float_positional(f, unique=True, trim="-")
    return f"{digits}e{int(exp):+d}"


def _local_us(v: Values) -> Tuple[np.ndarray, list]:
    """Timestamps as the microseconds of their local wall time (a zoned
    literal's zone applied, else as they are), and the zone's offset at
    each (empty without a zone)."""
    us = v.data.astype(np.int64)
    if v.zone is None:
        return us, []
    offsets = [(_EPOCH_UTC + x * _US).astimezone(v.zone).utcoffset()
               for x in us.tolist()]
    return us + np.array([o // _US for o in offsets], np.int64), offsets


def _ts_strings(v: Values) -> list:
    """Timestamps as Arrow's cast to string prints them:
    `YYYY-MM-DD HH:MM:SS.ffffff`; a zoned one in its zone's local time,
    followed by `Z` for UTC or the offset as `+HHMM`."""
    us, offsets = _local_us(v)
    suffix = [""] * len(us)
    if v.kind == "tsz" and v.zone is None:
        suffix = ["Z"] * len(us)
    elif v.kind == "tsz":
        minutes = [o // datetime.timedelta(minutes=1) for o in offsets]
        suffix = [f"{'-' if m < 0 else '+'}{abs(m) // 60:02d}{abs(m) % 60:02d}"
                  for m in minutes]
    years = us.astype("datetime64[us]").astype("datetime64[Y]").astype(
        np.int64) + 1970
    if len(years) and (years.min() < -32767 or years.max() > 32767):
        raise UnsupportedCast("cannot print a timestamp past the year 32767")
    # numpy's `<year>-MM-DDTHH:MM:SS.ffffff`, its year written as Arrow
    # writes it: four digits, or five with the sign of a year before 0
    text = np.datetime_as_string(us.astype("datetime64[us]"), unit="us")
    return [f"{y:0{5 if y < 0 else 4}d}{t[-22:].replace('T', ' ')}{z}"
            for y, t, z in zip(years.tolist(), text.tolist(), suffix)]


def evaluate_values(expr: Expression, batch) -> Values:
    """A SET value over `batch`: a column, a literal (typed as `pa.scalar`
    types it) or a predicate (bool, NULL rows invalid)."""
    return _as_values(_eval(expr, batch))


def cast_values(v: Values, type_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """`v` cast to the Delta type `type_name` as Arrow's unsafe cast
    (`cast(..., safe=False)`) does: integers wrap; floats truncate toward
    zero, NaN and values out of range giving the type's minimum; numbers
    become booleans as `!= 0`; booleans become 0/1 and 'true'/'false';
    strings parse strictly (an integer as `-?digits`, a float also with a
    sign, fraction, exponent, nan or inf, a boolean from true/false/1/0 in
    any case, a date as YYYY-MM-DD); a timestamp becomes its microseconds
    or its date (UTC, or a zoned literal's local date), a date midnight
    or its day number (as an integer);
    an integer becomes a timestamp of that many microseconds; a float or
    a timestamp becomes a string as Arrow prints it (`_float_str`,
    `_ts_strings`). Returns (values, valid), NULL rows holding the
    dtype's zero. A pair that Arrow refuses raises UnsupportedCast."""
    k, d, n = v.kind, v.data, len(v)
    t = type_name
    dtype = (np.dtype("datetime64[D]") if t == "date" else
             np.dtype("datetime64[us]") if t == "timestamp" else
             np.dtype(object) if t == "string" else np.dtype(_NUMPY[t]))
    if k == "null":
        return zeros(dtype, n), np.zeros(n, bool)
    out = None
    if t in ("long", "integer"):
        lo, hi = _int_bounds(t)
        if k in ("int", "bool"):
            out = d.astype(_NUMPY[t])  # wraps
        elif k == "float":
            ok = np.isfinite(d) & (d >= lo) & (d < hi)
            out = np.full(n, lo, _NUMPY[t])
            out[ok] = np.trunc(d[ok])
        elif k == "string":
            out = np.array(_parse_each(v, _parse_int(t)), _NUMPY[t])
        elif (k in ("ts", "tsz") and t == "long"
              or k == "date" and t == "integer"):
            out = d.astype(_NUMPY[t])
    elif t in ("double", "float"):
        if k in ("int", "bool", "float"):
            with np.errstate(over="ignore"):  # past float32: inf, as Arrow
                out = d.astype(_NUMPY[t])
        elif k == "string":
            out = np.array(_parse_each(
                v, lambda s: float(s) if _FLOAT_RE.fullmatch(s) else None),
                _NUMPY[t])
    elif t == "boolean":
        if k in ("int", "float"):
            out = d != 0
        elif k == "bool":
            out = d.astype(bool)
        elif k == "string":
            out = np.array(_parse_each(
                v, lambda s: _BOOL_STRINGS.get(s.lower())), bool)
    elif t == "string":
        if k == "string":
            out = d
        elif k in ("float", "ts", "tsz"):
            text = ([_float_str(x, v.float32) for x in d.tolist()]
                    if k == "float" else _ts_strings(v))
            out = np.empty(n, object)
            out[:] = [x if ok else "" for x, ok
                      in zip(text, v.valid.tolist())]
        elif k in ("int", "bool", "date"):
            fmt = {"int": str, "bool": lambda x: "true" if x else "false",
                   "date": lambda x: str(datetime.date(1970, 1, 1)
                                         + datetime.timedelta(days=x))}[k]
            out = np.empty(n, object)
            out[:] = [fmt(x) if ok else "" for x, ok
                      in zip(d.tolist(), v.valid.tolist())]
    elif t == "date":
        if k == "date":
            out = d
        elif k in ("ts", "tsz"):
            out = np.floor_divide(_local_us(v)[0], _US_PER_DAY)
        elif k == "string":
            out = np.array(_parse_each(v, _parse_date), np.int64)
    elif t == "timestamp":
        if k in ("ts", "tsz", "int"):
            out = d
        elif k == "date":
            out = d * _US_PER_DAY
    if out is None:
        raise UnsupportedCast(f"no cast of {k} to {t}")
    if t in ("date", "timestamp"):
        out = np.asarray(out, np.int64).astype(dtype)
    out = np.array(out, dtype)
    out[~v.valid] = zeros(dtype, 1)[0]
    return out, v.valid.copy()


def constant_values(value, type_name: str, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """A Python constant as `n` values of the Delta type `type_name`, as
    Arrow converts it (`pa.array([value] * n, type)`): None is NULL; an
    integer fits the type's range (a float type: exactly, |v| <= 2^53 for
    double and 2^24 for float); a float truncates toward zero into an
    integer type in range; a bool becomes 1.0 in a float type and is
    refused by an integer type; a number (a float truncated toward zero)
    becomes a date of that many days (in int32's range) or a timestamp of
    that many microseconds (in int64's); a datetime becomes its own
    calendar date (its zone ignored) or its instant (a naive one read as
    UTC); a string, a bool and a date go only to their own kind. Anything
    else raises UnsupportedCast."""
    kind, enc = scalar_kind(value)
    if kind == "null":
        return cast_values(literal_values(None, n), type_name)
    t = type_name
    x = None
    if t in ("long", "integer", "date", "timestamp") and kind in ("int",
                                                                "float"):
        lo, hi = _int_bounds({"date": "integer", "timestamp": "long"}.get(
            t, t))
        x = enc if kind == "int" else (math.trunc(enc) if math.isfinite(enc)
                                       else None)
        x = x if x is not None and lo <= x < hi else None
    elif t == "date" and kind in ("date", "ts", "tsz"):
        x = enc if kind == "date" else (value.date()
                                        - datetime.date(1970, 1, 1)).days
    elif t in ("double", "float"):
        exact = 1 << (53 if t == "double" else 24)
        if kind == "int" and -exact <= enc <= exact or kind == "float":
            x = float(enc)
        elif kind == "bool":
            x = float(enc)
    elif kind == {"boolean": "bool", "string": "string"}.get(t) or (
            t == "timestamp" and kind in ("ts", "tsz")):
        x = enc
    if x is None:
        raise UnsupportedCast(f"cannot convert {value!r} to {t}")
    v = literal_values(x, n)
    if t in ("date", "timestamp"):
        v = Values("date" if t == "date" else "tsz", v.data, v.valid)
    return cast_values(v, t)

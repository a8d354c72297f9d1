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
from delta_tpu_torch.models.batch import (
    DECIMAL_TEXT,
    NamespacedBatch,
    decimal_value,
    unscaled,
    zeros,
)
from delta_tpu_torch.models.schema import (
    MAX_INT64_PRECISION,
    decimal_precision_scale,
    numpy_dtype_of,
)
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
    column (Arrow prints their shortest float32 digits); `bits` the width
    of an int column's type (a cast to a decimal needs room for it)."""

    kind: str
    data: np.ndarray
    valid: np.ndarray
    zone: object = None
    float32: bool = False
    scale: int = 0
    bits: int = 64  # an int operand's width (a column's; 64 for a literal)

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
        return Values("int", values.astype(np.int64, copy=False), valid,
                      bits=8 * values.dtype.itemsize)
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
_BITS = {"long": 64, "integer": 32, "short": 16, "byte": 8}
# the digits of an integer type's widest value: a decimal(p,s) target
# takes the type only where p - s holds them
_INT_DIGITS = {64: 19, 32: 10, 16: 5, 8: 3}
_WIDE = decimal.Context(prec=200)


def _int_bounds(type_name: str) -> Tuple[int, int]:
    bits = _BITS.get(type_name, 32)
    return -(1 << (bits - 1)), 1 << (bits - 1)


def _wrap(x: int, bits: int) -> int:
    """x in two's complement of `bits` bits."""
    half = 1 << (bits - 1)
    return ((x + half) % (1 << bits)) - half


def _trunc_div(x: int, by: int) -> int:
    """x / by rounded toward zero."""
    q = abs(x) // by
    return q if x >= 0 else -q


def _rescaled(v: Values, scale: int) -> list:
    """A dec operand's unscaled integers at `scale`: down by truncation
    toward zero, up by multiplication wrapping at 128 bits, as Arrow's
    unsafe decimal cast rescales (no precision check)."""
    by = scale - v.scale
    xs = [int(x) for x in v.data.tolist()]
    if by >= 0:
        f = 10 ** by
        return [_wrap(x * f, 128) for x in xs]
    f = 10 ** -by
    return [_trunc_div(x, f) for x in xs]


def _float_to_decimal(x: float, precision: int, scale: int,
                      float32: bool) -> int:
    """A float as the unscaled integer Arrow's unsafe cast gives: its
    exact binary value at `scale`, rounded half to even; 0 for NaN, an
    infinity or a value past `precision` digits."""
    if not math.isfinite(x):
        return 0
    exact = decimal.Decimal(float(np.float32(x)) if float32 else x)
    q = int(exact.scaleb(scale, _WIDE).to_integral_value(
        decimal.ROUND_HALF_EVEN))
    return q if abs(q) < 10 ** precision else 0


def _parse_decimal(scale: int):
    """A string's decimal at `scale`, as Arrow's cast parses one: an
    optional sign, digits with an optional point, an optional exponent;
    extra fractional digits truncated toward zero."""
    def parse(s):
        if not DECIMAL_TEXT.fullmatch(s):
            return None
        d = decimal.Decimal(s)
        exp = d.as_tuple().exponent
        x = int(d.scaleb(-exp, _WIDE))
        if exp + scale >= 0:
            return x * 10 ** (exp + scale)
        return _trunc_div(x, 10 ** -(exp + scale))
    return parse


def _cast_decimal(v: Values, precision: int, scale: int):
    """`v` as unscaled integers of decimal(precision, scale), or None
    where Arrow has no such cast."""
    k = v.kind
    if k == "dec":
        return _rescaled(v, scale)
    if k == "int":
        if precision - scale < _INT_DIGITS[v.bits]:
            raise UnsupportedCast(
                f"decimal({precision},{scale}) has no room for an "
                f"int{v.bits}: its precision must be at least "
                f"{_INT_DIGITS[v.bits] + scale}")
        f = 10 ** scale
        return [int(x) * f for x in v.data.tolist()]
    if k == "float":
        return [_float_to_decimal(x, precision, scale, v.float32)
                for x in v.data.tolist()]
    if k == "string":
        return _parse_each(v, _parse_decimal(scale))
    return None


def _decimal_as_float(v: Values, float32: bool) -> np.ndarray:
    """A dec operand as Arrow casts it to a float: the unscaled integer
    times the power of ten, in the target's precision."""
    ft = np.float32 if float32 else np.float64
    lanes = np.array([float(x) for x in v.data.tolist()], np.float64) \
        .astype(ft)
    return lanes * ft(float(f"1e-{v.scale}"))


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


def cast_values(v: Values, type_name) -> Tuple[np.ndarray, np.ndarray]:
    """`v` cast to the Delta type `type_name` as Arrow's unsafe cast
    (`cast(..., safe=False)`) does: integers wrap; floats truncate toward
    zero, NaN and values out of range giving the type's minimum (for
    short and byte: int32's, then wrapped); numbers
    become booleans as `!= 0`; booleans become 0/1 and 'true'/'false';
    strings parse strictly (an integer as `-?digits`, a float also with a
    sign, fraction, exponent, nan or inf, a boolean from true/false/1/0 in
    any case, a date as YYYY-MM-DD); a timestamp becomes its microseconds
    or its date (UTC, or a zoned literal's local date), a date midnight
    or its day number (as an integer);
    an integer becomes a timestamp of that many microseconds; a float or
    a timestamp becomes a string as Arrow prints it (`_float_str`,
    `_ts_strings`).

    Decimals: a decimal rescales, extra digits truncated toward zero,
    with no precision check; an integer needs a precision that holds its
    type's widest value past the scale (Arrow refuses the cast otherwise,
    unsafe or not); a float rounds its exact value half to even, 0 where
    NaN, infinite or past the precision; a string parses (sign, digits,
    point, exponent) and truncates. A decimal becomes an integer truncated
    toward zero and wrapped, a float as its unscaled value times the power
    of ten, a string as `str(Decimal)`. A string becomes binary as its
    UTF-8 bytes, binary a string when it is UTF-8. A timestamp_ntz takes
    what a timestamp takes, and a string as `string_to_us` parses it. A
    nested column keeps its values. Returns (values, valid), NULL rows
    holding the dtype's zero. A pair that Arrow refuses raises
    UnsupportedCast."""
    k, d, n = v.kind, v.data, len(v)
    t = type_name
    dtype = numpy_dtype_of(t)
    if k == "null":
        return zeros(dtype, n, t), np.zeros(n, bool)
    out = None
    ps = decimal_precision_scale(t)
    if not isinstance(t, str):
        if k == "other":  # a nested column into its own type
            out = d
    elif ps is not None:
        out = _cast_decimal(v, *ps)
        if out is not None and ps[0] <= MAX_INT64_PRECISION:
            if any(not -(1 << 63) <= x < (1 << 63) for x in out):
                raise UnsupportedCast(f"a value past int64 in a {t} column")
    elif t in _BITS:
        lo, hi = _int_bounds(t)
        if k in ("int", "bool"):
            out = d.astype(dtype)  # wraps
        elif k == "float":
            lo32, hi32 = _int_bounds("integer") if _BITS[t] < 32 else (lo,
                                                                       hi)
            ok = np.isfinite(d) & (d >= lo32) & (d < hi32)
            out = np.full(n, lo32, np.int64)
            out[ok] = np.trunc(d[ok])
            out = out.astype(dtype)  # short, byte: wrapped
        elif k == "string":
            out = np.array(_parse_each(v, _parse_int(t)), dtype)
        elif k == "dec":
            bits = _BITS[t]
            f = 10 ** v.scale
            out = np.array([_wrap(_trunc_div(int(x), f), bits) if ok else 0
                            for x, ok in zip(d.tolist(), v.valid.tolist())],
                           dtype)
        elif (k in ("ts", "tsz") and t == "long"
              or k == "date" and t == "integer"):
            out = d.astype(dtype)
    elif t in ("double", "float"):
        if k in ("int", "bool", "float"):
            with np.errstate(over="ignore"):  # past float32: inf, as Arrow
                out = d.astype(dtype)
        elif k == "dec":
            with np.errstate(over="ignore"):
                out = _decimal_as_float(v, t == "float")
        elif k == "string":
            out = np.array(_parse_each(
                v, lambda s: float(s) if _FLOAT_RE.fullmatch(s) else None),
                dtype)
    elif t == "boolean":
        if k in ("int", "float"):
            out = d != 0
        elif k == "bool":
            out = d.astype(bool)
        elif k == "string":
            out = np.array(_parse_each(
                v, lambda s: _BOOL_STRINGS.get(s.lower())), bool)
    elif t == "binary":
        if k == "binary":
            out = d
        elif k == "string":
            out = np.empty(n, object)
            out[:] = [x.encode("utf-8") for x in d.tolist()]
    elif t == "string":
        if k == "string":
            out = d
        elif k == "binary":
            out = np.empty(n, object)
            try:
                out[:] = [x.decode("utf-8") for x in d.tolist()]
            except UnicodeDecodeError as e:
                raise UnsupportedCast(f"binary that is not UTF-8: {e}",
                                      error_class="CAST_INVALID_INPUT")
        elif k == "dec":
            out = np.empty(n, object)
            out[:] = [str(decimal_value(int(x), v.scale)) if ok else ""
                      for x, ok in zip(d.tolist(), v.valid.tolist())]
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
    elif t in ("timestamp", "timestamp_ntz"):
        if k in ("ts", "tsz", "int"):
            out = d
        elif k == "date":
            out = d * _US_PER_DAY
        elif k == "string" and t == "timestamp_ntz":
            out = _parse_each(v, string_to_us)
    if out is None:
        raise UnsupportedCast(f"no cast of {k} to {t}")
    if t in ("date", "timestamp", "timestamp_ntz"):
        out = np.asarray(out, np.int64).astype(dtype)
    if dtype == object:
        arr = np.empty(n, object)
        for i, x in enumerate(out):  # lists stay elements
            arr[i] = x
        out = arr
    else:
        out = np.array(out, dtype)
    out[~v.valid] = zeros(dtype, 1, t)[0]
    return out, v.valid.copy()


def constant_values(value, type_name: str, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """A Python constant as `n` values of the Delta type `type_name`, as
    Arrow converts it (`pa.array([value] * n, type)`): None is NULL; an integer
    fits the type's range (a float type: exactly, |v| <= 2^53 for double and
    2^24 for float); a float truncates toward zero into an integer type in
    range; a bool becomes 1.0 in a float type and is refused by an integer
    type; a Decimal truncates toward zero into an integer type, a date or a
    timestamp as a float does; a number (a float truncated toward zero) becomes
    a date of that many days (in int32's range) or a timestamp of that many
    microseconds (in int64's); a datetime becomes its own calendar date (its
    zone ignored) or its instant (a naive one read as UTC; a timestamp_ntz
    takes the instant's UTC wall time); a string, a bool and a date go only to
    their own kind, and UTF-8 bytes to a string. A decimal takes an int or a
    Decimal that fits its scale without losing a digit and its precision;
    binary takes bytes, or a string as its UTF-8 bytes; a nested type takes its
    Python value as it is. Anything else raises UnsupportedCast."""
    kind, enc = scalar_kind(value)
    if kind == "null":
        return cast_values(literal_values(None, n), type_name)
    t = type_name
    ps = decimal_precision_scale(t)
    if not isinstance(t, str) or ps is not None or t == "binary":
        return _constant_object(value, kind, t, ps, n)
    x = None
    if t in ("long", "integer", "short", "byte", "date", "timestamp",
             "timestamp_ntz") and kind in ("int", "float", "dec"):
        lo, hi = _int_bounds({"date": "integer", "timestamp": "long",
                              "timestamp_ntz": "long"}.get(t, t))
        x = (enc if kind == "int" else math.trunc(value) if kind == "dec"
             else math.trunc(enc) if math.isfinite(enc) else None)
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
            t in ("timestamp", "timestamp_ntz") and kind in ("ts", "tsz")):
        x = enc
    elif t == "string" and isinstance(value, (bytes, bytearray)):
        try:
            x = bytes(value).decode("utf-8")
        except UnicodeDecodeError:
            x = None
    if x is None:
        raise UnsupportedCast(f"cannot convert {value!r} to {t}")
    v = literal_values(x, n)
    if t in ("date", "timestamp", "timestamp_ntz"):
        v = Values("date" if t == "date" else "tsz", v.data, v.valid)
    return cast_values(v, t)


def _constant_object(value, kind: str, t, ps, n: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """`constant_values` into a decimal, binary or nested type."""
    x = None
    if ps is not None and kind in ("int", "dec", "other") \
            and not isinstance(value, (bool, np.bool_)) \
            and isinstance(value, (int, np.integer, decimal.Decimal)):
        try:
            x = unscaled(decimal.Decimal(int(value)) if not isinstance(
                value, decimal.Decimal) else value, ps[1])
        except ValueError:
            x = None
        if x is not None and abs(x) >= 10 ** ps[0]:
            x = None
    elif t == "binary" and isinstance(value, (bytes, bytearray, str)):
        x = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    elif not isinstance(t, str):
        x = value
    if x is None:
        raise UnsupportedCast(f"cannot convert {value!r} to {t}")
    out = zeros(numpy_dtype_of(t), n, t)
    for i in range(n):
        out[i] = x
    return out, np.ones(n, bool)

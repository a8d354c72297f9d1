"""Rows in memory: named numpy columns plus validity.

The port's stand-in for the Arrow tables the JAX package reads and writes
data files with. A `Column` is a numpy array and an optional bool
validity mask (None: every row is valid), and, where the dtype does not
say the Delta type, that type (`data_type`, a `models/schema.py` type).
By type: long int64, integer int32, short int16, byte int8, double
float64, float float32, boolean bool, string an object array of `str`,
binary one of `bytes`, date datetime64[D], timestamp datetime64[us] (UTC
instants), timestamp_ntz datetime64[us] (wall times; `data_type`
"timestamp_ntz"); `decimal(p,s)` its unscaled integers with the type
beside them: int64 lanes for p <= 18, an object array of Python ints
above; a struct an object array of dicts, an array one of lists, a map
one of lists of (key, value) tuples in file order, their elements the
Python values Arrow's `to_pylist` gives. `Column.to_python()` gives a
column's rows as `to_pylist` does (`decimal.Decimal`s of the column's
scale). Null rows hold the type's zero (0, 0.0, False, "", b"", the
epoch; None for a nested type), which is also what OPTIMIZE fills nulls
with before it builds curve keys.
"""

from __future__ import annotations

import datetime
import decimal
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from delta_tpu_torch.models.schema import (
    DataType,
    carried_type,
    decimal_precision_scale,
    numpy_dtype_of,
)

# exact for every decimal the protocol allows (38 digits)
_DECIMAL_CONTEXT = decimal.Context(prec=80)
# a decimal's text as Arrow parses one: a sign, digits with an optional
# point, an optional exponent
DECIMAL_TEXT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_EPOCH_DATE = datetime.date(1970, 1, 1)
_US = datetime.timedelta(microseconds=1)


def factorize_objects(values: np.ndarray) -> np.ndarray:
    """Dense int64 codes of an object array by Python equality, in order
    of first appearance. Not by `astype(str)`: numpy's fixed-width
    strings drop trailing NULs, so "a" and "a\x00" would share a code."""
    seen: dict = {}
    return np.fromiter((seen.setdefault(v, len(seen)) for v in values),
                       np.int64, len(values))


def decimal_value(unscaled: int, scale: int) -> decimal.Decimal:
    """The Decimal of an unscaled integer at `scale`, with the scale's
    digits (`Decimal('1.50')` for 150 at 2), as Arrow gives it."""
    return decimal.Decimal(unscaled).scaleb(-scale, _DECIMAL_CONTEXT)


@dataclass
class Column:
    values: np.ndarray
    valid: Optional[np.ndarray] = None
    data_type: Optional[DataType] = None  # where the dtype does not say

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def null_count(self) -> int:
        return 0 if self.valid is None else int((~self.valid).sum())

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.values[idx],
                      None if self.valid is None else self.valid[idx],
                      self.data_type)

    def slice(self, lo: int, hi: int) -> "Column":
        return Column(self.values[lo:hi],
                      None if self.valid is None else self.valid[lo:hi],
                      self.data_type)

    @staticmethod
    def nulls(dtype: np.dtype, n: int, data_type=None) -> "Column":
        return Column(zeros(dtype, n, data_type), np.zeros(n, bool),
                      data_type)

    @staticmethod
    def concat(parts: Sequence["Column"]) -> "Column":
        values = np.concatenate([p.values for p in parts])
        dt = next((p.data_type for p in parts if p.data_type is not None),
                  None)
        if all(p.valid is None for p in parts):
            return Column(values, None, dt)
        return Column(values, np.concatenate(
            [np.ones(len(p), bool) if p.valid is None else p.valid
             for p in parts]), dt)

    def to_python(self) -> list:
        """The rows as Python values, None where null, as Arrow's
        `to_pylist` gives them: Decimals of the column's scale, naive
        datetimes for timestamp_ntz and UTC ones for timestamp, dates,
        bytes, and the nested values as they are."""
        v = self.values
        ps = decimal_precision_scale(self.data_type)
        if ps is not None:
            out = [decimal_value(int(x), ps[1]) for x in v.tolist()]
        elif v.dtype == np.dtype("datetime64[us]"):
            us = v.astype(np.int64).tolist()
            if self.data_type == "timestamp_ntz":
                base = _EPOCH_UTC.replace(tzinfo=None)
            else:
                base = _EPOCH_UTC
            out = [base + datetime.timedelta(microseconds=x) for x in us]
        else:
            out = v.tolist()
        if self.valid is not None:
            out = [x if ok else None for x, ok in
                   zip(out, self.valid.tolist())]
        return out


def unscaled(value, scale: int) -> int:
    """The unscaled integer of a Decimal or an int at `scale`; a value
    with more fractional digits than the scale raises ValueError (Arrow
    refuses to lose them)."""
    if isinstance(value, decimal.Decimal):
        x = value.scaleb(scale, _DECIMAL_CONTEXT)
        if not x.is_finite() or x != x.to_integral_value():
            raise ValueError(f"{value} does not fit scale {scale}")
        return int(x)
    return int(value) * 10 ** scale


def _micros(value: datetime.datetime) -> int:
    if value.tzinfo is not None:
        return (value - _EPOCH_UTC) // _US
    return (value - _EPOCH_UTC.replace(tzinfo=None)) // _US


def column_from_python(values: Sequence, data_type) -> Column:
    """The Column of Python values of Delta type `data_type` as
    `Column.to_python()` gives them (None where null): the inverse of
    `to_python`. A naive datetime in a timestamp column is read as UTC,
    an aware one in a timestamp_ntz column as its UTC wall time; a
    decimal takes Decimals or ints."""
    n = len(values)
    valid = np.fromiter((v is not None for v in values), bool, n)
    dtype = numpy_dtype_of(data_type)
    out = zeros(dtype, n, data_type)
    idx = np.flatnonzero(valid)
    present = [values[i] for i in idx.tolist()]
    ps = decimal_precision_scale(data_type)
    if ps is not None:
        lanes = [unscaled(v, ps[1]) for v in present]
        if dtype == object:
            for i, x in zip(idx.tolist(), lanes):
                out[i] = x
        else:
            out[idx] = np.array(lanes, np.int64)
    elif dtype == np.dtype("datetime64[us]"):
        out[idx] = np.array([_micros(v) for v in present], np.int64) \
            .astype(dtype)
    elif dtype == np.dtype("datetime64[D]"):
        out[idx] = np.array([(v - _EPOCH_DATE).days for v in present],
                            np.int64).astype(dtype)
    elif dtype == object:
        for i, x in zip(idx.tolist(), present):
            out[i] = x
    else:
        out[idx] = np.array(present, dtype)
    return Column(out, None if bool(valid.all()) else valid,
                  carried_type(data_type))


def zeros(dtype: np.dtype, n: int, data_type=None) -> np.ndarray:
    """`n` null rows: the dtype's zero; for an object column "" (string),
    b"" (binary), 0 (a wide decimal) or None (a nested type)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "O":
        out = np.empty(n, object)
        if data_type is None or data_type == "string":
            out[:] = ""
        elif data_type == "binary":
            out[:] = b""
        elif isinstance(data_type, str):  # a decimal past 18 digits
            out[:] = 0
        return out
    return np.zeros(n, dtype)


class Batch:
    """An ordered set of equal-length named columns."""

    def __init__(self, columns: Dict[str, Column], num_rows: int = None):
        self.columns = dict(columns)
        lens = {len(c) for c in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(f"columns of unequal length: {sorted(lens)}")
        self.num_rows = lens.pop() if lens else int(num_rows or 0)

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> Column:
        return self.columns[name]

    def take(self, idx: np.ndarray) -> "Batch":
        return Batch({k: c.take(idx) for k, c in self.columns.items()},
                     len(idx))

    def slice(self, lo: int, hi: int) -> "Batch":
        hi = min(hi, self.num_rows)
        return Batch({k: c.slice(lo, hi) for k, c in self.columns.items()},
                     max(0, hi - lo))

    @staticmethod
    def concat(parts: Iterable["Batch"]) -> "Batch":
        parts = list(parts)
        if len(parts) == 1:
            return parts[0]
        names = parts[0].column_names
        return Batch({k: Column.concat([p.columns[k] for p in parts])
                      for k in names},
                     sum(p.num_rows for p in parts))


class NamespacedBatch:
    """Batches of equal length side by side under names: MERGE's rows as
    `target` and `source` (the counterpart of the reference's struct
    columns, `delta_tpu/commands/merge.py:224`). An expression reads a
    column of one as `target.<name>` (`expressions/eval.py`)."""

    def __init__(self, spaces: Dict[str, Batch]):
        self.spaces = dict(spaces)
        lens = {b.num_rows for b in self.spaces.values()}
        if len(lens) != 1:
            raise ValueError(f"namespaces of unequal length: {sorted(lens)}")
        self.num_rows = lens.pop()

    @property
    def column_names(self) -> List[str]:
        return list(self.spaces)


def as_column(v) -> Column:
    """A Column from a Column, a (values, valid) pair, or an array-like
    (a str array becomes an object array of str)."""
    if isinstance(v, Column):
        return v
    valid = None
    if isinstance(v, tuple):
        v, valid = v
        valid = None if valid is None else np.asarray(valid, bool)
    arr = np.asarray(v)
    if arr.dtype.kind in ("U", "S"):
        arr = arr.astype(str).astype(object)
    if valid is not None:
        arr = arr.copy()
        arr[~valid] = zeros(arr.dtype, 1)[0]
    return Column(arr, valid)

"""Rows in memory: named numpy columns plus validity.

The port's stand-in for the Arrow tables the JAX package reads and writes
data files with. A `Column` is a numpy array (int64, int32, float64,
float32, bool, object of `str`, datetime64[D], datetime64[us]) and an
optional bool validity mask (None: every row is valid). Null rows hold
the dtype's zero (0, 0.0, False, "", the epoch), which is also what
OPTIMIZE fills nulls with before it builds curve keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


def factorize_objects(values: np.ndarray) -> np.ndarray:
    """Dense int64 codes of an object array by Python equality, in order
    of first appearance. Not by `astype(str)`: numpy's fixed-width
    strings drop trailing NULs, so "a" and "a\x00" would share a code."""
    seen: dict = {}
    return np.fromiter((seen.setdefault(v, len(seen)) for v in values),
                       np.int64, len(values))


@dataclass
class Column:
    values: np.ndarray
    valid: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def null_count(self) -> int:
        return 0 if self.valid is None else int((~self.valid).sum())

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.values[idx],
                      None if self.valid is None else self.valid[idx])

    def slice(self, lo: int, hi: int) -> "Column":
        return Column(self.values[lo:hi],
                      None if self.valid is None else self.valid[lo:hi])

    @staticmethod
    def nulls(dtype: np.dtype, n: int) -> "Column":
        return Column(zeros(dtype, n), np.zeros(n, bool))

    @staticmethod
    def concat(parts: Sequence["Column"]) -> "Column":
        values = np.concatenate([p.values for p in parts])
        if all(p.valid is None for p in parts):
            return Column(values)
        return Column(values, np.concatenate(
            [np.ones(len(p), bool) if p.valid is None else p.valid
             for p in parts]))


def zeros(dtype: np.dtype, n: int) -> np.ndarray:
    dtype = np.dtype(dtype)
    if dtype.kind == "O":
        out = np.empty(n, object)
        out[:] = ""
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

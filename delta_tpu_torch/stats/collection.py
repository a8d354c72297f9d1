"""Per-file statistics collected on write.

Counterpart of `delta_tpu/stats/collection.py:36-178`, over a
`models.batch.Batch` instead of an Arrow table. Each written file's
`AddFile` carries a JSON `stats` document: `numRecords`, and
`minValues` / `maxValues` / `nullCount` per indexed leaf column (the
first `delta.dataSkippingNumIndexedCols` = 32 leaves by default, or the
explicit `delta.dataSkippingStatsColumns` list). The string is byte for
byte the reference's for the same rows:

- min/max over the valid values; NaN never takes part (a column holding
  one has max NaN, and min and max are "NaN" when every valid value is
  NaN); among equal values (0.0 and -0.0) the first row wins, as
  Arrow's min/max kernels keep it;
- strings truncated to 32 characters, the max bumped upward
  (`bump_string`) and dropped when it cannot be;
- NaN and infinities as the strings "NaN", "Infinity", "-Infinity";
  dates as ISO dates; timestamps as `%Y-%m-%dT%H:%M:%S.%f%z` in UTC,
  timestamp_ntz ones without the zone; a decimal as `float(value)`;
- a leaf inside a struct is found by its name path, null where any
  struct above it is null;
- booleans, binary, arrays and maps get a null count only.

Under column mapping the leaves are chosen by their logical paths and
keyed by their physical ones, at every depth (the reference keys the
top level only, and drops the stats of nested leaves).
"""

from __future__ import annotations

import datetime as dt
import decimal
import json
import math
from typing import Any, Dict, List, Optional

import numpy as np

from delta_tpu_torch.columnmapping import is_mapped, physical_name_path
from delta_tpu_torch.config import (
    DATA_SKIPPING_NUM_INDEXED_COLS,
    DATA_SKIPPING_STATS_COLUMNS,
    get_table_config,
)
from delta_tpu_torch.models.batch import (
    Batch,
    column_from_python,
    decimal_value,
)
from delta_tpu_torch.models.schema import (
    StructType,
    decimal_precision_scale,
)

MAX_STRING_PREFIX_LENGTH = 32
_EPOCH_DATE = dt.date(1970, 1, 1)
_EPOCH_TS = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)
_MINMAX_TYPES = frozenset({"long", "integer", "short", "byte", "double",
                           "float", "string", "date", "timestamp",
                           "timestamp_ntz"})


def _truncate_min(s: str) -> str:
    return s[:MAX_STRING_PREFIX_LENGTH]


def bump_string(s: str) -> Optional[str]:
    """Smallest convenient string > every string with prefix `s`:
    increment the last bumpable character. None when every character is
    already U+10FFFF (the caller then drops the max stat)."""
    for i in range(len(s) - 1, -1, -1):
        if ord(s[i]) < 0x10FFFF:
            return s[:i] + chr(ord(s[i]) + 1)
    return None


def _truncate_max(s: str) -> Optional[str]:
    if len(s) <= MAX_STRING_PREFIX_LENGTH:
        return s
    return bump_string(s[:MAX_STRING_PREFIX_LENGTH])


def _json_value(v: Any) -> Any:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return v
    if isinstance(v, dt.datetime):
        return v.strftime("%Y-%m-%dT%H:%M:%S.%f%z") or v.isoformat()
    if isinstance(v, dt.date):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return float(v)
    return v


def _set_nested(d: dict, path: List[str], value) -> None:
    for p in path[:-1]:
        d = d.setdefault(p, {})
    d[path[-1]] = value


def stats_columns(schema, configuration: Dict[str, str],
                  partition_columns: List[str]) -> List[List[str]]:
    """Leaf name-paths to index: the explicit list, or the first N leaves
    that are not partition columns (all of them when N < 0)."""
    explicit = get_table_config(configuration, DATA_SKIPPING_STATS_COLUMNS)
    if explicit:
        return [c.split(".") for c in explicit]
    n = get_table_config(configuration, DATA_SKIPPING_NUM_INDEXED_COLS)
    leaves = [list(p) for p, _ in schema.leaves()]
    leaves = [p for p in leaves if p[0] not in set(partition_columns)]
    if n < 0:
        return leaves
    return leaves[:n]


def _first_extreme(v: np.ndarray, fn) -> float:
    """min or max of NaN-free floats; of equal extremes (0.0 and -0.0)
    the first row's."""
    m = fn(v)
    if m == 0:
        return float(v[int(np.argmax(v == 0))])
    return float(m)


def _min_max(type_name: str, v: np.ndarray):
    """(min, max) as Python values of the non-empty valid values `v`;
    floats with a NaN return max NaN, all-NaN returns ("NaN", "NaN")."""
    if type_name in ("double", "float"):
        nan = np.isnan(v)
        clean = v[~nan]
        if clean.size == 0:
            return "NaN", "NaN"
        mn = _first_extreme(clean, np.min)
        mx = float("nan") if nan.any() else _first_extreme(clean, np.max)
        return mn, mx
    if type_name in ("long", "integer", "short", "byte"):
        return int(v.min()), int(v.max())
    ps = decimal_precision_scale(type_name)
    if ps is not None:
        return (decimal_value(int(v.min()), ps[1]),
                decimal_value(int(v.max()), ps[1]))
    if type_name == "date":
        days = v.astype("datetime64[D]").astype(np.int64)
        return (_EPOCH_DATE + dt.timedelta(days=int(days.min())),
                _EPOCH_DATE + dt.timedelta(days=int(days.max())))
    if type_name in ("timestamp", "timestamp_ntz"):
        us = v.astype("datetime64[us]").astype(np.int64)
        base = (_EPOCH_TS if type_name == "timestamp"
                else _EPOCH_TS.replace(tzinfo=None))
        return (base + dt.timedelta(microseconds=int(us.min())),
                base + dt.timedelta(microseconds=int(us.max())))
    vals = v.tolist()  # strings
    return min(vals), max(vals)


def _leaf_column(batch: Batch, schema, path: List[str]):
    """(the leaf's Column, its type) at a name path: a top-level column,
    or a field of structs (null where a struct above it is null, as
    Arrow's `struct_field` gives it); None when the path names no such
    leaf. A nested type's name is struct, array or map."""
    if path[0] not in batch.columns or path[0] not in schema:
        return None
    col, t = batch.columns[path[0]], schema[path[0]].data_type
    if len(path) > 1:
        rows = col.to_python()
        for name in path[1:]:
            if not isinstance(t, StructType) or name not in t:
                return None
            t = t[name].data_type
            rows = [None if r is None else r.get(name) for r in rows]
        col = column_from_python(rows, t)
    return col, (t if isinstance(t, str) else type(t).__name__)


def collect_stats(batch: Batch, schema, configuration: Dict[str, str],
                  partition_columns: List[str]) -> str:
    """Stats JSON for one written file."""
    cols = stats_columns(schema, configuration, partition_columns)
    mapped = is_mapped(configuration)
    stats: dict = {"numRecords": batch.num_rows}
    min_d: dict = {}
    max_d: dict = {}
    null_d: dict = {}
    for path in cols:
        leaf = _leaf_column(batch, schema, path)
        if leaf is None:
            continue
        col, type_name = leaf
        if mapped:
            path = physical_name_path(schema, tuple(path)) or path
        null_count = col.null_count
        _set_nested(null_d, path, int(null_count))
        if not (type_name in _MINMAX_TYPES
                or decimal_precision_scale(type_name)) \
                or len(col) == null_count:
            continue
        v = col.values if col.valid is None else col.values[col.valid]
        mn, mx = _min_max(type_name, v)
        if isinstance(mn, str) and type_name == "string":
            mn = _truncate_min(mn)
            mx_t = _truncate_max(mx)
            if mx_t is None:
                _set_nested(min_d, path, _json_value(mn))
                continue
            mx = mx_t
        _set_nested(min_d, path, _json_value(mn))
        _set_nested(max_d, path, _json_value(mx))
    if min_d:
        stats["minValues"] = min_d
        stats["maxValues"] = max_d
    stats["nullCount"] = null_d
    return json.dumps(stats, separators=(",", ":"))

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
  dates as ISO dates; timestamps as `%Y-%m-%dT%H:%M:%S.%f%z` in UTC;
- booleans get a null count only.
"""

from __future__ import annotations

import datetime as dt
import json
import math
from typing import Any, Dict, List, Optional

import numpy as np

from delta_tpu_torch.config import (
    DATA_SKIPPING_NUM_INDEXED_COLS,
    DATA_SKIPPING_STATS_COLUMNS,
    get_table_config,
)
from delta_tpu_torch.models.batch import Batch

MAX_STRING_PREFIX_LENGTH = 32
_EPOCH_DATE = dt.date(1970, 1, 1)
_EPOCH_TS = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)
_MINMAX_TYPES = frozenset({"long", "integer", "double", "float", "string",
                           "date", "timestamp"})


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
    if type_name in ("long", "integer"):
        return int(v.min()), int(v.max())
    if type_name == "date":
        days = v.astype("datetime64[D]").astype(np.int64)
        return (_EPOCH_DATE + dt.timedelta(days=int(days.min())),
                _EPOCH_DATE + dt.timedelta(days=int(days.max())))
    if type_name == "timestamp":
        us = v.astype("datetime64[us]").astype(np.int64)
        return (_EPOCH_TS + dt.timedelta(microseconds=int(us.min())),
                _EPOCH_TS + dt.timedelta(microseconds=int(us.max())))
    vals = v.tolist()  # strings
    return min(vals), max(vals)


def collect_stats(batch: Batch, schema, configuration: Dict[str, str],
                  partition_columns: List[str]) -> str:
    """Stats JSON for one written file."""
    cols = stats_columns(schema, configuration, partition_columns)
    stats: dict = {"numRecords": batch.num_rows}
    min_d: dict = {}
    max_d: dict = {}
    null_d: dict = {}
    for path in cols:
        if len(path) != 1 or path[0] not in batch.columns \
                or path[0] not in schema:
            continue
        col = batch.columns[path[0]]
        null_count = col.null_count
        _set_nested(null_d, path, int(null_count))
        type_name = schema[path[0]].type_name
        if type_name not in _MINMAX_TYPES or len(col) == null_count:
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

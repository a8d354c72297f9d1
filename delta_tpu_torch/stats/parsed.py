"""`stats_parsed`: a checkpoint's add stats as typed structs.

Counterpart of the reference's `replay/columnar.py::_stats_from_parsed`
(the read) and `log/checkpointer.py::{_stats_parsed_schema,
_parse_stats_structs}` (the write). With
`delta.checkpoint.writeStatsAsStruct` a checkpoint's add carries
`stats_parsed`: `numRecords`, `minValues`, `maxValues` and `nullCount` as
nested structs, and `tightBounds`; with `writeStatsAsJson=false` that is
the only stats form.

The read (`stats_from_parsed`) turns each add's struct back into the JSON
string the reference makes from `to_pylist()`: nulls pruned at every level
(a present struct whose fields are all null stays `{}`), a row with no
struct None, then `json.dumps(separators=(",", ":"))` with dates as ISO
dates and timestamps as `%Y-%m-%dT%H:%M:%S.%f%z` (`+0000` where the
Parquet timestamp is adjusted to UTC, nothing where it is not). Floats
keep `json`'s own spelling: a NaN is the bare token `NaN`, not the string
`"NaN"` that the stats collector writes.

The write parses the stats strings as Arrow's JSON reader does. First against
the explicit schema of `stats_parsed_schema` (the table schema's indexed
leaves: long int64, integer int32, short int16, byte int8, double float64,
float float32, boolean, string, date date32, timestamp int64 microseconds
adjusted to UTC, timestamp_ntz the same not adjusted, decimal(p,s) Arrow's
decimal128(p,s); `nullCount` int64 per leaf), fields outside it ignored; any
value Arrow's converter refuses (a string for a date, a fraction for an
integer, the string "NaN" for a double, an object for a number, a number with
more digits than a decimal's precision or more fractional digits than its
scale) fails the whole parse. It then falls back to inference
(`stats/skipping.py`'s rules: dates and second-precision date-times become
timestamps in seconds, fractional timestamps stay strings), and when that fails
too, the adds get no `stats_parsed` at all.
"""

from __future__ import annotations

import datetime
import decimal
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.columnmapping import is_mapped
from delta_tpu_torch.log.parquet_data import _as_numpy
from delta_tpu_torch.models.batch import DECIMAL_TEXT, decimal_value
from delta_tpu_torch.models.schema import (
    COLUMN_MAPPING_PHYSICAL_NAME_KEY,
    decimal_precision_scale,
    numpy_dtype_of,
)
from delta_tpu_torch.stats.skipping import _Invalid, _parse_table, _Struct
from delta_tpu_torch.utils.timestamps import json_to_us

_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_DATE = datetime.date(1970, 1, 1)
_UTC = datetime.timezone.utc
_ROOT = ("add", "stats_parsed")
# LogicalType union ids (parquet.thrift)
_LT_DECIMAL, _LT_DATE, _LT_TIMESTAMP, _LT_UNKNOWN = 5, 6, 8, 11
# ConvertedType ids
_CT_DECIMAL, _CT_DATE, _CT_TS_MILLIS, _CT_TS_MICROS = 5, 6, 9, 10


# --------------------------------------------------------------- read --

def _json_default(v):
    """`json.dumps`'s fallback for what it cannot spell (the reference's
    `stats/collection.py::_json_value`, which `json` consults only for
    dates and date-times here)."""
    if isinstance(v, datetime.datetime):
        return v.strftime("%Y-%m-%dT%H:%M:%S.%f%z") or v.isoformat()
    if isinstance(v, datetime.date):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return float(v)
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    raise TypeError(f"{type(v).__name__} is not JSON serializable")


def _timestamp_unit(leaf) -> Tuple[Optional[int], bool]:
    """(microseconds per unit, adjusted to UTC) of an INT64 timestamp
    leaf; (None, False) when the leaf is a plain integer."""
    lt = leaf.logical_type or {}
    ts = lt.get(_LT_TIMESTAMP)
    if isinstance(ts, dict):
        utc = bool(ts.get(1, False))
        unit = ts.get(2) or {}
        if 1 in unit:
            return 1000, utc
        if 2 in unit:
            return 1, utc
        if 3 in unit:
            return -1000, utc  # nanoseconds
        return 1, utc
    if leaf.converted_type == _CT_TS_MILLIS:
        return 1000, True
    if leaf.converted_type == _CT_TS_MICROS:
        return 1, True
    return None, False


def _python_values(hl, vi: np.ndarray) -> list:
    """Python values of one stats leaf at value indices `vi` (-1 = null),
    typed as Arrow's `to_pylist` types them."""
    leaf = hl.leaf
    lt = leaf.logical_type or {}
    if _LT_UNKNOWN in lt:
        return [None] * len(vi)
    if _LT_DECIMAL in lt or leaf.converted_type == _CT_DECIMAL:
        unscaled = _as_numpy("decimal", leaf, hl.values).tolist()
        return [None if i < 0 else decimal_value(int(unscaled[i]),
                                                 leaf.scale or 0)
                for i in vi.tolist()]
    raw = hl._python(vi)
    phys = leaf.physical_type
    if phys == "INT32" and (_LT_DATE in lt or leaf.converted_type == _CT_DATE):
        return [None if v is None else _EPOCH_DATE + datetime.timedelta(days=v)
                for v in raw]
    if phys == "INT64":
        per, utc = _timestamp_unit(leaf)
        if per is not None:
            base = _EPOCH.replace(tzinfo=_UTC) if utc else _EPOCH
            return [None if v is None else base + datetime.timedelta(
                microseconds=(v * per if per > 0 else v // -per))
                for v in raw]
    if phys == "FLOAT":
        return [None if v is None else float(np.float32(v)) for v in raw]
    return raw


def stats_from_parsed(footer, data: bytes, rows: np.ndarray
                      ) -> List[Optional[str]]:
    """The stats JSON string of each add at part `rows` (ascending), from
    the part's `add.stats_parsed` leaves; None where an add has no
    struct."""
    from delta_tpu_torch.log.parquet_host import read_leaves

    paths = [lf.path for lf in footer.leaves if lf.parts[:2] == _ROOT]
    leaves = read_leaves(footer, data, paths)
    n = len(rows)
    depth0 = len(_ROOT)  # path index of stats_parsed itself
    # tree of struct paths (relative to stats_parsed) -> children order
    kids: Dict[tuple, list] = {(): []}
    present: Dict[tuple, np.ndarray] = {}
    values: Dict[tuple, list] = {}
    for p in paths:
        hl = leaves[p]
        rel = hl.leaf.parts[depth0:]
        level = hl.level(rows)
        for k in range(len(rel)):
            node, parent = rel[:k + 1], rel[:k]
            if node not in kids.setdefault(parent, []):
                kids[parent].append(node)
            if k < len(rel) - 1:
                kids.setdefault(node, [])
                if node not in present:
                    present[node] = level >= hl.leaf.def_at[depth0 + k]
        if () not in present:
            present[()] = level >= hl.leaf.def_at[depth0 - 1]
        values[rel] = _python_values(hl, hl.value_index[rows])

    def build(node, i):
        if node in values:
            return values[node][i]
        if not present[node][i]:
            return None
        out = {}
        for child in kids[node]:
            v = build(child, i)
            if v is not None:
                out[child[-1]] = v
        return out

    out: List[Optional[str]] = []
    if () not in present:
        return [None] * n
    for i in range(n):
        r = build((), i)
        out.append(json.dumps(r, separators=(",", ":"), default=_json_default)
                   if r else None)
    return out


# -------------------------------------------------------------- write --

@dataclass
class SType:
    """A `stats_parsed` field type: a struct of named fields, or a leaf
    kind: int64, int32, int16, int8, float64, float32, bool, string,
    date32, ts_us_utc, ts_us (no zone), decimal(p,s) (the explicit
    schema's), ts_s (inferred date-times, in seconds, no
    zone) or null (a column that is null in every row)."""

    kind: str
    fields: Dict[str, "SType"] = field(default_factory=dict)


@dataclass
class SColumn:
    """A parsed column: a leaf's values (numpy, object array of str for
    strings) and validity, or a struct's validity and fields."""

    type: SType
    valid: np.ndarray
    data: object = None
    fields: Dict[str, "SColumn"] = field(default_factory=dict)


_LEAF_KIND = {"long": "int64", "integer": "int32", "short": "int16",
              "byte": "int8", "double": "float64", "float": "float32",
              "boolean": "bool", "string": "string", "date": "date32",
              "timestamp": "ts_us_utc", "timestamp_ntz": "ts_us"}


class _SchemaLeaves:
    """A parsed schemaString's leaf name paths, nested structs walked
    (what `stats_columns` asks of a schema)."""

    def __init__(self, root: dict):
        self._root = root

    def leaves(self):
        out = []

        def walk(node, prefix):
            for f in node.get("fields", []):
                t = f.get("type")
                path = prefix + (f.get("name"),)
                if isinstance(t, dict) and t.get("type") == "struct":
                    walk(t, path)
                else:
                    out.append((path, f))

        walk(self._root, ())
        return out


def stats_parsed_schema(schema_string: Optional[str],
                        configuration: Dict[str, str],
                        partition_columns: List[str]) -> Optional[SType]:
    """The explicit `stats_parsed` type for the table schema (the
    reference's `_stats_parsed_schema`): `numRecords`, `minValues` and
    `maxValues` over the indexed primitive leaves (`stats/collection.py::
    stats_columns` under the table's `configuration`; binary has no min
    or max), `nullCount` int64 per such leaf, `tightBounds`. An array or
    map leaf has no field: its null count is dropped, as Arrow's reader
    drops a field outside the explicit schema. Under column mapping the
    leaves are keyed by their physical paths, as the stats JSON is (the
    reference keys them by logical names, which the physical JSON keys
    do not fill)."""
    from delta_tpu_torch.stats.collection import stats_columns

    if not schema_string:
        return None
    root = json.loads(schema_string)
    stats_paths = stats_columns(_SchemaLeaves(root), configuration,
                                partition_columns)

    mapped = is_mapped(configuration)

    def resolve(path):
        """(the leaf's type, its key path in the stats)."""
        node, keys = root, []
        for name in path:
            if not isinstance(node, dict) or node.get("type") != "struct":
                return None, None
            f = next((f for f in node.get("fields", [])
                      if f.get("name") == name), None)
            if f is None:
                return None, None
            keys.append((f.get("metadata") or {}).get(
                COLUMN_MAPPING_PHYSICAL_NAME_KEY, name) if mapped else name)
            node = f.get("type")
        return node, keys

    minmax: Dict = {}
    nulls: Dict = {}

    def insert(tree, path, kind):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = kind

    for path in stats_paths:
        t, keys = resolve(path)
        if not isinstance(t, str):
            continue
        insert(nulls, keys, "int64")
        if t != "binary":
            insert(minmax, keys, _LEAF_KIND.get(t, t))  # decimal(p,s)

    def to_type(tree) -> SType:
        return SType("struct", {k: to_type(v) if isinstance(v, dict)
                                else SType(v) for k, v in tree.items()})

    fields = {"numRecords": SType("int64")}
    if minmax:
        fields["minValues"] = to_type(minmax)
        fields["maxValues"] = to_type(minmax)
    if nulls:
        fields["nullCount"] = to_type(nulls)
    fields["tightBounds"] = SType("bool")
    return SType("struct", fields)


class _Refused(Exception):
    """Arrow's converter refuses a value for the explicit type."""


_INT_RANGE = {"int64": (-(1 << 63), (1 << 63) - 1),
              "int32": (-(1 << 31), (1 << 31) - 1),
              "int16": (-(1 << 15), (1 << 15) - 1),
              "int8": (-(1 << 7), (1 << 7) - 1)}


def _json_decimal(v, precision: int, scale: int) -> int:
    """A JSON value under decimal(precision, scale), as Arrow's JSON
    converter takes it: a number (or a string) of its digits, at most
    `precision` of them (fractional digits and the whole part's from its
    first non-zero one; an exponent's zeros count), rescaled to `scale`
    without losing a non-zero digit; returns the unscaled integer."""
    if type(v) is str and DECIMAL_TEXT.fullmatch(v):
        v = decimal.Decimal(v)
    if type(v) is int:
        v = decimal.Decimal(v)
    if not isinstance(v, decimal.Decimal) or not v.is_finite():
        raise _Refused("decimal")
    _, digits, exp = v.as_tuple()
    if exp >= 0:
        digits_needed = len(digits) + exp
        unscaled, at = int(v), 0
    else:
        whole = digits[:exp]
        lead = next((i for i, x in enumerate(whole) if x), len(whole))
        digits_needed = -exp + len(whole) - lead
        unscaled, at = int(v.scaleb(-exp)), -exp
    if digits_needed > precision:
        raise _Refused("decimal")
    if at > scale:
        q, r = divmod(abs(unscaled), 10 ** (at - scale))
        if r:
            raise _Refused("decimal")
        return q if unscaled >= 0 else -q
    return unscaled * 10 ** (scale - at)


def _convert(kind: str, v):
    """One JSON value under an explicit leaf kind, as Arrow's JSON
    converter takes it; raise _Refused where Arrow fails the parse."""
    if kind in _INT_RANGE or kind == "date32":
        if type(v) is not int:
            raise _Refused(kind)
        lo, hi = _INT_RANGE.get(kind, _INT_RANGE["int32"])
        if not lo <= v <= hi:
            raise _Refused(kind)
        return v
    if kind in ("float64", "float32"):
        if type(v) not in (int, float, decimal.Decimal):
            raise _Refused(kind)
        return float(v)
    if kind == "bool":
        if type(v) is not bool:
            raise _Refused(kind)
        return v
    if kind == "string":
        if type(v) is not str:
            raise _Refused(kind)
        return v
    if kind.startswith("decimal("):
        return _json_decimal(v, *decimal_precision_scale(kind))
    if kind in ("ts_us_utc", "ts_us"):
        if type(v) is int:
            return v
        if type(v) is not str:
            raise _Refused(kind)
        us = json_to_us(v)
        if us is None:
            raise _Refused(kind)
        return us
    raise _Refused(kind)


_NP_KIND = {"int64": np.int64, "int32": np.int32, "int16": np.int16,
            "int8": np.int8, "ts_us": np.int64, "float64": np.float64,
            "float32": np.float32, "bool": bool, "date32": np.int32,
            "ts_us_utc": np.int64}


def _explicit(rows: list, t: SType, parent_valid: np.ndarray) -> SColumn:
    n = len(rows)
    if t.kind == "struct":
        valid = parent_valid.copy()
        subs: Dict[str, list] = {name: [None] * n for name in t.fields}
        for i, r in enumerate(rows):
            if r is None:
                valid[i] = False
                continue
            if type(r) is not dict:
                raise _Refused("struct")
            for name in t.fields:
                subs[name][i] = r.get(name)
        return SColumn(t, valid, fields={
            name: _explicit(subs[name], ft, valid)
            for name, ft in t.fields.items()})
    valid = np.array([v is not None for v in rows], bool) & parent_valid
    vals = [_convert(t.kind, v) if v is not None else None for v in rows]
    if t.kind == "string":
        data = np.empty(n, object)
        data[:] = [v if v is not None else "" for v in vals]
    elif t.kind.startswith("decimal("):
        data = np.array([v if v is not None else 0 for v in vals],
                        numpy_dtype_of(t.kind))
    else:
        data = np.array([v if v is not None else 0 for v in vals],
                        _NP_KIND[t.kind])
    return SColumn(t, valid, data)


def _from_inferred(col) -> SColumn:
    """`stats/skipping.py`'s inferred column as an SColumn."""
    if isinstance(col, _Struct):
        fields = {k: _from_inferred(v) for k, v in col.fields.items()}
        return SColumn(SType("struct", {k: c.type for k, c in fields.items()}),
                       col.valid, fields=fields)
    kind = {"int": "int64", "float": "float64", "bool": "bool",
            "string": "string", "ts": "ts_s", "null": "null"}.get(col.kind)
    if kind is None:
        raise _Invalid(f"a {col.kind} stats column")
    data = col.data
    if kind == "ts_s":
        data = col.data // 1_000_000
    return SColumn(SType(kind), col.valid.copy(), data)


def parse_stats_structs(stats: Sequence[Optional[str]],
                        explicit: Optional[SType]) -> Optional[SColumn]:
    """The `stats_parsed` column of the adds with these stats strings (a
    null string reads as an empty object), typed by `explicit` when every
    value converts, else by inference; None when nothing parses (the
    reference's `_parse_stats_structs`)."""
    n = len(stats)
    if n == 0 or all(s is None for s in stats):
        return None
    texts = ["{}" if s is None else s for s in stats]
    if any("\n" in s or "\r" in s for s in texts):
        return None  # a pretty-printed row breaks the line-delimited parse
    if explicit is not None:
        try:
            # numbers as Decimals: a decimal leaf takes a number's text
            rows = json.loads("[" + ",".join(texts) + "]",
                              parse_float=decimal.Decimal)
            if len(rows) == n and all(type(r) is dict for r in rows):
                return _explicit(rows, explicit, np.ones(n, bool))
        except (ValueError, RecursionError, _Refused):
            pass
    try:
        table = _parse_table(texts)
        return _from_inferred(table)
    except _Invalid:
        return None

"""Partition values: serialized on write, typed columns on read.

Counterpart of `delta_tpu/stats/partition.py:25-141`. Partition values are
serialized as strings in `add.partitionValues` (PROTOCOL.md, Partition
Value Serialization; null for NULL): `serialize_partition_value` writes
them and `partition_path` names a file's Hive-style directory from them;
the rest of this module turns them back into typed `models.batch.Batch`
columns, for partition pruning (`expressions/eval.py` evaluates a
partition predicate over them) and for the row read, which splices them
into every file's rows (`partition_column`). The types come from the
table schema's JSON (any primitive type, not only the ones this package
writes): a decimal becomes its unscaled integers at the column's scale,
binary the value's UTF-8 bytes (as the reference's Arrow array of the
string gives them), timestamp_ntz a wall time, each with its
`Column.data_type`. Under column mapping the maps are keyed by the
columns' physical names; a map keyed by the logical name is read too, as
the reference reads it (`partition_keys`).
"""

from __future__ import annotations

import datetime as dt
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch.columnmapping import is_mapped
from delta_tpu_torch.models.batch import Batch, Column
from delta_tpu_torch.models.schema import (
    COLUMN_MAPPING_PHYSICAL_NAME_KEY,
    carried_type,
    decimal_precision_scale,
    numpy_dtype_of,
)

_NUMPY = {
    "long": np.int64, "integer": np.int32, "short": np.int16,
    "byte": np.int8, "double": np.float64, "float": np.float32,
    "boolean": bool, "date": "datetime64[D]",
    "timestamp": "datetime64[us]", "timestamp_ntz": "datetime64[us]",
}


def serialize_partition_value(value) -> Optional[str]:
    """A Python or numpy value as its partition-value string (None stays
    None, the null partition): booleans as true/false, timestamps as
    `%Y-%m-%d %H:%M:%S.%f` (UTC), dates as ISO dates, numbers as `str`
    gives them (a float32 as numpy prints it, as the reference's numpy
    values do)."""
    if value is None:
        return None
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, np.datetime64):
        if np.isnat(value):
            return None
        value = value.astype(
            "datetime64[D]" if value.dtype == np.dtype("datetime64[D]")
            else "datetime64[us]").item()
    if isinstance(value, dt.datetime):
        return value.strftime("%Y-%m-%d %H:%M:%S.%f")
    if isinstance(value, dt.date):
        return value.isoformat()
    if isinstance(value, bytes):
        return value.decode("utf-8", errors="replace")
    return str(value)


def partition_path(partition_values: Dict[str, Optional[str]],
                   partition_columns: List[str]) -> str:
    """The Hive-style directory `col1=v1/col2=v2/` of a file with these
    partition values (empty when unpartitioned): each value
    percent-encoded (`quote(v, safe="")`: '%', '/', '=', spaces and
    non-ASCII escaped), the null partition `__HIVE_DEFAULT_PARTITION__`."""
    from urllib.parse import quote

    parts = []
    for c in partition_columns:
        v = partition_values.get(c)
        ev = "__HIVE_DEFAULT_PARTITION__" if v is None else quote(v, safe="")
        parts.append(f"{c}={ev}")
    return "/".join(parts) + ("/" if parts else "")


def deserialize_partition_value(s: Optional[str], type_name: str):
    """A partition-value string as a Python value of the column's type."""
    if s is None:
        return None
    if type_name == "string":
        return s
    if type_name in ("long", "integer", "short", "byte"):
        return int(s)
    if type_name in ("double", "float"):
        return float(s)
    if type_name == "boolean":
        return s.lower() == "true"
    if type_name == "date":
        return dt.date.fromisoformat(s)
    if type_name in ("timestamp", "timestamp_ntz"):
        try:
            return dt.datetime.fromisoformat(s)
        except ValueError:
            return dt.datetime.strptime(s, "%Y-%m-%d %H:%M:%S.%f")
    if type_name.startswith("decimal"):
        import decimal

        return decimal.Decimal(s)
    return s


def _partition_fields(metadata) -> Dict[str, tuple]:
    """Partition column -> (its key in `partitionValues`, its type name
    in the schema, "string" where the schema gives no primitive type)."""
    fields = {}
    if metadata is not None and metadata.schemaString:
        mapped = is_mapped(metadata.configuration)
        for f in json.loads(metadata.schemaString).get("fields", []):
            t = f.get("type")
            key = f.get("name")
            if mapped:
                key = (f.get("metadata") or {}).get(
                    COLUMN_MAPPING_PHYSICAL_NAME_KEY, key)
            fields[f.get("name")] = (key, t if isinstance(t, str)
                                     else "string")
    cols = metadata.partitionColumns if metadata is not None else []
    return {c: fields.get(c, (c, "string")) for c in cols}


def partition_keys(metadata) -> Dict[str, str]:
    """Partition column -> its key in `partitionValues`: the physical
    name under column mapping, else the column's name."""
    return {c: key for c, (key, _) in _partition_fields(metadata).items()}


def partition_value(pv: Dict[str, Optional[str]], column: str, key: str
                    ) -> Optional[str]:
    """A file's partition value of `column`, keyed `key` (or, as the
    reference reads it, by the column's own name)."""
    return pv[key] if key in pv else pv.get(column)


def _unscaled(value, scale: int) -> int:
    """A partition value's Decimal as an integer at `scale` (exact, as
    the reference's Arrow array of it: a value with more fractional
    digits than the scale raises)."""
    out = value.scaleb(scale)
    if out != out.to_integral_value():
        raise ValueError(f"partition value {value} has more than {scale} "
                         "fractional digits")
    return int(out)


def _typed_column(values: List[Optional[str]], type_name: str) -> Column:
    n = len(values)
    valid = np.fromiter((v is not None for v in values), bool, n)
    py = [deserialize_partition_value(v, type_name) for v in values]
    ps = decimal_precision_scale(type_name)
    if ps is not None or type_name == "binary":
        data = np.empty(n, object)
        if ps is not None:
            data[:] = [0 if v is None else _unscaled(v, ps[1]) for v in py]
        else:
            data[:] = [b"" if v is None else v.encode("utf-8") for v in py]
        return Column(data.astype(numpy_dtype_of(type_name)), valid,
                      carried_type(type_name))
    dtype = _NUMPY.get(type_name)
    if dtype is None:
        data = np.empty(n, object)
        data[:] = ["" if v is None else v for v in py]
        return Column(data, valid)
    if type_name in ("date", "timestamp", "timestamp_ntz"):
        data = np.array([np.datetime64(v) if v is not None
                         else np.datetime64(0, "D") for v in py],
                        dtype=dtype)
    else:
        data = np.array([0 if v is None else v for v in py], dtype=dtype)
    return Column(data, valid, carried_type(type_name))


def partition_column(s: Optional[str], type_name: str, n: int) -> Column:
    """`n` rows of one file's partition value `s` as a typed column (the
    row read's splice; `_typed_column` converts the value once)."""
    one = _typed_column([s], type_name)
    return Column(np.repeat(one.values, n),
                  None if s is not None else np.zeros(n, bool),
                  one.data_type)


def partition_values_to_columns(pv_dicts: Sequence[Dict[str, Optional[str]]],
                                metadata) -> Batch:
    """One typed column per partition column over the files'
    partitionValues maps (a missing key reads as NULL)."""
    return Batch({c: _typed_column([partition_value(d, c, key)
                                    for d in pv_dicts], t)
                  for c, (key, t) in _partition_fields(metadata).items()},
                 len(pv_dicts))


def partition_values_to_batch(pv_dicts: Sequence[Dict[str, Optional[str]]],
                              partition_columns: List[str],
                              metadata=None) -> Batch:
    """The conflict checker's small helper: the maps as string columns
    (literals then compare as strings, as in the reference), read by the
    physical keys of a column-mapped table's `metadata`."""
    keys = partition_keys(metadata) if metadata is not None else {}
    cols = {}
    for c in partition_columns:
        vals = [partition_value(d, c, keys.get(c, c)) for d in pv_dicts]
        data = np.empty(len(vals), object)
        data[:] = ["" if v is None else v for v in vals]
        cols[c] = Column(data, np.fromiter((v is not None for v in vals),
                                           bool, len(vals)))
    return Batch(cols, len(pv_dicts))

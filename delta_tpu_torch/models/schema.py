"""Table schema: the subset of `delta_tpu/models/schema.py` the write path
needs.

Delta serializes a table schema as Spark-SQL-style JSON in
`metaData.schemaString`: a `struct` of fields, each `{name, type,
nullable, metadata}`. This port reads and writes flat schemas of the
primitive types below; any other type (nested struct, array, map,
decimal, binary, short, byte, timestamp_ntz, variant) raises
`UnsupportedTableError` where the reference would go on.

Each primitive maps to one numpy dtype in a `models.batch.Batch` and to
one Parquet physical type plus logical annotation in a data file.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np

from delta_tpu_torch.errors import UnsupportedTableError

# Delta type -> (numpy dtype, Parquet physical type, converted type,
# logical type id of the thrift LogicalType union or None)
_TYPES: Dict[str, Tuple[np.dtype, str, Any, Any]] = {
    "long": (np.dtype(np.int64), "INT64", None, None),
    "integer": (np.dtype(np.int32), "INT32", None, None),
    "double": (np.dtype(np.float64), "DOUBLE", None, None),
    "float": (np.dtype(np.float32), "FLOAT", None, None),
    "boolean": (np.dtype(bool), "BOOLEAN", None, None),
    "string": (np.dtype(object), "BYTE_ARRAY", 0, 1),      # UTF8 / STRING
    "date": (np.dtype("datetime64[D]"), "INT32", 6, 6),    # DATE
    "timestamp": (np.dtype("datetime64[us]"), "INT64", 10, 8),  # micros, UTC
}


@dataclass
class StructField:
    name: str
    type_name: str
    nullable: bool = True
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def numpy_dtype(self) -> np.dtype:
        return _TYPES[self.type_name][0]

    @property
    def physical_type(self) -> str:
        return _TYPES[self.type_name][1]

    @property
    def converted_type(self):
        return _TYPES[self.type_name][2]

    @property
    def logical_type(self):
        return _TYPES[self.type_name][3]

    def to_json_value(self) -> Dict[str, Any]:
        return {"name": self.name, "type": self.type_name,
                "nullable": self.nullable, "metadata": self.metadata}


@dataclass
class StructType:
    fields: List[StructField] = field(default_factory=list)

    def to_json_value(self) -> Dict[str, Any]:
        return {"type": "struct",
                "fields": [f.to_json_value() for f in self.fields]}

    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def __getitem__(self, name: str) -> StructField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def leaves(self) -> List[Tuple[Tuple[str, ...], StructField]]:
        """Leaf columns as (name-path, field) pairs, in schema order (the
        unit of stats collection). Flat schemas only: each field is a
        leaf."""
        return [((f.name,), f) for f in self.fields]


def _field_from_json(f: Dict[str, Any]) -> StructField:
    t = f.get("type")
    if not isinstance(t, str) or t not in _TYPES:
        raise UnsupportedTableError(
            f"column {f.get('name')!r} has type {t!r}; this package writes "
            f"flat schemas of {sorted(_TYPES)} only", feature="schema type")
    return StructField(name=f["name"], type_name=t,
                       nullable=bool(f.get("nullable", True)),
                       metadata=dict(f.get("metadata") or {}))


def schema_from_json(s: str) -> StructType:
    v = json.loads(s)
    if not isinstance(v, dict) or v.get("type") != "struct":
        raise ValueError("top-level schema must be a struct")
    return StructType([_field_from_json(f) for f in v.get("fields", [])])


def schema_to_json(st: StructType) -> str:
    return json.dumps(st.to_json_value(), separators=(",", ":"))


def type_name_of(dtype: np.dtype) -> str:
    """The Delta type of a numpy column: int64 long, int32 integer,
    float64 double, float32 float, bool boolean, str/object string,
    datetime64[D] date, datetime64[us] timestamp."""
    dtype = np.dtype(dtype)
    if dtype.kind in ("U", "O"):
        return "string"
    for name, (dt, _, _, _) in _TYPES.items():
        if name != "string" and dt == dtype:
            return name
    raise UnsupportedTableError(f"no Delta type for numpy dtype {dtype}",
                                feature="schema type")

"""Table schema: the counterpart of `delta_tpu/models/schema.py:23-347`.

Delta serializes a table schema as Spark-SQL-style JSON in
`metaData.schemaString`: a `struct` of fields, each `{name, type,
nullable, metadata}`, where a type is a primitive name (`long`,
`decimal(p,s)`, ...) or a nested `struct`, `array` or `map` object.
`schema_from_json` parses every type the protocol names except
`variant`, which raises `UnsupportedTableError`, as any unknown type
does. A field's `data_type` is the primitive's name (a str) or a
`StructType`, `ArrayType` or `MapType`, nested to any depth.

The row read takes every such type (`models/batch.py` says how each
lies in memory). The writer takes the flat primitives of `_TYPES`, each
mapped to one numpy dtype in a `models.batch.Batch` and to one Parquet
physical type plus logical annotation in a data file; `check_writable`
refuses any other schema before a write path writes anything.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from delta_tpu_torch.errors import UnsupportedTableError

_DECIMAL_RE = re.compile(r"^decimal\(\s*(\d+)\s*,\s*(-?\d+)\s*\)$")

# Delta type -> (numpy dtype, Parquet physical type, converted type,
# logical type id of the thrift LogicalType union or None): what the
# writer takes
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

# the read's other primitives -> their numpy dtype
_READ_ONLY = {
    "short": np.dtype(np.int16),
    "byte": np.dtype(np.int8),
    "binary": np.dtype(object),               # bytes
    "timestamp_ntz": np.dtype("datetime64[us]"),  # wall time, no zone
}

# the widest decimal whose unscaled values fit int64 lanes
MAX_INT64_PRECISION = 18


@dataclass
class ArrayType:
    element_type: "DataType"
    contains_null: bool = True

    def to_json_value(self) -> Dict[str, Any]:
        return {"type": "array",
                "elementType": _type_json(self.element_type),
                "containsNull": self.contains_null}


@dataclass
class MapType:
    key_type: "DataType"
    value_type: "DataType"
    value_contains_null: bool = True

    def to_json_value(self) -> Dict[str, Any]:
        return {"type": "map", "keyType": _type_json(self.key_type),
                "valueType": _type_json(self.value_type),
                "valueContainsNull": self.value_contains_null}


def decimal_precision_scale(t) -> Optional[Tuple[int, int]]:
    """(precision, scale) of a `decimal(p,s)` type name; None for any
    other type."""
    m = _DECIMAL_RE.match(t) if isinstance(t, str) else None
    return (int(m.group(1)), int(m.group(2))) if m else None


def numpy_dtype_of(t) -> np.dtype:
    """The numpy dtype of a type's column in a Batch: int64 for a decimal
    of precision 18 or less (its unscaled values), object for a wider
    decimal (Python ints), binary (bytes) and every nested type (dicts,
    lists)."""
    if isinstance(t, str):
        if t in _TYPES:
            return _TYPES[t][0]
        if t in _READ_ONLY:
            return _READ_ONLY[t]
        ps = decimal_precision_scale(t)
        if ps is not None:
            return np.dtype(np.int64 if ps[0] <= MAX_INT64_PRECISION
                            else object)
    return np.dtype(object)


def carried_type(t) -> Optional["DataType"]:
    """A column's `Column.data_type` for Delta type `t`: `t` itself where
    the numpy dtype does not say it (decimal, binary, timestamp_ntz and
    the nested types), else None."""
    if isinstance(t, str) and t not in ("binary", "timestamp_ntz") \
            and decimal_precision_scale(t) is None:
        return None
    return t


@dataclass
class StructField:
    name: str
    data_type: "DataType"
    nullable: bool = True
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def type_name(self) -> str:
        """The primitive's name; `struct`, `array` or `map` for a nested
        type."""
        t = self.data_type
        return t if isinstance(t, str) else _type_json(t)["type"]

    @property
    def numpy_dtype(self) -> np.dtype:
        return numpy_dtype_of(self.data_type)

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
        return {"name": self.name, "type": _type_json(self.data_type),
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

    def leaves(self, prefix: Tuple[str, ...] = ()
               ) -> List[Tuple[Tuple[str, ...], StructField]]:
        """Depth-first leaf columns as (name-path, field) pairs (the unit
        of stats collection and data skipping): nested structs are walked,
        an array or a map is one leaf."""
        out = []
        for f in self.fields:
            if isinstance(f.data_type, StructType):
                out.extend(f.data_type.leaves(prefix + (f.name,)))
            else:
                out.append((prefix + (f.name,), f))
        return out


DataType = Union[str, StructType, ArrayType, MapType]


def _type_json(t: DataType):
    return t if isinstance(t, str) else t.to_json_value()


def _unsupported(what: str, v) -> UnsupportedTableError:
    return UnsupportedTableError(f"{what} has type {v!r}, which this "
                                 "package does not read",
                                 feature="schema type")


def _type_from_json(v, what: str) -> DataType:
    if isinstance(v, str):
        if v in _TYPES or v in _READ_ONLY or decimal_precision_scale(v):
            return v
        raise _unsupported(what, v)  # variant, or a name no protocol has
    if isinstance(v, dict):
        t = v.get("type")
        if t == "struct":
            return StructType([_field_from_json(f) for f in
                               v.get("fields", [])])
        if t == "array":
            return ArrayType(_type_from_json(v.get("elementType"), what),
                             bool(v.get("containsNull", True)))
        if t == "map":
            return MapType(_type_from_json(v.get("keyType"), what),
                           _type_from_json(v.get("valueType"), what),
                           bool(v.get("valueContainsNull", True)))
    raise _unsupported(what, v)


def _field_from_json(f: Dict[str, Any]) -> StructField:
    return StructField(
        name=f["name"],
        data_type=_type_from_json(f.get("type"), f"column {f.get('name')!r}"),
        nullable=bool(f.get("nullable", True)),
        metadata=dict(f.get("metadata") or {}))


def schema_from_json(s: str) -> StructType:
    v = json.loads(s)
    if not isinstance(v, dict) or v.get("type") != "struct":
        raise ValueError("top-level schema must be a struct")
    return StructType([_field_from_json(f) for f in v.get("fields", [])])


def schema_to_json(st: StructType) -> str:
    return json.dumps(st.to_json_value(), separators=(",", ":"))


def check_writable(schema: StructType) -> None:
    """Refuse a schema the writer cannot write: a column of a type
    outside `_TYPES` (nested, decimal, byte, short, binary,
    timestamp_ntz)."""
    for f in schema.fields:
        if not isinstance(f.data_type, str) or f.data_type not in _TYPES:
            raise UnsupportedTableError(
                f"column {f.name!r} has type "
                f"{json.dumps(_type_json(f.data_type))}; this package "
                f"writes flat schemas of {sorted(_TYPES)} only",
                feature="schema type")


def type_name_of(values: np.ndarray) -> str:
    """The Delta type of a numpy column: int64 long, int32 integer,
    float64 double, float32 float, bool boolean, str or an object array
    of `str` string, datetime64[D] date, datetime64[us] timestamp. An
    object array holding anything but `str` (bytes, dicts, lists: what
    the read gives for binary and nested columns) is refused."""
    dtype = values.dtype
    if dtype.kind == "U":
        return "string"
    if dtype.kind == "O":
        odd = next((v for v in values if type(v) is not str), None)
        if odd is not None:
            raise UnsupportedTableError(
                f"an object column holding {type(odd).__name__} values "
                "has no type this package writes", feature="schema type")
        return "string"
    for name, (dt, _, _, _) in _TYPES.items():
        if name != "string" and dt == dtype:
            return name
    raise UnsupportedTableError(f"no Delta type for numpy dtype {dtype}",
                                feature="schema type")

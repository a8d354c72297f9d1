"""Table schema: the counterpart of `delta_tpu/models/schema.py:23-347`.

Delta serializes a table schema as Spark-SQL-style JSON in
`metaData.schemaString`: a `struct` of fields, each `{name, type,
nullable, metadata}`, where a type is a primitive name (`long`,
`decimal(p,s)`, ...) or a nested `struct`, `array` or `map` object.
`schema_from_json` parses every type the protocol names except
`variant`, which raises `UnsupportedTableError`, as any unknown type
does. A field's `data_type` is the primitive's name (a str) or a
`StructType`, `ArrayType` or `MapType`, nested to any depth.

The row read and every write path take every such type
(`models/batch.py` says how each lies in memory). A primitive maps to
one numpy dtype in a `models.batch.Batch` (`numpy_dtype_of`) and to one
Parquet leaf in a data file (`parquet_leaf`), as Spark's writer
(parquet-mr, `writeLegacyFormat=false`) writes it; a struct is a group, an
array the three-level LIST and a map the MAP of a repeated `key_value`
group (`utils/parquet_write.py`). `check_writable` refuses, before a write
path writes anything, a schema holding a type outside these (one built
by hand: the parse refuses every other name).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from delta_tpu_torch.errors import UnsupportedTableError

_DECIMAL_RE = re.compile(r"^decimal\(\s*(\d+)\s*,\s*(-?\d+)\s*\)$")

# Delta primitive -> its numpy dtype in a Batch
_NUMPY: Dict[str, np.dtype] = {
    "long": np.dtype(np.int64),
    "integer": np.dtype(np.int32),
    "short": np.dtype(np.int16),
    "byte": np.dtype(np.int8),
    "double": np.dtype(np.float64),
    "float": np.dtype(np.float32),
    "boolean": np.dtype(bool),
    "string": np.dtype(object),                   # str
    "binary": np.dtype(object),                   # bytes
    "date": np.dtype("datetime64[D]"),
    "timestamp": np.dtype("datetime64[us]"),      # UTC instants
    "timestamp_ntz": np.dtype("datetime64[us]"),  # wall time, no zone
}

# Delta primitive -> (Parquet physical type, converted type, logical
# type): converted 0 UTF8, 6 DATE, 10 TIMESTAMP_MICROS, 15 INT_8,
# 16 INT_16; logical ("string",), ("date",), ("int", bits) signed,
# ("timestamp", adjusted to UTC) in microseconds
_PARQUET: Dict[str, Tuple[str, Any, Any]] = {
    "long": ("INT64", None, None),
    "integer": ("INT32", None, None),
    "short": ("INT32", 16, ("int", 16)),
    "byte": ("INT32", 15, ("int", 8)),
    "double": ("DOUBLE", None, None),
    "float": ("FLOAT", None, None),
    "boolean": ("BOOLEAN", None, None),
    "string": ("BYTE_ARRAY", 0, ("string",)),
    "binary": ("BYTE_ARRAY", None, None),
    "date": ("INT32", 6, ("date",)),
    "timestamp": ("INT64", 10, ("timestamp", True)),
    "timestamp_ntz": ("INT64", None, ("timestamp", False)),
}

# the widest decimal whose unscaled values fit int64 lanes
MAX_INT64_PRECISION = 18

# a field's column-mapping keys in its metadata (`columnmapping.py`)
COLUMN_MAPPING_ID_KEY = "delta.columnMapping.id"
COLUMN_MAPPING_PHYSICAL_NAME_KEY = "delta.columnMapping.physicalName"


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
        if t in _NUMPY:
            return _NUMPY[t]
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
    def column_mapping_id(self) -> Optional[int]:
        v = self.metadata.get(COLUMN_MAPPING_ID_KEY)
        return int(v) if v is not None else None

    @property
    def physical_name(self) -> str:
        """The name the field has in data files and stats under column
        mapping (its own name where the metadata gives none)."""
        return self.metadata.get(COLUMN_MAPPING_PHYSICAL_NAME_KEY, self.name)

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
        if v in _NUMPY or decimal_precision_scale(v):
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


def decimal_bytes(precision: int) -> int:
    """The fewest bytes whose two's complement holds every unscaled value
    of `precision` digits (Spark's `minBytesForPrecision`)."""
    n = 1
    while (1 << (8 * n - 1)) < 10 ** precision:
        n += 1
    return n


def parquet_leaf(t: str) -> Tuple[str, Any, Any, Optional[int]]:
    """(physical type, converted type, logical type, FIXED_LEN_BYTE_ARRAY
    length or None) of primitive `t` in a data file. A decimal(p,s) lies
    in INT32 for p <= 9, INT64 for p <= 18, else the fewest bytes of
    FIXED_LEN_BYTE_ARRAY, big-endian; converted DECIMAL (5), logical
    ("decimal", p, s)."""
    ps = decimal_precision_scale(t)
    if ps is None:
        return _PARQUET[t] + (None,)
    logical = ("decimal",) + ps
    if ps[0] <= 9:
        return "INT32", 5, logical, None
    if ps[0] <= MAX_INT64_PRECISION:
        return "INT64", 5, logical, None
    return "FIXED_LEN_BYTE_ARRAY", 5, logical, decimal_bytes(ps[0])


def _primitive(t) -> bool:
    if t in _NUMPY:
        return True
    ps = decimal_precision_scale(t)
    return ps is not None and 0 < ps[0] <= 38 and 0 <= ps[1] <= ps[0]


def _writable(t) -> bool:
    if isinstance(t, StructType):
        return all(_writable(f.data_type) for f in t.fields)
    if isinstance(t, ArrayType):
        return _writable(t.element_type)
    if isinstance(t, MapType):
        return _writable(t.key_type) and _writable(t.value_type)
    return isinstance(t, str) and _primitive(t)


def check_writable(schema: StructType) -> None:
    """Refuse a schema the writer cannot write: one holding, at any
    depth, a type outside the primitives of `_NUMPY`, decimal(p,s) with
    0 < p <= 38 and 0 <= s <= p, and the struct, array and map types."""
    for f in schema.fields:
        if not _writable(f.data_type):
            raise UnsupportedTableError(
                f"column {f.name!r} has type "
                f"{json.dumps(_type_json(f.data_type), default=repr)}, "
                "which this package does not write", feature="schema type")


def type_name_of(values: np.ndarray) -> str:
    """The Delta type of a numpy column: int64 long, int32 integer, int16
    short, int8 byte, float64 double, float32 float, bool boolean, str or
    an object array of `str` string, an object array of `bytes` binary,
    datetime64[D] date, datetime64[us] timestamp. An object array holding
    anything else (a dict or a list, whose type only a column's
    `data_type` says), or a mix, is refused."""
    dtype = values.dtype
    if dtype.kind == "U":
        return "string"
    if dtype.kind == "O":
        kinds = {type(v) for v in values}
        if kinds <= {str}:
            return "string"
        if kinds == {bytes}:
            return "binary"
        what = next(iter(kinds)).__name__ if len(kinds) == 1 else "mixed"
        raise UnsupportedTableError(
            f"an object column holding {what} values has no type without "
            "a data_type", feature="schema type")
    for name in ("long", "integer", "short", "byte", "double", "float",
                 "boolean", "date", "timestamp"):
        if _NUMPY[name] == dtype:
            return name
    raise UnsupportedTableError(f"no Delta type for numpy dtype {dtype}",
                                feature="schema type")

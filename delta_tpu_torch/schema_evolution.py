"""Schema evolution: merging an incoming schema into a table's on write.

Counterpart of `delta_tpu/schema_evolution.py` (Delta's
`SchemaMergingUtils.scala` and `TypeWidening.scala`), on this package's
types (`models/schema.py`: a primitive's name, `StructType`, `ArrayType`,
`MapType`):

- `merge_schemas(current, incoming)`: the incoming schema may add
  columns, nested ones inside their struct too; each is appended, in the
  incoming order, as nullable. A field present in both merges its types
  (`merge_types`); names match case-insensitively and keep the table's
  spelling.
- `merge_types`: equal types stay; structs merge field by field, an
  array's element and a map's key and value type by type; a narrower
  incoming type fits the table's as it is; a wider one replaces it only
  with `allow_widening` (a table with `delta.enableTypeWidening`) along
  the safe chains of `can_widen`: byte -> short -> integer -> long,
  float -> double, byte, short or integer -> double, date ->
  timestamp_ntz, and decimal(p,s) -> decimal(p',s') with s' >= s and
  p' - s' >= p - s. Anything else raises `SchemaMismatchError`
  (DELTA_FAILED_TO_MERGE_FIELDS).
"""

from __future__ import annotations

from typing import Optional

from delta_tpu_torch.errors import SchemaMismatchError
from delta_tpu_torch.models.schema import (
    ArrayType,
    DataType,
    MapType,
    StructField,
    StructType,
    decimal_precision_scale,
)

_WIDEN = {
    ("byte", "short"), ("byte", "integer"), ("byte", "long"),
    ("short", "integer"), ("short", "long"),
    ("integer", "long"),
    ("float", "double"),
    ("byte", "double"), ("short", "double"), ("integer", "double"),
    ("date", "timestamp_ntz"),
}


def can_widen(from_t: DataType, to_t: DataType) -> bool:
    """Whether a column of primitive type `from_t` widens safely into
    `to_t` (a different type)."""
    if not isinstance(from_t, str) or not isinstance(to_t, str):
        return False
    a, b = decimal_precision_scale(from_t), decimal_precision_scale(to_t)
    if a is not None or b is not None:
        if a is None or b is None:
            return False
        (p1, s1), (p2, s2) = a, b
        return s2 >= s1 and p2 - s2 >= p1 - s1 and a != b
    return (from_t, to_t) in _WIDEN


def _json(t: DataType):
    return t if isinstance(t, str) else t.to_json_value()


def merge_types(current: DataType, incoming: DataType, allow_widening: bool,
                path: str) -> DataType:
    """The type a column of type `current` takes to hold `incoming`
    values (`path` names it in the error)."""
    if current == incoming:
        return current
    if isinstance(current, StructType) and isinstance(incoming, StructType):
        return merge_schemas(current, incoming, allow_widening,
                             prefix=path + ".")
    if isinstance(current, ArrayType) and isinstance(incoming, ArrayType):
        return ArrayType(
            merge_types(current.element_type, incoming.element_type,
                        allow_widening, path + ".element"),
            current.contains_null or incoming.contains_null)
    if isinstance(current, MapType) and isinstance(incoming, MapType):
        return MapType(
            merge_types(current.key_type, incoming.key_type, allow_widening,
                        path + ".key"),
            merge_types(current.value_type, incoming.value_type,
                        allow_widening, path + ".value"),
            current.value_contains_null or incoming.value_contains_null)
    if allow_widening and can_widen(current, incoming):
        return incoming
    if can_widen(incoming, current):
        return current  # the narrower incoming values fit as they are
    raise SchemaMismatchError(
        f"cannot merge types at {path or '<root>'}: {_json(current)} vs "
        f"{_json(incoming)}", error_class="DELTA_FAILED_TO_MERGE_FIELDS")


def merge_schemas(current: StructType, incoming: StructType,
                  allow_widening: bool = False,
                  prefix: str = "") -> StructType:
    """The table schema that accepts `incoming` rows: `current`'s fields
    in order (their types merged), then `incoming`'s new fields as
    nullable."""
    by_name = {f.name.lower(): f for f in incoming.fields}
    out = []
    for f in current.fields:
        inc: Optional[StructField] = by_name.pop(f.name.lower(), None)
        if inc is None:
            out.append(f)
            continue
        out.append(StructField(
            f.name, merge_types(f.data_type, inc.data_type, allow_widening,
                                prefix + f.name),
            f.nullable, dict(f.metadata)))
    for f in incoming.fields:
        if f.name.lower() in by_name:  # a new field
            out.append(StructField(f.name, f.data_type, True,
                                   dict(f.metadata)))
    return StructType(out)


def is_read_compatible(table_schema: StructType,
                       read_schema: StructType) -> bool:
    """Whether rows written with `table_schema` read as `read_schema` (a
    column the write lacks reads as null)."""
    try:
        merge_schemas(read_schema, table_schema)
        return True
    except SchemaMismatchError:
        return False

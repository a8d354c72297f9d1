"""Column mapping: the logical -> physical column indirection.

Counterpart of `delta_tpu/columnmapping.py` (Delta's
`DeltaColumnMapping.scala`): modes `none`, `name` and `id`. Under `name`
or `id` every field, nested ones included, carries `delta.columnMapping.id`
(a stable int) and `delta.columnMapping.physicalName` in its metadata;
data files, stats JSON keys and `partitionValues` keys use the physical
names, so renaming or dropping a logical column changes only the
metadata. Both modes resolve columns by physical name here, as the
reference does.

New fields get a `col-<uuid>` physical name (`assign_column_mapping`).
When an existing table turns mapping on (`keep_names=True`), its fields
keep their current names as physical names, as Delta does: the files
already written hold those names, so none needs rewriting. (The reference
gives them fresh `col-<uuid>` names instead, and its reads of the table's
old files then lose every renamed column.)

`logical_converter` turns a nested value read from a data file (dicts
keyed by the file's field names) into the logical form of the table's
type: each struct field by its physical name, or by its logical name in a
struct of the file that holds none of the physical names (the reference's
writer names nested fields logically); a field the file lacks reads as
null, a field the table dropped disappears.
"""

from __future__ import annotations

import uuid
from typing import Callable, Dict, Optional

from delta_tpu_torch.errors import (
    ColumnMappingModeChangeError,
    DuplicateColumnError,
    NonExistentColumnError,
    SchemaEvolutionError,
)
from delta_tpu_torch.models.schema import (
    COLUMN_MAPPING_ID_KEY,
    COLUMN_MAPPING_PHYSICAL_NAME_KEY,
    ArrayType,
    DataType,
    MapType,
    StructField,
    StructType,
)

MODE_KEY = "delta.columnMapping.mode"
MAX_ID_KEY = "delta.columnMapping.maxColumnId"


def mapping_mode(configuration: Dict[str, str]) -> str:
    return configuration.get(MODE_KEY, "none")


def is_mapped(configuration: Dict[str, str]) -> bool:
    return mapping_mode(configuration) != "none"


def _assign_in_type(dt: DataType, next_id, keep_names: bool) -> DataType:
    if isinstance(dt, StructType):
        return StructType([_assign_field(f, next_id, keep_names)
                           for f in dt.fields])
    if isinstance(dt, ArrayType):
        return ArrayType(_assign_in_type(dt.element_type, next_id,
                                         keep_names), dt.contains_null)
    if isinstance(dt, MapType):
        return MapType(_assign_in_type(dt.key_type, next_id, keep_names),
                       _assign_in_type(dt.value_type, next_id, keep_names),
                       dt.value_contains_null)
    return dt


def _assign_field(f: StructField, next_id, keep_names: bool) -> StructField:
    md = dict(f.metadata)
    if COLUMN_MAPPING_ID_KEY not in md:
        md[COLUMN_MAPPING_ID_KEY] = next_id()
    if COLUMN_MAPPING_PHYSICAL_NAME_KEY not in md:
        md[COLUMN_MAPPING_PHYSICAL_NAME_KEY] = (
            f.name if keep_names else f"col-{uuid.uuid4()}")
    return StructField(f.name, _assign_in_type(f.data_type, next_id,
                                               keep_names),
                       f.nullable, md)


def assign_column_mapping(schema: StructType, configuration: Dict[str, str],
                          keep_names: bool = False) -> tuple:
    """Give every field that lacks them an id (past
    `delta.columnMapping.maxColumnId`) and a physical name: `col-<uuid>`,
    or with `keep_names` its current name (a mode change on an existing
    table). Returns (the new schema, the configuration with the bumped
    maxColumnId)."""
    max_id = int(configuration.get(MAX_ID_KEY, "0"))

    def next_id():
        nonlocal max_id
        max_id += 1
        return max_id

    new_schema = StructType([_assign_field(f, next_id, keep_names)
                             for f in schema.fields])
    new_conf = dict(configuration)
    new_conf[MAX_ID_KEY] = str(max_id)
    return new_schema, new_conf


def strip_column_mapping(dt: DataType) -> DataType:
    """A type with the ids and physical names taken out of every field's
    metadata, at every depth (a schema to map afresh)."""
    if isinstance(dt, StructType):
        return StructType([StructField(
            f.name, strip_column_mapping(f.data_type), f.nullable,
            {k: v for k, v in f.metadata.items()
             if k not in (COLUMN_MAPPING_ID_KEY,
                          COLUMN_MAPPING_PHYSICAL_NAME_KEY)})
            for f in dt.fields])
    if isinstance(dt, ArrayType):
        return ArrayType(strip_column_mapping(dt.element_type),
                         dt.contains_null)
    if isinstance(dt, MapType):
        return MapType(strip_column_mapping(dt.key_type),
                       strip_column_mapping(dt.value_type),
                       dt.value_contains_null)
    return dt


def _physical_type(dt: DataType) -> DataType:
    if isinstance(dt, StructType):
        return StructType([StructField(f.physical_name,
                                       _physical_type(f.data_type),
                                       f.nullable, dict(f.metadata))
                           for f in dt.fields])
    if isinstance(dt, ArrayType):
        return ArrayType(_physical_type(dt.element_type), dt.contains_null)
    if isinstance(dt, MapType):
        return MapType(_physical_type(dt.key_type),
                       _physical_type(dt.value_type), dt.value_contains_null)
    return dt


def physical_schema(schema: StructType) -> StructType:
    """The schema with every field, at every depth, under its physical
    name (metadata kept)."""
    return _physical_type(schema)  # type: ignore[return-value]


def logical_to_physical_names(schema: StructType) -> Dict[str, str]:
    return {f.name: f.physical_name for f in schema.fields}


def physical_to_logical_names(schema: StructType) -> Dict[str, str]:
    return {f.physical_name: f.name for f in schema.fields}


def physical_name_path(schema: StructType, name_path: tuple
                       ) -> Optional[tuple]:
    """A logical column path as its physical path (None when a segment
    names no field)."""
    out = []
    cur: Optional[DataType] = schema
    for part in name_path:
        if not isinstance(cur, StructType) or part not in cur:
            return None
        f = cur[part]
        out.append(f.physical_name)
        cur = f.data_type
    return tuple(out)


def validate_mode_change(old_mode: str, new_mode: str) -> None:
    """Legal changes: none -> name, none -> id, and no change; a mapped
    table cannot drop or switch its mode."""
    if old_mode == new_mode:
        return
    if old_mode == "none" and new_mode in ("name", "id"):
        return
    raise ColumnMappingModeChangeError(
        f"unsupported column mapping mode change {old_mode} -> {new_mode}")


def rename_column(schema: StructType, old: str, new: str) -> StructType:
    """A top-level field renamed, its metadata (physical name) kept."""
    if new in schema:
        raise DuplicateColumnError(f"column {new} already exists")
    if old not in schema:
        raise NonExistentColumnError(f"column {old} not found")
    return StructType([StructField(new, f.data_type, f.nullable,
                                   dict(f.metadata)) if f.name == old else f
                       for f in schema.fields])


def drop_column(schema: StructType, name: str) -> StructType:
    if name not in schema:
        raise NonExistentColumnError(f"column {name} not found")
    if len(schema.fields) == 1:
        raise SchemaEvolutionError(
            "cannot drop the last column",
            error_class="DELTA_DROP_COLUMN_ON_SINGLE_FIELD_SCHEMA")
    return StructType([f for f in schema.fields if f.name != name])


def _identity(v):
    return v


def logical_converter(target: DataType, have: DataType
                      ) -> Optional[Callable]:
    """A function from a nested value of the file's type `have` to the
    logical form of the table's type `target` (module docstring); None
    where the value needs no change."""
    if isinstance(target, StructType) and isinstance(have, StructType):
        names = set(have.field_names())
        # a field without a physical name of its own (the reference's
        # merge_schema adds such) says nothing of how the file names
        physical = any(f.physical_name in names for f in target.fields
                       if f.physical_name != f.name)
        parts = []
        for f in target.fields:
            src = f.physical_name if physical else f.name
            conv = (logical_converter(f.data_type, have[src].data_type)
                    if src in names else _identity)
            parts.append((f.name, src if src in names else None,
                          conv or _identity))
        if [(n, s) for n, s, _ in parts] == [(n, n) for n in
                                             have.field_names()] \
                and all(c is _identity for _, _, c in parts):
            return None

        def struct(v):
            if v is None:
                return None
            return {n: (None if s is None else c(v.get(s)))
                    for n, s, c in parts}
        return struct
    if isinstance(target, ArrayType) and isinstance(have, ArrayType):
        conv = logical_converter(target.element_type, have.element_type)
        if conv is None:
            return None
        return lambda v: None if v is None else [conv(e) for e in v]
    if isinstance(target, MapType) and isinstance(have, MapType):
        kc = logical_converter(target.key_type, have.key_type) or _identity
        vc = logical_converter(target.value_type, have.value_type) \
            or _identity
        if kc is _identity and vc is _identity:
            return None

        def mapping(v):
            if v is None:
                return None
            items = v.items() if isinstance(v, dict) else v
            out = [(kc(k), vc(x)) for k, x in items]
            return dict(out) if isinstance(v, dict) else out
        return mapping
    return None

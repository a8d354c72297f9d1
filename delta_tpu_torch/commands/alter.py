"""ALTER TABLE: columns, properties, protocol, column mapping.

Counterpart of `delta_tpu/commands/alter.py` (Delta's
`alterDeltaTableCommands.scala`): each operation is one metadata or
protocol commit, with no add and no remove, under the reference's
operation names and parameters:

    add_columns(table, [StructField("c", "double"),
                        StructField("s.x", "long")])   # ADD COLUMNS
    rename_column(table, "a", "b")                     # RENAME COLUMN
    drop_column(table, "s.x")                          # DROP COLUMNS
    set_properties(table, {"delta.columnMapping.mode": "name"})
    unset_properties(table, ["delta.appendOnly"])      # SET TBLPROPERTIES
    upgrade_protocol(table, feature="deletionVectors")  # UPGRADE PROTOCOL
    set_properties(table, {"delta.enableTypeWidening": "true"})
    change_column_type(table, "qty", "long")           # CHANGE COLUMN TYPE

RENAME and DROP COLUMN need column mapping (they change only the
metadata); a column that a CHECK constraint or a generated column
depends on is neither renamed nor dropped. Turning column mapping on
(`set_properties`) keeps every existing field's name as its physical
name, so the files written before read on (`columnmapping.py`); it
upgrades the protocol to carry `columnMapping`, as a property that turns
deletion vectors on upgrades it to (3, 7) and `delta.enableChangeDataFeed`
a legacy protocol to writer 4 (or lists `changeDataFeed` at writer 7).
Unsetting the mode, or a mode
change other than none -> name or none -> id, raises
`ColumnMappingModeChangeError` (the reference unsets it, after which its
reads look for the physical names' columns by their logical names).

CHANGE COLUMN TYPE widens a top-level column's type along
`schema_evolution.py::can_widen` on a table with
`delta.enableTypeWidening`, upgrading the protocol to `typeWidening`
(CHECK constraints are added and dropped by `constraints.py`). A property
that would turn on a feature the write path does not write
(`features.py::refused_properties`: row tracking, in-commit timestamps,
...) raises `UnsupportedTableError`, and the commit refuses a protocol
upgrade to one. Unknown `delta.*` keys are
not refused, as the reference refuses them, since this package parses
only some of the reference's properties.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from delta_tpu_torch.colgen import _ref_overlaps, generated_dependents
from delta_tpu_torch.columnmapping import (
    MODE_KEY,
    assign_column_mapping,
    drop_column as _drop_from_schema,
    mapping_mode,
    rename_column as _rename_in_schema,
    validate_mode_change,
)
from delta_tpu_torch.config import TABLE_CONFIGS, _parse_bool
from delta_tpu_torch.constraints import CONSTRAINT_PREFIX
from delta_tpu_torch.errors import (
    DeltaError,
    InvalidArgumentError,
    InvalidProtocolVersionError,
    InvalidTablePropertyError,
    MissingTransactionLogError,
    NonExistentColumnError,
    SchemaEvolutionError,
    SchemaMismatchError,
    UnsupportedTableError,
)
from delta_tpu_torch.expressions.parser import ParseError, parse_expression
from delta_tpu_torch.features import (
    FEATURES,
    refused_properties,
    upgraded_protocol,
)
from delta_tpu_torch.schema_evolution import can_widen
from delta_tpu_torch.models.schema import (
    DataType,
    StructField,
    StructType,
    schema_from_json,
    schema_to_json,
)
from delta_tpu_torch.txn.transaction import Operation

TYPE_WIDENING_KEY = "delta.enableTypeWidening"


def _check_dependent_columns(schema: StructType, configuration, column: str,
                             what: str) -> None:
    """A column referenced by a generated column's expression or a CHECK
    constraint is neither dropped nor renamed
    (`DeltaErrors.generatedColumnsDependentColumnChange`,
    `.constraintDependentColumnChange`)."""
    deps = generated_dependents(schema, column)
    if deps:
        raise SchemaEvolutionError(
            f"cannot {what} column {column}: generated column(s) {deps} "
            "depend on it",
            error_class="DELTA_GENERATED_COLUMNS_DEPENDENT_COLUMN_CHANGE")
    for key, expr in (configuration or {}).items():
        if not key.startswith(CONSTRAINT_PREFIX):
            continue
        try:
            refs = {".".join(r) for r in parse_expression(expr).references()}
        except ParseError:
            continue
        if any(_ref_overlaps(r, column) for r in refs):
            raise SchemaEvolutionError(
                f"cannot {what} column {column}: CHECK constraint "
                f"{key[len(CONSTRAINT_PREFIX):]!r} depends on it",
                error_class="DELTA_CONSTRAINT_DEPENDENT_COLUMN_CHANGE")


def _metadata_txn(table, operation: str):
    txn = table.create_transaction_builder(operation).build()
    if txn.read_snapshot is None:
        raise MissingTransactionLogError(f"no table at {table.path}")
    return txn


def _upgrade_for(txn, metadata) -> None:
    """Upgrade the transaction's protocol for every feature `metadata`
    turns on."""
    proto = txn.protocol()
    for feat in FEATURES.values():
        if feat.activated_by is not None and feat.activated_by(metadata):
            upgraded = upgraded_protocol(proto, feat)
            if upgraded != proto:
                proto = upgraded
                txn.update_protocol(proto)


def _commit_schema(txn, new_schema: StructType, operation_params: Dict,
                   new_conf: Optional[Dict[str, str]] = None) -> int:
    meta = txn.metadata()
    replacement = dataclasses.replace(
        meta, schemaString=schema_to_json(new_schema),
        configuration=dict(new_conf if new_conf is not None
                           else meta.configuration))
    txn.update_metadata(replacement)
    _upgrade_for(txn, replacement)
    txn.set_operation_parameters(operation_params)
    return txn.commit().version


def _add_nested_field(schema: StructType, parent: list,
                      leaf: StructField) -> StructType:
    """`schema` with `leaf` appended inside the struct at the `parent`
    path: DELTA_ADD_COLUMN_STRUCT_NOT_FOUND for a missing parent,
    DELTA_ADD_COLUMN_PARENT_NOT_STRUCT for one that is not a struct."""
    head = parent[0]
    if head not in schema:
        raise SchemaEvolutionError(
            f"Struct not found at position {head}",
            error_class="DELTA_ADD_COLUMN_STRUCT_NOT_FOUND")
    out = []
    for f in schema.fields:
        if f.name != head:
            out.append(f)
            continue
        if not isinstance(f.data_type, StructType):
            raise SchemaEvolutionError(
                f"cannot add {leaf.name} because its parent {head} is not a "
                f"StructType ({f.type_name})",
                error_class="DELTA_ADD_COLUMN_PARENT_NOT_STRUCT")
        if len(parent) == 1 and leaf.name in f.data_type:
            raise SchemaMismatchError(
                f"column {head}.{leaf.name} already exists")
        inner = (_add_nested_field(f.data_type, parent[1:], leaf)
                 if len(parent) > 1
                 else StructType(list(f.data_type.fields) + [leaf]))
        out.append(StructField(f.name, inner, f.nullable, dict(f.metadata)))
    return StructType(out)


def add_columns(table, columns: Sequence[StructField]) -> int:
    """ADD COLUMNS, nullable only, appended at the end; a dotted name
    (`a.b.c`) adds a field inside the struct at `a.b`. Under column
    mapping the new fields get ids and `col-<uuid>` physical names."""
    txn = _metadata_txn(table, Operation.ADD_COLUMNS)
    meta = txn.metadata()
    schema = schema_from_json(meta.schemaString)
    conf = dict(meta.configuration)
    for f in columns:
        if not f.nullable:
            raise SchemaEvolutionError(
                "added columns must be nullable",
                error_class="DELTA_ADD_COLUMN_NOT_NULLABLE")
        if "." in f.name:
            parts = f.name.split(".")
            leaf = StructField(parts[-1], f.data_type, f.nullable,
                               dict(f.metadata))
            schema = _add_nested_field(schema, parts[:-1], leaf)
            continue
        if f.name in schema:
            raise SchemaMismatchError(f"column {f.name} already exists")
        schema = StructType(schema.fields + [f])
    if mapping_mode(conf) != "none":
        schema, conf = assign_column_mapping(schema, conf)
    return _commit_schema(txn, schema, {"columns": [f.name for f in columns]},
                          conf)


def rename_column(table, old: str, new: str) -> int:
    """RENAME COLUMN of a top-level column (a partition column too: the
    table's partition columns are renamed with it); metadata only, so
    column mapping is required."""
    txn = _metadata_txn(table, Operation.RENAME_COLUMN)
    meta = txn.metadata()
    if mapping_mode(meta.configuration) == "none":
        raise SchemaEvolutionError(
            "RENAME COLUMN requires column mapping "
            "(set delta.columnMapping.mode = 'name')",
            error_class="DELTA_UNSUPPORTED_RENAME_COLUMN")
    schema = schema_from_json(meta.schemaString)
    _check_dependent_columns(schema, meta.configuration, old, "rename")
    new_schema = _rename_in_schema(schema, old, new)
    replacement = dataclasses.replace(
        meta, schemaString=schema_to_json(new_schema),
        partitionColumns=[new if c == old else c
                          for c in meta.partitionColumns])
    txn.update_metadata(replacement)
    txn.set_operation_parameters({"oldName": old, "newName": new})
    return txn.commit().version


def _drop_nested_field(schema: StructType, parts: list) -> StructType:
    """`schema` without the nested field at the `parts` path; an
    intermediate that is not a struct is the reference's
    `dropNestedColumnsFromNonStructTypeException`."""
    head = parts[0]
    if head not in schema:
        raise NonExistentColumnError(f"column {head} not found")
    out = []
    for f in schema.fields:
        if f.name != head:
            out.append(f)
            continue
        if not isinstance(f.data_type, StructType):
            raise SchemaEvolutionError(
                "cannot drop nested column from a non-struct type: "
                f"{f.type_name}",
                error_class=(
                    "DELTA_UNSUPPORTED_DROP_NESTED_COLUMN_FROM_NON_STRUCT_TYPE"))
        inner = (_drop_from_schema(f.data_type, parts[1])
                 if len(parts) == 2
                 else _drop_nested_field(f.data_type, parts[1:]))
        out.append(StructField(f.name, inner, f.nullable, dict(f.metadata)))
    return StructType(out)


def drop_column(table, name: str) -> int:
    """DROP COLUMN, top-level or dotted nested; metadata only, so column
    mapping is required. Not a partition column, nor the last column."""
    txn = _metadata_txn(table, Operation.DROP_COLUMNS)
    meta = txn.metadata()
    if mapping_mode(meta.configuration) == "none":
        raise SchemaEvolutionError(
            "DROP COLUMN requires column mapping "
            "(set delta.columnMapping.mode = 'name')",
            error_class="DELTA_UNSUPPORTED_DROP_COLUMN")
    if name in meta.partitionColumns:
        raise SchemaEvolutionError(
            f"cannot drop partition column {name}",
            error_class="DELTA_UNSUPPORTED_DROP_PARTITION_COLUMN")
    schema = schema_from_json(meta.schemaString)
    _check_dependent_columns(schema, meta.configuration, name, "drop")
    new_schema = (_drop_nested_field(schema, name.split("."))
                  if "." in name else _drop_from_schema(schema, name))
    return _commit_schema(txn, new_schema, {"column": name})


def change_column_type(table, name: str, new_type: DataType) -> int:
    """CHANGE COLUMN TYPE of a top-level column, widening only
    (`schema_evolution.py::can_widen`: DELTA_CANNOT_CHANGE_DATA_TYPE) on
    a table with `delta.enableTypeWidening` (DELTA_TYPE_WIDENING_DISABLED);
    the protocol is upgraded to `typeWidening` in the same commit. The
    files keep their old type: the read casts them (`read/reader.py`)."""
    txn = _metadata_txn(table, Operation.CHANGE_COLUMN)
    meta = txn.metadata()
    schema = schema_from_json(meta.schemaString)
    if name not in schema:
        raise SchemaMismatchError(
            f"column {name} not found",
            error_class="DELTA_COLUMN_NOT_FOUND_IN_SCHEMA")
    old = schema[name].type_name
    if not can_widen(schema[name].data_type, new_type):
        raise SchemaEvolutionError(
            f"unsupported type change {old} -> {new_type} (only widening "
            "changes allowed)", error_class="DELTA_CANNOT_CHANGE_DATA_TYPE")
    if not _parse_bool(meta.configuration.get(TYPE_WIDENING_KEY, "")):
        raise SchemaEvolutionError(
            f"set {TYPE_WIDENING_KEY} = true first",
            error_class="DELTA_TYPE_WIDENING_DISABLED")
    widened = StructType([
        StructField(f.name, new_type, f.nullable, dict(f.metadata))
        if f.name == name else f for f in schema.fields])
    proto = upgraded_protocol(txn.protocol(), FEATURES["typeWidening"])
    if proto != txn.protocol():
        txn.update_protocol(proto)
    return _commit_schema(txn, widened, {"column": name, "newType": new_type})


def _validate_properties(properties: Dict[str, str]) -> None:
    """The values of the properties this package parses must parse (a
    boolean as true or false), as the reference's
    `validate_table_properties` demands of them."""
    for k, v in properties.items():
        cfg = TABLE_CONFIGS.get(k)
        if cfg is None:
            continue
        if cfg.parse is _parse_bool and \
                str(v).strip().lower() not in ("true", "false"):
            if k == "delta.autoOptimize.autoCompact":
                raise InvalidTablePropertyError(
                    f"Invalid auto-compact type: {v}. Allowed values are: "
                    "(true, false)",
                    error_class="DELTA_INVALID_AUTO_COMPACT_TYPE")
            raise InvalidTablePropertyError(
                "The validation of the properties of the table has been "
                f"violated: {k}={v!r} is not a boolean",
                error_class="DELTA_VIOLATE_TABLE_PROPERTY_VALIDATION_FAILED")
        try:
            cfg.parse(str(v))
        except DeltaError:
            raise
        except Exception as e:
            raise InvalidTablePropertyError(
                "The validation of the properties of the table has been "
                f"violated: {k}={v!r} ({e})",
                error_class="DELTA_VIOLATE_TABLE_PROPERTY_VALIDATION_FAILED")


def set_properties(table, properties: Dict[str, str]) -> int:
    """SET TBLPROPERTIES; a column-mapping mode change assigns ids and
    physical names (existing fields keep their names) and upgrades the
    protocol, as does any property that turns on a feature."""
    txn = _metadata_txn(table, Operation.SET_TBLPROPERTIES)
    meta = txn.metadata()
    refused = refused_properties(properties)
    if refused:
        raise UnsupportedTableError(
            f"table properties {refused} need table features this package "
            "does not write yet", feature="table properties")
    _validate_properties(properties)
    conf = dict(meta.configuration)
    old_mode = mapping_mode(conf)
    conf.update(properties)
    new_mode = mapping_mode(conf)
    schema = schema_from_json(meta.schemaString)
    if old_mode != new_mode:
        validate_mode_change(old_mode, new_mode)
        schema, conf = assign_column_mapping(schema, conf, keep_names=True)
    return _commit_schema(txn, schema, {"properties": dict(properties)},
                          conf)


def unset_properties(table, keys: Sequence[str],
                     if_exists: bool = False) -> int:
    """UNSET TBLPROPERTIES (a missing key raises unless `if_exists`)."""
    txn = _metadata_txn(table, Operation.SET_TBLPROPERTIES)
    meta = txn.metadata()
    missing = [k for k in keys if k not in meta.configuration]
    if missing and not if_exists:
        raise InvalidArgumentError(
            f"cannot unset non-existent "
            f"propert{'ies' if len(missing) > 1 else 'y'} {missing}; use "
            "UNSET TBLPROPERTIES IF EXISTS",
            error_class="DELTA_UNSET_NON_EXISTENT_PROPERTY")
    if MODE_KEY in keys:
        validate_mode_change(mapping_mode(meta.configuration), "none")
    conf = {k: v for k, v in meta.configuration.items() if k not in set(keys)}
    txn.update_metadata(dataclasses.replace(meta, configuration=conf))
    txn.set_operation_parameters({"unset": list(keys)})
    return txn.commit().version


def upgrade_protocol(table, min_reader: Optional[int] = None,
                     min_writer: Optional[int] = None,
                     feature: Optional[str] = None) -> int:
    """UPGRADE PROTOCOL to carry `feature`, or to at least the given
    versions; no change commits nothing (the read version returns)."""
    txn = _metadata_txn(table, Operation.UPGRADE_PROTOCOL)
    proto = txn.protocol()
    if feature is not None:
        if feature not in FEATURES:
            raise InvalidArgumentError(
                f"unknown table feature {feature}",
                error_class="DELTA_UNSUPPORTED_FEATURES_IN_CONFIG")
        new_proto = upgraded_protocol(proto, FEATURES[feature])
    else:
        new_proto = dataclasses.replace(
            proto,
            minReaderVersion=max(proto.minReaderVersion, min_reader or 0),
            minWriterVersion=max(proto.minWriterVersion, min_writer or 0))
    if new_proto == proto:
        return txn.read_version
    if (new_proto.minReaderVersion < proto.minReaderVersion
            or new_proto.minWriterVersion < proto.minWriterVersion):
        raise InvalidProtocolVersionError(
            "protocol downgrade is not allowed",
            error_class="DELTA_INVALID_PROTOCOL_DOWNGRADE")
    txn.update_protocol(new_proto)
    txn.set_operation_parameters({"newProtocol": new_proto.to_dict()})
    return txn.commit().version

"""Writing rows to a table and reading them back: the counterparts of
`delta_tpu/api.py::write_table` and `read_table`.

    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.expressions import col, lit
    write_table(path, {"k": np.arange(10), "s": np.array(["a"] * 10)})
    write_table(path, {"k": (values, valid)}, mode="append")
    write_table(path, cols, partition_by=["month"], target_rows_per_file=n)
    write_table(path, cols, mode="overwrite",
                replace_where=col("month") == lit("12"))
    batch = read_table(path, filter=col("k") < lit(5), columns=["s"])

`columns` maps names to numpy arrays, (values, valid) pairs, or
`models.batch.Column`s (or is a `Batch`); a new table's schema is `schema`
where given, else comes from each column's `data_type` where it has one (a
decimal, binary, timestamp_ntz or nested column:
`models/batch.py::column_from_python` builds one from Python values), else
from its dtype (`models/schema.py::type_name_of`). The first write creates
the table: protocol (1, 2) and metadata with the given properties and
`partition_by` columns (ignored once the table exists, as in the
reference, but by `overwrite_schema`), in the same commit as the data, as
the reference does (`delta_tpu/api.py:24`). Returns the committed version.

The write modes, as the reference's `_write_table` (`delta_tpu/api.py:67`)
takes them, in one commit each:

- `append` (the default), `error` (`PathExistsError` if the table
  exists), `ignore` (an existing table is left as it is: the current
  version comes back and nothing is written);
- `overwrite`: every live file is removed (a file's deletion vector goes
  with its remove), then the rows are added;
- `overwrite` with `replace_where`, a predicate: every written row must
  satisfy it (DELTA_REPLACE_WHERE_MISMATCH, also on a first write; a
  predicate column the rows lack reads as null), and only the rows it
  matches are deleted, exactly as DELETE deletes them
  (`commands/dml.py::delete_matching_rows`: whole files, deletion vectors
  on a table with them, else copy-on-write); the commit carries the
  `predicate` parameter and DELETE's row and file metrics and, on an
  existing table with the change data feed on, the deleted rows'
  `delete` change data and the written rows' `insert` change data (the
  other modes write none: their feed is made from their adds and removes,
  `read/cdc.py`);
- `overwrite` with `partition_overwrite_mode="dynamic"`: only the files of
  the partitions the rows fall in are removed (partition values compared
  as the log spells them, keyed by physical name on a mapped table);
- `overwrite_schema` (with `overwrite`): the rows' schema and
  `partition_by` replace the table's in the same commit;
- `merge_schema`: the rows' new columns join the schema as nullable,
  nested ones inside their struct (`schema_evolution.py`);
- `data_change=False`: every add and remove says `dataChange: false` (a
  rearrangement: streams skip it).

Once the schema is settled, a table with generated, identity or default
columns fills the ones the rows leave out and checks the generated ones
they supply (`colgen.py::apply_column_generation`), before
`replace_where`'s check; a moved identity watermark is committed as the
table's metadata with the adds. The writer then holds the rows to the
NOT NULL and CHECK constraints (`write/writer.py`).

On a column-mapped table a new or replaced schema's fields get ids and
`col-<uuid>` physical names, and `delta.columnMapping.maxColumnId` moves
past them (`columnmapping.py::assign_column_mapping`); the reference gives
them none. The argument checks raise the reference's error classes in its
order: DELTA_ILLEGAL_USAGE, DELTA_ILLEGAL_OPTION,
DELTA_REPLACE_WHERE_WITH_DYNAMIC_PARTITION_OVERWRITE,
DELTA_OVERWRITE_SCHEMA_WITH_DYNAMIC_PARTITION_OVERWRITE,
DELTA_REPLACE_WHERE_WITH_FILTER_DATA_CHANGE_UNSET, DELTA_DATA_CHANGE_FALSE;
a `replace_where` column the table lacks raises `UnresolvedColumnError`
(DELTA_CANNOT_RESOLVE_COLUMN).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

from delta_tpu_torch.colgen import (
    apply_column_generation,
    needs_column_generation,
)
from delta_tpu_torch.columnmapping import (
    assign_column_mapping,
    is_mapped,
    strip_column_mapping,
)
from delta_tpu_torch.commands.dml import (
    DMLMetrics,
    delete_matching_rows,
    stage_change_data,
)
from delta_tpu_torch.errors import (
    InvalidArgumentError,
    InvariantViolationError,
    PathExistsError,
    TimeTravelArgumentError,
    UnresolvedColumnError,
)
from delta_tpu_torch.expressions.eval import evaluate_predicate
from delta_tpu_torch.models.batch import Batch, Column, as_column
from delta_tpu_torch.models.schema import (
    StructField,
    StructType,
    carried_type,
    schema_from_json,
    schema_to_json,
    type_name_of,
)
from delta_tpu_torch.schema_evolution import merge_schemas
from delta_tpu_torch.stats.partition import partition_keys, partition_value
from delta_tpu_torch.table import Table
from delta_tpu_torch.txn.transaction import Operation, check_write_supported
from delta_tpu_torch.write.writer import write_data_files

MODES = ("append", "overwrite", "error", "ignore")


def schema_of(batch: Batch) -> StructType:
    """The schema of a batch's columns: a column's own `data_type` where
    it carries one (a decimal, binary, timestamp_ntz or nested column the
    read gave, so that it writes back as that type), else its dtype's."""
    return StructType([StructField(name, c.data_type
                                   or type_name_of(c.values))
                       for name, c in batch.columns.items()])


def write_table(path: str, columns, mode: str = "append",
                partition_by: Optional[Sequence[str]] = None, engine=None,
                properties: Optional[Dict[str, str]] = None,
                target_rows_per_file: Optional[int] = None,
                schema: Optional[StructType] = None,
                merge_schema: bool = False, overwrite_schema: bool = False,
                replace_where=None,
                partition_overwrite_mode: Optional[str] = None,
                data_change: bool = True) -> int:
    """Write `columns` to the table at `path` in `mode` (module
    docstring), in files of at most `target_rows_per_file` rows; returns
    the committed version."""
    if mode not in MODES:
        raise InvalidArgumentError(
            f"unknown write mode {mode!r}; expected one of {list(MODES)}",
            error_class="DELTA_ILLEGAL_USAGE")
    batch = columns if isinstance(columns, Batch) else Batch(
        {name: as_column(v) for name, v in columns.items()})
    table = Table.for_path(path, engine)
    exists = table.exists()
    if exists and mode == "error":
        raise PathExistsError(f"table {path} already exists")
    if exists and mode == "ignore":
        return table.latest_snapshot().version
    dynamic = _check_options(mode, exists, merge_schema, overwrite_schema,
                             replace_where, partition_overwrite_mode,
                             data_change)
    builder = table.create_transaction_builder(
        Operation.WRITE if exists else Operation.CREATE_TABLE)
    if not exists:
        builder = builder.with_schema(schema if schema is not None
                                      else schema_of(batch))
        if partition_by:
            builder = builder.with_partition_columns(partition_by)
        if properties:
            builder = builder.with_table_properties(properties)
    txn = builder.build()
    check_write_supported(txn.protocol(), txn.metadata())
    overwrite = exists and mode == "overwrite"
    if overwrite and overwrite_schema:
        _replace_schema(txn, schema if schema is not None
                        else schema_of(batch), list(partition_by or []))
    if exists and merge_schema:
        _merge_schema(txn, schema_of(batch))
    meta = txn.metadata()
    table_schema = schema_from_json(meta.schemaString)
    if needs_column_generation(table_schema):
        batch, moved = apply_column_generation(batch, table_schema)
        if moved is not None:
            # the identity watermark moves in this commit
            table_schema = moved
            txn.update_metadata(dataclasses.replace(
                meta, schemaString=schema_to_json(moved)))
            meta = txn.metadata()
    if replace_where is not None:
        _check_replace_where(replace_where, batch, table_schema)
    now_ms = int(time.time() * 1000)
    metrics = None
    if overwrite and replace_where is not None:
        metrics = DMLMetrics()
        delete_matching_rows(txn, table, txn.read_snapshot, replace_where,
                             metrics, now_ms=now_ms,
                             candidates=txn.scan_files(filter=replace_where))
    adds = write_data_files(
        table.engine, table.path, batch, table_schema, meta.partitionColumns,
        meta.configuration, data_change=data_change,
        target_rows_per_file=target_rows_per_file)
    if overwrite and replace_where is None:
        # static: every live file; dynamic: those of the rows' partitions
        keys = partition_keys(meta)
        touched = {_partition_key(a.partitionValues, keys)
                   for a in adds} if dynamic else None
        for f in txn.scan_files():
            if touched is None or _partition_key(
                    f.partitionValues, keys) in touched:
                txn.remove_file(f.remove(deletion_timestamp=now_ms,
                                         data_change=data_change))
    txn.add_files(adds)
    if replace_where is not None:
        if exists:
            # a commit with change data is read from it alone, so the
            # written rows need their images too
            stage_change_data(txn, table, meta, [batch], "insert")
        txn.set_operation_parameters({"predicate": repr(replace_where)})
        if metrics is not None:
            txn.set_operation_metrics({
                "numDeletedRows": metrics.num_rows_deleted,
                "numRemovedFiles": (metrics.num_files_removed_fully
                                    + metrics.num_files_rewritten
                                    + metrics.num_dvs_written),
                "numCopiedRows": metrics.num_rows_copied,
                "numOutputRows": batch.num_rows,
            })
    return txn.commit().version


def _check_options(mode: str, exists: bool, merge_schema: bool,
                   overwrite_schema: bool, replace_where,
                   partition_overwrite_mode: Optional[str],
                   data_change: bool) -> bool:
    """The reference's argument checks, in its order; returns whether
    the overwrite is dynamic."""
    if (overwrite_schema or replace_where is not None) \
            and mode != "overwrite":
        raise InvalidArgumentError(
            "overwrite_schema/replace_where require mode='overwrite'",
            error_class="DELTA_ILLEGAL_USAGE")
    if overwrite_schema and replace_where is not None:
        raise InvalidArgumentError(
            "overwrite_schema cannot be combined with replace_where",
            error_class="DELTA_ILLEGAL_USAGE")
    if partition_overwrite_mode is not None and \
            partition_overwrite_mode.lower() not in ("static", "dynamic"):
        raise InvalidArgumentError(
            f"Invalid value '{partition_overwrite_mode}' for option "
            "'partitionOverwriteMode': expected 'static' or 'dynamic'",
            error_class="DELTA_ILLEGAL_OPTION")
    dynamic = (partition_overwrite_mode or "").lower() == "dynamic"
    if dynamic and replace_where is not None:
        raise InvalidArgumentError(
            "A 'replaceWhere' expression and "
            "'partitionOverwriteMode'='dynamic' cannot both be set",
            error_class="DELTA_REPLACE_WHERE_WITH_DYNAMIC_PARTITION_OVERWRITE")
    if dynamic and overwrite_schema:
        raise InvalidArgumentError(
            "'overwriteSchema' cannot be used in dynamic partition "
            "overwrite mode",
            error_class="DELTA_OVERWRITE_SCHEMA_WITH_DYNAMIC_PARTITION_OVERWRITE")
    if not data_change:
        if replace_where is not None:
            raise InvalidArgumentError(
                "'replaceWhere' cannot be used with data filters when "
                "'dataChange' is set to false",
                error_class="DELTA_REPLACE_WHERE_WITH_FILTER_DATA_CHANGE_UNSET")
        if not exists or overwrite_schema or merge_schema:
            # a rearrangement creates no table and changes no metadata
            raise InvalidArgumentError(
                "Cannot change table metadata because the 'dataChange' "
                f"option is set to false. Attempted operation: '{mode}'",
                error_class="DELTA_DATA_CHANGE_FALSE")
    return dynamic


def _set_schema(txn, meta, schema: StructType, **changes) -> None:
    """Stage `meta` with `schema` (its new fields mapped on a mapped
    table) and `changes`."""
    conf = meta.configuration
    if is_mapped(conf):
        schema, conf = assign_column_mapping(schema, conf)
    txn.update_metadata(dataclasses.replace(
        meta, schemaString=schema_to_json(schema), configuration=conf,
        **changes))


def _replace_schema(txn, schema: StructType, partition_by: List[str]
                    ) -> None:
    """overwrite_schema: `schema` and `partition_by` replace the table's
    where either differs (a mapped table's schema compared without its
    mapping, and replaced by fresh ids and physical names)."""
    meta = txn.metadata()
    current = schema_from_json(meta.schemaString)
    mapped = is_mapped(meta.configuration)
    same = (strip_column_mapping(current) if mapped else current) == schema
    if same and partition_by == list(meta.partitionColumns):
        return
    if mapped:
        schema = current if same else strip_column_mapping(schema)
    _set_schema(txn, meta, schema, partitionColumns=partition_by)


def _merge_schema(txn, incoming: StructType) -> None:
    """merge_schema: the table's schema with the rows' new columns."""
    meta = txn.metadata()
    current = schema_from_json(meta.schemaString)
    widen = meta.configuration.get("delta.enableTypeWidening",
                                   "").lower() == "true"
    merged = merge_schemas(current, incoming, allow_widening=widen)
    if merged != current:
        _set_schema(txn, meta, merged)


def _check_replace_where(predicate, batch: Batch, schema: StructType
                         ) -> None:
    """Every written row satisfies `predicate`; a column it names that the
    rows lack reads as null, one the table lacks is refused."""
    names = sorted({r[0] for r in predicate.references()})
    unknown = [n for n in names if n not in schema]
    if unknown:
        raise UnresolvedColumnError(
            f"replace_where references column(s) {unknown} not in the "
            "table schema", error_class="DELTA_CANNOT_RESOLVE_COLUMN")
    cols = dict(batch.columns)
    for n in names:
        if n not in cols:
            f = schema[n]
            cols[n] = Column.nulls(f.numpy_dtype, batch.num_rows,
                                   carried_type(f.data_type))
    if not evaluate_predicate(predicate, Batch(cols, batch.num_rows)).all():
        raise InvariantViolationError(
            "replace_where: written data contains rows that do not match "
            "the predicate", error_class="DELTA_REPLACE_WHERE_MISMATCH")


def _partition_key(values: Dict[str, Optional[str]], keys: Dict[str, str]
                   ) -> tuple:
    """A file's partition tuple as the log spells it, in the table's
    partition column order (`keys`: `stats/partition.py::partition_keys`)."""
    return tuple(partition_value(values, c, k) for c, k in keys.items())


def read_table(path: str, filter=None, columns: Optional[List[str]] = None,
               version: Optional[int] = None,
               timestamp_ms: Optional[int] = None, engine=None) -> Batch:
    """The table's rows (at `version`, or as of `timestamp_ms`, else the
    latest) that `filter` selects, with `columns` (all when None), as one
    `Batch`: scan planning with partition pruning and data skipping, then
    the row read (`Scan.to_batch()`). The snapshot's stats index is
    released at the end: this one-shot read's Table dies with the call."""
    if version is not None and timestamp_ms is not None:
        raise TimeTravelArgumentError(
            "provide either version or timestamp_ms, not both",
            error_class="DELTA_ONEOF_IN_TIMETRAVEL")
    table = Table.for_path(path, engine)
    if version is not None:
        snap = table.snapshot_at(version)
    elif timestamp_ms is not None:
        snap = table.snapshot_as_of_timestamp(timestamp_ms)
    else:
        snap = table.latest_snapshot()
    try:
        return snap.scan(filter=filter, columns=columns).to_batch()
    finally:
        if snap._state is not None:
            from delta_tpu_torch.stats.device_index import (
                release_state_stats_index,
            )

            release_state_stats_index(snap._state)

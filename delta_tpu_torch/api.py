"""Writing rows to a table and reading them back: the counterparts of
`delta_tpu/api.py::write_table` and `read_table`.

    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.expressions import col, lit
    write_table(path, {"k": np.arange(10), "s": np.array(["a"] * 10)})
    write_table(path, {"k": (values, valid)}, mode="append")
    write_table(path, cols, partition_by=["month"], target_rows_per_file=n)
    batch = read_table(path, filter=col("k") < lit(5), columns=["s"])

`columns` maps names to numpy arrays, (values, valid) pairs, or
`models.batch.Column`s; a new table's schema comes from each column's
`data_type` where it has one (a decimal, binary, timestamp_ntz or nested
column: `models/batch.py::column_from_python` builds one from Python values),
else from its dtype (`models/schema.py::type_name_of`). The first write creates
the table: protocol (1, 2) and metadata with the given properties and
`partition_by` columns (ignored once the table exists, as in the reference), in
the same commit as the data, as the reference does (`delta_tpu/api.py:24`).
Returns the committed version.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from delta_tpu_torch.errors import (
    PathExistsError,
    TimeTravelArgumentError,
    UnsupportedTableError,
)
from delta_tpu_torch.models.batch import Batch, as_column
from delta_tpu_torch.models.schema import (
    StructField,
    StructType,
    schema_from_json,
    type_name_of,
)
from delta_tpu_torch.table import Table
from delta_tpu_torch.txn.transaction import Operation, check_write_supported
from delta_tpu_torch.write.writer import write_data_files


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
                target_rows_per_file: Optional[int] = None) -> int:
    """Append `columns` to the table at `path` (creating it), or with
    mode="error" create it and fail if it exists; files of at most
    `target_rows_per_file` rows."""
    if mode not in ("append", "error"):
        raise UnsupportedTableError(f"write mode {mode!r} is not supported "
                                    "yet", feature=f"mode {mode}")
    batch = columns if isinstance(columns, Batch) else Batch(
        {name: as_column(v) for name, v in columns.items()})
    table = Table.for_path(path, engine)
    exists = table.exists()
    if exists and mode == "error":
        raise PathExistsError(f"table {path} already exists")
    builder = table.create_transaction_builder(
        Operation.WRITE if exists else Operation.CREATE_TABLE)
    if not exists:
        builder = builder.with_schema(schema_of(batch))
        if partition_by:
            builder = builder.with_partition_columns(partition_by)
        if properties:
            builder = builder.with_table_properties(properties)
    txn = builder.build()
    meta = txn.metadata()
    check_write_supported(txn.protocol(), meta)
    txn.add_files(write_data_files(
        table.engine, table.path, batch, schema_from_json(meta.schemaString),
        meta.partitionColumns, meta.configuration,
        target_rows_per_file=target_rows_per_file))
    return txn.commit().version


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

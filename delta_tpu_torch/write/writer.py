"""Transactional data-file writing for an unpartitioned table.

Counterpart of `delta_tpu/write/writer.py:32-178, 222-228`: a `Batch`
goes in; Parquet data files (`part-<uuid>.parquet`, under a random
prefix directory when `delta.randomizeFilePrefixes` is on) and their
`AddFile` actions (size, modification time, stats JSON) come out, ready
to stage on a transaction. Rows split into files of at most
`target_rows_per_file` rows. The schema check and the NOT NULL check run
before any file is written. A partitioned table, column mapping and CHECK
constraints raise `UnsupportedTableError`.
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional, Sequence

from delta_tpu_torch.config import (
    COLUMN_MAPPING_MODE,
    RANDOM_PREFIX_LENGTH,
    RANDOMIZE_FILE_PREFIXES,
    get_table_config,
)
from delta_tpu_torch.errors import (
    InvariantViolationError,
    SchemaMismatchError,
    UnsupportedTableError,
)
from delta_tpu_torch.models.actions import AddFile
from delta_tpu_torch.models.batch import Batch
from delta_tpu_torch.models.schema import StructType
from delta_tpu_torch.stats.collection import collect_stats
from delta_tpu_torch.utils.parquet_write import write_data_file

_CDC_COLUMNS = {"_change_type", "_commit_version", "_commit_timestamp"}


def _validate_schema(data: Batch, schema: StructType) -> None:
    table_fields = set(data.column_names)
    schema_fields = set(schema.field_names())
    missing = schema_fields - table_fields
    extra = table_fields - schema_fields
    if extra:
        if _CDC_COLUMNS & extra:
            raise SchemaMismatchError(
                f"columns {sorted(_CDC_COLUMNS & extra)} are reserved for "
                "the change data feed and cannot be written",
                error_class="RESERVED_CDC_COLUMNS_ON_WRITE")
        raise SchemaMismatchError(
            f"columns {sorted(extra)} not in table schema "
            f"{sorted(schema_fields)}",
            error_class="DELTA_COLUMN_NOT_FOUND_IN_SCHEMA")
    nonnull_missing = [m for m in missing if not schema[m].nullable]
    if nonnull_missing:
        raise SchemaMismatchError(
            f"missing non-nullable columns: {sorted(nonnull_missing)}",
            error_class="DELTA_MISSING_NOT_NULL_COLUMN_VALUE")


def _check_invariants(data: Batch, schema: StructType) -> None:
    for f in schema.fields:
        if not f.nullable and f.name in data.columns:
            nulls = data.columns[f.name].null_count
            if nulls:
                raise InvariantViolationError(
                    f"NOT NULL constraint violated for column {f.name}: "
                    f"{nulls} null row(s)",
                    error_class="DELTA_NOT_NULL_CONSTRAINT_VIOLATED")


def _split_rows(data: Batch, target_rows: Optional[int]) -> List[Batch]:
    if target_rows is None or data.num_rows <= target_rows:
        return [data]
    return [data.slice(start, start + target_rows)
            for start in range(0, data.num_rows, target_rows)]


def write_data_files(engine, table_path: str, data: Batch,
                     schema: StructType, partition_columns: Sequence[str],
                     configuration: Dict[str, str], data_change: bool = True,
                     target_rows_per_file: Optional[int] = None,
                     ) -> List[AddFile]:
    """Write `data` under `table_path`; returns the AddFile actions."""
    if partition_columns:
        raise UnsupportedTableError(
            "writing a partitioned table is not supported yet",
            feature="partitioned table")
    if get_table_config(configuration, COLUMN_MAPPING_MODE) != "none":
        raise UnsupportedTableError(
            "writing a table with column mapping is not supported yet",
            feature="column mapping")
    if any(k.startswith("delta.constraints.") for k in configuration):
        raise UnsupportedTableError(
            "CHECK constraints are not supported yet",
            feature="check constraints")
    _validate_schema(data, schema)
    _check_invariants(data, schema)
    now_ms = int(time.time() * 1000)
    randomize = get_table_config(configuration, RANDOMIZE_FILE_PREFIXES)
    prefix_len = max(1, get_table_config(configuration, RANDOM_PREFIX_LENGTH))
    file_schema = StructType([schema[c] for c in data.column_names])
    adds: List[AddFile] = []
    for chunk in _split_rows(data, target_rows_per_file):
        if chunk.num_rows == 0:
            continue
        fname = f"part-{uuid.uuid4()}.parquet"
        rel_path = (f"{uuid.uuid4().hex[:prefix_len]}/{fname}" if randomize
                    else fname)
        status = write_data_file(f"{table_path}/{rel_path}", chunk,
                                 file_schema, engine.fs)
        adds.append(AddFile(
            path=rel_path,
            partitionValues={},
            size=status.size,
            modificationTime=status.modification_time or now_ms,
            dataChange=data_change,
            stats=collect_stats(chunk, schema, configuration, []),
        ))
    return adds

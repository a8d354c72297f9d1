"""Reading one data file of a table as logical rows.

Counterpart of `delta_tpu/read/reader.py:21-124`
(`read_add_file_logical`), the read half of every file-rewrite command:
the file's columns in file order, kept when the table schema names them
and cast up where the file predates a widening (int32 -> int64, float32
-> float64); a schema column the file lacks reads as null. A missing file
raises `FileNotFoundInLogError`; a deletion vector, column mapping or a
partitioned table raises `UnsupportedTableError`.
"""

from __future__ import annotations

import numpy as np

from delta_tpu_torch.config import COLUMN_MAPPING_MODE, get_table_config
from delta_tpu_torch.errors import FileNotFoundInLogError, UnsupportedTableError
from delta_tpu_torch.log.parquet_data import read_data_file
from delta_tpu_torch.models.batch import Batch, Column
from delta_tpu_torch.models.schema import schema_from_json


def absolute_path(table_path: str, file_path: str) -> str:
    if "://" in file_path or file_path.startswith("/"):
        return file_path
    return f"{table_path}/{file_path}"


def _align_to_logical(batch: Batch, schema) -> Batch:
    known = {f.name: f for f in schema.fields}
    cols = {}
    for name in batch.column_names:
        f = known.get(name)
        if f is None:
            continue
        col = batch.columns[name]
        want = f.numpy_dtype
        if col.values.dtype != want and np.can_cast(col.values.dtype, want,
                                                    "safe"):
            col = Column(col.values.astype(want), col.valid)
        cols[name] = col
    for f in schema.fields:
        if f.name not in cols:
            cols[f.name] = Column.nulls(f.numpy_dtype, batch.num_rows)
    return Batch(cols, batch.num_rows)


def read_add_file_logical(engine, table_path: str, metadata, add) -> Batch:
    """Read one AddFile's rows in the table's logical schema."""
    if metadata.partitionColumns:
        raise UnsupportedTableError(
            "reading a partitioned table's files is not supported yet",
            feature="partitioned table")
    if get_table_config(metadata.configuration, COLUMN_MAPPING_MODE) != "none":
        raise UnsupportedTableError(
            "column mapping is not supported yet", feature="column mapping")
    if add.deletionVector is not None:
        raise UnsupportedTableError(
            f"{add.path} has a deletion vector; deletion vectors are not "
            "supported yet", feature="deletion vectors")
    try:
        data = engine.fs.read_file(absolute_path(table_path, add.path))
    except FileNotFoundError as e:
        raise FileNotFoundInLogError(
            f"data file referenced by the log is missing: {add.path} "
            "(removed by VACUUM, or the log is ahead of storage)") from e
    return _align_to_logical(read_data_file(data),
                             schema_from_json(metadata.schemaString))

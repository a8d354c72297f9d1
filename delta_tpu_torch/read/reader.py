"""Reading a table's data files as logical rows.

Counterpart of `delta_tpu/read/reader.py:21-202`:

- `read_add_files_logical`, the read half of every file-rewrite command:
  each file's columns in file order, kept when the table schema names
  them (a partition column the file holds is dropped) and cast to the
  table's type where the file predates a widening (`_cast`: byte ->
  short -> integer -> long, integer or long -> decimal, decimal(p,s) ->
  decimal(p',s') with s' >= s, date -> timestamp or timestamp_ntz, float
  -> double; a value the target cannot hold leaves the column as the
  file has it, as the reference's Arrow cast does); a schema column the
  file lacks reads as null, of any type, nested too; the rows its
  deletion vector deletes dropped; then the partition columns, typed
  (decimal, binary and timestamp_ntz too), from the
  file's `partitionValues` (`_append_partition_columns`, after the data
  columns, as the reference appends them); `read_add_file_logical` reads
  one file; DML reads with `apply_dv=False`: it computes row indexes
  against the file's own order; the change data feed reads with
  `missing_ok`, where a vacuumed file reads as None;
- `read_cdc_files_logical`, the change data files of a feed
  (`read/cdc.py`), in Delta's form and in the reference's;
- `read_scan`, the row read of a scan (`Scan.to_batch()`): each surviving
  file reads only the needed data columns (the projection plus the
  residual filter's references), drops its deleted rows, aligns to the
  logical schema, takes its needed partition columns, then the filter
  applies to all rows (NULL drops the row; partition columns included)
  and the projection last. No surviving file gives the schema's (or the
  projection's) columns, empty.

Under column mapping a file's columns are found by their physical names
and come back under the logical ones: a column the table dropped
disappears, one it added reads as null, a partition value is keyed by the
physical name (or the logical one), and a projection asks the file for
physical names. Nested struct fields are renamed the same way, at every
depth (`columnmapping.py::logical_converter`; also on a table without
mapping, where a field added inside a struct reads as null).

Both read every file first, then decode the deletion vectors of all of
them in one batch on the engine's device (`deleted_row_masks`: one K8
launch on the card, `dv/descriptor.py::load_deletion_vector_masks`), then
drop each file's deleted rows. A missing file raises
`FileNotFoundInLogError`; a data file in a form the Parquet reader does
not decode (`DecodeUnsupported`: an LZ4 or Brotli page, a legacy
two-level list) raises `UnsupportedTableError`; a damaged data file
(`DecodeCorrupt`) raises `DataFileCorruptedError`. Both name the file.
Every type of `models/schema.py` reads (`models/batch.py` says how each
lies in memory), as every write path writes it.
"""

from __future__ import annotations

import numpy as np

from delta_tpu_torch.columnmapping import (
    is_mapped,
    logical_converter,
    logical_to_physical_names,
    physical_to_logical_names,
)
from delta_tpu_torch.dv.descriptor import load_deletion_vector_masks
from delta_tpu_torch.errors import (
    DataFileCorruptedError,
    FileNotFoundInLogError,
    UnsupportedTableError,
)
from delta_tpu_torch.models.actions import Metadata
from delta_tpu_torch.log.parquet_data import read_data_file
from delta_tpu_torch.log.parquet_footer import DecodeCorrupt, DecodeUnsupported
from delta_tpu_torch.models.batch import Batch, Column, zeros
from delta_tpu_torch.models.schema import (
    MAX_INT64_PRECISION,
    carried_type,
    decimal_precision_scale,
    numpy_dtype_of,
    schema_from_json,
)
from delta_tpu_torch.stats.partition import (
    partition_column,
    partition_keys,
    partition_value,
)
from delta_tpu_torch.write.writer import CDC_TYPE_COLUMN



def absolute_path(table_path: str, file_path: str) -> str:
    if "://" in file_path or file_path.startswith("/"):
        return file_path
    return f"{table_path}/{file_path}"


def _rescaled(unscaled: np.ndarray, valid, by: int, precision: int):
    """Unscaled integers times 10**by in the lanes of `precision`; None
    where a valid value needs more than `precision` digits."""
    ints = unscaled.tolist()
    factor = 10 ** by
    limit = 10 ** precision
    out = [v * factor for v in ints]
    ok = valid.tolist() if valid is not None else [True] * len(out)
    if any(k and abs(v) >= limit for v, k in zip(out, ok)):
        return None
    if precision <= MAX_INT64_PRECISION:
        return np.array(out, np.int64)
    arr = np.empty(len(out), object)
    arr[:] = out
    return arr


def _cast(col: Column, target) -> Column:
    """`col` as the table's type `target` where the file's type widens to
    it; else `col` as it is (the reference's Arrow cast, whose failures
    leave the column be)."""
    values, have = col.values, col.data_type
    want_ps = decimal_precision_scale(target)
    if want_ps is not None:
        have_ps = decimal_precision_scale(have)
        if have_ps is None and values.dtype.kind == "i":
            have_ps = (19, 0)  # an integer column: unscaled at scale 0
        if have_ps is None or have_ps[1] > want_ps[1]:
            return col
        out = (values if have_ps == want_ps else
               _rescaled(values, col.valid, want_ps[1] - have_ps[1],
                         want_ps[0]))
        return col if out is None else Column(out, col.valid, target)
    if not isinstance(target, str):  # nested: renamed to the table's
        if values.dtype != object:
            return col
        conv = logical_converter(target, have)
        if conv is not None:
            out = np.empty(len(values), object)
            out[:] = [conv(v) for v in values.tolist()]
            values = out
        return Column(values, col.valid, target)
    want = numpy_dtype_of(target)
    if decimal_precision_scale(have) is not None or have == "binary" or (
            values.dtype != want and (values.dtype == object or not
                                      np.can_cast(values.dtype, want,
                                                  "safe"))):
        return col
    return Column(values.astype(want, copy=False), col.valid,
                  carried_type(target))


def _align_to_logical(batch: Batch, schema, partition_columns=(),
                      needed=None, mapped: bool = False) -> Batch:
    """Schema columns only, found by their physical names when `mapped`,
    under their logical names, cast to the table's types, partition
    columns left out; a schema column the file lacks reads as null (only
    those in `needed`, when given)."""
    known = {f.name: f for f in schema.fields
             if f.name not in partition_columns}
    p2l = physical_to_logical_names(schema) if mapped else None
    cols = {}
    for name in batch.column_names:
        f = known.get(p2l.get(name) if mapped else name)
        if f is None:
            continue
        cols[f.name] = _cast(batch.columns[name], f.data_type)
    for f in known.values():
        if f.name not in cols and (needed is None or f.name in needed):
            cols[f.name] = Column.nulls(f.numpy_dtype, batch.num_rows,
                                        carried_type(f.data_type))
    return Batch(cols, batch.num_rows)


def _append_partition_columns(batch: Batch, add, schema, partition_columns,
                              needed=None, keys=None) -> Batch:
    """The file's partition values (strings in `partitionValues`, keyed
    by `keys`: the physical names under column mapping) spliced in as
    typed columns after the data columns."""
    cols = dict(batch.columns)
    pv = add.partitionValues or {}
    for c in partition_columns:
        if needed is not None and c not in needed:
            continue
        type_name = (schema[c].data_type if c in schema and isinstance(
            schema[c].data_type, str) else "string")
        value = partition_value(pv, c, (keys or {}).get(c, c))
        cols[c] = partition_column(value, type_name, batch.num_rows)
    return Batch(cols, batch.num_rows)


def _logical(batch: Batch, add, schema, metadata: Metadata,
             needed=None) -> Batch:
    pcols = metadata.partitionColumns
    return _append_partition_columns(
        _align_to_logical(batch, schema, pcols, needed,
                          is_mapped(metadata.configuration)),
        add, schema, pcols, needed, partition_keys(metadata))


def deleted_row_masks(engine, table_path: str, adds, row_counts) -> list:
    """Bool masks of the rows each file's deletion vector deletes (None
    for a file with none), decoded in one batch."""
    has = [i for i, a in enumerate(adds) if a.deletionVector is not None]
    out = [None] * len(adds)
    if has:
        masks = load_deletion_vector_masks(engine, table_path, [
            (adds[i].deletionVector.to_dict(), row_counts[i]) for i in has])
        for i, m in zip(has, masks):
            out[i] = m
    return out


def deleted_row_mask(engine, table_path: str, add, num_rows: int):
    """Bool mask [num_rows] of the rows a file's deletion vector deletes
    (None: the file has none): a batch of one."""
    return deleted_row_masks(engine, table_path, [add], [num_rows])[0]


def _drop_deleted(engine, table_path: str, adds, batches) -> list:
    masks = deleted_row_masks(engine, table_path, adds,
                              [b.num_rows for b in batches])
    return [b if m is None else b.take(np.flatnonzero(~m))
            for b, m in zip(batches, masks)]


def _read_bytes(engine, table_path: str, add) -> bytes:
    try:
        return engine.fs.read_file(absolute_path(table_path, add.path))
    except FileNotFoundError as e:
        raise FileNotFoundInLogError(
            f"data file referenced by the log is missing: {add.path} "
            "(removed by VACUUM, or the log is ahead of storage)") from e


def _read_file(engine, table_path: str, add, columns=None) -> Batch:
    """One data file's columns (`read_data_file`), the reader's scope and
    damage refusals typed and naming the file."""
    data = _read_bytes(engine, table_path, add)
    try:
        return read_data_file(data, columns)
    except DecodeUnsupported as e:
        raise UnsupportedTableError(
            f"data file {add.path}: {e}", feature="parquet form",
            path=add.path) from e
    except DecodeCorrupt as e:
        raise DataFileCorruptedError(
            f"data file {add.path} is damaged: {e}", path=add.path) from e


def read_add_files_logical(engine, table_path: str, metadata, adds,
                           missing_ok=None) -> list:
    """Read AddFiles' rows in the table's logical schema, one Batch each,
    their deleted rows dropped (the DVs decoded in one batch). A file
    whose `missing_ok` entry is true and that is missing (vacuumed) reads
    as None."""
    schema = schema_from_json(metadata.schemaString)
    batches = []
    for i, a in enumerate(adds):
        try:
            batches.append(_read_file(engine, table_path, a))
        except FileNotFoundInLogError:
            if not (missing_ok is not None and missing_ok[i]):
                raise
            batches.append(None)
    have = [i for i, b in enumerate(batches) if b is not None]
    kept = _drop_deleted(engine, table_path, [adds[i] for i in have],
                         [batches[i] for i in have])
    out = [None] * len(adds)
    for i, b in zip(have, kept):
        out[i] = _logical(b, adds[i], schema, metadata)
    return out


def read_cdc_files_logical(engine, table_path: str, metadata, cdcs
                           ) -> list:
    """Read change data files (`cdc` actions) in the table's logical
    schema, data columns then partition columns, then `_change_type`, one
    Batch each. Both forms read: Delta's (physical names under column
    mapping, the partition columns in `partitionValues`) and the
    reference's (logical names, the partition columns in the file,
    `partitionValues` empty: ROADMAP C26). A column is found by its
    physical name, then by its name; a partition column by its
    `partitionValues` key, then in the file; a column neither holds reads
    as null."""
    schema = schema_from_json(metadata.schemaString)
    mapped = is_mapped(metadata.configuration)
    pcols = list(metadata.partitionColumns)
    keys = partition_keys(metadata)
    out = []
    for cdc in cdcs:
        batch = _read_file(engine, table_path, cdc)
        n = batch.num_rows
        pv = cdc.partitionValues or {}
        cols = {}
        for f in sorted(schema.fields, key=lambda f: f.name in pcols):
            held = [c for c in ((f.physical_name if mapped else f.name),
                                f.name) if c in batch.columns]
            key = keys.get(f.name, f.name)
            if f.name in pcols and (key in pv or f.name in pv or not held):
                t = (f.data_type if isinstance(f.data_type, str)
                     else "string")
                cols[f.name] = partition_column(
                    partition_value(pv, f.name, key), t, n)
            elif held:
                cols[f.name] = _cast(batch.columns[held[0]], f.data_type)
            else:
                cols[f.name] = Column.nulls(f.numpy_dtype, n,
                                            carried_type(f.data_type))
        cols[CDC_TYPE_COLUMN] = batch.columns[CDC_TYPE_COLUMN]
        out.append(Batch(cols, n))
    return out


def read_add_file_logical(engine, table_path: str, metadata, add,
                          apply_dv: bool = True) -> Batch:
    """Read one AddFile's rows in the table's logical schema (its deleted
    rows dropped unless `apply_dv` is False)."""
    if apply_dv:
        return read_add_files_logical(engine, table_path, metadata, [add])[0]
    batch = _read_file(engine, table_path, add)
    return _logical(batch, add, schema_from_json(metadata.schemaString),
                    metadata)


def _empty(schema, names) -> Batch:
    cols = {}
    for c in names:
        t = schema[c].data_type if c in schema else "string"
        cols[c] = Column(zeros(numpy_dtype_of(t), 0), None, carried_type(t))
    return Batch(cols, 0)


def read_scan(scan) -> Batch:
    """The rows of a scan's surviving files (module docstring)."""
    snapshot = scan.snapshot
    engine = snapshot.engine
    metadata = snapshot.metadata
    schema = schema_from_json(metadata.schemaString)
    files = scan.add_files()
    requested = scan.columns
    needed = requested
    if requested is not None and scan.filter is not None:
        # columns the filter references are read even when not projected
        refs = [r[0] for r in scan.filter.references()]
        needed = requested + [c for c in dict.fromkeys(refs)
                              if c not in requested]
    wanted = needed
    if needed is not None and is_mapped(metadata.configuration):
        l2p = logical_to_physical_names(schema)
        wanted = [l2p.get(c, c) for c in needed]
    parts = [_read_file(engine, snapshot.table_path, add, wanted)
             for add in files]
    batches = [_logical(part, add, schema, metadata, needed)
               for add, part in zip(files, _drop_deleted(
                   engine, snapshot.table_path, files, parts))]
    if not batches:
        return _empty(schema, requested if requested is not None
                      else schema.field_names())
    order = batches[0].column_names
    result = Batch.concat([Batch({c: b.columns[c] for c in order},
                                 b.num_rows) for b in batches])
    if scan.filter is not None:
        from delta_tpu_torch.expressions.eval import evaluate_predicate

        keep = evaluate_predicate(scan.filter, result)
        result = result.take(np.nonzero(keep)[0])
    if requested is not None:
        result = Batch({c: result.columns[c] for c in requested},
                       result.num_rows)
    return result

"""Transactional data-file writing.

Counterpart of `delta_tpu/write/writer.py:32-228`: a `Batch` goes in;
Parquet data files (`part-<uuid>.parquet`) and their `AddFile` actions
(partition values, size, modification time, stats JSON) come out, ready
to stage on a transaction. A partitioned table's rows are grouped by
their partition values (`_partition_groups`, groups in order of first
appearance, a NaN or null value the null partition); each group's files
go in its Hive-style directory (`stats/partition.py::partition_path`
decoded: `month=12/`, null `__HIVE_DEFAULT_PARTITION__`) or, with
`delta.randomizeFilePrefixes`, in a random prefix directory instead, and
carry the group's `partitionValues` (a decimal spelled with its scale's
digits, `1.50`; binary as its UTF-8 text; timestamp_ntz as
`%Y-%m-%d %H:%M:%S.%f`); the partition columns are left out of the file
and of its stats. The file lies in that directory (`x=a%b/` for the
value `a%b`) and its AddFile holds that decoded path, as a loaded
snapshot's do; the log gets the path as a URI
(`models/actions.py::encode_path`: `x=a%25b/`), which every reader
percent-decodes once back to where the file lies. (The reference puts
the file at the undecoded name, where neither package's reader looks.)
Rows split into files of at most `target_rows_per_file` rows. The schema
check, the NOT NULL check (nested fields too) and the table's CHECK
constraints (`constraints.py`, from `delta.constraints.*`) run before any
file is written: a row whose constraint is false or NULL (the reference
fills NULL with False) raises DELTA_VIOLATE_CONSTRAINT_WITH_VALUES, a
column the rows leave out reading as NULL. Every write path comes
through here: append and every write mode, DELETE's and UPDATE's
rewrites, MERGE, OPTIMIZE and REORG.

The rows come in under logical names. Under column mapping the Parquet
fields (at every depth), the stats JSON keys and the `partitionValues`
keys (and the partition directories) are the physical names.

`write_cdc_files` writes a command's change data (counterpart of
`delta_tpu/commands/dml.py::_write_cdc`) in Delta's form: the rows in
the table's schema with `_change_type` last, under `_change_data/` and,
on a partitioned table, under the partition's directory there, the
partition columns left out of the file and in the `cdc` action's
`partitionValues`, physical names under column mapping; no stats, no
checks (the rows are images of rows the table held or now holds),
`dataChange` false, nothing for zero rows. (The reference writes the
full rows under logical names with `partitionValues` `{}`: ROADMAP C26.)
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional, Sequence
from urllib.parse import unquote

import numpy as np

from delta_tpu_torch.columnmapping import is_mapped
from delta_tpu_torch.config import (
    RANDOM_PREFIX_LENGTH,
    RANDOMIZE_FILE_PREFIXES,
    get_table_config,
)
from delta_tpu_torch.constraints import table_constraints
from delta_tpu_torch.errors import InvariantViolationError, SchemaMismatchError
from delta_tpu_torch.expressions.eval import evaluate_predicate
from delta_tpu_torch.expressions.parser import to_sql
from delta_tpu_torch.models.actions import AddCDCFile, AddFile
from delta_tpu_torch.models.batch import Batch, Column, factorize_objects
from delta_tpu_torch.models.schema import (
    ArrayType,
    MapType,
    StructField,
    StructType,
    carried_type,
    decimal_precision_scale,
)
from delta_tpu_torch.stats.collection import collect_stats
from delta_tpu_torch.stats.partition import (
    partition_path,
    serialize_partition_value,
)
from delta_tpu_torch.utils.filenames import CHANGE_DATA_DIR
from delta_tpu_torch.utils.parquet_write import write_data_file

CDC_TYPE_COLUMN = "_change_type"
_CDC_COLUMNS = {CDC_TYPE_COLUMN, "_commit_version", "_commit_timestamp"}


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
    for name in sorted(table_fields & schema_fields):
        want = schema[name].data_type
        have = data.columns[name].data_type
        if decimal_precision_scale(want) and have != want:
            # unscaled lanes of another scale, or plain integers
            raise SchemaMismatchError(
                f"column {name} of type {want} takes a decimal column of "
                f"that type, not {have or data.columns[name].values.dtype}",
                error_class="DELTA_FAILED_TO_MERGE_FIELDS")
    nonnull_missing = [m for m in missing if not schema[m].nullable]
    if nonnull_missing:
        raise SchemaMismatchError(
            f"missing non-nullable columns: {sorted(nonnull_missing)}",
            error_class="DELTA_MISSING_NOT_NULL_COLUMN_VALUE")


def _check_invariants(data: Batch, schema: StructType) -> None:
    """NOT NULL: a top-level column (as the reference), and inside a
    present struct, array or map (a non-nullable field, element, value,
    and every map key), which a REQUIRED Parquet field cannot hold."""
    for f in schema.fields:
        if f.name not in data.columns:
            continue
        col = data.columns[f.name]
        nulls = col.null_count if not f.nullable else 0
        if nulls:
            raise InvariantViolationError(
                f"NOT NULL constraint violated for column {f.name}: "
                f"{nulls} null row(s)",
                error_class="DELTA_NOT_NULL_CONSTRAINT_VIOLATED")
        if not isinstance(f.data_type, str) and _has_required(f.data_type):
            rows = (col.values if col.valid is None
                    else col.values[col.valid]).tolist()
            bad = _null_required(f.data_type, rows, f.name)
            if bad is not None:
                raise InvariantViolationError(
                    f"NOT NULL constraint violated for column {bad}",
                    error_class="DELTA_NOT_NULL_CONSTRAINT_VIOLATED")


def _check_constraints(data: Batch, schema: StructType,
                       configuration: Dict[str, str]) -> None:
    """Every row satisfies every CHECK constraint of the table (a NULL
    result violates; a column the rows lack reads as NULL)."""
    for name, expr in table_constraints(configuration).items():
        cols = dict(data.columns)
        for ref in sorted({r[0] for r in expr.references()}):
            if ref not in cols and ref in schema:
                f = schema[ref]
                cols[ref] = Column.nulls(f.numpy_dtype, data.num_rows,
                                         carried_type(f.data_type))
        bad = int((~evaluate_predicate(expr, Batch(cols, data.num_rows)))
                  .sum())
        if bad:
            raise InvariantViolationError(
                f"CHECK constraint {name} ({to_sql(expr)}) violated by "
                f"{bad} row(s)",
                error_class="DELTA_VIOLATE_CONSTRAINT_WITH_VALUES")


def _has_required(t) -> bool:
    if isinstance(t, StructType):
        return any(not f.nullable or _has_required(f.data_type)
                   for f in t.fields)
    if isinstance(t, ArrayType):
        return not t.contains_null or _has_required(t.element_type)
    if isinstance(t, MapType):
        return True  # a map key is never null
    return False


def _null_required(t, values: list, what: str) -> Optional[str]:
    """The name path of the first non-nullable place that holds a null
    among the present `values` of type `t`; None when there is none."""
    if isinstance(t, StructType):
        for f in t.fields:
            if not f.nullable or _has_required(f.data_type):
                kids = [v.get(f.name) for v in values]
                if not f.nullable and any(k is None for k in kids):
                    return f"{what}.{f.name}"
                bad = _null_required(f.data_type,
                                     [k for k in kids if k is not None],
                                     f"{what}.{f.name}")
                if bad is not None:
                    return bad
        return None
    if isinstance(t, ArrayType):
        elems = [e for v in values for e in v]
        if not t.contains_null and any(e is None for e in elems):
            return f"{what}.element"
        return _null_required(t.element_type,
                              [e for e in elems if e is not None],
                              f"{what}.element")
    if isinstance(t, MapType):
        pairs = [kv for v in values
                 for kv in (v.items() if isinstance(v, dict) else v)]
        if any(k is None for k, _ in pairs):
            return f"{what}.key"
        if not t.value_contains_null and any(x is None for _, x in pairs):
            return f"{what}.value"
        return (_null_required(t.key_type, [k for k, _ in pairs],
                               f"{what}.key")
                or _null_required(t.value_type,
                                  [x for _, x in pairs if x is not None],
                                  f"{what}.value"))
    return None


def check_rows(data: Batch, schema: StructType,
               configuration: Dict[str, str]) -> None:
    """The checks every write makes before its first file: the schema,
    NOT NULL and the CHECK constraints (a command that writes several
    batches calls it on each first, so that nothing is written when one
    fails)."""
    _validate_schema(data, schema)
    _check_invariants(data, schema)
    _check_constraints(data, schema, configuration)


def _split_rows(data: Batch, target_rows: Optional[int]) -> List[Batch]:
    if target_rows is None or data.num_rows <= target_rows:
        return [data]
    return [data.slice(start, start + target_rows)
            for start in range(0, data.num_rows, target_rows)]


def _partition_groups(data: Batch, partition_columns: Sequence[str]
                      ) -> List[tuple]:
    """[(partitionValues, the group's rows)] in order of each group's
    first row (the reference's order); a null or NaN value is the null
    partition."""
    n = data.num_rows
    codes = np.zeros(n, np.int64)
    valid = {}
    for c in partition_columns:
        if c not in data.columns:
            raise SchemaMismatchError(
                f"partition column {c} missing from data",
                error_class="DELTA_MISSING_PARTITION_COLUMN")
        col = data.columns[c]
        values = col.values
        ok = np.ones(n, bool) if col.valid is None else col.valid.copy()
        if values.dtype.kind == "f":
            ok &= ~np.isnan(values)
        valid[c] = ok
        if values.dtype.kind == "O":
            # by Python equality: "a" and "a\x00" stay two partitions
            inv = np.where(ok, factorize_objects(
                np.where(ok, values, "")) + 1, 0)
        else:
            inv = np.where(ok, np.unique(values, return_inverse=True)[1]
                           .reshape(-1) + 1, 0)
        # a running radix over the columns, kept dense
        codes = np.unique(codes * (int(inv.max(initial=0)) + 1) + inv,
                          return_inverse=True)[1].reshape(-1)
    _, first, inv = np.unique(codes, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    group = rank[inv.reshape(-1)]
    rows = np.argsort(group, kind="stable")
    bounds = np.cumsum(np.bincount(group, minlength=len(order)))
    out = []
    for g, idx in enumerate(np.split(rows, bounds[:-1])):
        head = int(first[order[g]])
        pv = {c: serialize_partition_value(_value_at(data.columns[c], head))
              if valid[c][head] else None for c in partition_columns}
        out.append((pv, data.take(idx) if len(order) > 1 else data))
    return out


def _value_at(col, i: int):
    """Row i's value as the partition value is spelled from it: the numpy
    value, or the Python value of a column whose dtype does not say its
    type (a decimal's Decimal, with its scale's digits)."""
    if col.data_type is None:
        return col.values[i]
    return col.slice(i, i + 1).to_python()[0]


def write_data_files(engine, table_path: str, data: Batch,
                     schema: StructType, partition_columns: Sequence[str],
                     configuration: Dict[str, str], data_change: bool = True,
                     target_rows_per_file: Optional[int] = None,
                     ) -> List[AddFile]:
    """Write `data` under `table_path`; returns the AddFile actions."""
    check_rows(data, schema, configuration)
    partition_columns = list(partition_columns)
    groups = (_partition_groups(data, partition_columns)
              if partition_columns and data.num_rows else [({}, data)])
    now_ms = int(time.time() * 1000)
    randomize = get_table_config(configuration, RANDOMIZE_FILE_PREFIXES)
    prefix_len = max(1, get_table_config(configuration, RANDOM_PREFIX_LENGTH))
    mapped = is_mapped(configuration)
    key = _partition_keys(schema, partition_columns, mapped)
    keyed_columns = [key[c] for c in partition_columns]
    adds: List[AddFile] = []
    for pv, part in groups:
        pv = {key[c]: v for c, v in pv.items()}
        file_data = Batch({c: v for c, v in part.columns.items()
                           if c not in partition_columns}, part.num_rows)
        file_schema = StructType([schema[c] for c in file_data.column_names])
        for chunk in _split_rows(file_data, target_rows_per_file):
            if chunk.num_rows == 0:
                continue
            fname = f"part-{uuid.uuid4()}.parquet"
            # a random prefix directory INSTEAD of the partition
            # directories: the values live in the AddFile only
            rel_path = (f"{uuid.uuid4().hex[:prefix_len]}/{fname}"
                        if randomize else
                        unquote(partition_path(pv, keyed_columns))
                        + fname)
            status = write_data_file(f"{table_path}/{rel_path}",
                                     chunk, file_schema, engine.fs, mapped)
            adds.append(AddFile(
                path=rel_path,
                partitionValues=dict(pv),
                size=status.size,
                modificationTime=status.modification_time or now_ms,
                dataChange=data_change,
                stats=collect_stats(chunk, schema, configuration,
                                    partition_columns),
            ))
    return adds


def _partition_keys(schema: StructType, partition_columns: Sequence[str],
                    mapped: bool) -> Dict[str, str]:
    """Each partition column's key in `partitionValues` and its directory
    name: the physical name under column mapping."""
    return {c: schema[c].physical_name if mapped else c
            for c in partition_columns}


def write_cdc_files(engine, table_path: str, rows: Batch,
                    schema: StructType, partition_columns: Sequence[str],
                    configuration: Dict[str, str], change_type: str
                    ) -> List[AddCDCFile]:
    """Write `rows` (logical names) as change data of `change_type` under
    `_change_data/` (module docstring); returns the `cdc` actions. A
    schema column the rows lack is written null."""
    if rows.num_rows == 0:
        return []
    partition_columns = list(partition_columns)
    groups = (_partition_groups(rows, partition_columns)
              if partition_columns else [({}, rows)])
    mapped = is_mapped(configuration)
    key = _partition_keys(schema, partition_columns, mapped)
    keyed_columns = [key[c] for c in partition_columns]
    fields = [f for f in schema.fields if f.name not in partition_columns]
    file_schema = StructType(fields + [StructField(CDC_TYPE_COLUMN,
                                                   "string")])
    out: List[AddCDCFile] = []
    for pv, part in groups:
        pv = {key[c]: v for c, v in pv.items()}
        change = np.empty(part.num_rows, object)
        change[:] = change_type
        cols = {f.name: part.columns[f.name] if f.name in part.columns
                else Column.nulls(f.numpy_dtype, part.num_rows,
                                  carried_type(f.data_type))
                for f in fields}
        cols[CDC_TYPE_COLUMN] = Column(change)
        rel_path = (f"{CHANGE_DATA_DIR}/"
                    + unquote(partition_path(pv, keyed_columns))
                    + f"cdc-{uuid.uuid4()}.parquet")
        status = write_data_file(f"{table_path}/{rel_path}",
                                 Batch(cols, part.num_rows), file_schema,
                                 engine.fs, mapped)
        out.append(AddCDCFile(path=rel_path, partitionValues=dict(pv),
                              size=status.size, dataChange=False))
    return out

"""DML: DELETE and UPDATE, by deletion vectors or copy-on-write.

Counterpart of `delta_tpu/commands/dml.py:94-336` (Delta's
`DeleteCommand.scala`, `UpdateCommand.scala` and
`DMLWithDeletionVectorsHelper.scala`):

    from delta_tpu_torch.commands.dml import delete, update
    table = Table.for_path(p, engine=TorchEngine())
    delete(table, predicate=col("k") < lit(10))      # None: every row
    update(table, {"x": lit(0.0), "y": lambda batch: ...},
           predicate=col("k") >= lit(10))

1. The candidates are the files the predicate may match
   (`txn.scan_files(filter=)`: data skipping, K7 on the card; no
   predicate reads the whole table), each read in file order. Their
   deletion vectors are decoded on the engine's device in one batch
   before the loop (one K8 launch on the card), each file sized by its
   `numRecords` statistic, which the protocol requires of a file with a
   DV; a file without it, or whose read disagrees with it, is decoded
   alone after its read (`dml.dv_single_decodes`).
2. Per candidate, the predicate over its visible rows:
   - no row matches: the file stays;
   - DELETE of every visible row: the file is removed;
   - DELETE on a table with `delta.enableDeletionVectors`: the file is
     removed and re-added with a deletion vector of the old and the new
     deleted rows (one `.bin` per command, all its bitmap containers
     packed in one K8 launch on the engine's device);
   - otherwise copy-on-write: the surviving rows (DELETE), or the
     untouched rows then the updated ones (UPDATE), go to a new file,
     and the old one is removed. UPDATE always copies.
3. One commit with the reference's operation parameters and metrics;
   nothing matched commits nothing.

On a table with the change data feed on (`config.py::cdf_enabled`), the
commit also carries the command's change data, one set of files per
change type (`stage_change_data` → `write/writer.py::write_cdc_files`):
DELETE's deleted rows as `delete` in each of its three forms (a file
removed whole, a deletion vector, a copy-on-write rewrite), UPDATE's
matched rows before and after as `update_preimage` and
`update_postimage`. A DELETE with no predicate writes none, as the
reference: its feed is made from its removes (`read/cdc.py`).

On a partitioned table each candidate's rows carry its partition
columns (`read/reader.py`), so a predicate and a SET may name them, and
the rewritten rows go back through the partitioned writer (an UPDATE of
a partition column moves its rows to their new partition); a DELETE
whose predicate matches every row of a file removes it whole.

A SET value is a constant (converted as Arrow converts a Python value to
the column's type), an `Expression` (a column, a literal or a predicate,
cast to the column's type as Arrow's unsafe cast does) or a callable
taking the matched rows as a `Batch` and returning the new values
(an array, a (values, valid) pair or a `Column`), cast the same way;
`expressions/eval.py::cast_values`.

Every rewritten row passes the writer's NOT NULL and CHECK constraints
(`write/writer.py`); a copied row keeps its generated and identity
values, and an updated row's generated columns are computed again where
the SET changes a column they read, and checked where the SET assigns
them (`colgen.py::regenerate_columns`; the reference leaves them stale,
ROADMAP C24). Refused as in the reference: an append-only table
(`AppendOnlyTableError`), an UPDATE of an identity column
(`IdentityColumnError`), a SET of a column the table lacks
(`InvalidArgumentError`). Refused before anything is written
(`UnsupportedTableError`): what `check_write_supported` refuses.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from delta_tpu_torch import obs
from delta_tpu_torch.colgen import is_identity, regenerate_columns
from delta_tpu_torch.config import (
    APPEND_ONLY,
    DELETION_VECTORS_ENABLED,
    cdf_enabled,
    get_table_config,
)
from delta_tpu_torch.dv.descriptor import write_deletion_vector_file
from delta_tpu_torch.dv.roaring import RoaringBitmapArray
from delta_tpu_torch.errors import (
    AppendOnlyTableError,
    IdentityColumnError,
    InvalidArgumentError,
    MissingTransactionLogError,
)
from delta_tpu_torch.expressions.eval import (
    cast_values,
    column_values,
    constant_values,
    evaluate_predicate,
    evaluate_values,
)
from delta_tpu_torch.expressions.tree import Expression
from delta_tpu_torch.models.actions import AddFile
from delta_tpu_torch.models.batch import Batch, Column, as_column
from delta_tpu_torch.models.schema import carried_type, schema_from_json
from delta_tpu_torch.read.reader import (
    deleted_row_mask,
    deleted_row_masks,
    read_add_file_logical,
)
from delta_tpu_torch.txn.transaction import Operation, check_write_supported
from delta_tpu_torch.write.writer import write_cdc_files, write_data_files

_DV_SINGLE = obs.counter("dml.dv_single_decodes")


@dataclass
class DMLMetrics:
    num_files_scanned: int = 0
    num_files_rewritten: int = 0
    num_files_removed_fully: int = 0
    num_dvs_written: int = 0
    num_rows_deleted: int = 0
    num_rows_updated: int = 0
    num_rows_copied: int = 0
    version: Optional[int] = None


def _open(table, operation: str, what: str):
    """The command's transaction, after the reference's refusals."""
    txn = table.create_transaction_builder(operation).build()
    snapshot = txn.read_snapshot
    if snapshot is None:
        raise MissingTransactionLogError(f"no table at {table.path}")
    if get_table_config(snapshot.metadata.configuration, APPEND_ONLY):
        raise AppendOnlyTableError(f"cannot {what} an append-only table")
    return txn, snapshot


def stage_change_data(txn, table, metadata, parts: List[Batch],
                      change_type: str) -> None:
    """Write `parts` (logical rows, each aligned to the table's schema, a
    column it lacks null) as one command's change data of `change_type`
    and stage the files on `txn`; nothing when the table's feed is off or
    no row changed."""
    if not cdf_enabled(metadata.configuration):
        return
    parts = [p for p in parts if p.num_rows]
    if not parts:
        return
    schema = schema_from_json(metadata.schemaString)
    rows = Batch.concat([Batch({
        f.name: p.columns[f.name] if f.name in p.columns
        else Column.nulls(f.numpy_dtype, p.num_rows,
                          carried_type(f.data_type))
        for f in schema.fields}, p.num_rows) for p in parts])
    for cdc in write_cdc_files(table.engine, table.path, rows, schema,
                               metadata.partitionColumns,
                               metadata.configuration, change_type):
        txn.add_cdc_file(cdc)


def _read_physical(table, snapshot, add: AddFile) -> Batch:
    """Every row of the file in file order, partition columns spliced in,
    its deletion vector NOT applied: DML computes row indexes against the
    file's own order."""
    return read_add_file_logical(table.engine, table.path, snapshot.metadata,
                                 add, apply_dv=False)


def _records(add: AddFile) -> Optional[int]:
    """The file's numRecords statistic (None: it has none)."""
    try:
        n = json.loads(add.stats).get("numRecords")
        return None if n is None else int(n)
    except (TypeError, ValueError, AttributeError):
        return None


def _num_records(add: AddFile) -> int:
    return _records(add) or 0


def _presized_masks(table, candidates: List[AddFile]) -> Dict[int, tuple]:
    """{candidate index: (its numRecords, its deleted-row mask)} for the
    candidates with a deletion vector and the statistic, decoded in one
    batch. A statistic outside [0, 2^31) sizes nothing (the log is
    outside input): that file is decoded after its read."""
    sized = [(i, a, _records(a)) for i, a in enumerate(candidates)
             if a.deletionVector is not None]
    sized = [s for s in sized if s[2] is not None and 0 <= s[2] < 1 << 31]
    masks = deleted_row_masks(table.engine, table.path,
                              [a for _, a, _ in sized],
                              [n for _, _, n in sized])
    return {i: (n, m) for (i, _, n), m in zip(sized, masks)}


def _existing_mask(table, presized: Dict[int, tuple], i: int, add: AddFile,
                   num_rows: int):
    """Candidate i's deleted-row mask (None: no DV): the batch's, or its
    own decode when it has no statistic or its rows disagree with it."""
    if add.deletionVector is None:
        return None
    n, mask = presized.get(i, (None, None))
    if n == num_rows:
        return mask
    _DV_SINGLE.inc()
    return deleted_row_mask(table.engine, table.path, add, num_rows)


def delete(table, predicate: Optional[Expression] = None) -> DMLMetrics:
    """DELETE FROM table WHERE predicate (None: every row)."""
    txn, snapshot = _open(table, Operation.DELETE, "DELETE from")
    check_write_supported(snapshot.protocol, snapshot.metadata)
    now_ms = int(time.time() * 1000)
    metrics = DMLMetrics()
    candidates = txn.scan_files(filter=predicate)
    metrics.num_files_scanned = len(candidates)

    if predicate is None:
        for f in candidates:
            txn.remove_file(f.remove(deletion_timestamp=now_ms))
            metrics.num_files_removed_fully += 1
            metrics.num_rows_deleted += _num_records(f)
        txn.set_operation_parameters({"predicate": "true"})
        metrics.version = txn.commit().version
        return metrics

    delete_matching_rows(txn, table, snapshot, predicate, metrics,
                         now_ms=now_ms, candidates=candidates)
    if not txn._adds and not txn._removes:
        return metrics  # nothing matched; no commit
    txn.set_operation_parameters({"predicate": repr(predicate)})
    txn.set_operation_metrics({
        "numDeletedRows": metrics.num_rows_deleted,
        "numRemovedFiles": (metrics.num_files_removed_fully
                            + metrics.num_files_rewritten
                            + metrics.num_dvs_written),
        "numCopiedRows": metrics.num_rows_copied,
        "numDeletionVectorsAdded": metrics.num_dvs_written,
    })
    metrics.version = txn.commit().version
    return metrics


def delete_matching_rows(txn, table, snapshot, predicate: Expression,
                         metrics: DMLMetrics, now_ms: int,
                         candidates: List[AddFile]) -> None:
    """Stage on an open transaction the removal of every row `predicate`
    matches in `candidates`: full removes, deletion vectors or
    copy-on-write rewrites, and the deleted rows' change data."""
    meta = snapshot.metadata
    use_dv = get_table_config(meta.configuration, DELETION_VECTORS_ENABLED)
    schema = schema_from_json(meta.schemaString)
    dv_writes = []
    deleted = []  # the change data, when the table's feed is on
    feed = cdf_enabled(meta.configuration)
    presized = _presized_masks(table, candidates)
    for i, add in enumerate(candidates):
        data = _read_physical(table, snapshot, add)
        existing = _existing_mask(table, presized, i, add, data.num_rows)
        visible = (~existing if existing is not None
                   else np.ones(data.num_rows, dtype=bool))
        matches = evaluate_predicate(predicate, data) & visible
        n_match = int(matches.sum())
        if n_match == 0:
            continue
        metrics.num_rows_deleted += n_match
        if feed:
            deleted.append(data.take(np.nonzero(matches)[0]))
        if n_match == int(visible.sum()):
            txn.remove_file(add.remove(deletion_timestamp=now_ms))
            metrics.num_files_removed_fully += 1
        elif use_dv:
            gone = matches if existing is None else matches | existing
            dv_writes.append((add, np.nonzero(gone)[0].astype(np.uint64)))
        else:
            survivors = data.take(np.nonzero(visible & ~matches)[0])
            metrics.num_rows_copied += survivors.num_rows
            txn.add_files(write_data_files(
                table.engine, table.path, survivors, schema,
                meta.partitionColumns, meta.configuration))
            txn.remove_file(add.remove(deletion_timestamp=now_ms))
            metrics.num_files_rewritten += 1
    stage_change_data(txn, table, meta, deleted, "delete")
    if not dv_writes:
        return
    descriptors = write_deletion_vector_file(
        table.engine, table.path,
        [RoaringBitmapArray(idx) for _, idx in dv_writes])
    for (add, _), desc in zip(dv_writes, descriptors):
        txn.remove_file(add.remove(deletion_timestamp=now_ms))
        new_add = dataclasses.replace(add, deletionVector=desc,
                                      dataChange=True)
        new_add.extra = dict(add.extra)
        txn.add_file(new_add)
        metrics.num_dvs_written += 1


def update(table, assignments: Dict[str, object],
           predicate: Optional[Expression] = None) -> DMLMetrics:
    """UPDATE table SET column = value, ... WHERE predicate (None: every
    row); the values as the module docstring says."""
    txn, snapshot = _open(table, Operation.UPDATE, "UPDATE")
    meta = snapshot.metadata
    schema = schema_from_json(meta.schemaString)
    identity = {f.name for f in schema.fields if is_identity(f)}
    hit = sorted(identity & set(assignments))
    if hit:
        # values are system-allocated; an UPDATE would break uniqueness
        raise IdentityColumnError(
            f"UPDATE on IDENTITY column(s) {hit} is not supported",
            error_class="DELTA_IDENTITY_COLUMNS_UPDATE_NOT_SUPPORTED")
    check_write_supported(snapshot.protocol, meta)
    now_ms = int(time.time() * 1000)
    metrics = DMLMetrics()
    candidates = txn.scan_files(filter=predicate)
    metrics.num_files_scanned = len(candidates)
    before, after = [], []  # the change data, when the feed is on
    feed = cdf_enabled(meta.configuration)
    presized = _presized_masks(table, candidates)
    for i, add in enumerate(candidates):
        data = _read_physical(table, snapshot, add)
        existing = _existing_mask(table, presized, i, add, data.num_rows)
        if existing is not None:
            data = data.take(np.nonzero(~existing)[0])
        matches = (evaluate_predicate(predicate, data)
                   if predicate is not None
                   else np.ones(data.num_rows, dtype=bool))
        n_match = int(matches.sum())
        if n_match == 0:
            continue
        updated = regenerate_columns(_apply_assignments(
            data.take(np.nonzero(matches)[0]), assignments, schema),
            schema, set(assignments))
        untouched = data.take(np.nonzero(~matches)[0])
        if feed:
            before.append(data.take(np.nonzero(matches)[0]))
            after.append(updated)
        metrics.num_rows_updated += n_match
        metrics.num_rows_copied += untouched.num_rows
        txn.add_files(write_data_files(
            table.engine, table.path, Batch.concat([untouched, updated]),
            schema, meta.partitionColumns, meta.configuration))
        txn.remove_file(add.remove(deletion_timestamp=now_ms))
        metrics.num_files_rewritten += 1
    if not txn._adds and not txn._removes:
        return metrics
    stage_change_data(txn, table, meta, before, "update_preimage")
    stage_change_data(txn, table, meta, after, "update_postimage")
    txn.set_operation_parameters(
        {"predicate": repr(predicate) if predicate is not None else "true"})
    txn.set_operation_metrics({
        "numUpdatedRows": metrics.num_rows_updated,
        "numCopiedRows": metrics.num_rows_copied,
        "numRemovedFiles": metrics.num_files_rewritten,
    })
    metrics.version = txn.commit().version
    return metrics


def _apply_assignments(matched: Batch, assignments: Dict[str, object],
                       schema) -> Batch:
    """The matched rows with each SET applied in order (a later value sees
    the earlier ones)."""
    out = matched
    for name, value in assignments.items():
        if name not in out.columns:
            raise InvalidArgumentError(f"unknown column in SET: {name}",
                                       error_class="DELTA_MISSING_SET_COLUMN")
        t = schema[name].data_type
        if isinstance(value, Expression):
            values, valid = cast_values(evaluate_values(value, out), t)
        elif callable(value):
            c = as_column(value(out))
            values, valid = cast_values(
                column_values(c.values, c.valid, c.data_type), t)
        else:
            values, valid = constant_values(value, t, out.num_rows)
        cols = dict(out.columns)
        cols[name] = Column(values, None if valid.all() else valid,
                            carried_type(t))
        out = Batch(cols, out.num_rows)
    return out

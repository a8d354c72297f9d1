"""REORG TABLE ... APPLY (PURGE): rewrite the files that carry deletion
vectors into files without the rows those delete.

Counterpart of `delta_tpu/commands/reorg.py:26-121`
(`DeltaReorgTableCommand.scala` in Delta): REORG is OPTIMIZE with a
file-selection rule instead of a size threshold.

    reorg_purge(Table.for_path(p, engine=TorchEngine()))
    reorg_rewrite_all(table)   # every live file (the upgrade variant)

A SnapshotIsolation transaction scans every live file and keeps those the
rule picks; they are read together (`read_add_files_logical`: every DV
decoded in one batch, one K8 launch on the card) and each is written back
on its own (`write_data_files`: physical names on a column-mapped table,
its partition kept). Every remove and add is dataChange=false; the commit
is an `OPTIMIZE` with `applyPurge` and the four file and byte metrics,
and returns `OptimizeMetrics` (with the phases' wall seconds: snapshot,
scan, read, write, commit). No file picked: no commit. The UniForm
upgrade (`reorg_upgrade_uniform`) is not ported (A24).
"""

from __future__ import annotations

import time
from typing import Callable, List

from delta_tpu_torch.commands.optimize import OptimizeMetrics
from delta_tpu_torch.errors import MissingTransactionLogError
from delta_tpu_torch.models.actions import AddFile
from delta_tpu_torch.models.schema import schema_from_json
from delta_tpu_torch.obs import PhaseTimer
from delta_tpu_torch.read.reader import read_add_files_logical
from delta_tpu_torch.txn.isolation import IsolationLevel
from delta_tpu_torch.txn.transaction import Operation, check_write_supported
from delta_tpu_torch.write.writer import write_data_files


def reorg_purge(table) -> OptimizeMetrics:
    """Rewrite every file that has a deletion vector, dropping its
    deleted rows for good (REORG ... APPLY (PURGE))."""
    return _reorg(table, lambda f: f.deletionVector is not None, True)


def reorg_rewrite_all(table) -> OptimizeMetrics:
    """Rewrite every live file (the upgrade variant: a physical layout
    change carried to all files)."""
    return _reorg(table, lambda f: True, False)


def _reorg(table, selector: Callable[[AddFile], bool],
           purge: bool) -> OptimizeMetrics:
    mark = PhaseTimer(table.engine.synchronize)
    txn = table.create_transaction_builder(Operation.OPTIMIZE).build()
    txn.isolation = IsolationLevel.SNAPSHOT_ISOLATION
    snapshot = txn.read_snapshot
    if snapshot is None:
        raise MissingTransactionLogError(f"no table at {table.path}")
    meta = snapshot.metadata
    check_write_supported(snapshot.protocol, meta)
    mark("snapshot")
    targets = [f for f in txn.scan_files() if selector(f)]
    mark("scan")
    metrics = OptimizeMetrics(phase_seconds=mark.seconds)
    if not targets:
        return metrics

    batches = read_add_files_logical(table.engine, table.path, meta, targets)
    mark("read")
    schema = schema_from_json(meta.schemaString)
    now_ms = int(time.time() * 1000)
    new_adds: List[AddFile] = []
    for f, data in zip(targets, batches):
        if data.num_rows:
            new_adds += write_data_files(
                table.engine, table.path, data, schema, meta.partitionColumns,
                meta.configuration, data_change=False)
        txn.remove_file(f.remove(deletion_timestamp=now_ms, data_change=False))
    mark("write")
    txn.add_files(new_adds)
    metrics.num_files_removed = len(targets)
    metrics.bytes_removed = sum(f.size for f in targets)
    metrics.num_files_added = len(new_adds)
    metrics.bytes_added = sum(a.size for a in new_adds)
    txn.set_operation_parameters({"applyPurge": purge})
    txn.set_operation_metrics({
        "numAddedFiles": metrics.num_files_added,
        "numRemovedFiles": metrics.num_files_removed,
        "numAddedBytes": metrics.bytes_added,
        "numRemovedBytes": metrics.bytes_removed,
    })
    metrics.version = txn.commit().version
    mark("commit")
    return metrics

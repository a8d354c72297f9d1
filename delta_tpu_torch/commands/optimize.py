"""OPTIMIZE: bin-packing compaction and Z-order / Hilbert clustering.

Counterpart of `delta_tpu/commands/optimize.py:30-368`
(`OptimizeTableCommand.scala:251-427` and
`MultiDimClustering.scala:41-69` in Delta):

    Table.for_path(p, engine=TorchEngine()).optimize()
        .execute_zorder_by("k1", "k2", "k3", curve="zorder" | "hilbert")
    Table.for_path(p, engine=TorchEngine()).optimize()
        .execute_compaction(min_file_size=..., max_file_size=...)
    Table.for_path(p, engine=TorchEngine()).optimize()
        .where(col("k") < lit(10)).execute_compaction()

A SnapshotIsolation transaction reads every live file, or with
`where(predicate)` the files the predicate may match
(`txn.scan_files(filter=)`: partition pruning and data skipping, the
predicate recorded for the conflict check and in the commit's
`predicate` operation parameter). The files are grouped by their
partition values (bins never span partitions; `partitions_optimized`
counts the partitions that got a bin). Within a partition, compaction
packs the files under `min_file_size` into bins of at most
`max_file_size` bytes (`bin_pack_by_size`) and rewrites each bin of two
or more; Z-order rewrites every file of the partition as one bin, its
rows ordered along the curve by `ops/zorder.py` on the engine's device
(kernel K4 on the card, one launch per partition). A bin
becomes ceil(sum of its file sizes / max_file_size) files of equal row
counts; the removes carry dataChange=false; every add of an explicit
Z-order carries one set of ZCube tags per command. A bin's files are
read with their deletion vectors applied (decoded on the engine's
device, K8 on the card), so the rows they delete are purged: the new
files carry none, and the removes carry the old descriptors.

A clustered table raises `UnsupportedTableError`; a predicate on a
clustered table raises `OptimizeArgumentError`
(DELTA_CLUSTERING_WITH_PARTITION_PREDICATE), as in the reference,
before that. A column-mapped table optimizes as any other: the rewritten
files hold the physical names. A `where` predicate naming a column the
table lacks raises `NonExistentColumnError`. `OptimizeMetrics` also carries `phase_seconds`, the wall
seconds of the command's phases: snapshot, scan, read, keys, the curve
permutation's h2d, rank, interleave, sort and d2h, take, write, commit.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from delta_tpu_torch.clustering import clustering_columns, new_zcube_tags
from delta_tpu_torch.obs import PhaseTimer
from delta_tpu_torch.errors import (
    InvalidArgumentError,
    OptimizeArgumentError,
    UnsupportedTableError,
)
from delta_tpu_torch.expressions.tree import Expression
from delta_tpu_torch.models.actions import AddFile
from delta_tpu_torch.models.batch import Batch
from delta_tpu_torch.models.schema import schema_from_json
from delta_tpu_torch.ops.zorder import zorder_sort_indices
from delta_tpu_torch.read.reader import read_add_files_logical
from delta_tpu_torch.stats.collection import stats_columns
from delta_tpu_torch.txn.isolation import IsolationLevel
from delta_tpu_torch.txn.transaction import Operation, check_write_supported
from delta_tpu_torch.write.writer import write_data_files

DEFAULT_MIN_FILE_SIZE = 256 * 1024 * 1024   # files below this are compacted
DEFAULT_MAX_FILE_SIZE = 256 * 1024 * 1024   # bin capacity


@dataclass
class OptimizeMetrics:
    num_files_added: int = 0
    num_files_removed: int = 0
    bytes_added: int = 0
    bytes_removed: int = 0
    num_bins: int = 0
    num_batches: int = 1
    partitions_optimized: int = 0
    version: Optional[int] = None
    phase_seconds: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return dict(self.__dict__)


def bin_pack_by_size(files: Sequence[AddFile],
                     max_bin_size: int) -> List[List[AddFile]]:
    """Sort ascending by size and accumulate until a bin would overflow
    (`BinPackingUtils.binPackBySize`)."""
    bins: List[List[AddFile]] = []
    cur: List[AddFile] = []
    cur_size = 0
    for f in sorted(files, key=lambda f: f.size):
        if cur and cur_size + f.size > max_bin_size:
            bins.append(cur)
            cur, cur_size = [], 0
        cur.append(f)
        cur_size += f.size
    if cur:
        bins.append(cur)
    return bins


class OptimizeBuilder:
    """`table.optimize().execute_compaction()` /
    `.execute_zorder_by("c1", "c2")`."""

    def __init__(self, table):
        self._table = table
        self._filter = None

    def where(self, predicate) -> "OptimizeBuilder":
        """Optimize only the files `predicate` may match (None: all)."""
        if predicate is not None and not isinstance(predicate, Expression):
            raise InvalidArgumentError(
                f"OPTIMIZE ... WHERE takes an expression, got "
                f"{type(predicate).__name__}")
        self._filter = predicate
        return self

    def execute_compaction(self, min_file_size: int = DEFAULT_MIN_FILE_SIZE,
                           max_file_size: int = DEFAULT_MAX_FILE_SIZE,
                           ) -> OptimizeMetrics:
        return _run_optimize(self._table, None, max_file_size, min_file_size,
                             filter=self._filter)

    def execute_zorder_by(self, *columns: str, curve: str = "zorder",
                          max_file_size: int = DEFAULT_MAX_FILE_SIZE,
                          ) -> OptimizeMetrics:
        if not columns:
            raise OptimizeArgumentError(
                "ZORDER BY requires at least one column",
                error_class="DELTA_ZORDER_REQUIRES_COLUMN")
        return _run_optimize(self._table, list(columns), max_file_size,
                             None, curve, filter=self._filter)


def _run_optimize(table, zorder_by: Optional[List[str]], max_file_size: int,
                  min_file_size: Optional[int], curve: str = "zorder",
                  filter=None) -> OptimizeMetrics:
    mark = PhaseTimer(table.engine.synchronize)
    txn = table.create_transaction_builder(Operation.OPTIMIZE).build()
    txn.isolation = IsolationLevel.SNAPSHOT_ISOLATION
    state = txn.read_snapshot.state
    meta = state.metadata
    if clustering_columns(state):
        if zorder_by is None and filter is not None:
            # clustered tables cluster the whole table, never a slice
            # (`DeltaErrors.clusteringWithPartitionPredicatesException`)
            raise OptimizeArgumentError(
                "predicates are not supported when optimizing a clustered "
                "table",
                error_class="DELTA_CLUSTERING_WITH_PARTITION_PREDICATE")
        raise UnsupportedTableError(
            "OPTIMIZE of a clustered table is not supported yet",
            feature="clustered table")
    check_write_supported(state.protocol, meta)
    schema = schema_from_json(meta.schemaString)
    mark("snapshot")

    if zorder_by:
        indexed = {".".join(p) for p in stats_columns(
            schema, meta.configuration, meta.partitionColumns)}
        for c in zorder_by:
            if c in meta.partitionColumns:
                raise OptimizeArgumentError(
                    f"cannot Z-order by partition column {c}",
                    error_class="DELTA_ZORDERING_ON_PARTITION_COLUMN")
            if c not in schema:
                raise OptimizeArgumentError(
                    f"Z-order column {c} not in schema",
                    error_class="DELTA_ZORDERING_COLUMN_DOES_NOT_EXIST")
            if c not in indexed:
                raise OptimizeArgumentError(
                    f"Z-ordering on {c} will be ineffective: no file "
                    "statistics are collected for it (see "
                    "delta.dataSkippingStatsColumns / "
                    "delta.dataSkippingNumIndexedCols)",
                    error_class="DELTA_ZORDERING_ON_COLUMN_WITHOUT_STATS")

    files = txn.scan_files(filter=filter)
    mark("scan")
    metrics = OptimizeMetrics(phase_seconds=mark.seconds)
    tags = new_zcube_tags(zorder_by, curve) if zorder_by else None
    by_partition: Dict[tuple, List[AddFile]] = {}
    for f in files:
        key = tuple(sorted((f.partitionValues or {}).items()))
        by_partition.setdefault(key, []).append(f)

    now_ms = int(time.time() * 1000)
    new_adds: List[AddFile] = []
    removed: List[AddFile] = []
    # partitions in the reference's order, the null value first
    for _, part_files in sorted(by_partition.items(), key=lambda kv: [
            (k, v is not None, v or "") for k, v in kv[0]]):
        if zorder_by is None:
            small = [f for f in part_files if f.size < min_file_size]
            bins = [b for b in bin_pack_by_size(small, max_file_size)
                    if len(b) > 1]
        else:
            bins = [part_files]
        for bin_files in bins:
            adds = _rewrite_bin(table, meta, schema, bin_files, zorder_by,
                                curve, max_file_size, mark)
            if tags is not None:
                adds = [dataclasses.replace(
                    a, tags={**(a.tags or {}), **tags}) for a in adds]
            new_adds.extend(adds)
            removed.extend(bin_files)
            metrics.num_bins += 1
        if bins:
            metrics.partitions_optimized += 1
    if not removed:
        return metrics  # nothing to do; no commit

    for f in removed:
        txn.remove_file(f.remove(deletion_timestamp=now_ms, data_change=False))
    txn.add_files(new_adds)
    txn.set_operation_parameters({
        "predicate": repr(filter) if filter is not None else "[]",
        "zOrderBy": list(zorder_by) if zorder_by else [],
        "clusterBy": [],
        "auto": False,
    })
    metrics.num_files_added = len(new_adds)
    metrics.num_files_removed = len(removed)
    metrics.bytes_added = sum(a.size for a in new_adds)
    metrics.bytes_removed = sum(r.size for r in removed)
    txn.set_operation_metrics({
        "numAddedFiles": metrics.num_files_added,
        "numRemovedFiles": metrics.num_files_removed,
        "numAddedBytes": metrics.bytes_added,
        "numRemovedBytes": metrics.bytes_removed,
    })
    metrics.version = txn.commit().version
    mark("commit")
    return metrics


def _rewrite_bin(table, meta, schema, bin_files: List[AddFile],
                 zorder_by: Optional[List[str]], curve: str,
                 max_file_size: int, mark) -> List[AddFile]:
    """Read the bin's rows, order them along the curve (Z-order), and
    write them back as ceil(bin bytes / max_file_size) files."""
    engine = table.engine
    data = Batch.concat(read_add_files_logical(engine, table.path, meta,
                                               bin_files))
    mark("read")
    if zorder_by:
        cols = []
        for c in zorder_by:
            col = data.column(c)
            a = col.values  # null rows hold 0 / "" / b"" already
            if a.dtype == object and col.data_type is None:
                a = a.astype(str)
            # a decimal ranks by its value (int64 lanes, or Python ints)
            # and binary by its bytes: Spark's order, not the
            # reference's text order (ROADMAP C13)
            cols.append(a)
        perm = zorder_sort_indices(cols, curve=curve, device=engine.device,
                                   mark=mark)
        data = data.take(perm)
        mark("take")
    total_bytes = sum(f.size for f in bin_files)
    n_out = max(1, -(-total_bytes // max_file_size))
    rows_per_file = max(1, -(-data.num_rows // n_out))
    adds = write_data_files(
        engine, table.path, data, schema, meta.partitionColumns,
        meta.configuration, data_change=False,
        target_rows_per_file=rows_per_file if n_out > 1 else None)
    mark("write")
    return adds

"""RESTORE TABLE ... TO VERSION/TIMESTAMP AS OF, and CLONE.

Counterpart of `delta_tpu/commands/restore.py:35-186`
(`RestoreTableCommand.scala`, `CloneTableBase.scala` in Delta):

- `restore(table, version=... | timestamp_ms=..., force=False)`: the
  target snapshot's files against the current one's, keyed by (path, DV
  unique id): the target's files the table lacks come back as adds
  (dataChange=true), the table's files the target lacks go as removes,
  and the target's metadata is committed where it differs. A file to
  bring back that is gone (VACUUM deleted it) refuses the restore
  (DELTA_RESTORE_MISSING_DATA_FILE) unless `force`. A timestamp before
  the first commit or after the last raises
  DELTA_CANNOT_RESTORE_TIMESTAMP_EARLIER / _GREATER.
- `clone(source, dest_path, shallow=True, properties=None)`: a new table
  at `dest_path` (which must not hold a table, nor any file) with the
  source's schema, partitioning and properties (plus `properties`), and
  its live files. A shallow clone's adds name the source's files by
  absolute path, and a 'u' deletion vector becomes a 'p' descriptor of
  the source's DV file (C21: the reference keeps the 'u' descriptor,
  which then resolves under the clone's root, where no such file is). A
  deep clone copies each data file and 'u' DV file under the clone's
  root (a file named by an absolute path gets a fresh unique name).
- `convert_to_delta(path, partition_schema=None)`
  (`ConvertToDeltaCommand.scala`): a directory of Parquet files, Hive
  partitioned or not, becomes a Delta table in place with one CONVERT
  commit (version 0). The schema is the first file's footer's
  (`stats/footer.py::footer_schema`) with the partition columns added;
  each file's stats come from its footer (`footer_stats`), read on a
  small thread pool. `__HIVE_DEFAULT_PARTITION__` is a null partition
  value, the others are percent-decoded.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional
from urllib.parse import unquote

from delta_tpu_torch.dv.descriptor import absolute_dv_path
from delta_tpu_torch.errors import (
    CloneTargetExistsError,
    ConvertTargetError,
    InvalidArgumentError,
    RestoreTargetError,
    TimestampEarlierThanCommitRetentionError,
    TimestampLaterThanLatestCommitError,
)
from delta_tpu_torch.models.actions import AddFile, DeletionVectorDescriptor
from delta_tpu_torch.models.schema import (
    StructField,
    StructType,
    _primitive,
    schema_from_json,
)
from delta_tpu_torch.read.reader import absolute_path
from delta_tpu_torch.table import Table
from delta_tpu_torch.txn.transaction import Operation


@dataclass
class RestoreMetrics:
    num_restored_files: int = 0
    num_removed_files: int = 0
    version: Optional[int] = None


def _target_snapshot(table, version: Optional[int],
                     timestamp_ms: Optional[int]):
    if (version is None) == (timestamp_ms is None):
        raise RestoreTargetError(
            "restore requires exactly one of version / timestamp",
            error_class="DELTA_ONEOF_IN_TIMETRAVEL")
    if version is not None:
        return table.snapshot_at(version)
    try:
        return table.snapshot_as_of_timestamp(timestamp_ms)
    except TimestampEarlierThanCommitRetentionError as e:
        raise RestoreTargetError(
            f"cannot restore table to timestamp {timestamp_ms}: it is before "
            f"the earliest available version ({e})",
            error_class="DELTA_CANNOT_RESTORE_TIMESTAMP_EARLIER") from e
    except TimestampLaterThanLatestCommitError as e:
        raise RestoreTargetError(
            f"cannot restore table to timestamp {timestamp_ms}: it is after "
            f"the latest available version ({e})",
            error_class="DELTA_CANNOT_RESTORE_TIMESTAMP_GREATER") from e


def restore(table, version: Optional[int] = None,
            timestamp_ms: Optional[int] = None,
            force: bool = False) -> RestoreMetrics:
    target = _target_snapshot(table, version, timestamp_ms)
    current = table.latest_snapshot()
    now_ms = int(time.time() * 1000)
    target_adds = target.state.add_files
    cur_adds = current.state.add_files
    cur_keys = {(a.path, a.dv_unique_id) for a in cur_adds}
    target_keys = {(a.path, a.dv_unique_id) for a in target_adds}
    to_add = [a for a in target_adds if (a.path, a.dv_unique_id)
              not in cur_keys]
    to_remove = [a for a in cur_adds if (a.path, a.dv_unique_id)
                 not in target_keys]
    if not force:
        for a in to_add:
            if not os.path.exists(absolute_path(table.path, a.path)):
                raise RestoreTargetError(
                    f"cannot restore: data file {a.path} was removed "
                    "(probably by VACUUM); use force=True to restore anyway",
                    error_class="DELTA_RESTORE_MISSING_DATA_FILE")

    txn = table.create_transaction_builder(Operation.RESTORE).build()
    for a in to_add:
        txn.add_file(dataclasses.replace(a, dataChange=True))
    for a in to_remove:
        txn.remove_file(a.remove(deletion_timestamp=now_ms))
    if target.metadata.to_dict() != current.metadata.to_dict():
        txn.update_metadata(target.metadata)
    txn.set_operation_parameters({"version": version,
                                  "timestamp": timestamp_ms})
    txn.set_operation_metrics({"numRestoredFiles": len(to_add),
                               "numRemovedFiles": len(to_remove)})
    return RestoreMetrics(len(to_add), len(to_remove), txn.commit().version)


def _source_dv(src_root: str, dv: DeletionVectorDescriptor
               ) -> DeletionVectorDescriptor:
    """A 'u' descriptor as a 'p' one naming the source's DV file."""
    return dataclasses.replace(dv, storageType="p", pathOrInlineDv=(
        absolute_dv_path(src_root, dv.to_dict())))


def clone(source_table, dest_path: str, shallow: bool = True,
          properties: Optional[Dict[str, str]] = None) -> int:
    """CLONE (shallow or deep); returns the clone's commit version."""
    snap = source_table.latest_snapshot()
    dest = Table.for_path(dest_path, source_table.engine)
    if dest.exists():
        raise CloneTargetExistsError(
            f"clone destination {dest_path} already exists")
    if os.path.isdir(dest_path) and os.listdir(dest_path):
        # foreign files would mix into the clone's data
        # (`DeltaErrors.cloneOnNonEmptyTarget`)
        raise CloneTargetExistsError(
            f"clone destination {dest_path} is a non-empty directory; CLONE "
            "requires an empty or nonexistent target",
            error_class="DELTA_UNSUPPORTED_NON_EMPTY_CLONE")
    meta = snap.metadata
    txn = (dest.create_transaction_builder(Operation.CLONE)
           .with_schema(schema_from_json(meta.schemaString))
           .with_partition_columns(meta.partitionColumns)
           .with_table_properties({**meta.configuration,
                                   **(properties or {})})
           .build())
    src_root = source_table.path
    fs = source_table.engine.fs
    used: set = set()
    copied_dvs: set = set()
    for i, a in enumerate(snap.state.add_files):
        src = absolute_path(src_root, a.path)
        dv = a.deletionVector
        if shallow:
            if dv is not None and dv.storageType == "u":
                dv = _source_dv(src_root, dv)
            txn.add_file(dataclasses.replace(a, path=src, dataChange=True,
                                             deletionVector=dv))
            continue
        # a name from another root may collide with one of this root's
        rel = a.path if (src != a.path and a.path not in used) else \
            f"part-{i:05d}-{a.path.rsplit('/', 1)[-1]}"
        used.add(rel)
        fs.write(f"{dest.path}/{rel}", fs.read_file(src))
        if dv is not None and dv.storageType == "u":
            # a 'u' DV file resolves under the root: copy it along
            row = dv.to_dict()
            src_dv = absolute_dv_path(src_root, row)
            if src_dv not in copied_dvs:
                copied_dvs.add(src_dv)
                fs.write(absolute_dv_path(dest.path, row),
                         fs.read_file(src_dv))
        txn.add_file(dataclasses.replace(a, path=rel, dataChange=True))
    txn.set_operation_parameters({"source": src_root,
                                  "sourceVersion": snap.version,
                                  "isShallow": shallow})
    return txn.commit().version


_FOOTER_WORKERS = 8
_HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _parquet_manifest(root: str, part_cols: List[str]) -> List[tuple]:
    """(absolute path, relative path, partition values) of every Parquet
    data file under `root`, in `os.walk` order; hidden files and
    directories and the log are skipped."""
    manifest = []
    for dirpath, dirs, files in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        if rel_dir.startswith("_delta_log"):
            continue
        dirs[:] = [d for d in dirs if not d.startswith((".", "_"))]
        pv: Dict[str, Optional[str]] = {}
        if rel_dir != ".":
            for part in rel_dir.split(os.sep):
                if "=" in part:
                    k, _, v = part.partition("=")
                    pv[k] = None if v == _HIVE_NULL else unquote(v)
        for fname in files:
            if not fname.endswith(".parquet") or fname.startswith((".", "_")):
                continue
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            missing = [k for k in part_cols if k not in pv]
            if missing:
                raise ConvertTargetError(
                    f"file {rel} lacks partition values for {missing}",
                    error_class="DELTA_CONVERSION_NO_PARTITION_FOUND")
            manifest.append((full, rel, {k: pv.get(k) for k in part_cols}))
    return manifest


def convert_to_delta(path: str,
                     partition_schema: Optional[Dict[str, str]] = None,
                     engine=None) -> int:
    """CONVERT TO DELTA of the Parquet files under `path` (partition
    column -> type in `partition_schema`); returns the commit version."""
    from delta_tpu_torch.log.parquet_footer import (
        DecodeCorrupt,
        DecodeUnsupported,
    )
    from delta_tpu_torch.stats.footer import (
        footer_schema,
        footer_stats,
        read_file_footer,
    )

    table = Table.for_path(path, engine)
    if table.exists():
        raise ConvertTargetError(
            f"{path} is already a Delta table",
            error_class="DELTA_CONVERT_TARGET_ALREADY_DELTA")
    part_schema = partition_schema or {}
    part_cols = list(part_schema)
    manifest = _parquet_manifest(table.path, part_cols)
    if not manifest:
        raise ConvertTargetError(f"no parquet files found under {path}")
    schema = footer_schema(read_file_footer(manifest[0][0]))
    for col_name, type_name in part_schema.items():
        if col_name not in schema:
            if not _primitive(type_name):
                raise InvalidArgumentError(
                    f"unknown primitive type: {type_name}",
                    error_class="DELTA_PARSING_UNSUPPORTED_DATA_TYPE")
            schema = StructType(schema.fields
                                + [StructField(col_name, type_name)])

    def to_add(entry: tuple) -> AddFile:
        full, rel, pvals = entry
        st = os.stat(full)
        try:
            stats = footer_stats(read_file_footer(full), schema, {},
                                 part_cols)
        except (OSError, DecodeCorrupt, DecodeUnsupported):
            stats = None  # converted without stats, as the reference
        return AddFile(path=rel, partitionValues=pvals, size=st.st_size,
                       modificationTime=int(st.st_mtime * 1000),
                       dataChange=True, stats=stats)

    with ThreadPoolExecutor(min(_FOOTER_WORKERS, len(manifest))) as pool:
        adds = list(pool.map(to_add, manifest))
    txn = (table.create_transaction_builder(Operation.CONVERT)
           .with_schema(schema).with_partition_columns(part_cols).build())
    txn.add_files(adds)
    txn.set_operation_parameters({"numFiles": len(adds),
                                  "partitionedBy": part_cols})
    return txn.commit().version

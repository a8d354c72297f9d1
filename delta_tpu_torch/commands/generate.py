"""GENERATE symlink_format_manifest: manifests of the table's live data
files that Hive, Presto or Athena read.

Counterpart of `delta_tpu/commands/generate.py`
(`DeltaGenerateCommand.scala`, `hooks/GenerateSymlinkManifest.scala`):
`generate_symlink_manifest` writes one text file per live partition under
`_symlink_format_manifest/` (`<partition dirs>/manifest`), each line the
absolute path of one of its data files, sorted, and deletes the manifests
of partitions that hold no file any more. With
`delta.compatibility.symlinkFormatManifest.enabled`, the post-commit hook
`incremental_symlink_manifest_hook` (`hooks.py`) rewrites only the
partitions a commit touched.

A symlink manifest cannot express a deletion vector (an external engine
would read the deleted rows) nor column mapping's physical names, so
both refuse such a table (DELTA_GENERATE_WITH_DELETION_VECTORS,
DELTA_GENERATE_WITH_COLUMN_MAPPING), as the reference does.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from delta_tpu_torch.columnmapping import mapping_mode
from delta_tpu_torch.errors import InvalidArgumentError
from delta_tpu_torch.read.reader import absolute_path
from delta_tpu_torch.stats.partition import partition_path

MANIFEST_DIR = "_symlink_format_manifest"
MANIFEST_NAME = "manifest"


def _manifest_location(table_path: str, pv: Dict[str, Optional[str]],
                       partition_columns: List[str]) -> str:
    rel = partition_path(pv, partition_columns).rstrip("/")
    base = f"{table_path}/{MANIFEST_DIR}"
    return f"{base}/{rel}/{MANIFEST_NAME}" if rel else f"{base}/{MANIFEST_NAME}"


def _groups(table, snapshot, keep=None) -> Dict[Tuple, List[str]]:
    """Partition key -> the absolute paths of its live files (only the
    keys in `keep`, when given)."""
    files = snapshot.scan().files()
    _check_no_dvs(files)
    part_cols = snapshot.partition_columns
    groups: Dict[Tuple, List[str]] = {k: [] for k in keep or ()}
    for f in files:
        pv = f.partitionValues or {}
        key = tuple(pv.get(c) for c in part_cols)
        if keep is None or key in keep:
            groups.setdefault(key, []).append(absolute_path(table.path,
                                                            f.path))
    return groups


def generate_symlink_manifest(table) -> Dict[str, int]:
    """Every live partition's manifest written, stale ones deleted;
    returns {manifest path: its file count}."""
    snapshot = table.latest_snapshot()
    _check_compatible(snapshot)
    groups = _groups(table, snapshot)
    written = _write_manifests(table, snapshot.partition_columns, groups)
    _delete_stale_manifests(table, keep=set(written))
    return written


def incremental_symlink_manifest_hook(table, txn, version: int, metadata,
                                      snapshot) -> None:
    """After a commit: rewrite the manifests of the partitions the commit
    added or removed files in (`snapshot` is the committed version's),
    and delete those of partitions left empty."""
    touched_pvs = [a.partitionValues or {} for a in txn._adds]
    touched_pvs += [r.partitionValues or {} for r in txn._removes]
    if not touched_pvs:
        return
    _check_compatible(snapshot)
    part_cols = snapshot.partition_columns
    touched: Set[Tuple] = {tuple(pv.get(c) for c in part_cols)
                           for pv in touched_pvs}
    groups = _groups(table, snapshot, keep=touched)
    live = {k: v for k, v in groups.items() if v}
    _write_manifests(table, part_cols, live)
    for key in touched - set(live):
        loc = _manifest_location(table.path, dict(zip(part_cols, key)),
                                 part_cols)
        try:
            table.engine.fs.delete(loc)
        except FileNotFoundError:
            pass


def _check_compatible(snapshot) -> None:
    if mapping_mode(snapshot.metadata.configuration) != "none":
        raise InvalidArgumentError(
            "symlink manifests are not supported on column-mapped tables",
            error_class="DELTA_GENERATE_WITH_COLUMN_MAPPING")


def _check_no_dvs(files: Iterable) -> None:
    n = sum(1 for f in files if f.deletionVector is not None)
    if n:
        raise InvalidArgumentError(
            f"cannot generate symlink manifests: {n} live file(s) carry "
            "deletion vectors (external engines would see deleted rows); "
            "run REORG TABLE ... APPLY (PURGE) first",
            error_class="DELTA_GENERATE_WITH_DELETION_VECTORS")


def _write_manifests(table, part_cols: List[str],
                     groups: Dict[Tuple, List[str]]) -> Dict[str, int]:
    written: Dict[str, int] = {}
    for key, paths in sorted(groups.items(), key=lambda kv: str(kv[0])):
        loc = _manifest_location(table.path, dict(zip(part_cols, key)),
                                 part_cols)
        table.engine.fs.write(loc, ("\n".join(sorted(paths)) + "\n")
                              .encode(), overwrite=True)
        written[loc] = len(paths)
    return written


def _delete_stale_manifests(table, keep: Set[str]) -> None:
    root = f"{table.path}/{MANIFEST_DIR}"
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = f"{dirpath}/{name}"
            if name == MANIFEST_NAME and path not in keep:
                try:
                    table.engine.fs.delete(path)
                except FileNotFoundError:
                    pass

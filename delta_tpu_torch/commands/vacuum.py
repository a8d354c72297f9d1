"""VACUUM: delete the data files a table no longer references, once they
are past the retention window.

Counterpart of `delta_tpu/commands/vacuum.py` (`VacuumCommand.scala:59,
224` in Delta):

    Table.for_path(p, engine=TorchEngine()).vacuum(
        retention_hours=None, dry_run=False, inventory=None,
        vacuum_type="FULL" | "LITE")

The protected set holds the latest snapshot's live files, the DV files
they reference, and the tombstones whose deletionTimestamp is inside the
window. It is built from the rows the live and tombstone masks pick on
the engine's device (`SnapshotState.file_refs`: each row's path, deletion
timestamp and DV descriptor from the row store, no action built). A path
is the log's path decoded once (C7), which on this package's tables is
the path on disk. Paths outside the table root (absolute, `://`: a
shallow clone's) are never protected nor deleted.

Three candidate sources, as in the reference:
- FULL (default): a walk of the table directory, top-level hidden
  directories (`_`/`.`, `_delta_log` among them) but `_change_data` left
  out, hidden file names skipped at every depth;
- an inventory: rows of (path, length, isDir, modificationTime) the
  caller supplies, as a `Batch` or a mapping of column name to sequence
  (the reference takes an Arrow table or a data frame);
- LITE: the RemoveFile tombstones (and their 'u' DV files) and CDC files
  of the commits after the `_delta_log/_last_vacuum_info` watermark, up
  to the newest commit outside the window, read through the package's
  own commit parse (K1 on the card); a candidate's age is its
  deletionTimestamp (0 for a CDC file). Untracked files survive LITE.

A candidate is deleted when it is not protected and its mtime (ms) is
before `now - retention`. Deletes run in a thread pool. A real FULL or
LITE run advances the watermark (never back), except a FULL run that
left a file whose tombstone expired but whose mtime is too young;
an inventory run leaves it. The retention check refuses only a negative
retention, as the reference's does (Delta refuses anything under
`delta.deletedFileRetentionDuration` while its check is on; ROADMAP's
reference caveats). `VacuumResult.phase_seconds` holds the wall seconds
of the load, the protected set, the walk (or the inventory or LITE's
range scan), the selection, the deletes and the watermark.
"""

from __future__ import annotations

import json
import logging
import math
import os
import posixpath
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from delta_tpu_torch.config import TOMBSTONE_RETENTION, get_table_config
from delta_tpu_torch.dv.descriptor import absolute_dv_path
from delta_tpu_torch.errors import (
    InvalidArgumentError,
    TimestampEarlierThanCommitRetentionError,
    VacuumLiteError,
    VacuumRetentionError,
)
from delta_tpu_torch.history import version_at_timestamp
from delta_tpu_torch.models.actions import decode_path
from delta_tpu_torch.models.batch import Batch
from delta_tpu_torch.obs import PhaseTimer
from delta_tpu_torch.replay.columnar import (
    _parse_commit_buffer,
    _read_commits_buffer,
)
from delta_tpu_torch.utils import filenames

_log = logging.getLogger(__name__)

INVENTORY_COLUMNS = ("path", "length", "isDir", "modificationTime")
LAST_VACUUM_INFO = "_last_vacuum_info"
_WATERMARK_KEY = "latestCommitVersionOutsideOfRetentionWindow"
_UNLINK_WORKERS = 16


@dataclass
class VacuumResult:
    files_deleted: List[str] = field(default_factory=list)
    dry_run: bool = False
    type_of_vacuum: str = "FULL"
    eligible_start_commit_version: Optional[int] = None
    eligible_end_commit_version: Optional[int] = None
    phase_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def num_deleted(self) -> int:
        return len(self.files_deleted)


def _is_hidden(name: str) -> bool:
    return (name.startswith(("_", "."))
            and not name.startswith(filenames.CHANGE_DATA_DIR))


def _is_local(path: str) -> bool:
    return "://" not in path and not path.startswith("/")


def _dv_file(table_path: str, dv) -> str:
    """The absolute path of a 'u' descriptor's DV file."""
    return absolute_dv_path(table_path, {
        "storageType": dv.storageType, "pathOrInlineDv": dv.pathOrInlineDv})


def _walk_table_files(table_path: str):
    """(absolute path, table-relative path, mtime ms) of each file of the
    data area: hidden top-level directories are not entered (nor are
    links to directories), hidden file names are skipped at every depth.
    One stat per file (a directory entry's stat is cached): on a file
    system where each call is a round trip, the calls set the time."""
    pending = [table_path]
    while pending:
        root = pending.pop()
        try:
            with os.scandir(root) as it:
                entries = list(it)
        except FileNotFoundError:
            continue
        for e in entries:
            if e.is_dir():
                if not e.is_symlink() and not (root == table_path
                                               and _is_hidden(e.name)):
                    pending.append(e.path)
                continue
            if _is_hidden(e.name):
                continue
            try:
                mtime = int(e.stat().st_mtime * 1000)
            except FileNotFoundError:
                continue
            yield (e.path, e.path[len(table_path) + 1:].replace(os.sep, "/"),
                   mtime)


def _inventory_columns(inventory) -> dict:
    if isinstance(inventory, Batch):
        return {c: inventory.column(c).to_python()
                for c in inventory.column_names}
    if isinstance(inventory, Mapping):
        return {c: list(v) for c, v in inventory.items()}
    return {}


def _inventory_files(table_path: str, inventory):
    """(absolute path, table-relative path, mtime ms) of an inventory's
    file rows (`VacuumCommand.scala:59` USING INVENTORY; its schema
    `:69`). A path may be absolute or table-relative; rows outside the
    root, with a '..' segment, under a hidden top-level directory, with a
    hidden name, or without an mtime are ignored, as the walk would."""
    cols = _inventory_columns(inventory)
    missing = [c for c in INVENTORY_COLUMNS if c not in cols]
    if missing:
        raise InvalidArgumentError(
            f"invalid inventory schema: missing column(s) {missing}; "
            f"required: {list(INVENTORY_COLUMNS)}",
            error_class="DELTA_INVALID_INVENTORY_SCHEMA")
    base = table_path.rstrip("/")
    for path, is_dir, mtime in zip(cols["path"], cols["isDir"],
                                   cols["modificationTime"]):
        if is_dir or path is None:
            continue
        if path.startswith(base + "/"):
            rel = path[len(base) + 1:]
        elif not _is_local(path):
            continue
        else:
            rel = path
        # a '..' segment could escape the root, or alias a live file past
        # the string-keyed protected set: the walk never yields one
        rel = posixpath.normpath(rel.replace(os.sep, "/"))
        if rel.startswith("..") or rel.startswith("/") or rel == ".":
            continue
        if _is_hidden(rel.split("/", 1)[0]) \
                or _is_hidden(rel.rsplit("/", 1)[-1]):
            continue
        if mtime is None or (isinstance(mtime, float) and math.isnan(mtime)):
            continue  # unknown age: never a candidate
        yield os.path.join(base, rel), rel, int(mtime)


def _last_vacuum_watermark(table) -> Optional[int]:
    """The previous vacuum's watermark (`VacuumCommand.scala:948`); None
    when absent or unreadable (which only widens the next LITE scan)."""
    try:
        data = table.engine.fs.read_file(
            f"{table.log_path}/{LAST_VACUUM_INFO}")
        return json.loads(data.decode())[_WATERMARK_KEY]
    except (FileNotFoundError, KeyError, TypeError, ValueError):
        return None


def _persist_last_vacuum_info(table, watermark: int) -> None:
    """Write the watermark (`VacuumCommand.scala:967`), best effort."""
    body = json.dumps({_WATERMARK_KEY: watermark}).encode()
    try:
        table.engine.fs.write(f"{table.log_path}/{LAST_VACUUM_INFO}", body,
                              overwrite=True)
    except OSError as e:
        _log.warning("writing %s of %s failed: %s", LAST_VACUUM_INFO,
                     table.path, e)


def _commit_outside_retention(table, cutoff_ms: int) -> Optional[int]:
    """The newest commit at or before the cutoff; None when every commit
    is inside the window (`VacuumCommand.scala:285-296`)."""
    try:
        return version_at_timestamp(table, cutoff_ms,
                                    can_return_last_commit=True)
    except TimestampEarlierThanCommitRetentionError:
        return None


def _lite_candidates(table, cutoff_ms: int, last_mark: Optional[int]):
    """(candidates, start, end) of VACUUM LITE: the tombstones, their 'u'
    DV files and the CDC files of commits [start, end], where end is the
    newest commit outside the window and start the one after the
    watermark (`VacuumCommand.scala:506-556`)."""
    end = _commit_outside_retention(table, cutoff_ms)
    if end is None:
        return [], None, None
    listing = table.engine.fs.list_from(
        filenames.listing_prefix(table.log_path, 0), skip_stat=lambda n: True)
    versions = sorted(filenames.delta_version(st.path) for st in listing
                      if filenames.is_delta_file(st.path))
    if not versions:
        return [], None, None
    earliest = versions[0]
    # log cleanup removed commits no vacuum scanned: tombstones may have
    # left the log unseen, and only FULL can find their files now (no gap
    # when last_mark + 1 == earliest)
    if earliest != 0 and (last_mark is None or last_mark + 1 < earliest):
        raise VacuumLiteError(
            "VACUUM LITE cannot delete all eligible files as some files are "
            "not referenced by the Delta log. Please run VACUUM FULL.")
    # strictly after the watermark: its own commit was scanned already
    start = last_mark + 1 if last_mark is not None else earliest
    if start > end:
        return [], None, end
    buf, starts, vers = _read_commits_buffer(
        [(v, filenames.delta_file(table.log_path, v))
         for v in range(start, end + 1)])
    parsed = _parse_commit_buffer(table.engine, buf, starts, vers)
    fa = parsed.file_actions
    removes = torch.nonzero(~fa.is_add).squeeze(1).cpu().numpy()
    paths, stamps, dvs = fa.rows.refs(removes)

    base = table.path
    by_path: Dict[str, int] = {}

    def offer(path: str, mtime: int) -> None:
        # `path` is decoded already: '%2Fetc%2Fx' is the absolute path
        # it decodes to when the root checks see it
        if path.startswith(base + "/"):
            path = path[len(base) + 1:]
        elif not _is_local(path):
            return  # outside the root (a shallow clone's source)
        rel = posixpath.normpath(path.replace(os.sep, "/"))
        if rel.startswith("..") or rel.startswith("/") or rel == ".":
            return
        prev = by_path.get(rel)
        if prev is None or mtime > prev:
            by_path[rel] = mtime

    for path, stamp, dv in zip(paths, stamps, dvs):
        offer(path, stamp or 0)
        if dv is not None and dv.storageType == "u":
            offer(_dv_file(base, dv), stamp or 0)
    for _, _, row in parsed.others:
        cdc = row.get("cdc")
        if isinstance(cdc, dict) and isinstance(cdc.get("path"), str):
            offer(decode_path(cdc["path"]), 0)
    return ([(os.path.join(base, rel), rel, t) for rel, t in by_path.items()],
            start, end)


def _protected(table_path: str, state, cutoff_ms: int) -> tuple:
    """(protected, expired) table-relative paths: the live files, their
    'u' DV files and the tombstones inside the window; the tombstones
    past it."""
    live, paths, stamps, dvs = state.file_refs()
    protected, expired = set(), set()
    for is_live, path, stamp, dv in zip(live.tolist(), paths, stamps, dvs):
        local = _is_local(path)
        if not is_live and (stamp or 0) < cutoff_ms:
            if local:
                expired.add(path)
            continue
        if local:
            protected.add(path)
        if dv is not None and dv.storageType == "u":
            protected.add(os.path.relpath(_dv_file(table_path, dv),
                                          table_path).replace(os.sep, "/"))
    return protected, expired


def _unlink_all(paths: List[str]) -> None:
    def unlink(path: str) -> None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    with ThreadPoolExecutor(min(_UNLINK_WORKERS, len(paths))) as pool:
        list(pool.map(unlink, paths))


def vacuum(table, retention_hours: Optional[float] = None,
           dry_run: bool = False, enforce_retention_check: bool = True,
           inventory=None, vacuum_type: str = "FULL") -> VacuumResult:
    vacuum_type = vacuum_type.upper()
    if vacuum_type not in ("FULL", "LITE"):
        raise InvalidArgumentError(
            f"invalid vacuum type {vacuum_type!r}: expected FULL or LITE",
            error_class="DELTA_ILLEGAL_ARGUMENT")
    if inventory is not None and vacuum_type == "LITE":
        raise InvalidArgumentError("VACUUM LITE does not accept an inventory",
                                   error_class="DELTA_ILLEGAL_ARGUMENT")
    mark = PhaseTimer(table.engine.synchronize)
    state = table.latest_snapshot().state
    mark("load")
    retention_ms = (int(retention_hours * 3_600_000)
                    if retention_hours is not None else get_table_config(
                        state.metadata.configuration, TOMBSTONE_RETENTION))
    if enforce_retention_check and retention_ms < 0:
        raise VacuumRetentionError("retention must be >= 0")
    cutoff = int(time.time() * 1000) - retention_ms
    protected, expired = _protected(table.path, state, cutoff)
    mark("protected")

    result = VacuumResult(dry_run=dry_run, type_of_vacuum=vacuum_type,
                          phase_seconds=mark.seconds)
    last_mark = _last_vacuum_watermark(table)
    lite_end = None
    if inventory is not None:
        candidates = list(_inventory_files(table.path, inventory))
        mark("inventory")
    elif vacuum_type == "LITE":
        candidates, start, lite_end = _lite_candidates(table, cutoff,
                                                       last_mark)
        result.eligible_start_commit_version = start
        result.eligible_end_commit_version = lite_end
        mark("lite_scan")
    else:
        candidates = list(_walk_table_files(table.path))
        mark("walk")
    doomed: List[str] = []
    skewed_survivor = False
    for abs_path, rel, mtime in candidates:
        if rel in protected:
            continue
        if mtime >= cutoff:
            # too young (an in-flight transaction's, maybe); a file whose
            # tombstone already expired survives only by a skewed mtime,
            # and holds the FULL watermark back below
            skewed_survivor |= rel in expired
            continue
        result.files_deleted.append(rel)
        doomed.append(abs_path)
    mark("select")
    if dry_run:
        return result
    if doomed:
        _unlink_all(doomed)
    mark("unlink")
    if inventory is None:
        # advance-only: an empty run keeps the watermark. FULL advances it
        # too (the reference resets it to null, `VacuumCommand.scala:484`,
        # which wedges LITE on a cleaned-up log), unless a survivor's
        # remove lives in commits the watermark would skip. An inventory
        # proves nothing about files it does not list.
        new_mark = lite_end if vacuum_type == "LITE" else (
            None if skewed_survivor
            else _commit_outside_retention(table, cutoff))
        if new_mark is not None and (last_mark is None
                                     or new_mark > last_mark):
            _persist_last_vacuum_info(table, new_mark)
    mark("watermark")
    return result

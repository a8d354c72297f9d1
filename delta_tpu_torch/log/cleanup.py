"""Metadata cleanup (expire old log files) and log compaction.

Counterpart of `delta_tpu/log/cleanup.py`:

- `cleanup_expired_logs` (reference :34) deletes the commits, checksums
  and compacted deltas older than `delta.logRetentionDuration` (30 days),
  and the checkpoints older than the later of that and
  `delta.checkpointRetentionDuration` (2 days); an explicit `retention_ms`
  sets both. It never deletes at or past the newest complete checkpoint,
  so the table stays reconstructible from what is left, and nothing at
  all when there is no complete checkpoint. Sidecars are never deleted:
  their names parse to no version (and the listing holds files only).
- `write_compacted_delta` (reference :102) writes
  `<lo>.<hi>.compacted.json`, the reconciled actions of the commits lo..hi
  (the last protocol and metaData, the last txn per app, the last
  domainMetadata per domain, then each file key's last remove or add);
  a load lets it stand in for those commits (`log/segment.py`).

Both take an explicit clock (`now_ms`) or none; the files' ages are their
modification times.
"""

from __future__ import annotations

import time
from typing import List, Optional

from delta_tpu_torch.config import (
    CHECKPOINT_RETENTION,
    LOG_RETENTION,
    get_table_config,
)
from delta_tpu_torch.errors import InvalidArgumentError
from delta_tpu_torch.models.actions import (
    AddFile,
    DomainMetadata,
    Metadata,
    Protocol,
    RemoveFile,
    SetTransaction,
    actions_from_commit_bytes,
    actions_to_commit_bytes,
)
from delta_tpu_torch.utils import filenames
from delta_tpu_torch.utils.filenames import (
    CheckpointInstance,
    group_complete_checkpoints,
)


def _version_of(name: str, path: str) -> Optional[int]:
    """The version a commit, checksum or compacted delta's name names
    (a compacted delta's last one); None for any other file."""
    if filenames.DELTA_FILE_RE.match(name):
        return filenames.delta_version(path)
    if filenames.CHECKSUM_FILE_RE.match(name):
        return filenames.checksum_version(path)
    if filenames.COMPACTED_DELTA_FILE_RE.match(name):
        return filenames.compacted_delta_versions(path)[1]
    return None


def cleanup_expired_logs(table, retention_ms: Optional[int] = None,
                         now_ms: Optional[int] = None) -> List[str]:
    """Delete the expired log files a newer complete checkpoint shadows;
    returns their paths, in listing order."""
    fs = table.engine.fs
    conf = table.latest_snapshot().metadata.configuration
    explicit = retention_ms is not None
    if retention_ms is None:
        retention_ms = get_table_config(conf, LOG_RETENTION)
    now = now_ms if now_ms is not None else int(time.time() * 1000)
    cutoff = now - retention_ms
    # a shadowed checkpoint expires on its own, usually shorter, clock;
    # an explicit retention holds for both
    cp_cutoff = cutoff if explicit else max(
        cutoff, now - get_table_config(conf, CHECKPOINT_RETENTION))

    listing = fs.list_from(filenames.listing_prefix(table.log_path, 0))
    complete = group_complete_checkpoints(
        [ci for f in listing
         if (ci := CheckpointInstance.parse(f.path)) is not None])
    if not complete:
        return []  # nothing is shadowed
    newest_cp = complete[-1][0].version

    deleted = []
    for f in listing:
        name = filenames.file_name(f.path)
        version = _version_of(name, f.path)
        file_cutoff = cutoff
        if filenames.CHECKPOINT_FILE_RE.match(name):
            version = filenames.checkpoint_version(f.path)
            if version >= newest_cp:
                continue  # never the active checkpoint
            file_cutoff = cp_cutoff
        if version is None:
            continue
        if version < newest_cp and f.modification_time < file_cutoff:
            try:
                fs.delete(f.path)
                deleted.append(f.path)
            except FileNotFoundError:
                pass
    return deleted


def write_compacted_delta(table, from_version: int, to_version: int) -> str:
    """Reconcile commits `from_version`..`to_version` into one compacted
    delta (written put-if-absent); returns its path."""
    if to_version <= from_version:
        raise InvalidArgumentError(
            "compaction range must span at least two commits",
            error_class="DELTA_COMPACTION_RANGE_TOO_SMALL")
    fs = table.engine.fs
    protocol = metadata = None
    txns: dict = {}
    domains: dict = {}
    adds: dict = {}
    removes: dict = {}
    for v in range(from_version, to_version + 1):
        data = fs.read_file(filenames.delta_file(table.log_path, v))
        for a in actions_from_commit_bytes(data):
            if isinstance(a, Protocol):
                protocol = a
            elif isinstance(a, Metadata):
                metadata = a
            elif isinstance(a, SetTransaction):
                txns[a.appId] = a
            elif isinstance(a, DomainMetadata):
                domains[a.domain] = a
            elif isinstance(a, AddFile):
                key = (a.path, a.dv_unique_id)
                removes.pop(key, None)
                adds[key] = a
            elif isinstance(a, RemoveFile):
                key = (a.path, a.dv_unique_id)
                adds.pop(key, None)
                removes[key] = a
    out: list = [a for a in (protocol, metadata) if a is not None]
    out += list(txns.values()) + list(domains.values())
    out += list(removes.values()) + list(adds.values())
    path = filenames.compacted_delta_file(table.log_path, from_version,
                                          to_version)
    fs.write(path, actions_to_commit_bytes(out), overwrite=False)
    return path

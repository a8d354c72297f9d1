"""LogSegment: the checkpoint and commit files that reproduce a version.

Counterpart of `delta_tpu/log/segment.py`, for the latest version or a
target version at or below it:

1. LIST `_delta_log` (lexicographic order is version order) from the
   `_last_checkpoint` hint's version when the caller gives one, else from
   version 0; with a target version, commits, checkpoints and compacted
   deltas past it are left out. A hinted listing that cannot assemble a
   contiguous segment (the hinted checkpoint lost a part) is retried from
   version 0 and counted (`log.hint_discarded`).
2. Partition the listing into commits, checkpoints and compacted deltas.
3. The newest complete checkpoint anchors the segment: single-part or
   multi-part classic Parquet, or a V2 checkpoint (a UUID-named JSON or
   Parquet top level whose sidecars the reader resolves).
4. Keep the commits after the checkpoint and verify they are contiguous
   up to the version. Then the compacted deltas inside the window
   replace the runs of single commits they cover (`_apply_compaction`,
   the reference's greedy choice: by first version, widest first, no
   overlap, every covered commit listed).
   The snapshot's timestamp is the mtime of the last single commit kept,
   or, when none is kept, of the commit at the version (also at
   checkpoint-at-head), as in the reference.

A target version that the listing cannot reach raises
`VersionNotFoundError`.

`extend_log_segment` is the incremental half (`Snapshot.update()`): it
LISTs only past a segment's version and appends the new commits, or
raises `_IncrementalUnavailable` when the segment a cold load would build
starts elsewhere (a newer checkpoint or compacted delta) or the new
versions have a gap.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

from delta_tpu_torch import obs
from delta_tpu_torch.errors import (
    CorruptLogError,
    TableNotFoundError,
    VersionNotFoundError,
)
from delta_tpu_torch.storage.local import FileStatus
from delta_tpu_torch.utils import filenames
from delta_tpu_torch.utils.filenames import (
    CheckpointFormat,
    CheckpointInstance,
    group_complete_checkpoints,
)

_V2_FORMATS = (CheckpointFormat.V2_JSON, CheckpointFormat.V2_PARQUET)


@dataclass
class LogSegment:
    log_path: str
    version: int
    deltas: List[FileStatus] = field(default_factory=list)  # ascending version
    checkpoints: List[FileStatus] = field(default_factory=list)  # one checkpoint's parts
    compacted_deltas: List[FileStatus] = field(default_factory=list)  # chosen ranges
    checkpoint_version: Optional[int] = None
    last_commit_timestamp: int = 0

    @property
    def is_v2(self) -> bool:
        """The anchoring checkpoint is a V2 checkpoint."""
        return any(CheckpointInstance.parse(f.path).fmt in _V2_FORMATS
                   for f in self.checkpoints)


_HINT_DISCARDED = obs.counter("log.hint_discarded")


class _IncrementalUnavailable(Exception):
    """The segment cannot be extended incrementally: a checkpoint or
    compacted delta landed past it, or the new versions have a gap. The
    caller falls back to a full load; a control-flow signal, never a
    user-facing error."""


def _list(fs, log_path: str, start: int):
    """The listing of `log_path` from version `start`; commits skip the
    stat (the reader learns their sizes as it reads them)."""
    try:
        return fs.list_from(
            filenames.listing_prefix(log_path, start),
            skip_stat=lambda name: filenames.DELTA_FILE_RE.match(name)
            is not None)
    except FileNotFoundError:
        raise TableNotFoundError(f"no _delta_log at {log_path}",
                                 error_class="DELTA_EMPTY_DIRECTORY")


def extend_log_segment(fs, prev: LogSegment):
    """LIST only the log files past `prev.version` and append the new
    commits to the segment. Returns None when nothing is new (one
    listing, no read), else `(new segment, new commit FileStatuses)`; the
    newest commit's mtime is the new segment's timestamp. Raises
    `_IncrementalUnavailable` when a checkpoint or compacted delta newer
    than `prev.version` appeared (a cold load would start from it) or the
    new versions are not contiguous from `prev.version + 1`."""
    start = prev.version + 1
    new: List[tuple] = []
    for fstat in _list(fs, prev.log_path, start):
        name = filenames.file_name(fstat.path)
        if filenames.DELTA_FILE_RE.match(name):
            v = int(name.split(".", 1)[0])
            if v >= start:
                new.append((v, fstat))
        elif filenames.CHECKPOINT_FILE_RE.match(name) and fstat.size > 0:
            ci = CheckpointInstance.parse(fstat.path)
            if ci is not None and ci.version > prev.version:
                raise _IncrementalUnavailable(
                    f"checkpoint appeared at version {ci.version}")
        elif filenames.COMPACTED_DELTA_FILE_RE.match(name):
            _, hi = filenames.compacted_delta_versions(fstat.path)
            if hi > prev.version:
                raise _IncrementalUnavailable(
                    f"compacted delta appeared covering up to {hi}")
    if not new:
        return None
    new.sort(key=lambda t: t[0])
    versions = [v for v, _ in new]
    if versions != list(range(start, versions[-1] + 1)):
        raise _IncrementalUnavailable(
            f"non-contiguous new commits {versions[:5]}..., expected "
            f"[{start}, {versions[-1]}]")
    files = [f for _, f in new]
    ts = prev.last_commit_timestamp
    try:
        ts = max(ts, fs.file_status(files[-1].path).modification_time)
    except FileNotFoundError:
        pass
    seg = dataclasses.replace(prev, version=versions[-1],
                              deltas=list(prev.deltas) + files,
                              last_commit_timestamp=ts)
    return seg, files


def _apply_compaction(deltas: List[FileStatus], compacted: List[FileStatus],
                      start: int, target: int):
    """Substitute compacted deltas for runs of single commits inside
    [start, target] (the reference's `_apply_compaction`): ranges by
    first version, widest first; a range is taken when it overlaps no
    range taken and every commit it covers is listed. Returns (the single
    commits kept, the compacted deltas chosen)."""
    if not compacted:
        return deltas, []
    by_version = {filenames.delta_version(f.path): f for f in deltas}
    chosen: List[FileStatus] = []
    covered: set = set()
    ranges = sorted(((filenames.compacted_delta_versions(f.path), f)
                     for f in compacted),
                    key=lambda t: (t[0][0], -(t[0][1] - t[0][0])))
    for (lo, hi), f in ranges:
        if lo < start or hi > target:
            continue
        rng = set(range(lo, hi + 1))
        if rng & covered or not rng <= set(by_version):
            continue
        chosen.append(f)
        covered |= rng
    singles = [f for v, f in sorted(by_version.items()) if v not in covered]
    return singles, chosen


def build_log_segment(fs, log_path: str,
                      target_version: Optional[int] = None,
                      max_checkpoint_version: Optional[int] = None,
                      checkpoint_hint: Optional[int] = None) -> LogSegment:
    """LIST the log and assemble the segment of its latest version, or of
    `target_version`; compacted deltas stand in for the commits they
    cover. `max_checkpoint_version` caps which
    checkpoints may anchor it: the snapshot's fallback after the
    checkpoint at V proved unreadable rebuilds with V - 1, replaying from
    the previous complete checkpoint or from the JSON commits alone; the
    commits of the dropped checkpoints' versions stay in the segment. `checkpoint_hint` (the
    `_last_checkpoint` version) starts the listing there; a segment that
    cannot be assembled from it is listed again from version 0."""
    try:
        return _build_log_segment(fs, log_path, target_version,
                                  max_checkpoint_version, checkpoint_hint)
    except CorruptLogError:
        if checkpoint_hint is None:
            raise
        # the hint only speeds the listing up: a window that cannot be
        # assembled from it (the hinted checkpoint lost a part) may still
        # be assembled from a full listing anchored earlier
        _HINT_DISCARDED.inc()
        return _build_log_segment(fs, log_path, target_version,
                                  max_checkpoint_version, None)


def _build_log_segment(fs, log_path: str, target_version: Optional[int],
                       max_checkpoint_version: Optional[int],
                       checkpoint_hint: Optional[int]) -> LogSegment:
    listing = _list(fs, log_path, checkpoint_hint or 0)

    deltas: List[tuple] = []
    checkpoints: List[CheckpointInstance] = []
    compacted: List[FileStatus] = []
    last = target_version
    for fstat in listing:
        name = filenames.file_name(fstat.path)
        if filenames.DELTA_FILE_RE.match(name):
            v = int(name.split(".", 1)[0])
            if last is None or v <= last:
                deltas.append((v, fstat))
        elif filenames.CHECKPOINT_FILE_RE.match(name) and fstat.size > 0:
            ci = CheckpointInstance.parse(fstat.path)
            if (ci is not None and (last is None or ci.version <= last)
                    and (max_checkpoint_version is None
                         or ci.version <= max_checkpoint_version)):
                checkpoints.append(ci)
        elif filenames.COMPACTED_DELTA_FILE_RE.match(name):
            _, hi = filenames.compacted_delta_versions(fstat.path)
            if last is None or hi <= last:
                compacted.append(fstat)
    if not deltas and not checkpoints:
        raise TableNotFoundError(f"no commits found in {log_path}",
                                 error_class="DELTA_NO_COMMITS_FOUND")

    complete = group_complete_checkpoints(checkpoints)
    chosen = complete[-1] if complete else []
    cp_version = chosen[0].version if chosen else None
    start = cp_version + 1 if cp_version is not None else 0

    tail = [(v, f) for v, f in deltas if v >= start]
    versions = [v for v, _ in tail]
    version = versions[-1] if versions else cp_version
    if version is None:
        raise TableNotFoundError(f"no commits found in {log_path}",
                                 error_class="DELTA_NO_COMMITS_FOUND")
    if target_version is not None and version != target_version:
        raise VersionNotFoundError(
            version=target_version,
            earliest=versions[0] if versions else cp_version, latest=version)
    if versions != list(range(start, version + 1)):
        raise CorruptLogError(
            error_class="DELTA_TRUNCATED_TRANSACTION_LOG",
            message=f"Log is missing commit files: have versions "
            f"{versions[:5]}..., expected contiguous [{start}, {version}]")

    by_path = {f.path: f for f in listing}
    parts = [by_path[ci.path] for ci in chosen]
    singles = [f for _, f in tail]
    chosen_compacted: List[FileStatus] = []
    if compacted:
        singles, chosen_compacted = _apply_compaction(singles, compacted,
                                                      start, version)
    # the snapshot's timestamp is the mtime of the last single commit the
    # segment keeps, or, with none kept, of the commit at the version
    # (also at checkpoint-at-head: the checkpoint is written after it)
    head = singles[-1] if singles else next(
        (f for v, f in deltas if v == version), None)
    ts = 0
    if head is not None:
        try:
            ts = fs.file_status(head.path).modification_time
        except FileNotFoundError:
            ts = 0
    if ts == 0 and not singles:
        ts = max((f.modification_time for f in parts), default=0)
    return LogSegment(
        log_path=log_path,
        version=version,
        deltas=singles,
        checkpoints=parts,
        compacted_deltas=chosen_compacted,
        checkpoint_version=cp_version,
        last_commit_timestamp=ts,
    )

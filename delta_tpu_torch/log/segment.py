"""LogSegment: the commit files that reproduce a version.

Counterpart of `delta_tpu/log/segment.py::build_log_segment`, for a
segment made of JSON commits only:

1. LIST `_delta_log` (lexicographic order is version order).
2. Partition the listing into commits, checkpoints and compacted deltas.
3. If a complete checkpoint or a compacted delta would anchor the
   segment, raise `UnsupportedLogError`: reading checkpoints is the next
   slice of the port, and replaying the commits around a checkpoint would
   silently diverge from the JAX package once old commits are cleaned up.
4. Keep the commits `0..latest`, verify they are contiguous.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from delta_tpu_torch.errors import (
    CorruptLogError,
    TableNotFoundError,
    UnsupportedLogError,
)
from delta_tpu_torch.storage.local import FileStatus
from delta_tpu_torch.utils import filenames
from delta_tpu_torch.utils.filenames import (
    CheckpointInstance,
    complete_checkpoint_versions,
)


@dataclass
class LogSegment:
    log_path: str
    version: int
    deltas: List[FileStatus] = field(default_factory=list)  # ascending version
    last_commit_timestamp: int = 0


def build_log_segment(fs, log_path: str) -> LogSegment:
    """LIST the log and assemble the commit-only segment of its latest
    version (time travel comes with a later slice of the port)."""
    try:
        # commits skip the stat (the reader learns their sizes as it reads
        # them); only the newest commit's mtime is needed (stat'd below)
        listing = fs.list_from(
            filenames.listing_prefix(log_path, 0),
            skip_stat=lambda name: filenames.DELTA_FILE_RE.match(name)
            is not None)
    except FileNotFoundError:
        raise TableNotFoundError(f"no _delta_log at {log_path}",
                                 error_class="DELTA_EMPTY_DIRECTORY")

    deltas: List[tuple] = []
    checkpoints: List[CheckpointInstance] = []
    compacted: List[tuple] = []
    for fstat in listing:
        name = filenames.file_name(fstat.path)
        if filenames.DELTA_FILE_RE.match(name):
            deltas.append((int(name.split(".", 1)[0]), fstat))
        elif filenames.CHECKPOINT_FILE_RE.match(name) and fstat.size > 0:
            checkpoints.append(CheckpointInstance.parse(fstat.path))
        elif filenames.COMPACTED_DELTA_FILE_RE.match(name):
            compacted.append(filenames.compacted_delta_versions(fstat.path))

    complete = complete_checkpoint_versions(checkpoints)
    if complete:
        raise UnsupportedLogError(
            f"{log_path} has a complete checkpoint at version "
            f"{complete[-1]}; this package replays JSON commits only, "
            f"checkpoint reading is the next slice of the port",
            checkpoint_version=complete[-1])
    if compacted:
        raise UnsupportedLogError(
            f"{log_path} has compacted deltas {compacted[:3]}; this package "
            f"replays single JSON commits only",
            compacted=compacted)
    if not deltas:
        raise TableNotFoundError(f"no commits found in {log_path}",
                                 error_class="DELTA_NO_COMMITS_FOUND")

    versions = [v for v, _ in deltas]
    version = versions[-1]
    if versions != list(range(0, version + 1)):
        raise CorruptLogError(
            error_class="DELTA_TRUNCATED_TRANSACTION_LOG",
            message=f"Log is missing commit files: have versions "
            f"{versions[:5]}..., expected contiguous [0, {version}]")
    files = [f for _, f in deltas]
    return LogSegment(
        log_path=log_path,
        version=version,
        deltas=files,
        last_commit_timestamp=fs.file_status(files[-1].path).modification_time,
    )

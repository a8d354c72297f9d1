"""`_delta_log` file names: the part a commit-only snapshot load needs.

Counterpart of `delta_tpu/utils/filenames.py`. Commit files are
``%020d.json``; checkpoints (``%020d.checkpoint[...].parquet|json``) and
compacted ranges (``%020d.%020d.compacted.json``) are recognised so the
segment builder can refuse them. Zero padding makes a lexicographic
listing return files in version order.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

LOG_DIR_NAME = "_delta_log"

DELTA_FILE_RE = re.compile(r"^(\d+)\.json$")
COMPACTED_DELTA_FILE_RE = re.compile(r"^(\d+)\.(\d+)\.compacted\.json$")
CHECKPOINT_FILE_RE = re.compile(
    r"^(\d+)\.checkpoint((\.\d+\.\d+)?\.parquet|\.[^.]+\.(json|parquet))$"
)


def listing_prefix(log_path: str, version: int) -> str:
    """Prefix such that a lexicographic listing returns every log file
    with version >= `version`."""
    return f"{log_path}/{version:020d}."


def file_name(path: str) -> str:
    return path.rstrip("/").rsplit("/", 1)[-1]


def delta_version(path: str) -> int:
    """Version encoded in a commit file name."""
    return int(file_name(path).split(".")[0])


def compacted_delta_versions(path: str) -> tuple[int, int]:
    parts = file_name(path).split(".")
    return int(parts[0]), int(parts[1])


@dataclass(frozen=True)
class CheckpointInstance:
    """Identity of one checkpoint file: its version and, for a multi-part
    checkpoint, which part of how many. A classic or V2 checkpoint is one
    part of one."""

    version: int
    part: int = 1
    num_parts: int = 1
    path: Optional[str] = None

    @staticmethod
    def parse(path: str) -> Optional["CheckpointInstance"]:
        name = file_name(path)
        m = CHECKPOINT_FILE_RE.match(name)
        if m is None:
            return None
        version = int(m.group(1))
        parts = name.split(".")
        if len(parts) == 5 and parts[2].isdigit() and parts[3].isdigit():
            return CheckpointInstance(version, part=int(parts[2]),
                                      num_parts=int(parts[3]), path=path)
        return CheckpointInstance(version, path=path)


def complete_checkpoint_versions(
    instances: Sequence[CheckpointInstance],
) -> List[int]:
    """Versions that have a complete checkpoint, ascending: a single-file
    checkpoint is complete by itself, a multi-part one when all of its
    `num_parts` parts are listed."""
    parts: dict = {}
    for ci in instances:
        parts.setdefault((ci.version, ci.num_parts), set()).add(ci.part)
    return sorted({v for (v, k), got in parts.items()
                   if got == set(range(1, k + 1))})

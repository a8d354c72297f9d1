"""`_delta_log` file names: the part a snapshot load needs.

Counterpart of `delta_tpu/utils/filenames.py`. Commit files are
``%020d.json``; classic checkpoints ``%020d.checkpoint.parquet``,
multi-part ones ``%020d.checkpoint.%010d.%010d.parquet``, V2 ones
``%020d.checkpoint.<uuid>.{json,parquet}``; compacted ranges
``%020d.%020d.compacted.json``; version checksums ``%020d.crc``; V2
sidecars ``_sidecars/<uuid>.parquet``. Zero padding makes a lexicographic
listing return files in version order.
"""

from __future__ import annotations

import re
import uuid as _uuid
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Sequence

LOG_DIR_NAME = "_delta_log"
SIDECAR_SUBDIR = "_sidecars"
CHANGE_DATA_DIR = "_change_data"  # CDC files, which VACUUM walks

DELTA_FILE_RE = re.compile(r"^(\d+)\.json$")
COMPACTED_DELTA_FILE_RE = re.compile(r"^(\d+)\.(\d+)\.compacted\.json$")
CHECKSUM_FILE_RE = re.compile(r"^(\d+)\.crc$")
CHECKPOINT_FILE_RE = re.compile(
    r"^(\d+)\.checkpoint((\.\d+\.\d+)?\.parquet|\.[^.]+\.(json|parquet))$"
)


def listing_prefix(log_path: str, version: int) -> str:
    """Prefix such that a lexicographic listing returns every log file
    with version >= `version`."""
    return f"{log_path}/{version:020d}."


def delta_file(log_path: str, version: int) -> str:
    """Path of the commit file of `version`."""
    return f"{log_path}/{version:020d}.json"


def is_delta_file(path: str) -> bool:
    return DELTA_FILE_RE.match(file_name(path)) is not None


def file_name(path: str) -> str:
    return path.rstrip("/").rsplit("/", 1)[-1]


def delta_version(path: str) -> int:
    """Version encoded in a commit file name."""
    return int(file_name(path).split(".")[0])


def compacted_delta_versions(path: str) -> tuple[int, int]:
    parts = file_name(path).split(".")
    return int(parts[0]), int(parts[1])


def checkpoint_file_singular(log_path: str, version: int) -> str:
    return f"{log_path}/{version:020d}.checkpoint.parquet"


def checkpoint_file_with_parts(log_path: str, version: int,
                               num_parts: int) -> List[str]:
    return [f"{log_path}/{version:020d}.checkpoint.{i:010d}.{num_parts:010d}"
            f".parquet" for i in range(1, num_parts + 1)]


def top_level_v2_checkpoint_file(log_path: str, version: int,
                                 fmt: str = "parquet",
                                 uuid: Optional[str] = None) -> str:
    """A V2 checkpoint's top-level file, named by a fresh UUID unless one
    is given."""
    if fmt not in ("json", "parquet"):
        raise ValueError(f"V2 checkpoint format {fmt!r}")
    u = uuid if uuid is not None else str(_uuid.uuid4())
    return f"{log_path}/{version:020d}.checkpoint.{u}.{fmt}"


def sidecar_dir(log_path: str) -> str:
    """Where a V2 checkpoint's sidecar files live."""
    return f"{log_path}/{SIDECAR_SUBDIR}"


def compacted_delta_file(log_path: str, from_version: int,
                         to_version: int) -> str:
    return (f"{log_path}/{from_version:020d}.{to_version:020d}"
            f".compacted.json")


def checksum_version(path: str) -> int:
    return int(file_name(path).split(".")[0])


def checkpoint_version(path: str) -> int:
    return int(file_name(path).split(".")[0])


def last_checkpoint_file(log_path: str) -> str:
    return f"{log_path}/_last_checkpoint"


def checksum_file(log_path: str, version: int) -> str:
    return f"{log_path}/{version:020d}.crc"


class CheckpointFormat(Enum):
    CLASSIC = "classic"            # %020d.checkpoint.parquet
    MULTIPART = "multipart"        # %020d.checkpoint.%010d.%010d.parquet
    V2_JSON = "v2-json"            # %020d.checkpoint.<uuid>.json
    V2_PARQUET = "v2-parquet"      # %020d.checkpoint.<uuid>.parquet


_FORMAT_RANK = {
    CheckpointFormat.CLASSIC: 0,
    CheckpointFormat.MULTIPART: 1,
    CheckpointFormat.V2_JSON: 2,
    CheckpointFormat.V2_PARQUET: 2,
}


@dataclass(frozen=True)
class CheckpointInstance:
    """Identity of one checkpoint file: version, format and, for a
    multi-part checkpoint, which part of how many. Ordered by version,
    then format (V2 > multi-part > classic), as the reference picks the
    best complete checkpoint."""

    version: int
    fmt: CheckpointFormat
    num_parts: int = 1
    part: int = 1
    uuid: Optional[str] = None
    path: Optional[str] = None

    @property
    def sort_key(self):
        return (self.version, _FORMAT_RANK[self.fmt], self.num_parts)

    @staticmethod
    def parse(path: str) -> Optional["CheckpointInstance"]:
        name = file_name(path)
        m = CHECKPOINT_FILE_RE.match(name)
        if m is None:
            return None
        version = int(m.group(1))
        parts = name.split(".")
        if len(parts) == 3:
            return CheckpointInstance(version, CheckpointFormat.CLASSIC,
                                      path=path)
        if len(parts) == 5 and parts[2].isdigit() and parts[3].isdigit():
            return CheckpointInstance(version, CheckpointFormat.MULTIPART,
                                      num_parts=int(parts[3]),
                                      part=int(parts[2]), path=path)
        if len(parts) == 4:
            fmt = (CheckpointFormat.V2_JSON if parts[3] == "json"
                   else CheckpointFormat.V2_PARQUET)
            return CheckpointInstance(version, fmt, uuid=parts[2], path=path)
        return None


def group_complete_checkpoints(
    instances: Sequence[CheckpointInstance],
) -> List[List[CheckpointInstance]]:
    """Complete checkpoints, ascending by (version, format rank): a
    classic or V2 file is complete by itself, a multi-part checkpoint when
    all `num_parts` parts of one (version, num_parts) are listed."""
    groups: List[List[CheckpointInstance]] = []
    multi: dict = {}
    for ci in instances:
        if ci.fmt == CheckpointFormat.MULTIPART:
            multi.setdefault((ci.version, ci.num_parts), {})[ci.part] = ci
        else:
            groups.append([ci])
    for (_, num_parts), parts in multi.items():
        if set(parts) == set(range(1, num_parts + 1)):
            groups.append([parts[i] for i in range(1, num_parts + 1)])
    groups.sort(key=lambda g: g[0].sort_key)
    return groups

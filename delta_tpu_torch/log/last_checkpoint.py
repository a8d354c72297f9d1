"""The `_last_checkpoint` pointer file.

Counterpart of `delta_tpu/log/last_checkpoint.py`: a small JSON document
naming the newest checkpoint (PROTOCOL.md `_last_checkpoint`), so that a
reader can start its listing there. It is a hint: a missing or corrupt
one reads as None, and a failed write is counted
(`log.hint_write_failures`) and logged, never raised, since the
checkpoint it points at is already durable. A multi-part or V2
checkpoint's hint carries `partManifest` (the reference's part-reuse
rider): `{"writerFp": ..., "parts": [{"name", "fp", "rows", "bytes",
"mtime"}, ...]}`, one entry per file-action part or sidecar, which the
next write reads back to reuse them (`log/checkpointer.py`); a V2 hint
also names its top level in `tag`.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional

from delta_tpu_torch import obs
from delta_tpu_torch.utils import filenames

_log = logging.getLogger(__name__)

_HINT_WRITE_FAILURES = obs.counter("log.hint_write_failures")

_OPTIONAL = ("parts", "sizeInBytes", "numOfAddFiles", "checkpointSchema",
             "checksum", "tag", "partManifest")


@dataclass
class LastCheckpointInfo:
    version: int
    size: int                       # actions in the checkpoint
    parts: Optional[int] = None     # multi-part only
    sizeInBytes: Optional[int] = None
    numOfAddFiles: Optional[int] = None
    checkpointSchema: Optional[Dict[str, Any]] = None
    checksum: Optional[str] = None
    tag: Optional[str] = None
    partManifest: Optional[Dict[str, Any]] = None

    def to_json(self) -> str:
        d = {"version": self.version, "size": self.size}
        d.update({k: getattr(self, k) for k in _OPTIONAL
                  if getattr(self, k) is not None})
        return json.dumps(d, separators=(",", ":"))

    @staticmethod
    def from_json(data) -> "LastCheckpointInfo":
        d = json.loads(data)
        return LastCheckpointInfo(
            version=int(d["version"]),
            size=int(d.get("size", -1)),
            parts=int(d["parts"]) if d.get("parts") is not None else None,
            **{k: d.get(k) for k in _OPTIONAL if k != "parts"})


def read_last_checkpoint(fs, log_path: str) -> Optional[LastCheckpointInfo]:
    """The hint, or None when it is missing or does not parse."""
    try:
        return LastCheckpointInfo.from_json(
            fs.read_file(filenames.last_checkpoint_file(log_path)))
    except (FileNotFoundError, ValueError, KeyError, TypeError):
        return None


def write_last_checkpoint(fs, log_path: str, info: LastCheckpointInfo
                          ) -> None:
    """Overwrite the hint atomically (temporary file, then rename). A
    failure is counted and logged: readers then list from an older hint
    or from version 0."""
    try:
        fs.write(filenames.last_checkpoint_file(log_path),
                 info.to_json().encode("utf-8"), overwrite=True)
    except OSError as e:
        _HINT_WRITE_FAILURES.inc()
        _log.warning("_last_checkpoint hint write failed for %s (%s); "
                     "readers will list from an older hint or version 0",
                     log_path, e)

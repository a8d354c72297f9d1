"""The checkpoint write funnel: every part goes through one put-if-absent.

Counterpart of the serial half of `delta_tpu/write/ckpt_pipeline.py`
(`CheckpointWriteError` :126, `_upload` :151, `_existing_is_whole` :185,
`_run_serial` :209). Each task encodes its part, then writes it with the
local store's put-if-absent (`storage/local.py`, a link of a fsynced
temporary file). A collision with a file of the same size is another
writer's whole part of this checkpoint and counts as written (not
created by us); a collision with a shorter or longer file is a torn
leftover, deleted and retried twice. Any failure raises
`CheckpointWriteError` naming every file this attempt created plus the
failing target, for the caller to delete. The pipelined funnel of the
reference (encode of part i + 1 under the upload of part i) is not
ported: a local store gains nothing from it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from delta_tpu_torch.storage.local import FileStatus

_TORN_RETRIES = 2


@dataclass
class WriteTask:
    path: str
    build: Callable[[], bytes]   # the part's encoded bytes


@dataclass
class TaskResult:
    """`status` is the written file's FileStatus, or None when another
    writer's whole file already stood at `path`; `created` whether this
    attempt made the file."""

    task: WriteTask
    nbytes: int
    status: Optional[FileStatus]
    created: bool


class CheckpointWriteError(Exception):
    """A part's encode or write failed mid-checkpoint. `touched_paths`
    lists every file this attempt created plus the possibly torn target;
    the caller deletes them and leaves `_last_checkpoint` as it was."""

    error_class = "DELTA_CHECKPOINT_WRITE_ABORTED"

    def __init__(self, cause: BaseException, touched_paths: List[str]):
        super().__init__(f"checkpoint write aborted: {cause}")
        self.cause = cause
        self.touched_paths = list(touched_paths)


def _existing_is_whole(fs, path: str, expected_bytes: int) -> bool:
    try:
        return fs.file_status(path).size == expected_bytes
    except OSError:
        return False


def _upload(fs, task: WriteTask, data: bytes) -> TaskResult:
    for attempt in range(_TORN_RETRIES + 1):
        try:
            fs.write(task.path, data, overwrite=False)
            return TaskResult(task, len(data), fs.file_status(task.path),
                              created=True)
        except FileExistsError:
            if _existing_is_whole(fs, task.path, len(data)):
                return TaskResult(task, 0, None, created=False)
            if attempt >= _TORN_RETRIES:
                raise
            try:
                fs.delete(task.path)
            except OSError:
                pass  # the next attempt collides again and the loop raises
    raise AssertionError("unreachable")


def run_write_tasks(fs, tasks: List[WriteTask],
                    phases: Dict[str, float]) -> List[TaskResult]:
    """Encode and write each task in order; `phases` accumulates the wall
    seconds of "encode" and "put"."""
    results: List[TaskResult] = []
    for task in tasks:
        try:
            t0 = time.perf_counter()
            data = task.build()
            t1 = time.perf_counter()
            results.append(_upload(fs, task, data))
            t2 = time.perf_counter()
        except Exception as e:
            touched = [r.task.path for r in results if r.created]
            raise CheckpointWriteError(e, touched + [task.path]) from e
        phases["encode"] = phases.get("encode", 0.0) + (t1 - t0)
        phases["put"] = phases.get("put", 0.0) + (t2 - t1)
    return results

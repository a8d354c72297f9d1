"""The local filesystem under a Delta table.

Counterpart of `LocalLogStore` in `delta_tpu/storage/logstore.py`: a
sorted listing from a prefix, a stat, a whole-file read, an atomic
write, and a delete. Without `overwrite` the write is a put-if-absent:
the bytes go to a temporary file first (written and fsynced), which is
then linked under the final name; `os.link` fails when the name exists,
so exactly one of two racing writers of `N.json` wins and the other gets
FileExistsError, and no reader ever sees a partial file. With `overwrite` the temporary
file replaces the target by rename. The commit reader
(`replay/columnar.py`) opens the listed commit files itself and counts
them (`log.commit_reads`); this store counts its listings
(`storage.list_calls`) and whole-file reads (`storage.read_calls`).
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass
from typing import Callable, List, Optional

from delta_tpu_torch import obs

_LIST_CALLS = obs.counter("storage.list_calls")
_READ_CALLS = obs.counter("storage.read_calls")


@dataclass(frozen=True)
class FileStatus:
    """A listed file: path, size in bytes, modification time (ms since
    the epoch)."""

    path: str
    size: int
    modification_time: int


class LocalLogStore:
    def list_from(self, path: str,
                  skip_stat: Optional[Callable[[str], bool]] = None,
                  ) -> List[FileStatus]:
        """Files in the parent of `path` whose name is lexicographically
        >= `path`'s name, in sorted order. Entries whose name satisfies
        `skip_stat` come back with size -1 and mtime 0 instead of paying a
        stat each (one stat per commit file is a syscall the commit reader
        does without). Raises
        FileNotFoundError when the parent directory does not exist."""
        _LIST_CALLS.inc()
        parent = os.path.dirname(path)
        name = os.path.basename(path)
        if not os.path.isdir(parent):
            raise FileNotFoundError(parent)
        with os.scandir(parent) as it:
            entries = sorted((e for e in it if e.name >= name and e.is_file()),
                             key=lambda e: e.name)
        sep = "" if parent.endswith("/") else "/"
        out = []
        for e in entries:
            if skip_stat is not None and skip_stat(e.name):
                out.append(FileStatus(f"{parent}{sep}{e.name}", -1, 0))
                continue
            try:
                st = e.stat()
            except FileNotFoundError:
                continue  # removed between the scan and the stat
            out.append(FileStatus(f"{parent}{sep}{e.name}", st.st_size,
                                  int(st.st_mtime * 1000)))
        return out

    def file_status(self, path: str) -> FileStatus:
        st = os.stat(path)
        return FileStatus(path, st.st_size, int(st.st_mtime * 1000))

    def read_file(self, path: str) -> bytes:
        _READ_CALLS.inc()
        with open(path, "rb") as f:
            return f.read()

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def write(self, path: str, data: bytes, overwrite: bool = False) -> None:
        """Atomically create `path` holding `data`. Without `overwrite`,
        raise FileExistsError when `path` exists (the failure leaves no
        file behind)."""
        parent = os.path.dirname(path)
        if parent:
            self.mkdirs(parent)
        tmp = os.path.join(parent,
                           f".{os.path.basename(path)}.{uuid.uuid4().hex}.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if overwrite:
            os.replace(tmp, path)
            return
        try:
            os.link(tmp, path)
        finally:
            os.unlink(tmp)

    def delete(self, path: str) -> None:
        """Remove `path`; a missing file raises FileNotFoundError."""
        os.remove(path)

"""Local-filesystem reads of a `_delta_log`.

Counterpart of the read half of `LocalLogStore` in
`delta_tpu/storage/logstore.py`: a sorted listing from a prefix and a
stat. The commit reader (`replay/columnar.py`) opens the listed files
itself. Writes come with a later slice of the port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional


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

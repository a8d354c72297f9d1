"""Columnarization: a commit-only log segment -> replay lanes on the device.

Counterpart of the commit half of `delta_tpu/replay/columnar.py`. All JSON
commits of the segment are read in parallel into ONE buffer
(`_read_commits_buffer`); the device parse (`replay/device_parse.py`)
turns it into per-row lanes in line order, or, when the JAX package's
ladder sends the buffer back to the host, the host parser
(`replay/host_parse.py`) does. Either way the result is a `FileActions`:

- lanes on the engine's device, one row per add/remove action: `is_add`,
  `version`, `order` (the row's line rank within its commit), `size`
  (0 where absent), and the replay key `(path_code, dv_code)`, exact
  dictionary codes of the percent-decoded path and of the deletion
  vector's unique id (0 = none);
- a host-side row store that materializes `AddFile` / `RemoveFile`
  objects for the rows a caller asks for (stats decoded on that first
  access).

The small actions (protocol, metaData, txn, domainMetadata, commitInfo)
resolve host-side, latest (version, order) wins; they are O(commits).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch.errors import CorruptLogError
from delta_tpu_torch.models.actions import (
    CommitInfo,
    DomainMetadata,
    Metadata,
    Protocol,
    SetTransaction,
)
from delta_tpu_torch.utils import filenames


@dataclass
class FileActions:
    """Every add/remove row of a segment, in chronological (line) order.
    Lanes live on one device; `rows` materializes actions on the host."""

    is_add: torch.Tensor     # bool [n]
    version: torch.Tensor    # int64 [n]
    order: torch.Tensor      # int32 [n]
    size: torch.Tensor       # int64 [n], 0 where absent
    path_code: torch.Tensor  # int64 [n]
    dv_code: torch.Tensor    # int64 [n], 0 = no deletion vector
    rows: object             # .add_files(idx) / .remove_files(idx)

    @property
    def num_rows(self) -> int:
        return int(self.is_add.shape[0])


@dataclass
class ParsedCommits:
    """One parse of a commit buffer, by either route."""

    file_actions: FileActions
    others: List[Tuple[int, int, dict]]  # (version, order, control action)


def _prune_nones(d):
    if isinstance(d, dict):
        return {k: _prune_nones(v) for k, v in d.items() if v is not None}
    if isinstance(d, list):
        return [_prune_nones(v) for v in d]
    return d


@dataclass
class _SmallActionTracker:
    """Latest-seen-wins resolution for O(commits) actions."""

    protocol: tuple = (-1, -1, None)
    metadata: tuple = (-1, -1, None)
    txns: Dict[str, tuple] = field(default_factory=dict)
    domains: Dict[str, tuple] = field(default_factory=dict)
    commit_infos: Dict[int, CommitInfo] = field(default_factory=dict)

    def _on_protocol(self, v, o, row):
        if (v, o) > self.protocol[:2]:
            self.protocol = (v, o, Protocol.from_dict(row))

    def _on_metadata(self, v, o, row):
        if (v, o) > self.metadata[:2]:
            self.metadata = (v, o, Metadata.from_dict(row))

    def _on_txn(self, v, o, row):
        txn = SetTransaction.from_dict(row)
        cur = self.txns.get(txn.appId)
        if cur is None or (v, o) > cur[:2]:
            self.txns[txn.appId] = (v, o, txn)

    def _on_domain(self, v, o, row):
        dm = DomainMetadata.from_dict(row)
        cur = self.domains.get(dm.domain)
        if cur is None or (v, o) > cur[:2]:
            self.domains[dm.domain] = (v, o, dm)

    def _on_commit_info(self, v, o, row):
        self.commit_infos[v] = CommitInfo.from_dict(row)

    def scan_pylist(self, rows: Sequence[Tuple[int, int, dict]]):
        """Consume (version, order, {action-key: body}) control rows."""
        handlers = {
            "protocol": self._on_protocol,
            "metaData": self._on_metadata,
            "txn": self._on_txn,
            "domainMetadata": self._on_domain,
            "commitInfo": self._on_commit_info,
        }
        for v, o, row in rows:
            for key, body in row.items():
                h = handlers.get(key)
                if h is not None and body is not None:
                    h(v, o, _prune_nones(body))


@dataclass
class ColumnarActions:
    """Output of columnarization for one log segment."""

    file_actions: FileActions
    protocol: Optional[Protocol] = None
    metadata: Optional[Metadata] = None
    set_transactions: Dict[str, SetTransaction] = field(default_factory=dict)
    domain_metadata: Dict[str, DomainMetadata] = field(default_factory=dict)
    latest_commit_info: Optional[CommitInfo] = None
    commit_infos: Dict[int, CommitInfo] = field(default_factory=dict)
    parsed_on_device: bool = False
    # wall seconds of the read and parse phases (device work included)
    phase_seconds: Dict[str, float] = field(default_factory=dict)


_READ_CHUNK = 1 << 20


def _read_commits_buffer(
    commits: Sequence[Tuple[int, str]],
    max_workers: int = 8,
) -> tuple[bytearray, np.ndarray, np.ndarray]:
    """Parallel-read commit files into ONE buffer.

    commits: (version, local path) in version order. Each file is followed
    by a newline (an empty line between files is ignored by both parsers).
    Returns (buffer, per-file byte starts [n + 1], per-file versions).

    Per file: open, read until end of file, close; no stat. Where each
    file-system call is expensive (a sandboxed or network mount) the
    calls, not the bytes, set the time, and a commit (tens of KB) fits one
    read. Each worker takes one contiguous range of files, since a task
    per small file costs more in executor overhead than the read itself."""
    n = len(commits)
    workers = max(1, min(max_workers, os.cpu_count() or 1, n // 64))

    def read_file(path: str) -> bytes:
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError as e:
            # a listed commit vanished before reading: concurrent cleanup
            raise CorruptLogError(
                f"commit file vanished after listing: {path}",
                error_class="DELTA_COMMIT_FILE_VANISHED") from e
        try:
            parts = []
            while chunk := os.read(fd, _READ_CHUNK):
                parts.append(chunk)
        finally:
            os.close(fd)
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def read_range(k: int) -> List[bytes]:
        return [read_file(commits[i][1])
                for i in range(k * n // workers, (k + 1) * n // workers)]

    if workers == 1:
        blobs = read_range(0)
    else:
        with ThreadPoolExecutor(workers) as pool:
            blobs = [b for part in pool.map(read_range, range(workers))
                     for b in part]
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(b) + 1 for b in blobs), np.int64, n),
              out=starts[1:])
    buf = bytearray(b"\n").join(blobs + [b""])
    versions = np.array([v for v, _ in commits], dtype=np.int64)
    return buf, starts, versions


def columnarize_log_segment(engine, segment) -> ColumnarActions:
    """Read every commit of the segment and produce its ColumnarActions:
    the device parse first, the host parser when the device parse hands
    the buffer back (`parse.device_fallbacks` counts those)."""
    from delta_tpu_torch.replay import device_parse, host_parse

    t0 = time.perf_counter()
    buf, starts, versions = _read_commits_buffer(
        [(filenames.delta_version(f.path), f.path) for f in segment.deltas])
    t1 = time.perf_counter()
    parsed = device_parse.parse_commits_device(
        buf, starts, versions, engine.device, engine.parse_window_bytes)
    on_device = parsed is not None
    if parsed is None:
        parsed = host_parse.parse_commits_host(buf, starts, versions,
                                               engine.device)
    engine.synchronize()
    t2 = time.perf_counter()

    tracker = _SmallActionTracker()
    tracker.scan_pylist(parsed.others)
    latest_ci = None
    if tracker.commit_infos:
        latest_ci = tracker.commit_infos[max(tracker.commit_infos)]
    return ColumnarActions(
        file_actions=parsed.file_actions,
        protocol=tracker.protocol[2],
        metadata=tracker.metadata[2],
        set_transactions={k: t[2] for k, t in tracker.txns.items()},
        domain_metadata={k: t[2] for k, t in tracker.domains.items()},
        latest_commit_info=latest_ci,
        commit_infos=tracker.commit_infos,
        parsed_on_device=on_device,
        phase_seconds={"read": t1 - t0, "parse": t2 - t1},
    )

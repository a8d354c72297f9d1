"""Commit history and time travel by timestamp.

Counterpart of `delta_tpu/history.py` (the reference's
`DeltaHistoryManager`): `get_history` reads the commitInfo of each commit,
newest first; `version_at_timestamp` resolves a timestamp to the latest
version committed at or before it, `version_at_or_after_timestamp` to the
earliest committed at or after it. A commit's timestamp is its
`commitInfo.inCommitTimestamp` where the table's newest commit carries
one, else its file's mtime, made strictly increasing (a copy or a skewed
clock can set mtimes back; a later commit is moved to one past the one
before it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from delta_tpu_torch.errors import (
    TableNotFoundError,
    TimestampEarlierThanCommitRetentionError,
    TimestampLaterThanLatestCommitError,
)
from delta_tpu_torch.models.actions import (
    CommitInfo,
    actions_from_commit_bytes,
)
from delta_tpu_torch.utils import filenames


def _metric_value_str(v) -> str:
    from delta_tpu_torch.txn.transaction import _metric_str

    return v if isinstance(v, str) else _metric_str(v)


@dataclass
class CommitRecord:
    version: int
    timestamp_ms: int
    commit_info: Optional[CommitInfo]

    def to_dict(self) -> dict:
        d = {"version": self.version, "timestamp": self.timestamp_ms}
        if self.commit_info is not None:
            ci = self.commit_info
            # operationMetrics is a map of strings; logs of older writers
            # may hold raw numbers, shown as strings here
            metrics = ci.operationMetrics
            if metrics:
                metrics = {k: _metric_value_str(v)
                           for k, v in metrics.items()}
            d.update({
                "operation": ci.operation,
                "operationParameters": ci.operationParameters,
                "operationMetrics": metrics,
                "engineInfo": ci.engineInfo,
                "isBlindAppend": ci.isBlindAppend,
                "readVersion": ci.readVersion,
                "isolationLevel": ci.isolationLevel,
                "txnId": ci.txnId,
            })
        return d


def _commit_files(table):
    """The table's commit files with their mtimes, in version order."""
    try:
        listing = table.engine.fs.list_from(
            filenames.listing_prefix(table.log_path, 0))
    except FileNotFoundError:
        return []
    commits = [f for f in listing if filenames.is_delta_file(f.path)]
    commits.sort(key=lambda f: filenames.delta_version(f.path))
    return commits


def _monotonic(commits) -> List[int]:
    """mtimes, each later one moved to at least one past the one before."""
    ts, last = [], -1
    for fstat in commits:
        t = fstat.modification_time
        if t <= last:
            t = last + 1
        ts.append(t)
        last = t
    return ts


def _commit_info(fs, path: str) -> Optional[CommitInfo]:
    try:
        data = fs.read_file(path)
    except FileNotFoundError:
        return None
    return next((a for a in actions_from_commit_bytes(data)
                 if isinstance(a, CommitInfo)), None)


def _timestamps(fs, commits) -> List[int]:
    """Each commit's timestamp: the in-commit timestamps when the newest
    commit's first line carries one (each commit read, its commitInfo's
    value where present), else the monotonic mtimes."""
    mono = _monotonic(commits)
    if not commits:
        return mono
    try:
        head = fs.read_file(commits[-1].path)
    except FileNotFoundError:
        return mono
    if b"inCommitTimestamp" not in head.split(b"\n", 1)[0]:
        return mono
    out = []
    for fstat, t in zip(commits, mono):
        ci = _commit_info(fs, fstat.path)
        out.append(ci.inCommitTimestamp if ci is not None
                   and ci.inCommitTimestamp is not None else t)
    return out


def get_history(table, limit: Optional[int] = None) -> List[CommitRecord]:
    """One record per commit, newest first (at most `limit`)."""
    fs = table.engine.fs
    commits = _commit_files(table)
    selected = list(zip(commits, _monotonic(commits)))[::-1]
    if limit is not None:
        selected = selected[:limit]
    out = []
    for fstat, ts in selected:
        ci = _commit_info(fs, fstat.path)
        if ci is not None and ci.inCommitTimestamp is not None:
            ts = ci.inCommitTimestamp
        out.append(CommitRecord(filenames.delta_version(fstat.path), ts, ci))
    return out


def _timed_commits(table):
    commits = _commit_files(table)
    if not commits:
        raise TableNotFoundError(table.path)
    return commits, _timestamps(table.engine.fs, commits)


def version_at_timestamp(table, timestamp_ms: int,
                         can_return_last_commit: bool = False,
                         can_return_earliest_commit: bool = False) -> int:
    """The latest version committed at or before `timestamp_ms`. A
    timestamp before the earliest commit raises
    `TimestampEarlierThanCommitRetentionError`, one after the newest
    `TimestampLaterThanLatestCommitError`, unless the matching
    `can_return_*` flag asks for the end commit instead."""
    commits, ts = _timed_commits(table)
    best = None
    for fstat, t in zip(commits, ts):
        if t > timestamp_ms:
            break
        best = filenames.delta_version(fstat.path)
    if best is None:
        if can_return_earliest_commit:
            return filenames.delta_version(commits[0].path)
        raise TimestampEarlierThanCommitRetentionError(
            f"timestamp {timestamp_ms} is before the earliest available "
            f"commit (ts {ts[0]})")
    if (best == filenames.delta_version(commits[-1].path)
            and timestamp_ms > ts[-1] and not can_return_last_commit):
        raise TimestampLaterThanLatestCommitError(
            f"timestamp {timestamp_ms} is after the latest commit (ts "
            f"{ts[-1]}); retry with a timestamp <= {ts[-1]}")
    return best


def version_at_or_after_timestamp(table, timestamp_ms: int) -> int:
    """The earliest version committed at or after `timestamp_ms`; a
    timestamp after the newest commit raises
    `TimestampLaterThanLatestCommitError`."""
    commits, ts = _timed_commits(table)
    for fstat, t in zip(commits, ts):
        if t >= timestamp_ms:
            return filenames.delta_version(fstat.path)
    raise TimestampLaterThanLatestCommitError(
        f"timestamp {timestamp_ms} is after the latest commit (ts "
        f"{ts[-1]})", error_class="DELTA_TIMESTAMP_GREATER_THAN_COMMIT")

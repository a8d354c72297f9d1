"""Isolation levels (reference `delta_tpu/txn/isolation.py`).

- SERIALIZABLE: concurrent appends that our read might have seen
  conflict.
- WRITE_SERIALIZABLE: blind appends by winners do not conflict with our
  reads.
- SNAPSHOT_ISOLATION: only write-write conflicts (deletes of the same
  files, metadata or protocol changes) matter.

Data-changing commits default to WRITE_SERIALIZABLE; file-rearranging
commits (OPTIMIZE, dataChange=false) to SNAPSHOT_ISOLATION.
"""

from __future__ import annotations

from enum import Enum


class IsolationLevel(Enum):
    SERIALIZABLE = "Serializable"
    WRITE_SERIALIZABLE = "WriteSerializable"
    SNAPSHOT_ISOLATION = "SnapshotIsolation"


def default_isolation_level(data_changed: bool) -> IsolationLevel:
    return (IsolationLevel.WRITE_SERIALIZABLE if data_changed
            else IsolationLevel.SNAPSHOT_ISOLATION)

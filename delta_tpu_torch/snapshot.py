"""Snapshot: an immutable view of the table at one version.

Counterpart of `delta_tpu/snapshot.py`, cut to the load: state is
reconstructed on first access and cached on the object. `update()`, time
travel and scans come with later slices of the port.
"""

from __future__ import annotations

from typing import Optional

from delta_tpu_torch.log.segment import LogSegment
from delta_tpu_torch.replay.state import SnapshotState, reconstruct_state


class Snapshot:
    def __init__(self, table, segment: LogSegment):
        self._table = table
        self._segment = segment
        self._state: Optional[SnapshotState] = None

    @property
    def version(self) -> int:
        return self._segment.version

    @property
    def state(self) -> SnapshotState:
        if self._state is None:
            self._state = reconstruct_state(self._table.engine, self._segment)
        return self._state

    def __repr__(self):
        return f"Snapshot(path={self._table.path!r}, version={self.version})"

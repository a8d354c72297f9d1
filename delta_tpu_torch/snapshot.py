"""Snapshot: an immutable view of the table at one version.

Counterpart of `delta_tpu/snapshot.py`, cut to the load: state is
reconstructed on first access, through the reference's degradation ladder
and `.crc` quarantine, and cached on the object. `update()`, time travel
by timestamp, the P&M fast path and scans come with later slices of the
port.

The ladder absorbs exactly two shapes of damage, each warned and counted:

- a torn tip commit (`TornCommitError` whose version is the segment's
  newest, above 0) serves the version before it
  (`snapshot.torn_commit_fallbacks`);
- an unreadable checkpoint (`LogCorruptedError` or `OSError` while the
  segment has a checkpoint, other than a vanished commit file) rebuilds
  the segment without it, from the previous complete checkpoint or the
  JSON commits alone (`snapshot.checkpoint_fallbacks`).

Everything else propagates unchanged: a typed refusal
(`UnsupportedLogError`), a kernel's launch failure (`RuntimeError`), the
card's `torch.cuda.OutOfMemoryError`, a wrapper's `ValueError`. A fallback
replaces the snapshot's segment, so `version` reports the version served.
"""

from __future__ import annotations

import logging
import re
from typing import Optional

from delta_tpu_torch import obs
from delta_tpu_torch.errors import (
    ChecksumMismatchError,
    LogCorruptedError,
    TornCommitError,
)
from delta_tpu_torch.log.segment import LogSegment, build_log_segment
from delta_tpu_torch.replay.state import SnapshotState, reconstruct_state

_log = logging.getLogger(__name__)

_CHECKPOINT_FALLBACKS = obs.counter("snapshot.checkpoint_fallbacks")
_TORN_FALLBACKS = obs.counter("snapshot.torn_commit_fallbacks")
_CRC_QUARANTINED = obs.counter("snapshot.crc_quarantined")

# a commit file in a FileNotFoundError message (vs a checkpoint part)
_COMMIT_JSON_RE = re.compile(r"\d{20}\.json")


class Snapshot:
    def __init__(self, table, segment: LogSegment):
        self._table = table
        self._segment = segment
        self._state: Optional[SnapshotState] = None

    @property
    def version(self) -> int:
        return self._segment.version

    @property
    def log_segment(self) -> LogSegment:
        return self._segment

    @property
    def state(self) -> SnapshotState:
        if self._state is None:
            state = self._replay_degrading()
            self._validate_crc(state)
            self._state = state
        return self._state

    def _replay_degrading(self) -> SnapshotState:
        """`reconstruct_state` over the segment, under the ladder (module
        docstring). Each fallback LISTs again; it ends when a segment
        loads, or when the damage is not one the ladder absorbs."""
        engine = self._table.engine
        seg = self._segment
        while True:
            try:
                state = reconstruct_state(engine, seg)
                break
            except TornCommitError as e:
                torn_v = e.context.get("version")
                if torn_v is None or torn_v != seg.version or torn_v <= 0:
                    raise  # below the tip: history itself is damaged
                _TORN_FALLBACKS.inc()
                _log.warning("commit %d of %s has a torn trailing line "
                             "(interrupted write); serving version %d",
                             torn_v, self._table.path, torn_v - 1)
                seg = build_log_segment(engine.fs, seg.log_path,
                                        target_version=torn_v - 1)
            except (LogCorruptedError, OSError) as e:
                if not seg.checkpoints:
                    raise
                if (isinstance(e, FileNotFoundError)
                        and _COMMIT_JSON_RE.search(str(e))):
                    raise  # no checkpoint brings a vanished commit back
                cp_v = seg.checkpoint_version
                _CHECKPOINT_FALLBACKS.inc()
                _log.warning("checkpoint %d of %s unreadable (%s); "
                             "rebuilding from an earlier checkpoint or the "
                             "JSON log", cp_v, self._table.path, e)
                seg = build_log_segment(engine.fs, seg.log_path,
                                        target_version=seg.version,
                                        max_checkpoint_version=cp_v - 1)
        self._segment = seg
        return state

    def _validate_crc(self, state: SnapshotState) -> None:
        """Hold the state to this version's `.crc`, where one is readable.
        A mismatch means the checksum chain lies: warn, count, and reseed
        the file from the replayed state (the log is the truth, the `.crc`
        an accelerator), so the next commit's `.crc` derives from a sound
        one. The load never fails for it: a `.crc` that cannot be read or
        parsed counts as none, as in the reference."""
        from delta_tpu_torch.log.checksum import (
            read_checksum,
            validate_state_against_checksum,
            write_checksum_from_state,
        )

        fs, log_path = self._table.engine.fs, self._table.log_path
        try:
            crc = read_checksum(fs, log_path, state.version)
        except Exception as e:  # any unreadable .crc: no checksum
            _log.debug("checksum read failed at version %d (%s)",
                       state.version, e)
            return
        if crc is None:
            return
        try:
            validate_state_against_checksum(state, crc)
        except ChecksumMismatchError as e:
            _CRC_QUARANTINED.inc()
            _log.warning("checksum at version %d of %s disagrees with the "
                         "replayed state (%s); reseeding it from the state",
                         state.version, self._table.path, e)
            try:
                write_checksum_from_state(fs, log_path, state)
            except OSError as e2:
                _log.warning("checksum reseed at version %d failed: %s",
                             state.version, e2)

    def __repr__(self):
        return f"Snapshot(path={self._table.path!r}, version={self.version})"

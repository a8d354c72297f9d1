"""Snapshot: an immutable view of the table at one version.

Counterpart of `delta_tpu/snapshot.py`: state is reconstructed on first
access, through the reference's degradation ladder and `.crc`
quarantine, and cached on the object; `scan(filter, columns)` plans a
read over it (`scan.py`).

- Metadata accessors (`protocol`, `metadata`, `schema`, `timestamp_ms`,
  ...) take the P&M fast path (`_pm_state`): the full state when loaded,
  else a small state already read, else this version's `.crc` (one small
  read), else the small-action read (`_small_state`: the checkpoint's
  protocol, metaData, txn and domainMetadata columns and the tail's
  control lines, no file action decoded), under the same ladder.
  `snapshot.pm_from_crc` counts the `.crc` answers.
- `update()` LISTs past this version and replays only the new commits on
  top of the retained state (`replay/state.py::advance_state`; K1 parses
  them, `torch.sort` + K2 replay them); `_advanced_with_blobs` does the
  same with commit bytes a transaction hands over. A checkpoint past this
  version, a gap, or a protocol change sends the caller to a full load.

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

import dataclasses
import logging
import re
import time
from typing import Dict, Optional

from delta_tpu_torch import obs
from delta_tpu_torch.errors import (
    ChecksumMismatchError,
    LogCorruptedError,
    TornCommitError,
)
from delta_tpu_torch.log.segment import (
    LogSegment,
    _IncrementalUnavailable,
    build_log_segment,
    extend_log_segment,
)
from delta_tpu_torch.models.actions import (
    DomainMetadata,
    Metadata,
    Protocol,
    SetTransaction,
)
from delta_tpu_torch.replay.state import (
    SmallState,
    SnapshotState,
    advance_state,
    check_read_supported,
    reconstruct_small_state,
    reconstruct_state,
)

_log = logging.getLogger(__name__)

_CHECKPOINT_FALLBACKS = obs.counter("snapshot.checkpoint_fallbacks")
_TORN_FALLBACKS = obs.counter("snapshot.torn_commit_fallbacks")
_CRC_QUARANTINED = obs.counter("snapshot.crc_quarantined")
_PM_FROM_CRC = obs.counter("snapshot.pm_from_crc")
_UPDATE_FALLBACKS = obs.counter("snapshot.update_fallbacks")

# a commit file in a FileNotFoundError message (vs a checkpoint part)
_COMMIT_JSON_RE = re.compile(r"\d{20}\.json")


class Snapshot:
    def __init__(self, table, segment: LogSegment):
        self._table = table
        self._segment = segment
        self._state: Optional[SnapshotState] = None
        self._small: Optional[SmallState] = None
        self._pm: Optional[SmallState] = None  # from the .crc: P&M only

    @property
    def version(self) -> int:
        return self._segment.version

    @property
    def log_segment(self) -> LogSegment:
        return self._segment

    @property
    def table_path(self) -> str:
        return self._table.path

    @property
    def engine(self):
        return self._table.engine

    @property
    def state(self) -> SnapshotState:
        if self._state is None:
            state = self._replay_degrading(reconstruct_state)
            self._validate_crc(state)
            self._state = state
        return self._state

    def _replay_degrading(self, replay_fn):
        """`replay_fn` (the full or the small reconstruction) over the
        segment, under the ladder (module docstring). Each fallback LISTs
        again; it ends when a segment loads, or when the damage is not one
        the ladder absorbs."""
        engine = self._table.engine
        seg = self._segment
        while True:
            try:
                state = replay_fn(engine, seg)
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

    # -- the P&M fast path ---------------------------------------------

    @property
    def _small_state(self):
        """Small actions without the file replay; the full state, once
        loaded, serves as the small state too. A segment without a
        checkpoint has no column to skip, so it loads the full state once
        and serves both."""
        if self._state is not None:
            return self._state
        if self._small is None:
            if not self._segment.checkpoints:
                return self.state
            self._small = self._replay_degrading(reconstruct_small_state)
        return self._small

    @property
    def _pm_state(self):
        """The cheapest protocol and metadata: the full state if loaded,
        else a small state already read, else this version's `.crc` (an
        unreadable one counts as none), else the small read. A `.crc`
        serves protocol, metadata and timestamp only; txn and domain
        accessors always take the small state."""
        if self._state is not None:
            return self._state
        if self._small is not None:
            return self._small
        if self._pm is None:
            from delta_tpu_torch.config import (
                IN_COMMIT_TIMESTAMPS,
                get_table_config,
            )
            from delta_tpu_torch.log.checksum import read_checksum

            try:
                crc = read_checksum(self._table.engine.fs,
                                    self._table.log_path, self.version)
            except Exception as e:  # any unreadable .crc: log replay
                _log.debug("checksum read failed at version %d (%s); "
                           "using log replay", self.version, e)
                crc = None
            if crc is None or (
                    get_table_config(crc.metadata.configuration,
                                     IN_COMMIT_TIMESTAMPS)
                    and crc.inCommitTimestamp is None):
                # no .crc, or one without the ICT of an ICT table (its
                # timestamp feeds the next commit's): the small read
                return self._small_state
            check_read_supported(crc.protocol)
            _PM_FROM_CRC.inc()
            ts = self._segment.last_commit_timestamp
            if crc.inCommitTimestamp is not None:
                ts = crc.inCommitTimestamp
            self._pm = SmallState(
                version=self.version, protocol=crc.protocol,
                metadata=crc.metadata, set_transactions={},
                domain_metadata={}, timestamp_ms=ts)
        return self._pm

    @property
    def protocol(self) -> Protocol:
        return self._pm_state.protocol

    @property
    def metadata(self) -> Metadata:
        return self._pm_state.metadata

    @property
    def schema(self):
        from delta_tpu_torch.models.schema import schema_from_json

        raw = self._pm_state.metadata.schemaString
        return schema_from_json(raw) if raw else None

    @property
    def partition_columns(self) -> list:
        return list(self._pm_state.metadata.partitionColumns)

    @property
    def timestamp_ms(self) -> int:
        """This version's commit timestamp: its in-commit timestamp where
        the commit carries one, else the commit file's mtime."""
        pm = self._pm_state
        ci = pm.commit_infos.get(self.version)
        if ci is not None and ci.inCommitTimestamp is not None:
            return ci.inCommitTimestamp
        return pm.timestamp_ms

    @property
    def num_files(self) -> int:
        return self.state.num_files

    @property
    def size_in_bytes(self) -> int:
        return self.state.size_in_bytes

    def set_transaction_version(self, app_id: str) -> Optional[int]:
        txn = self._small_state.set_transactions.get(app_id)
        return txn.version if txn else None

    def set_transactions(self) -> Dict[str, SetTransaction]:
        return dict(self._small_state.set_transactions)

    def domain_metadata(self, domain: str) -> Optional[DomainMetadata]:
        dm = self._small_state.domain_metadata.get(domain)
        if dm is None or dm.removed:
            return None
        return dm

    def table_configuration(self) -> Dict[str, str]:
        return dict(self._pm_state.metadata.configuration)

    def get_config(self, key: str, default=None):
        """A table property, parsed where this package knows it (its
        default when unset), else the raw string or `default`."""
        from delta_tpu_torch.config import TABLE_CONFIGS

        cfg = TABLE_CONFIGS.get(key)
        raw = self._pm_state.metadata.configuration.get(key)
        if cfg is not None:
            if raw is not None:
                return cfg.parse(raw)
            return cfg.default if default is None else default
        return raw if raw is not None else default

    # -- incremental maintenance -----------------------------------------

    def update(self) -> Optional["Snapshot"]:
        """Advance to the latest version: LIST only past this version,
        parse just the new commits and replay them on top of this
        snapshot's retained state. Returns `self` when nothing is new (one
        LIST, no read), a new Snapshot when commits appended cleanly, or
        None when the advance is unavailable (a checkpoint or compacted
        delta past this version, a listing gap, or a protocol change): the
        caller then loads in full. The advanced state is the state a cold
        load of the new segment builds."""
        engine = self._table.engine
        try:
            ext = extend_log_segment(engine.fs, self._segment)
        except _IncrementalUnavailable as e:
            _UPDATE_FALLBACKS.inc()
            _log.debug("incremental update of %s unavailable (%s)",
                       self._table.path, e)
            return None
        if ext is None:
            return self
        new_segment, new_deltas = ext
        advanced = self._update_advance(engine, new_segment, new_deltas)
        if advanced is None:
            _UPDATE_FALLBACKS.inc()
        return advanced

    def _update_advance(self, engine, new_segment, new_deltas):
        if self._state is None:
            # no replayed state to advance: a lazy snapshot of the new
            # segment costs what advancing would
            return Snapshot(self._table, new_segment)
        from delta_tpu_torch.replay.columnar import columnarize_log_segment

        delta_seg = dataclasses.replace(new_segment, deltas=new_deltas,
                                        checkpoints=[], compacted_deltas=[],
                                        checkpoint_version=None)
        delta = columnarize_log_segment(engine, delta_seg)
        if delta.protocol is not None:
            # a protocol change can alter how earlier actions are read
            return None
        return self._advanced(advance_state(engine, self._state, delta,
                                            new_segment), new_segment)

    def _advanced(self, state: SnapshotState, segment) -> "Snapshot":
        snap = Snapshot(self._table, segment)
        snap._state = state
        return snap

    def _advanced_with_blobs(self, blobs) -> Optional["Snapshot"]:
        """Advance with commit bytes already in memory, `[(version,
        bytes)]` contiguous from `self.version + 1` (the post-commit
        handoff: the commit a transaction just wrote is never listed or
        read back). None when this snapshot cannot host the advance: no
        retained state, a version gap, or a protocol change."""
        if self._state is None:
            return None
        versions = [v for v, _ in blobs]
        if not versions or versions != list(
                range(self.version + 1, self.version + 1 + len(blobs))):
            return None
        from delta_tpu_torch.replay.columnar import columnarize_commit_blobs
        from delta_tpu_torch.storage.local import FileStatus
        from delta_tpu_torch.utils import filenames

        engine = self._table.engine
        delta = columnarize_commit_blobs(engine, blobs)
        if delta.protocol is not None:
            return None
        files = []
        ts = self._segment.last_commit_timestamp
        for v, data in blobs:
            path = filenames.delta_file(self._table.log_path, v)
            try:
                mtime = engine.fs.file_status(path).modification_time
            except OSError:
                mtime = int(time.time() * 1000)
            files.append(FileStatus(path, len(data), mtime))
            ts = max(ts, mtime)
        segment = dataclasses.replace(
            self._segment, version=versions[-1],
            deltas=list(self._segment.deltas) + files,
            last_commit_timestamp=ts)
        return self._advanced(advance_state(engine, self._state, delta,
                                            segment), segment)

    # -- scans -----------------------------------------------------------

    def scan_builder(self):
        from delta_tpu_torch.scan import ScanBuilder

        return ScanBuilder(self)

    def scan(self, filter=None, columns=None):
        """A scan of this version: partition pruning and data skipping by
        `filter`, the rows of `columns` (all when None) on read."""
        b = self.scan_builder()
        if filter is not None:
            b = b.with_filter(filter)
        if columns is not None:
            b = b.with_columns(columns)
        return b.build()

    def __repr__(self):
        return f"Snapshot(path={self._table.path!r}, version={self.version})"

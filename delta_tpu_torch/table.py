"""Table: the entry point handle for a Delta table at a path.

Counterpart of `delta_tpu/table.py` without coordinated commits:
`for_path`, `exists`, `latest_snapshot`, `update`, `notify_commit`,
`snapshot_at`, `snapshot_as_of_timestamp`, `history`,
`create_transaction_builder`, `optimize`, `vacuum` and `checkpoint`.

The table keeps its newest snapshot. `latest_snapshot()` LISTs from the
`_last_checkpoint` hint and serves the cached snapshot while the version
is unchanged; `update()` advances the cached snapshot by the new commits
alone (`Snapshot.update`), and `notify_commit` by the bytes of a commit
this process just wrote, so that the post-commit hooks and the next poll
do not read it back.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from delta_tpu_torch import obs
from delta_tpu_torch.engine import TorchEngine
from delta_tpu_torch.errors import CheckpointError, DeltaError, TableNotFoundError
from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint
from delta_tpu_torch.log.segment import build_log_segment
from delta_tpu_torch.snapshot import Snapshot
from delta_tpu_torch.utils import filenames

_log = logging.getLogger(__name__)
_RESEED_FAILURES = obs.counter("checkpoint.checksum_reseed_failures")
_NOTIFY_ADVANCES = obs.counter("table.notify_advances")
_NOTIFY_FAILURES = obs.counter("table.notify_failures")


class Table:
    def __init__(self, path: str, engine=None):
        self.path = path.rstrip("/")
        self.engine = engine if engine is not None else TorchEngine()
        self.log_path = f"{self.path}/{filenames.LOG_DIR_NAME}"
        self._lock = threading.Lock()
        self._cached_snapshot: Optional[Snapshot] = None

    @staticmethod
    def for_path(path: str, engine=None) -> "Table":
        return Table(path, engine)

    def exists(self) -> bool:
        """Whether a readable `_delta_log` is here (a missing log and a
        malformed listing both answer no)."""
        try:
            build_log_segment(self.engine.fs, self.log_path)
            return True
        except (DeltaError, OSError):
            return False

    def latest_snapshot(self) -> Snapshot:
        """LIST the log from the `_last_checkpoint` hint and return the
        newest snapshot (its state loads on first access); the cached
        snapshot when the version is unchanged."""
        hint = read_last_checkpoint(self.engine.fs, self.log_path)
        segment = build_log_segment(
            self.engine.fs, self.log_path,
            checkpoint_hint=hint.version if hint else None)
        with self._lock:
            cached = self._cached_snapshot
            if cached is not None and cached.version == segment.version:
                return cached
            snap = Snapshot(self, segment)
            self._cached_snapshot = snap
            return snap

    def update(self) -> Snapshot:
        """The latest snapshot, advancing the cached one by the new
        commits alone where it can (`Snapshot.update`); a full
        `latest_snapshot()` load when there is no cached snapshot or the
        advance is unavailable (a checkpoint past it, a listing gap, a
        protocol change)."""
        with self._lock:
            cached = self._cached_snapshot
        if cached is None:
            return self.latest_snapshot()
        advanced = cached.update()
        if advanced is None:
            return self.latest_snapshot()
        if advanced is not cached:
            with self._lock:
                cur = self._cached_snapshot
                if cur is None or cur.version <= advanced.version:
                    self._cached_snapshot = advanced
                else:
                    advanced = cur  # a racing load got further
        return advanced

    def notify_commit(self, version: int, data: bytes) -> None:
        """The post-commit handoff: a transaction that just wrote commit
        `version` gives its bytes to the cached snapshot, which advances
        without listing or reading them (`table.notify_advances`). Best
        effort: a failure leaves the cache as it was, and the next
        `update()` lists as usual (`table.notify_failures`). Never
        raises."""
        try:
            with self._lock:
                cached = self._cached_snapshot
            if (cached is None or cached.version != version - 1
                    or cached._state is None):
                return
            advanced = cached._advanced_with_blobs([(version, data)])
            if advanced is None:
                return
            with self._lock:
                if self._cached_snapshot is cached:
                    self._cached_snapshot = advanced
                    _NOTIFY_ADVANCES.inc()
        except Exception:  # the handoff only saves a read
            _NOTIFY_FAILURES.inc()
            _log.warning("post-commit advance of %s to version %d failed; "
                         "the next update() lists", self.path, version,
                         exc_info=True)

    def snapshot_at(self, version: int) -> Snapshot:
        """The snapshot at `version` (`VersionNotFoundError` when the log
        cannot reproduce it), listed from the `_last_checkpoint` hint when
        the hint is at or below `version`, and again without it when that
        listing fails."""
        hint = read_last_checkpoint(self.engine.fs, self.log_path)
        cp_hint = hint.version if hint and hint.version <= version else None
        try:
            segment = build_log_segment(self.engine.fs, self.log_path,
                                        target_version=version,
                                        checkpoint_hint=cp_hint)
        except DeltaError as e:
            if cp_hint is None:
                raise
            _log.debug("hinted listing for version %d failed (%s); "
                       "listing from version 0", version, e)
            segment = build_log_segment(self.engine.fs, self.log_path,
                                        target_version=version)
        return Snapshot(self, segment)

    def snapshot_as_of_timestamp(self, timestamp_ms: int) -> Snapshot:
        """The snapshot of the latest version committed at or before
        `timestamp_ms` (`history.py::version_at_timestamp`)."""
        from delta_tpu_torch.history import version_at_timestamp

        return self.snapshot_at(version_at_timestamp(self, timestamp_ms))

    def history(self, limit: Optional[int] = None):
        """Commit records, newest first (`history.py::get_history`)."""
        from delta_tpu_torch.history import get_history

        return get_history(self, limit)

    def checkpoint(self, version: Optional[int] = None) -> None:
        """Write a checkpoint of `version` (default: the latest), reusing
        the unchanged parts the previous `_last_checkpoint` names, then
        reseed the `.crc` chain from the checkpointed state; a failed
        reseed is counted (`checkpoint.checksum_reseed_failures`), the
        checkpoint stands."""
        from delta_tpu_torch.log.checkpointer import write_checkpoint
        from delta_tpu_torch.log.checksum import write_checksum_from_state

        try:
            snap = (self.latest_snapshot() if version is None
                    else self.snapshot_at(version))
        except TableNotFoundError as e:
            raise CheckpointError(
                f"cannot checkpoint a non-existent table: {e}") from e
        write_checkpoint(self.engine, snap, prev_info=read_last_checkpoint(
            self.engine.fs, self.log_path))
        try:
            write_checksum_from_state(self.engine.fs, self.log_path,
                                      snap.state)
        except OSError as e:
            _RESEED_FAILURES.inc()
            _log.warning("checksum reseed after the checkpoint of %s at "
                         "%d failed: %s", self.path, snap.version, e)

    def create_transaction_builder(self, operation: str = "WRITE"):
        from delta_tpu_torch.txn.transaction import TransactionBuilder

        return TransactionBuilder(self, operation)

    def optimize(self):
        """`OPTIMIZE`: `.execute_compaction(...)` or
        `.execute_zorder_by(*columns, curve=..., max_file_size=...)`."""
        from delta_tpu_torch.commands.optimize import OptimizeBuilder

        return OptimizeBuilder(self)

    def vacuum(self, retention_hours: Optional[float] = None,
               dry_run: bool = False, inventory=None,
               vacuum_type: str = "FULL"):
        """`VACUUM` (`commands/vacuum.py`): delete the files the table no
        longer references past the retention window."""
        from delta_tpu_torch.commands.vacuum import vacuum

        return vacuum(self, retention_hours=retention_hours,
                      dry_run=dry_run, inventory=inventory,
                      vacuum_type=vacuum_type)

    def __repr__(self):
        return f"Table({self.path!r})"

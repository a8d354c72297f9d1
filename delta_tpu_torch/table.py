"""Table: the entry point handle for a Delta table at a path.

Counterpart of `delta_tpu/table.py`, cut to `for_path`, `exists`,
`latest_snapshot`, `snapshot_at`, `create_transaction_builder`,
`optimize` and `checkpoint`.
"""

from __future__ import annotations

import logging
from typing import Optional

from delta_tpu_torch import obs
from delta_tpu_torch.engine import TorchEngine
from delta_tpu_torch.errors import CheckpointError, DeltaError, TableNotFoundError
from delta_tpu_torch.log.segment import build_log_segment
from delta_tpu_torch.snapshot import Snapshot
from delta_tpu_torch.utils import filenames

_log = logging.getLogger(__name__)
_RESEED_FAILURES = obs.counter("checkpoint.checksum_reseed_failures")


class Table:
    def __init__(self, path: str, engine=None):
        self.path = path.rstrip("/")
        self.engine = engine if engine is not None else TorchEngine()
        self.log_path = f"{self.path}/{filenames.LOG_DIR_NAME}"

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
        """LIST the log and return the newest snapshot (its state loads on
        first access)."""
        return Snapshot(self, build_log_segment(self.engine.fs, self.log_path))

    def snapshot_at(self, version: int) -> Snapshot:
        """The snapshot at `version` (`VersionNotFoundError` when the log
        cannot reproduce it)."""
        return Snapshot(self, build_log_segment(self.engine.fs, self.log_path,
                                                target_version=version))

    def checkpoint(self, version: Optional[int] = None) -> None:
        """Write a checkpoint of `version` (default: the latest), then
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
        write_checkpoint(self.engine, snap)
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

    def __repr__(self):
        return f"Table({self.path!r})"

"""Table: the entry point handle for a Delta table at a path.

Counterpart of `delta_tpu/table.py`, cut to `for_path`, `exists`,
`latest_snapshot`, `create_transaction_builder` and `optimize`.
"""

from __future__ import annotations

from delta_tpu_torch.engine import TorchEngine
from delta_tpu_torch.errors import DeltaError
from delta_tpu_torch.log.segment import build_log_segment
from delta_tpu_torch.snapshot import Snapshot
from delta_tpu_torch.utils import filenames


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

"""Table: the entry point handle for a Delta table at a path.

Counterpart of `delta_tpu/table.py`, cut to `for_path` and
`latest_snapshot`.
"""

from __future__ import annotations

from delta_tpu_torch.engine import TorchEngine
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

    def latest_snapshot(self) -> Snapshot:
        """LIST the log and return the newest snapshot (its state loads on
        first access)."""
        return Snapshot(self, build_log_segment(self.engine.fs, self.log_path))

    def __repr__(self):
        return f"Table({self.path!r})"

"""Table properties (`delta.*` keys in `Metadata.configuration`) that the
write path reads.

Counterpart of `delta_tpu/config.py`, cut to those keys, with the same
defaults and parsing (a boolean is true only for "true", any case).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

from delta_tpu_torch.errors import InvalidTablePropertyError


def _parse_bool(s: str) -> bool:
    return s.strip().lower() == "true"


def _parse_isolation(s: str) -> str:
    lv = s.strip()
    if lv not in ("Serializable", "WriteSerializable", "SnapshotIsolation"):
        raise InvalidTablePropertyError(
            f"invalid delta.isolationLevel {s!r}",
            error_class="DELTA_INVALID_ISOLATION_LEVEL")
    return lv


@dataclass(frozen=True)
class TableConfig:
    key: str
    default: Any
    parse: Callable[[str], Any]


DATA_SKIPPING_NUM_INDEXED_COLS = TableConfig(
    "delta.dataSkippingNumIndexedCols", 32, int)
DATA_SKIPPING_STATS_COLUMNS = TableConfig(
    "delta.dataSkippingStatsColumns", None,
    lambda s: [c.strip() for c in s.split(",")])
APPEND_ONLY = TableConfig("delta.appendOnly", False, _parse_bool)
ISOLATION_LEVEL = TableConfig("delta.isolationLevel", "WriteSerializable",
                              _parse_isolation)
RANDOMIZE_FILE_PREFIXES = TableConfig("delta.randomizeFilePrefixes", False,
                                      _parse_bool)
RANDOM_PREFIX_LENGTH = TableConfig("delta.randomPrefixLength", 2, int)
DELETION_VECTORS_ENABLED = TableConfig("delta.enableDeletionVectors", False,
                                       _parse_bool)
COLUMN_MAPPING_MODE = TableConfig("delta.columnMapping.mode", "none", str)
IN_COMMIT_TIMESTAMPS = TableConfig("delta.enableInCommitTimestamps", False,
                                   _parse_bool)
ROW_TRACKING_ENABLED = TableConfig("delta.enableRowTracking", False,
                                   _parse_bool)
COORDINATED_COMMITS_COORDINATOR = TableConfig(
    "delta.coordinatedCommits.commitCoordinator-preview", None, str)


def get_table_config(configuration: Dict[str, str], cfg: TableConfig):
    raw = configuration.get(cfg.key)
    if raw is None:
        return cfg.default
    return cfg.parse(raw)

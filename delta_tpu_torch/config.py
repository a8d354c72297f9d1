"""Table properties (`delta.*` keys in `Metadata.configuration`) that the
write path, the checkpoint writer and the post-commit hooks read, and the
process-wide settings they consult.

Counterpart of `delta_tpu/config.py`, cut to those keys, with the same
defaults and parsing (a boolean is true only for "true", any case; a
duration is "interval <n> <unit>" or a plain millisecond count).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from delta_tpu_torch.errors import InvalidTablePropertyError

_DAY_MS = 86_400_000
_UNIT_MS = {"millisecond": 1, "second": 1000, "minute": 60_000,
            "hour": 3_600_000, "day": _DAY_MS, "week": 7 * _DAY_MS}


def _parse_bool(s: str) -> bool:
    return s.strip().lower() == "true"


def _parse_interval_ms(s: str) -> int:
    """'interval <n> <unit>' (Spark's CalendarInterval subset) or a plain
    millisecond count."""
    s = s.strip().lower()
    if not s.startswith("interval"):
        return int(s)
    parts = s.split()
    if len(parts) < 2:
        raise InvalidTablePropertyError(
            "interval value is empty; expected 'interval <n> <unit>'",
            error_class="DELTA_INVALID_CALENDAR_INTERVAL_EMPTY")
    unit = parts[2].rstrip("s") if len(parts) > 2 else "millisecond"
    try:
        return int(float(parts[1]) * _UNIT_MS[unit])
    except (ValueError, KeyError):
        raise InvalidTablePropertyError(
            f"invalid interval {s!r}; expected 'interval <n> "
            f"<{'|'.join(_UNIT_MS)}>'",
            error_class="DELTA_INVALID_INTERVAL") from None


def _parse_formats(s: str):
    out = [f.strip().lower() for f in s.split(",") if f.strip()]
    bad = [f for f in out if f not in ("iceberg", "hudi")]
    if bad:
        raise ValueError(
            f"invalid delta.universalFormat.enabledFormats entries {bad}")
    return out


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
CHANGE_DATA_FEED = TableConfig("delta.enableChangeDataFeed", False,
                               _parse_bool)
# the legacy alias, honoured wherever the flag is (`cdf_enabled`)
CHANGE_DATA_CAPTURE = TableConfig("delta.enableChangeDataCapture", False,
                                  _parse_bool)
COLUMN_MAPPING_MODE = TableConfig("delta.columnMapping.mode", "none", str)
IN_COMMIT_TIMESTAMPS = TableConfig("delta.enableInCommitTimestamps", False,
                                   _parse_bool)
ROW_TRACKING_ENABLED = TableConfig("delta.enableRowTracking", False,
                                   _parse_bool)
COORDINATED_COMMITS_COORDINATOR = TableConfig(
    "delta.coordinatedCommits.commitCoordinator-preview", None, str)
# checkpoints, metadata cleanup and post-commit hooks
LOG_RETENTION = TableConfig("delta.logRetentionDuration", 30 * _DAY_MS,
                            _parse_interval_ms)
CHECKPOINT_RETENTION = TableConfig("delta.checkpointRetentionDuration",
                                   2 * _DAY_MS, _parse_interval_ms)
CHECKPOINT_INTERVAL = TableConfig("delta.checkpointInterval", 10, int)
TOMBSTONE_RETENTION = TableConfig("delta.deletedFileRetentionDuration",
                                  7 * _DAY_MS, _parse_interval_ms)
CHECKPOINT_POLICY = TableConfig("delta.checkpointPolicy", "classic", str)
CHECKPOINT_WRITE_STATS_AS_JSON = TableConfig(
    "delta.checkpoint.writeStatsAsJson", True, _parse_bool)
CHECKPOINT_WRITE_STATS_AS_STRUCT = TableConfig(
    "delta.checkpoint.writeStatsAsStruct", False, _parse_bool)
SET_TXN_RETENTION = TableConfig("delta.setTransactionRetentionDuration",
                                None, _parse_interval_ms)
AUTO_OPTIMIZE_AUTO_COMPACT = TableConfig("delta.autoOptimize.autoCompact",
                                         False, _parse_bool)
AUTO_OPTIMIZE_LEGACY = TableConfig("delta.autoOptimize", False, _parse_bool)
UNIFORM_ENABLED_FORMATS = TableConfig("delta.universalFormat.enabledFormats",
                                      [], _parse_formats)
SYMLINK_MANIFEST_ENABLED = TableConfig(
    "delta.compatibility.symlinkFormatManifest.enabled", False, _parse_bool)


# every table property this package parses, by key (`Snapshot.get_config`)
TABLE_CONFIGS: Dict[str, TableConfig] = {
    c.key: c for c in globals().values() if isinstance(c, TableConfig)}


def get_table_config(configuration: Dict[str, str], cfg: TableConfig):
    raw = configuration.get(cfg.key)
    if raw is None:
        return cfg.default
    return cfg.parse(raw)


def cdf_enabled(configuration: Dict[str, str]) -> bool:
    """The change data feed on: `delta.enableChangeDataFeed` or its legacy
    alias `delta.enableChangeDataCapture`."""
    return (get_table_config(configuration, CHANGE_DATA_FEED)
            or get_table_config(configuration, CHANGE_DATA_CAPTURE))


@dataclass
class Settings:
    """Process-wide settings (the reference's `Settings`, cut to the one
    the checkpoint writer reads)."""

    checkpoint_part_size: Optional[int] = None  # file actions per part


settings = Settings()

"""Errors raised on the snapshot load.

Counterpart of `delta_tpu/errors.py`, cut to the classes this package
raises. Each error carries the same stable ``error_class`` string as the
JAX package, so callers can match on class rather than message text.
"""

from __future__ import annotations


class DeltaError(Exception):
    """Base class of every error this package raises."""

    error_class: str = "DELTA_ERROR"

    def __init__(self, message: str = "", error_class: str = None,
                 **context):
        super().__init__(message)
        if error_class is not None:
            self.error_class = error_class
        self.context = context


class TableNotFoundError(DeltaError):
    error_class = "DELTA_TABLE_NOT_FOUND"


class UnsupportedTableFeatureError(DeltaError):
    """Protocol requires a reader feature this client does not implement."""

    error_class = "DELTA_UNSUPPORTED_FEATURES_FOR_READ"

    def __init__(self, features):
        super().__init__(
            f"Unsupported Delta table features for read: {sorted(features)}",
            features=sorted(features))
        self.features = frozenset(features)


class LogCorruptedError(DeltaError):
    error_class = "DELTA_LOG_FILE_MALFORMED"


class CorruptLogError(DeltaError):
    """The listing cannot form a segment (a gap in the commit versions)."""

    error_class = "DELTA_CORRUPT_LOG"


class UnsupportedLogError(DeltaError):
    """The log needs a reader this package does not have yet: a V2
    checkpoint (UUID-named, sidecars), a compacted delta in the segment, a
    checkpoint part in a codec other than snappy or none (ZSTD among
    them), or add stats held only as `stats_parsed` structs. The load
    stops here instead of replaying around what it cannot read."""

    error_class = "DELTA_UNSUPPORTED_LOG_SEGMENT"

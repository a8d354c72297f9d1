"""Errors raised by the snapshot load and the write path.

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


class TornCommitError(LogCorruptedError):
    """The newest commit file ends in a torn (partially written) JSON
    line, every earlier line of it intact: the mark of an interrupted
    writer on a store without atomic puts, not of damage below the tip.
    `context["version"]` is the torn version; the snapshot serves the one
    before it."""

    error_class = "DELTA_TORN_COMMIT"


class CorruptLogError(DeltaError):
    """The listing cannot form a segment (a gap in the commit versions)."""

    error_class = "DELTA_CORRUPT_LOG"


class UnsupportedLogError(DeltaError):
    """The log needs a reader this package does not have yet: a
    checkpoint part or sidecar in a codec the Parquet readers lack (LZ4,
    LZ4_RAW, BROTLI, LZO) or with columns outside their scope. The load
    stops here instead of replaying around what it cannot read."""

    error_class = "DELTA_UNSUPPORTED_LOG_SEGMENT"


class UnsupportedTableError(DeltaError):
    """The table or the request needs a write-path feature this package
    does not implement yet (a clustered table, in-commit timestamps, row
    tracking, coordinated or group commit, domain writes, writer
    features beyond those of `features.py`, a type outside the
    protocol's). The command stops before it writes anything a commit
    would reference."""

    error_class = "DELTA_UNSUPPORTED_FEATURES_FOR_WRITE"


class InvalidArgumentError(DeltaError):
    error_class = "DELTA_ILLEGAL_ARGUMENT"


class InvalidTablePropertyError(DeltaError):
    error_class = "DELTA_INVALID_TABLE_PROPERTY"


class OptimizeArgumentError(DeltaError):
    error_class = "DELTA_OPTIMIZE_INVALID_ARGUMENT"


class TimeTravelArgumentError(DeltaError):
    error_class = "DELTA_INVALID_TIME_TRAVEL_SPEC"


class PathExistsError(DeltaError):
    error_class = "DELTA_PATH_EXISTS"


class FileNotFoundInLogError(DeltaError):
    error_class = "DELTA_FILE_NOT_FOUND_DETAILED"


class DataFileCorruptedError(DeltaError):
    """A data file the log references holds bytes that no sound Parquet
    file holds (a truncated page, a broken footer or codec stream);
    `context["path"]` names it. The reference surfaces Arrow's error
    there."""

    error_class = "FAILED_READ_FILE"


class InvariantViolationError(DeltaError):
    """NOT NULL constraint violated by written data."""

    error_class = "DELTA_VIOLATE_CONSTRAINT"


class SchemaMismatchError(DeltaError):
    error_class = "DELTA_SCHEMA_MISMATCH"


class MaxCommitRetriesExceededError(DeltaError):
    error_class = "DELTA_MAX_COMMIT_RETRIES_EXCEEDED"


class ConcurrentModificationError(DeltaError):
    """A concurrent commit conflicts with this transaction."""

    error_class = "DELTA_CONCURRENT_MODIFICATION"


class ProtocolChangedError(ConcurrentModificationError):
    error_class = "DELTA_PROTOCOL_CHANGED"


class MetadataChangedError(ConcurrentModificationError):
    error_class = "DELTA_METADATA_CHANGED"


class ConcurrentAppendError(ConcurrentModificationError):
    error_class = "DELTA_CONCURRENT_APPEND"


class ConcurrentDeleteReadError(ConcurrentModificationError):
    error_class = "DELTA_CONCURRENT_DELETE_READ"


class ConcurrentDeleteDeleteError(ConcurrentModificationError):
    error_class = "DELTA_CONCURRENT_DELETE_DELETE"


class ConcurrentTransactionError(ConcurrentModificationError):
    error_class = "DELTA_CONCURRENT_TRANSACTION"


class VersionNotFoundError(DeltaError):
    """The requested version is outside the reconstructable range."""

    error_class = "DELTA_VERSION_NOT_FOUND"

    def __init__(self, version=None, earliest=None, latest=None):
        super().__init__(
            f"Cannot time travel Delta table to version {version}. "
            f"Available versions: [{earliest}, {latest}].",
            version=version, earliest=earliest, latest=latest)


class ChecksumMismatchError(DeltaError):
    """Replayed state disagrees with the `.crc` version checksum, or a
    checkpoint's rows with its snapshot."""

    error_class = "DELTA_CHECKSUM_MISMATCH"


class TimestampEarlierThanCommitRetentionError(DeltaError):
    """Time travel to a timestamp before the earliest commit."""

    error_class = "DELTA_TIMESTAMP_EARLIER_THAN_COMMIT_RETENTION"


class TimestampLaterThanLatestCommitError(DeltaError):
    """Time travel to a timestamp after the newest commit."""

    error_class = "DELTA_TIMESTAMP_GREATER_THAN_COMMIT"


class CheckpointError(DeltaError):
    error_class = "DELTA_CHECKPOINT_NON_EXIST_TABLE"


class MissingTransactionLogError(DeltaError):
    error_class = "DELTA_MISSING_TRANSACTION_LOG"


class AppendOnlyTableError(DeltaError):
    """DELETE or UPDATE on a delta.appendOnly table."""

    error_class = "DELTA_CANNOT_MODIFY_APPEND_ONLY"


class IdentityColumnError(DeltaError):
    error_class = "DELTA_IDENTITY_COLUMNS_ILLEGAL_OPERATION"


class ConstraintAlreadyExistsError(DeltaError):
    error_class = "DELTA_CONSTRAINT_ALREADY_EXISTS"


class ConstraintNotFoundError(DeltaError):
    error_class = "DELTA_CONSTRAINT_DOES_NOT_EXIST"


class DeletionVectorError(DeltaError):
    """A deletion vector that cannot be read as its descriptor says: a bad
    magic or cookie, a checksum, size or cardinality mismatch, or a
    storage type with no path."""

    error_class = "DELTA_DELETION_VECTOR_INVALID"


class InvalidProtocolVersionError(DeltaError):
    error_class = "DELTA_INVALID_PROTOCOL_VERSION"


class SchemaEvolutionError(DeltaError):
    """A schema change ALTER TABLE refuses (a non-nullable added column,
    RENAME or DROP without column mapping, a partition column or the last
    column dropped, a column a CHECK constraint or a generated column
    depends on); `error_class` names which."""

    error_class = "DELTA_UNSUPPORTED_SCHEMA_EVOLUTION"


class ColumnMappingError(DeltaError):
    error_class = "DELTA_UNSUPPORTED_COLUMN_MAPPING_OPERATION"


class ColumnMappingModeChangeError(ColumnMappingError):
    error_class = "DELTA_UNSUPPORTED_COLUMN_MAPPING_MODE_CHANGE"


class NonExistentColumnError(DeltaError):
    """A filter, a projection or a command names a column the table's
    schema lacks (names resolve case-sensitively)."""

    error_class = "DELTA_COLUMN_NOT_FOUND"


class UnresolvedColumnError(DeltaError):
    """A write's `replace_where` names a column the table's schema lacks;
    raised with the error class DELTA_CANNOT_RESOLVE_COLUMN, as the
    reference's `write_table` raises it."""

    error_class = "DELTA_UNRESOLVED_COLUMN"


class DuplicateColumnError(DeltaError):
    error_class = "DELTA_DUPLICATE_COLUMNS_FOUND"


class VacuumRetentionError(DeltaError):
    """A VACUUM retention the check refuses (a negative one)."""

    error_class = "DELTA_UNSAFE_VACUUM_RETENTION"


class VacuumLiteError(DeltaError):
    """VACUUM LITE cannot prove completeness: log cleanup removed commits
    that no earlier vacuum scanned."""

    error_class = "DELTA_CANNOT_VACUUM_LITE"


class RestoreTargetError(DeltaError):
    error_class = "DELTA_CANNOT_RESTORE_TABLE_VERSION"


class ConvertTargetError(DeltaError):
    error_class = "DELTA_CONVERSION_UNSUPPORTED_SOURCE"


class FeatureDropError(DeltaError):
    """DROP FEATURE's preconditions are not met (the
    `DELTA_FEATURE_DROP_*` family)."""

    error_class = "DELTA_FEATURE_DROP_UNSUPPORTED_CLIENT_FEATURE"


class FeatureDropHistoricalVersionsExistError(FeatureDropError):
    error_class = "DELTA_FEATURE_DROP_HISTORICAL_VERSIONS_EXIST"


class CloneTargetExistsError(DeltaError):
    error_class = "DELTA_CLONE_AMBIGUOUS_TARGET"


class CdcNotEnabledError(DeltaError):
    """A change data feed read of a table whose feed is off."""

    error_class = "DELTA_CHANGE_TABLE_FEED_DISABLED"


class SqlParseError(DeltaError):
    """SQL text failed to tokenize or parse (the reference's
    `DELTA_PARSE_SYNTAX_ERROR` family)."""

    error_class = "DELTA_PARSE_SYNTAX_ERROR"


class AmbiguousColumnError(DeltaError):
    error_class = "DELTA_AMBIGUOUS_COLUMN"


class UnsupportedSqlError(DeltaError):
    """Valid-looking SQL that uses a construct this package does not run;
    the message names the construct."""

    error_class = "DELTA_UNSUPPORTED_SQL"


class SubqueryShapeError(DeltaError):
    """A scalar or IN subquery returned the wrong shape."""

    error_class = "DELTA_INVALID_SUBQUERY"


class CatalogTableError(DeltaError):
    error_class = "DELTA_CATALOG_TABLE_ERROR"

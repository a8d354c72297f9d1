"""Optimistic transactions: read-tracked, conflict-checked commits.

Counterpart of `delta_tpu/txn/transaction.py:73-747`, cut to what
OPTIMIZE and a plain append need:

    txn = table.create_transaction_builder("OPTIMIZE").build()
    files = txn.scan_files()           # a whole-table read, tracked
    files = txn.scan_files(filter=p)   # a predicate read, tracked
    txn.remove_file(...); txn.add_files([...])
    txn.add_cdc_file(...)              # a change data file (CDF tables)
    result = txn.commit()

The commit serializes the actions (commitInfo first), writes `N+1.json`
with a put-if-absent (and hands the bytes to the table's cached snapshot,
`Table.notify_commit`), and on `FileExistsError` reads the winning
commits: a winner carrying our own `txnId` is our own landed commit;
otherwise `check_conflicts` either raises a typed
`ConcurrentModificationError` or the transaction rebases and retries at
the next version, up to `MAX_COMMIT_RETRIES` times
(`MaxCommitRetriesExceededError`). After a successful commit the
post-commit hooks run (`hooks.py`: the `.crc` checksum, the checkpoint
every `delta.checkpointInterval` commits, auto-compaction), best-effort:
a failing hook is counted and logged, and the commit stands.

A table created with `delta.columnMapping.mode` gets its fields' ids
and physical names (`columnmapping.py::assign_column_mapping`) in its
first metadata, and a mapped table may name columns with ' ,;{}()\n\t='.
Every staged metadata passes `colgen.py::validate_generated_schema`; a
new table's protocol carries the features its properties and its
schema's generated, identity and default columns turn on. An identity
write's moved watermark is a metadata action, so of two concurrent
writes to an identity column the later loses with
`MetadataChangedError`.

Refused with `UnsupportedTableError`, before anything is written: group
commit, coordinated commits, in-commit timestamps, row tracking, domain
writes, the writer features `features.py::unsupported_writer_features`
names, and tables that ask for the UniForm (Iceberg/Hudi) hooks, which
are not ported.
"""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from delta_tpu_torch.colgen import validate_generated_schema
from delta_tpu_torch.columnmapping import assign_column_mapping, is_mapped
from delta_tpu_torch.config import (
    APPEND_ONLY,
    COORDINATED_COMMITS_COORDINATOR,
    IN_COMMIT_TIMESTAMPS,
    ISOLATION_LEVEL,
    ROW_TRACKING_ENABLED,
    UNIFORM_ENABLED_FORMATS,
    get_table_config,
)
from delta_tpu_torch.errors import (
    ConcurrentTransactionError,
    InvalidArgumentError,
    MaxCommitRetriesExceededError,
    TableNotFoundError,
    UnsupportedTableError,
)
from delta_tpu_torch import features
from delta_tpu_torch.hooks import run_post_commit_hooks
from delta_tpu_torch.models.actions import (
    AddCDCFile,
    AddFile,
    CommitInfo,
    Metadata,
    Protocol,
    RemoveFile,
    SetTransaction,
    actions_from_commit_bytes,
    actions_to_commit_bytes,
)
from delta_tpu_torch.models.schema import (
    StructType,
    check_writable,
    schema_from_json,
    schema_to_json,
)
from delta_tpu_torch.txn.conflict import (
    TransactionReadState,
    WinningCommit,
    check_conflicts,
)
from delta_tpu_torch.txn.isolation import IsolationLevel, default_isolation_level
from delta_tpu_torch.utils import filenames

ENGINE_INFO = "delta-tpu-torch"
MAX_COMMIT_RETRIES = 200
_INVALID_NAME_CHARS = " ,;{}()\n\t="


class Operation:
    WRITE = "WRITE"
    CREATE_TABLE = "CREATE TABLE"
    OPTIMIZE = "OPTIMIZE"
    DELETE = "DELETE"
    UPDATE = "UPDATE"
    MERGE = "MERGE"
    SET_TBLPROPERTIES = "SET TBLPROPERTIES"
    ADD_COLUMNS = "ADD COLUMNS"
    RENAME_COLUMN = "RENAME COLUMN"
    DROP_COLUMNS = "DROP COLUMNS"
    CHANGE_COLUMN = "CHANGE COLUMN"
    ADD_CONSTRAINT = "ADD CONSTRAINT"
    DROP_CONSTRAINT = "DROP CONSTRAINT"
    UPGRADE_PROTOCOL = "UPGRADE PROTOCOL"
    RESTORE = "RESTORE"
    CLONE = "CLONE"
    CONVERT = "CONVERT"


@dataclass
class CommitResult:
    version: int
    committed: bool
    attempts: int = 1


def check_write_supported(protocol: Protocol, metadata: Metadata) -> None:
    """Refuse a table whose protocol or properties need a writer this
    package does not have."""
    unsupported = features.unsupported_writer_features(protocol)
    if unsupported:
        raise UnsupportedTableError(
            f"writer features not supported yet: {unsupported}",
            feature="writer features", features=unsupported)
    conf = metadata.configuration
    for cfg, what in ((IN_COMMIT_TIMESTAMPS, "in-commit timestamps"),
                      (ROW_TRACKING_ENABLED, "row tracking")):
        if get_table_config(conf, cfg):
            raise UnsupportedTableError(f"{what} are not supported yet",
                                        feature=what)
    if get_table_config(conf, COORDINATED_COMMITS_COORDINATOR) is not None:
        raise UnsupportedTableError("coordinated commits are not supported "
                                    "yet", feature="coordinated commits")
    if get_table_config(conf, UNIFORM_ENABLED_FORMATS):
        raise UnsupportedTableError(
            "UniForm (delta.universalFormat.enabledFormats) needs the "
            "Iceberg/Hudi post-commit hooks, which are not ported yet",
            feature="uniform")
    check_writable(schema_from_json(metadata.schemaString))


def _check_metadata(metadata: Metadata) -> None:
    schema = schema_from_json(metadata.schemaString)
    check_writable(schema)
    if not schema.fields:
        raise InvalidArgumentError(
            "Data used in creating the Delta table doesn't have any columns.",
            error_class="DELTA_EMPTY_DATA")
    pcols = list(metadata.partitionColumns or [])
    validate_generated_schema(schema, pcols)
    # partition columns name schema fields, once each, and leave one out
    missing = [c for c in pcols if c not in schema]
    if missing:
        raise InvalidArgumentError(
            f"partition column(s) {missing} not found in schema "
            f"{sorted(schema.field_names())}",
            error_class="DELTA_INVALID_PARTITION_COLUMN")
    if len(set(pcols)) != len(pcols):
        raise InvalidArgumentError(f"duplicate partition columns: {pcols}")
    if pcols and len(pcols) == len(schema.fields):
        raise InvalidArgumentError(
            "cannot use all columns for partition columns",
            error_class="DELTA_CANNOT_USE_ALL_COLUMNS_FOR_PARTITION")
    bad = [] if is_mapped(metadata.configuration) else [
        f.name for f in schema.fields
        if any(c in f.name for c in _INVALID_NAME_CHARS)]
    if bad:
        raise InvalidArgumentError(
            f"column name(s) {bad} contain invalid characters "
            "(' ,;{}()\\n\\t='); enable column mapping "
            "(delta.columnMapping.mode = 'name') to use them",
            error_class="DELTA_INVALID_CHARACTERS_IN_COLUMN_NAME")


def _metric_str(v) -> str:
    """operationMetrics values are strings ('true'/'false' for booleans,
    integral floats without '.0')."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _group_commit_requested() -> bool:
    """The JAX package batches commits when DELTA_TPU_GROUP_COMMIT is
    set; this package has no group committer and refuses instead of
    committing alone behind the caller's back."""
    return os.environ.get("DELTA_TPU_GROUP_COMMIT", "").strip().lower() in (
        "1", "true", "yes", "on")


class TransactionBuilder:
    def __init__(self, table, operation: str = Operation.WRITE):
        self._table = table
        self._operation = operation
        self._schema: Optional[StructType] = None
        self._partition_columns: List[str] = []
        self._table_properties: Optional[Dict[str, str]] = None
        self._txn_app_id: Optional[str] = None
        self._txn_version: Optional[int] = None

    def with_schema(self, schema: StructType) -> "TransactionBuilder":
        self._schema = schema
        return self

    def with_partition_columns(self, cols: Sequence[str]
                               ) -> "TransactionBuilder":
        """Partition columns of a table this transaction creates."""
        self._partition_columns = list(cols)
        return self

    def with_table_properties(self, props: Dict[str, str]
                              ) -> "TransactionBuilder":
        """Properties of a table this transaction creates."""
        self._table_properties = dict(props)
        return self

    def with_transaction_id(self, app_id: str, version: int
                            ) -> "TransactionBuilder":
        self._txn_app_id, self._txn_version = app_id, version
        return self

    def build(self) -> "Transaction":
        try:
            snapshot = self._table.latest_snapshot()
        except TableNotFoundError:
            snapshot = None
        if snapshot is None and self._schema is None:
            raise InvalidArgumentError(
                f"table {self._table.path} does not exist; provide a "
                "schema to create it", error_class="DELTA_METADATA_ABSENT")
        txn = Transaction(self._table, snapshot, self._operation)
        if snapshot is None:
            props = dict(self._table_properties or {})
            schema = self._schema
            if is_mapped(props):
                schema, props = assign_column_mapping(schema, props)
            metadata = Metadata(
                id=str(uuid.uuid4()),
                schemaString=schema_to_json(schema),
                partitionColumns=list(self._partition_columns),
                configuration=props,
                createdTime=int(time.time() * 1000),
            )
            txn.update_metadata(metadata)
            txn.update_protocol(features.protocol_for_new_table(
                props, metadata.schemaString))
        if self._txn_app_id is not None:
            txn.set_transaction_id(self._txn_app_id, self._txn_version)
        return txn


class Transaction:
    def __init__(self, table, snapshot, operation: str):
        self._table = table
        self.read_snapshot = snapshot
        self.operation = operation
        self.txn_id = str(uuid.uuid4())
        # None: the table's delta.isolationLevel, else the default for
        # the commit's kind; OPTIMIZE sets SnapshotIsolation
        self.isolation: Optional[IsolationLevel] = None
        self._adds: List[AddFile] = []
        self._removes: List[RemoveFile] = []
        self._cdcs: List[AddCDCFile] = []
        self._set_txns: Dict[str, SetTransaction] = {}
        self._new_metadata: Optional[Metadata] = None
        self._new_protocol: Optional[Protocol] = None
        self._op_parameters: Dict[str, object] = {}
        self._op_metrics: Dict[str, object] = {}
        self._read_whole_table = False
        self._read_predicates: list = []
        self._read_files: set = set()
        self._read_app_ids: set = set()
        self._committed = False

    # -- read tracking --------------------------------------------------

    @property
    def read_version(self) -> int:
        return self.read_snapshot.version if self.read_snapshot else -1

    def metadata(self) -> Optional[Metadata]:
        if self._new_metadata is not None:
            return self._new_metadata
        return self.read_snapshot.metadata if self.read_snapshot else None

    def protocol(self) -> Optional[Protocol]:
        if self._new_protocol is not None:
            return self._new_protocol
        return self.read_snapshot.protocol if self.read_snapshot else None

    def scan_files(self, filter=None) -> List[AddFile]:
        """The read snapshot's live files that `filter` may match (every
        one when None: a whole-table read); records the predicate (or the
        whole-table read) and the returned file keys for the conflict
        check."""
        if self.read_snapshot is None:
            return []
        files = self.read_snapshot.scan(filter=filter).files()
        if filter is None:
            self._read_whole_table = True
        else:
            self._read_predicates.append(filter)
        for f in files:
            self._read_files.add((f.path, f.dv_unique_id))
        return files

    def mark_read_whole_table(self) -> None:
        """Record a read of every row (ADD CONSTRAINT's check): any
        concurrent add conflicts."""
        self._read_whole_table = True

    def txn_version(self, app_id: str) -> Optional[int]:
        """An idempotent-txn watermark; the read is tracked."""
        self._read_app_ids.add(app_id)
        if self.read_snapshot is None:
            return None
        return self.read_snapshot.set_transaction_version(app_id)

    # -- staging --------------------------------------------------------

    def add_file(self, add: AddFile) -> None:
        self._adds.append(add)

    def add_files(self, adds: Sequence[AddFile]) -> None:
        self._adds.extend(adds)

    def remove_file(self, remove: RemoveFile) -> None:
        self._removes.append(remove)

    def add_cdc_file(self, cdc: AddCDCFile) -> None:
        """Stage a change data file (`write/writer.py::write_cdc_files`);
        it commits after the adds, as in the reference."""
        self._cdcs.append(cdc)

    def set_transaction_id(self, app_id: str, version: int,
                           last_updated: Optional[int] = None) -> None:
        existing = self.txn_version(app_id)
        if existing is not None and version <= existing:
            raise ConcurrentTransactionError(
                f"transaction {app_id} already advanced to {existing} >= "
                f"{version}")
        self._set_txns[app_id] = SetTransaction(
            app_id, version,
            last_updated if last_updated is not None
            else int(time.time() * 1000))

    def update_metadata(self, metadata: Metadata) -> None:
        _check_metadata(metadata)
        self._new_metadata = metadata

    def update_protocol(self, protocol: Protocol) -> None:
        self._new_protocol = protocol

    def set_domain_metadata(self, domain: str, configuration: str) -> None:
        raise UnsupportedTableError("domain metadata writes are not "
                                    "supported yet", feature="domain writes")

    def remove_domain_metadata(self, domain: str) -> None:
        raise UnsupportedTableError("domain metadata writes are not "
                                    "supported yet", feature="domain writes")

    def set_operation_parameters(self, params: Dict[str, object]) -> None:
        self._op_parameters.update(params)

    def set_operation_metrics(self, metrics: Dict[str, object]) -> None:
        self._op_metrics.update(metrics)

    # -- commit ---------------------------------------------------------

    @property
    def data_changed(self) -> bool:
        return (any(a.dataChange for a in self._adds)
                or any(r.dataChange for r in self._removes))

    def isolation_level(self) -> IsolationLevel:
        if self.isolation is not None:
            return self.isolation
        meta = self.metadata()
        if meta is not None:
            raw = meta.configuration.get(ISOLATION_LEVEL.key)
            if raw is not None:
                return IsolationLevel(ISOLATION_LEVEL.parse(raw))
        return default_isolation_level(self.data_changed)

    def _compute_metrics(self) -> Dict[str, str]:
        m = {"numOutputFiles": str(len(self._adds)),
             "numOutputBytes": str(sum(a.size for a in self._adds))}
        if self._removes:
            m["numRemovedFiles"] = str(len(self._removes))
        m.update({k: _metric_str(v) for k, v in self._op_metrics.items()
                  if v is not None})
        return m

    def _prepare_actions(self) -> list:
        """Validate and order the actions; commitInfo is the first line."""
        meta = self.metadata()
        if meta is None:
            raise InvalidArgumentError(
                "cannot commit a transaction with no metadata",
                error_class="DELTA_METADATA_ABSENT")
        if self.read_snapshot is None and self._new_protocol is None:
            raise InvalidArgumentError(
                "new table commit must include a protocol",
                error_class="DELTA_PROTOCOL_ABSENT")
        check_write_supported(self.protocol(), meta)
        if get_table_config(meta.configuration, APPEND_ONLY) and any(
                r.dataChange for r in self._removes):
            # dataChange=false removes (OPTIMIZE rewrites) stay allowed
            raise InvalidArgumentError(
                "This table is configured to only allow appends "
                "(delta.appendOnly=true); data-changing removes are not "
                "permitted", error_class="DELTA_APPEND_ONLY_REMOVES")
        commit_info = CommitInfo(
            timestamp=int(time.time() * 1000),
            operation=self.operation,
            operationParameters=self._op_parameters or {},
            operationMetrics=self._compute_metrics(),
            readVersion=self.read_version if self.read_version >= 0 else None,
            isolationLevel=self.isolation_level().value,
            isBlindAppend=(not self._removes and not self._read_files
                           and not self._read_predicates
                           and not self._read_whole_table),
            engineInfo=ENGINE_INFO,
            txnId=self.txn_id,
        )
        actions: list = [commit_info]
        if self._new_protocol is not None:
            actions.append(self._new_protocol)
        if self._new_metadata is not None:
            actions.append(self._new_metadata)
        actions.extend(self._set_txns.values())
        actions.extend(self._removes)
        actions.extend(self._adds)
        actions.extend(self._cdcs)
        return actions

    def _read_state(self) -> TransactionReadState:
        meta = self.metadata()
        return TransactionReadState(
            read_predicates=list(self._read_predicates),
            read_whole_table=self._read_whole_table,
            partition_columns=list(meta.partitionColumns) if meta else [],
            metadata=meta,
            read_files=set(self._read_files),
            read_app_ids=set(self._read_app_ids) | set(self._set_txns),
            removed_keys={(r.path, r.dv_unique_id) for r in self._removes},
            isolation=self.isolation_level(),
        )

    def _latest_version(self, fs, log_path: str, at_least: int) -> int:
        latest = at_least
        for st in fs.list_from(filenames.listing_prefix(log_path, at_least)):
            if filenames.is_delta_file(st.path):
                latest = max(latest, filenames.delta_version(st.path))
        return latest

    def _is_own_commit(self, winner: WinningCommit) -> bool:
        ci = next((a for a in winner.actions if isinstance(a, CommitInfo)),
                  None)
        return ci is not None and ci.txnId == self.txn_id

    def commit(self) -> CommitResult:
        if self._committed:
            raise InvalidArgumentError(
                "transaction already committed",
                error_class="DELTA_TRANSACTION_ALREADY_COMMITTED")
        if _group_commit_requested():
            raise UnsupportedTableError("group commit is not supported yet",
                                        feature="group commit")
        fs = self._table.engine.fs
        log_path = self._table.log_path
        attempt_version = self.read_version + 1
        attempts = 0
        while attempts <= MAX_COMMIT_RETRIES:
            attempts += 1
            data = actions_to_commit_bytes(self._prepare_actions())
            try:
                fs.write(filenames.delta_file(log_path, attempt_version), data,
                         overwrite=False)
                # hand the bytes to the table's cached snapshot before the
                # hooks run, so that they and the next update() advance
                # without reading this commit back
                self._table.notify_commit(attempt_version, data)
            except FileExistsError:
                latest = self._latest_version(fs, log_path, attempt_version)
                winners = [WinningCommit(v, actions_from_commit_bytes(
                    fs.read_file(filenames.delta_file(log_path, v))))
                    for v in range(attempt_version, latest + 1)]
                if not self._is_own_commit(winners[0]):
                    # a genuine loss: raises, or rebases past the winners
                    check_conflicts(self._read_state(), winners)
                    attempt_version = latest + 1
                    continue
                # an ambiguous write outcome: the winner is our own commit
            self._committed = True
            run_post_commit_hooks(self._table, self, attempt_version,
                                  self.metadata())
            return CommitResult(attempt_version, True, attempts)
        raise MaxCommitRetriesExceededError(
            f"commit failed after {attempts} attempts (last tried version "
            f"{attempt_version})")

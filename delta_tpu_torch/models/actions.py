"""Typed schemas of the transaction-log actions.

Counterpart of `delta_tpu/models/actions.py`, cut to `metaData`,
`protocol`, `add`, `remove`, `cdc`, `txn`, `domainMetadata` and `commitInfo`
(plus the deletion-vector descriptor an `add`/`remove` may carry). Field
lists follow the Delta protocol's action definitions.

- Dataclasses keep an `extra` dict so unknown fields from future writers
  round-trip unchanged.
- `AddFile.stats` stays a raw JSON string.
- The replay identity of a logical file is `(path, dv_unique_id)`.
- A file action's path is a URI in the log and decoded in memory:
  `from_dict` percent-decodes it once (`decode_path`), `to_dict` encodes
  it (`encode_path`), so whatever form a path was read in, the path a
  command writes back decodes once to the path the snapshot holds.
- `actions_to_commit_bytes` / `actions_from_commit_bytes` write and read
  a commit file (one wrapped JSON object per line); what they write
  parses to the same dicts as the reference's.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, Iterable, List, Optional
from urllib.parse import quote, unquote

# RFC 3986's path characters besides the unreserved ones: '/' and pchar's
# sub-delims, ':' and '@'. '%', spaces, '#', '?' and non-ASCII are escaped.
_PATH_SAFE = "/:@!$&'()*+,;="


def decode_path(raw: str) -> str:
    """Percent-decode a path URI from the log (the snapshot's path);
    untouched when no '%' appears."""
    return unquote(raw) if "%" in raw else raw


def encode_path(path: str) -> str:
    """The log's form of a decoded path: `decode_path(encode_path(p)) ==
    p` for every `p`, and a path of unreserved characters, '/', '=' and
    ':' comes out unchanged."""
    return quote(path, safe=_PATH_SAFE)


def _prune(d: Dict[str, Any]) -> Dict[str, Any]:
    """Drop None values — Delta JSON omits absent optional fields."""
    return {k: v for k, v in d.items() if v is not None}


@dataclass
class DeletionVectorDescriptor:
    """Pointer to a deletion vector (PROTOCOL.md Deletion Vectors section).

    storageType: 'u' = relative path derived from UUID (pathOrInlineDv =
    `<random prefix><base85 uuid>`), 'i' = inline (base85 bitmap bytes),
    'p' = absolute path.
    """

    storageType: str
    pathOrInlineDv: str
    sizeInBytes: int
    cardinality: int
    offset: Optional[int] = None
    maxRowIndex: Optional[int] = None

    UUID_DV: ClassVar[str] = "u"
    INLINE_DV: ClassVar[str] = "i"
    PATH_DV: ClassVar[str] = "p"

    @property
    def unique_id(self) -> str:
        """Stable identity of this DV, part of the logical-file replay key
        (reference `DeletionVectorDescriptor.scala` uniqueId)."""
        base = self.storageType + self.pathOrInlineDv
        if self.offset is not None:
            return f"{base}@{self.offset}"
        return base

    def to_dict(self) -> Dict[str, Any]:
        return _prune(
            {
                "storageType": self.storageType,
                "pathOrInlineDv": self.pathOrInlineDv,
                "offset": self.offset,
                "sizeInBytes": self.sizeInBytes,
                "cardinality": self.cardinality,
                "maxRowIndex": self.maxRowIndex,
            }
        )

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["DeletionVectorDescriptor"]:
        if d is None:
            return None
        return DeletionVectorDescriptor(
            storageType=d["storageType"],
            pathOrInlineDv=d["pathOrInlineDv"],
            sizeInBytes=int(d["sizeInBytes"]),
            cardinality=int(d["cardinality"]),
            offset=(int(d["offset"]) if d.get("offset") is not None else None),
            maxRowIndex=(int(d["maxRowIndex"]) if d.get("maxRowIndex") is not None else None),
        )


@dataclass
class Format:
    provider: str = "parquet"
    options: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"provider": self.provider, "options": dict(self.options)}

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "Format":
        if d is None:
            return Format()
        return Format(provider=d.get("provider", "parquet"), options=dict(d.get("options") or {}))


@dataclass
class Metadata:
    """Table metadata (`metaData` action). Latest-seen wins in replay."""

    WRAPPER_KEY: ClassVar[str] = "metaData"

    id: str
    schemaString: str = ""
    partitionColumns: List[str] = field(default_factory=list)
    configuration: Dict[str, str] = field(default_factory=dict)
    format: Format = field(default_factory=Format)
    name: Optional[str] = None
    description: Optional[str] = None
    createdTime: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = _prune(
            {
                "id": self.id,
                "name": self.name,
                "description": self.description,
                "format": self.format.to_dict(),
                "schemaString": self.schemaString,
                "partitionColumns": list(self.partitionColumns),
                "configuration": dict(self.configuration),
                "createdTime": self.createdTime,
            }
        )
        d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Metadata":
        known = {
            "id",
            "name",
            "description",
            "format",
            "schemaString",
            "partitionColumns",
            "configuration",
            "createdTime",
        }
        return Metadata(
            id=d["id"],
            name=d.get("name"),
            description=d.get("description"),
            format=Format.from_dict(d.get("format")),
            schemaString=d.get("schemaString", ""),
            partitionColumns=list(d.get("partitionColumns") or []),
            configuration=dict(d.get("configuration") or {}),
            createdTime=d.get("createdTime"),
            extra={k: v for k, v in d.items() if k not in known},
        )


@dataclass
class Protocol:
    """Protocol action: reader/writer version + optional feature sets.

    readerFeatures may only be present at (3, 7); writerFeatures at writer
    version 7 (PROTOCOL.md:844-876).
    """

    WRAPPER_KEY: ClassVar[str] = "protocol"

    minReaderVersion: int = 1
    minWriterVersion: int = 2
    readerFeatures: Optional[List[str]] = None
    writerFeatures: Optional[List[str]] = None

    def reader_feature_set(self) -> frozenset:
        return frozenset(self.readerFeatures or [])

    def writer_feature_set(self) -> frozenset:
        return frozenset(self.writerFeatures or [])

    def to_dict(self) -> Dict[str, Any]:
        return _prune(
            {
                "minReaderVersion": self.minReaderVersion,
                "minWriterVersion": self.minWriterVersion,
                "readerFeatures": (
                    sorted(self.readerFeatures) if self.readerFeatures is not None else None
                ),
                "writerFeatures": (
                    sorted(self.writerFeatures) if self.writerFeatures is not None else None
                ),
            }
        )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Protocol":
        return Protocol(
            minReaderVersion=int(d.get("minReaderVersion", 1)),
            minWriterVersion=int(d.get("minWriterVersion", 2)),
            readerFeatures=(
                list(d["readerFeatures"]) if d.get("readerFeatures") is not None else None
            ),
            writerFeatures=(
                list(d["writerFeatures"]) if d.get("writerFeatures") is not None else None
            ),
        )


@dataclass
class AddFile:
    """`add` action: a logical file joining the table."""

    WRAPPER_KEY: ClassVar[str] = "add"

    path: str
    partitionValues: Dict[str, Optional[str]] = field(default_factory=dict)
    size: int = 0
    modificationTime: int = 0
    dataChange: bool = True
    stats: Optional[str] = None
    tags: Optional[Dict[str, str]] = None
    deletionVector: Optional[DeletionVectorDescriptor] = None
    baseRowId: Optional[int] = None
    defaultRowCommitVersion: Optional[int] = None
    clusteringProvider: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def dv_unique_id(self) -> Optional[str]:
        return self.deletionVector.unique_id if self.deletionVector else None

    def remove(self, deletion_timestamp: int,
               data_change: bool = True) -> "RemoveFile":
        """Tombstone for this file (reference `AddFile.remove`)."""
        return RemoveFile(
            path=self.path,
            deletionTimestamp=deletion_timestamp,
            dataChange=data_change,
            extendedFileMetadata=True,
            partitionValues=dict(self.partitionValues),
            size=self.size,
            stats=self.stats,
            tags=self.tags,
            deletionVector=self.deletionVector,
            baseRowId=self.baseRowId,
            defaultRowCommitVersion=self.defaultRowCommitVersion,
        )

    def to_dict(self) -> Dict[str, Any]:
        d = _prune(
            {
                "path": encode_path(self.path),
                "partitionValues": dict(self.partitionValues),
                "size": self.size,
                "modificationTime": self.modificationTime,
                "dataChange": self.dataChange,
                "stats": self.stats,
                "tags": self.tags,
                "deletionVector": (
                    self.deletionVector.to_dict() if self.deletionVector else None
                ),
                "baseRowId": self.baseRowId,
                "defaultRowCommitVersion": self.defaultRowCommitVersion,
                "clusteringProvider": self.clusteringProvider,
            }
        )
        d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AddFile":
        known = {
            "path",
            "partitionValues",
            "size",
            "modificationTime",
            "dataChange",
            "stats",
            "tags",
            "deletionVector",
            "baseRowId",
            "defaultRowCommitVersion",
            "clusteringProvider",
        }
        return AddFile(
            path=decode_path(d["path"]),
            partitionValues=dict(d.get("partitionValues") or {}),
            size=int(d.get("size") or 0),
            modificationTime=int(d.get("modificationTime") or 0),
            dataChange=bool(d.get("dataChange", True)),
            stats=d.get("stats"),
            tags=(dict(d["tags"]) if d.get("tags") is not None else None),
            deletionVector=DeletionVectorDescriptor.from_dict(d.get("deletionVector")),
            baseRowId=d.get("baseRowId"),
            defaultRowCommitVersion=d.get("defaultRowCommitVersion"),
            clusteringProvider=d.get("clusteringProvider"),
            extra={k: v for k, v in d.items() if k not in known},
        )


@dataclass
class RemoveFile:
    """`remove` action: a tombstone for a logical file."""

    WRAPPER_KEY: ClassVar[str] = "remove"

    path: str
    deletionTimestamp: Optional[int] = None
    dataChange: bool = True
    extendedFileMetadata: Optional[bool] = None
    partitionValues: Optional[Dict[str, Optional[str]]] = None
    size: Optional[int] = None
    stats: Optional[str] = None
    tags: Optional[Dict[str, str]] = None
    deletionVector: Optional[DeletionVectorDescriptor] = None
    baseRowId: Optional[int] = None
    defaultRowCommitVersion: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def dv_unique_id(self) -> Optional[str]:
        return self.deletionVector.unique_id if self.deletionVector else None

    def to_dict(self) -> Dict[str, Any]:
        d = _prune(
            {
                "path": encode_path(self.path),
                "deletionTimestamp": self.deletionTimestamp,
                "dataChange": self.dataChange,
                "extendedFileMetadata": self.extendedFileMetadata,
                "partitionValues": self.partitionValues,
                "size": self.size,
                "stats": self.stats,
                "tags": self.tags,
                "deletionVector": (
                    self.deletionVector.to_dict() if self.deletionVector else None
                ),
                "baseRowId": self.baseRowId,
                "defaultRowCommitVersion": self.defaultRowCommitVersion,
            }
        )
        d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RemoveFile":
        known = {
            "path",
            "deletionTimestamp",
            "dataChange",
            "extendedFileMetadata",
            "partitionValues",
            "size",
            "stats",
            "tags",
            "deletionVector",
            "baseRowId",
            "defaultRowCommitVersion",
        }
        return RemoveFile(
            path=decode_path(d["path"]),
            deletionTimestamp=d.get("deletionTimestamp"),
            dataChange=bool(d.get("dataChange", True)),
            extendedFileMetadata=d.get("extendedFileMetadata"),
            partitionValues=(
                dict(d["partitionValues"]) if d.get("partitionValues") is not None else None
            ),
            size=d.get("size"),
            stats=d.get("stats"),
            tags=(dict(d["tags"]) if d.get("tags") is not None else None),
            deletionVector=DeletionVectorDescriptor.from_dict(d.get("deletionVector")),
            baseRowId=d.get("baseRowId"),
            defaultRowCommitVersion=d.get("defaultRowCommitVersion"),
            extra={k: v for k, v in d.items() if k not in known},
        )


@dataclass
class AddCDCFile:
    """`cdc` action: a change data file under `_change_data/`, written
    beside a data-changing command's adds and removes; it takes no part
    in the replay of the live files."""

    WRAPPER_KEY: ClassVar[str] = "cdc"

    path: str
    partitionValues: Dict[str, Optional[str]] = field(default_factory=dict)
    size: int = 0
    dataChange: bool = False
    tags: Optional[Dict[str, str]] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = _prune({
            "path": encode_path(self.path),
            "partitionValues": dict(self.partitionValues),
            "size": self.size,
            "dataChange": self.dataChange,
            "tags": self.tags,
        })
        d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AddCDCFile":
        known = {"path", "partitionValues", "size", "dataChange", "tags"}
        return AddCDCFile(
            path=decode_path(d["path"]),
            partitionValues=dict(d.get("partitionValues") or {}),
            size=int(d.get("size") or 0),
            dataChange=bool(d.get("dataChange", False)),
            tags=(dict(d["tags"]) if d.get("tags") is not None else None),
            extra={k: v for k, v in d.items() if k not in known},
        )


@dataclass
class SetTransaction:
    """`txn` action: idempotence watermark per application id. Latest-seen
    version wins per appId."""

    WRAPPER_KEY: ClassVar[str] = "txn"

    appId: str
    version: int
    lastUpdated: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return _prune(
            {"appId": self.appId, "version": self.version, "lastUpdated": self.lastUpdated}
        )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SetTransaction":
        return SetTransaction(
            appId=d["appId"], version=int(d["version"]), lastUpdated=d.get("lastUpdated")
        )


@dataclass
class DomainMetadata:
    """`domainMetadata` action: per-domain configuration, latest-seen wins;
    `removed=True` entries are tombstones not returned by reads."""

    WRAPPER_KEY: ClassVar[str] = "domainMetadata"

    domain: str
    configuration: str = ""
    removed: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "domain": self.domain,
            "configuration": self.configuration,
            "removed": self.removed,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DomainMetadata":
        return DomainMetadata(
            domain=d["domain"],
            configuration=d.get("configuration", ""),
            removed=bool(d.get("removed", False)),
        )


@dataclass
class CommitInfo:
    """`commitInfo` action: provenance (operation name/params, engine info,
    ICT). Not part of reconciled state; must be the first line of a commit
    when in-commit timestamps are enabled."""

    WRAPPER_KEY: ClassVar[str] = "commitInfo"

    timestamp: Optional[int] = None
    operation: Optional[str] = None
    operationParameters: Optional[Dict[str, Any]] = None
    operationMetrics: Optional[Dict[str, Any]] = None
    engineInfo: Optional[str] = None
    txnId: Optional[str] = None
    inCommitTimestamp: Optional[int] = None
    isBlindAppend: Optional[bool] = None
    readVersion: Optional[int] = None
    isolationLevel: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = _prune(
            {
                "timestamp": self.timestamp,
                "inCommitTimestamp": self.inCommitTimestamp,
                "operation": self.operation,
                "operationParameters": self.operationParameters,
                "operationMetrics": self.operationMetrics,
                "readVersion": self.readVersion,
                "isolationLevel": self.isolationLevel,
                "isBlindAppend": self.isBlindAppend,
                "engineInfo": self.engineInfo,
                "txnId": self.txnId,
            }
        )
        d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "CommitInfo":
        known = {
            "timestamp",
            "inCommitTimestamp",
            "operation",
            "operationParameters",
            "operationMetrics",
            "readVersion",
            "isolationLevel",
            "isBlindAppend",
            "engineInfo",
            "txnId",
        }
        return CommitInfo(
            timestamp=d.get("timestamp"),
            inCommitTimestamp=d.get("inCommitTimestamp"),
            operation=d.get("operation"),
            operationParameters=d.get("operationParameters"),
            operationMetrics=d.get("operationMetrics"),
            readVersion=d.get("readVersion"),
            isolationLevel=d.get("isolationLevel"),
            isBlindAppend=d.get("isBlindAppend"),
            engineInfo=d.get("engineInfo"),
            txnId=d.get("txnId"),
            extra={k: v for k, v in d.items() if k not in known},
        )


_WRAPPER_TO_CLASS = {cls.WRAPPER_KEY: cls for cls in (
    AddFile, RemoveFile, AddCDCFile, Metadata, Protocol, SetTransaction,
    DomainMetadata, CommitInfo)}


def action_to_json(action) -> str:
    return json.dumps({action.WRAPPER_KEY: action.to_dict()},
                      separators=(",", ":"))


def actions_to_commit_bytes(actions: Iterable) -> bytes:
    """Commit-file bytes: one JSON object per line."""
    return ("\n".join(action_to_json(a) for a in actions) + "\n") \
        .encode("utf-8")


def actions_from_commit_bytes(data: bytes) -> list:
    """Parse a commit file into actions; a wrapper this module does not
    model (`checkpointMetadata`, `sidecar`, future ones) is skipped, as
    readers must skip action types they do not know."""
    out = []
    for line in data.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        wrapped = json.loads(line)
        for key, cls in _WRAPPER_TO_CLASS.items():
            body = wrapped.get(key)
            if body is not None:
                out.append(cls.from_dict(body))
                break
    return out

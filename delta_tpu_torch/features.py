"""Table features: a new table's protocol, the upgrades ALTER TABLE makes,
and which features the write path takes.

A port-owned copy of `delta_tpu/features.py:20-260` (Delta's
`TableFeature.scala` and `Protocol.forNewTable`): the registry of
features with their reader and writer versions and the metadata that
turns each on, `protocol_for_new_table` and `upgraded_protocol`.

The write path takes appendOnly and invariants (legacy: protocol (1, 2)
carries them), checkConstraints (1, 3), changeDataFeed and
generatedColumns (1, 4), columnMapping (legacy at (2, 5)),
identityColumns (1, 6), deletionVectors (a reader-writer feature at (3,
7) with feature lists), timestampNtz, typeWidening and
allowColumnDefaults. changeDataFeed is turned on by
`delta.enableChangeDataFeed` alone, as in the reference; the legacy alias
`delta.enableChangeDataCapture` turns the feed on
(`config.py::cdf_enabled`) without a protocol feature.
`unsupported_writer_features` names the rest,
which `txn/transaction.py` refuses; `refused_properties` names the table
properties that would turn on a feature this package does not write.

One rule differs from the reference: `upgraded_protocol` lists a
reader-writer feature among the reader features whenever the protocol
has reader feature lists, as the protocol requires. The reference lists
only those of reader version 3 there, so its upgrade of a (3, 7) table
to column mapping leaves `columnMapping` out of `readerFeatures`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from delta_tpu_torch.config import _parse_bool
from delta_tpu_torch.errors import UnsupportedTableError
from delta_tpu_torch.models.actions import Metadata, Protocol


@dataclass(frozen=True)
class TableFeature:
    name: str
    min_reader_version: int  # 1 for a writer-only feature
    min_writer_version: int
    is_reader_writer: bool
    # the metadata that turns a supported feature on
    activated_by: Optional[Callable[[Metadata], bool]] = None
    # implied by a legacy protocol's versions
    legacy: bool = False


FEATURES: Dict[str, TableFeature] = {}


def _feature(name, min_reader, min_writer, reader_writer, activated_by=None,
             legacy=False) -> None:
    FEATURES[name] = TableFeature(name, min_reader, min_writer,
                                  reader_writer, activated_by, legacy)


def _conf_true(key):
    return lambda m: _parse_bool(m.configuration.get(key, ""))


def _schema_has_metadata_key(predicate):
    """Turned on by a field-metadata key on any (nested) field."""

    def walk(fields):
        for f in fields:
            if any(predicate(k) for k in (f.get("metadata") or {})):
                return True
            t = f.get("type")
            if isinstance(t, dict) and t.get("type") == "struct" \
                    and walk(t.get("fields", [])):
                return True
        return False

    def check(m):
        try:
            schema = json.loads(m.schemaString) if m.schemaString else {}
        except ValueError:
            return False
        return isinstance(schema, dict) and walk(schema.get("fields", []))

    return check


_feature("appendOnly", 1, 2, False, _conf_true("delta.appendOnly"),
         legacy=True)
_feature("invariants", 1, 2, False, legacy=True)
_feature("checkConstraints", 1, 3, False,
         lambda m: any(k.startswith("delta.constraints.")
                       for k in m.configuration), legacy=True)
_feature("changeDataFeed", 1, 4, False,
         _conf_true("delta.enableChangeDataFeed"), legacy=True)
_feature("generatedColumns", 1, 4, False,
         _schema_has_metadata_key(lambda k: k == "delta.generationExpression"),
         legacy=True)
_feature("columnMapping", 2, 5, True,
         lambda m: m.configuration.get("delta.columnMapping.mode",
                                       "none") != "none", legacy=True)
_feature("identityColumns", 1, 6, False,
         _schema_has_metadata_key(lambda k: k.startswith("delta.identity.")),
         legacy=True)
_feature("deletionVectors", 3, 7, True,
         _conf_true("delta.enableDeletionVectors"))
_feature("rowTracking", 1, 7, False, _conf_true("delta.enableRowTracking"))
_feature("timestampNtz", 3, 7, True)
_feature("typeWidening", 3, 7, True, _conf_true("delta.enableTypeWidening"))
_feature("domainMetadata", 1, 7, False)
_feature("v2Checkpoint", 3, 7, True,
         lambda m: m.configuration.get("delta.checkpointPolicy",
                                       "classic") == "v2")
_feature("icebergCompatV1", 1, 7, False,
         _conf_true("delta.enableIcebergCompatV1"))
_feature("icebergCompatV2", 1, 7, False,
         _conf_true("delta.enableIcebergCompatV2"))
_feature("inCommitTimestamp", 1, 7, False,
         _conf_true("delta.enableInCommitTimestamps"))
_feature("vacuumProtocolCheck", 3, 7, True)
_feature("clustering", 1, 7, False)
_feature("variantType", 3, 7, True)
_feature("allowColumnDefaults", 1, 7, False,
         _schema_has_metadata_key(lambda k: k == "CURRENT_DEFAULT"))

SUPPORTED_WRITER_FEATURES = frozenset({
    "appendOnly", "invariants", "checkConstraints", "changeDataFeed",
    "generatedColumns", "columnMapping", "identityColumns",
    "deletionVectors", "timestampNtz", "typeWidening",
    "allowColumnDefaults"})
_MAX_LEGACY_WRITER = 6
# properties that would turn on a table feature this package does not write
_REFUSED_FLAGS = ("delta.enableRowTracking",
                  "delta.enableIcebergCompatV1", "delta.enableIcebergCompatV2",
                  "delta.enableInCommitTimestamps")
_PROTOCOL_PROPS = ("delta.minReaderVersion", "delta.minWriterVersion",
                   "delta.ignoreProtocolDefaults")


def _implied(protocol: Protocol) -> set:
    """The legacy features a protocol without feature lists carries."""
    return {f.name for f in FEATURES.values()
            if f.legacy and f.min_writer_version <= protocol.minWriterVersion
            and (not f.is_reader_writer
                 or f.min_reader_version <= protocol.minReaderVersion)}


def is_feature_supported(protocol: Protocol, feature: TableFeature) -> bool:
    """Whether the protocol lists the feature, or (legacy features only)
    implies it by a writer version below 7."""
    if feature.name in protocol.writer_feature_set() or (
            feature.is_reader_writer
            and feature.name in protocol.reader_feature_set()):
        return True
    if feature.legacy:
        ok_writer = protocol.minWriterVersion >= feature.min_writer_version
        ok_reader = (not feature.is_reader_writer
                     or protocol.minReaderVersion >= feature.min_reader_version)
        return ok_writer and ok_reader and protocol.minWriterVersion < 7
    return False


def unsupported_writer_features(protocol: Protocol) -> List[str]:
    """The features of a table this package cannot write: those listed
    (or implied by a legacy writer version up to 6) outside the supported
    set; a legacy writer version past 6 names itself."""
    if protocol.minWriterVersion >= 7:
        listed = set(protocol.writerFeatures or [])
    elif protocol.minWriterVersion > _MAX_LEGACY_WRITER:
        return [f"writerVersion={protocol.minWriterVersion}"]
    else:
        listed = _implied(protocol)
    return sorted(listed - SUPPORTED_WRITER_FEATURES)


def refused_properties(properties: Dict[str, str]) -> List[str]:
    """The table properties that would turn on a feature this package
    does not write, or set the protocol itself."""
    needs = [k for k in _REFUSED_FLAGS if _parse_bool(properties.get(k, ""))]
    needs += [k for k in properties if k in _PROTOCOL_PROPS]
    if properties.get("delta.checkpointPolicy", "classic") != "classic":
        needs.append("delta.checkpointPolicy")
    return sorted(needs)


def protocol_for_new_table(properties: Dict[str, str],
                           schema_string: Optional[str] = None) -> Protocol:
    """The least protocol that carries the features `properties` and the
    schema's field metadata (generated, identity and default columns)
    turn on: (1, 2) for legacy ones alone,
    (2, 5) with column mapping; with a non-legacy feature, (3, 7) with the
    reader-writer features listed for readers and every turned-on feature
    for writers. A property that would need a feature this package does
    not write, or set the protocol itself, raises
    `UnsupportedTableError`."""
    needs = refused_properties(properties)
    if needs:
        raise UnsupportedTableError(
            f"table properties {needs} need table features this "
            "package does not write yet", feature="table properties")
    meta = Metadata(id="", schemaString=schema_string or "",
                    configuration=dict(properties))
    needed = [f for f in FEATURES.values()
              if f.activated_by is not None and f.activated_by(meta)]
    min_reader, min_writer = 1, 2
    for f in needed:
        min_reader = max(min_reader, f.min_reader_version)
        min_writer = max(min_writer, f.min_writer_version)
    if any(not f.legacy for f in needed):
        reader_vec = min_reader >= 3
        return Protocol(
            3 if reader_vec else min_reader, 7,
            readerFeatures=sorted(f.name for f in needed
                                  if f.is_reader_writer)
            if reader_vec else None,
            writerFeatures=sorted(f.name for f in needed))
    return Protocol(min_reader, min_writer)


def upgraded_protocol(current: Protocol, feature: TableFeature) -> Protocol:
    """The protocol after `feature` is turned on: a legacy protocol bumps
    its versions for a legacy feature; otherwise feature lists at writer
    7, every feature the old versions implied listed."""
    reader = set(current.readerFeatures or [])
    writer = set(current.writerFeatures or [])
    min_reader = current.minReaderVersion
    min_writer = current.minWriterVersion
    legacy_form = current.writerFeatures is None and min_writer < 7
    if feature.legacy and legacy_form:
        if feature.name in _implied(current):
            return current
        return Protocol(
            max(min_reader, feature.min_reader_version
                if feature.is_reader_writer else 1),
            max(min_writer, feature.min_writer_version))
    if current.writerFeatures is None:
        for name in _implied(current):
            writer.add(name)
            if FEATURES[name].is_reader_writer:
                reader.add(name)
    writer.add(feature.name)
    if feature.is_reader_writer:
        min_reader = max(min_reader, feature.min_reader_version)
        if min_reader >= 3 or reader:
            reader.add(feature.name)
    if reader:
        min_reader = 3
    return Protocol(min_reader, 7,
                    readerFeatures=sorted(reader) if min_reader >= 3
                    else None,
                    writerFeatures=sorted(writer))

"""ALTER TABLE ... DROP FEATURE: remove a table feature from the protocol.

Counterpart of `delta_tpu/commands/dropfeature.py`
(`AlterTableDropFeatureDeltaCommand`, `PreDowngradeTableFeatureCommand.scala`).
Each removable feature (`_REMOVABLE`) has a pre-downgrade step that
erases its traces from the current version: the table property unset
(`_CONF_KEYS`), deletion vectors purged (`reorg_purge`, K8 on the card),
every file rewritten at a widened type (`reorg_rewrite_all`), the
column-mapping or default-value field metadata stripped, a classic
checkpoint written in place of a V2 one; CHECK constraints and live
domains must be dropped first. A reader-writer feature may still be
named by older commits and checkpoints, so it needs TRUNCATE HISTORY,
which checkpoints the head and deletes every log file the checkpoint
shadows at once (`log/cleanup.py`; the reference's 24-hour wait taken as
passed). Then the protocol is committed without the feature, collapsed to
legacy versions when no non-legacy feature remains (`Protocol.downgraded`).

The steps that commit refuse a table whose writer this package lacks
(row tracking, clustering, in-commit timestamps, V2 checkpoints:
`txn/transaction.py::check_write_supported` raises
`UnsupportedTableError`), as they refuse any other write to it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from delta_tpu_torch.errors import (
    FeatureDropError,
    FeatureDropHistoricalVersionsExistError,
)
from delta_tpu_torch.features import FEATURES, TableFeature, is_feature_supported
from delta_tpu_torch.models.actions import Protocol
from delta_tpu_torch.models.schema import (
    StructField,
    StructType,
    schema_from_json,
    schema_to_json,
)

DROP_FEATURE_OP = "DROP FEATURE"
ROW_TRACKING_DOMAIN = "delta.rowTracking"

# the features whose traces this command erases (`RemovableFeature`)
_REMOVABLE = {
    "deletionVectors",
    "inCommitTimestamp",
    "v2Checkpoint",
    "typeWidening",
    "rowTracking",
    "clustering",
    "vacuumProtocolCheck",
    "checkConstraints",
    "changeDataFeed",
    "columnMapping",
    "domainMetadata",
    "allowColumnDefaults",
}

# the table properties each feature's pre-downgrade removes
_CONF_KEYS: Dict[str, List[str]] = {
    "deletionVectors": ["delta.enableDeletionVectors"],
    "inCommitTimestamp": [
        "delta.enableInCommitTimestamps",
        "delta.inCommitTimestampEnablementVersion",
        "delta.inCommitTimestampEnablementTimestamp",
    ],
    "v2Checkpoint": ["delta.checkpointPolicy"],
    "typeWidening": ["delta.enableTypeWidening"],
    "rowTracking": ["delta.enableRowTracking"],
    "changeDataFeed": ["delta.enableChangeDataFeed"],
    "columnMapping": ["delta.columnMapping.mode",
                      "delta.columnMapping.maxColumnId"],
}


def drop_feature(table, feature_name: str,
                 truncate_history: bool = False) -> int:
    """Pre-downgrade `feature_name`, check that no trace is left, and
    commit the protocol without it; returns that commit's version."""
    feature = FEATURES.get(feature_name)
    if feature is None:
        raise FeatureDropError(
            f"unknown table feature {feature_name!r}; known features: "
            f"{sorted(FEATURES)}")
    if feature_name not in _REMOVABLE:
        raise FeatureDropError(
            f"feature {feature_name!r} cannot be dropped (not removable)",
            error_class="DELTA_FEATURE_DROP_NONREMOVABLE_FEATURE")
    proto = table.latest_snapshot().protocol
    if feature_name not in proto.writer_feature_set() and (
            feature_name not in proto.reader_feature_set()):
        if is_feature_supported(proto, feature):
            raise FeatureDropError(
                f"feature {feature_name!r} is implicitly supported by "
                f"protocol ({proto.minReaderVersion}, "
                f"{proto.minWriterVersion}) legacy versions; dropping legacy "
                "features requires them to be listed explicitly (writer "
                "version 7)",
                error_class="DELTA_FEATURE_DROP_IMPLICITLY_SUPPORTED")
        raise FeatureDropError(
            f"feature {feature_name!r} is not present on this table",
            error_class="DELTA_FEATURE_DROP_FEATURE_NOT_PRESENT")

    _pre_downgrade(table, feature_name)

    # a reader-writer feature leaves traces in older commits and
    # checkpoints, readable until the history is truncated
    if feature.is_reader_writer and feature_name != "vacuumProtocolCheck":
        if not truncate_history:
            raise FeatureDropHistoricalVersionsExistError(
                f"dropping reader+writer feature {feature_name!r} requires "
                "history truncation: historical versions may still carry the "
                "feature. Re-run with TRUNCATE HISTORY "
                "(drop_feature(..., truncate_history=True))")
        _truncate_history(table)
    return _commit_downgrade(table, feature)


def _strip_fields(meta, keep) -> Optional[StructType]:
    """The schema with each top-level field's metadata filtered by
    `keep(key)`; None when nothing changes."""
    schema = schema_from_json(meta.schemaString)
    stripped = StructType([dataclasses.replace(
        f, metadata={k: v for k, v in f.metadata.items() if keep(k)})
        for f in schema.fields])
    return None if stripped == schema else stripped


def _pre_downgrade(table, name: str) -> None:
    from delta_tpu_torch.commands.alter import unset_properties

    meta = table.latest_snapshot().metadata
    conf = meta.configuration

    if name == "deletionVectors":
        from delta_tpu_torch.commands.reorg import reorg_purge

        if conf.get("delta.enableDeletionVectors", "").lower() == "true":
            unset_properties(table, _CONF_KEYS[name])
        reorg_purge(table)
        still = [f for f in table.latest_snapshot().scan().files()
                 if f.deletionVector is not None]
        if still:
            raise FeatureDropError(
                f"{len(still)} file(s) still carry deletion vectors after "
                "purge", error_class="DELTA_FEATURE_DROP_STILL_ACTIVE")
        return

    if name == "checkConstraints":
        from delta_tpu_torch.constraints import table_constraints

        existing = table_constraints(conf)
        if existing:
            raise FeatureDropError(
                f"cannot drop checkConstraints: constraint(s) "
                f"{sorted(existing)} still exist — DROP CONSTRAINT them "
                "first",
                error_class="DELTA_CANNOT_DROP_CHECK_CONSTRAINT_FEATURE")
        return

    if name == "rowTracking":
        _strip_metadata_and_domains(table, conf_keys=_CONF_KEYS[name],
                                    domains=[ROW_TRACKING_DOMAIN])
        return

    if name == "clustering":
        from delta_tpu_torch.clustering import CLUSTERING_DOMAIN

        _strip_metadata_and_domains(table, conf_keys=[],
                                    domains=[CLUSTERING_DOMAIN])
        return

    if name == "columnMapping":
        schema = schema_from_json(meta.schemaString)
        renamed = [f.name for f in schema.fields if f.physical_name != f.name]
        if renamed:
            raise FeatureDropError(
                "cannot drop columnMapping: column(s) "
                f"{renamed} have physical names differing from their logical "
                "names (a rename or drop happened); rewrite the table first")
        _strip_metadata_and_domains(
            table, conf_keys=_CONF_KEYS[name], domains=[],
            new_schema=_strip_fields(
                meta, lambda k: not k.startswith("delta.columnMapping.")))
        return

    if name == "typeWidening":
        # files written before a widening read right only through the
        # feature: every file is rewritten at the wide type first
        from delta_tpu_torch.commands.reorg import reorg_rewrite_all

        if conf.get("delta.enableTypeWidening", "").lower() == "true":
            unset_properties(table, _CONF_KEYS[name])
        reorg_rewrite_all(table)
        return

    if name == "v2Checkpoint":
        keys = [k for k in _CONF_KEYS[name] if k in conf]
        if conf.get("delta.checkpointPolicy", "classic") != "classic":
            _strip_metadata_and_domains(table, conf_keys=keys, domains=[])
        table.checkpoint()  # a classic checkpoint at the head
        return

    if name == "allowColumnDefaults":
        stripped = _strip_fields(
            meta, lambda k: k not in ("CURRENT_DEFAULT", "EXISTS_DEFAULT"))
        if stripped is not None:
            _strip_metadata_and_domains(table, conf_keys=[], domains=[],
                                        new_schema=stripped)
        return

    if name == "domainMetadata":
        live = {d: dm for d, dm in
                table.latest_snapshot().state.domain_metadata.items()
                if not dm.removed}
        if live:
            raise FeatureDropError(
                f"cannot drop domainMetadata: live domain(s) {sorted(live)} "
                "still exist")
        return

    keys = [k for k in _CONF_KEYS.get(name, ()) if k in conf]
    if keys:
        unset_properties(table, keys)


def _strip_metadata_and_domains(table, conf_keys: List[str],
                                domains: List[str],
                                new_schema: Optional[StructType] = None
                                ) -> None:
    txn = table.create_transaction_builder(DROP_FEATURE_OP).build()
    meta = txn.metadata()
    conf = {k: v for k, v in meta.configuration.items()
            if k not in set(conf_keys)}
    replacement = dataclasses.replace(
        meta, configuration=conf,
        schemaString=(schema_to_json(new_schema) if new_schema is not None
                      else meta.schemaString))
    if replacement != meta:
        txn.update_metadata(replacement)
    for d in domains:
        if d in txn.read_snapshot.state.domain_metadata:
            txn.remove_domain_metadata(d)
    txn.set_operation_parameters({"preDowngrade": True})
    txn.commit()


def _truncate_history(table) -> None:
    """Checkpoint the head and delete every log file it shadows, whatever
    its age (TRUNCATE HISTORY with the reference's wait taken as
    passed)."""
    from delta_tpu_torch.log.cleanup import cleanup_expired_logs

    table.checkpoint()
    cleanup_expired_logs(table, retention_ms=0,
                         now_ms=int(time.time() * 1000) + 60_000)


def _commit_downgrade(table, feature: TableFeature) -> int:
    txn = table.create_transaction_builder(DROP_FEATURE_OP).build()
    if feature.activated_by is not None and feature.activated_by(
            txn.metadata()):
        raise FeatureDropError(
            f"feature {feature.name!r} is still active after pre-downgrade",
            error_class="DELTA_FEATURE_DROP_STILL_ACTIVE")
    txn.update_protocol(_downgraded_protocol(txn.protocol(), feature.name))
    txn.set_operation_parameters({"featureName": feature.name})
    return txn.commit().version


def _downgraded_protocol(proto: Protocol, name: str) -> Protocol:
    writer = proto.writer_feature_set() - {name}
    reader = proto.reader_feature_set() - {name}
    remaining = [FEATURES[n] for n in writer | reader if n in FEATURES]
    unknown = (writer | reader) - set(FEATURES)
    if not unknown and all(f.legacy for f in remaining):
        # collapsed to legacy versions (`Protocol.downgraded`)
        min_writer = max([f.min_writer_version for f in remaining],
                         default=2)
        min_reader = max([f.min_reader_version for f in remaining
                          if f.is_reader_writer], default=1)
        return Protocol(min_reader, min_writer)
    min_reader = 3 if reader else 1
    return Protocol(min_reader, 7,
                    readerFeatures=sorted(reader) if min_reader >= 3 else None,
                    writerFeatures=sorted(writer))

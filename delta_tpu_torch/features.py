"""The table features this package writes, and a new table's protocol.

A port-owned copy of the rules of `delta_tpu/features.py:20-200`
(`protocol_for_new_table`, after Delta's `Protocol.forNewTable`), cut to
the features the write path supports: appendOnly and invariants (legacy:
protocol (1, 2) carries them) and deletionVectors (a reader-writer
feature: (3, 7) with feature lists), and a table that lists
timestampNtz, whose columns the writer writes (a new table does not ask
for it, as the reference's does not). This module alone decides which
features the write path takes: `txn/transaction.py` refuses a table whose
protocol lists any other writer feature, and `protocol_for_new_table`
refuses a table property that would turn one on.
"""

from __future__ import annotations

from typing import Dict

from delta_tpu_torch.config import _parse_bool
from delta_tpu_torch.errors import UnsupportedTableError
from delta_tpu_torch.models.actions import Protocol

_LEGACY = ("appendOnly", "invariants")
_READER_WRITER = ("deletionVectors",)
SUPPORTED_WRITER_FEATURES = frozenset(_LEGACY + _READER_WRITER
                                      + ("timestampNtz",))
# the table property that turns on each supported feature (invariants:
# none, a column's metadata does)
_FEATURE_PROPERTIES = {"delta.appendOnly": "appendOnly",
                       "delta.enableDeletionVectors": "deletionVectors"}
# properties that would turn on a table feature this package does not write
_REFUSED_FLAGS = ("delta.enableChangeDataFeed",
                  "delta.enableRowTracking", "delta.enableTypeWidening",
                  "delta.enableIcebergCompatV1", "delta.enableIcebergCompatV2",
                  "delta.enableInCommitTimestamps",
                  "delta.enableChangeDataCapture")
_PROTOCOL_PROPS = ("delta.minReaderVersion", "delta.minWriterVersion",
                   "delta.ignoreProtocolDefaults")


def protocol_for_new_table(properties: Dict[str, str]) -> Protocol:
    """The least protocol that carries the features `properties` turn on:
    (1, 2) for legacy ones alone; with deletionVectors, (3, 7) with the
    reader-writer features listed for readers and every turned-on
    feature for writers. A property that would need another feature, or
    set the protocol itself, raises `UnsupportedTableError`."""
    needs = [k for k in _REFUSED_FLAGS if _parse_bool(properties.get(k, ""))]
    needs += [k for k in properties
              if k in _PROTOCOL_PROPS or k.startswith("delta.constraints.")]
    if properties.get("delta.columnMapping.mode", "none") != "none":
        needs.append("delta.columnMapping.mode")
    if properties.get("delta.checkpointPolicy", "classic") != "classic":
        needs.append("delta.checkpointPolicy")
    if needs:
        raise UnsupportedTableError(
            f"table properties {sorted(needs)} need table features this "
            "package does not write yet", feature="table properties")
    on = sorted(f for k, f in _FEATURE_PROPERTIES.items()
                if _parse_bool(properties.get(k, "")))
    if not any(f in _READER_WRITER for f in on):
        return Protocol(1, 2)
    return Protocol(3, 7,
                    readerFeatures=[f for f in on if f in _READER_WRITER],
                    writerFeatures=on)

"""State reconstruction: a log segment -> SnapshotState.

Counterpart of `delta_tpu/replay/state.py`:

1. Columnarize the segment (`replay/columnar.py`): checkpoint parts
   (device page decode, kernel K3), then commits (device parse, K1);
   replay lanes on the engine's device.
2. Replay on the device (`ops/replay.py`): stable sort by the exact
   `(path, dv)` key codes, then kernel K2 marks each file's newest action;
   a checkpoint-only load whose parts were keyed on the device already
   launched that replay in the handoff. The live-file and tombstone masks
   stay on the device.
3. Aggregates (`num_files`, `size_in_bytes`) reduce on the device; the
   `AddFile` / `RemoveFile` lists materialize on first access.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional

import torch

from delta_tpu_torch.errors import LogCorruptedError, UnsupportedTableFeatureError
from delta_tpu_torch.models.actions import (
    AddFile,
    CommitInfo,
    DomainMetadata,
    Metadata,
    Protocol,
    RemoveFile,
    SetTransaction,
)
from delta_tpu_torch.ops.replay import python_replay_reference, replay_select
from delta_tpu_torch.replay.columnar import (
    ColumnarActions,
    FileActions,
    columnarize_log_segment,
)


@dataclass(eq=False)
class SnapshotState:
    version: int
    protocol: Protocol
    metadata: Metadata
    set_transactions: Dict[str, SetTransaction]
    domain_metadata: Dict[str, DomainMetadata]
    file_actions: FileActions
    live_mask: torch.Tensor       # bool over file_actions rows, on the device
    tombstone_mask: torch.Tensor
    latest_commit_info: Optional[CommitInfo] = None
    commit_infos: Dict[int, CommitInfo] = field(default_factory=dict)
    timestamp_ms: int = 0
    # wall seconds of the load's phases (ckpt_*, read, parse, codes, replay)
    phase_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def num_files(self) -> int:
        return int(self.live_mask.sum())

    @property
    def size_in_bytes(self) -> int:
        return int(self.file_actions.size[self.live_mask].sum())

    @cached_property
    def add_files(self) -> List[AddFile]:
        """Live files, in row order (materialized once)."""
        idx = torch.nonzero(self.live_mask).squeeze(1).cpu().numpy()
        return self.file_actions.rows.add_files(idx)

    @cached_property
    def tombstones(self) -> List[RemoveFile]:
        idx = torch.nonzero(self.tombstone_mask).squeeze(1).cpu().numpy()
        return self.file_actions.rows.remove_files(idx)


def compute_masks_device(columnar: ColumnarActions):
    """(live, tombstone) bool masks by the device replay."""
    fa = columnar.file_actions
    return replay_select([fa.path_code, fa.dv_code], fa.version, fa.order,
                         fa.is_add)


def compute_masks_host(columnar: ColumnarActions):
    """(live, tombstone) by the sequential reference replay, a hash map
    over the rows in (version, order) order; masks come back on the lanes'
    device."""
    fa = columnar.file_actions
    keys = list(zip(fa.path_code.tolist(), fa.dv_code.tolist()))
    live, tomb = python_replay_reference(
        keys, fa.version.cpu().numpy(), fa.order.cpu().numpy(),
        fa.is_add.cpu().numpy())
    dev = fa.is_add.device
    return torch.from_numpy(live).to(dev), torch.from_numpy(tomb).to(dev)


SUPPORTED_READER_FEATURES = frozenset(
    {
        "deletionVectors",
        "columnMapping",
        "timestampNtz",
        "typeWidening",
        "typeWidening-preview",
        "v2Checkpoint",
        "vacuumProtocolCheck",
        "variantType",
        "variantType-preview",
        "inCommitTimestamp",
        "domainMetadata",
        "rowTracking",
        "clustering",
        "appendOnly",
        "invariants",
        "checkConstraints",
        "changeDataFeed",
        "generatedColumns",
        "identityColumns",
        "allowColumnDefaults",
        "icebergCompatV1",
        "icebergCompatV2",
        "liquid",
    }
)
MAX_READER_VERSION = 3


def check_read_supported(protocol: Protocol) -> None:
    """Protocol gate: reader version <= 3 and, at (3, 7), every reader
    feature must be one the JAX package implements."""
    if protocol.minReaderVersion > MAX_READER_VERSION:
        raise UnsupportedTableFeatureError(
            {f"readerVersion={protocol.minReaderVersion}"})
    unsupported = protocol.reader_feature_set() - SUPPORTED_READER_FEATURES
    if unsupported:
        raise UnsupportedTableFeatureError(unsupported)


def reconstruct_state(engine, segment) -> SnapshotState:
    """Full state reconstruction of a log segment."""
    columnar = columnarize_log_segment(engine, segment)
    if columnar.protocol is None or columnar.metadata is None:
        raise LogCorruptedError(
            f"log segment for version {segment.version} has no "
            f"{'protocol' if columnar.protocol is None else 'metadata'} action")
    check_read_supported(columnar.protocol)
    t0 = time.perf_counter()
    if columnar.pending is not None:  # the checkpoint handoff's replay
        live, tomb = columnar.pending.finish()
    else:
        live, tomb = compute_masks_device(columnar)
    engine.synchronize()
    phases = dict(columnar.phase_seconds, replay=time.perf_counter() - t0)
    return SnapshotState(
        version=segment.version,
        protocol=columnar.protocol,
        metadata=columnar.metadata,
        set_transactions=columnar.set_transactions,
        domain_metadata=columnar.domain_metadata,
        file_actions=columnar.file_actions,
        live_mask=live,
        tombstone_mask=tomb,
        latest_commit_info=columnar.latest_commit_info,
        commit_infos=columnar.commit_infos,
        timestamp_ms=segment.last_commit_timestamp,
        phase_seconds=phases,
    )


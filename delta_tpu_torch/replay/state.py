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

`reconstruct_small_state` resolves the small actions alone (the P&M fast
path: no file action is decoded); `advance_state` replays a batch of new
commits on top of a retained state (`Snapshot.update()`), bit for bit the
state a cold load of the new version builds from the same checkpoint.
Counters: `replay.reconstructs` (full loads), `replay.small_loads`,
`replay.advances`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional

import numpy as np
import torch

from delta_tpu_torch import obs
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
from delta_tpu_torch.ops.replay import (
    advance_masks,
    python_replay_reference,
    replay_select,
)
from delta_tpu_torch.replay.columnar import (
    ColumnarActions,
    CompositeRows,
    FileActions,
    columnarize_log_segment,
)

_RECONSTRUCTS = obs.counter("replay.reconstructs")
_SMALL_LOADS = obs.counter("replay.small_loads")
_ADVANCES = obs.counter("replay.advances")


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
    # the resident stats index (stats/device_index.py), built on the first
    # filtered scan under its own lock (not shared with anything else)
    stats_index: Optional[object] = field(default=None, repr=False)
    stats_index_lock: object = field(default_factory=threading.Lock,
                                     repr=False)

    @property
    def num_files(self) -> int:
        return int(self.live_mask.sum())

    @property
    def size_in_bytes(self) -> int:
        return int(self.file_actions.size[self.live_mask].sum())

    @cached_property
    def live_rows(self) -> np.ndarray:
        """Row indices of the live files, ascending (the order of
        `add_files`, of a scan's files and of the stats index)."""
        return torch.nonzero(self.live_mask).squeeze(1).cpu().numpy()

    @cached_property
    def add_files(self) -> List[AddFile]:
        """Live files, in row order (materialized once)."""
        return self.file_actions.rows.add_files(self.live_rows)

    def live_stats(self) -> List[Optional[str]]:
        """The live files' stats strings, in row order, without
        materializing their actions."""
        return self.file_actions.rows.stats(self.live_rows)

    def file_refs(self) -> tuple:
        """(live flags, paths, deletion timestamps, DV descriptors) of the
        live files and the tombstones, in row order: the rows the masks
        pick on the device, their three leaves from the row store alone
        (VACUUM's protected set; no action is built)."""
        keep = self.live_mask | self.tombstone_mask
        idx = torch.nonzero(keep).squeeze(1).cpu().numpy()
        return (self.live_mask[keep].cpu().numpy(),
                *self.file_actions.rows.refs(idx))

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


def _require_pm(columnar: ColumnarActions, version: int,
                error_class: Optional[str] = None) -> None:
    if columnar.protocol is None or columnar.metadata is None:
        raise LogCorruptedError(
            f"log segment for version {version} has no "
            f"{'protocol' if columnar.protocol is None else 'metadata'} "
            f"action", error_class=error_class)
    check_read_supported(columnar.protocol)


@dataclass
class SmallState:
    """Protocol, metadata, txns, domains and commitInfos WITHOUT the file
    replay: the checkpoint's small-action columns alone and the tail's
    control lines (the reference's P&M fast path), for metadata-only
    readers of a large table."""

    version: int
    protocol: Protocol
    metadata: Metadata
    set_transactions: Dict[str, SetTransaction]
    domain_metadata: Dict[str, DomainMetadata]
    latest_commit_info: Optional[CommitInfo] = None
    commit_infos: Dict[int, CommitInfo] = field(default_factory=dict)
    timestamp_ms: int = 0


def reconstruct_small_state(engine, segment) -> SmallState:
    """Small-action-only reconstruction (see SmallState)."""
    _SMALL_LOADS.inc()
    columnar = columnarize_log_segment(engine, segment, small_only=True)
    _require_pm(columnar, segment.version, "DELTA_STATE_RECOVER_ERROR")
    return SmallState(
        version=segment.version,
        protocol=columnar.protocol,
        metadata=columnar.metadata,
        set_transactions=columnar.set_transactions,
        domain_metadata=columnar.domain_metadata,
        latest_commit_info=columnar.latest_commit_info,
        commit_infos=columnar.commit_infos,
        timestamp_ms=segment.last_commit_timestamp,
    )


def reconstruct_state(engine, segment) -> SnapshotState:
    """Full state reconstruction of a log segment."""
    _RECONSTRUCTS.inc()
    columnar = columnarize_log_segment(engine, segment)
    _require_pm(columnar, segment.version)
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



def advance_state(engine, prev: SnapshotState, delta: ColumnarActions,
                  new_segment) -> SnapshotState:
    """Replay a batch of new commits on top of a retained state (the
    incremental half of `Snapshot.update()`). The new state's lanes are
    the prior lanes followed by the delta's, its row store the prior's
    followed by the delta's; the delta's keys are coded into the prior's
    code space exactly (`KeySpace.absorb`), the delta replays on the
    device and every prior row whose key it touches loses its mask bits
    (`ops/replay.py::advance_masks`). Bit for bit the masks a cold load of
    the new segment computes from the same checkpoint.

    The caller handles a protocol change in the delta before this (a full
    load): a new protocol can change how earlier actions are read."""
    _ADVANCES.inc()
    t0 = time.perf_counter()
    pfa, dfa = prev.file_actions, delta.file_actions
    n_prev, m = pfa.num_rows, dfa.num_rows
    if m == 0:
        fa, live, tomb = pfa, prev.live_mask, prev.tombstone_mask
    else:
        d_path, d_dv, keys = pfa.keys.absorb(dfa.keys, dfa.path_code,
                                             dfa.dv_code)
        live, tomb = advance_masks(
            pfa.path_code, pfa.dv_code, prev.live_mask, prev.tombstone_mask,
            d_path, d_dv, dfa.version, dfa.order, dfa.is_add,
            len(keys.dv_ids))
        fa = FileActions(
            is_add=torch.cat([pfa.is_add, dfa.is_add]),
            version=torch.cat([pfa.version, dfa.version]),
            order=torch.cat([pfa.order, dfa.order]),
            size=torch.cat([pfa.size, dfa.size]),
            path_code=torch.cat([pfa.path_code, d_path]),
            dv_code=torch.cat([pfa.dv_code, d_dv]),
            rows=CompositeRows.chain(pfa.rows, n_prev, dfa.rows),
            keys=keys)
    engine.synchronize()
    set_txns = dict(prev.set_transactions)
    set_txns.update(delta.set_transactions)
    domains = dict(prev.domain_metadata)
    domains.update(delta.domain_metadata)
    commit_infos = dict(prev.commit_infos)
    commit_infos.update(delta.commit_infos)
    new_state = SnapshotState(
        version=new_segment.version,
        protocol=delta.protocol or prev.protocol,
        metadata=delta.metadata or prev.metadata,
        set_transactions=set_txns,
        domain_metadata=domains,
        file_actions=fa,
        live_mask=live,
        tombstone_mask=tomb,
        latest_commit_info=(delta.latest_commit_info
                            or prev.latest_commit_info),
        commit_infos=commit_infos,
        timestamp_ms=new_segment.last_commit_timestamp,
        phase_seconds=dict(delta.phase_seconds,
                           advance=time.perf_counter() - t0),
    )
    with prev.stats_index_lock:
        stats_index, prev.stats_index = prev.stats_index, None
    if stats_index is not None:
        if m == 0:
            # no file action: the live files are unchanged, so the index
            # is still exact and moves to the new state
            new_state.stats_index = stats_index
        else:
            # stale lanes: free them now; the next scan rebuilds
            stats_index.release()
    return new_state

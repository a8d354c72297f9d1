"""Conflict detection against winning commits.

Counterpart of `delta_tpu/txn/conflict.py:57-245`. After losing the
put-if-absent race at version v, the transaction reads the winning
commits [v, latest] and checks, per winner, in order:

1. a protocol change           -> ProtocolChangedError
2. a metadata change           -> MetadataChangedError
3. added files our read may have seen (per isolation level)
                                -> ConcurrentAppendError
4. a removed file we read      -> ConcurrentDeleteReadError
5. a removed file we remove    -> ConcurrentDeleteDeleteError
6. an idempotent-txn appId we read advanced
                                -> ConcurrentTransactionError

If nothing conflicts, the transaction rebases and retries at latest + 1.
Step 3 asks which of a winner's adds the transaction's read may have seen
(`_matching_adds`): all of them after a whole-table read, none without a
read, else those that some read predicate may match: a partition
conjunct evaluated exactly over the add's partitionValues, a data
conjunct through `stats/skipping.py::skipping_mask` over the winner's own
stats strings (without a state: the ladder alone, never the snapshot's
resident lanes); a conjunct that cannot be evaluated widens to "may
match". The port writes no domain metadata, so no domain can conflict.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set

import numpy as np

from delta_tpu_torch.errors import (
    ConcurrentAppendError,
    ConcurrentDeleteDeleteError,
    ConcurrentDeleteReadError,
    ConcurrentTransactionError,
    MetadataChangedError,
    ProtocolChangedError,
)
from delta_tpu_torch.models.actions import (
    AddFile,
    CommitInfo,
    Metadata,
    Protocol,
    RemoveFile,
    SetTransaction,
)
from delta_tpu_torch.expressions.tree import split_conjuncts
from delta_tpu_torch.txn.isolation import IsolationLevel

_log = logging.getLogger(__name__)


@dataclass
class WinningCommit:
    version: int
    actions: list

    @property
    def is_blind_append(self) -> bool:
        for a in self.actions:
            if isinstance(a, CommitInfo) and a.isBlindAppend is not None:
                return bool(a.isBlindAppend)
        # conservatively not blind if it holds removes
        return not any(isinstance(a, RemoveFile) for a in self.actions)


@dataclass
class TransactionReadState:
    """What the losing transaction read and intends to write."""

    read_predicates: list = field(default_factory=list)
    read_whole_table: bool = False
    read_files: Set[tuple] = field(default_factory=set)    # (path, dv_id)
    read_app_ids: Set[str] = field(default_factory=set)
    removed_keys: Set[tuple] = field(default_factory=set)  # (path, dv_id)
    partition_columns: List[str] = field(default_factory=list)
    isolation: IsolationLevel = IsolationLevel.WRITE_SERIALIZABLE
    metadata: Optional[Metadata] = None


def _matching_adds(adds: Sequence[AddFile],
                   state: TransactionReadState) -> np.ndarray:
    """May-match mask over a winner's adds (reference
    `txn/conflict.py:98-160`, `ConflictChecker.scala:584`). Per read
    predicate, a conjunction: a file may match unless some conjunct is
    disproved for it, exactly over partitionValues for a partition-only
    conjunct, by min/max/nullCount stats for a data conjunct. A conjunct
    that cannot be evaluated widens to true (over-approximating the match
    set only adds conflicts); missing stats keep the file."""
    n = len(adds)
    if state.read_whole_table:
        return np.ones(n, bool)
    if not state.read_predicates:
        return np.zeros(n, bool)
    from delta_tpu_torch.expressions.eval import evaluate_predicate
    from delta_tpu_torch.stats.partition import partition_values_to_batch
    from delta_tpu_torch.stats.skipping import skipping_mask

    pcols = set(state.partition_columns)
    pbatch = None
    stats = [a.stats for a in adds]
    may = np.zeros(n, bool)
    for pred in state.read_predicates:
        alive = np.ones(n, bool)
        for conj in split_conjuncts(pred):
            refs = conj.references()
            if refs and all(r[0] in pcols for r in refs):
                if pbatch is None:
                    pbatch = partition_values_to_batch(
                        [a.partitionValues for a in adds],
                        state.partition_columns, state.metadata)
                try:
                    alive &= evaluate_predicate(conj, pbatch)
                except Exception as e:  # unevaluable: widen (sound)
                    _log.debug("partition predicate unevaluable for the "
                               "conflict check, widening: %s", e)
            else:
                try:
                    alive &= skipping_mask(stats, [conj], state.metadata)
                except Exception as e:  # unevaluable: widen (sound)
                    _log.debug("stats predicate unevaluable for the "
                               "conflict check, widening: %s", e)
        may |= alive
        if may.all():
            break
    return may


def check_conflicts(state: TransactionReadState,
                    winners: Sequence[WinningCommit]) -> None:
    """Raises a ConcurrentModificationError subclass on a logical
    conflict; returns when the transaction may rebase past `winners`."""
    for w in winners:
        for a in w.actions:
            if isinstance(a, Protocol):
                raise ProtocolChangedError(
                    f"protocol changed by concurrent commit {w.version}")
            if isinstance(a, Metadata):
                raise MetadataChangedError(
                    f"metadata changed by concurrent commit {w.version}")
        check_appends = (
            state.isolation == IsolationLevel.SERIALIZABLE
            or (state.isolation == IsolationLevel.WRITE_SERIALIZABLE
                and not w.is_blind_append))
        adds: List[AddFile] = [a for a in w.actions
                               if isinstance(a, AddFile)] \
            if check_appends else []
        if adds:
            mask = _matching_adds(adds, state)
            if mask.any():
                raise ConcurrentAppendError(
                    f"files added by concurrent commit {w.version} may "
                    f"match this transaction's read predicate: "
                    f"{adds[int(mask.argmax())].path}")
        for a in w.actions:
            if isinstance(a, RemoveFile):
                key = (a.path, a.dv_unique_id)
                if key in state.read_files:
                    raise ConcurrentDeleteReadError(
                        f"file read by this transaction was removed by "
                        f"concurrent commit {w.version}: {a.path}")
                if key in state.removed_keys:
                    raise ConcurrentDeleteDeleteError(
                        f"file removed by both this transaction and "
                        f"concurrent commit {w.version}: {a.path}")
            if isinstance(a, SetTransaction) \
                    and a.appId in state.read_app_ids:
                raise ConcurrentTransactionError(
                    f"idempotent-transaction appId {a.appId} advanced by "
                    f"concurrent commit {w.version}")

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
The port's transactions read either the whole table or nothing (a scan
with a predicate is a later slice), so step 3 needs no predicate
evaluation: with a whole-table read every checked add may match. The
port writes no domain metadata, so no domain can conflict.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Set

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
from delta_tpu_torch.txn.isolation import IsolationLevel


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

    read_whole_table: bool = False
    read_files: Set[tuple] = field(default_factory=set)    # (path, dv_id)
    read_app_ids: Set[str] = field(default_factory=set)
    removed_keys: Set[tuple] = field(default_factory=set)  # (path, dv_id)
    isolation: IsolationLevel = IsolationLevel.WRITE_SERIALIZABLE


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
        if check_appends and state.read_whole_table:
            adds: List[AddFile] = [a for a in w.actions
                                   if isinstance(a, AddFile)]
            if adds:
                raise ConcurrentAppendError(
                    f"files added by concurrent commit {w.version} may "
                    f"match this transaction's read predicate: "
                    f"{adds[0].path}")
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

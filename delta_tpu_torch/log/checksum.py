"""Per-version `.crc` checksum files.

Counterpart of `delta_tpu/log/checksum.py`: after each commit a
`%020d.crc` JSON document records the table's state summary at that
version (tableSizeBytes, numFiles, protocol, metadata, txnId).
`write_checksum_for_commit` derives it from the previous version's
`.crc` plus the commit's own actions, without a replay, and writes
nothing when the chain is broken (no previous `.crc`, or a remove without
a size); `write_checksum_from_state` writes it from a loaded state (a
checkpoint reseeds the chain); `validate_state_against_checksum` holds a
replayed state to it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from delta_tpu_torch.errors import ChecksumMismatchError
from delta_tpu_torch.models.actions import Metadata, Protocol
from delta_tpu_torch.utils import filenames


@dataclass
class VersionChecksum:
    tableSizeBytes: int
    numFiles: int
    numMetadata: int
    numProtocol: int
    metadata: Metadata
    protocol: Protocol
    txnId: Optional[str] = None
    inCommitTimestamp: Optional[int] = None
    numDeletedRecordsOpt: Optional[int] = None
    numDeletionVectorsOpt: Optional[int] = None

    def to_json(self) -> str:
        d = {
            "tableSizeBytes": self.tableSizeBytes,
            "numFiles": self.numFiles,
            "numMetadata": self.numMetadata,
            "numProtocol": self.numProtocol,
            "metadata": self.metadata.to_dict(),
            "protocol": self.protocol.to_dict(),
        }
        for key, v in (("txnId", self.txnId),
                       ("inCommitTimestampOpt", self.inCommitTimestamp),
                       ("numDeletedRecordsOpt", self.numDeletedRecordsOpt),
                       ("numDeletionVectorsOpt", self.numDeletionVectorsOpt)):
            if v is not None:
                d[key] = v
        return json.dumps(d, separators=(",", ":"))

    @staticmethod
    def from_json(data) -> "VersionChecksum":
        d = json.loads(data)
        return VersionChecksum(
            tableSizeBytes=int(d["tableSizeBytes"]),
            numFiles=int(d["numFiles"]),
            numMetadata=int(d.get("numMetadata", 1)),
            numProtocol=int(d.get("numProtocol", 1)),
            metadata=Metadata.from_dict(d["metadata"]),
            protocol=Protocol.from_dict(d["protocol"]),
            txnId=d.get("txnId"),
            inCommitTimestamp=d.get("inCommitTimestampOpt"),
            numDeletedRecordsOpt=d.get("numDeletedRecordsOpt"),
            numDeletionVectorsOpt=d.get("numDeletionVectorsOpt"),
        )


def read_checksum(fs, log_path: str, version: int
                  ) -> Optional[VersionChecksum]:
    try:
        return VersionChecksum.from_json(
            fs.read_file(filenames.checksum_file(log_path, version)))
    except (FileNotFoundError, ValueError, KeyError):
        return None


def _write(fs, log_path: str, version: int, crc: VersionChecksum) -> None:
    fs.write(filenames.checksum_file(log_path, version),
             crc.to_json().encode(), overwrite=True)


def write_checksum_from_state(fs, log_path: str, state) -> None:
    ci = state.commit_infos.get(state.version)
    _write(fs, log_path, state.version, VersionChecksum(
        tableSizeBytes=state.size_in_bytes, numFiles=state.num_files,
        numMetadata=1, numProtocol=1, metadata=state.metadata,
        protocol=state.protocol,
        inCommitTimestamp=ci.inCommitTimestamp if ci is not None else None))


def write_checksum_for_commit(table, txn, version: int) -> None:
    """The `.crc` of `version` from the previous version's and the
    transaction's staged actions; nothing when the chain is broken."""
    fs = table.engine.fs
    log_path = table.log_path
    if version == 0:
        prev_size, prev_files = 0, 0
    else:
        prev = read_checksum(fs, log_path, version - 1)
        if prev is None:
            return
        prev_size, prev_files = prev.tableSizeBytes, prev.numFiles
    adds, removes = txn._adds, txn._removes
    if any(r.size is None for r in removes):
        return  # the size cannot be derived exactly
    new_size = (prev_size + sum(a.size for a in adds)
                - sum(r.size for r in removes))
    new_files = prev_files + len(adds) - len(removes)
    if new_files < 0 or new_size < 0:
        return
    _write(fs, log_path, version, VersionChecksum(
        tableSizeBytes=new_size, numFiles=new_files, numMetadata=1,
        numProtocol=1, metadata=txn.metadata(), protocol=txn.protocol(),
        txnId=txn.txn_id))


def validate_state_against_checksum(state, crc: VersionChecksum) -> None:
    """The replayed state must match the stored summary exactly
    (`ValidateChecksum`)."""
    problems = []
    if state.num_files != crc.numFiles:
        problems.append(f"numFiles {state.num_files} != crc {crc.numFiles}")
    if state.size_in_bytes != crc.tableSizeBytes:
        problems.append(f"tableSizeBytes {state.size_in_bytes} != crc "
                        f"{crc.tableSizeBytes}")
    if state.protocol.to_dict() != crc.protocol.to_dict():
        problems.append("protocol mismatch")
    if state.metadata.id != crc.metadata.id:
        problems.append("metadata id mismatch")
    if problems:
        raise ChecksumMismatchError(
            "; ".join(problems), error_class="DELTA_TXN_LOG_FAILED_INTEGRITY")

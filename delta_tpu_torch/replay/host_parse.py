"""Line tags, and the host parser the device parse hands a buffer back to.

`line_tags` is the counterpart of `delta_tpu/replay/native_parse.py::
line_tags`, in PyTorch ops so that it runs where the lanes are. The host
parser is a plain stdlib `json.loads` per line: the JAX package sends a
whole buffer to its host scanner when a window holds a line the device
pass does not parse exactly (deletion vectors, tags, non-empty
partitionValues, unknown or repeated keys, a bad control line); this is
that host side. It is the reference's own semantics, not a fallback that
hides a device failure: an error on the device still raises.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.errors import LogCorruptedError, TornCommitError
from delta_tpu_torch.models.actions import (
    AddFile,
    DeletionVectorDescriptor,
    RemoveFile,
    decode_path,
)
from delta_tpu_torch.replay.columnar import FileActions, ParsedCommits
from delta_tpu_torch.replay.keys import KeySpace

_TORN_COMMITS = obs.counter("log.torn_commits")


def line_tags(line_starts: torch.Tensor, file_starts: torch.Tensor,
              file_versions: torch.Tensor):
    """(version int64, order int32) per line: the file a line's byte
    offset falls in gives its version; order is the line's rank within
    that file. All int64 tensors on one device; `file_starts` has one
    more entry than `file_versions`."""
    file_of_line = torch.searchsorted(file_starts, line_starts,
                                      right=True) - 1
    first_line = torch.searchsorted(line_starts, file_starts[:-1])
    versions = file_versions[file_of_line]
    orders = (torch.arange(line_starts.shape[0], device=line_starts.device)
              - first_line[file_of_line]).to(torch.int32)
    return versions, orders


class DictRows:
    """Host row store of the host parser: each file-action row keeps its
    parsed JSON body, materialized the way the JAX package's canonical
    table is (absent dataChange reads False, an empty partitionValues map
    on a remove reads None)."""

    def __init__(self, bodies: List[dict]):
        self.bodies = bodies

    def paths(self, idx: np.ndarray) -> List[str]:
        return [decode_path(self.bodies[i]["path"]) for i in idx.tolist()]

    def stats(self, idx: np.ndarray) -> List[Optional[str]]:
        return [self.bodies[i].get("stats") for i in idx.tolist()]

    def refs(self, idx: np.ndarray) -> tuple:
        """(paths, deletion timestamps, DV descriptors) of rows `idx`."""
        rows = [self.bodies[i] for i in idx.tolist()]
        return ([decode_path(b["path"]) for b in rows],
                [b.get("deletionTimestamp") for b in rows],
                [DeletionVectorDescriptor.from_dict(b.get("deletionVector"))
                 for b in rows])

    def dv_ids(self, idx: np.ndarray) -> List[Optional[str]]:
        return [_dv_unique_id(self.bodies[i].get("deletionVector"))
                for i in idx.tolist()]

    def path_rows(self, device):
        """The raw (not percent-decoded) path bytes of every row, as the
        device parse lays them out, to code them beside checkpoint rows."""
        from delta_tpu_torch.log.parquet_host import Strings
        from delta_tpu_torch.replay.columnar import _PathRows

        mat, lens = Strings.from_list(
            [b["path"] for b in self.bodies]).matrix()
        return _PathRows(mat, lens, device)

    def add_files(self, idx: np.ndarray) -> List[AddFile]:
        out = []
        for i in idx.tolist():
            d = self.bodies[i]
            out.append(AddFile(
                path=decode_path(d["path"]),
                partitionValues=dict(d.get("partitionValues") or {}),
                size=d.get("size") or 0,
                modificationTime=d.get("modificationTime") or 0,
                dataChange=bool(d.get("dataChange")),
                stats=d.get("stats"),
                tags=dict(d["tags"]) if d.get("tags") is not None else None,
                deletionVector=DeletionVectorDescriptor.from_dict(
                    d.get("deletionVector")),
                baseRowId=d.get("baseRowId"),
                defaultRowCommitVersion=d.get("defaultRowCommitVersion"),
                clusteringProvider=d.get("clusteringProvider"),
            ))
        return out

    def remove_files(self, idx: np.ndarray) -> List[RemoveFile]:
        out = []
        for i in idx.tolist():
            d = self.bodies[i]
            out.append(RemoveFile(
                path=decode_path(d["path"]),
                deletionTimestamp=d.get("deletionTimestamp"),
                dataChange=bool(d.get("dataChange")),
                extendedFileMetadata=d.get("extendedFileMetadata"),
                partitionValues=dict(d.get("partitionValues") or {}) or None,
                size=d.get("size"),
                stats=d.get("stats"),
                tags=dict(d["tags"]) if d.get("tags") is not None else None,
                deletionVector=DeletionVectorDescriptor.from_dict(
                    d.get("deletionVector")),
                baseRowId=d.get("baseRowId"),
                defaultRowCommitVersion=d.get("defaultRowCommitVersion"),
            ))
        return out


def _dv_unique_id(dv: Optional[dict]) -> Optional[str]:
    if dv is None:
        return None
    return DeletionVectorDescriptor.from_dict(dv).unique_id


def parse_commits_host(buf, file_starts: np.ndarray,
                       file_versions: np.ndarray, device) -> ParsedCommits:
    """Parse one concatenated commit buffer line by line with
    `json.loads`. Lanes are built on `device`; the replay key codes are
    exact dictionary codes (a dict over the decoded path strings and the
    deletion-vector unique ids)."""
    arr = np.frombuffer(buf, np.uint8)
    ends = np.flatnonzero(arr == 10)
    starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
    versions, orders = line_tags(torch.from_numpy(starts),
                                 torch.from_numpy(file_starts),
                                 torch.from_numpy(file_versions))
    versions = versions.numpy()
    orders = orders.numpy()
    mv = memoryview(buf)

    bodies: List[dict] = []
    rows: List[int] = []
    is_add: List[bool] = []
    others = []
    for ln, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        if e == s:
            continue  # the empty line between two commit files
        try:
            row = json.loads(mv[s:e].tobytes())
        except ValueError as err:
            _raise_commit_parse_error(
                buf, file_starts, file_versions,
                f"commit {int(versions[ln])} line {int(orders[ln])} is not "
                f"valid JSON: {err}", int(versions[ln]), err)
        if not isinstance(row, dict):
            raise LogCorruptedError(
                f"commit {int(versions[ln])} line {int(orders[ln])} is not "
                f"a JSON object", version=int(versions[ln]))
        file_keys = [k for k in ("add", "remove") if row.get(k) is not None]
        for k in file_keys:
            bodies.append(row[k])
            rows.append(ln)
            is_add.append(k == "add")
        if not file_keys:
            others.append((int(versions[ln]), int(orders[ln]), row))

    path_codes: dict = {}
    dv_codes: dict = {None: 0}
    pc = np.fromiter((path_codes.setdefault(decode_path(b["path"]),
                                            len(path_codes))
                      for b in bodies), np.int64, len(bodies))
    dc = np.fromiter((dv_codes.setdefault(_dv_unique_id(b.get("deletionVector")),
                                          len(dv_codes))
                      for b in bodies), np.int64, len(bodies))
    size = np.fromiter((b.get("size") or 0 for b in bodies), np.int64,
                       len(bodies))
    line = np.asarray(rows, np.int64)

    def lane(a):
        return torch.from_numpy(a).to(device)

    fa = FileActions(
        is_add=lane(np.asarray(is_add, bool)),
        version=lane(versions[line]),
        order=lane(orders[line]),
        size=lane(size),
        path_code=lane(pc),
        dv_code=lane(dc),
        rows=DictRows(bodies),
        keys=KeySpace.of_strings(list(path_codes), device, dv_codes),
    )
    return ParsedCommits(file_actions=fa, others=others)


def _json_line_ok(line: bytes) -> bool:
    try:
        json.loads(line)
        return True
    except ValueError:
        return False


def _raise_commit_parse_error(buf, file_starts: np.ndarray,
                              file_versions: np.ndarray, detail: str,
                              version: int, cause: Exception):
    """Diagnose a commit that fails to parse before raising (port of the
    reference's `_raise_commit_parse_error`). A writer that crashed on a
    store without atomic puts leaves the NEWEST commit of the buffer
    ending in a torn line, every earlier line of it intact: that shape
    raises `TornCommitError` with the newest version (the snapshot can
    serve the version before it). Anything else is damage the log's
    history depends on: `LogCorruptedError`."""
    tip = int(np.argmax(file_versions))
    # each file is followed by one newline in the buffer
    blob = bytes(buf[int(file_starts[tip]):int(file_starts[tip + 1]) - 1])
    lines = [ln for ln in blob.split(b"\n") if ln.strip()]
    if (lines and not _json_line_ok(lines[-1])
            and all(_json_line_ok(ln) for ln in lines[:-1])):
        _TORN_COMMITS.inc()
        tip_v = int(file_versions[tip])
        raise TornCommitError(
            f"commit {tip_v} ends with a torn JSON line (interrupted "
            f"write); earlier lines are intact", version=tip_v) from cause
    raise LogCorruptedError(detail, version=version) from cause

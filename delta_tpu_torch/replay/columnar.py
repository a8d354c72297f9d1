"""Columnarization: a log segment -> replay lanes on the device.

Counterpart of `delta_tpu/replay/columnar.py`. Two halves:

- Checkpoint parts (`_read_checkpoint`): each Parquet part, and each
  sidecar a V2 checkpoint names (`_sidecars/<name>`, or the name itself
  when it holds a '/'), reads through
  `log/page_decode.py::read_checkpoint_part`: the device decode (kernel
  K3) for the projected hot columns, the host leaf reader for the rest,
  the whole part on the host when the plan is out of scope
  (`decode.device_parts` / `decode.device_fallbacks` count the parts that
  hold file-action columns). Checkpoint rows come first, with `version =
  checkpoint_version` and `order = arange`, part by part (a part's
  sidecars right after it), each part's adds before its removes. A part
  whose add stats exist only as `stats_parsed` structs gets them
  re-serialized to JSON on first access (`stats/parsed.py`), as the
  reference's `_stats_from_parsed` does.
- JSON files: a V2 checkpoint's JSON top level (at the checkpoint's
  version), the compacted deltas (each at its last version) and the
  single commits, read in parallel into ONE buffer
  (`_read_commits_buffer`); the device parse (`replay/device_parse.py`,
  kernel K1) turns it into per-row lanes in line order, or, when the JAX
  package's ladder sends the buffer back to the host, the host parser
  (`replay/host_parse.py`) does. A JSON top level is parsed before the
  checkpoint's Parquet, since its `sidecar` lines name the sidecars.

Either way the result is a `FileActions`:

- lanes on the engine's device, one row per add/remove action: `is_add`,
  `version`, `order` (the row's line rank within its commit), `size`
  (0 where absent), and the replay key `(path_code, dv_code)`, exact
  dictionary codes of the percent-decoded path and of the deletion
  vector's unique id (0 = none). Path codes of checkpoint and commit rows
  come from one `torch.unique` over their zero-padded path byte rows;
  a checkpoint-only load whose parts are all dictionary-keyed takes the
  handoff instead (`ops/page_decode.py::launch_checkpoint_handoff`),
  which also launches the replay;
- a host-side row store that materializes `AddFile` / `RemoveFile`
  objects for the rows a caller asks for (stats decoded on that first
  access).

The small actions (protocol, metaData, txn, domainMetadata, commitInfo)
resolve host-side, latest (version, order) wins; the checkpoint's rows
come before every commit's. A `small_only` read resolves them alone, from
the checkpoint's small-action columns (no add or remove leaf read, no
device decode) and the tail's control lines: the P&M fast path.
`columnarize_commit_blobs` takes commits already in memory (the bytes a
transaction just wrote) through the same parse as commits read from disk.

A sidecar or part that vanished after the listing raises
`LogCorruptedError` (DELTA_MISSING_PART_FILES), damage
(`DecodeCorrupt`) `LogCorruptedError`, and a part outside what the
readers decode (`DecodeUnsupported`: an LZ4 or Brotli part or sidecar)
`UnsupportedLogError`. ZSTD and GZIP parts decode through the device
plan like snappy ones; a part with data page v2 reads on the host.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.errors import (
    CorruptLogError,
    LogCorruptedError,
    TornCommitError,
    UnsupportedLogError,
)
from delta_tpu_torch.models.actions import (
    AddFile,
    CommitInfo,
    DeletionVectorDescriptor,
    DomainMetadata,
    Metadata,
    Protocol,
    RemoveFile,
    SetTransaction,
    decode_path,
)
from delta_tpu_torch.replay.keys import KeySpace
from delta_tpu_torch.utils import filenames

_OBS_DECODE_PARTS = obs.counter("decode.device_parts")
_OBS_DECODE_FALLBACKS = obs.counter("decode.device_fallbacks")
_OBS_COMMIT_READS = obs.counter("log.commit_reads")


@dataclass
class FileActions:
    """Every add/remove row of a segment, in chronological (line) order.
    Lanes live on one device; `rows` materializes actions on the host."""

    is_add: torch.Tensor     # bool [n]
    version: torch.Tensor    # int64 [n]
    order: torch.Tensor      # int32 [n]
    size: torch.Tensor       # int64 [n], 0 where absent
    path_code: torch.Tensor  # int64 [n]
    dv_code: torch.Tensor    # int64 [n], 0 = no deletion vector
    rows: object             # .add_files(idx) / .remove_files(idx)
    keys: object = None      # the codes' replay.keys.KeySpace

    @property
    def num_rows(self) -> int:
        return int(self.is_add.shape[0])


@dataclass
class ParsedCommits:
    """One parse of a commit buffer, by either route. `path_keys` are the
    device route's path byte rows (objects with `path_bytes`, `path_len`,
    `has_percent`), kept to code them together with checkpoint rows."""

    file_actions: FileActions
    others: List[Tuple[int, int, dict]]  # (version, order, control action)
    path_keys: Optional[list] = None
    on_device: bool = False  # parsed by the device route


def _prune_nones(d):
    if isinstance(d, dict):
        return {k: _prune_nones(v) for k, v in d.items() if v is not None}
    if isinstance(d, list):
        return [_prune_nones(v) for v in d]
    return d


@dataclass
class _SmallActionTracker:
    """Latest-seen-wins resolution for O(commits) actions."""

    protocol: tuple = (-1, -1, None)
    metadata: tuple = (-1, -1, None)
    txns: Dict[str, tuple] = field(default_factory=dict)
    domains: Dict[str, tuple] = field(default_factory=dict)
    commit_infos: Dict[int, CommitInfo] = field(default_factory=dict)

    def _on_protocol(self, v, o, row):
        if (v, o) > self.protocol[:2]:
            self.protocol = (v, o, Protocol.from_dict(row))

    def _on_metadata(self, v, o, row):
        if (v, o) > self.metadata[:2]:
            self.metadata = (v, o, Metadata.from_dict(row))

    def _on_txn(self, v, o, row):
        txn = SetTransaction.from_dict(row)
        cur = self.txns.get(txn.appId)
        if cur is None or (v, o) > cur[:2]:
            self.txns[txn.appId] = (v, o, txn)

    def _on_domain(self, v, o, row):
        dm = DomainMetadata.from_dict(row)
        cur = self.domains.get(dm.domain)
        if cur is None or (v, o) > cur[:2]:
            self.domains[dm.domain] = (v, o, dm)

    def _on_commit_info(self, v, o, row):
        self.commit_infos[v] = CommitInfo.from_dict(row)

    def scan_pylist(self, rows: Sequence[Tuple[int, int, dict]]):
        """Consume (version, order, {action-key: body}) control rows."""
        handlers = {
            "protocol": self._on_protocol,
            "metaData": self._on_metadata,
            "txn": self._on_txn,
            "domainMetadata": self._on_domain,
            "commitInfo": self._on_commit_info,
        }
        for v, o, row in rows:
            for key, body in row.items():
                h = handlers.get(key)
                if h is not None and body is not None:
                    h(v, o, _prune_nones(body))


@dataclass
class ColumnarActions:
    """Output of columnarization for one log segment."""

    file_actions: Optional[FileActions]  # None for a small-only read
    protocol: Optional[Protocol] = None
    metadata: Optional[Metadata] = None
    set_transactions: Dict[str, SetTransaction] = field(default_factory=dict)
    domain_metadata: Dict[str, DomainMetadata] = field(default_factory=dict)
    latest_commit_info: Optional[CommitInfo] = None
    commit_infos: Dict[int, CommitInfo] = field(default_factory=dict)
    parsed_on_device: bool = False
    # wall seconds of the load's phases (device work included)
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    pending: object = None  # the checkpoint handoff's ReplayPending


_READ_CHUNK = 1 << 20


def _read_commits_buffer(
    commits: Sequence[Tuple[int, str]],
    max_workers: int = 8,
    first: Sequence[Tuple[int, bytes]] = (),
) -> tuple[bytearray, np.ndarray, np.ndarray]:
    """Parallel-read commit files into ONE buffer, after the files already
    read, `first` ((version, bytes), a V2 checkpoint's JSON top level).

    commits: (version, local path) in version order. Each file is followed
    by a newline (an empty line between files is ignored by both parsers).
    Returns (buffer, per-file byte starts [n + 1], per-file versions).

    Per file: open, read until end of file, close; no stat. Where each
    file-system call is expensive (a sandboxed or network mount) the
    calls, not the bytes, set the time, and a commit (tens of KB) fits one
    read. Each worker takes one contiguous range of files, since a task
    per small file costs more in executor overhead than the read itself."""
    n = len(commits)
    workers = max(1, min(max_workers, os.cpu_count() or 1, n // 64))

    def read_file(path: str) -> bytes:
        _OBS_COMMIT_READS.inc()
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError as e:
            # a listed commit vanished before reading: concurrent cleanup
            raise CorruptLogError(
                f"commit file vanished after listing: {path}",
                error_class="DELTA_COMMIT_FILE_VANISHED") from e
        try:
            parts = []
            while chunk := os.read(fd, _READ_CHUNK):
                parts.append(chunk)
        finally:
            os.close(fd)
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def read_range(k: int) -> List[bytes]:
        return [read_file(commits[i][1])
                for i in range(k * n // workers, (k + 1) * n // workers)]

    if workers == 1:
        blobs = read_range(0)
    else:
        with ThreadPoolExecutor(workers) as pool:
            blobs = [b for part in pool.map(read_range, range(workers))
                     for b in part]
    blobs = [b for _, b in first] + blobs
    n = len(blobs)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(b) + 1 for b in blobs), np.int64, n),
              out=starts[1:])
    buf = bytearray(b"\n").join(blobs + [b""])
    versions = np.array([v for v, _ in first] + [v for v, _ in commits],
                        dtype=np.int64)
    return buf, starts, versions


# ------------------------------------------------ checkpoint half ----

# the add/remove fields the reference's canonical file-action table keeps
_FILE_FIELDS = frozenset({
    "path", "partitionValues", "size", "modificationTime", "dataChange",
    "stats", "tags", "deletionVector", "baseRowId",
    "defaultRowCommitVersion", "clusteringProvider", "deletionTimestamp",
    "extendedFileMetadata"})
_SMALL_ROOTS = ("protocol", "metaData", "txn", "domainMetadata")


def _wanted_leaf(leaf) -> bool:
    """Checkpoint leaves a snapshot load reads."""
    root = leaf.parts[0]
    if root in ("add", "remove"):
        return len(leaf.parts) > 1 and leaf.parts[1] in _FILE_FIELDS
    return root in _SMALL_ROOTS or leaf.parts[:2] == ("sidecar", "path")


def leaf_column(read, path: str, rows: np.ndarray):
    """(values, valid) of a non-repeated leaf at part `rows`, from the
    device decode or the host reader: numpy values, or Strings for a
    BYTE_ARRAY leaf (a dictionary-keyed path's strings gathered from its
    dictionary); None where the part has no such leaf."""
    from delta_tpu_torch.log.parquet_host import Strings

    dc = read.decoded.get(path)
    if dc is not None:
        valid = dc.valid[rows]
        if dc.uniq is not None:
            codes = np.where(valid, dc.values[rows], 0)
            return Strings.from_bytes(dc.uniq or [b""]).take(codes), valid
        return dc.values[rows], valid
    leaf = read.leaves.get(path)
    if leaf is None:
        return None
    vi = leaf.value_index[rows]
    valid = vi >= 0
    if isinstance(leaf.values, Strings):
        if not len(leaf.values):
            return Strings(np.zeros(0, np.uint8), np.zeros(len(rows), np.int64),
                           np.zeros(len(rows), np.int64)), valid
        return leaf.values.take(np.maximum(vi, 0)), valid
    values = np.asarray(leaf.values)
    if not len(values):
        return np.zeros(len(rows), values.dtype), valid
    return values[np.maximum(vi, 0)], valid


def _python(read, path: str, rows: np.ndarray) -> list:
    """Python values (None where null) of a non-repeated leaf at `rows`."""
    dc = read.decoded.get(path)
    if dc is not None:
        valid = dc.valid[rows].tolist()
        vals = dc.values[rows].tolist()
        if dc.uniq is not None:
            return [dc.uniq[v].decode("utf-8") if ok else None
                    for v, ok in zip(vals, valid)]
        return [v if ok else None for v, ok in zip(vals, valid)]
    leaf = read.leaves.get(path)
    return [None] * len(rows) if leaf is None else leaf.row_values(rows)


def _map(read, path: str, rows: np.ndarray) -> list:
    """A map<string,string> leaf pair as dicts (None where null)."""
    keys = read.leaves.get(f"{path}.key_value.key")
    if keys is None:
        return [None] * len(rows)
    vals = read.leaves.get(f"{path}.key_value.value")
    ks = keys.row_lists(rows)
    vs = vals.row_lists(rows) if vals is not None else [
        None if k is None else [None] * len(k) for k in ks]
    return [None if k is None else dict(zip(k, v)) for k, v in zip(ks, vs)]


def _present(read, root: str) -> np.ndarray:
    """Rows of the part where the root struct is non-null."""
    for path, leaf in read.leaves.items():
        if leaf.leaf.parts[0] == root:
            return leaf.present(0)
    return np.zeros(read.n_rows, bool)


def _dvs(read, root: str, rows: np.ndarray):
    """(DeletionVectorDescriptor or None per row, {position: unique id})
    of `root`'s deletion vectors; the unique id is the reference's
    storageType + pathOrInlineDv [+ "@" offset] of every non-null struct."""
    base = f"{root}.deletionVector."
    leaf = next((lf for p, lf in read.leaves.items() if p.startswith(base)),
                None)
    descs: list = [None] * len(rows)
    ids: Dict[int, str] = {}
    if leaf is None:
        return descs, ids
    at = np.flatnonzero(leaf.present(1, rows))
    if not at.size:
        return descs, ids
    sub = rows[at]
    f = {name: _python(read, base + name, sub) for name in (
        "storageType", "pathOrInlineDv", "offset", "sizeInBytes",
        "cardinality", "maxRowIndex")}
    for k, pos in enumerate(at.tolist()):
        st, pth, off = f["storageType"][k], f["pathOrInlineDv"][k], f["offset"][k]
        ids[pos] = (st or "") + (pth or "") + (f"@{off}" if off is not None
                                               else "")
        if st is not None:
            descs[pos] = DeletionVectorDescriptor(
                storageType=st, pathOrInlineDv=pth,
                sizeInBytes=f["sizeInBytes"][k] or 0,
                cardinality=f["cardinality"][k] or 0, offset=off,
                maxRowIndex=f["maxRowIndex"][k])
    return descs, ids


def _check_ascending(idx: np.ndarray, what: str) -> None:
    """The row stores cut `idx` by position: rows out of order would take
    each other's values, so they are refused."""
    if len(idx) > 1 and bool((np.diff(idx) < 0).any()):
        raise ValueError(f"{what}: row indices must be ascending")


@dataclass
class _CkptPart:
    read: object           # log.page_decode.PartRead
    add_rows: np.ndarray   # part rows holding an add, ascending
    rem_rows: np.ndarray
    data: Optional[bytes] = None  # kept while stats_parsed is unread
    _parsed_stats: Optional[np.ndarray] = None

    def stats(self, rows: np.ndarray) -> List[Optional[str]]:
        """The add stats strings at part `rows`: the `stats` leaf, or,
        for a part whose adds carry stats only as `stats_parsed` structs,
        those re-serialized (once, for the whole part)."""
        if self.data is None:
            return _python(self.read, "add.stats", rows)
        if self._parsed_stats is None:
            from delta_tpu_torch.stats.parsed import stats_from_parsed

            out = np.full(self.read.n_rows, None, object)
            out[self.add_rows] = stats_from_parsed(
                self.read.footer, self.data, self.add_rows)
            self._parsed_stats = out
        return self._parsed_stats[rows].tolist()


class CheckpointRows:
    """Host row store of the checkpoint's file actions, in lane order:
    part by part, each part's adds, then its removes. Materialized the way
    the reference's canonical table is (a null dataChange reads False, an
    empty partitionValues map of a remove reads None, an empty tags map
    reads {})."""

    def __init__(self, parts: List[_CkptPart]):
        self.parts = parts
        sizes = [n for p in parts for n in (len(p.add_rows), len(p.rem_rows))]
        self.bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    def blocks(self, idx: np.ndarray):
        """(part, is_add, part rows) per block that `idx` (ascending)
        touches, in order."""
        _check_ascending(idx, "CheckpointRows.blocks")
        blk = np.searchsorted(self.bounds, idx, side="right") - 1
        for k in np.unique(blk).tolist():
            local = idx[blk == k] - self.bounds[k]
            part = self.parts[k // 2]
            yield part, k % 2 == 0, (part.add_rows if k % 2 == 0
                                     else part.rem_rows)[local]

    def paths(self, idx: np.ndarray) -> List[str]:
        out: List[str] = []
        for part, is_add, rows in self.blocks(idx):
            raw = _python(part.read, ("add" if is_add else "remove")
                          + ".path", rows)
            out += [decode_path(p) for p in raw]
        return out

    def stats(self, idx: np.ndarray) -> List[Optional[str]]:
        out: List[Optional[str]] = []
        for part, is_add, rows in self.blocks(idx):
            out += (part.stats(rows) if is_add
                    else _python(part.read, "remove.stats", rows))
        return out

    def refs(self, idx: np.ndarray) -> tuple:
        """(paths, deletion timestamps, DV descriptors) of rows `idx`: the
        three leaves VACUUM reads, without building the actions (an add's
        deletion timestamp is None)."""
        paths: List[str] = []
        stamps: list = []
        dvs: list = []
        for part, is_add, rows in self.blocks(idx):
            root = "add" if is_add else "remove"
            paths += [decode_path(p)
                      for p in _python(part.read, root + ".path", rows)]
            stamps += ([None] * len(rows) if is_add else
                       _python(part.read, "remove.deletionTimestamp", rows))
            dvs += _dvs(part.read, root, rows)[0]
        return paths, stamps, dvs

    def add_files(self, idx: np.ndarray) -> List[AddFile]:
        out: List[AddFile] = []
        for part, is_add, rows in self.blocks(idx):
            out += (self._adds(part, rows) if is_add
                    else self._removes(part.read, rows))
        return out

    remove_files = add_files  # rows decide which action they hold

    @staticmethod
    def _adds(part, rows) -> list:
        read = part.read
        c = {f: _python(read, "add." + f, rows) for f in (
            "path", "size", "modificationTime", "dataChange",
            "baseRowId", "defaultRowCommitVersion", "clusteringProvider")}
        c["stats"] = part.stats(rows)
        pv = _map(read, "add.partitionValues", rows)
        tags = _map(read, "add.tags", rows)
        dvs, _ = _dvs(read, "add", rows)
        return [AddFile(
            path=decode_path(c["path"][j]),
            partitionValues=pv[j] or {},
            size=c["size"][j] or 0,
            modificationTime=c["modificationTime"][j] or 0,
            dataChange=bool(c["dataChange"][j]),
            stats=c["stats"][j],
            tags=tags[j],
            deletionVector=dvs[j],
            baseRowId=c["baseRowId"][j],
            defaultRowCommitVersion=c["defaultRowCommitVersion"][j],
            clusteringProvider=c["clusteringProvider"][j],
        ) for j in range(len(rows))]

    @staticmethod
    def _removes(read, rows) -> list:
        c = {f: _python(read, "remove." + f, rows) for f in (
            "path", "deletionTimestamp", "dataChange",
            "extendedFileMetadata", "size", "stats", "baseRowId",
            "defaultRowCommitVersion")}
        pv = _map(read, "remove.partitionValues", rows)
        tags = _map(read, "remove.tags", rows)
        dvs, _ = _dvs(read, "remove", rows)
        return [RemoveFile(
            path=decode_path(c["path"][j]),
            deletionTimestamp=c["deletionTimestamp"][j],
            dataChange=bool(c["dataChange"][j]),
            extendedFileMetadata=c["extendedFileMetadata"][j],
            partitionValues=pv[j] or None,
            size=c["size"][j],
            stats=c["stats"][j],
            tags=tags[j],
            deletionVector=dvs[j],
            baseRowId=c["baseRowId"][j],
            defaultRowCommitVersion=c["defaultRowCommitVersion"][j],
        ) for j in range(len(rows))]


class _PathRows:
    """Zero-padded path byte rows of some file actions, on a device."""

    def __init__(self, mat: np.ndarray, lens: np.ndarray, device):
        self.path_bytes = torch.from_numpy(mat).to(device)
        self.path_len = torch.from_numpy(lens.astype(np.int64)).to(device)
        self.has_percent = bool((mat == 37).any())


def _path_rows(read, root: str, rows: np.ndarray, device) -> _PathRows:
    """The raw path bytes of `root`'s rows: gathered from the part's
    dictionary where the device decoded the path as a key, else from the
    host reader's strings."""
    from delta_tpu_torch.log.parquet_host import Strings

    path = root + ".path"
    dc = read.decoded.get(path)
    if dc is not None:
        valid, codes = dc.valid[rows], dc.values[rows]
        uniq = Strings.from_bytes(dc.uniq)
        strings = uniq.take(np.where(valid, codes, 0))
    else:
        leaf = read.leaves.get(path)
        if leaf is None:
            valid = np.zeros(len(rows), bool)
            strings = None
        else:
            vi = leaf.value_index[rows]
            valid = vi >= 0
            strings = leaf.values.take(np.maximum(vi, 0)) if valid.all() \
                else None
    if not valid.all():
        raise LogCorruptedError(f"a checkpoint {root} action has no path")
    mat, lens = strings.matrix()
    return _PathRows(mat, lens, device)


@dataclass
class CheckpointActions:
    """The checkpoint's file-action lanes (host numpy), row store, path
    rows, deletion-vector ids, control rows and handoff."""

    is_add: np.ndarray
    size: np.ndarray
    rows: CheckpointRows
    path_rows: List[_PathRows]
    dv_ids: Dict[int, str]
    others: List[Tuple[int, int, dict]]
    handoff: Optional[tuple] = None  # (ReplayPending, codes, paths)

    @property
    def n(self) -> int:
        return int(self.is_add.shape[0])


def _read_part_bytes(path: str, version: int) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError as e:
        raise LogCorruptedError(
            f"couldn't find all part files of the checkpoint at version "
            f"{version}: {path} is missing",
            error_class="DELTA_MISSING_PART_FILES") from e


def _small_actions(segment, parts) -> List[Tuple[int, int, dict]]:
    """The protocol, metaData, txn and domainMetadata rows of the
    segment's checkpoint `parts` (Parquet; a V2 top level, whose sidecars
    hold file actions only, is read alone), by the host leaf reader from
    those columns alone: no add or remove leaf is read and nothing is
    decoded on the device (the reference's `small_only` projection)."""
    from delta_tpu_torch.log.page_decode import PartRead
    from delta_tpu_torch.log.parquet_footer import (
        DecodeCorrupt,
        DecodeUnsupported,
        read_footer,
    )
    from delta_tpu_torch.log.parquet_host import assemble, read_leaves

    cp = segment.checkpoint_version
    others: List[Tuple[int, int, dict]] = []
    for fstat in parts:
        data = _read_part_bytes(fstat.path, cp)
        try:
            footer = read_footer(data)
            read = PartRead(footer.num_rows, footer, read_leaves(
                footer, data, [leaf.path for leaf in footer.leaves
                               if leaf.parts[0] in _SMALL_ROOTS]),
                {}, None, False)
            for root in _SMALL_ROOTS:
                at = np.flatnonzero(_present(read, root))
                if at.size:
                    others += [(cp, int(r), {root: b}) for r, b in zip(
                        at.tolist(), assemble(read.leaves, root, at))]
        except DecodeUnsupported as e:
            raise UnsupportedLogError(
                f"checkpoint part {fstat.path}: {e}",
                error_class="DELTA_UNSUPPORTED_CHECKPOINT") from e
        except DecodeCorrupt as e:
            raise LogCorruptedError(
                f"checkpoint part {fstat.path} is damaged: {e}",
                version=cp, path=fstat.path) from e
    return others


def _sidecar_path(log_path: str, name: str) -> str:
    """Where a sidecar pointer leads: `_sidecars/<name>`, or the name
    itself when it holds a '/' (the reference's resolution)."""
    return name if "/" in name else f"{filenames.sidecar_dir(log_path)}/{name}"


def _has_file_columns(footer) -> bool:
    return any(lf.parts[0] in ("add", "remove") for lf in footer.leaves)


def _stats_only_parsed(read) -> bool:
    """The part's adds carry stats only as `stats_parsed` structs (the
    `stats` strings are all null, as with writeStatsAsJson=false)."""
    if not any(lf.parts[:2] == ("add", "stats_parsed")
               for lf in read.footer.leaves):
        return False
    stats = _python(read, "add.stats", np.flatnonzero(_present(read, "add")))
    return bool(stats) and all(s is None for s in stats)


def _read_checkpoint(engine, segment, parts: Sequence, sidecars: Sequence[str],
                     phases: Dict[str, float], want_handoff: bool
                     ) -> CheckpointActions:
    """Read the checkpoint's Parquet `parts` and the sidecars they name,
    and the `sidecars` a JSON top level named (port of the reference's
    `_consume_parts_device`, `_consume_checkpoint_table` and
    `_track_handoff`). The handoff, when wanted, stays on while every
    part and sidecar is keyed on the device with counts that agree with
    the host's rows and no deletion vector."""
    from delta_tpu_torch.log.page_decode import read_checkpoint_part
    from delta_tpu_torch.log.parquet_footer import (
        DecodeCorrupt,
        DecodeUnsupported,
    )
    from delta_tpu_torch.log.parquet_host import assemble
    from delta_tpu_torch.ops.page_decode import launch_checkpoint_handoff

    cp = segment.checkpoint_version
    handoff_ok = want_handoff
    keyed = []
    read_parts: List[_CkptPart] = []
    others: List[Tuple[int, int, dict]] = []
    dv_ids: Dict[int, str] = {}
    is_add, size = [], []
    n = 0

    def consume(path: str) -> None:
        nonlocal n, handoff_ok
        t0 = time.perf_counter()
        data = _read_part_bytes(path, cp)
        phases["ckpt_read"] = phases.get("ckpt_read", 0.0) + (
            time.perf_counter() - t0)
        try:
            read = read_checkpoint_part(data, engine.device, _wanted_leaf,
                                        want_keys=want_handoff,
                                        phases=phases)
            t1 = time.perf_counter()
            struct_stats = _stats_only_parsed(read)
            for root in _SMALL_ROOTS:
                at = np.flatnonzero(_present(read, root))
                if at.size:
                    bodies = assemble(read.leaves, root, at)
                    others.extend((cp, int(r), {root: b})
                                  for r, b in zip(at.tolist(), bodies))
            at = np.flatnonzero(_present(read, "sidecar"))
            names = _python(read, "sidecar.path", at) if at.size else []
        except DecodeUnsupported as e:
            raise UnsupportedLogError(
                f"checkpoint part {path}: {e}",
                error_class="DELTA_UNSUPPORTED_CHECKPOINT") from e
        except DecodeCorrupt as e:
            raise LogCorruptedError(
                f"checkpoint part {path} is damaged: {e}",
                version=cp, path=path) from e
        if _has_file_columns(read.footer):
            (_OBS_DECODE_PARTS if read.on_device
             else _OBS_DECODE_FALLBACKS).inc()
        part = _CkptPart(read, np.flatnonzero(_present(read, "add")),
                         np.flatnonzero(_present(read, "remove")),
                         data if struct_stats else None)
        read_parts.append(part)
        for root, rows in (("add", part.add_rows), ("remove", part.rem_rows)):
            _, ids = _dvs(read, root, rows)
            dv_ids.update({n + k: v for k, v in ids.items()})
            is_add.append(np.full(len(rows), root == "add"))
            col = leaf_column(read, root + ".size", rows)
            size.append(np.zeros(len(rows), np.int64) if col is None
                        else np.where(col[1], col[0], 0).astype(np.int64))
            n += len(rows)
        if handoff_ok:
            keys, n_add, n_rem = read.keys, len(part.add_rows), len(part.rem_rows)
            if keys is None:
                # a keyless part breaks the row alignment unless it holds
                # no file actions
                handoff_ok = not (n_add or n_rem)
            elif (keys.n_bad or keys.n_add != n_add or keys.n_rem != n_rem
                  or any(r >= n - n_add - n_rem for r in dv_ids)):
                handoff_ok = False
            else:
                keyed.append(keys)
        phases["ckpt_rows"] = phases.get("ckpt_rows", 0.0) + (
            time.perf_counter() - t1)
        for name in names:
            if name is not None:
                consume(_sidecar_path(segment.log_path, name))

    for fstat in parts:
        consume(fstat.path)
    for name in sidecars:
        consume(_sidecar_path(segment.log_path, name))
    t2 = time.perf_counter()
    rows = CheckpointRows(read_parts)
    handoff = None
    if handoff_ok and keyed:
        handoff = launch_checkpoint_handoff(keyed, engine.device)
    path_rows = []
    if handoff is None:
        for part in read_parts:
            for root, r in (("add", part.add_rows), ("remove", part.rem_rows)):
                if len(r):
                    path_rows.append(_path_rows(part.read, root, r,
                                                engine.device))
    phases["ckpt_rows"] = phases.get("ckpt_rows", 0.0) + (
        time.perf_counter() - t2)
    return CheckpointActions(
        is_add=np.concatenate(is_add) if is_add else np.zeros(0, bool),
        size=np.concatenate(size) if size else np.zeros(0, np.int64),
        rows=rows, path_rows=path_rows, dv_ids=dv_ids, others=others,
        handoff=handoff)


class CompositeRows:
    """Row store over several stores' rows, one after another: a
    checkpoint's rows, then its tail commits', then (after
    `Snapshot.update()`) each advance's commits'."""

    def __init__(self, first, n_first: int, second):
        self.stores = [first, second]
        self.starts = np.array([0, n_first], np.int64)

    @staticmethod
    def chain(prev, n_prev: int, store) -> "CompositeRows":
        """`prev`'s `n_prev` rows, then `store`'s; a composite `prev` is
        extended flat rather than nested."""
        if not isinstance(prev, CompositeRows):
            return CompositeRows(prev, n_prev, store)
        out = CompositeRows(None, 0, None)
        out.stores = prev.stores + [store]
        out.starts = np.append(prev.starts, n_prev)
        return out

    def pieces(self, idx: np.ndarray):
        """(store, its local rows) for each store, `idx` ascending."""
        _check_ascending(idx, "CompositeRows.pieces")
        cuts = np.searchsorted(idx, self.starts[1:])
        bounds = np.concatenate([[0], cuts, [len(idx)]])
        return [(st, idx[lo:hi] - base) for st, base, lo, hi in zip(
            self.stores, self.starts, bounds[:-1], bounds[1:])]

    def split(self, idx: np.ndarray):
        """`idx` (ascending) cut into first-store and second-store rows (a
        composite of two stores)."""
        (_, a), (_, b) = self.pieces(idx)
        return a, b

    def _each(self, idx: np.ndarray, method: str) -> list:
        out: list = []
        for st, local in self.pieces(idx):
            if len(local):
                out += getattr(st, method)(local)
        return out

    def paths(self, idx: np.ndarray) -> List[str]:
        return self._each(idx, "paths")

    def stats(self, idx: np.ndarray) -> List[Optional[str]]:
        return self._each(idx, "stats")

    def refs(self, idx: np.ndarray) -> tuple:
        out: tuple = ([], [], [])
        for st, local in self.pieces(idx):
            if len(local):
                for acc, got in zip(out, st.refs(local)):
                    acc += got
        return out

    def add_files(self, idx: np.ndarray) -> List[AddFile]:
        return self._each(idx, "add_files")

    def remove_files(self, idx: np.ndarray) -> List[RemoveFile]:
        return self._each(idx, "remove_files")


def _dv_codes(ck: CheckpointActions, commit_fa: Optional[FileActions],
              device):
    """Exact codes (0 = none) of the deletion-vector ids of checkpoint and
    commit rows together, and the table {id: code} (None is 0)."""
    table: Dict[Optional[str], int] = {None: 0}
    ck_codes = np.zeros(ck.n, np.int64)
    for r, dv in ck.dv_ids.items():
        ck_codes[r] = table.setdefault(dv, len(table))
    lanes = [torch.from_numpy(ck_codes).to(device)]
    if commit_fa is not None:
        local = commit_fa.dv_code.cpu().numpy()
        if local.any():
            # the host parser's local codes -> ids -> the shared table
            uniq, first = np.unique(local, return_index=True)
            ids = commit_fa.rows.dv_ids(first)
            remap = np.zeros(int(uniq.max()) + 1, np.int64)
            for u, dv in zip(uniq.tolist(), ids):
                remap[u] = table.setdefault(dv, len(table))
            local = remap[local]
        lanes.append(torch.from_numpy(local).to(device))
    return torch.cat(lanes), table


def _parse_commit_buffer(engine, buf, starts: np.ndarray,
                        versions: np.ndarray) -> ParsedCommits:
    """Parse one commit buffer: the device parse first, the host parser
    when the device parse hands the buffer back."""
    from delta_tpu_torch.replay import device_parse, host_parse

    parsed = device_parse.parse_commits_device(
        buf, starts, versions, engine.device, engine.parse_window_bytes)
    if parsed is None:
        return host_parse.parse_commits_host(buf, starts, versions,
                                             engine.device)
    parsed.on_device = True
    return parsed


def _small_columnar(tracker: "_SmallActionTracker", fa: FileActions,
                    **kw) -> ColumnarActions:
    latest_ci = None
    if tracker.commit_infos:
        latest_ci = tracker.commit_infos[max(tracker.commit_infos)]
    return ColumnarActions(
        file_actions=fa,
        protocol=tracker.protocol[2],
        metadata=tracker.metadata[2],
        set_transactions={k: t[2] for k, t in tracker.txns.items()},
        domain_metadata={k: t[2] for k, t in tracker.domains.items()},
        latest_commit_info=latest_ci,
        commit_infos=tracker.commit_infos,
        **kw)


def columnarize_commit_blobs(engine, blobs: Sequence[Tuple[int, bytes]]
                             ) -> ColumnarActions:
    """Commits already in memory, `[(version, bytes)]` ascending, through
    the same parse as commits read from disk (the device parse, kernel
    K1, first): the post-commit handoff, where a transaction hands over
    the bytes it just wrote, so that its commit is never listed or read
    back."""
    n = len(blobs)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(b) + 1 for _, b in blobs), np.int64, n),
              out=starts[1:])
    buf = bytearray(b"\n").join([b for _, b in blobs] + [b""])
    versions = np.array([v for v, _ in blobs], dtype=np.int64)
    parsed = _parse_commit_buffer(engine, buf, starts, versions)
    tracker = _SmallActionTracker()
    tracker.scan_pylist(parsed.others)
    return _small_columnar(tracker, parsed.file_actions,
                           parsed_on_device=parsed.on_device)


def _json_files(segment) -> Tuple[list, List[Tuple[int, str]]]:
    """The segment's JSON inputs in buffer order: the V2 JSON top levels
    as `(version, bytes)` (read here, so that a vanished one reads as a
    missing part), then `(version, path)` of the compacted deltas (at
    their last version, ahead of the singles, as in the reference) and
    the single commits."""
    cp = segment.checkpoint_version
    tops = [(cp, _read_part_bytes(f.path, cp)) for f in segment.checkpoints
            if f.path.endswith(".json")]
    files = [(filenames.compacted_delta_versions(f.path)[1], f.path)
             for f in segment.compacted_deltas]
    files += [(filenames.delta_version(f.path), f.path)
              for f in segment.deltas]
    return tops, files


def columnarize_log_segment(engine, segment, small_only: bool = False
                            ) -> ColumnarActions:
    """Read the segment's checkpoint parts and JSON files and produce its
    ColumnarActions. JSON takes the device parse first, the host parser
    when the device parse hands the buffer back (`parse.device_fallbacks`
    counts those). Returns, besides, the handoff's launched replay
    (`ColumnarActions.pending`) when one ran.

    `small_only` resolves only the small actions: the checkpoint's
    protocol, metaData, txn and domainMetadata columns alone (no add or
    remove leaf, no sidecar, no device decode) and the JSON files'
    control lines; its `file_actions` is None."""
    from delta_tpu_torch.replay import device_parse, host_parse

    phases: Dict[str, float] = {}
    parquet = [f for f in segment.checkpoints if not f.path.endswith(".json")]
    tops, files = _json_files(segment)
    if small_only:
        tracker = _SmallActionTracker()
        rows = _small_actions(segment, parquet) if parquet else []
        if tops or files:
            buf, starts, versions = _read_commits_buffer(files, first=tops)
            rows += host_parse.parse_commits_host(buf, starts, versions,
                                                  "cpu").others
        tracker.scan_pylist(rows)
        return _small_columnar(tracker, None)

    def parse_json():
        t0 = time.perf_counter()
        buf, starts, versions = _read_commits_buffer(files, first=tops)
        t1 = time.perf_counter()
        try:
            out = _parse_commit_buffer(engine, buf, starts, versions)
        except TornCommitError as e:
            if files:
                raise
            # the buffer holds only the checkpoint's top level: a torn
            # line there is a damaged checkpoint, not a torn commit
            raise LogCorruptedError(
                f"the V2 checkpoint at version {segment.checkpoint_version} "
                f"is damaged: {e}", version=segment.checkpoint_version) from e
        engine.synchronize()
        phases["read"] = t1 - t0
        phases["parse"] = time.perf_counter() - t1
        return out

    # a JSON top level names the sidecars: parse the JSON side first then
    parsed = parse_json() if tops else None
    ck = None
    if segment.checkpoints:
        cp = segment.checkpoint_version
        sidecars = [] if parsed is None else [
            row["sidecar"].get("path") for v, _, row in parsed.others
            if v == cp and isinstance(row.get("sidecar"), dict)]
        want_handoff = not files and (
            parsed is None or parsed.file_actions.num_rows == 0)
        ck = _read_checkpoint(engine, segment, parquet,
                              [p for p in sidecars if p is not None],
                              phases, want_handoff)
        engine.synchronize()
    if parsed is None and files:
        parsed = parse_json()

    t2 = time.perf_counter()
    pending = None
    dev = engine.device
    commit_fa = parsed.file_actions if parsed is not None else None
    if ck is None:
        fa = commit_fa
    else:
        if commit_fa is not None and commit_fa.num_rows == 0:
            commit_fa = None  # a top level of small actions and sidecars
        n_ck = ck.n
        lanes = dict(
            is_add=torch.from_numpy(ck.is_add).to(dev),
            version=torch.full((n_ck,), segment.checkpoint_version,
                               dtype=torch.int64, device=dev),
            order=torch.arange(n_ck, dtype=torch.int32, device=dev),
            size=torch.from_numpy(ck.size).to(dev))
        if commit_fa is not None:
            lanes = {k: torch.cat([v, getattr(commit_fa, k)])
                     for k, v in lanes.items()}
        store = (ck.rows if commit_fa is None
                 else CompositeRows(ck.rows, n_ck, commit_fa.rows))
        dv_code, dv_ids = _dv_codes(ck, commit_fa, dev)
        if ck.handoff is not None:
            pending, path_code, names = ck.handoff
            keys = KeySpace.of_strings(names, dev, dv_ids)
        else:
            windows = list(ck.path_rows)
            if commit_fa is not None:
                windows += (parsed.path_keys if parsed.path_keys is not None
                            else [commit_fa.rows.path_rows(dev)])
            path_code, keys = device_parse.path_codes(windows, store.paths,
                                                      dev)
            keys.dv_ids = dv_ids
        fa = FileActions(path_code=path_code, dv_code=dv_code, rows=store,
                         keys=keys, **lanes)
        engine.synchronize()
        phases["codes"] = time.perf_counter() - t2

    tracker = _SmallActionTracker()
    tracker.scan_pylist((ck.others if ck is not None else [])
                        + (parsed.others if parsed is not None else []))
    return _small_columnar(
        tracker, fa,
        parsed_on_device=parsed is not None and parsed.on_device,
        phase_seconds=phases, pending=pending)

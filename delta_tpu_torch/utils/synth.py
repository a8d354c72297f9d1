"""Synthetic `_delta_log` shaped like the repo's headline benchmark, and
synthetic checkpoints.

`synth_delta_log` is a copy of `bench.py::synth_delta_log` (same seed,
same bytes) that also returns the generator's own truth, so a load can be
checked without a second reader: the live paths, their total size and the
tombstone count. Given `checkpoint_version` it also writes a checkpoint
of the state at that version, split into parts the way `bench.py`'s
checkpoint metric splits them (`part_size = num_files // 8`).

`write_checkpoint` writes a checkpoint in the SingleAction layout of the
JAX package's checkpointer (`delta_tpu/log/checkpointer.py`): part 1 of a
multi-part checkpoint holds the small actions only, the other parts fixed
`part_size`-row chunks of [adds; removes]; every add and remove carries
dataChange=false; tombstones older than the retention window
(`delta.deletedFileRetentionDuration`, 7 days by default) are dropped;
then `_last_checkpoint`. The bytes go through `utils/parquet_write.py`.
It serves `chip_smoke.py` and the tests; writing checkpoints is not yet
a feature of the package.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch.log.parquet_host import Strings, ragged_arange
from delta_tpu_torch.utils import filenames
from delta_tpu_torch.utils.parquet_write import (
    LeafColumn,
    SchemaNode,
    write_parquet,
)

ADD_SIZE = 1048576
RETENTION_MS = 7 * 24 * 3600 * 1000  # delta.deletedFileRetentionDuration


def _grp(name, *kids, converted=None):
    return SchemaNode(name, 1, tuple(kids), converted=converted)


def _leaf(name, physical, repetition=1):
    return SchemaNode(name, repetition, physical=physical,
                      converted=0 if physical == "BYTE_ARRAY" else None)


def _str(name):
    return _leaf(name, "BYTE_ARRAY")


def _map(name):
    return _grp(name, SchemaNode("key_value", 2, (
        _leaf("key", "BYTE_ARRAY", 0), _str("value"))), converted=1)


def _list(name):
    return _grp(name, SchemaNode("list", 2, (_str("element"),)), converted=3)


_DV = _grp("deletionVector", _str("storageType"), _str("pathOrInlineDv"),
           _leaf("offset", "INT32"), _leaf("sizeInBytes", "INT32"),
           _leaf("cardinality", "INT64"), _leaf("maxRowIndex", "INT64"))

# the JAX checkpointer's SingleAction schema, column for column
CHECKPOINT_SCHEMA = SchemaNode("schema", 0, (
    _grp("protocol", _leaf("minReaderVersion", "INT32"),
         _leaf("minWriterVersion", "INT32"), _list("readerFeatures"),
         _list("writerFeatures")),
    _grp("metaData", _str("id"), _str("name"), _str("description"),
         _grp("format", _str("provider"), _map("options")),
         _str("schemaString"), _list("partitionColumns"),
         _map("configuration"), _leaf("createdTime", "INT64")),
    _grp("txn", _str("appId"), _leaf("version", "INT64"),
         _leaf("lastUpdated", "INT64")),
    _grp("domainMetadata", _str("domain"), _str("configuration"),
         _leaf("removed", "BOOLEAN")),
    _grp("add", _str("path"), _map("partitionValues"),
         _leaf("size", "INT64"), _leaf("modificationTime", "INT64"),
         _leaf("dataChange", "BOOLEAN"), _str("stats"), _DV,
         _leaf("baseRowId", "INT64"),
         _leaf("defaultRowCommitVersion", "INT64"),
         _str("clusteringProvider")),
    _grp("remove", _str("path"), _leaf("deletionTimestamp", "INT64"),
         _leaf("dataChange", "BOOLEAN"),
         _leaf("extendedFileMetadata", "BOOLEAN"), _map("partitionValues"),
         _leaf("size", "INT64"), _DV, _leaf("baseRowId", "INT64"),
         _leaf("defaultRowCommitVersion", "INT64")),
))
_ROOTS = {node.name: node for node in CHECKPOINT_SCHEMA.children}


@dataclass
class Repeated:
    """A map<string,string> or list<string> column: per-row validity and
    offsets into `items` (map values / list elements), `keys` for a map."""

    valid: np.ndarray
    offsets: np.ndarray
    items: Strings
    item_valid: np.ndarray
    keys: Optional[Strings] = None

    def take(self, idx: np.ndarray) -> "Repeated":
        counts = np.diff(self.offsets)[idx]
        ent = np.repeat(self.offsets[:-1][idx], counts) + ragged_arange(counts)
        return Repeated(self.valid[idx],
                        np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                        self.items.take(ent), self.item_valid[ent],
                        None if self.keys is None else self.keys.take(ent))


@dataclass
class Block:
    """`n` rows of one root struct, by column: a leaf's relative path ->
    (values, valid) with values a numpy array or Strings of n entries; a
    nested struct's path -> its validity mask; a map or list -> Repeated.
    Absent columns are null."""

    root: str
    n: int
    cols: Dict[tuple, object] = field(default_factory=dict)

    def take(self, idx: np.ndarray) -> "Block":
        out = {}
        for k, c in self.cols.items():
            if isinstance(c, Repeated):
                out[k] = c.take(idx)
            elif isinstance(c, tuple):
                v, ok = c
                out[k] = (v.take(idx) if isinstance(v, Strings) else v[idx],
                          ok[idx])
            else:
                out[k] = c[idx]
        return Block(self.root, int(idx.shape[0]), out)


def _strings(values: Sequence[Optional[str]]):
    return (Strings.from_list([v if v is not None else "" for v in values]),
            np.array([v is not None for v in values], bool))


def rows_block(root: str, rows: Sequence[dict]) -> Block:
    """A Block from Python dicts (one per row; maps as dicts, lists as
    lists, None or absent for null). Loops over rows: for the small
    actions and for tests."""
    n = len(rows)

    def walk(node, prefix, dicts, cols):
        for child in node.children:
            path = prefix + (child.name,)
            vals = [None if d is None else d.get(child.name) for d in dicts]
            if child.converted in (1, 3):
                valid = np.array([v is not None for v in vals], bool)
                seqs = [(list(v.items()) if child.converted == 1 else list(v))
                        if v is not None else [] for v in vals]
                counts = np.array([len(q) for q in seqs], np.int64)
                flat = [e for q in seqs for e in q]
                if child.converted == 1:
                    keys = Strings.from_list([k for k, _ in flat])
                    items, ok = _strings([v for _, v in flat])
                else:
                    keys = None
                    items, ok = _strings(flat)
                cols[path] = Repeated(valid, np.concatenate(
                    [[0], np.cumsum(counts)]).astype(np.int64), items, ok, keys)
            elif child.children:
                cols[path] = np.array([v is not None for v in vals], bool)
                walk(child, path, vals, cols)
            elif child.physical == "BYTE_ARRAY":
                cols[path] = _strings(vals)
            else:
                dt = bool if child.physical == "BOOLEAN" else np.int64
                cols[path] = (np.array([v if v is not None else 0
                                        for v in vals], dt),
                              np.array([v is not None for v in vals], bool))

    cols: Dict[tuple, object] = {}
    walk(_ROOTS[root], (), list(rows), cols)
    return Block(root, n, cols)


def _block_leaves(node: SchemaNode, block: Block):
    """(path, physical, defs, reps, values, max_def, max_rep) of every
    leaf under `node` for the block's rows (root present in each)."""
    out = []

    def walk(nd, prefix, lvl, alive, max_def):
        for child in nd.children:
            path = prefix + (child.name,)
            if child.converted in (1, 3):
                out.extend(_repeated_leaves(child, path, block, lvl, alive,
                                            max_def))
            elif child.children:
                sv = block.cols.get(path)  # an absent struct is null
                a = alive & (sv if sv is not None
                             else np.zeros(block.n, bool))
                walk(child, path, lvl + a, a, max_def + 1)
            else:
                c = block.cols.get(path)
                if c is None:
                    vals = (Strings(np.zeros(0, np.uint8),
                                    np.zeros(block.n, np.int64),
                                    np.zeros(block.n, np.int64))
                            if child.physical == "BYTE_ARRAY"
                            else np.zeros(block.n, np.int64))
                    ok = np.zeros(block.n, bool)
                else:
                    vals, ok = c
                a = alive & ok
                idx = np.flatnonzero(a)
                v = (vals.take(idx) if isinstance(vals, Strings)
                     else np.asarray(vals)[idx])
                out.append((path, child.physical, (lvl + a).astype(np.int32),
                            None, v, max_def + 1, 0))

    walk(node, (), np.ones(block.n, np.int32), np.ones(block.n, bool), 1)
    return out


def _repeated_leaves(node, path, block, lvl, alive, max_def):
    """The key/value (map) or element (list) leaves of one repeated
    container with one repetition level."""
    rc = block.cols.get(path)
    n = block.n
    if rc is None:
        rc = Repeated(np.zeros(n, bool), np.zeros(n + 1, np.int64),
                      Strings.from_list([]), np.zeros(0, bool),
                      Strings.from_list([]))
    alive_c = alive & rc.valid
    lvl_c = lvl + alive_c
    counts = np.where(alive_c, np.diff(rc.offsets), 0)
    has = counts > 0
    m = np.where(has, counts, 1)
    first = np.cumsum(m) - m
    row = np.repeat(np.arange(n), m)
    within = np.arange(int(m.sum())) - first[row]
    is_entry = has[row]
    entry = (rc.offsets[:-1][row] + within)[is_entry]
    reps = np.ones(row.shape[0], np.int32)
    reps[first] = 0
    base = lvl_c[row]
    kv = node.children[0]
    out = []
    if node.converted == 1:
        out.append((path + (kv.name, "key"), "BYTE_ARRAY",
                    (base + is_entry).astype(np.int32), reps,
                    rc.keys.take(entry), max_def + 2, 1))
    ok = np.zeros(row.shape[0], bool)
    ok[is_entry] = rc.item_valid[entry]
    leafname = "value" if node.converted == 1 else "element"
    out.append((path + (kv.name, leafname), "BYTE_ARRAY",
                (base + is_entry + ok).astype(np.int32), reps,
                rc.items.take(entry[rc.item_valid[entry]]), max_def + 3, 1))
    return out


def encode_part(blocks: Sequence[Block]) -> bytes:
    """One checkpoint Parquet file holding `blocks` (row ranges, in
    order; each row has exactly one non-null root)."""
    n_rows = sum(b.n for b in blocks)
    columns = []
    for root in CHECKPOINT_SCHEMA.children:
        per_block = []
        for b in blocks:
            if b.root == root.name:
                per_block.append(_block_leaves(root, b))
            else:
                per_block.append(None)
        template = _block_leaves(root, Block(root.name, 0))
        for k, (path, phys, _, _, _, max_def, max_rep) in enumerate(template):
            defs, reps, vals = [], [], []
            for b, leaves in zip(blocks, per_block):
                if leaves is None:
                    defs.append(np.zeros(b.n, np.int32))
                    reps.append(np.zeros(b.n, np.int32))
                    continue
                _, _, d, r, v, _, _ = leaves[k]
                defs.append(d)
                reps.append(r if r is not None else np.zeros(b.n, np.int32))
                vals.append(v)
            if phys == "BYTE_ARRAY":
                values = (Strings.concat(vals) if vals
                          else Strings.from_list([]))
            else:
                values = (np.concatenate(vals) if vals
                          else np.zeros(0, np.int64))
            columns.append(LeafColumn(
                (root.name,) + path, phys,
                np.concatenate(defs) if defs else np.zeros(0, np.int32),
                (np.concatenate(reps) if reps else np.zeros(0, np.int32))
                if max_rep else None, max_def, max_rep, values))
    return write_parquet(CHECKPOINT_SCHEMA, columns, n_rows)


def _chunk_plan(n_add: int, n_rem: int, part_size: int) -> List[tuple]:
    """Fixed `part_size`-row chunks over [adds; removes] ->
    [(a0, a1, r0, r1)] per part (the JAX checkpointer's `_chunk_plan`)."""
    total = n_add + n_rem
    out = []
    lo = 0
    while lo < total:
        hi = min(lo + part_size, total)
        out.append((min(lo, n_add), min(hi, n_add),
                    max(lo, n_add) - n_add, max(hi, n_add) - n_add))
        lo = hi
    return out or [(0, 0, 0, 0)]


def write_checkpoint(log_path: str, version: int, small: Sequence[Block],
                     adds: Block, removes: Block,
                     part_size: Optional[int] = None,
                     now_ms: Optional[int] = None) -> dict:
    """Write the checkpoint of the state at `version`: `small` holds the
    protocol, metaData, txn and domainMetadata blocks, `adds` the live
    files, `removes` every tombstone (those older than `now_ms -
    RETENTION_MS` are dropped). dataChange is written false. A multi-part
    checkpoint when `part_size` is given and the file actions exceed it.
    Returns the `_last_checkpoint` record it wrote."""
    now_ms = int(time.time() * 1000) if now_ms is None else now_ms
    ts, ok = removes.cols.get(("deletionTimestamp",),
                              (np.zeros(removes.n, np.int64),
                               np.zeros(removes.n, bool)))
    removes = removes.take(np.flatnonzero(np.where(ok, ts, 0)
                                          >= now_ms - RETENTION_MS))
    adds = adds.take(np.arange(adds.n))
    for b in (adds, removes):
        b.cols[("dataChange",)] = (np.zeros(b.n, bool), np.ones(b.n, bool))
    n_small = sum(b.n for b in small)
    n_files = adds.n + removes.n
    if part_size is not None and n_files > part_size:
        plan = _chunk_plan(adds.n, removes.n, part_size)
        contents = [list(small)] + [
            [adds.take(np.arange(a0, a1)), removes.take(np.arange(r0, r1))]
            for a0, a1, r0, r1 in plan]
        paths = filenames.checkpoint_file_with_parts(log_path, version,
                                                     len(contents))
    else:
        contents = [list(small) + [adds, removes]]
        paths = [filenames.checkpoint_file_singular(log_path, version)]
    size_bytes = 0
    for path, blocks in zip(paths, contents):
        data = encode_part(blocks)
        with open(path, "wb") as f:
            f.write(data)
        size_bytes += len(data)
    info = {"version": version, "size": n_small + n_files,
            "sizeInBytes": size_bytes, "numOfAddFiles": adds.n}
    if len(paths) > 1:
        info["parts"] = len(paths)
    with open(filenames.last_checkpoint_file(log_path), "w") as f:
        f.write(json.dumps(info))
    return info


@dataclass
class SynthTruth:
    version: int
    live_paths: List[str]  # sorted
    size_in_bytes: int
    num_tombstones: int
    num_actions: int
    checkpoint: Optional[dict] = None  # the _last_checkpoint record


PROTOCOL = {"minReaderVersion": 1, "minWriterVersion": 2}
METADATA = {
    "id": "bench", "format": {"provider": "parquet", "options": {}},
    "schemaString": '{"type":"struct","fields":[{"name":"x","type":"long",'
                    '"nullable":true,"metadata":{}}]}',
    "partitionColumns": [], "configuration": {}}


def _stats(fid: np.ndarray) -> List[str]:
    lo, hi = (fid + 1) * 1000, (fid + 2) * 1000
    return [f'{{"numRecords":1000,"minValues":{{"x":{a}}},'
            f'"maxValues":{{"x":{b}}},"nullCount":{{"x":0}}}}'
            for a, b in zip(lo.tolist(), hi.tolist())]


def _synth_checkpoint(log: str, version: int, paths: List[str],
                      alive: List[int], add_version: List[int],
                      removed: List[tuple], now_ms: Optional[int]) -> dict:
    """The checkpoint of the generator's state after commit `version`:
    live adds in the order they were added, tombstones in the order they
    were removed."""
    fid = np.sort(np.asarray(alive, np.int64))
    n = fid.shape[0]
    ones = np.ones(n, bool)
    adds = Block("add", n, {
        ("path",): (Strings.from_list([paths[f] for f in fid.tolist()]),
                    ones),
        ("partitionValues",): Repeated(ones, np.zeros(n + 1, np.int64),
                                       Strings.from_list([]),
                                       np.zeros(0, bool),
                                       Strings.from_list([])),
        ("size",): (np.full(n, ADD_SIZE, np.int64), ones),
        ("modificationTime",): (np.asarray(add_version, np.int64)[fid], ones),
        ("stats",): (Strings.from_list(_stats(fid)), ones),
    })
    rfid = np.asarray([f for f, _ in removed], np.int64)
    r_ones = np.ones(rfid.shape[0], bool)
    removes = Block("remove", rfid.shape[0], {
        ("path",): (Strings.from_list([paths[f] for f in rfid.tolist()]),
                    r_ones),
        ("deletionTimestamp",): (np.asarray([v for _, v in removed],
                                            np.int64), r_ones),
    })
    small = [rows_block("protocol", [PROTOCOL]),
             rows_block("metaData", [METADATA])]
    return write_checkpoint(log, version, small, adds, removes,
                            part_size=max(1, n // 8),
                            now_ms=now_ms)


def synth_delta_log(path: str, commits: int, files_per_commit: int,
                    remove_fraction: float = 0.2, seed: int = 0,
                    checkpoint_version: Optional[int] = None,
                    now_ms: Optional[int] = None) -> SynthTruth:
    """Write a synthetic `_delta_log`: every commit adds UUID-fresh files
    with stats and removes a slice of earlier-added ones; commit 0 also
    carries the protocol and metadata. No partitions.

    With `checkpoint_version`, also a checkpoint of the state after that
    commit, with `part_size = num_files // 8` (bench.py's split) and
    tombstones retained against `now_ms`.

    Removal picks are swap-popped from the alive list (O(1) per pick) and
    each commit's random draws are one vectorized call."""
    rng = np.random.default_rng(seed)
    log = os.path.join(path, "_delta_log")
    os.makedirs(log, exist_ok=True)
    protocol = json.dumps({"protocol": PROTOCOL}, separators=(",", ":"))
    metadata = json.dumps({"metaData": METADATA}, separators=(",", ":"))
    paths: List[str] = []
    add_version: List[int] = []
    alive: List[int] = []  # file ids
    removed: List[tuple] = []  # (file id, version)
    info = None
    n_rm = int(files_per_commit * remove_fraction)
    n_add_max = files_per_commit - n_rm
    for v in range(commits):
        lines = []
        if v == 0:
            lines.append(protocol)
            lines.append(metadata)
        k = min(n_rm, len(alive))
        if k:
            # one vectorized draw; each pick is uniform over the list
            # length at its own step (lengths shrink by one per pick)
            picks = rng.integers(
                0, np.arange(len(alive), len(alive) - k, -1))
            for j in picks:
                f = alive[j]
                alive[j] = alive[-1]
                alive.pop()
                removed.append((f, v))
                lines.append(
                    f'{{"remove":{{"path":"{paths[f]}","deletionTimestamp":'
                    f'{v},"dataChange":true}}}}'
                )
        uuids = rng.integers(0, 1 << 60, size=n_add_max)
        for u in uuids:
            fid = len(paths)
            p = f"part-{fid:010d}-{u:016x}.parquet"
            paths.append(p)
            add_version.append(v)
            alive.append(fid)
            lo, hi = (fid + 1) * 1000, (fid + 2) * 1000
            lines.append(
                f'{{"add":{{"path":"{p}","partitionValues":{{}},'
                f'"size":1048576,"modificationTime":{v},"dataChange":true,'
                f'"stats":"{{\\"numRecords\\":1000,'
                f'\\"minValues\\":{{\\"x\\":{lo}}},'
                f'\\"maxValues\\":{{\\"x\\":{hi}}},'
                f'\\"nullCount\\":{{\\"x\\":0}}}}"}}}}'
            )
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(lines) + "\n")
        if v == checkpoint_version:
            info = _synth_checkpoint(log, v, paths, alive, add_version,
                                     removed, now_ms)
    return SynthTruth(version=commits - 1,
                      live_paths=sorted(paths[f] for f in alive),
                      size_in_bytes=ADD_SIZE * len(alive),
                      num_tombstones=len(removed),
                      num_actions=len(paths) + len(removed),
                      checkpoint=info)

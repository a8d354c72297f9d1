"""Checkpoint writing: classic single-file, multi-part and V2.

Counterpart of `delta_tpu/log/checkpointer.py` (`write_checkpoint` :520,
`_write_checkpoint` :536, `_chunk_plan` :658, `_writer_fp` :679,
`_part_fp` :700, `_prev_part_index` :716, `_write_multipart_checkpoint`
:795, `_sidecar_usable` :867, `_write_v2_checkpoint` :878). A checkpoint
holds the state at a version in the SingleAction layout, one non-null
root struct per row:

- one protocol and one metaData row; one txn row per appId (those idle
  past `delta.setTransactionRetentionDuration` dropped); one
  domainMetadata row per domain;
- every live add, and every remove tombstone whose deletionTimestamp is
  within `delta.deletedFileRetentionDuration` of now (real clock), both
  with dataChange written false; the add's stats as the JSON string
  (`delta.checkpoint.writeStatsAsJson`, on by default) and/or as the
  typed `stats_parsed` struct (`writeStatsAsStruct`, `stats/parsed.py`).

The columns are the reference's `ADD_STRUCT` / `REMOVE_STRUCT` (:70-97),
so the add has no `tags` column, as there. A multi-part checkpoint
(`settings.checkpoint_part_size` below the file-action count) puts the
small actions alone in part 1 and fixed `part_size`-row chunks of
[adds; removes] in the others (`part_layout`, which the synthetic
checkpoint of `utils/synth.py` shares). A V2 checkpoint
(`delta.checkpointPolicy=v2`, or `policy="v2"`) puts those chunks in
UUID-named `_sidecars/` files and writes a UUID-named Parquet top level
of checkpointMetadata, sidecar pointers and the small actions. The file
actions come from the snapshot's row store by column (`_file_block`):
checkpoint rows straight from the part's leaves, commit rows through
their actions. Each row keeps its path as the log held it, the URI that
the load percent-decoded once to the snapshot's path, so the next load
decodes it once to the same path whatever form another writer gave it
(`p=a%2520b/` stays, where the decoded `p=a%20b/` would decode again to
`p=a b/`). Each part is encoded by `encode_part`
(`utils/parquet_write.py` underneath) and written put-if-absent through
`write/ckpt_pipeline.py`; a torn write deletes what this attempt created
(`checkpoint.aborted_writes`) and leaves `_last_checkpoint` at the
previous checkpoint.

Incremental checkpoints: each file-action part is fingerprinted
(`_part_fp`, over the levels and values the encoder writes) and the
fingerprints ride `_last_checkpoint` as `partManifest`. The next write
with that hint as `prev_info` reuses the matched parts
(`checkpoint.parts_reused`): a multi-part part is copied under the new
name, a V2 sidecar is pointed at again. Append-only workloads rewrite
only the tail part.

The aggregate stage (`ops/stats.py`) reduces the add lanes (size,
modification time, deletion-vector cardinality, partition codes) per
part on the engine's device; a failure there raises. Its block yields
the counters `checkpoint.logical_bytes`, `checkpoint.dv_cardinality` and
`checkpoint.distinct_partition_values`, the facts of the reference's
`checkpoint.aggregate` span.
"""

from __future__ import annotations

import hashlib
import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch import obs
from delta_tpu_torch.config import (
    CHECKPOINT_POLICY,
    CHECKPOINT_WRITE_STATS_AS_JSON,
    CHECKPOINT_WRITE_STATS_AS_STRUCT,
    SET_TXN_RETENTION,
    TOMBSTONE_RETENTION,
    get_table_config,
    settings,
)
from delta_tpu_torch.errors import ChecksumMismatchError
from delta_tpu_torch.log.last_checkpoint import (
    LastCheckpointInfo,
    write_last_checkpoint,
)
from delta_tpu_torch.log.parquet_host import Strings, ragged_arange
from delta_tpu_torch.utils import filenames
from delta_tpu_torch.utils.parquet_write import (
    LeafColumn,
    SchemaNode,
    physical_values,
    primitive_node,
    write_parquet,
)
from delta_tpu_torch.write import ckpt_pipeline

_BYTES_WRITTEN = obs.counter("checkpoint.bytes_written")
_PARTS_WRITTEN = obs.counter("checkpoint.parts_written")
_PARTS_REUSED = obs.counter("checkpoint.parts_reused")
_ABORTED_WRITES = obs.counter("checkpoint.aborted_writes")
_LOGICAL_BYTES = obs.counter("checkpoint.logical_bytes")
_DV_CARDINALITY = obs.counter("checkpoint.dv_cardinality")
_DISTINCT_PARTITION_VALUES = obs.counter(
    "checkpoint.distinct_partition_values")

RETENTION_MS = TOMBSTONE_RETENTION.default


# ------------------------------------------------------------- schema --

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

# a V2 checkpoint's top level: its version and the sidecar pointers
_CP_META = _grp("checkpointMetadata", _leaf("version", "INT64"))
_SIDECAR = _grp("sidecar", _str("path"), _leaf("sizeInBytes", "INT64"),
                _leaf("modificationTime", "INT64"))
_ROOTS.update({n.name: n for n in (_CP_META, _SIDECAR)})

# stats_parsed leaf kind -> (physical, converted, logical, timestamp)
_STATS_LEAF = {
    "int64": ("INT64", None, None, None),
    "int32": ("INT32", None, None, None),
    "int16": ("INT32", 16, None, None),
    "int8": ("INT32", 15, None, None),
    "float64": ("DOUBLE", None, None, None),
    "float32": ("FLOAT", None, None, None),
    "bool": ("BOOLEAN", None, None, None),
    "string": ("BYTE_ARRAY", 0, 1, None),
    "date32": ("INT32", 6, 6, None),
    "ts_us_utc": ("INT64", 10, 8, (True, 2)),
    "ts_us": ("INT64", None, 8, (False, 2)),
    "ts_s": ("INT64", None, 8, (False, 1)),  # seconds, written as millis
    "null": ("INT32", None, 11, None),
}


def _stats_parsed_node(name: str, t) -> SchemaNode:
    """The Parquet schema of a `stats/parsed.py::SType`."""
    if t.kind == "struct":
        return _grp(name, *(_stats_parsed_node(k, v)
                            for k, v in t.fields.items()))
    if t.kind.startswith("decimal("):
        return primitive_node(name, 1, t.kind)
    phys, conv, logical, ts = _STATS_LEAF[t.kind]
    return SchemaNode(name, 1, physical=phys, converted=conv,
                      logical=logical, timestamp=ts or (True, 2),
                      int_bits={15: 8, 16: 16}.get(conv))


def _stats_parsed_cols(col, prefix=("stats_parsed",)) -> dict:
    """Block columns of a parsed `stats_parsed` column."""
    out: Dict[tuple, object] = {prefix: col.valid}
    for name, c in col.fields.items():
        path = prefix + (name,)
        if c.type.kind == "struct":
            out.update(_stats_parsed_cols(c, path))
            continue
        kind, data, valid = c.type.kind, c.data, c.valid
        if kind == "string":
            vals = [v if ok else "" for v, ok in zip(data.tolist(),
                                                     valid.tolist())]
            try:
                data = Strings.from_list(vals)
            except ValueError:  # a NUL byte
                data = Strings.from_bytes([v.encode("utf-8") for v in vals])
        elif kind == "ts_s":
            data = np.asarray(data, np.int64) * 1000
        elif kind.startswith("decimal("):
            data = physical_values(kind, data)
        elif kind == "null":
            data = np.zeros(len(valid), np.int32)
        out[path] = (data, valid)
    return out


# ------------------------------------------------------------- blocks --

def _empty_strings(n: int = 0) -> Strings:
    return Strings(np.zeros(0, np.uint8), np.zeros(n, np.int64),
                   np.zeros(n, np.int64))


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

    @staticmethod
    def concat(parts: Sequence["Repeated"]) -> "Repeated":
        sizes = [int(p.offsets[-1]) for p in parts]
        base = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        offsets = np.concatenate([[0]] + [p.offsets[1:] + b
                                          for p, b in zip(parts, base)])
        keyed = parts[0].keys is not None
        return Repeated(
            np.concatenate([p.valid for p in parts]), offsets.astype(np.int64),
            Strings.concat([p.items for p in parts]),
            np.concatenate([p.item_valid for p in parts]),
            Strings.concat([p.keys for p in parts]) if keyed else None)


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


def _null_like(c, n: int):
    if isinstance(c, Repeated):
        return Repeated(np.zeros(n, bool), np.zeros(n + 1, np.int64),
                        _empty_strings(), np.zeros(0, bool),
                        None if c.keys is None else _empty_strings())
    if isinstance(c, tuple):
        v = _empty_strings(n) if isinstance(c[0], Strings) \
            else np.zeros(n, c[0].dtype)
        return v, np.zeros(n, bool)
    return np.zeros(n, bool)


def _concat_blocks(root: str, blocks: Sequence[Block]) -> Block:
    """The rows of `blocks` in order; a column absent from some block is
    null there."""
    blocks = [b for b in blocks if b.n]
    if len(blocks) == 1:
        return blocks[0]
    keys = {k: c for b in blocks for k, c in b.cols.items()}
    cols: Dict[tuple, object] = {}
    for k, like in keys.items():
        per = [b.cols.get(k, None) for b in blocks]
        per = [c if c is not None else _null_like(like, b.n)
               for c, b in zip(per, blocks)]
        if isinstance(like, Repeated):
            cols[k] = Repeated.concat(per)
        elif isinstance(like, tuple):
            vals = [c[0] for c in per]
            cols[k] = ((Strings.concat(vals) if isinstance(vals[0], Strings)
                        else np.concatenate(vals)),
                       np.concatenate([c[1] for c in per]))
        else:
            cols[k] = np.concatenate(per)
    return Block(root, sum(b.n for b in blocks), cols)


def _strings(values: Sequence[Optional[str]]):
    return (Strings.from_list([v if v is not None else "" for v in values]),
            np.array([v is not None for v in values], bool))


def rows_block(root: str, rows: Sequence[dict]) -> Block:
    """A Block from Python dicts (one per row; maps as dicts, lists as
    lists, None or absent for null). Loops over rows: for the small
    actions, commit rows and tests."""
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


# ------------------------------------------------------------ encoder --

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
                    vals = (_empty_strings(block.n)
                            if child.physical == "BYTE_ARRAY" else
                            np.zeros((block.n, child.type_length), np.uint8)
                            if child.type_length is not None
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
                      _empty_strings(), np.zeros(0, bool), _empty_strings())
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


_PHYS_DTYPE = {"INT32": np.int32, "INT64": np.int64, "FLOAT": np.float32,
               "DOUBLE": np.float64, "BOOLEAN": bool}


def encode_part(blocks: Sequence[Block],
                roots: Optional[Sequence[SchemaNode]] = None) -> bytes:
    """One checkpoint Parquet file holding `blocks` (row ranges, in
    order; each row has exactly one non-null root), with the root structs
    `roots` (the SingleAction schema's by default)."""
    n_rows = sum(b.n for b in blocks)
    columns = []
    schema = (CHECKPOINT_SCHEMA if roots is None
              else SchemaNode("schema", 0, tuple(roots)))
    for root in schema.children:
        per_block = [_block_leaves(root, b) if b.root == root.name else None
                     for b in blocks]
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
                values = Strings.concat(vals) if vals else _empty_strings()
            elif phys == "FIXED_LEN_BYTE_ARRAY":
                values = np.concatenate(vals) if vals else template[k][4]
            else:
                values = np.asarray(np.concatenate(vals) if vals
                                    else np.zeros(0), _PHYS_DTYPE[phys])
            columns.append(LeafColumn(
                (root.name,) + path, phys,
                np.concatenate(defs) if defs else np.zeros(0, np.int32),
                (np.concatenate(reps) if reps else np.zeros(0, np.int32))
                if max_rep else None, max_def, max_rep, values))
    return write_parquet(schema, columns, n_rows)


def _chunk_plan(n_add: int, n_rem: int, part_size: int) -> List[tuple]:
    """Fixed `part_size`-row chunks over [adds; removes] ->
    [(a0, a1, r0, r1)] per part (the reference's `_chunk_plan`)."""
    total = n_add + n_rem
    out = []
    lo = 0
    while lo < total:
        hi = min(lo + part_size, total)
        out.append((min(lo, n_add), min(hi, n_add),
                    max(lo, n_add) - n_add, max(hi, n_add) - n_add))
        lo = hi
    return out or [(0, 0, 0, 0)]


@dataclass
class PartLayout:
    """The files of one checkpoint: each part's path and blocks, the
    chunk plan of the file-action parts, and the row counts."""

    paths: List[str]
    contents: List[List[Block]]
    plan: List[tuple]
    rows: int
    num_adds: int

    def hint(self, version: int, size_in_bytes: Optional[int]
             ) -> LastCheckpointInfo:
        """The `_last_checkpoint` record of these parts."""
        return LastCheckpointInfo(
            version=version, size=self.rows,
            parts=len(self.paths) if len(self.paths) > 1 else None,
            sizeInBytes=size_in_bytes, numOfAddFiles=self.num_adds)


def _data_change_false(block: Block) -> Block:
    """`block` with dataChange written false on every row, as every
    checkpoint writes its file actions."""
    cols = dict(block.cols)
    cols[("dataChange",)] = (np.zeros(block.n, bool), np.ones(block.n, bool))
    return Block(block.root, block.n, cols)


def part_layout(log_path: str, version: int, small: Sequence[Block],
                adds: Block, tombs: Block,
                part_size: Optional[int]) -> PartLayout:
    """The checkpoint at `version` of the `small` action blocks, the live
    `adds` and the retained `tombs`, with dataChange written false on
    every add and remove: one classic file, or, when `part_size` is
    given and the file actions exceed it, the small actions alone in part
    1 and `_chunk_plan` chunks of [adds; tombs] in the others."""
    adds, tombs = _data_change_false(adds), _data_change_false(tombs)
    small = list(small)
    if part_size is not None and adds.n + tombs.n > part_size:
        plan = _chunk_plan(adds.n, tombs.n, part_size)
        contents = [small] + [
            [adds.take(np.arange(a0, a1)), tombs.take(np.arange(r0, r1))]
            for a0, a1, r0, r1 in plan]
        paths = filenames.checkpoint_file_with_parts(log_path, version,
                                                     len(contents))
    else:
        plan = [(0, adds.n, 0, tombs.n)]
        contents = [small + [adds, tombs]]
        paths = [filenames.checkpoint_file_singular(log_path, version)]
    return PartLayout(paths, contents, plan,
                      sum(b.n for b in small) + adds.n + tombs.n, adds.n)


# ----------------------------------------------- rows from a snapshot --

def _part_map(read, path: str, rows: np.ndarray) -> Optional[Repeated]:
    """The map<string,string> at `path` for part `rows`, from the host
    reader's key and value leaves."""
    keys = read.leaves.get(f"{path}.key_value.key")
    if keys is None:
        return None
    vals = read.leaves.get(f"{path}.key_value.value")
    k_rep = keys.leaf.rep_at.index(1)
    container = keys.leaf.def_at[k_rep - 1] if k_rep else 0
    starts = keys.row_starts
    s, e = starts[rows], starts[rows + 1]
    d = keys.defs[s]
    valid = d >= container
    counts = np.where(d >= keys.leaf.def_at[k_rep], e - s, 0)
    entry = np.repeat(s, counts) + ragged_arange(counts)
    key_strings = keys.values.take(keys.value_index[entry])
    if vals is None:
        items = _empty_strings(len(entry))
        item_valid = np.zeros(len(entry), bool)
    else:
        vi = vals.value_index[entry]
        item_valid = vi >= 0
        items = (vals.values.take(np.maximum(vi, 0)) if len(vals.values)
                 else _empty_strings(len(entry)))
    return Repeated(valid, np.concatenate([[0], np.cumsum(counts)])
                    .astype(np.int64), items, item_valid, key_strings)


def _part_block(part, root: str, rows: np.ndarray) -> Block:
    """The `root` file actions at part `rows`, column by column (the add
    stats of a part that holds them only as `stats_parsed` re-serialized,
    as the snapshot reads them)."""
    from delta_tpu_torch.replay.columnar import leaf_column

    read = part.read
    cols: Dict[tuple, object] = {}

    def walk(node, prefix):
        for child in node.children:
            path = prefix + (child.name,)
            full = ".".join((root,) + path)
            if child.converted == 1:
                rc = _part_map(read, full, rows)
                if rc is not None:
                    cols[path] = rc
            elif child.children:
                leaf = next((lf for p, lf in read.leaves.items()
                             if p.startswith(full + ".")), None)
                if leaf is not None:
                    cols[path] = leaf.present(len(path), rows)
                    walk(child, path)
            else:
                c = leaf_column(read, full, rows)
                if c is not None:
                    cols[path] = c

    walk(_ROOTS[root], ())
    if root == "add" and part.data is not None:
        cols[("stats",)] = _strings(part.stats(rows))
    return Block(root, len(rows), cols)


def _span_block(store, idx: np.ndarray, root: str) -> Block:
    """The `root` actions at rows `idx` of the device parse's row store,
    from its host lanes (simple lines: no deletion vector, no tags, an
    empty or absent partitionValues map)."""
    a = store.lanes
    n = len(idx)
    ones = np.ones(n, bool)
    cols: Dict[tuple, object] = {
        ("path",): (Strings.from_list(store.strings(idx, "path", ones)),
                    ones),
        ("partitionValues",): Repeated(
            a["pv_present"][idx], np.zeros(n + 1, np.int64),
            _empty_strings(), np.zeros(0, bool), _empty_strings()),
        ("size",): (a["size"][idx], a["size_present"][idx]),
    }
    if root == "add":
        cols[("modificationTime",)] = (a["mod_time"][idx],
                                       a["mod_time_present"][idx])
        cols[("stats",)] = _strings(store.strings(
            idx, "stats", a["stats_present"][idx]))
    else:
        cols[("deletionTimestamp",)] = (a["del_ts"][idx],
                                        a["del_ts_present"][idx])
        cols[("extendedFileMetadata",)] = (a["ext_meta_val"][idx].astype(bool),
                                           a["ext_meta_present"][idx])
    return Block(root, n, cols)


def _file_block(store, idx: np.ndarray, root: str) -> Block:
    """The `root` ("add" or "remove") actions at rows `idx` (ascending)
    of a snapshot's row store, as a Block of the values the log holds
    (an empty partitionValues map stays empty, an absent one null):
    checkpoint rows column by column from their part's leaves, device
    parsed commit rows from their host lanes, host parsed ones from their
    JSON bodies."""
    from delta_tpu_torch.replay.columnar import CheckpointRows, CompositeRows
    from delta_tpu_torch.replay.device_parse import SpanRows
    from delta_tpu_torch.replay.host_parse import DictRows

    if isinstance(store, CompositeRows):
        return _concat_blocks(root, [_file_block(st, local, root)
                                     for st, local in store.pieces(idx)])
    if isinstance(store, CheckpointRows):
        return _concat_blocks(root, [
            _part_block(part, root, rows)
            for part, _, rows in store.blocks(idx)])
    if isinstance(store, SpanRows):
        return _span_block(store, idx, root)
    if isinstance(store, DictRows):
        return rows_block(root, [store.bodies[i] for i in idx.tolist()])
    raise TypeError(f"no file actions from a {type(store).__name__}")


def retained(tombs: Block, now_ms: int, retention_ms: int) -> Block:
    """The tombstones whose deletionTimestamp (null reads 0) is at least
    `now_ms - retention_ms`."""
    ts, ok = tombs.cols.get(("deletionTimestamp",),
                            (np.zeros(tombs.n, np.int64),
                             np.zeros(tombs.n, bool)))
    return tombs.take(np.flatnonzero(np.where(ok, ts, 0)
                                     >= now_ms - retention_ms))


def _small_action_blocks(state, txn_min_last_updated: Optional[int] = None
                        ) -> List[Block]:
    """protocol, metaData, txn and domainMetadata rows of `state` (the
    reference's `_small_action_arrays`); txns idle before
    `txn_min_last_updated`, or without a lastUpdated, are dropped when it
    is given."""
    proto, meta = state.protocol, state.metadata
    blocks = [
        rows_block("protocol", [{
            "minReaderVersion": proto.minReaderVersion,
            "minWriterVersion": proto.minWriterVersion,
            "readerFeatures": (sorted(proto.readerFeatures)
                               if proto.readerFeatures is not None else None),
            "writerFeatures": (sorted(proto.writerFeatures)
                               if proto.writerFeatures is not None else None),
        }]),
        rows_block("metaData", [{
            "id": meta.id, "name": meta.name,
            "description": meta.description,
            "format": {"provider": meta.format.provider,
                       "options": dict(meta.format.options)},
            "schemaString": meta.schemaString,
            "partitionColumns": list(meta.partitionColumns),
            "configuration": dict(meta.configuration),
            "createdTime": meta.createdTime,
        }])]
    txns = list(state.set_transactions.values())
    if txn_min_last_updated is not None:
        txns = [t for t in txns if t.lastUpdated is not None
                and t.lastUpdated >= txn_min_last_updated]
    if txns:
        blocks.append(rows_block("txn", [
            {"appId": t.appId, "version": t.version,
             "lastUpdated": t.lastUpdated} for t in txns]))
    if state.domain_metadata:
        blocks.append(rows_block("domainMetadata", [
            {"domain": d.domain, "configuration": d.configuration,
             "removed": d.removed} for d in state.domain_metadata.values()]))
    return blocks


# ---------------------------------------------------------- aggregates --

def _partition_codes(state, adds: Block):
    """Dictionary code of each add's partition-value tuple; every row
    codes 0 in an unpartitioned table."""
    if not state.metadata.partitionColumns:
        return np.zeros(adds.n, np.int64), 1
    pv = adds.cols.get(("partitionValues",))
    codebook: dict = {}
    codes = np.empty(adds.n, np.int64)
    for i in range(adds.n):
        key = ()
        if pv is not None and pv.valid[i]:
            lo, hi = int(pv.offsets[i]), int(pv.offsets[i + 1])
            key = tuple((pv.keys.raw(j),
                         pv.items.raw(j) if pv.item_valid[j] else None)
                        for j in range(lo, hi))
        codes[i] = codebook.setdefault(key, len(codebook))
    return codes, max(len(codebook), 1)


def _lane(block: Block, path: tuple, struct: Optional[tuple] = None):
    n = block.n
    vals, ok = block.cols.get(path, (np.zeros(n, np.int64),
                                     np.zeros(n, bool)))
    if struct is not None:
        ok = ok & block.cols.get(struct, np.zeros(n, bool))
    return np.where(ok, vals, 0).astype(np.int64), ok


def _checkpoint_lanes(state, adds: Block, plan: List[tuple]):
    """The aggregate stage's inputs (the reference's
    `_checkpoint_aggregates`): lanes size, modification time,
    deletion-vector cardinality and partition code of every add, their
    validity, each add's part, and the partition code count."""
    size_v, size_ok = _lane(adds, ("size",))
    mt_v, mt_ok = _lane(adds, ("modificationTime",))
    dv_v, dv_ok = _lane(adds, ("deletionVector", "cardinality"),
                        ("deletionVector",))
    codes, n_codes = _partition_codes(state, adds)
    part_of = np.zeros(adds.n, np.int32)
    for i, (a0, a1, _r0, _r1) in enumerate(plan):
        part_of[a0:a1] = i
    return ([size_v, mt_v, dv_v, codes],
            [size_ok, mt_ok, dv_ok, np.ones(adds.n, bool)], part_of, n_codes)


def _publish_aggregates(block: np.ndarray, n_lanes: int) -> None:
    """The facts the reference's `checkpoint.aggregate` span carries, as
    counters summed over writes: the live files' logical bytes, their
    deletion-vector cardinality, and the most distinct partition values
    in one part."""
    _LOGICAL_BYTES.inc(int(block[2 * n_lanes].sum()))
    _DV_CARDINALITY.inc(int(block[2 * n_lanes + 2].sum()))
    _DISTINCT_PARTITION_VALUES.inc(int(block[4 * n_lanes].max(initial=0)))


# -------------------------------------------------------------- write --

def _strings_list(col) -> List[Optional[str]]:
    """(Strings, valid) -> Python strings, None where null."""
    vals, ok = col
    return [vals.raw(i).decode("utf-8") if v else None
            for i, v in enumerate(ok.tolist())]


def _add_stats_parsed(state, conf, adds: Block) -> Optional[SchemaNode]:
    """Parse the adds' stats strings into `stats_parsed` columns of
    `adds` (the reference's `_parse_stats_structs` against
    `_stats_parsed_schema`); returns the add struct's schema with the
    field, or None when nothing parsed."""
    from delta_tpu_torch.stats.parsed import (
        parse_stats_structs,
        stats_parsed_schema,
    )

    stats = adds.cols.get(("stats",))
    if stats is None:
        return None
    meta = state.metadata
    explicit = stats_parsed_schema(meta.schemaString, conf,
                                   list(meta.partitionColumns or []))
    parsed = parse_stats_structs(_strings_list(stats), explicit)
    if parsed is None:
        return None
    adds.cols.update(_stats_parsed_cols(parsed))
    return _grp("add", *(_ROOTS["add"].children
                         + (_stats_parsed_node("stats_parsed", parsed.type),)))


def _writer_fp(policy: str, part_size: Optional[int], stats_as_json: bool,
               stats_as_struct: bool, schema_string: Optional[str]) -> str:
    """Fingerprint of what shapes a part's bytes besides its rows (the
    reference's `_writer_fp`): a part is reused only from a manifest of
    an identically configured writer. The layout tag is this package's
    own, so that a manifest of the other package's writer, whose part
    fingerprints hash other bytes, is never consulted."""
    blob = json.dumps({
        "layout": "torch-1",
        "policy": policy,
        "partSize": part_size,
        "statsAsJson": bool(stats_as_json),
        "statsAsStruct": bool(stats_as_struct),
        "schema": hashlib.sha1((schema_string or "").encode()).hexdigest(),
    }, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def _part_fp(writer_fp: str, add_node: SchemaNode, adds: Block,
             tombs: Block) -> str:
    """Content fingerprint of one part's file-action rows: sha1 over the
    levels and values the encoder writes for them (absent and null
    columns alike), so equal rows give equal fingerprints whichever row
    store they came from."""
    h = hashlib.sha1(writer_fp.encode())
    for node, block in ((add_node, adds), (_ROOTS["remove"], tombs)):
        h.update(f"{node.name}:{block.n};".encode())
        for path, _, defs, reps, vals, _, _ in _block_leaves(node, block):
            h.update(".".join(path).encode())
            h.update(np.ascontiguousarray(defs).tobytes())
            if reps is not None:
                h.update(np.ascontiguousarray(reps).tobytes())
            if isinstance(vals, Strings):
                h.update(np.ascontiguousarray(vals.lens).tobytes())
                idx = (np.repeat(vals.starts, vals.lens)
                       + ragged_arange(vals.lens))
                h.update(vals.buf[idx].tobytes())
            else:
                h.update(np.ascontiguousarray(vals).tobytes())
    return h.hexdigest()[:20]


def _prev_part_index(prev_info: Optional[LastCheckpointInfo],
                     writer_fp: str) -> Dict[str, dict]:
    """fingerprint -> manifest entry of the previous checkpoint's
    file-action parts; empty unless an identically configured writer made
    the manifest (an unknown or absent one means a full write, never a
    wrong reuse)."""
    if prev_info is None:
        return {}
    pm = prev_info.partManifest
    if not isinstance(pm, dict) or pm.get("writerFp") != writer_fp:
        return {}
    return {e["fp"]: e for e in pm.get("parts") or []
            if isinstance(e, dict) and e.get("fp") and e.get("name")}


def _reusing(fs, prev_path: str, fresh: Callable[[], bytes]
             ) -> Callable[[], bytes]:
    """A multi-part part's build from a fingerprint-matched previous part:
    its bytes copied under the new name (the old part may be cleaned up
    once shadowed); a part that is gone or unreadable is encoded anew."""

    def build() -> bytes:
        try:
            data = fs.read_file(prev_path)
        except OSError:
            return fresh()
        _PARTS_REUSED.inc()
        return data

    return build


@dataclass
class CheckpointMetrics:
    """What one `write_checkpoint` did: wall seconds by phase
    ("rows", "retention", "aggregate", "encode", "put", "hint"), the
    parts, rows and bytes written, and the parts reused."""

    phase_seconds: Dict[str, float] = field(default_factory=dict)
    parts: int = 0
    rows: int = 0
    bytes_written: int = 0
    parts_reused: int = 0


def write_checkpoint(engine, snapshot,
                     metrics: Optional[CheckpointMetrics] = None,
                     policy: Optional[str] = None,
                     prev_info: Optional[LastCheckpointInfo] = None,
                     ) -> LastCheckpointInfo:
    """Write a checkpoint of `snapshot` and point `_last_checkpoint` at
    it; returns the hint written. `policy` ("classic" or "v2") defaults
    to `delta.checkpointPolicy`. `prev_info`, the previous hint, lets
    parts of an identically configured writer be reused: a multi-part
    part copied, a V2 sidecar pointed at again. `metrics`, when given, is
    filled in."""
    from delta_tpu_torch.ops import stats

    m = metrics if metrics is not None else CheckpointMetrics()
    ph = m.phase_seconds
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        engine.synchronize()
        now = time.perf_counter()
        ph[name] = ph.get(name, 0.0) + now - t
        t = now

    state = snapshot.state
    conf = state.metadata.configuration
    if policy is None:
        policy = get_table_config(conf, CHECKPOINT_POLICY)
    stats_as_json = get_table_config(conf, CHECKPOINT_WRITE_STATS_AS_JSON)
    stats_as_struct = get_table_config(conf, CHECKPOINT_WRITE_STATS_AS_STRUCT)
    now_ms = int(time.time() * 1000)
    store = state.file_actions.rows
    live = np.flatnonzero(state.live_mask.cpu().numpy())
    dead = np.flatnonzero(state.tombstone_mask.cpu().numpy())
    adds = _file_block(store, live, "add")
    tombs = _file_block(store, dead, "remove")
    add_node = _ROOTS["add"]
    if stats_as_struct:
        add_node = _add_stats_parsed(state, conf, adds) or add_node
    if not stats_as_json:
        adds.cols.pop(("stats",), None)
    mark("rows")
    tombs = retained(tombs, now_ms, get_table_config(conf,
                                                     TOMBSTONE_RETENTION))
    txn_retention = get_table_config(conf, SET_TXN_RETENTION)
    small = _small_action_blocks(
        state, None if txn_retention is None else now_ms - txn_retention)
    mark("retention")
    if adds.n != state.num_files:
        raise ChecksumMismatchError(
            f"checkpoint add rows {adds.n} != snapshot numFiles "
            f"{state.num_files}",
            error_class="DELTA_CHECKPOINT_SNAPSHOT_MISMATCH")
    log_path = snapshot._table.log_path
    version = snapshot.version
    part_size = settings.checkpoint_part_size
    n_files = adds.n + tombs.n
    if policy == "v2":
        route = "v2"
        plan = _chunk_plan(adds.n, tombs.n, part_size or max(n_files, 1))
    else:
        layout = part_layout(log_path, version, small, adds, tombs,
                             part_size)
        route = "multipart" if len(layout.paths) > 1 else "classic"
        plan = layout.plan
    mark("rows")

    lanes, valids, part_of, n_codes = _checkpoint_lanes(state, adds, plan)
    block = stats.checkpoint_stats_block(lanes, valids, part_of, len(plan),
                                         n_codes, engine.device)
    _publish_aggregates(block, len(lanes))
    mark("aggregate")

    writer_fp = _writer_fp(policy, part_size, stats_as_json,
                           stats_as_struct, state.metadata.schemaString)
    prev_parts = (_prev_part_index(prev_info, writer_fp)
                  if route != "classic" else {})
    reused0 = _PARTS_REUSED.read()
    roots = [add_node if r.name == "add" else r
             for r in CHECKPOINT_SCHEMA.children]
    try:
        if route == "v2":
            info = _write_v2(engine.fs, log_path, version, small, adds,
                             tombs, plan, roots, add_node, writer_fp,
                             prev_parts, ph, m)
        else:
            info = _write_parts(engine.fs, log_path, version, layout,
                                roots, add_node, writer_fp, prev_parts,
                                ph, m)
    except ckpt_pipeline.CheckpointWriteError as e:
        _ABORTED_WRITES.inc()
        _cleanup_orphans(engine.fs, e.touched_paths)
        raise
    m.parts_reused = _PARTS_REUSED.read() - reused0
    t = time.perf_counter()
    write_last_checkpoint(engine.fs, log_path, info)
    mark("hint")
    return info


def _count_written(results, m: CheckpointMetrics) -> None:
    for r in results:
        if r.created:
            _PARTS_WRITTEN.inc()
            _BYTES_WRITTEN.inc(r.nbytes)
    m.bytes_written += sum(r.nbytes for r in results)


def _write_parts(fs, log_path, version, layout: PartLayout, roots, add_node,
                 writer_fp, prev_parts, ph, m) -> LastCheckpointInfo:
    """A classic or multi-part checkpoint; a multi-part one reuses the
    fingerprint-matched parts of `prev_parts` by copy and publishes a
    `partManifest` of its file-action parts."""
    multi = len(layout.paths) > 1
    prev_parts = dict(prev_parts)
    tasks, fps = [], []
    for k, (p, blocks) in enumerate(zip(layout.paths, layout.contents)):
        fresh = (lambda blocks=blocks: encode_part(blocks, roots))
        fp = None
        if multi and k > 0:
            fp = _part_fp(writer_fp, add_node, *blocks)
            # pop, not get: one old part must not serve two new ones
            prev = prev_parts.pop(fp, None)
            if prev is not None:
                fresh = _reusing(fs, f"{log_path}/{prev['name']}", fresh)
        tasks.append(ckpt_pipeline.WriteTask(p, fresh))
        fps.append(fp)
    results = ckpt_pipeline.run_write_tasks(fs, tasks, ph)
    _count_written(results, m)
    m.parts = len(layout.paths)
    m.rows = layout.rows
    whole = all(r.status is not None for r in results)
    total = sum(r.status.size for r in results if r.status is not None)
    info = layout.hint(version, total if whole else None)
    if multi and whole:
        info.partManifest = {"writerFp": writer_fp, "parts": [
            {"name": filenames.file_name(r.task.path), "fp": fp,
             "rows": sum(b.n for b in blocks), "bytes": r.status.size,
             "mtime": r.status.modification_time}
            for r, fp, blocks in zip(results, fps, layout.contents)
            if fp is not None]}
    return info


def _sidecar_usable(fs, log_path: str, entry: dict) -> bool:
    """A previous sidecar is pointed at again only if it still exists (one
    lost to a manual delete is written anew, never left dangling)."""
    try:
        fs.file_status(f"{filenames.sidecar_dir(log_path)}/{entry['name']}")
        return True
    except OSError:
        return False


def _write_v2(fs, log_path, version, small, adds, tombs, plan, roots,
              add_node, writer_fp, prev_parts, ph, m) -> LastCheckpointInfo:
    """A V2 checkpoint (the reference's `_write_v2_checkpoint`): the file
    actions in `_sidecars/<uuid>.parquet`, one per `plan` chunk, and a
    UUID-named Parquet top level holding checkpointMetadata, the sidecar
    pointers and the small actions. A fingerprint-matched previous
    sidecar is pointed at again, not copied: sidecars parse to no version,
    so log cleanup never deletes them. A failed top-level write deletes
    only this attempt's fresh sidecars."""
    adds, tombs = _data_change_false(adds), _data_change_false(tombs)
    prev_parts = dict(prev_parts)
    tasks: List[ckpt_pipeline.WriteTask] = []
    slots, fps, rows = [], [], []
    for a0, a1, r0, r1 in plan:
        blocks = [adds.take(np.arange(a0, a1)), tombs.take(np.arange(r0, r1))]
        fp = _part_fp(writer_fp, add_node, *blocks)
        fps.append(fp)
        rows.append(a1 - a0 + r1 - r0)
        prev = prev_parts.pop(fp, None)
        if prev is not None and _sidecar_usable(fs, log_path, prev):
            _PARTS_REUSED.inc()
            slots.append(("reuse", prev["name"], prev.get("bytes"),
                          prev.get("mtime")))
            continue
        name = f"{uuid.uuid4()}.parquet"
        tasks.append(ckpt_pipeline.WriteTask(
            f"{filenames.sidecar_dir(log_path)}/{name}",
            lambda blocks=blocks: encode_part(blocks, roots)))
        slots.append(("task", len(tasks) - 1, name))
    results = ckpt_pipeline.run_write_tasks(fs, tasks, ph)
    _count_written(results, m)
    sidecars = []
    for slot in slots:
        if slot[0] == "reuse":
            sidecars.append(slot[1:])
        else:
            st = results[slot[1]].status
            sidecars.append((slot[2], st.size, st.modification_time))
    top = [rows_block("checkpointMetadata", [{"version": version}]),
           rows_block("sidecar", [
               {"path": p, "sizeInBytes": b, "modificationTime": t}
               for p, b, t in sidecars])] + list(small)
    present = {b.root for b in small}
    top_roots = [_CP_META, _SIDECAR] + [
        r for r in CHECKPOINT_SCHEMA.children
        if r.name in present]
    top_path = filenames.top_level_v2_checkpoint_file(log_path, version)
    try:
        t0 = time.perf_counter()
        data = encode_part(top, top_roots)
        t1 = time.perf_counter()
        fs.write(top_path, data, overwrite=False)
        st = fs.file_status(top_path)
        ph["encode"] = ph.get("encode", 0.0) + (t1 - t0)
        ph["put"] = ph.get("put", 0.0) + (time.perf_counter() - t1)
    except Exception as e:
        fresh = [r.task.path for r in results if r.created]
        raise ckpt_pipeline.CheckpointWriteError(e, fresh + [top_path]) from e
    _PARTS_WRITTEN.inc()
    _BYTES_WRITTEN.inc(len(data))
    m.bytes_written += len(data)
    n_top = sum(b.n for b in top)
    m.parts = len(slots) + 1  # every sidecar, reused or fresh, and the top
    m.rows = n_top + adds.n + tombs.n
    total = sum(b or 0 for _, b, _ in sidecars) + st.size
    return LastCheckpointInfo(
        version=version, size=n_top + adds.n + tombs.n,
        sizeInBytes=total or None, numOfAddFiles=adds.n,
        tag=filenames.file_name(top_path),
        partManifest={"writerFp": writer_fp, "parts": [
            {"name": p, "fp": fp, "rows": n, "bytes": b, "mtime": t}
            for (p, b, t), fp, n in zip(sidecars, fps, rows)]})


def _cleanup_orphans(fs, paths) -> None:
    """Best-effort delete of an aborted attempt's files (the reference's
    `_cleanup_orphans`): the write failure is re-raised by the caller
    either way, and an orphan part is never selected by a reader."""
    for p in paths:
        try:
            fs.delete(p)
        except OSError:
            pass

"""A Parquet writer: data files, and checkpoint parts.

It writes what parquet-cpp (Arrow's writer, which the JAX package uses for
its data files and checkpoints) writes, in the same encodings: one row
group, data page v1, RLE/bit-packed hybrid levels, a dictionary page plus
RLE_DICTIONARY data pages for every non-boolean column, with
parquet-cpp's fallback to PLAIN pages once the dictionary passes
`DICT_LIMIT` bytes (1 MiB), PLAIN booleans, and snappy pages
(`log/snappy.py`). The footer is written with a thrift compact-protocol
writer. Physical types: BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY,
FIXED_LEN_BYTE_ARRAY (big-endian two's complement decimals); logical
annotations STRING, DATE, TIMESTAMP (micros or millis, adjusted to UTC or
not), INT(8/16, signed), DECIMAL (with the DECIMAL converted type, its
precision and scale), LIST, MAP and UNKNOWN (an all-null column of
Arrow's null type); groups nest to any depth.

`write_data_file` writes one data file of a table from a
`models.batch.Batch`, each column as Spark's writer lays out its Delta
type (`models/schema.py::parquet_leaf`; an OPTIONAL field per nullable
field, REQUIRED otherwise). A flat column is numpy over the whole column.
A struct, array or map column (dicts, lists, lists of (key, value)
tuples: `models/batch.py`) is shredded into one leaf per primitive, with
definition and repetition levels by the Dremel rules: a struct is a
group, an array the three-level LIST `<name> (LIST) { repeated group list
{ element } }`, a map `<name> (MAP) { repeated group key_value { required
key; value } }`; that walk visits each element in Python. Under column
mapping (`physical=True`) every field, at every depth, is named by its
physical name.
`write_parquet` takes one `LeafColumn` per leaf, levels and values
already laid out (`utils/synth.py` builds them for the checkpoint
schema).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from delta_tpu_torch.log import snappy
from delta_tpu_torch.log.parquet_host import Strings, ragged_arange
from delta_tpu_torch.models.batch import column_from_python
from delta_tpu_torch.models.schema import (
    ArrayType,
    MapType,
    StructType,
    parquet_leaf,
)
from delta_tpu_torch.storage.local import FileStatus, LocalLogStore

DICT_LIMIT = 1 << 20    # parquet-cpp's default dictionary page size limit
PAGE_ENTRIES = 1 << 15  # level entries per data page, at most

_TYPES = {"BOOLEAN": 0, "INT32": 1, "INT64": 2, "FLOAT": 4, "DOUBLE": 5,
          "BYTE_ARRAY": 6, "FIXED_LEN_BYTE_ARRAY": 7}
_FLBA = "FIXED_LEN_BYTE_ARRAY"  # values: a uint8 matrix, a row each
_NP = {"INT32": np.int32, "INT64": np.int64, "FLOAT": np.float32,
       "DOUBLE": np.float64}
# floats enter the dictionary by bit pattern: 0.0 and -0.0 (and NaNs of
# other payloads) stay distinct entries, as in parquet-cpp's hash table
_BITS = {"FLOAT": np.uint32, "DOUBLE": np.uint64}
_PLAIN, _RLE, _RLE_DICT = 0, 3, 8
_SNAPPY = 1


class _Thrift:
    """Thrift compact-protocol writer: the subset a footer and a page
    header need (i32/i64, binary, lists, nested structs)."""

    def __init__(self):
        self.out = bytearray()
        self._last = [0]

    def varint(self, v: int) -> None:
        while v >= 0x80:
            self.out.append((v & 0x7F) | 0x80)
            v >>= 7
        self.out.append(v)

    def _zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63))

    def _field(self, fid: int, ctype: int) -> None:
        delta = fid - self._last[-1]
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ctype)
        else:
            self.out.append(ctype)
            self._zigzag(fid)
        self._last[-1] = fid

    def i32(self, fid: int, v: int) -> None:
        self._field(fid, 5)
        self._zigzag(v)

    def i64(self, fid: int, v: int) -> None:
        self._field(fid, 6)
        self._zigzag(v)

    def i8(self, fid: int, v: int) -> None:
        self._field(fid, 3)
        self.out.append(v & 0xFF)

    def boolean(self, fid: int, v: bool) -> None:
        self._field(fid, 1 if v else 2)

    def binary(self, fid: int, b: bytes) -> None:
        self._field(fid, 8)
        self.varint(len(b))
        self.out += b

    def begin(self, fid: Optional[int] = None) -> None:
        """Open a struct: a field of the enclosing struct, or (fid None)
        a list element or the top level."""
        if fid is not None:
            self._field(fid, 12)
        self._last.append(0)

    def end(self) -> None:
        self.out.append(0)
        self._last.pop()

    def list(self, fid: int, etype: int, n: int) -> None:
        self._field(fid, 9)
        if n < 15:
            self.out.append((n << 4) | etype)
        else:
            self.out.append(0xF0 | etype)
            self.varint(n)


@dataclass
class SchemaNode:
    """One SchemaElement: a group (children) or a leaf (physical type)."""

    name: str
    repetition: int                 # 0 required, 1 optional, 2 repeated
    children: Tuple["SchemaNode", ...] = ()
    physical: Optional[str] = None
    converted: Optional[int] = None  # 0 UTF8, 1 MAP, 3 LIST, 6 DATE, ...
    logical: Optional[int] = None    # LogicalType: 1 STRING, 2 MAP,
                                     # 3 LIST, 6 DATE, 8 TIMESTAMP,
                                     # 11 UNKNOWN (null)
    timestamp: Tuple[bool, int] = (True, 2)  # TIMESTAMP: adjusted to
                                             # UTC; unit 1 ms, 2 us
    decimal: Optional[Tuple[int, int]] = None  # DECIMAL (converted and
                                               # logical): precision, scale
    int_bits: Optional[int] = None   # INTEGER logical type, signed
    type_length: Optional[int] = None  # FIXED_LEN_BYTE_ARRAY bytes


@dataclass
class LeafColumn:
    """One leaf's column chunk, laid out: definition (and repetition)
    levels per entry, the values at the full definition level."""

    path: Tuple[str, ...]
    physical: str
    defs: np.ndarray
    reps: Optional[np.ndarray]
    max_def: int
    max_rep: int
    values: object  # numpy array, or Strings for BYTE_ARRAY


def _hybrid(v: np.ndarray, w: int) -> bytes:
    """RLE/bit-packed hybrid of `v` at width `w`: one RLE run when every
    value is equal, else one bit-packed run (padded to 8 values)."""
    n = v.shape[0]
    if n == 0:
        return b""
    t = _Thrift()
    if w == 0 or bool((v == v[0]).all()):
        t.varint(n << 1)
        return bytes(t.out) + int(v[0]).to_bytes((w + 7) // 8, "little")
    groups = -(-n // 8)
    padded = np.zeros(groups * 8, np.uint64)
    padded[:n] = v
    bits = ((padded[:, None] >> np.arange(w, dtype=np.uint64)) & 1)
    t.varint((groups << 1) | 1)
    return bytes(t.out) + np.packbits(bits.astype(np.uint8).reshape(-1),
                                      bitorder="little").tobytes()


def _levels(v: np.ndarray, max_level: int) -> bytes:
    body = _hybrid(v.astype(np.uint64), max(1, int(max_level).bit_length()))
    return len(body).to_bytes(4, "little") + body


def _plain(physical: str, values) -> bytes:
    if physical == "BOOLEAN":
        return np.packbits(np.asarray(values, bool),
                           bitorder="little").tobytes()
    if physical == _FLBA:
        return np.ascontiguousarray(values, np.uint8).tobytes()
    if physical != "BYTE_ARRAY":
        return np.asarray(values, _NP[physical]).tobytes()
    n = len(values)
    out = np.zeros(4 * n + int(values.lens.sum()), np.uint8)
    at = np.arange(n, dtype=np.int64) * 4 + np.concatenate(
        [[0], np.cumsum(values.lens)[:-1]]).astype(np.int64)
    out[(at[:, None] + np.arange(4)).reshape(-1)] = \
        values.lens.astype("<u4").view(np.uint8)
    within = ragged_arange(values.lens)
    out[np.repeat(at + 4, values.lens) + within] = values.buf[
        np.repeat(values.starts, values.lens) + within]
    return out.tobytes()


def _dictionary(physical: str, values):
    """(unique values in first-appearance order, each value's code, and
    how many leading values a dictionary under DICT_LIMIT covers)."""
    n = len(values)
    if physical == "BYTE_ARRAY":
        mat, lens = values.matrix()
        keyed = np.concatenate([mat, lens.astype("<u8").view(np.uint8)
                                .reshape(n, 8)], 1)
        keyed = np.ascontiguousarray(keyed).view(
            np.dtype((np.void, keyed.shape[1]))).reshape(n)
        sizes_of = lambda idx: 4 + values.lens[idx]  # noqa: E731
    elif physical == _FLBA:
        mat = np.ascontiguousarray(values, np.uint8)
        keyed = mat.view(np.dtype((np.void, mat.shape[1]))).reshape(n)
        sizes_of = lambda idx: np.full(len(idx), mat.shape[1])  # noqa: E731
    else:
        keyed = np.asarray(values)
        if physical in _BITS:
            keyed = np.ascontiguousarray(keyed).view(_BITS[physical])
        sizes_of = lambda idx: np.full(len(idx), np.dtype(  # noqa: E731
            _NP[physical]).itemsize)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    _, first, inverse = np.unique(keyed, return_index=True,
                                  return_inverse=True)
    rank = np.empty(first.shape[0], np.int64)
    order = np.argsort(first, kind="stable")
    rank[order] = np.arange(first.shape[0])
    firsts = first[order]  # value index of each unique, insertion order
    fits = int(np.searchsorted(np.cumsum(sizes_of(firsts)), DICT_LIMIT,
                               side="right"))
    covered = n if fits == firsts.shape[0] else int(firsts[fits])
    return firsts[:fits], rank[inverse.reshape(-1)], covered


def _page(t_type: int, payload: bytes, num_values: int,
          encoding: int) -> Tuple[bytes, int]:
    """(page header + snappy payload, its uncompressed size)."""
    comp = snappy.compress(payload)
    t = _Thrift()
    t.begin()
    t.i32(1, t_type)
    t.i32(2, len(payload))
    t.i32(3, len(comp))
    if t_type == 0:
        t.begin(5)
        t.i32(1, num_values)
        t.i32(2, encoding)
        t.i32(3, _RLE)
        t.i32(4, _RLE)
        t.end()
    else:
        t.begin(7)
        t.i32(1, num_values)
        t.i32(2, encoding)
        t.end()
    t.end()
    return bytes(t.out) + comp, len(t.out) + len(payload)


def _chunk(col: LeafColumn, base: int):
    """(chunk bytes, column metadata fields) of one leaf."""
    n_entries = col.defs.shape[0]
    full = col.defs == col.max_def
    vpos = np.cumsum(full) - full  # values before each entry
    starts = (np.flatnonzero(col.reps == 0) if col.reps is not None
              else np.arange(n_entries))  # pages begin at a row
    encodings = [_RLE]
    pieces: List[bytes] = []
    uncompressed = 0
    dict_off = None
    codes = None
    plain_from = n_entries
    if col.physical != "BOOLEAN":
        uniq_first, codes, covered = _dictionary(col.physical, col.values)
        if covered < len(col.values):
            # parquet-cpp's fallback: the entries from the first value the
            # dictionary cannot hold (from its row) go out as PLAIN
            e = int(np.searchsorted(vpos, covered, side="right")) - 1
            e = max(e, 0)
            plain_from = int(starts[np.searchsorted(starts, e, side="right")
                                    - 1])
        dict_vals = (col.values.take(uniq_first)
                     if isinstance(col.values, Strings)
                     else np.asarray(col.values)[uniq_first])
        dict_off = base
        page, u = _page(2, _plain(col.physical, dict_vals),
                        len(uniq_first), _PLAIN)
        pieces.append(page)
        uncompressed += u
        encodings = [_PLAIN, _RLE, _RLE_DICT]
        width = max(1, int(max(len(uniq_first) - 1, 0)).bit_length())
    cuts = list(starts[::max(1, PAGE_ENTRIES)].tolist()) if n_entries else [0]
    cuts = sorted(set([c for c in cuts if c < n_entries] + [plain_from])
                  - {n_entries}) + [n_entries]
    if cuts[0] != 0:
        cuts.insert(0, 0)
    data_off = base + sum(len(p) for p in pieces)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        body = b""
        if col.max_rep:
            body += _levels(col.reps[lo:hi], col.max_rep)
        if col.max_def:
            body += _levels(col.defs[lo:hi], col.max_def)
        v0, v1 = int(vpos[lo]), int(vpos[hi - 1] + full[hi - 1])
        if col.physical == "BOOLEAN" or lo >= plain_from:
            vals = (col.values.take(np.arange(v0, v1))
                    if isinstance(col.values, Strings)
                    else np.asarray(col.values)[v0:v1])
            body += _plain(col.physical, vals)
            enc = _PLAIN
            if _PLAIN not in encodings:
                encodings.append(_PLAIN)
        else:
            body += bytes([width]) + _hybrid(
                codes[v0:v1].astype(np.uint64), width)
            enc = _RLE_DICT
        page, u = _page(0, body, hi - lo, enc)
        pieces.append(page)
        uncompressed += u
    blob = b"".join(pieces)
    return blob, dict(encodings=encodings, num_values=n_entries,
                      uncompressed=uncompressed, compressed=len(blob),
                      data_off=data_off, dict_off=dict_off)


def _schema(t: _Thrift, node: SchemaNode, top: bool = False) -> None:
    t.begin()
    if node.physical is not None:
        t.i32(1, _TYPES[node.physical])
    if node.type_length is not None:
        t.i32(2, node.type_length)
    if not top:
        t.i32(3, node.repetition)
    t.binary(4, node.name.encode())
    if node.children:
        t.i32(5, len(node.children))
    if node.converted is not None:
        t.i32(6, node.converted)
    if node.decimal is not None:
        t.i32(7, node.decimal[1])
        t.i32(8, node.decimal[0])
    logical = node.logical
    if logical is None and node.decimal is not None:
        logical = 5
    if logical is None and node.int_bits is not None:
        logical = 10
    if logical is not None:
        t.begin(10)
        t.begin(logical)
        if logical == 8:  # TimestampType: isAdjustedToUTC, unit
            t.boolean(1, node.timestamp[0])
            t.begin(2)
            t.begin(node.timestamp[1])
            t.end()
            t.end()
        elif logical == 5:  # DecimalType: scale, precision
            t.i32(1, node.decimal[1])
            t.i32(2, node.decimal[0])
        elif logical == 10:  # IntType: bitWidth, isSigned
            t.i8(1, node.int_bits)
            t.boolean(2, True)
        t.end()
        t.end()
    t.end()
    for child in node.children:
        _schema(t, child)


def _count(node: SchemaNode) -> int:
    return 1 + sum(_count(c) for c in node.children)


def write_parquet(schema: SchemaNode, columns: List[LeafColumn],
                  num_rows: int) -> bytes:
    """One Parquet file: `schema` is the root group, `columns` its leaves
    in depth-first order."""
    out = [b"PAR1"]
    pos = 4
    metas = []
    for col in columns:
        blob, meta = _chunk(col, pos)
        out.append(blob)
        metas.append((col, pos, meta))
        pos += len(blob)
    t = _Thrift()
    t.begin()
    t.i32(1, 1)
    t.list(2, 12, _count(schema))
    _schema(t, schema, top=True)
    t.i64(3, num_rows)
    t.list(4, 12, 1)
    t.begin()
    t.list(1, 12, len(metas))
    total = 0
    for col, start, m in metas:
        t.begin()
        t.i64(2, start)
        t.begin(3)
        t.i32(1, _TYPES[col.physical])
        t.list(2, 5, len(m["encodings"]))
        for e in m["encodings"]:
            t._zigzag(e)
        t.list(3, 8, len(col.path))
        for p in col.path:
            t.varint(len(p.encode()))
            t.out += p.encode()
        t.i32(4, _SNAPPY)
        t.i64(5, m["num_values"])
        t.i64(6, m["uncompressed"])
        t.i64(7, m["compressed"])
        t.i64(9, m["data_off"])
        if m["dict_off"] is not None:
            t.i64(11, m["dict_off"])
        t.end()
        t.end()
        total += m["uncompressed"]
    t.i64(2, total)
    t.i64(3, num_rows)
    t.end()
    t.binary(6, b"delta_tpu_torch parquet writer")
    t.end()
    footer = bytes(t.out)
    out += [footer, len(footer).to_bytes(4, "little"), b"PAR1"]
    return b"".join(out)


def primitive_node(name: str, repetition: int, t: str) -> SchemaNode:
    phys, conv, logical, length = parquet_leaf(t)
    node = SchemaNode(name, repetition, physical=phys, converted=conv,
                      type_length=length)
    if logical is None:
        return node
    if logical[0] == "string":
        node.logical = 1
    elif logical[0] == "date":
        node.logical = 6
    elif logical[0] == "timestamp":
        node.logical, node.timestamp = 8, (logical[1], 2)
    elif logical[0] == "int":
        node.int_bits = logical[1]
    else:  # ("decimal", precision, scale)
        node.decimal = logical[1:]
    return node


def physical_values(t: str, values: np.ndarray):
    """The physical values of primitive `t`'s present values (a numpy
    column in `models/batch.py`'s layout)."""
    if t == "string":
        try:
            return Strings.from_list(list(values))
        except ValueError:  # a string holds a NUL byte: encode one by one
            return Strings.from_bytes([v.encode("utf-8") for v in values])
    if t == "binary":
        return Strings.from_bytes([bytes(v) for v in values])
    if t == "date":
        return values.astype("datetime64[D]").astype(np.int64) \
            .astype(np.int32)
    if t in ("timestamp", "timestamp_ntz"):
        return values.astype("datetime64[us]").astype(np.int64)
    phys, _, _, length = parquet_leaf(t)
    if phys == _FLBA:
        return _big_endian(values, length)
    return np.asarray(values, _NP.get(phys, bool))


def _big_endian(values: np.ndarray, length: int) -> np.ndarray:
    """Integers as `length`-byte big-endian two's complement rows."""
    out = np.zeros((len(values), length), np.uint8)
    for i, v in enumerate(values.tolist()):
        out[i] = np.frombuffer(int(v).to_bytes(length, "big", signed=True),
                               np.uint8)
    return out


@dataclass
class _Plan:
    """One node of a nested column's shredding: its kind (struct, list,
    map, leaf), whether it may be null, the rep level of its repeated
    group (list, map), its children and its leaves' index range."""

    kind: str
    nullable: bool
    what: str
    rep: int = 0
    children: Tuple["_Plan", ...] = ()
    names: Tuple[str, ...] = ()
    lo: int = 0
    hi: int = 0


def _plan(name: str, t, nullable: bool, d: int, r: int,
          path: Tuple[str, ...], leaves: list,
          physical: bool = False) -> Tuple[SchemaNode, _Plan]:
    """The schema node and shredding plan of a column of type `t`; each
    primitive leaf goes to `leaves` as (path, type, max def, max rep).
    With `physical`, a struct's fields are named by their physical names
    (column mapping), while the values stay keyed by the logical ones."""
    d += int(nullable)
    repetition = 1 if nullable else 0
    what = ".".join(path)
    lo = len(leaves)
    if isinstance(t, StructType):
        names = [f.physical_name if physical else f.name for f in t.fields]
        kids = [_plan(n, f.data_type, f.nullable, d, r, path + (n,),
                      leaves, physical) for n, f in zip(names, t.fields)]
        node = SchemaNode(name, repetition, tuple(k[0] for k in kids))
        plan = _Plan("struct", nullable, what,
                     children=tuple(k[1] for k in kids),
                     names=tuple(f.name for f in t.fields))
    elif isinstance(t, ArrayType):
        en, ep = _plan("element", t.element_type, t.contains_null, d + 1,
                       r + 1, path + ("list", "element"), leaves, physical)
        node = SchemaNode(name, repetition, (SchemaNode("list", 2, (en,)),),
                          converted=3, logical=3)
        plan = _Plan("list", nullable, what, r + 1, (ep,))
    elif isinstance(t, MapType):
        kn, kp = _plan("key", t.key_type, False, d + 1, r + 1,
                       path + ("key_value", "key"), leaves, physical)
        vn, vp = _plan("value", t.value_type, t.value_contains_null, d + 1,
                       r + 1, path + ("key_value", "value"), leaves,
                       physical)
        node = SchemaNode(name, repetition,
                          (SchemaNode("key_value", 2, (kn, vn)),),
                          converted=1, logical=2)
        plan = _Plan("map", nullable, what, r + 1, (kp, vp))
    else:
        node = primitive_node(name, repetition, t)
        leaves.append((path, t, d, r))
        plan = _Plan("leaf", nullable, what)
    plan.lo, plan.hi = lo, len(leaves)
    return node, plan


def _shred(plan: _Plan, v, d: int, r: int, defs: list, reps: list,
           vals: list) -> None:
    """Append the levels (and present values) of value `v` of `plan`'s
    node, whose parent is defined at level `d`, at repetition level `r`."""
    if v is None:
        if not plan.nullable:
            raise ValueError(f"a null in the non-nullable field {plan.what}")
        for i in range(plan.lo, plan.hi):
            defs[i].append(d)
            reps[i].append(r)
        return
    d += int(plan.nullable)
    kind = plan.kind
    if kind == "leaf":
        defs[plan.lo].append(d)
        reps[plan.lo].append(r)
        vals[plan.lo].append(v)
    elif kind == "struct":
        get = v.get
        for name, child in zip(plan.names, plan.children):
            _shred(child, get(name), d, r, defs, reps, vals)
    else:
        items = list(v.items()) if isinstance(v, dict) else v
        if not len(items):
            for i in range(plan.lo, plan.hi):
                defs[i].append(d)
                reps[i].append(r)
            return
        at = r
        if kind == "list":
            for e in items:
                _shred(plan.children[0], e, d + 1, at, defs, reps, vals)
                at = plan.rep
        else:
            key, value = plan.children
            for k, x in items:
                _shred(key, k, d + 1, at, defs, reps, vals)
                _shred(value, x, d + 1, at, defs, reps, vals)
                at = plan.rep


def _column_leaves(field, col, physical: bool = False
                   ) -> Tuple[SchemaNode, List[LeafColumn]]:
    """The schema node and laid-out leaves of one column (named, at every
    depth, by the physical names with `physical`)."""
    t, n = field.data_type, len(col)
    name = field.physical_name if physical else field.name
    valid = col.valid
    if isinstance(t, str):
        optional = bool(field.nullable)
        values = col.values if valid is None else col.values[valid]
        if optional:
            defs = (np.ones(n, np.int32) if valid is None
                    else valid.astype(np.int32))
        else:
            defs = np.zeros(n, np.int32)
        node = primitive_node(name, 1 if optional else 0, t)
        return node, [LeafColumn((name,), node.physical, defs, None,
                                 int(optional), 0, physical_values(t, values))]
    leaves: list = []
    node, plan = _plan(name, t, field.nullable, 0, 0, (name,), leaves,
                       physical)
    defs = [[] for _ in leaves]
    reps = [[] for _ in leaves]
    vals = [[] for _ in leaves]
    rows = col.values.tolist()
    if valid is not None:
        rows = [v if ok else None for v, ok in zip(rows, valid.tolist())]
    for v in rows:
        _shred(plan, v, 0, 0, defs, reps, vals)
    out = []
    for (path, lt, max_def, max_rep), d, r, v in zip(leaves, defs, reps,
                                                       vals):
        present = column_from_python(v, lt).values
        out.append(LeafColumn(path, parquet_leaf(lt)[0],
                              np.asarray(d, np.int32),
                              np.asarray(r, np.int32) if max_rep else None,
                              max_def, max_rep, physical_values(lt, present)))
    return node, out


def data_file_bytes(batch, schema, physical: bool = False) -> bytes:
    """The bytes of one data file holding `batch`'s columns in `schema`'s
    field order, each field under its physical name with `physical`."""
    nodes, leaves = [], []
    for f in schema.fields:
        node, cols = _column_leaves(f, batch.columns[f.name], physical)
        nodes.append(node)
        leaves.extend(cols)
    root = SchemaNode("schema", 0, tuple(nodes))
    return write_parquet(root, leaves, batch.num_rows)


def write_data_file(path: str, batch, schema,
                    store: Optional[LocalLogStore] = None,
                    physical: bool = False) -> FileStatus:
    """Write one data file at `path` (replacing any file there, through
    a temporary file and a rename) and return its status."""
    store = store or LocalLogStore()
    store.write(path, data_file_bytes(batch, schema, physical),
                overwrite=True)
    return store.file_status(path)

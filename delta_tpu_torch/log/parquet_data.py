"""Data-file reader: a Parquet data file -> named numpy columns.

The port's counterpart of `pq.read_table` in the JAX package's
`HostEngine.read_parquet_files` (`delta_tpu/engine/host.py`), for what a
Delta writer, Spark, Hive or parquet-mr puts in a data file: every row
group; for each leaf, dictionary pages followed by RLE_DICTIONARY data
pages, PLAIN pages, or both (parquet-cpp falls back to PLAIN mid-chunk
once its dictionary passes 1 MiB), or the DELTA_BINARY_PACKED,
DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY, BYTE_STREAM_SPLIT and
RLE-boolean encodings; data page v1 and v2; snappy, ZSTD, GZIP or
uncompressed. Leaves are read by the host leaf reader of the checkpoint
path (`log/parquet_host.py::read_leaf`).

Types (physical type and logical annotation -> numpy, as
`models/batch.py` lays each Delta type out): INT64 -> int64, INT32 ->
int32, INT32 annotated INT(8) or INT(16) signed -> int8 / int16, DOUBLE,
FLOAT, BOOLEAN, BYTE_ARRAY annotated UTF8 -> object array of str,
unannotated BYTE_ARRAY -> object array of bytes, INT32 annotated DATE ->
datetime64[D], INT64 annotated TIMESTAMP (millis, micros or nanos) and
INT96 (Spark's timestamps) -> datetime64[us], floored (a TIMESTAMP not
adjusted to UTC is a `timestamp_ntz` column); DECIMAL on INT32, INT64,
FIXED_LEN_BYTE_ARRAY or BYTE_ARRAY (big-endian two's complement, up to 16
bytes) -> its unscaled integers, int64 up to 18 digits and Python ints
past them, with the `decimal(p,s)` type beside them.

Struct, list and map columns are assembled from their leaves'
repetition and definition levels (record assembly as in the Dremel
paper), at any depth: a struct becomes a dict, a list (the three-level
LIST form) a list, a map (MAP with a repeated `key_value` group) a list
of (key, value) tuples in file order; each element is the Python value
Arrow's `to_pylist` gives. The entry ranges of every node's instances
are found over whole level arrays with numpy; only the values' Python
objects are built per element. Unsigned integers, legacy two-level lists
(a repeated field outside a LIST or MAP group, or a LIST whose repeated
field is a leaf, holds several fields or is named `array` or
`<name>_tuple`), LZ4 and Brotli pages raise `DecodeUnsupported`. Null
rows hold the type's zero.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from delta_tpu_torch.log.parquet_footer import (
    REPEATED,
    REQUIRED,
    DecodeCorrupt,
    DecodeUnsupported,
    Leaf,
    read_footer,
)
from delta_tpu_torch.log.parquet_host import (
    HostLeaf,
    Strings,
    ragged_arange,
    read_leaf,
)
from delta_tpu_torch.models.batch import Batch, Column, zeros
from delta_tpu_torch.models.schema import (
    MAX_INT64_PRECISION,
    ArrayType,
    MapType,
    StructField,
    StructType,
)

_CONVERTED_UTF8 = 0
_CONVERTED_DECIMAL = 5
_CONVERTED_DATE = 6
_CONVERTED_TS_MILLIS = 9
_CONVERTED_TS_MICROS = 10
# converted INT_8, INT_16, INT_32, INT_64 -> (bits, signed); UINT_* below
_CONVERTED_INTS = {15: 8, 16: 16, 17: 32, 18: 64}
_CONVERTED_UINTS = (11, 12, 13, 14)
_LOGICAL_STRING = 1
_LOGICAL_DECIMAL = 5
_LOGICAL_DATE = 6
_LOGICAL_TIMESTAMP = 8
_LOGICAL_INTEGER = 10
# TimeUnit union ids of a TIMESTAMP logical type -> numpy unit
_UNITS = {1: "ms", 2: "us", 3: "ns"}
_INT_KINDS = {8: "byte", 16: "short", 32: "integer", 64: "long"}


def _int_kind(leaf: Leaf, conv, logical: dict, bits: int) -> str:
    """The kind of an INT32 or INT64 leaf annotated as an integer: a
    signed width no wider than the physical type."""
    ints = logical.get(_LOGICAL_INTEGER)
    if ints is not None:
        width, signed = ints.get(1), ints.get(2, True)
    elif conv in _CONVERTED_INTS:
        width, signed = _CONVERTED_INTS[conv], True
    else:
        width, signed = None, conv not in _CONVERTED_UINTS
    if not signed or width not in _INT_KINDS or width > bits:
        raise DecodeUnsupported(f"{leaf.path}: annotated INT{bits} "
                                f"({conv}, {logical})")
    return _INT_KINDS[width]


def _kind(leaf: Leaf) -> str:
    """The numpy kind a leaf reads as: one of long, integer, short, byte,
    double, float, boolean, string, binary, date, decimal,
    timestamp-<unit>, timestamp_ntz-<unit>."""
    phys, conv = leaf.physical_type, leaf.converted_type
    logical = leaf.logical_type or {}
    if conv == _CONVERTED_DECIMAL or _LOGICAL_DECIMAL in logical:
        if phys not in ("INT32", "INT64", "FIXED_LEN_BYTE_ARRAY",
                        "BYTE_ARRAY"):
            raise DecodeUnsupported(f"{leaf.path}: DECIMAL on {phys}")
        p, s = leaf.precision, leaf.scale or 0
        if not p or not 0 < p <= 38 or not 0 <= s <= p:
            raise DecodeUnsupported(f"{leaf.path}: decimal({p},{s})")
        if phys == "FIXED_LEN_BYTE_ARRAY" and not 0 < (
                leaf.type_length or 0) <= 16:
            raise DecodeUnsupported(f"{leaf.path}: a decimal of "
                                    f"{leaf.type_length} bytes")
        return "decimal"
    if phys == "BOOLEAN":
        return "boolean"
    if phys == "FLOAT":
        return "float"
    if phys == "DOUBLE":
        return "double"
    if phys == "BYTE_ARRAY":
        if conv == _CONVERTED_UTF8 or _LOGICAL_STRING in logical:
            return "string"
        if conv is None and not logical:
            return "binary"
        raise DecodeUnsupported(f"{leaf.path}: annotated BYTE_ARRAY "
                                f"({conv}, {logical})")
    if phys == "INT32":
        if conv == _CONVERTED_DATE or _LOGICAL_DATE in logical:
            return "date"
        if conv is not None or logical:
            return _int_kind(leaf, conv, logical, 32)
        return "integer"
    if phys == "INT64":
        if _LOGICAL_TIMESTAMP in logical:
            ts = logical[_LOGICAL_TIMESTAMP]
            unit = ts.get(2) or {}
            zone = "timestamp" if ts.get(1, True) else "timestamp_ntz"
            for uid, name in _UNITS.items():
                if uid in unit:
                    return f"{zone}-{name}"
            raise DecodeUnsupported(f"{leaf.path}: timestamp unit {unit}")
        if conv == _CONVERTED_TS_MILLIS:
            return "timestamp-ms"
        if conv == _CONVERTED_TS_MICROS:
            return "timestamp-us"
        if conv is not None or logical:
            return _int_kind(leaf, conv, logical, 64)
        return "long"
    if phys == "INT96":  # the host reader gives microseconds
        return "timestamp-us"
    raise DecodeUnsupported(f"{leaf.path}: physical type {phys}")


_DTYPES = {"long": np.int64, "integer": np.int32, "short": np.int16,
           "byte": np.int8, "double": np.float64, "float": np.float32,
           "boolean": bool, "date": "datetime64[D]"}


def _big_endian_ints(values: Strings, precision: int) -> np.ndarray:
    """Big-endian two's-complement integers of up to 16 bytes each:
    int64 for a precision of 18 or less, else Python ints."""
    n = len(values)
    lens = values.lens
    if n == 0:
        return np.zeros(0, np.int64 if precision <= MAX_INT64_PRECISION
                        else object)
    if int(lens.max()) > 16:
        raise DecodeCorrupt(f"a decimal of {int(lens.max())} bytes")
    mat = np.zeros((n, 16), np.uint8)
    within = ragged_arange(lens)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    mat[rows, 16 - np.repeat(lens, lens) + within] = values.buf[
        np.repeat(values.starts, lens) + within]
    padded = np.concatenate([values.buf, np.zeros(1, np.uint8)])
    first = padded[np.minimum(values.starts, values.buf.size)]
    neg = (lens > 0) & (first >= 0x80)
    lead = np.arange(16)[None, :] < (16 - lens)[:, None]
    mat[neg[:, None] & lead] = 0xFF  # sign extension
    lo = np.ascontiguousarray(mat[:, 8:]).view(">i8").reshape(-1)
    if precision <= MAX_INT64_PRECISION:
        return lo.astype(np.int64)
    hi = np.ascontiguousarray(mat[:, :8]).view(">i8").reshape(-1)
    out = np.empty(n, object)
    out[:] = [(h << 64) + (v & 0xFFFFFFFFFFFFFFFF)
              for h, v in zip(hi.tolist(), lo.tolist())]
    return out


def _as_numpy(kind: str, leaf: Leaf, values) -> np.ndarray:
    if kind in ("string", "binary"):
        out = np.empty(len(values), object)
        buf = values.buf.tobytes()
        spans = zip(values.starts.tolist(), values.lens.tolist())
        if kind == "binary":
            out[:] = [buf[s:s + ln] for s, ln in spans]
            return out
        try:
            for i, (s, ln) in enumerate(spans):
                out[i] = buf[s:s + ln].decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeCorrupt(f"a UTF8 value is not UTF-8: {e}") from e
        return out
    if kind == "decimal":
        if isinstance(values, Strings):
            return _big_endian_ints(values, leaf.precision)
        out = np.asarray(values, np.int64)
        if leaf.precision > MAX_INT64_PRECISION:
            out = out.astype(object)
        return out
    if kind.startswith(("timestamp-", "timestamp_ntz-")):
        unit = kind.split("-", 1)[1]
        return np.asarray(values, np.int64).astype(
            f"datetime64[{unit}]").astype("datetime64[us]")
    if kind == "date":
        return np.asarray(values, np.int64).astype(np.int32).astype(
            "datetime64[D]")
    return np.asarray(values).astype(_DTYPES[kind], copy=False)


def _leaf_type(kind: str, leaf: Leaf):
    """The Delta type of a leaf's values."""
    if kind == "decimal":
        return f"decimal({leaf.precision},{leaf.scale or 0})"
    return kind.split("-", 1)[0]


def _data_type(kind: str, leaf: Leaf):
    """A flat column's `Column.data_type`: None where the dtype says the
    type."""
    t = _leaf_type(kind, leaf)
    return t if t in ("binary", "timestamp_ntz") or kind == "decimal" \
        else None


def _flat_column(leaf: Leaf, kind: str, hl: HostLeaf, num_rows: int
                 ) -> Column:
    n = hl.defs.shape[0]
    if n != num_rows:  # a flat leaf has one entry per row
        raise DecodeCorrupt(
            f"{leaf.path}: {n} level entries for {num_rows} rows")
    present = _as_numpy(kind, leaf, hl.values)
    dt = _data_type(kind, leaf)
    if leaf.max_definition_level == 0:
        return Column(present, None, dt)
    valid = hl.defs == leaf.max_definition_level
    if bool(valid.all()):
        return Column(present, None, dt)
    full = zeros(present.dtype, n, dt)
    full[valid] = present
    return Column(full, valid, dt)


# ------------------------------------------------------ record assembly --

class _Node:
    """One element of a column's Parquet schema tree."""

    def __init__(self, name: str, repetition: int,
                 annotation: Optional[str], def_at: int, rep_at: int):
        self.name = name
        self.repetition = repetition
        self.annotation = annotation
        self.def_at = def_at
        self.rep_at = rep_at
        self.children: List["_Node"] = []
        self.leaf: Optional[int] = None  # the footer's leaf index

    def leaves(self) -> List[int]:
        if self.leaf is not None:
            return [self.leaf]
        return [i for c in self.children for i in c.leaves()]


def _tree(footer, cols: List[int]) -> _Node:
    """The schema tree of one top-level column from its leaves."""
    nodes: Dict[tuple, _Node] = {}
    root = None
    for i in cols:
        leaf = footer.leaves[i]
        for k in range(len(leaf.parts)):
            key = leaf.parts[:k + 1]
            node = nodes.get(key)
            if node is None:
                node = nodes[key] = _Node(
                    leaf.parts[k], leaf.repetition[k],
                    leaf.annotation[k], leaf.def_at[k], leaf.rep_at[k])
                if k:
                    nodes[leaf.parts[:k]].children.append(node)
                else:
                    root = node
        nodes[leaf.parts].leaf = i
    return root


# an instance set: per leaf index, the [start, end) entry ranges of each
# instance of a node
_Ranges = Dict[int, Tuple[np.ndarray, np.ndarray]]


class _Assembler:
    def __init__(self, footer, leaves: Dict[int, HostLeaf], kinds):
        self.footer = footer
        self.host = leaves
        self.kinds = kinds
        self._python: Dict[int, list] = {}

    def python_values(self, i: int) -> list:
        """The Python values of leaf i's present values."""
        if i not in self._python:
            leaf = self.footer.leaves[i]
            kind = self.kinds[i]
            arr = _as_numpy(kind, leaf, self.host[i].values)
            self._python[i] = Column(arr, None, _data_type(kind, leaf)) \
                .to_python()
        return self._python[i]

    def build(self, node: _Node, inst: _Ranges) -> list:
        """The Python value of each instance of `node`, None where null."""
        some = node.leaves()[0]
        first = inst[some][0]
        if node.leaf is not None:
            vi = self.host[node.leaf].value_index[first].tolist()
            vals = self.python_values(node.leaf)
            return [vals[j] if j >= 0 else None for j in vi]
        present = (self.host[some].defs[first] >= node.def_at).tolist()
        if node.annotation in ("LIST", "MAP"):
            return self._repeated(node, inst, present)
        if node.repetition == REPEATED:
            raise DecodeUnsupported(f"{node.name}: a repeated field outside "
                                    f"a LIST or MAP (a legacy list form)")
        kids = [(c.name, self.build(c, {i: inst[i] for i in c.leaves()}))
                for c in node.children]
        names = [n for n, _ in kids]
        return [dict(zip(names, vals)) if ok else None
                for ok, vals in zip(present, zip(*[v for _, v in kids]))]

    def _repeated(self, node: _Node, inst: _Ranges, present: list) -> list:
        if len(node.children) != 1 or node.children[0].repetition \
                != REPEATED:
            raise DecodeUnsupported(f"{node.name}: a {node.annotation} "
                                    f"without one repeated field")
        rep = node.children[0]
        if node.annotation == "LIST" and (
                rep.leaf is not None or len(rep.children) != 1
                or rep.name in ("array", f"{node.name}_tuple")):
            raise DecodeUnsupported(f"{node.name}: a legacy two-level list")
        if node.annotation == "MAP" and (
                rep.leaf is not None or len(rep.children) != 2):
            raise DecodeUnsupported(f"{node.name}: a map without a key and "
                                    f"a value")
        some = rep.leaves()[0]
        full = self.host[some].defs[inst[some][0]] >= rep.def_at
        idx = np.flatnonzero(full)
        elems: _Ranges = {}
        counts = None
        for i in rep.leaves():
            s, e = inst[i][0][idx], inst[i][1][idx]
            reps = self.host[i].reps
            starts = np.sort(np.concatenate(
                [s, np.flatnonzero(reps == rep.rep_at)]))
            n = (np.searchsorted(starts, e) - np.searchsorted(starts, s))
            if counts is None:
                counts = n
            elif not np.array_equal(counts, n):
                raise DecodeCorrupt(f"{node.name}: its leaves disagree on "
                                    f"the element counts")
            ends = np.empty_like(starts)
            ends[:-1] = starts[1:]
            if len(starts):
                ends[np.cumsum(n) - 1] = e  # each container's last element
            elems[i] = (starts, ends)
        if node.annotation == "LIST":
            values = self.build(rep.children[0], elems)
        else:  # (key, value) pairs
            values = list(zip(*[self.build(c, {i: elems[i] for i in
                                               c.leaves()})
                                for c in rep.children]))
        out = [[] if ok else None for ok in present]
        ends = np.cumsum(counts).tolist()
        for j, lo, hi in zip(idx.tolist(), [0] + ends[:-1], ends):
            out[j] = values[lo:hi]
        return out


def _delta_type(node: _Node, kinds, footer):
    """The Delta type of a node's values."""
    if node.leaf is not None:
        return _leaf_type(kinds[node.leaf], footer.leaves[node.leaf])
    if node.annotation == "LIST":
        return ArrayType(_delta_type(node.children[0].children[0], kinds,
                                     footer))
    if node.annotation == "MAP":
        key, value = node.children[0].children
        return MapType(_delta_type(key, kinds, footer),
                       _delta_type(value, kinds, footer))
    return StructType([StructField(c.name, _delta_type(c, kinds, footer),
                                   c.repetition != REQUIRED)
                       for c in node.children])


def _nested_column(footer, data: bytes, cols: List[int]) -> Column:
    root = _tree(footer, cols)
    kinds = {i: _kind(footer.leaves[i]) for i in cols}
    host = {i: read_leaf(footer, data, i, nested=True) for i in cols}
    inst: _Ranges = {}
    for i in cols:
        starts = host[i].row_starts
        if starts.shape[0] - 1 != footer.num_rows:
            raise DecodeCorrupt(f"{footer.leaves[i].path}: "
                                f"{starts.shape[0] - 1} rows of "
                                f"{footer.num_rows}")
        inst[i] = (starts[:-1], starts[1:])
    values = _Assembler(footer, host, kinds).build(root, inst)
    out = np.empty(len(values), object)
    out[:] = values
    valid = np.fromiter((v is not None for v in values), bool, len(values))
    return Column(out, None if bool(valid.all()) else valid,
                  _delta_type(root, kinds, footer))


def read_data_file(data: bytes, columns=None) -> Batch:
    """The columns of a data file, in file order: every column, or those
    named in `columns` that the file has (the counterpart of
    `read_parquet_files(columns=)`; the other leaves are not decoded)."""
    footer = read_footer(data)
    wanted = None if columns is None else set(columns)
    groups: Dict[str, List[int]] = {}
    for i, leaf in enumerate(footer.leaves):
        if wanted is None or leaf.parts[0] in wanted:
            groups.setdefault(leaf.parts[0], []).append(i)
    cols = {}
    for name, idx in groups.items():
        leaf = footer.leaves[idx[0]]
        if len(idx) == 1 and len(leaf.parts) == 1 \
                and not leaf.max_repetition_level:
            kind = _kind(leaf)
            cols[name] = _flat_column(leaf, kind,
                                      read_leaf(footer, data, idx[0]),
                                      footer.num_rows)
        else:
            cols[name] = _nested_column(footer, data, idx)
    return Batch(cols, footer.num_rows)


def read_data_file_path(path: str, columns=None) -> Batch:
    with open(path, "rb") as f:
        return read_data_file(f.read(), columns)

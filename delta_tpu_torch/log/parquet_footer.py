"""Parquet footers: the counterpart of what `pq.ParquetFile(...).metadata`
gives the JAX package's checkpoint reader.

A Parquet file ends with its FileMetaData (thrift compact protocol), a
4-byte length and `PAR1`. `read_footer` parses it into the schema's
leaves (dotted path, physical type, maximum definition and repetition
levels, the level each path element reaches, each element's repetition
and LIST / MAP annotation, and the leaf's width, decimal scale and
precision and annotations) and each row group's column chunks (codec,
encodings, page offsets, sizes, statistics). `_Thrift` is a
copy of the reader in `delta_tpu/log/page_decode.py`, which the page
splitter also uses for PageHeaders.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class DecodeUnsupported(Exception):
    """A file, page or encoding outside what this reader decodes (an LZ4
    or Brotli codec, a ZSTD dictionary, an encoding, a repeated or nested
    column; data page v2 for the device plan): the bytes may be sound;
    this reader does not read them."""


class DecodeCorrupt(Exception):
    """Bytes that no sound Parquet file holds: no PAR1 magic, a bad footer
    length or footer, a column chunk past the file, a level or index
    stream that ends early, values past their page, a broken dictionary
    or a broken snappy, ZSTD or GZIP stream. Deliberately
    not a DecodeUnsupported: a caller that routes an out-of-scope part to
    another reader must not route damage there."""


_CT_STOP = 0
_CT_TRUE = 1
_CT_FALSE = 2
_CT_BYTE = 3
_CT_I16 = 4
_CT_I32 = 5
_CT_I64 = 6
_CT_DOUBLE = 7
_CT_BINARY = 8
_CT_LIST = 9
_CT_SET = 10
_CT_MAP = 11
_CT_STRUCT = 12


class _Thrift:
    """Minimal thrift compact-protocol reader: varints, zigzag ints,
    struct field iteration, lists, maps; every struct becomes a dict of
    field id -> value. A read past the buffer's end, or nesting deeper
    than any Parquet struct, raises DecodeCorrupt; `thrift_field` checks the
    type of what a caller takes out."""

    _MAX_DEPTH = 32

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos
        self._depth = 0

    def _take(self, n: int) -> int:
        """Advance past `n` bytes, returning where they start."""
        at = self.pos
        if n < 0 or at + n > len(self.buf):
            raise DecodeCorrupt(f"thrift stream ends inside a value "
                                f"({at} + {n} of {len(self.buf)} bytes)")
        self.pos = at + n
        return at

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.buf[self._take(1)]
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_struct(self) -> dict:
        self._depth += 1
        if self._depth > self._MAX_DEPTH:
            raise DecodeCorrupt("thrift structs nested past any Parquet "
                                "struct")
        out = {}
        fid = 0
        while True:
            head = self.buf[self._take(1)]
            if head == _CT_STOP:
                self._depth -= 1
                return out
            delta = head >> 4
            ctype = head & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self._read_value(ctype)

    def _read_value(self, ctype: int, in_list: bool = False):
        if ctype in (_CT_TRUE, _CT_FALSE):
            if in_list:  # a list element carries its bool in a byte
                return self.buf[self._take(1)] == _CT_TRUE
            return ctype == _CT_TRUE
        if ctype == _CT_BYTE:
            return self.buf[self._take(1)]
        if ctype in (_CT_I16, _CT_I32, _CT_I64):
            return self.zigzag()
        if ctype == _CT_DOUBLE:
            return struct.unpack_from("<d", self.buf, self._take(8))[0]
        if ctype == _CT_BINARY:
            n = self.varint()
            at = self._take(n)
            return self.buf[at:at + n]
        if ctype == _CT_STRUCT:
            return self.read_struct()
        if ctype in (_CT_LIST, _CT_SET):
            head = self.buf[self._take(1)]
            size = head >> 4
            elem = head & 0x0F
            if size == 15:
                size = self.varint()
            return [self._read_value(elem, True) for _ in range(size)]
        if ctype == _CT_MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self.buf[self._take(1)]
            kt, vt = kv >> 4, kv & 0x0F
            if kt in (_CT_LIST, _CT_SET, _CT_MAP, _CT_STRUCT):
                raise DecodeCorrupt(f"thrift map keyed by type {kt}")
            return {self._read_value(kt, True): self._read_value(vt, True)
                    for _ in range(size)}
        raise DecodeCorrupt(f"thrift type {ctype}")


def thrift_field(st: dict, fid: int, kind: type, default=None):
    """Field `fid` of a thrift struct, checked to be a `kind` (int, bytes,
    list or dict; a bool is no int here); absent gives `default`. Bytes
    of the wrong shape decode to a value of another type: DecodeCorrupt."""
    v = st.get(fid, default)
    if v is not default and type(v) is not kind:
        raise DecodeCorrupt(f"thrift field {fid} holds a "
                            f"{type(v).__name__} where a {kind.__name__} "
                            f"belongs")
    return v


def _utf8(b: bytes) -> str:
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeCorrupt(f"a schema name is not UTF-8: {e}") from e


PHYSICAL_TYPES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96",
                  4: "FLOAT", 5: "DOUBLE", 6: "BYTE_ARRAY",
                  7: "FIXED_LEN_BYTE_ARRAY"}
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI",
          5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
# ConvertedType and LogicalType ids of a group's annotation
_GROUP_CONVERTED = {1: "MAP", 2: "MAP_KEY_VALUE", 3: "LIST"}
_GROUP_LOGICAL = {2: "MAP", 3: "LIST"}
_LOGICAL_DECIMAL = 5


def _annotation(el: dict) -> Optional[str]:
    """LIST, MAP or MAP_KEY_VALUE where a group element says so."""
    logical = thrift_field(el, 10, dict) or {}
    for lid, name in _GROUP_LOGICAL.items():
        if lid in logical:
            return name
    return _GROUP_CONVERTED.get(thrift_field(el, 6, int))


@dataclass(frozen=True)
class Leaf:
    """One leaf column of the schema. `def_at[k]` / `rep_at[k]` are the
    definition / repetition levels reached when path element k is
    present; the last entries are the maxima."""

    path: str
    parts: Tuple[str, ...]
    physical_type: str
    def_at: Tuple[int, ...]
    rep_at: Tuple[int, ...]
    converted_type: Optional[int] = None  # SchemaElement field 6
    logical_type: Optional[dict] = field(  # field 10: {union id: struct}
        default=None, compare=False, hash=False)
    type_length: Optional[int] = None  # field 2 (FIXED_LEN_BYTE_ARRAY)
    scale: Optional[int] = None        # fields 7 and 8, or the DECIMAL
    precision: Optional[int] = None    # logical type's
    # per path element: its repetition and its group annotation
    repetition: Tuple[int, ...] = ()
    annotation: Tuple[Optional[str], ...] = ()

    @property
    def max_definition_level(self) -> int:
        return self.def_at[-1]

    @property
    def max_repetition_level(self) -> int:
        return self.rep_at[-1]


@dataclass(frozen=True)
class ColumnChunk:
    path: str
    codec: str
    encodings: Tuple[str, ...]
    num_values: int
    data_page_offset: int
    dictionary_page_offset: Optional[int]
    total_compressed_size: int
    total_uncompressed_size: int
    # ColumnMetaData's Statistics (field 12) as read: {field id: value}
    statistics: Optional[dict] = field(default=None, compare=False,
                                       hash=False)

    @property
    def start(self) -> int:
        """Offset of the chunk's first page (the dictionary page, if any;
        a chunk of no rows may have a dictionary page and no data page,
        whose offset then reads 0)."""
        offsets = [o for o in (self.data_page_offset,
                               self.dictionary_page_offset)
                   if o is not None and o >= 4]
        return min(offsets) if offsets else self.data_page_offset


@dataclass(frozen=True)
class RowGroup:
    num_rows: int
    columns: Tuple[ColumnChunk, ...]


@dataclass(frozen=True)
class Footer:
    leaves: Tuple[Leaf, ...]
    row_groups: Tuple[RowGroup, ...]
    num_rows: int
    created_by: Optional[str]
    index: Dict[str, int]  # leaf path -> leaf index

    def chunk(self, data: bytes, rg: int, col: int) -> Tuple[bytes, str]:
        """(the column chunk's bytes, its codec)."""
        c = self.row_groups[rg].columns[col]
        if not 0 <= c.start <= c.start + c.total_compressed_size <= len(data):
            raise DecodeCorrupt(f"column chunk {c.path} lies past the file "
                                f"({c.start} + {c.total_compressed_size} of "
                                f"{len(data)} bytes)")
        return data[c.start:c.start + c.total_compressed_size], c.codec


def _schema_leaves(elements: List[dict]) -> List[Leaf]:
    """Depth-first walk of the flattened SchemaElement list (element 0 is
    the root and does not count toward the levels)."""
    if not elements or not all(type(el) is dict for el in elements):
        raise DecodeCorrupt("schema is not a list of SchemaElements")
    leaves: List[Leaf] = []
    pos = 1

    def walk(n_children: int, parts, defs, reps, kinds, notes):
        nonlocal pos
        for _ in range(n_children):
            if pos >= len(elements):
                raise DecodeCorrupt(f"schema claims children past its "
                                    f"{len(elements)} elements")
            el = elements[pos]
            pos += 1
            name = _utf8(thrift_field(el, 4, bytes, b""))
            rep = thrift_field(el, 3, int, REQUIRED)
            d = (defs[-1] if defs else 0) + (rep != REQUIRED)
            r = (reps[-1] if reps else 0) + (rep == REPEATED)
            p, dd, rr = parts + (name,), defs + (d,), reps + (r,)
            kk = kinds + (rep,)
            kids = thrift_field(el, 5, int, 0)
            if kids:
                walk(kids, p, dd, rr, kk, notes + (_annotation(el),))
                continue
            phys = thrift_field(el, 1, int)
            if phys not in PHYSICAL_TYPES:
                raise DecodeCorrupt(f"physical type id {phys!r}")
            logical = thrift_field(el, 10, dict)
            dec = (logical or {}).get(_LOGICAL_DECIMAL)
            scale = thrift_field(el, 7, int)
            precision = thrift_field(el, 8, int)
            if type(dec) is dict:
                scale = thrift_field(dec, 1, int, scale)
                precision = thrift_field(dec, 2, int, precision)
            leaves.append(Leaf(
                ".".join(p), p, PHYSICAL_TYPES[phys], dd, rr,
                thrift_field(el, 6, int), logical,
                thrift_field(el, 2, int), scale, precision, kk,
                notes + (None,)))

    walk(thrift_field(elements[0], 5, int, 0), (), (), (), (), ())
    return leaves


def read_footer(data: bytes) -> Footer:
    """Parse a whole Parquet file's footer. Raises DecodeCorrupt when the
    bytes are not a sound Parquet file, DecodeUnsupported when a column
    chunk keeps its metadata elsewhere."""
    n = len(data)
    if n < 12 or data[-4:] != b"PAR1" or data[:4] != b"PAR1":
        raise DecodeCorrupt("not a Parquet file (no PAR1 magic)")
    (flen,) = struct.unpack_from("<I", data, n - 8)
    if flen <= 0 or flen > n - 12:
        raise DecodeCorrupt(f"bad footer length {flen}")
    md = _Thrift(data, n - 8 - flen).read_struct()
    if not all(k in md for k in (1, 2, 3, 4)):
        # version, schema, num_rows and row_groups are required
        raise DecodeCorrupt("footer lacks FileMetaData's required fields")
    leaves = _schema_leaves(thrift_field(md, 2, list))
    groups = []
    for rg in thrift_field(md, 4, list):
        if type(rg) is not dict:
            raise DecodeCorrupt("a row group is not a struct")
        cols = []
        for cc in thrift_field(rg, 1, list, []):
            if type(cc) is not dict:
                raise DecodeCorrupt("a column chunk is not a struct")
            cm = thrift_field(cc, 3, dict)
            if cm is None and 1 in cc:
                raise DecodeUnsupported("column chunk kept in another file")
            if cm is None:
                raise DecodeCorrupt("column chunk without metadata")
            codec = thrift_field(cm, 4, int, 0)
            if codec not in CODECS:
                raise DecodeCorrupt(f"codec id {codec!r}")
            path = thrift_field(cm, 3, list, [])
            encodings = thrift_field(cm, 2, list, [])
            if not all(type(p) is bytes for p in path) or not all(
                    type(e) is int for e in encodings):
                raise DecodeCorrupt("column chunk path or encodings of "
                                    "the wrong type")
            cols.append(ColumnChunk(
                path=".".join(_utf8(p) for p in path),
                codec=CODECS[codec],
                encodings=tuple(ENCODINGS.get(e, f"enc{e}")
                                for e in encodings),
                num_values=thrift_field(cm, 5, int, 0),
                data_page_offset=thrift_field(cm, 9, int, 0),
                dictionary_page_offset=thrift_field(cm, 11, int),
                total_compressed_size=thrift_field(cm, 7, int, 0),
                total_uncompressed_size=thrift_field(cm, 6, int, 0),
                statistics=thrift_field(cm, 12, dict)))
        if len(cols) != len(leaves):
            raise DecodeCorrupt("row group does not cover the schema")
        groups.append(RowGroup(thrift_field(rg, 3, int, 0), tuple(cols)))
    num_rows = thrift_field(md, 3, int)
    if num_rows != sum(g.num_rows for g in groups):
        raise DecodeCorrupt(f"footer counts {num_rows} rows, its row groups "
                            f"{sum(g.num_rows for g in groups)}")
    created = thrift_field(md, 6, bytes)
    created = created.decode("utf-8", "replace") if created else None
    return Footer(tuple(leaves), tuple(groups), num_rows, created,
                  {leaf.path: i for i, leaf in enumerate(leaves)})

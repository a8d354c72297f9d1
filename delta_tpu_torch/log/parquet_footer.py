"""Parquet footers: the counterpart of what `pq.ParquetFile(...).metadata`
gives the JAX package's checkpoint reader.

A Parquet file ends with its FileMetaData (thrift compact protocol), a
4-byte length and `PAR1`. `read_footer` parses it into the schema's
leaves (dotted path, physical type, maximum definition and repetition
levels, and the level each path element reaches) and each row group's
column chunks (codec, encodings, page offsets, sizes). `_Thrift` is a
copy of the reader in `delta_tpu/log/page_decode.py`, which the page
splitter also uses for PageHeaders.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class DecodeUnsupported(Exception):
    """A file, page or encoding outside what this reader decodes."""


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
    field id -> value."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_struct(self) -> dict:
        out = {}
        fid = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == _CT_STOP:
                return out
            delta = head >> 4
            ctype = head & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self._read_value(ctype)

    def _read_value(self, ctype: int, in_list: bool = False):
        if ctype in (_CT_TRUE, _CT_FALSE):
            if in_list:  # a list element carries its bool in a byte
                v = self.buf[self.pos]
                self.pos += 1
                return v == _CT_TRUE
            return ctype == _CT_TRUE
        if ctype == _CT_BYTE:
            v = self.buf[self.pos]
            self.pos += 1
            return v
        if ctype in (_CT_I16, _CT_I32, _CT_I64):
            return self.zigzag()
        if ctype == _CT_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ctype == _CT_BINARY:
            n = self.varint()
            v = self.buf[self.pos:self.pos + n]
            self.pos += n
            return v
        if ctype == _CT_STRUCT:
            return self.read_struct()
        if ctype in (_CT_LIST, _CT_SET):
            head = self.buf[self.pos]
            self.pos += 1
            size = head >> 4
            elem = head & 0x0F
            if size == 15:
                size = self.varint()
            return [self._read_value(elem, True) for _ in range(size)]
        if ctype == _CT_MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            kt, vt = kv >> 4, kv & 0x0F
            return {self._read_value(kt, True): self._read_value(vt, True)
                    for _ in range(size)}
        raise DecodeUnsupported(f"thrift type {ctype}")


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
        return data[c.start:c.start + c.total_compressed_size], c.codec


def _schema_leaves(elements: List[dict]) -> List[Leaf]:
    """Depth-first walk of the flattened SchemaElement list (element 0 is
    the root and does not count toward the levels)."""
    leaves: List[Leaf] = []
    pos = 1

    def walk(n_children: int, parts, defs, reps):
        nonlocal pos
        for _ in range(n_children):
            el = elements[pos]
            pos += 1
            name = el.get(4, b"").decode("utf-8")
            rep = el.get(3, REQUIRED)
            d = (defs[-1] if defs else 0) + (rep != REQUIRED)
            r = (reps[-1] if reps else 0) + (rep == REPEATED)
            p, dd, rr = parts + (name,), defs + (d,), reps + (r,)
            kids = el.get(5, 0)
            if kids:
                walk(kids, p, dd, rr)
            else:
                leaves.append(Leaf(".".join(p), p,
                                   PHYSICAL_TYPES.get(el.get(1), "UNKNOWN"),
                                   dd, rr, el.get(6), el.get(10)))

    walk(elements[0].get(5, 0), (), (), ())
    return leaves


def read_footer(data: bytes) -> Footer:
    """Parse a whole Parquet file's footer. Raises DecodeUnsupported when
    the bytes are not a plain (unencrypted) Parquet file."""
    n = len(data)
    if n < 12 or data[-4:] != b"PAR1" or data[:4] != b"PAR1":
        raise DecodeUnsupported("not a Parquet file (no PAR1 magic)")
    (flen,) = struct.unpack_from("<I", data, n - 8)
    if flen <= 0 or flen > n - 12:
        raise DecodeUnsupported(f"bad footer length {flen}")
    try:
        md = _Thrift(data, n - 8 - flen).read_struct()
        leaves = _schema_leaves(md.get(2) or [{}])
        groups = []
        for rg in md.get(4) or []:
            cols = []
            for cc in rg.get(1) or []:
                cm = cc.get(3)
                if cm is None:
                    raise DecodeUnsupported("column chunk without metadata")
                cols.append(ColumnChunk(
                    path=".".join(p.decode("utf-8") for p in cm.get(3, [])),
                    codec=CODECS.get(cm.get(4, 0), f"codec{cm.get(4)}"),
                    encodings=tuple(ENCODINGS.get(e, f"enc{e}")
                                    for e in cm.get(2, [])),
                    num_values=cm.get(5, 0),
                    data_page_offset=cm.get(9, 0),
                    dictionary_page_offset=cm.get(11),
                    total_compressed_size=cm.get(7, 0),
                    total_uncompressed_size=cm.get(6, 0)))
            if len(cols) != len(leaves):
                raise DecodeUnsupported("row group does not cover the schema")
            groups.append(RowGroup(rg.get(3, 0), tuple(cols)))
    except (IndexError, struct.error, UnicodeDecodeError) as e:
        raise DecodeUnsupported(f"corrupt footer: {e}") from e
    created = md.get(6)
    return Footer(tuple(leaves), tuple(groups), md.get(3, 0),
                  created.decode("utf-8", "replace") if created else None,
                  {leaf.path: i for i, leaf in enumerate(leaves)})

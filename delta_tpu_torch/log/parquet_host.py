"""Host leaf reader: the counterpart of Arrow's `pf.read(columns=rest)` in
the JAX package's checkpoint reader (`delta_tpu/log/page_decode.py:731`).

It reads the checkpoint leaves that the device decode does not plan:
stats strings, the `partitionValues` / `tags` maps, deletion-vector
structs, and the protocol, metaData, txn and domainMetadata rows. Scope:

- flat leaves at any struct depth, and maps and lists with ONE repetition
  level (`partitionValues`, `tags`, `format.options`, `configuration`,
  `partitionColumns`, `readerFeatures`, `writerFeatures`);
- INT32, INT64, INT96, BOOLEAN, FLOAT, DOUBLE, BYTE_ARRAY and
  FIXED_LEN_BYTE_ARRAY, PLAIN or dictionary-coded, including a chunk whose dictionary pages are followed
  by PLAIN pages (a writer's fallback once the dictionary passes its size
  limit); and the encodings of parquet-mr's v2 writer and of Arrow's
  `column_encoding=`: DELTA_BINARY_PACKED (INT32, INT64),
  DELTA_LENGTH_BYTE_ARRAY (BYTE_ARRAY), DELTA_BYTE_ARRAY (BYTE_ARRAY and
  FIXED_LEN_BYTE_ARRAY), BYTE_STREAM_SPLIT (FLOAT, DOUBLE, INT32, INT64,
  FIXED_LEN_BYTE_ARRAY) and RLE (BOOLEAN);
- data page v1 and v2, in any codec of `page_decode.py::decompress`
  (SNAPPY, ZSTD, GZIP or uncompressed).

INT96 values (nanoseconds of the day, then the Julian day) read as int64
microseconds since the epoch, floored as Spark floors them. Definition
and repetition levels decode through `materialize_runs`; the PLAIN
BYTE_ARRAY walk and the DELTA_BYTE_ARRAY prefix chain run in the host
library (`csrc/parquet_host.cpp`). Anything else (LZ4, LZ4_RAW, BROTLI
pages) raises DecodeUnsupported; damaged bytes raise DecodeCorrupt.
Byte strings, fixed-width ones too, stay as (buffer, starts, lengths)
until a caller materializes a row.

The row read (`log/parquet_data.py`) also takes leaves at any
repetition depth (`read_leaf(..., nested=True)`); the checkpoint path
refuses past one level, as it always has.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Sequence

import numpy as np

from delta_tpu_torch.log.page_decode import (
    _ENC_PLAIN,
    _ENC_PLAIN_DICT,
    _ENC_RLE,
    _ENC_RLE_DICT,
    _PAGE_DATA,
    _PAGE_DATA_V2,
    _PAGE_DICT,
    decompress_page,
    level_stream_length,
    materialize_runs,
    parse_hybrid,
    split_pages,
)
from delta_tpu_torch.log.parquet_footer import (
    DecodeCorrupt,
    DecodeUnsupported,
    Footer,
    Leaf,
    _Thrift,
)
from delta_tpu_torch.ops import cuda_build

_FIXED = {"INT32": np.int32, "INT64": np.int64, "FLOAT": np.float32,
          "DOUBLE": np.float64}
_ENC_DELTA_BINARY_PACKED = 5
_ENC_DELTA_LENGTH_BYTE_ARRAY = 6
_ENC_DELTA_BYTE_ARRAY = 7
_ENC_BYTE_STREAM_SPLIT = 9
_JULIAN_EPOCH = 2440588  # the Julian day of 1970-01-01
_US_PER_DAY = 86_400_000_000


def byte_array_offsets(buf: np.ndarray, start: int, count: int):
    """(starts, lens, end) of `count` PLAIN BYTE_ARRAY values in `buf`
    from `start`; raises DecodeCorrupt when the buffer ends early."""
    buf = np.ascontiguousarray(buf, np.uint8)
    starts = np.empty(count, np.int64)
    lens = np.empty(count, np.int64)
    fn = cuda_build.function(
        "parquet_host", "byte_array_offsets",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
        restype=ctypes.c_longlong)
    end = fn(buf.ctypes.data, buf.size, start, count, starts.ctypes.data,
             lens.ctypes.data)
    if end < 0:
        raise DecodeCorrupt("corrupt PLAIN BYTE_ARRAY values")
    return starts, lens, int(end)


def ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    offs = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(offs, lens)


@dataclass
class Strings:
    """Byte strings as spans of one buffer."""

    buf: np.ndarray     # uint8
    starts: np.ndarray  # int64
    lens: np.ndarray    # int64

    def __len__(self) -> int:
        return int(self.starts.shape[0])

    def take(self, idx: np.ndarray) -> "Strings":
        return Strings(self.buf, self.starts[idx], self.lens[idx])

    def raw(self, i: int) -> bytes:
        s = int(self.starts[i])
        return self.buf[s:s + int(self.lens[i])].tobytes()

    def matrix(self, width: Optional[int] = None):
        """(uint8 [n, width] zero-padded rows, lengths); width a multiple
        of 8, at least the longest string."""
        n = len(self)
        longest = int(self.lens.max()) if n else 0
        width = width or max(8, -(-longest // 8) * 8)
        mat = np.zeros((n, width), np.uint8)
        within = ragged_arange(self.lens)
        rows = np.repeat(np.arange(n, dtype=np.int64), self.lens)
        mat[rows, within] = self.buf[np.repeat(self.starts, self.lens)
                                     + within]
        return mat, self.lens.copy()

    @staticmethod
    def concat(parts: Sequence["Strings"]) -> "Strings":
        if len(parts) == 1:
            return parts[0]
        bufs, starts, base = [], [], 0
        seen: Dict[int, int] = {}
        for p in parts:
            key = id(p.buf)
            if key not in seen:  # a shared dictionary buffer goes in once
                seen[key] = base
                bufs.append(p.buf)
                base += p.buf.size
            starts.append(p.starts + seen[key])
        buf = np.concatenate(bufs) if bufs else np.zeros(0, np.uint8)
        return Strings(buf, np.concatenate(starts),
                       np.concatenate([p.lens for p in parts]))

    @staticmethod
    def from_bytes(values: Sequence[bytes]) -> "Strings":
        lens = np.fromiter((len(v) for v in values), np.int64, len(values))
        starts = np.cumsum(lens) - lens
        buf = np.frombuffer(b"".join(values), np.uint8)
        return Strings(buf, starts.astype(np.int64), lens)

    @staticmethod
    def from_list(values: Sequence[str]) -> "Strings":
        """UTF-8 spans of Python strings, with no per-string encode: the
        strings are joined around a NUL separator, encoded once, and split
        at the separators' byte positions (strings hold no NUL)."""
        n = len(values)
        if n == 0:
            return Strings(np.zeros(0, np.uint8), np.zeros(0, np.int64),
                           np.zeros(0, np.int64))
        buf = np.frombuffer(("\x00".join(values) + "\x00").encode("utf-8"),
                            np.uint8)
        ends = np.flatnonzero(buf == 0)
        if ends.shape[0] != n:
            raise ValueError("a string holds a NUL byte")
        starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
        return Strings(buf, starts, (ends - starts).astype(np.int64))


@dataclass
class HostLeaf:
    """One leaf's levels and present values, over every row group.
    `defs` / `reps` have one entry per level entry (one per row for a
    non-repeated leaf); `values` holds the values at the full definition
    level, in entry order."""

    leaf: Leaf
    defs: np.ndarray
    reps: Optional[np.ndarray]
    values: object  # numpy array, or Strings for BYTE_ARRAY

    @cached_property
    def value_index(self) -> np.ndarray:
        """Per entry: index into `values`, or -1 where the value is null."""
        full = self.defs == self.leaf.max_definition_level
        return np.where(full, np.cumsum(full) - 1, -1)

    @cached_property
    def row_starts(self) -> np.ndarray:
        """Entry index of each row's first entry, plus the end."""
        if self.reps is None:
            return np.arange(self.defs.shape[0] + 1, dtype=np.int64)
        return np.concatenate([np.flatnonzero(self.reps == 0),
                               [self.reps.shape[0]]]).astype(np.int64)

    @property
    def n_rows(self) -> int:
        return int(self.row_starts.shape[0] - 1)

    def level(self, rows=None) -> np.ndarray:
        """Definition level of each row's first entry."""
        first = self.row_starts[:-1]
        return self.defs[first if rows is None else first[rows]]

    def present(self, depth: int, rows=None) -> np.ndarray:
        """Rows where path element `depth` (0 = the root struct) is
        non-null."""
        return self.level(rows) >= self.leaf.def_at[depth]

    def _python(self, vi: np.ndarray) -> list:
        if isinstance(self.values, Strings):
            out: list = [None] * len(vi)
            try:
                for k, v in enumerate(vi.tolist()):
                    if v >= 0:
                        out[k] = self.values.raw(v).decode("utf-8")
            except UnicodeDecodeError as e:
                raise DecodeCorrupt(f"{self.leaf.path}: a value is not "
                                    f"UTF-8: {e}") from e
            return out
        if not len(self.values):
            return [None] * len(vi)
        vals = self.values[np.maximum(vi, 0)].tolist()
        return [v if i >= 0 else None for v, i in zip(vals, vi.tolist())]

    def row_values(self, rows: np.ndarray) -> list:
        """Python value (None where null) of a non-repeated leaf's rows."""
        if self.reps is not None:
            raise DecodeUnsupported(f"{self.leaf.path} is repeated")
        return self._python(self.value_index[rows])

    def row_lists(self, rows: np.ndarray) -> list:
        """Per row of a leaf with one repetition level: None when the
        repeated container (map or list) is null, else its elements (None
        where an element is null)."""
        k_rep = self.leaf.rep_at.index(1)
        container = self.leaf.def_at[k_rep - 1] if k_rep else 0
        entry_at = self.leaf.def_at[k_rep]
        vals = self._python(self.value_index)
        starts = self.row_starts
        out = []
        for r in rows.tolist():
            s, e = int(starts[r]), int(starts[r + 1])
            d = int(self.defs[s])
            if d < container:
                out.append(None)
            elif d < entry_at:
                out.append([])
            else:
                out.append(vals[s:e])
        return out


def _levels(payload: bytes, pos: int, max_level: int, n: int):
    """One v1 level stream: 4-byte length, then the hybrid at
    bit_length(max_level). Returns (levels int32 [n], next_pos)."""
    ln = level_stream_length(payload, pos)
    pos += 4
    runs, _ = parse_hybrid(payload, pos, max(1, int(max_level).bit_length()),
                           n, end=pos + ln)
    return materialize_runs(runs).astype(np.int32), pos + ln


def _levels_v2(payload: bytes, pos: int, length: int, max_level: int,
               n: int) -> np.ndarray:
    """One data page v2 level stream: the hybrid at bit_length(max_level)
    in `length` bytes from `pos`, with no length prefix."""
    runs, _ = parse_hybrid(payload, pos, max(1, int(max_level).bit_length()),
                           n, end=pos + length)
    return materialize_runs(runs).astype(np.int32)


def _int96_micros(buf: np.ndarray, pos: int, count: int) -> np.ndarray:
    """PLAIN INT96 timestamps -> int64 microseconds since the epoch: 8
    bytes of nanoseconds of the day, then a 4-byte Julian day, little
    endian. The nanoseconds floor to microseconds (a day's nanoseconds
    are never negative, so the value floors too, before 1970 as after)."""
    if pos + 12 * count > buf.size:
        raise DecodeCorrupt("PLAIN INT96 values past the page")
    rows = buf[pos:pos + 12 * count].reshape(count, 12)
    nanos = np.ascontiguousarray(rows[:, :8]).view("<u8").reshape(-1)
    days = np.ascontiguousarray(rows[:, 8:]).view("<i4").reshape(-1)
    return ((days.astype(np.int64) - _JULIAN_EPOCH) * _US_PER_DAY
            + (nanos // 1000).astype(np.int64))


def _fixed_width(buf: np.ndarray, pos: int, count: int,
                 width: Optional[int]) -> Strings:
    """`count` FIXED_LEN_BYTE_ARRAY values of `width` bytes from `pos`."""
    if not width or width < 0:
        raise DecodeCorrupt(f"FIXED_LEN_BYTE_ARRAY of width {width!r}")
    if pos + width * count > buf.size:
        raise DecodeCorrupt("PLAIN FIXED_LEN_BYTE_ARRAY values past the "
                            "page")
    return Strings(buf, pos + np.arange(count, dtype=np.int64) * width,
                   np.full(count, width, np.int64))


def _plain_values(phys: str, buf: np.ndarray, pos: int, count: int,
                  width: Optional[int] = None):
    if phys == "FIXED_LEN_BYTE_ARRAY":
        return _fixed_width(buf, pos, count, width)
    if phys == "BYTE_ARRAY":
        starts, lens, _ = byte_array_offsets(buf, pos, count)
        return Strings(buf, starts, lens)
    if phys == "BOOLEAN":
        nb = -(-count // 8)
        if pos + nb > buf.size:
            raise DecodeCorrupt("PLAIN booleans past the page")
        return np.unpackbits(buf[pos:pos + nb],
                             bitorder="little")[:count].astype(bool)
    if phys == "INT96":
        return _int96_micros(buf, pos, count)
    dt = _FIXED.get(phys)
    if dt is None:
        raise DecodeUnsupported(f"physical type {phys}")
    size = np.dtype(dt).itemsize * count
    if pos + size > buf.size:
        raise DecodeCorrupt("PLAIN values past the page")
    vals = np.frombuffer(buf[pos:pos + size].tobytes(), dt)
    return vals.astype(np.int64) if dt == np.int32 else vals


def _bits_at(buf: np.ndarray, bit: np.ndarray, width: np.ndarray
             ) -> np.ndarray:
    """uint64 [n]: the `width[i]`-bit little-endian field (0 to 64 bits)
    that starts at bit `bit[i]` of `buf`; bytes past the buffer read 0."""
    out = np.zeros(bit.shape[0], np.uint64)
    if not bit.shape[0]:
        return out
    padded = np.concatenate([buf, np.zeros(9, np.uint8)])
    byte = bit >> 3
    shift = (bit & 7).astype(np.uint64)
    for k in range(8):
        out |= padded[byte + k].astype(np.uint64) << np.uint64(8 * k)
    out >>= shift
    w = width.astype(np.uint64)
    ninth = (shift + w > 64) & (shift > 0)  # a field that reaches byte 9
    if ninth.any():
        hi = padded[byte[ninth] + 8].astype(np.uint64)
        out[ninth] |= hi << (np.uint64(64) - shift[ninth])
    full = w >= 64
    mask = (np.uint64(1) << np.where(full, 0, w).astype(np.uint64)) \
        - np.uint64(1)
    return np.where(full, out, out & mask)


def delta_binary_packed(raw: bytes, pos: int, count: int, bits: int):
    """(int64 [count] values, end position) of a DELTA_BINARY_PACKED
    stream at `pos` for `bits`-bit integers (32 or 64): a header (block
    size, miniblocks per block, value count, first value), then blocks of
    a zig-zag minimum delta, one width byte per miniblock and the packed
    miniblocks (a last block's unneeded miniblocks have widths but no
    bytes). Arithmetic wraps at `bits` bits, as the writers' does."""
    t = _Thrift(raw, pos)
    block, n_mini, total = t.varint(), t.varint(), t.varint()
    first = t.zigzag()
    per = block // n_mini if n_mini else 0
    if not (0 < block <= 1 << 20 and block % 128 == 0 and n_mini
            and block % n_mini == 0 and per % 32 == 0):
        raise DecodeCorrupt(f"DELTA_BINARY_PACKED block {block} with "
                            f"{n_mini} miniblocks")
    if total != count:
        raise DecodeCorrupt(f"DELTA_BINARY_PACKED holds {total} values "
                            f"where the page holds {count}")
    starts, widths, mins = [], [], []
    left = total - 1
    while left > 0:
        min_delta = t.zigzag() & 0xFFFFFFFFFFFFFFFF
        at = t._take(n_mini)
        for w in raw[at:at + n_mini]:
            if left <= 0:
                break
            if w > bits:
                raise DecodeCorrupt(f"DELTA_BINARY_PACKED width {w} for "
                                    f"{bits}-bit values")
            starts.append(t._take(per * w // 8))
            widths.append(w)
            mins.append(min_delta)
            left -= per
    if total == 0:
        return np.zeros(0, np.int64), t.pos
    k = np.arange(total - 1, dtype=np.int64)  # delta k: miniblock k // per
    mb, lane = k // per, k % per
    w = np.asarray(widths, np.int64)[mb]
    bit = np.asarray(starts, np.int64)[mb] * 8 + lane * w
    deltas = _bits_at(np.frombuffer(raw, np.uint8), bit, w)
    deltas += np.asarray(mins, np.uint64)[mb]
    values = np.empty(total, np.uint64)
    values[0] = first & 0xFFFFFFFFFFFFFFFF
    values[1:] = deltas
    values = np.cumsum(values, dtype=np.uint64)  # wraps mod 2^64
    if bits == 32:
        return (values & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(
            np.int32).astype(np.int64), t.pos
    return values.view(np.int64), t.pos


def _delta_lengths(raw: bytes, buf: np.ndarray, pos: int, count: int):
    """(Strings, end) of DELTA_LENGTH_BYTE_ARRAY at `pos`: the lengths as
    DELTA_BINARY_PACKED, then the values' bytes back to back."""
    lens, pos = delta_binary_packed(raw, pos, count, 32)
    if count and int(lens.min()) < 0:
        raise DecodeCorrupt("DELTA_LENGTH_BYTE_ARRAY length below 0")
    end = pos + int(lens.sum())
    if end > buf.size:
        raise DecodeCorrupt("DELTA_LENGTH_BYTE_ARRAY values past the page")
    return Strings(buf, pos + np.cumsum(lens) - lens, lens), end


def _delta_byte_array(raw: bytes, buf: np.ndarray, pos: int,
                      count: int) -> Strings:
    """DELTA_BYTE_ARRAY: prefix lengths (DELTA_BINARY_PACKED), then the
    suffixes (DELTA_LENGTH_BYTE_ARRAY); value i is the first prefix[i]
    bytes of value i - 1, then suffix i. The chain runs in the host
    library."""
    prefix, pos = delta_binary_packed(raw, pos, count, 32)
    suffix, _ = _delta_lengths(raw, buf, pos, count)
    lens = prefix + suffix.lens
    # each prefix lies within the value before it (the first's is empty),
    # checked before the output is sized
    if count and (int(prefix.min()) < 0 or prefix[0] != 0
                  or bool((prefix[1:] > lens[:-1]).any())):
        raise DecodeCorrupt("DELTA_BYTE_ARRAY prefix longer than the "
                            "value before it")
    out = np.empty(max(int(lens.sum()), 1), np.uint8)
    starts = np.cumsum(lens) - lens
    fn = cuda_build.function(
        "parquet_host", "delta_byte_array",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p], restype=ctypes.c_longlong)
    prefix = np.ascontiguousarray(prefix, np.int64)
    s_starts = np.ascontiguousarray(suffix.starts, np.int64)
    s_lens = np.ascontiguousarray(suffix.lens, np.int64)
    if fn(buf.ctypes.data, buf.size, prefix.ctypes.data,
          s_starts.ctypes.data, s_lens.ctypes.data, count,
          out.ctypes.data) < 0:
        raise DecodeCorrupt("DELTA_BYTE_ARRAY prefix longer than the "
                            "value before it")
    return Strings(out, starts.astype(np.int64), lens.astype(np.int64))


def _byte_stream_split(phys: str, buf: np.ndarray, pos: int, count: int,
                       width: Optional[int] = None):
    """BYTE_STREAM_SPLIT: byte k of every value, then byte k + 1, ..."""
    if phys == "FIXED_LEN_BYTE_ARRAY":
        if not width or width < 0:
            raise DecodeCorrupt(f"FIXED_LEN_BYTE_ARRAY of width {width!r}")
        if pos + width * count > buf.size:
            raise DecodeCorrupt("BYTE_STREAM_SPLIT values past the page")
        rows = np.ascontiguousarray(
            buf[pos:pos + width * count].reshape(width, count).T)
        return _fixed_width(rows.reshape(-1), 0, count, width)
    dt = _FIXED.get(phys)
    if dt is None:
        raise DecodeUnsupported(f"BYTE_STREAM_SPLIT of {phys}")
    size = np.dtype(dt).itemsize
    if pos + size * count > buf.size:
        raise DecodeCorrupt("BYTE_STREAM_SPLIT values past the page")
    vals = np.ascontiguousarray(
        buf[pos:pos + size * count].reshape(size, count).T).view(
            dt).reshape(-1)
    return vals.astype(np.int64) if dt == np.int32 else vals


def _page_values(leaf: Leaf, encoding: int, raw: bytes, buf: np.ndarray,
                 pos: int, count: int, dictionary):
    """The `count` present values of a data page, from `pos`."""
    phys = leaf.physical_type
    if encoding in (_ENC_RLE_DICT, _ENC_PLAIN_DICT):
        if dictionary is None:
            raise DecodeCorrupt("dict page missing")
        if pos >= len(raw):
            raise DecodeCorrupt("dict-encoded page without its "
                                "index width")
        runs, _ = parse_hybrid(raw, pos + 1, raw[pos], count)
        idx = materialize_runs(runs).astype(np.int64)
        if count and int(idx.max()) >= len(dictionary):
            raise DecodeCorrupt("dictionary index past end")
        return _take(dictionary, idx)
    if encoding == _ENC_PLAIN:
        return _plain_values(phys, buf, pos, count, leaf.type_length)
    if encoding == _ENC_DELTA_BINARY_PACKED and phys in ("INT32", "INT64"):
        return delta_binary_packed(raw, pos, count,
                                   32 if phys == "INT32" else 64)[0]
    if encoding == _ENC_DELTA_LENGTH_BYTE_ARRAY and phys == "BYTE_ARRAY":
        return _delta_lengths(raw, buf, pos, count)[0]
    if encoding == _ENC_DELTA_BYTE_ARRAY and phys in (
            "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY"):
        out = _delta_byte_array(raw, buf, pos, count)
        if phys == "FIXED_LEN_BYTE_ARRAY" and bool(
                (out.lens != leaf.type_length).any()):
            raise DecodeCorrupt(f"{leaf.path}: a DELTA_BYTE_ARRAY value "
                                f"is not {leaf.type_length} bytes wide")
        return out
    if encoding == _ENC_BYTE_STREAM_SPLIT:
        return _byte_stream_split(phys, buf, pos, count, leaf.type_length)
    if encoding == _ENC_RLE and phys == "BOOLEAN":
        ln = level_stream_length(raw, pos)
        runs, _ = parse_hybrid(raw, pos + 4, 1, count, end=pos + 4 + ln)
        return materialize_runs(runs).astype(bool)
    raise DecodeUnsupported(f"{leaf.path}: encoding {encoding} of {phys}")


def _take(values, idx: np.ndarray):
    return values.take(idx) if isinstance(values, Strings) else values[idx]


def _concat(parts: list, phys: str):
    if phys in ("BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY"):
        if not parts:
            return Strings(np.zeros(0, np.uint8), np.zeros(0, np.int64),
                           np.zeros(0, np.int64))
        return Strings.concat(parts)
    if not parts:
        return np.zeros(0, bool if phys == "BOOLEAN" else
                        (np.int64 if phys in ("INT32", "INT64", "INT96")
                         else _FIXED.get(phys, np.float64)))
    return np.concatenate(parts)


def read_leaf(footer: Footer, data: bytes, col: int,
              nested: bool = False) -> HostLeaf:
    """Every row group's chunk of one leaf column; past one repetition
    level only when `nested` (the row read)."""
    leaf = footer.leaves[col]
    if leaf.max_repetition_level > 1 and not nested:
        raise DecodeUnsupported(f"{leaf.path}: nested repetition")
    phys = leaf.physical_type
    max_def, max_rep = leaf.max_definition_level, leaf.max_repetition_level
    defs, reps, values = [], [], []
    for rg in range(len(footer.row_groups)):
        first_def, first_rep = len(defs), len(reps)
        chunk, codec = footer.chunk(data, rg, col)
        dictionary = None
        for page in split_pages(
                chunk, footer.row_groups[rg].columns[col].num_values):
            if page.type not in (_PAGE_DICT, _PAGE_DATA, _PAGE_DATA_V2):
                continue
            payload = np.frombuffer(
                decompress_page(chunk, page, codec), np.uint8)
            if page.type == _PAGE_DICT:
                dictionary = _plain_values(phys, payload, 0,
                                           page.num_values, leaf.type_length)
                continue
            raw = payload.tobytes()
            n = page.num_values
            pos = 0
            if page.type == _PAGE_DATA_V2:
                if max_rep:
                    reps.append(_levels_v2(raw, 0, page.rep_len, max_rep, n))
                d = (_levels_v2(raw, page.rep_len, page.def_len, max_def, n)
                     if max_def else np.zeros(n, np.int32))
                pos = page.levels_len
            else:
                if max_rep:
                    r, pos = _levels(raw, pos, max_rep, n)
                    reps.append(r)
                if max_def:
                    d, pos = _levels(raw, pos, max_def, n)
                else:
                    d = np.zeros(n, np.int32)
            defs.append(d)
            count = int((d == max_def).sum())
            values.append(_page_values(leaf, page.encoding, raw, payload,
                                       pos, count, dictionary))
        # the pages must hold the row group's rows: one entry a row, or
        # one repetition level 0 a row
        rows = (sum(int((r == 0).sum()) for r in reps[first_rep:]) if max_rep
                else sum(d.shape[0] for d in defs[first_def:]))
        if rows != footer.row_groups[rg].num_rows:
            raise DecodeCorrupt(f"{leaf.path}: {rows} rows in row group "
                                f"{rg} of {footer.row_groups[rg].num_rows}")
    return HostLeaf(
        leaf,
        np.concatenate(defs) if defs else np.zeros(0, np.int32),
        (np.concatenate(reps) if reps else np.zeros(0, np.int32))
        if max_rep else None,
        _concat(values, phys))


def read_leaves(footer: Footer, data: bytes,
                paths: Sequence[str]) -> Dict[str, HostLeaf]:
    return {p: read_leaf(footer, data, footer.index[p]) for p in paths}


def assemble(leaves: Dict[str, HostLeaf], root: str,
             rows: np.ndarray) -> List[Optional[dict]]:
    """The root struct of each of `rows` as a Python dict (None where the
    root is null): nested structs become dicts, maps (`x.key_value.key` /
    `.value`) dicts, lists (`x.list.element`) lists."""
    mine = {p: lf for p, lf in leaves.items() if lf.leaf.parts[0] == root}
    if not mine:
        return [None] * len(rows)
    out: List[dict] = [{} for _ in range(len(rows))]

    def put(rel, vals):  # a null value creates no enclosing struct
        for d, v in zip(out, vals):
            if v is None:
                continue
            for name in rel[:-1]:
                d = d.setdefault(name, {})
            d[rel[-1]] = v

    for path, lf in mine.items():
        rel = lf.leaf.parts[1:]
        if lf.reps is None:
            put(rel, lf.row_values(rows))
        elif rel[-2:] == ("key_value", "key"):
            vpath = path[:-len("key")] + "value"
            keys = lf.row_lists(rows)
            vals = (mine[vpath].row_lists(rows) if vpath in mine
                    else [None if k is None else [None] * len(k)
                          for k in keys])
            if any((k is None) != (v is None) or (k is not None and
                                                  len(k) != len(v))
                   for k, v in zip(keys, vals)):
                raise DecodeCorrupt(f"{path}: keys and values of a map "
                                    f"disagree")
            put(rel[:-2], [None if k is None else dict(zip(k, v))
                           for k, v in zip(keys, vals)])
        elif rel[-2:] == ("key_value", "value"):
            continue  # read with its key
        elif rel[-2:] == ("list", "element"):
            put(rel[:-2], lf.row_lists(rows))
        else:
            raise DecodeUnsupported(f"repeated leaf {path} of unknown shape")
    present = next(iter(mine.values())).present(0, rows)
    return [d if ok else None for d, ok in zip(out, present.tolist())]

"""Host leaf reader: the counterpart of Arrow's `pf.read(columns=rest)` in
the JAX package's checkpoint reader (`delta_tpu/log/page_decode.py:731`).

It reads the checkpoint leaves that the device decode does not plan:
stats strings, the `partitionValues` / `tags` maps, deletion-vector
structs, and the protocol, metaData, txn and domainMetadata rows. Scope:

- flat leaves at any struct depth, and maps and lists with ONE repetition
  level (`partitionValues`, `tags`, `format.options`, `configuration`,
  `partitionColumns`, `readerFeatures`, `writerFeatures`);
- INT32, INT64, BOOLEAN, FLOAT, DOUBLE and BYTE_ARRAY, PLAIN or
  dictionary-coded, including a chunk whose dictionary pages are followed
  by PLAIN pages (a writer's fallback once the dictionary passes its size
  limit);
- data page v1, SNAPPY or uncompressed.

Definition and repetition levels decode through `materialize_runs`; the
PLAIN BYTE_ARRAY walk runs in the host library (`csrc/parquet_host.cpp`).
Anything else raises DecodeUnsupported; damaged bytes raise
DecodeCorrupt. Strings stay as (buffer, starts,
lengths) until a caller materializes a row.
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
    _ENC_RLE_DICT,
    _PAGE_DATA,
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
)
from delta_tpu_torch.ops import cuda_build

_FIXED = {"INT32": np.int32, "INT64": np.int64, "FLOAT": np.float32,
          "DOUBLE": np.float64}


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
            for k, v in enumerate(vi.tolist()):
                if v >= 0:
                    out[k] = self.values.raw(v).decode("utf-8")
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


def _plain_values(phys: str, buf: np.ndarray, pos: int, count: int):
    if phys == "BYTE_ARRAY":
        starts, lens, _ = byte_array_offsets(buf, pos, count)
        return Strings(buf, starts, lens)
    if phys == "BOOLEAN":
        nb = -(-count // 8)
        if pos + nb > buf.size:
            raise DecodeCorrupt("PLAIN booleans past the page")
        return np.unpackbits(buf[pos:pos + nb],
                             bitorder="little")[:count].astype(bool)
    dt = _FIXED.get(phys)
    if dt is None:
        raise DecodeUnsupported(f"physical type {phys}")
    size = np.dtype(dt).itemsize * count
    if pos + size > buf.size:
        raise DecodeCorrupt("PLAIN values past the page")
    vals = np.frombuffer(buf[pos:pos + size].tobytes(), dt)
    return vals.astype(np.int64) if dt == np.int32 else vals


def _take(values, idx: np.ndarray):
    return values.take(idx) if isinstance(values, Strings) else values[idx]


def _concat(parts: list, phys: str):
    if phys == "BYTE_ARRAY":
        if not parts:
            return Strings(np.zeros(0, np.uint8), np.zeros(0, np.int64),
                           np.zeros(0, np.int64))
        return Strings.concat(parts)
    if not parts:
        return np.zeros(0, bool if phys == "BOOLEAN" else
                        (np.int64 if phys in ("INT32", "INT64")
                         else _FIXED.get(phys, np.float64)))
    return np.concatenate(parts)


def read_leaf(footer: Footer, data: bytes, col: int) -> HostLeaf:
    """Every row group's chunk of one leaf column."""
    leaf = footer.leaves[col]
    if leaf.max_repetition_level > 1:
        raise DecodeUnsupported(f"{leaf.path}: nested repetition")
    phys = leaf.physical_type
    max_def, max_rep = leaf.max_definition_level, leaf.max_repetition_level
    defs, reps, values = [], [], []
    for rg in range(len(footer.row_groups)):
        chunk, codec = footer.chunk(data, rg, col)
        dictionary = None
        for page in split_pages(
                chunk, footer.row_groups[rg].columns[col].num_values):
            if page.type not in (_PAGE_DICT, _PAGE_DATA):
                continue
            payload = np.frombuffer(
                decompress_page(chunk, page, codec), np.uint8)
            if page.type == _PAGE_DICT:
                dictionary = _plain_values(phys, payload, 0,
                                           page.num_values)
                continue
            raw = payload.tobytes()
            n = page.num_values
            pos = 0
            if max_rep:
                r, pos = _levels(raw, pos, max_rep, n)
                reps.append(r)
            if max_def:
                d, pos = _levels(raw, pos, max_def, n)
            else:
                d = np.zeros(n, np.int32)
            defs.append(d)
            count = int((d == max_def).sum())
            if page.encoding in (_ENC_RLE_DICT, _ENC_PLAIN_DICT):
                if dictionary is None:
                    raise DecodeCorrupt("dict page missing")
                if pos >= len(raw):
                    raise DecodeCorrupt("dict-encoded page without its "
                                        "index width")
                runs, _ = parse_hybrid(raw, pos + 1, raw[pos], count)
                idx = materialize_runs(runs).astype(np.int64)
                if count and int(idx.max()) >= len(dictionary):
                    raise DecodeCorrupt("dictionary index past end")
                values.append(_take(dictionary, idx))
            elif page.encoding == _ENC_PLAIN:
                values.append(_plain_values(phys, payload, pos, count))
            else:
                raise DecodeUnsupported(
                    f"{leaf.path}: encoding {page.encoding}")
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

"""Host side of the checkpoint page decode: one plan per part.

Counterpart of `delta_tpu/log/page_decode.py`. The plan compiler is a copy
of the reference's (`split_pages`, `parse_hybrid`, `materialize_runs`,
`_PlanState`, `_plan_hybrid`, `_parse_byte_array_dict`,
`_plan_column_chunk`, `build_part_plan`), driven by the port's own footer
reader (`log/parquet_footer.py`) instead of Arrow's metadata and by the
port's codecs (`decompress`: `log/snappy.py`, `log/zstd.py`, zlib)
instead of `pa.Codec`:

- host: PageHeader parse, page decompression, and the varint run headers
  of every RLE/bit-packed hybrid stream: O(pages), nothing O(values);
- device (`ops/page_decode.py`): the O(bytes) work, one decode per part:
  kernel K3 extracts every hybrid position, then torch ops expand the
  definition levels and gather dictionary and PLAIN values.

The plan layout is the reference's, column for column (documented in
`ops/page_decode.py`); the port does not pad lanes to buckets.

`read_checkpoint_part` is the port of `read_checkpoint_part_device`: the
device decodes the projected hot columns (`_VALUE_COLUMNS`, and the path
columns as replay keys while they are dictionary-coded) and the host leaf
reader (`log/parquet_host.py`) reads the rest, where the reference reads
them with Arrow. A part outside the plan's scope (`DecodeUnsupported`)
reads every leaf on the host, as the reference's whole-part Arrow read;
damaged bytes (`DecodeCorrupt`) go to no other reader: they propagate.

Scope of the plan: data page v1 (a v2 page sends the part to the host
reader, as the reference routes it), SNAPPY, ZSTD, GZIP or uncompressed,
non-repeated
columns, PLAIN / RLE_DICTIONARY values of INT32 / INT64 / DOUBLE /
BOOLEAN, and dictionary-coded BYTE_ARRAY for the two path columns.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from delta_tpu_torch.log.parquet_footer import (
    ENCODINGS,
    DecodeCorrupt,
    DecodeUnsupported,
    Footer,
    Leaf,
    _Thrift,
    read_footer,
    thrift_field,
)
from delta_tpu_torch.ops.page_decode import (
    KEY_ADD,
    KEY_REMOVE,
    KIND_BOOL,
    KIND_DICT,
    KIND_PLAIN,
    MAX_LANE_BYTES,
    PAGE_F,
    RUN_F,
    PartKeys,
    PartPlan,
    decode_part,
)

# page types (parquet-format PageType)
_PAGE_DATA = 0
_PAGE_DICT = 2
_PAGE_DATA_V2 = 3

# encodings
_ENC_PLAIN = 0
_ENC_PLAIN_DICT = 2
_ENC_RLE = 3
_ENC_RLE_DICT = 8


@dataclass
class PageInfo:
    type: int
    uncompressed_size: int
    compressed_size: int
    num_values: int
    encoding: int
    payload_start: int  # offset of the (compressed) payload in the chunk
    # data page v2 only: the byte lengths of the repetition and definition
    # levels, which lead the payload uncompressed and without a length
    # prefix, and whether the values after them are compressed
    rep_len: int = 0
    def_len: int = 0
    is_compressed: bool = True

    @property
    def levels_len(self) -> int:
        return self.rep_len + self.def_len


def split_pages(chunk: bytes, max_values: int) -> List[PageInfo]:
    """Host page splitting: walk the chunk's PageHeaders (data page v1 and
    v2, dictionary pages; other page types are skipped). No page of a
    sound chunk holds more than the chunk's `max_values` (its metadata's
    num_values)."""
    pages = []
    pos = 0
    while pos < len(chunk):
        t = _Thrift(chunk, pos)
        hdr = t.read_struct()
        ptype = thrift_field(hdr, 1, int)
        if ptype is None:
            break
        rep_len = def_len = 0
        compressed = True
        if ptype in (_PAGE_DATA, _PAGE_DICT):
            dph = thrift_field(hdr, 5 if ptype == _PAGE_DATA else 7, dict,
                               {})
            nv = thrift_field(dph, 1, int, 0)
            enc = thrift_field(dph, 2, int, _ENC_PLAIN)
        elif ptype == _PAGE_DATA_V2:
            # DataPageHeaderV2: 1 num_values, 4 encoding, 5/6 definition
            # and repetition level byte lengths, 7 is_compressed
            dph = thrift_field(hdr, 8, dict, {})
            nv = thrift_field(dph, 1, int, 0)
            enc = thrift_field(dph, 4, int, _ENC_PLAIN)
            def_len = thrift_field(dph, 5, int, 0)
            rep_len = thrift_field(dph, 6, int, 0)
            compressed = thrift_field(dph, 7, bool, True)
        else:
            nv, enc = 0, _ENC_PLAIN
        if enc not in ENCODINGS:
            raise DecodeCorrupt(f"page encoding {enc!r} is no Parquet "
                                f"encoding")
        sizes = (thrift_field(hdr, 2, int, 0), thrift_field(hdr, 3, int, 0),
                 nv, rep_len, def_len)
        if not all(0 <= v < 1 << 31 for v in sizes) or nv > max_values \
                or rep_len + def_len > min(sizes[0], sizes[1]):
            raise DecodeCorrupt(f"page header sizes {sizes!r} (the chunk "
                                f"holds {max_values} values)")
        pages.append(PageInfo(ptype, sizes[0], sizes[1], nv, enc, t.pos,
                              rep_len, def_len, compressed))
        pos = t.pos + sizes[1]
    return pages


def decompress(raw: bytes, expected: int, codec: str) -> bytes:
    """`raw` in `codec`, decompressed to its `expected` bytes: SNAPPY
    (`log/snappy.py`), ZSTD (`log/zstd.py`), GZIP (Python's zlib) or
    none. A stream that is damaged or gives another length raises
    DecodeCorrupt; LZ4, LZ4_RAW, BROTLI and LZO raise DecodeUnsupported."""
    if codec in ("UNCOMPRESSED", "NONE"):
        out = raw
    elif codec == "SNAPPY":
        from delta_tpu_torch.log import snappy

        out = snappy.decompress(raw, expected)
    elif codec == "ZSTD":
        from delta_tpu_torch.log import zstd

        out = zstd.decompress(raw, expected)
    elif codec == "GZIP":
        out = gunzip(raw, expected)
    else:
        raise DecodeUnsupported(f"codec {codec}")
    if len(out) != expected:
        raise DecodeCorrupt(f"{codec} page of {len(out)} bytes where its "
                            f"header says {expected}")
    return out


def gunzip(raw: bytes, expected: int) -> bytes:
    """GZIP (or zlib) members, concatenated: the codec Parquet calls
    GZIP. Damage, a member cut short and any other total than `expected`
    bytes raise DecodeCorrupt."""
    out = bytearray()
    rest = raw
    while rest:
        d = zlib.decompressobj(wbits=47)
        try:
            out += d.decompress(rest, expected - len(out) + 1)
        except zlib.error as e:
            raise DecodeCorrupt(f"corrupt GZIP page: {e}") from e
        if not d.eof or len(out) > expected:
            raise DecodeCorrupt("GZIP page ends inside a member, or holds "
                                "more than its header says")
        rest = d.unused_data
    if len(out) != expected:
        raise DecodeCorrupt(f"GZIP page gave {len(out)} of {expected} bytes")
    return bytes(out)


def decompress_page(chunk: bytes, page: PageInfo, codec: str) -> bytes:
    """Page payload bytes (`decompress`). A v2 data page's levels lead it
    uncompressed; only the values after them are compressed, and only
    when the header's `is_compressed` holds."""
    raw = chunk[page.payload_start:page.payload_start + page.compressed_size]
    if len(raw) != page.compressed_size:
        raise DecodeCorrupt("page runs past its column chunk")
    if page.type != _PAGE_DATA_V2:
        return decompress(raw, page.uncompressed_size, codec)
    cut = page.levels_len
    body = raw[cut:]
    return raw[:cut] + decompress(
        body, page.uncompressed_size - cut,
        codec if page.is_compressed else "UNCOMPRESSED")


# ------------------------------------------- RLE/bit-packed hybrid ----

@dataclass
class HybridRuns:
    """Parsed hybrid stream: RLE runs as (start, count, value), bit-packed
    runs as (start, n_values, words)."""

    n: int
    w: int = 0
    rle: List[Tuple[int, int, int]] = field(default_factory=list)
    packed: List[Tuple[int, int, np.ndarray]] = field(default_factory=list)


def parse_hybrid(data: bytes, pos: int, w: int, n: int,
                 end: Optional[int] = None) -> Tuple[HybridRuns, int]:
    """Parse the RLE/bit-packed hybrid stream for `n` values at bit
    width `w` starting at `pos`. Returns (runs, next_pos)."""
    if not isinstance(w, int) or not 0 <= w <= 32:
        raise DecodeCorrupt(f"hybrid bit width {w!r} outside [0, 32]")
    runs = HybridRuns(n, w)
    out = 0
    byte_w = (w + 7) // 8
    limit = len(data) if end is None else end
    t = _Thrift(data, pos)
    while out < n and t.pos < limit:
        header = t.varint()
        if header & 1:  # bit-packed: (header >> 1) groups of 8
            groups8 = header >> 1
            nvals = groups8 * 8
            nbytes = groups8 * w
            seg = data[t.pos:t.pos + nbytes]
            t.pos += nbytes
            padded = seg + b"\x00" * (-len(seg) % 4)
            words = np.frombuffer(padded, np.uint32)
            runs.packed.append((out, min(nvals, n - out), words))
            out += nvals
        else:  # RLE: value repeated (header >> 1) times
            count = header >> 1
            vbytes = data[t.pos:t.pos + byte_w]
            t.pos += byte_w
            value = int.from_bytes(vbytes, "little")
            runs.rle.append((out, min(count, n - out), value))
            out += count
    if out < n:
        raise DecodeCorrupt(f"hybrid stream ended early ({out}/{n})")
    return runs, t.pos


def materialize_runs(runs: HybridRuns) -> np.ndarray:
    """Expand a hybrid stream to uint32[n] on the host: the numpy twin of
    the device extract, and the host reader's level decoder."""
    out = np.zeros(runs.n, np.uint32)
    for start, count, value in runs.rle:
        out[start:start + count] = value
    w = runs.w
    for start, nv, words in runs.packed:
        nv = min(nv, runs.n - start)
        if nv <= 0 or w == 0:
            continue
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        need = nv * w
        if bits.size < need:
            bits = np.concatenate(
                [bits, np.zeros(need - bits.size, np.uint8)])
        weights = np.uint32(1) << np.arange(w, dtype=np.uint32)
        out[start:start + nv] = (
            bits[:need].reshape(nv, w).astype(np.uint64) * weights
        ).sum(axis=1).astype(np.uint32)
    return out


# ------------------------------------------------- the one-lane plan --

_PHYS_NP = {"INT32": np.int32, "INT64": np.int64, "DOUBLE": np.float64}
_PHYS_ITEM = {"INT32": 4, "INT64": 8, "DOUBLE": 8, "BOOLEAN": 1}


@dataclass
class _PlanState:
    """Accumulator while planning one part: byte-lane segments plus the
    run/page plan rows, with running hybrid/row counters."""

    segs: List[bytes] = field(default_factory=list)
    lane_len: int = 0
    runs: List[Tuple[int, ...]] = field(default_factory=list)
    pages: List[Tuple[int, ...]] = field(default_factory=list)
    h: int = 0
    rows: int = 0

    def append(self, b: bytes) -> int:
        """Append a byte segment to the lane, returning its offset."""
        off = self.lane_len
        self.segs.append(b)
        self.lane_len += len(b)
        if self.lane_len > MAX_LANE_BYTES:
            raise DecodeUnsupported("part byte lane over cap")
        return off

    def snapshot(self):
        return (len(self.segs), self.lane_len, len(self.runs),
                len(self.pages), self.h, self.rows)

    def restore(self, snap) -> None:
        n_segs, lane_len, n_runs, n_pages, h, rows = snap
        del self.segs[n_segs:]
        self.lane_len = lane_len
        del self.runs[n_runs:]
        del self.pages[n_pages:]
        self.h = h
        self.rows = rows


def _plan_hybrid(st: _PlanState, base_off: int, data: bytes, pos: int,
                 w: int, n: int, end: Optional[int] = None,
                 strict: bool = True) -> int:
    """Walk one hybrid stream's run headers without expanding: each run
    becomes a plan row carrying its absolute lane bit offset. Reserves
    exactly `n` hybrid positions. `strict=False` tolerates a stream that
    ends before `n` values (dictionary-index and boolean streams carry
    only the page's present values, a count the host never computes)."""
    if not isinstance(w, int) or not 0 <= w <= 32:
        raise DecodeCorrupt(f"hybrid bit width {w!r} outside [0, 32]")
    h0 = st.h
    out = 0
    byte_w = (w + 7) // 8
    limit = len(data) if end is None else end
    t = _Thrift(data, pos)
    while out < n and t.pos < limit:
        header = t.varint()
        if header >> 1 >= 1 << 28:  # a count past the int32 plan lanes
            raise DecodeCorrupt(f"hybrid run header {header}")
        if header & 1:
            groups8 = header >> 1
            nvals = groups8 * 8
            st.runs.append((h0 + out, nvals, 8 * (base_off + t.pos),
                            w, 0, 0))
            t.pos += groups8 * w
            out += nvals
        else:
            count = header >> 1
            value = int.from_bytes(data[t.pos:t.pos + byte_w], "little")
            t.pos += byte_w
            v32 = value & 0xFFFFFFFF
            if v32 >= 1 << 31:
                v32 -= 1 << 32  # int32 bit pattern for the plan lane
            st.runs.append((h0 + out, count, 0, w, 1, v32))
            out += count
    if strict and out < n:
        raise DecodeCorrupt(f"hybrid stream ended early ({out}/{n})")
    st.h = h0 + n
    return t.pos


def _length_prefix(payload: bytes, pos: int) -> int:
    return int.from_bytes(payload[pos:pos + 4], "little", signed=True)


def level_stream_length(payload: bytes, pos: int) -> int:
    """The 4-byte length before a v1 page's level stream at `pos`,
    checked to lie within the page."""
    if pos + 4 > len(payload):
        raise DecodeCorrupt("page ends before its level stream's length")
    ln = _length_prefix(payload, pos)
    if not 0 <= ln <= len(payload) - pos - 4:
        raise DecodeCorrupt(f"level stream of {ln} bytes past the page")
    return ln


def _parse_byte_array_dict(payload: bytes, num_values: int) -> List[bytes]:
    """PLAIN dictionary page of a BYTE_ARRAY column:
    [4-byte LE length][bytes] per entry."""
    out = []
    pos = 0
    for _ in range(num_values):
        ln = _length_prefix(payload, pos) if pos + 4 <= len(payload) else -1
        pos += 4
        if ln < 0 or pos + ln > len(payload):
            raise DecodeCorrupt("corrupt byte-array dictionary")
        out.append(payload[pos:pos + ln])
        pos += ln
    return out


def _plan_column_chunk(st: _PlanState, chunk: bytes, max_values: int,
                       phys: str, codec: str, max_def: int, key: int,
                       part_dict: Dict[bytes, int],
                       uniq: List[bytes]) -> None:
    """Plan one column chunk's pages into the lane. For key columns the
    dictionary page is parsed on the host into the part-local path
    dictionary (shared across add/remove) and only the int32 remap table
    enters the lane."""
    dict_b = dict_n = 0
    have_dict = False
    item = 4 if key else _PHYS_ITEM[phys]
    for page in split_pages(chunk, max_values):
        if page.type == _PAGE_DICT:
            payload = decompress_page(chunk, page, codec)
            if key:
                local = _parse_byte_array_dict(payload, page.num_values)
                remap = np.zeros(max(len(local), 1), np.int32)
                for j, b in enumerate(local):
                    code = part_dict.setdefault(b, len(part_dict))
                    if code == len(uniq):
                        uniq.append(b)
                    remap[j] = code
                dict_b = st.append(remap.tobytes())
                dict_n = len(local)
            else:
                if phys not in _PHYS_NP:
                    raise DecodeUnsupported(f"dict physical {phys}")
                dict_b = st.append(payload)
                dict_n = page.num_values
            have_dict = True
        elif page.type == _PAGE_DATA_V2:
            # the reference's device plan takes v1 pages only; such a
            # part reads on the host (one decode.device_fallbacks)
            raise DecodeUnsupported("data page v2")
        elif page.type == _PAGE_DATA:
            payload = decompress_page(chunk, page, codec)
            off = st.append(payload)
            n = page.num_values
            pos = 0
            def_h = 0
            if max_def > 0:
                # def levels: 4-byte LE length + hybrid at
                # bit_length(max_def); a value is present only at the
                # full definition level
                dw = max(1, int(max_def).bit_length())
                dl_len = level_stream_length(payload, pos)
                pos += 4
                def_h = st.h
                _plan_hybrid(st, off, payload, pos, dw, n,
                             end=pos + dl_len, strict=True)
                pos += dl_len
            if page.encoding in (_ENC_RLE_DICT, _ENC_PLAIN_DICT):
                if not have_dict:
                    raise DecodeCorrupt("dict-encoded page without dict")
                if pos >= len(payload):
                    raise DecodeCorrupt("dict-encoded page without its "
                                        "index width")
                w = payload[pos]
                if w > 32:
                    raise DecodeCorrupt(f"index width {w}")
                aux_h = st.h
                _plan_hybrid(st, off, payload, pos + 1, w, n, strict=False)
                kind, val_b = KIND_DICT, 0
            elif page.encoding == _ENC_PLAIN:
                if key:
                    # PLAIN BYTE_ARRAY is variable-width: no device plan;
                    # the caller drops just this key column
                    raise DecodeUnsupported("plain-encoded key column")
                if phys == "BOOLEAN":
                    # PLAIN booleans are a width-1 bit-packed stream
                    aux_h = st.h
                    st.runs.append((st.h, n, 8 * (off + pos), 1, 0, 0))
                    st.h += n
                    kind, val_b = KIND_BOOL, 0
                elif phys in _PHYS_NP:
                    kind, val_b, aux_h = KIND_PLAIN, off + pos, 0
                else:
                    raise DecodeUnsupported(f"plain physical {phys}")
            else:
                raise DecodeUnsupported(f"encoding {page.encoding}")
            st.pages.append((st.rows, n, max_def, def_h, kind, val_b,
                             item, aux_h, dict_b, dict_n, key))
            st.rows += n


# ------------------------------------------------- part plan + read ----

DEVICE_COLUMNS = ("add.size", "add.modificationTime", "add.dataChange")

# planned when present; the add columns above are the gate: a part
# without them reads wholly on the host
_VALUE_COLUMNS = DEVICE_COLUMNS + ("remove.deletionTimestamp",
                                   "remove.dataChange")
_KEY_COLUMNS = ("add.path", "remove.path")


@dataclass
class _ColSpan:
    """One planned column's slice of the plan's output row space."""

    name: str
    phys: str
    row_start: int
    n_rows: int
    key: int


def _plan_column(st: _PlanState, footer: Footer, data: bytes, col_idx: int,
                 key: int, part_dict: Dict[bytes, int],
                 uniq: List[bytes]) -> _ColSpan:
    """Plan every row group's chunk of one leaf column. Row groups are
    the inner loop, so a column's rows are contiguous in the row space."""
    leaf = footer.leaves[col_idx]
    if leaf.max_repetition_level != 0:
        raise DecodeUnsupported("repeated column")
    phys = leaf.physical_type
    if key:
        if phys != "BYTE_ARRAY" or leaf.max_definition_level != 2:
            raise DecodeUnsupported("key column shape")
    elif phys not in _PHYS_ITEM:
        raise DecodeUnsupported(f"physical {phys}")
    row_start = st.rows
    for rg in range(len(footer.row_groups)):
        chunk, codec = footer.chunk(data, rg, col_idx)
        _plan_column_chunk(st, chunk,
                           footer.row_groups[rg].columns[col_idx].num_values,
                           phys, codec, leaf.max_definition_level, key,
                           part_dict, uniq)
    return _ColSpan(leaf.path, phys, row_start, st.rows - row_start, key)


def build_part_plan(footer: Footer, data: bytes, value_cols: List[str],
                    key_cols: List[str]):
    """Build the one-lane decode plan for a checkpoint part: all pages of
    the projected columns packed into one uint8 lane plus int32 run/page
    plans.

    Value-column failures propagate (the whole part reads on the host);
    a key column that cannot be planned (PLAIN pages after a dictionary
    overflow, odd nesting) is rolled back and dropped: the part still
    decodes its numeric columns on the device, only the handoff is off.

    Returns (plan, spans, uniq, dropped_keys)."""
    st = _PlanState()
    part_dict: Dict[bytes, int] = {}
    uniq: List[bytes] = []
    spans: List[_ColSpan] = []
    dropped_keys: List[str] = []
    for name in value_cols:
        idx = footer.index.get(name)
        if idx is None:
            raise DecodeUnsupported(f"column {name} not found")
        spans.append(_plan_column(st, footer, data, idx, 0, part_dict, uniq))
    for name in key_cols:
        idx = footer.index.get(name)
        if idx is None:
            continue
        key = KEY_ADD if name.startswith("add.") else KEY_REMOVE
        snap = st.snapshot()
        n_uniq = len(uniq)
        try:
            spans.append(_plan_column(st, footer, data, idx, key,
                                      part_dict, uniq))
        except DecodeUnsupported:
            st.restore(snap)
            for b in uniq[n_uniq:]:
                del part_dict[b]
            del uniq[n_uniq:]
            dropped_keys.append(name)
    if not st.pages:
        raise DecodeUnsupported("no data pages")
    plan = _pack_plan(st, has_keys=any(s.key for s in spans))
    return plan, spans, uniq, dropped_keys


def _pack_plan(st: _PlanState, has_keys: bool) -> PartPlan:
    """The accumulated plan state, unpadded, in the one host buffer that
    `PartPlan.pack` lays out with K3's tile table."""
    lane = np.frombuffer(b"".join(st.segs), np.uint8)
    try:
        runs = np.asarray(st.runs, np.int32).reshape(-1, RUN_F)
        pages = np.asarray(st.pages, np.int32).reshape(-1, PAGE_F)
    except OverflowError as e:  # positions or rows past int32
        raise DecodeCorrupt(f"plan past int32: {e}") from e
    return PartPlan.pack(lane, runs, pages, st.h, st.rows, has_keys)


@dataclass
class DecodedColumn:
    """One device-decoded leaf, copied back to the host for the row
    store: validity and values per row of the part (`values` are the
    part-local dictionary codes of a key column, whose strings are
    `uniq`)."""

    valid: np.ndarray
    values: np.ndarray
    uniq: Optional[List[bytes]] = None


@dataclass
class PartRead:
    """One checkpoint part, read: `leaves` from the host reader, `decoded`
    from the device decode (empty when the part read wholly on the host),
    `keys` the device-resident replay-key lane (None unless every key
    column was planned)."""

    n_rows: int
    footer: Footer
    leaves: Dict[str, object]
    decoded: Dict[str, DecodedColumn]
    keys: Optional[PartKeys]
    on_device: bool


def _combine(phys: str, lo, hi):
    """Two u32 lanes (int64 tensors) -> the column's numpy values."""
    lo = lo.cpu().numpy()
    if phys == "BOOLEAN":
        return lo.astype(bool)
    if phys == "INT32":
        return lo.astype(np.uint32).view(np.int32).astype(np.int64)
    u = lo.astype(np.uint64) | (hi.cpu().numpy().astype(np.uint64)
                                << np.uint64(32))
    return u.view(np.int64) if phys == "INT64" else u.view(np.float64)


def read_checkpoint_part(data: bytes, device, wanted: Callable[[Leaf], bool],
                         want_keys: bool = True,
                         phases: Optional[Dict[str, float]] = None
                         ) -> PartRead:
    """Read one checkpoint part: the device decodes the projected hot
    columns in one decode (one K3 launch), the host leaf reader reads the
    other leaves for which `wanted(leaf)` holds. A part outside the plan's
    scope reads every wanted leaf on the host (`on_device` False).
    `phases` accumulates wall seconds of "ckpt_plan", "ckpt_decode" and
    "ckpt_host"."""
    from delta_tpu_torch.log import parquet_host

    phases = {} if phases is None else phases
    t0 = time.perf_counter()
    footer = read_footer(data)
    paths = [leaf.path for leaf in footer.leaves if wanted(leaf)]
    decoded: Dict[str, DecodedColumn] = {}
    keys = None
    on_device = False
    planned = set()
    try:
        if not any(c in footer.index for c in DEVICE_COLUMNS):
            raise DecodeUnsupported("no add columns to decode")
        if footer.num_rows == 0:
            # nothing to decode and nothing to replay: no launch
            leaves = parquet_host.read_leaves(footer, data, paths)
            return PartRead(0, footer, leaves, {},
                            PartKeys(None, 0, 0, 0, []), True)
        value_cols = [c for c in _VALUE_COLUMNS if c in footer.index]
        key_cols = [c for c in _KEY_COLUMNS
                    if want_keys and c in footer.index]
        plan, spans, uniq, _dropped = build_part_plan(
            footer, data, value_cols, key_cols)
        planned = {s.name for s in spans}
        rest = [c for c in paths if c not in planned]
        for root in {s.name.split(".", 1)[0] for s in spans}:
            if not any(c.startswith(root + ".") for c in rest):
                # row presence of the root comes from a host leaf
                raise DecodeUnsupported(f"no host leaf under {root}")
    except DecodeUnsupported:
        planned = set()
    t1 = time.perf_counter()
    if planned:
        lo, hi, defined, keys = decode_part(plan, device)
        valid = defined.cpu().numpy()
        for s in spans:
            sl = slice(s.row_start, s.row_start + s.n_rows)
            if s.key:
                decoded[s.name] = DecodedColumn(
                    valid[sl], lo[sl].cpu().numpy().astype(np.int64), uniq)
            else:
                decoded[s.name] = DecodedColumn(
                    valid[sl], _combine(s.phys, lo[sl], hi[sl]))
        if keys is not None:
            keys.uniq = uniq
        on_device = True
    t2 = time.perf_counter()
    leaves = parquet_host.read_leaves(
        footer, data, [c for c in paths if c not in planned])
    t3 = time.perf_counter()
    for k, v in (("ckpt_plan", t1 - t0), ("ckpt_decode", t2 - t1),
                 ("ckpt_host", t3 - t2)):
        phases[k] = phases.get(k, 0.0) + v
    return PartRead(footer.num_rows, footer, leaves, decoded, keys,
                    on_device)

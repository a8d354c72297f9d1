"""Roaring bitmaps of deletion vectors: the set, its serialization, and the
decode of a stored one to a row mask.

Counterpart of `delta_tpu/dv/roaring.py` (the public RoaringFormatSpec,
which the Delta protocol mandates for deletion vectors). 32-bit container
types, per 16-bit high key:

- array:  sorted u16 values (cardinality <= 4096)
- bitmap: 8192-byte bitset
- run:    u16 numRuns + (start, length - 1) u16 pairs

Top-level layouts:

- no runs:   [cookie 12346 i32][numContainers i32]
             [(key u16, card - 1 u16) * n][offsets i32 * n][containers]
- with runs: [cookie (n - 1) << 16 | 12347][run bitset ceil(n / 8) bytes]
             [(key u16, card - 1 u16) * n]
             [offsets i32 * n, only when n >= 4][containers]

64-bit portable: [numBuckets i64 LE], then per bucket (ascending)
[key u32 LE][32-bit roaring bytes]; a Delta blob is [magic i32 LE] plus
the portable bytes.

`RoaringBitmapArray` keeps the set as a sorted numpy uint64 array. The
writer emits array and bitmap containers, never runs, in the same bytes as
the reference's; `serialize_deltas` serializes a list of them with every
bitmap container packed by one K8 launch on the given device. The reader
takes all three container types. `decode_delta_masks` turns the blobs of
a batch of files into their deleted-row masks with one K8 launch
(`ops/dv_bits.py::dv_tiles`): the containers are parsed on the host
(`_containers`) into tiles, one per 65,536-row window of each file's
words in a segment of its own, their lows (array containers, and run
containers expanded here) and their bitmap containers; one pinned upload,
one launch, one copy of the words back, and the masks and cardinalities
split from those words on the host. Only the words below a file's rows
are expanded; the lanes past them are counted on the host, so the
cardinality stays exact.
"""

from __future__ import annotations

import struct
import time
import zlib
from typing import Optional

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.errors import DeletionVectorError
from delta_tpu_torch.ops.dv_bits import (
    BITMAP_WORDS,
    TILE_FIELDS,
    dv_tiles,
    pack_tiles,
    tile_table,
    upload,
)

SERIAL_COOKIE_NO_RUNCONTAINER = 12346
SERIAL_COOKIE = 12347
NO_OFFSET_THRESHOLD = 4
ARRAY_MAX_CARD = 4096
BITMAP_BYTES = 8192

DELTA_MAGIC = 1681511377


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    offs = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(offs, lens)


def _run_lows(buf, start: int) -> np.ndarray:
    """The low 16 bits of a run container's values, int64."""
    (n_runs,) = struct.unpack_from("<H", buf, start)
    runs = np.frombuffer(buf[start + 2:start + 2 + 4 * n_runs],
                         dtype="<u2").reshape(-1, 2).astype(np.int64)
    return runs[:, 0].repeat(runs[:, 1] + 1) + _ragged_arange(runs[:, 1] + 1)


class RoaringBitmapArray:
    """A set of uint64 row indexes (sorted, deduplicated numpy array)."""

    def __init__(self, values: Optional[np.ndarray] = None):
        if values is None or len(values) == 0:
            self.values = np.empty(0, dtype=np.uint64)
        else:
            self.values = np.unique(np.asarray(values, dtype=np.uint64))

    @property
    def cardinality(self) -> int:
        return int(self.values.shape[0])

    # -- 32-bit roaring ------------------------------------------------------

    @staticmethod
    def _layout32(values32: np.ndarray):
        """Sorted unique uint32 values -> (the bytes before the containers,
        the containers' bytes (uint8) with the array containers filled in,
        each bitmap container's start in them, the bitmap containers' lows
        (uint16, one container after another) and their counts). The
        bitmap containers are packed by K8 (`serialize_deltas`)."""
        high = (values32 >> np.uint32(16)).astype(np.uint16)
        low = (values32 & np.uint32(0xFFFF)).astype(np.uint16)
        keys, starts = np.unique(high, return_index=True)
        n = len(keys)
        bounds = np.append(starts, len(values32))
        header = struct.pack("<ii", SERIAL_COOKIE_NO_RUNCONTAINER, n)
        cards = np.diff(bounds)
        bitmap_mask = cards > ARRAY_MAX_CARD
        descr = np.empty((n, 2), dtype="<u2")
        descr[:, 0] = keys
        descr[:, 1] = (cards - 1).astype(np.uint16)
        sizes = np.where(bitmap_mask, BITMAP_BYTES, 2 * cards)
        c_offs = np.cumsum(sizes) - sizes  # container start within data
        data = np.zeros(int(sizes.sum()), np.uint8)
        ai = np.flatnonzero(~bitmap_mask)
        if len(ai):
            a_bytes = 2 * cards[ai]
            src = low[np.repeat(~bitmap_mask, cards)].astype(
                "<u2").view(np.uint8)
            data[np.repeat(c_offs[ai], a_bytes)
                 + _ragged_arange(a_bytes)] = src
        data_start = len(header) + 4 * n + 4 * n
        offsets = (data_start + c_offs).astype("<i4")
        head = bytes(header) + descr.tobytes() + offsets.tobytes()
        return (head, data, c_offs[bitmap_mask],
                low[np.repeat(bitmap_mask, cards)], cards[bitmap_mask])

    @staticmethod
    def _parse32_layout(buf: memoryview):
        """Header, descriptors and offsets of one 32-bit roaring blob.
        Returns (keys u16[n], cards i64[n], run_flags bool[n], starts
        i64[n] absolute payload offsets, sizes i64[n], consumed). Run
        containers need a short sequential walk: their payload length
        lives in the payload."""
        (cookie16,) = struct.unpack_from("<H", buf, 0)
        if cookie16 == SERIAL_COOKIE:
            (cookie,) = struct.unpack_from("<I", buf, 0)
            n = (cookie >> 16) + 1
            pos = 4
            run_bytes = (n + 7) // 8
            run_flags = np.unpackbits(
                np.frombuffer(buf[pos:pos + run_bytes], dtype=np.uint8),
                bitorder="little")[:n].astype(bool)
            pos += run_bytes
            has_offsets = n >= NO_OFFSET_THRESHOLD
        else:
            cookie32, n = struct.unpack_from("<ii", buf, 0)
            if cookie32 != SERIAL_COOKIE_NO_RUNCONTAINER:
                raise DeletionVectorError(f"bad roaring cookie {cookie32}")
            pos = 8
            run_flags = np.zeros(n, dtype=bool)
            has_offsets = True
        descr = np.frombuffer(buf[pos:pos + 4 * n], dtype="<u2").reshape(n, 2)
        keys = descr[:, 0].astype(np.uint16)
        cards = descr[:, 1].astype(np.int64) + 1
        pos += 4 * n
        if has_offsets:
            pos += 4 * n  # offsets are redundant for sequential reads
        sizes = np.where(cards > ARRAY_MAX_CARD, BITMAP_BYTES, 2 * cards)
        if run_flags.any():
            starts = np.empty(n, np.int64)
            p = pos
            for i in range(n):
                starts[i] = p
                if run_flags[i]:
                    (n_runs,) = struct.unpack_from("<H", buf, p)
                    sizes[i] = 2 + 4 * n_runs
                p += int(sizes[i])
            consumed = p
        else:
            starts = pos + np.cumsum(sizes) - sizes
            consumed = pos + int(sizes.sum())
        return keys, cards, run_flags, starts, sizes, consumed

    # -- 64-bit portable and the Delta blob --------------------------------

    def serialize_portable(self, device) -> bytes:
        """64-bit portable format (no Delta magic); bitmap containers are
        packed on `device`."""
        return serialize_deltas([self], device)[0][4:]

    @staticmethod
    def deserialize_portable(data: bytes) -> "RoaringBitmapArray":
        """A bitmap container counts its set bits, not its descriptor's
        cardinality, as the reference does."""
        window, is_bm, _, lens, lows, blocks = _containers(memoryview(data))
        at = np.cumsum(lens) - lens
        rank = np.cumsum(is_bm) - 1
        parts = []
        for c in range(len(window)):
            if is_bm[c]:
                low = np.flatnonzero(np.unpackbits(
                    blocks[rank[c]].view(np.uint8), bitorder="little"))
            else:
                low = lows[at[c]:at[c] + lens[c]]
            parts.append((np.uint64(window[c]) << np.uint64(16))
                         | low.astype(np.uint64))
        out = RoaringBitmapArray.__new__(RoaringBitmapArray)
        out.values = (np.concatenate(parts) if parts
                      else np.empty(0, np.uint64))  # sorted by construction
        return out

    def serialize_delta(self, device) -> bytes:
        return serialize_deltas([self], device)[0]

    @staticmethod
    def deserialize_delta(data: bytes) -> "RoaringBitmapArray":
        _check_magic(data)
        return RoaringBitmapArray.deserialize_portable(data[4:])


def checksum(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _check_magic(data: bytes) -> None:
    (magic,) = struct.unpack_from("<i", data, 0)
    if magic != DELTA_MAGIC:
        raise DeletionVectorError(f"bad deletion-vector magic {magic}")


# ------------------------------------------------- the batched pack (K8)


def _pack_plan(bitmaps):
    """The layouts of `bitmaps` (per bitmap, per 64-bit bucket: its key,
    `_layout32`'s bytes and bitmap slots), and the lows (int16) and
    counts of every bitmap container of all of them, in that order."""
    layouts, lows, lens = [], [], []
    for bm in bitmaps:
        v = bm.values
        high = (v >> np.uint64(32)).astype(np.uint32)
        low = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        keys, starts = np.unique(high, return_index=True)
        bounds = np.append(starts, len(v))
        buckets = []
        for i, key in enumerate(keys.tolist()):
            head, data, slots, b_lows, b_lens = RoaringBitmapArray._layout32(
                low[bounds[i]:bounds[i + 1]])
            buckets.append((key, head, data, slots))
            lows.append(b_lows)
            lens.append(b_lens)
        layouts.append(buckets)
    if not lens:
        return layouts, np.empty(0, np.int16), np.empty(0, np.int64)
    return layouts, np.concatenate(lows).view(np.int16), np.concatenate(lens)


def serialize_deltas(bitmaps, device) -> list:
    """The Delta blobs (bytes) of `bitmaps`: every bitmap container of all
    of them packed by one K8 launch on `device` (none when no container
    holds more than 4096 values)."""
    layouts, lows, lens = _pack_plan(bitmaps)
    if len(lens):
        words = dv_tiles(*upload((pack_tiles(lens), lows, np.zeros(
            (0, BITMAP_WORDS), np.int32)), device), len(lens) * BITMAP_WORDS,
            pack=True)
        blocks = words.cpu().numpy().view(np.uint8).reshape(-1, BITMAP_BYTES)
    out, c = [], 0
    for buckets in layouts:
        parts = [struct.pack("<iq", DELTA_MAGIC, len(buckets))]
        for key, head, data, slots in buckets:
            for s in slots.tolist():
                data[s:s + BITMAP_BYTES] = blocks[c]
                c += 1
            parts += [struct.pack("<I", key), head, data.tobytes()]
        out.append(b"".join(parts))
    return out


# ----------------------------------------------- the batched decode (K8)


def _containers(buf: memoryview):
    """The containers of a 64-bit portable bitmap (a Delta blob past its
    magic), parsed on the host: (window int64 [k],
    each container's 65,536-row window (bucket << 16 | key); is_bitmap
    and is_run bool [k]; lens int64 [k], each container's lows (0 for a
    bitmap); lows uint16, the array and run containers' low 16 bits, one
    container after another; blocks uint32 [b, 2048], the bitmap
    containers' words in container order). A bad cookie raises
    `DeletionVectorError`."""
    (n_buckets,) = struct.unpack_from("<q", buf, 0)
    pos = 8
    parts = []
    for _ in range(n_buckets):
        (bkey,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        sub = buf[pos:]
        keys, cards, run_flags, starts, _, consumed = (
            RoaringBitmapArray._parse32_layout(sub))
        pos += consumed
        if not len(keys):
            continue
        arr8 = np.frombuffer(sub[:consumed], np.uint8)
        is_bm = (cards > ARRAY_MAX_CARD) & ~run_flags
        lens = np.where(is_bm, 0, cards)
        if run_flags.any():  # a run's length lives in its payload
            pieces = []
            for i in range(len(keys)):
                s = int(starts[i])
                if run_flags[i]:
                    pieces.append(_run_lows(sub, s).astype(np.uint16))
                elif is_bm[i]:
                    pieces.append(np.empty(0, np.uint16))
                else:
                    pieces.append(arr8[s:s + 2 * int(cards[i])].view("<u2"))
            lens = np.array([len(p) for p in pieces], np.int64)
            lows = np.concatenate(pieces)
        else:
            a_bytes = 2 * lens
            lows = arr8[np.repeat(starts, a_bytes)
                        + _ragged_arange(a_bytes)].view("<u2")
        bi = np.flatnonzero(is_bm)
        blocks = np.ascontiguousarray(arr8[
            starts[bi][:, None] + np.arange(BITMAP_BYTES, dtype=np.int64)
        ]).view("<u4")
        parts.append(((np.int64(bkey) << np.int64(16))
                      | keys.astype(np.int64), is_bm, run_flags, lens,
                      lows.astype(np.uint16), blocks))
    if not parts:
        return (np.empty(0, np.int64), np.empty(0, bool), np.empty(0, bool),
                np.empty(0, np.int64), np.empty(0, np.uint16),
                np.empty((0, BITMAP_WORDS), np.uint32))
    return tuple(np.concatenate(c) for c in zip(*parts))


def _mask_plan(data: bytes):
    """A Delta blob's containers as the reference's decode lanes:
    (bit_idx int64 absolute rows of the array and run containers, each
    64-bit bucket's array containers before its run containers,
    bm_words uint32 raw bitmap-container words, 2048 per container,
    bm_base int64 each bitmap container's first word, n_words the words
    that cover the highest container)."""
    _check_magic(data)
    window, is_bm, is_run, lens, lows, blocks = _containers(
        memoryview(data)[4:])
    if not len(window):
        return (np.empty(0, np.int64), np.empty(0, np.uint32),
                np.empty(0, np.int64), 0)
    base = window << np.int64(16)
    at = np.cumsum(lens) - lens
    order = np.lexsort((np.arange(len(window)), is_run, window >> 16))
    order = order[~is_bm[order]]
    bit_idx = (np.repeat(base[order], lens[order])
               + lows[np.repeat(at[order], lens[order])
                      + _ragged_arange(lens[order])].astype(np.int64))
    return (bit_idx, blocks.reshape(-1), base[is_bm] >> np.int64(5),
            int((window.max() + 1) * BITMAP_WORDS))


def _popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(words).view(
        np.uint8)).sum())


_PLAN_NS = obs.counter("dv.decode_plan_ns")
_UPLOAD_NS = obs.counter("dv.decode_upload_ns")
_LAUNCH_NS = obs.counter("dv.decode_launch_ns")
_D2H_NS = obs.counter("dv.decode_d2h_ns")
_SPLIT_NS = obs.counter("dv.decode_split_ns")


def _plan(blobs, row_counts):
    """K8's tiles for the masks of `blobs` over files of `row_counts` rows
    (module docstring): (tiles, lows int16, bitmap words int32 [c, 2048],
    the output words, and per blob (its first word, its words, its
    rows, the bits counted on the host))."""
    tiles, lows, blocks, segs = [], [], [], []
    out_words = n_lows = n_bm = 0
    for data, n in zip(blobs, row_counts):
        _check_magic(data)
        window, is_bm, _, lens, c_lows, c_blocks = _containers(
            memoryview(data)[4:])
        n = int(n)
        n_words = -(-n // 32)
        n_win = -(-n_words // BITMAP_WORDS)
        # each container's words below the file's rows
        cut = np.clip(n_words - window * BITMAP_WORDS, 0, BITMAP_WORDS)
        low_of = np.repeat(np.arange(len(window)), lens)
        keep = (c_lows >> 5) < cut[low_of]
        above = int(np.count_nonzero(~keep))
        b_cut = cut[is_bm]
        above += sum(_popcount(c_blocks[i, b_cut[i]:])
                     for i in np.flatnonzero(b_cut < BITMAP_WORDS).tolist())
        # one bitmap a tile: any other in its window joins the lows
        b_win = window[is_bm]
        first = np.zeros(len(b_win), bool)
        first[np.unique(b_win, return_index=True)[1]] = True
        as_bm = first & (b_cut > 0)
        low_win, low_val = [window[low_of[keep]]], [c_lows[keep]]
        for i in np.flatnonzero(~first & (b_cut > 0)).tolist():
            extra = np.flatnonzero(np.unpackbits(
                c_blocks[i].view(np.uint8), bitorder="little"))
            extra = extra[(extra >> 5) < b_cut[i]]
            low_win.append(np.full(len(extra), b_win[i]))
            low_val.append(extra.astype(np.uint16))
        low_win, low_val = np.concatenate(low_win), np.concatenate(low_val)
        order = np.argsort(low_win, kind="stable")
        w = np.arange(n_win, dtype=np.int64)
        edges = n_lows + np.searchsorted(low_win[order], np.arange(n_win + 1))
        bm = np.full(n_win, -1, np.int64)
        bm[b_win[as_bm]] = n_bm + np.arange(int(as_bm.sum()))
        seg = -(-n_words // 4) * 4  # 16-byte aligned segments
        tiles.append(tile_table(
            out_words + w * BITMAP_WORDS,
            np.minimum(BITMAP_WORDS, seg - w * BITMAP_WORDS), bm,
            edges[:-1], edges[1:]))
        lows.append(low_val[order])
        blocks.append(c_blocks[as_bm])
        segs.append((out_words, n_words, n, above))
        out_words += seg
        n_lows += len(low_val)
        n_bm += int(as_bm.sum())
    if not segs:
        return (np.empty((0, TILE_FIELDS), np.int32), np.empty(0, np.int16),
                np.empty((0, BITMAP_WORDS), np.int32), 0, segs)
    return (np.concatenate(tiles), np.concatenate(lows).view(np.int16),
            np.concatenate(blocks).view(np.int32), out_words, segs)


def decode_delta_masks(blobs, row_counts, device) -> list:
    """Delta blobs -> [(deleted-row mask bool [n], cardinality)] for files
    of `row_counts` rows: one host plan of all their containers, one
    upload, one K8 launch on `device` and one copy of the words back, then
    the masks split on the host. K8 expands the lanes of each file's
    first ceil(n / 32) words; the cardinality counts every decoded bit,
    those at or past `n` too (the lanes past the words counted on the
    host), so the descriptor's check does not depend on the file's row
    count."""
    device = torch.device(device)
    t0 = time.perf_counter_ns()
    tiles, lows, bm_words, n_words, segs = _plan(blobs, row_counts)
    t1 = time.perf_counter_ns()
    _PLAN_NS.inc(t1 - t0)
    words = np.zeros(0, np.int32)
    if len(tiles):
        on = upload((tiles, lows, bm_words), device)
        t2 = time.perf_counter_ns()
        words = dv_tiles(*on, n_words, n_dvs=len(segs))
        t3 = time.perf_counter_ns()
        if device.type == "cuda":
            host = torch.empty(n_words, dtype=torch.int32, pin_memory=True)
            host.copy_(words, non_blocking=True)
            torch.cuda.current_stream(device).synchronize()
            words = host
        words = words.numpy()
        t4 = time.perf_counter_ns()
        _UPLOAD_NS.inc(t2 - t1)
        _LAUNCH_NS.inc(t3 - t2)
        _D2H_NS.inc(t4 - t3)
        t1 = t4
    out = []
    for start, n_w, n, above in segs:
        bits = np.unpackbits(words[start:start + n_w].view(np.uint8),
                             bitorder="little")
        out.append((bits[:n].view(np.bool_),
                    int(np.count_nonzero(bits)) + above))
    _SPLIT_NS.inc(time.perf_counter_ns() - t1)
    return out


def decode_delta_mask(data: bytes, n: int, device) -> tuple[np.ndarray, int]:
    """A Delta blob -> (deleted-row mask bool [n], cardinality): a batch
    of one (`decode_delta_masks`)."""
    return decode_delta_masks([data], [n], device)[0]

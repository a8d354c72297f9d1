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
the reference's; its bitmap containers are packed by K8 on the given
device (`ops/dv_bits.py::pack_bitmap_words`). The reader takes all three
container types. `decode_delta_mask` turns a blob into a file's deleted-
row mask: the container headers are parsed on the host into K8's lanes
(`_mask_plan`), K8 expands the lanes below the file's row count into
words on the device, and the mask and the cardinality come from those
words there; lanes past the file's rows are counted on the host.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch

from delta_tpu_torch.errors import DeletionVectorError
from delta_tpu_torch.ops.dv_bits import (
    BITMAP_WORDS,
    decode_mask_words,
    pack_bitmap_words,
)
from delta_tpu_torch.ops.replay import unpack_bits

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
    def _serialize32(values32: np.ndarray, device) -> bytes:
        """Sorted unique uint32 values -> portable bytes; the bitmap
        containers (cardinality > 4096) are packed by K8 on `device` in one
        launch."""
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
        bi = np.flatnonzero(bitmap_mask)
        if len(bi):
            sel = np.repeat(bitmap_mask, cards)
            rank = np.cumsum(bitmap_mask) - 1  # bitmap container per key
            flat = (np.repeat(rank, cards)[sel].astype(np.int64) * 65536
                    + low[sel].astype(np.int64))
            words = pack_bitmap_words(
                torch.from_numpy(flat).to(device), len(bi))
            blocks = words.cpu().numpy().astype("<i4").view(
                np.uint8).reshape(len(bi), BITMAP_BYTES)
            data[c_offs[bi][:, None]
                 + np.arange(BITMAP_BYTES, dtype=np.int64)] = blocks
        data_start = len(header) + 4 * n + 4 * n
        offsets = (data_start + c_offs).astype("<i4")
        return (bytes(header) + descr.tobytes() + offsets.tobytes()
                + data.tobytes())

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

    @staticmethod
    def _deserialize32(buf: memoryview) -> tuple[np.ndarray, int]:
        """Returns (sorted uint32 values, bytes consumed). A bitmap
        container counts its set bits, not its descriptor's cardinality,
        as the reference does."""
        keys, cards, run_flags, starts, _, consumed = (
            RoaringBitmapArray._parse32_layout(buf))
        arr8 = np.frombuffer(buf[:consumed], np.uint8)
        key32 = keys.astype(np.uint32) << np.uint32(16)
        is_bm = (cards > ARRAY_MAX_CARD) & ~run_flags
        parts = []
        for i in range(len(keys)):
            s = int(starts[i])
            if run_flags[i]:
                lows = _run_lows(buf, s).astype(np.uint32)
            elif is_bm[i]:
                lows = np.flatnonzero(np.unpackbits(
                    arr8[s:s + BITMAP_BYTES], bitorder="little")
                ).astype(np.uint32)
            else:
                lows = arr8[s:s + 2 * int(cards[i])].view("<u2").astype(
                    np.uint32)
            parts.append(key32[i] | lows)
        values = (np.concatenate(parts) if parts
                  else np.empty(0, np.uint32))
        return values, consumed

    # -- 64-bit portable and the Delta blob --------------------------------

    def serialize_portable(self, device) -> bytes:
        """64-bit portable format (no Delta magic); bitmap containers are
        packed on `device`."""
        v = self.values
        high = (v >> np.uint64(32)).astype(np.uint32)
        low = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        keys, starts = np.unique(high, return_index=True)
        bounds = np.append(starts, len(v))
        out = [struct.pack("<q", len(keys))]
        for i, key in enumerate(keys):
            out.append(struct.pack("<I", int(key)))
            out.append(self._serialize32(low[bounds[i]:bounds[i + 1]],
                                         device))
        return b"".join(out)

    @staticmethod
    def deserialize_portable(data: bytes) -> "RoaringBitmapArray":
        buf = memoryview(data)
        (n_buckets,) = struct.unpack_from("<q", buf, 0)
        pos = 8
        parts = []
        for _ in range(n_buckets):
            (key,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            lows, used = RoaringBitmapArray._deserialize32(buf[pos:])
            pos += used
            parts.append((np.uint64(key) << np.uint64(32))
                         | lows.astype(np.uint64))
        out = RoaringBitmapArray.__new__(RoaringBitmapArray)
        out.values = (np.concatenate(parts) if parts
                      else np.empty(0, np.uint64))  # sorted by construction
        return out

    def serialize_delta(self, device) -> bytes:
        return struct.pack("<i", DELTA_MAGIC) + self.serialize_portable(device)

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


# ------------------------------------------------------- the mask decode


def _mask_plan(data: bytes):
    """The container headers of a Delta blob parsed into K8's lanes:
    (bit_idx int64 absolute rows of the array and run containers,
    bm_words uint32 raw bitmap-container words, 2048 per container,
    bm_base int64 each bitmap container's first word, n_words the words
    that cover the highest container). A bad magic or cookie raises
    `DeletionVectorError`."""
    _check_magic(data)
    buf = memoryview(data)[4:]
    (n_buckets,) = struct.unpack_from("<q", buf, 0)
    pos = 8
    idx_parts, word_parts, wbase_parts = [], [], []
    n_words = 0
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
        # absolute row base per container: (bucket << 32) | (key << 16)
        base = (np.int64(bkey) << np.int64(32)) | (
            keys.astype(np.int64) << np.int64(16))
        n_words = max(n_words, -(-(int(base.max()) + 65536) // 32))
        is_bm = (cards > ARRAY_MAX_CARD) & ~run_flags
        ai = np.flatnonzero(~is_bm & ~run_flags)
        if len(ai):
            a_lens = cards[ai]
            lows = arr8[np.repeat(starts[ai], 2 * a_lens)
                        + _ragged_arange(2 * a_lens)].view("<u2")
            idx_parts.append(np.repeat(base[ai], a_lens)
                             + lows.astype(np.int64))
        bi = np.flatnonzero(is_bm)
        if len(bi):
            blk = arr8[starts[bi][:, None]
                       + np.arange(BITMAP_BYTES, dtype=np.int64)]
            word_parts.append(
                np.ascontiguousarray(blk).view("<u4").reshape(-1))
            wbase_parts.append(base[bi] >> np.int64(5))
        for i in np.flatnonzero(run_flags).tolist():
            idx_parts.append(base[i] + _run_lows(sub, int(starts[i])))
    bit_idx = (np.concatenate(idx_parts) if idx_parts
               else np.empty(0, np.int64))
    bm_words = (np.concatenate(word_parts) if word_parts
                else np.empty(0, np.uint32))
    bm_base = (np.concatenate(wbase_parts) if wbase_parts
               else np.empty(0, np.int64))
    return bit_idx, bm_words, bm_base, int(n_words)


def _popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(words).view(
        np.uint8)).sum())


def decode_delta_mask(data: bytes, n: int, device) -> tuple[np.ndarray, int]:
    """A Delta blob -> (deleted-row mask bool [n], cardinality). K8 expands
    the lanes of the first ceil(n / 32) words on `device`; the mask and
    their popcount come from those words there. The cardinality counts
    every decoded bit, the rows at or past `n` too (the lanes past the
    words counted on the host: their indexes, and their bitmap words'
    set bits), so the descriptor's cardinality check does not depend on
    the file's row count."""
    bit_idx, bm_words, bm_base, _ = _mask_plan(data)
    n_words = -(-int(n) // 32)
    blocks = bm_words.reshape(-1, BITMAP_WORDS)
    # the words of each bitmap container that lie below n_words
    cut = np.clip(n_words - bm_base, 0, BITMAP_WORDS)
    above = int(np.count_nonzero(bit_idx >= n_words * 32)) + sum(
        _popcount(blocks[c, cut[c]:])
        for c in np.flatnonzero(cut < BITMAP_WORDS).tolist())
    below = cut > 0
    words = decode_mask_words(
        torch.from_numpy(bit_idx).to(device),
        torch.from_numpy(blocks[below].reshape(-1).view(np.int32)).to(device),
        torch.from_numpy(bm_base[below].astype(np.int32)).to(device),
        n_words)
    bits = unpack_bits(words, n_words * 32)
    card = int(bits.sum()) + above
    return bits[:n].cpu().numpy(), card

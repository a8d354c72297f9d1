"""The roaring bit scatter of deletion vectors: kernel K8 and its plain
version.

Counterpart of queue B's B7, the jnp functions `_pack_fn_cached` and
`_decode_fn_cached` of `delta_tpu/ops/stats.py:231-336` (behind
`pack_bitmap_words` and `decode_mask_words`). Both compute one scatter-OR
of bits and bitmap words into a zeroed stream of u32 words (carried as
int32 bit patterns, `ops/u32.py`).

`dv_tiles(tiles, lows, bm_words, n_words)` computes it for a whole batch
of deletion vectors in one launch. The stream is cut into tiles of at
most 2048 words, one roaring container's 65,536 rows each; a tile (int32
[5]) is its first output word, its valid words, the bitmap container it
starts from (an index into `bm_words`, int32 [C, 2048], or -1), and the
range [lo, hi) of its lows (`lows`, int16 bit patterns of u16: the low 16
bits of an array or run container's values). Its words are the bitmap's
(or zeros) with bit `low & 31` of word `low >> 5` set for each low; a low
at or past the valid words drops. The tiles must cover each of the
`n_words` words exactly once: the functions here and in `dv/roaring.py`
that make tiles see to it. `dv/roaring.py::decode_delta_masks` decodes
every deletion vector a command reads in one such launch,
`serialize_deltas` packs every bitmap container it writes in another.

`decode_mask_words(bit_idx, bm_words, bm_base, n_words)` and
`pack_bitmap_words(flat_bits, n_containers)` keep the lane form of the
reference (int64 absolute bits, sentinels dropped, repeated bits ORed;
bitmap containers at word offsets `bm_base`) as a batch of one: a host
helper builds their tiles (`tiles_from_lanes`).

On a CUDA tensor the wrappers launch K8 (`csrc/dv_bits.cu`: one kernel on
the current stream, no memset, no synchronization) or raise; on a CPU
tensor they run the plain version (`dv_tiles_plain`), which carries the
words in int64 (torch has no u32 shifts on the CPU).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build
from delta_tpu_torch.ops.u32 import to_i32_bits, widen_u32

BITMAP_WORDS = 2048  # an 8192-byte roaring bitmap container, in u32 words
TILE_FIELDS = 5      # first word, valid words, bitmap index, lows lo, hi
PACK_LAUNCHES = obs.counter("kernel.dv_bits.pack_launches")
DECODE_LAUNCHES = obs.counter("kernel.dv_bits.decode_launches")
DECODE_DVS = obs.counter("kernel.dv_bits.decode_dvs")  # DVs those covered
_LAUNCH = None  # (K8's C entry point, the raw-stream getter), on first use


def _check_tiles(tiles: torch.Tensor, lows: torch.Tensor,
                 bm_words: torch.Tensor, n_words: int) -> None:
    if tiles.dtype != torch.int32 or tiles.dim() != 2 \
            or tiles.shape[1] != TILE_FIELDS:
        raise ValueError(f"dv_tiles takes int32 [t, 5] tiles, got "
                         f"{tiles.dtype} {tuple(tiles.shape)}")
    if lows.dtype != torch.int16 or lows.dim() != 1:
        raise ValueError(f"dv_tiles takes int16 [n] lows, got {lows.dtype} "
                         f"{tuple(lows.shape)}")
    if bm_words.dtype != torch.int32 or bm_words.dim() != 2 \
            or bm_words.shape[1] != BITMAP_WORDS:
        raise ValueError(f"dv_tiles takes int32 [c, 2048] bitmap words, got "
                         f"{bm_words.dtype} {tuple(bm_words.shape)}")
    if not tiles.device == lows.device == bm_words.device:
        raise ValueError("dv_tiles: the inputs lie on different devices")
    if not 0 <= n_words < 1 << 31:
        raise ValueError(f"dv_tiles: {n_words} words is outside [0, 2^31)")


def dv_tiles_plain(tiles: torch.Tensor, lows: torch.Tensor,
                   bm_words: torch.Tensor, n_words: int) -> torch.Tensor:
    """K8's function in plain PyTorch, on CPU tensors: int32 [n_words]. A
    tile's fields are clamped into their ranges as the kernel clamps
    them."""
    _check_tiles(tiles, lows, bm_words, n_words)
    if tiles.device.type != "cpu":
        raise ValueError("dv_tiles_plain runs on the CPU; a CUDA tensor "
                         "goes to dv_tiles")
    dev = tiles.device
    t = tiles.to(torch.int64)
    off, valid, bm, lo, hi = t.unbind(1)
    valid = torch.minimum(valid.clamp(max=BITMAP_WORDS), n_words - off)
    live = (off >= 0) & (off < n_words) & (valid > 0)
    valid = torch.where(live, valid, 0)
    words = torch.zeros(n_words, dtype=torch.int64, device=dev)
    # bitmap words: each tile owns its words, so they are assigned
    has = live & (bm >= 0) & (bm < bm_words.shape[0])
    j = torch.arange(BITMAP_WORDS, device=dev)
    sel = j < valid[has, None]
    words[(off[has, None] + j)[sel]] = widen_u32(bm_words[bm[has]][sel])
    # lows: each distinct bit once, so that adding its power of two is exact
    lo = lo.clamp(min=0)
    n = torch.where(live, hi.clamp(max=lows.shape[0]) - lo, 0).clamp(min=0)
    tile_of = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
    at = torch.arange(int(n.sum()), device=dev) + (lo - (n.cumsum(0) - n)
                                                   ).repeat_interleave(n)
    low = lows[at].to(torch.int64) & 0xFFFF
    keep = (low >> 5) < valid[tile_of]
    bits = torch.unique(off[tile_of][keep] * 32 + low[keep])
    ors = torch.zeros(n_words, dtype=torch.int64, device=dev)
    ors.scatter_add_(0, bits >> 5, torch.ones_like(bits) << (bits & 31))
    return to_i32_bits(words | ors)


def dv_tiles(tiles: torch.Tensor, lows: torch.Tensor, bm_words: torch.Tensor,
             n_words: int, *, pack: bool = False,
             n_dvs: int = 1) -> torch.Tensor:
    """K8 over a batch of tiles (module docstring): int32 [n_words] on the
    inputs' device. `pack` says whose launch it is (the pack or the decode
    counter); `n_dvs`, the deletion vectors a decode covers."""
    global _LAUNCH
    _check_tiles(tiles, lows, bm_words, n_words)
    if tiles.device.type == "cpu":
        return dv_tiles_plain(tiles, lows, bm_words, n_words)
    if tiles.device.type != "cuda":
        raise ValueError(f"dv_tiles: unsupported device {tiles.device}")
    index = tiles.get_device()
    words = torch.empty(n_words, dtype=torch.int32, device=index)
    if n_words == 0 or tiles.shape[0] == 0:
        return words
    tiles, lows, bm_words = (t.contiguous() for t in (tiles, lows, bm_words))
    if _LAUNCH is None:
        _LAUNCH = (cuda_build.function(
            "dv_bits", "dv_tiles_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]),
            torch._C._cuda_getCurrentRawStream)
    launch, raw_stream = _LAUNCH
    code = launch(tiles.data_ptr(), tiles.shape[0], lows.data_ptr(),
                  lows.shape[0], bm_words.data_ptr(), bm_words.shape[0],
                  words.data_ptr(), n_words, index, raw_stream(index))
    cuda_build.check_launch(code, "dv_bits")
    if pack:
        PACK_LAUNCHES.inc()
    else:
        DECODE_LAUNCHES.inc()
        DECODE_DVS.inc(n_dvs)
    return words


# ------------------------------------------------------------ host side


def upload(arrays, device) -> list:
    """Numpy arrays -> tensors of the same dtypes and shapes on `device`,
    through one staging buffer (pinned for a card, each array 16-byte
    aligned in it) and one host-to-device copy on the current stream."""
    device = torch.device(device)
    arrays = [np.ascontiguousarray(a) for a in arrays]
    starts, size = [], 0
    for a in arrays:
        starts.append(size)
        size += -(-a.nbytes // 16) * 16
    stage = torch.empty(size, dtype=torch.uint8,
                        pin_memory=device.type == "cuda")
    flat = stage.numpy()
    for a, s in zip(arrays, starts):
        flat[s:s + a.nbytes] = a.reshape(-1).view(np.uint8)
    on = stage.to(device, non_blocking=True) if device.type == "cuda" \
        else stage
    return [on[s:s + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, s in zip(arrays, starts)]


def tile_table(off, valid, bm, lo, hi) -> np.ndarray:
    """int32 [t, 5] tiles from their five columns."""
    cols = [np.asarray(c, np.int64) for c in (off, valid, bm, lo, hi)]
    return np.stack(cols, 1).astype(np.int32).reshape(-1, TILE_FIELDS)


def _lows(bits: np.ndarray) -> np.ndarray:
    return (bits & 0xFFFF).astype(np.uint16).view(np.int16)


def pack_tiles(lens: np.ndarray) -> np.ndarray:
    """The tiles of a pack: container c (its lows the c-th run of `lens`
    in the lows) into words [c * 2048, (c + 1) * 2048)."""
    lens = np.asarray(lens, np.int64)
    c = np.arange(len(lens), dtype=np.int64)
    hi = np.cumsum(lens)
    return tile_table(c * BITMAP_WORDS, np.full(len(lens), BITMAP_WORDS),
                      np.full(len(lens), -1), hi - lens, hi)


def tiles_from_lanes(bit_idx: np.ndarray, bm_words: np.ndarray,
                     bm_base: np.ndarray, n_words: int):
    """The reference's lane form as tiles over one stream of `n_words`
    words: (tiles, lows int16, bitmap words int32 [c, 2048]). A bitmap
    container that starts on a window's first word becomes that tile's
    bitmap (the first of several there); any other is expanded to its set
    bits, which join the indexes."""
    n_tiles = -(-n_words // BITMAP_WORDS)
    blocks = np.asarray(bm_words, np.int32).reshape(-1, BITMAP_WORDS)
    base = np.asarray(bm_base, np.int64)
    win = base // BITMAP_WORDS
    first = np.zeros(len(base), bool)
    aligned = (base % BITMAP_WORDS == 0) & (win >= 0) & (win < n_tiles)
    first[np.unique(np.where(aligned, win, -1), return_index=True)[1]] = True
    as_bitmap = aligned & first
    bits = [np.asarray(bit_idx, np.int64)]
    rest = np.flatnonzero(~as_bitmap)
    if len(rest):
        set_bits = np.unpackbits(blocks[rest].view(np.uint8), axis=1,
                                 bitorder="little").astype(bool)
        c, b = np.nonzero(set_bits)
        bits.append(base[rest][c] * 32 + b)
    bits = np.concatenate(bits)
    bits = np.unique(bits[(bits >= 0) & (bits < n_words * 32)])
    w = np.arange(n_tiles, dtype=np.int64)
    bm = np.full(n_tiles, -1, np.int64)
    bm[win[as_bitmap]] = np.arange(int(as_bitmap.sum()))
    edges = np.searchsorted(bits >> 16, np.arange(n_tiles + 1))
    tiles = tile_table(w * BITMAP_WORDS,
                       np.minimum(BITMAP_WORDS, n_words - w * BITMAP_WORDS),
                       bm, edges[:-1], edges[1:])
    return tiles, _lows(bits), blocks[as_bitmap]


def _check_lanes(bit_idx: torch.Tensor, bm_words: torch.Tensor,
                 bm_base: torch.Tensor, n_words: int) -> None:
    if bit_idx.dtype != torch.int64 or bit_idx.dim() != 1:
        raise ValueError(f"dv_bits takes int64 [n] bit indexes, got "
                         f"{bit_idx.dtype} {tuple(bit_idx.shape)}")
    if (bm_words.dtype != torch.int32 or bm_base.dtype != torch.int32
            or bm_words.dim() != 1 or bm_base.dim() != 1
            or bm_words.shape[0] != bm_base.shape[0] * BITMAP_WORDS):
        raise ValueError(
            f"dv_bits takes int32 [c * 2048] bitmap words and int32 [c] "
            f"container offsets, got {bm_words.dtype} "
            f"{tuple(bm_words.shape)}, {bm_base.dtype} "
            f"{tuple(bm_base.shape)}")
    if not bit_idx.device == bm_words.device == bm_base.device:
        raise ValueError("dv_bits: the lanes lie on different devices")
    if not 0 <= n_words < 1 << 31:
        raise ValueError(f"dv_bits: {n_words} words is outside [0, 2^31)")


def _decode_lanes(bit_idx, bm_words, bm_base, n_words,
                  plain: bool) -> torch.Tensor:
    _check_lanes(bit_idx, bm_words, bm_base, n_words)
    planned = tiles_from_lanes(bit_idx.cpu().numpy(), bm_words.cpu().numpy(),
                               bm_base.cpu().numpy(), n_words)
    if plain:
        return dv_tiles_plain(*upload(planned, "cpu"), n_words)
    return dv_tiles(*upload(planned, bit_idx.device), n_words)


def _pack_lanes(flat_bits, n_containers, plain: bool) -> torch.Tensor:
    n_words = n_containers * BITMAP_WORDS
    _check_lanes(flat_bits, _no_words(flat_bits), _no_words(flat_bits),
                 n_words)
    flat = flat_bits.cpu().numpy()
    flat = np.unique(flat[(flat >= 0) & (flat < n_words * 32)])
    lens = np.bincount(flat >> 16, minlength=n_containers)
    planned = (pack_tiles(lens), _lows(flat),
               np.zeros((0, BITMAP_WORDS), np.int32))
    if plain:
        return dv_tiles_plain(*upload(planned, "cpu"), n_words)
    return dv_tiles(*upload(planned, flat_bits.device), n_words, pack=True)


def _no_words(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.int32, device=like.device)


def pack_bitmap_words_plain(flat_bits: torch.Tensor,
                            n_containers: int) -> torch.Tensor:
    """`pack_bitmap_words` by the plain version, on the CPU."""
    return _pack_lanes(flat_bits, n_containers, plain=True)


def pack_bitmap_words(flat_bits: torch.Tensor,
                      n_containers: int) -> torch.Tensor:
    """Container-relative bits (int64: container * 65536 + low 16 bits)
    packed into `n_containers` roaring bitmap containers: int32
    [n_containers * 2048] words on the bits' device, little-endian bit
    order, so the words' bytes are the containers' serialized bytes."""
    return _pack_lanes(flat_bits, n_containers, plain=False)


def decode_mask_words_plain(bit_idx: torch.Tensor, bm_words: torch.Tensor,
                            bm_base: torch.Tensor,
                            n_words: int) -> torch.Tensor:
    """`decode_mask_words` by the plain version, on the CPU."""
    return _decode_lanes(bit_idx, bm_words, bm_base, n_words, plain=True)


def decode_mask_words(bit_idx: torch.Tensor, bm_words: torch.Tensor,
                      bm_base: torch.Tensor, n_words: int) -> torch.Tensor:
    """A deletion vector's words: absolute row bits `bit_idx` (int64, from
    array and run containers) and the words `bm_words` of bitmap
    containers (2048 each) that start at word offsets `bm_base` (both
    int32), ORed into int32 [n_words] on the lanes' device; lanes past
    `n_words` words drop."""
    return _decode_lanes(bit_idx, bm_words, bm_base, n_words, plain=False)

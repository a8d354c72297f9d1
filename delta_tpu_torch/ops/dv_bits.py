"""The roaring bit scatter of deletion vectors: kernel K8 and its plain
version.

Counterpart of queue B's B7, the jnp functions `_pack_fn_cached` and
`_decode_fn_cached` of `delta_tpu/ops/stats.py:231-336` (behind
`pack_bitmap_words` and `decode_mask_words`). Both compute one scatter-OR
into a zeroed stream of `n_words` u32 words (carried as int32 bit
patterns, `ops/u32.py`):

- a bit index `i` (int64) sets bit `i & 31` of word `i >> 5`;
- bitmap word `j` (int32 bits) of container `j // 2048` ORs into word
  `base[j // 2048] + j % 2048`, the container's offset (int32) plus the
  word's place in it;
- an index outside [0, n_words * 32) and a position outside
  [0, n_words) drop (the reference's sentinels, and the lanes past a
  file's rows).

`pack_bitmap_words(flat_bits, n_containers)` is the case with no bitmap
lanes: container-relative bits (container * 65536 + low 16 bits) into
`n_containers` stacked 2048-word roaring bitmap containers.
`decode_mask_words(bit_idx, bm_words, bm_base, n_words)` expands a stored
deletion vector's array/run bits and raw bitmap containers into its row
words. The reference gives each bitmap word its own position; here one
offset per container does, so no per-word lane is built or moved.

Both take their lanes on the engine's device: on a CUDA tensor they launch
K8 (`csrc/dv_bits.cu`: a memset and one kernel on the current stream, no
synchronization), or raise; on a CPU tensor they run the plain version,
which carries the words in int64 (torch has no u32 shifts on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build
from delta_tpu_torch.ops.u32 import to_i32_bits, widen_u32

BITMAP_WORDS = 2048  # an 8192-byte roaring bitmap container, in u32 words
PACK_LAUNCHES = obs.counter("kernel.dv_bits.pack_launches")
DECODE_LAUNCHES = obs.counter("kernel.dv_bits.decode_launches")
_LAUNCH = None  # (K8's C entry point, the raw-stream getter), on first use


def _check(bit_idx: torch.Tensor, bm_words: torch.Tensor,
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


def _scatter_plain(bit_idx: torch.Tensor, bm_words: torch.Tensor,
                   bm_base: torch.Tensor, n_words: int) -> torch.Tensor:
    """K8's function in plain PyTorch: int32 [n_words]."""
    dev = bit_idx.device
    idx = bit_idx[(bit_idx >= 0) & (bit_idx < n_words * 32)]
    pos = (bm_base.to(torch.int64)[:, None] + torch.arange(
        BITMAP_WORDS, dtype=torch.int64, device=dev)).reshape(-1)
    keep = (pos >= 0) & (pos < n_words)
    pos, w = pos[keep], widen_u32(bm_words[keep])
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    set_bits = ((w[:, None] >> shifts) & 1).to(torch.bool)
    from_words = (pos[:, None] * 32 + shifts)[set_bits]
    # OR: each set bit once, so that adding its power of two is exact
    bits = torch.unique(torch.cat([idx, from_words]))
    words = torch.zeros(n_words, dtype=torch.int64, device=dev)
    words.scatter_add_(0, bits >> 5, torch.ones_like(bits) << (bits & 31))
    return to_i32_bits(words)


def _scatter(bit_idx: torch.Tensor, bm_words: torch.Tensor,
             bm_base: torch.Tensor, n_words: int,
             counter: obs.Counter) -> torch.Tensor:
    global _LAUNCH
    _check(bit_idx, bm_words, bm_base, n_words)
    if bit_idx.device.type == "cpu":
        return _scatter_plain(bit_idx, bm_words, bm_base, n_words)
    if bit_idx.device.type != "cuda":
        raise ValueError(f"dv_bits: unsupported device {bit_idx.device}")
    index = bit_idx.get_device()
    words = torch.empty(n_words, dtype=torch.int32, device=index)
    if n_words == 0:
        return words
    bit_idx, bm_words, bm_base = (t.contiguous()
                                  for t in (bit_idx, bm_words, bm_base))
    if _LAUNCH is None:
        _LAUNCH = (cuda_build.function(
            "dv_bits", "dv_bits_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
            torch._C._cuda_getCurrentRawStream)
    launch, raw_stream = _LAUNCH
    code = launch(bit_idx.data_ptr(), bit_idx.shape[0], bm_words.data_ptr(),
                  bm_base.data_ptr(), bm_words.shape[0], words.data_ptr(),
                  n_words, index, raw_stream(index))
    cuda_build.check_launch(code, "dv_bits")
    counter.inc()
    return words


def _no_words(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.int32, device=like.device)


def pack_bitmap_words_plain(flat_bits: torch.Tensor,
                            n_containers: int) -> torch.Tensor:
    e = _no_words(flat_bits)
    _check(flat_bits, e, e, n_containers * BITMAP_WORDS)
    return _scatter_plain(flat_bits, e, e, n_containers * BITMAP_WORDS)


def pack_bitmap_words(flat_bits: torch.Tensor,
                      n_containers: int) -> torch.Tensor:
    """Container-relative bits (int64: container * 65536 + low 16 bits)
    packed into `n_containers` roaring bitmap containers: int32
    [n_containers * 2048] words on the bits' device, little-endian bit
    order, so the words' bytes are the containers' serialized bytes."""
    e = _no_words(flat_bits)
    return _scatter(flat_bits, e, e, n_containers * BITMAP_WORDS,
                    PACK_LAUNCHES)


def decode_mask_words_plain(bit_idx: torch.Tensor, bm_words: torch.Tensor,
                            bm_base: torch.Tensor,
                            n_words: int) -> torch.Tensor:
    _check(bit_idx, bm_words, bm_base, n_words)
    return _scatter_plain(bit_idx, bm_words, bm_base, n_words)


def decode_mask_words(bit_idx: torch.Tensor, bm_words: torch.Tensor,
                      bm_base: torch.Tensor, n_words: int) -> torch.Tensor:
    """A deletion vector's words: absolute row bits `bit_idx` (int64, from
    array and run containers) and the words `bm_words` of bitmap
    containers (2048 each) that start at word offsets `bm_base` (both
    int32), ORed into int32 [n_words] on the lanes' device; lanes past
    `n_words` words drop."""
    return _scatter(bit_idx, bm_words, bm_base, n_words, DECODE_LAUNCHES)

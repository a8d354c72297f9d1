"""Parquet bit-packed group decode: kernel K5 and its plain version.

Counterpart of `delta_tpu/ops/pallas_kernels.py:226-325`
(`_check_unpack_width`, `unpack_bitpacked_tiled`, the TPU kernel B4, its
wrapper `unpack_bitpacked`, and the jnp twin `_unpack_jnp`). One Parquet
bit-packed group is 32 values of w bits in w little-endian u32 words;
value j of a group is the w bits at bit offset j * w: word j * w // 32
shifted right by j * w % 32, OR'd with the next word shifted left when
the value straddles it, masked to w bits.

`unpack_bitpacked_words(packed, w)` takes the words word-major, int32
bit patterns [w, G] (`packed[k, g]` = word k of group g; any G), and
returns the G * 32 values group-major (value j of group g at g * 32 + j),
int32 bit patterns. On a CUDA tensor it launches K5
(`csrc/unpack_bitpacked.cu`) on the current stream, or raises; on a CPU
tensor it runs `unpack_bitpacked_plain`, the same loop in torch over
int64 lanes (torch has no u32 shifts on the CPU).

`unpack_bitpacked(packed_words, w, n_groups, device)` is the wrapper's
counterpart: a flat group-major u32 word stream in, n_groups * 32 values
out on `device` (the card unless the caller passes "cpu"); w == 0 gives
zeros, and a width outside [0, 32] or not an int raises
`InvalidArgumentError` (`_check_unpack_width`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.errors import InvalidArgumentError
from delta_tpu_torch.ops import cuda_build
from delta_tpu_torch.ops.u32 import to_i32_bits, widen_u32

LAUNCHES = obs.counter("kernel.unpack_bitpacked.launches")


def check_unpack_width(w, allow_zero: bool = False) -> None:
    """A width outside [1, 32] ([0, 32] with `allow_zero`), or not an
    int, raises InvalidArgumentError: a corrupt page header can carry any
    width byte."""
    lo = 0 if allow_zero else 1
    if not isinstance(w, (int, np.integer)) or not lo <= int(w) <= 32:
        raise InvalidArgumentError(
            f"bit-packed width must be in [{lo}, 32], got {w!r}")


def _check(packed: torch.Tensor, w) -> None:
    check_unpack_width(w)
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or packed.shape[0] != w:
        raise ValueError(f"unpack_bitpacked takes int32 [w={w}, G] words, "
                         f"got {packed.dtype} {tuple(packed.shape)}")


def unpack_bitpacked_plain(packed: torch.Tensor, w: int) -> torch.Tensor:
    """K5's function in plain PyTorch."""
    _check(packed, w)
    x = widen_u32(packed)
    mask = (1 << w) - 1
    outs = []
    for j in range(32):
        lo, sh = divmod(j * w, 32)
        v = x[lo] >> sh
        if sh + w > 32:
            v = v | (x[lo + 1] << (32 - sh))
        outs.append(v & mask)
    return to_i32_bits(torch.stack(outs, dim=1).reshape(-1))


def unpack_bitpacked_words(packed: torch.Tensor, w: int) -> torch.Tensor:
    """The group-major values of the word-major [w, G] int32 bit-pattern
    words `packed`: int32 [G * 32]. A CPU tensor takes the plain version;
    a CUDA tensor launches K5, or raises."""
    _check(packed, w)
    if packed.device.type == "cpu":
        return unpack_bitpacked_plain(packed, w)
    if packed.device.type != "cuda":
        raise ValueError(f"unpack_bitpacked: unsupported device "
                         f"{packed.device}")
    g = packed.shape[1]
    out = torch.empty(g * 32, dtype=torch.int32, device=packed.device)
    if g == 0:
        return out
    packed = packed.contiguous()
    fn = cuda_build.function(
        "unpack_bitpacked", "unpack_bitpacked_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    code = fn(packed.data_ptr(), int(w), g, out.data_ptr(),
              packed.device.index, stream)
    cuda_build.check_launch(code, "unpack_bitpacked")
    LAUNCHES.inc()
    return out


def unpack_bitpacked(packed_words: np.ndarray, w, n_groups: int,
                     device=None) -> torch.Tensor:
    """Decode `n_groups` bit-packed groups from the flat group-major u32
    word stream `packed_words` (n_groups * w words, little-endian): int32
    bit patterns [n_groups * 32] on `device` (the card when None)."""
    check_unpack_width(w, allow_zero=True)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("unpack_bitpacked: no CUDA device is "
                               "available; pass device='cpu'")
        device = "cuda"
    if w == 0:
        return torch.zeros(n_groups * 32, dtype=torch.int32, device=device)
    words = np.ascontiguousarray(packed_words[:n_groups * w], np.uint32)
    if words.size != n_groups * w:
        raise InvalidArgumentError(
            f"unpack_bitpacked: {n_groups} groups of width {w} need "
            f"{n_groups * w} words, got {words.size}")
    shaped = np.ascontiguousarray(words.reshape(n_groups, w).T)
    packed = torch.from_numpy(shaped.view(np.int32)).to(device)
    return unpack_bitpacked_words(packed, int(w))

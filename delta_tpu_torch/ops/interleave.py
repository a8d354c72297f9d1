"""The curve key's bit interleave: kernel K4 and its plain version.

Counterpart of `delta_tpu/ops/pallas_kernels.py:58-103`
(`interleave_bits_tiled`, the TPU kernel B3, and `interleave_bits_auto`)
and of the jnp twin `delta_tpu/ops/zorder.py::interleave_bits`.

`interleave_bits(cols, n_bits)` takes a [k, n] matrix of u32 values held
as int32 bit patterns and returns the [ceil(k * n_bits / 32), n] key
words, int32 bit patterns too. The bits go MSB-first and round-robin:
global bit g comes from column g % k, source bit n_bits - 1 - g // k, and
lands in word g // 32 at bit 31 - g % 32. Any n; k and n_bits from 1 to
32. On a CUDA tensor it launches K4 (`csrc/interleave_bits.cu`) on the
current stream, or raises; on a CPU tensor it runs
`interleave_bits_plain`, the same loop in torch over int64 lanes (torch
has no u32 shifts on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build
from delta_tpu_torch.ops.u32 import to_i32_bits, widen_u32

LAUNCHES = obs.counter("kernel.interleave_bits.launches")

MAX_COLS = 32


def n_words(k: int, n_bits: int) -> int:
    return max(1, -(-(k * n_bits) // 32))


def _check(cols: torch.Tensor, n_bits: int) -> None:
    if cols.dtype != torch.int32 or cols.dim() != 2:
        raise ValueError(f"interleave_bits takes int32 [k, n] bit patterns, "
                         f"got {cols.dtype} {tuple(cols.shape)}")
    if not 1 <= cols.shape[0] <= MAX_COLS:
        raise ValueError(f"interleave_bits takes 1 to {MAX_COLS} columns, "
                         f"got {cols.shape[0]}")
    if not 1 <= int(n_bits) <= 32:
        raise ValueError(f"interleave_bits: n_bits must be in 1..32, "
                         f"got {n_bits}")


def interleave_bits_plain(cols: torch.Tensor, n_bits: int = 32
                          ) -> torch.Tensor:
    """K4's function in plain PyTorch."""
    _check(cols, n_bits)
    k, n = cols.shape
    x = widen_u32(cols)
    words = torch.zeros((n_words(k, n_bits), n), dtype=torch.int64,
                        device=cols.device)
    for g in range(k * n_bits):
        c = g % k
        s = n_bits - 1 - g // k
        w, wb = divmod(g, 32)
        words[w] |= ((x[c] >> s) & 1) << (31 - wb)
    return to_i32_bits(words)


def interleave_bits(cols: torch.Tensor, n_bits: int = 32) -> torch.Tensor:
    """Curve key words of the [k, n] int32 bit-pattern matrix `cols`:
    int32 [ceil(k * n_bits / 32), n]. A CPU tensor takes the plain
    version; a CUDA tensor launches K4, or raises."""
    _check(cols, n_bits)
    if cols.device.type == "cpu":
        return interleave_bits_plain(cols, n_bits)
    if cols.device.type != "cuda":
        raise ValueError(f"interleave_bits: unsupported device {cols.device}")
    k, n = cols.shape
    out = torch.empty((n_words(k, n_bits), n), dtype=torch.int32,
                      device=cols.device)
    if n == 0:
        return out
    cols = cols.contiguous()
    fn = cuda_build.function(
        "interleave_bits", "interleave_bits_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    code = fn(cols.data_ptr(), k, int(n_bits), n, out.data_ptr(),
              cols.device.index, stream)
    cuda_build.check_launch(code, "interleave_bits")
    LAUNCHES.inc()
    return out

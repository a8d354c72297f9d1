"""JSON structural byte classes: kernel K1 and its plain version.

Counterpart of `delta_tpu/ops/pallas_kernels.py::byte_class_tiled`, the
Pallas kernel that opens the device JSON parse. The CUDA kernel is
`delta_tpu_torch/csrc/byte_class.cu` (its header gives the bound and the
design); unlike the TPU kernel it takes any length, not only multiples of
4096.
"""

from __future__ import annotations

import ctypes

import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build

# class bit per structural byte; ops/json_parse.py tests these bits
BYTE_CLASS_BITS = {
    "newline": 1, "quote": 2, "backslash": 4,
    "colon": 8, "lbrace": 16, "rbrace": 32,
}
_BYTE_CLASS_VALUES = ((10, 1), (34, 2), (92, 4), (58, 8), (123, 16),
                      (125, 32))

LAUNCHES = obs.counter("kernel.byte_class.launches")


def byte_class_plain(b: torch.Tensor) -> torch.Tensor:
    """uint8[n] -> uint8[n] class bitmask, in plain PyTorch ops."""
    cls = torch.zeros_like(b)
    for byte, bit in _BYTE_CLASS_VALUES:
        cls |= (b == byte).to(torch.uint8) * bit
    return cls


def byte_class(b: torch.Tensor) -> torch.Tensor:
    """uint8[n] -> uint8[n] class bitmask (bits in BYTE_CLASS_BITS).

    A CPU tensor takes the plain version; a CUDA tensor launches K1 on the
    current stream, or raises."""
    if b.dtype != torch.uint8 or b.dim() != 1:
        raise ValueError(f"byte_class takes a 1-D uint8 tensor, got "
                         f"{b.dtype} of shape {tuple(b.shape)}")
    if b.device.type == "cpu":
        return byte_class_plain(b)
    if b.device.type != "cuda":
        raise ValueError(f"byte_class: unsupported device {b.device}")
    b = b.contiguous()
    out = torch.empty_like(b)
    if b.numel() == 0:
        return out
    fn = cuda_build.function(
        "byte_class", "byte_class_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p])
    stream = torch.cuda.current_stream(b.device).cuda_stream
    code = fn(b.data_ptr(), out.data_ptr(), b.numel(), b.device.index,
              stream)
    cuda_build.check_launch(code, "byte_class")
    LAUNCHES.inc()
    return out

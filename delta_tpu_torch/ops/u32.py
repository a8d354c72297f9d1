"""u32 values in torch, which has no unsigned 32-bit shifts, sorts or
searches on the CPU: they travel as int32 bit patterns (4 B each, as on
the device) and are widened to int64 lanes for arithmetic and comparison.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def widen_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> the u32 values in int64."""
    return x.to(torch.int64) & U32


def to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same 32 bits as int32."""
    return (v - ((v >> 31) << 32)).to(torch.int32)

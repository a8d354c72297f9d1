"""Per-file min, max and valid count of a masked matrix: kernel K6 and its
plain version.

Counterpart of `delta_tpu/ops/pallas_kernels.py:105-166`
(`segmented_minmax`, the TPU kernel B5, and its wrapper
`batched_file_stats`). For each row f of values f32 [F, R] under a bool
mask [F, R]: the min and max over the valid entries and their count; a
row with no valid entry gives +inf, -inf and 0. The edge semantics are
the reference's, bit for bit: a valid NaN makes both min and max NaN
(the quiet NaN 0x7FC00000); -0.0 orders below +0.0 (min(0.0, -0.0) is
-0.0, max is +0.0, in any order); a valid +inf is a legal min.

Both versions reduce an order-preserving integer encoding of the float
(`_order_key`: the sign flips the other 31 bits, so int32 order is float
order with -0.0 < +0.0) and override with NaN. On a CUDA tensor
`segmented_minmax` launches K6 (`csrc/segmented_minmax.cu`) on the
current stream, or raises; on a CPU tensor it runs
`segmented_minmax_plain`. Any F and R.

`batched_file_stats(values, valid, device)` is the wrapper's counterpart:
numpy in (values cast to float32), numpy (min, max, null_count,
num_records) out, with num_records = R and null_count = R - count; it
runs on the card unless the caller passes "cpu".
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build

LAUNCHES = obs.counter("kernel.segmented_minmax.launches")

QUIET_NAN_BITS = 0x7FC00000
_LOW31 = 0x7FFFFFFF
_KEY_POS_INF = 0x7F800000                 # the key of +inf
_KEY_NEG_INF = (0xFF800000 ^ _LOW31) - (1 << 32)  # the key of -inf
_LAUNCH = None  # (K6's C entry point, the raw-stream getter), on first use


def _check(values: torch.Tensor, valid: torch.Tensor) -> None:
    if values.dtype != torch.float32 or values.dim() != 2:
        raise ValueError(f"segmented_minmax takes float32 [F, R] values, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if valid.dtype != torch.bool or valid.shape != values.shape \
            or valid.device != values.device:
        raise ValueError("segmented_minmax: the mask must be bool of the "
                         "values' shape, on their device")


def _order_key(bits: torch.Tensor) -> torch.Tensor:
    """int32 float bits -> int32 keys in float order (an involution)."""
    return bits ^ ((bits >> 31) & _LOW31)


def segmented_minmax_plain(values: torch.Tensor, valid: torch.Tensor):
    """K6's function in plain PyTorch."""
    _check(values, valid)
    key = _order_key(values.view(torch.int32))
    lo = torch.where(valid, key, _KEY_POS_INF).amin(dim=1)
    hi = torch.where(valid, key, _KEY_NEG_INF).amax(dim=1)
    count = valid.sum(dim=1, dtype=torch.int32)
    nan = (valid & torch.isnan(values)).any(dim=1)
    qnan = torch.tensor(QUIET_NAN_BITS, dtype=torch.int32,
                        device=values.device)
    mn = torch.where(nan, qnan, _order_key(lo)).view(torch.float32)
    mx = torch.where(nan, qnan, _order_key(hi)).view(torch.float32)
    return mn, mx, count


def segmented_minmax(values: torch.Tensor, valid: torch.Tensor):
    """(min f32 [F], max f32 [F], valid count int32 [F]) of each row of
    `values` over `valid`. A CPU tensor takes the plain version; a CUDA
    tensor launches K6 (one kernel, one C call, one `torch.empty` viewed
    as the three results), or raises."""
    global _LAUNCH
    _check(values, valid)
    if values.device.type == "cpu":
        return segmented_minmax_plain(values, valid)
    if values.device.type != "cuda":
        raise ValueError(f"segmented_minmax: unsupported device "
                         f"{values.device}")
    f, r = values.shape
    index = values.get_device()
    out = torch.empty(3 * f, dtype=torch.int32, device=index)
    results = (out[:f].view(torch.float32), out[f:2 * f].view(torch.float32),
               out[2 * f:])
    if f == 0:
        return results
    if not values.is_contiguous():
        values = values.contiguous()
    if not valid.is_contiguous():
        valid = valid.contiguous()
    if _LAUNCH is None:
        _LAUNCH = (cuda_build.function(
            "segmented_minmax", "segmented_minmax_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]),
            torch._C._cuda_getCurrentRawStream)
    launch, raw_stream = _LAUNCH
    code = launch(values.data_ptr(), valid.data_ptr(), f, r, out.data_ptr(),
                  index, raw_stream(index))
    cuda_build.check_launch(code, "segmented_minmax")
    LAUNCHES.inc()
    return results


def batched_file_stats(values: np.ndarray, valid: np.ndarray, device=None):
    """numpy (min f32, max f32, null_count int64, num_records int64) per
    file (row) of `values` [F, R] under `valid`, on `device` (the card
    when None)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("batched_file_stats: no CUDA device is "
                               "available; pass device='cpu'")
        device = "cuda"
    f, r = values.shape
    v = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(device)
    m = torch.from_numpy(np.ascontiguousarray(valid, bool)).to(device)
    mn, mx, cnt = segmented_minmax(v, m)
    num_records = np.full(f, r, dtype=np.int64)
    return (mn.cpu().numpy(), mx.cpu().numpy(),
            num_records - cnt.cpu().numpy(), num_records)

"""The segment aggregate of SQL's GROUP BY: kernel K10 and its plain
version.

Counterpart of three jnp functions of `delta_tpu/ops/sqlops.py` (queue
B's B11): `_segagg_kernel` (`:123`: count, sum, min, max), `_group_sizes_kernel`
(`:215`) and `_centered_sumsq_kernel` (`:221`, the second pass of the
sample variance). Over dense group codes int32 [n], values int64 or
float64 [n] and valid bool [n] (None: every row valid) it returns
`(agg[n_groups], count[n_groups])`, as `GroupAggregator.reduce` returns
them sliced: count is the number of valid rows of each group (int64); agg
is, by op,

- "count": the count again;
- "sum": int64 (wrapping on overflow, as jnp's segment_sum) or float64
  (0 for a group with no valid row);
- "min", "max": the values' dtype, bit for bit the reference's: a row
  that is not valid folds the reference's `big` (int64 INT64_MAX for min,
  -INT64_MAX for max, float64 +inf / -inf) and a group with no row at all
  holds the reduction's identity (INT64_MAX, INT64_MIN, +inf, -inf);
  floats order by the order-preserving int64 image of their bits, so
  -0.0 is below +0.0;
- "sumsq": float64, the sum over valid rows of (v - means[code])^2
  (`means` float64 [n_groups]).

There are no pad buckets (PyTorch keeps no compiled shape to reuse). On a
CUDA tensor `seg_agg` launches K10 (`csrc/seg_agg.cu`) on the current
stream, or raises; it never falls back. K10 is two launches, an init and
the rows, in one of three regimes that its C entry point picks by the
group count G: tables private to each thread in shared memory up to 16
groups, a whole table in each block's shared memory, folded over a
cluster of 4 blocks, up to 19,370 groups (227 KiB a block), and global
atomics after a warp folds each run of one code past that (or past 2^32
rows). On a CPU tensor it runs `seg_agg_plain`, the same function in torch
ops (`scatter_add_`, `scatter_reduce_`). Ints and counts are exact; a
float64 sum on the card adds in the order its atomics land, so it may
differ from the plain version's in the last bits (the tests allow 1e-12
relative).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build

LAUNCHES = obs.counter("kernel.seg_agg.launches")
OPS = {"count": 0, "sum": 1, "min": 2, "max": 3, "sumsq": 4}
_I64_MAX = (1 << 63) - 1
_LOW63 = _I64_MAX
_LAUNCH = None  # (K10's C entry point, the raw-stream getter), on first use


def _check(codes: torch.Tensor, values: Optional[torch.Tensor],
           valid: Optional[torch.Tensor], op: str, n_groups: int,
           means: Optional[torch.Tensor]) -> None:
    if op not in OPS:
        raise ValueError(f"seg_agg: unknown op {op!r}")
    if codes.dtype != torch.int32 or codes.dim() != 1:
        raise ValueError(f"seg_agg takes int32 [n] codes, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    n = codes.shape[0]
    if n_groups < 0 or n_groups >= 1 << 31:
        raise ValueError(f"seg_agg: n_groups {n_groups} out of range")
    if op != "count":
        if values is None or values.shape != (n,) or values.dtype not in (
                torch.int64, torch.float64):
            raise ValueError("seg_agg: values must be int64 or float64 [n]")
        if values.device != codes.device:
            raise ValueError("seg_agg: values and codes on different devices")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)
                              or valid.device != codes.device):
        raise ValueError("seg_agg: valid must be bool [n] on the codes' "
                         "device")
    if op == "sumsq":
        if values.dtype != torch.float64 or means is None \
                or means.dtype != torch.float64 \
                or means.shape != (n_groups,) or means.device != codes.device:
            raise ValueError("seg_agg sumsq takes float64 values and float64 "
                             "[n_groups] means on the codes' device")


def _order_image(bits: torch.Tensor) -> torch.Tensor:
    """float64 bits (as int64) -> int64 keys in float order (an
    involution)."""
    return bits ^ ((bits >> 63) & _LOW63)


def _identity(op: str, dtype: torch.dtype) -> int:
    """A group's agg word before any row (a float op's as its image)."""
    if dtype == torch.float64:
        if op == "min":
            return 0x7FF0000000000000
        if op == "max":
            return -0x7FF0000000000001
        return 0
    return {"min": _I64_MAX, "max": -_I64_MAX - 1}.get(op, 0)


def _invalid_fill(op: str, dtype: torch.dtype) -> int:
    """What a row that is not valid folds into a min or max."""
    if op == "max" and dtype == torch.int64:
        return -_I64_MAX
    return _identity(op, dtype)


def seg_agg_plain(codes: torch.Tensor, values: Optional[torch.Tensor],
                  valid: Optional[torch.Tensor], op: str, n_groups: int,
                  means: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's function in plain PyTorch, on the inputs' device."""
    _check(codes, values, valid, op, n_groups, means)
    dev = codes.device
    idx = codes.to(torch.int64)
    ones = torch.ones(codes.shape[0], dtype=torch.int64, device=dev) \
        if valid is None else valid.to(torch.int64)
    count = torch.zeros(n_groups, dtype=torch.int64, device=dev) \
        .scatter_add_(0, idx, ones)
    if op == "count":
        return count, count
    keep = valid if valid is not None else torch.ones(
        codes.shape[0], dtype=torch.bool, device=dev)
    if op == "sumsq":
        d = values - means[idx] if n_groups else values
        sq = torch.where(keep, d * d, torch.zeros((), dtype=torch.float64,
                                                  device=dev))
        agg = torch.zeros(n_groups, dtype=torch.float64, device=dev) \
            .scatter_add_(0, idx, sq)
        return agg, count
    if op == "sum":
        zero = torch.zeros((), dtype=values.dtype, device=dev)
        agg = torch.zeros(n_groups, dtype=values.dtype, device=dev) \
            .scatter_add_(0, idx, torch.where(keep, values, zero))
        return agg, count
    is_float = values.dtype == torch.float64
    key = _order_image(values.view(torch.int64)) if is_float else values
    ident = _identity(op, values.dtype)
    fill = torch.full((), _invalid_fill(op, values.dtype), dtype=torch.int64,
                      device=dev)
    agg = torch.full((n_groups,), ident, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, idx, torch.where(keep, key, fill),
                         "amin" if op == "min" else "amax",
                         include_self=True)
    if is_float:
        agg = _order_image(agg).view(torch.float64)
    return agg, count


def seg_agg(codes: torch.Tensor, values: Optional[torch.Tensor],
            valid: Optional[torch.Tensor], op: str, n_groups: int,
            means: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(agg [n_groups], count int64 [n_groups]) of `op` over the groups
    (module docstring). A CPU tensor takes the plain version; a CUDA
    tensor launches K10 (an init launch and the rows' launch: one C
    call), or raises."""
    global _LAUNCH
    _check(codes, values, valid, op, n_groups, means)
    if codes.device.type == "cpu":
        return seg_agg_plain(codes, values, valid, op, n_groups, means)
    if codes.device.type != "cuda":
        raise ValueError(f"seg_agg: unsupported device {codes.device}")
    index = codes.get_device()
    count = torch.empty(n_groups, dtype=torch.int64, device=codes.device)
    agg = None if op == "count" else torch.empty(
        n_groups, dtype=torch.float64 if op == "sumsq" else values.dtype,
        device=codes.device)
    if n_groups == 0:
        return (count if agg is None else agg), count
    codes = codes.contiguous()
    values = None if values is None else values.contiguous()
    valid = None if valid is None else valid.contiguous()
    means = None if means is None else means.contiguous()
    if _LAUNCH is None:
        _LAUNCH = (cuda_build.function(
            "seg_agg", "seg_agg_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p]),
            torch._C._cuda_getCurrentRawStream)
    launch, raw_stream = _LAUNCH
    code = launch(codes.data_ptr(),
                  None if values is None or op == "count"
                  else values.data_ptr(),
                  None if valid is None else valid.data_ptr(),
                  codes.shape[0], n_groups, OPS[op],
                  int(op == "sumsq" or (values is not None
                                        and values.dtype == torch.float64)),
                  None if means is None else means.data_ptr(),
                  None if agg is None else agg.data_ptr(),
                  count.data_ptr(), index, raw_stream(index))
    cuda_build.check_launch(code, "seg_agg")
    LAUNCHES.inc()
    return (count if agg is None else agg), count

"""The segmented scans of SQL's window functions: kernel K11 and its plain
versions.

Counterpart of three jnp functions of `delta_tpu/ops/sqlops.py` (queue
B's B11): `_ranks_kernel` (`:543`), `_segscan_kernel` (`:585`) and
`_peer_last_kernel` (`:655`). Each takes rows in a window's sorted order
(partition, then order keys) and boundary flags: `pb` bool [n] marks the
first row of each partition, `kb` bool [n] the first row of each run of
equal order keys (the wrappers OR `pb` into it; row 0 always starts a
partition).

- `window_ranks(pb, kb)` -> (row_number, rank, dense_rank), int64 [n],
  1-based within the partition.
- `window_running(v, valid, pb, op)` -> (values float64 [n], counts int64
  [n]): the running `op` ("sum", "mean", "count", "min", "max") of the
  valid values from the partition's first row to this one, and how many
  there are; a row whose count is 0 holds 0 (sum, mean), +inf / -inf
  (min, max): the caller makes it NULL.
- `window_peer_last(values, counts, kb)` -> each row takes the value and
  count of the last row of its `kb` run (the RANGE frame: peers share).

On a CUDA tensor each launches K11 (`csrc/window_scan.cu`: a memset of
its tile flags, then one pass over 2048-row tiles whose carries go by
decoupled look-back) on the current stream, or raises; it never falls
back. On a CPU tensor it runs the
`*_plain` version, the same math in torch ops (`cummax` of flagged
positions and prefix counts as the reference writes them,
`scatter_reduce_` of each run's last row); a running min or max is a
`cummax` over (partition, value rank) keys, a running sum a segmented
scan by doubling, so that it rounds within its partition (the reference
subtracts the partition's base from a global prefix sum, which carries
the rounding of every row before it). Ranks, counts, min and max are exact; a running sum or mean
is float64 and the kernel adds in another order, so they agree to
rounding (the tests allow 1e-9 of the partition's absolute sum). The
kernel's order is fixed: every call gives the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build

RANKS_LAUNCHES = obs.counter("kernel.window_ranks.launches")
RUNNING_LAUNCHES = obs.counter("kernel.window_running.launches")
PEER_LAUNCHES = obs.counter("kernel.window_peer_last.launches")
OPS = {"sum": 0, "mean": 1, "count": 2, "min": 3, "max": 4}
_FUNCS = None  # K11's C entry points and the raw-stream getter, on first use


def _flags(x: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if x.dtype != torch.bool or x.shape != (n,):
        raise ValueError(f"window: {what} must be bool [{n}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    return x


def _starts(pb: torch.Tensor) -> torch.Tensor:
    """pb with row 0 set."""
    pb = pb.clone()
    if pb.numel():
        pb[0] = True
    return pb


def _segment_start(pb: torch.Tensor) -> torch.Tensor:
    """Each row's partition's first row (a cummax of flagged positions)."""
    iota = torch.arange(pb.numel(), dtype=torch.int64, device=pb.device)
    return torch.cummax(torch.where(pb, iota, torch.full_like(iota, -1)),
                        0).values


def _segmented_sum(x: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums that restart at each `pb` row, by doubling
    (after the step of width d a row holds the sum of its partition's rows
    in (i - 2d, i]): each sum is rounded within its partition, where a
    global prefix sum less the partition's base would carry the rounding
    of every row before it."""
    n = x.numel()
    flags = pb
    d = 1
    while d < n:
        x = torch.cat([x[:d], x[d:] + torch.where(
            flags[d:], torch.zeros((), dtype=x.dtype, device=x.device),
            x[:-d])])
        flags = torch.cat([flags[:d], flags[d:] | flags[:-d]])
        d *= 2
    return x


def _launchers():
    global _FUNCS
    if _FUNCS is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        _FUNCS = {
            "scratch": cuda_build.function(
                "window_scan", "window_scan_scratch_bytes", [ll],
                restype=ll),
            "ranks": cuda_build.function(
                "window_scan", "window_ranks",
                [p, p, ll, p, p, p, p, i, p]),
            "running": cuda_build.function(
                "window_scan", "window_running",
                [p, p, p, ll, i, p, p, p, i, p]),
            "peers": cuda_build.function(
                "window_scan", "window_peer_last",
                [p, p, p, ll, p, p, p, i, p]),
            "stream": torch._C._cuda_getCurrentRawStream,
        }
    return _FUNCS


def _scratch(f, n: int, dev: torch.device) -> torch.Tensor:
    return torch.empty(int(f["scratch"](n)), dtype=torch.uint8, device=dev)


def _on_card(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


# ------------------------------------------------------------- ranks ----

def window_ranks_plain(pb: torch.Tensor, kb: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11's ranks in plain PyTorch, on the inputs' device."""
    n = pb.numel()
    pb = _starts(_flags(pb, n, "pb"))
    kb = _flags(kb, n, "kb") | pb
    iota = torch.arange(n, dtype=torch.int64, device=pb.device)
    start = _segment_start(pb)
    kstart = _segment_start(kb)
    kcum = torch.cumsum(kb.to(torch.int64), 0)
    at_start = torch.cummax(torch.where(pb, kcum, torch.full_like(kcum, -1)),
                            0).values
    return iota - start + 1, kstart - start + 1, kcum - at_start + 1


def window_ranks(pb: torch.Tensor, kb: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row_number, rank, dense_rank) int64 [n] (module docstring). A CPU
    tensor takes the plain version; a CUDA tensor launches K11, or
    raises."""
    n = pb.numel()
    _flags(pb, n, "pb")
    _flags(kb, n, "kb")
    if not _on_card(pb, "window_ranks"):
        return window_ranks_plain(pb, kb)
    dev = pb.device
    out = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(3)]
    if n == 0:
        return tuple(out)
    f = _launchers()
    pb, kb = pb.contiguous(), kb.contiguous()
    scratch = _scratch(f, n, dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    code = f["ranks"](pb.data_ptr(), kb.data_ptr(), n, out[0].data_ptr(),
                      out[1].data_ptr(), out[2].data_ptr(),
                      scratch.data_ptr(), index, f["stream"](index))
    cuda_build.check_launch(code, "window_ranks")
    RANKS_LAUNCHES.inc()
    return tuple(out)


# ----------------------------------------------------------- running ----

def _check_running(v, valid, pb, op) -> int:
    if op not in OPS:
        raise ValueError(f"window_running: unknown op {op!r}")
    n = v.numel()
    if v.dtype != torch.float64 or v.shape != (n,):
        raise ValueError("window_running: values must be float64 [n]")
    _flags(valid, n, "valid")
    _flags(pb, n, "pb")
    if not (v.device == valid.device == pb.device):
        raise ValueError("window_running: inputs on different devices")
    return n


def window_running_plain(v: torch.Tensor, valid: torch.Tensor,
                         pb: torch.Tensor, op: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's running aggregate in plain PyTorch, on the inputs' device."""
    n = _check_running(v, valid, pb, op)
    dev = v.device
    pb = _starts(pb)
    start = _segment_start(pb)
    before = torch.clamp(start - 1, min=0)
    cnt_cum = torch.cumsum(valid.to(torch.int64), 0)
    count = cnt_cum - torch.where(start > 0, cnt_cum[before],
                                  torch.zeros_like(cnt_cum))
    if op == "count":
        return count.to(torch.float64), count
    if op in ("sum", "mean"):
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        s = _segmented_sum(torch.where(valid, v, zero), pb)
        if op == "mean":
            s = s / torch.clamp(count, min=1).to(torch.float64)
        return s, count
    # a segmented min or max: ranks of the valid values (0 where not
    # valid), keyed by partition so that one cummax restarts at each
    part = torch.cumsum(pb.to(torch.int64), 0)
    uniq, inv = torch.unique(torch.where(valid, v, torch.zeros_like(v)),
                             sorted=True, return_inverse=True)
    rank = inv.to(torch.int64) + 1
    if op == "min":
        rank = uniq.numel() + 1 - rank
    rank = torch.where(valid, rank, torch.zeros_like(rank))
    best = torch.cummax(part * (uniq.numel() + 2) + rank, 0).values \
        - part * (uniq.numel() + 2)
    if op == "min":
        best = torch.where(best > 0, uniq.numel() + 1 - best, best)
    fill = float("inf") if op == "min" else float("-inf")
    out = torch.where(best > 0, uniq[torch.clamp(best - 1, min=0)],
                      torch.full((n,), fill, dtype=torch.float64,
                                 device=dev)) if uniq.numel() else \
        torch.full((n,), fill, dtype=torch.float64, device=dev)
    return out, count


def window_running(v: torch.Tensor, valid: torch.Tensor, pb: torch.Tensor,
                   op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values float64 [n], counts int64 [n]) of the running `op` (module
    docstring). A CPU tensor takes the plain version; a CUDA tensor
    launches K11, or raises."""
    n = _check_running(v, valid, pb, op)
    if not _on_card(v, "window_running"):
        return window_running_plain(v, valid, pb, op)
    dev = v.device
    out = torch.empty(n, dtype=torch.float64, device=dev)
    count = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out, count
    f = _launchers()
    v, valid, pb = v.contiguous(), valid.contiguous(), pb.contiguous()
    scratch = _scratch(f, n, dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    code = f["running"](v.data_ptr(), valid.data_ptr(), pb.data_ptr(), n,
                        OPS[op], out.data_ptr(), count.data_ptr(),
                        scratch.data_ptr(), index, f["stream"](index))
    cuda_build.check_launch(code, "window_running")
    RUNNING_LAUNCHES.inc()
    return out, count


# ------------------------------------------------------------- peers ----

def _check_peers(values, counts, kb) -> int:
    n = values.numel()
    if values.dtype != torch.float64 or values.shape != (n,) \
            or counts.dtype != torch.int64 or counts.shape != (n,):
        raise ValueError("window_peer_last takes float64 [n] values and "
                         "int64 [n] counts")
    _flags(kb, n, "kb")
    if not (values.device == counts.device == kb.device):
        raise ValueError("window_peer_last: inputs on different devices")
    return n


def window_peer_last_plain(values: torch.Tensor, counts: torch.Tensor,
                           kb: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's peer pass in plain PyTorch, on the inputs' device."""
    n = _check_peers(values, counts, kb)
    kb = _starts(kb)
    run = torch.cumsum(kb.to(torch.int64), 0) - 1
    iota = torch.arange(n, dtype=torch.int64, device=values.device)
    last = torch.zeros(n, dtype=torch.int64, device=values.device) \
        .scatter_reduce_(0, run, iota, "amax", include_self=False)
    take = last[run]
    return values[take], counts[take]


def window_peer_last(values: torch.Tensor, counts: torch.Tensor,
                     kb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's value and count at the last row of its `kb` run. A CPU
    tensor takes the plain version; a CUDA tensor launches K11, or
    raises."""
    n = _check_peers(values, counts, kb)
    if not _on_card(values, "window_peer_last"):
        return window_peer_last_plain(values, counts, kb)
    dev = values.device
    out_v = torch.empty(n, dtype=torch.float64, device=dev)
    out_c = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out_v, out_c
    f = _launchers()
    values, counts, kb = (values.contiguous(), counts.contiguous(),
                          kb.contiguous())
    scratch = _scratch(f, n, dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    code = f["peers"](values.data_ptr(), counts.data_ptr(), kb.data_ptr(), n,
                      out_v.data_ptr(), out_c.data_ptr(), scratch.data_ptr(),
                      index, f["stream"](index))
    cuda_build.check_launch(code, "window_peer_last")
    PEER_LAUNCHES.inc()
    return out_v, out_c

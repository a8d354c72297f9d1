"""MERGE's equi-join: joint key codes on the host, one sort and the join
tail (kernel K9) on the engine's device.

Counterpart of `delta_tpu/ops/join.py`: the jnp function `_join_kernel`
(`:41`, queue B's B9), `equi_join_codes` (`:88`) and `equi_join_device`
(`:114`). The join keys are dictionary-coded jointly over target and
source (`joint_codes`: numpy's sorted `np.unique` codes of numbers, and
codes by Python equality of strings, where the reference numbers keys in
order of first appearance; every output below is the same whichever code
a key gets), then:

1. the codes go to the device as one int32 lane (H2D);
2. a stable `torch.sort` of the composite key `(code << 1) | side` (side
   0 for a target row) puts each key's rows in one run, its target rows
   first, each side in input order, as the reference's
   `jax.lax.sort((codes, side, iota), num_keys=2)` orders them
   (`sort_codes`);
3. the tail (`join_tail`) gives, per target row, the source-local index
   of the first (smallest) source row of its run or -1 (`match_src`); per
   source row, whether its run holds a target row, as bit words; and the
   number of target rows whose run holds more than one source row
   (`n_multi`, all MERGE's cardinality rule needs). On a CUDA tensor it
   launches K9 (`csrc/merge_join.cu`: two single-pass launches over
   1024-row tiles whose carries go by decoupled look-back; no thread
   walks a key's run), or raises; on a CPU tensor it runs
   `join_tail_plain`, the same function in torch ops;
4. one copy of the packed result back (D2H).

There are no pad buckets (PyTorch keeps no compiled shape to reuse): the
lanes hold exactly nt + ns rows, and the outputs equal the reference's
sliced to [:nt] and [:ns]. Codes stay below 2^31 (re-densified when a
multi-key radix passes it), so they are valid as int32 and as u32.

`host_pair_join` is the route the device join does not take (an ON
condition with residual conjuncts, or fewer rows than MERGE's threshold):
every (target, source) pair of equal codes, by a numpy sort-merge, the
pairs the reference's host inner merge gives.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.models.batch import factorize_objects
from delta_tpu_torch.ops import cuda_build

LAUNCHES = obs.counter("kernel.merge_join.launches")
# joins that took the sort and the tail on the engine's device (on a CPU
# engine through the plain version): MERGE's device route
DEVICE_JOINS = obs.counter("join.device_joins")
_LAUNCH = None  # (K9's C entry point, the raw-stream getter), on first use
_CODE_LIMIT = 1 << 31


def n_words(ns: int) -> int:
    return (ns + 31) // 32


def _dense(codes: np.ndarray) -> np.ndarray:
    return np.unique(codes, return_inverse=True)[1].reshape(-1).astype(
        np.int64)


def _column_codes(both: np.ndarray) -> np.ndarray:
    """Dense int64 codes of one key column over target ++ source: equal
    values one code, every NaN one code of its own (Spark's NaN = NaN),
    -0.0 the code of 0.0."""
    if both.dtype == object:
        return factorize_objects(both)
    if both.dtype.kind == "f":
        nan = np.isnan(both)
        if nan.any():
            codes = np.zeros(len(both), np.int64)
            codes[~nan] = _dense(both[~nan])
            codes[nan] = int(codes[~nan].max(initial=-1)) + 1
            return codes
    return _dense(both)


def joint_codes(target_keys: Sequence[np.ndarray],
                source_keys: Sequence[np.ndarray]) -> np.ndarray:
    """int32 [nt + ns] codes of the key tuples of the target rows then the
    source rows (null-free columns: the caller drops NULL keys), equal
    exactly where every key column is equal; below 2^31."""
    codes = None
    for tc, sc in zip(target_keys, source_keys):
        c = _column_codes(np.concatenate([np.asarray(tc), np.asarray(sc)]))
        if codes is None:
            codes = c
        else:
            # a running radix over the columns; both factors < 2^31
            codes = codes * (int(c.max(initial=0)) + 1) + c
            if int(codes.max(initial=0)) >= _CODE_LIMIT:
                codes = _dense(codes)
    if codes is None:
        raise ValueError("an equi-join needs at least one key column")
    return codes.astype(np.int32)


def _check(s_code: torch.Tensor, s_pos: torch.Tensor, nt: int,
           ns: int) -> None:
    if s_code.dtype != torch.int32 or s_pos.dtype != torch.int32 \
            or s_code.dim() != 1 or s_pos.dim() != 1:
        raise ValueError("join_tail takes int32 [n] codes and positions, "
                         f"got {s_code.dtype} {tuple(s_code.shape)}, "
                         f"{s_pos.dtype} {tuple(s_pos.shape)}")
    if nt < 0 or ns < 0 or s_code.shape[0] != nt + ns \
            or s_pos.shape[0] != nt + ns or nt + ns >= _CODE_LIMIT:
        raise ValueError(f"join_tail: {s_code.shape[0]} codes and "
                         f"{s_pos.shape[0]} positions for {nt} + {ns} rows")
    if s_pos.device != s_code.device:
        raise ValueError("join_tail: the codes and positions lie on "
                         f"{s_code.device} and {s_pos.device}")


def sort_codes(codes: torch.Tensor, nt: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted codes, their input positions), both int32 [n], of the codes
    int32 [n] (target rows then source rows) sorted stably by (code,
    side)."""
    key = codes.to(torch.int64) << 1
    key[nt:] |= 1
    s_key, perm = torch.sort(key, stable=True)
    return (s_key >> 1).to(torch.int32), perm.to(torch.int32)


def join_tail_plain(s_code: torch.Tensor, s_pos: torch.Tensor, nt: int,
                    ns: int) -> torch.Tensor:
    """K9's function in plain PyTorch, on the lanes' device: int32
    [nt + ceil(ns/32) + 1], the match_src of every target row, the
    source-matched words (u32 bit patterns), then n_multi."""
    _check(s_code, s_pos, nt, ns)
    dev = s_code.device
    n, w = nt + ns, n_words(ns)
    out = torch.zeros(nt + w + 1, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    code = s_code.to(torch.int64)
    pos = s_pos.to(torch.int64)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = code[1:] != code[:-1]
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    n_runs = int(run[-1]) + 1
    is_src = pos >= nt
    n_src = torch.zeros(n_runs, dtype=torch.int64, device=dev)
    n_src.scatter_add_(0, run, is_src.to(torch.int64))
    n_tgt = torch.zeros(n_runs, dtype=torch.int64, device=dev)
    n_tgt.scatter_add_(0, run, (~is_src).to(torch.int64))
    first = torch.full((n_runs,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, run, torch.where(is_src, pos, n), "amin")
    t_run, t_pos = run[~is_src], pos[~is_src]
    out[t_pos] = torch.where(n_src[t_run] > 0, first[t_run] - nt,
                             -1).to(torch.int32)
    matched = torch.zeros(w * 32, dtype=torch.int64, device=dev)
    matched[pos[is_src] - nt] = (n_tgt[run[is_src]] > 0).to(torch.int64)
    bits = torch.arange(32, dtype=torch.int64, device=dev)
    words = (matched.view(w, 32) << bits).sum(1)
    # u32 bit patterns as int32 (bit 31 set: the word minus 2^32)
    out[nt:nt + w] = torch.where(words >= 1 << 31, words - (1 << 32),
                                 words).to(torch.int32)
    out[-1] = int((n_src[t_run] > 1).sum())
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous and 16-byte aligned, as K9's vector loads take it (a
    view that starts off alignment is copied)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def join_tail(s_code: torch.Tensor, s_pos: torch.Tensor, nt: int,
              ns: int) -> torch.Tensor:
    """The join tail over sorted lanes (module docstring), in the layout
    of `join_tail_plain`, on the lanes' device. A CPU tensor takes the
    plain version; a CUDA tensor launches K9 (its kernels write every
    output word and take their scratch from here, no synchronization), or
    raises."""
    global _LAUNCH
    _check(s_code, s_pos, nt, ns)
    if s_code.device.type == "cpu":
        return join_tail_plain(s_code, s_pos, nt, ns)
    if s_code.device.type != "cuda":
        raise ValueError(f"join_tail: unsupported device {s_code.device}")
    index = s_code.get_device()
    w = n_words(ns)
    out = torch.empty(nt + w + 1, dtype=torch.int32, device=index)
    if nt + ns == 0:
        return out.zero_()
    s_code, s_pos = _aligned(s_code), _aligned(s_pos)
    if _LAUNCH is None:
        _LAUNCH = (cuda_build.function(
            "merge_join", "merge_join_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]),
            cuda_build.function(
            "merge_join", "merge_join_scratch_bytes",
            [ctypes.c_longlong, ctypes.c_longlong], ctypes.c_longlong),
            torch._C._cuda_getCurrentRawStream)
    launch, scratch_bytes, raw_stream = _LAUNCH
    scratch = torch.empty(scratch_bytes(nt, ns), dtype=torch.uint8,
                          device=index)
    base, item = out.data_ptr(), out.element_size()
    code = launch(s_code.data_ptr(), s_pos.data_ptr(), nt, ns, base,
                  base + item * nt, base + item * (nt + w),
                  scratch.data_ptr(), index, raw_stream(index))
    cuda_build.check_launch(code, "merge_join")
    LAUNCHES.inc()
    return out


def unpack_tail(out: np.ndarray, nt: int, ns: int
                ) -> Tuple[np.ndarray, int, np.ndarray]:
    """(match_src int32 [nt], n_multi, source_matched bool [ns]) of a
    join tail's result copied to the host."""
    words = np.ascontiguousarray(out[nt:nt + n_words(ns)]).view(np.uint32)
    matched = np.unpackbits(words.view(np.uint8),
                            bitorder="little")[:ns].astype(bool)
    return out[:nt].astype(np.int32), int(out[-1]), matched


def equi_join_codes(t_codes: np.ndarray, s_codes: np.ndarray,
                    device="cuda", mark=None
                    ) -> Tuple[np.ndarray, int, np.ndarray]:
    """Join by key codes (int32, below 2^31) on `device` (the card unless
    the caller asks for the CPU). Returns (match_src int32 [nt] source
    row or -1, n_multi, source_matched bool [ns]). `mark`, when given, is
    called after each step (`join_h2d`, `join_sort`, `join_tail`,
    `join_d2h`), as `obs.PhaseTimer` takes it."""
    nt, ns = len(t_codes), len(s_codes)
    if nt == 0 or ns == 0:
        return np.full(nt, -1, np.int32), 0, np.zeros(ns, bool)
    DEVICE_JOINS.inc()
    mark = mark or (lambda name: None)
    dev = torch.device(device)
    codes = torch.from_numpy(np.concatenate([t_codes, s_codes])
                             .astype(np.int32))
    if dev.type == "cuda":
        codes = codes.pin_memory().to(dev, non_blocking=True)
    mark("join_h2d")
    s_code, s_pos = sort_codes(codes, nt)
    mark("join_sort")
    out = join_tail(s_code, s_pos, nt, ns)
    mark("join_tail")
    host = out.cpu().numpy()
    mark("join_d2h")
    return unpack_tail(host, nt, ns)


def equi_join_device(target_keys: Sequence[np.ndarray],
                     source_keys: Sequence[np.ndarray], device="cuda",
                     mark=None) -> Tuple[np.ndarray, int, np.ndarray]:
    """Join on one or more key columns (numpy arrays, null-free: the
    caller drops NULL keys): `joint_codes`, then `equi_join_codes`.
    `mark` also gets `join_encode`."""
    codes = joint_codes(target_keys, source_keys)
    if mark is not None:
        mark("join_encode")
    nt = len(np.asarray(target_keys[0]))
    return equi_join_codes(codes[:nt], codes[nt:], device=device, mark=mark)


def host_pair_join(target_keys: Sequence[np.ndarray],
                   source_keys: Sequence[np.ndarray],
                   codes: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Every (target row, source row) pair with equal keys, as int64
    (tpos, spos), target rows ascending and each one's sources in input
    order: a sort-merge over the joint codes."""
    if codes is None:
        codes = joint_codes(target_keys, source_keys)
    nt = len(np.asarray(target_keys[0]))
    t_codes, s_codes = codes[:nt], codes[nt:]
    order = np.argsort(s_codes, kind="stable")
    sorted_s = s_codes[order]
    lo = np.searchsorted(sorted_s, t_codes, "left")
    cnt = np.searchsorted(sorted_s, t_codes, "right") - lo
    tpos = np.repeat(np.arange(nt, dtype=np.int64), cnt)
    within = np.arange(len(tpos)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    spos = order[np.repeat(lo, cnt) + within].astype(np.int64)
    return tpos, spos

"""Log replay as a device sort plus a last-wins winner pass.

Counterpart of `delta_tpu/ops/replay.py`. The reconciliation contract:
for each logical file key `(path, dv_unique_id)` the newest action wins;
a surviving `add` is a live file, a surviving `remove` a tombstone.

1. Rows arrive in chronological (version, order) order, so the row index
   is the chronological rank; rows out of order are permuted into it first
   and the masks un-permuted after.
2. One stable `torch.sort` by the int64 replay key. Stability gives the
   chronological tiebreak that the JAX package builds by hand with an
   iota lane, so every file's history becomes one contiguous run, oldest
   first. (The JAX package's sort is XLA's `lax.sort`, outside any Pallas
   kernel; a library sort is its honest counterpart.)
3. Kernel K2 (`csrc/winner_pack.cu`) marks the last row of each run,
   scatters the mark to the row's original index and bit-packs it.
4. The winner words split into live (`winner & add`) and tombstone
   (`winner & ~add`) masks, which stay on the device.

`advance_masks` is `Snapshot.update()`'s replay: the new commits alone
through the same sort and K2, then a device search that clears the prior
rows whose keys they touch (the JAX package's `delta_winner_masks` and
its candidate check, which run on the host there).

The JAX package ships keys over a slow host link as first-appearance
flag bits; that packed transfer is not ported here. Keys stay on the
device from the parse on.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build

LAUNCHES = obs.counter("kernel.winner_pack.launches")
_LAUNCH = None  # (K2's C entry point, the raw-stream getter), on first use


def chrono_ok(version: torch.Tensor, order: torch.Tensor) -> bool:
    """True if rows are already in chronological (version, order) order,
    so that the row index is the chronological rank."""
    if version.shape[0] <= 1:
        return True
    v0, v1 = version[:-1], version[1:]
    if bool((v1 < v0).any()):
        return False
    return not bool(((v1 == v0) & (order[1:] < order[:-1])).any())


def combine_key_lanes(key_lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mixed-radix combine of dense, non-negative key-code lanes into one
    int64 replay key per row, equal exactly when all lanes are equal.
    Raises if the product of the lanes' ranges does not fit int64."""
    maxes = [int(lane.max()) if lane.numel() else 0 for lane in key_lanes]
    radix = 1
    for mx in maxes:
        radix *= mx + 1
    if radix > 1 << 63:
        raise ValueError(f"replay key lanes span {radix} values, more than "
                         "an int64 key holds")
    combined = key_lanes[0].to(torch.int64)
    for lane, mx in zip(key_lanes[1:], maxes[1:]):
        combined = combined * (mx + 1) + lane.to(torch.int64)
    return combined


def winner_pack_plain(skey: torch.Tensor, sidx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """K2's arithmetic in plain PyTorch: int32 [ceil(n / 32)] words."""
    winner = torch.ones(n, dtype=torch.bool, device=skey.device)
    winner[:-1] = skey[:-1] != skey[1:]  # is_last_of_run | ~next_valid
    n_words = -(-n // 32)
    bits = torch.zeros(n_words * 32, dtype=torch.bool, device=skey.device)
    bits[sidx.to(torch.int64)] = winner
    shifts = torch.arange(32, dtype=torch.int64, device=skey.device)
    w = (bits.view(n_words, 32).to(torch.int64) << shifts).sum(1)
    return (w - ((w >> 31) << 32)).to(torch.int32)  # the same 32 bits


def winner_pack(skey: torch.Tensor, sidx: torch.Tensor, n: int) -> torch.Tensor:
    """Winner bits of a key-sorted replay, in original row order.

    skey: int64 [n] sorted keys; sidx: int32 [n] original row index of
    each sorted row. Returns int32 [ceil(n / 32)] words, bit r % 32 of
    word r // 32 set when row r is the newest action of its key.

    A CPU tensor takes the plain version; a CUDA tensor launches K2 on the
    current stream, or raises. Host work per call is fixed and small: the
    checks, one `torch.empty`, one C call (which fills the words and
    launches)."""
    global _LAUNCH
    if (skey.dtype != torch.int64 or sidx.dtype != torch.int32
            or skey.shape != (n,) or sidx.shape != (n,)):
        raise ValueError(
            f"winner_pack takes int64 [n] keys and int32 [n] indices, got "
            f"{skey.dtype} {tuple(skey.shape)}, {sidx.dtype} "
            f"{tuple(sidx.shape)} for n={n}")
    if skey.device != sidx.device:
        raise ValueError("winner_pack: keys and indices on different devices")
    if skey.device.type == "cpu":
        return winner_pack_plain(skey, sidx, n)
    if skey.device.type != "cuda":
        raise ValueError(f"winner_pack: unsupported device {skey.device}")
    if not skey.is_contiguous():
        skey = skey.contiguous()
    if not sidx.is_contiguous():
        sidx = sidx.contiguous()
    index = skey.get_device()
    words = torch.empty(-(-n // 32), dtype=torch.int32, device=index)
    if n == 0:
        return words
    if _LAUNCH is None:
        _LAUNCH = (cuda_build.function(
            "winner_pack", "winner_pack_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
            torch._C._cuda_getCurrentRawStream)
    launch, raw_stream = _LAUNCH
    code = launch(skey.data_ptr(), sidx.data_ptr(), n, words.data_ptr(),
                  index, raw_stream(index))
    cuda_build.check_launch(code, "winner_pack")
    LAUNCHES.inc()
    return words


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [ceil(n / 32)] little-endian bit words -> bool [n]."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words.view(-1, 1) >> shifts) & 1).view(-1)[:n].to(torch.bool)


class ReplayPending:
    """A launched replay: the device works through the sort and the
    winner pass while the host goes on; `finish()` splits the winner words
    into (live, tombstone) masks."""

    __slots__ = ("_winner", "_is_add", "_n", "_perm")

    def __init__(self, winner, is_add: torch.Tensor, n: int, perm):
        self._winner = winner
        self._is_add = is_add
        self._n = n
        self._perm = perm

    def finish(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._n == 0:
            z = torch.zeros(0, dtype=torch.bool, device=self._is_add.device)
            return z, z
        winner = unpack_bits(self._winner, self._n)
        live = winner & self._is_add
        tomb = winner & ~self._is_add
        if self._perm is not None:
            inv_live = torch.empty_like(live)
            inv_tomb = torch.empty_like(tomb)
            inv_live[self._perm] = live
            inv_tomb[self._perm] = tomb
            live, tomb = inv_live, inv_tomb
        return live, tomb


def replay_select_launch(
    key_lanes: Sequence[torch.Tensor],
    version: torch.Tensor,
    order: torch.Tensor,
    is_add: torch.Tensor,
) -> ReplayPending:
    """Asynchronous half of `replay_select`: permutes to chronological
    order if needed, sorts and launches the winner pass; returns without
    waiting for the device."""
    n = int(version.shape[0])
    if n >= 1 << 31:
        raise ValueError(f"replay of {n} rows: row indices must fit int32")
    if n == 0:
        return ReplayPending(None, is_add.to(torch.bool), 0, None)
    perm = None
    if not chrono_ok(version, order):
        perm = torch.argsort(order, stable=True)
        perm = perm[torch.argsort(version[perm], stable=True)]
        key_lanes = [k[perm] for k in key_lanes]
        is_add = is_add[perm]
    key = combine_key_lanes(key_lanes)
    skey, sidx = torch.sort(key, stable=True)
    words = winner_pack(skey, sidx.to(torch.int32), n)
    return ReplayPending(words, is_add.to(torch.bool), n, perm)


def replay_select(
    key_lanes: Sequence[torch.Tensor],
    version: torch.Tensor,
    order: torch.Tensor,
    is_add: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(live_mask, tombstone_mask) bool tensors over the rows, on the
    tensors' device.

    key_lanes: one or more integer lanes jointly identifying the logical
    file (dictionary codes). version/order: the chronological coordinate of
    each row."""
    return replay_select_launch(key_lanes, version, order, is_add).finish()


def advance_masks(prev_path: torch.Tensor, prev_dv: torch.Tensor,
                  prev_live: torch.Tensor, prev_tomb: torch.Tensor,
                  d_path: torch.Tensor, d_dv: torch.Tensor,
                  d_version: torch.Tensor, d_order: torch.Tensor,
                  d_is_add: torch.Tensor, n_dv: int):
    """(live, tombstone) masks over a prior state's rows followed by a
    delta's, after the delta's commits replay on top of the prior state.
    The delta's key lanes are already coded in the prior's space
    (`replay/keys.py::KeySpace.absorb`); dv codes are below `n_dv`.

    The delta replays alone (stable `torch.sort` + K2, as a load does);
    every prior row whose exact `(path, dv)` key the delta touches loses
    its mask bits, since a newer action of its key exists. The prior
    lanes stay on the device: the delta's distinct keys are sorted and
    each prior key is found by `torch.searchsorted`, one pass over the
    prior rows."""
    d_live, d_tomb = replay_select([d_path, d_dv], d_version, d_order,
                                   d_is_add)
    if d_path.shape[0] == 0:
        return prev_live, prev_tomb
    touched = torch.unique(d_path * n_dv + d_dv)  # sorted
    pk = prev_path * n_dv + prev_dv if n_dv > 1 else prev_path
    at = torch.searchsorted(touched, pk).clamp_(max=touched.shape[0] - 1)
    hit = touched[at] == pk
    return (torch.cat([prev_live & ~hit, d_live]),
            torch.cat([prev_tomb & ~hit, d_tomb]))


def python_replay_reference(
    keys: Sequence[tuple],
    version: np.ndarray,
    order: np.ndarray,
    is_add: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Sequential hash-map replay, the protocol's reference semantics:
    visit rows in (version, order) order, last write per key wins."""
    n = len(keys)
    rows = sorted(range(n), key=lambda i: (int(version[i]), int(order[i])))
    winner: dict = {}
    for i in rows:
        winner[keys[i]] = i
    live = np.zeros(n, dtype=bool)
    tomb = np.zeros(n, dtype=bool)
    for i in winner.values():
        if is_add[i]:
            live[i] = True
        else:
            tomb[i] = True
    return live, tomb

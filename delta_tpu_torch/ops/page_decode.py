"""Device side of the checkpoint page decode, and the replay handoff.

Counterpart of `delta_tpu/ops/page_decode.py`. `log/page_decode.py` packs a
checkpoint part's projected pages into ONE uint8 lane plus two int32 plan
lanes; here one decode per part turns them into values:

1. kernel K3 `hybrid_extract` (`csrc/hybrid_extract.cu`, the port of the
   TPU kernel B1 `shift_extract_tiled`, fused with the run lookup, the
   5-byte gather and the RLE select of `_decode_stage_hybrid`) decodes
   every hybrid position: definition levels, dictionary indices, booleans.
   The plan carries a tile table built on the host (`tile_plan`), one
   block per tile, so the device searches nothing;
2. torch ops do the rest, as jnp does in the reference: the per-row
   definition-level lookup, the present-rank cumsum, the PLAIN and
   dictionary byte gathers and, when the path columns are dictionary-coded,
   the compaction of the replay-key codes, which stay on the device.

Plan layout (all int32), the reference's column for column:

run_plan[R, 6]   per hybrid run: hybrid start, value count, absolute lane
                 bit offset, bit width, is_rle, rle value (u32 bit pattern).
tile_plan[T, 2]  per K3 tile: run id, first hybrid position. Tiles cover
                 [0, h_total) in order, each inside one run's positions
                 and one TILE-aligned chunk of the output (so at most TILE
                 positions); a tile ends where the next begins.
page_plan[P, 11] per data page: output row start, row count, max def
                 level, def-stream hybrid start, kind (PLAIN/BOOL/DICT),
                 value byte offset, item size, aux hybrid start
                 (dict-index or bool bit stream), dictionary byte offset,
                 dictionary size, key column (0 none / 1 add.path /
                 2 remove.path).

The port does not pad to buckets. The byte lane and the three plans travel
to the device in ONE host-to-device copy (`PartPlan.host`). u32 values
travel as int64 (torch has no u32 shifts on the CPU); the kernel's output
is int32 bit patterns.

`launch_checkpoint_handoff` is the port of the reference's handoff: a
checkpoint-only load whose parts are all keyed replays straight from the
device code lanes (stable `torch.sort` + K2) and returns a
`ReplayPending`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build
from delta_tpu_torch.ops.u32 import U32, to_i32_bits, widen_u32

# run_plan columns
R_H, R_N, R_BIT, R_W, R_RLE, R_VAL = range(6)
RUN_F = 6
# tile_plan columns; TILE is kTile of csrc/hybrid_extract.cu
T_RUN, T_FIRST = range(2)
TILE_F = 2
TILE = 1024
# page_plan columns
(PG_OUT, PG_N, PG_MAXDEF, PG_DEFH, PG_KIND, PG_VALB, PG_ITEM, PG_AUXH,
 PG_DICTB, PG_DICTN, PG_KEY) = range(11)
PAGE_F = 11

KIND_PLAIN = 0
KIND_BOOL = 1
KIND_DICT = 2

KEY_NONE = 0
KEY_ADD = 1
KEY_REMOVE = 2

_FAR = 0x3FFFFFFF  # the reference's clip bound for in-page offsets

# byte-lane cap so every absolute bit offset fits int32 (8 * B < 2^31)
MAX_LANE_BYTES = 192 << 20

LAUNCHES = obs.counter("kernel.hybrid_extract.launches")
# (K3's C entry point, the current-stream getter), bound at first launch
_LAUNCH = None
_OBS_HANDOFFS = obs.counter("decode.handoff_launches")


def tile_plan(runs: np.ndarray, h_total: int) -> np.ndarray:
    """K3's tile table, int32[T, TILE_F]: the positions [0, h_total) cut at
    every multiple of TILE and at every run start, each piece with the run
    that the plain version's lookup (the last run whose start <= h,
    clipped to the table) gives its positions. Empty when there is nothing
    to extract."""
    if h_total <= 0 or runs.shape[0] == 0:
        return np.zeros((0, TILE_F), np.int32)
    starts = runs[:, R_H].astype(np.int64)
    first = np.unique(np.concatenate([
        np.arange(0, h_total, TILE, dtype=np.int64),
        starts[(starts > 0) & (starts < h_total)]]))
    rid = np.clip(np.searchsorted(starts, first, side="right") - 1, 0,
                  starts.shape[0] - 1)
    return np.stack([rid, first], 1).astype(np.int32)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@dataclass
class PartPlan:
    """Host-built decode plan for one checkpoint part: the byte lane and
    the run, tile and page plans laid out in one host buffer, so that one
    copy takes them all to the device. `lane`, `runs`, `tiles`, `pages`
    are views of it."""

    host: np.ndarray       # uint8: lane | runs | tiles | pages, 16-aligned
    lane_bytes: int        # B
    n_runs: int            # R
    n_tiles: int           # T
    n_pages: int           # P
    h_total: int           # hybrid positions
    n_rows: int            # output rows across all planned columns
    has_keys: bool         # any KEY_ADD/KEY_REMOVE pages present

    @staticmethod
    def pack(lane: np.ndarray, runs: np.ndarray, pages: np.ndarray,
             h_total: int, n_rows: int, has_keys: bool) -> "PartPlan":
        tiles = tile_plan(runs, h_total)
        words = np.concatenate([runs.ravel(), tiles.ravel(), pages.ravel()]
                               ).astype(np.int32)
        off = _align16(lane.size)
        host = np.zeros(off + words.nbytes, np.uint8)
        host[:lane.size] = lane
        host[off:] = words.view(np.uint8)
        return PartPlan(host, lane.size, runs.shape[0], tiles.shape[0],
                        pages.shape[0], h_total, n_rows, has_keys)

    def views(self, buf):
        """(lane, runs, tiles, pages) as views of `buf`, this plan's host
        buffer or its copy on a device (numpy or torch)."""
        off = _align16(self.lane_bytes)
        i32 = np.int32 if isinstance(buf, np.ndarray) else torch.int32
        words = buf[off:].view(i32)
        r = self.n_runs * RUN_F
        t = r + self.n_tiles * TILE_F
        return (buf[:self.lane_bytes], words[:r].reshape(-1, RUN_F),
                words[r:t].reshape(-1, TILE_F), words[t:].reshape(-1, PAGE_F))

    @property
    def lane(self) -> np.ndarray:
        return self.views(self.host)[0]

    @property
    def runs(self) -> np.ndarray:
        return self.views(self.host)[1]

    @property
    def tiles(self) -> np.ndarray:
        return self.views(self.host)[2]

    @property
    def pages(self) -> np.ndarray:
        return self.views(self.host)[3]


@dataclass
class PartKeys:
    """Device-resident replay keys of one part: part-local path codes
    compacted into (add rows, remove rows) order, int64, 0xFFFFFFFF past
    the present rows."""

    codes: Optional[torch.Tensor]
    n_add: int
    n_rem: int
    n_bad: int             # struct-present rows with a null path
    uniq: List[bytes]      # part-local dictionary, code order, raw bytes


def hybrid_extract_plain(lane: torch.Tensor, runs: torch.Tensor,
                         h_total: int) -> torch.Tensor:
    """K3's function in plain PyTorch: int32[h_total] bit patterns of the
    u32 value at every hybrid position."""
    dev = lane.device
    if h_total == 0 or runs.shape[0] == 0:
        return torch.zeros(h_total, dtype=torch.int32, device=dev)
    r = runs.to(torch.int64)
    h = torch.arange(h_total, dtype=torch.int64, device=dev)
    rid = (torch.searchsorted(r[:, R_H].contiguous(), h, right=True) - 1
           ).clamp_(0, r.shape[0] - 1)
    row = r[rid]
    j = torch.minimum((h - row[:, R_H]).clamp(min=0), row[:, R_N])
    w = row[:, R_W]
    bit = row[:, R_BIT] + j * w
    b0 = bit >> 3
    n_bytes = lane.shape[0]
    lane64 = lane.to(torch.int64)

    def byte(k):
        i = b0 + k
        ok = (i >= 0) & (i < n_bytes)
        return torch.where(ok, lane64[i.clamp(0, max(n_bytes - 1, 0))], 0) \
            if n_bytes else torch.zeros_like(i)

    lo = byte(0) | (byte(1) << 8) | (byte(2) << 16) | (byte(3) << 24)
    sh = bit & 7
    v = (lo >> sh) | (byte(4) << (32 - sh))
    mask = torch.where(w >= 32, U32, (1 << w.clamp(max=31)) - 1)
    v = v & mask & U32
    out = torch.where(row[:, R_RLE] == 1, row[:, R_VAL] & U32, v)
    return to_i32_bits(out)


def hybrid_extract(lane: torch.Tensor, runs: torch.Tensor, h_total: int,
                   tiles: torch.Tensor) -> torch.Tensor:
    """The u32 value at every hybrid position of a part: int32[h_total]
    bit patterns. lane: uint8[B]; runs: int32[R, 6] sorted by hybrid
    start; tiles: int32[T, 2], the runs' `tile_plan`.

    A CPU tensor takes the plain version (which needs no tiles); a CUDA
    tensor launches K3 on the current stream, one block per tile, or
    raises. Host work per call is fixed and small: the checks, one
    `torch.empty`, one C call."""
    global _LAUNCH
    if (lane.dtype != torch.uint8 or runs.dtype != torch.int32
            or tiles.dtype != torch.int32 or lane.dim() != 1
            or runs.dim() != 2 or tiles.dim() != 2
            or runs.shape[1] != RUN_F or tiles.shape[1] != TILE_F):
        raise ValueError(
            f"hybrid_extract takes a uint8 lane, int32 [R, {RUN_F}] runs and "
            f"int32 [T, {TILE_F}] tiles, got {lane.dtype} "
            f"{tuple(lane.shape)}, {runs.dtype} {tuple(runs.shape)}, "
            f"{tiles.dtype} {tuple(tiles.shape)}")
    index = lane.get_device()  # -1 on the CPU
    if runs.get_device() != index or tiles.get_device() != index:
        raise ValueError("hybrid_extract: lane, runs and tiles on different "
                         "devices")
    if not lane.is_cuda:
        if lane.device.type != "cpu":
            raise ValueError(f"hybrid_extract: unsupported device "
                             f"{lane.device}")
        return hybrid_extract_plain(lane, runs, h_total)
    if not (lane.is_contiguous() and runs.is_contiguous()
            and tiles.is_contiguous()):
        raise ValueError("hybrid_extract: lane, runs and tiles must be "
                         "contiguous")
    n_tiles = tiles.shape[0]
    if n_tiles == 0:
        if h_total and runs.shape[0]:
            raise ValueError("hybrid_extract: no tiles for a non-empty plan")
        return torch.zeros(h_total, dtype=torch.int32, device=index)
    if _LAUNCH is None:
        _LAUNCH = (cuda_build.function(
            "hybrid_extract", "hybrid_extract_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
            torch._C._cuda_getCurrentRawStream)
    launch, raw_stream = _LAUNCH
    out = torch.empty(h_total, dtype=torch.int32, device=index)
    code = launch(lane.data_ptr(), lane.shape[0], runs.data_ptr(),
                  tiles.data_ptr(), n_tiles, h_total, out.data_ptr(), index,
                  raw_stream(index))
    cuda_build.check_launch(code, "hybrid_extract")
    LAUNCHES.inc()
    return out


def decode_part(plan: PartPlan, device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Optional[PartKeys]]:
    """One decode of `plan` on `device`: (lo, hi, defined) over the plan's
    row space (lo/hi int64 holding u32 values) and the device-resident
    PartKeys (None when the plan carries no key pages). Port of the
    reference's `_decode_fn` / `decode_part`."""
    lane, runs, tiles, pages = plan.views(
        torch.from_numpy(plan.host).to(device))
    pages = pages.to(torch.int64)
    hyb = widen_u32(hybrid_extract(lane, runs, plan.h_total, tiles))
    if hyb.numel() == 0:
        hyb = torch.zeros(1, dtype=torch.int64, device=lane.device)
    h_max = hyb.shape[0] - 1
    n = plan.n_rows
    p_rows = pages.shape[0]

    i = torch.arange(n, dtype=torch.int64, device=lane.device)
    pid = (torch.searchsorted(pages[:, PG_OUT].contiguous(), i, right=True)
           - 1).clamp_(0, p_rows - 1)
    pg = pages[pid]
    j = i - pg[:, PG_OUT]
    in_page = (j >= 0) & (j < pg[:, PG_N])
    maxdef = pg[:, PG_MAXDEF]
    jc = j.clamp(0, _FAR)
    lvl = torch.where(maxdef > 0,
                      hyb[(pg[:, PG_DEFH] + jc).clamp(0, h_max)], maxdef)
    defined = in_page & (lvl == maxdef)

    cdef = torch.cumsum(defined.to(torch.int64), 0)
    out0 = pg[:, PG_OUT]
    base = torch.where(out0 > 0, cdef[(out0 - 1).clamp(0, max(n - 1, 0))], 0)
    p = (cdef - 1 - base).clamp(0, _FAR)

    kind = pg[:, PG_KIND]
    aux = hyb[(pg[:, PG_AUXH] + p).clamp(0, h_max)]
    item = pg[:, PG_ITEM]
    aux_i32 = torch.where(aux >= 1 << 31, aux - (1 << 32), aux)
    idx = torch.minimum(aux_i32.clamp(min=0),
                        (pg[:, PG_DICTN] - 1).clamp(min=0))
    src = torch.where(kind == KIND_DICT, pg[:, PG_DICTB] + idx * item,
                      pg[:, PG_VALB] + p * item)
    n_bytes = lane.shape[0]
    lane64 = lane.to(torch.int64)

    def byte(k):
        s = src + k
        return torch.where(s < n_bytes,
                           lane64[s.clamp(0, max(n_bytes - 1, 0))], 0)

    lo = byte(0) | (byte(1) << 8) | (byte(2) << 16) | (byte(3) << 24)
    hi = byte(4) | (byte(5) << 8) | (byte(6) << 16) | (byte(7) << 24)
    lo = torch.where(kind == KIND_BOOL, aux, lo)
    hi = torch.where((kind != KIND_BOOL) & (item == 8), hi, 0)
    out_lo = torch.where(defined, lo, 0)
    out_hi = torch.where(defined, hi, 0)
    if not plan.has_keys:
        return out_lo, out_hi, defined, None

    key_col = pg[:, PG_KEY]
    struct_ok = lvl >= maxdef - 1
    pres_a = in_page & (key_col == KEY_ADD) & struct_ok
    pres_r = in_page & (key_col == KEY_REMOVE) & struct_ok
    bad = (pres_a | pres_r) & (lvl < maxdef)
    n_add, n_rem, n_bad = torch.stack(
        [pres_a.sum(), pres_r.sum(), bad.sum()]).tolist()
    rank_a = torch.cumsum(pres_a.to(torch.int64), 0) - 1
    rank_r = torch.cumsum(pres_r.to(torch.int64), 0) - 1
    pos = torch.where(pres_a, rank_a,
                      torch.where(pres_r, n_add + rank_r, n))
    codes = torch.full((n,), U32, dtype=torch.int64, device=lane.device)
    keep = pos < n
    codes[pos[keep]] = lo[keep]
    keys = PartKeys(codes=codes, n_add=int(n_add), n_rem=int(n_rem),
                    n_bad=int(n_bad), uniq=[])
    return out_lo, out_hi, defined, keys


# ---------------------------------------------------------------- handoff --


def _decoded_paths(raw: Sequence[bytes]) -> Optional[List[str]]:
    """Raw path bytes with the percent-decoding every replay key gets;
    None on bytes that are not UTF-8 (the handoff is then off)."""
    try:
        out = [b.decode("utf-8") for b in raw]
    except UnicodeDecodeError:
        return None
    if any("%" in s for s in out):
        from urllib.parse import unquote

        out = [unquote(s) if "%" in s else s for s in out]
    return out


def launch_checkpoint_handoff(parts: Sequence[PartKeys], device):
    """Launch the replay of a checkpoint-only load straight from the parts'
    device code lanes. Returns (ReplayPending, path codes int64 [n], the
    decoded paths in code order) or None when the parts disqualify (a null
    path in a present action, a part without a code lane, non-UTF-8
    paths).

    Host work is O(unique paths): the part dictionaries unify into one
    code space and only the small remap tables go to the device. Row
    order is (part order) x (add block, remove block), the order in which
    the columnarizer lays out checkpoint rows; a checkpoint holds at most
    one action per (path, dv), so that order never changes a winner."""
    from delta_tpu_torch.ops.replay import ReplayPending, winner_pack

    live = [p for p in parts if p.n_add + p.n_rem > 0]
    n = sum(p.n_add + p.n_rem for p in live)
    if not live or any(p.n_bad > 0 or p.codes is None for p in live):
        return None
    global_codes: dict = {}
    keys = []
    is_add = []
    for p in live:
        decoded = _decoded_paths(p.uniq)
        if decoded is None:
            return None
        remap = np.fromiter((global_codes.setdefault(s, len(global_codes))
                             for s in decoded), np.int64, len(decoded))
        remap_t = torch.from_numpy(
            remap if remap.size else np.zeros(1, np.int64)).to(device)
        m = p.n_add + p.n_rem
        local = p.codes[:m].clamp(0, remap_t.shape[0] - 1)
        keys.append(remap_t[local])
        is_add.append(torch.arange(m, device=device) < p.n_add)
    key = torch.cat(keys)
    skey, sidx = torch.sort(key, stable=True)
    words = winner_pack(skey, sidx.to(torch.int32), n)
    _OBS_HANDOFFS.inc()
    return ReplayPending(words, torch.cat(is_add), n, None), key, \
        list(global_codes)

"""The checkpoint writer's aggregate stage: per-part min, max, sum and
null count of int64 lanes, and the distinct partition codes of each part.

Counterpart of `delta_tpu/ops/stats.py:98-205` (`checkpoint_stats_block`,
the jitted `_agg_fn_cached`, and its host twin `host_stats_block`). The
reference body is jnp, not Pallas, so plain torch ops on the engine's
device are its port: `scatter_reduce` (`amin` / `amax` / `sum`) over
identity-filled outputs, and one sort plus a fresh-value count for the
distinct codes. Every lane is int64 and every reduction is exact and
order-free, so the device block equals the host twin bit for bit.

Output block, int64 [4 * L + 1, n_parts]: rows 0..L-1 min, L..2L-1 max,
2L..3L-1 sum, 3L..4L-1 null count, and the last row the number of
distinct values of the last lane (the partition codes) per part. A part
with no valid value of a lane keeps the identities IDENT_MIN / IDENT_MAX.
The device stage raises on failure; it never falls back to the host twin.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

IDENT_MIN = np.iinfo(np.int64).max
IDENT_MAX = np.iinfo(np.int64).min


def checkpoint_stats_block(lanes: Sequence[np.ndarray],
                           valids: Sequence[np.ndarray],
                           part_of_row: np.ndarray, n_parts: int,
                           n_codes: int, device) -> np.ndarray:
    """The aggregate block of `lanes` (each int64 [n], with a bool
    validity), rows assigned to parts by `part_of_row`, computed on
    `device` in one upload and one download."""
    n_l = len(lanes)
    n = int(lanes[0].shape[0]) if n_l else 0
    dev = torch.device(device)
    if n_l == 0:
        return np.zeros((1, n_parts), np.int64)
    vals = torch.from_numpy(np.stack(
        [np.asarray(v, np.int64) for v in lanes])).to(dev)
    ok = torch.from_numpy(np.stack(
        [np.asarray(v, bool) for v in valids])).to(dev)
    part = torch.from_numpy(np.asarray(part_of_row, np.int64)).to(dev)
    idx = part.expand(n_l, n)

    def reduce(src, ident, how):
        out = torch.full((n_l, n_parts), ident, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(1, idx, src, how, include_self=True)

    mins = reduce(torch.where(ok, vals, IDENT_MIN), IDENT_MIN, "amin")
    maxs = reduce(torch.where(ok, vals, IDENT_MAX), IDENT_MAX, "amax")
    sums = reduce(torch.where(ok, vals, 0), 0, "sum")
    nulls = reduce((~ok).to(torch.int64), 0, "sum")
    # distinct (part, code) pairs: sort the combined key, count the fresh
    # values of each part (invalid rows take a sentinel that counts none)
    code_mult = max(int(n_codes), 1) + 1
    key = torch.where(ok[-1], part * code_mult + vals[-1], IDENT_MIN)
    skey = torch.sort(key).values
    fresh = torch.ones_like(skey, dtype=torch.bool)
    fresh[1:] = skey[1:] != skey[:-1]
    real = skey != IDENT_MIN
    part_of = torch.where(real, skey // code_mult, n_parts)
    distinct = torch.bincount(part_of[fresh & real], minlength=n_parts + 1)
    block = torch.cat([mins, maxs, sums, nulls,
                       distinct[:n_parts].to(torch.int64)[None]])
    return block.cpu().numpy()


def host_stats_block(lanes: Sequence[np.ndarray], valids: Sequence[np.ndarray],
                     part_of_row: np.ndarray, n_parts: int,
                     n_codes: int) -> np.ndarray:
    """The host twin of `checkpoint_stats_block` (numpy, part by part),
    the reference's `host_stats_block` line for line."""
    n_l = len(lanes)
    out = np.zeros((4 * n_l + 1, n_parts), np.int64)
    out[0:n_l, :] = IDENT_MIN
    out[n_l:2 * n_l, :] = IDENT_MAX
    pid = np.asarray(part_of_row, np.int64)
    for p in range(n_parts):
        m = pid == p
        for i in range(n_l):
            v = np.asarray(lanes[i], np.int64)[m]
            ok = np.asarray(valids[i], bool)[m]
            if ok.any():
                out[i, p] = v[ok].min()
                out[n_l + i, p] = v[ok].max()
            out[2 * n_l + i, p] = int(v[ok].sum()) if ok.any() else 0
            out[3 * n_l + i, p] = int((~ok).sum())
        if n_l:
            codes = np.asarray(lanes[-1], np.int64)[m]
            okc = np.asarray(valids[-1], bool)[m]
            out[4 * n_l, p] = len(np.unique(codes[okc]))
    return out

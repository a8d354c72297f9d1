"""The SQL executor's relational operators on the engine's device: sort,
GROUP BY's reductions and the equi-join.

Counterpart of `delta_tpu/ops/sqlops.py` (queue B's B11) without its
sharded path; its window scans are K11's (`ops/window.py`). The division of labour is the reference's:

- host: dictionary codes of the keys (`ops/join.py::joint_codes`) and the
  O(output) pair expansion of a join (`_expand_pairs`, numpy, as in the
  reference: its output has a size the data decides);
- device: the sorts (stable `torch.sort`) and the segment reductions
  (kernel K10, `ops/segagg.py`).

`sort_permutation` (`:79`, the jnp `_sort_kernel` at `:74`) sorts stably
by several ascending lanes, last lane first, one stable `torch.sort` pass
each; the permutation comes back to the host. `join_pairs` (`:440`,
`_join_sort_kernel` at `:363`) sorts the composite `(code << 1) | side`
(`ops/join.py::sort_codes`, K9's sort), so each key's rows form a run, its
left rows first, each side in input order, as the reference's
`jax.lax.sort((codes, side, iota), num_keys=2)` orders them.

`GroupAggregator` (`:229`) keeps the group codes on the device and runs
each reduction through K10: `sizes()` (COUNT(*)), `reduce(values, valid,
op)`, `var(values, valid)` (the exact two-pass sample variance: a sum,
then the centered sum of squares) and `count_distinct(value_codes,
valid)` (the (group, value) pairs sorted on the device, each run's first
row counted by K10); `distinct_rows` gives the rows SUM and AVG(DISTINCT)
aggregate. Results are numpy, [n_groups]. There are no pad buckets.

`window_order` (`sqlengine/device.py:473`'s `_window_order`) sorts a
window's rows by (partition code, order lanes) on the device and leaves
the permutation and the partition and peer boundaries there, for kernel
K11 (`ops/window.py`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch.ops.join import sort_codes
from delta_tpu_torch.ops.segagg import seg_agg


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sqlops: no CUDA device is available; pass "
                               "device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


# ------------------------------------------------------------- sort ----

def _lane_tensor(lane: np.ndarray, dev: torch.device) -> torch.Tensor:
    lane = np.asarray(lane)
    if lane.dtype == bool or lane.dtype.kind == "u":
        lane = lane.astype(np.int64)
    elif lane.dtype.kind == "f":
        lane = lane.astype(np.float64, copy=False)
    elif lane.dtype != np.int64:
        lane = lane.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(lane)).to(dev)


def _sorted_order(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable ascending permutation of lane tensors (primary first):
    one stable `torch.sort` pass a lane, the last lane first."""
    perm = None
    for key in reversed(list(lanes)):
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def sort_permutation(lanes: Sequence[np.ndarray], device=None) -> np.ndarray:
    """Stable multi-key ascending sort; the permutation (int64 row
    indices). Lanes are NaN-free numbers, primary first; callers encode
    direction (negate for DESC) and null order (a 0/1 lane per key)."""
    dev = _device(device)
    n = int(len(lanes[0]))
    if n == 0:
        return np.empty(0, np.int64)
    return _sorted_order([_lane_tensor(l, dev) for l in lanes]).cpu().numpy()


def _run_starts(lanes: Sequence[torch.Tensor], n: int,
                dev: torch.device) -> torch.Tensor:
    """bool [n]: row 0, and each row where a (sorted) lane differs from
    the row before."""
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        out[0] = True
    for lane in lanes:
        out[1:] |= lane[1:] != lane[:-1]
    return out


def window_order(part_codes, key_lanes: Sequence[np.ndarray], n: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """A window's rows sorted on the device by (partition code, order
    lanes), the reference's `_window_order` (`sqlengine/device.py:473`):
    (perm int64 [n], pb bool [n], kb bool [n]) on the device, pb marking
    each partition's first sorted row and kb each run of equal order keys
    (pb included)."""
    dev = _device(device)
    parts = [] if part_codes is None else [_lane_tensor(part_codes, dev)]
    keys = [_lane_tensor(l, dev) for l in key_lanes]
    if parts or keys:
        perm = _sorted_order(parts + keys)
    else:
        perm = torch.arange(n, dtype=torch.int64, device=dev)
    pb = _run_starts([p[perm] for p in parts], n, dev)
    kb = pb | _run_starts([k[perm] for k in keys], n, dev)
    return perm, pb, kb


# --------------------------------------------------- group-by reduce ----

class GroupAggregator:
    """Device-resident group codes plus per-aggregate reductions through
    K10. Construct with the row -> group codes (dense, < n_groups); ints
    accumulate in int64, floats in float64; results are numpy sliced to
    n_groups."""

    def __init__(self, codes: np.ndarray, n_groups: int, device=None):
        self.device = _device(device)
        self.n = int(len(codes))
        self.n_groups = int(n_groups)
        self.codes = torch.from_numpy(
            np.ascontiguousarray(codes, np.int32)).to(self.device)

    def sizes(self) -> np.ndarray:
        """COUNT(*) per group."""
        _, cnt = seg_agg(self.codes, None, None, "count", self.n_groups)
        return cnt.cpu().numpy()

    def count(self, valid) -> np.ndarray:
        """COUNT(col) per group: the rows where `valid` (None: all)."""
        mt = None if valid is None else torch.from_numpy(
            np.ascontiguousarray(valid, bool)).to(self.device)
        _, cnt = seg_agg(self.codes, None, mt, "count", self.n_groups)
        return cnt.cpu().numpy()

    def _upload(self, values, valid):
        v = np.asarray(values)
        if v.dtype.kind in "uib":
            v = v.astype(np.int64, copy=False)
        else:
            v = v.astype(np.float64, copy=False)
        vt = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        mt = None if valid is None else torch.from_numpy(
            np.ascontiguousarray(valid, bool)).to(self.device)
        return vt, mt

    def reduce(self, values, valid, op: str) -> Tuple[np.ndarray, np.ndarray]:
        """(agg[n_groups], valid_count[n_groups]). Callers null the groups
        whose count is 0 and restore the original dtypes."""
        vt, mt = self._upload(values, valid)
        agg, cnt = seg_agg(self.codes, vt, mt, op, self.n_groups)
        return agg.cpu().numpy(), cnt.cpu().numpy()

    def _distinct_runs(self, value_codes, valid
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The valid rows sorted on the device by (group, value code):
        (their row indices, their group codes int32, the first row of
        each (group, value) run as bool flags)."""
        vc = torch.from_numpy(np.ascontiguousarray(value_codes, np.int64)) \
            .to(self.device)
        rows = torch.arange(self.n, dtype=torch.int64, device=self.device)
        if valid is not None:
            rows = rows[torch.from_numpy(np.ascontiguousarray(
                valid, bool)).to(self.device)]
        g, v = self.codes[rows], vc[rows]
        order = _sorted_order([g, v])
        rows, g, v = rows[order], g[order], v[order]
        first = _run_starts([g, v], int(rows.numel()), self.device)
        return rows, g, first

    def count_distinct(self, value_codes, valid) -> np.ndarray:
        """COUNT(DISTINCT x) per group (the reference's `count_distinct`,
        `_count_distinct_kernel` at `:350`): the (group, value code) pairs
        of the valid rows sorted on the device, the first row of each run
        flagged, the flags counted per group by K10."""
        _, g, first = self._distinct_runs(value_codes, valid)
        _, cnt = seg_agg(g.contiguous(), None, first, "count", self.n_groups)
        return cnt.cpu().numpy()

    def distinct_rows(self, value_codes, valid) -> np.ndarray:
        """One row of each distinct (group, value) pair among the valid
        rows (the first in sorted order): the rows SUM(DISTINCT) and
        AVG(DISTINCT) aggregate."""
        rows, _, first = self._distinct_runs(value_codes, valid)
        return rows[first].cpu().numpy()

    def var(self, values, valid) -> Tuple[np.ndarray, np.ndarray]:
        """Two-pass sample variance (exact centering: a one-pass sum of
        squares in float64 loses on money columns). (var[n_groups],
        count[n_groups]); var is NaN where count < 2."""
        vt, mt = self._upload(values, valid)
        vt = vt.to(torch.float64)
        s, cnt = seg_agg(self.codes, vt, mt, "sum", self.n_groups)
        means = s / torch.clamp(cnt, min=1).to(torch.float64)
        ss, _ = seg_agg(self.codes, vt, mt, "sumsq", self.n_groups, means)
        cnt_np = cnt.cpu().numpy()
        ss_np = ss.cpu().numpy()
        with np.errstate(invalid="ignore", divide="ignore"):
            var = np.where(cnt_np >= 2, ss_np / np.maximum(cnt_np - 1, 1),
                           np.nan)
        return var, cnt_np


# ----------------------------------------------------------- join ----

def _expand_pairs(s_key: np.ndarray, s_side: np.ndarray, s_pos: np.ndarray,
                  r_offset: int, how: str) -> Tuple[np.ndarray, np.ndarray]:
    """O(output) host pair expansion over key-sorted (key, side, position)
    triples: one run per distinct key, every left x right combination per
    run; the rows `how` preserves unmatched get the other side's index
    -1. Right positions are rebased by `r_offset` into right-side
    indices."""
    empty = np.empty(0, np.int64)
    m = len(s_key)
    if m == 0:
        return empty, empty
    s_side = np.asarray(s_side, np.int64)
    s_pos = np.asarray(s_pos, np.int64)
    starts = np.flatnonzero(
        np.concatenate([[True], s_key[1:] != s_key[:-1]]))
    run_len = np.diff(np.concatenate([starts, [m]]))
    n_r = np.add.reduceat(s_side, starts).astype(np.int64)
    n_l = run_len - n_r

    pairs = n_l * n_r
    total = int(pairs.sum())
    run_of = np.repeat(np.arange(len(starts)), pairs)
    off = np.concatenate([[0], np.cumsum(pairs)[:-1]])
    within = np.arange(total, dtype=np.int64) - off[run_of]
    nr_run = n_r[run_of]
    li = within // np.maximum(nr_run, 1)
    ri = within - li * nr_run
    l_idx = s_pos[starts[run_of] + li]
    r_idx = s_pos[starts[run_of] + n_l[run_of] + ri] - r_offset

    extras_l = extras_r = None
    if how != "inner":
        run_of_sorted = np.repeat(np.arange(len(starts)), run_len)
    if how in ("left", "outer"):
        sel = (n_r[run_of_sorted] == 0) & (s_side == 0)
        extras_l = s_pos[sel]
    if how in ("right", "outer"):
        sel = (n_l[run_of_sorted] == 0) & (s_side == 1)
        extras_r = s_pos[sel] - r_offset
    if extras_l is not None and len(extras_l):
        l_idx = np.concatenate([l_idx, extras_l])
        r_idx = np.concatenate([r_idx, np.full(len(extras_l), -1, np.int64)])
    if extras_r is not None and len(extras_r):
        l_idx = np.concatenate([l_idx, np.full(len(extras_r), -1, np.int64)])
        r_idx = np.concatenate([r_idx, extras_r])
    return l_idx.astype(np.int64), r_idx.astype(np.int64)


def join_pairs(l_codes: np.ndarray, r_codes: np.ndarray, how: str = "inner",
               device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Many-to-many equi-join on dense codes (< 2^31) of both sides.
    (l_idx, r_idx) int64 pair indices; the unmatched rows `how`
    preserves appear with the other side's index -1. The device sorts the
    composite (code, side); the host expands the pairs."""
    dev = _device(device)
    nl, nr = int(len(l_codes)), int(len(r_codes))
    if nl + nr == 0:
        empty = np.empty(0, np.int64)
        return empty, empty
    codes = torch.from_numpy(np.concatenate([
        np.asarray(l_codes, np.int32), np.asarray(r_codes, np.int32)])).to(dev)
    s_code, s_pos = sort_codes(codes, nl)
    s_code = s_code.cpu().numpy()
    s_pos = s_pos.cpu().numpy().astype(np.int64)
    return _expand_pairs(s_code, s_pos >= nl, s_pos, nl, how)


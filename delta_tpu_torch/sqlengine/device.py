"""DeviceSpine: the SQL executor's relational core (GROUP BY aggregation,
equi-join, the lookups and membership tests of subqueries and set
operations, window functions, ORDER BY sort) on the engine's device.

Counterpart of `delta_tpu/sqlengine/device.py::DeviceSpine`: `groupby`
(`:211`, with COUNT(DISTINCT) at `:262-266`), `merge` (`:297`, every
`how`), `gather` (`_gather`, `:368`), `_order_lanes` (`:384`),
`sort_frame` (`:415`) and the windows: `partition_transform` (`:438`),
`_window_order` (`:473`), `window_rank` (`:502`) and `window_running`
(`:521`). The reference decorrelates subqueries and tests INTERSECT and
EXCEPT rows in per-row Python dictionaries and data frame merges
(`executor.py:1524-1647`, `:100-111`); here they are left joins on the
card: `match_codes` (a left row's first right row of the same code),
`lookup` (of key tuples; a NULL key never matches) and `member` (a
semi-join). The host dictionary-codes the keys and rebuilds output rows
with O(output) takes; the device sorts, reduces and scans
(`ops/sqlops.py`: stable `torch.sort`, kernel K10; `ops/window.py`:
kernel K11). There is no routing gate and no host fallback: on a CUDA
engine every GROUP BY aggregate, DISTINCT aggregate and partition window
goes through K10, every ranking and running window through K11, every
join, lookup, membership test, window and ORDER BY sorts on the card, and
a build or launch failure raises. On a CPU engine the same code runs the
plain versions on CPU tensors. The resident operand cache and the
routing gate of the reference are not ported.

What stays on the host, as in the reference: a string MIN or MAX (the
reference's `unsupported-agg-dtype` fallback), counted on
`sql.host_string_aggs` so that it is visible. A running window over a
string or a date (where the reference's `unsupported-window-agg` falls
back to its host path) is refused.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.errors import UnsupportedSqlError
from delta_tpu_torch.models.batch import Column, factorize_objects
from delta_tpu_torch.ops import sqlops, window
from delta_tpu_torch.ops.join import joint_codes
from delta_tpu_torch.sqlengine.frame import (Frame, column, null_rows,
                                             valid_of)

GROUPBYS = obs.counter("sql.device_groupbys")
JOINS = obs.counter("sql.device_joins")
SORTS = obs.counter("sql.device_sorts")
WINDOWS = obs.counter("sql.device_windows")
HOST_STRING_AGGS = obs.counter("sql.host_string_aggs")

_SUPPORTED_AGGS = {"sum", "count", "avg", "min", "max", "stddev_samp",
                   "var_samp"}
_CODE_LIMIT = 1 << 31


def _dense(codes: np.ndarray) -> Tuple[np.ndarray, int]:
    uniq, inv = np.unique(codes, return_inverse=True)
    return inv.reshape(-1).astype(np.int64), int(len(uniq))


def _value_codes(values: np.ndarray) -> np.ndarray:
    if values.dtype == object:
        return factorize_objects(values)
    return _dense(values)[0]


def _column_value_codes(c: Column) -> np.ndarray:
    """Dense codes of a Column's valid values (0 where NULL)."""
    valid = valid_of(c)
    out = np.zeros(len(c), np.int64)
    if valid.any():
        out[valid] = _value_codes(c.values[valid])
    return out


def group_codes(keys: Sequence[Column]
                ) -> Tuple[np.ndarray, int, np.ndarray]:
    """(dense int64 codes of the key tuples, the number of groups, each
    group's first row); NULL is a key value of its own (the
    reference groups with `dropna=False`)."""
    n = len(keys[0])
    codes = np.zeros(n, np.int64)
    for k in keys:
        valid = valid_of(k)
        c = np.zeros(n, np.int64)
        if valid.all():
            c = _value_codes(k.values)
        elif valid.any():
            c[valid] = _value_codes(k.values[valid])
        top = int(c.max(initial=-1)) + 1
        c[~valid] = top
        codes = codes * (top + 1) + c
        if int(codes.max(initial=0)) >= _CODE_LIMIT:
            codes = _dense(codes)[0]
    uniq, first, inv = np.unique(codes, return_index=True,
                                 return_inverse=True)
    return inv.reshape(-1).astype(np.int64), int(len(uniq)), first


class DeviceSpine:
    """The executor's device operators for one engine device."""

    def __init__(self, device):
        self.device = device

    # ------------------------------------------------------ group-by --

    def groupby(self, keys: List[Column], specs: List[tuple], n_rows: int
                ) -> Tuple[List[Column], List[Column]]:
        """Aggregate `specs` [(func name, arg Column or None for *,
        distinct)] over the groups of `keys` (none: one global group) of
        `n_rows` rows. Returns (the key Columns at each group's first row,
        the aggregate Columns)."""
        if keys:
            codes, n_groups, first = group_codes(keys)
        else:
            codes, n_groups = np.zeros(n_rows, np.int64), 1
        ga = sqlops.GroupAggregator(codes, n_groups, device=self.device)
        GROUPBYS.inc()
        out_keys = [k.take(first) for k in keys]
        aggs = [self._aggregate(ga, name, arg, codes, n_groups, distinct)
                for name, arg, distinct in specs]
        return out_keys, aggs

    def _aggregate(self, ga, name: str, arg: Optional[Column],
                   codes: np.ndarray, n_groups: int,
                   distinct: bool = False) -> Column:
        if name not in _SUPPORTED_AGGS:
            raise UnsupportedSqlError(f"aggregate {name} is not supported",
                                      construct=name)
        if arg is None:  # count(*)
            return Column(ga.sizes())
        if distinct:
            # the (group, value) pairs sorted on the card: COUNT counts
            # each run's first row (K10), the others aggregate one row of
            # each run (K10)
            vc = _column_value_codes(arg)
            if name == "count":
                return Column(ga.count_distinct(vc, arg.valid))
            rows = ga.distinct_rows(vc, arg.valid)
            sub = sqlops.GroupAggregator(codes[rows], n_groups,
                                         device=self.device)
            return self._aggregate(sub, name, arg.take(rows), codes[rows],
                                   n_groups)
        v, valid = arg.values, arg.valid
        kind = v.dtype.kind
        if name == "count":
            return Column(ga.count(valid))
        if kind == "O":
            if name in ("min", "max"):
                return self._host_string_minmax(name, v, valid_of(arg),
                                                codes, n_groups)
            raise UnsupportedSqlError(
                f"{name} over a string column is not supported",
                construct=f"{name}(string)")
        if kind == "M":
            if name not in ("min", "max"):
                raise UnsupportedSqlError(
                    f"{name} over a date or timestamp is not supported",
                    construct=f"{name}(date)")
            agg, cnt = ga.reduce(v.view(np.int64), valid, name)
            return Column(agg.view(v.dtype), cnt > 0)
        if kind == "b":
            v = v.astype(np.int64)
            kind = "i"
        if name in ("stddev_samp", "var_samp"):
            var, _ = ga.var(v, valid)
            return column(np.sqrt(var) if name == "stddev_samp" else var)
        if name == "avg":
            # summed as float64, as the reference and Spark's avg do: an
            # int64 sum would wrap past 2^63
            s, cnt = ga.reduce(np.asarray(v, np.float64), valid, "sum")
            with np.errstate(all="ignore"):
                mean = s / np.maximum(cnt, 1)
            return column(mean, cnt > 0)
        agg, cnt = ga.reduce(v, valid, name)
        return column(agg, cnt > 0)

    @staticmethod
    def _host_string_minmax(name: str, v: np.ndarray, valid: np.ndarray,
                            codes: np.ndarray, n_groups: int) -> Column:
        HOST_STRING_AGGS.inc()
        out = np.empty(n_groups, object)
        out[:] = ""
        have = np.zeros(n_groups, bool)
        better = (lambda a, b: a < b) if name == "min" \
            else (lambda a, b: a > b)
        for g, s in zip(codes[valid].tolist(), v[valid].tolist()):
            if not have[g] or better(s, out[g]):
                out[g] = s
                have[g] = True
        return column(out, have)

    # --------------------------------------------------------- joins --

    def merge(self, left: Frame, right: Frame, lk: List[str],
              rk: List[str], how: str = "inner") -> Frame:
        """Equi-join of null-free keys, every column of both sides; `how`
        ("inner", "left", "right", "outer") keeps the unmatched rows of the
        sides it preserves, the other side's columns NULL."""
        codes = joint_codes([left[a].values for a in lk],
                            [right[b].values for b in rk])
        nl = len(left)
        l_idx, r_idx = sqlops.join_pairs(codes[:nl], codes[nl:], how=how,
                                         device=self.device)
        JOINS.inc()
        return self.gather(left, right, l_idx, r_idx)

    @staticmethod
    def gather(left: Frame, right: Frame, l_idx: np.ndarray,
                r_idx: np.ndarray) -> Frame:
        """Rows of both sides by index; an index of -1 gives a NULL of the
        column's own type (a null-extended row of an outer join)."""
        cols = {k: take_or_null(c, l_idx) for k, c in left.cols.items()}
        cols.update({k: take_or_null(c, r_idx)
                     for k, c in right.cols.items()})
        return Frame(cols, len(l_idx))

    def match_codes(self, l_codes: np.ndarray, r_codes: np.ndarray
                    ) -> np.ndarray:
        """Per left row, a right row of the same code (the first, in input
        order), -1 where there is none: a left join against the right's
        distinct codes (dense, < 2^31)."""
        out = np.full(len(l_codes), -1, np.int64)
        if not len(l_codes) or not len(r_codes):
            return out
        uniq, first = np.unique(r_codes, return_index=True)
        l_idx, u_idx = sqlops.join_pairs(l_codes, uniq, how="left",
                                         device=self.device)
        JOINS.inc()
        hit = u_idx >= 0
        out[l_idx[hit]] = first[u_idx[hit]]
        return out

    def lookup(self, left: List[Column], right: List[Column]) -> np.ndarray:
        """Per left row, a right row whose key tuple equals its own (the
        first), -1 where there is none. A NULL key on either side never
        matches (`k = NULL` is UNKNOWN)."""
        nl = len(left[0])
        out = np.full(nl, -1, np.int64)
        l_rows = np.flatnonzero(~null_rows(left))
        r_rows = np.flatnonzero(~null_rows(right))
        if not len(l_rows) or not len(r_rows):
            return out
        codes = joint_codes([c.values[l_rows] for c in left],
                            [c.values[r_rows] for c in right])
        got = self.match_codes(codes[:len(l_rows)], codes[len(l_rows):])
        hit = got >= 0
        out[l_rows[hit]] = r_rows[got[hit]]
        return out

    def member(self, left: List[Column], right: List[Column]) -> np.ndarray:
        """Per left row, whether some right row has its key tuple (a
        semi-join; NULL keys never match)."""
        return self.lookup(left, right) >= 0

    @staticmethod
    def cross(left: Frame, right: Frame) -> Frame:
        nl, nr = len(left), len(right)
        return DeviceSpine.gather(left, right,
                                  np.repeat(np.arange(nl), nr),
                                  np.tile(np.arange(nr), nl))

    # --------------------------------------------------------- sorts --

    @staticmethod
    def _order_lanes(c: Column, asc: bool) -> list:
        """One ORDER BY key as ascending lanes: a null lane (NULLS FIRST
        when ascending, LAST when descending, Spark's rule) and a
        direction-folded value lane."""
        v = c.values
        isna = ~valid_of(c)
        if v.dtype == object:
            codes = np.zeros(len(v), np.int64)
            ok = ~isna
            if ok.any():
                _, inv = np.unique(v[ok], return_inverse=True)
                codes[ok] = inv.reshape(-1)
            vals = codes
        elif v.dtype.kind == "M":
            vals = np.where(isna, 0, v.view(np.int64))
        elif v.dtype.kind == "f":
            vals = np.where(isna, 0.0, v)
        else:
            vals = np.where(isna, 0, v.astype(np.int64))
        null_lane = np.where(isna, 0 if asc else 1, 1 if asc else 0) \
            .astype(np.uint8)
        if not asc:
            vals = -vals
        return [null_lane, vals]

    def sort_permutation(self, keys: List[Column], ascs: List[bool]
                         ) -> np.ndarray:
        """`_sql_sort` on the device: the stable multi-key permutation
        with Spark's null order."""
        n = len(keys[0])
        if n == 0:
            return np.empty(0, np.int64)
        lanes = []
        for c, asc in zip(keys, ascs):
            lanes.extend(self._order_lanes(c, asc))
        SORTS.inc()
        return sqlops.sort_permutation(lanes, device=self.device)

    # ------------------------------------------------------- windows --

    def partition_transform(self, parts: List[Column], name: str,
                            arg: Optional[Column], n: int) -> Column:
        """An aggregate window with no ORDER BY: `name` (sum, avg, min,
        max, count; arg None for count(*)) per partition of `parts` (none:
        every row one partition) through K10, then gathered back to the
        rows. A partition with no valid value gives NULL (COUNT 0)."""
        WINDOWS.inc()
        if parts:
            codes, n_groups, _ = group_codes(parts)
        else:
            codes, n_groups = np.zeros(n, np.int64), 1
        ga = sqlops.GroupAggregator(codes, n_groups, device=self.device)
        agg = self._aggregate(ga, name, arg, codes, n_groups)
        return agg.take(codes)

    def _window_order(self, parts: List[Column], order_items: list, n: int):
        """The window's rows sorted on the card by (partition code, order
        keys with `_order_lanes`' NULL order): (perm, pb, kb) device
        tensors (`ops/sqlops.py::window_order`)."""
        part_codes = group_codes(parts)[0] if parts else None
        lanes = []
        for c, asc in order_items:
            lanes.extend(self._order_lanes(c, asc))
        SORTS.inc()
        return sqlops.window_order(part_codes, lanes, n, device=self.device)

    def window_rank(self, parts: List[Column], order_items: list,
                    which: str, n: int) -> Column:
        """row_number, rank or dense_rank of each row (int64): the card's
        sort, then K11's ranks, scattered back to the rows' order."""
        WINDOWS.inc()
        if n == 0:
            return Column(np.empty(0, np.int64))
        perm, pb, kb = self._window_order(parts, order_items, n)
        rn, rk, dr = window.window_ranks(pb, kb)
        picked = {"row_number": rn, "rank": rk, "dense_rank": dr}[which]
        out = torch.empty_like(picked)
        out[perm] = picked
        return Column(out.cpu().numpy())

    def window_running(self, parts: List[Column], order_items: list,
                       name: str, arg: Optional[Column], frame: str,
                       n: int) -> Column:
        """A running aggregate with ORDER BY (the frame from the
        partition's first row to this one): the card's sort, K11's running
        scan, and for the RANGE frame (SQL's default) K11's peer pass, so
        that rows of equal order keys share the value at their run's last
        row; a ROWS frame skips it. COUNT is int64; the others float64,
        NULL where no valid value came before."""
        WINDOWS.inc()
        if n == 0:
            return Column(np.empty(0, np.int64 if name == "count"
                                   else np.float64))
        op = {"avg": "mean"}.get(name, name)
        if arg is None:
            v, valid = np.zeros(n, np.float64), np.ones(n, bool)
        else:
            kind = arg.values.dtype.kind
            if kind not in "biuf" and name != "count":
                raise UnsupportedSqlError(
                    f"running {name} over a {arg.values.dtype} column is "
                    "not supported", construct=f"running {name}")
            v = arg.values.astype(np.float64) if kind in "biuf" \
                else np.zeros(n, np.float64)
            valid = valid_of(arg)
        perm, pb, kb = self._window_order(parts, order_items, n)
        dev = perm.device
        vt = torch.from_numpy(np.ascontiguousarray(v)).to(dev)[perm]
        mt = torch.from_numpy(np.ascontiguousarray(valid)).to(dev)[perm]
        vals, cnts = window.window_running(vt, mt, pb, op)
        if frame != "rows":
            vals, cnts = window.window_peer_last(vals, cnts, kb)
        out_v = torch.empty_like(vals)
        out_c = torch.empty_like(cnts)
        out_v[perm] = vals
        out_c[perm] = cnts
        counts = out_c.cpu().numpy()
        if name == "count":
            return Column(counts)
        return column(out_v.cpu().numpy(), counts > 0)


def take_or_null(c: Column, idx: np.ndarray) -> Column:
    """`c.take(idx)` where an index of -1 gives a NULL of the column's own
    type (not a float NaN)."""
    missing = idx < 0
    if not missing.any():
        return c.take(idx)
    if not len(c):
        return Column.nulls(c.values.dtype, len(idx), c.data_type)
    got = c.take(np.where(missing, 0, idx))
    return Column(got.values, valid_of(got) & ~missing, got.data_type)

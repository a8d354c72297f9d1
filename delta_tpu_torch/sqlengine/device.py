"""DeviceSpine: the SQL executor's relational core (GROUP BY aggregation,
equi-join, the lookups and membership tests of subqueries and set
operations, ORDER BY sort) on the engine's device.

Counterpart of `delta_tpu/sqlengine/device.py::DeviceSpine`: `groupby`
(`:211`), `merge` (`:297`), `_gather` (`:368`), `_order_lanes` (`:384`)
and `sort_frame` (`:415`). The reference decorrelates subqueries and
tests INTERSECT and EXCEPT rows in per-row Python dictionaries and data
frame merges (`executor.py:1524-1647`, `:100-111`); here they are left
joins on the card: `match_codes` (a left row's first right row of the
same code), `lookup` (of key tuples; a NULL key never matches) and
`member` (a semi-join). The host dictionary-codes the keys and rebuilds
output rows with O(output) takes; the device sorts and reduces
(`ops/sqlops.py`: stable `torch.sort`, kernel K10). There is no routing
gate and no host fallback: on a CUDA engine every GROUP BY aggregate goes
through K10, every join, lookup, membership test and ORDER BY sorts on
the card, and a build or launch failure raises. On a CPU engine the same
code runs the plain versions on CPU tensors. The windows (`:438-556`),
the resident operand cache and the routing gate of the reference are not
ported.

What stays on the host, as in the reference: a string MIN or MAX (the
reference's `unsupported-agg-dtype` fallback), counted on
`sql.host_string_aggs` so that it is visible.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch import obs
from delta_tpu_torch.errors import UnsupportedSqlError
from delta_tpu_torch.models.batch import Column, factorize_objects
from delta_tpu_torch.ops import sqlops
from delta_tpu_torch.ops.join import joint_codes
from delta_tpu_torch.sqlengine.frame import (Frame, column, null_rows,
                                             valid_of)

GROUPBYS = obs.counter("sql.device_groupbys")
JOINS = obs.counter("sql.device_joins")
SORTS = obs.counter("sql.device_sorts")
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
        """Aggregate `specs` [(func name, arg Column or None for *)] over
        the groups of `keys` (none: one global group) of `n_rows` rows.
        Returns (the key Columns at each group's first row, the aggregate
        Columns)."""
        if keys:
            codes, n_groups, first = group_codes(keys)
        else:
            codes, n_groups = np.zeros(n_rows, np.int64), 1
        ga = sqlops.GroupAggregator(codes, n_groups, device=self.device)
        GROUPBYS.inc()
        out_keys = [k.take(first) for k in keys]
        aggs = [self._aggregate(ga, name, arg, codes, n_groups)
                for name, arg in specs]
        return out_keys, aggs

    def _aggregate(self, ga, name: str, arg: Optional[Column],
                   codes: np.ndarray, n_groups: int) -> Column:
        if name not in _SUPPORTED_AGGS:
            raise UnsupportedSqlError(f"aggregate {name} is not supported",
                                      construct=name)
        if arg is None:  # count(*)
            return Column(ga.sizes())
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
              rk: List[str]) -> Frame:
        """Inner equi-join of null-free keys, every column of both
        sides."""
        codes = joint_codes([left[a].values for a in lk],
                            [right[b].values for b in rk])
        nl = len(left)
        l_idx, r_idx = sqlops.join_pairs(codes[:nl], codes[nl:], how="inner",
                                         device=self.device)
        JOINS.inc()
        return self._gather(left, right, l_idx, r_idx)

    @staticmethod
    def _gather(left: Frame, right: Frame, l_idx: np.ndarray,
                r_idx: np.ndarray) -> Frame:
        cols = {k: c.take(l_idx) for k, c in left.cols.items()}
        cols.update({k: c.take(r_idx) for k, c in right.cols.items()})
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
        return DeviceSpine._gather(left, right,
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

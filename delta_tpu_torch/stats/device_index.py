"""Resident stats index for scan planning.

Counterpart of `delta_tpu/stats/device_index.py`. Once per snapshot
version, the parsed file stats (`stats/skipping.py::StatsIndex`) are
columnarized into a dense int64 lane matrix over every skipping-eligible
column (numeric, timestamp, date and boolean leaves whose min and max
parsed to a comparable kind):

  row 3c   : minValues  of eligible column c
  row 3c+1 : maxValues  of eligible column c
  row 3c+2 : nullCount  of eligible column c
  row -1   : numRecords

plus a validity matrix (a missing or unreadable stat is invalid, which
means unknown, which keeps the file). Every lane is int64 in an
order-preserving encoding (`_enc_f64` for floats; timestamps and dates
as epoch microseconds), so `ops/skipping.py` evaluates a whole conjunct
list against every file in one type-agnostic call. Columns: the live
files of the state in row order, unpadded ([R, F], F = live files).

Lifecycle: built at most once per `SnapshotState`, under the state's own
`stats_index_lock`, on the first filtered scan; the lanes go to the
engine's device then (`device_lanes`, one upload per version) and stay
there for every later scan of that version (`scan.stats_index_reuses`
counts those; `scan.stats_index_builds` the builds).
`replay/state.py::advance_state` moves the index to the new state when
the delta holds no file action and releases it otherwise (the next scan
rebuilds); `api.read_table` releases it at the end of its one-shot read.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.obs import PhaseTimer
from delta_tpu_torch.expressions.eval import Values, scalar_kind
from delta_tpu_torch.expressions.tree import (
    Column,
    Comparison,
    Expression,
    In,
    IsNotNull,
    IsNull,
    Literal,
    Not,
    Or,
)
from delta_tpu_torch.ops.skipping import AtomBlock
from delta_tpu_torch.stats.skipping import StatsIndex, _Struct
from delta_tpu_torch.utils.timestamps import string_to_us

_BUILDS = obs.counter("scan.stats_index_builds")
_REUSES = obs.counter("scan.stats_index_reuses")

_OP_CODES = {"<": 0, "<=": 1, ">": 2, ">=": 3, "=": 4, "!=": 5}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}
_NEG = {"=": "!=", "!=": "=", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}
_OP_ISNULL = 6
_OP_ISNOTNULL = 7

# an int cast to float64 is exact only within +/-2^53; literals outside
# that window fall back to the ladder rather than compare inexactly
_F64_EXACT_INT = 1 << 53

# IN lists longer than this compile to a range prefilter (two atoms)
# instead of one '=' atom per value
IN_LIST_ATOM_LIMIT = 64

_INT_RE_OK = frozenset("0123456789")


def _enc_f64(a: np.ndarray) -> np.ndarray:
    """Order-preserving float64 -> int64 encoding (sign-magnitude IEEE
    bits flipped into two's complement); -0.0 becomes +0.0 first so both
    compare equal to 0."""
    a = np.asarray(a, np.float64) + 0.0
    u = a.view(np.int64)
    return np.where(u >= 0, u, np.int64(np.iinfo(np.int64).min) ^ ~u)


def _lane_kind(leaf) -> Optional[str]:
    """Encoding kind of a parsed stat leaf; None = ineligible."""
    if not isinstance(leaf, Values):
        return None
    return leaf.kind if leaf.kind in ("bool", "int", "float", "ts") else None


def _resolve_kind(k_min: Optional[str], k_max: Optional[str]
                  ) -> Optional[str]:
    """Unify the min and max kinds (each JSON field is inferred on its
    own, so `min=1, max=1.5` parses as int64 and float64)."""
    if k_min is None or k_max is None:
        return None
    if k_min == k_max:
        return k_min
    if {k_min, k_max} == {"int", "float"}:
        return "float"
    return None


def _leaf_paths(node: _Struct, prefix: Tuple[str, ...] = ()) -> List[tuple]:
    out = []
    for name, child in node.fields.items():
        p = prefix + (name,)
        if isinstance(child, _Struct):
            out.extend(_leaf_paths(child, p))
        else:
            out.append(p)
    return out


def _cast_int64(leaf) -> Optional[np.ndarray]:
    """A leaf's values as int64, as Arrow's safe cast gives them; None
    where the cast refuses (a fraction, a non-integer string, a struct)."""
    if not isinstance(leaf, Values):
        return None
    v = leaf.valid
    if leaf.kind in ("int", "bool", "null"):
        return leaf.data.astype(np.int64)
    if leaf.kind == "ts":  # the raw value in the column's unit, seconds
        return leaf.data // 1_000_000
    if leaf.kind == "float":
        f = leaf.data[v]
        if not np.all(np.isfinite(f) & (f == np.floor(f))
                      & (np.abs(f) < 2.0 ** 63)):
            return None
        out = np.zeros(len(leaf), np.int64)
        out[v] = f.astype(np.int64)
        return out
    if leaf.kind == "string":
        out = np.zeros(len(leaf), np.int64)
        for i in np.nonzero(v)[0].tolist():
            s = leaf.data[i]
            digits = s[1:] if s[:1] in ("+", "-") else s
            if not digits or not set(digits) <= _INT_RE_OK:
                return None
            x = int(s)
            if not -(1 << 63) <= x < (1 << 63):
                return None
            out[i] = x
        return out
    return None


def _encode_lane(leaf, kind: str):
    """(int64 values, validity) of one stat leaf under `kind`; invalid
    slots hold 0. None when the whole leaf cannot be encoded."""
    if not isinstance(leaf, Values):
        return None
    valid = leaf.valid.copy()
    if kind in ("bool", "int"):
        enc = _cast_int64(leaf)
        if enc is None:
            return None
    elif kind == "float":
        if leaf.kind == "int":
            # Arrow's safe int64 -> float64 cast refuses the whole leaf
            # when any value lies past 2^53
            if np.any(np.abs(leaf.data[valid]) > _F64_EXACT_INT):
                return None
            f = leaf.data.astype(np.float64)
        elif leaf.kind == "float":
            f = leaf.data
        else:
            return None
        valid &= ~np.isnan(f)
        enc = _enc_f64(f)
    elif kind == "ts":
        if leaf.kind != "ts":
            return None
        enc = leaf.data.copy()
    else:
        return None
    enc = np.where(valid, enc, 0).astype(np.int64)
    return enc, valid


def encode_literal(value, kind: str) -> Optional[int]:
    """A predicate literal in the lane's int64 order; None = not exactly
    representable (the conjunct falls back to the ladder)."""
    if value is None:
        return None
    if kind == "bool":
        return int(value) if isinstance(value, bool) else None
    if isinstance(value, bool):
        return None
    if kind == "int":
        if isinstance(value, (int, np.integer)):
            v = int(value)
            return v if -(1 << 63) <= v < (1 << 63) else None
        return None
    if kind == "float":
        if isinstance(value, (int, np.integer)):
            if abs(int(value)) > _F64_EXACT_INT:
                return None
            value = float(value)
        if isinstance(value, (float, np.floating)):
            f = np.float64(value)
            if np.isnan(f):
                return None
            return int(_enc_f64(np.asarray([f]))[0])
        return None
    if kind == "ts":
        if isinstance(value, datetime.datetime) and value.tzinfo is not None:
            return None
        if isinstance(value, str):
            return string_to_us(value)
        if isinstance(value, (datetime.date, datetime.datetime)):
            k, v = scalar_kind(value)
            return v * 86_400_000_000 if k == "date" else v
        return None
    return None


class ResidentStatsIndex:
    """One snapshot version's stats index: the parsed columns (shared with
    the ladder) and the encoded int64 lanes on the host, with one copy on
    the engine's device made on first use."""

    def __init__(self, host_index: StatsIndex, vals: Optional[np.ndarray],
                 valid: Optional[np.ndarray],
                 cols: Dict[tuple, Tuple[int, str]], n: int, device=None):
        self._lock = threading.Lock()
        self.host_index = host_index
        self.vals = vals          # int64 [R, n] or None
        self.valid = valid        # bool  [R, n] or None
        self.cols = cols          # {name_path: (min row, kind)}
        self.n = n
        self.device = torch.device("cpu") if device is None else device
        self.released = False
        self._dev = None
        # wall seconds of the build's phases (stats, parse, lanes) and of
        # the upload, for the scan cell's split
        self.phase_seconds: Dict[str, float] = {}

    @property
    def has_lanes(self) -> bool:
        return self.vals is not None and not self.released

    def device_lanes(self):
        """(values, validity) tensors on the engine's device, uploaded
        once."""
        with self._lock:
            if self._dev is None and self.vals is not None:
                t0 = time.perf_counter()
                self._dev = (torch.from_numpy(self.vals).to(self.device),
                             torch.from_numpy(self.valid).to(self.device))
                self.phase_seconds["upload"] = time.perf_counter() - t0
            return self._dev

    @property
    def device_bytes(self) -> int:
        dev = self._dev
        return 0 if dev is None else sum(
            t.numel() * t.element_size() for t in dev)

    def release(self) -> None:
        """Drop the lanes and their device copy; the next scan of a
        still-live snapshot rebuilds."""
        with self._lock:
            self._dev = None
            self.vals = None
            self.valid = None
            self.released = True


def build_index(stats, device=None, mark=None) -> ResidentStatsIndex:
    """Columnarize one snapshot version's stats strings into lanes
    (`mark`, a PhaseTimer, gets "parse" and "lanes")."""
    host = StatsIndex.from_stats(stats)
    n = host.n
    if mark is not None:
        mark("parse")

    def empty():
        return ResidentStatsIndex(host, None, None, {}, n, device)

    if host._table is None:
        return empty()
    mins = host._table.fields.get("minValues")
    maxs = host._table.fields.get("maxValues")
    if not isinstance(mins, _Struct) or not isinstance(maxs, _Struct):
        return empty()
    lanes: List[Tuple[np.ndarray, np.ndarray]] = []
    cols: Dict[tuple, Tuple[int, str]] = {}
    for path in _leaf_paths(mins):
        mn, mx = host.min_values(path), host.max_values(path)
        if mn is None or mx is None:
            continue
        kind = _resolve_kind(_lane_kind(mn), _lane_kind(mx))
        if kind is None:
            continue
        enc_mn, enc_mx = _encode_lane(mn, kind), _encode_lane(mx, kind)
        if enc_mn is None or enc_mx is None:
            continue
        nc = host.null_count(path)
        enc_nc = _encode_lane(nc, "int") if nc is not None else None
        if enc_nc is None:
            enc_nc = (np.zeros(n, np.int64), np.zeros(n, bool))
        cols[path] = (len(lanes), kind)
        lanes.extend((enc_mn, enc_mx, enc_nc))
    if not cols:
        return empty()
    nr = host.num_records()
    enc_nr = _encode_lane(nr, "int") if nr is not None else None
    if enc_nr is None:
        enc_nr = (np.zeros(n, np.int64), np.zeros(n, bool))
    lanes.append(enc_nr)
    vals = np.ascontiguousarray(np.stack([v for v, _ in lanes]))
    valid = np.ascontiguousarray(np.stack([m for _, m in lanes]))
    if mark is not None:
        mark("lanes")
    return ResidentStatsIndex(host, vals, valid, cols, n, device)


def _compile_conj(conj: Expression, cols: Dict[tuple, Tuple[int, str]]):
    """One conjunct as a list of OR-groups of atoms (min row, op code,
    encoded literal); None = not compilable (the ladder takes it)."""
    if isinstance(conj, Comparison):
        if isinstance(conj.left, Column) and isinstance(conj.right, Literal):
            colref, lit, op = conj.left, conj.right, conj.op
        elif isinstance(conj.right, Column) \
                and isinstance(conj.left, Literal):
            colref, lit, op = conj.right, conj.left, _FLIP[conj.op]
        else:
            return None
        ent = cols.get(colref.name_path)
        if ent is None or op not in _OP_CODES:
            return None
        enc = encode_literal(lit.value, ent[1])
        if enc is None:
            return None
        return [[(ent[0], _OP_CODES[op], enc)]]
    if isinstance(conj, Or):
        left = _compile_conj(conj.left, cols)
        right = _compile_conj(conj.right, cols)
        if left is None or right is None or len(left) != 1 \
                or len(right) != 1:
            # an AND under an OR does not flatten into atom groups
            return None
        return [left[0] + right[0]]
    if isinstance(conj, (IsNull, IsNotNull)):
        child = conj.child
        ent = cols.get(child.name_path) if isinstance(child, Column) \
            else None
        if ent is None:
            return None
        code = _OP_ISNULL if isinstance(conj, IsNull) else _OP_ISNOTNULL
        return [[(ent[0], code, 0)]]
    if isinstance(conj, In):
        if not isinstance(conj.child, Column) or not conj.values:
            return None
        ent = cols.get(conj.child.name_path)
        if ent is None:
            return None
        encs = []
        for v in conj.values:
            e = encode_literal(v, ent[1])
            if e is None:
                return None
            encs.append(e)
        if len(encs) > IN_LIST_ATOM_LIMIT:
            # the encoding preserves order, so the encoded min and max
            # bound the raw values
            return [[(ent[0], _OP_CODES[">="], min(encs))],
                    [(ent[0], _OP_CODES["<="], max(encs))]]
        return [[(ent[0], _OP_CODES["="], e) for e in encs]]
    if isinstance(conj, Not):
        inner = conj.child
        if isinstance(inner, Comparison):
            return _compile_conj(
                Comparison(_NEG[inner.op], inner.left, inner.right), cols)
        if isinstance(inner, IsNull):
            return _compile_conj(IsNotNull(inner.child), cols)
        if isinstance(inner, IsNotNull):
            return _compile_conj(IsNull(inner.child), cols)
        return None
    return None


def compile_conjuncts(conjuncts: List[Expression],
                      index: ResidentStatsIndex):
    """(AtomBlock of every compilable conjunct or None, the rest)."""
    if not index.has_lanes:
        return None, list(conjuncts)
    rows_mn: List[int] = []
    ops: List[int] = []
    lits: List[int] = []
    grp: List[int] = []
    fallback: List[Expression] = []
    n_groups = 0
    for conj in conjuncts:
        groups = _compile_conj(conj, index.cols)
        if groups is None:
            fallback.append(conj)
            continue
        for g in groups:
            for (row0, code, enc) in g:
                rows_mn.append(row0)
                ops.append(code)
                lits.append(enc)
                grp.append(n_groups)
            n_groups += 1
    if not rows_mn:
        return None, fallback
    rmn = np.asarray(rows_mn, np.int32)
    block = AtomBlock(
        rows_mn=rmn, rows_mx=rmn + 1, rows_nc=rmn + 2,
        ops=np.asarray(ops, np.int32), lits=np.asarray(lits, np.int64),
        grp=np.asarray(grp, np.int32), n_atoms=len(rows_mn),
        n_groups=n_groups)
    return block, fallback


def snapshot_stats_index(state, engine=None) -> ResidentStatsIndex:
    """The state's resident index over its live files, built on first
    use from their stats strings, its lanes for the engine's device."""
    with state.stats_index_lock:
        idx = state.stats_index
        if idx is not None and not idx.released:
            _REUSES.inc()
            return idx
        device = getattr(engine, "device", None)
        if device is None:
            device = state.live_mask.device
        mark = PhaseTimer()
        stats = state.live_stats()
        mark("stats")
        idx = build_index(stats, device=device, mark=mark)
        idx.phase_seconds.update(mark.seconds)
        # the lanes are tensors the state holds: a state dropped outside
        # the explicit release paths frees them with it
        state.stats_index = idx
        _BUILDS.inc()
        return idx


def release_state_stats_index(state) -> None:
    """Release a state's resident index, if any."""
    idx = getattr(state, "stats_index", None)
    if idx is not None:
        idx.release()
        state.stats_index = None

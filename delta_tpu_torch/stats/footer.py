"""Per-file stats and the schema from Parquet footers, with no data read.

Counterpart of `delta_tpu/stats/footer.py` and, for CONVERT TO DELTA, of
the reference's `pq.read_schema` + `models/schema.py::from_arrow_schema`.
CONVERT needs an AddFile stats document per existing file, so that the
converted table skips data at once; row-group footer statistics give
min, max and null count per file without reading its pages. The footer
is this package's own (`log/parquet_footer.py::read_footer`, of the
file's tail alone).

`footer_stats` gives the reference's document byte for byte (Arrow's
reading of the footer statistics, then the reference's rules):

- a column takes part only when every row group carries statistics with a
  null count for it (else it is left out, null count included); a row
  group of nulls only gives no min or max; one without min and max drops
  the column's min and max;
- integers, dates, timestamps (UTC ones with the zone, timestamp_ntz
  without) and decimals (from their unscaled bytes, written as
  `float(value)`) keep their min and max; float and double columns get a
  null count only (NaN's order is the writer's);
- strings and binary values are decoded as UTF-8 (a value that is not
  drops the column's min and max), truncated to 32 characters with the
  max bumped upward; a group whose max is flagged inexact is bumped
  before the groups are folded;
- the newer `min_value` / `max_value` fields are read, the deprecated
  `min` / `max` ones only for signed physical types (Arrow's rule), and
  INT96 columns have no usable statistics (their sort order is unknown).
"""

from __future__ import annotations

import datetime
import decimal
import json
import os
import struct
from typing import Dict, List, Optional

from delta_tpu_torch.errors import InvalidArgumentError
from delta_tpu_torch.log.parquet_data import _delta_type, _kind, _leaf_type, _tree
from delta_tpu_torch.log.parquet_footer import (
    REQUIRED,
    DecodeCorrupt,
    DecodeUnsupported,
    Footer,
    read_footer,
)
from delta_tpu_torch.models.schema import StructField, StructType
from delta_tpu_torch.stats.collection import (
    _json_value,
    _set_nested,
    _truncate_max,
    _truncate_min,
    bump_string,
    stats_columns,
)

_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
# Statistics fields: deprecated max, min; null_count; max_value,
# min_value; is_max_value_exact
_MAX, _MIN, _NULLS, _MAX_VALUE, _MIN_VALUE, _MAX_EXACT = 1, 2, 3, 5, 6, 7
_SIGNED_PHYSICAL = ("INT32", "INT64", "FLOAT", "DOUBLE")


def read_file_footer(path: str) -> Footer:
    """The footer of the Parquet file at `path`, from its tail alone."""
    with open(path, "rb") as f:
        size = f.seek(0, os.SEEK_END)
        if size < 12:
            raise DecodeCorrupt(f"{path}: {size} bytes, no Parquet file")
        f.seek(size - 8)
        (flen,) = struct.unpack("<I", f.read(4))
        if flen <= 0 or flen > size - 12:
            raise DecodeCorrupt(f"{path}: bad footer length {flen}")
        f.seek(size - 8 - flen)
        tail = f.read(flen + 8)
        f.seek(0)
        head = f.read(4)
    # the footer's offsets point into the whole file; nothing here
    # follows them
    return read_footer(head + tail)


def footer_schema(footer: Footer) -> StructType:
    """The table schema of a file's footer: each top-level column's Delta
    type and nullability, as Arrow's reading of the same footer maps it
    (`from_arrow_schema`)."""
    groups: Dict[str, List[int]] = {}
    for i, leaf in enumerate(footer.leaves):
        groups.setdefault(leaf.parts[0], []).append(i)
    fields = []
    try:
        for name, idx in groups.items():
            leaf = footer.leaves[idx[0]]
            nullable = leaf.repetition[0] != REQUIRED
            if len(idx) == 1 and len(leaf.parts) == 1:
                t = _leaf_type(_kind(leaf), leaf)
            else:
                kinds = {i: _kind(footer.leaves[i]) for i in idx}
                t = _delta_type(_tree(footer, idx), kinds, footer)
            fields.append(StructField(name, t, nullable))
    except DecodeUnsupported as e:
        raise InvalidArgumentError(
            f"cannot convert the Parquet type: {e}",
            error_class="DELTA_UNSUPPORTED_DATA_TYPES") from None
    return StructType(fields)


def _decode(raw, leaf, kind: str):
    """One statistics value as Arrow gives it in Python."""
    phys = leaf.physical_type
    if phys == "BOOLEAN":
        return bool(raw[0])
    if phys == "FLOAT":
        return struct.unpack("<f", raw[:4])[0]
    if phys == "DOUBLE":
        return struct.unpack("<d", raw[:8])[0]
    if phys in ("INT32", "INT64"):
        x = int.from_bytes(raw[:4 if phys == "INT32" else 8], "little",
                           signed=True)
    elif kind == "decimal":  # big-endian two's complement
        x = int.from_bytes(raw, "big", signed=True)
    else:
        return bytes(raw)
    if kind == "decimal":
        return decimal.Decimal(x).scaleb(-(leaf.scale or 0))
    if kind == "date":
        return _EPOCH_DATE + datetime.timedelta(days=x)
    if kind.startswith("timestamp"):
        zone, unit = kind.split("-")
        us = {"ms": x * 1000, "us": x, "ns": x // 1000}[unit]
        base = _EPOCH_TS if zone == "timestamp" else _EPOCH_TS.replace(
            tzinfo=None)
        return base + datetime.timedelta(microseconds=us)
    return x


def _min_max(st: dict, leaf) -> tuple:
    lo, hi = st.get(_MIN_VALUE), st.get(_MAX_VALUE)
    if (lo is None or hi is None) and leaf.physical_type in _SIGNED_PHYSICAL:
        lo, hi = st.get(_MIN), st.get(_MAX)
    if type(lo) is not bytes or type(hi) is not bytes:
        return None, None
    return lo, hi


def footer_stats(footer: Footer, schema, configuration: Dict[str, str],
                 partition_columns: List[str]) -> Optional[str]:
    """The stats JSON of one existing Parquet file, from its footer."""
    stats: dict = {"numRecords": footer.num_rows}
    min_d: dict = {}
    max_d: dict = {}
    null_d: dict = {}
    col_index: Dict[str, int] = {}
    if footer.row_groups:
        for j, c in enumerate(footer.row_groups[0].columns):
            col_index[c.path] = j
    for path in stats_columns(schema, configuration, partition_columns):
        j = col_index.get(".".join(path))
        if j is None:
            continue
        leaf = footer.leaves[footer.index[footer.row_groups[0]
                                          .columns[j].path]]
        try:
            kind = None if leaf.physical_type == "INT96" else _kind(leaf)
        except DecodeUnsupported:
            kind = None
        nulls = 0
        mins: Optional[list] = []
        maxs: Optional[list] = []
        max_dropped = False
        usable = bool(footer.row_groups) and kind is not None
        for g in footer.row_groups if usable else ():
            col = g.columns[j]
            st = col.statistics
            if st is None or type(st.get(_NULLS)) is not int:
                usable = False
                break
            nulls += st[_NULLS]
            if col.num_values - st[_NULLS] == 0:
                continue  # an all-null group gives no min or max
            lo, hi = _min_max(st, leaf)
            if lo is None:
                mins = maxs = None
                continue
            if mins is None:
                continue
            gmin, gmax = _decode(lo, leaf, kind), _decode(hi, leaf, kind)
            if isinstance(gmin, bytes):
                # UTF-8 byte order is code-point order: decoding before
                # the fold keeps min and max
                try:
                    gmin, gmax = gmin.decode("utf-8"), gmax.decode("utf-8")
                except UnicodeDecodeError:
                    mins = maxs = None
                    continue
            mins.append(gmin)
            if st.get(_MAX_EXACT) is False:
                # a truncated max is a lower bound of the group's max:
                # bumped past every string of its prefix before the fold
                bumped = bump_string(gmax) if isinstance(gmax, str) else None
                if bumped is None:
                    max_dropped = True
                else:
                    maxs.append(bumped)
            else:
                maxs.append(gmax)
        if not usable:
            continue
        _set_nested(null_d, path, int(nulls))
        if not mins:
            continue
        mn = min(mins)
        mx = max(maxs) if maxs and not max_dropped else None
        if isinstance(mn, float) or isinstance(mx, float):
            continue  # NaN's order is the writer's: never trusted
        if isinstance(mn, str):
            mn = _truncate_min(mn)
            mx = _truncate_max(mx) if mx is not None else None
        _set_nested(min_d, path, _json_value(mn))
        if mx is not None:
            _set_nested(max_d, path, _json_value(mx))
    if min_d:
        stats["minValues"] = min_d
        stats["maxValues"] = max_d
    stats["nullCount"] = null_d
    return json.dumps(stats, separators=(",", ":"))

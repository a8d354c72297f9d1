"""Data-file reader: a flat Parquet data file -> named numpy columns.

The port's counterpart of `pq.read_table` in the JAX package's
`HostEngine.read_parquet_files` (`delta_tpu/engine/host.py`), for what a
Delta writer, Spark or parquet-mr puts in a data file of a flat table:
every row group; for each leaf, dictionary pages followed by
RLE_DICTIONARY data pages, PLAIN pages, or both (parquet-cpp falls back
to PLAIN mid-chunk once its dictionary passes 1 MiB), or the
DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY,
BYTE_STREAM_SPLIT and RLE-boolean encodings; data page v1 and v2;
snappy, ZSTD, GZIP or uncompressed. Leaves are read by the host leaf
reader of the checkpoint path (`log/parquet_host.py::read_leaf`).

Types (physical type and logical annotation -> numpy): INT64 -> int64,
INT32 -> int32, DOUBLE, FLOAT, BOOLEAN, BYTE_ARRAY annotated UTF8 ->
object array of str, INT32 annotated DATE -> datetime64[D], INT64
annotated TIMESTAMP (millis, micros or nanos) and INT96 (Spark's
timestamps) -> datetime64[us], floored. Anything else (nested or repeated
columns, unannotated BYTE_ARRAY, narrow integers, decimals, LZ4 and
Brotli pages) raises `DecodeUnsupported`. Null rows hold the dtype's
zero.
"""

from __future__ import annotations

import numpy as np

from delta_tpu_torch.log.parquet_footer import (
    DecodeCorrupt,
    DecodeUnsupported,
    Leaf,
    read_footer,
)
from delta_tpu_torch.log.parquet_host import read_leaf
from delta_tpu_torch.models.batch import Batch, Column, zeros

_CONVERTED_UTF8 = 0
_CONVERTED_DATE = 6
_CONVERTED_TS_MILLIS = 9
_CONVERTED_TS_MICROS = 10
_LOGICAL_STRING = 1
_LOGICAL_DATE = 6
_LOGICAL_TIMESTAMP = 8
_LOGICAL_INTEGER = 10
# TimeUnit union ids of a TIMESTAMP logical type -> numpy unit
_UNITS = {1: "ms", 2: "us", 3: "ns"}


def _kind(leaf: Leaf) -> str:
    """The numpy kind a leaf reads as: one of long, integer, double,
    float, boolean, string, date, timestamp-<unit>."""
    phys, conv = leaf.physical_type, leaf.converted_type
    logical = leaf.logical_type or {}
    if phys == "BOOLEAN":
        return "boolean"
    if phys == "FLOAT":
        return "float"
    if phys == "DOUBLE":
        return "double"
    if phys == "BYTE_ARRAY":
        if conv == _CONVERTED_UTF8 or _LOGICAL_STRING in logical:
            return "string"
        raise DecodeUnsupported(f"{leaf.path}: BYTE_ARRAY without UTF8")
    if phys == "INT32":
        if conv == _CONVERTED_DATE or _LOGICAL_DATE in logical:
            return "date"
        if conv is not None or logical:
            ints = logical.get(_LOGICAL_INTEGER) or {}
            if ints.get(1) == 32 and ints.get(2, True):
                return "integer"
            raise DecodeUnsupported(f"{leaf.path}: annotated INT32 "
                                    f"({conv}, {logical})")
        return "integer"
    if phys == "INT64":
        if _LOGICAL_TIMESTAMP in logical:
            unit = (logical[_LOGICAL_TIMESTAMP].get(2) or {})
            for uid, name in _UNITS.items():
                if uid in unit:
                    return f"timestamp-{name}"
            raise DecodeUnsupported(f"{leaf.path}: timestamp unit {unit}")
        if conv == _CONVERTED_TS_MILLIS:
            return "timestamp-ms"
        if conv == _CONVERTED_TS_MICROS:
            return "timestamp-us"
        if conv is not None or logical:
            ints = logical.get(_LOGICAL_INTEGER) or {}
            if ints.get(1) == 64 and ints.get(2, True):
                return "long"
            raise DecodeUnsupported(f"{leaf.path}: annotated INT64 "
                                    f"({conv}, {logical})")
        return "long"
    if phys == "INT96":  # the host reader gives microseconds
        return "timestamp-us"
    raise DecodeUnsupported(f"{leaf.path}: physical type {phys}")


_DTYPES = {"long": np.int64, "integer": np.int32, "double": np.float64,
           "float": np.float32, "boolean": bool, "string": object,
           "date": "datetime64[D]"}


def _as_numpy(kind: str, values) -> np.ndarray:
    if kind == "string":
        out = np.empty(len(values), object)
        buf = values.buf.tobytes()
        try:
            for i, (s, ln) in enumerate(zip(values.starts.tolist(),
                                            values.lens.tolist())):
                out[i] = buf[s:s + ln].decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeCorrupt(f"a UTF8 value is not UTF-8: {e}") from e
        return out
    if kind.startswith("timestamp-"):
        unit = kind.split("-", 1)[1]
        return np.asarray(values, np.int64).astype(
            f"datetime64[{unit}]").astype("datetime64[us]")
    if kind == "date":
        return np.asarray(values, np.int64).astype(np.int32).astype(
            "datetime64[D]")
    return np.asarray(values).astype(_DTYPES[kind], copy=False)


def read_data_file(data: bytes, columns=None) -> Batch:
    """The columns of a flat data file, in file order: every column, or
    those named in `columns` that the file has (the counterpart of
    `read_parquet_files(columns=)`; the other leaves are not decoded)."""
    footer = read_footer(data)
    wanted = None if columns is None else set(columns)
    cols = {}
    for i, leaf in enumerate(footer.leaves):
        if wanted is not None and leaf.parts[0] not in wanted:
            continue
        if len(leaf.parts) != 1 or leaf.max_repetition_level:
            raise DecodeUnsupported(f"{leaf.path}: not a flat column")
        kind = _kind(leaf)
        hl = read_leaf(footer, data, i)
        n = hl.defs.shape[0]
        if n != footer.num_rows:  # a flat leaf has one entry per row
            raise DecodeCorrupt(
                f"{leaf.path}: {n} level entries for {footer.num_rows} rows")
        present = _as_numpy(kind, hl.values)
        if leaf.max_definition_level == 0:
            cols[leaf.parts[0]] = Column(present)
            continue
        valid = hl.defs == leaf.max_definition_level
        if bool(valid.all()):
            cols[leaf.parts[0]] = Column(present)
            continue
        full = zeros(present.dtype, n)
        full[valid] = present
        cols[leaf.parts[0]] = Column(full, valid)
    return Batch(cols, footer.num_rows)


def read_data_file_path(path: str, columns=None) -> Batch:
    with open(path, "rb") as f:
        return read_data_file(f.read(), columns)

"""Other writers' Parquet forms: the port's readers against pyarrow, and
the row read's typed refusals (C11).

pyarrow writes each form the port now reads, and the reference reads it
(`HostEngine`, Arrow); the port's `read_data_file` and `read_table` must
give the same rows, exactly:

- INT96 timestamps (dictionary and PLAIN, sub-microsecond nanoseconds and
  dates before 1970: the port floors to microseconds, as Spark does;
  pyarrow gives the reference nanoseconds);
- GZIP and ZSTD pages (ZSTD at levels 1 to 22), data page v2 in every
  codec;
- DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY,
  BYTE_STREAM_SPLIT and RLE booleans, in v1 and v2 pages;

over long, integer, double, float, boolean, string, date and timestamp
columns, with and without nulls, across several row groups. Then the
ZSTD decoder on pyarrow's frames byte for byte, and a seeded fuzz of
truncated and bit-flipped ZSTD frames (with their XXH64 checksum), GZIP
members, v2 page headers and DELTA_* streams: each gives DecodeCorrupt
or the right bytes, and never another exception.

C11: a data file in a form the port still does not read (LZ4, Brotli)
raises `UnsupportedTableError` out of `read_table`, DELETE, UPDATE, MERGE
and OPTIMIZE, and leaves the table as it was; a truncated data file
raises `DataFileCorruptedError` naming the file.

The committed fixtures under `tests/torch_fixtures/parquet_forms/`
(read on the card by `chip_smoke.py`'s `parquet_forms` phase, which has
no pyarrow there) are held here: their `manifest.json` equals pyarrow's
read of the committed files and a regeneration, and the phase passes on
the CPU. `python tests/test_torch_parquet_forms.py --write-fixtures`
rewrites them.
"""

import glob
import hashlib
import io
import json
import os
import shutil
import sys
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "parquet_forms")


# --------------------------------------------------------- the writers --


def typed_table(rng, n, nulls=True, ts_unit="us"):
    """One column of each type the port reads; nulls on every column."""
    def mask():
        return (rng.random(n) < 0.15) if nulls else None

    words = [f"w{i}" + "-x" * (i % 11) + ("é€" if i % 7 == 0 else "")
             for i in range(97)]
    d = rng.normal(size=n)
    d[::13] = np.nan
    d[1::13] = -0.0
    ts = rng.integers(-2 * 10**18, 2 * 10**18, n) // (
        1000 if ts_unit == "us" else 1)
    return pa.table({
        "long": pa.array(np.cumsum(rng.integers(-50, 1000, n)), pa.int64(),
                         mask=mask()),
        "integer": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                            mask=mask()),
        "double": pa.array(d, mask=mask()),
        "float": pa.array(rng.normal(size=n).astype(np.float32),
                          mask=mask()),
        "boolean": pa.array(rng.random(n) < 0.4, mask=mask()),
        "string": pa.array([words[i] for i in rng.integers(0, 97, n)],
                           pa.string(), mask=mask()),
        "date": pa.array(rng.integers(-40000, 40000, n).astype(np.int32),
                         pa.int32(), mask=mask()).cast(pa.date32()),
        "timestamp": pa.array(ts, pa.timestamp(ts_unit, "UTC"),
                              mask=mask()),
    })


_DELTA = {"long": "DELTA_BINARY_PACKED", "integer": "DELTA_BINARY_PACKED",
          "date": "DELTA_BINARY_PACKED", "timestamp": "DELTA_BINARY_PACKED",
          "string": "DELTA_BYTE_ARRAY", "boolean": "RLE",
          "double": "BYTE_STREAM_SPLIT", "float": "BYTE_STREAM_SPLIT"}
_SPLIT = {"long": "BYTE_STREAM_SPLIT", "integer": "BYTE_STREAM_SPLIT",
          "double": "BYTE_STREAM_SPLIT", "float": "BYTE_STREAM_SPLIT",
          "string": "DELTA_LENGTH_BYTE_ARRAY", "boolean": "RLE"}

# form -> pq.write_table options (each form's encodings over every column
# type it applies to)
FORMS = {
    "gzip": {"compression": "gzip"},
    "zstd-1": {"compression": "zstd", "compression_level": 1},
    "zstd-3": {"compression": "zstd", "compression_level": 3},
    "zstd-9": {"compression": "zstd", "compression_level": 9},
    "zstd-19": {"compression": "zstd", "compression_level": 19},
    "zstd-22": {"compression": "zstd", "compression_level": 22},
    "v2-snappy": {"data_page_version": "2.0"},
    "v2-none": {"data_page_version": "2.0", "compression": "none"},
    "v2-gzip": {"data_page_version": "2.0", "compression": "gzip"},
    "v2-zstd": {"data_page_version": "2.0", "compression": "zstd"},
    "int96": {"use_deprecated_int96_timestamps": True},
    "int96-plain-v2": {"use_deprecated_int96_timestamps": True,
                       "use_dictionary": False, "data_page_version": "2.0"},
    "delta-v1": {"use_dictionary": False, "column_encoding": _DELTA},
    "delta-v2-zstd": {"use_dictionary": False, "column_encoding": _DELTA,
                      "data_page_version": "2.0", "compression": "zstd"},
    "split-v1-gzip": {"use_dictionary": False, "column_encoding": _SPLIT,
                      "compression": "gzip"},
    "split-v2": {"use_dictionary": False, "column_encoding": _SPLIT,
                 "data_page_version": "2.0"},
}


def file_bytes(tbl, **kw) -> bytes:
    sink = io.BytesIO()
    pq.write_table(tbl, sink, **{"row_group_size": max(
        1, tbl.num_rows // 3 + 1), **kw})
    return sink.getvalue()


# --------------------------------------------------- pyarrow's digests --


def _canonical(arr: pa.Array, kind: str) -> bytes:
    """The valid values of a column in the form `chip_smoke.py`'s
    `forms_digests` hashes: int64 for long, integer, date (days) and
    timestamp (microseconds, floored), the raw float64 / float32 / bool
    bytes, and [u32 length][UTF-8] per string."""
    valid = arr.drop_null()
    if kind == "string":
        return b"".join(len(b).to_bytes(4, "little") + b
                        for b in (v.encode() for v in valid.to_pylist()))
    if kind == "timestamp":
        v = valid.cast(pa.int64()).to_numpy()
        unit = arr.type.unit
        v = v // 1000 if unit == "ns" else v * {"s": 10**6, "ms": 1000,
                                                "us": 1}[unit]
        return v.astype(np.int64).tobytes()
    if kind == "date":
        return valid.cast(pa.int32()).to_numpy().astype(np.int64).tobytes()
    if kind in ("long", "integer"):
        return valid.to_numpy().astype(np.int64).tobytes()
    if kind == "boolean":
        return valid.to_numpy(zero_copy_only=False).astype(np.uint8).tobytes()
    return valid.to_numpy().tobytes()


def arrow_digests(tbl: pa.Table) -> dict:
    """{column: [sha256 of the validity bytes, sha256 of the values]} of
    pyarrow's read."""
    out = {}
    for name in tbl.column_names:
        arr = tbl.column(name).combine_chunks()
        validity = arr.is_valid().to_numpy(zero_copy_only=False)
        out[name] = [hashlib.sha256(validity.astype(np.uint8).tobytes())
                     .hexdigest(),
                     hashlib.sha256(_canonical(arr, name)).hexdigest()]
    return out


# -------------------------------------------------------- the fixtures --

# data files: form -> (pq options, rows, timestamp unit)
FIXTURE_FILES = {
    "gzip": ({"compression": "gzip"}, 1500, "us"),
    "zstd-1": ({"compression": "zstd", "compression_level": 1}, 1500, "us"),
    "zstd-19": ({"compression": "zstd", "compression_level": 19}, 1500,
                "us"),
    "v2-snappy": ({"data_page_version": "2.0"}, 1500, "us"),
    "v2-zstd": ({"data_page_version": "2.0", "compression": "zstd"}, 1500,
                "us"),
    "int96": ({"use_deprecated_int96_timestamps": True}, 1500, "ns"),
    "int96-plain": ({"use_deprecated_int96_timestamps": True,
                     "use_dictionary": False}, 1500, "ns"),
    "delta-v1": ({"use_dictionary": False, "column_encoding": _DELTA}, 1500,
                 "us"),
    "split-v2-gzip": ({"use_dictionary": False, "column_encoding": _SPLIT,
                       "data_page_version": "2.0", "compression": "gzip"},
                      1500, "us"),
}
# logs: name -> how pyarrow rewrites the checkpoint part
FIXTURE_LOGS = {
    "log-zstd": {"compression": "zstd"},
    "log-gzip": {"compression": "gzip"},
    "log-v2": {"data_page_version": "2.0"},
}


def _multiblock_zstd(rng) -> bytes:
    """One string column in one page of ~300 KiB, ZSTD level 3: a frame of
    several 128 KiB blocks."""
    words = [bytes(rng.integers(97, 123, rng.integers(3, 12), np.uint8))
             .decode() for _ in range(400)]
    vals = [" ".join(words[j] for j in rng.integers(0, 400, 8))
            for _ in range(6000)]
    return file_bytes(pa.table({"string": pa.array(vals)}),
                      compression="zstd", compression_level=3,
                      use_dictionary=False, data_page_size=1 << 22,
                      row_group_size=6000)


def write_fixtures(root: str) -> dict:
    """Write every fixture under `root` and return the manifest (also
    written there as manifest.json)."""
    from delta_tpu.engine.host import HostEngine
    from delta_tpu.table import Table as RefTable
    from delta_tpu_torch.utils.synth import synth_delta_log

    os.makedirs(root, exist_ok=True)
    manifest = {"files": {}, "logs": {}}
    for i, (name, (kw, n, unit)) in enumerate(FIXTURE_FILES.items()):
        data = file_bytes(typed_table(np.random.default_rng(100 + i), n,
                                      ts_unit=unit), **kw)
        with open(os.path.join(root, f"{name}.parquet"), "wb") as f:
            f.write(data)
    with open(os.path.join(root, "zstd-multiblock.parquet"), "wb") as f:
        f.write(_multiblock_zstd(np.random.default_rng(99)))
    for path in sorted(glob.glob(os.path.join(root, "*.parquet"))):
        manifest["files"][os.path.basename(path)] = arrow_digests(
            pq.read_table(path))
    for i, (name, kw) in enumerate(FIXTURE_LOGS.items()):
        path = os.path.join(root, name)
        shutil.rmtree(path, ignore_errors=True)
        synth_delta_log(path, 24, 10, seed=200 + i)
        RefTable.for_path(path, engine=HostEngine()).checkpoint(version=20)
        (part,) = glob.glob(os.path.join(path, "_delta_log", "*.parquet"))
        pq.write_table(pq.read_table(part), part, **kw)
        state = RefTable.for_path(path, engine=HostEngine()) \
            .latest_snapshot().state
        live = sorted(state.add_files_table.column("path").to_pylist())
        on_device = "data_page_version" not in kw
        manifest["logs"][name] = {
            "version": state.version, "live_files": len(live),
            "live_sha256": hashlib.sha256("\n".join(live).encode())
            .hexdigest(),
            "device_parts": int(on_device),
            "device_fallbacks": int(not on_device)}
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


# ------------------------------------------------------- the comparison --


def assert_reads_as_pyarrow(data: bytes):
    """The port's `read_data_file` against pyarrow's read of the same
    bytes, value for value (NaN and -0.0 bit for bit)."""
    from delta_tpu_torch.log.parquet_data import read_data_file

    ref = pq.read_table(io.BytesIO(data))
    got = read_data_file(data)
    assert got.num_rows == ref.num_rows
    assert got.column_names == ref.column_names
    import chip_smoke

    assert chip_smoke.forms_digests(got) == arrow_digests(ref)


# ------------------------------------------------------------- readers --


@pytest.mark.parametrize("nulls", [True, False], ids=["nulls", "no-nulls"])
@pytest.mark.parametrize("form", list(FORMS))
def test_each_form_reads_as_pyarrow(form, nulls):
    kw = dict(FORMS[form])
    unit = "ns" if form.startswith("int96") else "us"
    tbl = typed_table(np.random.default_rng(len(form) * 7 + nulls), 2500,
                      nulls=nulls, ts_unit=unit)
    data = file_bytes(tbl, **kw)
    md = pq.ParquetFile(io.BytesIO(data)).metadata
    assert md.num_row_groups == 3
    encodings = {e for rg in range(md.num_row_groups)
                 for c in range(md.num_columns)
                 for e in md.row_group(rg).column(c).encodings}
    for enc in set((kw.get("column_encoding") or {}).values()):
        assert enc in encodings, (form, enc, encodings)
    if form.startswith("int96"):
        assert md.schema.column(7).physical_type == "INT96"
    assert_reads_as_pyarrow(data)


def test_int96_edges_floor_like_spark():
    """Sub-microsecond nanoseconds and instants before 1970: the port's
    microseconds are pyarrow's nanoseconds floored (Spark's
    `fromJulianDay`), not truncated toward zero."""
    from delta_tpu_torch.log.parquet_data import read_data_file

    ns = np.array([0, 1, 999, 1000, -1, -999, -1000, -1001,
                   -86_400_000_000_000 + 1, -(10**18) - 123,
                   10**18 + 456], np.int64)
    for dictionary in (True, False):
        data = file_bytes(pa.table({"t": pa.array(ns, pa.timestamp("ns"))}),
                          use_deprecated_int96_timestamps=True,
                          use_dictionary=dictionary)
        ref = pq.read_table(io.BytesIO(data)).column("t").cast(pa.int64())
        assert ref.to_pylist() == ns.tolist()
        got = read_data_file(data).column("t").values
        assert got.dtype == np.dtype("datetime64[us]")
        assert got.astype(np.int64).tolist() == (ns // 1000).tolist()
        assert got.astype(np.int64)[5] == -1  # -999 ns: floored, not 0


def test_narrow_and_wide_delta_widths():
    """DELTA_BINARY_PACKED at every width to 64 bits: deltas of the full
    int64 range, constant runs (width 0) and one value per page."""
    from delta_tpu_torch.log.parquet_data import read_data_file

    rng = np.random.default_rng(3)
    for vals in (rng.integers(-2**63, 2**63 - 1, 5000, dtype=np.int64),
                 np.full(1000, 7, np.int64), np.array([42], np.int64),
                 np.array([], np.int64),
                 np.array([2**63 - 1, -2**63, 0, 2**63 - 1], np.int64)):
        for typ in (pa.int64(), pa.int32()):
            v = vals if typ == pa.int64() else vals.astype(np.int32)
            data = file_bytes(pa.table({"x": pa.array(v, typ)}),
                              use_dictionary=False,
                              column_encoding={"x": "DELTA_BINARY_PACKED"})
            got = read_data_file(data).column("x").values
            assert got.tolist() == v.tolist()


def test_invalid_utf8_is_damage():
    """A UTF8 column whose bytes are no UTF-8 is damage, on the row read
    and on the host leaf reader of the load."""
    from delta_tpu_torch.log import parquet_host
    from delta_tpu_torch.log.parquet_data import read_data_file
    from delta_tpu_torch.log.parquet_footer import DecodeCorrupt, read_footer

    data = file_bytes(pa.table({"s": pa.array(["aé", "b"])}),
                      compression="none", use_dictionary=False)
    bad = data.replace("é".encode(), b"\xff\xfe")
    assert bad != data
    with pytest.raises(DecodeCorrupt, match="UTF-8"):
        read_data_file(bad)
    ft = read_footer(bad)
    leaf = parquet_host.read_leaves(ft, bad, ["s"])["s"]
    with pytest.raises(DecodeCorrupt, match="UTF-8"):
        leaf.row_values(np.arange(2))


# ----------------------------------------------------------- the codecs --


def _zstd_inputs():
    rng = np.random.default_rng(8)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 10), np.uint8))
             for _ in range(300)]
    text = b" ".join(words[i] for i in rng.integers(0, 300, 40000))
    return {"empty": b"", "one": b"x",
            "random": rng.integers(0, 256, 40000, np.uint8).tobytes(),
            "repetitive": b"abcdefgh" * 30000 + bytes(5000),
            "text": text[:50000],
            "multi-block": text + rng.integers(0, 256, 60000,
                                               np.uint8).tobytes()}


@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
def test_zstd_decodes_pyarrow_frames(level):
    from delta_tpu_torch.log import zstd

    codec = pa.Codec("zstd", compression_level=level)
    for name, raw in _zstd_inputs().items():
        frame = codec.compress(raw, asbytes=True)
        assert zstd.decompress(frame, len(raw)) == raw, name
    # concatenated frames and a skippable frame between them
    a, b = b"first frame " * 100, b"second" * 333
    skip = (0x184D2A5E).to_bytes(4, "little") + (3).to_bytes(4, "little")
    joined = codec.compress(a, asbytes=True) + skip + b"abc" + \
        codec.compress(b, asbytes=True)
    assert zstd.decompress(joined, len(a) + len(b)) == a + b


def test_zstd_refusals():
    from delta_tpu_torch.log import zstd
    from delta_tpu_torch.log.parquet_footer import (
        DecodeCorrupt,
        DecodeUnsupported,
    )

    frame = pa.Codec("zstd").compress(b"hello world" * 50, asbytes=True)
    with pytest.raises(DecodeCorrupt):  # another length than the page's
        zstd.decompress(frame, 549)
    with pytest.raises(DecodeCorrupt):
        zstd.decompress(b"\x00" * 12, 5)
    # a frame naming dictionary 7: the header's dictionary-ID flag
    fhd = frame[4]
    single = (fhd >> 5) & 1
    at = 5 + (0 if single else 1)
    with_dict = frame[:4] + bytes([fhd | 1]) + frame[5:at] + b"\x07" + \
        frame[at:]
    with pytest.raises(DecodeUnsupported, match="dictionary"):
        zstd.decompress(with_dict, 550)


def test_gzip_members_and_damage():
    from delta_tpu_torch.log.page_decode import decompress
    from delta_tpu_torch.log.parquet_footer import DecodeCorrupt

    raw = b"gzip page " * 400
    one = pa.Codec("gzip").compress(raw, asbytes=True)
    assert decompress(one, len(raw), "GZIP") == raw
    two = one + zlib.compress(raw[:100])  # a gzip then a zlib member
    assert decompress(two, len(raw) + 100, "GZIP") == raw + raw[:100]
    for bad, n in ((one[:-3], len(raw)), (one, len(raw) - 1),
                   (one, len(raw) + 1), (one + b"x", len(raw))):
        with pytest.raises(DecodeCorrupt):
            decompress(bad, n, "GZIP")


# ------------------------------------------------------------- the fuzz --

_P1, _P2, _P3, _P4, _P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                           0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                           0x27D4EB2F165667C5)
_M = (1 << 64) - 1


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc, v):
    return (_rotl((acc + v * _P2) & _M, 31) * _P1) & _M


def xxh64(data: bytes) -> int:
    """XXH64 with seed 0, in plain Python: the test's own checksum."""
    n, p = len(data), 0
    q = lambda k: int.from_bytes(data[k:k + 8], "little")  # noqa: E731
    if n >= 32:
        v = [(_P1 + _P2) & _M, _P2, 0, (-_P1) & _M]
        while p + 32 <= n:
            v = [_round(v[j], q(p + 8 * j)) for j in range(4)]
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M
        for x in v:
            h = (((h ^ _round(0, x)) * _P1) + _P4) & _M
    else:
        h = _P5
    h = (h + n) & _M
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, q(p)), 27) * _P1 + _P4) & _M
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _P1 & _M),
                   23) * _P2 + _P3) & _M
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M), 11) * _P1) & _M
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    return h ^ (h >> 32)


def with_checksum(frame: bytes, raw: bytes) -> bytes:
    """A one-frame pyarrow ZSTD output with its content-checksum flag set
    and the low 32 bits of XXH64 appended."""
    return frame[:4] + bytes([frame[4] | 4]) + frame[5:] + \
        (xxh64(raw) & 0xFFFFFFFF).to_bytes(4, "little")


def test_xxh64_known_values_and_checksummed_frames():
    from delta_tpu_torch.log import zstd
    from delta_tpu_torch.log.parquet_footer import DecodeCorrupt

    assert xxh64(b"") == 0xEF46DB3751D8E999
    for name, raw in _zstd_inputs().items():
        frame = with_checksum(pa.Codec("zstd").compress(raw, asbytes=True),
                              raw)
        assert zstd.decompress(frame, len(raw)) == raw, name
        bad = frame[:-1] + bytes([frame[-1] ^ 0x10])
        with pytest.raises(DecodeCorrupt):
            zstd.decompress(bad, len(raw))


def _seeds():
    inputs = _zstd_inputs()
    out = []
    for level, name in ((1, "text"), (19, "text"), (3, "repetitive"),
                        (3, "random"), (22, "multi-block"), (1, "one")):
        raw = inputs[name][:70000]
        out.append((with_checksum(pa.Codec("zstd", compression_level=level)
                                  .compress(raw, asbytes=True), raw), raw))
    return out


_ZSTD_SEEDS = _seeds()
_FUZZ = settings(max_examples=300, deadline=None, derandomize=True,
                 suppress_health_check=list(HealthCheck))


def _mutate(data: bytes, cut: int, flips) -> bytes:
    b = bytearray(data[:max(0, len(data) - cut)] if cut else data)
    for pos, bit in flips:
        if b:
            b[pos % len(b)] ^= 1 << bit
    return bytes(b)


_mutations = st.tuples(
    st.sampled_from([0, 0, 1, 2, 5, 17, 100, 1000]),
    st.lists(st.tuples(st.integers(0, 1 << 20), st.integers(0, 7)),
             max_size=3))


@_FUZZ
@given(seed=st.integers(0, len(_ZSTD_SEEDS) - 1), mutation=_mutations)
def test_fuzzed_zstd_frames_give_corrupt_or_the_bytes(seed, mutation):
    from delta_tpu_torch.log import zstd
    from delta_tpu_torch.log.parquet_footer import (
        DecodeCorrupt,
        DecodeUnsupported,
    )

    frame, raw = _ZSTD_SEEDS[seed]
    bad = _mutate(frame, *mutation)
    try:
        assert zstd.decompress(bad, len(raw)) == raw
    except DecodeCorrupt:
        pass
    except DecodeUnsupported:  # a flip that set the dictionary-ID flag
        assert bad[4] & 3 and not frame[4] & 3


@_FUZZ
@given(mutation=_mutations)
def test_fuzzed_gzip_members_give_corrupt_or_the_bytes(mutation):
    from delta_tpu_torch.log.page_decode import gunzip
    from delta_tpu_torch.log.parquet_footer import DecodeCorrupt

    raw = _zstd_inputs()["text"][:20000]
    member = pa.Codec("gzip").compress(raw, asbytes=True)
    try:
        assert gunzip(_mutate(member, *mutation), len(raw)) == raw
    except DecodeCorrupt:
        pass


def _form_file(form: str) -> bytes:
    tbl = typed_table(np.random.default_rng(5), 400, ts_unit="us")
    return file_bytes(tbl, **FORMS[form])


_FUZZ_FILES = {f: _form_file(f) for f in ("v2-none", "v2-zstd", "delta-v1",
                                          "split-v2", "int96-plain-v2")}


@_FUZZ
@given(form=st.sampled_from(sorted(_FUZZ_FILES)), mutation=_mutations,
       where=st.floats(0, 1))
def test_fuzzed_pages_give_decode_errors_or_rows(form, mutation, where):
    """Damage in a v2 page header or a DELTA_* / BYTE_STREAM_SPLIT page
    (the bytes before the footer): the read raises DecodeCorrupt or
    DecodeUnsupported, or gives rows (an uncompressed page carries no
    checksum); never another exception."""
    from delta_tpu_torch.log.parquet_data import read_data_file
    from delta_tpu_torch.log.parquet_footer import (
        DecodeCorrupt,
        DecodeUnsupported,
    )

    data = _FUZZ_FILES[form]
    flen = int.from_bytes(data[-8:-4], "little")
    body_end = len(data) - 8 - flen
    cut, flips = mutation
    at = 4 + int(where * (body_end - 5))
    b = bytearray(data)
    for pos, bit in flips:  # flips inside the pages, near `at`
        b[4 + (at - 4 + pos % 64) % (body_end - 4)] ^= 1 << bit
    if cut:  # drop bytes inside the pages, the footer kept
        b = b[:at] + b[at + min(cut, body_end - at):]
    try:
        assert read_data_file(bytes(b)).num_rows == 400
    except (DecodeCorrupt, DecodeUnsupported):
        pass


@_FUZZ
@given(cut=st.integers(1, 400), flips=_mutations)
def test_fuzzed_delta_streams_give_corrupt_or_the_values(cut, flips):
    """A DELTA_BINARY_PACKED / DELTA_LENGTH_BYTE_ARRAY / DELTA_BYTE_ARRAY
    stream cut short raises DecodeCorrupt or gives the same values (when
    only unread bytes went); bit flips give DecodeCorrupt or values."""
    from delta_tpu_torch.log.parquet_footer import DecodeCorrupt

    for stream, count, fn in _DELTA_STREAMS:
        whole = fn(stream, count)
        short = stream[:max(0, len(stream) - cut)]
        try:
            assert fn(short, count) == whole
        except DecodeCorrupt:
            pass
        try:
            fn(_mutate(stream, 0, flips[1]), count)
        except DecodeCorrupt:
            pass


_PARTS = {}


def _fixture_part(log: str, kw: dict) -> bytes:
    """The checkpoint part of a fixture log, rewritten by pyarrow."""
    if (log, str(kw)) not in _PARTS:
        (path,) = glob.glob(os.path.join(FIXTURES, log, "_delta_log",
                                         "*.parquet"))
        _PARTS[(log, str(kw))] = file_bytes(pq.read_table(path), **kw)
    return _PARTS[(log, str(kw))]


@_FUZZ
@given(form=st.sampled_from(["zstd", "gzip", "v2", "v2-zstd"]),
       seed=st.integers(0, 2**31))
def test_fuzzed_checkpoint_parts_give_decode_errors_or_rows(form, seed):
    """Seeded byte damage anywhere in a ZSTD, GZIP or v2 checkpoint part:
    the part read and the row assembly raise DecodeCorrupt or
    DecodeUnsupported, or give rows; never another exception."""
    import torch

    from delta_tpu_torch.log.page_decode import read_checkpoint_part
    from delta_tpu_torch.log.parquet_footer import (
        DecodeCorrupt,
        DecodeUnsupported,
    )
    from delta_tpu_torch.log.parquet_host import assemble

    kw = {"zstd": {"compression": "zstd"}, "gzip": {"compression": "gzip"},
          "v2": {"data_page_version": "2.0"},
          "v2-zstd": {"data_page_version": "2.0", "compression": "zstd"}}
    data = bytearray(_fixture_part("log-zstd", kw[form]))
    rng = np.random.default_rng(seed)
    for k in rng.integers(4, len(data) - 8, 3):
        data[k] = int(rng.integers(0, 256))
    try:
        part = read_checkpoint_part(bytes(data), torch.device("cpu"),
                                    lambda leaf: True)
        for root in ("add", "remove", "metaData", "protocol"):
            assemble(part.leaves, root, np.arange(part.n_rows))
    except (DecodeCorrupt, DecodeUnsupported):
        pass


def _delta_stream(values, typ, encoding):
    """The one data page of a required column: a bare value stream."""
    from delta_tpu_torch.log import page_decode
    from delta_tpu_torch.log.parquet_footer import read_footer

    data = file_bytes(pa.table({"x": pa.array(values, typ)}).cast(
        pa.schema([pa.field("x", typ, nullable=False)])),
        use_dictionary=False, compression="none",
        column_encoding={"x": encoding}, row_group_size=len(values))
    ft = read_footer(data)
    chunk, _ = ft.chunk(data, 0, 0)
    (page,) = [p for p in page_decode.split_pages(chunk, len(values))
               if p.type == 0]
    return page_decode.decompress_page(chunk, page, "UNCOMPRESSED")


def _delta_streams():
    from delta_tpu_torch.log import parquet_host as ph

    rng = np.random.default_rng(4)
    ints = rng.integers(-10**12, 10**12, 300)
    words = [f"prefix/{i // 7:04d}/{'z' * (i % 5)}" for i in range(300)]
    def dbp(s, n):
        return ph.delta_binary_packed(s, 0, n, 64)[0].tolist()

    def dlba(s, n):
        got = ph._delta_lengths(s, np.frombuffer(s, np.uint8), 0, n)[0]
        return [got.raw(i) for i in range(n)]

    def dba(s, n):
        got = ph._delta_byte_array(s, np.frombuffer(s, np.uint8), 0, n)
        return [got.raw(i) for i in range(n)]

    return [
        (_delta_stream(ints, pa.int64(), "DELTA_BINARY_PACKED"), 300, dbp),
        (_delta_stream(words, pa.string(), "DELTA_LENGTH_BYTE_ARRAY"), 300,
         dlba),
        (_delta_stream(words, pa.string(), "DELTA_BYTE_ARRAY"), 300, dba)]


_DELTA_STREAMS = _delta_streams()


def test_delta_streams_decode_to_the_values():
    rng = np.random.default_rng(4)
    ints = rng.integers(-10**12, 10**12, 300)
    words = [f"prefix/{i // 7:04d}/{'z' * (i % 5)}".encode()
             for i in range(300)]
    (s1, n1, f1), (s2, n2, f2), (s3, n3, f3) = _DELTA_STREAMS
    assert f1(s1, n1) == ints.tolist()
    assert f2(s2, n2) == words == f3(s3, n3)
    assert len(s3) < len(s2)  # the prefixes really were shared


# -------------------------------------------------- read_table and C11 --


def _ref_table(path, n=600, rng_seed=0):
    import delta_tpu.api as dta
    from delta_tpu.engine.host import HostEngine

    tbl = typed_table(np.random.default_rng(rng_seed), n)
    for k in range(2):
        dta.write_table(path, tbl.slice(k * n // 2, n // 2),
                        engine=HostEngine())
    return sorted(glob.glob(os.path.join(path, "*.parquet")))


def _rewrite(files, **kw):
    for f in files:
        pq.write_table(pq.read_table(f), f, **kw)


def _rows_ref(path):
    import delta_tpu.api as dta
    from delta_tpu.engine.host import HostEngine

    t = dta.read_table(path, engine=HostEngine())
    out = []
    for name in sorted(t.column_names):
        arr = t.column(name).combine_chunks()
        if pa.types.is_timestamp(arr.type):
            arr = arr.cast(pa.int64())
        elif pa.types.is_date(arr.type):
            arr = arr.cast(pa.int32())
        out.append(["<null>" if v is None else repr(v)
                    for v in arr.to_pylist()])
    return sorted(zip(*out))


def _rows_port(path):
    from delta_tpu_torch import TorchEngine
    from delta_tpu_torch.api import read_table

    b = read_table(path, engine=TorchEngine("cpu"))
    out = []
    for name in sorted(b.column_names):
        col = b.column(name)
        vals = col.values
        if vals.dtype.kind == "M":
            vals = vals.astype(np.int64)
        vals = vals.tolist()
        valid = (np.ones(len(vals), bool) if col.valid is None
                 else col.valid)
        out.append([repr(v) if ok else "<null>"
                    for v, ok in zip(vals, valid)])
    return sorted(zip(*out))


@pytest.mark.parametrize("form", list(FORMS))
def test_read_table_reads_other_writers_files(tmp_path, form):
    """A reference-written table whose data files pyarrow rewrote in
    another form: the port's `read_table` gives the reference's rows."""
    path = str(tmp_path / "t")
    _rewrite(_ref_table(path), **FORMS[form])
    assert _rows_port(path) == _rows_ref(path)


def _commands():
    import delta_tpu_torch.expressions.tree as E
    from delta_tpu_torch.api import read_table
    from delta_tpu_torch.commands.dml import delete, update
    from delta_tpu_torch.commands.merge import merge

    def src():  # keys whose bounds prune no target file
        return {"long": np.array([-10**15, 10**15], np.int64),
                "double": np.array([0.5, 1.5])}

    return {
        "read_table": lambda t: read_table(t.path, engine=t.engine),
        "delete": lambda t: delete(t, E.col("long") > E.lit(-10**9)),
        "update": lambda t: update(t, {"double": E.lit(0.0)},
                                   E.col("long") > E.lit(-10**9)),
        "merge": lambda t: merge(t, src(), on=E.col("target.long") == E.col(
            "source.long")).when_matched_update(
                set={"double": E.col("source.double")})
        .when_not_matched_insert_all().execute(),
        "optimize": lambda t: t.optimize().execute_compaction(),
    }


def _table_files(path):
    """The log's files and the bytes of every data file it references. A
    file a command wrote before it reached the refused one stays
    uncommitted: it belongs to no version."""
    from delta_tpu_torch import Table, TorchEngine

    state = Table.for_path(path, engine=TorchEngine("cpu")) \
        .latest_snapshot().state
    data = {}
    for a in state.add_files:
        with open(os.path.join(path, a.path), "rb") as f:
            data[a.path] = hashlib.sha256(f.read()).hexdigest()
    return sorted(os.listdir(os.path.join(path, "_delta_log"))), data


@pytest.mark.parametrize("codec", ["lz4", "brotli"])
@pytest.mark.parametrize("command", ["read_table", "delete", "update",
                                     "merge", "optimize"])
def test_unread_forms_raise_a_typed_error(tmp_path, command, codec):
    """C11: every command over a file in a codec the port does not read
    raises `UnsupportedTableError`, naming the file, and commits nothing:
    the log and the table's files stay as they were."""
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.errors import UnsupportedTableError

    path = str(tmp_path / "t")
    files = _ref_table(path, n=200)
    _rewrite(files[:1], compression=codec)
    before = _table_files(path)
    table = Table.for_path(path, engine=TorchEngine("cpu"))
    with pytest.raises(UnsupportedTableError) as e:
        _commands()[command](table)
    assert codec.upper() in str(e.value)
    assert os.path.basename(files[0]) in str(e.value)
    assert _table_files(path) == before


@pytest.mark.parametrize("command", ["read_table", "delete", "update",
                                     "merge", "optimize"])
def test_truncated_data_file_raises_damage_naming_it(tmp_path, command):
    """C11: a data file cut inside a page is damage
    (`DataFileCorruptedError`), never a bare DecodeCorrupt, and nothing is
    committed."""
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.errors import DataFileCorruptedError, DeltaError

    path = str(tmp_path / "t")
    files = _ref_table(path, n=200)
    data = open(files[1], "rb").read()
    flen = int.from_bytes(data[-8:-4], "little")
    footer = data[-8 - flen:]
    body = data[:-8 - flen]
    # the pages lose bytes in their middle; the footer still points past
    with open(files[1], "wb") as f:
        f.write(body[:len(body) // 2] + footer)
    before = _table_files(path)
    table = Table.for_path(path, engine=TorchEngine("cpu"))
    with pytest.raises(DataFileCorruptedError) as e:
        _commands()[command](table)
    assert isinstance(e.value, DeltaError)
    assert os.path.basename(files[1]) in str(e.value)
    assert e.value.context["path"].endswith(os.path.basename(files[1]))
    assert _table_files(path) == before


# ------------------------------------------------------------- fixtures --


def test_committed_manifest_is_pyarrows_read_and_regenerates(tmp_path):
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        committed = json.load(f)
    for name, want in committed["files"].items():
        assert arrow_digests(pq.read_table(os.path.join(FIXTURES, name))) \
            == want, name
    regenerated = write_fixtures(str(tmp_path / "forms"))
    assert regenerated == committed
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FIXTURES) for f in fs)
    assert total <= 2 << 20


def test_chip_phase_passes_on_the_cpu():
    """`chip_smoke.py`'s parquet_forms phase, with the plain versions: every
    fixture's digests, every log's live files and route."""
    import chip_smoke

    out = chip_smoke.parquet_forms_phase(FIXTURES, "cpu", "cpu")
    assert out["files"] == len(json.load(open(os.path.join(
        FIXTURES, "manifest.json")))["files"])
    assert out["zstd_mb_s"] > 0 and out["snappy_mb_s"] > 0


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixtures"]:
        sys.exit("usage: python tests/test_torch_parquet_forms.py "
                 "--write-fixtures")
    print(json.dumps(write_fixtures(FIXTURES), indent=1)[:2000])

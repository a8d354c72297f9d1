"""The wider schema types in the port's row read: byte, short, binary,
timestamp_ntz, decimal(p,s) up to 38 digits, and struct, array and map
columns nested to any depth.

pyarrow writes each form, and the reference's `read_table(...)
.to_pylist()` (or `pq.read_table` for a lone data file) is the oracle;
the port's rows, as `Column.to_python()` gives them, must equal it
exactly, decimals in `as_tuple()` too (rows are compared by `repr`, which
spells a Decimal's digits and a datetime's zone):

- each new primitive type with and without nulls, across row groups, in
  v1 and v2 pages, PLAIN, dictionary, DELTA_* and BYTE_STREAM_SPLIT;
- decimals on INT32, INT64, FIXED_LEN_BYTE_ARRAY and BYTE_ARRAY at
  precisions 1, 9, 18, 19 and 38, scale 0 and more, negative and zero;
- nested shapes with every null and empty case, and a hypothesis test
  over random shapes of depth up to 3;
- projections that leave a wide column out, type-widened files,
  partition columns of the new types, filters on each new top-level type
  (the same rows, and at least the files the reference keeps; a decimal
  bound rounded by the JSON stats never skips a matching file), a
  deletion vector on a wide table, `stats_parsed` of the new types in a
  reference-written checkpoint (and the port's own of the same log),
  timestamp_ntz at protocol (1, 2) and at (3, 7) with its feature;
- each write path over a decimal and a struct column against the
  reference's (`tests/test_torch_wide_write.py` holds the writes in
  full), a read batch written back with its types, and `type_name_of`.

The committed fixtures under `tests/torch_fixtures/wide_types/` (read on
the card by `chip_smoke.py`'s `wide_types` phase, whose machine has no
pyarrow) are held here: `manifest.json` equals pyarrow's reading of the
committed tables and a regeneration, and the phase passes on the CPU at a
link count of 2. `python tests/test_torch_wide_types.py --write-fixtures`
rewrites them.
"""

import datetime
import decimal
import hashlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "wide_types")
D = decimal.Decimal
EXACT = decimal.Context(prec=80)  # scaleb at 38 digits, unrounded

# ------------------------------------------------------------ helpers --


def port_rows(batch) -> list:
    """A port Batch's rows as dicts of Python values."""
    names = batch.column_names
    cols = [batch.column(c).to_python() for c in names]
    return [dict(zip(names, r)) for r in zip(*cols)] if names else []


def same_rows(got: list, want: list, ordered: bool = False) -> bool:
    """Equal rows, Decimals to their digits, datetimes to their zone (by
    `repr`); as multisets unless `ordered`."""
    g, w = [repr(r) for r in got], [repr(r) for r in want]
    return g == w if ordered else sorted(g) == sorted(w)


def file_bytes(tbl: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(tbl, buf, **kw)
    return buf.getvalue()


def write_delta(path: str, files, schema=None, protocol=(1, 2),
                reader_features=None, writer_features=None,
                configuration=None, partition_columns=()):
    """A Delta table of hand-written data files: `files` holds (name,
    arrow table, pq.write_table options, partitionValues) each, the
    commit's stats are the reference's `collect_stats` of each file's
    rows, its schema the reference's of `schema` (an arrow schema; the
    first file's by default) as Delta JSON."""
    from delta_tpu.models.schema import from_arrow_schema, schema_to_json
    from delta_tpu.stats.collection import collect_stats

    os.makedirs(os.path.join(path, "_delta_log"), exist_ok=True)
    ref_schema = from_arrow_schema(schema or files[0][1].schema)
    conf = dict(configuration or {})
    proto = {"minReaderVersion": protocol[0],
             "minWriterVersion": protocol[1]}
    if reader_features is not None:
        proto["readerFeatures"] = reader_features
    if writer_features is not None:
        proto["writerFeatures"] = writer_features
    lines = [{"protocol": proto}, {"metaData": {
        "id": "00000000-0000-0000-0000-000000000017",
        "format": {"provider": "parquet", "options": {}},
        "schemaString": schema_to_json(ref_schema),
        "partitionColumns": list(partition_columns),
        "configuration": conf, "createdTime": 0}}]
    for name, tbl, kw, pv in files:
        full = os.path.join(path, name)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        data = kw if isinstance(kw, bytes) else file_bytes(tbl, **kw)
        with open(full, "wb") as f:
            f.write(data)
        lines.append({"add": {
            "path": name, "partitionValues": dict(pv or {}),
            "size": len(data), "modificationTime": 0, "dataChange": True,
            "stats": collect_stats(tbl, ref_schema, conf,
                                   list(partition_columns))}})
    with open(os.path.join(path, "_delta_log", f"{0:020d}.json"), "w") as f:
        f.write("".join(json.dumps(x) + "\n" for x in lines))


def _decimals(cents, valid, scale=2) -> pa.Array:
    return pa.array([D(int(c)).scaleb(-scale) if ok else None
                     for c, ok in zip(cents.tolist(), valid.tolist())],
                    pa.decimal128(7, scale))


# ----------------------------------------------------------- fixtures --

SS_KEYS = ["ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk",
           "ss_customer_sk", "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk",
           "ss_store_sk", "ss_promo_sk"]
SS_MONEY = ["ss_wholesale_cost", "ss_list_price", "ss_sales_price",
            "ss_ext_discount_amt", "ss_ext_sales_price",
            "ss_ext_wholesale_cost", "ss_ext_list_price", "ss_ext_tax",
            "ss_coupon_amt", "ss_net_paid", "ss_net_paid_inc_tax",
            "ss_net_profit"]
SS_COLUMNS = SS_KEYS + ["ss_ticket_number", "ss_quantity"] + SS_MONEY
# dsdgen's sold dates (1998-01-02 .. 2003-01-02, date_dim surrogate keys)
DATE_LO, DATE_HI = 2450816, 2452642
SS_FILES = 4
SS_ROWS = 6000
SS_NULL_RATE = 0.04   # dsdgen leaves each non-key column null at ~4%
DV_FILE = 1           # the file the reference's DELETE gives a DV
# the domains of SF1 (TPC-DS v3 table 3-2): time of day in the store's
# hours, items, customers, demographics, addresses, stores, promotions
SS_DOMAINS = {"ss_sold_time_sk": (28800, 75600), "ss_item_sk": (1, 18001),
              "ss_customer_sk": (1, 100001), "ss_cdemo_sk": (1, 1920801),
              "ss_hdemo_sk": (1, 7201), "ss_addr_sk": (1, 50001),
              "ss_store_sk": (1, 13), "ss_promo_sk": (1, 301)}


def quarter(i: int):
    """[lo, hi) of the sold dates file i covers."""
    step = -(-(DATE_HI + 1 - DATE_LO) // SS_FILES)
    return DATE_LO + i * step, min(DATE_LO + (i + 1) * step, DATE_HI + 1)


def store_sales(i: int, rows: int = SS_ROWS) -> pa.Table:
    """One file of store_sales rows (TPC-DS v3 §2.3): tickets of 8 to 16
    line items sharing a date, time, customer, store and ticket number;
    the prices as dsdgen derives them (list = wholesale plus a markup of
    up to 200%, sales = list less a discount of up to 100%, the ext_*
    columns times the quantity, a coupon on a fifth of the lines, tax of
    0-9%), in cents; every column but the item and ticket null at
    SS_NULL_RATE."""
    rng = np.random.default_rng(1700 + i)
    sizes = []
    while sum(sizes) < rows:
        sizes.append(int(rng.integers(8, 17)))
    n_t = len(sizes)
    per_ticket = {"ss_sold_date_sk": rng.integers(*quarter(i), n_t),
                  "ss_ticket_number": np.arange(n_t) + i * 60_000 + 1}
    for c in ("ss_sold_time_sk", "ss_customer_sk", "ss_cdemo_sk",
              "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk"):
        per_ticket[c] = rng.integers(*SS_DOMAINS[c], n_t)
    cols = {c: np.repeat(v, sizes)[:rows] for c, v in per_ticket.items()}
    for c in ("ss_item_sk", "ss_promo_sk"):
        cols[c] = rng.integers(*SS_DOMAINS[c], rows)
    qty = rng.integers(1, 101, rows)
    cols["ss_quantity"] = qty
    whole = rng.integers(100, 10001, rows)
    lst = np.round(whole * (1 + rng.integers(0, 201, rows) / 100))
    sales = np.round(lst * (1 - rng.integers(0, 101, rows) / 100))
    ext_sales = sales * qty
    coupon = np.where(rng.random(rows) < 0.2,
                      np.round(ext_sales * rng.random(rows)), 0)
    tax = np.round(ext_sales * rng.integers(0, 10, rows) / 100)
    net_paid = ext_sales - coupon
    money = {"ss_wholesale_cost": whole, "ss_list_price": lst,
             "ss_sales_price": sales,
             "ss_ext_discount_amt": (lst - sales) * qty,
             "ss_ext_sales_price": ext_sales,
             "ss_ext_wholesale_cost": whole * qty,
             "ss_ext_list_price": lst * qty, "ss_ext_tax": tax,
             "ss_coupon_amt": coupon, "ss_net_paid": net_paid,
             "ss_net_paid_inc_tax": net_paid + tax,
             "ss_net_profit": net_paid - whole * qty}
    arrays = {}
    for c in SS_COLUMNS:
        valid = (np.ones(rows, bool) if c in ("ss_item_sk",
                                              "ss_ticket_number")
                 else rng.random(rows) >= SS_NULL_RATE)
        if c in money:
            arrays[c] = _decimals(money[c].astype(np.int64), valid)
        else:
            typ = pa.int64() if c == "ss_ticket_number" else pa.int32()
            arrays[c] = pa.array(cols[c], typ, mask=~valid)
    return pa.table(arrays)


def _nested_rows(rng, n: int, base: int) -> pa.Table:
    """Rows of every wide type, with nulls and empties at every level."""
    def pick(*choices, p=None):
        return choices[int(rng.choice(len(choices), p=p))]

    def dec(scale, digits):
        if rng.random() < 0.1:
            return None
        v = int(rng.integers(-10 ** min(digits, 18), 10 ** min(digits, 18)))
        if digits > 18:
            v = v * 10 ** (digits - 18) + int(rng.integers(0, 10 ** 6))
        return D(v).scaleb(-scale, EXACT)

    def ints(k):
        return [None if rng.random() < 0.2 else int(rng.integers(-99, 99))
                for _ in range(k)]

    st_rows, arr, mp, aos, mal = [], [], [], [], []
    for _ in range(n):
        st_rows.append(pick(None, {"a": None, "z": None, "inner": None},
                            {"a": int(rng.integers(0, 9)), "z": "x" * int(
                                rng.integers(0, 3)), "inner": {
                                "x": float(rng.integers(0, 5)) / 4}},
                            {"a": 1, "z": None, "inner": {"x": None}}))
        arr.append(pick(None, [], ints(int(rng.integers(1, 4)))))
        mp.append(pick(None, [], [(f"k{j}", v) for j, v in
                                  enumerate(ints(int(rng.integers(1, 3))))]))
        aos.append(pick(None, [], [pick(None, {"x": dec(2, 8), "y": pick(
            None, [], ints(int(rng.integers(1, 3))))}) for _ in range(
                int(rng.integers(1, 3)))]))
        mal.append(pick(None, [], [(f"m{j}", pick(None, [], ints(2)))
                                   for j in range(int(rng.integers(1, 3)))]))
    nul = rng.random(n) < 0.15
    ts = (np.datetime64("1950-01-01T00:00:00", "us") + rng.integers(
        0, 100 * 365 * 86400 * 10 ** 6, n).astype("timedelta64[us]"))
    return pa.table({
        "k": pa.array(np.arange(base, base + n), pa.int64()),
        "b": pa.array(rng.integers(-128, 128, n), pa.int8(), mask=nul),
        "s": pa.array(rng.integers(-32768, 32768, n), pa.int16(),
                      mask=np.roll(nul, 1)),
        "bin": pa.array([None if m else bytes(rng.integers(
            0, 256, int(rng.integers(0, 6)), np.uint8)) for m in
            np.roll(nul, 2)], pa.binary()),
        "ntz": pa.array(ts, pa.timestamp("us"), mask=np.roll(nul, 3)),
        "d38": pa.array([dec(10, 37) for _ in range(n)],
                        pa.decimal128(38, 10)),
        "st": pa.array(st_rows, pa.struct([
            ("a", pa.int32()), ("z", pa.string()),
            ("inner", pa.struct([("x", pa.float64())]))])),
        "arr": pa.array(arr, pa.list_(pa.int64())),
        "m": pa.array(mp, pa.map_(pa.string(), pa.int32())),
        "aos": pa.array(aos, pa.list_(pa.struct([
            ("x", pa.decimal128(10, 2)), ("y", pa.list_(pa.int32()))]))),
        "mal": pa.array(mal, pa.map_(pa.string(), pa.list_(pa.int64()))),
    })


NESTED_READS = {"all": None, "projected": ["k", "aos", "mal", "d38"]}


def ss_reads():
    """The phase's reads of store_sales: name -> (columns, filter spec).
    A filter spec is (column, op, value) conjuncts."""
    lo, hi = quarter(DV_FILE)
    return {
        "q3": (["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"], []),
        "range": (["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
                  [("ss_sold_date_sk", ">=", lo),
                   ("ss_sold_date_sk", "<", hi)]),
        "profit": (["ss_item_sk", "ss_net_profit"],
                   [("ss_net_profit", ">", D("0.00"))]),
        "all": (None, []),
    }


def ss_filter(spec, tree):
    """A filter spec as an expression of the `tree` module (either
    package's)."""
    out = None
    for c, op, v in spec:
        e = tree.Comparison(op, tree.col(c), tree.lit(v))
        out = e if out is None else tree.And(out, e)
    return out


def _u64(values) -> np.ndarray:
    return np.asarray(values, np.int64).view(np.uint64)


def arrow_sums(tbl: pa.Table) -> dict:
    """{column: [valid count, sum mod 2^64, sum of squares mod 2^64]} of
    the integer or unscaled decimal values: additive over copies, the
    form `chip_smoke.py::wide_sums` gives the port's read."""
    out = {}
    for name in tbl.column_names:
        vals = [v for v in tbl.column(name).to_pylist() if v is not None]
        if vals and isinstance(vals[0], D):
            vals = [int(v.scaleb(-v.as_tuple().exponent, EXACT))
                    for v in vals]
        u = _u64(vals)
        out[name] = [len(vals), int(u.sum(dtype=np.uint64)),
                     int((u * u).sum(dtype=np.uint64))]
    return out


def rows_digest(rows: list) -> str:
    """sha256 of the sorted reprs of the rows (tuples in column order):
    the form `chip_smoke.py::wide_rows_digest` gives the port's read."""
    return hashlib.sha256("\n".join(sorted(
        repr(tuple(r.values())) for r in rows)).encode()).hexdigest()


def write_fixtures(root: str) -> dict:
    """Write both fixture tables under `root` and return the manifest
    (also written there as manifest.json), the reference's reads."""
    import delta_tpu.api as dta
    import delta_tpu.expressions.tree as RE
    from delta_tpu.commands.dml import delete
    from delta_tpu.engine.host import HostEngine
    from delta_tpu.table import Table as RefTable

    shutil.rmtree(root, ignore_errors=True)
    ss = os.path.join(root, "store_sales")
    files = []
    for i in range(SS_FILES):
        kw = {"store_decimal_as_integer": True} if i < 2 else {}
        files.append((f"part-{i:05d}-store_sales.snappy.parquet",
                      store_sales(i), kw, None))
    write_delta(ss, files, protocol=(3, 7),
                reader_features=["deletionVectors"],
                writer_features=["deletionVectors"],
                configuration={"delta.enableDeletionVectors": "true"})
    lo, hi = quarter(DV_FILE)
    delete(RefTable.for_path(ss, HostEngine()), ss_filter(
        [("ss_sold_date_sk", ">=", lo), ("ss_sold_date_sk", "<", hi),
         ("ss_quantity", "<=", 10)], RE))
    nested = os.path.join(root, "nested")
    rng = np.random.default_rng(1717)
    write_delta(nested, [
        ("part-00000-nested.parquet", _nested_rows(rng, 300, 0),
         {"row_group_size": 150}, None),
        ("part-00001-nested.parquet", _nested_rows(rng, 300, 300),
         {"row_group_size": 150, "data_page_version": "2.0",
          "compression": "zstd"}, None)],
        protocol=(3, 7), reader_features=["timestampNtz"],
        writer_features=["timestampNtz"])
    eng = HostEngine()
    manifest = {"store_sales": {"files": SS_FILES, "dv_file": DV_FILE,
                                "reads": {}},
                "nested": {"reads": {}}}
    for name, (cols, spec) in ss_reads().items():
        tbl = dta.read_table(ss, filter=ss_filter(spec, RE), columns=cols,
                             engine=eng)
        survivors = RefTable.for_path(ss, eng).latest_snapshot().scan(
            filter=ss_filter(spec, RE)).file_paths() if spec else None
        manifest["store_sales"]["reads"][name] = {
            "rows": tbl.num_rows, "sums": arrow_sums(tbl),
            "files": SS_FILES if survivors is None else len(survivors)}
    for name, cols in NESTED_READS.items():
        tbl = dta.read_table(nested, columns=cols, engine=eng)
        manifest["nested"]["reads"][name] = {
            "rows": tbl.num_rows, "columns": tbl.column_names,
            "sha256": rows_digest(tbl.to_pylist())}
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


# --------------------------------------------------- data-file forms --

def _read_port(data: bytes, columns=None) -> list:
    from delta_tpu_torch.log.parquet_data import read_data_file

    return port_rows(read_data_file(data, columns))


def assert_reads_as_pyarrow(data: bytes, columns=None):
    """The port's rows equal pyarrow's in order (projected columns come
    in file order, pyarrow's in the order asked: rows compare by name)."""
    want = pq.read_table(io.BytesIO(data), columns=columns).to_pylist()
    got = _read_port(data, columns)
    if columns is not None:
        want = [dict(sorted(r.items())) for r in want]
        got = [dict(sorted(r.items())) for r in got]
    assert same_rows(got, want, ordered=True)


def _primitives(rng, n: int, nulls: bool) -> pa.Table:
    def mask(k):
        return (rng.random(n) < 0.2) if nulls else None

    ts = np.datetime64("1960-01-01T00:00:00", "us") + rng.integers(
        0, 80 * 365 * 86400 * 10 ** 6, n).astype("timedelta64[us]")
    wide = [int(x) * 10 ** 20 + int(y) for x, y in zip(
        rng.integers(-10 ** 17, 10 ** 17, n), rng.integers(0, 10 ** 12, n))]
    return pa.table({
        "b": pa.array(rng.integers(-128, 128, n), pa.int8(), mask=mask(0)),
        "s": pa.array(rng.integers(-32768, 32768, n), pa.int16(),
                      mask=mask(1)),
        "bin": pa.array([bytes(rng.integers(0, 256, int(k), np.uint8))
                         for k in rng.integers(0, 9, n)], pa.binary(),
                        mask=mask(2)),
        "ntz": pa.array(ts, pa.timestamp("us"), mask=mask(3)),
        "dec": pa.array([D(int(v)).scaleb(-2) for v in rng.integers(
            -10 ** 6, 10 ** 6, n)], pa.decimal128(7, 2), mask=mask(4)),
        "d38": pa.array([D(v).scaleb(-6, EXACT) for v in wide],
                        pa.decimal128(38, 6), mask=mask(5)),
    })


_ENCODINGS = {
    "dictionary": {},
    "plain": {"use_dictionary": False},
    "delta": {"use_dictionary": False, "column_encoding": {
        "b": "DELTA_BINARY_PACKED", "s": "DELTA_BINARY_PACKED",
        "ntz": "DELTA_BINARY_PACKED", "bin": "DELTA_BYTE_ARRAY",
        "dec": "DELTA_BYTE_ARRAY", "d38": "DELTA_BYTE_ARRAY"}},
    "split": {"use_dictionary": False, "column_encoding": {
        "b": "BYTE_STREAM_SPLIT", "s": "BYTE_STREAM_SPLIT",
        "ntz": "BYTE_STREAM_SPLIT", "bin": "PLAIN",
        "dec": "BYTE_STREAM_SPLIT", "d38": "BYTE_STREAM_SPLIT"}},
}


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("page", ["1.0", "2.0"])
@pytest.mark.parametrize("encoding", sorted(_ENCODINGS))
def test_primitive_forms(encoding, page, nulls):
    """byte, short, binary, timestamp_ntz, decimal(7,2) and decimal(38,6)
    (FIXED_LEN_BYTE_ARRAY) across three row groups."""
    tbl = _primitives(np.random.default_rng(len(encoding) + 7 * nulls),
                      900, nulls)
    data = file_bytes(tbl, data_page_version=page, row_group_size=300,
                      **_ENCODINGS[encoding])
    md = pq.ParquetFile(io.BytesIO(data)).metadata
    assert md.num_row_groups == 3
    if encoding in ("delta", "split"):
        used = set(md.row_group(0).column(5).encodings)
        assert {"delta": "DELTA_BYTE_ARRAY",
                "split": "BYTE_STREAM_SPLIT"}[encoding] in used
    assert_reads_as_pyarrow(data)


def _byte_array_decimals(values, precision: int, scale: int) -> bytes:
    """A file of one optional BYTE_ARRAY DECIMAL column (minimal
    big-endian two's complement per value; pyarrow writes no such
    form), by the port's own Parquet writer."""
    from delta_tpu_torch.log.parquet_host import Strings
    from delta_tpu_torch.utils.parquet_write import (
        LeafColumn,
        SchemaNode,
        write_parquet,
    )

    present = [v for v in values if v is not None]
    ints = [int(v.scaleb(scale, EXACT)) for v in present]
    blobs = [v.to_bytes((v.bit_length() + 8) // 8, "big", signed=True)
             for v in ints]
    schema = SchemaNode("schema", 0, (SchemaNode(
        "d", 1, physical="BYTE_ARRAY", converted=5,
        decimal=(precision, scale)),))
    defs = np.array([v is not None for v in values], np.int32)
    return write_parquet(schema, [LeafColumn(
        ("d",), "BYTE_ARRAY", defs, None, 1, 0,
        Strings.from_bytes(blobs))], len(values))


def _decimal_values(rng, precision: int, scale: int, n: int) -> list:
    top = 10 ** precision - 1
    edge = [top, -top, 0, 1, -1]
    rand = [int(x) % (2 * top + 1) - top for x in rng.integers(
        0, 1 << 62, n, dtype=np.int64)]
    if precision > 18:  # 18 random leading digits, then the rest
        tail = precision - 18
        rand = [v * 10 ** tail + int("".join(map(str, rng.integers(
            0, 10, tail)))) * (1 if v >= 0 else -1) for v in
            [int(x) % (2 * 10 ** 18 - 1) - (10 ** 18 - 1) for x in
             rng.integers(0, 1 << 62, n, dtype=np.int64)]]
    out = [D(v).scaleb(-scale, EXACT) for v in edge + rand]
    return [None if i % 7 == 3 else v for i, v in enumerate(out)]


# precisions 1, 9, 18, 19 and 38 on each physical type Arrow stores them
# on (INT32 up to 9 digits, INT64 from 10 to 18) and on the byte forms
_DECIMAL_FORMS = ([("INT32", p) for p in (1, 9)] + [("INT64", 18)] + [
    (phys, p) for phys in ("FIXED_LEN_BYTE_ARRAY", "BYTE_ARRAY")
    for p in (1, 9, 18, 19, 38)])


@pytest.mark.parametrize("scale_of", ["zero", "half"])
@pytest.mark.parametrize("physical,precision", _DECIMAL_FORMS)
def test_decimal_physical_types(physical, precision, scale_of):
    """A decimal on each physical type, with its extremes, zeros,
    negatives and nulls; scale 0 and p // 2."""
    scale = 0 if scale_of == "zero" else precision // 2
    vals = _decimal_values(np.random.default_rng(precision), precision,
                           scale, 300)
    if physical == "BYTE_ARRAY":
        data = _byte_array_decimals(vals, precision, scale)
    else:
        data = file_bytes(pa.table({"d": pa.array(
            vals, pa.decimal128(precision, scale))}),
            store_decimal_as_integer=physical != "FIXED_LEN_BYTE_ARRAY",
            row_group_size=100)
    col = pq.ParquetFile(io.BytesIO(data)).schema.column(0)
    assert col.physical_type == physical
    assert_reads_as_pyarrow(data)
    got = [r["d"] for r in _read_port(data)]
    assert [None if v is None else v.as_tuple() for v in got] == \
        [None if v is None else v.as_tuple() for v in vals]


def _every_nested_case() -> pa.Table:
    """Each null and empty case of each nesting: a null list, an empty
    one, a list of one null; a null struct and one of null fields; a
    null map, an empty one, a null value; and their nestings."""
    return pa.table({
        "k": pa.array(range(6), pa.int64()),
        "st": pa.array([{"a": 1, "z": "x"}, None, {"a": None, "z": None},
                        {"a": 2, "z": ""}, None, {"a": 3, "z": "é"}],
                       pa.struct([("a", pa.int32()), ("z", pa.string())])),
        "arr": pa.array([[1, None], [], None, [None], [5], []],
                        pa.list_(pa.int64())),
        "m": pa.array([[("a", 1)], None, [], [("b", None), ("c", 3)],
                       [("d", 4)], None], pa.map_(pa.string(), pa.int32())),
        "aos": pa.array([[{"x": D("1.50"), "y": [1, 2]}, None,
                          {"x": None, "y": None}, {"x": D("-0.01"),
                                                   "y": []}],
                         None, [], [{"x": D("0.00"), "y": [None]}], [None],
                         [{"x": None, "y": [3]}]],
                        pa.list_(pa.struct([("x", pa.decimal128(10, 2)),
                                            ("y", pa.list_(pa.int32()))]))),
        "mal": pa.array([[("k", [1, None])], [("e", None)], None,
                         [("z", [])], [], [("q", [7]), ("r", None)]],
                        pa.map_(pa.string(), pa.list_(pa.int64()))),
        "lol": pa.array([[[1], [], None], None, [], [[None]], [[2, 3]],
                         [None]], pa.list_(pa.list_(pa.int8()))),
        "sos": pa.array([{"in": {"b": b"\x00"}}, {"in": None}, None,
                         {"in": {"b": None}}, {"in": {"b": b""}}, None],
                        pa.struct([("in", pa.struct([("b", pa.binary())]))])),
    })


@pytest.mark.parametrize("kw", [{}, {"data_page_version": "2.0"},
                                {"row_group_size": 2},
                                {"use_dictionary": False,
                                 "data_page_version": "2.0",
                                 "row_group_size": 4}])
def test_nested_shapes_every_null_and_empty(kw):
    data = file_bytes(_every_nested_case(), **kw)
    assert_reads_as_pyarrow(data)
    # projection by top-level column: its own leaves only
    assert_reads_as_pyarrow(data, ["aos", "k"])


_LEAF_TYPES = [pa.int64(), pa.int32(), pa.string(), pa.binary(),
               pa.bool_(), pa.decimal128(10, 2), pa.decimal128(30, 3),
               pa.int8(), pa.timestamp("us"), pa.float64()]


def _types(depth: int):
    leaf = st.sampled_from(_LEAF_TYPES)
    if depth == 0:
        return leaf
    inner = _types(depth - 1)
    return st.one_of(
        leaf,
        inner.map(pa.list_),
        st.lists(inner, min_size=1, max_size=3).map(
            lambda ts: pa.struct([(f"f{i}", t) for i, t in enumerate(ts)])),
        inner.map(lambda t: pa.map_(pa.string(), t)))


def _values(t: pa.DataType):
    if pa.types.is_list(t):
        inner = st.lists(_values(t.value_type), max_size=3)
    elif pa.types.is_map(t):
        inner = st.lists(st.tuples(st.text(max_size=2),
                                   _values(t.item_type)), max_size=3)
    elif pa.types.is_struct(t):
        inner = st.fixed_dictionaries({t.field(i).name: _values(
            t.field(i).type) for i in range(t.num_fields)})
    elif pa.types.is_decimal(t):
        inner = st.integers(-10 ** t.precision + 1, 10 ** t.precision - 1
                            ).map(lambda v: D(v).scaleb(-t.scale, EXACT))
    elif pa.types.is_timestamp(t):
        inner = st.datetimes(datetime.datetime(1900, 1, 1),
                             datetime.datetime(2100, 1, 1))
    else:
        inner = {pa.int64(): st.integers(-2 ** 63, 2 ** 63 - 1),
                 pa.int32(): st.integers(-2 ** 31, 2 ** 31 - 1),
                 pa.int8(): st.integers(-128, 127),
                 pa.string(): st.text(max_size=4),
                 pa.binary(): st.binary(max_size=4),
                 pa.bool_(): st.booleans(),
                 pa.float64(): st.floats(allow_nan=False)}[t]
    return st.one_of(st.none(), inner)


@st.composite
def _nested_tables(draw):
    t = draw(_types(3))
    rows = draw(st.lists(_values(t), min_size=1, max_size=12))
    return pa.table({"k": pa.array(range(len(rows)), pa.int64()),
                     "c": pa.array(rows, t)})


@settings(max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(_nested_tables(), st.sampled_from(["1.0", "2.0"]),
       st.integers(1, 5), st.booleans())
def test_random_nested_shapes(tbl, page, rows_per_group, dictionary):
    data = file_bytes(tbl, data_page_version=page,
                      row_group_size=rows_per_group,
                      use_dictionary=dictionary)
    assert_reads_as_pyarrow(data)


def test_legacy_two_level_list_is_refused_naming_the_file(tmp_path):
    from test_torch_write import _legacy_list_file
    import delta_tpu_torch.api as pta
    from delta_tpu_torch import TorchEngine
    from delta_tpu_torch.errors import UnsupportedTableError

    path = str(tmp_path / "t")
    tbl = pa.table({"x": pa.array([[1, 2], None, []], pa.list_(pa.int64()))})
    write_delta(path, [("legacy.parquet", tbl, _legacy_list_file(), None)])
    with pytest.raises(UnsupportedTableError, match="legacy.parquet") as e:
        pta.read_table(path, engine=TorchEngine("cpu"))
    assert "legacy two-level list" in str(e.value)


# ------------------------------------------------------- table reads --

def _ref_read(path, **kw) -> list:
    import delta_tpu.api as dta
    from delta_tpu.engine.host import HostEngine

    return dta.read_table(path, engine=HostEngine(), **kw).to_pylist()


def _port_read(path, **kw) -> list:
    import delta_tpu_torch.api as pta
    from delta_tpu_torch import TorchEngine

    return port_rows(pta.read_table(path, engine=TorchEngine("cpu"), **kw))


def _probe_table() -> pa.Table:
    return pa.table({
        "k": pa.array([1, 2, 3, 4], pa.int64()),
        "d": pa.array([D("1.50"), None, D("-3.25"), D("0.00")],
                      pa.decimal128(7, 2)),
        "big": pa.array([D("12345678901234567890.5"), D("1.0"), None,
                         D("-7.5")], pa.decimal128(38, 1)),
        "b": pa.array([1, -2, None, 127], pa.int8()),
        "s": pa.array([300, None, -5, 0], pa.int16()),
        "bin": pa.array([b"a\x00", None, b"", b"a"], pa.binary()),
        "ntz": pa.array([datetime.datetime(2020, 1, 1, 1, 2, 3, 4), None,
                         datetime.datetime(1960, 1, 1),
                         datetime.datetime(1970, 1, 1)], pa.timestamp("us")),
        "st": pa.array([{"a": 1, "z": "x"}, None, {"a": None, "z": None},
                        {"a": 2, "z": "y"}],
                       pa.struct([("a", pa.int32()), ("z", pa.string())])),
        "arr": pa.array([[1, None], [], None, [4]], pa.list_(pa.int64())),
        "m": pa.array([[("a", 1)], None, [], [("b", 2)]],
                      pa.map_(pa.string(), pa.int32())),
        "aoa": pa.array([[{"x": [1]}], None, [], [{"x": None}]],
                        pa.list_(pa.struct([("x", pa.list_(pa.int32()))]))),
    })


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """The reference-written probe table: four files (one per row), so
    that data skipping has files to drop."""
    import delta_tpu.api as dta
    from delta_tpu.engine.host import HostEngine

    path = str(tmp_path_factory.mktemp("probe") / "t")
    tbl = _probe_table()
    for i in range(tbl.num_rows):
        dta.write_table(path, tbl.slice(i, 1), engine=HostEngine())
    return path


def test_probe_reads_every_column_and_projects(probe):
    assert same_rows(_port_read(probe), _ref_read(probe))
    assert same_rows(_port_read(probe, columns=["k"]),
                     _ref_read(probe, columns=["k"]))
    assert same_rows(_port_read(probe, columns=["k", "aoa", "d"]),
                     _ref_read(probe, columns=["k", "aoa", "d"]))


def test_snapshot_schema_is_the_full_tree(probe):
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.models.schema import ArrayType, StructType

    snap = Table.for_path(probe, engine=TorchEngine("cpu")).latest_snapshot()
    schema = snap.schema
    assert schema["d"].data_type == "decimal(7,2)"
    assert isinstance(schema["st"].data_type, StructType)
    aoa = schema["aoa"].data_type
    assert isinstance(aoa, ArrayType) and isinstance(
        aoa.element_type.fields[0].data_type, ArrayType)
    assert json.loads(snap.metadata.schemaString) == \
        schema.to_json_value()
    assert [p for p, _ in schema.leaves()][:9] == [
        ("k",), ("d",), ("big",), ("b",), ("s",), ("bin",), ("ntz",),
        ("st", "a"), ("st", "z")]


_FILTERS = [
    ("big", ">=", D("12345678901234567890.5")),   # its stat is rounded
    ("big", ">", D("12345678901234567890.4")),
    ("big", "=", D("12345678901234567890.5")),
    ("big", ">=", 12345678901234567890.5),
    ("big", "<", 2),
    ("d", ">", D("1.495")), ("d", "=", D("1.5")), ("d", ">", 1),
    ("d", "<", 1.0), ("d", "!=", D("1.50")), ("d", "<=", D("-3.25")),
    ("b", "<", 300), ("b", ">", -300), ("b", "=", 127),
    ("s", ">", 0), ("s", "<", 40000),
    ("bin", "=", b"a\x00"), ("bin", "=", "a"), ("bin", ">", b"a"),
    ("ntz", ">", datetime.datetime(2000, 1, 1)),
    ("ntz", "<=", datetime.datetime(1970, 1, 1)),
]


# the reference compares `big`'s rounded max stat with the literal cast to
# a double (the same double) and skips the file that holds the match
# (ROADMAP C12)
_REFERENCE_SKIPS_A_MATCH = [("big", ">", D("12345678901234567890.4"))]


def _ref_filtered(path, expr) -> list:
    """The reference's residual filter (Arrow compute) over all of its
    rows, no file skipped."""
    import delta_tpu.api as dta
    from delta_tpu.engine.host import HostEngine
    from delta_tpu.expressions.eval import evaluate_predicate_host

    tbl = dta.read_table(path, engine=HostEngine())
    return tbl.filter(pa.array(evaluate_predicate_host(expr, tbl)))\
        .to_pylist()


@pytest.mark.parametrize("case", _FILTERS, ids=repr)
def test_filters_on_each_new_type(probe, case):
    """The same rows as the reference; the files the reference keeps are
    kept (the port may keep more: decimal bounds widen)."""
    import delta_tpu.expressions.tree as RE
    from delta_tpu.engine.host import HostEngine
    from delta_tpu.replay.columnar import clear_parse_cache
    from delta_tpu.table import Table as RefTable
    import delta_tpu_torch.expressions.tree as PE
    from delta_tpu_torch import Table, TorchEngine

    spec = [case]
    got = _port_read(probe, filter=ss_filter(spec, PE))
    assert same_rows(got, _ref_filtered(probe, ss_filter(spec, RE)))
    if case not in _REFERENCE_SKIPS_A_MATCH:
        assert same_rows(got, _ref_read(probe, filter=ss_filter(spec, RE)))
    clear_parse_cache()
    ref = set(RefTable.for_path(probe, HostEngine()).latest_snapshot()
              .scan(filter=ss_filter(spec, RE)).file_paths())
    port = set(Table.for_path(probe, engine=TorchEngine("cpu"))
               .latest_snapshot().scan(filter=ss_filter(spec, PE))
               .file_paths())
    assert ref <= port


def test_a_rounded_decimal_bound_never_skips_a_match(probe):
    """`big`'s max is written as the double 1.2345678901234567e+19, below
    the row's 12345678901234567890.5: compared as written, the file
    would be skipped."""
    import delta_tpu_torch.expressions.tree as PE
    from delta_tpu_torch import Table, TorchEngine

    snap = Table.for_path(probe, engine=TorchEngine("cpu")).latest_snapshot()
    for op in (">=", "=", ">"):
        v = D("12345678901234567890.5") if op != ">" else \
            D("12345678901234567890.4")
        sc = snap.scan(filter=PE.Comparison(op, PE.col("big"), PE.lit(v)))
        assert [r["k"] for r in port_rows(sc.to_batch())] == [1]
        assert len(sc.file_paths()) >= 1


def test_widened_files_read_as_the_table_types(tmp_path):
    """Files written before a type change: byte -> short -> integer ->
    long, integer -> decimal, decimal(7,2) -> decimal(20,4), date ->
    timestamp_ntz, float -> double, under the newer table schema."""
    path = str(tmp_path / "t")
    old = pa.table({
        "a": pa.array([1, -2, None], pa.int8()),
        "b": pa.array([300, None, -7], pa.int16()),
        "c": pa.array([5, 6, None], pa.int32()),
        "dd": pa.array([D("1.25"), None, D("-99999.99")],
                       pa.decimal128(7, 2)),
        "dt": pa.array([datetime.date(2001, 2, 3), None,
                        datetime.date(1969, 12, 31)], pa.date32()),
        "f": pa.array([1.5, None, -2.25], pa.float32()),
        "i2d": pa.array([12, -1, None], pa.int32()),
    })
    new = pa.schema([("a", pa.int16()), ("b", pa.int32()),
                     ("c", pa.int64()), ("dd", pa.decimal128(20, 4)),
                     ("dt", pa.timestamp("us")), ("f", pa.float64()),
                     ("i2d", pa.decimal128(12, 2))])
    fresh = pa.table({n: pa.array([None], new.field(n).type)
                      for n in new.names}, schema=new)
    write_delta(path, [("old.parquet", old, {}, None),
                       ("new.parquet", fresh, {}, None)], schema=new)
    want = _ref_read(path)
    assert same_rows(_port_read(path), want)
    assert any(isinstance(r["dd"], D) and r["dd"].as_tuple().exponent == -4
               for r in want)


def test_partition_columns_of_the_new_types(tmp_path):
    path = str(tmp_path / "t")
    schema = pa.schema([("k", pa.int64()), ("pb", pa.int8()),
                        ("ps", pa.int16()), ("pd", pa.decimal128(9, 3)),
                        ("pbin", pa.binary()), ("pn", pa.timestamp("us"))])
    files = []
    parts = [("1", "300", "1.5", "ab", "2020-01-02 03:04:05.000006"),
             ("-2", "-1", "-0.001", "", "1960-01-01 00:00:00"),
             (None, None, None, None, None)]
    for i, pv in enumerate(parts):
        data = pa.table({"k": pa.array([i, i + 10], pa.int64())})
        files.append((f"f{i}.parquet", data, {},
                      dict(zip(["pb", "ps", "pd", "pbin", "pn"], pv))))
    write_delta(path, files, schema=schema,
                partition_columns=["pb", "ps", "pd", "pbin", "pn"])
    import delta_tpu.expressions.tree as RE
    import delta_tpu_torch.expressions.tree as PE

    assert same_rows(_port_read(path), _ref_read(path))
    for spec in ([("pd", ">", D("0"))], [("pb", "<", 0)],
                 [("pbin", "=", b"ab")], [("ps", "=", 300)],
                 [("pn", "<", datetime.datetime(2000, 1, 1))]):
        assert same_rows(_port_read(path, filter=ss_filter(spec, PE)),
                         _ref_read(path, filter=ss_filter(spec, RE))), spec


def test_deletion_vector_on_a_wide_table(tmp_path):
    import delta_tpu.api as dta
    import delta_tpu.expressions.tree as RE
    from delta_tpu.commands.dml import delete
    from delta_tpu.engine.host import HostEngine
    from delta_tpu.table import Table as RefTable

    path = str(tmp_path / "t")
    tbl = _nested_rows(np.random.default_rng(3), 200, 0)
    dta.write_table(path, tbl, engine=HostEngine(),
                    properties={"delta.enableDeletionVectors": "true"})
    delete(RefTable.for_path(path, HostEngine()),
           RE.Comparison("<", RE.col("b"), RE.lit(0)))
    assert any("deletionVector" in line and '"add"' in line for line in
               open(os.path.join(path, "_delta_log", f"{1:020d}.json")))
    assert same_rows(_port_read(path), _ref_read(path))
    assert same_rows(_port_read(path, columns=["k", "mal"]),
                     _ref_read(path, columns=["k", "mal"]))


def test_timestamp_ntz_at_both_protocols(tmp_path):
    """The reference writes timestamp_ntz at (1, 2) without the feature;
    Spark at (3, 7) with `timestampNtz`: both read."""
    import delta_tpu.api as dta
    from delta_tpu.engine.host import HostEngine

    tbl = pa.table({"t": pa.array([datetime.datetime(2021, 5, 6, 7), None],
                                  pa.timestamp("us"))})
    legacy = str(tmp_path / "legacy")
    dta.write_table(legacy, tbl, engine=HostEngine())
    assert '"minReaderVersion":1' in open(os.path.join(
        legacy, "_delta_log", f"{0:020d}.json")).read().replace(" ", "")
    spark = str(tmp_path / "spark")
    write_delta(spark, [("a.parquet", tbl, {}, None)], protocol=(3, 7),
                reader_features=["timestampNtz"],
                writer_features=["timestampNtz"])
    for path in (legacy, spark):
        got = _port_read(path)
        assert same_rows(got, _ref_read(path))
        assert got[0]["t"] == datetime.datetime(2021, 5, 6, 7)


def test_stats_parsed_of_the_new_types(tmp_path):
    """A struct-only checkpoint the reference wrote over byte, short,
    decimal (FIXED_LEN_BYTE_ARRAY in the checkpoint) and timestamp_ntz
    columns: the stats strings the port rebuilds are the reference's,
    and a decimal filter keeps the same files."""
    import delta_tpu.api as dta
    import delta_tpu.expressions.tree as RE
    from delta_tpu.engine.host import HostEngine
    from delta_tpu.replay.columnar import clear_parse_cache
    from delta_tpu.table import Table as RefTable
    import delta_tpu_torch.expressions.tree as PE
    from delta_tpu_torch import Table, TorchEngine

    path = str(tmp_path / "t")
    props = {"delta.checkpoint.writeStatsAsStruct": "true",
             "delta.checkpoint.writeStatsAsJson": "false"}
    for i in range(3):
        tbl = _primitives(np.random.default_rng(i), 20, True).drop_columns(
            ["bin"])
        dta.write_table(path, tbl, engine=HostEngine(), properties=props)
    RefTable.for_path(path, HostEngine()).checkpoint()
    cp = [f for f in os.listdir(os.path.join(path, "_delta_log"))
          if f.endswith(".checkpoint.parquet")]
    part = pq.read_table(os.path.join(path, "_delta_log", cp[0]))
    sp = part.schema.field("add").type.field("stats_parsed").type
    assert pa.types.is_decimal(sp.field("minValues").type.field("dec").type)
    clear_parse_cache()
    ref_state = RefTable.for_path(path, HostEngine()).latest_snapshot() \
        .state.add_files_table
    want = sorted(zip(ref_state.column("path").to_pylist(),
                      ref_state.column("stats").to_pylist()))
    snap = Table.for_path(path, engine=TorchEngine("cpu")).latest_snapshot()
    assert sorted((a.path, a.stats) for a in snap.state.add_files) == want
    spec = [("dec", ">", D("5000.00"))]
    clear_parse_cache()
    ref = set(RefTable.for_path(path, HostEngine()).latest_snapshot()
              .scan(filter=ss_filter(spec, RE)).file_paths())
    assert ref <= set(snap.scan(filter=ss_filter(spec, PE)).file_paths())
    # the port's own struct-only checkpoint of the log: the same typed
    # stats_parsed as the reference's, and the same stats on reload
    for f in cp:
        os.remove(os.path.join(path, "_delta_log", f))
    os.remove(os.path.join(path, "_delta_log", "_last_checkpoint"))
    Table.for_path(path, engine=TorchEngine("cpu")).checkpoint()
    mine = pq.read_table(os.path.join(path, "_delta_log", cp[0]))
    assert mine.schema.field("add").type.field("stats_parsed") == \
        part.schema.field("add").type.field("stats_parsed")
    assert repr([a["stats_parsed"] for a in mine.column("add").to_pylist()
                 if a]) == repr([a["stats_parsed"] for a in
                                 part.column("add").to_pylist() if a])
    snap = Table.for_path(path, engine=TorchEngine("cpu")).latest_snapshot()
    assert sorted((a.path, a.stats) for a in snap.state.add_files) == want


# -------------------------------------------------------- write paths --

def _table_files(path) -> list:
    return sorted((os.path.relpath(os.path.join(d, f), path),
                   open(os.path.join(d, f), "rb").read())
                  for d, _, fs in os.walk(path) for f in fs)


def _write_commands(port: bool):
    """Each write path, in the port's package or the reference's."""
    if port:
        import delta_tpu_torch.api as api
        from delta_tpu_torch import TorchEngine as Engine
        from delta_tpu_torch.commands.dml import delete, update
        from delta_tpu_torch.commands.merge import merge
        from delta_tpu_torch.expressions import col, lit

        engine = Engine("cpu")
        rows = {"k": np.array([9])}
        source = {"k": np.array([1, 7])}
    else:
        import delta_tpu.api as api
        from delta_tpu.commands.dml import delete, update
        from delta_tpu.commands.merge import merge
        from delta_tpu.engine.host import HostEngine
        from delta_tpu.expressions import col, lit

        engine = HostEngine()
        rows = pa.table({"k": pa.array([9], pa.int64())})
        source = pa.table({"k": pa.array([1, 7], pa.int64())})
    return {
        "append": lambda t: api.write_table(t.path, rows, engine=engine),
        "delete": lambda t: delete(t, col("k") == lit(1)),
        "update": lambda t: update(t, {"k": lit(5)}, col("k") == lit(1)),
        "merge": lambda t: merge(
            t, source, on=col("target.k") == col("source.k"))
        .when_matched_delete().when_not_matched_insert_all().execute(),
        "optimize": lambda t: t.optimize().execute_compaction(),
    }


@pytest.mark.parametrize("command", ["append", "delete", "update", "merge",
                                     "optimize"])
@pytest.mark.parametrize("kind", ["decimal", "struct"])
def test_write_paths_refuse_before_writing(tmp_path, kind, command):
    """No longer a refusal: each write path writes a table with a decimal
    or a struct column, on copies of one reference-written table, to the
    rows the reference's command gives (both packages read both copies)."""
    import delta_tpu.api as dta
    from delta_tpu.engine.host import HostEngine
    from delta_tpu.table import Table as RefTable
    from delta_tpu_torch import Table, TorchEngine

    src = str(tmp_path / "src")
    extra = (pa.array([D("1.5"), D("2.5")], pa.decimal128(7, 2))
             if kind == "decimal" else
             pa.array([{"a": 1}, {"a": 2}], pa.struct([("a", pa.int32())])))
    for i in range(2):  # two files: OPTIMIZE has a bin to compact
        dta.write_table(src, pa.table({"k": pa.array([1 + i], pa.int64()),
                                       "w": extra.slice(i, 1)}),
                        engine=HostEngine(),
                        properties={"delta.enableDeletionVectors": "true"})
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    before = _table_files(port)
    _write_commands(False)[command](RefTable.for_path(ref, HostEngine()))
    _write_commands(True)[command](Table.for_path(port,
                                                  engine=TorchEngine("cpu")))
    assert _table_files(port) != before
    want = _ref_read(ref)
    if command == "optimize":  # the same rows, in one file
        assert len(Table.for_path(port, engine=TorchEngine("cpu"))
                   .latest_snapshot().state.add_files) == 1
    else:
        assert want != _ref_read(src)
    for path in (ref, port):
        assert same_rows(_port_read(path), want)
    assert same_rows(_ref_read(port), want)


def test_a_checkpoint_of_a_wide_table(tmp_path):
    """JSON stats: the port's checkpoint is one the reference loads to the
    same files and rows. Struct stats of the decimal, byte, short,
    timestamp_ntz and nested columns: written, and the `stats_parsed`
    column equals the reference's checkpoint of a copy of the log."""
    import delta_tpu.api as dta
    from delta_tpu.engine.host import HostEngine
    from delta_tpu.replay.columnar import clear_parse_cache
    from delta_tpu.table import Table as RefTable
    from delta_tpu_torch import Table, TorchEngine

    tbl = _probe_table()
    path = str(tmp_path / "json")
    for i in range(2):
        dta.write_table(path, tbl.slice(2 * i, 2), engine=HostEngine())
    Table.for_path(path, engine=TorchEngine("cpu")).checkpoint()
    assert os.path.exists(os.path.join(
        path, "_delta_log", f"{1:020d}.checkpoint.parquet"))
    clear_parse_cache()
    ref = RefTable.for_path(path, HostEngine()).latest_snapshot()
    assert ref.version == 1 and len(ref.state.add_files_table) == 2
    assert same_rows(_ref_read(path), tbl.to_pylist())
    assert same_rows(_port_read(path), tbl.to_pylist())

    path = str(tmp_path / "struct")
    dta.write_table(path, tbl, engine=HostEngine(), properties={
        "delta.checkpoint.writeStatsAsStruct": "true"})
    copy = str(tmp_path / "struct_ref")
    shutil.copytree(path, copy)
    before = _table_files(path)
    Table.for_path(path, engine=TorchEngine("cpu")).checkpoint()
    RefTable.for_path(copy, HostEngine()).checkpoint()
    assert _table_files(path) != before
    parts = [pq.read_table(os.path.join(p, "_delta_log",
                                        f"{0:020d}.checkpoint.parquet"))
             for p in (path, copy)]
    got, want = ([a["stats_parsed"] for a in t.column("add").to_pylist() if a]
                 for t in parts)
    assert len(got) == 1 and repr(got) == repr(want)
    assert same_rows(_port_read(path), tbl.to_pylist())
    clear_parse_cache()
    assert same_rows(_ref_read(path), tbl.to_pylist())


def test_type_name_of_looks_at_the_values():
    from delta_tpu_torch.errors import UnsupportedTableError
    from delta_tpu_torch.models.schema import type_name_of

    strs = np.empty(2, object)
    strs[:] = ["a", ""]
    assert type_name_of(strs) == "string"
    assert type_name_of(np.array(["a", "b"])) == "string"
    assert type_name_of(np.zeros(0, object)) == "string"
    blobs = np.empty(2, object)
    blobs[:] = [b"a", b""]
    assert type_name_of(blobs) == "binary"
    assert type_name_of(np.zeros(2, np.int8)) == "byte"
    assert type_name_of(np.zeros(2, np.int16)) == "short"
    for odd in ([{"a": 1}, {"a": 2}], ["a", [1]], ["a", b"b"]):
        arr = np.empty(2, object)
        arr[:] = odd
        with pytest.raises(UnsupportedTableError):
            type_name_of(arr)
    with pytest.raises(UnsupportedTableError):
        type_name_of(np.zeros(2, np.uint32))


def test_a_read_batch_with_wide_columns_does_not_write_back(probe,
                                                            tmp_path):
    """`write_table(q, read_table(p))`: the decimal, binary, timestamp_ntz
    and nested columns keep their types, so they write back as those
    types (not as strings or longs): the new table's schema and rows are
    the probe's, as both packages read them."""
    import delta_tpu_torch.api as pta
    from delta_tpu_torch import Table, TorchEngine

    eng = TorchEngine("cpu")
    batch = pta.read_table(probe, engine=eng)
    want_types = Table.for_path(probe, engine=eng).latest_snapshot().schema
    for c in ("d", "big", "bin", "ntz", "st", "arr", "m"):
        q = str(tmp_path / c)
        pta.write_table(q, {"k": batch.column("k"), c: batch.column(c)},
                        engine=eng)
        got = Table.for_path(q, engine=eng).latest_snapshot().schema
        assert got[c].data_type == want_types[c].data_type, c
        want = [{"k": r["k"], c: r[c]} for r in _ref_read(probe)]
        assert same_rows(_port_read(q), want), c
        assert same_rows(_ref_read(q), want), c


def test_schema_parse_refuses_variant_and_unknown_types():
    from delta_tpu_torch.errors import UnsupportedTableError
    from delta_tpu_torch.models.schema import schema_from_json

    for t in ("variant", "interval", {"type": "udt"},
              {"type": "array", "elementType": "variant",
               "containsNull": True}):
        s = json.dumps({"type": "struct", "fields": [
            {"name": "x", "type": t, "nullable": True, "metadata": {}}]})
        with pytest.raises(UnsupportedTableError):
            schema_from_json(s)


# ------------------------------------------------------------ fixtures --

def test_committed_manifest_is_pyarrows_read_and_regenerates(tmp_path):
    import delta_tpu.api as dta
    import delta_tpu.expressions.tree as RE
    from delta_tpu.engine.host import HostEngine

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        committed = json.load(f)
    ss = os.path.join(FIXTURES, "store_sales")
    for name, (cols, spec) in ss_reads().items():
        tbl = dta.read_table(ss, filter=ss_filter(spec, RE), columns=cols,
                             engine=HostEngine())
        assert arrow_sums(tbl) == \
            committed["store_sales"]["reads"][name]["sums"], name
    for name, cols in NESTED_READS.items():
        tbl = dta.read_table(os.path.join(FIXTURES, "nested"),
                             columns=cols, engine=HostEngine())
        assert rows_digest(tbl.to_pylist()) == \
            committed["nested"]["reads"][name]["sha256"], name
    assert write_fixtures(str(tmp_path / "wide")) == committed
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FIXTURES) for f in fs)
    assert total <= 3 << 20


def test_chip_phase_passes_on_the_cpu():
    """`chip_smoke.py`'s wide_types phase with the plain versions, at two
    links of each store_sales file: every read's digests, the survivors
    of the range read."""
    import chip_smoke

    assert chip_smoke.WIDE_RANGE == quarter(DV_FILE)
    assert chip_smoke.WIDE_NESTED_READS == NESTED_READS
    for name, (cols, spec) in ss_reads().items():
        theirs = chip_smoke.WIDE_READS[name]
        assert theirs[0] == cols and [
            (c, op, D(v.split(":", 1)[1]) if isinstance(v, str) else v)
            for c, op, v in theirs[1]] == spec, name
    out = chip_smoke.wide_types_phase(FIXTURES, "cpu", "cpu", links=2)
    reads = out["reads"]
    assert set(reads) == set(ss_reads()) | {f"nested_{k}" for k in
                                           NESTED_READS}
    assert reads["range"]["files"] == 2
    assert all(r["rows_per_s"] > 0 for r in reads.values())


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixtures"]:
        sys.exit("usage: python tests/test_torch_wide_types.py "
                 "--write-fixtures")
    print(json.dumps(write_fixtures(FIXTURES), indent=1)[:2000])

"""Writing the wider schema types: byte, short, binary, timestamp_ntz,
decimal(p,s) up to 38 digits, and struct, array and map columns nested
to any depth, through every write path of the port.

Inputs are made from a seed with numpy; the oracles are pyarrow's reader
and the reference (`delta_tpu`, `HostEngine`). Rows are compared by
`repr` (a Decimal's digits and a datetime's zone count:
`test_torch_wide_types.py::same_rows`), stats strings and commits byte
for byte, metrics exactly; there is no float tolerance anywhere:

- each new type with and without nulls, in each physical form the writer
  picks (decimals at p = 1, 9, 10, 18, 19 and 38, negative values): the
  port writes, pyarrow, the reference and the port read the rows back;
  the file's Parquet schema is Spark's form;
- every nested null and empty case, and random nested shapes (the
  generator of `test_torch_wide_types.py`), written and read back by
  pyarrow and by the port;
- each file's stats JSON against the reference's `collect_stats` of the
  same rows; `stats_parsed` of classic, multi-part and V2 checkpoints
  against the reference's checkpoint of the same log, and reloaded;
- partitioned writes over the new types;
- DELETE (deletion vectors and copy-on-write), UPDATE with a decimal SET,
  MERGE on a decimal key against decimal keys of another scale and int
  keys, MERGE on a binary key, and OPTIMIZE (compaction and ZORDER), on
  copies of one table that the reference or the port wrote, with equal
  metrics and rows;
- `cast_values` into and out of the new types against
  `pyarrow.compute.cast(safe=False)`, constants against `pa.array`;
- a file of the eight flat types byte for byte what the writer wrote
  before it took the new types; the refusals that remain.
"""

import dataclasses
import datetime
import decimal
import glob
import hashlib
import io
import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings

import delta_tpu.api as dta
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.merge as ref_merge
import delta_tpu.commands.optimize as ref_opt  # noqa: F401 (Table.optimize)
import delta_tpu.expressions.tree as RE
from delta_tpu.engine.host import HostEngine
from delta_tpu.models.schema import from_arrow_schema, schema_to_json
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.stats.collection import collect_stats as ref_collect_stats
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.api as pta
import delta_tpu_torch.commands.dml as port_dml
import delta_tpu_torch.commands.merge as port_merge
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.errors import (
    InvariantViolationError,
    UnsupportedTableError,
)
from delta_tpu_torch.expressions.eval import (
    UnsupportedCast,
    cast_values,
    column_values,
    constant_values,
)
from delta_tpu_torch.models.batch import Batch, column_from_python
from delta_tpu_torch.models.schema import (
    StructField,
    StructType,
    check_writable,
    schema_from_json,
)
from delta_tpu_torch.stats.collection import collect_stats
from delta_tpu_torch.utils.parquet_write import data_file_bytes
from test_torch_wide_types import (
    _every_nested_case,
    _nested_tables,
    _primitives,
    _probe_table,
    port_rows,
    same_rows,
)

D = decimal.Decimal
EXACT = decimal.Context(prec=80)
CPU = TorchEngine("cpu")
DV = {"delta.enableDeletionVectors": "true"}


# ------------------------------------------------------------ helpers --

def port_schema(arrow_schema: pa.Schema) -> StructType:
    """The port's schema of an arrow schema, through the reference's
    Delta JSON of it."""
    return schema_from_json(schema_to_json(from_arrow_schema(arrow_schema)))


def to_port(tbl: pa.Table) -> Batch:
    """An arrow table as the port's Batch: each column from its Python
    values, typed by the table's Delta schema."""
    schema = port_schema(tbl.schema)
    return Batch({f.name: column_from_python(tbl.column(f.name).to_pylist(),
                                             f.data_type)
                  for f in schema.fields}, tbl.num_rows)


def pyarrow_rows(path: str) -> list:
    """Every data file's rows of a table directory, read by pyarrow."""
    files = sorted(glob.glob(os.path.join(path, "**", "*.parquet"),
                             recursive=True))
    return [r for f in files if "_delta_log" not in f
            for r in pq.read_table(f).to_pylist()]


def ref_rows(path: str, **kw) -> list:
    clear_parse_cache()
    return dta.read_table(path, engine=HostEngine(), **kw).to_pylist()


def port_read(path: str, **kw) -> list:
    return port_rows(pta.read_table(path, engine=CPU, **kw))


def assert_stats_are_the_references(path: str) -> None:
    """Each written file's stats string equals the reference's
    `collect_stats` over the rows pyarrow reads from that file."""
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    meta = snap.metadata
    from delta_tpu.models.schema import schema_from_json as ref_schema

    schema = ref_schema(meta.schemaString)
    for add in snap.state.add_files:
        tbl = pq.read_table(os.path.join(path, add.path))
        assert add.stats == ref_collect_stats(
            tbl, schema, dict(meta.configuration),
            list(meta.partitionColumns)), add.path


def assert_written_rows(path: str, want: list, with_pyarrow=True) -> None:
    """The table's rows as the reference, the port (and pyarrow, file by
    file, where no partition column is left out) read them."""
    assert same_rows(ref_rows(path), want)
    assert same_rows(port_read(path), want)
    if with_pyarrow:
        assert same_rows(pyarrow_rows(path), want)


def _money(rng, n, precision, scale, nulls):
    top = 10 ** precision - 1
    lanes = rng.integers(-10 ** min(precision, 18) + 1,
                         10 ** min(precision, 18), n)
    vals = [D(int(v) * 10 ** max(precision - 18, 0)).scaleb(-scale, EXACT)
            for v in lanes]
    vals[0] = D(top).scaleb(-scale, EXACT)    # the widest value
    vals[-1] = D(-top).scaleb(-scale, EXACT)  # and its negative
    mask = (rng.random(n) < 0.25) if nulls else None
    if mask is not None:
        mask[0] = mask[-1] = False
    return pa.array(vals, pa.decimal128(precision, scale), mask=mask)


# physical form of each case: (physical type, FLBA length, logical type)
_FORMS = {
    "decimal(1,0)": ("INT32", 0, "Decimal(precision=1, scale=0)"),
    "decimal(9,4)": ("INT32", 0, "Decimal(precision=9, scale=4)"),
    "decimal(10,2)": ("INT64", 0, "Decimal(precision=10, scale=2)"),
    "decimal(18,9)": ("INT64", 0, "Decimal(precision=18, scale=9)"),
    "decimal(19,0)": ("FIXED_LEN_BYTE_ARRAY", 9,
                      "Decimal(precision=19, scale=0)"),
    "decimal(38,10)": ("FIXED_LEN_BYTE_ARRAY", 16,
                       "Decimal(precision=38, scale=10)"),
    "byte": ("INT32", 0, "Int(bitWidth=8, isSigned=true)"),
    "short": ("INT32", 0, "Int(bitWidth=16, isSigned=true)"),
    "binary": ("BYTE_ARRAY", 0, "None"),
    "timestamp_ntz": ("INT64", 0, "Timestamp(isAdjustedToUTC=false, "
                      "timeUnit=microseconds"),
}


def _form_column(name: str, rng, n: int, nulls: bool) -> pa.Array:
    if name.startswith("decimal"):
        p, s = (int(x) for x in name[8:-1].split(","))
        return _money(rng, n, p, s, nulls)
    prims = _primitives(rng, n, nulls)
    return prims.column({"byte": "b", "short": "s", "binary": "bin",
                         "timestamp_ntz": "ntz"}[name]).combine_chunks()


# ---------------------------------------------- each type, each form --

@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("form", sorted(_FORMS))
def test_each_new_type_in_its_physical_form(tmp_path, form, nulls):
    """Exact rows (no tolerance) through pyarrow, the reference and the
    port; the leaf's Parquet form is Spark's."""
    rng = np.random.default_rng(len(form) + nulls)
    tbl = pa.table({"k": pa.array(np.arange(40), pa.int64()),
                    "v": _form_column(form, rng, 40, nulls)})
    path = str(tmp_path / "t")
    pta.write_table(path, to_port(tbl), engine=CPU,
                    target_rows_per_file=25)
    assert_written_rows(path, tbl.to_pylist())
    phys, length, logical = _FORMS[form]
    for f in glob.glob(os.path.join(path, "*.parquet")):
        col = pq.ParquetFile(f).schema.column(1)
        assert col.physical_type == phys
        assert (col.length or 0) == length
        assert str(col.logical_type).startswith(logical)
        if form.startswith("decimal"):
            assert col.converted_type == "DECIMAL"
    assert Table.for_path(path, engine=CPU).latest_snapshot() \
        .schema["v"].data_type == form
    assert_stats_are_the_references(path)


def test_every_nested_null_and_empty_case(tmp_path):
    tbl = _every_nested_case()
    path = str(tmp_path / "t")
    pta.write_table(path, to_port(tbl), engine=CPU, target_rows_per_file=4)
    assert_written_rows(path, tbl.to_pylist())
    schema = pq.read_schema(glob.glob(os.path.join(path, "*.parquet"))[0])
    assert schema.field("m").type.key_field.nullable is False
    assert_stats_are_the_references(path)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(_nested_tables())
def test_random_nested_shapes_write(tbl):
    """Port write -> pyarrow read, and port write -> port read."""
    from delta_tpu_torch.log.parquet_data import read_data_file

    data = data_file_bytes(to_port(tbl), port_schema(tbl.schema))
    assert same_rows(pq.read_table(io.BytesIO(data)).to_pylist(),
                     tbl.to_pylist(), ordered=True)
    assert same_rows(port_rows(read_data_file(data)), tbl.to_pylist(),
                     ordered=True)


# -------------------------------------------------------------- stats --

def _struct_table(rng, n) -> pa.Table:
    x = rng.normal(size=n)
    x[3] = np.nan
    return pa.table({
        "k": pa.array(np.arange(n), pa.int64()),
        "st": pa.array([None if i % 7 == 0 else {
            "x": float(x[i]), "t": datetime.datetime(2000, 1, 1 + i % 28),
            "in": None if i % 5 == 0 else {"d": D(i).scaleb(-2) - 3,
                                           "b": bytes([i % 256])}}
            for i in range(n)], pa.struct([
                ("x", pa.float64()), ("t", pa.timestamp("us", "UTC")),
                ("in", pa.struct([("d", pa.decimal128(9, 2)),
                                  ("b", pa.binary())]))])),
        "tail": pa.array(rng.integers(0, 9, n), pa.int16()),
    })


_STATS_TABLES = {
    "primitives": lambda rng: _primitives(rng, 30, True),
    "primitives_full": lambda rng: _primitives(rng, 30, False),
    "nested": lambda rng: _every_nested_case(),
    "probe": lambda rng: _probe_table(),
    "structs": lambda rng: _struct_table(rng, 30),
}
_CONFS = [{}, {"delta.dataSkippingNumIndexedCols": "3"},
          {"delta.dataSkippingNumIndexedCols": "-1"},
          {"delta.dataSkippingStatsColumns": "st.in.d,st.x,tail,dec"}]


@pytest.mark.parametrize("conf", range(len(_CONFS)))
@pytest.mark.parametrize("which", sorted(_STATS_TABLES))
def test_stats_json_equals_the_references(which, conf):
    tbl = _STATS_TABLES[which](np.random.default_rng(7))
    ref_schema = from_arrow_schema(tbl.schema)
    want = ref_collect_stats(tbl, ref_schema, _CONFS[conf], [])
    got = collect_stats(to_port(tbl), port_schema(tbl.schema),
                        _CONFS[conf], [])
    assert got == want


def _stats_log(path: str, props: dict, writer: str) -> None:
    """Three appends of the new types (decimals that Arrow's explicit
    parse takes: scale-fitting digits), written by `writer`."""
    rng = np.random.default_rng(11)
    for i in range(3):
        tbl = _primitives(rng, 20, True).drop_columns(["d38"])
        tbl = tbl.append_column("st", pa.array(
            [None if j % 4 == 0 else {"q": int(j), "w": D(j).scaleb(-1)}
             for j in range(20)],
            pa.struct([("q", pa.int8()), ("w", pa.decimal128(5, 1))])))
        if writer == "ref":
            dta.write_table(path, tbl, engine=HostEngine(),
                            properties=props if i == 0 else None)
        else:
            pta.write_table(path, to_port(tbl), engine=CPU,
                            properties=props if i == 0 else None)


def _checkpoint_adds(path: str) -> list:
    files = sorted(glob.glob(os.path.join(path, "_delta_log", "*.parquet"))
                   + glob.glob(os.path.join(path, "_delta_log", "_sidecars",
                                            "*.parquet")))
    rows = [a for f in files for t in [pq.read_table(f)]
            if "add" in t.column_names
            for a in t.column("add").to_pylist() if a]
    return sorted(({"path": a["path"], "stats": a.get("stats"),
                    "stats_parsed": a.get("stats_parsed")} for a in rows),
                  key=lambda a: a["path"])


@pytest.mark.parametrize("policy", ["classic", "multipart", "v2"])
def test_stats_parsed_checkpoints_equal_the_references(tmp_path, policy,
                                                       monkeypatch):
    """The port's checkpoint of a port-written log against the
    reference's of a copy: the adds' `stats_parsed` (and JSON stats) as
    pyarrow reads them; the port's reload rebuilds the reference's stats
    strings."""
    from delta_tpu.log.checkpointer import write_checkpoint as ref_write
    import delta_tpu_torch.config as port_config
    from delta_tpu_torch.log.checkpointer import write_checkpoint

    props = {"delta.checkpoint.writeStatsAsStruct": "true"}
    port = str(tmp_path / "port")
    _stats_log(port, props, "port")
    ref = str(tmp_path / "ref")
    shutil.copytree(port, ref)
    kw = {"policy": "v2"} if policy == "v2" else {}
    if policy == "multipart":
        import delta_tpu.config as ref_config

        monkeypatch.setattr(port_config.settings, "checkpoint_part_size", 2)
        monkeypatch.setattr(ref_config.settings, "checkpoint_part_size", 2,
                            raising=False)
    write_checkpoint(CPU, Table.for_path(port, engine=CPU)
                     .latest_snapshot(), **kw)
    clear_parse_cache()
    ref_write(HostEngine(), RefTable.for_path(ref, engine=HostEngine())
              .latest_snapshot(), **kw)
    got, want = _checkpoint_adds(port), _checkpoint_adds(ref)
    assert len(got) == 3 and repr(got) == repr(want)
    sp = got[0]["stats_parsed"]
    assert isinstance(sp["minValues"]["dec"], D) or \
        sp["minValues"]["dec"] is None
    assert isinstance(sp["minValues"]["st"]["q"], int)
    if policy == "multipart":
        parts = [sorted(os.path.basename(f) for f in glob.glob(os.path.join(
            p, "_delta_log", "*.checkpoint.*.parquet"))) for p in (port, ref)]
        assert len(parts[0]) > 1 and parts[0] == parts[1]
    clear_parse_cache()
    want_stats = sorted(
        (a["path"], a["stats"]) for a in RefTable.for_path(
            ref, engine=HostEngine()).latest_snapshot().state
        .add_files_table.to_pylist())
    snap = Table.for_path(port, engine=CPU).latest_snapshot()
    assert sorted((a.path, a.stats) for a in snap.state.add_files) \
        == want_stats
    assert same_rows(port_read(port), ref_rows(ref))


def test_struct_only_checkpoint_reloads_the_decimal_stats(tmp_path):
    """writeStatsAsJson=false: the stats live only in `stats_parsed`;
    both packages rebuild the same strings from the port's checkpoint,
    and a decimal filter keeps at least the reference's files."""
    props = {"delta.checkpoint.writeStatsAsStruct": "true",
             "delta.checkpoint.writeStatsAsJson": "false"}
    path = str(tmp_path / "t")
    _stats_log(path, props, "port")
    Table.for_path(path, engine=CPU).checkpoint()
    clear_parse_cache()
    ref = RefTable.for_path(path, engine=HostEngine()).latest_snapshot()
    want = sorted((a["path"], a["stats"]) for a in
                  ref.state.add_files_table.to_pylist())
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    assert sorted((a.path, a.stats) for a in snap.state.add_files) == want
    assert all(s is not None for _, s in want)
    kept = set(ref.scan(filter=RE.col("dec") > RE.lit(D("5000.00")))
               .file_paths())
    assert kept <= set(snap.scan(filter=PE.col("dec") > PE.lit(
        D("5000.00"))).file_paths())


# -------------------------------------------------------- partitioned --

def _partition_table() -> pa.Table:
    return pa.table({
        "k": pa.array(np.arange(12), pa.int64()),
        "pb": pa.array([1, -2, None] * 4, pa.int8()),
        "ps": pa.array([300, 300, -7, None] * 3, pa.int16()),
        "pd": pa.array([D("1.50"), D("-0.25"), None, D("100.00")] * 3,
                       pa.decimal128(7, 2)),
        "pbin": pa.array([b"ab", b"cd", None] * 4, pa.binary()),
        "pt": pa.array([datetime.datetime(2020, 1, 2, 3, 4, 5, 600000),
                        None] * 6, pa.timestamp("us")),
        "v": pa.array([{"a": [1, 2]}, None, {"a": None}] * 4,
                      pa.struct([("a", pa.list_(pa.int32()))])),
    })


@pytest.mark.parametrize("col", ["pb", "ps", "pd", "pbin", "pt"])
def test_partitioned_writes_of_the_new_types(tmp_path, col):
    tbl = _partition_table()
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    dta.write_table(ref, tbl, engine=HostEngine(), partition_by=[col])
    pta.write_table(port, to_port(tbl), engine=CPU, partition_by=[col])

    def values(path):
        clear_parse_cache()
        adds = RefTable.for_path(path, engine=HostEngine()) \
            .latest_snapshot().state.add_files_table.to_pylist()
        out = []
        for a in adds:
            v = dict(a["partition_values"])[col]
            if col in ("pb", "ps") and v is not None:
                # ROADMAP C8: beside a null, the reference spells an int
                # partition through a float ("-2.0")
                v = str(int(float(v)))
            out.append(v)
        return sorted(out, key=repr)

    assert values(port) == values(ref)

    def by_name(rows):  # a partition column reads last
        return [dict(sorted(r.items())) for r in rows]

    want = by_name(tbl.to_pylist())
    assert same_rows(by_name(port_read(port)), want)
    assert same_rows(by_name(ref_rows(port)), want)
    if col in ("pd", "pbin"):
        # ROADMAP C8: no package reads back the reference's escaped
        # directories (`pt=2020-01-02 03%3A04%3A05.600000`) or its int
        # partitions spelled "1.0"
        assert same_rows(by_name(port_read(ref)), want)


# --------------------------------------------------------- the commands --

def _wide_rows(rng, lo: int, n: int) -> pa.Table:
    k = list(range(lo, lo + n))
    valid = np.array([j % 9 != 4 for j in k])
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "price": pa.array([D(int(v)).scaleb(-2) for v in
                           rng.integers(-50000, 50000, n)],
                          pa.decimal128(7, 2), mask=~valid),
        "big": pa.array([D(int(v) * 10 ** 12 + k[i]).scaleb(-4, EXACT)
                         for i, v in enumerate(rng.integers(-10 ** 15,
                                                            10 ** 15, n))],
                        pa.decimal128(38, 4)),
        "qty": pa.array(rng.integers(-100, 100, n), pa.int8()),
        "cnt": pa.array(rng.integers(-3000, 3000, n), pa.int16(),
                        mask=np.array([j % 13 == 0 for j in k])),
        "tag": pa.array([b"t%03d" % (j % 40) for j in k], pa.binary()),
        "at": pa.array(np.datetime64("2001-01-01", "us")
                       + (np.array(k) * 3_600_000_000).astype(
                           "timedelta64[us]"), pa.timestamp("us")),
        "st": pa.array([None if j % 6 == 0 else {
            "a": j, "l": [D(j).scaleb(-1)] * (j % 3)} for j in k],
            pa.struct([("a", pa.int32()),
                       ("l", pa.list_(pa.decimal128(9, 1)))])),
        "m": pa.array([[("x", j)] if j % 2 else [] for j in k],
                      pa.map_(pa.string(), pa.int64())),
    })


def _copies(tmp_path, writer: str, props=None, files=4, rows=60):
    """One table of `files` appends written by `writer`, copied for the
    reference (first) and the port (second)."""
    rng = np.random.default_rng(5)
    src = str(tmp_path / "src")
    for i in range(files):
        tbl = _wide_rows(rng, i * rows, rows)
        p = props if i == 0 else None
        if writer == "ref":
            dta.write_table(src, tbl, engine=HostEngine(), properties=p)
        else:
            pta.write_table(src, to_port(tbl), engine=CPU, properties=p)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port


_METRIC_KEYS = {"delete": ("num_files_scanned", "num_files_rewritten",
                           "num_files_removed_fully", "num_dvs_written",
                           "num_rows_deleted", "num_rows_updated",
                           "num_rows_copied", "version")}
_MERGE_METRICS = ("num_target_rows_updated", "num_target_rows_deleted",
                  "num_target_rows_inserted", "num_target_rows_copied",
                  "num_target_files_rewritten", "num_target_files_scanned",
                  "num_source_rows", "version")


def _operation(path: str, version: int):
    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        acts = [json.loads(line) for line in f if line.strip()]
    info = next(a["commitInfo"] for a in acts if "commitInfo" in a)
    return (info["operation"], info["operationParameters"],
            {k: v for k, v in info["operationMetrics"].items()
             if "Bytes" not in k},
            sorted(((a["add"]["dataChange"] if "add" in a else None,
                     "add" if "add" in a else "remove") for a in acts
                    if "add" in a or "remove" in a), key=repr))


def _same_tables(ref: str, port: str) -> list:
    rows = ref_rows(ref)
    for path in (ref, port):
        assert same_rows(port_read(path), rows)
    assert same_rows(ref_rows(port), rows)
    return rows


def _dml_both(ref, port, fn):
    rm = fn(ref_dml, RefTable.for_path(ref, engine=HostEngine()), RE)
    pm = fn(port_dml, Table.for_path(port, engine=CPU), PE)
    assert dataclasses.asdict(rm) == dataclasses.asdict(pm)
    if rm.version is not None:
        assert _operation(ref, rm.version) == _operation(port, pm.version)
    return pm, _same_tables(ref, port)


WRITERS = ["ref", "port"]


@pytest.mark.parametrize("writer", WRITERS)
def test_delete_with_deletion_vectors(tmp_path, writer):
    ref, port = _copies(tmp_path, writer, DV)
    pm, rows = _dml_both(ref, port, lambda m, t, E: m.delete(
        t, (E.col("price") < E.lit(D("-100.00")))
        | (E.col("k") >= E.lit(180))))
    assert pm.num_dvs_written >= 1 and pm.num_files_removed_fully == 1
    assert all(r["price"] is None or r["price"] >= D("-100.00")
               for r in rows)


@pytest.mark.parametrize("writer", WRITERS)
def test_delete_copy_on_write(tmp_path, writer):
    ref, port = _copies(tmp_path, writer)
    pm, rows = _dml_both(ref, port, lambda m, t, E: m.delete(
        t, (E.col("cnt") > E.lit(1000)) & (E.col("k") < E.lit(120))))
    assert pm.num_files_rewritten == 2 and pm.num_dvs_written == 0


@pytest.mark.parametrize("writer", WRITERS)
def test_update_with_a_decimal_set(tmp_path, writer):
    ref, port = _copies(tmp_path, writer, DV)
    _dml_both(ref, port, lambda m, t, E: m.update(
        t, {"price": E.lit(D("1.25")), "big": E.col("price"),
            "qty": E.lit(7), "tag": E.lit(b"new")},
        E.col("k") < E.lit(70)))
    pm, rows = _dml_both(ref, port, lambda m, t, E: m.update(
        t, {"price": D("-2.5"), "cnt": 5}, E.col("big") > E.lit(D("0"))))
    assert pm.num_rows_updated > 0
    assert sum(r["price"] == D("-2.50") for r in rows) == pm.num_rows_updated


def _merge_both(ref, port, src_tbl, build):
    rm = build(ref_merge.merge, RefTable.for_path(ref, engine=HostEngine()),
               src_tbl, RE).execute()
    pm = build(port_merge.merge, Table.for_path(port, engine=CPU),
               to_port(src_tbl), PE).execute()
    assert {k: getattr(rm, k) for k in _MERGE_METRICS} == \
        {k: getattr(pm, k) for k in _MERGE_METRICS}
    assert _operation(ref, rm.version) == _operation(port, pm.version)
    return pm, _same_tables(ref, port)


def _upsert(key: str, sets: dict, insert_key: bool = True):
    def build(m, t, s, E):
        values = {"k": E.col("source.k")}
        if insert_key:
            values[key] = E.col(f"source.{key}")
        return (m(t, s, on=E.col(f"target.{key}") == E.col(f"source.{key}"))
                .when_matched_update(set={c: E.col(f"source.{v}")
                                          for c, v in sets.items()})
                .when_not_matched_insert(values=values))
    return build


_KEY_SOURCES = {
    # the target's decimal(7,2) key against decimal(10,3) and int keys:
    # 1.50 matches 1.500 and an integer 2 matches 2.00, never 150
    "decimal_other_scale": lambda rows: pa.table({
        "price": pa.array([r["price"] for r in rows] + [D("0.001")],
                          pa.decimal128(10, 3)),
        "k": pa.array([10_000 + i for i in range(len(rows) + 1)],
                      pa.int64())}),
    "int_keys": lambda rows: pa.table({
        "price": pa.array([int(r["price"]) for r in rows] + [150],
                          pa.int64()),
        "k": pa.array([10_000 + i for i in range(len(rows) + 1)],
                      pa.int64())}),
    "binary": lambda rows: pa.table({
        "tag": pa.array([b"t001", b"t002", b"zzz"], pa.binary()),
        "k": pa.array([10_000, 10_001, 10_002], pa.int64())}),
}


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("case", sorted(_KEY_SOURCES))
def test_merge_on_a_new_key_type(tmp_path, writer, case, monkeypatch):
    """The device join route in both packages (K9's plain version here):
    a decimal key joins by value, binary by bytes."""
    monkeypatch.setattr(ref_merge, "DEVICE_JOIN_MIN_ROWS", 0)
    monkeypatch.setattr(port_merge, "DEVICE_JOIN_MIN_ROWS", 0)
    ref, port = _copies(tmp_path, writer)
    key = "tag" if case == "binary" else "price"
    target = ref_rows(ref)
    if case == "int_keys":  # whole-valued prices: each matches an int
        picks = [r for r in target if r["price"] is not None
                 and r["price"] == r["price"].to_integral_value()][:3]
        assert picks
    else:
        picks = [r for r in target if r["price"] is not None][:4:2]
    src = _KEY_SOURCES[case](picks)
    if case == "int_keys":
        # an int64 does not cast into decimal(7,2) (Arrow refuses it, unsafe
        # or not): inserting the key fails in both packages, before any
        # file is written
        for m, t, s, E in ((ref_merge.merge, RefTable.for_path(
                ref, engine=HostEngine()), src, RE), (
                port_merge.merge, Table.for_path(port, engine=CPU),
                to_port(src), PE)):
            with pytest.raises(Exception, match="recision"):
                _upsert(key, {"k": "k"})(m, t, s, E).execute()
    pm, rows = _merge_both(ref, port, src, _upsert(
        key, {"k": "k"}, insert_key=case != "int_keys"))
    assert pm.num_target_rows_updated >= 1
    assert pm.num_target_rows_inserted >= 1


@pytest.mark.parametrize("writer", WRITERS)
def test_merge_updates_nested_and_wide_columns(tmp_path, writer,
                                               monkeypatch):
    monkeypatch.setattr(ref_merge, "DEVICE_JOIN_MIN_ROWS", 0)
    monkeypatch.setattr(port_merge, "DEVICE_JOIN_MIN_ROWS", 0)
    ref, port = _copies(tmp_path, writer, DV)
    src = _wide_rows(np.random.default_rng(9), 100, 80).drop_columns(
        ["k"]).append_column("k", pa.array(np.arange(80) * 3 + 100,
                                           pa.int64()))

    def build(m, t, s, E):
        return (m(t, s, on=E.col("target.k") == E.col("source.k"))
                .when_matched_update_all()
                .when_not_matched_insert_all())

    pm, rows = _merge_both(ref, port, src, build)
    assert pm.num_target_rows_updated > 0 and pm.num_target_rows_inserted > 0


@pytest.mark.parametrize("writer", WRITERS)
def test_optimize_compaction(tmp_path, writer):
    ref, port = _copies(tmp_path, writer, DV)
    _dml_both(ref, port, lambda m, t, E: m.delete(
        t, E.col("qty") > E.lit(50)))
    rm = RefTable.for_path(ref, engine=HostEngine()).optimize() \
        .execute_compaction()
    pm = Table.for_path(port, engine=CPU).optimize().execute_compaction()
    assert (rm.num_files_removed, rm.num_files_added) == \
        (pm.num_files_removed, pm.num_files_added) == (4, 1)
    assert _operation(ref, rm.version) == _operation(port, pm.version)
    _same_tables(ref, port)


_ZORDER = [("qty", "cnt"), ("price", "k"), ("at", "qty"), ("tag", "k"),
           ("big", "cnt")]


def _curve_order(rows: list, cols) -> list:
    """The Z-order of `rows` (a bin's rows in read order) by the numeric
    ranks of `cols`: each column ranked by value (a null as the type's
    zero; ties by row), the ranks scaled by the 1024-row bucket to 32 bits
    and interleaved MSB first; returns the rows along the curve."""
    zero = {"tag": b"", "at": datetime.datetime(1970, 1, 1)}
    ranks = []
    for c in cols:
        vals = [r[c] if r[c] is not None else zero.get(c, 0) for r in rows]
        order = sorted(range(len(vals)), key=lambda i: vals[i])
        rank = [0] * len(vals)
        for pos, i in enumerate(order):
            rank[i] = pos << 22  # 32 - bits of (1024 - 1)
        ranks.append(rank)
    codes = []
    for i in range(len(rows)):
        code = 0
        for bit in range(31, -1, -1):
            for r in ranks:
                code = (code << 1) | ((r[i] >> bit) & 1)
        codes.append(code)
    return [rows[i] for i in sorted(range(len(rows)), key=codes.__getitem__)]


@pytest.mark.parametrize("cols", _ZORDER, ids="-".join)
def test_optimize_zorder_by_a_new_type(tmp_path, cols, monkeypatch):
    """The port's rows equal the reference's; the port's file follows the
    curve of the columns' ranks by value (the reference ranks a decimal
    or a binary column by its text: ROADMAP C13). The reference's curve
    needs the test-local `_x32` patch (ROADMAP C0)."""
    import jax

    import delta_tpu.ops.pallas_kernels as ref_pk
    import delta_tpu_torch.commands.optimize as port_opt

    monkeypatch.setattr(ref_pk, "_x32", lambda: jax.enable_x64(False))
    ref, port = _copies(tmp_path, "port")
    RefTable.for_path(ref, engine=HostEngine()).optimize() \
        .execute_zorder_by(*cols)
    read = port_opt.read_add_files_logical
    bins = []
    monkeypatch.setattr(port_opt, "read_add_files_logical",
                        lambda *a: bins.append(read(*a)) or bins[-1])
    pm = Table.for_path(port, engine=CPU).optimize().execute_zorder_by(*cols)
    assert pm.num_files_added == 1 and len(bins) == 1
    rows = _same_tables(ref, port)
    assert len(rows) == 240
    bin_rows = port_rows(Batch.concat(bins[0]))
    assert same_rows(port_read(port), _curve_order(bin_rows, cols),
                     ordered=True)


def test_reference_orders_decimals_by_text():
    """ROADMAP C13: the reference's curve keys rank a decimal column's
    `str` ("10.00" before "9.00"), the port's its value."""
    from delta_tpu.ops.zorder import _to_sortable_u32
    from delta_tpu_torch.ops.zorder import to_sortable_u32

    vals = pa.array([D("9.00"), D("10.00"), D("-1.00"), D("-2.00")],
                    pa.decimal128(7, 2))
    ref_key = _to_sortable_u32(np.asarray(vals).astype(str))
    port_key = to_sortable_u32(np.array([900, 1000, -100, -200]))
    assert list(np.argsort(ref_key)) == [2, 3, 1, 0]  # by text
    assert list(np.argsort(port_key)) == [3, 2, 0, 1]  # by value


def test_checkpoint_forms_of_a_wide_table_reload(tmp_path):
    """Classic, multi-part and V2 checkpoints (JSON and struct stats) of
    a port-written wide table after DML: both packages load the same
    files and rows."""
    from delta_tpu_torch.log.checkpointer import write_checkpoint

    props = dict(DV, **{"delta.checkpoint.writeStatsAsStruct": "true"})
    _, port = _copies(tmp_path, "port", props)
    port_dml.delete(Table.for_path(port, engine=CPU),
                    PE.col("price") > PE.lit(D("0.00")))
    want = ref_rows(port)
    for kw in ({}, {"policy": "v2"}):
        write_checkpoint(CPU, Table.for_path(port, engine=CPU)
                         .latest_snapshot(), **kw)
        clear_parse_cache()
        ref_state = RefTable.for_path(port, engine=HostEngine()) \
            .latest_snapshot().state.add_files_table
        snap = Table.for_path(port, engine=CPU).latest_snapshot()
        assert sorted(a.path for a in snap.state.add_files) == \
            sorted(ref_state.column("path").to_pylist())
        assert same_rows(port_read(port), want)
        assert same_rows(ref_rows(port), want)


# ------------------------------------------------------------- casts --

def _cast_both(arr: pa.Array, target: pa.DataType, delta_type: str):
    """(the port's cast as Python values, Arrow's), or the error kinds."""
    try:
        want = ("ok", pc.cast(arr, target, safe=False).to_pylist())
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError,
            UnicodeDecodeError):
        # (Arrow's unsafe cast of bytes that are not UTF-8 to a string
        # gives strings no reader decodes; the port refuses the cast)
        want = ("error", None)
    src_t = port_schema(pa.schema([("x", arr.type)]))["x"].data_type
    col = column_from_python(arr.to_pylist(), src_t)
    try:
        values, valid = cast_values(column_values(col.values, col.valid,
                                                  col.data_type), delta_type)
        from delta_tpu_torch.models.batch import Column

        got = ("ok", Column(values, None if valid.all() else valid,
                            delta_type if delta_type in (
                                "binary", "timestamp_ntz")
                            or delta_type.startswith("decimal")
                            else None).to_python())
    except UnsupportedCast:
        got = ("error", None)
    return got, want


_FLOATS = [0.0, -0.0, 1.005, -2.675, 12.345, 0.125, 0.375, 0.625, 2.5,
           99999.994, 99999.996, 1e10, 5e-3, float("nan"), float("inf"),
           -float("inf"), None, 1234.5678, -0.005]
_CAST_SOURCES = {
    "int64": pa.array([0, 1, -5, 123456, 2 ** 40, None], pa.int64()),
    "int32": pa.array([0, 7, -2 ** 31, None], pa.int32()),
    "int16": pa.array([300, -7, None], pa.int16()),
    "int8": pa.array([1, -128, None], pa.int8()),
    "float64": pa.array(_FLOATS, pa.float64()),
    "float32": pa.array(_FLOATS, pa.float32()),
    "string": pa.array(["1.5", "-0.125", "12", "1e2", "99999.999", None,
                        "+4.25", ".5", "1.", "-.5e1", "0.005", "1E-50"]),
    "bad_string": pa.array(["1.5", "abc"]),
    "empty_string": pa.array([""]),
    "dec72": pa.array([D("1.50"), D("-99999.99"), D("0.05"), None],
                      pa.decimal128(7, 2)),
    "dec103": pa.array([D("1.505"), D("-1.505"), D("1234.891"), D("0.001"),
                        None], pa.decimal128(10, 3)),
    "dec3810": pa.array([D("1234567890.0123456789"), D("-1.0000000005"),
                         None], pa.decimal128(38, 10)),
    "binary": pa.array([b"ab", b"", None], pa.binary()),
    "bad_binary": pa.array([b"\xff"], pa.binary()),
    "bool": pa.array([True, False, None]),
    "ntz": pa.array([datetime.datetime(2020, 1, 2, 3, 4, 5, 6), None],
                    pa.timestamp("us")),
    "ts_strings": pa.array(["2020-01-02 03:04:05", "2020-01-02T03:04:05.5",
                            "2020-01-02", None]),
}
_CAST_TARGETS = {
    "decimal(7,2)": pa.decimal128(7, 2),
    "decimal(5,0)": pa.decimal128(5, 0),
    "decimal(12,2)": pa.decimal128(12, 2),
    "decimal(38,2)": pa.decimal128(38, 2),
    "decimal(19,4)": pa.decimal128(19, 4),
    "short": pa.int16(),
    "byte": pa.int8(),
    "binary": pa.binary(),
    "string": pa.string(),
    "timestamp_ntz": pa.timestamp("us"),
}
_CAST_PAIRS = (
    [(s, t) for s in ("int64", "int32", "int16", "int8", "float64",
                      "float32", "string", "bad_string", "empty_string",
                      "dec72", "dec103", "dec3810", "bool")
     for t in ("decimal(7,2)", "decimal(5,0)", "decimal(12,2)",
               "decimal(38,2)", "decimal(19,4)")]
    + [(s, t) for s in ("int64", "int32", "float64", "string", "dec72",
                        "dec103", "bool")
       for t in ("short", "byte")]
    + [("string", "binary"), ("binary", "binary"), ("binary", "string"),
       ("bad_binary", "string"), ("int64", "binary"), ("dec72", "string"),
       ("dec103", "string"), ("ntz", "timestamp_ntz"),
       ("int64", "timestamp_ntz"), ("ts_strings", "timestamp_ntz"),
       ("ntz", "string")])


@pytest.mark.parametrize("source,target", _CAST_PAIRS,
                         ids=[f"{s}->{t}" for s, t in _CAST_PAIRS])
def test_cast_values_against_pyarrow(source, target):
    got, want = _cast_both(_CAST_SOURCES[source], _CAST_TARGETS[target],
                           target)
    assert repr(got) == repr(want)


def test_decimal_casts_to_floats_against_pyarrow():
    from delta_tpu_torch.models.batch import Column

    for arr in (_CAST_SOURCES["dec72"], _CAST_SOURCES["dec103"]):
        t = port_schema(pa.schema([("x", arr.type)]))["x"].data_type
        col = column_from_python(arr.to_pylist(), t)
        for target, pt in (("double", pa.float64()),
                           ("float", pa.float32()), ("long", pa.int64()),
                           ("integer", pa.int32())):
            values, valid = cast_values(column_values(
                col.values, col.valid, col.data_type), target)
            got = Column(values, None if valid.all() else valid).to_python()
            assert got == pc.cast(arr, pt, safe=False).to_pylist(), target


_CONSTANTS = [D("1.5"), D("1.234"), D("-0.10"), D("123456.78"), 5, 10 ** 6,
              1.5, "1.5", True, 2 ** 70, b"x", "é", bytearray(b"z"), 200,
              -129, datetime.datetime(2020, 1, 1, 1),
              datetime.datetime(2020, 1, 1, 1, tzinfo=datetime.timezone(
                  datetime.timedelta(hours=2))), datetime.date(2020, 1, 1)]


@pytest.mark.parametrize("target", sorted(_CAST_TARGETS))
def test_constants_against_pa_array(target):
    from delta_tpu_torch.models.batch import Column

    for value in _CONSTANTS:
        try:
            want = pa.array([value] * 2, _CAST_TARGETS[target]).to_pylist()
        except (pa.ArrowInvalid, pa.ArrowTypeError, TypeError,
                OverflowError):
            want = "error"
        try:
            values, valid = constant_values(value, target, 2)
            got = Column(values, None if valid.all() else valid,
                         target if target in ("binary", "timestamp_ntz")
                         or target.startswith("decimal") else None
                         ).to_python()
        except UnsupportedCast:
            got = "error"
        assert repr(got) == repr(want), (target, value)


# ------------------------------------------- flat files and refusals --

# sha256 of `_flat_batch()`'s data file as the writer wrote it before it
# took the wider types (the parent tree's `utils/parquet_write.py`)
FLAT_FILE_SHA256 = (
    "99fda8c742b6d386140267666e0dda5cd74d9a2293127717a15cab922b039242")


def _flat_batch():
    from delta_tpu_torch.models.batch import Column

    rng = np.random.default_rng(3)
    n = 3000
    valid = rng.random(n) > 0.1
    words = np.array([f"w{i % 97}é" for i in range(n)], object)
    cols = {
        "l": Column(rng.integers(-2 ** 62, 2 ** 62, n)),
        "i": Column(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                    valid),
        "d": Column(rng.normal(size=n)),
        "f": Column(rng.normal(size=n).astype(np.float32), valid),
        "b": Column(rng.random(n) < 0.5),
        "s": Column(np.where(valid, words, ""), valid),
        "dt": Column(np.datetime64("2000-01-01") + rng.integers(
            0, 9000, n).astype("timedelta64[D]")),
        "ts": Column(np.datetime64("2000-01-01", "us") + rng.integers(
            0, 10 ** 15, n).astype("timedelta64[us]"), valid),
    }
    schema = StructType([StructField(k, t, nullable=k != "l") for k, t in (
        ("l", "long"), ("i", "integer"), ("d", "double"), ("f", "float"),
        ("b", "boolean"), ("s", "string"), ("dt", "date"),
        ("ts", "timestamp"))])
    return Batch(cols, n), schema


def test_a_file_of_the_flat_types_is_byte_for_byte_unchanged():
    batch, schema = _flat_batch()
    data = data_file_bytes(batch, schema)
    assert hashlib.sha256(data).hexdigest() == FLAT_FILE_SHA256
    assert pq.read_table(io.BytesIO(data)).num_rows == 3000


def test_a_null_in_a_non_nullable_nested_field_is_refused(tmp_path):
    """Refused before any file is written (a REQUIRED Parquet field
    cannot hold it); the same struct with the null elsewhere writes. The
    reference writes such a row (ROADMAP C14)."""
    path = str(tmp_path / "t")
    t = StructType([StructField("a", "integer", nullable=False),
                    StructField("b", "string")])
    from delta_tpu_torch.models.schema import ArrayType, MapType

    schema_cols = {"k": column_from_python([1, 2], "long"),
                   "s": column_from_python([{"a": 1, "b": None},
                                            {"a": 2, "b": "x"}], t)}
    schema_cols["s"].data_type = t
    pta.write_table(path, Batch(schema_cols, 2), engine=CPU)
    assert same_rows(ref_rows(path), [{"k": 1, "s": {"a": 1, "b": None}},
                                      {"k": 2, "s": {"a": 2, "b": "x"}}])
    before = sorted(os.listdir(path))
    for v, t2 in (({"a": None, "b": "x"}, t),
                  ([1, None], ArrayType("long", contains_null=False)),
                  ([(None, 1)], MapType("string", "long")),
                  ([("k", None)], MapType("string", "long",
                                          value_contains_null=False))):
        col = column_from_python([v], t2)
        col.data_type = t2
        q = str(tmp_path / f"q{len(os.listdir(tmp_path))}")
        with pytest.raises(InvariantViolationError):
            pta.write_table(q, Batch({"x": col}, 1), engine=CPU)
        assert not os.path.exists(q) or not glob.glob(
            os.path.join(q, "*.parquet"))
    assert sorted(os.listdir(path)) == before
    ref = str(tmp_path / "ref")  # C14: the reference writes the null
    dta.write_table(ref, pa.table({"s": pa.array(
        [{"a": 1, "b": None}], pa.struct([pa.field("a", pa.int32(), False),
                                          ("b", pa.string())]))}),
        engine=HostEngine())
    dta.write_table(ref, pa.table({"s": pa.array(
        [{"a": None, "b": "x"}], pa.struct([("a", pa.int32()),
                                            ("b", pa.string())]))}),
        engine=HostEngine())
    assert {"a": None, "b": "x"} in [r["s"] for r in ref_rows(ref)]
    with pytest.raises(InvariantViolationError):
        pta.write_table(ref, to_port(pa.table({"s": pa.array(
            [{"a": None, "b": "x"}], pa.struct([("a", pa.int32()),
                                                ("b", pa.string())]))})),
            engine=CPU)


def test_check_writable_refuses_only_what_is_still_queued():
    for t in ("decimal(39,2)", "decimal(5,7)", "variant", "interval"):
        with pytest.raises(UnsupportedTableError):
            check_writable(StructType([StructField("x", t)]))
    check_writable(port_schema(_probe_table().schema))
    check_writable(port_schema(_every_nested_case().schema))


def test_appending_integers_to_a_decimal_column_is_refused(tmp_path):
    """Unscaled lanes of another scale would write other values."""
    from delta_tpu_torch.errors import SchemaMismatchError

    path = str(tmp_path / "t")
    tbl = pa.table({"d": pa.array([D("1.50")], pa.decimal128(7, 2))})
    pta.write_table(path, to_port(tbl), engine=CPU)
    with pytest.raises(SchemaMismatchError):
        pta.write_table(path, {"d": np.array([150])}, engine=CPU)
    other = pa.table({"d": pa.array([D("1.500")], pa.decimal128(10, 3))})
    with pytest.raises(SchemaMismatchError):
        pta.write_table(path, to_port(other), engine=CPU)
    assert same_rows(port_read(path), [{"d": D("1.50")}])


def test_chip_write_phase_passes_on_the_cpu():
    """`chip_smoke.py`'s step 20 with the plain versions, on step 19's
    read at two links of each store_sales file: every step's rows held to
    its numpy model inside the phase, its constants those of the
    fixture's generator."""
    import chip_smoke
    from test_torch_wide_types import DATE_HI, FIXTURES, quarter

    lo, hi = quarter(2)
    assert chip_smoke.WIDE_DELETE_RANGE == (lo, lo + (hi - lo) * 9 // 10)
    assert chip_smoke.WIDE_LAST_QUARTER == quarter(3) == (
        quarter(3)[0], DATE_HI + 1)
    keep = {}
    chip_smoke.wide_types_phase(FIXTURES, "cpu", "cpu", links=2, keep=keep)
    out = chip_smoke.wide_write_phase(keep["all"], keep["nested"], FIXTURES,
                                      "cpu", "cpu", links=2)
    steps = out["steps"]
    assert list(steps) == ["write", "reload", "read_all", "delete", "update",
                           "merge", "optimize_zorder", "checkpoint",
                           "checkpoint_reload", "read_profit",
                           "read_all_after", "nested_write"]
    assert out["rows"] == 2 * 23437
    assert steps["delete"]["dvs"] == steps["delete"]["files_kept"] > 0
    assert steps["optimize_zorder"]["files_added"] == 1
    assert all(s["rows_per_s"] > 0 for s in steps.values() if s["rows"])

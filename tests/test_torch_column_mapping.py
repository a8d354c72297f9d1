"""Column mapping and ALTER TABLE: the port against the JAX package.

Every comparison exact (rows as multisets of Python values, compared by
`repr`):

- fresh mapped tables (mode `name` and `id`, flat, partitioned, a nested
  struct) written by the port: its own rows and the reference's read of
  them equal the input; every Parquet field at every depth, every stats
  key at every depth and every `partitionValues` key is a physical name;
  the stats equal an unmapped table's of the same rows with the keys
  renamed; ids, protocol and configuration equal the reference's;
- the port reads the reference's mapped tables (fresh, partitioned,
  nested, renamed, dropped and added columns, nested fields dropped and
  added, DVs, a `stats_parsed` checkpoint) to the reference's rows, and
  the reference reads the port's tables built the same way to the port's;
- data skipping through a renamed column plans on the stats lanes
  (`scan.device_plans`) and keeps the same files as the old name did;
  partition pruning after a renamed partition column keeps the same
  files; the conflict check reads physical partition keys;
- DELETE (copy-on-write and DVs), UPDATE, MERGE and OPTIMIZE ZORDER by a
  renamed column on copies of one reference-written mapped table: both
  packages read the same rows from both copies, the commits agree, the
  port's new files are physical;
- the ALTER operations commit the reference's operation names,
  parameters, protocols and metadata (physical names masked), and refuse
  with the reference's error classes;
- the commit handoff carries a metadata-only commit into the cached
  snapshot; a checkpoint's `stats_parsed` carries physical names and its
  reload skips as the JSON stats do.

The reference's own faults under column mapping (`ROADMAP.md` C15-C17)
are held apart, each by a flag: `_REFERENCE_LOSES_RENAMED` (a mode
change gives the existing columns new physical names, so the old files'
renamed columns read as null), `_REFERENCE_NULLS_NESTED` (it writes
nested fields under their logical names and reads the port's physical
ones as null) and `_REFERENCE_OMITS_READER_FEATURE` (its upgrade of a
(3, 7) table leaves columnMapping out of readerFeatures).
"""

import json
import os
import re
import shutil

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.alter as ref_alter
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.merge as ref_merge
import delta_tpu.commands.optimize as ref_opt  # noqa: F401 (Table.optimize)
import delta_tpu.expressions.tree as RE
import delta_tpu.ops.pallas_kernels as ref_pk
from delta_tpu.constraints import add_constraint
from delta_tpu.engine.host import HostEngine
from delta_tpu.models.schema import PrimitiveType
from delta_tpu.models.schema import StructField as RefField
from delta_tpu.models.schema import StructType as RefStruct
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.api as pta
import delta_tpu_torch.commands.alter as port_alter
import delta_tpu_torch.commands.dml as port_dml
import delta_tpu_torch.commands.merge as port_merge
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.columnmapping import physical_schema
from delta_tpu_torch.errors import (
    ColumnMappingModeChangeError,
    ConcurrentAppendError,
    DeltaError,
    NonExistentColumnError,
    SchemaEvolutionError,
    UnsupportedTableError,
)
from delta_tpu_torch.log.checkpointer import write_checkpoint
from delta_tpu_torch.txn.isolation import IsolationLevel
from delta_tpu_torch.models.schema import StructField, StructType
from test_torch_wide_types import port_rows, same_rows
from test_torch_wide_write import to_port

CPU = TorchEngine("cpu")
NAME = {"delta.columnMapping.mode": "name"}
DV = {"delta.enableDeletionVectors": "true"}
STRUCT = pa.struct([("a", pa.int64()), ("b", pa.string())])

# the reference's faults under column mapping (ROADMAP.md C15-C17)
_REFERENCE_LOSES_RENAMED = True
_REFERENCE_NULLS_NESTED = True
_REFERENCE_OMITS_READER_FEATURE = True


@pytest.fixture(autouse=True)
def ref_x32(monkeypatch):
    # the reference's Z-order under this jax (ROADMAP C0)
    monkeypatch.setattr(ref_pk, "_x32", lambda: jax.enable_x64(False))


# ------------------------------------------------------------ helpers --

def _arrow(lo: int, n: int, nested=False, part=False) -> pa.Table:
    rng = np.random.default_rng(lo)
    ids = np.arange(lo, lo + n, dtype=np.int64)
    cols = {"id": pa.array(ids),
            "name": pa.array([f"n{i % 23}" for i in ids],
                             mask=ids % 9 == 4),
            "v": pa.array(rng.normal(size=n).round(3), mask=ids % 7 == 1)}
    if nested:
        cols["s"] = pa.array([None if i % 11 == 3 else
                              {"a": int(i) * 2,
                               "b": None if i % 5 == 0 else f"x{i % 6}"}
                              for i in ids], STRUCT)
    if part:
        cols["p"] = pa.array([["u", "v", "w"][i % 3] for i in ids],
                             mask=ids % 13 == 6)
    return pa.table(cols)


def _write(pkg: str, path: str, tables, props=None, partition_by=None,
           rows_per_file=None) -> None:
    for i, t in enumerate(tables):
        kw = dict(partition_by=partition_by) if partition_by else {}
        if i == 0 and props:
            kw["properties"] = props
        if pkg == "ref":
            dta.write_table(path, t, engine=HostEngine(), **kw)
        else:
            pta.write_table(path, to_port(t), engine=CPU,
                            target_rows_per_file=rows_per_file, **kw)


def ref_read(path: str, **kw) -> list:
    clear_parse_cache()
    return dta.read_table(path, engine=HostEngine(), **kw).to_pylist()


def port_read(path: str, **kw) -> list:
    return port_rows(pta.read_table(path, engine=CPU, **kw))


def _names(path: str, pkg: str) -> list:
    if pkg == "ref":
        clear_parse_cache()
        return dta.read_table(path, engine=HostEngine()).column_names
    return pta.read_table(path, engine=CPU).column_names


def _commit(path: str, version: int) -> dict:
    out = {}
    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        for line in f:
            if line.strip():
                (k, v), = json.loads(line).items()
                out.setdefault(k, []).append(v)
    return out


def _version(path: str) -> int:
    return max(int(n[:20]) for n in os.listdir(os.path.join(path,
                                                            "_delta_log"))
               if n.endswith(".json") and n[:20].isdigit())


def _schema(path: str) -> StructType:
    return Table.for_path(path, engine=CPU).latest_snapshot().schema


def _physical_names(t) -> set:
    out = set()
    for f in t.fields:
        out.add(f.physical_name)
        if isinstance(f.data_type, StructType):
            out |= _physical_names(f.data_type)
    return out


def _arrow_names(t) -> list:
    """Every field name of an arrow type, at every depth."""
    out = []
    if pa.types.is_struct(t):
        for i in range(t.num_fields):
            out.append(t.field(i).name)
            out += _arrow_names(t.field(i).type)
    elif pa.types.is_list(t):
        out += _arrow_names(t.value_type)
    return out


def _keys(d) -> list:
    out = []
    for k, v in d.items():
        out.append(k)
        if isinstance(v, dict):
            out += _keys(v)
    return out


def assert_physical(path: str) -> None:
    """Every data file's Parquet fields, every stats key and every
    partitionValues key of the live files are the schema's physical
    names (col-<uuid> on a fresh table), at every depth."""
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    schema = snap.schema
    pkeys = {schema[c].physical_name for c in snap.partition_columns}
    assert snap.state.add_files
    # the schema's physical form names each file's fields, in its order
    phys = {f.name: f for f in physical_schema(schema).fields}
    for add in snap.state.add_files:
        fs = pq.read_schema(os.path.join(path, add.path))
        live = [f for f in fs if f.name in phys]
        assert [f.name for f in live] == [n for n in phys if n in fs.names]
        for f in live:
            if pa.types.is_struct(f.type):
                assert set(_arrow_names(f.type)) <= set(
                    _nested_names(phys[f.name].data_type)) | {
                    n for n in _arrow_names(f.type) if n.startswith("col-")}
    for add in snap.state.add_files:
        fs = pq.read_schema(os.path.join(path, add.path))
        names = [n for f in fs for n in [f.name] + _arrow_names(f.type)]
        assert names and all(n.startswith("col-") for n in names), names
        stats = json.loads(add.stats)
        for k in ("minValues", "maxValues", "nullCount"):
            assert all(n.startswith("col-")
                       for n in _keys(stats.get(k, {})))
        assert set(add.partitionValues) == pkeys
        assert all(n.startswith("col-") for n in pkeys)


def _nested_names(t) -> list:
    out = []
    if isinstance(t, StructType):
        for f in t.fields:
            out.append(f.name)
            out += _nested_names(f.data_type)
    return out


def _to_logical_stats(stats: dict, schema: StructType) -> dict:
    def walk(d, t):
        out = {}
        for k, v in d.items():
            f = next(f for f in t.fields if f.physical_name == k)
            out[f.name] = walk(v, f.data_type) if isinstance(v, dict) else v
        return out
    return {k: walk(v, schema) if isinstance(v, dict) else v
            for k, v in stats.items()}


def _masked(schema_string: str) -> str:
    return re.sub(r"col-[0-9a-f-]{36}", "col-*", schema_string)


def _nested_nulled(rows: list) -> list:
    """Rows with every struct's fields null (the reference's read of the
    port's nested physical names, `_REFERENCE_NULLS_NESTED`)."""
    return [{k: ({f: None for f in v} if isinstance(v, dict) else v)
             for k, v in r.items()} for r in rows]


def _held_cross(path: str, nested: bool) -> list:
    """The reference reads the port's table to the port's rows (a nested
    struct's fields null, `_REFERENCE_NULLS_NESTED`); returns them."""
    got = port_read(path)
    want = _nested_nulled(got) if nested and _REFERENCE_NULLS_NESTED \
        else got
    assert same_rows(ref_read(path), want)
    assert _names(path, "ref") == _names(path, "port")
    return got


# -------------------------------------------------- fresh mapped tables --

FRESH = {"flat": dict(), "partitioned": dict(part=True),
         "nested": dict(nested=True), "id": dict(nested=True, part=True)}


@pytest.mark.parametrize("kind", list(FRESH))
def test_fresh_mapped_table_round_trip(tmp_path, kind):
    kw = FRESH[kind]
    props = {"delta.columnMapping.mode": "id" if kind == "id" else "name"}
    pb = ["p"] if kw.get("part") else None
    tables = [_arrow(i * 40, 40, **kw) for i in range(3)]
    want = [r for t in tables for r in t.to_pylist()]
    port, plain, ref = (str(tmp_path / n) for n in ("port", "plain", "ref"))
    _write("port", port, tables, props, pb, rows_per_file=15)
    _write("port", plain, tables, None, pb, rows_per_file=15)
    _write("ref", ref, tables[:1], props, pb)
    assert same_rows(port_read(port), want)
    _held_cross(port, kw.get("nested", False))
    assert_physical(port)
    # the stats are an unmapped table's of the same rows, keys renamed
    schema = _schema(port)
    mapped = Table.for_path(port, engine=CPU).latest_snapshot()
    unmapped = Table.for_path(plain, engine=CPU).latest_snapshot()
    assert [_to_logical_stats(json.loads(a.stats), schema)
            for a in mapped.state.add_files] == \
        [json.loads(a.stats) for a in unmapped.state.add_files]
    # ids, protocol and configuration as the reference creates them
    pm, rm = _commit(port, 0)["metaData"][0], _commit(ref, 0)["metaData"][0]
    assert _masked(pm["schemaString"]) == _masked(rm["schemaString"])
    assert pm["configuration"] == rm["configuration"]
    assert pm["partitionColumns"] == rm["partitionColumns"]
    assert _commit(port, 0)["protocol"] == _commit(ref, 0)["protocol"] \
        == [{"minReaderVersion": 2, "minWriterVersion": 5}]
    # a filtered read on a data column and on the partition column
    f = (PE.col("id") >= PE.lit(50)) & (PE.col("id") < PE.lit(90))
    rf = (RE.col("id") >= RE.lit(50)) & (RE.col("id") < RE.lit(90))
    assert same_rows(port_read(port, filter=f),
                     [r for r in want if 50 <= r["id"] < 90])
    if not kw.get("nested"):
        assert same_rows(ref_read(port, filter=rf), port_read(port,
                                                              filter=f))
    if pb:
        assert same_rows(port_read(port, filter=PE.col("p") == PE.lit("v")),
                         [r for r in want if r["p"] == "v"])


def test_mapped_table_with_deletion_vectors_protocol(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    _write("port", port, [_arrow(0, 10)], {**NAME, **DV})
    _write("ref", ref, [_arrow(0, 10)], {**NAME, **DV})
    assert _commit(port, 0)["protocol"] == _commit(ref, 0)["protocol"] == [{
        "minReaderVersion": 3, "minWriterVersion": 7,
        "readerFeatures": ["columnMapping", "deletionVectors"],
        "writerFeatures": ["columnMapping", "deletionVectors"]}]


def test_names_that_need_mapping(tmp_path):
    """A column name with ' ,;{}()\\n\\t=' is refused without mapping and
    written under mapping, as in the reference."""
    tbl = pa.table({"a b": pa.array([1, 2]), "c,d": pa.array(["x", "y"])})
    with pytest.raises(DeltaError) as e:
        pta.write_table(str(tmp_path / "no"), to_port(tbl), engine=CPU)
    assert e.value.error_class == "DELTA_INVALID_CHARACTERS_IN_COLUMN_NAME"
    port = str(tmp_path / "port")
    pta.write_table(port, to_port(tbl), engine=CPU, properties=NAME)
    assert_physical(port)
    assert same_rows(port_read(port), tbl.to_pylist())
    assert same_rows(ref_read(port), tbl.to_pylist())
    got = port_read(port, filter=PE.col("a b") > PE.lit(1))
    assert same_rows(got, tbl.to_pylist()[1:])


# ------------------------------------------- both packages, both ways --

def _build(pkg: str, path: str, case: str) -> None:
    """The same table history in either package."""
    A = ref_alter if pkg == "ref" else port_alter
    T = (lambda p: RefTable.for_path(p, engine=HostEngine())) \
        if pkg == "ref" else (lambda p: Table.for_path(p, engine=CPU))
    Field = RefField if pkg == "ref" else StructField
    typ = PrimitiveType if pkg == "ref" else str
    nested = case in ("nested", "nested_alter")
    part = case in ("partitioned", "renamed")
    props = dict(NAME)
    if case in ("dv", "checkpoint"):
        props.update(DV)
    if case == "checkpoint":
        props["delta.checkpoint.writeStatsAsStruct"] = "true"
    _write(pkg, path, [_arrow(0, 60, nested, part)], props,
           ["p"] if part else None)
    if case == "renamed":
        A.rename_column(T(path), "name", "label")
        A.rename_column(T(path), "p", "part")
    elif case == "dropped":
        A.drop_column(T(path), "v")
    elif case == "added":
        A.add_columns(T(path), [Field("w", typ("double"))])
    elif case == "nested_alter":
        A.drop_column(T(path), "s.b")
        A.add_columns(T(path), [Field("s.c", typ("string"))])
    second = _arrow(60, 30, nested, part)
    if case == "renamed":
        second = second.rename_columns(
            [{"name": "label", "p": "part"}.get(c, c)
             for c in second.column_names])
    elif case == "dropped":
        second = second.drop_columns(["v"])
    elif case == "nested_alter":
        s = pa.array([None if r is None else {"a": r["a"], "c": r["b"]}
                      for r in second.column("s").to_pylist()],
                     pa.struct([("a", pa.int64()), ("c", pa.string())]))
        second = second.set_column(second.column_names.index("s"), "s", s)
    _write(pkg, path, [second])
    if case in ("dv", "checkpoint"):
        D = ref_dml if pkg == "ref" else port_dml
        E = RE if pkg == "ref" else PE
        D.delete(T(path), E.col("id") < E.lit(7))
    if case == "checkpoint":
        T(path).checkpoint()


CASES = ["fresh", "partitioned", "nested", "renamed", "dropped", "added",
         "nested_alter", "dv", "checkpoint"]


@pytest.mark.parametrize("case", CASES)
def test_port_reads_reference_tables(tmp_path, case):
    path = str(tmp_path / "t")
    _build("ref", path, case)
    want = ref_read(path)
    assert same_rows(port_read(path), want)
    assert _names(path, "port") == _names(path, "ref")
    f = (PE.col("id") > PE.lit(40)) & (PE.col("id") < PE.lit(70))
    rf = (RE.col("id") > RE.lit(40)) & (RE.col("id") < RE.lit(70))
    assert same_rows(port_read(path, filter=f), ref_read(path, filter=rf))


@pytest.mark.parametrize("case", CASES)
def test_reference_reads_port_tables(tmp_path, case):
    path, twin = str(tmp_path / "t"), str(tmp_path / "ref")
    _build("port", path, case)
    _build("ref", twin, case)
    got = _held_cross(path, case in ("nested", "nested_alter"))
    # the port's history reads as the reference's own history does
    assert same_rows(got, ref_read(twin))
    assert_physical(path)


# --------------------------------------------- skipping and pruning --

def _counted(fn):
    obs.reset()
    out = fn()
    return out, obs.counters()


def test_skipping_through_a_renamed_column(tmp_path):
    path = str(tmp_path / "t")
    _write("port", path, [_arrow(0, 400)], NAME, rows_per_file=50)
    table = Table.for_path(path, engine=CPU)

    def plan(t, column, op_value):
        scan = t.latest_snapshot().scan(filter=PE.Comparison(
            op_value[0], PE.col(column), PE.lit(op_value[1])))
        return sorted(scan.file_paths()), scan.skipped_by_stats

    before, c0 = _counted(lambda: plan(table, "id", ("<", 120)))
    port_alter.rename_column(table, "id", "key")
    after, c1 = _counted(lambda: plan(table, "key", ("<", 120)))
    assert before == after and len(before[0]) == 3 and before[1] == 5
    for c in (c0, c1):
        assert c.get("scan.device_plans", 0) == 1
        assert c.get("scan.device_fallbacks", 0) == 0
    # the reference plans the port's renamed table to the same files
    clear_parse_cache()
    ref_scan = RefTable.for_path(path, engine=HostEngine()) \
        .latest_snapshot().scan(filter=RE.col("key") < RE.lit(120))
    assert sorted(ref_scan.add_files_table().column("path").to_pylist()) \
        == after[0]
    # a string conjunct walks the ladder on the physical keys
    s_before, c2 = _counted(lambda: plan(table, "name", ("=", "n3")))
    assert c2.get("scan.device_fallbacks", 0) == 1
    port_alter.rename_column(table, "name", "label")
    s_after, _ = _counted(lambda: plan(table, "label", ("=", "n3")))
    assert s_before == s_after
    # an old name now names nothing: the scan refuses it (C18)
    with pytest.raises(NonExistentColumnError):
        plan(table, "id", ("<", 120))
    got = port_read(path, filter=PE.col("key") < PE.lit(120))
    assert sorted(r["key"] for r in got) == list(range(120))


def test_partition_pruning_after_renaming_the_partition_column(tmp_path):
    path = str(tmp_path / "t")
    _write("port", path, [_arrow(0, 90, part=True)], NAME, ["p"])
    want = port_read(path, filter=PE.col("p") == PE.lit("u"))
    t = Table.for_path(path, engine=CPU)
    scan = t.latest_snapshot().scan(filter=PE.col("p") == PE.lit("u"))
    files, pruned = sorted(scan.file_paths()), scan.partition_pruned
    port_alter.rename_column(t, "p", "part")
    scan = t.latest_snapshot().scan(filter=PE.col("part") == PE.lit("u"))
    assert sorted(scan.file_paths()) == files and \
        scan.partition_pruned == pruned == 3
    got = port_read(path, filter=PE.col("part") == PE.lit("u"))
    assert same_rows([{("part" if k == "p" else k): v for k, v in r.items()}
                      for r in want], got) and len(got) == 27
    assert same_rows(ref_read(path, filter=RE.col("part") == RE.lit("u")),
                     got)
    assert Table.for_path(path, engine=CPU).latest_snapshot() \
        .partition_columns == ["part"]


def test_conflict_check_reads_physical_partition_keys(tmp_path):
    """A Serializable transaction that read partition u conflicts with a
    concurrent append into u (the winner's partitionValues are physical
    keys), and not with one that added no file to partition zz."""
    path = str(tmp_path / "t")
    _write("port", path, [_arrow(0, 30, part=True)], NAME, ["p"])
    t = Table.for_path(path, engine=CPU)
    txn = t.create_transaction_builder("DELETE").build()
    txn.isolation = IsolationLevel.SERIALIZABLE
    txn.scan_files(filter=PE.col("p") == PE.lit("u"))
    _write("port", path, [_arrow(100, 3, part=True)])
    with pytest.raises(ConcurrentAppendError):
        txn.commit()
    txn = Table.for_path(path, engine=CPU).create_transaction_builder(
        "DELETE").build()
    txn.isolation = IsolationLevel.SERIALIZABLE
    txn.scan_files(filter=PE.col("p") == PE.lit("zz"))
    _write("port", path, [_arrow(200, 3, part=True)])
    txn.commit()  # no appended file lies in partition zz


# ------------------------------------ DML, MERGE, OPTIMIZE on copies --

def _copies(tmp_path, props, nested=False):
    src = str(tmp_path / "src")
    _write("ref", src, [_arrow(0, 50, nested), _arrow(50, 50, nested),
                        _arrow(100, 50, nested)], props)
    ref_alter.rename_column(RefTable.for_path(src, engine=HostEngine()),
                            "v", "val")
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port


def _source(E):
    ids = np.array([5, 60, 149, 500, 501], np.int64)
    return ids, {"id": ids, "name": np.array(["m"] * 5, object),
                 "val": np.array([1.5, 2.5, 3.5, 4.5, 5.5])}


def _op(name, pkg, path):
    E = RE if pkg == "ref" else PE
    t = RefTable.for_path(path, engine=HostEngine()) if pkg == "ref" \
        else Table.for_path(path, engine=CPU)
    D = ref_dml if pkg == "ref" else port_dml
    if name in ("delete", "delete_dv"):
        return D.delete(t, (E.col("val") > E.lit(0.5))
                        | (E.col("id") < E.lit(20)))
    if name == "update":
        return D.update(t, {"val": E.lit(-1.0), "name": E.lit("u")},
                        (E.col("val") < E.lit(-1.0))
                        & (E.col("id") >= E.lit(30)))
    if name == "merge":
        ids, cols = _source(E)
        src = pa.table(cols) if pkg == "ref" else cols
        M = ref_merge if pkg == "ref" else port_merge
        return (M.merge(t, src, on=E.col("target.id") == E.col("source.id"))
                .when_matched_update(set={"val": E.col("source.val")})
                .when_not_matched_insert_all().execute())
    return t.optimize().execute_zorder_by("val", "id")


@pytest.mark.parametrize("name", ["delete", "delete_dv", "update", "merge",
                                  "zorder"])
def test_commands_on_a_reference_mapped_table(tmp_path, name):
    props = {**NAME, **(DV if name == "delete_dv" else {})}
    ref, port = _copies(tmp_path, props)
    _op(name, "ref", ref)
    _op(name, "port", port)
    rows = ref_read(ref)
    assert same_rows(ref_read(port), rows)
    assert same_rows(port_read(ref), rows)
    assert same_rows(port_read(port), rows)
    rc, pc = _commit(ref, _version(ref)), _commit(port, _version(port))
    ri, pi = rc["commitInfo"][0], pc["commitInfo"][0]
    assert ri["operation"] == pi["operation"]
    assert ri["operationParameters"] == pi["operationParameters"]
    assert len(rc.get("add", [])) == len(pc.get("add", []))
    assert len(rc.get("remove", [])) == len(pc.get("remove", []))
    if name == "delete_dv":
        assert all(a.get("deletionVector") for a in pc["add"])
    # the port's new files are physical; a copy-on-write keeps old rows
    # under the current physical names
    if pc.get("add") and name != "delete_dv":
        assert_physical(port)


def test_zorder_by_a_renamed_column_orders_by_it(tmp_path):
    ref, port = _copies(tmp_path, NAME)
    m = Table.for_path(port, engine=CPU).optimize().execute_zorder_by("val")
    assert m.num_files_added == 1
    vals = [r["val"] for r in port_rows(pta.read_table(port, engine=CPU))]
    present = [v for v in vals if v is not None]
    assert present == sorted(present)


def test_merge_schema_evolution_stays_refused(tmp_path):
    """Since MERGE's schema evolution was ported, it runs on a name-mode
    table as the reference's: the new column gets an id and a `col-`
    physical name in both, and each package reads both copies
    (`tests/test_torch_type_widening.py` holds the full comparison)."""
    ref, port = _copies(tmp_path, NAME)
    src = pa.table({"id": pa.array([1, 500]), "extra": pa.array([2, 3])})
    for merge, T, E, s in (
            (ref_merge.merge, RefTable.for_path(ref, engine=HostEngine()),
             RE, src),
            (port_merge.merge, Table.for_path(port, engine=CPU), PE,
             to_port(src))):
        (merge(T, s, on=E.col("target.id") == E.col("source.id"))
         .with_schema_evolution().when_not_matched_insert_all().execute())
    field = _schema(port)["extra"]
    assert field.physical_name.startswith("col-")
    assert field.physical_name in _physical_names(_schema(port))
    rows = ref_read(ref)
    assert [r["extra"] for r in rows if r["id"] == 500] == [3]
    for got in (port_read(ref), port_read(port), ref_read(port)):
        assert same_rows(got, rows)


# ------------------------------------------ C15: the mode upgrade --

def _file_facts(path: str) -> dict:
    out = {}
    for root, _, names in os.walk(path):
        for n in names:
            if n.endswith(".parquet") and "_delta_log" not in root:
                p = os.path.join(root, n)
                with open(p, "rb") as f:
                    out[p] = (f.read(), os.stat(p).st_mtime_ns)
    return out


@pytest.mark.parametrize("props", [None, DV], ids=["plain", "dv"])
def test_mode_upgrade_keeps_the_files_names(tmp_path, props):
    """C15: turning mapping on keeps each existing column's name as its
    physical name; renaming a data and a partition column then reads the
    old files through the new names, equal to a numpy model. No data file
    changes. The reference reads the port's table to the model; its own
    upgrade loses the renamed columns (`_REFERENCE_LOSES_RENAMED`)."""
    src = str(tmp_path / "src")
    tables = [_arrow(0, 40, part=True), _arrow(40, 20, part=True)]
    _write("ref", src, tables, props, ["p"])
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    shutil.copytree(src, port)
    shutil.copytree(src, ref)
    model = [r for t in tables for r in t.to_pylist()]
    facts = _file_facts(port)
    t = Table.for_path(port, engine=CPU)
    v = port_alter.set_properties(t, {"delta.columnMapping.mode": "name"})
    assert _file_facts(port) == facts
    schema = _schema(port)
    assert [(f.name, f.physical_name, f.column_mapping_id)
            for f in schema.fields] == [("id", "id", 1), ("name", "name", 2),
                                        ("v", "v", 3), ("p", "p", 4)]
    assert _commit(port, v)["metaData"][0]["configuration"][
        "delta.columnMapping.maxColumnId"] == "4"
    port_alter.rename_column(t, "name", "label")
    port_alter.rename_column(t, "p", "part")
    assert _file_facts(port) == facts
    renamed = {"name": "label", "p": "part"}
    model = [{renamed.get(k, k): x for k, x in r.items()} for r in model]
    assert same_rows(port_read(port), model)
    assert same_rows(ref_read(port), model)
    # an append after the renames, then both read on
    _write("port", port, [_arrow(60, 6, part=True).rename_columns(
        ["id", "label", "v", "part"])])
    model += [{renamed.get(k, k): x for k, x in r.items()}
              for r in _arrow(60, 6, part=True).to_pylist()]
    assert same_rows(port_read(port), model)
    assert same_rows(ref_read(port), model)
    # the protocol: (2, 5) from (1, 2); from (3, 7) columnMapping listed
    # for readers too, which the reference's upgrade leaves out
    rt = RefTable.for_path(ref, engine=HostEngine())
    ref_alter.set_properties(rt, {"delta.columnMapping.mode": "name"})
    pp = _commit(port, v)["protocol"][0]
    rp = _commit(ref, v)["protocol"][0]
    if props is None:
        assert pp == rp == {"minReaderVersion": 2, "minWriterVersion": 5}
    else:
        assert pp["readerFeatures"] == ["columnMapping", "deletionVectors"]
        assert _REFERENCE_OMITS_READER_FEATURE == (
            rp["readerFeatures"] == ["deletionVectors"])
        assert pp["writerFeatures"] == rp["writerFeatures"]
    ref_alter.rename_column(RefTable.for_path(ref, engine=HostEngine()),
                            "name", "label")
    ref_alter.rename_column(RefTable.for_path(ref, engine=HostEngine()),
                            "p", "part")
    lost = ref_read(ref)
    assert _REFERENCE_LOSES_RENAMED == (
        all(r["label"] is None and r["part"] is None for r in lost))


# ------------------------------------------------ ALTER's commits --

def _alter_cases():
    F = {"ref": (RefField, PrimitiveType, RefStruct),
         "port": (StructField, str, StructType)}

    def add_top(A, t, pkg):
        Fd, Ty, _ = F[pkg]
        return A.add_columns(t, [Fd("w", Ty("double")),
                                 Fd("z", Ty("string"))])

    def add_nested(A, t, pkg):
        Fd, Ty, St = F[pkg]
        return A.add_columns(t, [Fd("s.c", Ty("long")),
                                 Fd("t", St([Fd("x", Ty("integer"))]))])

    return {
        "add_columns": add_top,
        "add_nested": add_nested,
        "rename": lambda A, t, pkg: A.rename_column(t, "name", "label"),
        "rename_partition": lambda A, t, pkg: A.rename_column(t, "p", "q"),
        "drop": lambda A, t, pkg: A.drop_column(t, "v"),
        "drop_nested": lambda A, t, pkg: A.drop_column(t, "s.b"),
        "set_append_only": lambda A, t, pkg: A.set_properties(
            t, {"delta.appendOnly": "true", "custom.key": "x"}),
        "set_dv": lambda A, t, pkg: A.set_properties(t, DV),
        "unset": lambda A, t, pkg: A.unset_properties(
            t, ["custom.a", "custom.missing"], if_exists=True),
        "upgrade_writer": lambda A, t, pkg: A.upgrade_protocol(
            t, min_writer=5),
        "upgrade_feature": lambda A, t, pkg: A.upgrade_protocol(
            t, feature="deletionVectors"),
        "upgrade_none": lambda A, t, pkg: A.upgrade_protocol(
            t, min_reader=1),
    }


ALTER = _alter_cases()


@pytest.mark.parametrize("op", list(ALTER))
def test_alter_commits_equal_the_references(tmp_path, op):
    src = str(tmp_path / "src")
    _write("ref", src, [_arrow(0, 30, nested=True, part=True)],
           {**NAME, "custom.a": "1"}, ["p"])
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    rv = ALTER[op](ref_alter, RefTable.for_path(ref, engine=HostEngine()),
                   "ref")
    pv = ALTER[op](port_alter, Table.for_path(port, engine=CPU), "port")
    assert rv == pv
    if op == "upgrade_none":
        assert rv == 0 and _version(port) == 0
        return
    rc, pc = _commit(ref, rv), _commit(port, pv)
    for k in ("operation", "operationParameters", "isolationLevel",
              "isBlindAppend", "readVersion"):
        assert rc["commitInfo"][0].get(k) == pc["commitInfo"][0].get(k), k
    assert rc.get("protocol") == pc.get("protocol")
    assert set(rc) == set(pc)
    if "metaData" in rc:
        rm, pm = rc["metaData"][0], pc["metaData"][0]
        assert _masked(rm["schemaString"]) == _masked(pm["schemaString"])
        for k in ("configuration", "partitionColumns", "id"):
            assert rm[k] == pm[k], k
    rows = ref_read(ref)
    assert same_rows(port_read(ref), rows)
    assert same_rows(port_read(port), rows)
    # the reference reads the port's commit over its own files
    assert same_rows(ref_read(port), rows)


def _errors():
    cm = lambda A, t, pkg: A.set_properties(  # noqa: E731
        t, {"delta.columnMapping.mode": "id"})
    return {
        "rename_unmapped": (None, lambda A, t, pkg: A.rename_column(
            t, "name", "x"), "DELTA_UNSUPPORTED_RENAME_COLUMN"),
        "drop_unmapped": (None, lambda A, t, pkg: A.drop_column(t, "v"),
                          "DELTA_UNSUPPORTED_DROP_COLUMN"),
        "drop_partition": (NAME, lambda A, t, pkg: A.drop_column(t, "p"),
                           "DELTA_UNSUPPORTED_DROP_PARTITION_COLUMN"),
        "rename_to_existing": (NAME, lambda A, t, pkg: A.rename_column(
            t, "name", "v"), "DELTA_DUPLICATE_COLUMNS_FOUND"),
        "rename_missing": (NAME, lambda A, t, pkg: A.rename_column(
            t, "nope", "x"), "DELTA_COLUMN_NOT_FOUND"),
        "drop_missing": (NAME, lambda A, t, pkg: A.drop_column(t, "nope"),
                         "DELTA_COLUMN_NOT_FOUND"),
        "drop_in_non_struct": (NAME, lambda A, t, pkg: A.drop_column(
            t, "id.x"),
            "DELTA_UNSUPPORTED_DROP_NESTED_COLUMN_FROM_NON_STRUCT_TYPE"),
        "add_not_nullable": (NAME, lambda A, t, pkg: A.add_columns(t, [
            (RefField if pkg == "ref" else StructField)(
                "w", PrimitiveType("long") if pkg == "ref" else "long",
                False)]), "DELTA_ADD_COLUMN_NOT_NULLABLE"),
        "add_existing": (NAME, lambda A, t, pkg: A.add_columns(t, [
            (RefField if pkg == "ref" else StructField)(
                "v", PrimitiveType("long") if pkg == "ref" else "long")]),
            "DELTA_SCHEMA_MISMATCH"),
        "add_no_parent": (NAME, lambda A, t, pkg: A.add_columns(t, [
            (RefField if pkg == "ref" else StructField)(
                "q.w", PrimitiveType("long") if pkg == "ref" else "long")]),
            "DELTA_ADD_COLUMN_STRUCT_NOT_FOUND"),
        "add_parent_not_struct": (NAME, lambda A, t, pkg: A.add_columns(t, [
            (RefField if pkg == "ref" else StructField)(
                "id.w", PrimitiveType("long") if pkg == "ref" else "long")]),
            "DELTA_ADD_COLUMN_PARENT_NOT_STRUCT"),
        "mode_name_to_id": (NAME, cm,
                            "DELTA_UNSUPPORTED_COLUMN_MAPPING_MODE_CHANGE"),
        "mode_to_none": (NAME, lambda A, t, pkg: A.set_properties(
            t, {"delta.columnMapping.mode": "none"}),
            "DELTA_UNSUPPORTED_COLUMN_MAPPING_MODE_CHANGE"),
        "mode_unknown": (None, lambda A, t, pkg: A.set_properties(
            t, {"delta.columnMapping.mode": "names"}),
            "DELTA_UNSUPPORTED_COLUMN_MAPPING_MODE_CHANGE"),
        "unset_missing": (NAME, lambda A, t, pkg: A.unset_properties(
            t, ["custom.missing"]), "DELTA_UNSET_NON_EXISTENT_PROPERTY"),
        "unknown_feature": (NAME, lambda A, t, pkg: A.upgrade_protocol(
            t, feature="noSuchFeature"),
            "DELTA_UNSUPPORTED_FEATURES_IN_CONFIG"),
        "bad_boolean": (NAME, lambda A, t, pkg: A.set_properties(
            t, {"delta.appendOnly": "yes"}),
            "DELTA_VIOLATE_TABLE_PROPERTY_VALIDATION_FAILED"),
    }


ERRORS = _errors()


@pytest.mark.parametrize("case", list(ERRORS))
def test_alter_refusals_equal_the_references(tmp_path, case):
    props, fn, error_class = ERRORS[case]
    src = str(tmp_path / "src")
    _write("ref", src, [_arrow(0, 20, part=True)], props, ["p"])
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    with pytest.raises(Exception) as r:
        fn(ref_alter, RefTable.for_path(ref, engine=HostEngine()), "ref")
    with pytest.raises(DeltaError) as p:
        fn(port_alter, Table.for_path(port, engine=CPU), "port")
    assert r.value.error_class == p.value.error_class == error_class
    assert _version(port) == 0


def test_drop_the_last_column(tmp_path):
    path = str(tmp_path / "t")
    _write("port", path, [pa.table({"id": pa.array([1, 2])})], NAME)
    with pytest.raises(DeltaError) as e:
        port_alter.drop_column(Table.for_path(path, engine=CPU), "id")
    assert e.value.error_class == "DELTA_DROP_COLUMN_ON_SINGLE_FIELD_SCHEMA"


@pytest.mark.parametrize("what", ["rename", "drop"])
@pytest.mark.parametrize("kind", ["constraint", "generated"])
def test_dependent_columns_refused(tmp_path, what, kind):
    """A CHECK constraint or a generated column that references a column
    (or a field under it) keeps it from being renamed or dropped."""
    src = str(tmp_path / "src")
    _write("ref", src, [_arrow(0, 20, nested=True)], NAME)
    rt = RefTable.for_path(src, engine=HostEngine())
    if kind == "constraint":
        add_constraint(rt, "pos", "v IS NULL OR v > -100.0")
        column = "v"
    else:
        log = os.path.join(src, "_delta_log")
        meta = _commit(src, 0)["metaData"][0]
        schema = json.loads(meta["schemaString"])
        schema["fields"][1]["metadata"][
            "delta.generationExpression"] = "s.a IS NULL"
        meta["schemaString"] = json.dumps(schema)
        with open(os.path.join(log, f"{1:020d}.json"), "w") as f:
            f.write(json.dumps({"metaData": meta}) + "\n")
        column = "s"
    want = ("DELTA_CONSTRAINT_DEPENDENT_COLUMN_CHANGE" if kind == "constraint"
            else "DELTA_GENERATED_COLUMNS_DEPENDENT_COLUMN_CHANGE")
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    for A, t in ((ref_alter, RefTable.for_path(ref, engine=HostEngine())),
                 (port_alter, Table.for_path(port, engine=CPU))):
        with pytest.raises(Exception) as e:
            if what == "rename":
                A.rename_column(t, column, "x")
            else:
                A.drop_column(t, column)
        assert e.value.error_class == want
    # nothing was committed; a column nothing references renames as in
    # the reference (the constraint and generated-column features are
    # written since they were ported, so such a table is writable)
    assert _version(port) == 1
    rv = ref_alter.rename_column(RefTable.for_path(ref, engine=HostEngine()),
                                 "id", "key")
    pv = port_alter.rename_column(Table.for_path(port, engine=CPU), "id",
                                  "key")
    assert rv == pv == 2
    rows = port_read(ref)
    assert "key" in rows[0] and same_rows(port_read(port), rows)


def test_refused_alter_operations(tmp_path):
    """Refused, typed: a type change that does not widen (since type
    widening was ported: `tests/test_torch_type_widening.py`); a property
    that turns on a feature the write path does not write (row tracking);
    dropping the mode. A CHECK constraint set as a property is written
    since constraints were ported, and the change data feed since it was
    ported: its protocol upgrade equals the reference's."""
    path = str(tmp_path / "t")
    _write("port", path, [_arrow(0, 10)], NAME)
    t = Table.for_path(path, engine=CPU)
    with pytest.raises(SchemaEvolutionError) as e:
        port_alter.change_column_type(t, "id", "double")
    assert e.value.error_class == "DELTA_CANNOT_CHANGE_DATA_TYPE"
    with pytest.raises(UnsupportedTableError):
        port_alter.set_properties(t, {"delta.enableRowTracking": "true"})
    with pytest.raises(ColumnMappingModeChangeError):
        port_alter.unset_properties(t, ["delta.columnMapping.mode"])
    # a protocol upgrade to a feature the writer lacks fails at commit
    with pytest.raises(UnsupportedTableError):
        port_alter.upgrade_protocol(t, feature="rowTracking")
    assert _version(path) == 0
    assert port_alter.set_properties(t, {"delta.constraints.c": "id > 0"}) \
        == 1
    cdf = {"delta.enableChangeDataFeed": "true"}
    ref = str(tmp_path / "ref")
    _write("ref", ref, [_arrow(0, 10)], NAME)
    ref_alter.set_properties(RefTable.for_path(ref, engine=HostEngine()),
                             cdf)
    assert port_alter.set_properties(t, cdf) == 2
    clear_parse_cache()
    protocols = [RefTable.for_path(p, engine=HostEngine()).latest_snapshot()
                 .protocol.to_dict() for p in (ref, path)]
    assert protocols[0] == protocols[1]
    assert Table.for_path(path, engine=CPU).latest_snapshot().metadata \
        .configuration["delta.enableChangeDataFeed"] == "true"
    # an upgrade to writer 5 on an unmapped table stays writable
    plain = str(tmp_path / "plain")
    _write("port", plain, [_arrow(0, 10)])
    port_alter.upgrade_protocol(Table.for_path(plain, engine=CPU),
                                min_writer=5)
    _write("port", plain, [_arrow(10, 10)])
    assert len(port_read(plain)) == 20


# --------------------------------------- handoff, checkpoint reload --

def test_commit_handoff_carries_the_rename(tmp_path):
    path = str(tmp_path / "t")
    _write("port", path, [_arrow(0, 200)], NAME, rows_per_file=50)
    t = Table.for_path(path, engine=CPU)
    t.latest_snapshot().scan(filter=PE.col("id") < PE.lit(10)).file_paths()
    obs.reset()
    port_alter.rename_column(t, "id", "key")
    port_alter.add_columns(t, [StructField("w", "double")])
    snap = t.latest_snapshot()
    files = snap.scan(filter=PE.col("key") < PE.lit(10)).file_paths()
    batch = snap.scan(filter=PE.col("key") < PE.lit(10)).to_batch()
    c = obs.counters()
    assert c.get("table.notify_advances", 0) == 2
    assert c.get("log.commit_reads", 0) == 0
    assert c.get("scan.device_plans", 0) == 2
    assert len(files) == 1 and batch.column_names == ["key", "name", "v",
                                                      "w"]
    assert sorted(batch.column("key").values.tolist()) == list(range(10))
    assert snap.version == 2 and snap.schema.field_names() == [
        "key", "name", "v", "w"]


def _leaf_names(t) -> list:
    out = []
    for i in range(t.num_fields):
        f = t.field(i)
        out.append(f.name)
        if pa.types.is_struct(f.type):
            out += _leaf_names(f.type)
    return out


@pytest.mark.parametrize("json_stats", [True, False],
                         ids=["json_and_struct", "struct_only"])
def test_checkpoint_stats_parsed_is_physical(tmp_path, json_stats):
    """The checkpoint's stats_parsed carries the physical names at every
    depth; a reload (through stats_parsed alone when the JSON stats are
    off) plans every filter to the files the JSON stats gave."""
    path = str(tmp_path / "t")
    props = {**NAME, **DV, "delta.checkpoint.writeStatsAsStruct": "true",
             "delta.checkpoint.writeStatsAsJson": str(json_stats).lower()}
    tables = [_arrow(i * 50, 50, nested=True, part=True) for i in range(3)]
    _write("port", path, tables, props, ["p"], rows_per_file=20)
    port_alter.rename_column(Table.for_path(path, engine=CPU), "v", "val")
    port_dml.delete(Table.for_path(path, engine=CPU),
                    PE.col("id") < PE.lit(12))
    filters = [PE.col("id") < PE.lit(60), PE.col("val") > PE.lit(1.0),
               PE.col("s.a") > PE.lit(200),
               (PE.col("p") == PE.lit("v")) & (PE.col("id") > PE.lit(90))]
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    before = [sorted(snap.scan(filter=f).file_paths()) for f in filters]
    rows = port_read(path)
    write_checkpoint(CPU, Table.for_path(path, engine=CPU).latest_snapshot())
    cp = [n for n in os.listdir(os.path.join(path, "_delta_log"))
          if ".checkpoint." in n]
    part = pq.read_table(os.path.join(path, "_delta_log", cp[0]))
    sp = part.schema.field("add").type
    sp = sp.field(sp.get_field_index("stats_parsed")).type
    phys = _physical_names(_schema(path))
    for key in ("minValues", "maxValues", "nullCount"):
        names = _leaf_names(sp.field(sp.get_field_index(key)).type)
        assert names and set(names) <= phys
    obs.reset()
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    after = [sorted(snap.scan(filter=f).file_paths()) for f in filters]
    assert after == before
    assert obs.counters().get("scan.device_plans", 0) >= 3
    assert same_rows(port_read(path), rows)
    assert same_rows(ref_read(path), _nested_nulled(rows))


def test_chip_column_mapping_phase_passes_on_the_cpu():
    """`chip_smoke.py`'s step 21 with the plain versions, on step 20's
    table at two links of each store_sales file: every step's rows held to
    step 20's numpy model inside the phase."""
    import chip_smoke
    from test_torch_wide_types import FIXTURES, quarter

    assert chip_smoke.CM_FIRST_QUARTER == quarter(0)
    keep, kept = {}, {}
    chip_smoke.wide_types_phase(FIXTURES, "cpu", "cpu", links=2, keep=keep)
    chip_smoke.wide_write_phase(keep["all"], keep["nested"], FIXTURES,
                                "cpu", "cpu", links=2, keep=kept)
    try:
        out = chip_smoke.column_mapping_phase(kept, "cpu", "cpu")
    finally:
        shutil.rmtree(kept["work"], ignore_errors=True)
    steps = out["steps"]
    assert list(steps) == [
        "set_mode", "reload", "rename", "drop", "add", "read_profit",
        "delete", "update", "merge", "optimize_zorder", "checkpoint",
        "append", "checkpoint_reload", "read_profit_after", "read_all",
        "fresh_write", "fresh_read_range", "fresh_rename",
        "fresh_read_renamed"]
    assert steps["delete"]["dvs"] > 0
    assert steps["read_profit"]["files_kept"] > 0
    assert out["fresh"]["pruned"] > 0 and out["fresh"]["files"] == \
        out["fresh"]["dates"] + 1

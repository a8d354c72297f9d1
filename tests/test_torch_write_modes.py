"""Write modes and name resolution: the port against the JAX package.

Every comparison exact (rows as multisets of Python values, compared by
`repr`). Each write option runs on two copies of one reference-written
table (unpartitioned and partitioned by a string column with nulls,
unmapped and in column-mapping mode `name`, with and without deletion
vectors where a delete is involved), once per package:

- static overwrite, `overwrite_schema` (repartitioned too), `merge_schema`
  (a top-level and a nested field), `replace_where` on the partition
  column and on a data column (and on a table with the change data feed,
  its feed too), dynamic partition overwrite (the null partition
  included), `ignore` and `data_change=False`;
- the commits agree: operation, `operationParameters`,
  `operationMetrics` (byte counts aside), `isBlindAppend`, protocol,
  metadata (physical names masked), and every add and remove by its
  path (a file the command wrote counts as new), `dataChange`, partition
  values, row count and DV cardinality;
- the rows agree both ways: the port reads the reference's table and the
  reference reads the port's, each to the reference's own read.

The argument checks raise the reference's error classes and commit
nothing; `schema_evolution.merge_types` equals the reference's over type
pairs, with and without widening.

Name resolution (ROADMAP C18): a filter or a projection that names a
column the table lacks raises `NonExistentColumnError` from every path
of the port. The reference keeps every row for such a filter
(`_REFERENCE_KEEPS_UNKNOWN_FILTER`).

The reference's caveat under column mapping (ROADMAP C19) is held apart
by `_REFERENCE_LEAVES_NEW_FIELDS_UNMAPPED`: its `merge_schema` and
`overwrite_schema` give new fields no id and no physical name, so its
writer names them logically; the port maps them, as Delta does. Its
nested fields are named logically too (C16, `_REFERENCE_NULLS_NESTED`).
"""

import json
import os
import re
import shutil
from urllib.parse import unquote

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.merge as ref_merge
import delta_tpu.commands.optimize as ref_opt  # noqa: F401 (Table.optimize)
import delta_tpu.expressions.tree as RE
import delta_tpu.models.schema as ref_schema
import delta_tpu.schema_evolution as ref_se
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefError
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.api as pta
import delta_tpu_torch.commands.dml as port_dml
import delta_tpu_torch.commands.merge as port_merge
import delta_tpu_torch.expressions.tree as PE
import delta_tpu_torch.schema_evolution as port_se
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.errors import (
    DeltaError,
    NonExistentColumnError,
    UnresolvedColumnError,
)
from delta_tpu_torch.models.schema import (
    ArrayType,
    MapType,
    StructField,
    StructType,
)
from test_torch_cdf import port_changes_of, ref_changes_of
from test_torch_wide_types import port_rows, same_rows
from test_torch_wide_write import to_port

CPU = TorchEngine("cpu")
NAME = {"delta.columnMapping.mode": "name"}
DV = {"delta.enableDeletionVectors": "true"}
STRUCT = pa.struct([("a", pa.int64()), ("b", pa.string())])
STRUCT_WIDER = pa.struct([("a", pa.int64()), ("b", pa.string()),
                          ("c", pa.float64())])

# the reference keeps every row for a filter on a column the table lacks
# (ROADMAP C18), and its DML raises a bare KeyError there
_REFERENCE_KEEPS_UNKNOWN_FILTER = True
# its merge_schema and overwrite_schema leave new fields unmapped (C19)
_REFERENCE_LEAVES_NEW_FIELDS_UNMAPPED = True
# it names nested fields logically and reads the port's physical ones as
# null (C16)
_REFERENCE_NULLS_NESTED = True

# (partitioned, mapped)
KINDS = {"plain": (False, False), "partitioned": (True, False),
         "mapped": (False, True), "mapped_partitioned": (True, True)}


# ------------------------------------------------------------ helpers --

def _arrow(ids, part=False, nested=False, wider=False, seed=0) -> pa.Table:
    ids = np.asarray(ids, dtype=np.int64)
    rng = np.random.default_rng(seed + int(ids[0]) if len(ids) else seed)
    cols = {"id": pa.array(ids),
            "name": pa.array([f"n{i % 23}" for i in ids],
                             mask=ids % 9 == 4),
            "v": pa.array(rng.normal(size=len(ids)).round(3),
                          mask=ids % 7 == 1)}
    if nested:
        cols["s"] = pa.array(
            [None if i % 11 == 3 else
             dict({"a": int(i) * 2, "b": None if i % 5 == 0 else f"x{i % 6}"},
                  **({"c": float(i) / 4} if wider else {}))
             for i in ids], STRUCT_WIDER if wider else STRUCT)
    if part:
        cols["p"] = pa.array([_part_of(i) for i in ids])
    return pa.table(cols)


def _part_of(i: int):
    return None if i % 13 == 6 else ["u", "v", "w"][i % 3]


def _base(tmp_path, kind: str, props=None, nested=False,
          appends=((0, 40), (40, 80), (80, 120))):
    """The reference writes one table of `appends` (id ranges); returns
    the paths of its two copies (ref, port) and the source's data files."""
    part, mapped = KINDS[kind]
    conf = dict(NAME if mapped else {}, **(props or {}))
    src = str(tmp_path / "src")
    for i, (lo, hi) in enumerate(appends):
        kw = {}
        if i == 0:
            kw = dict(partition_by=["p"] if part else None,
                      properties=conf or None)
        dta.write_table(src, _arrow(range(lo, hi), part, nested),
                        engine=HostEngine(), **kw)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port, _data_files(src)


def _data_files(path: str) -> set:
    out = set()
    for root, _, names in os.walk(path):
        if "_delta_log" not in root:
            out |= {os.path.relpath(os.path.join(root, n), path)
                    for n in names if n.endswith(".parquet")}
    return out


def _write_both(ref: str, port: str, tbl: pa.Table, **kw) -> tuple:
    """The same write by both packages; a `replace_where` is given as a
    function of the expression module."""
    rw = kw.pop("replace_where", None)
    rv = dta.write_table(ref, tbl, engine=HostEngine(), replace_where=(
        None if rw is None else rw(RE)), **kw)
    pv = pta.write_table(port, to_port(tbl), engine=CPU, replace_where=(
        None if rw is None else rw(PE)), **kw)
    return rv, pv


def ref_read(path: str, **kw) -> list:
    clear_parse_cache()
    return dta.read_table(path, engine=HostEngine(), **kw).to_pylist()


def port_read(path: str, **kw) -> list:
    return port_rows(pta.read_table(path, engine=CPU, **kw))


def _masked(text: str) -> str:
    return re.sub(r"col-[0-9a-f-]{36}", "col-*", text)


def _log(path: str, version: int) -> list:
    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _version(path: str) -> int:
    return max(int(n[:20]) for n in os.listdir(os.path.join(path,
                                                            "_delta_log"))
               if n.endswith(".json") and n[:20].isdigit())


def _files(actions: list, kind: str, src: set) -> list:
    out = []
    for a in actions:
        body = a.get(kind)
        if body is None:
            continue
        dv = body.get("deletionVector")
        stats = json.loads(body["stats"]) if body.get("stats") else {}
        path = unquote(body["path"])
        out.append((path if path in src else "<new>", body["dataChange"],
                    _masked(json.dumps(body.get("partitionValues"),
                                       sort_keys=True)),
                    stats.get("numRecords"),
                    dv["cardinality"] if dv else None))
    return sorted(out, key=repr)


def _summary(path: str, version: int, src: set) -> dict:
    """A commit without timestamps, paths of new files and uuids."""
    actions = _log(path, version)
    info = next(a["commitInfo"] for a in actions if "commitInfo" in a)
    out = {k: info.get(k) for k in ("operation", "operationParameters",
                                    "readVersion", "isolationLevel",
                                    "isBlindAppend")}
    out["metrics"] = {k: v for k, v in info["operationMetrics"].items()
                      if "Bytes" not in k}
    out["add"] = _files(actions, "add", src)
    out["remove"] = _files(actions, "remove", src)
    out["protocol"] = [a["protocol"] for a in actions if "protocol" in a]
    out["metaData"] = [(_masked(a["metaData"]["schemaString"]),
                        a["metaData"]["partitionColumns"],
                        a["metaData"]["configuration"])
                       for a in actions if "metaData" in a]
    return out


def _unmapped_meta(meta: list) -> list:
    """Metadata with every field's mapping keys and maxColumnId taken
    out (`_REFERENCE_LEAVES_NEW_FIELDS_UNMAPPED`)."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items()
                    if k not in ("delta.columnMapping.id",
                                 "delta.columnMapping.physicalName")}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return [(json.dumps(strip(json.loads(s))), pc,
             {k: v for k, v in conf.items()
              if k != "delta.columnMapping.maxColumnId"})
            for s, pc, conf in meta]


def _same_commit(ref: str, port: str, rv: int, pv: int, src: set,
                 mapped_schema_change: bool = False) -> dict:
    assert rv == pv
    r, p = _summary(ref, rv, src), _summary(port, pv, src)
    if mapped_schema_change and _REFERENCE_LEAVES_NEW_FIELDS_UNMAPPED:
        r["metaData"], p["metaData"] = (_unmapped_meta(r["metaData"]),
                                        _unmapped_meta(p["metaData"]))
        # the new fields' physical names key the port's partition values,
        # their logical names the reference's: compare the values
        for c in (r, p):
            for k in ("add", "remove"):
                c[k] = sorted((f[:2] + (json.dumps(sorted(
                    json.loads(f[2]).values(), key=repr)),) + f[3:]
                    for f in c[k]), key=repr)
    assert r == p
    return p


def _same_rows(ref: str, port: str, nested_mapped: bool = False) -> list:
    """Both packages read both copies to the reference's own read."""
    want = ref_read(ref)
    assert same_rows(port_read(ref), want)
    got = port_read(port)
    assert same_rows(got, want)
    cross = ref_read(port)
    if nested_mapped and _REFERENCE_NULLS_NESTED:
        want = [{k: ({f: None for f in v} if isinstance(v, dict) else v)
                 for k, v in r.items()} for r in want]
    assert same_rows(cross, want)
    return got


def _field_names_of_files(path: str) -> set:
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    out = set()
    for a in snap.state.add_files:
        out |= set(pq.read_schema(os.path.join(path, a.path)).names)
    return out


# ---------------------------------------------------- static overwrite --

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dv", [False, True])
def test_static_overwrite(tmp_path, kind, dv):
    ref, port, src = _base(tmp_path, kind, DV if dv else None)
    if dv:  # a file with a DV: its remove carries the DV
        ref_dml.delete(RefTable.for_path(ref, engine=HostEngine()),
                       RE.col("id") < RE.lit(10))
        port_dml.delete(Table.for_path(port, engine=CPU),
                        PE.col("id") < PE.lit(10))
    part = KINDS[kind][0]
    rv, pv = _write_both(ref, port, _arrow(range(1000, 1030), part),
                         mode="overwrite")
    c = _same_commit(ref, port, rv, pv, src)
    assert c["operation"] == "WRITE" and c["operationParameters"] == {}
    assert c["isBlindAppend"] is False
    assert len(c["remove"]) == len(Table.for_path(
        port, engine=CPU).snapshot_at(pv - 1).state.add_files)
    assert all(r[0] != "<new>" or dv for r in c["remove"])
    assert any(r[4] for r in c["remove"]) == dv
    rows = _same_rows(ref, port)
    assert sorted(r["id"] for r in rows) == list(range(1000, 1030))
    # tombstones retained for VACUUM
    tomb = {t.path for t in Table.for_path(port, engine=CPU)
            .latest_snapshot().state.tombstones}
    assert tomb >= {r[0] for r in c["remove"]}


def test_overwrite_advances_the_cached_snapshot(tmp_path):
    """The overwrite's commit (removes and adds, a new schema) reaches a
    Table's cached snapshot by the commit handoff, and equals a cold
    load."""
    from delta_tpu_torch import obs

    path = str(tmp_path / "t")
    pta.write_table(path, to_port(_arrow(range(50), True)), engine=CPU,
                    partition_by=["p"], properties=NAME)
    t = Table.for_path(path, engine=CPU)
    t.latest_snapshot().state
    new = {"b": np.array(["x", "y", "z"], object), "c": np.arange(3)}
    obs.reset()
    txn_version = pta.write_table(path, new, mode="overwrite",
                                  overwrite_schema=True, engine=CPU)
    # write_table's own Table took the commit by the handoff
    assert obs.counters().get("table.notify_advances", 0) == 1
    snap = t.update()
    assert snap.version == txn_version
    cold = Table.for_path(path, engine=CPU).latest_snapshot()
    assert snap.schema == cold.schema and snap.partition_columns == []
    assert [a.path for a in snap.state.add_files] == \
        [a.path for a in cold.state.add_files]
    assert port_rows(snap.scan().to_batch()) == port_rows(
        cold.scan().to_batch())


# ---------------------------------------------------- overwrite_schema --

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("repartition", [False, True])
def test_overwrite_schema(tmp_path, kind, repartition):
    ref, port, src = _base(tmp_path, kind)
    new = pa.table({"b": pa.array(["x", "y", None, "x"]),
                    "c": pa.array([1, 2, 3, 4], pa.int64()),
                    "q": pa.array(["k1", "k2", "k1", None])})
    rv, pv = _write_both(ref, port, new, mode="overwrite",
                         overwrite_schema=True,
                         partition_by=["q"] if repartition else None)
    mapped = KINDS[kind][1]
    c = _same_commit(ref, port, rv, pv, src, mapped_schema_change=mapped)
    snap = Table.for_path(port, engine=CPU).latest_snapshot()
    assert snap.schema.field_names() == ["b", "c", "q"]
    assert snap.partition_columns == (["q"] if repartition else [])
    assert len(c["metaData"]) == 1
    _same_rows(ref, port)
    if mapped:
        # fresh ids past the old ones, col- names in every new file
        old = Table.for_path(port, engine=CPU).snapshot_at(pv - 1)
        old_max = int(old.metadata.configuration[
            "delta.columnMapping.maxColumnId"])
        ids = [f.column_mapping_id for f in snap.schema.fields]
        assert ids == list(range(old_max + 1, old_max + 4))
        conf = snap.metadata.configuration
        assert int(conf["delta.columnMapping.maxColumnId"]) == max(ids)
        assert all(f.physical_name.startswith("col-")
                   for f in snap.schema.fields)
        assert all(n.startswith("col-") for n in
                   _field_names_of_files(port))
        if _REFERENCE_LEAVES_NEW_FIELDS_UNMAPPED:
            rs = RefTable.for_path(ref, engine=HostEngine()) \
                .latest_snapshot().schema
            assert all("delta.columnMapping.physicalName" not in f.metadata
                       for f in rs.fields)


def test_overwrite_schema_of_the_same_schema_keeps_the_metadata(tmp_path):
    ref, port, src = _base(tmp_path, "mapped")
    rv, pv = _write_both(ref, port, _arrow(range(500, 510)),
                         mode="overwrite", overwrite_schema=True)
    # the port keeps the mapped schema (no metadata action); the
    # reference replaces it by its unmapped form
    p = _summary(port, pv, src)
    assert p["metaData"] == []
    assert _same_rows(ref, port)
    assert Table.for_path(port, engine=CPU).latest_snapshot().schema == \
        Table.for_path(port, engine=CPU).snapshot_at(0).schema


# -------------------------------------------------------- merge_schema --

@pytest.mark.parametrize("kind", list(KINDS))
def test_merge_schema_top_level(tmp_path, kind):
    ref, port, src = _base(tmp_path, kind)
    part, mapped = KINDS[kind]
    new = _arrow(range(200, 220), part)
    new = new.append_column("extra", pa.array(
        [None if i % 4 == 0 else f"e{i}" for i in range(20)]))
    rv, pv = _write_both(ref, port, new, merge_schema=True)
    c = _same_commit(ref, port, rv, pv, src, mapped_schema_change=mapped)
    assert len(c["metaData"]) == 1 and c["isBlindAppend"] is True
    snap = Table.for_path(port, engine=CPU).latest_snapshot()
    assert snap.schema.field_names() == ["id", "name", "v"] + (
        ["p"] if part else []) + ["extra"]
    assert snap.schema["extra"].nullable
    rows = _same_rows(ref, port)
    assert sum(r["extra"] is None for r in rows) == 120 + 5
    if mapped:
        f = snap.schema["extra"]
        old = Table.for_path(port, engine=CPU).snapshot_at(pv - 1)
        old_max = int(old.metadata.configuration[
            "delta.columnMapping.maxColumnId"])
        assert f.physical_name.startswith("col-")
        assert f.column_mapping_id == old_max + 1
        assert snap.metadata.configuration[
            "delta.columnMapping.maxColumnId"] == str(old_max + 1)
        new_files = [a for a in snap.state.add_files if a.path not in src]
        assert all(f.physical_name in pq.read_schema(
            os.path.join(port, a.path)).names for a in new_files)


@pytest.mark.parametrize("kind", list(KINDS))
def test_merge_schema_nested(tmp_path, kind):
    ref, port, src = _base(tmp_path, kind, nested=True)
    part, mapped = KINDS[kind]
    rv, pv = _write_both(ref, port, _arrow(range(300, 330), part, True,
                                           wider=True), merge_schema=True)
    _same_commit(ref, port, rv, pv, src, mapped_schema_change=mapped)
    snap = Table.for_path(port, engine=CPU).latest_snapshot()
    s = snap.schema["s"].data_type
    assert s.field_names() == ["a", "b", "c"] and s["c"].nullable
    if mapped:
        assert s["c"].physical_name.startswith("col-")
    got = port_read(port)
    assert same_rows(got, port_read(ref))
    want = ref_read(ref)
    if not mapped:
        assert same_rows(got, want)
        assert same_rows(ref_read(port), want)
    # old rows read the new field as null
    olds = [r["s"] for r in got if r["id"] < 120 and r["s"] is not None]
    assert olds and all(v["c"] is None for v in olds)


def test_merge_schema_on_write(tmp_path):
    """The reference's `test_rowtracking_colgen.py::
    test_merge_schema_on_write`: without the flag a new column is a
    schema mismatch; with it the old rows read it as null."""
    ref, port, src = _base(tmp_path, "plain", appends=((0, 5),))
    new = _arrow(range(100, 105)).append_column("extra",
                                                pa.array(["e"] * 5))
    with pytest.raises(RefError) as r:
        dta.write_table(ref, new, engine=HostEngine())
    with pytest.raises(DeltaError) as p:
        pta.write_table(port, to_port(new), engine=CPU)
    assert r.value.error_class == p.value.error_class
    _write_both(ref, port, new, merge_schema=True)
    rows = _same_rows(ref, port)
    extras = [r["extra"] for r in rows]
    assert extras.count(None) == 5 and extras.count("e") == 5


# -------------------------------------------------------- replace_where --

RW_CASES = {
    # the predicate, and the ids of the rows written (all matching it)
    "partition": (lambda E: E.col("p") == E.lit("u"),
                  [i for i in range(1000, 1040) if _part_of(i) == "u"]),
    "data": (lambda E: (E.col("id") >= E.lit(20)) & (E.col("id") < E.lit(70)),
             list(range(20, 70))),
    # no file holds a match: a pure insert, but not a blind append
    "no_match": (lambda E: E.col("id") >= E.lit(5000), [5000, 5001]),
}
RW_PARAMS = [(kind, case, dv) for kind in KINDS for case in RW_CASES
             for dv in (False, True)
             if case != "partition" or KINDS[kind][0]]


@pytest.mark.parametrize("kind,case,dv", RW_PARAMS)
def test_replace_where(tmp_path, kind, case, dv):
    part, mapped = KINDS[kind]
    pred, ids = RW_CASES[case]
    ref, port, src = _base(tmp_path, kind, DV if dv else None)
    new = _arrow(ids, part, seed=7)
    rv, pv = _write_both(ref, port, new, mode="overwrite",
                         replace_where=pred)
    c = _same_commit(ref, port, rv, pv, src)
    assert c["operationParameters"] == {"predicate": repr(pred(PE))}
    assert c["isBlindAppend"] is False
    m = c["metrics"]
    assert m["numOutputRows"] == str(len(ids))
    if case == "partition":  # whole files
        assert m["numCopiedRows"] == "0" and c["remove"]
        assert all(r[4] is None for r in c["remove"])
    elif case == "no_match":
        assert m["numDeletedRows"] == "0" and not c["remove"]
    elif dv:                 # deletion vectors on the partly matched files
        assert any(a[4] for a in c["add"]) and m["numCopiedRows"] == "0"
    else:
        assert int(m["numCopiedRows"]) > 0
    rows = _same_rows(ref, port)
    if case == "data":
        assert sorted(r["id"] for r in rows) == list(range(120))


def test_replace_where_across_deletion_vectors(tmp_path):
    """A file that already has a DV gets the union of the old and the new
    deleted rows, as DELETE gives it."""
    ref, port, src = _base(tmp_path, "plain", DV)
    for mod, E, t in ((ref_dml, RE, RefTable.for_path(ref,
                                                      engine=HostEngine())),
                      (port_dml, PE, Table.for_path(port, engine=CPU))):
        mod.delete(t, E.col("id").is_in(*range(0, 120, 5)))
    pred = (lambda E: (E.col("id") >= E.lit(10)) & (E.col("id") < E.lit(20)))
    new = _arrow(range(10, 20), seed=3)
    rv, pv = _write_both(ref, port, new, mode="overwrite",
                         replace_where=pred)
    c = _same_commit(ref, port, rv, pv, src)
    cards = [a[4] for a in c["add"] if a[4]]
    assert cards == [8 + 10 - 2]  # 40 rows / 5 + [10, 20) less 10 and 15
    _same_rows(ref, port)


def test_replace_where_on_a_cdf_table_is_refused(tmp_path):
    """Refused until the change data feed was ported: now the write runs
    as the reference's (the commit and the rows), and its change data
    (the replaced rows' `delete` images, the written rows' `insert`
    ones) gives the reference's feed (`tests/test_torch_cdf.py` holds
    the feed in full)."""
    ref, port, src = _base(tmp_path, "plain",
                           {"delta.enableChangeDataFeed": "true"},
                           appends=((0, 10),))
    rv, pv = _write_both(ref, port, _arrow(range(3)), mode="overwrite",
                         replace_where=lambda E: E.col("id") < E.lit(3))
    _same_commit(ref, port, rv, pv, src)
    _same_rows(ref, port)
    got = port_changes_of(port, pv)
    assert got == ref_changes_of(ref, rv)
    assert sorted(got) == [(pv, "delete"), (pv, "insert")]
    assert len(got[(pv, "delete")]) == len(got[(pv, "insert")]) == 3


def test_replace_where_validates_rows(tmp_path):
    """The reference's `test_end_to_end.py::test_replace_where`: rows the
    predicate does not match are refused, a data predicate replaces rows
    inside files."""
    ref, port, src = _base(tmp_path, "partitioned")
    v0 = _version(port)
    bad = _arrow([1000, 1001], True)  # p = "v" and "w"
    for write in (lambda: dta.write_table(
            ref, bad, mode="overwrite", engine=HostEngine(),
            replace_where=RE.col("p") == RE.lit("u")),
            lambda: pta.write_table(
            port, to_port(bad), mode="overwrite", engine=CPU,
            replace_where=PE.col("p") == PE.lit("u"))):
        with pytest.raises((RefError, DeltaError)) as e:
            write()
        assert e.value.error_class == "DELTA_REPLACE_WHERE_MISMATCH"
    assert _version(port) == _version(ref) == v0
    # a predicate column the rows lack reads as null: no row matches
    no_v = _arrow(range(20, 22), True).drop(["v"])
    for write in (lambda: dta.write_table(
            ref, no_v, mode="overwrite", engine=HostEngine(),
            replace_where=RE.col("v") > RE.lit(0.0)),
            lambda: pta.write_table(
            port, to_port(no_v), mode="overwrite", engine=CPU,
            replace_where=PE.col("v") > PE.lit(0.0))):
        with pytest.raises((RefError, DeltaError)) as e:
            write()
        assert e.value.error_class == "DELTA_REPLACE_WHERE_MISMATCH"
    _write_both(ref, port, pa.table({"id": pa.array([1], pa.int64()),
                                     "p": pa.array(["b"])}),
                mode="overwrite", replace_where=lambda E: E.col("id") <= E.lit(3))
    rows = _same_rows(ref, port)
    assert sorted(r["id"] for r in rows) == [1] + list(range(4, 120))


def test_replace_where_validates_on_new_table(tmp_path):
    for i, write in enumerate((
            lambda p: dta.write_table(p, pa.table({"p": pa.array(["b"])}),
                                      mode="overwrite", engine=HostEngine(),
                                      replace_where=RE.col("p") == RE.lit("a")),
            lambda p: pta.write_table(p, {"p": np.array(["b"], object)},
                                      mode="overwrite", engine=CPU,
                                      replace_where=PE.col("p") == PE.lit("a")))):
        path = str(tmp_path / str(i))
        with pytest.raises((RefError, DeltaError)) as e:
            write(path)
        assert e.value.error_class == "DELTA_REPLACE_WHERE_MISMATCH"
        assert not os.path.exists(os.path.join(path, "_delta_log")) or \
            not os.listdir(os.path.join(path, "_delta_log"))
    # a first write whose rows all match creates the table
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    rv, pv = _write_both(ref, port, pa.table({"p": pa.array(["a", "a"])}),
                         mode="overwrite",
                         replace_where=lambda E: E.col("p") == E.lit("a"))
    assert rv == pv == 0
    assert _summary(ref, 0, set())["operationParameters"] == \
        _summary(port, 0, set())["operationParameters"]
    assert same_rows(port_read(port), ref_read(ref))


# ------------------------------------------ dynamic partition overwrite --

@pytest.mark.parametrize("kind", list(KINDS))
def test_dynamic_partition_overwrite(tmp_path, kind):
    part, mapped = KINDS[kind]
    ref, port, src = _base(tmp_path, kind)
    # rows of partition u and of the null partition only
    ids = [i for i in range(2000, 2060) if _part_of(i) in ("u", None)]
    rv, pv = _write_both(ref, port, _arrow(ids, part), mode="overwrite",
                         partition_overwrite_mode="dynamic")
    c = _same_commit(ref, port, rv, pv, src)
    rows = _same_rows(ref, port)
    if part:
        gone = {i for i in range(120) if _part_of(i) in ("u", None)}
        assert sorted(r["id"] for r in rows) == sorted(
            [i for i in range(120) if i not in gone] + ids)
        kept = {a[0] for a in c["remove"]}
        assert kept and all("p=v" not in k and "p=w" not in k for k in kept)
    else:  # one partition: every file goes
        assert sorted(r["id"] for r in rows) == ids


def test_dynamic_overwrite_guards(tmp_path):
    """The reference's `test_error_catalog.py::
    test_round5_dynamic_overwrite_and_schema_log`: the partitions in the
    new rows alone are replaced; an append with data_change=False writes
    adds without dataChange."""
    ref, port, src = _base(tmp_path, "partitioned", appends=((0, 4),))
    rv, pv = _write_both(ref, port, pa.table({
        "id": pa.array([10], pa.int64()), "name": pa.array(["z"]),
        "v": pa.array([1.0]), "p": pa.array(["v"])}),
        mode="overwrite", partition_overwrite_mode="DYNAMIC")
    _same_commit(ref, port, rv, pv, src)
    assert sorted(r["id"] for r in _same_rows(ref, port)) == [0, 2, 3, 10]
    rv, pv = _write_both(ref, port, _arrow([99], True), mode="append",
                         data_change=False)
    c = _same_commit(ref, port, rv, pv, src)
    assert c["add"] and all(a[1] is False for a in c["add"])


# ------------------------------------------------ ignore and data_change --

@pytest.mark.parametrize("kind", list(KINDS))
def test_ignore_and_error_modes(tmp_path, kind):
    part = KINDS[kind][0]
    ref, port, src = _base(tmp_path, kind)
    v = _version(port)
    assert _write_both(ref, port, _arrow(range(500, 505), part),
                       mode="ignore") == (v, v)
    assert _version(port) == _version(ref) == v
    for write in (lambda: dta.write_table(ref, _arrow([1], part),
                                          mode="error", engine=HostEngine()),
                  lambda: pta.write_table(port, to_port(_arrow([1], part)),
                                          mode="error", engine=CPU)):
        with pytest.raises((RefError, DeltaError)) as e:
            write()
        assert e.value.error_class == "DELTA_PATH_EXISTS"
    # ignore on a new path creates the table
    rv, pv = _write_both(str(tmp_path / "r2"), str(tmp_path / "p2"),
                         _arrow(range(5), part), mode="ignore")
    assert rv == pv == 0
    assert same_rows(port_read(str(tmp_path / "p2")),
                     ref_read(str(tmp_path / "r2")))


@pytest.mark.parametrize("kind", list(KINDS))
def test_data_change_false_rewrite(tmp_path, kind):
    """An overwrite with the table's own rows and dataChange=false (the
    compaction idiom): every action says dataChange false, the rows stay."""
    part = KINDS[kind][0]
    ref, port, src = _base(tmp_path, kind)
    before = ref_read(ref)
    rv = dta.write_table(ref, dta.read_table(ref, engine=HostEngine()),
                         mode="overwrite", data_change=False,
                         engine=HostEngine())
    pv = pta.write_table(port, pta.read_table(port, engine=CPU),
                         mode="overwrite", data_change=False, engine=CPU,
                         target_rows_per_file=1000)
    c = _same_commit(ref, port, rv, pv, src)
    assert c["add"] and c["remove"]
    assert all(a[1] is False for a in c["add"] + c["remove"])
    assert len(c["remove"]) == len(Table.for_path(
        port, engine=CPU).snapshot_at(pv - 1).state.add_files)
    rows = _same_rows(ref, port)
    assert same_rows(rows, before)


# ------------------------------------------------------ argument errors --

def _t(ids=(1,)):
    return _arrow(list(ids), True)


ERRORS = {
    "overwrite_schema_on_append": (
        dict(mode="append", overwrite_schema=True), "DELTA_ILLEGAL_USAGE"),
    "replace_where_on_append": (
        dict(mode="append", replace_where=lambda E: E.col("id") < E.lit(5)),
        "DELTA_ILLEGAL_USAGE"),
    "overwrite_schema_with_replace_where": (
        dict(mode="overwrite", overwrite_schema=True,
             replace_where=lambda E: E.col("id") < E.lit(5)),
        "DELTA_ILLEGAL_USAGE"),
    "bad_partition_overwrite_mode": (
        dict(mode="overwrite", partition_overwrite_mode="sideways"),
        "DELTA_ILLEGAL_OPTION"),
    "dynamic_with_replace_where": (
        dict(mode="overwrite", partition_overwrite_mode="dynamic",
             replace_where=lambda E: E.col("p") == E.lit("v")),
        "DELTA_REPLACE_WHERE_WITH_DYNAMIC_PARTITION_OVERWRITE"),
    "dynamic_with_overwrite_schema": (
        dict(mode="overwrite", partition_overwrite_mode="dynamic",
             overwrite_schema=True),
        "DELTA_OVERWRITE_SCHEMA_WITH_DYNAMIC_PARTITION_OVERWRITE"),
    "replace_where_without_data_change": (
        dict(mode="overwrite", data_change=False,
             replace_where=lambda E: E.col("p") == E.lit("v")),
        "DELTA_REPLACE_WHERE_WITH_FILTER_DATA_CHANGE_UNSET"),
    "merge_schema_without_data_change": (
        dict(mode="append", data_change=False, merge_schema=True),
        "DELTA_DATA_CHANGE_FALSE"),
    "overwrite_schema_without_data_change": (
        dict(mode="overwrite", data_change=False, overwrite_schema=True),
        "DELTA_DATA_CHANGE_FALSE"),
    "replace_where_unknown_column": (
        dict(mode="overwrite",
             replace_where=lambda E: E.col("zzz") == E.lit(1)),
        "DELTA_CANNOT_RESOLVE_COLUMN"),
    "replace_where_mismatch": (
        dict(mode="overwrite",
             replace_where=lambda E: E.col("id") > E.lit(100)),
        "DELTA_REPLACE_WHERE_MISMATCH"),
    "error_mode": (dict(mode="error"), "DELTA_PATH_EXISTS"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_argument_errors(tmp_path, case):
    kw, want = ERRORS[case]
    ref, port, src = _base(tmp_path, "partitioned", appends=((0, 6),))
    v = _version(port)
    got = []
    for pkg, path in (("ref", ref), ("port", port)):
        args = dict(kw)
        rw = args.pop("replace_where", None)
        E = RE if pkg == "ref" else PE
        if rw is not None:
            args["replace_where"] = rw(E)
        with pytest.raises((RefError, DeltaError)) as e:
            if pkg == "ref":
                dta.write_table(path, _t(), engine=HostEngine(), **args)
            else:
                pta.write_table(path, to_port(_t()), engine=CPU, **args)
        got.append(e.value.error_class)
    assert got == [want, want]
    assert _version(port) == _version(ref) == v
    if case == "replace_where_unknown_column":
        with pytest.raises(UnresolvedColumnError):
            pta.write_table(port, to_port(_t()), engine=CPU,
                            mode="overwrite",
                            replace_where=PE.col("zzz") == PE.lit(1))


def test_data_change_false_on_a_new_table(tmp_path):
    got = []
    for i, write in enumerate((
            lambda p: dta.write_table(p, _t(), engine=HostEngine(),
                                      data_change=False),
            lambda p: pta.write_table(p, to_port(_t()), engine=CPU,
                                      data_change=False))):
        with pytest.raises((RefError, DeltaError)) as e:
            write(str(tmp_path / str(i)))
        got.append(e.value.error_class)
    assert got == ["DELTA_DATA_CHANGE_FALSE"] * 2


@pytest.mark.parametrize("case", ["overwrite", "append"])
def test_new_columns_without_a_flag_are_a_schema_mismatch(tmp_path, case):
    """The reference's `test_end_to_end.py::test_overwrite_schema`: a
    different schema needs overwrite_schema (or merge_schema)."""
    ref, port, src = _base(tmp_path, "plain", appends=((0, 5),))
    new = pa.table({"b": pa.array(["x", "y"])})
    got = []
    for write in (lambda: dta.write_table(ref, new, mode=case,
                                          engine=HostEngine()),
                  lambda: pta.write_table(port, to_port(new), mode=case,
                                          engine=CPU)):
        with pytest.raises((RefError, DeltaError)) as e:
            write()
        got.append(e.value.error_class)
    assert got[0] == got[1]
    if case == "overwrite":
        rv, pv = _write_both(ref, port, new, mode="overwrite",
                             overwrite_schema=True)
        assert _names(port) == _names(ref) == ["b"]
        assert len(_same_rows(ref, port)) == 2


def _names(path):
    return Table.for_path(path, engine=CPU).latest_snapshot() \
        .schema.field_names()


def test_merge_schema_type_conflict(tmp_path):
    ref, port, src = _base(tmp_path, "plain", appends=((0, 5),))
    new = pa.table({"id": pa.array(["a"]), "name": pa.array(["b"]),
                    "v": pa.array([1.0])})
    got = []
    for write in (lambda: dta.write_table(ref, new, merge_schema=True,
                                          engine=HostEngine()),
                  lambda: pta.write_table(port, to_port(new),
                                          merge_schema=True, engine=CPU)):
        with pytest.raises((RefError, DeltaError)) as e:
            write()
        got.append(e.value.error_class)
    assert got == ["DELTA_FAILED_TO_MERGE_FIELDS"] * 2


def test_unknown_mode_is_refused(tmp_path):
    with pytest.raises(DeltaError) as e:
        pta.write_table(str(tmp_path / "t"), {"a": np.arange(3)},
                        mode="sideways", engine=CPU)
    assert e.value.error_class == "DELTA_ILLEGAL_USAGE"


def test_schema_at_creation(tmp_path):
    schema = StructType([StructField("a", "long"),
                         StructField("b", "string", nullable=False)])
    path = str(tmp_path / "t")
    pta.write_table(path, {"a": np.arange(3), "b": np.array(
        ["x", "y", "z"], object)}, engine=CPU, schema=schema)
    got = Table.for_path(path, engine=CPU).latest_snapshot().schema
    assert got == schema
    ref = str(tmp_path / "r")
    dta.write_table(ref, pa.table({"a": pa.array([0, 1, 2], pa.int64()),
                                   "b": pa.array(["x", "y", "z"])}),
                    engine=HostEngine(), schema=ref_schema.StructType([
                        ref_schema.StructField("a", ref_schema.PrimitiveType(
                            "long")),
                        ref_schema.StructField("b", ref_schema.PrimitiveType(
                            "string"), nullable=False)]))
    assert _log(ref, 0)[2]["metaData"]["schemaString"] == \
        _log(path, 0)[2]["metaData"]["schemaString"]


# ---------------------------------------------------- schema evolution --

def _to_ref(t):
    if isinstance(t, str):
        return ref_schema.PrimitiveType(t)
    if isinstance(t, StructType):
        return ref_schema.StructType([ref_schema.StructField(
            f.name, _to_ref(f.data_type), f.nullable, dict(f.metadata))
            for f in t.fields])
    if isinstance(t, ArrayType):
        return ref_schema.ArrayType(_to_ref(t.element_type), t.contains_null)
    return ref_schema.MapType(_to_ref(t.key_type), _to_ref(t.value_type),
                              t.value_contains_null)


def _json(t):
    return t if isinstance(t, str) else t.to_json_value()


_S_AB = StructType([StructField("a", "long"), StructField("b", "string")])
_S_ABC = StructType([StructField("A", "integer"), StructField("c", "date"),
                     StructField("b", "string")])
TYPE_PAIRS = [
    ("long", "long"), ("integer", "long"), ("long", "integer"),
    ("byte", "short"), ("short", "byte"), ("byte", "long"),
    ("float", "double"), ("double", "float"), ("integer", "double"),
    ("long", "double"), ("date", "timestamp_ntz"), ("date", "timestamp"),
    ("string", "long"), ("binary", "string"), ("timestamp_ntz", "date"),
    ("decimal(7,2)", "decimal(9,2)"), ("decimal(7,2)", "decimal(9,4)"),
    ("decimal(7,2)", "decimal(8,3)"), ("decimal(9,2)", "decimal(7,2)"),
    ("decimal(7,2)", "decimal(7,2)"), ("integer", "decimal(12,2)"),
    (ArrayType("integer"), ArrayType("long", False)),
    (ArrayType("long", False), ArrayType("string")),
    (MapType("string", "float"), MapType("string", "double", False)),
    (MapType("string", "long"), MapType("integer", "long")),
    (_S_AB, _S_ABC), (_S_ABC, _S_AB),
    (StructType([StructField("s", _S_AB)]),
     StructType([StructField("s", _S_ABC), StructField("t", "byte")])),
    (ArrayType(_S_AB), ArrayType(_S_ABC)),
]


@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("pair", range(len(TYPE_PAIRS)))
def test_merge_types_equals_the_reference(pair, widen):
    cur, inc = TYPE_PAIRS[pair]
    try:
        want = ref_se.merge_types(_to_ref(cur), _to_ref(inc), widen,
                                  "c").to_json_value()
    except RefError as e:
        want = e.error_class
    try:
        got = _json(port_se.merge_types(cur, inc, widen, "c"))
    except DeltaError as e:
        got = e.error_class
    assert got == want
    if isinstance(cur, str) and isinstance(inc, str):
        assert port_se.can_widen(cur, inc) == ref_se.can_widen(
            _to_ref(cur), _to_ref(inc))


def test_merge_schemas():
    """The reference's `test_columnmapping_alter.py::test_merge_schemas`
    and `::test_merge_schemas_conflict`."""
    cur = StructType([StructField("a", "long", False),
                      StructField("b", "string")])
    inc = StructType([StructField("a", "long"), StructField("c", "string")])
    merged = port_se.merge_schemas(cur, inc)
    assert merged.field_names() == ["a", "b", "c"]
    assert merged["c"].nullable and not merged["a"].nullable
    assert merged.to_json_value() == ref_se.merge_schemas(
        _to_ref(cur), _to_ref(inc)).to_json_value()
    with pytest.raises(RefError) as r:
        ref_se.merge_schemas(_to_ref(StructType([StructField("a", "string")])),
                             _to_ref(StructType([StructField("a", "long")])))
    with pytest.raises(DeltaError) as e:
        port_se.merge_schemas(StructType([StructField("a", "string")]),
                              StructType([StructField("a", "long")]))
    assert e.value.error_class == r.value.error_class == \
        "DELTA_FAILED_TO_MERGE_FIELDS"
    assert port_se.is_read_compatible(cur, inc) == ref_se.is_read_compatible(
        _to_ref(cur), _to_ref(inc))
    assert port_se.is_read_compatible(
        StructType([StructField("a", "string")]),
        StructType([StructField("a", "long")])) is False


# --------------------------------------------- C18: name resolution --

def _c18_table(tmp_path):
    ref, port, _ = _base(tmp_path, "plain", appends=((0, 30), (30, 60)))
    return ref, port


C18_READS = {
    "unknown": lambda E: E.col("zzz") < E.lit(5),
    "unknown_is_null": lambda E: E.col("zzz").is_null(),
    "wrong_case": lambda E: E.col("ID") < E.lit(5),
    "residual": lambda E: (E.col("id") < E.lit(5)) & (E.col("zzz") > E.lit(1)),
}


@pytest.mark.parametrize("case", list(C18_READS))
def test_c18_filter_on_an_unknown_column(tmp_path, case):
    ref, port = _c18_table(tmp_path)
    pred = C18_READS[case]
    with pytest.raises(NonExistentColumnError) as e:
        pta.read_table(port, filter=pred(PE), engine=CPU)
    assert e.value.error_class == "DELTA_COLUMN_NOT_FOUND"
    with pytest.raises(NonExistentColumnError):
        Table.for_path(port, engine=CPU).latest_snapshot().scan(
            filter=pred(PE))
    if _REFERENCE_KEEPS_UNKNOWN_FILTER:
        kept = ref_read(ref, filter=pred(RE))
        assert len(kept) == (30 if case == "residual" else 60)


def test_c18_projection_of_an_unknown_column(tmp_path):
    ref, port = _c18_table(tmp_path)
    with pytest.raises(NonExistentColumnError):
        pta.read_table(port, columns=["id", "zzz"], engine=CPU)
    with pytest.raises(NonExistentColumnError):
        Table.for_path(port, engine=CPU).latest_snapshot().scan(
            columns=["zzz"])
    if _REFERENCE_KEEPS_UNKNOWN_FILTER:
        assert dta.read_table(ref, columns=["zzz"],
                              engine=HostEngine()).num_rows == 0
    # known names still read
    assert len(port_read(port, columns=["v", "id"])) == 60


C18_COMMANDS = {
    "delete": (lambda m, T, E: m.delete(T, E.col("ID") < E.lit(5))),
    "update": (lambda m, T, E: m.update(T, {"v": E.lit(1.0)},
                                        E.col("zzz") < E.lit(5))),
    "merge_on": (lambda m, T, E: m.merge(
        T, {"id": np.array([1])} if m is port_merge else
        pa.table({"id": pa.array([1], pa.int64())}),
        E.col("target.zzz") == E.col("source.id"))
        .when_matched_delete().execute()),
    "merge_condition": (lambda m, T, E: m.merge(
        T, {"id": np.array([1])} if m is port_merge else
        pa.table({"id": pa.array([1], pa.int64())}),
        E.col("target.id") == E.col("source.id"))
        .when_matched_delete(condition=E.col("target.Name").is_null())
        .execute()),
    "optimize_where": (lambda m, T, E: T.optimize().where(
        E.col("zzz") < E.lit(5)).execute_compaction()),
}


@pytest.mark.parametrize("case", list(C18_COMMANDS))
def test_c18_commands_refuse_an_unknown_column(tmp_path, case):
    ref, port = _c18_table(tmp_path)
    run = C18_COMMANDS[case]
    module = {"delete": port_dml, "update": port_dml}.get(case, port_merge)
    v = _version(port)
    with pytest.raises(NonExistentColumnError):
        run(module, Table.for_path(port, engine=CPU), PE)
    assert _version(port) == v
    if _REFERENCE_KEEPS_UNKNOWN_FILTER and case != "optimize_where":
        ref_module = {"delete": ref_dml, "update": ref_dml}.get(case,
                                                               ref_merge)
        with pytest.raises((KeyError, pa.ArrowInvalid)):
            run(ref_module, RefTable.for_path(ref, engine=HostEngine()), RE)
    assert len(port_read(port)) == 60


# ------------------------------------------------------ the chip's step --

def test_chip_write_modes_phase_passes_on_the_cpu():
    """`chip_smoke.py`'s step 22 with the plain versions, on step 21's two
    tables at two links of each store_sales file: every step's rows held
    to step 21's numpy models inside the phase."""
    import chip_smoke
    from test_torch_wide_types import FIXTURES

    keep, kept, tables = {}, {}, {}
    chip_smoke.wide_types_phase(FIXTURES, "cpu", "cpu", links=2, keep=keep)
    chip_smoke.wide_write_phase(keep["all"], keep["nested"], FIXTURES,
                                "cpu", "cpu", links=2, keep=kept)
    try:
        chip_smoke.column_mapping_phase(kept, "cpu", "cpu", keep=tables)
        out = chip_smoke.write_modes_phase(tables, "cpu", "cpu")
    finally:
        shutil.rmtree(kept["work"], ignore_errors=True)
    steps = out["steps"]
    assert list(steps) == [
        "dynamic_week", "replace_range", "replace_refused", "merge_schema",
        "read_before_rewrite", "rewrite", "ignore", "error",
        "read_before_schema", "overwrite_schema", "schema_reload",
        "schema_read_all", "replace_tickets", "reload", "read_all"]
    assert steps["replace_tickets"]["dvs"] > 0
    assert out["b"]["range_files"] > 0 and out["b"]["columns"] == 21

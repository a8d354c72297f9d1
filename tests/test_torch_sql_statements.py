"""SQL's statements past the query against the reference's `sql()`.

Every statement form of `delta_tpu/sql.py::sql` that changes or describes
a table: INSERT [OVERWRITE] [REPLACE WHERE] VALUES, DELETE, UPDATE, MERGE
INTO, OPTIMIZE [WHERE] [ZORDER BY], VACUUM, REORG PURGE, DESCRIBE HISTORY
and DETAIL, RESTORE, CONVERT TO DELTA, GENERATE, ALTER TABLE's forms,
DROP FEATURE, and CREATE TABLE, DROP TABLE and SHOW TABLES. Each package
writes its own table from the same numpy data (seeded): the reference
with `HostEngine`, the port with `TorchEngine("cpu")`. Each statement runs
through `delta_tpu.sql.sql` and `delta_tpu_torch.sql.sql`; the test holds
the rows each package then reads (as multisets), the commit's operation
and parameters, and the returned fields (file sizes and timings aside)
to each other, and for a malformed statement the error class. CONVERT
and GENERATE run on copies of one set of files, so their stats and
manifests compare byte for byte (the table root aside).

C33 (a reference caveat): INSERT's VALUES go through `pa.array(values,
type)` in the reference, which raises Arrow's own errors (a string into a
date column, a float into a decimal column, a bool into a number, a value
out of range); the port raises `InvalidArgumentError` with an error class
there (`test_insert_values_typing`).
"""

import dataclasses
import datetime
import decimal
import json
import os
import shutil
from urllib.parse import unquote

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.generate as ref_generate
import delta_tpu.ops.pallas_kernels as ref_pk
from delta_tpu.catalog import Catalog as RefCatalog
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefDeltaError
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.sql import sql as ref_sql
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.api import read_table, write_table
from delta_tpu_torch.catalog import Catalog
from delta_tpu_torch.commands import generate as port_generate
from delta_tpu_torch.errors import (
    DeltaError,
    InvalidArgumentError,
    UnsupportedSqlError,
    UnsupportedTableError,
)
from delta_tpu_torch.hooks import PostCommitHookError
from delta_tpu_torch.models.batch import Batch, column_from_python
from delta_tpu_torch.sql import sql

CPU = TorchEngine("cpu")
HOST = HostEngine()
TYPES = {"id": ("long", pa.int64()), "grp": ("string", pa.string()),
         "v": ("double", pa.float64()), "q": ("integer", pa.int32()),
         "s": ("string", pa.string()), "d": ("date", pa.date32())}
ROWS = 20
APPENDS = 3


@pytest.fixture(autouse=True)
def ref_x32(monkeypatch):
    """The reference's Z-order needs jax's old x64 switch (ROADMAP C0)."""
    monkeypatch.setattr(ref_pk, "_x32", lambda: jax.enable_x64(False))


def _lists(seed: int, first: int) -> dict:
    rng = np.random.default_rng(seed)
    day0 = datetime.date(2020, 1, 1)
    return {
        "id": list(range(first, first + ROWS)),
        "grp": [str(x) for x in rng.choice(["a", "b", "c"], ROWS)],
        "v": [round(float(x), 2) for x in rng.normal(10, 3, ROWS)],
        "q": [int(x) for x in rng.integers(0, 100, ROWS)],
        "s": [None if i % 7 == 3 else f"s{i}" for i in range(ROWS)],
        "d": [day0 + datetime.timedelta(days=int(x))
              for x in rng.integers(0, 60, ROWS)],
    }


def _write_pair(ref_path, port_path, seed=7, props=None, partition_by=None,
                appends=APPENDS, first=0):
    for k in range(appends):
        cols = _lists(seed + k, first + k * ROWS)
        dta.write_table(ref_path, pa.table(
            {n: pa.array(v, TYPES[n][1]) for n, v in cols.items()}),
            partition_by=partition_by, properties=props, engine=HOST)
        write_table(port_path, Batch(
            {n: column_from_python(v, TYPES[n][0]) for n, v in cols.items()},
            ROWS), partition_by=partition_by, properties=props, engine=CPU)


@pytest.fixture
def pair(tmp_path):
    def make(name="t", **kw):
        ref_p, port_p = str(tmp_path / f"ref_{name}"), str(tmp_path /
                                                             f"port_{name}")
        _write_pair(ref_p, port_p, **kw)
        return ref_p, port_p
    return make


def _norm(v):
    if isinstance(v, float) and v != v:
        return "NaN"
    if isinstance(v, datetime.datetime) and v.tzinfo is not None:
        return v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    return v


def _ref_rows(path) -> list:
    clear_parse_cache()
    t = dta.read_table(path, engine=HOST)
    return sorted((tuple(sorted((k, _norm(v)) for k, v in r.items()))
                   for r in t.to_pylist()), key=repr)


def _port_rows(path) -> list:
    b = read_table(path, engine=CPU)
    cols = {n: b.column(n).to_python() for n in b.column_names}
    return sorted((tuple(sorted((n, _norm(cols[n][i])) for n in cols))
                   for i in range(b.num_rows)), key=repr)


def _commit(path, version=None) -> dict:
    log = os.path.join(path, "_delta_log")
    if version is None:
        version = max(int(f[:20]) for f in os.listdir(log)
                      if f.endswith(".json") and f[:20].isdigit())
    with open(os.path.join(log, f"{version:020d}.json")) as f:
        for line in f:
            a = json.loads(line)
            if "commitInfo" in a:
                ci = a["commitInfo"]
                return {"operation": ci.get("operation"),
                        "operationParameters": ci.get("operationParameters")}
    return {}


_DROPPED = {"phase_seconds", "bytes_added", "bytes_removed", "dirs_scanned"}
_DETAIL_DROPPED = {"id", "location", "createdAt", "lastModified",
                   "sizeInBytes"}


def _fields(res, ref_root=None, port_root=None):
    """What a statement returned, as the parity compares it."""
    if dataclasses.is_dataclass(res):
        d = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
             if f.name not in _DROPPED}
        if "files_deleted" in d:
            d["files_deleted"] = len(d["files_deleted"])
        return d
    if isinstance(res, dict) and "numFiles" in res:
        return {k: v for k, v in res.items() if k not in _DETAIL_DROPPED}
    if isinstance(res, dict):  # GENERATE: manifest path -> file count
        return {os.path.relpath(k, ref_root if k.startswith(ref_root)
                                else port_root): v for k, v in res.items()}
    if isinstance(res, list) and res and isinstance(res[0], dict):
        keys = ("version", "operation", "operationParameters",
                "readVersion", "isBlindAppend", "isolationLevel")
        return [{k: r.get(k) for k in keys} for r in res]
    return res


def _both(stmt, ref_t, port_t, **kw):
    r = ref_sql(stmt.format(t=f"'{ref_t}'", **{k: f"'{v[0]}'"
                                              for k, v in kw.items()}),
                engine=HOST)
    p = sql(stmt.format(t=f"'{port_t}'", **{k: f"'{v[1]}'"
                                           for k, v in kw.items()}),
            engine=CPU)
    return r, p


def _held(ref_t, port_t, r, p):
    assert _fields(p, ref_t, port_t) == _fields(r, ref_t, port_t)
    assert _commit(port_t) == _commit(ref_t)
    assert _port_rows(port_t) == _ref_rows(ref_t)


DV = {"delta.enableDeletionVectors": "true"}
MAPPED = {"delta.enableDeletionVectors": "true",
          "delta.columnMapping.mode": "name"}
WIDENING = {"delta.enableDeletionVectors": "true",
            "delta.enableTypeWidening": "true"}

# (id, table properties, partition columns, setup statements, statement)
STATEMENTS = [
    ("delete", None, None, [], "DELETE FROM {t} WHERE id < 30"),
    ("delete_all", None, None, [], "DELETE FROM {t}"),
    ("delete_dv", DV, None, [], "DELETE FROM {t} WHERE q >= 50"),
    ("delete_partition", None, ["grp"], [], "DELETE FROM {t} WHERE grp = 'b'"),
    ("update", None, None, [], "UPDATE {t} SET v = 99.5, q = 7 WHERE id >= 40"),
    ("update_all", None, None, [], "UPDATE {t} SET s = 'zz'"),
    ("update_dv", DV, None, [], "UPDATE {t} SET q = q WHERE s IS NULL"),
    ("insert", None, None, [],
     "INSERT INTO {t} VALUES (1000, 'a', 1.5, 3, 'x', 18300), "
     "(1001, 'b', -2.25, 4, NULL, 18301)"),
    ("insert_columns", None, None, [],
     "INSERT INTO {t} (id, v) VALUES (1002, 2.5), (1003, NULL)"),
    ("insert_partitioned", None, ["grp"], [],
     "INSERT INTO {t} VALUES (1004, 'd', 1.0, 1, 'y', 18302)"),
    ("insert_overwrite", None, None, [],
     "INSERT OVERWRITE {t} VALUES (1, 'a', 1.0, 1, 'a', 18262)"),
    ("insert_replace_where", None, None, [],
     "INSERT OVERWRITE {t} REPLACE WHERE id >= 50 VALUES "
     "(150, 'c', 3.0, 2, 'r', 18263)"),
    ("insert_replace_where_dv", DV, None, [],
     "INSERT OVERWRITE {t} REPLACE WHERE q < 20 VALUES "
     "(151, 'c', 3.0, 2, 'r', 18263)"),
    ("optimize", None, None, [], "OPTIMIZE {t}"),
    ("optimize_where", None, ["grp"], [], "OPTIMIZE {t} WHERE grp = 'a'"),
    ("optimize_zorder", None, None, [], "OPTIMIZE {t} ZORDER BY (id, v)"),
    ("optimize_zorder_where", None, ["grp"], [],
     "OPTIMIZE {t} WHERE grp = 'c' ZORDER BY (q)"),
    ("vacuum_dry", None, None, ["DELETE FROM {t} WHERE id < 30"],
     "VACUUM {t} RETAIN 0 HOURS DRY RUN"),
    ("vacuum", None, None, ["DELETE FROM {t} WHERE id < 30"],
     "VACUUM {t} RETAIN 0 HOURS"),
    ("vacuum_modifiers_any_order", None, None,
     ["DELETE FROM {t} WHERE id < 30"], "VACUUM {t} DRY RUN FULL RETAIN 0 HOURS"),
    ("vacuum_lite", None, None, ["DELETE FROM {t} WHERE id < 30"],
     "VACUUM {t} LITE RETAIN 0 HOURS DRY RUN"),
    ("reorg_purge", DV, None, ["DELETE FROM {t} WHERE q >= 50"],
     "REORG TABLE {t} APPLY (PURGE)"),
    ("history", None, None, ["DELETE FROM {t} WHERE id < 30"],
     "DESCRIBE HISTORY {t}"),
    ("history_limit", None, None, [], "DESC HISTORY {t} LIMIT 2"),
    ("detail", DV, ["grp"], [], "DESCRIBE DETAIL {t}"),
    ("restore_version", None, None, ["DELETE FROM {t} WHERE id < 30"],
     "RESTORE TABLE {t} TO VERSION AS OF 1"),
    ("restore_no_table_word", DV, None, ["DELETE FROM {t} WHERE q >= 50"],
     "RESTORE {t} TO VERSION AS OF 2"),
    ("add_constraint", None, None, [],
     "ALTER TABLE {t} ADD CONSTRAINT idpos CHECK (id >= 0)"),
    ("drop_constraint", None, None,
     ["ALTER TABLE {t} ADD CONSTRAINT idpos CHECK (id >= 0)"],
     "ALTER TABLE {t} DROP CONSTRAINT idpos"),
    ("drop_constraint_if_exists", None, None, [],
     "ALTER TABLE {t} DROP CONSTRAINT IF EXISTS nope"),
    ("set_properties", None, None, [],
     "ALTER TABLE {t} SET TBLPROPERTIES ('delta.appendOnly' = 'false', "
     "delta.logRetentionDuration = 'interval 7 days')"),
    ("unset_properties", None, None,
     ["ALTER TABLE {t} SET TBLPROPERTIES ('delta.appendOnly' = 'false')"],
     "ALTER TABLE {t} UNSET TBLPROPERTIES ('delta.appendOnly')"),
    ("unset_properties_if_exists", None, None, [],
     "ALTER TABLE {t} UNSET TBLPROPERTIES IF EXISTS ('nope')"),
    ("add_columns", None, None, [],
     "ALTER TABLE {t} ADD COLUMNS (extra STRING, n BIGINT)"),
    ("rename_column", MAPPED, None, [],
     "ALTER TABLE {t} RENAME COLUMN v TO w"),
    ("drop_column", MAPPED, None, [], "ALTER TABLE {t} DROP COLUMN s"),
    ("change_column_type", WIDENING, None, [],
     "ALTER TABLE {t} CHANGE COLUMN q TYPE BIGINT"),
    ("alter_column_type", WIDENING, None, [],
     "ALTER TABLE {t} ALTER COLUMN q TYPE long"),
    ("merge_upsert", None, None, [],
     "MERGE INTO {t} a USING {s} b ON a.id = b.id WHEN MATCHED THEN "
     "UPDATE SET * WHEN NOT MATCHED THEN INSERT *"),
    ("merge_clauses", DV, None, [],
     "MERGE INTO {t} AS a USING {s} AS b ON a.id = b.id "
     "WHEN MATCHED AND b.q > 50 THEN DELETE "
     "WHEN MATCHED THEN UPDATE SET v = b.v, s = 'm' "
     "WHEN NOT MATCHED THEN INSERT (id, grp, v) VALUES (b.id, 'n', b.v) "
     "WHEN NOT MATCHED BY SOURCE AND a.id < 5 THEN DELETE"),
    ("merge_source_update", None, ["grp"], [],
     "MERGE INTO {t} USING {s} ON target.id = source.id "
     "WHEN NOT MATCHED BY SOURCE THEN UPDATE SET q = 0"),
]


@pytest.mark.parametrize("props,partition_by,setup,stmt", [
    c[1:] for c in STATEMENTS], ids=[c[0] for c in STATEMENTS])
def test_statement_matches_reference(pair, tmp_path, props, partition_by,
                                     setup, stmt):
    ref_t, port_t = pair(props=props, partition_by=partition_by)
    kw = {}
    if "{s}" in stmt:  # MERGE's source: ids 50-59 match, 60-69 are new
        kw["s"] = pair(name="s", seed=11, appends=1, first=50)
    for s in setup:
        _both(s, ref_t, port_t, **kw)
    r, p = _both(stmt, ref_t, port_t, **kw)
    _held(ref_t, port_t, r, p)


# ---------------------------------------------------------------- RESTORE


def test_restore_to_timestamp_matches_reference(pair):
    ref_t, port_t = pair()
    for path, run, eng in ((ref_t, ref_sql, HOST), (port_t, sql, CPU)):
        run(f"DELETE FROM '{path}' WHERE id < 30", engine=eng)
        log = os.path.join(path, "_delta_log")
        for v in range(4):  # commit v at 1,000 s + v minutes
            os.utime(os.path.join(log, f"{v:020d}.json"),
                     (1_000 + 60 * v, 1_000 + 60 * v))
    stmt = "RESTORE TABLE {t} TO TIMESTAMP AS OF 1090000"
    r, p = _both(stmt, ref_t, port_t)
    _held(ref_t, port_t, r, p)
    iso = datetime.datetime.fromtimestamp(1_150, datetime.timezone.utc)
    r, p = _both("RESTORE {t} TO TIMESTAMP AS OF '"
                 + iso.isoformat().replace("+00:00", "Z") + "'",
                 ref_t, port_t)
    _held(ref_t, port_t, r, p)


# ------------------------------------------- CREATE, DROP, SHOW TABLES --

CATALOG_STATEMENTS = [
    "CREATE TABLE events (id BIGINT NOT NULL, name VARCHAR(20), score "
    "DOUBLE, day DATE, amt DECIMAL(9, 2), flag BOOLEAN DEFAULT true) USING "
    "DELTA PARTITIONED BY (name) TBLPROPERTIES ('delta.appendOnly' = "
    "'false', 'delta.enableDeletionVectors' = 'true')",
    "SHOW TABLES",
    "INSERT INTO events (id, name, score, day, amt) VALUES "
    "(1, 'a', 1.5, 18262, 3), (2, 'b', NULL, NULL, -7)",
    "INSERT INTO events VALUES (3, 'a', 2.0, 18263, 1, false)",
    "CREATE TABLE IF NOT EXISTS events (id BIGINT) USING DELTA",
    "CREATE TABLE other (k INT, s STRING DEFAULT 'x') USING DELTA "
    "LOCATION '{root}/elsewhere'",
    "SHOW TABLES",
    "DESCRIBE DETAIL events",
    "DESCRIBE DETAIL other",
    "DELETE FROM events WHERE id = 1",
    "UPDATE events SET score = 0.5 WHERE name = 'a'",
    "DESCRIBE HISTORY events",
    "ALTER TABLE other DROP FEATURE allowColumnDefaults",
    "DESCRIBE DETAIL other",
    "DROP TABLE other",
    "DROP TABLE IF EXISTS other",
    "SHOW TABLES",
]


def test_catalog_statements_match_reference(tmp_path):
    roots = {k: str(tmp_path / k) for k in ("ref", "port")}
    ref_cat = RefCatalog(roots["ref"], engine=HOST)
    cat = Catalog(roots["port"], engine=CPU)
    for stmt in CATALOG_STATEMENTS:
        r = ref_sql(stmt.format(root=roots["ref"]), catalog=ref_cat)
        p = sql(stmt.format(root=roots["port"]), catalog=cat)
        assert _fields(p) == _fields(r), stmt
    ref_t = ref_cat.table("events").path
    port_t = cat.table("events").path
    assert _port_rows(port_t) == _ref_rows(ref_t)
    assert _commit(port_t) == _commit(ref_t)


@pytest.mark.parametrize("stmt", [
    "CREATE TABLE events (id BIGINT) USING DELTA",
    "DROP TABLE nope",
    "DESCRIBE DETAIL nope",
    "CREATE TABLE bad (a INT DEFAULT b) USING DELTA",
    "CREATE TABLE bad (a INT DEFAULT 'x) USING DELTA",
    "CREATE TABLE bad (a FROB) USING DELTA",
    "CREATE TABLE bad (a INT CHECK) USING DELTA",
    "CREATE TABLE bad (a INT) USING PARQUET",
    "CREATE TABLE 1bad (a INT) USING DELTA",
    "INSERT INTO events (id, id) VALUES (1, 2)",
    "INSERT INTO events (nope) VALUES (1)",
])
def test_catalog_errors_match_reference(tmp_path, stmt):
    ref_cat = RefCatalog(str(tmp_path / "ref"), engine=HOST)
    cat = Catalog(str(tmp_path / "port"), engine=CPU)
    create = "CREATE TABLE events (id BIGINT, v DOUBLE) USING DELTA"
    ref_sql(create, catalog=ref_cat)
    sql(create, catalog=cat)
    with pytest.raises(Exception) as r:
        ref_sql(stmt, catalog=ref_cat)
    with pytest.raises(DeltaError) as p:
        sql(stmt, catalog=cat)
    if stmt.endswith("nope"):
        # the reference's TableNotInCatalogError keeps the base class
        assert r.value.error_class == "DELTA_ERROR"
        assert p.value.error_class == "DELTA_TABLE_NOT_FOUND"
    else:
        assert p.value.error_class == r.value.error_class
    assert sql("SHOW TABLES", catalog=cat) == ref_sql("SHOW TABLES",
                                                      catalog=ref_cat)


# ------------------------------------------------------ malformed SQL ---

@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Tables the error cases read and never change: plain, DV (with
    DVs), mapped, a MERGE source, a directory of plain Parquet files."""
    root = tmp_path_factory.mktemp("sql_errors")
    out = {}
    for name, props in (("t", None), ("dv", DV), ("mapped", MAPPED),
                        ("s", None)):
        ref_p, port_p = str(root / f"ref_{name}"), str(root / f"port_{name}")
        _write_pair(ref_p, port_p, props=props,
                    appends=1 if name == "s" else APPENDS,
                    first=50 if name == "s" else 0)
        out[name] = (ref_p, port_p)
    ref_sql(f"DELETE FROM '{out['dv'][0]}' WHERE q >= 50", engine=HOST)
    sql(f"DELETE FROM '{out['dv'][1]}' WHERE q >= 50", engine=CPU)
    plain = str(root / "plain")
    os.makedirs(plain)
    pq.write_table(pa.table({"x": pa.array([1, 2], pa.int64())}),
                   f"{plain}/f.parquet")
    out["plain"] = (plain, plain)
    out["empty"] = (str(root / "empty"),) * 2
    os.makedirs(out["empty"][0])
    out["missing"] = (str(root / "missing"),) * 2
    return out


MALFORMED = [
    "FROBNICATE {t}",
    "INSERT INTO {t} VALUES (1, 2)",
    "INSERT INTO {t} (id, id) VALUES (1, 2)",
    "INSERT INTO {t} (nope) VALUES (1)",
    "INSERT INTO {t} REPLACE WHERE id > 1 VALUES (1, 'a', 1.0, 1, 'a', 1)",
    "INSERT OVERWRITE {t} REPLACE WHERE id > 1",
    "INSERT INTO {t} VALUES",
    "INSERT INTO {t} SELECT * FROM {s}",
    "INSERT INTO {t} VALUES (1, 'a', 1.0, 1, 'a', 1) garbage",
    "INSERT INTO {t} VALUES (id, 'a', 1.0, 1, 'a', 1)",
    "INSERT INTO {t} VALUES ((1, 'a', 1.0, 1, 'a', 1)",
    "INSERT INTO {t} (id) VALUES (1), (2, 3)",
    "CONVERT TO DELTA {plain}",
    "CONVERT TO DELTA orc.`{plain_raw}`",
    "CONVERT TO DELTA parquet.`{t_raw}`",
    "CONVERT TO DELTA parquet.`{empty_raw}`",
    "CONVERT TO DELTA parquet.`{plain_raw}` PARTITIONED BY (p string)",
    "OPTIMIZE {t} FULL ZORDER BY (id)",
    "OPTIMIZE {t} ZORDER BY ()",
    "VACUUM {t} RETAIN -1 HOURS",
    "VACUUM {t} RETAIN 1 DAYS",
    "RESTORE TABLE {t} TO VERSION AS OF 99",
    "RESTORE TABLE {t} TO TIMESTAMP AS OF 'not-a-date'",
    "RESTORE TABLE {t} TO TIMESTAMP AS OF 99999999999999",
    "RESTORE TABLE {t} TO TIMESTAMP AS OF 1",
    "RESTORE TABLE {t} TO VERSION 1",
    "DESCRIBE HISTORY {t} LIMIT x",
    "DESCRIBE DETAIL {missing}",
    "DESCRIBE {t}",
    "ALTER TABLE {t} ADD CONSTRAINT neg CHECK (id < 0)",
    "ALTER TABLE {t} DROP CONSTRAINT nope",
    "ALTER TABLE {t} UNSET TBLPROPERTIES ('nope')",
    "ALTER TABLE {t} CHANGE COLUMN q TYPE frob",
    "ALTER TABLE {t} CHANGE COLUMN q TYPE BIGINT",
    "ALTER TABLE {t} CHANGE COLUMN nope TYPE BIGINT",
    "ALTER TABLE {t} RENAME COLUMN v TO w",
    "ALTER TABLE {t} DROP COLUMN v",
    "ALTER TABLE {mapped} DROP COLUMN nope",
    "ALTER TABLE {t} ADD COLUMNS (x INT NOT NULL)",
    "ALTER TABLE {t} ADD COLUMNS (id INT)",
    "ALTER TABLE {t} ADD COLUMNS (x FROB)",
    "ALTER TABLE {t} SET TBLPROPERTIES ('delta.checkpointInterval' = 'x')",
    "ALTER TABLE {t} FROB",
    "ALTER TABLE {t} DROP FEATURE frob",
    "ALTER TABLE {t} DROP FEATURE appendOnly",
    "ALTER TABLE {t} DROP FEATURE deletionVectors",
    "ALTER TABLE {t} DROP FEATURE changeDataFeed",
    "ALTER TABLE {dv} DROP FEATURE typeWidening",
    "GENERATE symlink_format_manifest FOR TABLE {dv}",
    "GENERATE symlink_format_manifest FOR TABLE {mapped}",
    "GENERATE manifest FOR TABLE {t}",
    "MERGE INTO {t} a USING {s} b ON a.id = b.id",
    "MERGE INTO {t} a {s} b ON a.id = b.id WHEN MATCHED THEN DELETE",
    "MERGE INTO {t} a USING {s} b WHEN MATCHED THEN DELETE",
    "MERGE INTO {t} a USING {s} b ON a.id = b.id WHEN MATCHED THEN FROB",
    "MERGE INTO {t} a USING {s} b ON a.id = b.id WHEN NOT MATCHED THEN "
    "INSERT (id) VALUES (b.id, b.v)",
    "MERGE INTO {t} a USING {s} b ON a.id = b.id WHEN NOT MATCHED THEN "
    "UPDATE SET v = 1.0",
    "MERGE INTO {t} a USING {s} b ON a.id = b.id WHEN NOT MATCHED BY "
    "SOURCE THEN INSERT *",
    "MERGE INTO {t} a USING {s} b ON a.id = b.id WHEN FOO THEN DELETE",
    "MERGE INTO {t} a USING {s} b ON a.id = b.id WHEN MATCHED DELETE",
    "UPDATE {t} SET v = WHERE id = 1",
    "UPDATE {t} SET WHERE id = 1",
    "DELETE FROM {t} WHERE",
    "SELECT * FROM nope_table",
    "CREATE TABLE x (a INT) USING DELTA",
    "DROP TABLE x",
    "SHOW TABLES",
]


def _error_case(stmt, shared, which):
    kw = {k: f"'{v[which]}'" for k, v in shared.items()}
    kw.update({f"{k}_raw": v[which] for k, v in shared.items()})
    return stmt.format(**kw)


@pytest.mark.parametrize("stmt", MALFORMED)
def test_malformed_statement_matches_reference(shared, stmt):
    with pytest.raises(Exception) as r:
        ref_sql(_error_case(stmt, shared, 0), engine=HOST)
    with pytest.raises(Exception) as p:
        sql(_error_case(stmt, shared, 1), engine=CPU)
    ref_class = getattr(r.value, "error_class", type(r.value).__name__)
    assert getattr(p.value, "error_class", type(p.value).__name__) \
        == ref_class, (r.value, p.value)


@pytest.mark.parametrize("stmt,construct", [
    ("CREATE TABLE t (k BIGINT) USING DELTA CLUSTER BY (k)",
     "CREATE TABLE ... CLUSTER BY"),
    ("ALTER TABLE {t} CLUSTER BY (id)", "ALTER TABLE ... CLUSTER BY"),
    ("ALTER TABLE {t} CLUSTER BY NONE", "ALTER TABLE ... CLUSTER BY"),
    ("OPTIMIZE {t} FULL", "OPTIMIZE ... FULL"),
    ("OPTIMIZE {t} FULL WHERE grp = 'a'", "OPTIMIZE ... FULL"),
    ("REORG TABLE {t} APPLY (UPGRADE UNIFORM (ICEBERG_COMPAT_VERSION = 2))",
     "REORG ... UPGRADE UNIFORM"),
])
def test_four_constructs_are_refused_by_name(shared, tmp_path, stmt,
                                             construct):
    cat = Catalog(str(tmp_path), engine=CPU)
    before = sorted(os.listdir(os.path.join(shared["t"][1], "_delta_log")))
    with pytest.raises(UnsupportedSqlError) as e:
        sql(_error_case(stmt, shared, 1), engine=CPU, catalog=cat)
    assert e.value.context["construct"] == construct
    assert construct in str(e.value)
    assert sorted(os.listdir(os.path.join(shared["t"][1], "_delta_log"))) \
        == before
    assert sql("SHOW TABLES", catalog=cat) == []


def test_path_guard_sees_every_path(shared, tmp_path):
    seen = []
    src = str(tmp_path / "conv")
    shutil.copytree(shared["plain"][1], src)
    stmts = [
        "MERGE INTO {t} a USING {s} b ON a.id = b.id WHEN MATCHED THEN "
        "UPDATE SET v = b.v",
        "DESCRIBE DETAIL {dv}",
        f"CONVERT TO DELTA parquet.`{src}`",
    ]
    for stmt in stmts:
        sql(_error_case(stmt, shared, 1), engine=CPU, path_guard=seen.append)
    cat = Catalog(str(tmp_path / "cat"), engine=CPU)
    loc = str(tmp_path / "located")
    sql(f"CREATE TABLE x (a INT) USING DELTA LOCATION '{loc}'", catalog=cat,
        path_guard=seen.append)
    assert seen == [shared["t"][1], shared["s"][1], shared["dv"][1], src,
                    loc]

    def refuse(path):
        raise PermissionError(path)

    with pytest.raises(PermissionError):
        sql(_error_case("MERGE INTO {t} a USING {missing} b ON a.id = b.id "
                        "WHEN MATCHED THEN DELETE", shared, 1).replace(
                            f"'{shared['t'][1]}'", "x"),
            engine=CPU, catalog=cat, path_guard=refuse)


# ------------------------------------------------- INSERT's typing, C33 --

TYPED = "(l BIGINT, i INT, sh SMALLINT, b TINYINT, f FLOAT, dbl DOUBLE, " \
    "s STRING, bo BOOLEAN, d DATE, ts TIMESTAMP, dec DECIMAL(7,2), bin BINARY)"


@pytest.fixture(scope="module")
def typed(tmp_path_factory):
    root = tmp_path_factory.mktemp("typed")
    cats = (RefCatalog(str(root / "ref"), engine=HOST),
            Catalog(str(root / "port"), engine=CPU))
    for run, cat in zip((ref_sql, sql), cats):
        run(f"CREATE TABLE ty {TYPED} USING DELTA", catalog=cat)
    return cats


@pytest.mark.parametrize("column,literal", [
    ("l", "1.7"), ("l", "-1.7"), ("i", "-2147483648"), ("sh", "2.0"),
    ("dbl", "3"), ("dbl", "true"), ("f", "1.5"), ("d", "5"), ("d", "-3.9"),
    ("ts", "1000001"), ("dec", "2"), ("dec", "-99999"), ("bin", "'ab'"),
    ("s", "'x y'"), ("bo", "false"), ("l", "NULL"), ("d", "NULL"),
])
def test_insert_values_typing(typed, column, literal):
    ref_cat, cat = typed
    stmt = f"INSERT INTO ty ({column}) VALUES ({literal})"
    r = ref_sql(stmt, catalog=ref_cat)
    assert sql(stmt, catalog=cat) == r
    assert _port_rows(cat.table("ty").path) == _ref_rows(
        ref_cat.table("ty").path)


@pytest.mark.parametrize("column,literal,error_class", [
    ("l", "'x'", "INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST"),
    ("l", "true", "INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST"),
    ("d", "'2020-01-01'", "INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST"),
    ("ts", "'2020-01-01 00:00:00'",
     "INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST"),
    ("dec", "1.25", "INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST"),
    ("s", "1", "INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST"),
    ("bo", "1", "INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST"),
    ("sh", "70000", "CAST_OVERFLOW_IN_TABLE_INSERT"),
    ("i", "2147483648", "CAST_OVERFLOW_IN_TABLE_INSERT"),
    ("dec", "100000", "CAST_OVERFLOW_IN_TABLE_INSERT"),
])
def test_insert_values_refused_with_a_class_c33(typed, column, literal,
                                                error_class):
    """C33: where the reference's `pa.array` raises Arrow's own error, the
    port raises a typed DeltaError; neither writes."""
    ref_cat, cat = typed
    stmt = f"INSERT INTO ty ({column}) VALUES ({literal})"
    with pytest.raises((pa.ArrowException, OverflowError)) as r:
        ref_sql(stmt, catalog=ref_cat)
    assert not isinstance(r.value, RefDeltaError)
    with pytest.raises(InvalidArgumentError) as p:
        sql(stmt, catalog=cat)
    assert p.value.error_class == error_class
    assert _port_rows(cat.table("ty").path) == _ref_rows(
        ref_cat.table("ty").path)


# ------------------------------------------------------- DROP FEATURE ---

DROPS = [
    ("deletionVectors", DV, ["DELETE FROM {t} WHERE q >= 50"],
     "ALTER TABLE {t} DROP FEATURE deletionVectors TRUNCATE HISTORY"),
    ("checkConstraints", DV,
     ["ALTER TABLE {t} ADD CONSTRAINT c CHECK (id >= 0)",
      "ALTER TABLE {t} DROP CONSTRAINT c"],
     "ALTER TABLE {t} DROP FEATURE checkConstraints"),
    ("changeDataFeed", dict(DV, **{"delta.enableChangeDataFeed": "true"}),
     ["DELETE FROM {t} WHERE id < 3"],
     "ALTER TABLE {t} DROP FEATURE changeDataFeed"),
    ("columnMapping", MAPPED, [],
     "ALTER TABLE {t} DROP FEATURE `columnMapping` TRUNCATE HISTORY"),
    ("typeWidening", WIDENING, ["ALTER TABLE {t} CHANGE COLUMN q TYPE BIGINT"],
     "ALTER TABLE {t} DROP FEATURE typeWidening TRUNCATE HISTORY"),
]


def _protocol_and_conf(path, run, eng):
    d = run(f"DESCRIBE DETAIL '{path}'", engine=eng)
    return (d["minReaderVersion"], d["minWriterVersion"], d["tableFeatures"],
            d["properties"])


def _log_names(path) -> list:
    return sorted(f for f in os.listdir(os.path.join(path, "_delta_log"))
                  if f.endswith((".json", ".parquet")) and f[:20].isdigit())


@pytest.mark.parametrize("feature,props,setup,stmt", DROPS,
                         ids=[d[0] for d in DROPS])
def test_drop_feature_matches_reference(pair, feature, props, setup, stmt):
    ref_t, port_t = pair(props=props)
    for s in setup:
        _both(s, ref_t, port_t)
    try:
        r = ref_sql(stmt.format(t=f"'{ref_t}'"), engine=HOST)
    except RefDeltaError as e:
        # columnMapping: a fresh name-mode table's physical names differ
        # from its logical ones, so both refuse the drop
        with pytest.raises(DeltaError) as p:
            sql(stmt.format(t=f"'{port_t}'"), engine=CPU)
        assert p.value.error_class == e.error_class
        assert feature == "columnMapping"
    else:
        assert sql(stmt.format(t=f"'{port_t}'"), engine=CPU) == r
        assert feature not in _protocol_and_conf(port_t, sql, CPU)[2]
    assert _protocol_and_conf(port_t, sql, CPU) == _protocol_and_conf(
        ref_t, ref_sql, HOST)
    assert _commit(port_t) == _commit(ref_t)
    assert _port_rows(port_t) == _ref_rows(ref_t)
    # TRUNCATE HISTORY leaves the same log files (the checkpoint at the
    # head and what follows it)
    assert _log_names(port_t) == _log_names(ref_t)
    ops = [h["operation"] for h in sql(f"DESCRIBE HISTORY '{port_t}'",
                                       engine=CPU)]
    assert ops == [h["operation"] for h in ref_sql(
        f"DESCRIBE HISTORY '{ref_t}'", engine=HOST)]


def test_drop_feature_needs_truncation_and_no_constraint(pair):
    ref_t, port_t = pair(props=DV)
    for stmt in ("ALTER TABLE {t} DROP FEATURE deletionVectors",
                 "ALTER TABLE {t} ADD CONSTRAINT c CHECK (id >= 0)",
                 "ALTER TABLE {t} DROP FEATURE checkConstraints"):
        try:
            r = ref_sql(stmt.format(t=f"'{ref_t}'"), engine=HOST)
        except RefDeltaError as e:
            with pytest.raises(DeltaError) as p:
                sql(stmt.format(t=f"'{port_t}'"), engine=CPU)
            assert p.value.error_class == e.error_class
        else:
            assert sql(stmt.format(t=f"'{port_t}'"), engine=CPU) == r
    assert _protocol_and_conf(port_t, sql, CPU) == _protocol_and_conf(
        ref_t, ref_sql, HOST)


def test_drop_feature_without_a_writer_is_refused(tmp_path):
    """Row tracking has no writer in this package: its DROP FEATURE
    commits nothing and raises `UnsupportedTableError`, as any write to
    such a table does (`check_write_supported`). The reference refuses it
    too, for want of the domainMetadata feature its pre-downgrade needs."""
    ref_t, port_t = str(tmp_path / "ref"), str(tmp_path / "port")
    data = pa.table({"id": pa.array(np.arange(10), pa.int64())})
    for path in (ref_t, port_t):
        dta.write_table(path, data, engine=HOST,
                        properties={"delta.enableRowTracking": "true"})
    before = _log_names(port_t)
    with pytest.raises(UnsupportedTableError):
        sql(f"ALTER TABLE '{port_t}' DROP FEATURE rowTracking", engine=CPU)
    assert _log_names(port_t) == before
    with pytest.raises(RefDeltaError):
        ref_sql(f"ALTER TABLE '{ref_t}' DROP FEATURE rowTracking",
                engine=HOST)
    assert _log_names(ref_t) == before


# ----------------------------------------------------- CONVERT TO DELTA --

def _convert_source(root, partitioned: bool):
    """Parquet files written by pyarrow: two row groups a file, a group
    of nulls, long strings, every type whose stats the footer keeps; one
    file without statistics; Hive directories with a null and an escaped
    value when `partitioned`."""
    rng = np.random.default_rng(3)
    os.makedirs(root)
    dirs = ["grp=a", "grp=b%20c", "grp=__HIVE_DEFAULT_PARTITION__"] \
        if partitioned else [""]
    for k, sub in enumerate(dirs):
        n = 12
        ints = rng.integers(-1000, 1000, n)
        t = pa.table({
            "i32": pa.array(ints.astype(np.int32)),
            "i64": pa.array(ints * 10_000_000_000),
            "i16": pa.array(ints.astype(np.int16)),
            "f": pa.array(rng.normal(size=n)),
            "s": pa.array([None] * 6 + [("x" * 40 if i % 2 else "é")
                                        + str(i) for i in range(6)]),
            "d": pa.array(ints % 300, pa.int32()).cast(pa.date32()),
            "ts": pa.array(ints * 1_000_003, pa.timestamp("us", tz="UTC")),
            "ntz": pa.array(ints * 7, pa.timestamp("us")),
            "dec": pa.array([decimal.Decimal(int(x)) / 100 for x in ints],
                            pa.decimal128(7, 2)),
            "big": pa.array([decimal.Decimal(int(x)) for x in ints],
                            pa.decimal128(25, 0)),
            "b": pa.array(ints % 2 == 0),
            "bin": pa.array([bytes([65 + i % 3]) for i in range(n)]),
        })
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        pq.write_table(t, os.path.join(d, f"part-{k}.parquet"),
                       row_group_size=6)
        if k == 0:
            pq.write_table(t.slice(0, 3), os.path.join(d, "nostats.parquet"),
                           write_statistics=False)
    os.makedirs(os.path.join(root, "_hidden"))
    pq.write_table(t, os.path.join(root, "_hidden", "x.parquet"))
    with open(os.path.join(root, dirs[0], "notes.txt"), "w") as f:
        f.write("not data")


def _adds(path, decode: bool) -> list:
    """The CONVERT commit's schema, partition columns, protocol and adds.
    The port's log holds each path as a URI (`grp=b%2520c/...` for the
    directory `grp=b%20c`), the reference's the directory's name (C7's
    reference half): `decode` takes the port's back to the file's path."""
    with open(os.path.join(path, "_delta_log", f"{0:020d}.json")) as f:
        actions = [json.loads(line) for line in f]
    meta = next(a["metaData"] for a in actions if "metaData" in a)
    proto = next(a["protocol"] for a in actions if "protocol" in a)
    adds = sorted((unquote(a["add"]["path"]) if decode else a["add"]["path"],
                   json.dumps(a["add"]["partitionValues"]),
                   a["add"]["size"], a["add"]["stats"])
                  for a in actions if "add" in a)
    return [json.loads(meta["schemaString"]), meta["partitionColumns"],
            proto, adds]


@pytest.mark.parametrize("partitioned", [False, True],
                         ids=["flat", "partitioned"])
def test_convert_to_delta_matches_reference(tmp_path, partitioned):
    src = str(tmp_path / "src")
    _convert_source(src, partitioned)
    ref_t, port_t = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref_t)
    shutil.copytree(src, port_t)
    for a, b in zip(sorted(os.walk(ref_t)), sorted(os.walk(port_t))):
        for f in a[2]:  # the same mtimes, so the same modificationTime
            st = os.stat(os.path.join(a[0], f))
            os.utime(os.path.join(b[0], f), ns=(st.st_atime_ns,
                                                st.st_mtime_ns))
    clause = " PARTITIONED BY (grp string)" if partitioned else ""
    r = ref_sql(f"CONVERT TO DELTA parquet.`{ref_t}`{clause}", engine=HOST)
    p = sql(f"CONVERT TO DELTA parquet.`{port_t}`{clause}", engine=CPU)
    assert p == r == 0
    assert _adds(port_t, True) == _adds(ref_t, False)
    assert _commit(port_t) == _commit(ref_t)
    # the reference cannot read its own file under `grp=b%20c` (C8)
    assert _port_rows(port_t) == _source_rows(src)
    if not partitioned:
        assert _port_rows(port_t) == _ref_rows(ref_t)


def _source_rows(src) -> list:
    """The rows of the Parquet files under `src` as pyarrow reads them,
    each with its Hive directory's partition value."""
    rows = []
    for dirpath, dirs, files in os.walk(src):
        dirs[:] = [d for d in dirs if not d.startswith("_")]
        part = {}
        rel = os.path.relpath(dirpath, src)
        if "=" in rel:
            k, _, v = rel.partition("=")
            part[k] = None if v == "__HIVE_DEFAULT_PARTITION__" \
                else unquote(v)
        for name in files:
            if name.endswith(".parquet"):
                for r in pq.read_table(os.path.join(dirpath, name)) \
                        .to_pylist():
                    r.update(part)
                    rows.append(tuple(sorted((k, _norm(v))
                                             for k, v in r.items())))
    return sorted(rows, key=repr)


# ----------------------------------------- GENERATE and the manifests ---

def _manifests(path) -> dict:
    root = os.path.join(path, "_symlink_format_manifest")
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            with open(os.path.join(dirpath, name)) as f:
                out[os.path.relpath(os.path.join(dirpath, name), path)] = \
                    f.read().replace(path, "<root>")
    return out


def test_generate_manifests_match_reference(tmp_path):
    src = str(tmp_path / "src")
    _write_pair(src, str(tmp_path / "unused"), partition_by=["grp"])
    ref_t, port_t = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref_t)
    shutil.copytree(src, port_t)
    stmt = "GENERATE symlink_format_manifest FOR TABLE {t}"
    r, p = _both(stmt, ref_t, port_t)
    assert _fields(p, ref_t, port_t) == _fields(r, ref_t, port_t)
    assert _manifests(port_t) == _manifests(ref_t)
    assert len(_manifests(port_t)) == 3
    # a partition emptied: its manifest goes at the next GENERATE
    _both("DELETE FROM {t} WHERE grp = 'b'", ref_t, port_t)
    r, p = _both(stmt, ref_t, port_t)
    assert _fields(p, ref_t, port_t) == _fields(r, ref_t, port_t)
    assert _manifests(port_t) == _manifests(ref_t)
    assert len(_manifests(port_t)) == 2


def test_symlink_manifest_hook_matches_reference(pair, monkeypatch):
    ref_t, port_t = pair(partition_by=["grp"])
    on = ("ALTER TABLE {t} SET TBLPROPERTIES "
          "('delta.compatibility.symlinkFormatManifest.enabled' = 'true')")
    for stmt in (on, "INSERT INTO {t} VALUES (500, 'z', 1.0, 1, 'n', 18300)",
                 "DELETE FROM {t} WHERE grp = 'a'"):
        _both(stmt, ref_t, port_t)
        got, want = _manifests(port_t), _manifests(ref_t)
        assert sorted(got) == sorted(want)
        assert {k: v.count("\n") for k, v in got.items()} == \
            {k: v.count("\n") for k, v in want.items()}
    # after a full GENERATE the manifests name exactly the live files
    _both("GENERATE symlink_format_manifest FOR TABLE {t}", ref_t, port_t)
    assert sorted(_manifests(port_t)) == sorted(_manifests(ref_t))
    snap_files = {f"<root>/{a.path}" for a in Table.for_path(
        port_t, engine=CPU).latest_snapshot().state.add_files}
    listed = {line for v in _manifests(port_t).values()
              for line in v.splitlines()}
    assert listed == snap_files
    # the hook is critical: its failure is raised after the commit stands

    def fail(*args, **kw):
        raise OSError("manifest store unavailable")

    monkeypatch.setattr(ref_generate, "incremental_symlink_manifest_hook",
                        fail)
    monkeypatch.setattr(port_generate, "incremental_symlink_manifest_hook",
                        fail)
    stmt = "INSERT INTO {t} VALUES (501, 'y', 1.0, 1, 'n', 18300)"
    with pytest.raises(Exception) as r:
        ref_sql(stmt.format(t=f"'{ref_t}'"), engine=HOST)
    with pytest.raises(PostCommitHookError) as p:
        sql(stmt.format(t=f"'{port_t}'"), engine=CPU)
    assert p.value.error_class == r.value.error_class
    assert p.value.version == r.value.version
    assert _port_rows(port_t) == _ref_rows(ref_t)


# -------------------------------------------- the card's step on the CPU --

def test_chip_sql_statements_phase_passes_on_the_cpu(tmp_path):
    """`chip_smoke.py`'s step 27 at scale 12,000 on `TorchEngine("cpu")`:
    every statement against the generator's numpy truth, the CPU's
    launches 0."""
    import chip_smoke
    from delta_tpu_torch.utils.tpcds import generate, load_delta

    tabs = generate(12_000)
    keep = {k: tabs[k] for k in ("store_sales", "store_returns")}
    root = str(tmp_path / "sf")
    load_delta(root, tables=keep, engine=CPU)
    out = chip_smoke.sql_statements_phase(root, keep["store_sales"],
                                          keep["store_returns"], "cpu",
                                          "cpu")
    assert len(out["steps"]) == 18
    assert set(out["launches"].values()) == {0}

"""CHECK constraints and generated, identity and default columns: the
port against the JAX package.

Every comparison is exact, floats included (rows as multisets of Python
values compared by `repr`; commits without timestamps, file names and
byte counts). The reference writes a table from a numpy seed, which is
copied; each package runs the same operation on its own copy, and each
package reads both copies:

- ADD CONSTRAINT (a plain, a deletion-vector and a name-mapped table):
  the commit, the protocol upgrade to checkConstraints, the stored SQL;
  the refusals (an existing row violates, a NULL result violates, a
  non-boolean body, a name that exists), each with the reference's error
  class and nothing committed; DROP CONSTRAINT with and without
  `if_exists`;
- every write path refuses a violating row before any file is written:
  append, overwrite, `replace_where`, dynamic partition overwrite,
  `merge_schema`, DELETE's and UPDATE's copies, MERGE, OPTIMIZE and REORG
  (a constraint set by SET TBLPROPERTIES, which checks no row, lets the
  rewrites meet violating rows);
- generated, identity (positive and negative `step`,
  `allowExplicitInsert`) and default columns through `write_table`: the
  values, the watermark in each commit's metadata, the protocol; the
  refusals (a supplied generated value that differs, an explicit
  identity value); `validate_generated_schema`'s rules on a new table;
- two writes racing on an identity column: the later loses with
  MetadataChangedError in both packages;
- MERGE and UPDATE on such a table. The reference leaves an inserted
  row's identity, generated and default columns NULL and a generated
  column stale after an UPDATE of what it reads; the port computes them,
  as Delta does (ROADMAP C24, `_REFERENCE_LEAVES_GENERATED_NULL`): the
  port's rows are held to values computed here, and each package reads
  the other's table. C24's smaller differences are pinned too: the
  reference's writer raises a bare KeyError for a CHECK column the rows
  leave out (the port reads it as NULL), and it calls CHECK (TRUE)
  non-boolean.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.alter as ref_alter
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.merge as ref_merge
import delta_tpu.commands.optimize as ref_opt  # noqa: F401 (Table.optimize)
import delta_tpu.commands.reorg as ref_reorg
import delta_tpu.constraints as ref_con
import delta_tpu.colgen as ref_colgen
import delta_tpu.expressions.tree as RE
import delta_tpu.models.schema as ref_schema
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefError
from delta_tpu.models.schema import schema_to_json as ref_schema_to_json
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.table import Table as RefTable
from delta_tpu.txn.transaction import Operation as RefOperation
from delta_tpu.write.writer import write_data_files as ref_write_files
import delta_tpu_torch.api as pta
import delta_tpu_torch.colgen as port_colgen
import delta_tpu_torch.commands.alter as port_alter
import delta_tpu_torch.commands.dml as port_dml
import delta_tpu_torch.commands.merge as port_merge
import delta_tpu_torch.commands.reorg as port_reorg
import delta_tpu_torch.constraints as port_con
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.errors import DeltaError
from delta_tpu_torch.models.schema import (
    StructField,
    StructType,
    schema_from_json,
    schema_to_json,
)
from delta_tpu_torch.txn.transaction import Operation
from delta_tpu_torch.write.writer import write_data_files
from test_torch_wide_types import port_rows, same_rows
from test_torch_wide_write import to_port
from test_torch_write_modes import _summary, _version

CPU = TorchEngine("cpu")
NAME = {"delta.columnMapping.mode": "name"}
DV = {"delta.enableDeletionVectors": "true"}
# the reference's MERGE and UPDATE leave generated, identity and default
# columns NULL or stale (ROADMAP C24)
_REFERENCE_LEAVES_GENERATED_NULL = True
# its writer cannot evaluate a CHECK column the rows leave out (a bare
# KeyError), and its empty-batch probe types a bare literal as null, so
# CHECK (TRUE) is non-boolean there (both in C24's entry)
_REFERENCE_RAISES_ON_A_MISSING_CHECK_COLUMN = True
_REFERENCE_REFUSES_A_LITERAL_CHECK = True


def _arrow(ids, seed=0) -> pa.Table:
    ids = np.asarray(ids, np.int64)
    rng = np.random.default_rng(seed + (abs(int(ids[0])) if len(ids) else 0))
    return pa.table({
        "id": pa.array(ids),
        "v": pa.array(rng.normal(size=len(ids)).round(3) + 2.0,
                      mask=ids % 11 == 5),
        "p": pa.array([["u", "w"][i % 2] for i in ids]),
    })


def _copies(tmp_path, props=None, appends=((0, 30), (30, 60)),
            partition_by=None):
    src = str(tmp_path / "src")
    for i, (lo, hi) in enumerate(appends):
        dta.write_table(src, _arrow(range(lo, hi)), engine=HostEngine(),
                        properties=props if i == 0 else None,
                        partition_by=partition_by if i == 0 else None)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port


def _rt(path):
    clear_parse_cache()
    return RefTable.for_path(path, engine=HostEngine())


def _pt(path):
    return Table.for_path(path, engine=CPU)


def ref_read(path, **kw) -> list:
    clear_parse_cache()
    return dta.read_table(path, engine=HostEngine(), **kw).to_pylist()


def port_read(path, **kw) -> list:
    return port_rows(pta.read_table(path, engine=CPU, **kw))


def _by_name(rows: list) -> list:
    """Rows with their columns in name order (the reference reads a file's
    columns in the file's order)."""
    return [dict(sorted(r.items())) for r in rows]


def _both_read(ref, port, want=None) -> list:
    """Both packages read both copies to the reference's read of its own
    (or to `want`)."""
    want = _by_name(ref_read(ref) if want is None else want)
    for got in (port_read(ref), port_read(port), ref_read(port)):
        assert same_rows(_by_name(got), want)
    return want


def _outcome(fn):
    try:
        return "ok", fn()
    except (RefError, DeltaError) as e:
        return "error", (type(e).__name__, e.error_class)


def _same_outcome(ref_fn, port_fn):
    r, p = _outcome(ref_fn), _outcome(port_fn)
    assert r[0] == p[0], (r, p)
    if r[0] == "error":
        assert r[1] == p[1], (r, p)
    return p


def _meta_of(path, version):
    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        acts = [json.loads(ln) for ln in f if ln.strip()]
    return next((a["metaData"] for a in acts if "metaData" in a), None)


# ------------------------------------------------ ADD / DROP CONSTRAINT --

@pytest.mark.parametrize("kind", ["plain", "dv", "mapped"])
def test_add_and_drop_constraint(tmp_path, kind):
    props = {"plain": None, "dv": DV, "mapped": NAME}[kind]
    ref, port = _copies(tmp_path, props)
    if kind == "dv":  # deleted rows would violate: they are not live
        for fn, T, E in ((ref_dml.delete, _rt(ref), RE),
                         (port_dml.delete, _pt(port), PE)):
            fn(T, E.col("id") < E.lit(7))
    lo = -1 if kind != "dv" else 6
    body = f"id > {lo} AND (v IS NULL OR v > -100.0)"
    kind_ok = _same_outcome(
        lambda: ref_con.add_constraint(_rt(ref), "Sane", body),
        lambda: port_con.add_constraint(_pt(port), "Sane", body))
    v = kind_ok[1]
    assert _summary(ref, v, set()) == _summary(port, v, set())
    meta = _meta_of(port, v)
    assert meta["configuration"]["delta.constraints.sane"] == \
        "(id > %d AND (v IS NULL OR v > -100.0))" % lo
    clear_parse_cache()
    proto = _pt(port).latest_snapshot().protocol
    assert "checkConstraints" in (proto.writerFeatures or []) or \
        proto.minWriterVersion >= 3
    # refusals: nothing committed
    for name, expr, want in (
            ("sane", "id > 0", "DELTA_CONSTRAINT_ALREADY_EXISTS"),
            ("big", "id < 10", "DELTA_NEW_CHECK_CONSTRAINT_VIOLATION"),
            ("nulls", "v > -100.0", "DELTA_NEW_CHECK_CONSTRAINT_VIOLATION"),
            ("num", "v", "DELTA_NON_BOOLEAN_CHECK_CONSTRAINT"),
            ("text", "p", "DELTA_NON_BOOLEAN_CHECK_CONSTRAINT")):
        out = _same_outcome(
            lambda: ref_con.add_constraint(_rt(ref), name, expr),
            lambda: port_con.add_constraint(_pt(port), name, expr))
        assert out == ("error", (out[1][0], want)), (name, out)
        assert _version(port) == v
    _both_read(ref, port)
    # DROP CONSTRAINT
    out = _same_outcome(lambda: ref_con.drop_constraint(_rt(ref), "nope"),
                        lambda: port_con.drop_constraint(_pt(port), "nope"))
    assert out[1] == ("ConstraintNotFoundError",
                      "DELTA_CONSTRAINT_DOES_NOT_EXIST")
    assert port_con.drop_constraint(_pt(port), "nope", if_exists=True) == v
    rv = ref_con.drop_constraint(_rt(ref), "SANE")
    pv = port_con.drop_constraint(_pt(port), "SANE")
    assert rv == pv == v + 1
    assert _summary(ref, rv, set()) == _summary(port, pv, set())
    assert not any(k.startswith("delta.constraints.")
                   for k in _meta_of(port, pv)["configuration"])


def test_constraint_binds_the_writes_and_cross_reads(tmp_path):
    ref, port = _copies(tmp_path, NAME)
    _same_outcome(lambda: ref_con.add_constraint(_rt(ref), "pos", "id >= 0"),
                  lambda: port_con.add_constraint(_pt(port), "pos",
                                                  "id >= 0"))
    ok = _arrow(range(100, 110))
    assert dta.write_table(ref, ok, engine=HostEngine()) == \
        pta.write_table(port, to_port(ok), engine=CPU)
    bad = _arrow([-5, 200])
    out = _same_outcome(
        lambda: dta.write_table(ref, bad, engine=HostEngine()),
        lambda: pta.write_table(port, to_port(bad), engine=CPU))
    assert out[1] == ("InvariantViolationError",
                      "DELTA_VIOLATE_CONSTRAINT_WITH_VALUES")
    assert _version(port) == _version(ref)
    _both_read(ref, port)
    # a table the port writes with the constraint in its properties
    p2 = str(tmp_path / "p2")
    pta.write_table(p2, to_port(ok), engine=CPU,
                    properties={"delta.constraints.pos": "id >= 0"})
    clear_parse_cache()
    assert _rt(p2).latest_snapshot().protocol.minWriterVersion == 3
    with pytest.raises(RefError) as e:
        dta.write_table(p2, bad, engine=HostEngine())
    assert e.value.error_class == "DELTA_VIOLATE_CONSTRAINT_WITH_VALUES"


WRITE_PATHS = ["append", "overwrite", "replace_where", "dynamic",
               "merge_schema", "delete_copy", "update", "update_copy",
               "merge", "optimize", "reorg"]


@pytest.mark.parametrize("path_kind", WRITE_PATHS)
def test_every_write_path_refuses_a_violating_row(tmp_path, path_kind):
    """`id < 1000` set by SET TBLPROPERTIES (which checks no row) after a
    file of ids 5000 and 5001 was written: every path that writes a
    violating row raises DELTA_VIOLATE_CONSTRAINT_WITH_VALUES before any
    file is written, as the reference's writer does."""
    props = DV if path_kind == "reorg" else None
    ref, port = _copies(tmp_path, props, appends=((0, 30), (30, 60),
                                                  (5000, 5002)),
                        partition_by=["p"] if path_kind == "dynamic"
                        else None)
    if path_kind == "reorg":  # a DV on the violating rows' file
        for fn, T, E in ((ref_dml.delete, _rt(ref), RE),
                         (port_dml.delete, _pt(port), PE)):
            fn(T, E.col("id") == E.lit(5001))
    con = {"delta.constraints.small": "id < 1000"}
    assert ref_alter.set_properties(_rt(ref), con) == \
        port_alter.set_properties(_pt(port), con)
    v = _version(port)
    before = sorted(os.listdir(port))
    bad = _arrow([1, 2000])

    def run(pkg):
        is_ref = pkg == "ref"
        path, E = (ref, RE) if is_ref else (port, PE)

        def write(d, **kw):
            if is_ref:
                return dta.write_table(path, d, engine=HostEngine(), **kw)
            return pta.write_table(path, to_port(d), engine=CPU, **kw)
        T = _rt(path) if is_ref else _pt(path)
        dml = ref_dml if is_ref else port_dml
        if path_kind == "append":
            return write(bad)
        if path_kind == "overwrite":
            return write(bad, mode="overwrite")
        if path_kind == "replace_where":
            return write(bad, mode="overwrite",
                         replace_where=E.col("id") >= E.lit(0))
        if path_kind == "dynamic":
            return write(bad, mode="overwrite",
                         partition_overwrite_mode="dynamic")
        if path_kind == "merge_schema":
            return write(bad.append_column("extra", pa.array([1, 2])),
                         merge_schema=True)
        if path_kind == "delete_copy":  # the file's other row is copied
            return dml.delete(T, E.col("id") == E.lit(5001))
        if path_kind == "update":
            return dml.update(T, {"id": 3000}, E.col("id") == E.lit(3))
        if path_kind == "update_copy":
            return dml.update(T, {"v": 1.0}, E.col("id") == E.lit(5001))
        if path_kind == "merge":
            m = ref_merge if is_ref else port_merge
            return m.merge(T, bad if is_ref else to_port(bad),
                           on=E.col("target.id") == E.col("source.id")) \
                .when_matched_update_all() \
                .when_not_matched_insert_all().execute()
        if path_kind == "optimize":
            return T.optimize().execute_compaction()
        return (ref_reorg if is_ref else port_reorg).reorg_purge(T)

    out = _same_outcome(lambda: run("ref"), lambda: run("port"))
    assert out == ("error", ("InvariantViolationError",
                             "DELTA_VIOLATE_CONSTRAINT_WITH_VALUES")), out
    assert _version(port) == v
    if path_kind not in ("delete_copy", "update", "update_copy"):
        # DELETE and UPDATE write file by file, as the reference's do
        assert sorted(os.listdir(port)) == before
    _both_read(ref, port)


def test_null_results_violate(tmp_path):
    """The reference's NULL rule: a constraint whose value is NULL on a
    row rejects it (`evaluate_predicate_host` fills NULL with False), on
    ADD CONSTRAINT and on a write."""
    ref, port = _copies(tmp_path, appends=((0, 4),))  # no NULL v yet
    _same_outcome(lambda: ref_con.add_constraint(_rt(ref), "vpos", "v > 0"),
                  lambda: port_con.add_constraint(_pt(port), "vpos",
                                                  "v > 0"))
    nulls = _arrow([5, 6])  # id 5: v NULL
    out = _same_outcome(
        lambda: dta.write_table(ref, nulls, engine=HostEngine()),
        lambda: pta.write_table(port, to_port(nulls), engine=CPU))
    assert out[1][1] == "DELTA_VIOLATE_CONSTRAINT_WITH_VALUES"
    # a column the rows leave out reads as NULL in the port; the
    # reference cannot evaluate it at all
    with pytest.raises(DeltaError) as e:
        pta.write_table(port, {"id": np.array([9])}, engine=CPU)
    assert e.value.error_class == "DELTA_VIOLATE_CONSTRAINT_WITH_VALUES"
    if _REFERENCE_RAISES_ON_A_MISSING_CHECK_COLUMN:
        with pytest.raises(KeyError):
            dta.write_table(ref, pa.table({"id": pa.array([9])}),
                            engine=HostEngine())
    _both_read(ref, port)
    # CHECK (TRUE): boolean in the port, null-typed in the reference
    v = port_con.add_constraint(_pt(port), "always", "TRUE")
    assert _meta_of(port, v)["configuration"][
        "delta.constraints.always"] == "TRUE"
    if _REFERENCE_REFUSES_A_LITERAL_CHECK:
        with pytest.raises(RefError) as e:
            ref_con.add_constraint(_rt(ref), "always", "TRUE")
        assert e.value.error_class == "DELTA_NON_BOOLEAN_CHECK_CONSTRAINT"


# ------------------------------- generated, identity and default columns --

def _schema(pkg: str, start=1, step=1, allow=False):
    """id identity; k long; v double; pos = v >= 2.0; kk = k; ch default
    'store'; n integer default 7."""
    if pkg == "ref":
        L, D, B, S, I = (ref_schema.PrimitiveType(t) for t in (
            "long", "double", "boolean", "string", "integer"))
        cg, F, T = ref_colgen, ref_schema.StructField, ref_schema.StructType
    else:
        L, D, B, S, I = "long", "double", "boolean", "string", "integer"
        cg, F, T = port_colgen, StructField, StructType
    return T([cg.identity_field("id", start, step, allow), F("k", L),
              F("v", D), cg.generated_field("pos", B, "v >= 2.0"),
              cg.generated_field("kk", L, "k"),
              cg.default_field("ch", S, "'store'"),
              cg.default_field("n", I, "7")])


def _gen_rows(lo, hi, **extra) -> pa.Table:
    k = np.arange(lo, hi, dtype=np.int64)
    cols = {"k": pa.array(k),
            "v": pa.array(np.where(k % 2 == 0, 3.5, 1.25),
                          mask=k % 5 == 4)}
    cols.update(extra)
    return pa.table(cols)


def _write_new_both(tmp_path, schema_kw=None, **kw):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    first = _gen_rows(0, 5)
    out = _same_outcome(
        lambda: dta.write_table(ref, first, engine=HostEngine(),
                                schema=_schema("ref", **(schema_kw or {})),
                                **kw),
        lambda: pta.write_table(port, to_port(first), engine=CPU,
                                schema=_schema("port", **(schema_kw or {})),
                                **kw))
    assert out == ("ok", 0)
    assert _summary(ref, 0, set()) == _summary(port, 0, set())
    return ref, port


def _expected(k_values, ids, extra=None) -> list:
    out = []
    for k, i in zip(k_values, ids):
        v = None if k % 5 == 4 else (3.5 if k % 2 == 0 else 1.25)
        out.append(dict({"id": i, "k": k, "v": v,
                         "pos": None if v is None else v >= 2.0, "kk": k,
                         "ch": "store", "n": 7}, **(extra or {})))
    return out


def _watermark(path, version):
    meta = _meta_of(path, version)
    if meta is None:
        return None
    return json.loads(meta["schemaString"])["fields"][0]["metadata"].get(
        "delta.identity.highWaterMark")


def _row_order(rows):
    names = ["id", "k", "v", "pos", "kk", "ch", "n"]
    return [{c: r[c] for c in names} for r in rows]


@pytest.mark.parametrize("start,step", [(1, 1), (100, 7), (-3, -2)])
def test_identity_generated_and_default_columns(tmp_path, start, step):
    ref, port = _write_new_both(tmp_path, {"start": start, "step": step})
    ids = [start + step * i for i in range(5)]
    assert _watermark(port, 0) == ids[-1]
    for lo, hi in ((5, 9), (9, 10)):
        rows = _gen_rows(lo, hi)
        rv = dta.write_table(ref, rows, engine=HostEngine())
        pv = pta.write_table(port, to_port(rows), engine=CPU)
        assert rv == pv
        assert _summary(ref, rv, set()) == _summary(port, pv, set())
        ids += [ids[-1] + step * (i + 1) for i in range(hi - lo)]
        assert _watermark(port, pv) == ids[-1]
    want = _expected(list(range(10)), ids)
    got = _both_read(ref, port)
    assert same_rows(_row_order(got), want)
    assert len({r["id"] for r in got}) == 10
    # an empty append moves no watermark
    empty = _gen_rows(0, 0)
    pv = pta.write_table(port, to_port(empty), engine=CPU)
    assert dta.write_table(ref, empty, engine=HostEngine()) == pv
    assert _summary(ref, pv, set()) == _summary(port, pv, set())
    assert _meta_of(port, pv) is None
    clear_parse_cache()
    assert _rt(port).latest_snapshot().protocol.writerFeatures == [
        "allowColumnDefaults", "generatedColumns", "identityColumns"]


@pytest.mark.parametrize("allow", [False, True])
def test_supplied_identity_generated_and_default_values(tmp_path, allow):
    ref, port = _write_new_both(tmp_path, {"allow": allow})
    cases = [
        # explicit identity values
        _gen_rows(5, 7, id=pa.array([50, 51], pa.int64())),
        # a supplied generated value that differs, then one that agrees
        _gen_rows(7, 9, kk=pa.array([7, 99], pa.int64())),
        _gen_rows(7, 9, kk=pa.array([7, 8], pa.int64()),
                  pos=pa.array([False, True])),
        # a supplied generated NULL: a mismatch even where the value is
        # NULL too (v NULL at k = 9)
        _gen_rows(9, 10, pos=pa.array([None], pa.bool_())),
        # a supplied default column keeps its values
        _gen_rows(10, 12, ch=pa.array(["web", None])),
    ]
    outs = []
    for rows in cases:
        outs.append(_same_outcome(
            lambda: dta.write_table(ref, rows, engine=HostEngine()),
            lambda: pta.write_table(port, to_port(rows), engine=CPU)))
        if outs[-1][0] == "ok":
            v = outs[-1][1]
            assert _summary(ref, v, set()) == _summary(port, v, set())
    assert outs[0] == (("ok", 1) if allow else (
        "error", ("IdentityColumnError",
                  "DELTA_IDENTITY_COLUMNS_EXPLICIT_INSERT_NOT_SUPPORTED")))
    assert outs[1][1] == ("InvariantViolationError",
                          "DELTA_GENERATED_COLUMNS_EXPR_TYPE_MISMATCH")
    assert outs[2][0] == "ok" and outs[4][0] == "ok"
    assert outs[3][1][1] == "DELTA_GENERATED_COLUMNS_EXPR_TYPE_MISMATCH"
    got = _both_read(ref, port)
    assert sorted(r["ch"] or "" for r in got if r["k"] >= 10) == ["", "web"]


BAD_SCHEMAS = {
    "identity_generated": (lambda cg, F, T: F(
        "id", T("long"), True, {"delta.identity.start": 1,
                                "delta.identity.step": 1,
                                "delta.generationExpression": "k"}), None,
        "DELTA_IDENTITY_COLUMNS_WITH_GENERATED_EXPRESSION"),
    "identity_partition": (lambda cg, F, T: cg.identity_field("id"), ["id"],
                           "DELTA_IDENTITY_COLUMNS_PARTITION_NOT_SUPPORTED"),
    "identity_string": (lambda cg, F, T: F(
        "id", T("string"), True, {"delta.identity.start": 1,
                                  "delta.identity.step": 1}), None,
        "DELTA_IDENTITY_COLUMNS_UNSUPPORTED_DATA_TYPE"),
    "unparsable": (lambda cg, F, T: F(
        "id", T("long"), True, {"delta.generationExpression": "k + 1"}),
        None, "DELTA_UNSUPPORTED_EXPRESSION_GENERATED_COLUMN"),
    "missing_reference": (lambda cg, F, T: cg.generated_field(
        "id", T("boolean"), "zzz > 1"), None,
        "DELTA_INVALID_GENERATED_COLUMN_REFERENCES"),
    "generated_reference": (lambda cg, F, T: cg.generated_field(
        "id", T("long"), "kk"), None,
        "DELTA_INVALID_GENERATED_COLUMN_REFERENCES"),
}


@pytest.mark.parametrize("case", list(BAD_SCHEMAS))
def test_validate_generated_schema(tmp_path, case):
    make, part, want = BAD_SCHEMAS[case]
    outs = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            cg, F, T = (ref_colgen, ref_schema.StructField,
                        ref_schema.PrimitiveType)
            S = ref_schema.StructType
        else:
            cg, F, T, S = port_colgen, StructField, (lambda t: t), StructType
        schema = S([make(cg, F, T), F("k", T("long")),
                    cg.generated_field("kk", T("long"), "k")])
        path = str(tmp_path / pkg)
        rows = pa.table({"k": pa.array([1], pa.int64())})
        if pkg == "ref":
            outs.append(_outcome(lambda: dta.write_table(
                path, rows, engine=HostEngine(), schema=schema,
                partition_by=part)))
            outs.append(_outcome(lambda: ref_colgen.validate_generated_schema(
                schema, part or ())))
        else:
            outs.append(_outcome(lambda: pta.write_table(
                path, to_port(rows), engine=CPU, schema=schema,
                partition_by=part)))
            outs.append(_outcome(lambda: port_colgen.validate_generated_schema(
                schema, part or ())))
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert outs[2][1][1] == outs[3][1][1] == want
    assert not os.path.exists(str(tmp_path / "port" / "_delta_log"))
    for cg in (ref_colgen, port_colgen):
        with pytest.raises(Exception) as e:
            cg.identity_field("x", step=0)
        assert e.value.error_class == "DELTA_IDENTITY_COLUMNS_ILLEGAL_STEP"


def test_concurrent_identity_writes_conflict(tmp_path):
    """Two writes to an identity column from one snapshot: each stages
    its moved watermark; the later commit loses with
    MetadataChangedError, in both packages."""
    ref, port = _write_new_both(tmp_path)
    names = []
    for pkg, path in (("ref", ref), ("port", port)):
        if pkg == "ref":
            t = _rt(path)
            txn = t.create_transaction_builder(RefOperation.WRITE).build()
            meta = txn.metadata()
            data, moved = ref_colgen.apply_column_generation(
                _gen_rows(5, 8), meta.schema)
            txn.update_metadata(dataclasses.replace(
                meta, schemaString=ref_schema_to_json(moved)))
            txn.add_files(ref_write_files(
                engine=t.engine, table_path=t.path, data=data,
                schema=moved, partition_columns=[],
                configuration=meta.configuration))
            dta.write_table(path, _gen_rows(8, 9), engine=HostEngine())
        else:
            t = _pt(path)
            txn = t.create_transaction_builder(Operation.WRITE).build()
            meta = txn.metadata()
            data, moved = port_colgen.apply_column_generation(
                to_port(_gen_rows(5, 8)), schema_from_json(meta.schemaString))
            txn.update_metadata(dataclasses.replace(
                meta, schemaString=schema_to_json(moved)))
            txn.add_files(write_data_files(t.engine, t.path, data, moved,
                                           [], meta.configuration))
            pta.write_table(path, to_port(_gen_rows(8, 9)), engine=CPU)
        with pytest.raises(Exception) as e:
            txn.commit()
        names.append((type(e.value).__name__, e.value.error_class))
    assert names[0] == names[1]
    assert names[1][0] == "MetadataChangedError"
    got = _both_read(ref, port)
    assert sorted(r["id"] for r in got) == list(range(1, 7))


def test_merge_and_update_compute_generated_values(tmp_path):
    """MERGE inserts and UPDATE on a table with generated, identity and
    default columns. The port fills an inserted row's identity (from the
    watermark, moved in the MERGE's commit), generated and default
    columns, and computes a generated column again where an UPDATE or a
    MERGE update changes what it reads; the reference leaves them NULL or
    stale (C24). Each package reads the other's table."""
    ref, port = _write_new_both(tmp_path, {"start": 10, "step": 5})
    src = _gen_rows(3, 8)  # k 3, 4 match; 5, 6, 7 insert
    for pkg in ("ref", "port"):
        m, E, T = ((ref_merge, RE, _rt(ref)) if pkg == "ref"
                   else (port_merge, PE, _pt(port)))
        s = src if pkg == "ref" else to_port(src)
        m.merge(T, s, on=E.col("target.k") == E.col("source.k")) \
            .when_matched_update(set={"v": E.lit(9.5)}) \
            .when_not_matched_insert(values={
                "k": E.col("source.k"), "v": E.col("source.v")}).execute()
    assert _watermark(port, 1) == 45
    want = _expected([0, 1, 2], [10, 15, 20]) + [
        dict(r, v=9.5, pos=True) for r in _expected([3, 4], [25, 30])] \
        + _expected([5, 6, 7], [35, 40, 45])
    assert same_rows(_row_order(port_read(port)), want)
    assert same_rows(_row_order(ref_read(port)), want)
    got_ref = {r["k"]: r for r in port_read(ref)}
    if _REFERENCE_LEAVES_GENERATED_NULL:
        assert [got_ref[k]["id"] for k in (5, 6, 7)] == [None] * 3
        # stale: v was 1.25 and NULL
        assert [got_ref[k]["pos"] for k in (3, 4)] == [False, None]
        assert _watermark(ref, 1) is None
    # UPDATE of v: pos computed again; kk and the identity kept
    for pkg in ("ref", "port"):
        dml, E, T = ((ref_dml, RE, _rt(ref)) if pkg == "ref"
                     else (port_dml, PE, _pt(port)))
        dml.update(T, {"v": 9.0}, E.col("k") < E.lit(2))
    for r in want:
        if r["k"] < 2:
            r.update(v=9.0, pos=True)
    assert same_rows(_row_order(port_read(port)), want)
    assert same_rows(_row_order(ref_read(port)), want)
    # an UPDATE that assigns a generated column a wrong value is refused
    out = _outcome(lambda: port_dml.update(_pt(port), {"kk": 5},
                                           PE.col("k") == PE.lit(0)))
    assert out[1] == ("InvariantViolationError",
                      "DELTA_GENERATED_COLUMNS_EXPR_TYPE_MISMATCH")
    # UPDATE and MERGE may not set the identity column
    for fn in (lambda: port_dml.update(_pt(port), {"id": 1}),
               lambda: port_merge.merge(
                   _pt(port), to_port(src),
                   on=PE.col("target.k") == PE.col("source.k"))
               .when_matched_update(set={"id": PE.lit(1)}).execute(),
               lambda: port_merge.merge(
                   _pt(port), to_port(src.append_column(
                       "id", pa.array(range(5), pa.int64()))),
                   on=PE.col("target.k") == PE.col("source.k"))
               .when_matched_update_all().execute()):
        assert _outcome(fn)[1][1] == \
            "DELTA_IDENTITY_COLUMNS_UPDATE_NOT_SUPPORTED"

"""Type widening and MERGE's schema evolution: the port against the JAX
package.

Every comparison is exact, floats included (rows as multisets of Python
values compared by `repr`). The reference writes a table with
`delta.enableTypeWidening` (two files of the narrow type, from a numpy
seed), which is copied; each package runs the same operations on its own
copy:

- CHANGE COLUMN TYPE along every chain of `can_widen` (byte, short and
  integer to the wider integers and double, float to double, date to
  timestamp_ntz, decimal(p,s) to a wider decimal): the commits agree
  (operation, parameters, protocol, metadata); an append of the wide type
  with values past the narrow range; both packages read both copies to the
  reference's own read; filters that hit the narrow files' exact bounds
  (`=`, `<`, `<=`, `>`, `>=` against the old max and min) return exactly
  the rows a Python filter of the known rows keeps, in both packages, so
  no file whose old-typed stats bound a match is skipped;
  (The reference may skip a decimal file that holds a match: C12, held
  apart by `_REFERENCE_SKIPS_A_MATCH`.)
- a checkpoint written before the change (struct stats too) is read back
  after it, and one written after it types `stats_parsed` by the new
  schema, in both packages' checkpoints;
- the error classes: a narrowing or cross-kind change
  (DELTA_CANNOT_CHANGE_DATA_TYPE), a table without the flag
  (DELTA_TYPE_WIDENING_DISABLED), a missing column; nothing committed;
- a column-mapped table, a widened partition column (integer to long; a
  date partition read as timestamp_ntz), and the flag set by SET
  TBLPROPERTIES (the protocol upgrade in the same commit);
- MERGE `with_schema_evolution()` with a `*` clause and with an explicit
  assignment, on a plain, a partitioned and a name-mapped table: the new
  columns in sorted order, mapped on the mapped table, NULL in the rows
  written before; an evolution with nothing touched commits the metadata
  alone.
"""

import datetime as dt
import decimal
import glob
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.alter as ref_alter
import delta_tpu.commands.merge as ref_merge
import delta_tpu.expressions.tree as RE
import delta_tpu.models.schema as ref_schema
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefError
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.api as pta
import delta_tpu_torch.commands.alter as port_alter
import delta_tpu_torch.commands.merge as port_merge
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.errors import DeltaError
from test_torch_wide_types import port_rows, same_rows
from test_torch_wide_write import to_port
from test_torch_write_modes import (
    KINDS,
    _base,
    _same_commit,
    _same_rows,
    _summary,
    _version,
)

CPU = TorchEngine("cpu")
WIDEN = {"delta.enableTypeWidening": "true"}
STRUCT_STATS = {"delta.checkpoint.writeStatsAsStruct": "true"}
ARROW = {"byte": pa.int8(), "short": pa.int16(), "integer": pa.int32(),
         "long": pa.int64(), "float": pa.float32(), "double": pa.float64(),
         "date": pa.date32(), "timestamp_ntz": pa.timestamp("us"),
         "decimal(7,2)": pa.decimal128(7, 2),
         "decimal(9,2)": pa.decimal128(9, 2),
         "decimal(10,5)": pa.decimal128(10, 5),
         "decimal(20,4)": pa.decimal128(20, 4)}
CHAINS = [
    ("byte", "short"), ("byte", "integer"), ("byte", "long"),
    ("short", "integer"), ("short", "long"), ("integer", "long"),
    ("float", "double"), ("byte", "double"), ("short", "double"),
    ("integer", "double"), ("date", "timestamp_ntz"),
    ("decimal(7,2)", "decimal(9,2)"), ("decimal(7,2)", "decimal(10,5)"),
    ("decimal(7,2)", "decimal(20,4)"),
]
# the reference compares a decimal column's rounded float bounds with the
# exact literal and may skip a file that holds a match (ROADMAP C12)
_REFERENCE_SKIPS_A_MATCH = True
_INT_BITS = {"byte": 8, "short": 16, "integer": 32, "long": 64}
_EPOCH = dt.date(1970, 1, 1)


def _values(t: str, rng, n: int, wide_of: str = None) -> list:
    """`n` Python values of type `t` from the seed, about one in seven
    NULL; with `wide_of`, values of `t` past the narrow type `wide_of`'s
    range where `t` has room."""
    if t in _INT_BITS:
        bits = _INT_BITS[wide_of or t]
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
        if wide_of:
            top = 1 << (_INT_BITS[t] - 1)
            lo, hi = hi, min(top, hi + (1 << 40))
        v = [int(x) for x in rng.integers(lo, hi, n)]
    elif t in ("float", "double"):
        base = rng.normal(size=n) * 1000
        if wide_of:
            base = base * 1e40 if wide_of == "float" else base * 1e12
        v = [float(np.float32(x)) if t == "float" else float(x)
             for x in base]
    elif t == "date":
        v = [_EPOCH + dt.timedelta(days=int(x))
             for x in rng.integers(18_000, 19_000, n)]
    elif t == "timestamp_ntz":
        v = [dt.datetime(2019, 1, 1) + dt.timedelta(
            microseconds=int(x)) for x in rng.integers(0, 10 ** 14, n)]
    else:
        p, s = ref_schema.PrimitiveType(t).decimal_precision_scale()
        digits = min(10 ** (p - 2 if not wide_of else p - 1), 10 ** 18)
        v = [decimal.Decimal(int(x)).scaleb(-s)
             for x in rng.integers(-digits, digits, n)]
    return [None if i % 7 == 3 else x for i, x in enumerate(v)]


def _narrow_table(tmp_path, frm: str, props=None, part=False):
    """The reference's table of two narrow files (k, c[, p]); returns
    (ref copy, port copy, the rows written)."""
    rng = np.random.default_rng(len(frm) * 31 + 7)
    src = str(tmp_path / "src")
    rows = []
    for i in range(2):
        vals = _values(frm, rng, 40)
        ks = list(range(i * 40, i * 40 + 40))
        cols = {"k": pa.array(ks, pa.int64()),
                "c": pa.array(vals, ARROW[frm])}
        if part:
            cols["p"] = pa.array([k % 3 for k in ks], pa.int32())
        tbl = pa.table(cols)
        dta.write_table(src, tbl, engine=HostEngine(),
                        properties=dict(WIDEN, **(props or {}))
                        if i == 0 else None,
                        partition_by=["p"] if part and i == 0 else None)
        rows += tbl.to_pylist()
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port, rows


def ref_read(path, **kw) -> list:
    clear_parse_cache()
    return dta.read_table(path, engine=HostEngine(), **kw).to_pylist()


def port_read(path, **kw) -> list:
    return port_rows(pta.read_table(path, engine=CPU, **kw))


def _change_both(ref, port, name, to):
    rv = ref_alter.change_column_type(
        RefTable.for_path(ref, engine=HostEngine()), name,
        ref_schema.PrimitiveType(to))
    pv = port_alter.change_column_type(Table.for_path(port, engine=CPU),
                                       name, to)
    return rv, pv


def _wide_rows(to: str, frm: str, start: int) -> list:
    rng = np.random.default_rng(start)
    vals = _values(to, rng, 30, wide_of=frm) if to != "timestamp_ntz" \
        else _values(to, rng, 30)
    return [{"k": start + i, "c": v} for i, v in enumerate(vals)]


def _append_both(ref, port, rows, to, part=None):
    cols = {"k": pa.array([r["k"] for r in rows], pa.int64()),
            "c": pa.array([r["c"] for r in rows], ARROW[to])}
    if part:
        cols["p"] = pa.array([r["p"] for r in rows], ARROW[part])
    tbl = pa.table(cols)
    return (dta.write_table(ref, tbl, engine=HostEngine()),
            pta.write_table(port, to_port(tbl), engine=CPU))


def _as_wide(v, to: str):
    """A narrow row's value as the wide type reads it."""
    if v is None:
        return None
    if to == "timestamp_ntz":
        return dt.datetime(v.year, v.month, v.day)
    if to in ("double",):
        return float(v)
    if to.startswith("decimal"):
        s = ref_schema.PrimitiveType(to).decimal_precision_scale()[1]
        return v.quantize(decimal.Decimal(1).scaleb(-s))
    return v


_OPS = {"=": lambda a, b: a == b, "<": lambda a, b: a < b,
        "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
        ">=": lambda a, b: a >= b}


def _filters_keep_the_rows(ref, port, rows, old_bounds, wide_bound):
    """Each filter on c against the narrow files' bounds and a wide value
    keeps exactly the rows a Python filter keeps, in both packages and
    on both copies."""
    for lit in list(old_bounds) + [wide_bound]:
        for op, fn in _OPS.items():
            want = [r for r in rows if r["c"] is not None and fn(r["c"], lit)]
            for path in (ref, port):
                got_ref = ref_read(path, filter=RE.Comparison(
                    op, RE.col("c"), RE.lit(lit)))
                got_port = port_read(path, filter=PE.Comparison(
                    op, PE.col("c"), PE.lit(lit)))
                assert same_rows(got_port, want), (op, lit, path)
                if isinstance(lit, decimal.Decimal) \
                        and _REFERENCE_SKIPS_A_MATCH:
                    # C12: a subset, never a row the filter drops
                    assert all(repr(r) in map(repr, want) for r in got_ref)
                    continue
                assert same_rows(got_ref, want), (op, lit, path)


def _checkpoint_leaf_types(path: str) -> dict:
    """{checkpoint version: the type of stats_parsed.minValues.c}."""
    out = {}
    for f in glob.glob(os.path.join(path, "_delta_log",
                                    "*.checkpoint.parquet")):
        t = pq.read_schema(f).field("add").type
        sp = t[t.get_field_index("stats_parsed")].type
        mv = sp[sp.get_field_index("minValues")].type
        out[int(os.path.basename(f)[:20])] = str(
            mv[mv.get_field_index("c")].type)
    return out


@pytest.mark.parametrize("frm,to", CHAINS, ids=[f"{a}-{b}" for a, b in CHAINS])
def test_change_column_type_chain(tmp_path, frm, to):
    ref, port, rows = _narrow_table(tmp_path, frm, STRUCT_STATS)
    # a checkpoint before the change, by the reference on both copies
    for path in (ref, port):
        RefTable.for_path(path, engine=HostEngine()).checkpoint()
    rv, pv = _change_both(ref, port, "c", to)
    r, p = _summary(ref, rv, set()), _summary(port, pv, set())
    assert r == p
    assert p["operation"] == "CHANGE COLUMN"
    assert p["operationParameters"] == {"column": "c", "newType": to}
    for path in (ref, port):
        clear_parse_cache()
        for t in (RefTable.for_path(path, engine=HostEngine()),
                  Table.for_path(path, engine=CPU)):
            field = t.latest_snapshot().schema["c"]
            got = getattr(field, "data_type", None) or \
                getattr(field, "dataType").to_json_value()
            assert got == to
    # the narrow rows read as the wide type, through the old checkpoint
    rows = [dict(r, c=_as_wide(r["c"], to)) for r in rows]
    assert same_rows(port_read(port), rows)
    assert same_rows(port_read(ref), rows)
    assert same_rows(ref_read(port), rows)
    wide = _wide_rows(to, frm, 1000)
    assert _append_both(ref, port, wide, to)[0] == _version(port)
    rows += wide
    _same_rows(ref, port)
    assert same_rows(port_read(port), rows)
    old = [r["c"] for r in rows[:80] if r["c"] is not None]
    new = [r["c"] for r in wide if r["c"] is not None]
    _filters_keep_the_rows(ref, port, rows, (max(old), min(old)), max(new))
    # a checkpoint after the change types stats_parsed by the new schema
    RefTable.for_path(ref, engine=HostEngine()).checkpoint()
    Table.for_path(port, engine=CPU).checkpoint()
    kinds = [_checkpoint_leaf_types(x) for x in (ref, port)]
    assert kinds[0] == kinds[1]
    assert kinds[1][max(kinds[1])] == str(
        pa.timestamp("us") if to == "timestamp_ntz" else ARROW[to])
    _same_rows(ref, port)
    _filters_keep_the_rows(ref, port, rows, (max(old), min(old)), max(new))


NOT_WIDENING = [("long", "integer"), ("double", "float"), ("long", "double"),
                ("integer", "string"), ("date", "timestamp"),
                ("decimal(9,2)", "decimal(7,2)"),
                ("decimal(7,2)", "decimal(7,3)"), ("integer", "integer")]


@pytest.mark.parametrize("frm,to", NOT_WIDENING,
                         ids=[f"{a}-{b}" for a, b in NOT_WIDENING])
def test_change_column_type_refusals(tmp_path, frm, to):
    arrow = {"string": pa.string(), "timestamp": pa.timestamp("us", "UTC"),
             "decimal(7,3)": pa.decimal128(7, 3)}
    src = str(tmp_path / "src")
    dta.write_table(src, pa.table({"c": pa.array([], dict(
        ARROW, **arrow)[frm])}), engine=HostEngine(), properties=WIDEN)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    with pytest.raises(RefError) as r:
        ref_alter.change_column_type(RefTable.for_path(
            ref, engine=HostEngine()), "c", ref_schema.PrimitiveType(to))
    with pytest.raises(DeltaError) as p:
        port_alter.change_column_type(Table.for_path(port, engine=CPU),
                                      "c", to)
    assert type(p.value).__name__ == type(r.value).__name__
    assert p.value.error_class == r.value.error_class == \
        "DELTA_CANNOT_CHANGE_DATA_TYPE"
    assert _version(port) == 0


def test_change_column_type_needs_the_flag_and_the_column(tmp_path):
    src = str(tmp_path / "src")
    dta.write_table(src, pa.table({"k": pa.array([0, 1], pa.int64()),
                                   "c": pa.array([1, 2], pa.int32())}),
                    engine=HostEngine())
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    for name, want in (("c", "DELTA_TYPE_WIDENING_DISABLED"),
                       ("zzz", "DELTA_COLUMN_NOT_FOUND_IN_SCHEMA")):
        with pytest.raises(RefError) as r:
            ref_alter.change_column_type(RefTable.for_path(
                ref, engine=HostEngine()), name,
                ref_schema.PrimitiveType("long"))
        with pytest.raises(DeltaError) as p:
            port_alter.change_column_type(Table.for_path(port, engine=CPU),
                                          name, "long")
        assert (type(p.value).__name__, p.value.error_class) == \
            (type(r.value).__name__, r.value.error_class)
        assert p.value.error_class == want
    assert _version(port) == 0
    # the flag by SET TBLPROPERTIES: the protocol upgrade in its commit
    rv = ref_alter.set_properties(RefTable.for_path(
        ref, engine=HostEngine()), WIDEN)
    pv = port_alter.set_properties(Table.for_path(port, engine=CPU), WIDEN)
    r, p = _summary(ref, rv, set()), _summary(port, pv, set())
    assert r == p
    assert p["protocol"] == [{"minReaderVersion": 3, "minWriterVersion": 7,
                              "readerFeatures": ["typeWidening"],
                              "writerFeatures": ["appendOnly", "invariants",
                                                 "typeWidening"]}]
    rv, pv = _change_both(ref, port, "c", "long")
    assert _summary(ref, rv, set()) == _summary(port, pv, set())
    _append_both(ref, port, [{"k": 5, "c": 1 << 40}], "long")
    _same_rows(ref, port)


def test_new_table_with_the_flag_has_the_references_protocol(tmp_path):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    tbl = pa.table({"c": pa.array([1, 2], pa.int32())})
    dta.write_table(ref, tbl, engine=HostEngine(), properties=WIDEN)
    pta.write_table(port, to_port(tbl), engine=CPU, properties=WIDEN)
    assert _summary(ref, 0, set())["protocol"] == \
        _summary(port, 0, set())["protocol"] == [
            {"minReaderVersion": 3, "minWriterVersion": 7,
             "readerFeatures": ["typeWidening"],
             "writerFeatures": ["typeWidening"]}]


@pytest.mark.parametrize("case", ["mapped", "partition_int",
                                  "partition_date"])
def test_widening_on_mapped_and_partitioned_tables(tmp_path, case):
    if case == "mapped":
        ref, port, rows = _narrow_table(
            tmp_path, "integer", {"delta.columnMapping.mode": "name"})
        rv, pv = _change_both(ref, port, "c", "long")
        assert _summary(ref, rv, set()) == _summary(port, pv, set())
        _append_both(ref, port, _wide_rows("long", "integer", 500), "long")
        _same_rows(ref, port)
        return
    if case == "partition_int":
        ref, port, rows = _narrow_table(tmp_path, "integer", part=True)
        rv, pv = _change_both(ref, port, "p", "long")
        assert _summary(ref, rv, set()) == _summary(port, pv, set())
        wide = [{"k": 900 + i, "c": i, "p": (1 << 35) + i % 2}
                for i in range(6)]
        _append_both(ref, port, wide, "integer", part="long")
        _same_rows(ref, port)
        for path in (ref, port):
            got = port_read(path, filter=PE.col("p") >= PE.lit(1 << 35))
            assert sorted(r["k"] for r in got) == list(range(900, 906))
        return
    # a date partition column read as timestamp_ntz; the port appends
    # (the reference's writer misplaces an escaped partition value, C8)
    src = str(tmp_path / "src")
    days = [dt.date(2024, 1, 1) + dt.timedelta(days=i % 3) for i in range(9)]
    dta.write_table(src, pa.table({"k": pa.array(range(9), pa.int64()),
                                   "d": pa.array(days, pa.date32())}),
                    engine=HostEngine(), partition_by=["d"],
                    properties=WIDEN)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    rv, pv = _change_both(ref, port, "d", "timestamp_ntz")
    assert _summary(ref, rv, set()) == _summary(port, pv, set())
    when = dt.datetime(2024, 1, 2, 12, 30)
    pta.write_table(port, to_port(pa.table({
        "k": pa.array([100], pa.int64()),
        "d": pa.array([when], pa.timestamp("us"))})), engine=CPU)
    want = [{"k": k, "d": dt.datetime(d.year, d.month, d.day)}
            for k, d in enumerate(days)] + [{"k": 100, "d": when}]
    assert same_rows(port_read(port), want)
    assert same_rows(ref_read(port), want)
    assert same_rows(port_read(ref), want[:-1])
    lit = dt.datetime(2024, 1, 2)
    assert sorted(r["k"] for r in port_read(
        port, filter=PE.col("d") >= PE.lit(lit))) == \
        sorted(r["k"] for r in want if r["d"] >= lit)


# ------------------------------------------- MERGE's schema evolution --

def _merge_source(ids):
    ids = np.asarray(ids, np.int64)
    tbl = pa.table({"id": pa.array(ids),
                    "v": pa.array(ids / 4.0),
                    "zeta": pa.array([f"z{i}" for i in ids]),
                    "alpha": pa.array(ids * 3, pa.int32())})
    return tbl


def _merge_both(ref, port, tbl, build):
    outs = []
    for pkg, path in (("ref", ref), ("port", port)):
        m, E, T = ((ref_merge, RE, RefTable.for_path(
            path, engine=HostEngine())) if pkg == "ref" else
            (port_merge, PE, Table.for_path(path, engine=CPU)))
        src = tbl if pkg == "ref" else to_port(tbl)
        try:
            outs.append(build(m.merge(T, src, on=E.col("target.id")
                                      == E.col("source.id")), E).execute())
        except (RefError, DeltaError) as e:
            outs.append((type(e).__name__, e.error_class))
    return outs


@pytest.mark.parametrize("kind", ["plain", "partitioned", "mapped"])
@pytest.mark.parametrize("clause", ["star", "explicit"])
def test_merge_schema_evolution(tmp_path, kind, clause):
    ref, port, src = _base(tmp_path, kind)
    tbl = _merge_source(list(range(30, 50)) + list(range(200, 210)))
    part = KINDS[kind][0]
    if part:
        tbl = tbl.append_column("p", pa.array(
            [None if i % 13 == 6 else ["u", "v", "w"][i % 3]
             for i in tbl.column("id").to_pylist()]))

    def clauses(m, E):
        if clause == "star":
            return m.when_matched_update_all().when_not_matched_insert_all()
        return m.when_matched_update(
            set={"v": E.col("source.v"), "zeta": E.col("source.zeta")}) \
            .when_not_matched_insert(values={
                "id": E.col("source.id"), "zeta": E.col("source.zeta")})

    def build(m, E):
        return clauses(m.with_schema_evolution(), E)

    # without the flag: the reference's refusal, nothing committed
    r, p = _merge_both(ref, port, tbl, clauses)
    assert r == p and isinstance(p, tuple)
    assert _version(port) == _version(ref)
    rm, pm = _merge_both(ref, port, tbl, build)
    for k in ("num_target_rows_updated", "num_target_rows_inserted",
              "num_target_rows_copied", "num_target_files_rewritten",
              "version"):
        assert getattr(rm, k) == getattr(pm, k), k
    _same_commit(ref, port, rm.version, pm.version, src)
    snap = Table.for_path(port, engine=CPU).latest_snapshot()
    names = snap.schema.field_names()
    added = ["alpha", "zeta"] if clause == "star" else ["zeta"]
    assert names[-len(added):] == added
    if KINDS[kind][1]:
        conf = snap.metadata.configuration
        assert all(snap.schema[c].physical_name.startswith("col-")
                   for c in added)
        assert int(conf["delta.columnMapping.maxColumnId"]) == \
            max(f.column_mapping_id for f in snap.schema.fields)
    got = _same_rows(ref, port)
    old = [r for r in got if r["id"] < 30 or 50 <= r["id"] < 120]
    assert old and all(r["zeta"] is None for r in old)
    hit = [r for r in got if 30 <= r["id"] < 50 or r["id"] >= 200]
    assert all(r["zeta"] == f"z{r['id']}" for r in hit)


def test_merge_schema_evolution_with_nothing_touched(tmp_path):
    """No row matches and no clause inserts: the evolved metadata commits
    alone, as the reference commits it."""
    ref, port, src = _base(tmp_path, "plain")
    tbl = _merge_source([500, 501])
    rm, pm = _merge_both(ref, port, tbl, lambda m, E: m
                         .with_schema_evolution().when_matched_update_all())
    assert rm.version == pm.version == 3
    r, p = _summary(ref, rm.version, src), _summary(port, pm.version, src)
    assert r == p and p["add"] == p["remove"] == [] and p["metaData"]
    _same_rows(ref, port)

"""Partitioned tables: the port's writes, reads, OPTIMIZE and DML against
the JAX package's.

Both directions, every comparison exact:

- the port writes (`delta_tpu_torch.api.write_table(partition_by=)`) and
  the reference (`HostEngine`) loads the log to the same state (paths,
  partition values, stats) and reads the same rows, as a multiset, with
  and without a filter on the partition columns;
- the reference writes and the port reads the same rows.

Partition values: int, date, timestamp and string columns, a null
partition, values that need percent-encoding ('%', '/', a space, '=',
non-ASCII: the reference cannot read those back, see
`write/writer.py`, so the port's tables are held to it there), two
partition columns, `delta.randomizeFilePrefixes`, and a '%' table
reloaded through a checkpoint plus a tail. OPTIMIZE compaction and
Z-order per partition, `where` on a partition, a null partition and
auto-compaction; DELETE and UPDATE with and without deletion vectors,
a DELETE on a partition predicate removing whole files; the metadata
checks on partition columns.
"""

import dataclasses
import datetime
import json
import os
import shutil
from urllib.parse import quote, unquote

import jax
import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.optimize as ref_opt  # noqa: F401 (Table.optimize)
import delta_tpu.expressions.tree as RE
import delta_tpu.ops.pallas_kernels as ref_pk
from delta_tpu.engine.host import HostEngine
from delta_tpu.table import Table as RefTable
from delta_tpu.replay.columnar import clear_parse_cache
import delta_tpu_torch.commands.dml as port_dml
import delta_tpu_torch.commands.merge as port_merge
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.api import read_table, write_table
from delta_tpu_torch.config import settings
from delta_tpu_torch.errors import InvalidArgumentError, SchemaMismatchError
from delta_tpu_torch.log.checkpointer import write_checkpoint
from delta_tpu_torch.stats.partition import (
    partition_path,
    serialize_partition_value,
)
from delta_tpu.stats import partition as ref_partition

CPU = TorchEngine("cpu")
DV = {"delta.enableDeletionVectors": "true"}


@pytest.fixture(autouse=True)
def ref_x32(monkeypatch):
    # the reference's Z-order under this jax (ROADMAP C0)
    monkeypatch.setattr(ref_pk, "_x32", lambda: jax.enable_x64(False))


def _rows_of_batch(b, names):
    cols = []
    for c in names:
        col = b.column(c)
        vals = col.values.tolist()
        if col.valid is not None:
            vals = [v if ok else None for v, ok in zip(vals, col.valid)]
        cols.append(vals)
    return sorted(zip(*cols), key=repr)


def _py(v):
    """A reference value as the port's numpy values read back."""
    if isinstance(v, datetime.datetime):
        return v.replace(tzinfo=None)
    return v


def _rows_ref(path, names, filt=None):
    t = dta.read_table(path, filter=filt, engine=HostEngine())
    return sorted(zip(*([_py(v) for v in t.column(c).to_pylist()]
                        for c in names)), key=repr)


def _rows_port(path, names, filt=None):
    return _rows_of_batch(read_table(path, filter=filt, engine=CPU), names)


def _states(path):
    """(path, partitionValues, stats) of every live file, as the reference
    and the port load the log."""
    ref = RefTable.for_path(path, engine=HostEngine()).latest_snapshot()
    port = Table.for_path(path, engine=CPU).latest_snapshot()
    r = sorted((a.path, sorted((a.partitionValues or {}).items(), key=repr),
                a.stats) for a in ref.state.add_files())
    p = sorted((a.path, sorted((a.partitionValues or {}).items(), key=repr),
                a.stats) for a in port.state.add_files)
    return r, p


# ---------------------------------------------------------------- write


def _port_cols(rng, i, n, kind):
    k = np.arange(i * 1000, i * 1000 + n)
    cols = {"k": k, "x": rng.normal(size=n)}
    if kind == "int":
        cols["p"] = (k // 7) % 3
    elif kind == "date":
        cols["p"] = (np.datetime64("2024-02-27")
                     + (k % 4).astype("timedelta64[D]"))
    elif kind == "timestamp":
        cols["p"] = (np.datetime64("2024-01-01T00:00:00", "us")
                     + (k % 3).astype("timedelta64[h]"))
    elif kind in ("string", "escapes"):
        vals = (["a", "b", "c"] if kind == "string"
                else ["a%b", "c/d", "e f", "x=y", "ü", "50%"])
        p = np.array([vals[j % len(vals)] for j in k], object)
        cols["p"] = (p, k % 5 != 0)  # every fifth row in the null partition
    elif kind == "two":
        cols["p"] = np.array([["u", "v"][j % 2] for j in k], object)
        cols["q"] = (k // 3) % 2
    return cols


WRITE_CASES = ["int", "date", "timestamp", "string", "escapes", "two",
               "random_prefixes"]


@pytest.mark.parametrize("kind", WRITE_CASES)
def test_port_writes_reload_in_the_reference(tmp_path, kind):
    path = str(tmp_path / "t")
    rng = np.random.default_rng(3)
    data_kind = "string" if kind == "random_prefixes" else kind
    parts = ["p", "q"] if kind == "two" else ["p"]
    props = ({"delta.randomizeFilePrefixes": "true"}
             if kind == "random_prefixes" else None)
    for i in range(3):
        write_table(path, _port_cols(rng, i, 40 + 3 * i, data_kind),
                    partition_by=parts, engine=CPU, properties=props,
                    target_rows_per_file=9)
    ref_state, port_state = _states(path)
    assert ref_state == port_state
    for p, pv, stats in port_state:
        assert "\"p\"" not in stats and "\"q\"" not in stats
        if kind == "random_prefixes":
            assert not p.startswith("p=")
        else:
            # the state holds the decoded path: the file's directory
            assert p.startswith(unquote(partition_path(dict(pv), parts)))
    names = ["k", "x"] + parts
    rows = _rows_ref(path, names)
    assert _rows_port(path, names) == rows and len(rows) == 129
    # a filter on the partition column and a data column, both packages
    first = rows[0][names.index("p")]
    if first is not None:
        for E, read in ((RE, _rows_ref), (PE, _rows_port)):
            lit = first
            if kind == "timestamp":
                lit = first.replace(tzinfo=datetime.timezone.utc)
            got = read(path, names, (E.col("p") == E.lit(lit))
                       & (E.col("k") > E.lit(10)))
            assert got == [r for r in rows if r[2] == first and r[0] > 10]


def test_reference_writes_read_in_the_port(tmp_path):
    path = str(tmp_path / "t")
    rng = np.random.default_rng(5)
    for i in range(4):
        n = 30 + i
        k = np.arange(i * 100, i * 100 + n)
        dta.write_table(path, pa.table({
            "k": pa.array(k, pa.int64()),
            "x": pa.array(rng.normal(size=n)),
            "s": pa.array([f"s{j % 4}" for j in k], mask=k % 6 == 0),
            "n": pa.array((k % 3).astype(np.int32)),
            "d": pa.array((np.datetime64("2024-01-01")
                           + (k % 2).astype("timedelta64[D]"))
                          .astype("datetime64[D]"), pa.date32()),
        }), partition_by=["s", "n", "d"], engine=HostEngine())
    names = ["k", "x", "s", "n", "d"]
    rows = _rows_ref(path, names)
    assert _rows_port(path, names) == rows
    for E in (RE, PE):
        filt = (E.col("s").is_null() | (E.col("n") == E.lit(2))) & \
            (E.col("d") > E.lit(datetime.date(2024, 1, 1)))
        want = _rows_ref(path, names, build(filt, E, RE))
        assert _rows_port(path, names, build(filt, E, PE)) == want
    # the port reads the column order the reference does: data, partitions
    assert read_table(path, engine=CPU).column_names == \
        dta.read_table(path, engine=HostEngine()).column_names


def build(expr, E, target):
    """The same expression in the tree module `target` (both trees have
    the same shapes)."""
    if E is target:
        return expr
    name = type(expr).__name__
    if name == "Column":
        return target.Column(expr.name_path)
    if name == "Literal":
        return target.Literal(expr.value)
    if name in ("And", "Or"):
        return getattr(target, name)(build(expr.left, E, target),
                                     build(expr.right, E, target))
    if name == "Comparison":
        return target.Comparison(expr.op, build(expr.left, E, target),
                                 build(expr.right, E, target))
    if name in ("IsNull", "IsNotNull", "Not"):
        return getattr(target, name)(build(expr.child, E, target))
    raise TypeError(name)


def test_percent_paths_reload_through_a_checkpoint(tmp_path):
    """Twelve appends of escaped partition values: the hook checkpoints
    version 10, so both packages load a checkpoint plus a tail whose add
    paths hold '%' escapes (the port's '%' route)."""
    path = str(tmp_path / "t")
    rng = np.random.default_rng(7)
    for i in range(12):
        write_table(path, _port_cols(rng, i, 12, "escapes"),
                    partition_by=["p"], engine=CPU)
    assert os.path.exists(os.path.join(
        path, "_delta_log", f"{10:020d}.checkpoint.parquet"))
    ref_state, port_state = _states(path)
    assert ref_state == port_state
    # the tail's raw paths hold the escapes, the loaded ones are decoded
    with open(os.path.join(path, "_delta_log", f"{11:020d}.json")) as f:
        assert "p=a%25b/" in f.read()
    assert any(p.startswith("p=a%b/") for p, _, _ in port_state)
    names = ["k", "x", "p"]
    assert _rows_port(path, names) == _rows_ref(path, names)


def test_serialize_and_path_match_the_reference():
    values = [None, True, False, 7, np.int64(-3), 1.5, np.float32(1.1),
              np.float64(2.25), "a%b/c d=eü",
              datetime.date(2024, 2, 29), np.datetime64("2024-02-29"),
              datetime.datetime(2024, 1, 2, 3, 4, 5, 6),
              np.datetime64("2024-01-02T03:04:05.000006", "us"), b"xy"]
    for v in values:
        want = ref_partition.serialize_partition_value(
            v.item() if isinstance(v, np.datetime64) else v)
        if isinstance(v, np.bool_):
            want = want.lower()
        assert serialize_partition_value(v) == want, v
    pv = {"a": "x/y", "b": None, "c": "1%"}
    assert partition_path(pv, ["a", "b", "c"]) == \
        ref_partition.partition_path(pv, ["a", "b", "c"])
    assert partition_path({}, []) == ""


def test_partition_column_checks(tmp_path):
    with pytest.raises(InvalidArgumentError) as e:
        write_table(str(tmp_path / "a"), {"k": np.arange(3)},
                    partition_by=["nope"], engine=CPU)
    assert e.value.error_class == "DELTA_INVALID_PARTITION_COLUMN"
    with pytest.raises(InvalidArgumentError) as e:
        write_table(str(tmp_path / "b"), {"k": np.arange(3)},
                    partition_by=["k"], engine=CPU)
    assert e.value.error_class == \
        "DELTA_CANNOT_USE_ALL_COLUMNS_FOR_PARTITION"
    path = str(tmp_path / "c")
    write_table(path, {"k": np.arange(3), "p": np.arange(3)},
                partition_by=["p"], engine=CPU)
    with pytest.raises(SchemaMismatchError) as e:
        write_table(path, {"k": np.arange(3)}, engine=CPU)
    assert e.value.error_class == "DELTA_MISSING_PARTITION_COLUMN"
    for p in (tmp_path / "a", tmp_path / "b"):
        assert not os.path.exists(p / "_delta_log")


# Partition values whose directory holds an escape once decoded (`a%20b`,
# `x%25y`, `%2F`) beside ones that decode to no escape (ROADMAP C7).
ESCAPED = ["a%20b", "x%25y", "%2F", "a%b", "50%", "e f"]


def _spark_form(path):
    """A URI of `path` in another writer's form: every segment escaped
    but for '=' (so `p=a%20b/` is `p=a%2520b/`), '-' escaped too."""
    return "/".join(quote(seg, safe="=").replace("-", "%2D")
                    for seg in path.split("/"))


def _to_spark_form(path, version):
    """Rewrite the add paths of commit `version` into `_spark_form`."""
    name = os.path.join(path, "_delta_log", f"{version:020d}.json")
    with open(name) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    for d in lines:
        if "add" in d:
            d["add"]["path"] = _spark_form(unquote(d["add"]["path"]))
            assert d["add"]["path"] != quote(unquote(d["add"]["path"]))
    with open(name, "w") as f:
        f.write("\n".join(json.dumps(d) for d in lines) + "\n")


def _assert_truth(path, truth, gone):
    """The port's reload of `path` holds exactly the rows of `truth` (k ->
    (x, p)) in live files that lie at their paths in their partitions'
    directories, none of them a file an earlier step removed; the
    reference's load of the same log has the same live files. Returns
    the live paths."""
    clear_parse_cache()
    state = Table.for_path(path, engine=CPU).latest_snapshot().state
    live = sorted(a.path for a in state.add_files)
    ref = RefTable.for_path(path, engine=HostEngine()).latest_snapshot()
    assert sorted(a.path for a in ref.state.add_files()) == live
    assert not set(live) & gone
    for a in state.add_files:
        assert a.path.startswith(f"p={a.partitionValues['p']}/")
        assert os.path.isfile(os.path.join(path, a.path))
    want = sorted(((k, x, p) for k, (x, p) in truth.items()), key=repr)
    assert _rows_port(path, ["k", "x", "p"]) == want
    return set(live)


@pytest.mark.parametrize("dv", [False, True], ids=["cow", "dv"])
@pytest.mark.parametrize("origin", ["port", "spark_form"])
def test_escaped_partition_values_survive_every_step(tmp_path, monkeypatch,
                                                     origin, dv):
    """A value whose directory still holds an escape is written, and no
    removed file comes back through a DELETE (deletion vectors or
    copy-on-write), an UPDATE, a MERGE, an OPTIMIZE, or a classic,
    multi-part or V2 checkpoint with commands after each; `spark_form`
    first rewrites the adds' paths as another writer forms its URIs."""
    path = str(tmp_path / "t")
    k = np.arange(60)
    write_table(path, {"k": k, "x": k / 4.0,
                       "p": np.array([ESCAPED[j % 6] for j in k], object)},
                partition_by=["p"], target_rows_per_file=4, engine=CPU,
                properties=DV if dv else None)
    if origin == "spark_form":
        _to_spark_form(path, 0)
    truth = {int(j): (j / 4.0, ESCAPED[j % 6]) for j in k}
    live, gone = _assert_truth(path, truth, set()), set()
    assert len(live) == 18 and any("p=a%20b/" in p for p in live)

    def step(run, *, keep=lambda j, x, p: True,
             set_x=lambda j, x, p: x, insert=()):
        nonlocal live
        run(Table.for_path(path, engine=CPU))
        for j, (x, p) in list(truth.items()):
            if keep(j, x, p):
                truth[j] = (set_x(j, x, p), p)
            else:
                del truth[j]
        truth.update(insert)
        now = _assert_truth(path, truth, gone)
        gone.update(live - now)
        live = now

    def between(lo, hi):
        return (PE.col("k") >= PE.lit(lo)) & (PE.col("k") < PE.lit(hi))

    step(lambda t: port_dml.delete(t, between(10, 14)),
         keep=lambda j, x, p: not 10 <= j < 14)
    step(lambda t: port_dml.delete(t, PE.col("p") == PE.lit("%2F")),
         keep=lambda j, x, p: p != "%2F")
    step(lambda t: port_dml.update(t, {"x": PE.lit(-1.0)}, between(40, 46)),
         set_x=lambda j, x, p: -1.0 if 40 <= j < 46 else x)
    src = {"k": np.array([1, 27, 100, 101]),
           "x": np.array([0.5, 0.25, 9.0, 8.0]),
           "p": np.array(["x%25y", "a%b", "a%20b", "x%25y"], object)}
    step(lambda t: port_merge.merge(
            t, src, on=PE.col("target.k") == PE.col("source.k"))
         .when_matched_update(set={"x": PE.col("source.x")})
         .when_not_matched_insert_all().execute(),
         set_x=lambda j, x, p: {1: 0.5, 27: 0.25}.get(j, x),
         insert={100: (9.0, "a%20b"), 101: (8.0, "x%25y")})
    step(lambda t: t.optimize().execute_compaction())
    assert all(p.startswith(("p=a%20b/", "p=x%25y/", "p=a%b/", "p=50%/",
                             "p=e f/")) for p in live)
    step(lambda t: t.checkpoint())
    step(lambda t: port_dml.delete(t, between(30, 34)),
         keep=lambda j, x, p: not 30 <= j < 34)
    monkeypatch.setattr(settings, "checkpoint_part_size", 2)
    step(lambda t: t.checkpoint())
    step(lambda t: port_dml.update(t, {"x": PE.lit(7.0)},
                                   PE.col("p") == PE.lit("a%20b")),
         set_x=lambda j, x, p: 7.0 if p == "a%20b" else x)
    step(lambda t: write_checkpoint(CPU, t.latest_snapshot(), policy="v2"))
    step(lambda t: port_dml.delete(t, PE.col("p") == PE.lit("x%25y")),
         keep=lambda j, x, p: p != "x%25y")
    monkeypatch.setattr(settings, "checkpoint_part_size", None)
    step(lambda t: t.checkpoint())
    step(lambda t: port_dml.delete(t, between(0, 9)),
         keep=lambda j, x, p: not 0 <= j < 9)
    assert len(gone) > 10 and len(truth) == 31


# ------------------------------------------------------------- OPTIMIZE


def _ref_batch(rng, i, n):
    k = np.arange(i * 1000, i * 1000 + n)
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "x": pa.array(rng.normal(size=n)),
        "y": pa.array(rng.integers(0, 1 << 20, n), pa.int64()),
        "g": pa.array([f"g{j % 3}" for j in k]),
    })


def _copies(tmp_path, props=None, appends=4, rows=60):
    rng = np.random.default_rng(11)
    src = str(tmp_path / "src")
    for i in range(appends):
        dta.write_table(src, _ref_batch(rng, i, rows + 5 * i),
                        partition_by=["g"], engine=HostEngine(),
                        properties=props if i == 0 else None)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port


def _commit_adds(path, version):
    import json

    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        acts = [json.loads(line) for line in f if line.strip()]
    adds = [a["add"] for a in acts if "add" in a]
    return sorted((tuple(sorted(a["partitionValues"].items())), a["stats"])
                  for a in adds)


@pytest.mark.parametrize("case", ["compaction", "zorder", "where"])
def test_optimize_per_partition_matches_reference(tmp_path, case):
    ref, port = _copies(tmp_path)

    def run(opt, E):
        if case == "compaction":
            return opt.execute_compaction()
        if case == "zorder":
            return opt.execute_zorder_by("y", "x")
        return opt.where(E.col("g") != E.lit("g1")).execute_zorder_by("y")

    rm = run(RefTable.for_path(ref, engine=HostEngine()).optimize(), RE)
    pm = run(Table.for_path(port, engine=CPU).optimize(), PE)
    for f in ("num_files_added", "num_files_removed", "num_bins",
              "partitions_optimized", "version", "bytes_removed"):
        assert getattr(rm, f) == getattr(pm, f), f
    assert pm.partitions_optimized == (2 if case == "where" else 3)
    assert _commit_adds(ref, rm.version) == _commit_adds(port, pm.version)
    names = ["k", "x", "y", "g"]
    assert _rows_port(port, names) == _rows_ref(ref, names)
    assert _rows_ref(port, names) == _rows_ref(ref, names)


def test_optimize_keeps_a_null_partition_apart(tmp_path):
    path = str(tmp_path / "t")
    rng = np.random.default_rng(2)
    for i in range(3):
        write_table(path, _port_cols(rng, i, 20, "string"),
                    partition_by=["p"], engine=CPU)
    before = _rows_port(path, ["k", "x", "p"])
    m = Table.for_path(path, engine=CPU).optimize().execute_compaction()
    assert m.partitions_optimized == 4 and m.num_files_removed == 12
    assert m.num_files_added == 4
    assert _rows_port(path, ["k", "x", "p"]) == before
    assert _rows_ref(path, ["k", "x", "p"]) == before
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    assert sorted(str(a.partitionValues["p"]) for a in
                  snap.state.add_files) == ["None", "a", "b", "c"]


def test_auto_compaction_of_a_partitioned_table(tmp_path):
    """The hook compacts per partition once 50 small files exist, as the
    reference's does."""
    paths = {}
    for who in ("ref", "port"):
        p = paths[who] = str(tmp_path / who)
        rng = np.random.default_rng(4)
        props = {"delta.autoOptimize.autoCompact": "true"}
        for i in range(26):
            b = _ref_batch(rng, i, 4)
            if who == "ref":
                dta.write_table(p, b, partition_by=["g"],
                                engine=HostEngine(),
                                properties=props if i == 0 else None)
            else:
                write_table(p, {c: b.column(c).to_numpy(zero_copy_only=False)
                                for c in b.column_names},
                            partition_by=["g"], engine=CPU,
                            properties=props if i == 0 else None)
    counts = []
    for p in paths.values():
        snap = RefTable.for_path(p, engine=HostEngine()).latest_snapshot()
        counts.append((snap.version, snap.state.num_files))
    assert counts[0] == counts[1] and counts[0][1] < 26 * 3
    names = ["k", "x", "y", "g"]
    assert _rows_port(paths["port"], names) == _rows_ref(paths["ref"], names)


# ------------------------------------------------------------------ DML


def _dml_rows(path):
    names = ["k", "x", "y", "g"]
    return _rows_ref(path, names), _rows_port(path, names)


def _check(ref, port, rm, pm):
    assert dataclasses.asdict(rm) == dataclasses.asdict(pm)
    r_ref, r_port = _dml_rows(ref)
    assert r_ref == r_port
    assert _dml_rows(port) == (r_ref, r_ref)
    for path in (ref, port):  # every live file in its partition's dir
        for p, pv, _ in _states(path)[1]:
            assert p.startswith(f"g={dict(pv)['g']}/")
    return r_ref


@pytest.mark.parametrize("props", [None, DV], ids=["cow", "dv"])
@pytest.mark.parametrize("cmd", ["delete", "update"])
def test_dml_on_a_partitioned_table(tmp_path, props, cmd):
    ref, port = _copies(tmp_path, props)

    def pred(E):
        return (E.col("x") > E.lit(0.3)) & (E.col("g") != E.lit("g2"))

    if cmd == "delete":
        rm = ref_dml.delete(RefTable.for_path(ref, engine=HostEngine()),
                            pred(RE))
        pm = port_dml.delete(Table.for_path(port, engine=CPU), pred(PE))
    else:
        rm = ref_dml.update(RefTable.for_path(ref, engine=HostEngine()),
                            {"y": RE.lit(-1)}, pred(RE))
        pm = port_dml.update(Table.for_path(port, engine=CPU),
                             {"y": PE.lit(-1)}, pred(PE))
    rows = _check(ref, port, rm, pm)
    if cmd == "delete" and props:
        assert pm.num_dvs_written > 0 and pm.num_files_rewritten == 0
    elif cmd == "delete":
        assert pm.num_files_rewritten > 0
    # a second command over the result: an UPDATE of the partition column
    # itself moves rows to another partition
    rm = ref_dml.update(RefTable.for_path(ref, engine=HostEngine()),
                        {"g": RE.lit("g9")}, RE.col("k") < RE.lit(40))
    pm = port_dml.update(Table.for_path(port, engine=CPU),
                         {"g": PE.lit("g9")}, PE.col("k") < PE.lit(40))
    assert len(_check(ref, port, rm, pm)) == len(rows)


def test_delete_on_a_partition_predicate_removes_whole_files(tmp_path):
    ref, port = _copies(tmp_path, DV)
    rm = ref_dml.delete(RefTable.for_path(ref, engine=HostEngine()),
                        RE.col("g") == RE.lit("g1"))
    pm = port_dml.delete(Table.for_path(port, engine=CPU),
                         PE.col("g") == PE.lit("g1"))
    _check(ref, port, rm, pm)
    assert pm.num_files_scanned == pm.num_files_removed_fully == 4
    assert pm.num_dvs_written == pm.num_files_rewritten == 0



def test_trailing_nul_partition_values_stay_two_groups():
    """C9 at the writer: `_partition_groups` keeps "a" and "a\x00" apart,
    each group holding its own rows (the table's truth; the reference's
    `pd.factorize` merges them, C8). No file system takes a NUL in a
    directory name, in either package, so the groups are held directly."""
    from delta_tpu_torch.models.batch import Batch, Column
    from delta_tpu_torch.write.writer import _partition_groups

    k = np.array(["a", "a\x00", "a", None, "b"], object)
    data = Batch({"id": Column(np.arange(5)),
                  "k": Column(k, np.array([True, True, True, False, True]))},
                 5)
    groups = [(pv["k"], g.column("id").values.tolist())
              for pv, g in _partition_groups(data, ["k"])]
    assert groups == [("a", [0, 2]), ("a\x00", [1]), (None, [3]),
                      ("b", [4])]

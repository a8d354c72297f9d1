"""VACUUM: the port's `commands/vacuum.py` against the JAX package's.

Each case builds one table with the reference (`delta_tpu.api`,
`HostEngine`), ages every file by two hours (`os.utime`, so no case races
the clock), copies it, and runs the reference's VACUUM on one copy and
the port's (`TorchEngine("cpu")`) on the other, first as a dry run, then
for real. Compared, exactly: the deleted sets, LITE's commit range, the
`_last_vacuum_info` watermark, and afterwards the rows each package reads
from its copy (to the rows before the vacuum).

Cases: tables after a DV DELETE, a copy-on-write DELETE, UPDATE, MERGE,
OPTIMIZE, an overwrite and `replace_where`; partitioned (values that
need no escape, C8) and name-mapped tables; recent tombstones (retention
1 hour), too-young and mtime-skewed files, hidden and `_change_data`
paths; an inventory (a pyarrow table for the reference, the port's
`Batch` and a mapping for the port) with absolute, `..`, `://`, hidden,
directory and unknown-age rows; LITE with its watermark, its gap error,
CDC files and `..`, absolute, `://` and escaped absolute paths in the
log; the argument checks. The port's own partitioned tables with `%`,
spaces and `=` in their values keep every live file.

C22 (`_REFERENCE_VACUUMS_ESCAPED_LIVE`): the reference's writer puts a
file of value "a b" at the escaped `p=a%20b/` while its log says
`p=a b/`, so its own VACUUM names that live file. Run as a dry run only.
"""

import json
import os
import shutil
import time

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.merge as ref_merge
import delta_tpu.commands.optimize as ref_opt  # noqa: F401 (Table.optimize)
import delta_tpu.expressions.tree as RE
from delta_tpu.commands.vacuum import vacuum as ref_vacuum
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefError
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.api as pta
import delta_tpu_torch.commands.dml as port_dml
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.commands.vacuum import vacuum as port_vacuum
from delta_tpu_torch.errors import DeltaError
from delta_tpu_torch.models.batch import Batch, as_column
from test_torch_wide_types import port_rows, same_rows
from test_torch_wide_write import ref_rows

CPU = TorchEngine("cpu")
DV = {"delta.enableDeletionVectors": "true"}
NAME = {"delta.columnMapping.mode": "name"}
HOUR_S = 3600

# the reference's writer escapes a partition directory its log names
# unescaped, so its VACUUM takes live files for orphans (ROADMAP C22)
_REFERENCE_VACUUMS_ESCAPED_LIVE = True


# ------------------------------------------------------------ helpers --

def _data(lo: int, n: int, part: bool = False) -> pa.Table:
    k = np.arange(lo, lo + n)
    cols = {"k": pa.array(k, pa.int64()),
            "v": pa.array((k * 7 % 13).astype(float)),
            "s": pa.array([f"s{j % 5}" for j in k], mask=k % 9 == 4)}
    if part:
        cols["p"] = pa.array([("a", "b", "c")[j % 3] for j in k])
    return pa.table(cols)


def _ref(path: str) -> RefTable:
    return RefTable.for_path(path, engine=HostEngine())


def _port(path: str) -> Table:
    return Table.for_path(path, engine=CPU)


def _write(path: str, rows=(30, 30, 30), props=None, part=False) -> None:
    lo = 0
    for i, n in enumerate(rows):
        dta.write_table(path, _data(lo, n, part), engine=HostEngine(),
                        properties=props if i == 0 else None,
                        partition_by=["p"] if part else None)
        lo += n


def _age(path: str, seconds: float = 2 * HOUR_S) -> None:
    """Every file under `path` set `seconds` into the past."""
    t = time.time() - seconds
    for root, _, files in os.walk(path):
        for f in files:
            os.utime(os.path.join(root, f), (t, t))


def _copies(tmp_path, src: str) -> tuple:
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)   # copy2: the mtimes come along
    shutil.copytree(src, port)
    return ref, port


def _both(ref: str, port: str, **kw) -> tuple:
    r = ref_vacuum(_ref(ref), **kw)
    p = port_vacuum(_port(port), **kw)
    return r, p


def _watermark(path: str):
    name = os.path.join(path, "_delta_log", "_last_vacuum_info")
    if not os.path.exists(name):
        return None
    with open(name) as f:
        return json.load(f)


def _plant(root: str, rel: str) -> None:
    name = os.path.join(root, rel)
    os.makedirs(os.path.dirname(name), exist_ok=True)
    with open(name, "wb") as f:
        f.write(b"x")


def _check_pair(ref: str, port: str, **kw) -> list:
    """The dry run, then the real run, equal in both packages; the rows
    each reads from its copy unchanged. Returns the deleted set."""
    before = ref_rows(ref)
    r, p = _both(ref, port, dry_run=True, **kw)
    assert sorted(r.files_deleted) == sorted(p.files_deleted)
    assert r.dry_run and p.dry_run and p.type_of_vacuum == r.type_of_vacuum
    dry = sorted(p.files_deleted)
    r, p = _both(ref, port, **kw)
    assert sorted(r.files_deleted) == sorted(p.files_deleted) == dry
    for rel in dry:
        assert not os.path.exists(os.path.join(port, rel))
    assert _watermark(ref) == _watermark(port)
    assert same_rows(ref_rows(ref), before)
    assert same_rows(port_rows(pta.read_table(port, engine=CPU)), before)
    return dry


# -------------------------------------------------- one table, a case --

def _dv_delete(src):
    ref_dml.delete(_ref(src), RE.col("k") < RE.lit(5))
    ref_dml.delete(_ref(src), RE.col("k") == RE.lit(40))


def _cow_delete(src):
    ref_dml.delete(_ref(src), RE.col("k") < RE.lit(35))


def _update(src):
    ref_dml.update(_ref(src), {"v": RE.lit(1.5)}, RE.col("k") > RE.lit(80))


def _merge(src):
    source = _data(50, 60)
    (ref_merge.merge(_ref(src), source,
                     RE.col("target.k") == RE.col("source.k"))
     .when_matched_update_all().when_not_matched_insert_all().execute())


def _optimize(src):
    _ref(src).optimize().execute_compaction()


def _overwrite(src):
    dta.write_table(src, _data(100, 20), mode="overwrite",
                    engine=HostEngine())


def _replace_where(src):
    dta.write_table(src, _data(0, 20), mode="overwrite",
                    replace_where=RE.col("k") < RE.lit(20),
                    engine=HostEngine())


CASES = {
    "dv_delete": (DV, False, [_dv_delete]),
    "cow_delete": (None, False, [_cow_delete]),
    "update": (None, False, [_update]),
    "merge": (None, False, [_merge]),
    "optimize": (DV, False, [_dv_delete, _optimize]),
    "overwrite": (None, False, [_overwrite]),
    "replace_where": (None, False, [_replace_where]),
    "partitioned_dv_delete": (DV, True, [_dv_delete, _update]),
    "partitioned_optimize": (None, True, [_cow_delete, _optimize]),
    "mapped": ({**DV, **NAME}, False, [_dv_delete, _update]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_vacuum_after_each_command(tmp_path, case):
    props, part, steps = CASES[case]
    src = str(tmp_path / "src")
    _write(src, props=props, part=part)
    for step in steps:
        step(src)
    _age(src)
    ref, port = _copies(tmp_path, src)
    state = _port(port).latest_snapshot().state
    gone = ({a.path for a in state.tombstones}
            - {a.path for a in state.add_files})
    deleted = _check_pair(ref, port, retention_hours=0)
    # every file only a tombstone names goes (a DV'd file stays live)
    assert gone <= set(deleted)
    assert _watermark(port) == {
        "latestCommitVersionOutsideOfRetentionWindow":
            _port(port).latest_snapshot().version}


def test_recent_tombstones_and_young_files_survive(tmp_path):
    src = str(tmp_path / "src")
    _write(src, props=DV)
    _dv_delete(src)
    _cow_delete(src)
    _plant(src, "orphan-old.parquet")
    _age(src)
    _plant(src, "orphan-young.parquet")
    ref, port = _copies(tmp_path, src)
    # the tombstones' deletionTimestamps are recent: inside 1 hour
    assert _check_pair(ref, port, retention_hours=1) == ["orphan-old.parquet"]
    assert os.path.exists(os.path.join(port, "orphan-young.parquet"))
    # the default retention (7 days) keeps even the old orphan
    r, p = _both(ref, port, dry_run=True)
    assert r.files_deleted == p.files_deleted == []


def test_skewed_survivor_holds_the_watermark(tmp_path):
    src = str(tmp_path / "src")
    _write(src)
    _cow_delete(src)
    _age(src)
    ref, port = _copies(tmp_path, src)
    gone = sorted(a.path for a in _port(port).latest_snapshot().state
                  .tombstones)
    # one tombstoned file with an mtime an hour ahead of the clock
    ahead = time.time() + HOUR_S
    for root in (ref, port):
        os.utime(os.path.join(root, gone[0]), (ahead, ahead))
    deleted = _check_pair(ref, port, retention_hours=0)
    assert gone[0] not in deleted and set(gone[1:]) <= set(deleted)
    assert _watermark(port) is None


def test_hidden_and_change_data_paths(tmp_path):
    src = str(tmp_path / "src")
    _write(src, part=True)
    planted = ["_change_data/cdc-00000.parquet", "_change_data_x/q.parquet",
               "_tmp/x.parquet", ".x.parquet", "p=a/.y.parquet",
               "p=a/_z.parquet", "p=a/_sub/w.parquet", "sub/w.parquet",
               "sub/.hidden/v.parquet"]
    for rel in planted:
        _plant(src, rel)
    _age(src)
    ref, port = _copies(tmp_path, src)
    assert _check_pair(ref, port, retention_hours=0) == sorted([
        "_change_data/cdc-00000.parquet", "_change_data_x/q.parquet",
        "p=a/_sub/w.parquet", "sub/.hidden/v.parquet", "sub/w.parquet"])
    for rel in ("_tmp/x.parquet", ".x.parquet", "p=a/.y.parquet",
                "p=a/_z.parquet"):
        assert os.path.exists(os.path.join(port, rel))


# ---------------------------------------------------------- inventory --

def _inventory_rows(root: str, outside: str) -> list:
    """(path, length, isDir, modificationTime) rows: every file of the
    table (absolute and relative spellings) and rows the walk could never
    yield."""
    now = int(time.time() * 1000)
    old = now - 2 * HOUR_S * 1000
    rows = []
    for i, (dirpath, _, files) in enumerate(os.walk(root)):
        for f in files:
            full = os.path.join(dirpath, f)
            rel = os.path.relpath(full, root)
            rows.append((full if i % 2 else rel, 1, False,
                         int(os.stat(full).st_mtime * 1000)))
    rows += [("../" + os.path.basename(outside), 1, False, old),
             (outside, 1, False, old), ("s3://bucket/t/x.parquet", 1, False,
                                        old),
             ("sub/../../escape.parquet", 1, False, old),
             ("p=a", 0, True, old), ("never-listed.parquet", 1, False, old),
             ("unknown-age.parquet", 1, False, None),
             ("_tmp/h.parquet", 1, False, old), ("p=a/.h.parquet", 1, False,
                                                 old),
             ("young.parquet", 1, False, now + HOUR_S * 1000)]
    return rows


def test_inventory(tmp_path):
    src = str(tmp_path / "src")
    _write(src, props=DV, part=True)
    _dv_delete(src)
    _age(src)
    ref, port = _copies(tmp_path, src)
    outside = str(tmp_path / "outside.parquet")
    _plant(str(tmp_path), "outside.parquet")
    rows = _inventory_rows(port, outside)
    rows_ref = [((p.replace(port, ref, 1) if p.startswith(port) else p),
                 n, d, t) for p, n, d, t in rows]
    names = ("path", "length", "isDir", "modificationTime")
    inv_ref = pa.table({c: pa.array([r[i] for r in rows_ref]) for i, c in
                        enumerate(names)})
    paths, lens, dirs, mtimes = zip(*rows)
    batch = Batch({
        "path": as_column(np.array(paths, object)),
        "length": as_column(np.array(lens, np.int64)),
        "isDir": as_column(np.array(dirs, bool)),
        "modificationTime": as_column((
            np.array([t or 0 for t in mtimes], np.int64),
            np.array([t is not None for t in mtimes]))),
    })
    r = ref_vacuum(_ref(ref), retention_hours=0, dry_run=True,
                   inventory=inv_ref)
    p = port_vacuum(_port(port), retention_hours=0, dry_run=True,
                    inventory=batch)
    mapping = {c: [r_[i] for r_ in rows] for i, c in enumerate(names)}
    m = port_vacuum(_port(port), retention_hours=0, dry_run=True,
                    inventory=mapping)
    assert sorted(r.files_deleted) == sorted(p.files_deleted) \
        == sorted(m.files_deleted)
    assert "never-listed.parquet" in p.files_deleted
    for bad in ("outside.parquet", "escape.parquet", "x.parquet",
                "unknown-age.parquet", "young.parquet", "h.parquet"):
        assert not any(f.endswith(bad) for f in p.files_deleted)
    # a real inventory run deletes what it lists and leaves the watermark
    r = ref_vacuum(_ref(ref), retention_hours=0, inventory=inv_ref)
    p = port_vacuum(_port(port), retention_hours=0, inventory=batch)
    assert sorted(r.files_deleted) == sorted(p.files_deleted)
    assert _watermark(port) is None and _watermark(ref) is None
    assert os.path.exists(outside)
    assert same_rows(port_rows(pta.read_table(port, engine=CPU)),
                     ref_rows(ref))


def test_inventory_schema_refused(tmp_path):
    src = str(tmp_path / "src")
    _write(src, rows=(10,))
    ref, port = _copies(tmp_path, src)
    with pytest.raises(RefError) as r:
        ref_vacuum(_ref(ref), inventory=pa.table({"path": ["x"]}))
    with pytest.raises(DeltaError) as p:
        port_vacuum(_port(port), inventory={"path": ["x"]})
    assert r.value.error_class == p.value.error_class \
        == "DELTA_INVALID_INVENTORY_SCHEMA"


# --------------------------------------------------------------- LITE --

def test_lite_and_its_watermark(tmp_path):
    src = str(tmp_path / "src")
    _write(src, props=DV)
    _dv_delete(src)
    _cow_delete(src)
    _plant(src, "untracked.parquet")
    _age(src)
    ref, port = _copies(tmp_path, src)
    deleted = _check_pair(ref, port, retention_hours=0, vacuum_type="LITE")
    assert "untracked.parquet" not in deleted and deleted
    head = _port(port).latest_snapshot().version
    assert _watermark(port) == {
        "latestCommitVersionOutsideOfRetentionWindow": head}
    # nothing new: an empty range, the watermark kept
    r, p = _both(ref, port, retention_hours=0, vacuum_type="LITE")
    assert r.files_deleted == p.files_deleted == []
    assert (r.eligible_start_commit_version, r.eligible_end_commit_version) \
        == (p.eligible_start_commit_version,
            p.eligible_end_commit_version) == (None, head)
    # one more commit: the range starts after the watermark
    for root in (ref, port):
        ref_dml.delete(_ref(root), RE.col("k") >= RE.lit(60))
        _age(root)
    r, p = _both(ref, port, retention_hours=0, vacuum_type="LITE")
    assert sorted(r.files_deleted) == sorted(p.files_deleted) != []
    assert (p.eligible_start_commit_version,
            p.eligible_end_commit_version) == (head + 1, head + 1) == (
        r.eligible_start_commit_version, r.eligible_end_commit_version)
    assert _watermark(ref) == _watermark(port)
    # FULL afterwards finds the untracked file alone
    r, p = _both(ref, port, retention_hours=0, dry_run=True)
    assert r.files_deleted == p.files_deleted == ["untracked.parquet"]


def test_lite_gap_after_log_cleanup(tmp_path):
    src = str(tmp_path / "src")
    _write(src, rows=(10, 10, 10, 10))
    _ref(src).checkpoint(2)
    _age(src)
    ref, port = _copies(tmp_path, src)
    for root in (ref, port):
        os.remove(os.path.join(root, "_delta_log", f"{0:020d}.json"))
    with pytest.raises(RefError) as r:
        ref_vacuum(_ref(ref), retention_hours=0, vacuum_type="LITE")
    with pytest.raises(DeltaError) as p:
        port_vacuum(_port(port), retention_hours=0, vacuum_type="LITE")
    assert r.value.error_class == p.value.error_class \
        == "DELTA_CANNOT_VACUUM_LITE"
    # a watermark right below the earliest commit closes the gap
    for root in (ref, port):
        with open(os.path.join(root, "_delta_log", "_last_vacuum_info"),
                  "w") as f:
            json.dump({"latestCommitVersionOutsideOfRetentionWindow": 0}, f)
    r, p = _both(ref, port, retention_hours=0, vacuum_type="LITE")
    assert r.files_deleted == p.files_deleted == []
    assert (r.eligible_start_commit_version, r.eligible_end_commit_version) \
        == (p.eligible_start_commit_version, p.eligible_end_commit_version) \
        == (1, 3)


def test_lite_paths_from_the_log(tmp_path):
    """Tombstones naming '..', absolute, '://' and percent-escaped
    absolute paths, and a CDC file, in a commit of their own."""
    src = str(tmp_path / "src")
    _write(src, rows=(10,))
    _plant(str(tmp_path), "outside.parquet")
    _plant(src, "_change_data/cdc-1.parquet")
    _plant(src, "gone%20once.parquet")
    removes = ["../outside.parquet", str(tmp_path / "outside.parquet"),
               "s3://bucket/t/part-1.parquet", "%2Fetc%2Fhostname",
               "sub/../../outside.parquet", "gone%2520once.parquet"]
    lines = [{"remove": {"path": p, "deletionTimestamp": 1000,
                         "dataChange": True}} for p in removes]
    lines.append({"cdc": {"path": "_change_data/cdc-1.parquet",
                          "partitionValues": {}, "size": 1,
                          "dataChange": False}})
    with open(os.path.join(src, "_delta_log", f"{1:020d}.json"), "w") as f:
        f.write("".join(json.dumps(a) + "\n" for a in lines))
    _age(src)
    ref, port = _copies(tmp_path, src)
    r, p = _both(ref, port, retention_hours=0, dry_run=True,
                 vacuum_type="LITE")
    assert sorted(r.files_deleted) == sorted(p.files_deleted) == [
        "_change_data/cdc-1.parquet", "gone%20once.parquet"]
    r, p = _both(ref, port, retention_hours=0, dry_run=True)
    assert sorted(r.files_deleted) == sorted(p.files_deleted) == [
        "_change_data/cdc-1.parquet", "gone%20once.parquet"]


# ------------------------------------------------------------- checks --

@pytest.mark.parametrize("kw, error_class", [
    ({"vacuum_type": "MEDIUM"}, "DELTA_ILLEGAL_ARGUMENT"),
    ({"vacuum_type": "lite", "inventory": {}}, "DELTA_ILLEGAL_ARGUMENT"),
    ({"retention_hours": -1}, "DELTA_UNSAFE_VACUUM_RETENTION"),
])
def test_argument_checks(tmp_path, kw, error_class):
    src = str(tmp_path / "src")
    _write(src, rows=(10,))
    ref, port = _copies(tmp_path, src)
    ref_kw = dict(kw)
    if "inventory" in ref_kw:
        ref_kw["inventory"] = pa.table({"path": pa.array([], pa.string())})
    with pytest.raises(RefError) as r:
        ref_vacuum(_ref(ref), **ref_kw)
    with pytest.raises(DeltaError) as p:
        port_vacuum(_port(port), **kw)
    assert r.value.error_class == p.value.error_class == error_class
    # the check can be turned off: a negative retention vacuums nothing new
    if "retention_hours" in kw:
        r, p = _both(ref, port, retention_hours=-1, dry_run=True,
                     enforce_retention_check=False)
        assert r.files_deleted == p.files_deleted == []


# --------------------------------------------- the port's own tables --

ODD_VALUES = ("a b", "c%d", "x=y", "plain")


def test_port_tables_with_escaped_names_keep_live_files(tmp_path):
    """The port writes partition values holding a space, '%' and '='
    (each on disk as its log path decodes once), deletes by DVs and by
    copy-on-write; both packages' VACUUMs agree and every live file
    stays."""
    src = str(tmp_path / "src")
    k = np.arange(40)
    cols = {"k": k, "p": np.array([ODD_VALUES[j % 4] for j in k], object)}
    pta.write_table(src, cols, mode="error", partition_by=["p"],
                    engine=CPU, properties=DV)
    pta.write_table(src, {"k": k + 40, "p": cols["p"]}, engine=CPU)
    port_dml.delete(_port(src), PE.col("k") < PE.lit(6))
    port_dml.delete(_port(src), PE.col("k") >= PE.lit(70))
    _plant(src, "p=c%d/orphan.parquet")
    _age(src)
    ref, port = _copies(tmp_path, src)
    live = [a.path for a in _port(port).latest_snapshot().state.add_files]
    assert any("%" in p for p in live) and any(" " in p for p in live)
    deleted = _check_pair(ref, port, retention_hours=0)
    assert "p=c%d/orphan.parquet" in deleted
    for rel in live:
        assert os.path.exists(os.path.join(port, rel))
    got = port_rows(pta.read_table(port, engine=CPU))
    assert sorted(r["k"] for r in got) == list(range(6, 70))


def test_reference_vacuums_its_escaped_live_files(tmp_path):
    """C22, pinned: the reference's dry run on its own partitioned table
    names the live files of values that need an escape; the port's
    dry run on its own table of the same values names none."""
    src = str(tmp_path / "ref")
    dta.write_table(src, pa.table({"k": pa.array([1, 2, 3, 4], pa.int64()),
                                   "p": ["a b", "c%d", "x", "x"]}),
                    partition_by=["p"], engine=HostEngine())
    port = str(tmp_path / "port")
    pta.write_table(port, {"k": np.array([1, 2, 3, 4]),
                           "p": np.array(["a b", "c%d", "x", "x"], object)},
                    mode="error", partition_by=["p"], engine=CPU)
    _age(src)
    _age(port)
    r = ref_vacuum(_ref(src), retention_hours=0, dry_run=True)
    p = port_vacuum(_port(port), retention_hours=0, dry_run=True)
    assert p.files_deleted == []
    named = sorted(f.split("/", 1)[0] for f in r.files_deleted)
    if _REFERENCE_VACUUMS_ESCAPED_LIVE:
        assert named == ["p=a%20b", "p=c%25d"]
    else:
        assert named == []

"""DELETE and UPDATE: the port's `commands/dml.py` against the JAX
package's on copies of one reference-written table.

The reference (`delta_tpu.api.write_table`, `HostEngine`) writes a table
of a few appends (k int64 0..n-1 in file order, x float64 from a seed, s
string with nulls, b bool), which is copied; the reference's command runs
on one copy and the port's (`TorchEngine("cpu")`: every kernel's plain
version) on the other. Compared, exactly:

- `DMLMetrics`, and the commit's operation, parameters and metrics (but
  the byte counts of the files each writer writes);
- the rows each package reads from each copy, as a multiset;
- every live file's deletion-vector blob, byte for byte, and its
  cardinality; the live and tombstone counts.

Cases: the DV and full-remove branches in one DELETE, copy-on-write, a
second DELETE over a DV'd file, DELETE with no predicate, nothing matched,
a dense DELETE (bitmap containers, packed by K8's plain version),
append-only tables refused, change-data-feed tables (their change data
and feed against the reference's), UPDATE of a DV'd file
with a constant, an expression and a callable, an identity column and an
unknown column refused, OPTIMIZE purging DVs, a checkpoint of a DV table
written by either package and read back by both, `Table.update()`
advancing over a DELETE equal to the cold load, concurrent DELETEs of
one file (the same conflict class), a DV table created by the port's
`write_table`, UPDATE's SET casts against Arrow's, one call of K8's
wrapper per command for all the DVs it reads (and one per DV file it
writes), and a candidate without a true `numRecords` decoded alone.
"""

import dataclasses
import datetime
import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pytest
import torch

import delta_tpu.api as dta
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.optimize as ref_opt  # noqa: F401 (Table.optimize)
import delta_tpu.dv.descriptor as ref_desc
import delta_tpu.expressions.tree as RE
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefDeltaError
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.commands.dml as port_dml
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.api import read_table, write_table
from delta_tpu_torch.errors import DeltaError
from delta_tpu_torch.expressions.eval import (
    UnsupportedCast,
    cast_values,
    constant_values,
    literal_values,
)
from test_torch_cdf import port_changes_of, ref_changes_of

DV = {"delta.enableDeletionVectors": "true"}


def _data(rng, lo, rows):
    k = np.arange(lo, lo + rows)
    s = pa.array([f"v{j % 37}" for j in k], pa.string(), mask=k % 11 == 0)
    return pa.table({"k": pa.array(k, pa.int64()),
                     "x": pa.array(rng.normal(size=rows)),
                     "s": s, "b": pa.array(k % 3 == 0)})


def _make(tmp_path, props=None, rows=(300, 300, 300, 300), seed=0):
    """The reference writes one table of len(rows) appends; returns the
    paths of its two copies (ref, port)."""
    rng = np.random.default_rng(seed)
    src = str(tmp_path / "src")
    lo = 0
    for i, n in enumerate(rows):
        dta.write_table(src, _data(rng, lo, n), engine=HostEngine(),
                        properties=props if i == 0 else None)
        lo += n
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port


def _ref_table(path):
    return RefTable.for_path(path, engine=HostEngine())


def _port_table(path):
    return Table.for_path(path, engine=TorchEngine("cpu"))


def _rows_ref(path):
    t = dta.read_table(path, engine=HostEngine())
    return sorted(zip(*(t.column(c).to_pylist() for c in ("k", "x", "s",
                                                           "b"))), key=repr)


def _rows_port(path):
    b = read_table(path, engine=TorchEngine("cpu"))
    cols = []
    for c in ("k", "x", "s", "b"):
        col = b.column(c)
        vals = col.values.tolist()
        if col.valid is not None:
            vals = [v if ok else None for v, ok in zip(vals, col.valid)]
        cols.append(vals)
    return sorted(zip(*cols), key=repr)


def _commit(path, version):
    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _commit_summary(path, version):
    out = {"add": [], "remove": []}
    info = None
    for a in _commit(path, version):
        (key, body), = a.items()
        if key == "commitInfo":
            info = body
        elif key in out:
            dv = body.get("deletionVector")
            out[key].append((body["dataChange"],
                             dv["cardinality"] if dv else None))
    metrics = {k: v for k, v in info["operationMetrics"].items()
               if "Bytes" not in k}
    return (info["operation"], info["operationParameters"], metrics,
            sorted(out["add"], key=repr), sorted(out["remove"], key=repr))


def _live(path):
    """Per live file: (path, or '<new>' for a file the command wrote; its
    DV blob and cardinality), and the tombstone count, from the port's
    load and the reference's."""
    original = set(os.listdir(os.path.join(path, "..", "src")))
    port_state = _port_table(path).latest_snapshot().state
    ref_state = _ref_table(path).latest_snapshot().state
    views = []
    for adds, n_tomb in ((port_state.add_files, len(port_state.tombstones)),
                         (ref_state.add_files(),
                          len(ref_state.tombstones()))):
        files = []
        for a in adds:
            dv = a.deletionVector
            blob = card = None
            if dv is not None:
                blob, _ = ref_desc._load_blob(HostEngine(), path,
                                              dv.to_dict())
                card = dv.cardinality
            files.append((a.path if a.path in original else "<new>",
                          blob, card))
        views.append((sorted(files, key=repr), n_tomb))
    assert views[0] == views[1]
    return views[0]


def _check_same(ref, port, rm, pm):
    """Metrics, the commit, the rows read by both packages from both
    copies, the live files with their DV blobs."""
    assert dataclasses.asdict(rm) == dataclasses.asdict(pm)
    if rm.version is not None:
        assert _commit_summary(ref, rm.version) == \
            _commit_summary(port, pm.version)
    rows = _rows_ref(ref)
    assert _rows_ref(port) == rows
    assert _rows_port(ref) == rows
    assert _rows_port(port) == rows
    assert _live(ref) == _live(port)
    return rows


def _delete_both(ref, port, pred):
    rm = ref_dml.delete(_ref_table(ref), None if pred is None
                        else pred(RE))
    pm = port_dml.delete(_port_table(port), None if pred is None
                         else pred(PE))
    return rm, pm


def _some_and_all(E):
    # file 0 partly (a DV), file 3 wholly (a full remove)
    return (E.col("k") < E.lit(150)) | (E.col("k") >= E.lit(900))


def test_delete_dv_and_full_remove_branches(tmp_path):
    ref, port = _make(tmp_path, DV)
    rm, pm = _delete_both(ref, port, _some_and_all)
    rows = _check_same(ref, port, rm, pm)
    assert pm.num_dvs_written == 1 and pm.num_files_removed_fully == 1
    assert len(rows) == 1200 - 150 - 300
    files, n_tomb = _live(port)
    assert n_tomb == 2 and sum(c is not None for _, _, c in files) == 1


def test_delete_copy_on_write(tmp_path):
    ref, port = _make(tmp_path)
    rm, pm = _delete_both(ref, port, _some_and_all)
    _check_same(ref, port, rm, pm)
    assert pm.num_files_rewritten == 1 and pm.num_rows_copied == 150
    assert pm.num_dvs_written == 0


def test_second_delete_over_a_dv_file(tmp_path):
    ref, port = _make(tmp_path, DV)
    _check_same(ref, port, *_delete_both(
        ref, port, lambda E: E.col("k") < E.lit(100)))
    rm, pm = _delete_both(ref, port, lambda E: (E.col("k") >= E.lit(50))
                          & (E.col("k") < E.lit(400)) & E.col("b"))
    _check_same(ref, port, rm, pm)
    assert pm.num_dvs_written == 2  # the DV'd file 0 and file 1


def test_delete_without_predicate(tmp_path):
    ref, port = _make(tmp_path, DV)
    _delete_both(ref, port, lambda E: E.col("k") < E.lit(10))
    rm, pm = _delete_both(ref, port, None)
    assert _check_same(ref, port, rm, pm) == []
    assert pm.num_rows_deleted == 1200  # from the files' stats


def test_delete_matching_nothing_commits_nothing(tmp_path):
    ref, port = _make(tmp_path, DV)
    rm, pm = _delete_both(ref, port, lambda E: E.col("x") > E.lit(1e9))
    assert rm.version is None and pm.version is None
    _check_same(ref, port, rm, pm)
    assert len(os.listdir(os.path.join(port, "_delta_log"))) == \
        len(os.listdir(os.path.join(ref, "_delta_log")))


def test_dense_delete_packs_bitmap_containers(tmp_path):
    ref, port = _make(tmp_path, DV, rows=(20_000, 70_000))
    rm, pm = _delete_both(ref, port, lambda E: E.col("x") > E.lit(-0.5))
    _check_same(ref, port, rm, pm)
    # a second DELETE unions with the decoded masks
    rm, pm = _delete_both(ref, port, lambda E: E.col("k") < E.lit(66_000))
    _check_same(ref, port, rm, pm)


def _spy_dv_tiles(monkeypatch) -> list:
    """Record each call the DV codec makes of K8's wrapper, "pack" or
    "decode"."""
    import delta_tpu_torch.dv.roaring as port_roaring

    calls, launch = [], port_roaring.dv_tiles

    def spy(*args, **kw):
        calls.append("pack" if kw.get("pack") else "decode")
        return launch(*args, **kw)

    monkeypatch.setattr(port_roaring, "dv_tiles", spy)
    return calls


def test_each_command_decodes_its_dvs_in_one_call(tmp_path, monkeypatch):
    """On a 5-file DV table (the first file dense: bitmap containers),
    read_table, a DELETE over every DV'd file, an UPDATE and OPTIMIZE
    each call K8's wrapper once to decode every DV they read, and each
    DELETE's DV file packs its bitmap containers in one call; the rows
    stay the reference's."""
    ref, port = _make(tmp_path, DV, rows=(70_000, 300, 300, 300, 300))
    calls = _spy_dv_tiles(monkeypatch)

    def step(fn):
        calls.clear()
        fn()
        return list(calls)

    assert step(lambda: _delete_both(
        ref, port, lambda E: E.col("x") > E.lit(0.0))) == ["pack"]
    assert _rows_port(port) == _rows_ref(ref)
    assert step(lambda: read_table(port, engine=TorchEngine("cpu"))) \
        == ["decode"]
    assert step(lambda: _delete_both(ref, port, lambda E: E.col("b"))) \
        == ["decode", "pack"]
    assert step(lambda: (
        ref_dml.update(_ref_table(ref), {"x": 0.5}, RE.col("k") < RE.lit(9)),
        port_dml.update(_port_table(port), {"x": 0.5},
                        PE.col("k") < PE.lit(9)))) == ["decode"]
    assert step(lambda: (_ref_table(ref).optimize().execute_compaction(),
                         _port_table(port).optimize().execute_compaction())
                ) == ["decode"]
    rows = _rows_ref(ref)
    assert _rows_ref(port) == _rows_port(ref) == _rows_port(port) == rows


@pytest.mark.parametrize("stat", ["missing", "wrong"])
def test_a_dv_file_without_a_true_num_records_decodes_alone(
        tmp_path, monkeypatch, stat):
    """DML sizes its one batch of DV decodes by each file's numRecords;
    a file whose statistic is missing or disagrees with its read is
    decoded alone after the read, with the same result."""
    ref, port = _make(tmp_path, DV)
    _check_same(ref, port, *_delete_both(ref, port, _some_and_all))
    monkeypatch.setattr(port_dml, "_records",
                        lambda add: None if stat == "missing" else 7)
    alone = obs.counter("dml.dv_single_decodes")
    before = alone.read()
    rm, pm = _delete_both(ref, port, lambda E: E.col("b"))
    _check_same(ref, port, rm, pm)
    assert alone.read() - before == 1  # file 0, the one DV'd file left


def _refusal(ref_fn, port_fn):
    with pytest.raises(RefDeltaError) as r:
        ref_fn()
    with pytest.raises(DeltaError) as p:
        port_fn()
    assert p.value.error_class == r.value.error_class
    return p.value.error_class


def test_append_only_refused(tmp_path):
    ref, port = _make(tmp_path, {"delta.appendOnly": "true"})
    pred = lambda E: E.col("k") < E.lit(5)  # noqa: E731
    assert _refusal(lambda: ref_dml.delete(_ref_table(ref), pred(RE)),
                    lambda: port_dml.delete(_port_table(port), pred(PE))) \
        == "DELTA_CANNOT_MODIFY_APPEND_ONLY"
    assert _refusal(
        lambda: ref_dml.update(_ref_table(ref), {"x": RE.lit(1.0)}),
        lambda: port_dml.update(_port_table(port), {"x": PE.lit(1.0)})) \
        == "DELTA_CANNOT_MODIFY_APPEND_ONLY"


@pytest.mark.parametrize("props", [{"delta.enableChangeDataFeed": "true"},
                                   dict(DV, **{
                                       "delta.enableChangeDataFeed": "true"})])
def test_change_data_feed_table_refused(tmp_path, props):
    """Refused until the change data feed was ported: now a CDF table
    (with and without deletion vectors) takes DELETE and UPDATE as the
    reference does (metrics, commits, rows, DVs), each commit carries
    change data, and the feeds are equal (`tests/test_torch_cdf.py`
    holds the feed in full)."""
    ref, port = _make(tmp_path, props)
    rm, pm = _delete_both(ref, port, _some_and_all)
    _check_same(ref, port, rm, pm)
    pred = (lambda E: (E.col("k") >= E.lit(600))
            & (E.col("k") < E.lit(610)))
    rm = ref_dml.update(_ref_table(ref), {"x": 0.0}, pred(RE))
    pm = port_dml.update(_port_table(port), {"x": 0.0}, pred(PE))
    _check_same(ref, port, rm, pm)
    for v in (pm.version - 1, pm.version):
        assert any("cdc" in a for a in _commit(port, v))
    assert port_changes_of(port, 4) == ref_changes_of(ref, 4)


def _updates():
    return {
        "constant": (lambda E: {"x": 2.5, "s": "new", "b": None},
                     lambda E: E.col("k") < E.lit(200)),
        "expression": (lambda E: {"x": E.col("k"), "b": E.col("x") > E.lit(0),
                                  "s": E.lit(None)},
                       lambda E: (E.col("k") >= E.lit(100))
                       & (E.col("k") < E.lit(700))),
        "no_predicate": (lambda E: {"k": E.lit(7)}, lambda E: None),
    }


@pytest.mark.parametrize("case", sorted(_updates()))
def test_update_of_dv_files(tmp_path, case):
    assign, pred = _updates()[case]
    ref, port = _make(tmp_path, DV)
    _check_same(ref, port, *_delete_both(
        ref, port, lambda E: (E.col("k") < E.lit(50))
        | (E.col("k") >= E.lit(650)) & (E.col("k") < E.lit(700))))
    rm = ref_dml.update(_ref_table(ref), assign(RE), pred(RE))
    pm = port_dml.update(_port_table(port), assign(PE), pred(PE))
    _check_same(ref, port, rm, pm)
    assert pm.num_rows_updated > 0


def test_update_with_a_callable(tmp_path):
    ref, port = _make(tmp_path, DV)
    rm = ref_dml.update(
        _ref_table(ref),
        {"x": lambda t: pa.array(np.asarray(t.column("k")) * 0.5),
         "s": lambda t: pa.array([f"w{v}" for v in t.column("k")
                                 .to_pylist()])},
        RE.col("b"))
    pm = port_dml.update(
        _port_table(port),
        {"x": lambda b: b.column("k").values * 0.5,
         "s": lambda b: np.array([f"w{v}" for v in b.column("k").values])},
        PE.col("b"))
    _check_same(ref, port, rm, pm)


def test_update_refusals(tmp_path):
    ref, port = _make(tmp_path)
    assert _refusal(
        lambda: ref_dml.update(_ref_table(ref), {"nope": 1}),
        lambda: port_dml.update(_port_table(port), {"nope": 1})) \
        == "DELTA_MISSING_SET_COLUMN"
    # k becomes an identity column (a metaData action by hand)
    for path in (ref, port):
        meta = next(a["metaData"] for a in _commit(path, 0)
                    if "metaData" in a)
        schema = json.loads(meta["schemaString"])
        schema["fields"][0]["metadata"] = {"delta.identity.start": 1,
                                           "delta.identity.step": 1}
        meta["schemaString"] = json.dumps(schema)
        with open(os.path.join(path, "_delta_log", f"{4:020d}.json"),
                  "w") as f:
            f.write(json.dumps({"metaData": meta}) + "\n")
    assert _refusal(
        lambda: ref_dml.update(_ref_table(ref), {"k": 1}),
        lambda: port_dml.update(_port_table(port), {"k": 1})) \
        == "DELTA_IDENTITY_COLUMNS_UPDATE_NOT_SUPPORTED"
    rm = ref_dml.update(_ref_table(ref), {"x": 0.0}, RE.col("k") < RE.lit(3))
    pm = port_dml.update(_port_table(port), {"x": 0.0},
                         PE.col("k") < PE.lit(3))
    _check_same(ref, port, rm, pm)


def test_optimize_purges_deletion_vectors(tmp_path):
    ref, port = _make(tmp_path, DV)
    _delete_both(ref, port, lambda E: E.col("b") | (E.col("k") < E.lit(40)))
    rm = _ref_table(ref).optimize().execute_compaction()
    pm = _port_table(port).optimize().execute_compaction()
    assert (rm.num_files_removed, rm.num_files_added) == \
        (pm.num_files_removed, pm.num_files_added) == (4, 1)
    assert _commit_summary(ref, rm.version) == \
        _commit_summary(port, pm.version)
    rows = _rows_ref(ref)
    assert _rows_ref(port) == _rows_port(ref) == _rows_port(port) == rows
    files, _ = _live(port)
    assert files == [("<new>", None, None)]  # no DV left
    removes = _commit_summary(port, pm.version)[4]
    assert all(dv is not None for _, dv in removes)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_of_a_dv_table_reloads(tmp_path, writer):
    ref, port = _make(tmp_path, DV)
    rm, pm = _delete_both(ref, port, _some_and_all)
    _delete_both(ref, port, lambda E: E.col("k") < E.lit(200))
    for path in (ref, port):
        obs.reset()
        if writer == "ref":
            _ref_table(path).checkpoint()
        else:
            _port_table(path).checkpoint()
            # the write's aggregate lane: the live DVs' cardinalities
            assert obs.counters()["checkpoint.dv_cardinality"] == sum(
                a.deletionVector.cardinality for a in _port_table(path)
                .latest_snapshot().state.add_files if a.deletionVector)
        assert any(n.endswith(".checkpoint.parquet")
                   for n in os.listdir(os.path.join(path, "_delta_log")))
    from delta_tpu.replay.columnar import clear_parse_cache

    clear_parse_cache()
    assert _live(ref) == _live(port)
    rows = _rows_ref(ref)
    assert _rows_port(ref) == _rows_port(port) == _rows_ref(port) == rows
    st = _port_table(port).latest_snapshot().state
    assert st.file_actions.version.min() == 5  # rows from the checkpoint


def test_update_advances_over_a_delete(tmp_path):
    _, port = _make(tmp_path, DV)
    t = _port_table(port)
    t.latest_snapshot().state
    # another writer's DELETE, then the cached snapshot advances over it
    port_dml.delete(_port_table(port), _some_and_all(PE))
    obs.reset()
    advanced = t.update().state
    assert obs.counters()["replay.advances"] == 1
    assert obs.counters()["replay.reconstructs"] == 0
    cold = _port_table(port).snapshot_at(advanced.version).state

    def keys(st):
        return sorted((a.path, a.dv_unique_id) for a in st.add_files)

    assert keys(advanced) == keys(cold)
    assert sorted((r.path, r.dv_unique_id) for r in advanced.tombstones) \
        == sorted((r.path, r.dv_unique_id) for r in cold.tombstones)
    assert torch.equal(advanced.live_mask.sum(), cold.live_mask.sum())


def test_concurrent_deletes_of_one_file_conflict_alike(tmp_path,
                                                      monkeypatch):
    ref, port = _make(tmp_path, DV)

    def inject(module, name, action):
        real = getattr(module, name)
        done = []

        def wrapped(*args, **kwargs):
            if not done:
                done.append(True)
                action()
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    inject(ref_desc, "write_deletion_vector_file",
           lambda: ref_dml.delete(_ref_table(ref), RE.col("k") < RE.lit(5)))
    inject(port_dml, "write_deletion_vector_file",
           lambda: port_dml.delete(_port_table(port),
                                   PE.col("k") < PE.lit(5)))
    cls = _refusal(
        lambda: ref_dml.delete(_ref_table(ref), RE.col("k") > RE.lit(250)),
        lambda: port_dml.delete(_port_table(port),
                                PE.col("k") > PE.lit(250)))
    assert cls.startswith("DELTA_CONCURRENT")


def test_port_creates_a_dv_table(tmp_path):
    path = str(tmp_path / "t")
    rng = np.random.default_rng(3)
    write_table(path, {"k": np.arange(500), "x": rng.normal(size=500)},
                engine=TorchEngine("cpu"), properties=DV)
    p0 = next(a["protocol"] for a in _commit(path, 0) if "protocol" in a)
    ref_path = str(tmp_path / "r")
    dta.write_table(ref_path, pa.table({"k": np.arange(3)}),
                    engine=HostEngine(), properties=DV)
    assert p0 == next(a["protocol"] for a in _commit(ref_path, 0)
                      if "protocol" in a)
    m = port_dml.delete(_port_table(path), PE.col("x") > PE.lit(0.0))
    assert m.num_dvs_written == 1
    got = dta.read_table(path, engine=HostEngine())
    assert sorted(got.column("k").to_pylist()) == sorted(
        read_table(path, engine=TorchEngine("cpu")).column("k")
        .values.tolist())
    assert got.num_rows == 500 - m.num_rows_deleted


_SET_TYPES = {"long": pa.int64(), "integer": pa.int32(),
              "double": pa.float64(), "float": pa.float32(),
              "boolean": pa.bool_(), "string": pa.string(),
              "date": pa.date32(), "timestamp": pa.timestamp("us", "UTC")}
_SET_VALUES = [3, 2.0, 2.5, -2.7, True, False, "7", "x", "2.5", "TRUE",
               "2020-01-02", "1e3", "-inf", None, 1 << 40, float("nan"),
               float("inf"), datetime.date(2020, 1, 2),
               datetime.datetime(2020, 1, 2, 3, 4, 5),
               datetime.datetime(2020, 1, 2, 3, 4, 5,
                                 tzinfo=datetime.timezone.utc),
               3e10, 2 ** 53 + 1, 16777217, -(1 << 63), 9.2e18, 1e300,
               float("-inf"), -0.0, 0.1, 1e-7, 123456789.125, -2.5, 1 << 31,
               (1 << 31) - 1, -(1 << 31),
               datetime.datetime(1969, 12, 31, 23, 59, 59, 999999),
               datetime.datetime(2020, 1, 2, 1, 30, tzinfo=datetime.timezone(
                   datetime.timedelta(hours=5, minutes=30)))]


def _arrow_value(a: pa.Array):
    """The one value of `a`: a date as its days, a timestamp as its
    microseconds (read from the array's own integers, so that one past
    Python's datetime range reads too)."""
    if pa.types.is_date32(a.type):
        return a.view(pa.int32()).to_pylist()[0]
    if pa.types.is_timestamp(a.type):
        return a.view(pa.int64()).to_pylist()[0]
    return a.to_pylist()[0]


def _port_value(vals: np.ndarray, ok, type_name):
    if not ok:
        return None
    if type_name in ("date", "timestamp"):
        return int(vals.view(np.int64)[0])
    return vals.tolist()[0]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return np.isnan(b)
    return a == b and type(a) is type(b) or (
        isinstance(a, (int, float)) and not isinstance(a, bool)
        and type(a) is type(b) and a == b)


@pytest.mark.parametrize("mode", ["constant", "literal"])
@pytest.mark.parametrize("type_name", sorted(_SET_TYPES))
def test_set_values_cast_as_arrow_does(mode, type_name):
    """UPDATE's SET conversions: a constant as `pa.array([v], type)`, an
    expression's value as `.cast(type, safe=False)`."""
    t = _SET_TYPES[type_name]
    for v in _SET_VALUES:
        try:
            want = _arrow_value(pa.array([v], t) if mode == "constant"
                                else pa.array([v]).cast(t, safe=False))
        except (pa.ArrowException, ValueError, OverflowError):
            want = "refused"
        try:
            vals, valid = (constant_values(v, type_name, 1)
                           if mode == "constant"
                           else cast_values(literal_values(v, 1), type_name))
            got = _port_value(vals, bool(valid[0]), type_name)
        except UnsupportedCast:
            got = "refused"
        assert _same(want, got), (v, want, got)

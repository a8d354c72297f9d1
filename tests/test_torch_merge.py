"""MERGE: the port's `commands/merge.py` against the JAX package's on
copies of one reference-written table.

The reference (`delta_tpu.api.write_table`, `HostEngine`) writes a
table, which is copied; the reference's MERGE runs on one copy and the
port's (`TorchEngine("cpu")`: every kernel's plain version) on the other,
with the same source (a pyarrow table for the reference, the same numpy
columns for the port). Compared, exactly: `MergeMetrics`, the commit's
operation, parameters and metrics (but byte counts), the rows each
package reads from each copy as a multiset; or the same error class.

Cases: the cases of `tests/test_merge.py` the port supports (upsert,
matched delete with a condition, first clause wins, not matched by
source, cardinality, insert *, residual ON conjuncts, source columns in
another case, pruning by the source's key bounds, NULL and NaN keys,
duplicate assignments, clause validation) and of
`tests/test_device_join.py` (the device route with the threshold at 0:
equal to the host route, its cardinality error, duplicate sources in an
insert-only MERGE), a partitioned target with pruning by partition, a
deletion-vector target (soft-deleted rows neither match nor come back),
multi-key and string keys on the device route. The device route is
asserted through `join.device_joins` (a silent host route cannot pass);
K9 itself runs only on the card (`tests/test_torch_cuda.py`). Schema
evolution and identity and generated columns, refused until they were
ported, now run (the reference's NULLs pinned as C24); so does a table
with the change data feed on.
"""

import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.merge as ref_merge
import delta_tpu.expressions.tree as RE
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefDeltaError
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.commands.merge as port_merge
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.api import read_table
from delta_tpu_torch.errors import DeltaError
from test_torch_cdf import port_changes_of, ref_changes_of

CPU = TorchEngine("cpu")
METRICS = ("num_target_rows_updated", "num_target_rows_deleted",
           "num_target_rows_inserted", "num_target_rows_copied",
           "num_target_files_rewritten", "num_target_files_scanned",
           "num_source_rows", "version")


def _target(n=5, extra=None):
    cols = {"id": pa.array(np.arange(1, n + 1), pa.int64()),
            "value": pa.array(np.arange(1, n + 1) * 10.0),
            "status": pa.array(["a"] * n)}
    cols.update(extra or {})
    return pa.table(cols)


def _copies(tmp_path, tables, **kw):
    src = str(tmp_path / "src")
    for i, t in enumerate(tables):
        dta.write_table(src, t, engine=HostEngine(),
                        **(kw if i == 0 else {k: v for k, v in kw.items()
                                              if k == "partition_by"}))
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port


def _source(**cols):
    """{name: (values, valid)} -> (pyarrow table, the port's columns)."""
    arrays, port = {}, {}
    for name, (values, valid) in cols.items():
        values = np.asarray(values)
        mask = None if valid is None else ~np.asarray(valid, bool)
        arrays[name] = pa.array(values.tolist() if values.dtype == object
                                else values, mask=mask)
        port[name] = (values, valid)
    return pa.table(arrays), port


def _nan(v):
    return "NaN" if isinstance(v, float) and v != v else v


def _rows(path, who):
    """The rows as a sorted list of tuples (columns by name; NaN as a
    string, so that equal rows compare equal)."""
    if who == "ref":
        t = dta.read_table(path, engine=HostEngine())
        names = sorted(t.column_names)
        return sorted(zip(*([_nan(v) for v in t.column(c).to_pylist()]
                            for c in names)), key=repr)
    b = read_table(path, engine=CPU)
    names = sorted(b.column_names)
    cols = []
    for c in names:
        col = b.column(c)
        vals = col.values.tolist()
        if col.valid is not None:
            vals = [v if ok else None for v, ok in zip(vals, col.valid)]
        cols.append([_nan(v) for v in vals])
    return sorted(zip(*cols), key=repr)


def _commit(path, version):
    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        acts = [json.loads(line) for line in f if line.strip()]
    info = next(a["commitInfo"] for a in acts if "commitInfo" in a)
    return (info["operation"], info["operationParameters"],
            {k: v for k, v in info["operationMetrics"].items()
             if "Bytes" not in k},
            sum("add" in a for a in acts), sum("remove" in a for a in acts))


def _outcome(fn):
    try:
        return "ok", fn()
    except (DeltaError, RefDeltaError) as e:
        return "error", (type(e).__name__, e.error_class)


def _run_both(ref, port, src, build):
    """`build(merge_fn, table, source, E)` -> a builder, run by each
    package; the outcomes compared (module docstring). Returns the port's
    metrics (or its error)."""
    src_ref, src_port = src
    r = _outcome(lambda: build(
        ref_merge.merge, RefTable.for_path(ref, engine=HostEngine()),
        src_ref, RE).execute())
    p = _outcome(lambda: build(
        port_merge.merge, Table.for_path(port, engine=CPU), src_port,
        PE).execute())
    assert r[0] == p[0], (r, p)
    if r[0] == "error":
        assert r[1] == p[1]
        return p[1]
    rm, pm = r[1], p[1]
    assert {k: getattr(rm, k) for k in METRICS} == \
        {k: getattr(pm, k) for k in METRICS}
    if rm.version is not None:
        assert _commit(ref, rm.version) == _commit(port, pm.version)
    rows = _rows(ref, "ref")
    assert _rows(port, "ref") == rows
    assert _rows(ref, "port") == rows == _rows(port, "port")
    return pm


def _on(E, key="id"):
    return E.col(f"target.{key}") == E.col(f"source.{key}")


# ------------------------------------------- tests/test_merge.py's cases


def _ids(ids, values, ops=None):
    cols = {"id": (np.array(ids, np.int64), None),
            "value": (np.array(values, np.float64), None)}
    if ops is not None:
        cols["op"] = (np.array(ops, object), None)
    return _source(**cols)


def _upsert(m, t, s, E):
    return (m(t, s, on=_on(E))
            .when_matched_update(set={"value": E.col("source.value")})
            .when_not_matched_insert(values={
                "id": E.col("source.id"), "value": E.col("source.value"),
                "status": E.lit("new")}))


CASES = {
    "upsert": (_ids([3, 4, 6, 7], [300.0, 400.0, 600.0, 700.0]), _upsert),
    "matched_delete_with_condition": (
        _ids([1, 2, 3], [0.0, 0.0, 0.0], ["del", "keep", "del"]),
        lambda m, t, s, E: m(t, s, on=_on(E))
        .when_matched_delete(condition=E.col("source.op") == E.lit("del"))
        .when_matched_update(set={"value": E.col("source.value")})),
    "clause_order_first_wins": (
        _ids([1], [99.0]),
        lambda m, t, s, E: m(t, s, on=_on(E))
        .when_matched_update(set={"value": E.lit(111.0)},
                             condition=E.col("target.value") < E.lit(15.0))
        .when_matched_update(set={"value": E.lit(222.0)})),
    "not_matched_by_source_delete": (
        _ids([1, 2], [0.0, 0.0]),
        lambda m, t, s, E: m(t, s, on=_on(E))
        .when_matched_update(set={"value": E.col("source.value")})
        .when_not_matched_by_source_delete()),
    "not_matched_by_source_update": (
        _ids([1, 2], [0.0, 0.0]),
        lambda m, t, s, E: m(t, s, on=_on(E))
        .when_not_matched_by_source_update(
            set={"status": E.lit("gone"), "value": E.col("target.id")},
            condition=E.col("target.id") > E.lit(3))
        .when_not_matched_by_source_delete()),
    "cardinality_violation": (
        _ids([3, 3], [1.0, 2.0]),
        lambda m, t, s, E: m(t, s, on=_on(E))
        .when_matched_update(set={"value": E.col("source.value")})),
    "insert_all": (
        _source(id=(np.array([8]), None), value=(np.array([80.0]), None),
                status=(np.array(["s"], object), None)),
        lambda m, t, s, E: m(t, s, on=_on(E)).when_not_matched_insert_all()),
    "update_all_and_insert_all": (
        _source(id=(np.array([2, 9]), None),
                value=(np.array([-2.0, -9.0]), None),
                status=(np.array(["u", None], object),
                        np.array([True, False]))),
        lambda m, t, s, E: m(t, s, on=_on(E)).when_matched_update_all()
        .when_not_matched_insert_all()),
    "residual_condition": (
        _ids([1, 2], [100.0, 200.0]),
        lambda m, t, s, E: m(t, s, on=_on(E)
                             & (E.col("source.value") > E.lit(150.0)))
        .when_matched_update(set={"value": E.col("source.value")})),
    "no_equi_key": (
        _ids([1], [7.0]),
        lambda m, t, s, E: m(t, s, on=E.col("target.id") > E.lit(3))
        .when_not_matched_by_source_delete()),
    "case_insensitive_source_columns": (
        _source(ID=(np.array([2, 7]), None)),
        lambda m, t, s, E: m(t, s, on=E.col("target.id") == E.col(
            "source.ID")).when_not_matched_insert_all()),
    "insert_condition": (
        _ids([6, 7, 8], [1.0, -1.0, 2.0]),
        lambda m, t, s, E: m(t, s, on=_on(E))
        .when_not_matched_insert(values={"id": E.col("source.id")},
                                 condition=E.col("source.value") > E.lit(0))
        .when_not_matched_insert(values={"id": E.lit(-1),
                                         "status": E.lit("neg")})),
    "nothing_matches": (
        _ids([99], [1.0]),
        lambda m, t, s, E: m(t, s, on=_on(E))
        .when_matched_update(set={"value": E.lit(0.0)})),
    "duplicate_assignment_differing_case": (
        _ids([3], [300.0]),
        lambda m, t, s, E: m(t, s, on=_on(E)).when_matched_update(
            set={"value": E.lit(1.0), "VALUE": E.lit(2.0)})),
    "unknown_assignment": (
        _ids([3], [300.0]),
        lambda m, t, s, E: m(t, s, on=_on(E)).when_matched_update(
            set={"ghost": E.lit(1.0)})),
    "extra_source_column_without_evolution": (
        _ids([3], [300.0], ["x"]),
        lambda m, t, s, E: m(t, s, on=_on(E)).when_not_matched_insert_all()),
    "missing_when": (
        _ids([3], [300.0]), lambda m, t, s, E: m(t, s, on=_on(E))),
    "non_last_matched_omits_condition": (
        _ids([3], [300.0]),
        lambda m, t, s, E: m(t, s, on=_on(E)).when_matched_delete()
        .when_matched_update_all()),
    "non_last_not_matched_omits_condition": (
        _ids([3], [300.0]),
        lambda m, t, s, E: m(t, s, on=_on(E)).when_not_matched_insert_all()
        .when_not_matched_insert(values={"id": E.col("source.id")})),
    "non_last_nmbs_omits_condition": (
        _ids([3], [300.0]),
        lambda m, t, s, E: m(t, s, on=_on(E))
        .when_not_matched_by_source_delete()
        .when_not_matched_by_source_update(set={"id": E.col("target.id")})),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_merge_matches_reference(tmp_path, monkeypatch, case, device):
    """Each case on the host route and, with the threshold at 0 in both
    packages, the device route."""
    if device:
        monkeypatch.setattr(ref_merge, "DEVICE_JOIN_MIN_ROWS", 0)
        monkeypatch.setattr(port_merge, "DEVICE_JOIN_MIN_ROWS", 0)
    ref, port = _copies(tmp_path, [_target()])
    src, build = CASES[case]
    obs.reset()
    _run_both(ref, port, src, build)
    joins = obs.counters().get("join.device_joins", 0)
    # the device route: every pure equi-join with rows on both sides
    # (the source's bounds prune every file in three cases: no join)
    pure = case not in ("residual_condition", "no_equi_key", "insert_all",
                        "insert_condition", "nothing_matches",
                        "missing_when", "duplicate_assignment_differing_case",
                        "unknown_assignment",
                        "extra_source_column_without_evolution",
                        "non_last_matched_omits_condition",
                        "non_last_not_matched_omits_condition",
                        "non_last_nmbs_omits_condition")
    assert joins == (1 if device and pure else 0)
    assert obs.counters().get("kernel.merge_join.launches", 0) == 0


def test_prunes_target_files_by_source_bounds(tmp_path):
    ref, port = _copies(tmp_path, [pa.table({
        "id": pa.array(np.arange(100), pa.int64()),
        "v": pa.array(np.zeros(100))})], target_rows_per_file=10)
    src = _source(id=(np.array([5]), None), v=(np.array([9.0]), None))
    m = _run_both(ref, port, src, lambda m, t, s, E: m(t, s, on=_on(E))
                  .when_matched_update_all())
    assert m.num_target_files_scanned == 1 and m.num_target_rows_updated == 1
    m = _run_both(ref, port, src, lambda m, t, s, E: m(t, s, on=_on(E))
                  .when_matched_update_all()
                  .when_not_matched_by_source_update(
                      set={"v": E.lit(-1.0)},
                      condition=E.col("target.id") >= E.lit(95)))
    assert m.num_target_files_scanned == 10


@pytest.mark.parametrize("nmbs", [False, True])
def test_null_keys_never_match(tmp_path, nmbs):
    ref, port = _copies(tmp_path, [
        pa.table({"id": pa.array([None, None], pa.int64()),
                  "v": pa.array([1.0, 2.0])}),
        pa.table({"id": pa.array([5], pa.int64()), "v": pa.array([3.0])})])
    src = _source(id=(np.array([0, 5]), np.array([False, True])),
                  v=(np.array([9.0, 9.0]), None))

    def build(m, t, s, E):
        b = m(t, s, on=_on(E)).when_matched_update_all()
        if nmbs:  # no pruning, no row changed
            b = b.when_not_matched_by_source_update(
                set={"v": E.lit(99.0)},
                condition=E.col("target.v") > E.lit(1e9))
        return b

    assert _run_both(ref, port, src, build).num_target_rows_updated == 1


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_nan_keys_match_null_keys_dont(tmp_path, monkeypatch, device):
    if device:
        monkeypatch.setattr(ref_merge, "DEVICE_JOIN_MIN_ROWS", 0)
        monkeypatch.setattr(port_merge, "DEVICE_JOIN_MIN_ROWS", 0)
    ref, port = _copies(tmp_path, [pa.table({
        "k": pa.array([float("nan"), None, 1.0], pa.float64()),
        "v": pa.array([10.0, 20.0, 30.0])})])
    src = _source(k=(np.array([np.nan, 0.0]), np.array([True, False])),
                  v=(np.array([99.0, 88.0]), None))
    m = _run_both(ref, port, src, lambda m, t, s, E: m(
        t, s, on=_on(E, "k")).when_matched_update_all()
        .when_not_matched_insert_all())
    assert m.num_target_rows_updated == 1 and m.num_target_rows_inserted == 1


# ---------------------------------------- tests/test_device_join.py's cases


def _forced(monkeypatch):
    monkeypatch.setattr(ref_merge, "DEVICE_JOIN_MIN_ROWS", 0)
    monkeypatch.setattr(port_merge, "DEVICE_JOIN_MIN_ROWS", 0)


def test_device_route_equals_host_route(tmp_path, monkeypatch):
    tables = [pa.table({"id": pa.array(np.arange(i * 25, i * 25 + 25),
                                       pa.int64()),
                        "v": pa.array(np.arange(25, dtype=np.float64))})
              for i in range(4)]
    src = _source(id=(np.arange(50, 150), None), v=(np.full(100, 999.0),
                                                     None))

    def build(m, t, s, E):
        return m(t, s, on=_on(E)).when_matched_update_all() \
            .when_not_matched_insert_all()

    ref, port = _copies(tmp_path / "host", tables)
    host = _run_both(ref, port, src, build)
    host_rows = _rows(port, "port")
    _forced(monkeypatch)
    ref, port = _copies(tmp_path / "device", tables)
    obs.reset()
    dev = _run_both(ref, port, src, build)
    assert obs.counters()["join.device_joins"] == 1
    assert set(dev.phase_seconds) >= {"join_encode", "join_h2d",
                                      "join_sort", "join_tail", "join_d2h"}
    assert "join_host" in host.phase_seconds
    assert _rows(port, "port") == host_rows
    assert (host.num_target_rows_updated, host.num_target_rows_inserted) == \
        (dev.num_target_rows_updated, dev.num_target_rows_inserted) == (50, 50)


def test_device_route_cardinality_error(tmp_path, monkeypatch):
    _forced(monkeypatch)
    ref, port = _copies(tmp_path, [_target(10)])
    err = _run_both(ref, port, _ids([3, 3], [1.0, 2.0]),
                    lambda m, t, s, E: m(t, s, on=_on(E))
                    .when_matched_update_all())
    assert err == ("MergeCardinalityError",
                   "DELTA_MULTIPLE_SOURCE_ROW_MATCHING_TARGET_ROW_IN_MERGE")


def test_device_route_insert_only_duplicate_sources(tmp_path, monkeypatch):
    """Duplicate keys are legal in an insert-only MERGE: matched duplicates
    are all kept out, unmatched ones all insert."""
    _forced(monkeypatch)
    ref, port = _copies(tmp_path, [_target(5)])
    m = _run_both(ref, port, _ids([3, 3, 9, 9], [1.0, 2.0, 3.0, 4.0]),
                  lambda m, t, s, E: m(t, s, on=_on(E))
                  .when_not_matched_insert_all())
    assert m.num_target_rows_inserted == 2


def test_device_route_multi_key_strings(tmp_path, monkeypatch):
    _forced(monkeypatch)
    rng = np.random.default_rng(5)
    n = 400
    ref, port = _copies(tmp_path, [pa.table({
        "a": pa.array([f"k{int(x)}" for x in rng.integers(0, 30, n)]),
        "b": pa.array(rng.integers(0, 20, n), pa.int64()),
        "v": pa.array(np.arange(n, dtype=np.float64))})])
    m = 120
    src = _source(a=(np.array([f"k{int(x)}" for x in
                               rng.integers(0, 40, m)], object), None),
                  b=(rng.integers(0, 25, m), None),
                  v=(rng.normal(size=m), None))
    obs.reset()
    got = _run_both(ref, port, src, lambda mm, t, s, E: mm(
        t, s, on=_on(E, "a") & _on(E, "b"))
        .when_not_matched_insert_all())
    assert obs.counters()["join.device_joins"] == 1
    assert 0 < got.num_target_rows_inserted < m


# -------------------------------------------- partitions, deletion vectors


def _months(lo, n, rng):
    ids = np.arange(lo, lo + n)
    return pa.table({
        "id": pa.array(ids, pa.int64()),
        "v": pa.array(rng.normal(size=n)),
        "month": pa.array([f"{m:02d}" for m in ids * 12 // 1200 + 1])})


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_partitioned_upsert_and_delete(tmp_path, monkeypatch, device):
    """Cell 11's commands at a small size: an upsert on (id, month) whose
    source bounds and partitions prune the candidates to months 11-12,
    then a delete-merge into month 01."""
    if device:
        _forced(monkeypatch)
    rng = np.random.default_rng(11)
    ref, port = _copies(tmp_path, [_months(i * 100, 100, rng)
                                   for i in range(12)],
                        partition_by=["month"])
    old = rng.choice(np.arange(1000, 1200), 60, replace=False)
    new = np.arange(1200, 1260)
    ids = np.concatenate([old, new])
    month = np.array([f"{m:02d}" for m in np.minimum(ids * 12 // 1200 + 1,
                                                       12)], object)
    src = _source(id=(ids, None), v=(rng.normal(size=120), None),
                  month=(month, None))

    def on(E):
        return _on(E) & _on(E, "month")

    obs.reset()
    m = _run_both(ref, port, src, lambda mm, t, s, E: mm(t, s, on=on(E))
                  .when_matched_update(set={"v": E.col("source.v")})
                  .when_not_matched_insert_all())
    assert m.num_target_rows_updated == 60 and \
        m.num_target_rows_inserted == 60
    # months 11 and 12 only: the bound on month prunes the partitions
    assert m.num_target_files_scanned == 2
    assert obs.counters().get("join.device_joins", 0) == (1 if device else 0)
    dsrc = _source(id=(np.arange(0, 100, 4), None),
                   v=(rng.normal(size=25), None),
                   month=(np.array(["01"] * 25, object), None))
    m = _run_both(ref, port, dsrc, lambda mm, t, s, E: mm(t, s, on=on(E))
                  .when_matched_delete(condition=E.col("source.v") < E.lit(0)))
    assert 0 < m.num_target_rows_deleted < 25
    assert m.num_target_files_scanned == 1
    for p, _ in (("month=12/", None), ("month=01/", None)):
        assert any(a.path.startswith(p) for a in Table.for_path(
            port, engine=CPU).latest_snapshot().state.add_files)


def test_deletion_vector_rows_neither_match_nor_return(tmp_path):
    import delta_tpu.commands.dml as ref_dml
    import delta_tpu_torch.commands.dml as port_dml

    ref, port = _copies(tmp_path, [_target(40)], properties={
        "delta.enableDeletionVectors": "true"})
    ref_dml.delete(RefTable.for_path(ref, engine=HostEngine()),
                   RE.col("id") < RE.lit(10))
    port_dml.delete(Table.for_path(port, engine=CPU),
                    PE.col("id") < PE.lit(10))
    m = _run_both(ref, port, _ids([3, 12, 50], [0.0, 1.0, 2.0]),
                  lambda mm, t, s, E: mm(t, s, on=_on(E))
                  .when_matched_update_all().when_not_matched_insert_all())
    # id 3 was deleted: it inserts again instead of matching; ids 10-40
    # are visible, 12 updated, the other 30 copied
    assert (m.num_target_rows_updated, m.num_target_rows_inserted,
            m.num_target_rows_copied) == (1, 2, 30)


# ------------------------------------------------------------ refusals


def _upsert_all(t, on=None):
    return port_merge.merge(t, {"id": np.array([2, 9]),
                                "extra": np.array(["e", "f"])},
                            on=_on(PE)).when_matched_update_all() \
        .when_not_matched_insert_all()


def test_schema_evolution_is_refused(tmp_path):
    """A MERGE that would evolve the schema is refused without
    `with_schema_evolution()`, by the reference's error; with it (ported
    since: `tests/test_torch_type_widening.py` holds the full cases) it
    runs as the reference's: an `*` clause adds every source-only column,
    an explicit assignment the one it names."""
    ref, port = _copies(tmp_path, [pa.table({
        "id": pa.array([1, 2], pa.int64())})])
    src = _source(id=(np.array([2, 9]), None),
                  extra=(np.array(["e", "f"], object), None))
    upsert_all = (lambda m, t, s, E: m(t, s, on=_on(E))
                  .when_matched_update_all().when_not_matched_insert_all())
    assert _run_both(ref, port, src, upsert_all) == (
        "InvalidArgumentError", "DELTA_MERGE_UNRESOLVED_EXPRESSION")
    m = _run_both(ref, port, src, lambda *a: upsert_all(
        *a).with_schema_evolution())
    assert (m.num_target_rows_updated, m.num_target_rows_inserted) == (1, 1)
    src2 = _source(id=(np.array([3]), None), more=(np.array([1.5]), None))
    _run_both(ref, port, src2, lambda m, t, s, E: m(t, s, on=_on(E))
              .with_schema_evolution().when_not_matched_insert(
                  values={"id": E.col("source.id"),
                          "more": E.col("source.more")}))
    assert Table.for_path(port, engine=CPU).latest_snapshot() \
        .schema.field_names() == ["id", "extra", "more"]
    # asked for, but nothing to evolve: runs as without it
    m = port_merge.merge(Table.for_path(port, engine=CPU),
                         {"id": np.array([2, 4])}, on=_on(PE)) \
        .with_schema_evolution().when_not_matched_insert_all().execute()
    assert m.num_target_rows_inserted == 1


def _with_field_metadata(path, name, metadata):
    """Commit a metaData action whose schema gives column `name` the
    metadata (the protocol left alone, so that only MERGE refuses)."""
    log = os.path.join(path, "_delta_log")
    with open(os.path.join(log, f"{0:020d}.json")) as f:
        meta = next(json.loads(ln)["metaData"] for ln in f
                    if '"metaData"' in ln)
    schema = json.loads(meta["schemaString"])
    for f in schema["fields"]:
        if f["name"] == name:
            f["metadata"] = metadata
    meta["schemaString"] = json.dumps(schema)
    with open(os.path.join(log, f"{1:020d}.json"), "w") as f:
        f.write(json.dumps({"metaData": meta}) + "\n")


# the reference's MERGE takes an explicit identity value and leaves an
# inserted row's generated column NULL (ROADMAP C24)
_REFERENCE_LEAVES_GENERATED_NULL = True


@pytest.mark.parametrize("kind", ["identity", "generated"])
def test_identity_and_generated_columns_are_refused(tmp_path, kind):
    """A target with an identity column (`id`, hand-written metadata,
    protocol (1, 2)) or a generated one (`status` = `value > 15.0`).
    Since they were ported, MERGE refuses only what Delta refuses: an
    explicit identity value from `insert *` without allowExplicitInsert
    (DELTA_IDENTITY_COLUMNS_EXPLICIT_INSERT_NOT_SUPPORTED, nothing
    committed), and it computes an inserted row's generated value. The
    reference inserts the identity value and a NULL status (C24)."""
    ref, port = _copies(tmp_path, [_target(3)])
    for path in (ref, port):
        if kind == "identity":
            _with_field_metadata(path, "id", {"delta.identity.start": 1,
                                              "delta.identity.step": 1})
        else:
            _with_field_metadata(path, "status", {
                "delta.generationExpression": "value > 15.0"})
    tbl = pa.table({"id": pa.array([9], pa.int64()),
                    "value": pa.array([21.0])})
    ref_merge.merge(RefTable.for_path(ref, engine=HostEngine()), tbl,
                    on=_on(RE)).when_not_matched_insert_all().execute()
    before = sorted(os.listdir(os.path.join(port, "_delta_log")))
    run = (lambda: port_merge.merge(
        Table.for_path(port, engine=CPU),
        {"id": np.array([9]), "value": np.array([21.0])}, on=_on(PE))
        .when_not_matched_insert_all().execute())
    new = [r for r in _rows(ref, "port") if r[0] == 9]
    if kind == "identity":
        with pytest.raises(DeltaError) as e:
            run()
        assert e.value.error_class == \
            "DELTA_IDENTITY_COLUMNS_EXPLICIT_INSERT_NOT_SUPPORTED"
        assert sorted(os.listdir(os.path.join(port, "_delta_log"))) == \
            before
        assert _REFERENCE_LEAVES_GENERATED_NULL and new == [(9, None, 21.0)]
        return
    assert run().num_target_rows_inserted == 1
    assert [r for r in _rows(port, "port") if r[0] == 9] == \
        [(9, "true", 21.0)] == [r for r in _rows(port, "ref") if r[0] == 9]
    assert _REFERENCE_LEAVES_GENERATED_NULL and new == [(9, None, 21.0)]


@pytest.mark.parametrize("props,feature", [
    ({"delta.columnMapping.mode": "name"}, "column mapping"),
    ({"delta.enableChangeDataFeed": "true"}, "change data feed")])
def test_column_mapping_and_cdf_tables_are_refused(tmp_path, props, feature):
    """Both were refused until ported: a column-mapped table merges as the
    reference merges it, and so does a table with the change data feed
    on, whose commit carries the change data the reference's does
    (`tests/test_torch_cdf.py` holds the feed in full)."""
    ref, port = _copies(tmp_path, [_target(3)], properties=props)
    src = _source(id=(np.array([2, 7]), None),
                  value=(np.array([1.0, 7.0]), None))
    m = _run_both(ref, port, src, lambda m, t, s, E: m(t, s, on=_on(E))
                  .when_matched_update(set={"value": E.col("source.value")})
                  .when_not_matched_insert(values={
                      "id": E.col("source.id"),
                      "value": E.col("source.value")}))
    if feature == "change data feed":
        assert port_changes_of(port, 1) == ref_changes_of(ref, 1) == {
            (1, "update_preimage"): [(("id", "2"), ("status", "'a'"),
                                      ("value", "20.0"))],
            (1, "update_postimage"): [(("id", "2"), ("status", "'a'"),
                                       ("value", "1.0"))],
            (1, "insert"): [(("id", "7"), ("status", "None"),
                             ("value", "7.0"))]}
        assert m.version == 1


# ------------------------------------------------- C10 and C9: key codes


@pytest.mark.parametrize("target_keys,source_keys", [
    (["1", "2"], np.array([2, 3], np.int64)),
    (["1.5", "2"], np.array([1.5])),
    ([1, 2], np.array(["2", "3"], object)),
], ids=["str-int", "str-float", "int-str"])
def test_string_key_against_numeric_key_is_refused(tmp_path, monkeypatch,
                                                    target_keys, source_keys):
    """C10: a string key never joins a numeric one. The reference's join
    raises; the port refuses with a typed error before it reads or writes
    a file, and no commit is written."""
    ref, port = _copies(tmp_path, [pa.table({
        "k": pa.array(target_keys), "v": pa.array([1.0, 2.0])})])
    src = _source(k=(source_keys, None),
                  v=(np.full(len(source_keys), 9.0), None))

    def build(m, t, s, E):
        return (m(t, s, on=_on(E, "k")).when_matched_update(
            set={"v": E.col("source.v")}).when_not_matched_insert_all())

    with pytest.raises(Exception, match="merge on"):
        build(ref_merge.merge, RefTable.for_path(ref, engine=HostEngine()),
              src[0], RE).execute()
    log = os.path.join(port, "_delta_log")
    before = sorted(os.listdir(log))

    def no_read(*a, **k):
        raise AssertionError("a data file was read")

    monkeypatch.setattr(port_merge, "read_add_files_logical", no_read)
    with pytest.raises(DeltaError) as e:
        build(port_merge.merge, Table.for_path(port, engine=CPU), src[1],
              PE).execute()
    assert e.value.error_class == "DATATYPE_MISMATCH"
    assert sorted(os.listdir(log)) == before


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_trailing_nul_keys_stay_two_keys(tmp_path, monkeypatch, device):
    """C9: "a" and "a\\x00" are two keys on both join routes, as on the
    reference's host route: 1 row updated, 1 inserted."""
    ref, port = _copies(tmp_path, [pa.table({
        "k": pa.array(["a", "b"]), "v": pa.array([1.0, 2.0])})])
    src = _source(k=(np.array(["a\x00", "b"], object), None),
                  v=(np.array([10.0, 20.0]), None))

    def build(m, t, s, E):
        return (m(t, s, on=_on(E, "k")).when_matched_update(
            set={"v": E.col("source.v")}).when_not_matched_insert_all())

    if device:  # the port's device route against the reference's host one
        monkeypatch.setattr(port_merge, "DEVICE_JOIN_MIN_ROWS", 0)
    obs.reset()
    m = _run_both(ref, port, src, build)
    assert obs.counters().get("join.device_joins", 0) == int(device)
    assert (m.num_target_rows_updated, m.num_target_rows_inserted) == (1, 1)
    assert sorted(_rows(port, "port")) == [
        ("a", 1.0), ("a\x00", 10.0), ("b", 20.0)]

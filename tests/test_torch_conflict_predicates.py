"""Predicate reads in the write path: the conflict check and OPTIMIZE WHERE.

- `txn/conflict.py::_matching_adds` against the reference's on the same
  winners' adds (stats of every type, partition values, a file without
  stats) and read predicates: 40 seeded random predicates over typed
  columns and a partition column, a whole-table read, no read, a
  predicate that cannot be evaluated (widened to "may match");
- a transaction that read with `scan_files(filter=)` at Serializable
  isolation loses the race to an append: it raises
  `ConcurrentAppendError` exactly when the reference's `_matching_adds`
  says the winner's adds may match, and otherwise commits at N + 2;
- `optimize().where(...)` against the reference's on copies of one
  table: the same files removed, the same `predicate` operation
  parameter; a predicate on a clustered table raises
  DELTA_CLUSTERING_WITH_PARTITION_PREDICATE in both.
"""

import json
import os
import shutil

import numpy as np
import pytest

import delta_tpu.api as dta
import delta_tpu.expressions.tree as RE
from delta_tpu.engine.host import HostEngine
from delta_tpu.models.actions import AddFile as RefAddFile
from delta_tpu.table import Table as RefTable
from delta_tpu.txn import conflict as ref_conflict
from delta_tpu.txn.isolation import IsolationLevel as RefIsolation
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.errors import ConcurrentAppendError, OptimizeArgumentError
from delta_tpu_torch.models.actions import AddFile
from delta_tpu_torch.models.batch import Batch, as_column
from delta_tpu_torch.models.schema import schema_from_json
from delta_tpu_torch.txn import conflict as port_conflict
from delta_tpu_torch.txn.isolation import IsolationLevel
from delta_tpu_torch.write.writer import write_data_files
from torch_scan_helpers import (
    TYPES,
    build,
    random_spec,
    write_typed_table,
)


def _winner_adds(tmp_path):
    """The adds of a reference-written partitioned table (typed stats),
    plus one without stats and one with unparsable stats."""
    path = str(tmp_path / "w")
    write_typed_table(path, seed=41, appends=6, partition_by=["p"])
    snap = RefTable.for_path(path, HostEngine()).latest_snapshot()
    rows = snap.state.add_files_table.to_pylist()
    out = [(r["path"], dict(r["partition_values"] or []), r["stats"])
           for r in rows]
    out.append(("nostats.parquet", {"p": "p1"}, None))
    out.append(("bad.parquet", {"p": None}, '{"numRecords": 3, "min'))
    return out


def _both_adds(raw):
    ref = [RefAddFile(path=p, partitionValues=pv, stats=s) for p, pv, s in raw]
    port = [AddFile(path=p, partitionValues=pv, stats=s) for p, pv, s in raw]
    return ref, port


def _states(specs, whole=False):
    ref = ref_conflict.TransactionReadState(
        read_predicates=[build(s, RE) for s in specs],
        read_whole_table=whole, partition_columns=["p"])
    port = port_conflict.TransactionReadState(
        read_predicates=[build(s, PE) for s in specs],
        read_whole_table=whole, partition_columns=["p"])
    return ref, port


def test_matching_adds_matches_reference(tmp_path):
    ref_adds, port_adds = _both_adds(_winner_adds(tmp_path))
    rng = np.random.default_rng(43)
    columns = list(TYPES) + ["p"]
    n_excluded = 0
    for i in range(40):
        specs = [random_spec(rng, columns)
                 for _ in range(1 + int(rng.integers(0, 2)))]
        ref_state, port_state = _states(specs)
        want = ref_conflict._matching_adds(ref_adds, ref_state)
        got = port_conflict._matching_adds(port_adds, port_state)
        np.testing.assert_array_equal(got, want, err_msg=f"{i}: {specs}")
        n_excluded += int((~got).sum())
    assert n_excluded > 0
    for specs, whole in (([], True), ([], False),
                         ([("cmp", "<", "nope.x", 1, False)], False),
                         ([("starts", "p", "p1")], False)):
        ref_state, port_state = _states(specs, whole)
        np.testing.assert_array_equal(
            port_conflict._matching_adds(port_adds, port_state),
            ref_conflict._matching_adds(ref_adds, ref_state))


def _append(path, rows):
    """A blind append by another writer (the reference's)."""
    import pyarrow as pa

    dta.write_table(path, pa.table({"long": pa.array(rows, pa.int64())}),
                    engine=HostEngine())


@pytest.mark.parametrize("lo,hi", [(5000, 5010), (100, 120)])
def test_concurrent_append_decision_matches_reference(tmp_path, lo, hi):
    import pyarrow as pa

    path = str(tmp_path / "t")
    for i in range(3):
        dta.write_table(path, pa.table({"long": pa.array(
            np.arange(i * 1000, i * 1000 + 50), pa.int64())}),
            engine=HostEngine())
    table = Table.for_path(path, engine=TorchEngine("cpu"))
    txn = table.create_transaction_builder().build()
    txn.isolation = IsolationLevel.SERIALIZABLE
    pred = ("cmp", ">=", "long", 1500, False)
    seen = txn.scan_files(filter=build(pred, PE))
    assert sorted(f.path for f in seen) == sorted(
        RefTable.for_path(path, HostEngine()).latest_snapshot()
        .scan(filter=build(pred, RE)).file_paths())
    meta = txn.metadata()
    txn.add_files(write_data_files(
        table.engine, table.path, Batch({"long": as_column(np.arange(3))}),
        schema_from_json(meta.schemaString), [], meta.configuration))
    _append(path, np.arange(lo, hi))
    log = os.path.join(path, "_delta_log")
    with open(os.path.join(log, f"{3:020d}.json")) as f:
        winner = [RefAddFile(**{k: v for k, v in json.loads(ln)["add"].items()
                                if k in ("path", "partitionValues", "stats")})
                  for ln in f if ln.startswith('{"add"')]
    ref_state = ref_conflict.TransactionReadState(
        read_predicates=[build(pred, RE)], isolation=RefIsolation.SERIALIZABLE)
    conflicts = bool(ref_conflict._matching_adds(winner, ref_state).any())
    assert conflicts == (lo >= 1500)
    if conflicts:
        with pytest.raises(ConcurrentAppendError):
            txn.commit()
    else:
        assert txn.commit().version == 4


def _opt_copies(tmp_path):
    src = str(tmp_path / "src")
    write_typed_table(src, seed=45, appends=5, rows=30)
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref_path)
    shutil.copytree(src, port_path)
    return ref_path, port_path


def _last_commit(path):
    log = os.path.join(path, "_delta_log")
    v = max(int(n[:20]) for n in os.listdir(log) if n.endswith(".json"))
    with open(os.path.join(log, f"{v:020d}.json")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@pytest.mark.parametrize("spec", [
    ("cmp", ">=", "long", 400, False),
    ("and", ("cmp", "<", "long", 700, False), ("notnull", "string")),
    ("cmp", "<", "string", "s00500", False),
])
def test_optimize_where_matches_reference(tmp_path, spec):
    ref_path, port_path = _opt_copies(tmp_path)
    rm = RefTable.for_path(ref_path, HostEngine()).optimize() \
        .where(build(spec, RE)).execute_compaction()
    pm = Table.for_path(port_path, engine=TorchEngine("cpu")).optimize() \
        .where(build(spec, PE)).execute_compaction()
    assert (pm.num_files_removed, pm.num_files_added, pm.version) \
        == (rm.num_files_removed, rm.num_files_added, rm.version)
    assert pm.num_files_removed >= 2
    rc, pc = _last_commit(ref_path), _last_commit(port_path)
    rci = next(a["commitInfo"] for a in rc if "commitInfo" in a)
    pci = next(a["commitInfo"] for a in pc if "commitInfo" in a)
    assert pci["operationParameters"] == rci["operationParameters"]
    assert pci["operationParameters"]["predicate"] == repr(build(spec, RE))
    removed = lambda c: sorted(a["remove"]["path"] for a in c  # noqa: E731
                               if "remove" in a)
    assert removed(pc) == removed(rc)


def test_optimize_where_on_a_clustered_table(tmp_path):
    from delta_tpu.clustering import set_clustering_columns
    from delta_tpu.errors import OptimizeArgumentError as RefOptError

    ref_path, port_path = _opt_copies(tmp_path)
    for p in (ref_path, port_path):
        set_clustering_columns(RefTable.for_path(p, engine=HostEngine()),
                               ["long"])
    with pytest.raises(RefOptError) as r:
        RefTable.for_path(ref_path, HostEngine()).optimize() \
            .where(RE.col("long") > 3).execute_compaction()
    with pytest.raises(OptimizeArgumentError) as e:
        Table.for_path(port_path, engine=TorchEngine("cpu")).optimize() \
            .where(PE.col("long") > 3).execute_compaction()
    assert e.value.error_class == r.value.error_class \
        == "DELTA_CLUSTERING_WITH_PARTITION_PREDICATE"

"""An int64 value past ±2^53 beside a float: the port against the reference.

Arrow compares an int64 with a float64 by casting the integer side to
float64 with a safe cast, which refuses any valid value past ±2^53. So the
reference keeps every file in data skipping, raises in `read_table` and in
partition pruning, and counts every winner's add as "may match" in the
conflict check. Each case holds the port to the reference on the same
reference-written table: the scan's files, `read_table` (the same rows, or
an error of the same kind), and `_matching_adds`; and a transaction that
read with `k < 1.5` loses to a concurrent append in both.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.api as dta
import delta_tpu.expressions.tree as RE
from delta_tpu.engine.host import HostEngine
from delta_tpu.models.actions import AddFile as RefAddFile
from delta_tpu.table import Table as RefTable
from delta_tpu.txn import conflict as ref_conflict
import delta_tpu_torch.api as pta
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.errors import ConcurrentAppendError
from delta_tpu_torch.models.actions import AddFile
from delta_tpu_torch.models.batch import Batch, as_column
from delta_tpu_torch.models.schema import schema_from_json
from delta_tpu_torch.txn import conflict as port_conflict
from delta_tpu_torch.txn.isolation import IsolationLevel
from delta_tpu_torch.write.writer import write_data_files
from torch_scan_helpers import build

BIG = 2 ** 53 + 1

CASES = [
    ("cmp", "<", "k", 1.5, False),
    ("cmp", ">", "k", 9007199254740992.0, False),
    ("in", "k", (1.0, 2.0)),
    ("cmp", ">", "f", BIG, False),
    ("in", "f", (BIG, 1)),
    ("cmp", "<", "k", 5, False),  # int beside int: no cast, both skip
]
PART_CASES = [
    ("cmp", ">", "p", 1.5, False),
    ("cmp", "=", "p", 1.0, False),
]


def _two_files(path):
    dta.write_table(path, pa.table({
        "k": pa.array([1, 2], pa.int64()),
        "f": pa.array([1.0, 2.0], pa.float64())}), engine=HostEngine())
    dta.write_table(path, pa.table({
        "k": pa.array([BIG, BIG + 2], pa.int64()),
        "f": pa.array([3.0, 4.0], pa.float64())}), engine=HostEngine())


def _partitioned(path):
    for p in (1, BIG):
        dta.write_table(path, pa.table({
            "p": pa.array([p, p], pa.int64()),
            "x": pa.array([1, 2], pa.int64())}), engine=HostEngine(),
            partition_by=["p"])


def _outcome(fn):
    """("ok", value) or ("error", exception)."""
    try:
        return "ok", fn()
    except Exception as e:  # the kind is compared below
        return "error", e


def _files_ref(path, spec):
    return sorted(RefTable.for_path(path, HostEngine()).latest_snapshot()
                  .scan(filter=build(spec, RE)).file_paths())


def _files_port(path, spec):
    return sorted(Table.for_path(path, engine=TorchEngine("cpu"))
                  .latest_snapshot().scan(filter=build(spec, PE))
                  .file_paths())


def _rows_ref(path, spec):
    t = dta.read_table(path, filter=build(spec, RE), engine=HostEngine())
    return sorted(t.column("k" if "k" in t.column_names else "x")
                  .to_pylist())


def _rows_port(path, spec):
    b = pta.read_table(path, filter=build(spec, PE),
                       engine=TorchEngine("cpu"))
    name = "k" if "k" in b.column_names else "x"
    return sorted(b.column(name).values.tolist())


def _same(ref, port):
    assert ref[0] == port[0], (ref, port)
    if ref[0] == "ok":
        assert port[1] == ref[1]
    else:
        # Arrow's ArrowInvalid is a ValueError; the port refuses with a
        # TypeError (UnsupportedComparison) or a DeltaError around one
        assert isinstance(port[1], Exception)


@pytest.mark.parametrize("spec", CASES)
def test_scan_and_read_match_reference(tmp_path, spec):
    path = str(tmp_path / "t")
    _two_files(path)
    ref_files = _outcome(lambda: _files_ref(path, spec))
    port_files = _outcome(lambda: _files_port(path, spec))
    _same(ref_files, port_files)
    _same(_outcome(lambda: _rows_ref(path, spec)),
          _outcome(lambda: _rows_port(path, spec)))


@pytest.mark.parametrize("spec", PART_CASES)
def test_partition_pruning_matches_reference(tmp_path, spec):
    path = str(tmp_path / "t")
    _partitioned(path)
    _same(_outcome(lambda: _files_ref(path, spec)),
          _outcome(lambda: _files_port(path, spec)))
    _same(_outcome(lambda: _rows_ref(path, spec)),
          _outcome(lambda: _rows_port(path, spec)))


def _winner_adds(path):
    snap = RefTable.for_path(path, HostEngine()).latest_snapshot()
    rows = snap.state.add_files_table.to_pylist()
    raw = [(r["path"], dict(r["partition_values"] or []), r["stats"])
           for r in rows]
    return ([RefAddFile(path=p, partitionValues=pv, stats=s)
             for p, pv, s in raw],
            [AddFile(path=p, partitionValues=pv, stats=s) for p, pv, s in raw])


@pytest.mark.parametrize("spec,part", [(s, False) for s in CASES]
                         + [(s, True) for s in PART_CASES])
def test_matching_adds_match_reference(tmp_path, spec, part):
    path = str(tmp_path / "t")
    (_partitioned if part else _two_files)(path)
    ref_adds, port_adds = _winner_adds(path)
    cols = ["p"] if part else []
    want = ref_conflict._matching_adds(ref_adds, ref_conflict.TransactionReadState(
        read_predicates=[build(spec, RE)], partition_columns=cols))
    got = port_conflict._matching_adds(port_adds, port_conflict.TransactionReadState(
        read_predicates=[build(spec, PE)], partition_columns=cols))
    np.testing.assert_array_equal(got, want)


def test_concurrent_append_past_2_53_conflicts(tmp_path):
    """A transaction that read with `k < 1.5` loses to an append of rows
    past 2^53: the reference counts the winner's add as matching, so the
    port must raise ConcurrentAppendError."""
    path = str(tmp_path / "t")
    dta.write_table(path, pa.table({"k": pa.array([1, 2], pa.int64())}),
                    engine=HostEngine())
    table = Table.for_path(path, engine=TorchEngine("cpu"))
    txn = table.create_transaction_builder().build()
    txn.isolation = IsolationLevel.SERIALIZABLE
    pred = ("cmp", "<", "k", 1.5, False)
    txn.scan_files(filter=build(pred, PE))
    meta = txn.metadata()
    txn.add_files(write_data_files(
        table.engine, table.path, Batch({"k": as_column(np.arange(3))}),
        schema_from_json(meta.schemaString), [], meta.configuration))
    dta.write_table(path, pa.table({"k": pa.array([BIG, BIG + 2],
                                                  pa.int64())}),
                    engine=HostEngine())
    with open(os.path.join(path, "_delta_log", f"{1:020d}.json")) as f:
        winner = [RefAddFile(**{k: v for k, v in json.loads(ln)["add"].items()
                                if k in ("path", "partitionValues", "stats")})
                  for ln in f if ln.startswith('{"add"')]
    assert ref_conflict._matching_adds(winner, ref_conflict.TransactionReadState(
        read_predicates=[build(pred, RE)])).all()
    with pytest.raises(ConcurrentAppendError):
        txn.commit()

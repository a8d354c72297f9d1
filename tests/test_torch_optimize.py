"""OPTIMIZE end to end: the port against the JAX package on the same table.

The reference (`delta_tpu.api.write_table`, `HostEngine`) writes a table
of 4-8 appends, which is copied; the reference's OPTIMIZE runs on one copy
and the port's (`TorchEngine("cpu")`: every kernel's plain version) on
the other. Compared, ignoring paths, uuids, timestamps, `txnId`,
`engineInfo` and the sizes of the files each writer writes:

- the commit's actions, field by field, each add's stats byte for byte;
- the rows of the new files in add order, read with pyarrow;
- `OptimizeMetrics`;
- the snapshot `HostEngine` loads afterwards.

Then the validation errors, a concurrent append (both rebase and commit
at N + 2), a concurrent remove of a bin file (both raise the delete-read
conflict), and the port's typed refusals. The reference's
`zorder_sort_indices` needs the test-local `_x32` patch (ROADMAP C0).
"""

import json
import os
import shutil
import time

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.optimize as ref_opt
import delta_tpu.ops.pallas_kernels as ref_pk
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefDeltaError
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.commands import optimize as port_opt
from delta_tpu_torch.errors import (
    ConcurrentDeleteReadError,
    DeltaError,
    InvalidArgumentError,
    UnsupportedTableError,
)


@pytest.fixture(autouse=True)
def ref_x32(monkeypatch):
    monkeypatch.setattr(ref_pk, "_x32", lambda: jax.enable_x64(False))


def _batch(rng, n, with_nulls=True):
    k2 = rng.integers(0, 1 << 20, n)
    d = rng.normal(size=n)
    d[::13] = 0.0
    d[6::13] = -0.0
    d[::29] = np.nan
    s = [f"key-{int(x):04d}" + ("x" * 40 if x % 17 == 0 else "")
         for x in rng.integers(0, 3000, n)]
    mask = rng.random(n) < 0.1 if with_nulls else np.zeros(n, bool)
    return pa.table({
        "k1": pa.array(rng.integers(0, 1 << 30, n), pa.int64()),
        "k2": pa.array(k2, pa.int64(), mask=mask),
        "k3": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "d": pa.array(d),
        "f": pa.array(rng.normal(size=n).astype(np.float32)),
        "s": pa.array(s, pa.string(), mask=np.roll(mask, 3)),
        "b": pa.array(rng.random(n) > 0.5),
        "dt": pa.array((np.datetime64("2020-01-01")
                        + rng.integers(0, 2000, n).astype("timedelta64[D]"))
                       .astype("datetime64[D]"), pa.date32()),
        "ts": pa.array(rng.integers(0, 10**15, n), pa.timestamp("us", "UTC")),
    })


def _make_table(tmp_path, n_appends=5, seed=0, properties=None,
                partition_by=None):
    rng = np.random.default_rng(seed)
    src = str(tmp_path / "src")
    for i in range(n_appends):
        dta.write_table(src, _batch(rng, 300 + 97 * i), engine=HostEngine(),
                        properties=properties if i == 0 else None,
                        partition_by=partition_by)
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref_path)
    shutil.copytree(src, port_path)
    return ref_path, port_path


def _commit(path, version):
    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _split(actions):
    out = {"commitInfo": [], "add": [], "remove": [], "other": []}
    for a in actions:
        (key, body), = a.items()
        out[key if key in out else "other"].append(body)
    return out


_BYTE_METRICS = ("numOutputBytes", "numAddedBytes")


def _assert_same_commit(ref_actions, port_actions, zorder):
    ref, port = _split(ref_actions), _split(port_actions)
    assert ref["other"] == port["other"] == []
    (rci,), (pci,) = ref["commitInfo"], port["commitInfo"]
    assert set(rci) == set(pci)
    for k in rci:
        if k in ("timestamp", "txnId", "engineInfo", "operationMetrics"):
            continue
        assert rci[k] == pci[k], k
    rm, pm = rci["operationMetrics"], pci["operationMetrics"]
    assert set(rm) == set(pm)
    for k in rm:
        if k in _BYTE_METRICS:
            assert int(pm[k]) > 0
        else:
            assert rm[k] == pm[k], k
    # removes: the same files, field for field, but the timestamp
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k != "deletionTimestamp"}
    assert [strip(r) for r in ref["remove"]] == \
        [strip(r) for r in port["remove"]]
    assert all(r["dataChange"] is False for r in port["remove"])
    # adds: same count, same fields; stats byte for byte; tags but the id
    assert len(ref["add"]) == len(port["add"]) >= 1
    for ra, pa_ in zip(ref["add"], port["add"]):
        assert set(ra) == set(pa_)
        assert pa_["stats"] == ra["stats"]
        # booleans without case: the reference writes numpy's "True"
        assert pa_["dataChange"] is False
        assert {k: v.lower() for k, v in pa_["partitionValues"].items()} == \
            {k: v.lower() for k, v in ra["partitionValues"].items()}
        assert pa_["size"] > 0
        if zorder:
            rt, pt = dict(ra["tags"]), dict(pa_["tags"])
            assert len(rt.pop("ZCUBE_ID")) == len(pt.pop("ZCUBE_ID")) == 32
            assert rt == pt
        else:
            assert "tags" not in pa_
    if zorder:  # one cube per command
        assert len({a["tags"]["ZCUBE_ID"] for a in port["add"]}) == 1


def _rows(path, adds):
    return pa.concat_tables([pq.read_table(os.path.join(path, a["path"]))
                             for a in adds])


def _assert_same_rows(ref_tbl, port_tbl):
    assert sorted(ref_tbl.column_names) == sorted(port_tbl.column_names)
    for name in ref_tbl.column_names:
        r, p = ref_tbl.column(name), port_tbl.column(name)
        assert r.type == p.type, name
        if pa.types.is_floating(r.type):
            rv = r.to_numpy(zero_copy_only=False)
            pv = p.to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(rv, pv)
            # signed zeros survive in place
            np.testing.assert_array_equal(np.signbit(rv), np.signbit(pv))
            assert r.null_count == p.null_count
        else:
            assert r.to_pylist() == p.to_pylist(), name


def _assert_same_host_snapshot(ref_path, port_path):
    ref = RefTable.for_path(ref_path, engine=HostEngine()).latest_snapshot()
    port = RefTable.for_path(port_path, engine=HostEngine()).latest_snapshot()
    assert ref.version == port.version
    ra = ref.state.add_files_table
    pa_ = port.state.add_files_table
    assert ra.num_rows == pa_.num_rows
    assert ra.column("stats").to_pylist() == pa_.column("stats").to_pylist()
    assert sorted(ref.state.tombstones_table.column("path").to_pylist()) == \
        sorted(port.state.tombstones_table.column("path").to_pylist())
    # the data, as the reference reads it back
    _assert_same_rows(dta.read_table(ref_path, engine=HostEngine()),
                      dta.read_table(port_path, engine=HostEngine()))


_METRIC_FIELDS = ("num_files_added", "num_files_removed", "bytes_removed",
                  "num_bins", "num_batches", "partitions_optimized",
                  "version")


def _assert_same_metrics(rm, pm):
    for k in _METRIC_FIELDS:
        assert getattr(rm, k) == getattr(pm, k), k
    assert (pm.bytes_added > 0) == (pm.num_files_added > 0)
    assert set(rm.to_dict()) <= set(pm.to_dict())


def _run_both(ref_path, port_path, fn):
    rm = fn(RefTable.for_path(ref_path, engine=HostEngine()).optimize())
    pm = fn(Table.for_path(port_path, engine=TorchEngine("cpu")).optimize())
    return rm, pm


_CASES = {
    "zorder-ints": (lambda o: o.execute_zorder_by("k1", "k2", "k3"), True),
    "zorder-mixed": (lambda o: o.execute_zorder_by("s", "d", "ts", "b"),
                     True),
    "zorder-split": (lambda o: o.execute_zorder_by(
        "k1", "dt", max_file_size=60_000), True),
    "hilbert-ints": (lambda o: o.execute_zorder_by(
        "k1", "k2", curve="hilbert"), True),
    "hilbert-mixed": (lambda o: o.execute_zorder_by(
        "dt", "f", "k3", curve="hilbert", max_file_size=70_000), True),
    "compaction": (lambda o: o.execute_compaction(
        min_file_size=1 << 30, max_file_size=90_000), False),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_optimize_matches_reference(tmp_path, case):
    fn, zorder = _CASES[case]
    ref_path, port_path = _make_table(tmp_path, n_appends=6,
                                      seed=len(case))
    rm, pm = _run_both(ref_path, port_path, fn)
    _assert_same_metrics(rm, pm)
    assert pm.num_files_removed == 6 if case != "compaction" \
        else pm.num_bins >= 2
    if case.endswith("split") or case == "hilbert-mixed":
        assert pm.num_files_added >= 2
    ref_actions = _commit(ref_path, rm.version)
    port_actions = _commit(port_path, pm.version)
    _assert_same_commit(ref_actions, port_actions, zorder)
    _assert_same_rows(_rows(ref_path, _split(ref_actions)["add"]),
                      _rows(port_path, _split(port_actions)["add"]))
    _assert_same_host_snapshot(ref_path, port_path)
    # and the port loads its own result to the same live files
    st = Table.for_path(port_path, engine=TorchEngine("cpu")) \
        .latest_snapshot().state
    assert st.version == pm.version
    assert sorted(a.path for a in st.add_files) == sorted(
        RefTable.for_path(port_path, engine=HostEngine()).latest_snapshot()
        .state.add_files_table.column("path").to_pylist())
    assert set(pm.phase_seconds) >= {"snapshot", "scan", "read", "write",
                                     "commit"}


def test_optimize_nothing_to_do_commits_nothing(tmp_path):
    ref_path, port_path = _make_table(tmp_path, n_appends=1)
    rm, pm = _run_both(ref_path, port_path,
                       lambda o: o.execute_compaction())
    _assert_same_metrics(rm, pm)
    assert pm.version is None and pm.num_bins == 0


def _error_class(fn):
    with pytest.raises((DeltaError, RefDeltaError)) as e:
        fn()
    return e.value.error_class


@pytest.mark.parametrize("call,error_class", [
    (lambda o: o.execute_zorder_by(), "DELTA_ZORDER_REQUIRES_COLUMN"),
    (lambda o: o.execute_zorder_by("k1", "nope"),
     "DELTA_ZORDERING_COLUMN_DOES_NOT_EXIST"),
    (lambda o: o.execute_zorder_by("k1", "k3"),
     "DELTA_ZORDERING_ON_COLUMN_WITHOUT_STATS"),
])
def test_validation_errors_match_reference(tmp_path, call, error_class):
    ref_path, port_path = _make_table(
        tmp_path, n_appends=2,
        properties={"delta.dataSkippingNumIndexedCols": "2"})
    port = Table.for_path(port_path, engine=TorchEngine("cpu")).optimize()
    ref = RefTable.for_path(ref_path, engine=HostEngine()).optimize()
    assert _error_class(lambda: call(port)) == error_class
    assert _error_class(lambda: call(ref)) == error_class


def test_missing_table_error_matches_reference(tmp_path):
    port = Table.for_path(str(tmp_path / "none"),
                          engine=TorchEngine("cpu")).optimize()
    ref = RefTable.for_path(str(tmp_path / "none2"),
                            engine=HostEngine()).optimize()
    assert _error_class(lambda: port.execute_zorder_by("a")) == \
        _error_class(lambda: ref.execute_zorder_by("a")) == \
        "DELTA_METADATA_ABSENT"


def _inject_before_write(monkeypatch, module, action):
    """Run `action` once, just before the command writes its first file:
    after its snapshot was read, before its commit."""
    real = module.write_data_files
    done = []

    def wrapped(*args, **kwargs):
        if not done:
            done.append(True)
            action()
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "write_data_files", wrapped)


def test_concurrent_append_rebases_like_reference(tmp_path, monkeypatch):
    ref_path, port_path = _make_table(tmp_path, n_appends=4)
    extra = _batch(np.random.default_rng(99), 50)
    for module, path in ((ref_opt, ref_path), (port_opt, port_path)):
        _inject_before_write(monkeypatch, module, lambda p=path: (
            dta.write_table(p, extra, engine=HostEngine())))
    rm, pm = _run_both(ref_path, port_path,
                       lambda o: o.execute_zorder_by("k1", "k2"))
    assert rm.version == pm.version == 5  # 4 appends, the append, then us
    _assert_same_metrics(rm, pm)
    port_actions = _commit(port_path, 5)
    _assert_same_commit(_commit(ref_path, 5), port_actions, True)
    assert _split(port_actions)["commitInfo"][0]["readVersion"] == 3
    st = Table.for_path(port_path, engine=TorchEngine("cpu")) \
        .latest_snapshot().state
    assert st.num_files == 1 + pm.num_files_added  # the append survives
    _assert_same_host_snapshot(ref_path, port_path)


def test_concurrent_remove_conflicts_like_reference(tmp_path, monkeypatch):
    ref_path, port_path = _make_table(tmp_path, n_appends=3)

    def remove_one(path):
        t = RefTable.for_path(path, engine=HostEngine())
        txn = t.create_transaction_builder("DELETE").build()
        f = txn.scan_files()[0]
        txn.remove_file(f.remove(deletion_timestamp=int(time.time() * 1000)))
        txn.commit()

    for module, path in ((ref_opt, ref_path), (port_opt, port_path)):
        _inject_before_write(monkeypatch, module,
                             lambda p=path: remove_one(p))
    ref = RefTable.for_path(ref_path, engine=HostEngine()).optimize()
    port = Table.for_path(port_path, engine=TorchEngine("cpu")).optimize()
    ref_class = _error_class(lambda: ref.execute_zorder_by("k1"))
    with pytest.raises(ConcurrentDeleteReadError) as e:
        port.execute_zorder_by("k1")
    assert e.value.error_class == ref_class == "DELTA_CONCURRENT_DELETE_READ"
    # nothing of the port's landed: the log ends at the winner
    assert sorted(os.listdir(os.path.join(port_path, "_delta_log"))) == \
        sorted(n for n in os.listdir(os.path.join(ref_path, "_delta_log")))


def _refusal(tmp_path, **table_kw):
    _, port_path = _make_table(tmp_path, n_appends=2, **table_kw)
    return Table.for_path(port_path, engine=TorchEngine("cpu"))


def _optimize_both_like_reference(ref_path, port_path, fn, zorder):
    """OPTIMIZE `fn` on both copies, equal to the reference's: metrics,
    the commit, the rows, the host snapshot; no add carries a DV."""
    rm, pm = _run_both(ref_path, port_path, fn)
    _assert_same_metrics(rm, pm)
    ref_actions = _commit(ref_path, rm.version)
    port_actions = _commit(port_path, pm.version)
    _assert_same_commit(ref_actions, port_actions, zorder)
    _assert_same_rows(_rows(ref_path, _split(ref_actions)["add"]),
                      _rows(port_path, _split(port_actions)["add"]))
    _assert_same_host_snapshot(ref_path, port_path)
    assert not any("deletionVector" in a
                   for a in _split(port_actions)["add"])
    return pm


@pytest.mark.parametrize("kind", ["partitioned", "deletion vectors",
                                  "column mapping"])
def test_refuses_unsupported_tables(tmp_path, kind):
    """A table with deletion vectors enabled (none written yet), a
    partitioned table (since partitioned tables were ported, one bin per
    partition) and a column-mapped table (since column mapping was ported:
    the files read by their physical names and written under them)
    optimize as in the reference."""
    kw = {"partitioned": dict(partition_by=["b"]),
          "deletion vectors": dict(properties={
              "delta.enableDeletionVectors": "true"}),
          "column mapping": dict(properties={
              "delta.columnMapping.mode": "name"})}[kind]
    pm = _optimize_both_like_reference(
        *_make_table(tmp_path, n_appends=2, **kw),
        lambda o: o.execute_zorder_by("k1"), True)
    assert pm.partitions_optimized == (2 if kind == "partitioned" else 1)


def test_refuses_a_clustered_table(tmp_path):
    from delta_tpu.clustering import set_clustering_columns

    table = _refusal(tmp_path)
    set_clustering_columns(RefTable.for_path(table.path,
                                             engine=HostEngine()), ["k1"])
    with pytest.raises(UnsupportedTableError, match="clustered"):
        table.optimize().execute_compaction()


def test_refuses_a_predicate(tmp_path):
    """A predicate that is not an expression is refused with a typed
    error (an expression is ported: test_torch_conflict_predicates.py)."""
    table = _refusal(tmp_path)
    with pytest.raises(InvalidArgumentError):
        table.optimize().where(object())
    # where(None) is no predicate
    m = table.optimize().where(None).execute_zorder_by("k1")
    assert m.num_files_removed == 2


def test_refuses_deletion_vector_files(tmp_path):
    """Files with deletion vectors (the reference's DELETE on one copy of
    the table, hence on both) optimize as in the reference: their deleted
    rows purged, the removes carrying their descriptors."""
    from delta_tpu.commands.dml import delete
    from delta_tpu.expressions.tree import col, lit

    ref_path, port_path = _make_table(tmp_path, n_appends=3, properties={
        "delta.enableDeletionVectors": "true"})
    delete(RefTable.for_path(ref_path, engine=HostEngine()),
           predicate=col("k3") < lit(0))
    shutil.rmtree(port_path)
    shutil.copytree(ref_path, port_path)
    dv_adds = [a for a in _split(_commit(port_path, 3))["add"]
               if a.get("deletionVector")]
    assert len(dv_adds) == 3  # every file carries a DV
    pm = _optimize_both_like_reference(
        ref_path, port_path, lambda o: o.execute_compaction(), False)
    assert pm.num_files_removed == 3 and pm.num_files_added == 1
    assert len(_rows(port_path, _split(_commit(port_path, 4))["add"])) \
        == dta.read_table(ref_path, engine=HostEngine()).num_rows


def test_optimize_fills_a_column_older_files_lack(tmp_path):
    """Files written before a nullable column was populated read it as
    null (schema alignment), in the port as in the reference."""
    src = str(tmp_path / "src")
    rng = np.random.default_rng(3)
    full = _batch(rng, 200)
    dta.write_table(src, full, engine=HostEngine())
    for _ in range(2):
        dta.write_table(src, _batch(rng, 150).drop_columns(["s", "d"]),
                        engine=HostEngine())
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref_path)
    shutil.copytree(src, port_path)
    rm, pm = _run_both(ref_path, port_path,
                       lambda o: o.execute_zorder_by("k1", "s"))
    _assert_same_metrics(rm, pm)
    ref_actions, port_actions = _commit(ref_path, rm.version), \
        _commit(port_path, pm.version)
    _assert_same_commit(ref_actions, port_actions, True)
    rows = _rows(port_path, _split(port_actions)["add"])
    assert rows.column("s").null_count >= 300
    _assert_same_rows(_rows(ref_path, _split(ref_actions)["add"]), rows)

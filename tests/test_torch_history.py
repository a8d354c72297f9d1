"""Commit history and time travel by timestamp: the port's
`delta_tpu_torch.history` against the reference's `delta_tpu.history`.

`Table.history()` record for record (`CommitRecord.to_dict()`), newest
first and under a limit; `version_at_timestamp`,
`version_at_or_after_timestamp` and `Table.snapshot_as_of_timestamp` at
every timestamp around the commits' own, with file mtimes set by
`os.utime` (in order, equal and going backwards, which the monotonic
adjustment moves forward) and on an in-commit-timestamp table; the two
typed errors with the reference's error classes. Everything is exact.
"""

import json
import os

import numpy as np
import pytest

from delta_tpu import history as ref_history
from delta_tpu.engine.host import HostEngine
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine, history
from delta_tpu_torch.api import write_table
from delta_tpu_torch.errors import (
    TimestampEarlierThanCommitRetentionError,
    TimestampLaterThanLatestCommitError,
)
from test_torch_checkpoint import assert_matches_reference

CPU = TorchEngine("cpu")


def _tables(root):
    return (Table.for_path(root, engine=CPU),
            RefTable.for_path(root, engine=HostEngine()))


def _set_mtimes(root, mtimes_ms):
    log = os.path.join(root, "_delta_log")
    for v, t in enumerate(mtimes_ms):
        os.utime(os.path.join(log, f"{v:020d}.json"),
                 ns=(t * 1_000_000, t * 1_000_000))


def _written(root, n=5):
    rng = np.random.default_rng(0)
    for _ in range(n):
        write_table(root, {"k": rng.integers(0, 100, 10)}, engine=CPU)
    return root


def _outcome(fn):
    """The version `fn` returns, or its error's class and error_class."""
    try:
        return fn()
    except Exception as e:
        return type(e).__name__, getattr(e, "error_class", None)


MTIMES = {
    "increasing": [1_000, 2_000, 3_000, 4_000, 5_000],
    "equal": [1_000, 1_000, 1_000, 4_000, 4_000],
    "backwards": [5_000, 4_000, 3_000, 9_000, 2_000],
}


def test_history_record_for_record(tmp_path):
    root = _written(str(tmp_path))
    Table.for_path(root, engine=CPU).optimize().execute_compaction()
    port, ref = _tables(root)
    got = [r.to_dict() for r in port.history()]
    want = [r.to_dict() for r in ref.history()]
    assert got == want
    assert [r["version"] for r in got] == list(range(5, -1, -1))
    assert got[0]["operation"] == "OPTIMIZE"
    assert [r.to_dict() for r in port.history(limit=2)] == want[:2]


@pytest.mark.parametrize("shape", sorted(MTIMES))
def test_timestamps_resolve_as_the_reference(tmp_path, shape):
    root = _written(str(tmp_path))
    _set_mtimes(root, MTIMES[shape])
    port, ref = _tables(root)
    assert [r.to_dict() for r in port.history()] \
        == [r.to_dict() for r in ref.history()]
    stamps = sorted({t + d for t in MTIMES[shape] for d in (-1, 0, 1)}
                    | {t + 1 for t in range(4_000, 4_010)})
    for ts in stamps:
        for kw in ({}, {"can_return_last_commit": True},
                   {"can_return_earliest_commit": True}):
            assert _outcome(lambda: history.version_at_timestamp(
                port, ts, **kw)) == _outcome(
                lambda: ref_history.version_at_timestamp(ref, ts, **kw)), \
                (ts, kw)
        assert _outcome(lambda: history.version_at_or_after_timestamp(
            port, ts)) == _outcome(
            lambda: ref_history.version_at_or_after_timestamp(ref, ts)), ts


def test_snapshot_as_of_timestamp(tmp_path):
    root = _written(str(tmp_path))
    _set_mtimes(root, MTIMES["backwards"])
    port, ref = _tables(root)
    # monotonic timestamps: 5000, 5001, 5002, 9000, 9001
    for ts, version in ((5_000, 0), (5_001, 1), (8_999, 2), (9_000, 3),
                        (9_001, 4)):
        snap = port.snapshot_as_of_timestamp(ts)
        assert snap.version == version
        assert ref.snapshot_as_of_timestamp(ts).version == version
        state = snap.state
        ref_state = ref.snapshot_as_of_timestamp(ts).state
        assert sorted(a.path for a in state.add_files) \
            == sorted(ref_state.add_files_table.column("path").to_pylist())


def test_the_two_timestamp_errors(tmp_path):
    root = _written(str(tmp_path), 3)
    _set_mtimes(root, [10_000, 20_000, 30_000])
    port, _ = _tables(root)
    with pytest.raises(TimestampEarlierThanCommitRetentionError) as e:
        port.snapshot_as_of_timestamp(9_999)
    assert e.value.error_class \
        == "DELTA_TIMESTAMP_EARLIER_THAN_COMMIT_RETENTION"
    with pytest.raises(TimestampLaterThanLatestCommitError) as e:
        port.snapshot_as_of_timestamp(30_001)
    assert e.value.error_class == "DELTA_TIMESTAMP_GREATER_THAN_COMMIT"
    with pytest.raises(TimestampLaterThanLatestCommitError):
        history.version_at_or_after_timestamp(port, 30_001)
    assert history.version_at_timestamp(port, 30_001,
                                        can_return_last_commit=True) == 2
    assert history.version_at_timestamp(port, 1,
                                        can_return_earliest_commit=True) == 0


def _ict_log(root, icts):
    log = os.path.join(root, "_delta_log")
    os.makedirs(log)
    for v, ict in enumerate(icts):
        lines = [{"commitInfo": {"timestamp": 7, "inCommitTimestamp": ict,
                                 "operation": "WRITE"}}]
        if v == 0:
            lines += [
                {"protocol": {"minReaderVersion": 1, "minWriterVersion": 7,
                              "writerFeatures": ["inCommitTimestamp"]}},
                {"metaData": {
                    "id": "ict", "format": {"provider": "parquet",
                                            "options": {}},
                    "schemaString": '{"type":"struct","fields":[]}',
                    "partitionColumns": [], "configuration": {
                        "delta.enableInCommitTimestamps": "true"}}}]
        lines.append({"add": {"path": f"f{v}", "partitionValues": {},
                              "size": v + 1, "modificationTime": 1,
                              "dataChange": True}})
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return root


def test_in_commit_timestamps_decide(tmp_path):
    icts = [100_000, 200_000, 300_000, 400_000]
    root = _ict_log(str(tmp_path), icts)
    _set_mtimes(root, [9_000, 8_000, 7_000, 6_000])  # mtimes disagree
    port, ref = _tables(root)
    got = [r.to_dict() for r in port.history()]
    assert got == [r.to_dict() for r in ref.history()]
    assert [r["timestamp"] for r in got] == icts[::-1]
    for ts in (99_999, 100_000, 250_000, 400_000, 400_001):
        assert _outcome(lambda: history.version_at_timestamp(port, ts)) \
            == _outcome(lambda: ref_history.version_at_timestamp(ref, ts))
    snap = port.snapshot_as_of_timestamp(250_000)
    assert snap.version == 1
    assert snap.timestamp_ms == 200_000
    latest = port.latest_snapshot()
    assert latest.timestamp_ms == ref.latest_snapshot().timestamp_ms \
        == 400_000
    assert_matches_reference(root, latest.state)

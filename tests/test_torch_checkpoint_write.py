"""The port's checkpoint writer against the JAX package's.

On copies of one table, `delta_tpu.log.checkpointer.write_checkpoint`
(HostEngine) and `delta_tpu_torch.log.checkpointer.write_checkpoint`
(TorchEngine("cpu")) each checkpoint the latest version, classic and
multi-part; then their parts hold the same rows (pyarrow, sorted),
`_last_checkpoint` agrees apart from sizeInBytes and partManifest, a
HostEngine load of the port's checkpoint equals the port's state and a
port load of the JAX checkpoint equals the JAX state. Also: tombstone and
txn retention under a fixed clock, the row-count check, a torn multi-part
write, the aggregate block against the reference's jitted body and host
twin, `Table.checkpoint`, `snapshot_at`, and the V2 and stats_parsed
policies (with `tests/test_torch_log_forms.py`).
"""

import glob
import json
import os
import shutil
import time

import jax
import numpy as np
import pyarrow.parquet as pq
import pytest

from delta_tpu.config import settings as ref_settings
from delta_tpu.engine.host import HostEngine
from delta_tpu.log.checkpointer import write_checkpoint as ref_write
from delta_tpu.ops import stats as ref_stats
from delta_tpu.ops.replay import pad_bucket
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.api import write_table
from delta_tpu_torch.config import settings
from delta_tpu_torch.errors import (
    CheckpointError,
    ChecksumMismatchError,
    VersionNotFoundError,
)
from delta_tpu_torch.log import checkpointer
from delta_tpu_torch.log.checksum import read_checksum
from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint
from delta_tpu_torch.ops.stats import checkpoint_stats_block, host_stats_block
from delta_tpu_torch.replay.state import SnapshotState
from delta_tpu_torch.storage.local import LocalLogStore
from delta_tpu_torch.utils.synth import synth_delta_log
from delta_tpu_torch.write import ckpt_pipeline
from test_torch_checkpoint import _adds, _tombs, assert_matches_reference
from test_torch_page_decode import _typed, feature_log

WEEK_MS = 7 * 86_400_000
CPU = TorchEngine("cpu")


@pytest.fixture(autouse=True)
def _part_size():
    old = settings.checkpoint_part_size, ref_settings.checkpoint_part_size
    yield
    settings.checkpoint_part_size, ref_settings.checkpoint_part_size = old


def _port_written(root):
    rng = np.random.default_rng(4)
    for i in range(4):
        write_table(root, {"k": rng.integers(0, 100, 30),
                           "s": np.array([f"v{j}%{i}" for j in range(30)])},
                    engine=CPU)
    t = Table.for_path(root, engine=CPU)
    t.optimize().execute_compaction()
    write_table(root, {"k": np.arange(3), "s": np.array(["a", "b", "c"])},
                engine=CPU)


SOURCES = {
    "bench": lambda d: synth_delta_log(d, 30, 20, seed=6),
    "features_at_head": lambda d: feature_log(d, 4),
    "features_with_tail": lambda d: feature_log(d, 2),
    "port_written": _port_written,
}


def _copies(tmp_path, source):
    """The source table twice, its checkpoints removed."""
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    SOURCES[source](a)
    for p in glob.glob(os.path.join(a, "_delta_log", "*checkpoint*")):
        os.remove(p)
    shutil.copytree(a, b)
    return a, b


def _rows(path):
    out = {}
    for p in sorted(glob.glob(os.path.join(path, "_delta_log",
                                           "*.checkpoint*.parquet"))):
        t = pq.read_table(p)
        for root in t.column_names:
            typ = t.schema.field(root).type
            out.setdefault(root, []).extend(
                repr(_typed(v, typ)) for v in t.column(root).to_pylist()
                if v is not None)
    return {k: sorted(v) for k, v in out.items()}


def _write_both(a, b, part_size):
    ref_settings.checkpoint_part_size = part_size
    settings.checkpoint_part_size = part_size
    ri = ref_write(HostEngine(),
                   RefTable.for_path(a, engine=HostEngine()).latest_snapshot())
    pi = checkpointer.write_checkpoint(
        CPU, Table.for_path(b, engine=CPU).latest_snapshot())
    return ri, pi


def _hint(path):
    d = json.loads(open(os.path.join(path, "_delta_log",
                                     "_last_checkpoint")).read())
    d.pop("sizeInBytes", None)
    d.pop("partManifest", None)
    return d


def _load(path):
    return Table.for_path(path, engine=CPU).latest_snapshot().state


@pytest.mark.parametrize("part_size", [None, 3])
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_checkpoints_of_both_packages_agree(tmp_path, source, part_size):
    a, b = _copies(tmp_path, source)
    ri, pi = _write_both(a, b, part_size)
    assert _rows(a) == _rows(b)
    assert _hint(a) == _hint(b)
    assert pi.version == ri.version and pi.numOfAddFiles == ri.numOfAddFiles
    assert pi.parts == ri.parts and pi.size == ri.size
    assert (pi.parts or 1) == len(glob.glob(
        os.path.join(b, "_delta_log", "*.checkpoint*.parquet")))
    # the reference reads the port's checkpoint to the port's state ...
    obs.reset()
    mine = _load(b)
    assert mine.file_actions.version.min() == pi.version  # from the checkpoint
    assert obs.counters()["decode.device_fallbacks"] == 0
    assert_matches_reference(b, mine)
    # ... and the port reads the reference's to the reference's
    assert_matches_reference(a, _load(a))


def _fixed_clock(monkeypatch, now_ms):
    monkeypatch.setattr(time, "time", lambda: now_ms / 1000.0)


@pytest.mark.parametrize("source", ["bench", "features_at_head"])
def test_tombstone_retention_under_a_fixed_clock(tmp_path, monkeypatch,
                                                 source):
    """The synthetic tombstones carry deletionTimestamp = commit index;
    at now = 7 days + 11 ms those from commit 11 on are retained."""
    a, b = _copies(tmp_path, source)
    _fixed_clock(monkeypatch, WEEK_MS + 11)
    _write_both(a, b, 7)
    assert _rows(a) == _rows(b)
    kept = _rows(b).get("remove", [])
    state = _load(b)
    want = sorted(t.path for t in state.tombstones)
    assert sorted(t.path for t in _load(a).tombstones) == want
    all_tombs = RefTable.for_path(b, engine=HostEngine()).snapshot_at(
        state.version).state.tombstones()
    assert len(want) == len(kept) == sum(
        (t.deletionTimestamp or 0) >= 11 for t in all_tombs)
    assert_matches_reference(b, state)


def _txn_log(root):
    """Commits with three txns of different ages and a retention of 100 ms
    on the table."""
    log = os.path.join(root, "_delta_log")
    os.makedirs(log)
    meta = {"id": "txn", "format": {"provider": "parquet", "options": {}},
            "schemaString": '{"type":"struct","fields":[{"name":"x",'
                            '"type":"long","nullable":true,"metadata":{}}]}',
            "partitionColumns": [],
            "configuration": {
                "delta.setTransactionRetentionDuration": "interval 100 "
                                                         "milliseconds"}}
    lines = [{"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
             {"metaData": meta},
             {"txn": {"appId": "old", "version": 1, "lastUpdated": 10}},
             {"txn": {"appId": "fresh", "version": 2, "lastUpdated": 950}},
             {"txn": {"appId": "undated", "version": 3}},
             {"add": {"path": "f.parquet", "partitionValues": {}, "size": 1,
                      "modificationTime": 1, "dataChange": True}}]
    with open(os.path.join(log, f"{0:020d}.json"), "w") as f:
        f.write("\n".join(json.dumps(x) for x in lines) + "\n")


def test_txn_retention_under_a_fixed_clock(tmp_path, monkeypatch):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    _txn_log(a)
    shutil.copytree(a, b)
    _fixed_clock(monkeypatch, 1000)
    _write_both(a, b, None)
    assert _rows(a) == _rows(b)
    txns = _rows(b)["txn"]
    assert len(txns) == 1 and "'fresh'" in txns[0]
    assert list(_load(b).set_transactions) == ["fresh"]


def test_row_count_check(tmp_path, monkeypatch):
    synth_delta_log(str(tmp_path), 12, 10, seed=1)
    snap = Table.for_path(str(tmp_path), engine=CPU).latest_snapshot()
    real = snap.state.num_files
    monkeypatch.setattr(SnapshotState, "num_files",
                        property(lambda self: real + 1))
    with pytest.raises(ChecksumMismatchError) as e:
        checkpointer.write_checkpoint(CPU, snap)
    assert e.value.error_class == "DELTA_CHECKPOINT_SNAPSHOT_MISMATCH"
    assert not glob.glob(str(tmp_path / "_delta_log" / "*.checkpoint*"))


class _TearingStore(LocalLogStore):
    """Writes the first `good` checkpoint parts; the next one is torn (a
    prefix of its bytes lands, then the write fails)."""

    def __init__(self, good):
        self.good = good

    def write(self, path, data, overwrite=False):
        if ".checkpoint." in path:
            if self.good == 0:
                with open(path, "wb") as f:
                    f.write(data[:len(data) // 2])
                raise OSError("torn write")
            self.good -= 1
        super().write(path, data, overwrite)


def test_torn_multipart_write_keeps_the_previous_checkpoint(tmp_path):
    root = str(tmp_path)
    synth_delta_log(root, 25, 20, seed=3)
    Table.for_path(root, engine=CPU).checkpoint(version=19)
    before = read_last_checkpoint(LocalLogStore(), root + "/_delta_log")
    assert before.version == 19
    eng = TorchEngine("cpu")
    eng.fs = _TearingStore(good=2)
    settings.checkpoint_part_size = 50
    aborted = obs.counter("checkpoint.aborted_writes").read()
    with pytest.raises(ckpt_pipeline.CheckpointWriteError):
        checkpointer.write_checkpoint(
            eng, Table.for_path(root, engine=eng).latest_snapshot())
    assert obs.counter("checkpoint.aborted_writes").read() == aborted + 1
    assert not glob.glob(root + "/_delta_log/00000000000000000024.checkpoint*")
    assert read_last_checkpoint(LocalLogStore(), root + "/_delta_log") \
        == before
    state = _load(root)
    assert state.file_actions.version.min() == 19
    assert_matches_reference(root, state)


def test_collision_with_a_whole_part_counts_as_written(tmp_path):
    root = str(tmp_path)
    synth_delta_log(root, 12, 10, seed=2)
    snap = Table.for_path(root, engine=CPU).latest_snapshot()
    first = checkpointer.write_checkpoint(CPU, snap)
    assert first.sizeInBytes > 0
    written = obs.counter("checkpoint.parts_written").read()
    again = checkpointer.write_checkpoint(CPU, snap)  # every part exists
    assert obs.counter("checkpoint.parts_written").read() == written
    assert again.sizeInBytes is None
    assert again.numOfAddFiles == first.numOfAddFiles


@pytest.mark.parametrize("prop", ["delta.checkpointPolicy",
                                  "delta.checkpoint.writeStatsAsStruct"])
def test_v2_and_stats_struct_are_refused(tmp_path, prop):
    """Both were refused until the port wrote them: with the table
    property set, the two packages' checkpoints now hold the same rows
    (a V2 top level and its sidecars; stats_parsed beside the stats), and
    the reference loads the port's to the port's state."""
    from test_torch_log_forms import _rows as _all_rows

    a, b = _copies(tmp_path, "bench")
    for root in (a, b):
        _set_conf(root, {prop: "v2" if prop.endswith("Policy") else "true"})
    _write_both(a, b, 40)
    assert _all_rows(a) == _all_rows(b)
    log = os.path.join(b, "_delta_log")
    if prop.endswith("Policy"):
        assert len(os.listdir(os.path.join(log, "_sidecars"))) > 1
        assert read_last_checkpoint(LocalLogStore(), log).tag
    else:
        assert all("stats_parsed" in r for r in _all_rows(b)["add"])
    assert_matches_reference(b, _load(b))


def test_stats_written_as_json_can_be_turned_off(tmp_path):
    a, b = _copies(tmp_path, "bench")
    for root in (a, b):
        _set_conf(root, {"delta.checkpoint.writeStatsAsJson": "false"})
    _write_both(a, b, None)
    assert _rows(a) == _rows(b)
    assert all("'stats'" not in r for r in _rows(b)["add"])


def _set_conf(root, conf):
    """Append a metaData commit with `conf` to a synthetic log."""
    log = os.path.join(root, "_delta_log")
    v = max(int(p[-25:-5]) for p in glob.glob(log + "/*.json"))
    state = _load(root)
    meta = state.metadata.to_dict()
    meta["configuration"] = {**meta["configuration"], **conf}
    with open(os.path.join(log, f"{v + 1:020d}.json"), "w") as f:
        f.write(json.dumps({"metaData": meta}) + "\n")


def _random_lanes(rng, n, n_parts):
    lanes, valids = [], []
    for _ in range(3):
        lanes.append(rng.integers(-2**40, 2**40, size=n))
        valids.append(rng.random(n) > 0.2)
    lanes.append(rng.integers(0, 5, size=n))
    valids.append(np.ones(n, bool))
    return lanes, valids, rng.integers(0, n_parts, size=n).astype(np.int32)


def _reference_block(lanes, valids, part_of, n_parts, n_codes):
    """The reference's `checkpoint_stats_block` body without its `_x64`
    helper (ROADMAP C0): the same padding, then the jitted
    `_agg_fn_cached` under `jax.enable_x64(True)`."""
    n_l, n = len(lanes), len(lanes[0])
    n_pad = pad_bucket(max(n, 1))
    p_pad = pad_bucket(max(n_parts, 1), min_bucket=8)
    vals = np.zeros((n_l, n_pad), np.int64)
    vb = np.zeros((n_l, n_pad), bool)
    for i, (lane, ok) in enumerate(zip(lanes, valids)):
        vals[i, :n], vb[i, :n] = lane, ok
    parts = np.full(n_pad, p_pad, np.int32)
    parts[:n] = part_of
    with jax.enable_x64(True):
        fn = ref_stats._agg_fn_cached(n_l, n_pad, p_pad)
        block = fn(vals, np.packbits(vb, axis=1, bitorder="little"), parts,
                   np.int64(max(n_codes, 1) + 1))
        return np.asarray(block)[:, :n_parts]


@pytest.mark.parametrize("n,n_parts", [(0, 1), (7, 1), (1000, 9)])
def test_stats_block_equals_the_reference(n, n_parts):
    rng = np.random.default_rng(n + n_parts)
    lanes, valids, part_of = _random_lanes(rng, n, n_parts)
    got = checkpoint_stats_block(lanes, valids, part_of, n_parts, 5, "cpu")
    assert got.dtype == np.int64 and got.shape == (17, n_parts)
    assert np.array_equal(got, host_stats_block(lanes, valids, part_of,
                                                n_parts, 5))
    assert np.array_equal(got, ref_stats.host_stats_block(
        lanes, valids, part_of, n_parts, 5))
    assert np.array_equal(got, _reference_block(lanes, valids, part_of,
                                                n_parts, 5))


@pytest.mark.parametrize("source,part_size", [("bench", 40),
                                              ("features_at_head", None),
                                              ("features_at_head", 2)])
def test_checkpoint_publishes_the_aggregate_of_the_written_adds(
        tmp_path, source, part_size):
    root, _ = _copies(tmp_path, source)
    settings.checkpoint_part_size = part_size
    snap = Table.for_path(root, engine=CPU).latest_snapshot()
    state = snap.state
    obs.reset()
    m = checkpointer.CheckpointMetrics()
    info = checkpointer.write_checkpoint(CPU, snap, metrics=m)
    counts = obs.counters()
    # the same lanes and plan, assembled again, through the host twin
    adds = checkpointer._file_block(
        state.file_actions.rows,
        np.flatnonzero(state.live_mask.cpu().numpy()), "add")
    n_tombs = info.size - adds.n - sum(
        b.n for b in checkpointer._small_action_blocks(state))
    plan = (checkpointer._chunk_plan(adds.n, n_tombs, part_size)
            if info.parts else [(0, adds.n, 0, n_tombs)])
    lanes, valids, part_of, n_codes = checkpointer._checkpoint_lanes(
        state, adds, plan)
    block = host_stats_block(lanes, valids, part_of, len(plan), n_codes)
    assert counts["checkpoint.logical_bytes"] == int(block[8].sum()) \
        == state.size_in_bytes
    assert counts["checkpoint.dv_cardinality"] == int(block[10].sum()) \
        == sum(a.deletionVector.cardinality for a in state.add_files
               if a.deletionVector is not None)
    assert counts["checkpoint.distinct_partition_values"] \
        == int(block[16].max())
    if part_size is None:
        assert counts["checkpoint.distinct_partition_values"] == len(
            {tuple(sorted(a.partitionValues.items()))
             for a in state.add_files})
    assert set(m.phase_seconds) == {"rows", "retention", "aggregate",
                                    "encode", "put", "hint"}
    assert m.parts == (info.parts or 1) and m.rows == info.size
    assert m.bytes_written == sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(root, "_delta_log", "*.checkpoint*")))


def test_table_checkpoint_and_snapshot_at(tmp_path):
    root = str(tmp_path)
    synth_delta_log(root, 15, 10, seed=7)
    t = Table.for_path(root, engine=CPU)
    assert t.snapshot_at(6).state.version == 6
    t.checkpoint(version=8)
    assert read_last_checkpoint(t.engine.fs, t.log_path).version == 8
    crc = read_checksum(t.engine.fs, t.log_path, 8)
    st8 = t.snapshot_at(8).state
    assert st8.file_actions.version.min() == 8
    assert (crc.numFiles, crc.tableSizeBytes) == (st8.num_files,
                                                  st8.size_in_bytes)
    ref8 = RefTable.for_path(root, engine=HostEngine()).snapshot_at(8).state
    assert _adds(st8.add_files) == _adds(ref8.add_files())
    assert _tombs(st8.tombstones) == _tombs(ref8.tombstones())
    with pytest.raises(VersionNotFoundError):
        t.snapshot_at(15)
    with pytest.raises(CheckpointError):
        Table.for_path(str(tmp_path / "none"), engine=CPU).checkpoint()

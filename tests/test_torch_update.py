"""`Snapshot.update()`, the post-commit handoff and the P&M fast path of
the port, against the reference and against the port's own cold load.

`delta_tpu_torch.Table.for_path(p, engine=TorchEngine("cpu"))` (the plain
versions of K1 and K2) advances its cached snapshot by the new commits
alone; the advanced state must equal `delta_tpu.Table.for_path(p,
engine=HostEngine())` at the same version (live files, tombstones,
`num_files`, `size_in_bytes`, protocol, metadata, txns, all exact) and
the port's cold load of the same segment bit for bit (lanes and masks
equal, path and deletion-vector codes a bijection). Counters hold the
economy: a no-change poll does one LIST and no read, an advance reads only
the new commits, a commit that notified the cache leaves its hooks no
full replay, and metadata served from a `.crc` decodes no checkpoint
part. Everything is exact.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from delta_tpu.engine.host import HostEngine
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.errors import LogCorruptedError
from delta_tpu_torch.models.actions import AddFile, RemoveFile
from delta_tpu_torch.models.schema import StructField, StructType
from test_torch_checkpoint import assert_matches_reference
from test_torch_cuda import UPDATE_LOGS, commit_actions, update_log

CPU = TorchEngine("cpu")
NOW_MS = int(time.time() * 1000)  # tombstones inside the retention window
PATHS = ["a", "b", "c", "d/e", "x%20y", "x y", "f%25g", "h", "i%2Fj"]


def _line(obj) -> str:
    return json.dumps(obj, separators=(",", ":"))


def _dv(tag):
    return {"storageType": "u", "pathOrInlineDv": f"dv{tag}", "offset": 1,
            "sizeInBytes": 10, "cardinality": 2}


def _action(kind, path, size, dv=None):
    body = {"path": path, "dataChange": True, "size": size}
    if kind == "add":
        body.update(partitionValues={}, modificationTime=1,
                    stats=_line({"numRecords": size}))
    else:
        body["deletionTimestamp"] = NOW_MS
    if dv is not None:
        body["deletionVector"] = _dv(dv)
    return _line({kind: body})


def _protocol(dvs: bool):
    if dvs:
        return {"minReaderVersion": 3, "minWriterVersion": 7,
                "readerFeatures": ["deletionVectors"],
                "writerFeatures": ["deletionVectors"]}
    return {"minReaderVersion": 1, "minWriterVersion": 2}


def write_commit(root, v, actions=(), dvs=False, extra=()):
    """Commit `v` of a hand-written log: `actions` are (kind, raw path[,
    dv tag]); commit 0 carries the protocol and metadata; `extra` lines
    (dicts) go first, after a commitInfo."""
    log = os.path.join(root, "_delta_log")
    os.makedirs(log, exist_ok=True)
    lines = [_line({"commitInfo": {"timestamp": 1000 + v,
                                   "operation": "WRITE"}})]
    if v == 0:
        lines += [_line({"protocol": _protocol(dvs)}), _line({"metaData": {
            "id": "upd", "format": {"provider": "parquet", "options": {}},
            "schemaString": '{"type":"struct","fields":[]}',
            "partitionColumns": [], "configuration": {}}})]
    lines += [_line(e) for e in extra]
    for j, a in enumerate(actions):
        lines.append(_action(a[0], a[1], 100 * v + j + 1,
                             a[2] if len(a) > 2 else None))
    with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _ref_checkpoint(root, version):
    RefTable.for_path(root, engine=HostEngine()).checkpoint(version=version)


def assert_same_as_cold(state, root):
    """`state` equals the port's cold load of its version bit for bit:
    lanes and masks equal, the two numberings of the keys a bijection,
    the materialized actions equal."""
    cold = Table.for_path(root, engine=CPU).snapshot_at(state.version).state
    a, c = state.file_actions, cold.file_actions
    for lane in ("is_add", "version", "order", "size"):
        assert torch.equal(getattr(a, lane), getattr(c, lane)), lane
    assert torch.equal(state.live_mask, cold.live_mask)
    assert torch.equal(state.tombstone_mask, cold.tombstone_mask)
    pairs = set(zip(a.path_code.tolist(), a.dv_code.tolist(),
                    c.path_code.tolist(), c.dv_code.tolist()))
    assert len({p[:2] for p in pairs}) == len({p[2:] for p in pairs}) \
        == len(pairs)
    assert state.add_files == cold.add_files
    assert state.tombstones == cold.tombstones
    assert (state.num_files, state.size_in_bytes) \
        == (cold.num_files, cold.size_in_bytes)


def assert_advanced(state, root):
    assert_matches_reference(root, state)
    assert_same_as_cold(state, root)


def _delta(before: dict) -> dict:
    after = obs.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


# ------------------------------------------------ the reference's cases


def _port_table(root, props=None):
    t = Table.for_path(str(root), engine=CPU)
    b = t.create_transaction_builder().with_schema(
        StructType([StructField("x", "integer")]))
    if props:
        b = b.with_table_properties(props)
    b.build().commit()
    return t


def _commit(t, i, removes=()):
    txn = t.create_transaction_builder().build()
    txn.add_file(AddFile(path=f"p{i}.parquet", partitionValues={},
                         size=100 + i, modificationTime=1000 + i,
                         dataChange=True, stats=_line({"numRecords": i})))
    for r in removes:
        txn.remove_file(RemoveFile(path=r, deletionTimestamp=NOW_MS,
                                   dataChange=True, size=100))
    return txn.commit().version


def test_update_parity_mixed_add_remove(tmp_path):
    t = _port_table(tmp_path)
    for i in range(4):
        _commit(t, i)
    warm = t.update()
    warm.state
    assert warm.version == 4
    other = Table.for_path(str(tmp_path), engine=CPU)
    for i in range(4, 9):
        _commit(other, i, removes=[f"p{i - 4}.parquet"])
    before = obs.counters()
    inc = t.update()
    moved = _delta(before)
    assert inc.version == 9 and inc is not warm
    assert moved.get("replay.advances") == 1
    assert moved.get("replay.reconstructs", 0) == 0
    assert moved.get("log.commit_reads") == 5  # the new commits alone
    assert_advanced(inc.state, str(tmp_path))


def test_update_parity_readd_after_remove(tmp_path):
    t = _port_table(tmp_path)
    _commit(t, 0)
    t.update().state
    other = Table.for_path(str(tmp_path), engine=CPU)
    txn = other.create_transaction_builder().build()
    txn.remove_file(RemoveFile(path="p0.parquet", deletionTimestamp=NOW_MS,
                               dataChange=True, size=100))
    txn.commit()
    _commit(other, 0)
    inc = t.update()
    assert inc.num_files == 1
    assert_advanced(inc.state, str(tmp_path))


def test_snapshot_update_returns_self_when_current(tmp_path):
    t = _port_table(tmp_path)
    _commit(t, 0)
    snap = t.update()
    assert snap.update() is snap
    assert t.update() is snap


def test_no_change_poll_does_one_list_zero_reads(tmp_path):
    t = _port_table(tmp_path)
    _commit(t, 0)
    snap = t.update()
    snap.state
    before = obs.counters()
    assert t.update() is snap
    moved = _delta(before)
    assert moved.get("storage.list_calls") == 1
    assert moved.get("storage.read_calls", 0) == 0
    assert moved.get("log.commit_reads", 0) == 0


def test_update_falls_back_on_checkpoint_boundary(tmp_path):
    t = _port_table(tmp_path)
    for i in range(3):
        _commit(t, i)
    snap = t.update()
    snap.state
    assert snap.version == 3
    other = Table.for_path(str(tmp_path), engine=CPU)
    _commit(other, 3)
    other.checkpoint()  # at 4, past the snapshot
    before = obs.counters()
    assert snap.update() is None
    assert _delta(before).get("snapshot.update_fallbacks") == 1
    latest = t.update()  # the table falls back to a full load
    assert latest.version == 4
    assert latest.log_segment.checkpoint_version == 4
    assert_matches_reference(str(tmp_path), latest.state)


def test_update_falls_back_on_protocol_change(tmp_path):
    root = str(tmp_path)
    write_commit(root, 0, [("add", "a")])
    t = Table.for_path(root, engine=CPU)
    snap = t.update()
    snap.state
    write_commit(root, 1, [("add", "b")], extra=[{"protocol": {
        "minReaderVersion": 1, "minWriterVersion": 3}}])
    assert snap.update() is None
    latest = t.update()
    assert latest.version == 1
    assert latest.protocol.minWriterVersion == 3
    assert_matches_reference(root, latest.state)


def test_advanced_with_blobs_rejects_version_gap(tmp_path):
    t = _port_table(tmp_path)
    _commit(t, 0)
    snap = t.update()
    snap.state
    blob = (b'{"add":{"path":"q.parquet","partitionValues":{},"size":1,'
            b'"modificationTime":1,"dataChange":true}}\n')
    assert snap._advanced_with_blobs([(snap.version + 2, blob)]) is None
    assert snap._advanced_with_blobs([]) is None


def test_commit_advances_cache_without_rereading_own_commit(tmp_path):
    t = _port_table(tmp_path)
    _commit(t, 0)
    t.update().state
    before = obs.counters()
    _commit(t, 1)  # notify_commit hands the bytes over
    snap = t.update()
    moved = _delta(before)
    assert snap.version == 2 and snap.num_files == 2
    assert moved.get("table.notify_advances") == 1
    assert moved.get("log.commit_reads", 0) == 0
    assert moved.get("replay.reconstructs", 0) == 0
    # the reads left: the .crc chain's previous version (checksum hook)
    # and the transaction's own probes, no commit file
    assert moved.get("storage.read_calls", 0) <= 2
    assert_advanced(snap.state, str(tmp_path))


def test_checkpoint_hook_runs_off_advanced_state(tmp_path):
    t = _port_table(tmp_path, {"delta.checkpointInterval": "4"})
    t.update().state
    before = obs.counters()
    for i in range(4):
        _commit(t, i)  # version 4 runs the checkpoint hook
    moved = _delta(before)
    assert moved.get("replay.reconstructs", 0) == 0
    assert moved.get("log.commit_reads", 0) == 0
    assert moved.get("table.notify_advances") == 4
    assert os.path.exists(os.path.join(
        tmp_path, "_delta_log", f"{4:020d}.checkpoint.parquet"))
    assert not any(v for k, v in obs.counters().items()
                   if k.startswith("hooks.") and k.endswith(".failures"))
    cold = Table.for_path(str(tmp_path), engine=CPU).latest_snapshot()
    assert cold.log_segment.checkpoint_version == 4
    assert cold.num_files == 4
    assert_matches_reference(str(tmp_path), cold.state)


# ------------------------------------------------------ the port's own


def _route_log(root, route):
    """Commits 0-3 over '%' paths; the prior state loads commit-only,
    through a checkpoint at 2 and its tail, or through a checkpoint at its
    head (the handoff). Returns the loaded Table."""
    write_commit(root, 0, [("add", "a"), ("add", "x y"), ("add", "f%25g")])
    write_commit(root, 1, [("add", "b"), ("remove", "a")])
    write_commit(root, 2, [("add", "d/e"), ("add", "a")])
    write_commit(root, 3, [("add", "h"), ("remove", "b")])
    if route == "checkpoint_tail":
        _ref_checkpoint(root, 2)
    elif route == "handoff":
        _ref_checkpoint(root, 3)
    t = Table.for_path(root, engine=CPU)
    obs.reset()
    t.latest_snapshot().state
    counts = obs.counters()
    assert bool(counts.get("decode.handoff_launches")) == (route == "handoff")
    assert bool(counts.get("decode.device_parts")) == (route != "commit_only")
    return t


ROUTES = ["commit_only", "checkpoint_tail", "handoff"]


@pytest.mark.parametrize("route", ROUTES)
def test_update_on_each_load_route(tmp_path, route):
    root = str(tmp_path)
    t = _route_log(root, route)
    # x%20y is the prior's "x y"; f%g is the prior's f%25g; i/j is new
    write_commit(root, 4, [("remove", "x%20y"), ("add", "c"),
                           ("remove", "f%g")])
    write_commit(root, 5, [("add", "x%20y"), ("add", "i%2Fj"),
                           ("remove", "h")])
    before = obs.counters()
    snap = t.update()
    moved = _delta(before)
    assert snap.version == 5
    assert moved.get("replay.advances") == 1
    assert moved.get("replay.reconstructs", 0) == 0
    assert moved.get("decode.device_parts", 0) == 0
    assert moved.get("log.commit_reads") == 2
    assert sorted(a.path for a in snap.state.add_files) \
        == ["a", "c", "d/e", "i/j", "x y"]
    assert sorted(r.path for r in snap.state.tombstones) \
        == ["b", "f%g", "h"]
    assert_advanced(snap.state, root)


@pytest.mark.parametrize("route", ROUTES)
def test_notify_commit_on_each_load_route(tmp_path, route):
    """A transaction of the port on a table whose cached state came by
    each route: the commit's bytes advance the cache."""
    root = str(tmp_path)
    t = _route_log(root, route)
    before = obs.counters()
    txn = t.create_transaction_builder().build()
    txn.remove_file(RemoveFile(path="x y", deletionTimestamp=NOW_MS,
                               dataChange=True, size=2))
    txn.add_file(AddFile(path="x%20y", size=7, modificationTime=1,
                         dataChange=True))
    txn.add_file(AddFile(path="n.parquet", size=9, modificationTime=1,
                         dataChange=True))
    assert txn.commit().version == 4
    snap = t.update()
    moved = _delta(before)
    assert moved.get("table.notify_advances") == 1
    assert moved.get("log.commit_reads", 0) == 0
    assert moved.get("replay.reconstructs", 0) == 0
    assert snap.version == 4
    assert_advanced(snap.state, root)


def test_same_path_under_two_deletion_vectors(tmp_path):
    root = str(tmp_path)
    write_commit(root, 0, [("add", "p", 1), ("add", "q")], dvs=True)
    write_commit(root, 1, [("add", "r")], dvs=True)
    _ref_checkpoint(root, 1)
    write_commit(root, 2, [("add", "s")], dvs=True)
    t = Table.for_path(root, engine=CPU)
    t.latest_snapshot().state
    # p under dv1 stays beside p under dv2, then dv1's goes
    write_commit(root, 3, [("add", "p", 2)], dvs=True)
    snap = t.update()
    assert sorted((a.path, a.dv_unique_id) for a in snap.state.add_files) \
        == [("p", "udv1@1"), ("p", "udv2@1"), ("q", None), ("r", None),
            ("s", None)]
    assert_advanced(snap.state, root)
    write_commit(root, 4, [("remove", "p", 1), ("add", "q", 3)], dvs=True)
    snap = t.update()
    assert_advanced(snap.state, root)


def test_chained_advances(tmp_path):
    root = str(tmp_path)
    write_commit(root, 0, [("add", "a"), ("add", "b")])
    t = Table.for_path(root, engine=CPU)
    t.latest_snapshot().state
    paths = list(PATHS)
    rng = np.random.default_rng(7)
    for v in range(1, 7):
        picks = rng.choice(len(paths), 3, replace=False)
        write_commit(root, v, [("remove" if rng.random() < 0.4 else "add",
                                paths[i]) for i in picks])
        snap = t.update()
        assert snap.version == v
        assert_advanced(snap.state, root)
    assert isinstance(snap.state.file_actions.rows.stores, list)
    assert len(snap.state.file_actions.rows.stores) == 7  # flat, not nested


def test_commit_holding_only_commit_info(tmp_path):
    root = str(tmp_path)
    write_commit(root, 0, [("add", "a")])
    write_commit(root, 1, [("add", "b")])
    _ref_checkpoint(root, 1)
    t = Table.for_path(root, engine=CPU)
    prior = t.latest_snapshot().state
    write_commit(root, 2, [])
    write_commit(root, 3, [], extra=[{"txn": {"appId": "app",
                                              "version": 3}}])
    snap = t.update()
    assert snap.version == 3
    assert snap.state.file_actions is prior.file_actions
    assert snap.set_transaction_version("app") == 3
    assert sorted(snap.state.commit_infos) == [2, 3]  # 1 is checkpointed
    assert_advanced(snap.state, root)


def _random_log(root, seed):
    """2-9 commits of adds and removes over PATHS (each decoded path and
    dv at most once per commit; odd seeds add deletion vectors, which the
    host parser reads), a reference checkpoint at a random version or
    none, and a cut version to load before advancing."""
    rng = np.random.default_rng(seed)
    dvs = seed % 2 == 1
    n = int(rng.integers(2, 10))
    for v in range(n):
        k = int(rng.integers(0, 5)) if v else int(rng.integers(1, 5))
        seen, acts = set(), []
        for _ in range(k):
            p = PATHS[int(rng.integers(len(PATHS)))]
            dv = int(rng.integers(0, 3)) if dvs else 0
            key = (p.replace("%20", " ").replace("%25", "%")
                   .replace("%2F", "/"), dv)
            if key in seen:
                continue
            seen.add(key)
            kind = "add" if v == 0 or rng.random() < 0.6 else "remove"
            acts.append((kind, p, dv) if dv else (kind, p))
        write_commit(root, v, acts, dvs=dvs)
    cp = int(rng.integers(0, n)) if rng.random() < 0.6 else None
    if cp is not None:
        _ref_checkpoint(root, cp)
    return n, int(rng.integers(0, n - 1)), cp


@pytest.mark.parametrize("seed", range(32))
def test_random_logs_cut_and_advanced(tmp_path, seed):
    root = str(tmp_path)
    n, cut, cp = _random_log(root, seed)
    snap = Table.for_path(root, engine=CPU).snapshot_at(cut)
    snap.state
    adv = snap.update()
    if cp is not None and cp > cut:
        assert adv is None  # a checkpoint past the cut: a full load
        state = Table.for_path(root, engine=CPU).update().state
        assert_matches_reference(root, state)
        return
    assert adv.version == n - 1
    assert_advanced(adv.state, root)


def test_torn_new_commit_raises_and_the_cache_stands(tmp_path):
    root = str(tmp_path)
    write_commit(root, 0, [("add", "a")])
    t = Table.for_path(root, engine=CPU)
    snap = t.update()
    snap.state
    with open(os.path.join(root, "_delta_log", f"{1:020d}.json"), "w") as f:
        f.write('{"add":{"path":"b","partitionVal')
    with pytest.raises(LogCorruptedError):
        t.update()
    assert t.latest_snapshot() is not snap  # the LIST moved on


# ------------------------------------------------------- the P&M path


def _checkpointed_with_crc(root):
    """A port-written table checkpointed at its head, with a `.crc` per
    version (the hooks write them)."""
    t = _port_table(root, {"delta.checkpointInterval": "3"})
    for i in range(3):
        _commit(t, i)
    return t


def test_metadata_from_the_crc_decodes_no_part(tmp_path):
    root = str(tmp_path)
    _checkpointed_with_crc(root)
    ref = RefTable.for_path(root, engine=HostEngine()).latest_snapshot()
    before = obs.counters()
    snap = Table.for_path(root, engine=CPU).latest_snapshot()
    assert snap.log_segment.checkpoints
    meta, proto = snap.metadata, snap.protocol
    moved = _delta(before)
    assert moved.get("snapshot.pm_from_crc") == 1
    assert moved.get("decode.device_parts", 0) == 0
    assert moved.get("replay.reconstructs", 0) == 0
    assert moved.get("replay.small_loads", 0) == 0
    assert meta.to_dict() == ref.metadata.to_dict()
    assert proto.to_dict() == ref.protocol.to_dict()
    assert snap.timestamp_ms == ref.timestamp_ms
    assert snap.get_config("delta.checkpointInterval") == 3
    assert snap.get_config("delta.appendOnly") is False
    assert snap.partition_columns == []
    assert [f.name for f in snap.schema.fields] == ["x"]


@pytest.mark.parametrize("damage", ["garbled", "truncated"])
def test_corrupt_crc_falls_back_to_the_small_read(tmp_path, damage):
    root = str(tmp_path)
    _checkpointed_with_crc(root)
    crc = os.path.join(root, "_delta_log", f"{3:020d}.crc")
    data = open(crc, "rb").read()
    with open(crc, "wb") as f:
        f.write(b"{not json" if damage == "garbled" else data[:len(data) // 2])
    ref = RefTable.for_path(root, engine=HostEngine()).latest_snapshot()
    before = obs.counters()
    snap = Table.for_path(root, engine=CPU).latest_snapshot()
    meta = snap.metadata
    moved = _delta(before)
    assert moved.get("snapshot.pm_from_crc", 0) == 0
    assert moved.get("replay.small_loads") == 1
    assert moved.get("decode.device_parts", 0) == 0
    assert moved.get("decode.device_fallbacks", 0) == 0
    assert moved.get("replay.reconstructs", 0) == 0
    assert meta.to_dict() == ref.metadata.to_dict()
    assert snap.protocol.to_dict() == ref.protocol.to_dict()
    assert snap.set_transactions() == {}


def test_small_state_txns_and_domains_match_the_reference(tmp_path):
    """txn and domainMetadata from a checkpoint's small columns and the
    tail's control lines, without the file replay."""
    from test_torch_page_decode import feature_log

    root = feature_log(str(tmp_path), 2)
    ref = RefTable.for_path(root, engine=HostEngine()).latest_snapshot()
    before = obs.counters()
    snap = Table.for_path(root, engine=CPU).latest_snapshot()
    txns = snap.set_transactions()
    moved = _delta(before)
    assert moved.get("replay.small_loads") == 1
    assert moved.get("decode.device_parts", 0) == 0
    assert {k: t.to_dict() for k, t in txns.items()} \
        == {k: t.to_dict() for k, t in ref.set_transactions().items()}
    for app in txns:
        assert snap.set_transaction_version(app) \
            == ref.set_transaction_version(app)
    for domain in ref.state.domain_metadata:
        got, want = snap.domain_metadata(domain), ref.domain_metadata(domain)
        assert (got.to_dict() if got else None) \
            == (want.to_dict() if want else None)
    assert snap.metadata.to_dict() == ref.metadata.to_dict()
    assert snap.protocol.to_dict() == ref.protocol.to_dict()


def test_ict_table_whose_crc_lacks_the_ict_takes_the_small_read(tmp_path):
    """An in-commit-timestamp table whose newest `.crc` has no ICT: the
    timestamp comes from the small read of the tail commit's commitInfo,
    not from the `.crc` and not from the file's mtime."""
    root = str(tmp_path)
    log = os.path.join(root, "_delta_log")
    os.makedirs(log)
    meta = {"id": "ict", "format": {"provider": "parquet", "options": {}},
            "schemaString": '{"type":"struct","fields":[]}',
            "partitionColumns": [],
            "configuration": {"delta.enableInCommitTimestamps": "true"}}
    protocol = {"minReaderVersion": 1, "minWriterVersion": 7,
                "writerFeatures": ["inCommitTimestamp"]}
    for v, lines in enumerate((
            [{"commitInfo": {"timestamp": 5, "inCommitTimestamp": 100000,
                             "operation": "CREATE TABLE"}},
             {"protocol": protocol}, {"metaData": meta}],
            [{"commitInfo": {"timestamp": 6, "inCommitTimestamp": 123456,
                             "operation": "WRITE"}}])):
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(_line(x) for x in lines) + "\n")
    _ref_checkpoint(root, 0)
    with open(os.path.join(log, f"{1:020d}.crc"), "w") as f:
        f.write(_line({"tableSizeBytes": 0, "numFiles": 0, "numMetadata": 1,
                       "numProtocol": 1, "metadata": meta,
                       "protocol": protocol}))
    before = obs.counters()
    snap = Table.for_path(root, engine=CPU).latest_snapshot()
    ts = snap.timestamp_ms
    moved = _delta(before)
    assert moved.get("snapshot.pm_from_crc", 0) == 0
    assert moved.get("replay.small_loads") == 1
    assert moved.get("decode.device_parts", 0) == 0
    ref = RefTable.for_path(root, engine=HostEngine()).latest_snapshot()
    assert ts == ref.timestamp_ms == 123456


def test_latest_snapshot_lists_from_the_hint_and_serves_the_cache(tmp_path):
    root = str(tmp_path)
    for v in range(6):
        write_commit(root, v, [("add", f"f{v}")])
    _ref_checkpoint(root, 4)
    t = Table.for_path(root, engine=CPU)
    snap = t.latest_snapshot()
    assert snap.log_segment.checkpoint_version == 4
    assert [os.path.basename(f.path) for f in snap.log_segment.deltas] \
        == [f"{5:020d}.json"]
    assert t.latest_snapshot() is snap
    assert t.snapshot_at(5).log_segment.checkpoint_version == 4
    assert t.snapshot_at(2).version == 2


def test_a_hint_to_a_checkpoint_that_lost_a_part_is_discarded(tmp_path):
    root = str(tmp_path)
    for v in range(4):
        write_commit(root, v, [("add", f"f{v}")])
    _ref_checkpoint(root, 1)
    log = os.path.join(root, "_delta_log")
    hint = os.path.join(log, "_last_checkpoint")
    shutil.copy(hint, hint + ".one")
    _ref_checkpoint(root, 3)
    # the hint names a two-part checkpoint at 3 of which one part is gone
    doc = json.load(open(hint))
    doc["parts"] = 2
    with open(hint, "w") as f:
        json.dump(doc, f)
    os.rename(os.path.join(log, f"{3:020d}.checkpoint.parquet"),
              os.path.join(log, f"{3:020d}.checkpoint.{1:010d}.{2:010d}"
                                ".parquet"))
    before = obs.counters()
    state = Table.for_path(root, engine=CPU).latest_snapshot().state
    assert _delta(before).get("log.hint_discarded") == 1
    assert state.version == 3
    assert_matches_reference(root, state)


@pytest.mark.parametrize("by", ["update", "notify_commit"])
@pytest.mark.parametrize("case", sorted(UPDATE_LOGS))
def test_card_update_cases_match_the_reference(tmp_path, case, by):
    """The logs `tests/test_torch_cuda.py` advances on the card, advanced
    here on the CPU: the live files and tombstones it expects are the
    reference's, and the advanced state is the cold load's."""
    prior, cp, new, live, tombstones = UPDATE_LOGS[case]
    root = update_log(str(tmp_path), prior)
    if cp is not None:
        Table.for_path(root, engine=CPU).checkpoint(version=cp)
    table = Table.for_path(root, engine=CPU)
    table.latest_snapshot().state
    before = obs.counters()
    if by == "update":
        update_log(root, new, start=len(prior))
    else:
        for actions in new:
            commit_actions(table, actions)
    snap = table.update()
    moved = _delta(before)
    assert moved.get("replay.reconstructs", 0) == 0
    assert sorted(a.path for a in snap.state.add_files) == live
    assert sorted(r.path for r in snap.state.tombstones) == tombstones
    assert_advanced(snap.state, root)

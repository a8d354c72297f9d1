"""Whole-slice parity: the port's snapshot load against the JAX package's.

`delta_tpu_torch.Table.for_path(p, engine=TorchEngine("cpu"))` against
`delta_tpu.Table.for_path(p, engine=HostEngine())` on small logs written
to disk: both packages read the same bytes. On the CPU every kernel runs
its plain version, so this holds the port's control flow, windowing,
dictionary coding, fallback ladder and materialization to the reference.
"""

import json
import os
from urllib.parse import unquote

import numpy as np
import pytest
import torch

import bench
from delta_tpu.engine.host import HostEngine
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.errors import CorruptLogError, TableNotFoundError
from delta_tpu_torch.models.actions import (
    RemoveFile,
    action_to_json,
    decode_path,
    encode_path,
)
from delta_tpu_torch.utils.synth import synth_delta_log


def _d(obj) -> str:
    return json.dumps(obj, separators=(",", ":"))


_PROTO = '{"protocol":{"minReaderVersion":1,"minWriterVersion":2}}'
_META = _d({"metaData": {"id": "t", "format": {"provider": "parquet",
                                               "options": {}},
                         "schemaString": "{}", "partitionColumns": [],
                         "configuration": {"k": "v"}}})


def _add(path, size=10, mod=1, stats=None, **extra):
    a = {"path": path, "partitionValues": {}, "size": size,
         "modificationTime": mod, "dataChange": True}
    if stats is not None:
        a["stats"] = stats
    a.update(extra)
    return _d({"add": a})


def _remove(path, ts=5, **extra):
    return _d({"remove": dict({"path": path, "deletionTimestamp": ts,
                               "dataChange": True}, **extra)})


def _write_log(root, commits):
    log = os.path.join(root, "_delta_log")
    os.makedirs(log, exist_ok=True)
    for v, lines in enumerate(commits):
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


def _load(path, **engine_kw):
    return Table.for_path(path, engine=TorchEngine("cpu", **engine_kw)) \
        .latest_snapshot().state


def _assert_matches_reference(path, got):
    ref = RefTable.for_path(path, engine=HostEngine()).latest_snapshot().state
    assert got.version == ref.version
    assert got.protocol.to_dict() == ref.protocol.to_dict()
    assert got.metadata.to_dict() == ref.metadata.to_dict()
    assert ({k: t.to_dict() for k, t in got.set_transactions.items()}
            == {k: t.to_dict() for k, t in ref.set_transactions.items()})
    assert ({k: t.to_dict() for k, t in got.domain_metadata.items()}
            == {k: t.to_dict() for k, t in ref.domain_metadata.items()})
    assert got.num_files == ref.num_files
    assert got.size_in_bytes == ref.size_in_bytes

    def adds(files):
        return sorted((a.path, a.size, a.modificationTime, a.dataChange,
                       a.stats, a.partitionValues, a.dv_unique_id)
                      for a in files)

    def tombs(files):
        return sorted((r.path, r.deletionTimestamp, r.dataChange, r.size,
                       r.extendedFileMetadata, r.dv_unique_id)
                      for r in files)

    assert adds(got.add_files) == adds(ref.add_files())
    assert tombs(got.tombstones) == tombs(ref.tombstones())
    assert got.live_mask.dtype == torch.bool
    assert not bool((got.live_mask & got.tombstone_mask).any())


def test_bench_shaped_log_takes_the_device_route(tmp_path):
    truth = synth_delta_log(str(tmp_path), 40, 20, seed=1)
    obs.reset()
    got = _load(str(tmp_path))
    counts = obs.counters()
    assert counts["parse.device_windows"] == 1
    assert counts["parse.device_fallbacks"] == 0
    _assert_matches_reference(str(tmp_path), got)
    assert sorted(a.path for a in got.add_files) == truth.live_paths
    assert got.size_in_bytes == truth.size_in_bytes
    assert int(got.tombstone_mask.sum()) == truth.num_tombstones
    assert set(got.phase_seconds) == {"read", "parse", "replay"}


def test_small_windows_split_at_commit_boundaries(tmp_path):
    synth_delta_log(str(tmp_path), 30, 20, seed=2)
    obs.reset()
    got = _load(str(tmp_path), parse_window_bytes=8192)
    assert obs.counters()["parse.device_windows"] > 3
    assert obs.counters()["parse.device_fallbacks"] == 0
    _assert_matches_reference(str(tmp_path), got)
    whole = _load(str(tmp_path))
    assert torch.equal(got.live_mask, whole.live_mask)
    assert torch.equal(got.tombstone_mask, whole.tombstone_mask)


def test_readds_escapes_and_percent_paths(tmp_path):
    stats = _d({"numRecords": 3, "minValues": {"s": 'a"b\\c'}})
    commits = [
        [_d({"commitInfo": {"timestamp": 1, "operation": "CREATE"}}),
         _PROTO, _META, _add("a", stats=stats), _add("b"),
         _add("x%20y"), _add('q"uo\\te'), _add("café")],
        [_remove("a"), _add("c", size=7), _remove("x y"),
         _d({"txn": {"appId": "app", "version": 2, "lastUpdated": 4}})],
        [_add("a", size=99, mod=3), _remove("b", ts=9),
         _d({"domainMetadata": {"domain": "d", "configuration": "{}",
                                "removed": False}}),
         '{"add":{"path":"uni\\u00e9x","partitionValues":{},"size":1,'
         '"modificationTime":2,"dataChange":true}}',
         _d({"txn": {"appId": "app", "version": 3}})],
        [_remove("q\"uo\\te", ts=11), _add("b", size=5)],
    ]
    path = _write_log(tmp_path, commits)
    obs.reset()
    got = _load(path)
    assert obs.counters()["parse.device_fallbacks"] == 0
    _assert_matches_reference(path, got)
    assert got.set_transactions["app"].version == 3
    # "x%20y" and "x y" are one file after percent-decoding
    assert "x y" not in {a.path for a in got.add_files}
    assert got.latest_commit_info.operation == "CREATE"


@pytest.mark.parametrize("path", [
    "plain/part-0001.snappy.parquet", "month=12/x:y/f", "a%b", "a%20b",
    "p=%2F/f", "e f/ü/é", "50%", "%", "%%2525", "q#r?s&t+u,v;w@x!y$z'()*",
    "\t\n tab", "a/b=c=d/", "", "日本/データ"])
def test_encode_path_decodes_once_to_the_path(path):
    """The log's form of a decoded path (models/actions.py) decodes once
    back to it, and a path of unreserved characters, '/', '=' and ':'
    comes out unchanged."""
    enc = encode_path(path)
    assert unquote(enc) == path == decode_path(enc)
    if all(c.isascii() and (c.isalnum() or c in "-._~/=:") for c in path):
        assert enc == path
    assert "%" not in path or "%25" in enc
    assert json.loads(action_to_json(RemoveFile(path)))["remove"]["path"] \
        == enc


# A log in another writer's form: each decoded path still holds an escape
# or needs one (ROADMAP C7), and the raw forms differ from the port's own.
SPARK_FORM = {"p=a%2520b/f%2D1": "p=a%20b/f-1", "p=x%2525y/f2": "p=x%25y/f2",
              "p=%252F/f3": "p=%2F/f3", "p=e%20f/f4": "p=e f/f4",
              "p=50%25/f5": "p=50%/f5", "plain/f6": "plain/f6"}


@pytest.mark.parametrize("form", ["classic", "multi_part", "v2"])
def test_foreign_uris_decode_once_through_checkpoints_and_removes(
        tmp_path, monkeypatch, form):
    """A checkpoint of such a log, a commit that removes every file from
    the checkpoint's rows, then a checkpoint of the tombstones: the port
    and the reference load each version to the same files, and no
    removed file comes back."""
    from delta_tpu.replay.columnar import clear_parse_cache
    from delta_tpu_torch.commands.dml import delete
    from delta_tpu_torch.config import settings
    from delta_tpu_torch.log.checkpointer import write_checkpoint

    schema = {"type": "struct", "fields": [
        {"name": "k", "type": "long", "nullable": True, "metadata": {}}]}
    meta = _d({"metaData": {"id": "t", "format": {"provider": "parquet",
                                                  "options": {}},
                            "schemaString": json.dumps(schema),
                            "partitionColumns": [], "configuration": {}}})
    path = _write_log(tmp_path, [[_PROTO, meta] + [
        _add(raw, size=i + 1) for i, raw in enumerate(SPARK_FORM)]])
    monkeypatch.setattr(settings, "checkpoint_part_size",
                        2 if form == "multi_part" else None)
    cpu = TorchEngine("cpu")

    def checkpoint():
        table = Table.for_path(path, engine=cpu)
        write_checkpoint(cpu, table.latest_snapshot(),
                         policy="v2" if form == "v2" else "classic")

    def load(version):
        clear_parse_cache()
        got = _load(path)
        assert got.version == version
        _assert_matches_reference(path, got)
        return got

    checkpoint()
    assert sorted(a.path for a in load(0).add_files) == \
        sorted(SPARK_FORM.values())
    m = delete(Table.for_path(path, engine=cpu))
    assert m.num_files_removed_fully == len(SPARK_FORM)
    with open(os.path.join(path, "_delta_log", f"{1:020d}.json")) as f:
        removes = [json.loads(ln)["remove"]["path"] for ln in f
                   if '"remove"' in ln]
    assert sorted(unquote(r) for r in removes) == sorted(SPARK_FORM.values())
    for version in (1, 1):
        got = load(version)
        assert got.num_files == 0
        assert sorted(r.path for r in got.tombstones) == \
            sorted(SPARK_FORM.values())
        checkpoint()


def test_complex_lines_hand_the_buffer_to_the_host(tmp_path):
    dv = {"storageType": "u", "pathOrInlineDv": "ab", "offset": 1,
          "sizeInBytes": 3, "cardinality": 2}
    dv2 = dict(dv, pathOrInlineDv="cd")
    commits = [
        [_PROTO, _META, _add("a"), _add("b", tags={"k": "v"}),
         _add("p", partitionValues={"d": "1"})],
        [_remove("a", ts=3), _add("a", deletionVector=dv)],
        [_remove("a", ts=4, deletionVector=dv), _add("a", deletionVector=dv2),
         _add("c", baseRowId=4)],
    ]
    path = _write_log(tmp_path, commits)
    obs.reset()
    got = _load(path)
    assert obs.counters()["parse.device_fallbacks"] == 1
    assert obs.counters()["parse.device_windows"] == 0
    _assert_matches_reference(path, got)
    live = {a.path: a for a in got.add_files}
    assert live["a"].dv_unique_id == "ucd@1"
    assert live["p"].partitionValues == {"d": "1"}


def test_malformed_control_line_falls_back_then_raises(tmp_path):
    """The device parse hands a malformed line to the host parser. In the
    newest commit, as its only line, it is a torn tip: the snapshot serves
    the version before it, as the reference does. Below the tip it raises
    LogCorruptedError, not the torn-tip error."""
    from delta_tpu_torch.errors import LogCorruptedError, TornCommitError

    path = _write_log(tmp_path, [[_PROTO, _META, _add("a")],
                                 ['{"commitInfo":{"timestamp":1']])
    obs.reset()
    got = _load(path)
    assert got.version == 0
    _assert_matches_reference(path, got)
    assert obs.counters()["parse.device_fallbacks"] == 1
    assert obs.counters()["snapshot.torn_commit_fallbacks"] == 1
    with open(os.path.join(path, "_delta_log", f"{2:020d}.json"), "w") as f:
        f.write(_add("b") + "\n")
    obs.reset()
    with pytest.raises(LogCorruptedError) as ei:
        _load(path)
    assert not isinstance(ei.value, TornCommitError)
    assert obs.counters()["parse.device_fallbacks"] == 1


def test_checkpointed_or_compacted_log_is_refused(tmp_path):
    """Both forms were refused until the port read them. A damaged V2
    top level (UUID-named) now takes the ladder back to the JSON log, and
    a compacted delta stands in for the commits it covers; both as in the
    reference."""
    path = _write_log(tmp_path, [[_PROTO, _META, _add("a")], [_add("b")]])
    log = os.path.join(path, "_delta_log")
    v2 = os.path.join(log, f"{1:020d}.checkpoint.3f2a-uuid.parquet")
    with open(v2, "wb") as f:
        f.write(b"PAR1")
    obs.reset()
    got = _load(path)
    assert obs.counters()["snapshot.checkpoint_fallbacks"] == 1
    _assert_matches_reference(path, got)
    os.remove(v2)
    with open(os.path.join(log, f"{0:020d}.{1:020d}.compacted.json"),
              "w") as f:
        f.write(_PROTO + "\n" + _META + "\n" + _add("a") + "\n")
    got = _load(path)
    assert sorted(a.path for a in got.add_files) == ["a"]
    _assert_matches_reference(path, got)


def test_listing_errors(tmp_path):
    with pytest.raises(TableNotFoundError):
        Table.for_path(str(tmp_path / "none"),
                       engine=TorchEngine("cpu")).latest_snapshot()
    path = _write_log(tmp_path, [[_PROTO, _META], [_add("a")], [_add("b")]])
    os.remove(os.path.join(path, "_delta_log", f"{1:020d}.json"))
    with pytest.raises(CorruptLogError):
        Table.for_path(path, engine=TorchEngine("cpu")).latest_snapshot()


def test_engine_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        assert TorchEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchEngine()
        with pytest.raises(RuntimeError):
            TorchEngine("cuda")
    assert TorchEngine("cpu").device.type == "cpu"


def test_synth_writes_bench_bytes(tmp_path):
    bench.synth_delta_log(str(tmp_path / "ref"), 25, 20, seed=4)
    truth = synth_delta_log(str(tmp_path / "port"), 25, 20, seed=4)
    ref_log, port_log = tmp_path / "ref/_delta_log", tmp_path / "port/_delta_log"
    names = sorted(os.listdir(ref_log))
    assert names == sorted(os.listdir(port_log)) and len(names) == 25
    for name in names:
        assert (ref_log / name).read_bytes() == (port_log / name).read_bytes()
    assert truth.version == 24
    assert truth.num_actions == 25 * 20 - 4  # commit 0 removes nothing
    assert len(truth.live_paths) == 25 * 16 - truth.num_tombstones
    assert np.all(np.diff([len(p) for p in truth.live_paths]) == 0)


@pytest.mark.parametrize("route", ["device", "host"])
def test_sequential_host_replay_equals_device_replay(tmp_path, route):
    from delta_tpu_torch.log.segment import build_log_segment
    from delta_tpu_torch.replay.columnar import columnarize_log_segment
    from delta_tpu_torch.replay.state import (
        compute_masks_device,
        compute_masks_host,
    )

    synth_delta_log(str(tmp_path), 30, 20, seed=5)
    if route == "host":  # a tagged add sends the buffer to the host parser
        with open(tmp_path / "_delta_log" / f"{30:020d}.json", "w") as f:
            f.write(_add("t", tags={"k": "v"}) + "\n")
    eng = TorchEngine("cpu")
    col = columnarize_log_segment(
        eng, build_log_segment(eng.fs, str(tmp_path / "_delta_log")))
    assert col.parsed_on_device == (route == "device")
    live, tomb = compute_masks_device(col)
    h_live, h_tomb = compute_masks_host(col)
    assert torch.equal(live, h_live) and torch.equal(tomb, h_tomb)
    assert int(live.sum()) > 0 and int(tomb.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_histories_match_reference(tmp_path, seed):
    """Random adds, removes, re-adds and same-commit add/remove pairs over
    awkward path spellings; the odd seeds add deletion vectors, which
    hand the buffer to the host parser."""
    rng = np.random.default_rng(seed)
    names = ["plain", "sp%20ace", 'q"t', "b\\s", "é", "a/b"]
    alive, dead, commits = [], [], []
    for v in range(15):
        lines = [_PROTO, _META] if v == 0 else []
        for _ in range(int(rng.integers(1, 9))):
            r = rng.random()
            if r < 0.4 or not alive:
                p = f"{names[int(rng.integers(len(names)))]}-{v}-{len(lines)}"
                extra = {}
                if seed % 2 and rng.random() < 0.2:
                    extra["deletionVector"] = {
                        "storageType": "u", "pathOrInlineDv": f"d{v}",
                        "sizeInBytes": 1, "cardinality": 1}
                lines.append(_add(p, size=int(rng.integers(1, 99)), mod=v,
                                  **extra))
                if not extra:
                    alive.append(p)
            elif r < 0.7:
                p = alive.pop(int(rng.integers(len(alive))))
                lines.append(_remove(p, ts=v))
                dead.append(p)
            elif r < 0.85 and dead:
                p = dead.pop(int(rng.integers(len(dead))))
                lines.append(_add(p, size=1000 + v, mod=v))
                alive.append(p)
            else:
                p = alive[int(rng.integers(len(alive)))]
                lines.append(_add(p, size=2000 + v, mod=v))
                lines.append(_remove(p, ts=v))
                lines.append(_add(p, size=3000 + v, mod=v))
        commits.append(lines)
    path = _write_log(tmp_path, commits)
    obs.reset()
    got = _load(path, parse_window_bytes=int(rng.choice([600, 1 << 20])))
    assert obs.counters()["parse.device_fallbacks"] == seed % 2
    _assert_matches_reference(path, got)


def test_unsupported_reader_protocol_is_refused(tmp_path):
    from delta_tpu_torch.errors import UnsupportedTableFeatureError

    proto = _d({"protocol": {"minReaderVersion": 3, "minWriterVersion": 7,
                             "readerFeatures": ["noSuchFeature"],
                             "writerFeatures": []}})
    path = _write_log(tmp_path, [[proto, _META, _add("a")]])
    with pytest.raises(UnsupportedTableFeatureError) as err:
        _load(path)
    assert err.value.features == {"noSuchFeature"}

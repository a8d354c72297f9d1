"""Checkpoint-plus-tail loads of logs whose paths hold a '%'.

`delta_tpu_torch.Table.for_path(p, engine=TorchEngine("cpu"))` against
`delta_tpu.Table.for_path(p, engine=HostEngine())` on small logs over
paths that need percent-decoding (`x%20y` and `x y` name one file,
`f%25g` is `f%g`), anchored by a classic checkpoint that either package
wrote. Such a log takes the remap branch of
`replay/device_parse.py::path_codes`, which decodes one row per raw path
through the checkpoint-and-commit row store; that store serves rows in
ascending order only, so the branch must ask for them in that order.
Everything is exact.
"""

import json
import os
import time

import numpy as np
import pytest

from delta_tpu.engine.host import HostEngine
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.replay.columnar import CheckpointRows, CompositeRows

RAW_PATHS = ["a", "b", "c", "d/e", "x%20y", "x y", "f%25g", "h"]
NOW_MS = int(time.time() * 1000)  # tombstones inside the retention window


def _line(obj) -> str:
    return json.dumps(obj, separators=(",", ":"))


def _add(path, size):
    return _line({"add": {"path": path, "partitionValues": {}, "size": size,
                          "modificationTime": 1, "dataChange": True}})


def _remove(path, size):
    return _line({"remove": {"path": path, "deletionTimestamp": NOW_MS,
                             "dataChange": True, "size": size}})


def _write_log(root, commits):
    """commits: per version, a list of ("add" | "remove", raw path)."""
    log = os.path.join(root, "_delta_log")
    os.makedirs(log, exist_ok=True)
    for v, actions in enumerate(commits):
        lines = []
        if v == 0:
            lines += [_line({"protocol": {"minReaderVersion": 1,
                                          "minWriterVersion": 2}}),
                      _line({"metaData": {
                          "id": "pct", "format": {"provider": "parquet",
                                                  "options": {}},
                          "schemaString": "{}", "partitionColumns": [],
                          "configuration": {}}})]
        for j, (kind, path) in enumerate(actions):
            size = 100 * v + j + 1
            lines.append(_add(path, size) if kind == "add"
                         else _remove(path, size))
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


def _checkpoint(root, version, writer):
    if writer == "reference":
        RefTable.for_path(root, engine=HostEngine()).checkpoint(version=version)
    else:
        Table.for_path(root, engine=TorchEngine("cpu")).checkpoint(
            version=version)


def _random_commits(seed):
    """1-8 commits of adds and removes over RAW_PATHS, each logical
    (decoded) file at most once per commit; a checkpoint version."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    commits = []
    for _ in range(n):
        seen, actions = set(), []
        for k in rng.permutation(len(RAW_PATHS)).tolist():
            raw = RAW_PATHS[k]
            logical = raw.replace("%20", " ").replace("%25", "%")
            if logical in seen or rng.random() < 0.5:
                continue
            seen.add(logical)
            actions.append(("remove" if rng.random() < 0.3 else "add", raw))
        commits.append(actions)
    return commits, int(rng.integers(0, n))


def _assert_matches_reference(path):
    got = Table.for_path(path, engine=TorchEngine("cpu")) \
        .latest_snapshot().state
    ref = RefTable.for_path(path, engine=HostEngine()).latest_snapshot().state
    assert got.version == ref.version
    assert got.num_files == ref.num_files
    assert got.size_in_bytes == ref.size_in_bytes

    def adds(files):
        return sorted((a.path, a.size, a.modificationTime, a.dataChange,
                       a.dv_unique_id or "") for a in files)

    def tombs(files):
        return sorted((r.path, r.deletionTimestamp, r.dataChange, r.size,
                       r.dv_unique_id or "") for r in files)

    assert adds(got.add_files) == adds(ref.add_files())
    assert tombs(got.tombstones) == tombs(ref.tombstones())
    assert not bool((got.live_mask & got.tombstone_mask).any())
    return got


WRITERS = ["reference", "port"]


@pytest.mark.parametrize("writer", WRITERS)
def test_live_file_behind_the_checkpoint_is_kept(tmp_path, writer):
    """v0 adds f%25g, a checkpoint at 0, v1 adds c and b: f%g stays live
    (the rows once took each other's paths and f%g was lost)."""
    root = _write_log(str(tmp_path), [[("add", "f%25g")],
                                      [("add", "c"), ("add", "b")]])
    _checkpoint(root, 0, writer)
    got = _assert_matches_reference(root)
    assert sorted(a.path for a in got.add_files) == ["b", "c", "f%g"]


@pytest.mark.parametrize("writer", WRITERS)
def test_file_removed_after_the_checkpoint_is_a_tombstone(tmp_path, writer):
    """v0 adds f%25g and b, a checkpoint at 0, v1 removes f%25g and adds
    c: live b and c, tombstone f%g (this once raised IndexError)."""
    root = _write_log(str(tmp_path), [[("add", "f%25g"), ("add", "b")],
                                      [("remove", "f%25g"), ("add", "c")]])
    _checkpoint(root, 0, writer)
    got = _assert_matches_reference(root)
    assert sorted(a.path for a in got.add_files) == ["b", "c"]
    assert [r.path for r in got.tombstones] == ["f%g"]


@pytest.mark.parametrize("seed", range(16))
@pytest.mark.parametrize("writer", WRITERS)
def test_random_checkpointed_logs_match_reference(tmp_path, writer, seed):
    commits, version = _random_commits(seed)
    root = _write_log(str(tmp_path), commits)
    _checkpoint(root, version, writer)
    _assert_matches_reference(root)


def test_row_stores_refuse_indices_out_of_order():
    """Both stores cut `idx` by position: indices out of order would give
    rows each other's paths, so they raise instead."""
    composite = CompositeRows(None, 4, None)
    a, b = composite.split(np.array([0, 3, 4, 6]))
    assert a.tolist() == [0, 3] and b.tolist() == [0, 2]
    with pytest.raises(ValueError, match="ascending"):
        composite.split(np.array([5, 1]))
    with pytest.raises(ValueError, match="ascending"):
        list(CheckpointRows([]).blocks(np.array([2, 0])))

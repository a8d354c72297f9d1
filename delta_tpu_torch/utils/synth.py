"""Synthetic `_delta_log` shaped like the repo's headline benchmark, and
synthetic checkpoints.

`synth_delta_log` is a copy of `bench.py::synth_delta_log` (same seed,
same bytes) that also returns the generator's own truth, so a load can be
checked without a second reader: the live paths, their total size, the
tombstone count and the removed paths. Given `checkpoint_version` it also
writes a checkpoint of the state at that version, split into parts the
way `bench.py`'s checkpoint metric splits them (`part_size = num_files //
8`).

`write_checkpoint` writes a checkpoint of the generator's own truth (not
of a loaded snapshot: the package's writer, `log/checkpointer.py`, does
that) through that writer's retention, part layout, encoder and
`_last_checkpoint` record; only the Blocks and the clock come from the
generator. It serves `chip_smoke.py` and the tests.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from delta_tpu_torch.log.checkpointer import (
    RETENTION_MS,
    Block,
    Repeated,
    encode_part,
    part_layout,
    retained,
    rows_block,
)
from delta_tpu_torch.log.last_checkpoint import write_last_checkpoint
from delta_tpu_torch.log.parquet_host import Strings
from delta_tpu_torch.storage.local import LocalLogStore

ADD_SIZE = 1048576


def write_checkpoint(log_path: str, version: int, small: Sequence[Block],
                     adds: Block, removes: Block,
                     part_size: Optional[int] = None,
                     now_ms: Optional[int] = None) -> dict:
    """Write the checkpoint of the state at `version`: `small` holds the
    protocol, metaData, txn and domainMetadata blocks, `adds` the live
    files, `removes` every tombstone (those older than `now_ms -
    RETENTION_MS` are dropped), laid out in parts by the writer's
    `part_layout`. Returns the `_last_checkpoint` record it wrote."""
    now_ms = int(time.time() * 1000) if now_ms is None else now_ms
    layout = part_layout(log_path, version, small, adds,
                         retained(removes, now_ms, RETENTION_MS), part_size)
    size_bytes = 0
    for path, blocks in zip(layout.paths, layout.contents):
        data = encode_part(blocks)
        with open(path, "wb") as f:
            f.write(data)
        size_bytes += len(data)
    info = layout.hint(version, size_bytes)
    write_last_checkpoint(LocalLogStore(), log_path, info)
    return json.loads(info.to_json())


@dataclass
class SynthTruth:
    version: int
    live_paths: List[str]  # sorted
    size_in_bytes: int
    num_tombstones: int
    num_actions: int
    checkpoint: Optional[dict] = None  # the _last_checkpoint record
    removed_paths: List[str] = field(default_factory=list)  # sorted


PROTOCOL = {"minReaderVersion": 1, "minWriterVersion": 2}
METADATA = {
    "id": "bench", "format": {"provider": "parquet", "options": {}},
    "schemaString": '{"type":"struct","fields":[{"name":"x","type":"long",'
                    '"nullable":true,"metadata":{}}]}',
    "partitionColumns": [], "configuration": {}}


def _stats(fid: np.ndarray) -> List[str]:
    lo, hi = (fid + 1) * 1000, (fid + 2) * 1000
    return [f'{{"numRecords":1000,"minValues":{{"x":{a}}},'
            f'"maxValues":{{"x":{b}}},"nullCount":{{"x":0}}}}'
            for a, b in zip(lo.tolist(), hi.tolist())]


def _synth_checkpoint(log: str, version: int, paths: List[str],
                      alive: List[int], add_version: List[int],
                      removed: List[tuple], now_ms: Optional[int]) -> dict:
    """The checkpoint of the generator's state after commit `version`:
    live adds in the order they were added, tombstones in the order they
    were removed."""
    fid = np.sort(np.asarray(alive, np.int64))
    n = fid.shape[0]
    ones = np.ones(n, bool)
    adds = Block("add", n, {
        ("path",): (Strings.from_list([paths[f] for f in fid.tolist()]),
                    ones),
        ("partitionValues",): Repeated(ones, np.zeros(n + 1, np.int64),
                                       Strings.from_list([]),
                                       np.zeros(0, bool),
                                       Strings.from_list([])),
        ("size",): (np.full(n, ADD_SIZE, np.int64), ones),
        ("modificationTime",): (np.asarray(add_version, np.int64)[fid], ones),
        ("stats",): (Strings.from_list(_stats(fid)), ones),
    })
    rfid = np.asarray([f for f, _ in removed], np.int64)
    r_ones = np.ones(rfid.shape[0], bool)
    removes = Block("remove", rfid.shape[0], {
        ("path",): (Strings.from_list([paths[f] for f in rfid.tolist()]),
                    r_ones),
        ("deletionTimestamp",): (np.asarray([v for _, v in removed],
                                            np.int64), r_ones),
    })
    small = [rows_block("protocol", [PROTOCOL]),
             rows_block("metaData", [METADATA])]
    return write_checkpoint(log, version, small, adds, removes,
                            part_size=max(1, n // 8),
                            now_ms=now_ms)


def synth_delta_log(path: str, commits: int, files_per_commit: int,
                    remove_fraction: float = 0.2, seed: int = 0,
                    checkpoint_version: Optional[int] = None,
                    now_ms: Optional[int] = None) -> SynthTruth:
    """Write a synthetic `_delta_log`: every commit adds UUID-fresh files
    with stats and removes a slice of earlier-added ones; commit 0 also
    carries the protocol and metadata. No partitions.

    With `checkpoint_version`, also a checkpoint of the state after that
    commit, with `part_size = num_files // 8` (bench.py's split) and
    tombstones retained against `now_ms`.

    Removal picks are swap-popped from the alive list (O(1) per pick) and
    each commit's random draws are one vectorized call."""
    rng = np.random.default_rng(seed)
    log = os.path.join(path, "_delta_log")
    os.makedirs(log, exist_ok=True)
    protocol = json.dumps({"protocol": PROTOCOL}, separators=(",", ":"))
    metadata = json.dumps({"metaData": METADATA}, separators=(",", ":"))
    paths: List[str] = []
    add_version: List[int] = []
    alive: List[int] = []  # file ids
    removed: List[tuple] = []  # (file id, version)
    info = None
    n_rm = int(files_per_commit * remove_fraction)
    n_add_max = files_per_commit - n_rm
    for v in range(commits):
        lines = []
        if v == 0:
            lines.append(protocol)
            lines.append(metadata)
        k = min(n_rm, len(alive))
        if k:
            # one vectorized draw; each pick is uniform over the list
            # length at its own step (lengths shrink by one per pick)
            picks = rng.integers(
                0, np.arange(len(alive), len(alive) - k, -1))
            for j in picks:
                f = alive[j]
                alive[j] = alive[-1]
                alive.pop()
                removed.append((f, v))
                lines.append(
                    f'{{"remove":{{"path":"{paths[f]}","deletionTimestamp":'
                    f'{v},"dataChange":true}}}}'
                )
        uuids = rng.integers(0, 1 << 60, size=n_add_max)
        for u in uuids:
            fid = len(paths)
            p = f"part-{fid:010d}-{u:016x}.parquet"
            paths.append(p)
            add_version.append(v)
            alive.append(fid)
            lo, hi = (fid + 1) * 1000, (fid + 2) * 1000
            lines.append(
                f'{{"add":{{"path":"{p}","partitionValues":{{}},'
                f'"size":1048576,"modificationTime":{v},"dataChange":true,'
                f'"stats":"{{\\"numRecords\\":1000,'
                f'\\"minValues\\":{{\\"x\\":{lo}}},'
                f'\\"maxValues\\":{{\\"x\\":{hi}}},'
                f'\\"nullCount\\":{{\\"x\\":0}}}}"}}}}'
            )
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(lines) + "\n")
        if v == checkpoint_version:
            info = _synth_checkpoint(log, v, paths, alive, add_version,
                                     removed, now_ms)
    return SynthTruth(version=commits - 1,
                      live_paths=sorted(paths[f] for f in alive),
                      size_in_bytes=ADD_SIZE * len(alive),
                      num_tombstones=len(removed),
                      num_actions=len(paths) + len(removed),
                      checkpoint=info,
                      removed_paths=sorted(paths[f] for f, _ in removed))

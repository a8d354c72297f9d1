"""Synthetic `_delta_log` shaped like the repo's headline benchmark.

A copy of `bench.py::synth_delta_log` (same seed, same bytes) that also
returns the generator's own truth, so a load can be checked without a
second reader: the live paths, their total size and the tombstone count.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

ADD_SIZE = 1048576


@dataclass
class SynthTruth:
    version: int
    live_paths: List[str]  # sorted
    size_in_bytes: int
    num_tombstones: int
    num_actions: int


def synth_delta_log(path: str, commits: int, files_per_commit: int,
                    remove_fraction: float = 0.2, seed: int = 0) -> SynthTruth:
    """Write a synthetic `_delta_log`: every commit adds UUID-fresh files
    with stats and removes a slice of earlier-added ones; commit 0 also
    carries the protocol and metadata. No checkpoint, no partitions.

    Removal picks are swap-popped from the alive list (O(1) per pick) and
    each commit's random draws are one vectorized call."""
    rng = np.random.default_rng(seed)
    log = os.path.join(path, "_delta_log")
    os.makedirs(log, exist_ok=True)
    protocol = '{"protocol":{"minReaderVersion":1,"minWriterVersion":2}}'
    metadata = (
        '{"metaData":{"id":"bench","format":{"provider":"parquet",'
        '"options":{}},"schemaString":"{\\"type\\":\\"struct\\",'
        '\\"fields\\":[{\\"name\\":\\"x\\",\\"type\\":\\"long\\",'
        '\\"nullable\\":true,\\"metadata\\":{}}]}",'
        '"partitionColumns":[],"configuration":{}}}'
    )
    alive: list = []
    fid = 0
    removed = 0
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
                p = alive[j]
                alive[j] = alive[-1]
                alive.pop()
                lines.append(
                    f'{{"remove":{{"path":"{p}","deletionTimestamp":{v},'
                    f'"dataChange":true}}}}'
                )
            removed += k
        uuids = rng.integers(0, 1 << 60, size=n_add_max)
        for u in uuids:
            p = f"part-{fid:010d}-{u:016x}.parquet"
            fid += 1
            alive.append(p)
            lo, hi = fid * 1000, (fid + 1) * 1000
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
    return SynthTruth(version=commits - 1, live_paths=sorted(alive),
                      size_in_bytes=ADD_SIZE * len(alive),
                      num_tombstones=removed, num_actions=fid + removed)

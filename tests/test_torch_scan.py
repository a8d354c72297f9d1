"""Scan planning: the port's `Snapshot.scan` against the JAX package's.

Tables written by the reference (`HostEngine`), with a column of every
type the port reads (long, integer, double, float, boolean, string, date,
timestamp), nulls in most; a partitioned one (planning only: the port's
row read refuses it); one with a file that has no stats. The port
(`TorchEngine("cpu")`: the plain skip mask) and the reference
(`HostEngine`) scan each with the same seeded random predicates (60 per
table, 3 tables); the surviving paths (as sets: the two packages list
files in their own order), `partition_pruned` and `skipped_by_stats`
must be equal. Then the resident index's life: a second scan reuses it, an
`update()` with new files rebuilds it and scans equal to a cold snapshot's,
an `update()` over a commit without file actions keeps it.
"""

import json
import os

import numpy as np
import pytest

import delta_tpu.api as dta
import delta_tpu.expressions.tree as RE
from delta_tpu.engine.host import HostEngine
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine, obs
from torch_scan_helpers import (
    TYPES,
    add_file_without_stats,
    build,
    random_spec,
    typed_batch,
    write_typed_table,
)

N_PREDICATES = 60


def _ref_scan(path, spec):
    snap = RefTable.for_path(path, HostEngine()).latest_snapshot()
    sc = snap.scan(filter=build(spec, RE))
    paths = sc.add_files_table().column("path").to_pylist()
    return sorted(paths), sc.partition_pruned, sc.skipped_by_stats


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan")
    plain = str(root / "plain")
    write_typed_table(plain, seed=1)
    part = str(root / "part")
    write_typed_table(part, seed=2, partition_by=["p"])
    nostats = str(root / "nostats")
    write_typed_table(nostats, seed=3, appends=4)
    add_file_without_stats(nostats)
    return {"plain": plain, "part": part, "nostats": nostats}


@pytest.mark.parametrize("name", ["plain", "part", "nostats"])
def test_random_predicates_match_reference(tables, name):
    path = tables[name]
    columns = list(TYPES) + (["p"] if name == "part" else [])
    snap = Table.for_path(path, engine=TorchEngine("cpu")).latest_snapshot()
    rng = np.random.default_rng({"plain": 11, "part": 12, "nostats": 13}[name])
    n_skipped = n_pruned = 0
    for i in range(N_PREDICATES):
        spec = random_spec(rng, columns)
        sc = snap.scan(filter=build(spec, PE))
        got = (sorted(sc.file_paths()), sc.partition_pruned,
               sc.skipped_by_stats)
        assert got == _ref_scan(path, spec), (i, spec)
        n_skipped += sc.skipped_by_stats
        n_pruned += sc.partition_pruned
    assert n_skipped > 0  # the predicates do skip
    if name == "part":
        assert n_pruned > 0


@pytest.mark.parametrize("spec", [
    ("cmp", ">=", "long", 400, False),
    ("and", ("cmp", "=", "p", "p1", False), ("cmp", "<", "long", 700, False)),
    ("or", ("cmp", "<", "long", 150, False), ("cmp", ">", "long", 1000,
                                                False)),
    ("in", "long", (5, 640, 1010)),
    ("null", "long"),
    ("not", ("cmp", "<", "long", 600, False)),
    ("cmp", ">", "string", "s00900", False),
    ("cmp", "<", "date", "2020-02-15", False),
])
def test_fixed_predicates_match_reference(tables, spec):
    for name in ("plain", "part", "nostats"):
        path = tables[name]
        if name != "part" and "'p'" in repr(spec):
            continue
        snap = Table.for_path(path, engine=TorchEngine("cpu")) \
            .latest_snapshot()
        sc = snap.scan(filter=build(spec, PE))
        assert (sorted(sc.file_paths()), sc.partition_pruned,
                sc.skipped_by_stats) == _ref_scan(path, spec), (name, spec)


def test_unfiltered_scan_and_files(tables):
    snap = Table.for_path(tables["plain"],
                          engine=TorchEngine("cpu")).latest_snapshot()
    sc = snap.scan()
    assert sc.file_paths() == [a.path for a in snap.state.add_files]
    assert sc.files() == snap.state.add_files
    assert (sc.partition_pruned, sc.skipped_by_stats) == (0, 0)
    b = snap.scan_builder().with_filter(PE.col("long") >= 600) \
        .with_filter(PE.col("long") < 900).build()
    assert sorted(b.file_paths()) == _ref_scan(
        tables["plain"], ("and", ("cmp", ">=", "long", 600, False),
                          ("cmp", "<", "long", 900, False)))[0]


def _counts():
    c = obs.counters()
    return {k: c.get(k, 0) for k in ("scan.stats_index_builds",
                                     "scan.stats_index_reuses",
                                     "scan.device_plans")}


def test_index_reuse_rebuild_and_update(tmp_path):
    path = str(tmp_path / "t")
    write_typed_table(path, seed=5, appends=4)
    table = Table.for_path(path, engine=TorchEngine("cpu"))
    snap = table.latest_snapshot()
    pred = ("cmp", ">=", "long", 450, False)
    obs.reset()
    first = sorted(snap.scan(filter=build(pred, PE)).file_paths())
    second = sorted(snap.scan(filter=build(pred, PE)).file_paths())
    assert first == second == _ref_scan(path, pred)[0]
    assert _counts() == {"scan.stats_index_builds": 1,
                         "scan.stats_index_reuses": 1,
                         "scan.device_plans": 2}

    # new files: the advanced state's index is rebuilt on its next scan
    dta.write_table(path, typed_batch(np.random.default_rng(9), 30, 460),
                    engine=HostEngine())
    adv = table.update()
    assert adv is not snap and adv.state.version == snap.version + 1
    assert snap.state.stats_index is None  # released by the advance
    obs.reset()
    got = sorted(adv.scan(filter=build(pred, PE)).file_paths())
    cold = Table.for_path(path, engine=TorchEngine("cpu")).latest_snapshot()
    assert got == sorted(cold.scan(filter=build(pred, PE)).file_paths()) \
        == _ref_scan(path, pred)[0]
    assert _counts()["scan.stats_index_builds"] == 2  # advanced + cold

    # a commit without file actions: the index moves to the new state
    obs.reset()
    adv.scan(filter=build(pred, PE)).file_paths()
    assert _counts()["scan.stats_index_reuses"] == 1
    log = os.path.join(path, "_delta_log")
    with open(os.path.join(log, f"{adv.version + 1:020d}.json"), "w") as f:
        f.write(json.dumps({"commitInfo": {"operation": "NOOP"}}) + "\n")
    adv2 = table.update()
    assert adv2.version == adv.version + 1
    obs.reset()
    assert sorted(adv2.scan(filter=build(pred, PE)).file_paths()) == got
    assert _counts() == {"scan.stats_index_builds": 0,
                         "scan.stats_index_reuses": 1,
                         "scan.device_plans": 1}


def test_checkpointed_log_scan_matches_reference(tmp_path):
    """A synthetic checkpoint-plus-tail log (stats on x): the index is
    built from the checkpoint's and the tail's stats strings."""
    from delta_tpu_torch.utils.synth import synth_delta_log

    path = str(tmp_path / "synth")
    synth_delta_log(path, 40, 20, seed=4, checkpoint_version=30,
                    now_ms=7 * 86_400_000)
    snap = Table.for_path(path, engine=TorchEngine("cpu")).latest_snapshot()
    for spec in [("cmp", "<", "x", 120_000, False),
                 ("or", ("cmp", "<", "x", 50_000, False),
                  ("cmp", ">", "x", 600_000, False)),
                 ("in", "x", tuple(range(100_000, 900_000, 50_000))),
                 ("null", "x"),
                 ("not", ("cmp", ">=", "x", 300_500, False))]:
        sc = snap.scan(filter=build(spec, PE))
        assert (sorted(sc.file_paths()), sc.partition_pruned,
                sc.skipped_by_stats) == _ref_scan(path, spec), spec

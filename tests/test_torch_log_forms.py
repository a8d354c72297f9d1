"""The log forms of a later Delta: V2 checkpoints with sidecars,
`stats_parsed`, compacted deltas, part reuse and metadata cleanup.

`delta_tpu_torch` (TorchEngine("cpu")) against `delta_tpu` (HostEngine) on
the same bytes, both ways:

- reference-written V2 checkpoints (Parquet top level, multi-sidecar,
  rewritten with part reuse) and struct-only checkpoints
  (`writeStatsAsStruct=true`, `writeStatsAsJson=false`) over every type
  the port reads (NaN, ±Infinity, null minima, dates, timestamps), and
  compacted deltas, each loaded by the port to the reference's state, add
  stats strings equal byte for byte;
- port-written V2 and struct-only checkpoints: the same rows as the
  reference's (pyarrow, sorted) and loaded by the reference to the port's
  state;
- V2 part reuse: the same parts reused after the same appends; a torn top
  level deletes only the fresh sidecars;
- `cleanup_expired_logs` and `write_compacted_delta` of both packages on
  copies under one fixed clock: the same files deleted, the same bytes;
- `snapshot_at` inside and past a compacted range, history over it, a
  vanished sidecar, a ZSTD and an LZ4 sidecar, and a filtered scan over a
  struct-only checkpoint.
"""

import glob
import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
import delta_tpu.expressions.tree as RE
from delta_tpu.config import settings as ref_settings
from delta_tpu.engine.host import HostEngine
from delta_tpu.log import cleanup as ref_cleanup
from delta_tpu.log.checkpointer import write_checkpoint as ref_write
from delta_tpu.log.last_checkpoint import read_last_checkpoint as ref_hint
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.config import settings
from delta_tpu_torch.errors import UnsupportedLogError
from delta_tpu_torch.log import checkpointer, cleanup
from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint
from delta_tpu_torch.write import ckpt_pipeline
from test_torch_checkpoint import assert_matches_reference
from test_torch_page_decode import _typed
from torch_scan_helpers import build, typed_batch, write_typed_table

CPU = TorchEngine("cpu")
STRUCT_ONLY = {"delta.checkpoint.writeStatsAsStruct": "true",
               "delta.checkpoint.writeStatsAsJson": "false"}
DAY_MS = 86_400_000


@pytest.fixture(autouse=True)
def _part_size():
    old = settings.checkpoint_part_size, ref_settings.checkpoint_part_size
    clear_parse_cache()
    yield
    settings.checkpoint_part_size, ref_settings.checkpoint_part_size = old
    clear_parse_cache()


def _ref_snap(path):
    clear_parse_cache()
    return RefTable.for_path(path, HostEngine()).latest_snapshot()


def _load(path):
    return Table.for_path(path, engine=CPU).latest_snapshot().state


def _ref_stats(path):
    at = _ref_snap(path).state.add_files_table
    return sorted(zip(at.column("path").to_pylist(),
                      at.column("stats").to_pylist()))


def _port_stats(state):
    return sorted((a.path, a.stats) for a in state.add_files)


def _special_table(path, properties, with_dates=True, nonfinite=False):
    """Appends of every type and a column null in every row (its minima
    and maxima are null); with `nonfinite`, a double column holding NaN
    and ±Infinity (whose stats the collector writes as the strings "NaN",
    "Infinity", so that neither Arrow parse of the stats succeeds and
    both packages write no stats_parsed)."""
    rng = np.random.default_rng(5)
    for i in range(4):
        b = typed_batch(rng, 12, 100 * i)
        n = b.num_rows
        d = np.linspace(-1, 1, n)
        if nonfinite and i == 1:
            d[3] = np.nan
        if nonfinite and i == 2:
            d[0], d[1] = np.inf, -np.inf
        b = b.append_column("special", pa.array(d, pa.float64()))
        b = b.append_column("empty", pa.array([None] * n, pa.int64()))
        if not with_dates:
            b = b.drop_columns(["date", "timestamp"])
        dta.write_table(path, b, engine=HostEngine(), properties=properties)


def _rows(path):
    """Every checkpoint row of the log's checkpoints and sidecars, by
    root, pyarrow's values (sorted reprs)."""
    out = {}
    log = os.path.join(path, "_delta_log")
    files = sorted(glob.glob(os.path.join(log, "*.checkpoint*.parquet"))
                   + glob.glob(os.path.join(log, "_sidecars", "*.parquet")))
    for p in files:
        t = pq.read_table(p)
        for root in t.column_names:
            if root in ("checkpointMetadata", "sidecar"):
                continue  # names and sizes differ by design
            typ = t.schema.field(root).type
            out.setdefault(root, []).extend(
                repr(_typed(v, typ)) for v in t.column(root).to_pylist()
                if v is not None)
    return {k: sorted(v) for k, v in out.items()}


def _copies(tmp_path, make):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    make(a)
    shutil.copytree(a, b)
    return a, b


# ----------------------------------------------------- the port reads --

@pytest.mark.parametrize("part_size", [None, 2])
def test_reference_v2_checkpoint_loads(tmp_path, part_size):
    path = str(tmp_path / "t")
    write_typed_table(path, seed=11, appends=6, rows=10)
    ref_settings.checkpoint_part_size = part_size
    ref_write(HostEngine(), _ref_snap(path), policy="v2")
    n_sidecars = len(os.listdir(os.path.join(path, "_delta_log",
                                             "_sidecars")))
    assert n_sidecars == (1 if part_size is None else 3)
    obs.reset()
    got = _load(path)
    assert obs.counters()["decode.device_parts"] == n_sidecars
    assert obs.counters()["decode.device_fallbacks"] == 0
    assert obs.counters()["decode.handoff_launches"] == 1  # at the head
    assert got.file_actions.version.min() == 5
    assert_matches_reference(path, got)
    assert _port_stats(got) == _ref_stats(path)


def test_reference_v2_rewrite_with_reuse_and_a_tail(tmp_path):
    path = str(tmp_path / "t")
    write_typed_table(path, seed=12, appends=5, rows=8)
    ref_settings.checkpoint_part_size = 2
    ref_write(HostEngine(), _ref_snap(path), policy="v2")
    dta.write_table(path, typed_batch(np.random.default_rng(1), 5, 900),
                    engine=HostEngine())
    log = os.path.join(path, "_delta_log")
    ref_write(HostEngine(), _ref_snap(path), policy="v2",
              prev_info=ref_hint(HostEngine().fs, log))
    dta.write_table(path, typed_batch(np.random.default_rng(2), 5, 950),
                    engine=HostEngine())
    obs.reset()
    got = _load(path)
    assert obs.counters()["decode.handoff_launches"] == 0  # a tail commit
    assert obs.counters()["decode.device_parts"] == 3
    assert_matches_reference(path, got)
    # the small-only read takes the top level alone
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    obs.reset()
    assert snap.metadata.id == _ref_snap(path).metadata.id
    assert obs.counters().get("decode.device_parts", 0) == 0


@pytest.mark.parametrize("with_dates,nonfinite", [
    (True, False), (False, False), (True, True)])
def test_reference_struct_only_checkpoint_loads(tmp_path, with_dates,
                                                nonfinite):
    """With a date column the reference's explicit parse fails (Arrow
    reads no date from a string) and the inferred types are written; the
    stats strings re-serialized from either must be the reference's. With
    non-finite stats nothing parses and the adds have no stats."""
    path = str(tmp_path / "t")
    _special_table(path, STRUCT_ONLY, with_dates, nonfinite)
    RefTable.for_path(path, HostEngine()).checkpoint()
    obs.reset()
    got = _load(path)
    assert obs.counters()["decode.device_fallbacks"] == 0
    assert_matches_reference(path, got)
    want = _ref_stats(path)
    assert _port_stats(got) == want
    assert all((s is None) == nonfinite for _, s in want)
    # the scan's stats index parses the same strings
    spec = ("cmp", "<", "long", 150, False)
    ref_files = sorted(_ref_snap(path).scan(filter=build(spec, RE))
                       .file_paths())
    port_files = sorted(Table.for_path(path, engine=CPU).latest_snapshot()
                        .scan(filter=build(spec, PE)).file_paths())
    assert port_files == ref_files
    assert len(port_files) == (4 if nonfinite else 2)


def test_bare_nan_in_stats_parsed_is_a_bare_token(tmp_path):
    """A double stat written as the bare token NaN parses as a double, so
    stats_parsed holds a NaN and its re-serialized string reads `NaN`,
    not the string "NaN" the stats collector writes."""
    path = str(tmp_path / "t")
    dta.write_table(path, pa.table({"d": pa.array([1.0, 2.0])}),
                    engine=HostEngine(), properties=STRUCT_ONLY)
    log = os.path.join(path, "_delta_log")
    add = {"path": "x.parquet", "partitionValues": {}, "size": 1,
           "modificationTime": 1, "dataChange": True,
           "stats": '{"numRecords":2,"minValues":{"d":NaN},'
                    '"maxValues":{"d":Infinity},"nullCount":{"d":0}}'}
    with open(os.path.join(log, f"{1:020d}.json"), "w") as f:
        f.write(json.dumps({"add": add}) + "\n")
    RefTable.for_path(path, HostEngine()).checkpoint()
    want = _ref_stats(path)
    assert any(s and '"d":NaN' in s for _, s in want)
    assert _port_stats(_load(path)) == want


def test_compacted_deltas_and_snapshot_at(tmp_path):
    path = str(tmp_path / "t")
    write_typed_table(path, seed=13, appends=7, rows=6)
    t = RefTable.for_path(path, HostEngine())
    ref_cleanup.write_compacted_delta(t, 1, 3)
    ref_cleanup.write_compacted_delta(t, 4, 6)
    obs.reset()
    got = _load(path)
    seg = Table.for_path(path, engine=CPU).latest_snapshot().log_segment
    assert len(seg.compacted_deltas) == 2
    # the ranges take the place of the commits they cover
    listed = sorted(glob.glob(os.path.join(seg.log_path, "?" * 20 + ".json")))
    assert len(listed) == 7 and [d.path for d in seg.deltas] == listed[:1]
    assert obs.counters()["parse.device_windows"] >= 1  # through K1's route
    assert_matches_reference(path, got)
    for v in range(7):
        clear_parse_cache()
        ref = RefTable.for_path(path, HostEngine()).snapshot_at(v)
        port = Table.for_path(path, engine=CPU).snapshot_at(v)
        assert port.version == ref.version == v
        assert len(port.log_segment.compacted_deltas) == len(
            ref.log_segment.compacted_deltas)
        assert port.timestamp_ms == ref.timestamp_ms
        assert (sorted(a.path for a in port.state.add_files)
                == sorted(ref.state.add_files_table.column("path")
                          .to_pylist()))
    hist_r = [(c.version, c.timestamp_ms) for c in RefTable.for_path(
        path, HostEngine()).history()]
    hist_p = [(c.version, c.timestamp_ms) for c in Table.for_path(
        path, engine=CPU).history()]
    assert hist_p == hist_r


def test_vanished_sidecar_takes_the_ladder(tmp_path):
    path = str(tmp_path / "t")
    write_typed_table(path, seed=14, appends=4, rows=6)
    RefTable.for_path(path, HostEngine()).checkpoint(version=1)
    ref_settings.checkpoint_part_size = 2
    ref_write(HostEngine(), _ref_snap(path), policy="v2")
    side = sorted(glob.glob(os.path.join(path, "_delta_log", "_sidecars",
                                         "*.parquet")))
    os.remove(side[0])
    obs.reset()
    got = _load(path)
    assert obs.counters()["snapshot.checkpoint_fallbacks"] == 1
    assert got.file_actions.version.min() == 1  # the classic checkpoint
    assert_matches_reference(path, got)


def test_zstd_sidecar_is_refused(tmp_path):
    """Once refused, a ZSTD sidecar now loads as the reference loads it;
    an LZ4 one, a codec the port does not read, is still refused."""
    path = str(tmp_path / "t")
    write_typed_table(path, seed=15, appends=3, rows=6)
    ref_write(HostEngine(), _ref_snap(path), policy="v2")
    side = glob.glob(os.path.join(path, "_delta_log", "_sidecars",
                                  "*.parquet"))[0]
    tbl = pq.read_table(side)
    pq.write_table(tbl, side, compression="zstd")
    assert_matches_reference(path, _load(path))
    pq.write_table(tbl, side, compression="lz4")
    with pytest.raises(UnsupportedLogError, match="LZ4"):
        _load(path)


# ---------------------------------------------------- the port writes --

def _write_both(a, b, part_size, policy=None):
    ref_settings.checkpoint_part_size = part_size
    settings.checkpoint_part_size = part_size
    ri = ref_write(HostEngine(), _ref_snap(a), policy=policy)
    pi = checkpointer.write_checkpoint(
        CPU, Table.for_path(b, engine=CPU).latest_snapshot(), policy=policy)
    return ri, pi


@pytest.mark.parametrize("part_size", [None, 5])
def test_port_v2_checkpoint_matches_reference(tmp_path, part_size):
    a, b = _copies(tmp_path, lambda p: write_typed_table(
        p, seed=16, appends=6, rows=8))
    ri, pi = _write_both(a, b, part_size, policy="v2")
    assert _rows(a) == _rows(b)
    assert (pi.version, pi.size, pi.numOfAddFiles, pi.parts) == (
        ri.version, ri.size, ri.numOfAddFiles, ri.parts)
    assert len(pi.partManifest["parts"]) == len(ri.partManifest["parts"])
    assert pi.tag.endswith(".parquet") and ".checkpoint." in pi.tag
    mine = _load(b)
    assert mine.file_actions.version.min() == pi.version
    assert_matches_reference(b, mine)


@pytest.mark.parametrize("with_dates,nonfinite", [
    (True, False), (False, False), (True, True)])
@pytest.mark.parametrize("policy", [None, "v2"])
def test_port_struct_only_checkpoint_matches_reference(tmp_path, with_dates,
                                                       nonfinite, policy):
    a, b = _copies(tmp_path, lambda p: _special_table(p, STRUCT_ONLY,
                                                      with_dates, nonfinite))
    _write_both(a, b, 3, policy=policy)
    ra, rb = _rows(a), _rows(b)
    assert ra == rb
    assert all(("stats_parsed" in r) != nonfinite for r in rb["add"])
    mine = _load(b)
    assert_matches_reference(b, mine)
    assert _port_stats(mine) == _ref_stats(b) == _ref_stats(a)


def test_port_stats_struct_beside_json(tmp_path):
    props = {"delta.checkpoint.writeStatsAsStruct": "true"}
    a, b = _copies(tmp_path, lambda p: _special_table(p, props))
    _write_both(a, b, None)
    assert _rows(a) == _rows(b)
    assert_matches_reference(b, _load(b))


def _reuse_run(path, write, hint, append, reused, written):
    write(path, None)
    side = os.path.join(path, "_delta_log", "_sidecars")
    first = set(os.listdir(side))
    append(path)
    r0, w0 = reused(), written()
    info = write(path, hint(path))
    names = {e["name"] for e in info.partManifest["parts"]}
    return (len(first), reused() - r0, written() - w0, len(names & first),
            len(os.listdir(side)))


def test_v2_part_reuse_matches_reference(tmp_path):
    # 8 files in sidecars of 3, then 2 appends (below the hooks'
    # checkpoint at version 10, whose hint would carry no manifest)
    a, b = _copies(tmp_path, lambda p: write_typed_table(
        p, seed=17, appends=8, rows=5))
    ref_settings.checkpoint_part_size = 3
    settings.checkpoint_part_size = 3
    from delta_tpu.log.checkpointer import _PARTS_REUSED, _PARTS_WRITTEN

    def append(p):
        for s in (3, 4):
            dta.write_table(p, typed_batch(np.random.default_rng(s), 4,
                                           2000 + s), engine=HostEngine())

    ref = _reuse_run(
        a, lambda p, prev: ref_write(HostEngine(), _ref_snap(p), policy="v2",
                                     prev_info=prev),
        lambda p: ref_hint(HostEngine().fs, os.path.join(p, "_delta_log")),
        append, lambda: _PARTS_REUSED.value, lambda: _PARTS_WRITTEN.value)
    port = _reuse_run(
        b, lambda p, prev: checkpointer.write_checkpoint(
            CPU, Table.for_path(p, engine=CPU).latest_snapshot(),
            policy="v2", prev_info=prev),
        lambda p: read_last_checkpoint(CPU.fs, os.path.join(p, "_delta_log")),
        append, obs.counter("checkpoint.parts_reused").read,
        obs.counter("checkpoint.parts_written").read)
    # sidecars of the first write, reused, written (the port also counts
    # its top level), re-referenced, sidecar files after the second
    assert port[:2] == ref[:2] and port[3:] == ref[3:]
    assert port[2] == ref[2] + 1
    assert port[1] >= 2
    assert_matches_reference(b, _load(b))


def test_multipart_part_reuse_copies_parts(tmp_path):
    a, b = _copies(tmp_path, lambda p: write_typed_table(
        p, seed=18, appends=6, rows=5))
    settings.checkpoint_part_size = 4
    t = Table.for_path(b, engine=CPU)
    t.checkpoint()
    dta.write_table(b, typed_batch(np.random.default_rng(3), 4, 3000),
                    engine=HostEngine())
    r0 = obs.counter("checkpoint.parts_reused").read()
    t.checkpoint()
    assert obs.counter("checkpoint.parts_reused").read() - r0 >= 1
    hint = read_last_checkpoint(CPU.fs, os.path.join(b, "_delta_log"))
    assert hint.parts and len(hint.partManifest["parts"]) == hint.parts - 1
    assert_matches_reference(b, _load(b))


def test_torn_v2_top_level_deletes_only_fresh_sidecars(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "t")
    write_typed_table(path, seed=19, appends=5, rows=5)
    settings.checkpoint_part_size = 3
    snap = Table.for_path(path, engine=CPU).latest_snapshot()
    checkpointer.write_checkpoint(CPU, snap, policy="v2")
    log = os.path.join(path, "_delta_log")
    side = os.path.join(log, "_sidecars")
    first = set(os.listdir(side))
    hint = read_last_checkpoint(CPU.fs, log)
    dta.write_table(path, typed_batch(np.random.default_rng(9), 4, 4000),
                    engine=HostEngine())
    real = CPU.fs.write

    def failing(p, data, overwrite=False):
        if ".checkpoint." in p and p.endswith(".parquet"):
            raise OSError("disk full")
        return real(p, data, overwrite=overwrite)

    monkeypatch.setattr(CPU.fs, "write", failing)
    with pytest.raises(ckpt_pipeline.CheckpointWriteError):
        checkpointer.write_checkpoint(
            CPU, Table.for_path(path, engine=CPU).latest_snapshot(),
            policy="v2", prev_info=hint)
    monkeypatch.undo()
    assert set(os.listdir(side)) == first  # reused ones kept, fresh gone
    assert read_last_checkpoint(CPU.fs, log).tag == hint.tag
    assert_matches_reference(path, _load(path))


# ---------------------------------------------- cleanup and compaction --

def _aged_log(path):
    """Ten commits a day apart with checkpoints at 3 and 6 (mtimes set),
    a V2 checkpoint at 8 with sidecars."""
    for i in range(10):
        dta.write_table(path, pa.table({"k": pa.array([i, i + 1])}),
                        engine=HostEngine())
        if i in (3, 6):
            RefTable.for_path(path, HostEngine()).checkpoint()
        if i == 8:
            ref_write(HostEngine(), _ref_snap(path), policy="v2")
    log = os.path.join(path, "_delta_log")
    for name in os.listdir(log):
        p = os.path.join(log, name)
        if os.path.isfile(p) and name[:20].isdigit():
            v = int(name[:20])
            os.utime(p, (v * DAY_MS / 1000, v * DAY_MS / 1000))


@pytest.mark.parametrize("retention_ms,now_ms", [
    (None, 40 * DAY_MS), (None, 33 * DAY_MS), (3 * DAY_MS, 9 * DAY_MS),
    (0, 100 * DAY_MS)])
def test_cleanup_matches_reference(tmp_path, retention_ms, now_ms):
    a, b = _copies(tmp_path, _aged_log)
    ref = ref_cleanup.cleanup_expired_logs(
        RefTable.for_path(a, HostEngine()), retention_ms=retention_ms,
        now_ms=now_ms)
    port = cleanup.cleanup_expired_logs(
        Table.for_path(b, engine=CPU), retention_ms=retention_ms,
        now_ms=now_ms)
    name = os.path.basename
    assert [name(p) for p in port] == [name(p) for p in ref]
    assert sorted(os.listdir(os.path.join(b, "_delta_log", "_sidecars"))) \
        == sorted(os.listdir(os.path.join(a, "_delta_log", "_sidecars")))
    assert_matches_reference(b, _load(b))
    if port:
        gone = min(int(name(p)[:20]) for p in port)
        with pytest.raises(Exception) as ep:
            Table.for_path(b, engine=CPU).snapshot_at(gone).state
        with pytest.raises(Exception) as er:
            clear_parse_cache()
            RefTable.for_path(a, HostEngine()).snapshot_at(gone).state
        assert type(ep.value).__name__ == type(er.value).__name__
        assert ep.value.error_class == er.value.error_class


def test_write_compacted_delta_matches_reference(tmp_path):
    def make(p):
        write_typed_table(p, seed=20, appends=5, rows=4)
        t = RefTable.for_path(p, HostEngine())
        from delta_tpu.commands.dml import delete

        delete(t, predicate=RE.col("long") < RE.lit(300))
        dta.write_table(p, typed_batch(np.random.default_rng(4), 4, 5000),
                        engine=HostEngine())

    a, b = _copies(tmp_path, make)
    ra = ref_cleanup.write_compacted_delta(RefTable.for_path(a, HostEngine()),
                                           2, 6)
    pb = cleanup.write_compacted_delta(Table.for_path(b, engine=CPU), 2, 6)
    assert os.path.basename(ra) == os.path.basename(pb)
    with open(ra, "rb") as f1, open(pb, "rb") as f2:
        assert f1.read() == f2.read()
    assert_matches_reference(b, _load(b))
    with pytest.raises(Exception) as e:
        cleanup.write_compacted_delta(Table.for_path(b, engine=CPU), 3, 3)
    assert getattr(e.value, "error_class", "") == \
        "DELTA_COMPACTION_RANGE_TOO_SMALL"


@pytest.mark.parametrize("form", ["v2", "compacted"])
def test_update_over_v2_and_compacted_segments_advances(tmp_path, form):
    """New commits on a segment anchored by a V2 checkpoint or holding
    compacted deltas advance it (the delta alone is read) to the state a
    cold load builds."""
    path = str(tmp_path / "t")
    write_typed_table(path, seed=21, appends=3, rows=4)
    if form == "v2":
        ref_write(HostEngine(), _ref_snap(path), policy="v2")
    else:
        ref_cleanup.write_compacted_delta(
            RefTable.for_path(path, HostEngine()), 1, 2)
    t = Table.for_path(path, engine=CPU)
    snap = t.latest_snapshot()
    seg = snap.log_segment
    assert (seg.is_v2 if form == "v2" else len(seg.compacted_deltas) == 1)
    assert snap.state.num_files == 3
    assert snap.update() is snap  # nothing new: one listing
    for k in range(2):
        dta.write_table(path, typed_batch(np.random.default_rng(5 + k), 4,
                                          6000 + k), engine=HostEngine())
    obs.reset()
    new = snap.update()
    counts = obs.counters()
    assert counts["replay.advances"] == 1
    assert counts.get("snapshot.update_fallbacks", 0) == 0
    assert new.version == 4 and new.log_segment.compacted_deltas == \
        seg.compacted_deltas
    assert_matches_reference(path, new.state)
    assert _port_stats(new.state) == _port_stats(_load(path))

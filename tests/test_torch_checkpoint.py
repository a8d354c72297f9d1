"""Whole-slice parity for checkpointed logs, and the synthetic writer.

`delta_tpu_torch.Table.for_path(p, engine=TorchEngine("cpu"))` against
`delta_tpu.Table.for_path(p, engine=HostEngine())` on logs anchored by a
classic checkpoint, single- or multi-part: the golden fixtures, logs
checkpointed by the JAX package's checkpointer with tail commits and at
their head (where the device handoff must run), and the port's own
synthetic checkpoints. Then the synthetic writer against the JAX
checkpointer's rows and pyarrow's encodings. Everything is exact.
"""

import glob
import io
import json
import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from delta_tpu.engine.host import HostEngine
from delta_tpu.log import checkpointer as ref_ckpt
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.errors import LogCorruptedError, UnsupportedLogError
from delta_tpu_torch.log.segment import build_log_segment
from delta_tpu_torch.storage.local import LocalLogStore
from delta_tpu_torch.utils import parquet_write
from delta_tpu_torch.utils.synth import (
    RETENTION_MS,
    rows_block,
    synth_delta_log,
    write_checkpoint,
)
from test_torch_page_decode import _typed, feature_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEEK_MS = 7 * 86_400_000


def _load(path):
    return Table.for_path(path, engine=TorchEngine("cpu")) \
        .latest_snapshot().state


def _adds(files):
    return sorted((a.path, a.size, a.modificationTime, a.dataChange, a.stats,
                   a.partitionValues, a.tags, a.dv_unique_id,
                   a.deletionVector.to_dict() if a.deletionVector else None,
                   a.baseRowId, a.defaultRowCommitVersion,
                   a.clusteringProvider) for a in files)


def _tombs(files):
    return sorted((r.path, r.deletionTimestamp, r.dataChange, r.size,
                   r.extendedFileMetadata, r.partitionValues, r.tags,
                   r.dv_unique_id, r.stats) for r in files)


def assert_matches_reference(path, got):
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
    assert _adds(got.add_files) == _adds(ref.add_files())
    assert _tombs(got.tombstones) == _tombs(ref.tombstones())
    assert not bool((got.live_mask & got.tombstone_mask).any())
    return ref


@pytest.mark.parametrize("fixture", ["basic_checkpoint",
                                     "multipart_checkpoint", "kitchen_sink"])
def test_golden_checkpointed_logs_match_reference(fixture):
    path = os.path.join(REPO, "tests", "golden_fixtures", fixture)
    obs.reset()
    got = _load(path)
    counts = obs.counters()
    seg = build_log_segment(LocalLogStore(), os.path.join(path, "_delta_log"))
    assert seg.checkpoint_version == 1 and seg.checkpoints
    assert counts["decode.device_parts"] == len(seg.checkpoints)
    assert counts["decode.device_fallbacks"] == 0
    assert_matches_reference(path, got)


@pytest.mark.parametrize("fixture", ["v2_sidecars", "compacted"])
def test_v2_and_compacted_logs_are_refused(fixture):
    """These forms were refused until the port read them; the golden V2
    checkpoint (a JSON top level naming two sidecars) and the compacted
    delta now load to their hand-written `expected.json` and to the
    reference's state."""
    path = os.path.join(REPO, "tests", "golden_fixtures", fixture)
    with open(os.path.join(path, "expected.json")) as f:
        want = json.load(f)
    obs.reset()
    got = _load(path)
    live = sorted(f"{a.path}|{a.dv_unique_id or ''}" for a in got.add_files)
    dead = sorted(f"{r.path}|{r.dv_unique_id or ''}" for r in got.tombstones)
    assert (got.version, got.num_files, got.size_in_bytes, live, dead,
            got.metadata.id) == (want["version"], want["num_live"],
                                 want["live_bytes"], want["live_keys"],
                                 want["tombstone_keys"],
                                 want["metadata_id"])
    assert {k: v for k, v in got.protocol.to_dict().items()
            if v is not None} == want["protocol"]
    seg = build_log_segment(LocalLogStore(), os.path.join(path, "_delta_log"))
    if fixture == "v2_sidecars":
        assert obs.counters()["decode.device_parts"] == 2  # one per sidecar
    else:
        assert [os.path.basename(f.path) for f in seg.compacted_deltas] == [
            f"{1:020d}.{2:020d}.compacted.json"]
    assert_matches_reference(path, got)


@pytest.mark.parametrize("checkpoint_version", [2, 4])
def test_feature_log_checkpointed_by_the_jax_package(tmp_path,
                                                     checkpoint_version):
    """Deletion vectors, partition values, tags, txn, domainMetadata,
    feature lists: with tail commits (v2) and at the head (v4)."""
    path = feature_log(str(tmp_path), checkpoint_version)
    obs.reset()
    got = _load(path)
    assert obs.counters()["decode.device_fallbacks"] == 0
    assert obs.counters()["decode.device_parts"] >= 3
    ref = assert_matches_reference(path, got)
    assert {a.dv_unique_id for a in got.add_files} == {
        a.dv_unique_id for a in ref.add_files()}
    assert got.set_transactions["app"].version == 3


def test_bench_log_checkpointed_by_the_jax_package_with_tail(tmp_path):
    from delta_tpu.config import settings

    synth_delta_log(str(tmp_path), 40, 20, seed=3)
    old = settings.checkpoint_part_size
    settings.checkpoint_part_size = 90
    try:
        RefTable.for_path(str(tmp_path), engine=HostEngine()).checkpoint(
            version=29)
    finally:
        settings.checkpoint_part_size = old
    obs.reset()
    got = _load(str(tmp_path))
    counts = obs.counters()
    assert counts["decode.device_parts"] > 1
    assert counts["decode.device_fallbacks"] == 0
    assert counts["parse.device_windows"] == 1
    assert counts["decode.handoff_launches"] == 0  # tail commits: no handoff
    assert_matches_reference(str(tmp_path), got)
    assert got.phase_seconds.keys() >= {"ckpt_read", "ckpt_decode",
                                        "ckpt_host", "read", "parse",
                                        "codes", "replay"}


def test_checkpoint_at_head_takes_the_handoff(tmp_path):
    synth_delta_log(str(tmp_path), 30, 20, seed=4)
    RefTable.for_path(str(tmp_path), engine=HostEngine()).checkpoint()
    obs.reset()
    got = _load(str(tmp_path))
    assert obs.counters()["decode.handoff_launches"] == 1
    assert obs.counters()["parse.device_windows"] == 0
    assert_matches_reference(str(tmp_path), got)


@pytest.mark.parametrize("cp", [0, 24, 29])
def test_synthetic_checkpoint_loads_to_the_generator_truth(tmp_path, cp):
    truth = synth_delta_log(str(tmp_path), 30, 40, seed=cp,
                            checkpoint_version=cp, now_ms=WEEK_MS)
    obs.reset()
    got = _load(str(tmp_path))
    counts = obs.counters()
    assert counts["decode.device_parts"] == truth.checkpoint.get("parts", 1)
    assert counts["decode.handoff_launches"] == (cp == 29)
    assert sorted(a.path for a in got.add_files) == truth.live_paths
    assert got.size_in_bytes == truth.size_in_bytes
    assert int(got.tombstone_mask.sum()) == truth.num_tombstones
    assert_matches_reference(str(tmp_path), got)


def test_overflowing_path_dictionary_falls_to_plain(tmp_path, monkeypatch):
    monkeypatch.setattr(parquet_write, "DICT_LIMIT", 2048)
    monkeypatch.setattr(parquet_write, "PAGE_ENTRIES", 100)
    truth = synth_delta_log(str(tmp_path), 30, 40, seed=9,
                            checkpoint_version=29, now_ms=WEEK_MS)
    part = sorted(glob.glob(str(tmp_path / "_delta_log" / "*.parquet")))[1]
    md = pq.ParquetFile(part).metadata
    names = [md.schema.column(i).path for i in range(len(md.schema))]
    chunk = md.row_group(0).column(names.index("add.path"))
    assert chunk.dictionary_page_offset is not None
    obs.reset()
    got = _load(str(tmp_path))
    assert obs.counters()["decode.handoff_launches"] == 0  # keys dropped
    assert obs.counters()["decode.device_fallbacks"] == 0
    assert sorted(a.path for a in got.add_files) == truth.live_paths
    assert_matches_reference(str(tmp_path), got)


def test_missing_part_and_unsupported_codec(tmp_path):
    truth = synth_delta_log(str(tmp_path), 20, 20, seed=1,
                            checkpoint_version=19, now_ms=WEEK_MS)
    assert truth.checkpoint["parts"] > 2
    log = tmp_path / "_delta_log"
    parts = sorted(glob.glob(str(log / "*.parquet")))
    tbl = pq.read_table(parts[1])
    # a zstd part loads as the reference loads it, through the device plan
    pq.write_table(tbl, parts[1], compression="zstd")
    obs.reset()
    got = _load(str(tmp_path))
    assert obs.counters()["decode.device_parts"] == truth.checkpoint["parts"]
    assert obs.counters()["decode.device_fallbacks"] == 0
    assert_matches_reference(str(tmp_path), got)
    # an lz4 part: a codec the port does not read, refused by its name
    pq.write_table(tbl, parts[1], compression="lz4")
    with pytest.raises(UnsupportedLogError, match="LZ4"):
        _load(str(tmp_path))
    # a part that vanishes between LIST and read
    seg = build_log_segment(LocalLogStore(), str(log))
    os.remove(parts[1])
    from delta_tpu_torch.replay.columnar import columnarize_log_segment

    with pytest.raises(LogCorruptedError):
        columnarize_log_segment(TorchEngine("cpu"), seg)


@pytest.fixture(scope="module")
def two_part_log(tmp_path_factory):
    """A cell-2-shaped log at a small size: 200 commits of 20 file actions,
    a multi-part checkpoint by the JAX package's checkpointer at version
    190 (the small actions, then the file actions in two parts), then 9
    tail commits."""
    from delta_tpu.config import settings

    path = str(tmp_path_factory.mktemp("two_part") / "t")
    synth_delta_log(path, 200, 20, seed=11)
    ref = RefTable.for_path(path, engine=HostEngine())
    state = ref.snapshot_at(190).state
    old = settings.checkpoint_part_size
    settings.checkpoint_part_size = (state.num_files
                                     + len(state.tombstones())) // 2 + 1
    try:
        ref.checkpoint(version=190)
    finally:
        settings.checkpoint_part_size = old
    assert len(glob.glob(os.path.join(path, "_delta_log", "*.parquet"))) == 3
    return path


@pytest.mark.parametrize("form,kw,on_device", [
    ("zstd", {"compression": "zstd"}, True),
    ("zstd-19", {"compression": "zstd", "compression_level": 19}, True),
    ("gzip", {"compression": "gzip"}, True),
    ("v2", {"data_page_version": "2.0"}, False),
    ("v2-zstd", {"data_page_version": "2.0", "compression": "zstd"}, False),
])
def test_other_writers_checkpoint_parts_load_as_the_reference(
        tmp_path, two_part_log, form, kw, on_device):
    """Every part rewritten by pyarrow in another form: the state equals
    the reference's. ZSTD and GZIP parts decode through the device plan
    (K3 on the card), v2 pages on the host, one fallback per part, as the
    reference routes them."""
    import shutil

    path = str(tmp_path / form)
    shutil.copytree(two_part_log, path)
    parts = sorted(glob.glob(os.path.join(path, "_delta_log", "*.parquet")))
    for part in parts:
        pq.write_table(pq.read_table(part), part, **kw)
    from delta_tpu.replay.columnar import clear_parse_cache

    clear_parse_cache()
    obs.reset()
    got = _load(path)
    counts = obs.counters()
    assert counts["decode.device_parts"] == (3 if on_device else 0)
    assert counts["decode.device_fallbacks"] == (0 if on_device else 3)
    assert_matches_reference(path, got)


def test_segment_picks_the_newest_complete_checkpoint(tmp_path):
    synth_delta_log(str(tmp_path), 25, 20, seed=2, checkpoint_version=9,
                    now_ms=WEEK_MS)
    log = str(tmp_path / "_delta_log")
    RefTable.for_path(str(tmp_path), engine=HostEngine()).checkpoint(
        version=19)
    # an incomplete multi-part checkpoint at 21 is ignored
    with open(os.path.join(log, f"{21:020d}.checkpoint.{1:010d}."
                           f"{2:010d}.parquet"), "wb") as f:
        f.write(b"PAR1")
    seg = build_log_segment(LocalLogStore(), log)
    assert seg.checkpoint_version == 19 and seg.version == 24
    assert [os.path.basename(f.path)[:20] for f in seg.deltas] == [
        f"{v:020d}" for v in range(20, 25)]
    assert_matches_reference(str(tmp_path), _load(str(tmp_path)))
    # a gap after the checkpoint is a corrupt log
    os.remove(os.path.join(log, f"{22:020d}.json"))
    from delta_tpu_torch.errors import CorruptLogError

    with pytest.raises(CorruptLogError):
        build_log_segment(LocalLogStore(), log)


# ------------------------------------------------------------- writer --

def _ref_state(path):
    return RefTable.for_path(path, engine=HostEngine()).latest_snapshot() \
        .state


def _ref_checkpoint_table(state, now_ms):
    adds = state.add_files_table
    tombs = ref_ckpt._retained_tombstones(state, now_ms, RETENTION_MS)
    add_struct = ref_ckpt._file_struct_from_canonical(adds, is_add=True)
    rem_struct = ref_ckpt._file_struct_from_canonical(tombs, is_add=False)
    small = ref_ckpt._small_action_arrays(state)
    n = sum(len(a) for a in small if a is not None) + len(add_struct) \
        + len(rem_struct)
    return ref_ckpt._single_action_table(n, *small, add_struct, rem_struct)


def _port_blocks(ref_table):
    """Small-action and file-action Blocks holding the reference table's
    rows (maps as dicts), for the port's writer."""
    blocks = {}
    for root in ref_table.column_names:
        typ = ref_table.schema.field(root).type
        rows = [_typed(v, typ) for v in ref_table.column(root).to_pylist()]
        blocks[root] = rows_block(root, [r for r in rows if r is not None])
    return blocks


@pytest.mark.parametrize("which", ["bench", "features"])
def test_synthetic_writer_rows_equal_the_jax_checkpointer(tmp_path, which):
    src = str(tmp_path / "src")
    if which == "bench":
        synth_delta_log(src, 30, 20, seed=6)
    else:
        feature_log(src, 4)
    state = _ref_state(src)
    now_ms = WEEK_MS + 5
    want = _ref_checkpoint_table(state, now_ms)
    blocks = _port_blocks(want)
    out = str(tmp_path / "out" / "_delta_log")
    os.makedirs(out)
    # the writer applies the retention itself: hand it every tombstone
    tombs = _port_blocks(ref_ckpt._single_action_table(
        state.tombstones_table.num_rows, None, None, None, None, None,
        ref_ckpt._file_struct_from_canonical(state.tombstones_table,
                                             is_add=False)))["remove"]
    small = [blocks[r] for r in ("protocol", "metaData", "txn",
                                 "domainMetadata") if blocks[r].n]
    info = write_checkpoint(out, state.version, small, blocks["add"], tombs,
                            now_ms=now_ms)
    assert info["numOfAddFiles"] == state.num_files
    (part,) = glob.glob(os.path.join(out, "*.parquet"))
    got = pq.read_table(part)
    assert got.num_rows == want.num_rows
    for root in want.column_names:
        typ = want.schema.field(root).type
        g = [_typed(v, typ) for v in got.column(root).to_pylist()]
        w = [_typed(v, typ) for v in want.column(root).to_pylist()]
        assert sorted(map(repr, g)) == sorted(map(repr, w)), root
    assert json.loads(open(os.path.join(out, "_last_checkpoint")).read())[
        "version"] == state.version


def test_synthetic_writer_encodings_match_pyarrow(tmp_path, monkeypatch):
    """Per column, the set of encodings equals what pyarrow writes for
    the same table, also when the path dictionary overflows."""
    src = str(tmp_path / "src")
    synth_delta_log(src, 30, 20, seed=8)
    state = _ref_state(src)
    table = _ref_checkpoint_table(state, WEEK_MS)
    blocks = _port_blocks(table)
    for limit in (1 << 20, 1024):
        monkeypatch.setattr(parquet_write, "DICT_LIMIT", limit)
        out = str(tmp_path / f"out{limit}")
        os.makedirs(out)
        write_checkpoint(out, state.version,
                         [blocks["protocol"], blocks["metaData"]],
                         blocks["add"], blocks["remove"], now_ms=WEEK_MS)
        (part,) = glob.glob(os.path.join(out, "*.parquet"))
        sink = io.BytesIO()
        pq.write_table(table, sink, compression="snappy",
                       dictionary_pagesize_limit=limit)
        theirs = pq.ParquetFile(pa.BufferReader(sink.getvalue())).metadata
        ours = pq.ParquetFile(part).metadata
        t_cols = {theirs.schema.column(i).path: set(
            theirs.row_group(0).column(i).encodings)
            for i in range(len(theirs.schema))}
        o_cols = {ours.schema.column(i).path: set(
            ours.row_group(0).column(i).encodings)
            for i in range(len(ours.schema))}
        assert o_cols == t_cols, limit
        if limit == 1024:
            i = [ours.schema.column(k).path
                 for k in range(len(ours.schema))].index("add.path")
            assert ours.row_group(0).column(i).dictionary_page_offset


def test_retention_drops_old_tombstones(tmp_path):
    truth = synth_delta_log(str(tmp_path), 20, 20, seed=5,
                            checkpoint_version=19, now_ms=WEEK_MS + 10)
    parts = sorted(glob.glob(str(tmp_path / "_delta_log" / "*.parquet")))
    removes = [r for p in parts
               for r in pq.read_table(p).column("remove").to_pylist() if r]
    assert all(r["deletionTimestamp"] >= 10 for r in removes)
    assert 0 < len(removes) < truth.num_tombstones
    assert all(not r["dataChange"] for r in removes)

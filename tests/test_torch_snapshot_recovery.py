"""The snapshot's degradation ladder and `.crc` quarantine, held to the
reference.

Each case writes a table with the JAX package (`HostEngine`), damages it
as a crashed writer or a bad disk would, and loads it with both packages:
`delta_tpu_torch` on the CPU (plain versions of every kernel) against
`delta_tpu`. The port's counterparts of `tests/test_corruption_fallback.py`:
a torn tip commit serves the version before it; an unreadable checkpoint
rebuilds from an earlier one or the JSON log; a lying `.crc` is reseeded.
The ladder absorbs nothing else: typed refusals, kernel failures and a
vanished commit propagate.
"""

import ctypes
import io
import json
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from delta_tpu import obs as ref_obs
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import LogCorruptedError as RefLogCorruptedError
from delta_tpu.models.actions import AddFile as RefAddFile
from delta_tpu.models.schema import INTEGER, StructField, StructType
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.errors import (
    CorruptLogError,
    LogCorruptedError,
    TornCommitError,
    UnsupportedLogError,
)
from delta_tpu_torch.log import page_decode as port_plan
from delta_tpu_torch.log import parquet_host
from delta_tpu_torch.log.parquet_footer import (
    DecodeCorrupt,
    DecodeUnsupported,
    read_footer,
)
from delta_tpu_torch.models.actions import AddFile
from delta_tpu_torch.ops import cuda_build
from delta_tpu_torch.ops import page_decode as port_ops

_COUNTERS = ("snapshot.torn_commit_fallbacks",
             "snapshot.checkpoint_fallbacks", "snapshot.crc_quarantined")


def _ref_add(i, size):
    return RefAddFile(path=f"p{i}.parquet", partitionValues={}, size=size,
                      modificationTime=1000 + i, dataChange=True,
                      stats=json.dumps({"numRecords": i}))


def _ref_table(path, sizes):
    """A reference-written table: version k adds `p{k}.parquet` of
    `sizes[k]` bytes (version 0 creates the table with its first file).
    The reference's hooks write a `.crc` per version and a checkpoint at
    10."""
    t = RefTable.for_path(str(path), HostEngine())
    for i, size in enumerate(sizes):
        txn = (t.create_transaction_builder().with_schema(
            StructType([StructField("x", INTEGER)])).build() if i == 0
            else t.start_transaction())
        txn.add_file(_ref_add(i, size))
        txn.commit()
    return t


def _log(path, version, suffix="json"):
    return os.path.join(str(path), "_delta_log", f"{version:020d}.{suffix}")


def _ref_load(path):
    """(version, live paths, counters delta) of a cold reference load."""
    clear_parse_cache()
    before = {k: ref_obs.counter(k).value for k in _COUNTERS}
    snap = RefTable.for_path(str(path), HostEngine()).latest_snapshot()
    st = snap.state
    mask = np.asarray(st.live_mask)
    paths = sorted(p for p, m in zip(
        st.file_actions.column("path").to_pylist(), mask.tolist()) if m)
    return snap.version, paths, {k: ref_obs.counter(k).value - before[k]
                                 for k in _COUNTERS}


def _port_load(path, at=None):
    """(version, live paths, counters) of a port load with every counter
    at 0 just before; `at` loads through `Table.snapshot_at`."""
    obs.reset()
    t = Table.for_path(str(path), engine=TorchEngine("cpu"))
    snap = t.latest_snapshot() if at is None else t.snapshot_at(at)
    st = snap.state
    assert st.version == snap.version
    return (snap.version, sorted(a.path for a in st.add_files),
            {k: obs.counters().get(k, 0) for k in _COUNTERS})


def _both(path):
    got, want = _port_load(path), _ref_load(path)
    assert got == want
    return got


@pytest.fixture
def twelve(tmp_path):
    """Versions 0..11, one 534-byte file each, checkpoint at 10."""
    _ref_table(tmp_path, [534] * 12)
    assert os.path.exists(_log(tmp_path, 10, "checkpoint.parquet"))
    return tmp_path


def _tear_add_line(path, version):
    """Cut commit `version` inside its add line (an interrupted write)."""
    with open(_log(path, version), "rb") as f:
        data = f.read()
    at = data.index(b'{"add"')
    with open(_log(path, version), "wb") as f:
        f.write(data[:at + 20])


# ------------------------------------------------------------ torn tip --

def test_torn_tip_commit_serves_the_version_before_it(twelve):
    """C2: commit 12 cut inside its add line; both serve (11, 12 files)."""
    t = RefTable.for_path(str(twelve), HostEngine())
    txn = t.start_transaction()
    txn.add_file(_ref_add(12, 534))
    txn.commit()
    _tear_add_line(twelve, 12)
    version, paths, counts = _both(twelve)
    assert (version, len(paths)) == (11, 12)
    assert paths == sorted(f"p{i}.parquet" for i in range(12))
    assert counts == {"snapshot.torn_commit_fallbacks": 1,
                      "snapshot.checkpoint_fallbacks": 0,
                      "snapshot.crc_quarantined": 0}
    _port_load(twelve)
    assert obs.counters()["log.torn_commits"] == 1


def test_snapshot_at_the_torn_tip_serves_the_version_before_it(twelve):
    """`snapshot_at(tip)` takes the same ladder as the reference's: the
    snapshot asked for at 12 serves 11 and then reports 11."""
    t = RefTable.for_path(str(twelve), HostEngine())
    txn = t.start_transaction()
    txn.add_file(_ref_add(12, 534))
    txn.commit()
    _tear_add_line(twelve, 12)
    clear_parse_cache()
    ref = RefTable.for_path(str(twelve), HostEngine()).snapshot_at(12)
    ref_files = ref.state.num_files
    got = _port_load(twelve, at=12)
    assert (got[0], len(got[1])) == (ref.version, ref_files) == (11, 12)
    assert got[2]["snapshot.torn_commit_fallbacks"] == 1
    # below the tip, snapshot_at reads an intact version: no fallback
    assert _port_load(twelve, at=11)[2][
        "snapshot.torn_commit_fallbacks"] == 0


def test_torn_line_below_the_tip_is_not_absorbed(twelve):
    """Commit 11 torn while 12 is intact: the log's history is damaged.
    Both raise LogCorruptedError (not the torn-tip error), after the same
    one checkpoint rebuild that cannot route around it."""
    t = RefTable.for_path(str(twelve), HostEngine())
    txn = t.start_transaction()
    txn.add_file(_ref_add(12, 534))
    txn.commit()
    _tear_add_line(twelve, 11)
    obs.reset()
    with pytest.raises(LogCorruptedError) as ei:
        Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
            .latest_snapshot().state
    assert not isinstance(ei.value, TornCommitError)
    port_fallbacks = obs.counters()["snapshot.checkpoint_fallbacks"]
    assert obs.counters()["snapshot.torn_commit_fallbacks"] == 0
    clear_parse_cache()
    c0 = ref_obs.counter("snapshot.checkpoint_fallbacks").value
    with pytest.raises(RefLogCorruptedError):
        RefTable.for_path(str(twelve), HostEngine()).latest_snapshot().state
    assert port_fallbacks == (
        ref_obs.counter("snapshot.checkpoint_fallbacks").value - c0) == 1


def test_torn_first_commit_is_not_absorbed(tmp_path):
    """A torn version 0 has no version before it to serve."""
    _ref_table(tmp_path, [534])
    _tear_add_line(tmp_path, 0)
    with pytest.raises(TornCommitError) as ei:
        Table.for_path(str(tmp_path), engine=TorchEngine("cpu")) \
            .latest_snapshot().state
    assert ei.value.context["version"] == 0
    assert ei.value.error_class == "DELTA_TORN_COMMIT"


# ---------------------------------------------------------- checkpoints --

def test_truncated_checkpoint_rebuilds_from_json(twelve):
    """C3: the only checkpoint cut to half its bytes."""
    cp = _log(twelve, 10, "checkpoint.parquet")
    with open(cp, "rb") as f:
        data = f.read()
    with open(cp, "wb") as f:
        f.write(data[:len(data) // 2])
    version, paths, counts = _both(twelve)
    assert (version, len(paths)) == (11, 12)
    assert counts["snapshot.checkpoint_fallbacks"] == 1
    assert counts["snapshot.torn_commit_fallbacks"] == 0
    snap = Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
        .latest_snapshot()
    snap.state
    assert snap.log_segment.checkpoint_version is None


def test_garbled_checkpoint_rebuilds_from_the_previous_one(tmp_path):
    _ref_table(tmp_path, [100 + i for i in range(13)])
    RefTable.for_path(str(tmp_path), HostEngine()).checkpoint(version=5)
    cp = _log(tmp_path, 10, "checkpoint.parquet")
    with open(cp, "wb") as f:
        f.write(b"\x89not-a-parquet-file" * 64)
    version, paths, counts = _both(tmp_path)
    assert (version, len(paths)) == (12, 13)
    assert counts["snapshot.checkpoint_fallbacks"] == 1
    snap = Table.for_path(str(tmp_path), engine=TorchEngine("cpu")) \
        .latest_snapshot()
    snap.state
    assert snap.log_segment.checkpoint_version == 5


def _multipart_at_11(path):
    from delta_tpu.config import settings
    from delta_tpu.log.checkpointer import write_checkpoint

    t = RefTable.for_path(str(path), HostEngine())
    saved = settings.checkpoint_part_size
    settings.checkpoint_part_size = 4
    try:
        write_checkpoint(t.engine, t.latest_snapshot(), policy="classic")
    finally:
        settings.checkpoint_part_size = saved
    parts = sorted(n for n in os.listdir(os.path.join(str(path), "_delta_log"))
                   if n.startswith(f"{11:020d}.checkpoint."))
    assert len(parts) > 1, "the checkpoint did not split"
    return [os.path.join(str(path), "_delta_log", n) for n in parts]


def test_missing_multipart_part_falls_back(twelve):
    """A part missing at LIST: the incomplete checkpoint never anchors the
    segment (checkpoint 10 does). A part that vanishes after LIST: the
    load rebuilds past it, counted."""
    parts = _multipart_at_11(twelve)
    os.remove(parts[0])
    assert _both(twelve)[:2] == (11, sorted(f"p{i}.parquet"
                                            for i in range(12)))
    parts = _multipart_at_11(twelve)
    snap = Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
        .latest_snapshot()
    assert snap.log_segment.checkpoint_version == 11
    os.remove(parts[1])
    obs.reset()
    st = snap.state
    assert (st.version, st.num_files) == (11, 12)
    assert snap.log_segment.checkpoint_version == 10
    assert obs.counters()["snapshot.checkpoint_fallbacks"] == 1


def test_vanished_commit_is_not_absorbed(twelve):
    snap = Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
        .latest_snapshot()
    os.remove(_log(twelve, 11))
    obs.reset()
    with pytest.raises(CorruptLogError):
        snap.state
    assert obs.counters()["snapshot.checkpoint_fallbacks"] == 0


# --------------------------------------------------------------- .crc ---

def _append_with_port(path, size):
    t = Table.for_path(str(path), engine=TorchEngine("cpu"))
    txn = t.create_transaction_builder().build()
    txn.add_file(AddFile(path="p3.parquet", partitionValues={}, size=size,
                         modificationTime=1003, dataChange=True))
    txn.commit()


def test_lying_crc_is_reseeded_and_the_next_crc_derives_from_it(tmp_path):
    """C4: `2.crc` says 99 files and 12345 B (truth: 3 files, 1603 B).
    Loading reseeds it; an append with either package then writes a
    `3.crc` of 4 files and 2109 B."""
    base = tmp_path / "base"
    _ref_table(base, [534, 534, 535])
    crc_path = _log(base, 2, "crc")
    with open(crc_path) as f:
        doc = json.load(f)
    assert (doc["numFiles"], doc["tableSizeBytes"]) == (3, 1603)
    doc["numFiles"], doc["tableSizeBytes"] = 99, 12345
    with open(crc_path, "w") as f:
        json.dump(doc, f)
    ref_copy, port_copy = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(base, ref_copy)
    shutil.copytree(base, port_copy)

    assert _ref_load(ref_copy)[2]["snapshot.crc_quarantined"] == 1
    t = RefTable.for_path(str(ref_copy), HostEngine())
    txn = t.start_transaction()
    txn.add_file(_ref_add(3, 506))
    txn.commit()

    version, paths, counts = _port_load(port_copy)
    assert (version, len(paths)) == (2, 3)
    assert counts["snapshot.crc_quarantined"] == 1
    with open(_log(port_copy, 2, "crc")) as f:
        reseeded = json.load(f)
    assert (reseeded["numFiles"], reseeded["tableSizeBytes"]) == (3, 1603)
    assert _port_load(port_copy)[2]["snapshot.crc_quarantined"] == 0
    _append_with_port(port_copy, 506)

    for copy in (ref_copy, port_copy):
        with open(_log(copy, 3, "crc")) as f:
            doc = json.load(f)
        assert (doc["numFiles"], doc["tableSizeBytes"]) == (4, 2109), copy
    # the reference finds the port's chain sound
    assert _ref_load(port_copy)[2]["snapshot.crc_quarantined"] == 0


@pytest.mark.parametrize("body", [
    "[]",
    "not json",
    '{"numFiles": null, "tableSizeBytes": 1603}',
    "NUMFILES_NULL",
    "METADATA_LIST",
])
def test_unreadable_crc_counts_as_none(tmp_path, body):
    """A `.crc` of the wrong structure (an array, a null count, a
    metadata that is no object) is an accelerator that cannot be read:
    both packages serve the version from the log, quarantine nothing,
    and leave the file as it was."""
    _ref_table(tmp_path, [534, 534, 535])
    crc_path = _log(tmp_path, 2, "crc")
    with open(crc_path) as f:
        doc = json.load(f)
    if body == "NUMFILES_NULL":
        doc["numFiles"] = None
        body = json.dumps(doc)
    elif body == "METADATA_LIST":
        doc["metadata"] = [doc["metadata"]]
        body = json.dumps(doc)
    with open(crc_path, "w") as f:
        f.write(body)
    version, paths, counts = _both(tmp_path)
    assert (version, len(paths)) == (2, 3)
    assert counts["snapshot.crc_quarantined"] == 0
    with open(crc_path) as f:
        assert f.read() == body


# ------------------------------------------------ what is not absorbed --

def test_out_of_scope_checkpoint_still_refuses(twelve):
    """An lz4 part, and a sidecar row naming a brotli sidecar, are typed
    refusals, not damage (the sidecar itself is read since the port reads
    V2 checkpoints; its codec is not; ZSTD and GZIP are read)."""
    cp = _log(twelve, 10, "checkpoint.parquet")
    tbl = pq.read_table(cp)
    pq.write_table(tbl, cp, compression="lz4")
    obs.reset()
    with pytest.raises(UnsupportedLogError):
        Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
            .latest_snapshot().state
    sidecar_t = pa.struct([("path", pa.string()), ("sizeInBytes", pa.int64()),
                           ("modificationTime", pa.int64())])
    sidecar = pa.array([{"path": "x.parquet", "sizeInBytes": 1,
                         "modificationTime": 1}]
                       + [None] * (tbl.num_rows - 1), sidecar_t)
    pq.write_table(tbl.append_column("sidecar", sidecar), cp)
    side = os.path.join(str(twelve), "_delta_log", "_sidecars")
    os.makedirs(side)
    pq.write_table(tbl, os.path.join(side, "x.parquet"),
                   compression="brotli")
    with pytest.raises(UnsupportedLogError):
        Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
            .latest_snapshot().state
    assert obs.counters()["snapshot.checkpoint_fallbacks"] == 0


@pytest.mark.parametrize("error", [RuntimeError, torch.cuda.OutOfMemoryError,
                                   ValueError])
def test_kernel_failure_propagates(twelve, monkeypatch, error):
    """K3's launch failure (RuntimeError from `check_launch`), the card's
    out-of-memory error, and a wrapper's ValueError reach the caller: the
    ladder never rebuilds from JSON around a failing kernel."""
    def failing(*args, **kwargs):
        raise error("hybrid_extract launch failed: CUDA error 700")

    monkeypatch.setattr(port_ops, "hybrid_extract", failing)
    obs.reset()
    with pytest.raises(error):
        Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
            .latest_snapshot().state
    assert obs.counters()["snapshot.checkpoint_fallbacks"] == 0


@pytest.mark.parametrize("error", [TypeError, AttributeError, IndexError])
@pytest.mark.parametrize("site", ["footer", "planner", "host_reader"])
def test_reader_bug_propagates(twelve, monkeypatch, site, error):
    """A fault in the reader's own code (here patched into the footer
    parse, the device planner or the host leaf reader) is no damaged
    checkpoint: it reaches the caller unchanged, with no rebuild from
    JSON. Only shapes the reader checks become DecodeCorrupt."""
    module, name = {"footer": (port_plan, "read_footer"),
                    "planner": (port_plan, "_plan_column_chunk"),
                    "host_reader": (parquet_host, "_levels")}[site]

    def buggy(*args, **kwargs):
        raise error(f"a bug in {name}")

    monkeypatch.setattr(module, name, buggy)
    obs.reset()
    with pytest.raises(error, match="a bug in"):
        Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
            .latest_snapshot().state
    assert obs.counters()["snapshot.checkpoint_fallbacks"] == 0


def test_unloadable_native_library_propagates(twelve, monkeypatch):
    """A native library that does not load raises RuntimeError, not the
    OSError the ladder would take for an unreadable checkpoint."""
    def no_load(path):
        raise OSError(f"{path}: cannot open shared object file")

    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "_FUNCS", {})
    monkeypatch.setattr(ctypes, "CDLL", no_load)
    obs.reset()
    with pytest.raises(RuntimeError, match="native library parquet_host"):
        Table.for_path(str(twelve), engine=TorchEngine("cpu")) \
            .latest_snapshot().state
    assert obs.counters()["snapshot.checkpoint_fallbacks"] == 0


# ------------------------------------------- damage vs scope, by site ---

def _part_bytes(**kw) -> bytes:
    tbl = pa.table({"add": pa.array(
        [{"path": f"p{i}", "size": i} for i in range(50)],
        pa.struct([("path", pa.string()), ("size", pa.int64())]))})
    sink = io.BytesIO()
    pq.write_table(tbl, sink, **kw)
    return sink.getvalue()


def test_footer_damage_sites():
    good = _part_bytes()
    n = len(good)
    flen = int.from_bytes(good[-8:-4], "little")
    cases = {
        "no magic": good[:-1] + b"X",
        "footer length past the file": good[:-8]
        + (n + 5).to_bytes(4, "little") + b"PAR1",
        "zeroed footer": good[:n - 8 - flen] + bytes(flen) + good[-8:],
        "garbled footer": good[:n - 8 - flen]
        + np.random.default_rng(3).integers(0, 256, flen, np.uint8).tobytes()
        + good[-8:],
    }
    for name, data in cases.items():
        with pytest.raises(DecodeCorrupt):
            read_footer(data)
        assert not isinstance(DecodeCorrupt(), DecodeUnsupported), name


def test_hybrid_stream_damage_and_scope_sites():
    # an RLE run of 1 value where 100 were declared
    with pytest.raises(DecodeCorrupt, match="ended early"):
        port_plan.parse_hybrid(b"\x02\x05", 0, 3, 100)
    with pytest.raises(DecodeCorrupt, match="ended early"):
        port_plan._plan_hybrid(port_plan._PlanState(), 0, b"\x02\x05", 0,
                               3, 100)
    with pytest.raises(DecodeCorrupt, match="outside"):
        port_plan.parse_hybrid(b"\x02\x05", 0, 33, 1)
    # a dictionary entry longer than its page
    with pytest.raises(DecodeCorrupt, match="dictionary"):
        port_plan._parse_byte_array_dict(b"\x05\x00\x00\x00ab", 1)
    with pytest.raises(DecodeCorrupt):
        parquet_host.byte_array_offsets(
            np.frombuffer(b"\x09\x00\x00\x00abc", np.uint8), 0, 1)
    with pytest.raises(DecodeCorrupt, match="past the page"):
        parquet_host._plain_values("INT64", np.zeros(12, np.uint8), 0, 2)
    # scope, not damage: a codec the reader lacks, and a page form the
    # device plan lacks (the host reader reads it)
    page = port_plan.PageInfo(0, 4, 4, 1, 0, 0)
    with pytest.raises(DecodeUnsupported, match="codec"):
        port_plan.decompress_page(b"abcd", page, "LZ4")
    data = _part_bytes(data_page_version="2.0")
    ft = read_footer(data)
    with pytest.raises(DecodeUnsupported, match="v2"):
        port_plan.build_part_plan(ft, data, ["add.size"], [])


def test_damaged_page_is_corruption_not_a_host_route():
    """A snappy page cut short inside a sound footer: the device plan must
    not send it to the host reader as out of scope; it raises damage."""
    data = bytearray(_part_bytes(compression="snappy"))
    ft = read_footer(bytes(data))
    col = ft.row_groups[0].columns[ft.index["add.size"]]
    end = col.start + col.total_compressed_size
    data[end - 6:end] = b"\xff" * 6
    with pytest.raises(DecodeCorrupt):
        port_plan.read_checkpoint_part(bytes(data), torch.device("cpu"),
                                       lambda leaf: True)


def test_format_enum_and_shape_damage_sites():
    from delta_tpu_torch.log.parquet_footer import _Thrift

    with pytest.raises(DecodeCorrupt, match="thrift type"):
        _Thrift(b"\x1d\x00").read_struct()  # field 1 of type id 13
    with pytest.raises(DecodeCorrupt, match="past the page"):
        parquet_host._plain_values("BOOLEAN", np.zeros(1, np.uint8), 0, 9)
    # a data page header whose encoding id (77) is no Parquet encoding
    header = (b"\x15\x00" b"\x15\x08" b"\x15\x08"
              b"\x2c\x15\x02\x15\x9a\x01\x00" b"\x00")
    with pytest.raises(DecodeCorrupt, match="encoding 77"):
        port_plan.split_pages(header + b"abcd", 10)


@pytest.mark.parametrize("region", ["footer", "pages"])
def test_damaged_bytes_raise_only_decode_errors(region):
    """Seeded byte damage in a part's footer or pages either still reads
    (a flipped value) or raises DecodeCorrupt or DecodeUnsupported, never
    another error that the snapshot could neither absorb nor classify."""
    good = _part_bytes(compression="snappy")
    n = len(good)
    flen = int.from_bytes(good[-8:-4], "little")
    lo, hi = (n - 8 - flen, n - 8) if region == "footer" else (4, n - 8 - flen)
    outcomes = {"read": 0, "corrupt": 0, "unsupported": 0}
    for seed in range(1500):
        rng = np.random.default_rng(seed)
        data = bytearray(good)
        for k in rng.integers(lo, hi, 3):
            data[k] = int(rng.integers(0, 256))
        try:
            port_plan.read_checkpoint_part(bytes(data), torch.device("cpu"),
                                           lambda leaf: True)
            outcomes["read"] += 1
        except DecodeCorrupt:
            outcomes["corrupt"] += 1
        except DecodeUnsupported:
            outcomes["unsupported"] += 1
    assert outcomes["corrupt"] > outcomes["unsupported"], outcomes

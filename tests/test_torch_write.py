"""The port's write path against pyarrow and the JAX package.

- Data files written by `write_data_file` / `write_table` read back equal
  with `pq.read_table`, and the reference's `HostEngine` loads a
  port-written table to the same rows and the same stats.
- The port's data-file reader reads what pyarrow writes: dictionary pages
  falling back to PLAIN past 1 MiB, several row groups, nulls, every type
  the port writes.
- `collect_stats` is byte for byte the reference's.
- Commit serialization, the put-if-absent store and the transaction's
  commit loop (own-commit detection, retries, refusals).
Everything exact.
"""

import datetime as dt
import io
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
from delta_tpu.engine.host import HostEngine
from delta_tpu.models import actions as ref_actions
from delta_tpu.models.schema import from_arrow_schema, schema_to_json
from delta_tpu.stats.collection import collect_stats as ref_collect_stats
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.api import schema_of, write_table
from delta_tpu_torch.errors import (
    ConcurrentAppendError,
    InvalidArgumentError,
    InvariantViolationError,
    MaxCommitRetriesExceededError,
    PathExistsError,
    SchemaMismatchError,
    UnsupportedTableError,
)
from delta_tpu_torch.log.parquet_data import read_data_file
from delta_tpu_torch.models import actions as port_actions
from delta_tpu_torch.models.batch import Batch, Column
from delta_tpu_torch.models.schema import schema_from_json
from delta_tpu_torch.stats.collection import bump_string, collect_stats
from delta_tpu_torch.storage.local import LocalLogStore
from delta_tpu_torch.txn import transaction as port_txn
from delta_tpu_torch.utils.parquet_write import data_file_bytes
from delta_tpu_torch.write.writer import write_data_files
from test_torch_cdf import port_changes_of, ref_changes_of


def _cpu():
    return TorchEngine("cpu")


def _commit_batch(path, batch, schema=None, target_rows_per_file=None):
    """Append `batch` through the transaction builder and the writer: the
    write of `write_table` with a chosen schema (on creation) and file
    split."""
    t = Table.for_path(path, engine=_cpu())
    builder = t.create_transaction_builder("WRITE")
    if schema is not None:
        builder = builder.with_schema(schema)
    txn = builder.build()
    meta = txn.metadata()
    txn.add_files(write_data_files(
        t.engine, t.path, batch, schema_from_json(meta.schemaString), [],
        meta.configuration, target_rows_per_file=target_rows_per_file))
    return txn.commit().version


def _arrow_to_batch(tbl: pa.Table) -> Batch:
    """The same rows as a port Batch (nulls hold the dtype's zero)."""
    cols = {}
    for name in tbl.column_names:
        arr = tbl.column(name).combine_chunks()
        valid = None
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
        t = arr.type
        if pa.types.is_string(t):
            vals = np.array(["" if v is None else v for v in arr.to_pylist()],
                            dtype=object)
        elif pa.types.is_date32(t):
            vals = np.asarray(arr.fill_null(0) if arr.null_count else arr)
        elif pa.types.is_timestamp(t):
            vals = np.asarray(arr.cast(pa.int64()).fill_null(0)) \
                .astype("datetime64[us]")
        else:
            vals = arr.fill_null(False if pa.types.is_boolean(t) else 0) \
                .to_numpy(zero_copy_only=False)
        cols[name] = Column(vals, valid)
    return Batch(cols, tbl.num_rows)


def _typed_table(rng, n, nulls=True):
    d = rng.normal(size=n)
    d[::11] = np.nan
    d[1::11] = np.inf
    d[2::11] = -0.0
    f = rng.normal(size=n).astype(np.float32)
    f[::7] = -np.inf
    mask = (rng.random(n) < 0.2) if nulls else None
    strings = [("é€𝄞" if i % 5 == 0 else "") + f"s{int(x)}" +
               ("y" * 35 if i % 9 == 0 else "")
               for i, x in enumerate(rng.integers(0, 10**6, n))]
    return pa.table({
        "l": pa.array(rng.integers(-2**62, 2**62, n), pa.int64(), mask=mask),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32)),
        "d": pa.array(d, mask=None if mask is None else np.roll(mask, 1)),
        "f": pa.array(f),
        "b": pa.array(rng.random(n) > 0.3,
                      mask=None if mask is None else np.roll(mask, 2)),
        "s": pa.array(strings, pa.string(),
                      mask=None if mask is None else np.roll(mask, 3)),
        "dt": pa.array(rng.integers(-5000, 30000, n).astype(np.int32),
                       pa.int32()).cast(pa.date32()),
        "ts": pa.array(rng.integers(-10**15, 10**16, n),
                       pa.timestamp("us", "UTC"),
                       mask=None if mask is None else np.roll(mask, 4)),
    })


def _assert_batch_equals_arrow(batch: Batch, tbl: pa.Table):
    assert batch.num_rows == tbl.num_rows
    assert batch.column_names == tbl.column_names
    want = _arrow_to_batch(tbl)
    for name in tbl.column_names:
        got, exp = batch.column(name), want.column(name)
        assert got.null_count == exp.null_count, name
        gv = got.valid if got.valid is not None else np.ones(len(got), bool)
        ev = exp.valid if exp.valid is not None else np.ones(len(exp), bool)
        np.testing.assert_array_equal(gv, ev)
        if got.values.dtype.kind == "f":
            np.testing.assert_array_equal(got.values[gv], exp.values[ev])
            np.testing.assert_array_equal(np.signbit(got.values[gv]),
                                          np.signbit(exp.values[ev]))
        else:
            assert got.values[gv].tolist() == exp.values[ev].tolist(), name


# ------------------------------------------------------------ reading --


@pytest.mark.parametrize("n,kw", [
    (1, {}),
    (5000, {}),
    (5000, {"use_dictionary": False}),
    (5000, {"compression": "none"}),
    (3000, {"row_group_size": 700}),            # several row groups
    (300_000, {"row_group_size": 150_000}),     # past the 1 MiB dictionary
])
def test_reader_matches_pyarrow(n, kw):
    tbl = _typed_table(np.random.default_rng(n), n)
    buf = io.BytesIO()
    pq.write_table(tbl, buf, **{"compression": "snappy", **kw})
    data = buf.getvalue()
    md = pq.ParquetFile(io.BytesIO(data)).metadata
    if n == 300_000:  # the writer really fell back to PLAIN mid-chunk
        assert md.num_row_groups == 2
        enc = md.row_group(0).column(0).encodings
        assert "PLAIN" in enc and "RLE_DICTIONARY" in enc
    _assert_batch_equals_arrow(read_data_file(data), tbl)


def _legacy_list_file() -> bytes:
    """A LIST whose repeated field is the element itself (the two-level
    form of old writers), rows [1, 2], null, []."""
    from delta_tpu_torch.utils.parquet_write import (
        LeafColumn,
        SchemaNode,
        write_parquet,
    )

    schema = SchemaNode("schema", 0, (SchemaNode(
        "x", 1, (SchemaNode("array", 2, physical="INT64"),),
        converted=3),))
    return write_parquet(schema, [LeafColumn(
        ("x", "array"), "INT64", np.array([2, 2, 0, 1], np.int32),
        np.array([0, 1, 0, 0], np.int32), 2, 1,
        np.array([1, 2], np.int64))], 3)


def test_reader_refuses_what_it_does_not_decode():
    from delta_tpu_torch.log.parquet_footer import DecodeUnsupported

    forms = []
    for tbl, kw in [
        (pa.table({"x": pa.array([1, 2], pa.uint32())}), {}),      # unsigned
        (pa.table({"x": pa.array([1, 2], pa.int64())}),
         {"compression": "lz4"}),
        (pa.table({"x": pa.array([1, 2], pa.int64())}),
         {"compression": "brotli", "data_page_version": "2.0"}),
    ]:
        buf = io.BytesIO()
        pq.write_table(tbl, buf, **kw)
        forms.append(buf.getvalue())
    forms.append(_legacy_list_file())
    for data in forms:
        with pytest.raises(DecodeUnsupported):
            read_data_file(data)


# ------------------------------------------------------------ writing --


@pytest.mark.parametrize("nulls", [True, False])
@pytest.mark.parametrize("n", [1, 2000, 200_000])
def test_written_files_read_back_with_pyarrow(n, nulls):
    tbl = _typed_table(np.random.default_rng(n + nulls), n, nulls=nulls)
    batch = _arrow_to_batch(tbl)
    schema = schema_of(batch)
    data = data_file_bytes(batch, schema)
    back = pq.read_table(io.BytesIO(data))
    assert back.schema.types == tbl.schema.types
    _assert_batch_equals_arrow(_arrow_to_batch(back), tbl)
    # and the port reads its own file
    _assert_batch_equals_arrow(read_data_file(data), tbl)
    if n == 200_000:
        md = pq.ParquetFile(io.BytesIO(data)).metadata
        assert "PLAIN" in md.row_group(0).column(0).encodings


def test_schema_string_matches_reference():
    tbl = _typed_table(np.random.default_rng(0), 10)
    assert json.loads(schema_to_json(from_arrow_schema(tbl.schema))) == \
        json.loads(json.dumps(schema_of(_arrow_to_batch(tbl))
                              .to_json_value()))


def test_write_table_loads_in_reference_to_same_rows(tmp_path):
    path = str(tmp_path / "t")
    rng = np.random.default_rng(4)
    tables = [_typed_table(rng, 300 + 50 * i) for i in range(3)]
    for i, tbl in enumerate(tables):
        if i == 2:  # split into files of 200 rows
            v = _commit_batch(path, _arrow_to_batch(tbl),
                              target_rows_per_file=200)
        else:
            v = write_table(path, _arrow_to_batch(tbl), engine=_cpu(),
                            mode="error" if i == 0 else "append")
        assert v == i
    ref = RefTable.for_path(path, engine=HostEngine()).latest_snapshot()
    assert ref.version == 2
    assert ref.protocol.minReaderVersion == 1
    assert ref.protocol.minWriterVersion == 2
    assert ref.metadata.schemaString == schema_to_json(
        from_arrow_schema(tables[0].schema))
    got = dta.read_table(path, engine=HostEngine())
    want = pa.concat_tables(tables)
    assert got.num_rows == want.num_rows
    key = lambda t: sorted(zip(t.column("i").to_pylist(),  # noqa: E731
                               t.column("s").to_pylist()))
    assert key(got) == key(want)
    # each add's stats equal the reference's over the same file rows
    conf = ref.metadata.configuration
    for row in ref.state.add_files_table.to_pylist():
        rows = pq.read_table(os.path.join(path, row["path"]))
        assert row["stats"] == ref_collect_stats(
            rows, ref.metadata.schema, conf, [])
    assert ref.state.add_files_table.num_rows == 1 + 1 + 2
    with pytest.raises(PathExistsError):
        write_table(path, _arrow_to_batch(tables[0]), mode="error",
                    engine=_cpu())


def test_write_table_checks_schema_and_not_null(tmp_path):
    from delta_tpu_torch.models.schema import StructField, StructType

    path = str(tmp_path / "t")
    schema = StructType([StructField("a", "long", nullable=False),
                         StructField("b", "string")])
    _commit_batch(path, Batch({"a": Column(np.arange(3)),
                               "b": Column(np.array(["x", "y", "z"],
                                                    dtype=object))}),
                  schema=schema)
    with pytest.raises(InvariantViolationError) as e:
        write_table(path, {"a": (np.arange(3), np.array([1, 0, 1], bool))},
                    engine=_cpu())
    assert e.value.error_class == "DELTA_NOT_NULL_CONSTRAINT_VIOLATED"
    with pytest.raises(SchemaMismatchError) as e:
        write_table(path, {"a": np.arange(3), "c": np.arange(3)},
                    engine=_cpu())
    assert e.value.error_class == "DELTA_COLUMN_NOT_FOUND_IN_SCHEMA"
    with pytest.raises(SchemaMismatchError) as e:
        write_table(path, {"b": np.array(["q"])}, engine=_cpu())
    assert e.value.error_class == "DELTA_MISSING_NOT_NULL_COLUMN_VALUE"
    # a nullable column may be left out: it reads as null
    write_table(path, {"a": np.arange(2)}, engine=_cpu())
    rows = dta.read_table(path, engine=HostEngine())
    assert rows.column("b").null_count == 2


@pytest.mark.parametrize("props", [
    {"delta.enableDeletionVectors": "true"},
    {"delta.columnMapping.mode": "name"},
    {"delta.enableInCommitTimestamps": "true"},
    {"delta.enableRowTracking": "true"},
    {"delta.minWriterVersion": "7"},
])
def test_write_table_refuses_feature_properties(tmp_path, props):
    """Feature properties the port does not write are refused before
    anything is written; deletion vectors and column mapping are written:
    the protocol and the rows as the reference's."""
    if props in ({"delta.enableDeletionVectors": "true"},
                 {"delta.columnMapping.mode": "name"}):
        port, ref = str(tmp_path / "t"), str(tmp_path / "r")
        assert write_table(port, {"a": np.arange(3)}, engine=_cpu(),
                           properties=props) == 0
        dta.write_table(ref, pa.table({"a": np.arange(3)}),
                        engine=HostEngine(), properties=props)
        protocols = [RefTable.for_path(p, engine=HostEngine())
                     .latest_snapshot().protocol for p in (port, ref)]
        assert protocols[0] == protocols[1]
        if "delta.enableDeletionVectors" in props:
            assert protocols[0].writerFeatures == ["deletionVectors"]
        else:
            assert (protocols[0].minReaderVersion,
                    protocols[0].minWriterVersion) == (2, 5)
        assert dta.read_table(port, engine=HostEngine()).column(
            "a").to_pylist() == [0, 1, 2]
        return
    with pytest.raises(UnsupportedTableError):
        write_table(str(tmp_path / "t"), {"a": np.arange(3)}, engine=_cpu(),
                    properties=props)
    assert not os.path.exists(tmp_path / "t" / "_delta_log")


def test_write_table_refuses_reference_tables_with_features(tmp_path):
    """Refused until ported: a reference table with the change data feed
    on now takes the append (which writes no change data: its feed is
    made from the adds), and a partitioned one."""
    path = str(tmp_path / "t")
    dta.write_table(path, pa.table({"a": [1, 2]}), engine=HostEngine(),
                    properties={"delta.enableChangeDataFeed": "true"})
    assert write_table(path, {"a": np.arange(3)}, engine=_cpu()) == 1
    got = dta.read_table(path, engine=HostEngine())
    assert sorted(got.column("a").to_pylist()) == [0, 1, 1, 2, 2]
    assert port_changes_of(path, 1) == ref_changes_of(path, 1) == {
        (1, "insert"): [(("a", str(i)),) for i in range(3)]}
    # a partitioned table was refused too, before partitioned tables were
    # ported: now the append lands in the partitions, as the reference's
    part = str(tmp_path / "p")
    dta.write_table(part, pa.table({"a": [1, 2], "b": [1, 1]}),
                    engine=HostEngine(), partition_by=["b"])
    assert write_table(part, {"a": np.arange(3), "b": np.arange(3)},
                       engine=_cpu()) == 1
    got = dta.read_table(part, engine=HostEngine())
    assert sorted(zip(got.column("a").to_pylist(),
                      got.column("b").to_pylist())) == \
        [(0, 0), (1, 1), (1, 1), (2, 1), (2, 2)]


def test_append_only_table_takes_appends(tmp_path):
    path = str(tmp_path / "t")
    write_table(path, {"a": np.arange(3)}, engine=_cpu(),
                properties={"delta.appendOnly": "true"})
    assert write_table(path, {"a": np.arange(3)}, engine=_cpu()) == 1
    t = Table.for_path(path, engine=_cpu())
    txn = t.create_transaction_builder("DELETE").build()
    f = txn.scan_files()[0]
    txn.remove_file(f.remove(1, data_change=True))
    with pytest.raises(InvalidArgumentError) as e:
        txn.commit()
    assert e.value.error_class == "DELTA_APPEND_ONLY_REMOVES"
    # a rearrangement (dataChange=false) is allowed
    txn = t.create_transaction_builder("OPTIMIZE").build()
    txn.remove_file(txn.scan_files()[0].remove(1, data_change=False))
    assert txn.commit().version == 2


# -------------------------------------------------------------- stats --


def _stats_cases():
    rng = np.random.default_rng(7)
    yield "typed", _typed_table(rng, 500), {}
    yield "typed-no-nulls", _typed_table(rng, 300, nulls=False), {}
    yield "two-indexed", _typed_table(rng, 50), {
        "delta.dataSkippingNumIndexedCols": "2"}
    yield "explicit", _typed_table(rng, 50), {
        "delta.dataSkippingStatsColumns": "s, d,nope"}
    yield "all-indexed", _typed_table(rng, 50), {
        "delta.dataSkippingNumIndexedCols": "-1"}
    yield "edge", pa.table({
        "all_null": pa.array([None, None, None], pa.int64()),
        "all_nan": pa.array([np.nan, np.nan, np.nan]),
        "nan_and_null": pa.array([np.nan, None, np.nan]),
        "zeros": pa.array([0.0, -0.0, 0.0]),
        "neg_zero_first": pa.array([-0.0, 0.0, 1.0]),
        "zero_max": pa.array([-1.0, 0.0, -0.0]),
        "infs": pa.array([np.inf, -np.inf, None]),
        "max_chars": pa.array(["\U0010FFFF" * 40, "a", None]),
        "bump": pa.array(["a" * 31 + "\U0010FFFF" * 5, "b", "c"]),
        "empty": pa.array(["", "", None]),
        "f32": pa.array(np.array([0.1, 1e-30, -3.5], np.float32)),
    }), {}
    yield "empty-rows", _typed_table(rng, 1).slice(0, 0), {}


@pytest.mark.parametrize("name,tbl,conf", list(_stats_cases()),
                         ids=[c[0] for c in _stats_cases()])
def test_collect_stats_byte_identical(name, tbl, conf):
    ref_schema = from_arrow_schema(tbl.schema)
    want = ref_collect_stats(tbl, ref_schema, conf, [])
    port_schema = schema_from_json(schema_to_json(ref_schema))
    got = collect_stats(_arrow_to_batch(tbl), port_schema, conf, [])
    assert got == want


def test_bump_string_matches_reference():
    from delta_tpu.stats.collection import bump_string as ref_bump

    for s in ["", "a", "az", "a\U0010FFFF", "\U0010FFFF" * 3, "é€𝄞"]:
        assert bump_string(s) == ref_bump(s)


# ----------------------------------------------- commits and the store --


def test_commit_bytes_parse_like_the_reference():
    add = port_actions.AddFile("p", {}, 10, 5, False, '{"numRecords":1}',
                               {"t": "v"})
    acts = [port_actions.CommitInfo(timestamp=1, operation="WRITE",
                                    operationParameters={"x": [1]},
                                    isBlindAppend=True, txnId="id"),
            port_actions.Protocol(1, 2),
            port_actions.Metadata("m", '{"type":"struct","fields":[]}',
                                  configuration={"a": "b"}, createdTime=3),
            port_actions.SetTransaction("app", 4, 9),
            add.remove(7, data_change=False), add]
    data = port_actions.actions_to_commit_bytes(acts)
    ref = ref_actions.actions_from_commit_bytes(data)
    assert [a.to_dict() for a in ref] == [a.to_dict() for a in acts]
    assert ref_actions.actions_to_commit_bytes(ref) == data
    back = port_actions.actions_from_commit_bytes(data)
    assert [a.to_dict() for a in back] == [a.to_dict() for a in acts]
    ref_remove = ref_actions.AddFile.from_dict(add.to_dict()).remove(
        7, data_change=False)
    assert ref_remove.to_dict() == add.remove(7, data_change=False).to_dict()


def test_put_if_absent(tmp_path):
    fs = LocalLogStore()
    p = str(tmp_path / "log" / "00.json")
    fs.write(p, b"first")
    with pytest.raises(FileExistsError):
        fs.write(p, b"second")
    assert fs.read_file(p) == b"first"
    fs.write(p, b"third", overwrite=True)
    assert fs.read_file(p) == b"third"
    assert sorted(os.listdir(tmp_path / "log")) == ["00.json"]  # no temp


def _table_with_rows(tmp_path, n=3):
    path = str(tmp_path / "t")
    for i in range(n):
        write_table(path, {"a": np.arange(5) + 10 * i}, engine=_cpu())
    return Table.for_path(path, engine=_cpu())


def test_blind_append_rebases_past_a_concurrent_append(tmp_path):
    t = _table_with_rows(tmp_path, 1)
    txn = t.create_transaction_builder("WRITE").build()
    write_table(t.path, {"a": np.arange(2)}, engine=_cpu())  # the winner
    txn.add_file(port_actions.AddFile("x.parquet", size=1))
    res = txn.commit()
    assert (res.version, res.attempts) == (2, 2)


def test_serializable_whole_table_read_conflicts_with_an_append(tmp_path):
    path = str(tmp_path / "t")
    write_table(path, {"a": np.arange(5)}, engine=_cpu(),
                properties={"delta.isolationLevel": "Serializable"})
    t = Table.for_path(path, engine=_cpu())
    txn = t.create_transaction_builder("WRITE").build()
    txn.scan_files()
    write_table(t.path, {"a": np.arange(2)}, engine=_cpu())
    txn.add_file(port_actions.AddFile("x.parquet", size=1))
    with pytest.raises(ConcurrentAppendError):
        txn.commit()


def test_own_commit_is_recognized_after_an_ambiguous_write(tmp_path,
                                                           monkeypatch):
    """The put landed but the writer saw FileExistsError: the winner at
    our version carries our txnId, so the commit succeeds there instead
    of rebasing into a duplicate."""
    t = _table_with_rows(tmp_path, 1)
    real = LocalLogStore.write

    def lossy(self, path, data, overwrite=False):
        real(self, path, data, overwrite)
        if path.endswith(".json"):
            raise FileExistsError(path)

    monkeypatch.setattr(LocalLogStore, "write", lossy)
    txn = t.create_transaction_builder("WRITE").build()
    txn.add_file(port_actions.AddFile("x.parquet", size=1))
    res = txn.commit()
    assert (res.version, res.attempts) == (1, 1)
    assert not os.path.exists(os.path.join(t.log_path,
                                           f"{2:020d}.json"))


def test_max_commit_retries(tmp_path, monkeypatch):
    t = _table_with_rows(tmp_path, 1)
    monkeypatch.setattr(port_txn, "MAX_COMMIT_RETRIES", 0)
    txn = t.create_transaction_builder("WRITE").build()
    write_table(t.path, {"a": np.arange(2)}, engine=_cpu())
    txn.add_file(port_actions.AddFile("x.parquet", size=1))
    with pytest.raises(MaxCommitRetriesExceededError):
        txn.commit()


def test_group_commit_and_domain_writes_are_refused(tmp_path, monkeypatch):
    t = _table_with_rows(tmp_path, 1)
    txn = t.create_transaction_builder("WRITE").build()
    with pytest.raises(UnsupportedTableError):
        txn.set_domain_metadata("d", "{}")
    monkeypatch.setenv("DELTA_TPU_GROUP_COMMIT", "1")
    txn.add_file(port_actions.AddFile("x.parquet", size=1))
    with pytest.raises(UnsupportedTableError):
        txn.commit()


def test_dates_and_timestamps_stats_as_reference(tmp_path):
    tbl = pa.table({
        "dt": pa.array([dt.date(1969, 12, 31), dt.date(2024, 2, 29)]),
        "ts": pa.array([dt.datetime(1960, 1, 1, 0, 0, 0, 5,
                                    tzinfo=dt.timezone.utc),
                        dt.datetime(2030, 5, 6, 7, 8, 9, 123456,
                                    tzinfo=dt.timezone.utc)],
                       pa.timestamp("us", "UTC")),
    })
    ref_schema = from_arrow_schema(tbl.schema)
    assert collect_stats(_arrow_to_batch(tbl),
                         schema_from_json(schema_to_json(ref_schema)),
                         {}, []) == ref_collect_stats(tbl, ref_schema, {}, [])


def test_idempotent_app_id_conflicts_with_a_concurrent_advance(tmp_path):
    from delta_tpu_torch.errors import ConcurrentTransactionError

    t = _table_with_rows(tmp_path, 1)
    txn = t.create_transaction_builder("WRITE") \
        .with_transaction_id("stream-1", 1).build()
    winner = t.create_transaction_builder("WRITE") \
        .with_transaction_id("stream-1", 1).build()
    winner.add_file(port_actions.AddFile("w.parquet", size=1))
    assert winner.commit().version == 1
    txn.add_file(port_actions.AddFile("x.parquet", size=1))
    with pytest.raises(ConcurrentTransactionError):
        txn.commit()
    # the reference reads the watermark the port wrote
    ref = RefTable.for_path(t.path, engine=HostEngine()).latest_snapshot()
    assert ref.set_transaction_version("stream-1") == 1
    with pytest.raises(ConcurrentTransactionError):
        t.create_transaction_builder("WRITE") \
            .with_transaction_id("stream-1", 1).build()


def test_random_file_prefixes(tmp_path):
    path = str(tmp_path / "t")
    write_table(path, {"a": np.arange(7)}, engine=_cpu(),
                properties={"delta.randomizeFilePrefixes": "true",
                            "delta.randomPrefixLength": "3"})
    (add,) = Table.for_path(path, engine=_cpu()).latest_snapshot() \
        .state.add_files
    prefix, name = add.path.split("/")
    assert len(prefix) == 3 and name.startswith("part-")
    assert dta.read_table(path, engine=HostEngine()) \
        .column("a").to_pylist() == list(range(7))


def test_optimize_of_a_vanished_data_file(tmp_path):
    from delta_tpu_torch.errors import FileNotFoundInLogError

    t = _table_with_rows(tmp_path, 2)
    os.remove(os.path.join(t.path, t.latest_snapshot().state
                           .add_files[0].path))
    with pytest.raises(FileNotFoundInLogError):
        t.optimize().execute_zorder_by("a")


def test_strings_with_nul_bytes_round_trip():
    batch = Batch({"s": Column(np.array(["a\x00b", "", "\x00"], object))})
    data = data_file_bytes(batch, schema_of(batch))
    assert pq.read_table(io.BytesIO(data)).column("s").to_pylist() == \
        ["a\x00b", "", "\x00"]
    assert read_data_file(data).column("s").values.tolist() == \
        ["a\x00b", "", "\x00"]


@pytest.mark.parametrize("unit", ["ms", "us", "ns"])
def test_reader_takes_every_timestamp_unit(unit):
    micros = np.array([-10**6, 0, 1_700_000_000_123_000], np.int64)
    tbl = pa.table({"t": pa.array(micros, pa.timestamp("us", "UTC"))
                    .cast(pa.timestamp(unit, "UTC"))})
    buf = io.BytesIO()
    pq.write_table(tbl, buf)
    got = read_data_file(buf.getvalue()).column("t").values
    assert got.dtype == np.dtype("datetime64[us]")
    want = tbl.column("t").cast(pa.timestamp("us", "UTC")).cast(pa.int64())
    assert got.astype(np.int64).tolist() == want.to_pylist()


def test_concurrent_appends_all_land(tmp_path):
    """Writers racing on one table: every append commits once, at its own
    version, rebased past the winners it lost to."""
    import sys
    import threading

    t = _table_with_rows(tmp_path, 1)
    errors, versions = [], []
    lock = threading.Lock()

    def writer(i):
        try:
            for j in range(3):
                v = write_table(t.path, {"a": np.full(4, 100 * i + j)},
                                engine=_cpu())
                with lock:
                    versions.append(v)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert sorted(versions) == list(range(1, 37))
    st = Table.for_path(t.path, engine=_cpu()).latest_snapshot().state
    assert st.version == 36 and st.num_files == 37
    got = sorted(dta.read_table(t.path, engine=HostEngine())
                 .column("a").to_pylist())
    want = sorted(list(range(5)) + [100 * i + j for i in range(12)
                                    for j in range(3) for _ in range(4)])
    assert got == want

"""Post-commit hooks of the port's transaction against the reference.

Every port commit runs `delta_tpu_torch.hooks`: a `.crc` per version, a
checkpoint every `delta.checkpointInterval` commits and auto-compaction.
The reference reads what they write: each `.crc` passes the JAX
package's `validate_state_against_checksum` on a `HostEngine`
`snapshot_at` of its version, and the checkpoint loads there. A failing
hook is counted and the commit stands; the UniForm properties, whose
hooks are not ported, are refused before anything is written (the
symlink-manifest hook is ported: `tests/test_torch_sql_statements.py`).
"""

import glob
import os
import shutil

import numpy as np
import pyarrow as pa
import pytest

from delta_tpu import api as ref_api
from delta_tpu.engine.host import HostEngine
from delta_tpu.log.checksum import read_checksum as ref_read_checksum
from delta_tpu.log.checksum import \
    validate_state_against_checksum as ref_validate
from delta_tpu.table import Table as RefTable
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.api import write_table
from delta_tpu_torch.errors import UnsupportedTableError
from delta_tpu_torch.log import checkpointer
from delta_tpu_torch.log.checksum import (
    read_checksum,
    validate_state_against_checksum,
)
from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint
from delta_tpu_torch.models.batch import Batch, as_column
from delta_tpu_torch.models.schema import schema_from_json
from delta_tpu_torch.write.writer import write_data_files
from test_torch_checkpoint import assert_matches_reference

CPU = TorchEngine("cpu")


def _rows(i, n=20):
    rng = np.random.default_rng(i)
    return {"k": rng.integers(0, 1000, n), "x": rng.normal(size=n)}


def _log_files(root, pattern):
    return sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(root, "_delta_log", pattern)))


def _failures():
    """The hook failure counters that are not 0."""
    return {k: v for k, v in obs.counters().items()
            if k.startswith("hooks.") and v}


def test_twelve_appends_checkpoint_at_ten_and_every_crc_validates(tmp_path):
    root = str(tmp_path)
    obs.reset()
    for i in range(12):
        assert write_table(root, _rows(i), engine=CPU) == i
    assert _failures() == {}
    assert _log_files(root, "*.checkpoint*") == [
        f"{10:020d}.checkpoint.parquet"]
    hint = read_last_checkpoint(CPU.fs, root + "/_delta_log")
    assert hint.version == 10 and hint.numOfAddFiles == 11
    assert _log_files(root, "*.crc") == [f"{v:020d}.crc" for v in range(12)]
    ref = RefTable.for_path(root, engine=HostEngine())
    port = Table.for_path(root, engine=CPU)
    for v in range(12):
        ref_state = ref.snapshot_at(v).state
        ref_validate(ref_state, ref_read_checksum(HostEngine().fs,
                                                  ref.log_path, v))
        validate_state_against_checksum(
            port.snapshot_at(v).state, read_checksum(CPU.fs, port.log_path,
                                                     v))
    state = port.latest_snapshot().state
    assert state.file_actions.version.min() == 10  # through the checkpoint
    assert_matches_reference(root, state)


def test_checkpoint_interval_is_honoured(tmp_path):
    root = str(tmp_path)
    for i in range(8):
        write_table(root, _rows(i), engine=CPU,
                    properties={"delta.checkpointInterval": "3"})
    assert _log_files(root, "*.checkpoint*") == [
        f"{v:020d}.checkpoint.parquet" for v in (3, 6)]
    assert_matches_reference(root, Table.for_path(root, engine=CPU)
                             .latest_snapshot().state)


def test_a_failing_checksum_hook_is_counted_and_writes_no_crc(
        tmp_path, monkeypatch):
    from delta_tpu_torch.log import checksum

    def boom(table, txn, version):
        raise OSError("read-only file system")

    monkeypatch.setattr(checksum, "write_checksum_for_commit", boom)
    obs.reset()
    root = str(tmp_path)
    for i in range(3):
        assert write_table(root, _rows(i), engine=CPU) == i
    assert _failures() == {"hooks.checksum_hook.failures": 3}
    assert _log_files(root, "*.crc") == []
    assert _log_files(root, "*.json") == [f"{v:020d}.json" for v in range(3)]
    assert_matches_reference(root, Table.for_path(root, engine=CPU)
                             .latest_snapshot().state)


def test_a_broken_crc_chain_writes_no_crc(tmp_path):
    root = str(tmp_path)
    for i in range(2):
        write_table(root, _rows(i), engine=CPU)
    os.remove(os.path.join(root, "_delta_log", f"{1:020d}.crc"))
    write_table(root, _rows(2), engine=CPU)
    assert _log_files(root, "*.crc") == [f"{0:020d}.crc"]
    # a checkpoint reseeds the chain from the state
    Table.for_path(root, engine=CPU).checkpoint()
    write_table(root, _rows(3), engine=CPU)
    assert _log_files(root, "*.crc") == [f"{v:020d}.crc" for v in (0, 2, 3)]
    ref_validate(RefTable.for_path(root, engine=HostEngine())
                 .latest_snapshot().state,
                 ref_read_checksum(HostEngine().fs, root + "/_delta_log", 3))


def test_a_failing_hook_is_counted_and_the_commit_stands(tmp_path,
                                                          monkeypatch):
    root = str(tmp_path)

    def boom(engine, snapshot, metrics=None):
        raise OSError("disk full")

    monkeypatch.setattr(checkpointer, "write_checkpoint", boom)
    obs.reset()
    for i in range(11):
        assert write_table(root, _rows(i), engine=CPU) == i
    assert _failures() == {"hooks.checkpoint_hook.failures": 1}
    assert _log_files(root, "*.checkpoint*") == []
    assert Table.for_path(root, engine=CPU).latest_snapshot().version == 10


def _small_files(root, n, write):
    """A table of `n` one-row files in two commits: the first creates it,
    the second adds n - 1 files."""
    write(root, {"k": np.arange(1), "x": np.zeros(1)})
    table = Table.for_path(root, engine=CPU)
    txn = table.create_transaction_builder().build()
    meta = txn.metadata()
    schema = schema_from_json(meta.schemaString)
    for i in range(1, n):
        batch = Batch({"k": as_column(np.arange(i, i + 1)),
                       "x": as_column(np.full(1, float(i)))})
        txn.add_files(write_data_files(CPU, root, batch, schema, [],
                                       meta.configuration))
    txn.commit()


def test_auto_compaction_fires_on_fifty_small_files_as_the_reference(
        tmp_path):
    props = {"delta.autoOptimize.autoCompact": "true"}
    src = str(tmp_path / "src")
    _small_files(src, 49, lambda r, cols: write_table(
        r, cols, engine=CPU, properties=props))
    assert Table.for_path(src, engine=CPU).latest_snapshot() \
        .state.num_files == 49
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    shutil.copytree(src, port)
    shutil.copytree(src, ref)
    write_table(port, {"k": np.arange(50, 51), "x": np.ones(1)}, engine=CPU)
    ref_api.write_table(ref, pa.table({"k": pa.array([50], pa.int64()),
                                       "x": pa.array([1.0])}),
                        engine=HostEngine())
    p_state = Table.for_path(port, engine=CPU).latest_snapshot().state
    r_state = RefTable.for_path(ref, engine=HostEngine()) \
        .latest_snapshot().state
    assert p_state.version == r_state.version == 3
    assert p_state.num_files == r_state.num_files == 1
    assert p_state.latest_commit_info.operation == "OPTIMIZE" \
        == r_state.latest_commit_info.operation
    assert len(p_state.tombstones) == len(r_state.tombstones()) == 50
    assert_matches_reference(port, p_state)
    # under the threshold nothing is compacted
    small = str(tmp_path / "small")
    _small_files(small, 10, lambda r, cols: write_table(
        r, cols, engine=CPU, properties=props))
    write_table(small, {"k": np.arange(1), "x": np.ones(1)}, engine=CPU)
    assert Table.for_path(small, engine=CPU).latest_snapshot() \
        .state.num_files == 11


@pytest.mark.parametrize("props", [
    {"delta.universalFormat.enabledFormats": "iceberg"},
    {"delta.universalFormat.enabledFormats": "hudi"},
    {"delta.universalFormat.enabledFormats": "iceberg,hudi"},
])
def test_tables_asking_for_unported_hooks_are_refused(tmp_path, props):
    root = str(tmp_path)
    with pytest.raises(UnsupportedTableError):
        write_table(root, _rows(0), engine=CPU, properties=props)
    assert _log_files(root, "*.json") == []

"""The port stands alone: it imports nothing of the JAX package.

A snapshot load through `delta_tpu_torch` in a fresh interpreter, of a
commit-only log and of a checkpointed one, a `write_table` plus OPTIMIZE
(both curves, and compaction), the checkpoint writes of the
post-commit hooks and of `Table.checkpoint`, and a filtered `read_table`
(scan planning with the stats index, the skip mask and the ladder, the
row read) plus an OPTIMIZE with a predicate, and the log forms (a V2
checkpoint with struct-only stats read back and scanned, a compacted
delta, metadata cleanup of `log/cleanup.py`), and deletion vectors (a DV
DELETE, a read that decodes them, an UPDATE, an OPTIMIZE that purges
them), and a partitioned write, a filtered read of it and a MERGE
through the device join, and column mapping (a mapped partitioned write,
the expression parser, ALTER TABLE's rename, drop, add and mode upgrade,
a filtered read through a renamed column, a DELETE and a checkpoint with
`stats_parsed` reloaded), and the write modes (`merge_schema`,
`replace_where`, a dynamic partition overwrite, `overwrite_schema`), and
the maintenance commands (REORG PURGE, VACUUM FULL and LITE with a dry
run, RESTORE, a shallow and a deep CLONE), and the change data feed (the
change data of DELETE, UPDATE and MERGE on a mapped partitioned table
and `table_changes`), and SQL (the TPC-DS generator and catalog, two
corpus queries through `sql()`, a plain SELECT with time travel,
DESCRIBE DETAIL, a DELETE and a refused construct) must leave no `jax`, `pyarrow`, `pandas`,
`delta_tpu`, `delta_tpu.*` or `benchmarks*` module in `sys.modules`
(`delta_tpu_torch` itself shares the prefix, so the check matches whole
dotted names). And no source of the port may name them in an import.
"""

import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import json, sys
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.utils.synth import synth_delta_log

d = sys.argv[1]
truth = synth_delta_log(d, 6, 10)
st = Table.for_path(d, engine=TorchEngine("cpu")).latest_snapshot().state
assert sorted(a.path for a in st.add_files) == truth.live_paths
assert len(st.tombstones) == truth.num_tombstones
# a checkpointed log: the footer reader, snappy, the plan, the host leaf
# reader and the synthetic writer all run
d2 = d + "/checkpointed"
truth = synth_delta_log(d2, 12, 10, checkpoint_version=9, now_ms=7 * 86_400_000)
st = Table.for_path(d2, engine=TorchEngine("cpu")).latest_snapshot().state
assert st.file_actions.version.min() == 9  # rows from the checkpoint
assert sorted(a.path for a in st.add_files) == truth.live_paths
assert len(st.tombstones) == truth.num_tombstones
# the write path: appends, OPTIMIZE along both curves, compaction
import numpy as np
from delta_tpu_torch.api import write_table
d3 = d + "/written"
rng = np.random.default_rng(0)
for i in range(3):
    write_table(d3, {"k": rng.integers(0, 1 << 30, 500),
                     "s": np.array([f"v{j}" for j in range(500)]),
                     "x": rng.normal(size=500)}, engine=TorchEngine("cpu"))
t = Table.for_path(d3, engine=TorchEngine("cpu"))
assert t.optimize().execute_zorder_by("k", "s").version == 3
assert t.optimize().execute_zorder_by("k", "x", curve="hilbert").version == 4
write_table(d3, {"k": np.arange(5)}, engine=TorchEngine("cpu"))
assert t.optimize().execute_compaction().version == 6
assert t.latest_snapshot().state.num_files == 1
# the checkpoint write: the hook's multi-part checkpoint at version 10,
# the .crc of every version, and Table.checkpoint at an earlier version
from delta_tpu_torch import obs
from delta_tpu_torch.config import settings
settings.checkpoint_part_size = 2
for i in range(4):
    write_table(d3, {"k": np.arange(5)}, engine=TorchEngine("cpu"))
st = t.latest_snapshot().state
assert st.version == 10 and st.file_actions.version.min() == 10
assert obs.counters()["checkpoint.parts_written"] >= 3
t.checkpoint(version=9)
assert not any(v for k, v in obs.counters().items() if k.startswith("hooks."))
# the read path: a filtered read_table and a predicate OPTIMIZE
from delta_tpu_torch.api import read_table
from delta_tpu_torch.expressions import col, lit
obs.reset()
b = read_table(d3, filter=(col("k") < lit(3)) & (col("s") > lit("v1")),
               columns=["k"], engine=TorchEngine("cpu"))
assert b.column_names == ["k"]
assert obs.counters()["scan.device_plans"] == 1
assert obs.counters()["scan.device_fallbacks"] == 1
write_table(d3, {"k": np.arange(5)}, engine=TorchEngine("cpu"))
write_table(d3, {"k": np.arange(5)}, engine=TorchEngine("cpu"))
m = t.optimize().where(col("k") >= lit(0)).execute_compaction()
assert m.num_files_removed >= 2
# the log forms: a V2 checkpoint with struct-only stats, its reload and a
# scan over it, a compacted delta, metadata cleanup
from delta_tpu_torch.log.checkpointer import write_checkpoint
from delta_tpu_torch.log.cleanup import (cleanup_expired_logs,
                                         write_compacted_delta)
d4 = d + "/forms"
settings.checkpoint_part_size = 2
for i in range(4):
    write_table(d4, {"k": np.arange(5) + 10 * i}, engine=TorchEngine("cpu"),
                properties={"delta.checkpoint.writeStatsAsStruct": "true",
                            "delta.checkpoint.writeStatsAsJson": "false"})
t4 = Table.for_path(d4, engine=TorchEngine("cpu"))
write_checkpoint(t4.engine, t4.latest_snapshot(), policy="v2")
obs.reset()
b = read_table(d4, filter=col("k") >= lit(25), engine=TorchEngine("cpu"))
assert sorted(b.column("k").values.tolist()) == [30, 31, 32, 33, 34]
assert obs.counters()["decode.device_parts"] == 2  # the two sidecars
write_table(d4, {"k": np.arange(5)}, engine=TorchEngine("cpu"))
write_table(d4, {"k": np.arange(5)}, engine=TorchEngine("cpu"))
write_compacted_delta(t4, 4, 5)
assert Table.for_path(d4, engine=TorchEngine("cpu")).latest_snapshot() \
    .log_segment.compacted_deltas
assert cleanup_expired_logs(t4, retention_ms=0) != []
assert Table.for_path(d4, engine=TorchEngine("cpu")).latest_snapshot() \
    .state.num_files == 6
# deletion vectors: a DV DELETE (one packed through the bitmap-container
# path), a read that decodes them, an UPDATE and an OPTIMIZE that purges
from delta_tpu_torch.commands.dml import delete, update
d5 = d + "/dv"
write_table(d5, {"k": np.arange(9000), "x": rng.normal(size=9000)},
            engine=TorchEngine("cpu"),
            properties={"delta.enableDeletionVectors": "true"})
write_table(d5, {"k": np.arange(9000, 9100), "x": np.zeros(100)},
            engine=TorchEngine("cpu"))
t5 = Table.for_path(d5, engine=TorchEngine("cpu"))
assert delete(t5, col("k") < lit(5000)).num_dvs_written == 1
assert delete(t5, col("k") >= lit(9050)).num_dvs_written == 1
b = read_table(d5, filter=col("k") >= lit(0), engine=TorchEngine("cpu"))
assert sorted(b.column("k").values.tolist()) == list(range(5000, 9050))
assert update(t5, {"x": lit(1.0)}, col("k") < lit(6000)).num_rows_updated \
    == 1000
assert t5.optimize().execute_compaction().num_files_removed == 2
assert read_table(d5, engine=TorchEngine("cpu")).num_rows == 4050
# partitioned tables and MERGE: a partitioned write, a read filtered on
# the partition, an upsert through the device join (its plain version)
import delta_tpu_torch.commands.merge as merge_mod
d6 = d + "/merge"
write_table(d6, {"id": np.arange(100), "v": np.zeros(100),
                 "m": np.array([f"m{i % 3}" for i in range(100)])},
            partition_by=["m"], engine=TorchEngine("cpu"))
assert read_table(d6, filter=col("m") == lit("m1"),
                  engine=TorchEngine("cpu")).num_rows == 33
merge_mod.DEVICE_JOIN_MIN_ROWS = 0
obs.reset()
m = (merge_mod.merge(Table.for_path(d6, engine=TorchEngine("cpu")),
                     {"id": np.array([1, 200]), "v": np.ones(2),
                      "m": np.array(["m1", "m2"])},
                     (col("target.id") == col("source.id"))
                     & (col("target.m") == col("source.m")))
     .when_matched_update(set={"v": col("source.v")})
     .when_not_matched_insert_all().execute())
assert (m.num_target_rows_updated, m.num_target_rows_inserted) == (1, 1)
assert obs.counters()["join.device_joins"] == 1
# column mapping and ALTER TABLE: a mapped partitioned write, the parser,
# rename, drop, add and the mode upgrade, a read through a renamed column,
# a DELETE and a stats_parsed checkpoint reloaded
from delta_tpu_torch.commands import alter
from delta_tpu_torch.expressions.parser import parse_expression, to_sql
from delta_tpu_torch.models.schema import StructField
d7 = d + "/mapped"
write_table(d7, {"id": np.arange(60), "v": rng.normal(size=60),
                 "p": np.array([f"p{i % 3}" for i in range(60)])},
            partition_by=["p"], engine=TorchEngine("cpu"),
            properties={"delta.columnMapping.mode": "name",
                        "delta.checkpoint.writeStatsAsStruct": "true"})
t7 = Table.for_path(d7, engine=TorchEngine("cpu"))
alter.rename_column(t7, "id", "key")
alter.rename_column(t7, "p", "part")
alter.add_columns(t7, [StructField("w", "double")])
alter.drop_column(t7, "v")
pred = parse_expression("key < 30 AND part = 'p1'")
assert to_sql(pred) == "(key < 30 AND part = 'p1')"
b = read_table(d7, filter=pred, engine=TorchEngine("cpu"))
assert b.column_names == ["key", "w", "part"] and b.num_rows == 10
delete(t7, parse_expression("key >= 50"))
write_checkpoint(t7.engine, t7.latest_snapshot())
assert Table.for_path(d7, engine=TorchEngine("cpu")).latest_snapshot() \
    .scan(filter=parse_expression("key < 10")).to_batch().num_rows == 10
d8 = d + "/upgraded"
write_table(d8, {"a": np.arange(5)}, engine=TorchEngine("cpu"))
t8 = Table.for_path(d8, engine=TorchEngine("cpu"))
alter.set_properties(t8, {"delta.columnMapping.mode": "name"})
alter.rename_column(t8, "a", "b")
assert read_table(d8, engine=TorchEngine("cpu")).column(
    "b").values.tolist() == [0, 1, 2, 3, 4]
# the write modes: merge_schema, replace_where, dynamic partition
# overwrite and overwrite_schema
cpu = TorchEngine("cpu")
d9 = d + "/modes"
write_table(d9, {"id": np.arange(30),
                 "p": np.array([f"p{i % 3}" for i in range(30)])},
            partition_by=["p"], engine=cpu)
write_table(d9, {"id": np.arange(30, 33), "p": np.array(["p0"] * 3),
                 "x": np.arange(3.0)}, merge_schema=True, engine=cpu)
write_table(d9, {"id": np.array([100]), "p": np.array(["p1"])},
            mode="overwrite", replace_where=col("p") == lit("p1"),
            engine=cpu)
write_table(d9, {"id": np.array([200]), "p": np.array(["p2"])},
            mode="overwrite", partition_overwrite_mode="dynamic", engine=cpu)
assert sorted(read_table(d9, engine=cpu).column("id").values.tolist()) \
    == list(range(0, 30, 3)) + [30, 31, 32, 100, 200]
write_table(d9, {"k": np.arange(4)}, mode="overwrite", overwrite_schema=True,
            engine=cpu)
assert read_table(d9, engine=cpu).column_names == ["k"]
# the maintenance commands: REORG PURGE of d5's DVs, VACUUM (a dry run,
# FULL, LITE), RESTORE of a vacuumed version refused, then forced, CLONE
import os, time
from delta_tpu_torch.commands.reorg import reorg_purge
from delta_tpu_torch.commands.restore import clone, restore
from delta_tpu_torch.errors import RestoreTargetError
delete(t5, col("k") < lit(5100))
assert reorg_purge(t5).num_files_removed == 1
old = time.time() - 7200
for root, _, files in os.walk(d5):
    for f in files:
        os.utime(os.path.join(root, f), (old, old))
dry = t5.vacuum(retention_hours=0, dry_run=True).files_deleted
assert dry and t5.vacuum(retention_hours=0).files_deleted == dry
assert t5.vacuum(retention_hours=0, vacuum_type="LITE").files_deleted == []
for shallow in (True, False):
    dst = d + f"/clone_{shallow}"
    clone(t5, dst, shallow=shallow)
    assert read_table(dst, engine=cpu).num_rows == 3950
try:
    restore(t5, version=1)
    raise AssertionError("restored a vacuumed version")
except RestoreTargetError as e:
    assert e.error_class == "DELTA_RESTORE_MISSING_DATA_FILE"
assert restore(t5, version=5, force=True).version == 8
# type widening, MERGE's schema evolution, CHECK constraints, generated,
# identity and default columns
from delta_tpu_torch.colgen import (default_field, generated_field,
                                    identity_field)
from delta_tpu_torch.commands.merge import merge
from delta_tpu_torch.constraints import add_constraint, drop_constraint
from delta_tpu_torch.models.schema import StructType
d10 = d + "/features"
write_table(d10, {"k": np.arange(5, dtype=np.int32)}, engine=cpu,
            properties={"delta.enableTypeWidening": "true"})
t10 = Table.for_path(d10, engine=cpu)
alter.change_column_type(t10, "k", "long")
add_constraint(t10, "pos", "k >= 0")
merge(t10, {"k": np.array([4, 1 << 40]), "x": np.array([1.0, 2.0])},
      on=col("target.k") == col("source.k")).with_schema_evolution() \
    .when_not_matched_insert_all().execute()
drop_constraint(t10, "pos")
d11 = d + "/generated"
write_table(d11, {"k": np.arange(3)}, engine=cpu, schema=StructType([
    identity_field("id", 10, -2), StructField("k", "long"),
    generated_field("g", "boolean", "k > 0"),
    default_field("c", "string", "'x'")]))
assert read_table(d11, engine=cpu).column("id").values.tolist() == [10, 8, 6]
# the change data feed on a mapped partitioned table
from delta_tpu_torch.read.cdc import table_changes
d12 = d + "/cdf"
write_table(d12, {"k": np.arange(20), "p": np.arange(20) % 2}, engine=cpu,
            partition_by=["p"],
            properties={"delta.enableChangeDataFeed": "true",
                        "delta.columnMapping.mode": "name"})
t12 = Table.for_path(d12, engine=cpu)
delete(t12, col("k") < lit(3))
update(t12, {"k": 100}, col("k") == lit(5))
merge(t12, {"k": np.array([7, 50]), "p": np.array([1, 0])},
      on=col("target.k") == col("source.k")).when_matched_delete() \
    .when_not_matched_insert_all().execute()
kinds = table_changes(t12, 1).column("_change_type").values.tolist()
assert sorted(kinds) == ["delete"] * 4 + ["insert", "update_postimage",
                                          "update_preimage"], kinds
# SQL: the TPC-DS generator and catalog, a query through `sql()` (joins,
# GROUP BY through K10's plain version, ORDER BY), a plain SELECT with
# time travel, DESCRIBE DETAIL, a DELETE and a refused construct
from delta_tpu_torch.errors import UnsupportedSqlError
from delta_tpu_torch.sql import sql
from delta_tpu_torch.utils.tpcds import QUERIES, load_delta
cat = load_delta(d + "/tpcds", scale=2000, engine=cpu)
assert sql(QUERIES["q3"], catalog=cat).names == [
    "d_year", "brand_id", "brand", "sum_agg"]
assert sql(QUERIES["q17"], catalog=cat).num_columns == 15
assert sql(f"select k from '{d12}' version as of 0", engine=cpu).num_rows == 20
assert sql("DESCRIBE DETAIL store_sales", catalog=cat)["numFiles"] >= 1
assert sql("DELETE FROM store_sales WHERE ss_quantity > 50",
           catalog=cat).num_rows_deleted > 0
try:
    sql("OPTIMIZE store_sales FULL", catalog=cat)
    raise AssertionError("OPTIMIZE ... FULL ran")
except UnsupportedSqlError:
    pass
banned = ("jax", "jaxlib", "pyarrow", "pandas", "delta_tpu", "benchmarks")
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in banned)))
"""


def test_snapshot_load_imports_no_jax_pyarrow_or_reference(tmp_path):
    out = subprocess.run([sys.executable, "-c", _PROBE, str(tmp_path)],
                         cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_REFERENCE_IMPORT = re.compile(r"\b(from|import)\s+delta_tpu(\.|\s|$)",
                               re.MULTILINE)


_BENCHMARKS_IMPORT = re.compile(r"\b(from|import)\s+benchmarks(\.|\s|$)",
                                re.MULTILINE)


def test_port_sources_name_no_jax_pyarrow_or_reference():
    sources = sorted((REPO / "delta_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) > 10
    names = {str(p.relative_to(REPO)) for p in sources}
    assert {"delta_tpu_torch/columnmapping.py", "delta_tpu_torch/colgen.py",
            "delta_tpu_torch/schema_evolution.py",
            "delta_tpu_torch/expressions/parser.py",
            "delta_tpu_torch/commands/alter.py",
            "delta_tpu_torch/commands/vacuum.py",
            "delta_tpu_torch/commands/reorg.py",
            "delta_tpu_torch/commands/restore.py",
            "delta_tpu_torch/constraints.py",
            "delta_tpu_torch/read/cdc.py", "delta_tpu_torch/sql.py",
            "delta_tpu_torch/catalog.py",
            "delta_tpu_torch/sqlengine/executor.py",
            "delta_tpu_torch/sqlengine/device.py",
            "delta_tpu_torch/ops/sqlops.py", "delta_tpu_torch/ops/segagg.py",
            "delta_tpu_torch/utils/tpcds.py"} <= names
    for src in sources:
        text = src.read_text()
        name = src.relative_to(REPO)
        for word in ("import jax", "from jax", "pyarrow", "pandas"):
            assert word not in text, f"{name} contains {word!r}"
        # `delta_tpu_torch.` is the port itself; `delta_tpu.` is not
        assert not _REFERENCE_IMPORT.search(text), f"{name} imports delta_tpu"
        assert not _BENCHMARKS_IMPORT.search(text), \
            f"{name} imports benchmarks"

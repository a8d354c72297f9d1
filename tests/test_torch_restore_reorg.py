"""REORG PURGE, RESTORE and CLONE: the port's `commands/reorg.py` and
`commands/restore.py` against the JAX package's.

The reference (`delta_tpu.api`, `HostEngine`) writes each table and runs
the commands that shape it; the table is copied, and each package's
command runs on its own copy (`TorchEngine("cpu")` for the port).
Compared, exactly: the returned metrics (but the bytes each writer
writes), the commit's operation, parameters and metrics, every add and
remove by path (a file the command wrote counts as new), dataChange and
DV cardinality, the metadata, the errors' classes, and the rows each
package reads from its copy.

REORG: DV tables plain, partitioned and name-mapped (the rewritten files
hold the physical names), no DV (no commit), the rewrite-all variant.
RESTORE: to a version across a DV DELETE and a schema overwrite, to a
timestamp, the timestamp and argument errors, a file VACUUM deleted
(refused, then forced). CLONE: shallow and deep, of a DV table and a
partitioned one; VACUUM of a shallow clone leaves the source's files; a
deep clone outlives its source; an existing table or a non-empty
directory refused.

C21 (`_REFERENCE_CLONE_LOSES_DVS`): the reference's shallow clone keeps a
'u' DV descriptor, which resolves under the clone's root, so its read of
the clone raises; the port writes a 'p' descriptor naming the source's
DV file.
"""

import json
import os
import shutil
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.reorg as ref_reorg
import delta_tpu.commands.restore as ref_restore
import delta_tpu.expressions.tree as RE
from delta_tpu.commands.vacuum import vacuum as ref_vacuum
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefError
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.api as pta
import delta_tpu_torch.commands.reorg as port_reorg
import delta_tpu_torch.commands.restore as port_restore
from delta_tpu_torch import Table, TorchEngine
from delta_tpu_torch.commands.vacuum import vacuum as port_vacuum
from delta_tpu_torch.errors import DeltaError
from test_torch_vacuum import _age, _copies
from test_torch_wide_types import port_rows, same_rows
from test_torch_wide_write import ref_rows

CPU = TorchEngine("cpu")
DV = {"delta.enableDeletionVectors": "true"}
NAME = {"delta.columnMapping.mode": "name"}

# the reference's shallow clone keeps 'u' DV descriptors, which then
# resolve under the clone's root (ROADMAP C21)
_REFERENCE_CLONE_LOSES_DVS = True


# ------------------------------------------------------------ helpers --

def _data(lo: int, n: int, part: bool = False) -> pa.Table:
    k = np.arange(lo, lo + n)
    cols = {"k": pa.array(k, pa.int64()),
            "v": pa.array((k * 5 % 11).astype(float)),
            "s": pa.array([f"s{j % 4}" for j in k], mask=k % 7 == 3)}
    if part:
        cols["p"] = pa.array([("a", "b")[j % 2] for j in k])
    return pa.table(cols)


def _ref(path: str) -> RefTable:
    clear_parse_cache()
    return RefTable.for_path(path, engine=HostEngine())


def _port(path: str) -> Table:
    return Table.for_path(path, engine=CPU)


def _source(tmp_path, props=None, part=False, rows=(20, 20, 20),
            deletes=True) -> str:
    src = str(tmp_path / "src")
    lo = 0
    for i, n in enumerate(rows):
        dta.write_table(src, _data(lo, n, part), engine=HostEngine(),
                        properties=props if i == 0 else None,
                        partition_by=["p"] if part else None)
        lo += n
    if deletes:
        ref_dml.delete(_ref(src), RE.col("k") < RE.lit(3))
        ref_dml.delete(_ref(src), RE.col("k") > RE.lit(55))
    return src


def _version(path: str) -> int:
    log = os.path.join(path, "_delta_log")
    return max(int(n[:20]) for n in os.listdir(log)
               if n.endswith(".json") and n[:20].isdigit())


def _commit(path: str, version: int) -> dict:
    out = {"add": [], "remove": []}
    name = os.path.join(path, "_delta_log", f"{version:020d}.json")
    with open(name) as f:
        for line in f:
            if line.strip():
                (k, v), = json.loads(line).items()
                out.setdefault(k, []).append(v)
    return out


def _summary(path: str, version: int, known: set, root: str = None) -> tuple:
    """The commit's operation, parameters, metrics (bytes aside) and each
    add and remove as (path, or "<new>" for a file the command wrote;
    dataChange; DV cardinality); absolute paths under `root` made
    relative."""
    c = _commit(path, version)
    info = c["commitInfo"][0]
    metrics = {k: v for k, v in info["operationMetrics"].items()
               if "Bytes" not in k}

    def key(a):
        p = a["path"]
        if root is not None and p.startswith(root + "/"):
            p = p[len(root) + 1:]
        dv = a.get("deletionVector")
        return (p if p in known else "<new>", a["dataChange"],
                dv["cardinality"] if dv else None)

    return (info["operation"], info["operationParameters"], metrics,
            sorted(map(key, c["add"]), key=repr),
            sorted(map(key, c["remove"]), key=repr))


def _known(path: str) -> set:
    """Every data file path the table's log has named so far."""
    out = set()
    for v in range(_version(path) + 1):
        c = _commit(path, v)
        out |= {a["path"] for a in c["add"] + c["remove"]}
    return out


def _port_read(path: str) -> list:
    return port_rows(pta.read_table(path, engine=CPU))


def _errors(ref_call, port_call) -> tuple:
    with pytest.raises(RefError) as r:
        ref_call()
    with pytest.raises(DeltaError) as p:
        port_call()
    return r.value.error_class, p.value.error_class


# -------------------------------------------------------------- REORG --

REORG_KINDS = {"plain": (DV, False), "partitioned": (DV, True),
               "mapped": ({**DV, **NAME}, False)}


@pytest.mark.parametrize("kind", list(REORG_KINDS))
def test_reorg_purge(tmp_path, kind):
    props, part = REORG_KINDS[kind]
    src = _source(tmp_path, props, part)
    ref, port = _copies(tmp_path, src)
    known = _known(src)
    before = ref_rows(ref)
    rm = ref_reorg.reorg_purge(_ref(ref))
    pm = port_reorg.reorg_purge(_port(port))
    assert (pm.num_files_added, pm.num_files_removed, pm.bytes_removed,
            pm.version) == (rm.num_files_added, rm.num_files_removed,
                            rm.bytes_removed, rm.version)
    assert pm.num_files_removed > 0
    assert _summary(port, pm.version, known) == _summary(ref, rm.version,
                                                         known)
    assert _summary(port, pm.version, known)[1] == {"applyPurge": True}
    state = _port(port).latest_snapshot().state
    assert all(a.deletionVector is None for a in state.add_files)
    assert same_rows(_port_read(port), before)
    assert same_rows(ref_rows(ref), before)
    # the reference reads the port's rewritten files, and the reverse
    assert same_rows(ref_rows(port), before)
    assert same_rows(_port_read(ref), before)
    if kind == "mapped":
        snap = _port(port).latest_snapshot()
        physical = {f.physical_name for f in snap.schema.fields}
        for a in _commit(port, pm.version)["add"]:
            names = set(pq.read_schema(os.path.join(port, a["path"])).names)
            assert names <= physical and all(n.startswith("col-")
                                             for n in names)


def test_reorg_purge_without_dvs_commits_nothing(tmp_path):
    src = _source(tmp_path, deletes=False)
    ref, port = _copies(tmp_path, src)
    rm = ref_reorg.reorg_purge(_ref(ref))
    pm = port_reorg.reorg_purge(_port(port))
    assert pm.version is None and rm.version is None
    assert pm.num_files_removed == rm.num_files_removed == 0
    assert _version(port) == _version(ref) == 2


def test_reorg_rewrite_all(tmp_path):
    src = _source(tmp_path, DV, part=True)
    ref, port = _copies(tmp_path, src)
    known = _known(src)
    before = ref_rows(ref)
    rm = ref_reorg.reorg_rewrite_all(_ref(ref))
    pm = port_reorg.reorg_rewrite_all(_port(port))
    assert (pm.num_files_added, pm.num_files_removed, pm.version) == (
        rm.num_files_added, rm.num_files_removed, rm.version)
    assert _summary(port, pm.version, known) == _summary(ref, rm.version,
                                                         known)
    assert same_rows(_port_read(port), before)


# ------------------------------------------------------------ RESTORE --

def _history_table(tmp_path) -> str:
    """v0-v2 appends, v3-v4 DV DELETEs, v5 an overwrite without column s,
    v6 an append."""
    src = _source(tmp_path, DV)
    data = _data(100, 10).drop(["s"])
    dta.write_table(src, data, mode="overwrite", overwrite_schema=True,
                    engine=HostEngine())
    dta.write_table(src, _data(200, 5).drop(["s"]), engine=HostEngine())
    return src


@pytest.mark.parametrize("version", [1, 3, 4])
def test_restore_to_version(tmp_path, version):
    src = _history_table(tmp_path)
    ref, port = _copies(tmp_path, src)
    known = _known(src)
    clear_parse_cache()
    want = dta.read_table(ref, version=version,
                          engine=HostEngine()).to_pylist()
    rm = ref_restore.restore(_ref(ref), version=version)
    pm = port_restore.restore(_port(port), version=version)
    assert (pm.num_restored_files, pm.num_removed_files, pm.version) == (
        rm.num_restored_files, rm.num_removed_files, rm.version)
    assert _summary(port, pm.version, known) == _summary(ref, rm.version,
                                                         known)
    assert _summary(port, pm.version, known)[1] == {"version": version,
                                                    "timestamp": None}
    rmeta = _ref(ref).latest_snapshot().metadata
    pmeta = _port(port).latest_snapshot().metadata
    assert (pmeta.schemaString, pmeta.partitionColumns,
            pmeta.configuration) == (rmeta.schemaString,
                                     rmeta.partitionColumns,
                                     rmeta.configuration)
    assert "metaData" in _commit(port, pm.version)
    assert same_rows(_port_read(port), want)
    assert same_rows(ref_rows(ref), want)


def _stamp_commits(path: str, t0: float) -> None:
    """Commit v's mtime set to t0 + 60 s * v."""
    log = os.path.join(path, "_delta_log")
    for v in range(_version(path) + 1):
        t = t0 + 60 * v
        os.utime(os.path.join(log, f"{v:020d}.json"), (t, t))


def test_restore_to_timestamp_and_its_errors(tmp_path):
    src = _history_table(tmp_path)
    ref, port = _copies(tmp_path, src)
    t0 = time.time() - 86_400
    for root in (ref, port):
        _stamp_commits(root, t0)
    ms = int((t0 + 60 * 2 + 30) * 1000)   # after v2, before v3
    rm = ref_restore.restore(_ref(ref), timestamp_ms=ms)
    pm = port_restore.restore(_port(port), timestamp_ms=ms)
    assert (pm.num_restored_files, pm.num_removed_files, pm.version) == (
        rm.num_restored_files, rm.num_removed_files, rm.version)
    known = _known(src)
    assert _summary(port, pm.version, known) == _summary(ref, rm.version,
                                                         known)
    assert same_rows(_port_read(port), ref_rows(ref))
    head = _version(port)
    for kw, cls in (({"timestamp_ms": int((t0 - 60) * 1000)},
                     "DELTA_CANNOT_RESTORE_TIMESTAMP_EARLIER"),
                    ({"timestamp_ms": int(time.time() * 1000) + 86_400_000},
                     "DELTA_CANNOT_RESTORE_TIMESTAMP_GREATER"),
                    ({}, "DELTA_ONEOF_IN_TIMETRAVEL"),
                    ({"version": 1, "timestamp_ms": ms},
                     "DELTA_ONEOF_IN_TIMETRAVEL")):
        assert _errors(lambda: ref_restore.restore(_ref(ref), **kw),
                       lambda: port_restore.restore(_port(port), **kw)) \
            == (cls, cls)
    assert _version(port) == _version(ref) == head


def test_restore_of_vacuumed_files(tmp_path):
    src = _source(tmp_path, rows=(20, 20, 20), deletes=False)
    ref_dml.delete(_ref(src), RE.col("k") < RE.lit(25))  # copy-on-write
    _age(src)
    ref, port = _copies(tmp_path, src)
    ref_vacuum(_ref(ref), retention_hours=0)
    port_vacuum(_port(port), retention_hours=0)
    head = _version(port)
    assert _errors(lambda: ref_restore.restore(_ref(ref), version=1),
                   lambda: port_restore.restore(_port(port), version=1)) \
        == ("DELTA_RESTORE_MISSING_DATA_FILE",) * 2
    assert _version(port) == _version(ref) == head
    rm = ref_restore.restore(_ref(ref), version=1, force=True)
    pm = port_restore.restore(_port(port), version=1, force=True)
    assert (pm.num_restored_files, pm.num_removed_files, pm.version) == (
        rm.num_restored_files, rm.num_removed_files, rm.version)
    known = _known(src)
    assert _summary(port, pm.version, known) == _summary(ref, rm.version,
                                                         known)


# -------------------------------------------------------------- CLONE --

@pytest.mark.parametrize("part", [False, True])
def test_shallow_clone(tmp_path, part):
    src = _source(tmp_path, DV, part)
    ref, port = _copies(tmp_path, src)
    before = ref_rows(ref)
    known = _known(src)
    rdst, pdst = str(tmp_path / "ref_clone"), str(tmp_path / "port_clone")
    assert ref_restore.clone(_ref(ref), rdst) \
        == port_restore.clone(_port(port), pdst) == 0
    rs, ps = _summary(rdst, 0, known, ref), _summary(pdst, 0, known, port)
    assert rs[1].pop("source") == ref and ps[1].pop("source") == port
    assert ps == rs and ps[1] == {"sourceVersion": 4, "isShallow": True}
    assert all(os.path.isabs(a["path"]) for a in _commit(pdst, 0)["add"])
    pmeta = _port(pdst).latest_snapshot().metadata
    rmeta = _ref(rdst).latest_snapshot().metadata
    assert (pmeta.schemaString, pmeta.partitionColumns,
            pmeta.configuration) == (rmeta.schemaString,
                                     rmeta.partitionColumns,
                                     rmeta.configuration)
    dvs = [a["deletionVector"] for a in _commit(pdst, 0)["add"]
           if a.get("deletionVector")]
    assert dvs and all(d["storageType"] == "p" and
                       d["pathOrInlineDv"].startswith(port + "/")
                       for d in dvs)
    assert same_rows(_port_read(pdst), before)
    if _REFERENCE_CLONE_LOSES_DVS:
        with pytest.raises(FileNotFoundError):
            ref_rows(rdst)
    else:
        assert same_rows(ref_rows(rdst), before)
    # VACUUM of the clone touches none of the source's files
    files = sorted(os.listdir(port))
    _age(pdst)
    assert port_vacuum(_port(pdst), retention_hours=0).files_deleted == []
    assert sorted(os.listdir(port)) == files
    assert same_rows(_port_read(pdst), before)


def test_deep_clone(tmp_path):
    src = _source(tmp_path, DV, part=True)
    ref, port = _copies(tmp_path, src)
    before = ref_rows(ref)
    known = _known(src)
    rdst, pdst = str(tmp_path / "ref_clone"), str(tmp_path / "port_clone")
    ref_restore.clone(_ref(ref), rdst, shallow=False)
    port_restore.clone(_port(port), pdst, shallow=False)
    rs, ps = _summary(rdst, 0, known), _summary(pdst, 0, known)
    assert rs[1].pop("source") == ref and ps[1].pop("source") == port
    assert ps == rs and ps[1]["isShallow"] is False

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs
                      if "_delta_log" not in d)

    assert files(pdst) == files(rdst)
    shutil.rmtree(port)
    shutil.rmtree(ref)
    assert same_rows(_port_read(pdst), before)
    assert same_rows(ref_rows(rdst), before)


def test_clone_refusals(tmp_path):
    src = _source(tmp_path, deletes=False)
    ref, port = _copies(tmp_path, src)
    # an existing table
    assert _errors(lambda: ref_restore.clone(_ref(ref), port),
                   lambda: port_restore.clone(_port(port), ref)) \
        == ("DELTA_CLONE_AMBIGUOUS_TARGET",) * 2
    # a directory holding a file
    busy = tmp_path / "busy"
    busy.mkdir()
    (busy / "x.txt").write_text("x")
    assert _errors(lambda: ref_restore.clone(_ref(ref), str(busy)),
                   lambda: port_restore.clone(_port(port), str(busy))) \
        == ("DELTA_UNSUPPORTED_NON_EMPTY_CLONE",) * 2
    # an empty directory is a fine target
    (tmp_path / "empty").mkdir()
    assert port_restore.clone(_port(port), str(tmp_path / "empty")) == 0

"""The change data feed: the port's CDC files (`commands/dml.py`,
`commands/merge.py`, `api.write_table`) and its `read/cdc.py::
table_changes` against the JAX package's, on copies of one
reference-written table.

The reference (`delta_tpu.api.write_table`, `HostEngine`) writes a table
of three appends (k int64, x float64 from k, s string with nulls, p int64
in 0..2) with the feed on; it is copied, the reference's command runs on
one copy and the port's (`TorchEngine("cpu")`: every kernel's plain
version) on the other. Each package's feed of its own copy is compared
per (`_commit_version`, `_change_type`) as a multiset of rows (floats
exact); each package also reads the other's copy. Table kinds: plain,
deletion vectors, partitioned by p, and name-mode column mapping
partitioned by p.

Commands: DELETE (a file removed whole, a deletion vector, copy-on-write,
no predicate), UPDATE, MERGE (every clause kind, with and without schema
evolution), `replace_where`, append, overwrite, dynamic partition
overwrite, RESTORE. Also: every error class, the alias
`delta.enableChangeDataCapture`, the feed turned on at creation and by
ALTER, timestamp bounds, a missing commit and a vacuumed file, the load
of logs with `cdc` lines (the device-parse twin and the host parse), a
checkpoint and a compacted delta (no `cdc` action), VACUUM FULL and LITE
of expired change data files.

Pinned differences (ROADMAP):
- C25 (`_REFERENCE_FEEDS_DELETED_ROWS`): the reference's feed of a
  commit without change data reads the removed and added files without
  their deletion vectors, so rows a DV had deleted come back; the port
  applies them.
- C26 (`_REFERENCE_CDC_FORM`): the reference's change data files hold the
  partition columns under logical names, `partitionValues` `{}`; the port
  writes Delta's form (partition directories under `_change_data/`,
  physical names) and reads both. The reference reads the port's files
  as they stand: the partition column missing, physical names.
- C27 (`_REFERENCE_DROPS_NMBS_UPDATE_IMAGES`): the reference's MERGE writes
  no update images for a not-matched-by-source update; the port writes
  them, as Delta does.
- C28 (`_REFERENCE_RAISES_FOR_VACUUMED_FILES`): the reference means to
  skip a removed file that was vacuumed, but its read raises
  `FileNotFoundInLogError`, which it does not catch; the port skips it.
"""

import glob
import os
import shutil
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import delta_tpu.api as dta
import delta_tpu.commands.alter as ref_alter
import delta_tpu.commands.dml as ref_dml
import delta_tpu.commands.merge as ref_merge
import delta_tpu.commands.optimize as ref_opt  # noqa: F401 (Table.optimize)
import delta_tpu.commands.restore as ref_restore
import delta_tpu.expressions.tree as RE
from delta_tpu.commands.vacuum import vacuum as ref_vacuum
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefError
from delta_tpu.log.cleanup import write_compacted_delta as ref_compact
from delta_tpu.read.cdc import table_changes as ref_changes
from delta_tpu.replay.columnar import clear_parse_cache
from delta_tpu.table import Table as RefTable
import delta_tpu_torch.api as pta
import delta_tpu_torch.commands.alter as port_alter
import delta_tpu_torch.commands.dml as port_dml
import delta_tpu_torch.commands.merge as port_merge
import delta_tpu_torch.commands.restore as port_restore
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.commands.vacuum import vacuum as port_vacuum
from delta_tpu_torch.errors import (
    CdcNotEnabledError,
    DeltaError,
    InvalidArgumentError,
)
from delta_tpu_torch.log.cleanup import write_compacted_delta
from delta_tpu_torch.read.cdc import table_changes
from delta_tpu_torch.replay import device_parse
from test_torch_checkpoint import assert_matches_reference
from test_torch_wide_types import port_rows
from test_torch_wide_write import to_port

CPU = TorchEngine("cpu")
CDF = {"delta.enableChangeDataFeed": "true"}
DV = {"delta.enableDeletionVectors": "true"}
NAME = {"delta.columnMapping.mode": "name"}
KINDS = {"plain": ({}, None), "dv": (DV, None),
         "partitioned": ({}, ["p"]), "name": (NAME, ["p"])}
META = ("_commit_version", "_change_type")

# C25: the reference's synthesized feed reads files without their DVs
_REFERENCE_FEEDS_DELETED_ROWS = True
# C26: the reference's CDC files: partition columns inside, logical names,
# partitionValues {}
_REFERENCE_CDC_FORM = True
# C27: the reference's MERGE writes no images of a not-matched-by-source
# update
_REFERENCE_DROPS_NMBS_UPDATE_IMAGES = True
# C28: the reference's synthesized feed raises for a vacuumed removed file
_REFERENCE_RAISES_FOR_VACUUMED_FILES = True


# ------------------------------------------------------------ helpers --

def _data(lo: int, n: int) -> pa.Table:
    k = np.arange(lo, lo + n)
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "x": pa.array(k * 1.25),
        "s": pa.array([f"s{j % 7}" for j in k], mask=k % 9 == 4),
        "p": pa.array(k // 7 % 3, pa.int64())})


def _make(tmp_path, kind: str, props=CDF, rows=(40, 40, 40)) -> tuple:
    """The reference writes one table of `kind` (appends of `rows`);
    returns the paths of its two copies (ref, port)."""
    extra, part = KINDS[kind]
    src = str(tmp_path / "src")
    lo = 0
    for i, n in enumerate(rows):
        dta.write_table(src, _data(lo, n), engine=HostEngine(),
                        partition_by=part,
                        properties=dict(props, **extra) if i == 0 else None)
        lo += n
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    return ref, port


def _ref(path: str) -> RefTable:
    clear_parse_cache()
    return RefTable.for_path(path, engine=HostEngine())


def _port(path: str) -> Table:
    return Table.for_path(path, engine=CPU)


def _ref_feed(path: str, start=0, end=None, **kw) -> pa.Table:
    return ref_changes(_ref(path), start, end, **kw)


def _port_feed(path: str, start=0, end=None, **kw):
    return table_changes(_port(path), start, end, **kw)


def _key(row: dict) -> tuple:
    return tuple(sorted((k, repr(v)) for k, v in row.items()
                        if k not in ("_commit_timestamp",) + META))


def _by_change(rows: list) -> dict:
    """{(version, change type): sorted row keys}."""
    out: dict = {}
    for r in rows:
        out.setdefault((r["_commit_version"], r["_change_type"]),
                       []).append(_key(r))
    return {k: sorted(v) for k, v in out.items()}


def ref_changes_of(path: str, start=0, end=None, **kw) -> dict:
    return _by_change(_ref_feed(path, start, end, **kw).to_pylist())


def port_changes_of(path: str, start=0, end=None, **kw) -> dict:
    return _by_change(port_rows(_port_feed(path, start, end, **kw)))


def _version(path: str) -> int:
    return max(int(os.path.basename(n)[:20]) for n in glob.glob(
        os.path.join(path, "_delta_log", "*.json")))


def _actions(path: str, version: int, kind: str) -> list:
    import json

    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        return [json.loads(x)[kind] for x in f
                if x.strip() and kind in json.loads(x)]


def _check_form(ref: str, port: str, kind: str, version: int) -> None:
    """C26: the port's change data files in Delta's form, the
    reference's in its own."""
    cdcs = _actions(port, version, "cdc")
    assert cdcs and all(not c["dataChange"] for c in cdcs)
    snap = _port(port).latest_snapshot()
    mapped = kind == "name"
    for c in cdcs:
        path = os.path.join(port, c["path"])
        names = pq.read_schema(path).names
        assert c["path"].startswith("_change_data/")
        assert names[-1] == "_change_type"
        if KINDS[kind][1]:
            key = snap.schema["p"].physical_name if mapped else "p"
            assert list(c["partitionValues"]) == [key]
            assert c["path"].startswith(
                f"_change_data/{key}={c['partitionValues'][key]}/")
            assert "p" not in names and key not in names
        else:
            assert c["partitionValues"] == {}
        if mapped:
            assert all(n.startswith("col-") for n in names[:-1])
    assert _REFERENCE_CDC_FORM and all(
        c["partitionValues"] == {} for c in _actions(ref, version, "cdc"))


def _both_feeds_equal(ref: str, port: str, kind: str) -> dict:
    """The port's feed of its copy equals the reference's of its own; the
    port reads the reference's copy as the reference does; the reference
    reads the port's copy as the port does, but where C26 makes it
    differ. Returns the port's feed."""
    want = ref_changes_of(ref)
    got = port_changes_of(port)
    assert got == want
    assert port_changes_of(ref) == want
    cross = ref_changes_of(port)
    served = {v for v in range(_version(port) + 1)
              if _actions(port, v, "cdc")}
    if kind in ("plain", "dv") or not served:
        assert cross == got
    else:
        # the port's files as they stand: the partition column missing,
        # physical names, which the reference's permissive concatenation
        # then gives every other row as nulls
        assert _REFERENCE_CDC_FORM
        names = {c for rows in got.values() for r in rows for c, _ in r}

        def logical(rows):
            return sorted(tuple(x for x in r if x[0] in names)
                          for r in rows)

        assert {k: logical(v) for k, v in cross.items()
                if k[0] not in served} == \
            {k: v for k, v in got.items() if k[0] not in served}
        for k, rows in cross.items():
            if k[0] in served:
                assert len(rows) == len(got[k]) and logical(rows) != got[k]
    return got


def _both(ref: str, port: str, run) -> None:
    """`run(module-set)` on each copy: (dml, merge, api, restore, alter, E,
    table) per package."""
    run(ref_dml, ref_merge, dta, ref_restore, ref_alter, RE, _ref(ref),
        HostEngine())
    run(port_dml, port_merge, pta, port_restore, port_alter, PE,
        _port(port), CPU)


# ---------------------------------------------------------- DML cases --

def _delete(pred):
    def run(dml, merge, api, restore, alter, E, t, eng):
        dml.delete(t, pred(E))
    return run


_DML = {
    "delete_whole_files": _delete(lambda E: E.col("k") < E.lit(40)),
    "delete_rows": _delete(lambda E: E.col("k").is_in(*range(1, 120, 4))),
    "delete_everything": _delete(lambda E: None),
    "update": lambda dml, merge, api, restore, alter, E, t, eng: dml.update(
        t, {"x": E.col("k"), "s": "updated"},
        E.col("k").is_in(*range(0, 120, 5))),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("command", list(_DML))
def test_dml_feed_equals_the_references(tmp_path, kind, command):
    ref, port = _make(tmp_path, kind)
    _both(ref, port, _DML[command])
    v = _version(port)
    assert v == _version(ref) == 3
    got = _both_feeds_equal(ref, port, kind)
    if command == "delete_everything":
        # no change data: the feed is made from the removes
        assert not _actions(port, v, "cdc") and not _actions(ref, v, "cdc")
        assert sum(len(r) for k, r in got.items() if k[0] == v) == 120
        return
    _check_form(ref, port, kind, v)
    kinds = {k[1] for k in got if k[0] == v}
    assert kinds == ({"update_preimage", "update_postimage"}
                     if command == "update" else {"delete"})
    if command == "delete_rows":
        adds = _actions(port, v, "add")
        assert (any(a.get("deletionVector") for a in adds)
                == (kind == "dv"))


def test_dml_over_deletion_vectors_c25(tmp_path):
    """The reference caveat (ROADMAP C25): on 10 rows with DVs, a DELETE
    of k < 3 writes a DV and change data; a DELETE of every row writes
    none, and its feed is 7 deletes in the port (the DV applied), 10 in
    the reference."""
    src = str(tmp_path / "src")
    dta.write_table(src, _data(0, 10), engine=HostEngine(),
                    properties=dict(CDF, **DV))
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    _both(ref, port, _delete(lambda E: E.col("k") < E.lit(3)))
    _both(ref, port, _delete(lambda E: None))
    assert _actions(port, 1, "cdc") and not _actions(port, 2, "cdc")
    got = port_changes_of(port, 2, 2)
    assert list(got) == [(2, "delete")] and len(got[(2, "delete")]) == 7
    assert port_changes_of(ref, 2, 2) == got
    want = ref_changes_of(ref, 2, 2)
    assert _REFERENCE_FEEDS_DELETED_ROWS and len(want[(2, "delete")]) == 10
    assert set(got[(2, "delete")]) < set(want[(2, "delete")])
    # version 1's change data agrees
    assert port_changes_of(port, 1, 1) == ref_changes_of(ref, 1, 1)


# -------------------------------------------------------- MERGE cases --

def _merge_source(E_is_port: bool, evolve: bool):
    k = np.array([2, 3, 9, 60, 61, 200, 201], np.int64)
    cols = {"k": k, "x": k * 10.0,
            "op": np.array(["upd", "del", "upd", "del", "upd", "ins",
                            "ins"], object)}
    if evolve:
        cols["note"] = np.array([f"n{j}" for j in k], object)
    tbl = pa.table({c: pa.array(v.tolist()) for c, v in cols.items()})
    if not E_is_port:
        return tbl
    return to_port(tbl)


def _merge(evolve: bool):
    def run(dml, merge, api, restore, alter, E, t, eng):
        b = merge.merge(t, _merge_source(E is PE, evolve),
                        on=E.col("target.k") == E.col("source.k"))
        if evolve:
            b = b.with_schema_evolution()
        (b.when_matched_update(
            set=dict({"x": E.col("source.x")},
                     **({"note": E.col("source.note")} if evolve else {})),
            condition=E.col("source.op") == E.lit("upd"))
         .when_matched_delete()
         .when_not_matched_insert(values=dict(
             {"k": E.col("source.k"), "x": E.col("source.x"),
              "s": E.lit("new"), "p": E.lit(1)},
             **({"note": E.col("source.note")} if evolve else {})))
         .when_not_matched_by_source_update(
             set={"s": E.lit("stale")},
             condition=E.col("target.k") < E.lit(12))
         .when_not_matched_by_source_delete(
             condition=E.col("target.k") >= E.lit(110))
         .execute())
    return run


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("evolve", [False, True], ids=["fixed", "evolve"])
def test_merge_feed_equals_the_references(tmp_path, kind, evolve):
    ref, port = _make(tmp_path, kind)
    _both(ref, port, _merge(evolve))
    v = _version(port)
    _check_form(ref, port, kind, v)
    got = port_changes_of(port)
    want = ref_changes_of(ref)
    # C27: the reference drops the images of the not-matched-by-source
    # update (k 0, 1, 4..8, 10, 11: 'stale')
    nmbs = {0, 1, 4, 5, 6, 7, 8, 10, 11}

    def k_of(row):
        return int(dict(row)["k"])

    for t in ("update_preimage", "update_postimage"):
        mine = got[(v, t)]
        assert _REFERENCE_DROPS_NMBS_UPDATE_IMAGES
        assert [r for r in mine if k_of(r) not in nmbs] == want[(v, t)]
        assert {k_of(r) for r in mine if k_of(r) in nmbs} == nmbs
    post = [dict(r) for r in got[(v, "update_postimage")]]
    assert all(r["s"] == repr("stale") for r in post if int(r["k"]) in nmbs)
    rest = {k: r for k, r in got.items()
            if k[1] not in ("update_preimage", "update_postimage")}
    assert rest == {k: r for k, r in want.items()
                    if k[1] not in ("update_preimage", "update_postimage")}
    assert sorted(int(dict(r)["k"]) for r in got[(v, "delete")]) == \
        [3, 60] + list(range(110, 120))
    assert sorted(int(dict(r)["k"]) for r in got[(v, "insert")]) == [200,
                                                                    201]
    if evolve:
        # rows written before the evolution read the new column as null
        pre = [dict(r) for r in got[(v, "update_preimage")]]
        assert all(r["note"] == "None" for r in pre)
    assert port_changes_of(ref) == want


# -------------------------------------------------- write-mode cases --

def _write(mode: str, **kw):
    def run(dml, merge, api, restore, alter, E, t, eng):
        data = _data(1000, 21)
        if "replace_where" in kw:
            data = _data(100, 20)
        opts = {k: (v(E) if callable(v) else v) for k, v in kw.items()}
        api.write_table(t.path, data if eng.__class__ is HostEngine
                        else to_port(data), mode=mode, engine=eng, **opts)
    return run


_WRITES = {
    "append": _write("append"),
    "overwrite": _write("overwrite"),
    "replace_where": _write("overwrite", replace_where=lambda E: E.col(
        "k") >= E.lit(100)),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("write", list(_WRITES) + ["dynamic"])
def test_write_mode_feed_equals_the_references(tmp_path, kind, write):
    if write == "dynamic":
        kind = "partitioned" if kind in ("plain", "dv") else kind
        run = _write("overwrite", partition_overwrite_mode="dynamic")
    else:
        run = _WRITES[write]
    ref, port = _make(tmp_path, kind)
    _both(ref, port, run)
    v = _version(port)
    got = _both_feeds_equal(ref, port, kind)
    if write == "replace_where":
        _check_form(ref, port, kind, v)
        assert {k[1] for k in got if k[0] == v} == {"delete", "insert"}
        assert len(got[(v, "insert")]) == 20
        assert len(got[(v, "delete")]) == 20
    else:
        # no change data: inserts from the adds, deletes from the removes
        assert not _actions(port, v, "cdc")
        assert len(got[(v, "insert")]) == 21


def test_restore_feed_is_made_from_its_actions(tmp_path):
    """RESTORE writes no change data: its feed is made from its removes
    and adds, the DVs applied (C25: the reference's includes the rows a
    DV had deleted)."""
    ref, port = _make(tmp_path, "dv")
    _both(ref, port, _delete(lambda E: E.col("k").is_in(*range(0, 120, 3))))
    _both(ref, port, _delete(lambda E: E.col("k") >= E.lit(100)))

    def restore(dml, merge, api, restore, alter, E, t, eng):
        restore.restore(t, version=3)
    _both(ref, port, restore)
    v = _version(port)
    assert v == 5 and not _actions(port, v, "cdc")
    got = port_changes_of(port, v, v)
    assert port_changes_of(ref, v, v) == got
    # the rows of k >= 100 come back as inserts; the files removed and
    # re-added net to exactly that
    ins = [int(dict(r)["k"]) for r in got[(v, "insert")]]
    dels = [int(dict(r)["k"]) for r in got.get((v, "delete"), [])]
    back = sorted(set(ins) - set(dels))
    assert back == [k for k in range(100, 120) if k % 3]
    want = ref_changes_of(ref, v, v)
    assert _REFERENCE_FEEDS_DELETED_ROWS and sum(
        len(r) for r in want.values()) > sum(len(r) for r in got.values())
    # the other versions agree
    assert port_changes_of(port, 0, v - 1) == ref_changes_of(ref, 0, v - 1)


# ------------------------------------------------ errors and bounds --

def _error_class(fn):
    try:
        fn()
    except (RefError, DeltaError) as e:
        return type(e).__name__, e.error_class
    return None


@pytest.mark.parametrize("case", [
    "two_starts", "two_ends", "no_start", "disabled", "inverted",
    "missing_change_data"])
def test_errors_equal_the_references(tmp_path, case):
    props = {} if case in ("disabled", "missing_change_data") else CDF
    ref, port = _make(tmp_path, "plain", props=props)
    if case == "missing_change_data":
        for path in (ref, port):
            (ref_alter if path == ref else port_alter).set_properties(
                _ref(path) if path == ref else _port(path), CDF)
    args = {"two_starts": dict(starting_version=0, starting_timestamp=1),
            "two_ends": dict(starting_version=0, ending_version=1,
                             ending_timestamp=1),
            "no_start": {}, "disabled": dict(starting_version=0),
            "inverted": dict(starting_version=2, ending_version=1),
            "missing_change_data": dict(starting_version=1)}[case]
    r = _error_class(lambda: ref_changes(_ref(ref), **args))
    p = _error_class(lambda: table_changes(_port(port), **args))
    assert r is not None and r[1] == p[1]
    assert p[0] == {"disabled": "CdcNotEnabledError"}.get(
        case, "InvalidArgumentError")
    if case == "missing_change_data":
        # from the version that turned the feed on, the range is covered
        assert port_changes_of(port, 3) == ref_changes_of(ref, 3) == {}


def test_errors_are_typed():
    assert issubclass(CdcNotEnabledError, DeltaError)
    assert CdcNotEnabledError.error_class == "DELTA_CHANGE_TABLE_FEED_DISABLED"
    assert InvalidArgumentError.error_class != \
        CdcNotEnabledError.error_class


def test_timestamp_bounds_give_the_version_bounds_rows(tmp_path):
    ref, port = _make(tmp_path, "dv")
    _both(ref, port, _DML["delete_rows"])
    _both(ref, port, _DML["update"])
    for path in (ref, port):
        for v in range(_version(path) + 1):
            t = 1_700_000_000 + 100 * v
            os.utime(os.path.join(path, "_delta_log", f"{v:020d}.json"),
                     (t, t))
    ms = {v: (1_700_000_000 + 100 * v) * 1000 for v in range(5)}
    for path in (ref, port):
        by_version = port_changes_of(path, 3, 4)
        assert by_version == port_changes_of(
            path, None, None, starting_timestamp=ms[3] - 50_000,
            ending_timestamp=ms[4] + 50_000)
        assert by_version == ref_changes_of(
            path, None, None, starting_timestamp=ms[3] - 50_000,
            ending_timestamp=ms[4] + 50_000)
    # each row's timestamp is its commit's
    feed = _port_feed(port)
    ts = dict(zip(feed.column("_commit_version").values.tolist(),
                  feed.column("_commit_timestamp").values.tolist()))
    for v, t in ts.items():
        assert t == _actions(port, v, "commitInfo")[0]["timestamp"]


@pytest.mark.parametrize("how", ["creation", "alter", "alias"])
def test_turning_the_feed_on(tmp_path, how):
    """The protocol each package gives the flag at creation, by ALTER,
    and the legacy alias (no protocol feature); the DML then writes
    change data in both, and the feeds agree."""
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    alias = {"delta.enableChangeDataCapture": "true"}
    at_create = {"creation": CDF, "alter": {}, "alias": alias}[how]
    dta.write_table(ref, _data(0, 30), engine=HostEngine(),
                    properties=at_create)
    pta.write_table(port, to_port(_data(0, 30)), engine=CPU,
                    properties=at_create)
    if how == "alter":
        ref_alter.set_properties(_ref(ref), CDF)
        port_alter.set_properties(_port(port), CDF)
    rp = _ref(ref).latest_snapshot().protocol
    pp = _port(port).latest_snapshot().protocol
    assert (rp.minReaderVersion, rp.minWriterVersion) == \
        (pp.minReaderVersion, pp.minWriterVersion) == \
        ((1, 2) if how == "alias" else (1, 4))
    _both(ref, port, _DML["delete_rows"])
    _both(ref, port, _DML["update"])
    v = _version(port)
    assert _actions(port, v, "cdc") and _actions(port, v - 1, "cdc")
    start = 1 if how == "alter" else 0
    assert port_changes_of(port, start) == ref_changes_of(ref, start)
    # beside a non-legacy feature, the feature is listed at writer 7
    if how == "creation":
        both = str(tmp_path / "both")
        pta.write_table(both, to_port(_data(0, 3)), engine=CPU,
                        properties=dict(CDF, **DV))
        proto = _port(both).latest_snapshot().protocol
        assert "changeDataFeed" in proto.writerFeatures
        assert proto.minWriterVersion == 7


def test_a_missing_commit_is_skipped(tmp_path):
    """Commits 0 and 1 gone behind a checkpoint at 2: the feed from 0
    reads versions 2 and 3."""
    ref, port = _make(tmp_path, "plain")
    _both(ref, port, _DML["delete_rows"])
    _port(port).checkpoint(version=2)
    _ref(ref).checkpoint(version=2)
    for path in (ref, port):
        for v in (0, 1):
            os.remove(os.path.join(path, "_delta_log", f"{v:020d}.json"))
    got = port_changes_of(port)
    assert sorted(got) == [(2, "insert"), (3, "delete")]
    assert got == ref_changes_of(ref) == port_changes_of(ref)


def test_a_vacuumed_file_is_skipped(tmp_path):
    """A DELETE of every row (no change data) whose removed files are
    gone: its feed is empty in the port (C28: the reference raises)."""
    ref, port = _make(tmp_path, "plain")
    _both(ref, port, _delete(lambda E: None))
    for path in (ref, port):
        for f in glob.glob(os.path.join(path, "*.parquet")):
            os.remove(f)
    assert port_changes_of(port, 3) == port_changes_of(ref, 3) == {}
    assert _REFERENCE_RAISES_FOR_VACUUMED_FILES
    assert _error_class(lambda: _ref_feed(ref, 3)) == (
        "FileNotFoundInLogError", "DELTA_FILE_NOT_FOUND_DETAILED")


# ------------------------------------------------- logs with cdc lines --

def _cdc_log(tmp_path):
    ref, port = _make(tmp_path, "dv")
    for name in ("delete_rows", "update"):
        _both(ref, port, _DML[name])
    _both(ref, port, _merge(False))
    return ref, port


def test_loads_of_logs_with_cdc_lines_equal_the_references(tmp_path,
                                                            monkeypatch):
    ref, port = _cdc_log(tmp_path)
    for path in (ref, port):
        obs.reset()
        assert_matches_reference(path, _port(path).latest_snapshot().state)
        assert obs.counters().get("parse.device_windows", 0) + obs.counters(
        ).get("parse.device_fallbacks", 0) >= 1
    # the host parse alone
    monkeypatch.setattr(device_parse, "parse_commits_device",
                        lambda *a, **k: None)
    for path in (ref, port):
        assert_matches_reference(path, _port(path).latest_snapshot().state)


def test_cdc_lines_on_the_device_parse_twin(tmp_path):
    """A commit of `cdc` lines and plain adds (no DV line) stays on the
    device route: the control lines go to the host, the masks equal the
    reference's."""
    ref, port = _make(tmp_path, "plain")
    _both(ref, port, _DML["update"])
    obs.reset()
    state = _port(port).latest_snapshot().state
    c = obs.counters()
    assert c.get("parse.device_windows", 0) >= 1
    assert c.get("parse.device_fallbacks", 0) == 0
    assert_matches_reference(port, state)
    assert _actions(port, 3, "cdc")


@pytest.mark.parametrize("form", ["checkpoint", "compacted"])
def test_checkpoints_and_compacted_deltas_hold_no_cdc(tmp_path, form):
    ref, port = _cdc_log(tmp_path)
    head = _version(port)
    if form == "checkpoint":
        _port(port).checkpoint()
        _ref(ref).checkpoint()
        for path in (ref, port):
            parts = glob.glob(os.path.join(path, "_delta_log",
                                           f"{head:020d}.checkpoint*"))
            assert parts
            for part in parts:
                assert "cdc" not in pq.read_schema(part).names
    else:
        name = write_compacted_delta(_port(port), 1, head)
        ref_name = ref_compact(_ref(ref), 1, head)
        for f in (name, ref_name):
            with open(f) as fh:
                assert '"cdc"' not in fh.read()
    for path in (ref, port):
        assert_matches_reference(path, _port(path).latest_snapshot().state)
        assert port_changes_of(path) == ref_changes_of(path)


@pytest.mark.parametrize("vacuum_type", ["FULL", "LITE"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_vacuum_removes_expired_change_data(tmp_path, vacuum_type, writer):
    """On copies of one table whose change data either package wrote,
    both VACUUMs delete the same files, every change data file among
    them."""
    ref, port = _cdc_log(tmp_path)
    src = ref if writer == "ref" else port
    t = time.time() - 7200
    for root, _, files in os.walk(src):
        for f in files:
            os.utime(os.path.join(root, f), (t, t))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    cdc = {os.path.relpath(f, src) for f in glob.glob(
        os.path.join(src, "_change_data", "**", "*.parquet"),
        recursive=True)}
    assert cdc
    r = ref_vacuum(_ref(a), retention_hours=1, vacuum_type=vacuum_type)
    p = port_vacuum(_port(b), retention_hours=1, vacuum_type=vacuum_type)
    assert sorted(r.files_deleted) == sorted(p.files_deleted)
    assert cdc <= set(p.files_deleted)
    assert not glob.glob(os.path.join(b, "_change_data", "**", "*.parquet"),
                         recursive=True)


def test_table_changes_of_an_empty_range(tmp_path):
    """A range of commits that changed no data: an empty Batch with the
    feed's columns; OPTIMIZE's rearrangement changes nothing."""
    ref, port = _make(tmp_path, "plain")
    _port(port).optimize().execute_compaction()
    _ref(ref).optimize().execute_compaction()
    got = _port_feed(port, 3, 3)
    assert got.num_rows == 0 and got.column_names == [
        "k", "x", "s", "p", "_change_type", "_commit_version",
        "_commit_timestamp"]
    assert _ref_feed(ref, 3, 3).num_rows == 0

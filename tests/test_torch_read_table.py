"""The row read: the port's `api.read_table` against the JAX package's.

Tables the reference writes (every type the port reads, nulls in most);
the port reads them with `TorchEngine("cpu")`, the reference with
`HostEngine`. Compared: the column names in order, then the rows as a
multiset (each package lists files in its own order), every value with
its validity. Cases: the whole table; a projection whose filter names a
column it does not project; seeded random filters (30, zoned timestamp
literals, as the columns are UTC instants), where a filter the reference
refuses must be refused by the port too; `version=`, `timestamp_ms=` and
both at once (`TimeTravelArgumentError`); a filter that no file survives
(the schema's or the projection's columns, no rows); a file without
stats; the stats index released at the end of the read.
"""

import os

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.api as dta
import delta_tpu.expressions.tree as RE
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import TimeTravelArgumentError as RefTTError
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch import TorchEngine, obs
from delta_tpu_torch.api import read_table
from delta_tpu_torch.errors import TimeTravelArgumentError
from torch_scan_helpers import (
    TYPES,
    add_file_without_stats,
    build,
    random_spec,
    write_typed_table,
)


def _ref_rows(t: pa.Table):
    cols = []
    for name in t.column_names:
        a = t.column(name).combine_chunks()
        if pa.types.is_timestamp(a.type) or pa.types.is_date(a.type):
            a = a.cast(pa.int64() if pa.types.is_timestamp(a.type)
                       else pa.int32()).cast(pa.int64())
        cols.append(a.to_pylist())
    return t.column_names, sorted(zip(*cols), key=repr) if cols else []


def _port_rows(b):
    cols = []
    for name in b.column_names:
        c = b.column(name)
        v = c.values
        if v.dtype.kind == "M":
            v = v.view(np.int64)
        vals = v.tolist()
        if c.valid is not None:
            vals = [x if ok else None for x, ok in zip(vals, c.valid.tolist())]
        cols.append(vals)
    return b.column_names, sorted(zip(*cols), key=repr) if cols else []


def _both(path, spec=None, **kw):
    ref = dta.read_table(path, filter=None if spec is None else
                         build(spec, RE), engine=HostEngine(), **kw)
    port = read_table(path, filter=None if spec is None else build(spec, PE),
                      engine=TorchEngine("cpu"), **kw)
    return _ref_rows(ref), _port_rows(port)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("read") / "t")
    write_typed_table(path, seed=21, appends=5)
    return path


def test_whole_table(table):
    ref, port = _both(table)
    assert port[0] == ref[0] == list(TYPES)
    assert port[1] == ref[1]
    assert len(port[1]) > 100


def test_projection_with_an_unprojected_filter_column(table):
    spec = ("and", ("cmp", ">=", "long", 300, False),
            ("cmp", "<", "double", 110.0, False))
    ref, port = _both(table, spec, columns=["string", "boolean"])
    assert port[0] == ref[0] == ["string", "boolean"]
    assert port[1] == ref[1] and 0 < len(port[1])


def test_random_filters(table):
    rng = np.random.default_rng(31)
    n_rows = 0
    for i in range(30):
        spec = random_spec(rng, list(TYPES))
        cols = None if i % 3 else ["long", "string", "timestamp"]
        try:
            ref = _ref_rows(dta.read_table(table, filter=build(spec, RE),
                                           columns=cols,
                                           engine=HostEngine()))
        except Exception:
            with pytest.raises(Exception):
                read_table(table, filter=build(spec, PE), columns=cols,
                           engine=TorchEngine("cpu"))
            continue
        port = _port_rows(read_table(table, filter=build(spec, PE),
                                     columns=cols, engine=TorchEngine("cpu")))
        assert port == ref, (i, spec)
        n_rows += len(port[1])
    assert n_rows > 0


def test_time_travel(table):
    for v in (0, 2):
        ref, port = _both(table, ("cmp", ">", "long", 150, False), version=v)
        assert port == ref
    log = os.path.join(table, "_delta_log")
    for v in range(5):
        t = 1_700_000_000 + 100 * v
        os.utime(os.path.join(log, f"{v:020d}.json"), (t, t))
    ms = (1_700_000_000 + 250) * 1000
    ref, port = _both(table, timestamp_ms=ms)
    assert port == ref == _both(table, version=2)[1]
    with pytest.raises(RefTTError):
        dta.read_table(table, version=1, timestamp_ms=ms, engine=HostEngine())
    with pytest.raises(TimeTravelArgumentError) as e:
        read_table(table, version=1, timestamp_ms=ms,
                   engine=TorchEngine("cpu"))
    assert e.value.error_class == "DELTA_ONEOF_IN_TIMETRAVEL"


def test_empty_result(table):
    ref, port = _both(table, ("cmp", ">", "long", 10**9, False))
    assert port == ref and port[0] == list(TYPES) and port[1] == []
    ref, port = _both(table, ("cmp", "<", "long", -5, False),
                      columns=["float", "date"])
    assert port == ref and port[0] == ["float", "date"]
    b = read_table(table, filter=PE.col("long") > 10**9,
                   engine=TorchEngine("cpu"))
    assert b.num_rows == 0
    assert b.column("integer").values.dtype == np.int32
    assert b.column("timestamp").values.dtype == np.dtype("datetime64[us]")


def test_file_without_stats_and_index_release(tmp_path):
    path = str(tmp_path / "t")
    write_typed_table(path, seed=22, appends=3)
    add_file_without_stats(path)
    spec = ("cmp", "<", "long", 120, False)
    obs.reset()
    ref, port = _both(path, spec)
    assert port == ref and len(port[1]) > 0
    assert obs.counters()["scan.stats_index_builds"] == 1
    # the one-shot read released its index: a snapshot of the same
    # version loaded afresh builds its own
    from delta_tpu_torch import Table
    snap = Table.for_path(path, engine=TorchEngine("cpu")).latest_snapshot()
    snap.scan(filter=build(spec, PE)).file_paths()
    assert obs.counters()["scan.stats_index_builds"] == 2


def test_partitioned_read_is_refused(tmp_path):
    """Refused before partitioned tables were ported; now the rows, with
    the partition column spliced in after the data columns, equal the
    reference's, whole and under seeded predicates with a partition
    conjunct (`tests/test_torch_partitioned.py` holds the rest)."""
    path = str(tmp_path / "p")
    write_typed_table(path, seed=23, appends=2, partition_by=["p"])
    ref, port = _both(path)
    assert ref == port and ref[0][-1] == "p" and len(ref[1]) == 87
    rng = np.random.default_rng(23)
    checked = 0
    for _ in range(12):
        spec = ("and", ("cmp", "!=", "p", "p1", False),
                random_spec(rng, list(TYPES) + ["p"]))
        try:
            ref, port = _both(path, spec)
        except Exception:  # a refused comparison: both packages refuse
            with pytest.raises(Exception):
                read_table(path, filter=build(spec, PE),
                           engine=TorchEngine("cpu"))
            continue
        assert ref == port
        checked += 1
    assert checked >= 6

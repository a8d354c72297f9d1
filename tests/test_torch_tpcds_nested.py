"""The port's SQL on TPC-DS's 48 nested texts: WITH clauses, subqueries
in FROM, scalar, IN and EXISTS subqueries (uncorrelated and correlated),
UNION [ALL], INTERSECT and EXCEPT.

Each text, LIMIT stripped, run by the port on `TorchEngine("cpu")`
(through `execute_select` and through `sql()`, the same rows) over
tables the port wrote (`load_delta`), equals the reference's
`execute_select` over the same tables on `HostEngine` and the independent
sqlite oracle (`tests/tpcds_sqlite_oracle.py`) on the reference's own
generated tables, at scale 12,000, compared order-insensitively at the
oracle's 2e-4 tolerance, as `tests/test_torch_tpcds.py` compares the 23
single-block texts. Each verbatim text stays within its LIMIT. The texts
are `delta_tpu_torch/utils/tpcds.py`'s, letter for letter the corpus'.
"""

import re

import numpy as np
import pytest

from benchmarks.tpcds_data import generate as ref_generate
from benchmarks.tpcds_queries import QUERIES as REF_QUERIES
from delta_tpu.catalog import Catalog as RefCatalog
from delta_tpu.engine.host import HostEngine
from delta_tpu.sqlengine import execute_select as ref_execute
from delta_tpu_torch import TorchEngine, obs
from delta_tpu_torch.sql import sql
from delta_tpu_torch.sqlengine import execute_select
from delta_tpu_torch.utils import tpcds
from tests.tpcds_sqlite_oracle import SqliteOracle, rows_equal

SCALE = 12_000
CPU = TorchEngine("cpu")
# the corpus' texts with a WITH clause, a subquery or a set operation and
# none of the constructs still refused
NESTED = ["q1", "q2", "q4", "q6", "q8", "q9", "q10", "q11", "q14b", "q21",
          "q23a", "q23b", "q24a", "q24b", "q30", "q31", "q32", "q33", "q34",
          "q35", "q38", "q39a", "q39b", "q41", "q45", "q46", "q54", "q56",
          "q58", "q59", "q60", "q61", "q64", "q65", "q66", "q68", "q69",
          "q71", "q73", "q74", "q76", "q79", "q81", "q83", "q87", "q88",
          "q90", "q92"]
_LIMIT = re.compile(r"\blimit\s+(\d+)\s*$", re.IGNORECASE)


def _strip_limit(q: str) -> str:
    return _LIMIT.sub("", q.strip())


def _ref_rows(table):
    if not table.num_columns:
        return [()] * table.num_rows
    return list(zip(*(c.to_pylist() for c in table.columns)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_tpcds_nested"))
    ref_tables = ref_generate(SCALE)
    cat = tpcds.load_delta(root, tables=tpcds.generate(SCALE), engine=CPU)
    oracle = SqliteOracle(ref_tables)
    # indexes on the *_sk join keys change sqlite's plans, not its answers
    oracle.create_indexes()
    return {"cat": cat, "oracle": oracle,
            "ref_cat": RefCatalog(root, engine=HostEngine())}


def test_the_nested_texts_are_in_the_port_corpus():
    assert len(NESTED) == 48 and len(tpcds.QUERIES) == 102
    for name in NESTED:
        assert tpcds.QUERIES[name] == REF_QUERIES[name], name
        assert re.search(r"^\s*with\b|\(\s*select\b|\b(union|intersect|"
                         r"except)\b", tpcds.QUERIES[name],
                         re.IGNORECASE | re.MULTILINE), name


@pytest.mark.parametrize("name", NESTED)
def test_nested_query_equals_reference_and_sqlite(env, name):
    text = tpcds.QUERIES[name]
    q = _strip_limit(text)
    obs.reset()
    got = execute_select(q, catalog=env["cat"])
    assert obs.counters().get("sql.host_string_aggs", 0) == 0
    rows = got.rows()
    via_sql = sql(q, catalog=env["cat"])  # the entry point: same rows
    assert via_sql.names == got.names and via_sql.rows() == rows
    ok, msg = rows_equal(rows, env["oracle"].run(q))
    assert ok, f"{name} vs sqlite: {msg}"
    ref = ref_execute(q, catalog=env["ref_cat"])
    assert got.names == ref.column_names
    ok, msg = rows_equal(rows, _ref_rows(ref))
    assert ok, f"{name} vs the reference: {msg}"
    m = _LIMIT.search(text.strip())
    if m:
        verbatim = execute_select(text, catalog=env["cat"])
        assert verbatim.num_rows <= int(m.group(1)), name
        assert verbatim.num_rows == min(len(rows), int(m.group(1))), name
    for c in got.columns.values():
        if c.values.dtype.kind == "f":
            assert not np.isnan(c.values[c.valid if c.valid is not None
                                         else slice(None)]).any(), name

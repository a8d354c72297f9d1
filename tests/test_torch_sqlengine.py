"""The port's executor, construct by construct, against the reference's
`sql()` on the same tables.

The statements are the single-block ones of `tests/test_sqlengine.py`
(literals and operators, CASE, BETWEEN, IN with NULL, LIKE, IS NULL,
CAST and interval arithmetic, date parts, the scalar functions, every
aggregate, NULL group keys, GROUP BY expressions, INNER and CROSS joins,
lateral aliases, ORDER BY's null order, DISTINCT, HAVING) and a few
more, and the nested ones: CTEs (a CTE sees the one before it, not its
sibling; one CTE aliased three times), derived tables and their
pushdown, uncorrelated and correlated scalar, IN and EXISTS subqueries
(NOT IN over a set with a NULL, EXISTS with a NULL outer key, a
correlated COUNT and SUM over no rows, a scalar subquery of two rows),
UNION against UNION ALL, INTERSECT and EXCEPT with NULL rows, ORDER BY
after a union and the types a union gives; LEFT, RIGHT and FULL joins
with NULL keys on each side, a WHERE on the null-supplying side, an inner
prefix before an outer join; COUNT, SUM and AVG (DISTINCT ...) with and
without GROUP BY; ROLLUP with `grouping()`; each window function with and
without PARTITION BY and ORDER BY, in the RANGE and ROWS frames, over
rows and over aggregated rows. Each runs through `delta_tpu_torch.sql.sql` on `TorchEngine("cpu")`
and through the reference's `sql` on `HostEngine` over one table written
by the reference; rows are compared in order where the statement orders
them, else as multisets. Errors: both raise, with the reference's error
class where the port has the class.
"""

import re

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.api as dta
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefDeltaError
from delta_tpu.sql import sql as ref_sql
from delta_tpu_torch import TorchEngine
from delta_tpu_torch.errors import DeltaError, UnsupportedSqlError
from delta_tpu_torch.sql import sql

CPU = TorchEngine("cpu")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sqlengine")
    t, other, nulls, c30 = (str(root / n)
                            for n in ("t", "other", "nulls", "c30"))
    dta.write_table(t, pa.table({
        "id": pa.array([1, 2, 3, 4, None], pa.int64()),
        "v": pa.array([10.0, 20.0, 30.0, 40.0, 50.0]),
        "s": pa.array(["apple", "banana", "cherry", None, "apricot"]),
        "d": pa.array([18262, 18293, 18322, 18353, 18383], pa.date32()),
    }))
    dta.write_table(other, pa.table({
        "k": pa.array([2, 3, 9, 3], pa.int64()),
        "w": pa.array([200.0, 300.0, 900.0, 301.0]),
    }))
    dta.write_table(nulls, pa.table({
        "k": pa.array([None, None, "a", "b"]),
        "v": pa.array([1, 2, 3, None], pa.int64()),
        "f": pa.array([1.5, float("nan"), None, -2.0]),
    }))
    dta.write_table(c30, pa.table({
        "id": pa.array([1, 2, 3, 4, 5, None], pa.int64()),
        "i": pa.array([2**62, 2**62, 1, 2, 3, 4], pa.int64()),
    }))
    return {"t": t, "other": other, "nulls": nulls, "c30": c30}


def _rows(out):
    if hasattr(out, "rows"):
        return out.names, out.rows()
    names = out.column_names
    if hasattr(out, "num_columns") and isinstance(out, pa.Table):
        return names, list(zip(*(c.to_pylist() for c in out.columns))) \
            if out.num_columns else []
    return names, list(zip(*(out.column(c).to_python() for c in names)))


def _norm(v):
    if isinstance(v, float):
        return None if v != v else round(v, 9)
    if hasattr(v, "isoformat"):
        return v.isoformat()[:10]
    return v


STATEMENTS = [
    "SELECT id, v + 1, v - 1, v * 2, v / 2, -v FROM '{t}' WHERE id = 1",
    "SELECT s || '_x' FROM '{t}' WHERE id = 1",
    "SELECT id FROM '{t}' WHERE id = 3 ORDER BY id",
    "SELECT id FROM '{t}' WHERE id <> 3 ORDER BY id",
    "SELECT id FROM '{t}' WHERE id < 3 OR s = 'cherry' ORDER BY id",
    "SELECT id FROM '{t}' WHERE NOT (id >= 3) ORDER BY id",
    "SELECT v AS val, s FROM '{t}' WHERE id >= 3 ORDER BY val DESC",
    "SELECT DISTINCT CASE WHEN id < 3 THEN 'lo' ELSE 'hi' END AS bucket "
    "FROM '{t}' WHERE id IS NOT NULL",
    "SELECT id FROM '{t}' ORDER BY id DESC LIMIT 2",
    "SELECT id FROM '{t}' ORDER BY id",
    "SELECT id, s FROM '{t}' ORDER BY s DESC, id",
    "SELECT CASE WHEN v < 25 THEN 'small' WHEN v < 45 THEN 'mid' "
    "ELSE 'big' END c FROM '{t}' ORDER BY v",
    "SELECT CASE WHEN v < 25 THEN v END c FROM '{t}' ORDER BY v",
    "SELECT CASE WHEN id < 3 THEN 'y' ELSE 'n' END c FROM '{t}' "
    "WHERE id IS NULL",
    "SELECT CASE s WHEN 'apple' THEN 1 WHEN 'banana' THEN 2 ELSE 0 END c "
    "FROM '{t}' ORDER BY v",
    "SELECT id FROM '{t}' WHERE v BETWEEN 15 AND 35 ORDER BY id",
    "SELECT id FROM '{t}' WHERE v NOT BETWEEN 15 AND 35 ORDER BY id",
    "SELECT id FROM '{t}' WHERE id IN (1, NULL)",
    "SELECT id FROM '{t}' WHERE id NOT IN (1, NULL)",
    "SELECT id FROM '{t}' WHERE id NOT IN (1, 2) ORDER BY id",
    "SELECT s FROM '{t}' WHERE s LIKE 'ap%' ORDER BY s",
    "SELECT s FROM '{t}' WHERE s LIKE '_anana'",
    "SELECT s FROM '{t}' WHERE s LIKE 'a.p%'",
    "SELECT s FROM '{t}' WHERE s NOT LIKE 'a%' ORDER BY s",
    "SELECT v FROM '{t}' WHERE id IS NULL",
    "SELECT COUNT(*) n FROM '{t}' WHERE id IS NOT NULL",
    "SELECT CAST(v AS int) i, CAST(id AS double) f, CAST(id AS string) st, "
    "CAST(v AS decimal(10,2)) dec FROM '{t}' WHERE id = 2",
    "SELECT id FROM '{t}' WHERE d BETWEEN cast('2020-01-15' as date) AND "
    "(cast('2020-01-15' as date) + interval 60 days) ORDER BY id",
    "SELECT id FROM '{t}' WHERE d > '2020-2-1' ORDER BY id",
    "SELECT d, id FROM '{t}' WHERE d <= cast('2020-03-01' as date) "
    "ORDER BY d DESC",
    "SELECT year(d) y, month(d) m FROM '{t}' WHERE id = 3",
    "SELECT substr(s, 1, 3) a, upper(s) u, lower(upper(s)) lo, length(s) n "
    "FROM '{t}' WHERE id = 2",
    "SELECT substr(s, 2) a FROM '{t}' ORDER BY v",
    "SELECT abs(10 - v) a, round(v / 3, 1) r, coalesce(id, -1) c, "
    "concat(s, '!') k FROM '{t}' WHERE v = 50",
    "SELECT round(2.125, 2) r, round(-2.5) r0 FROM '{t}' WHERE id = 1",
    "SELECT coalesce(s, 'none') c FROM '{t}' ORDER BY v",
    "SELECT COUNT(*) n, COUNT(id) ni, SUM(v) s, AVG(v) a, MIN(v) lo, "
    "MAX(v) hi, stddev_samp(v) sd, var_samp(v) vr FROM '{t}'",
    "SELECT MIN(s) lo, MAX(s) hi, MIN(d) d0, MAX(d) d1 FROM '{t}'",
    "SELECT k, SUM(v) s, COUNT(f) c, AVG(f) a, MIN(f) lo FROM '{nulls}' "
    "GROUP BY k ORDER BY k",
    "SELECT k, COUNT(*) n FROM '{nulls}' GROUP BY k",
    "SELECT SUM(v) s FROM '{nulls}' WHERE v > 100",
    "SELECT COUNT(*) n, MAX(f) m FROM '{nulls}' WHERE f IS NULL",
    "SELECT month(d) m, COUNT(*) n FROM '{t}' GROUP BY month(d) "
    "ORDER BY m LIMIT 2",
    "SELECT id IS NULL k, SUM(v) s FROM '{t}' GROUP BY id IS NULL "
    "ORDER BY k",
    "SELECT a.id, b.w FROM '{t}' a JOIN '{other}' b ON a.id = b.k "
    "ORDER BY a.id, b.w",
    "SELECT a.id, b.w FROM '{t}' a INNER JOIN '{other}' b ON b.k = a.id "
    "WHERE b.w > 250 ORDER BY b.w",
    "SELECT COUNT(*) n FROM '{t}' a CROSS JOIN '{other}' b",
    "SELECT a.id, SUM(b.w) s FROM '{t}' a, '{other}' b WHERE a.id = b.k "
    "GROUP BY a.id HAVING SUM(b.w) > 250 ORDER BY s DESC",
    "SELECT COUNT(*) n FROM '{t}' a, '{other}' b WHERE a.v < b.w / 10",
    "SELECT k * 100 AS w, w + 1 AS x FROM '{other}' ORDER BY k, w",
    "SELECT k * 100 AS big, big + 1 AS x FROM '{other}' ORDER BY k, w",
    "SELECT k, SUM(w) total FROM '{other}' GROUP BY k HAVING total > 250 "
    "ORDER BY 2 DESC",
    "SELECT ID, V FROM '{t}' WHERE id = 2",
    "SELECT * FROM '{t}' WHERE id = 1",
    "SELECT DISTINCT k FROM '{other}' ORDER BY k",
    "SELECT b.k, b.w FROM '{other}' AS b WHERE b.k = 3 OR b.w IS NULL "
    "ORDER BY b.w DESC",
    # CTEs and derived tables
    "WITH a AS (SELECT id, v FROM '{t}' WHERE id > 1), "
    "b AS (SELECT id FROM a WHERE v < 40) SELECT id FROM b ORDER BY id",
    "WITH c AS (SELECT k, SUM(w) s FROM '{other}' GROUP BY k) "
    "SELECT x.k, y.s, z.s + 1 FROM c x, c y, c AS z "
    "WHERE x.k = y.k AND y.k = z.k ORDER BY x.k",
    "SELECT x.k, x.s, t.v FROM (SELECT k, SUM(w) s FROM '{other}' "
    "GROUP BY k) x, '{t}' t WHERE x.k = t.id AND x.s > 250 ORDER BY x.k",
    "SELECT q.n FROM (WITH z AS (SELECT COUNT(*) n FROM '{other}') "
    "SELECT n FROM z) q",
    # subqueries in expressions
    "SELECT id FROM '{t}' WHERE v > (SELECT AVG(w) / 10 FROM '{other}') "
    "ORDER BY id",
    "SELECT id FROM '{t}' WHERE id IN (SELECT v FROM '{nulls}') "
    "ORDER BY id",
    "SELECT id FROM '{t}' WHERE id NOT IN (SELECT v FROM '{nulls}')",
    "SELECT id FROM '{t}' WHERE id NOT IN (SELECT k FROM '{other}') "
    "ORDER BY id",
    "SELECT id FROM '{t}' a WHERE EXISTS (SELECT 1 FROM '{other}' b "
    "WHERE b.k = a.id) ORDER BY id",
    "SELECT id, v FROM '{t}' a WHERE NOT EXISTS (SELECT 1 FROM '{other}' "
    "b WHERE b.k = a.id) ORDER BY v",
    "SELECT id, v FROM '{t}' a WHERE v * 10 IN (SELECT w FROM '{other}' "
    "b WHERE b.k = a.id) ORDER BY v",
    "SELECT id, v FROM '{t}' a WHERE v * 10 NOT IN (SELECT w FROM "
    "'{other}' b WHERE b.k = a.id) ORDER BY v",
    "SELECT id, (SELECT COUNT(*) FROM '{other}' b WHERE b.k = a.id) n, "
    "(SELECT SUM(w) FROM '{other}' b WHERE b.k = a.id) s FROM '{t}' a "
    "ORDER BY v",
    "SELECT id FROM '{t}' a WHERE v * 10 < (SELECT MAX(w) FROM '{other}' "
    "b WHERE b.k = a.id) ORDER BY id",
    "SELECT id FROM '{t}' a WHERE EXISTS (SELECT 1 FROM '{other}' b "
    "WHERE b.k = a.id AND b.w <> a.v * 10) ORDER BY id",
    "SELECT k, SUM(w) s FROM '{other}' GROUP BY k "
    "HAVING SUM(w) > (SELECT AVG(w) FROM '{other}') ORDER BY k",
    # set operations
    "SELECT k FROM '{other}' UNION ALL SELECT id FROM '{t}'",
    "SELECT k FROM '{other}' UNION SELECT id FROM '{t}'",
    "SELECT k FROM '{nulls}' INTERSECT SELECT k FROM '{nulls}' WHERE v < 3",
    "SELECT k FROM '{nulls}' EXCEPT SELECT k FROM '{nulls}' WHERE v = 3",
    "SELECT k, v FROM '{nulls}' UNION SELECT k, v FROM '{nulls}' "
    "ORDER BY k, v DESC",
    "SELECT id AS n, v FROM '{t}' UNION ALL SELECT k, w FROM '{other}' "
    "ORDER BY 2 DESC LIMIT 4",
    "SELECT id FROM '{t}' UNION ALL SELECT k FROM (SELECT k FROM "
    "'{other}' EXCEPT SELECT 9 FROM '{other}') e ORDER BY id",
    "SELECT COUNT(*) n FROM ((SELECT k FROM '{other}') EXCEPT "
    "(SELECT id FROM '{t}')) x",
    # outer joins: NULL keys on each side, WHERE on the null-supplying
    # side, an inner prefix before an outer join
    "SELECT a.id, b.k, b.w FROM '{t}' a LEFT JOIN '{other}' b ON a.id = b.k",
    "SELECT a.id, b.k, b.w FROM '{t}' a RIGHT JOIN '{other}' b "
    "ON a.id = b.k",
    "SELECT a.id, a.s, b.k, b.w FROM '{t}' a FULL OUTER JOIN '{other}' b "
    "ON a.id = b.k",
    "SELECT n.k, n.v, a.id FROM '{nulls}' n LEFT JOIN '{t}' a ON n.v = a.id",
    "SELECT n.k, n.v, a.id FROM '{nulls}' n RIGHT OUTER JOIN '{t}' a "
    "ON n.v = a.id",
    "SELECT a.id, n.v, n.k FROM '{t}' a FULL JOIN '{nulls}' n ON a.id = n.v",
    "SELECT a.id, b.w FROM '{t}' a LEFT JOIN '{other}' b ON a.id = b.k "
    "WHERE b.w IS NULL",
    "SELECT a.id, b.w FROM '{t}' a LEFT JOIN '{other}' b ON a.id = b.k "
    "WHERE b.w > 250 AND a.v < 45",
    "SELECT a.id, b.k FROM '{t}' a RIGHT JOIN '{other}' b ON a.id = b.k "
    "WHERE a.v > 15 OR a.v IS NULL",
    "SELECT a.id, b.w, c.k FROM '{t}' a JOIN '{other}' b ON a.id = b.k "
    "LEFT JOIN '{nulls}' c ON b.k = c.v",
    "SELECT a.id, n.k, b.w FROM '{t}' a, '{nulls}' n LEFT JOIN '{other}' b "
    "ON n.v = b.k WHERE a.id = n.v",
    "SELECT b.k, COUNT(a.id) c, SUM(a.v) s FROM '{other}' b LEFT JOIN "
    "'{t}' a ON b.k = a.id GROUP BY b.k",
    "SELECT a.id, b.k, c.k FROM '{t}' a FULL JOIN '{other}' b ON a.id = b.k "
    "FULL JOIN '{nulls}' c ON a.id = c.v",
    # DISTINCT aggregates, with and without GROUP BY
    "SELECT COUNT(DISTINCT k) a, SUM(DISTINCT k) b, AVG(DISTINCT k) c "
    "FROM '{other}'",
    "SELECT k, COUNT(DISTINCT v) a, SUM(DISTINCT f) s, AVG(DISTINCT v) m "
    "FROM '{nulls}' GROUP BY k",
    "SELECT COUNT(DISTINCT s) n, COUNT(DISTINCT id) i, COUNT(id) c "
    "FROM '{t}'",
    "SELECT k, COUNT(DISTINCT k) a, SUM(DISTINCT w) b, COUNT(*) c "
    "FROM '{other}' GROUP BY k",
    "SELECT COUNT(DISTINCT k) n, SUM(DISTINCT k) s FROM '{other}' "
    "WHERE k > 100",
    # ROLLUP with grouping()
    "SELECT k, SUM(w) s, grouping(k) g FROM '{other}' GROUP BY ROLLUP(k)",
    "SELECT s, id, COUNT(*) c, grouping(s) gs, grouping(id) gi FROM '{t}' "
    "GROUP BY ROLLUP(s, id)",
    "SELECT k, SUM(v) s, grouping(k) + 0 g FROM '{nulls}' "
    "GROUP BY ROLLUP(k) ORDER BY g, k",
    "SELECT k, SUM(w) s FROM '{other}' WHERE k > 100 GROUP BY ROLLUP(k)",
    # window functions: partitions, whole frames, ranks, running
    # aggregates in the RANGE and ROWS frames, over aggregated rows
    "SELECT k, w, SUM(w) OVER (PARTITION BY k) s, AVG(w) OVER (PARTITION "
    "BY k) a, MIN(w) OVER (PARTITION BY k) mn, MAX(w) OVER (PARTITION BY "
    "k) mx, COUNT(w) OVER (PARTITION BY k) c FROM '{other}'",
    "SELECT k, w, SUM(w) OVER () s, COUNT(*) OVER () c, MIN(w) OVER () m "
    "FROM '{other}'",
    "SELECT k, v, f, SUM(f) OVER (PARTITION BY k) s, COUNT(f) OVER "
    "(PARTITION BY k) c, MAX(v) OVER (PARTITION BY k) m FROM '{nulls}'",
    "SELECT id, MIN(d) OVER (PARTITION BY s) m FROM '{t}'",
    "SELECT k, w, rank() OVER (ORDER BY k) r, dense_rank() OVER "
    "(ORDER BY k) d, row_number() OVER (ORDER BY k, w) n FROM '{other}'",
    "SELECT k, w, rank() OVER (PARTITION BY k ORDER BY w DESC) r "
    "FROM '{other}'",
    "SELECT id, rank() OVER (ORDER BY id DESC) r, row_number() OVER "
    "(ORDER BY id) n, dense_rank() OVER (ORDER BY s) d FROM '{t}'",
    "SELECT k, w, SUM(w) OVER (ORDER BY k) s, COUNT(w) OVER (ORDER BY k) c, "
    "MAX(w) OVER (ORDER BY k) m, AVG(w) OVER (ORDER BY k) a FROM '{other}'",
    "SELECT k, w, SUM(w) OVER (ORDER BY k, w ROWS BETWEEN UNBOUNDED "
    "PRECEDING AND CURRENT ROW) s, MIN(w) OVER (ORDER BY k ROWS BETWEEN "
    "UNBOUNDED PRECEDING AND CURRENT ROW) m FROM '{other}'",
    "SELECT k, v, SUM(v) OVER (PARTITION BY k ORDER BY v) s, AVG(f) OVER "
    "(PARTITION BY k ORDER BY v ROWS BETWEEN UNBOUNDED PRECEDING AND "
    "CURRENT ROW) a, MIN(f) OVER (PARTITION BY k ORDER BY v) mn FROM "
    "'{nulls}'",
    "SELECT k, COUNT(*) OVER (ORDER BY k) c FROM '{other}'",
    "SELECT k, SUM(w) s, rank() OVER (ORDER BY SUM(w) DESC) r, "
    "SUM(SUM(w)) OVER () t FROM '{other}' GROUP BY k",
    "SELECT k, SUM(w) s, grouping(k) g, rank() OVER (PARTITION BY "
    "grouping(k) ORDER BY SUM(w)) r FROM '{other}' GROUP BY ROLLUP(k)",
    "SELECT k, r FROM (SELECT k, rank() OVER (ORDER BY w) r FROM "
    "'{other}') x WHERE r <= 2",
]


@pytest.mark.parametrize("stmt", STATEMENTS)
def test_statement_equals_reference(paths, stmt):
    s = stmt.format(**paths)
    got_names, got = _rows(sql(s, engine=CPU))
    want_names, want = _rows(ref_sql(s, engine=HostEngine()))
    assert got_names == want_names
    got = [tuple(_norm(v) for v in r) for r in got]
    want = [tuple(_norm(v) for v in r) for r in want]
    if not re.search(r"\border\s+by\b", s, re.IGNORECASE):
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert got == want


@pytest.mark.parametrize("stmt,match", [
    ("SELECT a.id FROM '{t}' a JOIN '{other}' b ON a.id < b.k", "JOIN ON"),
    ("SELECT nope FROM '{t}'", "not found"),
    ("SELECT id FROM '{t}' a, '{t}' b WHERE a.id = b.id", "ambiguous"),
    ("SELECT a.id FROM '{t}' a, '{t}' a", "duplicate"),
    ("SELECT id FROM '{t}' ORDER BY id nonsense extra", "trailing"),
    ("SELECT regexp_extract(s, 'x') FROM '{t}'", "unsupported function"),
    ("SELECT abs(*) FROM '{t}'", "count"),
    ("SELECT id FROM '{t}' VERSION AS OF 'zero'", "VERSION AS OF"),
    ("SELECT id FROM '{t}' WHERE SUM(v) > 10", "not allowed|aggregate"),
    ("SELECT v, COUNT(*) FROM '{t}' GROUP BY id", "GROUP BY"),
    ("SELECT id FROM '{t}' HAVING id > 1", "HAVING"),
    ("WITH a AS (SELECT id FROM b), b AS (SELECT id FROM '{t}') "
     "SELECT id FROM a", "requires a catalog"),
    ("SELECT z.n FROM (WITH z AS (SELECT 1 n FROM '{t}') SELECT n FROM z) "
     "q, z", "requires a catalog"),
    ("SELECT id FROM '{t}' WHERE v > (SELECT w FROM '{other}' "
     "WHERE k = 3)", "scalar subquery"),
    ("SELECT id, v FROM '{t}' UNION ALL SELECT k FROM '{other}'",
     "different widths"),
    ("SELECT id FROM '{t}' UNION SELECT k FROM '{other}' ORDER BY id + 1",
     "ORDER BY after"),
    ("SELECT a.id FROM '{t}' a LEFT JOIN '{other}' b ON a.id < b.k",
     "JOIN ON"),
    ("SELECT a.id FROM '{t}' a LEFT JOIN '{other}' b ON c.v = b.k "
     "JOIN '{nulls}' c ON c.v = a.id", "joined after"),
    ("SELECT rank() OVER (PARTITION BY k) FROM '{other}'",
     "requires ORDER BY"),
    ("SELECT ntile(2) OVER (ORDER BY k) FROM '{other}'",
     "unsupported window function"),
    ("SELECT SUM(DISTINCT w) OVER (PARTITION BY k) FROM '{other}'",
     "DISTINCT inside window"),
])
def test_errors_as_in_the_reference(paths, stmt, match):
    s = stmt.format(**paths)
    with pytest.raises(RefDeltaError, match=match) as ref:
        ref_sql(s, engine=HostEngine())
    with pytest.raises(DeltaError, match=match) as got:
        sql(s, engine=CPU)
    assert got.value.error_class == ref.value.error_class


@pytest.mark.parametrize("stmt,construct", [
    ("SELECT SUM(DISTINCT w) OVER (PARTITION BY k) FROM '{other}'",
     "SUM(DISTINCT) OVER"),
    ("SELECT id FROM '{t}' WHERE v > (SELECT COUNT(DISTINCT w) OVER () "
     "FROM '{other}')", "COUNT(DISTINCT) OVER"),
    ("SELECT ntile(2) OVER (ORDER BY k) FROM '{other}'", "ntile() OVER"),
    ("SELECT id FROM (SELECT id, lag(v) OVER (ORDER BY v) f FROM '{t}') x",
     "lag() OVER"),
    ("WITH x AS (SELECT k, rank() OVER (PARTITION BY k) r FROM '{other}') "
     "SELECT k FROM x", "rank() OVER without ORDER BY"),
    ("SELECT k FROM '{other}' UNION ALL SELECT row_number() OVER "
     "(PARTITION BY id) FROM '{t}'", "row_number() OVER without ORDER BY"),
])
def test_constructs_outside_the_slice_are_refused(paths, stmt, construct):
    """Refused by name wherever the query holds the construct (a CTE, a
    derived table, a subquery, a set-operation branch), before any table
    is read: the window shapes the reference refuses (its
    `_window_eval`)."""
    from delta_tpu_torch import obs

    scans = obs.counter("sql.scan_ns").read()
    with pytest.raises(DeltaError) as e:
        sql(stmt.format(**paths), engine=CPU)
    assert e.value.context["construct"] == construct
    assert obs.counter("sql.scan_ns").read() == scans


@pytest.mark.parametrize("stmt,kinds", [
    ("SELECT id FROM '{t}' WHERE id < 3 UNION ALL SELECT w FROM '{other}'",
     ("f", "double")),
    ("SELECT k FROM '{other}' UNION ALL SELECT NULL FROM '{t}'",
     ("i", "int64")),
    ("SELECT NULL AS x FROM '{t}' UNION ALL SELECT s FROM '{t}'",
     ("O", "string")),
    ("SELECT k FROM '{other}' UNION SELECT id FROM '{t}' WHERE id > 1",
     ("i", "int64")),
])
def test_union_column_types_follow_the_reference(paths, stmt, kinds):
    """An int branch against a float branch is float64; a branch of NULLs
    takes the other branch's type."""
    s = stmt.format(**paths)
    got = sql(s, engine=CPU)
    want = ref_sql(s, engine=HostEngine())
    assert got.column_at(0).values.dtype.kind == kinds[0]
    assert str(want.column(0).type) == kinds[1]


def test_derived_table_filters_apply_before_the_join(paths, monkeypatch):
    """A WHERE conjunct that names one derived table alone filters it
    before any join (q4's six-way self-join shape)."""
    from delta_tpu_torch.sqlengine.device import DeviceSpine

    sizes = []
    merge = DeviceSpine.merge

    def watched(self, left, right, lk, rk, how="inner"):
        sizes.append((len(left), len(right)))
        return merge(self, left, right, lk, rk, how)

    monkeypatch.setattr(DeviceSpine, "merge", watched)
    s = ("WITH c AS (SELECT k, SUM(w) s FROM '{other}' GROUP BY k) "
         "SELECT x.k, y.s FROM c x, c y WHERE x.k = y.k AND x.s > 250 "
         "AND y.s < 500 ORDER BY x.k").format(**paths)
    got = sql(s, engine=CPU)
    assert _rows(got) == _rows(ref_sql(s, engine=HostEngine()))
    # c has 3 groups (2: 200, 3: 601, 9: 900): x keeps 2, y keeps 1
    assert sizes == [(2, 1)]
    assert got.rows() == []


@pytest.mark.parametrize("stmt,means", [
    ("SELECT AVG(i) a FROM '{c30}'", [1.5372286728091292e+18]),
    ("SELECT id IS NULL k, AVG(i) a FROM '{c30}' GROUP BY id IS NULL "
     "ORDER BY k", [1.8446744073709553e+18, 4.0]),
])
def test_avg_of_a_long_column_sums_in_float64(paths, stmt, means):
    """AVG over int64 values whose sum passes 2^63 (C30): summed as
    float64, as the reference does, not wrapped as SUM is."""
    s = stmt.format(**paths)
    got = [r[-1] for r in _rows(sql(s, engine=CPU))[1]]
    want = [r[-1] for r in _rows(ref_sql(s, engine=HostEngine()))[1]]
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(means, rel=1e-12)


def test_repeated_output_names_keep_every_column(paths):
    out = sql("SELECT id, id, v AS id FROM '{t}' WHERE id <= 2 "
              "ORDER BY v".format(**paths), engine=CPU)
    assert out.names == ["id", "id", "id"]
    assert out.column_names == ["id", "id#2", "id#3"]
    assert out.rows() == [(1, 1, 10.0), (2, 2, 20.0)]
    assert np.array_equal(out.column_at(2).values, [10.0, 20.0])


def test_catalog_against_the_reference(tmp_path):
    """Each package's catalog reads the other's entries; CREATE TABLE with
    a schema commits, a name over an existing table registers it, and the
    refusals raise the reference's error classes."""
    from delta_tpu.catalog import Catalog as RefCatalog
    from delta_tpu_torch.catalog import Catalog, TableAlreadyExistsError
    from delta_tpu_torch.errors import CatalogTableError
    from delta_tpu_torch.models.schema import StructField, StructType

    root = str(tmp_path)
    cat = Catalog(root, engine=CPU)
    ref = RefCatalog(root, engine=HostEngine())
    t = cat.create_table("sales.daily", schema=StructType(
        [StructField("k", "long"), StructField("p", "string")]),
        partition_by=["p"], properties={"delta.appendOnly": "false"})
    assert t.latest_snapshot().metadata.partitionColumns == ["p"]
    ext = str(tmp_path / "ext")
    dta.write_table(ext, pa.table({"x": [1, 2, 3]}))
    ref.register("ext", ext)
    assert cat.tables() == ref.tables() == ["ext", "sales.daily"]
    assert ref.table("sales.daily").latest_snapshot().metadata \
        .partitionColumns == ["p"]
    assert sql("SELECT sum(x) s FROM ext", catalog=cat).rows() == [(6,)]
    assert cat.table("ext") is cat.table("ext")
    with pytest.raises(TableAlreadyExistsError):
        cat.register("ext", ext)
    with pytest.raises(CatalogTableError) as e:
        cat.create_table("sales.daily", partition_by=["k"],
                         if_not_exists=True)
    assert e.value.error_class == \
        "DELTA_CREATE_TABLE_WITH_DIFFERENT_PARTITIONING"
    with pytest.raises(DeltaError) as e:
        cat.table("no such name!")
    assert e.value.error_class == "DELTA_PARSING_ILLEGAL_TABLE_NAME"
    assert cat.drop("ext") and not ref.exists("ext")
    assert not cat.drop("ext", if_exists=True)
    other = Catalog(str(tmp_path / "other"), engine=CPU)
    other.register("e2", ext)
    with pytest.raises(CatalogTableError):  # external: outside its root
        other.drop("e2", delete_data=True)
    assert cat.drop("sales.daily", delete_data=True)
    assert ref.tables() == []


def test_pushdown_takes_only_literals_of_the_columns_type(paths,
                                                          monkeypatch):
    """A conjunct goes into the scan's filter only where its literal has
    its column's type; a string against the date column stays with the
    executor's own coercions, and the rows are the reference's."""
    from delta_tpu_torch.snapshot import Snapshot

    filters = []
    real = Snapshot.scan

    def scan(self, filter=None, columns=None):
        filters.append(filter)
        return real(self, filter=filter, columns=columns)

    monkeypatch.setattr(Snapshot, "scan", scan)
    s = ("SELECT id FROM '{t}' WHERE d > '2020-2-1' AND id >= 2 "
         "AND s IN ('banana', 'cherry', 7) ORDER BY id").format(**paths)
    got = [tuple(_norm(v) for v in r) for r in _rows(sql(s, engine=CPU))[1]]
    want = [tuple(_norm(v) for v in r)
            for r in _rows(ref_sql(s, engine=HostEngine()))[1]]
    assert got == want == [(3,)]
    assert len(filters) == 1
    text = repr(filters[0])
    assert "id" in text and "2020" not in text and "banana" not in text


def test_a_scan_failure_under_a_pushed_filter_propagates(paths,
                                                         monkeypatch):
    """The executor does not scan again without the filter when the
    filtered scan raises: the error reaches the caller."""
    from delta_tpu_torch.snapshot import Snapshot

    calls = []

    def scan(self, filter=None, columns=None):
        calls.append(filter)
        raise ValueError("skipping: bad input")

    monkeypatch.setattr(Snapshot, "scan", scan)
    with pytest.raises(ValueError, match="bad input"):
        sql("SELECT id FROM '{t}' WHERE id = 3".format(**paths), engine=CPU)
    assert len(calls) == 1 and calls[0] is not None


def test_a_whole_frame_sum_of_no_values_is_null(paths):
    """ROADMAP C31: over a window with neither PARTITION BY nor ORDER BY,
    the reference's SUM of no valid value is 0.0 (a data frame's sum),
    where its partitioned and running windows, SQL and the port give NULL;
    COUNT is 0 and MAX NULL in both."""
    s = ("SELECT k, SUM(f) OVER () s, COUNT(f) OVER () c, MAX(f) OVER () m, "
         "SUM(f) OVER (PARTITION BY k) p FROM '{nulls}' WHERE k = 'a'"
         ).format(**paths)
    assert _rows(sql(s, engine=CPU))[1] == [("a", None, 0, None, None)]
    assert _rows(ref_sql(s, engine=HostEngine()))[1] == [
        ("a", 0.0, 0, None, None)]

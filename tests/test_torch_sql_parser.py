"""The port's SQL parser against the reference's.

`delta_tpu_torch/sqlengine/parser.py` parses the whole grammar, what the
port's executor refuses included, so that later slices only add
execution: its tree of every text of the TPC-DS corpus (all 102, the
79 the executor refuses among them) is equal in `repr` to the
reference's, and its error cases raise `SqlParseError` with the
reference's message.
"""

import pytest

from benchmarks.tpcds_queries import QUERIES
from delta_tpu.errors import SqlParseError as RefSqlParseError
from delta_tpu.sqlengine import parser as ref_parser
from delta_tpu_torch.errors import SqlParseError
from delta_tpu_torch.sqlengine import parser


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_corpus_tree_equals_reference(name):
    text = QUERIES[name]
    assert repr(parser.parse_query(text)) == \
        repr(ref_parser.parse_query(text))


@pytest.mark.parametrize("text", [
    "SELECT id, v + 1 AS w FROM 't' WHERE id = 1",
    "SELECT a.id, b.w FROM 't' a LEFT JOIN 'o' b ON a.id = b.k",
    "SELECT * FROM delta.`/p/q` VERSION AS OF 3",
    "SELECT * FROM t TIMESTAMP AS OF '2024-01-01T00:00:00Z'",
    "SELECT CASE s WHEN 'a' THEN 1 ELSE 0 END c FROM t",
    "SELECT count(DISTINCT x), count(*) FROM t GROUP BY ROLLUP (a, b)",
    "SELECT rank() OVER (PARTITION BY a ORDER BY b DESC ROWS BETWEEN "
    "UNBOUNDED PRECEDING AND CURRENT ROW) FROM t",
    "SELECT x FROM t WHERE x NOT IN (SELECT y FROM u) AND NOT EXISTS "
    "(SELECT 1 FROM u)",
    "(SELECT a FROM t) EXCEPT (SELECT a FROM u) INTERSECT SELECT a FROM v",
    "SELECT d FROM t WHERE d BETWEEN cast('2000-1-5' as date) AND "
    "(cast('2000-01-05' as date) + interval 30 days)",
])
def test_statement_tree_equals_reference(text):
    assert repr(parser.parse_query(text)) == \
        repr(ref_parser.parse_query(text))


# the parser's error cases of tests/test_sqlengine.py and the grammar's
@pytest.mark.parametrize("text", [
    "SELECT id FROM 't' ORDER BY id nonsense extra",
    "SELECT id FROM 't' VERSION AS OF 'zero'",
    "SELECT a FROM t JOIN u",
    "SELECT a FROM t LIMIT x",
    "SELECT a FROM t WHERE a LIKE b",
    "SELECT CASE END FROM t",
    "SELECT CAST(a AS decimal(10, 2 FROM t",
    "SELECT a + interval 3 months FROM t",
    "SELECT a FROM t VERSION AS OF 1 TIMESTAMP AS OF 5",
    "SELECT a FROM t WHERE a = ?",
    "SELECT a FROM",
    "SELECT (a FROM t",
])
def test_parse_errors_match_reference(text):
    with pytest.raises(RefSqlParseError) as ref:
        ref_parser.parse_query(text)
    with pytest.raises(SqlParseError) as got:
        parser.parse_query(text)
    assert str(got.value) == str(ref.value)
    assert got.value.error_class == ref.value.error_class

"""The port's expression parser against the JAX package's.

`delta_tpu_torch.expressions.parser` and `delta_tpu.expressions.parser`
on the same strings (the reference's `test_parser_roundtrip` and
`test_parser_evaluates` cases, and more): `to_sql` of each package's tree
is the same text and parses back to itself, `references()` are equal,
and the port's `evaluate_predicate` of the parsed tree over a seeded
batch (nulls in every column) equals the reference's
`evaluate_predicate_host` over the equal Arrow table. Strings that do not
parse raise `ParseError` with the same error class in both. Exact.
"""

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.expressions.parser as RP
from delta_tpu.expressions.eval import evaluate_predicate_host
import delta_tpu_torch.expressions.parser as PP
from delta_tpu_torch.expressions.eval import evaluate_predicate
from delta_tpu_torch.models.batch import Batch, Column

# the reference's round-trip cases first, then more of the grammar
ROUND_TRIP = [
    "a = 5",
    "a.b > 'it''s'",
    "(a = 1 AND b = 2) OR c < 3.5",
    "x IS NOT NULL",
    "NOT (flag = TRUE)",
    "c IN (1, 2, 3)",
    "x IS NULL",
    "a <> 3",
    "a != -4",
    "`a b`.`c,d` = 'x'",
    "`select` >= 2.25e3",
    "NOT NOT flag",
    "a = 1 OR b = 2 AND c = 3",
    "(a = 1 OR b = 2) AND NOT (c IS NULL)",
    "s IN ('x', 'it''s', NULL)",
    "flag = FALSE",
    "n = NULL",
    "  a   <=   -0.5  ",
    "a.b.c IS NOT NULL AND d",
]

# (expression, its evaluation over `_data`) cases: i, j int64, f double,
# s string, b boolean
EVALUATED = [
    "i >= 2 AND s != 'v3'",
    "i = 2",
    "i > 0 AND f < 0.5",
    "(i = 1 AND j = 2) OR f < 3.5",
    "s IS NOT NULL",
    "s IS NULL OR i IN (1, 2, 3)",
    "NOT (b = TRUE)",
    "b",
    "NOT b",
    "i IN (1, 2, 3)",
    "s IN ('v1', 'v2')",
    "s > 'v5'",
    "s = 'it''s'",
    "i <> 3",
    "i != j",
    "i >= -2 OR NOT (f <= -0.5)",
    "`i` = 1 AND `s` < 'v4'",
    "f < 1.0e1 AND f > -1.5E0",
    "i = 1 OR j = 2 AND b",
    "i < j",
]

NOT_PARSED = [
    "a +", "a = ", "1 + 2", "a IN (b)", "(a = 1", "a = 1)", "'open",
    "a IS 5", "a = 1 AND", "AND a = 1", "a IN 1", "a IN (1 2)", "",
    "a = b = c", "NOT", "a IS NOT 1", "#",
]


def _data(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    cols = {"i": rng.integers(-5, 6, n), "j": rng.integers(-5, 6, n),
            "f": rng.normal(size=n).round(1),
            "s": np.array([f"v{x}" for x in rng.integers(0, 12, n)]
                          + [], object),
            "b": rng.random(n) < 0.5}
    cols["s"][rng.integers(0, n, 5)] = "it's"
    arrow, port = {}, {}
    for name, v in cols.items():
        m = rng.random(n) < 0.2
        arrow[name] = pa.array(list(v) if v.dtype == object else v,
                               mask=m)
        fill = "" if v.dtype == object else np.zeros_like(v)
        port[name] = Column(np.where(m, fill, v).astype(v.dtype), ~m)
    return pa.table(arrow), Batch(port)


@pytest.mark.parametrize("text", ROUND_TRIP + EVALUATED)
def test_parser_roundtrip(text):
    port, ref = PP.parse_expression(text), RP.parse_expression(text)
    sql = PP.to_sql(port)
    assert sql == RP.to_sql(ref)
    assert PP.to_sql(PP.parse_expression(sql)) == sql
    assert port.references() == ref.references()


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("text", EVALUATED)
def test_parser_evaluates(text, seed):
    table, batch = _data(seed)
    want = evaluate_predicate_host(RP.parse_expression(text), table)
    np.testing.assert_array_equal(
        evaluate_predicate(PP.parse_expression(text), batch), want)
    # the text to_sql writes evaluates the same
    np.testing.assert_array_equal(evaluate_predicate(
        PP.parse_expression(PP.to_sql(PP.parse_expression(text))), batch),
        want)


@pytest.mark.parametrize("text", NOT_PARSED)
def test_parse_errors(text):
    with pytest.raises(RP.ParseError) as ref:
        RP.parse_expression(text)
    with pytest.raises(PP.ParseError) as port:
        PP.parse_expression(text)
    assert port.value.error_class == ref.value.error_class \
        == "DELTA_FAILED_RECOGNIZE_PREDICATE"


def test_literal_kinds():
    """Strings, ints, floats, booleans and NULL parse to the reference's
    literal values, types included."""
    from delta_tpu.expressions.tree import In as RIn
    from delta_tpu_torch.expressions.tree import In as PIn

    text = "x IN ('a''b', 7, -7, 2.5, -0.25, 1.0e-3, TRUE, FALSE, NULL)"
    port, ref = PP.parse_expression(text), RP.parse_expression(text)
    assert isinstance(port, PIn) and isinstance(ref, RIn)
    assert [(type(v), v) for v in port.values] == \
        [(type(v), v) for v in ref.values]

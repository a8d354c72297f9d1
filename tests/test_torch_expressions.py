"""The port's expression evaluation against the JAX package's.

`delta_tpu_torch.expressions.eval.evaluate_predicate` over a `Batch` and
the reference's `evaluate_predicate_host` over the equal Arrow table, on
seeded batches with nulls in every column: every node type (comparisons
both ways round and between two columns, AND, OR, NOT, IS [NOT] NULL, IN
with and without NULL, STARTS WITH, boolean columns as predicates), so
that the Kleene cases (false beats NULL in AND, true beats NULL in OR)
all occur. The masks must be equal; where Arrow refuses the operand
types, the port must refuse too. The tree itself: `split_conjuncts` and
`repr` agree, and `references()`.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import delta_tpu.expressions.tree as RE
from delta_tpu.expressions.eval import evaluate_predicate_host
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch.expressions.eval import (
    UnsupportedComparison,
    evaluate,
    evaluate_predicate,
)
from delta_tpu_torch.models.batch import Batch, Column
from torch_scan_helpers import build

UTC = datetime.timezone.utc


def _data(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)

    def mask():
        return rng.random(n) < 0.2

    i = rng.integers(-5, 6, n)
    f = rng.normal(size=n).round(1)
    b = rng.random(n) < 0.5
    s = np.array([f"v{x}" for x in rng.integers(0, 12, n)], object)
    d = (np.datetime64("2024-01-01")
         + rng.integers(0, 5, n).astype("timedelta64[D]"))
    t = (np.datetime64("2024-01-01T00:00:00", "us")
         + (rng.integers(0, 5, n) * 3_600_000_000).astype("timedelta64[us]"))
    cols = {"i": (i, mask()), "j": (rng.integers(-5, 6, n), mask()),
            "f": (f, mask()), "b": (b, mask()), "c": (rng.random(n) < 0.5,
                                                      mask()),
            "s": (s, mask()), "d": (d, mask()), "t": (t, mask())}
    arrow = {}
    for name, (v, m) in cols.items():
        if name == "t":
            arrow[name] = pa.array(v.view(np.int64), pa.timestamp("us", "UTC"),
                                   mask=m)
        elif name == "d":
            arrow[name] = pa.array(v, pa.date32(), mask=m)
        elif name == "s":
            arrow[name] = pa.array(list(v), pa.string(), mask=m)
        else:
            arrow[name] = pa.array(v, mask=m)
    batch = Batch({name: Column(np.where(m, np.zeros_like(v), v)
                                if v.dtype != object else
                                np.where(m, "", v).astype(object), ~m)
                   for name, (v, m) in cols.items()})
    return pa.table(arrow), batch


SPECS = [
    ("cmp", "<", "i", 0, False), ("cmp", ">=", "i", 2, True),
    ("cmp", "=", "f", 0.5, False), ("cmp", "!=", "i", 1.0, False),
    ("cmp", "<=", "s", "v5", False), ("cmp", ">", "d",
                                      datetime.date(2024, 1, 3), False),
    ("cmp", "<", "t", datetime.datetime(2024, 1, 1, 2, tzinfo=UTC), False),
    ("cmp", ">=", "t", datetime.date(2024, 1, 1), True),
    ("cmp", "=", "b", True, False),
    ("and", ("cmp", "<", "i", 0, False), ("cmp", ">", "f", 0.0, False)),
    ("or", ("cmp", "<", "i", 0, False), ("cmp", ">", "f", 0.0, False)),
    ("and", ("or", ("null", "i"), ("cmp", "=", "s", "v3", False)),
     ("not", ("cmp", "<", "j", 1, False))),
    ("not", ("or", ("cmp", ">", "i", 3, False), ("notnull", "f"))),
    ("in", "i", (1, 2, 3)), ("in", "i", (1, None)), ("in", "s", ("v1", "v2")),
    ("in", "f", (0.5, -0.5)), ("in", "d", (datetime.date(2024, 1, 2),)),
    ("null", "s"), ("notnull", "t"), ("starts", "s", "v1"),
    ("not", ("starts", "s", "v1")),
    ("or", ("starts", "s", "v2"), ("null", "b")),
]


def _ref_mask(spec, table):
    return evaluate_predicate_host(build(spec, RE), table)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", range(len(SPECS)))
def test_predicates_match_reference(seed, k):
    table, batch = _data(seed)
    spec = SPECS[k]
    np.testing.assert_array_equal(
        evaluate_predicate(build(spec, PE), batch), _ref_mask(spec, table))


def _col_cmp(E, op, a, b):
    return E.Comparison(op, E.col(a), E.col(b))


@pytest.mark.parametrize("op", ["=", "!=", "<", "<=", ">", ">="])
@pytest.mark.parametrize("a,b", [("i", "j"), ("i", "f"), ("b", "c"),
                                 ("d", "t")])
def test_column_against_column(op, a, b):
    table, batch = _data(5)
    np.testing.assert_array_equal(
        evaluate_predicate(_col_cmp(PE, op, a, b), batch),
        evaluate_predicate_host(_col_cmp(RE, op, a, b), table))


def test_boolean_columns_and_kleene_logic():
    table, batch = _data(7)
    for e in ("and", "or"):
        spec = (e, ("cmp", "=", "b", True, False),
                ("cmp", "=", "c", True, False))
        np.testing.assert_array_equal(
            evaluate_predicate(build(spec, PE), batch),
            _ref_mask(spec, table))
    # a bare boolean column is a predicate: NULL drops the row
    np.testing.assert_array_equal(
        evaluate_predicate(PE.col("b") & PE.col("c"), batch),
        evaluate_predicate_host(RE.col("b") & RE.col("c"), table))
    k = evaluate(PE.col("b") | PE.col("c"), batch)
    ref = pa.compute.or_kleene(table["b"], table["c"]).combine_chunks()
    np.testing.assert_array_equal(k.known, ref.is_valid().to_numpy(
        zero_copy_only=False))


@pytest.mark.parametrize("spec", [
    ("cmp", "<", "i", "x", False), ("cmp", "=", "s", 1, False),
    ("cmp", "<", "t", datetime.datetime(2024, 1, 1), False),
    ("cmp", "<", "b", 1, False), ("starts", "i", "1"),
])
def test_refused_operand_types_match_reference(spec):
    table, batch = _data(1)
    with pytest.raises(Exception):
        _ref_mask(spec, table)
    with pytest.raises(UnsupportedComparison):
        evaluate_predicate(build(spec, PE), batch)


def test_missing_column_raises_key_error():
    _, batch = _data(0)
    with pytest.raises(KeyError):
        evaluate_predicate(PE.col("nope") > 1, batch)


def test_tree_split_repr_references():
    for spec in SPECS:
        r, p = build(spec, RE), build(spec, PE)
        assert repr(p) == repr(r)
        assert p.references() == r.references()
        assert [repr(c) for c in PE.split_conjuncts(p)] \
            == [repr(c) for c in RE.split_conjuncts(r)]
    # __eq__ builds a node: conjuncts are told apart by id
    a = PE.col("x") > 1
    assert isinstance(a == a, PE.Comparison)

"""Expression tree for scan filters, partition pruning and data skipping.

A copy of `delta_tpu/expressions/tree.py:20-204`, so that the port needs
nothing of the JAX package: the same small language (column references,
literals, comparisons, AND/OR/NOT, IS [NOT] NULL, IN, STARTS WITH), built
with `col()` / `lit()` and operators:

    (col("date") >= lit("2024-01-01")) & col("country").is_in("US", "CA")

`Expression.__eq__` BUILDS a Comparison node (it does not compare), so two
expressions are told apart by `id`, never with `==` or `in`. Host
evaluation lives in `eval.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple


class Expression:
    def __and__(self, other: "Expression") -> "Expression":
        return And(self, _as_expr(other))

    def __or__(self, other: "Expression") -> "Expression":
        return Or(self, _as_expr(other))

    def __invert__(self) -> "Expression":
        return Not(self)

    def _cmp(self, op: str, other) -> "Expression":
        return Comparison(op, self, _as_expr(other))

    def __eq__(self, other):  # type: ignore[override]
        return self._cmp("=", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp("!=", other)

    def __lt__(self, other):
        return self._cmp("<", other)

    def __le__(self, other):
        return self._cmp("<=", other)

    def __gt__(self, other):
        return self._cmp(">", other)

    def __ge__(self, other):
        return self._cmp(">=", other)

    def __hash__(self):
        return hash(repr(self))

    def is_null(self) -> "Expression":
        return IsNull(self)

    def is_not_null(self) -> "Expression":
        return IsNotNull(self)

    def is_in(self, *values) -> "Expression":
        return In(self, tuple(values))

    def starts_with(self, prefix: str) -> "Expression":
        return StartsWith(self, prefix)

    def references(self) -> set:
        """Set of column name-paths (tuples) referenced."""
        out = set()
        for child in self.children():
            out |= child.references()
        return out

    def children(self) -> Tuple["Expression", ...]:
        return ()


def _as_expr(v) -> Expression:
    return v if isinstance(v, Expression) else Literal(v)


@dataclass(frozen=True, eq=False)
class Column(Expression):
    """A (possibly nested) column reference; `name_path` is a tuple of
    field names, e.g. ("user", "id")."""

    name_path: Tuple[str, ...]

    def references(self) -> set:
        return {self.name_path}

    def __repr__(self):
        return f"col({'.'.join(self.name_path)})"


@dataclass(frozen=True, eq=False)
class Literal(Expression):
    value: Any

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclass(frozen=True, eq=False)
class Comparison(Expression):
    op: str  # one of = != < <= > >=
    left: Expression
    right: Expression

    VALID_OPS = ("=", "!=", "<", "<=", ">", ">=")

    def __post_init__(self):
        assert self.op in self.VALID_OPS, self.op

    def children(self):
        return (self.left, self.right)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclass(frozen=True, eq=False)
class And(Expression):
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def __repr__(self):
        return f"({self.left!r} AND {self.right!r})"


@dataclass(frozen=True, eq=False)
class Or(Expression):
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def __repr__(self):
        return f"({self.left!r} OR {self.right!r})"


@dataclass(frozen=True, eq=False)
class Not(Expression):
    child: Expression

    def children(self):
        return (self.child,)

    def __repr__(self):
        return f"(NOT {self.child!r})"


@dataclass(frozen=True, eq=False)
class IsNull(Expression):
    child: Expression

    def children(self):
        return (self.child,)


@dataclass(frozen=True, eq=False)
class IsNotNull(Expression):
    child: Expression

    def children(self):
        return (self.child,)


@dataclass(frozen=True, eq=False)
class In(Expression):
    child: Expression
    values: Tuple[Any, ...]

    def children(self):
        return (self.child,)


@dataclass(frozen=True, eq=False)
class StartsWith(Expression):
    child: Expression
    prefix: str

    def children(self):
        return (self.child,)


def col(name: str) -> Column:
    """`col("a.b")` references nested field b of struct a."""
    return Column(tuple(name.split(".")))


def lit(value) -> Literal:
    return Literal(value)


def split_conjuncts(expr: Expression) -> list:
    """Flatten nested ANDs into a conjunct list (used by pruning to apply
    each conjunct independently)."""
    if isinstance(expr, And):
        return split_conjuncts(expr.left) + split_conjuncts(expr.right)
    return [expr]

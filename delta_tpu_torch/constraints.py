"""CHECK constraints: ALTER TABLE ADD and DROP CONSTRAINT.

Counterpart of `delta_tpu/constraints.py` (Delta's `Constraints.scala`
and `AlterTableAddConstraint`). A constraint lives in the table's
properties as `delta.constraints.<name lowercased> = <sql>` (the
expression as `expressions/parser.py::to_sql` writes it) and binds every
later write (`write/writer.py`):

    from delta_tpu_torch.constraints import add_constraint, drop_constraint
    add_constraint(table, "qty_nonneg", "ss_quantity >= 0")
    drop_constraint(table, "qty_nonneg", if_exists=True)

ADD CONSTRAINT checks, in the reference's order: the name is new
(`ConstraintAlreadyExistsError`); the body is boolean on an empty batch
of the table's schema (DELTA_NON_BOOLEAN_CHECK_CONSTRAINT; a body that
cannot be typed there is left to the rows); every live row satisfies it
(DELTA_NEW_CHECK_CONSTRAINT_VIOLATION), a NULL result failing as the
reference's `evaluate_predicate_host` fills NULL with False. The rows
come from this package's scan and row read of the columns the body
names: deletion vectors applied (one K8 launch on the card). The commit
records a whole-table read, holds one metadata action and upgrades the
protocol to `checkConstraints`. DROP CONSTRAINT of a missing name raises
`ConstraintNotFoundError` unless `if_exists` (the read version returns,
nothing is committed).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from delta_tpu_torch.errors import (
    ConstraintAlreadyExistsError,
    ConstraintNotFoundError,
    InvalidArgumentError,
    InvariantViolationError,
    MissingTransactionLogError,
)
from delta_tpu_torch.expressions.eval import (
    UnsupportedComparison,
    evaluate_predicate,
    evaluate_values,
)
from delta_tpu_torch.expressions.parser import parse_expression, to_sql
from delta_tpu_torch.expressions.tree import Expression
from delta_tpu_torch.features import FEATURES, upgraded_protocol
from delta_tpu_torch.models.batch import Batch, Column
from delta_tpu_torch.models.schema import carried_type, schema_from_json
from delta_tpu_torch.scan import check_columns_exist
from delta_tpu_torch.txn.transaction import Operation

CONSTRAINT_PREFIX = "delta.constraints."


def constraint_key(name: str) -> str:
    return CONSTRAINT_PREFIX + name.lower()


def table_constraints(configuration: Dict[str, str]) -> Dict[str, Expression]:
    """Constraint name -> parsed predicate, from the table's properties."""
    return {k[len(CONSTRAINT_PREFIX):]: parse_expression(v)
            for k, v in configuration.items()
            if k.startswith(CONSTRAINT_PREFIX)}


def _check_boolean(name: str, expr: Expression, schema) -> None:
    """The body evaluated on an empty batch of the schema must be
    boolean; one that cannot be evaluated there is left to the rows."""
    empty = Batch({f.name: Column.nulls(f.numpy_dtype, 0,
                                        carried_type(f.data_type))
                   for f in schema.fields}, 0)
    try:
        kind = evaluate_values(expr, empty).kind
    except (UnsupportedComparison, KeyError, InvalidArgumentError):
        return
    if kind != "bool":
        raise InvalidArgumentError(
            f"CHECK constraint {name} must be a boolean expression, got "
            f"{kind}", error_class="DELTA_NON_BOOLEAN_CHECK_CONSTRAINT")


def add_constraint(table, name: str, expr) -> int:
    """ALTER TABLE ADD CONSTRAINT name CHECK (expr), after every live row
    is checked; returns the commit version."""
    if isinstance(expr, str):
        expr = parse_expression(expr)
    txn = table.create_transaction_builder(Operation.ADD_CONSTRAINT).build()
    snapshot = txn.read_snapshot
    if snapshot is None:
        raise MissingTransactionLogError(f"no table at {table.path}")
    meta = snapshot.metadata
    key = constraint_key(name)
    if key in meta.configuration:
        raise ConstraintAlreadyExistsError(f"constraint {name} already exists")
    schema = schema_from_json(meta.schemaString)
    check_columns_exist(schema, filter=expr)
    _check_boolean(name, expr, schema)
    names = sorted({r[0] for r in expr.references()})
    rows = snapshot.scan(columns=names or None).to_batch()
    if rows.num_rows:
        bad = int((~evaluate_predicate(expr, rows)).sum())
        if bad:
            raise InvariantViolationError(
                f"{bad} existing row(s) violate new constraint {name}: "
                f"{to_sql(expr)}",
                error_class="DELTA_NEW_CHECK_CONSTRAINT_VIOLATION")
    txn.mark_read_whole_table()
    txn.update_metadata(dataclasses.replace(
        meta, configuration=dict(meta.configuration, **{key: to_sql(expr)})))
    proto = txn.protocol()
    new_proto = upgraded_protocol(proto, FEATURES["checkConstraints"])
    if new_proto != proto:
        txn.update_protocol(new_proto)
    txn.set_operation_parameters({"name": name, "expr": to_sql(expr)})
    return txn.commit().version


def drop_constraint(table, name: str, if_exists: bool = False) -> int:
    """ALTER TABLE DROP CONSTRAINT [IF EXISTS] name; returns the commit
    version (the read version when nothing was dropped)."""
    txn = table.create_transaction_builder(Operation.DROP_CONSTRAINT).build()
    if txn.read_snapshot is None:
        raise MissingTransactionLogError(f"no table at {table.path}")
    meta = txn.metadata()
    key = constraint_key(name)
    if key not in meta.configuration:
        if if_exists:
            return txn.read_version
        raise ConstraintNotFoundError(f"constraint {name} does not exist")
    txn.update_metadata(dataclasses.replace(meta, configuration={
        k: v for k, v in meta.configuration.items() if k != key}))
    txn.set_operation_parameters({"name": name})
    return txn.commit().version

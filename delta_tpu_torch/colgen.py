"""Generated, identity and default columns on write, and which generated
columns depend on a column (ALTER TABLE's guard).

Counterpart of `delta_tpu/colgen.py` (Delta's `GeneratedColumn.scala`,
`IdentityColumn.scala`, `ColumnWithDefaultExprUtils.scala`), on this
package's `Batch` and `Column`:

    from delta_tpu_torch.colgen import (default_field, generated_field,
                                        identity_field)
    schema = StructType([identity_field("id", start=100, step=-5),
                         StructField("net", "double"),
                         generated_field("paid", "boolean", "net >= 0"),
                         default_field("channel", "string", "'store'")])

- a generated column (field metadata `delta.generationExpression`, an
  expression `expressions/parser.py` parses): missing on write it is
  computed from the row; supplied, every row must equal the expression's
  value (a NULL on either side is a mismatch, as the reference's
  `fill_null(not_equal, True)`): DELTA_GENERATED_COLUMNS_EXPR_TYPE_MISMATCH;
- an identity column (`delta.identity.start`, `.step`, `.highWaterMark`,
  `.allowExplicitInsert`): missing on write, its values run from the
  watermark (`start` when there is none) by `step`, and the watermark
  moves to the last value in the same commit (the schema comes back
  changed); supplied, it is refused unless `allowExplicitInsert`
  (DELTA_IDENTITY_COLUMNS_EXPLICIT_INSERT_NOT_SUPPORTED);
- a default column (`CURRENT_DEFAULT`, the `allowColumnDefaults` writer
  feature): missing on write, it is filled with its expression's value.

A computed value is cast to the column's type as Arrow's unsafe cast does
(`expressions/eval.py::cast_values`). `validate_generated_schema` holds
the declaration rules every metadata commit checks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from delta_tpu_torch.errors import IdentityColumnError, InvariantViolationError
from delta_tpu_torch.expressions.eval import (
    cast_values,
    column_values,
    compare,
    evaluate_values,
)
from delta_tpu_torch.expressions.parser import ParseError, parse_expression
from delta_tpu_torch.models.batch import Batch, Column
from delta_tpu_torch.models.schema import StructField, StructType, carried_type

GENERATION_EXPRESSION_KEY = "delta.generationExpression"
IDENTITY_START_KEY = "delta.identity.start"
IDENTITY_STEP_KEY = "delta.identity.step"
IDENTITY_HIGH_WATERMARK_KEY = "delta.identity.highWaterMark"
IDENTITY_ALLOW_EXPLICIT_KEY = "delta.identity.allowExplicitInsert"
CURRENT_DEFAULT_KEY = "CURRENT_DEFAULT"

GENERATION_KEYS = (GENERATION_EXPRESSION_KEY, IDENTITY_START_KEY,
                   IDENTITY_STEP_KEY, CURRENT_DEFAULT_KEY)


def is_identity(f: StructField) -> bool:
    return IDENTITY_START_KEY in f.metadata or IDENTITY_STEP_KEY in f.metadata


def generation_columns(schema: StructType) -> set:
    """The names of the schema's generated, identity and default
    columns."""
    return {f.name for f in schema.fields
            if any(k in f.metadata for k in GENERATION_KEYS)}


def needs_column_generation(schema: StructType) -> bool:
    return bool(generation_columns(schema))


def identity_field(name: str, start: int = 1, step: int = 1,
                   allow_explicit_insert: bool = False) -> StructField:
    """An identity column (long) of a new table's schema."""
    if step == 0:
        raise IdentityColumnError(
            "identity step must not be 0",
            error_class="DELTA_IDENTITY_COLUMNS_ILLEGAL_STEP")
    return StructField(name, "long", True, {
        IDENTITY_START_KEY: start, IDENTITY_STEP_KEY: step,
        IDENTITY_ALLOW_EXPLICIT_KEY: allow_explicit_insert})


def generated_field(name: str, data_type, expression: str) -> StructField:
    """A column computed by `expression` (parsed here, so that a bad one
    fails at once)."""
    parse_expression(expression)
    return StructField(name, data_type,
                       metadata={GENERATION_EXPRESSION_KEY: expression})


def default_field(name: str, data_type, default: str,
                  nullable: bool = True) -> StructField:
    """A column filled with `default` where a write leaves it out (the
    `allowColumnDefaults` writer feature)."""
    parse_expression(default)
    return StructField(name, data_type, nullable,
                       {CURRENT_DEFAULT_KEY: default})


def _computed(text: str, batch: Batch, f: StructField) -> Column:
    values, valid = cast_values(
        evaluate_values(parse_expression(text), batch), f.data_type)
    return Column(values, None if valid.all() else valid,
                  carried_type(f.data_type))


def _check_generated(f: StructField, gen: str, batch: Batch) -> None:
    """Every supplied value of generated column `f` equals its
    expression's, a NULL on either side counting as a difference
    (DELTA_GENERATED_COLUMNS_EXPR_TYPE_MISMATCH)."""
    actual, computed = batch.columns[f.name], _computed(gen, batch, f)
    ne = compare("!=", column_values(actual.values, actual.valid,
                                     actual.data_type),
                 column_values(computed.values, computed.valid,
                               computed.data_type))
    bad = int((ne.value | ~ne.known).sum())
    if bad:
        raise InvariantViolationError(
            f"{bad} row(s) violate generation expression of column "
            f"{f.name}: {gen}",
            error_class="DELTA_GENERATED_COLUMNS_EXPR_TYPE_MISMATCH")


def apply_column_generation(data: Batch, schema: StructType
                            ) -> Tuple[Batch, Optional[StructType]]:
    """`data` with its missing generated, identity and default columns
    filled and its supplied generated ones checked (module docstring), in
    schema order; the schema with each moved identity watermark, or None
    when none moved."""
    n = data.num_rows
    cols = dict(data.columns)
    fields = list(schema.fields)
    changed = False
    for i, f in enumerate(schema.fields):
        gen = f.metadata.get(GENERATION_EXPRESSION_KEY)
        identity = is_identity(f)
        default = f.metadata.get(CURRENT_DEFAULT_KEY)
        if default is not None and gen is None and not identity \
                and f.name not in cols:
            cols[f.name] = _computed(default, Batch(cols, n), f)
            continue
        if gen is not None:
            if f.name in cols:
                _check_generated(f, gen, Batch(cols, n))
            else:
                cols[f.name] = _computed(gen, Batch(cols, n), f)
            continue
        if not identity:
            continue
        if f.name in cols:
            if not bool(f.metadata.get(IDENTITY_ALLOW_EXPLICIT_KEY, False)):
                raise IdentityColumnError(
                    f"explicit values for identity column {f.name} are not "
                    "allowed (allowExplicitInsert=false)",
                    error_class=(
                        "DELTA_IDENTITY_COLUMNS_EXPLICIT_INSERT_NOT_SUPPORTED"))
            continue
        if n == 0:
            continue
        step = int(f.metadata.get(IDENTITY_STEP_KEY, 1))
        start = int(f.metadata.get(IDENTITY_START_KEY, 1))
        watermark = f.metadata.get(IDENTITY_HIGH_WATERMARK_KEY)
        first = start if watermark is None else int(watermark) + step
        values = first + step * np.arange(n, dtype=np.int64)
        cols[f.name] = Column(values.astype(f.numpy_dtype))
        md = dict(f.metadata)
        md[IDENTITY_HIGH_WATERMARK_KEY] = int(values[-1])
        fields[i] = StructField(f.name, f.data_type, f.nullable, md)
        changed = True
    order = [f.name for f in schema.fields if f.name in cols]
    order += [c for c in cols if c not in set(order)]
    return (Batch({c: cols[c] for c in order}, n),
            StructType(fields) if changed else None)


def regenerate_columns(rows: Batch, schema: StructType, assigned) -> Batch:
    """UPDATE's rows after their SET (`assigned`: the column names it
    set): a generated column that the SET left alone but whose expression
    reads a set column is computed again, as Delta recomputes it; one the
    SET assigned must equal its expression
    (DELTA_GENERATED_COLUMNS_EXPR_TYPE_MISMATCH). Every other column,
    identity ones too, keeps its value."""
    cols = dict(rows.columns)
    for f in schema.fields:
        gen = f.metadata.get(GENERATION_EXPRESSION_KEY)
        if gen is None:
            continue
        if f.name in assigned:
            _check_generated(f, gen, Batch(cols, rows.num_rows))
        elif {r[0] for r in parse_expression(gen).references()} & set(
                assigned):
            cols[f.name] = _computed(gen, Batch(cols, rows.num_rows), f)
    return Batch(cols, rows.num_rows)


def validate_generated_schema(schema: StructType,
                              partition_columns=()) -> None:
    """The declaration rules of generated and identity columns, checked
    at every metadata commit: an identity column is not generated, not a
    partition column, and long or integer; a generation expression
    parses and names only columns that exist and are neither generated
    nor identity columns."""
    names = {f.name for f in schema.fields}
    generated = {f.name for f in schema.fields
                 if GENERATION_EXPRESSION_KEY in f.metadata or is_identity(f)}
    pcols = set(partition_columns or ())
    for f in schema.fields:
        identity = is_identity(f)
        gen = f.metadata.get(GENERATION_EXPRESSION_KEY)
        if identity and gen is not None:
            raise IdentityColumnError(
                f"identity column {f.name} cannot also have a generation "
                "expression",
                error_class="DELTA_IDENTITY_COLUMNS_WITH_GENERATED_EXPRESSION")
        if identity and f.name in pcols:
            raise IdentityColumnError(
                f"identity column {f.name} cannot be a partition column "
                "(PARTITIONED BY is not supported for identity columns)",
                error_class="DELTA_IDENTITY_COLUMNS_PARTITION_NOT_SUPPORTED")
        if identity and f.data_type not in ("long", "integer"):
            raise IdentityColumnError(
                f"identity column {f.name} must be BIGINT or INT, got "
                f"{f.type_name}",
                error_class="DELTA_IDENTITY_COLUMNS_UNSUPPORTED_DATA_TYPE")
        if gen is None:
            continue
        try:
            refs = {r[0] for r in parse_expression(gen).references()}
        except Exception as e:
            raise InvariantViolationError(
                f"generation expression of {f.name} cannot be parsed: "
                f"{gen!r} ({e})",
                error_class="DELTA_UNSUPPORTED_EXPRESSION_GENERATED_COLUMN")
        bad = sorted((refs - names) | (refs & generated))
        if bad:
            raise InvariantViolationError(
                f"generation expression of {f.name} references non-existent "
                f"or generated column(s) {bad}",
                error_class="DELTA_INVALID_GENERATED_COLUMN_REFERENCES")


def generated_dependents(schema: StructType, column: str) -> List[str]:
    """Names of the generated columns whose expression references
    `column`, possibly a dotted nested path (an expression that does not
    parse references nothing)."""
    out = []
    for f in schema.fields:
        expr = f.metadata.get(GENERATION_EXPRESSION_KEY)
        if expr is None:
            continue
        try:
            refs = {".".join(r) for r in parse_expression(expr).references()}
        except ParseError:
            continue
        if any(_ref_overlaps(r, column) for r in refs):
            out.append(f.name)
    return out


def _ref_overlaps(ref: str, column: str) -> bool:
    """A dotted reference depends on `column` when either is a prefix
    path of the other: referencing `s.x` depends on both `s.x` and `s`;
    referencing `s` depends on every field under `s`."""
    return (ref == column or ref.startswith(column + ".")
            or column.startswith(ref + "."))

"""Which generated columns depend on a column: ALTER TABLE's guard.

The part of `delta_tpu/colgen.py:228-258` that RENAME and DROP COLUMN
need (`commands/alter.py::_check_dependent_columns`). Writing generated
columns is not ported: every write path refuses a table that has one.
"""

from __future__ import annotations

from typing import List

from delta_tpu_torch.expressions.parser import ParseError, parse_expression
from delta_tpu_torch.models.schema import StructType

GENERATION_EXPRESSION_KEY = "delta.generationExpression"


def _ref_overlaps(ref: str, column: str) -> bool:
    """A dotted reference depends on `column` when either is a prefix
    path of the other: referencing `s.x` depends on both `s.x` and `s`;
    referencing `s` depends on every field under `s`."""
    return (ref == column or ref.startswith(column + ".")
            or column.startswith(ref + "."))


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

"""The SELECT engine of the port's SQL surface.

Counterpart of `delta_tpu/sqlengine/`: the recursive-descent parser
(`parser.py`, the whole grammar) and an executor of queries (WITH
clauses, set operations, subqueries in FROM and in expressions) over the
port's Columns (`executor.py`) whose joins, lookups, membership tests,
aggregates and sorts run on the engine's device (`device.py`, kernel K10
for the aggregates), with scan pushdown into Delta snapshots.
"""

from delta_tpu_torch.sqlengine.parser import parse_query, parse_select
from delta_tpu_torch.sqlengine.executor import SqlResult, execute_select

__all__ = ["parse_query", "parse_select", "execute_select", "SqlResult"]

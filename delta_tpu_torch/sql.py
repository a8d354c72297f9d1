"""The SQL entry point of the port: query statements.

Counterpart of `delta_tpu/sql.py::sql` (`:110`) for the statements that
read:

    SELECT <cols|*> FROM <t> [VERSION AS OF n | TIMESTAMP AS OF <ms|'iso'>]
        [WHERE <pred>] [LIMIT n]                 (a scan: its Batch)
    SELECT * FROM table_changes(<t>, start[, end]) [LIMIT n]
    [WITH ...] SELECT ... (joins, GROUP BY, HAVING, ORDER BY, subqueries,
        UNION / INTERSECT / EXCEPT: `sqlengine/executor.py`, an
        `SqlResult`)

`<t>` is '/path', delta.`/path`, "/path", or a bare name resolved through
`catalog` (`catalog.py`). `path_guard(path)`, when given, is called for
every table path a statement names and may raise to refuse it.

Every other statement (MERGE INTO, INSERT, DELETE, UPDATE, VACUUM,
OPTIMIZE, DESCRIBE, RESTORE, CONVERT, ALTER, CREATE, DROP, SHOW) raises
`UnsupportedSqlError` naming it: the reference's `_catalog_statement`
(`:490`) and its commands are later slices.
"""

from __future__ import annotations

import contextvars
import datetime
import re

from delta_tpu_torch.errors import (
    CatalogTableError,
    SqlParseError,
    UnresolvedColumnError,
    UnsupportedSqlError,
)
from delta_tpu_torch.expressions.parser import ParseError, parse_expression
from delta_tpu_torch.table import Table

_PATH = (r"(?:'(?P<path>[^']+)'|delta\.`(?P<path2>[^`]+)`|\"(?P<path3>[^\"]+)\""
         r"|(?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)?))")

# the statements this package does not run yet, by their leading words
_OTHER_STATEMENTS = (
    ("MERGE", r"MERGE\s+INTO"), ("INSERT", r"INSERT"),
    ("DELETE", r"DELETE\s+FROM"), ("UPDATE", r"UPDATE"),
    ("VACUUM", r"VACUUM"), ("OPTIMIZE", r"OPTIMIZE"),
    ("DESCRIBE HISTORY", r"DESC(?:RIBE)?\s+HISTORY"),
    ("DESCRIBE DETAIL", r"DESC(?:RIBE)?\s+DETAIL"),
    ("RESTORE", r"RESTORE"), ("CONVERT TO DELTA", r"CONVERT\s+TO\s+DELTA"),
    ("ALTER TABLE", r"ALTER\s+TABLE"), ("CREATE TABLE", r"CREATE"),
    ("DROP TABLE", r"DROP"), ("SHOW TABLES", r"SHOW"),
)

_PATH_GUARD: contextvars.ContextVar = contextvars.ContextVar(
    "delta_torch_sql_path_guard", default=None)


def check_path(path: str) -> None:
    """Run the active `path_guard` (if any) on a table path."""
    guard = _PATH_GUARD.get()
    if guard is not None:
        guard(path)


def _path_of(m) -> str:
    path = m.group("path") or m.group("path2") or m.group("path3")
    check_path(path)
    return path


def _table(m, engine, catalog=None) -> Table:
    ident = m.groupdict().get("ident")
    if ident is not None:
        if catalog is None:
            raise CatalogTableError(
                f"table name {ident!r} requires a catalog (pass catalog=)",
                error_class="DELTA_MISSING_CATALOG")
        return catalog.table(ident)
    return Table.for_path(_path_of(m), engine)


def timestamp_ms(raw: str) -> int:
    """`<ms>` or `'<iso>'` -> epoch milliseconds."""
    if raw.startswith("'"):
        text = raw.strip("'")
        if text.endswith(("Z", "z")):
            text = text[:-1] + "+00:00"
        try:
            return int(datetime.datetime.fromisoformat(text).timestamp()
                       * 1000)
        except ValueError as e:
            raise SqlParseError(
                f"cannot parse timestamp {raw}: {e}",
                error_class="DELTA_INVALID_TIMESTAMP_FORMAT") from None
    return int(raw)


def sql(statement: str, engine=None, catalog=None, path_guard=None):
    """Execute one query statement (module docstring) against a table
    path or, with a catalog, a table name."""
    if path_guard is not None:
        token = _PATH_GUARD.set(path_guard)
        try:
            return sql(statement, engine=engine, catalog=catalog)
        finally:
            _PATH_GUARD.reset(token)
    s = statement.strip().rstrip(";").strip()
    if catalog is not None and engine is None:
        engine = catalog.engine
    result = _query_statement(s, engine, catalog)
    if result is not NotImplemented:
        return result
    for name, pattern in _OTHER_STATEMENTS:
        if re.match(pattern + r"\b", s, re.IGNORECASE):
            raise UnsupportedSqlError(
                f"{name} is not supported by this package's SQL yet",
                construct=name)
    raise SqlParseError(f"unsupported or malformed SQL: {s[:80]!r}")


def _exec_select_extended(s: str, engine, catalog):
    """SELECT beyond a plain projection: joins, aggregates, GROUP BY /
    HAVING, CASE, BETWEEN, date arithmetic, ORDER BY (the sqlengine)."""
    from delta_tpu_torch.sqlengine import execute_select

    return execute_select(s, engine=engine, catalog=catalog)


def _split_top_level_commas(s: str):
    out, depth, cur = [], 0, []
    in_str = False
    for ch in s:
        if ch == "'":
            in_str = not in_str
        elif not in_str:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                out.append("".join(cur))
                cur = []
                continue
        cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _simple_select(s: str, engine, catalog):
    """`SELECT <plain cols|*> FROM <one table> [time travel] [WHERE
    <pushdown-parseable pred>] [LIMIT n]` as the scan's own `Batch`, the
    column types as the table stores them; NotImplemented for anything
    richer."""
    m = re.fullmatch(
        rf"SELECT\s+(?P<cols>.+?)\s+FROM\s+{_PATH}"
        r"(?:\s+VERSION\s+AS\s+OF\s+(?P<tt_version>\d+)"
        r"|\s+TIMESTAMP\s+AS\s+OF\s+(?P<tt_ts>\d+|'[^']+'))?"
        r"(?:\s+WHERE\s+(?P<where>.+?))?(?:\s+LIMIT\s+(?P<limit>\d+))?",
        s, re.IGNORECASE | re.DOTALL)
    if not m:
        return NotImplemented
    cols_text = m.group("cols").strip()
    if cols_text == "*":
        columns = None
    else:
        columns = [c.strip().strip("`")
                   for c in _split_top_level_commas(cols_text)]
        if not all(re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", c)
                   for c in columns):
            return NotImplemented  # expressions or aliases: the sqlengine
    if m.group("where"):
        # NULL outside IS [NOT] NULL needs three-valued logic the
        # pushdown evaluator does not implement: the sqlengine
        stripped = re.sub(r"\bIS\s+(?:NOT\s+)?NULL\b", "", m.group("where"),
                          flags=re.IGNORECASE)
        if re.search(r"\bNULL\b", stripped, re.IGNORECASE):
            return NotImplemented
        try:
            pred = parse_expression(m.group("where"))
        except ParseError:
            return NotImplemented  # a richer predicate: the sqlengine
    else:
        pred = None
    table = _table(m, engine, catalog)
    if m.group("tt_version") is not None:
        snap = table.snapshot_at(int(m.group("tt_version")))
    elif m.group("tt_ts") is not None:
        snap = table.snapshot_as_of_timestamp(timestamp_ms(m.group("tt_ts")))
    else:
        snap = table.latest_snapshot()
    known = ({f.name for f in snap.schema.fields}
             if snap.schema is not None else set())
    # case-insensitive resolution, as the sqlengine resolves names
    by_lower = {k.lower(): k for k in known}
    requested = None
    if columns is not None and known:
        resolved, unknown = [], []
        for c in columns:
            actual = c if c in known else by_lower.get(c.lower())
            (resolved.append(actual) if actual is not None
             else unknown.append(c))
        if unknown:
            raise UnresolvedColumnError(
                f"column(s) {unknown} not found in table schema "
                f"{sorted(known)}")
        requested, columns = columns, resolved
    if pred is not None and known:
        refs = {r[0] for r in pred.references()}
        bad = sorted(r for r in refs
                     if r not in known and r.lower() not in by_lower)
        if bad:
            raise UnresolvedColumnError(
                f"WHERE references unknown column(s) {bad}; table schema "
                f"is {sorted(known)}")
        if any(r not in known for r in refs):
            return NotImplemented  # a case-folding predicate: the sqlengine
    out = snap.scan(filter=pred, columns=columns).to_batch()
    if requested is not None and requested != columns:
        # the output names carry the query's spelling, as the sqlengine's
        from delta_tpu_torch.models.batch import Batch

        out = Batch({q: out.column(c) for q, c in zip(requested, columns)},
                    out.num_rows)
    if m.group("limit"):
        out = out.slice(0, int(m.group("limit")))
    return out


_NESTED = re.compile(r"\b(?:UNION|INTERSECT|EXCEPT)\b|\(\s*SELECT\b",
                     re.IGNORECASE)


def _is_nested(s: str) -> bool:
    """Whether a SELECT holds a set operation or a subquery (outside its
    string literals): the sqlengine's, never `_simple_select`'s."""
    if not re.match(r"\(*\s*SELECT\b", s, re.IGNORECASE):
        return False
    return bool(_NESTED.search(re.sub(r"'[^']*'", "''", s)))


def _query_statement(s: str, engine, catalog):
    # table_changes(<t>, start [, end]): Delta's change data feed as a
    # table function, rows with _change_type, _commit_version and
    # _commit_timestamp
    m = re.fullmatch(
        rf"SELECT\s+\*\s+FROM\s+table_changes\s*\(\s*{_PATH}\s*,\s*"
        r"(?P<start>\d+)\s*(?:,\s*(?P<end>\d+)\s*)?\)"
        r"(?:\s+LIMIT\s+(?P<limit>\d+))?",
        s, re.IGNORECASE | re.DOTALL)
    if m:
        from delta_tpu_torch.read.cdc import table_changes

        out = table_changes(
            _table(m, engine, catalog), int(m.group("start")),
            int(m.group("end")) if m.group("end") else None)
        if m.group("limit"):
            out = out.slice(0, int(m.group("limit")))
        return out
    if re.match(r"WITH\b", s, re.IGNORECASE) or _is_nested(s):
        return _exec_select_extended(s, engine, catalog)
    if re.match(r"SELECT\b", s, re.IGNORECASE):
        result = _simple_select(s, engine, catalog)
        if result is not NotImplemented:
            return result
        return _exec_select_extended(s, engine, catalog)
    return NotImplemented

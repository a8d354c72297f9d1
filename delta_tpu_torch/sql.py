"""The SQL entry point of the port: Delta's statement set.

Counterpart of `delta_tpu/sql.py::sql` (`:110`). The queries:

    SELECT <cols|*> FROM <t> [VERSION AS OF n | TIMESTAMP AS OF <ms|'iso'>]
        [WHERE <pred>] [LIMIT n]                 (a scan: its Batch)
    SELECT * FROM table_changes(<t>, start[, end]) [LIMIT n]
    [WITH ...] SELECT ... (joins, GROUP BY, HAVING, ORDER BY, subqueries,
        UNION / INTERSECT / EXCEPT, windows: `sqlengine/executor.py`, an
        `SqlResult`)

The statements that change or describe a table, over the port's
commands (each returns what its command returns):

    INSERT INTO <t> [(cols)] VALUES (v1, ...)[, (...)]
    INSERT OVERWRITE <t> [(cols)] [REPLACE WHERE <pred>] VALUES (...)
    DELETE FROM <t> [WHERE <pred>]
    UPDATE <t> SET col = <expr>[, ...] [WHERE <pred>]
    MERGE INTO <t> [AS a] USING <t2> [AS b] ON <cond>
        WHEN MATCHED [AND c] THEN UPDATE SET ... | UPDATE SET * | DELETE
        WHEN NOT MATCHED [AND c] THEN INSERT * | INSERT (cols) VALUES (...)
        WHEN NOT MATCHED BY SOURCE [AND c] THEN DELETE | UPDATE SET ...
    OPTIMIZE <t> [WHERE <pred>] [ZORDER BY (c1, c2)]
    VACUUM <t> [RETAIN n HOURS] [LITE|FULL] [DRY RUN]   (any order)
    REORG TABLE <t> APPLY (PURGE)
    DESCRIBE HISTORY <t> [LIMIT n]  /  DESCRIBE DETAIL <t>
    RESTORE [TABLE] <t> TO VERSION AS OF n | TIMESTAMP AS OF <ms|'iso'>
    CONVERT TO DELTA parquet.`/path` [PARTITIONED BY (c type, ...)]
    GENERATE symlink_format_manifest FOR TABLE <t>
    ALTER TABLE <t> ADD CONSTRAINT name CHECK (<pred>)
                  | DROP CONSTRAINT [IF EXISTS] name
                  | SET TBLPROPERTIES (k = v, ...)
                  | UNSET TBLPROPERTIES [IF EXISTS] (k, ...)
                  | ADD COLUMNS (c type, ...) | RENAME COLUMN a TO b
                  | DROP COLUMN c | ALTER|CHANGE COLUMN c TYPE t
                  | DROP FEATURE f [TRUNCATE HISTORY]
    CREATE TABLE [IF NOT EXISTS] name (col type [NOT NULL] [DEFAULT v], ...)
        USING DELTA [PARTITIONED BY (c, ...)] [LOCATION '/path']
        [TBLPROPERTIES (k = v, ...)]                (catalog= needed)
    DROP TABLE [IF EXISTS] name  /  SHOW TABLES     (catalog= needed)

`<t>` is '/path', delta.`/path`, "/path", or a bare name resolved through
`catalog` (`catalog.py`). `path_guard(path)`, when given, is called for
every path a statement names (a table, MERGE's source, CONVERT's
directory, CREATE's LOCATION) and may raise to refuse it. WHERE, CHECK
and SET expressions use the persisted-expression subset
(`expressions/parser.py`).

Four constructs wait on modules not ported yet and raise
`UnsupportedSqlError` naming them (`_OTHER_STATEMENTS`): CREATE TABLE
... CLUSTER BY and ALTER TABLE ... CLUSTER BY (liquid clustering), OPTIMIZE
... FULL (it re-clusters a clustered table) and REORG ... UPGRADE UNIFORM.
Anything else that does not parse raises `SqlParseError`.

INSERT's VALUES are typed by the table's schema as Arrow's conversion
types them in the reference (a float into an integer column truncates
toward zero); where Arrow raises an error of its own (a string into a
date column, a float into a decimal column, a bool into a number, a
value out of range) this package raises `InvalidArgumentError`
(INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST, or
CAST_OVERFLOW_IN_TABLE_INSERT for a value out of range).
"""

from __future__ import annotations

import contextvars
import dataclasses
import datetime
import decimal
import math
import re

from delta_tpu_torch.errors import (
    CatalogTableError,
    ConvertTargetError,
    DuplicateColumnError,
    InvalidArgumentError,
    OptimizeArgumentError,
    SqlParseError,
    UnresolvedColumnError,
    UnsupportedSqlError,
)
from delta_tpu_torch.expressions.parser import ParseError, parse_expression
from delta_tpu_torch.expressions.tree import Column as ColumnRef
from delta_tpu_torch.expressions.tree import Expression, Literal
from delta_tpu_torch.table import Table

_PATH = (r"(?:'(?P<path>[^']+)'|delta\.`(?P<path2>[^`]+)`|\"(?P<path3>[^\"]+)\""
         r"|(?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)?))")
# a quoted path alone (no catalog name): CONVERT TO DELTA parquet.`/p`
_QUOTED_PATH = (r"(?:'(?P<path>[^']+)'|`(?P<path2>[^`]+)`"
                r"|\"(?P<path3>[^\"]+)\")")

# the constructs this package does not run yet, by name
_OTHER_STATEMENTS = (
    ("CREATE TABLE ... CLUSTER BY",
     r"CREATE\s+TABLE\b.*\)\s*USING\s+DELTA\b.*\bCLUSTER\s+BY\b"),
    ("ALTER TABLE ... CLUSTER BY", rf"ALTER\s+TABLE\s+{_PATH}\s+CLUSTER\s+BY\b"),
    # FULL with ZORDER BY is refused by the reference's own check
    ("OPTIMIZE ... FULL",
     rf"OPTIMIZE\s+{_PATH}\s+FULL\b(?!.*\bZORDER\s+BY\b)"),
    ("REORG ... UPGRADE UNIFORM",
     rf"REORG\s+TABLE\s+{_PATH}\s+APPLY\s*\(\s*UPGRADE\s+UNIFORM\b"),
)

_SQL_TYPES = {
    "int": "integer", "integer": "integer", "bigint": "long", "long": "long",
    "smallint": "short", "short": "short", "tinyint": "byte", "byte": "byte",
    "string": "string", "varchar": "string", "text": "string",
    "double": "double", "float": "float", "real": "float",
    "boolean": "boolean", "bool": "boolean", "date": "date",
    "timestamp": "timestamp", "binary": "binary",
}


def normalize_sql_type(t: str) -> str:
    """SQL type text -> Delta primitive name: BIGINT -> long, VARCHAR(20)
    -> string; DECIMAL(10,2) passes through."""
    type_text = re.sub(r"\s+", "", t.lower())
    base = type_text.split("(", 1)[0]
    if base in ("varchar", "char", "text"):
        return "string"  # the length is advisory
    return _SQL_TYPES.get(type_text, type_text)


_PATH_GUARD: contextvars.ContextVar = contextvars.ContextVar(
    "delta_torch_sql_path_guard", default=None)


def check_path(path: str) -> None:
    """Run the active `path_guard` (if any) on a path."""
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


def _columns(text: str) -> list:
    return [c.strip().strip("`") for c in text.split(",")]


def sql(statement: str, engine=None, catalog=None, path_guard=None):
    """Execute one statement (module docstring) against a table path or,
    with a catalog, a table name."""
    if path_guard is not None:
        token = _PATH_GUARD.set(path_guard)
        try:
            return sql(statement, engine=engine, catalog=catalog)
        finally:
            _PATH_GUARD.reset(token)
    s = statement.strip().rstrip(";").strip()
    if catalog is not None and engine is None:
        engine = catalog.engine
    for name, pattern in _OTHER_STATEMENTS:
        if re.match(pattern, s, re.IGNORECASE | re.DOTALL):
            raise UnsupportedSqlError(
                f"{name} is not supported by this package's SQL yet",
                construct=name)
    for handler in (_catalog_statement, _query_statement,
                    _maintenance_statement, _alter_statement,
                    _dml_statement):
        result = handler(s, engine, catalog)
        if result is not NotImplemented:
            return result
    raise SqlParseError(f"cannot parse Delta SQL statement: {statement!r}")


# ---------------------------------------------------------- the helpers --

def _parse_properties(text: str) -> dict:
    """`'k' = 'v', k2 = v2` -> a dict (quotes optional)."""
    props = {}
    for part in _split_top_level_commas(text):
        k, _, v = part.partition("=")
        props[k.strip().strip("'\"` ")] = v.strip().strip("'\"` ")
    return props


def _primitive_type(typ: str, what: str) -> str:
    from delta_tpu_torch.models.schema import _primitive

    if not _primitive(typ):
        raise SqlParseError(
            f"unsupported column type in {what!r}: {typ}",
            error_class="DELTA_PARSING_UNSUPPORTED_DATA_TYPE")
    return typ


def _parse_column_defs(text: str):
    """`name type [NOT NULL] [DEFAULT <literal>], ...` -> StructFields."""
    from delta_tpu_torch.colgen import CURRENT_DEFAULT_KEY
    from delta_tpu_torch.models.schema import StructField

    fields = []
    for part in _split_top_level_commas(text):
        part = part.strip()
        m = re.match(
            r"(?:`(?P<q>[^`]+)`|(?P<name>\w+))\s+"
            r"(?P<type>\w+(?:\s*\([^)]*\))?)\s*(?P<rest>.*)",
            part, re.IGNORECASE | re.DOTALL)
        if not m:
            raise SqlParseError(f"cannot parse column definition: {part!r}")
        name = m.group("q") or m.group("name")
        typ = normalize_sql_type(m.group("type"))
        nullable = True
        default = None
        rest = m.group("rest").strip()
        while rest:
            c = re.match(r"NOT\s+NULL\b\s*", rest, re.IGNORECASE)
            if c:
                nullable = False
                rest = rest[c.end():].strip()
                continue
            c = re.match(r"DEFAULT\s+(?P<d>'[^']*'|\S+)\s*", rest,
                         re.IGNORECASE)
            if c:
                default = c.group("d")
                try:  # fail at CREATE, not at the first write
                    d_expr = parse_expression(default)
                except Exception as e:
                    raise SqlParseError(
                        f"cannot parse DEFAULT expression {default!r}: {e}"
                    ) from None
                if d_expr.references():
                    # the protocol's column defaults are constants
                    raise SqlParseError(
                        f"DEFAULT must be a constant expression, got "
                        f"{default!r}")
                rest = rest[c.end():].strip()
                continue
            raise SqlParseError(
                f"cannot parse column constraint {rest!r} in {part!r}")
        metadata = {CURRENT_DEFAULT_KEY: default} if default is not None \
            else {}
        fields.append(StructField(name, _primitive_type(typ, part),
                                  nullable=nullable, metadata=metadata))
    return fields


def _split_before_keyword(s: str, keyword: str):
    """Split `s` at the first whitespace-delimited `keyword` outside
    single-quoted literals: (before, from_keyword), or (s, None) when it
    is absent."""
    kw = keyword.lower()
    in_str = False
    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if in_str:
            if ch == "'":
                in_str = False
            i += 1
            continue
        if ch == "'":
            in_str = True
            i += 1
            continue
        if s[i:i + len(kw)].lower() == kw:
            before_ok = i == 0 or s[i - 1].isspace()
            after = i + len(kw)
            after_ok = after >= n or s[after].isspace()
            if before_ok and after_ok:
                return s[:i], s[i:]
        i += 1
    return s, None


def _split_values_tuples(s: str):
    """`(1, 'a(b)'), (2, 'c,d')` -> ["1, 'a(b)'", "2, 'c,d'"]: the tuple
    bodies at paren depth 1, string literals kept whole."""
    out, cur, depth, in_str = [], [], 0, False
    for ch in s:
        if in_str:
            cur.append(ch)
            if ch == "'":
                in_str = False
            continue
        if ch == "'":
            in_str = True
            cur.append(ch)
        elif ch == "(":
            depth += 1
            if depth > 1:
                cur.append(ch)
        elif ch == ")":
            depth -= 1
            if depth == 0:
                out.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        elif depth >= 1:
            cur.append(ch)
        elif not ch.isspace() and ch != ",":
            raise SqlParseError(
                f"cannot parse VALUES tuples near {ch!r} in {s!r}")
    if depth != 0 or in_str:
        raise SqlParseError(f"unbalanced VALUES tuples: {s!r}")
    if cur:
        raise SqlParseError(
            f"unexpected content outside VALUES tuples: {''.join(cur)!r}")
    return out


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


# -------------------------------------------------- CREATE, DROP, SHOW --

def _catalog_statement(s: str, engine, catalog):
    m = re.fullmatch(
        r"CREATE\s+TABLE\s+(?P<ine>IF\s+NOT\s+EXISTS\s+)?"
        r"(?P<name>[A-Za-z_][A-Za-z0-9_.]*)\s*"
        r"\((?P<cols>.+?)\)\s*USING\s+DELTA"
        r"(?:\s+PARTITIONED\s+BY\s+\((?P<parts>[^)]+)\))?"
        r"(?:\s+LOCATION\s+'(?P<loc>[^']+)')?"
        r"(?:\s+TBLPROPERTIES\s*\((?P<props>.+)\))?",
        s, re.IGNORECASE | re.DOTALL)
    if m:
        if catalog is None:
            raise CatalogTableError("CREATE TABLE <name> requires a catalog")
        from delta_tpu_torch.models.schema import StructType

        schema = StructType(_parse_column_defs(m.group("cols")))
        if m.group("loc"):
            check_path(m.group("loc"))
        catalog.create_table(
            m.group("name"), schema=schema, location=m.group("loc"),
            partition_by=(_columns(m.group("parts")) if m.group("parts")
                          else None),
            properties=(_parse_properties(m.group("props"))
                        if m.group("props") else None),
            if_not_exists=m.group("ine") is not None)
        return m.group("name")

    m = re.fullmatch(r"DROP\s+TABLE\s+(?P<ife>IF\s+EXISTS\s+)?"
                     r"(?P<name>[A-Za-z_][A-Za-z0-9_.]*)", s, re.IGNORECASE)
    if m:
        if catalog is None:
            raise CatalogTableError("DROP TABLE <name> requires a catalog")
        return catalog.drop(m.group("name"),
                            if_exists=m.group("ife") is not None)

    if re.fullmatch(r"SHOW\s+TABLES", s, re.IGNORECASE):
        if catalog is None:
            raise CatalogTableError("SHOW TABLES requires a catalog")
        return catalog.tables()
    return NotImplemented


# ------------------------------------------------------ SELECT, INSERT --

def _exec_select_extended(s: str, engine, catalog):
    """SELECT beyond a plain projection: joins, aggregates, GROUP BY /
    HAVING, CASE, BETWEEN, date arithmetic, ORDER BY (the sqlengine)."""
    from delta_tpu_torch.sqlengine import execute_select

    return execute_select(s, engine=engine, catalog=catalog)


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

    m = re.fullmatch(
        rf"INSERT\s+(?:INTO|(?P<overwrite>OVERWRITE))\s+{_PATH}\s*"
        r"(?:\((?P<collist>[^)]+)\)\s*)?(?P<rest>.+)",
        s, re.IGNORECASE | re.DOTALL)
    if m:
        return _insert(m, engine, catalog)
    return NotImplemented


def _insert(m, engine, catalog):
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.models.batch import Batch
    from delta_tpu_torch.models.schema import schema_from_json

    rest = m.group("rest").strip()
    replace_where = None
    rw = re.match(r"REPLACE\s+WHERE\s+", rest, re.IGNORECASE)
    if rw:
        if not m.group("overwrite"):
            raise SqlParseError("REPLACE WHERE requires INSERT OVERWRITE",
                                error_class="DELTA_OPERATION_NOT_ALLOWED")
        pred_str, rest = _split_before_keyword(rest[rw.end():], "VALUES")
        if rest is None:
            raise SqlParseError("REPLACE WHERE must be followed by VALUES")
        replace_where = parse_expression(pred_str.strip())
    vm = re.match(r"VALUES\s+(?P<vals>.+)", rest, re.IGNORECASE | re.DOTALL)
    if not vm:
        raise SqlParseError("INSERT requires a VALUES clause")
    table = _table(m, engine, catalog)
    meta = table.latest_snapshot().metadata
    fields = {f.name: f for f in schema_from_json(meta.schemaString).fields}
    if m.group("collist"):
        targets = _columns(m.group("collist"))
        unknown = [c for c in targets if c not in fields]
        if unknown:
            raise UnresolvedColumnError(
                f"INSERT column(s) {unknown} not in schema")
        if len(set(targets)) != len(targets):
            raise DuplicateColumnError(
                f"duplicate INSERT column(s) in {targets}",
                error_class="DELTA_DUPLICATE_COLUMNS_ON_INSERT")
    else:
        targets = list(fields)
    rows = []
    for tup in _split_values_tuples(vm.group("vals")):
        vals = []
        for item in _split_top_level_commas(tup):
            expr = parse_expression(item.strip())
            if not isinstance(expr, Literal):
                raise SqlParseError(
                    f"INSERT VALUES must be literals, got {item!r}")
            vals.append(expr.value)
        rows.append(vals)
    if not rows:
        raise SqlParseError("INSERT requires at least one VALUES tuple")
    if any(len(r) != len(targets) for r in rows):
        raise SqlParseError(
            f"each VALUES tuple must have exactly {len(targets)} value(s) "
            f"for columns {targets}",
            error_class="DELTA_INSERT_COLUMN_ARITY_MISMATCH")
    batch = Batch({n: _values_column([r[i] for r in rows], fields[n])
                   for i, n in enumerate(targets)}, len(rows))
    return write_table(
        table.path, batch,
        mode="overwrite" if m.group("overwrite") else "append",
        replace_where=replace_where, engine=table.engine)


_INT_BITS = {"long": 64, "integer": 32, "short": 16, "byte": 8}
_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _cannot_cast(field, v) -> InvalidArgumentError:
    return InvalidArgumentError(
        f"cannot write {v!r} ({type(v).__name__}) into column "
        f"{field.name!r} of type {field.type_name}",
        error_class="INCOMPATIBLE_DATA_FOR_TABLE.CANNOT_SAFELY_CAST")


def _overflow(field, v) -> InvalidArgumentError:
    return InvalidArgumentError(
        f"{v!r} is out of range for column {field.name!r} of type "
        f"{field.type_name}", error_class="CAST_OVERFLOW_IN_TABLE_INSERT")


def _as_int(v, field) -> int:
    """An integer or a float truncated toward zero, as Arrow converts
    either into an integer type."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _cannot_cast(field, v)
    if isinstance(v, float):
        if not math.isfinite(v) or abs(v) >= 2.0 ** 63:
            raise _cannot_cast(field, v)
        return int(v)
    return v


def _insert_value(v, field):
    """One VALUES literal as a value of `field`'s type, or a typed error
    where Arrow's conversion refuses it."""
    if v is None:
        return None
    t = field.data_type
    if t in _INT_BITS:
        x = _as_int(v, field)
        half = 1 << (_INT_BITS[t] - 1)
        if not -half <= x < half:
            raise _overflow(field, v)
        return x
    if t in ("double", "float"):
        if isinstance(v, float):
            return v
        if isinstance(v, int):  # a bool too, as Arrow takes it
            if not -(1 << 63) <= v < (1 << 63):
                raise _overflow(field, v)
            return float(v)
        raise _cannot_cast(field, v)
    if t in ("string", "binary"):
        if not isinstance(v, str):
            raise _cannot_cast(field, v)
        return v if t == "string" else v.encode("utf-8")
    if t == "boolean":
        if not isinstance(v, bool):
            raise _cannot_cast(field, v)
        return v
    if t == "date":
        try:
            return _EPOCH_DATE + datetime.timedelta(days=_as_int(v, field))
        except OverflowError:
            raise _overflow(field, v) from None
    if t in ("timestamp", "timestamp_ntz"):
        base = _EPOCH_TS if t == "timestamp" else _EPOCH_TS.replace(
            tzinfo=None)
        try:
            return base + datetime.timedelta(
                microseconds=_as_int(v, field))
        except OverflowError:
            raise _overflow(field, v) from None
    from delta_tpu_torch.models.schema import decimal_precision_scale

    ps = decimal_precision_scale(t)
    if ps is not None:
        if isinstance(v, bool) or not isinstance(v, int):
            raise _cannot_cast(field, v)
        if abs(v) >= 10 ** (ps[0] - ps[1]):
            raise _overflow(field, v)
        return decimal.Decimal(v)
    raise _cannot_cast(field, v)  # a nested column takes no literal


def _values_column(values: list, field):
    from delta_tpu_torch.models.batch import column_from_python

    return column_from_python([_insert_value(v, field) for v in values],
                              field.data_type)


# ------------------------------------------ VACUUM, OPTIMIZE, DESCRIBE --

def _maintenance_statement(s: str, engine, catalog):
    m = re.fullmatch(
        # the modifiers in any order, as the grammar's
        # `(vacuumType|retain|dryRun)*`
        rf"VACUUM\s+{_PATH}"
        r"(?P<mods>(?:\s+(?:RETAIN\s+[\d.]+\s+HOURS|LITE|FULL"
        r"|DRY\s+RUN))*)", s, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.vacuum import vacuum

        mods = m.group("mods") or ""
        hours = re.search(r"RETAIN\s+([\d.]+)\s+HOURS", mods, re.IGNORECASE)
        vtype = re.search(r"\b(LITE|FULL)\b", mods, re.IGNORECASE)
        return vacuum(
            _table(m, engine, catalog),
            retention_hours=float(hours.group(1)) if hours else None,
            dry_run=re.search(r"DRY\s+RUN", mods, re.IGNORECASE) is not None,
            vacuum_type=vtype.group(1).upper() if vtype else "FULL")

    m = re.fullmatch(
        rf"OPTIMIZE\s+{_PATH}(?P<full>\s+FULL)?"
        r"(?:\s+WHERE\s+(?P<where>.+?))?"
        r"(?:\s+ZORDER\s+BY\s+\((?P<zcols>[^)]+)\))?", s, re.IGNORECASE)
    if m:
        if m.group("full"):  # only with ZORDER BY: `_OTHER_STATEMENTS`
            raise OptimizeArgumentError(
                "OPTIMIZE FULL re-clusters by the table's clustering "
                "columns; ZORDER BY cannot be combined with it",
                error_class="DELTA_CLUSTERING_WITH_ZORDER_BY")
        builder = _table(m, engine, catalog).optimize()
        if m.group("where"):
            builder = builder.where(parse_expression(m.group("where")))
        if m.group("zcols"):
            return builder.execute_zorder_by(*_columns(m.group("zcols")))
        return builder.execute_compaction()

    m = re.fullmatch(rf"REORG\s+TABLE\s+{_PATH}\s+APPLY\s*\(\s*PURGE\s*\)",
                     s, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.reorg import reorg_purge

        return reorg_purge(_table(m, engine, catalog))

    m = re.fullmatch(rf"(?:DESC|DESCRIBE)\s+HISTORY\s+{_PATH}"
                     r"(?:\s+LIMIT\s+(?P<limit>\d+))?", s, re.IGNORECASE)
    if m:
        limit = int(m.group("limit")) if m.group("limit") else None
        return [r.to_dict() for r in _table(m, engine, catalog)
                .history(limit)]

    m = re.fullmatch(rf"(?:DESC|DESCRIBE)\s+DETAIL\s+{_PATH}", s,
                     re.IGNORECASE)
    if m:
        return describe_detail(_table(m, engine, catalog))

    m = re.fullmatch(
        rf"RESTORE\s+(?:TABLE\s+)?{_PATH}\s+TO\s+(?:VERSION\s+AS\s+OF\s+"
        r"(?P<v>\d+)|TIMESTAMP\s+AS\s+OF\s+(?:(?P<ms>\d+)|'(?P<iso>[^']+)'))",
        s, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.restore import restore

        table = _table(m, engine, catalog)
        if m.group("v") is not None:
            return restore(table, version=int(m.group("v")))
        raw = m.group("ms") or f"'{m.group('iso')}'"
        return restore(table, timestamp_ms=timestamp_ms(raw))

    m = re.fullmatch(
        rf"CONVERT\s+TO\s+DELTA\s+(?:(?P<prov>\w+)\.)?{_QUOTED_PATH}"
        r"(?:\s+PARTITIONED\s+BY\s+\((?P<parts>[^)]+)\))?",
        s, re.IGNORECASE)
    if m:
        return _convert(m, engine)

    m = re.fullmatch(
        rf"GENERATE\s+symlink_format_manifest\s+FOR\s+TABLE\s+{_PATH}",
        s, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.generate import (
            generate_symlink_manifest,
        )

        return generate_symlink_manifest(_table(m, engine, catalog))
    return NotImplemented


def _convert(m, engine):
    from delta_tpu_torch.commands.restore import convert_to_delta

    prov = m.group("prov")
    if prov is None:
        # `DeltaErrors.missingProviderForConvertException`
        raise ConvertTargetError(
            "CONVERT TO DELTA requires a provider prefix, e.g. "
            "parquet.`/path`",
            error_class="DELTA_MISSING_PROVIDER_FOR_CONVERT")
    if prov.lower() != "parquet":
        # `DeltaErrors.convertNonParquetTablesException`
        raise ConvertTargetError(
            f"CONVERT TO DELTA only supports parquet tables, got provider "
            f"{prov!r}", error_class="DELTA_CONVERT_NON_PARQUET_TABLE")
    part_schema = None
    if m.group("parts"):
        part_schema = {}
        for item in m.group("parts").split(","):
            name, _, typ = item.strip().partition(" ")
            part_schema[name.strip("`")] = typ.strip() or "string"
    return convert_to_delta(_path_of(m), partition_schema=part_schema,
                            engine=engine)


def describe_detail(table: Table) -> dict:
    """DESCRIBE DETAIL's row (the reference's `DeltaTableV2` detail)."""
    snap = table.latest_snapshot()
    meta = snap.metadata
    proto = snap.protocol
    return {
        "format": meta.format.provider,
        "id": meta.id,
        "name": meta.name,
        "description": meta.description,
        "location": table.path,
        "createdAt": meta.createdTime,
        "lastModified": snap.timestamp_ms,
        "partitionColumns": list(meta.partitionColumns),
        "numFiles": snap.num_files,
        "sizeInBytes": snap.size_in_bytes,
        "properties": dict(meta.configuration),
        "minReaderVersion": proto.minReaderVersion,
        "minWriterVersion": proto.minWriterVersion,
        "tableFeatures": sorted(proto.reader_feature_set()
                                | proto.writer_feature_set()),
        "version": snap.version,
    }


# ---------------------------------------------------------------- ALTER --

def _alter_statement(s: str, engine, catalog):
    head = re.match(rf"ALTER\s+TABLE\s+{_PATH}\s+", s, re.IGNORECASE)
    if not head:
        return NotImplemented
    rest = s[head.end():]

    def table():
        return _table(head, engine, catalog)

    m = re.fullmatch(r"ADD\s+CONSTRAINT\s+(?P<name>\w+)\s+"
                     r"CHECK\s*\((?P<expr>.+)\)", rest, re.IGNORECASE)
    if m:
        from delta_tpu_torch.constraints import add_constraint

        return add_constraint(table(), m.group("name"), m.group("expr"))

    m = re.fullmatch(r"DROP\s+CONSTRAINT\s+(?P<ife>IF\s+EXISTS\s+)?"
                     r"(?P<name>\w+)", rest, re.IGNORECASE)
    if m:
        from delta_tpu_torch.constraints import drop_constraint

        return drop_constraint(table(), m.group("name"),
                               if_exists=m.group("ife") is not None)

    m = re.fullmatch(r"SET\s+TBLPROPERTIES\s*\((?P<props>.+)\)", rest,
                     re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.alter import set_properties

        return set_properties(table(), _parse_properties(m.group("props")))

    m = re.fullmatch(r"UNSET\s+TBLPROPERTIES\s*(?P<ife>IF\s+EXISTS\s*)?"
                     r"\((?P<props>.+)\)", rest, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.alter import unset_properties

        keys = [k.strip().strip("'\"`")
                for k in _split_top_level_commas(m.group("props"))]
        return unset_properties(table(), keys,
                                if_exists=m.group("ife") is not None)

    m = re.fullmatch(r"ADD\s+COLUMNS?\s*\((?P<cols>.+)\)", rest,
                     re.IGNORECASE | re.DOTALL)
    if m:
        from delta_tpu_torch.commands.alter import add_columns

        return add_columns(table(), _parse_column_defs(m.group("cols")))

    m = re.fullmatch(r"RENAME\s+COLUMN\s+`?(?P<old>\w+)`?\s+TO\s+"
                     r"`?(?P<new>\w+)`?", rest, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.alter import rename_column

        return rename_column(table(), m.group("old"), m.group("new"))

    m = re.fullmatch(r"DROP\s+COLUMN\s+`?(?P<col>\w+)`?", rest,
                     re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.alter import drop_column

        return drop_column(table(), m.group("col"))

    m = re.fullmatch(r"(?:ALTER|CHANGE)\s+COLUMN\s+`?(?P<col>\w+)`?\s+TYPE\s+"
                     r"(?P<typ>\w+)", rest, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.alter import change_column_type

        from delta_tpu_torch.models.schema import _primitive

        typ = m.group("typ").lower()
        new_type = _SQL_TYPES.get(typ, typ)
        if not _primitive(new_type):
            raise SqlParseError(f"unknown primitive type: {new_type}")
        return change_column_type(table(), m.group("col"), new_type)

    m = re.fullmatch(r"DROP\s+FEATURE\s+`?(?P<feat>\w+)`?"
                     r"(?P<trunc>\s+TRUNCATE\s+HISTORY)?", rest,
                     re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.dropfeature import drop_feature

        return drop_feature(table(), m.group("feat"),
                            truncate_history=m.group("trunc") is not None)
    return NotImplemented


# ------------------------------------------ MERGE, DELETE and UPDATE ----

def _dml_statement(s: str, engine, catalog):
    if re.match(r"MERGE\s+INTO\s+", s, re.IGNORECASE):
        return _merge_into(s, engine, catalog)

    m = re.fullmatch(rf"DELETE\s+FROM\s+{_PATH}(?:\s+WHERE\s+(?P<where>.+))?",
                     s, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.dml import delete

        pred = parse_expression(m.group("where")) if m.group("where") \
            else None
        return delete(_table(m, engine, catalog), pred)

    m = re.fullmatch(rf"UPDATE\s+{_PATH}\s+SET\s+(?P<sets>.+?)"
                     r"(?:\s+WHERE\s+(?P<where>.+))?", s, re.IGNORECASE)
    if m:
        from delta_tpu_torch.commands.dml import update

        assignments = {}
        for part in _split_top_level_commas(m.group("sets")):
            col_name, _, value = part.partition("=")
            assignments[col_name.strip().strip("`")] = \
                parse_expression(value.strip())
        pred = parse_expression(m.group("where")) if m.group("where") \
            else None
        return update(_table(m, engine, catalog), assignments, pred)
    return NotImplemented


def _requalify(expr, alias_t, alias_s):
    """The expression with its alias roots rewritten onto MERGE's
    `target.` / `source.` namespaces, on the tree (string literals are
    never touched): every child of a node lies in a field that holds an
    Expression, so a `dataclasses.replace` rebuild is exact."""
    if isinstance(expr, ColumnRef):
        root = expr.name_path[0]
        if alias_t is not None and root == alias_t:
            return ColumnRef(("target",) + tuple(expr.name_path[1:]))
        if alias_s is not None and root == alias_s:
            return ColumnRef(("source",) + tuple(expr.name_path[1:]))
        return expr
    if not expr.children():
        return expr
    updates = {}
    for f in dataclasses.fields(expr):
        v = getattr(expr, f.name)
        if isinstance(v, Expression):
            nv = _requalify(v, alias_t, alias_s)
            if nv is not v:
                updates[f.name] = nv
    return dataclasses.replace(expr, **updates) if updates else expr


def _merge_into(s: str, engine, catalog):
    """MERGE INTO <t> [AS a] USING <t2> [AS b] ON <cond> WHEN ..., parsed
    step by step so that table tokens, aliases and keywords inside string
    literals all resolve."""
    from delta_tpu_torch.commands.merge import merge

    def take_table(text):
        m = re.match(_PATH, text)
        if not m:
            raise SqlParseError(
                f"cannot parse table reference near {text[:40]!r}")
        return m, text[m.end():].lstrip()

    def take_alias(text):
        m = re.match(r"(?:AS\s+)?([A-Za-z_][A-Za-z0-9_]*)\s+", text,
                     re.IGNORECASE)
        if m and m.group(1).upper() not in ("USING", "ON", "WHEN"):
            return m.group(1), text[m.end():]
        return None, text

    rest = s[re.match(r"MERGE\s+INTO\s+", s, re.IGNORECASE).end():]
    t_m, rest = take_table(rest)
    alias_t, rest = take_alias(rest)
    um = re.match(r"USING\s+", rest, re.IGNORECASE)
    if not um:
        raise SqlParseError("MERGE INTO requires a USING clause")
    s_m, rest = take_table(rest[um.end():])
    alias_s, rest = take_alias(rest)
    onm = re.match(r"ON\s+", rest, re.IGNORECASE)
    if not onm:
        raise SqlParseError("MERGE INTO requires an ON condition")
    on_text, rest = _split_before_keyword(rest[onm.end():], "WHEN")
    if rest is None:
        raise SqlParseError("MERGE INTO requires at least one WHEN clause")
    clause_texts = []
    while rest is not None:
        rest = rest[len("WHEN"):].strip() if rest[:4].upper() == "WHEN" \
            else rest
        body, rest = _split_before_keyword(rest, "WHEN")
        clause_texts.append(body.strip())

    def requalify(expr):
        return _requalify(expr, alias_t, alias_s)

    target = _table(t_m, engine, catalog)
    source = _table(s_m, engine, catalog).latest_snapshot().scan().to_batch()
    builder = merge(target, source,
                    on=requalify(parse_expression(on_text.strip())))

    def parse_sets(text):
        out = {}
        for part in _split_top_level_commas(text):
            lhs, _, rhs = part.partition("=")
            name = lhs.strip().strip("`")
            for pre in (f"{alias_t}." if alias_t else None, "target."):
                if pre and name.startswith(pre):
                    name = name[len(pre):]
            out[name] = requalify(parse_expression(rhs.strip()))
        return out

    def sets_of(action):
        return parse_sets(re.sub(r"^UPDATE\s+SET\s*", "", action,
                                 flags=re.IGNORECASE))

    for text in clause_texts:
        # the condition ends at a THEN outside string literals
        before_then, from_then = _split_before_keyword(text, "THEN")
        if from_then is None:
            raise SqlParseError(f"cannot parse MERGE clause: {text[:60]!r}")
        km = re.match(
            r"(?P<kind>MATCHED|NOT\s+MATCHED\s+BY\s+SOURCE|NOT\s+MATCHED)"
            r"(?:\s+AND\s+(?P<cond>.+))?\s*$",
            before_then.strip(), re.IGNORECASE | re.DOTALL)
        if not km:
            raise SqlParseError(f"cannot parse MERGE clause: {text[:60]!r}")
        kind = re.sub(r"\s+", " ", km.group("kind").upper())
        cond = (requalify(parse_expression(km.group("cond").strip()))
                if km.group("cond") else None)
        action = from_then[len("THEN"):].strip()
        a_up = re.sub(r"\s+", " ", action.upper())
        if kind == "MATCHED":
            if a_up == "DELETE":
                builder = builder.when_matched_delete(condition=cond)
            elif a_up in ("UPDATE SET *", "UPDATE *"):
                builder = builder.when_matched_update_all(condition=cond)
            elif a_up.startswith("UPDATE SET"):
                builder = builder.when_matched_update(set=sets_of(action),
                                                      condition=cond)
            else:
                raise SqlParseError(f"unsupported MATCHED action {action!r}")
        elif kind == "NOT MATCHED":
            if a_up == "INSERT *":
                builder = builder.when_not_matched_insert_all(condition=cond)
                continue
            im = re.match(r"INSERT\s*\((?P<cols>[^)]+)\)\s*VALUES\s*"
                          r"\((?P<vals>.+)\)\s*$", action,
                          re.IGNORECASE | re.DOTALL)
            if not im:
                raise SqlParseError(
                    f"unsupported NOT MATCHED action {action!r}")
            cols = _columns(im.group("cols"))
            vals = [requalify(parse_expression(v.strip()))
                    for v in _split_top_level_commas(im.group("vals"))]
            if len(cols) != len(vals):
                raise SqlParseError(
                    "INSERT column/value count mismatch",
                    error_class="DELTA_INSERT_COLUMN_ARITY_MISMATCH")
            builder = builder.when_not_matched_insert(
                values=dict(zip(cols, vals)), condition=cond)
        else:  # NOT MATCHED BY SOURCE
            if a_up == "DELETE":
                builder = builder.when_not_matched_by_source_delete(
                    condition=cond)
            elif a_up.startswith("UPDATE SET"):
                builder = builder.when_not_matched_by_source_update(
                    set=sets_of(action), condition=cond)
            else:
                raise SqlParseError(
                    f"unsupported NOT MATCHED BY SOURCE action {action!r}")
    return builder.execute()

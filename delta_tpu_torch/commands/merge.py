"""MERGE INTO: upserts with matched, not-matched and not-matched-by-source
clauses.

Counterpart of `delta_tpu/commands/merge.py` (Delta's
`MergeIntoCommand.scala` and `ClassicMergeExecutor.scala`):

    from delta_tpu_torch.commands.merge import merge
    (merge(table, source, on=(col("target.id") == col("source.id"))
        .when_matched_update(set={"v": col("source.v")})
        .when_matched_delete(condition=col("source.op") == lit("del"))
        .when_not_matched_insert(values={"id": col("source.id"), ...})
        .when_not_matched_by_source_delete()
        .execute())

`source` is a `models.batch.Batch` or a dict of numpy columns (as
`api.write_table` takes them). Conditions and values are expressions over
a `NamespacedBatch`: the target's columns are `target.<name>`, the
source's `source.<name>`. A value is an expression or a constant; an
`*_all` clause takes the source column of each target column's name
(case-insensitively), cast as Arrow's unsafe cast does.

1. The candidates are the files `txn.scan_files(filter=)` keeps (data
   skipping, K7 on the card; partition pruning): with no
   not-matched-by-source clause, under the source's [min, max] of each
   equi-key (`_source_key_bounds`), else every file. Their rows are read
   with partition columns, their deletion vectors applied (one K8 launch
   on the card), so soft-deleted rows neither match nor come back.
2. The join. The ON condition splits into target/source equi-key pairs
   and residual conjuncts (`_equi_keys`); NULL keys never match, NaN
   matches NaN. A pure equi-join of at least `DEVICE_JOIN_MIN_ROWS` rows
   runs on the engine's device (`ops/join.py::equi_join_device`: joint
   codes on the host, a stable sort and K9 on the card), one source row
   per target row; otherwise the host pair join, then the residual
   conjuncts over the pairs. A target row matched by two source rows
   under a matched clause raises `MergeCardinalityError`.
3. Clauses resolve in order, the first whose condition holds wins:
   matched pairs update or delete; unmatched source rows insert;
   unmatched target rows update or delete (not matched by source).
4. Every touched file is removed and its kept and updated rows written
   again (copy-on-write, the partitioned writer), the inserts appended,
   in one commit (`Operation.MERGE`, the ON condition as its
   `predicate`, the reference's metrics; the scan's predicate recorded
   for the conflict check). Nothing touched commits nothing (but an
   evolved schema). On a table with the change data feed on, the commit
   carries the change data (`commands/dml.py::stage_change_data`): the
   deleted target rows as `delete`, each updated row before and after
   as `update_preimage` and `update_postimage` (a not-matched-by-source
   update too, as Delta writes it; the reference writes none for it,
   ROADMAP C27), the inserted rows as `insert`; rows written before the
   schema evolved read the new columns as null there too.

Schema evolution (`with_schema_evolution()`): the table evolves by the
source columns a clause consumes, every source-only column under an
`*_all` clause and each new column an assignment names, added nullable in
sorted order without widening (`schema_evolution.py::merge_schemas`, as
the reference); a column-mapped table gives them ids and `col-` physical
names (`columnmapping.py::assign_column_mapping`). The rows written before
read the new columns as NULL, and the evolved metadata commits with the
files (alone, when nothing else is touched).

Generated, identity and default columns: an inserted row's unassigned
ones are filled and its assigned generated ones checked
(`colgen.py::apply_column_generation`; an explicit identity value needs
`allowExplicitInsert`), and the moved identity watermark commits with the
files; an updated row's generated columns are computed again where an
assignment changes what they read, and checked where assigned. (The
reference leaves them NULL, does not move the watermark and leaves a
generated column stale: ROADMAP C24.) An UPDATE of an identity column,
explicit or by `UPDATE SET *` from a source that holds it, raises
DELTA_IDENTITY_COLUMNS_UPDATE_NOT_SUPPORTED. The table's CHECK
constraints hold every written row (`write/writer.py`).

A `target.<name>` that names a column the target lacks raises
`NonExistentColumnError` before anything is read. Refused as in the
reference: no clause, an unconditional clause before the last of its
kind, a duplicate assignment, an assignment to or an `*_all` over a
column the target lacks (without schema evolution). Refused before
anything is written (`UnsupportedTableError`): what
`check_write_supported` refuses. A column-mapped table merges as any
other: its keys, conditions and assignments name logical columns, the
read renames the files' physical ones, and the writer writes physical
names.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from delta_tpu_torch.colgen import (
    apply_column_generation,
    generation_columns,
    is_identity,
    regenerate_columns,
)
from delta_tpu_torch.columnmapping import assign_column_mapping, is_mapped
from delta_tpu_torch.commands.dml import stage_change_data
from delta_tpu_torch.config import cdf_enabled
from delta_tpu_torch.errors import (
    DeltaError,
    IdentityColumnError,
    InvalidArgumentError,
    MissingTransactionLogError,
)
from delta_tpu_torch.expressions.eval import (
    cast_values,
    column_values,
    constant_values,
    evaluate_predicate,
    evaluate_values,
)
from delta_tpu_torch.expressions.tree import (
    Column as ColumnRef,
    Comparison,
    Expression,
    Literal,
    split_conjuncts,
)
from delta_tpu_torch.models.batch import (
    Batch,
    Column,
    NamespacedBatch,
    as_column,
    decimal_value,
)
from delta_tpu_torch.models.schema import (
    StructField,
    StructType,
    carried_type,
    decimal_precision_scale,
    schema_from_json,
    schema_to_json,
    type_name_of,
)
from delta_tpu_torch.obs import PhaseTimer
from delta_tpu_torch.ops.join import equi_join_device, host_pair_join
from delta_tpu_torch.read.reader import read_add_files_logical
from delta_tpu_torch.scan import check_columns_exist
from delta_tpu_torch.schema_evolution import merge_schemas
from delta_tpu_torch.txn.transaction import Operation, check_write_supported
from delta_tpu_torch.write.writer import check_rows, write_data_files

# pure equi-joins of at least this many rows (target + source, NULL keys
# left out) take the device join; tests lower it to 0
DEVICE_JOIN_MIN_ROWS = 65_536
_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


class MergeCardinalityError(DeltaError):
    error_class = "DELTA_MULTIPLE_SOURCE_ROW_MATCHING_TARGET_ROW_IN_MERGE"


@dataclass
class MergeClause:
    kind: str  # update | delete | insert
    condition: Optional[Expression] = None
    assignments: Optional[Dict[str, object]] = None  # None: *_all


@dataclass
class MergeMetrics:
    num_target_rows_updated: int = 0
    num_target_rows_deleted: int = 0
    num_target_rows_inserted: int = 0
    num_target_rows_copied: int = 0
    num_target_files_rewritten: int = 0
    num_target_files_scanned: int = 0
    num_source_rows: int = 0
    version: Optional[int] = None
    # wall seconds of the command's phases (snapshot, scan, read, the
    # join's encode, h2d, sort, tail and d2h or join_host, resolve,
    # write, commit); not one of the reference's metrics
    phase_seconds: Dict[str, float] = field(default_factory=dict)


class MergeBuilder:
    def __init__(self, table, source, on: Expression):
        self._table = table
        self._source = _as_batch(source)
        self._on = on
        self._matched: List[MergeClause] = []
        self._not_matched: List[MergeClause] = []
        self._not_matched_by_source: List[MergeClause] = []
        self._schema_evolution = False

    def with_schema_evolution(self) -> "MergeBuilder":
        """Evolve the target schema by the source columns the clauses
        consume (the reference's `withSchemaEvolution()`; module
        docstring)."""
        self._schema_evolution = True
        return self

    def when_matched_update(self, set: Dict[str, object], condition=None):
        self._matched.append(MergeClause("update", condition, dict(set)))
        return self

    def when_matched_update_all(self, condition=None):
        self._matched.append(MergeClause("update", condition, None))
        return self

    def when_matched_delete(self, condition=None):
        self._matched.append(MergeClause("delete", condition))
        return self

    def when_not_matched_insert(self, values: Dict[str, object],
                                condition=None):
        self._not_matched.append(MergeClause("insert", condition,
                                             dict(values)))
        return self

    def when_not_matched_insert_all(self, condition=None):
        self._not_matched.append(MergeClause("insert", condition, None))
        return self

    def when_not_matched_by_source_update(self, set: Dict[str, object],
                                          condition=None):
        self._not_matched_by_source.append(
            MergeClause("update", condition, dict(set)))
        return self

    def when_not_matched_by_source_delete(self, condition=None):
        self._not_matched_by_source.append(MergeClause("delete", condition))
        return self

    def execute(self) -> MergeMetrics:
        self._validate_clauses()
        return _execute_merge(
            self._table, self._source, self._on, self._matched,
            self._not_matched, self._not_matched_by_source,
            schema_evolution=self._schema_evolution)

    def _validate_clauses(self) -> None:
        """A MERGE needs a WHEN clause; within each clause family only the
        last may omit its condition (an earlier unconditional clause would
        shadow the rest)."""
        if not (self._matched or self._not_matched
                or self._not_matched_by_source):
            raise InvalidArgumentError(
                "MERGE requires at least one WHEN clause",
                error_class="DELTA_MERGE_MISSING_WHEN")
        for clauses, ec in (
                (self._matched,
                 "DELTA_NON_LAST_MATCHED_CLAUSE_OMIT_CONDITION"),
                (self._not_matched,
                 "DELTA_NON_LAST_NOT_MATCHED_CLAUSE_OMIT_CONDITION"),
                (self._not_matched_by_source,
                 "DELTA_NON_LAST_NOT_MATCHED_BY_SOURCE_CLAUSE_OMIT_CONDITION")):
            for c in clauses[:-1]:
                if c.condition is None:
                    raise InvalidArgumentError(
                        "only the last clause of its kind may omit a "
                        "condition; an unconditional earlier clause "
                        "would shadow the rest", error_class=ec)


def merge(table, source, on: Expression) -> MergeBuilder:
    return MergeBuilder(table, source, on)


def _as_batch(source) -> Batch:
    if isinstance(source, Batch):
        return source
    return Batch({name: as_column(v) for name, v in source.items()})


def _bound_literal(values: np.ndarray, fn):
    """min or max of a column's valid values as the Python literal the
    reference's `pc.min_max(...).as_py()` gives."""
    v = fn(values)
    if values.dtype.kind == "M":
        if np.datetime_data(values.dtype)[0] == "D":
            return _EPOCH_DATE + datetime.timedelta(days=int(v.astype(
                np.int64)))
        return _EPOCH_TS + datetime.timedelta(microseconds=int(
            v.astype("datetime64[us]").astype(np.int64)))
    if values.dtype.kind == "f":
        return float(v)
    if values.dtype.kind in "iu":
        return int(v)
    return v


def _source_key_bounds(t_keys: List[str], s_keys: List[str],
                       source: Batch) -> Optional[Expression]:
    """AND of [min, max] range conjuncts over the target's equi-key
    columns, from the source's keys: a superset of the rows that can
    match (NULL keys never equi-match). None when no key gives a bound
    (a boolean key, every key NULL, a NaN key: NaN matches NaN, and min
    and max skip it)."""
    conjuncts: List[Expression] = []
    for t_key, s_key in zip(t_keys, s_keys):
        if "." in t_key or s_key not in source.columns:
            continue
        col = source.column(s_key)
        v = col.values if col.valid is None else col.values[col.valid]
        if v.dtype.kind not in "iufMO" or len(v) == 0:
            continue
        if v.dtype.kind == "f" and np.isnan(v).any():
            continue
        ps = decimal_precision_scale(col.data_type)
        if col.data_type is not None and ps is None \
                and col.data_type != "timestamp_ntz":
            continue  # binary and nested keys: no min or max
        if v.dtype.kind == "O" and ps is None and not all(
                isinstance(x, str) for x in v.tolist()):
            continue  # bytes or dicts without a data_type
        mn, mx = _bound_literal(v, np.min), _bound_literal(v, np.max)
        if ps is not None:
            mn, mx = (decimal_value(int(x), ps[1]) for x in (mn, mx))
        elif col.data_type == "timestamp_ntz":
            mn, mx = (x.replace(tzinfo=None) for x in (mn, mx))
        target = ColumnRef((t_key,))
        conjuncts.append(Comparison(">=", target, Literal(mn)))
        conjuncts.append(Comparison("<=", target, Literal(mx)))
    if not conjuncts:
        return None
    pred = conjuncts[0]
    for c in conjuncts[1:]:
        pred = pred & c
    return pred


def _equi_keys(on: Expression):
    """(target keys, source keys, residual conjuncts) of the ON
    condition: each `target.a = source.b` conjunct is a key pair."""
    t_keys, s_keys, residual = [], [], []
    for conj in split_conjuncts(on):
        if isinstance(conj, Comparison) and conj.op == "=":
            sides = [conj.left, conj.right]
            if all(isinstance(s, ColumnRef) for s in sides):
                roots = {s.name_path[0] for s in sides}
                if roots == {"target", "source"}:
                    t = next(s for s in sides if s.name_path[0] == "target")
                    s = next(s for s in sides if s.name_path[0] == "source")
                    t_keys.append(".".join(t.name_path[1:]))
                    s_keys.append(".".join(s.name_path[1:]))
                    continue
        residual.append(conj)
    return t_keys, s_keys, residual


def _col(values: np.ndarray, valid: np.ndarray, t) -> Column:
    return Column(values, None if valid.all() else valid, carried_type(t))


def _eval_values(assignments: Optional[Dict[str, object]],
                 batch: NamespacedBatch, schema: StructType,
                 leave_out=frozenset()) -> Batch:
    """A clause's output rows over `batch`, every target column: an
    assigned column its value, an `*_all` clause the source column of the
    same name (case-insensitively; NULL when the source lacks it), an
    unassigned column the target's value (NULL for an insert); the
    columns named in `leave_out` are left out (an insert's unassigned
    generated, identity and default columns, which
    `colgen.py::apply_column_generation` fills)."""
    n = batch.num_rows
    source, target = batch.spaces["source"], batch.spaces["target"]
    if assignments is None:
        by_lower = {c.lower(): c for c in source.column_names}
    else:
        # duplicates differing only in case were refused before
        amap = {k.lower(): v for k, v in assignments.items()}
    out = {}
    for f in schema.fields:
        if f.name in leave_out:
            continue
        t = f.data_type
        if assignments is not None and f.name.lower() in amap:
            v = amap[f.name.lower()]
            if isinstance(v, Expression):
                out[f.name] = _col(*cast_values(evaluate_values(v, batch),
                                                t), t)
            else:
                out[f.name] = _col(*constant_values(v, t, n), t)
            continue
        src = (source.columns.get(by_lower.get(f.name.lower()))
               if assignments is None else target.columns.get(f.name))
        if src is None:
            out[f.name] = Column.nulls(f.numpy_dtype, n, carried_type(t))
        else:
            out[f.name] = _col(*cast_values(
                column_values(src.values, src.valid, src.data_type), t), t)
    return Batch(out, n)


def _updated(clause: MergeClause, batch: NamespacedBatch, schema: StructType,
             source: Batch, generated: set) -> Batch:
    """An update clause's rows, every target column: the generated
    columns it reads through its assignments computed again, those it
    assigns checked (`colgen.py::regenerate_columns`)."""
    rows = _eval_values(clause.assignments, batch, schema)
    if not generated:
        return rows
    return regenerate_columns(rows, schema, _assigned(clause, schema, source))


def _null_rows(types: Dict[str, tuple], n: int) -> Batch:
    """`n` null rows of columns named to (numpy dtype, data_type)."""
    return Batch({name: Column.nulls(dtype, n, t)
                  for name, (dtype, t) in types.items()}, n)


def _schema_types(schema: StructType) -> Dict[str, tuple]:
    return {f.name: (f.numpy_dtype, carried_type(f.data_type))
            for f in schema.fields}


def _in_schema_order(batch: Batch, schema: StructType) -> Batch:
    """`batch`'s columns in schema order, a column it lacks (a row from
    before the schema evolved) NULL."""
    return Batch({f.name: batch.columns[f.name] if f.name in batch.columns
                  else Column.nulls(f.numpy_dtype, batch.num_rows,
                                    carried_type(f.data_type))
                  for f in schema.fields}, batch.num_rows)


def _pairs(target: Batch, source: Batch, tpos, spos) -> NamespacedBatch:
    return NamespacedBatch({"target": target.take(tpos),
                            "source": source.take(spos)})


def _first_wins(clauses: List[MergeClause], batch) -> np.ndarray:
    """Per row, the index of the first clause whose condition holds
    (-1: none)."""
    action = np.full(batch.num_rows, -1, np.int64)
    undecided = np.ones(batch.num_rows, bool)
    for ci, clause in enumerate(clauses):
        if not undecided.any():
            break
        ok = (evaluate_predicate(clause.condition, batch)
              if clause.condition is not None
              else np.ones(batch.num_rows, bool))
        sel = undecided & ok
        action[sel] = ci
        undecided &= ~sel
    return action


def _check_target_references(on: Expression, clauses: List[MergeClause],
                             schema: StructType) -> None:
    """Refuse a `target.<name>` in the ON condition, a clause's condition
    or an assigned expression that names a column the target lacks
    (`NonExistentColumnError`)."""
    exprs = [on] + [c.condition for c in clauses if c.condition is not None]
    exprs += [v for c in clauses for v in (c.assignments or {}).values()
              if isinstance(v, Expression)]
    check_columns_exist(schema, columns=[
        r[1] for e in exprs for r in sorted(e.references())
        if len(r) > 1 and r[0] == "target"])


def _check_key_types(t_keys: List[str], s_keys: List[str],
                     schema: StructType, source: Batch) -> None:
    """Refuse an equi-key pair of a string column and a column of another
    type, as the reference's join does ("You are trying to merge on str
    and int64 columns"): coding both by their text would match "2" with 2
    but not with 2.0. Binary counts as another type. Pairs of numbers of
    mixed width or kind (decimals too) join by value, binary by bytes."""
    for t_key, s_key in zip(t_keys, s_keys):
        if t_key not in schema or s_key not in source.columns:
            continue
        t_type = schema[t_key].type_name
        sc = source.column(s_key)
        s_str = sc.data_type is None and sc.values.dtype.kind in "OU" and \
            not any(isinstance(v, bytes) for v in sc.values[:1].tolist())
        if (t_type == "string") != s_str:
            raise InvalidArgumentError(
                f"MERGE cannot join target.{t_key} ({t_type}) with "
                f"source.{s_key} ({sc.data_type or sc.values.dtype}): a "
                "string key joins only a string key",
                error_class="DATATYPE_MISMATCH")


def _check_assignments(matched: List[MergeClause],
                       clauses: List[MergeClause], source: Batch,
                       schema: StructType, has_star: bool,
                       schema_evolution: bool) -> List[str]:
    """The reference's analysis of the clauses' target columns, in its
    order: duplicate assignments, an UPDATE of an identity column (an
    explicit assignment, or an UPDATE SET * whose source holds it), then
    the columns the target lacks. Returns the source columns the table
    evolves by, sorted: every source-only column under an `*` clause,
    and each explicitly assigned new column."""
    target_lower = {f.name.lower() for f in schema.fields}
    identity = {f.name.lower() for f in schema.fields if is_identity(f)}
    for c in clauses:
        seen: set = set()
        for k in c.assignments or ():
            if k.lower() in seen:
                raise InvalidArgumentError(
                    f"duplicate assignment for column '{k}' in MERGE clause",
                    error_class="DELTA_DUPLICATE_COLUMNS_ON_UPDATE_TABLE")
            seen.add(k.lower())
            if c.kind == "update" and k.lower() in identity:
                raise IdentityColumnError(
                    f"UPDATE on IDENTITY column {k} is not supported in "
                    "MERGE",
                    error_class="DELTA_IDENTITY_COLUMNS_UPDATE_NOT_SUPPORTED")
    if identity and any(c.kind == "update" and c.assignments is None
                        for c in matched):
        hit = sorted(c for c in source.column_names
                     if c.lower() in identity)
        if hit:
            raise IdentityColumnError(
                f"UPDATE on IDENTITY column {hit[0]} is not supported in "
                "MERGE (UPDATE SET * assigns it from the source)",
                error_class="DELTA_IDENTITY_COLUMNS_UPDATE_NOT_SUPPORTED")
    unknown = sorted({k for c in clauses for k in c.assignments or ()
                      if k.lower() not in target_lower})
    extra = [c for c in source.column_names if c.lower() not in target_lower]
    if unknown:
        source_lower = {c.lower() for c in source.column_names}
        missing = [k for k in unknown if k.lower() not in source_lower]
        if missing:
            raise InvalidArgumentError(
                f"assignment target column(s) {missing} exist in neither "
                "the target schema nor the source",
                error_class="DELTA_COLUMN_NOT_FOUND_IN_MERGE")
        if not schema_evolution:
            raise InvalidArgumentError(
                f"assignment target column(s) {unknown} not in the target "
                "schema; call with_schema_evolution() to evolve the table")
    if extra and has_star and not schema_evolution:
        raise InvalidArgumentError(
            f"source column(s) {extra} not in the target schema; call "
            "with_schema_evolution() to evolve the table",
            error_class="DELTA_MERGE_UNRESOLVED_EXPRESSION")
    evolve = set(extra) if has_star else set()
    for k in unknown:
        evolve.add(next(c for c in source.column_names
                        if c.lower() == k.lower()))
    return sorted(evolve)


def _evolve(txn, meta, schema: StructType, source: Batch,
            new_columns: List[str]) -> StructType:
    """Stage the table's schema with the source's `new_columns` (nullable,
    no widening; ids and `col-` physical names on a mapped table); returns
    the evolved schema."""
    evolved = merge_schemas(schema, StructType([
        StructField(c, source.column(c).data_type
                    or type_name_of(source.column(c).values))
        for c in new_columns]))
    conf = meta.configuration
    if is_mapped(conf):
        evolved, conf = assign_column_mapping(evolved, conf)
    txn.update_metadata(dataclasses.replace(
        meta, schemaString=schema_to_json(evolved), configuration=conf))
    return evolved


def _assigned(clause: MergeClause, schema: StructType,
              source: Batch) -> set:
    """The target columns a clause gives a value: its assignments', or
    under `*` every column the source holds (case-insensitively)."""
    names = ({k.lower() for k in clause.assignments}
             if clause.assignments is not None
             else {c.lower() for c in source.column_names})
    return {f.name for f in schema.fields if f.name.lower() in names}


def _join_keys(t: Column, s: Column) -> Tuple[np.ndarray, np.ndarray]:
    """One key pair's values, comparable by value: a decimal beside a
    decimal or an integer as integers at the larger scale (int64 where
    they fit), beside anything else as Python values (Decimals, which
    equal a number of the same value, as the reference's Python objects
    do); any other pair as it is."""
    ts, ss = (decimal_precision_scale(c.data_type) for c in (t, s))
    if ts is None and ss is None:
        return t.values, s.values
    ints = all(ps is not None or c.values.dtype.kind in "iu"
               for ps, c in ((ts, t), (ss, s)))
    if not ints:
        return tuple(_objects(c.to_python()) for c in (t, s))
    scale = max(ps[1] for ps in (ts, ss) if ps is not None)
    out = []
    for ps, c in ((ts, t), (ss, s)):
        f = 10 ** (scale - (ps[1] if ps is not None else 0))
        out.append([int(x) * f for x in c.values.tolist()])
    if all(-(1 << 63) <= x < (1 << 63) for side in out for x in side):
        return tuple(np.array(side, np.int64) for side in out)
    return tuple(_objects(side) for side in out)


def _objects(values: list) -> np.ndarray:
    out = np.empty(len(values), object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _join(target_all: Batch, source: Batch, t_keys, s_keys, residual,
          engine, mark):
    """(tpos, spos, the source rows the device join matched or None,
    n_multi): the matching (target row, source row) pairs, by the device
    join or the host pair join (module docstring)."""
    if not t_keys:
        tpos, spos = np.meshgrid(np.arange(target_all.num_rows),
                                 np.arange(source.num_rows), indexing="ij")
        tpos, spos = tpos.ravel(), spos.ravel()
    else:
        t_ok = np.ones(target_all.num_rows, bool)
        s_ok = np.ones(source.num_rows, bool)
        for k in t_keys:
            if target_all.column(k).valid is not None:
                t_ok &= target_all.column(k).valid
        for k in s_keys:
            if source.column(k).valid is not None:
                s_ok &= source.column(k).valid
        t_valid, s_valid = np.nonzero(t_ok)[0], np.nonzero(s_ok)[0]
        t_cols, s_cols = [], []
        for tk, sk in zip(t_keys, s_keys):
            tc, sc = _join_keys(target_all.column(tk).take(t_valid),
                                source.column(sk).take(s_valid))
            t_cols.append(tc)
            s_cols.append(sc)
        if not residual and len(t_valid) + len(s_valid) \
                >= DEVICE_JOIN_MIN_ROWS:
            match, n_multi, matched_s = equi_join_device(
                t_cols, s_cols, device=engine.device, mark=mark)
            hit = match >= 0
            tpos = t_valid[np.nonzero(hit)[0]]
            spos = s_valid[match[hit]]
            # the source rows of a matched key, duplicates that form no
            # pair included (legal in an insert-only MERGE)
            return tpos, spos, s_valid[np.nonzero(matched_s)[0]], n_multi
        tpos, spos = host_pair_join(t_cols, s_cols)
        tpos, spos = t_valid[tpos], s_valid[spos]
        mark("join_host")
    if residual and len(tpos):
        batch = _pairs(target_all, source, tpos, spos)
        keep = np.ones(len(tpos), bool)
        for conj in residual:
            keep &= evaluate_predicate(conj, batch)
        tpos, spos = tpos[keep], spos[keep]
        mark("join_residual")
    return tpos, spos, None, 0


def _execute_merge(table, source: Batch, on: Expression,
                   matched: List[MergeClause],
                   not_matched: List[MergeClause],
                   not_matched_by_source: List[MergeClause],
                   schema_evolution: bool = False) -> MergeMetrics:
    mark = PhaseTimer(table.engine.synchronize)
    txn = table.create_transaction_builder(Operation.MERGE).build()
    snapshot = txn.read_snapshot
    if snapshot is None:
        raise MissingTransactionLogError(f"no table at {table.path}")
    meta = snapshot.metadata
    schema = schema_from_json(meta.schemaString)
    check_write_supported(snapshot.protocol, meta)
    clauses = matched + not_matched + not_matched_by_source
    _check_target_references(on, clauses, schema)
    has_star = any(c.assignments is None and c.kind != "delete"
                   for c in matched + not_matched)
    new_columns = _check_assignments(matched, clauses, source, schema,
                                     has_star, schema_evolution)
    if new_columns:
        schema = _evolve(txn, meta, schema, source, new_columns)
    conf = txn.metadata().configuration
    generated = generation_columns(schema)
    watermark = None  # the schema with a moved identity watermark
    part_cols = list(meta.partitionColumns)
    now_ms = int(time.time() * 1000)
    metrics = MergeMetrics(num_source_rows=source.num_rows,
                           phase_seconds=mark.seconds)
    mark("snapshot")

    t_keys, s_keys, residual = _equi_keys(on)
    _check_key_types(t_keys, s_keys, schema, source)
    # the source's key bounds prune the target's files (the reference's
    # dynamic pruning); only where no clause reads unmatched target rows
    scan_pred = (None if not_matched_by_source
                 else _source_key_bounds(t_keys, s_keys, source))
    candidates = txn.scan_files(filter=scan_pred)
    metrics.num_target_files_scanned = len(candidates)
    mark("scan")

    # the candidates' visible rows, with each row's file
    parts = read_add_files_logical(table.engine, table.path, meta,
                                   candidates)
    target_all = (Batch.concat(parts) if parts
                  else _null_rows(_schema_types(schema), 0))
    file_of = np.repeat(np.arange(len(parts), dtype=np.int64),
                        [p.num_rows for p in parts])
    mark("read")

    device_matched_s = None
    if target_all.num_rows and source.num_rows:
        tpos, spos, device_matched_s, n_multi = _join(
            target_all, source, t_keys, s_keys, residual, table.engine, mark)
        if matched and n_multi:
            raise MergeCardinalityError(
                f"{n_multi} target row(s) matched by multiple source rows; "
                "MERGE with update/delete requires at most one match")
    else:
        tpos = spos = np.empty(0, np.int64)

    if matched and len(tpos):
        _, counts = np.unique(tpos, return_counts=True)
        if (counts > 1).any():
            raise MergeCardinalityError(
                f"{int((counts > 1).sum())} target row(s) matched by "
                "multiple source rows; MERGE with update/delete requires "
                "at most one match")

    # matched pairs: the first clause whose condition holds
    pair_action = np.full(len(tpos), -1, np.int64)
    if matched and len(tpos):
        pair_action = _first_wins(matched, _pairs(target_all, source, tpos,
                                                  spos))
    acted = pair_action >= 0
    is_del = np.zeros(len(tpos), bool)
    is_del[acted] = np.array([c.kind == "delete" for c in matched],
                             bool)[pair_action[acted]]
    delete_t = tpos[is_del]
    upd_pi = np.nonzero(acted & ~is_del)[0]

    # unmatched source rows: inserts
    insert_parts = []
    if not_matched and source.num_rows:
        unmatched = np.ones(source.num_rows, bool)
        unmatched[spos if device_matched_s is None else device_matched_s] \
            = False
        un_idx = np.nonzero(unmatched)[0]
        if len(un_idx):
            batch = NamespacedBatch({
                "target": _null_rows(_schema_types(schema), len(un_idx)),
                "source": source.take(un_idx)})
            action = _first_wins(not_matched, batch)
            for ci, clause in enumerate(not_matched):
                sel = np.nonzero(action == ci)[0]
                if not len(sel):
                    continue
                rows = _eval_values(
                    clause.assignments, NamespacedBatch({
                        k: b.take(sel) for k, b in batch.spaces.items()}),
                    schema, generated - _assigned(clause, schema, source))
                if generated:
                    rows, moved = apply_column_generation(
                        rows, watermark or schema)
                    watermark = moved or watermark
                insert_parts.append(rows)

    # unmatched target rows: not matched by source
    nmbs_delete_t = np.empty(0, np.int64)
    nmbs_upd_t = np.empty(0, np.int64)
    nmbs_rows: Optional[Batch] = None
    if not_matched_by_source and target_all.num_rows:
        hit = np.zeros(target_all.num_rows, bool)
        hit[tpos] = True
        un_idx = np.nonzero(~hit)[0]
        if len(un_idx):
            batch = NamespacedBatch({
                "target": target_all.take(un_idx),
                "source": _null_rows({
                    c: (source.column(c).values.dtype,
                        source.column(c).data_type)
                    for c in source.column_names}, len(un_idx))})
            action = _first_wins(not_matched_by_source, batch)
            dels, upd_idx, upd_rows = [], [], []
            for ci, clause in enumerate(not_matched_by_source):
                sel = np.nonzero(action == ci)[0]
                if not len(sel):
                    continue
                if clause.kind == "delete":
                    dels.append(un_idx[sel])
                else:
                    upd_idx.append(un_idx[sel])
                    upd_rows.append(_updated(clause, NamespacedBatch({
                        k: b.take(sel) for k, b in batch.spaces.items()}),
                        schema, source, generated))
            if dels:
                nmbs_delete_t = np.concatenate(dels)
            if upd_idx:
                nmbs_upd_t = np.concatenate(upd_idx)
                nmbs_rows = Batch.concat(upd_rows)
    mark("resolve")

    # rewrite every touched file: its kept rows, then its updated rows
    n_target = target_all.num_rows
    del_mask = np.zeros(n_target, bool)
    del_mask[delete_t] = True
    del_mask[nmbs_delete_t] = True
    upd_mask = np.zeros(n_target, bool)
    upd_mask[tpos[upd_pi]] = True
    upd_mask[nmbs_upd_t] = True
    touched = np.unique(file_of[del_mask | upd_mask])
    upd_file = file_of[tpos[upd_pi]]
    upd_clause = pair_action[upd_pi]
    nmbs_file = file_of[nmbs_upd_t]
    writes = []
    before, after = [], []  # the updated rows' change data
    feed = cdf_enabled(conf)
    for fi in touched.tolist():
        here = file_of == fi
        kept = np.nonzero(here & ~del_mask & ~upd_mask)[0]
        out = []
        if len(kept):
            out.append(_in_schema_order(target_all.take(kept), schema))
            metrics.num_target_rows_copied += len(kept)
        in_file = upd_file == fi
        for ci in np.unique(upd_clause[in_file]).tolist():
            pis = upd_pi[in_file & (upd_clause == ci)]
            rows = _updated(matched[ci], _pairs(target_all, source,
                                                tpos[pis], spos[pis]),
                            schema, source, generated)
            out.append(rows)
            if feed:
                before.append(target_all.take(tpos[pis]))
                after.append(rows)
            metrics.num_target_rows_updated += rows.num_rows
        sel = np.nonzero(nmbs_file == fi)[0]
        if len(sel):
            out.append(nmbs_rows.take(sel))
            if feed:
                before.append(target_all.take(nmbs_upd_t[sel]))
                after.append(out[-1])
            metrics.num_target_rows_updated += len(sel)
        metrics.num_target_rows_deleted += int((here & del_mask).sum())
        txn.remove_file(candidates[fi].remove(deletion_timestamp=now_ms))
        metrics.num_target_files_rewritten += 1
        if out:
            writes.append(Batch.concat(out))
    if insert_parts:
        writes.append(Batch.concat(insert_parts))
        metrics.num_target_rows_inserted = writes[-1].num_rows
    for rows in writes:  # every batch checked before the first file
        check_rows(rows, schema, conf)
    for rows in writes:
        txn.add_files(write_data_files(table.engine, table.path, rows,
                                       schema, part_cols, conf))
    if watermark is not None:
        # the identity watermark moves in this commit
        txn.update_metadata(dataclasses.replace(
            txn.metadata(), schemaString=schema_to_json(watermark)))
    if feed:
        deleted = [target_all.take(np.nonzero(del_mask)[0])]
        for parts, kind in ((deleted, "delete"), (before, "update_preimage"),
                            (after, "update_postimage"),
                            (insert_parts, "insert")):
            stage_change_data(txn, table, txn.metadata(), parts, kind)
    mark("write")

    if not txn._adds and not txn._removes and not new_columns:
        return metrics  # nothing touched; an evolved schema still commits
    txn.set_operation_parameters({"predicate": repr(on)})
    txn.set_operation_metrics({
        "numTargetRowsUpdated": metrics.num_target_rows_updated,
        "numTargetRowsDeleted": metrics.num_target_rows_deleted,
        "numTargetRowsInserted": metrics.num_target_rows_inserted,
        "numTargetRowsCopied": metrics.num_target_rows_copied,
        "numSourceRows": metrics.num_source_rows,
    })
    metrics.version = txn.commit().version
    mark("commit")
    return metrics

"""Scan: a pruned listing of a snapshot's files, and the read of their rows.

Counterpart of `delta_tpu/scan.py:32-162` (kernel `ScanBuilder` / `Scan`).
A scan applies, in order:

1. partition pruning: the filter's conjuncts that reference only
   partition columns, evaluated exactly over each file's
   `partitionValues` (`expressions/eval.py`);
2. data skipping: the other conjuncts against the files' min/max/
   nullCount stats (`stats/skipping.py::skipping_mask` over the
   snapshot's resident stats index; kernel K7 on the card).

`add_files()` (and `files()`) return the surviving AddFiles in the
state's row order, `file_paths()` their paths (without materializing
the actions); `partition_pruned` and
`skipped_by_stats` count what each step dropped. `to_batch()` reads the
surviving files' rows (`read/reader.py::read_scan`): the counterpart of
the reference's `to_arrow()`, returning the port's `Batch`.

A scan is built only over names the snapshot's logical schema has: a
filter or a projection naming another column raises
`NonExistentColumnError` (`check_columns_exist`; case-sensitive, top-level
names). The reference keeps every row for such a filter instead.

Conjuncts are told apart by `id`: `Expression.__eq__` builds a node, so
`c in conjuncts` is always true.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from delta_tpu_torch.errors import NonExistentColumnError
from delta_tpu_torch.expressions.tree import Expression, split_conjuncts
from delta_tpu_torch.models.actions import AddFile


def check_columns_exist(schema, filter: Optional[Expression] = None,
                        columns: Optional[Sequence[str]] = None) -> None:
    """Raise `NonExistentColumnError` (DELTA_COLUMN_NOT_FOUND) for the
    first name that `filter` references or `columns` lists and `schema`
    (a table's logical schema) lacks; a nested reference resolves by its
    top-level name."""
    names = list(columns or ())
    if filter is not None:
        names += sorted(r[0] for r in filter.references())
    known = set(schema.field_names()) if schema is not None else set()
    for name in names:
        if name not in known:
            raise NonExistentColumnError(
                f"column {name!r} not found in the table's columns "
                f"{sorted(known)}", column=name)


class ScanBuilder:
    def __init__(self, snapshot):
        self._snapshot = snapshot
        self._filter: Optional[Expression] = None
        self._columns: Optional[List[str]] = None

    def with_filter(self, expr: Expression) -> "ScanBuilder":
        self._filter = expr if self._filter is None else (self._filter & expr)
        return self

    def with_columns(self, columns: Sequence[str]) -> "ScanBuilder":
        self._columns = list(columns)
        return self

    def build(self) -> "Scan":
        check_columns_exist(self._snapshot.schema, self._filter,
                            self._columns)
        return Scan(self._snapshot, self._filter, self._columns)


class Scan:
    def __init__(self, snapshot, filter: Optional[Expression],
                 columns: Optional[List[str]]):
        self._snapshot = snapshot
        self.filter = filter
        self.columns = columns
        self._rows: Optional[np.ndarray] = None
        self._files: Optional[List[AddFile]] = None
        self.partition_pruned = 0
        self.skipped_by_stats = 0

    @property
    def snapshot(self):
        return self._snapshot

    def surviving_rows(self) -> np.ndarray:
        """Row indices (into the state's file actions) of the surviving
        files, ascending."""
        if self._rows is None:
            self._rows = self._plan()
        return self._rows

    def _plan(self) -> np.ndarray:
        state = self._snapshot.state
        rows = state.live_rows
        n = len(rows)
        if self.filter is None or n == 0:
            return rows
        partition_cols = set(self._snapshot.partition_columns)
        conjuncts = split_conjuncts(self.filter)
        part_conjuncts = [
            c for c in conjuncts
            if c.references()
            and all(r[0] in partition_cols for r in c.references())]
        part_ids = {id(c) for c in part_conjuncts}
        data_conjuncts = [c for c in conjuncts if id(c) not in part_ids]

        keep = np.ones(n, dtype=bool)
        if part_conjuncts:
            from delta_tpu_torch.expressions.eval import evaluate_predicate
            from delta_tpu_torch.stats.partition import (
                partition_values_to_columns,
            )

            batch = partition_values_to_columns(
                [a.partitionValues for a in state.add_files],
                self._snapshot.metadata)
            for c in part_conjuncts:
                keep &= evaluate_predicate(c, batch)
            self.partition_pruned = int((~keep).sum())
        if data_conjuncts:
            from delta_tpu_torch.stats.skipping import skipping_mask

            stats_keep = skipping_mask(
                None, data_conjuncts, self._snapshot.metadata,
                engine=self._snapshot.engine, state=state)
            self.skipped_by_stats = int((keep & ~stats_keep).sum())
            keep &= stats_keep
        return rows[keep]

    def add_files(self) -> List[AddFile]:
        """The surviving AddFiles, in the state's row order."""
        if self._files is None:
            rows = self.surviving_rows()
            state = self._snapshot.state
            if rows is state.live_rows:
                self._files = list(state.add_files)
            else:
                self._files = state.file_actions.rows.add_files(rows)
        return self._files

    def files(self) -> List[AddFile]:
        return list(self.add_files())

    def file_paths(self) -> List[str]:
        """The surviving files' paths, read from the row store without
        materializing their actions."""
        if self._files is not None:
            return [a.path for a in self._files]
        return self._snapshot.state.file_actions.rows.paths(
            self.surviving_rows())

    def to_batch(self):
        """The surviving files' rows as one `Batch` (the counterpart of
        the reference's `to_arrow()`): only the needed columns are read,
        the residual filter applies, then the projection."""
        from delta_tpu_torch.read.reader import read_scan

        return read_scan(self)

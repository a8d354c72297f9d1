"""The change data feed: `table_changes`.

Counterpart of `delta_tpu/read/cdc.py` (Delta's `CDCReader.scala`):

    from delta_tpu_torch.read.cdc import table_changes
    batch = table_changes(Table.for_path(p, engine=TorchEngine()),
                          starting_version=3, ending_version=7)
    batch = table_changes(table, starting_timestamp=ms)  # to the head

The rows each commit of the range changed, as a `Batch`: the table's
logical columns (those of its latest schema: data columns, then the
partition columns; a column a row's file lacks reads as null), then
`_change_type` (`insert`, `delete`, `update_preimage`,
`update_postimage`), `_commit_version` (int64) and `_commit_timestamp`
(int64 ms: the first `commitInfo`'s `inCommitTimestamp`, else its
`timestamp`, else 0).

- The range's commit files are read as one buffer and parsed by the
  engine's commit parse (`replay/columnar.py::_parse_commit_buffer`: K1
  on the card), as VACUUM LITE reads its range; a commit file that is
  missing is skipped.
- A commit with `cdc` actions is served from its change data files alone
  (`read/reader.py::read_cdc_files_logical`, both packages' forms). Any
  other commit's data-changing adds read as `insert` rows and its
  data-changing removes as `delete` rows (`read_add_files_logical`),
  each file's deletion vector applied, every deletion vector of the read
  decoded in one batch (one K8 launch on the card); a removed file that
  was vacuumed is skipped. (The reference reads them without their
  deletion vectors: ROADMAP C25.) An add or remove with `dataChange`
  false (OPTIMIZE, a rearrangement) changes nothing.

Refused as in the reference (`InvalidArgumentError` but where named):
both a starting version and timestamp, or both ending ones
(DELTA_MULTIPLE_CDC_BOUNDARY); neither starting bound
(DELTA_NO_START_FOR_CDC_READ); a table whose feed is off now
(`CdcNotEnabledError`); an end before the start
(DELTA_INVALID_CDC_RANGE); a range that reaches a commit which changed
data while the feed was off (DELTA_MISSING_CHANGE_DATA). A starting
timestamp takes the first commit at or after it, an ending one the last
commit at or before it (`history.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from delta_tpu_torch.config import cdf_enabled
from delta_tpu_torch.errors import (
    CdcNotEnabledError,
    DeltaError,
    InvalidArgumentError,
)
from delta_tpu_torch.history import (
    version_at_or_after_timestamp,
    version_at_timestamp,
)
from delta_tpu_torch.models.actions import (
    AddCDCFile,
    AddFile,
    CommitInfo,
    Metadata,
)
from delta_tpu_torch.models.batch import Batch, Column, zeros
from delta_tpu_torch.models.schema import (
    carried_type,
    numpy_dtype_of,
    schema_from_json,
)
from delta_tpu_torch.read.reader import (
    read_add_files_logical,
    read_cdc_files_logical,
)
from delta_tpu_torch.replay.columnar import (
    _parse_commit_buffer,
    _read_commits_buffer,
)
from delta_tpu_torch.utils import filenames
from delta_tpu_torch.write.writer import CDC_TYPE_COLUMN

COMMIT_VERSION_COLUMN = "_commit_version"
COMMIT_TIMESTAMP_COLUMN = "_commit_timestamp"


def _start_and_end(table, starting_version, ending_version,
                   starting_timestamp, ending_timestamp) -> tuple:
    """The range's first version and its last (None: the head), after
    the reference's argument checks."""
    if starting_version is not None and starting_timestamp is not None:
        raise InvalidArgumentError(
            "multiple starting arguments provided for CDC read; please "
            "provide one of either startingVersion or startingTimestamp",
            error_class="DELTA_MULTIPLE_CDC_BOUNDARY")
    if ending_version is not None and ending_timestamp is not None:
        raise InvalidArgumentError(
            "multiple ending arguments provided for CDC read; please "
            "provide one of either endingVersion or endingTimestamp",
            error_class="DELTA_MULTIPLE_CDC_BOUNDARY")
    if starting_version is None and starting_timestamp is None:
        raise InvalidArgumentError(
            "no startingVersion or startingTimestamp provided for CDC read",
            error_class="DELTA_NO_START_FOR_CDC_READ")
    if starting_timestamp is not None:
        # changes committed before the requested time are not returned
        starting_version = version_at_or_after_timestamp(
            table, starting_timestamp)
    if ending_timestamp is not None:
        ending_version = version_at_timestamp(
            table, ending_timestamp, can_return_last_commit=True)
    return starting_version, ending_version


def _commits(table, start: int, end: int) -> List[tuple]:
    """(version, path) of the range's commit files that exist."""
    listing = table.engine.fs.list_from(
        filenames.listing_prefix(table.log_path, start),
        skip_stat=lambda n: True)
    versions = sorted({filenames.delta_version(st.path) for st in listing
                       if filenames.is_delta_file(st.path)})
    return [(v, filenames.delta_file(table.log_path, v)) for v in versions
            if start <= v <= end]


def _empty(schema, partition_columns) -> Batch:
    cols = {}
    for f in _ordered_fields(schema, partition_columns):
        cols[f.name] = Column(zeros(f.numpy_dtype, 0, f.data_type), None,
                              carried_type(f.data_type))
    cols[CDC_TYPE_COLUMN] = Column(np.empty(0, object))
    for c in (COMMIT_VERSION_COLUMN, COMMIT_TIMESTAMP_COLUMN):
        cols[c] = Column(zeros(numpy_dtype_of("long"), 0))
    return Batch(cols, 0)


def _ordered_fields(schema, partition_columns) -> list:
    return sorted(schema.fields, key=lambda f: f.name in partition_columns)


def _tagged(batch: Batch, names: List[str], change_type: Optional[str],
            version: int, timestamp: int) -> Batch:
    """`batch`'s columns `names` in order, its change type (when the rows
    do not carry one), its commit's version and timestamp."""
    n = batch.num_rows
    cols = {c: batch.columns[c] for c in names}
    if change_type is not None:
        kind = np.empty(n, object)
        kind[:] = change_type
        cols[CDC_TYPE_COLUMN] = Column(kind)
    else:
        cols[CDC_TYPE_COLUMN] = batch.columns[CDC_TYPE_COLUMN]
    cols[COMMIT_VERSION_COLUMN] = Column(np.full(n, version, np.int64))
    cols[COMMIT_TIMESTAMP_COLUMN] = Column(np.full(n, timestamp, np.int64))
    return Batch(cols, n)


def table_changes(table, starting_version: Optional[int] = None,
                  ending_version: Optional[int] = None,
                  starting_timestamp: Optional[int] = None,
                  ending_timestamp: Optional[int] = None) -> Batch:
    """The change data of the commits in [start, end] (module
    docstring)."""
    start, end = _start_and_end(table, starting_version, ending_version,
                                starting_timestamp, ending_timestamp)
    snap = table.latest_snapshot()
    meta = snap.metadata
    if not cdf_enabled(meta.configuration):
        raise CdcNotEnabledError(
            "change data feed is not enabled on this table (set "
            "delta.enableChangeDataFeed=true)")
    end = snap.version if end is None else end
    if end < start:
        raise InvalidArgumentError(
            f"invalid CDC range [{start}, {end}]: start is after end",
            error_class="DELTA_INVALID_CDC_RANGE")
    # the coverage check: a commit that changed data while the feed was
    # off recorded no change data, so the read fails rather than make it
    enabled = True
    if start <= snap.version:
        try:
            enabled = cdf_enabled(
                table.snapshot_at(start).metadata.configuration)
        except DeltaError:
            pass  # the start predates the history that can be rebuilt
    schema = schema_from_json(meta.schemaString)
    pcols = list(meta.partitionColumns)
    commits = _commits(table, start, end)
    if not commits:
        return _empty(schema, pcols)
    buf, starts, versions = _read_commits_buffer(commits)
    parsed = _parse_commit_buffer(table.engine, buf, starts, versions)
    del buf

    confs: Dict[int, dict] = {}
    stamps: Dict[int, int] = {}   # version -> its commit timestamp
    cdcs: Dict[int, List[AddCDCFile]] = {}
    for v, _, row in sorted(parsed.others, key=lambda r: r[:2]):
        if row.get("metaData") is not None:
            confs[v] = Metadata.from_dict(row["metaData"]).configuration
        elif row.get("commitInfo") is not None and v not in stamps:
            ci = CommitInfo.from_dict(row["commitInfo"])
            stamps[v] = ci.inCommitTimestamp or ci.timestamp or 0
        elif row.get("cdc") is not None:
            cdcs.setdefault(v, []).append(AddCDCFile.from_dict(row["cdc"]))

    # the file actions, in line order: version -> its data-changing ones
    fa = parsed.file_actions
    is_add = fa.is_add.cpu().numpy()
    version = fa.version.cpu().numpy()
    add_idx, rm_idx = np.flatnonzero(is_add), np.flatnonzero(~is_add)
    actions = dict(zip(add_idx.tolist(), fa.rows.add_files(add_idx)))
    actions.update(zip(rm_idx.tolist(), fa.rows.remove_files(rm_idx)))
    changing: Dict[int, list] = {}
    for i in range(fa.num_rows):
        if actions[i].dataChange:
            changing.setdefault(int(version[i]), []).append(
                (bool(is_add[i]), actions[i]))

    for v, _ in commits:
        if v in confs:
            enabled = cdf_enabled(confs[v])
        if not enabled and (v in cdcs or v in changing):
            raise InvalidArgumentError(
                f"error getting change data for range [{start}, {end}]: "
                f"change data was not recorded for version {v}",
                error_class="DELTA_MISSING_CHANGE_DATA")

    # every change data file in one read; every synthesized file in one
    # read, its deletion vectors decoded in one batch
    served = [(v, c) for v, _ in commits for c in cdcs.get(v, [])]
    synth = [(v, add) for v, _ in commits if v not in cdcs
             for add in changing.get(v, [])]
    cdc_rows = read_cdc_files_logical(table.engine, table.path, meta,
                                      [c for _, c in served])
    files = [a if is_an_add else AddFile(
        path=a.path, partitionValues=dict(a.partitionValues or {}),
        size=a.size or 0, stats=a.stats, deletionVector=a.deletionVector)
        for _, (is_an_add, a) in synth]
    synth_rows = read_add_files_logical(
        table.engine, table.path, meta, files,
        missing_ok=[not is_an_add for _, (is_an_add, _) in synth])

    names = [f.name for f in _ordered_fields(schema, pcols)]
    parts = [_tagged(b, names, None, v, stamps.get(v, 0))
             for (v, _), b in zip(served, cdc_rows)]
    parts += [_tagged(b, names, "insert" if is_an_add else "delete", v,
                      stamps.get(v, 0))
              for (v, (is_an_add, _)), b in zip(synth, synth_rows)
              if b is not None]
    parts = [p for p in parts if p.num_rows]
    if not parts:
        return _empty(schema, pcols)
    # the commits' order: each version's change data files, else its
    # adds and removes in line order
    order = np.argsort([p.columns[COMMIT_VERSION_COLUMN].values[0]
                        for p in parts], kind="stable")
    return Batch.concat([parts[i] for i in order.tolist()])

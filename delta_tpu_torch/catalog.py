"""In-process table catalog: name -> location.

Counterpart of `delta_tpu/catalog.py`. The reference's
`catalog/DeltaCatalog.scala` resolves table names through the Spark or
Hive metastore; here the role is a small file-backed registry: each table
is one JSON entry `<root>/_catalog/<name>.json` (`{"location": ...,
"createdAt": ...}`, the reference's form, so either package reads the
other's catalog), written with the log store's put-if-absent, so CREATE
TABLE is atomic under concurrent writers and DROP is one delete.

A name resolves to the same `Table` object on every call while its
location is unchanged, so repeated queries reuse the table's cached
snapshot state.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional

from delta_tpu_torch.clustering import clustering_columns
from delta_tpu_torch.errors import (
    CatalogTableError,
    DeltaError,
    InvalidArgumentError,
    MissingTransactionLogError,
)
from delta_tpu_torch.table import Table
from delta_tpu_torch.txn.transaction import Operation

_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)?$")


class TableAlreadyExistsError(DeltaError):
    error_class = "DELTA_TABLE_ALREADY_EXISTS"


class TableNotInCatalogError(DeltaError):
    error_class = "DELTA_TABLE_NOT_FOUND"


def _check_create_spec_matches(table, partition_by, properties,
                               cluster_by) -> None:
    """CREATE TABLE over an existing table must not silently diverge from
    the spec on disk; None means the caller left that field open."""
    if partition_by is None and cluster_by is None and not properties:
        return
    if not table.exists():
        return
    snapshot = table.latest_snapshot()
    meta = snapshot.metadata
    if partition_by is not None and \
            list(partition_by) != list(meta.partitionColumns):
        raise CatalogTableError(
            f"requested partitioning {list(partition_by)} does not match "
            f"the existing table's {list(meta.partitionColumns)}",
            error_class="DELTA_CREATE_TABLE_WITH_DIFFERENT_PARTITIONING")
    if properties:
        existing = meta.configuration
        diverged = sorted(k for k, v in properties.items()
                          if existing.get(k) != v)
        if diverged:
            raise CatalogTableError(
                f"requested table properties {diverged} differ from the "
                "existing table's configuration",
                error_class="DELTA_CREATE_TABLE_WITH_DIFFERENT_PROPERTY")
    if cluster_by is not None:
        existing_cb = clustering_columns(snapshot.state) or []
        if list(cluster_by) != list(existing_cb):
            raise CatalogTableError(
                f"requested clustering {list(cluster_by)} does not match "
                f"the existing table's {list(existing_cb)}",
                error_class="DELTA_CREATE_TABLE_WITH_DIFFERENT_CLUSTERING")


class Catalog:
    def __init__(self, root: str, engine=None):
        if engine is None:
            from delta_tpu_torch.engine import TorchEngine

            engine = TorchEngine()
        self.engine = engine
        self.root = root.rstrip("/")
        self._dir = f"{self.root}/_catalog"
        self._tables: Dict[str, Table] = {}
        self._tables_lock = threading.Lock()

    def _entry_path(self, name: str) -> str:
        if not _NAME_RE.match(name):
            raise InvalidArgumentError(
                f"invalid table name: {name!r}",
                error_class="DELTA_PARSING_ILLEGAL_TABLE_NAME")
        return f"{self._dir}/{name}.json"

    def _default_location(self, name: str) -> str:
        return f"{self.root}/{name.replace('.', '/')}"

    def default_location(self, name: str) -> str:
        """Where a table of this name lives: its registration, else the
        catalog root's convention."""
        if self.exists(name):
            return self._location(name)
        return self._default_location(name)

    # -- mutation ----------------------------------------------------------

    def create_table(self, name: str, schema=None,
                     location: Optional[str] = None,
                     partition_by: Optional[List[str]] = None,
                     cluster_by: Optional[List[str]] = None,
                     properties: Optional[Dict[str, str]] = None,
                     if_not_exists: bool = False) -> Table:
        """Create a named table (a `StructType` schema), or register the
        Delta table at `location` when no schema is given."""
        if cluster_by:
            raise CatalogTableError(
                "CREATE TABLE ... CLUSTER BY is not supported by this "
                "package yet", error_class="DELTA_UNSUPPORTED_FEATURE")
        entry = self._entry_path(name)
        loc = (location or self._default_location(name)).rstrip("/")
        fs = self.engine.fs
        fs.mkdirs(self._dir)
        payload = json.dumps(
            {"location": loc, "createdAt": int(time.time() * 1000)},
            sort_keys=True).encode()
        try:
            fs.write(entry, payload, overwrite=False)
        except FileExistsError:
            if if_not_exists:
                existing = self.table(name)
                _check_create_spec_matches(existing, partition_by,
                                           properties, cluster_by)
                return existing
            raise TableAlreadyExistsError(
                f"table {name} already exists") from None

        table = Table.for_path(loc, self.engine)
        if table.exists():
            _check_create_spec_matches(table, partition_by, properties,
                                       cluster_by)
        elif schema is not None:
            local = "://" not in loc
            dir_existed = local and os.path.isdir(loc)
            log_existed = local and os.path.isdir(
                os.path.join(loc, "_delta_log"))
            try:
                # a WRITE commit, as the reference's catalog makes it
                builder = table.create_transaction_builder(
                    Operation.WRITE).with_schema(schema)
                if partition_by:
                    builder = builder.with_partition_columns(partition_by)
                if properties:
                    builder = builder.with_table_properties(properties)
                builder.build().commit()
            except BaseException:
                # leave no name -> location entry and no half-created
                # table behind; remove only what this call created
                fs.delete(entry)
                if local:
                    if not dir_existed:
                        shutil.rmtree(loc, ignore_errors=True)
                    elif not log_existed:
                        shutil.rmtree(os.path.join(loc, "_delta_log"),
                                      ignore_errors=True)
                raise
        else:
            fs.delete(entry)
            raise MissingTransactionLogError(
                f"no Delta table at {loc}; provide a schema to create one")
        return table

    def register(self, name: str, path: str) -> Table:
        """Register an existing Delta table under a name."""
        t = Table.for_path(path, self.engine)
        if not t.exists():
            raise MissingTransactionLogError(
                f"no Delta table at {path}",
                error_class="DELTA_MISSING_DELTA_TABLE")
        return self.create_table(name, location=path)

    def drop(self, name: str, if_exists: bool = False,
             delete_data: bool = False) -> bool:
        entry = self._entry_path(name)
        fs = self.engine.fs
        if not os.path.exists(entry):
            if if_exists:
                return False
            raise TableNotInCatalogError(f"table {name} not found")
        loc = self._location(name)
        if delete_data and not loc.startswith(self.root + "/"):
            # an external table: refuse rather than keep the data after an
            # explicit request to delete it
            raise CatalogTableError(
                f"table {name} is external (location {loc!r} outside the "
                "catalog root); drop without delete_data",
                error_class="DELTA_OPERATION_NOT_ALLOWED_DETAIL")
        if delete_data:
            shutil.rmtree(loc, ignore_errors=True)
        fs.delete(entry)
        with self._tables_lock:
            self._tables.pop(name, None)
        return True

    # -- resolution --------------------------------------------------------

    def _location(self, name: str) -> str:
        entry = self._entry_path(name)
        try:
            return json.loads(self.engine.fs.read_file(entry))["location"]
        except FileNotFoundError:
            raise TableNotInCatalogError(f"table {name} not found") from None

    def table(self, name: str) -> Table:
        loc = self._location(name)
        with self._tables_lock:
            t = self._tables.get(name)
            if t is not None and t.path == loc and t.engine is self.engine:
                return t
            t = self._tables[name] = Table.for_path(loc, self.engine)
            return t

    def exists(self, name: str) -> bool:
        return os.path.exists(self._entry_path(name))

    def tables(self) -> List[str]:
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(n[:-5] for n in names if n.endswith(".json"))

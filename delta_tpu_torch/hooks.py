"""Post-commit hooks, run after every successful commit.

Counterpart of `delta_tpu/hooks.py`: the `.crc` checksum of the new
version (`checksum_hook`), a checkpoint every `delta.checkpointInterval`
commits (`checkpoint_hook`, at versions > 0 that the interval divides), and
auto-compaction after a data-adding commit on a table with
`delta.autoOptimize.autoCompact` (or the legacy `delta.autoOptimize`)
once 50 files are under 128 MiB (`auto_compact_hook`, the port's
`execute_compaction`), and the symlink manifests of the partitions a
commit touched on a table with
`delta.compatibility.symlinkFormatManifest.enabled`
(`symlink_manifest_hook`, `commands/generate.py`). The commit has landed
before they run, so they are best-effort, as in the reference: a failing
hook does not fail the commit, but bumps `hooks.<name>.failures` and is
logged, so that nothing swallows it unseen. The symlink-manifest hook is
critical, as in the reference (`GenerateSymlinkManifest.handleError`): a
stale manifest would serve external engines rows the table no longer
holds, so its failure is counted too and then raised as
`PostCommitHookError` (the commit stands). The reference's Iceberg/Hudi
hooks are not ported; a table whose configuration asks for them is
refused before the commit (`txn/transaction.py::check_write_supported`).

A hook that needs the state takes `_snapshot_for_hook`: the table's cached
snapshot, which the commit's own bytes advanced (`Table.notify_commit`),
so that it replays nothing in full.
"""

from __future__ import annotations

import logging

from delta_tpu_torch import obs
from delta_tpu_torch.errors import DeltaError
from delta_tpu_torch.config import (
    AUTO_OPTIMIZE_AUTO_COMPACT,
    AUTO_OPTIMIZE_LEGACY,
    CHECKPOINT_INTERVAL,
    SYMLINK_MANIFEST_ENABLED,
    get_table_config,
)

_log = logging.getLogger(__name__)

AUTO_COMPACT_MIN_FILES = 50
AUTO_COMPACT_MAX_FILE_SIZE = 128 * 1024 * 1024


def _snapshot_for_hook(table, version: int):
    """The snapshot at the just-committed `version`: `table.update()`,
    which serves it from the advanced cache without reading the log; the
    snapshot at `version` when that fails or another writer has moved
    past it."""
    try:
        snap = table.update()
        if snap.version == version:
            return snap
    except Exception as e:  # the cache only saves a load
        _log.debug("update() for the hooks at version %d failed (%s); "
                   "loading the snapshot at that version", version, e)
    return table.snapshot_at(version)


def checksum_hook(table, txn, version: int, metadata) -> None:
    from delta_tpu_torch.log.checksum import write_checksum_for_commit

    write_checksum_for_commit(table, txn, version)


def checkpoint_hook(table, txn, version: int, metadata) -> None:
    interval = get_table_config(metadata.configuration, CHECKPOINT_INTERVAL)
    if interval > 0 and version > 0 and version % interval == 0:
        from delta_tpu_torch.log.checkpointer import write_checkpoint
        from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint

        # the previous hint's partManifest lets unchanged parts be reused
        prev = read_last_checkpoint(table.engine.fs, table.log_path)
        write_checkpoint(table.engine, _snapshot_for_hook(table, version),
                         prev_info=prev)


def auto_compact_hook(table, txn, version: int, metadata) -> None:
    conf = metadata.configuration
    if not (get_table_config(conf, AUTO_OPTIMIZE_AUTO_COMPACT)
            or get_table_config(conf, AUTO_OPTIMIZE_LEGACY)):
        return
    if txn.operation == "OPTIMIZE" or not txn._adds:
        return
    state = _snapshot_for_hook(table, version).state
    sizes = state.file_actions.size[state.live_mask]
    if int((sizes < AUTO_COMPACT_MAX_FILE_SIZE).sum()) < AUTO_COMPACT_MIN_FILES:
        return
    table.optimize().execute_compaction(
        min_file_size=AUTO_COMPACT_MAX_FILE_SIZE,
        max_file_size=AUTO_COMPACT_MAX_FILE_SIZE)


def symlink_manifest_hook(table, txn, version: int, metadata) -> None:
    from delta_tpu_torch.commands.generate import (
        incremental_symlink_manifest_hook,
    )

    if not get_table_config(metadata.configuration,
                            SYMLINK_MANIFEST_ENABLED):
        return
    if not (txn._adds or txn._removes):
        return
    incremental_symlink_manifest_hook(table, txn, version, metadata,
                                      _snapshot_for_hook(table, version))


symlink_manifest_hook.critical = True


class PostCommitHookError(DeltaError):
    """A critical post-commit hook failed; the commit itself stands."""

    error_class = "DELTA_POST_COMMIT_HOOK_FAILED"

    def __init__(self, hook_name: str, version: int, cause: Exception):
        super().__init__(f"post-commit hook {hook_name!r} failed after "
                         f"version {version} committed: {cause}")
        self.hook_name = hook_name
        self.version = version
        self.__cause__ = cause


HOOKS = (checksum_hook, checkpoint_hook, auto_compact_hook,
         symlink_manifest_hook)


def run_post_commit_hooks(table, txn, version: int, metadata) -> None:
    for hook in HOOKS:
        try:
            hook(table, txn, version, metadata)
        except Exception as e:
            obs.counter(f"hooks.{hook.__name__}.failures").inc()
            _log.warning("post-commit hook %s failed after version %d "
                         "committed (the commit stands)", hook.__name__,
                         version, exc_info=True)
            if getattr(hook, "critical", False):
                raise PostCommitHookError(hook.__name__, version, e) from e

"""delta_tpu_torch: the PyTorch/CUDA port of delta-tpu, for an NVIDIA H100.

The JAX package `delta_tpu` stays the reference; this package imports
nothing of it. It loads a `_delta_log` of JSON commits, anchored or not by
a classic (single- or multi-part) Parquet checkpoint:

    from delta_tpu_torch import Table, TorchEngine
    state = Table.for_path(path, engine=TorchEngine()).latest_snapshot().state

LIST -> checkpoint parts (own footer reader and snappy; device page decode,
kernel K3, the hybrid bit-field extract; host leaf reader for the rest) ->
tail commits (parallel read, device JSON parse, kernel K1, byte classes)
-> device replay (stable sort + kernel K2, the winner pass) -> live-file
and tombstone masks on the card. The table keeps that snapshot:
`Table.update()` replays only the commits past it (K1, K2), a commit of
this package hands its own bytes over (`Table.notify_commit`), metadata
comes from the `.crc` or the checkpoint's small-action columns, and
`Table.history()` / `snapshot_as_of_timestamp()` travel in time.

Scans (`Snapshot.scan(filter, columns)`, `api.read_table`) prune
partitions and skip files by their stats: a resident int64 lane matrix
per version on the card and one launch of kernel K7 (the skip mask) per
filtered scan; the row read applies the residual filter and projection.

It writes to an unpartitioned table (`api.write_table`) and runs OPTIMIZE
(`Table.optimize()`: compaction, Z-order and Hilbert clustering) with its
own data-file reader and writer and an optimistic transaction; the curve
permutation runs on the card (kernel K4, the bit interleave). Every commit
runs the post-commit hooks (`hooks.py`: a `.crc` per version, a classic
or multi-part checkpoint every `delta.checkpointInterval` commits,
auto-compaction); `Table.checkpoint()` writes one on demand. DELETE and
UPDATE (`commands/dml.py`) write deletion vectors or copy the survivors;
a deletion vector is packed and decoded on the card (kernel K8, the
roaring bit scatter), and the row read and OPTIMIZE apply it. The last two
TPU kernels have entry points of their own: `ops/unpack.py` (kernel K5,
Parquet bit-packed groups) and `ops/minmax.py` (kernel K6, per-file min,
max and null count).

SQL (`sql.py`, `sqlengine/`, `catalog.py`) runs one SELECT block over
Delta tables: scans with pushed-down filters, then joins, aggregates
(kernel K10, the segment aggregate) and ORDER BY sorts on the card.
"""

from delta_tpu_torch.engine import TorchEngine
from delta_tpu_torch.table import Table

__all__ = ["Table", "TorchEngine"]

#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (`delta_tpu_torch`) once on one card.

    python3 chip_smoke.py [--commits N] [--profile]

1. Prints the card (name, count, `nvidia-smi` name and power limit).
2. Builds every hand-written kernel from `delta_tpu_torch/csrc/` with
   `nvcc` for sm_90a, and the host codec library with `c++`, one compiler
   per source, all at once.
3. Writes the repo's headline log shape (`bench.py`'s `synth_delta_log`:
   100 files per commit, 20% removes, stats on every add; --commits,
   default 10,000, cuts the depth of the benchmark's 100,000) and, with
   the generator's `utils/synth.py::write_checkpoint` (the package's
   checkpoint encoder over the generator's truth), a checkpoint of its
   state at version
   `commits - 10` (Delta's default interval of 10 commits), split into
   parts as `bench.py` splits them (`part_size = num_files // 8`), with
   every tombstone inside the 7-day retention window.
4. Kernel phase K1/K2: each against its plain PyTorch version on the
   card, at the main path's shapes, exact (`torch.equal`), then timed with
   CUDA events beside its plain version and its bound. K1 is timed on a
   real parse window; K2 on inputs of the main path's size: the
   commit-only load's own sorted replay keys, the same keys with their
   path codes put through a seeded random permutation before the sort
   (the order a table of random file names gives).
5. Commit-only path: the checkpoint files set aside, the log loads with
   `Table.for_path(p, engine=TorchEngine()).latest_snapshot().state`, with
   every counter set to 0 just before. The live files, their size and the
   tombstones must equal the generator's truth; the parse must have run
   on the device with no fallback; K1 and K2 must have launched.
6. Kernel phase K3: `hybrid_extract` against its plain version on the
   run, tile and lane plan of every part of the headline checkpoint (as
   the checkpoint-and-tail load plans them) and on edge plans (widths 0,
   1, 31, 32, shift 0, an RLE value with bit 31 set, h_total 1 and 1025,
   a bit-packed run ending in the lane's last bytes, runs of 0 values, a
   run one position longer than a tile, positions past a run's count, a
   lane at an address that is not 16-byte aligned); timed on the first
   file-action part per call (CUDA events around 50 calls of the wrapper)
   and on the card alone (`device_ms`, the kernel's own duration from
   torch.profiler), beside its plain version and its bound, and summed
   over all parts as the load launches it.
7. Checkpoint path, the slice's main path: the checkpoint put back, the
   same load runs through it (the checkpoint parts, then the 9 tail
   commits), counters from 0; the truth must hold again, every part must
   have decoded on the device (no fallback), K3 must have launched once
   per part and K1 and K2 at least once. Prints the phase split.
   Then the load's degradation ladder on a copy of that log (hard links),
   counters from 0 before each load: a torn commit after the newest one
   serves the newest intact version, the generator's truth, through the
   checkpoint (`snapshot.torn_commit_fallbacks` and `log.torn_commits` 1,
   K3 once per part on each of the two attempts); every part cut to half
   its bytes rebuilds from the JSON commits alone to the truth
   (`snapshot.checkpoint_fallbacks` 1, K3 not launched), and in the same
   load a `.crc` of the newest version that lies about the file count and
   size is quarantined (`snapshot.crc_quarantined` 1) and reseeded from
   the state.
   Then scan planning on that log's snapshot (every live file with stats
   on x in [(fid+1)*1000, (fid+2)*1000]), counters from 0: five filtered
   `Snapshot.scan`s (a range selecting 1% of the files, an OR of two
   ranges, IN with 16 values, IS NULL, NOT of a range), each surviving
   set equal to the generator's truth computed in numpy; the first
   builds the resident stats index (`scan.stats_index_builds` 1), the
   others reuse it (`scan.stats_index_reuses` 4), each plans on the card
   (`scan.device_plans` 5) through kernel K7 (`skip_mask`, 5 launches).
   K7 is held to its plain version on every predicate's atom block and
   timed on the range's beside its plain version and its bound (device
   time with L2 flushed between calls, and warm); prints
   `stats_index_build_s` (cold, with its split), `plan_s` (warm).
   Then the snapshot's life after the load on a copy of that log (hard
   links): a cold load on the card, a filtered scan that builds its stats
   index, 10 new commits of the generator's
   shape (100 files each, 20% removes of live files, one re-add of a
   removed path, one path that needs percent-decoding, removed later by
   its decoded spelling) and, counters from 0, `Table.update()`: one
   LIST, the 10 new commits read and parsed (K1) and replayed on top of
   the retained state (K2), K3 not launched, no full replay; the
   advanced state equals a cold `snapshot_at` of the new head bit for
   bit (lanes and masks, the key codes a bijection) and the appended
   live set; the advance released the prior stats index, and the
   advanced snapshot's first scan rebuilds it (one build, one K7 launch)
   and equals the cold snapshot's scan. Then a no-change poll (one LIST, no read), `metadata` on a
   fresh Table by the small read and then from a `.crc` (no part
   decoded), an append through `write_table`'s own steps on the Table
   holding the advanced snapshot (its commit advances the cache; the
   checkpoint hook at that version writes from it, no full replay), a
   `write_table` on a fresh Table (metadata from the `.crc`), and a
   reload through the hook's checkpoint to the expected live set.
   Prints each wall time beside the cold load's, with the counters.
8. Checkpoint-write path, BASELINE config 2's write half: the latest
   snapshot of the headline log loaded on the card, then, counters from
   0, `log/checkpointer.py::write_checkpoint(engine, snapshot)` with
   `checkpoint_part_size = num_files // 8` (`bench.py:823`); prints
   `checkpoint_write_gbps` (bytes written / wall, as `bench.py:940-960`),
   parts, rows, bytes, the phase split and peak device memory. Checks:
   `_last_checkpoint` names the head version with the part count and
   numOfAddFiles; the write's aggregate counters
   (`checkpoint.logical_bytes`, `.dv_cardinality`,
   `.distinct_partition_values`) equal the facts of the block that the
   card and the host twin compute alike on the same lanes, and the
   logical bytes equal `size_in_bytes`; a fresh load, counters from
   0, reads the new checkpoint alone (K3 once per part, no fallback) to
   the generator's live files, size and path digest, and to the
   tombstones retained under the real clock (computed from the loaded
   state). The new checkpoint is then removed again.
   Then the log forms (`log_forms_phase`) on a copy of that log (hard
   links), each load's counters from 0 just before it and read just
   after, each held to the generator's truth: compacted deltas over the
   tail and over 1,000 commit-only versions (K1 on their lines, with and
   without the checkpoint); a V2 checkpoint at the head with cell 5's
   part size (its file actions in 9 sidecars) and its reload alone (K3
   once per sidecar, K2); two append-only commits and a second V2 write
   with the first's hint (most sidecars reused; the counts printed); a
   fresh sidecar deleted (one fallback, to the first V2); a struct-only
   checkpoint (`writeStatsAsStruct` without JSON stats) and its reload,
   whose re-serialized stats hash to the JSON-stats reload's, and cell
   7's five filters on it (K7 once each); `cleanup_expired_logs` under a
   clock 31 days ahead (the deleted files printed, no sidecar among
   them; the load still meets the truth; `snapshot_at` of a deleted
   version raises as the reference does); and C6 (`k < 1.5` keeps both
   files of a table with a value past 2^53). Each write's seconds and
   bytes, each reload's seconds with its split, the struct-only index
   build and the cleanup print on lines of their own with the card.
9. Handoff phase: a 200-commit log checkpointed at its head (its path
   dictionaries stay under 1 MiB, so the keys are dictionary-coded) must
   load through the handoff (`decode.handoff_launches` >= 1) to its truth.
10. A small checkpointed log loads on the card and on the CPU (plain
    versions) to equal masks and equal live files.
11. Kernel phase K4: `interleave_bits` against its plain version on the
    card, exact, on the OPTIMIZE cell's own rank matrix ([3, rows],
    n_bits 32: the scaled ranks of k1, k2, k3) and on edge shapes
    (n = 1, 31, 33, 1023, 1025; k = 1..5; n_bits 16 and 32; bit 31 set;
    all-ones rows); timed beside its plain version and its bound.
12. Kernel phase K5: the entry point `unpack_bitpacked` at the
    benchmark's shape (`benchmarks/device_merit.py:491-506`: w = 16,
    random words; 10M values), counters from 0, then the kernel against
    its plain version, exact, there and on every w in 1..32 at G = 1, 31,
    1025, plus w = 0 and the width guard; timed beside its plain version
    and its bound (60 MB of words and values).
13. Kernel phase K6: the entry point `batched_file_stats` on the OPTIMIZE
    cell's payload column as f32 [20, 500,000], all valid and under a
    seeded 10% null mask, counters from 0, against numpy; the kernel
    against its plain version bit for bit there and on edge shapes (F = 1,
    9; R = 1, 129; NaN, signed zeros, infinities, an empty file); timed
    (one kernel per call) beside its plain version, `torch.where` +
    `torch.aminmax`, and its bound.
14. OPTIMIZE path, BASELINE config 4 (`benchmarks/workloads.py:162-203`):
    the port's `write_table` builds a table of the first
    OPTIMIZE_CELL_APPENDS (10) of its 20 appends of 500,000 rows (k1, k2,
    k3 int64 uniform in [0, 2^30), payload float64 normal; 5M rows, a cut
    for the run's time: K4's own phase above keeps the 10M rows), then,
    counters from 0, `Table.for_path(p, engine=TorchEngine()).optimize()
    .execute_zorder_by("k1", "k2", "k3")`. The new snapshot must hold one
    tombstone with dataChange false a file and ceil(bytes / 256 MiB) live
    files,
    all with ZCube tags; the rows read back in add order must be the
    input rows (an order-free digest, and a row-by-row match), in
    non-decreasing curve-key order under the keys the plain versions
    compute; K4 must have launched. The post-commit hooks run on every
    commit: a checkpoint at each tenth version, the OPTIMIZE commit's (10)
    among them (the new snapshot loads from it), a `.crc` per version, the OPTIMIZE commit's validating against the
    reloaded state, no hook failure; the ZCube tags are checked on the
    OPTIMIZE commit file's own adds (the checkpoint, like the reference's,
    has no add.tags column). Then the row read, counters from 0:
    `api.read_table(table, filter=(k1 < 2^28) & (k2 >= 2^29),
    columns=["k1", "payload"])` on the card (K7 once) must return the
    rows the same filter selects in numpy from those appends, as a
    multiset of row hashes. Prints the phase split, rows/s of the
    command and of `zorder_sort_indices` alone, the read's wall seconds
    and table rows/s, and peak device memory.
15. A 20,000-row table optimized along both curves on the card and on the
    CPU (plain versions): the same output rows in the same order and the
    same stats.
16. DML path (cell 10, `dml_phase`): the first DML_APPENDS (10) of the
    OPTIMIZE cell's 20 appends (5M rows; a cut, for the run's time)
    written by the port to a table created with
    delta.enableDeletionVectors, then, each step's counters from 0 and
    its rows against numpy as a multiset of row hashes: a sparse DELETE
    `k1 < 2^22` (a DV of array containers on every file), a read filtered
    on k2 (K7 plans, K8 decodes every DV in one launch), a dense DELETE
    `payload > 1.2816` (about 10%: the union with each DV, bitmap
    containers that K8 packs in one launch), a read of every row, an
    UPDATE of three rows' payload (three files copied), OPTIMIZE
    compaction (every DV purged), a reload and a read. Each step's K8
    pack and decode launches and `parse.device_fallbacks` (K1 hands a
    window with a DV line to the host) must be the expected ones
    (`DML_EXPECT`: 6 K8 launches in all), and print with the step's wall
    time, the DVs its decode covered and its DV host path (plan, upload,
    launch, copy back, split). After each DELETE, K8 against its plain
    version over every DV's decode tiles and pack tiles in one batch, the
    masks on the card against the CPU's, and the DVs re-serialized on the
    card to their stored bytes. K8 is timed at two shapes, decode and
    pack: (a) the dense DELETE's 10 DVs, (b) the same blobs ×100 (1,000
    DVs), each beside its plain version (on the CPU), its bound and one
    `scatter_add_` over precomputed lanes.
17. MERGE path (cell 11, `merge_phase`): a target of 10M rows (id
    0..10M-1, v normal from the seed, month "01".."12" time-ordered by
    id; `benchmarks/workloads.py`'s MergeBenchmark source shape and
    TpcdsLite's monthly partitions) written as 20 appends with
    `partition_by=["month"]`, then, each step's counters from 0 and its
    rows against numpy as a multiset: an upsert of a 1M-row source (half
    ids drawn from months 11-12, half new ids in month 12) ON id and
    month, WHEN MATCHED UPDATE SET v, WHEN NOT MATCHED INSERT *; a
    delete-merge of 1,000 rows into month 01 (WHEN MATCHED AND source.v
    < 0 DELETE); a read filtered on month 12; OPTIMIZE ZORDER BY id
    where month 12; a reload and a full read. The MergeMetrics must be
    the counts numpy gives (files scanned by the source's bounds and the
    partitions, rewritten, rows copied), K9 launched once per MERGE.
    K9 against its plain version on the card at the upsert's own sorted
    join lanes, at a skewed shape (one key with 150,000 target rows,
    insert-only) and at an all-one-key shape (1,000,000 target and
    1,000,000 source rows on one code), timed beside its plain version,
    its bound and `torch.unique_consecutive`; the longest run printed.

18. Parquet forms of other writers (`parquet_forms_phase`): every data
    fixture under `tests/torch_fixtures/parquet_forms/` (written once by
    Arrow's Parquet writer: INT96 timestamps, GZIP and ZSTD pages at levels 1 and 19 and
    a multi-block frame, data page v2, the DELTA_*, BYTE_STREAM_SPLIT and
    RLE-boolean encodings) read by `read_data_file` to the digests of its
    `manifest.json` (each column's values and validity as Arrow read
    them); each fixture log (a ZSTD, a GZIP and a v2 checkpoint part, each
    with tail commits) loaded with `TorchEngine()`, counters from 0, to
    the manifest's live files, with the ZSTD and GZIP parts decoded on the
    card (`decode.device_parts` 1, K3 once) and the v2 part on the host
    (`decode.device_fallbacks` 1, K3 not launched). Then the host decoders
    timed in MB/s of output: ZSTD on the largest ZSTD page of the
    fixtures, snappy on the same bytes recompressed by `log/snappy.py`.

19. Wider schema types (`wide_types_phase`): TPC-DS store_sales (23
    columns, 12 of them decimal(7,2): INT32 in two fixture files, FIXED_LEN_BYTE_ARRAY
    in two; one file with a DV written by the reference's DELETE) from
    `tests/torch_fixtures/wide_types/`, each file hard linked 120 times
    under one hand-written commit (2,880,000 rows, 480 adds: SF1's
    2,880,404), loaded with `TorchEngine()` (K1, K2) and read: q3's
    columns, one quarter of the sold dates (K7 keeps 120 files),
    `ss_net_profit > 0` (a Decimal literal), all 23 columns; each read's
    digests (valid count, sum and sum of squares mod 2^64 per column)
    the manifest's times 120, K7 once per filtered read, K8 once per read
    over the 120 shared DVs. Then the nested fixture (byte, short,
    binary, timestamp_ntz, decimal(38,10), struct, array, map, nested in
    each other, v1 and v2 pages) whole and projected, to the manifest's
    row digests. Prints rows/s and seconds per read.

20. Writing the wider types (`wide_write_phase`), TPC-DS's data
    maintenance of store_sales (v3 clause 5) on step 19's full read
    (2,812,440 live rows, each copy's tickets renumbered so that
    (ss_item_sk, ss_ticket_number) is unique), each step's counters from
    0 and its rows against a numpy model of that read (per column valid
    count, sum and sum of squares mod 2^64): `write_table` in files of
    6,000 rows with deletion vectors and struct stats, a reload (K1, K2)
    and a read of all 23 columns to the manifest's sums times 120; DF_SS,
    a DELETE of 90% of a quarter's sold dates (K7 keeps the files the
    stats give; K8 packs their DVs of bitmap containers once); an UPDATE
    of one ticket's `ss_coupon_amt` (a decimal SET); LF_SS, a MERGE on
    the key of a 1% source, half matched in the last quarter, half new
    tickets (K9 once); OPTIMIZE ZORDER BY (ss_customer_sk, ss_item_sk)
    of the last quarter (K4 once); a checkpoint with struct stats, its
    reload (K3 once per part), a read with `ss_net_profit > 0` (K7) and
    one of every column; then the 600-row nested fixture written back to
    the manifest's row digest. Prints each step's seconds, rows/s and
    launches.

21. Column mapping and ALTER TABLE (`column_mapping_phase`) on step 20's
    table at its end (2,223,984 live rows, DVs on), each step's counters
    from 0 and its rows against step 20's numpy model carried through
    the renames: `set_properties` to mode `name` (the protocol lists
    columnMapping; no data file's bytes or mtime change; each field keeps
    its name as its physical name), a reload (K3 per part, K1, K2),
    RENAME ss_net_profit TO ss_profit, DROP ss_coupon_amt, ADD
    ss_channel (K1 on each commit's handoff), `ss_profit > 0` (K7 keeps
    step 20's files of `ss_net_profit > 0`), a DELETE on ss_profit (K7,
    K8 packs the union with DF_SS's bitmaps), an UPDATE setting
    ss_channel (K7), LF_SS's 1% MERGE on the key (K9), ZORDER BY
    ss_profit of the last quarter (K4; its file holds the physical
    names), a `stats_parsed` checkpoint keyed by physical names, an
    append, a reload (K3, K1, K2), the profit read again (K7) and a full
    read (no ss_coupon_amt; ss_channel null outside the updated, merged
    and appended rows); then step 19's first quarter of sold dates
    written afresh in mode `name` partitioned by ss_sold_date_sk (every
    footer `col-` names only, partitionValues keyed by the physical
    name, nulls in `__HIVE_DEFAULT_PARTITION__`), a 30-date read that
    prunes partitions, and after renaming the partition column the same
    read by the new name: the same files and rows. Prints each step's
    seconds, rows/s and launches.

22. The write modes (`write_modes_phase`) on step 21's two tables, each
    step's counters from 0 and its rows against step 21's numpy models.
    On the fresh table partitioned by the renamed sold date (720,000
    rows): a dynamic partition overwrite of one week's rows with their
    ss_quantity refreshed (exactly those 7 partitions' files removed,
    every other file kept by path); `replace_where` on 30 dates of the
    partition column (its files removed whole, no K7), then a batch with
    one row outside the range refused (DELTA_REPLACE_WHERE_MISMATCH) at
    the same version; a `merge_schema` append of one new date's rows with
    ss_promo_channel (a `col-` physical name, null in the old rows); the
    rows written back with `data_change=False` (every action dataChange
    false, the same rows); `ignore` (no commit) and `error`
    (PathExistsError); `overwrite_schema` with three columns dropped,
    unpartitioned (`col-` names only in every file), a reload and a full
    read. On the upgraded table (name mode, DVs): `replace_where` on a
    data column, one store's rows in quarter 2's first 10 copies of
    tickets refreshed (K7 plans, K8 packs the union with DF_SS's bitmap
    DVs, the new rows in the same commit), a reload through step 21's
    checkpoint (K3 per part, K1, K2) and a full read. Each write but the
    appends loads the table afresh (K1, K2; K3 per checkpoint part) and
    hands its commit to the cached snapshot (K1).
    Prints each step's seconds, rows/s and launches.

23. Maintenance (`maintenance_phase`), each step's counters from 0: VACUUM
    on a hard-link copy of the headline log (its files and a zero-byte
    file planted for one live file and one tombstone in sixty, 100
    untracked files, a `_change_data/` file and two hidden ones, all
    aged two hours; the cut of one in sixty is for the run's time), with
    retention 1 hour: a FULL dry run naming the generator's planted
    tombstones, untracked and `_change_data` files (the load: K3 once
    per part, K1, K2), a LITE dry run naming every tombstone of commits
    0..head (the range through the device parse, K1), FULL for real (the
    planted live and hidden files kept, the watermark at the head), LITE
    again empty; then REORG PURGE of step 22's DV table (K8 decodes every
    DV in one launch; K1 on the handoff; no live file keeps a DV), a full
    read; VACUUM of it with retention 0: a dry run, LITE for real (the
    purged files and their DV files gone), a FULL dry run naming the one
    planted orphan, a reload and a full read (K8 0); RESTORE of step 22's
    partitioned table to the version before `overwrite_schema` (schema
    and partitioning back, K1 on the handoff), a full read, VACUUM with
    retention 0, a full read, a RESTORE to the new schema's version
    refused (DELTA_RESTORE_MISSING_DATA_FILE); a shallow CLONE of the DV
    table read back, VACUUM of the clone (none of the source's files
    deleted), a deep CLONE read back; every row against the generator's
    truth or step 22's numpy models, every fixture file's name and size
    unchanged. Prints each step's seconds, rows/s, launches and VACUUM's
    phase seconds (load, protected set, walk or LITE's range scan,
    selection, unlinks, watermark).

24. Table features (`table_features_phase`), each step's counters from
    0, its rows against the numpy models carried from step 22: on step
    23's DV table, `delta.enableTypeWidening` and CHANGE COLUMN TYPE
    ss_quantity integer -> long and ss_sales_price decimal(7,2) ->
    decimal(9,2) (K1 on the handoff), 10,000 rows with ss_quantity past
    2^31 and reads filtered at the old files' exact bound and past 2^31
    (K7 over int and long bounds), ZORDER BY ss_quantity (K4), a
    checkpoint, a reload through it (K3 per part) and a full read;
    LF_SS's MERGE with a new column under `with_schema_evolution()` (K9;
    the old rows read it as null), a DELETE leaving a deletion vector;
    ADD CONSTRAINT `ss_quantity >= 0` refused (NULL quantities violate),
    then `ss_quantity IS NULL OR ss_quantity >= 0` added (every live row
    checked, K8 decoding the DVs once); a violating append and UPDATE
    refused with the version and live files unchanged; DROP CONSTRAINT.
    Then step 19's first quarter written afresh with an identity column
    (start 1000, step 3), a generated ss_tax_covered =
    ss_net_paid_inc_tax >= ss_net_paid (checked with numpy first) and a
    CURRENT_DEFAULT ss_channel, two appends and LF_SS's MERGE (K9): the
    identity values unique and running by the step from each commit's
    watermark, the generated and default values numpy's. At least one
    launch each of K1, K2, K3, K4, K7, K8 and K9. Prints each step's
    seconds, rows/s and launches.

25. The change data feed (`change_data_feed_phase`), each step's counters
    from 0, its rows against the numpy models carried from step 24: on
    step 24's DV table (a), `delta.enableChangeDataFeed` on (K1 on the
    handoff), DF_SS's DELETE of 80% of quarter 0's sold dates (K7, K8
    packs; its change data file in Delta's form), an UPDATE of a few
    hundred rows, LF_SS's 1% MERGE (K9), then `read/cdc.py::
    table_changes` over those versions (K1 on the range): per version and
    change type (ss_item_sk, ss_ticket_number, ss_profit) equal to the
    model's, each `_commit_timestamp` its commit's, the same rows by
    timestamp bounds, DELTA_MISSING_CHANGE_DATA from before the flag;
    RESTORE to the flag's version and its feed (made from DV'd removes
    and adds: counts from numRecords and DV cardinalities, inserts minus
    deletes equal to the model's difference, every DV in one K8 decode).
    On step 23's partitioned table (b): the flag, an append of a new
    date, a DELETE of one date's partition and a 1% MERGE (K9) whose
    change data lies under `_change_data/<physical key>=<date>/`, and
    their feed with the partition column restored. At least one launch
    each of K1, K2, K3, K7, K8 pack, K8 decode and K9.

26. Device SQL (`sql_phase`), TPC-DS's 102 texts through
    `delta_tpu_torch.sqlengine.execute_select` on `TorchEngine()`: (a) at
    scale 12,000 (`utils/tpcds.py`'s generator, `load_delta` on the
    card), each with LIMIT stripped, and q51 with its running windows in
    the default RANGE frame (`q51_range`: no corpus text has one), against
    Python's `sqlite3` loaded from the same numpy columns, its `*_sk`
    columns indexed (the oracle's mechanical rewrites, ROLLUP expanded into
    its levels, and 2e-4 tolerance, `tests/tpcds_sqlite_oracle.py`; sqlite
    runs in a thread beside the card's queries), q67 against
    `TorchEngine("cpu")` (its nine-level ROLLUP expansion overflows
    sqlite's parser; so do q51, q97 and q51_range where sqlite predates
    FULL OUTER JOIN, 3.39); every aggregate and window the executor ran
    launched its kernel (K10; K11's ranks, running scan and peer pass), no
    string aggregate on the host, each verbatim text within its LIMIT;
    (b) at SF1's 2,880,404 store_sales rows (every other table sized by
    the generator's rules; the twelve tables the queries read written on
    the card), q3, q7, q42, q43, q52, q55, q96 and q17, q59 (a CTE
    self-joined), q65 (nested derived tables), q32 (a correlated scalar
    over catalog_sales), q87 (EXCEPT of three channels), q98 (a partition
    SUM window), q27 (ROLLUP), q97 (a FULL OUTER JOIN of two channels),
    q28 (COUNT(DISTINCT) over six buckets), q86 (rank() over ROLLUP's
    levels), q51 (running windows in ROWS frames, a FULL OUTER JOIN) and
    q51_range (the peer pass) on the card and on `TorchEngine("cpu")`,
    equal rows, each query's seconds, phase split (scan, join, group,
    sort) and the launches of K1, K2, K3, K7, K10 and K11's three
    launchers, each of K11's at least once; (c) K10 (`csrc/seg_agg.cu`)
    against its plain version and timed beside it, `scatter_reduce_`, its
    bound and its launches a call at six shapes, one or two of each of its
    regimes: store_sales' `ss_ext_sales_price` by `ss_item_sk` (11,521
    groups; also the variance's sumsq pass), `ss_quantity` by
    `ss_store_sk` (12 groups), the largest group-by that (b) ran, and
    `ss_ext_sales_price` by `ss_customer_sk` (57,608 groups) and by
    `ss_ticket_number` (about 221,000 tickets of 1-25 rows, in runs); and
    K11 (`csrc/window_scan.cu`, `k11_phase`) at store_sales' rows in
    (ss_item_sk, ss_sold_date_sk) order: ranks, the running sum, mean,
    count, min and max, and the peer pass of the running sum against
    their plain versions (exact; sums within 1e-9 of the partition's
    absolute sum), each called twice with the same bits, timed beside
    them (`torch.cumsum` beside the running sum) with their bounds, one
    kernel and one memset a call in the trace.

27. SQL's statements past the query (`sql_statements_phase`, inside
    `sql_phase` after (b), on (b)'s SF1 tables), every one through
    `delta_tpu_torch.sql.sql` with the card's catalog, after TPC-DS v3
    §5's data maintenance: DESCRIBE DETAIL and HISTORY of store_sales,
    SET TBLPROPERTIES turning deletion vectors on, DF_SS as a DELETE of
    a tenth of the sold dates (K7, K8 pack), an UPDATE of the first
    2,000 tickets' quantity (K8 decode), CREATE TABLE lf_ss and INSERT
    INTO it 1,000 rows by VALUES, MERGE INTO store_sales on (ticket,
    item) with UPDATE SET * and INSERT * (half the rows live keys, K9),
    OPTIMIZE store_returns ZORDER BY (sr_item_sk, sr_customer_sk) (K4),
    RESTORE of store_sales to before the DELETE, VACUUM RETAIN 0 HOURS
    DRY RUN, GENERATE symlink_format_manifest for store_returns, ADD and
    DROP CONSTRAINT and DROP FEATURE checkConstraints on lf_ss, CONVERT
    TO DELTA of hard links to store_returns' data files, DROP TABLE and
    SHOW TABLES. After each data-changing statement the row count and
    the sums of ss_quantity and ss_net_paid equal numpy's truth from the
    generator's columns; the manifest names the live files; the
    converted table's rows are its source's; store_sales read on the card
    equals its read on `TorchEngine("cpu")`, row for row. Each
    statement's seconds and launches; K1, K2, K4, K7, K8 pack and decode
    and K9 at least once in the step.

Prints a metrics line per phase, a `kernels` JSON line (K1-K11, each with
its launches (K1, K2, K3 and K7 also `launches_v2`,
`launches_stats_parsed` and `launches_compacted`; K1-K4 and K7-K9
`launches_wide_write` and `launches_column_mapping`; K1-K3, K7 and K8
`launches_write_modes`; every kernel `launches_maintenance`,
`launches_table_features`, `launches_change_data_feed` and
`launches_sql_statements`; K1-K3, K7 and K11's three launchers
`launches_sql`), its time per
call (`ms`, CUDA events around back-to-back calls of the wrapper) and on
the card alone (`device_ms`, torch.profiler), its bound and both shares
of the bound), a `phase_wall` line (each phase's wall seconds), the
card's `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
line, and as the last line `{"ok": true, "device": {...}}`. Any failed phase exits
non-zero and prints no result; so does a run without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor float32 peak, taken as the
                            # integer-operation ceiling (the data sheet gives
                            # no separate integer ALU rate)
WEEK_MS = 7 * 86_400_000    # now_ms that keeps every synthetic tombstone
                            # (deletionTimestamp = its commit index) within
                            # the default 7-day retention


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: warm-up, then `reps` calls
    between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, kernels, per_call: int = 1,
               launches: list = None) -> float:
    """Device milliseconds per call of the kernels whose names hold one of
    `kernels`, each launched `per_call` times a call: the sum over those
    kernels of their mean duration in a torch.profiler trace of `reps`
    calls (after a warm-up step, so that tracing is on when they start).
    The kernels' own time on the card, without the host work between
    launches that `_time_ms` counts. The tracer may miss launches, a few
    at its start or whole traces (once it loses events it tends to see
    none again in that process): the
    mean is over those it saw, and a trace that saw fewer than half is
    taken again, up to three times; then the time comes from
    `_stalled_ms` instead, which counts every device operation of a call
    (a fill, a copy) beside the kernels, and the miss is recorded in
    `DEVICE_MS_BY_EVENTS`, which the run prints. A `launches` list gets
    {"per_call": the kernels' launches a call that the trace saw,
    "kernels": each kernel's launches and mean microseconds} (None where
    it fell back)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        rows = [r for r in _device_rows(prof)
                if any(k in r[1] for k in kernels)]
        seen.append([r[2] for r in rows])
        if rows and all(2 * c >= reps * per_call for _, _, c in rows):
            if launches is not None:
                launches.append({
                    "per_call": sum(c for _, _, c in rows) / reps,
                    "kernels": [{"name": k[:48], "launches": c,
                                 "mean_us": us / c} for us, k, c in rows]})
            return sum(us / c for us, _, c in rows) * per_call / 1e3
    if launches is not None:
        launches.append(None)
    ms = _stalled_ms(fn, reps)
    DEVICE_MS_BY_EVENTS.append({"kernels": list(kernels), "seen": seen,
                                "reps": reps, "ms": ms})
    return ms


DEVICE_MS_BY_EVENTS: list = []
STALL_CYCLES = 50_000_000   # about 25 ms at the H100's clocks


def _stalled_ms(fn, reps: int) -> float:
    """Device milliseconds per call of `fn` with the host's gaps taken
    out: the stream is held by a spin kernel (`torch.cuda._sleep`) while
    the host enqueues `reps` calls between two events, so the events
    time the calls' device work back to back. `fn` must not synchronize;
    a host that enqueues slower than the spin lasts is caught (the spin
    is then lengthened, up to three times)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = STALL_CYCLES
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event(enable_timing=True)
        head = torch.cuda.Event(enable_timing=True)
        head.record()
        torch.cuda._sleep(cycles)
        spun.record()
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < head.elapsed_time(spun):
            return start.elapsed_time(end) / reps
        cycles *= 4
    _check(False, f"the host enqueued {reps} calls slower than a spin of "
           f"{cycles // 4} cycles")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_phase(window: torch.Tensor, n_rows: int, dev) -> dict:
    """Each kernel against its plain version on the card; returns the
    per-kernel numbers of the `kernels` line (launches filled in later)."""
    from delta_tpu_torch.ops.byte_class import byte_class, byte_class_plain
    from delta_tpu_torch.ops.replay import winner_pack, winner_pack_plain

    # K1: a real 64 MiB window, then lengths that are not multiples of 16
    # and a buffer that is not 16-byte aligned
    got = byte_class(window)
    torch.cuda.synchronize()
    want = byte_class_plain(window)
    _check(torch.equal(got, want), "byte_class != plain on the window")
    err1 = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    for n in (1, 15, 17, 4097, 1_000_003):
        x = window[:n]
        _check(torch.equal(byte_class(x), byte_class_plain(x)),
               f"byte_class != plain at n={n}")
        torch.cuda.synchronize()
    x = window[1:1 + 999_999]
    _check(torch.equal(byte_class(x), byte_class_plain(x)),
           "byte_class != plain on an unaligned slice")
    torch.cuda.synchronize()
    n1 = window.numel()
    k1_ms = _time_ms(lambda: byte_class(window), 50)
    k1_dev = _device_ms(lambda: byte_class(window), 50, ("byte_class",))
    k1_plain = _time_ms(lambda: byte_class_plain(window), 10)
    k1_bound, k1_by = _bound_ms(2.0 * n1, 12.0 * n1)

    # K2: the main path's row count with long duplicate runs and a key
    # 0xFFFFFFFF, then n = 1 and 33 (it is timed on the main path's own
    # keys, after the load: `winner_pack_phase`)
    g = torch.Generator(device="cpu").manual_seed(7)
    for n in (n_rows, 1, 33):
        key = torch.randint(0, max(1, n // 64), (n,), generator=g,
                            dtype=torch.int64)
        key[::97] = 0xFFFFFFFF
        skey, sidx = torch.sort(key.to(dev), stable=True)
        sidx = sidx.to(torch.int32)
        _check(torch.equal(winner_pack(skey, sidx, n),
                           winner_pack_plain(skey, sidx, n)),
               f"winner_pack != plain on long runs at n={n}")
        torch.cuda.synchronize()
    return {
        "byte_class": {
            "name": "byte_class", "route": "cuda", "ok": True,
            "source": "delta_tpu_torch/csrc/byte_class.cu",
            "replaces": "delta_tpu/ops/pallas_kernels.py:203",
            "max_abs_err": err1, "ms": k1_ms, "device_ms": k1_dev,
            "plain_ms": k1_plain,
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
            "shape": f"u8[{n1}]"},
    }


def _winner_pack_bytes(skey: torch.Tensor) -> tuple[float, int]:
    """Bytes K2 must move on these sorted keys, and their winner count.
    Every key is read once; a row's index is read only when the row wins,
    so index bytes are the 32-byte sectors (8 sorted rows each) that hold
    a winner; one 4-byte word is written per 32 rows."""
    n = skey.numel()
    winner = torch.ones(-(-n // 8) * 8, dtype=torch.bool, device=skey.device)
    winner[n:] = False
    winner[:n - 1] = skey[:-1] != skey[1:]
    sectors = int(winner.view(-1, 8).any(1).sum())
    return 8.0 * n + 32.0 * sectors + 4.0 * -(-n // 32), int(winner.sum())


def _winner_pack_times(skey: torch.Tensor, sidx: torch.Tensor) -> dict:
    """K2 on one sorted input: checked against its plain version, then
    timed beside it and its bound. `device_ms` is the call's work on the
    card, the kernel and the memset that fills its words;
    `kernel_device_ms` the kernel alone. The bound is the function's own
    bytes: the fill is the design's, and part of its gap to the bound."""
    from delta_tpu_torch.ops.replay import winner_pack, winner_pack_plain

    n = skey.numel()
    got = winner_pack(skey, sidx, n)
    torch.cuda.synchronize()
    want = winner_pack_plain(skey, sidx, n)
    _check(torch.equal(got, want), "winner_pack != plain")
    call = lambda: winner_pack(skey, sidx, n)  # noqa: E731
    nbytes, winners = _winner_pack_bytes(skey)
    bound, by = _bound_ms(nbytes, 2.0 * n)
    return {
        "max_abs_err": int((got.to(torch.int64) - want.to(torch.int64))
                           .abs().max()),
        "ms": _time_ms(call, 50),
        "device_ms": _device_ms(call, 50, ("winner_pack_kernel", "Memset")),
        "kernel_device_ms": _device_ms(call, 50, ("winner_pack_kernel",)),
        "plain_ms": _time_ms(lambda: winner_pack_plain(skey, sidx, n), 10),
        "bound_ms": bound, "bound_by": by, "winners": winners,
        "bound_bytes": nbytes}


def winner_pack_phase(state, seed: int) -> dict:
    """K2 on inputs of the main path's size: (1) the replay key of the
    commit-only load's rows, sorted as the load sorts it (its path codes
    rank the paths' bytes as little-endian 8-byte words, so the
    generator's names, ascending with the file id, sort by the id's last
    digits first and land far from their rows); (2) the same keys with
    their path codes put through a seeded random permutation before the
    sort, the order that a table of random file names gives. Each against
    its plain version, timed beside it and its bound; the row's numbers
    are input 1's, input 2's sit beside."""
    from delta_tpu_torch.ops.replay import chrono_ok, combine_key_lanes

    fa = state.file_actions
    _check(chrono_ok(fa.version, fa.order), "main-path rows are chronological")
    dev = fa.path_code.device
    n_codes = int(fa.path_code.max()) + 1
    g = torch.Generator(device="cpu").manual_seed(seed)
    shuffle = torch.randperm(n_codes, generator=g).to(dev)
    inputs = {}
    for name, codes in (("main_path", fa.path_code),
                        ("random_names", shuffle[fa.path_code])):
        skey, sidx = torch.sort(combine_key_lanes([codes, fa.dv_code]),
                                stable=True)
        inputs[name] = _winner_pack_times(skey, sidx.to(torch.int32))
    n = fa.path_code.numel()
    row = dict(inputs["main_path"])
    row.update({
        "name": "winner_pack", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/winner_pack.cu",
        "replaces": "delta_tpu/ops/replay.py:183", "library_ms": None,
        "shape": f"i64[{n}]+i32[{n}]",
        "random_names": inputs["random_names"]})
    other = row["random_names"]
    other["share"] = other["bound_ms"] / other["ms"]
    other["device_share"] = other["bound_ms"] / other["device_ms"]
    return row


def _edge_plans(real_lane: torch.Tensor, dev):
    """(name, lane, runs, h_total) edge cases of K3's plan space, on
    `dev` (runs None: the real plan's)."""
    from delta_tpu_torch.ops.page_decode import TILE

    g = np.random.default_rng(11)
    lane = g.integers(0, 256, 4096, dtype=np.uint8)
    plans = []
    for w in (0, 1, 31, 32):
        n = 1025
        plans.append((f"w={w}, shift 0", lane,
                      [(0, n, 0, w, 0, 0)], n))
        plans.append((f"w={w}, shift 5", lane,
                      [(0, 900, 5, w, 0, 0)], 900))
    plans.append(("rle with bit 31 set", lane,
                  [(0, 7, 0, 32, 1, -(1 << 31) + 12345),
                   (7, 9, 8 * 100 + 3, 13, 0, 0)], 16))
    plans.append(("h_total=1", lane, [(0, 1, 17, 9, 0, 0)], 1))
    tail_w, tail_n = 17, 64
    plans.append(("bit-packed run in the last 4 bytes", lane,
                  [(0, 10, 0, 3, 0, 0),
                   (10, tail_n, lane.size * 8 - tail_n * tail_w, tail_w,
                    0, 0)], 10 + tail_n))
    plans.append(("runs of 0 values", lane,
                  [(0, 0, 0, 5, 0, 0), (0, 40, 3, 5, 0, 0),
                   (40, 0, 0, 9, 1, 7), (40, 60, 900, 9, 0, 0)], 100))
    plans.append(("a run one longer than TILE, past its count", lane,
                  [(0, 3, 0, 4, 0, 0), (3, TILE + 1, 16, 8, 0, 0)],
                  3 * TILE))
    out = [(name, torch.from_numpy(ln).to(dev),
            torch.tensor(r, dtype=torch.int32, device=dev), h)
           for name, ln, r, h in plans]
    # the same lane at an address that is not 16-byte aligned
    shifted = torch.from_numpy(np.concatenate([[0], lane]).astype(np.uint8))
    out.append(("unaligned lane", shifted.to(dev)[1:], out[1][2], out[1][3]))
    return out + [("real lane, h_total=1025", real_lane, None, 1025)]


def _k3_bound(plan) -> tuple[float, float]:
    """(bytes, operations) K3 must spend on a plan: 4 B written per
    position, the packed lane bytes and the 24-byte run rows read once."""
    from delta_tpu_torch.ops.page_decode import R_N, R_RLE, R_W

    r = plan.runs.astype("int64")
    packed = r[:, R_RLE] == 0
    lane_bytes = int(((r[packed, R_N] * r[packed, R_W] + 7) // 8).sum())
    h = plan.h_total
    return 4.0 * h + lane_bytes + 24.0 * r.shape[0], 16.0 * h


def hybrid_extract_phase(part_paths: list, dev) -> dict:
    """K3 against its plain version on the plan of every part of the
    checkpoint, as the checkpoint-and-tail load plans them, and on edge
    plans; timed per call and on the card alone on the first file-action
    part, and summed over all parts as the load launches it."""
    from delta_tpu_torch.log.page_decode import (
        _VALUE_COLUMNS, build_part_plan)
    from delta_tpu_torch.log.parquet_footer import read_footer
    from delta_tpu_torch.ops.page_decode import (
        hybrid_extract, hybrid_extract_plain, tile_plan)

    calls, err = [], 0
    for path in part_paths:
        with open(path, "rb") as f:
            data = f.read()
        footer = read_footer(data)
        # the main path's plan: with tail commits the keys are not planned
        plan, _, _, _ = build_part_plan(
            footer, data, [c for c in _VALUE_COLUMNS if c in footer.index],
            [])
        lane, runs, tiles, _ = plan.views(
            torch.from_numpy(plan.host).to(dev))
        got = hybrid_extract(lane, runs, plan.h_total, tiles)
        torch.cuda.synchronize()
        want = hybrid_extract_plain(lane, runs, plan.h_total)
        _check(torch.equal(got, want),
               f"hybrid_extract != plain on {os.path.basename(path)}")
        if got.numel():
            err = max(err, int((got.to(torch.int64)
                                - want.to(torch.int64)).abs().max()))
        calls.append((plan, lane, runs, tiles))
    plan, lane, runs, tiles = calls[1 if len(calls) > 1 else 0]
    h = plan.h_total
    for name, ln, r, total in _edge_plans(lane, dev):
        r = runs if r is None else r
        t = torch.from_numpy(tile_plan(r.cpu().numpy(), total)).to(dev)
        _check(torch.equal(hybrid_extract(ln, r, total, t),
                           hybrid_extract_plain(ln, r, total)),
               f"hybrid_extract != plain on the edge plan '{name}'")
        torch.cuda.synchronize()

    def one():
        return hybrid_extract(lane, runs, h, tiles)

    def every_part():
        for p, ln, r, t in calls:
            hybrid_extract(ln, r, p.h_total, t)

    ms = _time_ms(one, 50)
    dev_ms = _device_ms(one, 50, ("hybrid_extract_kernel",))
    plain = _time_ms(lambda: hybrid_extract_plain(lane, runs, h), 10)
    nbytes, ops = _k3_bound(plan)
    bound, by = _bound_ms(nbytes, ops)
    all_ms = _time_ms(every_part, 20)
    all_dev = _device_ms(every_part, 20, ("hybrid_extract_kernel",),
                         per_call=len(calls))
    all_bytes, all_ops = map(sum, zip(*(_k3_bound(c[0]) for c in calls)))
    all_bound, _ = _bound_ms(all_bytes, all_ops)
    return {
        "name": "hybrid_extract", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/hybrid_extract.cu",
        "replaces": "delta_tpu/ops/pallas_kernels.py:357",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        "shape": f"u8[{plan.lane_bytes}]+i32[{plan.n_runs},6]"
                 f"+i32[{plan.n_tiles},2]->u32[{h}]",
        "bound_bytes": nbytes,
        "all_parts": {"parts": len(calls), "ms": all_ms,
                      "device_ms": all_dev, "bound_ms": all_bound,
                      "share": all_bound / all_ms,
                      "device_share": all_bound / all_dev,
                      "positions": sum(c[0].h_total for c in calls)}}


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:  # a file system without hard links
        shutil.copy2(src, dst)


def _replace(path: str, data: bytes) -> None:
    """Write `path` as a new file: never through a hard link, so that the
    original log keeps its bytes."""
    os.remove(path)
    with open(path, "wb") as f:
        f.write(data)


def ladder_phase(path: str, truth, parts: list, Table, TorchEngine, obs,
                 card: str) -> dict:
    """The snapshot's degradation ladder and `.crc` quarantine on the
    card, on a copy of the checkpoint-and-tail log (hard links; a damaged
    file is a new file). Counters from 0 before each load:
    - a torn tip: a commit after the newest, cut inside its add line,
      serves the newest intact version, the generator's truth, through
      the checkpoint (K3 once per part on each of the two attempts);
    - every part of the checkpoint cut to half its bytes: the load
      rebuilds from the JSON commits alone to the truth, K3 never
      launched;
    - a `.crc` of the newest version that lies about the file count and
      size: the load quarantines it and reseeds it from the state."""
    from delta_tpu_torch.log.checksum import (
        read_checksum, write_checksum_from_state)

    copy = path + "_ladder"
    shutil.copytree(path, copy, copy_function=_link_or_copy)
    log = os.path.join(copy, "_delta_log")
    out = {}
    try:
        tip = os.path.join(log, f"{truth.version + 1:020d}.json")
        with open(tip, "wb") as f:
            f.write(b'{"commitInfo":{"timestamp":1,"operation":"WRITE"}}\n'
                    b'{"add":{"path":"part-torn.parquet","partitionVal')
        state, counts, _, load_s, _ = _timed_load(copy, Table, TorchEngine,
                                                  obs)
        _truth_checks(state, truth, "torn tip")
        _check(counts.get("snapshot.torn_commit_fallbacks", 0) == 1
               and counts.get("log.torn_commits", 0) == 1,
               "torn tip: one torn commit, one fallback")
        _check(counts.get("snapshot.checkpoint_fallbacks", 0) == 0,
               "torn tip: no checkpoint fallback")
        _check(counts.get("kernel.hybrid_extract.launches", 0)
               == 2 * len(parts), "torn tip: K3 once per part per attempt")
        _check(counts.get("decode.device_fallbacks", 0) == 0,
               "torn tip: every part decoded on the card")
        out["torn_tip"] = {"load_s": load_s, "counters": counts}
        os.remove(tip)

        # the .crc of the newest version, then made to lie
        crc_path = os.path.join(log, f"{truth.version:020d}.crc")
        write_checksum_from_state(TorchEngine().fs, log, state)
        with open(crc_path) as f:
            doc = json.load(f)
        doc["numFiles"] += 7
        doc["tableSizeBytes"] += 999
        _replace(crc_path, json.dumps(doc).encode())
        del state

        for p in parts:
            cut = os.path.join(log, os.path.basename(p))
            with open(cut, "rb") as f:
                data = f.read()
            _replace(cut, data[:len(data) // 2])
        state, counts, _, load_s, _ = _timed_load(copy, Table, TorchEngine,
                                                  obs)
        _truth_checks(state, truth, "half-length checkpoint")
        _check(counts.get("snapshot.checkpoint_fallbacks", 0) == 1,
               "half-length checkpoint: one checkpoint fallback")
        _check(counts.get("kernel.hybrid_extract.launches", 0) == 0,
               "half-length checkpoint: K3 not launched on the JSON rebuild")
        _check(counts.get("parse.device_windows", 0) >= 1
               and counts.get("parse.device_fallbacks", 0) == 0,
               "half-length checkpoint: the commits parsed on the card")
        _check(counts.get("snapshot.crc_quarantined", 0) == 1,
               "the lying .crc quarantined")
        crc = read_checksum(TorchEngine().fs, log, truth.version)
        _check(crc.numFiles == len(truth.live_paths)
               and crc.tableSizeBytes == truth.size_in_bytes,
               "the lying .crc reseeded from the state")
        out["half_checkpoint"] = {"load_s": load_s, "counters": counts}
        del state
    finally:
        shutil.rmtree(copy, ignore_errors=True)
    out["card"] = card
    return out


SCAN_IN_VALUES = 16


def _fids(paths) -> np.ndarray:
    """The generator's file ids of `part-<fid:010d>-...` paths."""
    return np.array([int(p[5:15]) for p in paths], np.int64)


def _k7_bytes(block, n_rows: int, n_files: int) -> float:
    """K7's bound bytes: per file, 8 B of every distinct value row and
    1 B of every distinct validity row the block's atoms need, and 1 B
    out."""
    nr = n_rows - 1
    rows = set()
    for mn, op in zip(block.rows_mn.tolist(), block.ops.tolist()):
        rows |= {0: {mn, mn + 2, nr}, 1: {mn, mn + 2, nr},
                 2: {mn + 1, mn + 2, nr}, 3: {mn + 1, mn + 2, nr},
                 6: {mn + 2}}.get(op, {mn, mn + 1, mn + 2, nr})
    return float(n_files * (9 * len(rows) + 1))


def _scan_cases(fids: np.ndarray) -> list:
    """Cell 7's five filters over files whose stats put x in
    [(fid+1)*1000, (fid+2)*1000]: (name, predicate, the surviving files
    as a mask over `fids`, from those bounds in numpy)."""
    from delta_tpu_torch.expressions import col, lit

    lo, hi = (fids + 1) * 1000, (fids + 2) * 1000
    top = int(fids.max())
    a = top // 3
    b = a + max(1, top // 100)
    range_lo, range_hi = (a + 1) * 1000 + 500, (b + 1) * 1000 + 500
    or_lo = (top // 200 + 1) * 1000
    or_hi = (top - top // 200 + 1) * 1000
    cut = (top // 2 + 1) * 1000 + 250
    in_vals = np.sort(np.random.default_rng(17).integers(
        1000, (top + 2) * 1000, SCAN_IN_VALUES))
    x = col("x")
    return [
        ("range_1pct", (x >= lit(range_lo)) & (x < lit(range_hi)),
         (hi >= range_lo) & (lo < range_hi)),
        ("or_of_ranges", (x < lit(or_lo)) | (x > lit(or_hi)),
         (lo < or_lo) | (hi > or_hi)),
        ("in_16", x.is_in(*(int(v) for v in in_vals)),
         ((lo[:, None] <= in_vals) & (in_vals <= hi[:, None])).any(1)),
        ("is_null", x.is_null(), np.zeros(len(fids), bool)),
        ("not_range", ~(x < lit(cut)), hi >= cut),
    ]


def scan_phase(path: str, truth, card: str, dev) -> tuple:
    """Scan planning on cell 2's snapshot (the checkpoint-plus-tail log,
    every live file with stats on x in [(fid+1)*1000, (fid+2)*1000]): the
    snapshot loaded on the card, then, counters from 0, five filtered
    scans (a range of 1% of the files, an OR of two ranges, IN with 16
    values, IS NULL, NOT of a range), each surviving set equal to the
    generator's truth computed in numpy from those bounds; the first
    builds the stats index (cold), the rest reuse it; every scan launches
    K7 once. Then K7 against its plain version on the card for each
    predicate's atom block, and K7 timed on the range's block beside its
    plain version and its bound. Returns (metrics line, K7's kernels
    entry)."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.expressions import split_conjuncts
    from delta_tpu_torch.ops.skipping import skip_mask_block, skip_mask_plain
    from delta_tpu_torch.stats.device_index import compile_conjuncts

    fids = _fids(truth.live_paths)
    cases = _scan_cases(fids)
    snap = Table.for_path(path, engine=TorchEngine()).latest_snapshot()
    state = snap.state
    n = state.num_files
    _check(n == len(fids), "scan: the snapshot's live files")
    out = {"card": card, "files": n, "scans": {}}
    torch.cuda.synchronize()
    obs.reset()
    for name, pred, want in cases:
        t0 = time.perf_counter()
        sc = snap.scan(filter=pred)
        paths = sc.file_paths()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check(np.array_equal(np.sort(_fids(paths)), np.sort(fids[want])),
               f"scan {name}: the survivors are the generator's truth")
        _check(sc.skipped_by_stats == n - int(want.sum())
               and sc.partition_pruned == 0,
               f"scan {name}: skipped_by_stats")
        out["scans"][name] = {"s": wall, "survivors": len(paths),
                              "skipped_by_stats": sc.skipped_by_stats}
    counts = obs.counters()
    out["counters"] = {k: v for k, v in counts.items()
                       if k.startswith("scan.") or "skip_mask" in k}
    launches = counts.get("kernel.skip_mask.launches", 0)
    _check(counts.get("scan.device_plans", 0) == len(cases)
           and launches == len(cases)
           and counts.get("scan.stats_index_builds", 0) == 1
           and counts.get("scan.stats_index_reuses", 0) == len(cases) - 1
           and counts.get("scan.device_fallbacks", 0) == 0,
           f"scan: every plan on the card through K7, one index build "
           f"({out['counters']})")
    rs = state.stats_index
    out["stats_index_build_s"] = sum(rs.phase_seconds.values())
    out["stats_index_phase_s"] = dict(rs.phase_seconds)
    out["cold_plan_s"] = out["scans"]["range_1pct"]["s"]
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap.scan(filter=cases[0][1]).file_paths()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    out["plan_s"] = sorted(warm)[1]
    vals, valid = rs.device_lanes()
    out["lane_bytes"] = rs.device_bytes

    # K7 against its plain version on every predicate's block
    for name, pred, _ in cases:
        block, rest = compile_conjuncts(split_conjuncts(pred), rs)
        _check(block is not None and not rest, f"scan {name}: compiled")
        got = skip_mask_block(vals, valid, block, n)
        torch.cuda.synchronize()
        _check(torch.equal(got, skip_mask_plain(vals, valid, block, n)),
               f"skip_mask != plain on the {name} block")
    block, _ = compile_conjuncts(split_conjuncts(cases[0][1]), rs)
    ms = _time_ms(lambda: skip_mask_block(vals, valid, block, n), 50)
    # the lanes (22 MB) fit in the 50 MB L2: a scan after other work finds
    # them in device memory, so the device time is taken with L2 flushed
    # (a 64 MiB fill between calls) and, beside it, warm
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def cold():
        flush.fill_(1)
        return skip_mask_block(vals, valid, block, n)

    dev_ms = _device_ms(cold, 50, ("skip_mask_kernel",))
    dev_ms_warm = _device_ms(lambda: skip_mask_block(vals, valid, block, n),
                             50, ("skip_mask_kernel",))
    del flush
    plain = _time_ms(lambda: skip_mask_plain(vals, valid, block, n), 10)
    nbytes = _k7_bytes(block, vals.shape[0], n)
    bound, by = _bound_ms(nbytes, 8.0 * n * block.n_atoms)
    k7 = {
        "name": "skip_mask", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/skip_mask.cu",
        "replaces": "delta_tpu/ops/skipping.py:88",
        "launches": launches, "max_abs_err": 0, "ms": ms,
        "device_ms": dev_ms, "device_ms_l2_warm": dev_ms_warm,
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        "shape": f"i64[{vals.shape[0]},{n}]+bool[{vals.shape[0]},{n}], "
                 f"{block.n_atoms} atoms in {block.n_groups} groups",
        "bound_bytes": nbytes}
    return out, k7


UPDATE_COMMITS = 10


def append_commits(log: str, state, first: int, seed: int):
    """Append `UPDATE_COMMITS` commits of the generator's shape after the
    loaded `state` (100 files each: 20 removes of live files, 80 adds with
    stats): commit 5 re-adds a path commit 2 removed, commit 3 adds a path
    that needs percent-decoding, commit 7 removes it by its decoded
    spelling. Returns (the decoded paths added, those removed) as sets."""
    rng = np.random.default_rng(seed)
    live = torch.nonzero(state.live_mask).squeeze(1).cpu().numpy()
    pick = np.sort(rng.choice(live, 20 * UPDATE_COMMITS, replace=False))
    gone = state.file_actions.rows.paths(pick)
    rng.shuffle(gone)
    added, removed = set(), set()
    for k in range(UPDATE_COMMITS):
        v = first + k
        rms = list(gone[20 * k:20 * (k + 1)])
        adds = [f"part-u{v:010d}-{j:03d}-{int(u):016x}.parquet"
                for j, u in enumerate(rng.integers(0, 1 << 60, 80))]
        if k == 3:
            adds[0] = f"part-u{v:010d}-pct%20name.parquet"
        if k == 5:
            adds[1] = gone[20 * 2]  # re-added after commit 2 removed it
        if k == 7:
            rms[0] = f"part-u{first + 3:010d}-pct name.parquet"
        lines = [f'{{"remove":{{"path":"{p}","deletionTimestamp":{v},'
                 f'"dataChange":true}}}}' for p in rms]
        for j, p in enumerate(adds):
            lo, hi = (j + 1) * 1000, (j + 2) * 1000
            lines.append(
                f'{{"add":{{"path":"{p}","partitionValues":{{}},'
                f'"size":1048576,"modificationTime":{v},"dataChange":true,'
                f'"stats":"{{\\"numRecords\\":1000,'
                f'\\"minValues\\":{{\\"x\\":{lo}}},'
                f'\\"maxValues\\":{{\\"x\\":{hi}}},'
                f'\\"nullCount\\":{{\\"x\\":0}}}}"}}}}')
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(lines) + "\n")
        for p in rms:
            added.discard(p.replace("%20", " "))
            removed.add(p.replace("%20", " "))
        for p in adds:
            removed.discard(p.replace("%20", " "))
            added.add(p.replace("%20", " "))
    return added, removed


def _same_lanes(a, b, what: str) -> None:
    """Two states of one segment bit for bit on the card: lanes and masks
    equal, the two numberings of the replay key a bijection."""
    fa, fb = a.file_actions, b.file_actions
    for lane in ("is_add", "version", "order", "size"):
        _check(torch.equal(getattr(fa, lane), getattr(fb, lane)),
               f"{what}: the {lane} lanes equal")
    _check(torch.equal(a.live_mask, b.live_mask)
           and torch.equal(a.tombstone_mask, b.tombstone_mask),
           f"{what}: live and tombstone masks equal")
    ka = torch.stack([fa.path_code, fa.dv_code])
    kb = torch.stack([fb.path_code, fb.dv_code])
    n_pairs = torch.unique(torch.cat([ka, kb]), dim=1).shape[1]
    _check(n_pairs == torch.unique(ka, dim=1).shape[1]
           == torch.unique(kb, dim=1).shape[1],
           f"{what}: the replay keys' codes a bijection")


def _live_sha(state) -> str:
    idx = torch.nonzero(state.live_mask).squeeze(1).cpu().numpy()
    paths = sorted(state.file_actions.rows.paths(idx))
    return hashlib.sha256("\n".join(paths).encode()).hexdigest()


def update_phase(path: str, truth, card: str, seed: int) -> dict:
    """The snapshot's life after the load, on a hard-linked copy of the
    checkpoint-and-tail log: a cold load on the card, then
    `UPDATE_COMMITS` new commits (`append_commits`) and, counters from 0,
    `Table.update()`, which must list once, read only the new commits,
    launch K1 and K2 and not K3, replay nothing in full, and equal a cold
    `snapshot_at` of the new head bit for bit and the expected live set;
    then a no-change poll (one LIST, no read), `metadata` on a fresh
    Table (the small read, then from a `.crc`; no part decoded), and an
    append through `write_table`'s own steps on the Table that holds the
    advanced snapshot, whose commit advances it and whose checkpoint hook
    writes from it (no full replay), then a `write_table` on a fresh
    Table. Before the new commits a filtered scan builds the prior
    version's stats index; the advance releases it, and the advanced
    snapshot's first scan rebuilds it (one build, one K7 launch) and
    equals the cold snapshot's scan."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.log.checksum import write_checksum_from_state
    from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint
    from delta_tpu_torch.models.batch import Batch, as_column
    from delta_tpu_torch.models.schema import schema_from_json
    from delta_tpu_torch.utils import filenames
    from delta_tpu_torch.write.writer import write_data_files

    copy = path + "_update"
    shutil.copytree(path, copy, copy_function=_link_or_copy)
    log = os.path.join(copy, "_delta_log")
    out = {"card": card, "new_commits": UPDATE_COMMITS}

    def timed(fn):
        torch.cuda.synchronize()
        obs.reset()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, obs.counters()

    pred = col("x") < lit(40_500)
    held = {}

    def load(key, fn):
        held[key] = fn()
        return held[key].state

    try:
        table = Table.for_path(copy, engine=TorchEngine())
        prior, out["cold_load_s"], counts = timed(
            lambda: load("prior", table.latest_snapshot))
        _truth_checks(prior, truth, "update: the cold load")
        _ladder_idle(counts, "update: the cold load")
        # a scan of the prior version builds its stats index
        held["prior"].scan(filter=pred).file_paths()
        _check(prior.stats_index is not None,
               "update: the prior version's stats index")
        head = truth.version + UPDATE_COMMITS
        added, removed = append_commits(log, prior, truth.version + 1,
                                        seed)
        want = (set(truth.live_paths) - removed) | added
        want_sha = hashlib.sha256(
            "\n".join(sorted(want)).encode()).hexdigest()

        def advance():
            snap = table.update()
            snap.state
            return snap

        snap, out["update_s"], counts = timed(advance)
        out["update_counters"] = counts
        adv = snap.state
        out["update_phase_s"] = adv.phase_seconds
        _check(snap.version == head, "update: advanced to the new head")
        _check(counts.get("replay.advances", 0) == 1
               and counts.get("replay.reconstructs", 0) == 0,
               "update: one advance, no full replay")
        _check(counts.get("log.commit_reads", 0) == UPDATE_COMMITS,
               "update: read the new commits alone")
        _check(counts.get("kernel.byte_class.launches", 0) >= 1
               and counts.get("kernel.winner_pack.launches", 0) >= 1,
               "update: K1 parsed and K2 replayed the new commits")
        _check(counts.get("kernel.hybrid_extract.launches", 0) == 0
               and counts.get("decode.device_parts", 0) == 0,
               "update: K3 not launched, no part decoded")
        _check(adv.num_files == len(want)
               and adv.size_in_bytes == 1048576 * len(want)
               and _live_sha(adv) == want_sha,
               "update: the advanced state's live files as appended")

        cold, out["cold_head_load_s"], counts = timed(
            lambda: load("cold", lambda: Table.for_path(
                copy, engine=TorchEngine()).snapshot_at(head)))
        out["cold_head_counters"] = counts
        _same_lanes(adv, cold, "update: advanced vs cold snapshot_at")
        # the advance released the prior lanes; the advanced snapshot's
        # first scan rebuilds them and equals a cold snapshot's scan
        _check(prior.stats_index is None,
               "update: the advance released the prior stats index")
        got, out["scan_after_update_s"], counts = timed(
            lambda: sorted(snap.scan(filter=pred).file_paths()))
        out["scan_after_update_counters"] = {
            k: v for k, v in counts.items()
            if k.startswith("scan.") or "skip_mask" in k}
        _check(counts.get("scan.stats_index_builds", 0) == 1
               and counts.get("scan.stats_index_reuses", 0) == 0
               and counts.get("kernel.skip_mask.launches", 0) == 1,
               "update: the advanced snapshot's scan rebuilt its index")
        _check(got == sorted(held["cold"].scan(filter=pred).file_paths()),
               "update: the advanced scan equals the cold scan")
        out["scan_after_update_survivors"] = len(got)
        del cold
        held.pop("cold")

        same, out["poll_s"], counts = timed(table.update)
        out["poll_counters"] = counts
        _check(same is snap and counts.get("storage.list_calls", 0) == 1
               and counts.get("storage.read_calls", 0) == 0
               and counts.get("log.commit_reads", 0) == 0,
               "update: a no-change poll lists once and reads nothing")

        meta, out["metadata_small_s"], counts = timed(
            lambda: Table.for_path(copy, engine=TorchEngine())
            .latest_snapshot().metadata)
        out["metadata_small_counters"] = counts
        _check(meta.id == "bench" and counts.get("replay.small_loads") == 1
               and counts.get("replay.reconstructs", 0) == 0
               and counts.get("decode.device_parts", 0) == 0
               and counts.get("kernel.hybrid_extract.launches", 0) == 0,
               "update: metadata by the small read, no part decoded")
        write_checksum_from_state(TorchEngine().fs, log, adv)
        meta, out["metadata_crc_s"], counts = timed(
            lambda: Table.for_path(copy, engine=TorchEngine())
            .latest_snapshot().metadata)
        out["metadata_crc_counters"] = counts
        _check(meta.id == "bench" and counts.get("snapshot.pm_from_crc") == 1
               and counts.get("replay.small_loads", 0) == 0
               and counts.get("replay.reconstructs", 0) == 0
               and counts.get("log.commit_reads", 0) == 0,
               "update: metadata from the .crc alone")

        def append_on_table():
            txn = table.create_transaction_builder().build()
            meta = txn.metadata()
            txn.add_files(write_data_files(
                table.engine, table.path,
                Batch({"x": as_column(np.arange(1000))}),
                schema_from_json(meta.schemaString), [],
                meta.configuration))
            return txn.commit().version

        v, out["append_cached_s"], counts = timed(append_on_table)
        out["append_cached_counters"] = counts
        _check(v == head + 1 and v % 10 == 0, "update: the append's version")
        _check(counts.get("table.notify_advances") == 1
               and counts.get("replay.reconstructs", 0) == 0
               and counts.get("log.commit_reads", 0) == 0
               and counts.get("kernel.hybrid_extract.launches", 0) == 0,
               "update: the append advanced the cache, the hooks replayed "
               "nothing in full")
        _check(read_last_checkpoint(TorchEngine().fs, log).version == v
               and not any(n for k, n in counts.items()
                           if k.startswith("hooks.")),
               "update: the checkpoint hook wrote from the advanced state")
        v2, out["write_table_s"], counts = timed(lambda: write_table(
            copy, {"x": np.arange(1000)}, engine=TorchEngine()))
        out["write_table_counters"] = counts
        _check(v2 == v + 1 and counts.get("replay.reconstructs", 0) == 0
               and counts.get("snapshot.pm_from_crc", 0) == 1,
               "update: write_table read its metadata from the .crc")
        final, out["reload_s"], counts = timed(
            lambda: Table.for_path(copy, engine=TorchEngine())
            .latest_snapshot().state)
        _check(final.file_actions.version.min() == v,
               "update: the reload reads the hook's checkpoint")
        _check(counts.get("kernel.hybrid_extract.launches", 0)
               == counts.get("decode.device_parts", -1) >= 1,
               "update: the reload decodes each part of it with K3")
        new_paths = set()
        for ver in (v, v2):
            with open(filenames.delta_file(log, ver)) as fh:
                new_paths |= {json.loads(ln)["add"]["path"] for ln in fh
                              if ln.startswith('{"add"')}
        _check(final.num_files == len(want) + 2
               and _live_sha(final) == hashlib.sha256("\n".join(
                   sorted(want | new_paths)).encode()).hexdigest(),
               "update: the hook's checkpoint holds the advanced state")
    finally:
        shutil.rmtree(copy, ignore_errors=True)
    return out


def _set_aside(log: str, side: str) -> list:
    """Move the checkpoint files of `log` into `side`; returns their
    names (for `_put_back`)."""
    os.makedirs(side, exist_ok=True)
    names = [n for n in os.listdir(log)
             if ".checkpoint." in n or n == "_last_checkpoint"]
    for n in names:
        os.replace(os.path.join(log, n), os.path.join(side, n))
    return names


def _put_back(log: str, side: str, names: list) -> None:
    for n in names:
        os.replace(os.path.join(side, n), os.path.join(log, n))


def _truth_checks(state, truth, what: str) -> str:
    live_paths = sorted(a.path for a in state.add_files)
    sha = hashlib.sha256("\n".join(live_paths).encode()).hexdigest()
    want_sha = hashlib.sha256("\n".join(truth.live_paths).encode()).hexdigest()
    _check(state.version == truth.version, f"{what}: version")
    _check(state.num_files == len(truth.live_paths), f"{what}: num_files")
    _check(state.size_in_bytes == truth.size_in_bytes,
           f"{what}: size_in_bytes")
    _check(sha == want_sha, f"{what}: sha256 of the sorted live paths")
    _check(int(state.tombstone_mask.sum()) == truth.num_tombstones,
           f"{what}: tombstone count")
    return sha


_LADDER_COUNTERS = ("snapshot.torn_commit_fallbacks",
                    "snapshot.checkpoint_fallbacks",
                    "snapshot.crc_quarantined")


def _ladder_idle(counts: dict, what: str) -> None:
    """A main-path load took no fallback: no torn tip served around, no
    checkpoint rebuilt past, no `.crc` reseeded."""
    _check(not any(counts.get(k, 0) for k in _LADDER_COUNTERS),
           f"{what}: the degradation ladder stayed idle "
           f"{ {k: counts.get(k, 0) for k in _LADDER_COUNTERS} }")


def _timed_load(path: str, Table, TorchEngine, obs, **engine_kw):
    """One load with every counter at 0 just before; returns (state,
    counters, list seconds, load seconds, peak device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    t0 = time.perf_counter()
    snap = Table.for_path(path, engine=TorchEngine(**engine_kw)) \
        .latest_snapshot()
    t_list = time.perf_counter()
    state = snap.state
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    return (state, obs.counters(), t_list - t0, t_end - t0,
            torch.cuda.max_memory_allocated())


def _device_rows(prof) -> list:
    """(device microseconds, name, count) of every device-side row of a
    torch.profiler trace (kernels, copies, memsets), largest first; an
    operator's row is left out, since it repeats the time of the kernels
    it launched."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us:
            rows.append((us, e.key, e.count))
    return sorted(rows, reverse=True)


def _device_time(prof):
    """(device busy seconds, the 15 largest device rows as dicts) of a
    torch.profiler trace."""
    rows = _device_rows(prof)
    return (sum(r[0] for r in rows) / 1e6,
            [{"name": k[:90], "calls": c, "device_ms": us / 1e3}
             for us, k, c in rows[:15]])


def profile_decode(parts: list) -> None:
    """The checkpoint read of cell 2, part by part as the load reads it
    (the device decode of the hot columns, the host leaf reader for the
    rest), warm, under torch.profiler: the device split of the decode
    phase into K3, the torch ops of `ops/page_decode.py::decode_part` and
    the copies each way, beside the wall seconds of its phases."""
    from torch.profiler import ProfilerActivity, profile

    from delta_tpu_torch.log.page_decode import read_checkpoint_part
    from delta_tpu_torch.replay.columnar import _wanted_leaf

    dev = torch.device("cuda", 0)
    datas = []
    for p in parts:
        with open(p, "rb") as f:
            datas.append(f.read())
    read_checkpoint_part(datas[-1], dev, _wanted_leaf, want_keys=False)
    torch.cuda.synchronize()
    phases: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for data in datas:
            read_checkpoint_part(data, dev, _wanted_leaf, want_keys=False,
                                 phases=phases)
        torch.cuda.synchronize()
    split = {"k3": 0.0, "h2d": 0.0, "d2h": 0.0, "torch_ops": 0.0}
    for us, name, _ in _device_rows(prof):
        key = ("k3" if "hybrid_extract" in name else
               "h2d" if "HtoD" in name else
               "d2h" if "DtoH" in name else "torch_ops")
        split[key] += us / 1e3
    busy_s, top = _device_time(prof)
    print("profile decode: " + json.dumps({
        "parts": len(parts), "phase_s": phases, "device_ms": split,
        "device_busy_s": busy_s, "top_device": top}), flush=True)


def profile_load(path: str, Table, TorchEngine) -> None:
    """Two more loads of the same log, warm: one timed plainly, one under
    torch.profiler for device time by kernel and the device's busy share
    of the load's wall time."""
    from torch.profiler import ProfilerActivity, profile

    def load():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = Table.for_path(path, engine=TorchEngine()).latest_snapshot().state
        torch.cuda.synchronize()
        return time.perf_counter() - t0, st.phase_seconds

    warm_s, warm_phases = load()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_s, _ = load()
    busy_s, top = _device_time(prof)
    print("profile: " + json.dumps({
        "warm_load_s": warm_s, "warm_phase_s": warm_phases,
        "traced_load_s": traced_s, "device_busy_s": busy_s,
        "device_busy_share": busy_s / traced_s,
        "top": top}), flush=True)


ZORDER_COLS = ("k1", "k2", "k3")
OPTIMIZE_APPENDS = 20       # BASELINE config 4: 20 appends
OPTIMIZE_CELL_APPENDS = 10  # cell 4's OPTIMIZE: the first 10 (5M rows; a
                            # cut, for the run's time)
CONFIG4_ROWS = 10_000_000   # of 500,000 rows each
OPTIMIZE_MAX_FILE = 256 << 20  # the default max_file_size
READ_K1 = 1 << 28           # the row read's filter over the cell's table:
READ_K2 = 1 << 29           # k1 < 2^28 and k2 >= 2^29


def config4_appends(seed: int) -> list:
    """The OPTIMIZE cell's appends as `OptimizeBenchmark` makes them
    (`benchmarks/workloads.py:171-182`): 20 appends of k1, k2, k3 int64
    uniform in [0, 2^30) and payload float64 normal, one seeded
    generator."""
    rng = np.random.default_rng(seed)
    per = CONFIG4_ROWS // OPTIMIZE_APPENDS
    out = []
    for _ in range(OPTIMIZE_APPENDS):
        out.append({
            "k1": rng.integers(0, 1 << 30, per).astype(np.int64),
            "k2": rng.integers(0, 1 << 30, per).astype(np.int64),
            "k3": rng.integers(0, 1 << 30, per).astype(np.int64),
            "payload": rng.normal(size=per),
        })
    return out


def rank_matrix(cols, dev) -> torch.Tensor:
    """K4's input on the Z-order path for these columns: the scaled
    ranks, int32 bit patterns [k, n] on `dev`."""
    from delta_tpu_torch.ops import zorder as tz
    from delta_tpu_torch.ops.u32 import to_i32_bits

    stacked = np.stack([tz.to_sortable_u32(c) for c in cols])
    on_dev = torch.from_numpy(stacked.view(np.int32)).to(dev)
    return to_i32_bits(tz.scaled_ranks(on_dev, tz.pad_bucket(len(cols[0]))))


def interleave_phase(ranks: torch.Tensor, dev) -> dict:
    """K4 against its plain version on the cell's rank matrix and on edge
    shapes; timed on the rank matrix."""
    from delta_tpu_torch.ops.interleave import (
        interleave_bits, interleave_bits_plain, n_words)

    got = interleave_bits(ranks, 32)
    torch.cuda.synchronize()
    want = interleave_bits_plain(ranks, 32)
    _check(torch.equal(got, want), "interleave_bits != plain on the ranks")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    del got, want
    g = np.random.default_rng(13)
    shapes = [(k, b, n) for n in (1, 31, 33, 1023, 1025)
              for k in (1, 2, 3, 4, 5) for b in (16, 32)]
    for k, b, n in shapes + [(7, 5, 1025), (32, 32, 1025)]:
        x = g.integers(0, 2**32, (k, n), dtype=np.uint32)
        x[:, ::3] |= np.uint32(0x80000000)  # bit 31 set
        x[:, 1::5] = 0xFFFFFFFF             # all-ones rows
        t = torch.from_numpy(x.view(np.int32)).to(dev)
        _check(torch.equal(interleave_bits(t, b), interleave_bits_plain(t, b)),
               f"interleave_bits != plain at k={k} n_bits={b} n={n}")
        torch.cuda.synchronize()
    k, n = ranks.shape
    ms = _time_ms(lambda: interleave_bits(ranks, 32), 50)
    dev_ms = _device_ms(lambda: interleave_bits(ranks, 32), 50,
                        ("interleave_fixed", "interleave_generic"))
    plain = _time_ms(lambda: interleave_bits_plain(ranks, 32), 3)
    w = n_words(k, 32)
    nbytes = 4.0 * (k + w) * n
    bound, by = _bound_ms(nbytes, 4.0 * k * 32 * n)
    return {
        "name": "interleave_bits", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/interleave_bits.cu",
        "replaces": "delta_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": f"u32[{k},{n}]->u32[{w},{n}]", "bound_bytes": nbytes}


def _row_hash(k1, k2, k3, payload):
    """A 64-bit mix of each row's (k1, k2, k3, payload bits)."""
    with np.errstate(over="ignore"):
        h = k1.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        h ^= k2.view(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
        h ^= k3.view(np.uint64) * np.uint64(0x165667B19E3779F9)
        h ^= payload.view(np.uint64) * np.uint64(0xD6E8FEB86659FD93)
        h ^= h >> np.uint64(31)
        h *= np.uint64(0xBF58476D1CE4E5B9)
    return h


def check_optimized_rows(inp: dict, out, dev) -> None:
    """The rows read back are the input rows (an order-free digest, then
    a row-by-row match), and in non-decreasing curve-key order under the
    keys the plain versions compute from the input in its order."""
    from delta_tpu_torch.ops.interleave import interleave_bits_plain
    from delta_tpu_torch.ops.u32 import widen_u32

    n = len(inp["k1"])
    _check(out.num_rows == n, "optimize: row count")
    cols = ("k1", "k2", "k3", "payload")
    h_in = _row_hash(*(inp[c] for c in cols))
    h_out = _row_hash(*(out.column(c).values for c in cols))
    _check(int(h_in.sum(dtype=np.uint64)) == int(h_out.sum(dtype=np.uint64))
           and int(np.bitwise_xor.reduce(h_in))
           == int(np.bitwise_xor.reduce(h_out)),
           "optimize: order-free digest of the rows")
    order = np.argsort(h_in, kind="stable")
    pos = np.minimum(np.searchsorted(h_in[order], h_out), n - 1)
    perm = order[pos]  # input row of each output row
    for c in cols:
        a, b = inp[c][perm], out.column(c).values
        _check(np.array_equal(a.view(np.int64), b.view(np.int64)),
               f"optimize: output rows match input rows ({c})")
    _check(np.unique(perm).size == n, "optimize: every input row once")
    keys = interleave_bits_plain(
        rank_matrix([inp[c] for c in ZORDER_COLS], dev), 32)
    w = widen_u32(keys[:, torch.from_numpy(perm).to(dev)])
    del keys
    ok = torch.ones(n - 1, dtype=torch.bool, device=dev)
    undecided = torch.ones_like(ok)
    for i in range(w.shape[0]):
        a, b = w[i, :-1], w[i, 1:]
        ok &= ~(undecided & (a > b))
        undecided &= a == b
    _check(bool(ok.all()), "optimize: curve keys non-decreasing")


def optimize_phase(work: str, appends: list, card: str, dev) -> dict:
    """The OPTIMIZE cell on the card, counters from 0; returns its
    metrics line (K4's launches under `launches`)."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.log.checksum import (
        read_checksum, validate_state_against_checksum)
    from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint
    from delta_tpu_torch.log.parquet_data import read_data_file_path
    from delta_tpu_torch.models.actions import (
        AddFile, actions_from_commit_bytes)
    from delta_tpu_torch.models.batch import Batch
    from delta_tpu_torch.ops.zorder import zorder_sort_indices
    from delta_tpu_torch.utils import filenames

    path = os.path.join(work, "optimize")
    log = os.path.join(path, "_delta_log")
    obs.reset()
    t0 = time.perf_counter()
    for cols in appends:
        write_table(path, cols, engine=TorchEngine())
    write_s = time.perf_counter() - t0
    _check(not any(v for k, v in obs.counters().items()
                   if k.startswith("hooks.")),
           "optimize: no hook failed on the appends")
    # the checkpoint hook fires at each tenth version (the appends are
    # versions 0 .. len - 1)
    last_cp = read_last_checkpoint(TorchEngine().fs, log)
    if len(appends) > 10:
        _check(os.path.exists(filenames.checkpoint_file_singular(log, 10))
               and last_cp.version == 10,
               "optimize: the hook checkpointed version 10")
    else:
        _check(last_cp is None, "optimize: no checkpoint before version 10")
    before = Table.for_path(path, engine=TorchEngine()).latest_snapshot()
    _check(before.state.num_files == len(appends), "optimize: input files")
    _ladder_idle(obs.counters(), "optimize: the appends and their reload")
    bytes_in = before.state.size_in_bytes
    n_rows = sum(len(c["k1"]) for c in appends)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    t0 = time.perf_counter()
    m = Table.for_path(path, engine=TorchEngine()).optimize() \
        .execute_zorder_by(*ZORDER_COLS)
    torch.cuda.synchronize()
    command_s = time.perf_counter() - t0
    counts = obs.counters()
    peak = torch.cuda.max_memory_allocated()
    k4 = counts.get("kernel.interleave_bits.launches", 0)
    _check(k4 >= 1, "interleave_bits launched on the OPTIMIZE path")

    after = Table.for_path(path, engine=TorchEngine()).latest_snapshot().state
    _ladder_idle(obs.counters(), "optimize: the command and its reload")
    n_out = max(1, -(-bytes_in // OPTIMIZE_MAX_FILE))
    _check(after.version == len(appends) == m.version,
           "optimize: committed the next version")
    tombs = after.tombstones
    _check(len(tombs) == len(appends)
           and not any(t.dataChange for t in tombs),
           "optimize: one dataChange=false tombstone per input file")
    adds = after.add_files
    _check(len(adds) == n_out == m.num_files_added,
           f"optimize: {n_out} output files")
    # the hooks: a checkpoint at each tenth version, the OPTIMIZE
    # commit's among them (the snapshot now loads from it), a .crc per
    # version, the OPTIMIZE commit's validating
    _check(after.file_actions.version.min() == m.version
           and read_last_checkpoint(TorchEngine().fs, log).version
           == m.version, "optimize: the hook checkpointed the OPTIMIZE "
           "commit")
    _check(all(read_checksum(TorchEngine().fs, log, v) is not None
               for v in range(m.version + 1)), "optimize: a .crc per version")
    validate_state_against_checksum(
        after, read_checksum(TorchEngine().fs, log, m.version))
    hook_failures = {k: v for k, v in counts.items()
                     if k.startswith("hooks.")}
    _check(not any(hook_failures.values()),
           "optimize: no hook failed on the OPTIMIZE commit")
    # the reference's checkpoint has no add.tags column (ROADMAP C1): the
    # ZCube tags are checked on the OPTIMIZE commit's own add actions
    with open(filenames.delta_file(log, m.version), "rb") as fh:
        committed = [a for a in actions_from_commit_bytes(fh.read())
                     if isinstance(a, AddFile)]
    cubes = {(a.tags or {}).get("ZCUBE_ID") for a in committed}
    _check(len(committed) == n_out and len(cubes) == 1 and None not in cubes,
           "optimize: every output file carries the command's ZCube tags")
    t0 = time.perf_counter()
    out = Batch.concat([read_data_file_path(os.path.join(path, a.path))
                        for a in adds])
    read_back_s = time.perf_counter() - t0
    inp = {c: np.concatenate([a[c] for a in appends])
           for c in ("k1", "k2", "k3", "payload")}
    check_optimized_rows(inp, out, dev)
    del out

    # the row read over the optimized table, counters from 0: the filter
    # applied in numpy to the appends is the truth, compared as a
    # multiset of row hashes
    from delta_tpu_torch.api import read_table
    from delta_tpu_torch.expressions import col, lit

    torch.cuda.synchronize()
    obs.reset()
    t0 = time.perf_counter()
    got = read_table(path, filter=(col("k1") < lit(READ_K1))
                     & (col("k2") >= lit(READ_K2)),
                     columns=["k1", "payload"], engine=TorchEngine())
    read_s = time.perf_counter() - t0
    read_counts = obs.counters()
    sel = (inp["k1"] < READ_K1) & (inp["k2"] >= READ_K2)
    zero = np.zeros(int(sel.sum()), np.int64)
    _check(got.column_names == ["k1", "payload"]
           and got.num_rows == int(sel.sum()),
           "read_table: the projection and the row count")
    _check(np.array_equal(
        np.sort(_row_hash(inp["k1"][sel], zero, zero, inp["payload"][sel])),
        np.sort(_row_hash(np.ascontiguousarray(got.column("k1").values),
                          zero, zero,
                          np.ascontiguousarray(got.column("payload").values)))),
        "read_table: the rows are the numpy filter's, as a multiset")
    _check(read_counts.get("kernel.skip_mask.launches", 0) == 1
           and read_counts.get("scan.device_plans", 0) == 1,
           "read_table: the scan planned on the card through K7")
    del got
    sc = Table.for_path(path, engine=TorchEngine()).latest_snapshot().scan(
        filter=(col("k1") < lit(READ_K1)) & (col("k2") >= lit(READ_K2)))
    read_files = {"read": len(sc.file_paths()),
                  "skipped_by_stats": sc.skipped_by_stats}

    # the curve key alone (config 4's second metric), warm
    cols = [inp[c] for c in ZORDER_COLS]
    zorder_sort_indices(cols, device=dev)
    curve_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zorder_sort_indices(cols, device=dev)
        curve_s.append(time.perf_counter() - t0)
    curve_s.sort()
    return {
        "rows": n_rows, "appends": len(appends), "input_bytes": bytes_in,
        "output_files": len(adds),
        "output_bytes": sum(a.size for a in adds),
        "write_appends_s": write_s, "command_s": command_s,
        "command_rows_per_s": n_rows / command_s,
        "phase_s": m.phase_seconds,
        "curve_key_s": curve_s, "curve_key_rows_per_s": n_rows / curve_s[1],
        "read_back_s": read_back_s, "peak_device_bytes": peak,
        "read_table_s": read_s, "read_table_rows_out": int(sel.sum()),
        "read_table_files": read_files,
        "read_table_rows_per_s": n_rows / read_s,
        "read_table_counters": {k: v for k, v in read_counts.items()
                                if k.startswith("scan.")
                                or "skip_mask" in k},
        "counters": counts, "launches": k4, "hook_failures": hook_failures,
        "card": card}


def profile_optimize(path: str) -> None:
    """OPTIMIZE ZORDER BY once more on the cell's table (now its two
    output files), under torch.profiler: device time by kernel and the
    device's busy share of the command's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from delta_tpu_torch import Table, TorchEngine

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = Table.for_path(path, engine=TorchEngine()).optimize() \
            .execute_zorder_by(*ZORDER_COLS)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    busy_s, top = _device_time(prof)
    print("profile optimize: " + json.dumps({
        "traced_command_s": traced_s, "phase_s": m.phase_seconds,
        "device_busy_s": busy_s, "device_busy_share": busy_s / traced_s,
        "top": top}), flush=True)


def profile_checkpoint_write(path: str, version: int) -> None:
    """The checkpoint write once more, of the snapshot one version before
    the head, under torch.profiler: device time by kernel and the
    device's busy share of the write's wall time; its files are removed
    afterwards."""
    from torch.profiler import ProfilerActivity, profile
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.config import settings
    from delta_tpu_torch.log.checkpointer import (
        CheckpointMetrics, write_checkpoint)
    from delta_tpu_torch.utils import filenames

    eng = TorchEngine()
    snap = Table.for_path(path, engine=eng).snapshot_at(version)
    log = os.path.join(path, "_delta_log")
    hint_path = filenames.last_checkpoint_file(log)
    with open(hint_path, "rb") as fh:
        old_hint = fh.read()
    settings.checkpoint_part_size = max(1, snap.state.num_files // 8)
    m = CheckpointMetrics()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            write_checkpoint(eng, snap, metrics=m)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
    finally:
        settings.checkpoint_part_size = None
    for p in filenames.checkpoint_file_with_parts(log, version, m.parts):
        os.remove(p)
    with open(hint_path, "wb") as fh:
        fh.write(old_hint)
    busy_s, top = _device_time(prof)
    print("profile checkpoint write: " + json.dumps({
        "traced_write_s": traced_s, "phase_s": m.phase_seconds,
        "device_busy_s": busy_s, "device_busy_share": busy_s / traced_s,
        "top": top}), flush=True)


def optimize_card_vs_cpu(work: str) -> None:
    """A 20,000-row table optimized along both curves on the card and on
    the CPU: the same output rows in the same order, the same stats."""
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.log.parquet_data import read_data_file_path
    from delta_tpu_torch.models.batch import Batch

    src = os.path.join(work, "optimize_small")
    rng = np.random.default_rng(21)
    for _ in range(4):
        write_table(src, {"k1": rng.integers(0, 1 << 30, 5000),
                          "k2": rng.integers(0, 1 << 10, 5000),  # ties
                          "k3": rng.integers(0, 1 << 30, 5000),
                          "payload": rng.normal(size=5000)},
                    engine=TorchEngine("cpu"))
    for curve in ("zorder", "hilbert"):
        results = []
        for device in ("cuda", "cpu"):
            p = os.path.join(work, f"optimize_small_{curve}_{device}")
            shutil.copytree(src, p)
            Table.for_path(p, engine=TorchEngine(device)).optimize() \
                .execute_zorder_by(*ZORDER_COLS, curve=curve)
            st = Table.for_path(p, engine=TorchEngine("cpu")) \
                .latest_snapshot().state
            rows = Batch.concat([read_data_file_path(os.path.join(p, a.path))
                                 for a in st.add_files])
            results.append((rows, [a.stats for a in st.add_files]))
        (card_rows, card_stats), (cpu_rows, cpu_stats) = results
        _check(card_stats == cpu_stats, f"{curve}: card stats == CPU stats")
        for c in ("k1", "k2", "k3", "payload"):
            _check(np.array_equal(card_rows.column(c).values.view(np.int64),
                                  cpu_rows.column(c).values.view(np.int64)),
                   f"{curve}: card rows == CPU rows ({c})")


DML_SPARSE_K1 = 1 << 22     # DELETE k1 < 2^22: ~0.4% of the rows, arrays
DML_DENSE_PAYLOAD = 1.2816  # DELETE payload > 1.2816: ~10%, bitmaps
DML_READ_K2 = 1 << 29       # the first read's filter: k2 >= 2^29
DML_APPENDS = 10            # cell 10's table: the first 10 of the OPTIMIZE
                            # cell's appends, 5M rows (a cut, for the time)
DML_UPDATE_FILES = (2, 5, 8)  # appends whose one k1 the UPDATE sets
DML_OPTIMIZE_MAX_FILE = 1 << 30  # Delta's default maxFileSize for OPTIMIZE:
                                 # one bin takes every file (at 256 MiB the
                                 # largest file may sit alone in a bin, which
                                 # is not rewritten, and keep its DV)
DML_K8 = ("kernel.dv_bits.pack_launches", "kernel.dv_bits.decode_launches")
DML_DV_HOST = ("plan", "upload", "launch", "d2h", "split")
# per step on the card: (K8 pack launches, K8 decode launches, parse
# fallbacks). K8 decodes every DV a command reads in one launch (a read,
# a DML command's candidates, OPTIMIZE's one bin) and packs every bitmap
# container of a command's DV file in one; K1 hands every commit window
# that holds a line with a DV to the host parse (one fallback): the
# commit handoff of each command, and every load with such a commit past
# its checkpoint (the hook checkpoints version 20, the sparse DELETE)
DML_EXPECT = {"delete_sparse": (0, 0, 1), "read_filtered": (0, 1, 0),
              "delete_dense": (1, 1, 1), "read": (0, 1, 1),
              "update": (0, 1, 1), "optimize": (0, 1, 1),
              "reload": (0, 0, 1), "read_after": (0, 0, 1)}
K8_REPEAT = 100  # shape (b): the dense step's 10 DVs ×100, 1,000 DVs


def _dv_blobs(path: str, state, eng) -> list:
    """The DV blob of every live file that has one."""
    from delta_tpu_torch.dv.descriptor import _load_blob

    return [_load_blob(eng, path, a.deletionVector.to_dict())[0]
            for a in state.add_files if a.deletionVector is not None]


def _k8_against_plain(path: str, state, eng, rows_per_file: int, dev) -> int:
    """K8 against its plain version over every DV of the table in one
    batch: the decode tiles of all their blobs, and the pack tiles of all
    their bitmap containers; the masks decoded on the card equal the
    CPU's, and the DVs re-serialized on the card (one pack) equal the
    stored bytes. Returns the number of DVs held."""
    from delta_tpu_torch.dv.roaring import (
        RoaringBitmapArray, _pack_plan, _plan, decode_delta_masks,
        serialize_deltas)
    from delta_tpu_torch.ops.dv_bits import (
        BITMAP_WORDS, dv_tiles, dv_tiles_plain, pack_tiles, upload)

    blobs = _dv_blobs(path, state, eng)
    rows = [rows_per_file] * len(blobs)
    tiles, lows, bm, n_words, _ = _plan(blobs, rows)
    _check(torch.equal(dv_tiles(*upload((tiles, lows, bm), dev),
                                n_words).cpu(),
                       dv_tiles_plain(*upload((tiles, lows, bm), "cpu"),
                                      n_words)),
           "dml: K8 decode != plain over the table's DVs")
    for (m, c), (mc, cc) in zip(decode_delta_masks(blobs, rows, dev),
                                decode_delta_masks(blobs, rows, "cpu")):
        _check(c == cc and np.array_equal(m, mc),
               "dml: a DV's mask on the card != the CPU's")
    bitmaps = [RoaringBitmapArray.deserialize_delta(b) for b in blobs]
    _, p_lows, lens = _pack_plan(bitmaps)
    p_in = (pack_tiles(lens), p_lows, np.zeros((0, BITMAP_WORDS), np.int32))
    p_words = len(lens) * BITMAP_WORDS
    _check(torch.equal(dv_tiles(*upload(p_in, dev), p_words,
                                pack=True).cpu(),
                       dv_tiles_plain(*upload(p_in, "cpu"), p_words)),
           "dml: K8 pack != plain over the table's DVs")
    _check(serialize_deltas(bitmaps, dev) == blobs,
           "dml: the DVs re-serialized on the card != their blobs")
    eng.synchronize()
    return len(blobs)


def _dml_rows_check(got, truth: dict, sel: np.ndarray, what: str) -> None:
    """The rows read are the numpy truth's selected rows, as a multiset of
    row hashes."""
    cols = ("k1", "k2", "k3", "payload")
    _check(got.num_rows == int(sel.sum()),
           f"{what}: {got.num_rows} rows, numpy {int(sel.sum())}")
    want = np.sort(_row_hash(*(truth[c][sel] for c in cols)))
    have = np.sort(_row_hash(*(np.ascontiguousarray(got.column(c).values)
                               for c in cols)))
    _check(np.array_equal(want, have), f"{what}: the rows are numpy's")


def dml_phase(work: str, appends: list, card: str, dev) -> tuple:
    """Cell 10: DML on a deletion-vector table, on `dev`. The given
    appends of the OPTIMIZE cell written by the port to a table created with
    delta.enableDeletionVectors, then, each step's counters from 0: a
    sparse DELETE (array containers), a filtered read (K8 decodes), a
    dense DELETE (bitmap containers: K8 packs), a read, an UPDATE of
    three rows' payload, OPTIMIZE compaction (no DV left), a reload.
    Every step's rows against numpy; K8 against its plain version on
    every DV after each DELETE. Returns (the metrics line, K8's timed
    inputs)."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.commands.dml import delete, update
    from delta_tpu_torch.expressions import col, lit

    path = os.path.join(work, "dml")
    eng = TorchEngine(dev.type)
    per = len(appends[0]["k1"])
    truth = {c: np.concatenate([a[c] for a in appends])
             for c in ("k1", "k2", "k3", "payload")}
    alive = np.ones(len(truth["k1"]), bool)
    sync = eng.synchronize
    obs.reset()
    t0 = time.perf_counter()
    for i, cols in enumerate(appends):
        write_table(path, cols, engine=eng, properties=None if i else {
            "delta.enableDeletionVectors": "true"})
    out = {"rows": len(alive), "write_appends_s": time.perf_counter() - t0,
           "card": card}
    table = Table.for_path(path, engine=eng)
    table.latest_snapshot().state
    steps = {}

    def step(name, fn):
        sync()
        obs.reset()
        t0 = time.perf_counter()
        result = fn()
        sync()
        seconds = time.perf_counter() - t0
        counts = obs.counters()
        _ladder_idle(counts, f"dml {name}")
        steps[name] = {
            "s": seconds,
            "k8_pack": counts.get(DML_K8[0], 0),
            "k8_decode": counts.get(DML_K8[1], 0),
            "k7": counts.get("kernel.skip_mask.launches", 0),
            "k1": counts.get("kernel.byte_class.launches", 0),
            "k2": counts.get("kernel.winner_pack.launches", 0),
            "k3": counts.get("kernel.hybrid_extract.launches", 0),
            "k8_decode_dvs": counts.get("kernel.dv_bits.decode_dvs", 0),
            "dv_host_s": {k: counts.get(f"dv.decode_{k}_ns", 0) / 1e9
                          for k in DML_DV_HOST},
            "parse_device_windows": counts.get("parse.device_windows", 0),
            "parse_device_fallbacks": counts.get("parse.device_fallbacks", 0),
            "decode_device_parts": counts.get("decode.device_parts", 0)}
        s = steps[name]
        _check(dev.type != "cuda" or (s["k8_pack"], s["k8_decode"],
                                      s["parse_device_fallbacks"])
               == DML_EXPECT[name],
               f"dml {name}: K8 launches and parse fallbacks {s}, expected "
               f"{DML_EXPECT[name]}")
        return result

    # 1. a sparse DELETE: every file keeps a DV of array containers
    m = step("delete_sparse", lambda: delete(
        table, col("k1") < lit(DML_SPARSE_K1)))
    hit = alive & (truth["k1"] < DML_SPARSE_K1)
    _check(m.num_rows_deleted == int(hit.sum())
           and m.num_dvs_written == len(appends)
           and m.num_files_removed_fully == 0,
           f"dml: the sparse DELETE's metrics {m}")
    alive &= ~hit
    st = table.latest_snapshot().state
    steps["delete_sparse"]["dvs_held_to_plain"] = _k8_against_plain(
        path, st, eng, per, dev)
    # 2. a filtered read: K7 plans, K8 decodes each file's DV
    got = step("read_filtered", lambda: read_table(
        path, filter=col("k2") >= lit(DML_READ_K2), engine=eng))
    _dml_rows_check(got, truth, alive & (truth["k2"] >= DML_READ_K2),
                    "dml read_filtered")
    del got
    # 3. a dense DELETE: the union with each file's DV, bitmap containers
    m = step("delete_dense", lambda: delete(
        table, col("payload") > lit(DML_DENSE_PAYLOAD)))
    hit = alive & (truth["payload"] > DML_DENSE_PAYLOAD)
    _check(m.num_rows_deleted == int(hit.sum())
           and m.num_dvs_written == len(appends),
           f"dml: the dense DELETE's metrics {m}")
    alive &= ~hit
    st = table.latest_snapshot().state
    steps["delete_dense"]["dvs_held_to_plain"] = _k8_against_plain(
        path, st, eng, per, dev)
    # K8's timed inputs, at the main path's shape: the step's DVs
    k8_inputs = (_dv_blobs(path, st, eng), per)
    # 4. a read of every row
    got = step("read", lambda: read_table(path, engine=eng))
    _dml_rows_check(got, truth, alive, "dml read")
    del got
    # 5. an UPDATE of three rows, one in each of three files (their k1
    # unique in the table): copy-on-write of those files
    uniq, counts = np.unique(truth["k1"], return_counts=True)
    once = set(uniq[counts == 1].tolist())
    keys = []
    for f in DML_UPDATE_FILES:
        rows = np.arange(f * per, (f + 1) * per)
        keys.append(next(int(truth["k1"][r]) for r in rows
                         if alive[r] and int(truth["k1"][r]) in once))
    m = step("update", lambda: update(table, {"payload": lit(0.0)},
                                      col("k1").is_in(*keys)))
    hit = alive & np.isin(truth["k1"], keys)
    _check(m.num_rows_updated == 3 == int(hit.sum())
           and m.num_files_rewritten == 3, f"dml: the UPDATE's metrics {m}")
    truth["payload"] = np.where(hit, 0.0, truth["payload"])
    # 6. OPTIMIZE compaction: every bin's DVs purged
    m = step("optimize", lambda: table.optimize().execute_compaction(
        max_file_size=DML_OPTIMIZE_MAX_FILE))
    st = table.latest_snapshot().state
    _check(m.num_files_removed == len(appends)
           and not any(a.deletionVector for a in st.add_files),
           f"dml: OPTIMIZE left no DV ({m.num_files_removed} removed)")
    # 7. a reload from scratch, then every row
    st = step("reload", lambda: Table.for_path(
        path, engine=eng).latest_snapshot().state)
    _check(st.num_files == m.num_files_added
           and not any(a.deletionVector for a in st.add_files),
           "dml: the reload's live files")
    got = step("read_after", lambda: read_table(path, engine=eng))
    _dml_rows_check(got, truth, alive, "dml read_after")
    del got
    out.update({"steps": steps, "rows_alive": int(alive.sum()),
                "output_files": st.num_files})
    return out, k8_inputs


def _k8_batch(tiles, lows, bm, n_words: int, dev, pack: bool) -> dict:
    """K8 over one batch of tiles on the card: against its plain version
    (on the CPU), timed beside it, beside its bound and beside one
    `scatter_add_` of precomputed word indexes and int32 values (bits and
    bitmap words) over the same batch."""
    from delta_tpu_torch.ops.dv_bits import dv_tiles, dv_tiles_plain, upload

    on = upload((tiles, lows, bm), dev)
    run = lambda: dv_tiles(*on, n_words, pack=pack)  # noqa: E731
    got = run().cpu()
    t0 = time.perf_counter()
    want = dv_tiles_plain(*upload((tiles, lows, bm), "cpu"), n_words)
    plain_ms = (time.perf_counter() - t0) * 1e3
    _check(torch.equal(got, want), f"dv_bits {'pack' if pack else 'decode'}"
           " != plain")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if n_words else 0
    t = tiles.astype(np.int64)
    off, valid, bm_at, lo, hi = t.T
    has = bm_at >= 0
    # bytes: 2 B per low, 4 B per valid bitmap word, 20 B per tile, 4 B
    # per output word; operations: one OR per low
    bound, by = _bound_ms(2.0 * len(lows) + 4.0 * valid[has].sum()
                          + 20.0 * len(t) + 4.0 * n_words, float(len(lows)))
    # the library call's lanes, built outside its timing
    n = hi - lo
    tile_of = np.repeat(np.arange(len(t)), n)
    low = lows.view(np.uint16).astype(np.int64)
    keep = (low >> 5) < valid[tile_of]
    j = np.arange(bm.shape[1])
    sel = j < valid[has, None]
    word = np.concatenate([(off[tile_of] + (low >> 5))[keep],
                           (off[has, None] + j)[sel]])
    val = np.concatenate([(np.int64(1) << (low & 31))[keep].astype(
        np.uint32).view(np.int32), bm[bm_at[has]][sel]])
    word, val = torch.from_numpy(word).to(dev), torch.from_numpy(val).to(dev)
    buf = torch.zeros(n_words, dtype=torch.int32, device=dev)
    buf.scatter_add_(0, word, val)
    _check(torch.equal(buf.cpu(), got), "scatter_add_ != K8 on the lanes")
    return {
        "max_abs_err": err, "ms": _time_ms(run, 50),
        "device_ms": _device_ms(run, 50, ("dv_tiles_kernel",)),
        "plain_ms": plain_ms, "plain_device": "cpu",
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: buf.scatter_add_(0, word, val), 50),
        "shape": f"{len(t)} tiles ({int(has.sum())} bitmap), {len(lows)} "
                 f"lows -> i32[{n_words}]"}


def dv_bits_row(blobs: list, rows: int, dev, launches: int) -> dict:
    """K8 at two shapes: (a) the dense DELETE's DVs of cell 10, one file
    each, the main path's batch; (b) the same blobs ×K8_REPEAT (1,000
    DVs), where bytes and not the launch set the bound. Decode (the tiles
    `decode_delta_masks` builds) and pack (the tiles `serialize_deltas`
    builds) at each; the row's own keys are (a)'s decode."""
    from delta_tpu_torch.dv.roaring import (
        RoaringBitmapArray, _pack_plan, _plan)
    from delta_tpu_torch.ops.dv_bits import BITMAP_WORDS, pack_tiles

    bitmaps = [RoaringBitmapArray.deserialize_delta(b) for b in blobs]
    shapes = {}
    for name, k in (("a", 1), ("b", K8_REPEAT)):
        tiles, lows, bm, n_words, _ = _plan(blobs * k, [rows] * len(blobs)
                                            * k)
        shapes[f"{name}_decode"] = _k8_batch(tiles, lows, bm, n_words, dev,
                                             pack=False)
        shapes[f"{name}_decode"]["dvs"] = len(blobs) * k
        _, p_lows, lens = _pack_plan(bitmaps * k)
        shapes[f"{name}_pack"] = _k8_batch(
            pack_tiles(lens), p_lows, np.zeros((0, BITMAP_WORDS), np.int32),
            len(lens) * BITMAP_WORDS, dev, pack=True)
        shapes[f"{name}_pack"]["dvs"] = len(blobs) * k
    for s in shapes.values():
        s["device_share"] = s["bound_ms"] / s["device_ms"]
    return {"name": "dv_bits", "route": "cuda",
            "source": "delta_tpu_torch/csrc/dv_bits.cu",
            "replaces": "delta_tpu/ops/stats.py:279",
            "replaces_pack": "delta_tpu/ops/stats.py:231",
            "launches": launches, **shapes["a_decode"], "shapes": shapes}


MERGE_ROWS = 10_000_000     # cell 11's target: ids 0..10M-1, time-ordered
MERGE_APPENDS = 20          # written as 20 appends of 500k rows
MERGE_SOURCE = 1_000_000    # MergeBenchmark's 10% source
MERGE_DELETE_SOURCE = 1_000
MERGE_SKEW_TARGET = 150_000  # the skewed shape: one key's target rows
MERGE_ONE_KEY = 1_000_000   # the all-one-key shape: rows a side
MONTHS = np.array([f"{m:02d}" for m in range(1, 13)], object)
# per step on the card: K9 launches (the upsert's and the delete-merge's
# joins take the device route: over DEVICE_JOIN_MIN_ROWS rows, no
# residual conjunct)
MERGE_EXPECT_K9 = {"upsert": 1, "delete_merge": 1, "read_month": 0,
                   "optimize_month": 0, "reload": 0, "read_all": 0}


def _month_index(ids: np.ndarray) -> np.ndarray:
    """The month (0-11) of each id: time-ordered, ids past the target's
    in the last month."""
    return np.minimum(ids * 12 // MERGE_ROWS, 11)


def merge_appends(seed: int) -> list:
    """Cell 11's 20 appends: id, v (normal from the seed), month."""
    rng = np.random.default_rng(seed)
    per = MERGE_ROWS // MERGE_APPENDS
    out = []
    for k in range(MERGE_APPENDS):
        ids = np.arange(k * per, (k + 1) * per, dtype=np.int64)
        out.append({"id": ids, "v": rng.normal(size=per),
                    "month": MONTHS[_month_index(ids)]})
    return out


def _merge_files() -> list:
    """(append, month index, first id, last id, rows) of every file the
    appends write: one per append and month, ids in order."""
    per = MERGE_ROWS // MERGE_APPENDS
    out = []
    for k in range(MERGE_APPENDS):
        m = _month_index(np.arange(k * per, (k + 1) * per))
        for mi in np.unique(m).tolist():
            ids = np.nonzero(m == mi)[0] + k * per
            out.append((k, mi, int(ids[0]), int(ids[-1]), len(ids)))
    return out


def _merge_expected(files, src_ids, src_month_idx, hit_ids, n_hit) -> dict:
    """The candidates (files in the source's month range whose id range
    meets the source's) and the touched ones (holding a matched id): the
    scanned, rewritten and copied counts."""
    lo, hi = int(src_ids.min()), int(src_ids.max())
    m_lo, m_hi = int(src_month_idx.min()), int(src_month_idx.max())
    cand = [f for f in files if m_lo <= f[1] <= m_hi
            and f[2] <= hi and f[3] >= lo]
    touched = [f for f in cand if np.any((hit_ids >= f[2])
                                         & (hit_ids <= f[3]))]
    return {"scanned": len(cand), "rewritten": len(touched),
            "copied": sum(f[4] for f in touched) - n_hit}


def _merge_rows_check(got, ids, v, alive, what: str) -> None:
    """The rows read are the truth's alive rows as a multiset of (id, v)
    hashes, each with its id's month."""
    _check(got.num_rows == int(alive.sum()),
           f"{what}: {got.num_rows} rows, numpy {int(alive.sum())}")
    zero = np.zeros(int(alive.sum()), np.int64)
    gid = np.ascontiguousarray(got.column("id").values)
    want = np.sort(_row_hash(ids[alive], zero, zero, v[alive]))
    have = np.sort(_row_hash(gid, zero, zero,
                             np.ascontiguousarray(got.column("v").values)))
    _check(np.array_equal(want, have), f"{what}: the rows are numpy's")
    _check(np.array_equal(got.column("month").values,
                          MONTHS[_month_index(gid)]),
           f"{what}: every row in its id's month")


def merge_phase(work: str, card: str, seed: int, dev) -> tuple:
    """Cell 11: MERGE into a partitioned table, on the card. The target
    (10M rows, 20 appends, partitioned by month), then, each step's
    counters from 0: an upsert of a 1M-row source (half matched ids of
    months 11-12, half new ids in month 12), a delete-merge of 1,000 rows
    into month 01, a read filtered on month 12, OPTIMIZE ZORDER BY id
    where month 12, a reload and a full read. Every step's rows and
    MergeMetrics against numpy; K9 launched once per MERGE. Returns (the
    metrics line, the upsert's sorted join lanes for K9's row)."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.commands.merge import merge
    from delta_tpu_torch.expressions import col, lit
    import delta_tpu_torch.ops.join as join_mod

    path = os.path.join(work, "merge")
    eng = TorchEngine(dev.type)
    sync = eng.synchronize
    rng = np.random.default_rng(seed)
    appends = merge_appends(seed)
    n_new = MERGE_SOURCE // 2
    ids = np.arange(MERGE_ROWS + n_new, dtype=np.int64)
    v = np.concatenate([a["v"] for a in appends] + [np.zeros(n_new)])
    alive = np.arange(len(ids)) < MERGE_ROWS
    files = _merge_files()
    obs.reset()
    t0 = time.perf_counter()
    for cols in appends:
        write_table(path, cols, partition_by=["month"], engine=eng)
    sync()
    out = {"rows": MERGE_ROWS, "files": len(files), "card": card,
           "write_appends_s": time.perf_counter() - t0}
    del appends
    table = Table.for_path(path, engine=eng)
    _check(table.latest_snapshot().state.num_files == len(files),
           "merge: one file per append and month")
    steps = {}

    def step(name, fn):
        sync()
        obs.reset()
        t0 = time.perf_counter()
        result = fn()
        sync()
        seconds = time.perf_counter() - t0
        counts = obs.counters()
        _ladder_idle(counts, f"merge {name}")
        steps[name] = {
            "s": seconds,
            "k9": counts.get("kernel.merge_join.launches", 0),
            "device_joins": counts.get("join.device_joins", 0),
            **{k: counts.get(f"kernel.{n}.launches", 0) for k, n in (
                ("k1", "byte_class"), ("k2", "winner_pack"),
                ("k3", "hybrid_extract"), ("k4", "interleave_bits"),
                ("k7", "skip_mask"))},
            "k8_decode": counts.get("kernel.dv_bits.decode_launches", 0),
            "hook_failures": sum(v for k, v in counts.items()
                                 if k.startswith("hooks."))}
        s = steps[name]
        _check(dev.type != "cuda" or s["k9"] == MERGE_EXPECT_K9[name],
               f"merge {name}: K9 launches {s['k9']}, expected "
               f"{MERGE_EXPECT_K9[name]}")
        _check(s["hook_failures"] == 0, f"merge {name}: a hook failed")
        return result

    on = (col("target.id") == col("source.id")) \
        & (col("target.month") == col("source.month"))
    # 1. the upsert: matched ids drawn from months 11-12, new ids in 12
    first11 = int(np.nonzero(_month_index(ids[:MERGE_ROWS]) == 10)[0][0])
    old = rng.choice(np.arange(first11, MERGE_ROWS), MERGE_SOURCE - n_new,
                     replace=False)
    src_ids = np.concatenate([old, np.arange(MERGE_ROWS,
                                             MERGE_ROWS + n_new)])
    src_v = rng.normal(size=MERGE_SOURCE)
    src_m = _month_index(src_ids)
    source = {"id": src_ids, "v": src_v, "month": MONTHS[src_m]}
    want = _merge_expected(files, src_ids, src_m, old, len(old))
    lanes = {}
    tail = join_mod.join_tail

    def capture(s_code, s_pos, nt, ns):
        lanes["upsert"] = (s_code.clone(), s_pos.clone(), nt, ns)
        return tail(s_code, s_pos, nt, ns)

    join_mod.join_tail = capture
    try:
        m = step("upsert", lambda: merge(table, source, on)
                 .when_matched_update(set={"v": col("source.v")})
                 .when_not_matched_insert_all().execute())
    finally:
        join_mod.join_tail = tail
    _check((m.num_target_rows_updated, m.num_target_rows_inserted,
            m.num_target_rows_deleted, m.num_target_rows_copied,
            m.num_target_files_scanned, m.num_target_files_rewritten,
            m.num_source_rows)
           == (len(old), n_new, 0, want["copied"], want["scanned"],
               want["rewritten"], MERGE_SOURCE),
           f"merge upsert: metrics {m}, expected {want}")
    _check(dev.type != "cuda" or "upsert" in lanes,
           "merge upsert: the join's tail ran on the device route")
    steps["upsert"]["metrics"] = {k: v_ for k, v_ in vars(m).items()
                                  if k != "phase_seconds"}
    steps["upsert"]["phase_s"] = m.phase_seconds
    v[src_ids] = src_v
    alive[src_ids] = True
    # 2. the delete-merge: 1,000 ids of month 01, those with v < 0 go
    first02 = int(np.nonzero(_month_index(ids[:MERGE_ROWS]) == 1)[0][0])
    d_ids = rng.choice(first02, MERGE_DELETE_SOURCE, replace=False)
    d_v = rng.normal(size=MERGE_DELETE_SOURCE)
    dsrc = {"id": d_ids, "v": d_v, "month": MONTHS[_month_index(d_ids)]}
    gone = d_ids[d_v < 0]
    want = _merge_expected(files, d_ids, _month_index(d_ids), gone,
                           len(gone))
    m = step("delete_merge", lambda: merge(table, dsrc, on)
             .when_matched_delete(condition=col("source.v") < lit(0.0))
             .execute())
    _check((m.num_target_rows_deleted, m.num_target_rows_updated,
            m.num_target_rows_inserted, m.num_target_rows_copied,
            m.num_target_files_scanned, m.num_target_files_rewritten)
           == (len(gone), 0, 0, want["copied"], want["scanned"],
               want["rewritten"]),
           f"merge delete_merge: metrics {m}, expected {want}")
    steps["delete_merge"]["metrics"] = {k: v_ for k, v_ in vars(m).items()
                                        if k != "phase_seconds"}
    steps["delete_merge"]["phase_s"] = m.phase_seconds
    alive[gone] = False
    # 3. a read of month 12
    got = step("read_month", lambda: read_table(
        path, filter=col("month") == lit("12"), engine=eng))
    _merge_rows_check(got, ids, v, alive & (_month_index(ids) == 11),
                      "merge read_month")
    del got
    # 4. OPTIMIZE ZORDER BY id within month 12 (K4 once)
    m = step("optimize_month", lambda: table.optimize().where(
        col("month") == lit("12")).execute_zorder_by("id"))
    _check(m.partitions_optimized == 1 and m.num_bins == 1
           and steps["optimize_month"]["k4"] == (dev.type == "cuda"),
           f"merge optimize_month: {m.partitions_optimized} partitions, "
           f"{m.num_bins} bins, K4 {steps['optimize_month']['k4']}")
    steps["optimize_month"]["files_removed"] = m.num_files_removed
    # 5. a reload, then every row
    st = step("reload", lambda: Table.for_path(
        path, engine=eng).latest_snapshot().state)
    _check(all(a.path.startswith(f"month={a.partitionValues['month']}/")
               for a in st.add_files), "merge reload: files in their "
           "partitions' directories")
    got = step("read_all", lambda: read_table(path, engine=eng))
    _merge_rows_check(got, ids, v, alive, "merge read_all")
    del got
    out.update({"steps": steps, "rows_alive": int(alive.sum()),
                "output_files": st.num_files})
    return out, lanes.get("upsert")


def _skewed_lanes(dev):
    """The skewed shape: one key with MERGE_SKEW_TARGET target rows and
    three source rows (an insert-only MERGE's duplicate keys), beside
    unique keys; sorted on the card as the join sorts."""
    from delta_tpu_torch.ops.join import sort_codes

    rng = np.random.default_rng(5)
    nt = MERGE_SKEW_TARGET + 850_000
    t = np.concatenate([np.zeros(MERGE_SKEW_TARGET, np.int64),
                        np.arange(1, 850_001)])
    s = np.concatenate([np.zeros(3, np.int64),
                        rng.integers(1, 2_000_000, MERGE_SOURCE - 3)])
    codes = torch.from_numpy(np.concatenate([rng.permutation(t),
                                             rng.permutation(s)])
                             .astype(np.int32)).to(dev)
    s_code, s_pos = sort_codes(codes, nt)
    return s_code, s_pos, nt, len(s)


def _one_key_lanes(dev):
    """The all-one-key shape: MERGE_ONE_KEY target and MERGE_ONE_KEY
    source rows on one code, sorted on the card as the join sorts."""
    from delta_tpu_torch.ops.join import sort_codes

    codes = torch.zeros(2 * MERGE_ONE_KEY, dtype=torch.int32, device=dev)
    s_code, s_pos = sort_codes(codes, MERGE_ONE_KEY)
    return s_code, s_pos, MERGE_ONE_KEY, MERGE_ONE_KEY


def _k9_times(s_code, s_pos, nt: int, ns: int) -> dict:
    """K9 on one set of sorted lanes: against its plain version on the
    card, timed beside it and its bound, and beside
    `torch.unique_consecutive` (run ids and lengths: the nearest single
    call, a part of the function)."""
    from delta_tpu_torch.ops.join import join_tail, join_tail_plain, n_words

    got = join_tail(s_code, s_pos, nt, ns)
    torch.cuda.synchronize()
    want = join_tail_plain(s_code, s_pos, nt, ns)
    _check(torch.equal(got, want), "merge_join != plain")
    n = nt + ns
    runs = torch.unique_consecutive(s_code, return_counts=True)[1]
    call = lambda: join_tail(s_code, s_pos, nt, ns)  # noqa: E731
    # bytes: the code and position of every row read once, match_src and
    # the words written once; operations: a comparison or two per row
    nbytes = 8.0 * n + 4.0 * nt + 4.0 * n_words(ns) + 4.0
    bound, by = _bound_ms(nbytes, 2.0 * n)
    return {
        "max_abs_err": int((got.to(torch.int64) - want.to(torch.int64))
                           .abs().max()),
        "ms": _time_ms(call, 50),
        # the memset of its status words, merge_join_ahead and _resolve
        "device_ms": _device_ms(call, 50, ("merge_join", "Memset")),
        "plain_ms": _time_ms(lambda: join_tail_plain(s_code, s_pos, nt, ns),
                             10),
        "plain_device": "cuda",
        "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes,
        "closest_call": "torch.unique_consecutive(return_counts=True)",
        "closest_call_ms": _time_ms(lambda: torch.unique_consecutive(
            s_code, return_counts=True), 50),
        "longest_run": int(runs.max()), "runs": int(runs.numel()),
        "shape": f"u32[{n}]+i32[{n}] ({nt} target, {ns} source rows)"}


def merge_join_row(lanes, dev, launches: int) -> dict:
    """K9 at the upsert's shape (the main path's own sorted lanes), the
    skewed shape and the all-one-key shape; the row's own keys are the
    upsert's."""
    _check(lanes is not None, "merge: the upsert's join lanes")
    upsert = _k9_times(*lanes)
    skewed = _k9_times(*_skewed_lanes(dev))
    _check(skewed["longest_run"] >= MERGE_SKEW_TARGET,
           "merge_join: the skewed shape's longest run")
    one_key = _k9_times(*_one_key_lanes(dev))
    _check(one_key["runs"] == 1, "merge_join: the all-one-key shape's run")
    for s in (upsert, skewed, one_key):
        s["share"] = s["bound_ms"] / s["ms"]
        s["device_share"] = s["bound_ms"] / s["device_ms"]
    return {"name": "merge_join", "route": "cuda",
            "source": "delta_tpu_torch/csrc/merge_join.cu",
            "replaces": "delta_tpu/ops/join.py:41", "launches": launches,
            "library_ms": None, **upsert, "skewed": skewed,
            "one_key": one_key}


UNPACK_W = 16               # device_merit.py:491-506: w = 16, random words
UNPACK_VALUES = 10_000_000  # BASELINE config 2's scale


def unpack_phase(dev) -> dict:
    """K5: the entry point `unpack_bitpacked` at the benchmark's shape
    (w = 16, random words, 10M values), counters from 0; then the kernel
    against its plain version, exact, on that shape and on edge shapes
    (every w in 1..32 at G = 1, 31, 1025; w = 0 and the width guard);
    timed beside its plain version and its bound."""
    from delta_tpu_torch import obs
    from delta_tpu_torch.errors import InvalidArgumentError
    from delta_tpu_torch.ops.unpack import (
        unpack_bitpacked, unpack_bitpacked_plain, unpack_bitpacked_words)

    g = UNPACK_VALUES // 32
    rng = np.random.default_rng(31)
    stream = rng.integers(0, 2**32, g * UNPACK_W, dtype=np.uint32)
    torch.cuda.synchronize()
    obs.reset()
    out = unpack_bitpacked(stream, UNPACK_W, g)
    torch.cuda.synchronize()
    launches = obs.counters().get("kernel.unpack_bitpacked.launches", 0)
    _check(launches >= 1, "unpack_bitpacked launched on its entry point")
    packed = torch.from_numpy(np.ascontiguousarray(
        stream.reshape(g, UNPACK_W).T).view(np.int32)).to(dev)
    want = unpack_bitpacked_plain(packed, UNPACK_W)
    _check(torch.equal(out, want), "unpack_bitpacked != plain (10M values)")
    err = int((out.to(torch.int64) - want.to(torch.int64)).abs().max())
    del out, want
    for w in range(1, 33):
        for n_groups in (1, 31, 1025):
            x = torch.from_numpy(rng.integers(
                0, 2**32, (w, n_groups), dtype=np.uint32).view(np.int32)).to(dev)
            x[:, ::3] = -1  # all-ones words
            _check(torch.equal(unpack_bitpacked_words(x, w),
                               unpack_bitpacked_plain(x, w)),
                   f"unpack_bitpacked != plain at w={w} G={n_groups}")
            torch.cuda.synchronize()
    _check(not unpack_bitpacked(stream, 0, 1025).any(), "w = 0 gives zeros")
    for bad in (-1, 33, 2.5):
        try:
            unpack_bitpacked(stream, bad, 1)
        except InvalidArgumentError:
            continue
        _check(False, f"the width guard refuses w={bad!r}")
    ms = _time_ms(lambda: unpack_bitpacked_words(packed, UNPACK_W), 50)
    dev_ms = _device_ms(lambda: unpack_bitpacked_words(packed, UNPACK_W),
                        50, ("unpack_kernel",))
    plain = _time_ms(lambda: unpack_bitpacked_plain(packed, UNPACK_W), 5)
    nbytes = (4.0 * UNPACK_W + 128.0) * g
    bound, by = _bound_ms(nbytes, 4.0 * 32 * g)
    return {
        "name": "unpack_bitpacked", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/unpack_bitpacked.cu",
        "replaces": "delta_tpu/ops/pallas_kernels.py:258",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "device_ms": dev_ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        "shape": f"u32[{UNPACK_W},{g}]->u32[{g * 32}]",
        "bound_bytes": nbytes}


def _minmax_edges():
    """(name, values, mask) edge cases of K6."""
    g = np.random.default_rng(17)
    out = []
    for f, r in ((1, 1), (1, 129), (9, 1), (9, 129)):
        v = g.normal(size=(f, r)).astype(np.float32)
        out.append((f"F={f} R={r}", v, g.random((f, r)) > 0.2))
    v = g.normal(size=(6, 300)).astype(np.float32)
    m = np.ones((6, 300), bool)
    v[0] = 0.0
    v[0, ::2] = -0.0          # min -0.0, max +0.0 in any order
    v[1, 7] = np.nan          # a valid NaN: both NaN
    m[2] = False              # no valid row: +inf, -inf, 0
    v[3] = np.inf             # +inf as a min
    v[4, 5] = -np.inf
    v[5, 9] = np.nan
    m[5, 9] = False           # a masked NaN is ignored
    out.append(("NaN, signed zeros, infinities, an empty file", v, m))
    return out


def minmax_phase(appends: list, dev) -> dict:
    """K6: the entry point `batched_file_stats` on the OPTIMIZE cell's own
    data (the 20 appends' payload as f32 [20, 500,000], cast as the
    reference casts it), all valid and under a seeded 10% null mask,
    counters from 0; then the kernel against its plain version and numpy,
    exact, and on edge shapes; timed beside its plain version, the
    two-call where + aminmax yardstick, and its bound."""
    from delta_tpu_torch import obs
    from delta_tpu_torch.ops.minmax import (
        batched_file_stats, segmented_minmax, segmented_minmax_plain)

    values = np.stack([a["payload"] for a in appends]).astype(np.float32)
    f, r = values.shape
    masks = [np.ones((f, r), bool),
             np.random.default_rng(41).random((f, r)) >= 0.1]
    torch.cuda.synchronize()
    obs.reset()
    stats = [batched_file_stats(values, m) for m in masks]
    torch.cuda.synchronize()
    launches = obs.counters().get("kernel.segmented_minmax.launches", 0)
    _check(launches >= 2, "segmented_minmax launched on its entry point")
    for (mn, mx, nulls, records), m in zip(stats, masks):
        filled = np.where(m, values, np.inf)
        _check(np.array_equal(mn, filled.min(1))
               and np.array_equal(mx, np.where(m, values, -np.inf).max(1)),
               "batched_file_stats min/max == numpy")
        _check(np.array_equal(nulls, r - m.sum(1))
               and np.array_equal(records, np.full(f, r)),
               "batched_file_stats null counts == numpy")
    v = torch.from_numpy(values).to(dev)
    err = 0.0
    cases = [("payload", values, m) for m in masks] + _minmax_edges()
    for name, vals, m in cases:
        vt = torch.from_numpy(vals).to(dev)
        mt = torch.from_numpy(m).to(dev)
        got = segmented_minmax(vt, mt)
        torch.cuda.synchronize()
        want = segmented_minmax_plain(vt, mt)
        for a, b in zip(got, want):
            _check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                   f"segmented_minmax != plain bit for bit ({name})")
        err = max(err, float((got[0] - want[0]).abs().nan_to_num(0).max()))
    mt = torch.from_numpy(masks[1]).to(dev)
    ms = _time_ms(lambda: segmented_minmax(v, mt), 50)
    dev_ms = _device_ms(lambda: segmented_minmax(v, mt), 50,
                        ("segmented_minmax_kernel",))
    plain = _time_ms(lambda: segmented_minmax_plain(v, mt), 10)
    yardstick = _time_ms(
        lambda: torch.aminmax(torch.where(mt, v, torch.inf), dim=1), 20)
    bound, by = _bound_ms(5.0 * f * r, 4.0 * f * r)
    return {
        "name": "segmented_minmax", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/segmented_minmax.cu",
        "replaces": "delta_tpu/ops/pallas_kernels.py:125",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "device_ms": dev_ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "where_aminmax_ms": yardstick,
        "shape": f"f32[{f},{r}]+bool[{f},{r}]->f32[{f}]x2+i32[{f}]",
        "bound_bytes": 5.0 * f * r}


def checkpoint_write_phase(path: str, truth, card: str) -> dict:
    """BASELINE config 2's write half: the latest snapshot loaded on the
    card, then, counters from 0, `write_checkpoint(engine, snapshot)` with
    `checkpoint_part_size = num_files // 8` (bench.py:823); its hint, its
    aggregate counters against the block of the same lanes on the card
    and through the host twin, and a fresh load through the
    new checkpoint alone against the generator's truth and the retained
    tombstones. The new checkpoint is removed afterwards, so that later
    loads of the log see the cell they measured before."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.config import settings
    from delta_tpu_torch.log import checkpointer
    from delta_tpu_torch.log.checkpointer import (
        RETENTION_MS, CheckpointMetrics, write_checkpoint)
    from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint
    from delta_tpu_torch.ops.stats import (
        checkpoint_stats_block, host_stats_block)
    from delta_tpu_torch.utils import filenames

    eng = TorchEngine()
    log = os.path.join(path, "_delta_log")
    hint_path = filenames.last_checkpoint_file(log)
    with open(hint_path, "rb") as fh:
        old_hint = fh.read()
    obs.reset()
    snap = Table.for_path(path, engine=eng).latest_snapshot()
    state = snap.state
    _ladder_idle(obs.counters(), "checkpoint write: the load it writes")
    live = state.num_files
    # the tombstones a checkpoint written now keeps, computed here from
    # the loaded state (the generator's timestamps are commit indexes)
    now_ms = int(time.time() * 1000)
    keep = sorted(t.path for t in state.tombstones
                  if (t.deletionTimestamp or 0) >= now_ms - RETENTION_MS)
    settings.checkpoint_part_size = max(1, live // 8)
    try:
        m = CheckpointMetrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        obs.reset()
        t0 = time.perf_counter()
        info = write_checkpoint(eng, snap, metrics=m)
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
        counts = obs.counters()
        peak = torch.cuda.max_memory_allocated()
    finally:
        settings.checkpoint_part_size = None
    nbytes = counts.get("checkpoint.bytes_written", 0)
    hint = read_last_checkpoint(eng.fs, log)
    _check(hint is not None and hint.version == truth.version,
           "checkpoint write: _last_checkpoint names the head version")
    _check(hint.parts == m.parts and hint.numOfAddFiles == live,
           "checkpoint write: _last_checkpoint parts and numOfAddFiles")
    # the write's aggregate facts against the same lanes and plan,
    # assembled again, on the card and through the host twin
    adds = checkpointer._file_block(
        state.file_actions.rows,
        np.flatnonzero(state.live_mask.cpu().numpy()), "add")
    plan = checkpointer._chunk_plan(adds.n, len(keep), max(1, live // 8))
    lanes, valids, part_of, n_codes = checkpointer._checkpoint_lanes(
        state, adds, plan)
    block = checkpoint_stats_block(lanes, valids, part_of, len(plan),
                                   n_codes, eng.device)
    _check(np.array_equal(block, host_stats_block(
        lanes, valids, part_of, len(plan), n_codes)),
        "checkpoint write: the card's aggregate block == the host twin")
    _check(counts.get("checkpoint.logical_bytes") == int(block[8].sum())
           == state.size_in_bytes
           and counts.get("checkpoint.dv_cardinality") == int(block[10].sum())
           == 0 and counts.get("checkpoint.distinct_partition_values")
           == int(block[16].max()) == 1,
           "checkpoint write: its aggregate counters == the block's facts "
           "(logical bytes == size_in_bytes, no DVs, one partition)")
    del state, snap, adds, lanes, valids

    reload, rcounts, _, reload_s, _ = _timed_load(path, Table, TorchEngine,
                                                  obs)
    _check(reload.file_actions.version.min() == truth.version,
           "checkpoint write: the reload reads the new checkpoint alone")
    _ladder_idle(rcounts, "checkpoint write: the reload")
    _check(rcounts.get("decode.device_parts", 0) == m.parts
           and rcounts.get("decode.device_fallbacks", 0) == 0,
           "checkpoint write: every part decoded on the card")
    k3 = rcounts.get("kernel.hybrid_extract.launches", 0)
    _check(k3 == m.parts, "checkpoint write: K3 once per part on the reload")
    live_paths = sorted(a.path for a in reload.add_files)
    _check(reload.num_files == len(truth.live_paths)
           and reload.size_in_bytes == truth.size_in_bytes
           and hashlib.sha256("\n".join(live_paths).encode()).hexdigest()
           == hashlib.sha256("\n".join(truth.live_paths).encode())
           .hexdigest(), "checkpoint write: the reload meets the truth")
    _check(sorted(t.path for t in reload.tombstones) == keep,
           "checkpoint write: tombstones == the retained set")
    del reload
    for p in filenames.checkpoint_file_with_parts(log, truth.version,
                                                  m.parts):
        os.remove(p)
    with open(hint_path, "wb") as fh:
        fh.write(old_hint)
    return {
        "version": info.version, "parts": m.parts, "rows": m.rows,
        "live_files": live, "retained_tombstones": len(keep),
        "bytes": nbytes, "write_s": write_s,
        "checkpoint_write_gbps": nbytes / write_s / 1e9,
        "phase_s": m.phase_seconds, "peak_device_bytes": peak,
        "counters": counts, "reload_s": reload_s, "reload_counters": rcounts,
        "card": card}


_FORM_KERNELS = {"byte_class": "kernel.byte_class.launches",
                 "winner_pack": "kernel.winner_pack.launches",
                 "hybrid_extract": "kernel.hybrid_extract.launches",
                 "skip_mask": "kernel.skip_mask.launches"}


def _append_adds(log: str, live: list, first: int, n: int, next_fid: int,
                 seed: int) -> tuple:
    """`n` append-only commits after version `first - 1`, 100 new files
    each, named and with stats as the generator names them (fids from
    `next_fid` on). Returns the new live paths (sorted) and the next
    fid."""
    rng = np.random.default_rng(seed)
    live = list(live)
    for k in range(n):
        v = first + k
        lines = []
        for u in rng.integers(0, 1 << 60, 100):
            fid, next_fid = next_fid, next_fid + 1
            p = f"part-{fid:010d}-{int(u):016x}.parquet"
            live.append(p)
            lo, hi = (fid + 1) * 1000, (fid + 2) * 1000
            lines.append(
                f'{{"add":{{"path":"{p}","partitionValues":{{}},'
                f'"size":1048576,"modificationTime":{v},"dataChange":true,'
                f'"stats":"{{\\"numRecords\\":1000,'
                f'\\"minValues\\":{{\\"x\\":{lo}}},'
                f'\\"maxValues\\":{{\\"x\\":{hi}}},'
                f'\\"nullCount\\":{{\\"x\\":0}}}}"}}}}')
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return sorted(live), next_fid


def _forms_load(copy: str, live: list, version: int, what: str) -> tuple:
    """A cold load of `copy` on the card, counters from 0 just before and
    read just after, held to the live paths `live` at `version` (1 MiB
    files; the checkpoints the port writes keep no tombstone of the
    generator's, whose deletion times are commit indexes); returns (the
    snapshot, its counters, seconds)."""
    from delta_tpu_torch import Table, TorchEngine, obs

    torch.cuda.synchronize()
    obs.reset()
    t0 = time.perf_counter()
    snap = Table.for_path(copy, engine=TorchEngine()).latest_snapshot()
    state = snap.state
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = obs.counters()
    paths = sorted(_live_paths(state))
    _check(state.version == version and paths == live
           and state.size_in_bytes == 1048576 * len(live),
           f"{what}: the load meets the generator's truth")
    return snap, counts, secs


def _live_paths(state) -> list:
    """The live files' paths from the row stores (no AddFile built)."""
    idx = np.flatnonzero(state.live_mask.cpu().numpy())
    return state.file_actions.rows.paths(idx)


def log_forms_phase(path: str, truth, card: str) -> tuple:
    """The log forms of a later Delta on a hard-linked copy of cell 2's
    log (600,020 live files), on the card, each load's counters from 0
    just before it and read just after, each held to the generator's
    truth:
    - compacted deltas: `write_compacted_delta` over the tail (9991-9999)
      and over 1,000 commit-only versions (1000-1999 at 10k commits); the
      checkpoint
      load takes the tail's, a load with the checkpoint set aside takes
      both (K1 on their lines);
    - V2: `write_checkpoint(policy="v2")` at the head with cell 5's part
      size, so the file actions land in several sidecars; its reload
      reads that checkpoint alone (no commit), one K3 launch per sidecar
      and K2 (the handoff's where the sidecars' path dictionaries stay
      under 1 MiB, else the replay's); two more commits and a second V2 write with
      the first's hint reuses most sidecars; one of the second's fresh
      sidecars deleted, the load falls back once, to the first V2 and
      the two commits (append-only: a removal would shift every later
      chunk);
    - stats_parsed: a metaData commit sets writeStatsAsStruct=true and
      writeStatsAsJson=false and a struct-only checkpoint is written at
      it; its reload's 600k add stats strings (re-serialized from the
      structs) hash (sha256, sorted by path) to those of the JSON-stats
      V2 reload after both pass through `_stats_from_parsed`'s form
      (`json.dumps(json.loads(s), separators=(",", ":"))`); then cell 7's
      five filters, survivors equal to the generator's bounds, one K7
      launch per filter;
    - cleanup: `cleanup_expired_logs` under a clock 31 days ahead deletes
      every commit, checksum, compacted delta and checkpoint below the
      newest checkpoint, never a sidecar; the load still meets the truth
      and `snapshot_at` of a deleted version raises TableNotFoundError
      (DELTA_NO_COMMITS_FOUND), as the reference does;
    - C6: a scan with `k < 1.5` over two files, one holding a value past
      2^53, keeps both.
    Returns (metrics, {kernel: {launches_v2, launches_stats_parsed,
    launches_compacted}})."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.config import settings
    from delta_tpu_torch.errors import TableNotFoundError
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.log.checkpointer import (
        CheckpointMetrics, write_checkpoint)
    from delta_tpu_torch.log.cleanup import (
        cleanup_expired_logs, write_compacted_delta)
    from delta_tpu_torch.log.last_checkpoint import read_last_checkpoint
    from delta_tpu_torch.replay.columnar import CheckpointRows
    from delta_tpu_torch.utils import filenames

    copy = path + "_forms"
    shutil.copytree(path, copy, copy_function=_link_or_copy)
    log = os.path.join(copy, "_delta_log")
    head = truth.version
    live = list(truth.live_paths)
    part_size = max(1, len(live) // 8)  # cell 5's, for every write here
    out = {"card": card, "part_size": part_size}
    launches = {k: {} for k in _FORM_KERNELS}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def write(snap, **kw):
        m = CheckpointMetrics()
        settings.checkpoint_part_size = part_size
        try:
            obs.reset()
            info, secs = timed(lambda: write_checkpoint(
                TorchEngine(), snap, metrics=m, **kw))
        finally:
            settings.checkpoint_part_size = None
        return info, m, secs, obs.counters()

    try:
        # compacted deltas: the tail's, and 1,000 commit-only versions
        table = Table.for_path(copy, engine=TorchEngine())
        _, out["compact_tail_write_s"] = timed(
            lambda: write_compacted_delta(table, head - 8, head))
        run_lo = head // 10 + 1
        run_hi = run_lo + min(1000, head // 5) - 1
        _, out["compact_1000_write_s"] = timed(
            lambda: write_compacted_delta(table, run_lo, run_hi))
        base, c_ck, out["compacted_checkpoint_load_s"] = _forms_load(
            copy, live, head, "compacted tail on the checkpoint")
        seg = base.log_segment
        _check(len(seg.compacted_deltas) == 1 and not seg.deltas,
               "compacted: the checkpoint load takes the tail's range")
        _ladder_idle(c_ck, "compacted: the checkpoint load")
        side = os.path.join(copy, "_aside")
        aside = _set_aside(log, side)
        snap, c_co, out["compacted_commit_only_load_s"] = _forms_load(
            copy, live, head, "compacted ranges, checkpoint set aside")
        seg = snap.log_segment
        _check(len(seg.compacted_deltas) == 2
               and len(seg.deltas) == head + 1 - (run_hi - run_lo + 1) - 9,
               "compacted: the commit-only load takes both ranges")
        del snap
        _put_back(log, side, aside)
        for k in _FORM_KERNELS:
            launches[k]["launches_compacted"] = (
                c_ck.get(_FORM_KERNELS[k], 0) + c_co.get(_FORM_KERNELS[k], 0))
        for k in ("byte_class", "winner_pack"):
            _check(c_ck.get(_FORM_KERNELS[k], 0) >= 1
                   and c_co.get(_FORM_KERNELS[k], 0) >= 1,
                   f"compacted: {k} launched on both loads")
        out["compacted_counters"] = {"checkpoint_load": c_ck,
                                     "commit_only_load": c_co}

        # V2 at the head (from that snapshot), cell 5's part size; a
        # reload through it alone
        info1, m1, out["v2_write_s"], _ = write(base, policy="v2")
        n_side = m1.parts - 1
        _check(n_side > 1 and info1.tag and info1.version == head,
               "v2: the write put the file actions in several sidecars")
        out["v2_write"] = {"sidecars": n_side, "rows": m1.rows,
                           "bytes": m1.bytes_written,
                           "phase_s": m1.phase_seconds}
        del base
        snap, c_v2, out["v2_reload_s"] = _forms_load(copy, live, head,
                                                     "v2 reload")
        seg = snap.log_segment
        _check(seg.is_v2 and not seg.deltas and not seg.compacted_deltas,
               "v2: the reload reads the V2 checkpoint alone")
        _check(c_v2.get("decode.device_parts", 0) == n_side
               and c_v2.get("decode.device_fallbacks", 0) == 0
               and c_v2.get(_FORM_KERNELS["hybrid_extract"], 0) == n_side
               and c_v2.get(_FORM_KERNELS["winner_pack"], 0) >= 1,
               f"v2: K3 once per sidecar and K2 ({c_v2})")
        _ladder_idle(c_v2, "v2 reload")
        out["v2_reload_phase_s"] = snap.state.phase_seconds
        out["v2_reload_handoff_launches"] = c_v2.get(
            "decode.handoff_launches", 0)
        rows = snap.state.file_actions.rows
        idx = np.flatnonzero(snap.state.live_mask.cpu().numpy())
        json_stats = sorted(zip(
            rows.paths(idx),
            (json.dumps(json.loads(x), separators=(",", ":"))
             for x in rows.stats(idx))))
        for k in _FORM_KERNELS:
            launches[k]["launches_v2"] = c_v2.get(_FORM_KERNELS[k], 0)
        del snap

        # two more commits, a second V2 write reusing the first's parts
        live2, _ = _append_adds(log, live, head + 1, 2,
                                len(truth.live_paths) * 2, 23)
        snap = Table.for_path(copy, engine=TorchEngine()).latest_snapshot()
        info2, m2, out["v2_rewrite_s"], c_w2 = write(
            snap, policy="v2", prev_info=read_last_checkpoint(
                TorchEngine().fs, log))
        written = m2.parts - m2.parts_reused - 1
        out["v2_rewrite"] = {"reused": m2.parts_reused, "written": written,
                             "bytes": m2.bytes_written,
                             "phase_s": m2.phase_seconds}
        print(f"v2 rewrite: {m2.parts_reused} sidecars reused, {written} "
              f"written", flush=True)
        _check(m2.parts_reused > written,
               "v2: most sidecars reused by the second write")
        del snap
        old = {e["name"] for e in info1.partManifest["parts"]}
        fresh = [e["name"] for e in info2.partManifest["parts"]
                 if e["name"] not in old]
        os.remove(os.path.join(filenames.sidecar_dir(log), fresh[-1]))
        snap, c_fb, out["v2_fallback_load_s"] = _forms_load(
            copy, live2, head + 2, "v2: a vanished sidecar")
        _check(c_fb.get("snapshot.checkpoint_fallbacks", 0) == 1
               and snap.log_segment.checkpoint_version == head,
               "v2: a vanished sidecar falls back once, to the first V2")
        del snap
        os.remove(os.path.join(log, info2.tag))

        # stats_parsed: a struct-only checkpoint, its reload, five scans
        snap = Table.for_path(copy, engine=TorchEngine()).latest_snapshot()
        meta = snap.metadata.to_dict()
        meta["configuration"] = {
            **meta["configuration"],
            "delta.checkpoint.writeStatsAsStruct": "true",
            "delta.checkpoint.writeStatsAsJson": "false"}
        with open(filenames.delta_file(log, head + 3), "w") as f:
            f.write(json.dumps({"metaData": meta}) + "\n")
        del snap
        snap = Table.for_path(copy, engine=TorchEngine()).latest_snapshot()
        info3, m3, out["struct_write_s"], _ = write(snap)
        out["struct_write"] = {"parts": m3.parts, "bytes": m3.bytes_written,
                               "phase_s": m3.phase_seconds}
        del snap
        snap, c_sp, out["struct_reload_s"] = _forms_load(
            copy, live2, head + 3, "struct-only reload")
        _check(snap.log_segment.checkpoint_version == head + 3
               and c_sp.get("decode.device_parts", 0) == m3.parts
               and c_sp.get("decode.device_fallbacks", 0) == 0,
               "stats_parsed: the reload decodes every part on the card")
        state = snap.state
        out["struct_reload_phase_s"] = state.phase_seconds
        rows = state.file_actions.rows
        ck = [st for st in getattr(rows, "stores", [rows])
              if isinstance(st, CheckpointRows)]
        _check(len(ck) == 1 and all(
            p.data is not None for p in ck[0].parts if len(p.add_rows)),
            "stats_parsed: every part's adds carry stats only as structs, "
            "so the stats below come from stats_parsed")
        t0 = time.perf_counter()
        idx = np.flatnonzero(state.live_mask.cpu().numpy())
        got = sorted(zip(state.file_actions.rows.paths(idx),
                         state.file_actions.rows.stats(idx)))
        out["struct_stats_s"] = time.perf_counter() - t0
        both = set(live) & set(live2)
        sha = hashlib.sha256("\n".join(
            f"{p}\t{s}" for p, s in got if p in both).encode()).hexdigest()
        want = hashlib.sha256("\n".join(
            f"{p}\t{s}" for p, s in json_stats
            if p in both).encode()).hexdigest()
        _check(len(got) == len(live2) and sha == want
               and all(s is not None for _, s in got),
               "stats_parsed: the re-serialized stats equal the JSON "
               "stats (sha256 of the sorted path/stats lines)")
        fids = _fids(live2)
        for name, pred, want_mask in _scan_cases(fids):
            t0 = time.perf_counter()
            paths = snap.scan(filter=pred).file_paths()
            torch.cuda.synchronize()
            out[f"struct_scan_{name}_s"] = time.perf_counter() - t0
            _check(np.array_equal(np.sort(_fids(paths)),
                                  np.sort(fids[want_mask])),
                   f"stats_parsed scan {name}: the generator's survivors")
        c_sp = obs.counters()
        _check(c_sp.get(_FORM_KERNELS["skip_mask"], 0) == 5
               and c_sp.get("scan.device_plans", 0) == 5,
               "stats_parsed: one K7 launch per filter")
        out["struct_index_build_s"] = sum(
            state.stats_index.phase_seconds.values())
        out["struct_index_phase_s"] = dict(state.stats_index.phase_seconds)
        for k in _FORM_KERNELS:
            launches[k]["launches_stats_parsed"] = c_sp.get(
                _FORM_KERNELS[k], 0)
        _check(all(launches[k]["launches_stats_parsed"] >= 1
                   for k in ("winner_pack", "hybrid_extract", "skip_mask")),
               "stats_parsed: K2, K3 and K7 launched")
        del snap, state, got

        # metadata cleanup under a clock 31 days ahead
        table = Table.for_path(copy, engine=TorchEngine())
        n_side_before = len(os.listdir(filenames.sidecar_dir(log)))
        deleted, out["cleanup_s"] = timed(lambda: cleanup_expired_logs(
            table, now_ms=int(time.time() * 1000) + 31 * 86_400_000))
        out["cleanup_deleted"] = len(deleted)
        print(f"cleanup deleted {len(deleted)} files, e.g. "
              f"{[os.path.basename(p) for p in deleted[:3]]}", flush=True)
        _check(len(deleted) >= head and len(os.listdir(
            filenames.sidecar_dir(log))) == n_side_before,
            "cleanup: every commit below the checkpoint, no sidecar")
        snap, _, out["after_cleanup_load_s"] = _forms_load(
            copy, live2, head + 3, "after cleanup")
        del snap
        try:
            Table.for_path(copy, engine=TorchEngine()).snapshot_at(head // 2)
            _check(False, "cleanup: snapshot_at of a deleted version")
        except TableNotFoundError as e:
            _check(e.error_class == "DELTA_NO_COMMITS_FOUND",
                   "cleanup: a deleted version raises as the reference")

        # C6: an int64 past 2^53 beside a float literal keeps both files
        c6 = os.path.join(copy + "_c6")
        for k in ([1, 2], [2 ** 53 + 1, 2 ** 53 + 3]):
            write_table(c6, {"k": np.array(k, np.int64)},
                        engine=TorchEngine())
        kept = Table.for_path(c6, engine=TorchEngine()).latest_snapshot() \
            .scan(filter=col("k") < lit(1.5)).file_paths()
        _check(len(kept) == 2, "C6: k < 1.5 keeps both files")
    finally:
        shutil.rmtree(copy, ignore_errors=True)
        shutil.rmtree(copy + "_c6", ignore_errors=True)
    return out, launches


FORMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "torch_fixtures", "parquet_forms")


def forms_digests(batch) -> dict:
    """{column: [sha256 of the validity bytes, sha256 of the valid values]}
    of a `read_data_file` Batch: long, integer, date (days) and timestamp
    (microseconds) as int64, double and float as their raw bytes, booleans
    as bytes, strings as [u32 length][UTF-8] each; the form
    `tests/test_torch_parquet_forms.py::arrow_digests` gives Arrow's
    read."""
    out = {}
    for name in batch.column_names:
        col = batch.column(name)
        valid = (np.ones(batch.num_rows, bool) if col.valid is None
                 else col.valid)
        v = col.values[valid]
        if v.dtype == object:
            payload = b"".join(len(b).to_bytes(4, "little") + b
                               for b in (x.encode() for x in v))
        elif v.dtype.kind in "iM":
            payload = v.astype(np.int64).tobytes()
        elif v.dtype == bool:
            payload = v.astype(np.uint8).tobytes()
        else:
            payload = v.tobytes()
        out[name] = [hashlib.sha256(valid.astype(np.uint8).tobytes())
                     .hexdigest(), hashlib.sha256(payload).hexdigest()]
    return out


def _largest_zstd_page(data: bytes, best: tuple) -> tuple:
    """(payload, its uncompressed size) of the largest ZSTD v1 page of a
    file, or `best` when that is larger."""
    from delta_tpu_torch.log.page_decode import _PAGE_DATA_V2, split_pages
    from delta_tpu_torch.log.parquet_footer import read_footer

    ft = read_footer(data)
    for rg, group in enumerate(ft.row_groups):
        for col, meta in enumerate(group.columns):
            chunk, codec = ft.chunk(data, rg, col)
            if codec != "ZSTD":
                continue
            for page in split_pages(chunk, meta.num_values):
                if page.type != _PAGE_DATA_V2 and \
                        page.uncompressed_size > best[1]:
                    best = (chunk[page.payload_start:page.payload_start
                                  + page.compressed_size],
                            page.uncompressed_size)
    return best


def _mb_per_s(fn, nbytes: int) -> float:
    fn()
    reps, t0 = 0, time.perf_counter()
    while reps < 5 or time.perf_counter() - t0 < 0.5:
        fn()
        reps += 1
    return nbytes * reps / (time.perf_counter() - t0) / 1e6


def parquet_forms_phase(root: str, device: str, card: str) -> dict:
    """Step 18: the fixtures' digests, the fixture logs' live files and
    routes (K3 once per device part on a card), and the host decoders'
    MB/s."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.log import snappy, zstd
    from delta_tpu_torch.log.parquet_data import read_data_file

    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    largest = (b"", 0)
    t0 = time.perf_counter()
    for name, want in sorted(manifest["files"].items()):
        with open(os.path.join(root, name), "rb") as f:
            data = f.read()
        _check(forms_digests(read_data_file(data)) == want,
               f"parquet_forms {name}: digests equal the manifest")
        largest = _largest_zstd_page(data, largest)
    files_s = time.perf_counter() - t0
    logs = {}
    work = tempfile.mkdtemp(prefix="parquet_forms_")
    try:
        for name, want in sorted(manifest["logs"].items()):
            copy = os.path.join(work, name)
            shutil.copytree(os.path.join(root, name), copy)
            obs.reset()
            t0 = time.perf_counter()
            state = Table.for_path(copy, engine=TorchEngine(device)) \
                .latest_snapshot().state
            load_s = time.perf_counter() - t0
            counts = obs.counters()
            live = sorted(a.path for a in state.add_files)
            k3 = counts.get("kernel.hybrid_extract.launches", 0)
            _check(state.version == want["version"] and len(live) ==
                   want["live_files"] and hashlib.sha256(
                       "\n".join(live).encode()).hexdigest() ==
                   want["live_sha256"],
                   f"parquet_forms {name}: live files equal the manifest")
            for key in ("device_parts", "device_fallbacks"):
                _check(counts.get(f"decode.{key}", 0) == want[key],
                       f"parquet_forms {name}: decode.{key} == {want[key]}")
            _check(k3 == (want["device_parts"] if device != "cpu" else 0),
                   f"parquet_forms {name}: K3 once per device part")
            logs[name] = {"load_s": load_s, "k3": k3,
                          "device_parts": want["device_parts"],
                          "device_fallbacks": want["device_fallbacks"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    payload, size = largest
    _check(size > 0, "parquet_forms: a ZSTD page to time")
    raw = zstd.decompress(payload, size)
    packed = snappy.compress(raw)
    return {"files": len(manifest["files"]), "files_s": files_s,
            "logs": logs, "k3_launches": sum(v["k3"] for v in logs.values()),
            "timed_bytes": size, "zstd_payload_bytes": len(payload),
            "snappy_payload_bytes": len(packed),
            "zstd_mb_s": _mb_per_s(lambda: zstd.decompress(payload, size),
                                   size),
            "snappy_mb_s": _mb_per_s(
                lambda: snappy.decompress(packed, size), size),
            "card": card}


WIDE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "torch_fixtures", "wide_types")
# links of each store_sales fixture file: 4 files x 6,000 rows x 120 =
# 2,880,000 rows in 480 adds, SF1's 2,880,404 to whole files
WIDE_LINKS = 120
# the reads of `tests/test_torch_wide_types.py::ss_reads`, kept here for
# the card's machine (no Arrow, no test module): name -> (columns,
# conjuncts); the range is the DV'd file's quarter of the sold dates
WIDE_RANGE = (2451273, 2451730)
WIDE_READS = {
    "q3": (["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"], []),
    "range": (["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
              [("ss_sold_date_sk", ">=", WIDE_RANGE[0]),
               ("ss_sold_date_sk", "<", WIDE_RANGE[1])]),
    "profit": (["ss_item_sk", "ss_net_profit"],
               [("ss_net_profit", ">", "Decimal:0.00")]),
    "all": (None, []),
}
WIDE_NESTED_READS = {"all": None, "projected": ["k", "aos", "mal", "d38"]}


def _wide_filter(spec):
    import decimal

    from delta_tpu_torch.expressions import tree

    out = None
    for c, op, v in spec:
        if isinstance(v, str) and v.startswith("Decimal:"):
            v = decimal.Decimal(v.split(":", 1)[1])
        e = tree.Comparison(op, tree.col(c), tree.lit(v))
        out = e if out is None else tree.And(out, e)
    return out


def wide_sums(batch) -> dict:
    """{column: [valid count, sum mod 2^64, sum of squares mod 2^64]} of
    an integer or decimal Batch's values (decimals unscaled): additive
    over linked copies of a file; the form
    `tests/test_torch_wide_types.py::arrow_sums` gives Arrow's read."""
    out = {}
    for name in batch.column_names:
        c = batch.column(name)
        v = c.values if c.valid is None else c.values[c.valid]
        u = np.asarray(v, np.int64).view(np.uint64)
        out[name] = [int(u.shape[0]), int(u.sum(dtype=np.uint64)),
                     int((u * u).sum(dtype=np.uint64))]
    return out


def wide_rows_digest(batch) -> str:
    """sha256 of the sorted reprs of a Batch's rows as Python values
    (`Column.to_python()`), as `tests/test_torch_wide_types.py::
    rows_digest` gives Arrow's."""
    cols = [batch.column(c).to_python() for c in batch.column_names]
    return hashlib.sha256("\n".join(sorted(
        repr(tuple(r)) for r in zip(*cols))).encode()).hexdigest()


def _wide_table(root: str, work: str, links: int) -> str:
    """store_sales at `links` links of each fixture file: the files hard
    linked (copied where links fail) under new names, the DV file
    beside them, and one commit of the fixture's protocol and metaData
    and an add per link (its stats, its DV descriptor) written by hand,
    so that the read has 480 files without writing 2.88M rows (step 20
    writes them)."""
    from delta_tpu_torch import Table, TorchEngine

    src = os.path.join(root, "store_sales")
    dst = os.path.join(work, "store_sales")
    os.makedirs(os.path.join(dst, "_delta_log"))
    snap = Table.for_path(src, engine=TorchEngine("cpu")).latest_snapshot()
    for name in os.listdir(src):
        if name.startswith("deletion_vector"):
            _link_or_copy(os.path.join(src, name), os.path.join(dst, name))
    lines = [json.dumps({"protocol": snap.protocol.to_dict()}),
             json.dumps({"metaData": snap.metadata.to_dict()})]
    for add in sorted(snap.state.add_files, key=lambda a: a.path):
        stem = add.path[:-len(".parquet")]
        for j in range(links):
            name = f"{stem}-L{j:03d}.parquet"
            _link_or_copy(os.path.join(src, add.path),
                          os.path.join(dst, name))
            d = add.to_dict()
            d["path"] = name
            lines.append(json.dumps({"add": d}))
    with open(os.path.join(dst, "_delta_log", f"{0:020d}.json"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return dst


def wide_types_phase(root: str, device: str, card: str,
                     links: int = WIDE_LINKS, keep: dict = None) -> dict:
    """Step 19: TPC-DS store_sales (12 decimal(7,2) money columns, INT32
    in two files and FIXED_LEN_BYTE_ARRAY in two, one DV) at `links`
    links of each fixture file, loaded and read with `TorchEngine(device)`:
    q3's columns, a range of sold dates over one file's quarter (K7 keeps
    a quarter of the files), `ss_net_profit > 0` (a decimal filter), all
    23 columns; then the nested fixture table whole and projected. Each
    read's digests equal the manifest's, scaled by `links`; the load's K1
    and K2, and each read's K7 and K8 launches, are checked (0 on the
    CPU). `keep`, when given, receives the full read of store_sales
    ("all") and of the nested table ("nested"), step 20's input."""
    from delta_tpu_torch import Table, TorchEngine, obs

    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    card_run = device != "cpu"
    work = tempfile.mkdtemp(prefix="wide_types_")
    out = {"links": links, "card": card, "reads": {}}
    try:
        t0 = time.perf_counter()
        path = _wide_table(root, work, links)
        out["build_s"] = time.perf_counter() - t0
        n_files = manifest["store_sales"]["files"] * links
        obs.reset()
        t0 = time.perf_counter()
        snap = Table.for_path(path, engine=TorchEngine(device)) \
            .latest_snapshot()
        _check(len(snap.state.add_files) == n_files,
               f"wide_types: {n_files} live files")
        out["load_s"] = time.perf_counter() - t0
        counts = obs.counters()
        k1 = counts.get("kernel.byte_class.launches", 0)
        k2 = counts.get("kernel.winner_pack.launches", 0)
        _check((k1 >= 1 and k2 >= 1) if card_run else k1 == k2 == 0,
               "wide_types load: K1 and K2 launched")
        out["load_k1"], out["load_k2"] = k1, k2
        for name, (cols, spec) in WIDE_READS.items():
            want = manifest["store_sales"]["reads"][name]
            obs.reset()
            t0 = time.perf_counter()
            sc = snap.scan(filter=_wide_filter(spec) if spec else None,
                           columns=cols)
            files = len(sc.add_files())
            batch = sc.to_batch()
            s = time.perf_counter() - t0
            c = obs.counters()
            scaled = {k: [v[0] * links, v[1] * links % (1 << 64),
                          v[2] * links % (1 << 64)]
                      for k, v in want["sums"].items()}
            _check(batch.num_rows == want["rows"] * links and
                   files == want["files"] * links and
                   wide_sums(batch) == scaled,
                   f"wide_types {name}: digests equal the manifest's")
            k7 = c.get("kernel.skip_mask.launches", 0)
            k8 = c.get("kernel.dv_bits.decode_launches", 0)
            dvs = c.get("kernel.dv_bits.decode_dvs", 0)
            _check(k7 == (int(bool(spec)) if card_run else 0),
                   f"wide_types {name}: K7 launched once per filtered read")
            _check((k8, dvs) == ((1, links) if card_run else (0, 0)),
                   f"wide_types {name}: K8 once over the {links} DVs")
            _check(c.get("kernel.byte_class.launches", 0) == 0 and
                   c.get("kernel.winner_pack.launches", 0) == 0,
                   f"wide_types {name}: no reload")
            out["reads"][name] = {
                "rows": batch.num_rows, "files": files, "s": s,
                "rows_per_s": batch.num_rows / s,
                "columns": len(batch.column_names), "k7": k7, "k8": k8,
                "k8_dvs": dvs}
            if keep is not None and name == "all":
                keep["all"] = batch
        del snap, batch
        nested = Table.for_path(os.path.join(root, "nested"),
                                engine=TorchEngine(device)).latest_snapshot()
        for name, cols in WIDE_NESTED_READS.items():
            want = manifest["nested"]["reads"][name]
            t0 = time.perf_counter()
            batch = nested.scan(columns=cols).to_batch()
            s = time.perf_counter() - t0
            _check(batch.column_names == want["columns"] and
                   batch.num_rows == want["rows"] and
                   wide_rows_digest(batch) == want["sha256"],
                   f"wide_types nested {name}: rows equal the manifest's")
            out["reads"][f"nested_{name}"] = {
                "rows": batch.num_rows, "files": 2, "s": s,
                "rows_per_s": batch.num_rows / s,
                "columns": len(batch.column_names)}
            if keep is not None and name == "all":
                keep["nested"] = batch
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# step 20: TPC-DS's data maintenance of store_sales (v3 clause 5) on the
# port's own copy of step 19's rows: LF_SS inserts new sales, DF_SS
# deletes the sales of a date range
WIDE_WRITE_FILE_ROWS = 6_000  # rows per written file, the fixture's
# fixture ticket numbers are file * 60,000 + 1..~520: each copy's tickets
# renumbered to file * 10^6 + copy * 1,000 + the ticket's place in its
# file, so that (ss_item_sk, ss_ticket_number) is unique, as dsdgen's key
# is, and each quarter's tickets are contiguous
WIDE_TICKET_FILE = 60_000
WIDE_TICKETS = (1_000_000, 1_000)
# DF_SS's range: the first 90% of quarter 2's sold dates, > 4,096 of each
# of its files' 6,000 rows: DVs of bitmap containers (K8 packs)
WIDE_DELETE_RANGE = (2451730, 2452141)
WIDE_LAST_QUARTER = (2452187, 2452643)  # quarter 3: LF_SS's new sales
WIDE_MERGE_SHARE = 0.01      # the MERGE source: 1% of the live rows
WIDE_NEW_TICKET = 4_000_000  # LF_SS's new tickets: past every quarter's
WIDE_COUPON = "1.23"         # UPDATE's decimal SET
WIDE_ZORDER = ("ss_customer_sk", "ss_item_sk")
WIDE_WRITE_PROPS = {"delta.enableDeletionVectors": "true",
                    "delta.checkpoint.writeStatsAsStruct": "true"}
WIDE_WRITE_K = {"k1": "kernel.byte_class.launches",
                "k2": "kernel.winner_pack.launches",
                "k3": "kernel.hybrid_extract.launches",
                "k4": "kernel.interleave_bits.launches",
                "k5": "kernel.unpack_bitpacked.launches",
                "k6": "kernel.segmented_minmax.launches",
                "k7": "kernel.skip_mask.launches",
                "k8_pack": "kernel.dv_bits.pack_launches",
                "k8_decode": "kernel.dv_bits.decode_launches",
                "k9": "kernel.merge_join.launches"}


def _renumber_tickets(item: np.ndarray, ticket: np.ndarray) -> np.ndarray:
    """Each linked copy's tickets made its own (WIDE_TICKETS): a row's
    copy is its place among the rows of equal (item, ticket)."""
    n = len(ticket)
    order = np.lexsort((np.arange(n), ticket, item))
    key = item[order].astype(np.int64) * (1 << 32) + ticket[order]
    starts = np.r_[0, np.flatnonzero(np.diff(key)) + 1]
    occ = np.arange(n) - np.repeat(starts, np.diff(np.r_[starts, n]))
    copy = np.empty(n, np.int64)
    copy[order] = occ
    quarter, place = np.divmod(ticket.astype(np.int64), WIDE_TICKET_FILE)
    return quarter * WIDE_TICKETS[0] + copy * WIDE_TICKETS[1] + place


class _WideModel:
    """store_sales as numpy: each column's int64 lanes (decimals
    unscaled) and validity, and which rows are live."""

    def __init__(self, batch):
        self.names = batch.column_names
        self.types = {c: batch.column(c).data_type for c in self.names}
        self.dtypes = {c: batch.column(c).values.dtype for c in self.names}
        self.v = {c: np.asarray(batch.column(c).values, np.int64).copy()
                  for c in self.names}
        self.ok = {c: (np.ones(batch.num_rows, bool)
                       if batch.column(c).valid is None
                       else batch.column(c).valid.copy())
                   for c in self.names}
        self.alive = np.ones(batch.num_rows, bool)

    def sums(self, names=None) -> dict:
        """`wide_sums` of the live rows."""
        out = {}
        for c in names or self.names:
            u = self.v[c][self.alive & self.ok[c]].view(np.uint64)
            out[c] = [int(u.shape[0]), int(u.sum(dtype=np.uint64)),
                      int((u * u).sum(dtype=np.uint64))]
        return out

    def keys(self) -> np.ndarray:
        return self.v["ss_item_sk"] * (1 << 32) + self.v["ss_ticket_number"]

    def batch(self, idx):
        from delta_tpu_torch.models.batch import Batch, Column

        return Batch({c: Column(self.v[c][idx].astype(self.dtypes[c]),
                                self.ok[c][idx].copy(), self.types[c])
                      for c in self.names}, len(idx))

    def append(self, batch) -> None:
        for c in self.names:
            col = batch.column(c)
            self.v[c] = np.r_[self.v[c], np.asarray(col.values, np.int64)]
            self.ok[c] = np.r_[self.ok[c], np.ones(batch.num_rows, bool)
                               if col.valid is None else col.valid]
        self.alive = np.r_[self.alive, np.ones(batch.num_rows, bool)]


def _wide_merge_source(model, rng, profit_column: str = "ss_net_profit",
                       new_ticket: int = WIDE_NEW_TICKET):
    """LF_SS's rows: 1% of the live rows, half of them live rows of the
    last quarter with a new quantity and a profit 1.00 higher (matched),
    half new sales on new tickets in the last quarter's dates, their other
    columns those of last-quarter rows (inserted). Returns (source batch,
    the matched rows' model indexes)."""
    from delta_tpu_torch.models.batch import Batch, Column

    n = int(round(model.alive.sum() * WIDE_MERGE_SHARE)) // 2
    date = model.v["ss_sold_date_sk"]
    last = np.flatnonzero(model.alive & model.ok["ss_sold_date_sk"]
                          & (date >= WIDE_LAST_QUARTER[0]))
    hit = np.sort(rng.choice(last, n, replace=False))
    like = rng.choice(last, n)
    cols = {}
    for c in model.names:
        v = np.r_[model.v[c][hit], model.v[c][like]]
        ok = np.r_[model.ok[c][hit], model.ok[c][like]]
        cols[c] = [v, ok]
    cols["ss_quantity"] = [rng.integers(1, 101, 2 * n), np.ones(2 * n, bool)]
    profit = cols[profit_column]
    profit[0][:n] += 100
    profit[1][:n] = True
    cols["ss_ticket_number"][0][n:] = new_ticket + np.arange(n)
    cols["ss_sold_date_sk"] = [np.r_[date[hit], rng.integers(
        *WIDE_LAST_QUARTER, n)], np.ones(2 * n, bool)]
    src = Batch({c: Column(v.astype(model.dtypes[c]),
                           None if ok.all() else ok, model.types[c])
                 for c, (v, ok) in cols.items()}, 2 * n)
    return src, hit


def _loaded(path: str, eng):
    """A fresh Table's latest snapshot with its state loaded."""
    from delta_tpu_torch import Table

    snap = Table.for_path(path, engine=eng).latest_snapshot()
    snap.state
    return snap


def _stepper(out: dict, eng, what: str):
    """A runner of timed steps: each step's counters from 0 just before
    it and read just after (kept in `step.counts`), its seconds, rows/s
    and kernel launches (`WIDE_WRITE_K`) in `out["steps"]`; each launch
    count named in `expect` as (at least, exactly or None) on the card,
    0 on the CPU."""
    from delta_tpu_torch import obs

    card_run = eng.device.type != "cpu"

    def step(name, rows, fn, **expect):
        eng.synchronize()
        obs.reset()
        t0 = time.perf_counter()
        result = fn()
        eng.synchronize()
        seconds = time.perf_counter() - t0
        counts = step.counts = obs.counters()
        _ladder_idle(counts, f"{what} {name}")
        got = {k: counts.get(v, 0) for k, v in WIDE_WRITE_K.items()}
        for k, (at_least, exactly) in expect.items():
            ok = (got[k] >= at_least if exactly is None else
                  got[k] == exactly) if card_run else got[k] == 0
            _check(ok, f"{what} {name}: {k} {got[k]}, expected "
                   f"{exactly if exactly is not None else f'>= {at_least}'}")
        out["steps"][name] = dict(got, s=seconds, rows=rows,
                                  rows_per_s=rows / seconds)
        return result

    step.counts = {}
    return step


def wide_write_phase(batch, nested, root: str, device: str, card: str,
                     links: int = WIDE_LINKS, keep: dict = None) -> dict:
    """Step 20: the wider types through every write path on the card.
    `batch` is step 19's full read of store_sales (`links` links of each
    fixture file), `nested` its read of the nested fixture. Each step's
    counters from 0, its rows against `_WideModel`:
    1. `write_table` in files of 6,000 rows (tickets renumbered per
       copy), a reload and a read of all 23 columns: the manifest's sums
       times `links` (the tickets the model's); K1, K2 on the reload;
    2. DELETE of WIDE_DELETE_RANGE's sold dates (DF_SS): K7 keeps the
       files whose stats overlap the range, K8 packs once;
    3. UPDATE of one ticket's `ss_coupon_amt` (a decimal SET);
    4. MERGE on (ss_item_sk, ss_ticket_number) of a 1% source (LF_SS):
       half updated, half inserted; K9 once;
    5. OPTIMIZE ZORDER BY (ss_customer_sk, ss_item_sk) of the last
       quarter: K4 once;
    6. a checkpoint with struct stats, a reload (K3 once per part), a read
       with `ss_net_profit > 0` and a read of every column;
    7. the nested fixture written back by the port, read equal to the
       manifest's digest.
    Returns each step's seconds, rows/s and launches. With `keep`, the
    table stays on disk for step 21, and `keep` gets its path, its work
    directory (the caller removes it), the model, the files step 6's
    profit read kept and step 19's rows."""
    import decimal

    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.commands.dml import delete, update
    from delta_tpu_torch.commands.merge import merge
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.models.batch import Batch, Column

    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    eng = TorchEngine(device)
    work = tempfile.mkdtemp(prefix="wide_write_")
    path = os.path.join(work, "store_sales")
    n0 = batch.num_rows
    cols = dict(batch.columns)
    cols["ss_ticket_number"] = Column(_renumber_tickets(
        batch.column("ss_item_sk").values,
        batch.column("ss_ticket_number").values))
    src = Batch(cols, n0)
    model = _WideModel(src)
    _check(len(np.unique(model.keys())) == n0,
           "wide_write: (ss_item_sk, ss_ticket_number) unique")
    want = manifest["store_sales"]["reads"]["all"]["sums"]
    scaled = {k: [v[0] * links, v[1] * links % (1 << 64),
                  v[2] * links % (1 << 64)] for k, v in want.items()}
    scaled["ss_ticket_number"] = model.sums(["ss_ticket_number"])[
        "ss_ticket_number"]
    _check(model.sums() == scaled, "wide_write: the model is the manifest's")
    out = {"rows": n0, "links": links, "card": card, "steps": {}}
    step = _stepper(out, eng, "wide_write")

    def held(read, names, what):
        _check(read.num_rows == int(model.alive.sum())
               and wide_sums(read) == model.sums(names),
               f"wide_write {what}: rows equal the model's")

    try:
        # 1. the write, a reload, every column
        step("write", n0, lambda: write_table(
            path, src, engine=eng, properties=WIDE_WRITE_PROPS,
            target_rows_per_file=WIDE_WRITE_FILE_ROWS))
        table = Table.for_path(path, engine=eng)
        n_files = -(-n0 // WIDE_WRITE_FILE_ROWS)
        snap = step("reload", n0, lambda: _loaded(path, eng),
                    k1=(1, None), k2=(1, None))
        _check(len(snap.state.add_files) == n_files,
               f"wide_write: {n_files} files written")
        got = step("read_all", n0, lambda: read_table(path, engine=eng))
        _check(wide_sums(got) == scaled,
               "wide_write read_all: the manifest's sums times the links")
        del got, snap
        # 2. DF_SS: the sales of a date range
        date, date_ok = model.v["ss_sold_date_sk"], model.ok["ss_sold_date_sk"]
        lo, hi = WIDE_DELETE_RANGE
        in_range = date_ok & (date >= lo) & (date < hi)
        kept = 0
        for f in range(n_files):
            r = slice(f * WIDE_WRITE_FILE_ROWS, (f + 1) * WIDE_WRITE_FILE_ROWS)
            d = date[r][date_ok[r]]
            kept += int(len(d) == 0 or (d.max() >= lo and d.min() < hi))
        m = step("delete", int(in_range.sum()), lambda: delete(
            table, (col("ss_sold_date_sk") >= lit(lo))
            & (col("ss_sold_date_sk") < lit(hi))),
            k7=(1, 1), k8_pack=(1, 1))
        _check(m.num_files_scanned == kept
               and m.num_rows_deleted == int(in_range.sum()),
               f"wide_write delete: K7 kept {m.num_files_scanned} of "
               f"{n_files} files (the stats give {kept}); "
               f"{m.num_rows_deleted} rows")
        model.alive &= ~in_range
        out["steps"]["delete"].update(files_kept=kept, dvs=m.num_dvs_written)
        names = ["ss_sold_date_sk", "ss_ticket_number"]
        held(read_table(path, columns=names, engine=eng), names,
             "delete")
        # 3. a decimal SET on one ticket
        live_q3 = np.flatnonzero(model.alive & date_ok
                                 & (date >= WIDE_LAST_QUARTER[0]))
        ticket = int(model.v["ss_ticket_number"][live_q3[0]])
        hit = model.alive & (model.v["ss_ticket_number"] == ticket)
        m = step("update", int(hit.sum()), lambda: update(
            table, {"ss_coupon_amt": lit(decimal.Decimal(WIDE_COUPON))},
            col("ss_ticket_number") == lit(ticket)), k7=(1, 1))
        _check(m.num_rows_updated == int(hit.sum()),
               f"wide_write update: {m.num_rows_updated} rows")
        model.v["ss_coupon_amt"][hit] = int(
            decimal.Decimal(WIDE_COUPON).scaleb(2))
        model.ok["ss_coupon_amt"][hit] = True
        names = ["ss_ticket_number", "ss_coupon_amt"]
        held(read_table(path, columns=names, engine=eng), names, "update")
        # 4. LF_SS: MERGE a 1% source on the table's key
        source, matched = _wide_merge_source(model, np.random.default_rng(20))
        half = len(matched)
        m = step("merge", source.num_rows, lambda: merge(
            table, source, on=(col("target.ss_item_sk")
                               == col("source.ss_item_sk"))
            & (col("target.ss_ticket_number")
               == col("source.ss_ticket_number")))
            .when_matched_update_all().when_not_matched_insert_all()
            .execute(), k9=(1, 1))
        _check((m.num_target_rows_updated, m.num_target_rows_inserted)
               == (half, half),
               f"wide_write merge: {m.num_target_rows_updated} updated, "
               f"{m.num_target_rows_inserted} inserted of {half} each")
        model.alive[matched] = False
        model.append(source)
        names = ["ss_item_sk", "ss_ticket_number", "ss_quantity",
                 "ss_net_profit", "ss_sold_date_sk"]
        held(read_table(path, columns=names, engine=eng), names, "merge")
        out["steps"]["merge"]["files_rewritten"] = \
            m.num_target_files_rewritten
        # 5. OPTIMIZE ZORDER BY of the last quarter
        last = model.alive & model.ok["ss_sold_date_sk"] & (
            model.v["ss_sold_date_sk"] >= WIDE_LAST_QUARTER[0])
        m = step("optimize_zorder", int(last.sum()), lambda: table.optimize()
                 .where(col("ss_sold_date_sk") >= lit(WIDE_LAST_QUARTER[0]))
                 .execute_zorder_by(*WIDE_ZORDER), k4=(1, 1))
        out["steps"]["optimize_zorder"].update(
            files_removed=m.num_files_removed, files_added=m.num_files_added)
        # 6. a checkpoint of struct stats, its reload, reads
        step("checkpoint", 0, lambda: Table.for_path(
            path, engine=eng).checkpoint())
        parts = [n for n in os.listdir(os.path.join(path, "_delta_log"))
                 if ".checkpoint." in n]
        snap = step("checkpoint_reload", 0, lambda: _loaded(path, eng),
                    k3=(len(parts), len(parts)))
        _check(len(parts) >= 1 and snap.state.add_files,
               "wide_write: the checkpoint reloads")
        profit = model.v["ss_net_profit"]
        pos = model.alive & model.ok["ss_net_profit"] & (profit > 0)
        names = ["ss_item_sk", "ss_net_profit"]
        profit_scan = snap.scan(
            filter=col("ss_net_profit") > lit(decimal.Decimal("0.00")),
            columns=names)
        got = step("read_profit", int(pos.sum()), profit_scan.to_batch,
                   k7=(1, 1))
        profit_files = sorted(profit_scan.file_paths())
        alive = model.alive
        model.alive = pos
        held(got, names, "read_profit")
        model.alive = alive
        got = step("read_all_after", int(alive.sum()),
                   lambda: snap.scan().to_batch())
        held(got, None, "read_all_after")
        del got, snap
        # 7. the nested fixture, written back
        npath = os.path.join(work, "nested")
        step("nested_write", nested.num_rows, lambda: write_table(
            npath, nested, engine=eng))
        got = read_table(npath, engine=eng)
        _check(wide_rows_digest(got) == manifest["nested"]["reads"]["all"][
            "sha256"], "wide_write nested: rows equal the manifest's")
        out["steps"]["nested_write"]["files"] = 1
        if keep is not None:
            keep.update(path=path, work=work, model=model,
                        profit_files=profit_files, step19=batch)
    finally:
        if keep is None or "work" not in keep:
            shutil.rmtree(work, ignore_errors=True)
    return out


# step 21: column mapping and ALTER TABLE's column operations on step 20's
# store_sales, then a fresh name-mode table partitioned as spark-sql-perf
# partitions store_sales (by ss_sold_date_sk)
CM_MODE = {"delta.columnMapping.mode": "name"}
CM_RENAME = ("ss_net_profit", "ss_profit")
CM_DROP = "ss_coupon_amt"
CM_ADD = "ss_channel"
CM_DELETE_BELOW = "-4000.00"  # the DELETE: ss_profit under this
CM_APPEND_ROWS = 1_000        # rows appended after the checkpoint
CM_MERGE_TICKET = 5_000_000   # step 21's LF_SS tickets: past step 20's
CM_NEW_TICKET = 6_000_000     # the appended rows' tickets
CM_FIRST_QUARTER = (2450816, 2451273)  # step 19's file 0 of sold dates
CM_PRUNE_RANGE = (2450816, 2450846)    # its first 30 dates
CM_PARTITION = "ss_sold_date_sk"
CM_PARTITION_RENAMED = "ss_sold_date"


def _data_file_facts(path: str) -> dict:
    """(size, mtime in ns, crc32) of every data file under a table."""
    import zlib

    out = {}
    for root, _, names in os.walk(path):
        if "_delta_log" in root:
            continue
        for n in names:
            if n.endswith(".parquet"):
                p = os.path.join(root, n)
                with open(p, "rb") as f:
                    crc = zlib.crc32(f.read())
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns, crc)
    return out


def _model_rename(model, old: str, new: str) -> None:
    for d in (model.v, model.ok, model.types, model.dtypes):
        d[new] = d.pop(old)
    model.names = [new if c == old else c for c in model.names]


def _model_drop(model, name: str) -> None:
    for d in (model.v, model.ok, model.types, model.dtypes):
        d.pop(name)
    model.names = [c for c in model.names if c != name]


def _footer_leaf_paths(path: str) -> list:
    """The name path of every leaf of a Parquet file's schema."""
    from delta_tpu_torch.log.parquet_footer import read_footer

    with open(path, "rb") as f:
        return [leaf.parts for leaf in read_footer(f.read()).leaves]


def _footer_names(path: str) -> set:
    """Every field name of a data file's Parquet schema, at every depth."""
    return {p for parts in _footer_leaf_paths(path) for p in parts}


def _channels_held(got, model, channel, what: str) -> None:
    """The read's ss_channel, row by row on the key (ss_item_sk,
    ss_ticket_number), equals the model's: null outside the updated,
    merged and appended rows."""
    key = (got.column("ss_item_sk").values.astype(np.int64) * (1 << 32)
           + got.column("ss_ticket_number").values)
    col = got.column(CM_ADD)
    ok = (np.ones(got.num_rows, bool) if col.valid is None
          else col.valid)
    have = sorted(zip(key[ok].tolist(), col.values[ok].tolist()))
    live = model.alive
    mk = model.keys()[live]
    mc = channel[live]
    set_ = np.array([c is not None for c in mc], bool)
    want = sorted(zip(mk[set_].tolist(), mc[set_].tolist()))
    _check(have == want and int((~ok).sum()) == int((~set_).sum()),
           f"column_mapping {what}: {CM_ADD} equals the model's "
           f"({len(have)} set, {int((~ok).sum())} null)")


def column_mapping_phase(kept: dict, device: str, card: str,
                         keep: dict = None) -> dict:
    """Step 21: column mapping and ALTER TABLE's column operations on the
    card. `kept` is step 20's table at its end (`wide_write_phase`'s
    `keep`). Each step's counters from 0, its rows against step 20's
    numpy model carried through the renames:
    (a) 1. `set_properties` to mode `name`: the protocol lists
       columnMapping, no data file's bytes or mtime change, each field's
       physical name is its name; 2. a reload (K3 per part, K1, K2 on the
       tail); 3. RENAME ss_net_profit TO ss_profit, 4. DROP ss_coupon_amt,
       5. ADD ss_channel string, each through the commit handoff (K1);
       6. `ss_profit > 0` (K7): the files step 20's read of
       `ss_net_profit > 0` kept, the same rows; 7. DELETE `ss_profit <
       -4000.00` (K7, K8 packs the union with DF_SS's bitmaps); 8. an
       UPDATE setting ss_channel (K7); 9. LF_SS's 1% MERGE on the key,
       setting ss_profit and ss_channel (K9); 10. ZORDER BY ss_profit of
       the last quarter (K4), its file holding the physical names; 11. a
       `stats_parsed` checkpoint (leaves by physical name), an append, a
       reload (K3 per part, K1, K2), the profit read again (K7) and a
       full read: no ss_coupon_amt, ss_channel null outside the updated,
       merged and appended rows;
    (b) step 19's first quarter of sold dates written afresh in mode
       `name`, partitioned by ss_sold_date_sk (nulls in
       `__HIVE_DEFAULT_PARTITION__`): footers of `col-` names only,
       partitionValues keyed by the physical name, a 30-date read that
       prunes partitions, and after renaming the partition column the
       same read by the new name: the same files and rows.
    Returns each step's seconds, rows/s and launches. With `keep`, both
    tables stay on disk for step 22 (in `kept["work"]`, which the caller
    removes): `keep["a"]` holds (a)'s path, model and ss_channel values,
    `keep["b"]` (b)'s path and model under the partition column's new
    name."""
    import decimal

    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.commands import alter
    from delta_tpu_torch.commands.dml import delete, update
    from delta_tpu_torch.commands.merge import merge
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.models.batch import Batch, Column
    from delta_tpu_torch.models.schema import StructField

    eng = TorchEngine(device)
    path, model = kept["path"], kept["model"]
    out = {"rows": int(model.alive.sum()), "card": card, "steps": {}}
    step = _stepper(out, eng, "column_mapping")
    channel = np.full(len(model.alive), None, object)
    log = os.path.join(path, "_delta_log")

    def held(read, names, what, alive=None):
        live = model.alive if alive is None else alive
        saved, model.alive = model.alive, live
        try:
            _check(read.num_rows == int(live.sum())
                   and wide_sums(Batch({c: read.column(c) for c in names},
                                       read.num_rows)) == model.sums(names),
                   f"column_mapping {what}: rows equal the model's")
        finally:
            model.alive = saved

    def load():
        snap = table.latest_snapshot()
        snap.state
        return snap

    # (a) 1. the mode upgrade: a metadata and protocol commit only
    facts = _data_file_facts(path)
    table = Table.for_path(path, engine=eng)
    step("set_mode", 0, lambda: alter.set_properties(table, CM_MODE))
    _check(_data_file_facts(path) == facts,
           "column_mapping set_mode: no data file changed")
    # 2. a reload through step 20's checkpoint and the mode's commit
    parts = _newest_parts(log)
    table = Table.for_path(path, engine=eng)
    snap = step("reload", 0, load, k1=(1, None), k2=(1, None),
                k3=(len(parts), len(parts)))
    proto = snap.protocol
    _check("columnMapping" in (proto.writerFeatures or [])
           and "columnMapping" in (proto.readerFeatures or []),
           f"column_mapping set_mode: the protocol lists columnMapping "
           f"({proto.to_dict()})")
    _check(all(f.physical_name == f.name for f in snap.schema.fields),
           "column_mapping set_mode: each field keeps its name as its "
           "physical name")
    # 3-5. RENAME, DROP, ADD: metadata commits through the handoff (K1)
    step("rename", 0, lambda: alter.rename_column(table, *CM_RENAME),
         k1=(1, None))
    _model_rename(model, *CM_RENAME)
    step("drop", 0, lambda: alter.drop_column(table, CM_DROP), k1=(1, None))
    _model_drop(model, CM_DROP)
    step("add", 0, lambda: alter.add_columns(
        table, [StructField(CM_ADD, "string")]), k1=(1, None))
    _check(step.counts.get("table.notify_advances", 0) == 1,
           "column_mapping add: the handoff advanced the cached snapshot")
    _check(_data_file_facts(path) == facts,
           "column_mapping: no data file changed by the ALTERs")
    snap = table.latest_snapshot()
    _check(snap.schema.field_names()[-1] == CM_ADD
           and CM_DROP not in snap.schema
           and snap.schema[CM_RENAME[1]].physical_name == CM_RENAME[0],
           "column_mapping: the cached schema holds the ALTERs")
    # 6. the profit read through the renamed column
    profit = CM_RENAME[1]
    names = ["ss_item_sk", profit]
    pos = model.alive & model.ok[profit] & (model.v[profit] > 0)
    scan = snap.scan(filter=col(profit) > lit(decimal.Decimal("0.00")),
                     columns=names)
    got = step("read_profit", int(pos.sum()), scan.to_batch, k7=(1, 1))
    held(got, names, "read_profit", pos)
    _check(sorted(scan.file_paths()) == kept["profit_files"],
           "column_mapping read_profit: K7 kept step 20's files")
    _check(step.counts.get("scan.device_plans", 0) == 1
           and step.counts.get("scan.device_fallbacks", 0) == 0,
           "column_mapping read_profit: planned on the stats lanes")
    out["steps"]["read_profit"]["files_kept"] = len(kept["profit_files"])
    # 7. a DELETE on the renamed column: DVs, K8 packs the bitmaps
    below = int(decimal.Decimal(CM_DELETE_BELOW).scaleb(2))
    hit = model.alive & model.ok[profit] & (model.v[profit] < below)
    m = step("delete", int(hit.sum()), lambda: delete(
        table, col(profit) < lit(decimal.Decimal(CM_DELETE_BELOW))),
        k7=(1, 1), k8_pack=(1, 1))
    _check(m.num_rows_deleted == int(hit.sum()) and m.num_dvs_written > 0,
           f"column_mapping delete: {m.num_rows_deleted} rows, "
           f"{m.num_dvs_written} DVs")
    model.alive &= ~hit
    cards = [a.deletionVector.cardinality for a in
             table.latest_snapshot().state.add_files if a.deletionVector]
    _check(max(cards) > 4096, "column_mapping delete: a DV of bitmap "
           "containers (DF_SS's union)")
    out["steps"]["delete"]["dvs"] = m.num_dvs_written
    # 8. an UPDATE that sets the added column
    date, date_ok = model.v["ss_sold_date_sk"], model.ok["ss_sold_date_sk"]
    q3 = np.flatnonzero(model.alive & date_ok
                        & (date >= WIDE_LAST_QUARTER[0]))
    ticket = int(model.v["ss_ticket_number"][q3[0]])
    hit = model.alive & (model.v["ss_ticket_number"] == ticket)
    m = step("update", int(hit.sum()), lambda: update(
        table, {CM_ADD: lit("store")}, col("ss_ticket_number") == lit(ticket)),
        k7=(1, 1))
    _check(m.num_rows_updated == int(hit.sum()),
           f"column_mapping update: {m.num_rows_updated} rows")
    channel[hit] = "store"
    # 9. LF_SS: MERGE a 1% source on the key, setting ss_profit
    source, matched = _wide_merge_source(model, np.random.default_rng(21),
                                         profit, CM_MERGE_TICKET)
    half = len(matched)
    lf = np.empty(source.num_rows, object)
    lf[:] = "lf_ss"
    merged = Batch(dict(source.columns, **{CM_ADD: Column(lf)}),
                   source.num_rows)
    m = step("merge", source.num_rows, lambda: merge(
        table, merged, on=(col("target.ss_item_sk")
                           == col("source.ss_item_sk"))
        & (col("target.ss_ticket_number")
           == col("source.ss_ticket_number")))
        .when_matched_update_all().when_not_matched_insert_all()
        .execute(), k9=(1, 1))
    _check((m.num_target_rows_updated, m.num_target_rows_inserted)
           == (half, half),
           f"column_mapping merge: {m.num_target_rows_updated} updated, "
           f"{m.num_target_rows_inserted} inserted of {half} each")
    model.alive[matched] = False
    model.append(source)
    channel = np.r_[channel, lf]
    # 10. ZORDER BY the renamed column of the last quarter
    last = model.alive & model.ok["ss_sold_date_sk"] & (
        model.v["ss_sold_date_sk"] >= WIDE_LAST_QUARTER[0])
    m = step("optimize_zorder", int(last.sum()), lambda: table.optimize()
             .where(col("ss_sold_date_sk") >= lit(WIDE_LAST_QUARTER[0]))
             .execute_zorder_by(profit), k4=(1, 1))
    schema = table.latest_snapshot().schema
    physical = {f.physical_name for f in schema.fields}
    new_files = [os.path.join(path, a.path) for a in
                 table.latest_snapshot().state.add_files
                 if os.path.join(path, a.path) not in facts]
    _check(new_files and all(_footer_names(f) == physical
                             for f in new_files)
           and CM_RENAME[0] in physical and CM_DROP not in physical,
           "column_mapping: the rewritten files hold the physical names")
    out["steps"]["optimize_zorder"].update(
        files_removed=m.num_files_removed, files_added=m.num_files_added)
    # 11. a stats_parsed checkpoint, an append, the reload, reads
    step("checkpoint", 0, lambda: Table.for_path(
        path, engine=eng).checkpoint())
    parts = _newest_parts(log)
    leaves = set()
    for n in parts:
        leaves |= {p[3] for p in _footer_leaf_paths(os.path.join(log, n))
                   if p[:2] == ("add", "stats_parsed") and len(p) > 3}
    _check(leaves and leaves <= physical and CM_RENAME[1] not in leaves,
           f"column_mapping checkpoint: stats_parsed keyed by physical "
           f"names ({sorted(leaves)[:4]}...)")
    idx = q3[:CM_APPEND_ROWS]
    extra = model.batch(idx)
    cols = dict(extra.columns)
    cols["ss_ticket_number"] = Column((CM_NEW_TICKET + np.arange(len(
        idx))).astype(model.dtypes["ss_ticket_number"]))
    web = np.empty(len(idx), object)
    web[:] = "web"
    cols[CM_ADD] = Column(web)
    extra = Batch(cols, len(idx))
    step("append", len(idx), lambda: write_table(path, extra, engine=eng))
    model.append(extra)
    channel = np.r_[channel, web]
    snap = step("checkpoint_reload", 0, lambda: _loaded(path, eng),
                k3=(len(parts), len(parts)), k1=(1, None), k2=(1, None))
    pos = model.alive & model.ok[profit] & (model.v[profit] > 0)
    got = step("read_profit_after", int(pos.sum()), lambda: snap.scan(
        filter=col(profit) > lit(decimal.Decimal("0.00")),
        columns=names).to_batch(), k7=(1, 1))
    held(got, names, "read_profit_after", pos)
    got = step("read_all", int(model.alive.sum()),
               lambda: snap.scan().to_batch())
    _check(CM_DROP not in got.column_names
           and got.column_names[-1] == CM_ADD and profit in got.column_names,
           f"column_mapping read_all: the columns {got.column_names}")
    held(got, model.names, "read_all")
    _channels_held(got, model, channel, "read_all")
    del got, snap

    # (b) a fresh name-mode table, partitioned by the sold date
    src = kept["step19"]
    d = src.column(CM_PARTITION)
    d_ok = (np.ones(src.num_rows, bool) if d.valid is None else d.valid)
    lo, hi = CM_FIRST_QUARTER
    file0 = src.column("ss_ticket_number").values // WIDE_TICKET_FILE == 0
    rows = np.flatnonzero((d_ok & (d.values >= lo) & (d.values < hi))
                          | (~d_ok & file0))
    q0 = src.take(rows)
    q0_model = _WideModel(q0)
    fresh = os.path.join(kept["work"], "store_sales_mapped")
    step("fresh_write", q0.num_rows, lambda: write_table(
        fresh, q0, engine=eng, partition_by=[CM_PARTITION],
        properties=CM_MODE))
    fsnap = Table.for_path(fresh, engine=eng).latest_snapshot()
    pkey = fsnap.schema[CM_PARTITION].physical_name
    adds = fsnap.state.add_files
    n_dates = len(np.unique(d.values[rows][d_ok[rows]]))
    _check(pkey.startswith("col-")
           and all(set(a.partitionValues) == {pkey} for a in adds)
           and len(adds) == n_dates + int((~d_ok[rows]).any()),
           f"column_mapping fresh_write: {len(adds)} files keyed by the "
           f"physical name")
    _check(any("__HIVE_DEFAULT_PARTITION__" in a.path
               and a.partitionValues[pkey] is None for a in adds),
           "column_mapping fresh_write: nulls in the default partition")
    _check(all(n.startswith("col-") for a in adds
               for n in _footer_names(os.path.join(fresh, a.path))),
           "column_mapping fresh_write: every footer holds col- names only")
    plo, phi = CM_PRUNE_RANGE
    in_range = q0_model.ok[CM_PARTITION] & (q0_model.v[CM_PARTITION] >= plo) \
        & (q0_model.v[CM_PARTITION] < phi)

    def range_read(name):
        snap = Table.for_path(fresh, engine=eng).latest_snapshot()
        scan = snap.scan(filter=(col(name) >= lit(plo))
                         & (col(name) < lit(phi)))
        return scan, scan.to_batch()

    scan, got = step("fresh_read_range", int(in_range.sum()),
                     lambda: range_read(CM_PARTITION))
    files = sorted(scan.file_paths())
    n_in = len(np.unique(q0_model.v[CM_PARTITION][in_range]))
    _check(scan.partition_pruned == len(adds) - n_in
           and len(files) == n_in > 0,
           f"column_mapping fresh_read_range: {scan.partition_pruned} "
           f"partitions pruned, {len(files)} read")
    sums = [c for c in q0_model.names if c != CM_PARTITION]
    saved, q0_model.alive = q0_model.alive, in_range
    _check(got.num_rows == int(in_range.sum())
           and wide_sums(Batch({c: got.column(c) for c in sums},
                               got.num_rows)) == q0_model.sums(sums),
           "column_mapping fresh_read_range: rows equal the model's")
    want_sums = wide_sums(Batch({c: got.column(c) for c in sums},
                                got.num_rows))
    step("fresh_rename", 0, lambda: alter.rename_column(
        Table.for_path(fresh, engine=eng), CM_PARTITION,
        CM_PARTITION_RENAMED))
    scan, got = step("fresh_read_renamed", int(in_range.sum()),
                     lambda: range_read(CM_PARTITION_RENAMED))
    _check(sorted(scan.file_paths()) == files
           and got.num_rows == int(in_range.sum())
           and wide_sums(Batch({c: got.column(c) for c in sums},
                               got.num_rows)) == want_sums
           and CM_PARTITION_RENAMED in got.column_names,
           "column_mapping fresh_read_renamed: the same files and rows")
    q0_model.alive = saved
    out["fresh"] = {"rows": q0.num_rows, "files": len(adds),
                    "dates": n_dates, "pruned": scan.partition_pruned}
    if keep is not None:
        _model_rename(q0_model, CM_PARTITION, CM_PARTITION_RENAMED)
        keep.update(a={"path": path, "model": model, "channel": channel},
                    b={"path": fresh, "model": q0_model})
    return out


# step 22: the write modes on step 21's two tables
WM_WEEK = 40               # (b)'s dynamic overwrite: its 41st-47th dates
WM_PROMO_COLUMN = "ss_promo_channel"  # merge_schema's new column
WM_PROMO = "promo"
WM_PROMO_FROM = 100        # the new date's rows copy its 101st date's
WM_NEW_DATE = CM_FIRST_QUARTER[1]     # a sold date past the quarter
WM_REWRITE_ROWS = 1_000_000           # data_change=False: rows per file
WM_DROPPED = (WM_PROMO_COLUMN, "ss_coupon_amt", "ss_ext_tax")
# (a): quarter 2's tickets in its first 10 copies, whose files hold
# DF_SS's bitmap DVs (> 4,096 of 6,000 rows), so the union packs on K8
WM_TICKETS = (2 * WIDE_TICKETS[0], 2 * WIDE_TICKETS[0] + 10 * WIDE_TICKETS[1])


def _head_version(path: str) -> int:
    log = os.path.join(path, "_delta_log")
    return max(int(n[:20]) for n in os.listdir(log)
               if n.endswith(".json") and n[:20].isdigit())


def _newest_parts(log: str) -> list:
    cps = [n for n in os.listdir(log) if ".checkpoint." in n]
    newest = max(n[:20] for n in cps)
    return [n for n in cps if n.startswith(newest)]


def _commit_actions(path: str, version: int) -> dict:
    """{action kind: [bodies]} of one commit file."""
    out = {}
    name = os.path.join(path, "_delta_log", f"{version:020d}.json")
    with open(name) as f:
        for line in f:
            if line.strip():
                (k, v), = json.loads(line).items()
                out.setdefault(k, []).append(v)
    return out


def _refreshed(model, idx, bump: int):
    """The model's rows `idx` as a Batch, each valid ss_quantity moved to
    (q mod 100) + bump: a refresh of those sales."""
    from delta_tpu_torch.models.batch import Batch, Column

    b = model.batch(idx)
    q = b.column("ss_quantity")
    cols = dict(b.columns)
    cols["ss_quantity"] = Column(
        np.where(q.valid, q.values % 100 + bump, q.values).astype(
            q.values.dtype), q.valid, q.data_type)
    return Batch(cols, b.num_rows)


def _held(read, model, names, what: str, alive=None) -> None:
    """The read's rows equal the model's live rows (`alive`, else
    `model.alive`) over the columns `names`: the count and `wide_sums`."""
    from delta_tpu_torch.models.batch import Batch

    live = model.alive if alive is None else alive
    _check(read.num_rows == int(live.sum()),
           f"{what}: {read.num_rows} rows, the model {int(live.sum())}")
    saved, model.alive = model.alive, live
    try:
        _check(wide_sums(Batch({c: read.column(c) for c in names},
                               read.num_rows)) == model.sums(names),
               f"{what}: rows equal the model's")
    finally:
        model.alive = saved


def write_modes_phase(kept: dict, device: str, card: str) -> dict:
    """Step 22: the write modes of `api.write_table` on the card, on step
    21's two tables (`column_mapping_phase`'s `keep`). Each step's
    counters from 0, its rows against step 21's numpy models:
    (b) the fresh name-mode table partitioned by ss_sold_date (720,000
       rows at 120 links): 1. a dynamic partition overwrite of one week's
       rows with their ss_quantity refreshed: exactly those 7 partitions'
       files removed, every other file kept by path; 2. `replace_where`
       on CM_PRUNE_RANGE's 30 dates of the partition column, the range's
       rows refreshed: its files removed whole (no K7: a partition-only
       predicate), then a batch with one row outside the range refused
       (DELTA_REPLACE_WHERE_MISMATCH) at the same version; 3. a
       `merge_schema` append of one new date's rows with a new column
       ss_promo_channel: a `col-` physical name, null in the old rows;
       4. the table's rows written back with `data_change=False`: every
       action dataChange false, the same rows; 5. `ignore` writes nothing,
       `error` raises PathExistsError; 6. `overwrite_schema` with three
       columns dropped, unpartitioned: every file holds `col-` names only,
       a reload and a full read equal the model;
    (a) the upgraded table (name mode, DVs): `replace_where` on a data
       column (one store's rows in a ticket range refreshed, DF_SS/LF_SS's
       manner) in quarter 2's files, which hold DF_SS's DVs: K7 plans, K8
       packs the union of the old and the new deleted rows (bitmap
       containers),
       the new rows in the same commit; then a reload through step 21's
       checkpoint (K3 per part, K1, K2) and a full read.
    Returns each step's seconds, rows/s and launches."""
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.errors import InvariantViolationError, PathExistsError
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.models.batch import Batch, Column

    eng = TorchEngine(device)
    out = {"card": card, "steps": {}}
    step = _stepper(out, eng, "write_modes")

    def held(read, model, names, what, alive=None):
        _held(read, model, names, f"write_modes {what}", alive)

    def all_flags(actions, flag):
        return all(a["dataChange"] is flag for k in ("add", "remove")
                   for a in actions.get(k, []))

    # (b) the fresh partitioned table
    fpath, fm = kept["b"]["path"], kept["b"]["model"]
    part = CM_PARTITION_RENAMED
    out["b_rows"] = int(fm.alive.sum())
    promo = np.full(len(fm.alive), None, object)
    pkey = _loaded(fpath, eng).schema[part].physical_name

    def live_files():
        return {a.path: a.partitionValues[pkey]
                for a in _loaded(fpath, eng).state.add_files}

    def range_read(lo, hi, names=None):
        snap = Table.for_path(fpath, engine=eng).latest_snapshot()
        return snap.scan(filter=(col(part) >= lit(lo)) & (col(part) <= lit(
            hi)), columns=names).to_batch()

    sums = fm.names
    date, date_ok = fm.v[part], fm.ok[part]
    # 1. dynamic partition overwrite of one week
    dates = np.unique(date[fm.alive & date_ok])
    week = dates[WM_WEEK:WM_WEEK + 7]
    hit = fm.alive & date_ok & np.isin(date, week)
    new = _refreshed(fm, np.flatnonzero(hit), 1)
    before = live_files()
    step("dynamic_week", new.num_rows, lambda: write_table(
        fpath, new, mode="overwrite", partition_overwrite_mode="dynamic",
        engine=eng), k1=(1, None), k2=(1, None))
    fm.alive &= ~hit
    fm.append(new)
    promo = np.r_[promo, np.full(new.num_rows, None, object)]
    after = live_files()
    spelled = {str(int(d)) for d in week}
    others = {p for p, v in before.items() if v not in spelled}
    _check(others == {p for p, v in after.items() if v not in spelled}
           and sorted(v for v in after.values() if v in spelled)
           == sorted(spelled)
           and not {p for p, v in after.items() if v in spelled} & set(before),
           f"write_modes dynamic_week: the week's 7 partitions rewritten, "
           f"{len(others)} other files kept by path")
    date, date_ok = fm.v[part], fm.ok[part]
    got = range_read(int(week[0]), int(week[-1]))
    held(got, fm, sums, "dynamic_week",
         fm.alive & date_ok & np.isin(date, week))
    # 2. replace_where on 30 dates of the partition column
    lo, hi = CM_PRUNE_RANGE
    pred = (col(part) >= lit(lo)) & (col(part) < lit(hi))
    hit = fm.alive & date_ok & (date >= lo) & (date < hi)
    new = _refreshed(fm, np.flatnonzero(hit), 2)
    in_range = {p for p, v in live_files().items()
                if v is not None and lo <= int(v) < hi}
    version = step("replace_range", new.num_rows, lambda: write_table(
        fpath, new, mode="overwrite", replace_where=pred, engine=eng),
        k1=(1, None), k2=(1, None), k7=(0, 0))
    acts = _commit_actions(fpath, version)
    metrics = acts["commitInfo"][0]["operationMetrics"]
    _check({r["path"] for r in acts["remove"]} == in_range
           and metrics["numCopiedRows"] == "0"
           and metrics["numDeletedRows"] == str(int(hit.sum()))
           and metrics["numOutputRows"] == str(new.num_rows)
           and acts["commitInfo"][0]["operationParameters"]
           == {"predicate": repr(pred)},
           f"write_modes replace_range: {len(in_range)} files removed "
           f"whole, {int(hit.sum())} rows replaced ({metrics})")
    fm.alive &= ~hit
    fm.append(new)
    promo = np.r_[promo, np.full(new.num_rows, None, object)]
    date, date_ok = fm.v[part], fm.ok[part]
    got = range_read(lo, hi - 1)
    held(got, fm, sums, "replace_range",
         fm.alive & date_ok & (date >= lo) & (date < hi))
    outside = np.flatnonzero(fm.alive & date_ok & (date >= hi))[:1]
    bad = fm.batch(np.r_[np.flatnonzero(fm.alive & date_ok & (date >= lo)
                                        & (date < hi))[:9], outside])

    def refused():
        try:
            write_table(fpath, bad, mode="overwrite", replace_where=pred,
                        engine=eng)
        except InvariantViolationError as e:
            return e.error_class
        return None

    _check(step("replace_refused", bad.num_rows, refused)
           == "DELTA_REPLACE_WHERE_MISMATCH"
           and _head_version(fpath) == version,
           "write_modes replace_refused: a row outside the range refused, "
           "nothing committed")
    # 3. merge_schema: one new date's rows with a new column
    idx = np.flatnonzero(fm.alive & date_ok
                         & (date == dates[WM_PROMO_FROM]))
    cols = dict(fm.batch(idx).columns)
    cols[part] = Column(np.full(len(idx), WM_NEW_DATE, fm.dtypes[part]))
    tags = np.full(len(idx), WM_PROMO, object)
    old_max = int(_loaded(fpath, eng).metadata.configuration[
        "delta.columnMapping.maxColumnId"])
    extra = Batch(dict(cols, **{WM_PROMO_COLUMN: Column(tags)}), len(idx))
    # an append reads the metadata alone: no replay, no handoff
    step("merge_schema", len(idx), lambda: write_table(
        fpath, extra, merge_schema=True, engine=eng), k1=(0, 0),
        k2=(0, 0))
    fm.append(Batch({c: cols[c] for c in fm.names}, len(idx)))
    promo = np.r_[promo, tags]
    snap = _loaded(fpath, eng)
    field = snap.schema[WM_PROMO_COLUMN]
    new_files = [a for a in snap.state.add_files
                 if a.partitionValues[pkey] == str(WM_NEW_DATE)]
    _check(field.physical_name.startswith("col-")
           and field.column_mapping_id == old_max + 1
           and snap.metadata.configuration[
               "delta.columnMapping.maxColumnId"] == str(old_max + 1)
           and new_files and all(
               field.physical_name in _footer_names(os.path.join(fpath, a.path))
               for a in new_files),
           f"write_modes merge_schema: {WM_PROMO_COLUMN} mapped as "
           f"{field.physical_name} (id {field.column_mapping_id})")
    date, date_ok = fm.v[part], fm.ok[part]
    for d, want in ((WM_NEW_DATE, WM_PROMO), (int(dates[WM_PROMO_FROM]), None)):
        got = range_read(d, d)
        c = got.column(WM_PROMO_COLUMN)
        ok = np.ones(got.num_rows, bool) if c.valid is None else c.valid
        _check(got.num_rows == len(idx) and (
            ok.all() and set(c.values.tolist()) == {want} if want
            else not ok.any()),
            f"write_modes merge_schema: {WM_PROMO_COLUMN} on date {d}")
    # 4. the rows written back with data_change=False
    snap = _loaded(fpath, eng)
    n_files = len(snap.state.add_files)
    rows = step("read_before_rewrite", int(fm.alive.sum()),
                lambda: snap.scan().to_batch())
    held(rows, fm, sums, "read_before_rewrite")
    c = rows.column(WM_PROMO_COLUMN)
    ok = np.ones(rows.num_rows, bool) if c.valid is None else c.valid
    _check(sorted(c.values[ok].tolist())
           == sorted(v for v in promo[fm.alive] if v is not None),
           "write_modes read_before_rewrite: the promo column's values")
    version = step("rewrite", rows.num_rows, lambda: write_table(
        fpath, rows, mode="overwrite", data_change=False,
        target_rows_per_file=WM_REWRITE_ROWS, engine=eng), k1=(1, None),
        k2=(1, None))
    acts = _commit_actions(fpath, version)
    _check(len(acts["remove"]) == n_files and acts["add"]
           and all_flags(acts, False),
           f"write_modes rewrite: {n_files} removes and "
           f"{len(acts['add'])} adds, all dataChange false")
    del rows, snap
    # 5. ignore and error on the existing table
    small = fm.batch(np.flatnonzero(fm.alive)[:10])
    _check(step("ignore", 0, lambda: write_table(
        fpath, small, mode="ignore", engine=eng)) == version
        and _head_version(fpath) == version,
        "write_modes ignore: nothing written")

    def error_mode():
        try:
            write_table(fpath, small, mode="error", engine=eng)
        except PathExistsError as e:
            return e.error_class
        return None

    _check(step("error", 0, error_mode) == "DELTA_PATH_EXISTS"
           and _head_version(fpath) == version,
           "write_modes error: PathExistsError, nothing written")
    # 6. overwrite_schema: three columns dropped, unpartitioned
    snap = _loaded(fpath, eng)
    rows = step("read_before_schema", int(fm.alive.sum()),
                lambda: snap.scan().to_batch())
    held(rows, fm, sums, "read_before_schema")
    keep_cols = [c for c in rows.column_names if c not in WM_DROPPED]
    slim = Batch({c: rows.column(c) for c in keep_cols}, rows.num_rows)
    del rows, snap
    schema_version = step("overwrite_schema", slim.num_rows,
                          lambda: write_table(fpath, slim, mode="overwrite",
                                              overwrite_schema=True,
                                              engine=eng),
                          k1=(1, None), k2=(1, None))
    del slim
    snap = step("schema_reload", 0, lambda: _loaded(fpath, eng),
                k1=(1, None), k2=(1, None))
    schema = snap.schema
    _check(snap.partition_columns == [] and schema.field_names() == keep_cols
           and all(f.physical_name.startswith("col-") for f in schema.fields)
           and all(n.startswith("col-") for a in snap.state.add_files
                   for n in _footer_names(os.path.join(fpath, a.path))),
           "write_modes overwrite_schema: unpartitioned, every file holds "
           "col- names only")
    got = step("schema_read_all", int(fm.alive.sum()),
               lambda: snap.scan().to_batch())
    _check(got.column_names == keep_cols,
           f"write_modes schema_read_all: the columns {got.column_names}")
    held(got, fm, [c for c in sums if c not in WM_DROPPED],
         "schema_read_all")
    out["b"] = {"files_after_week": len(after), "range_files": len(in_range),
                "rewrite_files": n_files, "columns": len(keep_cols)}
    # step 23 restores the version before the new schema
    kept["b"].update(promo=promo, restore_version=version,
                     schema_version=schema_version)
    del got, snap

    # (a) replace_where on a data column of the upgraded table
    path, model = kept["a"]["path"], kept["a"]["model"]
    channel = kept["a"]["channel"]
    log = os.path.join(path, "_delta_log")
    out["a_rows"] = int(model.alive.sum())
    t0, t1 = WM_TICKETS
    store, store_ok = model.v["ss_store_sk"], model.ok["ss_store_sk"]
    ticket = model.v["ss_ticket_number"]
    span = model.alive & store_ok & (ticket >= t0) & (ticket < t1)
    kinds, counts = np.unique(store[span], return_counts=True)
    pick = int(kinds[np.argmax(counts)])
    hit = span & (store == pick)
    pred = (col("ss_store_sk") == lit(pick)) \
        & (col("ss_ticket_number") >= lit(t0)) \
        & (col("ss_ticket_number") < lit(t1))
    new = _refreshed(model, np.flatnonzero(hit), 3)
    parts = _newest_parts(log)
    version = step("replace_tickets", new.num_rows, lambda: write_table(
        path, new, mode="overwrite", replace_where=pred, engine=eng),
        k7=(1, 1), k8_pack=(1, 1), k3=(len(parts), None), k1=(1, None),
        k2=(1, None))
    acts = _commit_actions(path, version)
    metrics = acts["commitInfo"][0]["operationMetrics"]
    dvs = [a for a in acts["add"] if a.get("deletionVector")]
    _check(metrics["numDeletedRows"] == str(int(hit.sum()))
           and metrics["numOutputRows"] == str(new.num_rows)
           and metrics["numCopiedRows"] == "0" and dvs
           and max(a["deletionVector"]["cardinality"] for a in dvs) > 4096
           and acts["commitInfo"][0]["operationParameters"]
           == {"predicate": repr(pred)},
           f"write_modes replace_tickets: store {pick}, {int(hit.sum())} "
           f"rows replaced, {len(dvs)} DVs ({metrics})")
    out["steps"]["replace_tickets"]["dvs"] = len(dvs)
    model.alive &= ~hit
    model.append(new)
    channel = np.r_[channel, np.full(new.num_rows, None, object)]
    parts = _newest_parts(log)
    tail = _head_version(path) > int(parts[0][:20])
    snap = step("reload", 0, lambda: _loaded(path, eng),
                k3=(len(parts), len(parts)), k1=(int(tail), None),
                k2=(1, None))
    got = step("read_all", int(model.alive.sum()),
               lambda: snap.scan().to_batch())
    held(got, model, model.names, "read_all")
    _channels_held(got, model, channel, "write_modes read_all")
    kept["a"]["channel"] = channel
    return out




# step 23: VACUUM, REORG PURGE, RESTORE and CLONE
MAINT_PLANT_EVERY = 60      # (i): a zero-byte file for one live file and
                            # one tombstone in sixty (a cut, for the time)
MAINT_UNTRACKED = 100       # (i): files no log names
MAINT_AGE_S = 2 * 3600      # (i), (iii): the planted files' and the log's age
MAINT_RETENTION_H = 1       # (i)'s retention: the planted files are past it
MAINT_CLONE_COLUMNS = ("ss_sold_date_sk", "ss_item_sk", "ss_ticket_number",
                       "ss_quantity")
MAINT_ORPHAN = "orphan-00000.parquet"   # (iii): the one untracked file


def _fixture_sizes() -> dict:
    """{path: size} of every file under `tests/torch_fixtures/`."""
    root = os.path.dirname(WIDE_DIR)
    return {os.path.relpath(os.path.join(d, f), root):
            os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(root) for f in files}


def _plant(root: str, rels, mtime: float) -> None:
    """Zero-byte files at `rels` under `root`, with mtime `mtime`."""
    for rel in rels:
        name = os.path.join(root, rel)
        os.makedirs(os.path.dirname(name), exist_ok=True)
        with open(name, "wb"):
            pass
        os.utime(name, (mtime, mtime))


def _watermark(path: str):
    with open(os.path.join(path, "_delta_log", "_last_vacuum_info")) as f:
        return json.load(f)["latestCommitVersionOutsideOfRetentionWindow"]


def maintenance_phase(head: str, truth, kept: dict, work: str, device: str,
                      card: str, plant_every: int = MAINT_PLANT_EVERY
                      ) -> dict:
    """Step 23: VACUUM, REORG PURGE, RESTORE and CLONE on the card, each
    step's counters from 0:
    (i) VACUUM at the headline log's scale on a hard-link copy of it
       (`head`, the generator's `truth`) whose files, and the planted ones,
       are aged MAINT_AGE_S: a zero-byte file for one live file and one
       tombstone in `plant_every`, MAINT_UNTRACKED untracked files, a
       `_change_data/` file, hidden `_tmp/` and `.x` files. With retention
       MAINT_RETENTION_H: a FULL dry run names the planted tombstones, the
       untracked and the `_change_data` files (the load: K3 once per part,
       K1, K2); a LITE dry run names every tombstone of commits 0..head
       (its range read through the commit parse, K1); FULL for real
       deletes that set, keeps every planted live file and the hidden
       ones, and writes the watermark at the head; LITE again is empty;
    (ii) REORG PURGE on step 22's DV table (a): every DV'd file rewritten
       (K8 decodes their DVs in one launch; K1 on the handoff), every
       action dataChange false, no live file keeps a DV, a full read equal
       to step 22's model;
    (iii) VACUUM of (a) with retention 0 and MAINT_ORPHAN planted: a dry
       run names the purged originals and their DV files; LITE for real
       deletes the dry run's set but the orphan; a FULL dry run then names
       the orphan alone; a reload and a full read equal the model, K8 not
       launched;
    (iv) RESTORE of step 22's partitioned table (b) to the version before
       `overwrite_schema`: its schema and partitioning back (K1 on the
       handoff), a full read equal to the model at that version; VACUUM
       with retention 0 deletes the new schema's files, the read stays;
       a RESTORE to the new schema's version is refused with
       DELTA_RESTORE_MISSING_DATA_FILE, nothing committed;
    (v) a shallow CLONE of (a) reads (a)'s rows; VACUUM of the clone
       deletes none of (a)'s files; a deep CLONE reads them from its own
       copies.
    Every file under `tests/torch_fixtures/` keeps its name and size.
    Returns each step's seconds, rows/s and launches, and VACUUM's phase
    seconds (`vacuum_phase_s`)."""
    from urllib.parse import unquote

    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.commands.reorg import reorg_purge
    from delta_tpu_torch.commands.restore import clone, restore
    from delta_tpu_torch.dv.descriptor import absolute_dv_path
    from delta_tpu_torch.errors import RestoreTargetError

    eng = TorchEngine(device)
    out = {"card": card, "steps": {}, "vacuum_phase_s": {}}
    step = _stepper(out, eng, "maintenance")
    fixtures = _fixture_sizes()
    old = time.time() - MAINT_AGE_S

    # (i) the headline log: a copy of links (which share the headline's
    # inodes, so its files age too; nothing after this step reads their
    # mtimes) and the planted files
    copy = os.path.join(work, "maintenance_headline")
    src_log, log = (os.path.join(head, "_delta_log"),
                    os.path.join(copy, "_delta_log"))
    os.makedirs(log)
    t0 = time.perf_counter()
    for n in os.listdir(src_log):
        _link_or_copy(os.path.join(src_log, n), os.path.join(log, n))
        os.utime(os.path.join(log, n), (old, old))
    live_plant = truth.live_paths[::plant_every]
    tomb_plant = truth.removed_paths[::plant_every]
    untracked = [f"untracked-{i:03d}.parquet" for i in range(MAINT_UNTRACKED)]
    cdc = "_change_data/cdc-00000.parquet"
    hidden = ["_tmp/x.parquet", ".x.parquet"]
    _plant(copy, live_plant + tomb_plant + untracked + [cdc] + hidden, old)
    out["plant_s"] = time.perf_counter() - t0
    out["planted"] = {"live": len(live_plant), "tombstones": len(tomb_plant),
                      "untracked": len(untracked)}
    parts = _newest_parts(log)
    rows = len(truth.live_paths) + truth.num_tombstones
    table = Table.for_path(copy, engine=eng)

    # the first run loads the table (K3 per part, K1 on the tail, K2),
    # the others take its cached snapshot; LITE's range parse is K1's
    expect = {"vacuum_full_dry": dict(k3=(len(parts), len(parts)),
                                      k1=(1, None), k2=(1, None)),
              "vacuum_lite_dry": dict(k3=(0, 0), k1=(1, None), k2=(0, 0)),
              "vacuum_full": dict(k3=(0, 0), k1=(0, 0), k2=(0, 0)),
              "vacuum_lite_again": dict(k3=(0, 0), k1=(0, 0), k2=(0, 0))}

    def vacuum(name, **kw):
        r = step(name, rows, lambda: table.vacuum(
            retention_hours=MAINT_RETENTION_H, **kw), **expect[name])
        out["vacuum_phase_s"][name] = r.phase_seconds
        return r
    full_want = set(tomb_plant) | set(untracked) | {cdc}
    r = vacuum("vacuum_full_dry", dry_run=True)
    _check(len(r.files_deleted) == len(full_want)
           and set(r.files_deleted) == full_want,
           f"maintenance vacuum_full_dry: {len(r.files_deleted)} files "
           f"named, the generator's {len(full_want)}")
    r = vacuum("vacuum_lite_dry", dry_run=True, vacuum_type="LITE")
    _check(len(r.files_deleted) == truth.num_tombstones
           and set(r.files_deleted) == set(truth.removed_paths)
           and (r.eligible_start_commit_version,
                r.eligible_end_commit_version) == (0, truth.version),
           f"maintenance vacuum_lite_dry: {len(r.files_deleted)} files "
           f"named, the generator's {truth.num_tombstones} tombstones")
    r = vacuum("vacuum_full")
    _check(set(r.files_deleted) == full_want
           and not any(os.path.exists(os.path.join(copy, p))
                       for p in full_want)
           and all(os.path.exists(os.path.join(copy, p))
                   for p in live_plant + hidden)
           and _watermark(copy) == truth.version,
           "maintenance vacuum_full: the named files gone, every planted "
           "live and hidden file kept, the watermark at the head")
    r = vacuum("vacuum_lite_again", vacuum_type="LITE")
    _check(r.files_deleted == [] and (r.eligible_start_commit_version,
                                      r.eligible_end_commit_version)
           == (None, truth.version),
           "maintenance vacuum_lite_again: an empty range")
    del table

    # (ii) REORG PURGE of (a)'s deletion vectors
    path, model = kept["a"]["path"], kept["a"]["model"]
    channel = kept["a"]["channel"]
    parts = _newest_parts(os.path.join(path, "_delta_log"))
    table = Table.for_path(path, engine=eng)
    m = step("reorg_purge", 0, lambda: reorg_purge(table),
             k3=(len(parts), None), k1=(1, None), k2=(1, None),
             k8_decode=(1, 1), k8_pack=(0, 0), k7=(0, 0))
    acts = _commit_actions(path, m.version)
    rewritten = sum(json.loads(a["stats"])["numRecords"] for a in acts["add"])
    st = out["steps"]["reorg_purge"]
    st.update(rows=rewritten, rows_per_s=rewritten / st["s"],
              files_removed=m.num_files_removed,
              files_added=m.num_files_added, phase_s=m.phase_seconds)
    info = acts["commitInfo"][0]
    snap = table.latest_snapshot()
    _check(m.num_files_removed == len(acts["remove"]) > 0
           and all(r.get("deletionVector") for r in acts["remove"])
           and all(a["dataChange"] is False
                   for a in acts["add"] + acts["remove"])
           and info["operation"] == "OPTIMIZE"
           and info["operationParameters"] == {"applyPurge": True}
           and snap.version == m.version
           and all(a.deletionVector is None for a in snap.state.add_files),
           f"maintenance reorg_purge: {m.num_files_removed} files purged "
           f"into {m.num_files_added}, no live file keeps a DV")
    got = step("purge_read_all", int(model.alive.sum()),
               lambda: snap.scan().to_batch(), k8_decode=(0, 0))
    _held(got, model, model.names, "maintenance purge_read_all")
    _channels_held(got, model, channel, "maintenance purge_read_all")
    del got, snap

    # (iii) VACUUM of (a): LITE deletes what the log removed
    parts = _newest_parts(os.path.join(path, "_delta_log"))
    purged = {unquote(r["path"]) for r in acts["remove"]}
    purged |= {os.path.relpath(absolute_dv_path(path, r["deletionVector"]),
                               path) for r in acts["remove"]
               if r["deletionVector"]["storageType"] == "u"}
    _plant(path, [MAINT_ORPHAN], old)
    table = Table.for_path(path, engine=eng)
    dry = step("vacuum_dry", 0, lambda: table.vacuum(retention_hours=0,
                                                     dry_run=True),
               k3=(len(parts), None), k1=(1, None), k2=(1, None))
    dry = set(dry.files_deleted)
    _check(purged | {MAINT_ORPHAN} <= dry,
           f"maintenance vacuum_dry: {len(dry)} files named, the "
           f"{len(purged)} purged files and DV files among them")
    lite = step("vacuum_lite", 0, lambda: table.vacuum(
        retention_hours=0, vacuum_type="LITE"), k1=(1, None), k3=(0, 0),
        k2=(0, 0))
    _check(set(lite.files_deleted) == dry - {MAINT_ORPHAN}
           and not any(os.path.exists(os.path.join(path, p))
                       for p in lite.files_deleted),
           f"maintenance vacuum_lite: {len(lite.files_deleted)} files "
           "deleted, the dry run's but the orphan")
    full = step("vacuum_full_dry_after", 0, lambda: table.vacuum(
        retention_hours=0, dry_run=True), k1=(0, 0), k3=(0, 0), k2=(0, 0))
    _check(full.files_deleted == [MAINT_ORPHAN],
           f"maintenance vacuum_full_dry_after: {full.files_deleted[:5]}")
    out["a_vacuum"] = {"dry": len(dry), "lite": len(lite.files_deleted)}
    snap = step("vacuum_reload", 0, lambda: _loaded(path, eng),
                k3=(len(parts), None), k1=(1, None), k2=(1, None))
    got = step("vacuum_read_all", int(model.alive.sum()),
               lambda: snap.scan().to_batch(), k8_decode=(0, 0),
               k8_pack=(0, 0))
    _held(got, model, model.names, "maintenance vacuum_read_all")
    _channels_held(got, model, channel, "maintenance vacuum_read_all")
    del got, snap, table

    # (iv) RESTORE of (b) to the version before the new schema
    fpath, fm = kept["b"]["path"], kept["b"]["model"]
    promo, v_pre = kept["b"]["promo"], kept["b"]["restore_version"]
    v_schema = kept["b"]["schema_version"]
    table = Table.for_path(fpath, engine=eng)
    want = table.snapshot_at(v_pre).metadata
    rm = step("restore", 0, lambda: restore(table, version=v_pre),
              k1=(1, None), k2=(1, None))
    snap = table.latest_snapshot()
    _check(step.counts.get("table.notify_advances", 0) == 1
           and snap.version == rm.version
           and snap.metadata.schemaString == want.schemaString
           and snap.partition_columns == want.partitionColumns
           == [CM_PARTITION_RENAMED],
           f"maintenance restore: version {v_pre}'s schema and "
           f"partitioning back ({rm.num_restored_files} files restored, "
           f"{rm.num_removed_files} removed), through the handoff")

    def held_b(what):
        got = step(what, int(fm.alive.sum()), lambda: snap.scan().to_batch())
        _held(got, fm, fm.names, f"maintenance {what}")
        c = got.column(WM_PROMO_COLUMN)
        ok = np.ones(got.num_rows, bool) if c.valid is None else c.valid
        _check(sorted(c.values[ok].tolist())
               == sorted(v for v in promo[fm.alive] if v is not None),
               f"maintenance {what}: the promo column's values")

    held_b("restore_read_all")
    schema_files = {unquote(a["path"])
                    for a in _commit_actions(fpath, v_schema)["add"]}
    vac = step("restore_vacuum", 0, lambda: table.vacuum(retention_hours=0))
    _check(schema_files <= set(vac.files_deleted),
           f"maintenance restore_vacuum: {len(vac.files_deleted)} files "
           f"deleted, the {len(schema_files)} of the new schema among them")
    held_b("restore_vacuum_read_all")

    def refused():
        try:
            restore(table, version=v_schema)
        except RestoreTargetError as e:
            return e.error_class
        return None

    _check(step("restore_refused", 0, refused)
           == "DELTA_RESTORE_MISSING_DATA_FILE"
           and _head_version(fpath) == rm.version,
           "maintenance restore_refused: the vacuumed version refused, "
           "nothing committed")
    out["b_restore"] = {"restored": rm.num_restored_files,
                        "removed": rm.num_removed_files,
                        "vacuumed": len(vac.files_deleted)}
    del snap, table

    # (v) CLONE of (a): shallow (the source's files), then deep (copies)
    a_files = sorted(os.listdir(path))
    names = list(MAINT_CLONE_COLUMNS)
    for kind in ("shallow", "deep"):
        dst = os.path.join(work, f"maintenance_{kind}_clone")
        step(f"clone_{kind}", 0, lambda: clone(
            Table.for_path(path, engine=eng), dst, shallow=kind == "shallow"),
            k3=(len(parts), None), k1=(1, None), k2=(1, None))
        adds = _commit_actions(dst, 0)["add"]
        _check(all(os.path.isabs(a["path"]) == (kind == "shallow")
                   for a in adds)
               and all(os.path.exists(os.path.join(dst, a["path"]))
                       for a in adds),
               f"maintenance clone_{kind}: {len(adds)} files, "
               f"{'absolute' if kind == 'shallow' else 'copied'}")
        got = step(f"{kind}_read", int(model.alive.sum()), lambda: _loaded(
            dst, eng).scan(columns=names).to_batch())
        _held(got, model, names, f"maintenance {kind}_read")
        del got
        if kind == "shallow":
            v = step("shallow_vacuum", 0, lambda: Table.for_path(
                dst, engine=eng).vacuum(retention_hours=0))
            _check(v.files_deleted == [] and sorted(os.listdir(path))
                   == a_files, "maintenance shallow_vacuum: none of the "
                   "source's files deleted")
    _check(_fixture_sizes() == fixtures,
           "maintenance: every fixture file keeps its name and size")
    return out


# step 24: type widening, MERGE's schema evolution, CHECK constraints, and
# generated, identity and default columns
TF_WIDEN = {"delta.enableTypeWidening": "true"}
TF_TYPES = (("ss_quantity", "long"), ("ss_sales_price", "decimal(9,2)"))
TF_APPEND_ROWS = 10_000          # 2.: ss_quantity past 2^31
TF_BIG = 1 << 31
TF_BIG_STEP = 1_000
TF_APPEND_TICKET = 7_000_000     # 2.'s tickets: past step 21's
TF_MERGE_TICKET = 8_000_000      # 4.'s LF_SS tickets
TF_PROMO = "ss_promo"            # 4.'s new source column
TF_DELETE_ABOVE = TF_BIG + TF_BIG_STEP * (TF_APPEND_ROWS // 2)
TF_CHECK = ("qty_nonneg", "ss_quantity >= 0")
TF_CHECK_NULLS = ("qty_nonneg", "ss_quantity IS NULL OR ss_quantity >= 0")
TF_ID = ("ss_row_id", 1_000, 3)  # 7.: identity (name, start, step)
TF_GENERATED = ("ss_tax_covered", "ss_net_paid_inc_tax >= ss_net_paid")
TF_DEFAULT = ("ss_channel", "'store'", "store")
TF_FRESH_APPENDS = (2_000, 3_000)  # 7.: the two appends' rows
TF_FRESH_TICKET = 9_000_000
TF_FRESH_MERGE_TICKET = 9_500_000


def _field_metadata(path: str, version: int, name: str):
    """A field's metadata in the metaData action of commit `version`
    (None: the commit holds none)."""
    meta = _commit_actions(path, version).get("metaData")
    if not meta:
        return None
    return next(f["metadata"] for f in json.loads(
        meta[0]["schemaString"])["fields"] if f["name"] == name)


def _covered(model, idx) -> tuple:
    """ss_net_paid_inc_tax >= ss_net_paid over the model's rows `idx`
    (unscaled decimals of one scale): (values, valid)."""
    a, b = "ss_net_paid_inc_tax", "ss_net_paid"
    ok = model.ok[a][idx] & model.ok[b][idx]
    return model.v[a][idx] >= model.v[b][idx], ok


def table_features_phase(kept: dict, step19, work: str, device: str,
                         card: str) -> dict:
    """Step 24: type widening, MERGE's schema evolution, CHECK constraints,
    and generated, identity and default columns on the card, each step's
    counters from 0 and its rows against the numpy models carried from
    step 22 (`kept`: `column_mapping_phase`'s `keep`, after steps 22-23):
    (a) the name-mode DV table: 1. `delta.enableTypeWidening` on (the
       protocol lists typeWidening), then CHANGE COLUMN TYPE ss_quantity
       integer -> long and ss_sales_price decimal(7,2) -> decimal(9,2)
       (K1 on each commit's handoff); 2. TF_APPEND_ROWS rows with
       ss_quantity past 2^31, then reads filtered on ss_quantity at the
       old files' exact bound (>= 100) and past 2^31 (K7 over files of
       int and of long bounds); 3. ZORDER BY ss_quantity of the last
       quarter (K4), a checkpoint, a fresh Table's reload through it (K3
       on every part) and a full read; 4. LF_SS's 1% MERGE with a new
       column TF_PROMO under `with_schema_evolution()` (K9): the rows
       written before read it as null; then a DELETE of half the
       appended rows (a deletion vector, K8 packs); 5. ADD CONSTRAINT
       `ss_quantity >= 0` refused (ss_quantity has NULLs, which violate),
       then `ss_quantity IS NULL OR ss_quantity >= 0` added: every live
       row checked, K8 decoding the DVs in one launch; 6. an append and
       an UPDATE that would violate it refused, the version and the
       live files as they were; DROP CONSTRAINT;
    (b) step 19's first quarter (720,000 rows at 120 links) written afresh
       with an identity column (start 1000, step 3), a generated column
       ss_tax_covered = ss_net_paid_inc_tax >= ss_net_paid (the relation
       checked with numpy first) and a CURRENT_DEFAULT column ss_channel:
       7. the write and two appends: the identity values unique, each
       commit's values running by the step from the previous watermark,
       the watermark in each commit's metadata; the generated and default
       values equal numpy's; 8. a 1% MERGE into it in LF_SS's manner
       (K9): half the source matches live rows and sets their ss_quantity
       and ss_net_profit, half inserts new tickets; the inserted rows'
       identity values from the watermark (moved in the MERGE's commit),
       their generated and default values; the updated rows keep theirs.
    Returns each step's seconds, rows/s and launches."""
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.api import schema_of, write_table
    from delta_tpu_torch.colgen import (
        default_field,
        generated_field,
        identity_field,
    )
    from delta_tpu_torch.commands import alter
    from delta_tpu_torch.commands.dml import delete, update
    from delta_tpu_torch.commands.merge import merge
    from delta_tpu_torch.constraints import add_constraint, drop_constraint
    from delta_tpu_torch.errors import InvariantViolationError
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.models.batch import Batch, Column
    from delta_tpu_torch.models.schema import StructType

    eng = TorchEngine(device)
    out = {"card": card, "steps": {}}
    step = _stepper(out, eng, "table_features")
    path, model = kept["a"]["path"], kept["a"]["model"]
    channel = kept["a"]["channel"]
    log = os.path.join(path, "_delta_log")
    out["a_rows"] = int(model.alive.sum())
    key = (col("target.ss_item_sk") == col("source.ss_item_sk")) \
        & (col("target.ss_ticket_number") == col("source.ss_ticket_number"))

    def loaded_table():
        """A Table whose cached snapshot holds its state, so that a
        commit on it takes the post-commit handoff (K1)."""
        t = Table.for_path(path, engine=eng)
        t.latest_snapshot().state
        return t

    # 1. the flag (a protocol commit), then the two type changes
    table = loaded_table()
    step("set_widening", 0, lambda: alter.set_properties(table, TF_WIDEN))
    proto = Table.for_path(path, engine=eng).latest_snapshot().protocol
    _check("typeWidening" in (proto.writerFeatures or [])
           and "typeWidening" in (proto.readerFeatures or []),
           f"table_features set_widening: the protocol {proto}")
    table = loaded_table()
    for name, new_type in TF_TYPES:
        step(f"widen_{name}", 0, lambda: alter.change_column_type(
            table, name, new_type), k1=(1, None))
        model.types[name] = None if new_type == "long" else new_type
        if new_type == "long":
            model.dtypes[name] = np.dtype(np.int64)
    schema = table.latest_snapshot().schema
    _check(schema["ss_quantity"].data_type == "long"
           and schema["ss_sales_price"].data_type == "decimal(9,2)"
           and step.counts.get("table.notify_advances", 0) == 1,
           "table_features widen: both types changed through the handoff")

    # 2. rows past 2^31, filters at the old and the new bounds
    q3 = np.flatnonzero(model.alive & model.ok["ss_sold_date_sk"]
                        & (model.v["ss_sold_date_sk"]
                           >= WIDE_LAST_QUARTER[0]))
    idx = q3[:TF_APPEND_ROWS]
    big = model.batch(idx)
    cols = dict(big.columns)
    cols["ss_ticket_number"] = Column((TF_APPEND_TICKET + np.arange(len(
        idx))).astype(model.dtypes["ss_ticket_number"]))
    cols["ss_quantity"] = Column(TF_BIG + TF_BIG_STEP * np.arange(
        len(idx), dtype=np.int64))
    big = Batch(cols, len(idx))
    step("append_big", len(idx), lambda: write_table(path, big, engine=eng))
    model.append(big)
    channel = np.r_[channel, np.full(len(idx), None, object)]
    qty, qty_ok = model.v["ss_quantity"], model.ok["ss_quantity"]
    names = ["ss_quantity", "ss_ticket_number", "ss_sales_price"]
    for what, pred, sel in (
            ("read_at_old_bound", col("ss_quantity") >= lit(100),
             qty >= 100),
            ("read_past_2_31", col("ss_quantity") > lit(TF_BIG + 5),
             qty > TF_BIG + 5)):
        hit = model.alive & qty_ok & sel
        snap = Table.for_path(path, engine=eng).latest_snapshot()
        got = step(what, int(hit.sum()), lambda: snap.scan(
            filter=pred, columns=names).to_batch(), k7=(1, 1))
        _held(got, model, names, f"table_features {what}", hit)

    # 3. ZORDER BY the widened column, a checkpoint, a reload, a full read
    table = Table.for_path(path, engine=eng)
    last = model.alive & model.ok["ss_sold_date_sk"] & (
        model.v["ss_sold_date_sk"] >= WIDE_LAST_QUARTER[0])
    m = step("zorder", int(last.sum()), lambda: table.optimize()
             .where(col("ss_sold_date_sk") >= lit(WIDE_LAST_QUARTER[0]))
             .execute_zorder_by("ss_quantity"), k4=(1, 1))
    out["steps"]["zorder"].update(files_removed=m.num_files_removed,
                                  files_added=m.num_files_added)
    step("checkpoint", 0, lambda: Table.for_path(
        path, engine=eng).checkpoint())
    parts = _newest_parts(log)
    snap = step("reload", 0, lambda: _loaded(path, eng),
                k3=(len(parts), len(parts)), k2=(1, None))
    _check(snap.schema["ss_quantity"].data_type == "long",
           "table_features reload: the widened schema")
    got = step("read_all", int(model.alive.sum()),
               lambda: snap.scan().to_batch())
    _held(got, model, model.names, "table_features read_all")
    _channels_held(got, model, channel, "table_features read_all")
    del got, snap

    # 4. LF_SS's MERGE with a new column, under schema evolution
    source, matched = _wide_merge_source(model, np.random.default_rng(24),
                                         "ss_profit", TF_MERGE_TICKET)
    promo = np.empty(source.num_rows, object)
    promo[:] = "lf_ss_promo"
    merged = Batch(dict(source.columns, **{TF_PROMO: Column(promo)}),
                   source.num_rows)
    table = Table.for_path(path, engine=eng)
    m = step("merge_evolve", source.num_rows, lambda: merge(
        table, merged, on=key).with_schema_evolution()
        .when_matched_update_all().when_not_matched_insert_all().execute(),
        k9=(1, 1))
    half = len(matched)
    _check((m.num_target_rows_updated, m.num_target_rows_inserted)
           == (half, half),
           f"table_features merge_evolve: {m.num_target_rows_updated} "
           f"updated, {m.num_target_rows_inserted} inserted of {half} each")
    model.alive[matched] = False
    model.append(source)
    channel = np.r_[channel, np.full(source.num_rows, None, object)]
    field = Table.for_path(path, engine=eng).latest_snapshot().schema[
        TF_PROMO]
    _check(field.physical_name.startswith("col-"),
           f"table_features merge_evolve: {TF_PROMO} mapped as "
           f"{field.physical_name}")
    # then a deletion vector: half the appended rows
    gone = model.alive & model.ok["ss_quantity"] & (
        model.v["ss_quantity"] > TF_DELETE_ABOVE)
    m = step("delete_big", int(gone.sum()), lambda: delete(
        Table.for_path(path, engine=eng),
        col("ss_quantity") > lit(TF_DELETE_ABOVE)), k7=(1, 1))
    _check(m.num_rows_deleted == int(gone.sum()) and m.num_dvs_written >= 1,
           f"table_features delete_big: {m.num_rows_deleted} rows, "
           f"{m.num_dvs_written} DVs")
    model.alive &= ~gone

    # 5. ADD CONSTRAINT: NULLs violate, then the NULL-tolerant body
    nulls = int((model.alive & ~model.ok["ss_quantity"]).sum())
    _check(nulls > 0, "table_features: ss_quantity holds NULLs")
    before_v = _head_version(path)

    def refused_constraint():
        try:
            add_constraint(Table.for_path(path, engine=eng), *TF_CHECK)
        except InvariantViolationError as e:
            return e.error_class
        return None

    _check(step("constraint_refused", int(model.alive.sum()),
                refused_constraint)
           == "DELTA_NEW_CHECK_CONSTRAINT_VIOLATION"
           and _head_version(path) == before_v,
           f"table_features constraint_refused: {nulls} NULL quantities "
           "violate, nothing committed")
    version = step("add_constraint", int(model.alive.sum()),
                   lambda: add_constraint(Table.for_path(path, engine=eng),
                                          *TF_CHECK_NULLS),
                   k8_decode=(1, 1))
    conf = Table.for_path(path, engine=eng).latest_snapshot() \
        .metadata.configuration
    _check(conf.get("delta.constraints.qty_nonneg")
           == "(ss_quantity IS NULL OR ss_quantity >= 0)"
           and _commit_actions(path, version).keys() >= {"metaData"},
           "table_features add_constraint: the constraint stored")

    # 6. a violating append and UPDATE refused, then DROP CONSTRAINT
    live_before = sorted(a.path for a in _loaded(path, eng).state.add_files)
    bad = model.batch(q3[:10])
    cols = dict(bad.columns)
    cols["ss_quantity"] = Column(np.full(10, -1, np.int64))
    bad = Batch(cols, 10)
    ticket = int(model.v["ss_ticket_number"][np.flatnonzero(
        model.alive)[0]])

    def violated(fn):
        def run():
            try:
                fn()
            except InvariantViolationError as e:
                return e.error_class
            return None
        return run

    for what, fn in (
            ("append_refused", lambda: write_table(path, bad, engine=eng)),
            ("update_refused", lambda: update(
                Table.for_path(path, engine=eng), {"ss_quantity": -5},
                col("ss_ticket_number") == lit(ticket)))):
        _check(step(what, 10, violated(fn))
               == "DELTA_VIOLATE_CONSTRAINT_WITH_VALUES"
               and _head_version(path) == version
               and sorted(a.path for a in _loaded(path, eng)
                          .state.add_files) == live_before,
               f"table_features {what}: refused, the version and the live "
               "files as they were")
    step("drop_constraint", 0, lambda: drop_constraint(
        Table.for_path(path, engine=eng), TF_CHECK[0]))
    got = step("read_after", int(model.alive.sum()), lambda: _loaded(
        path, eng).scan(columns=names + [TF_PROMO, "ss_item_sk"])
        .to_batch(), k8_decode=(1, 1))
    _held(got, model, names, "table_features read_after")
    c = got.column(TF_PROMO)
    ok = np.ones(got.num_rows, bool) if c.valid is None else c.valid
    _check(int(ok.sum()) == source.num_rows
           and set(c.values[ok].tolist()) == {"lf_ss_promo"},
           f"table_features read_after: {TF_PROMO} set on the "
           f"{source.num_rows} merged rows only")
    kept["a"]["channel"] = channel
    del got

    # (b) 7. a fresh table with identity, generated and default columns
    d = step19.column(CM_PARTITION)
    d_ok = np.ones(step19.num_rows, bool) if d.valid is None else d.valid
    lo, hi = CM_FIRST_QUARTER
    file0 = step19.column("ss_ticket_number").values // WIDE_TICKET_FILE == 0
    q0 = step19.take(np.flatnonzero((d_ok & (d.values >= lo)
                                     & (d.values < hi)) | (~d_ok & file0)))
    cols = dict(q0.columns)  # each linked copy's tickets its own
    cols["ss_ticket_number"] = Column(_renumber_tickets(
        q0.column("ss_item_sk").values,
        q0.column("ss_ticket_number").values))
    q0 = Batch(cols, q0.num_rows)
    fm = _WideModel(q0)
    _check(len(np.unique(fm.keys())) == q0.num_rows,
           "table_features: (ss_item_sk, ss_ticket_number) unique")
    cov, cov_ok = _covered(fm, np.arange(q0.num_rows))
    _check(cov[cov_ok].all() and cov_ok.any(),
           f"table_features: {TF_GENERATED[1]} holds on every row of "
           "step 19's first quarter")
    id_name, start, stride = TF_ID
    schema = StructType([identity_field(id_name, start, stride)]
                        + list(schema_of(q0).fields)
                        + [generated_field(TF_GENERATED[0], "boolean",
                                           TF_GENERATED[1]),
                           default_field(TF_DEFAULT[0], "string",
                                         TF_DEFAULT[1])])
    fresh = os.path.join(work, "table_features_fresh")
    wm = start - stride  # the next values run from wm + stride

    def commit_ids(version, n):
        """The commit's watermark moved n values past the last."""
        nonlocal wm
        md = _field_metadata(fresh, version, id_name)
        want = wm + stride * n
        _check(md is not None and md.get("delta.identity.highWaterMark")
               == want, f"table_features: commit {version}'s watermark "
               f"{md and md.get('delta.identity.highWaterMark')}, "
               f"expected {want}")
        ids = wm + stride * np.arange(1, n + 1)
        wm = want
        return ids

    version = step("fresh_write", q0.num_rows, lambda: write_table(
        fresh, q0, schema=schema, engine=eng))
    ids = [commit_ids(version, q0.num_rows)]
    for i, n in enumerate(TF_FRESH_APPENDS):
        idx = np.arange(n) + i * n
        rows = fm.batch(idx)
        cols = dict(rows.columns)
        cols["ss_ticket_number"] = Column((TF_FRESH_TICKET + i * n
                                           + np.arange(n)).astype(
            fm.dtypes["ss_ticket_number"]))
        rows = Batch(cols, n)
        version = step(f"fresh_append_{i}", n, lambda: write_table(
            fresh, rows, engine=eng))
        ids.append(commit_ids(version, n))
        fm.append(rows)
    # 8. LF_SS's MERGE into it: inserted rows take the next identities
    rng = np.random.default_rng(25)
    half = int(round(fm.alive.sum() * WIDE_MERGE_SHARE)) // 2
    live = np.flatnonzero(fm.alive)
    matched = np.sort(rng.choice(live, half, replace=False))
    source = fm.batch(np.r_[matched, rng.choice(live, half)])
    cols = dict(source.columns)
    cols["ss_quantity"] = Column(rng.integers(1, 101, 2 * half).astype(
        fm.dtypes["ss_quantity"]))
    ticket = cols["ss_ticket_number"].values.copy()
    ticket[half:] = TF_FRESH_MERGE_TICKET + np.arange(half)
    cols["ss_ticket_number"] = Column(ticket)
    source = Batch(cols, 2 * half)
    m = step("fresh_merge", source.num_rows, lambda: merge(
        Table.for_path(fresh, engine=eng), source, on=key)
        .when_matched_update(set={
            c: col(f"source.{c}") for c in ("ss_quantity", "ss_net_profit")})
        .when_not_matched_insert_all().execute(), k9=(1, 1))
    _check((m.num_target_rows_updated, m.num_target_rows_inserted)
           == (half, half),
           f"table_features fresh_merge: {m.num_target_rows_updated} "
           f"updated, {m.num_target_rows_inserted} inserted of {half} each")
    ids.append(commit_ids(m.version, half))
    fm.alive[matched] = False
    fm.append(source)
    got = step("fresh_read", int(fm.alive.sum()), lambda: _loaded(
        fresh, eng).scan(columns=[id_name, "ss_item_sk", "ss_ticket_number",
                                  "ss_net_paid", "ss_net_paid_inc_tax",
                                  TF_GENERATED[0], TF_DEFAULT[0]])
        .to_batch())
    _held(got, fm, ["ss_item_sk", "ss_ticket_number", "ss_net_paid",
                    "ss_net_paid_inc_tax"], "table_features fresh_read")
    idc = got.column(id_name)
    all_ids = np.concatenate(ids)  # the updated rows keep theirs
    _check(idc.valid is None and len(np.unique(idc.values)) == got.num_rows
           and sorted(idc.values.tolist()) == sorted(all_ids.tolist()),
           f"table_features fresh_read: {got.num_rows} identity values, "
           f"unique, by the step {stride} across {len(ids)} commits")
    # the generated and default values, row by row on the key
    k = (got.column("ss_item_sk").values.astype(np.int64) * (1 << 32)
         + got.column("ss_ticket_number").values)
    order = np.argsort(k, kind="stable")
    mk = fm.keys()[fm.alive]
    morder = np.argsort(mk, kind="stable")
    cov, cov_ok = _covered(fm, np.flatnonzero(fm.alive))
    g = got.column(TF_GENERATED[0])
    g_ok = np.ones(got.num_rows, bool) if g.valid is None else g.valid
    ch = got.column(TF_DEFAULT[0])
    _check(np.array_equal(k[order], mk[morder])
           and np.array_equal(g_ok[order], cov_ok[morder])
           and np.array_equal(g.values[order][g_ok[order]],
                              cov[morder][cov_ok[morder]])
           and (ch.valid is None or ch.valid.all())
           and set(ch.values.tolist()) == {TF_DEFAULT[2]},
           f"table_features fresh_read: {TF_GENERATED[0]} equals numpy's, "
           f"{TF_DEFAULT[0]} is {TF_DEFAULT[2]!r} on every row")
    out["fresh"] = {"rows": got.num_rows, "watermark": int(wm),
                    "commits": len(ids)}
    return out


# step 25: the change data feed
CDF_ON = {"delta.enableChangeDataFeed": "true"}
# (a) 2.: DF_SS over the first 80% of quarter 0's sold dates, > 4,096 of
# each of its files' 6,000 rows: bitmap DVs (K8 packs)
CDF_DELETE_RANGE = (2450816, 2451182)
CDF_UPDATE_QUARTER = 2          # (a) 3.: the middle copy of its tickets,
                                # DF_SS's survivors in one file
CDF_UPDATE_QUANTITY = 77
CDF_UPDATE_PROFIT = "12.34"
CDF_MERGE_TICKET = 8_500_000     # (a) 4.: LF_SS's new tickets
CDF_B_DATE_FROM = 60             # (b): the appended date copies its 61st
CDF_B_DELETE_DATE = 90           # (b): the deleted partition, its 91st
CDF_B_NEW_DATE = CM_FIRST_QUARTER[1] + 1
CDF_B_TICKET = 9_800_000         # (b): the appended rows' tickets
CDF_B_MERGE_KEYS = 60            # (b): live keys the MERGE updates (each
                                 # in every linked copy)
CDF_B_MERGE_TICKET = 9_900_000   # (b): the MERGE's new tickets
_NULL = np.iinfo(np.int64).min   # a null in a compared tuple


def _tuples(cols: list) -> np.ndarray:
    """Rows of (values, valid) int64 columns as an [n, k] array, nulls as
    _NULL, sorted lexicographically."""
    if not cols or not len(cols[0][0]):
        return np.zeros((0, len(cols)), np.int64)
    out = np.stack([np.where(ok, np.asarray(v, np.int64), _NULL)
                    for v, ok in cols], 1)
    return out[np.lexsort(out.T[::-1])]


def _feed_groups(feed, names) -> dict:
    """{(version, change type): `_tuples` of the feed's rows over
    `names`}."""
    ver = feed.column("_commit_version").values
    kind = feed.column("_change_type").values
    out = {}
    for v in np.unique(ver).tolist():
        at = ver == v
        for t in sorted(set(kind[at].tolist())):
            sel = np.flatnonzero(at & (kind == t))
            cols = []
            for c in names:
                col = feed.column(c)
                ok = (np.ones(len(sel), bool) if col.valid is None
                      else col.valid[sel])
                cols.append((col.values[sel], ok))
            out[(v, t)] = _tuples(cols)
    return out


def _model_tuples(model, idx, names) -> np.ndarray:
    return _tuples([(model.v[c][idx], model.ok[c][idx]) for c in names])


def _signed(pos: np.ndarray, neg: np.ndarray) -> tuple:
    """pos minus neg as a signed multiset: (distinct rows, their
    counts), the rows of count 0 left out."""
    rows = np.concatenate([pos, neg])
    if not len(rows):
        return rows, np.zeros(0)
    u, inv = np.unique(rows, axis=0, return_inverse=True)
    c = np.bincount(inv.reshape(-1), weights=np.r_[np.ones(len(pos)),
                                                   -np.ones(len(neg))],
                    minlength=len(u))
    return u[c != 0], c[c != 0]


def _feed_held(feed, want: dict, names, what: str) -> None:
    """The feed's groups equal `want` ({(version, change type): tuples}),
    none more."""
    got = _feed_groups(feed, names)
    _check(sorted(got) == sorted(want),
           f"{what}: the feed's groups {sorted(got)}, expected "
           f"{sorted(want)}")
    for k, rows in want.items():
        _check(np.array_equal(got[k], rows),
               f"{what}: {k}: {len(got[k])} rows, the model's {len(rows)}")


def _commit_stamps_held(feed, path: str, what: str) -> None:
    """Each row's _commit_timestamp is its commit's commitInfo
    timestamp."""
    ver = feed.column("_commit_version").values
    ts = feed.column("_commit_timestamp").values
    for v in np.unique(ver).tolist():
        want = _commit_actions(path, v)["commitInfo"][0]["timestamp"]
        _check(bool((ts[ver == v] == want).all()),
               f"{what}: version {v}'s _commit_timestamp {want}")


def _cdc_paths_held(path: str, version: int, schema, key, what: str
                    ) -> list:
    """The commit's change data files in Delta's form: under
    `_change_data/` (and `<key>=<value>/` on a partitioned table), the
    physical names and `_change_type` in the footer, no partition column,
    dataChange false. Returns the `cdc` actions."""
    cdcs = _commit_actions(path, version).get("cdc", [])
    _check(len(cdcs) > 0, f"{what}: change data files in commit {version}")
    names = {f.physical_name for f in schema.fields} | {"_change_type"}
    for c in cdcs:
        rel = c["path"]
        top = _footer_names(os.path.join(path, rel))
        if key is None:
            ok = rel.startswith("_change_data/cdc-")
        else:
            ok = (rel.startswith(f"_change_data/{key}=")
                  and list(c["partitionValues"]) == [key] and key not in top)
        _check(ok and not c["dataChange"] and "_change_type" in top
               and top <= names,
               f"{what}: {rel} in Delta's form ({sorted(top)[:4]}...)")
    return cdcs


def _data_changing_before(path: str, version: int) -> int:
    """The newest commit before `version` with a data-changing action."""
    for v in range(version - 1, -1, -1):
        acts = _commit_actions(path, v)
        if any(a.get("dataChange") for k in ("add", "remove")
               for a in acts.get(k, [])):
            return v
    raise AssertionError(f"no data-changing commit before {version}")


def _live_records(actions: list) -> int:
    """Σ numRecords − DV cardinality over add or remove actions."""
    n = 0
    for a in actions:
        n += json.loads(a["stats"])["numRecords"]
        dv = a.get("deletionVector")
        n -= dv["cardinality"] if dv else 0
    return n


def change_data_feed_phase(kept: dict, device: str, card: str) -> dict:
    """Step 25: the change data feed on the card, each step's counters
    from 0 and its rows against the numpy models carried from step 24
    (`kept`: `column_mapping_phase`'s `keep`, after steps 22-24):
    (a) the name-mode DV table: 1. `delta.enableChangeDataFeed` on (the
       protocol lists changeDataFeed; K1 on the handoff); 2. DF_SS's
       DELETE of CDF_DELETE_RANGE's sold dates (K7 plans, K8 packs the
       bitmap DVs), its change data file in Delta's form; 3. an UPDATE of
       the few hundred rows of the middle copy of CDF_UPDATE_QUARTER's
       tickets (K7); 4. LF_SS's 1% MERGE
       (K9), half updates, half inserts; 5. `table_changes` over [1.'s
       version + 1, the head] (K1 on the range): per version and change
       type the multiset of (ss_item_sk, ss_ticket_number, ss_profit)
       equals the model's, each `_commit_timestamp` its commit's; the
       same read by timestamp bounds gives the same rows; a range from
       the last data-changing commit before 1. raises
       DELTA_MISSING_CHANGE_DATA; 6. RESTORE to 1.'s version (removes
       and adds of DV'd files, no change data): its feed's deletes are
       Σ numRecords − DV cardinality of the removed files, its inserts
       the same of the added ones, inserts minus deletes as multisets the
       model's rows at 1. minus its rows at the head, every DV of the read
       decoded in one K8 launch;
    (b) the partitioned name-mode table: 7. the feed on, an append of a
       new date (no change data: its feed made from the adds), a DELETE
       of one date's partition (removed whole), a 1% MERGE (K9) whose
       change data files lie under `_change_data/<physical key>=<date>/`
       with physical names; `table_changes` over these versions: the
       partition column restored, (ss_item_sk, ss_ticket_number,
       ss_sold_date) equal to the model's per version and change type.
    Returns each step's seconds, rows/s and launches."""
    import decimal

    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.commands import alter
    from delta_tpu_torch.commands.dml import delete, update
    from delta_tpu_torch.commands.merge import merge
    from delta_tpu_torch.commands.restore import restore
    from delta_tpu_torch.errors import InvalidArgumentError
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.models.batch import Batch, Column
    from delta_tpu_torch.read.cdc import table_changes

    eng = TorchEngine(device)
    out = {"card": card, "steps": {}}
    step = _stepper(out, eng, "change_data_feed")
    key = (col("target.ss_item_sk") == col("source.ss_item_sk")) \
        & (col("target.ss_ticket_number") == col("source.ss_ticket_number"))

    def loaded_table(p):
        t = Table.for_path(p, engine=eng)
        t.latest_snapshot().state
        return t

    def flag(p, what):
        t = loaded_table(p)
        v = step(what, 0, lambda: alter.set_properties(t, CDF_ON),
                 k1=(1, None))
        proto = Table.for_path(p, engine=eng).latest_snapshot().protocol
        _check("changeDataFeed" in (proto.writerFeatures or [])
               or (proto.writerFeatures is None
                   and proto.minWriterVersion >= 4),
               f"change_data_feed {what}: the protocol {proto}")
        return v

    # (a) 1. the flag
    path, model = kept["a"]["path"], kept["a"]["model"]
    profit = CM_RENAME[1]
    names = ["ss_item_sk", "ss_ticket_number", profit]
    out["a_rows"] = int(model.alive.sum())
    v_on = flag(path, "a_set_cdf")
    alive_on = model.alive.copy()
    want = {}

    # 2. DF_SS: the sold-date range, DVs of bitmap containers
    date, date_ok = model.v["ss_sold_date_sk"], model.ok["ss_sold_date_sk"]
    lo, hi = CDF_DELETE_RANGE
    gone = model.alive & date_ok & (date >= lo) & (date < hi)
    m = step("a_delete", int(gone.sum()), lambda: delete(
        Table.for_path(path, engine=eng),
        (col("ss_sold_date_sk") >= lit(lo))
        & (col("ss_sold_date_sk") < lit(hi))), k7=(1, 1), k8_pack=(1, 1))
    _check(m.num_rows_deleted == int(gone.sum()) and m.num_dvs_written > 0,
           f"change_data_feed a_delete: {m.num_rows_deleted} rows, "
           f"{m.num_dvs_written} DVs")
    schema = Table.for_path(path, engine=eng).latest_snapshot().schema
    _cdc_paths_held(path, m.version, schema, None,
                    "change_data_feed a_delete")
    want[(m.version, "delete")] = _model_tuples(model, gone, names)
    model.alive &= ~gone

    # 3. UPDATE of a few hundred rows: a quantity and a profit
    ticket = model.v["ss_ticket_number"]
    quarter = model.alive & (ticket // WIDE_TICKETS[0] == CDF_UPDATE_QUARTER)
    copies = np.unique(ticket[quarter] % WIDE_TICKETS[0] // WIDE_TICKETS[1])
    t0 = (CDF_UPDATE_QUARTER * WIDE_TICKETS[0]
          + int(copies[len(copies) // 2]) * WIDE_TICKETS[1])
    t1 = t0 + WIDE_TICKETS[1]
    hit = model.alive & (ticket >= t0) & (ticket < t1)
    idx = np.flatnonzero(hit)
    new = model.batch(idx)
    cols = dict(new.columns)
    cols["ss_quantity"] = Column(np.full(len(idx), CDF_UPDATE_QUANTITY,
                                         model.dtypes["ss_quantity"]),
                                 None, model.types["ss_quantity"])
    cols[profit] = Column(np.full(len(idx), int(decimal.Decimal(
        CDF_UPDATE_PROFIT).scaleb(2)), model.dtypes[profit]), None,
        model.types[profit])
    new = Batch(cols, len(idx))
    m = step("a_update", len(idx), lambda: update(
        Table.for_path(path, engine=eng),
        {"ss_quantity": CDF_UPDATE_QUANTITY,
         profit: lit(decimal.Decimal(CDF_UPDATE_PROFIT))},
        (col("ss_ticket_number") >= lit(t0))
        & (col("ss_ticket_number") < lit(t1))), k7=(1, 1))
    _check(m.num_rows_updated == len(idx) and 100 <= len(idx) <= 2_000,
           f"change_data_feed a_update: {m.num_rows_updated} rows of "
           f"{len(idx)}")
    want[(m.version, "update_preimage")] = _model_tuples(model, idx, names)
    model.alive[idx] = False
    n0 = len(model.alive)
    model.append(new)
    want[(m.version, "update_postimage")] = _model_tuples(
        model, np.arange(n0, len(model.alive)), names)

    # 4. LF_SS's 1% MERGE: half updates, half inserts
    source, matched = _wide_merge_source(model, np.random.default_rng(26),
                                         profit, CDF_MERGE_TICKET)
    half = len(matched)
    m = step("a_merge", source.num_rows, lambda: merge(
        Table.for_path(path, engine=eng), source, on=key)
        .when_matched_update_all().when_not_matched_insert_all().execute(),
        k9=(1, 1))
    _check((m.num_target_rows_updated, m.num_target_rows_inserted)
           == (half, half),
           f"change_data_feed a_merge: {m.num_target_rows_updated} "
           f"updated, {m.num_target_rows_inserted} inserted of {half} each")
    want[(m.version, "update_preimage")] = _model_tuples(model, matched,
                                                         names)
    model.alive[matched] = False
    n0 = len(model.alive)
    model.append(source)
    want[(m.version, "update_postimage")] = _model_tuples(
        model, np.arange(n0, n0 + half), names)
    want[(m.version, "insert")] = _model_tuples(
        model, np.arange(n0 + half, len(model.alive)), names)
    head = m.version

    # 5. the feed over the range, by versions and by timestamps
    feed = step("a_feed", sum(len(r) for r in want.values()),
                lambda: table_changes(Table.for_path(path, engine=eng),
                                      v_on + 1, head), k1=(1, None))
    _feed_held(feed, want, names, "change_data_feed a_feed")
    _commit_stamps_held(feed, path, "change_data_feed a_feed")
    stamps = {r.version: r.timestamp_ms
              for r in Table.for_path(path, engine=eng).history(
                  limit=head - v_on + 1)}
    by_time = step("a_feed_by_time", feed.num_rows, lambda: table_changes(
        Table.for_path(path, engine=eng), starting_timestamp=stamps[v_on + 1],
        ending_timestamp=stamps[head]), k1=(1, None))
    _feed_held(by_time, want, names, "change_data_feed a_feed_by_time")
    out["a_feed"] = {"rows": feed.num_rows, "versions": [v_on + 1, head],
                     "groups": {f"{v} {t}": len(r)
                                for (v, t), r in want.items()}}
    del feed, by_time
    early = _data_changing_before(path, v_on)

    def missing():
        try:
            table_changes(Table.for_path(path, engine=eng), early, head)
        except InvalidArgumentError as e:
            return e.error_class
        return None

    _check(step("a_feed_missing", 0, missing) == "DELTA_MISSING_CHANGE_DATA",
           f"change_data_feed a_feed_missing: [{early}, {head}] refused")

    # 6. RESTORE to 1.'s version: a feed made from DV'd removes and adds
    rm = step("a_restore", 0, lambda: restore(
        Table.for_path(path, engine=eng), version=v_on), k1=(1, None))
    acts = _commit_actions(path, rm.version)
    removed = [a for a in acts.get("remove", []) if a["dataChange"]]
    added = [a for a in acts.get("add", []) if a["dataChange"]]
    _check("cdc" not in acts and any(a.get("deletionVector")
                                     for a in removed),
           "change_data_feed a_restore: removes of DV'd files, no change "
           "data")
    n_del, n_ins = _live_records(removed), _live_records(added)
    feed = step("a_restore_feed", n_del + n_ins, lambda: table_changes(
        Table.for_path(path, engine=eng), rm.version, rm.version),
        k1=(1, None), k8_decode=(1, 1))
    dvs = step.counts.get("kernel.dv_bits.decode_dvs", 0)
    _check(eng.device.type == "cpu"
           or dvs == sum(bool(a.get("deletionVector"))
                         for a in removed + added),
           f"change_data_feed a_restore_feed: {dvs} DVs in one decode")
    groups = _feed_groups(feed, names)
    ins = groups.get((rm.version, "insert"), np.zeros((0, 3), np.int64))
    dels = groups.get((rm.version, "delete"), np.zeros((0, 3), np.int64))
    _check((len(dels), len(ins)) == (n_del, n_ins),
           f"change_data_feed a_restore_feed: {len(dels)} deletes, "
           f"{len(ins)} inserts; the actions' {n_del}, {n_ins}")
    on = np.r_[alive_on, np.zeros(len(model.alive) - len(alive_on), bool)]
    got_u, got_c = _signed(ins, dels)
    want_u, want_c = _signed(_model_tuples(model, on & ~model.alive, names),
                             _model_tuples(model, model.alive & ~on, names))
    _check(np.array_equal(got_u, want_u) and np.array_equal(got_c, want_c),
           f"change_data_feed a_restore_feed: inserts minus deletes "
           f"({len(got_u)} rows) equal the model's rows at {v_on} minus "
           f"its rows at the head ({len(want_u)})")
    out["a_restore"] = {"removed": len(removed), "added": len(added),
                        "deletes": n_del, "inserts": n_ins, "dvs": dvs}
    model.alive = on
    del feed

    # (b) 7. the partitioned name-mode table
    fpath, fm = kept["b"]["path"], kept["b"]["model"]
    part = CM_PARTITION_RENAMED
    bnames = ["ss_item_sk", "ss_ticket_number", part]
    out["b_rows"] = int(fm.alive.sum())
    v_b = flag(fpath, "b_set_cdf")
    pkey = _loaded(fpath, eng).schema[part].physical_name
    bwant = {}
    fdate, fdate_ok = fm.v[part], fm.ok[part]
    dates = np.unique(fdate[fm.alive & fdate_ok])
    like = np.flatnonzero(fm.alive & fdate_ok
                          & (fdate == dates[CDF_B_DATE_FROM]))
    rows = fm.batch(like)
    cols = dict(rows.columns)
    cols[part] = Column(np.full(len(like), CDF_B_NEW_DATE,
                                fm.dtypes[part]), None, fm.types[part])
    cols["ss_ticket_number"] = Column((CDF_B_TICKET + np.arange(
        len(like))).astype(fm.dtypes["ss_ticket_number"]))
    rows = Batch(cols, len(like))
    v = step("b_append", len(like), lambda: write_table(fpath, rows,
                                                        engine=eng))
    _check("cdc" not in _commit_actions(fpath, v),
           "change_data_feed b_append: no change data")
    n0 = len(fm.alive)
    fm.append(rows)
    bwant[(v, "insert")] = _model_tuples(fm, np.arange(n0, len(fm.alive)),
                                         bnames)
    d = int(dates[CDF_B_DELETE_DATE])
    gone = fm.alive & fm.ok[part] & (fm.v[part] == d)
    m = step("b_delete_partition", int(gone.sum()), lambda: delete(
        Table.for_path(fpath, engine=eng), col(part) == lit(d)))
    _check(m.num_files_removed_fully > 0 and m.num_dvs_written == 0
           and m.num_files_rewritten == 0,
           f"change_data_feed b_delete_partition: {d}'s files removed whole")
    schema = Table.for_path(fpath, engine=eng).latest_snapshot().schema
    _cdc_paths_held(fpath, m.version, schema, pkey,
                    "change_data_feed b_delete_partition")
    bwant[(m.version, "delete")] = _model_tuples(fm, gone, bnames)
    fm.alive &= ~gone
    # a 1% MERGE: CDF_B_MERGE_KEYS live keys updated in every copy, as
    # many new rows inserted
    rng = np.random.default_rng(27)
    keys = fm.keys()
    live = np.flatnonzero(fm.alive)
    pick = rng.choice(np.unique(keys[live]), CDF_B_MERGE_KEYS, replace=False)
    first = live[np.unique(keys[live], return_index=True)[1]]
    first = first[np.isin(keys[first], pick)]
    n_new = int(round(fm.alive.sum() * WIDE_MERGE_SHARE)) - len(first)
    like = rng.choice(live, n_new)
    src = fm.batch(np.r_[first, like])
    cols = dict(src.columns)
    qty = rng.integers(1, 101, len(first) + n_new)
    cols["ss_quantity"] = Column(qty.astype(fm.dtypes["ss_quantity"]), None,
                                 fm.types["ss_quantity"])
    tk = cols["ss_ticket_number"].values.copy()
    tk[len(first):] = CDF_B_MERGE_TICKET + np.arange(n_new)
    cols["ss_ticket_number"] = Column(tk)
    src = Batch(cols, len(first) + n_new)
    matched = fm.alive & np.isin(keys, pick)
    m = step("b_merge", src.num_rows, lambda: merge(
        Table.for_path(fpath, engine=eng), src, on=key)
        .when_matched_update(set={"ss_quantity": col("source.ss_quantity")})
        .when_not_matched_insert_all().execute(), k9=(1, 1))
    _check((m.num_target_rows_updated, m.num_target_rows_inserted)
           == (int(matched.sum()), n_new),
           f"change_data_feed b_merge: {m.num_target_rows_updated} updated "
           f"({int(matched.sum())}), {m.num_target_rows_inserted} inserted "
           f"({n_new})")
    cdcs = _cdc_paths_held(fpath, m.version, schema, pkey,
                           "change_data_feed b_merge")
    idx = np.flatnonzero(matched)
    bwant[(m.version, "update_preimage")] = _model_tuples(fm, idx, bnames)
    bwant[(m.version, "update_postimage")] = bwant[(m.version,
                                                    "update_preimage")]
    # each copy of a picked key takes its source row's quantity
    by_key = dict(zip(keys[first].tolist(), qty[:len(first)].tolist()))
    fm.v["ss_quantity"][idx] = [by_key[k] for k in keys[idx].tolist()]
    fm.ok["ss_quantity"][idx] = True
    n0 = len(fm.alive)
    fm.append(src.take(np.arange(len(first), src.num_rows)))
    bwant[(m.version, "insert")] = _model_tuples(
        fm, np.arange(n0, len(fm.alive)), bnames)
    feed = step("b_feed", sum(len(r) for r in bwant.values()),
                lambda: table_changes(Table.for_path(fpath, engine=eng),
                                      v_b + 1, m.version), k1=(1, None))
    _check(feed.column_names[:-3][-1] == part,
           f"change_data_feed b_feed: the columns {feed.column_names}")
    _feed_held(feed, bwant, bnames, "change_data_feed b_feed")
    _commit_stamps_held(feed, fpath, "change_data_feed b_feed")
    out["b_feed"] = {"rows": feed.num_rows, "cdc_files": len(cdcs),
                     "groups": {f"{v} {t}": len(r)
                                for (v, t), r in bwant.items()}}
    return out


# step 26: device SQL, TPC-DS's 102 texts

SQL_SMALL_SCALE = 12_000
SQL_FULL_SCALE = 2_880_404          # SF1's store_sales row count
# the store_sales star joins with the largest group-bys, q17's
# stddev_samp, and one text for each nested construct: q59 a CTE
# self-joined, q65 nested derived tables, q32 a correlated scalar, q87
# EXCEPT; and one for each construct of the third slice: q98 a partition
# SUM window, q27 ROLLUP, q97 a FULL OUTER JOIN of two channels, q28
# COUNT(DISTINCT) over six buckets, q86 rank() over ROLLUP's levels, q51
# running windows (ROWS frames) and a FULL OUTER JOIN, and q51 in the
# RANGE frame (the peer pass); at full width
SQL_FULL_QUERIES = ("q3", "q7", "q42", "q43", "q52", "q55", "q96", "q17",
                    "q59", "q65", "q32", "q87", "q98", "q27", "q97", "q28",
                    "q86", "q51", "q51_range")
# the tables those texts read (the generator draws every table)
SQL_FULL_TABLES = ("date_dim", "time_dim", "item", "customer_demographics",
                   "household_demographics", "promotion", "store",
                   "store_sales", "store_returns", "catalog_sales",
                   "web_sales", "customer")
SQL_SQLITE_WORKERS = 3   # (a)'s sqlite threads, beside the card's queries
SQL_K = {"k1": "kernel.byte_class.launches",
         "k2": "kernel.winner_pack.launches",
         "k3": "kernel.hybrid_extract.launches",
         "k7": "kernel.skip_mask.launches",
         "k10": "kernel.seg_agg.launches",
         "k11_ranks": "kernel.window_ranks.launches",
         "k11_running": "kernel.window_running.launches",
         "k11_peers": "kernel.window_peer_last.launches"}
K11_ROWS = {"k11_ranks": ("window_ranks", "delta_tpu/ops/sqlops.py:543"),
            "k11_running": ("window_running",
                            "delta_tpu/ops/sqlops.py:585"),
            "k11_peers": ("window_peer_last",
                          "delta_tpu/ops/sqlops.py:655")}
# a query that aggregates and returns rows launches K10 (a GROUP BY with
# no aggregate, q37 and q82, only dedupes its keys on the host; a GROUP BY
# over no rows has no group to launch for)
_SQL_AGG = re.compile(r"\b(sum|avg|count|min|max|stddev_samp)\s*\(",
                      re.IGNORECASE)
# no corpus text has a running window in SQL's default RANGE frame (q51's
# are ROWS frames): q51 with them left to the default runs the peer pass
_ROWS_FRAME = re.compile(r"\s+rows\s+between\s+unbounded\s+preceding\s+"
                         r"and\s+current\s+row", re.IGNORECASE)


def _sql_texts(queries: dict) -> dict:
    """The corpus' texts and q51 in the RANGE frame (`q51_range`)."""
    return dict(queries, q51_range=_ROWS_FRAME.sub("", queries["q51"]))


def _strip_limit(q: str) -> str:
    return re.sub(r"\blimit\s+\d+\s*$", "", q.strip(), flags=re.IGNORECASE)


def _sqlite_rewrite(q: str) -> str:
    """The mechanical rewrites of `tests/tpcds_sqlite_oracle.py::_rewrite`
    (kept here: the card's machine has no Arrow): padded date literals,
    real division outside string literals, date arithmetic as sqlite's
    date(), no parentheses around a compound select's operands (q87),
    stddev_samp by sums of squares, CAST AS decimal as REAL, no trailing
    ORDER BY, GROUP BY ROLLUP as a UNION ALL of its levels."""
    q = re.sub(r"'(\d{4})-(\d{1,2})-(\d{1,2})'",
               lambda m: f"'{m.group(1)}-{int(m.group(2)):02d}-"
                         f"{int(m.group(3)):02d}'", q)
    parts = q.split("'")
    q = "'".join(p.replace("/", "*1.0/") if i % 2 == 0 else p
                 for i, p in enumerate(parts))
    q = re.sub(r"\(\s*cast\s*\(\s*'([0-9-]+)'\s+as\s+date\s*\)\s*([+-])\s*"
               r"interval\s+(\d+)\s+days?\s*\)",
               r"date('\1','\g<2>\3 days')", q, flags=re.IGNORECASE)
    q = re.sub(r"([a-z_][\w.]*\.?d_date)\s*([+-])\s*interval\s+(\d+)\s+days?",
               r"date(\1,'\g<2>\3 days')", q, flags=re.IGNORECASE)
    q = re.sub(r"cast\s*\(\s*'([0-9-]+)'\s+as\s+date\s*\)", r"'\1'", q,
               flags=re.IGNORECASE)
    q = re.sub(r"cast\s*\(\s*([a-z_][\w.]*)\s+as\s+date\s*\)", r"\1", q,
               flags=re.IGNORECASE)
    q = re.sub(r"\)\s*(union\s+all|union|intersect|except)\s*\(", r" \1 ", q,
               flags=re.IGNORECASE)
    q = re.sub(r"\border\s+by\s+[^()]*$", "", q, flags=re.IGNORECASE)
    q = re.sub(r"stddev_samp\s*\(\s*([a-z_][a-z0-9_.]*)\s*\)",
               r"(case when count(\1) > 1 then sqrt(max(0.0,"
               r"(1.0*sum(1.0*\1*\1) - 1.0*sum(\1)*sum(\1)/count(\1))"
               r"/(count(\1)-1))) else null end)", q, flags=re.IGNORECASE)
    q = re.sub(r"cast\s*\(\s*([^()]+?)\s+as\s+decimal\s*\([^)]*\)\s*\)",
               r"CAST(\1 AS REAL)", q, flags=re.IGNORECASE)
    return _expand_rollup(q)


def _expand_rollup(q: str) -> str:
    """`tests/tpcds_sqlite_oracle.py::_expand_rollup`: sqlite has no GROUP
    BY ROLLUP, so the owning SELECT becomes a UNION ALL of one aggregation
    per key prefix, where the rolled-up keys of its select list are NULL
    and `grouping(k)` is the 0/1 constant; the WHERE clause is untouched
    and the trailing ORDER BY dropped (the comparison ignores order)."""
    m = re.search(r"group\s+by\s+rollup\s*\(([^)]*)\)", q, re.IGNORECASE)
    if not m:
        return q
    keys = [k.strip() for k in m.group(1).split(",")]

    def depth0_positions(text, word):
        out = []
        depth = 0
        for mo in re.finditer(r"[()]|\b" + word + r"\b", text,
                              re.IGNORECASE):
            tok = mo.group(0)
            if tok == "(":
                depth += 1
            elif tok == ")":
                depth -= 1
            elif depth == 0:
                out.append(mo.start())
        return out

    head = q[:m.start()]
    sel_start = depth0_positions(head, "select")[-1]
    from_start = [p for p in depth0_positions(head, "from")
                  if p > sel_start][0]
    select_list = q[sel_start:from_start]
    branches = []
    for level in range(len(keys), -1, -1):
        sl = select_list
        for j, k in enumerate(keys):
            sl = re.sub(r"grouping\s*\(\s*" + re.escape(k) + r"\s*\)",
                        "1" if j >= level else "0", sl, flags=re.IGNORECASE)
            if j >= level:
                sl = re.sub(r"\b" + re.escape(k) + r"\b", "NULL", sl,
                            flags=re.IGNORECASE)
        gb = ("GROUP BY " + ", ".join(keys[:level])) if level else ""
        branches.append(sl + q[from_start:m.start()] + gb + " ")
    tail = re.sub(r"\border\s+by\b.*$", "", q[m.end():],
                  flags=re.IGNORECASE | re.DOTALL)
    return q[:sel_start] + " UNION ALL ".join(branches) + " " + tail


def _sqlite_of(tables: dict, path: str) -> None:
    """A sqlite3 database file at `path`, loaded from the generator's
    columns (dates as ISO strings; sqlite stores a NaN as NULL, as the
    oracle's load does), every `*_sk` column indexed and the tables
    analyzed, as `tests/tpcds_sqlite_oracle.py::create_indexes` does: the
    plans change, not the answers."""
    import sqlite3

    conn = sqlite3.connect(path)
    conn.execute("PRAGMA journal_mode=OFF")
    conn.execute("PRAGMA synchronous=OFF")
    for name, batch in tables.items():
        cols = batch.column_names
        conn.execute(f"CREATE TABLE {name} ({', '.join(cols)})")
        values = []
        for c in cols:
            py = batch.column(c).to_python()
            if batch.column(c).values.dtype.kind == "M":
                py = [None if v is None else v.isoformat() for v in py]
            values.append(py)
        conn.executemany(f"INSERT INTO {name} VALUES "
                         f"({','.join('?' * len(cols))})", zip(*values))
        for c in cols:
            if c.endswith("_sk"):
                conn.execute(f"CREATE INDEX idx_{name}_{c} ON {name} ({c})")
    conn.execute("ANALYZE")
    conn.commit()
    conn.close()


def _sqlite_answers(path: str, texts: dict, workers: int) -> dict:
    """Each text's rows from the sqlite database at `path` (rewritten by
    `_sqlite_rewrite`), `workers` threads with a connection each (sqlite
    leaves the GIL while it runs a statement)."""
    import math
    import sqlite3
    import threading

    names = iter(list(texts))
    lock = threading.Lock()
    out = {}

    def work():
        conn = sqlite3.connect(path)
        conn.create_function("sqrt", 1, math.sqrt)
        try:
            while True:
                with lock:
                    name = next(names, None)
                if name is None:
                    return
                out[name] = conn.execute(
                    _sqlite_rewrite(texts[name])).fetchall()
        except BaseException as e:  # reported by the caller
            out["__error__"] = repr(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=work, daemon=True)
               for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _norm_cell(v):
    import datetime as _dt
    import math

    if isinstance(v, float):
        return None if math.isnan(v) else round(v, 3)
    if isinstance(v, _dt.date):
        return v.isoformat()[:10]
    return v


def _rows_equal(got, want, tol: float = 2e-4) -> tuple:
    """`tests/tpcds_sqlite_oracle.py::rows_equal`: order-insensitive
    multiset equality, floats to `tol` relative. At the oracle's 2e-4 the
    floats are compared rounded to 3 decimals, as there; a tighter `tol`
    compares them unrounded (the rounding is then only the sort key's)."""
    rounded = tol >= 2e-4

    def cell(v):
        if not rounded and isinstance(v, float):
            return None if v != v else v
        return _norm_cell(v)

    if len(got) != len(want):
        return False, f"row count {len(got)} != {len(want)}"

    def key(row):
        out = []
        for v in row:
            v = _norm_cell(v)
            if isinstance(v, bool):
                out.append(f"bool:{v}")
            elif isinstance(v, (int, float)):
                out.append(f"num:{float(v):.3f}")
            else:
                out.append(f"{type(v).__name__}:{v}")
        return tuple(out)

    for i, (ra, rb) in enumerate(zip(sorted(got, key=key),
                                     sorted(want, key=key))):
        if len(ra) != len(rb):
            return False, f"row {i}: width {len(ra)} != {len(rb)}"
        for j, (va, vb) in enumerate(zip(ra, rb)):
            va, vb = cell(va), cell(vb)
            if va is None and vb is None:
                continue
            if isinstance(va, float) or isinstance(vb, float):
                if va is None or vb is None or abs(va - vb) > tol * max(
                        1.0, abs(va), abs(vb)):
                    return False, f"row {i} col {j}: {va!r} vs {vb!r}"
            elif va != vb:
                return False, f"row {i} col {j}: {va!r} vs {vb!r}"
    return True, "ok"


def _sql_launches(counts: dict) -> dict:
    return {k: counts.get(name, 0) for k, name in SQL_K.items()}


def _k10_times(codes, values, valid, op: str, n_groups: int,
               means=None) -> dict:
    """K10 on one input: against its plain version on the card (ints and
    counts exact, float sums to 1e-12 relative), timed beside it, beside
    `scatter_reduce_(include_self=False)` on pre-masked values (the one
    library call) and its bound."""
    from delta_tpu_torch.ops.segagg import seg_agg, seg_agg_plain

    got = seg_agg(codes, values, valid, op, n_groups, means)
    torch.cuda.synchronize()
    want = seg_agg_plain(codes, values, valid, op, n_groups, means)
    _check(torch.equal(got[1], want[1]), f"seg_agg count != plain ({op})")
    if got[0].dtype == torch.float64 and op in ("sum", "sumsq"):
        err = float((got[0] - want[0]).abs().max()) if n_groups else 0.0
        _check(torch.allclose(got[0], want[0], rtol=1e-12, atol=1e-9),
               f"seg_agg {op} != plain within 1e-12")
    else:
        _check(torch.equal(got[0].view(torch.int64),
                           want[0].view(torch.int64)),
               f"seg_agg {op} != plain bit for bit")
        err = 0.0
    n = codes.numel()
    call = lambda: seg_agg(codes, values, valid, op, n_groups, means)  # noqa
    idx = codes.to(torch.int64)
    keep = valid if valid is not None else torch.ones_like(codes,
                                                           dtype=torch.bool)
    if op == "sumsq":
        d = values - means[idx]
        masked = torch.where(keep, d * d, 0.0)
    elif op == "count":
        masked = keep.to(torch.int64)
    else:
        masked = torch.where(keep, values, torch.zeros((), dtype=values.dtype,
                                                       device=values.device))
    reduce = {"min": "amin", "max": "amax"}.get(op, "sum")
    out = torch.zeros(n_groups, dtype=masked.dtype, device=codes.device)
    library = lambda: out.scatter_reduce_(0, idx, masked, reduce,  # noqa
                                          include_self=False)
    # each input read once: 4 B code, 8 B value (a count reads none),
    # 1 B valid where there is a mask; 16 B out per group, plus 8 B of
    # means for the sumsq pass
    reads_values = values is not None and op != "count"
    row_bytes = 4.0 + (8.0 if reads_values else 0.0) + (
        1.0 if valid is not None else 0.0)
    nbytes = row_bytes * n + 16.0 * n_groups + (
        8.0 * n_groups if op == "sumsq" else 0.0)
    bound, by = _bound_ms(nbytes, float(n))
    ms = _time_ms(call, 50)
    seen = []
    dev_ms = _device_ms(call, 50, ("seg_agg",), launches=seen)
    return {"op": op, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "launches_per_call": seen[0] and seen[0]["per_call"],
            "device_kernels": seen[0] and seen[0]["kernels"],
            "plain_ms": _time_ms(lambda: seg_agg_plain(
                codes, values, valid, op, n_groups, means), 10),
            "plain_device": "cuda",
            "library_ms": _time_ms(library, 50),
            "library_call": f"Tensor.scatter_reduce_(0, idx, masked, "
                            f"{reduce!r}, include_self=False)",
            "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes,
            "share": bound / ms, "device_share": bound / dev_ms,
            "shape": _k10_shape(n, values if reads_values else None, valid,
                                n_groups)}


def _k10_shape(n: int, values, valid, n_groups: int) -> str:
    """The inputs K10 reads and its output length, as `i32[n]+f64[n]+
    bool[n] -> [groups]`."""
    parts = [f"i32[{n}]"]
    if values is not None:
        parts.append({torch.float64: "f64", torch.int64: "i64"}.get(
            values.dtype, str(values.dtype).split(".")[-1]) + f"[{n}]")
    if valid is not None:
        parts.append(f"bool[{n}]")
    return "+".join(parts) + f" -> [{n_groups}]"


# the names of K11's launches in a torch.profiler trace of one launcher's
# calls: its one kernel and the memset of its tile flags
K11_KERNELS = ("window_scan_pass", "Memset")
K11_REPS = 50  # wrapper calls a K11 time is taken over


def _k11_times(call, plain, row_bytes: float, n: int,
               library=None) -> dict:
    """One K11 launcher at the main path's shape: `ms` (CUDA events over
    K11_REPS wrapper calls), `device_ms` (its launches in a torch.profiler
    trace, names holding one of K11_KERNELS: the kernel and the memset
    before it), the launches a call and each one's mean microseconds the
    trace saw, its plain version on the card and `library` where one
    PyTorch call computes a part of it; the bound is `row_bytes` a row
    over the card's memory rate."""
    nbytes = row_bytes * n
    bound, by = _bound_ms(nbytes, float(n))
    ms = _time_ms(call, K11_REPS)
    seen = []
    dev_ms = _device_ms(call, K11_REPS, K11_KERNELS, launches=seen)
    return {"ms": ms, "device_ms": dev_ms,
            "launches_per_call": seen[0] and seen[0]["per_call"],
            "device_kernels": seen[0] and seen[0]["kernels"],
            "plain_ms": _time_ms(plain, 10), "plain_device": "cuda",
            "library_ms": None if library is None
            else _time_ms(library, K11_REPS),
            "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes}


def _k11_inputs(ss, dev) -> dict:
    """store_sales' rows in (ss_item_sk, ss_sold_date_sk) order on the
    card: partition flags by item, peer-run flags by date, and
    `ss_ext_sales_price` with its validity."""
    item = ss.column("ss_item_sk").values
    date = ss.column("ss_sold_date_sk")
    dvals = np.where(date.valid if date.valid is not None else True,
                     date.values, -1)
    order = np.lexsort((dvals, item))
    it, dt = item[order], dvals[order]
    n = len(order)
    pb = np.ones(n, bool)
    pb[1:] = it[1:] != it[:-1]
    kb = pb.copy()
    kb[1:] |= dt[1:] != dt[:-1]
    price = ss.column("ss_ext_sales_price").values[order]
    valid = ~np.isnan(price)
    return {"n": n, "pb": torch.from_numpy(pb).to(dev),
            "kb": torch.from_numpy(kb).to(dev),
            "v": torch.from_numpy(np.where(valid, price, 0.0)).to(dev),
            "valid": torch.from_numpy(valid).to(dev),
            "shape": f"{n} rows, {int(pb.sum())} partitions (ss_item_sk), "
                     f"{int(kb.sum())} peer runs (ss_sold_date_sk)"}


def _same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int64) if x.is_floating_point()
                           else x, y.view(torch.int64)
                           if y.is_floating_point() else y)
               for x, y in zip(a, b))


def k11_phase(ss, dev, launches: dict, launches_small: dict) -> dict:
    """K11's three launchers against their plain versions at store_sales'
    size (2,880,404 rows in (ss_item_sk, ss_sold_date_sk) order:
    partitions by item, peer runs by date: ranks, counts and maxima exact,
    running sums within 1e-9 of the partition's absolute sum where a valid
    value came before), each twice with the same bits, and timed beside
    them (`_k11_times`), each a kernel and a memset a call in the trace.
    Returns the three rows of the kernels line."""
    from delta_tpu_torch.ops import window

    inp = _k11_inputs(ss, dev)
    n, tpb, tkb, tv, tvalid = (inp[k] for k in ("n", "pb", "kb", "v",
                                                "valid"))
    rows = {}
    got = window.window_ranks(tpb, tkb)
    torch.cuda.synchronize()
    want = window.window_ranks_plain(tpb, tkb)
    _check(all(torch.equal(g, w) for g, w in zip(got, want)),
           "window_ranks != plain")
    _check(_same_bits(got, window.window_ranks(tpb, tkb)),
           "window_ranks: two calls differ")
    rows["k11_ranks"] = dict(max_abs_err=0.0, **_k11_times(
        lambda: window.window_ranks(tpb, tkb),
        lambda: window.window_ranks_plain(tpb, tkb), 26.0, n),
        library_none="no single PyTorch call ranks rows within segments")

    part = torch.cumsum(tpb.to(torch.int64), 0) - 1
    scale = torch.zeros(int(part[-1]) + 1, dtype=torch.float64,
                        device=dev).scatter_add_(0, part, tv.abs())[part]
    err = 0.0
    for op in ("sum", "mean", "count", "min", "max"):
        out, cnt = window.window_running(tv, tvalid, tpb, op)
        torch.cuda.synchronize()
        w_out, w_cnt = window.window_running_plain(tv, tvalid, tpb, op)
        _check(torch.equal(cnt, w_cnt), f"window_running {op} counts")
        if op in ("sum", "mean"):
            some = cnt > 0
            diff = (out - w_out).abs()[some]
            _check(bool((diff <= 1e-9 * scale[some]).all()),
                   f"window_running {op} != plain within 1e-9 of the "
                   "partition's absolute sum")
            err = max(err, float(diff.max()))
        else:
            _check(torch.equal(out, w_out), f"window_running {op} != plain")
        _check(_same_bits((out, cnt),
                          window.window_running(tv, tvalid, tpb, op)),
               f"window_running {op}: two calls differ")
    vals, cnts = window.window_running(tv, tvalid, tpb, "sum")
    rows["k11_running"] = dict(max_abs_err=err, op="sum", **_k11_times(
        lambda: window.window_running(tv, tvalid, tpb, "sum"),
        lambda: window.window_running_plain(tv, tvalid, tpb, "sum"),
        26.0, n, library=lambda: torch.cumsum(tv, 0)),
        library_call="torch.cumsum(values, 0): the prefix sum, a part of "
                     "the running sum (no reset at partitions, no count)")

    got = window.window_peer_last(vals, cnts, tkb)
    torch.cuda.synchronize()
    want = window.window_peer_last_plain(vals, cnts, tkb)
    _check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
           "window_peer_last != plain")
    _check(_same_bits(got, window.window_peer_last(vals, cnts, tkb)),
           "window_peer_last: two calls differ")
    rows["k11_peers"] = dict(max_abs_err=0.0, **_k11_times(
        lambda: window.window_peer_last(vals, cnts, tkb),
        lambda: window.window_peer_last_plain(vals, cnts, tkb),
        33.0, n),
        library_none="no single PyTorch call gives each row its run's "
                     "last value")
    # one kernel and at most one memset a call: the trace may miss
    # launches (`_device_ms`), never add them, so each name's count over
    # K11_REPS calls is at most K11_REPS
    for key, row in rows.items():
        seen = row["device_kernels"]
        _check(seen is not None, f"{key}: the trace saw no launches")
        _check(sum("window_scan_pass" in k["name"] for k in seen) == 1
               and sum("Memset" in k["name"] for k in seen) <= 1
               and len(seen) <= 2
               and all(k["launches"] <= K11_REPS for k in seen),
               f"{key}: one kernel and at most one memset a call ({seen})")
    out = {}
    for key, (name, replaces) in K11_ROWS.items():
        out[name] = {"name": name, "route": "cuda",
                     "source": "delta_tpu_torch/csrc/window_scan.cu",
                     "replaces": replaces, "launches": launches[key],
                     "launches_sql": launches[key],
                     "launches_small": launches_small[key],
                     **rows[key], "shape": inp["shape"]}
    return out


# step 27: SQL's statements past the query (TPC-DS v3 §5's data
# maintenance through `sql()`) on step 26 (b)'s SF1 tables

STMT_DELETE_QUANTILES = (0.40, 0.50)  # DF_SS: the sold dates between the
                                      # 40th and 50th percentiles, ~10%
STMT_UPDATE_TICKETS = 2_000           # UPDATE: the first tickets' rows
STMT_UPDATE_QUANTITY = 77
STMT_LF_SS = 1_000                    # LF_SS: half updates, half inserts
STMT_LF_COLUMNS = ("ss_sold_date_sk", "ss_item_sk", "ss_ticket_number",
                   "ss_quantity", "ss_net_paid")
STMT_ZORDER = ("sr_item_sk", "sr_customer_sk")
STMT_CHECK = ("qty_nonneg", "ss_quantity IS NULL OR ss_quantity >= 0")
# the statements' launches, kernel row -> counter keys
STMT_ROWS = {"byte_class": ("k1",), "winner_pack": ("k2",),
             "hybrid_extract": ("k3",), "interleave_bits": ("k4",),
             "unpack_bitpacked": ("k5",), "segmented_minmax": ("k6",),
             "skip_mask": ("k7",), "dv_bits": ("k8_pack", "k8_decode"),
             "merge_join": ("k9",), "seg_agg": ("k10",),
             "window_ranks": ("k11_ranks",),
             "window_running": ("k11_running",),
             "window_peer_last": ("k11_peers",)}
_SQL_TYPE = {"long": "BIGINT", "integer": "INT", "double": "DOUBLE"}


def _row_digest(batch, names) -> np.ndarray:
    """One 64-bit hash a row over `names` (a null its own value, NaN one
    value), sorted: equal arrays are equal multisets of rows."""
    h = np.zeros(batch.num_rows, np.uint64)
    for name in names:
        c = batch.column(name)
        v = np.asarray(c.values)
        if v.dtype == object:
            bits = np.fromiter((hash(x) for x in v.tolist()), np.int64,
                               len(v)).view(np.uint64)
        elif v.dtype.kind == "f":
            f = v.astype(np.float64)
            bits = np.where(np.isnan(f), np.float64(np.nan), f).view(
                np.uint64)
        else:
            bits = v.astype(np.int64).view(np.uint64)
        if c.valid is not None:
            bits = np.where(c.valid, bits, np.uint64(0x9E3779B97F4A7C15))
        h = (h * np.uint64(1_000_003)) ^ bits
    return np.sort(h)


def _sums_of(batch) -> tuple:
    """(rows, the sum of ss_quantity's valid values, the sum of
    ss_net_paid's valid non-NaN values)."""
    q = batch.column("ss_quantity")
    p = batch.column("ss_net_paid")
    qv = q.values if q.valid is None else q.values[q.valid]
    pv = p.values if p.valid is None else p.values[p.valid]
    return batch.num_rows, int(qv.astype(np.int64).sum()), \
        float(np.nansum(pv))


def sql_statements_phase(root: str, ss, sr, device: str, card: str) -> dict:
    """Step 27 (module docstring): every statement through
    `delta_tpu_torch.sql.sql` on the catalog of the tables at `root`
    (step 26 (b)'s), on `device`; `ss` and `sr` are the generator's
    store_sales and store_returns, the numpy truth. Each statement's
    seconds and launches (`WIDE_WRITE_K`, K10 and K11) in
    `out["steps"]`."""
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.catalog import Catalog
    from delta_tpu_torch.sql import sql

    eng = TorchEngine(device)
    cat = Catalog(root, engine=eng)
    cpu_cat = Catalog(root, engine=TorchEngine("cpu"))
    out = {"steps": {}}
    step = _stepper(out, eng, "sql statements")
    launches = {}

    def run(name, text, rows, **expect):
        res = step(name, rows, lambda: sql(text, catalog=cat), **expect)
        counts = step.counts
        launches[name] = {k: counts.get(v, 0)
                          for k, v in {**WIDE_WRITE_K, **SQL_K}.items()}
        print(f"sql statements {name}: {out['steps'][name]['s']:.4f} s, "
              f"{rows} rows, launches {json.dumps(launches[name])}; {card}",
              flush=True)
        return res

    # the numpy truth of store_sales: who is alive, and the two columns
    date = ss.column("ss_sold_date_sk")
    d_ok = np.ones(ss.num_rows, bool) if date.valid is None else date.valid
    item = ss.column("ss_item_sk").values.astype(np.int64)
    ticket = ss.column("ss_ticket_number").values.astype(np.int64)
    qty = ss.column("ss_quantity").values.astype(np.int64).copy()
    paid = ss.column("ss_net_paid").values.astype(np.float64).copy()
    alive = np.ones(ss.num_rows, bool)
    extra_q, extra_p = np.zeros(0, np.int64), np.zeros(0, np.float64)
    original = (int(alive.sum()), int(qty.sum()), float(np.nansum(paid)))

    def truth():
        return (int(alive.sum()) + len(extra_q),
                int(qty[alive].sum() + extra_q.sum()),
                float(np.nansum(paid[alive]) + extra_p.sum()))

    def held(what, want=None):
        got = _sums_of(sql("SELECT ss_quantity, ss_net_paid FROM "
                           "store_sales", catalog=cat))
        want = truth() if want is None else want
        _check(got[:2] == want[:2]
               and abs(got[2] - want[2]) <= 1e-9 * abs(want[2]),
               f"sql statements {what}: (rows, quantity, net paid) {got}, "
               f"numpy {want}")

    n_ss, n_sr = ss.num_rows, sr.num_rows
    detail = run("describe_detail", "DESCRIBE DETAIL store_sales", 1)
    _check(detail["numFiles"] >= 1 and detail["partitionColumns"] == [],
           f"sql statements: DESCRIBE DETAIL {detail}")
    history = run("describe_history", "DESCRIBE HISTORY store_sales", 1)
    _check(history[0]["version"] == detail["version"],
           f"sql statements: DESCRIBE HISTORY's head {history[0]}")
    v_dv = run("set_deletion_vectors", "ALTER TABLE store_sales SET "
               "TBLPROPERTIES ('delta.enableDeletionVectors' = 'true')", 1)
    feats = sql("DESCRIBE DETAIL store_sales", catalog=cat)["tableFeatures"]
    _check("deletionVectors" in feats,
           f"sql statements: the DV upgrade, features {feats}")
    # DF_SS: a range of sold dates
    lo, hi = (int(np.quantile(date.values[d_ok], q))
              for q in STMT_DELETE_QUANTILES)
    gone = d_ok & (date.values >= lo) & (date.values <= hi)
    m = run("delete_df_ss", f"DELETE FROM store_sales WHERE ss_sold_date_sk "
            f">= {lo} AND ss_sold_date_sk <= {hi}", int(gone.sum()),
            k7=(1, None), k8_pack=(1, None))
    alive &= ~gone
    _check(m.num_rows_deleted == int(gone.sum()),
           f"sql statements DELETE: {m.num_rows_deleted} rows, numpy "
           f"{int(gone.sum())}")
    held("DELETE")
    t_hi = int(ticket.min()) + STMT_UPDATE_TICKETS
    hit = alive & (ticket <= t_hi)
    m = run("update", f"UPDATE store_sales SET ss_quantity = "
            f"{STMT_UPDATE_QUANTITY} WHERE ss_ticket_number <= {t_hi}",
            int(hit.sum()), k8_decode=(1, None))
    qty[hit] = STMT_UPDATE_QUANTITY
    _check(m.num_rows_updated == int(hit.sum()),
           f"sql statements UPDATE: {m.num_rows_updated} rows, numpy "
           f"{int(hit.sum())}")
    held("UPDATE")

    # LF_SS: a 1,000-row source in the catalog, half of it live keys
    types = {f.name: f.data_type for f in
             Table.for_path(f"{root}/store_sales", engine=eng)
             .latest_snapshot().schema.fields}
    cols = ", ".join(f"{c} {_SQL_TYPE[types[c]]}" for c in STMT_LF_COLUMNS)
    run("create_table", f"CREATE TABLE lf_ss ({cols}) USING DELTA "
        "TBLPROPERTIES ('delta.enableDeletionVectors' = 'true')", 0)
    rng = np.random.default_rng(27)
    half = STMT_LF_SS // 2
    key = item * (1 << 32) + ticket
    # matched rows: live keys from the last tickets (few candidate rows
    # past the source's bounds), each key once
    cand = np.flatnonzero(alive & (ticket > ticket.max() - 20 * half))
    _, first = np.unique(key[cand], return_index=True)
    pick = rng.choice(cand[first], half, replace=False)
    s_item = np.concatenate([item[pick], rng.integers(1, item.max() + 1,
                                                      half)])
    s_ticket = np.concatenate([ticket[pick], ticket.max() + 1
                               + np.arange(half)])
    s_date = np.concatenate([date.values[pick], np.full(half, hi + 1)])
    s_qty = rng.integers(1, 101, STMT_LF_SS)
    s_paid = np.round(rng.uniform(1.0, 2000.0, STMT_LF_SS), 2)
    values = ", ".join(f"({d}, {i}, {t}, {q}, {p!r})" for d, i, t, q, p in zip(
        s_date.tolist(), s_item.tolist(), s_ticket.tolist(), s_qty.tolist(),
        s_paid.tolist()))
    run("insert_values", f"INSERT INTO lf_ss VALUES {values}", STMT_LF_SS)
    got = sql("SELECT * FROM lf_ss", catalog=cat)
    _check(got.num_rows == STMT_LF_SS and int(got.column("ss_quantity")
           .values.sum()) == int(s_qty.sum()),
           "sql statements INSERT: lf_ss's rows")
    m = run("merge", "MERGE INTO store_sales t USING lf_ss s ON "
            "t.ss_ticket_number = s.ss_ticket_number AND t.ss_item_sk = "
            "s.ss_item_sk WHEN MATCHED THEN UPDATE SET * WHEN NOT MATCHED "
            "THEN INSERT *", STMT_LF_SS, k9=(1, None))
    s_key = s_item * (1 << 32) + s_ticket
    order = np.argsort(s_key[:half])
    matched = alive & np.isin(key, s_key[:half])
    at = order[np.searchsorted(s_key[:half], key[matched],
                               sorter=order)]
    qty[matched] = s_qty[at]
    paid[matched] = s_paid[at]
    extra_q, extra_p = s_qty[half:], s_paid[half:]
    _check(m.num_target_rows_updated == int(matched.sum())
           and m.num_target_rows_inserted == half,
           f"sql statements MERGE: {m}, numpy {int(matched.sum())} updated, "
           f"{half} inserted")
    held("MERGE")

    # OPTIMIZE ... ZORDER BY on store_returns
    m = run("optimize_zorder", "OPTIMIZE store_returns ZORDER BY ("
            + ", ".join(STMT_ZORDER) + ")", n_sr, k4=(1, None))
    _check(m.num_files_added >= 1, f"sql statements OPTIMIZE: {m}")
    got = sql("SELECT sr_return_quantity FROM store_returns", catalog=cat)
    _check(got.num_rows == n_sr and int(got.column("sr_return_quantity")
           .values.sum()) == int(sr.column("sr_return_quantity").values
                                 .sum()), "sql statements OPTIMIZE: rows")
    # RESTORE to the version before the DELETE
    m = run("restore", f"RESTORE TABLE store_sales TO VERSION AS OF {v_dv}",
            n_ss)
    held("RESTORE", original)
    version = m.version
    res = run("vacuum_dry_run", "VACUUM store_sales RETAIN 0 HOURS DRY RUN",
              0)
    live = {a.path for a in Table.for_path(f"{root}/store_sales", engine=eng)
            .latest_snapshot().state.add_files}
    _check(res.dry_run and len(res.files_deleted) >= 1
           and not live & set(res.files_deleted),
           f"sql statements VACUUM: {res.files_deleted} beside {live}")
    manifests = run("generate", "GENERATE symlink_format_manifest FOR TABLE "
                    "store_returns", n_sr)
    sr_table = Table.for_path(f"{root}/store_returns", engine=eng)
    sr_live = sorted(f"{sr_table.path}/{a.path}" for a in
                     sr_table.latest_snapshot().state.add_files)
    for path in manifests:
        with open(path) as f:
            _check(f.read().split() == sr_live,
                   f"sql statements GENERATE: {path} names the live files")
    _check(len(manifests) == 1, f"sql statements GENERATE: {manifests}")
    # CHECK constraints and DROP FEATURE on lf_ss
    run("add_constraint", f"ALTER TABLE lf_ss ADD CONSTRAINT {STMT_CHECK[0]} "
        f"CHECK ({STMT_CHECK[1]})", STMT_LF_SS)
    run("drop_constraint", f"ALTER TABLE lf_ss DROP CONSTRAINT {STMT_CHECK[0]}",
        0)
    run("drop_feature", "ALTER TABLE lf_ss DROP FEATURE checkConstraints", 0)
    feats = sql("DESCRIBE DETAIL lf_ss", catalog=cat)["tableFeatures"]
    _check("checkConstraints" not in feats and "deletionVectors" in feats,
           f"sql statements DROP FEATURE: features {feats}")
    # CONVERT TO DELTA: hard links to store_returns' data files
    conv = os.path.join(root, "converted_returns")
    os.makedirs(conv)
    for p in sr_live:
        _link_or_copy(p, os.path.join(conv, os.path.basename(p)))
    run("convert", f"CONVERT TO DELTA parquet.`{conv}`", n_sr)
    names = sorted(sr.column_names)
    a = _row_digest(sql(f"SELECT * FROM '{conv}'", engine=TorchEngine(
        device)), names)
    b = _row_digest(sql("SELECT * FROM store_returns", catalog=cat), names)
    _check(np.array_equal(a, b), "sql statements CONVERT: the converted "
           "table's rows are its source's")
    dropped = run("drop_table", "DROP TABLE lf_ss", 0)
    tables = run("show_tables", "SHOW TABLES", 0)
    _check(dropped is True and "lf_ss" not in tables
           and "store_sales" in tables,
           f"sql statements DROP TABLE, SHOW TABLES: {tables}")
    # the card's read of store_sales is the CPU's, row for row
    names = sorted(ss.column_names)
    q = f"SELECT * FROM store_sales VERSION AS OF {version}"
    _check(np.array_equal(_row_digest(sql(q, catalog=cat), names),
                          _row_digest(sql(q, catalog=cpu_cat), names)),
           "sql statements: the card's store_sales is the CPU's")
    for name, r in out["steps"].items():
        r["launches_sql"] = {k: launches[name][k] for k in SQL_K}
    out["launches"] = {k: sum(launches[s][k] for s in launches)
                       for k in {**WIDE_WRITE_K, **SQL_K}}
    out["s"] = sum(r["s"] for r in out["steps"].values())
    return out


def sql_phase(work: str, card: str, dev) -> tuple:
    """Step 26 (module docstring): (a) the 102 texts and q51 in the RANGE
    frame at scale 12,000 against sqlite (q67 against the CPU engine),
    (b) nineteen at SF1 on the card against the CPU engine, (c) K10
    beside its plain version and `scatter_reduce_`, and K11 beside its
    plain versions. Returns (the phase's metrics, the kernels line's rows
    of K10 and K11's three launchers)."""
    import sqlite3
    import threading

    from delta_tpu_torch import TorchEngine, obs
    from delta_tpu_torch.catalog import Catalog
    from delta_tpu_torch.ops import sqlops, window
    from delta_tpu_torch.sqlengine import execute_select
    from delta_tpu_torch.utils.tpcds import QUERIES, generate, load_delta

    out = {"small": {}, "full": {}}
    corpus = _sql_texts(QUERIES)
    # q67: sqlite's parser overflows on its nine-level ROLLUP expansion;
    # FULL OUTER JOIN came in sqlite 3.39
    exempt = {"q67"}
    if tuple(int(x) for x in sqlite3.sqlite_version.split(".")[:2]) \
            < (3, 39):
        exempt |= {"q51", "q97", "q51_range"}
    print(f"sql (a): sqlite {sqlite3.sqlite_version}; held to the CPU "
          f"engine instead: {sorted(exempt)}", flush=True)
    # (a) every query at scale 12,000, LIMIT stripped, against sqlite (in
    # a thread: sqlite leaves the GIL while it runs a statement); each
    # verbatim text within its LIMIT
    tabs = generate(SQL_SMALL_SCALE)
    texts = {name: _strip_limit(text) for name, text in corpus.items()}
    oracle = {}

    def run_sqlite():
        t0 = time.perf_counter()
        try:
            db = os.path.join(work, "sql_small.sqlite")
            _sqlite_of(tabs, db)
            oracle.update(_sqlite_answers(
                db, {k: v for k, v in texts.items() if k not in exempt},
                SQL_SQLITE_WORKERS))
        except BaseException as e:  # reported after the join
            oracle["__error__"] = repr(e)
        oracle["__s__"] = time.perf_counter() - t0

    sqlite = threading.Thread(target=run_sqlite, daemon=True)
    sqlite.start()
    t0 = time.perf_counter()
    small_root = os.path.join(work, "sql_small")
    cat = load_delta(small_root, tables=tabs, engine=TorchEngine())
    out["small_write_s"] = time.perf_counter() - t0
    # each wrapper's calls that have rows to launch for: every one must
    # have launched its kernel
    real = {"k10": sqlops.seg_agg, "k11_ranks": window.window_ranks,
            "k11_running": window.window_running,
            "k11_peers": window.window_peer_last}
    calls = dict.fromkeys(real, 0)

    def counting_k10(codes, values, valid, op, n_groups, means=None):
        calls["k10"] += int(n_groups > 0)
        return real["k10"](codes, values, valid, op, n_groups, means)

    def counting(key):
        def call(first, *rest):
            calls[key] += int(first.numel() > 0)
            return real[key](first, *rest)
        return call

    small = dict.fromkeys(real, 0)
    got_rows = {}
    t_all = time.perf_counter()
    sqlops.seg_agg = counting_k10
    window.window_ranks = counting("k11_ranks")
    window.window_running = counting("k11_running")
    window.window_peer_last = counting("k11_peers")
    try:
        for name, q in texts.items():
            for key in calls:
                calls[key] = 0
            obs.reset()
            t0 = time.perf_counter()
            res = execute_select(q, catalog=cat)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            counts = obs.counters()
            launched = {k: counts.get(SQL_K[k], 0) for k in real}
            # every aggregate and window the executor ran (one call each,
            # with a group or a row or more) launched its kernel
            for key in real:
                _check(launched[key] == calls[key],
                       f"sql (a) {name}: {key} launched {launched[key]} of "
                       f"{calls[key]}")
            if _SQL_AGG.search(q) and res.num_rows:
                _check(launched["k10"] >= 1,
                       f"sql (a) {name}: K10 launched ({launched['k10']})")
            _check(counts.get("sql.host_string_aggs", 0) == 0,
                   f"sql (a) {name}: a string aggregate on the host")
            for key in real:
                small[key] += launched[key]
            got_rows[name] = res.rows()
            m = re.search(r"\blimit\s+(\d+)\s*$", corpus[name].strip(),
                          re.IGNORECASE)
            verbatim = execute_select(corpus[name], catalog=cat)
            _check(m is None or verbatim.num_rows <= int(m.group(1)),
                   f"sql (a) {name} past its LIMIT")
            out["small"][name] = {"rows": res.num_rows, "s": s,
                                  "launches": launched}
    finally:
        sqlops.seg_agg = real["k10"]
        window.window_ranks = real["k11_ranks"]
        window.window_running = real["k11_running"]
        window.window_peer_last = real["k11_peers"]
    out["small_card_s"] = time.perf_counter() - t_all
    sqlite.join()
    out["small_sqlite_s"] = oracle.get("__s__")
    _check("__error__" not in oracle, f"sql (a) sqlite: "
           f"{oracle.get('__error__')}")
    cpu_small = Catalog(small_root, engine=TorchEngine("cpu"))
    for name, rows in got_rows.items():
        if name in exempt:
            want = execute_select(texts[name], catalog=cpu_small).rows()
            ok, msg = _rows_equal(rows, want, tol=1e-9)
            _check(ok, f"sql (a) {name} != the CPU engine: {msg}")
        else:
            ok, msg = _rows_equal(rows, oracle[name])
            _check(ok, f"sql (a) {name} != sqlite: {msg}")
    for key in K11_ROWS:
        _check(small[key] >= 1, f"sql (a): {key} launched ({small[key]})")
    out["small_launches"] = small
    print(f"sql (a): {len(texts)} queries at scale {SQL_SMALL_SCALE} equal "
          f"sqlite ({sorted(exempt)} the CPU engine), launches "
          f"{json.dumps(small)}; the card's {out['small_card_s']:.2f} s, "
          f"sqlite's {out['small_sqlite_s']:.2f} s beside them; {card}",
          flush=True)

    # (b) SF1's store_sales, the tables these queries read
    t0 = time.perf_counter()
    tabs = generate(SQL_FULL_SCALE)
    out["generate_s"] = time.perf_counter() - t0
    ss, sr = tabs["store_sales"], tabs["store_returns"]
    root = os.path.join(work, "sql_sf1")
    obs.reset()
    t0 = time.perf_counter()
    load_delta(root, tables={k: tabs[k] for k in SQL_FULL_TABLES},
               engine=TorchEngine())
    out["write_s"] = time.perf_counter() - t0
    out["rows"] = {k: tabs[k].num_rows for k in SQL_FULL_TABLES}
    del tabs
    card_cat = Catalog(root, engine=TorchEngine())
    cpu_cat = Catalog(root, engine=TorchEngine("cpu"))
    largest = {}

    def watching(codes, values, valid, op, n_groups, means=None):
        if codes.is_cuda and codes.numel() > largest.get("n", -1):
            largest.update(n=codes.numel(), args=(codes, values, valid, op,
                                                  n_groups, means))
        return real["k10"](codes, values, valid, op, n_groups, means)

    sqlops.seg_agg = watching
    try:
        for name in SQL_FULL_QUERIES:
            q = _strip_limit(corpus[name])
            torch.cuda.synchronize()
            obs.reset()
            t0 = time.perf_counter()
            res = execute_select(q, catalog=card_cat)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            counts = obs.counters()
            t0 = time.perf_counter()
            cpu = execute_select(q, catalog=cpu_cat)
            cpu_s = time.perf_counter() - t0
            ok, msg = _rows_equal(res.rows(), cpu.rows(), tol=1e-9)
            _check(ok, f"sql (b) {name}: card != CPU: {msg}")
            launches = _sql_launches(counts)
            _check(launches["k10"] >= 1, f"sql (b) {name}: K10 launched")
            out["full"][name] = {
                "rows": res.num_rows, "s": s, "cpu_s": cpu_s,
                "phase_s": {p: counts.get(f"sql.{p}_ns", 0) / 1e9
                            for p in ("scan", "join", "group", "sort")},
                "launches": launches}
            print(f"sql (b) {name}: {res.num_rows} rows, {s:.4f} s on the "
                  f"card ({json.dumps(out['full'][name]['phase_s'])}), "
                  f"{cpu_s:.4f} s on the CPU, launches "
                  f"{json.dumps(launches)}; {card}", flush=True)
    finally:
        sqlops.seg_agg = real["k10"]
    _check("args" in largest, "sql (b): a group-by on the card")
    full = {k: sum(r["launches"][k] for r in out["full"].values())
            for k in SQL_K}
    for key in K11_ROWS:
        _check(full[key] >= 1, f"sql (b): {key} launched ({full[key]})")

    # step 27: the statements past the query, on (b)'s tables
    t0 = time.perf_counter()
    st = out["statements"] = sql_statements_phase(root, ss, sr, dev.type,
                                                  card)
    st["wall_s"] = time.perf_counter() - t0
    del sr
    for key in ("k1", "k2", "k4", "k7", "k8_pack", "k8_decode", "k9"):
        _check(st["launches"][key] >= 1, f"sql statements: {key} launched "
               f"({st['launches'][key]})")
    print(f"sql statements: {len(st['steps'])} statements {st['s']:.4f} s "
          f"(step 27's wall {st['wall_s']:.4f} s), launches "
          + json.dumps(st["launches"]) + f"; {card}", flush=True)

    # (c) K10 at six shapes
    item = ss.column("ss_item_sk").values
    price = ss.column("ss_ext_sales_price").values
    n_items = int(item.max())
    codes = torch.from_numpy((item - 1).astype(np.int32)).to(dev)
    p_valid = torch.from_numpy(~np.isnan(price)).to(dev)
    p_vals = torch.from_numpy(np.nan_to_num(price, nan=0.0)).to(dev)
    store = ss.column("ss_store_sk").values
    s_codes = torch.from_numpy((store - 1).astype(np.int32)).to(dev)
    qty = torch.from_numpy(ss.column("ss_quantity").values).to(dev)
    q_valid = None if ss.column("ss_quantity").valid is None else \
        torch.from_numpy(ss.column("ss_quantity").valid).to(dev)
    by_item = _k10_times(codes, p_vals, p_valid, "sum", n_items)
    means = torch.zeros(n_items, dtype=torch.float64, device=dev)
    by_item_sumsq = _k10_times(codes, p_vals, p_valid, "sumsq", n_items,
                               means + 1.5)
    by_store = _k10_times(s_codes, qty, q_valid, "sum", 12)
    biggest = _k10_times(*largest["args"])
    biggest["query_shape"] = True
    runs = {}
    for col in ("ss_customer_sk", "ss_ticket_number"):
        keys = ss.column(col).values - 1
        runs[col] = _k10_times(torch.from_numpy(keys.astype(np.int32)).to(dev),
                               p_vals, p_valid, "sum", int(keys.max()) + 1)
    rows = {"seg_agg": {
        "name": "seg_agg", "route": "cuda",
        "source": "delta_tpu_torch/csrc/seg_agg.cu",
        "replaces": "delta_tpu/ops/sqlops.py:123",
        "launches": full["k10"], "launches_small": small["k10"],
        **by_item, "sumsq": by_item_sumsq, "by_store": by_store,
        "largest_query_groupby": biggest,
        "by_customer": runs["ss_customer_sk"],
        "by_ticket": runs["ss_ticket_number"]}}
    # (c) K11 at store_sales' size
    rows.update(k11_phase(ss, dev, full, small))
    return out, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--commits", type=int, default=10_000,
                    help="log depth (the headline benchmark has 100000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also time a warm load and trace one, and trace "
                    "a second checkpoint write and a second OPTIMIZE, with "
                    "torch.profiler (device time by kernel, busy share)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.log.segment import build_log_segment
    from delta_tpu_torch.ops import cuda_build
    from delta_tpu_torch.replay.columnar import _read_commits_buffer
    from delta_tpu_torch.utils import filenames
    from delta_tpu_torch.utils.synth import synth_delta_log

    t_start = time.perf_counter()
    phase_wall = {}  # each phase's wall seconds, the printing after it
    last = [t_start]  # included

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_wall[name] = round(now - last[0], 3)
        last[0] = now

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = _card_line()
    print(f"device: {kind} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = cuda_build.build()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.2f}s\n{info['log'].strip()}")
    print(f"build wall: {build_s:.2f}s", flush=True)
    lap("build")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(work, "headline")
        log = os.path.join(path, "_delta_log")
        cp_version = max(0, args.commits - 10)
        t0 = time.perf_counter()
        truth = synth_delta_log(path, args.commits, 100, seed=args.seed,
                                checkpoint_version=cp_version,
                                now_ms=WEEK_MS)
        print(f"generated {args.commits} commits, {truth.num_actions} "
              f"actions and a {truth.checkpoint.get('parts', 1)}-part "
              f"checkpoint at {cp_version} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        side = os.path.join(work, "checkpoint_aside")
        aside = _set_aside(log, side)
        lap("generate")

        # one real parse window of the log: its first <= 64 MiB of commits
        eng = TorchEngine()
        seg = build_log_segment(eng.fs, log)
        buf, starts, _ = _read_commits_buffer(
            [(filenames.delta_version(f.path), f.path) for f in seg.deltas])
        cut = int(starts[starts <= eng.parse_window_bytes][-1])
        window = torch.frombuffer(buf, dtype=torch.uint8)[:cut].to(dev)
        del buf
        kernels = kernel_phase(window, truth.num_actions, dev)
        del window
        print("kernel phase ok: " + json.dumps(
            {k: {"ms": v["ms"], "plain_ms": v["plain_ms"]}
             for k, v in kernels.items()}) + "; winner_pack equal on "
            "long runs", flush=True)
        lap("kernel_phase")

        # commit-only path, counters from 0
        state, counts, list_s, load_s, peak = _timed_load(
            path, Table, TorchEngine, obs)
        n_actions = state.file_actions.num_rows
        _truth_checks(state, truth, "commit-only load")
        _ladder_idle(counts, "commit-only load")
        _check(n_actions == truth.num_actions, "action count")
        windows = counts.get("parse.device_windows", 0)
        _check(windows >= 1, "parse.device_windows >= 1")
        _check(counts.get("parse.device_fallbacks", 0) == 0,
               "parse.device_fallbacks == 0")
        k1 = counts.get("kernel.byte_class.launches", 0)
        k2 = counts.get("kernel.winner_pack.launches", 0)
        _check(k1 >= windows, "byte_class launched once per window")
        _check(k2 >= 1, "winner_pack launched")
        kernels["byte_class"]["launches"] = k1
        kernels["winner_pack"] = winner_pack_phase(state, args.seed + 3)
        kernels["winner_pack"]["launches"] = k2
        print("winner_pack on the main path's keys: " + json.dumps(
            kernels["winner_pack"]), flush=True)
        print("load: " + json.dumps({
            "commits": args.commits, "actions": n_actions,
            "live_files": state.num_files,
            "tombstones": int(state.tombstone_mask.sum()),
            "bytes": int(starts[-1]),
            "windows": windows, "list_s": list_s, "load_s": load_s,
            "phase_s": state.phase_seconds,
            "actions_per_s": n_actions / load_s,
            "peak_device_bytes": peak, "card": card}), flush=True)
        del state
        _put_back(log, side, aside)
        lap("commit_only_load")

        # K3 on every part of the headline checkpoint, then edge plans
        parts = sorted(os.path.join(log, n) for n in aside
                       if n.endswith(".parquet"))
        kernels["hybrid_extract"] = hybrid_extract_phase(parts, dev)
        print("hybrid_extract phase: " + json.dumps(
            kernels["hybrid_extract"]), flush=True)
        lap("hybrid_extract")

        # checkpoint path (the slice's main path), counters from 0
        state, counts, list_s, load_s, peak = _timed_load(
            path, Table, TorchEngine, obs)
        _truth_checks(state, truth, "checkpoint load")
        _ladder_idle(counts, "checkpoint load")
        n_parts = len(parts)
        _check(counts.get("decode.device_parts", 0) == n_parts,
               "decode.device_parts == the part count")
        _check(counts.get("decode.device_fallbacks", 0) == 0,
               "decode.device_fallbacks == 0")
        k3 = counts.get("kernel.hybrid_extract.launches", 0)
        _check(k3 == n_parts, "hybrid_extract launched once per part")
        ck1 = counts.get("kernel.byte_class.launches", 0)
        ck2 = counts.get("kernel.winner_pack.launches", 0)
        _check(ck1 >= 1, "byte_class launched on the tail commits")
        _check(ck2 >= 1, "winner_pack launched on the checkpoint path")
        kernels["hybrid_extract"]["launches"] = k3
        kernels["byte_class"]["launches_checkpoint_path"] = ck1
        kernels["winner_pack"]["launches_checkpoint_path"] = ck2
        n_rows = state.file_actions.num_rows
        print("checkpoint load: " + json.dumps({
            "commits": args.commits, "checkpoint_version": cp_version,
            "parts": n_parts, "tail_commits": args.commits - 1 - cp_version,
            "checkpoint_bytes": sum(os.path.getsize(p) for p in parts),
            "rows": n_rows, "live_files": state.num_files,
            "tombstones": int(state.tombstone_mask.sum()),
            "counters": counts, "list_s": list_s, "load_s": load_s,
            "phase_s": state.phase_seconds,
            "actions_per_s": n_rows / load_s,
            "peak_device_bytes": peak, "card": card}), flush=True)
        del state

        # scan planning on the checkpoint-plus-tail snapshot: the stats
        # index, K7 on every filtered scan; counters from 0
        scan, kernels["skip_mask"] = scan_phase(path, truth, card, dev)
        print("scan: " + json.dumps(scan), flush=True)
        print("skip_mask phase: " + json.dumps(kernels["skip_mask"]),
              flush=True)
        lap("checkpoint_load_and_scan")

        # the snapshot's life after the load: update(), a poll, P&M, an
        # append whose hooks take the advanced state, a scan of the
        # advanced snapshot; counters from 0
        upd = update_phase(path, truth, card, args.seed + 5)
        kernels["skip_mask"]["launches_update"] = \
            upd["scan_after_update_counters"].get(
                "kernel.skip_mask.launches", 0)
        for name, key in (("byte_class", "kernel.byte_class.launches"),
                          ("winner_pack", "kernel.winner_pack.launches")):
            kernels[name]["launches_update"] = \
                upd["update_counters"].get(key, 0)
        kernels["hybrid_extract"]["launches_update"] = \
            upd["update_counters"].get("kernel.hybrid_extract.launches", 0)
        print("update: " + json.dumps(upd), flush=True)
        lap("update")

        # the load's degradation ladder and .crc quarantine on the card
        print("ladder: " + json.dumps(ladder_phase(
            path, truth, parts, Table, TorchEngine, obs, card)), flush=True)
        lap("ladder")

        # the checkpoint write (the slice's main path), counters from 0
        cw = checkpoint_write_phase(path, truth, card)
        kernels["hybrid_extract"]["launches_checkpoint_write_reload"] = \
            cw["reload_counters"].get("kernel.hybrid_extract.launches", 0)
        print("checkpoint write: " + json.dumps(cw), flush=True)
        lap("checkpoint_write")

        # the log forms: compacted deltas, V2 with sidecars and reuse,
        # stats_parsed, cleanup, C6; each load's counters from 0
        forms, form_launches = log_forms_phase(path, truth, card)
        for name, extra in form_launches.items():
            kernels[name].update(extra)
        print("log forms: " + json.dumps(forms), flush=True)
        for key in ("v2_write", "v2_rewrite", "struct_write"):
            print(f"log forms {key}: {forms[key + '_s']:.4f} s, "
                  f"{forms[key]['bytes']} B; {card}", flush=True)
        for key in ("compacted_checkpoint_load", "compacted_commit_only_load",
                    "v2_reload", "v2_fallback_load", "struct_reload",
                    "after_cleanup_load"):
            print(f"log forms {key}: {forms[key + '_s']:.4f} s "
                  f"{json.dumps(forms.get(key + '_phase_s', {}))}; {card}",
                  flush=True)
        for key in ("compact_tail_write", "compact_1000_write",
                    "struct_stats", "struct_index_build", "cleanup"):
            print(f"log forms {key}: {forms[key + '_s']:.4f} s; {card}",
                  flush=True)
        lap("log_forms")

        # other writers' Parquet forms: the committed fixtures' digests,
        # their logs' live files and routes; counters from 0 per log
        pforms = parquet_forms_phase(FORMS_DIR, "cuda", card)
        kernels["hybrid_extract"]["launches_parquet_forms"] = \
            pforms["k3_launches"]
        print("parquet_forms: " + json.dumps(pforms), flush=True)
        print(f"parquet_forms host decode: zstd {pforms['zstd_mb_s']:.1f} "
              f"MB/s, snappy {pforms['snappy_mb_s']:.1f} MB/s on "
              f"{pforms['timed_bytes']} B; {card}", flush=True)
        lap("parquet_forms")

        # the wider schema types: TPC-DS store_sales at SF1's row count
        # and the nested fixture; counters from 0 per load and read
        wide_in = {}
        wide = wide_types_phase(WIDE_DIR, "cuda", card, keep=wide_in)
        wide_reads = wide["reads"].values()
        kernels["skip_mask"]["launches_wide_types"] = sum(
            r.get("k7", 0) for r in wide_reads)
        kernels["byte_class"]["launches_wide_types"] = wide["load_k1"]
        kernels["winner_pack"]["launches_wide_types"] = wide["load_k2"]
        wide_k8 = sum(r.get("k8", 0) for r in wide_reads)
        print("wide_types: " + json.dumps(wide), flush=True)
        for name, r in wide["reads"].items():
            print(f"wide_types {name}: {r['rows']} rows, {r['columns']} "
                  f"columns, {r['files']} files, {r['s']:.4f} s, "
                  f"{r['rows_per_s']:.1f} rows/s; {card}", flush=True)
        lap("wide_types")

        # step 20: the wider types through every write path, on step
        # 19's rows (TPC-DS data maintenance); counters from 0 per step
        ww_keep = {}
        ww = wide_write_phase(wide_in.pop("all"), wide_in.pop("nested"),
                              WIDE_DIR, "cuda", card, keep=ww_keep)
        ww_steps = ww["steps"].values()
        for name, key in (("byte_class", "k1"), ("winner_pack", "k2"),
                          ("hybrid_extract", "k3"),
                          ("skip_mask", "k7")):
            kernels[name]["launches_wide_write"] = sum(
                s[key] for s in ww_steps)
        wide_write_k4 = sum(s["k4"] for s in ww_steps)
        wide_write_k8 = sum(s["k8_pack"] + s["k8_decode"] for s in ww_steps)
        wide_write_k9 = sum(s["k9"] for s in ww_steps)
        print("wide_write: " + json.dumps(ww), flush=True)
        lap("wide_write")
        for name, r in ww["steps"].items():
            print(f"wide_write {name}: {r['rows']} rows, {r['s']:.4f} s, "
                  f"{r['rows_per_s']:.1f} rows/s, launches "
                  + json.dumps({k: r[k] for k in WIDE_WRITE_K})
                  + f"; {card}", flush=True)

        # step 21: column mapping and ALTER TABLE on step 20's table, then
        # a fresh name-mode table; step 22: the write modes on both
        # tables; counters from 0 per step
        cm_keep = {}
        try:
            cm = column_mapping_phase(ww_keep, "cuda", card, keep=cm_keep)
            lap("column_mapping")
            print("column_mapping: " + json.dumps(cm), flush=True)
            for name, r in cm["steps"].items():
                print(f"column_mapping {name}: {r['rows']} rows, "
                      f"{r['s']:.4f} s, {r['rows_per_s']:.1f} rows/s, "
                      "launches " + json.dumps(
                          {k: r[k] for k in WIDE_WRITE_K})
                      + f"; {card}", flush=True)
            wm = write_modes_phase(cm_keep, "cuda", card)
            lap("write_modes")
            # step 23: VACUUM (the headline log, then step 22's tables),
            # REORG PURGE, RESTORE and CLONE; counters from 0 per step
            mt = maintenance_phase(path, truth, cm_keep, work, "cuda", card)
            lap("maintenance")
            # step 24: type widening, MERGE's schema evolution, CHECK
            # constraints, generated, identity and default columns on step
            # 23's table (a) and step 19's first quarter
            tf = table_features_phase(cm_keep, ww_keep["step19"], work,
                                      "cuda", card)
            lap("table_features")
            # step 25: the change data feed on step 24's table (a) and
            # step 23's partitioned table (b)
            cdf = change_data_feed_phase(cm_keep, "cuda", card)
            lap("change_data_feed")
        finally:
            if "work" in ww_keep:
                shutil.rmtree(ww_keep["work"], ignore_errors=True)
            ww_keep.clear()
            cm_keep.clear()
        cm_steps = cm["steps"].values()
        for name, key in (("byte_class", "k1"), ("winner_pack", "k2"),
                          ("hybrid_extract", "k3"),
                          ("skip_mask", "k7")):
            kernels[name]["launches_column_mapping"] = sum(
                s[key] for s in cm_steps)
        cm_k4 = sum(s["k4"] for s in cm_steps)
        cm_k8 = sum(s["k8_pack"] + s["k8_decode"] for s in cm_steps)
        cm_k9 = sum(s["k9"] for s in cm_steps)
        wm_steps = wm["steps"].values()
        for name, key in (("byte_class", "k1"), ("winner_pack", "k2"),
                          ("hybrid_extract", "k3"),
                          ("skip_mask", "k7")):
            kernels[name]["launches_write_modes"] = sum(
                s[key] for s in wm_steps)
        wm_k8 = sum(s["k8_pack"] + s["k8_decode"] for s in wm_steps)
        print("write_modes: " + json.dumps(wm), flush=True)
        for name, r in wm["steps"].items():
            print(f"write_modes {name}: {r['rows']} rows, {r['s']:.4f} s, "
                  f"{r['rows_per_s']:.1f} rows/s, launches "
                  + json.dumps({k: r[k] for k in WIDE_WRITE_K})
                  + f"; {card}", flush=True)
        print(f"write_modes steps: {sum(r['s'] for r in wm_steps):.4f} s; "
              f"{card}", flush=True)
        print("maintenance: " + json.dumps(mt), flush=True)
        for name, r in mt["steps"].items():
            print(f"maintenance {name}: {r['rows']} rows, {r['s']:.4f} s, "
                  f"{r['rows_per_s']:.1f} rows/s, launches "
                  + json.dumps({k: r[k] for k in WIDE_WRITE_K})
                  + (f", phases {json.dumps(mt['vacuum_phase_s'][name])}"
                     if name in mt["vacuum_phase_s"] else "")
                  + (f", files {r['files_removed']} rewritten into "
                     f"{r['files_added']}" if "files_removed" in r else "")
                  + f"; {card}", flush=True)
        print(f"maintenance steps: "
              f"{sum(r['s'] for r in mt['steps'].values()):.4f} s, planting "
              f"{mt['plant_s']:.4f} s; {card}", flush=True)
        mt_launches = {k: sum(r[k] for r in mt["steps"].values())
                       for k in WIDE_WRITE_K}
        print("table_features: " + json.dumps(tf), flush=True)
        for name, r in tf["steps"].items():
            print(f"table_features {name}: {r['rows']} rows, {r['s']:.4f} s, "
                  f"{r['rows_per_s']:.1f} rows/s, launches "
                  + json.dumps({k: r[k] for k in WIDE_WRITE_K})
                  + f"; {card}", flush=True)
        tf_launches = {k: sum(r[k] for r in tf["steps"].values())
                       for k in WIDE_WRITE_K}
        print(f"table_features steps: "
              f"{sum(r['s'] for r in tf['steps'].values()):.4f} s, launches "
              + json.dumps(tf_launches) + f"; {card}", flush=True)
        print("change_data_feed: " + json.dumps(cdf), flush=True)
        for name, r in cdf["steps"].items():
            print(f"change_data_feed {name}: {r['rows']} rows, "
                  f"{r['s']:.4f} s, {r['rows_per_s']:.1f} rows/s, launches "
                  + json.dumps({k: r[k] for k in WIDE_WRITE_K})
                  + f"; {card}", flush=True)
        cdf_launches = {k: sum(r[k] for r in cdf["steps"].values())
                        for k in WIDE_WRITE_K}
        print(f"change_data_feed steps: "
              f"{sum(r['s'] for r in cdf['steps'].values()):.4f} s, launches "
              + json.dumps(cdf_launches) + f"; {card}", flush=True)

        # step 26: device SQL, TPC-DS's 102 texts at scale 12,000 against
        # sqlite and nineteen at SF1 against the CPU engine; K10 at six
        # shapes, K11 at store_sales' size
        sqlm, sql_rows = sql_phase(work, card, dev)
        kernels.update(sql_rows)
        sql_launches = {k: sum(r["launches"][k] for r in
                               sqlm["full"].values()) for k in SQL_K}
        for name, key in (("byte_class", "k1"), ("winner_pack", "k2"),
                          ("hybrid_extract", "k3"), ("skip_mask", "k7")):
            kernels[name]["launches_sql"] = sql_launches[key]
        print("sql: " + json.dumps(sqlm), flush=True)
        for name in sql_rows:
            print(f"{name} phase: " + json.dumps(kernels[name]), flush=True)
        print(f"sql (b) queries: {sum(r['s'] for r in sqlm['full'].values()):.4f}"
              f" s on the card, {sum(r['cpu_s'] for r in sqlm['full'].values()):.4f}"
              f" s on the CPU, write {sqlm['write_s']:.4f} s, launches "
              + json.dumps(sql_launches) + f"; {card}", flush=True)
        lap("sql")

        # handoff: a checkpoint at the head of a 200-commit log
        small = os.path.join(work, "handoff")
        h_truth = synth_delta_log(small, 200, 100, seed=args.seed + 2,
                                  checkpoint_version=199, now_ms=WEEK_MS)
        h_state, h_counts, _, h_s, _ = _timed_load(
            small, Table, TorchEngine, obs)
        _truth_checks(h_state, h_truth, "handoff load")
        _ladder_idle(h_counts, "handoff load")
        _check(h_counts.get("decode.handoff_launches", 0) >= 1,
               "decode.handoff_launches >= 1")
        _check(h_counts.get("decode.device_fallbacks", 0) == 0,
               "handoff load: decode.device_fallbacks == 0")
        print("handoff load: " + json.dumps({
            "parts": h_truth.checkpoint.get("parts", 1), "load_s": h_s,
            "counters": h_counts}), flush=True)
        lap("handoff_load")

        # a small checkpointed log on the card and on the CPU: equal masks
        small = os.path.join(work, "small")
        synth_delta_log(small, 300, 100, seed=args.seed + 1,
                        checkpoint_version=290, now_ms=WEEK_MS)
        obs.reset()
        on_card = Table.for_path(small, engine=TorchEngine(
            parse_window_bytes=1 << 20)).latest_snapshot().state
        on_cpu = Table.for_path(small, engine=TorchEngine(
            "cpu", parse_window_bytes=1 << 20)).latest_snapshot().state
        _ladder_idle(obs.counters(), "small checkpointed log")
        _check(torch.equal(on_card.live_mask.cpu(), on_cpu.live_mask)
               and torch.equal(on_card.tombstone_mask.cpu(),
                               on_cpu.tombstone_mask)
               and on_card.add_files == on_cpu.add_files,
               "small checkpointed log: card == CPU")
        print("small checkpointed log: card == cpu", flush=True)
        lap("small_card_vs_cpu")

        # K4 on the OPTIMIZE cell's own rank matrix, then edge shapes
        appends = config4_appends(args.seed + 1)
        ranks = rank_matrix([np.concatenate([a[c] for a in appends])
                             for c in ZORDER_COLS], dev)
        kernels["interleave_bits"] = interleave_phase(ranks, dev)
        del ranks
        print("interleave_bits phase: " + json.dumps(
            kernels["interleave_bits"]), flush=True)

        # K5 and K6 on their own entry points (no production caller)
        kernels["unpack_bitpacked"] = unpack_phase(dev)
        print("unpack_bitpacked phase: " + json.dumps(
            kernels["unpack_bitpacked"]), flush=True)
        kernels["segmented_minmax"] = minmax_phase(appends, dev)
        print("segmented_minmax phase: " + json.dumps(
            kernels["segmented_minmax"]), flush=True)
        lap("k4_k5_k6")

        # the OPTIMIZE path, counters from 0
        opt = optimize_phase(work, appends[:OPTIMIZE_CELL_APPENDS], card,
                             dev)
        kernels["interleave_bits"]["launches"] = opt["launches"]
        kernels["interleave_bits"]["launches_wide_write"] = wide_write_k4
        kernels["interleave_bits"]["launches_column_mapping"] = cm_k4
        kernels["skip_mask"]["launches_read_table"] = \
            opt["read_table_counters"].get("kernel.skip_mask.launches", 0)
        print("optimize zorder: " + json.dumps(opt), flush=True)
        lap("optimize")
        # DML on a deletion-vector table (cell 10), each step's counters
        # from 0; K8 on its DVs at two shapes
        dml, k8_inputs = dml_phase(work, appends[:DML_APPENDS], card, dev)
        del appends
        steps = dml["steps"]
        kernels["dv_bits"] = dv_bits_row(*k8_inputs, dev, launches=sum(
            s["k8_pack"] + s["k8_decode"] for s in steps.values()))
        del k8_inputs
        kernels["dv_bits"]["launches_wide_types"] = wide_k8
        kernels["dv_bits"]["launches_wide_write"] = wide_write_k8
        kernels["dv_bits"]["launches_column_mapping"] = cm_k8
        kernels["dv_bits"]["launches_write_modes"] = wm_k8
        kernels["dv_bits"]["launches_per_step"] = {
            k: {"pack": s["k8_pack"], "decode": s["k8_decode"],
                "decode_dvs": s["k8_decode_dvs"]}
            for k, s in steps.items()}
        for name, key in (("skip_mask", "k7"), ("byte_class", "k1"),
                          ("winner_pack", "k2"), ("hybrid_extract", "k3")):
            kernels[name]["launches_dml"] = sum(s[key] for s in
                                                steps.values())
        print("dml: " + json.dumps(dml), flush=True)
        for name, s in steps.items():
            print(f"dml {name}: {s['s']:.4f} s, K8 pack {s['k8_pack']} "
                  f"decode {s['k8_decode']} ({s['k8_decode_dvs']} DVs), DV "
                  f"host path {json.dumps(s['dv_host_s'])}, "
                  f"parse.device_fallbacks {s['parse_device_fallbacks']}; "
                  f"{card}", flush=True)
        print("dv_bits phase: " + json.dumps(kernels["dv_bits"]), flush=True)
        lap("dml")
        # MERGE into a partitioned table (cell 11), each step's counters
        # from 0; K9 at the upsert's shape and a skewed one
        mrg, lanes = merge_phase(work, card, args.seed + 7, dev)
        steps = mrg["steps"]
        kernels["merge_join"] = merge_join_row(lanes, dev, launches=sum(
            s["k9"] for s in steps.values()))
        del lanes
        kernels["merge_join"]["launches_per_step"] = {
            k: s["k9"] for k, s in steps.items()}
        kernels["merge_join"]["launches_wide_write"] = wide_write_k9
        kernels["merge_join"]["launches_column_mapping"] = cm_k9
        for name, key in (("skip_mask", "k7"), ("byte_class", "k1"),
                          ("winner_pack", "k2"), ("hybrid_extract", "k3"),
                          ("interleave_bits", "k4")):
            kernels[name]["launches_merge"] = sum(s[key] for s in
                                                  steps.values())
        print("merge: " + json.dumps(mrg), flush=True)
        for name, s in steps.items():
            split = {k: v for k, v in s.get("phase_s", {}).items()
                     if k.startswith("join")}
            print(f"merge {name}: {s['s']:.4f} s, K9 {s['k9']}, join split "
                  f"{json.dumps(split)}; {card}", flush=True)
        print("merge_join phase: " + json.dumps(kernels["merge_join"]),
              flush=True)
        lap("merge")
        optimize_card_vs_cpu(work)
        print("small optimize, both curves: card == cpu", flush=True)
        lap("optimize_card_vs_cpu")
        if args.profile:
            profile_decode(parts)
            profile_load(path, Table, TorchEngine)
            profile_checkpoint_write(path, truth.version - 1)
            profile_optimize(os.path.join(work, "optimize"))
            lap("profile")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lap("cleanup")

    for name, key in (("byte_class", "k1"), ("winner_pack", "k2"),
                      ("hybrid_extract", "k3"), ("interleave_bits", "k4"),
                      ("unpack_bitpacked", "k5"), ("segmented_minmax", "k6"),
                      ("skip_mask", "k7"), ("merge_join", "k9")):
        kernels[name]["launches_maintenance"] = mt_launches[key]
    kernels["dv_bits"]["launches_maintenance"] = \
        mt_launches["k8_pack"] + mt_launches["k8_decode"]
    for name, key in (("byte_class", "k1"), ("winner_pack", "k2"),
                      ("hybrid_extract", "k3"), ("interleave_bits", "k4"),
                      ("unpack_bitpacked", "k5"), ("segmented_minmax", "k6"),
                      ("skip_mask", "k7"), ("merge_join", "k9")):
        kernels[name]["launches_table_features"] = tf_launches[key]
    kernels["dv_bits"]["launches_table_features"] = \
        tf_launches["k8_pack"] + tf_launches["k8_decode"]
    for key in ("k1", "k2", "k3", "k4", "k7", "k8_decode", "k9"):
        _check(tf_launches[key] >= 1,
               f"table_features: {key} launched ({tf_launches[key]})")
    for name, key in (("byte_class", "k1"), ("winner_pack", "k2"),
                      ("hybrid_extract", "k3"), ("interleave_bits", "k4"),
                      ("unpack_bitpacked", "k5"), ("segmented_minmax", "k6"),
                      ("skip_mask", "k7"), ("merge_join", "k9")):
        kernels[name]["launches_change_data_feed"] = cdf_launches[key]
    kernels["dv_bits"]["launches_change_data_feed"] = \
        cdf_launches["k8_pack"] + cdf_launches["k8_decode"]
    for key in ("k1", "k2", "k3", "k7", "k8_pack", "k8_decode", "k9"):
        _check(cdf_launches[key] >= 1,
               f"change_data_feed: {key} launched ({cdf_launches[key]})")
    for name, keys in STMT_ROWS.items():
        kernels[name]["launches_sql_statements"] = sum(
            sqlm["statements"]["launches"][k] for k in keys)
    for k in kernels.values():
        k["share"] = k["bound_ms"] / k["ms"]
        k["device_share"] = k["bound_ms"] / k["device_ms"]
    if DEVICE_MS_BY_EVENTS:
        print("device_ms by stalled events (the profiler missed): "
              + json.dumps(DEVICE_MS_BY_EVENTS))
    print(json.dumps({"kernels": list(kernels.values())}))
    print("phase_wall: " + json.dumps(
        dict(phase_wall, total=time.perf_counter() - t_start)), flush=True)
    print(card)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

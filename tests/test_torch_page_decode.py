"""The checkpoint page decode: the port's footer reader, snappy, plan
compiler, device decode (plain versions on the CPU), kernel K3's plain
version and host leaf reader, each against the JAX package's counterpart
on the same bytes, exactly (integer and bool lanes, byte-equal strings).

Parts: every golden fixture part; parts written by the JAX checkpointer
(`delta_tpu.log.checkpointer`) from a hand-written log with deletion
vectors, partition values, tags, txn, domainMetadata, protocol feature
lists and a configuration map; a bench-shaped part from the same
checkpointer, and pyarrow rewrites of it with a small dictionary page
limit (the path dictionary overflows into PLAIN pages) and with row
groups of 97 rows; an empty part.
"""

import glob
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from delta_tpu.engine.host import HostEngine
from delta_tpu.log import page_decode as ref_plan
from delta_tpu.ops import page_decode as ref_ops
from delta_tpu.ops.pallas_kernels import _shift_extract_body, shift_extract_tiled
from delta_tpu.ops.replay import pad_bucket
from delta_tpu.table import Table as RefTable
from delta_tpu_torch.log import page_decode as port_plan
from delta_tpu_torch.log import parquet_host, snappy
from delta_tpu_torch.log.parquet_footer import (
    DecodeCorrupt,
    DecodeUnsupported,
    read_footer,
)
from delta_tpu_torch.ops import page_decode as port_ops
from delta_tpu_torch.utils.synth import synth_delta_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's hybrid stage, compiled once per shape
_ref_hybrid = jax.jit(ref_ops._decode_stage_hybrid, static_argnums=(2, 3))
GOLDEN = sorted(glob.glob(os.path.join(
    REPO, "tests", "golden_fixtures", "*", "_delta_log", "*.parquet")))


def _line(obj) -> str:
    import json

    return json.dumps(obj, separators=(",", ":"))


def feature_log(root: str, checkpoint_version: int, commits: int = 5) -> str:
    """A log with deletion vectors, partition values (one null), tags,
    txn, domainMetadata, reader/writer features, a configuration map and a
    percent-encoded path; checkpointed by the JAX package at
    `checkpoint_version` (multi-part, 3 actions per part)."""
    from delta_tpu.config import settings

    log = os.path.join(root, "_delta_log")
    os.makedirs(log, exist_ok=True)
    schema = ('{"type":"struct","fields":[{"name":"x","type":"long",'
              '"nullable":true,"metadata":{}},{"name":"d","type":"string",'
              '"nullable":true,"metadata":{}}]}')

    def dv(tag, offset=None):
        d = {"storageType": "u", "pathOrInlineDv": f"dv{tag}",
             "sizeInBytes": 10, "cardinality": 2}
        if offset is not None:
            d["offset"] = offset
        return d

    def add(p, d="1", **kw):
        body = {"path": p, "partitionValues": {"d": d}, "size": len(p),
                "modificationTime": 7, "dataChange": True,
                "stats": _line({"numRecords": 1})}
        body.update(kw)
        return _line({"add": body})

    def remove(p, ts, **kw):
        return _line({"remove": dict({"path": p, "deletionTimestamp": ts,
                                      "dataChange": True,
                                      "partitionValues": {"d": "1"},
                                      "size": len(p)}, **kw)})

    versions = [
        [_line({"protocol": {"minReaderVersion": 3, "minWriterVersion": 7,
                             "readerFeatures": ["deletionVectors"],
                             "writerFeatures": ["deletionVectors",
                                                "domainMetadata"]}}),
         _line({"metaData": {"id": "feat", "format": {"provider": "parquet",
                                                      "options": {}},
                             "schemaString": schema, "partitionColumns": ["d"],
                             "configuration": {
                                 "delta.enableDeletionVectors": "true",
                                 "k": "v"}, "createdTime": 5}}),
         add("a.parquet"), add("b.parquet", d=None, tags={"t": "1"}),
         add("c%20d.parquet"), add("e.parquet", deletionVector=dv(1)),
         _line({"txn": {"appId": "app", "version": 3, "lastUpdated": 9}}),
         _line({"domainMetadata": {"domain": "dom", "configuration": "{}",
                                   "removed": False}})],
        [remove("a.parquet", 10), add("f.parquet", tags={}),
         remove("e.parquet", 11, deletionVector=dv(1)),
         add("e.parquet", deletionVector=dv(2, offset=4))],
        [add("g.parquet"), remove("b.parquet", 12),
         _line({"txn": {"appId": "app2", "version": 1}})],
        [add("h.parquet"), remove("g.parquet", 13),
         _line({"domainMetadata": {"domain": "dom", "configuration": "{1}",
                                   "removed": False}})],
        [add("a.parquet", d="2"), remove("c d.parquet", 14)],
    ][:commits]
    for v, lines in enumerate(versions):
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(lines) + "\n")
    old = settings.checkpoint_part_size
    settings.checkpoint_part_size = 3
    try:
        RefTable.for_path(root, engine=HostEngine()).checkpoint(
            version=checkpoint_version)
    finally:
        settings.checkpoint_part_size = old
    return root


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """{name: bytes} of every part the tests read."""
    out = {os.path.relpath(p, REPO): open(p, "rb").read() for p in GOLDEN}
    root = str(tmp_path_factory.mktemp("feature"))
    feature_log(root, 2)
    jax_parts = sorted(glob.glob(os.path.join(root, "_delta_log",
                                              "*.parquet")))
    assert len(jax_parts) > 2
    for p in jax_parts:
        out["jax:" + os.path.basename(p)] = open(p, "rb").read()
    # a bench-shaped log's JAX checkpoint, and its rewrite with a small
    # dictionary page limit: its path dictionaries overflow into PLAIN
    bench_root = str(tmp_path_factory.mktemp("bench"))
    synth_delta_log(bench_root, 40, 20, seed=7)
    RefTable.for_path(bench_root, engine=HostEngine()).checkpoint()
    (bench_part,) = glob.glob(os.path.join(bench_root, "_delta_log",
                                           "*.parquet"))
    out["jax-bench"] = open(bench_part, "rb").read()
    tbl = pq.read_table(bench_part)
    sink = io.BytesIO()
    pq.write_table(tbl, sink, compression="snappy",
                   dictionary_pagesize_limit=2048, write_batch_size=64,
                   data_page_size=4096)
    out["overflow"] = sink.getvalue()
    sink = io.BytesIO()
    pq.write_table(tbl, sink, compression="snappy", row_group_size=97)
    out["row-groups"] = sink.getvalue()
    sink = io.BytesIO()
    pq.write_table(tbl.slice(0, 0), sink, compression="snappy")
    out["empty"] = sink.getvalue()
    return out


def _names(parts):
    return sorted(parts)


# ------------------------------------------------------------- footer --

def test_footer_matches_pyarrow_metadata(parts):
    for name, data in parts.items():
        ft = read_footer(data)
        md = pq.ParquetFile(pa.BufferReader(data)).metadata
        assert ft.num_rows == md.num_rows, name
        assert len(ft.row_groups) == md.num_row_groups, name
        assert len(ft.leaves) == len(md.schema), name
        for i, leaf in enumerate(ft.leaves):
            c = md.schema.column(i)
            assert (leaf.path, leaf.physical_type, leaf.max_definition_level,
                    leaf.max_repetition_level) == (
                c.path, c.physical_type, c.max_definition_level,
                c.max_repetition_level), name
            for rg in range(md.num_row_groups):
                want = md.row_group(rg).column(i)
                got = ft.row_groups[rg].columns[i]
                assert (got.path, got.codec, got.encodings, got.num_values,
                        got.data_page_offset, got.dictionary_page_offset,
                        got.total_compressed_size,
                        got.total_uncompressed_size) == (
                    want.path_in_schema, want.compression, want.encodings,
                    want.num_values, want.data_page_offset,
                    want.dictionary_page_offset, want.total_compressed_size,
                    want.total_uncompressed_size), name
            assert ft.row_groups[0].num_rows == md.row_group(0).num_rows


def test_footer_refuses_what_is_not_parquet():
    """Bytes that are not Parquet are damage, not an unsupported form."""
    with pytest.raises(DecodeCorrupt):
        read_footer(b"PAR1")
    with pytest.raises(DecodeCorrupt):
        read_footer(b"not a parquet file at all")


# -------------------------------------------------------------- snappy --

@pytest.mark.parametrize("kind", ["random", "repetitive", "mixed", "empty",
                                  "long-literal"])
def test_snappy_agrees_with_pyarrow_both_ways(kind):
    rng = np.random.default_rng(len(kind))
    data = {
        "random": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "repetitive": b"abcd" * 20000 + b"x" * 70000,
        "mixed": b"".join(rng.choice([b"part-000", b"{\"numRecords\":",
                                      bytes(rng.integers(0, 256, 7,
                                                         dtype=np.uint8))])
                          for _ in range(4000)),
        "empty": b"",
        "long-literal": rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
    }[kind]
    codec = pa.Codec("snappy")
    theirs = codec.compress(data).to_pybytes()
    assert snappy.decompress(theirs, len(data)) == data
    assert snappy.decompress_py(theirs) == data
    ours = snappy.compress(data)
    assert codec.decompress(ours, decompressed_size=len(data)) \
        .to_pybytes() == data
    assert snappy.decompress_py(ours) == data
    if kind == "repetitive":
        assert len(ours) < len(data) // 10


def test_snappy_refuses_a_corrupt_stream():
    bad = snappy.compress(b"hello hello hello hello")[:-3]
    with pytest.raises(DecodeCorrupt):
        snappy.decompress(bad, 23)


# ---------------------------------------------------------- plan + decode --

def _plan_both(data):
    ft = read_footer(data)
    pf = pq.ParquetFile(pa.BufferReader(data))
    value_cols = [c for c in port_plan._VALUE_COLUMNS if c in ft.index]
    key_cols = [c for c in port_plan._KEY_COLUMNS if c in ft.index]
    ref = ref_plan.build_part_plan(pf, data, value_cols, key_cols)
    got = port_plan.build_part_plan(ft, data, value_cols, key_cols)
    return ref, got


def _decodable(parts):
    return [n for n in _names(parts)
            if n != "empty" and "add.size" in read_footer(parts[n]).index]


def _ref_lane(rp, pp):
    """A copy of the reference plan's lane with each empty key dictionary's
    remap slot zeroed: the decode never reads that slot; the reference
    leaves it uninitialized, the port writes zeros."""
    lane = rp.lane.copy()
    for row in pp.pages:
        if row[ref_ops.PG_KEY] and row[ref_ops.PG_DICTN] == 0:
            lane[row[ref_ops.PG_DICTB]:row[ref_ops.PG_DICTB] + 4] = 0
    return lane


def test_plan_equals_reference_plan(parts):
    names = _decodable(parts)
    assert len(names) >= 8
    dropped_seen = False
    for name in names:
        (rp, rs, ru, rd), (pp, ps, pu, pd) = _plan_both(parts[name])
        b, r, p = pp.lane.size, pp.runs.shape[0], pp.pages.shape[0]
        lane = _ref_lane(rp, pp)[:b]
        assert np.array_equal(lane, pp.lane), name
        assert not rp.lane[b:].any(), name
        assert np.array_equal(rp.runs[:r], pp.runs), name
        assert (rp.runs[r:, ref_ops.R_H] == ref_ops._FAR).all(), name
        assert np.array_equal(rp.pages[:p], pp.pages), name
        assert (rp.h_total, rp.n_rows, rp.has_keys) == (
            pp.h_total, pp.n_rows, pp.has_keys), name
        assert ru == pu and rd == pd, name
        assert [(s.name, s.phys, s.row_start, s.n_rows, s.key) for s in rs] \
            == [(s.name, s.phys, s.row_start, s.n_rows, s.key) for s in ps]
        dropped_seen |= bool(pd)
    assert dropped_seen  # the overflow part drops its path keys


def test_decode_equals_reference_decode(parts):
    for name in _decodable(parts):
        (rp, _, _, _), (pp, _, _, _) = _plan_both(parts[name])
        h_pad, n_pad = pad_bucket(rp.h_total), pad_bucket(rp.n_rows)
        fn = ref_ops._decode_fn(rp.lane.shape[0], rp.runs.shape[0],
                                rp.pages.shape[0], h_pad, n_pad, n_pad,
                                rp.has_keys, False)
        outs = fn(jnp.asarray(rp.lane), jnp.asarray(rp.runs),
                  jnp.asarray(rp.pages))
        lo, hi, defined, keys = port_ops.decode_part(pp, "cpu")
        n = pp.n_rows
        assert np.array_equal(np.asarray(outs[0])[:n].astype(np.int64),
                              lo.numpy()), name
        assert np.array_equal(np.asarray(outs[1])[:n].astype(np.int64),
                              hi.numpy()), name
        assert np.array_equal(np.asarray(outs[2])[:n], defined.numpy()), name
        assert (keys is None) == (not rp.has_keys), name
        if keys is not None:
            assert [keys.n_add, keys.n_rem, keys.n_bad] == \
                np.asarray(outs[4]).tolist(), name
            assert np.array_equal(np.asarray(outs[3])[:n].astype(np.int64),
                                  keys.codes.numpy()), name


# ------------------------------------------------------------ K3 plain --

def _random_plan(seed, n_runs, lane_bytes):
    from test_torch_cuda import random_hybrid_plan

    return random_hybrid_plan(np.random.default_rng(seed), n_runs,
                              lane_bytes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hybrid_extract_plain_equals_shift_extract(seed):
    """n % 1024 == 0: the reference's own gather feeding the Pallas kernel
    (interpret mode) and the jnp body, then the RLE select."""
    lane, runs, h = _random_plan(seed, 40, 3000)
    n = -(-h // 1024) * 1024
    got = port_ops.hybrid_extract_plain(torch.from_numpy(lane),
                                        torch.from_numpy(runs), n)
    got = got.numpy().view(np.uint32)
    padded = np.concatenate([lane, np.zeros(8, np.uint8)])
    hh = np.arange(n)
    rid = np.clip(np.searchsorted(runs[:, 0], hh, side="right") - 1, 0,
                  runs.shape[0] - 1)
    row = runs[rid].astype(np.int64)
    j = np.clip(hh - row[:, 0], 0, row[:, 1])
    bit = row[:, 2] + j * row[:, 3]
    gb = [padded[np.clip((bit >> 3) + k, 0, padded.size - 1)]
          .astype(np.uint32) for k in range(5)]
    lo = gb[0] | (gb[1] << 8) | (gb[2] << 16) | (gb[3] << 24)
    args = [jnp.asarray(a, jnp.uint32) for a in
            (lo, gb[4], bit & 7, row[:, 3])]
    for val in (np.asarray(shift_extract_tiled(*args)),
                np.asarray(_shift_extract_body(*args))):
        want = np.where(row[:, 4] == 1,
                        (row[:, 5] & 0xFFFFFFFF).astype(np.uint32), val)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed,n_runs,lane_bytes",
                         [(3, 1, 64), (4, 9, 500), (5, 300, 20000)])
def test_hybrid_extract_plain_equals_reference_hybrid_stage(
        seed, n_runs, lane_bytes):
    lane, runs, h = _random_plan(seed, n_runs, lane_bytes)
    for total in (h, 1, max(1, h - 7)):
        got = port_ops.hybrid_extract_plain(
            torch.from_numpy(lane), torch.from_numpy(runs), total)
        padded = np.concatenate([lane, np.zeros(8, np.uint8)])
        want = _ref_hybrid(jnp.asarray(padded), jnp.asarray(runs), total,
                           False)
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_hybrid_extract_takes_cpu_tensors_to_the_plain_version():
    lane, runs, h = _random_plan(6, 5, 256)
    lane_t, runs_t = torch.from_numpy(lane), torch.from_numpy(runs)
    tiles_t = torch.from_numpy(port_ops.tile_plan(runs, h))
    assert torch.equal(port_ops.hybrid_extract(lane_t, runs_t, h, tiles_t),
                       port_ops.hybrid_extract_plain(lane_t, runs_t, h))
    with pytest.raises(ValueError):
        port_ops.hybrid_extract(lane_t.to(torch.int32), runs_t, h, tiles_t)
    with pytest.raises(ValueError):
        port_ops.hybrid_extract(lane_t, runs_t[:, :5].contiguous(), h,
                                tiles_t)
    with pytest.raises(ValueError):
        port_ops.hybrid_extract(lane_t, runs_t, h, tiles_t[:, :1])


def _check_tiles(runs, h_total):
    tiles = port_ops.tile_plan(runs, h_total)
    T = port_ops.TILE
    if h_total == 0 or runs.shape[0] == 0:
        assert tiles.shape == (0, 2)
        return tiles
    first = tiles[:, port_ops.T_FIRST].astype(np.int64)
    end = np.append(first[1:], h_total)
    # consecutive from 0 to h_total: every position exactly once
    assert first[0] == 0 and (end > first).all()
    assert (end - first <= T).all()
    assert ((end - 1) // T == first // T).all()  # one aligned chunk each
    starts = runs[:, port_ops.R_H].astype(np.int64)
    for s in starts.tolist():  # no run starts strictly inside a tile
        assert not ((first < s) & (s < end)).any()
    hh = np.arange(h_total)
    rid = np.clip(np.searchsorted(starts, hh, side="right") - 1, 0,
                  starts.size - 1)
    tile_of = np.searchsorted(first, hh, side="right") - 1
    assert np.array_equal(tiles[tile_of, port_ops.T_RUN], rid)
    return tiles


@pytest.mark.parametrize("seed", range(8))
def test_tile_plan_covers_every_position_once_within_one_run(seed):
    """K3's tile table over random run plans, the edge plans and totals
    below and past the plan: every hybrid position in exactly one tile,
    each tile inside one run's positions (the run the plain version's
    lookup gives) and at most TILE positions."""
    rng = np.random.default_rng(seed)
    from test_torch_cuda import edge_hybrid_plans

    plans = list(edge_hybrid_plans())
    lane, runs, h = _random_plan(seed, int(rng.integers(1, 60)),
                                 int(rng.integers(64, 5000)))
    plans.append(("random", lane, runs, h))
    for name, lane, runs, h in plans:
        for total in (h, 1, max(1, h - 7), h + port_ops.TILE + 3, 0):
            tiles = _check_tiles(runs, total)
            lane_t, runs_t = torch.from_numpy(lane), torch.from_numpy(runs)
            assert torch.equal(
                port_ops.hybrid_extract(lane_t, runs_t, total,
                                        torch.from_numpy(tiles)),
                port_ops.hybrid_extract_plain(lane_t, runs_t, total)), name
    assert _check_tiles(np.zeros((0, 6), np.int32), 50).shape == (0, 2)


def test_part_plan_carries_its_tiles_in_one_buffer(parts):
    """The plan's lane, runs, tiles and pages are views of one host
    buffer, so one copy takes them to the device."""
    for name in _decodable(parts):
        _, (pp, _, _, _) = _plan_both(parts[name])
        assert np.array_equal(pp.tiles, port_ops.tile_plan(pp.runs,
                                                          pp.h_total)), name
        for view in (pp.lane, pp.runs, pp.tiles, pp.pages):
            assert view.base is not None and np.shares_memory(view, pp.host)
        dev = pp.views(torch.from_numpy(pp.host))
        for a, b in zip(dev, (pp.lane, pp.runs, pp.tiles, pp.pages)):
            assert np.array_equal(a.numpy(), b), name


def test_hybrid_extract_plain_on_real_plans_equals_reference(parts):
    for name in _decodable(parts):
        (rp, _, _, _), (pp, _, _, _) = _plan_both(parts[name])
        got = port_ops.hybrid_extract_plain(
            torch.from_numpy(pp.lane), torch.from_numpy(pp.runs), pp.h_total)
        # the 5-byte gather of a position next to an empty key
        # dictionary's remap slot reads it: zero it as the port does
        lane = _ref_lane(rp, pp)
        want = _ref_hybrid(
            jnp.asarray(np.concatenate([lane, np.zeros(8, np.uint8)])),
            jnp.asarray(rp.runs), pp.h_total, False)
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(want)), name


# ---------------------------------------------------------- host leaves --

def test_host_leaves_equal_pyarrow(parts):
    for name, data in parts.items():
        ft = read_footer(data)
        leaves = parquet_host.read_leaves(ft, data,
                                          [lf.path for lf in ft.leaves])
        tbl = pq.read_table(pa.BufferReader(data))
        flat = tbl.flatten()
        for path, leaf in leaves.items():
            parts_ = leaf.leaf.parts
            rows = np.arange(ft.num_rows)
            if leaf.reps is None:
                want = flat.column(path).to_pylist() \
                    if path in flat.column_names else None
                if want is None:  # under a list/map: not flattened
                    continue
                assert leaf.row_values(rows) == want, (name, path)
                continue
            container = ".".join(parts_[:-2])
            col = tbl.column(parts_[0]).combine_chunks()
            for p in parts_[1:-2]:
                col = pa.compute.struct_field(col, p)
            vals = col.to_pylist()
            got = leaf.row_lists(rows)
            if parts_[-1] == "key":
                want = [None if v is None else [k for k, _ in v]
                        for v in vals]
            elif parts_[-1] == "value":
                want = [None if v is None else [x for _, x in v]
                        for v in vals]
            else:
                want = vals
            # a null parent struct nulls its map or list too
            assert got == want, (name, container)


def _typed(v, t):
    """pyarrow's Python value of type `t` with maps as dicts and null
    struct fields dropped (the host reader's `assemble` form)."""
    if v is None:
        return None
    if pa.types.is_map(t):
        return dict(v.items() if isinstance(v, dict) else v)
    if pa.types.is_struct(t):
        out = {f.name: _typed(v.get(f.name), f.type) for f in t}
        return {k: x for k, x in out.items() if x is not None}
    if pa.types.is_list(t):
        return [_typed(x, t.value_type) for x in v]
    return v


def test_assembled_roots_equal_pyarrow(parts):
    for name, data in parts.items():
        ft = read_footer(data)
        leaves = parquet_host.read_leaves(ft, data,
                                          [lf.path for lf in ft.leaves])
        tbl = pq.read_table(pa.BufferReader(data))
        rows = np.arange(ft.num_rows)
        for root in tbl.column_names:
            typ = tbl.schema.field(root).type
            got = [_typed(d, typ) for d in parquet_host.assemble(
                leaves, root, rows)]
            want = [_typed(d, typ) for d in tbl.column(root).to_pylist()]
            assert got == want, (name, root)


def test_read_checkpoint_part_routes(parts):
    from delta_tpu_torch.replay.columnar import _wanted_leaf

    read = port_plan.read_checkpoint_part(parts["overflow"], "cpu",
                                          _wanted_leaf)
    # add.path fell back to PLAIN pages: that key is dropped, the part's
    # keys count no add row, so the handoff is off for it
    assert read.on_device and read.keys.n_add == 0
    assert "add.path" in read.leaves and "add.size" in read.decoded
    assert (pq.read_table(pa.BufferReader(parts["overflow"])).column("add")
            .null_count < read.n_rows)
    tbl = pq.read_table(pa.BufferReader(parts["overflow"])).flatten()
    for path, col in read.decoded.items():
        want = tbl.column(path).to_pylist()
        got = [v if ok else None for v, ok in zip(col.values.tolist(),
                                                  col.valid.tolist())]
        assert got == want, path
    empty = port_plan.read_checkpoint_part(parts["empty"], "cpu",
                                           _wanted_leaf)
    assert empty.n_rows == 0 and empty.on_device
    assert empty.keys.n_add == 0 and empty.keys.codes is None


def test_zstd_part_is_refused_on_both_routes():
    """Once refused, a ZSTD part now reads on both routes as the
    reference reads it (pyarrow's codec): the device plan decodes
    `add.size`, the host reader `add.path`."""
    tbl = pa.table({"add": pa.array([{"path": "a", "size": 1},
                                     {"path": "b", "size": 7}],
                                    pa.struct([("path", pa.string()),
                                               ("size", pa.int64())]))})
    sink = io.BytesIO()
    pq.write_table(tbl, sink, compression="zstd")
    data = sink.getvalue()
    ft = read_footer(data)
    plan, spans, _, _ = port_plan.build_part_plan(ft, data, ["add.size"], [])
    lo, hi, defined, _ = port_ops.decode_part(plan, torch.device("cpu"))
    sl = slice(spans[0].row_start, spans[0].row_start + spans[0].n_rows)
    assert port_plan._combine("INT64", lo[sl], hi[sl]).tolist() == [1, 7]
    assert defined[sl].tolist() == [True, True]
    leaf = parquet_host.read_leaves(ft, data, ["add.path"])["add.path"]
    assert leaf.row_values(np.arange(2)) == ["a", "b"]

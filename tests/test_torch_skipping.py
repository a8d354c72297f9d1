"""The port's stats index and skip mask against the JAX package's.

- `build_index` from the same stats strings: the port's lanes (values
  where valid, validity) and column map equal the reference's (whose
  lanes are padded: its first F columns are compared), on each parse case
  the reference's Arrow inference decides: integers, dates (timestamps),
  the writers' timestamp stats (strings, no lanes), a "NaN" or
  "Infinity" token beside numbers (the retry), an all-"NaN" column
  (strings), `min=1, max=1.5` (float), an integer past 2^53 in a float
  column (no lanes), pretty-printed stats, a row that does not parse (no
  index), booleans, nested stats, null stats rows, a missing numRecords,
  a float nullCount, an empty row, non-object rows, mixed kinds, big
  integers;
- `compile_conjuncts` gives the same `AtomBlock` on the same conjuncts;
- the plain skip mask (`skip_mask_plain`, on the CPU) equals the
  reference's `host_skip_mask` and its jnp function `_skip_fn_cached`,
  called directly under `jax.enable_x64(True)` (`skip_mask_block` goes
  through `_x64`, which fails under this jax: ROADMAP C0), bit for bit on
  32 seeded random blocks, empty groups included; no atom keeps all.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import delta_tpu.expressions.tree as RE
from delta_tpu.ops import skipping as ref_ops
from delta_tpu.ops.replay import pad_bucket
from delta_tpu.stats import device_index as ref_di
import delta_tpu_torch.expressions.tree as PE
from delta_tpu_torch.ops import skipping as port_ops
from delta_tpu_torch.stats import device_index as port_di
from delta_tpu_torch.stats.skipping import StatsIndex
from delta_tpu_torch.utils.timestamps import parse_timestamp_s


def _stats(num_records, mins, maxs, nulls):
    return json.dumps({"numRecords": num_records, "minValues": mins,
                       "maxValues": maxs, "nullCount": nulls})


def _int_case(rng, n=40):
    out = []
    for i in range(n):
        lo = int(rng.integers(-1000, 1000))
        out.append(_stats(10, {"a": lo, "b": lo * 3},
                          {"a": lo + int(rng.integers(0, 50)), "b": lo * 3},
                          {"a": int(rng.integers(0, 3)), "b": 0}))
    out[3 % n] = None
    out[7 % n] = _stats(10, {"b": 1}, {"b": 2}, {"a": 10, "b": 0})
    return out


def _cases():
    rng = np.random.default_rng(7)
    c = {"ints": _int_case(rng)}
    c["dates"] = [_stats(5, {"d": f"2024-01-{i + 1:02d}"},
                         {"d": f"2024-02-{i + 1:02d}"}, {"d": i % 2})
                  for i in range(20)]
    c["date_times"] = [_stats(5, {"t": "2024-01-01T10:00:00+01:30"},
                              {"t": "2024-01-02 10"}, {"t": 0})] * 3
    c["writer_timestamps"] = [
        _stats(5, {"t": f"2024-01-01T10:00:{i:02d}.000000+0000", "x": i},
               {"t": f"2024-01-01T11:00:{i:02d}.000000+0000", "x": i + 5},
               {"t": 0, "x": 0}) for i in range(12)]
    nan = [_stats(5, {"x": float(i)}, {"x": float(i) + 2}, {"x": 0})
           for i in range(10)]
    nan[4] = '{"numRecords":5,"minValues":{"x":"NaN"},' \
        '"maxValues":{"x":"Infinity"},"nullCount":{"x":0}}'
    nan[5] = '{"numRecords":5,"minValues":{"x":"-Infinity"},' \
        '"maxValues":{"x": "NaN"},"nullCount":{"x":0}}'
    c["nan_tokens"] = nan
    c["all_nan"] = ['{"numRecords":5,"minValues":{"x":"NaN","y":1},'
                    '"maxValues":{"x":"NaN","y":2},"nullCount":{"x":0}}'] * 4
    c["int_float"] = [_stats(5, {"x": 1}, {"x": 1.5}, {"x": 0}),
                      _stats(5, {"x": -3}, {"x": 7}, {"x": 1})]
    c["past_2_53"] = [_stats(5, {"x": 1, "y": 2}, {"x": 1.5, "y": 3},
                             {"x": 0, "y": 0}),
                      _stats(5, {"x": (1 << 53) + 1, "y": 4},
                             {"x": 2.5, "y": 9}, {"x": 0, "y": 0})]
    c["big_ints"] = [_stats(5, {"x": 1 << 63}, {"x": (1 << 63) + 5},
                            {"x": 0}), _stats(5, {"x": 0}, {"x": 1},
                                              {"x": 0})]
    c["pretty"] = [json.dumps(json.loads(s), indent=2)
                   for s in _int_case(rng, 9) if s is not None]
    c["pretty_crlf"] = [s.replace("\n", "\r\n") for s in c["pretty"]]
    bad = _int_case(rng, 9)
    bad[2] = '{"numRecords": 5, "minValues": {"a": '
    c["unparsable"] = bad
    c["bools"] = [_stats(5, {"b": bool(i % 2)}, {"b": True}, {"b": 0})
                  for i in range(6)]
    c["nested"] = [_stats(5, {"s": {"u": i, "v": "x"}}, {"s": {"u": i + 1}},
                          {"s": {"u": 0, "v": 1}}) for i in range(6)]
    c["null_rows"] = [None, None, _stats(3, {"a": 1}, {"a": 2}, {"a": 0})]
    c["all_null_rows"] = [None, None]
    c["no_num_records"] = ['{"minValues":{"a":1},"maxValues":{"a":4},'
                           '"nullCount":{"a":0}}'] * 3
    c["float_null_count"] = [_stats(5, {"a": 1}, {"a": 2}, {"a": 1.0}),
                             _stats(5, {"a": 1}, {"a": 2}, {"a": 2.0})]
    c["fraction_null_count"] = [_stats(5, {"a": 1}, {"a": 2}, {"a": 1.5})]
    c["string_null_count"] = ['{"numRecords":5,"minValues":{"a":1},'
                              '"maxValues":{"a":2},"nullCount":{"a":"3"}}']
    c["empty_row"] = [_stats(5, {"a": 1}, {"a": 2}, {"a": 0}), ""]
    c["non_object_row"] = [_stats(5, {"a": 1}, {"a": 2}, {"a": 0}), "[1]"]
    c["mixed_kinds"] = [_stats(5, {"a": 1}, {"a": 2}, {"a": 0}),
                        _stats(5, {"a": True}, {"a": 2}, {"a": 0})]
    c["min_struct_max_scalar"] = [_stats(5, {"a": {"b": 1}}, {"a": 2},
                                         {"a": 0})]
    c["bare_nan"] = ['{"numRecords":5,"minValues":{"a":NaN},'
                     '"maxValues":{"a":2},"nullCount":{"a":0}}',
                     '{"numRecords":5,"minValues":{"a":-Infinity},'
                     '"maxValues":{"a":Infinity},"nullCount":{"a":0}}']
    c["huge_float"] = [_stats(5, {"a": 1}, {"a": 2}, {"a": 0})[:-1]
                       + ',"z":1e400}']
    c["strings"] = [_stats(5, {"s": f"k{i:03d}", "n": None},
                           {"s": "k" + "z" * (32 if i % 3 == 0 else 5)},
                           {"s": 0}) for i in range(9)]
    return c


CASES = _cases()


def _ref_index(stats):
    return ref_di.build_index(pa.table({"stats": pa.array(stats,
                                                          pa.string())}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_index_matches_reference(case):
    stats = CASES[case]
    ref = _ref_index(stats)
    port = port_di.build_index(stats)
    n = len(stats)
    assert port.n == ref.n == n
    assert port.cols == ref.cols
    assert (port.vals is None) == (ref.vals is None)
    assert (port.host_index._table is None) == (ref.arrow_index._table
                                                is None)
    if ref.vals is None:
        return
    rv, rm = ref.vals[:, :n], ref.valid[:, :n]
    assert not ref.valid[:, n:].any()
    np.testing.assert_array_equal(port.valid, rm)
    np.testing.assert_array_equal(np.where(port.valid, port.vals, 0),
                                  np.where(rm, rv, 0))


@pytest.mark.parametrize("s", [
    "2024-01-01", "2024-01-01T10:00:00", "2024-01-01 10:00:00",
    "2024-01-01T10:00:00Z", "2024-01-01T10:00:00.123",
    "2024-01-01T10:00:00+0000", "2024-01-01T10:00:00-05:00",
    "2024-01-01T10Z", "2024-01-01T10", "2024-01-01Z", "2024-13-01",
    "2023-02-29", "2000-02-29", "1900-02-29", "0001-01-01",
    "9999-12-31T23:59:59", "2024-01-01T24:00:00", "2024-01-01T10:00:60",
    "2024-01-01T10:00:00+24:00", "2024-01-01T10:00:00+23:59",
    "2024-01-01t10:00:00", "2024-1-1", "20240101", "2024-01-01T",
    "2024-01-01T10:00:00+05", "2024-01-01T10:00:00+05:3", "abc",
])
def test_timestamp_inference_matches_arrow(s):
    import pyarrow.json as pj

    t = pj.read_json(pa.BufferReader(json.dumps({"a": s}).encode()))
    typ = t.schema.field("a").type
    want = t.column("a").cast(pa.int64())[0].as_py() \
        if pa.types.is_timestamp(typ) else None
    assert parse_timestamp_s(s) == want


def _build(spec, E):
    """The expression `spec` (nested tuples) in the tree module E."""
    tag = spec[0]
    if tag == "cmp":
        _, op, name, v, flip = spec
        c, lit = E.col(name), E.lit(v)
        return E.Comparison(op, lit, c) if flip else E.Comparison(op, c, lit)
    if tag == "in":
        return E.col(spec[1]).is_in(*spec[2])
    if tag == "null":
        return E.col(spec[1]).is_null()
    if tag == "notnull":
        return E.col(spec[1]).is_not_null()
    if tag == "not":
        return ~_build(spec[1], E)
    if tag == "or":
        return _build(spec[1], E) | _build(spec[2], E)
    if tag == "and":
        return _build(spec[1], E) & _build(spec[2], E)
    raise ValueError(tag)


CONJUNCTS = [
    ("cmp", "<", "a", 10, False), ("cmp", ">=", "a", -5, True),
    ("cmp", "=", "b", 12, False), ("cmp", "!=", "a", 3, False),
    ("in", "a", (1, 2, 300)), ("in", "a", tuple(range(0, 700, 10))),
    ("null", "a"), ("notnull", "b"), ("not", ("cmp", "<=", "a", 50, False)),
    ("not", ("null", "b")), ("or", ("cmp", "<", "a", 0, False),
                             ("cmp", ">", "b", 100, False)),
    ("or", ("and", ("cmp", "<", "a", 0, False),
            ("cmp", ">", "a", -9, False)), ("null", "a")),
    ("cmp", "<", "a", 1.5, False), ("cmp", "<", "a", "x", False),
    ("cmp", "=", "zz", 1, False), ("cmp", "<", "a", 1 << 60, False),
    ("in", "a", (1, None)),
]


def test_compile_conjuncts_matches_reference():
    stats = CASES["ints"]
    ref, port = _ref_index(stats), port_di.build_index(stats)
    rb, rf = ref_di.compile_conjuncts(
        [_build(s, RE) for s in CONJUNCTS], ref)
    pb, pf = port_di.compile_conjuncts(
        [_build(s, PE) for s in CONJUNCTS], port)
    assert [repr(c) for c in pf] == [repr(c) for c in rf]
    for field in ("rows_mn", "rows_mx", "rows_nc", "ops", "lits", "grp"):
        np.testing.assert_array_equal(getattr(pb, field), getattr(rb, field))
    assert (pb.n_atoms, pb.n_groups) == (rb.n_atoms, rb.n_groups)


@pytest.mark.parametrize("kind,values", [
    ("int", [0, -5, 1 << 62, True, 1.5, "1"]),
    ("float", [0, 1.5, -0.0, float("nan"), (1 << 53) + 1, 1 << 53, True]),
    ("bool", [True, False, 1]),
    ("ts", ["2024-01-01", "2024-01-01T10:00:00.5", "2024-01-01T10:00:00Z",
            "2024-01-01T10:00:00.1234567", "nope"]),
])
def test_encode_literal_matches_reference(kind, values):
    import datetime

    if kind == "ts":
        values = values + [datetime.date(2024, 1, 2),
                           datetime.datetime(2024, 1, 2, 3, 4, 5, 6),
                           datetime.datetime(2024, 1, 2,
                                             tzinfo=datetime.timezone.utc)]
    for v in values:
        assert port_di.encode_literal(v, kind) \
            == ref_di.encode_literal(v, kind), v


def _random_block(rng, n_cols, max_atoms):
    a = int(rng.integers(1, max_atoms + 1))
    cols = rng.integers(0, n_cols, a)
    g = int(rng.integers(1, a + 3))  # groups past the last atom's are empty
    grp = np.sort(rng.integers(0, g, a)).astype(np.int32)
    rng.shuffle(grp)
    rmn = (3 * cols).astype(np.int32)
    return port_ops.AtomBlock(
        rows_mn=rmn, rows_mx=rmn + 1, rows_nc=rmn + 2,
        ops=rng.integers(0, 8, a).astype(np.int32),
        lits=rng.integers(-20, 21, a).astype(np.int64),
        grp=grp, n_atoms=a, n_groups=g)


def _random_lanes(rng, n_cols, f):
    r = 3 * n_cols + 1
    vals = rng.integers(-20, 21, (r, f)).astype(np.int64)
    nr = rng.integers(0, 4, f)
    vals[-1] = nr
    for c in range(n_cols):  # null counts in [0, numRecords]
        vals[3 * c + 2] = np.minimum(rng.integers(0, 5, f), nr)
    valid = rng.random((r, f)) > 0.15
    return vals, valid


def _ref_jit_mask(vals, valid, block):
    a_pad = pad_bucket(max(block.n_atoms, 1), min_bucket=16)
    g_segs = pad_bucket(max(block.n_groups, 1), min_bucket=16) + 1

    def pad(a, fill, dtype):
        out = np.full(a_pad, fill, dtype=dtype)
        out[:block.n_atoms] = a
        return out

    with jax.enable_x64(True):
        keep = ref_ops._skip_fn_cached(a_pad, g_segs)(
            jnp.asarray(vals), jnp.asarray(valid),
            pad(block.rows_mn, 0, np.int32), pad(block.rows_mx, 0, np.int32),
            pad(block.rows_nc, 0, np.int32), pad(block.ops, 0, np.int32),
            jnp.asarray(pad(block.lits, 0, np.int64)),
            pad(block.grp, g_segs - 1, np.int32), np.int32(block.n_atoms))
        return np.asarray(keep)


@pytest.mark.parametrize("seed", range(32))
def test_plain_skip_mask_matches_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    n_cols = int(rng.integers(1, 4))
    f = int(rng.integers(1, 300))
    vals, valid = _random_lanes(rng, n_cols, f)
    block = _random_block(rng, n_cols, 12)
    got = port_ops.skip_mask_plain(torch.from_numpy(vals),
                                   torch.from_numpy(valid), block, f).numpy()
    ref_block = ref_ops.AtomBlock(*block)
    np.testing.assert_array_equal(
        got, ref_ops.host_skip_mask(vals, valid, ref_block, f))
    np.testing.assert_array_equal(got, _ref_jit_mask(vals, valid,
                                                     ref_block))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        port_ops.skip_mask_block(torch.from_numpy(vals),
                                 torch.from_numpy(valid), block,
                                 f).numpy(), got)


def test_no_atom_keeps_every_file():
    rng = np.random.default_rng(3)
    vals, valid = _random_lanes(rng, 2, 50)
    empty = port_ops.AtomBlock(
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32),
        np.zeros(0, np.int32), np.zeros(0, np.int64), np.zeros(0, np.int32),
        0, 3)
    assert port_ops.skip_mask_plain(torch.from_numpy(vals),
                                    torch.from_numpy(valid), empty,
                                    50).all()


def test_atoms_outside_the_lanes_raise():
    vals = torch.zeros((4, 5), dtype=torch.int64)
    valid = torch.ones((4, 5), dtype=torch.bool)
    bad = port_ops.AtomBlock(
        np.array([3], np.int32), np.array([4], np.int32),
        np.array([5], np.int32), np.array([0], np.int32),
        np.array([0], np.int64), np.array([0], np.int32), 1, 1)
    with pytest.raises(ValueError):
        port_ops.skip_mask_block(vals, valid, bad, 5)


def test_ladder_and_lanes_on_string_stats_match_reference():
    """String columns take the ladder (no lanes) with the truncated-max
    rule; the whole mask equals the reference's."""
    from delta_tpu.stats.skipping import skipping_mask as ref_mask
    from delta_tpu_torch.stats.skipping import skipping_mask as port_mask

    stats = CASES["strings"] + CASES["writer_timestamps"][:3]
    files = pa.table({"stats": pa.array(stats, pa.string())})
    for spec in [("cmp", "<", "s", "k002", False),
                 ("cmp", ">", "s", "kzzzzz", False),
                 ("cmp", "=", "s", "kzzzzzz", False),
                 ("cmp", "!=", "s", "k" + "z" * 32, False),
                 ("in", "s", ("k001", "k004")),
                 ("cmp", ">=", "t", "2024-01-01T10:30:00", False),
                 ("cmp", "<", "n", "a", False),
                 ("null", "n"), ("notnull", "s")]:
        assert StatsIndex.from_stats(stats)._table is not None
        np.testing.assert_array_equal(
            port_mask(stats, [_build(spec, PE)], None),
            ref_mask(files, [_build(spec, RE)], None), err_msg=str(spec))

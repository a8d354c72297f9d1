"""The curve key of OPTIMIZE ZORDER: the port against the JAX package.

`delta_tpu_torch.ops.interleave` (kernel K4's plain version and its
CPU route) and `delta_tpu_torch.ops.zorder` against
`delta_tpu.ops.pallas_kernels.interleave_bits_tiled` (interpret mode),
the jnp `interleave_bits`, and the reference's `range_rank`,
`hilbert_transpose`, `hilbert_key`, `curve_order` and
`zorder_sort_indices`. Inputs are seeded numpy; every comparison is
exact.

The reference's `zorder_sort_indices` reaches `interleave_bits_auto`,
whose `_x32()` fails under the installed jax (ROADMAP C0); the tests
patch it locally with `jax.enable_x64(False)`. Nothing in the JAX package
changes. Hilbert keys tie once the padded row count passes 65,536 (the
key keeps the top 16 bits of each rank), and the reference's sort is not
stable, so above that only the key words and the sorted key sequence are
held equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import delta_tpu.ops.pallas_kernels as ref_pk
from delta_tpu.ops import zorder as ref_z
from delta_tpu_torch.ops import zorder as tz
from delta_tpu_torch.ops.interleave import interleave_bits, interleave_bits_plain
from delta_tpu_torch.ops.u32 import to_i32_bits, widen_u32


@pytest.fixture
def ref_x32(monkeypatch):
    monkeypatch.setattr(ref_pk, "_x32", lambda: jax.enable_x64(False))


def _u32_cols(rng, k, n):
    cols = rng.integers(0, 2**32, (k, n), dtype=np.uint32)
    cols[:, ::7] = 0xFFFFFFFF       # all-ones values
    cols[:, 3::11] |= 0x80000000    # bit 31 set
    return cols


def _port_interleave(cols: np.ndarray, n_bits: int) -> np.ndarray:
    t = torch.from_numpy(cols.view(np.int32).copy())
    return interleave_bits_plain(t, n_bits).numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("n_bits", [16, 32])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_interleave_plain_matches_tiled_kernel_and_jnp(k, n_bits, n):
    cols = _u32_cols(np.random.default_rng(k * 100 + n_bits + n), k, n)
    got = _port_interleave(cols, n_bits)
    with jax.enable_x64(False):
        tiled = np.asarray(ref_pk.interleave_bits_tiled(
            jnp.asarray(cols), n_bits=n_bits))
        twin = np.asarray(ref_z.interleave_bits(
            [jnp.asarray(c) for c in cols], n_bits=n_bits))
    np.testing.assert_array_equal(got, tiled)
    np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("k,n_bits,n", [(1, 1, 1), (3, 32, 31), (2, 7, 33),
                                        (6, 11, 1025), (32, 32, 5)])
def test_interleave_odd_shapes_match_jnp(k, n_bits, n):
    cols = _u32_cols(np.random.default_rng(n), k, n)
    got = _port_interleave(cols, n_bits)
    with jax.enable_x64(False):
        twin = np.asarray(ref_z.interleave_bits(
            [jnp.asarray(c) for c in cols], n_bits=n_bits))
    np.testing.assert_array_equal(got, twin)


def test_interleave_wrapper_takes_plain_on_cpu_and_checks_inputs():
    cols = torch.from_numpy(_u32_cols(np.random.default_rng(3), 3, 100)
                            .view(np.int32).copy())
    assert torch.equal(interleave_bits(cols, 32),
                       interleave_bits_plain(cols, 32))
    with pytest.raises(ValueError):
        interleave_bits(cols.to(torch.int64), 32)
    with pytest.raises(ValueError):
        interleave_bits(cols, 33)
    with pytest.raises(ValueError):
        interleave_bits(torch.zeros((33, 4), dtype=torch.int32), 32)


def test_range_rank_matches_reference_with_ties():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 50, 3000).astype(np.uint32)
    v[::13] = 0xFFFFFFFF
    got = tz.range_rank(torch.from_numpy(v.astype(np.int64))).numpy()
    with jax.enable_x64(False):
        want = np.asarray(ref_z.range_rank(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_hilbert_transpose_and_key_match_reference(k):
    rng = np.random.default_rng(k)
    cols = rng.integers(0, 1 << 16, (k, 2000)).astype(np.uint32)
    port = tz.hilbert_transpose(
        [torch.from_numpy(c.astype(np.int64)) for c in cols])
    key = tz.hilbert_key([torch.from_numpy(c.astype(np.int64))
                          for c in cols]).numpy().view(np.uint32)
    with jax.enable_x64(False):
        ref = [np.asarray(x) for x in ref_z.hilbert_transpose(
            [jnp.asarray(c) for c in cols])]
        ref_key = np.asarray(ref_z.hilbert_key([jnp.asarray(c)
                                                for c in cols]))
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), b.astype(np.int64))
    np.testing.assert_array_equal(key, ref_key)


def test_curve_order_matches_reference_on_unique_keys():
    rng = np.random.default_rng(9)
    n = 5000
    words = rng.integers(0, 2**32, (3, n), dtype=np.uint32)
    words[0] = rng.integers(0, 4, n)        # long runs in the top word
    words[1, ::3] = 0x80000000              # ties broken by a later word
    words[2] = rng.permutation(n)           # every key unique
    got = tz.curve_order(torch.from_numpy(words.view(np.int32).copy()))
    with jax.enable_x64(False):
        want = np.asarray(ref_z.curve_order(jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), want)


def _columns(kind, n, rng):
    if kind == "ints":
        return [rng.integers(-1000, 1000, n), rng.integers(0, 1 << 30, n)]
    if kind == "floats":
        a = rng.normal(size=n)
        a[::17] = 0.0
        a[5::17] = -0.0
        a[7::31] = np.nan
        b = rng.normal(size=n).astype(np.float32)
        b[::23] = -np.inf
        return [a, b]
    if kind == "strings":
        return [np.array([f"k{int(x):05d}" for x in rng.integers(0, 500, n)]),
                rng.integers(0, 100, n)]
    if kind == "dates":
        return [np.datetime64("2020-01-01") + rng.integers(0, 3000, n)
                .astype("timedelta64[D]"),
                (rng.integers(0, 10**12, n) * 1000)
                .astype("datetime64[us]")]
    if kind == "wide":
        a = rng.integers(-2**62, 2**62, n)
        a[::9] = 2**62  # ties in the host rank
        return [a, rng.random(n) > 0.5]
    raise ValueError(kind)


@pytest.mark.parametrize("curve", ["zorder", "hilbert"])
@pytest.mark.parametrize("kind", ["ints", "floats", "strings", "dates",
                                  "wide"])
@pytest.mark.parametrize("n", [1, 700, 5000])
def test_zorder_sort_indices_matches_reference(ref_x32, kind, curve, n):
    cols = _columns(kind, n, np.random.default_rng(n))
    got = tz.zorder_sort_indices(cols, curve=curve, device="cpu")
    want = ref_z.zorder_sort_indices(cols, curve=curve)
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_zorder_sort_indices_runs_on_the_card_unless_asked():
    """The entry's default device is the card: without one it raises
    instead of running the plain versions on the host."""
    cols = _columns("ints", 50, np.random.default_rng(0))
    if torch.cuda.is_available():
        np.testing.assert_array_equal(
            tz.zorder_sort_indices(cols),
            tz.zorder_sort_indices(cols, device="cpu"))
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tz.zorder_sort_indices(cols)


def test_zorder_sort_indices_past_the_hilbert_limit(ref_x32):
    """m = 131,072: the Z-order permutation is still exact; for Hilbert
    the key words are equal and so is the sorted key sequence."""
    rng = np.random.default_rng(1)
    n = 70_000
    cols = [rng.integers(0, 1 << 30, n) for _ in range(3)]
    np.testing.assert_array_equal(
        tz.zorder_sort_indices(cols, curve="zorder", device="cpu"),
        ref_z.zorder_sort_indices(cols, curve="zorder").astype(np.int64))
    m = tz.pad_bucket(n)
    assert m == 131_072
    stacked = torch.from_numpy(
        np.stack([tz.to_sortable_u32(c) for c in cols]).view(np.int32))
    ranks = [tz.range_rank(widen_u32(row)) for row in stacked]
    keys = tz.hilbert_key(tz.scaled_ranks(stacked, m) >> 16) \
        .numpy().view(np.uint32)
    with jax.enable_x64(False):
        ref_scaled = [ref_z._scale_ranks(
            jnp.asarray(r.numpy().astype(np.uint32)), m, 32) >> 16
            for r in ranks]
        ref_keys = np.asarray(ref_z.hilbert_key(ref_scaled))
    np.testing.assert_array_equal(keys, ref_keys)
    got = tz.zorder_sort_indices(cols, curve="hilbert", device="cpu")
    want = ref_z.zorder_sort_indices(cols, curve="hilbert")
    assert sorted(got.tolist()) == list(range(n))
    np.testing.assert_array_equal(keys[:, got], keys[:, want])


def test_pad_bucket_matches_reference():
    from delta_tpu.ops.replay import pad_bucket as ref_pad

    for n in (1, 1023, 1024, 1025, 65_536, 65_537, 1 << 20, (1 << 20) + 1,
              10_000_000):
        assert tz.pad_bucket(n, 1024) == ref_pad(n, min_bucket=1024)


def test_sortable_u32_matches_reference():
    rng = np.random.default_rng(2)
    for kind in ("ints", "floats", "strings", "dates", "wide"):
        for c in _columns(kind, 300, rng):
            np.testing.assert_array_equal(tz.to_sortable_u32(c),
                                          ref_z._to_sortable_u32(c))


def test_scaled_ranks_feed_k4_as_bit_patterns():
    """Scaled ranks reach 2^32 - 2^shift: the int32 bit patterns handed to
    K4 carry bit 31, and the key words still equal the reference's."""
    n = 1000
    m = tz.pad_bucket(n)
    ranks = torch.arange(n, dtype=torch.int64).flip(0)
    scaled = torch.stack([tz._scale_ranks(ranks, m, 32)] * 2)
    assert int(scaled.max()) >= 1 << 31
    words = interleave_bits(to_i32_bits(scaled), 32).numpy().view(np.uint32)
    with jax.enable_x64(False):
        want = np.asarray(ref_z.interleave_bits(
            [jnp.asarray(scaled[i].numpy().astype(np.uint32))
             for i in range(2)]))
    np.testing.assert_array_equal(words, want)

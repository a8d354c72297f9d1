"""MERGE's equi-join: the port's `ops/join.py` against the JAX package's
`delta_tpu/ops/join.py`.

Seeded numpy inputs go through the reference's `_join_kernel` (jax on the
CPU, pad buckets and all) and through the port's `sort_codes` +
`join_tail_plain` (K9's plain version) on the same codes: `match_src`,
the source-matched words and `n_multi` must be equal, exactly, after the
reference's outputs are cut to [:nt] and [:ceil(ns/32)]. Then the entry
points `equi_join_codes` and `equi_join_device` against the reference's
(empty sides, no overlap, duplicate sources, NaN keys, multi-key strings
and ints, the codes whatever numpy and pandas number them), and the host
pair join against pandas' inner merge, which the reference's MERGE runs.
Cases mirror `tests/test_device_join.py`.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from delta_tpu.ops.join import _join_kernel
from delta_tpu.ops.join import equi_join_codes as ref_codes
from delta_tpu.ops.join import equi_join_device as ref_device
from delta_tpu.ops.replay import pad_bucket
from delta_tpu_torch import obs
from delta_tpu_torch.ops import join as J
from test_torch_cuda import JOIN_SHAPES, join_shape


def _reference_tail(t, s):
    """The reference kernel's outputs cut to the port's sizes."""
    nt, ns = len(t), len(s)
    nt_pad, ns_pad = pad_bucket(max(nt, 1)), pad_bucket(max(ns, 1))
    codes = np.full(nt_pad + ns_pad, 0xFFFFFFFF, np.uint32)
    codes[:nt] = t
    codes[nt_pad:nt_pad + ns] = s
    m, w, n_multi = _join_kernel(codes, nt_pad=nt_pad, ns_pad=ns_pad)
    return (np.asarray(m)[:nt], np.asarray(w)[:J.n_words(ns)],
            int(n_multi))


def _port_tail(t, s):
    nt, ns = len(t), len(s)
    codes = torch.from_numpy(np.concatenate([t, s]).astype(np.int32))
    s_code, s_pos = J.sort_codes(codes, nt)
    out = J.join_tail_plain(s_code, s_pos, nt, ns).numpy()
    return (out[:nt], out[nt:nt + J.n_words(ns)].view(np.uint32),
            int(out[-1]))


def _same_tail(t, s):
    want, got = _reference_tail(t, s), _port_tail(t, s)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    return got


TAIL_CASES = [
    # (nt, ns, distinct keys, seed)
    (5000, 1200, 3000, 0), (5000, 1200, 3000, 1), (5000, 1200, 3000, 2),
    (1, 1, 1, 3), (1, 1, 2, 4), (31, 33, 8, 5), (33, 31, 1, 6),
    (100, 1000, 50, 7), (1000, 100, 5000, 8), (64, 64, 64, 9),
    (3, 97, 2, 10), (257, 0, 4, 11), (0, 65, 4, 12),
]


@pytest.mark.parametrize("nt,ns,keys,seed", TAIL_CASES)
def test_tail_equals_the_reference_kernel(nt, ns, keys, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, keys, nt).astype(np.uint32)
    s = rng.integers(0, keys, ns).astype(np.uint32)
    _same_tail(t, s)


def test_tail_with_one_skewed_key():
    """One key with many target rows and several sources (the shape a
    skewed insert-only MERGE gives), beside unique keys."""
    rng = np.random.default_rng(13)
    t = np.concatenate([np.full(3000, 7), rng.integers(100, 900, 500)])
    s = np.concatenate([np.full(5, 7), rng.integers(100, 2000, 300)])
    m, _, n_multi = _same_tail(rng.permutation(t).astype(np.uint32),
                               rng.permutation(s).astype(np.uint32))
    assert n_multi >= 3000


@pytest.mark.parametrize("shape", sorted(JOIN_SHAPES))
def test_tail_on_the_kernels_adversarial_shapes(shape):
    """The shapes the card test holds K9 to its plain version on (one
    code, every code distinct, runs of one side only, block starts on
    and beside K9's tile and segment edges, n off the tile, ns < 32):
    the plain version equals the reference kernel."""
    t, s = join_shape(shape)
    m, words, n_multi = _same_tail(t.astype(np.uint32), s.astype(np.uint32))
    runs = JOIN_SHAPES[shape]
    # from the runs alone: matched targets, multi-matched ones, sources
    assert int((m >= 0).sum()) == sum(a for a, b in runs if b)
    assert n_multi == sum(a for a, b in runs if b > 1)
    matched = np.unpackbits(words.view(np.uint8), bitorder="little")
    assert int(matched.sum()) == sum(b for a, b in runs if a)


def test_sort_keeps_input_order_within_a_side():
    codes = torch.tensor([2, 1, 2, 1, 2, 1, 1, 2], dtype=torch.int32)
    s_code, s_pos = J.sort_codes(codes, 4)
    assert s_code.tolist() == [1, 1, 1, 1, 2, 2, 2, 2]
    assert s_pos.tolist() == [1, 3, 5, 6, 0, 2, 4, 7]


def test_plain_refuses_bad_lanes():
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        J.join_tail_plain(c, c.to(torch.int64), 2, 2)
    with pytest.raises(ValueError):
        J.join_tail(c, c, 2, 3)


def _entry_same(t, s):
    want = ref_codes(t.astype(np.uint32), s.astype(np.uint32))
    obs.reset()
    got = J.equi_join_codes(t.astype(np.int32), s.astype(np.int32),
                            device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert obs.counters().get("kernel.merge_join.launches", 0) == 0
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_codes_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 3000, 5000)
    s = rng.integers(0, 3000, 1200)
    _entry_same(t, s)
    assert obs.counters()["join.device_joins"] == 1


def test_no_overlap_and_empty_sides():
    match, n_multi, s_matched = _entry_same(np.array([1, 2, 3]),
                                            np.array([7, 8]))
    assert (match == -1).all() and n_multi == 0 and not s_matched.any()
    match, n_multi, s_matched = _entry_same(np.array([1, 2, 3]),
                                            np.empty(0, np.int64))
    assert (match == -1).all() and len(s_matched) == 0
    match, n_multi, s_matched = _entry_same(np.empty(0, np.int64),
                                            np.array([4, 4]))
    assert len(match) == 0 and not s_matched.any()


def test_duplicate_sources_first_one_wins():
    match, n_multi, s_matched = _entry_same(np.array([5, 6, 5, 9]),
                                            np.array([9, 5, 5, 1, 6]))
    assert match.tolist() == [1, 4, 1, 0] and n_multi == 2
    assert s_matched.tolist() == [True, True, True, False, True]


DEVICE_CASES = {
    "multi_key_strings_and_ints": (
        [np.array(["a", "b", "a", "c"], object), np.array([1, 2, 2, 3])],
        [np.array(["a", "a", "x"], object), np.array([2, 1, 9])]),
    "nan_keys_match_each_other": (
        [np.array([1.0, np.nan, 3.0]), np.array([np.nan, 2.0, 3.0])],
        [np.array([np.nan, 1.0]), np.array([2.0, np.nan])]),
    "signed_zero": (
        [np.array([0.0, -0.0, 1.5])], [np.array([-0.0, 2.0])]),
    "dates": (
        [np.array(["2024-01-01", "2024-01-02"], "datetime64[D]")],
        [np.array(["2024-01-02", "2024-01-02", "2023-01-01"],
                  "datetime64[D]")]),
    "three_wide_keys": (
        [np.arange(40) % 7, np.arange(40) % 5, (np.arange(40) * 13) % 11],
        [np.arange(25) % 7, np.arange(25) % 5, (np.arange(25) * 3) % 11]),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_join_device_matches_the_reference(case):
    t_cols, s_cols = DEVICE_CASES[case]
    want = ref_device(t_cols, s_cols)
    got = J.equi_join_device(t_cols, s_cols, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def test_random_multi_key_join_matches_the_reference():
    rng = np.random.default_rng(17)
    for _ in range(5):
        nt, ns = int(rng.integers(1, 400)), int(rng.integers(1, 300))
        t = [np.array([f"s{x}" for x in rng.integers(0, 9, nt)], object),
             rng.integers(0, 6, nt), rng.normal(size=nt).round(0)]
        s = [np.array([f"s{x}" for x in rng.integers(0, 12, ns)], object),
             rng.integers(0, 8, ns), rng.normal(size=ns).round(0)]
        want = ref_device(t, s)
        got = J.equi_join_device(t, s, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])


def test_codes_stay_below_2_31():
    wide = [np.arange(3000) * 7919 % 3000 for _ in range(4)]
    codes = J.joint_codes(wide, [c[:100] for c in wide])
    assert codes.dtype == np.int32 and codes.min() >= 0
    assert len(np.unique(codes)) == 3000


@pytest.mark.parametrize("seed", [0, 1])
def test_host_pair_join_equals_pandas_merge(seed):
    rng = np.random.default_rng(seed)
    nt, ns = 300, 200
    t = [rng.integers(0, 40, nt), np.array([f"k{x}" for x in
                                            rng.integers(0, 3, nt)], object)]
    s = [rng.integers(0, 40, ns), np.array([f"k{x}" for x in
                                            rng.integers(0, 3, ns)], object)]
    tdf = pd.DataFrame({"a": t[0], "b": t[1], "__tpos": np.arange(nt)})
    sdf = pd.DataFrame({"a": s[0], "b": s[1], "__spos": np.arange(ns)})
    joined = tdf.merge(sdf, on=["a", "b"], how="inner")
    want = sorted(zip(joined["__tpos"], joined["__spos"]))
    tpos, spos = J.host_pair_join(t, s)
    assert sorted(zip(tpos.tolist(), spos.tolist())) == want
    assert np.all(np.diff(tpos) >= 0)

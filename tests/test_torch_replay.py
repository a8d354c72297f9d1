"""The port's replay masks against the JAX package's.

`delta_tpu_torch.ops.replay.replay_select` (CPU: stable sort + K2's plain
version) against `delta_tpu.ops.replay.replay_select` (CPU jax) and
`python_replay_reference`, on the same numpy inputs handed over through
`delta_tpu_torch.interop`. Masks are bool: exact equality.
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from delta_tpu.ops import replay as ref_replay
from delta_tpu.utils.synth import fa_history
from delta_tpu_torch.interop import replay_inputs_from_numpy
from delta_tpu_torch.ops import replay as port_replay


def _assert_parity(key_lanes, version, order, is_add):
    want_live, want_tomb = ref_replay.replay_select(
        key_lanes, version, order, is_add)
    keys = list(zip(*[np.asarray(k).tolist() for k in key_lanes]))
    py_live, py_tomb = ref_replay.python_replay_reference(
        keys, version, order, is_add)
    np.testing.assert_array_equal(want_live, py_live)
    np.testing.assert_array_equal(want_tomb, py_tomb)

    lanes, v, o, a = replay_inputs_from_numpy(key_lanes, version, order,
                                              is_add, "cpu")
    live, tomb = port_replay.replay_select(lanes, v, o, a)
    assert live.dtype == torch.bool and tomb.dtype == torch.bool
    np.testing.assert_array_equal(live.numpy(), want_live)
    np.testing.assert_array_equal(tomb.numpy(), want_tomb)
    # the port's own copy of the sequential reference agrees too
    p_live, p_tomb = port_replay.python_replay_reference(
        keys, version, order, is_add)
    np.testing.assert_array_equal(p_live, want_live)
    np.testing.assert_array_equal(p_tomb, want_tomb)


@pytest.mark.parametrize("n,dv_frac", [(3000, 0.0), (3000, 0.05), (33, 0.2)])
def test_fa_history(n, dv_frac):
    pk, dk, ver, order, add, _ = fa_history(n, seed=n, dv_frac=dv_frac)
    _assert_parity([pk, dk], ver, order, add)


def test_example_batch():
    pk, dk, ver, order, add, _ = _example_batch()
    _assert_parity([pk, dk], ver, order, add)


def test_non_chronological_rows():
    pk, dk, ver, order, add, _ = fa_history(2000, seed=3)
    perm = np.random.default_rng(3).permutation(2000)
    _assert_parity([pk[perm], dk[perm]], ver[perm], order[perm], add[perm])


def test_key_equal_to_padding_sentinel():
    """A real key of 0xFFFFFFFF (the JAX package's padding value) replays
    like any other key."""
    rng = np.random.default_rng(5)
    n = 700
    keys = rng.integers(0, 60, n).astype(np.uint32)
    keys[rng.random(n) < 0.2] = 0xFFFFFFFF
    ver = np.sort(rng.integers(0, 50, n)).astype(np.int32)
    order = (np.arange(n) - np.searchsorted(ver, ver)).astype(np.int32)
    add = rng.random(n) < 0.6
    _assert_parity([keys], ver, order, add)
    _assert_parity([keys, np.zeros(n, np.uint32)], ver, order, add)


@pytest.mark.parametrize("n", [0, 1, 33])
def test_small_n(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 5, n).astype(np.uint32)
    ver = np.arange(n, dtype=np.int32)
    order = np.zeros(n, np.int32)
    add = rng.random(n) < 0.5
    _assert_parity([keys, np.zeros(n, np.uint32)], ver, order, add)


def test_combine_key_lanes_matches_reference():
    pk, dk, *_ = fa_history(500, seed=9, dv_frac=0.1)
    want = ref_replay.combine_key_lanes([pk, dk])
    got = port_replay.combine_key_lanes(
        [torch.from_numpy(pk.astype(np.int64)),
         torch.from_numpy(dk.astype(np.int64))])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # past the JAX package's u32 cap the port's int64 key still combines
    wide = [torch.tensor([0, 0xFFFFFFF0, 7]), torch.tensor([0, 3, 1])]
    assert ref_replay.combine_key_lanes([w.numpy().astype(np.uint32)
                                         for w in wide]) is None
    assert port_replay.combine_key_lanes(wide).tolist() == [
        0, 0xFFFFFFF0 * 4 + 3, 7 * 4 + 1]
    # and raises where no int64 holds the product of the ranges
    with pytest.raises(ValueError):
        port_replay.combine_key_lanes(
            [torch.tensor([0, 1 << 62]), torch.tensor([0, 3])])


def test_chrono_ok_matches_reference():
    ver = np.array([0, 0, 1, 1, 2], np.int32)
    for order in ([0, 1, 0, 1, 0], [1, 0, 0, 1, 0]):
        order = np.array(order, np.int32)
        assert port_replay.chrono_ok(torch.from_numpy(ver),
                                     torch.from_numpy(order)) \
            == ref_replay.chrono_ok(ver, order)

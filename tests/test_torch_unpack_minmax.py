"""K5 (`unpack_bitpacked`) and K6 (`segmented_minmax`) plain versions
against the JAX package's TPU kernels B4 and B5, run in interpret mode.

The reference wrappers `unpack_bitpacked` and `batched_file_stats` fail
under the installed jax (ROADMAP C0), so the jitted kernels
`unpack_bitpacked_tiled`, `_unpack_jnp` and `segmented_minmax` are called
directly. Inputs come from numpy with a seed. Everything is exact:
unpacked words bit for bit, floats bit for bit, NaN positions and the sign
of zero included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_tpu.ops import pallas_kernels as ref
from delta_tpu_torch.errors import InvalidArgumentError
from delta_tpu_torch.ops.minmax import (
    QUIET_NAN_BITS,
    batched_file_stats,
    segmented_minmax,
)
from delta_tpu_torch.ops.unpack import (
    unpack_bitpacked,
    unpack_bitpacked_plain,
    unpack_bitpacked_words,
)


def _words(w, g, seed):
    return np.random.default_rng(seed).integers(0, 2**32, (w, g),
                                                dtype=np.uint32)


def _port_unpack(words: np.ndarray, w: int) -> np.ndarray:
    out = unpack_bitpacked_words(torch.from_numpy(words.view(np.int32)), w)
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("g", [1024, 2048])
@pytest.mark.parametrize("w", range(1, 33))
def test_unpack_plain_equals_tiled_kernel_and_jnp_twin(w, g):
    words = _words(w, g, seed=w * 7 + g)
    words[:, ::5] = 0xFFFFFFFF  # all-ones groups
    got = _port_unpack(words, w)
    assert got.dtype == np.uint32 and got.shape == (g * 32,)
    assert np.array_equal(got, np.asarray(
        ref.unpack_bitpacked_tiled(jnp.asarray(words), w)))
    assert np.array_equal(got, np.asarray(ref._unpack_jnp(jnp.asarray(words),
                                                          w)))


@pytest.mark.parametrize("w", [1, 3, 8, 16, 17, 31, 32])
@pytest.mark.parametrize("g", [1, 31, 1025])
def test_unpack_any_group_count(w, g):
    """The port takes any G; the jnp twin does too."""
    words = _words(w, g, seed=g + w)
    assert np.array_equal(_port_unpack(words, w),
                          np.asarray(ref._unpack_jnp(jnp.asarray(words), w)))


@pytest.mark.parametrize("w", [0, 5, 32])
def test_unpack_wrapper_on_a_flat_word_stream(w):
    n_groups = 37
    stream = np.random.default_rng(w).integers(
        0, 2**32, n_groups * w + 3, dtype=np.uint32)  # extra words ignored
    got = unpack_bitpacked(stream, w, n_groups, device="cpu")
    assert got.device.type == "cpu" and got.shape == (n_groups * 32,)
    if w == 0:
        assert not got.any()
        return
    shaped = stream[:n_groups * w].reshape(n_groups, w).T
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(ref._unpack_jnp(jnp.asarray(shaped), w)))


@pytest.mark.parametrize("bad", [-1, 33, 2.5, "3", None])
def test_unpack_width_guard(bad):
    with pytest.raises(InvalidArgumentError):
        unpack_bitpacked(np.zeros(64, np.uint32), bad, 1, device="cpu")
    # the reference's guard refuses the same widths
    with pytest.raises(Exception) as e:
        ref._check_unpack_width(bad, allow_zero=True)
    assert type(e.value).__name__ == "InvalidArgumentError"


def test_unpack_words_rejects_a_shape_that_is_not_w_rows():
    with pytest.raises(ValueError):
        unpack_bitpacked_plain(torch.zeros((3, 4), dtype=torch.int32), 4)


def _minmax_inputs(f, r, seed):
    """Random values and mask, with the edge cases planted: signed zeros
    in both orders, NaN valid and masked, +inf as a min, -inf as a max,
    an empty file, an all-NaN file."""
    rng = np.random.default_rng(seed)
    at5, at3 = 5 % r, 3 % r
    v = (rng.normal(size=(f, r)) * 1e3).astype(np.float32)
    m = rng.random((f, r)) > 0.3
    edges = [
        lambda: (v[0].fill(0.0), v[0, ::2].fill(-0.0), m[0].fill(True)),
        lambda: (v[1].fill(-0.0), v[1, ::3].fill(0.0), m[1].fill(True)),
        lambda: (v[2].__setitem__(at5, np.nan), m[2].__setitem__(at5, True)),
        lambda: (v[3].fill(np.inf), m[3].fill(True)),
        lambda: (v[4].fill(-np.inf), v[4, 1:].fill(np.inf)),
        lambda: m[5].fill(False),
        lambda: (v[6].__setitem__(at3, np.nan), m[6].__setitem__(at3, False)),
        lambda: (v[7].fill(np.nan), m[7].fill(True)),
    ]
    for edge in edges[:f]:
        edge()
    return v, m


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("f,r,seed", [(8, 128, 0), (16, 256, 1),
                                      (24, 1024, 2), (8, 4096, 3)])
def test_segmented_minmax_plain_equals_the_tpu_kernel(f, r, seed):
    v, m = _minmax_inputs(f, r, seed)
    mn, mx, cnt = ref.segmented_minmax(jnp.asarray(v), jnp.asarray(m))
    pm, px, pc = segmented_minmax(torch.from_numpy(v), torch.from_numpy(m))
    assert np.array_equal(_bits(pm.numpy()), _bits(mn))
    assert np.array_equal(_bits(px.numpy()), _bits(mx))
    assert pc.dtype == torch.int32
    assert np.array_equal(pc.numpy(), np.asarray(cnt))
    # the planted edges, spelled out
    assert _bits(pm[0]) == 0x80000000 and _bits(px[0]) == 0
    assert _bits(pm[1]) == 0x80000000 and _bits(px[1]) == 0
    assert _bits(pm[2]) == _bits(px[2]) == QUIET_NAN_BITS
    assert pm[3] == np.inf and px[3] == np.inf
    assert pm[5] == np.inf and px[5] == -np.inf and pc[5] == 0
    assert not torch.isnan(pm[6])


@pytest.mark.parametrize("f,r", [(1, 1), (9, 129), (1, 129), (9, 1),
                                 (3, 500)])
def test_batched_file_stats_any_shape(f, r):
    """Any F and R: equal to the TPU kernel on the reference wrapper's
    padding, and to numpy where no NaN or signed zero decides."""
    v, m = _minmax_inputs(f, r, seed=f * 1000 + r)
    mn, mx, nulls, records = batched_file_stats(v, m, device="cpu")
    fpad, rpad = (-f) % 8, (-r) % 128
    rmn, rmx, rcnt = ref.segmented_minmax(
        jnp.asarray(np.pad(v, ((0, fpad), (0, rpad)))),
        jnp.asarray(np.pad(m, ((0, fpad), (0, rpad)))))
    assert np.array_equal(_bits(mn), _bits(np.asarray(rmn)[:f]))
    assert np.array_equal(_bits(mx), _bits(np.asarray(rmx)[:f]))
    assert np.array_equal(records, np.full(f, r, np.int64))
    assert np.array_equal(nulls, r - np.asarray(rcnt)[:f])
    assert nulls.dtype == records.dtype == np.int64
    for i in range(f):
        ok = v[i][m[i]]
        if ok.size and not np.isnan(ok).any() and not (ok == 0).any():
            assert mn[i] == ok.min() and mx[i] == ok.max()
        assert nulls[i] == r - ok.size


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        unpack_bitpacked(np.zeros(8, np.uint32), 8, 1)
    with pytest.raises(RuntimeError):
        batched_file_stats(np.zeros((1, 1)), np.ones((1, 1), bool))

"""The port's hand-written kernels, held against the JAX package.

K1 (`byte_class`) against `delta_tpu.ops.pallas_kernels.byte_class_tiled`
in interpret mode; K2 (`winner_pack`) against the tail of
`delta_tpu.ops.replay._sort_winner_pack`, reached through
`_winner_kernel`. On the CPU each wrapper runs its plain PyTorch version
(`tests/test_torch_cuda.py` holds each CUDA kernel against that plain
version on the card). Every comparison is exact.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_tpu.ops.pallas_kernels import byte_class_tiled
from delta_tpu.ops.replay import _winner_kernel, pad_bucket
from delta_tpu_torch.ops.byte_class import byte_class
from delta_tpu_torch.ops.replay import winner_pack

_TILE = 4096  # the Pallas kernel's length multiple


def _ref_classes(b: np.ndarray) -> np.ndarray:
    pad = (-len(b)) % _TILE
    x = np.concatenate([b, np.zeros(pad or _TILE, np.uint8)])
    return np.asarray(byte_class_tiled(jnp.asarray(x)))[:len(b)]


def _structural_bytes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, n, dtype=np.uint8)
    hot = rng.random(n) < 0.3
    b[hot] = rng.choice(np.frombuffer(b'\n"\\:{}', np.uint8), int(hot.sum()))
    return b


@pytest.mark.parametrize("n", [4096, 8192, 1, 17, 5000, 12289])
def test_byte_class_matches_pallas_on_random_bytes(n):
    b = _structural_bytes(n, seed=n)
    got = byte_class(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, _ref_classes(b))


def test_byte_class_matches_pallas_on_json_text():
    lines = [json.dumps({"add": {"path": f"p{i}\\\"x", "size": i,
                                 "stats": json.dumps({"n": i})}},
                        separators=(",", ":")) for i in range(200)]
    b = np.frombuffer(("\n".join(lines) + "\n").encode(), np.uint8).copy()
    assert len(b) % _TILE != 0
    got = byte_class(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, _ref_classes(b))


def test_byte_class_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        byte_class(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        byte_class(torch.zeros((2, 2), dtype=torch.uint8))
    assert byte_class(torch.zeros(0, dtype=torch.uint8)).numel() == 0


def _ref_winner_words(keys: np.ndarray) -> np.ndarray:
    """`_winner_kernel`'s packed winner words for raw uint32 keys, cut to
    ceil(n / 32) words (the rest only hold padding rows)."""
    n = len(keys)
    m = pad_bucket(n)
    lane = np.concatenate([keys.astype(np.uint32),
                           np.full(m - n, 0xFFFFFFFF, np.uint32)])
    words = np.asarray(_winner_kernel(
        (jnp.asarray(lane), jnp.asarray(np.int32(n))), width=0))
    return words[:-(-n // 32)].view(np.int32)


def _keys(n: int, seed: int) -> np.ndarray:
    """Long duplicate runs plus real keys equal to the JAX package's
    padding sentinel 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(1, n // 8), n).astype(np.uint32)
    keys[rng.random(n) < 0.1] = 0xFFFFFFFF
    return keys


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 1000, 4099])
def test_winner_pack_matches_sort_winner_pack(n):
    keys = _keys(n, seed=n)
    skey, sidx = torch.sort(torch.from_numpy(keys.astype(np.int64)),
                            stable=True)
    got = winner_pack(skey, sidx.to(torch.int32), n).numpy()
    np.testing.assert_array_equal(got, _ref_winner_words(keys))


def test_winner_pack_wrapper_checks_its_input():
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        winner_pack(k, torch.zeros(4, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        winner_pack(k, torch.zeros(3, dtype=torch.int32), 4)
    assert winner_pack(k[:0], torch.zeros(0, dtype=torch.int32), 0).numel() == 0

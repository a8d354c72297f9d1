"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: each test decides inside itself whether a GPU is present
and skips without one. This file imports neither jax nor the JAX package
(nor does the port), so it also runs where jax is not installed; the
repo's conftest imports jax, hence:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.ops.byte_class import byte_class, byte_class_plain
from delta_tpu_torch.ops.replay import winner_pack, winner_pack_plain
from delta_tpu_torch.utils.synth import synth_delta_log


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _structural_bytes(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, n, dtype=np.uint8)
    hot = rng.random(n) < 0.3
    b[hot] = rng.choice(np.frombuffer(b'\n"\\:{}', np.uint8), int(hot.sum()))
    return torch.from_numpy(b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4097, 1 << 20])
def test_byte_class_kernel_matches_plain(n):
    b = _structural_bytes(n, seed=n).to(_card())
    launches = obs.counter("kernel.byte_class.launches").read()
    assert torch.equal(byte_class(b), byte_class_plain(b))
    # an unaligned start takes the scalar path
    assert torch.equal(byte_class(b[1:]), byte_class_plain(b[1:]))
    torch.cuda.synchronize()
    assert obs.counter("kernel.byte_class.launches").read() \
        == launches + 1 + (n > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 4099, 100_003])
def test_winner_pack_kernel_matches_plain(n):
    dev = _card()
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(1, n // 8), n)
    keys[rng.random(n) < 0.1] = 0xFFFFFFFF
    skey, sidx = torch.sort(torch.from_numpy(keys).to(dev), stable=True)
    sidx = sidx.to(torch.int32)
    assert torch.equal(winner_pack(skey, sidx, n),
                       winner_pack_plain(skey, sidx, n))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_load_equals_cpu_load(tmp_path):
    _card()
    synth_delta_log(str(tmp_path), 60, 100, seed=3)
    obs.reset()
    on_card = Table.for_path(str(tmp_path), engine=TorchEngine(
        parse_window_bytes=1 << 16)).latest_snapshot().state
    counts = obs.counters()
    assert counts["kernel.byte_class.launches"] == counts["parse.device_windows"] > 1
    assert counts["kernel.winner_pack.launches"] == 1
    on_cpu = Table.for_path(str(tmp_path), engine=TorchEngine(
        "cpu", parse_window_bytes=1 << 16)).latest_snapshot().state
    assert on_card.live_mask.is_cuda
    assert torch.equal(on_card.live_mask.cpu(), on_cpu.live_mask)
    assert torch.equal(on_card.tombstone_mask.cpu(), on_cpu.tombstone_mask)
    assert on_card.add_files == on_cpu.add_files

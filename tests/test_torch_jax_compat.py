"""The JAX package's scoped precision switches under the installed jax.

`delta_tpu.ops.pallas_kernels._x32` and `delta_tpu.ops.stats._x64` enter
`jax.experimental.enable_x64(new_val)`, the context manager that older jax
releases exported there. Newer releases (0.9.0 among them) keep the same
context manager only as `jax.enable_x64(new_val)`, so without help every
reference entry point that goes through either switch raises
`ImportError`: the Z-order curve, the device stats, the checkpoint
hand-off, the skipping mask. Whether the reference's tests passed then
depended on which other tests a worker had already run.

Importing this module gives `jax.experimental` the old name, bound to the
new context manager, when the installed jax lacks it. pytest imports every
test module of `tests/` while it collects them, in every worker, so the
reference runs under the precision it asks for whatever the schedule.
Nothing in the JAX package changes. The tests below hold the two switches
to the precision each names, and the reference's curve key to the port's.
"""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if not hasattr(jax.experimental, "enable_x64"):
    def _enable_x64(new_val=True):
        return jax.enable_x64(new_val)

    jax.experimental.enable_x64 = _enable_x64

import delta_tpu.ops.pallas_kernels as ref_pk  # noqa: E402
import delta_tpu.ops.stats as ref_stats  # noqa: E402
from delta_tpu.ops import zorder as ref_z  # noqa: E402
from delta_tpu_torch.ops import zorder as tz  # noqa: E402
from delta_tpu_torch.ops.interleave import interleave_bits_plain  # noqa: E402


def test_reference_x32_switch_gives_32_bit_ints():
    with jax.enable_x64(True):
        with ref_pk._x32():
            assert jnp.arange(3).dtype == jnp.int32
        assert jnp.arange(3).dtype == jnp.int64


def test_reference_x64_switch_gives_64_bit_ints():
    with jax.enable_x64(False):
        with ref_stats._x64():
            assert jnp.arange(3).dtype == jnp.int64
        assert jnp.arange(3).dtype == jnp.int32


@pytest.mark.parametrize("n", [300, 1024])
def test_reference_interleave_auto_unpatched_equals_port(n):
    cols = np.random.default_rng(n).integers(0, 2**32, (2, n), dtype=np.uint32)
    want = np.asarray(ref_pk.interleave_bits_auto(jnp.asarray(cols), n_bits=32))
    t = torch.from_numpy(cols.view(np.int32).copy())
    got = interleave_bits_plain(t, 32).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_reference_zorder_sort_indices_unpatched_equals_port():
    rng = np.random.default_rng(1)
    cols = [rng.integers(-1000, 1000, 257).astype(np.int64),
            rng.normal(size=257)]
    want = ref_z.zorder_sort_indices(cols)
    got = tz.zorder_sort_indices(cols, device="cpu")
    np.testing.assert_array_equal(got, want.astype(np.int64))

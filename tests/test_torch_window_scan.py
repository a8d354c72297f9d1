"""Kernel K11's plain versions against the reference's jnp functions, and
K11 against its plain versions on a card.

`delta_tpu_torch/ops/window.py`'s `window_ranks_plain`,
`window_running_plain` and `window_peer_last_plain` against
`delta_tpu/ops/sqlops.py`'s `_ranks_kernel`, `_segscan_kernel` and
`_peer_last_kernel` on seeded numpy inputs: no rows, one row, one
partition, every row its own partition, long runs of peers, partitions
with no valid value, and every running op. Tolerance: ranks, counts, min
and max exact; a running sum or mean within 1e-9 of its partition's
absolute sum, where a valid value came before (the reference subtracts
float64 prefix sums, the plain version scans each partition by doubling,
the kernel adds in tile order). On the card, also: every launcher gives
the same bits on every call, takes inputs at an unaligned offset, and
holds infinities and sums that overflow within their partition. Those
cases stay out of the reference's parity tests: its running sum turns
every partition after an infinite prefix into NaN (ROADMAP C32).

The reference's jitted functions run inside `jax.enable_x64(True)`: its
public wrappers (`window_ranks`, ...) would turn x64 on for the whole
process (`_ensure_x64`, ROADMAP C0). jax is imported inside the tests
that use it, so the `cuda`-marked test runs where jax is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_window_scan.py
"""

import numpy as np
import pytest
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import window

RUNNING_OPS = ("sum", "mean", "count", "min", "max")
SUM_TOL = 1e-9


def _boundaries(rng, n: int, shape: str):
    """(pb, kb) of a layout: partitions and runs of peers in sorted order
    (pb[0] set; kb includes pb)."""
    pb = np.zeros(n, bool)
    kb = np.zeros(n, bool)
    if shape == "one_partition":
        kb = rng.random(n) < 0.3
    elif shape == "every_row":
        pb[:] = True
    elif shape == "long_peers":
        pb = rng.random(n) < 0.01
        kb = rng.random(n) < 0.002
    elif shape == "mixed":
        pb = rng.random(n) < 0.05
        kb = rng.random(n) < 0.4
    if n:
        pb[0] = True
    return pb, kb | pb


def _values(rng, n: int, shape: str):
    v = np.round(rng.normal(0, 500, n), 2)
    valid = rng.random(n) >= 0.2
    if shape == "all_invalid":
        valid[:] = False
    return v, valid


def _invalid_partitions(pb, valid):
    """Every third partition with no valid value."""
    part = np.cumsum(pb) - 1
    out = valid.copy()
    out[part % 3 == 1] = False
    return out


def _partition_abs_sum(pb, v, valid):
    part = np.cumsum(pb) - 1
    sums = np.zeros(int(part.max()) + 1 if len(part) else 0)
    np.add.at(sums, part, np.where(valid, np.abs(v), 0.0))
    return sums[part] if len(part) else sums


def _close_sums(got, want, counts, pb, v, valid):
    """Running sums or means within 1e-9 of the partition's absolute sum
    where the count is not 0 (a row with none is NULL to the caller:
    there the prefix-sum difference is a rounding of 0)."""
    scale = _partition_abs_sum(pb, v, valid)
    some = counts > 0
    assert (np.abs(got - want)[some] <= SUM_TOL * scale[some]).all()


def _ref_ranks(pb, kb):
    import jax
    import jax.numpy as jnp

    from delta_tpu.ops import sqlops as ref

    with jax.enable_x64(True):
        return [np.asarray(x) for x in ref._ranks_kernel(
            jnp.asarray(pb), jnp.asarray(kb))]


def _ref_running(v, valid, pb, op):
    import jax
    import jax.numpy as jnp

    from delta_tpu.ops import sqlops as ref

    with jax.enable_x64(True):
        out, cnt = ref._segscan_kernel(jnp.asarray(v), jnp.asarray(valid),
                                       jnp.asarray(pb), op=op)
        return np.asarray(out), np.asarray(cnt)


def _ref_peers(vals, counts, kb):
    import jax
    import jax.numpy as jnp

    from delta_tpu.ops import sqlops as ref

    with jax.enable_x64(True):
        out, cnt = ref._peer_last_kernel(jnp.asarray(vals),
                                         jnp.asarray(counts),
                                         jnp.asarray(kb))
        return np.asarray(out), np.asarray(cnt)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


SHAPES = ["one_partition", "every_row", "long_peers", "mixed"]
SIZES = [0, 1, 2, 7, 2048, 2049, 10_000]


def _cases():
    for n in SIZES:
        for shape in SHAPES:
            if n == 0 and shape != "mixed":
                continue
            yield n, shape


@pytest.mark.parametrize("n,shape", list(_cases()))
def test_ranks_plain_equals_reference(n, shape):
    rng = np.random.default_rng(n + len(shape))
    pb, kb = _boundaries(rng, n, shape)
    got = window.window_ranks_plain(_t(pb), _t(kb))
    if n == 0:
        assert all(g.numel() == 0 for g in got)
        return
    want = _ref_ranks(pb, kb)
    for g, w, what in zip(got, want, ("row_number", "rank", "dense_rank")):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), w), what


@pytest.mark.parametrize("op", RUNNING_OPS)
@pytest.mark.parametrize("n,shape", list(_cases()) + [
    (500, "all_invalid"), (5000, "invalid_partitions")])
def test_running_plain_equals_reference(n, shape, op):
    rng = np.random.default_rng(3 * n + len(shape))
    pb, _ = _boundaries(rng, n, "mixed" if "invalid" in shape else shape)
    v, valid = _values(rng, n, shape)
    if shape == "invalid_partitions":
        valid = _invalid_partitions(pb, valid)
    out, cnt = window.window_running_plain(_t(v), _t(valid), _t(pb), op)
    assert out.dtype == torch.float64 and cnt.dtype == torch.int64
    if n == 0:
        assert out.numel() == 0 and cnt.numel() == 0
        return
    w_out, w_cnt = _ref_running(v, valid, pb, op)
    assert np.array_equal(cnt.numpy(), w_cnt)
    if op in ("sum", "mean"):
        _close_sums(out.numpy(), w_out, w_cnt, pb, v, valid)
    else:
        assert np.array_equal(out.numpy(), w_out)
    if shape == "all_invalid":
        assert (cnt.numpy() == 0).all()


@pytest.mark.parametrize("n,shape", list(_cases()))
def test_peer_last_plain_equals_reference(n, shape):
    rng = np.random.default_rng(5 * n + len(shape))
    pb, kb = _boundaries(rng, n, shape)
    v, valid = _values(rng, n, shape)
    vals, counts = window.window_running_plain(_t(v), _t(valid), _t(pb),
                                               "sum")
    out, cnt = window.window_peer_last_plain(vals, counts, _t(kb))
    if n == 0:
        assert out.numel() == 0
        return
    w_out, w_cnt = _ref_peers(vals.numpy(), counts.numpy(), kb)
    assert np.array_equal(out.numpy(), w_out)
    assert np.array_equal(cnt.numpy(), w_cnt)


def test_wrappers_take_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(11)
    pb, kb = _boundaries(rng, 3000, "mixed")
    v, valid = _values(rng, 3000, "mixed")
    before = {k: obs.counter(k).read() for k in (
        "kernel.window_ranks.launches", "kernel.window_running.launches",
        "kernel.window_peer_last.launches")}
    for g, w in zip(window.window_ranks(_t(pb), _t(kb)),
                    window.window_ranks_plain(_t(pb), _t(kb))):
        assert torch.equal(g, w)
    for op in RUNNING_OPS:
        got = window.window_running(_t(v), _t(valid), _t(pb), op)
        want = window.window_running_plain(_t(v), _t(valid), _t(pb), op)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = window.window_peer_last(want[0], want[1], _t(kb))
    assert all(torch.equal(g, w) for g, w in zip(
        got, window.window_peer_last_plain(want[0], want[1], _t(kb))))
    assert {k: obs.counter(k).read() for k in before} == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "op"])
def test_wrappers_refuse_malformed_inputs(bad):
    pb = torch.ones(4, dtype=torch.bool)
    v = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        if bad == "dtype":
            window.window_ranks(pb.to(torch.uint8), pb)
        elif bad == "shape":
            window.window_running(v, pb[:3], pb, "sum")
        else:
            window.window_running(v, pb, pb, "median")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 1_000_003])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_equals_plain(n, shape):
    """K11's three launchers against their plain versions on the card:
    ranks, counts, min and max exact; a running sum or mean within 1e-9 of
    its partition's absolute sum; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K11 runs only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n + 7 * len(shape))
    pb, kb = _boundaries(rng, n, shape)
    v, valid = _values(rng, n, shape)
    valid = _invalid_partitions(pb, valid)
    tpb, tkb, tv, tvalid = _t(pb), _t(kb), _t(v), _t(valid)
    launches = obs.counter("kernel.window_ranks.launches").read()
    got = window.window_ranks(tpb.to(dev), tkb.to(dev))
    for g, w in zip(got, window.window_ranks_plain(tpb, tkb)):
        assert torch.equal(g.cpu(), w)
    assert obs.counter("kernel.window_ranks.launches").read() == launches + 1
    for op in RUNNING_OPS:
        out, cnt = window.window_running(tv.to(dev), tvalid.to(dev),
                                         tpb.to(dev), op)
        w_out, w_cnt = window.window_running_plain(tv, tvalid, tpb, op)
        assert torch.equal(cnt.cpu(), w_cnt), op
        if op in ("sum", "mean"):
            _close_sums(out.cpu().numpy(), w_out.numpy(), w_cnt.numpy(), pb,
                        v, valid)
        else:
            assert torch.equal(out.cpu(), w_out), op
    vals, counts = window.window_running_plain(tv, tvalid, tpb, "max")
    out, cnt = window.window_peer_last(vals.to(dev), counts.to(dev),
                                       tkb.to(dev))
    w_out, w_cnt = window.window_peer_last_plain(vals, counts, tkb)
    assert torch.equal(out.cpu(), w_out) and torch.equal(cnt.cpu(), w_cnt)


def test_running_sum_restarts_after_an_infinite_partition():
    """An infinite value stays in its partition: [1, inf, 2 | 3, 4] runs
    to [1, inf, inf, 3, 7]. The reference subtracts global prefix sums,
    so its later partition is NaN (ROADMAP C32, a caveat of the
    reference), where the port restarts."""
    v = np.array([1.0, np.inf, 2.0, 3.0, 4.0])
    valid = np.ones(5, bool)
    pb = np.array([True, False, False, True, False])
    for op, want in (("sum", [1.0, np.inf, np.inf, 3.0, 7.0]),
                     ("mean", [1.0, np.inf, np.inf, 3.0, 3.5])):
        out, cnt = window.window_running_plain(_t(v), _t(valid), _t(pb), op)
        assert out.tolist() == want, op
        assert cnt.tolist() == [1, 2, 3, 1, 2]
        w_out, w_cnt = _ref_running(v, valid, pb, op)
        assert np.array_equal(w_cnt, cnt.numpy())
        assert w_out[:3].tolist() == want[:3]
        assert np.isnan(w_out[3:]).all(), op


def _bits(x):
    return x.view(torch.int64) if x.dtype == torch.float64 else x


def _launch_all(pb, kb, v, valid):
    """Every launcher's outputs on these (device) inputs, the peer pass
    over the running sum's."""
    outs = list(window.window_ranks(pb, kb))
    for op in RUNNING_OPS:
        outs += window.window_running(v, valid, pb, op)
    outs += window.window_peer_last(outs[3], outs[4], kb)
    return [_bits(o).cpu() for o in outs]


def _special_values(rng, v, pb):
    """v with +inf, -inf, +1e308 or -1e308 at about 2% of the rows, one
    kind a partition: any order of adding a partition's values gives the
    same sums (a kind never meets its opposite)."""
    part = np.cumsum(pb) - 1
    kinds = rng.integers(0, 5, int(part[-1]) + 1)
    kinds[0] = 3  # the first partition overflows
    special = np.array([0.0, np.inf, -np.inf, 1e308, -1e308])
    hit = (rng.random(v.size) < 0.02) & (kinds[part] > 0)
    return np.where(hit, special[kinds[part]], v)


def _on_card(x, dev, offset):
    """x on the card, `offset` rows into its storage."""
    pad = torch.zeros(offset, dtype=x.dtype)
    return torch.cat([pad, x]).to(dev)[offset:]


def _held_to_plain(pb, kb, v, valid, dev, offset=0):
    """The launchers on the card, each input `offset` rows into its
    storage, against their plain versions on the CPU: ranks, counts, min
    and max exact; a non-finite sum or mean exact, a finite one within
    1e-9 of its partition's absolute sum; the peer pass bit for bit on the
    same inputs."""
    tpb, tkb, tv, tvalid = (_on_card(x, dev, offset)
                            for x in (pb, kb, v, valid))
    if offset:
        assert all(x.data_ptr() % 16 for x in (tpb, tkb, tv, tvalid))
    for g, w in zip(window.window_ranks(tpb, tkb),
                    window.window_ranks_plain(pb, kb)):
        assert torch.equal(g.cpu(), w)
    for op in RUNNING_OPS:
        out, cnt = window.window_running(tv, tvalid, tpb, op)
        w_out, w_cnt = window.window_running_plain(v, valid, pb, op)
        assert torch.equal(cnt.cpu(), w_cnt), op
        got, want = out.cpu().numpy(), w_out.numpy()
        if op not in ("sum", "mean"):
            assert np.array_equal(got, want), op
            continue
        fin = np.isfinite(want)
        assert np.array_equal(got[~fin], want[~fin], equal_nan=True), op
        keep = fin & (w_cnt.numpy() > 0)
        with np.errstate(over="ignore"):  # two 1e308 overflow the scale
            scale = _partition_abs_sum(pb.numpy(), v.numpy(), valid.numpy())
        assert (np.abs(got[keep] - want[keep])
                <= SUM_TOL * scale[keep]).all(), op
    vals, counts = window.window_running_plain(v, valid, pb, "sum")
    out, cnt = window.window_peer_last(_on_card(vals, dev, offset),
                                       _on_card(counts, dev, offset), tkb)
    w_out, w_cnt = window.window_peer_last_plain(vals, counts, kb)
    assert torch.equal(_bits(out.cpu()), _bits(w_out))
    assert torch.equal(cnt.cpu(), w_cnt)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K11 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_gives_the_same_bits_on_every_call():
    """Five calls of each launcher on one partition of 1,000,003 rows
    (about 489 tiles, every carry through the look-back) give the same
    bits: the float64 sum folds the tiles in one order whatever the
    look-back found."""
    dev = _card()
    rng = np.random.default_rng(29)
    n = 1_000_003
    pb, kb = _boundaries(rng, n, "one_partition")
    v, valid = _values(rng, n, "one_partition")
    args = [_t(x).to(dev) for x in (pb, kb, v, valid)]
    first = _launch_all(*args)
    for _ in range(4):
        again = _launch_all(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2049, 100_000])
@pytest.mark.parametrize("shape", ["one_partition", "mixed"])
def test_kernel_takes_unaligned_views(n, shape):
    """Inputs that are views 3 rows into their storage (flags 3 bytes,
    values 24 bytes past a 16-byte boundary) equal the plain versions."""
    dev = _card()
    rng = np.random.default_rng(n + len(shape))
    pb, kb = _boundaries(rng, n, shape)
    v, valid = _values(rng, n, shape)
    _held_to_plain(_t(pb), _t(kb), _t(v), _t(valid), dev, offset=3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["one_partition", "long_peers", "mixed"])
def test_kernel_holds_infinities(shape):
    """Values holding inf, -inf and +-1e308 (sums that overflow inside a
    partition, carried across tiles) equal the plain versions."""
    dev = _card()
    rng = np.random.default_rng(len(shape) + 1)
    n = 50_000
    pb, kb = _boundaries(rng, n, shape)
    v, valid = _values(rng, n, shape)
    v = _special_values(rng, v, pb)
    _held_to_plain(_t(pb), _t(kb), _t(v), _t(valid), dev)

"""The SQL operators' plain versions against the reference's jnp
functions (`delta_tpu/ops/sqlops.py`, queue B's B11).

- `ops/segagg.py::seg_agg_plain` (kernel K10's function) against
  `_segagg_kernel` (count, sum, min, max over int64 and float64 with
  validity), `_group_sizes_kernel` and `_centered_sumsq_kernel`, with
  all-null groups, empty input, int64 overflow and the card tests' code
  patterns (a warp step on one code, runs, no valid row);
  `GroupAggregator.var`
  and `.count` against numpy;
- `ops/sqlops.py::sort_permutation` against `_sort_kernel` (stable on
  ties);
- `join_pairs` against `_join_sort_kernel` plus the reference's
  `_expand_pairs`, for every `how`, many-to-many runs included.

The reference's jitted functions run inside `jax.enable_x64(True)`: its
public wrappers would turn x64 on for the whole process
(`_ensure_x64`), so the tests call the functions they wrap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_tpu.ops import sqlops as ref
from delta_tpu_torch.ops import sqlops
from delta_tpu_torch.ops.segagg import seg_agg, seg_agg_plain

OPS = ("count", "sum", "min", "max")


def _case(seed: int, n: int, n_groups: int, dtype, null_frac: float):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, max(n_groups, 1), n).astype(np.int32)
    if dtype == np.int64:
        v = rng.integers(-10**6, 10**6, n).astype(np.int64)
    else:
        v = np.round(rng.normal(0, 500, n), 2)
    valid = rng.random(n) >= null_frac
    if n_groups > 2 and n:
        valid[codes == 1] = False  # an all-null group
    return codes, v, valid


def _ref_segagg(codes, v, valid, op, n_groups):
    with jax.enable_x64(True):
        agg, cnt = ref._segagg_kernel(jnp.asarray(codes), jnp.asarray(v),
                                      jnp.asarray(valid), op=op,
                                      n_seg=n_groups)
        return np.asarray(agg), np.asarray(cnt)


def _port(codes, v, valid, op, n_groups, means=None):
    agg, cnt = seg_agg_plain(
        torch.from_numpy(codes), None if v is None else torch.from_numpy(v),
        None if valid is None else torch.from_numpy(valid), op, n_groups,
        None if means is None else torch.from_numpy(means))
    return agg.numpy(), cnt.numpy()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("n,n_groups,null_frac", [
    (0, 3, 0.0), (1, 1, 0.0), (1000, 7, 0.1), (5000, 1000, 0.3),
    (300, 300, 1.0)])
def test_seg_agg_plain_equals_segagg_kernel(op, dtype, n, n_groups,
                                            null_frac):
    codes, v, valid = _case(n + n_groups, n, n_groups, dtype, null_frac)
    want_agg, want_cnt = _ref_segagg(codes, v, valid, op, n_groups)
    got_agg, got_cnt = _port(codes, v, valid, op, n_groups)
    assert np.array_equal(got_cnt, want_cnt)
    assert got_agg.dtype == (np.int64 if op == "count" else dtype)
    if dtype == np.float64 and op == "sum":
        np.testing.assert_allclose(got_agg, want_agg, rtol=1e-12, atol=1e-9)
    else:
        assert np.array_equal(got_agg, want_agg)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("pattern", ["warp", "runs", "invalid"])
def test_seg_agg_plain_on_code_patterns_equals_segagg_kernel(op, dtype,
                                                             pattern):
    """The code patterns that the card's K10 tests hold the kernel to
    this plain version on: 128 rows in a row on one code (a warp step),
    tickets' runs of 1-25 rows, and no valid row at all."""
    n, n_groups = 5000, 37
    rng = np.random.default_rng(len(pattern))
    codes, v, valid = _case(7, n, n_groups, dtype, 0.1)
    if pattern == "warp":
        codes = np.repeat(rng.integers(0, n_groups, n // 128 + 1),
                          128)[:n].astype(np.int32)
    elif pattern == "runs":
        codes = np.repeat(np.arange(n) % n_groups,
                          rng.integers(1, 26, n))[:n].astype(np.int32)
    else:
        valid = np.zeros(n, bool)
    want_agg, want_cnt = _ref_segagg(codes, v, valid, op, n_groups)
    got_agg, got_cnt = _port(codes, v, valid, op, n_groups)
    assert np.array_equal(got_cnt, want_cnt)
    if dtype == np.float64 and op == "sum":
        np.testing.assert_allclose(got_agg, want_agg, rtol=1e-12, atol=1e-9)
    else:
        assert np.array_equal(got_agg, want_agg)


def test_seg_agg_plain_edges_equal_segagg_kernel():
    """±0.0 and infinities in min and max, and an int64 sum that wraps as
    the reference's segment_sum wraps."""
    codes = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    v = np.array([0.0, -0.0, -0.0, 0.0, np.inf, 1.0, -np.inf, -1.0])
    valid = np.ones(8, bool)
    for op in ("min", "max", "sum"):
        want, _ = _ref_segagg(codes, v, valid, op, 4)
        got, _ = _port(codes, v, valid, op, 4)
        assert np.array_equal(got, want), op
    big = np.array([2**62, 2**62, 2**62, -2**63], np.int64)
    c = np.zeros(4, np.int32)
    want, _ = _ref_segagg(c, big, np.ones(4, bool), "sum", 1)
    got, _ = _port(c, big, np.ones(4, bool), "sum", 1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,n_groups", [(0, 4), (1, 1), (10_000, 97)])
def test_seg_agg_plain_sizes_and_sumsq_equal_reference(n, n_groups):
    codes, v, valid = _case(n, n, n_groups, np.float64, 0.2)
    real = np.ones(n, bool)
    with jax.enable_x64(True):
        sizes = np.asarray(ref._group_sizes_kernel(
            jnp.asarray(codes), jnp.asarray(real), n_seg=n_groups))
        means = np.random.default_rng(1).normal(0, 100, n_groups)
        ss = np.asarray(ref._centered_sumsq_kernel(
            jnp.asarray(codes), jnp.asarray(v), jnp.asarray(valid),
            jnp.asarray(means), n_seg=n_groups))
    got_sizes, same = _port(codes, None, None, "count", n_groups)
    assert np.array_equal(got_sizes, sizes) and np.array_equal(same, sizes)
    got_ss, cnt = _port(codes, v, valid, "sumsq", n_groups, means)
    np.testing.assert_allclose(got_ss, ss, rtol=1e-12)
    assert np.array_equal(cnt, np.bincount(codes[valid],
                                           minlength=n_groups))


def test_group_aggregator_var_equals_numpy():
    codes, v, valid = _case(5, 4000, 9, np.float64, 0.1)
    ga = sqlops.GroupAggregator(codes, 9, device="cpu")
    var, cnt = ga.var(v, valid)
    for g in range(9):
        x = v[(codes == g) & valid]
        assert cnt[g] == len(x)
        if len(x) >= 2:
            assert var[g] == pytest.approx(np.var(x, ddof=1), rel=1e-12)
        else:
            assert np.isnan(var[g])
    assert np.array_equal(ga.sizes(), np.bincount(codes, minlength=9))
    assert np.array_equal(ga.count(valid),
                          np.bincount(codes[valid], minlength=9))
    assert np.array_equal(ga.count(None), ga.sizes())


def test_seg_agg_refuses_bad_inputs():
    codes = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        seg_agg(codes, torch.zeros(3, dtype=torch.float32), None, "sum", 1)
    with pytest.raises(ValueError):
        seg_agg(codes, torch.zeros(3, dtype=torch.float64), None, "median",
                1)
    with pytest.raises(ValueError):
        seg_agg(codes, torch.zeros(3, dtype=torch.float64), None, "sumsq", 1)


def _lanes(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, n).astype(np.uint8),      # a null lane
            rng.integers(-3, 3, n).astype(np.int64),     # ties
            np.round(rng.normal(0, 2, n), 0),            # float ties
            rng.integers(0, 2, n).astype(np.int64)]


@pytest.mark.parametrize("n", [0, 1, 17, 5000])
def test_sort_permutation_equals_sort_kernel(n):
    lanes = _lanes(n, n)
    got = sqlops.sort_permutation(lanes, device="cpu")
    if n == 0:
        assert len(got) == 0
        return
    with jax.enable_x64(True):
        ops = tuple(jnp.asarray(l) for l in lanes) + (
            jnp.arange(n, dtype=jnp.int64),)
        want = np.asarray(ref._sort_kernel(ops, num_keys=len(lanes)))
    assert np.array_equal(got, want)


def _ref_join_pairs(l_codes, r_codes, how):
    nl, nr = len(l_codes), len(r_codes)
    codes = np.concatenate([l_codes, r_codes]).astype(np.uint32)
    side = np.concatenate([np.zeros(nl, np.uint32), np.ones(nr, np.uint32)])
    with jax.enable_x64(True):
        s_code, s_side, s_pos = (np.asarray(a) for a in ref._join_sort_kernel(
            jnp.asarray(codes), jnp.asarray(side),
            jnp.arange(nl + nr, dtype=jnp.int64)))
    return ref._expand_pairs(s_code, s_side, s_pos, nl, how)


def _pairs(l_idx, r_idx):
    return sorted(zip(l_idx.tolist(), r_idx.tolist()))


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("nl,nr,keys", [
    (0, 0, 1), (5, 0, 3), (0, 4, 3), (1, 1, 1), (200, 300, 20),
    (2000, 50, 2000), (64, 64, 1)])
def test_join_pairs_equal_reference(how, nl, nr, keys):
    rng = np.random.default_rng(nl * 7 + nr)
    l = rng.integers(0, keys, nl).astype(np.int32)
    r = rng.integers(0, keys, nr).astype(np.int32)
    got = sqlops.join_pairs(l, r, how=how, device="cpu")
    want = _ref_join_pairs(l, r, how)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    # every pair of equal codes once, the unmatched rows `how` keeps
    pairs = {(i, j) for i in range(nl) for j in range(nr) if l[i] == r[j]}
    if how in ("left", "outer"):
        pairs |= {(i, -1) for i in range(nl) if l[i] not in set(r)}
    if how in ("right", "outer"):
        pairs |= {(-1, j) for j in range(nr) if r[j] not in set(l)}
    assert _pairs(*got) == sorted(pairs)


def test_a_failing_k10_raises_through_the_executor(monkeypatch, tmp_path):
    """No fallback: a K10 failure on the group-by, COUNT(DISTINCT) and
    partition-window paths propagates out of the query (on the card a build or launch failure raises the same
    way; `tests/test_torch_cuda.py` holds that there)."""
    from delta_tpu_torch import TorchEngine
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.sqlengine import execute_select

    p = str(tmp_path / "t")
    write_table(p, {"k": np.arange(10) % 3, "v": np.arange(10.0)},
                engine=TorchEngine("cpu"))

    def broken(*a, **k):
        raise RuntimeError("seg_agg launch failed: CUDA error 700")

    monkeypatch.setattr(sqlops, "seg_agg", broken)
    with pytest.raises(RuntimeError, match="seg_agg launch failed"):
        execute_select(f"SELECT k, sum(v) FROM '{p}' GROUP BY k",
                       engine=TorchEngine("cpu"))
    # COUNT(DISTINCT) counts its runs through K10 too, and a partition
    # window aggregates through it
    for q in (f"SELECT count(DISTINCT v) FROM '{p}'",
              f"SELECT k, sum(v) OVER (PARTITION BY k) FROM '{p}'"):
        with pytest.raises(RuntimeError, match="seg_agg launch failed"):
            execute_select(q, engine=TorchEngine("cpu"))

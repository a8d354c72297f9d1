"""Space-filling-curve clustering keys (OPTIMIZE ZORDER BY / Hilbert).

Counterpart of `delta_tpu/ops/zorder.py`. Pipeline
(`MultiDimClustering.scala:41-69` semantics):

1. `range_rank`: each clustering column -> its rank in [0, n), by a
   stable argsort, so equal values rank by row index as `jnp.argsort`
   ranks them;
2. `_scale_ranks` spreads the ranks over 32 bits; the Z-order key is
   their bit interleave (kernel K4, `ops/interleave.py`), the Hilbert key
   the interleave (n_bits 16) of Skilling's transposed form
   (`hilbert_transpose`, elementwise torch);
3. `curve_order`: the row order along the curve, a lexicographic sort of
   the key words by stable passes, last word first.

`zorder_sort_indices` is the host entry: every clustering column rides
to the device in ONE transfer and the permutation comes back in one. The
reference pads the rows to `pad_bucket(n, 1024)` with all-ones rows that
rank and sort after every real row; the port does not pad, but takes the
rank scale from that padded size, because the Hilbert key keeps only the
top 16 bits of each scaled rank and so depends on it.

u32 values travel as int32 bit patterns and are widened to int64 lanes
before any comparison (a signed int32 sort would misorder values with bit
31 set).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from delta_tpu_torch.ops.interleave import interleave_bits
from delta_tpu_torch.ops.u32 import U32, to_i32_bits, widen_u32

_MIN_BUCKET = 1024
_FINE_PAD_START = 1 << 20  # above this, pad linearly instead of to pow2
_FINE_PAD_STEP = 1 << 19
HILBERT_BITS = 16


def pad_bucket(n: int, min_bucket: int = _MIN_BUCKET) -> int:
    """The reference's shape bucket (`delta_tpu/ops/replay.py:81-92`): the
    next power of two up to 1M rows, then the next multiple of 512k."""
    if n <= min_bucket:
        return min_bucket
    if n <= _FINE_PAD_START:
        return 1 << (int(n - 1).bit_length())
    return -(-n // _FINE_PAD_STEP) * _FINE_PAD_STEP


def range_rank(values: torch.Tensor) -> torch.Tensor:
    """Rank in [0, n) of each value (int64 lanes), ties broken by row
    index; int64."""
    n = values.shape[0]
    order = torch.argsort(values, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(n, dtype=order.dtype, device=values.device)
    return ranks


def _scale_ranks(ranks: torch.Tensor, m: int, n_bits: int) -> torch.Tensor:
    """Spread ranks of a (padded) size-m column over the full n_bits key
    space so that the interleave uses high bits first."""
    shift = max(0, n_bits - max(1, (m - 1).bit_length()))
    return (ranks << shift) & U32


def hilbert_transpose(cols: Sequence[torch.Tensor],
                      n_bits: int = HILBERT_BITS) -> List[torch.Tensor]:
    """Skilling's inverse transform (public domain, 2004): coordinates
    (u32 values in int64 lanes) -> the 'transposed' Hilbert form, by
    elementwise selects over the columns; the bit loop is static."""
    d = len(cols)
    X = [c & U32 for c in cols]
    Q = 1 << (n_bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(d):
            has = (X[i] & Q) != 0
            # bit set: invert the low bits of X[0]; else swap them with X[i]
            t = (X[0] ^ X[i]) & P
            x0 = torch.where(has, X[0] ^ P, X[0] ^ t)
            if i != 0:
                X[i] = torch.where(has, X[i], X[i] ^ t)
            X[0] = x0
        Q >>= 1
    for i in range(1, d):  # Gray encode
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    Q = 1 << (n_bits - 1)
    while Q > 1:
        t = torch.where((X[d - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    return [x ^ t for x in X]


def hilbert_key(cols: Sequence[torch.Tensor],
                n_bits: int = HILBERT_BITS) -> torch.Tensor:
    """Coordinates (int64 lanes) -> Hilbert key words, int32 bit patterns
    [ceil(k * n_bits / 32), n]: the interleave of the transposed form."""
    X = hilbert_transpose(cols, n_bits=n_bits)
    return interleave_bits(to_i32_bits(torch.stack(X)), n_bits=n_bits)


def curve_order(key_words: torch.Tensor) -> torch.Tensor:
    """Row order along the curve: lexicographic argsort of the key words
    (int32 bit patterns [w, n], word 0 most significant), by stable LSD
    passes. int64 permutation."""
    w, n = key_words.shape
    perm = torch.arange(n, dtype=torch.int64, device=key_words.device)
    for i in range(w - 1, -1, -1):
        key = widen_u32(key_words[i])[perm]
        perm = perm[torch.argsort(key, stable=True)]
    return perm


def scaled_ranks(stacked: torch.Tensor, m: int) -> torch.Tensor:
    """Each row of the [k, n] int32 bit-pattern key matrix ranked and
    scaled over 32 bits by the padded size m: u32 values in int64 [k, n].
    The Z-order key interleaves them; the Hilbert key keeps their top
    HILBERT_BITS bits."""
    return torch.stack([_scale_ranks(range_rank(widen_u32(row)), m, 32)
                        for row in stacked])


def _no_mark(name: str) -> None:
    pass


def _curve_perm(stacked: torch.Tensor, m: int, curve: str,
                mark: Callable[[str], None] = _no_mark) -> torch.Tensor:
    """rank -> scale -> curve key -> sort over `stacked`, the [k, n] int32
    bit-pattern key matrix on the device; `m` is the reference's padded
    row count."""
    scaled = scaled_ranks(stacked, m)
    mark("curve_perm.rank")
    if curve == "hilbert":
        keys = hilbert_key(scaled >> (32 - HILBERT_BITS))
    else:
        # rebind so the int64 ranks are freed before K4 allocates its words
        scaled = to_i32_bits(scaled)
        keys = interleave_bits(scaled, n_bits=32)
    mark("curve_perm.interleave")
    perm = curve_order(keys)
    mark("curve_perm.sort")
    return perm


def zorder_sort_indices(cols: Sequence[np.ndarray], curve: str = "zorder",
                        device="cuda",
                        mark: Optional[Callable[[str], None]] = None,
                        ) -> np.ndarray:
    """Host entry: the row permutation (int64) that clusters rows along
    the curve. `cols` are numpy columns (ints, floats, bools, strings,
    dates, timestamps). It runs on the card unless `device` names the
    CPU, where the plain versions run. `mark` (an `obs.PhaseTimer`) is called at the end
    of each phase: keys (the host mapping to u32), then
    curve_perm.{h2d, rank, interleave (with the Hilbert transform), sort,
    d2h}."""
    mark = mark or _no_mark
    n = len(cols[0])
    if n == 0:
        return np.empty(0, dtype=np.int64)
    m = pad_bucket(n, min_bucket=_MIN_BUCKET)
    stacked = np.empty((len(cols), n), np.uint32)
    for i, c in enumerate(cols):
        stacked[i] = to_sortable_u32(c)
    mark("keys")
    on_dev = torch.from_numpy(stacked.view(np.int32)).to(device)
    mark("curve_perm.h2d")
    perm = _curve_perm(on_dev, m, curve, mark)
    out = perm.cpu().numpy()
    mark("curve_perm.d2h")
    return out


def to_sortable_u32(col: np.ndarray) -> np.ndarray:
    """Map a numpy column to uint32, preserving order (for ranking); the
    reference's `_to_sortable_u32`, value for value."""
    c = np.asarray(col)
    if c.dtype.kind == "f":
        # IEEE-754 total order trick (on float32, as the reference does)
        bits = c.astype(np.float32).view(np.uint32)
        mask = np.where(bits >> 31 == 1, np.uint32(0xFFFFFFFF),
                        np.uint32(0x80000000))
        return bits ^ mask
    if c.dtype.kind == "i":
        c64 = c.astype(np.int64)
        lo, hi = int(c64.min()), int(c64.max())
        if hi - lo < 2**32:
            return (c64 - lo).astype(np.uint32)
        # wide int64 range: a dense host rank preserves the order exactly
        return _host_rank(c64)
    if c.dtype.kind in ("u", "b"):
        return c.astype(np.uint32)
    if c.dtype.kind in ("U", "S", "O"):
        return _host_rank(c)
    if np.issubdtype(c.dtype, np.datetime64):
        return to_sortable_u32(
            c.astype("datetime64[us]").astype(np.int64) // 1000)
    raise ValueError(f"cannot build curve key from dtype {c.dtype}")


def _host_rank(c: np.ndarray) -> np.ndarray:
    order = np.argsort(c, kind="stable")
    ranks = np.empty(len(c), dtype=np.uint32)
    ranks[order] = np.arange(len(c), dtype=np.uint32)
    return ranks

"""Data skipping's keep mask over the resident stats lanes: kernel K7 and
its plain version.

Counterpart of `delta_tpu/ops/skipping.py:65-167`: the jnp function
`_skip_fn_cached` (queue B's B8; not a Pallas kernel) and its numpy twin
`host_skip_mask`. `stats/device_index.py` lays the snapshot's stats out as
int64 lanes `vals` [R, F] with a bool validity `valid` [R, F] (column c
in rows 3c, 3c+1, 3c+2 as min, max, nullCount; numRecords in row R-1). A
scan's conjuncts compile to an `AtomBlock`: one atom per `col op lit`,
OR-alternatives sharing a group. For every file:

    keep = NOT (some group has every atom known false)

An atom is known false for a file only when the stat that decides it is
present and proves that no row can match (op codes: 0 '<', 1 '<=',
2 '>', 3 '>=', 4 '=', 5 '!=', 6 IS NULL, 7 IS NOT NULL; ops 0-5 are also
known false where every row is null, nullCount == numRecords). A group
with no atom never skips; no atom keeps every file.

`skip_mask_block` takes the lanes on the engine's device: on a CUDA
tensor it launches K7 (`csrc/skip_mask.cu`) on the current stream, or
raises; on a CPU tensor it runs `skip_mask_plain`. Both return a bool
tensor over the F files on the lanes' device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.ops import cuda_build

LAUNCHES = obs.counter("kernel.skip_mask.launches")
_LAUNCH = None  # (K7's C entry point, the raw-stream getter), on first use


class AtomBlock(NamedTuple):
    """A compiled conjunct list: flat atom arrays over the lane matrix."""

    rows_mn: np.ndarray  # int32 [A] min-lane row per atom
    rows_mx: np.ndarray  # int32 [A] max-lane row per atom (rows_mn + 1)
    rows_nc: np.ndarray  # int32 [A] nullCount-lane row (rows_mn + 2)
    ops: np.ndarray      # int32 [A] op code (module docstring)
    lits: np.ndarray     # int64 [A] encoded literal (0 for ops 6 and 7)
    grp: np.ndarray      # int32 [A] OR-group, in [0, n_groups)
    n_atoms: int
    n_groups: int


def _check(vals: torch.Tensor, valid: torch.Tensor, block: AtomBlock,
           n_files: int) -> None:
    if vals.dtype != torch.int64 or vals.dim() != 2:
        raise ValueError(f"skip_mask takes int64 [R, F] lanes, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if valid.dtype != torch.bool or valid.shape != vals.shape \
            or valid.device != vals.device:
        raise ValueError("skip_mask: the validity must be bool of the "
                         "lanes' shape, on their device")
    if not 0 <= n_files <= vals.shape[1]:
        raise ValueError(f"skip_mask: {n_files} files over "
                         f"{vals.shape[1]} lane columns")
    rows = vals.shape[0]
    if block.n_atoms and (int(block.rows_mn.min()) < 0
                          or int(block.rows_nc.max()) >= rows - 1
                          or int(block.grp.min()) < 0
                          or int(block.grp.max()) >= block.n_groups):
        raise ValueError("skip_mask: an atom's rows or group lie outside "
                         "the lanes")


def known_false(mn, mx, nc, nr, vmn, vmx, vnc, vnr, ops, lits):
    """Per atom x file "the stats prove that no row matches" [A, F]; every
    input int64 or bool, broadcast to [A, F] (nr, vnr [1, F])."""
    op = ops[:, None]
    lit = lits[:, None]
    all_null = vnc & vnr & (nc == nr)
    w = torch.where
    kf = w(op == 0, vmn & (mn >= lit),
         w(op == 1, vmn & (mn > lit),
         w(op == 2, vmx & (mx <= lit),
         w(op == 3, vmx & (mx < lit),
         w(op == 4, (vmn & (mn > lit)) | (vmx & (mx < lit)),
         w(op == 5, vmn & vmx & (mn == lit) & (mx == lit),
         w(op == 6, vnc & (nc == 0),
           vnc & vnr & (nc == nr))))))))
    return kf | ((op <= 5) & all_null)


def skip_mask_plain(vals: torch.Tensor, valid: torch.Tensor,
                    block: AtomBlock, n_files: int) -> torch.Tensor:
    """K7's function in plain PyTorch: bool [n_files] on the lanes'
    device."""
    _check(vals, valid, block, n_files)
    dev = vals.device
    keep = torch.ones(n_files, dtype=torch.bool, device=dev)
    if block.n_atoms == 0 or n_files == 0:
        return keep
    vals, valid = vals[:, :n_files], valid[:, :n_files]

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    rmn, rmx, rnc = (t(block.rows_mn, torch.int64),
                     t(block.rows_mx, torch.int64),
                     t(block.rows_nc, torch.int64))
    kf = known_false(vals[rmn], vals[rmx], vals[rnc], vals[-1:],
                     valid[rmn], valid[rmx], valid[rnc], valid[-1:],
                     t(block.ops, torch.int64), t(block.lits, torch.int64))
    # the group fold: a group skips a file where all its atoms are known
    # false (a count of known-false atoms equal to the group's size)
    grp = t(block.grp, torch.int64)
    sizes = torch.bincount(grp, minlength=block.n_groups)
    hits = torch.zeros(block.n_groups, n_files, dtype=torch.int64,
                       device=dev)
    hits.index_add_(0, grp, kf.to(torch.int64))
    skip = (hits == sizes[:, None]) & (sizes > 0)[:, None]
    return keep & ~skip.any(dim=0)


def _atom_buffer(block: AtomBlock) -> np.ndarray:
    """The atoms sorted by group (stably) as one int64 buffer: rows [A],
    ops [A], literals [A], group offsets [G + 1]."""
    order = np.argsort(block.grp, kind="stable")
    grp = block.grp[order]
    offs = np.searchsorted(grp, np.arange(block.n_groups + 1), side="left")
    return np.concatenate([
        block.rows_mn[order].astype(np.int64),
        block.ops[order].astype(np.int64),
        block.lits[order].astype(np.int64), offs.astype(np.int64)])


def skip_mask_block(vals: torch.Tensor, valid: torch.Tensor,
                    block: AtomBlock, n_files: int) -> torch.Tensor:
    """The keep mask (bool [n_files], on the lanes' device) of `block`
    over the lanes. A CPU tensor takes the plain version; a CUDA tensor
    launches K7 (one upload of the atoms, one kernel, no synchronization),
    or raises."""
    global _LAUNCH
    _check(vals, valid, block, n_files)
    if vals.device.type == "cpu":
        return skip_mask_plain(vals, valid, block, n_files)
    if vals.device.type != "cuda":
        raise ValueError(f"skip_mask: unsupported device {vals.device}")
    index = vals.get_device()
    keep = torch.empty(n_files, dtype=torch.bool, device=index)
    if n_files == 0:
        return keep
    if not vals.is_contiguous():
        vals = vals.contiguous()
    if not valid.is_contiguous():
        valid = valid.contiguous()
    # pinned, so that the upload is queued behind earlier work instead of
    # waiting for it (a copy from pageable memory synchronizes the stream)
    atoms = torch.from_numpy(_atom_buffer(block)).pin_memory().to(
        index, non_blocking=True)
    if _LAUNCH is None:
        _LAUNCH = (cuda_build.function(
            "skip_mask", "skip_mask_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]),
            torch._C._cuda_getCurrentRawStream)
    launch, raw_stream = _LAUNCH
    code = launch(vals.data_ptr(), valid.data_ptr(), vals.shape[0],
                  vals.shape[1], n_files, atoms.data_ptr(), block.n_atoms,
                  block.n_groups, keep.data_ptr(), index, raw_stream(index))
    cuda_build.check_launch(code, "skip_mask")
    LAUNCHES.inc()
    return keep

"""Exact code spaces of the replay key, kept with a state so that later
commits can be coded into them.

A load codes each file action's replay key `(path, dv)` as two dense
integer lanes (`FileActions.path_code`, `.dv_code`), and the numbering is
the load's own: `torch.unique` inverse indices over raw path bytes, dense
ranks of percent-decoded strings, the checkpoint handoff's dictionary. A
delta's code 17 and the prior state's code 17 name different files, so
`Snapshot.update()` codes the delta's keys into the prior's space through
a `KeySpace`:

- paths: one row per distinct decoded path, `[length, w0, w1, ...]` with
  the path's UTF-8 bytes as int64 words (zero-padded), sorted in the
  lexicographic order of the signed columns, and each row's code; built
  on first use, on the lanes' device;
- deletion vectors: a host dict from unique id to code (None is 0).

`lookup` finds query rows by a vectorized binary search on the device and
then compares whole rows, so two keys share a code exactly when their
decoded bytes (and lengths) are equal; no hash decides. `merged` inserts
new rows at their search positions without a sort; `absorb` codes another
load's lanes into this space and returns the space grown by its new keys.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def key_rows(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """uint8 [n, width] zero-padded path bytes (width a multiple of 8) and
    int64 [n] lengths -> int64 [n, 1 + width / 8] key rows."""
    if mat.shape[0] == 0:  # an empty array may carry any strides
        return torch.zeros((0, 1 + mat.shape[1] // 8), dtype=torch.int64,
                           device=mat.device)
    words = mat.contiguous().view(torch.int64)
    return torch.cat([lens.to(torch.int64)[:, None], words], 1)


def string_rows(strings: List[str], device) -> torch.Tensor:
    """Key rows of Python strings (their UTF-8 bytes), on `device`."""
    from delta_tpu_torch.log.parquet_host import Strings

    mat, lens = Strings.from_list(strings).matrix()
    return key_rows(torch.from_numpy(mat), torch.from_numpy(lens)).to(device)


def _pad(rows: torch.Tensor, cols: int) -> torch.Tensor:
    if rows.shape[1] >= cols:
        return rows
    return torch.nn.functional.pad(rows, (0, cols - rows.shape[1]))


def lexsort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts int64 [n, c] rows lexicographically (column
    0 first): one stable sort per column, the last column first."""
    perm = torch.arange(rows.shape[0], device=rows.device)
    for c in range(rows.shape[1] - 1, -1, -1):
        perm = perm[torch.argsort(rows[perm, c], stable=True)]
    return perm


def _row_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[i] < b[i] in the lexicographic order of signed columns."""
    diff = a != b
    first = diff.to(torch.int8).argmax(1, keepdim=True)
    return diff.any(1) & (a.gather(1, first) < b.gather(1, first)).squeeze(1)


def lower_bound(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """For each query row, the first index of sorted `rows` whose row is
    not less than it (`rows.shape[0]` when none): a binary search of
    ceil(log2(u + 1)) steps, all queries at once, with no host sync."""
    u = rows.shape[0]
    m = queries.shape[0]
    lo = torch.zeros(m, dtype=torch.int64, device=queries.device)
    hi = torch.full((m,), u, dtype=torch.int64, device=queries.device)
    if u == 0 or m == 0:
        return lo
    for _ in range(u.bit_length()):
        mid = (lo + hi) // 2
        active = lo < hi
        less = _row_less(rows[mid.clamp(max=u - 1)], queries)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


class KeySpace:
    """A state's path and deletion-vector code spaces (module docstring).
    `n_codes` is one past the largest path code in use."""

    def __init__(self, source: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
                 n_codes: int, dv_ids: Optional[Dict] = None):
        self._source = source  # () -> (distinct key rows, their codes)
        self._rows: Optional[torch.Tensor] = None
        self._codes: Optional[torch.Tensor] = None
        self.n_codes = n_codes
        self.dv_ids: Dict = dict(dv_ids) if dv_ids else {None: 0}

    @classmethod
    def of_rows(cls, rows: torch.Tensor, codes: torch.Tensor, n_codes: int,
                dv_ids: Optional[Dict] = None) -> "KeySpace":
        return cls(lambda: (rows, codes), n_codes, dv_ids)

    @classmethod
    def of_strings(cls, paths: List[str], device,
                   dv_ids: Optional[Dict] = None) -> "KeySpace":
        """Distinct decoded paths, path i holding code i."""
        def source():
            return (string_rows(paths, device),
                    torch.arange(len(paths), dtype=torch.int64,
                                 device=device))
        return cls(source, len(paths), dv_ids)

    def sorted(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows sorted, their codes), built on first use."""
        if self._rows is None:
            rows, codes = self._source()
            perm = lexsort_rows(rows)
            self._rows, self._codes = rows[perm], codes[perm]
            self._source = None
        return self._rows, self._codes

    def lookup(self, queries: torch.Tensor):
        """(lower-bound positions, hit mask, codes where hit) of int64 key
        rows `queries`, each compared whole against this space's rows."""
        rows, codes = self.sorted()
        cols = max(rows.shape[1], queries.shape[1])
        rows, queries = _pad(rows, cols), _pad(queries, cols)
        pos = lower_bound(rows, queries)
        if rows.shape[0] == 0:
            hit = torch.zeros(queries.shape[0], dtype=torch.bool,
                              device=queries.device)
            return pos, hit, torch.zeros_like(pos)
        at = pos.clamp(max=rows.shape[0] - 1)
        hit = (pos < rows.shape[0]) & (rows[at] == queries).all(1)
        return pos, hit, codes[at]

    def merged(self, new_rows: torch.Tensor, new_codes: torch.Tensor,
               pos: torch.Tensor, dv_ids: Dict) -> "KeySpace":
        """This space with `new_rows` (sorted, distinct, absent here; `pos`
        their lower bounds here, non-decreasing) holding `new_codes`, and
        the deletion-vector table `dv_ids`."""
        rows, codes = self.sorted()
        k = new_rows.shape[0]
        out = KeySpace(None, self.n_codes + k, dv_ids)
        if k:
            cols = max(rows.shape[1], new_rows.shape[1])
            rows, new_rows = _pad(rows, cols), _pad(new_rows, cols)
            u = rows.shape[0]
            dev = rows.device
            old = torch.arange(u, device=dev)
            at_old = old + torch.searchsorted(pos, old, right=True)
            at_new = pos + torch.arange(k, device=dev)
            out_rows = torch.empty((u + k, cols), dtype=torch.int64,
                                   device=dev)
            out_codes = torch.empty(u + k, dtype=torch.int64, device=dev)
            out_rows[at_old], out_rows[at_new] = rows, new_rows
            out_codes[at_old], out_codes[at_new] = codes, new_codes
            rows, codes = out_rows, out_codes
        out._rows, out._codes = rows, codes
        return out

    def absorb(self, other: "KeySpace", path_code: torch.Tensor,
               dv_code: torch.Tensor):
        """Code lanes numbered in `other`'s space into this one: returns
        (path codes, deletion-vector codes, this space grown by `other`'s
        keys that are new here, numbered from `n_codes` on)."""
        rows, codes = other.sorted()
        dev = rows.device
        pos, hit, found = self.lookup(rows)
        new = ~hit
        mapped = torch.where(hit, found, self.n_codes
                             + torch.cumsum(new.to(torch.int64), 0) - 1)
        table = torch.zeros(max(other.n_codes, 1), dtype=torch.int64,
                            device=dev)
        table[codes] = mapped
        dv_ids = dict(self.dv_ids)
        dv_table = np.zeros(max(other.dv_ids.values()) + 1, np.int64)
        for dv, c in other.dv_ids.items():
            dv_table[c] = dv_ids.setdefault(dv, len(dv_ids))
        grown = self.merged(rows[new], mapped[new], pos[new], dv_ids)
        return (table[path_code],
                torch.from_numpy(dv_table).to(dev)[dv_code], grown)

"""The device JSON parse route: commit windows -> replay lanes.

Counterpart of `delta_tpu/replay/device_parse.py`. The commit buffer
splits at commit boundaries into windows of at most `window_bytes` (64 MiB
by default); each window goes to the device as one uint8 lane,
`ops/json_parse.py` extracts its per-line lanes, and the file-action rows
become `FileActions` lanes that stay on the device.

Fallback ladder, as in the JAX package (the device route only answers for
content it parsed exactly; anything else hands the WHOLE buffer to the
host parser, `replay/host_parse.py`):

1. window ineligible (empty, not newline-terminated, >= 2 GiB) -> host;
2. structural balance failed anywhere in the window (odd quote count,
   unbalanced or negative brace depth) -> host;
3. any file-action line is COMPLEX (deletionVector, tags, non-empty
   partitionValues, unknown or duplicate keys, > int64 numerics) -> host;
4. a control line fails json.loads, or is a file action the compact-form
   patterns missed -> host.

Replay keys are exact: each row's path bytes (escapes resolved) are laid
out as one fixed-width row on the device and `torch.unique` over those
rows assigns the codes, with no hash. Percent-encoded paths are decoded
per unique path and re-coded. Stats stay raw spans in the host buffer and
are decoded on first access (the JAX package's lazy stats).

Counters: `parse.device_windows`, `parse.device_fallbacks`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from delta_tpu_torch import obs
from delta_tpu_torch.models.actions import AddFile, RemoveFile, decode_path
from delta_tpu_torch.ops.json_parse import (
    FLAG_NAMES,
    TAIL_PAD,
    parse_lanes,
    window_eligible,
)
from delta_tpu_torch.replay.columnar import FileActions, ParsedCommits
from delta_tpu_torch.replay.host_parse import line_tags
from delta_tpu_torch.replay.keys import KeySpace, key_rows

_OBS_WINDOWS = obs.counter("parse.device_windows")
_OBS_FALLBACKS = obs.counter("parse.device_fallbacks")

DEFAULT_WINDOW_BYTES = 64 << 20

_F = {name: i for i, name in enumerate(FLAG_NAMES)}

# unescape value for the byte FOLLOWING an escape initiator; 0 marks
# 'u' (\uXXXX needs real JSON decoding, handled per row)
_ESC_LUT = np.zeros(256, np.uint8)
for _c, _v in ((34, 34), (92, 92), (47, 47), (98, 8), (102, 12),
               (110, 10), (114, 13), (116, 9)):
    _ESC_LUT[_c] = _v


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    offs = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(offs, lens)


def _unescape_many(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Unescape many raw JSON-string spans at once.

    Returns (arena uint8, offsets int64 [n + 1], exc {row: bytes}): one
    vectorized pass deletes escape-initiator backslashes and maps the
    following byte through `_ESC_LUT`; rows holding \\uXXXX land in `exc`
    (decoded per row, possibly multi-byte UTF-8) and their arena slice is
    garbage the caller must override."""
    n = len(lens)
    total = int(lens.sum())
    src = np.repeat(starts, lens) + _ragged_arange(lens)
    raw = buf[src]
    row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
    bs = raw == 92
    prev_bs = np.zeros_like(bs)
    prev_bs[1:] = bs[:-1]
    run_start = bs & ~prev_bs
    pos = np.arange(total, dtype=np.int64)
    # a span never ends with an unpaired backslash (it would have escaped
    # its closing quote), so backslash-run parity over the concatenation
    # equals per-row parity
    last_rs = np.maximum.accumulate(np.where(run_start, pos, -1))
    initiator = bs & (((pos - last_rs) & 1) == 0)
    follows = np.zeros_like(initiator)
    follows[1:] = initiator[:-1]
    mapped = np.where(follows, _ESC_LUT[raw], raw)
    keep = ~initiator
    out = mapped[keep]
    out_lens = np.bincount(row_of[keep], minlength=n).astype(np.int64)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(out_lens, out=offs[1:])
    exc = {}
    u_rows = follows & (raw == 117)
    if bool(u_rows.any()):
        for r in np.unique(row_of[u_rows]).tolist():
            s = int(starts[r])
            span = buf[s:s + int(lens[r])].tobytes()
            exc[int(r)] = json.loads(b'"' + span + b'"').encode("utf-8")
    return out, offs, exc


def _unescaped_bytes(buf: np.ndarray, starts: np.ndarray,
                     lens: np.ndarray) -> List[bytes]:
    """Unescaped bytes of each span."""
    arena, offs, exc = _unescape_many(buf, starts, lens)
    return [exc[r] if r in exc else arena[offs[r]:offs[r + 1]].tobytes()
            for r in range(len(lens))]


def decode_spans(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                 present: np.ndarray, esc: np.ndarray) -> List[Optional[str]]:
    """String values of raw JSON-string spans of `buf`: None where absent,
    escaped spans unescaped in one vectorized pass."""
    out: List[Optional[str]] = [None] * len(starts)
    raw_rows = np.flatnonzero(present & ~esc)
    for r, s, e in zip(raw_rows.tolist(), starts[raw_rows].tolist(),
                       ends[raw_rows].tolist()):
        out[r] = buf[s:e].tobytes().decode("utf-8")
    esc_rows = np.flatnonzero(present & esc)
    if len(esc_rows):
        vals = _unescaped_bytes(buf, starts[esc_rows],
                                ends[esc_rows] - starts[esc_rows])
        for r, v in zip(esc_rows.tolist(), vals):
            out[r] = v.decode("utf-8")
    return out


# host lanes of the file-action rows, kept for materialization: the
# string spans, and the values that AddFile / RemoveFile take from them
_SPAN_LANES = ("path_start", "path_end", "path_esc", "stats_start",
               "stats_end", "stats_esc", "stats_present")
_VALUE_LANES = ("size", "size_present", "mod_time", "mod_time_present",
                "data_change_val", "data_change_present", "del_ts",
                "del_ts_present", "ext_meta_val", "ext_meta_present",
                "pv_present")
_HOST_LANES = _SPAN_LANES + _VALUE_LANES


class SpanRows:
    """Host row store of the device route: spans into the commit buffer
    and the parsed numeric/boolean lanes of every file-action row.
    Materialized the way the JAX package's canonical table is (absent
    dataChange reads False; a simple line's partitionValues is {} on an
    add and None on a remove)."""

    def __init__(self, buf: np.ndarray, lanes: dict):
        self.buf = buf
        self.lanes = lanes

    def strings(self, idx: np.ndarray, key: str, present) -> List[Optional[str]]:
        a = self.lanes
        return decode_spans(self.buf, a[f"{key}_start"][idx],
                            a[f"{key}_end"][idx], present,
                            a[f"{key}_esc"][idx])

    def paths(self, idx: np.ndarray) -> List[str]:
        """Unescaped, percent-decoded paths of rows `idx`."""
        return [decode_path(p) for p in
                self.strings(idx, "path", np.ones(len(idx), bool))]

    def stats(self, idx: np.ndarray) -> List[Optional[str]]:
        return self.strings(idx, "stats", self.lanes["stats_present"][idx])

    def refs(self, idx: np.ndarray) -> tuple:
        """(paths, deletion timestamps, DV descriptors) of rows `idx`; a
        line of this route holds no deletion vector."""
        a = self.lanes
        stamps = [t if ok else None for t, ok in zip(
            a["del_ts"][idx].tolist(), a["del_ts_present"][idx].tolist())]
        return self.paths(idx), stamps, [None] * len(idx)

    def _common(self, idx):
        a = self.lanes
        stats = self.strings(idx, "stats", a["stats_present"][idx])
        cols = {k: a[k][idx].tolist() for k in _VALUE_LANES}
        return self.paths(idx), stats, cols

    def add_files(self, idx: np.ndarray) -> List[AddFile]:
        paths, stats, c = self._common(idx)
        return [AddFile(
            path=paths[j],
            partitionValues={},
            size=c["size"][j] if c["size_present"][j] else 0,
            modificationTime=(c["mod_time"][j] if c["mod_time_present"][j]
                              else 0),
            dataChange=bool(c["data_change_present"][j]
                            and c["data_change_val"][j]),
            stats=stats[j],
        ) for j in range(len(idx))]

    def remove_files(self, idx: np.ndarray) -> List[RemoveFile]:
        paths, stats, c = self._common(idx)
        return [RemoveFile(
            path=paths[j],
            deletionTimestamp=(c["del_ts"][j] if c["del_ts_present"][j]
                               else None),
            dataChange=bool(c["data_change_present"][j]
                            and c["data_change_val"][j]),
            extendedFileMetadata=(bool(c["ext_meta_val"][j])
                                  if c["ext_meta_present"][j] else None),
            size=c["size"][j] if c["size_present"][j] else None,
            stats=stats[j],
        ) for j in range(len(idx))]


@dataclass
class _Window:
    """One window's file-action rows, before the merge."""

    is_add: torch.Tensor
    version: torch.Tensor
    order: torch.Tensor
    size: torch.Tensor
    path_bytes: torch.Tensor  # uint8 [rows, width], zero past each length
    path_len: torch.Tensor    # int64 [rows]
    has_percent: bool
    host: dict                # _HOST_LANES, numpy, offsets global
    others: list


def _path_matrix(bx: torch.Tensor, n: int, start: torch.Tensor,
                 length: torch.Tensor, win: np.ndarray,
                 esc: torch.Tensor):
    """Each row's path bytes, escapes resolved, as one zero-padded row of
    a uint8 [rows, width] matrix (width a multiple of 8); with the
    lengths, equal rows are exactly equal paths."""
    dev = bx.device
    rows = start.shape[0]
    width = max(8, -(-int(length.max()) // 8) * 8) if rows else 8
    cols = torch.arange(width, device=dev)
    idx = (start[:, None] + cols[None, :]).clamp_(max=n - 1)
    mat = torch.where(cols[None, :] < length[:, None], bx[idx], 0)
    del idx
    er = torch.nonzero(esc).squeeze(1)
    if er.numel():
        # escaped paths (rare): unescape on the host, patch the rows in
        vals = _unescaped_bytes(win, start[er].cpu().numpy(),
                                length[er].cpu().numpy())
        fix = np.zeros((len(vals), width), np.uint8)
        for j, v in enumerate(vals):
            fix[j, :len(v)] = np.frombuffer(v, np.uint8)
        mat[er] = torch.from_numpy(fix).to(dev)
        length = length.clone()
        length[er] = torch.tensor([len(v) for v in vals], dtype=torch.int64,
                                  device=dev)
    return mat, length


def _parse_one_window(buf: np.ndarray, base: int, file_starts: np.ndarray,
                      file_versions: np.ndarray, device) -> Optional[_Window]:
    """One window's device parse; None hands the buffer to the host."""
    n = int(file_starts[-1])
    win = buf[base:base + n]
    if not window_eligible(n) or win[-1] != 10:
        return None
    n_lines = int(np.count_nonzero(win == 10))
    bx = torch.full((n + TAIL_PAD,), 0x20, dtype=torch.uint8, device=device)
    bx[:n].copy_(torch.from_numpy(win))
    vals, spans, flags, window_ok = parse_lanes(bx, n, n_lines)
    if not bool(window_ok):
        return None
    vals, spans, flags = (vals[:, :n_lines], spans[:, :n_lines],
                          flags[:, :n_lines])
    filerow = flags[_F["is_add"]] | flags[_F["is_remove"]]
    if bool((flags[_F["complex"]] & filerow).any()):
        return None

    line_start = spans[0].to(torch.int64)
    versions, orders = line_tags(
        line_start, torch.from_numpy(file_starts).to(device),
        torch.from_numpy(file_versions).to(device))

    others = []
    ctrl = torch.nonzero(~filerow & (spans[1] > spans[0])).squeeze(1)
    if ctrl.numel():
        cs, ce = spans[0][ctrl].tolist(), spans[1][ctrl].tolist()
        cv, co = versions[ctrl].tolist(), orders[ctrl].tolist()
        for s, e, v, o in zip(cs, ce, cv, co):
            try:
                row = json.loads(win[s:e].tobytes())
            except ValueError:
                return None  # malformed control line: the host path raises
            if not isinstance(row, dict) or "add" in row or "remove" in row:
                # a file action the compact-form patterns missed
                return None
            others.append((v, o, row))

    rows = torch.nonzero(filerow).squeeze(1)
    f = {name: flags[i][rows] for i, name in enumerate(FLAG_NAMES)}
    v = vals[:, rows]
    sp = spans[:, rows]
    path_start = sp[2].to(torch.int64)
    path_len = sp[3].to(torch.int64) - path_start
    path_bytes, path_len = _path_matrix(bx, n, path_start, path_len, win,
                                        f["path_esc"])
    has_percent = bool((path_bytes == 37).any())
    size = torch.where(f["size_present"], v[0], 0)

    lanes = {
        "path_start": sp[2], "path_end": sp[3], "path_esc": f["path_esc"],
        "stats_start": sp[4], "stats_end": sp[5],
        "stats_esc": f["stats_esc"], "stats_present": f["stats_present"],
        "size": v[0], "mod_time": v[1], "del_ts": v[2],
    }
    for k in _HOST_LANES:
        if k not in lanes:
            lanes[k] = f[k]
    host = {k: t.cpu().numpy() for k, t in lanes.items()}
    for k in ("path_start", "path_end", "stats_start", "stats_end"):
        host[k] = host[k].astype(np.int64) + base
    return _Window(
        is_add=f["is_add"], version=versions[rows], order=orders[rows],
        size=size, path_bytes=path_bytes, path_len=path_len,
        has_percent=has_percent, host=host, others=others)


def path_codes(windows, paths_of, device):
    """Exact dictionary codes of the decoded paths of all rows of
    `windows` (in order), and their `KeySpace` (`replay/keys.py`): each
    window has `path_bytes` (uint8 [rows, width], zero past each length),
    `path_len` and `has_percent`. One `torch.unique` over the byte rows
    and lengths codes the raw paths; when any raw path holds a '%',
    `paths_of(row indices, ascending)` gives the decoded paths of one row
    per raw path, and those are coded."""
    if sum(int(w.path_len.shape[0]) for w in windows) == 0:
        return (torch.zeros(0, dtype=torch.int64, device=device),
                KeySpace.of_strings([], device))
    width = max(w.path_bytes.shape[1] for w in windows)
    mats = [torch.nn.functional.pad(w.path_bytes,
                                    (0, width - w.path_bytes.shape[1]))
            for w in windows]
    keys = key_rows(torch.cat(mats), torch.cat([w.path_len for w in windows]))
    del mats
    uniq, codes = torch.unique(keys, dim=0, return_inverse=True)
    u = uniq.shape[0]
    if not any(w.has_percent for w in windows):
        # no '%': each raw path is its decoded path
        return codes, KeySpace.of_rows(
            uniq, torch.arange(u, dtype=torch.int64, device=device), u)
    # percent-decoding may map two raw spellings to one path: decode each
    # unique raw path once and code the decoded strings
    n = codes.shape[0]
    first = torch.full((u,), n, dtype=torch.int64, device=device) \
        .scatter_reduce_(0, codes, torch.arange(n, device=device), "amin")
    # the row stores serve rows in ascending order: ask in that order,
    # then put each path back at its raw key's slot
    first = first.cpu().numpy()
    asc = np.argsort(first)
    paths = np.empty(u, object)
    paths[asc] = paths_of(first[asc])
    decoded: dict = {}
    remap = np.fromiter((decoded.setdefault(p, len(decoded)) for p in paths),
                        np.int64, u)
    return (torch.from_numpy(remap).to(device)[codes],
            KeySpace.of_strings(list(decoded), device))


def parse_commits_device(buf, file_starts: np.ndarray,
                         file_versions: np.ndarray, device,
                         window_bytes: int = DEFAULT_WINDOW_BYTES,
                         ) -> Optional[ParsedCommits]:
    """Device parse of one concatenated commit buffer, split at commit
    boundaries into windows of at most `window_bytes` (a single commit
    larger than that is one window of its own). None sends the whole
    buffer to the host parser."""
    n_files = len(file_versions)
    if n_files == 0:
        return None
    arr = np.frombuffer(buf, np.uint8)
    cap = max(1, window_bytes)
    windows: List[_Window] = []
    lo = 0
    while lo < n_files:
        hi = lo + 1
        while (hi < n_files
               and int(file_starts[hi + 1] - file_starts[lo]) <= cap):
            hi += 1
        base = int(file_starts[lo])
        w = _parse_one_window(arr, base, file_starts[lo:hi + 1] - base,
                              file_versions[lo:hi], device)
        if w is None:
            _OBS_FALLBACKS.inc()
            return None
        _OBS_WINDOWS.inc()
        windows.append(w)
        lo = hi
    store = SpanRows(arr, {k: np.concatenate([w.host[k] for w in windows])
                           for k in _HOST_LANES})
    n = sum(int(w.is_add.shape[0]) for w in windows)
    codes, keys = path_codes(windows, store.paths, device)
    fa = FileActions(
        is_add=torch.cat([w.is_add for w in windows]),
        version=torch.cat([w.version for w in windows]),
        order=torch.cat([w.order for w in windows]),
        size=torch.cat([w.size for w in windows]),
        path_code=codes,
        dv_code=torch.zeros(n, dtype=torch.int64, device=device),
        rows=store,
        keys=keys,
    )
    return ParsedCommits(file_actions=fa,
                         others=[r for w in windows for r in w.others],
                         path_keys=windows)

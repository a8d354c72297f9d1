"""Field extraction from a commit window, in PyTorch ops on the device.

Counterpart of `delta_tpu/ops/json_parse.py::_parse_fn_cached`. One
newline-terminated window of commit bytes lies on the device as one uint8
lane, and one data-parallel pass extracts the replay-critical fields of
every *simple* add/remove line:

- structural scan: the byte classes come from kernel K1
  (`ops/byte_class.py`); newline rank by cumsum, backslash-run parity for
  escape initiators from the latest run start (a running max, taken as a
  cumsum and a gather), in-string parity from the unescaped quotes, brace
  depth;
- key matches: shifted byte compares locate the known depth-2 keys and the
  `{"add":` / `{"remove":` line tags;
- per-line reductions by `index_add_` (sums) and `scatter_reduce_` (mins);
- string spans resolve their closing quote through a quote-rank table;
  numerics parse with an unrolled Horner loop in int64.

A line is SIMPLE when its depth-2 colons are all explained by matched known
keys, it has no colon at depth >= 3 (deletionVector, tags, non-empty
partitionValues) and every matched value validates. The lanes and
`window_ok` follow the JAX function's contract exactly: the tests hold
every lane against it, on the same padded bytes.
"""

from __future__ import annotations

import torch

from delta_tpu_torch.ops.byte_class import byte_class

# Span lanes are int32: every byte offset of a window stays below 2^31.
MAX_WINDOW_BYTES = (1 << 31) - 1

_PAT_ADD = b'{"add":{'
_PAT_REMOVE = b'{"remove":{'

# Known depth-2 keys of simple add/remove actions. kind: str -> quoted
# span; int -> int64 numeric; bool -> true/false literal; empty -> '{}'.
KEY_PATTERNS = (
    ("path", b'"path":"', "str"),
    ("stats", b'"stats":"', "str"),
    ("size", b'"size":', "int"),
    ("mod_time", b'"modificationTime":', "int"),
    ("del_ts", b'"deletionTimestamp":', "int"),
    ("data_change", b'"dataChange":', "bool"),
    ("ext_meta", b'"extendedFileMetadata":', "bool"),
    ("pv_empty", b'"partitionValues":{}', "empty"),
)
_STR_KEYS = tuple(i for i, p in enumerate(KEY_PATTERNS) if p[2] == "str")
_INT_KEYS = tuple(i for i, p in enumerate(KEY_PATTERNS) if p[2] == "int")
_BOOL_KEYS = tuple(i for i, p in enumerate(KEY_PATTERNS) if p[2] == "bool")

TAIL_PAD = 32  # > longest pattern; keeps shifted compares off the edge
_MAX_INT_DIGITS = 18  # int64-safe; 19+ digit values make the line complex
_INT32_MAX = (1 << 31) - 1

FLAG_NAMES = (
    "is_add", "is_remove", "complex",
    "path_esc", "stats_esc", "stats_present",
    "size_present", "mod_time_present", "del_ts_present",
    "data_change_present", "data_change_val",
    "ext_meta_present", "ext_meta_val",
    "pv_present",
)
SPAN_NAMES = ("line_start", "line_end",
              "path_start", "path_end", "stats_start", "stats_end")
VAL_NAMES = ("size_val", "mod_time_val", "del_ts_val")


def window_eligible(nbytes: int) -> bool:
    """int32-span guard: offsets in a window must fit in int32."""
    return 0 < nbytes < MAX_WINDOW_BYTES


def _shift_in(m: torch.Tensor) -> torch.Tensor:
    """Previous-byte view of a mask (False shifted in at position 0)."""
    out = torch.empty_like(m)
    out[0] = False
    out[1:] = m[:-1]
    return out


def parse_lanes(bx: torch.Tensor, n: int, n_lines: int,
                n_segments: int | None = None):
    """Field lanes of one window.

    `bx`: uint8 [n + TAIL_PAD], the window's n bytes then 0x20 padding
    (the padding joins the discarded tail line and matches no pattern).
    `n_lines`: the number of newlines in the window. `n_segments`: lanes
    per output row, at least n_lines + 1 (the default).

    Returns (vals int64 [3, L], spans int32 [6, L], flags bool [14, L],
    window_ok 0-d bool tensor), rows in VAL_NAMES / SPAN_NAMES /
    FLAG_NAMES order; columns past n_lines are not meaningful.
    """
    L = n_lines + 1 if n_segments is None else n_segments
    if L < n_lines + 1 or bx.numel() != n + TAIL_PAD:
        raise ValueError(f"parse_lanes: need n_segments > n_lines and "
                         f"n + {TAIL_PAD} bytes, got {L}, {n_lines}, "
                         f"{bx.numel()} for n={n}")
    dev = bx.device
    i32, i64 = torch.int32, torch.int64
    big = n
    pos = torch.arange(n, dtype=i32, device=dev)

    cls = byte_class(bx[:n])
    nl = (cls & 1) != 0
    quote = (cls & 2) != 0
    bs = (cls & 4) != 0
    colon = (cls & 8) != 0
    lb = (cls & 16) != 0
    rb = (cls & 32) != 0
    del cls

    nli = nl.to(i32)
    line_id = (torch.cumsum(nli, 0, dtype=i32) - nli).to(i64)
    del nli
    # the k-th newline (0-based) ends line k and starts line k + 1
    nl_pos = pos[nl]
    line_start = torch.zeros(L, dtype=i32, device=dev)
    k = min(nl_pos.numel(), L - 1)
    line_start[1:1 + k] = nl_pos[:k] + 1
    line_end = torch.full((L,), n, dtype=i32, device=dev)
    k = min(nl_pos.numel(), L)
    line_end[:k] = nl_pos[:k]
    del nl_pos

    # escape initiators: a backslash at even offset within its run. The
    # position of the latest run start is a running max; run starts come
    # in increasing order, so it is the k-th start's position where k is
    # the running count of starts (torch.cummax's 1-D scan measured ~150
    # ms per 64 MiB window on an H100; cumsum + gather is the same value)
    run_start = bs & ~_shift_in(bs)
    rs_count = torch.cumsum(run_start.to(i32), 0, dtype=i32)
    rs_pos = torch.cat([pos.new_full((1,), -1), pos[run_start]])
    last_rs = rs_pos[rs_count.to(i64)]
    del run_start, rs_count, rs_pos
    initiator = bs & (((pos - last_rs) & 1) == 0)
    del last_rs
    uq = quote & ~_shift_in(initiator)  # structurally active quote
    del initiator, quote
    uqi = uq.to(i32)
    q_cum = torch.cumsum(uqi, 0, dtype=i32)
    outside = ((q_cum - uqi) & 1) == 0  # even quote parity before
    del uqi

    depth = torch.cumsum((lb & outside).to(i32) - (rb & outside).to(i32), 0,
                         dtype=i32)
    del lb, rb
    s_colon = colon & outside
    del colon

    def seg_sum(m):
        return torch.zeros(L, dtype=i32, device=dev).index_add_(
            0, line_id, m.to(i32))

    def seg_min(v):
        return torch.full((L,), _INT32_MAX, dtype=i32, device=dev) \
            .scatter_reduce_(0, line_id, v, "amin")

    n_c1 = seg_sum(s_colon & (depth == 1))
    n_c2 = seg_sum(s_colon & (depth == 2))
    n_c3 = seg_sum(s_colon & (depth >= 3))
    del s_colon
    n_quotes = seg_sum(uq)
    depth_end = torch.zeros(L, dtype=i32, device=dev)
    d_nl = depth[nl]
    k = min(d_nl.numel(), L)
    depth_end[:k] = d_nl[:k]
    del d_nl
    depth_min = seg_min(depth)

    # rank -> position of each active quote (closing-quote lookup)
    pos_by_rank = torch.full((n + 1,), n, dtype=i32, device=dev)
    pos_by_rank[(q_cum[uq] - 1).to(i64)] = pos[uq]
    bs_cum = torch.cumsum(bs.to(i32), 0, dtype=i32)
    del bs

    at_ls = _shift_in(nl)
    at_ls[0] = True
    del nl

    def match(pat: bytes):
        acc = bx[0:n] == pat[0]
        for j in range(1, len(pat)):
            acc &= bx[j:j + n] == pat[j]
        return acc

    is_add = seg_sum(match(_PAT_ADD) & at_ls) > 0
    is_rem = seg_sum(match(_PAT_REMOVE) & at_ls) > 0
    del at_ls
    filerow = is_add | is_rem

    key_ok = uq & outside & (depth == 2)
    del uq, outside, depth
    counts, mpos = [], []
    for _name, pat, _kind in KEY_PATTERNS:
        m = match(pat) & key_ok
        counts.append(seg_sum(m))
        mpos.append(seg_min(torch.where(m, pos, big)))
        del m
    del key_ok, pos, line_id

    lim8 = n + TAIL_PAD - 1

    def gather8(idx):
        return bx[idx.clamp(0, lim8).to(i64)]

    def gather32(arr, idx, limit):
        return arr[idx.clamp(0, limit).to(i64)]

    # string spans: [open_quote + 1, closing quote)
    span_start, span_end, span_esc, span_bad = {}, {}, {}, {}
    for i in _STR_KEYS:
        name, pat, _ = KEY_PATTERNS[i]
        present = counts[i] == 1
        o = mpos[i] + (len(pat) - 1)  # value's opening quote
        rank = gather32(q_cum, o, n - 1)
        close = gather32(pos_by_rank, rank, n)
        start = o + 1
        nbs = gather32(bs_cum, close - 1, n - 1) \
            - gather32(bs_cum, start - 1, n - 1)
        span_start[name] = torch.where(present, start, 0)
        span_end[name] = torch.where(present, close, 0)
        span_esc[name] = present & (nbs > 0)
        span_bad[name] = present & ((close >= line_end) | (close <= o))
    del q_cum, pos_by_rank, bs_cum

    # numerics: unrolled Horner over at most _MAX_INT_DIGITS digits
    num_val, num_present, num_bad = {}, {}, {}
    for i in _INT_KEYS:
        name, pat, _ = KEY_PATTERNS[i]
        present = counts[i] == 1
        vs = mpos[i] + len(pat)
        negm = gather8(vs) == 45
        base = vs + negm.to(i32)
        val = torch.zeros(L, dtype=i64, device=dev)
        active = torch.ones(L, dtype=torch.bool, device=dev)
        term_ok = torch.zeros(L, dtype=torch.bool, device=dev)
        ndig = torch.zeros(L, dtype=i32, device=dev)
        for j in range(_MAX_INT_DIGITS + 1):
            ch = gather8(base + j)
            is_d = (ch >= 48) & (ch <= 57)
            take = active & is_d
            val = torch.where(take, val * 10 + (ch.to(i64) - 48), val)
            ndig += take.to(i32)
            stop = active & ~is_d
            term_ok = torch.where(stop, (ch == 44) | (ch == 125), term_ok)
            active &= is_d
        num_val[name] = torch.where(negm, -val, val)
        num_present[name] = present
        # still active after the unroll = too many digits for int64
        num_bad[name] = present & (active | (ndig < 1) | ~term_ok)

    bool_val, bool_present, bool_bad = {}, {}, {}
    for i in _BOOL_KEYS:
        name, pat, _ = KEY_PATTERNS[i]
        present = counts[i] == 1
        ch = gather8(mpos[i] + len(pat))
        bool_val[name] = ch == 116  # 't'
        bool_present[name] = present
        bool_bad[name] = present & (ch != 116) & (ch != 102)  # nor 'f'

    matched = torch.stack(counts).sum(0, dtype=i32)
    dup = (torch.stack(counts) > 1).any(0)
    tail_ch = gather8(line_end - 1)
    any_bad = (span_bad["path"] | span_bad["stats"]
               | num_bad["size"] | num_bad["mod_time"] | num_bad["del_ts"]
               | bool_bad["data_change"] | bool_bad["ext_meta"])
    complex_line = filerow & (
        (n_c1 != 1) | (n_c2 != matched) | (n_c3 > 0) | dup
        | (counts[0] != 1)          # path is mandatory
        | (tail_ch != 125)          # line must close with '}'
        | any_bad)

    valid_line = torch.arange(L, dtype=i32, device=dev) < n_lines
    bal_bad = valid_line & (((n_quotes & 1) != 0)
                            | (depth_end != 0) | (depth_min < 0))
    window_ok = ~bal_bad.any()

    vals = torch.stack([num_val["size"], num_val["mod_time"],
                        num_val["del_ts"]])
    spans = torch.stack([line_start, line_end,
                         span_start["path"], span_end["path"],
                         span_start["stats"], span_end["stats"]])
    flags = torch.stack([
        is_add, is_rem, complex_line,
        span_esc["path"], span_esc["stats"],
        counts[1] == 1,
        num_present["size"], num_present["mod_time"],
        num_present["del_ts"],
        bool_present["data_change"], bool_val["data_change"],
        bool_present["ext_meta"], bool_val["ext_meta"],
        counts[7] == 1,
    ])
    return vals, spans, flags, window_ok

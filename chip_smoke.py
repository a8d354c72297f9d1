#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (`delta_tpu_torch`) once on one card.

    python3 chip_smoke.py [--commits N] [--profile]

1. Prints the card (name, count, `nvidia-smi` name and power limit).
2. Builds every hand-written kernel from `delta_tpu_torch/csrc/` with
   `nvcc` for sm_90a, and the host codec library with `c++`, one compiler
   per source, all at once.
3. Writes the repo's headline log shape (`bench.py`'s `synth_delta_log`:
   100 files per commit, 20% removes, stats on every add; --commits,
   default 10,000, cuts the depth of the benchmark's 100,000) and, with
   the port's `write_checkpoint`, a checkpoint of its state at version
   `commits - 10` (Delta's default interval of 10 commits), split into
   parts as `bench.py` splits them (`part_size = num_files // 8`), with
   every tombstone inside the 7-day retention window.
4. Kernel phase K1/K2: each against its plain PyTorch version on the
   card, at the main path's shapes, exact (`torch.equal`), then timed with
   CUDA events beside its plain version and its bound. K1 is timed on a
   real parse window; K2 on the commit-only load's own sorted replay keys.
5. Commit-only path: the checkpoint files set aside, the log loads with
   `Table.for_path(p, engine=TorchEngine()).latest_snapshot().state`, with
   every counter set to 0 just before. The live files, their size and the
   tombstones must equal the generator's truth; the parse must have run
   on the device with no fallback; K1 and K2 must have launched.
6. Kernel phase K3: `hybrid_extract` against its plain version on the run
   and lane plan of a real part of the headline checkpoint and on edge
   plans (widths 0, 1, 31, 32, shift 0, an RLE value with bit 31 set,
   h_total 1 and 1025, a bit-packed run ending in the lane's last bytes);
   timed on the real plan beside its plain version and its bound.
7. Checkpoint path, the slice's main path: the checkpoint put back, the
   same load runs through it (the checkpoint parts, then the 9 tail
   commits), counters from 0; the truth must hold again, every part must
   have decoded on the device (no fallback), K3 must have launched once
   per part and K1 and K2 at least once. Prints the phase split.
8. Handoff phase: a 200-commit log checkpointed at its head (its path
   dictionaries stay under 1 MiB, so the keys are dictionary-coded) must
   load through the handoff (`decode.handoff_launches` >= 1) to its truth.
9. A small checkpointed log loads on the card and on the CPU (plain
   versions) to equal masks and equal live files.
10. Kernel phase K4: `interleave_bits` against its plain version on the
    card, exact, on the OPTIMIZE cell's own rank matrix ([3, rows],
    n_bits 32: the scaled ranks of k1, k2, k3) and on edge shapes
    (n = 1, 31, 33, 1023, 1025; k = 1..5; n_bits 16 and 32; bit 31 set;
    all-ones rows); timed beside its plain version and its bound.
11. OPTIMIZE path, BASELINE config 4 (`benchmarks/workloads.py:162-203`):
    the port's `write_table` builds a table of 20 appends of 500,000 rows
    (k1, k2, k3 int64 uniform in [0, 2^30), payload float64 normal; 10M
    rows, uncut), then, counters from 0,
    `Table.for_path(p, engine=TorchEngine()).optimize()
    .execute_zorder_by("k1", "k2", "k3")`. The new snapshot must hold 20
    tombstones with dataChange false and ceil(bytes / 256 MiB) live files,
    all with ZCube tags; the rows read back in add order must be the
    input rows (an order-free digest, and a row-by-row match), in
    non-decreasing curve-key order under the keys the plain versions
    compute; K4 must have launched. Prints the phase split, rows/s of the
    command and of `zorder_sort_indices` alone, and peak device memory.
12. A 20,000-row table optimized along both curves on the card and on the
    CPU (plain versions): the same output rows in the same order and the
    same stats.

Prints a metrics line per phase, a `kernels` JSON line, the card's
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` line, and
as the last line `{"ok": true, "device": {...}}`. Any failed phase exits
non-zero and prints no result; so does a run without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor float32 peak, taken as the
                            # integer-operation ceiling (the data sheet gives
                            # no separate integer ALU rate)
WEEK_MS = 7 * 86_400_000    # now_ms that keeps every synthetic tombstone
                            # (deletionTimestamp = its commit index) within
                            # the default 7-day retention


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: warm-up, then `reps` calls
    between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_phase(window: torch.Tensor, n_rows: int, dev) -> dict:
    """Each kernel against its plain version on the card; returns the
    per-kernel numbers of the `kernels` line (launches filled in later)."""
    from delta_tpu_torch.ops.byte_class import byte_class, byte_class_plain
    from delta_tpu_torch.ops.replay import winner_pack, winner_pack_plain

    # K1: a real 64 MiB window, then lengths that are not multiples of 16
    # and a buffer that is not 16-byte aligned
    got = byte_class(window)
    torch.cuda.synchronize()
    want = byte_class_plain(window)
    _check(torch.equal(got, want), "byte_class != plain on the window")
    err1 = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    for n in (1, 15, 17, 4097, 1_000_003):
        x = window[:n]
        _check(torch.equal(byte_class(x), byte_class_plain(x)),
               f"byte_class != plain at n={n}")
        torch.cuda.synchronize()
    x = window[1:1 + 999_999]
    _check(torch.equal(byte_class(x), byte_class_plain(x)),
           "byte_class != plain on an unaligned slice")
    torch.cuda.synchronize()
    n1 = window.numel()
    k1_ms = _time_ms(lambda: byte_class(window), 50)
    k1_plain = _time_ms(lambda: byte_class_plain(window), 10)
    k1_bound, k1_by = _bound_ms(2.0 * n1, 12.0 * n1)

    # K2: the main path's row count with long duplicate runs and a key
    # 0xFFFFFFFF, then n = 1 and 33 (it is timed on the main path's own
    # keys, after the load: `winner_pack_phase`)
    g = torch.Generator(device="cpu").manual_seed(7)
    for n in (n_rows, 1, 33):
        key = torch.randint(0, max(1, n // 64), (n,), generator=g,
                            dtype=torch.int64)
        key[::97] = 0xFFFFFFFF
        skey, sidx = torch.sort(key.to(dev), stable=True)
        sidx = sidx.to(torch.int32)
        _check(torch.equal(winner_pack(skey, sidx, n),
                           winner_pack_plain(skey, sidx, n)),
               f"winner_pack != plain on long runs at n={n}")
        torch.cuda.synchronize()
    return {
        "byte_class": {
            "name": "byte_class", "route": "cuda", "ok": True,
            "source": "delta_tpu_torch/csrc/byte_class.cu",
            "replaces": "delta_tpu/ops/pallas_kernels.py:203",
            "max_abs_err": err1, "ms": k1_ms, "plain_ms": k1_plain,
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
            "shape": f"u8[{n1}]"},
    }


def _winner_pack_bytes(skey: torch.Tensor) -> tuple[float, int]:
    """Bytes K2 must move on these sorted keys, and their winner count.
    Every key is read once; a row's index is read only when the row wins,
    so index bytes are the 32-byte sectors (8 sorted rows each) that hold
    a winner; one 4-byte word is written per 32 rows."""
    n = skey.numel()
    winner = torch.ones(-(-n // 8) * 8, dtype=torch.bool, device=skey.device)
    winner[n:] = False
    winner[:n - 1] = skey[:-1] != skey[1:]
    sectors = int(winner.view(-1, 8).any(1).sum())
    return 8.0 * n + 32.0 * sectors + 4.0 * -(-n // 32), int(winner.sum())


def winner_pack_phase(state) -> dict:
    """K2 against its plain version on the main path's own inputs: the
    replay key of the loaded rows, sorted as the load sorts it; then timed
    beside its plain version and its bound on those inputs."""
    from delta_tpu_torch.ops.replay import (
        chrono_ok, combine_key_lanes, winner_pack, winner_pack_plain)

    fa = state.file_actions
    _check(chrono_ok(fa.version, fa.order), "main-path rows are chronological")
    skey, sidx = torch.sort(combine_key_lanes([fa.path_code, fa.dv_code]),
                            stable=True)
    sidx = sidx.to(torch.int32)
    n = skey.numel()
    got = winner_pack(skey, sidx, n)
    torch.cuda.synchronize()
    want = winner_pack_plain(skey, sidx, n)
    _check(torch.equal(got, want), "winner_pack != plain on the main path")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    ms = _time_ms(lambda: winner_pack(skey, sidx, n), 50)
    plain = _time_ms(lambda: winner_pack_plain(skey, sidx, n), 10)
    nbytes, winners = _winner_pack_bytes(skey)
    bound, by = _bound_ms(nbytes, 2.0 * n)
    return {
        "name": "winner_pack", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/winner_pack.cu",
        "replaces": "delta_tpu/ops/replay.py:183",
        "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": f"i64[{n}]+i32[{n}]", "winners": winners,
        "bound_bytes": nbytes}


def _edge_plans(real_lane: torch.Tensor):
    """(name, lane, runs, h_total) edge cases of K3's plan space."""
    g = np.random.default_rng(11)
    lane = g.integers(0, 256, 4096, dtype=np.uint8)
    plans = []
    for w in (0, 1, 31, 32):
        n = 1025
        plans.append((f"w={w}, shift 0", lane,
                      [(0, n, 0, w, 0, 0)], n))
        plans.append((f"w={w}, shift 5", lane,
                      [(0, 900, 5, w, 0, 0)], 900))
    plans.append(("rle with bit 31 set", lane,
                  [(0, 7, 0, 32, 1, -(1 << 31) + 12345),
                   (7, 9, 8 * 100 + 3, 13, 0, 0)], 16))
    plans.append(("h_total=1", lane, [(0, 1, 17, 9, 0, 0)], 1))
    tail_w, tail_n = 17, 64
    plans.append(("bit-packed run in the last 4 bytes", lane,
                  [(0, 10, 0, 3, 0, 0),
                   (10, tail_n, lane.size * 8 - tail_n * tail_w, tail_w,
                    0, 0)], 10 + tail_n))
    out = [(name, torch.from_numpy(ln), torch.tensor(r, dtype=torch.int32), h)
           for name, ln, r, h in plans]
    return out + [("real lane, h_total=1025", real_lane, None, 1025)]


def hybrid_extract_phase(part_path: str, dev) -> dict:
    """K3 against its plain version on a real part's plan and on edge
    plans; timed on the real plan."""
    from delta_tpu_torch.log.page_decode import (
        _VALUE_COLUMNS, build_part_plan)
    from delta_tpu_torch.log.parquet_footer import read_footer
    from delta_tpu_torch.ops.page_decode import (
        R_N, R_RLE, R_W, hybrid_extract, hybrid_extract_plain)

    with open(part_path, "rb") as f:
        data = f.read()
    footer = read_footer(data)
    # the main path's plan: with tail commits the path keys are not planned
    plan, _, _, _ = build_part_plan(
        footer, data, [c for c in _VALUE_COLUMNS if c in footer.index], [])
    lane = torch.from_numpy(plan.lane).to(dev)
    runs = torch.from_numpy(plan.runs).to(dev)
    h = plan.h_total
    got = hybrid_extract(lane, runs, h)
    torch.cuda.synchronize()
    want = hybrid_extract_plain(lane, runs, h)
    _check(torch.equal(got, want), "hybrid_extract != plain on a real part")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    for name, ln, r, total in _edge_plans(lane):
        ln = ln.to(dev)
        r = runs if r is None else r.to(dev)
        _check(torch.equal(hybrid_extract(ln, r, total),
                           hybrid_extract_plain(ln, r, total)),
               f"hybrid_extract != plain on the edge plan '{name}'")
        torch.cuda.synchronize()
    ms = _time_ms(lambda: hybrid_extract(lane, runs, h), 50)
    plain = _time_ms(lambda: hybrid_extract_plain(lane, runs, h), 10)
    r = plan.runs.astype("int64")
    packed = r[:, R_RLE] == 0
    lane_bytes = int(((r[packed, R_N] * r[packed, R_W] + 7) // 8).sum())
    nbytes = 4.0 * h + lane_bytes + 24.0 * r.shape[0]
    ops = h * (max(1, int(r.shape[0]).bit_length()) + 16.0)
    bound, by = _bound_ms(nbytes, ops)
    return {
        "name": "hybrid_extract", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/hybrid_extract.cu",
        "replaces": "delta_tpu/ops/pallas_kernels.py:357",
        "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": f"u8[{plan.lane.size}]+i32[{r.shape[0]},6]->u32[{h}]",
        "bound_bytes": nbytes}


def _set_aside(log: str, side: str) -> list:
    """Move the checkpoint files of `log` into `side`; returns their
    names (for `_put_back`)."""
    os.makedirs(side, exist_ok=True)
    names = [n for n in os.listdir(log)
             if ".checkpoint." in n or n == "_last_checkpoint"]
    for n in names:
        os.replace(os.path.join(log, n), os.path.join(side, n))
    return names


def _put_back(log: str, side: str, names: list) -> None:
    for n in names:
        os.replace(os.path.join(side, n), os.path.join(log, n))


def _truth_checks(state, truth, what: str) -> str:
    live_paths = sorted(a.path for a in state.add_files)
    sha = hashlib.sha256("\n".join(live_paths).encode()).hexdigest()
    want_sha = hashlib.sha256("\n".join(truth.live_paths).encode()).hexdigest()
    _check(state.version == truth.version, f"{what}: version")
    _check(state.num_files == len(truth.live_paths), f"{what}: num_files")
    _check(state.size_in_bytes == truth.size_in_bytes,
           f"{what}: size_in_bytes")
    _check(sha == want_sha, f"{what}: sha256 of the sorted live paths")
    _check(int(state.tombstone_mask.sum()) == truth.num_tombstones,
           f"{what}: tombstone count")
    return sha


def _timed_load(path: str, Table, TorchEngine, obs, **engine_kw):
    """One load with every counter at 0 just before; returns (state,
    counters, list seconds, load seconds, peak device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    t0 = time.perf_counter()
    snap = Table.for_path(path, engine=TorchEngine(**engine_kw)) \
        .latest_snapshot()
    t_list = time.perf_counter()
    state = snap.state
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    return (state, obs.counters(), t_list - t0, t_end - t0,
            torch.cuda.max_memory_allocated())


def profile_load(path: str, Table, TorchEngine) -> None:
    """Two more loads of the same log, warm: one timed plainly, one under
    torch.profiler for device time by kernel and the device's busy share
    of the load's wall time."""
    from torch.profiler import ProfilerActivity, profile

    def load():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = Table.for_path(path, engine=TorchEngine()).latest_snapshot().state
        torch.cuda.synchronize()
        return time.perf_counter() - t0, st.phase_seconds

    warm_s, warm_phases = load()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_s, _ = load()
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print("profile: " + json.dumps({
        "warm_load_s": warm_s, "warm_phase_s": warm_phases,
        "traced_load_s": traced_s, "device_busy_s": busy_s,
        "device_busy_share": busy_s / traced_s,
        "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3}
                for us, k, c in rows[:15]]}), flush=True)


ZORDER_COLS = ("k1", "k2", "k3")
OPTIMIZE_APPENDS = 20       # BASELINE config 4: 20 appends
CONFIG4_ROWS = 10_000_000   # of 500,000 rows each
OPTIMIZE_MAX_FILE = 256 << 20  # the default max_file_size


def config4_appends(seed: int) -> list:
    """The OPTIMIZE cell's appends as `OptimizeBenchmark` makes them
    (`benchmarks/workloads.py:171-182`): 20 appends of k1, k2, k3 int64
    uniform in [0, 2^30) and payload float64 normal, one seeded
    generator."""
    rng = np.random.default_rng(seed)
    per = CONFIG4_ROWS // OPTIMIZE_APPENDS
    out = []
    for _ in range(OPTIMIZE_APPENDS):
        out.append({
            "k1": rng.integers(0, 1 << 30, per).astype(np.int64),
            "k2": rng.integers(0, 1 << 30, per).astype(np.int64),
            "k3": rng.integers(0, 1 << 30, per).astype(np.int64),
            "payload": rng.normal(size=per),
        })
    return out


def rank_matrix(cols, dev) -> torch.Tensor:
    """K4's input on the Z-order path for these columns: the scaled
    ranks, int32 bit patterns [k, n] on `dev`."""
    from delta_tpu_torch.ops import zorder as tz
    from delta_tpu_torch.ops.u32 import to_i32_bits

    stacked = np.stack([tz.to_sortable_u32(c) for c in cols])
    on_dev = torch.from_numpy(stacked.view(np.int32)).to(dev)
    return to_i32_bits(tz.scaled_ranks(on_dev, tz.pad_bucket(len(cols[0]))))


def interleave_phase(ranks: torch.Tensor, dev) -> dict:
    """K4 against its plain version on the cell's rank matrix and on edge
    shapes; timed on the rank matrix."""
    from delta_tpu_torch.ops.interleave import (
        interleave_bits, interleave_bits_plain, n_words)

    got = interleave_bits(ranks, 32)
    torch.cuda.synchronize()
    want = interleave_bits_plain(ranks, 32)
    _check(torch.equal(got, want), "interleave_bits != plain on the ranks")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    del got, want
    g = np.random.default_rng(13)
    shapes = [(k, b, n) for n in (1, 31, 33, 1023, 1025)
              for k in (1, 2, 3, 4, 5) for b in (16, 32)]
    for k, b, n in shapes + [(7, 5, 1025), (32, 32, 1025)]:
        x = g.integers(0, 2**32, (k, n), dtype=np.uint32)
        x[:, ::3] |= np.uint32(0x80000000)  # bit 31 set
        x[:, 1::5] = 0xFFFFFFFF             # all-ones rows
        t = torch.from_numpy(x.view(np.int32)).to(dev)
        _check(torch.equal(interleave_bits(t, b), interleave_bits_plain(t, b)),
               f"interleave_bits != plain at k={k} n_bits={b} n={n}")
        torch.cuda.synchronize()
    k, n = ranks.shape
    ms = _time_ms(lambda: interleave_bits(ranks, 32), 50)
    plain = _time_ms(lambda: interleave_bits_plain(ranks, 32), 3)
    w = n_words(k, 32)
    nbytes = 4.0 * (k + w) * n
    bound, by = _bound_ms(nbytes, 4.0 * k * 32 * n)
    return {
        "name": "interleave_bits", "route": "cuda", "ok": True,
        "source": "delta_tpu_torch/csrc/interleave_bits.cu",
        "replaces": "delta_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": f"u32[{k},{n}]->u32[{w},{n}]", "bound_bytes": nbytes}


def _row_hash(k1, k2, k3, payload):
    """A 64-bit mix of each row's (k1, k2, k3, payload bits)."""
    with np.errstate(over="ignore"):
        h = k1.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        h ^= k2.view(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
        h ^= k3.view(np.uint64) * np.uint64(0x165667B19E3779F9)
        h ^= payload.view(np.uint64) * np.uint64(0xD6E8FEB86659FD93)
        h ^= h >> np.uint64(31)
        h *= np.uint64(0xBF58476D1CE4E5B9)
    return h


def check_optimized_rows(inp: dict, out, dev) -> None:
    """The rows read back are the input rows (an order-free digest, then
    a row-by-row match), and in non-decreasing curve-key order under the
    keys the plain versions compute from the input in its order."""
    from delta_tpu_torch.ops.interleave import interleave_bits_plain
    from delta_tpu_torch.ops.u32 import widen_u32

    n = len(inp["k1"])
    _check(out.num_rows == n, "optimize: row count")
    cols = ("k1", "k2", "k3", "payload")
    h_in = _row_hash(*(inp[c] for c in cols))
    h_out = _row_hash(*(out.column(c).values for c in cols))
    _check(int(h_in.sum(dtype=np.uint64)) == int(h_out.sum(dtype=np.uint64))
           and int(np.bitwise_xor.reduce(h_in))
           == int(np.bitwise_xor.reduce(h_out)),
           "optimize: order-free digest of the rows")
    order = np.argsort(h_in, kind="stable")
    pos = np.minimum(np.searchsorted(h_in[order], h_out), n - 1)
    perm = order[pos]  # input row of each output row
    for c in cols:
        a, b = inp[c][perm], out.column(c).values
        _check(np.array_equal(a.view(np.int64), b.view(np.int64)),
               f"optimize: output rows match input rows ({c})")
    _check(np.unique(perm).size == n, "optimize: every input row once")
    keys = interleave_bits_plain(
        rank_matrix([inp[c] for c in ZORDER_COLS], dev), 32)
    w = widen_u32(keys[:, torch.from_numpy(perm).to(dev)])
    del keys
    ok = torch.ones(n - 1, dtype=torch.bool, device=dev)
    undecided = torch.ones_like(ok)
    for i in range(w.shape[0]):
        a, b = w[i, :-1], w[i, 1:]
        ok &= ~(undecided & (a > b))
        undecided &= a == b
    _check(bool(ok.all()), "optimize: curve keys non-decreasing")


def optimize_phase(work: str, appends: list, card: str, dev) -> dict:
    """The OPTIMIZE cell on the card, counters from 0; returns its
    metrics line (K4's launches under `launches`)."""
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.log.parquet_data import read_data_file_path
    from delta_tpu_torch.models.batch import Batch
    from delta_tpu_torch.ops.zorder import zorder_sort_indices

    path = os.path.join(work, "optimize")
    t0 = time.perf_counter()
    for cols in appends:
        write_table(path, cols, engine=TorchEngine())
    write_s = time.perf_counter() - t0
    before = Table.for_path(path, engine=TorchEngine()).latest_snapshot()
    _check(before.state.num_files == len(appends), "optimize: input files")
    bytes_in = before.state.size_in_bytes
    n_rows = sum(len(c["k1"]) for c in appends)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    t0 = time.perf_counter()
    m = Table.for_path(path, engine=TorchEngine()).optimize() \
        .execute_zorder_by(*ZORDER_COLS)
    torch.cuda.synchronize()
    command_s = time.perf_counter() - t0
    counts = obs.counters()
    peak = torch.cuda.max_memory_allocated()
    k4 = counts.get("kernel.interleave_bits.launches", 0)
    _check(k4 >= 1, "interleave_bits launched on the OPTIMIZE path")

    after = Table.for_path(path, engine=TorchEngine()).latest_snapshot().state
    n_out = max(1, -(-bytes_in // OPTIMIZE_MAX_FILE))
    _check(after.version == len(appends) == m.version,
           "optimize: committed the next version")
    tombs = after.tombstones
    _check(len(tombs) == len(appends)
           and not any(t.dataChange for t in tombs),
           "optimize: one dataChange=false tombstone per input file")
    adds = after.add_files
    _check(len(adds) == n_out == m.num_files_added,
           f"optimize: {n_out} output files")
    cubes = {(a.tags or {}).get("ZCUBE_ID") for a in adds}
    _check(len(cubes) == 1 and None not in cubes,
           "optimize: every output file carries the command's ZCube tags")
    t0 = time.perf_counter()
    out = Batch.concat([read_data_file_path(os.path.join(path, a.path))
                        for a in adds])
    read_back_s = time.perf_counter() - t0
    inp = {c: np.concatenate([a[c] for a in appends])
           for c in ("k1", "k2", "k3", "payload")}
    check_optimized_rows(inp, out, dev)
    del out

    # the curve key alone (config 4's second metric), warm
    cols = [inp[c] for c in ZORDER_COLS]
    zorder_sort_indices(cols, device=dev)
    curve_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zorder_sort_indices(cols, device=dev)
        curve_s.append(time.perf_counter() - t0)
    curve_s.sort()
    return {
        "rows": n_rows, "appends": len(appends), "input_bytes": bytes_in,
        "output_files": len(adds),
        "output_bytes": sum(a.size for a in adds),
        "write_appends_s": write_s, "command_s": command_s,
        "command_rows_per_s": n_rows / command_s,
        "phase_s": m.phase_seconds,
        "curve_key_s": curve_s, "curve_key_rows_per_s": n_rows / curve_s[1],
        "read_back_s": read_back_s, "peak_device_bytes": peak,
        "counters": counts, "launches": k4, "card": card}


def profile_optimize(path: str) -> None:
    """OPTIMIZE ZORDER BY once more on the cell's table (now its two
    output files), under torch.profiler: device time by kernel and the
    device's busy share of the command's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from delta_tpu_torch import Table, TorchEngine

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = Table.for_path(path, engine=TorchEngine()).optimize() \
            .execute_zorder_by(*ZORDER_COLS)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print("profile optimize: " + json.dumps({
        "traced_command_s": traced_s, "phase_s": m.phase_seconds,
        "device_busy_s": busy_s, "device_busy_share": busy_s / traced_s,
        "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3}
                for us, k, c in rows[:15]]}), flush=True)


def optimize_card_vs_cpu(work: str) -> None:
    """A 20,000-row table optimized along both curves on the card and on
    the CPU: the same output rows in the same order, the same stats."""
    from delta_tpu_torch import Table, TorchEngine
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.log.parquet_data import read_data_file_path
    from delta_tpu_torch.models.batch import Batch

    src = os.path.join(work, "optimize_small")
    rng = np.random.default_rng(21)
    for _ in range(4):
        write_table(src, {"k1": rng.integers(0, 1 << 30, 5000),
                          "k2": rng.integers(0, 1 << 10, 5000),  # ties
                          "k3": rng.integers(0, 1 << 30, 5000),
                          "payload": rng.normal(size=5000)},
                    engine=TorchEngine("cpu"))
    for curve in ("zorder", "hilbert"):
        results = []
        for device in ("cuda", "cpu"):
            p = os.path.join(work, f"optimize_small_{curve}_{device}")
            shutil.copytree(src, p)
            Table.for_path(p, engine=TorchEngine(device)).optimize() \
                .execute_zorder_by(*ZORDER_COLS, curve=curve)
            st = Table.for_path(p, engine=TorchEngine("cpu")) \
                .latest_snapshot().state
            rows = Batch.concat([read_data_file_path(os.path.join(p, a.path))
                                 for a in st.add_files])
            results.append((rows, [a.stats for a in st.add_files]))
        (card_rows, card_stats), (cpu_rows, cpu_stats) = results
        _check(card_stats == cpu_stats, f"{curve}: card stats == CPU stats")
        for c in ("k1", "k2", "k3", "payload"):
            _check(np.array_equal(card_rows.column(c).values.view(np.int64),
                                  cpu_rows.column(c).values.view(np.int64)),
                   f"{curve}: card rows == CPU rows ({c})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--commits", type=int, default=10_000,
                    help="log depth (the headline benchmark has 100000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also time a warm load and trace one, and trace "
                    "a second OPTIMIZE, with torch.profiler (device time "
                    "by kernel, busy share)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from delta_tpu_torch import Table, TorchEngine, obs
    from delta_tpu_torch.log.segment import build_log_segment
    from delta_tpu_torch.ops import cuda_build
    from delta_tpu_torch.replay.columnar import _read_commits_buffer
    from delta_tpu_torch.utils import filenames
    from delta_tpu_torch.utils.synth import synth_delta_log

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = _card_line()
    print(f"device: {kind} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = cuda_build.build()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.2f}s\n{info['log'].strip()}")
    print(f"build wall: {build_s:.2f}s", flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(work, "headline")
        log = os.path.join(path, "_delta_log")
        cp_version = max(0, args.commits - 10)
        t0 = time.perf_counter()
        truth = synth_delta_log(path, args.commits, 100, seed=args.seed,
                                checkpoint_version=cp_version,
                                now_ms=WEEK_MS)
        print(f"generated {args.commits} commits, {truth.num_actions} "
              f"actions and a {truth.checkpoint.get('parts', 1)}-part "
              f"checkpoint at {cp_version} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        side = os.path.join(work, "checkpoint_aside")
        aside = _set_aside(log, side)

        # one real parse window of the log: its first <= 64 MiB of commits
        eng = TorchEngine()
        seg = build_log_segment(eng.fs, log)
        buf, starts, _ = _read_commits_buffer(
            [(filenames.delta_version(f.path), f.path) for f in seg.deltas])
        cut = int(starts[starts <= eng.parse_window_bytes][-1])
        window = torch.frombuffer(buf, dtype=torch.uint8)[:cut].to(dev)
        del buf
        kernels = kernel_phase(window, truth.num_actions, dev)
        del window
        print("kernel phase ok: " + json.dumps(
            {k: {"ms": v["ms"], "plain_ms": v["plain_ms"]}
             for k, v in kernels.items()}) + "; winner_pack equal on "
            "long runs", flush=True)

        # commit-only path, counters from 0
        state, counts, list_s, load_s, peak = _timed_load(
            path, Table, TorchEngine, obs)
        n_actions = state.file_actions.num_rows
        _truth_checks(state, truth, "commit-only load")
        _check(n_actions == truth.num_actions, "action count")
        windows = counts.get("parse.device_windows", 0)
        _check(windows >= 1, "parse.device_windows >= 1")
        _check(counts.get("parse.device_fallbacks", 0) == 0,
               "parse.device_fallbacks == 0")
        k1 = counts.get("kernel.byte_class.launches", 0)
        k2 = counts.get("kernel.winner_pack.launches", 0)
        _check(k1 >= windows, "byte_class launched once per window")
        _check(k2 >= 1, "winner_pack launched")
        kernels["byte_class"]["launches"] = k1
        kernels["winner_pack"] = winner_pack_phase(state)
        kernels["winner_pack"]["launches"] = k2
        print("winner_pack on the main path's keys: " + json.dumps(
            kernels["winner_pack"]), flush=True)
        print("load: " + json.dumps({
            "commits": args.commits, "actions": n_actions,
            "live_files": state.num_files,
            "tombstones": int(state.tombstone_mask.sum()),
            "bytes": int(starts[-1]),
            "windows": windows, "list_s": list_s, "load_s": load_s,
            "phase_s": state.phase_seconds,
            "actions_per_s": n_actions / load_s,
            "peak_device_bytes": peak, "card": card}), flush=True)
        del state
        _put_back(log, side, aside)

        # K3 on a real part of the headline checkpoint, then edge plans
        parts = sorted(os.path.join(log, n) for n in aside
                       if n.endswith(".parquet"))
        kernels["hybrid_extract"] = hybrid_extract_phase(
            parts[1 if len(parts) > 1 else 0], dev)
        print("hybrid_extract phase: " + json.dumps(
            kernels["hybrid_extract"]), flush=True)

        # checkpoint path (the slice's main path), counters from 0
        state, counts, list_s, load_s, peak = _timed_load(
            path, Table, TorchEngine, obs)
        _truth_checks(state, truth, "checkpoint load")
        n_parts = len(parts)
        _check(counts.get("decode.device_parts", 0) == n_parts,
               "decode.device_parts == the part count")
        _check(counts.get("decode.device_fallbacks", 0) == 0,
               "decode.device_fallbacks == 0")
        k3 = counts.get("kernel.hybrid_extract.launches", 0)
        _check(k3 >= n_parts, "hybrid_extract launched once per part")
        ck1 = counts.get("kernel.byte_class.launches", 0)
        ck2 = counts.get("kernel.winner_pack.launches", 0)
        _check(ck1 >= 1, "byte_class launched on the tail commits")
        _check(ck2 >= 1, "winner_pack launched on the checkpoint path")
        kernels["hybrid_extract"]["launches"] = k3
        kernels["byte_class"]["launches_checkpoint_path"] = ck1
        kernels["winner_pack"]["launches_checkpoint_path"] = ck2
        n_rows = state.file_actions.num_rows
        print("checkpoint load: " + json.dumps({
            "commits": args.commits, "checkpoint_version": cp_version,
            "parts": n_parts, "tail_commits": args.commits - 1 - cp_version,
            "checkpoint_bytes": sum(os.path.getsize(p) for p in parts),
            "rows": n_rows, "live_files": state.num_files,
            "tombstones": int(state.tombstone_mask.sum()),
            "counters": counts, "list_s": list_s, "load_s": load_s,
            "phase_s": state.phase_seconds,
            "actions_per_s": n_rows / load_s,
            "peak_device_bytes": peak, "card": card}), flush=True)
        del state

        # handoff: a checkpoint at the head of a 200-commit log
        small = os.path.join(work, "handoff")
        h_truth = synth_delta_log(small, 200, 100, seed=args.seed + 2,
                                  checkpoint_version=199, now_ms=WEEK_MS)
        h_state, h_counts, _, h_s, _ = _timed_load(
            small, Table, TorchEngine, obs)
        _truth_checks(h_state, h_truth, "handoff load")
        _check(h_counts.get("decode.handoff_launches", 0) >= 1,
               "decode.handoff_launches >= 1")
        _check(h_counts.get("decode.device_fallbacks", 0) == 0,
               "handoff load: decode.device_fallbacks == 0")
        print("handoff load: " + json.dumps({
            "parts": h_truth.checkpoint.get("parts", 1), "load_s": h_s,
            "counters": h_counts}), flush=True)

        # a small checkpointed log on the card and on the CPU: equal masks
        small = os.path.join(work, "small")
        synth_delta_log(small, 300, 100, seed=args.seed + 1,
                        checkpoint_version=290, now_ms=WEEK_MS)
        on_card = Table.for_path(small, engine=TorchEngine(
            parse_window_bytes=1 << 20)).latest_snapshot().state
        on_cpu = Table.for_path(small, engine=TorchEngine(
            "cpu", parse_window_bytes=1 << 20)).latest_snapshot().state
        _check(torch.equal(on_card.live_mask.cpu(), on_cpu.live_mask)
               and torch.equal(on_card.tombstone_mask.cpu(),
                               on_cpu.tombstone_mask)
               and on_card.add_files == on_cpu.add_files,
               "small checkpointed log: card == CPU")
        print("small checkpointed log: card == cpu", flush=True)

        # K4 on the OPTIMIZE cell's own rank matrix, then edge shapes
        appends = config4_appends(args.seed + 1)
        ranks = rank_matrix([np.concatenate([a[c] for a in appends])
                             for c in ZORDER_COLS], dev)
        kernels["interleave_bits"] = interleave_phase(ranks, dev)
        del ranks
        print("interleave_bits phase: " + json.dumps(
            kernels["interleave_bits"]), flush=True)

        # the OPTIMIZE path, counters from 0
        opt = optimize_phase(work, appends, card, dev)
        kernels["interleave_bits"]["launches"] = opt["launches"]
        print("optimize zorder: " + json.dumps(opt), flush=True)
        del appends
        optimize_card_vs_cpu(work)
        print("small optimize, both curves: card == cpu", flush=True)
        if args.profile:
            profile_load(path, Table, TorchEngine)
            profile_optimize(os.path.join(work, "optimize"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

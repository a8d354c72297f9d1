"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: each test decides inside itself whether a GPU is present
and skips without one. This file imports neither jax nor the JAX package
(nor does the port), so it also runs where jax is not installed; the
repo's conftest imports jax, hence:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import shutil

import numpy as np
import pytest
import torch

from delta_tpu_torch import Table, TorchEngine, obs
from delta_tpu_torch.ops.byte_class import byte_class, byte_class_plain
from delta_tpu_torch.ops.minmax import (
    segmented_minmax,
    segmented_minmax_plain,
)
from delta_tpu_torch.ops.interleave import (
    interleave_bits,
    interleave_bits_plain,
)
from delta_tpu_torch.ops.page_decode import (
    TILE,
    hybrid_extract,
    hybrid_extract_plain,
    tile_plan,
)
from delta_tpu_torch.ops.replay import winner_pack, winner_pack_plain
from delta_tpu_torch.ops.stats import checkpoint_stats_block, host_stats_block
from delta_tpu_torch.ops.unpack import (
    unpack_bitpacked,
    unpack_bitpacked_plain,
    unpack_bitpacked_words,
)
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


def _sorted_replay(n, order, seed):
    """(sorted int64 keys, int32 original row of each sorted row) as numpy:
    `near` puts most rows back near their sorted position (paths named in
    write order, a fifth of the winners elsewhere), `random` is a random
    permutation; keys are runs of 1-3 rows, all equal, or all distinct."""
    rng = np.random.default_rng(seed)
    if order == "equal":
        keys = np.zeros(n, np.int64)
    elif order == "distinct":
        keys = np.arange(n, dtype=np.int64) * 3 - n
    else:
        keys = np.cumsum(rng.random(n) < 0.6).astype(np.int64)
    if order == "near":
        idx = np.arange(n)
        far = np.flatnonzero(rng.random(n) < 0.2)
        idx[far] = idx[rng.permutation(far)]
    else:
        idx = rng.permutation(n)
    return keys, idx.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["near", "random", "equal", "distinct"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 4099, 100_003, 1_000_003])
def test_winner_pack_kernel_on_row_orders(n, order):
    dev = _card()
    keys, idx = _sorted_replay(n, order, seed=n)
    skey, sidx = torch.from_numpy(keys).to(dev), torch.from_numpy(idx).to(dev)
    launches = obs.counter("kernel.winner_pack.launches").read()
    got = winner_pack(skey, sidx, n)
    torch.cuda.synchronize()
    assert torch.equal(got, winner_pack_plain(skey, sidx, n))
    assert obs.counter("kernel.winner_pack.launches").read() == launches + 1
    winners = int(np.unpackbits(got.cpu().numpy().view(np.uint8)).sum())
    if order == "equal":
        assert winners == 1
    if order == "distinct":
        assert winners == n  # every row wins


@pytest.mark.cuda
@pytest.mark.parametrize("key_at,idx_at", [(1, 0), (0, 1), (1, 3)])
@pytest.mark.parametrize("n", [33, 100_003])
def test_winner_pack_kernel_on_unaligned_views(n, key_at, idx_at):
    """Views whose data does not start 16-byte aligned (`buf[1:]`) take
    the kernel's row-by-row loads."""
    dev = _card()
    keys, idx = _sorted_replay(n, "near", seed=n + 1)
    kbuf = torch.zeros(n + key_at, dtype=torch.int64, device=dev)
    ibuf = torch.zeros(n + idx_at, dtype=torch.int32, device=dev)
    kbuf[key_at:] = torch.from_numpy(keys)
    ibuf[idx_at:] = torch.from_numpy(idx)
    skey, sidx = kbuf[key_at:], ibuf[idx_at:]
    got = winner_pack(skey, sidx, n)
    torch.cuda.synchronize()
    assert torch.equal(got, winner_pack_plain(skey, sidx, n))


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


def random_hybrid_plan(rng, n_runs: int, lane_bytes: int):
    """A lane and a run plan: bit-packed runs at widths 0..32 and shifts
    0..7, RLE runs with values of bit 31 set, one run ending in the last
    bytes of the lane (used by the K3 tests on the card and on the CPU)."""
    lane = rng.integers(0, 256, lane_bytes, dtype=np.uint8)
    rows, h = [], 0
    for k in range(n_runs):
        count = int(rng.integers(1, 300))
        if k % 4 == 3:
            val = int(rng.integers(0, 1 << 32))
            rows.append((h, count, 0, int(rng.integers(0, 33)), 1,
                         val - (1 << 32) if val >= 1 << 31 else val))
        else:
            w = int(rng.choice([0, 1, 2, 7, 13, 31, 32, int(rng.integers(0, 33))]))
            bits = count * w
            top = max(0, lane_bytes * 8 - bits)
            bit = int(rng.integers(0, top + 1)) if k else 0
            if k == n_runs - 1:
                bit = top  # ends in the last bytes of the lane
            rows.append((h, count, bit, w, 0, 0))
        h += count
    return lane, np.asarray(rows, np.int32), h


def edge_hybrid_plans():
    """(name, lane, runs, h_total) plan shapes K3's tiling must get right:
    runs of 0 values, a run one position longer than TILE, widths 0 and
    32, a bit-packed run ending in the lane's last 4 bytes, positions past
    the last run's count."""
    lane = np.random.default_rng(11).integers(0, 256, 4096, dtype=np.uint8)
    t = TILE
    tail_w, tail_n = 17, 64
    plans = [
        ("runs of 0 values",
         [(0, 0, 0, 5, 0, 0), (0, 40, 3, 5, 0, 0), (40, 0, 0, 9, 1, 7),
          (40, 0, 0, 9, 0, 0), (40, 60, 900, 9, 0, 0)], 100),
        ("a run one position longer than TILE",
         [(0, 3, 0, 4, 0, 0), (3, t + 1, 16, 8, 0, 0),
          (t + 4, t + 1, 0, 2, 1, -3)], 2 * t + 5),
        ("w = 0 and w = 32",
         [(0, 700, 0, 0, 0, 0), (700, 900, 13, 32, 0, 0)], 1600),
        ("a bit-packed run ending in the lane's last 4 bytes",
         [(0, 10, 0, 3, 0, 0),
          (10, tail_n, lane.size * 8 - tail_n * tail_w, tail_w, 0, 0)],
         10 + tail_n),
        ("positions past the last run's count", [(0, 5, 8, 7, 0, 0)], 3 * t),
    ]
    return [(name, lane, np.asarray(r, np.int32), h) for name, r, h in plans]


def _k3_both(lane, runs, total, dev):
    """K3 on the card and its plain version on the same plan."""
    lane_t = torch.from_numpy(lane).to(dev)
    runs_t = torch.from_numpy(runs).to(dev)
    tiles_t = torch.from_numpy(tile_plan(runs, total)).to(dev)
    got = hybrid_extract(lane_t, runs_t, total, tiles_t)
    torch.cuda.synchronize()
    return got, hybrid_extract_plain(lane_t, runs_t, total)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_runs", [(0, 1), (1, 7), (2, 64), (3, 999)])
def test_hybrid_extract_kernel_matches_plain(seed, n_runs):
    dev = _card()
    rng = np.random.default_rng(seed)
    lane, runs, h = random_hybrid_plan(rng, n_runs, 4096 + seed)
    launches = obs.counter("kernel.hybrid_extract.launches").read()
    for total in (h, 1, min(h, 1025)):
        got, want = _k3_both(lane, runs, total, dev)
        assert torch.equal(got, want)
    assert obs.counter("kernel.hybrid_extract.launches").read() \
        == launches + 3


@pytest.mark.cuda
def test_hybrid_extract_kernel_on_edge_plans():
    dev = _card()
    for name, lane, runs, h in edge_hybrid_plans():
        for total in (h, 1, h + TILE + 3):
            got, want = _k3_both(lane, runs, total, dev)
            assert torch.equal(got, want), (name, total)
        # a lane whose address is not 16-byte aligned
        ln = torch.from_numpy(np.concatenate([[0], lane]).astype(np.uint8)) \
            .to(dev)[1:]
        runs_t = torch.from_numpy(runs).to(dev)
        got = hybrid_extract(ln, runs_t, h,
                             torch.from_numpy(tile_plan(runs, h)).to(dev))
        assert torch.equal(got, hybrid_extract_plain(ln, runs_t, h)), name


@pytest.mark.cuda
def test_hybrid_extract_kernel_on_every_part_of_a_checkpoint(tmp_path):
    """K3 == plain on the plan of every part of a generated multi-part
    checkpoint, as the load plans them (value columns; with the keys too,
    as a checkpoint-only load does)."""
    from delta_tpu_torch.log.page_decode import (
        _KEY_COLUMNS, _VALUE_COLUMNS, build_part_plan)
    from delta_tpu_torch.log.parquet_footer import read_footer

    dev = _card()
    truth = synth_delta_log(str(tmp_path), 60, 100, seed=9,
                            checkpoint_version=50, now_ms=7 * 86_400_000)
    log = tmp_path / "_delta_log"
    parts = sorted(str(p) for p in log.glob("*.checkpoint.*parquet"))
    assert len(parts) == truth.checkpoint["parts"] > 2
    for path in parts:
        data = open(path, "rb").read()
        ft = read_footer(data)
        for keys in ([], [c for c in _KEY_COLUMNS if c in ft.index]):
            plan, _, _, _ = build_part_plan(
                ft, data, [c for c in _VALUE_COLUMNS if c in ft.index], keys)
            lane, runs, tiles, _ = plan.views(
                torch.from_numpy(plan.host).to(dev))
            got = hybrid_extract(lane, runs, plan.h_total, tiles)
            torch.cuda.synchronize()
            assert torch.equal(
                got, hybrid_extract_plain(lane, runs, plan.h_total)), path


@pytest.mark.cuda
def test_checkpointed_card_load_equals_cpu_load(tmp_path):
    _card()
    truth = synth_delta_log(str(tmp_path), 40, 100, seed=5,
                            checkpoint_version=30, now_ms=7 * 86_400_000)
    obs.reset()
    on_card = Table.for_path(str(tmp_path), engine=TorchEngine()) \
        .latest_snapshot().state
    counts = obs.counters()
    parts = truth.checkpoint["parts"]
    assert counts["decode.device_parts"] == parts
    assert counts["decode.device_fallbacks"] == 0
    assert counts["kernel.hybrid_extract.launches"] == parts
    on_cpu = Table.for_path(str(tmp_path), engine=TorchEngine("cpu")) \
        .latest_snapshot().state
    assert torch.equal(on_card.live_mask.cpu(), on_cpu.live_mask)
    assert torch.equal(on_card.tombstone_mask.cpu(), on_cpu.tombstone_mask)
    assert sorted(a.path for a in on_card.add_files) == truth.live_paths


def _percent_log(root, commits) -> str:
    """A log whose commits are, per version, ("add" | "remove", raw path)
    pairs; tombstones inside the retention window."""
    import json
    import os
    import time

    now_ms = int(time.time() * 1000)
    log = os.path.join(root, "_delta_log")
    os.makedirs(log)
    for v, actions in enumerate(commits):
        lines = [] if v else [
            {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
            {"metaData": {"id": "pct", "format": {"provider": "parquet",
                                                  "options": {}},
                          "schemaString": "{}", "partitionColumns": [],
                          "configuration": {}}}]
        for j, (kind, path) in enumerate(actions):
            size = 100 * v + j + 1
            lines.append(
                {"add": {"path": path, "partitionValues": {}, "size": size,
                         "modificationTime": 1, "dataChange": True}}
                if kind == "add" else
                {"remove": {"path": path, "deletionTimestamp": now_ms,
                            "dataChange": True, "size": size}})
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return str(root)


# The two smallest checkpoint-plus-tail logs over a '%' path, with the
# live files and tombstones that the reference's HostEngine serves for
# them (tests/test_torch_percent_paths.py holds the port's CPU load of
# both to the reference), and one whose decoded path still holds an
# escape: the checkpoint must keep `a%2520b`, which decodes once to the
# tail's remove (tests/test_torch_snapshot.py holds such logs on the CPU).
PERCENT_LOGS = {
    "live_file_behind_the_checkpoint": (
        [[("add", "f%25g")], [("add", "c"), ("add", "b")]],
        ["b", "c", "f%g"], []),
    "file_removed_after_the_checkpoint": (
        [[("add", "f%25g"), ("add", "b")], [("remove", "f%25g"), ("add", "c")]],
        ["b", "c"], ["f%g"]),
    "escape_removed_after_the_checkpoint": (
        [[("add", "a%2520b"), ("add", "b")],
         [("remove", "a%2520b"), ("add", "c")]],
        ["b", "c"], ["a%20b"]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("writer", ["cpu", "cuda"])
@pytest.mark.parametrize("case", sorted(PERCENT_LOGS))
def test_percent_paths_across_a_checkpoint_on_the_card(tmp_path, case,
                                                       writer):
    """The path codes' remap branch on CUDA tensors: a checkpoint at 0
    (the port's writer, on the CPU or the card) and a tail over a path
    that needs percent-decoding load on the card as on the CPU and as the
    reference serves them."""
    _card()
    commits, live, tombstones = PERCENT_LOGS[case]
    root = _percent_log(str(tmp_path), commits)
    Table.for_path(root, engine=TorchEngine(writer)).checkpoint(version=0)
    on_card = Table.for_path(root, engine=TorchEngine()) \
        .latest_snapshot().state
    on_cpu = Table.for_path(root, engine=TorchEngine("cpu")) \
        .latest_snapshot().state
    assert on_card.live_mask.device.type == "cuda"
    assert sorted(a.path for a in on_card.add_files) == live
    assert sorted(r.path for r in on_card.tombstones) == tombstones
    assert (on_card.version, on_card.num_files, on_card.size_in_bytes) \
        == (on_cpu.version, on_cpu.num_files, on_cpu.size_in_bytes)
    assert sorted((a.path, a.size) for a in on_card.add_files) \
        == sorted((a.path, a.size) for a in on_cpu.add_files)
    assert sorted((r.path, r.size, r.deletionTimestamp)
                  for r in on_card.tombstones) \
        == sorted((r.path, r.size, r.deletionTimestamp)
                  for r in on_cpu.tombstones)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n_bits,n", [
    (1, 16, 1), (1, 32, 31), (2, 16, 33), (2, 32, 1023), (3, 32, 1025),
    (3, 16, 100_003), (4, 32, 4096), (4, 16, 7), (5, 32, 1025),
    (7, 5, 999), (32, 32, 257), (3, 32, 3_000_000)])
def test_interleave_bits_kernel_matches_plain(k, n_bits, n):
    dev = _card()
    rng = np.random.default_rng(k * 1000 + n_bits + n)
    x = rng.integers(0, 2**32, (k, n), dtype=np.uint32)
    x[:, ::3] |= np.uint32(0x80000000)
    x[:, 1::5] = 0xFFFFFFFF
    t = torch.from_numpy(x.view(np.int32)).to(dev)
    launches = obs.counter("kernel.interleave_bits.launches").read()
    got = interleave_bits(t, n_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, interleave_bits_plain(t, n_bits))
    assert obs.counter("kernel.interleave_bits.launches").read() \
        == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("curve", ["zorder", "hilbert"])
def test_optimize_on_card_matches_cpu(tmp_path, curve):
    import shutil

    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.log.parquet_data import read_data_file_path

    dev = _card()
    src = str(tmp_path / "src")
    rng = np.random.default_rng(0)
    for _ in range(3):
        write_table(src, {"a": rng.integers(0, 1 << 30, 3000),
                          "b": rng.integers(0, 50, 3000),
                          "c": rng.normal(size=3000)},
                    engine=TorchEngine("cpu"))
    out = []
    for device in (dev.type, "cpu"):
        p = str(tmp_path / device)
        shutil.copytree(src, p)
        launches = obs.counter("kernel.interleave_bits.launches").read()
        Table.for_path(p, engine=TorchEngine(device)).optimize() \
            .execute_zorder_by("a", "b", "c", curve=curve)
        ran = obs.counter("kernel.interleave_bits.launches").read() - launches
        assert ran == (1 if device == "cuda" else 0)
        st = Table.for_path(p, engine=TorchEngine("cpu")) \
            .latest_snapshot().state
        rows = [read_data_file_path(f"{p}/{a.path}") for a in st.add_files]
        out.append(([r.column("a").values for r in rows],
                     [a.stats for a in st.add_files]))
    (card_a, card_stats), (cpu_a, cpu_stats) = out
    assert card_stats == cpu_stats
    for x, y in zip(card_a, cpu_a):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 31, 32, 33, 1025, 312_500])
@pytest.mark.parametrize("w", [1, 2, 7, 16, 17, 31, 32])
def test_unpack_bitpacked_kernel_matches_plain(w, g):
    dev = _card()
    words = np.random.default_rng(w * 100 + g).integers(
        0, 2**32, (w, g), dtype=np.uint32)
    words[:, ::7] = 0xFFFFFFFF
    t = torch.from_numpy(words.view(np.int32)).to(dev)
    launches = obs.counter("kernel.unpack_bitpacked.launches").read()
    got = unpack_bitpacked_words(t, w)
    torch.cuda.synchronize()
    assert torch.equal(got, unpack_bitpacked_plain(t, w))
    assert obs.counter("kernel.unpack_bitpacked.launches").read() \
        == launches + 1


@pytest.mark.cuda
def test_unpack_bitpacked_entry_point_on_the_card():
    _card()
    stream = np.random.default_rng(3).integers(0, 2**32, 16 * 1000,
                                               dtype=np.uint32)
    got = unpack_bitpacked(stream, 16, 1000)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), unpack_bitpacked(stream, 16, 1000,
                                                   device="cpu"))
    assert not unpack_bitpacked(stream, 0, 1000).any()


def _minmax_case(f, r, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(f, r)).astype(np.float32)
    m = rng.random((f, r)) > 0.1
    v[0, :] = 0.0
    v[0, ::2] = -0.0
    if f > 1:
        v[1, r // 2] = np.nan
        m[1, r // 2] = True
    if f > 2:
        m[2, :] = False
    if f > 3:
        v[3, :] = np.inf
        v[3, -1] = -np.inf
    return torch.from_numpy(v), torch.from_numpy(m)


def _card_kernels(fn, calls: int) -> dict:
    """{kernel name: launches} that torch.profiler saw on the card in
    `calls` calls of `fn` (after a warm-up step, so that tracing is on).
    The tracer may miss a whole trace: one that saw nothing is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        seen = {e.key: e.count for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", ""))
                and (getattr(e, "self_device_time_total", 0)
                     or getattr(e, "self_cuda_time_total", 0))}
        if seen:
            return seen
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("f,r", [(1, 1), (9, 129), (4, 15), (4, 17),
                                 (4, 16384), (4, 16385), (20, 500_000),
                                 (3, 1_000_001), (70_000, 3)])
def test_segmented_minmax_kernel_matches_plain(f, r):
    dev = _card()
    v, m = _minmax_case(f, r, seed=f + r)
    launches = obs.counter("kernel.segmented_minmax.launches").read()
    got = segmented_minmax(v.to(dev), m.to(dev))
    torch.cuda.synchronize()
    want = segmented_minmax_plain(v, m)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    assert obs.counter("kernel.segmented_minmax.launches").read() \
        == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("v_at,m_at", [(1, 1), (0, 1), (1, 0), (3, 7)])
@pytest.mark.parametrize("f,r", [(9, 129), (20, 500_000), (1000, 17)])
def test_segmented_minmax_kernel_on_unaligned_views(f, r, v_at, m_at):
    """Contiguous views that start off 16-byte alignment
    (`buf[k:].view(F, R)`), values and mask alike or apart: bit for bit,
    one kernel per call."""
    dev = _card()
    v, m = _minmax_case(f, r, seed=f + r + v_at)
    vbuf = torch.zeros(f * r + v_at, dtype=torch.float32, device=dev)
    mbuf = torch.zeros(f * r + m_at, dtype=torch.bool, device=dev)
    vbuf[v_at:] = v.reshape(-1).to(dev)
    mbuf[m_at:] = m.reshape(-1).to(dev)
    vt, mt = vbuf[v_at:].view(f, r), mbuf[m_at:].view(f, r)
    got = segmented_minmax(vt, mt)
    torch.cuda.synchronize()
    for a, b in zip(got, segmented_minmax_plain(v, m)):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    seen = _card_kernels(lambda: segmented_minmax(vt, mt), calls=5)
    assert len(seen) == 1 and "segmented_minmax_kernel" in next(iter(seen))
    assert 1 <= next(iter(seen.values())) <= 5


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_parts", [(0, 1), (7, 1), (1000, 9),
                                       (600_000, 8)])
def test_checkpoint_aggregate_on_card_equals_host(n, n_parts):
    dev = _card()
    rng = np.random.default_rng(n)
    lanes = [rng.integers(-2**40, 2**40, n) for _ in range(3)]
    lanes.append(rng.integers(0, 5, n))
    valids = [rng.random(n) > 0.2 for _ in range(3)] + [np.ones(n, bool)]
    part_of = np.sort(rng.integers(0, n_parts, n)).astype(np.int32)
    assert np.array_equal(
        checkpoint_stats_block(lanes, valids, part_of, n_parts, 5, dev),
        host_stats_block(lanes, valids, part_of, n_parts, 5))


@pytest.mark.cuda
def test_checkpoint_written_on_the_card_equals_cpu(tmp_path):
    import glob
    import json
    import shutil
    import time

    from delta_tpu_torch.config import settings
    from delta_tpu_torch.log.checkpointer import write_checkpoint

    _card()
    src = str(tmp_path / "src")
    truth = synth_delta_log(src, 40, 100, seed=8, checkpoint_version=30,
                            now_ms=7 * 86_400_000)
    # commit 40 removes five live files under the real clock: three a day
    # ago (retained), two eight days ago (past the 7-day window); the
    # generator's own tombstones carry commit indexes and are all past it
    now_ms = int(time.time() * 1000)
    gone = truth.live_paths[:5]
    ages = [1, 1, 1, 8, 8]
    with open(f"{src}/_delta_log/{40:020d}.json", "w") as f:
        for p, days in zip(gone, ages):
            f.write(json.dumps({"remove": {
                "path": p, "deletionTimestamp": now_ms - days * 86_400_000,
                "dataChange": True}}) + "\n")
    settings.checkpoint_part_size = 500
    try:
        out = {}
        for device in ("cuda", "cpu"):
            p = str(tmp_path / device)
            shutil.copytree(src, p)
            eng = TorchEngine(device)
            write_checkpoint(eng, Table.for_path(p, engine=eng)
                             .latest_snapshot())
            parts = sorted(glob.glob(f"{p}/_delta_log/*40.checkpoint*"))
            out[device] = [open(x, "rb").read() for x in parts]
    finally:
        settings.checkpoint_part_size = None
    assert out["cuda"] == out["cpu"] and len(out["cuda"]) > 1
    st = Table.for_path(str(tmp_path / "cuda"), engine=TorchEngine()) \
        .latest_snapshot().state
    assert st.file_actions.version.min() == 40  # through the new checkpoint
    assert sorted(a.path for a in st.add_files) == truth.live_paths[5:]
    assert sorted(t.path for t in st.tombstones) == sorted(gone[:3])

@pytest.mark.cuda
def test_ladder_on_the_card(tmp_path):
    """A torn tip commit and a half-length checkpoint load on the card to
    the generator's truth."""
    _card()
    truth = synth_delta_log(str(tmp_path), 40, 100, seed=6,
                            checkpoint_version=30, now_ms=7 * 86_400_000)
    log = tmp_path / "_delta_log"
    parts = truth.checkpoint["parts"]
    tip = log / f"{truth.version + 1:020d}.json"
    tip.write_bytes(b'{"commitInfo":{"timestamp":1}}\n{"add":{"path":"x')
    obs.reset()
    state = Table.for_path(str(tmp_path), engine=TorchEngine()) \
        .latest_snapshot().state
    counts = obs.counters()
    assert state.version == truth.version
    assert sorted(a.path for a in state.add_files) == truth.live_paths
    assert counts["snapshot.torn_commit_fallbacks"] == 1
    assert counts["kernel.hybrid_extract.launches"] == 2 * parts
    tip.unlink()
    for part in log.glob("*.checkpoint.*parquet"):
        part.write_bytes(part.read_bytes()[:part.stat().st_size // 2])
    obs.reset()
    state = Table.for_path(str(tmp_path), engine=TorchEngine()) \
        .latest_snapshot().state
    counts = obs.counters()
    assert sorted(a.path for a in state.add_files) == truth.live_paths
    assert counts["snapshot.checkpoint_fallbacks"] == 1
    assert counts["kernel.hybrid_extract.launches"] == 0
    assert counts["parse.device_windows"] >= 1


# Logs that `Snapshot.update()` and the post-commit handoff advance on the
# card: the prior commits, the version of a checkpoint written by the
# port (None: commit-only), the new commits, and the live files and
# tombstones that the reference's HostEngine serves at the head
# (tests/test_torch_update.py holds them to it). Each load route of the
# prior state appears (commit-only, checkpoint and tail, the handoff of a
# checkpoint at the head), and the new commits name files of the prior
# state by another spelling of their path (C5's rule: `x%20y` is `x y`).
_PRIOR = [[("add", "a"), ("add", "x y"), ("add", "f%25g")],
          [("add", "b"), ("remove", "a")],
          [("add", "d/e"), ("add", "a")],
          [("add", "h"), ("remove", "b")]]
_NEW = [[("remove", "x%20y"), ("add", "c"), ("remove", "f%g")],
        [("add", "x%20y"), ("add", "i%2Fj"), ("remove", "h")]]
UPDATE_LOGS = {
    "commit_only": (_PRIOR, None, _NEW, ["a", "c", "d/e", "i/j", "x y"],
                    ["b", "f%g", "h"]),
    "checkpoint_tail": (_PRIOR, 2, _NEW, ["a", "c", "d/e", "i/j", "x y"],
                        ["b", "f%g", "h"]),
    "handoff": (_PRIOR, 3, _NEW, ["a", "c", "d/e", "i/j", "x y"],
                ["b", "f%g", "h"]),
    "other_spelling_removed": ([[("add", "x y"), ("add", "b")]], 0,
                               [[("remove", "x%20y"), ("add", "c")]],
                               ["b", "c"], ["x y"]),
    "percent_file_behind_the_checkpoint": (
        [[("add", "f%25g")], [("add", "c"), ("add", "b")]], 0,
        [[("remove", "f%g"), ("add", "x%20y")]], ["b", "c", "x y"],
        ["f%g"]),
    "percent_file_removed_then_readded": (
        [[("add", "f%25g"), ("add", "b")], [("remove", "f%25g"),
                                            ("add", "c")]], 0,
        [[("add", "f%g")]], ["b", "c", "f%g"], []),
}


def update_log(root, commits, start=0) -> str:
    """Commits `start`, `start + 1`, ... of a log, each a list of ("add" |
    "remove", raw path); commit 0 carries the protocol and metadata;
    tombstones inside the retention window."""
    import json
    import os
    import time

    now_ms = int(time.time() * 1000)
    log = os.path.join(root, "_delta_log")
    os.makedirs(log, exist_ok=True)
    for v, actions in enumerate(commits, start):
        lines = [{"commitInfo": {"timestamp": now_ms, "operation": "WRITE"}}]
        if v == 0:
            lines += [
                {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
                {"metaData": {
                    "id": "upd", "format": {"provider": "parquet",
                                            "options": {}},
                    "schemaString": '{"type":"struct","fields":[]}',
                    "partitionColumns": [], "configuration": {}}}]
        for j, (kind, path) in enumerate(actions):
            size = 100 * v + j + 1
            lines.append(
                {"add": {"path": path, "partitionValues": {}, "size": size,
                         "modificationTime": 1, "dataChange": True}}
                if kind == "add" else
                {"remove": {"path": path, "deletionTimestamp": now_ms,
                            "dataChange": True, "size": size}})
        with open(os.path.join(log, f"{v:020d}.json"), "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return str(root)


def commit_actions(table, actions) -> int:
    """One transaction of the port on `table` staging `actions` (an
    action in memory holds the decoded path; the commit encodes it)."""
    import time

    from delta_tpu_torch.models.actions import AddFile, RemoveFile, decode_path

    txn = table.create_transaction_builder().build()
    for j, (kind, raw) in enumerate(actions):
        path = decode_path(raw)
        if kind == "add":
            txn.add_file(AddFile(path=path, size=j + 1, modificationTime=1,
                                 dataChange=True))
        else:
            txn.remove_file(RemoveFile(
                path=path, deletionTimestamp=int(time.time() * 1000),
                dataChange=True, size=j + 1))
    return txn.commit().version


def same_as_cold(state, root, engine) -> None:
    """`state` equals a cold load of its version on `engine` bit for bit:
    lanes and masks equal, the two numberings of the keys a bijection,
    the materialized actions equal."""
    cold = Table.for_path(root, engine=engine).snapshot_at(state.version) \
        .state
    a, c = state.file_actions, cold.file_actions
    for lane in ("is_add", "version", "order", "size"):
        assert torch.equal(getattr(a, lane).cpu(), getattr(c, lane).cpu())
    assert torch.equal(state.live_mask.cpu(), cold.live_mask.cpu())
    assert torch.equal(state.tombstone_mask.cpu(), cold.tombstone_mask.cpu())
    pairs = set(zip(a.path_code.tolist(), a.dv_code.tolist(),
                    c.path_code.tolist(), c.dv_code.tolist()))
    assert len({p[:2] for p in pairs}) == len({p[2:] for p in pairs}) \
        == len(pairs)
    assert state.add_files == cold.add_files
    assert state.tombstones == cold.tombstones


@pytest.mark.cuda
@pytest.mark.parametrize("by", ["update", "notify_commit"])
@pytest.mark.parametrize("case", sorted(UPDATE_LOGS))
def test_update_on_the_card(tmp_path, case, by):
    """The cached state on the card, loaded by each route, advances by
    the new commits (read and listed, or handed over by the port's own
    transactions): K1 parses them, K2 replays them, K3 does not launch,
    nothing is replayed in full; the result equals the cold card load
    bit for bit, the CPU's and the reference's answer."""
    _card()
    prior, cp, new, live, tombstones = UPDATE_LOGS[case]
    root = update_log(str(tmp_path), prior)
    if cp is not None:
        Table.for_path(root, engine=TorchEngine("cpu")).checkpoint(
            version=cp)
    table = Table.for_path(root, engine=TorchEngine())
    table.latest_snapshot().state
    before = obs.counters()
    if by == "update":
        update_log(root, new, start=len(prior))
    else:
        for actions in new:
            commit_actions(table, actions)
    snap = table.update()
    moved = {k: v - before.get(k, 0) for k, v in obs.counters().items()}
    assert snap.version == len(prior) + len(new) - 1
    assert moved.get("replay.advances") == (1 if by == "update"
                                            else len(new))
    assert moved.get("replay.reconstructs", 0) == 0
    assert moved.get("kernel.hybrid_extract.launches", 0) == 0
    assert moved.get("kernel.byte_class.launches", 0) >= 1
    assert moved.get("kernel.winner_pack.launches", 0) >= 1
    if by == "notify_commit":
        assert moved.get("table.notify_advances") == len(new)
        assert moved.get("log.commit_reads", 0) == 0
    state = snap.state
    assert state.live_mask.device.type == "cuda"
    assert sorted(a.path for a in state.add_files) == live
    assert sorted(r.path for r in state.tombstones) == tombstones
    same_as_cold(state, root, TorchEngine())
    same_as_cold(state, root, TorchEngine("cpu"))


def _k7_block(rng, n_cols: int, n_atoms: int, n_groups: int):
    from delta_tpu_torch.ops.skipping import AtomBlock

    cols = rng.integers(0, n_cols, n_atoms)
    rmn = (3 * cols).astype(np.int32)
    return AtomBlock(
        rows_mn=rmn, rows_mx=rmn + 1, rows_nc=rmn + 2,
        ops=rng.integers(0, 8, n_atoms).astype(np.int32),
        lits=rng.integers(-20, 21, n_atoms).astype(np.int64),
        grp=rng.integers(0, max(n_groups, 1), n_atoms).astype(np.int32),
        n_atoms=n_atoms, n_groups=n_groups)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,f,n_atoms,n_groups", [
    (0, 1, 1, 1), (1, 255, 3, 5), (2, 257, 12, 4), (3, 100_003, 40, 30),
    (4, 1000, 0, 0), (5, 1000, 0, 3), (6, 600_000, 20, 6)])
def test_skip_mask_kernel_matches_plain(seed, f, n_atoms, n_groups):
    """K7 equals its plain version bit for bit on random lanes and atom
    blocks: empty groups (more groups than atoms fill), no atom at all,
    lanes wider than the files scanned (an offset stride)."""
    from delta_tpu_torch.ops.skipping import skip_mask_block, skip_mask_plain

    dev = _card()
    rng = np.random.default_rng(seed)
    n_cols = 3
    r = 3 * n_cols + 1
    width = f + (seed % 3) * 7
    vals = rng.integers(-20, 21, (r, width)).astype(np.int64)
    nr = rng.integers(0, 4, width)
    vals[-1] = nr
    for c in range(n_cols):
        vals[3 * c + 2] = np.minimum(rng.integers(0, 5, width), nr)
    valid = rng.random((r, width)) > 0.15
    block = _k7_block(rng, n_cols, n_atoms, n_groups)
    v = torch.from_numpy(vals).to(dev)
    m = torch.from_numpy(valid).to(dev)
    launches = obs.counter("kernel.skip_mask.launches").read()
    got = skip_mask_block(v, m, block, f).cpu().numpy()
    torch.cuda.synchronize()
    assert obs.counter("kernel.skip_mask.launches").read() == launches + 1
    want = skip_mask_plain(v, m, block, f).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    if n_atoms == 0:
        assert got.all()


@pytest.mark.cuda
def test_scan_and_read_table_on_the_card_equal_cpu(tmp_path):
    """A small table's filtered scans and `read_table` on the card (K7
    launched once per filtered scan) equal `device="cpu"`."""
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.expressions import col, lit

    _card()
    path = str(tmp_path / "t")
    rng = np.random.default_rng(0)
    for i in range(6):
        k = np.arange(i * 100, i * 100 + 100)
        write_table(path, {"k": k, "x": rng.normal(size=100),
                           "s": np.array([f"s{v:04d}" for v in k])},
                    engine=TorchEngine("cpu"))
    preds = [col("k") >= lit(250), (col("k") < lit(120)) | (col("k") > lit(480)),
             col("k").is_in(5, 305, 999), col("k").is_null(),
             ~(col("k") < lit(400)), col("s") > lit("s0350")]
    card = Table.for_path(path, engine=TorchEngine()).latest_snapshot()
    cpu = Table.for_path(path, engine=TorchEngine("cpu")).latest_snapshot()
    obs.reset()
    for p in preds:
        a, b = card.scan(filter=p), cpu.scan(filter=p)
        assert a.file_paths() == b.file_paths()
        assert (a.skipped_by_stats, a.partition_pruned) \
            == (b.skipped_by_stats, b.partition_pruned)
    counts = obs.counters()
    assert counts["kernel.skip_mask.launches"] == len(preds) - 1
    assert counts["scan.stats_index_builds"] == 2
    assert card.state.stats_index.device_lanes()[0].is_cuda
    f = (col("k") >= lit(130)) & (col("x") > lit(0.0))
    on_card = read_table(path, filter=f, columns=["s", "x"],
                         engine=TorchEngine())
    on_cpu = read_table(path, filter=f, columns=["s", "x"],
                        engine=TorchEngine("cpu"))
    assert on_card.column_names == on_cpu.column_names == ["s", "x"]
    for c in ("s", "x"):
        assert np.array_equal(on_card.column(c).values,
                              on_cpu.column(c).values)


def _forms_log(root, form):
    """A small synthetic log in one of the later forms: a V2 checkpoint
    with sidecars, a struct-only checkpoint (`stats_parsed` alone), or
    compacted deltas in its tail; written by the port on the CPU."""
    import json

    from delta_tpu_torch.config import settings
    from delta_tpu_torch.log.checkpointer import write_checkpoint
    from delta_tpu_torch.log.cleanup import write_compacted_delta

    synth_delta_log(root, 40, 100, seed=11, checkpoint_version=30,
                    now_ms=7 * 86_400_000)
    cpu = TorchEngine("cpu")
    table = Table.for_path(root, engine=cpu)
    if form == "compacted":
        write_compacted_delta(table, 31, 35)
        write_compacted_delta(table, 36, 39)
        return
    if form == "struct_only":
        meta = table.latest_snapshot().metadata.to_dict()
        meta["configuration"] = {
            **meta["configuration"],
            "delta.checkpoint.writeStatsAsStruct": "true",
            "delta.checkpoint.writeStatsAsJson": "false"}
        with open(f"{root}/_delta_log/{40:020d}.json", "w") as f:
            f.write(json.dumps({"metaData": meta}) + "\n")
    settings.checkpoint_part_size = 700
    try:
        write_checkpoint(cpu, table.latest_snapshot(),
                         policy="v2" if form == "v2" else None)
    finally:
        settings.checkpoint_part_size = None


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["v2", "struct_only", "compacted"])
def test_log_forms_load_on_the_card_equal_cpu(tmp_path, form):
    """A V2 (sidecars decoded by K3, the handoff's K2), a struct-only
    (K3, the stats re-serialized) and a compacted (K1) log load on the
    card to the CPU engine's state; a filtered scan of each plans through
    K7 to the CPU's survivors."""
    from delta_tpu_torch.expressions import col, lit

    _card()
    root = str(tmp_path / form)
    _forms_log(root, form)
    obs.reset()
    card = Table.for_path(root, engine=TorchEngine()).latest_snapshot()
    st = card.state
    counts = obs.counters()
    cpu = Table.for_path(root, engine=TorchEngine("cpu")).latest_snapshot()
    assert torch.equal(st.live_mask.cpu(), cpu.state.live_mask)
    assert torch.equal(st.tombstone_mask.cpu(), cpu.state.tombstone_mask)
    assert st.add_files == cpu.state.add_files
    if form == "compacted":
        assert counts["kernel.byte_class.launches"] >= 1
        assert len(card.log_segment.compacted_deltas) == 2
    else:
        assert counts["kernel.hybrid_extract.launches"] == \
            counts["decode.device_parts"] >= 2
        assert counts["decode.device_fallbacks"] == 0
        assert counts["kernel.winner_pack.launches"] >= 1
        # the checkpoint is at the head: its parts' keys go to K2 directly
        assert counts["decode.handoff_launches"] == 1
    pred = col("x") < lit(500_000)
    obs.reset()
    assert card.scan(filter=pred).file_paths() == \
        cpu.scan(filter=pred).file_paths()
    assert obs.counters()["kernel.skip_mask.launches"] == 1


def _dv_lanes(seed: int, n_words: int, n_idx: int, n_bm: int):
    """Seeded K8 lanes over `n_words` words: indexes (some repeated, some
    sentinels and past the end), `n_bm` bitmap containers of 2048 words
    at word offsets (some repeated, some past the end, most running
    past it), bit 31 set in many."""
    rng = np.random.default_rng(seed)
    n_bits = n_words * 32
    idx = rng.integers(0, max(n_bits, 1), n_idx)
    idx[::7] |= 31
    if n_idx:
        idx[-1] = n_bits            # the sentinel
        idx[0] = n_bits - 1         # the last word's bit 31
    if n_idx > 3:
        idx[1] = idx[2]             # a repeated bit: OR, not add
        idx[3] = 1 << 40            # far past the end
    words = rng.integers(-(1 << 31), 1 << 31, n_bm * 2048).astype(np.int32)
    pos = rng.integers(0, max(n_words, 1), n_bm).astype(np.int32)
    if n_bm > 2:
        pos[-1] = n_words           # the sentinel position
        pos[1] = pos[0]
    return (torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(words),
            torch.from_numpy(pos))


@pytest.mark.cuda
@pytest.mark.parametrize("n_words,n_idx,n_bm", [
    (1, 0, 0), (1, 1, 0), (1, 0, 1), (33, 100, 5), (2048, 0, 1),
    (4096, 65536, 2), (312_500, 1_000_000, 20)])
def test_dv_bits_kernel_matches_plain(n_words, n_idx, n_bm):
    from delta_tpu_torch.ops.dv_bits import (
        decode_mask_words, decode_mask_words_plain, pack_bitmap_words,
        pack_bitmap_words_plain)

    dev = _card()
    idx, words, pos = _dv_lanes(n_words + n_idx, n_words, n_idx, n_bm)
    want = decode_mask_words_plain(idx, words, pos, n_words)
    launches = obs.counter("kernel.dv_bits.decode_launches").read()
    got = decode_mask_words(idx.to(dev), words.to(dev), pos.to(dev), n_words)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert obs.counter("kernel.dv_bits.decode_launches").read() \
        == launches + 1
    # lanes at addresses that are not 16-byte aligned
    pad_i = torch.cat([torch.zeros(1, dtype=torch.int64), idx]).to(dev)[1:]
    pad_w = torch.cat([torch.zeros(1, dtype=torch.int32), words]).to(dev)[1:]
    pad_p = torch.cat([torch.zeros(3, dtype=torch.int32), pos]).to(dev)[3:]
    assert torch.equal(decode_mask_words(pad_i, pad_w, pad_p, n_words).cpu(),
                       want)
    # pack: container-relative bits, a full 65,536-bit container among them
    n_c = max(1, n_words // 2048)
    flat = torch.cat([idx[(idx >= 0) & (idx < n_c * 65536)],
                      torch.arange(65536, dtype=torch.int64)])
    assert torch.equal(pack_bitmap_words(flat.to(dev), n_c).cpu(),
                       pack_bitmap_words_plain(flat, n_c))
    torch.cuda.synchronize()


def _run_blob(key: int, runs) -> bytes:
    """A Delta blob of one run container (key, (start, length - 1) pairs)
    in bucket 0, as other writers emit them."""
    import struct

    card = sum(n + 1 for _, n in runs)
    body = struct.pack("<H", len(runs)) + b"".join(
        struct.pack("<HH", s, n) for s, n in runs)
    blob32 = struct.pack("<I", 12347) + b"\x01" + struct.pack(
        "<HH", key, card - 1) + body
    return struct.pack("<iqI", 1681511377, 1, 0) + blob32


def _dv_pool(seed: int, n: int, rows: int):
    """`n` DV blobs of files of `rows` rows: arrays (sparse), bitmaps
    (dense, as after cell 10's dense DELETE), an empty window between
    containers, a bucket above 0, a run container."""
    from delta_tpu_torch.dv.roaring import RoaringBitmapArray

    rng = np.random.default_rng(seed)
    blobs = []
    for i in range(n):
        kind = i % 5
        if kind == 0:
            v = rng.choice(rows, max(1, rows // 250), replace=False)
        elif kind == 1:
            v = np.flatnonzero(rng.random(rows) < 0.104)
        elif kind == 2:
            v = np.concatenate([rng.choice(65536, 5000, replace=False),
                                (2 << 16) + rng.choice(65536, 30,
                                                       replace=False)])
        elif kind == 3:
            v = np.concatenate([rng.choice(rows, 100, replace=False),
                                (np.int64(1) << 32) + np.arange(9)])
        else:
            blobs.append(_run_blob(1, [(3, 9), (40_000, 25_535)]))
            continue
        blobs.append(RoaringBitmapArray(v).serialize_delta("cpu"))
    return blobs


@pytest.mark.cuda
@pytest.mark.parametrize("n_dvs,distinct,rows", [
    (1, 1, 500_000), (20, 20, 500_000), (1000, 50, 500_000),
    (7, 7, 70_001)])
def test_dv_tiles_kernel_on_batches(n_dvs, distinct, rows):
    """K8 over one batch of real DV blobs (the tiles `decode_delta_masks`
    builds) equals its plain version word for word, pads included, in one
    launch; the masks and cardinalities equal the CPU's; the batch's
    bitmaps serialized on the card equal the CPU's bytes, in one pack."""
    from delta_tpu_torch.dv.roaring import (
        RoaringBitmapArray, _plan, decode_delta_masks, serialize_deltas)
    from delta_tpu_torch.ops.dv_bits import dv_tiles, dv_tiles_plain, upload

    dev = _card()
    blobs = _dv_pool(n_dvs, distinct, rows) * (n_dvs // distinct)
    counts = [rows - 37 * (i % 3) for i in range(n_dvs)]
    tiles, lows, bm, n_words, _ = _plan(blobs, counts)
    want = dv_tiles_plain(*upload((tiles, lows, bm), "cpu"), n_words)
    before = obs.counters()
    got = dv_tiles(*upload((tiles, lows, bm), dev), n_words)
    torch.cuda.synchronize()
    after = obs.counters()
    assert torch.equal(got.cpu(), want)
    assert after["kernel.dv_bits.decode_launches"] \
        == before.get("kernel.dv_bits.decode_launches", 0) + 1
    if n_dvs <= 20:
        for (m, c), (mc, cc) in zip(decode_delta_masks(blobs, counts, dev),
                                    decode_delta_masks(blobs, counts, "cpu")):
            assert c == cc and np.array_equal(m, mc)
    bitmaps = [RoaringBitmapArray.deserialize_delta(b) for b in blobs]
    dense = any(np.unique(b.values >> np.uint64(16), return_counts=True)[1]
                .max(initial=0) > 4096 for b in bitmaps)
    packs = obs.counter("kernel.dv_bits.pack_launches").read()
    assert serialize_deltas(bitmaps, dev) == serialize_deltas(bitmaps, "cpu")
    assert obs.counter("kernel.dv_bits.pack_launches").read() \
        == packs + dense


@pytest.mark.cuda
@pytest.mark.parametrize("unaligned_bitmaps", [False, True])
def test_dv_tiles_kernel_on_unaligned_tiles(unaligned_bitmaps):
    """Hand-made tiles at word offsets that are not multiples of 4, with
    valid counts that are not either: zero, bitmap, lows and bitmap plus
    lows tiles (lows past the valid words drop), and bitmap words at an
    address off 16-byte alignment."""
    from delta_tpu_torch.ops.dv_bits import dv_tiles, dv_tiles_plain

    dev = _card()
    rng = np.random.default_rng(11)
    valids = [5, 2048, 1, 2047, 3, 1000, 2048, 7, 2046, 6]
    offs = np.cumsum([0] + valids[:-1])
    bm = rng.integers(-(1 << 31), 1 << 31, (4, 2048)).astype(np.int32)
    rows, lows, at = [], [], 0
    for t, (o, v) in enumerate(zip(offs, valids)):
        kind = t % 4   # zero, bitmap, lows, both
        k = 0 if kind < 2 else int(rng.integers(1, 3000))
        lows.append(np.sort(rng.integers(0, 65536, k)).astype(np.uint16))
        rows.append([o, v, t % 4 if kind in (1, 3) else -1, at, at + k])
        at += k
    tiles = torch.tensor(rows, dtype=torch.int32)
    low = torch.from_numpy(np.concatenate(lows).view(np.int16))
    words = torch.from_numpy(bm)
    want = dv_tiles_plain(tiles, low, words, sum(valids))
    d_words = words.to(dev)
    if unaligned_bitmaps:
        d_words = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                             d_words.reshape(-1)])[1:].view(4, 2048)
    got = dv_tiles(tiles.to(dev), low.to(dev), d_words, sum(valids))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_dml_on_the_card_equals_cpu(tmp_path):
    """DELETE (array and bitmap containers), the reads that decode the
    DVs, UPDATE and an OPTIMIZE that purges them, on the card (K8 packs
    and decodes) and on the CPU: the same DV blobs, rows and metrics."""
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.commands.dml import delete, update
    from delta_tpu_torch.dv.descriptor import _load_blob
    from delta_tpu_torch.expressions import col, lit

    _card()
    rng = np.random.default_rng(4)
    src = str(tmp_path / "src")
    for n in (70_000, 500, 9_000):
        write_table(src, {"k": rng.integers(0, 1 << 30, n),
                          "x": rng.normal(size=n)}, engine=TorchEngine("cpu"),
                    properties={"delta.enableDeletionVectors": "true"})
    runs = {}
    obs.reset()
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / dev)
        shutil.copytree(src, path)
        eng = TorchEngine(dev)
        t = Table.for_path(path, engine=eng)
        out = [delete(t, col("k") < lit(1 << 24)),       # sparse: arrays
               delete(t, col("x") > lit(0.3))]           # dense: bitmaps
        blobs = sorted(_load_blob(eng, path, a.deletionVector.to_dict())[0]
                       for a in t.latest_snapshot().state.add_files
                       if a.deletionVector is not None)
        rows = read_table(path, filter=col("x") < lit(0.0), engine=eng)
        out.append(update(t, {"x": lit(0.5)}, col("k") < lit(1 << 27)))
        out.append(t.optimize().execute_compaction())
        after = read_table(path, engine=eng)
        runs[dev] = (out, blobs, np.sort(rows.column("k").values),
                     np.sort(after.column("k").values),
                     np.sort(after.column("x").values))
        if dev == "cuda":
            counts = obs.counters()
            assert counts["kernel.dv_bits.pack_launches"] >= 1
            assert counts["kernel.dv_bits.decode_launches"] >= 3
    (a_out, a_blobs, *a_rows), (b_out, b_blobs, *b_rows) = \
        runs["cuda"], runs["cpu"]
    strip = lambda m: {k: v for k, v in vars(m).items()  # noqa: E731
                       if k != "phase_seconds"}
    assert [strip(m) for m in a_out] == [strip(m) for m in b_out]
    assert a_blobs == b_blobs and len(a_blobs) == 3
    for x, y in zip(a_rows, b_rows):
        assert np.array_equal(x, y)


def _join_lanes(nt: int, ns: int, keys: int, seed: int, skew: int = 0):
    """Codes of nt target rows then ns source rows, `skew` target rows
    (and as many source rows, up to 5) on one key."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, keys, nt)
    s = rng.integers(0, keys, ns)
    if skew:
        t[:skew] = keys
        s[:min(5, ns)] = keys
    return torch.from_numpy(np.concatenate([rng.permutation(t),
                                            rng.permutation(s)])
                            .astype(np.int32))


# K9's adversarial shapes: per key in code order, (target rows, source
# rows), so that the sorted rows hold the runs in this order. K9 reads
# 1024-row tiles in 128-row warp segments: `tile_edges` puts block starts
# (a new key, or a key's first source row) on a tile's first row and one
# row either side of it, `segment_edges` on 128-row segments.
JOIN_SHAPES = {
    "one_code": [(3000, 2500)],
    "one_code_targets_only": [(4100, 0)],
    "one_code_sources_only": [(0, 4100)],
    "every_code_distinct": [(1, 0), (0, 1)] * 1500,
    "one_target_one_source_each": [(1, 1)] * 2600,
    "target_and_source_only_runs": [(700, 0), (3, 5), (0, 1500), (2, 0),
                                    (0, 2), (1025, 1)],
    "tile_edges": [(1023, 0), (0, 1), (512, 512), (1, 2048), (3071, 1),
                   (1, 1024), (1023, 2), (5, 0), (0, 3), (2, 2)],
    "segment_edges": [(127, 1), (0, 128), (1, 127), (128, 0), (129, 2),
                      (0, 126), (3, 1)] * 3,
    "few_sources": [(50, 3), (40, 0), (10, 4)],
    "ns_31": [(900, 31), (200, 0)],
}


def join_shape(name: str, seed: int = 0):
    """(target codes, source codes) of a JOIN_SHAPES entry, int64, each
    side in a random input order."""
    runs = JOIN_SHAPES[name]
    keys = 3 * np.arange(len(runs), dtype=np.int64) + 1
    rng = np.random.default_rng(seed)
    t = np.repeat(keys, [nt for nt, _ in runs])
    s = np.repeat(keys, [ns for _, ns in runs])
    return rng.permutation(t), rng.permutation(s)


def _shape_lanes(name: str):
    t, s = join_shape(name)
    return torch.from_numpy(np.concatenate([t, s]).astype(np.int32)), len(t)


JOIN_CASES = {
    **{f"random_{nt}_{ns}_{keys}_{skew}":
       (lambda nt=nt, ns=ns, keys=keys, skew=skew:
        (_join_lanes(nt, ns, keys, seed=nt + ns, skew=skew), nt))
       for nt, ns, keys, skew in [
           (1, 1, 1, 0), (31, 33, 8, 0), (1000, 1, 10, 0), (0, 70, 3, 0),
           (70, 0, 3, 0), (5000, 1200, 3000, 0),
           (1_000_003, 300_001, 700_000, 0),
           (200_000, 50_000, 1000, 150_000), (4097, 4097, 1, 0),
           # 4,883 tiles of 1,024 rows, more than the card runs at once
           (3_000_000, 2_000_000, 2_500_000, 0)]},
    **{name: (lambda name=name: _shape_lanes(name)) for name in JOIN_SHAPES},
    # the all-one-key shape `chip_smoke.py` times, and one whose run
    # spans more tiles than the card runs at once (look-backs over tiles
    # that have not started)
    "one_code_1m_1m": lambda: (torch.zeros(2_000_000, dtype=torch.int32),
                               1_000_000),
    "one_code_3m_2m": lambda: (torch.zeros(5_000_000, dtype=torch.int32),
                               3_000_000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_merge_join_kernel_matches_plain(case):
    """K9 against its plain version on the same sorted lanes (the sort
    on the card), bit for bit, one launch per call; also on a view that
    starts off 16-byte alignment."""
    from delta_tpu_torch.ops.join import join_tail, join_tail_plain, sort_codes

    dev = _card()
    codes, nt = JOIN_CASES[case]()
    ns = codes.numel() - nt
    s_code, s_pos = sort_codes(codes.to(dev), nt)
    launches = obs.counter("kernel.merge_join.launches").read()
    got = join_tail(s_code, s_pos, nt, ns)
    torch.cuda.synchronize()
    assert obs.counter("kernel.merge_join.launches").read() == \
        launches + (nt + ns > 0)
    want = join_tail_plain(s_code, s_pos, nt, ns)
    assert torch.equal(got, want)
    # the same lanes one int32 past an aligned start
    pad_code = torch.cat([s_code[:1], s_code])[1:]
    pad_pos = torch.cat([s_pos[:1], s_pos])[1:]
    assert pad_code.data_ptr() % 16 != 0
    assert torch.equal(join_tail(pad_code, pad_pos, nt, ns), want)
    # and the lanes sorted on the CPU: the same order
    c_code, c_pos = sort_codes(codes, nt)
    assert torch.equal(s_code.cpu(), c_code) and torch.equal(s_pos.cpu(),
                                                             c_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("n,distinct", [(1000, 3), (1 << 20, 1000),
                                        (3_000_000, 10)])
def test_sort_is_stable_on_int64(n, distinct):
    """K9 takes a run's first source row as its smallest: torch.sort must
    keep input order among equal int64 keys on the card."""
    dev = _card()
    rng = np.random.default_rng(n)
    key = torch.from_numpy(rng.integers(0, distinct, n)).to(dev) << 1
    s_key, perm = torch.sort(key, stable=True)
    same = s_key[1:] == s_key[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())


@pytest.mark.cuda
def test_merge_on_the_card_equals_cpu(tmp_path, monkeypatch):
    """A partitioned upsert and a delete-merge on the card (K9, one launch
    each) and on the CPU: the same metrics and rows."""
    import delta_tpu_torch.commands.merge as merge_mod
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.expressions import col, lit

    _card()
    monkeypatch.setattr(merge_mod, "DEVICE_JOIN_MIN_ROWS", 0)
    rng = np.random.default_rng(8)
    src = str(tmp_path / "src")
    for i in range(4):
        ids = np.arange(i * 5000, (i + 1) * 5000)
        write_table(src, {"id": ids, "v": rng.normal(size=5000),
                          "m": np.array([f"{x % 3}" for x in ids // 7000],
                                        object)},
                    partition_by=["m"], engine=TorchEngine("cpu"))
    ids = np.concatenate([rng.choice(20_000, 3000, replace=False),
                          np.arange(20_000, 21_000)])
    source = {"id": ids, "v": rng.normal(size=len(ids)),
              "m": np.array([f"{x % 3}" for x in ids // 7000], object)}
    on = (col("target.id") == col("source.id")) & \
        (col("target.m") == col("source.m"))
    runs = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / dev)
        shutil.copytree(src, path)
        t = Table.for_path(path, engine=TorchEngine(dev))
        obs.reset()
        up = (merge_mod.merge(t, source, on)
              .when_matched_update(set={"v": col("source.v")})
              .when_not_matched_insert_all().execute())
        de = (merge_mod.merge(t, {k: v[:500] for k, v in source.items()}, on)
              .when_matched_delete(condition=col("source.v") < lit(0))
              .execute())
        if dev == "cuda":
            assert obs.counters()["kernel.merge_join.launches"] == 2
        rows = read_table(path, engine=TorchEngine(dev))
        order = np.argsort(rows.column("id").values, kind="stable")
        runs[dev] = ([{k: v for k, v in vars(m).items()
                       if k != "phase_seconds"} for m in (up, de)],
                     rows.column("id").values[order],
                     rows.column("v").values[order])
    assert runs["cuda"][0] == runs["cpu"][0]
    assert runs["cuda"][0][0]["num_target_rows_inserted"] == 1000
    for x, y in zip(runs["cuda"][1:], runs["cpu"][1:]):
        assert np.array_equal(x, y)


@pytest.mark.cuda
def test_column_mapping_on_the_card_equals_cpu(tmp_path):
    """A name-mode table renamed, dropped, added to and DELETEd from on
    the card: every scan through a renamed column plans by K7 to the CPU's
    files, the DELETE writes the CPU's rows, and the reads agree."""
    _card()
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.commands import alter
    from delta_tpu_torch.commands.dml import delete
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.models.schema import StructField

    paths = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(19)
        path = paths[dev] = str(tmp_path / dev)
        eng = TorchEngine(dev)
        for i in range(4):
            k = np.arange(i * 1000, (i + 1) * 1000)
            write_table(path, {"k": k, "x": rng.normal(size=1000),
                               "p": np.array([f"p{v % 3}" for v in k])},
                        engine=eng, partition_by=["p"],
                        properties={"delta.columnMapping.mode": "name",
                                    "delta.enableDeletionVectors": "true"})
        t = Table.for_path(path, engine=eng)
        t.latest_snapshot().state
        alter.rename_column(t, "k", "key")
        alter.rename_column(t, "p", "part")
        alter.add_columns(t, [StructField("w", "double")])
        obs.reset()
        delete(t, (col("key") < lit(1500)) & (col("part") == lit("p1")))
        if dev == "cuda":
            assert obs.counters()["kernel.skip_mask.launches"] == 1
    preds = [col("key") >= lit(2500), (col("key") < lit(700))
             & (col("part") == lit("p2")), col("key").is_in(5, 3999)]
    card = Table.for_path(paths["cuda"], engine=TorchEngine()) \
        .latest_snapshot()
    cpu = Table.for_path(paths["cpu"], engine=TorchEngine("cpu")) \
        .latest_snapshot()
    obs.reset()
    for p in preds:
        a, b = card.scan(filter=p), cpu.scan(filter=p)
        assert len(a.file_paths()) == len(b.file_paths())
        assert (a.skipped_by_stats, a.partition_pruned) \
            == (b.skipped_by_stats, b.partition_pruned)
    assert obs.counters()["kernel.skip_mask.launches"] == len(preds)
    on_card = read_table(paths["cuda"], engine=TorchEngine())
    on_cpu = read_table(paths["cpu"], engine=TorchEngine("cpu"))
    assert on_card.column_names == on_cpu.column_names == [
        "key", "x", "w", "part"]
    order_a = np.argsort(on_card.column("key").values)
    order_b = np.argsort(on_cpu.column("key").values)
    assert np.array_equal(on_card.column("key").values[order_a],
                          on_cpu.column("key").values[order_b])
    assert on_card.num_rows == 4000 - 500


def _commit_shape(path: str, version: int) -> dict:
    """A commit's operation, parameters, metrics (byte counts aside) and
    per action kind its (dataChange, partition values, rows, DV
    cardinality) tuples, sorted."""
    import json
    import os
    import re

    out = {}
    with open(os.path.join(path, "_delta_log", f"{version:020d}.json")) as f:
        for line in f:
            if not line.strip():
                continue
            (k, v), = json.loads(line).items()
            if k == "commitInfo":
                out["info"] = (v["operation"], v["operationParameters"], {
                    m: x for m, x in v["operationMetrics"].items()
                    if "Bytes" not in m}, v["isBlindAppend"])
            elif k in ("add", "remove"):
                dv = v.get("deletionVector")
                out.setdefault(k, []).append((
                    v["dataChange"], re.sub(r"col-[0-9a-f-]{36}", "col-*",
                                            json.dumps(v["partitionValues"],
                                                       sort_keys=True)),
                    json.loads(v["stats"])["numRecords"] if v.get("stats")
                    else None, dv["cardinality"] if dv else None))
    return {k: sorted(v) if isinstance(v, list) else v
            for k, v in out.items()}


@pytest.mark.cuda
def test_write_modes_on_the_card_equal_cpu(tmp_path):
    """`chip_smoke.py` step 22's writes on a small name-mode table with
    DVs, partitioned: a dynamic overwrite, replace_where on the partition
    column and on a data column (K7 plans, K8 packs: 4,725 of a file's
    5,000 rows, a bitmap container), merge_schema, a data_change=False
    rewrite and overwrite_schema give the CPU's commits and rows on the
    card."""
    _card()
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.expressions import col, lit

    def rows(lo, n, part):
        k = np.arange(lo, lo + n)
        return {"k": k, "x": (k * 7 % 11).astype(np.float64),
                "p": np.array([part(v) for v in k], object)}

    paths, shapes, reads = {}, {}, {}
    for dev in ("cuda", "cpu"):
        path = paths[dev] = str(tmp_path / dev)
        eng = TorchEngine(dev)
        for i in range(4):
            write_table(path, rows(i * 20000, 20000, lambda v: f"p{v % 4}"),
                        engine=eng, partition_by=["p"],
                        properties={"delta.columnMapping.mode": "name",
                                    "delta.enableDeletionVectors": "true"})
        versions = [
            write_table(path, rows(5000, 40, lambda v: "p1"), engine=eng,
                        mode="overwrite", partition_overwrite_mode="dynamic"),
            write_table(path, rows(6000, 30, lambda v: "p2"), engine=eng,
                        mode="overwrite",
                        replace_where=col("p") == lit("p2"))]
        obs.reset()
        versions.append(write_table(
            path, rows(100, 200, lambda v: f"p{v % 4}"), engine=eng,
            mode="overwrite",
            replace_where=(col("k") >= lit(100)) & (col("k") < lit(19000))))
        if dev == "cuda":
            c = obs.counters()
            assert c["kernel.skip_mask.launches"] == 1
            assert c["kernel.dv_bits.pack_launches"] == 1
        extra = rows(7000, 10, lambda v: "p3")
        extra["tag"] = np.array(["t"] * 10, object)
        versions.append(write_table(path, extra, engine=eng,
                                    merge_schema=True))
        versions.append(write_table(path, read_table(path, engine=eng),
                                    engine=eng, mode="overwrite",
                                    data_change=False))
        everything = read_table(path, engine=eng)
        versions.append(write_table(
            path, {c: everything.column(c) for c in ("k", "x", "p")},
            engine=eng, mode="overwrite", overwrite_schema=True))
        shapes[dev] = [_commit_shape(path, v) for v in versions[:-2]]
        got = read_table(path, engine=eng)
        order = np.argsort(got.column("k").values)
        reads[dev] = (got.column_names,
                      got.column("k").values[order].tolist(),
                      got.column("x").values[order].tolist(),
                      got.column("p").values[order].tolist())
    assert shapes["cuda"] == shapes["cpu"]
    assert reads["cuda"] == reads["cpu"]
    assert reads["cuda"][0] == ["k", "x", "p"]
    # p1 and p2 replaced by 40 and 30 rows; the live rows in [100, 19000)
    # (9,450 of p0 and p3, and those 70) by 200; 10 appended
    assert len(reads["cuda"][1]) == 80000 - 40000 - 9450 + 200 + 10


@pytest.mark.cuda
def test_reorg_and_vacuum_on_the_card_equal_cpu(tmp_path):
    """REORG PURGE of a DV table (a bitmap container and an array one:
    K8 decodes both in one launch), then VACUUM's dry run, LITE and a
    FULL dry run with retention 0 (the range read through K1), on the
    card and on the CPU: the same metrics, deleted sets and rows."""
    import os
    import time

    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.commands.dml import delete
    from delta_tpu_torch.commands.reorg import reorg_purge
    from delta_tpu_torch.expressions import col, lit

    _card()
    src = str(tmp_path / "src")
    for i in range(3):
        k = np.arange(i * 6000, (i + 1) * 6000)
        write_table(src, {"k": k, "x": (k % 17).astype(np.float64)},
                    engine=TorchEngine("cpu"),
                    properties={"delta.enableDeletionVectors": "true"})
    delete(Table.for_path(src, engine=TorchEngine("cpu")),
           (col("k") < lit(5000))
           | ((col("k") >= lit(9000)) & (col("k") < lit(9050))))
    runs = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / dev)
        shutil.copytree(src, path)
        eng = TorchEngine(dev)
        t = Table.for_path(path, engine=eng)
        obs.reset()
        m = reorg_purge(t)
        if dev == "cuda":
            assert obs.counters()["kernel.dv_bits.decode_launches"] == 1
        old = time.time() - 7200
        for f in os.listdir(path):
            if f != "_delta_log":
                os.utime(os.path.join(path, f), (old, old))
        t = Table.for_path(path, engine=eng)
        dry = t.vacuum(retention_hours=0, dry_run=True).files_deleted
        obs.reset()
        lite = t.vacuum(retention_hours=0, vacuum_type="LITE")
        if dev == "cuda":
            assert obs.counters()["kernel.byte_class.launches"] >= 1
        after = t.vacuum(retention_hours=0, dry_run=True).files_deleted
        got = read_table(path, engine=eng)
        runs[dev] = ((m.num_files_added, m.num_files_removed,
                      m.bytes_removed), sorted(dry),
                     sorted(lite.files_deleted), after,
                     np.sort(got.column("k").values).tolist())
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"][1] == runs["cuda"][2] and runs["cuda"][3] == []
    assert len(runs["cuda"][4]) == 18000 - 5000 - 50


@pytest.mark.cuda
def test_table_features_on_the_card_equal_cpu(tmp_path, monkeypatch):
    """`chip_smoke.py` step 24's operations on a small name-mode DV table,
    on the card and on the CPU: CHANGE COLUMN TYPE integer -> long, an
    append past 2^31 and a filtered read at the old bound (K7 once), a
    MERGE with schema evolution (K9 once), a DELETE leaving a bitmap DV,
    ADD CONSTRAINT over every live row (K8 decodes the DV in one launch),
    a violating append refused; then a table with identity, generated and
    default columns, appended to and merged into (K9). The same commits'
    shapes, rows and identity values."""
    import delta_tpu_torch.commands.merge as merge_mod
    from delta_tpu_torch.api import read_table, write_table
    from delta_tpu_torch.colgen import (default_field, generated_field,
                                        identity_field)
    from delta_tpu_torch.commands import alter
    from delta_tpu_torch.commands.dml import delete
    from delta_tpu_torch.constraints import add_constraint
    from delta_tpu_torch.errors import InvariantViolationError
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.models.schema import StructField, StructType

    _card()
    monkeypatch.setattr(merge_mod, "DEVICE_JOIN_MIN_ROWS", 0)
    on = col("target.k") == col("source.k")
    runs = {}
    for dev in ("cuda", "cpu"):
        path, eng = str(tmp_path / dev), TorchEngine(dev)
        for i in range(3):
            k = np.arange(i * 6000, (i + 1) * 6000)
            write_table(path, {"k": k, "q": (k % 100).astype(np.int32)},
                        engine=eng, properties={
                            "delta.columnMapping.mode": "name",
                            "delta.enableDeletionVectors": "true",
                            "delta.enableTypeWidening": "true"})
        t = Table.for_path(path, engine=eng)
        t.latest_snapshot().state
        obs.reset()
        versions = [alter.change_column_type(t, "q", "long")]
        counts = [obs.counters()]
        k = np.arange(20_000, 26_000)
        versions.append(write_table(path, {"k": k, "q": (1 << 31) + k},
                                    engine=eng))
        obs.reset()
        at_bound = read_table(path, filter=col("q") >= lit(99), engine=eng)
        counts.append(obs.counters())
        src = {"k": np.arange(17_000, 19_000),
               "q": np.arange(2000, dtype=np.int64),
               "tag": np.array(["new"] * 2000, object)}
        obs.reset()
        versions.append(merge_mod.merge(t, src, on).with_schema_evolution()
                        .when_matched_update_all()
                        .when_not_matched_insert_all().execute().version)
        counts.append(obs.counters())
        versions.append(delete(t, col("q") > lit((1 << 31) + 21_000))
                        .version)
        obs.reset()
        versions.append(add_constraint(t, "pos", "q >= 0"))
        counts.append(obs.counters())
        with pytest.raises(InvariantViolationError):
            write_table(path, {"k": np.array([1]), "q": np.array([-1])},
                        engine=eng)
        fresh = str(tmp_path / f"{dev}_ids")
        schema = StructType([identity_field("id", 5, -2),
                             StructField("k", "long"),
                             generated_field("big", "boolean", "k > 100"),
                             default_field("c", "string", "'x'")])
        write_table(fresh, {"k": np.arange(200)}, schema=schema, engine=eng)
        write_table(fresh, {"k": np.arange(200, 300)}, engine=eng)
        obs.reset()
        merge_mod.merge(Table.for_path(fresh, engine=eng),
                        {"k": np.arange(250, 400)}, on) \
            .when_not_matched_insert_all().execute()
        counts.append(obs.counters())
        got, ids = read_table(path, engine=eng), read_table(fresh,
                                                            engine=eng)
        order = np.argsort(got.column("k").values, kind="stable")
        iorder = np.argsort(ids.column("k").values, kind="stable")
        runs[dev] = (
            [_commit_shape(path, v) for v in versions],
            at_bound.num_rows, got.column_names,
            got.column("k").values[order].tolist(),
            got.column("q").values[order].tolist(),
            ids.column("id").values[iorder].tolist(),
            ids.column("big").values[iorder].tolist(),
            set(ids.column("c").values.tolist()))
        if dev == "cuda":
            assert counts[0].get("kernel.byte_class.launches", 0) >= 1
            assert counts[1]["kernel.skip_mask.launches"] == 1
            assert counts[2]["kernel.merge_join.launches"] == 1
            assert counts[3]["kernel.dv_bits.decode_launches"] == 1
            assert counts[4]["kernel.merge_join.launches"] == 1
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"][2] == ["k", "q", "tag"]
    assert runs["cuda"][5] == [5 - 2 * i for i in range(400)]
    assert runs["cuda"][7] == {"x"}


@pytest.mark.cuda
def test_change_data_feed_on_the_card_equals_cpu(tmp_path):
    """A table with deletion vectors and the change data feed: an UPDATE,
    a DELETE that leaves bitmap DVs (its change data file), then a
    DELETE of every row (no change data: its feed is made from removes
    that carry DVs). On the card and on the CPU the feeds are equal; on
    the card the read of the last version parses its range in one K1
    launch and decodes every DV it carries in one K8 launch."""
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.commands.dml import delete, update
    from delta_tpu_torch.expressions import col, lit
    from delta_tpu_torch.read.cdc import table_changes

    _card()
    rng = np.random.default_rng(25)
    src = str(tmp_path / "src")
    for n in (70_000, 9_000):
        write_table(src, {"k": rng.integers(0, 1 << 30, n),
                          "x": rng.normal(size=n)}, engine=TorchEngine("cpu"),
                    properties={"delta.enableDeletionVectors": "true",
                                "delta.enableChangeDataFeed": "true"})
    runs = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / dev)
        shutil.copytree(src, path)
        eng = TorchEngine(dev)
        update(Table.for_path(path, engine=eng), {"x": lit(0.5)},
               col("k") < lit(1 << 24))
        delete(Table.for_path(path, engine=eng), col("x") > lit(0.3))
        delete(Table.for_path(path, engine=eng), None)
        obs.reset()
        last = table_changes(Table.for_path(path, engine=eng), 4, 4)
        counts = obs.counters()
        feed = table_changes(Table.for_path(path, engine=eng), 0)
        order = np.lexsort((feed.column("x").values, feed.column("k").values,
                            feed.column("_commit_version").values))
        runs[dev] = (last.num_rows, [
            feed.column(c).values[order].tolist()
            for c in ("k", "x", "_change_type", "_commit_version")])
        if dev == "cuda":
            assert counts["kernel.byte_class.launches"] == 1
            assert counts["kernel.dv_bits.decode_launches"] == 1
            assert counts["kernel.dv_bits.decode_dvs"] >= 1
    assert runs["cuda"] == runs["cpu"]
    assert set(runs["cpu"][1][2]) == {"insert", "delete", "update_preimage",
                                      "update_postimage"}


def _seg_agg_case(n: int, n_groups: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, max(n_groups, 1), n)
                             .astype(np.int32))
    if dtype == torch.int64:
        v = torch.from_numpy(rng.integers(-10**9, 10**9, n))
    else:
        v = torch.from_numpy(np.round(rng.normal(0, 1e3, n), 2))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    return codes, v, valid


def _seg_agg_same(got, want, op, dtype):
    assert torch.equal(got[1].cpu(), want[1])
    if dtype == torch.float64 and op in ("sum", "sumsq"):
        assert torch.allclose(got[0].cpu(), want[0], rtol=1e-12, atol=1e-9)
    else:
        assert torch.equal(got[0].cpu().view(torch.int64),
                           want[0].view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", [
    (op, dt) for op in ("count", "sum", "min", "max", "sumsq")
    for dt in (torch.int64, torch.float64)
    if op != "sumsq" or dt == torch.float64])
@pytest.mark.parametrize("n,n_groups", [(0, 3), (1, 1), (1000, 1),
                                        (4097, 4097), (100_000, 12),
                                        (100_000, 1024), (100_000, 1025),
                                        (2_000_000, 11_521),
                                        (100_000, 16), (100_000, 17),
                                        (2_000_000, 11_622),
                                        (2_000_000, 11_623),
                                        (2_000_000, 19_370),
                                        (2_000_000, 19_371)])
def test_seg_agg_kernel_matches_plain(op, dtype, n, n_groups):
    """K10 against its plain version: one group, as many groups as rows,
    and each regime's edges (`csrc/seg_agg.cu`): the lane tables' last G
    (16) and the first past it, in a cluster's tables; the last G whose
    sumsq means fit beside the table (11,622) and the first past it; the
    tables' last G (19,370: 227 KiB a block) and the first that goes to
    global atomics."""
    from delta_tpu_torch.ops.segagg import seg_agg, seg_agg_plain

    dev = _card()
    codes, v, valid = _seg_agg_case(n, n_groups, dtype, n + n_groups)
    means = torch.linspace(-5, 5, n_groups, dtype=torch.float64) \
        if op == "sumsq" else None
    launches = obs.counter("kernel.seg_agg.launches").read()
    got = seg_agg(codes.to(dev), v.to(dev), valid.to(dev), op, n_groups,
                  None if means is None else means.to(dev))
    torch.cuda.synchronize()
    _seg_agg_same(got, seg_agg_plain(codes, v, valid, op, n_groups, means),
                  op, dtype)
    assert obs.counter("kernel.seg_agg.launches").read() == launches + 1


def _seg_agg_pattern(pattern: str, n: int, n_groups: int, rng):
    """Codes and validity of a pattern: every 128-row warp step one code
    ("warp"), tickets' runs of 1-25 rows ("runs"), or random codes with
    no valid row ("invalid")."""
    if pattern == "warp":
        codes = np.repeat(rng.integers(0, n_groups, n // 128 + 1), 128)[:n]
    elif pattern == "runs":
        sizes = rng.integers(1, 26, n)
        codes = np.repeat(np.arange(n) % n_groups, sizes)[:n]
    else:
        codes = rng.integers(0, n_groups, n)
    valid = np.zeros(n, bool) if pattern == "invalid" else rng.random(n) > 0.1
    return torch.from_numpy(codes.astype(np.int32)), torch.from_numpy(valid)


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", [
    (op, dt) for op in ("count", "sum", "min", "max", "sumsq")
    for dt in (torch.int64, torch.float64)
    if op != "sumsq" or dt == torch.float64])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("pattern", ["warp", "runs", "invalid"])
@pytest.mark.parametrize("n_groups", [6, 11_521, 221_000])
def test_seg_agg_kernel_on_code_patterns(op, dtype, masked, pattern,
                                         n_groups):
    """K10 against its plain version where a warp's rows share one code,
    where codes come in runs as a ticket's line items do, and where no
    row is valid (the mask, or none: every row valid), in each regime:
    warp tables (6 groups), a cluster's table (11,521) and global atomics
    (221,000)."""
    from delta_tpu_torch.ops.segagg import seg_agg, seg_agg_plain

    dev = _card()
    n = 300_000
    rng = np.random.default_rng(n_groups)
    codes, valid = _seg_agg_pattern(pattern, n, n_groups, rng)
    _, v, _ = _seg_agg_case(n, n_groups, dtype, n_groups + 1)
    if not masked:
        valid = None
    means = torch.linspace(-5, 5, n_groups, dtype=torch.float64) \
        if op == "sumsq" else None
    got = seg_agg(codes.to(dev), v.to(dev),
                  None if valid is None else valid.to(dev), op, n_groups,
                  None if means is None else means.to(dev))
    torch.cuda.synchronize()
    _seg_agg_same(got, seg_agg_plain(codes, v, valid, op, n_groups, means),
                  op, dtype)


@pytest.mark.cuda
def test_seg_agg_kernel_on_edge_values():
    """All rows invalid, ±0.0 and infinities, an int64 sum that wraps
    (as the reference's segment_sum), no valid mask, a group with no
    row."""
    from delta_tpu_torch.ops.segagg import seg_agg, seg_agg_plain

    dev = _card()
    codes = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], dtype=torch.int32)
    f = torch.tensor([0.0, -0.0, -0.0, 0.0, float("inf"), 1.0,
                      float("-inf"), -1.0], dtype=torch.float64)
    big = torch.tensor([2**62, 2**62, 2**62, 2**62, -2**63, -1, 5, 6],
                       dtype=torch.int64)
    none = torch.zeros(8, dtype=torch.bool)
    for v in (f, big):
        for valid in (None, none, torch.ones(8, dtype=torch.bool)):
            for op in ("count", "sum", "min", "max"):
                got = seg_agg(codes.to(dev), v.to(dev),
                              None if valid is None else valid.to(dev), op, 5)
                torch.cuda.synchronize()
                want = seg_agg_plain(codes, v, valid, op, 5)
                assert torch.equal(got[1].cpu(), want[1])
                assert torch.equal(got[0].cpu().view(torch.int64),
                                   want[0].view(torch.int64)), (op, valid)


@pytest.mark.cuda
def test_a_k10_build_or_launch_failure_raises(monkeypatch, tmp_path):
    """On a CUDA engine a K10 that cannot be built, or whose launch
    fails, raises out of the query: there is no host fallback."""
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.ops import cuda_build, segagg
    from delta_tpu_torch.sqlengine import execute_select

    _card()
    p = str(tmp_path / "t")
    write_table(p, {"k": np.arange(10) % 3, "v": np.arange(10.0)},
                engine=TorchEngine("cpu"))
    q = f"SELECT k, sum(v) FROM '{p}' GROUP BY k"

    real_function = cuda_build.function

    def unbuildable(name, *a, **k):
        if name == "seg_agg":
            raise RuntimeError("native library seg_agg: nvcc failed")
        return real_function(name, *a, **k)

    monkeypatch.setattr(segagg, "_LAUNCH", None)
    monkeypatch.setattr(cuda_build, "function", unbuildable)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        execute_select(q, engine=TorchEngine())
    monkeypatch.setattr(segagg, "_LAUNCH",
                        (lambda *a: 700, lambda index: 0))
    with pytest.raises(RuntimeError, match="seg_agg launch failed"):
        execute_select(q, engine=TorchEngine())


@pytest.mark.cuda
def test_avg_of_a_long_column_on_the_card(tmp_path):
    """AVG over int64 values whose sum passes 2^63 sums in float64 on the
    card as on the CPU (C30), in one group and under a GROUP BY."""
    from delta_tpu_torch.api import write_table
    from delta_tpu_torch.models.batch import Column
    from delta_tpu_torch.sql import sql

    _card()
    p = str(tmp_path / "c30")
    write_table(p, {"id": Column(np.array([1, 2, 3, 4, 5, 0]),
                                 np.array([True] * 5 + [False])),
                    "i": np.array([2**62, 2**62, 1, 2, 3, 4])},
                engine=TorchEngine("cpu"))
    for stmt, means in (
            (f"SELECT AVG(i) a FROM '{p}'", [1.5372286728091292e+18]),
            (f"SELECT id IS NULL k, AVG(i) a FROM '{p}' GROUP BY id IS NULL "
             "ORDER BY k", [1.8446744073709553e+18, 4.0])):
        launches = obs.counter("kernel.seg_agg.launches").read()
        got = [r[-1] for r in sql(stmt, engine=TorchEngine()).rows()]
        assert obs.counter("kernel.seg_agg.launches").read() > launches
        want = [r[-1] for r in sql(stmt, engine=TorchEngine("cpu")).rows()]
        assert got == pytest.approx(want, rel=1e-12)
        assert got == pytest.approx(means, rel=1e-12)


def _same_sql_rows(got, want, name):
    assert got.names == want.names, name
    key = lambda r: repr([round(x, 3) if isinstance(x, float) else x
                          for x in r])  # noqa: E731
    for a, b in zip(sorted(got.rows(), key=key),
                    sorted(want.rows(), key=key), strict=True):
        for x, y in zip(a, b, strict=True):
            assert x == pytest.approx(y, rel=1e-9) \
                if isinstance(y, float) else x == y, name


@pytest.mark.cuda
def test_sql_on_the_card_equals_cpu(tmp_path):
    """The TPC-DS generator at scale 12,000 written on the CPU, each of
    the 71 texts the port runs on the card and on the CPU: the same rows
    (the card's float sums to 1e-9 relative); K10 launched on every query
    that aggregates and has rows; the joins, lookups, membership tests,
    group-bys and sorts counted the same on both (q9 and q41 join
    nothing)."""
    from delta_tpu_torch.catalog import Catalog
    from delta_tpu_torch.sqlengine import execute_select
    from delta_tpu_torch.utils.tpcds import QUERIES, load_delta

    _card()
    root = str(tmp_path / "tpcds")
    load_delta(root, scale=12_000, engine=TorchEngine("cpu"))
    card = Catalog(root, engine=TorchEngine())
    cpu = Catalog(root, engine=TorchEngine("cpu"))
    plan = ("sql.device_joins", "sql.device_groupbys", "sql.device_sorts")
    for name, text in QUERIES.items():
        obs.reset()
        got = execute_select(text, catalog=card)
        counts = obs.counters()
        obs.reset()
        want = execute_select(text, catalog=cpu)
        cpu_counts = obs.counters()
        _same_sql_rows(got, want, name)
        if got.num_rows and any(f"{a}(" in text.lower() for a in (
                "sum", "avg", "count", "stddev_samp")):
            assert counts.get("kernel.seg_agg.launches", 0) >= 1, name
        assert [counts.get(k, 0) for k in plan] == \
            [cpu_counts.get(k, 0) for k in plan], name
        if name not in ("q9", "q41"):
            assert counts.get("sql.device_joins", 0) >= 1, name


@pytest.mark.cuda
def test_nested_sql_on_the_card_equals_cpu(tmp_path):
    """q32 (a correlated scalar: its decorrelated group-by on K10, the
    outer keys looked up on the card), q59 (a CTE self-joined) and q87
    (EXCEPT of three channels' distinct rows) at scale 12,000 on the card
    and on the CPU: the same rows, K10 launched."""
    from delta_tpu_torch.catalog import Catalog
    from delta_tpu_torch.sqlengine import execute_select
    from delta_tpu_torch.utils.tpcds import QUERIES, load_delta

    _card()
    root = str(tmp_path / "tpcds")
    load_delta(root, scale=12_000, engine=TorchEngine("cpu"))
    card = Catalog(root, engine=TorchEngine())
    cpu = Catalog(root, engine=TorchEngine("cpu"))
    for name in ("q32", "q59", "q87"):
        obs.reset()
        got = execute_select(QUERIES[name], catalog=card)
        counts = obs.counters()
        _same_sql_rows(got, execute_select(QUERIES[name], catalog=cpu), name)
        assert got.num_rows >= 1, name
        assert counts.get("kernel.seg_agg.launches", 0) >= 1, name
        assert counts.get("sql.device_joins", 0) >= 1, name

"""The deletion-vector codec: the port's `dv/` and K8's plain version
against the JAX package's `delta_tpu/dv/` and its jitted B7 bodies.

Every comparison is exact. Value sets come from numpy seeds; run
containers are built by hand (the reference's writer never emits them,
Spark's does). Compared:

- blobs byte for byte (`serialize_delta`), the values and the row mask of
  each blob, and `_mask_plan`'s lanes (the port's one word offset per
  bitmap container expanded to the reference's position per word), on empty, one-value, array-only,
  bitmap-only and mixed sets, a high 32-bit bucket, a full container;
- blobs with run containers (with and without offsets, beside array and
  bitmap containers, two 64-bit buckets) decoded by both;
- `pack_bitmap_words_plain` against `_pack_fn_cached` and
  `decode_mask_words_plain` against `_decode_fn_cached`, the un-wrapped
  jitted bodies, under `jax.enable_x64(True)` (their wrappers reach
  `_x64()`, which this jax lacks: ROADMAP C0);
- descriptor errors class for class (CRC, size, cardinality, bad magic
  and cookie, an inline 'p' path), DV files and inline descriptors each
  package writes read by the other;
- a blob with a bit past 2^31 (the reference declines its device decode
  and expands on the host; the port counts the lanes past the file's
  rows on the host);
- K8's batched form (`dv_tiles_plain` over the tiles of one batch of 1,
  7 and 50 DVs: array, run and bitmap containers, an empty window, rows
  ending inside a container, a bucket above 0) against the reference
  body per DV; one batched pack against `_pack_fn_cached` per bucket and
  the reference's blobs; `load_deletion_vector_masks` against the
  reference's loads per descriptor, one read of the shared DV file, and
  a bad CRC or cardinality inside a batch raising the reference's
  error class; the plain version's clamps and refusals.
"""

import base64
import struct
import uuid

import jax
import numpy as np
import pytest
import torch

from delta_tpu.dv import descriptor as ref_desc
from delta_tpu.dv import roaring as ref_roaring
from delta_tpu.engine.host import HostEngine
from delta_tpu.errors import DeltaError as RefDeltaError
from delta_tpu.ops import stats as ref_stats
from delta_tpu_torch import TorchEngine, obs
from delta_tpu_torch.dv import descriptor as port_desc
from delta_tpu_torch.dv import roaring as port_roaring
from delta_tpu_torch.errors import DeletionVectorError
from delta_tpu_torch.ops.dv_bits import (
    BITMAP_WORDS,
    decode_mask_words,
    dv_tiles,
    dv_tiles_plain,
    decode_mask_words_plain,
    pack_bitmap_words,
    pack_bitmap_words_plain,
)

RefBitmap = ref_roaring.RoaringBitmapArray
PortBitmap = port_roaring.RoaringBitmapArray
CPU = torch.device("cpu")


def _sets():
    rng = np.random.default_rng(7)
    mixed = np.concatenate([
        rng.choice(65536, 100, replace=False),                  # array
        (1 << 16) + rng.choice(65536, 9000, replace=False),     # bitmap
        (5 << 16) + np.arange(4096),                            # array, full
        (6 << 16) + np.arange(4097),                            # bitmap, edge
    ])
    return {
        "empty": np.empty(0, np.uint64),
        "one": np.array([12345]),
        "zero": np.array([0]),
        "array_only": rng.choice(1 << 20, 3000, replace=False),
        "bitmap_only": rng.choice(3 * 65536, 60000, replace=False),
        "full_container": np.arange(65536),
        "mixed": mixed,
        "high_bucket": np.concatenate([
            rng.choice(1 << 18, 500, replace=False),
            (np.uint64(3) << np.uint64(32))
            + rng.choice(100000, 20000, replace=False).astype(np.uint64)]),
        "bit_31": np.array([1, 2, (1 << 31) - 1, 1 << 31]),
    }


SETS = _sets()


@pytest.mark.parametrize("name", sorted(SETS))
def test_blob_values_mask_and_plan_equal(name):
    values = np.asarray(SETS[name]).astype(np.uint64)
    blob = PortBitmap(values).serialize_delta(CPU)
    assert blob == RefBitmap(values).serialize_delta()
    want = np.unique(values)
    assert np.array_equal(PortBitmap.deserialize_delta(blob).values, want)
    assert np.array_equal(RefBitmap.deserialize_delta(blob).values, want)
    for n in (0, 1, 70000, 300_000):
        mask, card = port_roaring.decode_delta_mask(blob, n, CPU)
        assert np.array_equal(mask, RefBitmap.deserialize_delta(blob)
                              .to_mask(n))
        assert card == len(want)
    ref_plan = ref_roaring._mask_plan(blob)
    if ref_plan is None:
        # past 2^26 words the reference declines (its host route runs)
        assert int(values.max()) >= 1 << 31
        return
    _assert_plans_equal(ref_plan, port_roaring._mask_plan(blob))


def _assert_plans_equal(ref_plan, port_plan):
    """The port's lanes equal the reference's, its container offsets
    expanded to the reference's word positions."""
    bit_idx, bm_words, bm_base, n_words = port_plan
    assert bm_base.dtype == np.int64
    bm_pos = (bm_base[:, None] + np.arange(BITMAP_WORDS)).reshape(-1)
    for r, p in zip(ref_plan, (bit_idx, bm_words, bm_pos, n_words)):
        assert np.array_equal(np.asarray(r), np.asarray(p))
        assert np.asarray(r).dtype == np.asarray(p).dtype


def _run_blob32(containers):
    """A 32-bit roaring blob with a run bitset. containers: list of
    (key, kind, payload): kind 'run' with (start, length - 1) pairs,
    'array' with values, 'bitmap' with values."""
    n = len(containers)
    out = struct.pack("<I", ((n - 1) << 16) | 12347)
    flags = 0
    for i, (_, kind, _) in enumerate(containers):
        if kind == "run":
            flags |= 1 << i
    out += flags.to_bytes((n + 7) // 8, "little")
    bodies = []
    for key, kind, payload in containers:
        if kind == "run":
            card = sum(length + 1 for _, length in payload)
            body = struct.pack("<H", len(payload)) + b"".join(
                struct.pack("<HH", s, length) for s, length in payload)
        elif kind == "array":
            card = len(payload)
            body = np.asarray(payload, "<u2").tobytes()
        else:
            card = len(payload)
            bits = np.zeros(65536, np.uint8)
            bits[np.asarray(payload)] = 1
            body = np.packbits(bits, bitorder="little").tobytes()
        out += struct.pack("<HH", key, card - 1)
        bodies.append(body)
    if n >= 4:
        pos = len(out) + 4 * n
        for b in bodies:
            out += struct.pack("<i", pos)
            pos += len(b)
    return out + b"".join(bodies)


def _delta_blob(buckets):
    out = struct.pack("<i", 1681511377) + struct.pack("<q", len(buckets))
    for key, blob32 in buckets:
        out += struct.pack("<I", key) + blob32
    return out


RUN_BLOBS = {
    "one_run": _delta_blob([(0, _run_blob32([(0, "run", [(10, 9)])]))]),
    "runs_and_arrays": _delta_blob([(0, _run_blob32([
        (0, "run", [(0, 0), (5, 99), (65000, 535)]),
        (2, "array", [1, 7, 65535]),
        (3, "run", [(0, 65535)]),
    ]))]),
    "with_offsets": _delta_blob([(0, _run_blob32([
        (0, "array", [3, 4, 5]),
        (1, "run", [(100, 4000), (9000, 2)]),
        (4, "bitmap", list(range(0, 65536, 7))),
        (9, "run", [(65535, 0)]),
        (11, "array", [0]),
    ]))]),
    "two_buckets": _delta_blob([
        (0, _run_blob32([(7, "run", [(1, 1)])])),
        (2, _run_blob32([(0, "run", [(0, 9)]), (1, "array", [5])])),
    ]),
}


@pytest.mark.parametrize("name", sorted(RUN_BLOBS))
def test_run_containers_decode_equal(name):
    blob = RUN_BLOBS[name]
    want = RefBitmap.deserialize_delta(blob).values
    assert len(want)
    assert np.array_equal(PortBitmap.deserialize_delta(blob).values, want)
    for n in (1, 1000, 200_000):
        mask, card = port_roaring.decode_delta_mask(blob, n, CPU)
        assert np.array_equal(mask, RefBitmap.deserialize_delta(blob)
                              .to_mask(n))
        assert card == len(want)
    ref_plan = ref_roaring._mask_plan(blob)
    if ref_plan is not None:
        _assert_plans_equal(ref_plan, port_roaring._mask_plan(blob))
    # re-serialized, the set takes the writer's array/bitmap form
    assert PortBitmap(want).serialize_delta(CPU) == \
        RefBitmap(want).serialize_delta()


def _pad(n: int) -> int:
    return max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))


@pytest.mark.parametrize("seed,n_containers,n_bits", [
    (0, 1, 0), (1, 1, 1), (2, 1, 5000), (3, 3, 70000), (4, 8, 200_000)])
def test_pack_plain_matches_reference_body(seed, n_containers, n_bits):
    rng = np.random.default_rng(seed)
    flat = rng.choice(n_containers * 65536, n_bits, replace=False)
    n_words = n_containers * BITMAP_WORDS
    n_pad = _pad(n_bits)
    lane = np.full(n_pad, n_words * 32, np.int64)  # the sentinel drops
    lane[:n_bits] = flat
    with jax.enable_x64(True):
        want = np.asarray(ref_stats._pack_fn_cached(n_pad, n_words)(lane))
    got = pack_bitmap_words_plain(torch.from_numpy(lane), n_containers)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(pack_bitmap_words(torch.from_numpy(lane),
                                         n_containers), got)


@pytest.mark.parametrize("seed,n_words,n_containers", [
    (0, 1, 0), (1, 33, 1), (2, 2048, 0), (3, 10_000, 2), (4, 10_000, 5)])
def test_decode_plain_matches_reference_body(seed, n_words, n_containers):
    rng = np.random.default_rng(seed)
    n_bits = n_words * 32
    # bitmap containers (the last one past the end, its words dropping)
    # and indexes in the words no container covers, so that the
    # reference's add is an OR
    total = -(-n_words // BITMAP_WORDS)
    base = np.sort(rng.choice(total, n_containers, replace=False))
    base = np.append(base, total) * BITMAP_WORDS
    covered = (base[:-1, None] + np.arange(BITMAP_WORDS)).reshape(-1)
    free = np.setdiff1d(np.arange(n_words), covered)
    idx = rng.choice(free * 32, len(free) // 2, replace=False) \
        + rng.integers(0, 32, len(free) // 2)
    words = rng.integers(0, 1 << 32, len(base) * BITMAP_WORDS,
                         dtype=np.uint32)
    words[::3] |= np.uint32(1 << 31)
    pos = (base[:, None] + np.arange(BITMAP_WORDS)).reshape(-1)
    i_pad, w_pad = _pad(len(idx) + 2), _pad(len(pos) + 2)
    lane_idx = np.full(i_pad, n_bits, np.int64)
    lane_idx[:len(idx)] = idx
    lane_w = np.zeros(w_pad, np.uint32)
    lane_w[:len(pos)] = words
    lane_p = np.full(w_pad, n_words, np.int32)   # the sentinel position
    lane_p[:len(pos)] = np.minimum(pos, n_words)
    with jax.enable_x64(True):
        want = np.asarray(ref_stats._decode_fn_cached(i_pad, w_pad, n_words)(
            lane_idx, lane_w, lane_p))
    args = (torch.from_numpy(lane_idx), torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(base.astype(np.int32)), n_words)
    got = decode_mask_words_plain(*args)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(decode_mask_words(*args), got)


def test_plain_ors_repeated_bits_and_drops_out_of_range():
    idx = torch.tensor([0, 0, 31, 32, 63, 64, -1, 1 << 40])
    words = torch.zeros(2 * BITMAP_WORDS, dtype=torch.int32)
    words[0], words[2] = 5, 4
    words[BITMAP_WORDS] = -1     # a container wholly past the end
    base = torch.tensor([0, 2], dtype=torch.int32)
    got = decode_mask_words_plain(idx, words, base, 2)
    want = np.array([1 | (1 << 31) | 5, 1 | (1 << 31)], np.uint32)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_wrappers_on_the_cpu_launch_nothing_and_check_their_lanes():
    before = dict(obs.counters())
    pack_bitmap_words(torch.tensor([1, 2, 70000]), 2)
    decode_mask_words(torch.tensor([3]), torch.zeros(0, dtype=torch.int32),
                      torch.zeros(0, dtype=torch.int32), 1)
    after = obs.counters()
    for k in ("kernel.dv_bits.pack_launches",
              "kernel.dv_bits.decode_launches"):
        assert after.get(k, 0) == before.get(k, 0)
    with pytest.raises(ValueError):
        decode_mask_words(torch.tensor([3], dtype=torch.int32),
                          torch.zeros(0, dtype=torch.int32),
                          torch.zeros(0, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        decode_mask_words(torch.tensor([3]), torch.zeros(2, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        decode_mask_words(torch.tensor([3]), torch.zeros(0, dtype=torch.int32),
                          torch.zeros(0, dtype=torch.int32), 1 << 31)


def test_a_bit_past_2_31_decodes_with_its_cardinality():
    values = np.array([0, 5, 1 << 31, (1 << 31) + 7, 3 << 40], np.uint64)
    blob = PortBitmap(values).serialize_delta(CPU)
    assert ref_roaring._mask_plan(blob) is None  # the reference declines
    mask, card = port_roaring.decode_delta_mask(blob, 100, CPU)
    assert card == 5
    assert np.flatnonzero(mask).tolist() == [0, 5]
    desc = {"storageType": "i", "sizeInBytes": len(blob), "cardinality": 5,
            "pathOrInlineDv": base64.b85encode(blob).decode("ascii")}
    eng = TorchEngine("cpu")
    assert np.array_equal(
        port_desc.load_deletion_vector_mask(eng, "/t", desc, 100),
        ref_desc.load_deletion_vector_mask(HostEngine(), "/t", desc, 100))
    assert np.array_equal(port_desc.load_deletion_vector(eng, "/t", desc),
                          ref_desc.load_deletion_vector(HostEngine(), "/t",
                                                        desc))


def test_uuid_paths_equal():
    u = uuid.UUID(int=0x0123456789ABCDEF0123456789ABCDEF)
    enc = port_desc.encode_uuid_base85(u)
    assert enc == ref_desc.encode_uuid_base85(u) and len(enc) == 20
    assert port_desc.decode_uuid_base85(enc) == u
    for row in ({"storageType": "u", "pathOrInlineDv": "ab" + enc},
                {"storageType": "u", "pathOrInlineDv": enc},
                {"storageType": "p", "pathOrInlineDv": "/x/y.bin"}):
        assert port_desc.absolute_dv_path("/t", row) == \
            ref_desc.absolute_dv_path("/t", row)


def test_prefixed_dv_file_of_another_writer_reads(tmp_path):
    """A 'u' descriptor with a random prefix (Spark's writers set one;
    this package writes none) resolves into the prefix's folder."""
    values = SETS["mixed"]
    (d,) = ref_desc.write_deletion_vector_file(
        HostEngine(), str(tmp_path), [RefBitmap(values)], random_prefix="q7")
    row = d.to_dict()
    assert row["pathOrInlineDv"].startswith("q7")
    assert (tmp_path / "q7").is_dir()
    eng = TorchEngine("cpu")
    assert np.array_equal(port_desc.load_deletion_vector(eng, str(tmp_path),
                                                         row),
                          np.unique(np.asarray(values, np.uint64)))
    assert np.array_equal(
        port_desc.load_deletion_vector_mask(eng, str(tmp_path), row, 500_000),
        RefBitmap(values).to_mask(500_000))


def _write_both(tmp_path, sets):
    """One DV file per package holding `sets`; returns (ref descriptors,
    port descriptors)."""
    ref = ref_desc.write_deletion_vector_file(
        HostEngine(), str(tmp_path / "ref"), [RefBitmap(s) for s in sets])
    port = port_desc.write_deletion_vector_file(
        TorchEngine("cpu"), str(tmp_path / "port"),
        [PortBitmap(s) for s in sets])
    return ref, port


def test_dv_files_cross_read(tmp_path):
    sets = [SETS["mixed"], SETS["array_only"], SETS["one"], SETS["empty"]]
    ref, port = _write_both(tmp_path, sets)
    files = {p: open(next((tmp_path / p).glob("*.bin")), "rb").read()
             for p in ("ref", "port")}
    assert files["ref"] == files["port"]  # one layout, equal blobs
    for r, p, s in zip(ref, port, sets):
        assert (r.offset, r.sizeInBytes, r.cardinality) == \
            (p.offset, p.sizeInBytes, p.cardinality)
        n = 400_000
        want = RefBitmap(s).to_mask(n)
        for eng_ref, eng_port, root, d in (
                (HostEngine(), TorchEngine("cpu"), "ref", r),
                (HostEngine(), TorchEngine("cpu"), "port", p)):
            row = d.to_dict()
            path = str(tmp_path / root)
            assert np.array_equal(ref_desc.load_deletion_vector_mask(
                eng_ref, path, row, n), want)
            assert np.array_equal(port_desc.load_deletion_vector_mask(
                eng_port, path, row, n), want)
            assert np.array_equal(port_desc.load_deletion_vector(
                eng_port, path, row), np.unique(np.asarray(s, np.uint64)))
    assert port_desc.inline_descriptor(PortBitmap(sets[0]), CPU).to_dict() \
        == ref_desc.inline_descriptor(RefBitmap(sets[0])).to_dict()


def _errors(tmp_path):
    """(name, descriptor row) pairs that each package must refuse."""
    ref, _ = _write_both(tmp_path, [SETS["mixed"]])
    good = ref[0].to_dict()
    path = next((tmp_path / "ref").glob("*.bin"))
    data = bytearray(open(path, "rb").read())
    blob_at = good["offset"] + 4
    data_crc = bytearray(data)
    data_crc[blob_at + 20] ^= 0xFF
    blob = RefBitmap(SETS["mixed"]).serialize_delta()
    magic = struct.pack("<i", 7) + blob[4:]
    cookie = blob[:16] + struct.pack("<i", 999) + blob[20:]

    def inline(b, **kw):
        row = {"storageType": "i", "sizeInBytes": len(b),
               "cardinality": len(np.unique(SETS["mixed"])),
               "pathOrInlineDv": base64.b85encode(b).decode("ascii")}
        row.update(kw)
        return row

    return data_crc, path, [
        ("crc", dict(good)),
        ("size", dict(good, sizeInBytes=good["sizeInBytes"] + 1)),
        ("cardinality", dict(good, cardinality=good["cardinality"] - 1)),
        ("inline_size", inline(blob, sizeInBytes=len(blob) - 1)),
        ("inline_cardinality", inline(blob, cardinality=3)),
        ("magic", inline(magic)),
        ("cookie", inline(cookie)),
    ]


@pytest.mark.parametrize("case", ["crc", "size", "cardinality",
                                  "inline_size", "inline_cardinality",
                                  "magic", "cookie"])
def test_descriptor_errors_match(tmp_path, case):
    data_crc, path, cases = _errors(tmp_path)
    row = dict(cases)[case]
    if case == "crc":
        with open(path, "wb") as f:
            f.write(bytes(data_crc))
    root = str(tmp_path / "ref")
    for ref_fn, port_fn in (
            (lambda: ref_desc.load_deletion_vector_mask(
                HostEngine(), root, row, 10),
             lambda: port_desc.load_deletion_vector_mask(
                 TorchEngine("cpu"), root, row, 10)),
            (lambda: ref_desc.load_deletion_vector(HostEngine(), root, row),
             lambda: port_desc.load_deletion_vector(
                 TorchEngine("cpu"), root, row))):
        with pytest.raises(RefDeltaError) as r:
            ref_fn()
        with pytest.raises(DeletionVectorError) as p:
            port_fn()
        assert p.value.error_class == r.value.error_class


def test_inline_has_no_path():
    row = {"storageType": "i", "pathOrInlineDv": "xyz"}
    with pytest.raises(RefDeltaError) as r:
        ref_desc.absolute_dv_path("/t", row)
    with pytest.raises(DeletionVectorError) as p:
        port_desc.absolute_dv_path("/t", row)
    assert p.value.error_class == r.value.error_class \
        == "DELTA_CANNOT_RECONSTRUCT_PATH_FROM_URI"


# ------------------------------------------------ the batched K8 (tiles)


def _gap_set():
    """Containers in windows 0 and 2 of bucket 0, window 1 empty."""
    rng = np.random.default_rng(3)
    return np.concatenate([rng.choice(65536, 5000, replace=False),
                           (2 << 16) + rng.choice(65536, 40, replace=False)])


def _pool(n_dvs: int, seed: int = 0):
    """`n_dvs` DV blobs drawn from array, bitmap and run containers, an
    empty window between containers, a bucket above 0 and a bit past
    2^31, with the row counts of their files (some ending inside a
    container, one at 0)."""
    sets = [SETS[k] for k in ("mixed", "array_only", "bitmap_only",
                              "high_bucket", "one", "empty", "bit_31",
                              "full_container")] + [_gap_set()]
    kinds = [PortBitmap(np.asarray(s).astype(np.uint64)).serialize_delta(CPU)
             for s in sets] + [RUN_BLOBS[k] for k in sorted(RUN_BLOBS)]
    rng = np.random.default_rng(seed)
    picks = rng.permutation(np.resize(np.arange(len(kinds)), n_dvs))
    rows = rng.choice([1, 1000, 65_536, 70_001, 131_073, 200_000, 300_000],
                      n_dvs)
    if n_dvs > 1:
        rows[-1] = 0
    return [kinds[i] for i in picks], [int(r) for r in rows]


def _reference_words(blob: bytes, n_words: int) -> np.ndarray:
    """The reference's `_decode_fn_cached` body on a blob's lanes over
    `n_words` words (past 2^26 words its wrapper declines the device and
    expands on the host: the body then takes the values below the words
    as indexes)."""
    plan = ref_roaring._mask_plan(blob)
    if plan is None:
        idx = RefBitmap.deserialize_delta(blob).values.astype(np.int64)
        words, pos = np.empty(0, np.uint32), np.empty(0, np.int64)
    else:
        idx, words, pos, _ = plan
    idx = idx[idx < n_words * 32]
    i_pad, w_pad = _pad(len(idx) + 1), _pad(len(words) + 1)
    lane_idx = np.full(i_pad, n_words * 32, np.int64)
    lane_idx[:len(idx)] = idx
    lane_w = np.zeros(w_pad, np.uint32)
    lane_w[:len(words)] = words
    lane_p = np.full(w_pad, n_words, np.int32)
    lane_p[:len(pos)] = np.minimum(pos, n_words)
    with jax.enable_x64(True):
        return np.asarray(ref_stats._decode_fn_cached(i_pad, w_pad, n_words)(
            lane_idx, lane_w, lane_p))


@pytest.mark.parametrize("n_dvs", [1, 7, 50])
def test_batched_tiles_plain_equals_reference_body_per_dv(n_dvs):
    """One batch's tiles through `dv_tiles_plain`: each DV's segment (at
    a 16-byte aligned start) equals the reference body's words for that
    DV alone, and the tiles cover every output word once."""
    blobs, rows = _pool(n_dvs, seed=n_dvs)
    tiles, lows, bm, n_words, segs = port_roaring._plan(blobs, rows)
    cover = np.zeros(n_words, np.int64)
    for off, valid, *_ in tiles.tolist():
        cover[off:off + valid] += 1
    assert (cover == 1).all()
    got = dv_tiles_plain(*(torch.from_numpy(a) for a in (tiles, lows, bm)),
                         n_words).numpy().view(np.uint32)
    for blob, (start, n_w, n, _) in zip(blobs, segs):
        assert start % 4 == 0 and n_w == -(-n // 32)
        assert np.array_equal(got[start:start + n_w],
                              _reference_words(blob, n_w))


@pytest.mark.parametrize("n_dvs", [1, 3, 7])
def test_batched_pack_equals_reference_body_per_dv(monkeypatch, n_dvs):
    """`serialize_deltas` packs every bitmap container of a batch in one
    call of K8's wrapper: each 32-bit bucket's containers equal the
    reference body `_pack_fn_cached` on that bucket's bits, and every blob
    equals the reference's bytes."""
    keys = ["bitmap_only", "mixed", "high_bucket", "full_container",
            "array_only", "one", "empty"]
    sets = [np.asarray(SETS[keys[i % len(keys)]]).astype(np.uint64)
            for i in range(n_dvs)]
    calls, launch = [], port_roaring.dv_tiles

    def spy(*args, **kw):
        calls.append((args, kw, launch(*args, **kw)))
        return calls[-1][2]

    monkeypatch.setattr(port_roaring, "dv_tiles", spy)
    blobs = port_roaring.serialize_deltas([PortBitmap(s) for s in sets], CPU)
    assert blobs == [RefBitmap(s).serialize_delta() for s in sets]
    assert len(calls) == 1 and calls[0][1] == {"pack": True}
    words = calls[0][2].numpy().view(np.uint32).reshape(-1, BITMAP_WORDS)
    c = 0
    for s in sets:
        v = np.unique(s)
        for bucket in np.unique(v >> np.uint64(32)):
            low = (v[(v >> np.uint64(32)) == bucket]
                   & np.uint64(0xFFFFFFFF)).astype(np.int64)
            high, counts = np.unique(low >> 16, return_counts=True)
            dense = counts > 4096
            if not dense.any():
                continue
            flat = np.concatenate([
                r * 65536 + (low[(low >> 16) == h] & 0xFFFF)
                for r, h in enumerate(high[dense])])
            n_c = int(dense.sum())
            lane = np.full(_pad(len(flat)), n_c * 65536, np.int64)
            lane[:len(flat)] = flat
            with jax.enable_x64(True):
                want = np.asarray(ref_stats._pack_fn_cached(
                    len(lane), n_c * BITMAP_WORDS)(lane))
            assert np.array_equal(words[c:c + n_c].reshape(-1), want)
            c += n_c
    assert c == len(words)


def _batch_rows(tmp_path):
    """A DV file the reference writes (several DVs) and an inline DV with
    bits past 2^31, each with a file row count: [(descriptor row, n)]."""
    sets = [SETS["mixed"], SETS["array_only"], SETS["bitmap_only"],
            SETS["high_bucket"], SETS["empty"], _gap_set()]
    descs = ref_desc.write_deletion_vector_file(
        HostEngine(), str(tmp_path), [RefBitmap(s) for s in sets])
    past = np.array([0, 5, 1 << 31, (1 << 31) + 7, 3 << 40], np.uint64)
    blob = PortBitmap(past).serialize_delta(CPU)
    inline = {"storageType": "i", "sizeInBytes": len(blob), "cardinality": 5,
              "pathOrInlineDv": base64.b85encode(blob).decode("ascii")}
    ns = [70_001, 1_000_000, 196_608, 300_000, 10, 131_073]
    return [(d.to_dict(), n) for d, n in zip(descs, ns)] + [(inline, 100)]


def test_batched_masks_equal_reference_loads(tmp_path):
    """`load_deletion_vector_masks` on a batch equals the reference's
    `load_deletion_vector_mask` per descriptor (the bit past 2^31 with
    its cardinality among them), reading the shared DV file once."""
    rows = _batch_rows(tmp_path)
    eng = TorchEngine("cpu")
    reads = []
    read_file = eng.fs.read_file
    eng.fs.read_file = lambda p: reads.append(p) or read_file(p)
    got = port_desc.load_deletion_vector_masks(eng, str(tmp_path), rows)
    assert len(reads) == 1
    for (d, n), mask in zip(rows, got):
        assert np.array_equal(mask, ref_desc.load_deletion_vector_mask(
            HostEngine(), str(tmp_path), d, n))
    masks = port_roaring.decode_delta_masks(
        [port_desc._load_blob(eng, str(tmp_path), d)[0] for d, _ in rows],
        [n for _, n in rows], CPU)
    assert [c for _, c in masks] == [d["cardinality"] for d, _ in rows]


@pytest.mark.parametrize("case", ["crc", "cardinality"])
def test_a_bad_descriptor_inside_a_batch_raises_the_reference_error(
        tmp_path, case):
    rows = _batch_rows(tmp_path)
    bad = rows[2][0]
    if case == "crc":
        path = next(tmp_path.glob("*.bin"))
        data = bytearray(path.read_bytes())
        data[bad["offset"] + 4 + 30] ^= 0xFF
        path.write_bytes(bytes(data))
    else:
        rows[2] = (dict(bad, cardinality=bad["cardinality"] + 1), rows[2][1])
    with pytest.raises(RefDeltaError) as r:
        ref_desc.load_deletion_vector_mask(HostEngine(), str(tmp_path),
                                           rows[2][0], rows[2][1])
    with pytest.raises(DeletionVectorError) as p:
        port_desc.load_deletion_vector_masks(TorchEngine("cpu"),
                                             str(tmp_path), rows)
    assert p.value.error_class == r.value.error_class


def test_plain_tiles_clamp_and_refuse_what_the_kernel_does():
    """Tile fields outside their ranges clamp as the kernel clamps them;
    the plain version takes CPU tensors only, and the wrapper checks
    its inputs' types and shapes."""
    tiles = torch.tensor([[0, 5000, 9, -3, 2], [2048, 4, -1, 1, 99],
                          [-4, 4, 0, 0, 1], [4000, 4, 0, 0, 1]],
                         dtype=torch.int32)
    lows = torch.tensor([0, 33, 200, -1], dtype=torch.int16)  # -1: 65535
    got = dv_tiles_plain(tiles, lows, torch.full((1, BITMAP_WORDS), 7,
                                                 dtype=torch.int32), 2052)
    want = np.zeros(2052, np.uint32)
    want[0], want[1] = 1, 2          # lows 0 and 33 (the bitmap index 9
    want[2048 + 1] = 2               # is out of range: none); low 33 again
    assert np.array_equal(got.numpy().view(np.uint32), want)
    for bad in ((tiles.to(torch.int64), lows), (tiles, lows.to(torch.int32)),
                (tiles[:, :4], lows)):
        with pytest.raises(ValueError):
            dv_tiles(*bad, torch.zeros((0, BITMAP_WORDS), dtype=torch.int32),
                     2052)

"""The port's window field extraction against the JAX package's.

Every lane and `window_ok` of `delta_tpu_torch.ops.json_parse.parse_lanes`
against `delta_tpu.ops.json_parse._parse_fn_cached(n_pad, l_pad, False)`
under `jax.enable_x64(True)` (the wrapped entry point does not run under
the installed jax). Inputs are padded the reference's way: `pad_bucket`,
then `_TAIL_PAD` bytes of 0x20. All lanes are integer or bool: exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_tpu.ops.json_parse import _TAIL_PAD, _parse_fn_cached
from delta_tpu.ops.replay import pad_bucket
from delta_tpu_torch.interop import lanes_to_numpy
from delta_tpu_torch.ops.json_parse import TAIL_PAD, parse_lanes


def _d(obj) -> str:
    return json.dumps(obj, separators=(",", ":"))


def _bench_add(i: int) -> str:
    # bench.py's line shape, stats escaped inside the JSON string
    p = f"part-{i:010d}-{i * 7919:016x}.parquet"
    return (f'{{"add":{{"path":"{p}","partitionValues":{{}},'
            f'"size":1048576,"modificationTime":{i},"dataChange":true,'
            f'"stats":"{{\\"numRecords\\":1000,'
            f'\\"minValues\\":{{\\"x\\":{i}}},'
            f'\\"maxValues\\":{{\\"x\\":{i + 1}}},'
            f'\\"nullCount\\":{{\\"x\\":0}}}}"}}}}')


_MIXED = [
    '{"protocol":{"minReaderVersion":1,"minWriterVersion":2}}',
    _d({"metaData": {"id": "m", "format": {"provider": "parquet",
                                           "options": {}},
                     "schemaString": "{}", "partitionColumns": [],
                     "configuration": {}}}),
    _d({"commitInfo": {"timestamp": 5, "operation": "WRITE"}}),
    _d({"txn": {"appId": "app", "version": 3}}),
    _bench_add(1),
    _bench_add(2),
    '{"remove":{"path":"part-0000000001-0000000000001eef.parquet",'
    '"deletionTimestamp":7,"dataChange":true}}',
    # escapes: quote, backslash, unicode; percent-encoded path
    _d({"add": {"path": 'q"uo\\te', "partitionValues": {}, "size": 1,
                "modificationTime": 2, "dataChange": True}}),
    _d({"add": {"path": "café", "partitionValues": {}, "size": 1,
                "modificationTime": 2, "dataChange": False}}),
    '{"add":{"path":"uni\\u00e9","partitionValues":{},"size":1,'
    '"modificationTime":2,"dataChange":true}}',
    _d({"add": {"path": "a%20b%3Ac", "partitionValues": {}, "size": 9,
                "modificationTime": 2, "dataChange": True}}),
    # negative and 18-digit numerics (simple); 19 digits (complex)
    _d({"remove": {"path": "neg", "deletionTimestamp": -42,
                   "dataChange": False, "extendedFileMetadata": True,
                   "size": 123456789012345678}}),
    _d({"remove": {"path": "big", "deletionTimestamp": 1234567890123456789,
                   "dataChange": True}}),
    # complex lines: deletion vector, tags, partition values, unknown key
    _d({"add": {"path": "dv", "partitionValues": {}, "size": 1,
                "modificationTime": 2, "dataChange": True,
                "deletionVector": {"storageType": "u", "pathOrInlineDv": "ab",
                                   "offset": 1, "sizeInBytes": 3,
                                   "cardinality": 2}}}),
    _d({"add": {"path": "tagged", "partitionValues": {}, "size": 1,
                "modificationTime": 2, "dataChange": True,
                "tags": {"k": "v"}}}),
    _d({"add": {"path": "part", "partitionValues": {"d": "1"}, "size": 1,
                "modificationTime": 2, "dataChange": True}}),
    _d({"add": {"path": "odd", "partitionValues": {}, "size": 1,
                "modificationTime": 2, "dataChange": True,
                "baseRowId": 4}}),
    # a duplicated key; a non-compact line (whitespace between tokens)
    '{"add":{"path":"d1","path":"d2","size":1,"modificationTime":2,'
    '"dataChange":true}}',
    '{"add": {"path": "spaced", "size": 1}}',
    "",
]

CORPUS = {
    "mixed": _MIXED,
    "bench": ['{"protocol":{"minReaderVersion":1,"minWriterVersion":2}}']
    + [_bench_add(i) for i in range(8)],
    "odd_quotes": [_bench_add(1), '{"add":{"path":"unterminated}}',
                   _bench_add(2)],
    "unbalanced": [_bench_add(1), '{"add":{"path":"x","size":1}',
                   _bench_add(2)],
    "negative_depth": [_bench_add(1), '}{"add":{"path":"x"}}',
                       _bench_add(2)],
}


def _window(lines):
    win = np.frombuffer(("\n".join(lines) + "\n").encode(), np.uint8).copy()
    return win, int(np.count_nonzero(win == 10))


def _reference(win, n_lines):
    n_pad, l_pad = pad_bucket(len(win)), pad_bucket(n_lines + 1)
    lane_bytes = np.full(n_pad + _TAIL_PAD, 0x20, np.uint8)
    lane_bytes[:len(win)] = win
    with jax.enable_x64(True):
        vals, spans, flags, ok = _parse_fn_cached(n_pad, l_pad, False)(
            jnp.asarray(lane_bytes), np.int32(n_lines))
        ref = lanes_to_numpy(torch.from_numpy(np.array(vals)),
                             torch.from_numpy(np.array(spans)),
                             torch.from_numpy(np.array(flags)), n_lines)
        return ref, bool(ok), lane_bytes, n_pad, l_pad


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_lanes_match_reference_on_padded_input(name):
    win, n_lines = _window(CORPUS[name])
    ref, ref_ok, lane_bytes, n_pad, l_pad = _reference(win, n_lines)
    vals, spans, flags, ok = parse_lanes(torch.from_numpy(lane_bytes),
                                         n_pad, n_lines, l_pad)
    got = lanes_to_numpy(vals, spans, flags, n_lines)
    assert bool(ok) == ref_ok
    assert sorted(got) == sorted(ref)
    for lane in ref:
        np.testing.assert_array_equal(got[lane], ref[lane], err_msg=lane)
        assert got[lane].dtype == ref[lane].dtype, lane


@pytest.mark.parametrize("name", ["mixed", "bench"])
def test_unpadded_window_gives_the_same_lanes(name):
    """The production call (no bucket padding, n_lines + 1 segments)
    agrees with the reference on every real line."""
    win, n_lines = _window(CORPUS[name])
    ref, ref_ok, *_ = _reference(win, n_lines)
    bx = torch.from_numpy(np.concatenate(
        [win, np.full(TAIL_PAD, 0x20, np.uint8)]))
    vals, spans, flags, ok = parse_lanes(bx, len(win), n_lines)
    assert bool(ok) and ref_ok
    got = lanes_to_numpy(vals, spans, flags, n_lines)
    for lane in ref:
        np.testing.assert_array_equal(got[lane], ref[lane], err_msg=lane)


def test_corpus_exercises_the_ladder():
    """The mixed window holds simple and complex file lines; the broken
    windows fail the structural checks."""
    win, n_lines = _window(CORPUS["mixed"])
    ref, ok, *_ = _reference(win, n_lines)
    filerow = ref["is_add"] | ref["is_remove"]
    assert ok
    assert (filerow & ref["complex"]).sum() >= 5
    assert (filerow & ~ref["complex"]).sum() >= 8
    assert ref["path_esc"].sum() >= 2 and ref["stats_esc"].sum() >= 2
    for name in ("odd_quotes", "unbalanced", "negative_depth"):
        assert not _reference(*_window(CORPUS[name]))[1], name
    with pytest.raises(ValueError):
        parse_lanes(torch.zeros(10, dtype=torch.uint8), 10, 1)

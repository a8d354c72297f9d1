"""Zstandard, the codec of ZSTD data pages and checkpoint parts.

`decompress` calls the decoder in the host library built from
`csrc/parquet_host.cpp` (RFC 8878, without dictionaries): the counterpart
of Arrow's `pa.Codec("zstd")` in the JAX package's page reader
(`delta_tpu/log/page_decode.py`). The card's machine has no zstd library.
"""

from __future__ import annotations

import ctypes

import numpy as np

from delta_tpu_torch.log.parquet_footer import DecodeCorrupt, DecodeUnsupported
from delta_tpu_torch.ops import cuda_build

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_NEEDS_DICTIONARY = -2


def decompress(raw: bytes, expected: int) -> bytes:
    """Decompress the Zstandard frames of one page payload, `expected`
    bytes in all; raises DecodeCorrupt when a frame is damaged or the
    frames hold another length, DecodeUnsupported when one needs a
    dictionary."""
    src = np.frombuffer(raw, np.uint8)
    dst = np.empty(max(expected, 1), np.uint8)
    fn = cuda_build.function("parquet_host", "zstd_decompress",
                             [_P, _I64, _P, _I64], restype=_I64)
    got = fn(src.ctypes.data, src.size, dst.ctypes.data, expected)
    if got == _NEEDS_DICTIONARY:
        raise DecodeUnsupported("a ZSTD frame that needs a dictionary")
    if got != expected:
        raise DecodeCorrupt(
            f"corrupt ZSTD page ({got} of {expected} bytes)")
    return dst[:expected].tobytes()

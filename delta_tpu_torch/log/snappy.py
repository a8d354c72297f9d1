"""Snappy, the codec of every checkpoint part a Delta writer produces.

`decompress` and `compress` call the host library built from
`csrc/parquet_host.cpp` (the counterpart of Arrow's `pa.Codec("snappy")`
in the JAX package's page reader). `decompress_py` is the same format
read in plain Python: the twin that the tests hold the C decoder to.
"""

from __future__ import annotations

import ctypes

import numpy as np

from delta_tpu_torch.log.parquet_footer import DecodeCorrupt
from delta_tpu_torch.ops import cuda_build

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _fn(symbol, argtypes):
    return cuda_build.function("parquet_host", symbol, argtypes,
                               restype=ctypes.c_longlong)


def decompress(raw: bytes, expected: int) -> bytes:
    """Decompress one snappy page payload of `expected` bytes; raises
    DecodeCorrupt when the stream is corrupt or of another length."""
    src = np.frombuffer(raw, np.uint8)
    dst = np.empty(max(expected, 1), np.uint8)
    got = _fn("snappy_decompress", [_P, _I64, _P, _I64])(
        src.ctypes.data, src.size, dst.ctypes.data, expected)
    if got != expected:
        raise DecodeCorrupt(
            f"corrupt snappy page ({got} of {expected} bytes)")
    return dst[:expected].tobytes()


def compress(data: bytes) -> bytes:
    """Greedy snappy compression (any snappy decoder reads it)."""
    src = np.frombuffer(data, np.uint8)
    cap = _fn("snappy_max_compressed_length", [_I64])(src.size)
    dst = np.empty(cap, np.uint8)
    n = _fn("snappy_compress", [_P, _I64, _P])(
        src.ctypes.data, src.size, dst.ctypes.data)
    return dst[:n].tobytes()


def decompress_py(raw: bytes) -> bytes:
    """The snappy format in plain Python: a varint length, then literals
    and back-references (1-, 2- or 4-byte offsets)."""
    pos = 0
    length = 0
    shift = 0
    while True:
        b = raw[pos]
        pos += 1
        length |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while pos < len(raw):
        tag = raw[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            n = tag >> 2
            if n >= 60:
                nb = n - 59
                n = int.from_bytes(raw[pos:pos + nb], "little")
                pos += nb
            n += 1
            out += raw[pos:pos + n]
            pos += n
            continue
        if kind == 1:
            n = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | raw[pos]
            pos += 1
        else:
            nb = 2 if kind == 2 else 4
            n = (tag >> 2) + 1
            off = int.from_bytes(raw[pos:pos + nb], "little")
            pos += nb
        if off == 0 or off > len(out):
            raise DecodeCorrupt("corrupt snappy back-reference")
        for _ in range(n):  # byte by byte: a copy may overlap its output
            out.append(out[-off])
    if len(out) != length:
        raise DecodeCorrupt(
            f"snappy stream gave {len(out)} of {length} bytes")
    return bytes(out)

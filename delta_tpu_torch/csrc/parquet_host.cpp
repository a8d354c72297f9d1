// Host-side Parquet helpers for the checkpoint reader and the synthetic
// checkpoint writer, with a plain C interface bound by ctypes
// (`delta_tpu_torch/log/parquet_host.py`).
//
// The JAX package reads checkpoints through Arrow, whose C++ does this
// work: snappy page decompression and the walk over PLAIN BYTE_ARRAY
// values (a 4-byte length, then the bytes: sequential by nature). The
// card's machine has no Arrow, so the port brings its own. This is host
// code in the reference too; it is not a device kernel.
//
// Built by `ops/cuda_build.py` with the host compiler
// (`c++ -std=c++17 -O2 -shared -fPIC`), at first use.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Little-endian base-128 varint at src[*pos]; -1 when it runs off the end
// or exceeds 32 bits (snappy lengths are 32-bit).
int64_t read_varint32(const uint8_t* src, int64_t n, int64_t* pos) {
  uint64_t v = 0;
  for (int shift = 0; shift <= 28; shift += 7) {
    if (*pos >= n) return -1;
    uint8_t b = src[(*pos)++];
    v |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) return v <= 0xffffffffull ? static_cast<int64_t>(v) : -1;
  }
  return -1;
}

uint8_t* emit_literal(uint8_t* op, const uint8_t* s, int64_t len) {
  int64_t n = len - 1;  // len >= 1
  if (n < 60) {
    *op++ = static_cast<uint8_t>(n << 2);
  } else {
    int nb = n < (1 << 8) ? 1 : n < (1 << 16) ? 2 : n < (1 << 24) ? 3 : 4;
    *op++ = static_cast<uint8_t>((59 + nb) << 2);
    for (int k = 0; k < nb; ++k) *op++ = static_cast<uint8_t>(n >> (8 * k));
  }
  memcpy(op, s, len);
  return op + len;
}

// Copies of at most 64 bytes each; the caller keeps offsets below 65536.
uint8_t* emit_copy(uint8_t* op, int64_t off, int64_t len) {
  while (len > 0) {
    int64_t l = len > 64 ? 64 : len;
    if (l >= 4 && l <= 11 && off < 2048) {
      *op++ = static_cast<uint8_t>(1 | ((l - 4) << 2) | ((off >> 8) << 5));
      *op++ = static_cast<uint8_t>(off & 0xff);
    } else {
      *op++ = static_cast<uint8_t>(2 | ((l - 1) << 2));
      *op++ = static_cast<uint8_t>(off & 0xff);
      *op++ = static_cast<uint8_t>(off >> 8);
    }
    len -= l;
  }
  return op;
}

}  // namespace

extern "C" {

// Decompress a raw snappy stream into dst (cap bytes). Returns the bytes
// written, which equal the declared length, or -1 on corrupt input.
int64_t snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
  int64_t i = 0;
  int64_t len = read_varint32(src, n, &i);
  if (len < 0 || len > cap) return -1;
  int64_t o = 0;
  while (i < n) {
    uint8_t tag = src[i++];
    int kind = tag & 3;
    if (kind == 0) {  // literal
      int64_t l = tag >> 2;
      if (l >= 60) {
        int nb = static_cast<int>(l) - 59;
        if (i + nb > n) return -1;
        l = 0;
        for (int k = 0; k < nb; ++k) l |= static_cast<int64_t>(src[i + k]) << (8 * k);
        i += nb;
      }
      l += 1;
      if (l > n - i || l > len - o) return -1;
      memcpy(dst + o, src + i, l);
      i += l;
      o += l;
      continue;
    }
    int64_t l, off;
    if (kind == 1) {
      if (i + 1 > n) return -1;
      l = ((tag >> 2) & 7) + 4;
      off = (static_cast<int64_t>(tag >> 5) << 8) | src[i];
      i += 1;
    } else if (kind == 2) {
      if (i + 2 > n) return -1;
      l = (tag >> 2) + 1;
      off = src[i] | (static_cast<int64_t>(src[i + 1]) << 8);
      i += 2;
    } else {
      if (i + 4 > n) return -1;
      l = (tag >> 2) + 1;
      off = static_cast<int64_t>(src[i]) | (static_cast<int64_t>(src[i + 1]) << 8) |
            (static_cast<int64_t>(src[i + 2]) << 16) |
            (static_cast<int64_t>(src[i + 3]) << 24);
      i += 4;
    }
    if (off == 0 || off > o || l > len - o) return -1;
    const uint8_t* s = dst + o - off;
    for (int64_t k = 0; k < l; ++k) dst[o + k] = s[k];  // overlap-safe
    o += l;
  }
  return o == len ? o : -1;
}

int64_t snappy_max_compressed_length(int64_t n) { return 32 + n + n / 6; }

// Greedy snappy compressor: a 16k-entry hash of 4-byte sequences, the
// longest forward match from the last position seen, offsets < 65536.
// Any snappy decoder reads its output. Returns the compressed size; dst
// holds snappy_max_compressed_length(n) bytes.
int64_t snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
  uint8_t* op = dst;
  uint64_t v = static_cast<uint64_t>(n);
  while (v >= 0x80) {
    *op++ = static_cast<uint8_t>(v | 0x80);
    v >>= 7;
  }
  *op++ = static_cast<uint8_t>(v);
  const int kBits = 14;
  std::vector<int64_t> table(1 << kBits, -1);
  int64_t lit = 0, i = 0;
  while (i + 4 <= n) {
    uint32_t x;
    memcpy(&x, src + i, 4);
    uint32_t h = (x * 0x1e35a7bdu) >> (32 - kBits);
    int64_t c = table[h];
    table[h] = i;
    if (c >= 0 && i - c < 65536 && memcmp(src + c, src + i, 4) == 0) {
      int64_t m = 4;
      while (i + m < n && src[c + m] == src[i + m]) ++m;
      if (i > lit) op = emit_literal(op, src + lit, i - lit);
      op = emit_copy(op, i - c, m);
      i += m;
      lit = i;
    } else {
      ++i;
    }
  }
  if (n > lit) op = emit_literal(op, src + lit, n - lit);
  return op - dst;
}

// PLAIN BYTE_ARRAY values: `count` entries of [4-byte LE length][bytes]
// from buf[start]. Writes each value's byte start and length; returns the
// position after the last value, or -1 when the buffer ends early.
int64_t byte_array_offsets(const uint8_t* buf, int64_t len, int64_t start,
                           int64_t count, int64_t* starts, int64_t* lens) {
  int64_t p = start;
  for (int64_t k = 0; k < count; ++k) {
    if (p < 0 || p + 4 > len) return -1;
    uint32_t l;
    memcpy(&l, buf + p, 4);
    p += 4;
    if (static_cast<int64_t>(l) > len - p) return -1;
    starts[k] = p;
    lens[k] = l;
    p += l;
  }
  return p;
}

}  // extern "C"

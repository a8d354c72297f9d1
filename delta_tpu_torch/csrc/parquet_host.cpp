// Host-side Parquet helpers for the checkpoint and data-file readers and
// the synthetic checkpoint writer, with a plain C interface bound by
// ctypes (`delta_tpu_torch/log/{parquet_host,snappy,zstd}.py`).
//
// The JAX package reads Parquet through Arrow, whose C++ does this work:
// snappy and ZSTD page decompression, the walk over PLAIN BYTE_ARRAY
// values (a 4-byte length, then the bytes: sequential by nature) and
// DELTA_BYTE_ARRAY's prefix chain. The card's machine has no Arrow and no
// zstd library, so the port brings its own. This is host code in the
// reference too; it is not a device kernel.
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

// DELTA_BYTE_ARRAY's prefix chain: value k is the first prefix[k] bytes
// of value k - 1, then its suffix (suffix_len[k] bytes of buf from
// suffix_start[k], checked by the caller to lie in buf). Writes the values
// back to back into out (sum of prefix + suffix_len bytes). Returns 0, or
// -1 when a prefix is longer than the value before it (or negative).
int64_t delta_byte_array(const uint8_t* buf, int64_t len,
                         const int64_t* prefix, const int64_t* suffix_start,
                         const int64_t* suffix_len, int64_t count,
                         uint8_t* out) {
  int64_t o = 0, prev_start = 0, prev_len = 0;
  for (int64_t k = 0; k < count; ++k) {
    int64_t p = prefix[k], s = suffix_start[k], l = suffix_len[k];
    if (p < 0 || p > prev_len || s < 0 || l < 0 || s > len - l) return -1;
    memmove(out + o, out + prev_start, p);
    memcpy(out + o + p, buf + s, l);
    prev_start = o;
    prev_len = p + l;
    o += prev_len;
  }
  return 0;
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
// ---------------------------------------------------------------- ZSTD --
//
// A Zstandard decoder after RFC 8878, for ZSTD pages of data files and
// checkpoint parts (the reference decompresses them with Arrow's codec).
// It reads every frame a compressor writes without a dictionary:
// concatenated and skippable frames, raw, RLE and compressed blocks,
// literals raw, RLE, Huffman-compressed (one or four streams, weights
// direct or FSE-coded) and treeless, sequences in predefined, RLE, FSE and
// repeat modes, the repeat offsets, and the optional XXH64 content
// checksum. Every read of the input, every table index, every match
// offset and every write is bounds-checked: damage gives an error code,
// never a read or write out of bounds.
//
// The section numbers below are RFC 8878's.

namespace zstd {

enum Code : int64_t { kCorrupt = -1, kDictionary = -2 };

struct Fail {
  int64_t code;
};

[[noreturn]] void corrupt() { throw Fail{kCorrupt}; }

inline void need(bool ok) {
  if (!ok) corrupt();
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int k = 0; k < n; ++k) v |= static_cast<uint64_t>(p[k]) << (8 * k);
  return v;
}

// -------------------------------------------------------------- XXH64 --

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}

inline uint64_t xxh_merge(uint64_t h, uint64_t v) {
  return (h ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, int64_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xxh_round(v1, load_le(p, 8));
      v2 = xxh_round(v2, load_le(p + 8, 8));
      v3 = xxh_round(v3, load_le(p + 16, 8));
      v4 = xxh_round(v4, load_le(p + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += static_cast<uint64_t>(n);
  for (; end - p >= 8; p += 8) h = rotl(h ^ xxh_round(0, load_le(p, 8)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------- bit readers --

// Little-endian bits read forward from the start of [p, p + n): FSE table
// descriptions (§4.1.1). Bits past the end read 0; `done` checks the
// description ended inside its bytes.
struct ForwardBits {
  const uint8_t* p;
  int64_t n;
  int64_t bit = 0;

  uint32_t peek(int w) const {  // w <= 32
    int64_t byte = bit >> 3;
    uint64_t v = 0;
    for (int k = 0; k < 5 && byte + k < n; ++k)
      v |= static_cast<uint64_t>(p[byte + k]) << (8 * k);
    return static_cast<uint32_t>((v >> (bit & 7)) & ((1ull << w) - 1));
  }
  void skip(int w) { bit += w; }
  int64_t bytes_used() const {
    int64_t used = (bit + 7) >> 3;
    need(used <= n);
    return used;
  }
};

// The backward bitstreams of Huffman literals, FSE weights and sequences
// (§4.1, §4.2.2): written forward, read from the end; the last byte's
// highest set bit marks where the stream starts. `pos` counts the bits
// not yet read; a read past the start reads 0 bits there and leaves
// `pos` negative (an overflow the callers check).
struct BackBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;

  BackBits(const uint8_t* src, int64_t size) : p(src), n(size) {
    need(size > 0 && src[size - 1] != 0);
    pos = (size - 1) * 8 + highbit(src[size - 1]);
  }

  // The w bits (w <= 56) below `pos`, the highest first read; not consumed.
  uint64_t peek(int w) const {
    if (w == 0) return 0;
    int64_t start = pos - w;
    int shift = 0;
    if (start < 0) {
      if (start + w <= 0) return 0;
      shift = static_cast<int>(-start);
      w -= shift;
      start = 0;
    }
    int64_t byte = start >> 3;
    uint64_t v;
    if (byte + 8 <= n) {
      memcpy(&v, p + byte, 8);
    } else {
      v = load_le(p + byte, static_cast<int>(n - byte));
    }
    v = (v >> (start & 7)) & ((1ull << w) - 1);
    return v << shift;
  }
  uint64_t read(int w) {
    uint64_t v = peek(w);
    pos -= w;
    return v;
  }
  bool overflow() const { return pos < 0; }
};

// ------------------------------------------------------------------ FSE --

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;  // the next state is base + the `bits` bits read
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> cells;

  // §4.1.1: spread the symbols of a normalized distribution over 2^log
  // cells, then give each cell its bit count and next-state base.
  void build(const int16_t* norm, int n_symbols, int accuracy) {
    log = accuracy;
    int size = 1 << accuracy;
    cells.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(n_symbols);
    int high = size - 1;
    for (int s = 0; s < n_symbols; ++s) {
      if (norm[s] == -1) {
        need(high >= 0);
        cells[high--].symbol = static_cast<uint16_t>(s);
        next[s] = 1;
      } else {
        next[s] = static_cast<uint32_t>(norm[s]);
      }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, at = 0;
    for (int s = 0; s < n_symbols; ++s) {
      for (int k = 0; k < norm[s]; ++k) {
        cells[at].symbol = static_cast<uint16_t>(s);
        do {
          at = (at + step) & mask;
        } while (at > high);
      }
    }
    need(at == 0);
    for (int u = 0; u < size; ++u) {
      uint32_t x = next[cells[u].symbol]++;
      need(x > 0);
      int bits = accuracy - highbit(x);
      need(bits >= 0 && bits <= accuracy);
      cells[u].bits = static_cast<uint8_t>(bits);
      cells[u].base = static_cast<uint16_t>((x << bits) - size);
    }
  }

  void rle(int symbol) {
    log = 0;
    cells.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
  }

  bool empty() const { return cells.empty(); }
};

// §4.1.1: a normalized distribution of at most max_symbol + 1 symbols at
// an accuracy log of at most max_log. Returns the bytes it took.
int64_t read_fse_table(const uint8_t* p, int64_t n, int max_symbol,
                       int max_log, FseTable* out) {
  ForwardBits br{p, n};
  int log = static_cast<int>(br.peek(4)) + 5;
  br.skip(4);
  need(log <= max_log);
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, bits = log + 1;
  int symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int n0 = symbol;
      for (;;) {  // two-bit repeat flags, 3 meaning "3 more, then more"
        uint32_t r = br.peek(2);
        br.skip(2);
        n0 += static_cast<int>(r);
        need(br.bit <= 8 * n + 32);
        if (r != 3) break;
      }
      need(n0 <= max_symbol);
      while (symbol < n0) norm[symbol++] = 0;
    }
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = br.peek(bits);
    int count;
    if (static_cast<int>(v & (threshold - 1)) < max) {
      count = static_cast<int>(v & (threshold - 1));
      br.skip(bits - 1);
    } else {
      count = static_cast<int>(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(bits);
    }
    count -= 1;  // -1: a probability "below 1"
    remaining -= count < 0 ? -count : count;
    need(remaining >= 1);
    norm[symbol++] = static_cast<int16_t>(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --bits;
      threshold >>= 1;
    }
  }
  need(remaining == 1 && symbol <= max_symbol + 1);
  int64_t used = br.bytes_used();
  out->build(norm, symbol, log);
  return used;
}

// §3.1.1.3.2.2: the predefined distributions.
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

// §3.1.1.3.2.1.1: literal and match length codes -> baseline, extra bits.
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// -------------------------------------------------------------- Huffman --

constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;  // 2^max_bits cells

  bool empty() const { return symbol.empty(); }

  // §4.2.1.3: weights of all but the last symbol -> the canonical prefix
  // code, as a table indexed by the next max_bits bits.
  void build(const uint8_t* w, int n) {
    need(n >= 1 && n <= 255);
    uint32_t total = 0;
    for (int s = 0; s < n; ++s) {
      need(w[s] <= kHufMaxBits);
      if (w[s]) total += 1u << (w[s] - 1);
    }
    need(total > 0);
    int mb = highbit(total) + 1;
    need(mb <= kHufMaxBits);
    uint32_t rest = (1u << mb) - total;  // the last symbol's share
    need(rest > 0 && (rest & (rest - 1)) == 0);
    uint8_t weights[256];
    memcpy(weights, w, n);
    weights[n] = static_cast<uint8_t>(highbit(rest) + 1);
    int count = n + 1;
    uint32_t rank[kHufMaxBits + 2] = {0};
    for (int s = 0; s < count; ++s) ++rank[weights[s]];
    uint32_t start = 0;
    for (int k = 1; k <= mb; ++k) {  // weight k starts after lighter ones
      uint32_t c = rank[k];
      rank[k] = start;
      start += c << (k - 1);
    }
    need(start == (1u << mb));
    max_bits = mb;
    symbol.assign(1u << mb, 0);
    bits.assign(1u << mb, 0);
    for (int s = 0; s < count; ++s) {
      int k = weights[s];
      if (!k) continue;
      uint32_t len = 1u << (k - 1);
      for (uint32_t u = rank[k]; u < rank[k] + len; ++u) {
        symbol[u] = static_cast<uint8_t>(s);
        bits[u] = static_cast<uint8_t>(mb + 1 - k);
      }
      rank[k] += len;
    }
  }

  // Decode exactly `count` literals from one backward stream, which they
  // must consume exactly.
  void decode_stream(const uint8_t* src, int64_t size, uint8_t* out,
                     int64_t count) const {
    BackBits br(src, size);
    for (int64_t k = 0; k < count; ++k) {
      uint32_t u = static_cast<uint32_t>(br.peek(max_bits));
      out[k] = symbol[u];
      br.pos -= bits[u];
    }
    need(br.pos == 0);
  }
};

// §4.2.1: the Huffman tree description. Returns the bytes it took.
int64_t read_huffman_tree(const uint8_t* p, int64_t n, HufTable* out) {
  need(n >= 1);
  int header = p[0];
  uint8_t w[256];
  int count = 0;
  if (header >= 128) {  // direct: 4-bit weights, two per byte
    count = header - 127;
    int64_t bytes = (count + 1) / 2;
    need(1 + bytes <= n);
    for (int s = 0; s < count; ++s)
      w[s] = (s & 1) ? (p[1 + s / 2] & 15) : (p[1 + s / 2] >> 4);
    out->build(w, count);
    return 1 + bytes;
  }
  // FSE-compressed weights: a table, then two interleaved states
  int64_t size = header;
  need(size >= 1 && 1 + size <= n);
  FseTable t;
  int64_t used = read_fse_table(p + 1, size, 255, 6, &t);
  need(used < size);
  BackBits br(p + 1 + used, size - used);
  uint32_t s1 = static_cast<uint32_t>(br.read(t.log));
  uint32_t s2 = static_cast<uint32_t>(br.read(t.log));
  auto step = [&](uint32_t* s) {  // emit the state's symbol, then advance
    need(count < 255);
    const FseEntry& e = t.cells[*s];
    w[count++] = static_cast<uint8_t>(e.symbol);
    *s = e.base + static_cast<uint32_t>(br.read(e.bits));
  };
  need(!br.overflow());
  for (;;) {
    step(&s1);
    if (br.overflow()) {
      step(&s2);
      break;
    }
    step(&s2);
    if (br.overflow()) {
      step(&s1);
      break;
    }
  }
  out->build(w, count);
  return 1 + size;
}

// ------------------------------------------------------------- frames --

struct Frame {
  uint8_t* dst;       // the whole output
  int64_t cap;        // its size
  int64_t o;          // bytes written so far
  int64_t frame_start;
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  std::vector<uint8_t> lit;

  void put(const uint8_t* src, int64_t len) {
    need(len <= cap - o);
    memcpy(dst + o, src, len);
    o += len;
  }

  // §3.1.1.3.1: the literals section; returns the bytes it took.
  int64_t literals(const uint8_t* p, int64_t n, int64_t* n_lit) {
    need(n >= 1);
    int type = p[0] & 3, format = (p[0] >> 2) & 3;
    int64_t regen, comp = 0, head;
    if (type < 2) {  // raw or RLE
      if (format == 0 || format == 2) {
        head = 1;
        regen = p[0] >> 3;
      } else if (format == 1) {
        need(n >= 2);
        head = 2;
        regen = (p[0] >> 4) + (static_cast<int64_t>(p[1]) << 4);
      } else {
        need(n >= 3);
        head = 3;
        regen = (p[0] >> 4) + (static_cast<int64_t>(p[1]) << 4) +
                (static_cast<int64_t>(p[2]) << 12);
      }
      need(regen <= (128 << 10));
      lit.resize(regen);
      if (type == 0) {
        need(head + regen <= n);
        memcpy(lit.data(), p + head, regen);
        *n_lit = regen;
        return head + regen;
      }
      need(head + 1 <= n);
      memset(lit.data(), p[head], regen);
      *n_lit = regen;
      return head + 1;
    }
    // Huffman-compressed (2) or treeless (3)
    head = format < 2 ? 3 : format + 2;
    need(n >= head);
    uint64_t h = load_le(p, static_cast<int>(head));
    int size_bits = format < 2 ? 10 : format == 2 ? 14 : 18;
    regen = static_cast<int64_t>((h >> 4) & ((1ull << size_bits) - 1));
    comp = static_cast<int64_t>((h >> (4 + size_bits)) &
                                ((1ull << size_bits) - 1));
    bool four = format != 0;
    need(regen <= (128 << 10) && head + comp <= n);
    const uint8_t* q = p + head;
    int64_t left = comp;
    if (type == 2) {
      int64_t used = read_huffman_tree(q, left, &huf);
      q += used;
      left -= used;
    } else {
      need(!huf.empty());
    }
    lit.resize(regen);
    if (!four) {
      huf.decode_stream(q, left, lit.data(), regen);
    } else {
      need(left >= 6);
      int64_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2), s3 = load_le(q + 4, 2);
      int64_t s4 = left - 6 - s1 - s2 - s3;
      need(s4 >= 0);
      int64_t seg = (regen + 3) / 4, last = regen - 3 * seg;
      need(last >= 0);
      const uint8_t* at = q + 6;
      huf.decode_stream(at, s1, lit.data(), seg);
      huf.decode_stream(at + s1, s2, lit.data() + seg, seg);
      huf.decode_stream(at + s1 + s2, s3, lit.data() + 2 * seg, seg);
      huf.decode_stream(at + s1 + s2 + s3, s4, lit.data() + 3 * seg, last);
    }
    *n_lit = regen;
    return head + comp;
  }

  // §3.1.1.3.2.1: one symbol table of the sequences section.
  int64_t table(int mode, const uint8_t* p, int64_t n, FseTable* t,
                const int16_t* dflt, int n_dflt, int dflt_log, int max_symbol,
                int max_log) {
    switch (mode) {
      case 0:
        t->build(dflt, n_dflt, dflt_log);
        return 0;
      case 1:
        need(n >= 1 && p[0] <= max_symbol);
        t->rle(p[0]);
        return 1;
      case 2:
        return read_fse_table(p, n, max_symbol, max_log, t);
      default:
        need(!t->empty());
        return 0;
    }
  }

  void copy_match(uint32_t offset, int64_t len) {
    need(offset > 0 && offset <= o - frame_start && len <= cap - o);
    uint8_t* d = dst + o;
    const uint8_t* s = d - offset;
    if (offset >= len) {
      memcpy(d, s, len);
    } else {
      for (int64_t k = 0; k < len; ++k) d[k] = s[k];  // overlapping
    }
    o += len;
  }

  // §3.1.1.3: a compressed block.
  void compressed_block(const uint8_t* p, int64_t n) {
    int64_t n_lit = 0;
    int64_t at = literals(p, n, &n_lit);
    need(at < n);  // the sequences section has at least its count
    int64_t n_seq = p[at];
    if (n_seq < 128) {
      at += 1;
    } else if (n_seq < 255) {
      need(at + 2 <= n);
      n_seq = ((n_seq - 128) << 8) + p[at + 1];
      at += 2;
    } else {
      need(at + 3 <= n);
      n_seq = p[at + 1] + (static_cast<int64_t>(p[at + 2]) << 8) + 0x7F00;
      at += 3;
    }
    if (n_seq == 0) {
      need(at == n);
      put(lit.data(), n_lit);
      return;
    }
    need(at < n);
    int modes = p[at++];
    need((modes & 3) == 0);
    at += table(modes >> 6, p + at, n - at, &ll, kLLDefault, 36, 6, 35, 9);
    at += table((modes >> 4) & 3, p + at, n - at, &of, kOFDefault, 29, 5, 31,
                8);
    at += table((modes >> 2) & 3, p + at, n - at, &ml, kMLDefault, 53, 6, 52,
                9);
    need(at < n);
    BackBits br(p + at, n - at);
    uint32_t sll = static_cast<uint32_t>(br.read(ll.log));
    uint32_t sof = static_cast<uint32_t>(br.read(of.log));
    uint32_t sml = static_cast<uint32_t>(br.read(ml.log));
    int64_t used_lit = 0;
    for (int64_t k = 0; k < n_seq; ++k) {
      const FseEntry& el = ll.cells[sll];
      const FseEntry& eo = of.cells[sof];
      const FseEntry& em = ml.cells[sml];
      int of_code = eo.symbol;
      need(of_code <= 31 && el.symbol < 36 && em.symbol < 53);
      // extra bits: the offset's, then the match length's, then the
      // literal length's
      uint64_t off_value = (1ull << of_code) + br.read(of_code);
      int64_t mlen = kMLBase[em.symbol] + br.read(kMLBits[em.symbol]);
      int64_t llen = kLLBase[el.symbol] + br.read(kLLBits[el.symbol]);
      uint32_t offset;
      if (off_value > 3) {  // §3.1.1.5: a new offset enters the history
        need(off_value - 3 <= 0xFFFFFFFFull);
        offset = static_cast<uint32_t>(off_value - 3);
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {  // a repeat code, shifted by one after an empty literal run
        int r = static_cast<int>(off_value) - 1 + (llen == 0);
        if (r == 0) {
          offset = rep[0];
        } else {
          offset = r == 3 ? rep[0] - 1 : rep[r];
          need(offset != 0);
          if (r != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      need(llen <= n_lit - used_lit);
      put(lit.data() + used_lit, llen);
      used_lit += llen;
      copy_match(offset, mlen);
      if (k + 1 < n_seq) {  // states: literal length, match length, offset
        sll = el.base + static_cast<uint32_t>(br.read(el.bits));
        sml = em.base + static_cast<uint32_t>(br.read(em.bits));
        sof = eo.base + static_cast<uint32_t>(br.read(eo.bits));
      }
      need(!br.overflow());
    }
    need(br.pos == 0);
    put(lit.data() + used_lit, n_lit - used_lit);
  }
};

// One frame from src[*i]: its blocks appended to dst from *o.
void frame(const uint8_t* src, int64_t n, int64_t* i, uint8_t* dst,
           int64_t cap, int64_t* o) {
  int64_t at = *i + 4;
  need(at < n);
  int fhd = src[at++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      dict_flag = fhd & 3;
  need(!(fhd & 8));  // the reserved bit
  if (!single) {
    need(at < n);
    ++at;  // the window descriptor: the whole output is the window here
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  int db = kDictBytes[dict_flag];
  need(at + db <= n);
  if (db && load_le(src + at, db) != 0) throw Fail{kDictionary};
  at += db;
  int fcs_bytes = fcs_flag == 0 ? single : 1 << fcs_flag;
  int64_t content = -1;
  if (fcs_bytes) {
    need(at + fcs_bytes <= n);
    uint64_t v = load_le(src + at, fcs_bytes);
    if (fcs_bytes == 2) v += 256;
    need(v <= static_cast<uint64_t>(cap));
    content = static_cast<int64_t>(v);
    at += fcs_bytes;
  }
  Frame f;
  f.lit.reserve(128 << 10);  // a block's literals; never reallocated
  f.dst = dst;
  f.cap = cap;
  f.o = *o;
  f.frame_start = *o;
  for (bool last = false; !last;) {  // §3.1.1.2: blocks
    need(at + 3 <= n);
    uint32_t bh = static_cast<uint32_t>(load_le(src + at, 3));
    at += 3;
    last = bh & 1;
    int type = (bh >> 1) & 3;
    int64_t size = bh >> 3;
    if (type == 0) {  // raw
      need(size <= n - at);
      f.put(src + at, size);
      at += size;
    } else if (type == 1) {  // RLE: one byte, `size` times
      need(at < n && size <= cap - f.o);
      memset(dst + f.o, src[at], size);
      f.o += size;
      at += 1;
    } else if (type == 2) {
      need(size <= n - at && size <= (128 << 10));
      f.compressed_block(src + at, size);
      at += size;
    } else {
      corrupt();
    }
  }
  need(content < 0 || f.o - f.frame_start == content);
  if (checksum) {
    need(at + 4 <= n);
    uint64_t h = xxh64(dst + f.frame_start, f.o - f.frame_start);
    need(static_cast<uint32_t>(h) == load_le(src + at, 4));
    at += 4;
  }
  *i = at;
  *o = f.o;
}

}  // namespace zstd

extern "C" {

// Decompress the concatenated (and skippable) Zstandard frames of
// src[0, n) into dst (cap bytes). Returns the bytes written; -1 when the
// input is damaged or needs more than cap bytes, -2 when a frame needs a
// dictionary. No input makes it read or write out of bounds.
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  int64_t i = 0, o = 0;
  try {
    zstd::need(n > 0);
    while (i < n) {
      zstd::need(n - i >= 4);
      uint32_t magic = static_cast<uint32_t>(zstd::load_le(src + i, 4));
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
        zstd::need(n - i >= 8);
        int64_t size = static_cast<int64_t>(zstd::load_le(src + i + 4, 4));
        zstd::need(size <= n - i - 8);
        i += 8 + size;
        continue;
      }
      zstd::need(magic == 0xFD2FB528u);
      zstd::frame(src, n, &i, dst, cap, &o);
    }
  } catch (const zstd::Fail& f) {
    return f.code;
  } catch (...) {  // std::bad_alloc: tables are small, bounded by the format
    return zstd::kCorrupt;
  }
  return o;
}

}  // extern "C"

// K8 `dv_bits`: the roaring bit scatter of deletion vectors, hand-written
// for Hopper (sm_90a), one launch for every deletion vector of a command.
//
// Replaces the JAX package's two jnp scatter functions of queue B's B7
// (not Pallas kernels): `_pack_fn_cached` (delta_tpu/ops/stats.py:231,
// through `pack_bitmap_words` at :247), which packs a deletion vector's
// bitmap containers when it is serialized, and `_decode_fn_cached` (:279,
// through `decode_mask_words` at :300), which expands a stored deletion
// vector's containers to its row words when a file is read. Reached
// through `ops/dv_bits.py::dv_tiles` from `dv/roaring.py`
// (`serialize_deltas`, `decode_delta_masks`).
//
// Both are one scatter-OR of bits and bitmap words into a zeroed stream of
// u32 words. Here the stream is cut into tiles of at most 2048 words: one
// 65,536-row window of one deletion vector's output, which is exactly one
// roaring container's span, so a tile holds at most one container. A tile
// (int32 [5]) is: its first output word, its valid words (<= 2048), the
// bitmap container whose words it starts from (or -1), and the range
// [lo, hi) of its lows, the low 16 bits (u16) of the values of an array or
// run container. The tile's words are the bitmap's first `valid` words (or
// zeros) with bit (low & 31) of word (low >> 5) set for every low; a low at
// or past the valid words drops (the rows past a file's count). Decode
// takes one tile per window of every deletion vector of the batch, each
// vector's words in a segment of its own; pack is the case with lows only,
// one tile per bitmap container being serialized. The tiles cover every
// output word once: the launch writes them all, so nothing is zeroed
// before it.
//
// Bound: bytes. The function reads 2 B per low, 4 B per valid bitmap word
// and 20 B per tile, and writes 4 B per output word; an OR per low is no
// work beside that. Design: one block of 256 threads per tile, which owns
// its words, so no global atomic and no memset pass. A tile without lows
// is copied global to global (the bitmap's words, or zeros) with 16-byte
// vector loads and stores, neighbouring threads on neighbouring addresses,
// two in flight per thread. A tile with lows is built in an 8 KiB shared
// tile (zeros or the bitmap's words): each thread reads 8 consecutive lows
// with one 16-byte load, two loads in flight, and ORs a run of lows that
// hit one word in a register before one shared-memory atomicOr (sorted
// lows: about one atomic per 3 lows at cell 10's 10% density); then the
// valid words are stored with 16-byte vectors. A tail of fewer than 4
// words, or a tile whose words or lows are not 16-byte aligned, is read or
// stored element by element. (A first version aggregated a warp's lanes
// with __match_any_sync and __reduce_or_sync, one low a thread and one
// load in flight: the load latency of every 256 lows set its time.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 2048;  // 65,536 rows: one roaring container
constexpr int kFields = 5;    // offset, valid, bitmap, lo, hi
constexpr unsigned kNoWord = 0xFFFFFFFFu;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// out[0, valid) = src[0, valid), or zeros when src is null. src may lie in
// global or shared memory.
__device__ __forceinline__ void put_words(unsigned* __restrict__ out,
                                          const unsigned* __restrict__ src,
                                          int valid) {
  const bool vec = aligned16(out) && (src == nullptr || aligned16(src));
  const int n4 = vec ? valid >> 2 : 0;
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  int i = threadIdx.x;
  for (; i + kThreads < n4; i += 2 * kThreads) {
    const uint4 a = src ? s4[i] : zero;
    const uint4 b = src ? s4[i + kThreads] : zero;
    o4[i] = a;
    o4[i + kThreads] = b;
  }
  if (i < n4) o4[i] = src ? s4[i] : zero;
  for (int j = 4 * n4 + threadIdx.x; j < valid; j += kThreads)
    out[j] = src ? src[j] : 0u;
}

// tile[low >> 5] |= 1 << (low & 31) for each low in lows[lo, hi). Each
// thread takes 8 consecutive lows (one 16-byte load where the lows are
// 16-byte aligned), two such chunks in flight, and ORs the bits of a run
// of equal words in a register before one shared-memory atomicOr per run:
// the lows of a container come sorted, so 8 of them span a few words.
// Any order is right; unsorted lows only take more atomics.
__device__ __forceinline__ void or_lows(
    unsigned* tile, const unsigned short* __restrict__ lows, long long n_lows,
    long long lo, long long hi) {
  const bool vec = aligned16(lows);
  const long long first = (lo & ~7LL) + 8LL * threadIdx.x;
  constexpr long long kStride = 8LL * kThreads;
  for (long long c0 = first; c0 < hi; c0 += 2 * kStride) {
    unsigned q[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long c = c0 + h * kStride;
      if (vec && c + 8 <= n_lows) {
        const uint4 v = *reinterpret_cast<const uint4*>(lows + c);
        q[h][0] = v.x; q[h][1] = v.y; q[h][2] = v.z; q[h][3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const long long i = c + 2 * k;
          q[h][k] = (i < n_lows ? lows[i] : 0u)
                    | (i + 1 < n_lows ? unsigned(lows[i + 1]) << 16 : 0u);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long c = c0 + h * kStride;
      unsigned word = kNoWord, bits = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long i = c + k;
        if (i < lo || i >= hi) continue;
        const unsigned v = (q[h][k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
        if ((v >> 5) != word) {
          if (word != kNoWord) atomicOr(tile + word, bits);
          word = v >> 5;
          bits = 0u;
        }
        bits |= 1u << (v & 31u);
      }
      if (word != kNoWord) atomicOr(tile + word, bits);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dv_tiles_kernel(const int* __restrict__ tiles,
                const unsigned short* __restrict__ lows, long long n_lows,
                const unsigned* __restrict__ bm_words, long long n_bm,
                unsigned* __restrict__ words, long long n_words) {
  __shared__ __align__(16) unsigned tile[kWords];
  const int* f = tiles + static_cast<long long>(blockIdx.x) * kFields;
  const long long off = f[0];
  if (off < 0 || off >= n_words) return;
  long long valid = f[1];
  if (valid > kWords) valid = kWords;
  if (valid > n_words - off) valid = n_words - off;
  if (valid <= 0) return;
  const long long bm = f[2];
  const long long lo = f[3] < 0 ? 0 : f[3];
  const long long hi = f[4] > n_lows ? n_lows : f[4];
  const unsigned* src =
      (bm >= 0 && bm < n_bm) ? bm_words + bm * kWords : nullptr;
  unsigned* out = words + off;
  if (lo >= hi) {  // a zero or a bitmap tile
    put_words(out, src, static_cast<int>(valid));
    return;
  }
  put_words(tile, src, kWords);
  __syncthreads();
  or_lows(tile, lows, n_lows, lo, hi);
  __syncthreads();
  put_words(out, tile, static_cast<int>(valid));
}

}  // namespace

// Launches K8 over `n_tiles` tiles (int32 [n_tiles, 5]) on `stream` of CUDA
// device `device`; returns the CUDA error code (0 = launched). `lows` holds
// n_lows u16, `bm_words` n_bm bitmap containers of 2048 words; `words` has
// n_words words, each of which exactly one tile must cover (the host
// functions that make the tiles see to it). A tile's fields are clamped
// into their ranges, so no tile reads or writes out of bounds.
extern "C" int dv_tiles_launch(const void* tiles, long long n_tiles,
                               const void* lows, long long n_lows,
                               const void* bm_words, long long n_bm,
                               void* words, long long n_words, int device,
                               void* stream) {
  if (n_tiles < 0 || n_tiles > 0x7FFFFFFFLL || n_lows < 0 || n_bm < 0 ||
      n_words < 0 || n_words > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0 || n_words == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dv_tiles_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tiles),
      static_cast<const unsigned short*>(lows), n_lows,
      static_cast<const unsigned*>(bm_words), n_bm,
      static_cast<unsigned*>(words), n_words);
  return static_cast<int>(cudaGetLastError());
}

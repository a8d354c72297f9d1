// K8 `dv_bits`: the roaring bit scatter of deletion vectors, hand-written
// for Hopper (sm_90a).
//
// Replaces the JAX package's two jnp scatter functions of queue B's B7
// (not Pallas kernels): `_pack_fn_cached` (delta_tpu/ops/stats.py:231,
// through `pack_bitmap_words` at :247), which packs a deletion vector's
// bitmap containers when it is serialized, and `_decode_fn_cached` (:279,
// through `decode_mask_words` at :300), which expands a stored deletion
// vector's containers to its row words when a file is read. Reached
// through `ops/dv_bits.py` from `dv/roaring.py` (`_serialize32`,
// `decode_delta_mask`).
//
// Both are one scatter-OR into a zeroed stream of n_words 32-bit words:
//   bit index b (int64, from array and run containers, or the flat bits
//   of the containers being packed):   words[b >> 5] |= 1u << (b & 31)
//   bitmap word j (u32) of container c = j >> 11, which starts at word
//   offset base[c] (int32):   words[base[c] + (j & 2047)] |= bm_words[j]
// An index outside [0, n_words * 32) and a position outside [0, n_words)
// drop: the reference's sentinels (index n_words * 32, position n_words),
// and the lanes past a file's rows. Pack is the case with no bitmap lanes.
//
// Bound: bytes. The function reads 8 B per index, 4 B per bitmap word and
// 4 B per bitmap container, and writes 4 B per output word; an OR per lane
// entry is no work beside that. Design, simple and right: one thread per
// lane entry (indexes first, then bitmap words), 256 a block; each does
// one atomicOr into global memory, resolved in L2. A bitmap word's
// position follows from its container's offset, so no position lane is
// built or read. OR does not depend on the order of the atomics, so the
// result is exact and the same on every run. The entry point zeroes the
// words with a memset on the same stream before the launch. A deletion
// vector's indexes come sorted, so neighbouring threads often hit one
// word: a warp-aggregated OR over runs of equal words, or a container tile
// in shared memory, would cut the atomics (later work).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kContainerShift = 11;  // 2048 words in a bitmap container

__global__ void __launch_bounds__(kThreads)
dv_bits_kernel(const long long* __restrict__ bit_idx, long long n_idx,
               const unsigned* __restrict__ bm_words,
               const int* __restrict__ bm_base, long long n_bm,
               unsigned* __restrict__ words, long long n_words) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_idx) {
    const long long b = bit_idx[i];
    if (b >= 0 && b < n_words * 32)
      atomicOr(words + (b >> 5), 1u << static_cast<unsigned>(b & 31));
  } else if (i < n_idx + n_bm) {
    const long long j = i - n_idx;
    const unsigned w = bm_words[j];
    const long long p = static_cast<long long>(bm_base[j >> kContainerShift])
                        + (j & ((1 << kContainerShift) - 1));
    if (w != 0u && p >= 0 && p < n_words) atomicOr(words + p, w);
  }
}

}  // namespace

// Zeroes `words` (n_words of them) and launches the scatter, both on
// `stream` of CUDA device `device`; returns the CUDA error code (0 =
// launched). `bm_words` holds n_bm words, 2048 for each of the containers
// whose offsets `bm_base` holds. Any of the lanes may be empty (its
// pointer is then not read).
extern "C" int dv_bits_launch(const void* bit_idx, long long n_idx,
                              const void* bm_words, const void* bm_base,
                              long long n_bm, void* words, long long n_words,
                              int device, void* stream) {
  if (n_idx < 0 || n_bm < 0 || n_bm % (1 << kContainerShift) != 0 ||
      n_words < 0 || n_words > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_words == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(words, 0, static_cast<size_t>(n_words) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n_idx + n_bm;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  dv_bits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const long long*>(bit_idx), n_idx,
      static_cast<const unsigned*>(bm_words), static_cast<const int*>(bm_base),
      n_bm, static_cast<unsigned*>(words), n_words);
  return static_cast<int>(cudaGetLastError());
}

// Replay winner pass, hand-written for Hopper (sm_90a).
//
// Replaces the tail of delta_tpu/ops/replay.py::_sort_winner_pack (the jnp
// code after its lax.sort): after a stable sort by replay key, every
// logical file's history is one contiguous run in chronological order, and
// the last row of each run is the newest action, the winner. The winner
// bit is scattered back to the row's original index and bit-packed, 32
// rows per word, little-endian bit order (ops/replay.py::_pack_bits).
//
// Inputs: sorted int64 keys [n], the original row index of each sorted
// row (int32 [n]), n, and ceil(n / 32) zeroed 32-bit words.
// Rule, as in the reference: winner = is_last_of_run | ~next_valid. The
// reference pads to a bucket and drops padding through `valid`; here the
// arrays hold exactly n rows, so only the row past the end is not valid.
//
// Bound: memory. 12 B read per row (key + index, plus the next key, which
// the neighbouring thread has just brought into L1/L2) and 4 B written per
// 32 rows: ~12 MB for 1M rows, ~4 us at 3.35 TB/s on an H100 SXM.
//
// Design: one thread per sorted row in a grid-stride loop; adjacent
// threads read adjacent keys, so the compare with the next key is a
// coalesced load. The scatter to original order is random, so the bit is
// set with atomicOr on the zeroed word (each row sets one distinct bit, so
// the result does not depend on the order of the atomics).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void winner_pack_kernel(const long long* __restrict__ skey,
                                   const int* __restrict__ sidx,
                                   long long n,
                                   unsigned int* __restrict__ words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    // winner = is_last_of_run | ~next_valid
    const bool next_valid = i + 1 < n;
    if (!next_valid || skey[i] != skey[i + 1]) {
      const int r = sidx[i];
      atomicOr(words + (r >> 5), 1u << (r & 31));
    }
  }
}

}  // namespace

// Launches on `stream` of CUDA device `device`; returns the CUDA error
// code of the launch (0 = launched). `words` must hold ceil(n / 32)
// zeroed words.
extern "C" int winner_pack_launch(const void* skey, const void* sidx,
                                  long long n, void* words, int device,
                                  void* stream) {
  if (n <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  winner_pack_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(skey), static_cast<const int*>(sidx), n,
      static_cast<unsigned int*>(words));
  return static_cast<int>(cudaGetLastError());
}

// K9 `merge_join`: the tail of MERGE's equi-join, after the sort.
//
// Replaces the body of the JAX package's `_join_kernel`
// (delta_tpu/ops/join.py:41-85) after its sort, a jnp function, not a
// Pallas kernel: queue B's B9. Reached through
// `ops/join.py::equi_join_codes` from `commands/merge.py` on every MERGE
// whose ON condition is an equi-join (no residual conjunct) of at least
// DEVICE_JOIN_MIN_ROWS rows.
//
// Input: the rows of the target (input positions 0 .. nt-1) and of the
// source (nt .. nt+ns-1), sorted stably by (key code, side), side 0 for a
// target row: `code` u32 [n] the sorted codes, `pos` i32 [n] the input
// position of each sorted row. A key's rows form one run of equal codes,
// its target rows first, each side in input order. Output:
//   match   i32 [nt]         per target row, the source-local index of the
//                            first (smallest) source row of its run, or -1;
//   words   u32 [ceil(ns/32)] bit s set where source row s shares its run
//                            with a target row (zeroed by the wrapper);
//   n_multi i32 [1]          the target rows whose run holds more than one
//                            source row (zeroed by the wrapper).
//
// Bound: bytes. The function must read 8 B per row (code and position)
// and write 4 B per target row and per word; it does a comparison or two
// per row. Design, simple and right: one thread per sorted row, 256 a
// block. A thread at a run head (i == 0 or code[i] != code[i - 1]) walks
// its run once to the first source row and on to the run's end, then
// writes the run's match to each of its target rows (scattered by input
// position) and, when the run holds a target row, ORs each source row's
// bit with atomicOr (runs share words). Other threads only compare their
// code with the previous one: neighbouring threads read neighbouring
// words, so those loads are coalesced. The count of multi-matched target
// rows is summed in the block (warp shuffles, then one warp over the
// warps' sums) and added with one atomic per block. A long run (a skewed
// key) is walked by one thread; a warp per run is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void merge_join_kernel(const uint32_t* __restrict__ code,
                                  const int32_t* __restrict__ pos,
                                  int64_t nt, int64_t ns,
                                  int32_t* __restrict__ match,
                                  uint32_t* __restrict__ words,
                                  int32_t* __restrict__ n_multi) {
  const int64_t n = nt + ns;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int multi = 0;
  if (i < n) {
    const uint32_t c = code[i];
    if (i == 0 || code[i - 1] != c) {
      int64_t j = i;
      while (j < n && code[j] == c && pos[j] < nt) ++j;
      const int64_t t_end = j;  // the run's first source row, if any
      while (j < n && code[j] == c) ++j;
      const int64_t n_tgt = t_end - i;
      const int64_t n_src = j - t_end;
      const int32_t first =
          n_src > 0 ? static_cast<int32_t>(pos[t_end] - nt) : -1;
      for (int64_t k = i; k < t_end; ++k) match[pos[k]] = first;
      if (n_tgt > 0) {
        for (int64_t k = t_end; k < j; ++k) {
          const uint32_t s = static_cast<uint32_t>(pos[k] - nt);
          atomicOr(&words[s >> 5], 1u << (s & 31));
        }
      }
      if (n_src > 1) multi = static_cast<int>(n_tgt);
    }
  }
  __shared__ int part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  multi = warp_sum(multi);
  if (lane == 0) part[warp] = multi;
  __syncthreads();
  if (warp == 0) {
    multi = warp_sum(lane < kWarps ? part[lane] : 0);
    if (lane == 0 && multi != 0) atomicAdd(n_multi, multi);
  }
}

}  // namespace

// The C entry point, bound with ctypes by ops/join.py. Launches on
// `stream`; returns the CUDA error of the launch (0 on success).
extern "C" int merge_join_launch(const void* code, const void* pos,
                                 long long nt, long long ns, void* match,
                                 void* words, void* n_multi, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nt < 0 || ns < 0 || nt + ns > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);  // i32 positions
  const long long n = nt + ns;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  merge_join_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(code), static_cast<const int32_t*>(pos),
      nt, ns, static_cast<int32_t*>(match), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(n_multi));
  return static_cast<int>(cudaGetLastError());
}

// K6 `segmented_minmax`: per-file min, max and valid count of a masked
// float32 matrix.
//
// Replaces the TPU kernel B5, `segmented_minmax` / `_minmax_kernel`
// (delta_tpu/ops/pallas_kernels.py:111-146), reached through the wrapper
// `batched_file_stats` (:149) from tests.
//
// Computes, for each row f of values[F, R] under valid[F, R] (bytes, 0 or
// 1): the min and max of the valid entries and their count; a row with no
// valid entry gives +inf, -inf and 0. The reference's edge semantics hold
// bit for bit: a valid NaN makes min and max the quiet NaN 0x7FC00000;
// -0.0 orders below +0.0; +inf is a legal min. fminf/fmaxf would drop NaN
// and leave the sign of zero open, so the kernel reduces an order-preserving
// int32 key of the float bits (the sign flips the other 31 bits: int32
// order is float order with -0.0 < +0.0), with a NaN flag beside it. No
// float atomics: the result does not depend on the order of the blocks.
//
// Bound: bytes, 4 B of value and 1 B of mask per entry. Design, simple and
// right, for few long rows (the chip shape is F = 20, R = 500,000): pass 1
// runs a grid of (F, chunks of 16,384 entries) blocks, each reducing its
// chunk with a grid-stride loop, warp shuffles and shared memory into one
// partial (min key, max key, count, NaN flag) in scratch; pass 2 runs one
// warp per row over its partials and writes the floats. Vector loads are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16384;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kKeyPosInf = 0x7F800000;
constexpr int32_t kKeyNegInf = static_cast<int32_t>(0x807FFFFFu);
constexpr uint32_t kQuietNan = 0x7FC00000u;

__device__ __forceinline__ int32_t order_key(uint32_t bits) {
  const int32_t b = static_cast<int32_t>(bits);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ bool is_nan(uint32_t bits) {
  return (bits & 0x7FFFFFFFu) > 0x7F800000u;
}

struct Part {
  int32_t lo, hi, count, nan;
};

__device__ __forceinline__ Part combine(Part a, Part b) {
  return {min(a.lo, b.lo), max(a.hi, b.hi), a.count + b.count, a.nan | b.nan};
}

__device__ __forceinline__ Part warp_reduce(Part p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Part q{__shfl_xor_sync(0xFFFFFFFFu, p.lo, off),
           __shfl_xor_sync(0xFFFFFFFFu, p.hi, off),
           __shfl_xor_sync(0xFFFFFFFFu, p.count, off),
           __shfl_xor_sync(0xFFFFFFFFu, p.nan, off)};
    p = combine(p, q);
  }
  return p;
}

// scratch layout: 4 int32 planes of [F, C]: lo, hi, count, nan
__global__ void minmax_partial(const uint32_t* __restrict__ values,
                               const uint8_t* __restrict__ valid, int64_t r,
                               int n_chunks, int32_t* __restrict__ scratch,
                               int64_t plane) {
  const int64_t f = blockIdx.x;
  const int c = blockIdx.y;
  const int64_t begin = static_cast<int64_t>(c) * kChunk;
  const int64_t end = begin + kChunk < r ? begin + kChunk : r;
  const uint32_t* v = values + f * r;
  const uint8_t* m = valid + f * r;
  Part p{kKeyPosInf, kKeyNegInf, 0, 0};
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    if (m[i]) {
      const uint32_t bits = v[i];
      const int32_t k = order_key(bits);
      p.lo = min(p.lo, k);
      p.hi = max(p.hi, k);
      p.count += 1;
      p.nan |= is_nan(bits) ? 1 : 0;
    }
  }
  __shared__ Part warps[kWarps];
  p = warp_reduce(p);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < kWarps ? warps[lane] : Part{kKeyPosInf, kKeyNegInf, 0, 0};
    p = warp_reduce(p);
    if (lane == 0) {
      const int64_t at = f * n_chunks + c;
      scratch[at] = p.lo;
      scratch[plane + at] = p.hi;
      scratch[2 * plane + at] = p.count;
      scratch[3 * plane + at] = p.nan;
    }
  }
}

__global__ void minmax_final(const int32_t* __restrict__ scratch, int f_rows,
                             int n_chunks, int64_t plane,
                             uint32_t* __restrict__ out_min,
                             uint32_t* __restrict__ out_max,
                             int32_t* __restrict__ out_count) {
  const int f = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (f >= f_rows) return;
  Part p{kKeyPosInf, kKeyNegInf, 0, 0};
  for (int c = lane; c < n_chunks; c += 32) {
    const int64_t at = static_cast<int64_t>(f) * n_chunks + c;
    p = combine(p, Part{scratch[at], scratch[plane + at],
                        scratch[2 * plane + at], scratch[3 * plane + at]});
  }
  p = warp_reduce(p);
  if (lane == 0) {
    // the key is an involution: decode with the same flip
    out_min[f] = p.nan ? kQuietNan
                       : static_cast<uint32_t>(order_key(
                             static_cast<uint32_t>(p.lo)));
    out_max[f] = p.nan ? kQuietNan
                       : static_cast<uint32_t>(order_key(
                             static_cast<uint32_t>(p.hi)));
    out_count[f] = p.count;
  }
}

}  // namespace

extern "C" int segmented_minmax_launch(const void* values, const void* valid,
                                       int f_rows, long long r, int n_chunks,
                                       void* scratch, void* out_min,
                                       void* out_max, void* out_count,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (f_rows <= 0) return 0;
  if (n_chunks < 1 || n_chunks > 65535 ||
      static_cast<long long>(n_chunks) * kChunk < r) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(f_rows) * n_chunks;
  int32_t* sc = static_cast<int32_t*>(scratch);
  minmax_partial<<<dim3(f_rows, n_chunks), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(values),
      static_cast<const uint8_t*>(valid), r, n_chunks, sc, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = kThreads / 32;
  minmax_final<<<(f_rows + rows_per_block - 1) / rows_per_block, kThreads,
                 0, s>>>(sc, f_rows, n_chunks, plane,
                         static_cast<uint32_t*>(out_min),
                         static_cast<uint32_t*>(out_max),
                         static_cast<int32_t*>(out_count));
  return static_cast<int>(cudaGetLastError());
}

// K5 `unpack_bitpacked`: Parquet bit-packed groups to values.
//
// Replaces the TPU kernel B4, `unpack_bitpacked_tiled` / `_unpack_kernel`
// (delta_tpu/ops/pallas_kernels.py:238-277), reached through the wrapper
// `unpack_bitpacked` (:280) from tests and `benchmarks/device_merit.py:491`.
//
// Computes, for G groups of 32 values x w bits given word-major (word k of
// group g at packed[k * G + g], w words per group), the G * 32 values
// group-major: value j of group g, at out[g * 32 + j], is the w bits at bit
// j * w of the group's words: word j * w / 32 shifted right by
// sh = j * w % 32, OR'd with the next word shifted left by 32 - sh when
// sh + w > 32, masked to w bits. The mask is built without 1 << 32, which
// C leaves undefined. The TPU kernel needs G % 1024 == 0; any G works here.
//
// Bound: bytes. Each group reads 4 * w bytes and writes 128; a value costs
// a few integer operations. Design, simple and right: one block of 256
// threads per run of 32 groups. The block stages the run's [w, 32] word
// tile in shared memory with coalesced loads (32 consecutive words of one
// word row per warp step), rows padded to 33 words so that the 32 lanes of
// a warp, which read the same group's words at different rows, hit 32
// different banks; then each thread computes output values o = t,
// t + 256, ... of the run, and the stores of a warp are 32 consecutive
// words. The last run may hold fewer than 32 groups.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 32;        // groups per block
constexpr int kStride = kGroups + 1;
constexpr int kThreads = 256;

__global__ void unpack_kernel(const uint32_t* __restrict__ packed, int w,
                              int64_t n_groups, uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[32 * kStride];
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kGroups;
  const int here = static_cast<int>(
      n_groups - g0 < kGroups ? n_groups - g0 : kGroups);
  for (int t = threadIdx.x; t < w * kGroups; t += kThreads) {
    const int k = t / kGroups;
    const int g = t % kGroups;
    tile[k * kStride + g] = g < here ? packed[k * n_groups + g0 + g] : 0u;
  }
  __syncthreads();
  const uint32_t mask = w == 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
  const int n_out = here * 32;
  uint32_t* dst = out + g0 * 32;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const int g = o >> 5;
    const int bit = (o & 31) * w;
    const int lo = bit >> 5;
    const int sh = bit & 31;
    uint32_t v = tile[lo * kStride + g] >> sh;
    if (sh + w > 32) v |= tile[(lo + 1) * kStride + g] << (32 - sh);
    dst[o] = v & mask;
  }
}

}  // namespace

extern "C" int unpack_bitpacked_launch(const void* packed, int w,
                                       long long n_groups, void* out,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w < 1 || w > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return 0;
  const long long blocks = (n_groups + kGroups - 1) / kGroups;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), w, n_groups,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

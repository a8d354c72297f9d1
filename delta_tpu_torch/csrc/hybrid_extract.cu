// K3 `hybrid_extract`: every position of a checkpoint part's RLE/bit-packed
// hybrid streams, decoded from the part's one byte lane and its run plan.
//
// Replaces the TPU kernel B1, `shift_extract_tiled` / `_shift_extract_kernel`
// (delta_tpu/ops/pallas_kernels.py:337-375), and fuses the work around it in
// `_decode_stage_hybrid` (delta_tpu/ops/page_decode.py:103-124): the run
// lookup of each hybrid position (the reference's searchsorted over the
// run starts), the gather of the 5 lane bytes at bit >> 3, the
// variable-shift extract ((lo >> sh) | (hi << (32 - sh))) & mask(w), and
// the RLE select. The TPU kernel needs n % 1024 == 0 and four u32 input
// lanes built by XLA; here any h_total works and the four lanes never
// exist in device memory.
//
// Inputs: lane u8[B]; runs int32[R, 6] (hybrid start, value count, lane
// bit offset, bit width, is_rle, rle value as a u32 bit pattern), sorted
// by hybrid start; output u32[h_total]. A lane byte past B reads as 0, as
// the reference's zero-padded lane gives it.
//
// Bound: bytes. Each position writes 4 bytes; the bit-packed runs cover
// sum(ceil(n * w / 8)) lane bytes and the run table 24 * R, all read once.
// A few dozen integer operations per position (a log2(R) binary search,
// the extract) are far below the byte time. Design, simple and right:
// a grid-stride loop over positions, one binary search of the run table
// per position (the table is small and stays in L1/L2), byte loads from
// the lane. A run-major launch with the lane window staged in shared
// memory is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRunF = 6;

__device__ __forceinline__ uint32_t lane_byte(const uint8_t* __restrict__ lane,
                                              int64_t i, int64_t n_bytes) {
  return (i >= 0 && i < n_bytes) ? static_cast<uint32_t>(lane[i]) : 0u;
}

__global__ void hybrid_extract_kernel(const uint8_t* __restrict__ lane,
                                      int64_t n_bytes,
                                      const int32_t* __restrict__ runs,
                                      int n_runs, int64_t h_total,
                                      uint32_t* __restrict__ out) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t h = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       h < h_total; h += stride) {
    // last run whose start <= h (searchsorted right, minus one, clipped)
    int lo_r = 0, hi_r = n_runs;
    while (lo_r < hi_r) {
      int mid = (lo_r + hi_r) >> 1;
      if (static_cast<int64_t>(runs[mid * kRunF]) <= h) lo_r = mid + 1;
      else hi_r = mid;
    }
    int rid = lo_r - 1;
    if (rid < 0) rid = 0;
    const int32_t* row = runs + rid * kRunF;
    if (row[4] == 1) {  // RLE run: its value
      out[h] = static_cast<uint32_t>(row[5]);
      continue;
    }
    int64_t j = h - row[0];
    if (j < 0) j = 0;
    if (j > row[1]) j = row[1];
    int w = row[3];
    int64_t bit = static_cast<int64_t>(row[2]) + j * w;
    int64_t b0 = bit >> 3;
    uint32_t sh = static_cast<uint32_t>(bit & 7);
    uint32_t lo = lane_byte(lane, b0, n_bytes) |
                  (lane_byte(lane, b0 + 1, n_bytes) << 8) |
                  (lane_byte(lane, b0 + 2, n_bytes) << 16) |
                  (lane_byte(lane, b0 + 3, n_bytes) << 24);
    uint32_t hi = lane_byte(lane, b0 + 4, n_bytes);
    uint32_t v = (lo >> sh) | (sh ? (hi << (32u - sh)) : 0u);
    uint32_t mask = w >= 32 ? 0xffffffffu : ((1u << w) - 1u);
    out[h] = v & mask;
  }
}

}  // namespace

extern "C" int hybrid_extract_launch(const void* lane, long long n_bytes,
                                     const void* runs, int n_runs,
                                     long long h_total, void* out, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h_total <= 0) return 0;
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  long long want = (h_total + threads - 1) / threads;
  long long cap = static_cast<long long>(sms) * 16;
  int blocks = static_cast<int>(want < cap ? want : cap);
  hybrid_extract_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lane), n_bytes,
      static_cast<const int32_t*>(runs), n_runs, h_total,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

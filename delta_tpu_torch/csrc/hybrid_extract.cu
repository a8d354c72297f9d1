// K3 `hybrid_extract`: every position of a checkpoint part's RLE/bit-packed
// hybrid streams, decoded from the part's one byte lane and its run plan.
//
// Replaces the TPU kernel B1, `shift_extract_tiled` / `_shift_extract_kernel`
// (delta_tpu/ops/pallas_kernels.py:337-375), and fuses the work around it in
// `_decode_stage_hybrid` (delta_tpu/ops/page_decode.py:103-124): the run
// lookup of each hybrid position (the reference's searchsorted over the
// run starts), the gather of the lane bytes at bit >> 3, the variable-shift
// extract ((lo >> sh) | (hi << (32 - sh))) & mask(w), and the RLE select.
// The TPU kernel needs n % 1024 == 0 and four u32 input lanes built by XLA;
// here any h_total works and the four lanes never exist in device memory.
//
// Inputs: lane u8[B]; runs int32[R, 6] (hybrid start, value count, lane
// bit offset, bit width, is_rle, rle value as a u32 bit pattern), sorted
// by hybrid start; tiles int32[T, 2] (run id, first position), built on
// the host by `ops/page_decode.py::tile_plan`: they cover [0, h_total) in
// order, each inside one run's positions and one kTile-aligned chunk of
// the output, and a tile ends where the next begins. Output u32[h_total],
// 16-byte aligned. A lane byte outside [0, B) reads as 0, as the
// reference's zero-padded lane gives it.
//
// Bound: bytes. Each position writes 4 bytes; the bit-packed runs cover
// sum(ceil(n * w / 8)) lane bytes and the run table 24 * R, all read once;
// a handful of integer operations per position. What the design does
// about it:
// - no search: one block per tile, whose run the host already named;
// - RLE and width-0 tiles are fills, one 16-byte store per thread;
// - a bit-packed tile stages its lane window (at most
//   ceil(kTile * 32 / 8) + 24 bytes) in shared memory with 16-byte loads
//   on 16-byte-aligned addresses, then each thread extracts its 4
//   consecutive positions from two 32-bit shared words each and writes
//   them with one 16-byte store. Positions at a tile's ragged edge are
//   stored one by one. There is nothing to overlap the window load with
//   inside a block (one tile each), so it is a plain load, not cp.async;
//   the other resident blocks hide its latency.
// - a lean launch: grid = T, so no SM count is queried; the device is set
//   only when it is not current.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRunF = 6;
constexpr int kTile = 1024;          // positions; TILE of ops/page_decode.py
constexpr int kThreads = kTile / 4;  // 4 consecutive positions a thread
// bytes of the largest window: (kTile - 1) * 32 bits, the 8 bytes the last
// position reads from its word, and up to 15 bytes of alignment
constexpr int kWindowChunks = ((kTile - 1) * 32 / 8 + 1 + 8 + 15 + 15) / 16;

__device__ __forceinline__ uint4 lane_chunk(const uint8_t* __restrict__ lane,
                                            int64_t o, int64_t n_bytes) {
  if (o >= 0 && o + 16 <= n_bytes) {
    return *reinterpret_cast<const uint4*>(lane + o);  // o is 16-aligned
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16; ++i) {
    int64_t k = o + i;
    if (k >= 0 && k < n_bytes) w[i >> 2] |= static_cast<uint32_t>(lane[k])
                                            << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kThreads)
hybrid_extract_kernel(const uint8_t* __restrict__ lane, int64_t n_bytes,
                      const int32_t* __restrict__ runs,
                      const int32_t* __restrict__ tiles, int n_tiles,
                      int64_t h_total, uint32_t* __restrict__ out) {
  __shared__ uint4 window[kWindowChunks];

  const int t = blockIdx.x;
  const int64_t first = tiles[2 * t + 1];
  const int64_t end = t + 1 < n_tiles ? tiles[2 * t + 3] : h_total;
  const int32_t* row = runs + static_cast<int64_t>(tiles[2 * t]) * kRunF;
  const int64_t start = row[0];
  const int64_t count = row[1];
  const int64_t bit0 = row[2];
  const int w = row[3];
  // this thread's 4 positions: an aligned group of the tile's chunk
  const int64_t g = (first & ~static_cast<int64_t>(kTile - 1)) +
                    4 * static_cast<int64_t>(threadIdx.x);
  const bool whole = g >= first && g + 4 <= end;

  if (row[4] == 1 || w == 0) {  // a fill: the RLE value, or 0 at width 0
    const uint32_t v = row[4] == 1 ? static_cast<uint32_t>(row[5]) : 0u;
    if (whole) {
      *reinterpret_cast<uint4*>(out + g) = make_uint4(v, v, v, v);
    } else {
      for (int k = 0; k < 4; ++k) {
        if (g + k >= first && g + k < end) out[g + k] = v;
      }
    }
    return;  // the whole block takes this branch: no barrier follows
  }

  // the lane bytes of the tile's positions, j clipped to [0, count] as
  // the plain version clips them
  auto clip = [count](int64_t j) {
    return j < 0 ? int64_t{0} : (j > count ? count : j);
  };
  const int64_t byte_lo = (bit0 + clip(first - start) * w) >> 3;
  const int64_t byte_hi = ((bit0 + clip(end - 1 - start) * w) >> 3) + 8;
  const int64_t mis = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(lane) & 15);
  // the window starts at a lane offset whose address is 16-byte aligned
  const int64_t base = ((byte_lo + mis) & ~static_cast<int64_t>(15)) - mis;
  const int n_chunks = static_cast<int>((byte_hi - base + 15) >> 4);
  for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
    window[c] = lane_chunk(lane, base + 16 * static_cast<int64_t>(c), n_bytes);
  }
  __syncthreads();

  const uint32_t* words = reinterpret_cast<const uint32_t*>(window);
  const uint32_t mask = w >= 32 ? 0xffffffffu : ((1u << w) - 1u);
  auto value = [&](int64_t h) -> uint32_t {
    const int64_t bit = bit0 + clip(h - start) * w;
    const int64_t local = (bit >> 3) - base;
    const int64_t word = local >> 2;
    const uint64_t pair = static_cast<uint64_t>(words[word]) |
                          (static_cast<uint64_t>(words[word + 1]) << 32);
    const int shift = static_cast<int>(8 * (local & 3) + (bit & 7));
    return static_cast<uint32_t>(pair >> shift) & mask;
  };
  if (whole) {
    *reinterpret_cast<uint4*>(out + g) =
        make_uint4(value(g), value(g + 1), value(g + 2), value(g + 3));
  } else {
    for (int k = 0; k < 4; ++k) {
      if (g + k >= first && g + k < end) out[g + k] = value(g + k);
    }
  }
}

}  // namespace

extern "C" int hybrid_extract_launch(const void* lane, long long n_bytes,
                                     const void* runs, const void* tiles,
                                     int n_tiles, long long h_total,
                                     void* out, int device, void* stream) {
  if (n_tiles <= 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hybrid_extract_kernel<<<n_tiles, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lane), n_bytes,
      static_cast<const int32_t*>(runs), static_cast<const int32_t*>(tiles),
      n_tiles, h_total, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

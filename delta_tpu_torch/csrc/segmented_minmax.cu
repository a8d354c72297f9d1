// K6 `segmented_minmax`: per-file min, max and valid count of a masked
// float32 matrix, hand-written for Hopper (sm_90a).
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
// float atomics and no scratch: every combine is exact and associative, so
// the result does not depend on the order of the blocks.
//
// Bound: bytes, 4 B of value and 1 B of mask per entry (50 MB, ~15 us at
// 3.35 TB/s on an H100 SXM, at the chip shape F = 20, R = 500,000).
//
// Design: one launch per call, one kernel, two ways to cover a row.
// - Long rows (R > kWarpRowMax): a thread block cluster per row, of
//   ceil(R / kBlockEntries) blocks up to the portable 8 (the chip shape:
//   20 clusters of 8 = 160 blocks over 132 SMs). The cluster's threads
//   stride over the row; each block reduces its threads' partials with
//   warp shuffles and shared memory, then, after cluster.sync(), block 0
//   reads the other blocks' partials through distributed shared memory and
//   writes the row's three results. A second cluster.sync() keeps the
//   peers' shared memory alive until it has been read. A row longer than
//   the cluster's threads cover loops inside them. Few rows of this kind
//   (F * 8 < 132 SMs, one row at the extreme) leave SMs idle.
// - Short rows (R <= kWarpRowMax, e.g. the tests' F = 70,000, R = 3): a
//   warp per row, 16 rows per block; no cluster and no block barrier.
// Loads: a unit of 16 entries is four 16-byte value loads and one 16-byte
// mask load; values are loaded whatever the mask says (their sectors are
// read anyway) and the mask is folded in registers. Each thread keeps two
// units in flight. A row whose mask does not start 16-byte aligned (R not
// a multiple of 16, or a view at an odd offset) takes its head and tail
// entry by entry; values and mask whose alignments cannot meet (the value
// address / 4 and the mask address differ mod 4) go entry by entry
// throughout, inside the same kernel.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;               // portable cluster size
constexpr long long kBlockEntries = 32768;   // a row's entries per block
constexpr long long kWarpRowMax = 2048;      // rows up to this: a warp each
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

__device__ __forceinline__ Part identity() {
  return {kKeyPosInf, kKeyNegInf, 0, 0};
}

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

__device__ __forceinline__ void take(Part& p, uint32_t bits, bool valid) {
  const int32_t k = order_key(bits);
  p.lo = min(p.lo, valid ? k : kKeyPosInf);
  p.hi = max(p.hi, valid ? k : kKeyNegInf);
  p.count += valid ? 1 : 0;
  p.nan |= (valid && is_nan(bits)) ? 1 : 0;
}

// One unit: 16 entries, values v[0..3] (4 each), mask bytes m.
__device__ __forceinline__ void take_unit(Part& p, const uint4 (&v)[4],
                                          const uint4& m) {
  const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t vw[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      take(p, vw[c], ((mw[q] >> (8 * c)) & 0xFFu) != 0);
    }
  }
}

__device__ __forceinline__ void load_unit(const uint4* v, const uint4* m,
                                          long long u, uint4 (&vo)[4],
                                          uint4& mo) {
#pragma unroll
  for (int q = 0; q < 4; ++q) vo[q] = __ldg(v + 4 * u + q);
  mo = __ldg(m + u);
}

// Thread `t` of `t_count`'s share of the entries [0, r) of one row.
__device__ __forceinline__ Part row_share(const uint32_t* __restrict__ v,
                                          const uint8_t* __restrict__ m,
                                          long long r, long long t,
                                          long long t_count, int vec) {
  Part p = identity();
  long long head = 0, units = 0;
  if (vec) {
    head = (16 - static_cast<long long>(
                     reinterpret_cast<uintptr_t>(m) % 16)) % 16;
    if (head > r) head = r;
    units = (r - head) / 16;
  }
  const long long body_end = head + 16 * units;
  for (long long i = t; i < head; i += t_count) {
    take(p, __ldg(v + i), __ldg(m + i) != 0);
  }
  for (long long i = body_end + t; i < r; i += t_count) {
    take(p, __ldg(v + i), __ldg(m + i) != 0);
  }
  const uint4* vv = reinterpret_cast<const uint4*>(v + head);
  const uint4* mm = reinterpret_cast<const uint4*>(m + head);
  long long u = t;
  for (; u + t_count < units; u += 2 * t_count) {
    uint4 va[4], vb[4], ma, mb;
    load_unit(vv, mm, u, va, ma);
    load_unit(vv, mm, u + t_count, vb, mb);
    take_unit(p, va, ma);
    take_unit(p, vb, mb);
  }
  if (u < units) {
    uint4 va[4], ma;
    load_unit(vv, mm, u, va, ma);
    take_unit(p, va, ma);
  }
  return p;
}

// out: int32 [3 F]: min bits, max bits, counts
__device__ __forceinline__ void write_row(int32_t* out, int f_rows,
                                          long long f, Part p) {
  // the key is an involution: decode with the same flip
  out[f] = p.nan ? static_cast<int32_t>(kQuietNan) : order_key(p.lo);
  out[f_rows + f] = p.nan ? static_cast<int32_t>(kQuietNan) : order_key(p.hi);
  out[2LL * f_rows + f] = p.count;
}

__global__ void __launch_bounds__(kThreads)
segmented_minmax_kernel(const uint32_t* __restrict__ values,
                        const uint8_t* __restrict__ valid, int f_rows,
                        long long r, int vec, int warp_rows,
                        int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp_rows) {
    const long long f = static_cast<long long>(blockIdx.x) * kWarps + warp;
    if (f >= f_rows) return;  // whole warps: no block barrier below
    Part p = warp_reduce(row_share(values + f * r, valid + f * r, r, lane,
                                   32, vec));
    if (lane == 0) write_row(out, f_rows, f, p);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cs = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const long long f = blockIdx.x / cs;
  Part p = warp_reduce(row_share(
      values + f * r, valid + f * r, r,
      static_cast<long long>(rank) * kThreads + threadIdx.x,
      static_cast<long long>(cs) * kThreads, vec));
  __shared__ Part warps[kWarps];
  __shared__ Part block_part;
  if (lane == 0) warps[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = warp_reduce(lane < kWarps ? warps[lane] : identity());
    if (lane == 0) block_part = p;
  }
  cluster.sync();
  if (rank == 0 && warp == 0) {
    p = warp_reduce(lane < static_cast<int>(cs)
                        ? *cluster.map_shared_rank(&block_part, lane)
                        : identity());
    if (lane == 0) write_row(out, f_rows, f, p);
  }
  cluster.sync();  // peers keep their shared memory until block 0 has read it
}

}  // namespace

// Launches the one kernel on `stream` of CUDA device `device`; returns the
// CUDA error code (0 = launched). out: int32 [3 * f_rows].
extern "C" int segmented_minmax_launch(const void* values, const void* valid,
                                       int f_rows, long long r, void* out,
                                       int device, void* stream) {
  if (f_rows <= 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const uintptr_t va = reinterpret_cast<uintptr_t>(values);
  const uintptr_t ma = reinterpret_cast<uintptr_t>(valid);
  const int vec = va % 4 == 0 && ((va >> 2) - ma) % 4 == 0;
  const int warp_rows = r <= kWarpRowMax;
  long long cs = 1;
  long long blocks = (f_rows + kWarps - 1) / kWarps;
  if (!warp_rows) {
    cs = (r + kBlockEntries - 1) / kBlockEntries;
    if (cs > kMaxCluster) cs = kMaxCluster;
    blocks = static_cast<long long>(f_rows) * cs;
  }
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, segmented_minmax_kernel,
                           static_cast<const uint32_t*>(values),
                           static_cast<const uint8_t*>(valid), f_rows, r, vec,
                           warp_rows, static_cast<int32_t*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

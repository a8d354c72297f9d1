// K10 `seg_agg`: the segment aggregate of SQL's GROUP BY.
//
// Replaces the JAX package's jnp functions `_segagg_kernel`
// (delta_tpu/ops/sqlops.py:123, count, sum, min and max over dense group
// codes), `_group_sizes_kernel` (:215, COUNT(*)) and
// `_centered_sumsq_kernel` (:221, the second pass of the two-pass sample
// variance): queue B's B11, reached through `ops/sqlops.py::
// GroupAggregator` on every grouped or global aggregate.
//
// Inputs: codes int32 [n] (dense, in [0, G)), values int64 or float64 [n]
// (none for a count), valid uint8 [n] (none: every row valid), and for
// the sumsq pass the group means float64 [G]. Outputs: agg [G] (8-byte
// words: int64 or float64 bits) and count int64 [G], the number of valid
// rows of each group. A row that is not valid takes part in no count,
// sum or sumsq.
//   op 0 count : agg is not written (the caller reads count)
//   op 1 sum   : int64 wraps on overflow (two's complement, as jnp's
//                segment_sum); float64 in the order the atomics land
//   op 2 min, op 3 max : as the reference, a row that is not valid folds
//                its `big` (int64 INT64_MAX for min, -INT64_MAX for
//                max; float64 +inf / -inf) and a group with no row at all
//                holds the reduction's identity (INT64_MAX, INT64_MIN,
//                +inf, -inf). Floats reduce the order-preserving
//                int64 image of their bits (the sign flips the other 63),
//                so -0.0 orders below +0.0 and the result is bit exact
//   op 4 sumsq : sum over valid rows of (v - means[code])^2, float64
//
// Bound: bytes. The function reads 4 + 8 + 1 bytes a row and writes 16
// bytes a group (and reads 8 bytes of means a group for sumsq).
//
// Design, simple and right: a grid-stride loop, one row per thread per
// step, 64-bit atomics. With G <= kSharedGroups every block first
// accumulates into its own table in shared memory (shared atomics: TPC-DS
// groups are often few, q43 groups by 12 stores, and 2.88M global atomics
// on 12 words serialize) and then flushes each touched entry with one
// global atomic; past that the rows go straight to global memory, where
// contention is low because the groups are many.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedGroups = 1024;  // 16 KiB of tables a block
constexpr int kBlocksPerSm = 4;

enum Op { kCount = 0, kSum = 1, kMin = 2, kMax = 3, kSumsq = 4 };

constexpr long long kI64Max = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ long long order_image(long long bits) {
  return bits ^ ((bits >> 63) & kI64Max);
}

// the identity of an op's 8-byte word (float ops as their image)
__host__ __device__ __forceinline__ long long identity(int op,
                                                       bool is_float) {
  if (op == kMin) return is_float ? 0x7FF0000000000000LL : kI64Max;
  if (op == kMax)
    // the image of -inf's bits 0xFFF0000000000000 is -0x7FF0000000000001
    return is_float ? -0x7FF0000000000001LL : -kI64Max - 1;
  return 0;  // sums: 0 and +0.0 share their bits
}

// an int64 max folds -INT64_MAX for a row that is not valid (the
// reference's -big); every other op's invalid row changes nothing
template <int OP, bool FLOAT>
__device__ __forceinline__ void fold_invalid(long long* agg, int g) {
  if (OP == kMax && !FLOAT) atomicMax(agg + g, -kI64Max);
}

template <int OP, bool FLOAT>
__device__ __forceinline__ void fold(long long* agg, unsigned long long* cnt,
                                     int g, const void* values, int64_t i,
                                     const double* means) {
  atomicAdd(cnt + g, 1ULL);
  if (OP == kCount) return;
  if (OP == kSumsq) {
    const double d = static_cast<const double*>(values)[i] - means[g];
    atomicAdd(reinterpret_cast<double*>(agg + g), d * d);
    return;
  }
  if (FLOAT) {
    const double v = static_cast<const double*>(values)[i];
    if (OP == kSum) {
      atomicAdd(reinterpret_cast<double*>(agg + g), v);
      return;
    }
    const long long key = order_image(__double_as_longlong(v));
    if (OP == kMin) atomicMin(agg + g, key);
    else atomicMax(agg + g, key);
    return;
  }
  const long long v = static_cast<const long long*>(values)[i];
  if (OP == kSum)
    atomicAdd(reinterpret_cast<unsigned long long*>(agg + g),
              static_cast<unsigned long long>(v));
  else if (OP == kMin) atomicMin(agg + g, v);
  else atomicMax(agg + g, v);
}

// flush one shared entry into the global tables
template <int OP, bool FLOAT>
__device__ __forceinline__ void flush(long long* agg, unsigned long long* cnt,
                                      int g, long long a,
                                      unsigned long long c) {
  atomicAdd(cnt + g, c);
  if (OP == kCount) return;
  if (OP == kSum && !FLOAT)
    atomicAdd(reinterpret_cast<unsigned long long*>(agg + g),
              static_cast<unsigned long long>(a));
  else if (OP == kSum || OP == kSumsq)
    atomicAdd(reinterpret_cast<double*>(agg + g), __longlong_as_double(a));
  else if (OP == kMin) atomicMin(agg + g, a);
  else atomicMax(agg + g, a);
}

__global__ void seg_agg_init(long long* agg, unsigned long long* cnt,
                             int n_groups, long long ident) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  cnt[g] = 0;
  if (agg != nullptr) agg[g] = ident;
}

template <int OP, bool FLOAT>
__global__ void seg_agg_shared(const int32_t* __restrict__ codes,
                               const void* __restrict__ values,
                               const uint8_t* __restrict__ valid, int64_t n,
                               int n_groups, const double* __restrict__ means,
                               long long* agg, unsigned long long* cnt) {
  __shared__ long long s_agg[kSharedGroups];
  __shared__ unsigned long long s_cnt[kSharedGroups];
  const long long ident = identity(OP, FLOAT);
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    s_agg[g] = ident;
    s_cnt[g] = 0;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int g = codes[i];
    if (g < 0 || g >= n_groups) continue;
    if (valid != nullptr && valid[i] == 0)
      fold_invalid<OP, FLOAT>(s_agg, g);
    else
      fold<OP, FLOAT>(s_agg, s_cnt, g, values, i, means);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n_groups; g += kThreads)
    if (s_cnt[g] != 0 || s_agg[g] != ident)
      flush<OP, FLOAT>(agg, cnt, g, s_agg[g], s_cnt[g]);
}

template <int OP, bool FLOAT>
__global__ void seg_agg_global(const int32_t* __restrict__ codes,
                               const void* __restrict__ values,
                               const uint8_t* __restrict__ valid, int64_t n,
                               int n_groups, const double* __restrict__ means,
                               long long* agg, unsigned long long* cnt) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int g = codes[i];
    if (g < 0 || g >= n_groups) continue;
    if (valid != nullptr && valid[i] == 0)
      fold_invalid<OP, FLOAT>(agg, g);
    else
      fold<OP, FLOAT>(agg, cnt, g, values, i, means);
  }
}

// float min/max: the images back to float64 bits, in place
__global__ void seg_agg_unimage(long long* agg, int n_groups) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < n_groups) agg[g] = order_image(agg[g]);
}

template <int OP, bool FLOAT>
void launch_rows(const int32_t* codes, const void* values,
                 const uint8_t* valid, int64_t n, int n_groups,
                 const double* means, long long* agg,
                 unsigned long long* cnt, unsigned blocks,
                 cudaStream_t stream) {
  if (n_groups <= kSharedGroups)
    seg_agg_shared<OP, FLOAT><<<blocks, kThreads, 0, stream>>>(
        codes, values, valid, n, n_groups, means, agg, cnt);
  else
    seg_agg_global<OP, FLOAT><<<blocks, kThreads, 0, stream>>>(
        codes, values, valid, n, n_groups, means, agg, cnt);
}

int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int c = 0;
    if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || c <= 0)
      c = 132;
    counts[device] = c;
  }
  return counts[device];
}

}  // namespace

// codes int32 [n]; values int64/float64 [n] (null for op 0, or n = 0,
// where an empty tensor's pointer is null); valid uint8 [n]
// or null; means float64 [n_groups] (op 4 only); agg [n_groups] 8-byte
// words or null (op 0); count int64 [n_groups]. Returns the CUDA error of
// the launches.
extern "C" int seg_agg_launch(const void* codes, const void* values,
                              const void* valid, long long n, int n_groups,
                              int op, int is_float, const void* means,
                              void* agg, void* count, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || n_groups < 0 || op < kCount || op > kSumsq ||
      (op != kCount && (agg == nullptr || (n > 0 && values == nullptr))) ||
      (op == kSumsq && (means == nullptr || !is_float)) || count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fl = is_float != 0;
  long long* a = static_cast<long long*>(op == kCount ? nullptr : agg);
  unsigned long long* c = static_cast<unsigned long long*>(count);
  const unsigned init_blocks = (n_groups + kThreads - 1) / kThreads;
  seg_agg_init<<<init_blocks, kThreads, 0, s>>>(a, c, n_groups,
                                                identity(op, fl));
  if (n > 0) {
    long long want = (n + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sm_count(device)) *
                          kBlocksPerSm;
    const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
    const int32_t* cd = static_cast<const int32_t*>(codes);
    const uint8_t* vd = static_cast<const uint8_t*>(valid);
    const double* md = static_cast<const double*>(means);
#define SEG_AGG_CASE(OP, FL)                                                \
  launch_rows<OP, FL>(cd, values, vd, n, n_groups, md, a, c, blocks, s)
    switch (op) {
      case kCount: SEG_AGG_CASE(kCount, false); break;
      case kSum: if (fl) SEG_AGG_CASE(kSum, true); else SEG_AGG_CASE(kSum, false); break;
      case kMin: if (fl) SEG_AGG_CASE(kMin, true); else SEG_AGG_CASE(kMin, false); break;
      case kMax: if (fl) SEG_AGG_CASE(kMax, true); else SEG_AGG_CASE(kMax, false); break;
      default: SEG_AGG_CASE(kSumsq, true); break;
    }
#undef SEG_AGG_CASE
  }
  if (fl && (op == kMin || op == kMax))
    seg_agg_unimage<<<init_blocks, kThreads, 0, s>>>(a, n_groups);
  return static_cast<int>(cudaGetLastError());
}

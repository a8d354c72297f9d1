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
// sum or sumsq; a row whose code lies outside [0, G) takes part in
// nothing.
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
// bytes a group (and reads 8 bytes of means a group for sumsq). What sets
// the pace instead is the atomics: a 64-bit global atomic for a row's
// count and one for its value queue in L2, and shared atomics of many
// lanes on the words of few groups serialise.
//
// Design: two launches a call, an init kernel (count 0, agg the op's
// identity in global memory) and one rows kernel in one of three regimes,
// chosen here by G (and n):
// - Lane tables (G <= kLaneGroups = 16): every thread owns G 8-byte words
//   and G 32-bit counts in shared memory (group-major, so a warp's lanes
//   touch neighbouring words) and updates them with plain loads and
//   stores: no atomic and no exchange between lanes. Each warp then folds
//   one group's column of the block with shuffles and sends one global
//   atomic per touched group and word. TPC-DS's group-bys by store (12
//   groups) and q43's (6) run here.
// - A cluster's tables (G up to the card's opt-in shared memory, 227 KiB
//   a block: 19,370 groups of 12 bytes): every block of 1,024 threads
//   holds the whole table in dynamic shared memory and updates it with
//   shared-memory atomics. A thread block cluster of kCluster = 4 blocks
//   then folds its four tables through distributed shared memory
//   (`map_shared_rank`), each block a quarter of the groups, and sends one
//   global atomic per touched group and word: the flush costs one table a
//   cluster, not one a block. The sumsq pass copies the means beside the
//   table where both fit (G <= 11,622): L1 keeps little once the table
//   takes the shared memory. By item (11,521 groups) runs here.
// - Global atomics (past that, or n >= 2^32, where a table's 32-bit
//   counts could overflow): rows go by warp steps of 128, slot j of lane l
//   being row 32 j + l, so a run of one code lies on neighbouring lanes; a
//   segmented scan (5 shuffle rounds, skipped where no run crosses a lane)
//   folds each run into its first lane, which alone sends the run's word
//   and count. A ticket's line items and their customers come in such
//   runs: by customer (57,608 groups) and by ticket run here.
// The table regimes read 4 consecutive rows a thread a step (16-byte loads
// of codes and values, 4 bytes of mask, where the pointers allow; else row
// by row) and fold the rows that continue one run first; the global one
// reads 4 rows a thread 32 apart. Each keeps the next step's loads in
// flight while it folds the current one. Float min and max go to global
// memory as float bits: a non-negative value by a signed atomic, a
// negative one by the opposite unsigned atomic, which orders the bits as
// the image orders them, so no pass turns images back into floats. A
// refused shared-memory size or launch returns its CUDA error: there is
// no other path.
//
// Tried on an H100 and not kept (PERF.md §6): warp tables whose lanes
// fold by `__match_any_sync` before one plain update (by store 0.024 ms
// against the lane tables' 0.012), a table split over a cluster with each
// row's atomic sent to its owner through distributed shared memory (by
// item 0.078-0.159 ms), `__match_any_sync` and a shuffle tree before the
// global atomics (by customer 0.027 ms against the scan's 0.019), and
// clusters of 1, 2, 8 and 16 blocks (by item 0.030, 0.025, 0.025 and
// 0.032 ms against 0.024 for 4).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

enum Op { kCount = 0, kSum = 1, kMin = 2, kMax = 3, kSumsq = 4 };
enum Mode { kLaneTables = 0, kClusterTables = 1 };

constexpr int kLaneThreads = 256;
constexpr int kTableThreads = 1024;
constexpr int kGlobalThreads = 512;
constexpr int kInitThreads = 256;
constexpr int kEntryBytes = 12;           // 8 B word + 4 B count
constexpr int kLaneGroups = 16;           // 256 x 16 x 12 B = 48 KiB
constexpr int kTableBytes = 232448;       // opt-in shared memory a block
constexpr int kCluster = 4;               // blocks a cluster
constexpr int kLaneBlocksPerSm = 4;
constexpr int kGlobalBlocksPerSm = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kI64Max = 0x7FFFFFFFFFFFFFFFLL;

__host__ __device__ constexpr int block_threads(int mode) {
  return mode == kLaneTables ? kLaneThreads : kTableThreads;
}

__host__ __device__ __forceinline__ long long order_image(long long bits) {
  return bits ^ ((bits >> 63) & kI64Max);
}

// the identity of an op's 8-byte word in a table (float ops as their
// image)
__host__ __device__ __forceinline__ long long identity(int op,
                                                       bool is_float) {
  if (op == kMin) return is_float ? 0x7FF0000000000000LL : kI64Max;
  if (op == kMax)
    // the image of -inf's bits 0xFFF0000000000000 is -0x7FF0000000000001
    return is_float ? -0x7FF0000000000001LL : -kI64Max - 1;
  return 0;  // sums: 0 and +0.0 share their bits
}

// the identity in global memory, where floats are bits
__host__ __device__ __forceinline__ long long global_identity(int op,
                                                              bool is_float) {
  const long long ident = identity(op, is_float);
  return is_float && (op == kMin || op == kMax) ? order_image(ident) : ident;
}

// a thread's share of one row or run: its code (-1: takes no part), the
// number of valid rows folded into it, and its word
struct Item {
  int key;
  unsigned c;
  long long w;
};

template <int OP, bool FLOAT>
__device__ __forceinline__ long long combine(long long a, long long b) {
  if (OP == kSum && !FLOAT)
    return static_cast<long long>(static_cast<unsigned long long>(a) +
                                  static_cast<unsigned long long>(b));
  if (OP == kSum || OP == kSumsq)
    return __double_as_longlong(__longlong_as_double(a) +
                                __longlong_as_double(b));
  if (OP == kMin) return a < b ? a : b;
  if (OP == kMax) return a > b ? a : b;
  return a;
}

// one row into an Item. An int64 max folds -INT64_MAX for a row that is
// not valid (the reference's -big), with no count; every other op's
// invalid row takes no part, as its `big` is the identity.
template <int OP, bool FLOAT>
__device__ __forceinline__ Item make_item(int code, bool ok, long long raw,
                                          int n_groups,
                                          const double* __restrict__ means) {
  Item it;
  it.c = ok ? 1u : 0u;
  it.w = identity(OP, FLOAT);
  const bool part = code >= 0 && code < n_groups &&
                    (ok || (OP == kMax && !FLOAT));
  it.key = part ? code : -1;
  if (!part || OP == kCount) return it;
  if (OP == kSumsq) {
    const double d = __longlong_as_double(raw) - means[code];
    it.w = __double_as_longlong(d * d);
  } else if (FLOAT) {
    it.w = OP == kSum ? raw : order_image(raw);
  } else {
    it.w = ok ? raw : -kI64Max;
  }
  return it;
}

// 4 consecutive rows, as loaded
struct Quad {
  int4 c;
  long long v[4];
  unsigned m;  // 4 mask bytes, row 0 lowest
};

struct Args {
  const int32_t* codes;
  const long long* values;  // raw 8-byte words; null for a count
  const uint8_t* valid;     // null: every row valid
  long long n;
  int n_groups;
  const double* means;
  long long* agg;  // null for a count
  unsigned long long* cnt;
  int vec;  // 16-byte loads of codes and values, 4-byte of the mask
  int smem_means;  // sumsq in a cluster's tables: means copied beside them
};

template <int OP>
__device__ __forceinline__ Quad load_quad(const Args& a, long long q) {
  Quad r;
  const long long i = 4 * q;
  if (a.vec && i + 3 < a.n) {
    r.c = __ldcs(reinterpret_cast<const int4*>(a.codes + i));
    if (OP != kCount) {
      const longlong2 v0 =
          __ldcs(reinterpret_cast<const longlong2*>(a.values + i));
      const longlong2 v1 =
          __ldcs(reinterpret_cast<const longlong2*>(a.values + i + 2));
      r.v[0] = v0.x;
      r.v[1] = v0.y;
      r.v[2] = v1.x;
      r.v[3] = v1.y;
    }
    r.m = a.valid == nullptr
              ? 0x01010101u
              : __ldcs(reinterpret_cast<const unsigned*>(a.valid + i));
    return r;
  }
  int c[4];
  r.m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = i + j < a.n;
    c[j] = in ? __ldcs(a.codes + i + j) : -1;
    r.v[j] = in && OP != kCount ? __ldcs(a.values + i + j) : 0;
    const unsigned ok = in && (a.valid == nullptr || __ldcs(a.valid + i + j));
    r.m |= ok << (8 * j);
  }
  r.c = make_int4(c[0], c[1], c[2], c[3]);
  return r;
}

// fold an item into the block's shared table, which its other threads
// update too
template <int OP, bool FLOAT>
__device__ __forceinline__ void table_atomic(long long* w, unsigned* c,
                                             const Item& it) {
  if (it.c != 0) atomicAdd(c, it.c);
  if (OP == kCount) return;
  if (OP == kSum && !FLOAT)
    atomicAdd(reinterpret_cast<unsigned long long*>(w),
              static_cast<unsigned long long>(it.w));
  else if (OP == kSum || OP == kSumsq)
    atomicAdd(reinterpret_cast<double*>(w), __longlong_as_double(it.w));
  else if (OP == kMin)
    atomicMin(w, it.w);
  else
    atomicMax(w, it.w);
}

// fold a table's word (float min/max as the image) and count into the
// global outputs
template <int OP, bool FLOAT>
__device__ __forceinline__ void global_atomic(const Args& a, int g,
                                              long long w, unsigned c) {
  if (c != 0) atomicAdd(a.cnt + g, static_cast<unsigned long long>(c));
  if (OP == kCount) return;
  long long* p = a.agg + g;
  if (OP == kSum && !FLOAT) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(w));
  } else if (OP == kSum || OP == kSumsq) {
    atomicAdd(reinterpret_cast<double*>(p), __longlong_as_double(w));
  } else if (!FLOAT) {
    if (OP == kMin) atomicMin(p, w);
    else atomicMax(p, w);
  } else {
    // float bits: signed order for a non-negative value, reversed
    // unsigned order for a negative one
    const long long bits = order_image(w);
    unsigned long long* u = reinterpret_cast<unsigned long long*>(p);
    const unsigned long long ub = static_cast<unsigned long long>(bits);
    if (OP == kMin) {
      if (bits >= 0) atomicMin(p, bits);
      else atomicMax(u, ub);
    } else {
      if (bits >= 0) atomicMax(p, bits);
      else atomicMin(u, ub);
    }
  }
}

__global__ void seg_agg_init(long long* agg, unsigned long long* cnt,
                             int n_groups, long long ident) {
  const int g = blockIdx.x * kInitThreads + threadIdx.x;
  if (g >= n_groups) return;
  cnt[g] = 0;
  if (agg != nullptr) agg[g] = ident;
}

template <int OP, bool FLOAT, int MODE>
__global__ void __launch_bounds__(block_threads(MODE))
    seg_agg_rows(const Args a) {
  constexpr int T = block_threads(MODE);
  constexpr int W = T / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ident = identity(OP, FLOAT);
  const int G = a.n_groups;
  // lane tables: words [G][T], then counts [G][T]; a cluster's tables:
  // words [G], the sumsq pass's means [G] where they fit, then counts [G]
  const int entries = MODE == kLaneTables ? G * T : G;
  long long* tw = reinterpret_cast<long long*>(smem);
  double* sm = reinterpret_cast<double*>(tw + entries);
  const double* means = a.smem_means ? sm : a.means;
  unsigned* tc = reinterpret_cast<unsigned*>(sm + (a.smem_means ? G : 0));
  for (int i = threadIdx.x; i < entries; i += T) {
    tw[i] = ident;
    tc[i] = 0;
    if (a.smem_means) sm[i] = a.means[i];
  }
  __syncthreads();

  const long long n_quads = (a.n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * T;
  long long q = (static_cast<long long>(blockIdx.x) * W + warp) * 32;
  Quad next = {};
  if (q + lane < n_quads) next = load_quad<OP>(a, q + lane);
  for (; q < n_quads; q += stride) {  // uniform in the warp
    const Quad cur = next;
    if (q + stride + lane < n_quads)
      next = load_quad<OP>(a, q + stride + lane);
    Item it[4];
    const bool live = q + lane < n_quads;
    const int cj[4] = {cur.c.x, cur.c.y, cur.c.z, cur.c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      it[j] = make_item<OP, FLOAT>(live ? cj[j] : -1,
                                   (cur.m >> (8 * j)) & 0xFFu, cur.v[j], G,
                                   means);
    // a run of one code inside the thread's 4 rows folds into its first
#pragma unroll
    for (int j = 3; j > 0; --j)
      if (it[j].key >= 0 && it[j].key == it[j - 1].key) {
        it[j - 1].c += it[j].c;
        it[j - 1].w = combine<OP, FLOAT>(it[j - 1].w, it[j].w);
        it[j].key = -1;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = it[j].key;
      if (g < 0) continue;
      if (MODE == kLaneTables) {
        const int at = g * T + threadIdx.x;
        tc[at] += it[j].c;
        if (OP != kCount) tw[at] = combine<OP, FLOAT>(tw[at], it[j].w);
      } else {
        table_atomic<OP, FLOAT>(tw + g, tc + g, it[j]);
      }
    }
  }

  if (MODE == kLaneTables) {
    // a warp a group: its T lanes' entries, then a shuffle tree
    __syncthreads();
    for (int g = warp; g < G; g += W) {
      long long w = ident;
      unsigned c = 0;
#pragma unroll
      for (int t = lane; t < T; t += 32) {
        c += tc[g * T + t];
        if (OP != kCount) w = combine<OP, FLOAT>(w, tw[g * T + t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_xor_sync(kFull, c, off);
        if (OP != kCount)
          w = combine<OP, FLOAT>(w, __shfl_xor_sync(kFull, w, off));
      }
      if (lane == 0 && (c != 0 || w != ident))
        global_atomic<OP, FLOAT>(a, g, w, c);
    }
  } else {
    // every block's table done; each block folds one slice of the groups
    // over the cluster's tables, read through distributed shared memory
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int cs = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int slice = (G + cs - 1) / cs;
    const int hi = min(G, (rank + 1) * slice);
    for (int g = rank * slice + threadIdx.x; g < hi; g += T) {
      long long w = ident;
      unsigned c = 0;
#pragma unroll 4
      for (int r = 0; r < cs; ++r) {
        c += cluster.map_shared_rank(tc, r)[g];
        if (OP != kCount)
          w = combine<OP, FLOAT>(w, cluster.map_shared_rank(tw, r)[g]);
      }
      if (c != 0 || w != ident) global_atomic<OP, FLOAT>(a, g, w, c);
    }
    cluster.sync();  // peers keep their tables until every slice is read
  }
}

// one row of the global regime: code, word and mask of row i (past the
// last row, code -1: the row takes no part)
template <int OP>
__device__ __forceinline__ void load_row(const Args& a, long long i,
                                         int& code, long long& raw,
                                         bool& ok) {
  const bool in = i < a.n;
  code = in ? __ldcs(a.codes + i) : -1;
  raw = in && OP != kCount ? __ldcs(a.values + i) : 0;
  ok = in && (a.valid == nullptr || __ldcs(a.valid + i) != 0);
}

// Global atomics, rows by warp steps of 128: slot j of lane l is row
// 32 j + l, so a run of one code lies on neighbouring lanes. A segmented
// scan folds each run into its first lane (5 shuffle rounds, skipped when
// no run crosses a lane), which alone sends the run's word and count.
template <int OP, bool FLOAT>
__global__ void __launch_bounds__(kGlobalThreads)
    seg_agg_global(const Args a) {
  constexpr int W = kGlobalThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = a.n_groups;
  const long long stride = static_cast<long long>(gridDim.x) * W * 128;
  long long base = (static_cast<long long>(blockIdx.x) * W + warp) * 128;
  int code[4];
  long long raw[4];
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    load_row<OP>(a, base + 32 * j + lane, code[j], raw[j], ok[j]);
  for (; base < a.n; base += stride) {  // uniform in the warp
    Item cur[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cur[j] = make_item<OP, FLOAT>(code[j], ok[j], raw[j], G, a.means);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      load_row<OP>(a, base + stride + 32 * j + lane, code[j], raw[j], ok[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Item& it = cur[j];
      const int up = __shfl_up_sync(kFull, it.key, 1);
      const int down = __shfl_down_sync(kFull, it.key, 1);
      const bool head = lane == 0 || up != it.key;
      bool stop = lane == 31 || down != it.key;  // the run ends here
      if (__any_sync(kFull, !stop && it.key >= 0)) {
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned oc = __shfl_down_sync(kFull, it.c, d);
          const bool os = __shfl_down_sync(kFull, stop, d);
          long long ow = 0;
          if (OP != kCount) ow = __shfl_down_sync(kFull, it.w, d);
          if (!stop) {  // lane + d holds the run's next rows
            it.c += oc;
            if (OP != kCount) it.w = combine<OP, FLOAT>(it.w, ow);
            stop = os;
          }
        }
      }
      if (head && it.key >= 0)
        global_atomic<OP, FLOAT>(a, it.key, it.w, it.c);
    }
  }
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

cudaLaunchConfig_t config(unsigned blocks, int threads, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr,
                          int cs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (cs > 0) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// the clusters of kCluster blocks with `smem` bytes each that the card
// holds at once (opting the kernel in to the shared memory first), cached
// per device by size
template <int OP, bool FLOAT>
cudaError_t resident_clusters(int device, size_t smem, int* out) {
  constexpr int kSeen = 8;
  static bool opted[64] = {false};
  static size_t seen_smem[64][kSeen] = {};
  static int seen_clusters[64][kSeen] = {};
  static int next_slot[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  auto kernel = seg_agg_rows<OP, FLOAT, kClusterTables>;
  if (!opted[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
    if (err != cudaSuccess) return err;
    opted[device] = true;
  }
  for (int i = 0; i < kSeen; ++i) {
    if (seen_smem[device][i] == smem && seen_clusters[device][i] > 0) {
      *out = seen_clusters[device][i];
      return cudaSuccess;
    }
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(kCluster, kTableThreads, smem, nullptr, attr, kCluster);
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorLaunchOutOfResources;
  const int i = next_slot[device];
  next_slot[device] = (i + 1) % kSeen;
  seen_smem[device][i] = smem;
  seen_clusters[device][i] = clusters;
  *out = clusters;
  return cudaSuccess;
}

template <int OP, bool FLOAT>
cudaError_t launch_rows(const Args& a, int device, cudaStream_t stream) {
  const long long n_quads = (a.n + 3) >> 2;
  const long long sms = sm_count(device);
  const long long G = a.n_groups;
  const bool tables = a.n < (1LL << 32);
  cudaLaunchAttribute attr[1];
  auto blocks_for = [&](int threads, long long cap) {
    const long long want = (n_quads + threads - 1) / threads;
    return static_cast<unsigned>(want < cap ? want : cap);
  };
  if (tables && G <= kLaneGroups) {
    const size_t smem = static_cast<size_t>(G) * kLaneThreads * kEntryBytes;
    cudaLaunchConfig_t cfg =
        config(blocks_for(kLaneThreads, sms * kLaneBlocksPerSm),
               kLaneThreads, smem, stream, attr, 0);
    return cudaLaunchKernelEx(&cfg, seg_agg_rows<OP, FLOAT, kLaneTables>, a);
  }
  if (tables && G * kEntryBytes <= kTableBytes) {
    // the sumsq pass gathers a mean a row: from shared memory where the
    // card's 227 KiB hold them beside the table (L1 keeps little of them
    // once the table takes the shared memory)
    Args b = a;
    b.smem_means = OP == kSumsq && G * (kEntryBytes + 8) <= kTableBytes;
    const long long bytes = G * (kEntryBytes + (b.smem_means ? 8 : 0));
    const size_t smem = static_cast<size_t>((bytes + 15) / 16 * 16);
    int clusters = 0;
    cudaError_t err = resident_clusters<OP, FLOAT>(device, smem, &clusters);
    if (err != cudaSuccess) return err;
    const long long want =
        (n_quads + static_cast<long long>(kTableThreads) * kCluster - 1) /
        (static_cast<long long>(kTableThreads) * kCluster);
    const long long c = want < clusters ? want : clusters;
    cudaLaunchConfig_t cfg =
        config(static_cast<unsigned>(c * kCluster), kTableThreads, smem,
               stream, attr, kCluster);
    return cudaLaunchKernelEx(&cfg, seg_agg_rows<OP, FLOAT, kClusterTables>,
                              b);
  }
  cudaLaunchConfig_t cfg =
      config(blocks_for(kGlobalThreads, sms * kGlobalBlocksPerSm),
             kGlobalThreads, 0, stream, attr, 0);
  return cudaLaunchKernelEx(&cfg, seg_agg_global<OP, FLOAT>, a);
}

bool is_aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

}  // namespace

// codes int32 [n]; values int64/float64 [n] (null for op 0, or n = 0,
// where an empty tensor's pointer is null); valid uint8 [n]
// or null; means float64 [n_groups] (op 4 only); agg [n_groups] 8-byte
// words or null (op 0); count int64 [n_groups]. Returns the CUDA error of
// the launches (0: both launched).
extern "C" int seg_agg_launch(const void* codes, const void* values,
                              const void* valid, long long n, int n_groups,
                              int op, int is_float, const void* means,
                              void* agg, void* count, int device,
                              void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n < 0 || n_groups < 0 || op < kCount || op > kSumsq ||
      (op != kCount && (agg == nullptr || (n > 0 && values == nullptr))) ||
      (op == kSumsq && (means == nullptr || !is_float)) || count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fl = is_float != 0;
  Args a = {};
  a.codes = static_cast<const int32_t*>(codes);
  a.values = static_cast<const long long*>(op == kCount ? nullptr : values);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n = n;
  a.n_groups = n_groups;
  a.means = static_cast<const double*>(means);
  a.agg = static_cast<long long*>(op == kCount ? nullptr : agg);
  a.cnt = static_cast<unsigned long long*>(count);
  a.vec = is_aligned(codes, 16) &&
          (a.values == nullptr || is_aligned(values, 16)) &&
          (valid == nullptr || is_aligned(valid, 4));
  const unsigned init_blocks = (n_groups + kInitThreads - 1) / kInitThreads;
  seg_agg_init<<<init_blocks, kInitThreads, 0, s>>>(
      a.agg, a.cnt, n_groups, global_identity(op, fl));
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  switch (op) {
    case kCount: err = launch_rows<kCount, false>(a, device, s); break;
    case kSum:
      err = fl ? launch_rows<kSum, true>(a, device, s)
               : launch_rows<kSum, false>(a, device, s);
      break;
    case kMin:
      err = fl ? launch_rows<kMin, true>(a, device, s)
               : launch_rows<kMin, false>(a, device, s);
      break;
    case kMax:
      err = fl ? launch_rows<kMax, true>(a, device, s)
               : launch_rows<kMax, false>(a, device, s);
      break;
    default: err = launch_rows<kSumsq, true>(a, device, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

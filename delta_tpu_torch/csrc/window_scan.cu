// K11 `window_scan`: the segmented scans of SQL's window functions.
//
// Replaces three jnp functions of the JAX package's
// delta_tpu/ops/sqlops.py (queue B's B11): `_ranks_kernel` (:543),
// `_segscan_kernel` (:585) and `_peer_last_kernel` (:655). Reached through
// `ops/window.py` from `sqlengine/device.py::DeviceSpine.window_rank` and
// `window_running`, after the card's stable sort of a window's rows by
// (partition, order keys).
//
// Rows are in that sorted order. pb uint8 [n] marks the first row of each
// partition, kb uint8 [n] the first row of each run of equal order keys
// (kb includes pb; row 0 starts a partition whatever pb[0] holds). Three
// launchers:
//   window_ranks      (pb, kb) -> row_number, rank, dense_rank int64 [n],
//                     1-based within the partition: rank is the row
//                     number of the run's first row, dense_rank the number
//                     of runs from the partition's first row to this one.
//   window_running    (v float64 [n], valid uint8 [n], pb, op) ->
//                     (out float64 [n], count int64 [n]): the running
//                     aggregate of the valid values from the partition's
//                     first row to this one, and their count. op 0 sum
//                     (0 before any valid value), 1 mean (sum / max(count,
//                     1)), 2 count (out is the count as float64), 3 min,
//                     4 max (+inf / -inf before any valid value).
//   window_peer_last  (vals float64 [n], counts int64 [n], kb) -> each row
//                     takes the value and count of the last row of its kb
//                     run (the RANGE frame's peers share them).
//
// Design: each launcher is one associative scan over the rows with a
// state per row, run as three launches over 2048-row tiles (256 threads,
// 8 consecutive rows each):
//   1. `scan_reduce`: a block per tile folds its rows into the tile's
//      total state (each thread its 8 rows in order, then a warp scan by
//      shuffles and a scan of the 8 warp totals in shared memory);
//   2. `scan_carry`: one block turns the tile totals, in place, into each
//      tile's exclusive prefix (each thread a run of tiles in order, then
//      the block scan);
//   3. `scan_apply`: a block per tile folds its rows again from its tile's
//      carry and writes each row's outputs, one output at a time through
//      shared memory so that a warp stores 256 consecutive bytes.
// A segmented scan is an ordinary scan of (value, reset flag) states: the
// combine keeps the right operand alone where it starts a partition.
//   ranks:   (start, kstart, dense, reset): start and kstart are the last
//            pb and kb positions so far (a max scan), dense the number of
//            kb rows since the last pb (a segmented sum);
//   running: (value, count, reset): a segmented sum, min or max and the
//            segmented count of valid rows;
//   peers:   the scan runs backward (logical position p is row n-1-p): the
//            smallest kb position after the row (a min scan), the row's
//            run ending just before it.
// Every combine is exact but the float64 sum's, which adds in the tile
// and carry order above (the plain version scans each partition by
// doubling, the reference subtracts prefix sums: they agree to rounding).
//
// Bound: bytes. The function must read 2 B a row and write 24 (ranks),
// read 10 and write 16 (running), read 17 and write 16 (peers). This
// design reads every input twice (passes 1 and 3; the second read of a
// tile mostly from L2), each thread its 8 consecutive rows, and, for
// peers, gathers the value at each run's last row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr long long kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr long long kStateBytes = 32;  // the largest state, padded

// ------------------------------------------------------------- ranks --

struct RankState {
  long long start, kstart, dense;
  int reset;
};

struct RankOp {
  using State = RankState;
  const uint8_t* pb;
  const uint8_t* kb;
  long long n;
  long long* rn;
  long long* rk;
  long long* dr;

  __device__ static State identity() { return {-1, -1, 0, 0}; }
  __device__ static State combine(const State& a, const State& b) {
    return {a.start > b.start ? a.start : b.start,
            a.kstart > b.kstart ? a.kstart : b.kstart,
            b.reset ? b.dense : a.dense + b.dense, a.reset | b.reset};
  }
  __device__ static State shfl_up(const State& s, int d) {
    return {__shfl_up_sync(0xffffffffu, s.start, d),
            __shfl_up_sync(0xffffffffu, s.kstart, d),
            __shfl_up_sync(0xffffffffu, s.dense, d),
            __shfl_up_sync(0xffffffffu, s.reset, d)};
  }
  __device__ State element(long long i) const {
    const int p = (i == 0) | (pb[i] != 0);
    const int k = p | (kb[i] != 0);
    return {p ? i : -1, k ? i : -1, k, p};
  }
  static constexpr int kOutputs = 3;
  __device__ long long* output(int k) const {
    return k == 0 ? rn : k == 1 ? rk : dr;
  }
  __device__ long long row(long long i) const { return i; }
  __device__ void outputs(long long i, const State& s, long long* w) const {
    w[0] = i - s.start + 1;
    w[1] = s.kstart - s.start + 1;
    w[2] = s.dense;
  }
};

// ----------------------------------------------------------- running --

enum RunKind { kSum = 0, kMean = 1, kCount = 2, kMin = 3, kMax = 4 };

struct RunState {
  double value;
  long long count;
  int reset;
};

template <int K>
struct RunOp {
  using State = RunState;
  const double* v;
  const uint8_t* valid;
  const uint8_t* pb;
  long long n;
  double* out;
  long long* cnt;

  __device__ static double fill() {
    return K == kMin ? __longlong_as_double(0x7FF0000000000000LL)
         : K == kMax ? __longlong_as_double((long long)0xFFF0000000000000ULL)
                     : 0.0;
  }
  __device__ static double fold(double a, double b) {
    if (K == kMin) return fmin(a, b);
    if (K == kMax) return fmax(a, b);
    return a + b;
  }
  __device__ static State identity() { return {fill(), 0, 0}; }
  __device__ static State combine(const State& a, const State& b) {
    if (b.reset) return {b.value, b.count, 1};
    return {fold(a.value, b.value), a.count + b.count, a.reset};
  }
  __device__ static State shfl_up(const State& s, int d) {
    return {__shfl_up_sync(0xffffffffu, s.value, d),
            __shfl_up_sync(0xffffffffu, s.count, d),
            __shfl_up_sync(0xffffffffu, s.reset, d)};
  }
  __device__ State element(long long i) const {
    const int ok = valid[i] != 0;
    return {ok ? v[i] : fill(), ok, (i == 0) | (pb[i] != 0)};
  }
  static constexpr int kOutputs = 2;
  __device__ long long* output(int k) const {
    return k == 0 ? reinterpret_cast<long long*>(out) : cnt;
  }
  __device__ long long row(long long i) const { return i; }
  __device__ void outputs(long long i, const State& s, long long* w) const {
    double r = s.value;
    if (K == kMean) r = s.value / (double)(s.count > 1 ? s.count : 1);
    if (K == kCount) r = (double)s.count;
    w[0] = __double_as_longlong(r);
    w[1] = s.count;
  }
};

// ------------------------------------------------------------- peers --

struct PeerState {
  long long next;
};

struct PeerOp {
  using State = PeerState;
  const double* vals;
  const long long* counts;
  const uint8_t* kb;
  long long n;
  double* out_v;
  long long* out_c;

  __device__ static State identity() { return {0x7FFFFFFFFFFFFFFFLL}; }
  __device__ static State combine(const State& a, const State& b) {
    return {a.next < b.next ? a.next : b.next};
  }
  __device__ static State shfl_up(const State& s, int d) {
    return {__shfl_up_sync(0xffffffffu, s.next, d)};
  }
  // logical position p is row n - 1 - p: the scan runs backward
  __device__ State element(long long p) const {
    const long long r = n - 1 - p;
    return {(r + 1 < n && kb[r + 1] != 0) ? r + 1 : n};
  }
  static constexpr int kOutputs = 2;
  __device__ long long* output(int k) const {
    return k == 0 ? reinterpret_cast<long long*>(out_v) : out_c;
  }
  __device__ long long row(long long p) const { return n - 1 - p; }
  __device__ void outputs(long long p, const State& s, long long* w) const {
    const long long last = s.next - 1;
    w[0] = __double_as_longlong(vals[last]);
    w[1] = counts[last];
  }
};

// ------------------------------------------------------- block scans --

template <class Op>
__device__ __forceinline__ typename Op::State warp_inclusive(
    typename Op::State v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    typename Op::State t = Op::shfl_up(v, d);
    if (lane >= d) v = Op::combine(t, v);
  }
  return v;
}

// The exclusive prefix of each thread's `v` over the block (the identity
// for thread 0); `total` gets the fold of every thread's.
template <class Op>
__device__ typename Op::State block_exclusive(typename Op::State v,
                                              typename Op::State& total) {
  using S = typename Op::State;
  __shared__ S warp_total[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  S inc = warp_inclusive<Op>(v);
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    S w = lane < kWarps ? warp_total[lane] : Op::identity();
    w = warp_inclusive<Op>(w);
    if (lane < kWarps) warp_total[lane] = w;
  }
  __syncthreads();
  S before = Op::shfl_up(inc, 1);
  if (lane == 0) before = Op::identity();
  S pre = warp == 0 ? Op::identity() : warp_total[warp - 1];
  total = warp_total[kWarps - 1];
  __syncthreads();
  return Op::combine(pre, before);
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_reduce(Op op, typename Op::State* tile_total) {
  using S = typename Op::State;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  S acc = Op::identity();
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (base + j < op.n) acc = Op::combine(acc, op.element(base + j));
  S total;
  block_exclusive<Op>(acc, total);
  if (threadIdx.x == 0) tile_total[blockIdx.x] = total;
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_carry(typename Op::State* tile_total, long long tiles) {
  using S = typename Op::State;
  const long long per = (tiles + kThreads - 1) / kThreads;
  const long long lo = (long long)threadIdx.x * per;
  const long long hi = lo + per < tiles ? lo + per : tiles;
  S acc = Op::identity();
  for (long long t = lo; t < hi; ++t) acc = Op::combine(acc, tile_total[t]);
  S total;
  S pre = block_exclusive<Op>(acc, total);
  for (long long t = lo; t < hi; ++t) {
    const S x = tile_total[t];
    tile_total[t] = pre;
    pre = Op::combine(pre, x);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_apply(Op op, const typename Op::State* carry) {
  using S = typename Op::State;
  // a tile's words of one output, padded one word in 8 so that the
  // threads' 8-word rows fall in different banks
  __shared__ long long buf[kTile + kTile / 8];
  const long long tile = (long long)blockIdx.x * kTile;
  const int first = threadIdx.x * kItems;
  const long long base = tile + first;
  S acc = Op::identity();
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (base + j < op.n) acc = Op::combine(acc, op.element(base + j));
  S total;
  S run = Op::combine(carry[blockIdx.x], block_exclusive<Op>(acc, total));
  long long words[kItems][Op::kOutputs];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + j < op.n) {
      run = Op::combine(run, op.element(base + j));
      op.outputs(base + j, run, words[j]);
    }
  }
  // each output through shared memory, so that a warp's stores are 256
  // consecutive bytes
  const long long count = op.n - tile < kTile ? op.n - tile : kTile;
#pragma unroll
  for (int k = 0; k < Op::kOutputs; ++k) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int l = first + j;
      if (l < count) buf[l + l / 8] = words[j][k];
    }
    __syncthreads();
    long long* out = op.output(k);
    for (int l = threadIdx.x; l < count; l += kThreads)
      out[op.row(tile + l)] = buf[l + l / 8];
    __syncthreads();
  }
}

template <class Op>
int run_scan(const Op& op, void* scratch, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (op.n < 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (op.n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (op.n + kTile - 1) / kTile;
  auto* state = static_cast<typename Op::State*>(scratch);
  scan_reduce<Op><<<(unsigned)tiles, kThreads, 0, s>>>(op, state);
  scan_carry<Op><<<1, kThreads, 0, s>>>(state, tiles);
  scan_apply<Op><<<(unsigned)tiles, kThreads, 0, s>>>(op, state);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch bytes the launchers need for n rows: one state per tile.
extern "C" long long window_scan_scratch_bytes(long long n) {
  const long long tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  return tiles * kStateBytes;
}

extern "C" int window_ranks(const void* pb, const void* kb, long long n,
                            void* rn, void* rk, void* dr, void* scratch,
                            int device, void* stream) {
  if (n > 0 && (pb == nullptr || kb == nullptr || rn == nullptr ||
                rk == nullptr || dr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RankOp op{static_cast<const uint8_t*>(pb), static_cast<const uint8_t*>(kb),
            n, static_cast<long long*>(rn), static_cast<long long*>(rk),
            static_cast<long long*>(dr)};
  return run_scan(op, scratch, device, stream);
}

extern "C" int window_running(const void* v, const void* valid,
                              const void* pb, long long n, int kind,
                              void* out, void* count, void* scratch,
                              int device, void* stream) {
  if (n > 0 && (v == nullptr || valid == nullptr || pb == nullptr ||
                out == nullptr || count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* vv = static_cast<const double*>(v);
  const auto* ok = static_cast<const uint8_t*>(valid);
  const auto* p = static_cast<const uint8_t*>(pb);
  auto* o = static_cast<double*>(out);
  auto* c = static_cast<long long*>(count);
  switch (kind) {
    case kSum: return run_scan(RunOp<kSum>{vv, ok, p, n, o, c}, scratch,
                               device, stream);
    case kMean: return run_scan(RunOp<kMean>{vv, ok, p, n, o, c}, scratch,
                                device, stream);
    case kCount: return run_scan(RunOp<kCount>{vv, ok, p, n, o, c}, scratch,
                                 device, stream);
    case kMin: return run_scan(RunOp<kMin>{vv, ok, p, n, o, c}, scratch,
                               device, stream);
    case kMax: return run_scan(RunOp<kMax>{vv, ok, p, n, o, c}, scratch,
                               device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int window_peer_last(const void* vals, const void* counts,
                                const void* kb, long long n, void* out_v,
                                void* out_c, void* scratch, int device,
                                void* stream) {
  if (n > 0 && (vals == nullptr || counts == nullptr || kb == nullptr ||
                out_v == nullptr || out_c == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PeerOp op{static_cast<const double*>(vals),
            static_cast<const long long*>(counts),
            static_cast<const uint8_t*>(kb), n,
            static_cast<double*>(out_v), static_cast<long long*>(out_c)};
  return run_scan(op, scratch, device, stream);
}

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
// Each launcher is one associative scan over the rows with a state per
// row. A segmented scan is an ordinary scan of (value, reset flag)
// states: the combine keeps the right operand alone where it starts a
// partition.
//   ranks:   (start, kstart, dense, reset): start and kstart are the last
//            pb and kb positions so far (a max scan), dense the number of
//            kb rows since the last pb (a segmented sum);
//   running: (value, count, reset): a segmented sum, min or max and the
//            segmented count of valid rows;
//   peers:   the scan runs backward over the rows: the smallest kb
//            position after the row (a min scan, taken exclusive of the
//            row), its run ending just before it.
//
// Design: one launch per call, after a memset of the tile flags: a block
// per tile of 2048 rows (256 threads, 8 consecutive rows each),
// blocks in scan order (tiles reversed for the peers):
//   1. Inputs into shared memory: one TMA bulk copy per input
//      (`cp.async.bulk` onto an mbarrier) where the tile is whole and the
//      input's address 16-byte aligned; else (the last, partial tile, or
//      a view at an unaligned offset) 16-, 8- or 1-byte loads by every
//      thread. Each thread takes its rows from shared memory: flags as
//      one 8-byte word, 8-byte values as 16-byte vectors in a
//      rotated order, so that a quarter warp's 8 threads hit 8 bank
//      groups.
//   2. Fold: each thread its rows in order, a warp scan by shuffles, a
//      scan of the 8 warp totals: each thread's exclusive prefix in the
//      tile and the tile's aggregate A(t).
//   3. Publish: P(t) = A(t) where A(t) restarts (a partition, or a peer
//      run, starts in the tile: combine(x, A(t)) is A(t) bit for bit, for
//      any x), flagged INC; else A(t), flagged AGG. On real data nearly
//      every tile restarts, so a look-back stops at the tile before.
//   4. Every row's outputs without the carry, staged (16-byte vectors,
//      rotated as in 1): the rows from the tile's first restart on are
//      final, and leave at once by one TMA bulk store per output
//      (`cp.async.bulk.global.shared::cta`); the rows before it (the
//      head) wait for the carry.
//   5. Carry by decoupled look-back, where the head or P(t) needs it:
//      warp 0 reads its predecessors' flags 32 * kLook at a time back to
//      the nearest tile j flagged INC, waiting on any that has published
//      nothing, then folds FORWARD: carry = ((P(j) ⊕ A(j+1)) ⊕ ...) ⊕
//      A(t-1); P(t) = carry ⊕ A(t), flagged INC. By induction every P(t)
//      is the strict left fold of A(0) .. A(t) whatever j the look-back
//      found, so a float64 running sum is bit-identical from call to call:
//      the sum folds one tile after another; the exact combines (ranks,
//      counts, min, max, peers) fold a window as a tree. No tile in
//      (j, t) restarts: such a tile publishes INC at once.
//      Ordering: one thread writes a state and then its flag by
//      `st.release.gpu`; warp 0's lanes read flags by `ld.acquire.gpu`, a
//      `__syncwarp` orders those reads before every lane's loads of the
//      states, which go past L1 (`ld.cg`): two round trips where the tile
//      before is INC. It cannot hang: blocks are dispatched in index
//      order, so a look-back waits only on tiles taken by blocks already
//      resident or done, and the lowest unfinished tile waits on nothing.
//   6. The head's rows again from the carry, then stored. A partial tile
//      or an unaligned output leaves whole at the end by 8-byte stores.
//   The peers' gather of each run's last row reads the staged tile where
//   the run ends inside it (in a rotated order: mostly a row's own word),
//   global memory where it crosses the tile's end.
//
// Bound: bytes. The function must read 2 B a row and write 24 (ranks),
// read 10 and write 16 (running), read 17 and write 16 (peers). This
// design reads every input once and writes every output once, plus 4 B
// of flag and up to two 32-byte states per tile; a head row's outputs are
// staged twice in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;
constexpr int kItems = kTile / kThreads;  // consecutive rows a thread
constexpr int kVecs = kItems / 2;         // its 16-byte vectors of 8-byte rows
constexpr int kChunks = kThreads;         // kItems-row chunks of a tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kAgg = 1, kInc = 2;    // tile flags; 0: nothing yet
constexpr int kLook = 2;                  // flags a lane reads in a look-back
constexpr long long kStateBytes = 32;     // the largest state
constexpr int kMinBlocks = 4;             // resident a multiprocessor

// ------------------------------------------------ memory primitives --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// `bytes` from global `src` to shared `dst` by every thread, 16 bytes at a
// time where both are aligned, else by elements of `size` bytes (8-byte
// elements are 8-byte aligned in both).
__device__ void copy_in(unsigned char* dst, const unsigned char* src,
                        int bytes, int size) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    done = bytes & ~15;
    for (int i = threadIdx.x; i < done / 16; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] =
          __ldg(reinterpret_cast<const uint4*>(src) + i);
  } else if (size == 8) {
    done = bytes;
    for (int i = threadIdx.x; i < bytes / 8; i += kThreads)
      reinterpret_cast<unsigned long long*>(dst)[i] =
          __ldg(reinterpret_cast<const unsigned long long*>(src) + i);
  }
  for (int i = done + threadIdx.x; i < bytes; i += kThreads)
    dst[i] = __ldg(src + i);
}

// ---------------------------------------- a thread's rows in shared --

// x[j] <- x[(j + s) % N], by log2(N) rounds of selects (no dynamic
// register index).
template <int N, class T>
__device__ __forceinline__ void rotate_left(T (&x)[N], int s) {
#pragma unroll
  for (int b = 1; b < N; b <<= 1) {
    const bool on = (s & b) != 0;
    T y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = x[(j + b) % N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = on ? y[j] : x[j];
  }
}

// The rotation of a chunk's vectors: 8 consecutive chunks (a quarter
// warp's 16-byte accesses) start at 8 different 16-byte bank groups.
__device__ __forceinline__ int rotation(int chunk) {
  return (chunk / (8 / kVecs)) & (kVecs - 1);
}

// The rotation of a chunk's rows for 8-byte accesses: the 16 threads of
// a half warp's 8-byte accesses hit 16 different bank pairs.
__device__ __forceinline__ int word_rotation(int chunk) {
  return (chunk / (16 / kItems)) & (kItems - 1);
}

// Chunk `chunk`'s kItems 8-byte words, w[m] the word of row m in it.
__device__ __forceinline__ void read_words(const unsigned char* buf,
                                           int chunk,
                                           long long (&w)[kItems]) {
  const int s = rotation(chunk);
  const longlong2* src = reinterpret_cast<const longlong2*>(buf) +
                         chunk * kVecs;
  longlong2 v[kVecs];
#pragma unroll
  for (int q = 0; q < kVecs; ++q) v[q] = src[(q + s) & (kVecs - 1)];
  rotate_left(v, (kVecs - s) & (kVecs - 1));
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    w[2 * q] = v[q].x;
    w[2 * q + 1] = v[q].y;
  }
}

__device__ __forceinline__ void write_words(unsigned char* buf, int chunk,
                                            const long long (&w)[kItems]) {
  const int s = rotation(chunk);
  longlong2* dst = reinterpret_cast<longlong2*>(buf) + chunk * kVecs;
  longlong2 v[kVecs];
#pragma unroll
  for (int q = 0; q < kVecs; ++q) v[q] = make_longlong2(w[2 * q], w[2 * q + 1]);
  rotate_left(v, s);
#pragma unroll
  for (int q = 0; q < kVecs; ++q) dst[(q + s) & (kVecs - 1)] = v[q];
}

// A chunk's kItems (8) flag bytes, read as one word.
struct Bytes {
  unsigned long long w;
  __device__ __forceinline__ bool operator[](int m) const {
    return ((w >> (8 * m)) & 0xffu) != 0;
  }
};

__device__ __forceinline__ Bytes read_bytes(const unsigned char* buf,
                                            int chunk) {
  return {reinterpret_cast<const unsigned long long*>(buf)[chunk]};
}

// Where the tile lies: rows r0 .. r0 + c - 1 at shared offsets shift ..
// shift + c - 1 (a partial tile scanned backward sits at the buffer's end,
// so that its chunks stay aligned).
struct Tile {
  long long r0;
  int c, shift;
  __device__ bool holds(int o) const { return o >= shift && o - shift < c; }
  __device__ long long row(int o) const { return r0 + o - shift; }
};

// ------------------------------------------------------------- ranks --

struct RankState {
  long long start, kstart, dense;
  int reset;
};

struct RankOp {
  using State = RankState;
  static constexpr bool kReverse = false, kExact = true;
  static constexpr bool kGather = false;
  static constexpr int kIns = 2, kOuts = 3;
  // shared: pb, kb (1 B a row), then each output's staging (8 B a row)
  __host__ __device__ static constexpr int in_size(int) { return 1; }
  __host__ __device__ static constexpr int in_at(int k) { return k * kTile; }
  __host__ __device__ static constexpr int stage_at(int k) {
    return (2 + 8 * k) * kTile;
  }
  static constexpr int kSmem = 26 * kTile;
  const uint8_t* pb;
  const uint8_t* kb;
  long long n;
  long long* rn;
  long long* rk;
  long long* dr;

  __device__ const void* in(int k) const { return k == 0 ? pb : kb; }
  __device__ long long* out(int k) const {
    return k == 0 ? rn : k == 1 ? rk : dr;
  }
  __device__ static State identity() { return {-1, -1, 0, 0}; }
  // combine(a, s) == s, bit for bit, for every earlier a
  __device__ static bool restarts(const State& s) { return s.reset; }
  __device__ static State combine(const State& a, const State& b) {
    return {a.start > b.start ? a.start : b.start,
            a.kstart > b.kstart ? a.kstart : b.kstart,
            b.reset ? b.dense : a.dense + b.dense, a.reset | b.reset};
  }
  __device__ static State shfl(const State& s, int lane) {
    return {__shfl_sync(kAll, s.start, lane),
            __shfl_sync(kAll, s.kstart, lane),
            __shfl_sync(kAll, s.dense, lane),
            __shfl_sync(kAll, s.reset, lane)};
  }
  __device__ static State shfl_up(const State& s, int d) {
    return {__shfl_up_sync(kAll, s.start, d),
            __shfl_up_sync(kAll, s.kstart, d),
            __shfl_up_sync(kAll, s.dense, d),
            __shfl_up_sync(kAll, s.reset, d)};
  }
  __device__ static State shfl_down(const State& s, int d) {
    return {__shfl_down_sync(kAll, s.start, d),
            __shfl_down_sync(kAll, s.kstart, d),
            __shfl_down_sync(kAll, s.dense, d),
            __shfl_down_sync(kAll, s.reset, d)};
  }
  __device__ static State load(const State* p) {
    return {__ldcg(&p->start), __ldcg(&p->kstart), __ldcg(&p->dense),
            __ldcg(&p->reset)};
  }
  __device__ static void store(State* p, const State& s) {
    __stcg(&p->start, s.start);
    __stcg(&p->kstart, s.kstart);
    __stcg(&p->dense, s.dense);
    __stcg(&p->reset, s.reset);
  }

  struct Items {
    Bytes pb, kb;
  };
  __device__ void take(const unsigned char* smem, int chunk,
                       Items& it) const {
    it.pb = read_bytes(smem + in_at(0), chunk);
    it.kb = read_bytes(smem + in_at(1), chunk);
  }
  __device__ State element(const Items& it, int m, long long row) const {
    const int p = (row == 0) | it.pb[m];
    const int k = p | it.kb[m];
    return {p ? row : -1, k ? row : -1, k, p};
  }
  __device__ long long output(int k, const State& s, long long row) const {
    return k == 0 ? row - s.start + 1
         : k == 1 ? s.kstart - s.start + 1 : s.dense;
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
  static constexpr bool kReverse = false;
  static constexpr bool kExact = K != kSum && K != kMean;
  static constexpr bool kGather = false;
  static constexpr int kIns = 3, kOuts = 2;
  // shared: v (8 B a row), valid, pb (1 B); out stages over v, count
  // after pb
  __host__ __device__ static constexpr int in_size(int k) {
    return k == 0 ? 8 : 1;
  }
  __host__ __device__ static constexpr int in_at(int k) {
    return k == 0 ? 0 : (7 + k) * kTile;
  }
  __host__ __device__ static constexpr int stage_at(int k) {
    return k == 0 ? 0 : 10 * kTile;
  }
  static constexpr int kSmem = 18 * kTile;
  const double* v;
  const uint8_t* valid;
  const uint8_t* pb;
  long long n;
  double* out_v;
  long long* cnt;

  __device__ const void* in(int k) const {
    return k == 0 ? static_cast<const void*>(v)
         : k == 1 ? static_cast<const void*>(valid) : pb;
  }
  __device__ long long* out(int k) const {
    return k == 0 ? reinterpret_cast<long long*>(out_v) : cnt;
  }
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
  __device__ static bool restarts(const State& s) { return s.reset; }
  __device__ static State combine(const State& a, const State& b) {
    if (b.reset) return {b.value, b.count, 1};
    return {fold(a.value, b.value), a.count + b.count, a.reset};
  }
  __device__ static State shfl(const State& s, int lane) {
    return {__shfl_sync(kAll, s.value, lane),
            __shfl_sync(kAll, s.count, lane),
            __shfl_sync(kAll, s.reset, lane)};
  }
  __device__ static State shfl_up(const State& s, int d) {
    return {__shfl_up_sync(kAll, s.value, d),
            __shfl_up_sync(kAll, s.count, d),
            __shfl_up_sync(kAll, s.reset, d)};
  }
  __device__ static State shfl_down(const State& s, int d) {
    return {__shfl_down_sync(kAll, s.value, d),
            __shfl_down_sync(kAll, s.count, d),
            __shfl_down_sync(kAll, s.reset, d)};
  }
  __device__ static State load(const State* p) {
    return {__ldcg(&p->value), __ldcg(&p->count), __ldcg(&p->reset)};
  }
  __device__ static void store(State* p, const State& s) {
    __stcg(&p->value, s.value);
    __stcg(&p->count, s.count);
    __stcg(&p->reset, s.reset);
  }

  struct Items {
    long long v[kItems];
    Bytes valid, pb;
  };
  __device__ void take(const unsigned char* smem, int chunk,
                       Items& it) const {
    read_words(smem + in_at(0), chunk, it.v);
    it.valid = read_bytes(smem + in_at(1), chunk);
    it.pb = read_bytes(smem + in_at(2), chunk);
  }
  __device__ State element(const Items& it, int m, long long row) const {
    const bool ok = it.valid[m];
    return {ok ? __longlong_as_double(it.v[m]) : fill(), ok,
            (row == 0) | it.pb[m]};
  }
  __device__ long long output(int k, const State& s, long long) const {
    if (k == 1) return s.count;
    double r = s.value;
    if (K == kMean) r = s.value / (double)(s.count > 1 ? s.count : 1);
    if (K == kCount) r = (double)s.count;
    return __double_as_longlong(r);
  }
};

// ------------------------------------------------------------- peers --

struct PeerState {
  long long next;
};

struct PeerOp {
  using State = PeerState;
  // backward; a row's output takes the state before the row's own
  // element: the smallest kb position after it
  static constexpr bool kReverse = true, kExact = true;
  // outputs gather from the staged vals and counts, and stage over them
  static constexpr bool kGather = true;
  static constexpr int kIns = 3, kOuts = 2;
  __host__ __device__ static constexpr int in_size(int k) {
    return k < 2 ? 8 : 1;
  }
  __host__ __device__ static constexpr int in_at(int k) {
    return 8 * k * kTile;
  }
  __host__ __device__ static constexpr int stage_at(int k) {
    return in_at(k);
  }
  static constexpr int kSmem = 17 * kTile;
  const double* vals;
  const long long* counts;
  const uint8_t* kb;
  long long n;
  double* out_v;
  long long* out_c;

  __device__ const void* in(int k) const {
    return k == 0 ? static_cast<const void*>(vals)
         : k == 1 ? static_cast<const void*>(counts) : kb;
  }
  __device__ long long* out(int k) const {
    return k == 0 ? reinterpret_cast<long long*>(out_v) : out_c;
  }
  __device__ static State identity() { return {0x7FFFFFFFFFFFFFFFLL}; }
  // a kb row in the tile: every earlier state's (a later tile's) is larger
  __device__ static bool restarts(const State& s) {
    return s.next != 0x7FFFFFFFFFFFFFFFLL;
  }
  __device__ static State combine(const State& a, const State& b) {
    return {a.next < b.next ? a.next : b.next};
  }
  __device__ static State shfl(const State& s, int lane) {
    return {__shfl_sync(kAll, s.next, lane)};
  }
  __device__ static State shfl_up(const State& s, int d) {
    return {__shfl_up_sync(kAll, s.next, d)};
  }
  __device__ static State shfl_down(const State& s, int d) {
    return {__shfl_down_sync(kAll, s.next, d)};
  }
  __device__ static State load(const State* p) { return {__ldcg(&p->next)}; }
  __device__ static void store(State* p, const State& s) {
    __stcg(&p->next, s.next);
  }

  struct Items {
    Bytes kb;
  };
  __device__ void take(const unsigned char* smem, int chunk,
                       Items& it) const {
    it.kb = read_bytes(smem + in_at(2), chunk);
  }
  __device__ State element(const Items& it, int m, long long row) const {
    return {it.kb[m] ? row : 0x7FFFFFFFFFFFFFFFLL};
  }
  // the row whose value and count a row takes: its run's last
  __device__ long long target(const State& s) const {
    return (s.next < n ? s.next : n) - 1;
  }
  // output k of row `last`: from the staged tile where the run ends
  // inside it, else from global memory
  __device__ long long fetch(int k, long long last,
                             const unsigned char* smem,
                             const Tile& tile) const {
    if (last < tile.r0 + tile.c)
      return reinterpret_cast<const long long*>(smem + in_at(k))
          [last - tile.r0 + tile.shift];
    return fetch_global(k, last);
  }
  __device__ long long fetch_global(int k, long long last) const {
    return k == 0 ? __double_as_longlong(__ldg(vals + last))
                  : __ldg(counts + last);
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

// The fold of the lanes' states in lane order (lane 0 first), in lane 0
// (an exact combine: a tree).
template <class Op>
__device__ __forceinline__ typename Op::State warp_fold(
    typename Op::State x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const typename Op::State y = Op::shfl_down(x, d);
    if (lane + d < 32) x = Op::combine(x, y);
  }
  return x;
}

// Warp 0 of logical tile t > 0: the nearest tile j < t whose flag is INC,
// every tile between having published AGG. Each lane reads the flags of
// kLook consecutive tiles, a window 32 * kLook tiles, by acquire loads,
// waiting on tiles that have published nothing.
__device__ long long find_prefix(const uint32_t* flags, long long t) {
  const int lane = threadIdx.x & 31;
  for (long long top = t - 1;; top -= 32 * kLook) {
    uint32_t f[kLook];
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      const long long idx = top - kLook * lane - q;
      f[q] = idx >= 0 ? ld_acquire(flags + idx) : kInc;  // before tile 0
    }
    for (;;) {
      bool wait = false;
#pragma unroll
      for (int q = 0; q < kLook; ++q) wait |= f[q] == 0;
      if (!__any_sync(kAll, wait)) break;
      __nanosleep(32);
#pragma unroll
      for (int q = 0; q < kLook; ++q)
        if (f[q] == 0) f[q] = ld_acquire(flags + top - kLook * lane - q);
    }
    int near = kLook;
#pragma unroll
    for (int q = kLook - 1; q >= 0; --q)
      if (f[q] == kInc) near = q;
    const unsigned got = __ballot_sync(kAll, near < kLook);
    if (got) {
      const int l = __ffs(got) - 1;
      return top - kLook * l - __shfl_sync(kAll, near, l);
    }
  }
}

// Warp 0 of logical tile t > 0: the fold of A(0) .. A(t-1), from the
// nearest published prefix P(j) forward (module comment, 5): an exact
// combine as a tree over the lanes' consecutive runs of tiles; the float
// sum strictly left to right from P(j).
template <class Op>
__device__ typename Op::State look_back(const uint32_t* flags,
                                        const typename Op::State* agg,
                                        const typename Op::State* inc,
                                        long long t) {
  using S = typename Op::State;
  const int lane = threadIdx.x & 31;
  const long long j = find_prefix(flags, t);
  __syncwarp();  // every lane's acquires before any lane's state loads
  S acc = Op::load(inc + j);
  if constexpr (Op::kExact) {
    const long long per = (t - 1 - j + 31) / 32;  // tiles a lane
    const long long lo = j + 1 + lane * per;
    const long long hi = lo + per < t ? lo + per : t;
    S mine = Op::identity();
    for (long long i = lo; i < hi; i += 4) {
      S x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = i + q < hi ? Op::load(agg + i + q) : Op::identity();
#pragma unroll
      for (int q = 0; q < 4; ++q) mine = Op::combine(mine, x[q]);
    }
    acc = Op::combine(acc, Op::shfl(warp_fold<Op>(mine), 0));
  } else {
    __shared__ S run[32 * kLook];
    for (long long base = j + 1; base < t; base += 32 * kLook) {
      const int cnt = static_cast<int>(
          t - base < 32 * kLook ? t - base : 32 * kLook);
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        const int i = q * 32 + lane;
        if (i < cnt) run[i] = Op::load(agg + base + i);
      }
      __syncwarp();
      if (lane == 0)
        for (int i = 0; i < cnt; ++i) acc = Op::combine(acc, run[i]);
      __syncwarp();
    }
    acc = Op::shfl(acc, 0);
  }
  return acc;
}

// ------------------------------------------------------------ kernel --

template <class Op>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_scan_pass(Op op, uint32_t* flags, typename Op::State* agg,
                 typename Op::State* inc, long long tiles) {
  using S = typename Op::State;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ S carry_s;
  __shared__ int head_s;
  const long long t = blockIdx.x;  // the tile's place in scan order
  const long long phys = Op::kReverse ? tiles - 1 - t : t;
  Tile tile;
  tile.r0 = phys * kTile;
  tile.c = static_cast<int>(op.n - tile.r0 < kTile ? op.n - tile.r0 : kTile);
  tile.shift = Op::kReverse ? kTile - tile.c : 0;

  // 1. the tile's inputs into shared memory
  bool tma[Op::kIns];
  uint32_t tx = 0;
#pragma unroll
  for (int k = 0; k < Op::kIns; ++k) {
    const auto* src = static_cast<const unsigned char*>(op.in(k)) +
                      tile.r0 * Op::in_size(k);
    tma[k] = tile.c == kTile && aligned16(src);
    if (tma[k]) tx += kTile * Op::in_size(k);
  }
  if (threadIdx.x == 0 && tx) {
    bar_init(&bar);
    bar_expect(&bar, tx);
#pragma unroll
    for (int k = 0; k < Op::kIns; ++k)
      if (tma[k])
        bulk_load(smem + Op::in_at(k),
                  static_cast<const unsigned char*>(op.in(k)) +
                      tile.r0 * Op::in_size(k),
                  kTile * Op::in_size(k), &bar);
  }
#pragma unroll
  for (int k = 0; k < Op::kIns; ++k)
    if (!tma[k])
      copy_in(smem + Op::in_at(k) + tile.shift * Op::in_size(k),
              static_cast<const unsigned char*>(op.in(k)) +
                  tile.r0 * Op::in_size(k),
              tile.c * Op::in_size(k), Op::in_size(k));
  __syncthreads();  // the barrier's init, the threads' copies
  if (tx) bar_wait(&bar);

  // 2. this thread's rows, their fold, the block's scan
  const int chunk = Op::kReverse ? kChunks - 1 - threadIdx.x : threadIdx.x;
  typename Op::Items it;
  op.take(smem, chunk, it);
  S acc = Op::identity();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int m = Op::kReverse ? kItems - 1 - j : j;
    const int o = chunk * kItems + m;
    if (tile.holds(o)) acc = Op::combine(acc, op.element(it, m, tile.row(o)));
  }
  if (threadIdx.x == 0) {
    carry_s = Op::identity();
    head_s = kTile;
  }
  S total;
  const S pre = block_exclusive<Op>(acc, total);

  // 3. publish: a tile whose aggregate restarts (a partition or a peer run
  // starts in it) is its own inclusive prefix, else its aggregate
  const bool own = t == 0 || Op::restarts(total);
  if (threadIdx.x == 0) {
    Op::store(own ? inc + t : agg + t, total);
    st_release(flags + t, own ? kInc : kAgg);
  }

  // 4. every row's outputs without the carry, staged; a row whose state
  // restarts in the tile is final, and the rows before the first such
  // (the head) wait for the carry
  int first = kTile;  // this thread's first final row, in scan order
  if constexpr (Op::kGather) {
    // each row's source row (from the state before its own element),
    // then each output gathered from it in a rotated order (mostly the
    // row's own word), all read before any is staged over the buffer
    // they come from
    long long src[kItems];
    S run = pre;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int m = Op::kReverse ? kItems - 1 - j : j;
      const int o = chunk * kItems + m;
      src[m] = -1;
      if (tile.holds(o)) {
        if (Op::restarts(run) && first == kTile)
          first = threadIdx.x * kItems + j;
        src[m] = op.target(run);
        run = Op::combine(run, op.element(it, m, tile.row(o)));
      }
    }
    const int s = word_rotation(chunk);
    rotate_left(src, s);
#pragma unroll
    for (int k = 0; k < Op::kOuts; ++k) {
      long long w[kItems];
#pragma unroll
      for (int q = 0; q < kItems; ++q)
        w[q] = src[q] < 0 ? 0 : op.fetch(k, src[q], smem, tile);
      rotate_left(w, (kItems - s) & (kItems - 1));
      __syncthreads();
      write_words(smem + Op::stage_at(k), chunk, w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < Op::kOuts; ++k) {
      long long w[kItems];
      S run = pre;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int m = Op::kReverse ? kItems - 1 - j : j;
        const int o = chunk * kItems + m;
        w[m] = 0;
        if (tile.holds(o)) {
          const long long row = tile.row(o);
          run = Op::combine(run, op.element(it, m, row));
          if (k == 0 && Op::restarts(run) && first == kTile)
            first = threadIdx.x * kItems + j;
          w[m] = op.output(k, run, row);
        }
      }
      write_words(smem + Op::stage_at(k), chunk, w);
    }
  }
  if (first < kTile) atomicMin(&head_s, first);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int head = head_s < tile.c ? head_s : tile.c;  // rows, scan order
  bool whole = tile.c == kTile;
#pragma unroll
  for (int k = 0; k < Op::kOuts; ++k)
    whole = whole && aligned16(op.out(k) + tile.r0);
  // a whole tile's staged rows [lo, lo + cnt) to its outputs by bulk
  // copies (lo and cnt even: 16-byte aligned)
  auto store = [&](int lo, int cnt) {
    if (cnt <= 0 || threadIdx.x != 0) return;
#pragma unroll
    for (int k = 0; k < Op::kOuts; ++k)
      bulk_store(op.out(k) + tile.r0 + lo, smem + Op::stage_at(k) + 8 * lo,
                 cnt * 8);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  };
  // the head's rows rounded out to whole 16-byte words (every row where
  // the tile is not whole), in scan order; its shared offsets start at
  // held_lo, the rest's at free_lo
  const int held = whole ? (Op::kReverse ? kTile - ((kTile - head) & ~1)
                                         : (head + 1) & ~1)
                         : tile.c;
  const int held_lo = Op::kReverse ? kTile - held : 0;
  const int free_lo = Op::kReverse ? 0 : held;
  if (whole) store(free_lo, kTile - held);

  // 5. the carry by decoupled look-back, where the head or the tile's
  // inclusive prefix needs it
  if (threadIdx.x < 32 && t > 0 && (head > 0 || !own)) {
    const S carry = look_back<Op>(flags, agg, inc, t);
    if (threadIdx.x == 0) {
      carry_s = carry;
      if (!own) {
        Op::store(inc + t, Op::combine(carry, total));
        st_release(flags + t, kInc);
      }
    }
  }
  __syncthreads();

  // 6. the held rows again from the carry, then stored
  if (threadIdx.x * kItems < held) {
    S run = Op::combine(carry_s, pre);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int m = Op::kReverse ? kItems - 1 - j : j;
      const int o = chunk * kItems + m;
      if (threadIdx.x * kItems + j < held && tile.holds(o)) {
        const long long row = tile.row(o);
        long long w[Op::kOuts];
        if constexpr (Op::kGather) {
          const long long last = op.target(run);
#pragma unroll
          for (int k = 0; k < Op::kOuts; ++k) w[k] = op.fetch_global(k, last);
        }
        run = Op::combine(run, op.element(it, m, row));
        if constexpr (!Op::kGather) {
#pragma unroll
          for (int k = 0; k < Op::kOuts; ++k) w[k] = op.output(k, run, row);
        }
#pragma unroll
        for (int k = 0; k < Op::kOuts; ++k)
          reinterpret_cast<long long*>(smem + Op::stage_at(k))[o] = w[k];
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (whole) {
    store(held_lo, held);
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  } else {
#pragma unroll
    for (int k = 0; k < Op::kOuts; ++k) {
      const long long* from =
          reinterpret_cast<const long long*>(smem + Op::stage_at(k)) +
          tile.shift;
      long long* dst = op.out(k) + tile.r0;
      for (int i = threadIdx.x; i < tile.c; i += kThreads) dst[i] = from[i];
    }
  }
}

// Flag words of `tiles` tiles, padded to 16 bytes.
long long flag_bytes(long long tiles) { return (tiles * 4 + 15) & ~15LL; }

template <class Op>
int run_scan(const Op& op, void* scratch, int device, void* stream) {
  using S = typename Op::State;
  static_assert(sizeof(S) <= kStateBytes, "a state fits its slot");
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (op.n < 0 || scratch == nullptr ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (op.n == 0) return 0;
  const long long tiles = (op.n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* flags = static_cast<uint32_t*>(scratch);
  auto* agg = reinterpret_cast<S*>(static_cast<char*>(scratch) +
                                   flag_bytes(tiles));
  auto* inc = agg + tiles;
  if ((err = cudaMemsetAsync(flags, 0, tiles * 4, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaFuncSetAttribute(
           window_scan_pass<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
           Op::kSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           window_scan_pass<Op>,
           cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return static_cast<int>(err);
  window_scan_pass<Op><<<(unsigned)tiles, kThreads, Op::kSmem, s>>>(
      op, flags, agg, inc, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch bytes the launchers need for n rows: a flag and two states (the
// aggregate, the inclusive prefix) per tile.
extern "C" long long window_scan_scratch_bytes(long long n) {
  const long long tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  return flag_bytes(tiles) + 2 * tiles * kStateBytes;
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

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
// position of each sorted row, both 16-byte aligned. A key's rows form
// one run of equal codes, its target rows first, each side in input
// order. Output:
//   match   i32 [nt]         per target row, the source-local index of the
//                            first (smallest) source row of its run, or -1
//                            (16-byte aligned);
//   words   u32 [ceil(ns/32)] bit s set where source row s shares its run
//                            with a target row;
//   n_multi i32 [1]          the target rows whose run holds more than one
//                            source row.
// Scratch (`merge_join_scratch_bytes`, from the caller's allocator; the
// launch zeroes it): 12 B of status words per 1024-row tile.
//
// Every answer comes from the sorted order alone. Row r starts a block
// when r == 0 or its (code, side) differs from row r - 1's.
//   - A target row i takes e, the first block start after i: match =
//     pos[e] - nt where code[e] == code[i] (e is then its run's first
//     source row), else -1; it counts toward n_multi where code[e + 1] ==
//     code[i] too (a second source row).
//   - A source row k takes b, the last block start at or before k: its
//     bit is set where b > 0 and code[b - 1] == code[k] (a target block
//     precedes its source block in the run).
// So each row needs only the next block start after it or the last one
// at or before it, found in its own 1024-row tile where the tile holds
// one, else carried from the tiles beside it. Two launches, each a
// single pass whose carries go by decoupled look-back over per-tile
// status words (0 until the tile publishes; "empty" while a tile without
// a start waits for its neighbours; then its value):
//   1. `merge_join_ahead`: a warp per tile, tiles taken from the last
//      down, finds the tile's first block start f (128-row segments from
//      the front until one holds a start, each step loading the next
//      segment first) and publishes what a target row before f takes
//      from it: pos[f] - nt where f's run has a target block before it,
//      else -1, and whether a second source row follows. A tile without
//      a start takes the value of the nearest tile above it that has one,
//      reading 32 status words at once. It also zeroes the words and
//      n_multi.
//   2. `merge_join_resolve`: a block per tile, tiles taken from the
//      first up, reads its rows with 16-byte loads (4 a lane) into shared
//      memory, flags the starts, and finds each row's two starts in its
//      own 4 rows, else in its warp's nearest lane below or above holding
//      one (`__ballot_sync`, `__ffs`, `__clz`), else in the block's other
//      warps. It publishes whether its last start opens a matched source
//      block (code[b - 1] == code[b]); a tile whose first rows are source
//      rows of an earlier tile's block takes that flag by look-back, the
//      target rows after the tile's last start the first launch's value
//      for the next tile. It stores match (scattered by input position,
//      16 bytes at once where four target rows are consecutive), sets the
//      source bits with atomicOr (one per word and warp through
//      `__match_any_sync` where neighbouring lanes share a word, else one
//      per row), and adds its n_multi with one atomic.
// A long run costs what other rows cost: its tiles hold no start and take
// the carries. A look-back waits only on tiles taken before its own
// (blocks start in index order, warps of a block together), so it cannot
// hang; it passes only tiles that have not yet published, so its walk is
// bounded by the tiles resident on the card, not by a run.
//
// Bound: bytes. The function must read 8 B per row (code and position)
// and write 4 B per target row and per word. This design reads at least
// an eighth of each tile again in the first launch, all of a tile inside
// a long run; a source bit lands at a random word, one atomic each, where
// the source's input order is random.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // a block of either launch
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // rows a lane: one 16-byte load
constexpr int kSeg = 32 * kRows;         // rows a warp loads at once
constexpr int kTile = kThreads * kRows;  // 1024 rows
constexpr int kSegs = kTile / kSeg;      // 8
constexpr int kHalo = 4;  // shared slots before a tile's rows (row base - 1
                          // in the last), keeping the 16-byte stores aligned
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // no code (codes are below 2^31)
                                         // and no word

// Status words. ahead (the first launch's, u64): the state in the high
// half, the value ((match + 1) << 1 | a second source row) in the low;
// behind (the second's, u32): the state, plus 1 where the block is
// matched.
constexpr uint32_t kEmpty = 1, kValue = 2;
constexpr unsigned long long kAheadEmpty = 1ull << 32;
constexpr unsigned long long kAheadValue = 2ull << 32;

// Four consecutive rows of a lane from row r; rows at or past n read as
// code kNone (no code is) and position 0.
struct Quad {
  uint32_t c[kRows];
  int32_t p[kRows];
};

__device__ __forceinline__ Quad load_quad(const uint32_t* __restrict__ code,
                                          const int32_t* __restrict__ pos,
                                          int64_t r, int64_t n) {
  Quad q;
  if (r + kRows <= n) {
    const uint4 c = __ldg(reinterpret_cast<const uint4*>(code + r));
    const int4 p = __ldg(reinterpret_cast<const int4*>(pos + r));
    q.c[0] = c.x; q.c[1] = c.y; q.c[2] = c.z; q.c[3] = c.w;
    q.p[0] = p.x; q.p[1] = p.y; q.p[2] = p.z; q.p[3] = p.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const bool in = r + j < n;
      q.c[j] = in ? code[r + j] : kNone;
      q.p[j] = in ? pos[r + j] : 0;
    }
  }
  return q;
}

// Bit j set where row r + j starts a block of equal (code, side); pc and
// pp are row r - 1's code and position.
__device__ __forceinline__ unsigned block_starts(const Quad& q, uint32_t pc,
                                                 int32_t pp, int64_t r,
                                                 int64_t n, int64_t nt) {
  unsigned bits = 0;
  bool ps = pp >= nt;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const bool s = q.p[j] >= nt;
    if (r + j < n && (r + j == 0 || q.c[j] != pc || s != ps)) bits |= 1u << j;
    pc = q.c[j];
    ps = s;
  }
  return bits;
}

// Each lane's start bits in a warp's segment of rows q from row r0; pc0
// and pp0 are row r0 - 1's code and position.
__device__ __forceinline__ unsigned segment_starts(const Quad& q,
                                                   uint32_t pc0, int32_t pp0,
                                                   int64_t r0, int64_t n,
                                                   int64_t nt, int lane) {
  uint32_t pc = __shfl_up_sync(kAll, q.c[kRows - 1], 1);
  int32_t pp = __shfl_up_sync(kAll, q.p[kRows - 1], 1);
  if (lane == 0) {
    pc = pc0;
    pp = pp0;
  }
  return block_starts(q, pc, pp, r0 + kRows * lane, n, nt);
}

// What a target row takes from e, the first block start after it, where
// its run continues at e: the value of an ahead word.
__device__ __forceinline__ uint32_t ahead_value(
    const uint32_t* __restrict__ code, const int32_t* __restrict__ pos,
    int64_t e, int64_t n, int64_t nt) {
  const uint32_t c = code[e];
  if (e == 0 || code[e - 1] != c) return 0u;  // match -1
  const uint32_t multi = e + 1 < n && code[e + 1] == c;
  return static_cast<uint32_t>(pos[e] - nt + 1) << 1 | multi;
}

// The value of the nearest tile from `from` up that has one (past the
// last tile: match -1), waiting on tiles that have not published.
// Warp-wide.
__device__ uint32_t look_ahead(const volatile unsigned long long* st,
                               int64_t from, int64_t tiles, int lane) {
  for (int64_t t0 = from;; t0 += 32) {
    const int64_t t = t0 + lane;
    unsigned long long s = t < tiles ? st[t] : kAheadValue;
    while (__any_sync(kAll, (s >> 32) == 0))
      if ((s >> 32) == 0) s = st[t];
    const unsigned got = __ballot_sync(kAll, (s >> 32) == kValue);
    if (got)
      return static_cast<uint32_t>(__shfl_sync(kAll, s, __ffs(got) - 1));
  }
}

// Whether the last block start before tile from + 1 opens a matched
// source block: the flag of the nearest tile from `from` down that has
// one. Warp-wide; tile 0 always has one (row 0 starts a block).
__device__ bool look_back(const volatile uint32_t* st, int64_t from,
                          int lane) {
  for (int64_t t0 = from;; t0 -= 32) {
    const int64_t t = t0 - lane;
    uint32_t s = t >= 0 ? st[t] : kValue;
    while (__any_sync(kAll, s == 0))
      if (s == 0) s = st[t];
    const unsigned got = __ballot_sync(kAll, s >= kValue);
    if (got) return __shfl_sync(kAll, s, __ffs(got) - 1) == kValue + 1;
  }
}

// ahead[t] for every tile t, warp by warp from the last tile down; the
// words and n_multi zeroed.
__global__ void __launch_bounds__(kThreads)
merge_join_ahead(const uint32_t* __restrict__ code,
                 const int32_t* __restrict__ pos, int64_t nt, int64_t n,
                 int64_t tiles, unsigned long long* ahead,
                 uint32_t* __restrict__ words, int64_t n_words,
                 int32_t* __restrict__ n_multi) {
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       w < n_words; w += static_cast<int64_t>(gridDim.x) * kThreads)
    words[w] = 0u;
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_multi = 0;
  const int lane = threadIdx.x & 31;
  const int64_t taken =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (taken >= tiles) return;  // the whole warp
  const int64_t tile = tiles - 1 - taken;
  const int64_t base = tile * kTile;
  const int segs = static_cast<int>(min(static_cast<int64_t>(kSegs),
                                        (n - base + kSeg - 1) / kSeg));
  uint32_t pc = base > 0 ? code[base - 1] : kNone;
  int32_t pp = base > 0 ? pos[base - 1] : 0;
  int64_t first = -1;
  Quad q = load_quad(code, pos, base + kRows * lane, n);
  for (int s = 0; s < segs; ++s) {
    Quad nq = q;
    if (s + 1 < segs)
      nq = load_quad(code, pos, base + (s + 1) * kSeg + kRows * lane, n);
    const unsigned bits = segment_starts(q, pc, pp, base + s * kSeg, n, nt,
                                         lane);
    const unsigned m = __ballot_sync(kAll, bits != 0);
    if (m != 0) {
      const int l = __ffs(m) - 1;
      first = base + s * kSeg + kRows * l +
              __ffs(__shfl_sync(kAll, bits, l)) - 1;
      break;
    }
    pc = __shfl_sync(kAll, q.c[kRows - 1], 31);
    pp = __shfl_sync(kAll, q.p[kRows - 1], 31);
    q = nq;
  }
  volatile unsigned long long* st = ahead;
  if (first >= 0) {
    if (lane == 0)
      st[tile] = kAheadValue | ahead_value(code, pos, first, n, nt);
    return;
  }
  if (lane == 0) st[tile] = kAheadEmpty;
  const uint32_t v = look_ahead(st, tile + 1, tiles, lane);
  if (lane == 0) st[tile] = kAheadValue | v;
}

// Every row of tile blockIdx.x: its match or its source bit, and its
// share of n_multi. A row's starts come from its lane, its warp, the
// block's other warps, or the carries: behind by look-back, ahead from
// the first launch.
__global__ void __launch_bounds__(kThreads)
merge_join_resolve(const uint32_t* __restrict__ code,
                   const int32_t* __restrict__ pos, int64_t nt, int64_t ns,
                   int64_t tiles,
                   const unsigned long long* __restrict__ ahead,
                   uint32_t* behind, int32_t* __restrict__ match,
                   uint32_t* __restrict__ words,
                   int32_t* __restrict__ n_multi) {
  // rows base - 1 .. base + kTile at [kHalo + row - base]
  __shared__ __align__(16) uint32_t s_code[kHalo + kTile + 1];
  __shared__ __align__(16) int32_t s_pos[kHalo + kTile + 1];
  __shared__ int w_first[kWarps], w_last[kWarps], part[kWarps];
  __shared__ uint32_t s_ahead;  // the next tile's ahead value
  __shared__ bool s_behind;     // the carried matched flag
  const int64_t n = nt + ns;
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = kHalo + kRows * threadIdx.x;
  const int64_t r = base + kRows * threadIdx.x;
  const Quad q = load_quad(code, pos, r, n);
  *reinterpret_cast<uint4*>(&s_code[slot]) =
      make_uint4(q.c[0], q.c[1], q.c[2], q.c[3]);
  *reinterpret_cast<int4*>(&s_pos[slot]) =
      make_int4(q.p[0], q.p[1], q.p[2], q.p[3]);
  if (threadIdx.x < 2) {  // row base - 1 and the row after the tile
    const int64_t h = threadIdx.x == 0 ? base - 1 : base + kTile;
    const int hs = kHalo + static_cast<int>(h - base);
    const bool in = h >= 0 && h < n;
    s_code[hs] = in ? code[h] : kNone;
    s_pos[hs] = in ? pos[h] : 0;
  } else if (threadIdx.x == 2) {
    s_ahead = tile + 1 < tiles ? static_cast<uint32_t>(ahead[tile + 1]) : 0u;
  }
  __syncthreads();

  const unsigned bits = block_starts(q, s_code[slot - 1], s_pos[slot - 1], r,
                                     n, nt);
  const unsigned m = __ballot_sync(kAll, bits != 0);
  const int wbase = kSeg * warp;  // in-tile rows from here on
  // the warp's first and last start, for the other warps
  const int lf = m ? __ffs(m) - 1 : 0, ll = m ? 31 - __clz(m) : 0;
  const unsigned bf = __shfl_sync(kAll, bits, lf);
  const unsigned bl = __shfl_sync(kAll, bits, ll);
  if (lane == 0) {
    w_first[warp] = m ? wbase + kRows * lf + __ffs(bf) - 1 : kTile;
    w_last[warp] = m ? wbase + kRows * ll + 31 - __clz(bl) : -1;
  }
  // the nearest lanes below and above this one that hold a start
  const unsigned below = m & ((1u << lane) - 1u);
  const unsigned above = lane == 31 ? 0u : m & (kAll << (lane + 1));
  const int lb = below ? 31 - __clz(below) : lane;
  const int la = above ? __ffs(above) - 1 : lane;
  const unsigned bb = __shfl_sync(kAll, bits, lb);
  const unsigned ba = __shfl_sync(kAll, bits, la);
  __syncthreads();
  // in-tile: the last start before this lane's rows and the first after,
  // -1 and kTile where they lie in other tiles; the tile's first and last
  int prev = -1, next = kTile, first = kTile, last = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) prev = max(prev, w_last[w]);
    if (w > warp) next = min(next, w_first[w]);
    first = min(first, w_first[w]);
    last = max(last, w_last[w]);
  }
  if (below) prev = wbase + kRows * lb + 31 - __clz(bb);
  if (above) next = wbase + kRows * la + __ffs(ba) - 1;
  if (warp == 0) {  // publish, then take the carry where the tile needs it
    volatile uint32_t* st = behind;
    if (last >= 0 && lane == 0)
      st[tile] = kValue + (s_code[kHalo + last - 1] == s_code[kHalo + last]);
    if (last < 0) {
      if (lane == 0) st[tile] = kEmpty;
      const bool v = look_back(st, tile - 1, lane);
      if (lane == 0) {
        st[tile] = kValue + v;
        s_behind = v;
      }
    } else if (first > 0 && s_pos[kHalo] >= nt) {
      const bool v = look_back(st, tile - 1, lane);
      if (lane == 0) s_behind = v;
    }
  }
  __syncthreads();

  const int lr = kRows * threadIdx.x;
  int multi = 0;
  int32_t mv[kRows];  // match of each target row
  uint32_t key[kRows], bit[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    key[j] = kNone;
    bit[j] = 0u;
    if (r + j >= n) continue;
    const unsigned upto = bits & ((2u << j) - 1u);
    const unsigned after = bits & ~((2u << j) - 1u);
    const uint32_t c = q.c[j];
    if (q.p[j] < nt) {
      const int e = after ? lr + __ffs(after) - 1 : next;  // in-tile
      int32_t v = -1;
      if (e < kTile) {
        if (s_code[kHalo + e] == c) {
          v = s_pos[kHalo + e] - static_cast<int32_t>(nt);
          multi += s_code[kHalo + e + 1] == c;
        }
      } else {
        v = static_cast<int32_t>(s_ahead >> 1) - 1;
        multi += s_ahead & 1u;
      }
      mv[j] = v;
    } else {
      const int b = upto ? lr + 31 - __clz(upto) : prev;  // in-tile
      const bool hit = b >= 0 ? s_code[kHalo + b - 1] == c : s_behind;
      if (hit) {
        const uint32_t s = static_cast<uint32_t>(q.p[j] - nt);
        key[j] = s >> 5;
        bit[j] = 1u << (s & 31);
      }
    }
  }
  // four target rows at four consecutive positions from a multiple of 4:
  // one 16-byte store, else one store a row
  const int32_t p0 = q.p[0];
  if (r + kRows <= n && (p0 & 3) == 0 && q.p[1] == p0 + 1 &&
      q.p[2] == p0 + 2 && q.p[3] == p0 + 3 && p0 + 3 < nt) {
    *reinterpret_cast<int4*>(match + p0) =
        make_int4(mv[0], mv[1], mv[2], mv[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (r + j < n && q.p[j] < nt) match[q.p[j]] = mv[j];
  }
  // one atomicOr per word and warp where neighbouring lanes share words
  // (source rows in input order), else one per row: grouping random
  // words costs more than it saves
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const uint32_t up = __shfl_up_sync(kAll, key[j], 1);
    if (__ballot_sync(kAll, lane > 0 && key[j] != kNone && key[j] == up)) {
      const unsigned group = __match_any_sync(kAll, key[j]);
      if (key[j] != kNone) {
        const unsigned v = __reduce_or_sync(group, bit[j]);
        if (lane == __ffs(group) - 1) atomicOr(&words[key[j]], v);
      }
    } else if (key[j] != kNone) {
      atomicOr(&words[key[j]], bit[j]);
    }
  }
  // n_multi: the warps' sums, then one atomic per block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    multi += __shfl_down_sync(kAll, multi, off);
  if (lane == 0) part[warp] = multi;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w];
    if (sum != 0) atomicAdd(n_multi, sum);
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Bytes of scratch the launch needs for nt + ns rows: an ahead word (8 B)
// and a behind word (4 B) a tile.
extern "C" long long merge_join_scratch_bytes(long long nt, long long ns) {
  return 12 * tiles_of(nt + ns);
}

// The C entry point, bound with ctypes by ops/join.py. Zeroes the scratch
// and launches on `stream`; returns the CUDA error of the launches (0 on
// success).
extern "C" int merge_join_launch(const void* code, const void* pos,
                                 long long nt, long long ns, void* match,
                                 void* words, void* n_multi, void* scratch,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nt < 0 || ns < 0 || nt + ns > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);  // i32 positions
  if ((reinterpret_cast<uintptr_t>(code) | reinterpret_cast<uintptr_t>(pos) |
       reinterpret_cast<uintptr_t>(match) |
       reinterpret_cast<uintptr_t>(scratch)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long n = nt + ns;
  if (n == 0) return 0;
  const long long tiles = tiles_of(n), n_words = (ns + 31) / 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint32_t*>(code);
  const auto* p = static_cast<const int32_t*>(pos);
  auto* ahead = static_cast<unsigned long long*>(scratch);
  auto* behind = reinterpret_cast<uint32_t*>(ahead + tiles);
  auto* w = static_cast<uint32_t*>(words);
  auto* multi = static_cast<int32_t*>(n_multi);
  if ((err = cudaMemsetAsync(scratch, 0, 12 * tiles, s)) != cudaSuccess)
    return static_cast<int>(err);
  merge_join_ahead<<<static_cast<unsigned>((tiles + kWarps - 1) / kWarps),
                     kThreads, 0, s>>>(c, p, nt, n, tiles, ahead, w, n_words,
                                       multi);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  merge_join_resolve<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      c, p, nt, ns, tiles, ahead, behind, static_cast<int32_t*>(match), w,
      multi);
  return static_cast<int>(cudaGetLastError());
}

// Replay winner pass, hand-written for Hopper (sm_90a).
//
// Replaces the tail of delta_tpu/ops/replay.py::_sort_winner_pack (the jnp
// code after its lax.sort): after a stable sort by replay key, every
// logical file's history is one contiguous run in chronological order, and
// the last row of each run is the newest action, the winner. The winner
// bit is scattered back to the row's original index and bit-packed, 32
// rows per word, little-endian bit order (ops/replay.py::_pack_bits).
//
// Inputs: sorted int64 keys [n], the original row index of each sorted
// row (int32 [n]), n, and ceil(n / 32) 32-bit words, which the entry point
// fills with ones on the stream before the launch.
// Rule, as in the reference: winner = is_last_of_run | ~next_valid. The
// reference pads to a bucket and drops padding through `valid`; here the
// arrays hold exactly n rows, so only the row past the end is not valid.
//
// Bound: memory. 8 B of key and 4 B of index read per row, 4 B written
// (and filled) per 32 rows: ~12 MB for 1M rows, ~3.7 us at 3.35 TB/s on an
// H100 SXM.
//
// Design, from measurements on the card (PERF.md). The scatter to original
// order is random in general, and it is the scattered read-modify-writes
// in L2, not the bytes, that bound a one-atomic-per-winner pass: ~15 us for
// the ~0.8M winners of the main path's 1M rows, whose path codes rank the
// paths' little-endian 8-byte words and so scatter like random names. So
// the kernel writes the complement: the words start as ones and each
// loser (a row with a newer action of its key) clears its bit with
// atomicAnd. A replay's losers are the files' older actions, a fifth of
// the rows there, so a quarter of the atomics. Each thread takes kRows = 4
// consecutive sorted rows, a warp 128: two 16-byte key loads and one
// 16-byte index load. The key after a thread's last row is the next lane's
// first key (__shfl_down_sync); only lane 31 loads one key across the
// warp's edge. A view whose data does not start 16-byte aligned, and the
// ragged end, load row by row inside the same loop. A thread ORs its
// losers that fall in one word and issues one atomic per such run (merging
// runs across lanes by a segmented shuffle scan measured no faster on the
// main path's keys, and grouping lanes by word with __match_any_sync +
// __reduce_or_sync slower than the one atomic per winner it was to save:
// PERF.md).
// The result does not depend on the order of the atomics. The grid is
// sized from the device's SM count (read once per device and cached),
// with a grid-stride loop over the warps' row tiles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;                  // sorted rows per thread
constexpr int kThreads = 256;
constexpr int kWarpRows = 32 * kRows;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNoWord = 0xFFFFFFFFu;  // r >> 5 < 2^26: never a word
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
winner_pack_kernel(const long long* __restrict__ skey,
                   const int* __restrict__ sidx, long long n, int vec,
                   unsigned* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  if (warp == 0 && lane == 0 && (n & 31)) {
    // the last word's bits past row n - 1 are not rows: clear them
    atomicAnd(words + (n >> 5), (1u << (n & 31)) - 1);
  }
  for (long long base = warp * kWarpRows; base < n;
       base += warps * kWarpRows) {
    const long long i0 = base + static_cast<long long>(lane) * kRows;
    long long key[kRows];
    int idx[kRows];
    if (vec && i0 + kRows <= n) {
      const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(skey + i0));
      const longlong2 b =
          __ldg(reinterpret_cast<const longlong2*>(skey + i0 + 2));
      const int4 c = __ldg(reinterpret_cast<const int4*>(sidx + i0));
      key[0] = a.x; key[1] = a.y; key[2] = b.x; key[3] = b.y;
      idx[0] = c.x; idx[1] = c.y; idx[2] = c.z; idx[3] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const bool in = i0 + j < n;
        key[j] = in ? __ldg(skey + i0 + j) : 0;
        idx[j] = in ? __ldg(sidx + i0 + j) : 0;
      }
    }
    // the key after this thread's last row: the next lane's first
    long long next = __shfl_down_sync(kFull, key[0], 1);
    if (lane == 31 && base + kWarpRows < n) {
      next = __ldg(skey + base + kWarpRows);
    }

    // this thread's losers, one atomic per run of rows in one word
    unsigned word = kNoWord, bits = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long after = j + 1 < kRows ? key[j + 1] : next;
      if (i0 + j + 1 < n && key[j] == after) {  // not the last of its run
        const unsigned r = static_cast<unsigned>(idx[j]);
        if (r >> 5 != word) {
          if (word != kNoWord) atomicAnd(words + word, ~bits);
          word = r >> 5;
          bits = 0;
        }
        bits |= 1u << (r & 31);
      }
    }
    if (word != kNoWord) atomicAnd(words + word, ~bits);
  }
}

int sm_count(int device) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 132;
  if (cached[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || sms <= 0) {
      return 132;
    }
    cached[device] = sms;
  }
  return cached[device];
}

}  // namespace

// Fills `words` (ceil(n / 32) of them) with ones and launches the pass,
// both on `stream` of CUDA device `device`; returns the CUDA error code (0
// = launched).
extern "C" int winner_pack_launch(const void* skey, const void* sidx,
                                  long long n, void* words, int device,
                                  void* stream) {
  if (n <= 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(words, 0xFF, static_cast<size_t>((n + 31) / 32) * 4,
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<uintptr_t>(skey) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sidx) % 16 == 0);
  const long long tiles = (n + kWarpRows - 1) / kWarpRows;
  long long blocks = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const long long resident = static_cast<long long>(sm_count(device)) *
                             (2048 / kThreads);
  if (blocks > resident) blocks = resident;
  winner_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const long long*>(skey), static_cast<const int*>(sidx), n,
      vec, static_cast<unsigned int*>(words));
  return static_cast<int>(cudaGetLastError());
}

// K4 `interleave_bits`: the Z-order (and Hilbert) curve key of OPTIMIZE.
//
// Replaces the TPU kernel B3, `interleave_bits_tiled` / `_interleave_kernel`
// (delta_tpu/ops/pallas_kernels.py:58-89), reached from
// `delta_tpu/ops/zorder.py:156` (Z-order, n_bits 32) and, through the jnp
// twin `interleave_bits`, from `hilbert_key` (n_bits 16).
//
// Computes, for each row i of a [k, n] u32 matrix (column-major rows: the
// value of column c at row i is cols[c * n + i]), ceil(k * n_bits / 32)
// u32 key words. The bits go MSB-first and round-robin: global bit g comes
// from column g % k, source bit n_bits - 1 - g / k, and lands in word g / 32
// at bit 31 - g % 32. Sorting rows by (word 0, word 1, ...) sorts them
// along the Z-order curve. The TPU kernel needs n % 1024 == 0 (one [8, 128]
// tile per grid step); any n works here.
//
// Bound: bytes. Each row reads 4 * k bytes and writes 4 * w; the bit loop
// is about 4 integer operations per output bit (shift, and, shift, or),
// 384 per row at k = 3, n_bits = 32, under the byte time at 67 TOP/s.
// Design, simple and right: one thread per row in a grid-stride loop; the
// row's k values are loaded once (coalesced along each column), the bit
// loop runs in registers, fully unrolled by template for the cases the path
// uses (k <= 4, n_bits 16 or 32), a runtime loop for the rest; the w words
// are stored coalesced along each word row. A bit-spreading formulation
// (magic-number masks instead of a loop over bits) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 32;

template <int K, int NBITS>
__global__ void interleave_fixed(const uint32_t* __restrict__ cols, int64_t n,
                                 uint32_t* __restrict__ out) {
  constexpr int kTotal = K * NBITS;
  constexpr int kWords = (kTotal + 31) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t v[K];
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] = cols[c * n + i];
    uint32_t w[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) w[j] = 0u;
#pragma unroll
    for (int g = 0; g < kTotal; ++g) {
      const int c = g % K;
      const int s = NBITS - 1 - g / K;
      w[g / 32] |= ((v[c] >> s) & 1u) << (31 - g % 32);
    }
#pragma unroll
    for (int j = 0; j < kWords; ++j) out[j * n + i] = w[j];
  }
}

__global__ void interleave_generic(const uint32_t* __restrict__ cols, int k,
                                   int n_bits, int n_words, int64_t n,
                                   uint32_t* __restrict__ out) {
  const int total = k * n_bits;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t v[kMaxCols];
    for (int c = 0; c < k; ++c) v[c] = cols[c * n + i];
    for (int j = 0; j < n_words; ++j) {
      uint32_t word = 0u;
      const int g_end = min(total, 32 * (j + 1));
      for (int g = 32 * j; g < g_end; ++g) {
        const int s = n_bits - 1 - g / k;
        word |= ((v[g % k] >> s) & 1u) << (31 - (g & 31));
      }
      out[j * n + i] = word;
    }
  }
}

}  // namespace

#define DTT_INTERLEAVE_FIXED(K, B)                                          \
  if (k == K && n_bits == B) {                                              \
    interleave_fixed<K, B><<<blocks, threads, 0, s>>>(in, n, o);            \
    return static_cast<int>(cudaGetLastError());                            \
  }

extern "C" int interleave_bits_launch(const void* cols, int k, int n_bits,
                                      long long n, void* out, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxCols || n_bits < 1 || n_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  long long cap = static_cast<long long>(sms) * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(cols);
  uint32_t* o = static_cast<uint32_t*>(out);
  DTT_INTERLEAVE_FIXED(1, 16)
  DTT_INTERLEAVE_FIXED(1, 32)
  DTT_INTERLEAVE_FIXED(2, 16)
  DTT_INTERLEAVE_FIXED(2, 32)
  DTT_INTERLEAVE_FIXED(3, 16)
  DTT_INTERLEAVE_FIXED(3, 32)
  DTT_INTERLEAVE_FIXED(4, 16)
  DTT_INTERLEAVE_FIXED(4, 32)
  const int n_words = (k * n_bits + 31) / 32;
  interleave_generic<<<blocks, threads, 0, s>>>(in, k, n_bits, n_words, n, o);
  return static_cast<int>(cudaGetLastError());
}

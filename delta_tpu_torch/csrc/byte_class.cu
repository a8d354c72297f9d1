// JSON structural byte classes, hand-written for Hopper (sm_90a).
//
// Replaces delta_tpu/ops/pallas_kernels.py::byte_class_tiled
// (_byte_class_kernel), the first stage of the device JSON parse: one
// uint8 class mask per input byte, bits newline=1, quote=2, backslash=4,
// colon=8, '{'=16, '}'=32 (BYTE_CLASS_BITS there).
//
// Bound: memory. Each byte is read once and its class written once, 2 B of
// traffic per input byte for a dozen integer operations, so a 64 MiB
// window needs ~134 MB / 3.35 TB/s ~= 40 us on an H100 SXM.
//
// Design: the TPU kernel walks (32, 128) uint8 tiles and needs
// n % 4096 == 0; here any n is taken. Each thread moves 16 bytes per step
// with one 128-bit load and one 128-bit store (neighbouring threads on
// neighbouring addresses), classifying the four 32-bit words byte by byte
// in registers; a grid-stride loop covers the buffer with a grid sized to
// the card, and a scalar loop takes the tail that is not a multiple of 16
// (or the whole buffer when a pointer is not 16-byte aligned).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t class_of_byte(uint32_t b) {
  return static_cast<uint32_t>(b == 10u)
       | (static_cast<uint32_t>(b == 34u) << 1)
       | (static_cast<uint32_t>(b == 92u) << 2)
       | (static_cast<uint32_t>(b == 58u) << 3)
       | (static_cast<uint32_t>(b == 123u) << 4)
       | (static_cast<uint32_t>(b == 125u) << 5);
}

__device__ __forceinline__ uint32_t class_of_word(uint32_t w) {
  return class_of_byte(w & 0xFFu)
       | (class_of_byte((w >> 8) & 0xFFu) << 8)
       | (class_of_byte((w >> 16) & 0xFFu) << 16)
       | (class_of_byte(w >> 24) << 24);
}

__global__ void byte_class_kernel(const uint8_t* __restrict__ in,
                                  uint8_t* __restrict__ out,
                                  long long n, long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long v = tid; v < n_vec; v += stride) {
    const uint4 x = __ldg(in4 + v);
    uint4 y;
    y.x = class_of_word(x.x);
    y.y = class_of_word(x.y);
    y.z = class_of_word(x.z);
    y.w = class_of_word(x.w);
    out4[v] = y;
  }
  for (long long j = n_vec * 16 + tid; j < n; j += stride) {
    out[j] = static_cast<uint8_t>(class_of_byte(in[j]));
  }
}

}  // namespace

// Launches on `stream` of CUDA device `device`; returns the CUDA error
// code of the launch (0 = launched). `in` and `out` hold n bytes each.
extern "C" int byte_class_launch(const void* in, void* out, long long n,
                                 int device, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long n_vec = aligned ? n / 16 : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  const int threads = 256;
  long long blocks = (work + threads - 1) / threads;
  const long long max_blocks = 132 * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  byte_class_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, n_vec);
  return static_cast<int>(cudaGetLastError());
}

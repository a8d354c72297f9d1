// K7 `skip_mask`: data skipping's keep mask over the resident stats lanes.
//
// Replaces the JAX package's batched skipping function `_skip_fn_cached`
// (delta_tpu/ops/skipping.py:88-112, with `_known_false` at :65-85), a jnp
// function, not a Pallas kernel: queue B's B8. Reached through
// `stats/skipping.py::skipping_mask` on every filtered scan.
//
// Computes, for each file f of F, keep[f] = NOT (some OR-group of atoms has
// every atom known false for f). The lanes are int64 vals [R, F] and bool
// valid [R, F], row-major: an atom on column c reads min, max and nullCount
// at rows r, r + 1, r + 2 (r = 3c) and numRecords at row R - 1. Known false
// (the stat that decides is present and proves no row matches):
//   op 0 '<'  : min >= lit        op 1 '<=' : min > lit
//   op 2 '>'  : max <= lit        op 3 '>=' : max < lit
//   op 4 '='  : min > lit or max < lit
//   op 5 '!=' : min == lit and max == lit
//   op 6 IS NULL : nullCount == 0
//   other (7, IS NOT NULL) : nullCount == numRecords
// and ops 0-5 also where nullCount == numRecords (every row null). A group
// with no atom never skips; with no group every file is kept.
//
// Atoms come sorted by group in one int64 buffer: rows [A], ops [A],
// literals [A], group offsets [G + 1]. Bound: bytes. Per file the function
// must read 8 B of every distinct value row its atoms need and 1 B of every
// distinct validity row, and write 1 B; each atom costs a few integer
// comparisons. Design, simple and right: one thread per file, 256 a block;
// neighbouring threads read neighbouring 8-byte words of a row, so a warp's
// loads of one row are coalesced. The thread walks the groups in order and
// stops at the first group whose atoms are all known false (and, within a
// group, at the first atom that is not), so it reads only what decides; a
// row it has just loaded is not loaded again for the next atom of the same
// column (an IN list's atoms), and numRecords is loaded once. The atoms are
// read from global memory: every thread of a warp reads the same address,
// one broadcast load served from L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void skip_mask_kernel(const int64_t* __restrict__ vals,
                                 const uint8_t* __restrict__ valid,
                                 int64_t n_rows, int64_t stride,
                                 int64_t n_files,
                                 const int64_t* __restrict__ atoms,
                                 int n_atoms, int n_groups,
                                 uint8_t* __restrict__ keep) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= n_files) return;
  const int64_t* rows = atoms;
  const int64_t* ops = atoms + n_atoms;
  const int64_t* lits = atoms + 2 * n_atoms;
  const int64_t* offs = atoms + 3 * n_atoms;

  const int64_t nr_at = (n_rows - 1) * stride + f;
  const int64_t nr = vals[nr_at];
  const bool vnr = valid[nr_at] != 0;

  int64_t cur = -1;  // the min row whose three lanes are in registers
  int64_t mn = 0, mx = 0, nc = 0;
  bool vmn = false, vmx = false, vnc = false;
  bool kept = true;
  for (int g = 0; g < n_groups && kept; ++g) {
    const int64_t s = __ldg(offs + g);
    const int64_t e = __ldg(offs + g + 1);
    if (s == e) continue;  // an empty group never skips
    bool all_false = true;
    for (int64_t a = s; a < e && all_false; ++a) {
      const int64_t r = __ldg(rows + a);
      if (r != cur) {
        const int64_t at = r * stride + f;
        mn = vals[at];
        mx = vals[at + stride];
        nc = vals[at + 2 * stride];
        vmn = valid[at] != 0;
        vmx = valid[at + stride] != 0;
        vnc = valid[at + 2 * stride] != 0;
        cur = r;
      }
      const int64_t op = __ldg(ops + a);
      const int64_t lit = __ldg(lits + a);
      const bool all_null = vnc && vnr && nc == nr;
      bool kf;
      switch (op) {
        case 0: kf = vmn && mn >= lit; break;
        case 1: kf = vmn && mn > lit; break;
        case 2: kf = vmx && mx <= lit; break;
        case 3: kf = vmx && mx < lit; break;
        case 4: kf = (vmn && mn > lit) || (vmx && mx < lit); break;
        case 5: kf = vmn && vmx && mn == lit && mx == lit; break;
        case 6: kf = vnc && nc == 0; break;
        default: kf = all_null; break;
      }
      if (op >= 0 && op <= 5) kf = kf || all_null;
      all_false = kf;
    }
    if (all_false) kept = false;
  }
  keep[f] = kept ? 1 : 0;
}

}  // namespace

extern "C" int skip_mask_launch(const void* vals, const void* valid,
                                long long n_rows, long long stride,
                                long long n_files, const void* atoms,
                                int n_atoms, int n_groups, void* keep,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows < 1 || n_files < 0 || n_files > stride || n_atoms < 0 ||
      n_groups < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_files == 0) return 0;
  const long long blocks = (n_files + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  skip_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const uint8_t*>(valid),
      n_rows, stride, n_files, static_cast<const int64_t*>(atoms), n_atoms,
      n_groups, static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

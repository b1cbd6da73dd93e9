// Symmetric-storage stencil block-SpMV y = A x for the SoA shell operator,
// from the upper half U of its slots (the offsets off >= 0).
//
// A is symmetric: the block coupling n to n - off is the transpose of the
// block coupling n - off to n, values[a, b, -off](n) = values[b, a, off](n - off).
// So with U[(a*6 + b)*Ku + s, n] the slots of offsets up_s >= 0 (up_0 = 0):
//
//   y[a, n] = sum_{s}        sum_b U[a, b, s](n)          * x[b, n + up_s]   (direct)
//           + sum_{s: up_s>0} sum_b U[b, a, s](n - up_s)  * x[b, n - up_s]   (transposed)
//
//   U [36, Ku, Npad] f64, x, y [6, Npad] f64
//
// Replaces the TPU kernel
//   fem_shell_tpu/ops/pallas_spmv_df.py  _kernel_sym (stencil_spmv_pallas_df_sym)
// the symmetric-storage CG matvec of the materialized pair. Native f64 takes
// the place of the two-float32 pair.
//
// Bound: bytes. A launch must read U once, 36*S_up values with
// S_up = sum_s (Npad - up_s) (the direct read of slot s at n and its
// transposed read at n - up_s cover the same Npad - up_s entries), x once and
// write y: (36*S_up + 12*Npad)*8 bytes, about 55 % of the full-storage
// product's, at 2 operations per term.
//
// Design: the TPU kernel walks its grid in order and hands the transposed
// terms that cross a tile to the next grid step in a scratch carry. Blocks on
// the card run in no order, so this kernel gathers instead: thread n owns
// y[:, n] and reads the transposed blocks it needs from the node n - up_s that
// stores them. No atomics, no carry, no second pass, and one summation order
// on every run (slot by slot, the direct term and then the transposed one).
// Both reads are coalesced (stride Npad across the 36*Ku rows, contiguous in
// n). The two terms of one slot sit in one loop step, so that thread n reads
// U[., s](n - up_s) close in time to the direct read of the same entries by
// thread n - up_s, up_s <= nxp + 1 nodes (a few blocks) earlier, and can find
// them in L2; with all direct terms first, tens of microseconds and some
// 100 MB of traffic would lie between the two reads. Even so, on an H100 the
// kernel takes about as long as the full-storage one, at half its bytes
// bound: its time follows the 36*(2*Ku - 1) loads it issues per node more
// than the bytes (PERF.md). A target outside [0, Npad) contributes nothing,
// as in stencil_spmv.cu.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxUpper = 17;  // the off >= 0 half of build_soa_pattern's 32 slots

struct Offsets {
  int v[kMaxUpper];
};

template <typename T>
__global__ void __launch_bounds__(256) stencil_spmv_sym_kernel(
    const T* __restrict__ upper, const T* __restrict__ x, T* __restrict__ y,
    const Offsets offs, const int ku, const int64_t npad) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= npad) return;
  T acc[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[a] = T(0);
  for (int s = 0; s < ku; ++s) {
    const int off = offs.v[s];
    T xb[6];
    const int64_t t = n + off;  // direct: U(n) x(n + up_s)
    if (t < npad) {
#pragma unroll
      for (int b = 0; b < 6; ++b) xb[b] = __ldg(x + b * npad + t);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b < 6; ++b) {
          acc[a] += __ldg(upper + ((a * 6 + b) * static_cast<int64_t>(ku) + s) * npad + n) * xb[b];
        }
      }
    }
    const int64_t m = n - off;  // transposed: U(m)^T x(m), m = n - up_s
    if (off == 0 || m < 0) continue;
#pragma unroll
    for (int b = 0; b < 6; ++b) xb[b] = __ldg(x + b * npad + m);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        acc[a] += __ldg(upper + ((b * 6 + a) * static_cast<int64_t>(ku) + s) * npad + m) * xb[b];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) y[a * npad + n] = acc[a];
}

}  // namespace

// Plain C interface for ctypes. `offsets` is a host array of the ku upper
// offsets, ascending from 0; the return value is cudaGetLastError() after the
// launch (0 = launched).
extern "C" int stencil_spmv_sym_f64(const double* upper, const double* x, double* y,
                                    const int* offsets, int ku, int64_t npad, void* stream) {
  if (ku < 1 || ku > kMaxUpper || npad < 1 || offsets[0] != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets offs{};
  for (int s = 0; s < ku; ++s) offs.v[s] = offsets[s];
  constexpr int kThreads = 256;
  const int64_t blocks = (npad + kThreads - 1) / kThreads;
  stencil_spmv_sym_kernel<double><<<static_cast<unsigned>(blocks), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(upper, x, y, offs, ku,
                                                                         npad);
  return static_cast<int>(cudaGetLastError());
}

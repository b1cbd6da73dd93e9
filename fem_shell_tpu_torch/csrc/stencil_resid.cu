// Compensated stencil residual r = b - A x for the SoA shell operator, in
// double-double accumulation rounded once to double.
//
//   r[a, n] = b[a, n] - sum_s sum_b values[(a*6 + b)*K + s, n] * x[b, n + off_s]
//
//   values [36, K, Npad] f64, x, b, r [6, Npad] f64
//
// Replaces the TPU kernel
//   fem_shell_tpu/ops/pallas_spmv_df.py  _kernel / _kernel_flat with tf=True
// (the 4-level compensated accumulator, ~2^-70, of the iterative-refinement
// residual's main term). Native f64 products with an exact error term and a
// double-double running sum take the place of the two-float32 pair.
//
// Bound: bytes. A launch must read 36*S values (S = sum_s (Npad - |off_s|),
// the slots whose target lies inside the vector) and x and b, and write r:
// (36*S + 18*Npad)*8 bytes, at about 11 operations per term (one multiply,
// one fma, six adds of the TwoSum, two adds into the error sum) -- 1.4
// operations per byte, under the card's f64 balance point of ~10.
//
// Design: the layout and coalescing of stencil_spmv.cu: one thread per node,
// a 1-D grid over Npad, thread n reading its 36*K values at stride Npad (one
// 256-byte segment per warp load) and x through the read-only cache. Each
// product is split exactly, p + e = v * x with p = __dmul_rn(v, x) and
// e = fma(v, x, -p); -p enters the running sum s by Knuth's TwoSum and the
// sum's rounding error joins -e in the error sum c, per output component,
// seeded with (b, 0). r = s + c. This is Ogita-Rump-Oishi's Dot2: the result
// is as accurate as a sum taken in twice the working precision (error about
// (6K)^2 * 2^-106 of sum |v x|) and then rounded. __dmul_rn keeps nvcc from
// contracting p into the following add: a fused p would be the exact product,
// and the TwoSum would no longer see the value e was computed against. No
// other multiply feeds an add, so no other contraction is possible. A target
// outside [0, Npad) contributes nothing, as in stencil_spmv.cu. Registers:
// 12 doubles of accumulator and 6 of x per thread.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxStencil = 32;  // build_soa_pattern's max_stencil

struct Offsets {
  int v[kMaxStencil];
};

__global__ void __launch_bounds__(256) stencil_resid_dd_kernel(
    const double* __restrict__ values, const double* __restrict__ x,
    const double* __restrict__ b, double* __restrict__ r, const Offsets offs, const int k,
    const int64_t npad) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= npad) return;
  double s[6], c[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    s[a] = b[a * npad + n];
    c[a] = 0.0;
  }
  for (int j = 0; j < k; ++j) {
    const int64_t t = n + offs.v[j];
    if (t < 0 || t >= npad) continue;
    double xb[6];
#pragma unroll
    for (int bb = 0; bb < 6; ++bb) xb[bb] = __ldg(x + bb * npad + t);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int bb = 0; bb < 6; ++bb) {
        const double v = __ldg(values + ((a * 6 + bb) * static_cast<int64_t>(k) + j) * npad + n);
        const double p = __dmul_rn(v, xb[bb]);
        const double e = fma(v, xb[bb], -p);
        // TwoSum(s, -p) = (sn, err), exactly s - p = sn + err
        const double sn = s[a] - p;
        const double z = sn - s[a];
        const double err = (s[a] - (sn - z)) + (-p - z);
        s[a] = sn;
        c[a] = c[a] + (err - e);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) r[a * npad + n] = s[a] + c[a];
}

}  // namespace

// Plain C interface for ctypes. `offsets` is a host array of k ints; the
// return value is cudaGetLastError() after the launch (0 = launched).
extern "C" int stencil_resid_dd_f64(const double* values, const double* x, const double* b,
                                    double* r, const int* offsets, int k, int64_t npad,
                                    void* stream) {
  if (k < 1 || k > kMaxStencil || npad < 1) return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  for (int j = 0; j < k; ++j) offs.v[j] = offsets[j];
  constexpr int kThreads = 256;
  const int64_t blocks = (npad + kThreads - 1) / kThreads;
  stencil_resid_dd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(values, x, b, r, offs, k, npad);
  return static_cast<int>(cudaGetLastError());
}

// Stencil block-SpMV for the SoA shell operator, y = A x.
//
//   y[a, n] = sum_s sum_b values[(a*6 + b)*K + s, n] * x[b, n + off_s]
//
//   values [36, K, Npad] (slot s of node n = 6x6 block coupling n to n+off_s)
//   x, y   [6, Npad]
//
// Replaces the TPU kernels
//   fem_shell_tpu/ops/pallas_spmv.py     _kernel, _kernel_tiled  (float)
//   fem_shell_tpu/ops/pallas_spmv_df.py  _kernel, _kernel_flat   (double; tf=False)
// Native f64 takes the place of the two-float32 pair of the df kernels.
//
// A third instance, stencil_spmv_f32v (float values, double x and y),
// replaces no TPU kernel: it is the f64 CG matvec over an f32 operator
// (the f32 LargeShellSystem's and MultigridShellSystem's solve_df), the
// counterpart of the JAX package's XLA df_stencil_matvec_f32v
// (fem_shell_tpu/ops/df.py:212). A copy of the values cast up would move
// twice the operator's bytes; this instance reads them as f32 and widens
// each in registers. Each product and sum is in f64 (nvcc may fuse a pair
// into one fma).
//
// Bound: bytes. Each launch must read 36*K*Npad values and 6*Npad entries
// of x and write 6*Npad entries of y, at 2*36*K flops per node: about
// 0.25 flop per byte, far under the card's balance point.
//
// Design: one thread per node and a 1-D grid over Npad. Thread n reads its
// 36*K values at stride Npad, so every load of a warp is one coalesced
// 128-byte (f32) or 256-byte (f64) segment; x goes through the read-only
// cache, where the K shifted reads of neighbouring nodes hit the same
// lines. A target outside [0, Npad) contributes nothing: the JAX package
// stores zero blocks there, so skipping them gives the same sum. The
// offsets travel by value in the kernel's parameters (constant bank).
// Sums accumulate in the vector type, in slot-then-column order. The
// kernel is templated on the value type V and the vector type X; with
// V == X the conversion is the identity, so <float> and <double> compile
// to what they were before the mixed instance.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxStencil = 32;  // build_soa_pattern's max_stencil

struct Offsets {
  int v[kMaxStencil];
};

template <typename V, typename X>
__global__ void __launch_bounds__(256) stencil_spmv_kernel(
    const V* __restrict__ values, const X* __restrict__ x, X* __restrict__ y,
    const Offsets offs, const int k, const int64_t npad) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= npad) return;
  X acc[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[a] = X(0);
  for (int s = 0; s < k; ++s) {
    const int64_t t = n + offs.v[s];
    if (t < 0 || t >= npad) continue;
    X xb[6];
#pragma unroll
    for (int b = 0; b < 6; ++b) xb[b] = __ldg(x + b * npad + t);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        acc[a] += static_cast<X>(__ldg(values + ((a * 6 + b) * static_cast<int64_t>(k) + s) * npad + n)) *
                  xb[b];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) y[a * npad + n] = acc[a];
}

template <typename V, typename X>
int launch(const V* values, const X* x, X* y, const int* offsets, int k, int64_t npad,
           cudaStream_t stream) {
  if (k < 1 || k > kMaxStencil || npad < 1) return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  for (int s = 0; s < k; ++s) offs.v[s] = offsets[s];
  constexpr int kThreads = 256;
  const int64_t blocks = (npad + kThreads - 1) / kThreads;
  stencil_spmv_kernel<V, X><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      values, x, y, offs, k, npad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. `offsets` is a host array of k ints; the
// return value is cudaGetLastError() after the launch (0 = launched).
extern "C" int stencil_spmv_f32(const float* values, const float* x, float* y,
                                const int* offsets, int k, int64_t npad, void* stream) {
  return launch<float, float>(values, x, y, offsets, k, npad, static_cast<cudaStream_t>(stream));
}

extern "C" int stencil_spmv_f64(const double* values, const double* x, double* y,
                                const int* offsets, int k, int64_t npad, void* stream) {
  return launch<double, double>(values, x, y, offsets, k, npad, static_cast<cudaStream_t>(stream));
}

extern "C" int stencil_spmv_f32v(const float* values, const double* x, double* y,
                                 const int* offsets, int k, int64_t npad, void* stream) {
  return launch<float, double>(values, x, y, offsets, k, npad, static_cast<cudaStream_t>(stream));
}

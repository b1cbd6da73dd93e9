// Matrix-free class-table operator on a uniform structured grid:
//
//   y[a, n] = sum_s sum_b c[s, a, b] * x[b, n + off_s]          (interior)
//           + sum_s sum_b band[s, a, b, j, l] * x[b, n + off_s] (band nodes)
//
//   x, y         [6, Npad]; node n = iy*nxp + ix for n < nyp*nxp, the
//                padding [nyp*nxp, Npad) is written too (CG dots read it)
//   c            [K, 6, 6] interior class stencil, by value (constant bank)
//   bands        [K, 6, 6, 2, 2*nxp + 2*nyp] per-node deltas to the
//                interior class, the four bands side by side along the
//                last axis: rows 0,1 (top) and nyp-2,nyp-1 (bottom), nxp
//                long, then columns 0,1 (left) and nxp-2,nxp-1 (right),
//                nyp long; the column tables are zero on the four band
//                rows, so corner nodes are owned by the row bands
//   off_s        (dy, dx) in {-1, 0, 1}^2; a neighbour outside the grid
//                is skipped
//
// and, fused, y = w * (b - A x) (the Jacobi correction and the Chebyshev
// z of the level-0 smoother) in the same pass.
//
// Replaces the TPU kernels of fem_shell_tpu/ops/pallas_class.py:
//   :130 _kernel      via :311 class_matvec_f32_pad / class_smooth_f32_pad
//                     (float: level-0 V-cycle) and via :545
//                     class_interior_pallas (class_matvec_f32 /
//                     class_ecorr_f32 / class_matvec_df interior term)
//   :163 _kernel_df2  via :417 class_matvec_df_pad (the fine CG operator)
// The Pallas kernels compute the interior term only and leave the band
// folds to XLA; here both are one pass. Native f64 takes the place of the
// two-float32 (df) arithmetic: the double instance runs A_df = fl64(t0+t1).
//
// Bound: bytes. A launch must read x (6*Npad values), write y (6*Npad),
// read the band entries of the accumulated (a, b, s) triples on the band
// nodes (O(boundary)) and, fused, w and b (12*Npad more); it does two
// operations per accumulated triple per node (~250 at K=9 for a flat
// shell). At 1024^2 in f64: ~100 MB of vectors, ~30 us at 3.35 TB/s,
// against ~6 us of f64 arithmetic.
//
// Design: one thread per node on a 1-D grid over Npad, so the lanes of a
// warp take consecutive ix and every x load is a coalesced row segment;
// the K neighbour rows of a warp overlap and come from L1/L2 (read-only
// path), so x streams from device memory about once. There is no
// coefficient stream: the interior table rides in the kernel parameters,
// read uniformly by every thread, and structurally zero (a, b, s) triples
// (flat shells decouple membrane, plate and drilling DOFs) are skipped by
// a per-offset bit mask. Only the threads of the 2-node-wide boundary
// bands read band tables. The interior and band sums run apart, each
// s-major then b with explicit fma, and meet at the end: where a band
// delta is the exact negative of the interior coefficient (every coupling
// of a constrained DOF, whose class row is an identity row) the two
// partial sums are exact negatives and cancel to zero, which keeps the
// constrained DOFs exactly decoupled, as in the JAX package.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxK = 9;  // 3x3 node stencil

template <typename T>
struct Params {
  T c[kMaxK][36];                // interior coefficients c[s][a*6 + b]
  unsigned long long mask[kMaxK];  // bit a*6 + b set: (a, b, s) is accumulated
  unsigned need[kMaxK];          // bit b set: x[b] of offset s is read
  int dy[kMaxK];
  int dx[kMaxK];
  int k;
};

template <typename T, bool kFused>
__global__ void __launch_bounds__(256) class_stencil_kernel(
    const __grid_constant__ Params<T> p, const T* __restrict__ x, T* __restrict__ y,
    const T* __restrict__ w, const T* __restrict__ bv, const T* __restrict__ bands,
    const int nyp, const int nxp, const int64_t npad) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= npad) return;
  if (n >= static_cast<int64_t>(nyp) * nxp) {  // padding: A x = 0 there
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int64_t i = a * npad + n;
      y[i] = kFused ? w[i] * bv[i] : T(0);
    }
    return;
  }
  const int iy = static_cast<int>(n / nxp);
  const int ix = static_cast<int>(n - static_cast<int64_t>(iy) * nxp);

  // the band this node belongs to, if any (row bands own the corners):
  // band row j and position l along the concatenated band axis
  const int len = 2 * (nxp + nyp);
  int j = -1, l = 0;
  if (iy < 2) {
    j = iy, l = ix;
  } else if (iy >= nyp - 2) {
    j = iy - (nyp - 2), l = nxp + ix;
  } else if (ix < 2) {
    j = ix, l = 2 * nxp + iy;
  } else if (ix >= nxp - 2) {
    j = ix - (nxp - 2), l = 2 * nxp + nyp + iy;
  }

  T acc[6], accb[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[a] = accb[a] = T(0);
  for (int s = 0; s < p.k; ++s) {
    const int qy = iy + p.dy[s], qx = ix + p.dx[s];
    if (qy < 0 || qy >= nyp || qx < 0 || qx >= nxp) continue;
    const int64_t t = static_cast<int64_t>(qy) * nxp + qx;
    const unsigned need = p.need[s];
    T xb[6];
#pragma unroll
    for (int b = 0; b < 6; ++b) xb[b] = (need >> b) & 1u ? __ldg(x + b * npad + t) : T(0);
    const unsigned long long m = p.mask[s];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        if ((m >> (a * 6 + b)) & 1ull) acc[a] = fma(p.c[s][a * 6 + b], xb[b], acc[a]);
      }
    }
    if (j >= 0) {
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b < 6; ++b) {
          if ((m >> (a * 6 + b)) & 1ull) {
            const int64_t at = ((static_cast<int64_t>((s * 6 + a) * 6 + b) * 2 + j) * len) + l;
            accb[a] = fma(__ldg(bands + at), xb[b], accb[a]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const int64_t i = a * npad + n;
    const T v = acc[a] + accb[a];
    y[i] = kFused ? w[i] * (bv[i] - v) : v;
  }
}

template <typename T>
int launch(const T* x, T* y, const T* w, const T* bv, const T* coef,
           const unsigned long long* mask, const int* dydx, int k, const T* bands, int nyp,
           int nxp, int64_t npad, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || nyp < 4 || nxp < 4 || npad < static_cast<int64_t>(nyp) * nxp ||
      (w == nullptr) != (bv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params<T> p{};
  p.k = k;
  for (int s = 0; s < k; ++s) {
    p.mask[s] = mask[s];
    unsigned need = 0;
    for (int a = 0; a < 6; ++a) {
      for (int b = 0; b < 6; ++b) {
        p.c[s][a * 6 + b] = coef[s * 36 + a * 6 + b];
        if ((mask[s] >> (a * 6 + b)) & 1ull) need |= 1u << b;
      }
    }
    p.need[s] = need;
    p.dy[s] = dydx[2 * s];
    p.dx[s] = dydx[2 * s + 1];
  }
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((npad + kThreads - 1) / kThreads);
  if (w != nullptr) {
    class_stencil_kernel<T, true><<<blocks, kThreads, 0, stream>>>(p, x, y, w, bv, bands, nyp,
                                                                    nxp, npad);
  } else {
    class_stencil_kernel<T, false><<<blocks, kThreads, 0, stream>>>(p, x, y, w, bv, bands, nyp,
                                                                     nxp, npad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. `coef` (k*36 values, [s][a][b]), `mask`
// (k) and `dydx` (2k) are host arrays; every other pointer is device
// memory. `w` and `bv` are both null (y = A x) or both set
// (y = w * (bv - A x)). Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int class_stencil_f32(const float* x, float* y, const float* w, const float* bv,
                                 const float* coef, const unsigned long long* mask,
                                 const int* dydx, int k, const float* bands, int nyp, int nxp,
                                 int64_t npad, void* stream) {
  return launch<float>(x, y, w, bv, coef, mask, dydx, k, bands, nyp, nxp, npad,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int class_stencil_f64(const double* x, double* y, const double* w, const double* bv,
                                 const double* coef, const unsigned long long* mask,
                                 const int* dydx, int k, const double* bands, int nyp, int nxp,
                                 int64_t npad, void* stream) {
  return launch<double>(x, y, w, bv, coef, mask, dydx, k, bands, nyp, nxp, npad,
                        static_cast<cudaStream_t>(stream));
}

// Matrix-free class-table operator on a uniform structured grid:
//
//   y[a, n] = sum_s sum_b c[s, a, b] * x[b, n + off_s]          (interior)
//           + sum_s sum_b band[s, a, b, j, l] * x[b, n + off_s] (band nodes)
//
//   x, y         [6, Npad]; node n = iy*nxp + ix for n < nyp*nxp, the
//                padding [nyp*nxp, Npad) is written too (CG dots read it)
//   c            the interior class stencil, by value (constant bank),
//                placed by offset slot q = (dy + 1)*3 + (dx + 1) of the
//                3x3 node stencil: c[q][a*6 + b], zero where the table
//                has no such offset
//   bands        [K, 6, 6, 2, 2*nxp + 2*nyp] per-node deltas to the
//                interior class, the four bands side by side along the
//                last axis: rows 0,1 (top) and nyp-2,nyp-1 (bottom), nxp
//                long, then columns 0,1 (left) and nxp-2,nxp-1 (right),
//                nyp long; the column tables are zero on the four band
//                rows, so corner nodes are owned by the row bands; s_of[q]
//                is the table's offset index of slot q
//   a neighbour outside the grid contributes nothing
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
// read the band entries on the band nodes (O(boundary)) and, fused, w and
// b (12*Npad more). The work is 14 fmas per node and offset for a flat
// shell (98 per node at K=7): at 1024^2, 0.1 G fmas against 25-100 MB of
// vectors, so bytes bind in both types if the instruction stream stays
// near the fmas themselves.
//
// Design (as the Pallas kernel: a specialised stencil over a halo tile):
// - a 2-D grid of 32 x 16 node tiles (32-bit row and column indices from
//   blockIdx), 256 threads, two nodes of one column per thread, at most
//   64 registers so that four blocks stay resident per SM (the tiling of
//   tools/torch_class_stencil_tiling.py's best variant on an H100);
// - each block copies its x tile with a one-node halo into shared memory
//   once, with cp.async (every copy in flight at once, no registers; zero
//   fill outside the grid: a zero x adds nothing, as a skipped neighbour
//   does, up to the sign of a zero), node-major so that a node's six
//   values are three vector loads;
// - the stencil is a template: the offset slots of the shape (3x3, or
//   either 7-point triangle stencil) and the (a, b) terms (the flat-shell
//   block pattern: membrane u,v; plate w,rx,ry; drilling rz; or all 36)
//   are compile-time, so the interior loops unroll and each coefficient is
//   an immediate constant-bank operand of its fma;
// - each thread walks the kNY + 2 halo rows times three columns once,
//   applying each loaded node to every owned node it neighbours;
// - the band deltas are summed only in blocks that touch a band (a
//   block-uniform branch), one item per (band node, row a) spread over all
//   of the block's threads, so that a band block costs about one more
//   round trip to memory; the sums pass to the owning threads through the
//   tile's shared memory;
// - a last row of blocks writes the padding.
// The wrapper (ops/class_stencil.py) picks the instance from the table:
// the flat-shell instance of its shape where every mask (bit a*6+b of
// masks[s] set where (a, b, s) is accumulated) lies in the pattern, else
// the all-36 instance on the full 3x3. Multiplying a zero coefficient (or
// a zero-padded slot) adds nothing for finite x, so every instance gives
// the sums of one that skips the zeros, in the same order.
//
// Order: each node sums its interior terms and its band terms apart,
// each offset-major (slots in (dy, dx) order, the order of the table's
// offsets) then b, with explicit fma, and adds the two once at the end.
// Where a band delta is the exact negative of the interior coefficient
// (every coupling of a constrained DOF, whose class row is an identity
// row) the two partial sums are exact negatives and cancel to zero,
// which keeps the constrained DOFs exactly decoupled, as in the JAX
// package.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kSlots = 9;  // 3x3 node stencil, slot (dy + 1) * 3 + (dx + 1)
constexpr int kTX = 32;    // node columns per tile: one warp

// thread rows per block, nodes per thread along y, and the resident
// blocks per SM that the register budget must allow (launch bounds):
// 32 x 16 node tiles in both types, chosen on the card with
// tools/torch_class_stencil_tiling.py
template <typename T>
struct Tiling;
template <>
struct Tiling<float> {
  static constexpr int kTY = 8, kNY = 2, kMinBlocks = 4;
};
template <>
struct Tiling<double> {
  static constexpr int kTY = 8, kNY = 2, kMinBlocks = 4;
};

// the slots of each stencil shape: 0 = the full 3x3 (quad; any other
// offset set, with zero coefficients in its absent slots), 1 = the tri
// stencil without (-1,-1), (1,1), 2 = the tri stencil without (-1,1), (1,-1)
__host__ __device__ constexpr unsigned shape_slots(int shape) {
  return shape == 1 ? 0x0FEu : shape == 2 ? 0x1BBu : 0x1FFu;
}

// the flat-shell (a, b) pattern, bit a*6 + b: membrane (u, v) x (u, v),
// plate (w, rx, ry) x (w, rx, ry), drilling rz x rz
constexpr unsigned long long kFlatPattern =
    (1ull << 0) | (1ull << 1) | (1ull << 6) | (1ull << 7) | (1ull << 14) | (1ull << 15) |
    (1ull << 16) | (1ull << 20) | (1ull << 21) | (1ull << 22) | (1ull << 26) | (1ull << 27) |
    (1ull << 28) | (1ull << 35);

__host__ __device__ constexpr bool term(bool flat, int a, int b) {
  return !flat || ((kFlatPattern >> (a * 6 + b)) & 1ull);
}

template <typename T>
struct Params {
  T c[kSlots][36];  // interior coefficients c[slot][a*6 + b]
  int s_of[kSlots]; // the table's offset index of each slot, -1 if absent
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// the six values of one node of the shared tile (three aligned pair loads)
template <typename T>
__device__ __forceinline__ void load6(const T* v, T (&out)[6]) {
  using P = typename Pair<T>::type;
  const P* p = reinterpret_cast<const P*>(v);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const P q = p[i];
    out[2 * i] = q.x;
    out[2 * i + 1] = q.y;
  }
}

// one element global -> shared without registers (cp.async); zeros where
// `in` is false (src-size 0: nothing is read)
template <typename T>
__device__ __forceinline__ void copy_or_zero(T* dst, const T* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(in ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

// the k-th of the band lines {0, 1, n-2, n-1} (ascending, n >= 4) inside
// [lo, hi), and how many lie there
__device__ __forceinline__ int band_line(int k, int lo, int hi, int n) {
  const int c[4] = {0, 1, n - 2, n - 1};
  int out = -1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c[i] >= lo && c[i] < hi) {
      if (k == 0 && out < 0) out = c[i];
      --k;
    }
  }
  return out;
}

__device__ __forceinline__ int band_lines(int lo, int hi, int n) {
  return (lo <= 0 && 0 < hi) + (lo <= 1 && 1 < hi) + (lo <= n - 2 && n - 2 < hi) +
         (lo <= n - 1 && n - 1 < hi);
}

// row a's band sum of node (iy, ix) on band row j at position l: slots in
// (dy, dx) order, then b in [kLo, kHi), x read from global memory (the
// block has just read it: L1/L2), zero outside the grid
template <typename T, int kShape, int kLo, int kHi>
__device__ __forceinline__ T band_row(const Params<T>& p, const T* __restrict__ bands,
                                      const T* __restrict__ x, int a, int j, int l, int len,
                                      int iy, int ix, int nyp, int nxp, int64_t npad) {
  T acc = T(0);
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    if (!((shape_slots(kShape) >> slot) & 1u)) continue;
    const int s = p.s_of[slot];
    if (s < 0) continue;
    const int qy = iy + slot / 3 - 1, qx = ix + slot % 3 - 1;
    const bool in = qy >= 0 && qy < nyp && qx >= 0 && qx < nxp;
    const T* xq = x + (in ? qy * nxp + qx : 0);
    const T* bs = bands + ((static_cast<int64_t>(s) * 72 + a * 12 + j) * len + l);
#pragma unroll
    for (int b = kLo; b < kHi; ++b) {
      const T xv = in ? __ldg(xq + b * npad) : T(0);
      acc = fma(__ldg(bs + static_cast<int64_t>(b) * 2 * len), xv, acc);
    }
  }
  return acc;
}

// issue the cp.async copies of one x tile (rows y0-1 .. y0+kHY-2, columns
// x0-1 .. x0+kHX-2, zeros outside the grid) and commit them as one group
template <typename T, int kHY, int kHX, int kThreads>
__device__ __forceinline__ void load_tile(T (*sx)[kHX][6], const T* __restrict__ x, int y0,
                                          int x0, int nyp, int nxp, int64_t npad, int tid) {
  for (int i = tid; i < kHY * kHX; i += kThreads) {
    const int hr = i / kHX, hc = i - hr * kHX;
    const int iy = y0 - 1 + hr, ix = x0 - 1 + hc;
    const bool in = iy >= 0 && iy < nyp && ix >= 0 && ix < nxp;
    const T* src = x + (in ? iy * nxp + ix : 0);
#pragma unroll
    for (int b = 0; b < 6; ++b) copy_or_zero(&sx[hr][hc][b], src + b * npad, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, int kShape, bool kFlat>
__global__ void __launch_bounds__(kTX* Tiling<T>::kTY, Tiling<T>::kMinBlocks) class_stencil_kernel(
    const __grid_constant__ Params<T> p, const T* __restrict__ x, T* __restrict__ y,
    const T* __restrict__ w, const T* __restrict__ bv, const T* __restrict__ bands,
    const int nyp, const int nxp, const int64_t npad) {
  constexpr int kTY = Tiling<T>::kTY, kNY = Tiling<T>::kNY;
  constexpr int kRY = kTY * kNY;  // node rows per tile
  constexpr int kHY = kRY + 2, kHX = kTX + 2, kThreads = kTX * kTY;
  constexpr unsigned kShapeSlots = shape_slots(kShape);
  __shared__ __align__(16) T sx[kHY][kHX][6];

  const int n = nyp * nxp;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  if (blockIdx.y == gridDim.y - 1) {  // the padding [n, npad): A x = 0 there
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = n + static_cast<int64_t>(blockIdx.x) * kThreads + tid; i < npad; i += stride) {
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const int64_t k = a * npad + i;
        y[k] = w != nullptr ? w[k] * bv[k] : T(0);
      }
    }
    return;
  }
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kRY, ix = x0 + tx;
  load_tile<T, kHY, kHX, kThreads>(sx, x, y0, x0, nyp, nxp, npad, tid);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // interior: halo rows ty*kNY .. ty*kNY + kNY + 1, three columns each;
  // node r of this thread sees halo row hr at dy = hr - 1 - r
  T acc[kNY][6];
#pragma unroll
  for (int r = 0; r < kNY; ++r) {
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[r][a] = T(0);
  }
#pragma unroll
  for (int hr = 0; hr < kNY + 2; ++hr) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      T xv[6];
      load6(&sx[ty * kNY + hr][tx + q][0], xv);  // dead where no node uses it
#pragma unroll
      for (int r = 0; r < kNY; ++r) {
        const int dy = hr - 1 - r;
        if (dy < -1 || dy > 1) continue;
        const int slot = (dy + 1) * 3 + q;
        if (!((kShapeSlots >> slot) & 1u)) continue;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            if (term(kFlat, a, b)) acc[r][a] = fma(p.c[slot][a * 6 + b], xv[b], acc[r][a]);
          }
        }
      }
    }
  }

  // band deltas, in blocks that touch a band only (block-uniform): one
  // item per (band node, row a), spread over the block's threads, each
  // sum written into the tile's space (free now); row bands own corners
  if (y0 < 2 || y0 + kRY > nyp - 2 || x0 < 2 || x0 + kTX > nxp - 2) {
    T* sums = &sx[0][0][0];  // [kRY * kTX][6]
    const int hv = min(kRY, nyp - y0), wv = min(kTX, nxp - x0);
    const int nr = band_lines(y0, y0 + hv, nyp), nc = band_lines(x0, x0 + wv, nxp);
    const int nodes = nr * wv + nc * hv;
    const int len = 2 * (nxp + nyp);
    __syncthreads();
    for (int it = tid; it < 6 * nodes; it += kThreads) {
      const int a = it / nodes, m = it - a * nodes;
      int iy, jx, j, l;
      if (m < nr * wv) {  // a row band: top (rows 0, 1) or bottom
        iy = band_line(m / wv, y0, y0 + hv, nyp), jx = x0 + m % wv;
        if (iy < 2) {
          j = iy, l = jx;
        } else {
          j = iy - (nyp - 2), l = nxp + jx;
        }
      } else {  // a column band, off the band rows
        const int m2 = m - nr * wv;
        jx = band_line(m2 / hv, x0, x0 + wv, nxp), iy = y0 + m2 % hv;
        if (iy < 2 || iy >= nyp - 2) continue;
        if (jx < 2) {
          j = jx, l = 2 * nxp + iy;
        } else {
          j = jx - (nxp - 2), l = 2 * nxp + nyp + iy;
        }
      }
      T sum;
      if (!kFlat) {
        sum = band_row<T, kShape, 0, 6>(p, bands, x, a, j, l, len, iy, jx, nyp, nxp, npad);
      } else if (a < 2) {
        sum = band_row<T, kShape, 0, 2>(p, bands, x, a, j, l, len, iy, jx, nyp, nxp, npad);
      } else if (a < 5) {
        sum = band_row<T, kShape, 2, 5>(p, bands, x, a, j, l, len, iy, jx, nyp, nxp, npad);
      } else {
        sum = band_row<T, kShape, 5, 6>(p, bands, x, a, j, l, len, iy, jx, nyp, nxp, npad);
      }
      sums[((iy - y0) * kTX + (jx - x0)) * 6 + a] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kNY; ++r) {
      const int iy = y0 + ty * kNY + r;
      if (iy >= nyp || ix >= nxp || !(iy < 2 || iy >= nyp - 2 || ix < 2 || ix >= nxp - 2)) {
        continue;
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[r][a] += sums[((ty * kNY + r) * kTX + tx) * 6 + a];
    }
  }

#pragma unroll
  for (int r = 0; r < kNY; ++r) {
    const int iy = y0 + ty * kNY + r;
    if (iy >= nyp || ix >= nxp) continue;
    const int node = iy * nxp + ix;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int64_t i = a * npad + node;
      y[i] = w != nullptr ? w[i] * (bv[i] - acc[r][a]) : acc[r][a];
    }
  }
}

// instances 0-2: the flat-shell pattern on shape 0-2; 3: all 36 terms on
// the full 3x3 (any offsets and masks: absent slots have zero coefficients)
constexpr int kInstances = 4;

template <typename T, int kShape, bool kFlat>
void launch_one(const Params<T>& p, const T* x, T* y, const T* w, const T* bv, const T* bands,
                int nyp, int nxp, int64_t npad, cudaStream_t stream) {
  constexpr int kTY = Tiling<T>::kTY, kRY = kTY * Tiling<T>::kNY;
  const dim3 grid((nxp + kTX - 1) / kTX, (nyp + kRY - 1) / kRY + 1);  // + the padding row
  class_stencil_kernel<T, kShape, kFlat>
      <<<grid, dim3(kTX, kTY), 0, stream>>>(p, x, y, w, bv, bands, nyp, nxp, npad);
}

template <typename T>
int launch(const T* x, T* y, const T* w, const T* bv, const T* coef, const int* s_of,
           int instance, const T* bands, int nyp, int nxp, int64_t npad, cudaStream_t stream) {
  if (instance < 0 || instance >= kInstances || nyp < 4 || nxp < 4 ||
      static_cast<int64_t>(nyp) * nxp > INT32_MAX || npad < static_cast<int64_t>(nyp) * nxp ||
      (w == nullptr) != (bv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params<T> p;
  std::memcpy(p.c, coef, sizeof p.c);
  std::memcpy(p.s_of, s_of, sizeof p.s_of);
  switch (instance) {
    case 0: launch_one<T, 0, true>(p, x, y, w, bv, bands, nyp, nxp, npad, stream); break;
    case 1: launch_one<T, 1, true>(p, x, y, w, bv, bands, nyp, nxp, npad, stream); break;
    case 2: launch_one<T, 2, true>(p, x, y, w, bv, bands, nyp, nxp, npad, stream); break;
    default: launch_one<T, 0, false>(p, x, y, w, bv, bands, nyp, nxp, npad, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. `coef` (9*36 values, [slot][a][b]) and
// `s_of` (9) are host arrays, packed once per table by the wrapper;
// `instance` as kInstances says; every other pointer is device memory.
// `w` and `bv` are both null (y = A x) or both set (y = w * (bv - A x)).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int class_stencil_f32(const float* x, float* y, const float* w, const float* bv,
                                 const float* coef, const int* s_of, int instance,
                                 const float* bands, int nyp, int nxp, int64_t npad,
                                 void* stream) {
  return launch<float>(x, y, w, bv, coef, s_of, instance, bands, nyp, nxp, npad,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int class_stencil_f64(const double* x, double* y, const double* w, const double* bv,
                                 const double* coef, const int* s_of, int instance,
                                 const double* bands, int nyp, int nxp, int64_t npad,
                                 void* stream) {
  return launch<double>(x, y, w, bv, coef, s_of, instance, bands, nyp, nxp, npad,
                        static_cast<cudaStream_t>(stream));
}

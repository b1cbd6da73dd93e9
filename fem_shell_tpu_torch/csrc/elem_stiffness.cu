// Element stiffness of flat shell elements in f64: Tri-3 (CST membrane +
// Specht plate) and Quad-4 (bilinear membrane + DKQ plate), each with the
// stabilized drilling DOF, in global axes.
//
//   xyz [M, 3, E] f64 (node, coordinate, element), dm, dp [3, 3] f64
//   ke  [6M, 6M, E] f64, entry (i, j) of element e at (i*6M + j)*E + e
//
// Replaces the TPU kernel
//   fem_shell_tpu/ops/pallas_elem.py  kernel (elem_stiffness_pallas)
// which re-executes the traced single-element f64 stiffness as two-float32
// arithmetic inside one Pallas kernel over a tile of elements. Native f64
// takes the place of the two-float32 pair; the element math is written out
// once here, function by function as the package's ops/elements.py (same
// reference lines of fem-shell.cpp, the Specht Y[2,1] = x31*x31 quirk,
// the quadrature order (+,+), (+,-), (-,+), (-,-), the CST and Specht
// sampling points). nvcc may contract products into fma here: nothing in
// the element math is an error-free transform. No -use_fast_math: sqrt and
// division stay IEEE. No atomics: every entry is summed by one thread in a
// fixed order, so two launches are equal bit for bit.
//
// Bound: bytes. A launch must read xyz and write ke, 8*(3M + 36M^2) bytes per
// element (2664 for Tri-3, 4704 for Quad-4), against ~10-20 thousand f64
// operations per element (chip_smoke.py elem_work counts them from the
// reference math): ~4 operations per byte, under the card's f64 balance
// point of ~10. Both kernels are batch-last, so the 32 threads of a warp
// store one entry (i, j) of 32 neighbouring elements in one 256-byte
// segment, and read xyz the same way.
//
// Tri-3 (tri_stiffness_kernel): one thread per element. It keeps the
// membrane (6 x 6) and plate (9 x 9) matrices, both symmetric and stored as
// their upper triangles, and the frame R; it never holds the 18 x 18
// matrix. Per node pair (i, j) it builds the local 6x6 block from the
// membrane block, the plate block and the drilling term (the largest of the
// five membrane/plate diagonal entries of the block, over 1000), rotates it
// as the 3x3 blocks R^T L R of blockdiag(R, R)^T L blockdiag(R, R), and
// stores its 36 entries. Every loop is unrolled, so all indices are
// constants; ptxas spills a little of the working set (its report:
// chip_smoke.py phase 1).
//
// Quad-4 (quad_stiffness_kernel): eight threads per element, so that no
// thread holds more than one node pair's sums (one thread per element needs
// ~300 live doubles: it ran at the 255-register cap and spilled 2.5 KB a
// thread). A block takes 32 elements, one per lane, and 8 warps; the
// per-element work lands in a shared table behind three barriers:
//   1a. warp 0 builds the frames (R, local coordinates lx, ly), warp 1
//       copies dm and dp;
//   1b. warps 0-3 the DKQ coefficients of side w, warps 4-7 the membrane
//       dN/dx, dN/dy and weight of Gauss point w - 4;
//   1c. warp 4h + q the plate B columns of nodes 2h, 2h+1 at Gauss point q
//       (and, h = 0, its weight).
// So the frame, the side coefficients and each B column are computed once
// per element. Phase 2: each warp owns fixed 6x6 node-pair blocks of its 32
// elements. It sums their membrane (2x2) and plate (3x3) entries over the
// four Gauss points in the reference's order, each term formed as add_btdb
// forms it, then builds, rotates and stores the blocks as above:
//   warps 0-5: the pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3), 13 sums;
//     block (i, j) and, from the same registers, its transpose as block
//     (j, i) (R^T L^T R = (R^T L R)^T, the drilling term is the same): 72
//     entries;
//   warps 6, 7: the diagonal blocks (0,0), (1,1) and (2,2), (3,3), one after
//     the other, 9 sums each (the upper triangles), each block's 21
//     distinct entries stored as its 36: 72 entries.
// So every thread stores 72 entries, and ke is exactly symmetric. The table
// (221 rows of 32 doubles and D, 56,720 bytes) and ptxas's 128 registers
// (kQuadMinBlocks = 2, no spills) let an SM hold 2 blocks, 16 warps; at 3
// blocks (80 registers) ptxas spills and the kernel is slower
// (tools/torch_elem_stiffness_variants.py measures both).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 2x2 Gauss points at +-sqrt(1/3): the f64 value of math.sqrt(1.0 / 3.0)
constexpr double kGaussRoot = 0.5773502691896257;

// Gauss point q of the reference's order (+,+), (+,-), (-,+), (-,-)
__device__ __forceinline__ double quad_qp_r(const int q) { return (q < 2 ? 1.0 : -1.0) * kGaussRoot; }
__device__ __forceinline__ double quad_qp_s(const int q) { return (q % 2 == 0 ? 1.0 : -1.0) * kGaussRoot; }
// Specht plate interior points (1/6, 1/6), (2/3, 1/6), (1/6, 2/3), weight
// 1/6 (fem-shell.cpp:557-562)
__device__ __forceinline__ double tri_qp_l1(const int q) { return q == 1 ? 2.0 / 3.0 : 1.0 / 6.0; }
__device__ __forceinline__ double tri_qp_l2(const int q) { return q == 2 ? 2.0 / 3.0 : 1.0 / 6.0; }

// Upper triangle of a symmetric N x N matrix, row by row.
template <int N>
struct Sym {
  double v[N * (N + 1) / 2] = {};
  __device__ __forceinline__ static constexpr int idx(int p, int q) {
    return p <= q ? p * (2 * N - p + 1) / 2 + (q - p) : q * (2 * N - q + 1) / 2 + (p - q);
  }
  __device__ __forceinline__ double& at(int p, int q) { return v[idx(p, q)]; }
  __device__ __forceinline__ double get(int p, int q) const { return v[idx(p, q)]; }
};

// K += w * B^T D B, upper triangle only; B is 3 x N, D is 3 x 3 row-major.
template <int N>
__device__ __forceinline__ void add_btdb(Sym<N>& k, const double (&b)[3][N], const double (&d)[9],
                                         const double w) {
  double db[3][N];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < N; ++q) db[r][q] = d[r * 3] * b[0][q] + d[r * 3 + 1] * b[1][q] + d[r * 3 + 2] * b[2][q];
  }
#pragma unroll
  for (int p = 0; p < N; ++p) {
#pragma unroll
    for (int q = p; q < N; ++q) {
      const double s = b[0][p] * db[0][q] + b[1][p] * db[1][q] + b[2][p] * db[2][q];
      k.at(p, q) += w * s;
    }
  }
}

__device__ __forceinline__ void cross(const double (&u)[3], const double (&v)[3], double (&w)[3]) {
  w[0] = u[1] * v[2] - u[2] * v[1];
  w[1] = u[2] * v[0] - u[0] * v[2];
  w[2] = u[0] * v[1] - u[1] * v[0];
}

__device__ __forceinline__ double norm3(const double (&v)[3]) {
  return sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ __forceinline__ double dot3(const double (&u)[3], const double (&v)[3]) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

// ---------------------------------------------------------------------------
// Tri-3: frame (fem-shell.cpp:403-411), CST membrane (445-468), Specht plate
// (555-603, 698-891)
// ---------------------------------------------------------------------------

// Local frame R (rows are the local axes), edge differences
// d = ((x12, y12), (x31, y31), (x23, y23)) and the area.
__device__ __forceinline__ void tri_frame(const double (&x)[3][3], double (&rot)[3][3],
                                          double (&d)[3][2], double& area) {
  double u[3], v[3], w[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u[c] = x[1][c] - x[0][c];
    v[c] = x[2][c] - x[0][c];
  }
  cross(u, v, w);
  const double nw = norm3(w);
  area = 0.5 * nw;
  const double nu = norm3(u);
  double ex[3], ey[3], ez[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ex[c] = u[c] / nu;
    ez[c] = w[c] / nw;
  }
  cross(ez, ex, ey);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rot[0][c] = ex[c];
    rot[1][c] = ey[c];
    rot[2][c] = ez[c];
  }
  const double lb0 = dot3(ex, u), lb1 = dot3(ey, u);
  const double lc0 = dot3(ex, v), lc1 = dot3(ey, v);
  d[0][0] = -lb0;
  d[0][1] = -lb1;
  d[1][0] = lc0;
  d[1][1] = lc1;
  d[2][0] = lb0 - lc0;
  d[2][1] = lb1 - lc1;
}

__device__ __forceinline__ void tri_membrane(const double (&d)[3][2], const double area,
                                             const double (&dm)[9], const double t, Sym<6>& km) {
  const double x12 = d[0][0], y12 = d[0][1];
  const double x31 = d[1][0], y31 = d[1][1];
  const double x23 = d[2][0], y23 = d[2][1];
  const double a2 = 2.0 * area;
  const double b[3][6] = {
      {y23 / a2, 0.0, y31 / a2, 0.0, y12 / a2, 0.0},
      {0.0, -x23 / a2, 0.0, -x31 / a2, 0.0, -x12 / a2},
      {-x23 / a2, y23 / a2, -x31 / a2, y31 / a2, -x12 / a2, y12 / a2},
  };
  add_btdb<6>(km, b, dm, t * area);
}

// Second-derivative strain matrix of the 9-dof Specht triangle at area
// coordinates (l1, l2); fem-shell.cpp:698-891.
__device__ __forceinline__ void eval_b_tri(const double (&ss)[3], const double l1, const double l2,
                                           const double (&d)[3][2], double (&b)[3][9]) {
  const double mu1 = (ss[0] - ss[1]) / ss[2];
  const double mu2 = (ss[2] - ss[0]) / ss[1];
  const double mu3 = (ss[1] - ss[2]) / ss[0];

  const double l3 = 1.0 - l1 - l2;
  const double f13mu1 = 1 + 3 * mu1;
  const double f13mu2 = 1 + 3 * mu2;
  const double f13mu3 = 1 + 3 * mu3;
  const double f1m3mu3 = 1 - 3 * mu3;
  const double fm13mu2 = -1 + 3 * mu2;
  const double fm1m3mu3 = -1 - 3 * mu3;
  const double f1mmu1 = 1 - mu1;
  const double f1mmu2 = 1 - mu2;
  const double f1mmu3 = 1 - mu3;

  const double a = 3 * f1mmu3 * l1 - f13mu3 * l2 + f13mu3 * l3;
  const double bb = 3 * f1mmu2 * l3 - f13mu2 * l1 + f13mu2 * l2;
  const double c = 3 * f1mmu1 * l2 - f13mu1 * l3 + f13mu1 * l1;

  const double d00 = d[0][0], d01 = d[0][1];  // x12, y12
  const double d10 = d[1][0], d11 = d[1][1];  // x31, y31
  const double d20 = d[2][0], d21 = d[2][1];  // x23, y23

  // row 0: d2/dL1^2 terms
  b[0][0] = 6 + l2 * (-4 - 2 * a) + 4 * f1m3mu3 * (l2 * l3 - l1 * l2) - 12 * l1 + 2 * l2 * bb +
            8 * (l2 * l3 - l1 * l2);
  const double t_b = -2 + 6 * l1 + 4 * l2 - l2 * bb - 4 * l2 * l3 + 4 * l1 * l2;
  const double t_a = 2 * l2 - l2 * a + l2 * l3 * 2 * f1m3mu3 - l1 * l2 * 2 * f1m3mu3;
  b[0][1] = -d11 * t_b - d01 * t_a;
  b[0][2] = d10 * t_b + d00 * t_a;
  b[0][3] = -2 * l2 * c + 4 * f13mu1 * (l2 * l3 - l1 * l2) - 4 * l2 + 2 * l2 * a +
            4 * f1m3mu3 * (-l2 * l3 + l1 * l2);
  const double t_c = -l2 * c + l2 * l3 * 2 * f13mu1 - l1 * l2 * 2 * f13mu1;
  b[0][4] = -d01 * t_a - d21 * t_c;
  b[0][5] = d00 * t_a + d20 * t_c;
  b[0][6] = -6 + 12 * l1 + 8 * l2 - 2 * l2 * bb + 8 * (l1 * l2 - l2 * l3) + 2 * l2 * c +
            4 * f13mu1 * (l1 * l2 - l2 * l3);
  const double t_b4 = -4 + 6 * l1 + 4 * l2 - l2 * bb - 4 * l2 * l3 + 4 * l1 * l2;
  b[0][7] = -d21 * t_c - d11 * t_b4;
  b[0][8] = d20 * t_c + d10 * t_b4;

  // row 1: d2/dL2^2 terms
  b[1][0] = -2 * l1 * a + 2 * l1 * l3 * 2 * fm1m3mu3 - 2 * l1 * l2 * 2 * fm1m3mu3 - 4 * l1 +
            2 * l1 * bb - 2 * l1 * l3 * 2 * fm13mu2 + 2 * l1 * l2 * 2 * fm13mu2;
  const double s_b = 2 * l1 - l1 * bb + l1 * l3 * 2 * fm13mu2 - l1 * l2 * 2 * fm13mu2;
  const double s_a = -l1 * a + l1 * l3 * 2 * fm1m3mu3 - l1 * l2 * 2 * fm1m3mu3;
  b[1][1] = -d11 * s_b - d01 * s_a;
  b[1][2] = d10 * s_b + d00 * s_a;
  b[1][3] = 6 - 12 * l2 - 4 * l1 - 2 * l1 * c + 8 * l3 * l1 - 8 * l1 * l2 + 2 * l1 * a -
            2 * l1 * l3 * 2 * fm1m3mu3 + 2 * l1 * l2 * 2 * fm1m3mu3;
  const double s_c2 = -6 * l2 + 2 - 2 * l1 - l1 * c + 4 * l3 * l1 - 4 * l1 * l2;
  b[1][4] = -d01 * s_a - d21 * s_c2;
  b[1][5] = d00 * s_a + d20 * s_c2;
  b[1][6] = -6 + 8 * l1 - 2 * l1 * bb + 2 * l1 * l3 * 2 * fm13mu2 - 2 * l1 * l2 * 2 * fm13mu2 +
            12 * l2 + 2 * l1 * c - 8 * l3 * l1 + 8 * l1 * l2;
  const double s_c4 = -6 * l2 + 4 - 2 * l1 - l1 * c + 4 * l3 * l1 - 4 * l1 * l2;
  b[1][7] = -d21 * s_c4 - d11 * s_b;
  b[1][8] = d20 * s_c4 + d10 * s_b;

  // row 2: mixed d2/dL1dL2 terms, doubled at the end (fem-shell.cpp:888-890)
  const double r2c0 = 2 - 4 * l1 + l3 * a - l2 * a + l2 * l3 * 2 * fm1m3mu3 - l1 * a -
                      l1 * l2 * 2 * fm1m3mu3 + l1 * l3 * 2 * f1m3mu3 - l1 * l2 * 2 * f1m3mu3 -
                      4 * l2 - l3 * bb + l2 * bb - l2 * l3 * 2 * fm13mu2 + l1 * bb +
                      l1 * l2 * 2 * fm13mu2 + 4 * l3 * l1 - 4 * l1 * l2;
  const double m_b = -1 + 4 * l1 + 2 * l2 + 0.5 * l3 * bb - 0.5 * l2 * bb +
                     0.5 * l2 * l3 * 2 * fm13mu2 - 0.5 * l1 * bb - 0.5 * l1 * l2 * 2 * fm13mu2 -
                     2 * l3 * l1 + 2 * l1 * l2;
  const double m_a = 2 * l1 + 0.5 * l3 * a - 0.5 * l2 * a + 0.5 * l2 * l3 * 2 * fm1m3mu3 -
                     0.5 * l1 * a - 0.5 * l1 * l2 * 2 * fm1m3mu3 + 0.5 * l1 * l3 * 2 * f1m3mu3 -
                     0.5 * l1 * l2 * 2 * f1m3mu3;
  const double r2c1 = -d11 * m_b - d01 * m_a;
  const double r2c2 = d10 * m_b + d00 * m_a;
  const double r2c3 = 2 - 4 * l2 + l3 * c - l2 * c + 4 * l2 * l3 - l1 * c - 4 * l1 * l2 +
                      l1 * l3 * 2 * f13mu1 - l1 * l2 * 2 * f13mu1 - 4 * l1 - l3 * a + l2 * a +
                      l1 * a - l2 * l3 * 2 * fm1m3mu3 + l1 * l2 * 2 * fm1m3mu3 -
                      l1 * l3 * 2 * f1m3mu3 + l1 * l2 * 2 * f1m3mu3;
  const double m_c = -2 * l2 + 0.5 * l3 * c - 0.5 * l2 * c + 2 * l2 * l3 - 0.5 * l1 * c -
                     2 * l1 * l2 + 0.5 * l1 * l3 * 2 * f13mu1 - 0.5 * l1 * l2 * 2 * f13mu1;
  const double r2c4 = -d01 * (m_a - 1) - d21 * m_c;
  const double r2c5 = d00 * (m_a - 1) + d20 * m_c;
  const double r2c6 = -4 + 8 * l1 + 8 * l2 + l3 * bb - l2 * bb + l2 * l3 * 2 * fm13mu2 - l1 * bb -
                      l1 * l2 * 2 * fm13mu2 - 4 * l3 * l1 + 8 * l1 * l2 - l3 * c + l2 * c -
                      4 * l2 * l3 + l1 * c - l1 * l3 * 2 * f13mu1 + l1 * l2 * 2 * f13mu1;
  const double m_b2 = -2 + 4 * l1 + 2 * l2 + 0.5 * l3 * bb - 0.5 * l2 * bb +
                      0.5 * l2 * l3 * 2 * fm13mu2 - 0.5 * l1 * bb - 0.5 * l1 * l2 * 2 * fm13mu2 -
                      2 * l3 * l1 + 2 * l1 * l2;
  const double r2c7 = -d21 * (m_c + 1) - d11 * m_b2;
  const double r2c8 = d20 * (m_c + 1) + d10 * m_b2;
  b[2][0] = 2.0 * r2c0;
  b[2][1] = 2.0 * r2c1;
  b[2][2] = 2.0 * r2c2;
  b[2][3] = 2.0 * r2c3;
  b[2][4] = 2.0 * r2c4;
  b[2][5] = 2.0 * r2c5;
  b[2][6] = 2.0 * r2c6;
  b[2][7] = 2.0 * r2c7;
  b[2][8] = 2.0 * r2c8;
}

__device__ __forceinline__ void tri_plate(const double (&d)[3][2], const double area,
                                          const double (&dp)[9], Sym<9>& kp) {
  double ss[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ss[k] = d[k][0] * d[k][0] + d[k][1] * d[k][1];  // AB, AC, BC
  const double x31 = d[1][0], y31 = d[1][1];
  const double x23 = d[2][0], y23 = d[2][1];
  // auxiliary matrix from area-coordinate second derivatives to curvatures;
  // Y[2][1] is -2*x31*x31, as the reference has it (fem-shell.cpp:586)
  const double s = 4.0 * (area * area);
  const double y[3][3] = {
      {(y23 * y23) / s, (y31 * y31) / s, (y23 * y31) / s},
      {(x23 * x23) / s, (x31 * x31) / s, (x31 * x23) / s},
      {(-2.0 * x23 * y23) / s, (-2.0 * x31 * x31) / s, (-x23 * y31 - x31 * y23) / s},
  };
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    double bq[3][9], yb[3][9];
    eval_b_tri(ss, tri_qp_l1(q), tri_qp_l2(q), d, bq);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 9; ++c) yb[r][c] = y[r][0] * bq[0][c] + y[r][1] * bq[1][c] + y[r][2] * bq[2][c];
    }
    add_btdb<9>(kp, yb, dp, 1.0 / 6.0);
  }
  const double a2 = 2.0 * area;
#pragma unroll
  for (int i = 0; i < 45; ++i) kp.v[i] = a2 * kp.v[i];
}

// ---------------------------------------------------------------------------
// Quad-4: frame (fem-shell.cpp:342-432), bilinear membrane (469-541), DKQ
// plate (604-688, 901-990)
// ---------------------------------------------------------------------------

// Local frame R and local in-plane node coordinates (lx, ly).
__device__ __forceinline__ void quad_frame(const double (&x)[4][3], double (&rot)[3][3],
                                           double (&lx)[4], double (&ly)[4]) {
  double ex[3], vr[3], ez[3], ey[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const double mid_ab = x[0][c] + 0.5 * (x[1][c] - x[0][c]);
    const double mid_bc = x[1][c] + 0.5 * (x[2][c] - x[1][c]);
    const double mid_cd = x[2][c] + 0.5 * (x[3][c] - x[2][c]);
    const double mid_da = x[3][c] + 0.5 * (x[0][c] - x[3][c]);
    ex[c] = mid_bc - mid_da;
    vr[c] = mid_cd - mid_ab;
  }
  const double nx = norm3(ex);
#pragma unroll
  for (int c = 0; c < 3; ++c) ex[c] = ex[c] / nx;
  cross(ex, vr, ez);
  const double nz = norm3(ez);
#pragma unroll
  for (int c = 0; c < 3; ++c) ez[c] = ez[c] / nz;
  cross(ez, ex, ey);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rot[0][c] = ex[c];
    rot[1][c] = ey[c];
    rot[2][c] = ez[c];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lx[i] = dot3(ex, x[i]);
    ly[i] = dot3(ey, x[i]);
  }
}

// Derivatives N_xi, N_eta of the 8-node serendipity shape functions at
// (xi, eta), corners then mid-side nodes 5-8; fem-shell.cpp:901-990.
__device__ __forceinline__ void dkq_shape_derivatives(const double xi, const double eta,
                                                      double (&n_xi)[8], double (&n_eta)[8]) {
  n_xi[0] = 0.25 * (2 * xi + eta) * (1 - eta);
  n_xi[1] = 0.25 * (2 * xi - eta) * (1 - eta);
  n_xi[2] = 0.25 * (2 * xi + eta) * (1 + eta);
  n_xi[3] = 0.25 * (2 * xi - eta) * (1 + eta);
  n_xi[4] = -xi * (1 - eta);
  n_xi[5] = 0.5 * (1 - eta * eta);
  n_xi[6] = -xi * (1 + eta);
  n_xi[7] = -0.5 * (1 - eta * eta);
  n_eta[0] = 0.25 * (2 * eta + xi) * (1 - xi);
  n_eta[1] = 0.25 * (2 * eta - xi) * (1 + xi);
  n_eta[2] = 0.25 * (2 * eta + xi) * (1 + xi);
  n_eta[3] = 0.25 * (2 * eta - xi) * (1 - xi);
  n_eta[4] = -0.5 * (1 - xi * xi);
  n_eta[5] = -eta * (1 + xi);
  n_eta[6] = 0.5 * (1 - xi * xi);
  n_eta[7] = -eta * (1 - xi);
}

// The three entries of Hx and of Hy of corner node i for one derivative
// direction (n = N_xi or N_eta).
__device__ __forceinline__ void h_node(const double (&h)[5][4], const double (&n)[8], const int i,
                                       double (&hx)[3], double (&hy)[3]) {
  const int m = 4 + i;            // mid-side node on side i
  const int p = 4 + (i + 3) % 4;  // the preceding mid-side node
  const int im = i, ip = (i + 3) % 4;
  hx[0] = 1.5 * (h[0][im] * n[m] - h[0][ip] * n[p]);
  hx[1] = h[1][im] * n[m] + h[1][ip] * n[p];
  hx[2] = n[i] - h[2][im] * n[m] - h[2][ip] * n[p];
  hy[0] = 1.5 * (h[3][im] * n[m] - h[3][ip] * n[p]);
  hy[1] = -n[i] + h[4][im] * n[m] + h[4][ip] * n[p];
  hy[2] = -(h[1][im] * n[m] + h[1][ip] * n[p]);
}

// Columns 3i..3i+2 of the DKQ strain matrix B (b[row][k] = B[row][3i+k]);
// fem-shell.cpp:901-990.
__device__ __forceinline__ void dkq_b_node(const double (&h)[5][4], const double (&n_xi)[8],
                                           const double (&n_eta)[8], const double (&jinv)[2][2],
                                           const int i, double (&b)[3][3]) {
  double hx_xi[3], hy_xi[3], hx_eta[3], hy_eta[3];
  h_node(h, n_xi, i, hx_xi, hy_xi);
  h_node(h, n_eta, i, hx_eta, hy_eta);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[0][k] = jinv[0][0] * hx_xi[k] + jinv[0][1] * hx_eta[k];
    b[1][k] = jinv[1][0] * hy_xi[k] + jinv[1][1] * hy_eta[k];
    b[2][k] = jinv[0][0] * hy_xi[k] + jinv[0][1] * hy_eta[k] + jinv[1][0] * hx_xi[k] +
              jinv[1][1] * hx_eta[k];
  }
}

// ---------------------------------------------------------------------------
// Superposition, drilling DOF (fem-shell.cpp:999-1053) and the congruence
// with blockdiag(R, R) (1061-1102), one 6x6 node-pair block at a time
// ---------------------------------------------------------------------------

__device__ __forceinline__ double max2(const double a, const double b) { return a > b ? a : b; }

// out = R^T A R for 3x3 A (R rows are the local axes).
__device__ __forceinline__ void rotate3(const double (&a)[3][3], const double (&rot)[3][3],
                                        double (&out)[3][3]) {
  double ar[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int b = 0; b < 3; ++b) ar[c][b] = a[c][0] * rot[0][b] + a[c][1] * rot[1][b] + a[c][2] * rot[2][b];
  }
#pragma unroll
  for (int a_ = 0; a_ < 3; ++a_) {
#pragma unroll
    for (int b = 0; b < 3; ++b) out[a_][b] = rot[0][a_] * ar[0][b] + rot[1][a_] * ar[1][b] + rot[2][a_] * ar[2][b];
  }
}

// Store R^T A R as rows row0.., columns col0.. of element e's matrix.
template <int kDof>
__device__ __forceinline__ void store_rotated(const double (&a)[3][3], const double (&rot)[3][3],
                                              double* __restrict__ ke, const int row0,
                                              const int col0, const int64_t e, const int64_t ne) {
  double g[3][3];
  rotate3(a, rot, g);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ke[(static_cast<int64_t>(row0 + r) * kDof + col0 + c) * ne + e] = g[r][c];
  }
}

template <int M>
__device__ __forceinline__ void store_blocks(const Sym<2 * M>& km, const Sym<3 * M>& kp,
                                             const double (&rot)[3][3], double* __restrict__ ke,
                                             const int64_t e, const int64_t ne) {
  constexpr int kDof = 6 * M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const double muu = km.get(2 * i, 2 * j), muv = km.get(2 * i, 2 * j + 1);
      const double mvu = km.get(2 * i + 1, 2 * j), mvv = km.get(2 * i + 1, 2 * j + 1);
      double p[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) p[a][b] = kp.get(3 * i + a, 3 * j + b);
      }
      const double drill =
          max2(max2(max2(max2(muu, mvv), p[0][0]), p[1][1]), p[2][2]) / 1000.0;
      // local block L = [[L11, L12], [L21, L22]] over (u, v, w | tx, ty, tz)
      const double l11[3][3] = {{muu, muv, 0.0}, {mvu, mvv, 0.0}, {0.0, 0.0, p[0][0]}};
      const double l12[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {p[0][1], p[0][2], 0.0}};
      const double l21[3][3] = {{0.0, 0.0, p[1][0]}, {0.0, 0.0, p[2][0]}, {0.0, 0.0, 0.0}};
      const double l22[3][3] = {{p[1][1], p[1][2], 0.0}, {p[2][1], p[2][2], 0.0}, {0.0, 0.0, drill}};
      store_rotated<kDof>(l11, rot, ke, i * 6, j * 6, e, ne);
      store_rotated<kDof>(l12, rot, ke, i * 6, j * 6 + 3, e, ne);
      store_rotated<kDof>(l21, rot, ke, i * 6 + 3, j * 6, e, ne);
      store_rotated<kDof>(l22, rot, ke, i * 6 + 3, j * 6 + 3, e, ne);
    }
  }
}


__global__ void __launch_bounds__(128) tri_stiffness_kernel(
    const double* __restrict__ xyz, const double* __restrict__ dmat,
    const double* __restrict__ dpmat, const double t, const int64_t ne, double* __restrict__ ke) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= ne) return;
  double x[3][3], dm[9], dp[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) x[i][c] = __ldg(xyz + (i * 3 + c) * ne + e);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    dm[k] = __ldg(dmat + k);
    dp[k] = __ldg(dpmat + k);
  }
  double rot[3][3];
  Sym<6> km;
  Sym<9> kp;
  double d[3][2], area;
  tri_frame(x, rot, d, area);
  tri_membrane(d, area, dm, t, km);
  tri_plate(d, area, dp, kp);
  store_blocks<3>(km, kp, rot, ke, e, ne);
}

// ---------------------------------------------------------------------------
// Quad-4, eight threads per element
// ---------------------------------------------------------------------------

constexpr int kQuadLanes = 32;     // elements per block, one per lane
constexpr int kQuadWarps = 8;      // threads per element
constexpr int kQuadMinBlocks = 2;  // resident blocks per SM: the register cap
// Shared table, one row of kQuadLanes doubles (one per lane) per entry: R
// (9 rows), the local coordinates lx, ly (4 + 4), the DKQ coefficients
// h[c][side] (20), then per Gauss point q at row kRowGauss + q *
// kRowsPerGauss: the plate B [3][12] row-major, the plate weight det, dN/dx
// and dN/dy of nodes 0-3, and the membrane weight det * t. After the table,
// dm and dp (18 doubles, one copy for the block).
constexpr int kRowLx = 9, kRowLy = 13, kRowH = 17;
constexpr int kRowGauss = 37;
constexpr int kRowsPerGauss = 46;
constexpr int kOffPlateW = 36, kOffDx = 37, kOffDy = 41, kOffMembraneW = 45;
constexpr int kQuadTable = (kRowGauss + 4 * kRowsPerGauss) * kQuadLanes;
constexpr int kQuadSmemBytes = (kQuadTable + 18) * 8;

__device__ __forceinline__ double& row(double* table, const int k) { return table[k * kQuadLanes]; }
__device__ __forceinline__ double row(const double* table, const int k) { return table[k * kQuadLanes]; }

// Edge differences ((x12, y12), (x23, y23), (x34, y34), (x41, y41)) from the
// table's local coordinates.
__device__ __forceinline__ void table_edges(const double* table, double (&d)[4][2]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k][0] = row(table, kRowLx + k) - row(table, kRowLx + (k + 1) % 4);
    d[k][1] = row(table, kRowLy + k) - row(table, kRowLy + (k + 1) % 4);
  }
}

// Phase 1b, warps 0-3: the DKQ coefficients a, b, c, d, e of side k (sides
// 5-8 in Batoz numbering), h[c][k]; fem-shell.cpp:604-688.
__device__ __forceinline__ void quad_side_table(double* table, const int k) {
  const int k1 = (k + 1) % 4;
  const double dx = row(table, kRowLx + k) - row(table, kRowLx + k1);
  const double dy = row(table, kRowLy + k) - row(table, kRowLy + k1);
  const double ss = dx * dx + dy * dy;  // squared side length
  row(table, kRowH + k) = -dx / ss;
  row(table, kRowH + 4 + k) = 0.75 * dx * dy / ss;
  row(table, kRowH + 8 + k) = (0.25 * (dx * dx) - 0.5 * (dy * dy)) / ss;
  row(table, kRowH + 12 + k) = -dy / ss;
  row(table, kRowH + 16 + k) = (0.25 * (dy * dy) - 0.5 * (dx * dx)) / ss;
}

// Phase 1b, warps 4-7: dN/dx, dN/dy of the four nodes and the weight det *
// t of Gauss point q; the Jacobian from the local coordinates,
// fem-shell.cpp:469-541.
__device__ __forceinline__ void quad_membrane_table(double* table, const int q, const double t) {
  const double r = quad_qp_r(q);
  const double s = quad_qp_s(q);
  double* const g = table + (kRowGauss + q * kRowsPerGauss) * kQuadLanes;
  // bilinear shape-function derivatives in (r, s); fem-shell.cpp:494-502
  const double dhdr[4] = {-0.25 * (1 - s), 0.25 * (1 - s), 0.25 * (1 + s), -0.25 * (1 + s)};
  const double dhds[4] = {-0.25 * (1 - r), -0.25 * (1 + r), 0.25 * (1 + r), 0.25 * (1 - r)};
  double j00 = 0.0, j01 = 0.0, j10 = 0.0, j11 = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double lx = row(table, kRowLx + i), ly = row(table, kRowLy + i);
    j00 += lx * dhdr[i];
    j01 += ly * dhdr[i];
    j10 += lx * dhds[i];
    j11 += ly * dhds[i];
  }
  const double det = j00 * j11 - j01 * j10;
  const double q00 = j11 / det, q01 = -j01 / det;
  const double q12 = -j10 / det, q13 = j00 / det;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row(g, kOffDx + i) = q00 * dhdr[i] + q01 * dhds[i];
    row(g, kOffDy + i) = q12 * dhdr[i] + q13 * dhds[i];
  }
  row(g, kOffMembraneW) = det * t;
}

// Phase 1c, warp 4H + q: plate B columns 6H..6H+5 (nodes 2H, 2H+1) of Gauss
// point q and, for H = 0, its weight det; the Jacobian from the edge
// differences, fem-shell.cpp:604-688.
template <int H>
__device__ __forceinline__ void quad_plate_table(double* table, const int q) {
  const double r = quad_qp_r(q);
  const double s = quad_qp_s(q);
  double* const g = table + (kRowGauss + q * kRowsPerGauss) * kQuadLanes;
  double d[4][2], h[5][4];
  table_edges(table, d);
#pragma unroll
  for (int c = 0; c < 5; ++c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) h[c][k] = row(table, kRowH + 4 * c + k);  // the unused side is dropped
  }
  const double j00 = 0.25 * ((d[0][0] + d[2][0]) * s - d[0][0] + d[2][0]);
  const double j01 = 0.25 * ((d[0][1] + d[2][1]) * s - d[0][1] + d[2][1]);
  const double j10 = 0.25 * ((d[0][0] + d[2][0]) * r - d[1][0] + d[3][0]);
  const double j11 = 0.25 * ((d[0][1] + d[2][1]) * r - d[1][1] + d[3][1]);
  const double det = j00 * j11 - j01 * j10;
  const double jinv[2][2] = {{j11 / det, -j01 / det}, {-j10 / det, j00 / det}};
  double n_xi[8], n_eta[8];
  dkq_shape_derivatives(r, s, n_xi, n_eta);
#pragma unroll
  for (int i = 2 * H; i < 2 * H + 2; ++i) {
    double b[3][3];
    dkq_b_node(h, n_xi, n_eta, jinv, i, b);
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) row(g, rr * 12 + 3 * i + k) = b[rr][k];
    }
  }
  if (H == 0) row(g, kOffPlateW) = det;
}

// Plate column c of B at a Gauss point (row 0 at g).
__device__ __forceinline__ void plate_column(const double* __restrict__ g, const int c, double (&b)[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) b[r] = row(g, r * 12 + c);
}

// Membrane columns 2i and 2i+1 of B at a Gauss point: (dN/dx, 0, dN/dy)
// and (0, dN/dy, dN/dx) of node i.
__device__ __forceinline__ void membrane_columns(const double* __restrict__ g, const int i,
                                                 double (&b)[2][3]) {
  const double dx = row(g, kOffDx + i), dy = row(g, kOffDy + i);
  b[0][0] = dx;
  b[0][1] = 0.0;
  b[0][2] = dy;
  b[1][0] = 0.0;
  b[1][1] = dy;
  b[1][2] = dx;
}

// D b for N columns b of B, D [3, 3] row-major in shared memory. The reads
// are volatile, so D is read where it is used and never held in registers
// across the Gauss points (it would take 36 of them).
template <int N>
__device__ __forceinline__ void d_times(const volatile double* dsh, const double (&b)[N][3],
                                        double (&db)[N][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const double d0 = dsh[r * 3], d1 = dsh[r * 3 + 1], d2 = dsh[r * 3 + 2];
#pragma unroll
    for (int c = 0; c < N; ++c) db[c][r] = d0 * b[c][0] + d1 * b[c][1] + d2 * b[c][2];
  }
}

// Sums of node pair (i, j) over the Gauss points in the reference's order,
// each term w * b_p . (D b_q) as add_btdb forms it: membrane mm[a][b] =
// K(2i+a, 2j+b), plate pp[a][b] = K(3i+a, 3j+b). For i = j only the upper
// triangles (a <= b) are summed. dsh holds dm, then dp.
template <bool kDiagonal>
__device__ __forceinline__ void quad_pair_sums(const double* __restrict__ table, const int i,
                                               const int j, const volatile double* dsh,
                                               double (&mm)[2][2], double (&pp)[3][3]) {
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const double* g = table + (kRowGauss + q * kRowsPerGauss) * kQuadLanes;
    double bi[3][3], bj[3][3], dbj[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      plate_column(g, 3 * j + c, bj[c]);
      plate_column(g, 3 * i + c, bi[c]);
    }
    d_times<3>(dsh + 9, bj, dbj);
    const double wp = row(g, kOffPlateW);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = kDiagonal ? a : 0; b < 3; ++b) pp[a][b] += wp * dot3(bi[a], dbj[b]);
    }
    double mi[2][3], mj[2][3], dmj[2][3];
    membrane_columns(g, i, mi);
    membrane_columns(g, j, mj);
    d_times<2>(dsh, mj, dmj);
    const double wm = row(g, kOffMembraneW);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = kDiagonal ? a : 0; b < 2; ++b) mm[a][b] += wm * dot3(mi[a], dmj[b]);
    }
  }
}

// The local 6x6 block L of a node pair over (u, v, w | tx, ty, tz), as
// store_blocks builds it, from its membrane and plate entries and the
// drilling term.
__device__ __forceinline__ void local_block(const double (&mm)[2][2], const double (&p)[3][3],
                                            double (&l11)[3][3], double (&l12)[3][3],
                                            double (&l21)[3][3], double (&l22)[3][3]) {
  const double drill = max2(max2(max2(max2(mm[0][0], mm[1][1]), p[0][0]), p[1][1]), p[2][2]) / 1000.0;
  const double a11[3][3] = {{mm[0][0], mm[0][1], 0.0}, {mm[1][0], mm[1][1], 0.0}, {0.0, 0.0, p[0][0]}};
  const double a12[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {p[0][1], p[0][2], 0.0}};
  const double a21[3][3] = {{0.0, 0.0, p[1][0]}, {0.0, 0.0, p[2][0]}, {0.0, 0.0, 0.0}};
  const double a22[3][3] = {{p[1][1], p[1][2], 0.0}, {p[2][1], p[2][2], 0.0}, {0.0, 0.0, drill}};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      l11[r][c] = a11[r][c];
      l12[r][c] = a12[r][c];
      l21[r][c] = a21[r][c];
      l22[r][c] = a22[r][c];
    }
  }
}

__device__ __forceinline__ int64_t quad_index(const int row, const int col, const int64_t e,
                                              const int64_t ne) {
  return (static_cast<int64_t>(row) * 24 + col) * ne + e;
}

// Store G = R^T A R at rows row0.., columns col0.. of element e's matrix
// and G^T at rows col0.., columns row0...
__device__ __forceinline__ void store_rotated_and_transpose(const double (&a)[3][3],
                                                            const double (&rot)[3][3],
                                                            double* __restrict__ ke, const int row0,
                                                            const int col0, const int64_t e,
                                                            const int64_t ne) {
  double g[3][3];
  rotate3(a, rot, g);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ke[quad_index(row0 + r, col0 + c, e, ne)] = g[r][c];
      ke[quad_index(col0 + c, row0 + r, e, ne)] = g[r][c];
    }
  }
}

// Store R^T A R of a symmetric A at rows and columns row0.. from its upper
// triangle, so that the stored block is exactly symmetric.
__device__ __forceinline__ void store_rotated_symmetric(const double (&a)[3][3],
                                                        const double (&rot)[3][3],
                                                        double* __restrict__ ke, const int row0,
                                                        const int64_t e, const int64_t ne) {
  double g[3][3];
  rotate3(a, rot, g);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ke[quad_index(row0 + r, row0 + c, e, ne)] = r <= c ? g[r][c] : g[c][r];
  }
}

__global__ void __launch_bounds__(kQuadLanes * kQuadWarps, kQuadMinBlocks) quad_stiffness_kernel(
    const double* __restrict__ xyz, const double* __restrict__ dmat,
    const double* __restrict__ dpmat, const double t, const int64_t ne, double* __restrict__ ke) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x % kQuadLanes;
  const int warp = threadIdx.x / kQuadLanes;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kQuadLanes + lane;
  double* const table = smem + lane;  // row k of this lane's element at table[k * kQuadLanes]
  double* const dsh = smem + kQuadTable;
  // phase 1a: warp 0 builds the frames, warp 1 copies D
  if (warp == 0) {
    const int64_t el = e < ne ? e : ne - 1;  // the ragged tail builds a copy of the last element
    double x[4][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[i][c] = __ldg(xyz + (i * 3 + c) * ne + el);
    }
    double rot[3][3], lx[4], ly[4];
    quad_frame(x, rot, lx, ly);
#pragma unroll
    for (int k = 0; k < 9; ++k) row(table, k) = rot[k / 3][k % 3];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      row(table, kRowLx + i) = lx[i];
      row(table, kRowLy + i) = ly[i];
    }
  } else if (warp == 1 && lane < 18) {
    dsh[lane] = lane < 9 ? __ldg(dmat + lane) : __ldg(dpmat + lane - 9);
  }
  __syncthreads();
  // phase 1b: warps 0-3 the DKQ coefficients of side w, warps 4-7 the
  // membrane of Gauss point w - 4
  if (warp < 4) {
    quad_side_table(table, warp);
  } else {
    quad_membrane_table(table, warp - 4, t);
  }
  __syncthreads();
  // phase 1c: warp 4h + q the plate B columns of nodes 2h, 2h+1 at Gauss point q
  if (warp < 4) {
    quad_plate_table<0>(table, warp);
  } else {
    quad_plate_table<1>(table, warp - 4);
  }
  __syncthreads();
  if (e >= ne) return;
  double rot[3][3];
  if (warp < 6) {
    // (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
    const int i = warp < 3 ? 0 : (warp < 5 ? 1 : 2);
    const int j = warp < 3 ? warp + 1 : (warp < 5 ? warp - 1 : 3);
    double mm[2][2] = {}, pp[3][3] = {};
    quad_pair_sums<false>(table, i, j, dsh, mm, pp);
    double l11[3][3], l12[3][3], l21[3][3], l22[3][3];
    local_block(mm, pp, l11, l12, l21, l22);
#pragma unroll
    for (int k = 0; k < 9; ++k) rot[k / 3][k % 3] = row(table, k);
    store_rotated_and_transpose(l11, rot, ke, 6 * i, 6 * j, e, ne);
    store_rotated_and_transpose(l12, rot, ke, 6 * i, 6 * j + 3, e, ne);
    store_rotated_and_transpose(l21, rot, ke, 6 * i + 3, 6 * j, e, ne);
    store_rotated_and_transpose(l22, rot, ke, 6 * i + 3, 6 * j + 3, e, ne);
  } else {
#pragma unroll 1
    for (int i = 2 * (warp - 6); i < 2 * (warp - 6) + 2; ++i) {
      double mm[2][2] = {}, pp[3][3] = {};
      quad_pair_sums<true>(table, i, i, dsh, mm, pp);
      mm[1][0] = mm[0][1];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < a; ++b) pp[a][b] = pp[b][a];
      }
      double l11[3][3], l12[3][3], l21[3][3], l22[3][3];
      local_block(mm, pp, l11, l12, l21, l22);
#pragma unroll
      for (int k = 0; k < 9; ++k) rot[k / 3][k % 3] = row(table, k);
      // L21 = L12^T: its rotation is stored as the transpose of L12's
      store_rotated_symmetric(l11, rot, ke, 6 * i, e, ne);
      store_rotated_and_transpose(l12, rot, ke, 6 * i, 6 * i + 3, e, ne);
      store_rotated_symmetric(l22, rot, ke, 6 * i + 3, e, ne);
    }
  }
}

int launch_tri(const double* xyz, const double* dm, const double* dp, double t, int64_t ne,
               double* ke, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int64_t blocks = (ne + kThreads - 1) / kThreads;
  tri_stiffness_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xyz, dm, dp, t, ne, ke);
  return static_cast<int>(cudaGetLastError());
}

int launch_quad(const double* xyz, const double* dm, const double* dp, double t, int64_t ne,
                double* ke, cudaStream_t stream) {
  // the table is above the 48 KB a block gets without asking
  const cudaError_t err = cudaFuncSetAttribute(
      quad_stiffness_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kQuadSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (ne + kQuadLanes - 1) / kQuadLanes;
  quad_stiffness_kernel<<<static_cast<unsigned>(blocks), kQuadLanes * kQuadWarps, kQuadSmemBytes,
                          stream>>>(xyz, dm, dp, t, ne, ke);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: xyz [m, 3, ne], dm and dp [3, 3] (device
// pointers), ke [6m, 6m, ne]; m is 3 (Tri-3) or 4 (Quad-4). The return value
// is cudaGetLastError() after the launch (0 = launched).
extern "C" int elem_stiffness_f64(const double* xyz, const double* dm, const double* dp,
                                  double thickness, int m, int64_t ne, double* ke, void* stream) {
  if (ne < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (m == 3) return launch_tri(xyz, dm, dp, thickness, ne, ke, s);
  if (m == 4) return launch_quad(xyz, dm, dp, thickness, ne, ke, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

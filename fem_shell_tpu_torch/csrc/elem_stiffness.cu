// Element stiffness of flat shell elements, one thread per element, in f64:
// Tri-3 (CST membrane + Specht plate) and Quad-4 (bilinear membrane + DKQ
// plate), each with the stabilized drilling DOF, in global axes.
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
// division stay IEEE.
//
// Bound: bytes. A launch must read xyz and write ke, 8*(3M + 36M^2) bytes per
// element (2664 for Tri-3, 4704 for Quad-4), against ~10-20 thousand f64
// operations per element (chip_smoke.py elem_work counts them from this
// code): ~4 operations per byte, under the card's f64 balance point of ~10.
//
// Design: batch-last, so the 32 threads of a warp store one entry (i, j) of
// 32 neighbouring elements in one 256-byte segment, and read xyz the same
// way. Each thread keeps the membrane (2M x 2M) and plate (3M x 3M)
// matrices, both symmetric and stored as their upper triangles, and the
// frame R; it never holds the 6M x 6M matrix. Per node pair (i, j) it builds
// the local 6x6 block from the membrane block, the plate block and the
// drilling term (the largest of the five membrane/plate diagonal entries of
// the block, over 1000), rotates it as the 3x3 blocks R^T L R of
// blockdiag(R, R)^T L blockdiag(R, R), and stores its 36 entries. Every loop
// is unrolled, so all indices are constants; the working set (~300 doubles
// for Quad-4) is larger than the register file gives one thread, and ptxas
// spills the rest to local memory (its report: chip_smoke.py phase 1).

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

// Local frame R, local in-plane node coordinates (lx, ly) and edge
// differences ((x12, y12), (x23, y23), (x34, y34), (x41, y41)).
__device__ __forceinline__ void quad_frame(const double (&x)[4][3], double (&rot)[3][3],
                                           double (&lx)[4], double (&ly)[4], double (&d)[4][2]) {
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
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k][0] = lx[k] - lx[(k + 1) % 4];
    d[k][1] = ly[k] - ly[(k + 1) % 4];
  }
}

__device__ __forceinline__ void quad_membrane(const double (&lx)[4], const double (&ly)[4],
                                              const double (&dm)[9], const double t, Sym<8>& km) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double r = quad_qp_r(q);
    const double s = quad_qp_s(q);
    // bilinear shape-function derivatives in (r, s); fem-shell.cpp:494-502
    const double dhdr[4] = {-0.25 * (1 - s), 0.25 * (1 - s), 0.25 * (1 + s), -0.25 * (1 + s)};
    const double dhds[4] = {-0.25 * (1 - r), -0.25 * (1 + r), 0.25 * (1 + r), 0.25 * (1 - r)};
    double j00 = 0.0, j01 = 0.0, j10 = 0.0, j11 = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      j00 += lx[i] * dhdr[i];
      j01 += ly[i] * dhdr[i];
      j10 += lx[i] * dhds[i];
      j11 += ly[i] * dhds[i];
    }
    const double det = j00 * j11 - j01 * j10;
    const double q00 = j11 / det, q01 = -j01 / det;
    const double q12 = -j10 / det, q13 = j00 / det;
    double b[3][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[0][2 * i] = q00 * dhdr[i] + q01 * dhds[i];
      b[0][2 * i + 1] = 0.0;
      b[1][2 * i] = 0.0;
      b[1][2 * i + 1] = q12 * dhdr[i] + q13 * dhds[i];
      b[2][2 * i] = q12 * dhdr[i] + q13 * dhds[i];
      b[2][2 * i + 1] = q00 * dhdr[i] + q01 * dhds[i];
    }
    add_btdb<8>(km, b, dm, det * t);
  }
}

// Hx and Hy of one derivative direction (n = N_xi or N_eta); h[5][4] holds
// the coefficients a, b, c, d, e of sides 5-8 (Batoz numbering).
__device__ __forceinline__ void h_vectors(const double (&h)[5][4], const double (&n)[8],
                                          double (&hx)[12], double (&hy)[12]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 4 + i;            // mid-side node on side i
    const int p = 4 + (i + 3) % 4;  // the preceding mid-side node
    const int im = i, ip = (i + 3) % 4;
    hx[3 * i] = 1.5 * (h[0][im] * n[m] - h[0][ip] * n[p]);
    hx[3 * i + 1] = h[1][im] * n[m] + h[1][ip] * n[p];
    hx[3 * i + 2] = n[i] - h[2][im] * n[m] - h[2][ip] * n[p];
    hy[3 * i] = 1.5 * (h[3][im] * n[m] - h[3][ip] * n[p]);
    hy[3 * i + 1] = -n[i] + h[4][im] * n[m] + h[4][ip] * n[p];
    hy[3 * i + 2] = -(h[1][im] * n[m] + h[1][ip] * n[p]);
  }
}

// DKQ strain matrix at (xi, eta); fem-shell.cpp:901-990.
__device__ __forceinline__ void eval_b_quad(const double (&h)[5][4], const double xi,
                                            const double eta, const double (&jinv)[2][2],
                                            double (&b)[3][12]) {
  const double n_xi[8] = {
      0.25 * (2 * xi + eta) * (1 - eta), 0.25 * (2 * xi - eta) * (1 - eta),
      0.25 * (2 * xi + eta) * (1 + eta), 0.25 * (2 * xi - eta) * (1 + eta),
      -xi * (1 - eta),                   0.5 * (1 - eta * eta),
      -xi * (1 + eta),                   -0.5 * (1 - eta * eta),
  };
  const double n_eta[8] = {
      0.25 * (2 * eta + xi) * (1 - xi), 0.25 * (2 * eta - xi) * (1 + xi),
      0.25 * (2 * eta + xi) * (1 + xi), 0.25 * (2 * eta - xi) * (1 - xi),
      -0.5 * (1 - xi * xi),             -eta * (1 + xi),
      0.5 * (1 - xi * xi),              -eta * (1 - xi),
  };
  double hx_xi[12], hy_xi[12], hx_eta[12], hy_eta[12];
  h_vectors(h, n_xi, hx_xi, hy_xi);
  h_vectors(h, n_eta, hx_eta, hy_eta);
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    b[0][c] = jinv[0][0] * hx_xi[c] + jinv[0][1] * hx_eta[c];
    b[1][c] = jinv[1][0] * hy_xi[c] + jinv[1][1] * hy_eta[c];
    b[2][c] = jinv[0][0] * hy_xi[c] + jinv[0][1] * hy_eta[c] + jinv[1][0] * hx_xi[c] +
              jinv[1][1] * hx_eta[c];
  }
}

__device__ __forceinline__ void quad_plate(const double (&d)[4][2], const double (&dp)[9],
                                           Sym<12>& kp) {
  double h[5][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double dx = d[k][0], dy = d[k][1];
    const double ss = dx * dx + dy * dy;  // squared side length
    h[0][k] = -dx / ss;
    h[1][k] = 0.75 * dx * dy / ss;
    h[2][k] = (0.25 * (dx * dx) - 0.5 * (dy * dy)) / ss;
    h[3][k] = -dy / ss;
    h[4][k] = (0.25 * (dy * dy) - 0.5 * (dx * dx)) / ss;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double r = quad_qp_r(q);
    const double s = quad_qp_s(q);
    const double j00 = 0.25 * ((d[0][0] + d[2][0]) * s - d[0][0] + d[2][0]);
    const double j01 = 0.25 * ((d[0][1] + d[2][1]) * s - d[0][1] + d[2][1]);
    const double j10 = 0.25 * ((d[0][0] + d[2][0]) * r - d[1][0] + d[3][0]);
    const double j11 = 0.25 * ((d[0][1] + d[2][1]) * r - d[1][1] + d[3][1]);
    const double det = j00 * j11 - j01 * j10;
    const double jinv[2][2] = {{j11 / det, -j01 / det}, {-j10 / det, j00 / det}};
    double b[3][12];
    eval_b_quad(h, r, s, jinv, b);
    add_btdb<12>(kp, b, dp, det);
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

template <int M>
__global__ void __launch_bounds__(128) elem_stiffness_kernel(
    const double* __restrict__ xyz, const double* __restrict__ dmat,
    const double* __restrict__ dpmat, const double t, const int64_t ne, double* __restrict__ ke) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= ne) return;
  double x[M][3], dm[9], dp[9];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) x[i][c] = __ldg(xyz + (i * 3 + c) * ne + e);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    dm[k] = __ldg(dmat + k);
    dp[k] = __ldg(dpmat + k);
  }
  double rot[3][3];
  Sym<2 * M> km;
  Sym<3 * M> kp;
  if constexpr (M == 3) {
    double d[3][2], area;
    tri_frame(x, rot, d, area);
    tri_membrane(d, area, dm, t, km);
    tri_plate(d, area, dp, kp);
  } else {
    double lx[4], ly[4], d[4][2];
    quad_frame(x, rot, lx, ly, d);
    quad_membrane(lx, ly, dm, t, km);
    quad_plate(d, dp, kp);
  }
  store_blocks<M>(km, kp, rot, ke, e, ne);
}

template <int M>
int launch(const double* xyz, const double* dm, const double* dp, double t, int64_t ne, double* ke,
           void* stream) {
  if (ne < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
  const int64_t blocks = (ne + kThreads - 1) / kThreads;
  elem_stiffness_kernel<M><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(xyz, dm, dp, t, ne, ke);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: xyz [m, 3, ne], dm and dp [3, 3] (device
// pointers), ke [6m, 6m, ne]; m is 3 (Tri-3) or 4 (Quad-4). The return value
// is cudaGetLastError() after the launch (0 = launched).
extern "C" int elem_stiffness_f64(const double* xyz, const double* dm, const double* dp,
                                  double thickness, int m, int64_t ne, double* ke, void* stream) {
  if (m == 3) return launch<3>(xyz, dm, dp, thickness, ne, ke, stream);
  if (m == 4) return launch<4>(xyz, dm, dp, thickness, ne, ke, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

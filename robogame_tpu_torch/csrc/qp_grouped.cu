// K2, grouped route: the batched ADMM QP solve for problems that share
// their H and A, written by hand for Hopper (sm_90a).
//
// Replaces, for these problems, the TPU kernel
// robogame_tpu/ops/qp_pallas.py:100 (_make_kernel, launched by
// solve_qp_lanes :260), as csrc/qp_admm.cu does for the rest.  It solves
//
//   min 1/2 x'Hx + g'x  s.t.  l <= Ax <= u
//
// with the ADMM of the plain version robogame_tpu_torch/ops/qp.py::solve_qp
// (rho0 = clip(tr(H)/n, 1e-3, 1e6) rho, n_seg segments of seg_iters
// iterations with over-relaxation alpha, the residuals, the adaptive rho
// and the flag of the last segment), on the algebra of
// robogame_tpu_torch/ops/qp_lanes.py::solve_qp_grouped_plain, its plain
// version: the problems of a group share H and A, and a problem with no
// equality row gives every row its scalar rho_p, so
//
//   K_p = H + sigma I + rho_p A'A,   K_p^-1 = W diag(1/(1 + rho_p lam)) W'
//
// from one generalized eigendecomposition per group.
//
// Two kernels:
// * grouped_setup_kernel, one block per group, in f64: M0 = H + sigma I
//   (positive definite for sigma > 0) and M1 = A'A; the Cholesky factor
//   M0 = R R', S = R^-1 M1 R^-T = V diag(lam) V', W = R^-T V; the
//   symmetric eigendecomposition by the cyclic Jacobi method in
//   round-robin order (16 disjoint rotations a round, each of the 256
//   threads rotating one 2 x 2 block, one barrier a round; 31 rounds a
//   sweep, until a sweep rotates nothing); W and lam go out in f32.  No
//   library solver.
// * grouped_admm_kernel: a block takes a tile of TP problems of one group.
//   A (twice: row- and column-major), W (twice) and the tile's l, u and the
//   vectors the products exchange sit in shared memory; x, g and the
//   diagonal 1/(1 + rho lam) of a thread's 2 variables x 4 problems, and z
//   and y of its 4 rows x 4 problems, in registers.  An iteration is four
//   register-tiled products over the tile, A'w, W'r, W t and A x, each
//   shared-memory load feeding 8 or 16 FMAs, with four barriers.  Problems
//   with an equality row (l == u somewhere) are not solved here: their
//   indices go to a list with a count on the device, which the per-problem
//   kernel (csrc/qp_admm.cu, rg_qp_admm_listed) solves next on the same
//   stream, with no host fetch.
//
// What bounds it: operations.  A skills QP (n=30, m=60, 60 iterations in 4
// segments) needs about 0.72 MFLOP on this algebra (4mn + 4n^2 an
// iteration) against about 0.95 MFLOP with a factorization per segment, and
// moves about 0.7 KB of its own data.  The design keeps every operand in
// shared memory or registers for the whole solve and feeds the f32 pipes
// from register tiles; 2 blocks of 80 problems an SM (about 218 KB of
// shared memory), so the 40,960 skills QPs of a launch run in two waves.
// The tensor cores stay off (no TF32).
//
// Numerics: the factors in f64, the iterations in f32 with sums in another
// order than the plain versions', so the kernel is held to them by
// tolerance; IEEE division and square root.  The build flags (kernels.py
// FMAD) rest on the f64 comparisons of robogame_tpu_torch/profile_qp.py
// and chip_smoke.py phase 5 (a').
//
// Supported: n <= 32, m <= 64, any group size (a tile holds one group's
// problems only); the wrapper routes groups of fewer than 32 problems and
// larger shapes to the per-problem kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NP = 32;                  // variables, padded
constexpr int MP = 64;                  // rows, padded
constexpr int LD = NP + 1;              // f64 setup matrices' row stride
constexpr int PAIRS = NP / 2;           // Jacobi rotations a round
constexpr int ST = PAIRS * PAIRS;       // setup threads: a pair of pairs
constexpr int MAX_SWEEPS = 30;
constexpr double JACOBI_TOL = 1e-14;    // off-diagonal left unrotated

constexpr int TP = 80;                  // problems a block
constexpr int PB = TP / 4;              // problem quads
constexpr int NT = 16 * PB;             // threads: 16 row blocks x 20 quads
constexpr int NRED = 7;                 // per-problem maxima of a segment

// ---------------------------------------------------------------------------
// setup: one block per group, f64
// ---------------------------------------------------------------------------

// Cholesky in place (lower, row-major, stride LD) of the positive
// definite n x n matrix C.
__device__ void chol(double* C, int n) {
  const int t = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    if (t == 0) C[j * LD + j] = sqrt(C[j * LD + j]);
    __syncthreads();
    const double ljj = C[j * LD + j];
    for (int i = j + 1 + t; i < n; i += ST) C[i * LD + j] /= ljj;
    __syncthreads();
    const int w = n - j - 1;
    for (int e = t; e < w * w; e += ST) {
      const int a = j + 1 + e / w, b = j + 1 + e % w;
      if (b <= a) C[a * LD + b] -= C[a * LD + j] * C[b * LD + j];
    }
    __syncthreads();
  }
}

// The round-robin pairing of round r over NP slots: slot NP-1 is fixed,
// the others turn on a circle.  Pair k of round r is (p, q), p < q.
__device__ __forceinline__ void rr_pair(int r, int k, int& p, int& q) {
  int a, b;
  if (k == 0) {
    a = NP - 1;
    b = r;
  } else {
    a = (r + k) % (NP - 1);
    b = (r - k + (NP - 1)) % (NP - 1);
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

// The Jacobi rotation (c, s) that zeroes S[p][q] of the symmetric S
// (row stride LD), S <- G'S G with G = [[c, s], [-s, c]] on rows and
// columns p, q: t = tan of the smaller angle, from d = S[q][q] - S[p][p]
// and b = 2 S[p][q] as t = sgn(d) b / (|d| + sqrt(d^2 + b^2)), then
// c = 1/sqrt(1 + t^2), s = t c (one square root, one division and one
// reciprocal square root: the round's critical path).  The identity (and
// false) where q >= n or |S[p][q]| <= JACOBI_TOL sqrt(|S[p][p] S[q][q]|)
// (the f32 factors cannot see it) or is negligible beside both diagonal
// entries.
__device__ __forceinline__ bool jacobi_angle(const double* S, int p, int q,
                                             int n, double& c, double& s) {
  c = 1.0;
  s = 0.0;
  if (q >= n) return false;
  const double app = S[p * LD + p], aqq = S[q * LD + q];
  const double apq = S[p * LD + q];
  const double g = 100.0 * fabs(apq);
  if ((fabs(app) + g == fabs(app) && fabs(aqq) + g == fabs(aqq)) ||
      apq * apq <= JACOBI_TOL * JACOBI_TOL * fabs(app * aqq))
    return false;
  const double d = aqq - app, b = 2.0 * apq;
  const double t = (d < 0.0 ? -b : b) / (fabs(d) + sqrt(d * d + b * b));
  c = rsqrt(t * t + 1.0);
  s = t * c;
  return true;
}

__global__ void __launch_bounds__(ST)
grouped_setup_kernel(const float* __restrict__ H,
                     const float* __restrict__ A, float* __restrict__ Wout,
                     float* __restrict__ lam_out, int n, int m,
                     float sigma) {
  __shared__ double V[NP * LD];    // the eigenvectors
  __shared__ double X1[NP * LD];   // M1, later S
  __shared__ double Rm[NP * LD];   // the factor R, then R^-1 M1
  __shared__ double Ri[NP * LD];   // R^-1
  __shared__ int rot[2];
  const int t = threadIdx.x;
  const int gidx = blockIdx.x;
  const float* Hg = H + (size_t)gidx * n * n;
  const float* Ag = A + (size_t)gidx * m * n;

  // ---- M0 = H + sigma I (into the factor's buffer), M1 = A'A (f64)
  for (int e = t; e < n * n; e += ST) {
    const int i = e / n, j = e % n;
    Rm[i * LD + j] = (double)Hg[i * n + j] + (i == j ? (double)sigma : 0.0);
    double acc = 0.0;
    for (int r = 0; r < m; ++r)
      acc += (double)Ag[r * n + i] * (double)Ag[r * n + j];
    X1[i * LD + j] = acc;
  }
  __syncthreads();
  // ---- M0 = R R'
  chol(Rm, n);
  // ---- Ri = R^-1 (lower), one column a thread
  if (t < n) {
    const int c = t;
    for (int i = 0; i < n; ++i) Ri[i * LD + c] = 0.0;
    for (int i = c; i < n; ++i) {
      double acc = 0.0;
      for (int k = c; k < i; ++k) acc += Rm[i * LD + k] * Ri[k * LD + c];
      Ri[i * LD + c] = ((i == c ? 1.0 : 0.0) - acc) / Rm[i * LD + i];
    }
  }
  __syncthreads();
  // ---- T = Ri M1 over the factor, then S = T Ri' (lower, mirrored) over
  // M1
  for (int e = t; e < n * n; e += ST) {
    const int i = e / n, j = e % n;
    double acc = 0.0;
    for (int k = 0; k <= i; ++k) acc += Ri[i * LD + k] * X1[k * LD + j];
    Rm[i * LD + j] = acc;
  }
  __syncthreads();
  double* S = X1;
  for (int e = t; e < n * n; e += ST) {
    const int i = e / n, j = e % n;
    if (j <= i) {
      double acc = 0.0;
      for (int k = 0; k <= j; ++k) acc += Rm[i * LD + k] * Ri[j * LD + k];
      S[i * LD + j] = acc;
    }
  }
  __syncthreads();
  // (zero beyond n, so that the rotations of the slots beyond n, the
  // identity, leave those rows and columns zero)
  for (int e = t; e < NP * NP; e += ST) {
    const int i = e / NP, j = e % NP;
    if (i >= n || j >= n) S[i * LD + j] = 0.0;
    else if (j > i) S[i * LD + j] = S[j * LD + i];
    V[i * LD + j] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();

  // ---- cyclic Jacobi, round-robin: S = V diag(lam) V'.  A round rotates
  // 16 disjoint pairs at once, S <- G'S G: thread (a, b) of the 16 x 16
  // pairs computes both rotations itself from the round's S and writes
  // the 2 x 2 block at rows {p_a, q_a}, columns {p_b, q_b} into the other
  // buffer (R^-1 M1 is dead), and V's entries at those rows and columns in
  // place (V <- V G); one barrier a round.
  const int pa = t / PAIRS, pb = t % PAIRS;
  double* Sn = Rm;
  if (t < 2) rot[t] = 0;
  __syncthreads();
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    for (int r = 0; r < NP - 1; ++r) {
      int p1, q1, p2, q2;
      rr_pair(r, pa, p1, q1);
      rr_pair(r, pb, p2, q2);
      double c1, s1, c2, s2;
      const bool rot2 = jacobi_angle(S, p2, q2, n, c2, s2);
      jacobi_angle(S, p1, q1, n, c1, s1);
      if (pa == 0 && rot2) rot[sweep & 1] = 1;
      if (t == 0 && r == 1) rot[(sweep + 1) & 1] = 0;
      {
        const double bpp = S[p1 * LD + p2], bpq = S[p1 * LD + q2];
        const double bqp = S[q1 * LD + p2], bqq = S[q1 * LD + q2];
        const double rpp = c1 * bpp - s1 * bqp, rpq = c1 * bpq - s1 * bqq;
        const double rqp = s1 * bpp + c1 * bqp, rqq = s1 * bpq + c1 * bqq;
        Sn[p1 * LD + p2] = c2 * rpp - s2 * rpq;
        Sn[p1 * LD + q2] = s2 * rpp + c2 * rpq;
        Sn[q1 * LD + p2] = c2 * rqp - s2 * rqq;
        Sn[q1 * LD + q2] = s2 * rqp + c2 * rqq;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h ? q1 : p1;
        const double vp = V[i * LD + p2], vq = V[i * LD + q2];
        V[i * LD + p2] = c2 * vp - s2 * vq;
        V[i * LD + q2] = s2 * vp + c2 * vq;
      }
      __syncthreads();
      double* sw = S;
      S = Sn;
      Sn = sw;
    }
    if (!rot[sweep & 1]) break;
  }

  // ---- W = Ri' V, lam; zero padding
  float* Wg = Wout + (size_t)gidx * NP * NP;
  for (int e = t; e < NP * NP; e += ST) {
    const int i = e / NP, k = e % NP;
    float w = 0.0f;
    if (i < n && k < n) {
      double acc = 0.0;
      for (int j = i; j < n; ++j) acc += Ri[j * LD + i] * V[j * LD + k];
      w = (float)acc;
    }
    Wg[e] = w;
  }
  if (t < NP) {
    lam_out[(size_t)gidx * NP + t] = t < n ? (float)S[t * LD + t] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// the iterations: a tile of TP problems of one group a block
// ---------------------------------------------------------------------------

struct Smem {
  float A[MP * NP];     // A[r][i] at r*NP + i (zero padded)
  float At[NP * MP];    // A[r][i] at i*MP + r
  float W[NP * NP];     // W[i][k] at i*NP + k
  float Wt[NP * NP];    // W[i][k] at k*NP + i
  float w[MP * TP];     // row vectors of the tile: rho z - y, then y
  float r[NP * TP];     // rhs, then x
  float tt[NP * TP];    // D W' rhs
  float lo[MP * TP];
  float hi[MP * TP];
  unsigned red[NRED * TP];
  float rho[TP];
  int eq[TP];
};

__device__ __forceinline__ void amax_to(unsigned* slot, float v) {
  atomicMax(slot, __float_as_uint(v));   // v >= 0: the bits order as floats
}

__global__ void __launch_bounds__(NT, 2)
grouped_admm_kernel(const float* __restrict__ H, const float* __restrict__ g,
                    const float* __restrict__ A, const float* __restrict__ l,
                    const float* __restrict__ u,
                    const float* __restrict__ Wg_all,
                    const float* __restrict__ lam_all,
                    float* __restrict__ xout, float* __restrict__ stats,
                    int* __restrict__ listed, int* __restrict__ n_listed,
                    unsigned long long* __restrict__ routed, int n, int m,
                    int group, int tiles, int n_seg, int seg_iters,
                    float rho, float sigma, float alpha, float tol,
                    float dual_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const int gidx = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * TP;
  const int np = min(TP, group - j0);              // problems in the tile
  const size_t p0 = (size_t)gidx * group + j0;     // first problem
  const float* Hg = H + (size_t)gidx * n * n;
  const float* Ag = A + (size_t)gidx * m * n;
  const float* Wg = Wg_all + (size_t)gidx * NP * NP;

  // ---- the group's operands and the tile's bounds
  for (int e = t; e < MP * NP; e += NT) {
    const int r = e / NP, i = e % NP;
    const float a = (r < m && i < n) ? Ag[r * n + i] : 0.0f;
    S.A[e] = a;
    S.At[i * MP + r] = a;
  }
  for (int e = t; e < NP * NP; e += NT) {
    const float w = Wg[e];
    S.W[e] = w;
    S.Wt[(e % NP) * NP + e / NP] = w;
  }
  if (t < TP) S.eq[t] = 0;
  for (int e = t; e < MP * TP; e += NT) {
    S.lo[e] = 0.0f;
    S.hi[e] = 0.0f;
  }
  for (int e = t; e < NRED * TP; e += NT) S.red[e] = 0u;
  __syncthreads();
  for (int e = t; e < np * m; e += NT) {
    const int q = e / m, r = e % m;
    const float lo = l[p0 * m + e], hi = u[p0 * m + e];
    S.lo[r * TP + q] = lo;
    S.hi[r * TP + q] = hi;
    if (lo == hi) S.eq[q] = 1;
  }
  if (t < 32) {
    float tr = 0.0f;
    for (int i = t; i < n; i += 32) tr += Hg[i * n + i];
    for (int o = 16; o > 0; o >>= 1) tr += __shfl_xor_sync(0xffffffffu, tr, o);
    const float rho0 = fminf(fmaxf(tr / (float)n, 1e-3f), 1e6f) * rho;
    for (int q = t; q < TP; q += 32) S.rho[q] = rho0;
  }
  __syncthreads();

  // thread t: problems 4 qb .. 4 qb + 3; variables 2 rb, 2 rb + 1 (n-map);
  // rows 4 rb .. 4 rb + 3 (m-map)
  const int qb = t % PB, rb = t / PB;
  const int q0 = 4 * qb;
  const int i0 = 2 * rb, r0 = 4 * rb;
  float xv[2][4], gv[2][4], dv[2][4], lamv[2];
  float zv[4][4], yv[4][4], rhov[4];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    lamv[a] = lam_all[(size_t)gidx * NP + i0 + a];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + a, q = q0 + b;
      xv[a][b] = 0.0f;
      gv[a][b] = (i < n && q < np) ? g[(p0 + q) * n + i] : 0.0f;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      zv[a][b] = 0.0f;
      yv[a][b] = 0.0f;
    }
  const float one_m_alpha = 1.0f - alpha;
  float prim = 0.0f, dual = 0.0f, p_sc = 1.0f, d_sc = 1.0f;   // t < TP

  for (int s = 0; s < n_seg; ++s) {
#pragma unroll
    for (int b = 0; b < 4; ++b) rhov[b] = S.rho[q0 + b];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dv[a][b] = 1.0f / (1.0f + rhov[b] * lamv[a]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float4 wv;
      wv.x = rhov[0] * zv[a][0] - yv[a][0];
      wv.y = rhov[1] * zv[a][1] - yv[a][1];
      wv.z = rhov[2] * zv[a][2] - yv[a][2];
      wv.w = rhov[3] * zv[a][3] - yv[a][3];
      *reinterpret_cast<float4*>(&S.w[(r0 + a) * TP + q0]) = wv;
    }
    __syncthreads();

    for (int it = 0; it < seg_iters; ++it) {
      const bool last = it == seg_iters - 1;
      float acc[2][4];
      // ---- rhs = sigma x - g + A'w
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 8
      for (int r = 0; r < MP; ++r) {
        const float2 av = *reinterpret_cast<const float2*>(&S.A[r * NP + i0]);
        const float4 wv = *reinterpret_cast<const float4*>(&S.w[r * TP + q0]);
        acc[0][0] += av.x * wv.x; acc[0][1] += av.x * wv.y;
        acc[0][2] += av.x * wv.z; acc[0][3] += av.x * wv.w;
        acc[1][0] += av.y * wv.x; acc[1][1] += av.y * wv.y;
        acc[1][2] += av.y * wv.z; acc[1][3] += av.y * wv.w;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float4 rv;
        rv.x = sigma * xv[a][0] - gv[a][0] + acc[a][0];
        rv.y = sigma * xv[a][1] - gv[a][1] + acc[a][1];
        rv.z = sigma * xv[a][2] - gv[a][2] + acc[a][2];
        rv.w = sigma * xv[a][3] - gv[a][3] + acc[a][3];
        *reinterpret_cast<float4*>(&S.r[(i0 + a) * TP + q0]) = rv;
      }
      __syncthreads();
      // ---- t = D W'rhs
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 8
      for (int i = 0; i < NP; ++i) {
        const float2 wv2 = *reinterpret_cast<const float2*>(&S.W[i * NP + i0]);
        const float4 rv = *reinterpret_cast<const float4*>(&S.r[i * TP + q0]);
        acc[0][0] += wv2.x * rv.x; acc[0][1] += wv2.x * rv.y;
        acc[0][2] += wv2.x * rv.z; acc[0][3] += wv2.x * rv.w;
        acc[1][0] += wv2.y * rv.x; acc[1][1] += wv2.y * rv.y;
        acc[1][2] += wv2.y * rv.z; acc[1][3] += wv2.y * rv.w;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float4 tv;
        tv.x = dv[a][0] * acc[a][0];
        tv.y = dv[a][1] * acc[a][1];
        tv.z = dv[a][2] * acc[a][2];
        tv.w = dv[a][3] * acc[a][3];
        *reinterpret_cast<float4*>(&S.tt[(i0 + a) * TP + q0]) = tv;
      }
      __syncthreads();
      // ---- x = W t
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < NP; ++k) {
        const float2 wv2 = *reinterpret_cast<const float2*>(&S.Wt[k * NP + i0]);
        const float4 tv = *reinterpret_cast<const float4*>(&S.tt[k * TP + q0]);
        acc[0][0] += wv2.x * tv.x; acc[0][1] += wv2.x * tv.y;
        acc[0][2] += wv2.x * tv.z; acc[0][3] += wv2.x * tv.w;
        acc[1][0] += wv2.y * tv.x; acc[1][1] += wv2.y * tv.y;
        acc[1][2] += wv2.y * tv.z; acc[1][3] += wv2.y * tv.w;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) xv[a][b] = acc[a][b];
        *reinterpret_cast<float4*>(&S.r[(i0 + a) * TP + q0]) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
      __syncthreads();
      // ---- Ax; z and y; the next w (y itself after the last iteration)
      float ax[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) ax[a][b] = 0.0f;
#pragma unroll 8
      for (int i = 0; i < NP; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(&S.At[i * MP + r0]);
        const float4 xx = *reinterpret_cast<const float4*>(&S.r[i * TP + q0]);
        ax[0][0] += av.x * xx.x; ax[0][1] += av.x * xx.y;
        ax[0][2] += av.x * xx.z; ax[0][3] += av.x * xx.w;
        ax[1][0] += av.y * xx.x; ax[1][1] += av.y * xx.y;
        ax[1][2] += av.y * xx.z; ax[1][3] += av.y * xx.w;
        ax[2][0] += av.z * xx.x; ax[2][1] += av.z * xx.y;
        ax[2][2] += av.z * xx.z; ax[2][3] += av.z * xx.w;
        ax[3][0] += av.w * xx.x; ax[3][1] += av.w * xx.y;
        ax[3][2] += av.w * xx.z; ax[3][3] += av.w * xx.w;
      }
      float pr[4] = {0.f, 0.f, 0.f, 0.f}, am[4] = {0.f, 0.f, 0.f, 0.f};
      float zm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 lo = *reinterpret_cast<const float4*>(&S.lo[(r0 + a) * TP + q0]);
        const float4 hi = *reinterpret_cast<const float4*>(&S.hi[(r0 + a) * TP + q0]);
        const float lov[4] = {lo.x, lo.y, lo.z, lo.w};
        const float hiv[4] = {hi.x, hi.y, hi.z, hi.w};
        float wv[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float zt = alpha * ax[a][b] + one_m_alpha * zv[a][b];
          const float zn = fminf(fmaxf(zt + yv[a][b] / rhov[b], lov[b]),
                                 hiv[b]);
          yv[a][b] = yv[a][b] + rhov[b] * (zt - zn);
          zv[a][b] = zn;
          wv[b] = last ? yv[a][b] : rhov[b] * zn - yv[a][b];
          pr[b] = fmaxf(pr[b], fabsf(ax[a][b] - zn));
          am[b] = fmaxf(am[b], fabsf(ax[a][b]));
          zm[b] = fmaxf(zm[b], fabsf(zn));
        }
        *reinterpret_cast<float4*>(&S.w[(r0 + a) * TP + q0]) =
            make_float4(wv[0], wv[1], wv[2], wv[3]);
      }
      if (last) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          amax_to(&S.red[0 * TP + q0 + b], pr[b]);
          amax_to(&S.red[1 * TP + q0 + b], am[b]);
          amax_to(&S.red[2 * TP + q0 + b], zm[b]);
        }
      }
      __syncthreads();
    }

    // ---- residuals: A'y (y in w), Hx (x in r), and their maxima
    {
      float aty[2][4], hx[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          aty[a][b] = 0.0f;
          hx[a][b] = 0.0f;
        }
      for (int r = 0; r < MP; ++r) {
        const float2 av = *reinterpret_cast<const float2*>(&S.A[r * NP + i0]);
        const float4 yy = *reinterpret_cast<const float4*>(&S.w[r * TP + q0]);
        const float yl[4] = {yy.x, yy.y, yy.z, yy.w};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          aty[0][b] += av.x * yl[b];
          aty[1][b] += av.y * yl[b];
        }
      }
      for (int j = 0; j < n; ++j) {
        const float h0 = i0 < n ? Hg[i0 * n + j] : 0.0f;
        const float h1 = i0 + 1 < n ? Hg[(i0 + 1) * n + j] : 0.0f;
        const float4 xx = *reinterpret_cast<const float4*>(&S.r[j * TP + q0]);
        const float xl[4] = {xx.x, xx.y, xx.z, xx.w};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          hx[0][b] += h0 * xl[b];
          hx[1][b] += h1 * xl[b];
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float du = 0.f, hm = 0.f, atm = 0.f, gm = 0.f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          du = fmaxf(du, fabsf(hx[a][b] + gv[a][b] + aty[a][b]));
          hm = fmaxf(hm, fabsf(hx[a][b]));
          atm = fmaxf(atm, fabsf(aty[a][b]));
          gm = fmaxf(gm, fabsf(gv[a][b]));
        }
        amax_to(&S.red[3 * TP + q0 + b], du);
        amax_to(&S.red[4 * TP + q0 + b], hm);
        amax_to(&S.red[5 * TP + q0 + b], atm);
        amax_to(&S.red[6 * TP + q0 + b], gm);
      }
    }
    __syncthreads();
    if (t < TP) {
      float v[NRED];
#pragma unroll
      for (int k = 0; k < NRED; ++k) {
        v[k] = __uint_as_float(S.red[k * TP + t]);
        S.red[k * TP + t] = 0u;
      }
      prim = v[0];
      dual = v[3];
      p_sc = fmaxf(v[1], v[2]) + 1e-9f;
      d_sc = fmaxf(fmaxf(v[4], v[5]), v[6]) + 1e-9f;
      const float ratio = sqrtf((prim / p_sc) / (dual / d_sc + 1e-12f));
      S.rho[t] = fminf(fmaxf(S.rho[t] * fminf(fmaxf(ratio, 0.2f), 5.0f),
                             1e-6f), 1e8f);
    }
    __syncthreads();
  }

  // ---- outputs of the problems solved here; the rest to the list
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + a, q = q0 + b;
      if (i < n && q < np && !S.eq[q]) xout[(p0 + q) * n + i] = xv[a][b];
    }
  if (t < np) {
    const size_t p = p0 + t;
    if (S.eq[t]) {
      listed[atomicAdd(n_listed, 1)] = (int)p;
    } else {
      const bool conv = (prim < tol * p_sc) && (dual < dual_tol * d_sc);
      stats[p * 3 + 0] = conv ? 1.0f : 0.0f;
      stats[p * 3 + 1] = prim;
      stats[p * 3 + 2] = dual;
    }
  }
  if (routed != nullptr && t == 0) {
    int n_eq = 0;
    for (int q = 0; q < np; ++q) n_eq += S.eq[q];
    atomicAdd(&routed[0], (unsigned long long)(np - n_eq));
  }
}

}  // namespace

// The grouped route over P = G * group problems: H (G, n, n), g (P, n),
// A (G, m, n), l/u (P, m) in (f32, contiguous, row-major); W (G, 32, 32)
// and lam (G, 32) out (the setup's factors); x (P, n) and stats (P, 3) =
// [converged, prim_res, dual_res] out for the problems with no equality
// row; `listed` (P,) and `n_listed` (1,) out: the problems with an
// equality row and their count, for rg_qp_admm_listed; `routed` (2,)
// accumulates the problems solved here (element 0; may be null).
// Returns the CUDA error of the launches (0 when accepted).
extern "C" int rg_qp_grouped(const float* H, const float* g, const float* A,
                             const float* l, const float* u, float* W,
                             float* lam, float* x, float* stats,
                             int* listed, int* n_listed,
                             unsigned long long* routed, int P, int n, int m,
                             int group, int n_seg, int seg_iters, float rho,
                             float sigma, float alpha, float tol,
                             float dual_tol, void* stream) {
  if (n < 1 || n > NP || m < 1 || m > MP || P < 1 || group < 1 ||
      P % group != 0 || n_seg < 1 || seg_iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int G = P / group;
  cudaError_t err = cudaMemsetAsync(n_listed, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  grouped_setup_kernel<<<G, ST, 0, st>>>(H, A, W, lam, n, m, sigma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bytes = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(grouped_admm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grouped_admm_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (group + TP - 1) / TP;
  grouped_admm_kernel<<<G * tiles, NT, bytes, st>>>(
      H, g, A, l, u, W, lam, x, stats, listed, n_listed, routed, n, m, group,
      tiles, n_seg, seg_iters, rho, sigma, alpha, tol, dual_tol);
  return (int)cudaGetLastError();
}

// The setup alone (for tests): W (G, 32, 32) and lam (G, 32) from
// H (G, n, n) and A (G, m, n).
extern "C" int rg_qp_grouped_setup(const float* H, const float* A, float* W,
                                   float* lam, int G, int n, int m,
                                   float sigma, void* stream) {
  if (n < 1 || n > NP || m < 1 || m > MP || G < 1)
    return (int)cudaErrorInvalidValue;
  grouped_setup_kernel<<<G, ST, 0, (cudaStream_t)stream>>>(
      H, A, W, lam, n, m, sigma);
  return (int)cudaGetLastError();
}

// The blocks a launch of grouped_admm_kernel keeps on one SM, and its
// shared bytes (out[0], out[1]).
extern "C" int rg_qp_grouped_occupancy(int* out) {
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grouped_admm_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, grouped_admm_kernel, NT, bytes);
  out[0] = blocks;
  out[1] = bytes;
  return (int)err;
}

// The structured two-agent ADMM QP solve of K5 (csrc/qp_joint.cu), written
// by hand for Hopper (sm_90a), on a general A.  (K4, whose rows are knot
// combinations of the position sensitivities, has its own machinery in
// csrc/knot_sqp.cuh.)
//
// It computes what the TPU kernel's machinery computes
// (robogame_tpu/ops/qp_pallas.py: _chol_in_place :392, _trtri_in_place
// :405, and the segment of _make_joint_kernel :420): the problem
//
//   min 1/2 x'Hx + g'x  s.t.  lx <= x <= ux (implicit rows),
//                             lo <= A x <= hi,
//
// with x = [x1 (n1); x2 (n1)], H = blockdiag(H1, H2), and R = 2 mo + mp
// constraint rows ordered [own rows of player 1 (mo); own rows of player 2
// (mo); pair rows (mp)].  A is stored per player and column: player p's
// column j holds its own rows then its part of the pair rows (m1 = mo + mp
// entries); a pair row's product sums both players' parts.
//
// One adaptive-rho segment:
//   K11 = H1 + (sigma + rho) I + A1' R1 A1, C1 = chol(K11)^-1 (dtrti2 order),
//   K12 = P1' Rp P2, W = C1 K12, S = K22 - W'W, Cs = chol(S)^-1;
//   each ADMM iteration solves K x = r through the factors, never an
//   explicit inverse:  t1 = C1 r1, t2 = r2 - W't1, u2 = Cs t2, x2 = Cs'u2,
//   v1 = t1 - W x2, x1 = C1'v1;  then the alpha-relaxed z and y updates of
//   the box rows (scalar rho) and of the constraint rows (rho, 1e3 rho on
//   equality rows);
//   then the residuals and rho <- clip(rho clip(sqrt(ratio), 0.2, 5),
//   1e-6, 1e8).
//
// Design: one block of NT = 128 threads per problem.  At CMPC's shape (n1
// = 40, mo = 80, mp = 20) a problem's A, C1, W and S take 53 KB of shared
// memory, so only 3 or 4 problems fit an SM: one warp per problem, as K2
// does it, would leave 3-4 warps an SM.  Four warps share each problem
// instead: thread v < 2 n1 owns variable v (its x, z, y, g and box in
// registers), thread t owns the rows t, t + 128, ... (their z, y, bounds
// and rho in registers), and
// the formation of K, the Cholesky's trailing updates and the inverse's
// rows spread over the block.  H stays in device memory (read once per
// segment and for the residuals, through L1/L2).  The triangular solves are
// dependent chains of n1-long dot products; more problems in flight, the
// per-knot structure of A'A and warp-level splitting of those dots are
// later work (K4's design in csrc/knot_sqp.cuh is one answer).
//
// Numerics: the sources are built with -fmad=false and no fast math, IEEE
// division and square root.  Sums run in another order than the plain
// PyTorch versions' batched products, so the two are held by tolerance.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace joint {

constexpr int NT = 128;                 // threads of one problem's block
constexpr int NW = NT / 32;
constexpr int MAX_N1 = 64;
constexpr int MAX_R = 4 * NT;           // constraint rows: RM <= 4 a thread
constexpr size_t SMEM_MAX = 232448;     // a block's shared memory on H100

struct Dims {
  int n1, mo, mp, m1, R, ldn, ldm;
};

__host__ __device__ inline Dims dims(int n1, int mo, int mp) {
  Dims d;
  d.n1 = n1;
  d.mo = mo;
  d.mp = mp;
  d.m1 = mo + mp;
  d.R = 2 * mo + mp;
  d.ldn = n1 | 1;                       // odd strides: no bank conflicts
  d.ldm = d.m1 | 1;
  return d;
}

// Shared floats of the solver: A, C1, W, S, the per-player row penalties
// (2 m1), the row vector w (R), the vectors xs, rs, ts, us (2 n1 each) and
// the reduction scratch (8 NW).
__host__ __device__ inline int solver_floats(const Dims& d) {
  return 2 * d.n1 * d.ldm + 3 * d.n1 * d.ldn + 2 * d.m1 + d.R + 8 * d.n1 +
         8 * NW;
}

struct Solver {
  Dims D;
  float* A;     // A[p][j][r] at (p n1 + j) ldm + r
  float* C1;    // n1 x n1 column-major: M[i][j] at j ldn + i
  float* W;
  float* S;
  float* rho1;  // player 1's column penalties: own rows, then pair rows
  float* rho2;
  float* ws;    // a row vector (R)
  float* xs;    // x (2 n1): the iterate, or the linearization point
  float* rs;    // the iteration's right-hand side
  float* ts;    // scratch vectors (2 n1 each)
  float* us;
  float* red;   // reduction scratch
  const float* H;  // this problem's blocks (2, n1, n1) in device memory
  float sigma, alpha;
};

__device__ inline Solver carve(float* smem, const Dims& D, const float* H,
                               float sigma, float alpha) {
  Solver s;
  s.D = D;
  s.A = smem;
  s.C1 = s.A + 2 * D.n1 * D.ldm;
  s.W = s.C1 + D.n1 * D.ldn;
  s.S = s.W + D.n1 * D.ldn;
  s.rho1 = s.S + D.n1 * D.ldn;
  s.rho2 = s.rho1 + D.m1;
  s.ws = s.rho2 + D.m1;
  s.xs = s.ws + D.R;
  s.rs = s.xs + 2 * D.n1;
  s.ts = s.rs + 2 * D.n1;
  s.us = s.ts + 2 * D.n1;
  s.red = s.us + 2 * D.n1;
  s.H = H;
  s.sigma = sigma;
  s.alpha = alpha;
  return s;
}

// The registers of one thread: its variable and its rows.
template <int RM>
struct Own {
  float x, zx, yx, g, lx, ux;                  // variable threadIdx.x
  float z[RM], y[RM], lo[RM], hi[RM], ro[RM], ax[RM];
  bool eq[RM];                                 // rows threadIdx.x + NT k
  float rho;                                   // the box rows' rho
  float prim, dual, p_sc, d_sc;                // the last segment's
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide maxima of NV values, returned to every thread.
template <int NV>
__device__ inline void block_max(float (&v)[NV], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_max(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i * NW + w] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float m = red[i * NW];
    for (int k = 1; k < NW; ++k) m = fmaxf(m, red[i * NW + k]);
    v[i] = m;
  }
  __syncthreads();
}

// In-place Cholesky of the lower triangle of an n x n column-major M,
// right-looking: column j of L over column j of K, then the trailing
// update.  Ends synchronized.
__device__ inline void chol(float* M, int n, int ld) {
  const int t = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    const float dj = M[j * ld + j];
    __syncthreads();
    const float ljj = sqrtf(dj);
    const float piv = 1.0f / ljj;
    for (int i = j + t; i < n; i += NT)
      M[j * ld + i] = i == j ? ljj : M[j * ld + i] * piv;
    __syncthreads();
    const int tt = n - j - 1;
    for (int e = t; e < tt * tt; e += NT) {
      const int kk = e / tt, ii = e - kk * tt;
      if (ii >= kk) {
        const int k = j + 1 + kk, i = j + 1 + ii;
        M[k * ld + i] -= M[j * ld + i] * M[j * ld + k];
      }
    }
    __syncthreads();
  }
}

// C = L^-1 in place over the lower-triangular L (column-major), in LAPACK
// dtrti2 order: the last column first; column j needs only the inverted
// columns k > j and L's column j, copied to ``col`` before it is
// overwritten.  The strict upper triangle becomes 0.  Ends synchronized.
__device__ inline void trtri(float* M, int n, int ld, float* col) {
  const int t = threadIdx.x;
  for (int j = n - 1; j >= 0; --j) {
    for (int i = j + t; i < n; i += NT) col[i] = M[j * ld + i];
    __syncthreads();
    const float inv_d = 1.0f / col[j];
    for (int i = t; i < n; i += NT) {
      float v = 0.f;
      if (i >= j) {
        float acc = 0.f;
        for (int k = j + 1; k <= i; ++k) acc += M[k * ld + i] * col[k];
        v = ((i == j ? 1.f : 0.f) - acc) * inv_d;
      }
      M[j * ld + i] = v;
    }
    __syncthreads();
  }
}

// (A'w)[v] for variable v < 2 n1 and a row vector w (R).
__device__ inline float at_row(const Solver& s, int v, const float* w) {
  const Dims& D = s.D;
  const int p = v >= D.n1 ? 1 : 0;
  const float* a = s.A + (size_t)v * D.ldm;
  const float* wo = w + p * D.mo;
  const float* wp = w + 2 * D.mo;
  float acc = 0.f;
  for (int r = 0; r < D.mo; ++r) acc += a[r] * wo[r];
  for (int r = 0; r < D.mp; ++r) acc += a[D.mo + r] * wp[r];
  return acc;
}

// (A x)[q] for row q < R at the x in xs.
__device__ inline float ax_row(const Solver& s, int q) {
  const Dims& D = s.D;
  if (q < 2 * D.mo) {
    const int p = q >= D.mo ? 1 : 0;
    const float* a = s.A + (size_t)p * D.n1 * D.ldm + (q - p * D.mo);
    const float* xp = s.xs + p * D.n1;
    float acc = 0.f;
    for (int j = 0; j < D.n1; ++j) acc += a[j * D.ldm] * xp[j];
    return acc;
  }
  const int r = D.mo + (q - 2 * D.mo);
  const float* a0 = s.A + r;
  const float* a1 = s.A + (size_t)D.n1 * D.ldm + r;
  float f0 = 0.f, f1 = 0.f;
  for (int j = 0; j < D.n1; ++j) f0 += a0[j * D.ldm] * s.xs[j];
  for (int j = 0; j < D.n1; ++j) f1 += a1[j * D.ldm] * s.xs[D.n1 + j];
  return f0 + f1;
}

// The factors C1, W and Cs (in S) of K at the row penalties in rho1/rho2
// and the box rows' rho.  Ends synchronized.
__device__ inline void factor(const Solver& s, float rho) {
  const Dims& D = s.D;
  const int n1 = D.n1, ldn = D.ldn, ldm = D.ldm, t = threadIdx.x;
  const float diag = s.sigma + rho;
  const float* H1 = s.H;
  const float* H2 = s.H + n1 * n1;
  // K11 (lower triangle) into C1
  for (int e = t; e < n1 * n1; e += NT) {
    const int j = e / n1, i = e - j * n1;
    if (i >= j) {
      const float* ai = s.A + i * ldm;
      const float* aj = s.A + j * ldm;
      float acc = 0.f;
      for (int r = 0; r < D.m1; ++r) acc += ai[r] * (aj[r] * s.rho1[r]);
      float k = acc + H1[i * n1 + j];
      if (i == j) k += diag;
      s.C1[j * ldn + i] = k;
    }
  }
  __syncthreads();
  chol(s.C1, n1, ldn);
  trtri(s.C1, n1, ldn, s.ts);
  // K12 = P1' Rp P2 (full) into S, then W = C1 K12
  for (int e = t; e < n1 * n1; e += NT) {
    const int j = e / n1, k = e - j * n1;
    const float* ak = s.A + k * ldm + D.mo;
    const float* aj = s.A + (n1 + j) * ldm + D.mo;
    const float* rp = s.rho1 + D.mo;
    float acc = 0.f;
    for (int r = 0; r < D.mp; ++r) acc += ak[r] * (aj[r] * rp[r]);
    s.S[j * ldn + k] = acc;
  }
  __syncthreads();
  for (int e = t; e < n1 * n1; e += NT) {
    const int j = e / n1, i = e - j * n1;
    const float* kj = s.S + j * ldn;
    float acc = 0.f;
    for (int k = 0; k <= i; ++k) acc += s.C1[k * ldn + i] * kj[k];
    s.W[j * ldn + i] = acc;
  }
  __syncthreads();
  // S = K22 - W'W (lower triangle)
  for (int e = t; e < n1 * n1; e += NT) {
    const int j = e / n1, i = e - j * n1;
    if (i >= j) {
      const float* ai = s.A + (n1 + i) * ldm;
      const float* aj = s.A + (n1 + j) * ldm;
      float acc = 0.f;
      for (int r = 0; r < D.m1; ++r) acc += ai[r] * (aj[r] * s.rho2[r]);
      const float* wi = s.W + i * ldn;
      const float* wj = s.W + j * ldn;
      float ww = 0.f;
      for (int k = 0; k < n1; ++k) ww += wi[k] * wj[k];
      float v = acc + H2[i * n1 + j];
      if (i == j) v += diag;
      s.S[j * ldn + i] = v - ww;
    }
  }
  __syncthreads();
  chol(s.S, n1, ldn);
  trtri(s.S, n1, ldn, s.ts);
}

// x = K^-1 r: r in rs, x into xs.  Ends synchronized.
__device__ inline void schur_solve(const Solver& s) {
  const int n1 = s.D.n1, ldn = s.D.ldn, t = threadIdx.x;
  float* t1 = s.ts;
  float* u2 = s.ts + n1;
  float* t2 = s.us;
  float* v1 = s.us + n1;
  if (t < n1) {
    float acc = 0.f;
    for (int k = 0; k <= t; ++k) acc += s.C1[k * ldn + t] * s.rs[k];
    t1[t] = acc;
  }
  __syncthreads();
  if (t < n1) {
    const float* wc = s.W + t * ldn;
    float acc = 0.f;
    for (int k = 0; k < n1; ++k) acc += wc[k] * t1[k];
    t2[t] = s.rs[n1 + t] - acc;
  }
  __syncthreads();
  if (t < n1) {
    float acc = 0.f;
    for (int k = 0; k <= t; ++k) acc += s.S[k * ldn + t] * t2[k];
    u2[t] = acc;
  }
  __syncthreads();
  if (t < n1) {
    const float* sc = s.S + t * ldn;
    float acc = 0.f;
    for (int k = t; k < n1; ++k) acc += sc[k] * u2[k];
    s.xs[n1 + t] = acc;
  }
  __syncthreads();
  if (t < n1) {
    float acc = 0.f;
    for (int k = 0; k < n1; ++k) acc += s.W[k * ldn + t] * s.xs[n1 + k];
    v1[t] = t1[t] - acc;
  }
  __syncthreads();
  if (t < n1) {
    const float* cc = s.C1 + t * ldn;
    float acc = 0.f;
    for (int k = t; k < n1; ++k) acc += cc[k] * v1[k];
    s.xs[t] = acc;
  }
  __syncthreads();
}

// One adaptive-rho segment of ``iters`` ADMM iterations from the carry in
// ``o`` (and x in xs).  Ends synchronized.
template <int RM>
__device__ void segment(const Solver& s, Own<RM>& o, int iters) {
  const Dims& D = s.D;
  const int t = threadIdx.x, n2 = 2 * D.n1;
  const float one_m_alpha = 1.f - s.alpha;
  // the rows' penalties, into the per-player column vectors
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    const int q = t + NT * k;
    if (q < D.R) {
      o.ro[k] = o.eq[k] ? 1e3f * o.rho : o.rho;
      if (q < D.mo) {
        s.rho1[q] = o.ro[k];
      } else if (q < 2 * D.mo) {
        s.rho2[q - D.mo] = o.ro[k];
      } else {
        s.rho1[q - D.mo] = o.ro[k];
        s.rho2[q - D.mo] = o.ro[k];
      }
    }
  }
  __syncthreads();
  factor(s, o.rho);

  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      const int q = t + NT * k;
      if (q < D.R) s.ws[q] = o.ro[k] * o.z[k] - o.y[k];
    }
    __syncthreads();
    if (t < n2)
      s.rs[t] = ((s.sigma * o.x - o.g) + at_row(s, t, s.ws)) +
                (o.rho * o.zx - o.yx);
    __syncthreads();
    schur_solve(s);
    if (t < n2) {
      o.x = s.xs[t];
      const float zt = s.alpha * o.x + one_m_alpha * o.zx;
      const float zn = fminf(fmaxf(zt + o.yx / o.rho, o.lx), o.ux);
      o.yx = o.yx + o.rho * (zt - zn);
      o.zx = zn;
    }
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      const int q = t + NT * k;
      if (q < D.R) {
        const float a = ax_row(s, q);
        o.ax[k] = a;
        const float zt = s.alpha * a + one_m_alpha * o.z[k];
        const float zn = fminf(fmaxf(zt + o.y[k] / o.ro[k], o.lo[k]),
                               o.hi[k]);
        o.y[k] = o.y[k] + o.ro[k] * (zt - zn);
        o.z[k] = zn;
      }
    }
  }

  // residuals (ax is the last iteration's, from the final x) and rho
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    const int q = t + NT * k;
    if (q < D.R) {
      s.ws[q] = o.y[k];
      v[0] = fmaxf(v[0], fabsf(o.ax[k] - o.z[k]));
      v[1] = fmaxf(v[1], fabsf(o.ax[k]));
      v[2] = fmaxf(v[2], fabsf(o.z[k]));
    }
  }
  __syncthreads();
  if (t < n2) {
    v[0] = fmaxf(v[0], fabsf(o.x - o.zx));
    v[1] = fmaxf(v[1], fabsf(o.x));
    v[2] = fmaxf(v[2], fabsf(o.zx));
    const int p = t >= D.n1 ? 1 : 0;
    const float* h = s.H + (size_t)t * D.n1;        // row t - p n1 of H_p
    const float* xp = s.xs + p * D.n1;
    float hx = 0.f;
    for (int j = 0; j < D.n1; ++j) hx += h[j] * xp[j];
    const float aty = at_row(s, t, s.ws) + o.yx;
    v[3] = fabsf(hx + o.g + aty);
    v[4] = fabsf(hx);
    v[5] = fabsf(aty);
    v[6] = fabsf(o.g);
  }
  block_max(v, s.red);
  o.prim = v[0];
  o.dual = v[3];
  o.p_sc = fmaxf(v[1], v[2]) + 1e-9f;
  o.d_sc = fmaxf(fmaxf(v[4], v[5]), v[6]) + 1e-9f;
  const float ratio = sqrtf((o.prim / o.p_sc) / (o.dual / o.d_sc + 1e-12f));
  o.rho = fminf(fmaxf(o.rho * fminf(fmaxf(ratio, 0.2f), 5.0f), 1e-6f), 1e8f);
}

// rho0 = clip(tr(H) / n, 1e-3, 1e6) rho, the trace summed in order by one
// thread; every thread's variable and row registers cleared.
template <int RM>
__device__ inline void cold_start(const Solver& s, Own<RM>& o, float rho,
                                  float inv_n2) {
  const int n1 = s.D.n1;
  if (threadIdx.x == 0) {
    float tr = 0.f;
    for (int p = 0; p < 2; ++p)
      for (int j = 0; j < n1; ++j) tr = tr + s.H[(p * n1 + j) * n1 + j];
    s.red[0] = tr;
  }
  __syncthreads();
  o.rho = fminf(fmaxf(s.red[0] * inv_n2, 1e-3f), 1e6f) * rho;
  __syncthreads();
  o.x = o.zx = o.yx = 0.f;
#pragma unroll
  for (int k = 0; k < RM; ++k) o.z[k] = o.y[k] = o.ax[k] = 0.f;
}

// x (2 n1) and stats (5) = [converged, prim, dual, p_sc, d_sc] of problem b.
template <int RM>
__device__ inline void write_out(const Solver& s, const Own<RM>& o, int b,
                                 float tol, float dual_tol, float* xout,
                                 float* stats) {
  const int n2 = 2 * s.D.n1, t = threadIdx.x;
  if (t < n2) xout[(size_t)b * n2 + t] = o.x;
  if (t == 0) {
    const bool conv = (o.prim < tol * o.p_sc) && (o.dual < dual_tol * o.d_sc);
    float* st = stats + (size_t)b * 5;
    st[0] = conv ? 1.f : 0.f;
    st[1] = o.prim;
    st[2] = o.dual;
    st[3] = o.p_sc;
    st[4] = o.d_sc;
  }
}

}  // namespace joint

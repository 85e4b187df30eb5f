// The knot-structured SQP machinery shared by K3 (csrc/dmpc_sqp.cu) and K4
// (csrc/cmpc_sqp.cu), written by hand for Hopper (sm_90a).
//
// Every constraint row of the DMPC and CMPC SQPs is a scaled combination
// of the two rows (x and y) of the position sensitivity SG at one knot:
// an arena row is d sgx[k] or d sgy[k], a keepout row (m, k) is
// (cx sgx[k] + cy sgy[k]) with (cx, cy) = 2 d (dx, dy), and a pair row k is
// +-(cpx sg_p x[k] + cpy sg_p y[k]).  So the kernels never store A:
//
//   A x   = the rows' coefficients applied to the knot increments Y = SG x
//           (2N dot products of length n1 a player);
//   A'w   = SG' u with u the rows' coefficients times w folded into their
//           knots' x and y entries (one dot product of length 2N a variable);
//   A'A   = SG' Q SG with Q block-diagonal, 2 x 2 a knot (form_k);
//   K12   = P1' P2 summed over the N knots as rank-1 terms (cmpc_sqp.cu).
//
// What this header holds:
//
//   row_dot / col_dot / dot4: the matrix-vector products an iteration
//     runs, each output's dot split into four independent partial sums over
//     float4 loads of the vector (dependent chains of n/4 terms);
//   form_k: K = H + rho SG'Q SG + diag I (lower triangle) in 2 x 2 tiles
//     spread over the team, optionally less W'W (the Schur complement);
//   chol_inv: the Cholesky factor and its inverse C = L^-1 in one sweep, in
//     place, BS (4, or 2) columns a step: every thread factors and inverts
//     the diagonal block in registers, the team computes the block's
//     columns of L and rows of C, then updates in one pass both the
//     trailing matrix (rank BS) and the rows of C below the block; two
//     barriers a step, every thread on one or two columns;
//   keepout_row: a keepout row's scale, lower bound and coefficients at
//     the linearization point.
//
// A "team" solves one problem: a warp (K3, barrier __syncwarp) or a block
// (K4, barrier __syncthreads).  Matrices are column-major, M[i][j] at
// j ld + i with an odd ld (conflict-free when the lanes walk a column or a
// row); SG is row-major, row k at k lds with lds a multiple of 4 (float4
// and float2 loads).  Vectors read through float4 are 16-byte aligned and
// padded with zeros to a multiple of 4, as are the matrices' rows and
// columns beyond n, so every product may run to the padded length.
//
// Numerics: IEEE division and square root; sums run in another order than
// the plain PyTorch versions' batched products, so the kernels are held to
// them by tolerance.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace knot {

constexpr int WARP = 32;
constexpr size_t SMEM_MAX = 232448;     // a block's shared memory on H100

struct WarpTeam {
  static constexpr int NT = WARP;
  __device__ static void sync() { __syncwarp(); }
};

template <int NT_>
struct BlockTeam {
  static constexpr int NT = NT_;
  __device__ static void sync() { __syncthreads(); }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// sum_k M[k ld + i] v[k] over k in [k0, k0 + n): row i of a column-major
// M (or column i of SG' for SG row-major with ld = lds); k0 and n multiples
// of 4.
__device__ __forceinline__ float row_dot(const float* M, int ld, int i,
                                         const float* v, int k0, int n) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  const float* m = M + k0 * ld + i;
#pragma unroll
  for (int s = 0; s < n; s += 4, m += 4 * ld) {
    const float4 w = ld4(v + k0 + s);
    a0 += m[0] * w.x;
    a1 += m[ld] * w.y;
    a2 += m[2 * ld] * w.z;
    a3 += m[3 * ld] * w.w;
  }
  return (a0 + a1) + (a2 + a3);
}

// sum_k M[i ld + k] v[k] over k in [k0, k0 + n): column i of a
// column-major M, that is row i of M'; k0 and n multiples of 4.
__device__ __forceinline__ float col_dot(const float* M, int ld, int i,
                                         const float* v, int k0, int n) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  const float* m = M + i * ld;
#pragma unroll
  for (int s = 0; s < n; s += 4) {
    const int k = k0 + s;
    const float4 w = ld4(v + k);
    a0 += m[k] * w.x;
    a1 += m[k + 1] * w.y;
    a2 += m[k + 2] * w.z;
    a3 += m[k + 3] * w.w;
  }
  return (a0 + a1) + (a2 + a3);
}

// sum_k a[k] v[k] over [0, n), both 16-byte aligned, n a multiple of 4.
__device__ __forceinline__ float dot4(const float* a, const float* v, int n) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int k = 0; k < n; k += 4) {
    const float4 x = ld4(a + k), w = ld4(v + k);
    a0 += x.x * w.x;
    a1 += x.y * w.y;
    a2 += x.z * w.z;
    a3 += x.w * w.w;
  }
  return (a0 + a1) + (a2 + a3);
}

// Block-wide maxima of NV values over NT threads, returned to every
// thread; red holds NV NT / 32 floats.  Ends synchronized.
template <int NT, int NV>
__device__ inline void block_max(float (&v)[NV], float* red) {
  constexpr int NW = NT / WARP;
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP;
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

// K = H + rho SG'Q SG + diag I [- W'W] into M (lower triangle, the strict
// upper triangle set to 0), n1 = 2N variables in 2 x 2 tiles over the team:
// SG rows k (x) and N + k (y) at k lds; qs[4k..4k+2] = (qxx, qxy, qyy) of
// knot k; H (n1, n1) row-major in device memory; W column-major (ldw) or
// null.  Thread t of the team; does not synchronize.
template <int NT>
__device__ __forceinline__ void form_k(float* M, int ld, const float* SG,
                                       int lds, const float* qs, int N,
                                       const float* H, float rho, float diag,
                                       const float* W, int ldw, int n1pad,
                                       int t) {
  const int n1 = 2 * N, nt = N;
  const int tiles = nt * (nt + 1) / 2;
  int I = 0, J = t;                      // tile e = I (I + 1) / 2 + J
  while (J > I) {
    J -= I + 1;
    ++I;
  }
  for (int e = t; e < tiles; e += NT) {
    const int i0 = 2 * I, j0 = 2 * J;
    const float* h0 = H + i0 * n1 + j0;
    const float* h1 = h0 + n1;
    const float h00 = h0[0], h01 = h0[1], h10 = h1[0], h11 = h1[1];
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float4 q = ld4(qs + 4 * k);
      const float2 xi = ld2(SG + k * lds + i0);
      const float2 yi = ld2(SG + (N + k) * lds + i0);
      const float2 xj = ld2(SG + k * lds + j0);
      const float2 yj = ld2(SG + (N + k) * lds + j0);
      const float vx0 = q.x * xj.x + q.y * yj.x;
      const float vx1 = q.x * xj.y + q.y * yj.y;
      const float vy0 = q.y * xj.x + q.z * yj.x;
      const float vy1 = q.y * xj.y + q.z * yj.y;
      a00 += xi.x * vx0;
      a00 += yi.x * vy0;
      a01 += xi.x * vx1;
      a01 += yi.x * vy1;
      a10 += xi.y * vx0;
      a10 += yi.y * vy0;
      a11 += xi.y * vx1;
      a11 += yi.y * vy1;
    }
    float k00 = h00 + rho * a00, k01 = h01 + rho * a01;
    float k10 = h10 + rho * a10, k11 = h11 + rho * a11;
    if (I == J) {
      k00 += diag;
      k11 += diag;
    }
    if (W != nullptr) {
      float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f;
      const float* wi0 = W + i0 * ldw;
      const float* wi1 = wi0 + ldw;
      const float* wj0 = W + j0 * ldw;
      const float* wj1 = wj0 + ldw;
#pragma unroll
      for (int l = 0; l < n1pad; ++l) {
        w00 += wi0[l] * wj0[l];
        w01 += wi0[l] * wj1[l];
        w10 += wi1[l] * wj0[l];
        w11 += wi1[l] * wj1[l];
      }
      k00 -= w00;
      k01 -= w01;
      k10 -= w10;
      k11 -= w11;
    }
    M[j0 * ld + i0] = k00;
    M[j0 * ld + i0 + 1] = k10;
    M[(j0 + 1) * ld + i0 + 1] = k11;
    // (i0, j0 + 1) is below the diagonal off the diagonal tiles; the
    // mirror entries are the strict upper triangle
    M[(j0 + 1) * ld + i0] = I == J ? 0.f : k01;
    if (I != J) {
      M[i0 * ld + j0] = 0.f;
      M[i0 * ld + j0 + 1] = 0.f;
      M[(i0 + 1) * ld + j0] = 0.f;
      M[(i0 + 1) * ld + j0 + 1] = 0.f;
    }
    J += NT;
    while (J > I) {
      J -= I + 1;
      ++I;
    }
  }
}

// In place over the lower triangle of the n x n column-major M (ld), n a
// multiple of BS: the Cholesky factor L of M and then C = L^-1, in one
// right-looking sweep BS columns a step.  Phase A: every thread factors
// the BS x BS diagonal block and inverts it in registers (L_bb, X_bb); the
// team writes the block's columns of L below it into col (column j + a at
// a n) and its rows of C left of it (C_j+a,c = (P_j+a,c - sum_k<a L_j+a,j+k
// C_j+k,c) / l_j+a,j+a).  Phase B, for every row i >= j + BS in one pass:
// the rank-BS trailing update M_ic -= sum_a L_i,j+a L_c,j+a (j + BS <= c
// <= i) and the inverse's partial sums P_ic -= sum_a L_i,j+a C_j+a,c (c <
// j + BS).  Each subtraction runs in the order of the unblocked
// algorithm; divisions are products with the IEEE reciprocal.  Thread t
// owns columns t, t + NT, ..., or, where the team has two threads a column
// (2 n <= NT), threads 2c and 2c + 1 share column c's rows by parity; the
// strict upper triangle is not touched.  Begins after and ends with a
// barrier of the team; col holds BS n floats.
template <class Team, int BS>
__device__ __forceinline__ void chol_inv(float* __restrict__ M, int n, int ld,
                                         float* __restrict__ col, int t) {
  constexpr int NT = Team::NT;
  constexpr int RC = (64 + NT - 1) / NT;    // columns a thread (n <= 64)
#pragma unroll 1
  for (int j = 0; j < n; j += BS) {
    float L[BS][BS], X[BS][BS], inv[BS];
#pragma unroll
    for (int a = 0; a < BS; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) L[a][b] = M[(j + b) * ld + j + a];
    }
#pragma unroll
    for (int b = 0; b < BS; ++b) {
      float d = L[b][b];
#pragma unroll
      for (int k = 0; k < b; ++k) d -= L[b][k] * L[b][k];
      L[b][b] = sqrtf(d);
      inv[b] = 1.0f / L[b][b];
#pragma unroll
      for (int a = b + 1; a < BS; ++a) {
        float v = L[a][b];
#pragma unroll
        for (int k = 0; k < b; ++k) v -= L[a][k] * L[b][k];
        L[a][b] = v * inv[b];
      }
    }
#pragma unroll
    for (int a = 0; a < BS; ++a) {
      X[a][a] = inv[a];
#pragma unroll
      for (int c = 0; c < a; ++c) {
        float v = 0.f;
#pragma unroll
        for (int k = c; k < a; ++k) v -= L[a][k] * X[k][c];
        X[a][c] = v * inv[a];
      }
    }
    for (int i = j + BS + t; i < n; i += NT) {
      float li[BS];
#pragma unroll
      for (int b = 0; b < BS; ++b) {
        float v = M[(j + b) * ld + i];
#pragma unroll
        for (int k = 0; k < b; ++k) v -= li[k] * L[b][k];
        li[b] = v * inv[b];
        col[b * n + i] = li[b];
      }
    }
    for (int c = t; c < j; c += NT) {
      float xr[BS];
#pragma unroll
      for (int a = 0; a < BS; ++a) {
        float v = M[c * ld + j + a];
#pragma unroll
        for (int k = 0; k < a; ++k) v -= L[a][k] * xr[k];
        xr[a] = v * inv[a];
        M[c * ld + j + a] = xr[a];
      }
    }
    Team::sync();
    // column c's multipliers s of the block's columns, its first row and
    // whether it is a column of L becoming C's
    auto column = [&](int c, float (&s)[BS], int& lo, bool& fresh) {
      lo = c >= j + BS ? c : j + BS;
      fresh = c >= j && c < j + BS;
#pragma unroll
      for (int a = 0; a < BS; ++a) s[a] = 0.f;
      if (c < j) {
#pragma unroll
        for (int a = 0; a < BS; ++a) s[a] = M[c * ld + j + a];
      } else if (fresh) {
#pragma unroll
        for (int cb = 0; cb < BS; ++cb) {
          if (c == j + cb) {
#pragma unroll
            for (int a = cb; a < BS; ++a) s[a] = X[a][cb];
          }
        }
      } else if (c < n) {
#pragma unroll
        for (int a = 0; a < BS; ++a) s[a] = col[a * n + c];
      } else {
        lo = n;
      }
    };
    auto update = [&](int c, int i, const float (&s)[BS], bool fresh) {
      float* m = M + c * ld + i;
      float v = fresh ? 0.f : *m;
#pragma unroll
      for (int a = 0; a < BS; ++a) v -= col[a * n + i] * s[a];
      *m = v;
    };
    if (2 * n <= NT) {             // two threads a column, rows by parity
      float s[BS];
      int lo;
      bool fresh;
      const int c = t >> 1;
      column(c, s, lo, fresh);
#pragma unroll 4
      for (int i = j + BS + (t & 1); i < n; i += 2)
        if (i >= lo) update(c, i, s, fresh);
    } else {                       // one thread a column
      float s[RC][BS];
      int lo[RC];
      bool fresh[RC];
#pragma unroll
      for (int q = 0; q < RC; ++q) column(t + NT * q, s[q], lo[q], fresh[q]);
#pragma unroll 2
      for (int i = j + BS; i < n; ++i) {
#pragma unroll
        for (int q = 0; q < RC; ++q)
          if (i >= lo[q]) update(t + NT * q, i, s[q], fresh[q]);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < BS; ++b) {
#pragma unroll
        for (int a = b; a < BS; ++a) M[(j + b) * ld + j + a] = X[a][b];
      }
    }
    Team::sync();
  }
}

// Keepout row at a knot: position (accx, accy), free response (p0x, p0y),
// gram terms of the knot's sensitivity rows, obstacle (ox, oy), squared
// clearance d2.  The row is 2 (dx sgx + dy sgy) scaled by d = 1 / max(norm,
// 1e-8): its coefficients (cx, cy) = 2 d (dx, dy) and lower bound rhs d
// (the upper bound is 1e9 d).
__device__ __forceinline__ void keepout_row(float accx, float accy, float p0x,
                                            float p0y, float gxx, float gxy,
                                            float gyy, float ox, float oy,
                                            float d2, float& d, float& lo,
                                            float& cx, float& cy) {
  const float dx = accx - ox, dy = accy - oy;
  const float nrm =
      2.f * sqrtf(dx * dx * gxx + 2.f * dx * dy * gxy + dy * dy * gyy);
  const float gval = dx * dx + dy * dy - d2;
  const float rhs = 2.f * (dx * accx + dy * accy) - gval -
                    2.f * (dx * p0x + dy * p0y);
  d = 1.f / fmaxf(nrm, 1e-8f);
  lo = rhs * d;
  cx = (2.f * dx) * d;
  cy = (2.f * dy) * d;
}

// The alpha-relaxed ADMM update of one row (or box variable) with value a
// = A x, bounds [lo, hi] and penalty rho: z and the dual y in place.
__device__ __forceinline__ void admm_row(float a, float lo, float hi,
                                         float rho, float alpha, float& z,
                                         float& y) {
  const float zt = alpha * a + (1.f - alpha) * z;
  const float zn = fminf(fmaxf(zt + y / rho, lo), hi);
  y = y + rho * (zt - zn);
  z = zn;
}

}  // namespace knot

// The structured two-agent ADMM QP solve of K5 (csrc/qp_joint.cu), written
// by hand for Hopper (sm_90a), on a general A.  (K4, whose rows are knot
// combinations of the position sensitivities, has its own machinery in
// csrc/knot_sqp.cuh; both take their Cholesky factors and inverses from
// knot::chol_inv.)
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
//   K11 = H1 + (sigma + rho) I + A1' R1 A1, C1 = chol(K11)^-1,
//   K12 = P1' Rp P2, W = C1 K12, S = K22 - W'W, Cs = chol(S)^-1,
//   B21 = -Cs W' C1, so that L^-1 = [[C1, 0], [B21, Cs]] is the inverse of
//   K's Cholesky factor; each ADMM iteration solves K x = r as
//   t = L^-1 r (t1 = C1 r1, t2 = B21 r1 + Cs r2) and x = L^-T t (x1 =
//   C1't1 + B21't2, x2 = Cs't2); then the alpha-relaxed z and y updates of
//   the box rows (scalar rho) and of the constraint rows (rho, 1e3 rho on
//   equality rows); then the residuals and rho <- clip(rho clip(sqrt(ratio),
//   0.2, 5), 1e-6, 1e8).
//
// Design: one block of NT = 160 threads (five warps) per problem, every
// thread busy in every stage of an iteration:
//   * the 2 n1 = 80 variables' products (A'w, t = L^-1 r, x = L^-T t) run
//     on two lanes a variable, each taking half of the terms (A'w: half of
//     the rows; L^-1 r, L^-T t: every other block of four) with the vector
//     read as float4, a shuffle adding the halves; lane 0 of the pair owns
//     the variable (its x, z, y, g and box in registers);
//   * thread t owns own row t (160 at CMPC's shape; its z, y, bounds and
//     rho in registers) and computes its A x dot; pair row r's 80-term dot
//     runs on PC = 8 lanes, every eighth term each, shuffles adding the
//     parts, lane 0 of the eight owning the row;
//   * an iteration is four stages, each ended by one barrier: A'w and the
//     right-hand side; t; x; the box and row updates (which write the next
//     w);
//   * a segment's factorization forms K11, K22 and K12 in 4 x 4 tiles
//     spread over the block, takes the Cholesky factors and their inverses
//     from knot::chol_inv (one right-looking sweep, four columns a step),
//     and W, S, V = W'C1 and B21 in 4 x 4 tiles read as float4 blocks, each
//     tile's products summed in the order of the unblocked algorithm.
// Shared memory holds A, C1, B21 (where K12, then W, then V stood), Cs
// (where K22, then S stood) and the vectors: 57,184 bytes a problem at
// CMPC's shape, four problems (20 warps) an SM (the kernel is built for
// 96 registers a thread).  H stays in device memory (read once per
// segment and for the residuals, through L1/L2).  CMPC's shape (n1 = 40,
// mo = 80, mp = 20) runs a kernel with the shape fixed at compile time;
// every other supported shape the same code with the shape read at run
// time (one lane a pair row, two problems an SM).
//
// Numerics: no fast math, IEEE division and square root, no FMA
// contraction (kernels.py's flag table: with FMA the kernel ran 3% faster
// but lay further from the f64 solution, profile_sqp.py).  Sums run in
// another order than the plain PyTorch version's batched products
// (ops/qp_lanes.py::joint_plain_stats, which repeats this algebra), so the
// two are held by tolerance.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "knot_sqp.cuh"

namespace joint {

constexpr int WARP = 32;
constexpr int NT = 160;                 // threads of one problem's block
constexpr int NW = NT / WARP;
constexpr int MAX_N1 = 64;
constexpr int MAX_R = 512;
constexpr size_t SMEM_MAX = knot::SMEM_MAX;
constexpr unsigned FULL = 0xffffffffu;
using Team = knot::BlockTeam<NT>;

// m1p: a player's rows padded with zeros to a multiple of 8, so that each
// half of A'w is a multiple of 4 long (float4 loads); ldm = m1p and ldc =
// n1 + 4 keep those loads 16-byte aligned and, at CMPC's shape, the lanes
// of a product on distinct banks.
struct Dims {
  int n1, mo, mp, m1, m1p, R, ldm, ldc;
};

__host__ __device__ __forceinline__ Dims dims(int n1, int mo, int mp) {
  Dims d;
  d.n1 = n1;
  d.mo = mo;
  d.mp = mp;
  d.m1 = mo + mp;
  d.m1p = (d.m1 + 7) & ~7;
  d.R = 2 * mo + mp;
  d.ldm = d.m1p;
  d.ldc = n1 + 4;
  return d;
}

// Shared floats of the solver: A, C1, F2 (K12 -> W -> V -> B21), S (K22 ->
// S -> Cs), the per-player views of the row penalties and of the row
// vector w (2 m1p each), the vectors rs, ts (the right-hand side and t =
// L^-1 r; chol_inv's 4 n1 columns in between) and xs (2 n1 each), and the
// reduction scratch (8 NW); every piece a multiple of 4 floats.
__host__ __device__ __forceinline__ int solver_floats(const Dims& d) {
  return 2 * d.n1 * d.ldm + 3 * d.n1 * d.ldc + 4 * d.m1p + 6 * d.n1 + 8 * NW;
}

struct Solver {
  Dims D;
  float* A;     // A[p][j][r] at (p n1 + j) ldm + r
  float* C1;    // n1 x n1 column-major: M[i][j] at j ldc + i
  float* F2;
  float* S;
  float* rho;   // rho1 then rho2 (m1p each): the rows' penalties by player
  float* w;     // w1 then w2 (m1p each, zero padded): the row vector
  float* rs;    // the iteration's right-hand side (2 n1)
  float* ts;    // t = L^-1 rs (2 n1)
  float* xs;    // x (2 n1)
  float* red;   // reduction scratch
  const float* H;  // this problem's blocks (2, n1, n1) in device memory
  float sigma, alpha;
};

__device__ __forceinline__ Solver carve(float* smem, const Dims& D,
                                        const float* H, float sigma,
                                        float alpha) {
  Solver s;
  s.D = D;
  s.A = smem;
  s.C1 = s.A + 2 * D.n1 * D.ldm;
  s.F2 = s.C1 + D.n1 * D.ldc;
  s.S = s.F2 + D.n1 * D.ldc;
  s.rho = s.S + D.n1 * D.ldc;
  s.w = s.rho + 2 * D.m1p;
  s.rs = s.w + 2 * D.m1p;
  s.ts = s.rs + 2 * D.n1;
  s.xs = s.ts + 2 * D.n1;
  s.red = s.xs + 2 * D.n1;
  s.H = H;
  s.sigma = sigma;
  s.alpha = alpha;
  return s;
}

// The registers of one thread.  Variable task k is tau = t + NT k (tau < 4
// n1): variable tau / 2, half tau % 2, owned by half 0.  Row task k is tau
// = t + NT k (tau < 2 mo + PC mp): own row tau, or part (tau - 2 mo) % PC of
// pair row (tau - 2 mo) / PC, owned by part 0.
template <int PV, int RM>
struct Own {
  float x[PV], zx[PV], yx[PV], g[PV], lx[PV], ux[PV];
  float z[RM], y[RM], lo[RM], hi[RM], ro[RM], ax[RM];
  bool eq[RM];
  float rho;                                   // the box rows' rho
  float prim, dual, p_sc, d_sc;                // the last segment's
};

// sum over the blocks of 4 at k = k0, k0 + step, ... below k1 of m[k st]
// v[k]: v read as float4 (16-byte aligned, k0 and step multiples of 4),
// four partial sums.
__device__ __forceinline__ float dot_v4(const float* m, int st,
                                        const float* v, int k0, int k1,
                                        int step) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int k = k0; k < k1; k += step) {
    const float4 w = knot::ld4(v + k);
    a0 += m[k * st] * w.x;
    a1 += m[(k + 1) * st] * w.y;
    a2 += m[(k + 2) * st] * w.z;
    a3 += m[(k + 3) * st] * w.w;
  }
  return (a0 + a1) + (a2 + a3);
}

// The same with m contiguous (st = 1), both read as float4.
__device__ __forceinline__ float dot_44(const float* m, const float* v,
                                        int k0, int k1, int step) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int k = k0; k < k1; k += step) {
    const float4 a = knot::ld4(m + k), w = knot::ld4(v + k);
    a0 += a.x * w.x;
    a1 += a.y * w.y;
    a2 += a.z * w.z;
    a3 += a.w * w.w;
  }
  return (a0 + a1) + (a2 + a3);
}

// Lower 4 x 4 tile e of an nb x nb tile triangle: (I, J), J <= I.
__device__ __forceinline__ void tri_tile(int e, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= e) ++I;
  J = e - I * (I + 1) / 2;
}

// Tile (i0, j0) of M (ld) from acc: the lower triangle (i >= j) as given,
// the strict upper triangle 0; `full` writes every entry.
__device__ __forceinline__ void put_tile(float* M, int ld, int i0, int j0,
                                         const float (&acc)[4][4],
                                         bool full) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + a, j = j0 + b;
      if (full || i >= j) {
        M[j * ld + i] = acc[a][b];
        if (!full && i > j) M[i * ld + j] = 0.f;
      } else {
        M[j * ld + i] = 0.f;
      }
    }
  }
}

// The 4 x 4 block x[a][kk] = X(a, k + kk) of a matrix in shared memory,
// read as four float4: X(a, k) at base + a ld + k (ALONG_K, each row a
// float4 along k) or at base + k ld + a (each k a float4 along a); 16-byte
// aligned.
template <bool ALONG_K>
__device__ __forceinline__ void blk(const float* base, int ld, int k,
                                    float (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = ALONG_K ? knot::ld4(base + i * ld + k)
                             : knot::ld4(base + (k + i) * ld);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ALONG_K)
        x[i][j] = e[j];
      else
        x[j][i] = e[j];
    }
  }
}

// acc[a][b] += sum_kk x[a][kk] y[b][kk], each entry's terms in k order.
__device__ __forceinline__ void mac(float (&acc)[4][4],
                                    const float (&x)[4][4],
                                    const float (&y)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += x[a][kk] * y[b][kk];
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// K11 -> C1, K22 -> S (lower triangles, strict upper 0) and K12 -> F2
// (full) at the row penalties in s.rho and diag = sigma + rho, in 4 x 4
// tiles: Kpp(i, j) = sum_r A(r, i) (A(r, j) rho_r) over the player's
// (zero-padded) rows, + Hp(i, j) (+ diag).  Does not synchronize.
__device__ __forceinline__ void form(const Solver& s, float diag) {
  const Dims& D = s.D;
  const int n1 = D.n1, ldm = D.ldm, ldc = D.ldc, t = threadIdx.x;
  const int nb = n1 / 4, tri = nb * (nb + 1) / 2;
  for (int e = t; e < 2 * tri + nb * nb; e += NT) {
    float acc[4][4];
    zero(acc);
    if (e < 2 * tri) {                 // K11 (p = 0) or K22 (p = 1)
      const int p = e < tri ? 0 : 1;
      int I, J;
      tri_tile(e - p * tri, I, J);
      const int i0 = 4 * I, j0 = 4 * J;
      const float* ai = s.A + (p * n1 + i0) * ldm;
      const float* aj = s.A + (p * n1 + j0) * ldm;
      const float* rp = s.rho + p * D.m1p;
#pragma unroll 2
      for (int r = 0; r < D.m1p; r += 4) {
        float x[4][4], y[4][4];
        blk<true>(ai, ldm, r, x);
        blk<true>(aj, ldm, r, y);
        const float4 rr = knot::ld4(rp + r);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          y[b][0] = y[b][0] * rr.x;
          y[b][1] = y[b][1] * rr.y;
          y[b][2] = y[b][2] * rr.z;
          y[b][3] = y[b][3] * rr.w;
        }
        mac(acc, x, y);
      }
      const float* H = s.H + p * n1 * n1;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + a, j = j0 + b;
          float k = acc[a][b] + H[i * n1 + j];
          if (i == j) k += diag;
          acc[a][b] = k;
        }
      put_tile(p == 0 ? s.C1 : s.S, ldc, i0, j0, acc, false);
    } else {                           // K12 = P1' Rp P2
      const int f = e - 2 * tri, I = f / nb, J = f - I * nb;
      const int i0 = 4 * I, j0 = 4 * J;
      const float* ai = s.A + i0 * ldm + D.mo;
      const float* aj = s.A + (n1 + j0) * ldm + D.mo;
      const float* rp = s.rho + D.mo;
      for (int r = 0; r < D.mp; ++r) {
        const float rr = rp[r];
        float u[4], v[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          u[a] = ai[a * ldm + r];
          v[a] = aj[a * ldm + r] * rr;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += u[a] * v[b];
      }
      put_tile(s.F2, ldc, i0, j0, acc, true);
    }
  }
}

// The factors of K at the row penalties in s.rho and the box rows' rho:
// C1, B21 (in F2) and Cs (in S); PT full 4 x 4 tiles a thread (nb^2 <= PT
// NT).  The triangular factors' strict upper triangles are 0, so each
// product runs over whole blocks of 4.  Begins after and ends with a
// barrier.
template <int PT>
__device__ __forceinline__ void factor(const Solver& s, float rho) {
  const Dims& D = s.D;
  const int n1 = D.n1, ldc = D.ldc, t = threadIdx.x;
  const int nb = n1 / 4, tri = nb * (nb + 1) / 2;
  float* col = s.rs;                   // chol_inv's 4 n1 columns (rs, ts)
  float keep[PT][4][4];
  // tile (I, J) of the full n1 x n1 products, or none
  auto tile = [&](int q, int& i0, int& j0) {
    const int e = t + NT * q;
    i0 = 4 * (e / nb);
    j0 = 4 * (e % nb);
    return e < nb * nb;
  };
  auto store = [&]() {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      int i0, j0;
      if (tile(q, i0, j0)) put_tile(s.F2, ldc, i0, j0, keep[q], true);
    }
    __syncthreads();
  };
  form(s, s.sigma + rho);
  __syncthreads();
  knot::chol_inv<Team, 4>(s.C1, n1, ldc, col, t);
  // W = C1 K12: W(i, j) = sum_k C1(i, k) K12(k, j), k < i0 + 4
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    int i0, j0;
    if (!tile(q, i0, j0)) continue;
    zero(keep[q]);
    for (int k = 0; k < i0 + 4; k += 4) {
      float x[4][4], y[4][4];
      blk<false>(s.C1 + i0, ldc, k, x);
      blk<true>(s.F2 + j0 * ldc, ldc, k, y);
      mac(keep[q], x, y);
    }
  }
  store();
  // S = K22 - W'W (lower, in place) and V = W'C1 (full; C1(k, j) = 0 for
  // k < j0)
  for (int e = t; e < tri; e += NT) {
    int I, J;
    tri_tile(e, I, J);
    const int i0 = 4 * I, j0 = 4 * J;
    float ww[4][4];
    zero(ww);
    for (int k = 0; k < n1; k += 4) {
      float x[4][4], y[4][4];
      blk<true>(s.F2 + i0 * ldc, ldc, k, x);
      blk<true>(s.F2 + j0 * ldc, ldc, k, y);
      mac(ww, x, y);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i >= j) s.S[j * ldc + i] = s.S[j * ldc + i] - ww[a][b];
      }
  }
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    int i0, j0;
    if (!tile(q, i0, j0)) continue;
    zero(keep[q]);
    for (int k = j0; k < n1; k += 4) {
      float x[4][4], y[4][4];
      blk<true>(s.F2 + i0 * ldc, ldc, k, x);
      blk<true>(s.C1 + j0 * ldc, ldc, k, y);
      mac(keep[q], x, y);
    }
  }
  store();
  knot::chol_inv<Team, 4>(s.S, n1, ldc, col, t);
  // B21 = -Cs V: -sum_k Cs(i, k) V(k, j), k < i0 + 4
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    int i0, j0;
    if (!tile(q, i0, j0)) continue;
    zero(keep[q]);
    for (int k = 0; k < i0 + 4; k += 4) {
      float x[4][4], y[4][4];
      blk<false>(s.S + i0, ldc, k, x);
      blk<true>(s.F2 + j0 * ldc, ldc, k, y);
      mac(keep[q], x, y);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) keep[q][a][b] = -keep[q][a][b];
  }
  store();
}

// Row task tau's row: its index q in [0, R), the part c of a pair row
// (0 for an own row) and whether the task exists.
template <int PC>
__device__ __forceinline__ void row_task(const Dims& D, int tau, int& q,
                                         int& c, bool& ok) {
  const int own = 2 * D.mo;
  ok = tau < own + PC * D.mp;
  if (tau < own) {
    q = tau;
    c = 0;
  } else {
    q = own + (tau - own) / PC;
    c = (tau - own) % PC;
  }
}

// Row q's slot in the per-player views (rho, w): w1 index, w2 index (-1
// where the row is not the player's).
__device__ __forceinline__ void row_views(const Dims& D, int q, int& i1,
                                          int& i2) {
  if (q < D.mo) {
    i1 = q;
    i2 = -1;
  } else if (q < 2 * D.mo) {
    i1 = -1;
    i2 = q - D.mo;
  } else {
    i1 = i2 = q - D.mo;
  }
}

__device__ __forceinline__ void put_row(float* v, const Dims& D, int q,
                                        float val) {
  int i1, i2;
  row_views(D, q, i1, i2);
  if (i1 >= 0) v[i1] = val;
  if (i2 >= 0) v[D.m1p + i2] = val;
}

// (A x)[q], part c of PC (a pair row's columns c, c + PC, ... of [x1; x2]
// on lane c of PC), at the x in xs.
template <int PC>
__device__ __forceinline__ float ax_part(const Solver& s, int q, int c) {
  const Dims& D = s.D;
  if (q < 2 * D.mo) {
    const int p = q >= D.mo ? 1 : 0;
    return dot_v4(s.A + (size_t)p * D.n1 * D.ldm + (q - p * D.mo), D.ldm,
                  s.xs + p * D.n1, 0, D.n1, 4);
  }
  const float* a = s.A + D.mo + (q - 2 * D.mo);
  if (PC == 1) return dot_v4(a, D.ldm, s.xs, 0, 2 * D.n1, 4);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int jj = c; jj < 2 * D.n1; jj += 2 * PC) {
    a0 += a[jj * D.ldm] * s.xs[jj];
    if (jj + PC < 2 * D.n1) a1 += a[(jj + PC) * D.ldm] * s.xs[jj + PC];
  }
  return a0 + a1;
}

// The sum of v over the PC lanes of a pair row's group (aligned lanes),
// on every lane; all 32 lanes of the warp take part.
template <int PC>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < PC; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// (A'w)[v], half h of the (padded) rows, for the per-player row vector
// views in wv.
__device__ __forceinline__ float atw_half(const Solver& s, int v, int h,
                                          const float* wv) {
  const Dims& D = s.D;
  const int p = v >= D.n1 ? 1 : 0;
  const int half = D.m1p / 2;
  return dot_44(s.A + (size_t)v * D.ldm + h * half,
                wv + p * D.m1p + h * half, 0, half, 4);
}

// One adaptive-rho segment of ``iters`` ADMM iterations from the carry in
// ``o`` (x in xs and in the owners' registers).  Begins after and ends with
// a barrier.
template <int PV, int RM, int PC, int PT>
__device__ void segment(const Solver& s, Own<PV, RM>& o, int iters) {
  const Dims& D = s.D;
  const int t = threadIdx.x, n1 = D.n1, n2 = 2 * D.n1, ldc = D.ldc;
  const float one_m_alpha = 1.f - s.alpha;
  // the rows' penalties and w = ro z - y into the per-player views
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    int q, c;
    bool ok;
    row_task<PC>(D, t + NT * k, q, c, ok);
    if (ok && c == 0) {
      o.ro[k] = o.eq[k] ? 1e3f * o.rho : o.rho;
      put_row(s.rho, D, q, o.ro[k]);
      put_row(s.w, D, q, o.ro[k] * o.z[k] - o.y[k]);
    }
  }
  __syncthreads();
  factor<PT>(s, o.rho);

  for (int it = 0; it < iters; ++it) {
    // the right-hand side: (sigma x - g) + A'w + (rho zx - yx)
#pragma unroll
    for (int k = 0; k < PV; ++k) {
      const int tau = t + NT * k, v = tau >> 1, h = tau & 1;
      const float part = v < n2 ? atw_half(s, v, h, s.w) : 0.f;
      const float atw = part + __shfl_xor_sync(FULL, part, 1);
      if (v < n2 && h == 0)
        s.rs[v] = ((s.sigma * o.x[k] - o.g[k]) + atw) +
                  (o.rho * o.zx[k] - o.yx[k]);
    }
    __syncthreads();
    // t = L^-1 rs: t1 = C1 r1, t2 = B21 r1 + Cs r2 (the factors' strict
    // upper triangles are 0); half h takes every other block of 4 terms
#pragma unroll
    for (int k = 0; k < PV; ++k) {
      const int tau = t + NT * k, i = tau >> 1, h = tau & 1;
      float part = 0.f;
      if (i < n1) {
        part = dot_v4(s.C1 + i, ldc, s.rs, 4 * h, n1, 8);
      } else if (i < n2) {
        const int ii = i - n1;
        part = dot_v4(s.F2 + ii, ldc, s.rs, 4 * h, n1, 8) +
               dot_v4(s.S + ii, ldc, s.rs + n1, 4 * h, n1, 8);
      }
      const float sum = part + __shfl_xor_sync(FULL, part, 1);
      if (i < n2 && h == 0) s.ts[i] = sum;
    }
    __syncthreads();
    // x = L^-T t: x1 = C1't1 + B21't2, x2 = Cs't2
#pragma unroll
    for (int k = 0; k < PV; ++k) {
      const int tau = t + NT * k, j = tau >> 1, h = tau & 1;
      float part = 0.f;
      if (j < n1) {
        part = dot_44(s.C1 + j * ldc, s.ts, 4 * h, n1, 8) +
               dot_44(s.F2 + j * ldc, s.ts + n1, 4 * h, n1, 8);
      } else if (j < n2) {
        const int jj = j - n1;
        part = dot_44(s.S + jj * ldc, s.ts + n1, 4 * h, n1, 8);
      }
      const float sum = part + __shfl_xor_sync(FULL, part, 1);
      if (j < n2 && h == 0) s.xs[j] = sum;
    }
    __syncthreads();
    // the box rows and the constraint rows; w for the next iteration
#pragma unroll
    for (int k = 0; k < PV; ++k) {
      const int tau = t + NT * k, v = tau >> 1;
      if (v < n2 && (tau & 1) == 0) {
        o.x[k] = s.xs[v];
        const float zt = s.alpha * o.x[k] + one_m_alpha * o.zx[k];
        const float zn = fminf(fmaxf(zt + o.yx[k] / o.rho, o.lx[k]),
                               o.ux[k]);
        o.yx[k] = o.yx[k] + o.rho * (zt - zn);
        o.zx[k] = zn;
      }
    }
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      int q, c;
      bool ok;
      row_task<PC>(D, t + NT * k, q, c, ok);
      float a = ok ? ax_part<PC>(s, q, c) : 0.f;
      const float gs = group_sum<PC>(a);     // every lane takes part
      if (q >= 2 * D.mo) a = gs;
      if (ok && c == 0) {
        o.ax[k] = a;
        const float zt = s.alpha * a + one_m_alpha * o.z[k];
        const float zn = fminf(fmaxf(zt + o.y[k] / o.ro[k], o.lo[k]),
                               o.hi[k]);
        o.y[k] = o.y[k] + o.ro[k] * (zt - zn);
        o.z[k] = zn;
        put_row(s.w, D, q, o.ro[k] * o.z[k] - o.y[k]);
      }
    }
    __syncthreads();
  }

  // residuals (ax is the last iteration's, from the final x) and rho
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    int q, c;
    bool ok;
    row_task<PC>(D, t + NT * k, q, c, ok);
    if (ok && c == 0) {
      put_row(s.w, D, q, o.y[k]);
      v[0] = fmaxf(v[0], fabsf(o.ax[k] - o.z[k]));
      v[1] = fmaxf(v[1], fabsf(o.ax[k]));
      v[2] = fmaxf(v[2], fabsf(o.z[k]));
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PV; ++k) {
    const int tau = t + NT * k, vv = tau >> 1, h = tau & 1;
    float hx = 0.f, aty = 0.f;
    if (vv < n2) {
      const int p = vv >= n1 ? 1 : 0;
      hx = dot_44(s.H + (size_t)vv * n1, s.xs + p * n1, 4 * h, n1, 8);
      aty = atw_half(s, vv, h, s.w);
    }
    hx = hx + __shfl_xor_sync(FULL, hx, 1);
    aty = aty + __shfl_xor_sync(FULL, aty, 1);
    if (vv < n2 && h == 0) {
      aty = aty + o.yx[k];
      v[0] = fmaxf(v[0], fabsf(o.x[k] - o.zx[k]));
      v[1] = fmaxf(v[1], fabsf(o.x[k]));
      v[2] = fmaxf(v[2], fabsf(o.zx[k]));
      v[3] = fmaxf(v[3], fabsf(hx + o.g[k] + aty));
      v[4] = fmaxf(v[4], fabsf(hx));
      v[5] = fmaxf(v[5], fabsf(aty));
      v[6] = fmaxf(v[6], fabsf(o.g[k]));
    }
  }
  knot::block_max<NT, 7>(v, s.red);
  o.prim = v[0];
  o.dual = v[3];
  o.p_sc = fmaxf(v[1], v[2]) + 1e-9f;
  o.d_sc = fmaxf(fmaxf(v[4], v[5]), v[6]) + 1e-9f;
  const float ratio = sqrtf((o.prim / o.p_sc) / (o.dual / o.d_sc + 1e-12f));
  o.rho = fminf(fmaxf(o.rho * fminf(fmaxf(ratio, 0.2f), 5.0f), 1e-6f), 1e8f);
}

// rho0 = clip(tr(H) / n, 1e-3, 1e6) rho, the trace summed in order by one
// thread.  Ends synchronized.
__device__ __forceinline__ float rho0(const Solver& s, float rho,
                                      float inv_n2) {
  const int n1 = s.D.n1;
  if (threadIdx.x == 0) {
    float tr = 0.f;
    for (int p = 0; p < 2; ++p)
      for (int j = 0; j < n1; ++j) tr = tr + s.H[(p * n1 + j) * n1 + j];
    s.red[0] = tr;
  }
  __syncthreads();
  const float r = fminf(fmaxf(s.red[0] * inv_n2, 1e-3f), 1e6f) * rho;
  __syncthreads();
  return r;
}

}  // namespace joint

// K4: the fused joint two-player CMPC SQP solve, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel robogame_tpu/ops/sqp_pallas.py:77-464
// (_make_cmpc_kernel) and its launch in solve_cmpc_sqp_lanes (:836-930).
// It computes what that kernel computes, the algorithm of the plain version
// robogame_tpu_torch/ops/sqp_lanes.py::solve_cmpc_sqp_plain; the wrapper is
// robogame_tpu_torch/kernels.py::cmpc_sqp.  Per problem (one CMPC
// candidate: n1 = 2N inputs a player in its own permuted columns, mo = 2N
// arena rows + M N keepout rows a player, mp = N pair rows, the 2 n1 input
// box rows implicit):
//
//   once: the per-player, per-knot gram terms gxx, gxy, gyy of the
//     position sensitivities sg (the closed-form norms of every row) and
//     rho0 = clip(tr(H) / 2 n1, 1e-3, 1e6) rho;
//   relinearize(x): knot positions p_p = p0_p + sg_p x_p; keepout row
//     (p, m, k) is 2 (dx sgx_p[k] + dy sgy_p[k]) with d = p_p[k] - obs[m],
//     bounds [2 d.p - (|d|^2 - d2) - 2 d.p0, 1e9]; pair row k is
//     [2 (dp . sg_1[k]), -2 (dp . sg_2[k])] with dp = p_1[k] - p_2[k],
//     bounds [2 dp.(p_1 - p_2) - (|dp|^2 - d2) - 2 dp.(p0_1 - p0_2), 1e9];
//     every row (arena rows too) scaled by 1 / max(norm, 1e-8), the norms
//     in closed form from the gram terms (a pair row's from both players');
//   segment: the block-Schur factors of K = blockdiag(H1, H2) + (sigma +
//     rho) I + rho A'A: K11 = H1 + .. + A1'A1, C1 = chol(K11)^-1, K12 =
//     rho P1'P2 (the pair rows' parts), W = C1 K12, S = K22 - W'W, Cs =
//     chol(S)^-1; then alpha-relaxed ADMM iterations solving K x = r
//     through the factors (t1 = C1 r1, t2 = r2 - W't1, u2 = Cs t2, x2 =
//     Cs'u2, v1 = t1 - W x2, x1 = C1'v1), never an explicit inverse; then
//     the residuals and rho <- clip(rho clip(sqrt(ratio), 0.2, 5), 1e-6,
//     1e8);
//   SQP iteration 1: relinearize(U0), n_seg0 cold segments of it0
//     iterations (the schedule of one K5 launch); each later iteration:
//     relinearize(x), y_rows *= d_old / d_new, z_rows = A_new x, one warm
//     segment of it_rest iterations with the carried rho;
//   the flag: prim < tol p_sc and dual < 10 tol d_sc of the last segment.
//
// What bounds it: operations, on the knot-structured algebra
// (chip_smoke.py::k4_flops).  At CMPC's production shape (N = 20: n1 = 40,
// mo = 80, mp = 20; 348 iterations, 9 factorizations) an iteration needs
// about 30 kFLOP (A'w as SG'u and A x as SG x for both players, the six
// products of the Schur solve) and a factorization about 0.45 MFLOP; a
// control step's 4,096 SQPs about 60 GFLOP, 0.89 ms at the H100's 67
// TFLOP/s in f32.  An iteration is a chain of dependent 40 x 40
// products, so what decides the time is the instructions a product issues,
// the barriers between them and the problems in flight.  The design
// (csrc/knot_sqp.cuh):
//
//   * A is never stored.  Knot thread (p, k) (t < 2N) owns player p's rows
//     at knot k: the two arena rows and the pair row k in registers (the
//     pair row twice, once in each player's thread, updated identically),
//     the M keepout rows in shared memory.  A x is the knot increments
//     Y_p = SG_p x_p, A'w is SG_p'u_p; K11 and K22 are H + rho SG'Q SG
//     with Q 2 x 2 a knot; K12 = -rho sum_k a_k b_k' with a_k, b_k the
//     pair row's parts, in 2 x 2 tiles.  A relinearization rewrites the
//     rows' coefficients, not A.
//   * One block of NT = 96 threads solves one problem: lanes 2i and 2i + 1
//     share output i of each of the Schur solve's six products, each taking
//     half of its dot (four partial sums over float4 loads) and a shuffle
//     adding the halves (80 of 96 busy at the production shape); thread v
//     owns variable v for SG'u and the box rows, thread r row r of SG x.
//     Nine barriers an iteration.  The Cholesky factors and their inverses
//     come from one sweep each, four columns a step (knot::chol_inv).
//   * Shared memory holds SG (both players), C1, W, S -> Cs and the
//     vectors: 42 KB a problem at the production shape (A would add 32
//     KB), so 5 problems (15 warps) fit an SM (rg_cmpc_sqp_occupancy asks
//     the card's occupancy calculator).  H is read from device memory,
//     through L1/L2.
//   * The production shape (N = 20, M = 2) runs a kernel with N and M
//     fixed at compile time, its products fully unrolled; every other
//     supported shape the same code with N and M read at run time.
//
// Numerics: no fast math; IEEE division and square root.  Built with FMA
// contraction (kernels.py's flag table): the kernel is held to its plain
// version by tolerance and, in chip_smoke.py phase 7 (b), to lie no further
// from the f64 plain version than the plain f32 version does.
//
// Supported shapes: n1 = 2N <= 64 and R = 2 mo + mp <= 512 rows within a
// block's shared memory (odd N pads n1 to a multiple of 4 with zeros);
// anything else is refused at launch (the wrapper raises first).

#include "knot_sqp.cuh"

namespace {

using knot::WARP;
constexpr int NT = 96;                  // threads of one problem's block
constexpr int MAX_N1 = 64;
constexpr int MAX_R = 512;
constexpr int RV = (2 * MAX_N1 + NT - 1) / NT;   // variables a thread
using Team = knot::BlockTeam<NT>;

struct Dims {
  int N, M, n1, np, lds, ldc, floats;
};

// Shared floats: SG (each player's 2N rows, x then y, padded with zero
// rows to np, at lds), C1, W, S (np columns of ldc each), the vectors x, r,
// u, Y (2 np each, [player][np]), t1, t2, u2, v1 (np each), four columns of
// L (4 np), the knots' Q blocks (2 x 4N), the pair rows' coefficients
// (2N), the knots' positions and free responses (4N each) and gram terms
// (6N), the keepout rows' cx, cy, d, lo, z, y (2 M N each) and the
// reduction scratch.  np is n1 rounded up to a multiple of 8, so that each
// half of a padded product is a multiple of 4 long; whatever is read
// through float4 sits at a multiple of 4.
__host__ __device__ inline Dims dims(int N, int M) {
  Dims d;
  d.N = N;
  d.M = M;
  d.n1 = 2 * N;
  d.np = (d.n1 + 7) & ~7;
  d.lds = d.np + 4;
  d.ldc = d.np + 1;
  const int f = 2 * d.np * d.lds + 3 * d.np * ((d.ldc + 3) & ~3) +
                8 * d.np + 8 * d.np + 8 * N + 2 * N + 14 * N +
                12 * M * N + 8 * (NT / WARP);
  d.floats = (f + 3) & ~3;
  return d;
}

struct Params {
  int B, N, M, n_seg0, it0, sqp_rest, it_rest;
  float rho, sigma, alpha, tol, dual_tol, d2, inv_n2;
};

// K12 = -rho sum_k a_k b_k' (full, column-major, ld) with a_k = cpx sgx_1[k]
// + cpy sgy_1[k] and b_k = cpx sgx_2[k] + cpy sgy_2[k] the pair row k's
// player parts (player 2's carries the minus sign), in 2 x 2 tiles.
__device__ __forceinline__ void form_k12(float* K, int ld, const float* SG1,
                                         const float* SG2, int lds,
                                         const float* pcs, int N, float rho,
                                         int t) {
  const int nt = N;
  for (int e = t; e < nt * nt; e += NT) {
    const int I = e / nt, J = e - I * nt;
    const int i0 = 2 * I, j0 = 2 * J;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float2 c = knot::ld2(pcs + 2 * k);
      const float2 ax = knot::ld2(SG1 + k * lds + i0);
      const float2 ay = knot::ld2(SG1 + (N + k) * lds + i0);
      const float2 bx = knot::ld2(SG2 + k * lds + j0);
      const float2 by = knot::ld2(SG2 + (N + k) * lds + j0);
      const float p0 = c.x * ax.x + c.y * ay.x, p1 = c.x * ax.y + c.y * ay.y;
      const float q0 = c.x * bx.x + c.y * by.x, q1 = c.x * bx.y + c.y * by.y;
      a00 += p0 * q0;
      a01 += p0 * q1;
      a10 += p1 * q0;
      a11 += p1 * q1;
    }
    K[j0 * ld + i0] = -(rho * a00);
    K[(j0 + 1) * ld + i0] = -(rho * a01);
    K[j0 * ld + i0 + 1] = -(rho * a10);
    K[(j0 + 1) * ld + i0 + 1] = -(rho * a11);
  }
}

// W = C1 K12 (C1 lower triangular, K12 full; all column-major, ld) for n1
// = 2N, in 2 x 2 tiles.
__device__ __forceinline__ void form_w(float* W, const float* C1,
                                       const float* K, int ld, int N, int t) {
  const int nt = N;
  for (int e = t; e < nt * nt; e += NT) {
    const int I = e / nt, J = e - I * nt;
    const int i0 = 2 * I, j0 = 2 * J;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
    const float* k0 = K + j0 * ld;
    const float* k1 = k0 + ld;
#pragma unroll 4
    for (int l = 0; l <= i0 + 1; ++l) {
      const float c0 = C1[l * ld + i0], c1 = C1[l * ld + i0 + 1];
      a00 += c0 * k0[l];
      a01 += c0 * k1[l];
      a10 += c1 * k0[l];
      a11 += c1 * k1[l];
    }
    W[j0 * ld + i0] = a00;
    W[(j0 + 1) * ld + i0] = a01;
    W[j0 * ld + i0 + 1] = a10;
    W[(j0 + 1) * ld + i0 + 1] = a11;
  }
}

// NC, MC > 0: N and M fixed at compile time (the production shape, its
// products fully unrolled); 0: taken from P.
template <int NC, int MC>
__global__ void __launch_bounds__(NT, 5)
cmpc_sqp_kernel(const float* __restrict__ Hb, const float* __restrict__ g,
                const float* __restrict__ sg, const float* __restrict__ p0,
                const float* __restrict__ obs,
                const float* __restrict__ lo_arena,
                const float* __restrict__ hi_arena,
                const float* __restrict__ lx, const float* __restrict__ ux,
                const float* __restrict__ U0, float* __restrict__ xout,
                float* __restrict__ stats, Params P) {
  extern __shared__ float4 smem4[];
  const Dims D = dims(NC > 0 ? NC : P.N, MC > 0 ? MC : P.M);
  const int N = D.N, M = D.M, n1 = D.n1, np = D.np, n2 = 2 * n1;
  const int lds = D.lds, ldc = D.ldc, ldm = (D.ldc + 3) & ~3;
  const int MN = M * N;
  const int b = blockIdx.x, t = threadIdx.x, w = t / WARP;
  float* SG = reinterpret_cast<float*>(smem4);  // player p's rows at p np lds
  float* C1 = SG + 2 * np * lds;                // column-major, ldc
  float* Wm = C1 + np * ldm;
  float* Sm = Wm + np * ldm;                    // K12, then S -> Cs
  float* xs = Sm + np * ldm;                    // [player][np]
  float* rs = xs + 2 * np;
  float* us = rs + 2 * np;                      // [player][x (N); y (N); 0]
  float* Ys = us + 2 * np;                      // [player][x (N); y (N); 0]
  float* t1 = Ys + 2 * np;
  float* t2 = t1 + np;
  float* u2 = t2 + np;
  float* v1 = u2 + np;
  float* cl = v1 + np;                          // four columns of L
  float* qs = cl + 4 * np;                      // [player][4N]
  float* pcs = qs + 8 * N;                      // pair k: cpx, cpy at 2k
  float* pb = pcs + 2 * N;                      // positions [player][x; y]
  float* p0s = pb + 4 * N;                      // free response, same
  float* gr = p0s + 4 * N;                      // gxx, gxy, gyy [3][2N]
  float* kcx = gr + 6 * N;                      // keepout (p, m, k) at
  float* kcy = kcx + 2 * MN;                    //   (p M + m) N + k
  float* kd = kcy + 2 * MN;
  float* klo = kd + 2 * MN;
  float* kz = klo + 2 * MN;
  float* ky = kz + 2 * MN;
  float* red = ky + 2 * MN;
  const float* H1 = Hb + (size_t)b * 2 * n1 * n1;
  const float* H2 = H1 + (size_t)n1 * n1;
  const float* ob = obs + (size_t)b * M * 2;

  // zero SG's and the matrices' padding and the vectors, then sg (2, N, 2,
  // n1) -> player p's row c N + k
  for (int e = t; e < 2 * np * lds + 3 * np * ldm + 8 * np; e += NT)
    SG[e] = 0.f;
  for (int e = t; e < 8 * np; e += NT) t1[e] = 0.f;
  __syncthreads();
  const float* sgb = sg + (size_t)b * 2 * N * 2 * n1;
  for (int e = t; e < 2 * N * 2 * n1; e += NT) {
    const int pk = e / (2 * n1), cj = e - pk * 2 * n1;
    const int p = pk / N, k = pk - p * N;
    const int c = cj / n1, j = cj - c * n1;
    SG[(p * np + c * N + k) * lds + j] = sgb[e];
  }
  // variables v = t + NT s: player v / n1, index v % n1
  float x[RV], zx[RV], yx[RV], gv[RV], lxv[RV], uxv[RV];
  float tr = 0.f;
#pragma unroll
  for (int s = 0; s < RV; ++s) {
    const int v = t + NT * s;
    x[s] = zx[s] = yx[s] = gv[s] = lxv[s] = uxv[s] = 0.f;
    if (v < n2) {
      const int p = v >= n1 ? 1 : 0, i = v - p * n1;
      gv[s] = g[(size_t)b * n2 + v];
      lxv[s] = lx[(size_t)b * n2 + v];
      uxv[s] = ux[(size_t)b * n2 + v];
      xs[p * np + i] = U0[(size_t)b * n2 + v];
      tr += H1[((size_t)p * n1 + i) * n1 + i];
    }
  }
  tr = knot::warp_sum(tr);
  if ((t & (WARP - 1)) == 0) red[w] = tr;
  __syncthreads();
  tr = 0.f;
  for (int k = 0; k < NT / WARP; ++k) tr += red[k];
  float rho = fminf(fmaxf(tr * P.inv_n2, 1e-3f), 1e6f) * P.rho;

  // knot thread (p, k) = t < 2N: gram terms, free response, the two arena
  // rows and its copy of pair row k in registers
  const bool knot = t < 2 * N;
  const int kp = knot ? t / N : 0, kk = knot ? t - kp * N : 0;
  const float sgn = kp == 0 ? 1.f : -1.f;     // the pair row's sign
  const float* sx = SG + (kp * np + kk) * lds;
  const float* sy = SG + (kp * np + N + kk) * lds;
  const float* xp = xs + kp * np;
  float gxx = 0.f, gxy = 0.f, gyy = 0.f, p0x = 0.f, p0y = 0.f;
  float dax = 1.f, day = 1.f, lax = 0.f, hax = 0.f, lay = 0.f, hay = 0.f;
  float zax = 0.f, yax = 0.f, zay = 0.f, yay = 0.f;
  float pcx = 0.f, pcy = 0.f, pdk = 1.f, plo = 0.f, pz = 0.f, py = 0.f;
  __syncthreads();
  if (knot) {
#pragma unroll 4
    for (int j = 0; j < n1; ++j) {
      gxx += sx[j] * sx[j];
      gxy += sx[j] * sy[j];
      gyy += sy[j] * sy[j];
    }
    gr[0 * 2 * N + t] = gxx;
    gr[1 * 2 * N + t] = gxy;
    gr[2 * 2 * N + t] = gyy;
    p0x = p0[(((size_t)b * 2 + kp) * N + kk) * 2 + 0];
    p0y = p0[(((size_t)b * 2 + kp) * N + kk) * 2 + 1];
    p0s[kp * 2 * N + kk] = p0x;
    p0s[kp * 2 * N + N + kk] = p0y;
    dax = 1.f / fmaxf(sqrtf(gxx), 1e-8f);
    day = 1.f / fmaxf(sqrtf(gyy), 1e-8f);
    const size_t ra = ((size_t)b * 2 + kp) * 2 * N + kk;
    lax = lo_arena[ra] * dax;
    hax = hi_arena[ra] * dax;
    lay = lo_arena[ra + N] * day;
    hay = hi_arena[ra + N] * day;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = (kp * M + m) * N + kk;
      kz[q] = ky[q] = 0.f;
    }
  }
  __syncthreads();
  const float alpha = P.alpha;

  // The rows at the point in xs; warm: rescale the row duals by d_old /
  // d_new and reseed z = A_new x.
  auto relinearize = [&](bool warm) {
    float Yx = 0.f, Yy = 0.f;
    if (knot) {
      Yx = knot::dot4(sx, xp, np);
      Yy = knot::dot4(sy, xp, np);
      const float accx = p0x + Yx, accy = p0y + Yy;
      pb[kp * 2 * N + kk] = accx;
      pb[kp * 2 * N + N + kk] = accy;
      Ys[kp * np + kk] = Yx;
      Ys[kp * np + N + kk] = Yy;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = (kp * M + m) * N + kk;
        float d, lo, cx, cy;
        knot::keepout_row(accx, accy, p0x, p0y, gxx, gxy, gyy, ob[2 * m],
                          ob[2 * m + 1], P.d2, d, lo, cx, cy);
        if (warm) {
          ky[q] = ky[q] * (kd[q] / d);
          kz[q] = cx * Yx + cy * Yy;
        }
        kd[q] = d;
        klo[q] = lo;
        kcx[q] = cx;
        kcy[q] = cy;
      }
      if (warm) {
        zax = dax * Yx;
        zay = day * Yy;
      }
    }
    __syncthreads();
    if (knot) {                   // pair row kk, in both players' threads
      const int k = kk;
      const float b0x = pb[k], b0y = pb[N + k];
      const float b1x = pb[2 * N + k], b1y = pb[3 * N + k];
      const float sxx = gr[k] + gr[N + k];
      const float sxy = gr[2 * N + k] + gr[3 * N + k];
      const float syy = gr[4 * N + k] + gr[5 * N + k];
      const float dpx = b0x - b1x, dpy = b0y - b1y;
      const float rn = 2.f * sqrtf(dpx * dpx * sxx + 2.f * dpx * dpy * sxy +
                                   dpy * dpy * syy);
      const float d = 1.f / fmaxf(rn, 1e-8f);
      const float gp = dpx * dpx + dpy * dpy - P.d2;
      const float rhs =
          2.f * (dpx * b0x + dpy * b0y - dpx * b1x - dpy * b1y) - gp -
          2.f * (dpx * (p0s[k] - p0s[2 * N + k]) +
                 dpy * (p0s[N + k] - p0s[3 * N + k]));
      pcx = (2.f * dpx) * d;
      pcy = (2.f * dpy) * d;
      plo = rhs * d;
      if (warm) {
        py = py * (pdk / d);
        pz = pcx * (Ys[k] - Ys[np + k]) + pcy * (Ys[N + k] - Ys[np + N + k]);
      }
      pdk = d;
      if (kp == 0) {
        pcs[2 * k] = pcx;
        pcs[2 * k + 1] = pcy;
      }
    }
    __syncthreads();
  };

  // u_p = the rows' coefficients times v folded into player p's knots: v =
  // rho z - y (dual = false) or the duals y (dual = true), into us.
  auto fold = [&](bool dual) {
    if (knot) {
      float ux_ = dax * (dual ? yax : rho * zax - yax);
      float uy_ = day * (dual ? yay : rho * zay - yay);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = (kp * M + m) * N + kk;
        const float wv = dual ? ky[q] : rho * kz[q] - ky[q];
        ux_ += kcx[q] * wv;
        uy_ += kcy[q] * wv;
      }
      const float wp = dual ? py : rho * pz - py;
      ux_ += (sgn * pcx) * wp;
      uy_ += (sgn * pcy) * wp;
      us[kp * np + kk] = ux_;
      us[kp * np + N + kk] = uy_;
    }
  };

  // A'u + the rest of the right-hand side for variable slot s
  auto atu = [&](int s) {
    const int v = t + NT * s;
    const int p = v >= n1 ? 1 : 0, i = v - p * n1;
    return knot::row_dot(SG + p * np * lds, lds, i, us + p * np, 0, np);
  };

  // C = chol(M)^-1 in place, four columns a step (two for an odd N)
  auto chol_inv = [&](float* Mx) {
    if (n1 % 4 == 0)
      knot::chol_inv<Team, 4>(Mx, n1, ldc, cl, t);
    else
      knot::chol_inv<Team, 2>(Mx, n1, ldc, cl, t);
  };

  float prim = 0.f, dual = 0.f, p_sc = 1.f, d_sc = 1.f;
  // The Schur solve's products: output i = base + t / 2 in passes of NT / 2
  // outputs, its dot of np terms split between lanes t and t ^ 1 (the
  // padded entries are zeros); both lanes get the sum, put(i, sum) runs in
  // the even one.
  const int hk = (t & 1) * (np / 2);
  auto schur = [&](const float* Mx, const float* v, bool transposed,
                   auto put) {
    for (int base = 0; base < n1; base += NT / 2) {
      const int i = base + t / 2;
      float p = 0.f;
      if (i < n1)
        p = transposed ? knot::col_dot(Mx, ldc, i, v, hk, np / 2)
                       : knot::row_dot(Mx, ldc, i, v, hk, np / 2);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      if (i < n1 && hk == 0) put(i, p);
    }
  };

  auto segment = [&](int iters) {
    // ---- the factors C1, W, Cs
    if (knot) {
      float qxx = dax * dax + pcx * pcx, qxy = pcx * pcy;
      float qyy = day * day + pcy * pcy;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = (kp * M + m) * N + kk;
        qxx += kcx[q] * kcx[q];
        qxy += kcx[q] * kcy[q];
        qyy += kcy[q] * kcy[q];
      }
      float* qk = qs + kp * 4 * N + 4 * kk;
      qk[0] = qxx;
      qk[1] = qxy;
      qk[2] = qyy;
      qk[3] = 0.f;
    }
    __syncthreads();
    const float diag = P.sigma + rho;
    knot::form_k<NT>(C1, ldc, SG, lds, qs, N, H1, rho, diag, nullptr, 0, np,
                     t);
    form_k12(Sm, ldc, SG, SG + np * lds, lds, pcs, N, rho, t);
    __syncthreads();
    chol_inv(C1);
    form_w(Wm, C1, Sm, ldc, N, t);
    __syncthreads();
    knot::form_k<NT>(Sm, ldc, SG + np * lds, lds, qs + 4 * N, N, H2,
                     rho, diag, Wm, ldc, np, t);
    __syncthreads();
    chol_inv(Sm);

    // ---- ADMM iterations
    for (int it = 0; it < iters; ++it) {
      fold(false);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < RV; ++s) {
        const int v = t + NT * s;
        if (v < n2) {
          const int p = v >= n1 ? 1 : 0;
          rs[p * np + v - p * n1] =
              (P.sigma * x[s] - gv[s]) + atu(s) + (rho * zx[s] - yx[s]);
        }
      }
      __syncthreads();
      schur(C1, rs, false, [&](int i, float p) { t1[i] = p; });
      __syncthreads();
      schur(Wm, t1, true, [&](int i, float p) { t2[i] = rs[np + i] - p; });
      __syncthreads();
      schur(Sm, t2, false, [&](int i, float p) { u2[i] = p; });
      __syncthreads();
      schur(Sm, u2, true, [&](int i, float p) { xs[np + i] = p; });
      __syncthreads();
      schur(Wm, xs + np, false, [&](int i, float p) { v1[i] = t1[i] - p; });
      __syncthreads();
      schur(C1, v1, true, [&](int i, float p) { xs[i] = p; });
      __syncthreads();
#pragma unroll
      for (int s = 0; s < RV; ++s) {
        const int v = t + NT * s;
        if (v < n2) {
          const int p = v >= n1 ? 1 : 0;
          x[s] = xs[p * np + v - p * n1];
          knot::admm_row(x[s], lxv[s], uxv[s], rho, alpha, zx[s], yx[s]);
        }
      }
      for (int r = t; r < 4 * N; r += NT) {       // Y = SG x, both players
        const int p = r >= 2 * N ? 1 : 0, row = r - p * 2 * N;
        Ys[p * np + row] =
            knot::dot4(SG + (p * np + row) * lds, xs + p * np, np);
      }
      __syncthreads();
      if (knot) {
        const float Yx = Ys[kp * np + kk], Yy = Ys[kp * np + N + kk];
        knot::admm_row(dax * Yx, lax, hax, rho, alpha, zax, yax);
        knot::admm_row(day * Yy, lay, hay, rho, alpha, zay, yay);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int q = (kp * M + m) * N + kk;
          float z = kz[q], y = ky[q];
          knot::admm_row(kcx[q] * Yx + kcy[q] * Yy, klo[q], 1e9f * kd[q],
                         rho, alpha, z, y);
          kz[q] = z;
          ky[q] = y;
        }
        const float a = pcx * (Ys[kk] - Ys[np + kk]) +
                        pcy * (Ys[N + kk] - Ys[np + N + kk]);
        knot::admm_row(a, plo, 1e9f * pdk, rho, alpha, pz, py);
      }
    }

    // ---- residuals (A x from the final x's Y) and the adaptive rho update
    float v7[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < RV; ++s) {
      if (t + NT * s < n2) {
        v7[0] = fmaxf(v7[0], fabsf(x[s] - zx[s]));
        v7[1] = fmaxf(v7[1], fabsf(x[s]));
        v7[2] = fmaxf(v7[2], fabsf(zx[s]));
      }
    }
    if (knot) {
      const float Yx = Ys[kp * np + kk], Yy = Ys[kp * np + N + kk];
      const float ax = dax * Yx, ay = day * Yy;
      const float a = pcx * (Ys[kk] - Ys[np + kk]) +
                      pcy * (Ys[N + kk] - Ys[np + N + kk]);
      v7[0] = fmaxf(v7[0], fmaxf(fmaxf(fabsf(ax - zax), fabsf(ay - zay)),
                                 fabsf(a - pz)));
      v7[1] = fmaxf(v7[1], fmaxf(fmaxf(fabsf(ax), fabsf(ay)), fabsf(a)));
      v7[2] = fmaxf(v7[2], fmaxf(fmaxf(fabsf(zax), fabsf(zay)), fabsf(pz)));
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = (kp * M + m) * N + kk;
        const float am = kcx[q] * Yx + kcy[q] * Yy;
        v7[0] = fmaxf(v7[0], fabsf(am - kz[q]));
        v7[1] = fmaxf(v7[1], fabsf(am));
        v7[2] = fmaxf(v7[2], fabsf(kz[q]));
      }
    }
    fold(true);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < RV; ++s) {
      const int v = t + NT * s;
      if (v < n2) {
        const int p = v >= n1 ? 1 : 0;
        const float* h = H1 + (size_t)v * n1;     // row v - p n1 of H_p
        const float* xq = xs + p * np;
        float hx = 0.f;
#pragma unroll 8
        for (int j = 0; j < n1; ++j) hx += h[j] * xq[j];
        const float aty = atu(s) + yx[s];
        v7[3] = fmaxf(v7[3], fabsf(hx + gv[s] + aty));
        v7[4] = fmaxf(v7[4], fabsf(hx));
        v7[5] = fmaxf(v7[5], fabsf(aty));
        v7[6] = fmaxf(v7[6], fabsf(gv[s]));
      }
    }
    knot::block_max<NT>(v7, red);
    prim = v7[0];
    dual = v7[3];
    p_sc = fmaxf(v7[1], v7[2]) + 1e-9f;
    d_sc = fmaxf(fmaxf(v7[4], v7[5]), v7[6]) + 1e-9f;
    const float ratio = sqrtf((prim / p_sc) / (dual / d_sc + 1e-12f));
    rho = fminf(fmaxf(rho * fminf(fmaxf(ratio, 0.2f), 5.0f), 1e-6f), 1e8f);
  };

  // ---- SQP iteration 1: cold ADMM start at the linearization point U0
  relinearize(false);
  for (int s = 0; s < P.n_seg0; ++s) segment(P.it0);
  // ---- SQP iterations 2..: relinearize at x, rescale the row duals,
  // reseed z = A_new x, one warm segment with the carried rho
  for (int s = 0; s < P.sqp_rest; ++s) {
    relinearize(true);
    segment(P.it_rest);
  }

  const bool conv = (prim < P.tol * p_sc) && (dual < P.dual_tol * d_sc);
#pragma unroll
  for (int s = 0; s < RV; ++s) {
    const int v = t + NT * s;
    if (v < n2) xout[(size_t)b * n2 + v] = x[s];
  }
  if (t == 0) {
    float* st = stats + (size_t)b * 5;
    st[0] = conv ? 1.f : 0.f;
    st[1] = prim;
    st[2] = dual;
    st[3] = p_sc;
    st[4] = d_sc;
  }
}

bool supported(int N, int M) {
  const int n1 = 2 * N, R = 2 * (2 + M) * N + N;
  return N >= 1 && n1 <= MAX_N1 && M >= 0 && R <= MAX_R &&
         (size_t)dims(N, M).floats * sizeof(float) <= knot::SMEM_MAX;
}

size_t smem_bytes(int N, int M) {
  return (size_t)dims(N, M).floats * sizeof(float);
}

// CMPC's production shape (N = 20 knots, 2 keepouts a knot) runs the
// specialized kernel, every other supported shape the generic one.
bool production(int N, int M) { return N == 20 && M == 2; }

template <int NC, int MC>
int launch(const float* const* in, float* x, float* stats, const Params& P,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(P.N, P.M);
  cudaError_t err = cudaFuncSetAttribute(
      cmpc_sqp_kernel<NC, MC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cmpc_sqp_kernel<NC, MC><<<P.B, NT, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], x,
      stats, P);
  return (int)cudaGetLastError();
}

template <class K>
int occupancy(K kernel, int N, int M, int* out) {
  const size_t bytes = smem_bytes(N, M);
  out[0] = 0;
  out[1] = (int)bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                            NT, bytes);
}

}  // namespace

// Hb (B, 2, n1, n1), g (B, 2 n1), sg (B, 2, N, 2, n1), p0 (B, 2, N, 2),
// obs (B, M, 2), lo_arena/hi_arena (B, 2, 2N) [x rows; y rows] a player,
// lx/ux/U0 (B, 2 n1) in; x (B, 2 n1) and stats (B, 5) = [converged, prim,
// dual, p_sc, d_sc] out; all float32, contiguous, row-major, n1 = 2N.
// dual_tol is the caller's 10 tol and inv_n2 its 1 / (2 n1), each rounded
// once.  Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int rg_cmpc_sqp(const float* Hb, const float* g, const float* sg,
                           const float* p0, const float* obs,
                           const float* lo_arena, const float* hi_arena,
                           const float* lx, const float* ux, const float* U0,
                           float* x, float* stats, int B, int N, int M,
                           int n_seg0, int it0, int sqp_rest, int it_rest,
                           float rho, float sigma, float alpha, float tol,
                           float dual_tol, float d2, float inv_n2,
                           void* stream) {
  if (B < 1 || !supported(N, M) || n_seg0 < 1 || it0 < 1 || sqp_rest < 0 ||
      (sqp_rest > 0 && it_rest < 1))
    return (int)cudaErrorInvalidValue;
  const Params P{B, N, M, n_seg0, it0, sqp_rest, it_rest, rho, sigma, alpha,
                 tol, dual_tol, d2, inv_n2};
  const float* in[10] = {Hb, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0};
  cudaStream_t st = (cudaStream_t)stream;
  return production(N, M) ? launch<20, 2>(in, x, stats, P, st)
                          : launch<0, 0>(in, x, stats, P, st);
}

// The problems an SM that K4 runs at (N, M), one a block (the card's
// occupancy calculator), into out[0], and its shared bytes a problem into
// out[1].  Returns the CUDA error (0 on success).
extern "C" int rg_cmpc_sqp_occupancy(int N, int M, int* out) {
  if (!supported(N, M)) return (int)cudaErrorInvalidValue;
  return production(N, M) ? occupancy(cmpc_sqp_kernel<20, 2>, N, M, out)
                          : occupancy(cmpc_sqp_kernel<0, 0>, N, M, out);
}

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
//   SQP iteration 1: relinearize(U0), n_seg0 cold segments of it0
//     iterations of the block-Schur ADMM in csrc/joint_schur.cuh (the same
//     schedule as one K5 launch); each later iteration: relinearize(x),
//     y_rows *= d_old / d_new, z_rows = A_new x, one warm segment of
//     it_rest iterations with the carried rho;
//   the flag: prim < tol p_sc and dual < 10 tol d_sc of the last segment.
//
// What bounds it: operations.  At CMPC's production shape (N = 20: n1 =
// 40, mo = 80, mp = 20; 4 x 37 + 5 x 40 = 348 iterations, 9
// factorizations) one SQP needs about 24 MFLOP (chip_smoke.py::k4_flops),
// a control step's 4,096 SQPs (512 games x 8 candidates) about 0.1 TFLOP:
// about 1.5 ms at the H100's 67 TFLOP/s in f32 against 0.03 ms to move
// the 0.11 GB of inputs.  Design: one block of 128 threads per problem
// (joint_schur.cuh says why); A is rebuilt in shared memory from sg at
// every relinearization (sg, A and the factors: 72 KB at the production
// shape, 3 problems an SM), so device memory is read once per problem (H
// through L1/L2).  Building Ax and A'w from sg's 2 N rows a player instead
// of A's m1 rows, and forming A'A per knot, are later work (PERF.md).
//
// Numerics: -fmad=false and no fast math; IEEE division and square root;
// solves through the triangular factors, never an explicit inverse (on
// DMPC's ill-conditioned H an explicit C'C lay further from the f64
// solution than the plain f32 version).  Held to the plain version by
// tolerance.
//
// Supported shapes: n1 = 2N <= 64 and R = 2 mo + mp <= 512 rows within a
// block's shared memory; anything else is refused at launch (the wrapper
// raises first).

#include "joint_schur.cuh"

namespace {

using joint::NT;

struct Params {
  int B, N, M, n_seg0, it0, sqp_rest, it_rest;
  float rho, sigma, alpha, tol, dual_tol, d2, inv_n2;
};

// Shared floats beside the solver's: sg (2 n1 columns of lds), the rows'
// lower and upper bounds and scales (3 R), the knot positions (4 N), the
// gram terms (6 N), the free-response positions (4 N), the keepout offsets
// dx and dy (2 x 2 M N) and the pair offsets (2 N).
__host__ __device__ inline int extra_floats(int N, int M, int R) {
  const int lds = (2 * N) | 1;
  return 2 * (2 * N) * lds + 3 * R + 4 * N + 6 * N + 4 * N + 4 * M * N +
         2 * N;
}

template <int RM>
__global__ void __launch_bounds__(NT)
cmpc_sqp_kernel(const float* __restrict__ Hb, const float* __restrict__ g,
                const float* __restrict__ sg, const float* __restrict__ p0,
                const float* __restrict__ obs,
                const float* __restrict__ lo_arena,
                const float* __restrict__ hi_arena,
                const float* __restrict__ lx, const float* __restrict__ ux,
                const float* __restrict__ U0, float* __restrict__ xout,
                float* __restrict__ stats, Params P) {
  extern __shared__ float smem[];
  const int N = P.N, M = P.M, n1 = 2 * N, n2 = 2 * n1;
  const joint::Dims D = joint::dims(n1, (2 + M) * N, N);
  const int mo = D.mo, m1 = D.m1, R = D.R, ldm = D.ldm;
  const int lds = (2 * N) | 1;
  const int b = blockIdx.x, t = threadIdx.x;
  const joint::Solver s = joint::carve(
      smem, D, Hb + (size_t)b * 2 * n1 * n1, P.sigma, P.alpha);
  float* Ss = smem + joint::solver_floats(D);  // sg[p][.][j] at (p n1 + j) lds
  float* los = Ss + 2 * n1 * lds;               // the rows' scaled bounds
  float* his = los + R;
  float* ds = his + R;                          // the rows' scales
  float* pb = ds + R;                           // knot positions [p][c][k]
  float* gr = pb + 4 * N;                       // grams [xx, xy, yy][p][k]
  float* p0s = gr + 6 * N;                      // free response [p][c][k]
  float* dxs = p0s + 4 * N;                     // keepout dx [p][m][k]
  float* dys = dxs + 2 * M * N;
  float* dps = dys + 2 * M * N;                 // pair offsets [c][k]
  const float* ob = obs + (size_t)b * M * 2;

  // sg (2, N, 2, n1) -> player p's column j: [x rows (N); y rows (N)]
  const float* sgb = sg + (size_t)b * 2 * N * 2 * n1;
  for (int e = t; e < 2 * N * 2 * n1; e += NT) {
    const int pk = e / (2 * n1), cj = e - pk * 2 * n1;
    const int p = pk / N, k = pk - p * N;
    const int c = cj / n1, j = cj - c * n1;
    Ss[(p * n1 + j) * lds + c * N + k] = sgb[e];
  }
  joint::Own<RM> o;
  joint::cold_start(s, o, P.rho, P.inv_n2);
  if (t < n2) {
    o.g = g[(size_t)b * n2 + t];
    o.lx = lx[(size_t)b * n2 + t];
    o.ux = ux[(size_t)b * n2 + t];
    s.xs[t] = U0[(size_t)b * n2 + t];           // the linearization point
  }
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    o.lo[k] = o.hi[k] = 0.f;
    o.d[k] = 1.f;
    o.eq[k] = false;                            // no equality rows
  }
  __syncthreads();
  // knot thread (p, k): its gram terms and free-response position
  const bool knot = t < 2 * N;
  const int kp = knot ? t / N : 0, kk = knot ? t - kp * N : 0;
  float gxx = 0.f, gxy = 0.f, gyy = 0.f, p0x = 0.f, p0y = 0.f;
  if (knot) {
    for (int j = 0; j < n1; ++j) {
      const float* sj = Ss + (kp * n1 + j) * lds;
      const float sx = sj[kk], sy = sj[N + kk];
      gxx = gxx + sx * sx;
      gxy = gxy + sx * sy;
      gyy = gyy + sy * sy;
    }
    p0x = p0[(((size_t)b * 2 + kp) * N + kk) * 2 + 0];
    p0y = p0[(((size_t)b * 2 + kp) * N + kk) * 2 + 1];
    gr[0 * 2 * N + t] = gxx;
    gr[1 * 2 * N + t] = gxy;
    gr[2 * 2 * N + t] = gyy;
    p0s[(kp * 2 + 0) * N + kk] = p0x;
    p0s[(kp * 2 + 1) * N + kk] = p0y;
  }
  __syncthreads();

  // Rebuild the scaled rows of A at the point in xs: scales into o.d,
  // bounds into o.lo / o.hi (read from shared memory after the barrier
  // that follows the write of A).
  auto relinearize = [&]() {
    if (knot) {
      float accx = p0x, accy = p0y;
      const float* xp = s.xs + kp * n1;
      for (int j = 0; j < n1; ++j) {
        const float* sj = Ss + (kp * n1 + j) * lds;
        accx = accx + sj[kk] * xp[j];
        accy = accy + sj[N + kk] * xp[j];
      }
      pb[(kp * 2 + 0) * N + kk] = accx;
      pb[(kp * 2 + 1) * N + kk] = accy;
      const float* la = lo_arena + ((size_t)b * 2 + kp) * 2 * N;
      const float* ha = hi_arena + ((size_t)b * 2 + kp) * 2 * N;
      const float dax = 1.f / fmaxf(sqrtf(gxx), 1e-8f);
      const float day = 1.f / fmaxf(sqrtf(gyy), 1e-8f);
      const int qx = kp * mo + kk, qy = kp * mo + N + kk;
      ds[qx] = dax;
      los[qx] = la[kk] * dax;
      his[qx] = ha[kk] * dax;
      ds[qy] = day;
      los[qy] = la[N + kk] * day;
      his[qy] = ha[N + kk] * day;
      for (int m = 0; m < M; ++m) {
        const float dx = accx - ob[2 * m], dy = accy - ob[2 * m + 1];
        const float nrm = 2.f * sqrtf(dx * dx * gxx + 2.f * dx * dy * gxy +
                                      dy * dy * gyy);
        const float gval = dx * dx + dy * dy - P.d2;
        const float rhs = 2.f * (dx * accx + dy * accy) - gval -
                          2.f * (dx * p0x + dy * p0y);
        const float d = 1.f / fmaxf(nrm, 1e-8f);
        const int q = kp * mo + 2 * N + m * N + kk;
        ds[q] = d;
        los[q] = rhs * d;
        his[q] = 1e9f * d;
        dxs[(kp * M + m) * N + kk] = dx;
        dys[(kp * M + m) * N + kk] = dy;
      }
    }
    __syncthreads();
    if (t < N) {                                  // pair row k = t
      const int k = t;
      const float b0x = pb[0 * N + k], b0y = pb[1 * N + k];
      const float b1x = pb[2 * N + k], b1y = pb[3 * N + k];
      const float sxx = gr[0 * 2 * N + k] + gr[0 * 2 * N + N + k];
      const float sxy = gr[1 * 2 * N + k] + gr[1 * 2 * N + N + k];
      const float syy = gr[2 * 2 * N + k] + gr[2 * 2 * N + N + k];
      const float dpx = b0x - b1x, dpy = b0y - b1y;
      const float rn = 2.f * sqrtf(dpx * dpx * sxx + 2.f * dpx * dpy * sxy +
                                   dpy * dpy * syy);
      const float d = 1.f / fmaxf(rn, 1e-8f);
      const float gp = dpx * dpx + dpy * dpy - P.d2;
      const float rhs =
          2.f * (dpx * b0x + dpy * b0y - dpx * b1x - dpy * b1y) - gp -
          2.f * (dpx * (p0s[0 * N + k] - p0s[2 * N + k]) +
                 dpy * (p0s[1 * N + k] - p0s[3 * N + k]));
      const int q = 2 * mo + k;
      ds[q] = d;
      los[q] = rhs * d;
      his[q] = 1e9f * d;
      dps[k] = dpx;
      dps[N + k] = dpy;
    }
    __syncthreads();
    for (int e = t; e < 2 * n1 * m1; e += NT) {
      const int pj = e / m1, r = e - pj * m1;
      const int p = pj >= n1 ? 1 : 0;
      const float* sj = Ss + pj * lds;
      float a;
      if (r < 2 * N) {
        a = sj[r] * ds[p * mo + r];
      } else if (r < mo) {
        const int q2 = r - 2 * N, m = q2 / N, k = q2 - m * N;
        const int o2 = (p * M + m) * N + k;
        a = 2.f * (dxs[o2] * sj[k] + dys[o2] * sj[N + k]) * ds[p * mo + r];
      } else {
        const int k = r - mo;
        const float sgn = p == 0 ? 2.f : -2.f;
        a = sgn * (dps[k] * sj[k] + dps[N + k] * sj[N + k]) * ds[2 * mo + k];
      }
      s.A[pj * ldm + r] = a;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      const int q = t + NT * k;
      if (q < R) {
        o.d[k] = ds[q];
        o.lo[k] = los[q];
        o.hi[k] = his[q];
      }
    }
  };

  // ---- SQP iteration 1: cold ADMM start at the linearization point U0
  relinearize();
  for (int seg = 0; seg < P.n_seg0; ++seg) joint::segment(s, o, P.it0);
  // ---- SQP iterations 2..: relinearize at x, rescale the row duals,
  // reseed z = A_new x, one warm segment with the carried rho
  for (int it = 0; it < P.sqp_rest; ++it) {
    float d_old[RM];
#pragma unroll
    for (int k = 0; k < RM; ++k) d_old[k] = o.d[k];
    relinearize();
#pragma unroll
    for (int k = 0; k < RM; ++k) o.y[k] = o.y[k] * (d_old[k] / o.d[k]);
    joint::reseed(s, o);
    joint::segment(s, o, P.it_rest);
  }
  joint::write_out(s, o, b, P.tol, P.dual_tol, xout, stats);
}

template <int RM>
int launch(const float* const* in, float* x, float* stats, const Params& P,
           cudaStream_t stream) {
  const joint::Dims D = joint::dims(2 * P.N, (2 + P.M) * P.N, P.N);
  const size_t bytes =
      (size_t)(joint::solver_floats(D) + extra_floats(P.N, P.M, D.R)) *
      sizeof(float);
  if (bytes > joint::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cmpc_sqp_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cmpc_sqp_kernel<RM><<<P.B, NT, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], x,
      stats, P);
  return (int)cudaGetLastError();
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
  const int n1 = 2 * N, R = 2 * (2 + M) * N + N;
  if (B < 1 || N < 1 || n1 > joint::MAX_N1 || M < 0 || R > joint::MAX_R ||
      n_seg0 < 1 || it0 < 1 || sqp_rest < 0 || (sqp_rest > 0 && it_rest < 1))
    return (int)cudaErrorInvalidValue;
  const Params P{B, N, M, n_seg0, it0, sqp_rest, it_rest, rho, sigma, alpha,
                 tol, dual_tol, d2, inv_n2};
  const float* in[10] = {Hb, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0};
  cudaStream_t st = (cudaStream_t)stream;
  const int rm = (R + NT - 1) / NT;
  if (rm <= 1) return launch<1>(in, x, stats, P, st);
  if (rm <= 2) return launch<2>(in, x, stats, P, st);
  return launch<4>(in, x, stats, P, st);
}

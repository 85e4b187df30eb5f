// K3: the fused single-agent DMPC SQP solve, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel robogame_tpu/ops/sqp_pallas.py:482-740
// (_make_dmpc_kernel) and its launch in solve_dmpc_sqp_lanes (:744-831).
// It computes what that kernel computes, the algorithm of the plain version
// robogame_tpu_torch/ops/sqp_lanes.py::solve_dmpc_sqp_plain; the wrapper is
// robogame_tpu_torch/kernels.py::dmpc_sqp.  Per problem (one DMPC
// candidate: n1 = 2N inputs, m_own = 2N arena rows + M N keepout rows, the
// n1 input-box rows implicit):
//
//   once: the per-knot gram terms gxx, gxy, gyy of the position
//     sensitivities sg (closed-form norms of every own row) and
//     rho0 = clip(tr(H) / n1, 1e-3, 1e6) * rho;
//   relinearize(x): knot positions p = p0 + sg x; keepout row (m, k) is
//     2 (dx sgx[k] + dy sgy[k]) with d = p[k] - obs[m], bounds
//     [2 d.p - (|d|^2 - d2) - 2 d.p0, 1e9]; every own row (arena rows too)
//     scaled by 1 / max(norm, 1e-8);
//   segment: K = H + (sigma + rho) I + rho A'A, Cholesky K = LL', C = L^-1,
//     then alpha-over-relaxed ADMM iterations (x = C'(C r)) on the own rows
//     and the implicit box rows (same scalar rho), then the residuals and
//     rho <- clip(rho clip(sqrt(ratio), 0.2, 5), 1e-6, 1e8);
//   SQP iteration 1: relinearize(U0), n_seg0 cold segments of it0
//     iterations; each later iteration: relinearize(x), y_own *= d_old /
//     d_new, z_own = A_new x, one segment of it_rest iterations;
//   the flag: prim < tol p_sc and dual < 10 tol d_sc of the last segment.
//
// What bounds it: operations, on the knot-structured algebra
// (chip_smoke.py::k3_flops).  At DMPC's production shape (N = 20: n1 = 40,
// m_own = 100; 4 x 37 + 5 x 40 = 348 iterations, 9 factorizations) an
// iteration needs about 12 kFLOP (four 40 x 40 products: A'w as SG'u, C r,
// C't, A x as SG x) and a factorization about 0.12 MFLOP; a control
// step's 8,192 SQPs about 44 GFLOP, 0.66 ms at the H100's 67 TFLOP/s in
// f32, against 35 us to move the 0.2 KB of input a problem.
// The iterations of a problem are a dependent chain of short products, so
// what decides the time is how many instructions a product issues and how
// many problems are in flight to hide their latency.  The design
// (csrc/knot_sqp.cuh):
//
//   * A is never stored.  Every own row is a scaled combination of SG's
//     two rows at one knot, so lane k (k < N) owns knot k's rows (the two
//     arena rows in registers, the M keepout rows' coefficients, bounds, z
//     and y in shared memory): A x is the knot increments Y = SG x (one
//     float4 dot of length n1 per row of SG) and A'w is SG'u with u folded
//     from the rows at their knots; K = H + rho SG'Q SG (+ diag) with Q 2 x
//     2 a knot, in 2 x 2 tiles.  A relinearization rewrites 6 M N floats,
//     not A.
//   * One block of one warp solves one problem.  An iteration is four
//     products (SG'u, C r, C't, SG x) split over the 32 lanes, each dot as
//     four independent partial sums over float4 loads of its vector, with
//     four __syncwarp.  The Cholesky factor and its inverse come from one
//     sweep, four columns a step (knot::chol_inv).
//   * Shared memory holds SG, K -> C and the vectors: 16 KB a problem at
//     the production shape (A alone would add 16 KB), and registers are
//     capped at 128 a lane, so 13 problems fit an SM (rg_dmpc_sqp_occupancy
//     asks the card's occupancy calculator).  H is read from device
//     memory, through L1/L2, once per segment.
//   * The production shape (N = 20, M = 3) runs a kernel with N and M
//     fixed at compile time, its products fully unrolled; every other
//     supported shape the same code with N and M read at run time.
//
// Numerics: no fast math; IEEE division and square root.  Built with FMA
// contraction (kernels.py's flag table): the kernel is held to its plain
// version by tolerance and, in chip_smoke.py phase 6 (b), to lie no further
// from the f64 plain version than the plain f32 version does.  An iteration
// applies C and then C' as the TPU kernel and the plain version do (an
// explicit Kinv = C'C, as K2 forms it, lies further from the f64 solution
// on these ill-conditioned problems).
//
// Supported shapes: n1 = 2N with n1 % 8 == 0 and n1 <= 64, m_own <= 256;
// anything else is refused at launch (the wrapper raises first).

#include "knot_sqp.cuh"

namespace {

using knot::WARP;
constexpr int MAX_N1 = 64;
constexpr int MAX_M = 256;
constexpr int RN = MAX_N1 / WARP;       // variables a lane
constexpr int MIN_PER_SM = 16;          // the register cap: 128 a lane

struct Dims {
  int N, M, n1, lds, ldc, floats;
};

// Shared floats of one problem: SG (2N rows of lds), K -> C (n1 columns of
// ldc), the vectors x, r, t, u (n1 each), four columns of L (4 n1), the
// knots' Q blocks (4N) and
// the keepout rows' cx, cy, d, lo, z, y (M N each), rounded to a multiple
// of 4.
__host__ __device__ inline Dims dims(int N, int M) {
  Dims d;
  d.N = N;
  d.M = M;
  d.n1 = 2 * N;
  d.lds = d.n1 + 4;
  d.ldc = d.n1 + 1;
  const int f = 2 * N * d.lds + d.n1 * d.ldc + 8 * d.n1 + 4 * N + 6 * M * N;
  d.floats = (f + 3) & ~3;
  return d;
}

struct Params {
  int B, N, M, n_seg0, it0, sqp_rest, it_rest;
  float rho, sigma, alpha, tol, dual_tol, d2, inv_n1;
};

// NC, MC > 0: N and M fixed at compile time (the production shape, its
// products fully unrolled); 0: taken from P.
template <int NC, int MC>
__global__ void __launch_bounds__(WARP, MIN_PER_SM)
dmpc_sqp_kernel(const float* __restrict__ H, const float* __restrict__ g,
                const float* __restrict__ sg, const float* __restrict__ p0,
                const float* __restrict__ obs,
                const float* __restrict__ lo_arena,
                const float* __restrict__ hi_arena,
                const float* __restrict__ lx, const float* __restrict__ ux,
                const float* __restrict__ U0, float* __restrict__ xout,
                float* __restrict__ stats, Params P) {
  extern __shared__ float4 smem4[];
  const Dims D = dims(NC > 0 ? NC : P.N, MC > 0 ? MC : P.M);
  const int N = D.N, M = D.M, n1 = D.n1, lds = D.lds, ldc = D.ldc;
  const int MN = M * N;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  float* SG = reinterpret_cast<float*>(smem4);
  float* Cm = SG + 2 * N * lds;   // K -> C; M[i][j] at j ldc + i
  float* xs = Cm + n1 * ldc;      // x (the linearization point, the iterate)
  float* rs = xs + n1;            // the iteration's right-hand side
  float* ts = rs + n1;            // C r
  float* us = ts + n1;            // u: [x entries (N); y entries (N)]
  float* cl = us + n1;            // four columns of L
  float* qs = cl + 4 * n1;        // Q of knot k at 4k: qxx, qxy, qyy, 0
  float* kcx = qs + 4 * N;        // keepout row (m, k) at m N + k
  float* kcy = kcx + MN;
  float* kd = kcy + MN;
  float* klo = kd + MN;
  float* kz = klo + MN;
  float* ky = kz + MN;

  const float* Hb = H + (size_t)b * n1 * n1;
  const float* sgb = sg + (size_t)b * N * 2 * n1;
  const float* ob = obs + (size_t)b * M * 2;

  for (int e = lane; e < N * 2 * n1; e += WARP) {     // sg[b, k, c, j]
    const int kc = e / n1, j = e - kc * n1;
    SG[((kc & 1) * N + (kc >> 1)) * lds + j] = sgb[e];
  }
  for (int e = lane; e < n1 * ldc; e += WARP) Cm[e] = 0.f;
  float gi[RN], xi[RN], zx[RN], yx[RN], lxi[RN], uxi[RN];
  float tr = 0.f;
#pragma unroll
  for (int q = 0; q < RN; ++q) {
    const int i = lane + WARP * q;
    const bool ok = i < n1;
    gi[q] = ok ? g[(size_t)b * n1 + i] : 0.f;
    lxi[q] = ok ? lx[(size_t)b * n1 + i] : 0.f;
    uxi[q] = ok ? ux[(size_t)b * n1 + i] : 0.f;
    xi[q] = zx[q] = yx[q] = 0.f;
    if (ok) {
      xs[i] = U0[(size_t)b * n1 + i];
      tr += Hb[i * n1 + i];
    }
  }
  tr = knot::warp_sum(tr);
  float rho = fminf(fmaxf(tr * P.inv_n1, 1e-3f), 1e6f) * P.rho;
  __syncwarp();

  // knot lane k = lane < N: its gram terms, free-response position and two
  // arena rows (scale, bounds, z, y) in registers; Y = (SG x)[k], [N + k]
  const bool knot = lane < N;
  const float* sx = SG + lane * lds;
  const float* sy = SG + (N + lane) * lds;
  float gxx = 0.f, gxy = 0.f, gyy = 0.f, p0x = 0.f, p0y = 0.f;
  float dax = 1.f, day = 1.f, lax = 0.f, hax = 0.f, lay = 0.f, hay = 0.f;
  float zax = 0.f, yax = 0.f, zay = 0.f, yay = 0.f, Yx = 0.f, Yy = 0.f;
  if (knot) {
#pragma unroll 4
    for (int j = 0; j < n1; ++j) {
      gxx += sx[j] * sx[j];
      gxy += sx[j] * sy[j];
      gyy += sy[j] * sy[j];
    }
    p0x = p0[((size_t)b * N + lane) * 2 + 0];
    p0y = p0[((size_t)b * N + lane) * 2 + 1];
    dax = 1.f / fmaxf(sqrtf(gxx), 1e-8f);
    day = 1.f / fmaxf(sqrtf(gyy), 1e-8f);
    const size_t ra = (size_t)b * 2 * N + lane;
    lax = lo_arena[ra] * dax;
    hax = hi_arena[ra] * dax;
    lay = lo_arena[ra + N] * day;
    hay = hi_arena[ra + N] * day;
#pragma unroll
    for (int m = 0; m < M; ++m) kz[m * N + lane] = ky[m * N + lane] = 0.f;
  }
  const float alpha = P.alpha;

  // The keepout rows at the point in xs; warm: rescale their duals by
  // d_old / d_new and reseed every own row's z = A_new x.
  auto relinearize = [&](bool warm) {
    if (knot) {
      Yx = knot::dot4(sx, xs, n1);
      Yy = knot::dot4(sy, xs, n1);
      const float accx = p0x + Yx, accy = p0y + Yy;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = m * N + lane;
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
    __syncwarp();
  };

  // u = the rows' coefficients times v folded into their knots: v = rho z -
  // y (dual = false) or the duals y (dual = true), into us.
  auto fold = [&](bool dual) {
    if (knot) {
      float ux_ = dax * (dual ? yax : rho * zax - yax);
      float uy_ = day * (dual ? yay : rho * zay - yay);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = m * N + lane;
        const float w = dual ? ky[q] : rho * kz[q] - ky[q];
        ux_ += kcx[q] * w;
        uy_ += kcy[q] * w;
      }
      us[lane] = ux_;
      us[N + lane] = uy_;
    }
  };

  float prim = 0.f, dual = 0.f, p_sc = 1.f, d_sc = 1.f;

  auto segment = [&](int iters) {
    // ---- K = H + rho SG'Q SG + (sigma + rho) I, then C = chol(K)^-1
    if (knot) {
      float qxx = dax * dax, qxy = 0.f, qyy = day * day;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = m * N + lane;
        qxx += kcx[q] * kcx[q];
        qxy += kcx[q] * kcy[q];
        qyy += kcy[q] * kcy[q];
      }
      qs[4 * lane + 0] = qxx;
      qs[4 * lane + 1] = qxy;
      qs[4 * lane + 2] = qyy;
      qs[4 * lane + 3] = 0.f;
    }
    __syncwarp();
    knot::form_k<WARP>(Cm, ldc, SG, lds, qs, N, Hb, rho, P.sigma + rho,
                       nullptr, 0, n1, lane);
    __syncwarp();
    knot::chol_inv<knot::WarpTeam, 4>(Cm, n1, ldc, cl, lane);

    // ---- ADMM iterations
    for (int it = 0; it < iters; ++it) {
      fold(false);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int i = lane + WARP * q;
        if (i < n1)
          rs[i] = (P.sigma * xi[q] - gi[q]) +
                  knot::row_dot(SG, lds, i, us, 0, n1) +
                  (rho * zx[q] - yx[q]);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int i = lane + WARP * q;
        const int kend = n1 < WARP * (q + 1) ? n1 : WARP * (q + 1);
        if (i < n1) ts[i] = knot::row_dot(Cm, ldc, i, rs, 0, kend);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int i = lane + WARP * q;
        if (i < n1) {
          const float x =
              knot::col_dot(Cm, ldc, i, ts, WARP * q, n1 - WARP * q);
          xi[q] = x;
          xs[i] = x;
          knot::admm_row(x, lxi[q], uxi[q], rho, alpha, zx[q], yx[q]);
        }
      }
      __syncwarp();
      if (knot) {
        Yx = knot::dot4(sx, xs, n1);
        Yy = knot::dot4(sy, xs, n1);
        knot::admm_row(dax * Yx, lax, hax, rho, alpha, zax, yax);
        knot::admm_row(day * Yy, lay, hay, rho, alpha, zay, yay);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int q = m * N + lane;
          float z = kz[q], y = ky[q];
          knot::admm_row(kcx[q] * Yx + kcy[q] * Yy, klo[q], 1e9f * kd[q],
                         rho, alpha, z, y);
          kz[q] = z;
          ky[q] = y;
        }
      }
    }

    // ---- residuals (A x from the final x's Y) and the adaptive rho update
    float pr = 0.f, am = 0.f, zm = 0.f;
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      if (lane + WARP * q < n1) {
        pr = fmaxf(pr, fabsf(xi[q] - zx[q]));
        am = fmaxf(am, fabsf(xi[q]));
        zm = fmaxf(zm, fabsf(zx[q]));
      }
    }
    if (knot) {
      const float ax = dax * Yx, ay = day * Yy;
      pr = fmaxf(pr, fmaxf(fabsf(ax - zax), fabsf(ay - zay)));
      am = fmaxf(am, fmaxf(fabsf(ax), fabsf(ay)));
      zm = fmaxf(zm, fmaxf(fabsf(zax), fabsf(zay)));
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int q = m * N + lane;
        const float a = kcx[q] * Yx + kcy[q] * Yy;
        pr = fmaxf(pr, fabsf(a - kz[q]));
        am = fmaxf(am, fabsf(a));
        zm = fmaxf(zm, fabsf(kz[q]));
      }
    }
    fold(true);
    __syncwarp();
    float du = 0.f, hm = 0.f, atm = 0.f, gm = 0.f;
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int i = lane + WARP * q;
      if (i < n1) {
        const float* hrow = Hb + i * n1;
        float hx = 0.f;
#pragma unroll 8
        for (int j = 0; j < n1; ++j) hx += hrow[j] * xs[j];
        const float aty = knot::row_dot(SG, lds, i, us, 0, n1) + yx[q];
        du = fmaxf(du, fabsf(hx + gi[q] + aty));
        hm = fmaxf(hm, fabsf(hx));
        atm = fmaxf(atm, fabsf(aty));
        gm = fmaxf(gm, fabsf(gi[q]));
      }
    }
    prim = knot::warp_max(pr);
    dual = knot::warp_max(du);
    p_sc = fmaxf(knot::warp_max(am), knot::warp_max(zm)) + 1e-9f;
    d_sc = fmaxf(fmaxf(knot::warp_max(hm), knot::warp_max(atm)),
                 knot::warp_max(gm)) + 1e-9f;
    const float ratio = sqrtf((prim / p_sc) / (dual / d_sc + 1e-12f));
    rho = fminf(fmaxf(rho * fminf(fmaxf(ratio, 0.2f), 5.0f), 1e-6f), 1e8f);
    __syncwarp();
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
  for (int q = 0; q < RN; ++q) {
    const int i = lane + WARP * q;
    if (i < n1) xout[(size_t)b * n1 + i] = xi[q];
  }
  if (lane == 0) {
    float* st = stats + (size_t)b * 5;
    st[0] = conv ? 1.f : 0.f;
    st[1] = prim;
    st[2] = dual;
    st[3] = p_sc;
    st[4] = d_sc;
  }
}

size_t smem_bytes(int N, int M) {
  return (size_t)dims(N, M).floats * sizeof(float);
}

bool supported(int N, int M) {
  const int n1 = 2 * N, m = 2 * N + M * N;
  return N >= 1 && n1 % 8 == 0 && n1 <= MAX_N1 && M >= 0 && m <= MAX_M &&
         smem_bytes(N, M) <= knot::SMEM_MAX;
}

// DMPC's production shape (N = 20 knots, 3 keepouts a knot) runs the
// specialized kernel, every other supported shape the generic one.
bool production(int N, int M) { return N == 20 && M == 3; }

template <int NC, int MC>
int launch(const float* const* in, float* x, float* stats, const Params& P,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(P.N, P.M);
  cudaError_t err = cudaFuncSetAttribute(
      dmpc_sqp_kernel<NC, MC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dmpc_sqp_kernel<NC, MC><<<P.B, WARP, bytes, stream>>>(
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
                                                            WARP, bytes);
}

}  // namespace

// H (B, n1, n1), g (B, n1), sg (B, N, 2, n1), p0 (B, N, 2), obs (B, M, 2),
// lo_arena/hi_arena (B, 2N) [x rows; y rows], lx/ux/U0 (B, n1) in; x (B, n1)
// and stats (B, 5) = [converged, prim, dual, p_sc, d_sc] out; all float32,
// contiguous, row-major, n1 = 2N.  dual_tol is the caller's 10 * tol and
// inv_n1 its 1 / n1, each rounded once.  Returns the CUDA error of the
// launch (0 when it was accepted).
extern "C" int rg_dmpc_sqp(const float* H, const float* g, const float* sg,
                           const float* p0, const float* obs,
                           const float* lo_arena, const float* hi_arena,
                           const float* lx, const float* ux, const float* U0,
                           float* x, float* stats, int B, int N, int M,
                           int n_seg0, int it0, int sqp_rest, int it_rest,
                           float rho, float sigma, float alpha, float tol,
                           float dual_tol, float d2, float inv_n1,
                           void* stream) {
  if (!supported(N, M) || B < 1 || n_seg0 < 1 || it0 < 1 || sqp_rest < 0 ||
      (sqp_rest > 0 && it_rest < 1))
    return (int)cudaErrorInvalidValue;
  const Params P{B, N, M, n_seg0, it0, sqp_rest, it_rest, rho, sigma, alpha,
                 tol, dual_tol, d2, inv_n1};
  const float* in[10] = {H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0};
  cudaStream_t st = (cudaStream_t)stream;
  return production(N, M) ? launch<20, 3>(in, x, stats, P, st)
                          : launch<0, 0>(in, x, stats, P, st);
}

// The problems an SM that K3 runs at (N, M), one a block (the card's
// occupancy calculator), into out[0], and its shared bytes a problem into
// out[1].  Returns the CUDA error (0 on success).
extern "C" int rg_dmpc_sqp_occupancy(int N, int M, int* out) {
  if (!supported(N, M)) return (int)cudaErrorInvalidValue;
  return production(N, M) ? occupancy(dmpc_sqp_kernel<20, 3>, N, M, out)
                          : occupancy(dmpc_sqp_kernel<0, 0>, N, M, out);
}

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
// What bounds it: operations.  At DMPC's production shape (N = 20: n1 = 40,
// m_own = 100; 4 x 37 + 5 x 40 = 348 iterations, 9 factorizations) one SQP
// needs about 9 MFLOP, and a control step's 8,192 SQPs (2 agents x 512
// games x 8 candidates) about 75 GFLOP, against about 0.2 KB of input per
// SQP and 28 KB of shared operands: about 1.1 ms at the H100's 67 TFLOP/s
// in f32 against 35 us to move the bytes.  The design keeps every operand
// of the solve on chip: one warp per problem holds A (m_own x n1), K -> L,
// C and sg in shared memory (37.5 KB at the production shape, 6 problems a
// block) and each lane keeps its rows' z, y, bounds and row
// scales and its variables' x, z, y, g and box in registers, so device
// memory is read once per problem (H's rows are re-read through L1/L2).
// The factorization and the inverse factor run once per segment so an
// iteration is four matrix-vector products; the iterations of a problem are a dependent chain
// of warp-wide steps, so the kernel relies on many problems in flight, and
// at one warp per problem it runs far above its bound (PERF.md).  Faster
// designs (a block per problem, the 2 x 2 per-knot structure of A'A) are
// later work.
//
// Numerics: built with -fmad=false and no fast math; IEEE division and
// square root.  An iteration applies C and then C' as the TPU kernel and
// the plain version do (an explicit Kinv = C'C, as K2 forms it, lies
// further from the f64 solution on these ill-conditioned problems).  Sums
// run in another order than the plain version's batched products, so the
// two are held by tolerance.
//
// Supported shapes: n1 = 2N with n1 % 8 == 0 and n1 <= 64, m_own <= 256;
// anything else is refused at launch (the wrapper raises first).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_N1 = 64;
constexpr int MAX_M = 256;
constexpr int RN = MAX_N1 / WARP;       // variables per lane
constexpr int MAX_WARPS = 8;            // problems per block
constexpr size_t SMEM_MAX = 232448;     // a block's shared memory on H100

struct Dims {
  int n1, N, M, m, ldn, ldm, lds;
};

__host__ __device__ inline Dims dims(int N, int M) {
  Dims d;
  d.N = N;
  d.M = M;
  d.n1 = 2 * N;
  d.m = 2 * N + M * N;
  d.ldn = d.n1 | 1;
  d.ldm = d.m | 1;
  d.lds = (2 * N) | 1;
  return d;
}

// Shared floats of one warp: A, K/L, C, sg, then the row vectors w
// and d, the keepout offsets dx and dy, the vectors x and r.
__host__ __device__ inline int warp_floats(const Dims& d) {
  return d.n1 * d.ldm + 2 * d.n1 * d.ldn + d.n1 * d.lds + 2 * d.ldm +
         2 * d.M * d.N + 2 * d.ldn;
}

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

struct Params {
  int B, N, M, n_seg0, it0, sqp_rest, it_rest;
  float rho, sigma, alpha, tol, dual_tol, d2, inv_n1;
};

// RM: own rows per lane, ceil(m_own / 32) rounded up to 1, 2, 4 or 8.
template <int RM>
__global__ void __launch_bounds__(WARP * MAX_WARPS)
dmpc_sqp_kernel(const float* __restrict__ H, const float* __restrict__ g,
                const float* __restrict__ sg, const float* __restrict__ p0,
                const float* __restrict__ obs,
                const float* __restrict__ lo_arena,
                const float* __restrict__ hi_arena,
                const float* __restrict__ lx, const float* __restrict__ ux,
                const float* __restrict__ U0, float* __restrict__ xout,
                float* __restrict__ stats, Params P) {
  extern __shared__ float smem[];
  const Dims D = dims(P.N, P.M);
  const int n1 = D.n1, N = D.N, M = D.M, m = D.m;
  const int ldn = D.ldn, ldm = D.ldm, lds = D.lds;
  const int lane = threadIdx.x & (WARP - 1);
  const int wib = threadIdx.x / WARP;
  const int b = blockIdx.x * (blockDim.x / WARP) + wib;
  if (b >= P.B) return;                     // the whole warp leaves together
  float* As = smem + (size_t)wib * warp_floats(D);  // A[r][j] at j*ldm+r
  float* Ms = As + n1 * ldm;    // K -> L, then C r; M[i][j] at j*ldn+i
  float* Cs = Ms + n1 * ldn;    // C = L^-1;       C[i][j] at j*ldn+i
  float* Ss = Cs + n1 * ldn;    // sg: column j = [x rows (N); y rows (N)]
  float* ws = Ss + n1 * lds;    // a row vector: rho z - y, keepout rhs, y
  float* ds = ws + ldm;         // the row scales d
  float* dxs = ds + ldm;        // keepout offsets, row 2N + m N + k at m N + k
  float* dys = dxs + M * N;
  float* xs = dys + M * N;      // x (the linearization point, the iterate)
  float* rs = xs + ldn;         // the iteration's right-hand side

  const float* Hb = H + (size_t)b * n1 * n1;
  const float* sgb = sg + (size_t)b * N * 2 * n1;
  const float* ob = obs + (size_t)b * M * 2;

  for (int e = lane; e < N * 2 * n1; e += WARP) {     // sg[b, k, c, j]
    const int kc = e / n1, j = e - kc * n1;
    const int k = kc >> 1, c = kc & 1;
    Ss[j * lds + c * N + k] = sgb[e];
  }
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
  tr = warp_sum(tr);
  float rho_s = fminf(fmaxf(tr * P.inv_n1, 1e-3f), 1e6f) * P.rho;
  float lo[RM], hi[RM], dr[RM], la[RM], ha[RM], z[RM], y[RM], ax[RM];
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    const int r = lane + WARP * k;
    const bool arena = r < 2 * N;
    la[k] = arena ? lo_arena[(size_t)b * 2 * N + r] : 0.f;
    ha[k] = arena ? hi_arena[(size_t)b * 2 * N + r] : 0.f;
    lo[k] = hi[k] = z[k] = y[k] = ax[k] = 0.f;
    dr[k] = 1.f;
  }
  __syncwarp();
  // knot lane k: the gram terms, the free-response position, the arena
  // rows' scales
  float gxx = 0.f, gxy = 0.f, gyy = 0.f, p0x = 0.f, p0y = 0.f;
  if (lane < N) {
    for (int j = 0; j < n1; ++j) {
      const float sx = Ss[j * lds + lane], sy = Ss[j * lds + N + lane];
      gxx = gxx + sx * sx;
      gxy = gxy + sx * sy;
      gyy = gyy + sy * sy;
    }
    p0x = p0[((size_t)b * N + lane) * 2 + 0];
    p0y = p0[((size_t)b * N + lane) * 2 + 1];
    ds[lane] = 1.f / fmaxf(sqrtf(gxx), 1e-8f);
    ds[N + lane] = 1.f / fmaxf(sqrtf(gyy), 1e-8f);
  }
  const float one_m_alpha = 1.f - P.alpha;

  // Rebuild the scaled own rows of A at the point in xs: row scales into dr,
  // bounds into lo/hi.
  auto relinearize = [&]() {
    if (lane < N) {
      float accx = p0x, accy = p0y;
      for (int j = 0; j < n1; ++j) {
        accx = accx + Ss[j * lds + lane] * xs[j];
        accy = accy + Ss[j * lds + N + lane] * xs[j];
      }
      for (int mm = 0; mm < M; ++mm) {
        const float dx = accx - ob[2 * mm], dy = accy - ob[2 * mm + 1];
        const float nrm = 2.f * sqrtf(dx * dx * gxx + 2.f * dx * dy * gxy +
                                      dy * dy * gyy);
        const float gval = dx * dx + dy * dy - P.d2;
        const float rhs = 2.f * (dx * accx + dy * accy) - gval -
                          2.f * (dx * p0x + dy * p0y);
        const int q = mm * N + lane;
        dxs[q] = dx;
        dys[q] = dy;
        ws[2 * N + q] = rhs;
        ds[2 * N + q] = 1.f / fmaxf(nrm, 1e-8f);
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      const int r = lane + WARP * k;
      if (r < m) {
        dr[k] = ds[r];
        if (r < 2 * N) {
          lo[k] = la[k] * dr[k];
          hi[k] = ha[k] * dr[k];
        } else {
          lo[k] = ws[r] * dr[k];
          hi[k] = 1e9f * dr[k];
        }
      }
    }
    for (int e = lane; e < m * n1; e += WARP) {
      const int j = e / m, r = e - j * m;
      const float* sj = Ss + j * lds;
      float a;
      if (r < 2 * N) {
        a = sj[r];
      } else {
        const int q = r - 2 * N, kn = q % N;
        a = 2.f * (dxs[q] * sj[kn] + dys[q] * sj[N + kn]);
      }
      As[j * ldm + r] = a * ds[r];
    }
    __syncwarp();
  };

  // z_own = A x for the iterate in xs
  auto reseed = [&]() {
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      const int r = lane + WARP * k;
      if (r < m) {
        float acc = 0.f;
        for (int j = 0; j < n1; ++j) acc += As[j * ldm + r] * xs[j];
        z[k] = acc;
      }
    }
  };

  float prim = 0.f, dual = 0.f, p_sc = 1.f, d_sc = 1.f;

  auto segment = [&](int iters) {
    // ---- K = H + (sigma + rho) I + rho A'A (lower triangle)
    for (int e = lane; e < n1 * n1; e += WARP) {
      const int j = e / n1, i = e - j * n1;
      if (i >= j) {
        const float* ai = As + i * ldm;
        const float* aj = As + j * ldm;
        float acc = 0.f;
        for (int r = 0; r < m; ++r) acc += ai[r] * aj[r];
        float kij = Hb[i * n1 + j] + rho_s * acc;
        if (i == j) kij += P.sigma + rho_s;
        Ms[j * ldn + i] = kij;
      }
    }
    __syncwarp();
    // ---- Cholesky in place, right-looking: column j of L over column j of K
    for (int j = 0; j < n1; ++j) {
      const float d = Ms[j * ldn + j];
      __syncwarp();
      const float ljj = sqrtf(d);
      const float piv = 1.0f / ljj;
      for (int i = j + lane; i < n1; i += WARP)
        Ms[j * ldn + i] = i == j ? ljj : Ms[j * ldn + i] * piv;
      __syncwarp();
      const int t = n1 - j - 1;
      for (int e = lane; e < t * t; e += WARP) {
        const int kk = e / t, ii = e - kk * t;
        if (ii >= kk) {
          const int k = j + 1 + kk, i = j + 1 + ii;
          Ms[k * ldn + i] -= Ms[j * ldn + i] * Ms[j * ldn + k];
        }
      }
      __syncwarp();
    }
    // ---- C = L^-1 by forward substitution, one column per lane
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int c = lane + WARP * q;
      if (c < n1) {
        float* Cc = Cs + c * ldn;
        for (int i = 0; i < c; ++i) Cc[i] = 0.f;
        for (int i = c; i < n1; ++i) {
          float acc = 0.f;
          for (int k = c; k < i; ++k) acc += Ms[k * ldn + i] * Cc[k];
          Cc[i] = ((i == c ? 1.f : 0.f) - acc) / Ms[i * ldn + i];
        }
      }
    }
    __syncwarp();

    // ---- ADMM iterations
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int k = 0; k < RM; ++k) {
        const int r = lane + WARP * k;
        if (r < m) ws[r] = rho_s * z[k] - y[k];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int i = lane + WARP * q;
        if (i < n1) {
          const float* ai = As + i * ldm;
          float acc = 0.f;
          for (int r = 0; r < m; ++r) acc += ai[r] * ws[r];
          rs[i] = P.sigma * xi[q] - gi[q] + acc + (rho_s * zx[q] - yx[q]);
        }
      }
      __syncwarp();
      // x = C'(C r): t = C r into the dead L's first column, then C't
      float* ts = Ms;
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int i = lane + WARP * q;
        if (i < n1) {
          float acc = 0.f;
          for (int k = 0; k <= i; ++k) acc += Cs[k * ldn + i] * rs[k];
          ts[i] = acc;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int i = lane + WARP * q;
        if (i < n1) {
          const float* ci = Cs + i * ldn;
          float acc = 0.f;
          for (int k = i; k < n1; ++k) acc += ci[k] * ts[k];
          xi[q] = acc;
          xs[i] = acc;
          const float zt = P.alpha * acc + one_m_alpha * zx[q];
          const float zn = fminf(fmaxf(zt + yx[q] / rho_s, lxi[q]), uxi[q]);
          yx[q] = yx[q] + rho_s * (zt - zn);
          zx[q] = zn;
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < RM; ++k) {
        const int r = lane + WARP * k;
        if (r < m) {
          float acc = 0.f;
          for (int j = 0; j < n1; ++j) acc += As[j * ldm + r] * xs[j];
          ax[k] = acc;
          const float zt = P.alpha * acc + one_m_alpha * z[k];
          const float zn = fminf(fmaxf(zt + y[k] / rho_s, lo[k]), hi[k]);
          y[k] = y[k] + rho_s * (zt - zn);
          z[k] = zn;
        }
      }
    }

    // ---- residuals and the adaptive rho update (ax is the last
    // iteration's, computed from the final x)
    float pr = 0.f, am = 0.f, zm = 0.f;
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      const int r = lane + WARP * k;
      if (r < m) {
        ws[r] = y[k];
        pr = fmaxf(pr, fabsf(ax[k] - z[k]));
        am = fmaxf(am, fabsf(ax[k]));
        zm = fmaxf(zm, fabsf(z[k]));
      }
    }
    __syncwarp();
    float du = 0.f, hm = 0.f, atm = 0.f, gm = 0.f;
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int i = lane + WARP * q;
      if (i < n1) {
        pr = fmaxf(pr, fabsf(xi[q] - zx[q]));
        am = fmaxf(am, fabsf(xi[q]));
        zm = fmaxf(zm, fabsf(zx[q]));
        const float* hrow = Hb + (size_t)i * n1;
        float hx = 0.f;
        for (int j = 0; j < n1; ++j) hx += hrow[j] * xs[j];
        const float* ai = As + i * ldm;
        float aty = 0.f;
        for (int r = 0; r < m; ++r) aty += ai[r] * ws[r];
        aty = aty + yx[q];
        du = fmaxf(du, fabsf(hx + gi[q] + aty));
        hm = fmaxf(hm, fabsf(hx));
        atm = fmaxf(atm, fabsf(aty));
        gm = fmaxf(gm, fabsf(gi[q]));
      }
    }
    prim = warp_max(pr);
    dual = warp_max(du);
    p_sc = fmaxf(warp_max(am), warp_max(zm)) + 1e-9f;
    d_sc = fmaxf(fmaxf(warp_max(hm), warp_max(atm)), warp_max(gm)) + 1e-9f;
    const float ratio = sqrtf((prim / p_sc) / (dual / d_sc + 1e-12f));
    rho_s = fminf(fmaxf(rho_s * fminf(fmaxf(ratio, 0.2f), 5.0f), 1e-6f),
                  1e8f);
    __syncwarp();
  };

  // ---- SQP iteration 1: cold ADMM start at the linearization point U0
  relinearize();
  for (int s = 0; s < P.n_seg0; ++s) segment(P.it0);
  // ---- SQP iterations 2..: relinearize at x, rescale the row duals,
  // reseed z = A_new x, one warm segment with the carried rho
  for (int s = 0; s < P.sqp_rest; ++s) {
    float d_old[RM];
#pragma unroll
    for (int k = 0; k < RM; ++k) d_old[k] = dr[k];
    __syncwarp();
    relinearize();
#pragma unroll
    for (int k = 0; k < RM; ++k) y[k] = y[k] * (d_old[k] / dr[k]);
    reseed();
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

template <int RM>
int launch(const float* const* in, float* x, float* stats, const Params& P,
           cudaStream_t stream) {
  const size_t per_warp = (size_t)warp_floats(dims(P.N, P.M)) * sizeof(float);
  int warps = MAX_WARPS;
  while (warps > 1 && warps * per_warp > SMEM_MAX) --warps;
  if (per_warp > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const size_t bytes = warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      dmpc_sqp_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P.B + warps - 1) / warps), block(WARP * warps);
  dmpc_sqp_kernel<RM><<<grid, block, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], x,
      stats, P);
  return (int)cudaGetLastError();
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
  const int n1 = 2 * N, m = 2 * N + M * N;
  if (N < 1 || n1 % 8 != 0 || n1 > MAX_N1 || M < 0 || m > MAX_M || B < 1 ||
      n_seg0 < 1 || it0 < 1 || sqp_rest < 0 || (sqp_rest > 0 && it_rest < 1))
    return (int)cudaErrorInvalidValue;
  const Params P{B, N, M, n_seg0, it0, sqp_rest, it_rest, rho, sigma, alpha,
                 tol, dual_tol, d2, inv_n1};
  const float* in[10] = {H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0};
  cudaStream_t st = (cudaStream_t)stream;
  const int rm = (m + WARP - 1) / WARP;
  if (rm <= 1) return launch<1>(in, x, stats, P, st);
  if (rm <= 2) return launch<2>(in, x, stats, P, st);
  if (rm <= 4) return launch<4>(in, x, stats, P, st);
  return launch<8>(in, x, stats, P, st);
}

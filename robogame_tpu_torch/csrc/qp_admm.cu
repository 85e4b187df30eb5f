// K2: batched dense OSQP-style ADMM QP solve, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel robogame_tpu/ops/qp_pallas.py:100 (_make_kernel,
// launched by solve_qp_lanes).  It computes what that kernel computes, the
// same algorithm as the plain version robogame_tpu_torch/ops/qp.py::solve_qp:
//
//   min 1/2 x'Hx + g'x  s.t.  l <= Ax <= u
//   rho0 = clip(tr(H)/n, 1e-3, 1e6) * rho; equality rows (l == u) at 1e3 rho;
//   n_seg segments, each: K = H + sigma I + A' diag(rho) A, Cholesky K = LL',
//   C = L^-1, Kinv = C'C, then seg_iters ADMM iterations with
//   over-relaxation alpha; residuals and the adaptive rho update; the last
//   segment's residuals give the convergence flag.
//
// This is K2's per-problem route: the CBF filter's distinct QPs, every
// shape beyond csrc/qp_grouped.cu's (n <= 32, m <= 64) or group below 32,
// and (rg_qp_admm_listed) the problems of a grouped launch that have an
// equality row, whose indices and count that launch left on the device.
//
// Layout: one warp per problem.  The warp keeps A (m x n), K/L then Kinv
// (n x n) and C (n x n) in shared memory, column-major with odd leading
// dimensions so that lanes walking rows or columns hit distinct banks, plus
// three short vectors.  Each lane owns the constraint rows r = lane + 32k
// (z, y, l, u, rho and Ax stay in its registers) and the variables
// i = lane + 32k.  Problem p reads the shared operands H and A at index
// p / group (the skills' 16 final-time candidates share them across games),
// g, l and u at p.
//
// What bounds it: operations, not bytes.  A skills QP (n=30, m=60, 60
// iterations in 4 segments) moves about 0.7 KB of its own data and does
// about 1 MFLOP: per segment a K formation (m n^2), a factorization and an
// explicit inverse (n^3), per iteration two products with A and one with
// Kinv.  The design keeps every operand of those products in shared memory
// for the whole solve, so device memory is read once per problem, and runs
// the factorization once per segment so that an iteration is three
// matrix-vector products; the iterations of a problem are a dependent chain
// of warp-wide steps, so the kernel relies on many problems in flight.
//
// Numerics: built with -fmad=false and no fast math; IEEE division and
// square root (1.0f / sqrtf(d) for the pivot, not rsqrtf).  Sums run in
// another order than torch's batched products, so the kernel is held to the
// plain version by tolerance.
//
// Supported shapes: 1 <= n <= 64, 1 <= m <= 256; anything else is refused at
// launch (the wrapper raises first).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int WARP = 32;
constexpr int MAX_N = 64;
constexpr int MAX_M = 256;
constexpr int RN = MAX_N / WARP;        // variables per lane
constexpr int MAX_WARPS = 4;            // problems per block
constexpr size_t SMEM_MAX = 232448;     // a block's shared memory on H100
constexpr int LISTED_BLOCKS = 1056;     // 8 blocks an SM for a listed launch

__host__ __device__ inline int warp_floats(int n, int m) {
  const int ldn = n | 1, ldm = m | 1;
  return n * ldm + 2 * n * ldn + ldm + 2 * ldn;
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

// One problem p on one warp, in the warp's shared memory `smem`.
// RM: constraint rows per lane, ceil(m / 32) rounded up to 1, 2, 4 or 8.
template <int RM>
__device__ __forceinline__ void solve_one(
    float* smem, int p, const float* __restrict__ H,
    const float* __restrict__ g, const float* __restrict__ A,
    const float* __restrict__ l, const float* __restrict__ u,
    float* __restrict__ xout, float* __restrict__ stats, int n, int m,
    int group, int n_seg, int seg_iters, float rho, float sigma, float alpha,
    float tol, float dual_tol) {
  const int lane = threadIdx.x & (WARP - 1);
  const int ldn = n | 1, ldm = m | 1;
  float* As = smem;             // A[r][j] at j*ldm+r
  float* Ms = As + n * ldm;     // K -> L -> Kinv; M[i][j] at j*ldn+i
  float* Cs = Ms + n * ldn;     // C = L^-1;       C[i][j] at j*ldn+i
  float* ws = Cs + n * ldn;     // a row vector: rho, w, y
  float* xs = ws + ldm;         // x
  float* rs = xs + ldn;         // the iteration's right-hand side

  const int op = p / group;
  const float* Hp = H + (size_t)op * n * n;
  const float* Ap = A + (size_t)op * m * n;
  const float* gp = g + (size_t)p * n;
  const float* lp = l + (size_t)p * m;
  const float* up = u + (size_t)p * m;

  for (int e = lane; e < m * n; e += WARP) {
    const int r = e / n, j = e - r * n;
    As[j * ldm + r] = Ap[e];
  }
  float lo[RM], hi[RM], z[RM], y[RM], rv[RM], ax[RM];
  bool eq[RM];
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    const int r = lane + WARP * k;
    const bool ok = r < m;
    lo[k] = ok ? lp[r] : 0.f;
    hi[k] = ok ? up[r] : 0.f;
    eq[k] = lo[k] == hi[k];
    z[k] = 0.f;
    y[k] = 0.f;
    rv[k] = 1.f;
    ax[k] = 0.f;
  }
  float gi[RN], xi[RN];
  float tr = 0.f;
#pragma unroll
  for (int q = 0; q < RN; ++q) {
    const int i = lane + WARP * q;
    gi[q] = i < n ? gp[i] : 0.f;
    xi[q] = 0.f;
    if (i < n) {
      xs[i] = 0.f;
      tr += Hp[i * n + i];
    }
  }
  tr = warp_sum(tr);
  float rho_s = fminf(fmaxf(tr / (float)n, 1e-3f), 1e6f) * rho;
  const float one_m_alpha = 1.f - alpha;
  float prim = 0.f, dual = 0.f, p_sc = 1.f, d_sc = 1.f;

  for (int s = 0; s < n_seg; ++s) {
    // ---- rho per row; K = H + sigma I + A' diag(rho) A (lower triangle)
    const float rho_eq = 1e3f * rho_s;
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      const int r = lane + WARP * k;
      rv[k] = eq[k] ? rho_eq : rho_s;
      if (r < m) ws[r] = rv[k];
    }
    __syncwarp();
    for (int e = lane; e < n * n; e += WARP) {
      const int j = e / n, i = e - j * n;
      if (i >= j) {
        const float* ai = As + i * ldm;
        const float* aj = As + j * ldm;
        float acc = 0.f;
        for (int r = 0; r < m; ++r) acc += ai[r] * ws[r] * aj[r];
        float hij = Hp[i * n + j];
        if (i == j) hij += sigma;
        Ms[j * ldn + i] = hij + acc;
      }
    }
    __syncwarp();
    // ---- Cholesky in place, right-looking: column j of L over column j of K
    for (int j = 0; j < n; ++j) {
      const float d = Ms[j * ldn + j];
      __syncwarp();
      const float ljj = sqrtf(d);
      const float piv = 1.0f / ljj;
      for (int i = j + lane; i < n; i += WARP)
        Ms[j * ldn + i] = i == j ? ljj : Ms[j * ldn + i] * piv;
      __syncwarp();
      const int t = n - j - 1;
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
      if (c < n) {
        float* Cc = Cs + c * ldn;
        for (int i = 0; i < c; ++i) Cc[i] = 0.f;
        for (int i = c; i < n; ++i) {
          float acc = 0.f;
          for (int k = c; k < i; ++k) acc += Ms[k * ldn + i] * Cc[k];
          Cc[i] = ((i == c ? 1.f : 0.f) - acc) / Ms[i * ldn + i];
        }
      }
    }
    __syncwarp();
    // ---- Kinv = C'C (full, symmetric) over the dead L
    for (int e = lane; e < n * n; e += WARP) {
      const int j = e / n, i = e - j * n;
      const float* ci = Cs + i * ldn;
      const float* cj = Cs + j * ldn;
      float acc = 0.f;
      for (int k = i > j ? i : j; k < n; ++k) acc += ci[k] * cj[k];
      Ms[j * ldn + i] = acc;
    }
    __syncwarp();

    // ---- ADMM iterations
    for (int it = 0; it < seg_iters; ++it) {
#pragma unroll
      for (int k = 0; k < RM; ++k) {
        const int r = lane + WARP * k;
        if (r < m) ws[r] = rv[k] * z[k] - y[k];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int i = lane + WARP * q;
        if (i < n) {
          const float* ai = As + i * ldm;
          float acc = 0.f;
          for (int r = 0; r < m; ++r) acc += ai[r] * ws[r];
          rs[i] = sigma * xi[q] - gi[q] + acc;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int i = lane + WARP * q;
        if (i < n) {
          float acc = 0.f;
          for (int j = 0; j < n; ++j) acc += Ms[j * ldn + i] * rs[j];
          xi[q] = acc;
          xs[i] = acc;
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < RM; ++k) {
        const int r = lane + WARP * k;
        if (r < m) {
          float acc = 0.f;
          for (int j = 0; j < n; ++j) acc += As[j * ldm + r] * xs[j];
          ax[k] = acc;
          const float zt = alpha * acc + one_m_alpha * z[k];
          const float zn = fminf(fmaxf(zt + y[k] / rv[k], lo[k]), hi[k]);
          y[k] = y[k] + rv[k] * (zt - zn);
          z[k] = zn;
        }
      }
    }

    // ---- residuals and the adaptive rho update (Ax is the last
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
      if (i < n) {
        const float* hrow = Hp + (size_t)i * n;
        float hx = 0.f;
        for (int j = 0; j < n; ++j) hx += hrow[j] * xs[j];
        const float* ai = As + i * ldm;
        float aty = 0.f;
        for (int r = 0; r < m; ++r) aty += ai[r] * ws[r];
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
  }

  const bool conv = (prim < tol * p_sc) && (dual < dual_tol * d_sc);
#pragma unroll
  for (int q = 0; q < RN; ++q) {
    const int i = lane + WARP * q;
    if (i < n) xout[(size_t)p * n + i] = xi[q];
  }
  if (lane == 0) {
    stats[(size_t)p * 3 + 0] = conv ? 1.f : 0.f;
    stats[(size_t)p * 3 + 1] = prim;
    stats[(size_t)p * 3 + 2] = dual;
  }
}

template <int RM>
__global__ void __launch_bounds__(WARP * MAX_WARPS)
qp_admm_kernel(const float* __restrict__ H, const float* __restrict__ g,
               const float* __restrict__ A, const float* __restrict__ l,
               const float* __restrict__ u, float* __restrict__ xout,
               float* __restrict__ stats, int P, int n, int m, int group,
               int n_seg, int seg_iters, float rho, float sigma, float alpha,
               float tol, float dual_tol) {
  extern __shared__ float smem[];
  const int wib = threadIdx.x / WARP;
  const int p = blockIdx.x * (blockDim.x / WARP) + wib;
  if (p >= P) return;                       // the whole warp leaves together
  solve_one<RM>(smem + (size_t)wib * warp_floats(n, m), p, H, g, A, l, u,
                xout, stats, n, m, group, n_seg, seg_iters, rho, sigma, alpha,
                tol, dual_tol);
}

// The problems listed[0 .. *n_listed) only (a count on the device, so the
// launch needs no host fetch): each warp takes every (gridDim.x * warps)-th.
template <int RM>
__global__ void __launch_bounds__(WARP * MAX_WARPS)
qp_admm_listed_kernel(const float* __restrict__ H,
                      const float* __restrict__ g,
                      const float* __restrict__ A,
                      const float* __restrict__ l,
                      const float* __restrict__ u, float* __restrict__ xout,
                      float* __restrict__ stats,
                      const int* __restrict__ listed,
                      const int* __restrict__ n_listed,
                      unsigned long long* __restrict__ routed, int n, int m,
                      int group, int n_seg, int seg_iters, float rho,
                      float sigma, float alpha, float tol, float dual_tol) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / WARP;
  const int wib = threadIdx.x / WARP;
  const int count = *n_listed;
  if (routed != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&routed[1], (unsigned long long)count);
  for (int q = blockIdx.x * warps + wib; q < count; q += gridDim.x * warps) {
    solve_one<RM>(smem + (size_t)wib * warp_floats(n, m), listed[q], H, g, A,
                  l, u, xout, stats, n, m, group, n_seg, seg_iters, rho,
                  sigma, alpha, tol, dual_tol);
    __syncwarp();
  }
}

// listed == nullptr: every problem; else the listed ones.
template <int RM>
int launch(const float* H, const float* g, const float* A, const float* l,
           const float* u, float* x, float* stats, const int* listed,
           const int* n_listed, unsigned long long* routed, int P, int n,
           int m, int group, int n_seg, int seg_iters, float rho,
           float sigma, float alpha, float tol, float dual_tol,
           cudaStream_t stream) {
  const size_t per_warp = (size_t)warp_floats(n, m) * sizeof(float);
  int warps = MAX_WARPS;
  while (warps > 1 && warps * per_warp > SMEM_MAX) warps /= 2;
  const size_t bytes = warps * per_warp;
  int blocks = (P + warps - 1) / warps;
  cudaError_t err;
  if (listed == nullptr) {
    err = cudaFuncSetAttribute(qp_admm_kernel<RM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    qp_admm_kernel<RM><<<blocks, WARP * warps, bytes, stream>>>(
        H, g, A, l, u, x, stats, P, n, m, group, n_seg, seg_iters, rho,
        sigma, alpha, tol, dual_tol);
  } else {
    err = cudaFuncSetAttribute(qp_admm_listed_kernel<RM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    blocks = blocks < LISTED_BLOCKS ? blocks : LISTED_BLOCKS;
    qp_admm_listed_kernel<RM><<<blocks, WARP * warps, bytes, stream>>>(
        H, g, A, l, u, x, stats, listed, n_listed, routed, n, m, group,
        n_seg, seg_iters, rho, sigma, alpha, tol, dual_tol);
  }
  return (int)cudaGetLastError();
}

int dispatch(const float* H, const float* g, const float* A, const float* l,
             const float* u, float* x, float* stats, const int* listed,
             const int* n_listed, unsigned long long* routed, int P, int n,
             int m, int group, int n_seg, int seg_iters, float rho,
             float sigma, float alpha, float tol, float dual_tol,
             void* stream) {
  if (n < 1 || n > MAX_N || m < 1 || m > MAX_M || P < 1 || group < 1 ||
      P % group != 0 || n_seg < 1 || seg_iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rm = (m + WARP - 1) / WARP;
  auto run = [&](auto tag) {
    constexpr int R = decltype(tag)::value;
    return launch<R>(H, g, A, l, u, x, stats, listed, n_listed, routed, P, n,
                     m, group, n_seg, seg_iters, rho, sigma, alpha, tol,
                     dual_tol, st);
  };
  if (rm <= 1) return run(std::integral_constant<int, 1>());
  if (rm <= 2) return run(std::integral_constant<int, 2>());
  if (rm <= 4) return run(std::integral_constant<int, 4>());
  return run(std::integral_constant<int, 8>());
}

}  // namespace

// H (P/group, n, n), g (P, n), A (P/group, m, n), l/u (P, m) in; x (P, n)
// and stats (P, 3) = [converged, prim_res, dual_res] out; all float32,
// contiguous, row-major.  dual_tol is the caller's 10 * tol rounded once.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int rg_qp_admm(const float* H, const float* g, const float* A,
                          const float* l, const float* u, float* x,
                          float* stats, int P, int n, int m, int group,
                          int n_seg, int seg_iters, float rho, float sigma,
                          float alpha, float tol, float dual_tol,
                          void* stream) {
  return dispatch(H, g, A, l, u, x, stats, nullptr, nullptr, nullptr, P, n,
                  m, group, n_seg, seg_iters, rho, sigma, alpha, tol,
                  dual_tol, stream);
}

// The same over the problems listed[0 .. *n_listed) of the P only (the
// equality-row problems of a grouped launch, csrc/qp_grouped.cu); the count
// stays on the device.  routed[1] (may be null) accumulates the count.
extern "C" int rg_qp_admm_listed(const float* H, const float* g,
                                 const float* A, const float* l,
                                 const float* u, float* x, float* stats,
                                 const int* listed, const int* n_listed,
                                 unsigned long long* routed, int P, int n,
                                 int m, int group, int n_seg, int seg_iters,
                                 float rho, float sigma, float alpha,
                                 float tol, float dual_tol, void* stream) {
  return dispatch(H, g, A, l, u, x, stats, listed, n_listed, routed, P, n, m,
                  group, n_seg, seg_iters, rho, sigma, alpha, tol, dual_tol,
                  stream);
}

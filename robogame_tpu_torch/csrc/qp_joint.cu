// K5: the structured two-agent ADMM QP solve (the CMPC shape), written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel robogame_tpu/ops/qp_pallas.py:420-655
// (_make_joint_kernel, with _chol_in_place :392 and _trtri_in_place :405)
// and its launch in solve_qp_lanes_joint (:659-787).  It computes what that
// kernel computes, the algorithm of the plain version
// robogame_tpu_torch/ops/qp_lanes.py::solve_qp_lanes_joint_plain; the
// wrapper is robogame_tpu_torch/kernels.py::qp_joint, and the row scaling
// by the full joint-row norm stays in the caller, as in the JAX wrapper.
// Per problem: n_seg cold adaptive-rho segments of seg_iters iterations of
// the block-Schur ADMM in csrc/joint_schur.cuh, starting from x = z = y = 0
// and rho0 = clip(tr(H) / 2 n1, 1e-3, 1e6) rho; the flag from the last
// segment's residuals.
//
// What bounds it: operations.  At CMPC's shape (n1 = 40 a player, m_own =
// 80, m_pair = 20, 150 iterations in 4 segments) one QP needs about 11
// MFLOP (chip_smoke.py::k5_flops), a launch over 4,096 candidates about 43
// GFLOP: about 0.64 ms at the H100's 67 TFLOP/s in f32 against 0.06 ms to
// move its 0.19 GB of A, H and bounds once.  An iteration is four
// dependent products over shared memory (A'w, L^-1 r, L^-T t, A x), each
// read once from shared memory, so what decides the time is the shared
// loads an iteration issues, the barriers between the products and the
// problems in flight.  One block of 160 threads solves one problem, every
// thread on every product, four barriers an iteration, A and the factors in
// shared memory (57,184 bytes at that shape, four problems an SM; see
// joint_schur.cuh).
//
// Supported shapes: n1 <= 64 with n1 % 8 == 0 and R = 2 m_own + m_pair <=
// 512 rows, within the shared memory of a block; anything else is refused
// at launch (the wrapper raises first).  CMPC's shape runs a kernel
// specialized to it at compile time.

#include "joint_schur.cuh"

namespace {

using joint::NT;

struct Params {
  int B, n1, mo, mp, n_seg, seg_iters;
  float rho, sigma, alpha, tol, dual_tol, inv_n2;
};

// CN1, CMO, CMP: the shape fixed at compile time (0: read from P); PV
// variable tasks, RM row tasks and PT factor tiles a thread; PC lanes a
// pair row; MB blocks an SM that the registers must allow.
template <int CN1, int CMO, int CMP, int PV, int RM, int PC, int PT, int MB>
__global__ void __launch_bounds__(NT, MB)
qp_joint_kernel(const float* __restrict__ Hb, const float* __restrict__ g,
                const float* __restrict__ Ab, const float* __restrict__ l,
                const float* __restrict__ u, const float* __restrict__ lx,
                const float* __restrict__ ux, float* __restrict__ xout,
                float* __restrict__ stats, Params P) {
  extern __shared__ float4 smem4[];       // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const joint::Dims D = joint::dims(CN1 ? CN1 : P.n1, CMO ? CMO : P.mo,
                                    CMP ? CMP : P.mp);
  const int b = blockIdx.x, t = threadIdx.x;
  const int n1 = D.n1, n2 = 2 * n1, m1 = D.m1;
  const joint::Solver s = joint::carve(
      smem, D, Hb + (size_t)b * 2 * n1 * n1, P.sigma, P.alpha);

  // A (2, m1, n1) row-major -> player p's column j at (p n1 + j) ldm,
  // its rows m1 .. m1p - 1 zero, as are the rows' views' padding and x
  const float* Ag = Ab + (size_t)b * 2 * m1 * n1;
  for (int e = t; e < 2 * m1 * n1; e += NT) {
    const int p = e / (m1 * n1), rem = e - p * m1 * n1;
    const int r = rem / n1, j = rem - r * n1;
    s.A[(p * n1 + j) * D.ldm + r] = Ag[e];
  }
  const int pad = D.m1p - m1;
  for (int e = t; e < n2 * pad; e += NT)
    s.A[(e / pad) * D.ldm + m1 + e % pad] = 0.f;
  for (int e = t; e < 4 * D.m1p; e += NT) s.rho[e] = 0.f;   // rho, w
  for (int e = t; e < n2; e += NT) s.xs[e] = 0.f;
  joint::Own<PV, RM> o;
  o.rho = joint::rho0(s, P.rho, P.inv_n2);
#pragma unroll
  for (int k = 0; k < PV; ++k) {
    const int v = (t + NT * k) >> 1;
    const bool ok = v < n2;
    o.x[k] = o.zx[k] = o.yx[k] = 0.f;
    o.g[k] = ok ? g[(size_t)b * n2 + v] : 0.f;
    o.lx[k] = ok ? lx[(size_t)b * n2 + v] : 0.f;
    o.ux[k] = ok ? ux[(size_t)b * n2 + v] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    int q, c;
    bool ok;
    joint::row_task<PC>(D, t + NT * k, q, c, ok);
    ok = ok && c == 0;
    o.lo[k] = ok ? l[(size_t)b * D.R + q] : 0.f;
    o.hi[k] = ok ? u[(size_t)b * D.R + q] : 0.f;
    o.eq[k] = ok && o.lo[k] == o.hi[k];
    o.z[k] = o.y[k] = o.ax[k] = o.ro[k] = 0.f;
  }
  __syncthreads();
  for (int seg = 0; seg < P.n_seg; ++seg)
    joint::segment<PV, RM, PC, PT>(s, o, P.seg_iters);

  // x (2 n1) and stats (5) = [converged, prim, dual, p_sc, d_sc]
#pragma unroll
  for (int k = 0; k < PV; ++k) {
    const int tau = t + NT * k, v = tau >> 1;
    if (v < n2 && (tau & 1) == 0) xout[(size_t)b * n2 + v] = o.x[k];
  }
  if (t == 0) {
    const bool conv = (o.prim < P.tol * o.p_sc) &&
                      (o.dual < P.dual_tol * o.d_sc);
    float* st = stats + (size_t)b * 5;
    st[0] = conv ? 1.f : 0.f;
    st[1] = o.prim;
    st[2] = o.dual;
    st[3] = o.p_sc;
    st[4] = o.d_sc;
  }
}

template <int CN1, int CMO, int CMP, int PV, int RM, int PC, int PT, int MB>
int launch(const float* const* in, float* x, float* stats, const Params& P,
           cudaStream_t stream, int* occ) {
  const joint::Dims D = joint::dims(P.n1, P.mo, P.mp);
  const size_t bytes = (size_t)joint::solver_floats(D) * sizeof(float);
  if (bytes > joint::SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = qp_joint_kernel<CN1, CMO, CMP, PV, RM, PC, PT, MB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (occ != nullptr) {                  // the occupancy query only
    occ[1] = (int)bytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[0], kern,
                                                              NT, bytes);
  }
  kern<<<P.B, NT, bytes, stream>>>(in[0], in[1], in[2], in[3], in[4], in[5],
                                   in[6], x, stats, P);
  return (int)cudaGetLastError();
}

// The kernel for P's shape: CMPC's production shape specialized at compile
// time, every other supported shape read at run time; occ as in launch.
int dispatch(const float* const* in, float* x, float* stats,
             const Params& P, cudaStream_t st, int* occ) {
  const int R = 2 * P.mo + P.mp;
  if (P.B < 1 || P.n1 < 8 || P.n1 > joint::MAX_N1 || P.n1 % 8 != 0 ||
      P.mo < 0 || P.mp < 0 || R < 1 || R > joint::MAX_R || P.n_seg < 1 ||
      P.seg_iters < 1)
    return (int)cudaErrorInvalidValue;
  if (P.n1 == 40 && P.mo == 80 && P.mp == 20)   // 4 problems an SM, else 2
    return launch<40, 80, 20, 1, 2, 8, 1, 4>(in, x, stats, P, st, occ);
  constexpr int PV = (4 * joint::MAX_N1 + NT - 1) / NT;
  constexpr int RM = (joint::MAX_R + NT - 1) / NT;
  constexpr int PT = (joint::MAX_N1 * joint::MAX_N1 / 16 + NT - 1) / NT;
  return launch<0, 0, 0, PV, RM, 1, PT, 2>(in, x, stats, P, st, occ);
}

}  // namespace

// Hb (B, 2, n1, n1), g (B, 2 n1), Ab (B, 2, m_own + m_pair, n1), l/u (B, R)
// ordered [own 1, own 2, pair], lx/ux (B, 2 n1) in (rows already scaled);
// x (B, 2 n1) and stats (B, 5) = [converged, prim, dual, p_sc, d_sc] out;
// all float32, contiguous, row-major.  dual_tol is the caller's 10 tol and
// inv_n2 its 1 / (2 n1), each rounded once.  Returns the CUDA error of the
// launch (0 when it was accepted).
extern "C" int rg_qp_joint(const float* Hb, const float* g, const float* Ab,
                           const float* l, const float* u, const float* lx,
                           const float* ux, float* x, float* stats, int B,
                           int n1, int m_own, int m_pair, int n_seg,
                           int seg_iters, float rho, float sigma, float alpha,
                           float tol, float dual_tol, float inv_n2,
                           void* stream) {
  const Params P{B, n1, m_own, m_pair, n_seg, seg_iters, rho, sigma, alpha,
                 tol, dual_tol, inv_n2};
  const float* in[7] = {Hb, g, Ab, l, u, lx, ux};
  return dispatch(in, x, stats, P, (cudaStream_t)stream, nullptr);
}

// The problems an SM that K5 runs at (n1, m_own, m_pair), one a block (the
// card's occupancy calculator), into out[0], and its shared bytes a
// problem into out[1].  Returns the CUDA error (0 on success).
extern "C" int rg_qp_joint_occupancy(int n1, int m_own, int m_pair,
                                     int* out) {
  const Params P{1, n1, m_own, m_pair, 1, 1, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  out[0] = 0;
  out[1] = 0;
  return dispatch(nullptr, nullptr, nullptr, P, nullptr, out);
}

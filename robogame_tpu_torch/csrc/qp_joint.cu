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
// move its 0.19 GB of A, H and bounds once.  One block of 128 threads solves
// one problem with A and the factors in shared memory (55 KB at that
// shape, 4 problems an SM; see joint_schur.cuh); it runs far above its
// bound (PERF.md).
//
// Supported shapes: n1 <= 64 and R = 2 m_own + m_pair <= 512 rows, within
// the shared memory of a block; anything else is refused at launch (the
// wrapper raises first).

#include "joint_schur.cuh"

namespace {

using joint::NT;

struct Params {
  int B, n1, mo, mp, n_seg, seg_iters;
  float rho, sigma, alpha, tol, dual_tol, inv_n2;
};

template <int RM>
__global__ void __launch_bounds__(NT)
qp_joint_kernel(const float* __restrict__ Hb, const float* __restrict__ g,
                const float* __restrict__ Ab, const float* __restrict__ l,
                const float* __restrict__ u, const float* __restrict__ lx,
                const float* __restrict__ ux, float* __restrict__ xout,
                float* __restrict__ stats, Params P) {
  extern __shared__ float smem[];
  const joint::Dims D = joint::dims(P.n1, P.mo, P.mp);
  const int b = blockIdx.x, t = threadIdx.x;
  const int n1 = D.n1, n2 = 2 * n1, m1 = D.m1;
  const joint::Solver s = joint::carve(
      smem, D, Hb + (size_t)b * 2 * n1 * n1, P.sigma, P.alpha);

  // A (2, m1, n1) row-major -> player p's column j at (p n1 + j) ldm
  const float* Ag = Ab + (size_t)b * 2 * m1 * n1;
  for (int e = t; e < 2 * m1 * n1; e += NT) {
    const int p = e / (m1 * n1), rem = e - p * m1 * n1;
    const int r = rem / n1, j = rem - r * n1;
    s.A[(p * n1 + j) * D.ldm + r] = Ag[e];
  }
  joint::Own<RM> o;
  joint::cold_start(s, o, P.rho, P.inv_n2);
  if (t < n2) {
    o.g = g[(size_t)b * n2 + t];
    o.lx = lx[(size_t)b * n2 + t];
    o.ux = ux[(size_t)b * n2 + t];
    s.xs[t] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    const int q = t + NT * k;
    const bool ok = q < D.R;
    o.lo[k] = ok ? l[(size_t)b * D.R + q] : 0.f;
    o.hi[k] = ok ? u[(size_t)b * D.R + q] : 0.f;
    o.eq[k] = ok && o.lo[k] == o.hi[k];
  }
  __syncthreads();
  for (int seg = 0; seg < P.n_seg; ++seg) joint::segment(s, o, P.seg_iters);
  joint::write_out(s, o, b, P.tol, P.dual_tol, xout, stats);
}

template <int RM>
int launch(const float* const* in, float* x, float* stats, const Params& P,
           cudaStream_t stream) {
  const joint::Dims D = joint::dims(P.n1, P.mo, P.mp);
  const size_t bytes = (size_t)joint::solver_floats(D) * sizeof(float);
  if (bytes > joint::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      qp_joint_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  qp_joint_kernel<RM><<<P.B, NT, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], x, stats, P);
  return (int)cudaGetLastError();
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
  const int R = 2 * m_own + m_pair;
  if (B < 1 || n1 < 1 || n1 > joint::MAX_N1 || m_own < 0 || m_pair < 0 ||
      R < 1 || R > joint::MAX_R || n_seg < 1 || seg_iters < 1)
    return (int)cudaErrorInvalidValue;
  const Params P{B, n1, m_own, m_pair, n_seg, seg_iters, rho, sigma, alpha,
                 tol, dual_tol, inv_n2};
  const float* in[7] = {Hb, g, Ab, l, u, lx, ux};
  cudaStream_t st = (cudaStream_t)stream;
  const int rm = (R + NT - 1) / NT;
  if (rm <= 1) return launch<1>(in, x, stats, P, st);
  if (rm <= 2) return launch<2>(in, x, stats, P, st);
  return launch<4>(in, x, stats, P, st);
}

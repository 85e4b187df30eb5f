// K1: the event-order-exact control step of a batch of 2v2 air-hockey games.
//
// Replaces the TPU kernel robogame_tpu/physics/pallas_step.py::_make_kernel
// (:130) in its modes "exact", "exact_export" and "exact_resume", launched
// by _kernel_call (:1491).  The plain PyTorch version of the same function
// is robogame_tpu_torch/physics/exact_step.py::exact_step_plain; the
// wrapper is robogame_tpu_torch/kernels.py::exact_step.
//
// Per game, in order: populate the 51-column x 20-component sub-step grid
// as the affine map M [x; u] (+ populate noise); detect the first
// qualifying wall/pair event per entity; pop the globally-earliest event
// (ties -> highest entity), skipping events of an already-scored puck;
// resolve it (partial RK4, de-penetration + elastic impulse + damage, or
// wall flip + goal test); re-propagate the one or two involved entities
// column by column with overlap corrections fed back; invalidate stale
// slots and re-detect only the touched entities; loop until no slot is
// valid or `cap` events ran; finalize (decided games keep their inputs).
//
// What bounds it on the H100: the latency of dependent per-game chains on
// the CUDA cores.  Per game the populate is 1020 six-term sums and every
// detect column is up to 10 pair and 10 wall-axis candidate tests; an event
// adds two RK4 resolves and a sequential re-propagation over up to 50
// columns.  The data moved is small (the grid is 4 KB a game), so the bytes
// bound is far below the time the dependent per-game chains take.
//
// Design: a warp per game, WPB = 4 games a block (K6's layout).
// * The block's games read their grids (resume) or populate-noise planes
//   (stochastic populate) from the plane layout [20][G+1][B] into shared
//   memory together, WPB consecutive games a (component, column), and write
//   the grids back the same way at the end; in between a game's grid (20 x
//   51 floats, 4 KB) never leaves shared memory.  In stochastic mode the
//   re-propagation noise plane is staged beside it.  The compacted resume
//   of 512 pending games is 512 warps on 128 blocks, over all 132 SMs.
// * The populate's 1020 cells are split over the lanes, each the same
//   six-term sum in the same order.
// * Detect is step_common.cuh's detect_warp (K6's): the columns over the
//   lanes, the first qualifying one by __ballot_sync / __ffs; after an
//   event only the touched entities are re-detected, from the event's
//   column on.
// * Pop, resolve, the damage and goal bookkeeping and the feedback
//   re-propagation (each column's corrected position feeds the next, so it
//   cannot be split over columns) run in their serial order on every lane
//   alike (warp-uniform), reading and writing the grid in shared memory.
// Built with -fmad=false and IEEE division and square root: every f32
// operation is the one the plain version does, in the same order, so the
// kernel and the plain version agree bitwise.

#include <cuda_runtime.h>
#include <string.h>

#include "step_common.cuh"

namespace {

using namespace rg_step;
enum { MODE_EXACT = 0, MODE_EXPORT = 1, MODE_RESUME = 2 };

// One game b's control step on a warp: its grid in shared memory at sg
// (sg[c * K1 + k], holding the populate noise on entry in a stochastic
// populate, the exported grid in a resume), its re-propagation noise at
// srn (null when deterministic).
__device__ __forceinline__ void run_game(
    float* sg, const float* srn, const Consts& K, const float* __restrict__ M6,
    const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ meta, const float* __restrict__ dmgin,
    bool noisy, const float* __restrict__ carry_in, float* __restrict__ xout,
    float* __restrict__ aux, float* __restrict__ carry_out, int B, int K1,
    int b, int mode, int cap, int lane) {
  const int G = K1 - 1;
  const float s0 = meta[b], s1 = meta[B + b], t0 = meta[2 * B + b];
  const bool undec = s0 < K.ws && s1 < K.ws;

  float st[E];
  int sj[E], sc[E];
  bool sv[E];
  bool scored = false;
  float incA = 0.0f, incB = 0.0f, actv = 0.0f;
  float dacc[16];
  if (mode == MODE_RESUME) {
    // loop state verbatim from the export carry (rows: 0-4 st, 5-9 sj,
    // 10-14 sc, 15-19 sv, 20 scored, 21 incA, 22 incB, 23-38 dmg, 39 actv)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      st[e] = carry_in[e * B + b];
      sj[e] = (int)carry_in[(5 + e) * B + b];
      sc[e] = (int)carry_in[(10 + e) * B + b];
      sv[e] = carry_in[(15 + e) * B + b] > 0.5f;
    }
    scored = carry_in[20 * B + b] > 0.5f;
    incA = carry_in[21 * B + b];
    incB = carry_in[22 * B + b];
#pragma unroll
    for (int r = 0; r < 16; ++r) dacc[r] = carry_in[(23 + r) * B + b];
    actv = carry_in[39 * B + b];
  } else {
    float z[30];
#pragma unroll
    for (int j = 0; j < 20; ++j) z[j] = x[j * B + b];
#pragma unroll
    for (int j = 0; j < 10; ++j) z[20 + j] = u[j * B + b];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = c / 4;
      for (int k = lane; k <= G; k += WARP) {
        const float* m = M6 + ((size_t)c * K1 + k) * 6;
        float acc = m[0] * z[e * 4 + 0];
        acc = acc + m[1] * z[e * 4 + 1];
        acc = acc + m[2] * z[e * 4 + 2];
        acc = acc + m[3] * z[e * 4 + 3];
        acc = acc + m[4] * z[20 + 2 * e];
        acc = acc + m[5] * z[21 + 2 * e];
        if (noisy) acc = acc + sg[c * K1 + k];
        sg[c * K1 + k] = acc;
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) dacc[r] = 0.0f;
    __syncwarp();
    const int ones[E] = {1, 1, 1, 1, 1};
    detect_warp(sg, K1, K, (1 << E) - 1, ones, lane, st, sj, sc, sv);
  }
  float ux[E], uy[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ux[e] = u[(2 * e) * B + b];
    uy[e] = u[(2 * e + 1) * B + b];
  }

  int it = 0;
  while (it < cap && (sv[0] || sv[1] || sv[2] || sv[3] || sv[4])) {
    // --- pop the earliest valid slot; ties -> highest entity index
    int a = -1, ct = 0, jr = 0;
    float tp = INF_T;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (sv[e] && (a < 0 || st[e] <= tp)) {
        a = e;
        tp = st[e];
        ct = sc[e];
        jr = sj[e];
      }
    const bool is_pair = ct == 4;
    const int ej = is_pair ? jr : 0;
    ++it;
    actv += 1.0f;
    if ((a == PUCK || (is_pair && ej == PUCK)) && scored) {
      // scored latch: the pop uses up an iteration, nothing else changes
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e == a) sv[e] = false;
      continue;
    }

    // --- gather the two involved entities at column km1
    int km1 = (int)(tp / K.dtcol);
    km1 = km1 < 0 ? 0 : (km1 > G - 1 ? G - 1 : km1);
    const int bn = km1 + 1;
    float* gi = sg + a * 4 * K1;         // entity a's rows
    float* gj = sg + ej * 4 * K1;        // entity ej's rows
    float xi[4], xj[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xi[c] = gi[c * K1 + km1];
      xj[c] = gj[c * K1 + km1];
    }
    const float r_i = pick(K.r, a), r_j = pick(K.r, ej);
    const float m_i = pick(K.m, a), m_j = pick(K.m, ej);
    const float tau_i = pick(K.tau, a), tau_j = pick(K.tau, ej);
    const float drag_i = pick(K.drag, a), drag_j = pick(K.drag, ej);
    const float uix = pick(ux, a), uiy = pick(uy, a);
    const float ujx = pick(ux, ej), ujy = pick(uy, ej);
    const float fa_i = pick(K.sa, a), fb_i = pick(K.sb, a);
    const float fa_j = pick(K.sa, ej), fb_j = pick(K.sb, ej);
    const float sci = pick(K.sc, a), sdi = pick(K.sd, a);
    const float scj = pick(K.sc, ej), sdj = pick(K.sd, ej);
    const float su_i[4] = {sci * uix, sci * uiy, sdi * uix, sdi * uiy};
    const float su_j[4] = {scj * ujx, scj * ujy, sdj * ujx, sdj * ujy};
    const float* ni = srn == nullptr ? nullptr : srn + a * 4 * K1;
    const float* nj = srn == nullptr ? nullptr : srn + ej * 4 * K1;

    const float dt_t = tp - (float)km1 * K.dtcol;
    float xit[4], xjt[4];
    rk4(xi, uix, uiy, tau_i, drag_i, dt_t, xit);
    rk4(xj, ujx, ujy, tau_j, drag_j, dt_t, xjt);
    if (srn != nullptr) {
      // one substep of re-propagation noise at t_pop, before the impulse
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xit[c] = xit[c] + ni[c * K1 + bn];
        xjt[c] = xjt[c] + nj[c * K1 + bn];
      }
    }

    // --- pair: de-penetrate (1.01) + elastic impulse
    const float pijx = xjt[0] - xit[0], pijy = xjt[1] - xit[1];
    const float pn = sqrtf(pijx * pijx + pijy * pijy);
    const float rr = r_i + r_j;
    const float ovl = rr - pn;
    const bool app = ovl > 0.0f;
    const float rsum = rr > 0.0f ? rr : 1.0f;
    const float ci = app ? 1.01f * r_i / rsum * ovl : 0.0f;
    const float cj = app ? 1.01f * r_j / rsum * ovl : 0.0f;
    const float p_ix = xit[0] - ci * pijx, p_iy = xit[1] - ci * pijy;
    const float p_jx = xjt[0] + cj * pijx, p_jy = xjt[1] + cj * pijy;
    const float d12x = p_ix - p_jx, d12y = p_iy - p_jy;
    float den = d12x * d12x + d12y * d12y;
    den = den > 0.0f ? den : 1.0f;
    const float rvx = xit[2] - xjt[2], rvy = xit[3] - xjt[3];
    const float dot = (rvx * d12x + rvy * d12y) / den;
    const float mm = m_i + m_j;
    const float msum = mm > 0.0f ? mm : 1.0f;
    const float vi_nx = xit[2] - 2.0f * m_j / msum * dot * d12x;
    const float vi_ny = xit[3] - 2.0f * m_j / msum * dot * d12y;
    const float vj_nx = xjt[2] + 2.0f * m_i / msum * dot * d12x;
    const float vj_ny = xjt[3] + 2.0f * m_i / msum * dot * d12y;

    // --- damage between two players
    if (is_pair && a != PUCK && ej != PUCK) {
      const float dv2 = 0.01f * (rvx * rvx + rvy * rvy);
      const int r1 = a * 4 + ej, r2 = ej * 4 + a;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (r == r1) dacc[r] = dacc[r] + m_i * dv2;
        if (r == r2) dacc[r] = dacc[r] + m_j * dv2;
      }
    }

    // --- wall: sign-conditioned flip + goal
    const bool flip_y = (ct == 0 && xit[3] > 0.0f) || (ct == 1 && xit[3] < 0.0f);
    const bool flip_x = (ct == 2 && xit[2] > 0.0f) || (ct == 3 && xit[2] < 0.0f);
    const float w_vx = flip_x ? -xit[2] : xit[2];
    const float w_vy = flip_y ? -xit[3] : xit[3];
    const bool goal = !is_pair && a == PUCK && (ct == 2 || ct == 3) &&
                      xit[1] < K.gh2 && xit[1] > -K.gh2;
    if (goal && !scored) {
      if (ct == 2) incA = incA + 1.0f;
      if (ct == 3) incB = incB + 1.0f;
    }
    scored = scored || goal;

    // --- value at grid column bn
    const float xres[4] = {is_pair ? p_ix : xit[0], is_pair ? p_iy : xit[1],
                           is_pair ? vi_nx : w_vx, is_pair ? vi_ny : w_vy};
    const float yres[4] = {p_jx, p_jy, vj_nx, vj_ny};
    const float rem = K.dtcol - dt_t;
    float xib[4], xjb[4];
    rk4(xres, uix, uiy, tau_i, drag_i, rem, xib);
    rk4(yres, ujx, ujy, tau_j, drag_j, rem, xjb);
    const float pbx = xjb[0] - xib[0], pby = xjb[1] - xib[1];
    const float ov2 = rr - sqrtf(pbx * pbx + pby * pby);
    const float bri = K.buf * r_i / rsum, brj = K.buf * r_j / rsum;
    const float ci2 = ov2 > 0.0f ? bri * ov2 : 0.0f;
    const float cj2 = ov2 > 0.0f ? brj * ov2 : 0.0f;
    // overlap correction against the event's own wall
    const bool isy = ct <= 1;
    const float sgn = (ct == 0 || ct == 2) ? 1.0f : -1.0f;
    const float half = isy ? K.halfy : K.halfx;
    const float dirx = ct == 2 ? -1.0f : (ct == 3 ? 1.0f : 0.0f);
    const float diry = ct == 0 ? -1.0f : (ct == 1 ? 1.0f : 0.0f);
    auto wall_fix = [&](float& px, float& py) {
      const float ow = sgn * (isy ? py : px) + r_i - half;
      const bool on = ct < 4 && ow > 0.0f;
      const float cw = K.buf * ow;
      px = px + (on ? cw * dirx : 0.0f);
      py = py + (on ? cw * diry : 0.0f);
    };
    float ri[4], rj[4];
    if (is_pair) {
      ri[0] = xib[0] - ci2 * pbx;
      ri[1] = xib[1] - ci2 * pby;
      ri[2] = xib[2];
      ri[3] = xib[3];
    } else if (goal) {
      ri[0] = ri[1] = ri[2] = ri[3] = 0.0f;
    } else {
      ri[0] = xib[0];
      ri[1] = xib[1];
      wall_fix(ri[0], ri[1]);
      ri[2] = xib[2];
      ri[3] = xib[3];
    }
    rj[0] = xjb[0] + cj2 * pbx;
    rj[1] = xjb[1] + cj2 * pby;
    rj[2] = xjb[2];
    rj[3] = xjb[3];

    // --- sequential feedback re-propagation into the shared grid (every
    // lane computes and stores the same values, once every lane has read
    // what the last detect read)
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      gi[c * K1 + bn] = ri[c];
      if (is_pair) gj[c * K1 + bn] = rj[c];
    }
    for (int k = bn + 1; k <= G; ++k) {
      float pi[4] = {ri[0] + fa_i * ri[2] + su_i[0], ri[1] + fa_i * ri[3] + su_i[1],
                     fb_i * ri[2] + su_i[2], fb_i * ri[3] + su_i[3]};
      if (srn != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) pi[c] = pi[c] + ni[c * K1 + k];
      }
      if (is_pair) {
        float pj[4] = {rj[0] + fa_j * rj[2] + su_j[0], rj[1] + fa_j * rj[3] + su_j[1],
                       fb_j * rj[2] + su_j[2], fb_j * rj[3] + su_j[3]};
        if (srn != nullptr) {
#pragma unroll
          for (int c = 0; c < 4; ++c) pj[c] = pj[c] + nj[c * K1 + k];
        }
        const float dx = pj[0] - pi[0], dy = pj[1] - pi[1];
        const float ov = rr - sqrtf(dx * dx + dy * dy);
        const float cie = ov > 0.0f ? bri * ov : 0.0f;
        const float cje = ov > 0.0f ? brj * ov : 0.0f;
        ri[0] = pi[0] - cie * dx;
        ri[1] = pi[1] - cie * dy;
        rj[0] = pj[0] + cje * dx;
        rj[1] = pj[1] + cje * dy;
        rj[2] = pj[2];
        rj[3] = pj[3];
      } else {
        ri[0] = pi[0];
        ri[1] = pi[1];
        wall_fix(ri[0], ri[1]);
      }
      ri[2] = pi[2];
      ri[3] = pi[3];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gi[c * K1 + k] = ri[c];
        if (is_pair) gj[c * K1 + k] = rj[c];
      }
    }
    __syncwarp();

    // --- slot bookkeeping: slots naming a touched entity are dropped
    // without recompute; the touched entities are re-detected from bn
    int want = 1 << a;
    if (is_pair) want |= 1 << ej;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((want >> e) & 1) continue;
      const bool jt = (sj[e] == a || (is_pair && sj[e] == ej)) && sj[e] >= 0;
      sv[e] = sv[e] && !jt;
    }
    const int bns[E] = {bn, bn, bn, bn, bn};
    detect_warp(sg, K1, K, want, bns, lane, st, sj, sc, sv);
  }

  // --- finalize: decided games keep their inputs, live games advance
  if (lane != 0) return;
  const float u01 = undec ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    xout[c * B + b] = undec ? sg[c * K1 + G] : x[c * B + b];
  const bool pend = (sv[0] || sv[1] || sv[2] || sv[3] || sv[4]) && undec;
  aux[0 * B + b] = s0 + u01 * incA;
  aux[1 * B + b] = s1 + u01 * incB;
  aux[2 * B + b] = t0 + u01 * K.dt;
  aux[3 * B + b] = actv;                 // event-loop iterations so far
  aux[4 * B + b] = (float)it;            // this call's loop trips
  aux[5 * B + b] = pend ? 1.0f : 0.0f;   // pending at the cap
  aux[6 * B + b] = 0.0f;
  aux[7 * B + b] = 0.0f;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    aux[(8 + r) * B + b] = dmgin[r * B + b] + u01 * dacc[r];
  if (mode == MODE_EXPORT) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      carry_out[e * B + b] = st[e];
      carry_out[(5 + e) * B + b] = (float)sj[e];
      carry_out[(10 + e) * B + b] = (float)sc[e];
      carry_out[(15 + e) * B + b] = sv[e] ? 1.0f : 0.0f;
    }
    carry_out[20 * B + b] = scored ? 1.0f : 0.0f;
    carry_out[21 * B + b] = incA;
    carry_out[22 * B + b] = incB;
#pragma unroll
    for (int r = 0; r < 16; ++r) carry_out[(23 + r) * B + b] = dacc[r];
    carry_out[39 * B + b] = actv;
#pragma unroll
    for (int r = 40; r < 48; ++r) carry_out[r * B + b] = 0.0f;
  }
}

__global__ void __launch_bounds__(WARP * WPB)
exact_step_kernel(const Consts K, const float* __restrict__ M6,
                  const float* __restrict__ x, const float* __restrict__ u,
                  const float* __restrict__ meta,
                  const float* __restrict__ dmgin,
                  const float* __restrict__ noise,
                  const float* __restrict__ rnoise, float* g,
                  const float* __restrict__ carry_in,
                  float* __restrict__ xout, float* __restrict__ aux,
                  float* __restrict__ carry_out, int B, int K1, int mode,
                  int cap) {
  // WPB grids, then (stochastic) WPB re-propagation noise planes
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (WARP - 1);
  const int w = threadIdx.x / WARP;
  const int b0 = blockIdx.x * WPB;
  const int nb = B - b0 < WPB ? B - b0 : WPB;
  const int cells = NC * K1;
  float* srn = rnoise == nullptr ? nullptr : smem + (size_t)WPB * cells;
  // the block's grids (resume) or populate noise planes in, and the
  // re-propagation noise planes
  const float* src = mode == MODE_RESUME ? g : noise;
  if (src != nullptr) planes_in(smem, src, B, K1, b0, nb);
  if (srn != nullptr) planes_in(srn, rnoise, B, K1, b0, nb);
  __syncthreads();
  if (w < nb)
    run_game(smem + (size_t)w * cells,
             srn == nullptr ? nullptr : srn + (size_t)w * cells, K, M6, x, u,
             meta, dmgin, mode != MODE_RESUME && noise != nullptr, carry_in,
             xout, aux, carry_out, B, K1, b0 + w, mode, cap, lane);
  __syncthreads();
  // ... and the grids out
  planes_out(smem, g, B, K1, b0, nb);
}

// A block's dynamic shared memory: WPB grids, and in stochastic mode WPB
// re-propagation noise planes.
int smem_bytes(int K1, bool stochastic) {
  return (stochastic ? 2 : 1) * WPB * NC * K1 * (int)sizeof(float);
}

}  // namespace

// Launches K1 on `stream` and returns the CUDA error of the launch (0 when
// it was accepted).  `consts` is a host array of 82 floats; every other
// pointer is device memory.  `g` is the working grid (20, K1, B): written
// by the populate, or holding the exported grid to resume from; it is the
// export grid afterwards.  `noise`, `rnoise`, `carry_in` and `carry_out`
// may be null where the mode does not use them.  A warp runs a game, WPB
// games a block, the grids (and re-propagation noise) in shared memory.
extern "C" int rg_exact_step(const float* consts, const float* M6,
                             const float* x, const float* u,
                             const float* meta, const float* dmgin,
                             const float* noise, const float* rnoise,
                             float* g, const float* carry_in, float* xout,
                             float* aux, float* carry_out, int B, int K1,
                             int mode, int cap, void* stream) {
  Consts K;
  memcpy(&K, consts, sizeof(K));
  cudaStream_t st = (cudaStream_t)stream;
  const int bytes = smem_bytes(K1, rnoise != nullptr);
  const cudaError_t err = cudaFuncSetAttribute(
      exact_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + WPB - 1) / WPB;
  exact_step_kernel<<<blocks, WARP * WPB, bytes, st>>>(
      K, M6, x, u, meta, dmgin, noise, rnoise, g, carry_in, xout, aux,
      carry_out, B, K1, mode, cap);
  return (int)cudaGetLastError();
}

// The blocks (WPB games each) an SM runs of K1 at K1 grid columns,
// deterministic or stochastic (the card's occupancy calculator at the
// launch's dynamic shared memory), into out[0], that shared memory a
// block into out[1] and the registers a thread into out[2].  Returns the
// CUDA error (0 on success).
extern "C" int rg_exact_step_occupancy(int K1, int stochastic, int* out) {
  const int bytes = smem_bytes(K1, stochastic != 0);
  out[0] = 0;
  out[1] = bytes;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, exact_step_kernel);
  if (err != cudaSuccess) return (int)err;
  out[2] = attr.numRegs;
  err = cudaFuncSetAttribute(
      exact_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], exact_step_kernel, WARP * WPB, bytes);
}

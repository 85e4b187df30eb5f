// K6: the parallel-resolution control step of a batch of 2v2 air-hockey
// games (the sweep algorithm in one kernel).
//
// Replaces the TPU kernel robogame_tpu/physics/pallas_step.py::_make_kernel
// (:130) in its modes "full", "export" and "resume" (the loop :450-743,
// start and finish :1137-1188), launched by _kernel_call (:1491); the
// two-phase compact-and-resume around it is robogame_tpu_torch/physics/
// parallel_step.py::_twophase_planes.  The plain PyTorch version of the
// same function is parallel_step.py::parallel_step_plain; the wrapper is
// robogame_tpu_torch/kernels.py::parallel_step.
//
// Per game: populate the 51-column x 20-component sub-step grid as M [x; u]
// (+ the populate noise plane); detect every entity's first qualifying
// event from its base column and drop those of an already-scored puck;
// loop while a slot is valid and fewer than `cap` iterations ran: take
// every slot that no conflicting valid slot beats (earlier, ties to the
// lower index), resolve each taken slot from the grid as it stood at the
// start of the iteration, claim its entities, re-propagate the claimed
// entities without feedback (z = Finvpow[base] (x_base - Spow[base] u),
// tail M [z; u], per-column pair correction against the partner's
// uncorrected tail or wall correction), write columns > base corrected
// and the base column uncorrected, move the bases, re-detect everything;
// finalize (decided games keep their inputs); export the grid and a
// 32-row carry, or resume from them.
//
// What bounds it on the H100: like K1, the latency of dependent per-game
// chains on the CUDA cores.  Per game the populate is 1020 six-term sums;
// each loop iteration re-detects all five entities (up to 50 columns of
// 10 pair and 10 wall-axis tests) and re-propagates every claimed entity's
// tail over up to 50 columns.  The bytes that must move are small (the
// grid is 4 KB a game, 33 MB at B = 8192, inside the 50 MB L2), so the
// bytes bound lies far below the time of the per-game chains.
//
// Design: a warp per game (WarpGame below), in every mode.
// * The block's WPB games read their grids (resume) or populate noise
//   planes (stochastic populate) from the plane layout [20][G+1][B] into
//   shared memory together, WPB consecutive games a (component, column),
//   and write the grids back the same way at the end (export and finish);
//   in between a game's grid (20 x 51 floats, 4 KB) never leaves shared
//   memory.  The compacted resume of 512 pending games is 512 warps on
//   128 blocks, about 4 warps an SM over all 132 SMs.
// * Detect (detect_warp): the lanes take the columns, 32 at a time from
//   the least base; each lane evaluates the qualifying tests of its column
//   exactly as step_common.cuh's detect does, and an entity's first
//   qualifying column is the lowest lane with a hit (__ballot_sync,
//   __ffs), its event broadcast with __shfl_sync.
// * The populate's cells, and the re-propagated tails' columns >= base,
//   are split over the lanes; each cell is the same six-term sum and the
//   same correction in the same order.
// * Selection, resolve and the damage and carry accumulations run in
//   their serial order on every lane alike (warp-uniform), so every lane
//   holds the same game state.
// Built with -fmad=false and IEEE division and square root: every f32
// operation is the one the plain version does, in the same order, so the
// kernel and the plain version agree bitwise.

#include <cuda_runtime.h>
#include <string.h>

#include "step_common.cuh"

namespace {

using namespace rg_step;
enum { MODE_FULL = 0, MODE_EXPORT = 1, MODE_RESUME = 2 };
constexpr int WARP = 32;
constexpr int WPB = 4;                  // games (warps) a block
constexpr unsigned FULL = 0xffffffffu;

// The first qualifying event of every entity from its base, a warp over
// one game's grid in shared memory (sg[c * K1 + k]): step_common.cuh's
// detect with the columns over the lanes.  Every lane returns the same.
__device__ __forceinline__ void detect_warp(const float* sg, int K1,
                                            const Consts& K,
                                            const int (&base)[E], int lane,
                                            float (&st)[E], int (&sj)[E],
                                            int (&sc)[E], bool (&sv)[E]) {
  const int G = K1 - 1;
  int k0 = K1;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (base[e] < k0) k0 = base[e];
    st[e] = INF_T;
    sj[e] = -1;
    sc[e] = 0;
    sv[e] = false;
  }
  k0 = k0 > 1 ? k0 : 1;
  int todo = (1 << E) - 1;
  for (int c0 = k0; c0 <= G && todo; c0 += WARP) {
    const int k = c0 + lane;
    const bool valid = k <= G;
    const int kk = valid ? k : G;
    float cu[NC], pv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      cu[c] = sg[c * K1 + kk];
      pv[c] = sg[c * K1 + kk - 1];
    }
    const float tm = ((float)kk - 1.0f) * K.dtcol;
    float ptc[E][E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
#pragma unroll
      for (int o = i + 1; o < E; ++o) {
        ptc[i][o] = INF_T;
        if (((todo >> i) | (todo >> o)) & 1) {
          const float sig2 = K.sig2[i][o];
          const float dxk = cu[o * 4 + 0] - cu[i * 4 + 0];
          const float dyk = cu[o * 4 + 1] - cu[i * 4 + 1];
          const bool over = dxk * dxk + dyk * dyk <= sig2;
          const float dxm = pv[o * 4 + 0] - pv[i * 4 + 0];
          const float dym = pv[o * 4 + 1] - pv[i * 4 + 1];
          const float dvx = pv[o * 4 + 2] - pv[i * 4 + 2];
          const float dvy = pv[o * 4 + 3] - pv[i * 4 + 3];
          const float bb = dxm * dvx + dym * dvy;
          const float dvv = dvx * dvx + dvy * dvy;
          const float dpp = dxm * dxm + dym * dym;
          const float disc = bb * bb - dvv * (dpp - sig2);
          const bool ok = over && bb < 0.0f && disc >= 0.0f && dvv > 0.0f;
          const float den = dvv == 0.0f ? 1.0f : dvv;
          const float tau = clamp0(-(bb + sqrtf(clamp0(disc))) / den);
          ptc[i][o] = ok ? tm + tau : INF_T;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!((todo >> e) & 1)) continue;
      float best_t = INF_T;
      int best_m = 0;
#pragma unroll
      for (int ax = 0; ax < 2; ++ax) {      // ax 0: y walls, 1: x walls
        const int comp = ax == 0 ? 1 : 0;
        const float pk = cu[e * 4 + comp], pm = pv[e * 4 + comp];
        const float vm = pv[e * 4 + comp + 2];
        const float bmr = ax == 0 ? K.bmry[e] : K.bmrx[e];
        const float bound = ax == 0 ? K.halfy : K.halfx;
        const float toward = vm >= 0.0f ? 1.0f : -1.0f;
        const bool overlap = toward * pk + K.r[e] >= bound;
        const float den = vm == 0.0f ? 1.0f : vm;
        const float tau = clamp0((bmr * toward - pm) / den);
        const float tc = (overlap && vm != 0.0f) ? tm + tau : INF_T;
        const int cm = 16 * (vm >= 0.0f ? 2 * ax : 2 * ax + 1);
        if (ax == 0 || tc < best_t) {
          best_t = tc;
          best_m = cm;
        }
      }
#pragma unroll
      for (int o = 0; o < E; ++o) {
        if (o == e) continue;
        const float tc = o < e ? ptc[o][e] : ptc[e][o];
        if (tc < best_t) {
          best_t = tc;
          best_m = 16 * 4 + o + 1;
        }
      }
      const bool hit = valid && kk >= base[e] && best_t < K.dt;
      const unsigned mask = __ballot_sync(FULL, hit);
      if (mask != 0u) {
        const int src = __ffs(mask) - 1;
        const float bt = __shfl_sync(FULL, best_t, src);
        const int bm = __shfl_sync(FULL, best_m, src);
        st[e] = bt;
        sj[e] = (bm & 15) - 1;
        sc[e] = bm >> 4;
        sv[e] = true;
        todo &= ~(1 << e);
      }
    }
  }
}

// A game on one warp: the grid in shared memory, sg[c * K1 + k]; in a
// stochastic populate sg holds the noise plane on entry.
struct WarpGame {
  float* sg;
  int K1, lane;
  __device__ int first() const { return lane; }
  __device__ float get(int c, int k) const { return sg[c * K1 + k]; }
  __device__ void set(int c, int k, float v) const { sg[c * K1 + k] = v; }
  __device__ float noise_at(int c, int k) const { return sg[c * K1 + k]; }
  __device__ void sync() const { __syncwarp(); }
  __device__ bool writer() const { return lane == 0; }
};

// Detect from the per-entity bases, then drop the events that involve an
// already-scored puck (the slot is not searched again).
__device__ __forceinline__ void detect_stacked(
    const WarpGame& gm, const Consts& K, const int (&base)[E], bool scored,
    float (&st)[E], int (&sj)[E], int (&sc)[E], bool (&sv)[E]) {
  detect_warp(gm.sg, gm.K1, K, base, gm.lane, st, sj, sc, sv);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool pv = e == PUCK || (sc[e] == 4 && sj[e] == PUCK);
    sv[e] = sv[e] && !(pv && scored);
  }
}

// The overlap correction against wall ct (0-3; 4 leaves the point).
__device__ __forceinline__ void wall_fix(const Consts& K, int ct, float r,
                                         float& px, float& py) {
  const bool isy = ct <= 1;
  const float sgn = (ct == 0 || ct == 2) ? 1.0f : -1.0f;
  const float half = isy ? K.halfy : K.halfx;
  const float dirx = ct == 2 ? -1.0f : (ct == 3 ? 1.0f : 0.0f);
  const float diry = ct == 0 ? -1.0f : (ct == 1 ? 1.0f : 0.0f);
  const float ow = sgn * (isy ? py : px) + r - half;
  const bool on = ct < 4 && ow > 0.0f;
  const float cw = K.buf * ow;
  px = px + (on ? cw * dirx : 0.0f);
  py = py + (on ? cw * diry : 0.0f);
}

// Column k of entity e's tail M [z; u] (six terms in _NZ order).
__device__ __forceinline__ void tail_at(const float* __restrict__ M6, int K1,
                                        int e, int k, const float (&z)[4],
                                        float ux, float uy, float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* m = M6 + ((size_t)(e * 4 + i) * K1 + k) * 6;
    float acc = m[0] * z[0];
    acc = acc + m[1] * z[1];
    acc = acc + m[2] * z[2];
    acc = acc + m[3] * z[3];
    acc = acc + m[4] * ux;
    acc = acc + m[5] * uy;
    t[i] = acc;
  }
}

// One game b's control step on the warp gm.
__device__ __forceinline__ void run_game(
    const WarpGame& gm, const Consts& K, const float* __restrict__ M6,
    const float* __restrict__ FI, const float* __restrict__ SP,
    const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ meta, const float* __restrict__ dmgin,
    bool noisy, const float* __restrict__ carry_in, float* __restrict__ xout,
    float* __restrict__ aux, float* __restrict__ carry_out, int B, int K1,
    int b, int mode, int cap) {
  const int G = K1 - 1;
  const float s0 = meta[b], s1 = meta[B + b], t0 = meta[2 * B + b];
  const bool undec = s0 < K.ws && s1 < K.ws;

  int base[E];
  bool scored = false;
  float incA = 0.0f, incB = 0.0f, actv = 0.0f;
  float dacc[16];
  if (mode == MODE_RESUME) {
    // rows: 0-4 base, 5 scored, 6 incA, 7 incB, 8-23 dmg, 24 actv
#pragma unroll
    for (int e = 0; e < E; ++e) base[e] = (int)carry_in[e * B + b];
    scored = carry_in[5 * B + b] > 0.5f;
    incA = carry_in[6 * B + b];
    incB = carry_in[7 * B + b];
#pragma unroll
    for (int r = 0; r < 16; ++r) dacc[r] = carry_in[(8 + r) * B + b];
    actv = carry_in[24 * B + b];
  } else {
    float z[30];
#pragma unroll
    for (int j = 0; j < 20; ++j) z[j] = x[j * B + b];
#pragma unroll
    for (int j = 0; j < 10; ++j) z[20 + j] = u[j * B + b];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = c / 4;
      for (int k = gm.first(); k <= G; k += WARP) {
        const float* m = M6 + ((size_t)c * K1 + k) * 6;
        float acc = m[0] * z[e * 4 + 0];
        acc = acc + m[1] * z[e * 4 + 1];
        acc = acc + m[2] * z[e * 4 + 2];
        acc = acc + m[3] * z[e * 4 + 3];
        acc = acc + m[4] * z[20 + 2 * e];
        acc = acc + m[5] * z[21 + 2 * e];
        if (noisy) acc = acc + gm.noise_at(c, k);
        gm.set(c, k, acc);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) base[e] = 1;
#pragma unroll
    for (int r = 0; r < 16; ++r) dacc[r] = 0.0f;
  }
  gm.sync();
  float ux[E], uy[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ux[e] = u[(2 * e) * B + b];
    uy[e] = u[(2 * e + 1) * B + b];
  }

  float st[E];
  int sj[E], sc[E];
  bool sv[E];
  detect_stacked(gm, K, base, scored, st, sj, sc, sv);

  int it = 0;
  while (it < cap && (sv[0] || sv[1] || sv[2] || sv[3] || sv[4])) {
    // --- selection: a slot is taken unless a conflicting valid slot is
    // earlier (ties to the lower index); slot a's entities are {a, jj[a]}
    float te[E];
    int jj[E];
    bool take[E];
#pragma unroll
    for (int a = 0; a < E; ++a) {
      te[a] = sv[a] ? st[a] : INF_T;
      jj[a] = sc[a] == 4 ? sj[a] : a;
    }
#pragma unroll
    for (int a = 0; a < E; ++a) {
      bool beaten = false;
#pragma unroll
      for (int o = 0; o < E; ++o) {
        if (o == a) continue;
        const bool share = a == o || a == jj[o] || jj[a] == o ||
                           jj[a] == jj[o];
        const bool earlier = te[o] < te[a] || (te[o] == te[a] && o < a);
        beaten = beaten || (share && sv[a] && sv[o] && earlier);
      }
      take[a] = sv[a] && !beaten;
    }

    // --- resolve every taken slot; claim its entities
    bool clm[E], epair[E];
    int ebase[E], ect[E], epart[E];
    float val[E][4];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      clm[e] = false;
      epair[e] = false;
      ebase[e] = 0;
      ect[e] = 0;
      epart[e] = e;
      val[e][0] = val[e][1] = val[e][2] = val[e][3] = 0.0f;
    }
    bool gA = false, gB = false, new_scored = scored;
    for (int a = 0; a < E; ++a) {
      if (!take[a]) continue;
      const float tp = te[a];
      const int ct = sc[a];
      const bool is_pair = ct == 4;
      const int ej = jj[a];
      int km1 = (int)(tp / K.dtcol);
      km1 = km1 < 0 ? 0 : (km1 > G - 1 ? G - 1 : km1);
      const int bn = km1 + 1;
      float xi[4], xj[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xi[c] = gm.get(a * 4 + c, km1);
        xj[c] = gm.get(ej * 4 + c, km1);
      }
      const float r_i = pick(K.r, a), r_j = pick(K.r, ej);
      const float m_i = pick(K.m, a), m_j = pick(K.m, ej);
      const float tau_i = pick(K.tau, a), tau_j = pick(K.tau, ej);
      const float drag_i = pick(K.drag, a), drag_j = pick(K.drag, ej);
      const float uix = pick(ux, a), uiy = pick(uy, a);
      const float ujx = pick(ux, ej), ujy = pick(uy, ej);
      float dt_t = tp - (float)km1 * K.dtcol;
      dt_t = dt_t < 0.0f ? 0.0f : (dt_t > K.dtcol ? K.dtcol : dt_t);
      float xit[4], xjt[4];
      rk4(xi, uix, uiy, tau_i, drag_i, dt_t, xit);
      rk4(xj, ujx, ujy, tau_j, drag_j, dt_t, xjt);

      // pair: de-penetrate (1.01) + elastic impulse
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

      // damage between two players (each row gets at most one event an
      // iteration: two slots naming the same pair conflict)
      if (is_pair && a != PUCK && ej != PUCK) {
        const float dv2 = 0.01f * (rvx * rvx + rvy * rvy);
        const int r1 = a * 4 + ej, r2 = ej * 4 + a;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (r == r1) dacc[r] = dacc[r] + m_i * dv2;
          if (r == r2) dacc[r] = dacc[r] + m_j * dv2;
        }
      }

      // wall: sign-conditioned flip + goal
      const bool flip_y = (ct == 0 && xit[3] > 0.0f) ||
                          (ct == 1 && xit[3] < 0.0f);
      const bool flip_x = (ct == 2 && xit[2] > 0.0f) ||
                          (ct == 3 && xit[2] < 0.0f);
      const float w_vx = flip_x ? -xit[2] : xit[2];
      const float w_vy = flip_y ? -xit[3] : xit[3];
      const bool goal = !is_pair && a == PUCK && (ct == 2 || ct == 3) &&
                        xit[1] < K.gh2 && xit[1] > -K.gh2;
      if (goal && !scored) {
        gA = gA || ct == 2;
        gB = gB || ct == 3;
      }
      new_scored = new_scored || goal;

      // value at grid column bn, and the overlap corrections there
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
      float vi[4];
      if (is_pair) {
        vi[0] = xib[0] - ci2 * pbx;
        vi[1] = xib[1] - ci2 * pby;
        vi[2] = xib[2];
        vi[3] = xib[3];
      } else if (goal) {
        vi[0] = vi[1] = vi[2] = vi[3] = 0.0f;
      } else {
        vi[0] = xib[0];
        vi[1] = xib[1];
        wall_fix(K, ct, r_i, vi[0], vi[1]);
        vi[2] = xib[2];
        vi[3] = xib[3];
      }
      const float vj[4] = {xjb[0] + cj2 * pbx, xjb[1] + cj2 * pby, xjb[2],
                           xjb[3]};
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e == a) {
          clm[e] = true;
          epair[e] = is_pair;
          ebase[e] = bn;
          ect[e] = ct;
          epart[e] = ej;
#pragma unroll
          for (int c = 0; c < 4; ++c) val[e][c] = vi[c];
        } else if (is_pair && e == ej) {
          clm[e] = true;
          epair[e] = true;
          ebase[e] = bn;
          ect[e] = 4;
          epart[e] = a;
#pragma unroll
          for (int c = 0; c < 4; ++c) val[e][c] = vj[c];
        }
      }
    }
    incA = incA + (gA ? 1.0f : 0.0f);
    incB = incB + (gB ? 1.0f : 0.0f);

    // --- z = Finvpow[base] (x_base - Spow[base] u) of the claimed entities
    float zz[E][4];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int bs = ebase[e];
      float xb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        xb[c] = val[e][c] - (SP[(size_t)(e * 8 + c * 2) * K1 + bs] * ux[e] +
                             SP[(size_t)(e * 8 + c * 2 + 1) * K1 + bs] * uy[e]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* f = FI + (size_t)(e * 16 + i * 4) * K1 + bs;
        float acc = f[0] * xb[0];
        acc = acc + f[K1] * xb[1];
        acc = acc + f[2 * K1] * xb[2];
        acc = acc + f[3 * K1] * xb[3];
        zz[e][i] = acc;
      }
    }

    // --- the tails of the claimed entities, corrected beyond the base
    // (the columns over the lanes of a warp)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!clm[e]) continue;
      const int bs = ebase[e];
      const int p = epart[e];
      float zp[4];
      float r_p = K.r[0], uxp = ux[0], uyp = uy[0];
#pragma unroll
      for (int q = 0; q < E; ++q)
        if (q == p) {
#pragma unroll
          for (int c = 0; c < 4; ++c) zp[c] = zz[q][c];
          r_p = K.r[q];
          uxp = ux[q];
          uyp = uy[q];
        }
      const float r_e = K.r[e];
      const float rre = r_e + r_p;
      const float rs = rre > 0.0f ? rre : 1.0f;
      const float bre = K.buf * r_e / rs;
      for (int k = bs + gm.first(); k <= G; k += WARP) {
        float t[4];
        tail_at(M6, K1, e, k, zz[e], ux[e], uy[e], t);
        if (k > bs) {
          if (epair[e]) {
            float tq[4];
            tail_at(M6, K1, p, k, zp, uxp, uyp, tq);
            const float dx = tq[0] - t[0], dy = tq[1] - t[1];
            const float pnt = sqrtf(dx * dx + dy * dy);
            const float ovt = rre - pnt;
            const float ce = ovt > 0.0f ? bre * ovt : 0.0f;
            t[0] = t[0] - ce * dx;
            t[1] = t[1] - ce * dy;
          } else {
            wall_fix(K, ect[e], r_e, t[0], t[1]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) gm.set(e * 4 + c, k, t[c]);
      }
      base[e] = bs;
    }
    gm.sync();
    scored = new_scored;
    actv += 1.0f;
    ++it;
    detect_stacked(gm, K, base, scored, st, sj, sc, sv);
  }

  // --- finalize: decided games keep their inputs, live games advance
  if (!gm.writer()) return;
  const float u01 = undec ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    xout[c * B + b] = undec ? gm.get(c, G) : x[c * B + b];
  const bool pend = (sv[0] || sv[1] || sv[2] || sv[3] || sv[4]) && undec;
  aux[0 * B + b] = s0 + u01 * incA;
  aux[1 * B + b] = s1 + u01 * incB;
  aux[2 * B + b] = t0 + u01 * K.dt;
  aux[3 * B + b] = actv;                 // loop iterations so far
  aux[4 * B + b] = (float)it;            // this call's loop trips
  aux[5 * B + b] = pend ? 1.0f : 0.0f;   // pending at the cap
  aux[6 * B + b] = 0.0f;
  aux[7 * B + b] = 0.0f;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    aux[(8 + r) * B + b] = dmgin[r * B + b] + u01 * dacc[r];
  if (mode == MODE_EXPORT) {
#pragma unroll
    for (int e = 0; e < E; ++e) carry_out[e * B + b] = (float)base[e];
    carry_out[5 * B + b] = scored ? 1.0f : 0.0f;
    carry_out[6 * B + b] = incA;
    carry_out[7 * B + b] = incB;
#pragma unroll
    for (int r = 0; r < 16; ++r) carry_out[(8 + r) * B + b] = dacc[r];
    carry_out[24 * B + b] = actv;
#pragma unroll
    for (int r = 25; r < 32; ++r) carry_out[r * B + b] = 0.0f;
  }
}

__global__ void __launch_bounds__(WARP * WPB)
parallel_step_kernel(const Consts K, const float* __restrict__ M6,
                          const float* __restrict__ FI,
                          const float* __restrict__ SP,
                          const float* __restrict__ x,
                          const float* __restrict__ u,
                          const float* __restrict__ meta,
                          const float* __restrict__ dmgin,
                          const float* __restrict__ noise, float* g,
                          const float* __restrict__ carry_in,
                          float* __restrict__ xout, float* __restrict__ aux,
                          float* __restrict__ carry_out, int B, int K1,
                          int mode, int cap) {
  extern __shared__ float sgrid[];          // WPB games x NC x K1
  const int lane = threadIdx.x & (WARP - 1);
  const int w = threadIdx.x / WARP;
  const int b0 = blockIdx.x * WPB;
  const int nb = B - b0 < WPB ? B - b0 : WPB;
  const int cells = NC * K1;
  // the block's grids (resume) or noise planes (stochastic populate) in
  const float* src = mode == MODE_RESUME ? g : noise;
  if (src != nullptr)
    for (int e = threadIdx.x; e < cells * nb; e += blockDim.x) {
      const int ww = e % nb, ck = e / nb;
      sgrid[(size_t)ww * cells + ck] = src[(size_t)ck * B + b0 + ww];
    }
  __syncthreads();
  if (w < nb) {
    const WarpGame gm{sgrid + (size_t)w * cells, K1, lane};
    run_game(gm, K, M6, FI, SP, x, u, meta, dmgin, noise != nullptr,
             carry_in, xout, aux, carry_out, B, K1, b0 + w, mode, cap);
  }
  __syncthreads();
  // ... and the grids out
  for (int e = threadIdx.x; e < cells * nb; e += blockDim.x) {
    const int ww = e % nb, ck = e / nb;
    g[(size_t)ck * B + b0 + ww] = sgrid[(size_t)ww * cells + ck];
  }
}

}  // namespace

// Launches K6 on `stream` and returns the CUDA error of the launch (0 when
// it was accepted).  `consts` is a host array of 82 floats (K1's); every
// other pointer is device memory.  M6 is (20, K1, 6), FI (80, K1), SP
// (40, K1).  `g` is the working grid (20, K1, B): written by the populate,
// or holding the exported grid to resume from; it is the export grid
// afterwards.  `noise`, `carry_in` and `carry_out` may be null where the
// mode does not use them.  A warp runs a game, WPB games a block, the
// grids in shared memory.
extern "C" int rg_parallel_step(const float* consts, const float* M6,
                                const float* FI, const float* SP,
                                const float* x, const float* u,
                                const float* meta, const float* dmgin,
                                const float* noise, float* g,
                                const float* carry_in, float* xout,
                                float* aux, float* carry_out, int B, int K1,
                                int mode, int cap, void* stream) {
  Consts K;
  memcpy(&K, consts, sizeof(K));
  cudaStream_t st = (cudaStream_t)stream;
  const int bytes = WPB * NC * K1 * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      parallel_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + WPB - 1) / WPB;
  parallel_step_kernel<<<blocks, WARP * WPB, bytes, st>>>(
      K, M6, FI, SP, x, u, meta, dmgin, noise, g, carry_in, xout, aux,
      carry_out, B, K1, mode, cap);
  return (int)cudaGetLastError();
}

// Device code shared by K1 (csrc/exact_step.cu) and K6
// (csrc/parallel_step.cu), the two batched control steps, each a warp a
// game with its grid in shared memory: the f32 constants, one RK4 step of
// the damped double integrator, the first-qualifying-collision detect over
// the lanes of a warp, and the copy of a block's grids between the plane
// layout and shared memory.  Each is written so that its f32 operations,
// in order, are those of the plain PyTorch versions
// (robogame_tpu_torch/physics/exact_step.py: _rk4, _detect_plain).
#pragma once

#include <cuda_runtime.h>
#include <string.h>

namespace rg_step {

constexpr int NC = 20;
constexpr int E = 5;
constexpr int PUCK = 4;
constexpr int WARP = 32;
constexpr int WPB = 4;             // games (warps) a block
constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_T = 1.0e9f;

// f32 constants, in the order of exact_step.py::CONST_FIELDS
struct Consts {
  float dt, dtcol, halfx, halfy, gh2, buf, ws;
  float r[E], m[E], tau[E], drag[E];
  float sa[E], sb[E], sc[E], sd[E];   // one-substep affine scalars
  float bmry[E], bmrx[E];             // halfy - r_e, halfx - r_e
  float sig2[E][E];                   // (r_i + r_o)^2
};
static_assert(sizeof(Consts) == 82 * sizeof(float), "Consts layout");

__device__ __forceinline__ float pick(const float (&v)[E], int a) {
  float out = v[0];
#pragma unroll
  for (int e = 1; e < E; ++e)
    if (a == e) out = v[e];
  return out;
}

// One RK4 step of vdot = (u - drag v) / tau over h.
__device__ __forceinline__ void rk4(const float (&x)[4], float ux, float uy,
                                    float tau, float drag, float h,
                                    float (&out)[4]) {
  const float vx = x[2], vy = x[3];
  const float a1x = (ux - drag * vx) / tau, a1y = (uy - drag * vy) / tau;
  const float k2x = vx + a1x * h / 2.0f, k2y = vy + a1y * h / 2.0f;
  const float a2x = (ux - drag * k2x) / tau, a2y = (uy - drag * k2y) / tau;
  const float k3x = vx + a2x * h / 2.0f, k3y = vy + a2y * h / 2.0f;
  const float a3x = (ux - drag * k3x) / tau, a3y = (uy - drag * k3y) / tau;
  const float k4x = vx + a3x * h, k4y = vy + a3y * h;
  const float a4x = (ux - drag * k4x) / tau, a4y = (uy - drag * k4y) / tau;
  const float h6 = h / 6.0f;
  out[0] = x[0] + (vx + 2.0f * k2x + 2.0f * k3x + k4x) * h6;
  out[1] = x[1] + (vy + 2.0f * k2y + 2.0f * k3y + k4y) * h6;
  out[2] = vx + (a1x + 2.0f * a2x + 2.0f * a3x + a4x) * h6;
  out[3] = vy + (a1y + 2.0f * a2y + 2.0f * a3y + a4y) * h6;
}

__device__ __forceinline__ float clamp0(float v) { return v < 0.0f ? 0.0f : v; }

// The first qualifying event of each entity e in `want` at columns >=
// max(base[e], 1), a warp over one game's grid in shared memory
// (sg[c * K1 + k]); the slots of the other entities are left as they are.
// Candidates per column: the y wall, the x wall, then partners ascending --
// the first strictly smaller time wins -- and an entity's event is that of
// its first column whose best time is < dt.  The lanes take the columns, 32
// at a time from the least base; each lane runs its column's tests, and an
// entity's first qualifying column is the lowest lane with a hit
// (__ballot_sync, __ffs), its event broadcast with __shfl_sync.  Every lane
// returns the same; every f32 operation is the plain version's
// (exact_step.py::_detect_plain, parallel_step.py's detect).
__device__ __forceinline__ void detect_warp(const float* sg, int K1,
                                            const Consts& K, int want,
                                            const int (&base)[E], int lane,
                                            float (&st)[E], int (&sj)[E],
                                            int (&sc)[E], bool (&sv)[E]) {
  const int G = K1 - 1;
  int k0 = K1;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if ((want >> e) & 1) {
      if (base[e] < k0) k0 = base[e];
      st[e] = INF_T;
      sj[e] = -1;
      sc[e] = 0;
      sv[e] = false;
    }
  k0 = k0 > 1 ? k0 : 1;
  int todo = want;
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

// A block's nb games from the plane layout [20][G+1][B] of `src` into
// shared memory (game w's 20 x K1 floats at w NC K1), nb consecutive games a
// (component, column), and back out of it.
__device__ __forceinline__ void planes_in(float* smem,
                                          const float* __restrict__ src,
                                          int B, int K1, int b0, int nb) {
  const int cells = NC * K1;
  for (int e = threadIdx.x; e < cells * nb; e += blockDim.x) {
    const int ww = e % nb, ck = e / nb;
    smem[(size_t)ww * cells + ck] = src[(size_t)ck * B + b0 + ww];
  }
}

__device__ __forceinline__ void planes_out(const float* smem,
                                           float* __restrict__ dst, int B,
                                           int K1, int b0, int nb) {
  const int cells = NC * K1;
  for (int e = threadIdx.x; e < cells * nb; e += blockDim.x) {
    const int ww = e % nb, ck = e / nb;
    dst[(size_t)ck * B + b0 + ww] = smem[(size_t)ww * cells + ck];
  }
}

}  // namespace rg_step

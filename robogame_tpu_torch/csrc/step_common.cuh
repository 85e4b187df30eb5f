// Device code shared by K1 (csrc/exact_step.cu) and K6
// (csrc/parallel_step.cu), the two batched control steps: the f32
// constants, one RK4 step of the damped double integrator, and the
// first-qualifying-collision detect.  Each is written so that its f32
// operations, in order, are those of the plain PyTorch versions
// (robogame_tpu_torch/physics/exact_step.py: _rk4, _detect_plain).
#pragma once

#include <cuda_runtime.h>
#include <string.h>

namespace rg_step {

constexpr int NC = 20;
constexpr int E = 5;
constexpr int PUCK = 4;
constexpr int BLOCK = 32;          // = exact_step.py::BLOCK
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

// First qualifying event of each entity e in `want` at columns >=
// max(base[e], 1); candidates per column: the y wall, the x wall, then
// partners ascending -- the first strictly smaller time wins, and the
// first column whose best time is < dt.
__device__ __forceinline__ void detect(const float* g, int B,
                                       int K1, int b, const Consts& K,
                                       int want, const int (&base)[E],
                                       float (&st)[E], int (&sj)[E],
                                       int (&sc)[E], bool (&sv)[E]) {
  const int G = K1 - 1;
  int k0 = K1;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (((want >> e) & 1) && base[e] < k0) k0 = base[e];
  k0 = k0 > 1 ? k0 : 1;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if ((want >> e) & 1) {
      st[e] = INF_T;
      sj[e] = -1;
      sc[e] = 0;
      sv[e] = false;
    }
  float pv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) pv[c] = g[((size_t)c * K1 + k0 - 1) * B + b];
  int todo = want;
  for (int k = k0; k <= G && todo; ++k) {
    float cu[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) cu[c] = g[((size_t)c * K1 + k) * B + b];
    const float tm = ((float)k - 1.0f) * K.dtcol;
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
      if (!((todo >> e) & 1) || k < base[e]) continue;
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
      if (best_t < K.dt) {
        st[e] = best_t;
        sj[e] = (best_m & 15) - 1;
        sc[e] = best_m >> 4;
        sv[e] = true;
        todo &= ~(1 << e);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) pv[c] = cu[c];
  }
}

// The same, every wanted entity from one base column.
__device__ __forceinline__ void detect(const float* g, int B,
                                       int K1, int b, const Consts& K,
                                       int want, int base, float (&st)[E],
                                       int (&sj)[E], int (&sc)[E],
                                       bool (&sv)[E]) {
  int bases[E];
#pragma unroll
  for (int e = 0; e < E; ++e) bases[e] = base;
  detect(g, B, K1, b, K, want, bases, st, sj, sc, sv);
}

}  // namespace rg_step

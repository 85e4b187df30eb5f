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
// What bounds it on the H100: f32 operations on the CUDA cores, latency-
// bound.  Per game the populate is 1020 six-term sums and every detect
// column is up to 10 pair and 10 wall-axis candidate tests; an event adds
// two RK4 resolves and a sequential re-propagation over up to 50 columns.
// The data moved is small (the export grid is 4 KB a game), so the bytes
// bound is far below the time the dependent per-game chains take.
//
// Design (first, simple and right):
// * one thread per game (the TPU's lane <-> game becomes thread <-> game),
//   32 games per block so that 8192 games spread over 256 blocks on the
//   132 SMs;
// * the grid lives in device memory in the JAX plane layout [20][G+1][B],
//   so a warp's accesses to one (component, column) are one coalesced
//   128-byte line; at B = 8192 the 33 MB of grid stays in the 50 MB L2;
// * detect stops at the first qualifying column instead of scanning all
//   51 with 0/1 blends, and re-detects only the touched entities;
// * the feedback re-propagation writes straight into the grid (the TPU
//   kernel's role slabs and blend-store scatter are not needed);
// * the populate reads the 6 non-zeros of each row of M, summed in a fixed
//   order that the plain version repeats.
// Built with -fmad=false and IEEE division and square root: every f32
// operation is the one the plain version does, in the same order, so the
// two agree on chaotic grinding games as well.  Making it fast (shared-
// memory tiling of the grid, warp-per-game detect, CUDA graphs over the
// control-step loop) is later work.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int NC = 20;
constexpr int E = 5;
constexpr int PUCK = 4;
constexpr int BLOCK = 32;          // = exact_step.py::BLOCK
constexpr float INF_T = 1.0e9f;
enum { MODE_EXACT = 0, MODE_EXPORT = 1, MODE_RESUME = 2 };

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

// First qualifying event at columns >= max(base, 1) for the entities in
// `want`; candidates per column: the y wall, the x wall, then partners
// ascending -- the first strictly smaller time wins, and the first column
// whose best time is < dt.
__device__ __forceinline__ void detect(const float* g, int B,
                                       int K1, int b, const Consts& K,
                                       int want, int base, float (&st)[E],
                                       int (&sj)[E], int (&sc)[E],
                                       bool (&sv)[E]) {
  const int G = K1 - 1;
  const int k0 = base > 1 ? base : 1;
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

__global__ void __launch_bounds__(BLOCK)
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
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int G = K1 - 1;
  auto gi = [=](int c, int k) -> size_t {
    return ((size_t)c * K1 + k) * B + b;
  };
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
      for (int k = 0; k <= G; ++k) {
        const float* m = M6 + ((size_t)c * K1 + k) * 6;
        float acc = m[0] * z[e * 4 + 0];
        acc = acc + m[1] * z[e * 4 + 1];
        acc = acc + m[2] * z[e * 4 + 2];
        acc = acc + m[3] * z[e * 4 + 3];
        acc = acc + m[4] * z[20 + 2 * e];
        acc = acc + m[5] * z[21 + 2 * e];
        if (noise != nullptr) acc = acc + noise[gi(c, k)];
        g[gi(c, k)] = acc;
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) dacc[r] = 0.0f;
    detect(g, B, K1, b, K, (1 << E) - 1, 1, st, sj, sc, sv);
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
    float xi[4], xj[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xi[c] = g[gi(a * 4 + c, km1)];
      xj[c] = g[gi(ej * 4 + c, km1)];
    }
    const float r_i = pick(K.r, a), r_j = pick(K.r, ej);
    const float m_i = pick(K.m, a), m_j = pick(K.m, ej);
    const float tau_i = pick(K.tau, a), tau_j = pick(K.tau, ej);
    const float drag_i = pick(K.drag, a), drag_j = pick(K.drag, ej);
    const float uix = u[(2 * a) * B + b], uiy = u[(2 * a + 1) * B + b];
    const float ujx = u[(2 * ej) * B + b], ujy = u[(2 * ej + 1) * B + b];
    const float fa_i = pick(K.sa, a), fb_i = pick(K.sb, a);
    const float fa_j = pick(K.sa, ej), fb_j = pick(K.sb, ej);
    const float sci = pick(K.sc, a), sdi = pick(K.sd, a);
    const float scj = pick(K.sc, ej), sdj = pick(K.sd, ej);
    const float su_i[4] = {sci * uix, sci * uiy, sdi * uix, sdi * uiy};
    const float su_j[4] = {scj * ujx, scj * ujy, sdj * ujx, sdj * ujy};

    const float dt_t = tp - (float)km1 * K.dtcol;
    float xit[4], xjt[4];
    rk4(xi, uix, uiy, tau_i, drag_i, dt_t, xit);
    rk4(xj, ujx, ujy, tau_j, drag_j, dt_t, xjt);
    if (rnoise != nullptr) {
      // one substep of re-propagation noise at t_pop, before the impulse
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xit[c] = xit[c] + rnoise[gi(a * 4 + c, bn)];
        xjt[c] = xjt[c] + rnoise[gi(ej * 4 + c, bn)];
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

    // --- sequential feedback re-propagation, straight into the grid
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      g[gi(a * 4 + c, bn)] = ri[c];
      if (is_pair) g[gi(ej * 4 + c, bn)] = rj[c];
    }
    for (int k = bn + 1; k <= G; ++k) {
      float pi[4] = {ri[0] + fa_i * ri[2] + su_i[0], ri[1] + fa_i * ri[3] + su_i[1],
                     fb_i * ri[2] + su_i[2], fb_i * ri[3] + su_i[3]};
      if (rnoise != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) pi[c] = pi[c] + rnoise[gi(a * 4 + c, k)];
      }
      if (is_pair) {
        float pj[4] = {rj[0] + fa_j * rj[2] + su_j[0], rj[1] + fa_j * rj[3] + su_j[1],
                       fb_j * rj[2] + su_j[2], fb_j * rj[3] + su_j[3]};
        if (rnoise != nullptr) {
#pragma unroll
          for (int c = 0; c < 4; ++c) pj[c] = pj[c] + rnoise[gi(ej * 4 + c, k)];
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
        g[gi(a * 4 + c, k)] = ri[c];
        if (is_pair) g[gi(ej * 4 + c, k)] = rj[c];
      }
    }

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
    detect(g, B, K1, b, K, want, bn, st, sj, sc, sv);
  }

  // --- finalize: decided games keep their inputs, live games advance
  const float u01 = undec ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    xout[c * B + b] = undec ? g[gi(c, G)] : x[c * B + b];
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

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError().  `consts` is a
// host array of 82 floats; every other pointer is device memory.  `g` is
// the working grid (20, K1, B): written by the populate, or holding the
// exported grid to resume from; it is the export grid afterwards.
// `noise`, `rnoise`, `carry_in` and `carry_out` may be null where the
// mode does not use them.
extern "C" int rg_exact_step(const float* consts, const float* M6,
                             const float* x, const float* u,
                             const float* meta, const float* dmgin,
                             const float* noise, const float* rnoise,
                             float* g, const float* carry_in, float* xout,
                             float* aux, float* carry_out, int B, int K1,
                             int mode, int cap, void* stream) {
  Consts K;
  memcpy(&K, consts, sizeof(K));
  const int blocks = (B + BLOCK - 1) / BLOCK;
  exact_step_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      K, M6, x, u, meta, dmgin, noise, rnoise, g, carry_in, xout, aux,
      carry_out, B, K1, mode, cap);
  return (int)cudaGetLastError();
}

"""Event-order-exact batched control step (``engine="pallas_exact"``).

Counterpart of the JAX package's ``physics/pallas_step.py`` host glue for
the exact modes.  One function, called K1 below, carries the whole control
step of every game:

1. populate the 51-column x 20-component sub-step grid as the affine map
   M [x; u] (plus the populate noise plane in stochastic mode);
2. detect the first qualifying wall or pair event per entity;
3. pop the single globally-earliest event (ties to the highest entity),
   skipping events of an already-scored puck;
4. resolve it (partial RK4, de-penetration + elastic impulse + damage, or
   wall flip + goal test), re-propagate the two involved entities column by
   column with overlap corrections fed back, and re-detect only them
   (stale slots of other entities are invalidated without recompute);
5. loop until no slot is valid or the event cap is reached; finalize.

K1 has two implementations with the same interface:

* the hand-written CUDA kernel ``csrc/exact_step.cu`` (``kernels.py``),
  used for every CUDA tensor;
* :func:`exact_step_plain`, the same function written with batched tensor
  ops: the event loop as a Python ``while``, the feedback loop as a Python
  ``for`` over columns.  It runs for CPU tensors (the tests) and, on the
  card, only as the kernel's yardstick in ``chip_smoke.py``.

:func:`_kernel_call` dispatches on the tensors' device, with no fallback.
Planes keep the JAX package's lane-major layout (component rows, games in
the last dimension) without its 128-lane padding: x (20, B), u (10, B),
meta (8, B), dmg (16, B), grid and noise planes (20, G+1, B), carry
(48, B).  Every division the kernel does is a true f32 division on tensor
operands here, so the two versions run the same IEEE operations in the
same order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import PUCK, SimParams
from ..plain import plain_version
from ..state import GameState
from .sweep import _affine_tables_np, _substep_affine_np, game_draws, \
    populate_noise, repropagation_noise

NC = 20              # state components: 5 entities x 4
E = 5
CARRY_ROWS = 48
_INF = 1.0e9
MODES = ("exact", "exact_export", "exact_resume")
# The two-phase compaction budget is a multiple of BLOCK games.
BLOCK = 32

# unordered entity pairs (i < o) in the kernel's order
_PAIRS = [(i, o) for i in range(E) for o in range(i + 1, E)]
_PAIR_ID = {p: n for n, p in enumerate(_PAIRS)}


def _substep_scalars(params: SimParams):
    """The one-substep RK4 affine map collapsed to 4 scalars per entity:
    F = [[1,0,a,0],[0,1,0,a],[0,0,b,0],[0,0,0,b]], S = [[c,0],[0,c],[d,0],
    [0,d]].  The feedback re-propagation uses these directly."""
    F, S, _ = _substep_affine_np(params)
    a = [float(F[e][0, 2]) for e in range(5)]
    b = [float(F[e][2, 2]) for e in range(5)]
    c = [float(S[e][0, 0]) for e in range(5)]
    d = [float(S[e][2, 0]) for e in range(5)]
    return a, b, c, d


@functools.lru_cache(maxsize=16)
def _tables(key):
    """Per-component affine tables M (20, G+1, 32) mapping [x(20); u(10);
    pad 2] to grid column values, and the z tables FI (80, G+1) = Finvpow
    and SP (40, G+1) = Spow of the parallel-resolution step (K6,
    ``parallel_step.py``), float32 numpy."""
    params = SimParams(**dict(key))
    G = params.grid_points
    Fpow, Spow, _ = _affine_tables_np(params)      # (G+1,5,4,4), (G+1,5,4,2)
    F, _, _ = _substep_affine_np(params)
    Finv = np.stack([np.linalg.inv(F[e]) for e in range(5)])
    Finvpow = np.zeros((G + 1, 5, 4, 4))
    Finvpow[0] = np.eye(4)
    for d in range(1, G + 1):
        Finvpow[d] = np.einsum("eij,ejk->eik", Finv, Finvpow[d - 1])
    M = np.zeros((NC, G + 1, 32))
    for e in range(5):
        for i in range(4):
            c = e * 4 + i
            M[c, :, e * 4:e * 4 + 4] = Fpow[:, e, i, :]
            M[c, :, 20 + e * 2:20 + e * 2 + 2] = Spow[:, e, i, :]
    FI = Finvpow.reshape(G + 1, 80).T.copy()
    SP = Spow.reshape(G + 1, 40).T.copy()
    return (M.astype(np.float32), FI.astype(np.float32),
            SP.astype(np.float32))


def _table_key(params: SimParams):
    return (("dt", params.dt), ("grid_points", params.grid_points),
            ("tau_player", params.tau_player),
            ("tau_puck", params.tau_puck))


# z-vector index of the 6 non-zeros of row c of M: the entity's own 4
# state components, then its 2 controls (zero padding for the puck)
_NZ = np.array([[e * 4 + i for i in range(4)] + [20 + 2 * e, 21 + 2 * e]
                for e in range(E) for _ in range(4)])              # (20, 6)


def _sparse_M(params: SimParams) -> np.ndarray:
    """(20, G+1, 6) float32: the non-zeros of M in ``_NZ`` order; the
    populate sums them in this order in both implementations."""
    M, _, _ = _tables(_table_key(params))
    return np.ascontiguousarray(np.take_along_axis(
        M, _NZ[:, None, :].repeat(M.shape[1], axis=1), axis=2))


# Scalar constants, as f32, in the order of ``struct Consts`` in
# csrc/exact_step.cu.  Each is rounded once from the float64 expression
# the JAX kernel folds at trace time.
CONST_FIELDS = (["dt", "dtcol", "halfx", "halfy", "gh2", "buf", "ws"]
                + [f"{n}{e}" for n in ("r", "m", "tau", "drag", "sa", "sb",
                                       "sc", "sd", "bmry", "bmrx")
                   for e in range(E)]
                + [f"sig2_{i}{o}" for i in range(E) for o in range(E)])


def _consts(params: SimParams) -> np.ndarray:
    sa, sb, sc, sd = _substep_scalars(params)
    hx, hy = params.arena_x / 2.0, params.arena_y / 2.0
    r = params.radii
    v = [params.dt, params.dt_col, hx, hy, params.goal_height / 2.0,
         params.overlap_buffer, float(params.winning_score)]
    v += list(r) + list(params.masses) + list(params.taus)
    v += list(params.drags) + sa + sb + sc + sd
    v += [hy - r[e] for e in range(E)] + [hx - r[e] for e in range(E)]
    v += [(r[i] + r[o]) * (r[i] + r[o]) for i in range(E) for o in range(E)]
    out = np.asarray(v, dtype=np.float32)
    assert out.shape == (len(CONST_FIELDS),)
    return out


class _Tabs:
    """Per-(params, device) constants of K1 and K6: the sparse populate
    table, K6's z tables and the f32 scalars (as numpy for the kernels, as
    tensors here)."""

    def __init__(self, params: SimParams, device: torch.device):
        self.G = params.grid_points
        self.M6 = torch.from_numpy(_sparse_M(params)).to(device)
        _, FI, SP = _tables(_table_key(params))
        self.FI = torch.from_numpy(FI).to(device)              # (80, G+1)
        self.SP = torch.from_numpy(SP).to(device)              # (40, G+1)
        self.consts = _consts(params)
        c = dict(zip(CONST_FIELDS, self.consts.tolist()))
        self.c = c
        t = lambda vals: torch.tensor(vals, dtype=torch.float32,
                                      device=device)
        self.r = t([c[f"r{e}"] for e in range(E)])
        self.m = t([c[f"m{e}"] for e in range(E)])
        self.tau = t([c[f"tau{e}"] for e in range(E)])
        self.drag = t([c[f"drag{e}"] for e in range(E)])
        self.sa = t([c[f"sa{e}"] for e in range(E)])
        self.sb = t([c[f"sb{e}"] for e in range(E)])
        self.sc = t([c[f"sc{e}"] for e in range(E)])
        self.sd = t([c[f"sd{e}"] for e in range(E)])
        self.bmry = t([c[f"bmry{e}"] for e in range(E)])[:, None]
        self.bmrx = t([c[f"bmrx{e}"] for e in range(E)])[:, None]
        self.rcol = self.r[:, None]
        self.sig2 = t([c[f"sig2_{i}{o}"] for i, o in _PAIRS])[:, None]
        self.pi = torch.tensor([i for i, _ in _PAIRS], device=device)
        self.po = torch.tensor([o for _, o in _PAIRS], device=device)
        # candidate order per entity: partners ascending
        part = [[_PAIR_ID[(min(e, o), max(e, o))] for o in range(E)
                 if o != e] for e in range(E)]
        self.part = torch.tensor(part, device=device)              # (5, 4)
        self.part_m = [[float(16 * 4 + o + 1) for o in range(E) if o != e]
                       for e in range(E)]
        k = torch.arange(self.G + 1, device=device)
        self.k = k
        self.kf = k.to(torch.float32)
        self.dirx = t([0.0, 0.0, -1.0, 1.0, 0.0])
        self.diry = t([-1.0, 1.0, 0.0, 0.0, 0.0])


@functools.lru_cache(maxsize=16)
def _tabs_cached(key, device: torch.device) -> _Tabs:
    return _Tabs(SimParams(**dict(key)), device)


def _tabs(params: SimParams, device: torch.device) -> _Tabs:
    key = _table_key(params) + (
        ("winning_score", params.winning_score),
        ("arena_x", params.arena_x), ("arena_y", params.arena_y),
        ("goal_height", params.goal_height),
        ("overlap_buffer", params.overlap_buffer),
        ("player_radius", params.player_radius),
        ("puck_radius", params.puck_radius),
        ("player_mass", params.player_mass),
        ("puck_mass", params.puck_mass))
    return _tabs_cached(key, device)


# ---------------------------------------------------------------------------
# The plain PyTorch version of K1
# ---------------------------------------------------------------------------

def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as a true f32 division (a Python divisor is turned into a
    tensor: CUDA divides by a host scalar through its reciprocal)."""
    return a / torch.full_like(a, b)


def _rk4(px, py, vx, vy, ux, uy, tau, drag, h):
    """One RK4 step of vdot = (u - drag v)/tau over per-game h."""
    def f(vx_, vy_):
        return (ux - drag * vx_) / tau, (uy - drag * vy_) / tau
    a1x, a1y = f(vx, vy)
    k2x, k2y = vx + a1x * h / 2, vy + a1y * h / 2
    a2x, a2y = f(k2x, k2y)
    k3x, k3y = vx + a2x * h / 2, vy + a2y * h / 2
    a3x, a3y = f(k3x, k3y)
    k4x, k4y = vx + a3x * h, vy + a3y * h
    a4x, a4y = f(k4x, k4y)
    h6 = _div(h, 6.0)
    return [px + (vx + 2 * k2x + 2 * k3x + k4x) * h6,
            py + (vy + 2 * k2y + 2 * k3y + k4y) * h6,
            vx + (a1x + 2 * a2x + 2 * a3x + a4x) * h6,
            vy + (a1y + 2 * a2y + 2 * a3y + a4y) * h6]


def _detect_plain(gr, base, T: _Tabs):
    """First qualifying event per entity at columns >= base (and >= 1).
    gr (B, 5, 4, G+1); base (B, 5) or (B, 1).  Returns t, j, c, valid,
    each (B, 5).  Candidates per column: the y wall, the x wall (each one
    sign-selected candidate), then partners ascending; the first strictly
    smaller time wins, and the first column whose best time is < dt."""
    c = T.c
    G = T.G
    prv = torch.roll(gr, 1, dims=-1)
    tm = (T.kf - 1.0) * c["dtcol"]
    # a pair's differences at column k - 1 are those at column k rolled
    # one column on, so each is computed once (the same values)
    D = gr[:, T.po] - gr[:, T.pi]                           # (B, 10, 4, G+1)
    dxk, dyk = D[:, :, 0], D[:, :, 1]
    d2 = dxk * dxk + dyk * dyk
    over = d2 <= T.sig2
    dxm, dym, dvx, dvy = torch.roll(D, 1, dims=-1).unbind(2)
    b = dxm * dvx + dym * dvy
    dvv = dvx * dvx + dvy * dvy
    dpp = torch.roll(d2, 1, dims=-1)
    disc = b * b - dvv * (dpp - T.sig2)
    ok = over & (b < 0) & (disc >= 0) & (dvv > 0)
    den = torch.where(dvv == 0, 1.0, dvv)
    tau = torch.clamp_min(
        -(b + torch.sqrt(torch.clamp_min(disc, 0.0))) / den, 0.0)
    ptc = torch.where(ok, tm + tau, _INF)                      # (B, 10, G+1)

    best_t = best_m = None
    for cid0, (ax, bmr, half) in enumerate(((1, T.bmry, c["halfy"]),
                                            (0, T.bmrx, c["halfx"]))):
        pk = gr[:, :, ax]
        pm = prv[:, :, ax]
        vm = prv[:, :, ax + 2]
        toward = torch.where(vm >= 0, 1.0, -1.0)
        overlap = toward * pk + T.rcol >= half
        den = torch.where(vm == 0, 1.0, vm)
        tau = torch.clamp_min((bmr * toward - pm) / den, 0.0)
        tc = torch.where(overlap & (vm != 0), tm + tau, _INF)
        cm = torch.where(vm >= 0, 16.0 * (2 * cid0), 16.0 * (2 * cid0 + 1))
        if best_t is None:
            best_t, best_m = tc, cm
        else:
            better = tc < best_t
            best_m = torch.where(better, cm, best_m)
            best_t = torch.where(better, tc, best_t)
    pt = ptc[:, T.part]                                     # (B, 5, 4, G+1)
    for n in range(E - 1):
        tc = pt[:, :, n]
        better = tc < best_t
        mval = best_m.new_tensor([T.part_m[e][n] for e in range(E)])[:, None]
        best_m = torch.where(better, mval, best_m)
        best_t = torch.where(better, tc, best_t)

    q = (best_t < c["dt"]) & (T.k >= 1) & (T.k >= base[..., None])
    kfirst = torch.where(q, T.k, G + 1).amin(dim=-1)                # (B, 5)
    found = kfirst <= G
    kc = torch.clamp(kfirst, max=G)[..., None]
    sel_t = best_t.gather(-1, kc)[..., 0]
    sel_m = best_m.gather(-1, kc)[..., 0].to(torch.int64)
    return (torch.where(found, sel_t, _INF),
            torch.where(found, (sel_m & 15) - 1, -1),
            torch.where(found, sel_m >> 4, 0),
            found)


def _to_grid(plane: torch.Tensor) -> torch.Tensor:
    """(20, G+1, B) plane -> (B, 5, 4, G+1)."""
    K1, B = plane.shape[1], plane.shape[2]
    return plane.permute(2, 0, 1).reshape(B, E, 4, K1)


def _to_plane(gr: torch.Tensor) -> torch.Tensor:
    B, K1 = gr.shape[0], gr.shape[-1]
    return gr.reshape(B, NC, K1).permute(1, 2, 0).contiguous()


@plain_version
def exact_step_plain(T: _Tabs, x, u, meta, dmg, noise=None, rnoise=None,
                     grid_in=None, carry_in=None, mode: str = "exact",
                     cap: int = 49):
    """K1 in batched PyTorch ops over the planes (see :func:`_kernel_call`).
    Returns (xout (20,B), aux (24,B) = meta 8 + dmg 16, grid (20,G+1,B),
    carry (48,B)); the last two matter in export mode only."""
    c = T.c
    G = T.G
    B = x.shape[1]
    dev = x.device
    bi = torch.arange(B, device=dev)
    X, U = x.T, u.T
    undec = (meta[0] < c["ws"]) & (meta[1] < c["ws"])
    if mode == "exact_resume":
        gr = _to_grid(grid_in).clone()
        cr = carry_in.T
        st = cr[:, 0:5].clone()
        sj = cr[:, 5:10].to(torch.int64)
        sc = cr[:, 10:15].to(torch.int64)
        sv = cr[:, 15:20] > 0.5
        scored = cr[:, 20] > 0.5
        incA, incB = cr[:, 21].clone(), cr[:, 22].clone()
        dacc = cr[:, 23:39].clone()
        actv = cr[:, 39].clone()
    else:
        z = torch.cat([X, U, X.new_zeros((B, 2))], dim=1)[:, _NZ]  # (B,20,6)
        acc = T.M6[None, :, :, 0] * z[:, :, None, 0]
        for s in range(1, 6):
            acc = acc + T.M6[None, :, :, s] * z[:, :, None, s]
        if noise is not None:
            acc = acc + noise.permute(2, 0, 1)
        gr = acc.reshape(B, E, 4, G + 1)
        st, sj, sc, sv = _detect_plain(gr, bi.new_ones((B, 1)), T)
        scored = torch.zeros(B, dtype=torch.bool, device=dev)
        incA = x.new_zeros(B)
        incB = x.new_zeros(B)
        dacc = x.new_zeros((B, 16))
        actv = x.new_zeros(B)
    rn = None if rnoise is None else _to_grid(rnoise)
    ents = torch.arange(E, device=dev)
    trips = x.new_zeros(B)          # this call's loop trips per game
    it = 0
    while it < cap and bool(sv.any()):
        active = sv.any(dim=1)
        # --- pop the earliest valid slot; ties -> highest entity index
        a = torch.full((B,), -1, dtype=torch.int64, device=dev)
        tb = x.new_full((B,), _INF)
        for e in range(E):
            sel = sv[:, e] & ((a < 0) | (st[:, e] <= tb))
            a = torch.where(sel, e, a)
            tb = torch.where(sel, st[:, e], tb)
        a = a.clamp(min=0)
        t_pop = torch.where(active, st[bi, a], 0.0)
        ct = torch.where(active, sc[bi, a], 0)
        is_pair = ct == 4
        e_j = torch.where(is_pair, sj[bi, a], 0)
        puck_inv = (a == PUCK) | (is_pair & (e_j == PUCK))
        skip = active & puck_inv & scored
        live = active & ~skip

        # --- gather the two involved entities at column km1
        km1 = torch.clamp(_div(t_pop, c["dtcol"]).to(torch.int32), 0,
                          G - 1).to(torch.int64)
        base_new = km1 + 1
        xi = gr[bi, a, :, km1]
        xj = gr[bi, e_j, :, km1]
        r_i, m_i, tau_i, drag_i = T.r[a], T.m[a], T.tau[a], T.drag[a]
        r_j, m_j, tau_j, drag_j = T.r[e_j], T.m[e_j], T.tau[e_j], \
            T.drag[e_j]
        u_i = (U[bi, 2 * a], U[bi, 2 * a + 1])
        u_j = (U[bi, 2 * e_j], U[bi, 2 * e_j + 1])
        fa_i, fb_i, fa_j, fb_j = T.sa[a], T.sb[a], T.sa[e_j], T.sb[e_j]
        su_i = torch.stack([T.sc[a] * u_i[0], T.sc[a] * u_i[1],
                            T.sd[a] * u_i[0], T.sd[a] * u_i[1]], dim=1)
        su_j = torch.stack([T.sc[e_j] * u_j[0], T.sc[e_j] * u_j[1],
                            T.sd[e_j] * u_j[0], T.sd[e_j] * u_j[1]], dim=1)

        dt_t = t_pop - km1.to(torch.float32) * c["dtcol"]
        xi_t = _rk4(*xi.unbind(1), *u_i, tau_i, drag_i, dt_t)
        xj_t = _rk4(*xj.unbind(1), *u_j, tau_j, drag_j, dt_t)
        if rn is not None:
            # one substep of re-propagation noise injected at t_pop,
            # before the impulse (the rnoise row at base_new)
            ni = rn[bi, a, :, base_new]
            nj = rn[bi, e_j, :, base_new]
            xi_t = [xi_t[k] + ni[:, k] for k in range(4)]
            xj_t = [xj_t[k] + nj[:, k] for k in range(4)]

        # --- pair: de-penetrate (1.01) + elastic impulse
        pijx = xj_t[0] - xi_t[0]
        pijy = xj_t[1] - xi_t[1]
        pn = torch.sqrt(pijx * pijx + pijy * pijy)
        rr = r_i + r_j
        ovl = rr - pn
        app = ovl > 0
        rsum = torch.where(rr > 0, rr, 1.0)
        ci = torch.where(app, 1.01 * r_i / rsum * ovl, 0.0)
        cj = torch.where(app, 1.01 * r_j / rsum * ovl, 0.0)
        p_ix = xi_t[0] - ci * pijx
        p_iy = xi_t[1] - ci * pijy
        p_jx = xj_t[0] + cj * pijx
        p_jy = xj_t[1] + cj * pijy
        d12x = p_ix - p_jx
        d12y = p_iy - p_jy
        den = d12x * d12x + d12y * d12y
        den = torch.where(den > 0, den, 1.0)
        rvx = xi_t[2] - xj_t[2]
        rvy = xi_t[3] - xj_t[3]
        dot = (rvx * d12x + rvy * d12y) / den
        mm = m_i + m_j
        msum = torch.where(mm > 0, mm, 1.0)
        vi_nx = xi_t[2] - 2.0 * m_j / msum * dot * d12x
        vi_ny = xi_t[3] - 2.0 * m_j / msum * dot * d12y
        vj_nx = xj_t[2] + 2.0 * m_i / msum * dot * d12x
        vj_ny = xj_t[3] + 2.0 * m_i / msum * dot * d12y

        # --- damage between two players
        dv2 = 0.01 * (rvx * rvx + rvy * rvy)
        hit = live & is_pair & (a != PUCK) & (e_j != PUCK)
        rows = torch.arange(16, device=dev)
        dacc = dacc + torch.where(
            hit[:, None] & (rows == (a * 4 + e_j)[:, None]),
            (m_i * dv2)[:, None], 0.0)
        dacc = dacc + torch.where(
            hit[:, None] & (rows == (e_j * 4 + a)[:, None]),
            (m_j * dv2)[:, None], 0.0)

        # --- wall: sign-conditioned flip + goal
        flip_y = ((ct == 0) & (xi_t[3] > 0)) | ((ct == 1) & (xi_t[3] < 0))
        flip_x = ((ct == 2) & (xi_t[2] > 0)) | ((ct == 3) & (xi_t[2] < 0))
        w_vx = torch.where(flip_x, -xi_t[2], xi_t[2])
        w_vy = torch.where(flip_y, -xi_t[3], xi_t[3])
        goal = (~is_pair & (a == PUCK) & ((ct == 2) | (ct == 3))
                & (xi_t[1] < c["gh2"]) & (xi_t[1] > -c["gh2"]))
        ginc = goal & live & ~scored
        incA = incA + torch.where(ginc & (ct == 2), 1.0, 0.0)
        incB = incB + torch.where(ginc & (ct == 3), 1.0, 0.0)
        new_scored = scored | (goal & live)

        # --- value at grid column base_new
        xi_res = [torch.where(is_pair, p_ix, xi_t[0]),
                  torch.where(is_pair, p_iy, xi_t[1]),
                  torch.where(is_pair, vi_nx, w_vx),
                  torch.where(is_pair, vi_ny, w_vy)]
        rem = c["dtcol"] - dt_t
        xi_b = _rk4(*xi_res, *u_i, tau_i, drag_i, rem)
        xj_b = _rk4(p_jx, p_jy, vj_nx, vj_ny, *u_j, tau_j, drag_j, rem)
        pbx = xj_b[0] - xi_b[0]
        pby = xj_b[1] - xi_b[1]
        ov2 = rr - torch.sqrt(pbx * pbx + pby * pby)
        ap2 = ov2 > 0
        bri = c["buf"] * r_i / rsum
        brj = c["buf"] * r_j / rsum
        ci2 = torch.where(ap2, bri * ov2, 0.0)
        cj2 = torch.where(ap2, brj * ov2, 0.0)
        # the wall correction of the event's own wall (ct); for the other
        # walls JAX adds exact zeros
        isy = ct <= 1
        sgn = torch.where((ct == 0) | (ct == 2), 1.0, -1.0)
        half = torch.where(isy, c["halfy"], c["halfx"])
        wall = ct < 4
        dirx, diry = T.dirx[ct], T.diry[ct]

        def wall_fix(px, py):
            ow = sgn * torch.where(isy, py, px) + r_i - half
            on = wall & (ow > 0)
            cw = c["buf"] * ow
            return (px + torch.where(on, cw * dirx, 0.0),
                    py + torch.where(on, cw * diry, 0.0))

        wbx, wby = wall_fix(xi_b[0], xi_b[1])
        xi_base = torch.stack([
            torch.where(is_pair, xi_b[0] - ci2 * pbx,
                        torch.where(goal, 0.0, wbx)),
            torch.where(is_pair, xi_b[1] - ci2 * pby,
                        torch.where(goal, 0.0, wby)),
            torch.where(is_pair, xi_b[2], torch.where(goal, 0.0, xi_b[2])),
            torch.where(is_pair, xi_b[3], torch.where(goal, 0.0, xi_b[3]))],
            dim=1)
        xj_base = torch.stack([xj_b[0] + cj2 * pbx, xj_b[1] + cj2 * pby,
                               xj_b[2], xj_b[3]], dim=1)

        # --- sequential feedback re-propagation over columns > base_new
        # (the loop's invariants are taken once and the columns' rows
        # stacked at the end: the same arithmetic in fewer operations)
        ri, rj = xi_base, xj_base
        k0 = int(torch.where(live, base_new, G + 1).min())
        # only the branches some live game takes are computed (the others
        # would be selected away)
        pairs = bool((live & is_pair).any())
        walls = bool((live & ~is_pair).any())
        fa_i2, fb_i2, fa_j2, fb_j2 = (f[:, None] for f in (fa_i, fb_i, fa_j,
                                                            fb_j))
        sp_i, sv_i, sp_j, sv_j = su_i[:, :2], su_i[:, 2:], su_j[:, :2], \
            su_j[:, 2:]
        gates = (live[:, None] & (T.k[None, :] > base_new[:, None]))[..., None]
        gates_j = gates & is_pair[:, None, None]
        rn_i = None if rn is None else rn[bi, a]
        rn_j = None if rn is None else rn[bi, e_j]
        cols_i, cols_j = [], []
        for k in range(k0 + 1, G + 1):
            vi = ri[:, 2:]
            pi = torch.cat([ri[:, :2] + fa_i2 * vi + sp_i, fb_i2 * vi + sv_i],
                           dim=1)
            if rn is not None:
                pi = pi + rn_i[:, :, k]
            p0, p1, p2, p3 = pi.unbind(1)
            if walls:
                ci_x, ci_y = wall_fix(p0, p1)
            if pairs:
                vj = rj[:, 2:]
                pj = torch.cat([rj[:, :2] + fa_j2 * vj + sp_j,
                                fb_j2 * vj + sv_j], dim=1)
                if rn is not None:
                    pj = pj + rn_j[:, :, k]
                q0, q1, q2, q3 = pj.unbind(1)
                dx = q0 - p0
                dy = q1 - p1
                ov = rr - torch.sqrt(dx * dx + dy * dy)
                go = ov > 0
                cie = torch.where(go, bri * ov, 0.0)
                cje = torch.where(go, brj * ov, 0.0)
                px, py = p0 - cie * dx, p1 - cie * dy
                ci_x = torch.where(is_pair, px, ci_x) if walls else px
                ci_y = torch.where(is_pair, py, ci_y) if walls else py
                rj = torch.where(gates_j[:, k],
                                 torch.stack([q0 + cje * dx, q1 + cje * dy,
                                              q2, q3], dim=1), rj)
                cols_j.append(rj)
            ri = torch.where(gates[:, k],
                             torch.stack([ci_x, ci_y, p2, p3], dim=1), ri)
            cols_i.append(ri)

        def role(base, cols):
            """(B, 4, G+1): ``base`` up to column k0, then ``cols``."""
            head = base[:, :, None].expand(B, 4, G + 1 - len(cols))
            return torch.cat([head, torch.stack(cols, 2)], 2) if cols \
                else head

        role_i, role_j = role(xi_base, cols_i), role(xj_base, cols_j)
        rowm = (T.k[None, :] >= base_new[:, None])[:, None, :]   # (B,1,G+1)
        gr[bi, a] = torch.where(live[:, None, None] & rowm, role_i,
                                gr[bi, a])
        gr[bi, e_j] = torch.where((live & is_pair)[:, None, None] & rowm,
                                  role_j, gr[bi, e_j])

        # --- slot bookkeeping: re-detect the touched entities from
        # base_new, invalidate (without recompute) slots naming them
        st_r, sj_r, sc_r, sv_r = _detect_plain(gr, base_new[:, None], T)
        take = ents[None, :] == a[:, None]
        touched = take | (is_pair[:, None] & (ents[None, :] == e_j[:, None]))
        jt = (((sj == a[:, None]) | (is_pair[:, None] & (sj == e_j[:, None])))
              & (sj >= 0))
        aff = touched & live[:, None]
        sv_n = torch.where(aff, sv_r, sv & ~touched & ~jt)
        upd = live[:, None]
        st = torch.where(aff, st_r, st)
        sj = torch.where(aff, sj_r, sj)
        sc = torch.where(aff, sc_r, sc)
        sv = torch.where(upd, sv_n,
                         torch.where(skip[:, None], sv & ~take, sv))
        actv = actv + torch.where(active, 1.0, 0.0)
        trips = trips + torch.where(active, 1.0, 0.0)
        scored = new_scored
        it += 1

    xfin = gr[:, :, :, G].reshape(B, NC)
    xout = torch.where(undec[:, None], xfin, X)
    u01 = torch.where(undec, 1.0, 0.0)
    pend = torch.where(sv.any(dim=1) & undec, 1.0, 0.0)
    zero = x.new_zeros(B)
    aux = torch.stack([meta[0] + u01 * incA, meta[1] + u01 * incB,
                       meta[2] + u01 * c["dt"], actv, trips, pend,
                       zero, zero], dim=1)
    aux = torch.cat([aux, dmg.T + u01[:, None] * dacc], dim=1)
    carry = torch.cat([st, sj.to(torch.float32), sc.to(torch.float32),
                       sv.to(torch.float32), scored.to(torch.float32)[:, None],
                       incA[:, None], incB[:, None], dacc, actv[:, None],
                       x.new_zeros((B, 8))], dim=1)
    return (xout.T.contiguous(), aux.T.contiguous(), _to_plane(gr),
            carry.T.contiguous())


# ---------------------------------------------------------------------------
# Dispatch, two-phase, step
# ---------------------------------------------------------------------------

def _kernel_call(planes, u, params: SimParams, noise_plane=None,
                 mode: str = "exact", cap: int = None, grid_in=None,
                 carry_in=None, rnoise_plane=None):
    """One K1 invocation over lane-major planes: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    ``cap`` is the event budget (default collision_counter_lim - 1).
    Stochastic runs take the populate noise plane (modes exact and
    exact_export) and the re-propagation noise plane (all modes).  Returns
    (x, meta, dmg); exact_export also returns the grid (20, G+1, B) and the
    48-row carry that exact_resume restarts from (``grid_in`` is not
    modified)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    x, meta, dmg = planes
    if cap is None:
        cap = params.collision_counter_lim - 1
    noise = noise_plane if params.stochastic and mode != "exact_resume" \
        else None
    rnoise = rnoise_plane if params.stochastic else None
    if params.stochastic and (rnoise is None or (
            noise is None and mode != "exact_resume")):
        raise ValueError("stochastic K1 needs its noise planes")
    if mode == "exact_resume" and (grid_in is None or carry_in is None):
        raise ValueError("exact_resume needs grid_in and carry_in")
    T = _tabs(params, x.device)
    if x.device.type == "cuda":
        from .. import kernels
        xout, aux, grid, carry = kernels.exact_step(
            T.M6, T.consts, x, u, meta, dmg, noise, rnoise, grid_in,
            carry_in, mode, cap)
    elif x.device.type == "cpu":
        xout, aux, grid, carry = exact_step_plain(
            T, x, u, meta, dmg, noise, rnoise, grid_in, carry_in, mode, cap)
    else:
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {x.device}")
    out = (xout, aux[0:8], aux[8:24])
    if mode == "exact_export":
        return out, grid, carry
    return out


def _compact_lanes(B: int, params: SimParams) -> int:
    """K: the resume budget, B/compact_frac rounded up to whole blocks."""
    want = -(-(B // params.compact_frac) // BLOCK) * BLOCK
    return min(B, max(BLOCK, want))


def _twophase_planes_exact(planes, u, params: SimParams, noise_plane=None,
                           rnoise_plane=None):
    """Two-phase compact-and-resume.  Phase 1 caps every game at
    ``phase1_iters`` events and exports the loop state; the pending games
    are gathered into K lanes and finished at the remaining budget, their
    results scattered back.  When more than K games are pending the resume
    runs over the full batch instead, so the result equals one-phase
    bitwise at every pending count.  The pending count is one host fetch
    per step."""
    x_in, meta_in, dmg_in = planes
    B = x_in.shape[1]
    p1 = params.phase1_iters
    ev_total = params.collision_counter_lim - 1
    (x1, meta1, dmg1), grid, carry = _kernel_call(
        planes, u, params, noise_plane, mode="exact_export",
        cap=min(p1, ev_total), rnoise_plane=rnoise_plane)
    if p1 >= ev_total:
        return x1, meta1, dmg1
    K = _compact_lanes(B, params)
    pending = meta1[5]
    if K >= B or int((pending > 0.5).sum()) > K:
        return _kernel_call(planes, u, params, mode="exact_resume",
                            cap=ev_total - p1, grid_in=grid, carry_in=carry,
                            rnoise_plane=rnoise_plane)
    idx = torch.argsort(-pending, stable=True)[:K]
    rn_g = None if rnoise_plane is None else rnoise_plane[..., idx]
    x2, meta2, dmg2 = _kernel_call(
        (x_in[:, idx], meta_in[:, idx], dmg_in[:, idx]), u[:, idx], params,
        mode="exact_resume", cap=ev_total - p1, grid_in=grid[..., idx],
        carry_in=carry[:, idx], rnoise_plane=rn_g)
    x1[:, idx] = x2
    meta1[:, idx] = meta2
    dmg1[:, idx] = dmg2
    return x1, meta1, dmg1


def _to_planes(states: GameState):
    """GameState (B-leading) -> lane-major f32 planes (x, meta, dmg)."""
    B = states.score.shape[0]
    f = torch.float32
    x = states.x.to(f).reshape(B, NC).T.contiguous()
    meta = torch.cat([states.score.to(f).T, states.t.to(f)[None],
                      x.new_zeros((5, B))], dim=0)
    dmg = states.damage.to(f).reshape(B, 16).T.contiguous()
    return x, meta, dmg


def _u_plane(controls, B: int) -> torch.Tensor:
    c = controls.to(torch.float32).reshape(B, 8)
    return torch.cat([c, c.new_zeros((B, 2))], dim=1).T.contiguous()


def _noise_plane(contrib: torch.Tensor) -> torch.Tensor:
    """Populate noise (B, G, 4, 4) -> kernel plane (20, G+1, B): rows
    e*4+c for players, column 0 and the puck rows zero."""
    B, G = contrib.shape[:2]
    plane = contrib.new_zeros((NC, G + 1, B))
    plane[:16, 1:] = contrib.permute(2, 3, 1, 0).reshape(16, G, B)
    return plane


def _rnoise_plane(contrib: torch.Tensor) -> torch.Tensor:
    """Re-propagation noise (B, G+1, 4, 4) -> plane (20, G+1, B)."""
    B, K1 = contrib.shape[:2]
    plane = contrib.new_zeros((NC, K1, B))
    plane[:16] = contrib.permute(2, 3, 1, 0).reshape(16, K1, B)
    return plane


def _noise_planes(states: GameState, params: SimParams):
    """Both noise planes of a stochastic step and the advanced keys: the
    populate's normals from substream 0 and the re-propagation's from
    substream 1 of each game's Philox stream (:func:`.sweep.game_draws`:
    one draw-kernel launch each on the card, no host sync), so a game's
    noise depends on its own key only."""
    G = params.grid_points
    (xp, xr), new_keys = game_draws(states, (G, G + 1))
    return (_noise_plane(populate_noise(xp, params)),
            _rnoise_plane(repropagation_noise(xr, params)), new_keys)


def _from_planes(planes, states: GameState, new_keys,
                 params: SimParams) -> GameState:
    x, meta, dmg = planes
    B = states.score.shape[0]
    dt = params.torch_dtype
    return GameState(
        x=x.T.reshape(B, 5, 4).to(dt),
        score=meta[0:2].T.to(torch.int32),
        damage=dmg.T.reshape(B, 4, 4).to(dt),
        t=meta[2].to(dt),
        key=new_keys,
    )

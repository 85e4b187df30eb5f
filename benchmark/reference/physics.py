"""Plain reference of the event-order-exact control step.

A frozen, self-contained copy of the port's plain version of K1 (the
deterministic one-phase ``exact`` mode) and of the tables it reads,
written in batched PyTorch operations.  It imports nothing of the program:
the configuration's ``SimParams`` values come in as a plain dict, and
every table is worked out again here.  ``dtype`` sets the precision of the
tables and of the arithmetic: float32 is the reference, bfloat16 the
control of ``benchmark/control.py``.

The two-phase step of the program (phase 1 capped at ``phase1_iters``
events, then a resume) equals the one-phase step bitwise, so one function
serves as the reference of both.
"""

from __future__ import annotations

import numpy as np
import torch

NC = 20              # state components: 5 entities x 4
E = 5
_INF = 1.0e9
PUCK = 4             # entity rows: A1, A2, B1, B2, PUCK

# unordered entity pairs (i < o) in the step's order
_PAIRS = [(i, o) for i in range(E) for o in range(i + 1, E)]
_PAIR_ID = {p: n for n, p in enumerate(_PAIRS)}


class Sim:
    """The configuration's physics values and what follows from them."""

    def __init__(self, sp: dict):
        self.__dict__.update(sp)
        r, p = self.player_radius, self.puck_radius
        self.radii = (r, r, r, r, p)
        self.masses = (self.player_mass,) * 4 + (self.puck_mass,)
        self.taus = (self.tau_player,) * 4 + (self.tau_puck,)
        self.drags = (1.0, 1.0, 1.0, 1.0, 0.2)
        self.dt_col = self.dt / self.grid_points


def _substep_affine_np(p: Sim):
    """Per-entity one-substep RK4 affine map: F (5, 4, 4), S (5, 4, 2),
    float64."""
    h = p.dt_col
    F = np.zeros((5, 4, 4))
    S = np.zeros((5, 4, 2))
    I = np.eye(4)
    for e in range(5):
        tau, drag = p.taus[e], p.drags[e]
        Ac = np.zeros((4, 4))
        Ac[0, 2] = Ac[1, 3] = 1.0
        Ac[2, 2] = Ac[3, 3] = -drag / tau
        Bc = np.zeros((4, 2))
        Bc[2, 0] = Bc[3, 1] = 1.0 / tau
        hA = h * Ac
        hA2, hA3 = hA @ hA, hA @ hA @ hA
        F[e] = I + hA + hA2 / 2.0 + hA3 / 6.0 + hA3 @ hA / 24.0
        S[e] = h * (I + hA / 2.0 + hA2 / 6.0 + hA3 / 24.0) @ Bc
    return F, S


def _affine_tables_np(p: Sim):
    """Fpow[d] = F^d, Spow[d] = sum_{m<d} F^m S (d = 0..G): grid column k
    is x_k = Fpow[k] x_0 + Spow[k] u."""
    G = p.grid_points
    F, S = _substep_affine_np(p)
    Fpow = np.zeros((G + 1, 5, 4, 4))
    Spow = np.zeros((G + 1, 5, 4, 2))
    Fpow[0] = np.eye(4)
    for d in range(1, G + 1):
        Fpow[d] = np.einsum("eij,ejk->eik", F, Fpow[d - 1])
        Spow[d] = np.einsum("eij,ejk->eik", F, Spow[d - 1]) + S
    return Fpow, Spow


# z-vector index of the 6 non-zeros of row c of M: the entity's own 4
# state components, then its 2 controls (zero padding for the puck)
_NZ = np.array([[e * 4 + i for i in range(4)] + [20 + 2 * e, 21 + 2 * e]
                for e in range(E) for _ in range(4)])              # (20, 6)


def _sparse_M(p: Sim) -> np.ndarray:
    """(20, G+1, 6) float32: the non-zeros of the populate's affine map M
    [x(20); u(10); pad 2] -> grid column values, in ``_NZ`` order."""
    G = p.grid_points
    Fpow, Spow = _affine_tables_np(p)
    M = np.zeros((NC, G + 1, 32))
    for e in range(5):
        for i in range(4):
            c = e * 4 + i
            M[c, :, e * 4:e * 4 + 4] = Fpow[:, e, i, :]
            M[c, :, 20 + e * 2:20 + e * 2 + 2] = Spow[:, e, i, :]
    M = M.astype(np.float32)
    return np.ascontiguousarray(np.take_along_axis(
        M, _NZ[:, None, :].repeat(M.shape[1], axis=1), axis=2))


def _consts(p: Sim) -> dict:
    """The step's scalars, each rounded once to f32 from its float64
    expression."""
    F, S = _substep_affine_np(p)
    sa = [float(F[e][0, 2]) for e in range(5)]
    sb = [float(F[e][2, 2]) for e in range(5)]
    sc = [float(S[e][0, 0]) for e in range(5)]
    sd = [float(S[e][2, 0]) for e in range(5)]
    hx, hy = p.arena_x / 2.0, p.arena_y / 2.0
    r = p.radii
    c = {"dt": p.dt, "dtcol": p.dt_col, "halfx": hx, "halfy": hy,
         "gh2": p.goal_height / 2.0, "buf": p.overlap_buffer,
         "ws": float(p.winning_score)}
    for name, vals in (("r", r), ("m", p.masses), ("tau", p.taus),
                       ("drag", p.drags), ("sa", sa), ("sb", sb), ("sc", sc),
                       ("sd", sd), ("bmry", [hy - r[e] for e in range(E)]),
                       ("bmrx", [hx - r[e] for e in range(E)])):
        for e in range(E):
            c[f"{name}{e}"] = vals[e]
    for i in range(E):
        for o in range(E):
            c[f"sig2_{i}{o}"] = (r[i] + r[o]) * (r[i] + r[o])
    return {k: float(np.float32(v)) for k, v in c.items()}


class _Tabs:
    """The step's constants on ``device`` in ``dtype``."""

    def __init__(self, p: Sim, device, dtype=torch.float32):
        self.G = p.grid_points
        self.dtype = dtype
        self.M6 = torch.from_numpy(_sparse_M(p)).to(device=device,
                                                    dtype=dtype)
        c = _consts(p)
        self.c = c
        t = lambda vals: torch.tensor(vals, dtype=dtype, device=device)
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
        self.kf = k.to(dtype)
        self.dirx = t([0.0, 0.0, -1.0, 1.0, 0.0])
        self.diry = t([-1.0, 1.0, 0.0, 0.0, 0.0])


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


def _step_planes(T: _Tabs, x, u, meta, dmg, cap: int):
    """The deterministic one-phase control step over lane-major planes:
    x (20, B), u (10, B), meta (8, B), dmg (16, B).  Returns (xout (20, B),
    aux (24, B) = meta 8 + dmg 16)."""
    c = T.c
    G = T.G
    B = x.shape[1]
    dev = x.device
    bi = torch.arange(B, device=dev)
    one = x.new_ones(())
    zero0 = x.new_zeros(())
    X, U = x.T, u.T
    undec = (meta[0] < c["ws"]) & (meta[1] < c["ws"])
    if True:
        z = torch.cat([X, U, X.new_zeros((B, 2))], dim=1)[:, _NZ]  # (B,20,6)
        acc = T.M6[None, :, :, 0] * z[:, :, None, 0]
        for s in range(1, 6):
            acc = acc + T.M6[None, :, :, s] * z[:, :, None, s]
        gr = acc.reshape(B, E, 4, G + 1)
        st, sj, sc, sv = _detect_plain(gr, bi.new_ones((B, 1)), T)
        scored = torch.zeros(B, dtype=torch.bool, device=dev)
        incA = x.new_zeros(B)
        incB = x.new_zeros(B)
        dacc = x.new_zeros((B, 16))
        actv = x.new_zeros(B)
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

        dt_t = t_pop - km1.to(T.dtype) * c["dtcol"]
        xi_t = _rk4(*xi.unbind(1), *u_i, tau_i, drag_i, dt_t)
        xj_t = _rk4(*xj.unbind(1), *u_j, tau_j, drag_j, dt_t)

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
        incA = incA + torch.where(ginc & (ct == 2), one, zero0)
        incB = incB + torch.where(ginc & (ct == 3), one, zero0)
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
        cols_i, cols_j = [], []
        for k in range(k0 + 1, G + 1):
            vi = ri[:, 2:]
            pi = torch.cat([ri[:, :2] + fa_i2 * vi + sp_i, fb_i2 * vi + sv_i],
                           dim=1)
            p0, p1, p2, p3 = pi.unbind(1)
            if walls:
                ci_x, ci_y = wall_fix(p0, p1)
            if pairs:
                vj = rj[:, 2:]
                pj = torch.cat([rj[:, :2] + fa_j2 * vj + sp_j,
                                fb_j2 * vj + sv_j], dim=1)
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

        # (a no-op in f32; in a lower precision some branch values come
        # out of Python-scalar selects in f32)
        role_i = role(xi_base, cols_i).to(gr.dtype)
        role_j = role(xj_base, cols_j).to(gr.dtype)
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
        actv = actv + torch.where(active, one, zero0)
        trips = trips + torch.where(active, one, zero0)
        scored = new_scored
        it += 1

    xfin = gr[:, :, :, G].reshape(B, NC)
    xout = torch.where(undec[:, None], xfin, X)
    u01 = torch.where(undec, one, zero0)
    pend = torch.where(sv.any(dim=1) & undec, one, zero0)
    zero = x.new_zeros(B)
    aux = torch.stack([meta[0] + u01 * incA, meta[1] + u01 * incB,
                       meta[2] + u01 * c["dt"], actv, trips, pend,
                       zero, zero], dim=1)
    aux = torch.cat([aux, dmg.T + u01[:, None] * dacc], dim=1)
    return xout.T.contiguous(), aux.T.contiguous()


def step(sp: dict, x, score, damage, t, u, dtype=torch.float32):
    """One control step of a batch of games on the tensors' device: x
    (B, 5, 4), score (B, 2), damage (B, 4, 4), t (B,), controls u
    (B, 4, 2).  Decided games (a score at winning_score) keep their state.
    Returns (x, score int32, damage, t) in ``dtype``."""
    p = Sim(sp)
    if p.stochastic or p.noise:
        raise ValueError("this reference steps deterministic games only")
    T = _Tabs(p, x.device, dtype)
    B = x.shape[0]
    with torch.inference_mode():
        xp = x.to(dtype).reshape(B, NC).T.contiguous()
        meta = torch.cat([score.to(dtype).T, t.to(dtype)[None],
                          xp.new_zeros((5, B))], dim=0)
        dmg = damage.to(dtype).reshape(B, 16).T.contiguous()
        c = u.to(dtype).reshape(B, 8)
        up = torch.cat([c, c.new_zeros((B, 2))], dim=1).T.contiguous()
        xo, aux = _step_planes(T, xp, up, meta, dmg,
                               p.collision_counter_lim - 1)
        return (xo.T.reshape(B, 5, 4).clone(),
                aux[0:2].T.to(torch.int32).clone(),
                aux[8:24].T.reshape(B, 4, 4).clone(), aux[2].clone())

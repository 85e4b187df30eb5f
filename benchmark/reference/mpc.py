"""Plain reference of the closed-loop matchup's policy: a DMPC team
(field -1) against a CMPC team (field +1), each on its fused SQP route.

A frozen, self-contained copy of the port's plain versions: the teams'
targets and obstacle sets (``agents/dmpc_team.py``,
``agents/centralized.py``), the candidate grids and the closed-form QP
data (``control/dmpc.py``, ``control/cmpc.py``), K3's and K4's plain SQP
solves (``ops/sqp_lanes.py``, with the block-Schur ADMM of
``ops/qp_lanes.py``), the candidate costs and the least-cost selection.
It imports nothing of the program; the configuration's parameters come
in as plain dicts.  ``dtype`` sets the precision of the whole policy:
float32 is the reference, bfloat16 the control of ``control.py`` (torch
factors a matrix in f32 at least: there the factor is rounded back).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

OFFENSE, DEFENSE = 0, 1
ATTACKER, DEFENDER = 1, 2
A1, A2, B1, B2, PUCK = 0, 1, 2, 3, 4
CMPC_V_HIT = 5.0


def _omega(mpc, dtype, device):
    """The terminal weights diag(Omega) of one player."""
    return torch.tensor([mpc.w_pos, mpc.w_pos, mpc.w_vel, mpc.w_vel],
                        dtype=dtype, device=device)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _amax(*vs):
    return torch.stack([v.abs().amax(dim=-1) for v in vs]).amax(dim=0)


def _tri_inv(K):
    """The inverse of K's Cholesky factor.  torch factors in f32 at least:
    below it the factor is taken in f32 of the rounded K and rounded back,
    and a K that rounding has left indefinite gives NaNs for that problem
    (its candidate then never converges) instead of an error."""
    dt = K.dtype
    if dt in (torch.float32, torch.float64):
        L = torch.linalg.cholesky(K)
    else:
        L = torch.linalg.cholesky_ex(K.float())[0]
        bad = ~torch.isfinite(L).all(dim=(-1, -2)) | (
            L.diagonal(dim1=-2, dim2=-1) <= 0).any(dim=-1)
        L = torch.where(bad[:, None, None], float("nan"), L)
    eye = torch.eye(K.shape[-1], dtype=L.dtype, device=K.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L),
                                         upper=False).to(dt)


def _grid_tables(minT, maxT, t_grid: int, t_local: int, dtype, device):
    """The candidate grid's constant tensors on ``device``, made once (a
    host-to-device copy waits for the stream, so the per-step glue makes
    none): the global grid (t_grid,), the indices of the global candidates
    a warm grid keeps, and the local factors."""
    n_local = min(t_local, t_grid // 2)
    ratio = np.logspace(0.0, 1.0, t_grid, base=maxT / minT)
    keep = np.round(np.linspace(0, t_grid - 1, t_grid - n_local)).astype(int)
    factors = np.concatenate([[1.0], np.geomspace(0.7, 1.5, n_local - 1)]) \
        if n_local > 1 else np.asarray([1.0])
    return (torch.as_tensor(minT * ratio, dtype=dtype, device=device),
            torch.as_tensor(keep, device=device),
            torch.as_tensor(factors, dtype=dtype, device=device))


def candidate_steps(minT, maxT, t_grid: int, t_local: int, h_prev, valid,
                    dtype=torch.float32):
    """Hybrid free-final-time candidate grid for instances (...) of
    ``h_prev`` and ``valid``: (..., t_grid).

    Cold: a geometric grid over [minT, maxT], built in f64 and rounded once
    to ``dtype``.  Warm: the last ``t_local`` candidates are re-centred on
    the previous winner's step (factors 1, then geometric 0.7 .. 1.5,
    clipped to the bounds), the others keep spanning the global range."""
    glob, keep, factors = _grid_tables(minT, maxT, t_grid, t_local, dtype,
                                       h_prev.device)
    glob = glob.expand(h_prev.shape + (t_grid,))
    if min(t_local, t_grid // 2) == 0:
        return glob
    local = torch.clamp(h_prev[..., None] * factors, minT, maxT)
    warm = torch.cat([glob[..., keep], local], dim=-1)
    return torch.where(valid[..., None], warm, glob)


def _gains(h, tau, N: int, dtype):
    """Closed-form condensed gains of the exact-ZOH player model per axis,
    for step sizes h (Bt,): ``A^m B`` is [P[m]; V[m]] with
    P[m] = (h - s) + tau (1 - e^m)(1 - e), V[m] = e^m (1 - e),
    e = exp(-h/tau), s = tau (1 - e); the free response at knot k uses
    s_k = tau (1 - e^k), e_k = e^k.  Each (Bt, N)."""
    m = torch.arange(N, dtype=dtype, device=h.device)
    h = h[:, None]
    e1 = torch.exp(-h / tau)
    em = torch.exp(-(m * h) / tau)          # e^m, m = 0..N-1
    ek = em * e1                            # e^k, k = 1..N
    s1 = tau * (1.0 - e1)
    P = (h - s1) + tau * (1.0 - em) * (1.0 - e1)
    V = em * (1.0 - e1)
    sk = tau * (1.0 - ek)
    return P, V, sk, ek


# ---- DMPC (K3) ----

def dmpc_prepare(h, x0, x_des, obs, params, mpc):
    """Closed-form equivalent of the program's dense condensing restricted to the fields
    the fused route and :func:`dmpc_finish` read."""
    dtype, dev = x0.dtype, x0.device
    N = mpc.N
    nU = 2 * N
    Bt = h.shape[0]
    P, V, sk, ek = _gains(h, params.tau_player, N, dtype)
    Pt, Vt = P.flip(-1), V.flip(-1)          # index j: P[N-1-j]
    eye2 = torch.eye(2, dtype=dtype, device=dev)

    # H = 2 (gN^T Omega gN + reg I): axis-decoupled rank-2 structure
    Hs = 2.0 * (mpc.w_pos * (Pt[:, :, None] * Pt[:, None, :]) +
                mpc.w_vel * (Vt[:, :, None] * Vt[:, None, :]))   # (Bt, N, N)
    H = (Hs[:, :, None, :, None] * eye2[:, None, :]).reshape(Bt, nU, nU) \
        + 2.0 * mpc.u_reg * torch.eye(nU, dtype=dtype, device=dev)

    p0c, v0c = x0[:, 0:2], x0[:, 2:4]
    pos_free = p0c[:, None, :] + sk[:, :, None] * v0c[:, None, :]  # (Bt, N, 2)
    velN = ek[:, -1:] * v0c
    phiN_x0 = torch.cat([pos_free[:, -1], velN], dim=1)
    errp = pos_free[:, -1] - x_des[:, 0:2]
    errv = velN - x_des[:, 2:4]
    g = (2.0 * (mpc.w_pos * Pt[:, :, None] * errp[:, None, :] +
                mpc.w_vel * Vt[:, :, None] * errv[:, None, :])).reshape(Bt, nU)

    # sg[k, c, 2j + c'] = P[k - j] delta_cc' for j <= k (row k = knot k+1)
    idx = torch.arange(N, device=dev)
    d = idx[:, None] - idx[None, :]
    M = torch.where(d >= 0, P[:, d.clamp(0, N - 1)],
                    torch.zeros((), dtype=dtype, device=dev))      # (Bt, N, N)
    sg = (M[:, :, None, :, None] * eye2[:, None, :]).reshape(Bt, N, 2, nU)

    gN = torch.cat([
        (Pt[:, :, None, None] * eye2).permute(0, 2, 1, 3).reshape(Bt, 2, nU),
        (Vt[:, :, None, None] * eye2).permute(0, 2, 1, 3).reshape(Bt, 2, nU),
    ], dim=1)                                                    # (Bt, 4, nU)

    r = params.player_radius
    box = torch.tensor([params.arena_x / 2.0 - r, params.arena_y / 2.0 - r],
                       dtype=dtype, device=dev).repeat(N).expand(Bt, nU)
    lim = torch.full((Bt, nU), params.input_limit, dtype=dtype, device=dev)
    off = pos_free.reshape(Bt, nU)          # interleaved [x_1, y_1, ...]
    lo_fix = torch.cat([-lim, -box - off], dim=1)
    hi_fix = torch.cat([lim, box - off], dim=1)
    return SimpleNamespace(H=H, g=g, lo_fix=lo_fix, hi_fix=hi_fix, sg=sg,
                       p0p=pos_free, gN=gN, phiN_x0=phiN_x0, obs=obs,
                       x_des=x_des, h=h)


def dmpc_finish(U, prep, params, mpc):
    """Box projection and candidate cost (terminal + final time)."""
    om = _omega(mpc, U.dtype, U.device)
    U = U.clamp(-params.input_limit, params.input_limit)
    xN = prep.phiN_x0 + (prep.gN * U[:, None, :]).sum(-1)
    err = xN - prep.x_des
    cost = (err * om * err).sum(-1) + mpc.N * prep.h
    return U, cost


def dmpc_sqp(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, *,
                 N: int, n_obs: int, n_seg0: int = 4, it0: int = 37,
                 sqp_rest: int = 5, it_rest: int = 40, rho: float = 1.0,
                 sigma: float = 1e-6, alpha: float = 1.6, tol: float = 1e-3,
                 d2: float = 0.16):
    B, n1 = g.shape
    dtype, dev = g.dtype, g.device
    eye = torch.eye(n1, dtype=dtype, device=dev)
    sigma_t = torch.full((), sigma, dtype=dtype, device=dev)
    alpha_t = torch.full((), alpha, dtype=dtype, device=dev)
    one_m_alpha = 1 - alpha_t
    sgx, sgy = sg[:, :, 0, :], sg[:, :, 1, :]                 # (B, N, n1)
    gxx = (sgx * sgx).sum(-1)
    gxy = (sgx * sgy).sum(-1)
    gyy = (sgy * sgy).sum(-1)
    arena_norm = torch.cat([torch.sqrt(gxx), torch.sqrt(gyy)], dim=1)
    tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
    rho_s = torch.clamp(tr * (1.0 / n1), 1e-3, 1e6) * rho        # (B,)
    p0x, p0y = p0[..., 0], p0[..., 1]                            # (B, N)
    ox, oy = obs[..., 0:1], obs[..., 1:2]                        # (B, M, 1)
    big = torch.full((B, n_obs * N), 1e9, dtype=dtype, device=dev)

    def relinearize(x):
        """The scaled own rows at x: A (B, m_own, n1), lo, hi, d."""
        accx = p0x + _mv(sgx, x)
        accy = p0y + _mv(sgy, x)
        dx = accx[:, None] - ox                                  # (B, M, N)
        dy = accy[:, None] - oy
        ko_norm = 2.0 * torch.sqrt(dx * dx * gxx[:, None]
                                   + 2.0 * dx * dy * gxy[:, None]
                                   + dy * dy * gyy[:, None])
        gval = dx * dx + dy * dy - d2
        rhs = (2.0 * (dx * accx[:, None] + dy * accy[:, None]) - gval
               - 2.0 * (dx * p0x[:, None] + dy * p0y[:, None]))
        norm = torch.cat([arena_norm, ko_norm.reshape(B, -1)], dim=1)
        d = 1.0 / torch.clamp(norm, min=1e-8)
        lo = torch.cat([lo_arena, rhs.reshape(B, -1)], dim=1) * d
        hi = torch.cat([hi_arena, big], dim=1) * d
        ko = 2.0 * (dx[..., None] * sgx[:, None] + dy[..., None] * sgy[:, None])
        A = torch.cat([sgx, sgy, ko.reshape(B, -1, n1)], dim=1) * d[..., None]
        return A, lo, hi, d

    def segment(c, A, lo, hi, iters):
        x, zx, zo, yx, yo, rho_s = c
        r = rho_s[:, None]
        At = A.transpose(-1, -2)
        K = H + r[..., None] * (At @ A) + (sigma_t + rho_s)[:, None, None] * eye
        C = _tri_inv(K)
        Ct = C.transpose(-1, -2)
        for _ in range(iters):
            rhs = sigma_t * x - g + _mv(At, r * zo - yo) + (r * zx - yx)
            x = _mv(Ct, _mv(C, rhs))
            Ax = _mv(A, x)
            zx_t = alpha_t * x + one_m_alpha * zx
            zx_n = torch.minimum(torch.maximum(zx_t + yx / r, lx), ux)
            yx = yx + r * (zx_t - zx_n)
            zx = zx_n
            zo_t = alpha_t * Ax + one_m_alpha * zo
            zo_n = torch.minimum(torch.maximum(zo_t + yo / r, lo), hi)
            yo = yo + r * (zo_t - zo_n)
            zo = zo_n
        Ax = _mv(A, x)
        Hx = _mv(H, x)
        Aty = _mv(At, yo) + yx
        prim = _amax(x - zx, Ax - zo)
        dual = _amax(Hx + g + Aty)
        p_sc = torch.maximum(_amax(x, Ax), _amax(zx, zo)) + 1e-9
        d_sc = torch.maximum(_amax(Hx, Aty), _amax(g)) + 1e-9
        ratio = torch.sqrt((prim / p_sc) / (dual / d_sc + 1e-12))
        rho_s = torch.clamp(rho_s * torch.clamp(ratio, 0.2, 5.0), 1e-6, 1e8)
        return (x, zx, zo, yx, yo, rho_s), (prim, dual, p_sc, d_sc)

    A, lo, hi, d = relinearize(U0)
    zv = torch.zeros_like(g)
    zo0 = torch.zeros_like(lo)
    c = (zv, zv, zo0, zv, zo0, rho_s)
    for _ in range(n_seg0):
        c, res = segment(c, A, lo, hi, it0)
    for _ in range(sqp_rest):
        x, zx, _, yx, yo, rho_s = c
        A, lo, hi, d_new = relinearize(x)
        yo = yo * (d / d_new)
        d = d_new
        c, res = segment((x, zx, _mv(A, x), yx, yo, rho_s), A, lo, hi,
                         it_rest)
    prim, dual, p_sc, d_sc = res
    conv = (prim < tol * p_sc) & (dual < 10.0 * tol * d_sc)
    stats = torch.stack([conv.to(dtype), prim, dual, p_sc, d_sc], dim=1)
    return c[0], stats


# ---- CMPC (K4) ----

def joint_ax(A, x, m_own: int):
    """A x for the blocks A (B, 2, m1, n1) at x (B, 2 n1): rows [own 1 (m_own),
    own 2 (m_own), pair (m_pair)]; a pair row sums both players' parts."""
    n1 = A.shape[-1]
    f = _mv(A, x.reshape(-1, 2, n1))                       # (B, 2, m1)
    return torch.cat([f[:, 0, :m_own], f[:, 1, :m_own],
                      f[:, 0, m_own:] + f[:, 1, m_own:]], dim=1)


def joint_atw(A, w, m_own: int):
    """A'w (B, 2 n1) for a row vector w (B, 2 m_own + m_pair)."""
    wf = torch.stack([torch.cat([w[:, :m_own], w[:, 2 * m_own:]], 1),
                      torch.cat([w[:, m_own:2 * m_own], w[:, 2 * m_own:]], 1)],
                     dim=1)                                # (B, 2, m1)
    return _mv(A.transpose(-1, -2), wf).flatten(1)


def schur_factors(Hb, A, ro, rho_s, sigma_t, m_own: int):
    """The block-Schur factors (C1, W, Cs) of K for the blocks A, row
    penalties ro (B, R) and the box rows' rho_s (B,)."""
    n1 = A.shape[-1]
    eye = torch.eye(n1, dtype=A.dtype, device=A.device)
    rp = ro[:, 2 * m_own:]
    r1 = torch.cat([ro[:, :m_own], rp], dim=1)
    r2 = torch.cat([ro[:, m_own:2 * m_own], rp], dim=1)
    A1, A2 = A[:, 0], A[:, 1]
    diag = (sigma_t + rho_s)[:, None, None] * eye
    K11 = (A1.transpose(-1, -2) * r1[:, None, :]) @ A1 + Hb[:, 0] + diag
    C1 = _tri_inv(K11)
    K12 = (A1[:, m_own:].transpose(-1, -2) * rp[:, None, :]) @ A2[:, m_own:]
    W = C1 @ K12
    K22 = (A2.transpose(-1, -2) * r2[:, None, :]) @ A2 + Hb[:, 1] + diag
    Cs = _tri_inv(K22 - W.transpose(-1, -2) @ W)
    return C1, W, Cs


def schur_solve(C1, W, Cs, r):
    """x = K^-1 r through the factors of :func:`schur_factors`."""
    n1 = C1.shape[-1]
    Wt = W.transpose(-1, -2)
    t1 = _mv(C1, r[:, :n1])
    t2 = r[:, n1:] - _mv(Wt, t1)
    x2 = _mv(Cs.transpose(-1, -2), _mv(Cs, t2))
    x1 = _mv(C1.transpose(-1, -2), t1 - _mv(W, x2))
    return torch.cat([x1, x2], dim=1)


def joint_segment(c, Hb, g, A, lo, hi, lx, ux, is_eq, iters: int,
                  m_own: int, sigma_t, alpha_t, solver):
    """One adaptive-rho segment of the structured ADMM from the carry
    c = (x, zx, z, yx, y, rho_s): factor, ``iters`` iterations, residuals,
    the rho update.  Rows with ``is_eq`` take 1e3 rho (None: no equality
    rows).  ``solver`` is (factors, solve): K5's (:func:`linv_factors`,
    :func:`linv_solve`) or K4's (:func:`schur_factors`,
    :func:`schur_solve`).  Returns (carry, (prim, dual, p_sc, d_sc))."""
    x, zx, z, yx, y, rho_s = c
    r = rho_s[:, None]
    ro = r.expand_as(z) if is_eq is None else torch.where(is_eq, 1e3 * r, r)
    one_m_alpha = 1 - alpha_t
    factors, solve = solver
    F = factors(Hb, A, ro, rho_s, sigma_t, m_own)
    for _ in range(iters):
        rhs = sigma_t * x - g + joint_atw(A, ro * z - y, m_own) + \
            (r * zx - yx)
        x = solve(*F, rhs)
        ax = joint_ax(A, x, m_own)
        zx_t = alpha_t * x + one_m_alpha * zx
        zx_n = torch.minimum(torch.maximum(zx_t + yx / r, lx), ux)
        yx = yx + r * (zx_t - zx_n)
        zx = zx_n
        z_t = alpha_t * ax + one_m_alpha * z
        z_n = torch.minimum(torch.maximum(z_t + y / ro, lo), hi)
        y = y + ro * (z_t - z_n)
        z = z_n
    n1 = A.shape[-1]
    ax = joint_ax(A, x, m_own)
    Hx = _mv(Hb, x.reshape(-1, 2, n1)).flatten(1)
    Aty = joint_atw(A, y, m_own) + yx
    prim = _amax(x - zx, ax - z)
    dual = _amax(Hx + g + Aty)
    p_sc = torch.maximum(_amax(x, ax), _amax(zx, z)) + 1e-9
    d_sc = torch.maximum(_amax(Hx, Aty), _amax(g)) + 1e-9
    ratio = torch.sqrt((prim / p_sc) / (dual / d_sc + 1e-12))
    rho_s = torch.clamp(rho_s * torch.clamp(ratio, 0.2, 5.0), 1e-6, 1e8)
    return (x, zx, z, yx, y, rho_s), (prim, dual, p_sc, d_sc)


def joint_rho0(Hb, rho: float):
    """rho0 = clip(tr(H) / n, 1e-3, 1e6) rho over both blocks."""
    n2 = 2 * Hb.shape[-1]
    tr = Hb.diagonal(dim1=-2, dim2=-1).sum((-1, -2))
    return torch.clamp(tr * (1.0 / n2), 1e-3, 1e6) * rho


def joint_stats(res, tol: float):
    prim, dual, p_sc, d_sc = res
    conv = (prim < tol * p_sc) & (dual < 10.0 * tol * d_sc)
    return torch.stack([conv.to(prim.dtype), prim, dual, p_sc, d_sc], dim=1)


def cmpc_sqp(Hb, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, *,
                      N: int, n_obs: int, n_seg0: int = 4, it0: int = 37,
                      sqp_rest: int = 5, it_rest: int = 40, rho: float = 1.0,
                      sigma: float = 1e-6, alpha: float = 1.6,
                      tol: float = 1e-3, d2: float = 0.16):
    B, n2 = g.shape
    n1 = n2 // 2
    M = n_obs
    m_own = (2 + M) * N
    dtype, dev = g.dtype, g.device
    sigma_t = torch.full((), sigma, dtype=dtype, device=dev)
    alpha_t = torch.full((), alpha, dtype=dtype, device=dev)
    sgx, sgy = sg[:, :, :, 0], sg[:, :, :, 1]              # (B, 2, N, n1)
    gxx = (sgx * sgx).sum(-1)                              # (B, 2, N)
    gxy = (sgx * sgy).sum(-1)
    gyy = (sgy * sgy).sum(-1)
    arena_norm = torch.cat([torch.sqrt(gxx), torch.sqrt(gyy)], dim=2)
    sxx, sxy, syy = (a.sum(1) for a in (gxx, gxy, gyy))    # (B, N)
    p0x, p0y = p0[..., 0], p0[..., 1]                      # (B, 2, N)
    ox = obs[..., 0][:, None, :, None]                     # (B, 1, M, 1)
    oy = obs[..., 1][:, None, :, None]
    big = torch.full((B, 2, M * N), 1e9, dtype=dtype, device=dev)
    sign = torch.tensor([2.0, -2.0], dtype=dtype, device=dev)[None, :, None,
                                                              None]

    def relinearize(x):
        """The scaled rows at x: A (B, 2, m1, n1), lo, hi, d (B, R)."""
        xp = x.reshape(B, 2, n1)
        accx = p0x + _mv(sgx, xp)
        accy = p0y + _mv(sgy, xp)
        dpx = accx[:, 0] - accx[:, 1]                      # (B, N)
        dpy = accy[:, 0] - accy[:, 1]
        rnp = 2.0 * torch.sqrt(dpx * dpx * sxx + 2.0 * dpx * dpy * sxy
                               + dpy * dpy * syy)
        d_pr = 1.0 / torch.clamp(rnp, min=1e-8)
        gp = dpx * dpx + dpy * dpy - d2
        rhs_p = (2.0 * (dpx * accx[:, 0] + dpy * accy[:, 0] - dpx * accx[:, 1]
                        - dpy * accy[:, 1]) - gp
                 - 2.0 * (dpx * (p0x[:, 0] - p0x[:, 1])
                          + dpy * (p0y[:, 0] - p0y[:, 1])))
        dx = accx[:, :, None] - ox                         # (B, 2, M, N)
        dy = accy[:, :, None] - oy
        ko_norm = 2.0 * torch.sqrt(dx * dx * gxx[:, :, None]
                                   + 2.0 * dx * dy * gxy[:, :, None]
                                   + dy * dy * gyy[:, :, None])
        gval = dx * dx + dy * dy - d2
        rhs = (2.0 * (dx * accx[:, :, None] + dy * accy[:, :, None]) - gval
               - 2.0 * (dx * p0x[:, :, None] + dy * p0y[:, :, None]))
        d_o = 1.0 / torch.clamp(torch.cat([arena_norm, ko_norm.reshape(
            B, 2, M * N)], dim=2), min=1e-8)               # (B, 2, m_own)
        lo_o = torch.cat([lo_arena, rhs.reshape(B, 2, M * N)], dim=2) * d_o
        hi_o = torch.cat([hi_arena, big], dim=2) * d_o
        ko = 2.0 * (dx[..., None] * sgx[:, :, None] + dy[..., None]
                    * sgy[:, :, None])                     # (B, 2, M, N, n1)
        own = torch.cat([sgx, sgy, ko.reshape(B, 2, M * N, n1)], dim=2) \
            * d_o[..., None]
        pair = sign * (dpx[:, None, :, None] * sgx + dpy[:, None, :, None]
                       * sgy) * d_pr[:, None, :, None]
        A = torch.cat([own, pair], dim=2)
        lo = torch.cat([lo_o[:, 0], lo_o[:, 1], rhs_p * d_pr], dim=1)
        hi = torch.cat([hi_o[:, 0], hi_o[:, 1], 1e9 * d_pr], dim=1)
        d = torch.cat([d_o[:, 0], d_o[:, 1], d_pr], dim=1)
        return A, lo, hi, d

    def segment(c, A, lo, hi, iters):
        return joint_segment(c, Hb, g, A, lo, hi, lx, ux, None, iters, m_own,
                             sigma_t, alpha_t, (schur_factors, schur_solve))

    A, lo, hi, d = relinearize(U0)
    zv = torch.zeros_like(g)
    zr = torch.zeros_like(lo)
    c = (zv, zv, zr, zv, zr, joint_rho0(Hb, rho))
    res = None
    for _ in range(n_seg0):
        c, res = segment(c, A, lo, hi, it0)
    for _ in range(sqp_rest):
        x, zx, _, yx, y, rho_s = c
        A, lo, hi, d_new = relinearize(x)
        y = y * (d / d_new)
        d = d_new
        c, res = segment((x, zx, joint_ax(A, x, m_own), yx, y, rho_s), A,
                         lo, hi, it_rest)
    return c[0], joint_stats(res, tol)


def _perms(N: int, device):
    """The per-player permutation of the joint inputs and its inverse, and
    player 1's and player 2's column indices, on ``device``."""
    perm1 = (np.arange(N)[:, None] * 4 + np.array([0, 1])).reshape(-1)
    perm_j = np.concatenate([perm1, perm1 + 2])
    return tuple(torch.as_tensor(a, device=device) for a in (
        perm_j, np.argsort(perm_j), perm1, perm1 + 2))


def cmpc_prepare(h, x0, x_des, obs, params, mpc):
    """Closed-form equivalent of the program's dense condensing, permuted per player,
    restricted to what the fused route and :func:`cmpc_finish` read."""
    dtype, dev = x0.dtype, x0.device
    N = mpc.N
    n1 = 2 * N
    Bt = h.shape[0]
    P, V, sk, ek = _gains(h, params.tau_player, N, dtype)
    Pt, Vt = P.flip(-1), V.flip(-1)
    eye2 = torch.eye(2, dtype=dtype, device=dev)

    Hs = 2.0 * (mpc.w_pos * (Pt[:, :, None] * Pt[:, None, :]) +
                mpc.w_vel * (Vt[:, :, None] * Vt[:, None, :]))   # (Bt, N, N)
    H1 = (Hs[:, :, None, :, None] * eye2[:, None, :]).reshape(Bt, n1, n1) \
        + 2.0 * mpc.u_reg * torch.eye(n1, dtype=dtype, device=dev)

    p0c = torch.stack([x0[:, 0:2], x0[:, 4:6]], dim=1)            # (Bt, 2, 2)
    v0c = torch.stack([x0[:, 2:4], x0[:, 6:8]], dim=1)
    pos_free = p0c[:, :, None, :] + sk[:, None, :, None] * v0c[:, :, None, :]
    velN = ek[:, -1, None, None] * v0c
    phiN = torch.cat([pos_free[:, :, -1], velN], dim=2)           # (Bt, 2, 4)
    xdp = x_des.reshape(Bt, 2, 4)
    errp = pos_free[:, :, -1] - xdp[:, :, 0:2]
    errv = velN - xdp[:, :, 2:4]
    g = (2.0 * (mpc.w_pos * Pt[:, None, :, None] * errp[:, :, None, :] +
                mpc.w_vel * Vt[:, None, :, None] * errv[:, :, None, :])
         ).reshape(Bt, 2 * n1)

    # sg1[k, c, 2j + c'] = P[k - j] delta_cc' for j <= k
    idx = torch.arange(N, device=dev)
    d = idx[:, None] - idx[None, :]
    M = torch.where(d >= 0, P[:, d.clamp(0, N - 1)],
                    torch.zeros((), dtype=dtype, device=dev))     # (Bt, N, N)
    sg1 = (M[:, :, None, :, None] * eye2[:, None, :]).reshape(Bt, N, 2, n1)
    gN1 = torch.cat([
        (Pt[:, :, None, None] * eye2).permute(0, 2, 1, 3).reshape(Bt, 2, n1),
        (Vt[:, :, None, None] * eye2).permute(0, 2, 1, 3).reshape(Bt, 2, n1),
    ], dim=1)

    r = params.player_radius
    box = torch.tensor([params.arena_x / 2.0 - r, params.arena_y / 2.0 - r],
                       dtype=dtype, device=dev)
    rep = box.repeat_interleave(N)                     # [hx] * N + [hy] * N
    off = pos_free.transpose(2, 3).reshape(Bt, 2, n1)  # [x (N); y (N)]
    return SimpleNamespace(H1=H1, g=g, sg1=sg1, p0=pos_free, loa=-rep - off,
                           hia=rep - off, gN1=gN1, phiN=phiN, obs=obs,
                           x_des=x_des, h=h)


def cmpc_finish(Up, fp, params,
                  mpc):
    """The candidate cost on the per-player layout: Up (Bt, 2 n1)."""
    om = _omega(mpc, Up.dtype, Up.device)
    n1 = 2 * mpc.N
    Bt = Up.shape[0]
    Up = Up.clamp(-params.input_limit, params.input_limit)
    xN = fp.phiN + (fp.gN1[:, None] * Up.reshape(Bt, 2, 1, n1)).sum(-1)
    err = xN - fp.x_des.reshape(Bt, 2, 4)
    cost = (err * err * om).sum((-1, -2)) + mpc.N * fp.h
    return Up, cost


# ---- the teams ----

def select_play(puck, field: int, params,
                strat):
    """The reference team's play thresholds for pucks (B, 4): always
    OFFENSE under the reference constants (see the module docstring)."""
    px, vx = puck[:, 0], puck[:, 2]
    d1 = params.arena_x - strat.d_goalie_defense
    d2 = params.arena_x - strat.d_goalie_offense
    defense = (field * px > d1) | ((field * px > d2) &
                                   (field * vx > strat.v_thresh))
    return torch.where(defense, DEFENSE, OFFENSE).to(torch.int32)


def player_target(play, role: int, puck_pos, field: int, params,
                  strat):
    """DMPCPlayer's target state (B, 4) for plays (B,) and puck positions
    (B, 2)."""
    dtype, dev = puck_pos.dtype, puck_pos.device
    B = puck_pos.shape[0]
    gx = torch.full((B,), -field * params.arena_x / 2.0, dtype=dtype,
                    device=dev)
    zero = torch.zeros_like(gx)
    goal = torch.stack([gx, zero], dim=1)
    home = torch.stack([-gx, zero], dim=1)
    d = goal - puck_pos
    n = torch.sqrt((d * d).sum(-1, keepdim=True))
    hit = strat.v_hit * d / torch.where(n > 0, n, torch.ones_like(n))
    x_hit = torch.cat([puck_pos, hit], dim=1)
    x_hit2 = torch.cat([puck_pos, 2.0 * hit], dim=1)
    def_pos = home + (puck_pos - home) / 2.0
    x_home = torch.cat([def_pos, torch.zeros_like(def_pos)], dim=1)
    offense = (play == OFFENSE)[:, None]
    if role == ATTACKER:
        return torch.where(offense, x_hit, x_hit2)
    home_side = (field * puck_pos[:, 0] > 0)[:, None]
    return torch.where(offense, torch.where(home_side, x_home, x_hit), x_home)


def _dmpc_rows(field: int):
    """(attacker, defender, opponent 1, opponent 2) entity rows."""
    return (A1, A2, B1, B2) if field < 0 else (B1, B2, A1, A2)


def dmpc_team_inputs(x, field: int, params, strat):
    """Per game of x (B, 5, 4): both players' states (B, 2, 4), targets
    (B, 2, 4) and obstacle sets, the other three players' positions
    (B, 2, 3, 2); [attacker, defender] on axis 1."""
    a_row, d_row, o1, o2 = _dmpc_rows(field)
    puck = x[:, PUCK]
    play = select_play(puck, field, params, strat)
    tgt_a = player_target(play, ATTACKER, puck[:, 0:2], field, params, strat)
    tgt_d = player_target(play, DEFENDER, puck[:, 0:2], field, params, strat)
    pos = lambda r: x[:, r, 0:2]
    obs_a = torch.stack([pos(d_row), pos(o1), pos(o2)], dim=1)
    obs_d = torch.stack([pos(a_row), pos(o1), pos(o2)], dim=1)
    return (torch.stack([x[:, a_row], x[:, d_row]], dim=1),
            torch.stack([tgt_a, tgt_d], dim=1),
            torch.stack([obs_a, obs_d], dim=1))


def target_states(play, puck_pos, field: int, params,
                  v_hit: float = CMPC_V_HIT):
    """Attacker and defender target states (B, 4) each for plays (B,) and
    puck positions (B, 2)."""
    dtype, dev = puck_pos.dtype, puck_pos.device
    B = puck_pos.shape[0]
    gx = torch.full((B,), -field * params.arena_x / 2.0, dtype=dtype,
                    device=dev)
    zero = torch.zeros_like(gx)
    goal = torch.stack([gx, zero], dim=1)
    home = torch.stack([-gx, zero], dim=1)
    d = goal - puck_pos
    n = torch.sqrt((d * d).sum(-1, keepdim=True))
    hit = v_hit * d / torch.where(n > 0, n, torch.ones_like(n))
    x_attack_off = torch.cat([puck_pos, hit], dim=1)
    x_attack_def = torch.cat([puck_pos, 2.0 * hit], dim=1)
    offense = (play == OFFENSE)[:, None]
    x_attack = torch.where(offense, x_attack_off, x_attack_def)
    def_pos = home + (puck_pos - home) / 2.0
    x_def_home = torch.cat([def_pos, torch.zeros_like(def_pos)], dim=1)
    home_side = (field * puck_pos[:, 0] > 0)[:, None]
    x_defend = torch.where(offense, torch.where(home_side, x_def_home,
                                                x_attack_off), x_def_home)
    return x_attack, x_defend


def _cmpc_rows(field: int):
    """(attacker, defender, opponent 1, opponent 2) entity rows."""
    return (A1, A2, B1, B2) if field < 0 else (B1, B2, A1, A2)


def cmpc_team_inputs(x, play, field: int, params):
    """Per game of x (B, 5, 4) and plays (B,): the attacker's and the
    defender's states and targets (B, 4) each and the obstacles (B, 2, 2),
    the opponents' positions."""
    a_row, d_row, o1, o2 = _cmpc_rows(field)
    x_att, x_def = target_states(play, x[:, PUCK, 0:2], field, params)
    obstacles = torch.stack([x[:, o1, 0:2], x[:, o2, 0:2]], dim=1)
    return x[:, a_row], x[:, d_row], x_att, x_def, obstacles


# ---- the controls ----

def _schedule(mpc) -> dict:
    return dict(n_seg0=4, it0=max(1, mpc.qp_iters // 4),
                sqp_rest=mpc.sqp_iters - 1, it_rest=mpc.warm_qp_iters)


def _select(U, cost, conv, hs, U_prev, valid, h_prev):
    """The least-cost candidate (ties to the first): its solution, the new
    warm state (updated where the winner converged)."""
    k = torch.argmin(cost, dim=1)
    bi = torch.arange(k.shape[0], device=k.device)
    U_w, ok, h_w = U[bi, k], conv[bi, k], hs[bi, k]
    return U_w, (torch.where(ok[:, None], U_w, U_prev), ok | valid,
                 torch.where(ok, h_w, h_prev))


def dmpc_control(U_prev, valid, h_prev, x0, x_des, obstacles, params, mpc):
    """Bq single-agent DMPC instances: warm state U_prev (Bq, 2N), valid,
    h_prev (Bq,); x0, x_des (Bq, 4); obstacles (Bq, 3, 2).  Returns the
    first controls (Bq, 2) and the new warm state."""
    dtype, dev = x0.dtype, x0.device
    N, T = mpc.N, mpc.t_grid
    nU = 2 * N
    Bq = x0.shape[0]
    minT = params.dt * mpc.minT_frac / N
    maxT = 5.0 / N
    hs = candidate_steps(minT, maxT, T, mpc.t_local, h_prev, valid, dtype)
    U0 = torch.where(valid[:, None], U_prev,
                     torch.zeros((), dtype=dtype, device=dev))
    rep = lambda a: a.repeat_interleave(T, dim=0)
    prep = dmpc_prepare(hs.reshape(-1), rep(x0), rep(x_des),
                        rep(obstacles.reshape(Bq, 3, 2)), params, mpc)

    def xy_blocked(a):   # interleaved [x_1, y_1, ...] -> [x (N); y (N)]
        return a.reshape(-1, N, 2).transpose(1, 2).reshape(-1, nU)

    U, stats = dmpc_sqp(
        prep.H, prep.g, prep.sg, prep.p0p, prep.obs,
        xy_blocked(prep.lo_fix[:, nU:]), xy_blocked(prep.hi_fix[:, nU:]),
        prep.lo_fix[:, :nU], prep.hi_fix[:, :nU], rep(U0), N=N, n_obs=3,
        d2=float((2.0 * params.player_radius) ** 2), **_schedule(mpc))
    conv = stats[:, 0] > 0.5
    U, cost = dmpc_finish(U, prep, params, mpc)
    cost = torch.where(conv, cost, cost + 1e9)
    U_w, state = _select(U.reshape(Bq, T, nU), cost.reshape(Bq, T),
                         conv.reshape(Bq, T), hs, U_prev, valid, h_prev)
    return U_w[:, 0:2], state


def cmpc_control(U_prev, valid, h_prev, x0_p1, x0_p2, xf_p1, xf_p2,
                 obstacles, params, mpc):
    """Bq joint two-player CMPC instances: warm state U_prev (Bq, 4N)
    knot-major, valid, h_prev (Bq,); the players' states and targets
    (Bq, 4); obstacles (Bq, 2, 2).  Returns both players' first controls
    (Bq, 2) each and the new warm state."""
    dtype, dev = x0_p1.dtype, x0_p1.device
    N, T = mpc.N, mpc.t_grid
    nU, n1 = 4 * N, 2 * N
    Bq = x0_p1.shape[0]
    Bt = Bq * T
    x0 = torch.cat([x0_p1, x0_p2], dim=1)
    x_des = torch.cat([xf_p1, xf_p2], dim=1)
    minT, maxT = params.dt * mpc.minT_frac / (N + 1), 4.0 * params.dt
    hs = candidate_steps(minT, maxT, T, mpc.t_local, h_prev, valid, dtype)
    U0 = torch.where(valid[:, None], U_prev,
                     torch.zeros((), dtype=dtype, device=dev))
    rep = lambda a: a.repeat_interleave(T, dim=0)
    perm_j, inv_j, _, _ = _perms(N, dev)
    fp = cmpc_prepare(hs.reshape(-1), rep(x0), rep(x_des),
                      rep(obstacles.reshape(Bq, 2, 2)), params, mpc)
    two = lambda a: a[:, None].expand((Bt, 2) + a.shape[1:])
    lx = torch.full((Bt, 2 * n1), -params.input_limit, dtype=dtype,
                    device=dev)
    x, stats = cmpc_sqp(
        two(fp.H1), fp.g, two(fp.sg1), fp.p0, fp.obs, fp.loa, fp.hia, lx,
        -lx, rep(U0)[:, perm_j], N=N, n_obs=2,
        d2=float((2.0 * params.player_radius) ** 2), **_schedule(mpc))
    Up, cost = cmpc_finish(x, fp, params, mpc)
    conv = stats[:, 0] > 0.5
    cost = torch.where(conv, cost, cost + 1e9)
    U_w, state = _select(Up[:, inv_j].reshape(Bq, T, nU),
                         cost.reshape(Bq, T), conv.reshape(Bq, T), hs,
                         U_prev, valid, h_prev)
    return U_w[:, 0:2], U_w[:, 2:4], state


def matchup_policy(x, dmpc_state, cmpc_state, sp: dict, mpc: dict,
                   strat: dict, dtype=torch.float32):
    """One control step of the DMPC team A (field -1) against the CMPC team
    B (+1) for B games: x (B, 5, 4); dmpc_state (U (B, 2, 2N), valid
    (B, 2), h (B, 2)), [attacker, defender] on axis 1; cmpc_state (U
    (B, 4N), valid (B,), h (B,)).  Returns the controls (B, 4, 2) and both
    new warm states."""
    params, mpc, strat = (SimpleNamespace(**d) for d in (sp, mpc, strat))
    B = x.shape[0]
    x = x.to(dtype)
    with torch.inference_mode():
        x0s, tgts, obss = dmpc_team_inputs(x, -1, params, strat)
        U, valid, h = dmpc_state
        u_a, (Ud, vd, hd) = dmpc_control(
            U.to(dtype).flatten(0, 1), valid.flatten(0, 1),
            h.to(dtype).flatten(0, 1), x0s.flatten(0, 1), tgts.flatten(0, 1),
            obss.flatten(0, 1), params, mpc)
        play = torch.full((B,), OFFENSE, dtype=torch.int64, device=x.device)
        xa, xd, ta, td, obs = cmpc_team_inputs(x, play, 1, params)
        U, valid, h = cmpc_state
        u1, u2, cstate = cmpc_control(U.to(dtype), valid, h.to(dtype), xa, xd,
                                      ta, td, obs, params, mpc)
        u = torch.cat([u_a.reshape(B, 2, 2), torch.stack([u1, u2], dim=1)],
                      dim=1)
        dstate = (Ud.reshape(B, 2, -1), vd.reshape(B, 2), hd.reshape(B, 2))
        return u.clone(), tuple(a.clone() for a in dstate), \
            tuple(a.clone() for a in cstate)

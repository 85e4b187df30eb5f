"""Decentralized per-agent MPC (the reference's DMPC), batched.

Counterpart of the JAX package's ``control/dmpc.py``: each agent solves a
free-final-time SQP over N=20 knots against the other three players'
frozen positions (keepout rows, linearized per SQP iteration), with input
and arena boxes and a terminal cost to its target; the final time is a
parallel enumeration over ``t_grid`` candidate step sizes h, and the
agent takes the converged candidate of least cost.

:func:`compute_control_batch` flattens every instance's candidates into one
batch and solves them by one of three routes:

* ``"fused"`` (the default on every device): the whole SQP loop of every
  candidate in one call of :func:`..ops.sqp_lanes.solve_dmpc_sqp_lanes`
  (K3 on CUDA tensors, its plain version on CPU tensors), from the closed
  forms of :func:`_prepare_fused`;
* ``"lanes"``: ``sqp_iters`` calls of :func:`..ops.qp_lanes.solve_qp_lanes`
  (K2 on CUDA tensors) with the keepout rows relinearized between them;
* ``"plain"``: the same loop on :func:`..ops.qp.solve_qp`, CPU tensors only.

Tensors stay on their device and the per-step glue makes no host-device
copy (each would wait for the stream): the constant tables are made once
per device.  The glue products are elementwise sums or full-f32 matrix
products.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import MpcParams, SimParams, resolve_device
from ..models.lqsys import condense, exact_ab
from ..ops import qp_lanes, sqp_lanes
from ..ops.qp import solve_qp

N_NEIGHBORS = 3
ROUTES = ("fused", "lanes", "plain")


class DmpcState(NamedTuple):
    """Warm-start carry, one per agent (leading axes: the instances)."""
    U: torch.Tensor        # (..., 2N)
    valid: torch.Tensor    # (...) bool
    h: torch.Tensor        # (...) previous winner's per-knot time step


def initial_dmpc_state(mpc: MpcParams, dtype=torch.float32, device="cuda",
                       batch: tuple = ()) -> DmpcState:
    dev = resolve_device(device)
    return DmpcState(U=torch.zeros(batch + (2 * mpc.N,), dtype=dtype,
                                   device=dev),
                     valid=torch.zeros(batch, dtype=torch.bool, device=dev),
                     h=torch.zeros(batch, dtype=dtype, device=dev))


@functools.lru_cache(maxsize=32)
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


class QpPieces(NamedTuple):
    """Per-candidate condensed-QP data that does not depend on the SQP
    iterate, over a leading candidate axis."""
    H: torch.Tensor          # (Bt, nU, nU)
    g: torch.Tensor          # (Bt, nU)
    A_fix: torch.Tensor      # (Bt, nU + 2N, nU) input box + arena rows
    lo_fix: torch.Tensor
    hi_fix: torch.Tensor
    sg: torch.Tensor         # (Bt, N, 2, nU) position rows of Gamma
    p0p: torch.Tensor        # (Bt, N, 2) free-response positions
    phi_x0: torch.Tensor     # (Bt, 4N)
    gam: torch.Tensor        # (Bt, 4N, nU)
    gN: torch.Tensor         # (Bt, 4, nU)
    phiN_x0: torch.Tensor    # (Bt, 4)
    obs: torch.Tensor        # (Bt, 3, 2)
    x_des: torch.Tensor      # (Bt, 4)
    h: torch.Tensor          # (Bt,)


class FusedPieces(NamedTuple):
    """The fields of :class:`QpPieces` that the fused route and
    :func:`_finish` read, built from closed forms by
    :func:`_prepare_fused`."""
    H: torch.Tensor
    g: torch.Tensor
    lo_fix: torch.Tensor
    hi_fix: torch.Tensor
    sg: torch.Tensor
    p0p: torch.Tensor
    gN: torch.Tensor
    phiN_x0: torch.Tensor
    obs: torch.Tensor
    x_des: torch.Tensor
    h: torch.Tensor


@functools.lru_cache(maxsize=32)
def _consts(params: SimParams, mpc: MpcParams, dtype, device):
    """The arena box shrunk by the player radius, interleaved [x, y] per
    knot (2N,), and the terminal weights diag(Omega) (4,), on ``device``,
    made once."""
    r = params.player_radius
    box = torch.tensor([params.arena_x / 2.0 - r, params.arena_y / 2.0 - r],
                       dtype=dtype).repeat(mpc.N)
    om = torch.tensor([mpc.w_pos, mpc.w_pos, mpc.w_vel, mpc.w_vel],
                      dtype=dtype)
    return box.to(device), om.to(device)


def _box(params: SimParams, mpc: MpcParams, Bt: int, dtype, dev):
    """The arena box and the input limit as (Bt, 2N) tensors."""
    box = _consts(params, mpc, dtype, dev)[0].expand(Bt, 2 * mpc.N)
    lim = torch.full((Bt, 2 * mpc.N), params.input_limit, dtype=dtype,
                     device=dev)
    return box, lim


def _prepare(h, x0, x_des, obs, params: SimParams, mpc: MpcParams):
    """The condensed QP of each candidate: h (Bt,), x0 and x_des (Bt, 4),
    obs (Bt, 3, 2)."""
    dtype, dev = x0.dtype, x0.device
    N = mpc.N
    nU = 2 * N
    Bt = h.shape[0]
    A, B = exact_ab(h, params.tau_player, dtype)
    phi, gam = condense(A, B, N)                     # (Bt, 4N, 4), (.., nU)
    om = _consts(params, mpc, dtype, dev)[1]
    gN = gam[:, 4 * (N - 1):4 * N]                   # (Bt, 4, nU)
    phiN_x0 = (phi[:, 4 * (N - 1):4 * N] @ x0[..., None])[..., 0]
    gNt = gN.transpose(1, 2)
    eye = torch.eye(nU, dtype=dtype, device=dev)
    H = 2.0 * ((gNt * om) @ gN + mpc.u_reg * eye)
    g = 2.0 * ((gNt * om) @ (phiN_x0 - x_des)[..., None])[..., 0]

    def pos_rows(M):       # rows 4k + {0, 1} of the stacked state
        return M.reshape(Bt, N, 4, -1)[:, :, 0:2].reshape(Bt, 2 * N, -1)

    phi_x0 = (phi @ x0[..., None])[..., 0]           # (Bt, 4N)
    sel_gam = pos_rows(gam)
    off = pos_rows(phi_x0[..., None])[..., 0]
    box, lim = _box(params, mpc, Bt, dtype, dev)
    A_fix = torch.cat([eye.expand(Bt, nU, nU), sel_gam], dim=1)
    lo_fix = torch.cat([-lim, -box - off], dim=1)
    hi_fix = torch.cat([lim, box - off], dim=1)
    return QpPieces(H=H, g=g, A_fix=A_fix, lo_fix=lo_fix, hi_fix=hi_fix,
                    sg=sel_gam.reshape(Bt, N, 2, nU),
                    p0p=off.reshape(Bt, N, 2), phi_x0=phi_x0, gam=gam, gN=gN,
                    phiN_x0=phiN_x0, obs=obs, x_des=x_des, h=h)


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


def _prepare_fused(h, x0, x_des, obs, params: SimParams, mpc: MpcParams):
    """Closed-form equivalent of :func:`_prepare` restricted to the fields
    the fused route and :func:`_finish` read."""
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

    box, lim = _box(params, mpc, Bt, dtype, dev)
    off = pos_free.reshape(Bt, nU)          # interleaved [x_1, y_1, ...]
    lo_fix = torch.cat([-lim, -box - off], dim=1)
    hi_fix = torch.cat([lim, box - off], dim=1)
    return FusedPieces(H=H, g=g, lo_fix=lo_fix, hi_fix=hi_fix, sg=sg,
                       p0p=pos_free, gN=gN, phiN_x0=phiN_x0, obs=obs,
                       x_des=x_des, h=h)


def _keepout(U, prep: QpPieces, params: SimParams, mpc: MpcParams):
    """Linearized keepout rows (Bt, 3N, nU) and their lower bounds
    (Bt, 3N) against the other 3 players' frozen positions at the SQP
    iterate U (Bt, nU)."""
    N = mpc.N
    nU = 2 * N
    Bt = U.shape[0]
    d2 = (2.0 * params.player_radius) ** 2
    p_bar = (prep.phi_x0 + (prep.gam * U[:, None, :]).sum(-1)).reshape(
        Bt, N, 4)[:, :, 0:2]
    diff = p_bar[:, None] - prep.obs[:, :, None]            # (Bt, 3, N, 2)
    gval = (diff * diff).sum(-1) - d2
    rows = 2.0 * (diff[..., None] * prep.sg[:, None]).sum(-2)  # (Bt,3,N,nU)
    rhs = (2.0 * (diff * p_bar[:, None]).sum(-1) - gval -
           2.0 * (diff * prep.p0p[:, None]).sum(-1))
    return rows.reshape(Bt, -1, nU), rhs.reshape(Bt, -1)


def _finish(U, prep, params: SimParams, mpc: MpcParams):
    """Box projection and candidate cost (terminal + final time)."""
    om = _consts(params, mpc, U.dtype, U.device)[1]
    U = U.clamp(-params.input_limit, params.input_limit)
    xN = prep.phiN_x0 + (prep.gN * U[:, None, :]).sum(-1)
    err = xN - prep.x_des
    cost = (err * om * err).sum(-1) + mpc.N * prep.h
    return U, cost


class Candidates(NamedTuple):
    """Every candidate of :func:`compute_control_batch` (Bq instances x
    t_grid): its step size, solution (clipped), cost (+1e9 where the solve
    did not converge) and flag; for the fused route also the flag's margin
    max(prim / (tol p_sc), dual / (10 tol d_sc)) (< 1 where converged)."""
    h: torch.Tensor          # (Bq, T)
    U: torch.Tensor          # (Bq, T, nU)
    cost: torch.Tensor       # (Bq, T)
    conv: torch.Tensor       # (Bq, T) bool
    margin: torch.Tensor | None


def candidates(state: DmpcState, x0, x_des, obstacles, params: SimParams,
               mpc: MpcParams, route: str = "fused") -> Candidates:
    """Solve every candidate of Bq instances (state leaves (Bq, ...), x0
    and x_des (Bq, 4), obstacles (Bq, 3, 2)) by ``route``: the step sizes
    of :func:`candidate_steps`, each candidate started from the previous
    winner's U where the state is valid."""
    dtype = x0.dtype
    minT = params.dt * mpc.minT_frac / mpc.N
    maxT = 5.0 / mpc.N
    hs = candidate_steps(minT, maxT, mpc.t_grid, mpc.t_local, state.h,
                         state.valid, dtype)
    U0 = torch.where(state.valid[:, None], state.U,
                     torch.zeros((), dtype=dtype, device=x0.device))
    return solve_candidates(hs, U0, x0, x_des, obstacles, params, mpc,
                            route)


def solve_candidates(hs, U0, x0, x_des, obstacles, params: SimParams,
                     mpc: MpcParams, route: str = "fused") -> Candidates:
    """Solve the candidates of Bq instances over given step sizes ``hs``
    (Bq, T), each started from ``U0`` (Bq, nU), with x0 and x_des (Bq, 4)
    and obstacles (Bq, 3, 2), by ``route`` (the JAX package's
    ``_solve_candidate``, batched)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "plain" and x0.is_cuda:
        raise ValueError("route='plain' runs on CPU tensors only; use "
                         "'fused' (K3) or 'lanes' (K2) on the card")
    dtype = x0.dtype
    Bq, T = hs.shape
    N = mpc.N
    nU = 2 * N
    obs = obstacles.to(dtype).reshape(Bq, N_NEIGHBORS, 2)

    def rep(a):
        return a.repeat_interleave(T, dim=0)

    prep_fn = _prepare_fused if route == "fused" else _prepare
    prep = prep_fn(hs.reshape(-1), rep(x0.to(dtype)), rep(x_des.to(dtype)),
                   rep(obs), params, mpc)
    U = rep(U0.to(dtype))
    margin = None

    if route == "fused":
        def xy_blocked(a):   # interleaved [x_1, y_1, ...] -> [x (N); y (N)]
            return a.reshape(-1, N, 2).transpose(1, 2).reshape(-1, nU)

        U, stats = sqp_lanes.dmpc_sqp_stats(
            prep.H, prep.g, prep.sg, prep.p0p, prep.obs,
            xy_blocked(prep.lo_fix[:, nU:]), xy_blocked(prep.hi_fix[:, nU:]),
            prep.lo_fix[:, :nU], prep.hi_fix[:, :nU], U, N=N,
            n_obs=N_NEIGHBORS, n_seg0=4, it0=max(1, mpc.qp_iters // 4),
            sqp_rest=mpc.sqp_iters - 1, it_rest=mpc.warm_qp_iters,
            d2=float((2.0 * params.player_radius) ** 2))
        U = U.to(dtype)
        conv = stats[:, 0] > 0.5
        margin = sqp_lanes.flag_margin(stats).reshape(Bq, T)
    else:
        big = torch.full((Bq * T, N_NEIGHBORS * N), 1e9, dtype=dtype,
                         device=x0.device)
        solve = qp_lanes.solve_qp_lanes if route == "lanes" else solve_qp
        for _ in range(mpc.sqp_iters):
            rows, rhs = _keepout(U, prep, params, mpc)
            A_all = torch.cat([prep.A_fix, rows], dim=1)
            lo = torch.cat([prep.lo_fix, rhs], dim=1)
            hi = torch.cat([prep.hi_fix, big], dim=1)
            sol = solve(prep.H, prep.g, A_all, lo, hi, iters=mpc.qp_iters,
                        scale_rows=True)
            U, conv = sol.x.to(dtype), sol.converged

    U, costs = _finish(U, prep, params, mpc)
    costs = torch.where(conv, costs, costs + 1e9)
    return Candidates(h=hs, U=U.reshape(Bq, T, nU), cost=costs.reshape(Bq, T),
                      conv=conv.reshape(Bq, T), margin=margin)


def runner_up_gap(c: Candidates):
    """(Bq,) how far the best cost lies below the best cost of a candidate
    with another step size: where it is small, f32 roundoff may pick the
    other candidate.  (A warm grid may hold one step size twice; such
    copies tie exactly and the argmin takes the first on every route.)"""
    best = c.cost.min(dim=1, keepdim=True)
    h_w = c.h.gather(1, c.cost.argmin(dim=1, keepdim=True))
    other = torch.where(c.h == h_w, torch.full_like(c.cost, float("inf")),
                        c.cost)
    return (other.min(dim=1, keepdim=True).values - best.values)[:, 0]


def select(state: DmpcState, c: Candidates):
    """The least-cost candidate of each instance (ties to the first): the
    new state (updated only where the winner converged) and the first
    control (Bq, 2)."""
    k = torch.argmin(c.cost, dim=1)
    bi = torch.arange(k.shape[0], device=k.device)
    U_w = c.U[bi, k]
    ok = c.conv[bi, k]
    h_w = c.h[bi, k]
    new_state = DmpcState(U=torch.where(ok[:, None], U_w, state.U),
                          valid=ok | state.valid,
                          h=torch.where(ok, h_w, state.h))
    return new_state, U_w[:, 0:2]


def compute_control_batch(state: DmpcState, x0, x_des, obstacles,
                          params: SimParams, mpc: MpcParams,
                          route: str = "fused"):
    """Batched DMPC control: every argument carries a leading instance axis
    Bq (e.g. games x agents); all Bq x t_grid candidates solve in one K3
    launch on the fused route.  Returns (new state, u (Bq, 2))."""
    return select(state, candidates(state, x0, x_des, obstacles, params, mpc,
                                    route))


def compute_control(state: DmpcState, x0, x_des, obstacles,
                    params: SimParams, mpc: MpcParams):
    """One agent (the reference's DMPC.compute_control): state leaves
    unbatched, x0 and x_des (4,), obstacles (3, 2), on one device.  Each
    SQP iteration is a cold QP solve per candidate, as in the JAX
    package's per-agent function: on K2 on the card, on the plain solver
    on the CPU.  Returns (new state, u (2,))."""
    route = "lanes" if x0.is_cuda else "plain"
    st = DmpcState(*(a[None] for a in state))
    new, u = compute_control_batch(st, x0[None], x_des[None],
                                   obstacles[None], params, mpc, route)
    return DmpcState(*(a[0] for a in new)), u[0]

"""Centralized two-player MPC (the reference's CentralizedMPC), batched.

Counterpart of the JAX package's ``control/cmpc.py``: one team's two
players solve one joint free-final-time SQP over N=20 knots (8 states, 4
inputs), with both players' input and arena boxes, keepout rows of each
player against the two opponents (frozen positions) and the pairwise
keepout between the two players, all linearized per SQP iteration, and a
terminal cost to both targets.  The final time is a parallel enumeration
over ``t_grid`` candidate step sizes h; the team takes the converged
candidate of least cost (terminal cost + N h).

:func:`compute_control_batch` flattens every instance's candidates into one
batch and solves them by one of four routes:

* ``"fused"`` (the default on every device): the whole SQP loop of every
  candidate in one call of :func:`..ops.sqp_lanes.solve_cmpc_sqp_lanes`
  (K4 on CUDA tensors, its plain version on CPU tensors), from the
  per-player closed forms of :func:`_prepare_fused`;
* ``"joint"``: ``sqp_iters`` calls of
  :func:`..ops.qp_lanes.solve_qp_lanes_joint` (K5 on CUDA tensors) on the
  per-player blocks, the keepout rows relinearized between them;
* ``"lanes"``: the same loop on the dense joint problem through
  :func:`..ops.qp_lanes.solve_qp_lanes` (K2), which takes n <= 64 and
  m <= 256 only (N <= 16 here), as JAX's route serves only small horizons;
* ``"plain"``: the same loop on :func:`..ops.qp.solve_qp`, CPU tensors
  only (the JAX package's XLA route).

The fused and joint routes work in the per-player permuted variable order
(``perm_j``: player 1's inputs [u1x, u1y] per knot, then player 2's); the
public U is the reference's knot-major [u1x, u1y, u2x, u2y] per knot.
Tensors stay on their device and the per-step glue makes no host-device
copy.
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
from .dmpc import Candidates, _gains, candidate_steps

N_OBS = 2      # obstacles: the two opposing players
ROUTES = ("fused", "joint", "lanes", "plain")


class CmpcState(NamedTuple):
    """Warm-start carry, one per team (leading axes: the instances)."""
    U: torch.Tensor        # (..., 4N) previous solution, knot-major
    valid: torch.Tensor    # (...) bool
    h: torch.Tensor        # (...) previous winner's per-knot time step


def initial_cmpc_state(mpc: MpcParams, dtype=torch.float32, device="cuda",
                       batch: tuple = ()) -> CmpcState:
    dev = resolve_device(device)
    return CmpcState(U=torch.zeros(batch + (4 * mpc.N,), dtype=dtype,
                                   device=dev),
                     valid=torch.zeros(batch, dtype=torch.bool, device=dev),
                     h=torch.zeros(batch, dtype=dtype, device=dev))


def _joint_ab(h, params: SimParams, dtype):
    """Both players' exact-ZOH models side by side: (..., 8, 8) and
    (..., 8, 4)."""
    A, B = exact_ab(h, params.tau_player, dtype)
    lead = A.shape[:-2]
    Aj = torch.zeros(lead + (8, 8), dtype=dtype, device=A.device)
    Bj = torch.zeros(lead + (8, 4), dtype=dtype, device=A.device)
    Aj[..., :4, :4] = A
    Aj[..., 4:, 4:] = A
    Bj[..., :4, :2] = B
    Bj[..., 4:, 2:] = B
    return Aj, Bj


def _pos_rows(M, N: int, lo: int):
    """Rows 8k + lo .. 8k + lo + 1 of a stacked (Bt, 8N, ...) tensor: one
    player's knot positions, (Bt, 2N, ...)."""
    Bt = M.shape[0]
    tail = M.shape[2:]
    return M.reshape((Bt, N, 8) + tail)[:, :, lo:lo + 2].reshape(
        (Bt, 2 * N) + tail)


@functools.lru_cache(maxsize=32)
def _perms(N: int, device):
    """The per-player permutation of the joint inputs and its inverse, and
    player 1's and player 2's column indices, on ``device``."""
    perm1 = (np.arange(N)[:, None] * 4 + np.array([0, 1])).reshape(-1)
    perm_j = np.concatenate([perm1, perm1 + 2])
    return tuple(torch.as_tensor(a, device=device) for a in (
        perm_j, np.argsort(perm_j), perm1, perm1 + 2))


@functools.lru_cache(maxsize=32)
def _consts(params: SimParams, mpc: MpcParams, dtype, device):
    """The arena box shrunk by the player radius ([hx, hy]) and the terminal
    weights diag(Omega) of one player (4,), on ``device``, made once."""
    r = params.player_radius
    box = torch.tensor([params.arena_x / 2.0 - r, params.arena_y / 2.0 - r],
                       dtype=dtype)
    om = torch.tensor([mpc.w_pos, mpc.w_pos, mpc.w_vel, mpc.w_vel],
                      dtype=dtype)
    return box.to(device), om.to(device)


class CmpcPieces(NamedTuple):
    """Per-candidate joint-QP data independent of the SQP iterate, over a
    leading candidate axis (the reference's knot-major variables)."""
    H: torch.Tensor          # (Bt, nU, nU)
    g: torch.Tensor          # (Bt, nU)
    A_fix: torch.Tensor      # (Bt, nU + 4N, nU) input box + both arenas
    lo_fix: torch.Tensor
    hi_fix: torch.Tensor
    sg1: torch.Tensor        # (Bt, N, 2, nU) player 1's position rows
    sg2: torch.Tensor
    p0_1: torch.Tensor       # (Bt, N, 2) free-response positions
    p0_2: torch.Tensor
    phi_x0: torch.Tensor     # (Bt, 8N)
    gam: torch.Tensor        # (Bt, 8N, nU)
    gN: torch.Tensor         # (Bt, 8, nU)
    phiN_x0: torch.Tensor    # (Bt, 8)
    obs: torch.Tensor        # (Bt, 2, 2)
    x_des: torch.Tensor      # (Bt, 8)
    h: torch.Tensor          # (Bt,)


def _prepare(h, x0, x_des, obs, params: SimParams, mpc: MpcParams):
    """The condensed joint QP of each candidate: h (Bt,), x0 and x_des
    (Bt, 8), obs (Bt, 2, 2)."""
    dtype, dev = x0.dtype, x0.device
    N = mpc.N
    nU = 4 * N
    Bt = h.shape[0]
    Aj, Bj = _joint_ab(h, params, dtype)
    phi, gam = condense(Aj, Bj, N)                  # (Bt, 8N, 8), (.., nU)
    box, om1 = _consts(params, mpc, dtype, dev)
    om = om1.repeat(2)
    gN = gam[:, 8 * (N - 1):8 * N]                  # (Bt, 8, nU)
    phiN_x0 = (phi[:, 8 * (N - 1):8 * N] @ x0[..., None])[..., 0]
    gNt = gN.transpose(1, 2)
    eye = torch.eye(nU, dtype=dtype, device=dev)
    H = 2.0 * ((gNt * om) @ gN + mpc.u_reg * eye)
    g = 2.0 * ((gNt * om) @ (phiN_x0 - x_des)[..., None])[..., 0]

    phi_x0 = (phi @ x0[..., None])[..., 0]          # (Bt, 8N)
    lim = params.input_limit
    boxN = box.repeat(N)                            # [hx, hy] per knot
    rows1, rows2 = _pos_rows(gam, N, 0), _pos_rows(gam, N, 4)
    off1 = _pos_rows(phi_x0[..., None], N, 0)[..., 0]
    off2 = _pos_rows(phi_x0[..., None], N, 4)[..., 0]
    A_fix = torch.cat([eye.expand(Bt, nU, nU), rows1, rows2], dim=1)
    limv = torch.full((Bt, nU), lim, dtype=dtype, device=dev)
    lo_fix = torch.cat([-limv, -boxN - off1, -boxN - off2], dim=1)
    hi_fix = torch.cat([limv, boxN - off1, boxN - off2], dim=1)
    return CmpcPieces(
        H=H, g=g, A_fix=A_fix, lo_fix=lo_fix, hi_fix=hi_fix,
        sg1=rows1.reshape(Bt, N, 2, nU), sg2=rows2.reshape(Bt, N, 2, nU),
        p0_1=off1.reshape(Bt, N, 2), p0_2=off2.reshape(Bt, N, 2),
        phi_x0=phi_x0, gam=gam, gN=gN, phiN_x0=phiN_x0, obs=obs,
        x_des=x_des, h=h)


class CmpcFusedPieces(NamedTuple):
    """Per-player closed-form QP data of the fused route, already in the
    kernel's per-player permuted layouts: both players share h and tau, so
    the Hessian block, the position sensitivities and the terminal rows
    are one per candidate."""
    H1: torch.Tensor      # (Bt, n1, n1) the shared per-player Hessian block
    g: torch.Tensor       # (Bt, 2 n1) [player 1; player 2]
    sg1: torch.Tensor     # (Bt, N, 2, n1) the shared position sensitivity
    p0: torch.Tensor      # (Bt, 2, N, 2) free-response positions per player
    loa: torch.Tensor     # (Bt, 2, 2N) arena bounds, [x (N); y (N)] each
    hia: torch.Tensor
    gN1: torch.Tensor     # (Bt, 4, n1) the shared terminal rows
    phiN: torch.Tensor    # (Bt, 2, 4) per-player free terminal state
    obs: torch.Tensor     # (Bt, 2, 2)
    x_des: torch.Tensor   # (Bt, 8)
    h: torch.Tensor       # (Bt,)


def _prepare_fused(h, x0, x_des, obs, params: SimParams, mpc: MpcParams):
    """Closed-form equivalent of :func:`_prepare`, permuted per player,
    restricted to what the fused route and :func:`_finish_fused` read."""
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

    box = _consts(params, mpc, dtype, dev)[0]
    rep = box.repeat_interleave(N)                     # [hx] * N + [hy] * N
    off = pos_free.transpose(2, 3).reshape(Bt, 2, n1)  # [x (N); y (N)]
    return CmpcFusedPieces(H1=H1, g=g, sg1=sg1, p0=pos_free, loa=-rep - off,
                           hia=rep - off, gN1=gN1, phiN=phiN, obs=obs,
                           x_des=x_des, h=h)


def _finish_fused(Up, fp: CmpcFusedPieces, params: SimParams,
                  mpc: MpcParams):
    """:func:`_finish` on the per-player layout: Up (Bt, 2 n1)."""
    om = _consts(params, mpc, Up.dtype, Up.device)[1]
    n1 = 2 * mpc.N
    Bt = Up.shape[0]
    Up = Up.clamp(-params.input_limit, params.input_limit)
    xN = fp.phiN + (fp.gN1[:, None] * Up.reshape(Bt, 2, 1, n1)).sum(-1)
    err = xN - fp.x_des.reshape(Bt, 2, 4)
    cost = (err * err * om).sum((-1, -2)) + mpc.N * fp.h
    return Up, cost


def _keepout_pieces(U, prep: CmpcPieces, params: SimParams,
                    mpc: MpcParams):
    """Keepout rows of both players against the obstacles and the pairwise
    row, linearized at U (Bt, nU), as per-player pieces: (r1, b1, r2, b2,
    rows_pair, rhs_pair), r (Bt, 2N, nU), b (Bt, 2N), pair (Bt, N, nU)
    and (Bt, N)."""
    N = mpc.N
    nU = 4 * N
    Bt = U.shape[0]
    d2 = (2.0 * params.player_radius) ** 2
    X = (prep.phi_x0 + (prep.gam * U[:, None, :]).sum(-1)).reshape(Bt, N, 8)
    p1, p2 = X[:, :, 0:2], X[:, :, 4:6]

    def keepout(p_bar, sg, p0p):
        diff = p_bar[:, None] - prep.obs[:, :, None]         # (Bt, M, N, 2)
        gval = (diff * diff).sum(-1) - d2
        rows = 2.0 * (diff[..., None] * sg[:, None]).sum(-2)
        rhs = (2.0 * (diff * p_bar[:, None]).sum(-1) - gval -
               2.0 * (diff * p0p[:, None]).sum(-1))
        return rows.reshape(Bt, -1, nU), rhs.reshape(Bt, -1)

    r1, b1 = keepout(p1, prep.sg1, prep.p0_1)
    r2, b2 = keepout(p2, prep.sg2, prep.p0_2)
    diffp = p1 - p2                                           # |p1 - p2| >= 2r
    gp = (diffp * diffp).sum(-1) - d2
    rowsp = 2.0 * (diffp[..., None] * (prep.sg1 - prep.sg2)).sum(-2)
    rhsp = (2.0 * (diffp * (p1 - p2)).sum(-1) - gp -
            2.0 * (diffp * (prep.p0_1 - prep.p0_2)).sum(-1))
    return r1, b1, r2, b2, rowsp, rhsp


def _keepout_all(U, prep: CmpcPieces, params: SimParams, mpc: MpcParams):
    """Dense assembly of :func:`_keepout_pieces` (the dense routes)."""
    r1, b1, r2, b2, rowsp, rhsp = _keepout_pieces(U, prep, params, mpc)
    return torch.cat([r1, r2, rowsp], dim=1), torch.cat([b1, b2, rhsp], dim=1)


def _finish(U, prep: CmpcPieces, params: SimParams, mpc: MpcParams):
    """Box projection and candidate cost (terminal + final time)."""
    om = _consts(params, mpc, U.dtype, U.device)[1].repeat(2)
    U = U.clamp(-params.input_limit, params.input_limit)
    xN = prep.phiN_x0 + (prep.gN * U[:, None, :]).sum(-1)
    err = xN - prep.x_des
    cost = (err * om * err).sum(-1) + mpc.N * prep.h
    return U, cost


def _grid(params: SimParams, mpc: MpcParams):
    """The candidate grid's bounds: [dt minT_frac / (N + 1), 4 dt]."""
    return params.dt * mpc.minT_frac / (mpc.N + 1), 4.0 * params.dt


def candidates(state: CmpcState, x0_p1, x0_p2, xf_p1, xf_p2, obstacles,
               params: SimParams, mpc: MpcParams,
               route: str = "fused") -> Candidates:
    """Solve every candidate of Bq instances (state leaves (Bq, ...), the
    players' states and targets (Bq, 4), obstacles (Bq, 2, 2)) by
    ``route``.  U is knot-major; the fused and joint routes also give the
    flags' margins."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    N = mpc.N
    nU = 4 * N
    n1 = 2 * N
    if route == "plain" and x0_p1.is_cuda:
        raise ValueError("route='plain' runs on CPU tensors only; use "
                         "'fused' (K4) or 'joint' (K5) on the card")
    m_dense = 2 * nU + 2 * N_OBS * N + N
    if route == "lanes" and not (nU <= qp_lanes.MAX_N and
                                 m_dense <= qp_lanes.MAX_M):
        raise ValueError(f"route='lanes' (K2) supports n <= {qp_lanes.MAX_N} "
                         f"and m <= {qp_lanes.MAX_M}, got n={nU}, "
                         f"m={m_dense} (N={N}); use 'fused' or 'joint'")
    dtype, dev = x0_p1.dtype, x0_p1.device
    Bq = x0_p1.shape[0]
    T = mpc.t_grid
    x0 = torch.cat([x0_p1, x0_p2], dim=1).to(dtype)
    x_des = torch.cat([xf_p1, xf_p2], dim=1).to(dtype)
    obs = obstacles.to(dtype).reshape(Bq, N_OBS, 2)
    minT, maxT = _grid(params, mpc)
    hs = candidate_steps(minT, maxT, T, mpc.t_local, state.h, state.valid,
                         dtype)

    def rep(a):
        return a.repeat_interleave(T, dim=0)

    U0 = torch.where(state.valid[:, None], state.U,
                     torch.zeros((), dtype=dtype, device=dev)).to(dtype)
    U = rep(U0)
    Bt = Bq * T
    perm_j, inv_j, perm1, perm2 = _perms(N, dev)
    d2 = float((2.0 * params.player_radius) ** 2)
    margin = None

    if route == "fused":
        fp = _prepare_fused(hs.reshape(-1), rep(x0), rep(x_des), rep(obs),
                            params, mpc)

        def two(a):
            return a[:, None].expand((Bt, 2) + a.shape[1:])

        lx = torch.full((Bt, 2 * n1), -params.input_limit, dtype=dtype,
                        device=dev)
        x, stats = sqp_lanes.cmpc_sqp_stats(
            two(fp.H1), fp.g, two(fp.sg1), fp.p0, fp.obs, fp.loa, fp.hia, lx,
            -lx, U[:, perm_j], N=N, n_obs=N_OBS, n_seg0=4,
            it0=max(1, mpc.qp_iters // 4), sqp_rest=mpc.sqp_iters - 1,
            it_rest=mpc.warm_qp_iters, d2=d2)
        Up, costs = _finish_fused(x.to(dtype), fp, params, mpc)
        U = Up[:, inv_j]
        conv = stats[:, 0] > 0.5
        margin = sqp_lanes.flag_margin(stats).reshape(Bq, T)
    else:
        prep = _prepare(hs.reshape(-1), rep(x0), rep(x_des), rep(obs),
                        params, mpc)
        conv = torch.zeros(Bt, dtype=torch.bool, device=dev)

    if route == "joint":
        # H is block diagonal under the per-player permutation: only the
        # diagonal blocks are taken
        H, g = prep.H, prep.g
        Hb = torch.stack([H[:, perm1][:, :, perm1],
                          H[:, perm2][:, :, perm2]], dim=1)
        g_j = torch.cat([g[:, perm1], g[:, perm2]], dim=1)
        arena1 = prep.A_fix[:, nU:nU + n1][:, :, perm1]
        arena2 = prep.A_fix[:, nU + n1:][:, :, perm2]
        lx = prep.lo_fix[:, :nU][:, perm_j]
        ux = prep.hi_fix[:, :nU][:, perm_j]
        lo_a1, hi_a1 = prep.lo_fix[:, nU:nU + n1], prep.hi_fix[:, nU:nU + n1]
        lo_a2, hi_a2 = prep.lo_fix[:, nU + n1:], prep.hi_fix[:, nU + n1:]
        big_ko = torch.full((Bt, N_OBS * N), 1e9, dtype=dtype, device=dev)
        big_p = torch.full((Bt, N), 1e9, dtype=dtype, device=dev)
        for _ in range(mpc.sqp_iters):
            r1, b1, r2, b2, rpr, bpr = _keepout_pieces(U, prep, params, mpc)
            Ab = torch.stack([
                torch.cat([arena1, r1[:, :, perm1], rpr[:, :, perm1]], 1),
                torch.cat([arena2, r2[:, :, perm2], rpr[:, :, perm2]], 1)],
                dim=1)
            l_j = torch.cat([lo_a1, b1, lo_a2, b2, bpr], dim=1)
            u_j = torch.cat([hi_a1, big_ko, hi_a2, big_ko, big_p], dim=1)
            x, stats = qp_lanes.joint_qp_stats(
                Hb, g_j, Ab, l_j, u_j, lx, ux, m_own=(2 + N_OBS) * N,
                m_pair=N, iters=mpc.qp_iters, scale_rows=True)
            U = x[:, inv_j].to(dtype)
            conv = stats[:, 0] > 0.5
        margin = sqp_lanes.flag_margin(stats).reshape(Bq, T)
    elif route in ("lanes", "plain"):
        big = torch.full((Bt, 2 * N_OBS * N + N), 1e9, dtype=dtype,
                         device=dev)
        solve = qp_lanes.solve_qp_lanes if route == "lanes" else solve_qp
        for _ in range(mpc.sqp_iters):
            rows, rhs = _keepout_all(U, prep, params, mpc)
            sol = solve(prep.H, prep.g, torch.cat([prep.A_fix, rows], dim=1),
                        torch.cat([prep.lo_fix, rhs], dim=1),
                        torch.cat([prep.hi_fix, big], dim=1),
                        iters=mpc.qp_iters, scale_rows=True)
            U, conv = sol.x.to(dtype), sol.converged

    if route != "fused":
        U, costs = _finish(U, prep, params, mpc)
    costs = torch.where(conv, costs, costs + 1e9)
    return Candidates(h=hs, U=U.reshape(Bq, T, nU), cost=costs.reshape(Bq, T),
                      conv=conv.reshape(Bq, T), margin=margin)


def select(state: CmpcState, c: Candidates):
    """The least-cost candidate of each instance (ties to the first): the
    new state (updated only where the winner converged) and both players'
    first controls (Bq, 2) each."""
    k = torch.argmin(c.cost, dim=1)
    bi = torch.arange(k.shape[0], device=k.device)
    U_w = c.U[bi, k]
    ok = c.conv[bi, k]
    h_w = c.h[bi, k]
    new_state = CmpcState(U=torch.where(ok[:, None], U_w, state.U),
                          valid=ok | state.valid,
                          h=torch.where(ok, h_w, state.h))
    return new_state, U_w[:, 0:2], U_w[:, 2:4]


def compute_control_batch(state: CmpcState, x0_p1, x0_p2, xf_p1, xf_p2,
                          obstacles, params: SimParams, mpc: MpcParams,
                          route: str = "fused"):
    """Batched CMPC control: every argument carries a leading instance axis
    Bq (e.g. games); all Bq x t_grid candidates solve in one K4 launch on
    the fused route.  Returns (new state, u1 (Bq, 2), u2 (Bq, 2))."""
    return select(state, candidates(state, x0_p1, x0_p2, xf_p1, xf_p2,
                                    obstacles, params, mpc, route))


def compute_control(state: CmpcState, x0_p1, x0_p2, xf_p1, xf_p2, obstacles,
                    params: SimParams, mpc: MpcParams):
    """One team (the reference's CentralizedMPC.compute_control): state
    leaves unbatched, the players' states and targets (4,), obstacles
    (2, 2), on one device.  Each SQP iteration is a cold QP solve per
    candidate, as in the JAX package's per-team function: on K5 on the
    card, on the plain solver on the CPU.  Returns (new state, u1 (2,),
    u2 (2,))."""
    route = "joint" if x0_p1.is_cuda else "plain"
    st = CmpcState(*(a[None] for a in state))
    new, u1, u2 = compute_control_batch(
        st, x0_p1[None], x0_p2[None], xf_p1[None], xf_p2[None],
        obstacles[None], params, mpc, route)
    return CmpcState(*(a[0] for a in new)), u1[0], u2[0]

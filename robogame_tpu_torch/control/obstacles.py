"""Obstacle-avoiding trajectory optimization for one player.

Counterpart of the JAX package's ``control/obstacles.py`` (the
reference's NonLinearOptimizer):

* :func:`intercepting_with_obs_avoidance`: fixed T, quadratic terminal
  (10 I) and effort cost, nonconvex keep-outs per obstacle;
* :func:`intercepting_with_obs_avoidance_bb`: the same problem with
  axis-separation sides and terminal *equality*, as a race of fixed side
  assignments;
* :func:`min_time_traj_avoid_obs`: N=20 at the step dt (the reference
  pins the collocation step to dt), terminal cost I, running cost
  0.1 |u|^2 dt, player keep-outs only.

A fixed-iteration SQP: each outer iteration linearizes every keep-out
around the current iterate and solves one condensed-horizon QP.  Every QP
goes to :func:`..ops.qp.solve_qp` on the caller's device in the params'
dtype (row-scaled): that is the port's counterpart of JAX's ``solve_qp``,
the plain XLA ADMM that JAX calls here, not a fallback from a kernel.
These shapes lie beyond K2's (n <= 64, f32): 40 steps in f64 make n = 80.
The side variant's 6 + 4 (N + 1) candidate assignments solve as one
batched ``solve_qp``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimParams, resolve_device
from ..models.lqsys import condense, exact_ab
from ..ops.qp import QpSolution, solve_qp
from .trajopt import MAX_TRAJ, Trajectory, _arena_rows, _vec

MAX_OBS = 4          # obstacle slots: teammate + 2 opponents + puck


class _QpParts(NamedTuple):
    H: torch.Tensor
    g: torch.Tensor
    A_fix: torch.Tensor   # fixed rows: input box, arena box [, terminal eq]
    lo_fix: torch.Tensor
    hi_fix: torch.Tensor
    phi: torch.Tensor
    gam: torch.Tensor
    sel: torch.Tensor     # (2N, 4N) position selector


def _build_parts(x0, xf, h, params: SimParams, N: int, w_term: float,
                 w_eff: float, terminal_eq: bool) -> _QpParts:
    """The condensed QP of one problem x0 -> xf (4,) at step ``h``, on
    x0's device and dtype."""
    dtype, dev = x0.dtype, x0.device
    A, B = exact_ab(torch.as_tensor(h, dtype=dtype, device=dev),
                    params.tau_player, dtype)
    phi, gam = condense(A, B, N)
    nU = 2 * N
    rowN = slice(4 * (N - 1), 4 * N)
    gN = gam[rowN]
    phiN_x0 = phi[rowN] @ x0
    eye = torch.eye(nU, dtype=dtype, device=dev)
    H = 2.0 * (w_eff * eye + w_term * gN.T @ gN)
    g = 2.0 * w_term * gN.T @ (phiN_x0 - xf)
    sel, plo, phi_hi = (a.to(dev) for a in _arena_rows(params, N, dtype))
    A_pos = sel @ gam
    off = sel @ (phi @ x0)
    box = torch.full((nU,), params.input_limit, dtype=dtype, device=dev)
    A_fix = torch.cat([eye, A_pos])
    lo = torch.cat([-box, plo - off])
    hi = torch.cat([box, phi_hi - off])
    if terminal_eq:
        tgt = xf - phiN_x0
        A_fix = torch.cat([A_fix, gN])
        lo = torch.cat([lo, tgt])
        hi = torch.cat([hi, tgt])
    return _QpParts(H, g, A_fix, lo, hi, phi, gam, sel)


def _positions(parts: _QpParts, x0, U):
    X = parts.phi @ x0 + parts.gam @ U
    return (parts.sel @ X).reshape(-1, 2)                 # (N, 2)


def _keepout_rows(parts: _QpParts, x0, p_bar, obs, obs_r, obs_mask):
    """Linearized keep-outs  |p_k - o|^2 >= r_o^2  around p_bar (N, 2),
    obstacles (MAX_OBS, 2): returns (MAX_OBS * N, nU) rows and bounds."""
    N = p_bar.shape[0]
    diff = p_bar[None, :, :] - obs[:, None, :]             # (M, N, 2)
    gval = (diff * diff).sum(-1) - obs_r[:, None] ** 2
    # row: 2 diff . p_k >= 2 diff . p_bar - g
    sel_gam = (parts.sel @ parts.gam).reshape(N, 2, -1)    # (N, 2, nU)
    rows = 2.0 * torch.einsum("mnc,ncu->mnu", diff, sel_gam)
    p0_part = (parts.sel @ (parts.phi @ x0)).reshape(N, 2)
    rhs = (2.0 * (diff * p_bar[None]).sum(-1) - gval -
           2.0 * (diff * p0_part[None]).sum(-1))
    m = obs_mask[:, None]
    rows = torch.where(m[..., None], rows, 0.0)
    lo = torch.where(m, rhs, -1.0)
    hi = torch.where(m, torch.full_like(lo, 1e9), 1.0)
    nU = parts.gam.shape[1]
    return rows.reshape(-1, nU), lo.reshape(-1), hi.reshape(-1)


def _solve1(parts: _QpParts, A, lo, hi, qp_iters: int) -> QpSolution:
    sol = solve_qp(parts.H[None], parts.g[None], A[None], lo[None],
                   hi[None], iters=qp_iters, scale_rows=True)
    return QpSolution(*(a[0] for a in sol))


def _sqp(x0, xf, h, params, N, w_term, w_eff, terminal_eq, obs, obs_r,
         obs_mask, sqp_iters, qp_iters):
    parts = _build_parts(x0, xf, h, params, N, w_term, w_eff, terminal_eq)
    U = torch.zeros((2 * N,), dtype=x0.dtype, device=x0.device)
    conv = None
    for _ in range(sqp_iters):
        p_bar = _positions(parts, x0, U)
        rows, lo_o, hi_o = _keepout_rows(parts, x0, p_bar, obs, obs_r,
                                         obs_mask)
        sol = _solve1(parts, torch.cat([parts.A_fix, rows]),
                      torch.cat([parts.lo_fix, lo_o]),
                      torch.cat([parts.hi_fix, hi_o]), qp_iters)
        U, conv = sol.x, sol.converged
    # feasibility: all keep-outs hold at the final iterate (small slack)
    p_fin = _positions(parts, x0, U)
    dist2 = ((p_fin[None] - obs[:, None]) ** 2).sum(-1)
    feas = torch.all(torch.where(obs_mask[:, None],
                                 dist2 >= (obs_r[:, None] - 0.05) ** 2,
                                 True))
    return parts, U, conv & feas


def _pack(U, N: int, params: SimParams, success) -> Trajectory:
    dtype, dev = U.dtype, U.device
    u_pad = torch.zeros((2, MAX_TRAJ), dtype=dtype, device=dev)
    u_pad[:, :N] = U.reshape(N, 2).T
    n = torch.full((), N, dtype=torch.int32, device=dev)
    return Trajectory(u=torch.where(success, u_pad, 0.0),
                      length=torch.where(success, n, torch.ones_like(n)),
                      success=success,
                      T=torch.full((), N * params.dt, dtype=dtype,
                                   device=dev))


def _obs_arrays(obstacles, p_puck, params: SimParams, dtype,
                include_puck: bool = True, device="cuda"):
    """The obstacle list padded to MAX_OBS with a mask, on ``device``;
    radii as the reference's: players 2 r, the puck r + r_puck - 0.2."""
    dev = resolve_device(device)
    obs = torch.zeros((MAX_OBS, 2), dtype=dtype)
    mask = torch.zeros((MAX_OBS,), dtype=torch.bool)
    radii = torch.zeros((MAX_OBS,), dtype=dtype)
    n = 0
    for p in obstacles:
        obs[n] = torch.as_tensor(p, dtype=dtype).reshape(2).cpu()
        mask[n] = True
        radii[n] = 2.0 * params.player_radius
        n += 1
    if include_puck and p_puck is not None:
        obs[n] = torch.as_tensor(p_puck, dtype=dtype).reshape(2).cpu()
        mask[n] = True
        radii[n] = params.player_radius + params.puck_radius - 0.2
    return obs.to(dev), radii.to(dev), mask.to(dev)


def _start(p0, v0, pf, vf, params: SimParams, device):
    dev = resolve_device(device)
    dtype = params.torch_dtype
    x0 = torch.cat([_vec(p0, dtype, dev), _vec(v0, dtype, dev)])
    xf = torch.cat([_vec(pf, dtype, dev), _vec(vf, dtype, dev)])
    return x0, xf, dev


def _obstacles(obs, obs_r, obs_mask, dtype, dev):
    return (torch.as_tensor(obs, dtype=dtype).to(dev),
            torch.as_tensor(obs_r, dtype=dtype).to(dev),
            torch.as_tensor(obs_mask, dtype=torch.bool).to(dev))


def intercepting_with_obs_avoidance(p0, v0, pf, vf, obs, obs_r, obs_mask,
                                    params: SimParams, n_steps: int,
                                    sqp_iters: int = 5, qp_iters: int = 150,
                                    device="cuda") -> Trajectory:
    """Fixed-T kick trajectory avoiding obstacles ((MAX_OBS, 2) obstacles
    with radii and mask): terminal cost 10 I, effort cost 1, on
    ``device``.  Leaves without a batch axis."""
    x0, xf, dev = _start(p0, v0, pf, vf, params, device)
    obs, obs_r, obs_mask = _obstacles(obs, obs_r, obs_mask, x0.dtype, dev)
    _, U, ok = _sqp(x0, xf, params.dt, params, n_steps, 10.0, 1.0, False,
                    obs, obs_r, obs_mask, sqp_iters, qp_iters)
    return _pack(U, n_steps, params, ok)


def _solve_sides(sides, parts: _QpParts, x0, obs, obs_s, obs_mask,
                 qp_iters: int) -> QpSolution:
    """The QPs with fixed axis-separation sides, one a candidate, in one
    batched solve.  ``sides``: (C, M, N) int64 in {-1 free or disabled,
    0: x >= o_x + s, 1: x <= o_x - s, 2: y >= o_y + s, 3: y <= o_y - s}
    (the reference's binary assignment)."""
    dtype = x0.dtype
    C, M, N = sides.shape
    sel_gam = (parts.sel @ parts.gam).reshape(N, 2, -1)
    p0_part = (parts.sel @ (parts.phi @ x0)).reshape(N, 2)
    is_x = (sides == 0) | (sides == 1)
    sign = torch.where((sides == 0) | (sides == 2), 1.0, -1.0).to(dtype)
    axis = torch.where(is_x, 0, 1)
    nrm = torch.nn.functional.one_hot(axis, 2).to(dtype) * sign[..., None]
    rows = torch.einsum("cmnk,nku->cmnu", nrm, sel_gam)
    # sign (p_ax - o_ax) >= s  =>  row . U >= s + sign o_ax - sign p0_ax
    rhs = (obs_s[:, None] + (nrm * obs[:, None]).sum(-1) -
           (nrm * p0_part[None]).sum(-1))
    active = (sides >= 0) & obs_mask[:, None]
    rows = torch.where(active[..., None], rows, 0.0)
    lo_o = torch.where(active, rhs, -1.0).reshape(C, -1)
    hi_o = torch.where(active, torch.full_like(rhs, 1e9), 1.0).reshape(C, -1)
    A = torch.cat([parts.A_fix.expand(C, -1, -1),
                   rows.reshape(C, M * N, 2 * N)], dim=1)
    lo = torch.cat([parts.lo_fix.expand(C, -1), lo_o], dim=1)
    hi = torch.cat([parts.hi_fix.expand(C, -1), hi_o], dim=1)
    return solve_qp(parts.H.expand(C, -1, -1), parts.g.expand(C, -1), A, lo,
                    hi, iters=qp_iters, scale_rows=True)


def intercepting_with_obs_avoidance_bb(p0, v0, pf, vf, obs, obs_r, obs_mask,
                                       params: SimParams, n_steps: int,
                                       sqp_iters: int = 5,
                                       qp_iters: int = 150,
                                       device="cuda") -> Trajectory:
    """The big-M MIQP variant with the reference's terminal *equality*:
    races a fixed set of side assignments -- the SQP solution's per-knot
    dominant side, its per-obstacle majority side, the four uniform
    sides, and each split of the knots between two sides that cross an
    axis -- in one batched QP solve; the feasible one of least effort
    wins."""
    x0, xf, dev = _start(p0, v0, pf, vf, params, device)
    obs, obs_r, obs_mask = _obstacles(obs, obs_r, obs_mask, x0.dtype, dev)
    N, M = n_steps, obs.shape[0]
    parts, U, _ = _sqp(x0, xf, params.dt, params, N, 10.0, 1.0, True, obs,
                       obs_r, obs_mask, sqp_iters, qp_iters)

    # candidate 0: per-knot dominant separating axis and side of the SQP
    p_bar = _positions(parts, x0, U)                       # (N, 2)
    diff = p_bar[None] - obs[:, None]                      # (M, N, 2)
    axis = torch.argmax(diff.abs(), dim=-1)                # (M, N) 0=x
    sgn_pos = torch.gather(diff, -1, axis[..., None])[..., 0] >= 0
    per_knot = torch.where(axis == 0, torch.where(sgn_pos, 0, 1),
                           torch.where(sgn_pos, 2, 3))
    # candidate 1: per-obstacle majority side, uniform across knots
    counts = torch.nn.functional.one_hot(per_knot, 4).sum(dim=1)  # (M, 4)
    majority = torch.argmax(counts, dim=-1)
    cand_major = majority[:, None].expand(M, N)
    # candidates 2-5: every obstacle on one uniform side
    uniform = torch.arange(4, device=dev)[:, None, None].expand(4, M, N)
    # split candidates: side a for knots < j, side b for knots >= j, for
    # every split point and the four axis-crossing (a, b) pairs
    ks = torch.arange(N, device=dev)
    pairs = torch.tensor([[1, 0], [0, 1], [3, 2], [2, 3]], device=dev)
    js = torch.arange(N + 1, device=dev)
    split = torch.where(ks[None, None, :] < js[None, :, None],
                        pairs[:, 0, None, None], pairs[:, 1, None, None])
    split = split.reshape(4 * (N + 1), 1, N).expand(4 * (N + 1), M, N)
    sides = torch.cat([per_knot[None], cand_major[None], uniform, split])

    sols = _solve_sides(sides, parts, x0, obs, obs_r, obs_mask, qp_iters)
    effort = (sols.x * sols.x).sum(-1)
    score = torch.where(sols.converged, effort,
                        torch.full_like(effort, float("inf")))
    best = torch.argmin(score)
    return _pack(sols.x[best], N, params, sols.converged[best])


def min_time_traj_avoid_obs(p0, v0, pf, vf, obs, obs_r, obs_mask,
                            params: SimParams, sqp_iters: int = 5,
                            qp_iters: int = 400,
                            device="cuda") -> Trajectory:
    """N=20 at the step dt (the reference's min == max == dt
    collocation), terminal cost I, effort 0.1 dt (the reference's running
    cost 0.1 |u|^2 integrated over a step), player keep-outs only."""
    x0, xf, dev = _start(p0, v0, pf, vf, params, device)
    obs, obs_r, obs_mask = _obstacles(obs, obs_r, obs_mask, x0.dtype, dev)
    N = 20
    _, U, ok = _sqp(x0, xf, params.dt, params, N, 1.0, 0.1 * params.dt,
                    False, obs, obs_r, obs_mask, sqp_iters, qp_iters)
    return _pack(U, N, params, ok)

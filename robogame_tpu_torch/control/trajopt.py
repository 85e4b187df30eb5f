"""Free-final-time trajectories for a single player, batched.

Counterpart of the JAX package's ``control/trajopt.py`` (the reference's
LinearOptimizer): :func:`min_time_traj_batch` plans B reach problems at
once.  Free final time is a parallel enumeration over a fixed grid of
T_GRID final times: one condensed QP per (candidate, problem), all solved
in one launch of K2 (:func:`..ops.qp_lanes.solve_qp_lanes`), then the
argmin of the reference's soft objective 10 |x_N - xf|^2 + T.  The
candidates' H and constraint matrices depend only on the T grid, so K2
takes its grouped route (group = B, from 32 problems): one factorization
per shared matrix, then the factor-free iterations, instead of a
factorization per problem.

A trajectory is a padded (2, MAX_TRAJ) control sequence plus a length.
The glue products are elementwise sums, never matrix products, so they run
in full f32 whatever the TF32 setting.

The fixed-final-time planners of ``ClassicalPlayer``'s skills,
:func:`intercepting_traj` (terminal equality, minimum effort) and
:func:`min_time_bounce_kick_traj` (the kick velocity from the elastic
reset map), solve one condensed QP each (:func:`_fixed_T_qp`, batched over
a leading problem axis) with :func:`..ops.qp.solve_qp` on the caller's
device in the params' dtype: that is the port's counterpart of the JAX
package's ``ops/qp.py::solve_qp``, the plain XLA ADMM that JAX calls
there, not a fallback from a kernel.  Their shapes lie beyond K2's
(n <= 64, f32): 40 steps in f64 make n = 80.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import SimParams, resolve_device
from ..models.lqsys import condense, exact_ab
from ..ops import qp_lanes
from ..ops.qp import _mv, solve_qp

# Solver-grid constants (the reference's N=15 knots, T in [dt, 5])
N_KNOTS = 15
T_MAX = 5.0
T_GRID = 16
MAX_TRAJ = 100        # ceil(T_MAX / dt) at dt=0.05
W_TERMINAL, W_EFFORT = 10.0, 1e-3


class Trajectory(NamedTuple):
    u: torch.Tensor          # (B, 2, MAX_TRAJ) padded control sequence at dt
    length: torch.Tensor     # (B,) int32 valid entries
    success: torch.Tensor    # (B,) bool
    T: torch.Tensor          # (B,) chosen final time


def _arena_rows(params: SimParams, N: int, dtype):
    """Inequality rows selecting the position components of the stacked
    state X (N*4,) with the arena bounds shrunk by the player radius."""
    sel = torch.zeros((2 * N, 4 * N), dtype=dtype)
    for k in range(N):
        sel[2 * k, 4 * k] = 1.0
        sel[2 * k + 1, 4 * k + 1] = 1.0
    r = params.player_radius
    hx = params.arena_x / 2.0 - r
    hy = params.arena_y / 2.0 - r
    lo = torch.tensor([-hx, -hy], dtype=dtype).repeat(N)
    hi = torch.tensor([hx, hy], dtype=dtype).repeat(N)
    return sel, lo, hi


def _fixed_T_qp(x0, xf, h, params: SimParams, N: int, w_terminal: float,
                w_effort: float, terminal_eq: bool, qp_iters: int):
    """Condensed horizon QPs of P problems x0 -> xf (P, 4) at step length
    ``h`` (a float, or (P,) one a problem), solved in one batched
    :func:`..ops.qp.solve_qp`:

    min  w_eff |U|^2 + w_term |x_N - xf|^2   (or x_N == xf as equality)
    s.t. |u| <= input_limit (box), arena box on every knot.
    Returns (U (P, N, 2), x_N (P, 4), converged (P,))."""
    dtype, dev = x0.dtype, x0.device
    P = x0.shape[0]
    A, B = exact_ab(torch.as_tensor(h, dtype=dtype, device=dev),
                    params.tau_player, dtype)
    phi, gam = condense(A, B, N)          # X = phi x0 + gam U
    phi, gam = (a.expand((P,) + a.shape[-2:]) for a in (phi, gam))
    nU = 2 * N
    rowN = slice(4 * (N - 1), 4 * N)
    gN = gam[:, rowN]                                         # (P, 4, nU)
    phiN_x0 = _mv(phi[:, rowN], x0)                           # (P, 4)
    gNt = gN.transpose(1, 2)
    eye = torch.eye(nU, dtype=dtype, device=dev)
    H = 2.0 * (w_effort * eye + w_terminal * gNt @ gN)
    g = 2.0 * w_terminal * _mv(gNt, phiN_x0 - xf)
    sel, plo, phi_hi = (a.to(dev) for a in _arena_rows(params, N, dtype))
    A_pos = sel @ gam                                         # (P, 2N, nU)
    off = _mv(sel, _mv(phi, x0))
    lim = params.input_limit
    box = torch.full((P, nU), lim, dtype=dtype, device=dev)
    A_in = torch.cat([eye.expand(P, nU, nU), A_pos], dim=1)
    lo = torch.cat([-box, plo - off], dim=1)
    hi = torch.cat([box, phi_hi - off], dim=1)
    if terminal_eq:
        A_in = torch.cat([A_in, gN], dim=1)
        tgt = xf - phiN_x0
        lo = torch.cat([lo, tgt], dim=1)
        hi = torch.cat([hi, tgt], dim=1)
    sol = solve_qp(H, g, A_in, lo, hi, iters=qp_iters)
    # project out the residual ADMM box violation (exact, cheap)
    U = sol.x.reshape(P, N, 2).clamp(-lim, lim)
    xN = phiN_x0 + _mv(gN, U.reshape(P, nU))
    return U, xN, sol.converged


def _vec(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype).reshape(-1).to(dev)


def intercepting_traj(p0, v0, pf, vf, params: SimParams, n_steps: int,
                      qp_iters: int = 80, device="cuda") -> Trajectory:
    """Fixed-T trajectory of one player ((2,) arrays) with terminal
    equality and minimum effort, ``n_steps`` steps of dt, on ``device``
    (the exact ZOH model at the dt grid, which the physics integrates
    exactly).  Leaves without a batch axis."""
    dev = resolve_device(device)
    dtype = params.torch_dtype
    x0 = torch.cat([_vec(p0, dtype, dev), _vec(v0, dtype, dev)])
    xf = torch.cat([_vec(pf, dtype, dev), _vec(vf, dtype, dev)])
    N = n_steps
    U, _, conv = _fixed_T_qp(x0[None], xf[None], params.dt, params, N, 0.0,
                             1.0, True, qp_iters)
    conv = conv[0]
    u_pad = torch.zeros((2, MAX_TRAJ), dtype=dtype, device=dev)
    u_pad[:, :N] = U[0].T
    zero = torch.zeros((), dtype=dtype, device=dev)
    n = torch.full((), N, dtype=torch.int32, device=dev)
    return Trajectory(u=torch.where(conv, u_pad, zero),
                      length=torch.where(conv, n, torch.ones_like(n)),
                      success=conv,
                      T=torch.full((), params.dt, dtype=dtype, device=dev)
                      * N)


def min_time_bounce_kick_traj(p0, v0, p0_puck, v0_puck, v_puck_desired,
                              params: SimParams, qp_iters: int = 80,
                              device="cuda") -> Trajectory:
    """Reach the kick point with a final velocity that imparts
    ``v_puck_desired`` through the elastic reset map, in T = 1 (N = 20).
    With the kick point placed along the desired direction, the reset map
    pins only the component of the player's final velocity along the
    contact normal; the tangential component is chosen zero.  (2,) arrays
    on ``device``; leaves without a batch axis."""
    dev = resolve_device(device)
    dtype = params.torch_dtype
    p0, v0, p_pk, v_pk, vd = (_vec(a, dtype, dev) for a in (
        p0, v0, p0_puck, v0_puck, v_puck_desired))
    m1, m2 = params.player_mass, params.puck_mass
    nrm = torch.sqrt((vd * vd).sum())
    dirn = vd / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    pf = p_pk - dirn * (params.puck_radius + params.player_radius)
    nvec = p_pk - pf                       # contact normal (unnormalized)
    nn = (nvec * nvec).sum()
    c = 2.0 * m1 / (m1 + m2)
    # v_after = v2 - c ((v2 - v1).n / |n|^2) n == vd; along n:
    # (vd - v2).n = c (v1 - v2).n  ->  v1.n
    v1_dot_n = ((vd - v_pk) * nvec).sum() / c + (v_pk * nvec).sum()
    v1 = (v1_dot_n / nn) * nvec            # tangential component = 0
    T = torch.ones((1,), dtype=dtype, device=dev)
    N = 20
    h = T / N
    x0 = torch.cat([p0, v0])[None]
    xf = torch.cat([pf, v1])[None]
    U, _, conv = _fixed_T_qp(x0, xf, h, params, N, 0.0, 1.0, True, qp_iters)
    u_pad, n = _resample(U, h, params.dt, T)
    conv = conv[0]
    zero = torch.zeros((), dtype=dtype, device=dev)
    return Trajectory(u=torch.where(conv, u_pad[0], zero),
                      length=torch.where(conv, n[0], torch.ones_like(n[0])),
                      success=conv, T=T[0])


def _t_grid(params: SimParams) -> np.ndarray:
    """The candidate final times, geometric from dt to T_MAX, in f64."""
    return params.dt * np.logspace(0.0, 1.0, T_GRID, base=T_MAX / params.dt)


class _Grid(NamedTuple):
    """The T grid's per-candidate tables (K = T_GRID)."""
    H: torch.Tensor        # (K, nU, nU)
    A: torch.Tensor        # (K, m, nU): input box rows, then arena rows
    gN: torch.Tensor       # (K, 4, nU) terminal-state rows of Gamma
    phiN: torch.Tensor     # (K, 4, 4)  terminal-state rows of Phi
    selphi: torch.Tensor   # (K, 2N, 4) knot positions from x0
    plo: torch.Tensor      # (2N,) arena bounds
    phi_hi: torch.Tensor
    Ts: torch.Tensor       # (K,) candidate final times


@functools.lru_cache(maxsize=16)
def _grid(params: SimParams, dtype: torch.dtype, device) -> _Grid:
    """The tables of one configuration, built once on the CPU (so the card
    and the CPU use the same numbers) and moved to ``device``."""
    N = N_KNOTS
    nU = 2 * N
    sel, plo, phi_hi = _arena_rows(params, N, dtype)
    rowN = slice(4 * (N - 1), 4 * N)
    H, Ain, gN, phiN, selphi = [], [], [], [], []
    Ts_np = _t_grid(params)
    for h in Ts_np / N_KNOTS:
        A, Bm = exact_ab(float(h), params.tau_player, dtype)
        phi, gam = condense(A, Bm, N)
        gNk = gam[rowN]
        H.append(2.0 * (W_EFFORT * torch.eye(nU, dtype=dtype) +
                        W_TERMINAL * gNk.T @ gNk))
        Ain.append(torch.cat([torch.eye(nU, dtype=dtype), sel @ gam]))
        gN.append(gNk)
        phiN.append(phi[rowN])
        selphi.append(sel @ phi)
    tabs = (torch.stack(H), torch.stack(Ain), torch.stack(gN),
            torch.stack(phiN), torch.stack(selphi), plo, phi_hi,
            torch.tensor(Ts_np, dtype=dtype))
    return _Grid(*(t.to(device).contiguous() for t in tabs))


def candidate_qps(x0, xf, params: SimParams):
    """The K x B condensed QPs of a batch of reach problems x0 -> xf (B, 4):
    returns (grid, Phi_N x0 (K, B, 4), g (K*B, nU), lo, hi (K*B, m));
    problem k*B + b is candidate k of problem b, its H and A are
    grid.H[k] and grid.A[k]."""
    dtype = x0.dtype
    T = _grid(params, dtype, x0.device)
    K, B = T_GRID, x0.shape[0]
    lim = params.input_limit
    nU = 2 * N_KNOTS
    phiN_x0 = (T.phiN[:, None] * x0[None, :, None, :]).sum(-1)    # (K,B,4)
    d = phiN_x0 - xf[None]
    g = 2.0 * W_TERMINAL * (T.gN[:, None] * d[..., None]).sum(-2)  # (K,B,nU)
    off = (T.selphi[:, None] * x0[None, :, None, :]).sum(-1)      # (K,B,2N)
    box = torch.full((K, B, nU), lim, dtype=dtype, device=x0.device)
    lo = torch.cat([-box, T.plo - off], dim=-1)
    hi = torch.cat([box, T.phi_hi - off], dim=-1)
    m = lo.shape[-1]
    return T, phiN_x0, g.reshape(K * B, nU), lo.reshape(K * B, m), \
        hi.reshape(K * B, m)


def candidate_costs(p0, v0, pf, vf, params: SimParams, qp_iters: int = 60):
    """Every candidate of :func:`min_time_traj_batch`: returns U (K, B, N, 2)
    clipped to the input box, costs (K, B) with +1e6 where the QP did not
    converge, conv (K, B) and the candidate final times Ts (K,)."""
    x0 = torch.cat([p0, v0], dim=1)
    xf = torch.cat([pf, vf], dim=1)
    K, B = T_GRID, x0.shape[0]
    lim = params.input_limit
    T, phiN_x0, g, lo, hi = candidate_qps(x0, xf, params)
    sol = qp_lanes.solve_qp_lanes(T.H, g, T.A, lo, hi, iters=qp_iters,
                                  group=B)
    U = sol.x.reshape(K, B, N_KNOTS, 2).clamp(-lim, lim)
    xN = phiN_x0 + (T.gN[:, None] *
                    U.reshape(K, B, 1, 2 * N_KNOTS)).sum(-1)     # (K,B,4)
    costs = 10.0 * ((xN - xf[None]) ** 2).sum(-1) + T.Ts[:, None]
    conv = sol.converged.reshape(K, B)
    costs = torch.where(conv, costs, costs + 1e6)
    return U, costs, conv, T.Ts


def _resample(U, h, dt: float, T):
    """Resample piecewise-constant (B, N, 2) controls of step h (B,) at dt
    into the padded playback buffer (B, 2, MAX_TRAJ); lengths
    max(1, floor(T/dt)).  Divisions by dt go through a tensor so that each
    is one IEEE f32 division on every device."""
    dtype = U.dtype
    B, N = U.shape[:2]
    dt_t = torch.full_like(T, dt)
    n_out = torch.clamp(torch.floor(T / dt_t), min=1).to(torch.int32)
    t_out = torch.arange(MAX_TRAJ, dtype=dtype, device=U.device) * \
        torch.full((), dt, dtype=dtype, device=U.device)
    idx = (t_out[None] / h[:, None]).to(torch.int32).clamp(0, N - 1).long()
    u_full = torch.gather(U, 1, idx[..., None].expand(B, MAX_TRAJ, 2))
    mask = (torch.arange(MAX_TRAJ, device=U.device)[None] < n_out[:, None])
    u_full = torch.where(mask[..., None], u_full,
                         torch.zeros((), dtype=dtype, device=U.device))
    return u_full.transpose(1, 2), n_out


def min_time_traj_batch(p0, v0, pf, vf, params: SimParams,
                        qp_iters: int = 60) -> Trajectory:
    """Free-final-time reach for B problems: (B, 2) start and target
    positions and velocities, on their device.  All B x T_GRID candidate
    QPs solve in one K2 launch; each problem takes the candidate of least
    cost (ties to the shortest T), and an unconverged choice plans
    nothing (zero controls, length 1)."""
    U, costs, conv, Ts = candidate_costs(p0, v0, pf, vf, params, qp_iters)
    B = p0.shape[0]
    kbest = torch.argmin(costs, dim=0)                          # (B,)
    bi = torch.arange(B, device=p0.device)
    U_b = U[kbest, bi]
    T_b = Ts[kbest]
    h_b = T_b / torch.full_like(T_b, float(N_KNOTS))
    success = conv[kbest, bi]
    u_pad, n_len = _resample(U_b, h_b, params.dt, T_b)
    u_pad = torch.where(success[:, None, None], u_pad,
                        torch.zeros((), dtype=u_pad.dtype,
                                    device=u_pad.device))
    one = torch.ones_like(n_len)
    return Trajectory(u=u_pad, length=torch.where(success, n_len, one),
                      success=success, T=T_b)


def min_time_traj(p0, v0, pf, vf, params: SimParams, qp_iters: int = 60,
                  device="cuda") -> Trajectory:
    """One reach problem ((2,) arrays): :func:`min_time_traj_batch` at
    B=1 on ``device``; leaves without the batch axis."""
    dev = resolve_device(device)
    dt = params.torch_dtype
    args = [torch.as_tensor(a, dtype=dt).reshape(1, 2).to(dev)
            for a in (p0, v0, pf, vf)]
    tr = min_time_traj_batch(*args, params, qp_iters=qp_iters)
    return Trajectory(*(t[0] for t in tr))

"""Joint puck+player MPC (the reference's CentralizedPuckPlayerMPC).

Counterpart of the JAX package's ``control/puck_player_mpc.py``.  The
reference class defines ``compute_control`` twice and the second
definition wins, so what it does is: aim at the puck with velocity
``V_HIT`` toward the goal, solve a single-player free-final-time problem
for player 1 only, and return ``(True, u1, zeros(2))``.  This module does
that with the DMPC machinery (the same single-player problem) and a warm
start, over its own grid of step sizes.

Each candidate is the JAX package's per-candidate algorithm: ``sqp_iters``
cold QP solves, one an SQP iteration, through
:func:`.dmpc.solve_candidates` on route ``"lanes"`` (K2) on the card and
``"plain"`` on the CPU, as :func:`.dmpc.compute_control` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import MpcParams, SimParams, resolve_device
from .dmpc import (N_NEIGHBORS, DmpcState, initial_dmpc_state,
                   solve_candidates)

V_HIT = 6.0     # the reference's hit speed toward the goal


class JointPuckPlayerState(NamedTuple):
    p1: DmpcState


def initial_state(mpc: MpcParams, dtype=torch.float32,
                  device="cuda") -> JointPuckPlayerState:
    return JointPuckPlayerState(p1=initial_dmpc_state(mpc, dtype, device))


def _step_sizes(params: SimParams, mpc: MpcParams, dtype, device):
    """The puck player's own grid: linspace(dt minT_frac / (N + 1), 4 dt,
    t_grid), in f64 and rounded once to ``dtype``."""
    minT = params.dt * mpc.minT_frac / (mpc.N + 1)
    maxT = 4.0 * params.dt
    return torch.as_tensor(np.linspace(minT, maxT, mpc.t_grid),
                           dtype=torch.float64).to(dtype).to(device)


def compute_control(state: JointPuckPlayerState, x_p1, x_p2, x_puck,
                    p_goal, obstacles, params: SimParams, mpc: MpcParams):
    """Player 1 toward the puck, player 2 idle, on x_p1's device and
    dtype: x_p1, x_p2, x_puck (4,), p_goal (2,), obstacles (M, 2) (padded
    with far-away points or trimmed to the 3 neighbour slots).  Returns
    (new state, u_p1 (2,), u_p2 (2,) zeros)."""
    dtype, dev = x_p1.dtype, x_p1.device
    p_puck = x_puck.to(dtype)[0:2]
    d = p_goal.to(dtype) - p_puck
    n = torch.linalg.norm(d)
    hit = V_HIT * d / torch.where(n > 0, n, torch.ones_like(n))
    x_des = torch.cat([p_puck, hit])

    obs = obstacles.to(dtype).reshape(-1, 2)[:N_NEIGHBORS]
    if obs.shape[0] < N_NEIGHBORS:
        pad = torch.full((N_NEIGHBORS - obs.shape[0], 2), 1e3, dtype=dtype,
                         device=dev)
        obs = torch.cat([obs, pad])

    hs = _step_sizes(params, mpc, dtype, dev)
    p1 = state.p1
    U0 = torch.where(p1.valid, p1.U, torch.zeros((), dtype=dtype,
                                                 device=dev))
    route = "lanes" if x_p1.is_cuda else "plain"
    c = solve_candidates(hs[None], U0[None], x_p1[None], x_des[None],
                         obs[None], params, mpc, route)
    k = torch.argmin(c.cost[0])
    U, ok = c.U[0, k], c.conv[0, k]
    new = JointPuckPlayerState(p1=DmpcState(
        U=torch.where(ok, U, p1.U), valid=ok | p1.valid,
        h=torch.where(ok, hs[k], p1.h)))
    return new, U[0:2], torch.zeros(2, dtype=dtype, device=dev)


class JointPuckPlayerMPC:
    """The reference class's host API, on ``device`` in the params'
    dtype."""

    def __init__(self, sim_params: SimParams, mpc: MpcParams | None = None,
                 device="cuda"):
        self.params = sim_params
        self.mpc = mpc or MpcParams()
        self.device = resolve_device(device)
        self.state = initial_state(self.mpc, sim_params.torch_dtype,
                                   self.device)

    def compute_control(self, x_p1, x_p2, x_puck, p_goal, obstacles):
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=self.params.
                                   torch_dtype).to(self.device)

        self.state, u1, u2 = compute_control(
            self.state, t(x_p1), t(x_p2), t(x_puck), t(p_goal),
            t(obstacles), self.params, self.mpc)
        return True, u1.cpu().numpy(), u2.cpu().numpy()

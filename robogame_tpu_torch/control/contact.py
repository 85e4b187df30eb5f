"""Bounce-pass planner: the initial puck velocity that banks off a wall
into the adversary goal.

Counterpart of the JAX package's ``control/contact.py`` (the reference's
ContactOptimizer).  The flight model is the controllers' closed-form
exponential decay

    v(h) = v0 e^{-h/tau},   p(h) = p0 + tau v0 (1 - e^{-h/tau})

(the controller decay 1/tau_puck, not the simulator's 0.2/tau_puck; the
reference's mismatch is kept), with a wall reset map flipping v_y.  Given
the first segment's duration h0, the wall contact fixes v0y, the goal's y
then fixes e^{-h1/tau} in closed form, and the goal's x fixes v0x: a
one-parameter family, evaluated on a grid of H0_GRID values of h0 at once
(elementwise tensor code, no solver), the reference's sign constraints as
feasibility masks, the slowest feasible kick chosen.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimParams, resolve_device

H0_GRID = 64          # candidate first-segment durations


class BouncePlan(NamedTuple):
    success: torch.Tensor   # () bool
    v0: torch.Tensor        # (2,) initial puck velocity
    h: torch.Tensor         # (2,) segment durations (diagnostics)


def bounce_pass_wall(p_puck, p_goal, which_wall: str, params: SimParams,
                     duration: float = 3.0, device="cuda") -> BouncePlan:
    """The reference's ``ContactOptimizer.bounce_pass_wall`` for one puck
    ((2,) position) and goal, off the "up" or "down" wall, on ``device``
    in the params' dtype."""
    if which_wall not in ("up", "down"):
        raise ValueError(f"which_wall must be 'up' or 'down', "
                         f"got {which_wall!r}")
    dev = resolve_device(device)
    dtype = params.torch_dtype
    tau = params.tau_puck
    p0 = torch.as_tensor(p_puck, dtype=dtype).reshape(2).to(dev)
    pg = torch.as_tensor(p_goal, dtype=dtype).reshape(2).to(dev)
    sgn = 1.0 if which_wall == "up" else -1.0
    wy = sgn * (params.arena_y / 2.0 - params.puck_radius)   # contact y

    h0 = torch.linspace(0.02, duration, H0_GRID, dtype=torch.float64).to(
        device=dev, dtype=dtype)
    e0 = torch.exp(-h0 / tau)

    # wall contact: p0y + tau v0y (1 - e0) = wy  ->  v0y(h0)
    v0y = (wy - p0[1]) / (tau * (1.0 - e0))
    # after the bounce v_ay = -v0y e0; goal y: wy - tau v0y e0 (1 - e1) = pgy
    one_m_e1 = (wy - pg[1]) / (tau * v0y * e0)
    e1 = 1.0 - one_m_e1
    valid_e1 = (e1 > 0.0) & (e1 < 1.0)
    e1s = torch.clamp(e1, 1e-9, 1.0 - 1e-9)
    h1 = -tau * torch.log(e1s)
    # goal x: p0x + tau v0x (1 - e0 e1) = pgx  ->  v0x(h0)
    v0x = (pg[0] - p0[0]) / (tau * (1.0 - e0 * e1s))

    # end velocity, for the reference's direction constraints
    v_end_x = v0x * e0 * e1s
    v_end_y = -v0y * e0 * e1s

    goal_right = pg[0] > 0
    feas = (valid_e1 & (h1 > 0) & (h0 + h1 <= duration) &
            # the initial velocity's direction box
            torch.where(goal_right, v0x >= 0, v0x <= 0) &
            (sgn * v0y >= 0) &
            # the end velocity's helper constraints
            (-sgn * v_end_y >= 0.1) &
            torch.where(goal_right, v_end_x >= 0.1, v_end_x <= -0.1))

    # among the feasible candidates the slowest workable kick
    speed2 = torch.where(feas, v0x * v0x + v0y * v0y,
                         torch.full_like(v0x, float("inf")))
    k = torch.argmin(speed2)
    success = feas[k]
    v0 = torch.stack([v0x[k], v0y[k]])
    return BouncePlan(success=success,
                      v0=torch.where(success, v0, torch.zeros_like(v0)),
                      h=torch.stack([h0[k], h1[k]]))


def simulate_bounce(p0, v0, h0, h1, params: SimParams, which_wall: str):
    """The closed-form two-segment flight under the controllers' puck
    model (tensors on one device): the contact point, the end point and
    the end velocity.  Used to check that a plan reaches the goal."""
    tau = params.tau_puck
    e0 = torch.exp(-h0 / tau)
    p_c = p0 + tau * v0 * (1.0 - e0)
    v_c = v0 * e0
    v_a = torch.stack([v_c[0], -v_c[1]])
    e1 = torch.exp(-h1 / tau)
    p_end = p_c + tau * v_a * (1.0 - e1)
    v_end = v_a * e1
    return p_c, p_end, v_end

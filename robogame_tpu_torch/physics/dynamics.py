"""Entity dynamics: damped double integrators integrated with classic RK4.

* player:  pdot = v,  vdot = (u - v)/tau_player + w * N(0,1)  (noise drawn
  independently at every RK4 stage evaluation, players only)
* puck:    pdot = v,  vdot = (u - 0.2 v)/tau_puck  with u == 0

Both laws are one family ``vdot = (u - c v) / tau + noise`` with per-entity
drag c and tau, so one RK4 evaluation advances all entities at once.
"""

from __future__ import annotations

import torch

from ..config import SimParams, resolve_device


def f_all(x, u, tau, drag, stage_noise):
    """x (..., E, 4), u (..., E, 2), tau/drag (E,), stage_noise (..., E, 2)
    -> xdot of x's shape."""
    vel = x[..., 2:4]
    acc = (u - drag[..., :, None] * vel) / tau[..., :, None] + stage_noise
    return torch.cat([vel, acc], dim=-1)


def rk4_step(x, u, dt, tau, drag, noise=None):
    """Classic RK4.  ``noise`` is (4, ..., E, 2), one draw per stage;
    ``dt`` a scalar or a tensor broadcastable to the leading (..., E)
    dims."""
    if noise is None:
        z = torch.zeros_like(u)
        noise = (z, z, z, z)
    dt_ = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    if dt_.ndim > 0:
        dt_ = dt_[..., None]
    k1 = f_all(x, u, tau, drag, noise[0])
    k2 = f_all(x + k1 * (dt_ / 2.0), u, tau, drag, noise[1])
    k3 = f_all(x + k2 * (dt_ / 2.0), u, tau, drag, noise[2])
    k4 = f_all(x + k3 * dt_, u, tau, drag, noise[3])
    return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) * (dt_ / 6.0)


def sample_stage_noise(generator: torch.Generator, shape, w_stdev, dtype,
                       device=None):
    """4 independent stage draws, (4, *shape), from ``generator``."""
    device = generator.device if device is None else device
    return w_stdev * torch.randn((4,) + tuple(shape), generator=generator,
                                 dtype=dtype, device=device)


def exact_player_step(x, u, dt, tau):
    """Exact discretization of pdot = v, vdot = (u - v)/tau for constant u:
    v(t) = u + (v0-u) e^{-t/tau};  p(t) = p0 + u t + tau (v0-u)(1-e^{-t/tau})."""
    p0, v0 = x[..., 0:2], x[..., 2:4]
    e = torch.exp(torch.as_tensor(-dt / tau, dtype=x.dtype,
                                  device=x.device))
    v = u + (v0 - u) * e
    p = p0 + u * dt + tau * (v0 - u) * (1.0 - e)
    return torch.cat([p, v], dim=-1)


def exact_puck_step(x, dt, tau, drag=0.2):
    """Exact free-puck flight, vdot = -(drag/tau) v:
    v(t) = v0 e^{-kt}, p(t) = p0 + v0 (1-e^{-kt})/k with k = drag/tau."""
    k = drag / tau
    p0, v0 = x[..., 0:2], x[..., 2:4]
    e = torch.exp(torch.as_tensor(-k * dt, dtype=x.dtype, device=x.device))
    v = v0 * e
    p = p0 + v0 * (1.0 - e) / k
    return torch.cat([p, v], dim=-1)


def entity_consts(params: SimParams, device="cuda"):
    """(tau, drag, radius, mass) tensors of shape (5,)."""
    dt = params.torch_dtype
    dev = resolve_device(device)
    return tuple(torch.tensor(v, dtype=dt, device=dev)
                 for v in (params.taus, params.drags, params.radii,
                           params.masses))

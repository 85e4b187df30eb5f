"""Centralized control-barrier-function safety filter, batched over games.

Counterpart of the JAX package's ``control/cbf.py`` (the reference's
damped-double-integrator CBF).  It minimally modifies the nominal controls
of the 4 players so that they avoid each other:

    min  ||u - u_nominal||^2
    s.t. hij_dot(u) >= -gain * hij^3        for every approaching pair
         |u| <= input_limit

with barrier

    hij  = (a_max - v_col) * E - a_max,
    E    = exp((|p_ij| + tau*v_col - Ds) / (tau*a_max)),
    v_col = p_ij_unit . v_ij  (negative when approaching),
    a_max = 2 * input_limit.

hij_dot is linear in u_i - u_j, so each game's filter is one QP over its 8
input components (12 pair rows + 8 box rows); all games' QPs solve in one
launch of K2.  Where a game's QP does not converge its nominal controls are
returned unchanged.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import CbfParams, SimParams, resolve_device
from ..ops import qp_lanes

# ordered player pairs (i, j), i != j
_PAIRS = [(i, j) for i in range(4) for j in range(4) if i != j]


class CbfResult(NamedTuple):
    u: torch.Tensor          # (B, 4, 2) safe controls
    converged: torch.Tensor  # (B,) bool (False -> u == u_nominal)


@functools.lru_cache(maxsize=8)
def _pair_index(device: torch.device):
    """Pair endpoints i, j (12,) and the rows' column indices of -k pu and
    k pu (12, 2), made once per device."""
    ii = torch.tensor([a for a, _ in _PAIRS], device=device)
    jj = torch.tensor([b for _, b in _PAIRS], device=device)
    c2 = torch.arange(2, device=device)[None, :]
    return ii, jj, 2 * ii[:, None] + c2, 2 * jj[:, None] + c2


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _build_qp(u_nominal, positions, velocities, params: SimParams,
              cbf: CbfParams):
    """Every game's CBF QP: H (B, 8, 8), g (B, 8), A (B, 20, 8), lo/hi
    (B, 20), and the nominal controls (B, 4, 2) in the working dtype."""
    dtype = params.torch_dtype
    dev = u_nominal.device
    B = u_nominal.shape[0]
    u_nom = u_nominal.to(dtype).reshape(B, 4, 2)
    p = positions.to(dtype).reshape(B, 4, 2)
    v = velocities.to(dtype).reshape(B, 4, 2)

    tau = params.tau_player
    a_max = 2.0 * params.input_limit
    Ds = cbf.safety_radius
    gain = cbf.barrier_gain

    ii, jj, ci, cj = _pair_index(dev)
    pij = p[:, ii] - p[:, jj]                                  # (B, 12, 2)
    vij = v[:, ii] - v[:, jj]
    pn = _norm(pij)
    one = torch.ones((), dtype=dtype, device=dev)
    tau_t = torch.full((), tau, dtype=dtype, device=dev)
    pn_safe = torch.where(pn > 0, pn, one)
    pu = pij / pn_safe[..., None]
    vcol = (pu * vij).sum(-1)
    active = vcol < 0

    E = torch.exp((pn + tau * vcol - Ds) / (tau * a_max))
    vperp2 = (vij * vij).sum(-1) - vcol ** 2
    c0 = E * (-vperp2 / pn_safe +
              (a_max - vcol) / (tau * a_max) *
              (vcol + tau_t / pn_safe * vperp2) +
              vcol / (tau * a_max) * vcol)
    k = E * vcol / (tau * a_max)
    h = (a_max - vcol) * E - a_max

    rows = torch.zeros((B, len(_PAIRS), 8), dtype=dtype, device=dev)
    r12 = torch.arange(len(_PAIRS), device=dev)[:, None]
    rows[:, r12, ci] = -k[..., None] * pu
    rows[:, r12, cj] = k[..., None] * pu
    lo_c = -gain * h ** 3 - c0
    zero = torch.zeros((), dtype=dtype, device=dev)
    rows = torch.where(active[..., None], rows, zero)
    lo_c = torch.where(active, lo_c, -one)
    hi_c = torch.where(active, torch.full((), 1e9, dtype=dtype, device=dev),
                       one)

    lim = params.input_limit
    eye8 = torch.eye(8, dtype=dtype, device=dev)
    A = torch.cat([rows, eye8.expand(B, 8, 8)], dim=1)
    box = torch.full((B, 8), lim, dtype=dtype, device=dev)
    lo = torch.cat([lo_c, -box], dim=1)
    hi = torch.cat([hi_c, box], dim=1)
    H = (2.0 * eye8).expand(B, 8, 8).contiguous()
    g = -2.0 * u_nom.reshape(B, 8)
    return H, g, A, lo, hi, u_nom


def safe_control_batch(u_nominal, positions, velocities, params: SimParams,
                       cbf: CbfParams) -> CbfResult:
    """The filter over a leading game axis: u_nominal, positions and
    velocities (B, 4, 2) on their device; every game's QP in one K2
    launch."""
    H, g, A, lo, hi, u_nom = _build_qp(u_nominal, positions, velocities,
                                       params, cbf)
    sol = qp_lanes.solve_qp_lanes(H, g, A, lo, hi, iters=cbf.qp_iters)
    lim = params.input_limit
    u_safe = sol.x.reshape(-1, 4, 2).clamp(-lim, lim)
    u_out = torch.where(sol.converged[:, None, None], u_safe, u_nom)
    return CbfResult(u=u_out, converged=sol.converged)


def safe_control(u_nominal, positions, velocities, params: SimParams,
                 cbf: CbfParams, device="cuda") -> CbfResult:
    """One game ((4, 2) arrays): :func:`safe_control_batch` at B=1 on
    ``device``; leaves without the batch axis."""
    dev = resolve_device(device)
    dt = params.torch_dtype
    args = [torch.as_tensor(a, dtype=dt).reshape(1, 4, 2).to(dev)
            for a in (u_nominal, positions, velocities)]
    res = safe_control_batch(*args, params, cbf)
    return CbfResult(u=res.u[0], converged=res.converged[0])

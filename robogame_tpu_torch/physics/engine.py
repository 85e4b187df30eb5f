"""Collision detection of the event engine, batched over games.

Counterpart of the JAX package's ``physics/engine.py`` as far as the sweep
engine (:mod:`.sweep`) needs it: the per-entity pending-collision slots,
the guarded division and the vectorized ``GameSim::insertCollisions``
equivalent.  The event engine itself (``step``, ``_update_sim``, the
per-iteration noise) is not ported yet.

Everything runs in the grid's dtype (the params' dtype: f64 in the parity
tests, f32 in production) on the grid's device, with a leading game axis
where JAX ``vmap``s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import INTER_AGENT, SimParams

_INF = 1.0e9  # "no collision" sentinel (the reference's Collision() t)


class _Slots(NamedTuple):
    """Pending earliest collision per detecting entity, each (B, 5)."""
    t: torch.Tensor       # collision time (INF if none)
    j: torch.Tensor       # int64 other entity (-1 for walls)
    ctype: torch.Tensor   # int64 collision type (WALL_* or INTER_AGENT)
    valid: torch.Tensor   # bool


def _safe_div(num, den):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), _INF)


def _detect(grid, base_idx, t0, params: SimParams, radius) -> _Slots:
    """Each entity's first qualifying collision scanning grid columns
    ``base_idx..G``, for all entities at once (the caller masks which
    slots to update).

    grid (B, G+1, 5, 4); base_idx (B, 5) integer; t0 (B,); radius (5,).
    Per column the 9 candidates are the walls UP, DOWN, RIGHT, LEFT, then
    the other entities ascending; the first minimum wins (the reference
    compares with strict <), and a column qualifies when its minimum lies
    less than dt after t0."""
    G = params.grid_points
    dtype = grid.dtype
    dev = grid.device
    dtcol = params.dt_col
    halfx = params.arena_x / 2.0
    halfy = params.arena_y / 2.0

    pos_k = grid[:, 1:, :, 0:2]                 # (B, G, 5, 2) columns 1..G
    pos_m = grid[:, :-1, :, 0:2]                # column k-1
    vel_m = grid[:, :-1, :, 2:4]
    r = radius
    t_m = t0[:, None, None] + dtcol * torch.arange(
        G, dtype=dtype, device=dev)[None, :, None]           # (B, G, 1)

    def wall(axis, sign, bound):
        overlap = sign * pos_k[..., axis] + r >= bound       # (B, G, 5)
        v = vel_m[..., axis]
        approaching = sign * v > 0
        tau = torch.clamp_min(
            _safe_div((bound - r) * sign - pos_m[..., axis], v), 0.0)
        return torch.where(overlap & approaching, t_m + tau, _INF)

    cand_walls = torch.stack([wall(1, 1.0, halfy), wall(1, -1.0, halfy),
                              wall(0, 1.0, halfx), wall(0, -1.0, halfx)],
                             dim=-1)                         # (B, G, 5, 4)

    dp_k = pos_k[:, :, None, :, :] - pos_k[:, :, :, None, :]  # [e, o] = o - e
    dist_k = torch.linalg.vector_norm(dp_k, dim=-1)          # (B, G, 5, 5)
    sigma = r[:, None] + r[None, :]
    overlap_k = dist_k <= sigma
    dp_m = pos_m[:, :, None, :, :] - pos_m[:, :, :, None, :]
    dv_m = vel_m[:, :, None, :, :] - vel_m[:, :, :, None, :]
    b = (dp_m * dv_m).sum(-1)
    dvv = (dv_m * dv_m).sum(-1)
    dpp = (dp_m * dp_m).sum(-1)
    disc = b * b - dvv * (dpp - sigma * sigma)
    ok = overlap_k & (b < 0) & (disc >= 0)
    tau = torch.clamp_min(
        _safe_div(-(b + torch.sqrt(torch.clamp_min(disc, 0.0))), dvv), 0.0)
    t_pair = t_m[..., None] + tau                            # (B, G, 5, 5)
    eye = torch.eye(grid.shape[2], dtype=torch.bool, device=dev)
    cand_pairs = torch.where(ok & ~eye, t_pair, _INF)

    cands = torch.cat([cand_walls, cand_pairs], dim=-1)      # (B, G, 5, 9)
    tmin, cidx = torch.min(cands, dim=-1)     # the first index of the min

    cols = torch.arange(1, G + 1, device=dev)[None, :, None]  # (1, G, 1)
    qualify = ((tmin - t0[:, None, None] < params.dt)
               & (cols >= base_idx[:, None, :]))             # (B, G, 5)
    found = qualify.any(dim=1)
    first = torch.argmax(qualify.to(torch.uint8), dim=1)     # (B, 5)
    sel_t = tmin.gather(1, first[:, None, :])[:, 0]
    sel_c = cidx.gather(1, first[:, None, :])[:, 0]
    is_pair = sel_c >= 4
    return _Slots(
        t=torch.where(found, sel_t, _INF),
        j=torch.where(is_pair, sel_c - 4, -1),
        ctype=torch.where(is_pair, INTER_AGENT, sel_c),
        valid=found,
    )

"""Plain reference of a Monte-Carlo sweep's starts.

Game ``s`` of a sweep (seeds 1..num_runs) starts with its players at
(+-arena_x / 4, +-arena_y / 4), at rest, score, damage and time zero, its
random stream keyed [s, 0], and, with ``randomize_x0``, its puck drawn from
its own CPU generator seeded ``s``: position U(-1, 1) * x0_pos_range, then
velocity U(-v, v), in the configuration's dtype.  Imports nothing of the
program.
"""

from __future__ import annotations

import torch


def players(sp: dict, B: int, dtype) -> torch.Tensor:
    """The players' and a resting puck's start (B, 5, 4)."""
    qx, qy = sp["arena_x"] / 4.0, sp["arena_y"] / 4.0
    x = torch.tensor([[-qx, qy, 0.0, 0.0], [-qx, -qy, 0.0, 0.0],
                      [qx, qy, 0.0, 0.0], [qx, -qy, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 0.0]], dtype=dtype)
    return x.repeat(B, 1, 1)


def sweep_starts(sp: dict, mc: dict, games, dtype=None):
    """The starts of the sweep's games ``games`` (0-based indices) on the
    CPU: (x, score, damage, t, key)."""
    dtype = dtype or getattr(torch, sp["dtype"])
    games = [int(g) for g in games]
    B = len(games)
    x = players(sp, B, dtype)
    if mc["randomize_x0"]:
        pr = torch.tensor(mc["x0_pos_range"], dtype=dtype)
        v = mc["x0_vel_range"]
        for row, game in enumerate(games):
            g = torch.Generator().manual_seed(game + 1)
            pos = (torch.rand(2, generator=g, dtype=dtype) * 2.0 - 1.0) * pr
            vel = torch.rand(2, generator=g, dtype=dtype) * (2.0 * v) - v
            x[row, 4] = torch.cat([pos, vel])
    seeds = torch.tensor(games, dtype=torch.int64) + 1
    return given_starts(sp, x[:, 4], seeds, dtype, x)


def given_starts(sp: dict, puck, seeds, dtype=None, x=None):
    """Starts from given puck states (B, 4) and game seeds (B,)."""
    dtype = dtype or getattr(torch, sp["dtype"])
    B = puck.shape[0]
    if x is None:
        x = players(sp, B, dtype)
        x[:, 4] = puck.to(dtype)
    seeds = torch.as_tensor(seeds, dtype=torch.int64).reshape(B)
    return (x, torch.zeros((B, 2), dtype=torch.int32),
            torch.zeros((B, 4, 4), dtype=dtype), torch.zeros(B, dtype=dtype),
            torch.stack([seeds, torch.zeros_like(seeds)], dim=1))

"""Schedule family ``uniform`` (bench.py's and dist_equiv's): every player
of every game follows its own U(low, high) velocity command a piece, each
piece held for ``hold`` control steps."""

import torch


def table(mix: dict, g: torch.Generator, games: int, n_steps: int, device):
    """(games, pieces, 4, 2) float32 commands and their hold."""
    hold = mix["hold"]
    pieces = -(-n_steps // hold)
    lo, hi = mix["low"], mix["high"]
    u = torch.rand((games, pieces, 4, 2), generator=g, device=device,
                   dtype=torch.float32) * (hi - lo) + lo
    return u, hold

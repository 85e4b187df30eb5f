"""Schedule family ``corner`` (dist_equiv's): all four players of a game
drive at one corner, x and y each drawn from ``values``, for the whole
game."""

import torch


def table(mix: dict, g: torch.Generator, games: int, n_steps: int, device):
    """(games, 1, 4, 2) float32 commands held for the whole game."""
    vals = torch.tensor(mix["values"], dtype=torch.float32, device=device)
    pick = torch.randint(0, len(mix["values"]), (games, 1, 1, 2),
                         generator=g, device=device)
    return vals[pick].expand(games, 1, 4, 2).contiguous(), n_steps

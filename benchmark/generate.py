"""The one traffic generator: it turns a traffic mix's parameters
(``traffic/<mix>.json``) and ``--seed`` into the inputs the program is
handed.  The same seed gives the same inputs; every seed gives the same
sizes.

Kinds of mix:

* ``schedules``: open-loop velocity commands for a sweep of ``games``
  games, a batch-leading table (games, pieces, 4, 2), each piece held for
  ``hold`` control steps.  The mix's ``family`` names the file that draws
  the table, ``generators/<family>.py`` (its ``table(mix, generator,
  games, n_steps, device)``): ``uniform``, ``corner``.  Sweep ``i`` of a
  run gets its own table.
* ``closed_loop_starts``: for episode ``i`` of a closed-loop run, each
  game's puck start (position U(-1, 1) * pos_range, velocity
  U(-vel_range, vel_range)) and its game seed.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import numpy as np
import torch

# a run's draws: a stream per (seed, kind, index), so that sweep i's table
# does not depend on how many sweeps came before it
_KIND = {"schedules": 1, "closed_loop_starts": 2, "sample": 3}


@functools.lru_cache(maxsize=None)
def _family(name: str):
    """``generators/<name>.py``, loaded once."""
    path = Path(__file__).resolve().parent / "generators" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown schedule family {name!r}")
    spec = importlib.util.spec_from_file_location("bench_family_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(seed: int, kind: str, index: int, device) -> torch.Generator:
    """A torch generator on ``device`` for draw ``index`` of ``kind``."""
    ss = np.random.SeedSequence([int(seed), _KIND[kind], int(index)])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def rng(seed: int, kind: str, index: int) -> np.random.Generator:
    """A numpy generator on the host for draw ``index`` of ``kind``."""
    return np.random.default_rng([int(seed), _KIND[kind], int(index)])


def schedule_table(mix: dict, seed: int, index: int, n_steps: int,
                   device, dtype=torch.float32):
    """Sweep ``index``'s table (games, pieces, 4, 2) and its hold, drawn by
    the mix's family (``generators/<family>.py``)."""
    g = generator(seed, "schedules", index, device)
    u, hold = _family(mix["family"]).table(mix, g, mix["games"], n_steps,
                                           device)
    return u.to(dtype), hold


def closed_loop_starts(mix: dict, seed: int, index: int, device,
                       dtype=torch.float32):
    """Episode ``index``'s puck starts (games, 4) and game seeds
    (games,) int64."""
    B = mix["games"]
    g = generator(seed, "closed_loop_starts", index, device)
    pr = torch.tensor(mix["pos_range"], dtype=torch.float32, device=device)
    v = mix["vel_range"]
    pos = (torch.rand((B, 2), generator=g, device=device) * 2.0 - 1.0) * pr
    vel = torch.rand((B, 2), generator=g, device=device) * (2.0 * v) - v
    seeds = torch.randint(1, 2 ** 31 - 1, (B,), generator=g, device=device)
    return torch.cat([pos, vel], dim=1).to(dtype), seeds

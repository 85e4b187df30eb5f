"""Batched Monte-Carlo game sweeps.

All games of a sweep step in lockstep as one batch: a host loop over
control steps, each step one :func:`..physics.exact_step.step_batch`
(the K1 kernel on the card).  Sharding over several cards and per-step
logs are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import SimParams, resolve_device
from ..physics.exact_step import step_batch
from ..state import GameState, initial_state


@dataclasses.dataclass(frozen=True)
class McParams:
    """The reference's MC configuration record."""
    num_runs: int = 4
    T: float = 10.0
    log_prefix: str = "mc_out"
    randomize_x0: bool = False       # extension: random puck initial states
    x0_ball: tuple = (0.0, 0.0, 0.0, 0.0)
    x0_pos_range: tuple = (2.0, 1.0)   # |x|,|y| ranges when randomizing
    x0_vel_range: float = 4.0


class McResult(NamedTuple):
    scores: torch.Tensor    # (B, 2) int32 final scores
    damage: torch.Tensor    # (B, 4, 4)
    t_final: torch.Tensor   # (B,)


def _initial_states(params: SimParams, mc: McParams,
                    device="cuda") -> GameState:
    """Batch of initial states, seeds 1..num_runs.  With randomize_x0 the
    puck of game s is drawn from its own generator seeded s: position
    U(-1,1) * x0_pos_range, velocity U(-v, v)."""
    dev = resolve_device(device)
    seeds = list(range(1, mc.num_runs + 1))
    dt = params.torch_dtype
    if not mc.randomize_x0:
        return initial_state(params, x0_puck=mc.x0_ball, seed=seeds,
                             device=dev)
    pr = torch.tensor(mc.x0_pos_range, dtype=dt)
    v = mc.x0_vel_range
    x0 = []
    for s in seeds:
        g = torch.Generator().manual_seed(s)
        pos = (torch.rand(2, generator=g, dtype=dt) * 2.0 - 1.0) * pr
        vel = torch.rand(2, generator=g, dtype=dt) * (2.0 * v) - v
        x0.append(torch.cat([pos, vel]))
    return initial_state(params, x0_puck=torch.stack(x0), seed=seeds,
                         device=dev)


def _run_batch(states: GameState, params: SimParams, n_steps: int,
               policy: Callable | None, policy_state=None, device="cuda"):
    """``n_steps`` control steps; ``policy`` is an optional
    ``(policy_state, states) -> (policy_state, controls (B, 4, 2))``."""
    dev = resolve_device(device)
    B = states.score.shape[0]
    s, ps = states, policy_state
    zero = torch.zeros((B, 4, 2), dtype=params.torch_dtype, device=dev)
    for _ in range(n_steps):
        if policy is None:
            u = zero
        else:
            ps, u = policy(ps, s)
        s = step_batch(s, u, params, device=dev)
    return s, ps


def monte_carlo(params: SimParams, mc: McParams,
                policy: Callable | None = None, policy_state=None,
                mesh=None, log: bool = False, write_config: bool = False,
                device="cuda") -> McResult:
    """Run the full sweep of ``mc.num_runs`` games for ceil(T/dt) control
    steps on ``device``."""
    if mesh is not None:
        raise NotImplementedError("sharded sweeps are not ported yet")
    if log:
        raise NotImplementedError("per-step logs are not ported yet")
    n_steps = int(np.ceil(mc.T / params.dt))
    states = _initial_states(params, mc, device=device)
    final, _ = _run_batch(states, params, n_steps, policy, policy_state,
                          device=device)
    if write_config:
        write_configuration(params, mc)
    return McResult(scores=final.score, damage=final.damage, t_final=final.t)


def write_configuration(params: SimParams, mc: McParams) -> None:
    """Reference-compatible configuration.txt: 13 scalars, one per line."""
    os.makedirs(mc.log_prefix, exist_ok=True)
    vals = [mc.num_runs, mc.T, params.dt, params.winning_score,
            mc.x0_ball[0], mc.x0_ball[1], mc.x0_ball[2], mc.x0_ball[3],
            params.noise, params.tau_puck, params.tau_player,
            params.player_mass, params.puck_mass]
    with open(os.path.join(mc.log_prefix, "configuration.txt"), "w") as f:
        for v in vals:
            f.write(str(v) + "\n")


def aggregate(res: McResult) -> dict:
    """Cross-game statistics (score/damage moments and win counts)."""
    scores = res.scores.to(torch.float32)
    return dict(
        games=res.scores.shape[0],
        mean_score_a=float(scores[:, 0].mean()),
        mean_score_b=float(scores[:, 1].mean()),
        wins_a=int((res.scores[:, 0] > res.scores[:, 1]).sum()),
        wins_b=int((res.scores[:, 1] > res.scores[:, 0]).sum()),
        mean_total_damage=float(res.damage.sum(dim=(1, 2)).mean()),
    )

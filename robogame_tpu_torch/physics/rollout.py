"""Rollouts: a host loop over control steps, each one
:func:`.step.step_batch` (so every engine runs), with an optional log
record a step.

One game's state is unbatched (x (5, 4), ...) and its records stack to
(T, ...); a batch's state is batch-leading and its records stack to
(T, B, ...), time first, as :func:`..parallel.monte_carlo.monte_carlo`
returns them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import A1, A2, B1, B2, PUCK, SimParams, resolve_device
from ..state import GameState
from .step import batch_of_one, step, step_batch, unbatch


class LogRecord(NamedTuple):
    """One 29-field log record per control step in the reference's binary
    log layout: t, scoreA, scoreB, the positions (2 each) of puck, A1, A2,
    B1, B2, the damage (4 x 4)."""
    t: torch.Tensor          # (...)
    score: torch.Tensor      # (..., 2)
    positions: torch.Tensor  # (..., 5, 2) in log order [puck, A1, A2, B1, B2]
    damage: torch.Tensor     # (..., 4, 4)


_LOG_ORDER = (PUCK, A1, A2, B1, B2)


def log_record(state: GameState) -> LogRecord:
    """The record of a state, unbatched or batch-leading."""
    pos = state.x[..., list(_LOG_ORDER), 0:2]
    return LogRecord(t=state.t, score=state.score, positions=pos,
                     damage=state.damage)


def record_to_f64_row(rec: LogRecord) -> torch.Tensor:
    """Flatten to the 29-double layout the MATLAB readers expect."""
    f64 = torch.float64
    return torch.cat([
        rec.t[..., None].to(f64),
        rec.score.to(f64),
        rec.positions.reshape(rec.positions.shape[:-2] + (10,)).to(f64),
        rec.damage.reshape(rec.damage.shape[:-2] + (16,)).to(f64),
    ], dim=-1)


def stack_records(recs: list) -> LogRecord:
    """A list of records, one a step, stacked along a leading time axis."""
    return LogRecord(*(torch.stack(parts) for parts in zip(*recs)))


def scripted_rollout(state: GameState, controls, params: SimParams,
                     n_steps: int | None = None, log: bool = True,
                     device="cuda"):
    """Roll out a precomputed control schedule (the reference's
    ``test_collisions.py`` workload).  One game: ``state`` unbatched and
    ``controls`` (T, 4, 2); a batch: ``state`` batch-leading and
    ``controls`` (T, B, 4, 2).  Returns (final state, the LogRecord stacked
    over the steps, or None)."""
    dev = resolve_device(device)
    single = state.x.ndim == 2
    s = batch_of_one(state) if single else state
    u_all = torch.as_tensor(controls, dtype=params.torch_dtype, device=dev)
    if single:
        u_all = u_all[:, None]
    n_steps = u_all.shape[0] if n_steps is None else n_steps
    recs = []
    for k in range(n_steps):
        s = step_batch(s, u_all[k], params, device=dev)
        if log:
            recs.append(log_record(s))
    recs = stack_records(recs) if log else None
    if single:
        s = unbatch(s)
        recs = None if recs is None else LogRecord(*(a[:, 0] for a in recs))
    return s, recs


def rollout(state: GameState, policy: Callable, params: SimParams,
            n_steps: int, log: bool = False, policy_state=None,
            device="cuda"):
    """Closed-loop rollout of one game: ``policy(policy_state, game_state)
    -> (policy_state, controls (4, 2))`` every control step.  Returns
    (final state, final policy state, records (T, ...) or None)."""
    s, ps = state, policy_state
    recs = []
    for _ in range(n_steps):
        ps, u = policy(ps, s)
        s = step(s, u, params, device=device)
        if log:
            recs.append(log_record(s))
    return s, ps, stack_records(recs) if log else None


def batch_rollout(states: GameState, controls, params: SimParams,
                  log: bool = False, device="cuda"):
    """:func:`scripted_rollout` of a batch: ``states`` batch-leading,
    ``controls`` (T, B, 4, 2); records (T, B, ...).  (The JAX package
    ``vmap``s over a leading batch axis, so its controls and records are
    (B, T, ...).)"""
    return scripted_rollout(states, controls, params, log=log,
                            device=device)

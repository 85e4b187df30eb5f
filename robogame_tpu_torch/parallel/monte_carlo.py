"""Batched Monte-Carlo game sweeps.

All games of a sweep step in lockstep as one batch: a host loop over
control steps, each step one :func:`..physics.step.step_batch` (on the
card, K1 for ``engine="pallas_exact"``, K6 for ``engine="pallas"``; the
event and sweep engines are plain PyTorch), with a log record a step on
request.  Over a mesh of processes (:mod:`.mesh`, one card each) every
rank steps its own contiguous slice of the batch and the results are
all-gathered, so every rank returns the whole sweep.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import SimParams, resolve_device
from ..physics.rollout import LogRecord, log_record, stack_records
from ..physics.step import step_batch
from ..state import GameState, initial_state
from ..utils.tree import tree_map
from .mesh import BATCH_AXIS, shard_batch


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
               policy: Callable | None, policy_state=None, device="cuda",
               log: bool = False):
    """``n_steps`` control steps; ``policy`` is an optional
    ``(policy_state, states) -> (policy_state, controls (B, 4, 2))``.
    Returns (states, policy state), and with ``log`` the LogRecord of
    every step stacked (T, B, ...) as well."""
    dev = resolve_device(device)
    B = states.score.shape[0]
    s, ps = states, policy_state
    zero = torch.zeros((B, 4, 2), dtype=params.torch_dtype, device=dev)
    recs = []
    for _ in range(n_steps):
        if policy is None:
            u = zero
        else:
            ps, u = policy(ps, s)
        s = step_batch(s, u, params, device=dev)
        if log:
            recs.append(log_record(s))
    if log:
        return s, ps, stack_records(recs)
    return s, ps


def _run_batch_chunked(states: GameState, params: SimParams, n_steps: int,
                       policy: Callable | None, policy_state, device,
                       log: bool, chunk_steps: int):
    """:func:`_run_batch` in host segments of at most ``chunk_steps``
    steps, with one host sync a segment: the carry between segments is the
    state itself, so the results are those of the unchunked run,
    bitwise."""
    dev = resolve_device(device)
    s, ps, parts = states, policy_state, []
    done = 0
    while done < n_steps:
        n = min(chunk_steps, n_steps - done)
        s, ps, *recs = _run_batch(s, params, n, policy, ps, device=dev,
                                  log=log)
        parts.extend(recs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        done += n
    if log:
        return s, ps, LogRecord(*(torch.cat(f) for f in zip(*parts)))
    return s, ps


def _gather(a: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's ``a`` (one shape on all), concatenated along ``dim``
    in rank order, on every rank."""
    parts = [torch.empty_like(a) for _ in range(mesh.size())]
    dist.all_gather(parts, a.contiguous(), group=mesh.get_group(BATCH_AXIS))
    return torch.cat(parts, dim=dim)


def sweep(params: SimParams, mc: McParams, policy: Callable | None = None,
          policy_state=None, mesh=None, log: bool = False,
          chunk_steps: int | None = None, device="cuda"):
    """The sweep of :func:`monte_carlo`, returning the final
    :class:`GameState` of all ``mc.num_runs`` games (and with ``log`` the
    records, else None).

    With ``mesh``, the batch (padded with duplicate games to a multiple of
    the mesh's size) and the policy state's batch-leading tensors are cut
    into one contiguous slice a rank; each rank steps its slice and the
    final states (and records) are all-gathered and cut back to
    ``num_runs``."""
    n_steps = int(np.ceil(mc.T / params.dt))
    states = _initial_states(params, mc, device=device)
    B = mc.num_runs
    if mesh is not None:
        n_pad = -B % mesh.size()
        if n_pad:
            pad_idx = torch.arange(n_pad) % B

            def pad(a):
                if isinstance(a, torch.Tensor) and a.ndim and \
                        a.shape[0] == B:
                    return torch.cat([a, a[pad_idx.to(a.device)]])
                return a

            states = tree_map(pad, states)
            policy_state = tree_map(pad, policy_state)
        states = shard_batch(states, mesh, B + n_pad)
        policy_state = shard_batch(policy_state, mesh, B + n_pad)
    if chunk_steps is not None and chunk_steps < n_steps:
        final, _, *recs = _run_batch_chunked(states, params, n_steps, policy,
                                             policy_state, device, log,
                                             chunk_steps)
    else:
        final, _, *recs = _run_batch(states, params, n_steps, policy,
                                     policy_state, device=device, log=log)
    recs = recs[0] if log else None
    if mesh is not None:
        final = GameState(*(_gather(a, mesh, 0)[:B] for a in final))
        if log:
            recs = LogRecord(*(_gather(a, mesh, 1)[:, :B] for a in recs))
    return final, recs


def monte_carlo(params: SimParams, mc: McParams,
                policy: Callable | None = None, policy_state=None,
                mesh=None, log: bool = False, write_config: bool = False,
                chunk_steps: int | None = None, device="cuda"):
    """Run the full sweep of ``mc.num_runs`` games for ceil(T/dt) control
    steps on ``device``.  Returns the :class:`McResult`, and with ``log``
    ``(result, records)``: the LogRecord of every step, (T, B, ...).

    ``mesh`` (:func:`.mesh.make_mesh`): shard the games over the job's
    processes, one card each; every rank returns the whole result (see
    :func:`sweep`).  ``chunk_steps``: sync with the host after every
    segment of at most this many steps; the results are the same
    bitwise."""
    final, recs = sweep(params, mc, policy, policy_state, mesh, log,
                        chunk_steps, device)
    if write_config:
        write_configuration(params, mc)
    res = McResult(scores=final.score, damage=final.damage, t_final=final.t)
    return (res, recs) if log else res


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

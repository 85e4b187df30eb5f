"""MPC benchmarks: solver throughput, closed-loop game throughput, and one
game's per-step latency against the 50 ms real-time budget.

    python -m robogame_tpu_torch.examples.bench_mpc [--mode throughput]
        [--team dmpc] [--batch 512] [--steps 200] [--N 20] [--t-grid T]
        [--sqp-iters S] [--qp-iters Q] [--engine pallas_exact] [--xla]
        [--cpu]

Modes:

* ``throughput`` (the default): B batched open-loop DMPC solves a call
  (N=20, t_grid 8, 3 SQP iterations of 60 QP iterations), solves/s; all
  candidates in one K3 launch.  ``--xla`` takes the per-agent algorithm
  instead, a cold QP solve an SQP iteration (K2 on the card, the plain
  solver on the CPU), as the JAX driver's flag takes the vmapped
  per-agent solve.
* ``closed-loop``: B full games of ``--team cmpc|dmpc|classical|physics``
  (the controllers plus physics, ``--steps`` control steps): games/s and
  control-steps/s.  CMPC solves on K4, DMPC on K3, classical on K2 behind
  the CBF filter; the physics on K1.
* ``latency``: one game's wall per control step (both teams' solves and
  the physics, a host sync a step, as deployed), its median, p90 and
  largest against the dt = 50 ms budget.  DMPC runs as a batch of one
  (K3); CMPC runs its per-team solve (K5), classical its policy and the
  filter (K2).

Closed-loop and latency run the production ``MpcParams`` and
``engine="pallas_exact"`` by default.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import CbfParams, MpcParams, SimParams, StrategyParams
from ..control import dmpc
from ..control.cbf import safe_control, safe_control_batch
from ..parallel.monte_carlo import McParams, _initial_states, _run_batch
from ..physics.step import step_batch
from ..state import initial_state
from . import add_cpu_flag, driver_device, host, sync
from .matchups import make_team

PROG = "python -m robogame_tpu_torch.examples.bench_mpc"


def _name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def solver_throughput(args, params: SimParams, mpc: MpcParams, dev) -> None:
    B = args.batch
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    x0 = f32(rng.uniform(-1, 1, (B, 4)) * np.array([4, 2, 2, 2]))
    xd = f32(rng.uniform(-1, 1, (B, 4)) * np.array([4, 2, 4, 4]))
    obs = f32(rng.uniform(-1, 1, (B, 3, 2)) * np.array([4, 2]))
    states = dmpc.initial_dmpc_state(mpc, torch.float32, dev, (B,))
    route = ("lanes" if dev.type == "cuda" else "plain") if args.xla \
        else "fused"

    def solve_all(st):
        return dmpc.compute_control_batch(st, x0, xd, obs, params, mpc,
                                          route)

    host(solve_all(states)[1])               # warm-up
    # the reps chained through the warm state, ended with a host fetch
    n_rep = 5
    st = states
    t0 = time.perf_counter()
    for _ in range(n_rep):
        st, u = solve_all(st)
    u = host(u)
    w = (time.perf_counter() - t0) / n_rep
    print(f"{B} DMPC solves (N={args.N}, t_grid={args.t_grid}, "
          f"sqp={args.sqp_iters}x{args.qp_iters}, route {route}) in "
          f"{w * 1e3:.1f} ms on {_name(dev)}  ->  {B / w:,.0f} solves/s",
          flush=True)
    if not np.isfinite(u).all():
        raise RuntimeError("bench_mpc: non-finite controls")


def _batched_policy(team: str, params: SimParams, mpc: MpcParams,
                    strat: StrategyParams, B: int, dev):
    """A ``(carry, states) -> (carry, u (B, 4, 2))`` of both teams of
    ``team`` (classical behind the CBF filter; physics: no controls) and
    its initial carry."""
    kind = "noop" if team == "physics" else team
    init_a, step_a = make_team(kind, -1, params, mpc, strat, B, dev)
    init_b, step_b = make_team(kind, 1, params, mpc, strat, B, dev)
    cbf = CbfParams()

    def policy(carry, s):
        ca, cb = carry
        ca, u_a = step_a(ca, s.x)
        cb, u_b = step_b(cb, s.x)
        u = torch.cat([u_a, u_b], dim=1)
        if team == "classical":
            u = safe_control_batch(u, s.x[:, :4, 0:2], s.x[:, :4, 2:4],
                                   params, cbf).u
        return (ca, cb), u

    return policy, (init_a, init_b)


def closed_loop(args, params: SimParams, mpc: MpcParams,
                strat: StrategyParams, dev) -> None:
    """B full games, the controllers and the physics a step."""
    B, n_steps = args.batch, args.steps
    states = _initial_states(params, McParams(num_runs=B, randomize_x0=True,
                                              x0_vel_range=2.0), device=dev)

    def run_games():
        policy, carry = _batched_policy(args.team, params, mpc, strat, B,
                                        dev)
        final, _ = _run_batch(states, params, n_steps, policy, carry,
                              device=dev)
        host(final.score)
        return final

    t0 = time.perf_counter()
    run_games()
    t_first = time.perf_counter() - t0
    wall = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        final = run_games()
        wall = min(wall, time.perf_counter() - t0)
    print(f"closed-loop {args.team}: B={B} games x {n_steps} steps "
          f"(T={n_steps * params.dt:.0f}s) on {_name(dev)}: "
          f"first {t_first:.1f}s, steady {wall:.2f}s -> "
          f"{B / wall:.2f} games/s, {B * n_steps / wall:,.0f} "
          f"control-steps/s, total goals {int(host(final.score).sum())}, "
          f"damage mean {float(final.damage.sum((1, 2)).mean()):.2f}",
          flush=True)


def _single_controls(team: str, params: SimParams, mpc: MpcParams,
                     strat: StrategyParams, xla: bool, dev):
    """(carry, controls(carry, s) -> (carry, u (4, 2))) of one game, ``s``
    its state as a batch of one."""
    dtype = params.torch_dtype
    if team in ("physics", "dmpc") and not xla:
        # DMPC: both agents' candidates in one K3 launch (the batched team
        # at B=1); physics: no controls
        policy, carry = _batched_policy(team, params, mpc, strat, 1, dev)

        def controls(carry, s):
            carry, u = policy(carry, s)
            return carry, u[0]
        return carry, controls
    if team == "dmpc":
        from ..agents.dmpc_team import initial_team_state, team_step
        init = lambda: initial_team_state(mpc, dtype, dev)
        step = lambda c, x, f: team_step(c, x, f, params, mpc, strat)
    elif team == "cmpc":
        from ..agents.centralized import OFFENSE, team_step
        from ..control.cmpc import initial_cmpc_state
        init = lambda: initial_cmpc_state(mpc, dtype, dev)
        step = lambda c, x, f: team_step(c, x, OFFENSE, f, params, mpc)
    else:
        from ..agents.classical import _map, initial_team_state, team_policy
        init = lambda: _map(lambda a: a[0], initial_team_state(1, dtype,
                                                               dev))
        step = lambda c, x, f: team_policy(c, x, f, params, strat)
    cbf = CbfParams()

    def controls(carry, s):
        x = s.x[0]
        ca, cb = carry
        ca, u_a = step(ca, x, -1)
        cb, u_b = step(cb, x, 1)
        u = torch.cat([u_a, u_b])
        if team == "classical":
            u = safe_control(u, x[:4, 0:2], x[:4, 2:4], params, cbf,
                             device=dev).u
        return (ca, cb), u

    return (init(), init()), controls


def latency(args, params: SimParams, mpc: MpcParams, strat: StrategyParams,
            dev) -> None:
    """One game's control step (controllers and physics), a host sync a
    step, the real-time deployment's shape."""
    carry, controls = _single_controls(args.team, params, mpc, strat,
                                       args.xla, dev)
    s = initial_state(params, x0_puck=[0.0, 0.5, 1.0, 0.0], device=dev)

    def one_step(carry, s):
        carry, u = controls(carry, s)
        s = step_batch(s, u[None], params, device=dev)
        host(s.t)                           # a host sync a step, as deployed
        return carry, s

    carry, s = one_step(carry, s)           # warm-up
    lat = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        carry, s = one_step(carry, s)
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3
    budget = params.dt * 1e3
    verdict = ("REAL-TIME" if np.percentile(lat, 90) < budget
               else "over budget")
    print(f"latency {args.team}: per-step {np.median(lat):.1f} ms median "
          f"(p90 {np.percentile(lat, 90):.1f}, max {lat.max():.1f}) on "
          f"{_name(dev)}; budget {budget:.0f} ms -> {verdict}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--mode", default="throughput",
                    choices=["throughput", "closed-loop", "latency"])
    ap.add_argument("--team", default="dmpc",
                    choices=["cmpc", "dmpc", "classical", "physics"])
    ap.add_argument("--batch", type=int, default=512,
                    help="solver instances / games")
    ap.add_argument("--steps", type=int, default=200,
                    help="game length in control steps (closed-loop), or "
                    "timed steps (latency)")
    ap.add_argument("--N", type=int, default=20)
    ap.add_argument("--t-grid", type=int, default=None,
                    help="default: 8 for throughput, the production "
                    "MpcParams otherwise")
    ap.add_argument("--sqp-iters", type=int, default=None)
    ap.add_argument("--qp-iters", type=int, default=None)
    ap.add_argument("--engine", default="pallas_exact",
                    choices=["event", "sweep", "pallas", "pallas_exact"])
    ap.add_argument("--xla", action="store_true",
                    help="the per-agent DMPC algorithm (a cold QP solve an "
                    "SQP iteration) in place of the fused K3 route")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    # throughput keeps the round-1 metric's configuration; closed-loop and
    # latency run the production MpcParams
    fast = args.mode == "throughput"
    mpc = MpcParams(
        N=args.N,
        t_grid=args.t_grid or (8 if fast else MpcParams.t_grid),
        sqp_iters=args.sqp_iters or (3 if fast else MpcParams.sqp_iters),
        qp_iters=args.qp_iters or (60 if fast else MpcParams.qp_iters))
    args.t_grid, args.sqp_iters, args.qp_iters = (mpc.t_grid, mpc.sqp_iters,
                                                  mpc.qp_iters)
    params = SimParams(dtype="float32", engine=args.engine,
                       winning_score=100)
    strat = StrategyParams()
    if args.mode == "throughput":
        solver_throughput(args, params, mpc, dev)
    elif args.mode == "closed-loop":
        closed_loop(args, params, mpc, strat, dev)
    else:
        latency(args, params, mpc, strat, dev)
    sync(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

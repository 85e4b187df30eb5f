"""DMPC vs DMPC full game: four independent per-agent MPC solves a step
(the reference's test_dmpc.py: T=100 s, dt=0.05, winning score 100, log
"dmpc_game.log").

    python -m robogame_tpu_torch.examples.run_dmpc_sim [--steps 2000]
        [--log dmpc_game.log] [--f64] [--t-grid 8] [--cpu]

Each control step both teams run ``agents.dmpc_team.team_step``: each
agent's ``control.dmpc.compute_control`` at ``MpcParams(t_grid,
sqp_iters=3)``, a cold QP solve of its candidates an SQP iteration (K2 on
the card, the plain solver on the CPU); then one step of the sweep
engine.  The puck starts at rest in the middle.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..agents.dmpc_team import initial_team_state, team_step
from ..config import MpcParams, SimParams, StrategyParams
from ..physics.rollout import log_record, stack_records
from ..physics.step import step, unbatch
from ..state import initial_state
from ..utils.gamelog import write_trajectory_log
from . import add_cpu_flag, driver_device, sync

PROG = "python -m robogame_tpu_torch.examples.run_dmpc_sim"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)  # T = 100 s
    ap.add_argument("--log", default="dmpc_game.log")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--t-grid", type=int, default=8)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    params = SimParams(dt=0.05, winning_score=100, engine="sweep",
                       dtype="float64" if args.f64 else "float32")
    mpc = MpcParams(t_grid=args.t_grid, sqp_iters=3)
    strat = StrategyParams()
    dt = params.torch_dtype
    ts_a = initial_team_state(mpc, dt, dev)
    ts_b = initial_team_state(mpc, dt, dev)
    s = unbatch(initial_state(params, x0_puck=[0.0, 0.0, 0.0, 0.0],
                              device=dev))
    recs = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        ts_a, u_a = team_step(ts_a, s.x, -1, params, mpc, strat)
        ts_b, u_b = team_step(ts_b, s.x, 1, params, mpc, strat)
        s = step(s, torch.cat([u_a, u_b]), params, device=dev)
        recs.append(log_record(s))
    sync(dev)
    wall = time.perf_counter() - t0
    if args.log:
        write_trajectory_log(args.log, stack_records(recs))
    score = s.score.tolist()
    print(f"T={args.steps * params.dt:.0f}s  scores A={score[0]} "
          f"B={score[1]}  wall={wall:.1f}s ({args.steps / wall:.1f} steps/s "
          f"on {dev.type})  log={args.log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

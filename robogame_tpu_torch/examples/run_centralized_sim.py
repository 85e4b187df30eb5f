"""CentralizedTeam vs CentralizedTeam game: one joint two-player MPC a
team (the reference's run_centralized_sim.py, T=10 s, dt=0.05).

    python -m robogame_tpu_torch.examples.run_centralized_sim
        [--steps 200] [--log centralized_game.log] [--f64] [--t-grid 8]
        [--cpu]

Each control step both teams run ``agents.centralized.team_step`` with
the OFFENSE play (CentralizedTeam.py:14-18): ``control.cmpc.
compute_control`` at ``MpcParams(t_grid, sqp_iters=3)``, a cold joint QP
solve of the candidates an SQP iteration (K5 on the card, the plain
solver on the CPU); then one step of the sweep engine.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..agents.centralized import OFFENSE, team_step
from ..config import MpcParams, SimParams
from ..control.cmpc import initial_cmpc_state
from ..physics.rollout import log_record, stack_records
from ..physics.step import step, unbatch
from ..state import initial_state
from ..utils.gamelog import write_trajectory_log
from . import add_cpu_flag, driver_device, host, sync

PROG = "python -m robogame_tpu_torch.examples.run_centralized_sim"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)   # T = 10 s
    ap.add_argument("--log", default="centralized_game.log")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--t-grid", type=int, default=8)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    params = SimParams(dt=0.05, winning_score=100, engine="sweep",
                       dtype="float64" if args.f64 else "float32")
    mpc = MpcParams(t_grid=args.t_grid, sqp_iters=3)
    dt = params.torch_dtype
    cs_a = initial_cmpc_state(mpc, dt, dev)
    cs_b = initial_cmpc_state(mpc, dt, dev)
    s = unbatch(initial_state(params, x0_puck=[0.0, 0.0, 0.0, 0.0],
                              device=dev))
    recs = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        cs_a, u_a = team_step(cs_a, s.x, OFFENSE, -1, params, mpc)
        cs_b, u_b = team_step(cs_b, s.x, OFFENSE, 1, params, mpc)
        s = step(s, torch.cat([u_a, u_b]), params, device=dev)
        recs.append(log_record(s))
    sync(dev)
    wall = time.perf_counter() - t0
    if args.log:
        write_trajectory_log(args.log, stack_records(recs))
    score = s.score.tolist()
    print(f"T={args.steps * params.dt:.0f}s  scores A={score[0]} "
          f"B={score[1]}  puck={np.round(host(s.x[4, 0:2]), 2)}  "
          f"wall={wall:.1f}s ({args.steps / wall:.1f} steps/s on "
          f"{dev.type})  log={args.log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Classical vs classical 2v2 game behind the centralized CBF safety
filter (the reference's run_sim.py: T=20 s, dt=0.05, winning score 4, the
puck at (-1, 0), binary log "minimal_game.log").

    python -m robogame_tpu_torch.examples.run_sim [--steps 400]
        [--log minimal_game.log] [--f64] [--cpu]

The reference-shaped host loop: each control step both
``ClassicalTeam``s plan on the game's state (their skills' QPs on K2 on
the card), ``safe_control`` filters the four nominal controls (K2), and
``GameSim.run`` steps the sweep engine and logs the step while the game
is undecided.  (``--host-loop`` is accepted for the JAX driver's command
lines: this loop is the only path here, there being no fused program to
compile.)
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..agents.classical import ClassicalTeam
from ..config import CbfParams, SimParams, StrategyParams
from ..control.cbf import safe_control
from ..sim import GameSim
from ..state import SimStateView
from . import add_cpu_flag, driver_device, host

PROG = "python -m robogame_tpu_torch.examples.run_sim"


def host_loop_game(params: SimParams, strat: StrategyParams, cbf: CbfParams,
                   n_steps: int, x0_ball, logname: str, dev):
    """The reference's loop (run_sim.py:56-75) over ``GameSim``; returns
    the final 22-vector."""
    sim = GameSim(params, device=dev)
    vec = sim.reset(dt=params.dt, winning_score=params.winning_score,
                    x0_ball=x0_ball, log=bool(logname),
                    logname=logname or "minimal_game.log")
    home = ClassicalTeam(params, -1, "A", strat, device=dev)
    away = ClassicalTeam(params, 1, "B", strat, device=dev)
    try:
        for _ in range(n_steps):
            view = SimStateView(vec)
            vel_a1, vel_a2 = home.run(view)
            vel_b1, vel_b2 = away.run(view)
            u_nom = np.stack([vel_a1, vel_a2, vel_b1, vel_b2])
            x = view.entity_array
            u = host(safe_control(u_nom, x[:4, 0:2], x[:4, 2:4], params, cbf,
                                  device=dev).u)
            vec = sim.run(u[0], u[1], u[2], u[3])
    finally:
        sim.close()
    return vec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)   # T = 20 s
    ap.add_argument("--log", default="minimal_game.log")
    ap.add_argument("--host-loop", action="store_true",
                    help="accepted; the host loop is the only path")
    ap.add_argument("--f64", action="store_true")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    params = SimParams(dt=0.05, winning_score=4, engine="sweep",
                       dtype="float64" if args.f64 else "float32")
    t0 = time.perf_counter()
    vec = host_loop_game(params, StrategyParams(), CbfParams(), args.steps,
                         [-1.0, 0.0, 0.0, 0.0], args.log, dev)
    wall = time.perf_counter() - t0
    print(f"T={args.steps * params.dt:.0f}s  scores A={vec[0]:.0f} "
          f"B={vec[1]:.0f}  puck={np.round(vec[2:4], 2)}  wall={wall:.1f}s "
          f"({args.steps / wall:.1f} steps/s on {dev.type})  log={args.log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

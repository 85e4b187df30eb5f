"""Bounce-kick demonstration: bank the puck off a wall into the goal (the
reference's bounce_kick_up.mp4 / bounce_kick_down.mp4;
``ClassicalPlayer.bounce_kick``, which needs tau_puck >= 1).

    python -m robogame_tpu_torch.examples.bounce_kick_demo [--wall up|down]
        [--log bounce_kick.log] [--steps 120] [--cpu]

The contact planner solves for the puck velocity that banks off the
chosen wall into the adversary goal, the trajectory optimizer drives A2
to impart it through the elastic reset map, and ``GameSim`` (the sweep
engine, f32) plays it out.  Exits 0 on a goal, 1 when the shot cannot be
planned, 2 when no goal falls within ``--steps``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..agents.classical import ClassicalPlayer
from ..config import SimParams
from ..sim import GameSim
from ..state import SimStateView
from . import add_cpu_flag, driver_device

PROG = "python -m robogame_tpu_torch.examples.bounce_kick_demo"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--wall", default="up", choices=["up", "down"])
    ap.add_argument("--log", default="bounce_kick.log")
    ap.add_argument("--steps", type=int, default=120)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    # tau_puck = 1.0: the bounce_kick regime (the reference's run_sim.py:20)
    params = SimParams(dt=0.05, winning_score=1, tau_puck=1.0,
                       engine="sweep", dtype="float32")
    sim = GameSim(params, device=dev)
    vec = sim.reset(dt=params.dt, winning_score=1, tau_puck=1.0,
                    x0_ball=[-1.0, 0.0, 0.0, 0.0], log=bool(args.log),
                    logname=args.log)
    try:
        player = ClassicalPlayer(params, -1, "A", 2, device=dev)
        ok = player.bounce_kick(SimStateView(vec), args.wall)
        print(f"bounce_kick({args.wall}) planned: {ok}")
        if not ok:
            return 1
        z = np.zeros(2)
        for k in range(args.steps):
            u, _ = player.get_control()
            vec = sim.run(z, u, z, z)                  # A2 is the kicker
            if vec[0] >= 1:
                print(f"GOAL via {args.wall}-wall bank at "
                      f"t={k * params.dt:.2f}s  puck path logged to "
                      f"{args.log}")
                return 0
    finally:
        sim.close()
    print(f"no goal within {args.steps * params.dt:.0f}s "
          f"(final puck: {vec[2:6]})")
    return 2


if __name__ == "__main__":
    sys.exit(main())

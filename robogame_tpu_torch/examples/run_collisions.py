"""Physics-only regression driver: replay per-player velocity schedules
through the event engine with logging on (the reference's
test_collisions.py).

    python -m robogame_tpu_torch.examples.run_collisions [--dir DIR]
        [--log collision_test.log] [--f64] [--cpu]

Reads whitespace-separated schedules A1.txt A2.txt B1.txt B2.txt from
``--dir`` (one "vx vy" row a control step) and replays them with
``scripted_rollout`` on ``engine="event"``, the puck at (-1, 0) and
winning_score 100; with no schedule files present, a built-in
demonstration schedule of 200 steps.  Writes the reference's binary log,
29 doubles a step.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..config import SimParams
from ..physics.rollout import scripted_rollout
from ..physics.step import unbatch
from ..state import initial_state
from ..utils.gamelog import write_trajectory_log
from . import add_cpu_flag, driver_device, sync

PROG = "python -m robogame_tpu_torch.examples.run_collisions"


def load_schedules(d: str):
    """(T, 4, 2) from A1.txt..B2.txt in ``d``, cut to the shortest; None
    when a file is missing."""
    paths = [os.path.join(d, n) for n in ("A1.txt", "A2.txt", "B1.txt",
                                          "B2.txt")]
    if not all(os.path.exists(p) for p in paths):
        return None
    cols = [np.loadtxt(p).reshape(-1, 2) for p in paths]
    n = min(c.shape[0] for c in cols)
    return np.stack([c[:n] for c in cols], axis=1)


def demo_schedule(n_steps: int = 200) -> np.ndarray:
    t = np.arange(n_steps) * 0.05
    s = np.zeros((n_steps, 4, 2))
    s[:, 0, 0] = 6.0                  # A1 charges right into the puck
    s[:, 2] = np.stack([3 * np.cos(t), 3 * np.sin(t)], axis=1)  # B1 swirls
    s[:, 3, 0] = -2.0
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--dir", default=".")
    ap.add_argument("--log", default="collision_test.log")
    ap.add_argument("--f64", action="store_true")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    sched = load_schedules(args.dir)
    if sched is None:
        print("no A1.txt..B2.txt found; using built-in demo schedule")
        sched = demo_schedule()

    params = SimParams(dt=0.05, winning_score=100,
                       dtype="float64" if args.f64 else "float32")
    s0 = unbatch(initial_state(params, x0_puck=[-1.0, 0.0, 0.0, 0.0],
                               device=dev))
    t0 = time.perf_counter()
    final, recs = scripted_rollout(s0, sched, params, log=True, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    write_trajectory_log(args.log, recs)
    score = final.score.tolist()
    print(f"{sched.shape[0]} steps  scores A={score[0]} B={score[1]}  "
          f"wall={wall:.1f}s ({sched.shape[0] / wall:.1f} steps/s on "
          f"{dev.type})  log={args.log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

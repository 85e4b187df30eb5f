"""Monte-Carlo sweep: classical vs classical WITH the CBF safety filter
(the reference's mc_example_1.py).

    python -m robogame_tpu_torch.examples.mc_example_1 [--runs 4] [--T 10]
        [--no-cbf] [--out mc_out_torch] [--no-logs] [--cpu]

All games run in lockstep as one batch (``monte_carlo`` on the sweep
engine, both teams' skills and the CBF filter on K2 on the card), where
the reference runs them one after another (MonteCarlo.py:23-45).  Writes
configuration.txt and one reference-format binary log a game under
``--out``.  ``--no-cbf`` is mc_example_2.  The default output directory
is the port's own, so that no run rewrites the JAX package's tracked
``mc_out/``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..agents.classical import classical_matchup
from ..config import CbfParams, SimParams, StrategyParams
from ..parallel.monte_carlo import McParams, aggregate, monte_carlo
from ..utils.gamelog import GameLogWriter, rows_from_states
from . import add_cpu_flag, driver_device, host

PROG = "python -m robogame_tpu_torch.examples.mc_example_1"


def main(argv=None, prog: str = PROG) -> int:
    ap = argparse.ArgumentParser(prog=prog, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--T", type=float, default=10.0)
    ap.add_argument("--no-cbf", action="store_true")
    ap.add_argument("--out", default="mc_out_torch")
    ap.add_argument("--no-logs", action="store_true")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, prog)

    params = SimParams(dt=0.05, winning_score=4, engine="sweep")
    mc = McParams(num_runs=args.runs, T=args.T, log_prefix=args.out,
                  x0_ball=(-1.0, 0.0, 0.0, 0.0))
    B = args.runs
    policy, ps0 = classical_matchup(
        params, B, StrategyParams(), None if args.no_cbf else CbfParams(),
        device=dev)
    t0 = time.perf_counter()
    res, recs = monte_carlo(params, mc, policy=policy, policy_state=ps0,
                            log=True, write_config=True, chunk_steps=100,
                            device=dev)
    stats = aggregate(res)
    wall = time.perf_counter() - t0
    n_steps = int(np.ceil(args.T / params.dt))
    print(f"{B} games x {n_steps} steps in {wall:.1f}s "
          f"({B * n_steps / wall:.0f} steps/s on {dev.type})")
    print("aggregate:", stats)

    if not args.no_logs:
        os.makedirs(args.out, exist_ok=True)
        t, score, pos, dmg = (host(a) for a in (recs.t, recs.score,
                                                recs.positions, recs.damage))
        for i in range(B):
            rows = rows_from_states(t[:, i], score[:, i], pos[:, i],
                                    dmg[:, i])
            with GameLogWriter(os.path.join(args.out,
                                            f"mc_run_{i + 1}.log")) as w:
                w.write_rows(rows)
        print(f"wrote {B} logs + configuration.txt under {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())

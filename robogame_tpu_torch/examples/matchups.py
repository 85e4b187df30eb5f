"""The reference's matchup record, reproduced statistically.

The reference's record of expected behavior is its ``videos/`` matchups
(bl_vs_bl_4.mp4, dmpc_vs_cmpc_4.mp4, dmpc_vs_cmpc_cbf_4.mp4, single
games) and the mc_example_1/2 sweeps whose score and damage histograms
matlab/interpret_mc_results.m:52-96 plots.  Here every matchup is a
batched sweep through ``monte_carlo`` and the record's qualitative
invariants are checked:

* controllers play: games produce goals;
* the centralized CBF filter reduces collision damage (mc_example_1 vs
  mc_example_2; DMPC vs CMPC with and without it);
* DMPC beats a team that does nothing.

The teams follow the reference's harnesses: classical
(py/mc_example_1.py:44), CMPC (py/run_centralized_sim.py:40-58), DMPC
(py/test_dmpc.py:33-47); the optional CBF is the reference's centralized
four-player filter over both teams' nominal controls
(py/MonteCarlo.py:41-43).

    python -m robogame_tpu_torch.examples.matchups [--runs 64] [--T 20]
        [--quick] [--only classical_cbf,...] [--json out.json]
        [--chunk 100] [--engine pallas_exact] [--no-check] [--cpu]

Each matchup prints one JSON record; on the card a comment line with the
kernels' launches of its run follows it.  Exits 1 when an invariant
fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..config import CbfParams, MpcParams, SimParams, StrategyParams
from ..control.cbf import safe_control_batch
from ..parallel.monte_carlo import McParams, monte_carlo
from . import add_cpu_flag, driver_device, host

PROG = "python -m robogame_tpu_torch.examples.matchups"

# (name, team_a, team_b, cbf): the reference's recorded matchups
MATCHUPS = [
    ("classical_cbf",   "classical", "classical", True),   # mc_example_1
    ("classical_nocbf", "classical", "classical", False),  # mc_example_2
    ("cmpc_vs_cmpc",    "cmpc",      "cmpc",      False),  # bl_vs_bl_4
    ("dmpc_vs_cmpc",    "dmpc",      "cmpc",      False),  # dmpc_vs_cmpc_4
    ("dmpc_vs_cmpc_cbf", "dmpc",     "cmpc",      True),   # ..._cbf_4
    ("dmpc_vs_noop",    "dmpc",      "noop",      False),  # sanity: scores
]


def make_team(kind: str, field: int, params: SimParams, mpc: MpcParams,
              strat: StrategyParams, B: int, dev):
    """(initial carry of B games, step(carry, x (B, 5, 4)) -> (carry,
    u (B, 2, 2))) for one team of ``kind`` on side ``field``: classical on
    K2, CMPC on K4, DMPC on K3 on the card (their plain versions on the
    CPU)."""
    dtype = params.torch_dtype
    if kind == "classical":
        from ..agents.classical import initial_team_state, team_policy_batch
        return (initial_team_state(B, dtype, dev),
                lambda ts, x: team_policy_batch(ts, x, field, params,
                                                strat))
    if kind == "cmpc":
        from ..agents.centralized import OFFENSE, team_step_batch
        from ..control.cmpc import initial_cmpc_state
        return (initial_cmpc_state(mpc, dtype, dev, (B,)),
                lambda cs, x: team_step_batch(cs, x, OFFENSE, field, params,
                                              mpc))
    if kind == "dmpc":
        from ..agents.dmpc_team import initial_team_state, team_step_batch
        return (initial_team_state(mpc, dtype, dev, (B,)),
                lambda ts, x: team_step_batch(ts, x, field, params, mpc,
                                              strat))
    if kind == "noop":
        return (None, lambda ts, x: (ts, torch.zeros(
            (x.shape[0], 2, 2), dtype=x.dtype, device=x.device)))
    raise ValueError(kind)


def make_policy(kind_a: str, kind_b: str, use_cbf: bool, params: SimParams,
                mpc: MpcParams, strat: StrategyParams, cbf: CbfParams,
                B: int, dev):
    """A ``monte_carlo`` policy of team A (field -1) against team B (+1),
    behind the CBF filter over all four players when ``use_cbf``, and its
    initial state."""
    init_a, step_a = make_team(kind_a, -1, params, mpc, strat, B, dev)
    init_b, step_b = make_team(kind_b, 1, params, mpc, strat, B, dev)

    def policy(carry, states):
        ca, cb = carry
        ca, u_a = step_a(ca, states.x)
        cb, u_b = step_b(cb, states.x)
        u = torch.cat([u_a, u_b], dim=1)                    # (B, 4, 2)
        if use_cbf:
            u = safe_control_batch(u, states.x[:, :4, 0:2],
                                   states.x[:, :4, 2:4], params, cbf).u
        return (ca, cb), u

    return policy, (init_a, init_b)


def launch_totals() -> dict:
    """Launches of each kernel since ``kernels.reset_launches()``: K1 and
    K6 in launches (a two-phase step makes two), K2 with its grouped and
    listed launches, D the draw kernel's."""
    k2 = (kernels.qp_launches, kernels.qp_grouped_launches,
          kernels.qp_listed_launches)
    return {"K1": sum(kernels.launches.values()),
            "K2": sum(sum(c.values()) for c in k2),
            "K3": sum(kernels.sqp_launches.values()),
            "K4": sum(kernels.cmpc_launches.values()),
            "K5": sum(kernels.joint_launches.values()),
            "K6": sum(kernels.parallel_launches.values()),
            "D": sum(kernels.noise_launches.values())}


def record(name: str, scores: np.ndarray, damage: np.ndarray, T: float,
           wall: float, n_steps: int) -> dict:
    """The JAX driver's record of one matchup: scores (B, 2), damage
    (B, 4, 4)."""
    B = scores.shape[0]
    dmg = damage.sum((1, 2))
    return dict(
        matchup=name, games=B, T=T,
        goals_a=float(scores[:, 0].mean()),
        goals_b=float(scores[:, 1].mean()),
        wins_a=int((scores[:, 0] > scores[:, 1]).sum()),
        wins_b=int((scores[:, 1] > scores[:, 0]).sum()),
        draws=int((scores[:, 0] == scores[:, 1]).sum()),
        damage_mean=float(dmg.mean()), damage_std=float(dmg.std()),
        damage_hist=np.histogram(dmg, bins=8)[0].tolist(),
        score_hist_a=np.bincount(scores[:, 0], minlength=5).tolist(),
        score_hist_b=np.bincount(scores[:, 1], minlength=5).tolist(),
        wall_s=round(wall, 1),
        games_per_s=round(B / wall, 2),
        steps_per_s=round(B * n_steps / wall, 1),
    )


def run_matchup(name: str, kind_a: str, kind_b: str, use_cbf: bool, args,
                params: SimParams, mpc: MpcParams, strat: StrategyParams,
                cbf: CbfParams, dev) -> dict:
    B = args.runs
    mc = McParams(num_runs=B, T=args.T, randomize_x0=True,
                  x0_pos_range=(1.0, 0.5), x0_vel_range=2.0)
    policy, ps0 = make_policy(kind_a, kind_b, use_cbf, params, mpc, strat,
                              cbf, B, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = monte_carlo(params, mc, policy=policy, policy_state=ps0,
                      chunk_steps=args.chunk, device=dev)
    scores = host(res.scores)
    wall = time.perf_counter() - t0
    out = record(name, scores.astype(np.int64), host(res.damage), args.T,
                 wall, int(np.ceil(args.T / params.dt)))
    print(json.dumps(out), flush=True)
    if dev.type == "cuda":
        print(f"# {name} kernel launches: {json.dumps(launch_totals())}",
              flush=True)
    return out


def invariant_failures(r: dict) -> list:
    """The names of the record's qualitative invariants that fail, given
    the records of all six matchups by name."""
    total = lambda m: r[m]["goals_a"] + r[m]["goals_b"]
    checks = [
        # the CBF filter reduces collision damage (mc_example_1 vs 2)
        ("CBF damage", r["classical_cbf"]["damage_mean"]
         < r["classical_nocbf"]["damage_mean"]),
        ("CBF damage (mpc)", r["dmpc_vs_cmpc_cbf"]["damage_mean"]
         < r["dmpc_vs_cmpc"]["damage_mean"]),
        # controllers actually score
        ("classical scores", total("classical_nocbf") > 0),
        ("dmpc scores", r["dmpc_vs_noop"]["goals_a"] > 0),
    ]
    return [name for name, ok in checks if not ok]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--runs", type=int, default=64)
    ap.add_argument("--T", type=float, default=20.0)
    ap.add_argument("--quick", action="store_true",
                    help="8 games x 5 s (a smoke run)")
    ap.add_argument("--only", default=None,
                    help="comma-separated matchup names")
    ap.add_argument("--json", default=None, help="write results here")
    ap.add_argument("--chunk", type=int, default=100,
                    help="control steps between host syncs (the results "
                    "are the same bitwise)")
    ap.add_argument("--engine", default="pallas_exact",
                    choices=["event", "sweep", "pallas", "pallas_exact"],
                    help="the physics engine (default pallas_exact: K1 on "
                    "the card, its plain version on the CPU)")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the qualitative invariants")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)
    if args.quick:
        args.runs, args.T = 8, 5.0

    params = SimParams(dt=0.05, winning_score=4, engine=args.engine)
    mpc, strat, cbf = MpcParams(), StrategyParams(), CbfParams()
    names = (args.only.split(",") if args.only
             else [m[0] for m in MATCHUPS])
    results = {}
    for name, ka, kb, use_cbf in MATCHUPS:
        if name in names:
            results[name] = run_matchup(name, ka, kb, use_cbf, args, params,
                                        mpc, strat, cbf, dev)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)

    if not args.no_check and not args.only:
        failed = invariant_failures(results)
        if failed:
            print(f"# qualitative invariants: FAIL {failed}", flush=True)
            return 1
        print("# qualitative invariants: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

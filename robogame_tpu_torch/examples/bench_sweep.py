"""Batch-size and noise sweep of the Monte-Carlo physics benchmark.

    python -m robogame_tpu_torch.examples.bench_sweep [--quick] [--cpu]

bench.py's workload: B independent games, each driven by its own
piecewise-constant schedule (U(-8, 8), held for 10 control steps), full
20 s games (400 steps) with winning_score 4, so the decided-game freeze is
live; two-phase compact-and-resume.  Rows at B in {256, 2048, 8192} on
``pallas_exact`` (K1) and ``pallas`` (K6), then the stochastic rows
(noise 1.0, the draw kernel) at B=2048.  ``--quick``: B in {256, 2048},
40 steps.  Each row is timed after a warm-up run, the best of three groups
of two runs from the same starts, each group ended with a host fetch (CUDA
events on the card, the host clock on the CPU), and printed as the JAX
driver's JSON record, ``vs_ref`` against the compiled reference's 18,000
control-steps/s on one CPU core (a CPU figure).  These are records, not
the headline benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..config import SimParams
from ..parallel.monte_carlo import McParams, _initial_states
from ..physics.step import step_batch
from . import add_cpu_flag, driver_device, host, time_call

PROG = "python -m robogame_tpu_torch.examples.bench_sweep"
REFERENCE_STEPS_PER_SEC = 18_000.0  # compiled C++ reference, 1 CPU core
HOLD = 10                           # schedule piece length in control steps
SIZES, N_STEPS = (256, 2048, 8192), 400
QUICK_SIZES, QUICK_STEPS = (256, 2048), 40
NOISE_B = 2048                      # the stochastic rows' batch


def make_run(engine: str, b: int, n_steps: int, stochastic: bool = False,
             device="cuda"):
    """(params, run): ``run(states, u_base)`` steps the games ``n_steps``
    control steps on ``engine``, game g at step k under ``u_base[k //
    HOLD, g]``, and returns the final states."""
    params = SimParams(dtype="float32", engine=engine, winning_score=4,
                       stochastic=stochastic,
                       noise=1.0 if stochastic else 0.0,
                       two_phase=engine.startswith("pallas"),
                       phase1_iters=1, compact_frac=16)

    def run(states, u_base):
        s = states
        for k in range(n_steps):
            s = step_batch(s, u_base[k // HOLD], params, device=device)
        return s

    return params, run


def make_inputs(b: int, n_steps: int, device="cuda"):
    """Seeds 1..b with random pucks, and the schedules (n_steps / HOLD, b,
    4, 2) drawn U(-8, 8) from a generator seeded 0."""
    states = _initial_states(SimParams(dtype="float32"),
                             McParams(num_runs=b, randomize_x0=True),
                             device=device)
    g = torch.Generator().manual_seed(0)
    u_base = torch.rand(((n_steps + HOLD - 1) // HOLD, b, 4, 2),
                        generator=g) * 16.0 - 8.0
    return states, u_base.to(device)


def time_run(run, states, u_base, reps: int = 2, groups: int = 3) -> float:
    """Seconds a run of full games from ``states``: after a warm-up run,
    the best of ``groups`` groups of ``reps`` runs, each group's time
    ended with a host fetch.  (The JAX driver chains the runs, each from
    the previous one's final state, to serialize them through its TPU
    runtime; here every run starts from the same states, so a row times
    the same 400-step games as the headline workload.)"""
    s = run(states, u_base)
    host(s.score)                           # warm-up

    def group():
        for _ in range(reps - 1):
            run(states, u_base)
        return run(states, u_base)
    return min(time_call(group, s.score.device)[0] / reps
               for _ in range(groups))


def row(engine: str, b: int, n_steps: int, stochastic: bool, dev) -> dict:
    _, run = make_run(engine, b, n_steps, stochastic, dev)
    states, u_base = make_inputs(b, n_steps, dev)
    sps = b * n_steps / time_run(run, states, u_base)
    out = dict(B=b, engine=engine, noise=1.0 if stochastic else 0.0,
               steps_per_sec=round(sps, 1),
               vs_ref=round(sps / REFERENCE_STEPS_PER_SEC, 2))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="B in {256, 2048}, 40 steps")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)
    sizes, n_steps = ((QUICK_SIZES, QUICK_STEPS) if args.quick
                      else (SIZES, N_STEPS))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# bench_sweep: {n_steps} steps a game on {name}", flush=True)
    for engine in ("pallas_exact", "pallas"):
        for b in sizes:
            row(engine, b, n_steps, False, dev)
    # the stochastic rows at the headline batch size
    for engine in ("pallas", "pallas_exact"):
        row(engine, NOISE_B, n_steps, True, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

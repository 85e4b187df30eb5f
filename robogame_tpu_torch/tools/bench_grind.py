"""Corner-grind against uniform ablation of the step kernels.

    python -m robogame_tpu_torch.tools.bench_grind [--batch 2048]
        [--steps 40] [--reps 3] [--families corner,uniform]
        [--engine pallas_exact|pallas] [--two-phase] [--cpu]

The corner family (all four players driven into one corner all game,
``dist_equiv.make_sched``) grinds K1's event loop at its cap, one wall
event after another; the uniform family is the Monte-Carlo mix, where
most steps finish in one loop iteration.  One-phase (the default) runs
every game's loop in one launch; ``--two-phase`` runs the export, one
host fetch of the pending count, and the resume over the pending games.
``--engine pallas`` runs K6 instead of K1 (``--engine pallas_exact``).

A row per family, the JAX tool's: ``family engine two_phase B steps/s
best all dmg_ck``, where ``dmg_ck`` sums the warm-up run's final damage.
Method: a warm-up run of ``--steps`` steps from the family's starts, then
``--reps`` runs, each from the warm-up run's final states (so each times
the same work: on corner, games piled up in their corners), each timed by
CUDA events and closed by a host fetch (the host clock on the CPU).  On
K1 the row adds ``cap_steps`` and ``cap_games``: the share of game-steps
of a timed run whose loop reached the cap, and of games that reached it
at some step (a one-phase K1 run, meta row 3, after the timing).

(The JAX tool's ``--detect`` forced a TPU-specific detect variant, and
its timing subtracted a TPU dispatch constant; neither has a
counterpart here.)
"""

from __future__ import annotations

import argparse
import sys
import zlib

import torch

from ..config import SimParams
from ..examples import add_cpu_flag, driver_device, host, time_call
from ..physics import exact_step as ex
from ..physics.step import step_batch
from . import dist_equiv

PROG = "python -m robogame_tpu_torch.tools.bench_grind"


def workload(family: str, B: int, n_steps: int, params: SimParams, dev):
    """The family's starts (seeds 1..B, random pucks) and its (n_steps, B,
    4, 2) schedule on ``dev``, seeded by ``zlib.crc32`` of its name as in
    the JAX tools."""
    states = dist_equiv.make_states(B, params, dev)
    sched = dist_equiv.make_sched(family, B, n_steps,
                                  seed=zlib.crc32(family.encode()) % 2**31)
    return states, torch.as_tensor(sched, device=dev)


def rollout(states, sched, params: SimParams, dev):
    s = states
    for u in sched:
        s = step_batch(s, u, params, device=dev)
    return s


def bench(params: SimParams, family: str, B: int, n_steps: int, reps: int,
          dev):
    """(seconds of each timed run, the warm-up run's final states, the
    schedule): a warm-up run from the family's starts, then ``reps`` runs
    from its final states."""
    states, sched = workload(family, B, n_steps, params, dev)
    warm = rollout(states, sched, params, dev)
    secs = [time_call(lambda: rollout(warm, sched, params, dev), dev)[0]
            for _ in range(reps)]
    return secs, warm, sched


def cap_share(states, sched, params: SimParams):
    """(share of game-steps, share of games) at K1's event cap over a
    one-phase K1 run of ``sched`` from ``states`` (meta row 3, the events a
    game resolved in a step)."""
    p1 = params.replace(engine="pallas_exact", two_phase=False)
    cap = p1.collision_counter_lim - 1
    B = states.score.shape[0]
    at_cap = []
    s = states
    for u in sched:
        out = ex._kernel_call(ex._to_planes(s), ex._u_plane(u, B), p1,
                              mode="exact")
        at_cap.append(out[1][3] >= cap)
        s = ex._from_planes(out, s, s.key, p1)
    hit = torch.stack(at_cap)
    return float(hit.float().mean()), float(hit.any(0).float().mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[1])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--families", default="corner,uniform")
    ap.add_argument("--engine", default="pallas_exact",
                    choices=["pallas_exact", "pallas"])
    ap.add_argument("--two-phase", action="store_true",
                    help="two-phase kernel (default one-phase: the "
                         "event-loop stressor)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    B, n = args.batch, args.steps
    params = SimParams(dtype="float32", engine=args.engine,
                       two_phase=args.two_phase)
    for family in args.families.split(","):
        secs, warm, sched = bench(params, family, B, n, args.reps, dev)
        cks = float(host(warm.damage).sum())
        rates = [B * n / t for t in secs]
        row = (f"{family:8s} {args.engine} two_phase={args.two_phase} "
               f"B={B} steps/s best={max(rates):,.0f} "
               f"all={[f'{r:,.0f}' for r in rates]} dmg_ck={cks:.3f}")
        if args.engine == "pallas_exact":
            steps_at, games_at = cap_share(warm, sched, params)
            row += f" cap_steps={steps_at:.3f} cap_games={games_at:.3f}"
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

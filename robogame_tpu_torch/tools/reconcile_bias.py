"""Split the corner-grinding damage bias into a platform part and a
semantic part.

    python -m robogame_tpu_torch.tools.reconcile_bias --phase cpu
    python -m robogame_tpu_torch.tools.reconcile_bias --phase gpu
    python -m robogame_tpu_torch.tools.reconcile_bias --phase compare \\
        [--json out.json]
    python -m robogame_tpu_torch.tools.reconcile_bias --phase perturb \\
        [--json out.json] [--cpu]
        (each with [--games 4096] [--steps 100] [--cache PREFIX])

On corner grinders (``dist_equiv``'s corner family: every player driven
into one corner all game, the same seeds and schedules as the JAX tool)
K1's total damage reads apart from the event engine's.  Three rollouts of
the same games settle the attribution:

  A. event on the CPU against event on the card: the same semantics, the
     platform's arithmetic only;
  B. K1 on the card against event on the card: the same platform, the
     semantics only;
  C. K1 on the card against event on the CPU: the mixed mode of a
     campaign that dumps its references on the CPU.

``--phase cpu`` rolls the event engine on the CPU (by definition; no card
needed), ``--phase gpu`` K1 and the event engine on the card (the JAX
tool's phase ``tpu``; it needs a card, or ``--cpu`` to run both on the
CPU), each dumping its final arrays to ``PREFIX_<engine>_<platform>.npz``
(``dist_equiv.dump_final``) and skipping a dump that exists, so phases
resume.  ``--phase compare`` reads the three dumps and writes the records
A, B, C (``dist_equiv.compare``) to ``--json``.  ``--phase perturb`` is
the control: the event engine from the same states and from states with
x scaled by 1 + 2^-23 (one ulp), at 30 steps and at ``--steps``, on the
card unless given ``--cpu``; JAX's record moved the 100-step corner
damage 40% on that ulp while the 30-step damage stayed (0.28%).  The
default phase is ``gpu``.

(The JAX tool's ``--block`` and its per-block pieces and caches kept each
TPU execution under a worker's watchdog; one process on the card runs
the rollouts whole.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

import numpy as np
import torch

from ..config import SimParams
from ..examples import add_cpu_flag, driver_device
from . import dist_equiv

PROG = "python -m robogame_tpu_torch.tools.reconcile_bias"
ULP = np.float32(1.0 + 2.0 ** -23)


def workload(G: int, steps: int, dev):
    """f32 params, G starts (seeds 1..G) on ``dev``, the corner schedule
    (the JAX tool's seed)."""
    params = SimParams(dtype="float32")
    states = dist_equiv.make_states(G, params, dev)
    sched = dist_equiv.make_sched("corner", G, steps,
                                  seed=zlib.crc32(b"corner") % 2**31)
    return params, states, sched


def roll_and_dump(engine: str, path: str, params, states, sched) -> None:
    if os.path.exists(path):
        print(f"# cached: {path}", flush=True)
        return
    f, t = dist_equiv.rollout(engine, states, sched, params)
    dist_equiv.dump_final(path, f)
    G, n = f.score.shape[0], sched.shape[0]
    print(f"# {engine} on {states.x.device.type}: {G * n / t:.0f} steps/s "
          f"-> {path}", flush=True)


def _write(path, obj) -> None:
    if path:
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=1)
        print(f"# wrote {path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--phase", default="gpu",
                    choices=["cpu", "gpu", "compare", "perturb"])
    ap.add_argument("--games", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cache", default=os.path.join("recon_out_torch",
                                                    "recon"),
                    help="prefix of the phases' .npz dumps")
    ap.add_argument("--json", default=None)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    c = args.cache
    paths = dict(event_cpu=f"{c}_event_cpu.npz",
                 event_gpu=f"{c}_event_gpu.npz",
                 exact_gpu=f"{c}_exact_gpu.npz")

    if args.phase == "compare":
        f = {k: dist_equiv.load_final(p) for k, p in paths.items()}
        records = [
            dist_equiv.compare(f["event_cpu"], f["event_gpu"],
                               "corner: event_cpu-vs-event_gpu "
                               "(platform only)"),
            dist_equiv.compare(f["event_gpu"], f["exact_gpu"],
                               "corner: exact_gpu-vs-event_gpu "
                               "(same platform)"),
            dist_equiv.compare(f["event_cpu"], f["exact_gpu"],
                               "corner: exact_gpu-vs-event_cpu "
                               "(campaign mode)"),
        ]
        _write(args.json, dict(games=args.games, steps=args.steps,
                               records=records))
        return 0

    dev = (torch.device("cpu") if args.phase == "cpu"
           else driver_device(args, PROG))
    if os.path.dirname(c):
        os.makedirs(os.path.dirname(c), exist_ok=True)
    params, states, sched = workload(args.games, args.steps, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# reconcile_bias {args.phase}: platform={dev.type} ({name}) "
          f"G={args.games} steps={args.steps}", flush=True)

    if args.phase == "perturb":
        plat = "gpu" if dev.type == "cuda" else "cpu"
        states_p = states._replace(x=states.x * torch.tensor(
            ULP, device=dev))
        recs = []
        for steps in sorted({min(30, args.steps), args.steps}):
            f0, _ = dist_equiv.rollout("event", states, sched[:steps],
                                       params)
            fp, _ = dist_equiv.rollout("event", states_p, sched[:steps],
                                       params)
            recs.append(dist_equiv.compare(
                f0, fp, f"corner {steps}step: event_{plat}-vs-"
                f"event_{plat}+1ulp"))
        _write(args.json, dict(games=args.games, records=recs))
        return 0

    if args.phase == "cpu":
        roll_and_dump("event", paths["event_cpu"], params, states, sched)
    else:
        roll_and_dump("pallas_exact", paths["exact_gpu"], params, states,
                      sched)
        roll_and_dump("event", paths["event_gpu"], params, states, sched)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The cost of one iteration of K1's event loop, from a sweep of its cap.

    python -m robogame_tpu_torch.tools.bench_sol [--batch 2048]
        [--steps 40] [--cpu]

On corner grinders (``bench_grind``'s corner family: every player driven
into one corner all game) K1's loop runs to its cap in many game-steps,
so a one-phase step's time against the cap (``collision_counter_lim =
cap + 1``, caps 2, 9, 25, 49) is a line: its slope is the cost of one
loop iteration of the whole batch, its intercept the floor of populate,
detect and the planes' reads and writes.  Each cap is timed two ways:

* the step, JAX's method: the best of 3 runs of ``--steps`` steps after a
  warm-up run (``bench_grind.bench``: CUDA events around a run, a host
  fetch at its end).  Each step is issued from the host (the planes, the
  launch, the states), so where the kernel is short the run waits on the
  host and the time flattens at the small caps;
* the kernel alone: K1's one-phase launch from the warm-up run's final
  states, KERNEL_REPS launches back to back between two CUDA events.

:func:`fit_slope` fits a line to each by least squares; each slope is
printed for the batch and per game-iteration (slope / B) beside its
intercept, with the share of game-steps at the cap.  A warp runs each
game and at B = 2048 every game is resident at once, so the batch waits
for its deepest game: the slope is one loop iteration's latency, and
slope / B is a game-iteration's cost only where every game grinds at the
cap.  (The JAX tool divided the slope by its 128-lane tiles, which run
one after another through the TPU's kernel grid; nothing here
corresponds.)

Then the uniform family two-phase (the Monte-Carlo mix): the step's time,
and its two launches timed apart at the warm-up run's final states, as
``chip_smoke.py`` phase 3 times them: the export (cap ``phase1_iters``)
over the batch and the resume over the pending games gathered into
``_compact_lanes`` lanes (the batch when more are pending).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import SimParams
from ..examples import add_cpu_flag, driver_device, time_call
from ..physics import exact_step as ex
from .bench_grind import bench, cap_share

PROG = "python -m robogame_tpu_torch.tools.bench_sol"
CAPS = (2, 9, 25, 49)
REPS = 3
KERNEL_REPS = 20        # launches averaged for a kernel's time


def fit_slope(caps, seconds):
    """Least-squares line through (cap, seconds): (slope, intercept)."""
    caps = np.asarray(caps, float)
    A = np.vstack([caps, np.ones_like(caps)]).T
    slope, intercept = np.linalg.lstsq(A, np.asarray(seconds, float),
                                       rcond=None)[0]
    return float(slope), float(intercept)


def kernel_ms(fn, dev):
    """(ms a call, the last call's result): after one call, KERNEL_REPS
    calls back to back, timed together (``time_call``)."""
    fn()

    def reps():
        for _ in range(KERNEL_REPS - 1):
            fn()
        return fn()
    t, out = time_call(reps, dev)
    return t / KERNEL_REPS * 1e3, out


def step_kernel_ms(states, u, params: SimParams, dev) -> float:
    """ms of K1's one-phase launch from ``states`` under controls u."""
    B = states.score.shape[0]
    planes, up = ex._to_planes(states), ex._u_plane(u, B)
    return kernel_ms(lambda: ex._kernel_call(planes, up, params,
                                             mode="exact"), dev)[0]


def export_resume_ms(states, u, params: SimParams, dev):
    """(export ms, resume ms, pending games, resume lanes) of one
    two-phase K1 step from ``states`` (:func:`kernel_ms` each), the
    resume's inputs gathered beforehand."""
    B = states.score.shape[0]
    planes = ex._to_planes(states)
    up = ex._u_plane(u, B)
    p1 = params.phase1_iters
    exp_ms, ((_, meta1, _), grid, carry) = kernel_ms(
        lambda: ex._kernel_call(planes, up, params, mode="exact_export",
                                cap=p1), dev)
    pending = meta1[5]
    n_pend = int((pending > 0.5).sum())
    K = ex._compact_lanes(B, params)
    K = K if n_pend <= K else B
    idx = torch.argsort(-pending, stable=True)[:K]
    x_k, m_k, d_k = (a[:, idx].contiguous() for a in planes)
    u_k, g_k, c_k = (up[:, idx].contiguous(), grid[..., idx].contiguous(),
                     carry[:, idx].contiguous())
    ev_rest = params.collision_counter_lim - 1 - p1
    res_ms, _ = kernel_ms(lambda: ex._kernel_call(
        (x_k, m_k, d_k), u_k, params, mode="exact_resume", cap=ev_rest,
        grid_in=g_k, carry_in=c_k), dev)
    return exp_ms, res_ms, n_pend, K


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[1])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=40)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    B, n = args.batch, args.steps
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# B={B} steps={n} on {name}", flush=True)
    ts, tk = [], []
    for cap in CAPS:
        p = SimParams(dtype="float32", engine="pallas_exact",
                      two_phase=False, collision_counter_lim=cap + 1)
        secs, warm, sched = bench(p, "corner", B, n, REPS, dev)
        t = min(secs) / n                   # seconds a batch step
        ts.append(t)
        tk.append(step_kernel_ms(warm, sched[0], p, dev) / 1e3)
        at_cap, _ = cap_share(warm, sched, p)
        print(f"cap={cap:3d}  step={t*1e3:8.3f} ms  ({B / t:,.0f} steps/s)"
              f"  kernel={tk[-1]*1e3:.4f} ms  game-steps at the cap "
              f"{at_cap:.3f}", flush=True)
    for what, secs in (("", ts), ("kernel ", tk)):
        slope, intercept = fit_slope(CAPS, secs)
        print(f"{what}slope: {slope*1e6:.2f} us/iteration (batch) = "
              f"{slope*1e9/B:.3f} ns/game-iteration; intercept "
              f"(populate+detect+I/O): {intercept*1e3:.3f} ms", flush=True)

    p_head = SimParams(dtype="float32", engine="pallas_exact",
                       two_phase=True)
    secs, warm, sched = bench(p_head, "uniform", B, n, REPS, dev)
    t_u = min(secs) / n
    exp_ms, res_ms, n_pend, K = export_resume_ms(warm, sched[0], p_head,
                                                 dev)
    print(f"uniform two-phase: step={t_u*1e3:.3f} ms ({B / t_u:,.0f} "
          f"steps/s); export {exp_ms:.4f} ms + resume {res_ms:.4f} ms "
          f"({n_pend} pending, resumed over {K} lanes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

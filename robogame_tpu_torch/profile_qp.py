"""K2's skills solve on the card: its routes, its setup, and its build flags.

    python -m robogame_tpu_torch.profile_qp

The classical skills' condensed QPs at production width (2,560 random
reach problems x 16 final times: 40,960 QPs, n=30, m=60, 60 iterations in
4 segments, 16 shared H and A) are timed with CUDA events after a
warm-up:

* the grouped route (``csrc/qp_grouped.cu``: the setup, then the
  iterations, then the per-problem kernel over the equality-row problems,
  none here), its setup kernel alone, and the per-problem kernel
  (``csrc/qp_admm.cu``) on the same problems;
* the grouped kernels built with FMA contraction and with
  ``-fmad=false``: each one's time, and how far its solutions lie from
  the plain version in f64 beside the plain f32 version, where all
  converged: the count outside 2e-3 + 1e-2 |x|, and the mean, the 99.9%
  quantile and the largest of a problem's max |dx|, which is what
  ``kernels.FMAD`` rests on;
* the equality-row problems of a grouped call, which the per-problem
  kernel solves (16 groups of 640 QPs at the skills' shape with random H
  and A, 3 equality rows in 5% of them, drawn in -0.5..0.5 or pinned at
  the upper bound, as ``tests/test_torch_cuda.py`` draws them): how many
  converged ones lie outside 2e-3 + 1e-2 |x| of the plain version, and of
  the plain version in f64 beside the plain f32 version.

Needs a CUDA device.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import kernels
from .config import SimParams
from .control import trajopt
from .ops import qp, qp_lanes

GAMES = 2560
X_ATOL, X_RTOL = 2e-3, 1e-2


def _ms(fn, reps=20):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def skills_qps(dev, B=GAMES, seed=0):
    """The 16 final-time candidates' QPs of B random reach problems:
    (H (16, 30, 30), g, A (16, 60, 30), lo, hi), problem k B + b is
    candidate k of problem b."""
    rng = np.random.default_rng(seed)

    def states():
        return torch.as_tensor(np.concatenate(
            [rng.uniform(-4.5, 4.5, (B, 1)), rng.uniform(-2.2, 2.2, (B, 1)),
             rng.uniform(-3.0, 3.0, (B, 2))], 1), dtype=torch.float32,
            device=dev)

    T, _, g, lo, hi = trajopt.candidate_qps(states(), states(), SimParams())
    return T.H, g, T.A, lo, hi


def eq_row_qps(dev, at_hi, G=16, group=640, n=30, m=60, n_eq=3,
               share=0.05):
    """Random QPs over G shared H and A, n_eq equality rows in about
    ``share`` of them (the draw of ``tests/test_torch_cuda.py::_qps``)."""
    P = G * group
    rng = np.random.default_rng(P + m)
    Q = rng.normal(size=(G, n, n))
    H = np.einsum("bij,bkj->bik", Q, Q) / n + np.eye(n) / 10.0
    lo = rng.uniform(-2.0, 0.0, (P, m))
    hi = rng.uniform(0.1, 2.0, (P, m))
    rows = rng.random(P) < share
    if at_hi:
        lo[rows, :n_eq] = hi[rows, :n_eq]
    else:
        lo[rows, :n_eq] = hi[rows, :n_eq] = rng.uniform(
            -0.5, 0.5, (P, n_eq))[rows]
    return group, [torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in (H, rng.normal(size=(P, n)),
                             rng.normal(size=(G, m, n)), lo, hi)]


def _outside(a, b, sel):
    """(converged in both among sel, of those outside X_ATOL + X_RTOL |x|
    of b)."""
    both = a.converged & b.converged & sel
    off = both & ((a.x.double() - b.x.double()).abs() >
                  X_ATOL + X_RTOL * b.x.double().abs()).any(-1)
    return int(both.sum()), int(off.sum())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_qp: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    H, g, A, lo, hi = skills_qps(dev)
    B = GAMES
    P = g.shape[0]
    args = (H, g, A, lo, hi, B, 4, 15, 1.0, 1e-6, 1.6, 1e-3)
    Hb, Ab = H.repeat_interleave(B, 0), A.repeat_interleave(B, 0)
    p64 = qp.solve_qp(*(t.double() for t in (Hb, g, Ab, lo, hi)), iters=60)
    p32 = qp.solve_qp(Hb, g, Ab, lo, hi, iters=60)
    print(f"card: {card}")
    occ = kernels.qp_grouped_occupancy()
    t_route = _ms(lambda: kernels.qp_grouped(*args))
    t_setup = _ms(lambda: kernels.qp_grouped_setup(H, A, 1e-6))
    t_per = _ms(lambda: kernels.qp_admm(*args), reps=5)
    print(f"skills QPs P={P} (n=30, m=60, 60 iterations): grouped route "
          f"{t_route:.4f} ms a launch, its setup alone {t_setup:.4f} ms "
          f"({t_setup / t_route:.3f} of the launch); the per-problem kernel "
          f"{t_per:.4f} ms; {occ['blocks_per_sm']} blocks of 80 problems an "
          f"SM at {occ['smem_bytes']} shared bytes  [{card}]")

    sols = {"plain f32": (p32.x, p32.converged)}
    times = {}
    fmad = set(kernels.FMAD)
    for build, table in (("FMA contraction", fmad | {"qp_grouped"}),
                         ("-fmad=false", fmad - {"qp_grouped"})):
        kernels.FMAD = table
        kernels._libs.pop("qp_grouped", None)
        x, st = kernels.qp_grouped(*args)
        sols[build] = (x, st[:, 0] > 0.5)
        times[build] = _ms(lambda: kernels.qp_grouped(*args))
    kernels.FMAD = fmad
    kernels._libs.pop("qp_grouped", None)
    allc = p64.converged
    for _, conv in sols.values():
        allc = allc & conv
    print(f"against the plain version in f64, {int(allc.sum())} of {P} "
          f"problems all converged:")
    for tag, (x, conv) in sols.items():
        dx = (x.double() - p64.x).abs()
        off = allc & (dx > X_ATOL + X_RTOL * p64.x.abs()).any(-1)
        agree = float((conv == p64.converged).float().mean())
        worst = dx[allc].amax(-1)          # a problem's max |dx|
        t = times.get(tag)
        extra = f"; {t:.4f} ms a launch" if t is not None else ""
        print(f"  {tag}: flags agree {agree:.5f}, {int(off.sum())} outside "
              f"{X_ATOL} + {X_RTOL} |x|; a problem's max|dx|: mean "
              f"{float(worst.mean()):.4g}, 99.9% "
              f"{float(worst.quantile(0.999)):.4g}, max "
              f"{float(worst.max()):.4g}{extra}")

    for at_hi in (False, True):
        group, (H, g, A, lo, hi) = eq_row_qps(dev, at_hi)
        k = qp_lanes.solve_qp_lanes(H, g, A, lo, hi, iters=60, group=group)
        Hb, Ab = H.repeat_interleave(group, 0), A.repeat_interleave(group, 0)
        p = qp.solve_qp(Hb, g, Ab, lo, hi, iters=60)
        f = qp.solve_qp(*(t.double() for t in (Hb, g, Ab, lo, hi)),
                        iters=60)
        eq = (lo == hi).any(-1)
        agree = float((k.converged == p.converged)[eq].float().mean())
        print(f"equality rows {'at the upper bound' if at_hi else 'drawn'}"
              f" ({int(eq.sum())} of {g.shape[0]} problems, on the "
              f"per-problem kernel): flags agree {agree:.4f}; outside "
              f"(converged in both / outside): K2 vs plain f32 "
              f"{_outside(k, p, eq)}, K2 vs f64 {_outside(k, f, eq)}, "
              f"plain f32 vs f64 {_outside(p, f, eq)}; the grouped "
              f"problems: K2 vs f64 {_outside(k, f, ~eq)}, plain f32 vs "
              f"f64 {_outside(p, f, ~eq)}  [{card}]", flush=True)


if __name__ == "__main__":
    main()

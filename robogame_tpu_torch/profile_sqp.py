"""K3's, K4's and K5's time on the card, split by schedule, and their build
flags.

    python -m robogame_tpu_torch.profile_sqp

Random DMPC and CMPC instances at the production width (1,024 and 512
games x 8 candidates: 8,192 fused DMPC SQPs, 4,096 joint CMPC SQPs) go
through the controllers' candidate grids, and the fused solves' inputs are
timed on their kernels (CUDA events, after a warm-up):

* the production schedule (4 cold segments of 37 iterations, 5 warm SQP
  iterations of 40: 9 factorizations, 348 iterations);
* one segment of one iteration (the set-up, one factorization, one
  iteration and the residuals), nine segments of one iteration, and one
  segment of 348 iterations: the differences split a launch into its
  factorizations and its iterations.

K5 is timed on the joint QPs of CMPC's "joint" route (one SQP iteration
of the same instances: 4,096 QPs of n1 = 40 x 2, m_own = 80 x 2, m_pair =
20, 150 iterations) and at CMPC's N = 16 (n1 = 32, m_own = 64, m_pair =
16), with the problems an SM it runs.

Then the kernels are built with FMA contraction and with ``-fmad=false``
and timed on the production schedule, each beside the other; for each
build the kernel is held against its plain version in f32 and f64 (the
problems where all three converged that lie outside 2e-3 + 1e-2 |x| of
the f64 solution), which is what the flag table ``kernels.FMAD`` rests on.
Needs a CUDA device.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import kernels
from .config import MpcParams, SimParams
from .ops import qp_lanes, sqp_lanes

SCHEDULES = {"production": {},
             "1 segment x 1 iteration": dict(n_seg0=1, it0=1, sqp_rest=0),
             "9 segments x 1 iteration": dict(n_seg0=9, it0=1, sqp_rest=0),
             "1 segment x 348 iterations": dict(n_seg0=1, it0=348,
                                                sqp_rest=0)}
X_ATOL, X_RTOL = 2e-3, 1e-2


def _pos(rng, *shape):
    return np.stack([rng.uniform(-4.5, 4.5, shape),
                     rng.uniform(-2.2, 2.2, shape)], -1)


def _capture(name, fn, module=sqp_lanes):
    """The arguments of the first ``module.<name>`` call fn() makes."""
    seen = []
    route = getattr(module, name)

    def hook(*args, **kw):
        seen.append((args, kw))
        return route(*args, **kw)

    setattr(module, name, hook)
    try:
        fn()
    finally:
        setattr(module, name, route)
    args, kw = seen[0]
    return tuple(a.float().contiguous() for a in args), kw


def dmpc_inputs(games, dev, seed=0):
    """The fused DMPC solve's inputs for ``games`` random instances."""
    from .control import dmpc as dm
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    x0 = np.concatenate([_pos(rng, games), rng.normal(size=(games, 2))], 1)
    xd = np.concatenate([_pos(rng, games),
                         3.0 * rng.normal(size=(games, 2))], 1)
    mpc = MpcParams()
    st = dm.initial_dmpc_state(mpc, device=dev, batch=(games,))
    return _capture("dmpc_sqp_stats", lambda: dm.candidates(
        st, f(x0), f(xd), f(_pos(rng, games, 3)), SimParams(), mpc,
        "fused"))


def cmpc_inputs(games, dev, seed=0):
    """The fused CMPC solve's inputs for ``games`` random instances."""
    from .control import cmpc as cm
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    state = lambda v: np.concatenate([_pos(rng, games), v], 1)
    x1 = state(rng.normal(size=(games, 2)))
    x2 = state(rng.normal(size=(games, 2)))
    f1 = state(3.0 * rng.normal(size=(games, 2)))
    f2 = state(np.zeros((games, 2)))
    mpc = MpcParams()
    st = cm.initial_cmpc_state(mpc, device=dev, batch=(games,))
    return _capture("cmpc_sqp_stats", lambda: cm.candidates(
        st, f(x1), f(x2), f(f1), f(f2), f(_pos(rng, games, 2)),
        SimParams(), mpc, "fused"))


def joint_inputs(games, dev, N=20, seed=0):
    """K5's inputs (rows scaled, as ``kernels.qp_joint`` takes them) and
    keyword arguments: the joint QPs of ``games`` random CMPC instances at
    N knots, one SQP iteration on the "joint" route."""
    from .control import cmpc as cm
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    state = lambda v: np.concatenate([_pos(rng, games), v], 1)
    x1 = state(rng.normal(size=(games, 2)))
    x2 = state(rng.normal(size=(games, 2)))
    f1 = state(3.0 * rng.normal(size=(games, 2)))
    f2 = state(np.zeros((games, 2)))
    mpc = MpcParams(N=N, sqp_iters=1)
    st = cm.initial_cmpc_state(mpc, device=dev, batch=(games,))
    args, kw = _capture("joint_qp_stats", lambda: cm.candidates(
        st, f(x1), f(x2), f(f1), f(f2), f(_pos(rng, games, 2)),
        SimParams(), mpc, "joint"), qp_lanes)
    m_own = kw["m_own"]
    Ab, lo, hi = qp_lanes.joint_row_scale(*args[2:5], m_own)
    args = tuple(a.contiguous() for a in (args[0], args[1], Ab, lo, hi,
                                          args[5], args[6]))
    return args, dict(m_own=m_own, m_pair=kw["m_pair"], n_seg=4,
                      seg_iters=kw["iters"] // 4, rho=1.0, sigma=1e-6,
                      alpha=1.6, tol=1e-3)


def time_ms(fn, reps=3):
    """Device milliseconds per call of fn, after two warm-up calls."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def off_f64(kernel, plain, args):
    """(problems outside tolerance of the f64 plain solution: kernel, plain
    f32, of the problems where all three converged)."""
    (xk, sk), (xp, sp) = kernel(args), plain(args)
    x64, s64 = plain(tuple(a.double() for a in args))
    all3 = (sk[:, 0] > 0.5) & (sp[:, 0] > 0.5) & (s64[:, 0] > 0.5)
    off = [int((all3 & ((x.double() - x64).abs() >
                        X_ATOL + X_RTOL * x64.abs()).any(-1)).sum())
           for x in (xk, xp)]
    return off[0], off[1], int(all3.sum())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_sqp needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    solves = (("K3", "dmpc_sqp", sqp_lanes.dmpc_sqp_stats,
               sqp_lanes._plain_stats, dmpc_inputs(1024, dev)),
              ("K4", "cmpc_sqp", sqp_lanes.cmpc_sqp_stats,
               sqp_lanes._cmpc_plain_stats, cmpc_inputs(512, dev)))
    for tag, name, stats, _, (args, kw) in solves:
        occ = kernels.occupancy(name, kw["N"], kw["n_obs"])
        print(f"{tag} P={args[1].shape[0]}: {occ['problems_per_sm']} "
              f"problems an SM, {occ['smem_bytes']} shared bytes a problem")
        for label, sched in SCHEDULES.items():
            ms = time_ms(lambda: stats(*args, **dict(kw, **sched)))
            print(f"{tag} {label}: {ms:.4f} ms")
    joints = [("K5", joint_inputs(512, dev)),
              ("K5 at N=16", joint_inputs(512, dev, N=16))]
    for tag, (args, kw) in joints:
        n1 = args[0].shape[-1]
        occ = kernels.qp_joint_occupancy(n1, kw["m_own"], kw["m_pair"])
        print(f"{tag} P={args[1].shape[0]} (n1={n1}, m_own={kw['m_own']}, "
              f"m_pair={kw['m_pair']}): {occ['problems_per_sm']} problems "
              f"an SM, {occ['smem_bytes']} shared bytes a problem")
    fmad = set(kernels.FMAD)
    names = ("dmpc_sqp", "cmpc_sqp", "qp_joint")
    for build, table in (("FMA contraction", fmad | set(names)),
                         ("-fmad=false", fmad - set(names))):
        kernels.FMAD = table
        for name in names:
            kernels._libs.pop(name, None)
        for tag, name, stats, plain, (args, kw) in solves:
            ms = time_ms(lambda: stats(*args, **kw))
            k, p, n = off_f64(lambda a: stats(*a, **kw),
                              lambda a: plain(*a, **kw), args)
            print(f"{tag} built with {build}: {ms:.4f} ms; outside "
                  f"{X_ATOL}/{X_RTOL} of f64 ({n} all converged): kernel "
                  f"{k}, plain f32 {p}")
        for tag, (args, kw) in joints:
            ms = time_ms(lambda: kernels.qp_joint(*args, **kw))
            k, p, n = off_f64(lambda a: kernels.qp_joint(*a, **kw),
                              lambda a: qp_lanes.joint_plain_stats(*a, **kw),
                              args)
            (xk, _), (x64, _) = (kernels.qp_joint(*args, **kw),
                                 qp_lanes.joint_plain_stats(
                                     *(a.double() for a in args), **kw))
            xp, _ = qp_lanes.joint_plain_stats(*args, **kw)
            dk, dp = ((x.double() - x64).abs().amax(-1) for x in (xk, xp))
            print(f"{tag} built with {build}: {ms:.4f} ms; outside "
                  f"{X_ATOL}/{X_RTOL} of f64 ({n} all converged): kernel "
                  f"{k}, plain f32 {p}; a problem's max|dx| to f64 mean / "
                  f"max: kernel {float(dk.mean()):.4g} / "
                  f"{float(dk.max()):.4g}, plain f32 {float(dp.mean()):.4g}"
                  f" / {float(dp.max()):.4g}")
    kernels.FMAD = fmad

if __name__ == "__main__":
    main()

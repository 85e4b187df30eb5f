#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each failing loudly (nothing here catches an error):

0. the card's name and power limit (nvidia-smi), then the builds of the
   hand-written CUDA kernels K1 (csrc/exact_step.cu), K2 (csrc/qp_grouped.cu
   and csrc/qp_admm.cu), K3 (csrc/dmpc_sqp.cu), K4 (csrc/cmpc_sqp.cu), K5
   (csrc/qp_joint.cu) and K6 (csrc/parallel_step.cu) from this checkout,
   one nvcc each, started together, with ptxas's report (registers,
   spills, shared memory) of K2's grouped kernels and K3's and K4's;
1. K1 against its plain PyTorch version on the card, from common states:
   (a) mode exact at B=8192 on Monte-Carlo starts, uniform schedules;
   (b) corner-grinding games (B=1024, pre-ground 26 steps by the kernel),
       which drive the event loop to its cap;
   (c) two-phase (exact_export + exact_resume) bitwise equal to one-phase
       in the kernel, through both the compacted and the overflow path;
   (d) stochastic mode with identical noise planes, and noise=0 bitwise
       equal to the deterministic kernel;
2. slice 1's main path: bench.py's workload (B=8192 games, 400 control
   steps, per-game U(-8, 8) schedules held 10 steps, winning_score=4,
   two-phase with compact_frac=16) through ``monte_carlo``, timed after a
   warm-up, with K1's launch counts of that run; its first 64 games are
   held against the same sweep run by the plain version on the CPU;
3. K1's time per control step at the main path's shapes beside its bound
   and the plain version's time;
4. slice 2's main path: the classical_cbf and classical_nocbf matchups
   (classical vs classical, with and without the CBF filter; 512 games x
   400 control steps, randomized puck starts) through ``monte_carlo``,
   each timed after a warm-up with the K1 and K2 launch counts of its run
   (K2: 2 grouped launches a step for the skills, each with the
   per-problem kernel's launch over its equality-row problems, and one
   per-problem launch for the CBF filter) and the problems each K2 route
   solved (every skills QP grouped); CBF must cut the mean damage.
   From the states of steps 100 and 200 of the CBF run, the policy on K2
   is held against the policy on K2's plain version on the card, and 16
   games' policy output on the card against the CPU;
5. K2 against its plain version on the card: (a) the skills QPs (n=30,
   m=60, 40960 problems, the grouped route) and (b) the CBF QPs (8, 20,
   the per-problem route) of a mid-game matchup state; (a') on the
   skills, the grouped kernel, its plain version and the plain f32
   version against the plain version in f64 (the kernel must lie no
   further from it than the plain f32 version: at most one problem more
   outside the tolerance, and a problem's max |dx| no larger in the mean
   nor at its largest); (c) random
   DMPC-shaped QPs (40, 140) with row scaling and equality rows (and,
   reported only, how each f32 route's flags agree with the plain version
   in f64 at 150 iterations); (c'') 16 groups of 640 skills-shaped QPs
   with equality rows in 5% of them, which the per-problem kernel must
   solve within the grouped call; (d) two grouped launches bitwise equal,
   and the grouped route against the per-problem kernel on the broadcast
   operands; K2's time per launch at both matchup shapes (the grouped
   route with its setup alone, and the per-problem kernel on the same
   skills) beside its bounds (the grouped count and the count with a
   factorization a segment) and the plain time;
6. slice 3's main path: (a) the dmpc_vs_dmpc and dmpc_vs_noop matchups
   (512 games, 400 control steps each) through ``monte_carlo``, each timed
   after a warm-up with its K1, K2 and K3 launch counts (K3: one launch
   per DMPC team and step, 8192 SQPs each for two teams); DMPC must score
   against the no-op team.  From the states of step 100 of dmpc_vs_dmpc:
   (b) K3 against its plain version on team A's 8192 candidate SQPs (and
   each against the plain version in f64, reported); (c) K3 with one SQP
   iteration against K2 (the controller's 'lanes' route) on the same
   candidates; (d) the policy on K3 against the policy on the plain
   version at steps 50, 100, ..., 350, and 64 games on the card against
   the CPU at steps 100 and 200;
   (e) K3's time per launch beside its bound (operations counted on the
   knot-structured algebra, with the count on an explicit A beside it),
   the plain time and the problems an SM it runs;
7. slice 4's main path: (a) the cmpc_vs_cmpc and dmpc_vs_cmpc matchups
   (512 games, 400 control steps each) through ``monte_carlo``, each timed
   after a warm-up with its launch counts (K4: one launch per CMPC team
   and step, 4096 joint SQPs each; K3 for the DMPC team); DMPC must
   outscore CMPC in dmpc_vs_cmpc.  From the states of step 100 of
   cmpc_vs_cmpc: (b) K4 against its plain version on team A's 4096
   candidate SQPs (and both against the plain version in f64); (c) K4
   with one SQP iteration against K5 (the controller's 'joint' route), K5
   against its plain version (and f64) and against the dense ``solve_qp``
   on the assembled problems; (d) the policy on K4 against the policy on
   the plain version at steps 50, 100, ..., 350, and 64 games on the card
   against the CPU at step 100; (e) three control steps of cmpc_vs_cmpc on
   route 'joint' (6 K5 launches a team-step), timed; (f) K4's and K5's
   times per launch beside their bounds and the plain times (K4's bound
   on the knot-structured algebra, the explicit-A count beside it, and
   the problems an SM it runs).

8. slice 5's main path, the parallel-resolution step on K6
   (``engine="pallas"``): (a) K6 against its plain version in modes full,
   export (grid and carry too) and resume, bitwise: at B=8192 on
   Monte-Carlo starts with uniform schedules, on corner-grinding games
   (B=1024, pre-ground 26 steps by the kernel) that drive the loop to its
   cap, in stochastic mode with identical noise planes, and noise=0
   bitwise equal to the deterministic kernel; (b) two-phase equal to
   one-phase in the kernel through the compacted and the overflow path;
   (c) the bench workload on engine="pallas" through ``monte_carlo``,
   timed after a warm-up, with K6's launch counts (export and resume 400
   each) and phase 2's K1 rate beside it; its first 64 games held against
   the plain version on the CPU over 40 steps; (d) the stochastic row
   (B=2048, noise=1.0), timed, and the velocity std at zero input after 8
   steps within 6% of the analytic value; (e) the sweep engine
   (``engine="sweep"``, plain PyTorch) on the card, B=2048 x 40 steps,
   timed, and 64 games x 3 steps held against the CPU from common states;
   (f) K6's time per control step (export + resume at step 200 of the
   main path, each printed, with the resume's warps an SM) beside its
   bound and the plain time.

The kernels' times go out as one JSON line ``{"kernels": [...]}`` (K1,
K2 at the skills shape, K2 at the CBF shape, K3, K4, K5, K6); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
1 before printing any result.
"""

import contextlib
import dataclasses
import importlib
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN, N_STEPS, HOLD = 8192, 400, 10
B_CL = 512                          # games of each closed-loop matchup
SNAP_STEPS = (100, 200)             # states the policy checks start from
DMPC_SNAPS = tuple(range(50, N_STEPS, 50))  # and those of the DMPC policy
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12              # f32 outside the tensor cores
# a candidate skill whose best two final-time costs lie this close may
# rightly pick another final time under f32 roundoff
NEAR_TIE = 1e-3
# K2 against its plain version, and the policy's trajectories and
# controls (K2's solutions, clipped to the input box) on K2 against the
# policy on the plain version
X_ATOL, X_RTOL = 2e-3, 1e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps=1):
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    out = None
    for _ in range(reps):
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, out


def maxdiff(a, b):
    return float((a.double() - b.double()).abs().max())


def k2_flops(n, m, n_seg, seg_iters):
    """The f32 operations one K2 solve needs: per segment the lower
    triangle of K = H + sigma I + A' diag(rho) A, the Cholesky factor,
    its inverse and Kinv = C'C (n^3/3 each), the iterations (two products
    with A, one with Kinv, the vector updates) and the residuals."""
    form = m * n * (n + 1) + m * n
    it = 4 * m * n + 2 * n * n + 12 * m + 3 * n
    res = 2 * m * n + 2 * n * n + 5 * m + 5 * n
    return n_seg * (form + n ** 3 + seg_iters * it + res)


def k2_grouped_flops(n, m, n_seg, seg_iters):
    """The f32 operations one K2 solve needs on the grouped algebra (the
    factors come once per group, in f64, and are not counted: some 0.2
    MFLOP a group of 2,560 problems): per iteration the products A'w, W'r,
    W t and A x (4mn + 4n^2) and the vector updates, per segment the
    diagonal 1/(1 + rho lam) and the residuals (Hx, A'y)."""
    it = 4 * m * n + 4 * n * n + 5 * n + 10 * m
    res = 2 * m * n + 2 * n * n + 5 * m + 5 * n
    return n_seg * (2 * n + seg_iters * it + res)


def k2_bound_ms(G, P, n, m, n_seg, seg_iters, count=k2_flops):
    """(bound ms, 'bytes' or 'operations') of one K2 launch: each input
    read once (G shared H and A, per-problem g, l, u), each output written
    once (x and 3 flags), against the f32 rate, the operations counted by
    ``count``."""
    nbytes = 4 * (G * (n * n + m * n) + P * (n + 2 * m) + P * (n + 3))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = P * count(n, m, n_seg, seg_iters) / H100_F32_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


@contextlib.contextmanager
def plain_qp():
    """Route every ``solve_qp_lanes`` call of the controllers to K2's plain
    version (``ops/qp.py::solve_qp``) on the tensors' own device."""
    from robogame_tpu_torch.ops import qp, qp_lanes
    kernel_route = qp_lanes.solve_qp_lanes

    def plain(H, g, A, l, u, iters=50, n_seg=4, rho=1.0, sigma=1e-6,
              alpha=1.6, tol=1e-3, scale_rows=False, group=1):
        return qp.solve_qp(H.repeat_interleave(group, 0), g,
                           A.repeat_interleave(group, 0), l, u, iters=iters,
                           rho=rho, sigma=sigma, alpha=alpha, tol=tol,
                           scale_rows=scale_rows, n_seg=n_seg)

    qp_lanes.solve_qp_lanes = plain
    try:
        yield
    finally:
        qp_lanes.solve_qp_lanes = kernel_route


def random_qps(dev, P, n, m, n_eq, seed=40):
    """P random strictly convex QPs (the generator of
    tests/test_qp_pallas.py) with ``n_eq`` equality rows, float32 on
    ``dev``."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(P, n, n))
    H = np.einsum("bij,bkj->bik", Q, Q) / n + np.eye(n) / 10.0
    lo = rng.uniform(-2.0, 0.0, (P, m))
    hi = rng.uniform(0.1, 2.0, (P, m))
    lo[:, :n_eq] = hi[:, :n_eq] = rng.uniform(-0.5, 0.5, (P, n_eq))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        H, rng.normal(size=(P, n)), rng.normal(size=(P, m, n)), lo, hi)]


def grouped_qps(dev, G, group, n, m, n_eq, share, seed=41):
    """G groups of ``group`` random strictly convex QPs sharing H and A,
    ``n_eq`` equality rows in a ``share`` of the problems, float32 on
    ``dev``."""
    rng = np.random.default_rng(seed)
    P = G * group
    Q = rng.normal(size=(G, n, n))
    H = np.einsum("bij,bkj->bik", Q, Q) / n + np.eye(n) / 10.0
    lo = rng.uniform(-2.0, 0.0, (P, m))
    hi = rng.uniform(0.1, 2.0, (P, m))
    rows = rng.random(P) < share
    lo[rows, :n_eq] = hi[rows, :n_eq] = rng.uniform(
        -0.5, 0.5, (int(rows.sum()), n_eq))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        H, rng.normal(size=(P, n)), rng.normal(size=(G, m, n)), lo, hi)]


def _objective(H, g, x, group):
    """1/2 x'Hx + g'x per problem, H shared by groups of ``group``."""
    G, n = H.shape[0], g.shape[1]
    xg = x.reshape(G, group, n)
    return 0.5 * torch.einsum("gpi,gij,gpj->gp", xg, H, xg).reshape(-1) + \
        (g * x).sum(-1)


def k2_vs_plain(tag, H, g, A, l, u, group=1, **kw):
    """K2 and its plain version on the same problems.  Held: flags agree on
    >= 99% of the problems; where both converged, the objectives agree
    within 2e-2 (1 + |f|) (what the flags guarantee against an exact
    solver, tests/test_qp_fuzz.py) and x within X_ATOL/X_RTOL on all but
    0.1% of the problems.  Those few lie in the nearly flat directions of
    an ill-conditioned H (the skills' H is rank 4 plus 2e-3 I), where f32
    roundoff moves a stopped ADMM iterate along the valley.  Returns (max
    |dx| where both converged, K2's solution)."""
    from robogame_tpu_torch.ops import qp, qp_lanes
    k = qp_lanes.solve_qp_lanes(H, g, A, l, u, group=group, **kw)
    p = qp.solve_qp(H.repeat_interleave(group, 0), g,
                    A.repeat_interleave(group, 0), l, u, **kw)
    return held_against(k, p, tag, H, g, group, l.shape[1]), k


def held_against(k, p, tag, H, g, group, m):
    """K2's solution k held against p by k2_vs_plain's criteria (H shared
    by groups of ``group``, m rows); returns max |dx| where both
    converged."""
    torch.cuda.synchronize()
    agree = float((k.converged == p.converged).float().mean())
    both = k.converged & p.converged
    nb = int(both.sum())
    dx = (k.x - p.x).abs()
    err = float(dx[both].max()) if nb else 0.0
    off = both & (dx > X_ATOL + X_RTOL * p.x.abs()).any(-1)
    fk, fp = (_objective(H.double(), g.double(), s.x.double(), group)
              for s in (k, p))
    df = ((fk - fp).abs() / (1 + fp.abs()))[both]
    dfmax = float(df.max()) if nb else 0.0
    print(f"phase5 {tag}: P={g.shape[0]} n={g.shape[1]} m={m}: "
          f"flags agree {agree:.5f}, both converged {nb}; there max|dx| "
          f"{err:.3g}, {int(off.sum())} problems outside "
          f"{X_ATOL}/{X_RTOL}, max |df|/(1+|f|) {dfmax:.3g}", flush=True)
    check(agree >= 0.99, f"{tag}: K2 and plain flags agree on {agree}")
    check(dfmax <= 2e-2, f"{tag}: K2's objective differs ({dfmax})")
    check(int(off.sum()) <= nb // 1000, f"{tag}: K2 disagrees with its "
          f"plain version ({err})")
    return err


def _tensors(tree):
    """The tensors of a carry of (named) tuples, depth first (None and
    other leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for a in tree for t in _tensors(a)]
    return []


def unsettled_games(rt, params, carry, states, cbf, route):
    """(B,) games whose plan may rightly differ between K2 on the card and
    ``route`` ('plain': the plain version on the card, 'cpu': on the CPU):
    a candidate skill with its best two final-time costs within NEAR_TIE on
    either side, or a QP flag that differs between the sides (the knife
    edge of the convergence test), in either team's skills or the CBF."""
    from robogame_tpu_torch.agents import classical as cl
    from robogame_tpu_torch.control import cbf as cbf_mod
    from robogame_tpu_torch.control import trajopt as tr

    def other(fn, *args):
        if route == "cpu":
            return fn(*(a.cpu() for a in args))
        with plain_qp():
            return fn(*args)

    x = states.x
    B = x.shape[0]
    bad = torch.zeros(B, dtype=torch.bool)
    u = []
    for field, ts in zip((-1, 1), carry):
        c4 = [a.reshape(B * 5, 2) for a in cl._team_candidates(
            x, field, params, rt.StrategyParams())[:4]]
        _, ck, vk, _ = tr.candidate_costs(*c4, params)
        _, cp, vp, _ = other(lambda *a: tr.candidate_costs(*a, params), *c4)
        for c in (ck.cpu(), cp.cpu()):
            srt = c.sort(dim=0).values
            bad |= ((srt[1] - srt[0]) <= NEAR_TIE).reshape(B, 5).any(1)
        bad |= (vk.cpu() != vp.cpu()).any(0).reshape(B, 5).any(1)
        u.append(rt.team_policy_batch(ts, x, field, params,
                                      rt.StrategyParams())[1])
    if cbf is not None:
        args = (torch.cat(u, 1), x[:, :4, 0:2], x[:, :4, 2:4])
        fk = cbf_mod.safe_control_batch(*args, params, cbf).converged
        fp = other(lambda *a: cbf_mod.safe_control_batch(
            *a, params, cbf).converged, *args)
        bad |= fk.cpu() != fp.cpu()
    return bad


def hold_policy(rt, tag, policy, params, carry, states, cbf, route):
    """The matchup policy on K2 against the same policy on ``route`` from
    one state.  Plays are equal in every game; outside the unsettled games
    the playback indices and lengths are equal, and the trajectories and
    controls (K2's solutions, clipped) are within X_ATOL/X_RTOL in all but
    1% of the games (the flat-valley outliers of ``k2_vs_plain``)."""
    from robogame_tpu_torch.agents import classical as cl
    (ka, kb), uk = policy(carry, states)
    if route == "cpu":
        c_carry = tuple(cl._map(lambda a: a.cpu(), ts) for ts in carry)
        c_states = type(states)(*(a.cpu() for a in states))
        (pa, pb), up = policy(c_carry, c_states)
    else:
        with plain_qp():
            (pa, pb), up = policy(carry, states)
    bad = unsettled_games(rt, params, carry, states, cbf, route)
    ok = ~bad
    B = states.x.shape[0]
    err = 0.0
    off = torch.zeros(B, dtype=torch.bool)
    for a, b in zip(_tensors((ka, kb, uk)), _tensors((pa, pb, up))):
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            d = (a - b).abs().reshape(B, -1)
            err = max(err, float(d[ok].max()) if bool(ok.any()) else 0.0)
            off |= (d > X_ATOL + X_RTOL * b.abs().reshape(B, -1)).any(-1)
        else:
            check(torch.equal(a[ok], b[ok]), f"{tag}: plays or indices "
                  f"differ")
    off &= ok
    check(torch.equal(ka.curr_play.cpu(), pa.curr_play.cpu()) and
          torch.equal(kb.curr_play.cpu(), pb.curr_play.cpu()),
          f"{tag}: plays differ")
    print(f"phase4 {tag}: {B} games, {int(bad.sum())} unsettled (near-tie "
          f"or flag knife-edge) set aside; over the other {int(ok.sum())} "
          f"max|d| {err:.3g}, {int(off.sum())} games outside "
          f"{X_ATOL}/{X_RTOL}", flush=True)
    check(int(ok.sum()) >= B // 2, f"{tag}: too many unsettled games")
    check(int(off.sum()) <= -(-int(ok.sum()) // 100), f"{tag}: trajectories "
          f"or controls differ ({err})")


def _tree_map(fn, tree):
    """``fn`` over the tensors of a carry of (named) tuples; other leaves
    (None, ints) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        parts = [_tree_map(fn, a) for a in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else \
            tuple(parts)
    return tree


def _clone(tree):
    return _tree_map(torch.clone, tree)


def ptxas_report(log):
    """ptxas's lines on each kernel of a build's ``-Xptxas=-v`` log, one
    line a kernel: the compile-time shape its template fixes (N, M; 0 0
    for the generic one), then its stack, spills, registers and shared
    memory."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            shape = re.search(r"ILi(\d+)ELi(\d+)E", line)
            cur = [f"N, M = {shape.group(1)}, {shape.group(2)}" if shape
                   else line.split("'")[1]]
            out.append(cur)
        elif cur is not None and ("spill" in line or "Used" in line):
            cur.append(line.split(":", 1)[-1].strip())
    return ["; ".join(c) for c in out]


def matchup_params(rt):
    """The matchups' physics (examples/matchups.py:180)."""
    return rt.SimParams(dt=0.05, winning_score=4, engine="pallas_exact")


def run_matchup(rt, kernels, name, policy, ps0, dev, card, snap=SNAP_STEPS):
    """One 512-game matchup of N_STEPS steps through monte_carlo after a
    10-step warm-up; returns (params, snapshots {step: (carry, states)} at
    the steps ``snap``, launches {"K1", ..., "K5"} of the run,
    aggregate)."""
    params = matchup_params(rt)
    mc = rt.McParams(num_runs=B_CL, T=round(N_STEPS * params.dt, 9),
                     randomize_x0=True,
                     x0_pos_range=(1.0, 0.5), x0_vel_range=2.0)
    warm = rt.monte_carlo(params, dataclasses.replace(mc, T=0.5),
                          policy=policy, policy_state=ps0, device=dev)
    _ = warm.scores.cpu()
    snaps, step = {}, [0]

    def spy(carry, states):
        if step[0] in snap:
            snaps[step[0]] = (_clone(carry), _clone(states))
        step[0] += 1
        return policy(carry, states)

    kernels.reset_launches()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    ev0.record()
    res = rt.monte_carlo(params, mc, policy=spy, policy_state=ps0,
                         device=dev)
    ev1.record()
    scores = res.scores.cpu()
    wall = time.perf_counter() - t0
    k2 = {**{("per_problem", *k): v for k, v in kernels.qp_launches.items()},
          **{("grouped", *k): v for k, v in
             kernels.qp_grouped_launches.items()},
          **{("listed", *k): v for k, v in
             kernels.qp_listed_launches.items()}}
    launches = {"K1": dict(kernels.launches), "K2": k2,
                "K3": dict(kernels.sqp_launches),
                "K4": dict(kernels.cmpc_launches),
                "K5": dict(kernels.joint_launches)}
    agg = rt.aggregate(res)
    agg["draws"] = agg["games"] - agg["wins_a"] - agg["wins_b"]
    print(f"{name}: {B_CL} games x {step[0]} steps in {wall:.3f} s wall "
          f"({ev0.elapsed_time(ev1):.1f} ms between CUDA events): "
          f"{B_CL / wall:.3f} games/s, {B_CL * step[0] / wall:.1f} "
          f"control-steps/s  [{card}]", flush=True)
    print(f"{name} launches: {launches}", flush=True)
    print(f"{name} aggregate: {json.dumps(agg)}", flush=True)
    agg["control_steps_per_s"] = B_CL * step[0] / wall
    check(step[0] == N_STEPS, f"{name}: ran {step[0]} steps")
    k1 = launches["K1"]
    check(k1["exact_export"] >= N_STEPS and k1["exact_resume"] >= N_STEPS,
          f"{name}: K1 did not run every step")
    check(scores.shape == (B_CL, 2) and bool(torch.isfinite(
        res.damage).all()) and bool(((scores >= 0) & (
            scores <= params.winning_score)).all()),
          f"{name}: outputs malformed")
    return params, snaps, launches, agg


def run_classical(rt, kernels, name, cbf, dev, card):
    """A classical matchup (phase 4): K2 runs 2 skills launches a step on
    its grouped route (each followed by the per-problem kernel's launch
    over the equality-row problems, of which the skills have none) and one
    CBF launch with the filter on its per-problem route; returns (policy,
    params, snapshots, K2 launches by (route, n, m), aggregate)."""
    policy, ps0 = rt.classical_matchup(matchup_params(rt), B_CL, cbf=cbf,
                                       device=dev)
    params, snaps, launches, agg = run_matchup(
        rt, kernels, f"phase4 {name}", policy, ps0, dev, card)
    want = {("grouped", 30, 60): 2 * N_STEPS,
            ("listed", 30, 60): 2 * N_STEPS}
    if cbf is not None:
        want[("per_problem", 8, 20)] = N_STEPS
    k2 = launches["K2"]
    check(k2 == want, f"{name}: K2 launches {k2}, expected {want}")
    routes = kernels.k2_routes()
    n_skills = 2 * N_STEPS * B_CL * 5 * 16
    print(f"phase4 {name} K2 problems by route: {routes}", flush=True)
    check(routes == {"grouped": n_skills, "listed": 0, "per_problem":
                     (N_STEPS * B_CL if cbf is not None else 0)},
          f"{name}: K2 routes {routes}")
    return policy, params, snaps, k2, agg


def closed_loop_and_k2(rt, dev, card):
    """Phases 4 and 5; returns K2's two entries of the kernels line."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.agents import classical as cl
    from robogame_tpu_torch.control import cbf as cbf_mod
    from robogame_tpu_torch.control import trajopt as tr
    from robogame_tpu_torch.ops import qp, qp_lanes

    # ---- phase 4: both matchups through monte_carlo ---------------------
    cbf = rt.CbfParams()
    policy, params, snaps, k2_main, agg_c = run_classical(
        rt, kernels, "classical_cbf", cbf, dev, card)
    *_, agg_n = run_classical(
        rt, kernels, "classical_nocbf", None, dev, card)
    dm_c, dm_n = agg_c["mean_total_damage"], agg_n["mean_total_damage"]
    print(f"phase4 damage mean: CBF {dm_c:.4f} vs no CBF {dm_n:.4f}",
          flush=True)
    check(dm_c < dm_n, "the CBF filter did not cut the mean damage")
    for k in SNAP_STEPS:
        carry, states = snaps[k]
        hold_policy(rt, f"step {k}: K2 vs plain on the card", policy,
                    params, carry, states, cbf, "plain")
    carry, states = snaps[SNAP_STEPS[0]]
    first = lambda a: a[:16].contiguous()
    c16 = tuple(cl._map(first, ts) for ts in carry)
    s16 = type(states)(*(first(a) for a in states))
    hold_policy(rt, f"step {SNAP_STEPS[0]}, 16 games: card vs CPU",
                policy, params, c16, s16, cbf, "cpu")

    # ---- phase 5: K2 against its plain version, times -------------------
    x = states.x
    B5 = B_CL * 5
    c4 = [a.reshape(B5, 2) for a in cl._team_candidates(
        x, -1, params, rt.StrategyParams())[:4]]
    T, _, g, lo, hi = tr.candidate_qps(torch.cat(c4[:2], 1),
                                       torch.cat(c4[2:], 1), params)
    skills = (T.H, g, T.A, lo, hi)
    kernels.reset_launches()
    err_s, ks = k2_vs_plain(f"(a) skills, step {SNAP_STEPS[0]}", *skills,
                            group=B5, iters=60)
    routes = kernels.k2_routes()
    print(f"phase5 (a) skills K2 problems by route: {routes}", flush=True)
    check(routes["grouped"] == g.shape[0] and not routes["listed"] and
          not routes["per_problem"], "(a) the skills did not all take the "
          "grouped route")
    # how far each f32 route lies from the plain version in f64: the
    # grouped kernel, its plain version, the plain f32 version
    Hb, Ab = (a.repeat_interleave(B5, 0) for a in (T.H, T.A))
    ps32 = qp.solve_qp(Hb, g, Ab, lo, hi, iters=60)
    ps64 = qp.solve_qp(*(a.double() for a in (Hb, g, Ab, lo, hi)),
                       iters=60)
    gpl = qp_lanes.solve_qp_grouped_plain(*skills, group=B5, iters=60)
    sols = {"K2": ks, "grouped plain version": gpl, "plain f32": ps32}
    all3 = ps64.converged
    for sol in sols.values():
        all3 = all3 & sol.converged
    n3 = int(all3.sum())
    far = {}
    for key, sol in sols.items():
        d = (sol.x.double() - ps64.x).abs()[all3]
        off = int((d > X_ATOL + X_RTOL * ps64.x.abs()[all3]).any(-1).sum())
        dmax = d.amax(-1)
        far[key] = (off, float(dmax.mean()), float(dmax.max()))
        print(f"phase5 (a') skills, {key} against the plain version in f64 "
              f"({n3} problems all converged): {off} outside "
              f"{X_ATOL}/{X_RTOL}; max|dx| a problem: max "
              f"{float(dmax.max()):.4g}, 99.9% "
              f"{float(dmax.quantile(0.999)):.4g}, mean "
              f"{float(dmax.mean()):.4g}", flush=True)
    # no further from f64 than the plain f32 version: at most one problem
    # more outside the tolerance, and a problem's max |dx| no larger in
    # the mean nor at its largest
    (k_off, k_mean, k_max), (p_off, p_mean, p_max) = far["K2"], \
        far["plain f32"]
    check(k_off <= p_off + 1 and k_mean <= p_mean and k_max <= p_max,
          f"(a') K2 lies further from f64 than the plain f32 version: "
          f"{far['K2']} vs {far['plain f32']}")
    u_nom = torch.cat([rt.team_policy_batch(ts, x, f, params,
                                            rt.StrategyParams())[1]
                       for f, ts in zip((-1, 1), carry)], dim=1)
    cbf_qp = cbf_mod._build_qp(u_nom, x[:, :4, 0:2], x[:, :4, 2:4], params,
                               cbf)[:5]
    err_c, _ = k2_vs_plain(f"(b) CBF, step {SNAP_STEPS[0]}", *cbf_qp,
                           iters=cbf.qp_iters)
    rnd = random_qps(dev, 2048, 40, 140, n_eq=4)
    k2_vs_plain("(c) random (40, 140), row scaling, 4 equality rows", *rnd,
                iters=60, scale_rows=True)
    # DMPC's 150 iterations with 10 equality rows (1e3 rho): K is
    # ill-conditioned and the flags sit on a knife-edge; each f32 route
    # against the plain version in f64 (reported, not held)
    rnd = random_qps(dev, 2048, 40, 140, n_eq=10)
    f64 = qp.solve_qp(*(a.double() for a in rnd), iters=150,
                      scale_rows=True)
    k = qp_lanes.solve_qp_lanes(*rnd, iters=150, scale_rows=True)
    p = qp.solve_qp(*rnd, iters=150, scale_rows=True)
    agree = lambda a, b: float((a.converged == b.converged).float().mean())
    print(f"phase5 (c') (40, 140), 10 equality rows, 150 iterations: flags "
          f"K2 vs plain {agree(k, p):.4f}, K2 vs f64 {agree(k, f64):.4f}, "
          f"plain vs f64 {agree(p, f64):.4f}; converged (f64) "
          f"{float(f64.converged.float().mean()):.3f}", flush=True)
    # groups at the skills shape with equality rows in 5% of the problems:
    # those go from the grouped launch to the per-problem kernel
    grp = grouped_qps(dev, 16, 640, 30, 60, n_eq=3, share=0.05)
    kernels.reset_launches()
    k2_vs_plain("(c'') 16 groups of 640 (30, 60), 3 equality rows in 5%",
                *grp, group=640, iters=60)
    routes = kernels.k2_routes()
    n_eq = int((grp[3] == grp[4]).any(-1).sum())
    print(f"phase5 (c'') K2 problems by route: {routes} ({n_eq} with an "
          f"equality row)", flush=True)
    check(routes["listed"] == n_eq > 0 and
          routes["grouped"] == grp[1].shape[0] - n_eq,
          "(c'') the equality-row problems did not take the per-problem "
          "kernel")
    # (d) a grouped launch repeats itself bitwise, and agrees with the
    # per-problem kernel on the broadcast operands within K2's tolerances
    ks2 = qp_lanes.solve_qp_lanes(*skills, group=B5, iters=60)
    check(all(torch.equal(a, b) for a, b in zip(ks, ks2)),
          "(d) two grouped launches differ")
    bc = qp_lanes.solve_qp_lanes(Hb, g, Ab, lo, hi, iters=60)
    held_against(ks, bc, "(d) grouped vs the broadcast operands on the "
                 "per-problem kernel", T.H, g, B5, lo.shape[1])
    print("phase5 (d) two grouped launches bitwise equal", flush=True)

    entries = []
    occ = kernels.qp_grouped_occupancy()
    for tag, qpa, group, iters, n, m, err in (
            ("skills QPs", skills, B5, 60, 30, 60, err_s),
            ("CBF QPs", cbf_qp, 1, cbf.qp_iters, 8, 20, err_c)):
        run = lambda: qp_lanes.solve_qp_lanes(*qpa, group=group,
                                              iters=iters)
        for _ in range(3):
            run()
        ms, _ = cuda_ms(run, reps=20)
        Hf = qpa[0].repeat_interleave(group, 0)
        Af = qpa[2].repeat_interleave(group, 0)
        plain_ms, _ = cuda_ms(lambda: qp.solve_qp(
            Hf, qpa[1], Af, qpa[3], qpa[4], iters=iters), reps=3)
        P = qpa[1].shape[0]
        G = qpa[0].shape[0]
        bound_f, by_f = k2_bound_ms(G, P, n, m, 4, iters // 4)
        if group > 1:
            setup_ms, _ = cuda_ms(lambda: kernels.qp_grouped_setup(
                qpa[0], qpa[2], 1e-6), reps=20)
            per_ms, _ = cuda_ms(lambda: kernels.qp_admm(
                *qpa, group, 4, iters // 4, 1.0, 1e-6, 1.6, 1e-3), reps=5)
            bound, by = k2_bound_ms(G, P, n, m, 4, iters // 4,
                                    k2_grouped_flops)
            source = "robogame_tpu_torch/csrc/qp_grouped.cu"
            kname = "K2 qp_grouped (grouped route)"
            print(f"phase5 K2 {tag} (P={P}, n={n}, m={m}), grouped route: "
                  f"{ms:.4f} ms per launch (its setup alone {setup_ms:.4f} "
                  f"ms, {G} groups; {occ['blocks_per_sm']} blocks of 80 "
                  f"problems an SM, {occ['smem_bytes']} shared bytes each); "
                  f"the per-problem kernel on the same problems "
                  f"{per_ms:.4f} ms; plain {plain_ms:.3f} ms; bound "
                  f"{bound:.4f} ms ({by}, grouped count "
                  f"{k2_grouped_flops(n, m, 4, iters // 4) / 1e6:.4f} "
                  f"MFLOP a problem) / {bound_f:.4f} ms with a factorization "
                  f"a segment ({k2_flops(n, m, 4, iters // 4) / 1e6:.4f} "
                  f"MFLOP)  [{card}]", flush=True)
            launches = k2_main[("grouped", n, m)]
        else:
            bound, by = bound_f, by_f
            source = "robogame_tpu_torch/csrc/qp_admm.cu"
            kname = "K2 qp_admm (per-problem route)"
            print(f"phase5 K2 {tag} (P={P}, n={n}, m={m}), per-problem "
                  f"route: {ms:.4f} ms per launch; plain {plain_ms:.3f} ms; "
                  f"bound {bound:.4f} ms ({by})  [{card}]", flush=True)
            launches = k2_main[("per_problem", n, m)]
        entries.append({
            "name": f"{kname}, {tag} (n={n}, m={m}, {P} per launch)",
            "route": "cuda",
            "source": source,
            "replaces": "robogame_tpu/ops/qp_pallas.py:100",
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })
    return entries


# ---------------------------------------------------------------------------
# phase 6: DMPC on K3
# ---------------------------------------------------------------------------

# a flag whose margin max(prim / (tol p_sc), dual / (10 tol d_sc)) lies
# within this share of 1 may flip under f32 roundoff
FLAG_EDGE = 1e-2
SET_ASIDE_MAX = 0.10    # share of games the policy check may set aside
# K3 against its plain version: the share of the SQPs (both converged)
# that may lie outside X_ATOL/X_RTOL.  The plain version in f32 itself lies
# outside that tolerance of the plain version in f64 on about 0.5% of the
# converged SQPs (flat directions of H, rank 4 plus 0.02 I, carried on by
# the nonconvex relinearization).
SQP_OFF_MAX = 0.01
# the share of the held games (four agents' warm states and controls each)
# outside X_ATOL/X_RTOL, pooled over the DMPC_SNAPS states of the run
# recorded in PERF.md (59 of 3,577 games); a policy check fails above its
# binomial 3-sigma upper bound for the check's number of games
POLICY_OFF_RATE = 59 / 3577


def policy_off_limit(n):
    p = POLICY_OFF_RATE
    return n * p + 3.0 * math.sqrt(n * p * (1.0 - p))

N_CPU = 64              # games of the DMPC policy held against the CPU


@contextlib.contextmanager
def sqp_hook(mode, seen, name="dmpc_sqp_stats"):
    """Record the inputs of every fused solve of the controllers through
    ``ops/sqp_lanes.<name>`` (DMPC's ``dmpc_sqp_stats``, on K3, or CMPC's
    ``cmpc_sqp_stats``, on K4) in ``seen`` and run it on its kernel
    (``mode='capture'``) or on the kernel's plain version on the tensors'
    own device (``mode='plain'``)."""
    from robogame_tpu_torch.ops import sqp_lanes
    kernel_route = getattr(sqp_lanes, name)
    plain_route = {"dmpc_sqp_stats": sqp_lanes._plain_stats,
                   "cmpc_sqp_stats": sqp_lanes._cmpc_plain_stats}[name]

    def hook(*args, **kw):
        seen.append((args, kw))
        if mode == "capture":
            return kernel_route(*args, **kw)
        return plain_route(*(a.float().contiguous() for a in args), **kw)

    setattr(sqp_lanes, name, hook)
    try:
        yield
    finally:
        setattr(sqp_lanes, name, kernel_route)


def k3_flops(n1, m, M, N, n_seg0, it0, sqp_rest, it_rest):
    """The f32 operations of one K3 solve on the knot-structured algebra,
    A never formed (csrc/knot_sqp.cuh): the gram terms once; per
    relinearization Y = SG x and the keepout rows' scales, bounds and
    coefficients, per warm one the dual rescale and the reseed; per
    segment the knots' 2 x 2 blocks Q, V = Q SG and the lower triangle of K
    = H + rho SG'V + diag, the Cholesky factor and its inverse (n1^3 / 3
    each) and the residuals (H x, A'y as SG'u); per iteration the fold of
    the rows into u, SG'u, C r, C't, SG x and the updates of the own and
    the box rows.  The loop counts are fixed, so every SQP does this
    work."""
    tri = n1 * (n1 + 1) // 2
    gram = 6 * N * n1
    relin = 4 * N * n1 + 2 * N + 25 * M * N
    warm = 5 * M * N + 2 * N
    seg = (6 * M + 2) * N + 6 * N * n1 + 4 * N * tri + 2 * tri + n1 + \
        2 * n1 ** 3 // 3 + 2 * n1 * n1 + 4 * N * n1 + 6 * m + 5 * (m + n1)
    it = 8 * N * n1 + 2 * n1 * (n1 + 1) + 19 * m + 15 * n1
    return gram + (1 + sqp_rest) * relin + sqp_rest * warm + \
        (n_seg0 + sqp_rest) * seg + (n_seg0 * it0 + sqp_rest * it_rest) * it


def k3_flops_dense(n1, m, M, N, n_seg0, it0, sqp_rest, it_rest):
    """The same solve counted on an explicit constraint matrix A (m x n1),
    kept beside :func:`k3_flops` so that bounds taken on either count stay
    comparable: the gram terms once; per relinearization the knot
    positions, the keepout rows and A; per reseed A x; per segment the
    lower triangle of K = H + rho A'A + diag, the Cholesky factor and its
    inverse and the residuals; per iteration two products with A, one with
    C and one with C' and the vector updates."""
    gram = 6 * N * n1
    relin = 4 * N * n1 + 20 * M * N + 4 * m * n1
    reseed = 2 * m * n1
    seg = m * n1 * (n1 + 1) + 2 * n1 ** 3 // 3 + 2 * m * n1 + \
        2 * n1 * n1 + 5 * m + 5 * n1
    it = 4 * m * n1 + 2 * n1 * n1 + 12 * m + 12 * n1
    return gram + (1 + sqp_rest) * relin + sqp_rest * reseed + \
        (n_seg0 + sqp_rest) * seg + (n_seg0 * it0 + sqp_rest * it_rest) * it


def k3_bound_ms(args, kw, count=k3_flops):
    """(bound ms, 'bytes' or 'operations') of one K3 launch on ``args``:
    each input read once, x and the 5 stats written once, against the f32
    rate, the operations counted by ``count``."""
    B, n1 = args[1].shape
    N, M = kw["N"], kw["n_obs"]
    nbytes = 4 * (sum(a.numel() for a in args) + B * (n1 + 5))
    flops = B * count(n1, (2 + M) * N, M, N, kw["n_seg0"], kw["it0"],
                      kw["sqp_rest"], kw["it_rest"])
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def _qp_objective(H, g, x):
    """1/2 x'Hx + g'x per problem in f64; H (B, n, n) or the blocks of a
    block-diagonal H (B, 2, n1, n1)."""
    H, g, x = H.double(), g.double(), x.double()
    xb = x.reshape(H.shape[:-1])
    quad = torch.einsum("b...i,b...ij,b...j->b", xb, H, xb)
    return 0.5 * quad + (g * x).sum(-1)


def sqp_vs_plain(tag, name, kernel, plain, args, objective):
    """Kernel ``name`` (K3, K4 or K5) and its plain version on the same
    problems: ``kernel(args)`` and ``plain(args)`` give (x, stats (B, 5)),
    ``objective(args, x)`` the QP objective.  Held: flags agree on >= 99%;
    where both converged, the objectives agree within 2e-2 (1 + |f|), x
    within X_ATOL/X_RTOL on all but SQP_OFF_MAX of the problems, and the
    kernel lies no further from the plain version in f64 than the plain
    version in f32 does (at most twice its count of problems outside
    X_ATOL/X_RTOL, plus 0.1%).  Reported: how many flag disagreements are
    knife-edges.  Returns max |dx| where both converged."""
    from robogame_tpu_torch.ops import sqp_lanes
    xk, sk = kernel(args)
    xp, sp = plain(args)
    x64, s64 = plain(tuple(a.double() for a in args))
    torch.cuda.synchronize()
    ck, cp, c64 = sk[:, 0] > 0.5, sp[:, 0] > 0.5, s64[:, 0] > 0.5
    agree = float((ck == cp).float().mean())
    both = ck & cp
    nb = int(both.sum())
    dx = (xk - xp).abs()
    err = float(dx[both].max()) if nb else 0.0
    off = both & (dx > X_ATOL + X_RTOL * xp.abs()).any(-1)
    fk, fp = (objective(args, x) for x in (xk, xp))
    df = ((fk - fp).abs() / (1 + fp.abs()))[both]
    dfmax = float(df.max()) if nb else 0.0
    dis = ck != cp
    edge = dis & (((sqp_lanes.flag_margin(sk) - 1).abs() <= FLAG_EDGE) |
                  ((sqp_lanes.flag_margin(sp) - 1).abs() <= FLAG_EDGE))
    all3 = both & c64
    n3 = int(all3.sum())
    d64 = [(x.double() - x64).abs() for x in (xk, xp)]
    off64 = [int((all3 & (d > X_ATOL + X_RTOL * x64.abs()).any(-1)).sum())
             for d in d64]
    d64 = [float(d[all3].max()) if n3 else 0.0 for d in d64]
    print(f"{tag}: {xk.shape[0]} problems: flags agree {agree:.5f} "
          f"({int(dis.sum())} differ, {int(edge.sum())} of them within "
          f"{FLAG_EDGE:.0%} of the threshold), converged {name} "
          f"{float(ck.float().mean()):.4f} plain {float(cp.float().mean()):.4f}"
          f" f64 {float(c64.float().mean()):.4f}; both converged {nb}: max|dx|"
          f" {err:.3g}, {int(off.sum())} outside {X_ATOL}/{X_RTOL}, max "
          f"|df|/(1+|f|) {dfmax:.3g}; against f64 ({n3} all converged) "
          f"outside {X_ATOL}/{X_RTOL}: {name} {off64[0]}, plain f32 "
          f"{off64[1]}; max|dx| {name} {d64[0]:.3g}, plain f32 {d64[1]:.3g}",
          flush=True)
    check(agree >= 0.99, f"{tag}: {name} and plain flags agree on {agree}")
    check(dfmax <= 2e-2, f"{tag}: {name}'s objective differs ({dfmax})")
    check(int(off.sum()) <= SQP_OFF_MAX * nb, f"{tag}: {name} disagrees with "
          f"its plain version ({int(off.sum())} problems, max {err})")
    check(off64[0] <= 2 * off64[1] + n3 // 1000, f"{tag}: {name} lies "
          f"further from the f64 solution than the plain f32 version "
          f"({off64})")
    return err


def k3_vs_plain(tag, args, kw):
    """K3 and its plain version on the same SQPs (``sqp_vs_plain``)."""
    from robogame_tpu_torch.ops import sqp_lanes
    return sqp_vs_plain(
        f"phase6 {tag}", "K3", lambda a: sqp_lanes.dmpc_sqp_stats(*a, **kw),
        lambda a: sqp_lanes._plain_stats(*a, **kw), args,
        lambda a, x: _qp_objective(a[0], a[1], x))


def _team_candidates(dt, dm, ts, x, field, params, mpc, strat, route="fused"):
    x0s, tgts, obss = dt.team_inputs(x, field, params, strat)
    return dm.candidates(dt._flat_states(ts), x0s.flatten(0, 1),
                         tgts.flatten(0, 1), obss.flatten(0, 1), params, mpc,
                         route)


def hold_mpc_policy(rt, tag, policy, params, carry, states, route, teams):
    """An MPC matchup's policy on its kernels (K3 for DMPC teams, K4 for CMPC
    teams) against the same policy on ``route`` ('plain': the kernels'
    plain versions on the card, 'cpu': on the CPU) from one state.
    ``teams`` lists (carry index, candidates(team carry, x)) of the MPC
    teams.  A game is set aside where a team's (or an agent's) winning
    candidate differs between the two and the difference is explained: the
    best cost within NEAR_TIE of another step size's on either side
    (``runner_up_gap``), a flag within FLAG_EDGE of its threshold, or a
    flag that differs between the sides.  In the other games every winner
    must be the same and the new warm states and controls agree within
    X_ATOL/X_RTOL; the caller holds the counts to its limits.  The plain
    route must make one solve per MPC team and call, and launch no K3 or
    K4.  Prints and returns (tag, share set aside, games outside, games
    held)."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.control import dmpc as dm
    B = states.x.shape[0]

    def other(fn, n_solves):
        if route == "cpu":
            cpu = lambda a: a.cpu()
            return fn(_tree_map(cpu, carry), _tree_map(cpu, states))
        calls = []
        before = (dict(kernels.sqp_launches), dict(kernels.cmpc_launches))
        with sqp_hook("plain", calls), sqp_hook("plain", calls,
                                                "cmpc_sqp_stats"):
            out = fn(carry, states)
        after = (dict(kernels.sqp_launches), dict(kernels.cmpc_launches))
        check(len(calls) == n_solves and after == before,
              f"{tag}: the plain route made {len(calls)} solves (expected "
              f"{n_solves}) and K3, K4 launches went {before} -> {after}")
        return out

    (ka, kb), uk = policy(carry, states)
    (pa, pb), up = other(policy, len(teams))
    aside = torch.zeros(B, dtype=torch.bool)
    odd = torch.zeros(B, dtype=torch.bool)
    for i, cands in teams:
        ck = cands(carry[i], states.x)
        cp = other(lambda c, s: cands(c[i], s.x), 1)
        ck, cp = (type(c)(*(a.cpu() for a in c)) for c in (ck, cp))
        differ = ck.cost.argmin(1) != cp.cost.argmin(1)
        explained = ((dm.runner_up_gap(ck) <= NEAR_TIE) |
                     (dm.runner_up_gap(cp) <= NEAR_TIE) |
                     ((ck.margin - 1).abs() <= FLAG_EDGE).any(1) |
                     ((cp.margin - 1).abs() <= FLAG_EDGE).any(1) |
                     (ck.conv != cp.conv).any(1))
        aside |= (differ & explained).reshape(B, -1).any(1)
        odd |= (differ & ~explained).reshape(B, -1).any(1)
    ok = ~aside
    err = 0.0
    off = odd.clone()
    for a, b in zip(_tensors((ka, kb, uk)), _tensors((pa, pb, up))):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.bool:
            off |= (a != b).reshape(B, -1).any(-1)
            continue
        d = (a - b).abs().reshape(B, -1)
        err = max(err, float(d[ok].max()) if bool(ok.any()) else 0.0)
        off |= (d > X_ATOL + X_RTOL * b.abs().reshape(B, -1)).any(-1)
    off &= ok
    n_ok = int(ok.sum())
    print(f"{tag}: {B} games, {int(aside.sum())} set aside "
          f"({float(aside.float().mean()):.4f}: a winner differs at a "
          f"near-tie or a flag edge); over the other {n_ok} max|d| "
          f"{err:.3g}, {int(off.sum())} games outside {X_ATOL}/{X_RTOL} "
          f"({int((odd & ok).sum())} with an unexplained winner)", flush=True)
    return tag, float(aside.float().mean()), int(off.sum()), n_ok


def hold_dmpc_policy(rt, tag, policy, params, carry, states, route):
    """``hold_mpc_policy`` for a DMPC matchup (the DMPC teams of
    ``carry``)."""
    from robogame_tpu_torch.agents import dmpc_team as dt
    from robogame_tpu_torch.control import dmpc as dm
    mpc, strat = rt.MpcParams(), rt.StrategyParams()
    teams = [(i, lambda ts, x, f=field: _team_candidates(
        dt, dm, ts, x, f, params, mpc, strat))
        for field, i in ((-1, 0), (1, 1)) if carry[i] is not None]
    return hold_mpc_policy(rt, f"phase6 {tag}", policy, params, carry,
                           states, route, teams)


def dmpc_phase(rt, dev, card):
    """Phase 6; returns K3's entry of the kernels line."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.agents import dmpc_team as dt
    from robogame_tpu_torch.control import dmpc as dm
    from robogame_tpu_torch.ops import sqp_lanes

    mpc, strat = rt.MpcParams(), rt.StrategyParams()
    # ---- (a) dmpc_vs_dmpc and dmpc_vs_noop through monte_carlo ----------
    runs = {}
    for name, opp in (("dmpc_vs_dmpc", "dmpc"), ("dmpc_vs_noop", "noop")):
        policy, ps0 = dt.dmpc_matchup(matchup_params(rt), B_CL, opp, mpc,
                                      strat, device=dev)
        params, snaps, launches, agg = run_matchup(
            rt, kernels, f"phase6 (a) {name}", policy, ps0, dev, card,
            DMPC_SNAPS)
        teams = 2 if opp == "dmpc" else 1
        want = {(2 * mpc.N, (2 + dm.N_NEIGHBORS) * mpc.N): teams * N_STEPS}
        check(launches["K3"] == want and not launches["K2"],
              f"{name}: K3 launches {launches['K3']}, expected {want}, K2 "
              f"{launches['K2']}")
        runs[name] = (policy, params, snaps, launches, agg)
    goals_a = runs["dmpc_vs_noop"][4]["mean_score_a"]
    print(f"phase6 (a) dmpc_vs_noop goals_a {goals_a:.4f} a game; "
          f"dmpc_vs_dmpc goals {runs['dmpc_vs_dmpc'][4]['mean_score_a']:.4f}"
          f" / {runs['dmpc_vs_dmpc'][4]['mean_score_b']:.4f}, mean damage "
          f"{runs['dmpc_vs_dmpc'][4]['mean_total_damage']:.4f}", flush=True)
    print(f"phase6 (a) rates: dmpc_vs_dmpc "
          f"{runs['dmpc_vs_dmpc'][4]['control_steps_per_s']:.1f}, "
          f"dmpc_vs_noop {runs['dmpc_vs_noop'][4]['control_steps_per_s']:.1f}"
          f" control-steps/s  [{card}]", flush=True)
    check(goals_a > 0, "dmpc_vs_noop: DMPC did not score")

    # ---- (b) K3 against its plain version at step 100 -------------------
    policy, params, snaps, launches, _ = runs["dmpc_vs_dmpc"]
    carry, states = snaps[SNAP_STEPS[0]]
    seen = []
    with sqp_hook("capture", seen):
        _team_candidates(dt, dm, carry[0], states.x, -1, params, mpc, strat)
    args, kw = seen[0]
    err = k3_vs_plain(f"(b) K3 vs plain, team A's {args[1].shape[0]} "
                      f"candidate SQPs at step {SNAP_STEPS[0]}", args, kw)

    # ---- (c) K3 with sqp_rest=0 against K2 (route 'lanes', 1 SQP step) --
    one = mpc.replace(sqp_iters=1)
    cf, cl_ = (_team_candidates(dt, dm, carry[0], states.x, -1, params, one,
                                strat, route) for route in ("fused", "lanes"))
    torch.cuda.synchronize()
    agree = float((cf.conv == cl_.conv).float().mean())
    both = cf.conv & cl_.conv
    d = (cf.U - cl_.U).abs()
    off = both & (d > X_ATOL + X_RTOL * cl_.U.abs()).any(-1)
    nb = int(both.sum())
    print(f"phase6 (c) K3 (sqp_rest=0) vs K2 (route 'lanes', 1 SQP "
          f"iteration) at step {SNAP_STEPS[0]}: flags agree {agree:.5f}, "
          f"both converged {nb}: max|dU| {float(d[both].max()):.3g}, "
          f"{int(off.sum())} outside {X_ATOL}/{X_RTOL}", flush=True)
    check(agree >= 0.99, f"(c) K3 and K2 flags agree on {agree}")
    check(int(off.sum()) <= SQP_OFF_MAX * nb, "(c) K3 (sqp_rest=0) "
          "disagrees with K2")

    # ---- (d) the policy on K3 against the policy on the plain version ---
    readings = [hold_dmpc_policy(rt, f"(d) step {k}: K3 vs plain on the "
                                 f"card", policy, params, *snaps[k], "plain")
                for k in DMPC_SNAPS]
    first = lambda a: a[:N_CPU].contiguous()
    readings += [hold_dmpc_policy(rt, f"(d) step {k}, {N_CPU} games: card vs "
                                  f"CPU", policy, params,
                                  *(_tree_map(first, a) for a in snaps[k]),
                                  "cpu")
                 for k in SNAP_STEPS]
    print(f"phase6 (d) games outside {X_ATOL}/{X_RTOL}, share of those held:"
          f" {[round(off / n_ok, 5) for _, _, off, n_ok in readings]}",
          flush=True)
    for tag, aside, off, n_ok in readings:
        check(aside <= SET_ASIDE_MAX, f"{tag}: {aside:.4f} of the games set "
              f"aside")
        check(off <= policy_off_limit(n_ok), f"{tag}: policy differs in "
              f"{off} of {n_ok} games (limit {policy_off_limit(n_ok):.2f})")

    # ---- (e) K3's time per launch at the production shape ---------------
    run = lambda: sqp_lanes.dmpc_sqp_stats(*args, **kw)
    for _ in range(2):
        run()
    ms, _ = cuda_ms(run, reps=10)
    plain_ms, _ = cuda_ms(lambda: sqp_lanes._plain_stats(*args, **kw),
                          reps=2)
    bound, by = k3_bound_ms(args, kw)
    dense, _ = k3_bound_ms(args, kw, k3_flops_dense)
    occ = kernels.occupancy("dmpc_sqp", kw["N"], kw["n_obs"])
    P, n1 = args[1].shape
    m_own = (2 + kw["n_obs"]) * kw["N"]
    print(f"phase6 (e) K3 (P={P}, n1={n1}, m_own={m_own}): {ms:.4f} ms per "
          f"launch; plain {plain_ms:.3f} ms; bound {bound:.4f} ms ({by}; "
          f"counted on an explicit A {dense:.4f} ms); "
          f"{occ['problems_per_sm']} problems an SM (one a block, "
          f"{occ['smem_bytes']} shared bytes a problem)  [{card}]",
          flush=True)
    return {
        "name": f"K3 dmpc_sqp, fused DMPC SQP (n1={n1}, m_own={m_own}, "
                f"{P} per launch)",
        "route": "cuda",
        "source": "robogame_tpu_torch/csrc/dmpc_sqp.cu",
        "replaces": "robogame_tpu/ops/sqp_pallas.py:482",
        "launches": launches["K3"][(n1, m_own)],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# phase 7: CMPC on K4 (and K5 on the "joint" route)
# ---------------------------------------------------------------------------

# the share of the held games (both CMPC teams' warm states and controls)
# outside X_ATOL/X_RTOL, pooled over the DMPC_SNAPS states of the
# cmpc_vs_cmpc run recorded in PERF.md (29 of 3,582 games); a policy check
# fails above its binomial 3-sigma upper bound for the check's number of
# games
CMPC_POLICY_OFF_RATE = 29 / 3582
N_CPU_CMPC = 64         # games of the CMPC policy held against the CPU
N_JOINT = 3             # control steps of cmpc_vs_cmpc on route 'joint'


def cmpc_policy_off_limit(n):
    p = CMPC_POLICY_OFF_RATE
    return n * p + 3.0 * math.sqrt(n * p * (1.0 - p))


@contextlib.contextmanager
def capture(module, name, seen):
    """Record the arguments of every call of ``module.name`` in ``seen``."""
    route = getattr(module, name)

    def hook(*args, **kw):
        seen.append((args, kw))
        return route(*args, **kw)

    setattr(module, name, hook)
    try:
        yield
    finally:
        setattr(module, name, route)


def _cmpc_candidates(ct, cm, cs, x, field, params, mpc, route="fused"):
    play = torch.full((x.shape[0],), ct.OFFENSE, dtype=torch.int32,
                      device=x.device)
    return cm.candidates(cs, *ct.team_inputs(x, play, field, params),
                         params, mpc, route)


def _joint_factor_flops(n1, mo, mp):
    """One factorization of the structured solve: K11 and S (lower
    triangles, with W'W), K12, W = C1 K12, two Cholesky factors and their
    inverses (n1^3 / 3 each)."""
    m1 = mo + mp
    tri = n1 * (n1 + 1) // 2
    return tri * (6 * m1 + 2 * n1 + 5) + 3 * n1 * n1 * mp + n1 ** 3 + \
        4 * n1 ** 3 // 3 + 4 * n1


def _joint_iter_flops(n1, mo, mp):
    """One ADMM iteration: w, A'w and the right-hand side, the six products
    of the Schur solve, A x, the box and the row updates."""
    m1, R = mo + mp, 2 * mo + mp
    return 12 * R + 8 * n1 * m1 + mp + 8 * n1 * n1 + 36 * n1


def _joint_res_flops(n1, mo, mp):
    """The residuals of a segment: H x, A'y and the maxima."""
    return 5 * (2 * mo + mp) + 2 * n1 * (2 * n1 + 2 * (mo + mp) + 10)


def k5_flops(n1, mo, mp, n_seg, seg_iters):
    """The f32 operations of one K5 solve (every loop count is fixed)."""
    return n_seg * (_joint_factor_flops(n1, mo, mp) +
                    _joint_res_flops(n1, mo, mp) +
                    seg_iters * _joint_iter_flops(n1, mo, mp))


def k4_flops(n1, mo, mp, M, N, n_seg0, it0, sqp_rest, it_rest):
    """The f32 operations of one K4 solve on the knot-structured algebra,
    A never formed (csrc/knot_sqp.cuh): the gram terms once; per
    relinearization both players' Y = SG x, the keepout and pair rows'
    scales, bounds and coefficients, per warm one the dual rescale and the
    reseed; per segment K11 and K22 as H + rho SG'V (V = Q SG), K12 as N
    rank-1 terms, W = C1 K12, S = K22 - W'W, two Cholesky factors and
    their inverses, the residuals; per iteration the fold into u, SG'u and
    SG x for both players, the six products of the Schur solve and the
    row and box updates (every loop count is fixed)."""
    R = 2 * mo + mp
    tri = n1 * (n1 + 1) // 2
    gram = 12 * N * n1
    relin = 2 * (4 * N * n1 + 2 * N + 25 * M * N) + 30 * N
    warm = 2 * (5 * M * N + 2 * N) + 5 * N
    seg = 2 * (6 * M + 8) * N + 2 * (6 * N * n1 + 4 * N * tri + 2 * tri +
                                     n1) + \
        2 * N * n1 * n1 + 6 * N * n1 + n1 * n1 + n1 * n1 * (n1 + 1) + \
        2 * n1 * tri + 4 * n1 ** 3 // 3 + \
        4 * n1 * n1 + 8 * N * n1 + 4 * R + 5 * (R + 2 * n1)
    it = 6 * R + 16 * N * n1 + 4 * n1 * (n1 + 1) + 4 * n1 * n1 + 2 * n1 + \
        3 * (2 * M * N + mp) + 10 * R + 30 * n1
    return gram + (1 + sqp_rest) * relin + sqp_rest * warm + \
        (n_seg0 + sqp_rest) * seg + (n_seg0 * it0 + sqp_rest * it_rest) * it


def k4_flops_dense(n1, mo, mp, M, N, n_seg0, it0, sqp_rest, it_rest):
    """The same solve counted on an explicit A (the rows of each player's
    columns), kept beside :func:`k4_flops` so that bounds taken on either
    count stay comparable: the gram terms once; per relinearization the
    knot positions, the rows' scales and bounds and A; per warm iteration
    the dual rescale and the reseed z = A x; the segments as K5's."""
    R = 2 * mo + mp
    gram = 2 * N * 6 * n1
    relin = 2 * N * (4 * n1 + 10 + 25 * M) + 30 * N + 10 * n1 * (mo + mp)
    reseed = 4 * n1 * (mo + mp) + mp + 2 * R
    seg = _joint_factor_flops(n1, mo, mp) + _joint_res_flops(n1, mo, mp)
    it = _joint_iter_flops(n1, mo, mp)
    return gram + (1 + sqp_rest) * relin + sqp_rest * reseed + \
        (n_seg0 + sqp_rest) * seg + (n_seg0 * it0 + sqp_rest * it_rest) * it


def _bound(args, n_out, flops):
    """(bound ms, 'bytes' or 'operations'): each input of ``args`` read
    once and ``n_out`` floats written once, against the f32 rate."""
    nbytes = 4 * (sum(a.numel() for a in args) + n_out)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def _dense_joint(Hb, g, Ab, l, u, lx, ux, m_own):
    """The structured joint QP assembled densely for ``solve_qp``: H =
    blockdiag(Hb), A = [I (the box rows); own rows of each player in its
    columns; the pair rows across both]."""
    B, _, m1, n1 = Ab.shape
    mp = m1 - m_own
    H = torch.zeros((B, 2 * n1, 2 * n1), dtype=Hb.dtype, device=Hb.device)
    H[:, :n1, :n1] = Hb[:, 0]
    H[:, n1:, n1:] = Hb[:, 1]
    A = torch.zeros((B, 2 * n1 + 2 * m_own + mp, 2 * n1), dtype=Ab.dtype,
                    device=Ab.device)
    A[:, :2 * n1] = torch.eye(2 * n1, dtype=Ab.dtype, device=Ab.device)
    r = 2 * n1
    A[:, r:r + m_own, :n1] = Ab[:, 0, :m_own]
    A[:, r + m_own:r + 2 * m_own, n1:] = Ab[:, 1, :m_own]
    A[:, r + 2 * m_own:, :n1] = Ab[:, 0, m_own:]
    A[:, r + 2 * m_own:, n1:] = Ab[:, 1, m_own:]
    return H, g, A, torch.cat([lx, l], 1), torch.cat([ux, u], 1)


def cmpc_phase(rt, dev, card):
    """Phase 7; returns K4's and K5's entries of the kernels line."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.agents import centralized as ct
    from robogame_tpu_torch.agents import dmpc_team as dt
    from robogame_tpu_torch.control import cmpc as cm
    from robogame_tpu_torch.control import dmpc as dm
    from robogame_tpu_torch.ops import qp, qp_lanes, sqp_lanes

    mpc = rt.MpcParams()
    N = mpc.N
    n1, mo = 2 * N, (2 + cm.N_OBS) * N
    key = (n1, mo, N)
    # ---- (a) cmpc_vs_cmpc and dmpc_vs_cmpc through monte_carlo ----------
    runs = {}
    for name in ("cmpc_vs_cmpc", "dmpc_vs_cmpc"):
        if name == "cmpc_vs_cmpc":
            policy, ps0 = rt.cmpc_matchup(matchup_params(rt), B_CL, mpc=mpc,
                                          device=dev)
            snap, teams = DMPC_SNAPS, 2
            want3 = {}
        else:
            policy, ps0 = dt.dmpc_matchup(matchup_params(rt), B_CL, "cmpc",
                                          mpc, device=dev)
            snap, teams = (), 1
            want3 = {(n1, (2 + dm.N_NEIGHBORS) * N): N_STEPS}
        params, snaps, launches, agg = run_matchup(
            rt, kernels, f"phase7 (a) {name}", policy, ps0, dev, card, snap)
        want4 = {key: teams * N_STEPS}
        check(launches["K4"] == want4 and launches["K3"] == want3 and
              not launches["K2"] and not launches["K5"],
              f"{name}: K4 launches {launches['K4']} (expected {want4}), K3 "
              f"{launches['K3']} (expected {want3}), K2 {launches['K2']}, K5 "
              f"{launches['K5']}")
        print(f"phase7 (a) {name}: goals a game A {agg['mean_score_a']:.4f} "
              f"B {agg['mean_score_b']:.4f}; wins-draws-losses (A) "
              f"{agg['wins_a']}-{agg['draws']}-{agg['wins_b']}; mean damage "
              f"{agg['mean_total_damage']:.4f}  [{card}]", flush=True)
        runs[name] = (policy, params, snaps, launches, agg)
    agg = runs["dmpc_vs_cmpc"][4]
    print(f"phase7 (a) rates: cmpc_vs_cmpc "
          f"{runs['cmpc_vs_cmpc'][4]['control_steps_per_s']:.1f}, "
          f"dmpc_vs_cmpc {agg['control_steps_per_s']:.1f} control-steps/s  "
          f"[{card}]", flush=True)
    check(agg["mean_score_a"] > agg["mean_score_b"], "dmpc_vs_cmpc: the DMPC "
          "team did not outscore the CMPC team")

    # ---- (b) K4 against its plain version at step 100 -------------------
    policy, params, snaps, launches, _ = runs["cmpc_vs_cmpc"]
    carry, states = snaps[SNAP_STEPS[0]]
    seen = []
    with sqp_hook("capture", seen, "cmpc_sqp_stats"):
        _cmpc_candidates(ct, cm, carry[0], states.x, -1, params, mpc)
    args, kw = seen[0]
    args = tuple(a.float().contiguous() for a in args)
    P4 = args[1].shape[0]
    err4 = sqp_vs_plain(
        f"phase7 (b) K4 vs plain, team A's {P4} candidate SQPs at step "
        f"{SNAP_STEPS[0]}", "K4",
        lambda a: sqp_lanes.cmpc_sqp_stats(*a, **kw),
        lambda a: sqp_lanes._cmpc_plain_stats(*a, **kw), args,
        lambda a, x: _qp_objective(a[0], a[1], x))

    # ---- (c) K4 with sqp_rest=0 against K5; K5 against its plain version
    # and against the dense solve_qp
    one = mpc.replace(sqp_iters=1)
    cf = _cmpc_candidates(ct, cm, carry[0], states.x, -1, params, one)
    seen5 = []
    with capture(qp_lanes, "joint_qp_stats", seen5):
        cj = _cmpc_candidates(ct, cm, carry[0], states.x, -1, params, one,
                              "joint")
    torch.cuda.synchronize()
    agree = float((cf.conv == cj.conv).float().mean())
    both = cf.conv & cj.conv
    d = (cf.U - cj.U).abs()
    off = both & (d > X_ATOL + X_RTOL * cj.U.abs()).any(-1)
    nb = int(both.sum())
    print(f"phase7 (c) K4 (sqp_rest=0) vs K5 (route 'joint', 1 SQP "
          f"iteration) at step {SNAP_STEPS[0]}: flags agree {agree:.5f}, "
          f"both converged {nb}: max|dU| {float(d[both].max()):.3g}, "
          f"{int(off.sum())} outside {X_ATOL}/{X_RTOL}", flush=True)
    check(agree >= 0.99, f"(c) K4 and K5 flags agree on {agree}")
    check(int(off.sum()) <= SQP_OFF_MAX * nb, "(c) K4 (sqp_rest=0) "
          "disagrees with K5")
    args5, kw5 = seen5[0]
    m_own, m_pair, iters = kw5["m_own"], kw5["m_pair"], kw5["iters"]
    Ab, l, u = qp_lanes.joint_row_scale(*(a.float() for a in args5[2:5]),
                                        m_own)
    args5 = tuple(a.float().contiguous() for a in (
        args5[0], args5[1], Ab, l, u, args5[5], args5[6]))
    kw5 = dict(m_own=m_own, m_pair=m_pair, n_seg=4,
               seg_iters=max(1, iters // 4), rho=1.0, sigma=1e-6, alpha=1.6,
               tol=1e-3)
    err5 = sqp_vs_plain(
        f"phase7 (c) K5 vs plain, team A's {P4} candidate QPs at step "
        f"{SNAP_STEPS[0]}", "K5", lambda a: kernels.qp_joint(*a, **kw5),
        lambda a: qp_lanes.joint_plain_stats(*a, **kw5), args5,
        lambda a, x: _qp_objective(a[0], a[1], x))
    xk, sk = kernels.qp_joint(*args5, **kw5)
    dense = qp.solve_qp(*_dense_joint(*args5, m_own), iters=iters)
    torch.cuda.synchronize()
    ck = sk[:, 0] > 0.5
    agree = float((ck == dense.converged).float().mean())
    both = ck & dense.converged
    d = (xk - dense.x).abs()
    off = both & (d > X_ATOL + X_RTOL * dense.x.abs()).any(-1)
    nb = int(both.sum())
    print(f"phase7 (c) K5 vs the dense solve_qp on the assembled problems "
          f"(n={2 * n1}, m={2 * n1 + 2 * m_own + m_pair}): flags agree "
          f"{agree:.5f}, both converged {nb}: max|dx| "
          f"{float(d[both].max()):.3g}, {int(off.sum())} outside "
          f"{X_ATOL}/{X_RTOL}", flush=True)
    check(agree >= 0.99, f"(c) K5 and the dense solve flags agree on {agree}")
    check(int(off.sum()) <= SQP_OFF_MAX * nb, "(c) K5 disagrees with the "
          "dense solve")

    # ---- (d) the policy on K4 against the policy on the plain version ---
    teams = [(i, lambda cs, x, f=field: _cmpc_candidates(
        ct, cm, cs, x, f, params, mpc)) for field, i in ((-1, 0), (1, 1))]
    readings = [hold_mpc_policy(rt, f"phase7 (d) step {k}: K4 vs plain on "
                                f"the card", policy, params, *snaps[k],
                                "plain", teams)
                for k in DMPC_SNAPS]
    first = lambda a: a[:N_CPU_CMPC].contiguous()
    readings += [hold_mpc_policy(
        rt, f"phase7 (d) step {SNAP_STEPS[0]}, {N_CPU_CMPC} games: card vs "
        f"CPU", policy, params, *(_tree_map(first, a)
                                  for a in snaps[SNAP_STEPS[0]]), "cpu",
        teams)]
    n_off = sum(r[2] for r in readings[:-1])
    n_held = sum(r[3] for r in readings[:-1])
    print(f"phase7 (d) games outside {X_ATOL}/{X_RTOL}, share of those held:"
          f" {[round(off / n_ok, 5) for _, _, off, n_ok in readings]}; "
          f"pooled over the card states {n_off} of {n_held} "
          f"({n_off / max(n_held, 1):.5f})", flush=True)
    for tag, aside, off, n_ok in readings:
        check(aside <= SET_ASIDE_MAX, f"{tag}: {aside:.4f} of the games set "
              f"aside")
        check(off <= cmpc_policy_off_limit(n_ok), f"{tag}: policy differs "
              f"in {off} of {n_ok} games (limit "
              f"{cmpc_policy_off_limit(n_ok):.2f})")

    # ---- (e) cmpc_vs_cmpc on route 'joint' (K5, relinearized) -----------
    carry, states = _clone(snaps[SNAP_STEPS[0]])
    kernels.reset_launches()
    step_ms = []
    for _ in range(N_JOINT):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ca, u_a = ct.team_step_batch(carry[0], states.x, ct.OFFENSE, -1,
                                     params, mpc, "joint")
        cb, u_b = ct.team_step_batch(carry[1], states.x, ct.OFFENSE, 1,
                                     params, mpc, "joint")
        states = rt.step_batch(states, torch.cat([u_a, u_b], 1), params,
                               device=dev)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        carry = (ca, cb)
    k5_launches = dict(kernels.joint_launches)
    want5 = {key: 2 * N_JOINT * mpc.sqp_iters}
    print(f"phase7 (e) cmpc_vs_cmpc on route 'joint' from step "
          f"{SNAP_STEPS[0]}: {N_JOINT} steps of "
          f"{[round(t, 3) for t in step_ms]}"
          f" ms; K5 launches {k5_launches}  [{card}]", flush=True)
    check(k5_launches == want5 and not kernels.cmpc_launches and
          bool(torch.isfinite(states.x).all()),
          f"(e) K5 launches {k5_launches}, expected {want5}")

    # ---- (f) K4's and K5's times per launch ------------------------------
    entries = []
    sched = (kw["n_seg0"], kw["it0"], kw["sqp_rest"], kw["it_rest"])
    for name, run, plain, a, flops, err, n_launch, src, repl, label in (
            ("K4", lambda: sqp_lanes.cmpc_sqp_stats(*args, **kw),
             lambda: sqp_lanes._cmpc_plain_stats(*args, **kw), args,
             k4_flops(n1, mo, N, cm.N_OBS, N, *sched), err4,
             launches["K4"][key], "cmpc_sqp.cu", "sqp_pallas.py:77",
             "cmpc_sqp, fused joint CMPC SQP"),
            ("K5", lambda: kernels.qp_joint(*args5, **kw5),
             lambda: qp_lanes.joint_plain_stats(*args5, **kw5), args5,
             k5_flops(n1, mo, N, kw5["n_seg"], kw5["seg_iters"]), err5,
             k5_launches[key], "qp_joint.cu", "qp_pallas.py:420",
             "qp_joint, structured joint QP")):
        for _ in range(2):
            run()
        ms, _ = cuda_ms(run, reps=5)
        plain_ms, _ = cuda_ms(plain, reps=2)
        P = a[1].shape[0]
        bound, by = _bound(a, P * (2 * n1 + 5), P * flops)
        extra = ""
        if name == "K4":
            dense = k4_flops_dense(n1, mo, N, cm.N_OBS, N, *sched)
            occ = kernels.occupancy("cmpc_sqp", N, cm.N_OBS)
            extra = (f"; counted on an explicit A {dense / 1e6:.2f} MFLOP, "
                     f"bound {_bound(a, P * (2 * n1 + 5), P * dense)[0]:.4f}"
                     f" ms; {occ['problems_per_sm']} problems an SM "
                     f"({occ['smem_bytes']} shared bytes a problem)")
        print(f"phase7 (f) {name} (P={P}, n1={n1} x 2, m_own={mo} x 2, "
              f"m_pair={N}): {ms:.4f} ms per launch; plain {plain_ms:.3f} "
              f"ms; bound {bound:.4f} ms ({by}: {flops / 1e6:.2f} MFLOP a "
              f"problem{extra})  [{card}]", flush=True)
        entries.append({
            "name": f"{name} {label} (n1={n1} x 2, m_own={mo} x 2, "
                    f"m_pair={N}, {P} per launch)",
            "route": "cuda",
            "source": f"robogame_tpu_torch/csrc/{src}",
            "replaces": f"robogame_tpu/ops/{repl}",
            "launches": n_launch,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })
    return entries


# ---------------------------------------------------------------------------
# phase 8: the parallel-resolution step on K6, and the sweep engine
# ---------------------------------------------------------------------------

B_STOCH = 2048                     # bench_sweep.py's stochastic row
B_SWEEP, SWEEP_STEPS = 2048, 40    # the sweep engine on the card
N_CPU6 = 64                        # games of the main path held on the CPU
K6_DMG_TOL = 5e-4                  # their damage, card against CPU
SWEEP_X_TOL, SWEEP_DMG_TOL = 1e-4, 1e-5   # sweep per step, card vs CPU


def _k6_both(ex, ps, kernels, T, planes, up, mode, cap, npl=None,
             grid=None, carry=None):
    """K6 and its plain version on the same card tensors."""
    k = kernels.parallel_step(T.M6, T.FI, T.SP, T.consts, planes[0], up,
                              planes[1], planes[2], npl, grid, carry, mode,
                              cap)
    q = ps.parallel_step_plain(T, planes[0], up, planes[1], planes[2], npl,
                               grid, carry, mode, cap)
    torch.cuda.synchronize()
    return k, q


def _equal_outputs(k, q, mode):
    same = torch.equal(k[0], q[0]) and torch.equal(k[1], q[1])
    if mode == "export":
        same = same and torch.equal(k[2], q[2]) and torch.equal(k[3], q[3])
    return same


def pallas_phase(rt, dev, card, u_uni, k1_rate):
    """Phase 8: K6 against its plain version, two-phase against one-phase,
    the bench workload and its stochastic row on engine="pallas", the
    sweep engine on the card, and K6's time; returns K6's kernels entry."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.physics import exact_step as ex
    from robogame_tpu_torch.physics import parallel_step as ps
    from robogame_tpu_torch.physics.sweep import (_substep_affine_np,
                                                  game_draws, populate_noise)
    mc_mod = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")
    P6 = rt.SimParams(engine="pallas", two_phase=False)
    T = ex._tabs(P6, dev)
    errs = []

    def every_mode(tag, s, u, params, npl=None):
        """Modes full, export (grid and carry too) and resume, bitwise."""
        planes = ex._to_planes(s)
        up = ex._u_plane(u, s.x.shape[0])
        kf, qf = _k6_both(ex, ps, kernels, T, planes, up, "full",
                          params.sweep_iters, npl)
        ke, qe = _k6_both(ex, ps, kernels, T, planes, up, "export", 1, npl)
        kr, qr = _k6_both(ex, ps, kernels, T, planes, up, "resume",
                          params.sweep_iters - 1, None, ke[2], ke[3])
        diff = max(maxdiff(a, b) for a, b in ((kf[0], qf[0]), (kf[1], qf[1]),
                                              (ke[2], qe[2]), (ke[3], qe[3]),
                                              (kr[0], qr[0]), (kr[1], qr[1])))
        errs.append(diff)
        trips = float(kf[1][4].max())
        print(f"phase8 (a) {tag}: full / export / resume max|diff| "
              f"{diff:.3g}, loop trips mean {float(kf[1][4].mean()):.3f} "
              f"max {trips:.0f}", flush=True)
        check(_equal_outputs(kf, qf, "full") and
              _equal_outputs(ke, qe, "export") and
              _equal_outputs(kr, qr, "resume"),
              f"(8a) {tag}: K6 differs from its plain version")
        return kf, trips

    # ---- (a) K6 against its plain version, every mode ------------------
    mcp = rt.McParams(num_runs=B_MAIN, randomize_x0=True)
    s = mc_mod._initial_states(P6, mcp, device=dev)
    for k in range(30):
        s = rt.step_batch(s, u_uni[k // HOLD], P6, device=dev)
    for k in range(30, 33):
        every_mode(f"uniform B={B_MAIN} step {k}", s, u_uni[k // HOLD], P6)
        s = rt.step_batch(s, u_uni[k // HOLD], P6, device=dev)
    Bc = 1024
    g = torch.Generator().manual_seed(2)
    corner = (torch.randint(0, 2, (Bc, 1, 2), generator=g) * 16.0
              - 8.0).expand(Bc, 4, 2).contiguous().to(dev)
    sc = mc_mod._initial_states(P6, rt.McParams(num_runs=Bc,
                                                randomize_x0=True), dev)
    for _ in range(26):
        sc = rt.step_batch(sc, corner, P6, device=dev)
    deepest = 0.0
    for k in range(3):
        _, trips = every_mode(f"corner B={Bc} step {26 + k}", sc, corner, P6)
        deepest = max(deepest, trips)
        sc = rt.step_batch(sc, corner, P6, device=dev)
    check(deepest >= P6.sweep_iters, "(8a) no corner game reached the cap")
    pst = P6.replace(stochastic=True, noise=1.0)
    (xp,), _ = game_draws(sc, (P6.grid_points,))
    every_mode(f"stochastic corner B={Bc}", sc, corner, pst,
               ex._noise_plane(populate_noise(xp, pst)))
    p0 = P6.replace(stochastic=True, noise=0.0)
    planes = ex._to_planes(sc)
    up = ex._u_plane(corner, Bc)
    z0 = ex._noise_plane(populate_noise(xp, p0))
    det = ps._kernel_call(planes, up, P6)
    sto = ps._kernel_call(planes, up, p0, z0)
    check(all(torch.equal(a, b) for a, b in zip(det, sto)),
          "(8a) noise=0 differs from deterministic")
    print("phase8 (a) noise=0 == deterministic bitwise", flush=True)

    # ---- (b) two-phase == one-phase in the kernel, both paths -----------
    pinned_x = sc.x.clone()
    pin_u = torch.zeros((Bc, 4, 2), device=dev)
    for pl, (sx, sy) in enumerate([(-1, -1), (-1, 1), (1, -1), (1, 1)]):
        pinned_x[:, pl] = torch.tensor([4.81 * sx, 2.31 * sy, 0.01 * sx,
                                        0.01 * sy], device=dev)
        pin_u[:, pl] = torch.tensor([8.0 * sx, 8.0 * sy], device=dev)
    pinned = sc._replace(x=pinned_x, score=torch.zeros_like(sc.score))
    for tag, st, u in (("compact", s, u_uni[3]), ("overflow", pinned, pin_u)):
        B = st.x.shape[0]
        planes = ex._to_planes(st)
        up = ex._u_plane(u, B)
        (_, m1, _), _, _ = ps._kernel_call(planes, up, P6, mode="export",
                                           cap=1)
        n_pend = int(m1[5].sum())
        check(n_pend > 0, f"(8b) {tag}: no game pending after phase 1")
        frac = B // (-(-n_pend // ex.BLOCK) * ex.BLOCK) if tag == "compact" \
            else B // ex.BLOCK
        p2 = P6.replace(two_phase=True, compact_frac=max(frac, 1))
        K = ex._compact_lanes(B, p2)
        one = ps._kernel_call(planes, up, P6)
        two = ps._twophase_planes(planes, up, p2)
        torch.cuda.synchronize()
        undec = (planes[1][0] < P6.winning_score) & \
            (planes[1][1] < P6.winning_score)
        rows = [0, 1, 2, 5]             # meta row 4 counts each call's trips
        check(torch.equal(one[0], two[0]) and torch.equal(one[2], two[2])
              and torch.equal(one[1][rows], two[1][rows])
              and torch.equal(one[1][3][undec], two[1][3][undec]),
              f"(8b) {tag}: two-phase differs from one-phase")
        if tag == "compact":
            check(0 < n_pend <= K < B, f"(8b) compact path not taken "
                  f"({n_pend} pending, K={K})")
        else:
            check(n_pend > K, f"(8b) overflow path not taken ({n_pend})")
        print(f"phase8 (b) {tag}: B={B} K={K} pending={n_pend}: two-phase "
              f"== one-phase bitwise", flush=True)

    # ---- (c) the main path: the bench workload on engine="pallas" -------
    pm = rt.SimParams(engine="pallas", winning_score=4, two_phase=True,
                      phase1_iters=1, compact_frac=16)
    mc_main = rt.McParams(num_runs=B_MAIN, T=20.0, randomize_x0=True)

    def schedule(ps_, states):
        k, u_base = ps_
        return (k + 1, u_base), u_base[k // HOLD]

    warm = rt.monte_carlo(pm, rt.McParams(num_runs=B_MAIN, T=1.0,
                                          randomize_x0=True),
                          policy=schedule, policy_state=(0, u_uni),
                          device=dev)
    _ = warm.scores.cpu()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = rt.monte_carlo(pm, mc_main, policy=schedule,
                         policy_state=(0, u_uni), device=dev)
    scores = res.scores.cpu()
    wall = time.perf_counter() - t0
    launches6 = dict(kernels.parallel_launches)
    launches1 = dict(kernels.launches)
    rate = B_MAIN * N_STEPS / wall
    print(f"phase8 (c) main path engine=pallas: B={B_MAIN} x {N_STEPS} "
          f"steps in {wall:.3f} s wall: {rate:.1f} control-steps/s; "
          f"engine=pallas_exact (phase 2): {k1_rate:.1f} control-steps/s; "
          f"K6 / K1 {rate / k1_rate:.4f}  [{card}]", flush=True)
    print(f"phase8 (c) K6 launches: {launches6}; K1 launches: {launches1}",
          flush=True)
    check(launches6["export"] == N_STEPS and launches6["resume"] == N_STEPS
          and launches6["full"] == 0 and sum(launches1.values()) == 0,
          "(8c) main path did not run K6's two-phase once a step")
    check(scores.shape == (B_MAIN, 2) and bool(torch.isfinite(
        res.damage).all()) and bool(((scores >= 0) &
                                     (scores <= pm.winning_score)).all()),
          "(8c) main path outputs malformed")
    t_fin = res.t_final.cpu()
    undecided = (scores < pm.winning_score).all(dim=1)
    check(bool(undecided.any()) and bool(
        (t_fin[undecided] - N_STEPS * pm.dt).abs().max() < 1e-3),
        "(8c) undecided games did not run the full game")
    print(f"phase8 (c) aggregate: {json.dumps(rt.aggregate(res))}",
          flush=True)
    mc_ref = rt.McParams(num_runs=N_CPU6, T=2.0, randomize_x0=True)
    ref_cpu = rt.monte_carlo(pm, mc_ref, policy=schedule,
                             policy_state=(0, u_uni[:, :N_CPU6].cpu()),
                             device="cpu")
    ref_gpu = rt.monte_carlo(pm, mc_ref, policy=schedule,
                             policy_state=(0, u_uni[:, :N_CPU6]), device=dev)
    dref = maxdiff(ref_gpu.damage.cpu(), ref_cpu.damage)
    check(torch.equal(ref_cpu.scores, ref_gpu.scores.cpu()),
          "(8c) scores differ from the plain version on the CPU")
    check(dref <= K6_DMG_TOL, f"(8c) damage vs the plain CPU sweep: {dref}")
    print(f"phase8 (c) check: {N_CPU6} games x 40 steps on the card == "
          f"plain version on the CPU (scores equal, max|ddmg| {dref:.3g})",
          flush=True)

    # ---- (d) the stochastic row: B=2048, noise=1.0 ----------------------
    pn = pm.replace(stochastic=True, noise=1.0)
    u_st = u_uni[:, :B_STOCH]
    t0 = time.perf_counter()
    res_n = rt.monte_carlo(pn, rt.McParams(num_runs=B_STOCH, T=20.0,
                                           randomize_x0=True),
                           policy=schedule, policy_state=(0, u_st),
                           device=dev)
    _ = res_n.scores.cpu()
    wall_n = time.perf_counter() - t0
    check(bool(torch.isfinite(res_n.damage).all()),
          "(8d) stochastic row malformed")
    n_v = 8
    pv = P6.replace(stochastic=True, noise=0.8)
    sv = rt.initial_state(pv, seed=list(range(1, B_STOCH + 1)), device=dev)
    u0 = torch.zeros((B_STOCH, 4, 2), device=dev)
    for _ in range(n_v):
        sv = rt.step_batch(sv, u0, pv, device=dev)
    F, _, L = _substep_affine_np(pv)
    C = (pv.noise ** 2) * (L @ L.T)
    V = np.zeros((4, 4))
    for _ in range(n_v * pv.grid_points):
        V = F[0] @ V @ F[0].T + C
    sig_v = math.sqrt(V[2, 2])
    v_std = float(sv.x[:, :4, 2:4].std())
    rel = abs(v_std - sig_v) / sig_v
    print(f"phase8 (d) stochastic row: B={B_STOCH} x {N_STEPS} steps, "
          f"noise=1.0, in {wall_n:.3f} s wall: "
          f"{B_STOCH * N_STEPS / wall_n:.1f} control-steps/s; velocity std "
          f"at zero input after {n_v} steps {v_std:.5f} vs analytic "
          f"{sig_v:.5f} ({rel:.4f})  [{card}]", flush=True)
    check(rel < 0.06, f"(8d) velocity std off the analytic value by {rel}")

    # ---- (e) the sweep engine on the card -------------------------------
    psw = rt.SimParams(engine="sweep", winning_score=4)
    ss = mc_mod._initial_states(psw, rt.McParams(num_runs=B_SWEEP,
                                                 randomize_x0=True), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(SWEEP_STEPS):
        ss = rt.step_batch(ss, u_uni[k // HOLD, :B_SWEEP], psw, device=dev)
    _ = ss.score.cpu()
    wall_s = time.perf_counter() - t0
    worst = (0.0, 0.0)
    held = ss
    for k in range(SWEEP_STEPS, SWEEP_STEPS + 3):
        sub = rt.GameState(*(a[:N_CPU6] for a in held))
        u = u_uni[k // HOLD, :N_CPU6]
        gcard = rt.step_batch(sub, u, psw, device=dev)
        gcpu = rt.step_batch(rt.GameState(*(a.cpu() for a in sub)), u.cpu(),
                             psw, device="cpu")
        check(torch.equal(gcard.score.cpu(), gcpu.score),
              "(8e) sweep scores differ between the card and the CPU")
        worst = (max(worst[0], maxdiff(gcard.x.cpu(), gcpu.x)),
                 max(worst[1], maxdiff(gcard.damage.cpu(), gcpu.damage)))
        held = rt.step_batch(held, u_uni[k // HOLD, :B_SWEEP], psw,
                             device=dev)
    check(worst[0] <= SWEEP_X_TOL and worst[1] <= SWEEP_DMG_TOL,
          f"(8e) sweep on the card vs the CPU: {worst}")
    print(f"phase8 (e) sweep engine: B={B_SWEEP} x {SWEEP_STEPS} steps in "
          f"{wall_s:.3f} s wall ({B_SWEEP * SWEEP_STEPS / wall_s:.1f} "
          f"control-steps/s); {N_CPU6} games x 3 steps card vs CPU: scores "
          f"equal, max|dx| {worst[0]:.3g}, max|ddmg| {worst[1]:.3g}  "
          f"[{card}]", flush=True)

    # ---- (f) K6's time per control step at the main path's shapes -------
    sm = mc_mod._initial_states(pm, mc_main, device=dev)
    sm, _ = mc_mod._run_batch(sm, pm, 200, schedule, (0, u_uni), device=dev)
    planes = ex._to_planes(sm)
    up = ex._u_plane(u_uni[20], B_MAIN)
    run_export = lambda: kernels.parallel_step(
        T.M6, T.FI, T.SP, T.consts, planes[0], up, planes[1], planes[2],
        None, None, None, "export", 1)
    for _ in range(3):
        run_export()
    exp_ms, (xo, aux, grid, carry) = cuda_ms(run_export, reps=20)
    n_pend = int(aux[5].sum())
    K = ex._compact_lanes(B_MAIN, pm)
    K = K if n_pend <= K else B_MAIN        # the overflow guard's resume
    idx = torch.argsort(-aux[5], stable=True)[:K]
    g_in = [a[:, idx].contiguous() for a in (*planes, up, carry)]
    grid_k = grid[..., idx].contiguous()
    rest = pm.sweep_iters - pm.phase1_iters
    run_resume = lambda: kernels.parallel_step(
        T.M6, T.FI, T.SP, T.consts, g_in[0], g_in[3], g_in[1], g_in[2], None,
        grid_k, g_in[4], "resume", rest)
    for _ in range(3):
        run_resume()
    res_ms, (_, aux_r, _, _) = cuda_ms(run_resume, reps=20)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"phase8 (f) K6 at B={B_MAIN}, step 200, a warp a game: export "
          f"{exp_ms:.4f} ms, resume {res_ms:.4f} ms; the resume's {K} games "
          f"run {K / n_sm:.2f} warps an SM on {-(-K // 4)} blocks of 4  "
          f"[{card}]", flush=True)
    pl_exp_ms, pl_exp = cuda_ms(lambda: ps.parallel_step_plain(
        T, planes[0], up, planes[1], planes[2], None, None, None, "export",
        1))
    pl_res_ms, pl_res = cuda_ms(lambda: ps.parallel_step_plain(
        T, g_in[0], g_in[3], g_in[1], g_in[2], None, grid_k, g_in[4],
        "resume", rest))
    errf = max(maxdiff(xo, pl_exp[0]), maxdiff(aux, pl_exp[1]),
               maxdiff(grid, pl_exp[2]), maxdiff(carry, pl_exp[3]),
               maxdiff(aux_r, pl_res[1]))
    check(errf == 0.0, f"(8f) K6 vs plain {errf}")
    errs.append(errf)
    # bound: each input read once, each output written once (f32) ...
    K1c = pm.grid_points + 1
    table = (T.M6.numel() + T.FI.numel() + T.SP.numel()) * 4
    bytes_exp = 4 * B_MAIN * (20 + 10 + 8 + 16 + 20 + 24 + 20 * K1c + 32)
    bytes_res = 4 * K * (20 + 10 + 8 + 16 + 20 * K1c + 32 + 20 + 24)
    nbytes = bytes_exp + bytes_res + 2 * table
    # ... and a lower count of the f32 operations, as phase 3 counts K1's:
    # the populate (6 mul + 5 add per grid cell) and ~200 per loop
    # iteration (one resolved event's two partial RK4s and impulse);
    # detect and the tails not counted
    iters = float(aux[4].sum()) + float(aux_r[4].sum())
    ops = 11 * 20 * K1c * B_MAIN + 200 * iters
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    print(f"phase8 (f) K6 at B={B_MAIN} (step 200, pending {n_pend}, resume "
          f"over {K}, {iters:.0f} loop iterations): export {exp_ms:.4f} ms + "
          f"resume {res_ms:.4f} ms; plain {pl_exp_ms:.1f} + {pl_res_ms:.1f} "
          f"ms; bound {t_bytes:.4f} ms bytes / {t_ops:.4f} ms ops; library "
          f"none  [{card}]", flush=True)
    return {
        "name": "K6 parallel_step (export + resume per step)",
        "route": "cuda",
        "source": "robogame_tpu_torch/csrc/parallel_step.cu",
        "replaces": "robogame_tpu/physics/pallas_step.py:130",
        "launches": sum(launches6.values()),
        "max_abs_err": max(errs),
        "ms": exp_ms + res_ms,
        "plain_ms": pl_exp_ms + pl_res_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import robogame_tpu_torch as rt
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.physics import exact_step as ex
    mc_mod = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 0: card, build -------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase0 build K1-K6: {build_s:.2f} s (nvcc seconds "
          f"{kernels.build_seconds})  [{card}]", flush=True)
    for name, tag in (("qp_grouped", "K2 grouped"), ("dmpc_sqp", "K3"),
                      ("cmpc_sqp", "K4")):
        for line in ptxas_report(kernels.build_log.get(name, "")):
            print(f"phase0 {tag} ptxas: {line}", flush=True)

    P1 = rt.SimParams(engine="pallas_exact", two_phase=False)
    errs = []

    def compare(tag, s, u, params, xtol, dtol, npl=None, rpl=None):
        """One mode-exact K1 step and its plain version from state s."""
        planes = ex._to_planes(s)
        up = ex._u_plane(u, s.x.shape[0])
        T = ex._tabs(params, dev)
        k = ex._kernel_call(planes, up, params, npl, mode="exact",
                            rnoise_plane=rpl)
        p = ex.exact_step_plain(T, *planes[:1], up, *planes[1:], npl, rpl,
                                None, None, "exact", 49)
        p = (p[0], p[1][0:8], p[1][8:24])
        torch.cuda.synchronize()
        dx, dm = maxdiff(k[0], p[0]), maxdiff(k[2], p[2])
        dmeta = maxdiff(k[1][0:4], p[1][0:4])
        print(f"phase1 {tag}: max|dx| {dx:.3g} max|ddmg| {dm:.3g} "
              f"max|dmeta| {dmeta:.3g} events/game "
              f"{float(k[1][3].mean()):.3f}", flush=True)
        check(torch.equal(k[1][0:2], p[1][0:2]), f"{tag}: scores differ")
        check(dx <= xtol and dm <= dtol * (1 + float(p[2].abs().max())),
              f"{tag}: K1 disagrees with its plain version")
        errs.append(max(dx, dm))
        return k

    # ---- phase 1a: exact at B=8192 on MC starts, uniform schedule -------
    sched_g = torch.Generator().manual_seed(0)
    u_uni = (torch.rand((N_STEPS // HOLD, B_MAIN, 4, 2), generator=sched_g)
             * 16.0 - 8.0).to(dev)
    mcp = rt.McParams(num_runs=B_MAIN, randomize_x0=True)
    s = mc_mod._initial_states(P1, mcp, device=dev)
    for k in range(30):
        s = rt.step_batch(s, u_uni[k // HOLD], P1, device=dev)
    for k in range(30, 33):
        compare(f"(a) exact B={B_MAIN} step {k}", s, u_uni[k // HOLD], P1,
                1e-4, 1e-4)
        s = rt.step_batch(s, u_uni[k // HOLD], P1, device=dev)

    # ---- phase 1b: corner grinding --------------------------------------
    Bc = 1024
    corner = (torch.randint(0, 2, (Bc, 1, 2), generator=sched_g) * 16.0
              - 8.0).expand(Bc, 4, 2).contiguous().to(dev)
    sc = mc_mod._initial_states(P1, rt.McParams(num_runs=Bc,
                                                randomize_x0=True), dev)
    for _ in range(26):
        sc = rt.step_batch(sc, corner, P1, device=dev)
    deepest = 0.0
    for k in range(3):
        out = compare(f"(b) corner B={Bc} step {26 + k}", sc, corner, P1,
                      5e-3, 2e-3)
        deepest = max(deepest, float(out[1][3].max()))
        sc = rt.step_batch(sc, corner, P1, device=dev)
    check(deepest >= 49, "(b) no game reached the event cap")

    # ---- phase 1c: two-phase == one-phase, compacted and overflow -------
    # (the export and resume modes are held against the plain version in
    # phase 3, at the main path's shapes)
    for tag, st, u in (("compact", s, u_uni[3]), ("overflow", sc, corner)):
        B = st.x.shape[0]
        planes = ex._to_planes(st)
        up = ex._u_plane(u, B)
        (_, m1, _), _, _ = ex._kernel_call(planes, up, P1,
                                           mode="exact_export", cap=1)
        n_pend = int(m1[5].sum())
        check(n_pend > 0, f"(c) {tag}: no game pending after phase 1")
        # compact: a budget just above the pending count; overflow: one
        # block of lanes
        frac = B // (-(-n_pend // ex.BLOCK) * ex.BLOCK) if tag == "compact" \
            else B // ex.BLOCK
        p2 = P1.replace(two_phase=True, compact_frac=max(frac, 1))
        K = ex._compact_lanes(B, p2)
        one = ex._kernel_call(planes, up, P1, mode="exact")
        two = ex._twophase_planes_exact(planes, up, p2)
        torch.cuda.synchronize()
        rows = [0, 1, 2, 3, 5]          # meta row 4 counts this call's trips
        check(torch.equal(one[0], two[0]) and torch.equal(one[2], two[2])
              and torch.equal(one[1][rows], two[1][rows]),
              f"(c) {tag}: two-phase differs from one-phase")
        if tag == "compact":
            check(0 < n_pend <= K < B, f"(c) compact path not taken "
                  f"({n_pend} pending, K={K})")
        else:
            check(n_pend > K, f"(c) overflow path not taken ({n_pend})")
        print(f"phase1 (c) {tag}: B={B} K={K} pending={n_pend}: two-phase "
              f"== one-phase bitwise", flush=True)

    # ---- phase 1d: stochastic with identical planes; noise=0 ------------
    ps = P1.replace(stochastic=True, noise=1.0)
    npl, rpl, _ = ex._noise_planes(sc, ps)
    compare(f"(d) stochastic B={Bc}", sc, corner, ps, 5e-3, 2e-3, npl, rpl)
    p0 = P1.replace(stochastic=True, noise=0.0)
    z0, r0, _ = ex._noise_planes(sc, p0)
    planes = ex._to_planes(sc)
    up = ex._u_plane(corner, Bc)
    det = ex._kernel_call(planes, up, P1, mode="exact")
    sto = ex._kernel_call(planes, up, p0, z0, mode="exact", rnoise_plane=r0)
    check(all(torch.equal(a, b) for a, b in zip(det, sto)),
          "(d) noise=0 differs from deterministic")
    print("phase1 (d) noise=0 == deterministic bitwise", flush=True)

    # ---- phase 2: the main path -----------------------------------------
    pm = rt.SimParams(engine="pallas_exact", winning_score=4,
                      two_phase=True, phase1_iters=1, compact_frac=16)
    mc_main = rt.McParams(num_runs=B_MAIN, T=20.0,
                          randomize_x0=True)

    def schedule(ps_, states):
        k, u_base = ps_
        return (k + 1, u_base), u_base[k // HOLD]

    warm = rt.monte_carlo(pm, rt.McParams(num_runs=B_MAIN, T=1.0,
                                          randomize_x0=True),
                          policy=schedule, policy_state=(0, u_uni),
                          device=dev)
    _ = warm.scores.cpu()
    kernels.reset_launches()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    ev0.record()
    res = rt.monte_carlo(pm, mc_main, policy=schedule,
                         policy_state=(0, u_uni), device=dev)
    ev1.record()
    scores = res.scores.cpu()
    wall = time.perf_counter() - t0
    dev_ms = ev0.elapsed_time(ev1)
    main_launches = dict(kernels.launches)
    rate = B_MAIN * N_STEPS / wall
    print(f"phase2 main path: B={B_MAIN} x {N_STEPS} steps in {wall:.3f} s "
          f"wall ({dev_ms:.1f} ms between CUDA events): {rate:.1f} "
          f"control-steps/s  [{card}]", flush=True)
    print(f"phase2 K1 launches: {main_launches}", flush=True)
    check(main_launches["exact_export"] >= N_STEPS and
          main_launches["exact_resume"] >= N_STEPS,
          "main path did not run the two-phase kernel every step")
    check(scores.shape == (B_MAIN, 2) and res.damage.shape == (B_MAIN, 4, 4)
          and bool(torch.isfinite(res.damage).all()),
          "main path outputs malformed")
    check(bool(((scores >= 0) & (scores <= pm.winning_score)).all()),
          "scores out of range")
    t_fin = res.t_final.cpu()
    undecided = (scores < pm.winning_score).all(dim=1)
    check(bool(undecided.any()) and bool(
        (t_fin[undecided] - N_STEPS * pm.dt).abs().max() < 1e-3),
        "undecided games did not run the full game")
    agg = rt.aggregate(res)
    print(f"phase2 aggregate: {json.dumps(agg)}", flush=True)
    # the first 64 games, swept by the plain version on the CPU
    nref = 64
    mc_ref = rt.McParams(num_runs=nref, T=2.0, randomize_x0=True)
    ref_cpu = rt.monte_carlo(pm, mc_ref, policy=schedule,
                             policy_state=(0, u_uni[:, :nref].cpu()),
                             device="cpu")
    ref_gpu = rt.monte_carlo(pm, mc_ref, policy=schedule,
                             policy_state=(0, u_uni[:, :nref]), device=dev)
    check(torch.equal(ref_cpu.scores, ref_gpu.scores.cpu()),
          "main path scores differ from the plain version on the CPU")
    dref = maxdiff(ref_gpu.damage.cpu(), ref_cpu.damage)
    check(dref <= 5e-4, f"main path damage vs plain CPU sweep: {dref}")
    print(f"phase2 check: {nref} games x 40 steps on the card == plain "
          f"version on the CPU (scores equal, max|ddmg| {dref:.3g})",
          flush=True)

    # ---- phase 3: K1 time per control step at the main path's shapes ----
    sm = mc_mod._initial_states(pm, mc_main, device=dev)
    sm, _ = mc_mod._run_batch(sm, pm, 200, schedule, (0, u_uni), device=dev)
    planes = ex._to_planes(sm)
    up = ex._u_plane(u_uni[20], B_MAIN)
    T = ex._tabs(pm, dev)
    run_export = lambda: kernels.exact_step(
        T.M6, T.consts, planes[0], up, planes[1], planes[2], None, None,
        None, None, "exact_export", 1)
    for _ in range(3):
        run_export()
    exp_ms, (xo, aux, grid, carry) = cuda_ms(run_export, reps=20)
    n_pend = int(aux[5].sum())
    K = ex._compact_lanes(B_MAIN, pm)
    K = K if n_pend <= K else B_MAIN        # the overflow guard's resume
    idx = torch.argsort(-aux[5], stable=True)[:K]
    g_in = [a[:, idx].contiguous() for a in (*planes, up, carry)]
    grid_k = grid[..., idx].contiguous()
    run_resume = lambda: kernels.exact_step(
        T.M6, T.consts, g_in[0], g_in[3], g_in[1], g_in[2], None, None,
        grid_k, g_in[4], "exact_resume", 48)
    for _ in range(3):
        run_resume()
    res_ms, (_, aux_r, _, _) = cuda_ms(run_resume, reps=20)
    pl_exp_ms, pl_exp = cuda_ms(lambda: ex.exact_step_plain(
        T, planes[0], up, planes[1], planes[2], None, None, None, None,
        "exact_export", 1))
    pl_res_ms, pl_res = cuda_ms(lambda: ex.exact_step_plain(
        T, g_in[0], g_in[3], g_in[1], g_in[2], None, None, grid_k, g_in[4],
        "exact_resume", 48))
    err3 = max(maxdiff(xo, pl_exp[0]), maxdiff(aux, pl_exp[1]),
               maxdiff(grid, pl_exp[2]), maxdiff(aux_r, pl_res[1]))
    check(err3 <= 5e-3, f"phase3: K1 vs plain {err3}")
    errs.append(err3)
    # bound: each input read once, each output written once (f32) ...
    K1c = pm.grid_points + 1
    table = T.M6.numel() * 4
    bytes_exp = 4 * B_MAIN * (20 + 10 + 8 + 16 + 20 + 24 + 20 * K1c + 48)
    bytes_res = 4 * K * (20 + 10 + 8 + 16 + 20 * K1c + 48 + 20 + 24)
    nbytes = bytes_exp + bytes_res + 2 * table
    # ... and a lower count of the f32 operations: the populate (6 mul +
    # 5 add per grid cell) and ~200 per resolved event (two partial RK4s
    # per entity and the impulse); detect and re-propagation not counted
    events = float(aux[3].sum()) + float(aux_r[4].sum())
    ops = 11 * 20 * K1c * B_MAIN + 200 * events
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    kern = {
        "name": "K1 exact_step (exact_export + exact_resume per step)",
        "route": "cuda",
        "source": "robogame_tpu_torch/csrc/exact_step.cu",
        "replaces": "robogame_tpu/physics/pallas_step.py:130",
        "launches": sum(main_launches.values()),
        "max_abs_err": max(errs),
        "ms": exp_ms + res_ms,
        "plain_ms": pl_exp_ms + pl_res_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    print(f"phase3 K1 at B={B_MAIN} (step 200, pending {n_pend}, resume "
          f"over {K}): "
          f"export {exp_ms:.4f} ms + resume {res_ms:.4f} ms; plain "
          f"{pl_exp_ms:.1f} + {pl_res_ms:.1f} ms; bound {t_bytes:.4f} ms "
          f"bytes / {t_ops:.4f} ms ops  [{card}]", flush=True)
    k2 = closed_loop_and_k2(rt, dev, card)
    k3 = dmpc_phase(rt, dev, card)
    k45 = cmpc_phase(rt, dev, card)
    k6 = pallas_phase(rt, dev, card, u_uni, rate)
    print(json.dumps({"kernels": [kern, *k2, k3, *k45, k6]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

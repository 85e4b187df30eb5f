#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each failing loudly (nothing here catches an error):

0. the card's name and power limit (nvidia-smi), then the builds of the
   hand-written CUDA kernels K1 (csrc/exact_step.cu), K2 (csrc/qp_admm.cu)
   and K3 (csrc/dmpc_sqp.cu) from this checkout, one nvcc each, started
   together;
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
   (K2: 3 per step with CBF, 2 without); CBF must cut the mean damage.
   From the states of steps 100 and 200 of the CBF run, the policy on K2
   is held against the policy on K2's plain version on the card, and 16
   games' policy output on the card against the CPU;
5. K2 against its plain version on the card: the skills QPs (n=30, m=60,
   40960 problems) and the CBF QPs (8, 20) of a mid-game matchup state,
   random DMPC-shaped QPs (40, 140) with row scaling and equality rows
   (and, reported only, how each f32 route's flags agree with the plain
   version in f64 at 150 iterations), and shared operands bitwise equal to
   their broadcast; K2's time per
   launch at both matchup shapes beside its bound and the plain time;
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
   (e) K3's time per launch beside its bound and the plain time.

The kernels' times go out as one JSON line ``{"kernels": [...]}`` (K1,
K2 at the skills shape, K2 at the CBF shape, K3); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
1 before printing any result.
"""

import contextlib
import dataclasses
import importlib
import json
import math
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


def k2_bound_ms(G, P, n, m, n_seg, seg_iters):
    """(bound ms, 'bytes' or 'operations') of one K2 launch: each input
    read once (G shared H and A, per-problem g, l, u), each output written
    once (x and 3 flags), against the f32 rate."""
    nbytes = 4 * (G * (n * n + m * n) + P * (n + 2 * m) + P * (n + 3))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = P * k2_flops(n, m, n_seg, seg_iters) / H100_F32_PER_S * 1e3
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
    print(f"phase5 {tag}: P={g.shape[0]} n={g.shape[1]} m={l.shape[1]}: "
          f"flags agree {agree:.5f}, both converged {nb}; there max|dx| "
          f"{err:.3g}, {int(off.sum())} problems outside "
          f"{X_ATOL}/{X_RTOL}, max |df|/(1+|f|) {dfmax:.3g}", flush=True)
    check(agree >= 0.99, f"{tag}: K2 and plain flags agree on {agree}")
    check(dfmax <= 2e-2, f"{tag}: K2's objective differs ({dfmax})")
    check(int(off.sum()) <= nb // 1000, f"{tag}: K2 disagrees with its "
          f"plain version ({err})")
    return err, k


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


def matchup_params(rt):
    """The matchups' physics (examples/matchups.py:180)."""
    return rt.SimParams(dt=0.05, winning_score=4, engine="pallas_exact")


def run_matchup(rt, kernels, name, policy, ps0, dev, card, snap=SNAP_STEPS):
    """One 512-game matchup of N_STEPS steps through monte_carlo after a
    10-step warm-up; returns (params, snapshots {step: (carry, states)} at
    the steps ``snap``, launches {"K1", "K2", "K3"} of the run,
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
    launches = {"K1": dict(kernels.launches), "K2": dict(kernels.qp_launches),
                "K3": dict(kernels.sqp_launches)}
    agg = rt.aggregate(res)
    print(f"{name}: {B_CL} games x {step[0]} steps in {wall:.3f} s wall "
          f"({ev0.elapsed_time(ev1):.1f} ms between CUDA events): "
          f"{B_CL / wall:.3f} games/s, {B_CL * step[0] / wall:.1f} "
          f"control-steps/s  [{card}]", flush=True)
    print(f"{name} launches: {launches}", flush=True)
    print(f"{name} aggregate: {json.dumps(agg)}", flush=True)
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
    """A classical matchup (phase 4): K2 runs 2 skills launches a step and
    one CBF launch with the filter; returns (policy, params, snapshots, K2
    launches, aggregate)."""
    policy, ps0 = rt.classical_matchup(matchup_params(rt), B_CL, cbf=cbf,
                                       device=dev)
    params, snaps, launches, agg = run_matchup(
        rt, kernels, f"phase4 {name}", policy, ps0, dev, card)
    want = {(30, 60): 2 * N_STEPS}
    if cbf is not None:
        want[(8, 20)] = N_STEPS
    k2 = launches["K2"]
    check(k2 == want, f"{name}: K2 launches {k2}, expected {want}")
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
    err_s, ks = k2_vs_plain(f"(a) skills, step {SNAP_STEPS[0]}", *skills,
                            group=B5, iters=60)
    # how far each f32 route lies from the plain version in f64 (reported)
    ps32 = qp.solve_qp(T.H.repeat_interleave(B5, 0), g,
                       T.A.repeat_interleave(B5, 0), lo, hi, iters=60)
    ps64 = qp.solve_qp(*(a.double() for a in (
        T.H.repeat_interleave(B5, 0), g, T.A.repeat_interleave(B5, 0), lo,
        hi)), iters=60)
    all3 = ks.converged & ps32.converged & ps64.converged
    d64 = [float((a.x.double() - ps64.x).abs()[all3].max()) for a in (
        ks, ps32)]
    print(f"phase5 (a') skills against the plain version in f64, "
          f"{int(all3.sum())} problems all converged: max|dx| K2 {d64[0]:.3g}, plain f32 "
          f"{d64[1]:.3g}", flush=True)
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
    bc = qp_lanes.solve_qp_lanes(T.H.repeat_interleave(B5, 0), g,
                                 T.A.repeat_interleave(B5, 0), lo, hi,
                                 iters=60)
    check(all(torch.equal(a, b) for a, b in zip(ks, bc)),
          "(d) grouped operands differ from their broadcast")
    print("phase5 (d) skills with 16 shared H and A == the broadcast "
          "operands, bitwise", flush=True)

    entries = []
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
        bound, by = k2_bound_ms(qpa[0].shape[0], P, n, m, 4, iters // 4)
        print(f"phase5 K2 {tag} (P={P}, n={n}, m={m}): {ms:.4f} ms per "
              f"launch; plain {plain_ms:.3f} ms; bound {bound:.4f} ms "
              f"({by})  [{card}]", flush=True)
        entries.append({
            "name": f"K2 qp_admm, {tag} (n={n}, m={m}, {P} per launch)",
            "route": "cuda",
            "source": "robogame_tpu_torch/csrc/qp_admm.cu",
            "replaces": "robogame_tpu/ops/qp_pallas.py:100",
            "launches": k2_main[(n, m)],
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
def sqp_hook(mode, seen):
    """Record the inputs of every fused DMPC solve of the controllers in
    ``seen`` and run it on K3 (``mode='capture'``) or on K3's plain version
    on the tensors' own device (``mode='plain'``)."""
    from robogame_tpu_torch.ops import sqp_lanes
    kernel_route = sqp_lanes.dmpc_sqp_stats

    def hook(*args, **kw):
        seen.append((args, kw))
        if mode == "capture":
            return kernel_route(*args, **kw)
        return sqp_lanes._plain_stats(*(a.float().contiguous()
                                        for a in args), **kw)

    sqp_lanes.dmpc_sqp_stats = hook
    try:
        yield
    finally:
        sqp_lanes.dmpc_sqp_stats = kernel_route


def k3_flops(n1, m, M, N, n_seg0, it0, sqp_rest, it_rest):
    """The f32 operations of one K3 solve: the gram terms once; per
    relinearization the knot positions, the keepout rows and A; per
    reseed A x; per segment the lower triangle of K, the Cholesky factor
    and its inverse (n1^3 / 3 each) and the residuals; per iteration two
    products with A, one with C and one with C' and the vector updates of
    the own and the box rows.  The loop counts are fixed, so every SQP
    does this work."""
    gram = 6 * N * n1
    relin = 4 * N * n1 + 20 * M * N + 4 * m * n1
    reseed = 2 * m * n1
    seg = m * n1 * (n1 + 1) + 2 * n1 ** 3 // 3 + 2 * m * n1 + \
        2 * n1 * n1 + 5 * m + 5 * n1
    it = 4 * m * n1 + 2 * n1 * n1 + 12 * m + 12 * n1
    return gram + (1 + sqp_rest) * relin + sqp_rest * reseed + \
        (n_seg0 + sqp_rest) * seg + (n_seg0 * it0 + sqp_rest * it_rest) * it


def k3_bound_ms(args, kw):
    """(bound ms, 'bytes' or 'operations') of one K3 launch on ``args``:
    each input read once, x and the 5 stats written once, against the f32
    rate."""
    B, n1 = args[1].shape
    N, M = kw["N"], kw["n_obs"]
    nbytes = 4 * (sum(a.numel() for a in args) + B * (n1 + 5))
    flops = B * k3_flops(n1, (2 + M) * N, M, N, kw["n_seg0"], kw["it0"],
                         kw["sqp_rest"], kw["it_rest"])
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def k3_vs_plain(tag, args, kw):
    """K3 and its plain version on the same SQPs.  Held: flags agree on >=
    99%; where both converged, the QP objectives 1/2 x'Hx + g'x agree
    within 2e-2 (1 + |f|), x within X_ATOL/X_RTOL on all but SQP_OFF_MAX
    of the SQPs, and K3 lies no further from the plain version in f64 than
    the plain version in f32 does (at most twice its count of SQPs outside
    X_ATOL/X_RTOL, plus 0.1%).  Reported: how many flag disagreements are
    knife-edges.  Returns max |dx| where both converged."""
    from robogame_tpu_torch.ops import sqp_lanes
    xk, sk = sqp_lanes.dmpc_sqp_stats(*args, **kw)
    xp, sp = sqp_lanes._plain_stats(*args, **kw)
    x64, s64 = sqp_lanes._plain_stats(*(a.double() for a in args), **kw)
    torch.cuda.synchronize()
    ck, cp, c64 = sk[:, 0] > 0.5, sp[:, 0] > 0.5, s64[:, 0] > 0.5
    agree = float((ck == cp).float().mean())
    both = ck & cp
    nb = int(both.sum())
    dx = (xk - xp).abs()
    err = float(dx[both].max()) if nb else 0.0
    off = both & (dx > X_ATOL + X_RTOL * xp.abs()).any(-1)
    H, g = args[0].double(), args[1].double()
    fk, fp = (0.5 * torch.einsum("bi,bij,bj->b", x, H, x) + (g * x).sum(-1)
              for x in (xk.double(), xp.double()))
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
    d64 = [float(d[all3].max()) for d in d64]
    print(f"phase6 {tag}: {xk.shape[0]} SQPs: flags agree {agree:.5f} "
          f"({int(dis.sum())} differ, {int(edge.sum())} of them within "
          f"{FLAG_EDGE:.0%} of the threshold), converged K3 "
          f"{float(ck.float().mean()):.4f} plain {float(cp.float().mean()):.4f}"
          f" f64 {float(c64.float().mean()):.4f}; both converged {nb}: max|dx|"
          f" {err:.3g}, {int(off.sum())} outside {X_ATOL}/{X_RTOL}, max "
          f"|df|/(1+|f|) {dfmax:.3g}; against f64 ({n3} all converged) "
          f"outside {X_ATOL}/{X_RTOL}: K3 {off64[0]}, plain f32 {off64[1]}; "
          f"max|dx| K3 {d64[0]:.3g}, plain f32 {d64[1]:.3g}", flush=True)
    check(agree >= 0.99, f"{tag}: K3 and plain flags agree on {agree}")
    check(dfmax <= 2e-2, f"{tag}: K3's objective differs ({dfmax})")
    check(int(off.sum()) <= SQP_OFF_MAX * nb, f"{tag}: K3 disagrees with "
          f"its plain version ({int(off.sum())} SQPs, max {err})")
    check(off64[0] <= 2 * off64[1] + n3 // 1000, f"{tag}: K3 lies further "
          f"from the f64 solution than the plain f32 version ({off64})")
    return err


def _team_candidates(dt, dm, ts, x, field, params, mpc, strat, route="fused"):
    x0s, tgts, obss = dt.team_inputs(x, field, params, strat)
    return dm.candidates(dt._flat_states(ts), x0s.flatten(0, 1),
                         tgts.flatten(0, 1), obss.flatten(0, 1), params, mpc,
                         route)


def hold_dmpc_policy(rt, tag, policy, params, carry, states, route):
    """The DMPC matchup's policy on K3 against the same policy on
    ``route`` ('plain': K3's plain version on the card, 'cpu': on the
    CPU) from one state.  A game is set aside where an agent's winning
    candidate differs between the two and the difference is explained: the
    best cost within NEAR_TIE of another step size's on either side
    (``runner_up_gap``), a flag within FLAG_EDGE of its threshold, or a
    flag that differs between the sides.  At most SET_ASIDE_MAX of the
    games may be set aside; in the others every winner must be the same
    and the new warm states and controls agree within X_ATOL/X_RTOL in all
    but ``policy_off_limit`` of the games.  The plain route must make one
    solve per DMPC team and call, and launch no K3.
    Prints and returns (tag, share set aside, games outside, games held);
    the caller holds them to the limits."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.agents import dmpc_team as dt
    from robogame_tpu_torch.control import dmpc as dm
    mpc, strat = rt.MpcParams(), rt.StrategyParams()
    B = states.x.shape[0]

    def other(fn, n_solves):
        if route == "cpu":
            cpu = lambda a: a.cpu()
            return fn(_tree_map(cpu, carry), _tree_map(cpu, states))
        calls, before = [], dict(kernels.sqp_launches)
        with sqp_hook("plain", calls):
            out = fn(carry, states)
        check(len(calls) == n_solves and kernels.sqp_launches == before,
              f"{tag}: the plain route made {len(calls)} solves (expected "
              f"{n_solves}) and K3 launches went {before} -> "
              f"{kernels.sqp_launches}")
        return out

    (ka, kb), uk = policy(carry, states)
    (pa, pb), up = other(policy, sum(c is not None for c in carry))
    aside = torch.zeros(B, dtype=torch.bool)
    odd = torch.zeros(B, dtype=torch.bool)
    for field, i in ((-1, 0), (1, 1)):
        if carry[i] is None:
            continue
        ck = _team_candidates(dt, dm, carry[i], states.x, field, params,
                              mpc, strat)
        cp = other(lambda c, s: _team_candidates(dt, dm, c[i], s.x, field,
                                                 params, mpc, strat), 1)
        ck, cp = (type(c)(*(a.cpu() for a in c)) for c in (ck, cp))
        differ = ck.cost.argmin(1) != cp.cost.argmin(1)
        explained = ((dm.runner_up_gap(ck) <= NEAR_TIE) |
                     (dm.runner_up_gap(cp) <= NEAR_TIE) |
                     ((ck.margin - 1).abs() <= FLAG_EDGE).any(1) |
                     ((cp.margin - 1).abs() <= FLAG_EDGE).any(1) |
                     (ck.conv != cp.conv).any(1))
        aside |= (differ & explained).reshape(B, 2).any(1)
        odd |= (differ & ~explained).reshape(B, 2).any(1)
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
    print(f"phase6 {tag}: {B} games, {int(aside.sum())} set aside "
          f"({float(aside.float().mean()):.4f}: a winner differs at a "
          f"near-tie or a flag edge); over the other {n_ok} max|d| "
          f"{err:.3g}, {int(off.sum())} games outside {X_ATOL}/{X_RTOL} "
          f"({int((odd & ok).sum())} with an unexplained winner)", flush=True)
    return tag, float(aside.float().mean()), int(off.sum()), n_ok


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
    P, n1 = args[1].shape
    m_own = (2 + kw["n_obs"]) * kw["N"]
    print(f"phase6 (e) K3 (P={P}, n1={n1}, m_own={m_own}): {ms:.4f} ms per "
          f"launch; plain {plain_ms:.3f} ms; bound {bound:.4f} ms ({by})  "
          f"[{card}]", flush=True)
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
    print(f"phase0 build K1, K2, K3: {build_s:.2f} s (nvcc seconds "
          f"{kernels.build_seconds})  [{card}]", flush=True)

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
    print(json.dumps({"kernels": [kern, *k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

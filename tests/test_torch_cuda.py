"""The CUDA kernels K1-K6 and the draw kernel against their plain
PyTorch versions, on the card; the puck player on K2 against the CPU, a
one-process NCCL mesh against the mesh-less sweep, and the
activity-sorted rollout on K1 and K6 against the step-by-step one.

These tests need a CUDA device (marker ``cuda``); without one they skip.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

The kernels are built with IEEE division and square root; K1, K2's
per-problem kernel, K5 and K6 with -fmad=false, K2's grouped kernels, K3
and K4 with FMA contraction.  K1 and K6 run their
plain versions' f32 operations in the same order, so each is held to be
equal to its plain version bitwise, which also covers chaotic grinding
games; K2-K5 are held by tolerance (see their sections below)."""

import importlib

import numpy as np
import pytest
import torch

import robogame_tpu_torch as rt
from robogame_tpu_torch.physics import exact_step as ex

pytestmark = pytest.mark.cuda

mc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")
P1 = rt.SimParams(engine="pallas_exact", two_phase=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corner_states(dev, B, steps):
    g = torch.Generator().manual_seed(1)
    u = (torch.randint(0, 2, (B, 1, 2), generator=g) * 16.0
         - 8.0).expand(B, 4, 2).contiguous().to(dev)
    s = mc._initial_states(P1, rt.McParams(num_runs=B, randomize_x0=True),
                           dev)
    for _ in range(steps):
        s = rt.step_batch(s, u, P1, device=dev)
    return s, u


def _plain(params, dev, planes, u, mode, cap, noise=None, rnoise=None,
           grid=None, carry=None):
    T = ex._tabs(params, dev)
    return ex.exact_step_plain(T, planes[0], u, planes[1], planes[2], noise,
                               rnoise, grid, carry, mode, cap)


@pytest.mark.parametrize("stochastic", [False, True])
def test_kernel_equals_plain_in_every_mode(dev, stochastic):
    from robogame_tpu_torch import kernels
    B = 256
    s, u = _corner_states(dev, B, 27)
    p = P1.replace(stochastic=stochastic, noise=1.0 if stochastic else 0.0)
    planes = ex._to_planes(s)
    up = ex._u_plane(u, B)
    npl = rpl = None
    if stochastic:
        npl, rpl, _ = ex._noise_planes(s, p)
    T = ex._tabs(p, dev)
    n0 = dict(kernels.launches)
    for mode, cap in (("exact", 49), ("exact_export", 1)):
        k = kernels.exact_step(T.M6, T.consts, planes[0], up, planes[1],
                               planes[2], npl, rpl, None, None, mode, cap)
        q = _plain(p, dev, planes, up, mode, cap, npl, rpl)
        assert torch.equal(k[0], q[0]) and torch.equal(k[1], q[1])
        if mode == "exact_export":
            assert torch.equal(k[2], q[2]) and torch.equal(k[3], q[3])
            kr = kernels.exact_step(T.M6, T.consts, planes[0], up,
                                    planes[1], planes[2], None, rpl, k[2],
                                    k[3], "exact_resume", 48)
            qr = _plain(p, dev, planes, up, "exact_resume", 48, None, rpl,
                        q[2], q[3])
            assert torch.equal(kr[0], qr[0]) and torch.equal(kr[1], qr[1])
    assert kernels.launches["exact"] == n0["exact"] + 1
    assert kernels.launches["exact_resume"] == n0["exact_resume"] + 1


def test_twophase_equals_one_phase_in_the_kernel(dev):
    B = 256
    s, u = _corner_states(dev, B, 28)
    p2 = P1.replace(two_phase=True, compact_frac=B // ex.BLOCK)
    a = rt.step_batch(s, u, P1, device=dev)
    b = rt.step_batch(s, u, p2, device=dev)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_step_batch_on_the_card_equals_the_cpu(dev):
    B = 64
    s, u = _corner_states(dev, B, 26)
    a = rt.step_batch(s, u, P1.replace(two_phase=True), device=dev)
    c = rt.step_batch(rt.GameState(*(t.cpu() for t in s)), u.cpu(),
                      P1.replace(two_phase=True), device="cpu")
    for x, y in zip(a, c):
        assert torch.equal(x.cpu(), y)
    with pytest.raises(ValueError):
        rt.step_batch(s, u, P1, device="cpu")


# ---------------------------------------------------------------------------
# K2: the dense ADMM QP kernel against its plain version
# ---------------------------------------------------------------------------
#
# K2 sums in another order than torch's batched products, so it is held to
# the plain version by tolerance (x within 2e-3 + 1e-2 |x| where both
# converged, flags agreeing on >= 99% of the problems), not bitwise.

def _qps(dev, P, n, m, G=None, n_eq=0, seed=0, share=None, at_hi=False):
    """P random strictly convex QPs over G shared H and A; n_eq equality
    rows in every problem, or (``share``) in about that share of them,
    drawn in -0.5..0.5 or (``at_hi``) pinned at the upper bound."""
    rng = np.random.default_rng(seed)
    G = P if G is None else G
    Q = rng.normal(size=(G, n, n))
    H = np.einsum("bij,bkj->bik", Q, Q) / n + np.eye(n) / 10.0
    lo = rng.uniform(-2.0, 0.0, (P, m))
    hi = rng.uniform(0.1, 2.0, (P, m))
    rows = slice(None) if share is None else rng.random(P) < share
    if at_hi:
        lo[rows, :n_eq] = hi[rows, :n_eq]
    else:
        lo[rows, :n_eq] = hi[rows, :n_eq] = rng.uniform(
            -0.5, 0.5, (P, n_eq))[rows]
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        H, rng.normal(size=(P, n)), rng.normal(size=(G, m, n)), lo, hi)]


@pytest.mark.parametrize("P,n,m,G,n_eq,scale_rows,iters", [
    (16 * 640, 30, 60, 16, 0, False, 60),     # the skills, shared H and A
    (512, 8, 20, None, 0, False, 50),          # the CBF filter
    (1024, 40, 140, None, 4, True, 60),        # DMPC's shape
    (64, 64, 256, None, 0, False, 20),         # the largest supported
])
def test_k2_agrees_with_plain(dev, P, n, m, G, n_eq, scale_rows, iters):
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.ops import qp, qp_lanes
    H, g, A, lo, hi = _qps(dev, P, n, m, G, n_eq)
    group = P // H.shape[0]
    # the skills' shape takes the grouped route, the others the
    # per-problem kernel
    count = kernels.qp_grouped_launches if qp_lanes.grouped_route(
        n, m, group) else kernels.qp_launches
    before = count.get((n, m), 0)
    k = qp_lanes.solve_qp_lanes(H, g, A, lo, hi, iters=iters, group=group,
                                scale_rows=scale_rows)
    assert count[(n, m)] == before + 1
    p = qp.solve_qp(H.repeat_interleave(group, 0), g,
                    A.repeat_interleave(group, 0), lo, hi, iters=iters,
                    scale_rows=scale_rows)
    torch.cuda.synchronize()
    assert float((k.converged == p.converged).float().mean()) >= 0.99
    both = k.converged & p.converged
    assert bool((k.x - p.x).abs()[both].le(
        2e-3 + 1e-2 * p.x.abs()[both]).all())


def _k2_held(k, p):
    """k held against p by test_k2_agrees_with_plain's thresholds: flags
    agree on >= 99%, and where both converged x within 2e-3 + 1e-2 |x|."""
    assert float((k.converged == p.converged).float().mean()) >= 0.99
    both = k.converged & p.converged
    assert bool((k.x - p.x).abs()[both].le(
        2e-3 + 1e-2 * p.x.abs()[both]).all())


def test_k2_shared_operands_equal_broadcast_bitwise(dev):
    """The grouped route runs another algebra than the per-problem kernel
    (one factorization per shared operand), so it is not the broadcast
    call to the bit: two grouped launches are equal bitwise, and the
    grouped route agrees with the per-problem kernel on the broadcast
    operands within K2's tolerances."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.ops import qp_lanes
    H, g, A, lo, hi = _qps(dev, 16 * 256, 30, 60, G=16, seed=3)
    kernels.reset_launches()
    a = qp_lanes.solve_qp_lanes(H, g, A, lo, hi, iters=60, group=256)
    a2 = qp_lanes.solve_qp_lanes(H, g, A, lo, hi, iters=60, group=256)
    b = qp_lanes.solve_qp_lanes(H.repeat_interleave(256, 0), g,
                                A.repeat_interleave(256, 0), lo, hi,
                                iters=60)
    torch.cuda.synchronize()
    assert kernels.qp_grouped_launches == {(30, 60): 2}
    assert kernels.qp_launches == {(30, 60): 1}
    for x, y in zip(a, a2):
        assert torch.equal(x, y)
    _k2_held(a, b)


@pytest.mark.parametrize("P,n,m,G,n_eq,share,at_hi,scale_rows", [
    (16 * 640, 30, 60, 16, 0, 0.0, False, False),   # the skills' shape
    (16 * 640, 30, 60, 16, 3, 0.05, False, False),  # equality rows in 5%
    (16 * 640, 30, 60, 16, 3, 0.05, True, False),   # ... at the upper bound
    (4 * 250, 17, 41, 4, 2, 0.05, False, True),     # odd, partial tiles
    (2 * 400, 32, 64, 2, 1, 0.05, False, False),    # the largest grouped
])
def test_k2_grouped_route_agrees_with_plain(dev, P, n, m, G, n_eq, share,
                                            at_hi, scale_rows):
    """The grouped route against solve_qp by test_k2_agrees_with_plain's
    thresholds: flags agree on >= 99% of all problems, and where both
    converged x lies within 2e-3 + 1e-2 |x| on every problem the grouped
    kernel solved.  The problems with an equality row go to the
    per-problem kernel in the same call (their count read on the device)
    and equal that kernel's own launch on the broadcast operands bitwise;
    their x is held within the same tolerance on all but 0.1% of the
    converged problems, chip_smoke.py's k2_vs_plain allowance: at 1e3 rho
    a stopped f32 ADMM iterate of these problems moves with the order of
    the sums, and the per-problem kernel lies outside on about one in 300
    of them (profile_qp.py holds both f32 routes against f64 there;
    PERF.md).  The problems by route are counted."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.ops import qp, qp_lanes
    H, g, A, lo, hi = _qps(dev, P, n, m, G, n_eq, seed=P + m, share=share,
                           at_hi=at_hi)
    group = P // G
    kernels.reset_launches()
    k = qp_lanes.solve_qp_lanes(H, g, A, lo, hi, iters=60, group=group,
                                scale_rows=scale_rows)
    routes = kernels.k2_routes()
    Hb, Ab = H.repeat_interleave(group, 0), A.repeat_interleave(group, 0)
    p = qp.solve_qp(Hb, g, Ab, lo, hi, iters=60, scale_rows=scale_rows)
    eq = (lo == hi).any(-1)
    per = qp_lanes.solve_qp_lanes(Hb[eq], g[eq], Ab[eq], lo[eq], hi[eq],
                                  iters=60, scale_rows=scale_rows)
    torch.cuda.synchronize()
    n_eq_problems = int(eq.sum())
    assert (n_eq_problems > 0) == (n_eq > 0)
    assert routes == {"grouped": P - n_eq_problems,
                      "listed": n_eq_problems, "per_problem": 0}
    assert kernels.qp_grouped_launches == {(n, m): 1}
    assert kernels.qp_listed_launches == {(n, m): 1}
    assert float((k.converged == p.converged).float().mean()) >= 0.99
    both = k.converged & p.converged
    off = both & (k.x - p.x).abs().gt(2e-3 + 1e-2 * p.x.abs()).any(-1)
    assert not bool(off[~eq].any())
    assert int(off.sum()) <= int(both.sum()) // 1000
    for a, b in zip(k, per):
        assert torch.equal(a[eq], b)


@pytest.mark.parametrize("rho", [1e-2, 1.0, 1e2])
def test_k2_setup_kinv_matches_f64_inverse(dev, rho):
    """The grouped route's setup kernel: W diag(1/(1 + rho lam)) W' from
    its f32 factors against the f64 inverse of H + sigma I + rho A'A, on
    the skills' operands and on random ones with fewer rows than
    variables (A'A singular).  Held within 1e-4 of the
    largest entry of the inverse: the factors come from f64 and are
    rounded once to f32, and the skills' K reaches a condition number of
    some 1e5 at the smallest rho."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.control import trajopt as tt
    grid = tt._grid(rt.SimParams(), torch.float32, dev)
    Hr, _, Ar, _, _ = _qps(dev, 4, 24, 16, G=4, seed=9)
    for H, A in ((grid.H, grid.A), (Hr, Ar)):
        n = H.shape[-1]
        W, lam = kernels.qp_grouped_setup(H, A, 1e-6)
        Wd, ld = W[:, :n, :n].double(), lam[:, :n].double()
        Ad = A.double()
        K = H.double() + 1e-6 * torch.eye(n, dtype=torch.float64,
                                          device=dev) + \
            rho * Ad.transpose(1, 2) @ Ad
        Kinv = torch.linalg.inv(K)
        got = Wd @ torch.diag_embed(1.0 / (1.0 + rho * ld)) @ \
            Wd.transpose(1, 2)
        scale = Kinv.abs().amax((1, 2), keepdim=True)
        assert float(((got - Kinv).abs() / scale).max()) <= 1e-4
        assert float(W[:, n:].abs().max()) == 0.0
        assert float(W[:, :, n:].abs().max()) == 0.0


def test_k2_refuses_unsupported_shapes(dev):
    from robogame_tpu_torch.ops import qp_lanes
    for n, m in ((65, 10), (8, 257)):
        H, g, A, lo, hi = _qps(dev, 4, n, m)
        with pytest.raises(ValueError, match="K2 supports"):
            qp_lanes.solve_qp_lanes(H, g, A, lo, hi)


def test_classical_cbf_policy_on_the_card_equals_the_cpu(dev):
    """Eight games, five steps of the classical_cbf matchup on the card
    from the CPU's states: plays equal and controls within 2e-3 + 1e-3 |u|
    (a near-tie of two final times could flip a plan; none does here)."""
    p = rt.SimParams(dt=0.05, winning_score=4, engine="pallas_exact")
    B = 8
    policy, ps = rt.classical_matchup(p, B, cbf=rt.CbfParams(),
                                      device="cpu")
    s = mc._initial_states(p, rt.McParams(num_runs=B, randomize_x0=True,
                                          x0_pos_range=(1.0, 0.5),
                                          x0_vel_range=2.0), "cpu")
    from robogame_tpu_torch.agents import classical as cl
    for _ in range(5):
        gps = tuple(cl._map(lambda a: a.to(dev), t) for t in ps)
        gs = rt.GameState(*(a.to(dev) for a in s))
        (ga, gb), gu = policy(gps, gs)
        ps, u = policy(ps, s)
        assert torch.equal(ga.curr_play.cpu(), ps[0].curr_play)
        assert torch.equal(gb.curr_play.cpu(), ps[1].curr_play)
        assert bool(((gu.cpu() - u).abs() <= 2e-3 + 1e-3 * u.abs()).all())
        s = rt.step_batch(s, u, p, device="cpu")


# ---------------------------------------------------------------------------
# K3: the fused DMPC SQP kernel against its plain version and against K2
# ---------------------------------------------------------------------------
#
# Held by tolerance, as K2: flags agree on >= 99% of the candidates, and
# where both converged x lies within 2e-3 + 1e-2 |x| on all but 2% of them
# (a stopped ADMM iterate moves along the flat directions of H, rank 4
# plus 0.02 I, and the nonconvex relinearization carries that on: the
# plain version in f32 lies outside that tolerance of its f64 run on about
# 0.5% of them, chip_smoke.py phase 6 (b)).

def _dmpc_candidates(dev, Bq, N, seed=0, t_grid=8):
    """Random DMPC instances (arena-scale positions, targets and
    obstacles) through the controller's candidate grid and closed-form QP
    data: the fused solver's inputs for Bq x t_grid candidates."""
    from robogame_tpu_torch.control import dmpc as dm
    rng = np.random.default_rng(seed)

    def pos(*shape):
        return np.stack([rng.uniform(-4.5, 4.5, shape),
                         rng.uniform(-2.2, 2.2, shape)], -1)

    x0 = np.concatenate([pos(Bq), rng.normal(size=(Bq, 2))], 1)
    xd = np.concatenate([pos(Bq), 3.0 * rng.normal(size=(Bq, 2))], 1)
    obs = pos(Bq, 3)
    mpc = rt.MpcParams(N=N, t_grid=t_grid)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    st = dm.initial_dmpc_state(mpc, device=dev, batch=(Bq,))
    return dm, mpc, (st, f(x0), f(xd), f(obs))


def _capture_fused(dm, mpc, inp):
    from robogame_tpu_torch.ops import sqp_lanes
    seen = []
    kernel_route = sqp_lanes.dmpc_sqp_stats

    def hook(*args, **kw):
        seen.append((args, kw))
        return kernel_route(*args, **kw)

    sqp_lanes.dmpc_sqp_stats = hook
    try:
        dm.candidates(*inp, rt.SimParams(), mpc, "fused")
    finally:
        sqp_lanes.dmpc_sqp_stats = kernel_route
    return seen[0]


# the shapes each fused SQP kernel is held to its plain version on: N
# knots and the change to the controller's solve (n_obs = 0 drops the
# keepout rows, sqp_rest = 0 the warm SQP iterations; P the problems kept)
SQP_CASES = {
    "production": (20, {}),
    "n1_24": (12, {}),              # K3: 2N not a multiple of the 32 lanes
    "n1_56": (28, {}),              # K4: two passes of 48 paired outputs
    "no_keepouts": (20, {"n_obs": 0}),
    "no_warm_iterations": (20, {"sqp_rest": 0}),
    "one_problem": (20, {"P": 1}),
    "odd_problem_count": (4, {"P": 3}),
}


def _sqp_case(args, kw, change):
    """The captured solve's (args, kw) with one of SQP_CASES' changes."""
    args, kw = list(args), dict(kw)
    if "n_obs" in change:
        args[4] = args[4][:, :change["n_obs"]].contiguous()
        kw["n_obs"] = change["n_obs"]
    if "sqp_rest" in change:
        kw["sqp_rest"] = change["sqp_rest"]
    if "P" in change:
        args = [a[:change["P"]].contiguous() for a in args]
    return args, kw


@pytest.mark.parametrize("case", [c for c in SQP_CASES if c != "n1_56"])
def test_k3_agrees_with_plain(dev, case):
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.ops import sqp_lanes
    torch.backends.cuda.matmul.allow_tf32 = False
    N, change = SQP_CASES[case]
    dm, mpc, inp = _dmpc_candidates(dev, 256, N)
    args, kw = _sqp_case(*_capture_fused(dm, mpc, inp), change)
    key = (2 * N, (2 + kw["n_obs"]) * N)
    before = kernels.sqp_launches.get(key, 0)
    xk, sk = sqp_lanes.dmpc_sqp_stats(*args, **kw)
    assert kernels.sqp_launches[key] == before + 1
    xp, sp = sqp_lanes._plain_stats(*args, **kw)
    torch.cuda.synchronize()
    _held(xk, sk, xp, sp, min_conv=0.5 if xk.shape[0] > 1 else 0.0)


def test_k3_one_sqp_iteration_agrees_with_k2(dev):
    """sqp_rest = 0: the fused solve is one cold scaled QP solve, the same
    algorithm as K2 on the controller's 'lanes' route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dm, mpc, inp = _dmpc_candidates(dev, 256, 20, seed=1)
    one = mpc.replace(sqp_iters=1)
    cf = dm.candidates(*inp, rt.SimParams(), one, "fused")
    cl = dm.candidates(*inp, rt.SimParams(), one, "lanes")
    torch.cuda.synchronize()
    assert float((cf.conv == cl.conv).float().mean()) >= 0.99
    both = cf.conv & cl.conv
    off = both & ((cf.U - cl.U).abs() > 2e-3 + 1e-2 * cl.U.abs()).any(-1)
    assert int(off.sum()) <= 0.02 * int(both.sum())


def test_k3_refuses_unsupported_shapes(dev):
    from robogame_tpu_torch.ops import sqp_lanes
    for N in (6, 36):              # n1 = 12 (n1 % 8 != 0), n1 = 72 (> 64)
        dm, mpc, inp = _dmpc_candidates(dev, 2, N, t_grid=2)
        with pytest.raises(ValueError, match="K3 supports"):
            dm.candidates(*inp, rt.SimParams(), mpc, "fused")
    with pytest.raises(ValueError, match="CPU tensors only"):
        dm.candidates(*inp, rt.SimParams(), mpc, "plain")
    assert sqp_lanes.MAX_N1 == 64


# ---------------------------------------------------------------------------
# K4 and K5: the fused joint CMPC SQP and the structured joint QP
# ---------------------------------------------------------------------------
#
# Held by tolerance, as K3: flags agree on >= 99% of the candidates, and
# where both converged x lies within 2e-3 + 1e-2 |x| on all but 2% of them
# (the CMPC H has DMPC's structure: a rank-deficient terminal cost plus
# u_reg I, so a stopped ADMM iterate may move along its flat directions).

def _cmpc_candidates(dev, Bq, N, seed=0, t_grid=8):
    """Random CMPC instances (arena-scale states, targets and obstacles)
    for the controller's candidate grid: its inputs for Bq x t_grid
    candidates."""
    from robogame_tpu_torch.control import cmpc as cm
    rng = np.random.default_rng(seed)

    def pos(*shape):
        return np.stack([rng.uniform(-4.5, 4.5, shape),
                         rng.uniform(-2.2, 2.2, shape)], -1)

    x1 = np.concatenate([pos(Bq), rng.normal(size=(Bq, 2))], 1)
    x2 = np.concatenate([pos(Bq), rng.normal(size=(Bq, 2))], 1)
    f1 = np.concatenate([pos(Bq), 3.0 * rng.normal(size=(Bq, 2))], 1)
    f2 = np.concatenate([pos(Bq), np.zeros((Bq, 2))], 1)
    mpc = rt.MpcParams(N=N, t_grid=t_grid)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    st = cm.initial_cmpc_state(mpc, device=dev, batch=(Bq,))
    return cm, mpc, (st, f(x1), f(x2), f(f1), f(f2), f(pos(Bq, 2)))


def _capture(module, name, fn):
    """The arguments of the first call of ``module.name`` made by fn()."""
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
    return seen[0]


def _held(xk, sk, xp, sp, off_share=0.02, min_conv=0.5):
    ck, cp = sk[:, 0] > 0.5, sp[:, 0] > 0.5
    assert float((ck == cp).float().mean()) >= 0.99
    both = ck & cp
    off = both & ((xk - xp).abs() > 2e-3 + 1e-2 * xp.abs()).any(-1)
    assert int(off.sum()) <= off_share * int(both.sum())
    assert bool(torch.isfinite(xk).all())
    assert float(ck.float().mean()) >= min_conv


@pytest.mark.parametrize("case", [c for c in SQP_CASES if c != "n1_24"])
def test_k4_agrees_with_plain(dev, case):
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.ops import sqp_lanes
    torch.backends.cuda.matmul.allow_tf32 = False
    N, change = SQP_CASES[case]
    cm, mpc, inp = _cmpc_candidates(dev, 128, N)
    args, kw = _capture(sqp_lanes, "cmpc_sqp_stats", lambda: cm.candidates(
        *inp, rt.SimParams(), mpc, "fused"))
    args, kw = _sqp_case([a.float().contiguous() for a in args], kw, change)
    key = (2 * N, (2 + kw["n_obs"]) * N, N)
    before = kernels.cmpc_launches.get(key, 0)
    xk, sk = sqp_lanes.cmpc_sqp_stats(*args, **kw)
    assert kernels.cmpc_launches[key] == before + 1
    xp, sp = sqp_lanes._cmpc_plain_stats(*args, **kw)
    torch.cuda.synchronize()
    _held(xk, sk, xp, sp, min_conv=0.5 if xk.shape[0] > 1 else 0.0)


@pytest.mark.parametrize("N", [20, 16])     # CMPC's shape, and at N=16
def test_k5_agrees_with_plain(dev, N):
    """K5 against its plain version, and no further from the plain version
    in f64 than the plain f32 version (problems outside 2e-3 + 1e-2 |x|
    where all three converged: at most twice as many, plus 0.1%)."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.ops import qp_lanes
    torch.backends.cuda.matmul.allow_tf32 = False
    cm, mpc, inp = _cmpc_candidates(dev, 128, N, seed=1)
    one = mpc.replace(sqp_iters=1)
    args, kw = _capture(qp_lanes, "joint_qp_stats", lambda: cm.candidates(
        *inp, rt.SimParams(), one, "joint"))
    key = (2 * N, 4 * N, N)
    before = kernels.joint_launches.get(key, 0)
    xk, sk = qp_lanes.joint_qp_stats(*args, **kw)
    assert kernels.joint_launches[key] == before + 1
    p = qp_lanes.solve_qp_lanes_joint_plain(*args, **kw)
    sp = torch.stack([p.converged.float(), p.prim_res, p.dual_res], 1)
    p64 = qp_lanes.solve_qp_lanes_joint_plain(*(a.double() for a in args),
                                              **kw)
    torch.cuda.synchronize()
    _held(xk, sk, p.x, sp)
    all3 = (sk[:, 0] > 0.5) & p.converged & p64.converged
    off = [int((all3 & ((x.double() - p64.x).abs() >
                        2e-3 + 1e-2 * p64.x.abs()).any(-1)).sum())
           for x in (xk, p.x)]
    assert off[0] <= 2 * off[1] + int(all3.sum()) // 1000


def test_k4_first_iteration_agrees_with_k5(dev):
    """sqp_iters=1: the fused solve is one cold scaled joint QP solve, the
    same algorithm as one K5 launch on the controller's 'joint' route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cm, mpc, inp = _cmpc_candidates(dev, 128, 20, seed=2)
    one = mpc.replace(sqp_iters=1)
    cf = cm.candidates(*inp, rt.SimParams(), one, "fused")
    cj = cm.candidates(*inp, rt.SimParams(), one, "joint")
    torch.cuda.synchronize()
    assert float((cf.conv == cj.conv).float().mean()) >= 0.99
    both = cf.conv & cj.conv
    off = both & ((cf.U - cj.U).abs() > 2e-3 + 1e-2 * cj.U.abs()).any(-1)
    assert int(off.sum()) <= 0.02 * int(both.sum())


def test_k4_k5_refuse_unsupported_shapes(dev):
    cm, mpc, inp = _cmpc_candidates(dev, 2, 36, t_grid=2)   # n1 = 72 > 64
    for route, name in (("fused", "K4"), ("joint", "K5")):
        with pytest.raises(ValueError, match=f"{name} supports"):
            cm.candidates(*inp, rt.SimParams(), mpc, route)
    with pytest.raises(ValueError, match="CPU tensors only"):
        cm.candidates(*inp, rt.SimParams(), mpc, "plain")
    cm, mpc, inp = _cmpc_candidates(dev, 2, 20, t_grid=2)   # n = 80 > 64
    with pytest.raises(ValueError, match="route='lanes'"):
        cm.candidates(*inp, rt.SimParams(), mpc, "lanes")


# ---------------------------------------------------------------------------
# K6: the parallel-resolution step against its plain version
# ---------------------------------------------------------------------------
#
# K6 runs its plain version's f32 operations in the same order (-fmad=false,
# IEEE division and square root), so the two are held to be equal bitwise.

from robogame_tpu_torch.physics import parallel_step as pst  # noqa: E402

P6 = rt.SimParams(engine="pallas", two_phase=False)


def _corner_states6(dev, B, steps):
    g = torch.Generator().manual_seed(1)
    u = (torch.randint(0, 2, (B, 1, 2), generator=g) * 16.0
         - 8.0).expand(B, 4, 2).contiguous().to(dev)
    s = mc._initial_states(P6, rt.McParams(num_runs=B, randomize_x0=True),
                           dev)
    for _ in range(steps):
        s = rt.step_batch(s, u, P6, device=dev)
    return s, u


@pytest.mark.parametrize("stochastic", [False, True])
def test_k6_equals_plain_in_every_mode(dev, stochastic):
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.physics.sweep import game_draws, populate_noise
    B = 256
    s, u = _corner_states6(dev, B, 27)
    p = P6.replace(stochastic=stochastic, noise=1.0 if stochastic else 0.0)
    planes = ex._to_planes(s)
    up = ex._u_plane(u, B)
    npl = None
    if stochastic:
        (xp,), _ = game_draws(s, (p.grid_points,))
        npl = ex._noise_plane(populate_noise(xp, p))
    T = ex._tabs(p, dev)
    n0 = dict(kernels.parallel_launches)
    for mode, cap in (("full", 50), ("export", 1)):
        k = kernels.parallel_step(T.M6, T.FI, T.SP, T.consts, planes[0], up,
                                  planes[1], planes[2], npl, None, None,
                                  mode, cap)
        q = pst.parallel_step_plain(T, planes[0], up, planes[1], planes[2],
                                    npl, None, None, mode, cap)
        assert torch.equal(k[0], q[0]) and torch.equal(k[1], q[1])
        if mode == "export":
            assert torch.equal(k[2], q[2]) and torch.equal(k[3], q[3])
            kr = kernels.parallel_step(T.M6, T.FI, T.SP, T.consts, planes[0],
                                       up, planes[1], planes[2], None, k[2],
                                       k[3], "resume", 49)
            qr = pst.parallel_step_plain(T, planes[0], up, planes[1],
                                         planes[2], None, q[2], q[3],
                                         "resume", 49)
            assert torch.equal(kr[0], qr[0]) and torch.equal(kr[1], qr[1])
    assert kernels.parallel_launches["full"] == n0["full"] + 1
    assert kernels.parallel_launches["resume"] == n0["resume"] + 1


def test_k6_resume_odd_batch_at_the_cap_with_noise(dev):
    """B=253 corner grinders (not a multiple of the 4 games a block): a
    stochastic export at cap 1 and the resume from its grid and carry,
    games reaching the loop cap, bitwise equal to the plain version."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.physics.sweep import game_draws, populate_noise
    B = 253
    s, u = _corner_states6(dev, B, 27)
    p = P6.replace(stochastic=True, noise=1.0)
    planes = ex._to_planes(s)
    up = ex._u_plane(u, B)
    (xp,), _ = game_draws(s, (p.grid_points,))
    npl = ex._noise_plane(populate_noise(xp, p))
    T = ex._tabs(p, dev)
    k = kernels.parallel_step(T.M6, T.FI, T.SP, T.consts, planes[0], up,
                              planes[1], planes[2], npl, None, None,
                              "export", 1)
    q = pst.parallel_step_plain(T, planes[0], up, planes[1], planes[2], npl,
                                None, None, "export", 1)
    for a, b in zip(k, q):
        assert torch.equal(a, b)
    kr = kernels.parallel_step(T.M6, T.FI, T.SP, T.consts, planes[0], up,
                               planes[1], planes[2], None, k[2], k[3],
                               "resume", 49)
    qr = pst.parallel_step_plain(T, planes[0], up, planes[1], planes[2],
                                 None, q[2], q[3], "resume", 49)
    for a, b in zip(kr[:3], qr[:3]):
        assert torch.equal(a, b)
    assert float(kr[1][4].max()) == 49          # some games at the cap


def test_k1_resume_odd_batch_at_the_cap_with_noise(dev):
    """B=253 corner grinders (not a multiple of the 4 games a block): a
    stochastic K1 export at cap 1 and the resume from its grid and carry,
    games reaching the event cap, bitwise equal to the plain version."""
    from robogame_tpu_torch import kernels
    B = 253
    s, u = _corner_states(dev, B, 27)
    p = P1.replace(stochastic=True, noise=1.0)
    planes = ex._to_planes(s)
    up = ex._u_plane(u, B)
    npl, rpl, _ = ex._noise_planes(s, p)
    T = ex._tabs(p, dev)
    k = kernels.exact_step(T.M6, T.consts, planes[0], up, planes[1],
                           planes[2], npl, rpl, None, None, "exact_export", 1)
    q = _plain(p, dev, planes, up, "exact_export", 1, npl, rpl)
    for a, b in zip(k, q):
        assert torch.equal(a, b)
    kr = kernels.exact_step(T.M6, T.consts, planes[0], up, planes[1],
                            planes[2], None, rpl, k[2], k[3], "exact_resume",
                            48)
    qr = _plain(p, dev, planes, up, "exact_resume", 48, None, rpl, q[2], q[3])
    for a, b in zip(kr[:3], qr[:3]):
        assert torch.equal(a, b)
    assert float(kr[1][4].max()) == 48          # some games at the cap


def test_k6_twophase_equals_one_phase_in_the_kernel(dev):
    from robogame_tpu_torch import kernels
    B = 256
    s, u = _corner_states6(dev, B, 28)
    p2 = P6.replace(two_phase=True, compact_frac=B // ex.BLOCK)
    a = rt.step_batch(s, u, P6, device=dev)
    kernels.reset_launches()
    b = rt.step_batch(s, u, p2, device=dev)
    assert kernels.parallel_launches["export"] == 1
    assert kernels.parallel_launches["resume"] == 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_k6_step_batch_on_the_card_equals_the_cpu(dev):
    B = 64
    s, u = _corner_states6(dev, B, 26)
    for p in (P6, P6.replace(two_phase=True)):
        a = rt.step_batch(s, u, p, device=dev)
        c = rt.step_batch(rt.GameState(*(t.cpu() for t in s)), u.cpu(), p,
                          device="cpu")
        for x, y in zip(a, c):
            assert torch.equal(x.cpu(), y)


def test_k6_refuses_wrong_dtypes_and_shapes(dev):
    from robogame_tpu_torch import kernels
    B = 64
    s, u = _corner_states6(dev, B, 1)
    planes = ex._to_planes(s)
    up = ex._u_plane(u, B)
    T = ex._tabs(P6, dev)
    args = [T.M6, T.FI, T.SP, T.consts, planes[0], up, planes[1], planes[2],
            None, None, None, "full", 50]
    for i, bad in ((4, planes[0].double()), (5, up[:8]),
                   (6, planes[1][:, :32]), (1, T.FI[:40]),
                   (4, planes[0].cpu())):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            kernels.parallel_step(*wrong)
    with pytest.raises(ValueError):
        kernels.parallel_step(*args[:11], "exact", 50)
    with pytest.raises(ValueError):                 # resume needs its carry
        kernels.parallel_step(*args[:9], torch.zeros_like(T.M6), None,
                              "resume", 50)


# ---------------------------------------------------------------------------
# the draw kernel (csrc/game_noise.cu) against its plain version
# ---------------------------------------------------------------------------

# the card's and the host's log and sin/cos may part in the last bits
NORMAL_ULPS = {torch.float32: 1.0, torch.float64: 4.0}


def _draw_keys(dev, B, seed=12):
    g = torch.Generator().manual_seed(seed)
    seeds = torch.randint(-2 ** 62, 2 ** 62, (B,), generator=g)
    ctrs = torch.randint(0, 2 ** 33, (B,), generator=g)
    return torch.stack([seeds, ctrs], dim=1).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_draw_kernel_equals_plain(dev, dtype):
    """Every substream at B=1001, G=50's sizes: the words bitwise, the
    normals within 1 ulp (f32) or 4 ulp (f64) of the plain version on the
    card; the launches counted per substream."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.physics import noise
    keys = _draw_keys(dev, 1001)
    per = noise.per_block(dtype)
    n0 = dict(kernels.noise_launches)
    for s, it, n in ((0, 0, 800), (1, 0, 816), (2, 0, 1600), (3, 9, 1632)):
        nb = -(-n // per)
        assert torch.equal(kernels.game_words(keys, nb, s, it),
                           noise.block_words(keys, nb, s, it))
        z = noise.game_normals(keys, n, s, it, dtype)
        ref = noise.game_normals_plain(keys, n, s, it, dtype)
        assert z.dtype == dtype and z.shape == (1001, n)
        assert noise.ulps(z, ref) <= NORMAL_ULPS[dtype]
        assert kernels.noise_launches[s] == n0[s] + 1


def test_draws_do_not_depend_on_the_batch_and_make_no_sync(dev):
    """A game's draws are the same in a batch of 8192 and a batch of 3,
    and every engine's draw functions run under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from robogame_tpu_torch.physics import engine, noise
    from robogame_tpu_torch.physics.sweep import game_draws
    keys = _draw_keys(dev, 8192)
    pick = torch.tensor([0, 4097, 8191], device=dev)
    for dtype in (torch.float32, torch.float64):
        a = noise.game_normals(keys, 1632, 3, 2, dtype)[pick]
        b = noise.game_normals(keys[pick], 1632, 3, 2, dtype)
        assert torch.equal(a, b)
    p = rt.SimParams(engine="event", stochastic=True, noise=0.8)
    s = rt.initial_state(p, seed=list(range(512)), device=dev)
    active = torch.arange(512, device=dev) % 3 == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (xp, xr), keys2 = game_draws(s, (50, 51))
        pop = engine._populate_draws(s.key, p)
        rn, pn, sn = engine._iteration_draws(s.key, active, 3, p)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert xp.shape == (512, 50, 4, 4) and xr.shape == (512, 51, 4, 4)
    assert torch.equal(keys2[:, 1], s.key[:, 1] + 1)
    assert pop.shape == (512, 50, 4, 5, 2) and sn.shape == (512, 50, 4, 5, 2)
    assert not rn[~active].any()


# ---------------------------------------------------------------------------
# the puck player (K2 a cold solve an SQP iteration) and the NCCL mesh
# ---------------------------------------------------------------------------

def test_puck_player_on_the_card_equals_the_cpu(dev):
    """MpcParams() (n=40, m=140 on K2's per-problem kernel): the card's
    control within 2e-3 + 1e-2 |u| of the CPU's plain solves, two calls
    from common states, the state's flag equal, one K2 launch an SQP
    iteration."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.control import puck_player_mpc as pp
    mpc = rt.MpcParams()
    params = rt.SimParams()
    st = pp.initial_state(mpc, torch.float32, "cpu")
    obs = torch.tensor([[3.0, 2.0], [3.0, -2.0], [0.0, 1.2], [0.5, -1.5]])
    goal = torch.tensor([5.0, 0.0])
    x_p2 = torch.tensor([-2.0, -1.0, 0.0, 0.0])
    kernels.reset_launches()
    for x_p1, x_puck in (([-2.0, 0, 0, 0], [1.0, 0, 0, 0]),
                         ([-1.7, 0.1, 2.0, 0.5], [1.2, 0.3, 0.5, 0.0])):
        args = [torch.tensor(x_p1), x_p2, torch.tensor(x_puck), goal, obs]
        st_dev = pp.JointPuckPlayerState(pp.DmpcState(
            *(a.to(dev) for a in st.p1)))
        new, u1, u2 = pp.compute_control(st_dev, *(a.to(dev) for a in args),
                                         params, mpc)
        st, u1_c, _ = pp.compute_control(st, *args, params, mpc)
        torch.testing.assert_close(u1.cpu(), u1_c, atol=2e-3, rtol=1e-2)
        assert bool(new.p1.valid.cpu() == st.p1.valid)
        assert u1.is_cuda and bool((u2 == 0).all())
    assert kernels.qp_launches[(2 * mpc.N, 7 * mpc.N)] == 2 * mpc.sqp_iters


def test_one_process_nccl_mesh_equals_meshless(dev):
    """``monte_carlo(mesh=make_mesh())`` at one NCCL process gives the
    mesh-less sweep bitwise, on K1."""
    import torch.distributed as dist
    from robogame_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    try:
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        p = rt.SimParams(engine="pallas_exact")
        mcp = rt.McParams(num_runs=96, T=0.5, randomize_x0=True)
        a = rt.monte_carlo(p, mcp, device=dev)
        b = rt.monte_carlo(p, mcp, mesh=mesh, device=dev)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("engine", ["pallas_exact", "pallas"])
def test_sorted_rollout_equals_step_by_step(dev, engine):
    """rollout_pallas_sorted on K1 / K6 only permutes the games among the
    kernel's blocks: at B=256 on corner grinders its states equal the
    step-by-step rollout's bitwise, keys included, at resort_every 1 and
    4; the kernel's occupancy query gives at least one block an SM."""
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.tools.dist_equiv import make_sched, make_states
    p = rt.SimParams(engine=engine, two_phase=False)
    B, n = 256, 30
    us = torch.from_numpy(make_sched("corner", B, n, seed=3)).to(dev)
    s0 = make_states(B, p, dev)
    ref, act = s0, torch.zeros(B, device=dev)
    for u in us:
        ref, a = rt.step_batch(ref, u, p, device=dev, with_activity=True)
        act += a
    assert bool((act != act[0]).any())      # a spread to sort by
    for every in (1, 4):
        got = rt.rollout_pallas_sorted(s0, us, p, resort_every=every,
                                       device=dev)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    name = "exact_step" if engine == "pallas_exact" else "parallel_step"
    for stochastic in (False, True):
        occ = kernels.step_occupancy(name, p.grid_points + 1, stochastic)
        assert occ["blocks_per_sm"] >= 1 and occ["smem_bytes"] > 0

